"""Training: one round and the multi-round protocol (port of
``pathnet_tpu/train/trainer.py:48-434``).

A round initialises the model from its seed and runs ``cfg.epochs`` epochs.
Each epoch samples a fresh walk set for every node
(``PathSampler.sample_epoch``: the sampler's one launch, ``walk_dists``, K1
and K2, on the default path), accumulates the exact full-train-set
gradient over microbatches (forward K3 with dropout, K5; backward K4 with
its segment sum, K5), takes one Adam step, computes the validation
confusion matrix and, only on a strict improvement of validation accuracy (from 0),
the test confusion matrix: the round's result is the test metrics of the
best-on-validation epoch (PathNet_run.py:281-403).

The JAX package runs the epochs as one ``lax.scan``; the port runs them as a
Python loop of eager steps (``TrainConfig.scan_epochs``/``scan_chunk`` have
no effect here). Randomness: every (round seed, epoch, stream) pair gets its
own ``torch.Generator`` (``rng.make_generator``), for the streams init,
walks and dropout (one generator per microbatch), as JAX folds the epoch into its key: an epoch's
draws depend only on the round seed and the global epoch, and two runs with
one seed on one device give identical results, on the card too: no sum on
the training path depends on the order its threads finish in (K4 reduces in
an order fixed by the paths; ``tests/test_torch_reproducible.py``). Philox
and threefry streams differ, so rounds are compared with the JAX package by
distribution only.

With ``mesh`` (a rank grid of ``parallel``) every rank runs the same round
on its share of each chunk (the ``axis`` of :func:`chunked_grads` and
:func:`chunked_cm`), as JAX's round runs under a mesh; one process is the
grid of one rank.

Optimizer semantics match ``optax.chain(add_decayed_weights, scale_by_adam,
scale(-lr))``: ``torch.optim.Adam(lr, weight_decay)``, additive L2 before the
moment update, not AdamW.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterable, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..config import TrainConfig
from ..models.pagg import PaggSpec, PathNet, draw_dropout_masks
from ..nn.metrics import classification_metrics, confusion_matrix
from ..parallel.comm import SINGLE, Axis, all_reduce
from ..parallel.mesh import FeatureExchange, shard_rows, share, share_masks, sum_grads, walk_starts
from ..rng import STREAM_DROPOUT, STREAM_INIT, STREAM_WALKS, make_generator, stream_seed
from ..sample.walk import PathSampler

__all__ = ["RoundResult", "STREAM_INIT", "STREAM_WALKS", "STREAM_DROPOUT", "stream_seed",
           "make_generator", "make_optimizer", "chunk_index", "chunked_grads", "chunked_cm",
           "epoch_uniforms", "rank_starts", "epoch_walks",
           "run_round", "checkpoint_name", "run_protocol"]


@dataclasses.dataclass
class RoundResult:
    best_val_acc: float
    metrics: Dict[str, float]          # the five test metrics at best val
    best_params: Optional[dict] = None  # state_dict of the best epoch
    history: Optional[np.ndarray] = None   # [epochs] val accuracy
    losses: Optional[np.ndarray] = None    # [epochs] train loss
    epoch_seconds: Optional[np.ndarray] = None  # [epochs] host clock


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float,
                   weight_decay: float) -> torch.optim.Adam:
    """torch Adam with additive L2: JAX's ``make_optimizer`` (trainer.py:48-55)."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)


def _pad_chunks(idx: np.ndarray, chunk: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pad an index set to a multiple of ``chunk``; returns (idx [K, C],
    weights [K, C]) with padded entries weighted 0 (they index node 0)."""
    m = len(idx)
    k = max(1, -(-m // chunk))
    padded = np.zeros(k * chunk, np.int32)
    padded[:m] = idx
    w = np.zeros(k * chunk, np.float32)
    w[:m] = 1.0
    return padded.reshape(k, chunk), w.reshape(k, chunk)


def chunk_index(mask: np.ndarray, microbatch: Optional[int],
                device: torch.device) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """The nodes of ``mask`` as ``(idx [K, C] int32, weights [K, C], total)``;
    ``microbatch=None`` gives one chunk of them all, unpadded."""
    idx = np.flatnonzero(mask).astype(np.int32)
    if microbatch is None:
        ic, wc = idx[None, :], np.ones((1, len(idx)), np.float32)
    else:
        ic, wc = _pad_chunks(idx, microbatch)
    return (torch.from_numpy(ic).to(device), torch.from_numpy(wc).to(device),
            max(float(wc.sum()), 1.0))


def weighted_ce(logits: torch.Tensor, y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Sum of ``w * CE``; labels of zero-weight (padding) rows may be -1."""
    logp = F.log_softmax(logits, dim=-1)
    ce = -logp.gather(1, y.long().clamp(min=0)[:, None])[:, 0]
    return (ce * w).sum()


def chunked_grads(model: PathNet, X: torch.Tensor, y: torch.Tensor,
                  paths: torch.Tensor, dists: torch.Tensor, idx_chunks: torch.Tensor,
                  w_chunks: torch.Tensor, total: float,
                  dropout_gen=None, axis: Axis = SINGLE, exchange=None) -> torch.Tensor:
    """Set every parameter's ``.grad`` to the full-batch gradient of the mean
    CE over the weighted rows, accumulated over microbatches (trainer.py:87-112):
    each chunk's weighted CE sum is back-propagated, and the summed gradients
    are divided by ``total``. ``dropout_gen(i)`` gives chunk ``i``'s dropout
    generator (None: no dropout). Returns the loss (a 0-d tensor).

    On a data ``axis`` of several ranks each chunk is split across them
    (``parallel.mesh.share``; the chunk's dropout masks drawn whole and
    sliced the same way), and the gradients and the loss are summed over
    the axis once, after the chunk loop. ``X`` is this rank's row block when
    an ``exchange`` (``parallel.mesh.FeatureExchange``) reaches the rest."""
    model.zero_grad(set_to_none=True)
    nw = paths.shape[1]
    width = idx_chunks.shape[1]
    loss = torch.zeros((), device=X.device)
    for i in range(idx_chunks.shape[0]):
        idx_c, w_c = share(idx_chunks[i], w_chunks[i], axis)
        rows = idx_c.long()
        masks = None
        if dropout_gen is not None:
            masks = share_masks(draw_dropout_masks(model.spec, width, nw, dropout_gen(i),
                                                   X.device), width, axis)
        logits = model(X, paths[rows], dists[rows], idx_c, train=True, masks=masks,
                       exchange=exchange)
        part = weighted_ce(logits, y[rows], w_c)
        part.backward()
        loss += part.detach()
    loss = sum_grads(model, loss, axis)
    for p in model.parameters():
        p.grad /= total
    return loss / total


@torch.no_grad()
def chunked_cm(model: PathNet, X: torch.Tensor, y: torch.Tensor,
               paths: torch.Tensor, dists: torch.Tensor, idx_chunks: torch.Tensor,
               w_chunks: torch.Tensor, num_classes: int, axis: Axis = SINGLE,
               exchange=None) -> torch.Tensor:
    """Weighted confusion matrix of the serving forward over the chunks,
    split and summed over the data ``axis`` as in :func:`chunked_grads`:
    every rank holds the same matrix."""
    cm = torch.zeros((num_classes, num_classes), device=X.device)
    for i in range(idx_chunks.shape[0]):
        idx_c, w_c = share(idx_chunks[i], w_chunks[i], axis)
        rows = idx_c.long()
        pred = model(X, paths[rows], dists[rows], idx_c, exchange=exchange).argmax(dim=-1)
        cm += confusion_matrix(y[rows], pred, num_classes, weights=w_c)
    return all_reduce(cm, axis)


def epoch_uniforms(ps: PathSampler, seed: int, epoch: int) -> torch.Tensor:
    """The whole epoch's walk draws for every node, those
    ``ps.sample_epoch(seed, epoch)`` takes."""
    return ps.draw_uniforms(ps.sampler.n * ps.num_walks,
                            make_generator(seed, epoch, STREAM_WALKS, device=ps.device))


def rank_starts(chunks, axis: Axis) -> Optional[torch.Tensor]:
    """The nodes this rank walks an epoch: those of its shares of the
    ``chunk_index`` sets ``chunks``, sorted, once each; None (every node)
    on one rank."""
    if axis.size == 1:
        return None
    return torch.unique(torch.cat([share(ic[i], wc[i], axis)[0]
                                   for ic, wc, _ in chunks for i in range(ic.shape[0])]))


def epoch_walks(ps: PathSampler, seed: int, epoch: int,
                starts: Optional[torch.Tensor] = None):
    """The epoch's ``(paths, dists)``, a row a node:
    ``ps.sample_epoch(seed, epoch)``, of which only the rows of ``starts``
    are walked when given (on their columns of the epoch's whole draws, so
    bit for bit; the other rows are 0)."""
    if starts is None:
        return ps.sample_epoch(seed, epoch)
    paths, dists = walk_starts(ps, epoch_uniforms(ps, seed, epoch), starts)
    rows = starts.long()
    full = []
    for t in (paths, dists):
        if t is not None:
            f = t.new_zeros((ps.sampler.n, *t.shape[1:]))
            f[rows] = t
            t = f
        full.append(t)
    return tuple(full)


def run_round(X: torch.Tensor, y: torch.Tensor, ps: PathSampler, spec: PaggSpec,
              cfg: TrainConfig, train_mask: np.ndarray, val_mask: np.ndarray,
              test_mask: np.ndarray, num_classes: int, seed: int = 0,
              track_history: bool = False, keep_params: bool = False,
              mesh=None, shard_features: bool = False) -> RoundResult:
    """One full round on ``ps.device``: init -> epochs -> best-on-val test metrics.

    ``X [n, F]`` and ``y [n]`` lie on the sampler's device. With
    ``track_history`` the result carries the per-epoch validation accuracy,
    train loss and host-clock seconds; with ``keep_params`` the best epoch's
    ``state_dict`` (the init params when validation accuracy never rises
    above 0, as in JAX).

    ``mesh`` (this rank's :class:`~pathnet_tpu_torch.parallel.comm.Grid`;
    every rank calls ``run_round`` alike) runs the round over the grid's data
    axis (JAX's ``trainer.py:228-257``): each chunk split across the ranks,
    each rank walking its shares' starts on the epoch's whole draws and
    slicing the chunk's dropout masks, so its walks and masks are the
    one-process round's; the gradients summed once a step; the validation
    and test confusion matrices summed before the host reads them, so every
    rank takes the same best-on-validation branch. ``shard_features`` keeps
    only this rank's row block of ``X`` and all-gathers the projected table
    (the ``gspmd`` exchange, as JAX's trainer).
    """
    dev = ps.device
    model = PathNet(spec, device=dev, generator=make_generator(seed, 0, STREAM_INIT))
    opt = make_optimizer(model.parameters(), cfg.lr, cfg.weight_decay)
    tr = chunk_index(train_mask, cfg.microbatch, dev)
    va = chunk_index(val_mask, cfg.microbatch, dev)
    te = chunk_index(test_mask, cfg.microbatch, dev)
    axis = SINGLE if mesh is None else mesh.data_axis
    fx = None
    if mesh is not None and shard_features:
        fx = FeatureExchange(mesh, "gspmd")
        X = shard_rows(X, axis)
    starts = rank_starts((tr, va, te), axis)
    best_val = 0.0
    best_cm = torch.zeros((num_classes, num_classes), device=dev)
    # as JAX's carry: a round whose validation accuracy never rises keeps
    # the init params (pathnet_tpu/train/trainer.py:216-217)
    best_params = ({k: v.detach().clone() for k, v in model.state_dict().items()}
                   if keep_params else None)
    hist, losses, secs = [], [], []
    for epoch in range(cfg.epochs):
        t0 = time.perf_counter()
        paths, dists = epoch_walks(ps, seed, epoch, starts)
        dropout_gen = None
        if spec.dropout > 0.0:
            dropout_gen = lambda i: make_generator(seed, epoch, STREAM_DROPOUT, i,
                                                   device=dev)
        loss = chunked_grads(model, X, y, paths, dists, tr[0], tr[1], tr[2],
                             dropout_gen, axis, fx)
        cm = lambda c: chunked_cm(model, X, y, paths, dists, c[0], c[1], num_classes,
                                  axis, fx)
        opt.step()
        val_cm = cm(va)
        val_acc = float(val_cm.diagonal().sum() / val_cm.sum().clamp(min=1.0))
        if val_acc > best_val:
            best_val = val_acc
            best_cm = cm(te)
            if keep_params:
                best_params = {k: v.detach().clone()
                               for k, v in model.state_dict().items()}
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        secs.append(time.perf_counter() - t0)
        hist.append(val_acc)
        losses.append(loss)
    metrics = {k: float(v) for k, v in classification_metrics(best_cm).items()}
    return RoundResult(
        best_val_acc=best_val, metrics=metrics, best_params=best_params,
        history=np.asarray(hist, np.float32) if track_history else None,
        losses=(torch.stack(losses).cpu().numpy() if track_history and losses
                else None),
        epoch_seconds=np.asarray(secs) if track_history else None)


def checkpoint_name(name: str, fingerprint: str, cfg: TrainConfig, hidden: int,
                    num_walks: int, walk_len: int, dropout: float, kind: str,
                    rnn: str, agg: str, compute_dtype: str = "float32",
                    quirk_compat: bool = False) -> str:
    """The JAX package's checkpoint key (trainer.py:379-383): every knob that
    changes the math, so a resume never takes rounds of another protocol."""
    return (f"{name}.{fingerprint}.e{cfg.epochs}"
            f".h{hidden}.s{cfg.seed}.nw{num_walks}.wl{walk_len}"
            f".dr{dropout}.{kind}.{rnn}.{agg}"
            + ("" if compute_dtype == "float32" else f".{compute_dtype}")
            + (".quirk" if quirk_compat else ""))


def run_protocol(name: str, data_root: str = "data",
                 cfg: Optional[TrainConfig] = None,
                 num_walks: int = 40, walk_len: int = 4, hidden: int = 64,
                 kind: str = "merw", rnn: str = "lstm", agg: str = "attention",
                 quirk_compat: bool = False, rounds: Optional[int] = None,
                 dropout: float = 0.7, ckpt_dir: Optional[str] = None,
                 verbose: bool = True, compute_dtype: str = "float32",
                 remat: str = "auto",
                 device: Optional[Union[str, torch.device]] = None,
                 mesh=None, shard_features: bool = False,
                 ) -> Tuple[Dict[str, Tuple[float, float]], list]:
    """The multi-round protocol (trainer.py:347-434; PathNet_run.py:406-485).

    Loads the dataset per round (the payload once, the masks per round),
    builds the sampler once (after MERW on ``device`` for a payload without
    transition probabilities), runs ``rounds`` rounds with seeds
    ``cfg.seed + round``, and returns ``(mean/std aggregate, per-round
    results)``. With ``ckpt_dir`` each round's best params and metrics are
    saved under the JAX package's checkpoint key, and rounds already saved
    are skipped. ``remat`` is accepted and has no effect (K4 recomputes).

    ``mesh`` (this rank's grid; every rank calls ``run_protocol`` alike) runs
    each round with :func:`run_round`'s ``mesh`` and ``shard_features`` (the
    ``gspmd`` exchange, as JAX's trainer) on the grid's device; only rank 0
    prints and saves rounds.
    """
    from ..data.registry import DATASETS, load_dataset, payload_fingerprint
    from ..device import resolve_device
    from ..merw import merw_graph_per_component
    from .checkpoint import load_round, save_round
    from .results import aggregate_rounds

    cfg = cfg or TrainConfig()
    rounds = rounds if rounds is not None else cfg.rounds
    spec_d = DATASETS[name]
    variant = "homo" if spec_d.variant == "homo" else "hetero"
    spec_probe = PaggSpec(feat_dim=spec_d.feat_dim, hidden=hidden,
                          out_dim=spec_d.num_classes, walk_len=walk_len,
                          variant=variant, rnn=rnn, agg=agg, dropout=dropout,
                          quirk_compat=quirk_compat, compute_dtype=compute_dtype)
    spec_probe.check_ported()
    ckpt_name = checkpoint_name(name, payload_fingerprint(spec_d), cfg, hidden,
                                num_walks, walk_len, dropout, kind, rnn, agg,
                                compute_dtype, quirk_compat)
    dev = resolve_device(device) if mesh is None else mesh.device
    lead = mesh is None or mesh.rank == 0
    verbose = verbose and lead
    results = []
    ps = None
    for round_i in range(rounds):
        if ckpt_dir is not None:
            prev = load_round(ckpt_dir, ckpt_name, round_i)
            if prev is not None:
                results.append(RoundResult(
                    best_val_acc=prev["meta"]["best_val_acc"],
                    metrics=prev["meta"]["metrics"]))
                if verbose:
                    print(f"round {round_i}: resumed from checkpoint "
                          f"(acc={prev['meta']['metrics']['accuracy']:.4f})")
                continue
        g, train_mask, val_mask, test_mask, _ = load_dataset(name, data_root, round_i)
        if ps is None:
            if kind == "merw" and not (g.prob < 1.0).any():
                # per-component: SBM stand-ins can have isolated nodes, and
                # a global eigenvector yields psi=0 -> NaN probabilities on
                # minor components (the reference preprocessing's own bug)
                g = merw_graph_per_component(g, device=dev)
            ps = PathSampler.build(g, num_walks, walk_len, kind=kind, device=dev)
            X = torch.from_numpy(np.array(g.features, np.float32)).to(dev)
            y = torch.from_numpy(np.array(g.labels, np.int64)).to(dev)
            spec = dataclasses.replace(spec_probe, feat_dim=g.features.shape[1],
                                       remat=remat == "on")
        t_round = time.time()
        res = run_round(X, y, ps, spec, cfg, train_mask, val_mask, test_mask,
                        spec_d.num_classes, seed=cfg.seed + round_i,
                        keep_params=ckpt_dir is not None, mesh=mesh,
                        shard_features=shard_features)
        if ckpt_dir is not None:
            if lead:
                save_round(ckpt_dir, ckpt_name, round_i, res)
            res.best_params = None
        if verbose:
            print(f"round {round_i}: val={res.best_val_acc:.4f} "
                  f"acc={res.metrics['accuracy']:.4f} "
                  f"[{time.time() - t_round:.1f}s]", flush=True)
        results.append(res)
    return aggregate_rounds(results), results
