"""The rank side of the multi-device tests: functions that
``pathnet_tpu_torch.parallel.comm.spawn`` runs on each gloo rank.

This module imports torch and the port only, so a rank starts without JAX;
the test files hand it numpy arrays and compare what it returns.
"""
import numpy as np
import torch

from pathnet_tpu_torch.data import Graph
from pathnet_tpu_torch.models import PaggSpec, PathNet
from pathnet_tpu_torch.parallel import (make_ring_gather, make_sparse_gather,
                                        make_sparse_gather_sharded, shard_rows,
                                        sharded_train_step)
from pathnet_tpu_torch.parallel.comm import regrid
from pathnet_tpu_torch.parallel.mesh import EXCHANGES
from pathnet_tpu_torch.sample import PathSampler
from pathnet_tpu_torch.train import make_sharded_predict

GATHERS = {"ring": (make_ring_gather, True), "sparse": (make_sparse_gather, False),
           "sparse_sharded": (make_sparse_gather_sharded, True)}


def _grids(grid, shapes):
    """One grid a ``(data, model)`` shape, made in the same order on every
    rank."""
    return {shape: (grid if shape == (grid.data, grid.model) else regrid(grid, *shape))
            for shape in shapes}


def _model(spec, state):
    model = PathNet(spec, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model


def gathers(grid, shapes, h, idx, w):
    """Each exchange's rows of ``h`` at ``idx`` (this rank's share of them
    for the sharded requests) and the gradient of ``sum(rows * w)`` in this
    rank's block, on each grid shape."""
    h, idx, w = torch.from_numpy(h), torch.from_numpy(idx), torch.from_numpy(w)
    out = {}
    for shape, gr in _grids(grid, shapes).items():
        ax = gr.data_axis
        for name, (make, sharded) in GATHERS.items():
            block = shard_rows(h, ax).clone().requires_grad_(True)
            k = idx.shape[0] // ax.size
            mine = idx[ax.index * k:(ax.index + 1) * k] if sharded else idx
            rows = make(gr)(block, mine)
            (rows * w).sum().backward()
            out[shape, name] = (rows.detach().numpy(), block.grad.numpy())
    return out


def steps(grid, prob):
    """One :func:`sharded_train_step` a configuration ``(shape, exchange,
    shard_features, shard_params)`` from the same parameters: loss,
    validation accuracy, this rank's logits, and (rank 0) the summed
    gradients and the parameters after the update."""
    g = Graph.from_edge_input(prob["edge"])
    ps = PathSampler.build(g, prob["nw"], prob["spec"]["walk_len"], device="cpu")
    spec = PaggSpec(**prob["spec"])
    X, y = torch.from_numpy(prob["X"]), torch.from_numpy(prob["y"])
    tr, va = torch.from_numpy(prob["train_idx"]), torch.from_numpy(prob["val_idx"])
    u = torch.from_numpy(prob["u"])
    masks = None if prob["masks"] is None else tuple(torch.from_numpy(m) for m in prob["masks"])
    grids = _grids(grid, sorted({c[0] for c in prob["configs"]}))
    out = {}
    for cfg in prob["configs"]:
        shape, exchange, sf, sp = cfg
        gr = grids[shape]
        step = sharded_train_step(gr, _model(spec, prob["state"]), prob["classes"],
                                  shard_features=sf, exchange=exchange, shard_params=sp)
        res = step(shard_rows(X, gr.data_axis) if sf else X, y, ps, tr, va, u, masks)
        lead = grid.rank == 0
        out[cfg] = dict(loss=res.loss, val_acc=res.val_acc, logits=res.logits.numpy(),
                        grads={k: v.numpy() for k, v in res.grads.items()} if lead else None,
                        params=({k: v.numpy() for k, v in step.state_dict().items()}
                                if lead else None))
    return out


def sharded_predict(grid, prob):
    """``make_sharded_predict`` on this rank's block of X with the given
    draws: the log-probabilities."""
    g = Graph.from_edge_input(prob["edge"])
    ps = PathSampler.build(g, prob["nw"], prob["spec"]["walk_len"], device="cpu")
    model = _model(PaggSpec(**prob["spec"]), prob["state"])
    fn = make_sharded_predict(grid, num_ensemble=prob["u"].shape[0])
    X = shard_rows(torch.from_numpy(prob["X"]), grid.data_axis)
    return fn(model, X, ps, torch.from_numpy(prob["idx"]), u=torch.from_numpy(prob["u"])).numpy()


def suite(grid, gather_args, step_prob, predict_prob):
    """Everything ``tests/test_torch_parallel.py`` compares, in one spawn."""
    return {"gathers": gathers(grid, *gather_args), "steps": steps(grid, step_prob),
            "predict": sharded_predict(grid, predict_prob)}


def record_forwards(log):
    """Wrap ``PathNet.forward`` in this process so that each training call
    appends its ``(targets, paths, masks)`` to ``log``; returns the undo."""
    real = PathNet.forward

    def forward(self, X, paths, dists, ego_idx, train=False, masks=None, exchange=None):
        if train:
            log.append((ego_idx.numpy().copy(), paths.numpy().copy(),
                        None if masks is None else tuple(m.numpy().copy() for m in masks)))
        return real(self, X, paths, dists, ego_idx, train, masks, exchange)

    PathNet.forward = forward
    return lambda: setattr(PathNet, "forward", real)


def round_setup(prob):
    g = Graph.from_edge_input(prob["edge"])
    ps = PathSampler.build(g, prob["nw"], prob["spec"]["walk_len"], device="cpu")
    X, y = torch.from_numpy(prob["X"]), torch.from_numpy(prob["y"])
    return ps, X, y


def exchange_round(grid, ps, X, y, spec, cfg, masks, classes, seed, exchange):
    """``run_round``'s epochs written out with X row-sharded through
    ``exchange`` (the round itself takes the ``gspmd`` exchange, as JAX's
    trainer): the same chunks, walks, steps and best-on-validation test
    matrix, from ``chunked_grads`` and ``chunked_cm`` on the data axis."""
    from pathnet_tpu_torch.nn.metrics import classification_metrics
    from pathnet_tpu_torch.parallel import FeatureExchange
    from pathnet_tpu_torch.train.trainer import (STREAM_INIT, chunk_index, chunked_cm,
                                                 chunked_grads, epoch_walks, make_generator,
                                                 make_optimizer, rank_starts)

    axis, fx, Xb = grid.data_axis, FeatureExchange(grid, exchange), shard_rows(X, grid.data_axis)
    model = PathNet(spec, device="cpu", generator=make_generator(seed, 0, STREAM_INIT))
    opt = make_optimizer(model.parameters(), cfg.lr, cfg.weight_decay)
    tr, va, te = (chunk_index(m, cfg.microbatch, "cpu") for m in masks)
    starts = rank_starts((tr, va, te), axis)
    best, best_cm, hist, losses = 0.0, torch.zeros((classes, classes)), [], []
    for epoch in range(cfg.epochs):
        paths, dists = epoch_walks(ps, seed, epoch, starts)
        losses.append(float(chunked_grads(model, Xb, y, paths, dists, *tr, axis=axis,
                                          exchange=fx)))
        opt.step()
        cm = chunked_cm(model, Xb, y, paths, dists, va[0], va[1], classes, axis, fx)
        acc = float(cm.diagonal().sum() / cm.sum().clamp(min=1.0))
        if acc > best:
            best = acc
            best_cm = chunked_cm(model, Xb, y, paths, dists, te[0], te[1], classes, axis, fx)
        hist.append(acc)
    return dict(history=np.asarray(hist, np.float32), losses=np.asarray(losses, np.float32),
                metrics={k: float(v) for k, v in classification_metrics(best_cm).items()},
                best_val=best)


def rounds(grid, prob):
    """For each ``(dropout, shard_features, exchange)`` of ``prob["runs"]``,
    ``run_round`` on the grid (``gspmd``) or :func:`exchange_round` (``ring``,
    ``sparse``): its history, losses and metrics, and (the first run) the
    inputs of every training forward."""
    from pathnet_tpu_torch.config import TrainConfig
    from pathnet_tpu_torch.train import run_round

    ps, X, y = round_setup(prob)
    cfg = TrainConfig(**prob["cfg"])
    out = {}
    for i, (dropout, sf, exchange) in enumerate(prob["runs"]):
        spec = PaggSpec(**{**prob["spec"], "dropout": dropout})
        if exchange != "gspmd":
            out[dropout, sf, exchange] = dict(
                exchange_round(grid, ps, X, y, spec, cfg, prob["masks"], prob["classes"], 3,
                               exchange), forwards=[])
            continue
        log = []
        undo = record_forwards(log) if i == 0 else (lambda: None)
        try:
            res = run_round(X, y, ps, spec, cfg, *prob["masks"], prob["classes"], seed=3,
                            track_history=True, mesh=grid, shard_features=sf)
        finally:
            undo()
        out[dropout, sf, exchange] = dict(history=res.history, losses=res.losses,
                                          metrics=res.metrics, best_val=res.best_val_acc,
                                          forwards=log)
    return out


def exchange_variants(grid, prob, choices):
    """For each model choice (``PaggSpec`` keywords), one sharded step with
    X replicated and one with X row-sharded through each exchange, from the
    same parameters, walks and masks: the loss and (rank 0) the gradients."""
    from pathnet_tpu_torch.models import draw_dropout_masks
    from pathnet_tpu_torch.train.trainer import epoch_uniforms

    ps, X, y = round_setup(prob)
    tr = torch.arange(0, 40, dtype=torch.int32)
    va = torch.arange(40, 80, dtype=torch.int32)
    u = epoch_uniforms(ps, 0, 0)
    out = {}
    for kw in choices:
        spec = PaggSpec(**{**prob["spec"], **kw})
        masks = draw_dropout_masks(spec, tr.shape[0], prob["nw"],
                                   torch.Generator().manual_seed(5), "cpu")
        init = PathNet(spec, device="cpu", generator=torch.Generator().manual_seed(0))
        for ex in (None,) + tuple(sorted(EXCHANGES)):
            model = _model(spec, {k: v.numpy() for k, v in init.state_dict().items()})
            step = sharded_train_step(grid, model, prob["classes"], shard_features=ex is not None,
                                      exchange=ex or "gspmd")
            res = step(X if ex is None else shard_rows(X, grid.data_axis), y, ps, tr, va, u,
                       masks)
            out[tuple(sorted(kw.items())), ex] = (
                res.loss, {k: v.numpy() for k, v in res.grads.items()} if grid.rank == 0
                else None)
    return out


def train_suite(grid, prob, choices):
    """Everything ``tests/test_torch_parallel_train.py`` compares, in one
    spawn."""
    return {"rounds": rounds(grid, prob), "variants": exchange_variants(grid, prob, choices)}
