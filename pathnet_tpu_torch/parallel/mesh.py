"""Data- and model-parallel training over the rank grid (port of
``pathnet_tpu/parallel/mesh.py``).

JAX partitions one program over a ``('data', 'model')`` mesh with GSPMD; the
port runs one process a rank (:mod:`~pathnet_tpu_torch.parallel.comm`) and
makes JAX's partitioning explicit:

- ``data`` splits the targets: a batch (a microbatch chunk in the trainer)
  is padded to a multiple of the axis with zero-weight rows and rank ``r``
  takes its ``r``-th contiguous share (:func:`share`). Each rank walks only
  the starts of its share, on its columns of the whole epoch's uniforms
  (:func:`rank_uniforms`), so its walks are those of the one-process epoch
  bit for bit, as JAX's values are unchanged under partitioning; dropout
  masks are drawn for the whole batch and sliced the same way
  (:func:`share_masks`). The gradients are summed over the axis once a step,
  in one flat all-reduce (:func:`sum_grads`).
- ``shard_features``: the feature matrix lives row-sharded over ``data``
  (:func:`shard_rows`), and the model reaches other ranks' rows through a
  :class:`FeatureExchange`: ``gspmd`` all-gathers the projected table (the
  collective GSPMD inserts), ``ring`` and ``sparse`` gather only the rows
  the walks visit (``parallel/ring.py``, ``parallel/sparse.py``).
- ``model`` shards the hidden-dimension parameters
  (:func:`param_shardings`): each rank of the axis keeps, and updates with
  Adam, only its rows of each sharded parameter and their Adam moments
  (:class:`ParamShards`), and all-gathers the whole parameters in one flat
  collective before each forward. Adam is elementwise, so the result equals
  the replicated step's bit for bit. Only the optimizer's state and update
  are split: every rank of the model axis still runs the whole forward and
  backward on its data share, where GSPMD splits JAX's products.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import torch

from .comm import Axis, Grid, all_gather, all_reduce
from .ring import make_ring_gather, pad_rows
from .sparse import make_sparse_gather, make_sparse_gather_sharded

EXCHANGES = ("gspmd", "ring", "sparse")
REPLICATED = ("attw", "fc2")   # the small head stays replicated (mesh.py:71-72)


# ------------------------------------------------------------ data partition

def shard_rows(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """This rank's row block of ``x`` padded with zero rows to a multiple of
    the axis (rank ``r`` owns rows ``r * bs`` to ``r * bs + bs``)."""
    xp, _ = pad_rows(x, axis.size)
    bs = xp.shape[0] // axis.size
    return xp[axis.index * bs:(axis.index + 1) * bs].contiguous()


def padded_width(width: int, d: int) -> int:
    return -(-width // d) * d


def share(idx: torch.Tensor, w: torch.Tensor, axis: Axis) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's contiguous share of one batch ``idx [C]`` (int32) with
    weights ``w [C]``, padded to a multiple of the axis with node 0 at
    weight 0 (``trainer._pad_chunks``' padding)."""
    C = idx.shape[0]
    pad = padded_width(C, axis.size) - C
    if pad:
        idx = torch.cat([idx, idx.new_zeros(pad)])
        w = torch.cat([w, w.new_zeros(pad)])
    k = idx.shape[0] // axis.size
    sl = slice(axis.index * k, (axis.index + 1) * k)
    return idx[sl].contiguous(), w[sl].contiguous()


def share_masks(masks, width: int, axis: Axis):
    """This rank's rows of the dropout keep masks of a batch of ``width``
    targets (``models.pagg.draw_dropout_masks``: ``[wl, width * nw, H]`` and
    ``[width, 2H]``), the padding targets' rows zero."""
    if masks is None or axis.size == 1:
        return masks
    m1, m2 = masks
    wl, _, H = m1.shape
    nw = m1.shape[1] // width
    Cp = padded_width(width, axis.size)
    k = Cp // axis.size
    lo, hi = axis.index * k, min((axis.index + 1) * k, width)
    r1 = m1.new_zeros((wl, k * nw, H))
    r2 = m2.new_zeros((k, m2.shape[1]))
    if hi > lo:
        r1[:, :(hi - lo) * nw] = m1[:, lo * nw:hi * nw]
        r2[:hi - lo] = m2[lo:hi]
    return r1, r2


def rank_uniforms(u: torch.Tensor, starts: torch.Tensor, nw: int) -> torch.Tensor:
    """The columns of the whole epoch's draws ``u`` (``[wl - 1, n * nw]``, or
    ``[wl - 1, 2, n * nw]`` for the alias tables; walker ``s * nw + j`` is
    start ``s``'s ``j``-th walk) that the walks of ``starts`` take."""
    cols = (starts.long()[:, None] * nw
            + torch.arange(nw, device=starts.device)).reshape(-1).to(u.device)
    return u.index_select(u.dim() - 1, cols)


def walk_starts(ps, u: torch.Tensor, starts: torch.Tensor):
    """``(paths, dists)`` of ``starts`` on their columns of the whole epoch's
    draws ``u``: those rows of the walks of every node on ``u``."""
    return ps.sample(starts, u=rank_uniforms(u, starts, ps.num_walks))


def sum_grads(model: torch.nn.Module, loss: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Sum every parameter's ``.grad`` and ``loss`` over the axis in one
    flat all-reduce (a fixed order: the parameters', then the loss);
    returns the summed loss."""
    if axis.size == 1:
        return loss
    params = list(model.parameters())
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1) for p in params] + [loss.reshape(1)])
    all_reduce(flat, axis)
    at = 0
    for p in params:
        p.grad.copy_(flat[at:at + p.numel()].view_as(p))
        at += p.numel()
    return flat[-1]


# ---------------------------------------------------------- feature exchange

class FeatureExchange:
    """How ``PathNet.forward`` reaches rows of the table when ``X`` is this
    rank's row block (``pathnet_tpu/models/pagg.py:200-209``'s
    ``gather_fn``, done on both the walk rows and the ego rows).

    ``gspmd`` all-gathers the block-projected ``h`` (and the bf16 table) into
    the whole table, and K3 and K5 run on it as on one process; its backward
    is a reduce-scatter of ``dh``. ``ring`` and ``sparse`` (and
    ``sparse_replicated``, serving's replicated requests) gather the walks'
    rows and the ego rows, ``[m + T, H]``, and K3 reads them as a table of
    ``m`` rows with the ids ``arange(m)``; K4's ``dh [m, H]`` flows back
    through the exchange's backward to the owners."""

    def __init__(self, grid: Grid, kind: str):
        if kind not in EXCHANGES + ("sparse_replicated",):
            raise ValueError(f"unknown exchange {kind!r}")
        self.kind, self.axis = kind, grid.data_axis
        self.gather = {"gspmd": None, "ring": make_ring_gather,
                       "sparse": make_sparse_gather_sharded,
                       "sparse_replicated": make_sparse_gather}[kind]
        if self.gather is not None:
            self.gather = self.gather(grid)

    def tables(self, table: torch.Tensor, h: torch.Tensor, paths: torch.Tensor,
               ego_idx: torch.Tensor):
        """``(table, h, paths, ego_idx)`` for K3 and K5 from this rank's
        blocks ``table`` (K3's, f32 or bf16) and ``h`` (the f32 projection;
        the same tensor as ``table`` in f32)."""
        same = table is h
        if self.gather is None:
            hf = all_gather(h, self.axis)
            tf = hf if same else all_gather(table.float(), self.axis).to(table.dtype)
            return tf, hf, paths, ego_idx
        T, nw, wl = paths.shape
        m = T * nw * wl
        seq = torch.arange(m, dtype=torch.int32, device=paths.device).reshape(T, nw, wl)
        if same:
            rows = self.gather(h, torch.cat([paths.reshape(-1), ego_idx]))
            ego = torch.arange(m, m + T, dtype=torch.int32, device=paths.device)
            return rows, rows, seq, ego
        tf = self.gather(table.float(), paths.reshape(-1)).to(table.dtype)
        hf = self.gather(h, ego_idx)
        return tf, hf, seq, torch.arange(T, dtype=torch.int32, device=paths.device)


# ------------------------------------------------------- parameter sharding

def param_shardings(params, model_size: int) -> Dict[str, Optional[int]]:
    """The model-axis sharding of each parameter (``mesh.py:59-79``): the dim
    sharded (0) or None (replicated), by name.

    JAX shards a hidden-dimension tensor on its last axis where the axis size
    divides it, and keeps ``attw`` and ``fc2`` replicated. JAX's ``[in, out]``
    kernel is torch's ``[out, in]`` weight, and the JAX package stacks the
    distance layers on a leading axis, so JAX's last axis is dim 0 of every
    torch tensor here: ``fc0``, each ``nets.k``, the LSTM's ``[4H, H]`` (the
    GRU's ``[3H, H]``, the MLP's ``[H, H]``) weights and their biases are
    sharded on their output rows. ``params`` is a module or a state dict."""
    items = params.named_parameters() if isinstance(params, torch.nn.Module) else params.items()
    return {name: (0 if model_size > 1 and name.split(".")[0] not in REPLICATED
                   and p.shape[0] % model_size == 0 else None)
            for name, p in items}


def shard_state_dict(state: Mapping[str, torch.Tensor], specs: Mapping[str, Optional[int]],
                     model_size: int, index: int) -> Dict[str, torch.Tensor]:
    """Rank ``index``'s shard of a state dict over a model axis of
    ``model_size`` ranks (a JAX checkpoint: ``params_from_jax`` first)."""
    out = {}
    for name, t in state.items():
        if specs.get(name) is None:
            out[name] = t
        else:
            k = t.shape[0] // model_size
            out[name] = t[index * k:(index + 1) * k]
    return out


def unshard_state_dict(parts: List[Mapping[str, torch.Tensor]],
                       specs: Mapping[str, Optional[int]]) -> Dict[str, torch.Tensor]:
    """The whole state dict from every model-axis rank's shard, in order."""
    return {name: (torch.cat([p[name] for p in parts]) if specs.get(name) is not None
                   else parts[0][name]) for name in parts[0]}


class ParamShards:
    """This rank's model-axis shards of ``model``'s parameters, which the
    optimizer updates; :meth:`gather` writes the whole parameters back into
    the model for the next forward."""

    def __init__(self, model: torch.nn.Module, axis: Axis):
        self.model, self.axis = model, axis
        self.specs = param_shardings(model, axis.size)
        full = {n: p.detach() for n, p in model.named_parameters()}
        self.shards = {n: torch.nn.Parameter(t.clone()) for n, t in
                       shard_state_dict(full, self.specs, axis.size, axis.index).items()}

    def parameters(self) -> List[torch.nn.Parameter]:
        return list(self.shards.values())

    def load_grads(self) -> None:
        """Each shard's gradient: its rows of the model's summed ``.grad``."""
        grads = {n: p.grad for n, p in self.model.named_parameters()}
        for n, t in shard_state_dict(grads, self.specs, self.axis.size,
                                     self.axis.index).items():
            self.shards[n].grad = t.clone()

    @torch.no_grad()
    def gather(self) -> None:
        """The whole parameters back into the model: the sharded ones from
        one flat all-gather of every shard, in the parameters' order."""
        sharded = []
        for n, p in self.model.named_parameters():
            if self.specs[n] is None:
                p.copy_(self.shards[n])
            else:
                sharded.append((n, p))
        if not sharded:
            return
        flat = torch.cat([self.shards[n].detach().reshape(-1) for n, _ in sharded])
        every = all_gather(flat, self.axis).view(self.axis.size, -1)
        at = 0
        for n, p in sharded:
            k = self.shards[n].numel()
            # each rank's shard is a block of dim 0: in rank order, the whole
            p.copy_(every[:, at:at + k].reshape(p.shape))
            at += k


# -------------------------------------------------------------- sharded step

@dataclasses.dataclass
class StepResult:
    loss: float                  # mean CE over the whole batch
    val_acc: float               # after the update, over every val entry
    logits: torch.Tensor         # this rank's training logits
    grads: Dict[str, torch.Tensor]   # summed over the data axis, before the update


class ShardedStep:
    """One training step with validation on the grid (``mesh.py:82-179``):
    walk, loss, Adam, then the validation accuracy. Made by
    :func:`sharded_train_step`."""

    def __init__(self, grid: Grid, model, num_classes: int, lr: float, weight_decay: float,
                 shard_features: bool, exchange: str, shard_params: bool):
        from ..train.trainer import make_optimizer

        if exchange not in EXCHANGES:
            raise ValueError(f"unknown exchange {exchange!r}")
        self.grid, self.model = grid, model
        self.exchange = FeatureExchange(grid, exchange) if shard_features else None
        self.shards = ParamShards(model, grid.model_axis) if shard_params else None
        self.opt = make_optimizer(self.shards.parameters() if shard_params
                                  else model.parameters(), lr, weight_decay)

    def __call__(self, X: torch.Tensor, y: torch.Tensor, ps, train_idx: torch.Tensor,
                 val_idx: torch.Tensor, u: torch.Tensor, masks=None) -> StepResult:
        """``X``: this rank's row block (:func:`shard_rows`) with
        ``shard_features``, else the whole matrix; ``train_idx`` and
        ``val_idx`` (int32) padded by the caller to a multiple of the data
        axis, as JAX's step wants them; ``u`` the whole epoch's draws
        (``ps.uniform_shape(n * nw)``); ``masks`` the whole batch's dropout
        keep masks, or None."""
        from ..train.trainer import weighted_ce

        axis, model, dev = self.grid.data_axis, self.model, X.device
        if train_idx.shape[0] % axis.size or val_idx.shape[0] % axis.size:
            raise ValueError(f"pad train_idx and val_idx to a multiple of {axis.size}")
        walk = lambda starts: walk_starts(ps, u, starts)
        tr, wt = share(train_idx.to(dev), torch.ones(train_idx.shape[0], device=dev), axis)
        paths, dists = walk(tr)
        model.zero_grad(set_to_none=True)
        logits = model(X, paths, dists, tr, train=True,
                       masks=share_masks(masks, train_idx.shape[0], axis),
                       exchange=self.exchange)
        part = weighted_ce(logits, y[tr.long()], wt)
        part.backward()
        loss = sum_grads(model, part.detach(), axis) / train_idx.shape[0]
        for p in model.parameters():
            p.grad /= train_idx.shape[0]
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        if self.shards is not None:
            self.shards.load_grads()
            self.opt.step()
            self.shards.gather()
        else:
            self.opt.step()
        va, _ = share(val_idx.to(dev), torch.ones(val_idx.shape[0], device=dev), axis)
        vp, vd = walk(va)
        with torch.no_grad():
            pred = model(X, vp, vd, va, exchange=self.exchange).argmax(-1)
            correct = all_reduce((pred == y[va.long()]).sum().float(), axis)
        return StepResult(loss=float(loss), val_acc=float(correct) / val_idx.shape[0],
                          logits=logits.detach(), grads=grads)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The whole parameters, as every rank holds them after a step."""
        return {n: p.detach().clone() for n, p in self.model.named_parameters()}


def sharded_train_step(grid: Grid, model, num_classes: int, lr: float = 0.005,
                       weight_decay: float = 0.0005, shard_features: bool = False,
                       exchange: str = "gspmd", shard_params: bool = False) -> ShardedStep:
    """The SPMD train-and-validate step of ``model`` (a ``PathNet`` on the
    grid's device, the same parameters on every rank) with the optimizer
    ``make_optimizer(lr, weight_decay)``: JAX's
    ``sharded_train_step(mesh, spec, optimizer, num_classes, shard_features,
    exchange, shard_params)`` (``num_classes`` kept for its signature; the
    accuracy needs none). ``exchange`` is ``gspmd``, ``ring`` or ``sparse``
    (used with ``shard_features``); ``shard_params`` shards the
    hidden-dimension parameters over the model axis."""
    return ShardedStep(grid, model, num_classes, lr, weight_decay, shard_features, exchange,
                       shard_params)
