"""K4 ``pagg_encode_bwd``: the backward of K3, in f32 or with bf16 compute.

Replaces the VJP of ``pathnet_tpu/models/pagg.py:235-303`` (what ``jax.grad``
derives for the encode block and the attention readout) together with the
gather VJP of the "h" gather mode (``pagg.py:83-93``). Given ``g``, the
gradient of K3's output ``[T, H]``, it returns the gradients of K3's inputs:
``dh [n, H]`` and those of ``wd, bd, w_ih, w_hh, b_ih, b_hh, attw, attb``.

Both variants of K3 (``homo=False``, hetero, and ``homo=True``), its
readouts (``agg``: attention, mean, sum and the quirk's) and its three
cells (``cell``: the LSTM, the GRU in K3's packed layout, the MLP) have
their backward here; the variant is a template parameter (``HOMO``) of each
launch, the readout (``AGG``, ``QUIRK``) of the attention backward and the
cell (``CELL``) of the recompute and the BPTT, so the LSTM and attention
instances are the code they were before the others came.

Source: ``pathnet_tpu_torch/csrc/pagg_encode_bwd.cu`` on K3's walk tile
(``csrc/pagg_tile.cuh``), three launches behind the one wrapper (one count a
call). Nothing is kept between K3 and K4, so the first launch recomputes the
forward.

1. The forward recompute is K3's encode kernel, on K3's grid of tiles of
   ``M`` walks across targets, run so that it also writes per walk step the
   gathered row ``xr``, the LSTM input ``xin`` after dropout, ``h_{t-1}`` as
   ``hp``, ``c_t`` as ``cs`` (``[wl, T * nw, H]`` each, row ``t * T * nw +
   b``) and the gate activations ``gt`` ``[wl, T * nw, 4H]``, besides
   ``h_n`` ``[T * nw, H]`` into a scratch.
2. The attention backward, one block per target: the scores and the softmax
   again from ``h_n``, ``d h_n`` into a second scratch ``[T * nw, H]``, the
   ego rows' gradient to its rows ``[T * nw, H]``, and the target's terms of
   ``dattw`` and ``dattb`` to its row of ``[T, 2H + 1]`` partial sums, which
   the wrapper sums over the targets (``torch.sum`` over a fixed shape);
   under mean and sum ``d h_n`` alone (below).
3. BPTT on the same tiles: a thread keeps ``dh`` and ``dc`` of 8 walks x 2
   units in registers down the steps. Each step forms the pre-activation
   gate gradients (written over ``gt``); one register-tiled product with
   ``[w_ih; w_hh]^T`` gives the LSTM input's gradient and ``dh_{t-1}``; the
   keep mask turns the first into ``dsel`` (its stream); one product per
   distance class present in the tile with ``wd[k]^T`` gives each gathered
   row's gradient, stored in ``dsel``'s layout ``[wl, T * nw, H]``.
4. :func:`~pathnet_tpu_torch.kernels.segment_sum.segment_sum` adds the row
   gradients of 2. and 3. into ``dh [n, H]``, each node's in the order of a
   stable sort of the paths' node ids (its own launch and count).

**Mean and sum** (``pagg.py:304-307``): 2. reads ``g`` alone and writes
``d h_n = g / nw`` (mean) or ``g`` (sum) to every walk, and nothing else
(16-byte stores over the flat ``[T * nw, H]``: its bound is those bytes);
``dattw`` and ``dattb`` are exact zero tensors that the wrapper makes (not
None: the trainer's additive L2 still decays them, as JAX's does). No ego
row gets a gradient: the hetero rows are ``wl`` a walk
(:func:`row_nodes` with ``agg``), and the homo BPTT is given no ``d ego``
(it still reads ``ego`` for the ReLU's sign at step 0).

**The GRU** (K3's packed weights, :func:`~pathnet_tpu_torch.kernels.pagg_encode.pack_gru`):
1. writes ``gt`` as ``(r, z, n, h W_hn + b_hn)`` and ``hp``, and no ``cs``
(the GRU has no cell state); 3. reads ``h_{t-1}`` from ``hp`` and carries
only ``dh``: ``dn = dh (1 - z)``, ``dz = dh (h_{t-1} - n)``, ``da = dn (1 -
n^2)``, and the four packed gate gradients ``(da (h W_hn + b_hn) r (1 - r),
dz z (1 - z), da, da r)``; after the shared ``[4H] -> [2H]`` product it adds
the direct term ``z dh`` into ``dh_{t-1}``. The contractions then give the
packed weights' gradients, ``xin^T dgates`` and ``hp^T dgates`` and ``db``
for both biases, which autograd unpacks through the model's packing
(:func:`~pathnet_tpu_torch.kernels.pagg_encode.pack_gru`): ``dW_ih`` is
``xin^T dgates``' groups 0-2, ``dW_hh`` is ``hp^T dgates``' groups 0, 1
and 3, ``db_ih = db[0:3H]`` and ``db_hh = [db_r, db_z, db_3]``. The entries
in the zero blocks (``dW_ih``'s and ``db_ih``'s group 3, ``dW_hh``'s and
``db_hh``'s group 2) are the packing's constants' and are dropped there; the
plain version returns zeros in them, so the two agree after
:func:`~pathnet_tpu_torch.kernels.pagg_encode.unpack_gru`.

**The MLP** (``cell="mlp"``; ``W`` as ``w_ih``, ``b`` as ``b_ih``): 1. writes
``xr``, ``xin`` and, in ``hp``'s place, the walks' mean input ``m [T * nw,
H]``, and no ``cs`` or ``gt``; 3. has no recurrence: one product ``d s = (d
h_n W^T) / wl`` a tile, the same for every step, then each step's dropout,
homo ReLU and distance select as above. The contractions give ``dW = m^T d
h_n`` and ``db = sum d h_n`` over the walks; ``w_hh`` and ``b_hh`` are empty
and so are their gradients.

**quirk_compat** (``agg="quirk"``, hetero, f32): the wrapper runs the hetero
launches on :func:`~pathnet_tpu_torch.kernels.pagg_encode.quirk_layout`'s
walks and keep mask columns; 2. reads the ego rows at the layout's ego nodes
and scales its cotangent by ``1 / nw`` (the readout's mean), and the ego
rows' gradients go to those nodes (:func:`row_nodes` with ``ego``).

Homo (``pagg.py:257-303``): the steps run in sampled order (step ``t`` holds
position ``t``); 1. also writes the ego rows ``ego [T * nw, H]``, the ReLU'd
step-0 selected rows before dropout, and ``xin`` holds the ReLU'd input
after dropout; 2. reads ``ego`` for the scores, forms ``d score = g . h_n /
nw`` and ``d h_n = (1 + score) g / nw + d score attw[:H]``, and writes
``d ego`` to a scratch (not a row gradient: the ego row is step 0's selected
row); 3. adds ``d ego`` to step 0's ``dsel`` and multiplies every ``dsel``
by the ReLU's derivative, its sign read from ``ego`` at step 0 and from
``xin`` after (where the mask dropped an entry its ``dsel`` is 0 whatever
the sign). So 4. sums ``wl`` rows a walk, not ``wl + 1``.

**bf16 compute** (K3's bf16 instances: ``h`` and ``wd, bd, w_ih, w_hh, b_ih,
b_hh`` bf16, all or none): 1. is K3's bf16 encode, so the streams hold the
forward's rounded values, kept in f32, which holds them exactly; 2. reads
the hetero ego rows from the bf16 table; 3. stages the bf16 weights as K3
does and multiplies on the bf16 tensor cores too, each f32 cotangent of its
products split into two bf16 halves, ``hi = bf16(a)`` and ``lo = bf16(a -
hi)``, both multiplied into the same f32 sums (within ~2^-16 relative of the
f32 product). Every cotangent stays f32: the derivative of each rounding is
taken as the identity (JAX's convert VJP only changes the cotangent's
type). ``dh``
(from 4., f32) and the six cast weights' gradients are returned as bf16, the
type of their inputs, as JAX's cotangents of a bf16 cast are; ``dattw`` and
``dattb`` stay f32. The plain version differentiates K3's bf16 plain version
in f32 and rounds those seven gradients once at the end, as the kernel path
does.

No launch adds with atomics and every reduction has an order fixed by the
inputs, so one input gives one result, bit for bit, on every run: a seeded
round on the card is reproducible (``tests/test_torch_reproducible.py``).

The weight gradients are contractions of the streams over all rows
(:func:`contractions`, the kernel :func:`pagg_contract`: tiles of the
weights over ranges of rows, staged by TMA and multiplied with ``wgmma`` on
the TF32 tensor cores, their partial sums added in a fixed order; its plain
version :func:`contractions_plain` is
``torch.matmul`` and ``bmm`` over padded copies regrouped by class). Memory
held during the call: the streams, 9 ``H`` floats per walk step (3.0 GB for
one 8192-target bgp microbatch, nw = 40, wl = 4, H = 64); the row
gradients, ``H`` floats per walk step and per walk (0.42 GB there); the two
scratches ``h_n`` and ``d h_n``, ``[T * nw, H]`` each (84 MB each there); and
the contractions' partial sums (17.5 MB there). Homo holds ``ego`` and ``d
ego`` (84 MB each there) in place of the ego rows' gradients. All are freed
on return.

:func:`encode_walks_streams`, :func:`attention_bwd` and :func:`bptt` launch
each stage alone (for timing and tests; they count no launch), beside plain
versions written out by hand; with :func:`contractions` the plain stages
compose to :func:`pagg_encode_bwd_plain`.

Bound on the H100: f32 operations, about 54 ``H^2`` flops per walk step
(forward recompute 18, backward products 18, weight-gradient contractions
18), about 290 GFLOP or 4.3 ms at 67 TFLOP/s per bgp microbatch, for either
variant (homo's extra work is per element); the bf16 instances' at bf16's
tensor-core rate, 0.29 ms. The GRU needs 42 H^2 (14 each), 3.4 ms there,
though the packed products run the LSTM's 54; the MLP 7.5 H^2 at wl = 4
(0.59 ms), its 3 stream floats a walk step (1.0 GB) about as long at
3.35 TB/s.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import build
from .pagg_encode import (AGGS, CELLS, _check as check_encode, cell_shapes, check_choices,
                          check_keep_mask, check_quirk, compute_dtype, dropout_divisor,
                          dropout_plain, gather_rows, gru_bf16_steps, is_bf16,
                          lstm_bf16_steps, mlp_plain, pagg_encode_fwd_plain, ptr,
                          quirk_layout, select_plain)
from .segment_sum import segment_sum

Grads = Tuple[torch.Tensor, ...]


def pagg_encode_bwd_plain(g, h, paths, dists, wd, bd, w_ih, w_hh, b_ih, b_hh,
                          attw, attb, keep_mask=None, keep=1.0, homo=False,
                          bf16=False, agg="attention", cell="lstm") -> Grads:
    """Plain PyTorch version: ``torch.autograd.grad`` through
    :func:`pagg_encode_fwd_plain` with the same mask, variant, readout and
    cell, taken in f32; each gradient returned in its input's type (``bf16``
    as in :func:`~pathnet_tpu_torch.kernels.pagg_encode.encode_walks_plain`),
    and as zeros where the output does not depend on the input (``attw``,
    ``attb`` under mean and sum)."""
    bf16 = is_bf16(h, bf16)
    inputs = (h, wd, bd, w_ih, w_hh, b_ih, b_hh, attw, attb)
    with torch.enable_grad():
        leaves = [t.detach().float().requires_grad_(True) for t in inputs]
        lh, lwd, lbd, lwi, lwh, lbi, lbh, law, lab = leaves
        out = pagg_encode_fwd_plain(lh, paths, dists, lwd, lbd, lwi, lwh, lbi,
                                    lbh, law, lab, keep_mask, keep, homo, bf16, agg, cell)
        grads = torch.autograd.grad(out, leaves, g, allow_unused=True)
    return tuple((torch.zeros_like(t) if d is None else d).to(t.dtype)
                 for d, t in zip(grads, inputs))


def _step_classes(dists: torch.Tensor, homo: bool = False) -> torch.Tensor:
    """int64 ``[wl, T * nw]``: the clipped distance class of step ``t`` of
    each walk (step ``t`` holds position ``wl - 1 - t``, homo ``t``)."""
    T, nw, wl = dists.shape
    d = dists if homo else dists.flip(2)
    return d.clamp(0, wl - 1).reshape(T * nw, wl).t().contiguous().long()


def encode_walks_streams_plain(h, paths, dists, wd, bd, w_ih, w_hh, b_ih, b_hh,
                               keep_mask=None, keep=1.0, homo=False, bf16=False,
                               cell="lstm"):
    """Plain version of the forward recompute: ``(h_n, xr, xin, hp, cs, gt)``,
    and with ``homo`` the ego rows ``ego [T * nw, H]`` after them; all f32,
    with ``bf16`` (or a bf16 ``h``) the bf16 forward's rounded values. The
    GRU (packed weights) has ``cs`` None and ``gt`` ``(r, z, n, h W_hn +
    b_hn)``; the MLP has ``hp`` its mean input ``m [T * nw, H]`` and ``cs``,
    ``gt`` None."""
    bf16 = is_bf16(h, bf16)
    check_choices(cell=cell)
    if bf16:
        h, wd, bd, w_ih, w_hh, b_ih, b_hh = (t.float() for t in
                                             (h, wd, bd, w_ih, w_hh, b_ih, b_hh))
    T, nw, wl = paths.shape
    H = h.shape[1]
    B = T * nw
    xr = gather_rows(h, paths)
    if not homo:
        xr = xr.flip(2)
    xr = xr.reshape(B, wl, H).transpose(0, 1).contiguous()
    xin = select_plain(xr, _step_classes(dists, homo)[:, :, None], wd, bd, homo, bf16)
    ego = xin[0].clone() if homo else None
    xin = dropout_plain(xin, keep_mask, keep, bf16)
    if cell == "mlp":
        m, hn = mlp_plain(xin, w_ih, b_ih, bf16)
        out = (hn, xr, xin, m, None, None)
        return out + (ego,) if homo else out
    if bf16:
        steps = gru_bf16_steps if cell == "gru" else lstm_bf16_steps
        hp, gt, cs, hn = zip(*steps(xin, w_ih, w_hh, b_ih, b_hh))
        out = (hn[-1], xr, xin, torch.stack(hp), None if cell == "gru" else torch.stack(cs),
               torch.stack(gt))
        return out + (ego,) if homo else out
    gx = xin @ w_ih + b_ih
    hprev = h.new_zeros((B, H))
    c = h.new_zeros((B, H))
    hp, cs, gt = [], [], []
    if cell == "gru":
        for t in range(wl):
            ar, az, an, a3 = (gx[t] + hprev @ w_hh + b_hh).chunk(4, dim=1)
            r, z = torch.sigmoid(ar), torch.sigmoid(az)
            n = torch.tanh(an + r * a3)
            hp.append(hprev)
            gt.append(torch.cat([r, z, n, a3], dim=1))
            hprev = (1.0 - z) * n + z * hprev
        out = (hprev, xr, xin, torch.stack(hp), None, torch.stack(gt))
        return out + (ego,) if homo else out
    for t in range(wl):
        i, f, gg, o = (gx[t] + hprev @ w_hh + b_hh).chunk(4, dim=1)
        si, sf, tg, so = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(gg), torch.sigmoid(o)
        c = sf * c + si * tg
        hp.append(hprev)
        cs.append(c)
        gt.append(torch.cat([si, sf, tg, so], dim=1))
        hprev = so * torch.tanh(c)
    out = (hprev, xr, xin, torch.stack(hp), torch.stack(cs), torch.stack(gt))
    return out + (ego,) if homo else out


def attention_bwd_plain(g, h, paths, hn, attw, attb, ego=None, agg="attention"):
    """Plain version of the attention backward: ``(dhn, dego, dattw, dattb)``,
    ``dego [T * nw, H]`` holding each walk's ego row gradient; homo where the
    ego rows ``ego [T * nw, H]`` (the recompute's) are given; ``h`` f32 or
    the bf16 table. Under ``agg`` mean or sum: ``g / nw`` or ``g`` for every
    walk, ``dego`` None (the ego rows get no gradient) and zero ``dattw``,
    ``dattb``. Under "quirk" the hetero attention backward of ``g / nw`` (the
    readout's mean), the ego rows at ``paths[:, :, 0]``."""
    T, nw, _ = paths.shape
    H = h.shape[1]
    if agg in ("mean", "sum"):
        dhn = (g / nw if agg == "mean" else g).repeat_interleave(nw, dim=0)
        return dhn, None, attw.new_zeros(2 * H), attb.new_zeros(1)
    if agg == "quirk":
        g = g / nw
    h_n = hn.reshape(T, nw, H)
    e = gather_rows(h, paths[:, :, 0]).float() if ego is None else ego.reshape(T, nw, H)
    score = h_n @ attw[:H] + e @ attw[H:] + attb                     # [T, nw]
    datt = (h_n * g[:, None, :]).sum(-1)
    if ego is None:
        att = torch.softmax(F.leaky_relu(score, 0.01), dim=1)
        ds = att * (datt - (att * datt).sum(1, keepdim=True))
        ds = ds * torch.where(score > 0, 1.0, 0.01)
    else:
        att = (1.0 + score) / nw
        ds = datt / nw
    dhn = att[:, :, None] * g[:, None, :] + ds[:, :, None] * attw[:H]
    dego = ds[:, :, None] * attw[H:]
    dattw = torch.cat([(ds[:, :, None] * h_n).sum((0, 1)),
                       (ds[:, :, None] * e).sum((0, 1))])
    return dhn.reshape(T * nw, H), dego.reshape(T * nw, H), dattw, ds.sum().reshape(1)


def bptt_plain(dhn, paths, dists, wd, w_ih, w_hh, state, gt, keep_mask=None, keep=1.0,
               homo=None, bf16=False, cell="lstm"):
    """Plain version of the BPTT: ``(drow, dgates, dsel)``, ``drow [wl, T * nw,
    H]`` holding every gathered row's gradient (row ``t * T * nw + b`` is
    position ``wl - 1 - t`` of walk ``b``, homo position ``t``), ``dgates [wl,
    T * nw, 4H]`` the pre-activation gate gradients and ``dsel [wl, T * nw,
    H]`` the gradient of the selected row (homo: before its ReLU). ``state``
    is the recompute's ``cs`` (LSTM) or ``hp`` (``cell="gru"``, packed
    weights); the MLP (``w_ih`` its ``W``) reads no ``state`` and no ``gt``,
    and its ``dgates`` is None. ``homo`` is None (hetero) or ``(xin, ego,
    dego)``: the recompute's ``xin`` and ``ego`` and the attention backward's
    ``dego`` (None under the mean and sum readouts: no ego row gradient at
    step 0). ``bf16`` (or bf16 weights): the same f32 math on the weights'
    values (each rounding's derivative is 1), the dropout's divisor rounded
    as the forward's."""
    keep = dropout_divisor(keep, is_bf16(wd, bf16))
    wd, w_ih, w_hh = wd.float(), w_ih.float(), w_hh.float()
    d = _step_classes(dists, homo is not None)
    wl, H = d.shape[0], dhn.shape[1]
    drow = dhn.new_empty((wl,) + dhn.shape)
    dsel = torch.empty_like(drow)
    dgates = None if cell == "mlp" else torch.empty_like(gt)
    dht, dc = dhn, torch.zeros_like(dhn)
    ds = dhn @ w_ih.t() / wl if cell == "mlp" else None   # every step's d s
    for t in range(wl - 1, -1, -1):
        if cell == "mlp":
            dxin = ds
        else:
            if cell == "gru":
                r, z, n, a3 = (gt[t, :, k * H:(k + 1) * H] for k in range(4))
                dn = dht * (1 - z)
                da = dn * (1 - n * n)
                dg = torch.cat([da * a3 * r * (1 - r), dht * (state[t] - n) * z * (1 - z),
                                da, da * r], dim=1)
                direct = dht * z
            else:
                si, sf, tg, so = (gt[t, :, k * H:(k + 1) * H] for k in range(4))
                cp = state[t - 1] if t > 0 else torch.zeros_like(dc)
                tc = torch.tanh(state[t])
                dct = dc + dht * so * (1 - tc * tc)
                dg = torch.cat([dct * tg * si * (1 - si), dct * cp * sf * (1 - sf),
                                dct * si * (1 - tg * tg), dht * tc * so * (1 - so)], dim=1)
                dc = dct * sf
            dgates[t] = dg
            dxin = dg @ w_ih.t()
            dht = dg @ w_hh.t()
            if cell == "gru":
                dht = dht + direct
        if keep_mask is not None:
            dxin = torch.where(keep_mask[t].bool(), dxin / keep, 0.0)
        if homo is not None:
            xin, ego, dego = homo
            if t == 0 and dego is not None:
                dxin = dxin + dego
            dxin = torch.where((ego if t == 0 else xin[t]) > 0, dxin, 0.0)
        dsel[t] = dxin
        dx = torch.zeros_like(dxin)
        for k in range(wl):
            dx = torch.where(d[t, :, None] == k, dxin @ wd[k].t(), dx)
        drow[t] = dx
    return drow, dgates, dsel


def row_nodes(paths: torch.Tensor, homo: bool = False, agg: str = "attention",
              ego: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int32: the node of each row gradient, in the order of the BPTT's
    ``drow`` (step ``t`` holds position ``wl - 1 - t``) followed by the
    attention backward's ego rows, ``(wl + 1) * T * nw`` in all; homo (step
    ``t`` holds position ``t``, no ego rows) and the mean and sum readouts
    (no ego row gradient) ``wl * T * nw``. The ego rows lie at ``paths[:, :,
    0]``, or (the quirk) at ``ego[:, :, 0]``."""
    T, nw, wl = paths.shape
    if homo:
        return paths.reshape(T * nw, wl).t().reshape(-1)
    steps = paths.flip(2).reshape(T * nw, wl).t().reshape(-1)
    if agg in ("mean", "sum"):
        return steps
    return torch.cat([steps, (paths if ego is None else ego)[:, :, 0].reshape(-1)])


def class_contractions(x: torch.Tensor, s: torch.Tensor, d: torch.Tensor,
                       classes: int, tile: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """``dw[k] = sum over rows r with d[r] = k of x[r]^T s[r]`` and
    ``db[k] = sum of those s[r]``, for ``x, s [R, H]`` and int64 ``d [R]`` in
    ``[0, classes)``.

    Each row is contracted once and nothing waits on the host, so the K4
    wrapper can be captured in a CUDA graph: the rows are copied into a
    buffer in which every class starts on a ``tile`` boundary, so each
    ``[H, tile] @ [tile, H]`` tile product belongs to one class. A one-hot
    ``[classes, tiles]`` product sums each class's tiles, in an order that
    depends on the shapes alone (the tiles of other classes add exact zeros).
    """
    R, H = x.shape
    # [classes, R]: the scan runs along the contiguous dimension (a scan
    # along the outer one is a serial loop per column on the card)
    rank = (torch.arange(classes, device=d.device)[:, None] == d).cumsum(1)
    padded = (rank[:, -1] + tile - 1) // tile * tile  # each class's rows, padded
    ends = padded.cumsum(0)
    dest = (ends - padded)[d] + rank.gather(0, d[None])[0] - 1
    ntiles = R // tile + classes                      # >= ends[-1] / tile
    xp = x.new_zeros((ntiles * tile, H)).index_copy_(0, dest, x)
    sp = s.new_zeros((ntiles * tile, H)).index_copy_(0, dest, s).view(ntiles, tile, H)
    starts = torch.arange(ntiles, device=d.device) * tile
    cls = torch.bucketize(starts, ends, right=True).clamp_(max=classes - 1)
    prod = torch.bmm(xp.view(ntiles, tile, H).transpose(1, 2), sp)
    onehot = (torch.arange(classes, device=d.device)[:, None] == cls).to(x.dtype)
    dw = (onehot @ prod.view(ntiles, H * H)).view(classes, H, H)
    return dw, onehot @ sp.sum(dim=1)


def contractions_plain(xr, xin, hp, dsel, dgates, dists, homo=False, cell="lstm") -> Grads:
    """Plain version of :func:`pagg_contract`: ``torch.matmul`` and ``bmm``
    over the streams, the class-grouped sums through
    :func:`class_contractions`' padded copies."""
    wl, B, H = xr.shape
    dwd, dbd = class_contractions(xr.view(-1, H), dsel.view(-1, H),
                                  _step_classes(dists, homo).reshape(-1), wl)
    if cell == "mlp":
        return dwd, dbd, hp.t() @ dgates, hp.new_zeros((H, 0)), dgates.sum(dim=0)
    dg = dgates.view(wl * B, 4 * H)
    dw_ih = xin.view(-1, H).t() @ dg
    dw_hh = hp.view(-1, H).t() @ dg
    return dwd, dbd, dw_ih, dw_hh, dg.sum(dim=0)


def contract_route(H: int, *streams: torch.Tensor) -> str:
    """How :func:`pagg_contract`'s kernel stages ``streams`` (``[rows, H]``
    or ``[rows, 4H]`` f32, row-major): ``"tma"`` where a tensor map can
    describe every one (each starts at a 16-byte boundary and a row is a
    multiple of 16 bytes, ``H % 4 == 0``), else ``"cp.async"`` (4-byte copies
    into the same layout)."""
    aligned = all(t.data_ptr() % 16 == 0 for t in streams)
    return "tma" if H % 4 == 0 and aligned else "cp.async"


def pagg_contract(xr, xin, hp, dsel, dgates, dists, homo=False, cell="lstm") -> Grads:
    """The weight gradients from the streams: ``(dwd, dbd, dw_ih, dw_hh, db)``,
    ``db`` being both LSTM biases' gradient. ``xr``, ``xin``, ``hp``,
    ``dsel`` ``[wl, T * nw, H]`` and ``dgates`` ``[wl, T * nw, 4H]`` f32
    (every K4 instance keeps f32 streams), ``dists`` int32 ``[T, nw, wl]``.
    The MLP: ``hp`` its mean input ``m`` and ``dgates`` its ``d h_n`` ``[T *
    nw, H]`` (``xin`` unread), giving ``dw_ih = m^T d h_n``, an empty
    ``dw_hh [H, 0]`` and ``db = sum d h_n``.

    On the card the hand-written kernel ``csrc/pagg_contract.cu`` (three
    launches, one count a call) stages each split's rows of each stream once
    (TMA, or 4-byte ``cp.async`` where :func:`contract_route` says so) and
    multiplies on the TF32 tensor cores with ``wgmma`` and the 3xTF32 split,
    ``dwd``'s rows sorted by class a stage; the last launch adds the splits'
    partial sums in split order (no atomics: one input gives one result, bit
    for bit). Its scratch is those partial sums, 17.5 MB at the bgp
    microbatch (8192 targets, nw = 40, wl = 4, H = 64). On the CPU,
    :func:`contractions_plain`."""
    check_choices(cell=cell)
    mlp = cell == "mlp"
    dev = xr.device
    f32 = torch.float32
    build.require(xr, "xr", f32, (None, None, None), dev)
    wl, B, H = xr.shape
    build.require(dists, "dists", torch.int32, (None, None, wl), dev)
    if dists.shape[0] * dists.shape[1] != B:
        raise ValueError(f"dists: {tuple(dists.shape)} walks, the streams {B}")
    build.require(dsel, "dsel", f32, (wl, B, H), dev)
    if mlp:
        build.require(hp, "hp", f32, (B, H), dev)
        build.require(dgates, "dgates", f32, (B, H), dev)
    else:
        build.require(xin, "xin", f32, (wl, B, H), dev)
        build.require(hp, "hp", f32, (wl, B, H), dev)
        build.require(dgates, "dgates", f32, (wl, B, 4 * H), dev)
    if dev.type == "cpu":
        return contractions_plain(xr, xin, hp, dsel, dgates, dists, homo, cell)
    _require_device(dev, "pagg_contract")
    if H > 1024:
        raise ValueError(f"pagg_contract: hidden {H} > 1024 is not supported")
    lib = build.library()
    part = torch.empty(lib.pathnet_pagg_contract_scratch(B, wl, H, int(mlp)), dtype=f32,
                       device=dev)
    G = H if mlp else 4 * H
    sizes = [wl * H * H, wl * H, H * G, G] + ([] if mlp else [H * G])
    out = torch.empty(sum(sizes), dtype=f32, device=dev)
    streams = (xr, dsel, hp, dgates) if mlp else (xr, dsel, xin, hp, dgates)
    tma = contract_route(H, *streams) == "tma"
    with torch.cuda.device(dev):
        rc = lib.pathnet_pagg_contract(
            xr.data_ptr(), dsel.data_ptr(), None if mlp else xin.data_ptr(), hp.data_ptr(),
            dgates.data_ptr(), dists.data_ptr(), part.data_ptr(), out.data_ptr(), B, wl, H,
            int(homo), int(mlp), int(tma), build.stream_ptr(xr))
    build.check(rc, "pagg_contract")
    pagg_contract.launches += 1
    dwd, dbd, dw_ih, db, *hh = out.split(sizes)
    dw_hh = out.new_zeros((H, 0)) if mlp else hh[0].view(H, G)
    return dwd.view(wl, H, H), dbd.view(wl, H), dw_ih.view(H, G), dw_hh, db


pagg_contract.launches = 0
# K4's name for its weight contractions
contractions = pagg_contract


def _require_device(dev: torch.device, what: str) -> None:
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")


def _launch_streams(h, paths, dists, wd, bd, w_ih, w_hh, b_ih, b_hh, keep_mask, keep,
                    streams, ego=None, cell="lstm"):
    """Launch A into ``streams = (xr, xin, hp, cs, gt)`` (``cs`` None for the
    GRU; the MLP: ``hp`` its mean input, ``cs`` and ``gt`` None), homo where
    ``ego`` (which receives the ego rows) is given; returns ``h_n``."""
    T, nw, wl = paths.shape
    H = h.shape[1]
    bf16 = h.dtype == torch.bfloat16
    hn = torch.empty((T * nw, H), dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        rc = build.library().pathnet_pagg_encode_walks_streams(
            h.data_ptr(), paths.data_ptr(), dists.data_ptr(), wd.data_ptr(),
            bd.data_ptr(), w_ih.data_ptr(), w_hh.data_ptr(), b_ih.data_ptr(),
            b_hh.data_ptr(), ptr(keep_mask), dropout_divisor(keep, bf16), hn.data_ptr(),
            *(ptr(s) for s in streams), ptr(ego), T, nw, wl, H, int(bf16),
            CELLS.index(cell), build.stream_ptr(h))
    build.check(rc, "pagg_encode_bwd (forward recompute)")
    return hn


def _launch_attention(g, h, paths, hn, attw, attb, dego, ego=None, agg="attention"):
    """Launch B: the ego rows' gradient into ``dego [T * nw, H]`` (attention;
    None under mean and sum), homo where ``ego`` is given; returns ``(d h_n,
    dattw, dattb)``, the last two summed over the targets' partial sums
    (zero tensors under mean and sum, whose launch writes ``d h_n`` alone)."""
    T, nw, wl = paths.shape
    H = h.shape[1]
    dhn = torch.empty((T * nw, H), dtype=torch.float32, device=h.device)
    att = agg in ("attention", "quirk")
    part = torch.empty((T, 2 * H + 1), dtype=torch.float32, device=h.device) if att else None
    with torch.cuda.device(h.device):
        rc = build.library().pathnet_pagg_attention_bwd(
            g.data_ptr(), h.data_ptr(), paths.data_ptr(), hn.data_ptr(), ptr(ego),
            attw.data_ptr(), attb.data_ptr(), dhn.data_ptr(), ptr(dego), ptr(part),
            T, nw, wl, H, int(h.dtype == torch.bfloat16), AGGS.index(agg),
            build.stream_ptr(h))
    build.check(rc, "pagg_encode_bwd (attention)")
    if not att:
        return dhn, attw.new_zeros(2 * H), attb.new_zeros(1)
    dpart = part.sum(dim=0)
    return dhn, dpart[:2 * H], dpart[2 * H:]


def bptt_weights(wd, w_ih, w_hh):
    """The BPTT launch's operands, in the weights' type: ``wd`` transposed
    per class and ``[w_ih; w_hh]^T`` ``[4H, 2H]`` (the MLP: ``W^T [H, H]``)."""
    w = w_ih if w_hh.shape[1] == 0 else torch.cat([w_ih, w_hh], 0)
    return wd.transpose(1, 2).contiguous(), w.t().contiguous()


def _launch_bptt(dhn, dists, wd_t, w_t, state, gt, keep_mask, keep, dsel, drow, homo=None,
                 cell="lstm"):
    """Launch C: gate gradients over ``gt``, ``dsel``, row gradients ``drow``;
    ``state`` and ``homo`` as in :func:`bptt_plain`."""
    T, nw, wl = dists.shape
    H = dhn.shape[1]
    bf16 = wd_t.dtype == torch.bfloat16
    xin, ego, dego = homo if homo is not None else (None, None, None)
    with torch.cuda.device(dhn.device):
        rc = build.library().pathnet_pagg_bptt(
            dhn.data_ptr(), dists.data_ptr(), wd_t.data_ptr(), w_t.data_ptr(),
            ptr(state), ptr(gt), ptr(keep_mask), dropout_divisor(keep, bf16),
            ptr(xin), ptr(ego), ptr(dego), dsel.data_ptr(), drow.data_ptr(), T, nw, wl, H,
            int(bf16), CELLS.index(cell), build.stream_ptr(dhn))
    build.check(rc, "pagg_encode_bwd (bptt)")


def pagg_encode_bwd(g: torch.Tensor, h: torch.Tensor, paths: torch.Tensor,
                    dists: torch.Tensor, wd: torch.Tensor, bd: torch.Tensor,
                    w_ih: torch.Tensor, w_hh: torch.Tensor, b_ih: torch.Tensor,
                    b_hh: torch.Tensor, attw: torch.Tensor, attb: torch.Tensor,
                    keep_mask: Optional[torch.Tensor] = None,
                    keep: float = 1.0, homo: bool = False, agg: str = "attention",
                    cell: str = "lstm") -> Grads:
    """``(dh, dwd, dbd, dw_ih, dw_hh, db_ih, db_hh, dattw, dattb)``.

    ``g`` float32 ``[T, H]``; the other arguments are K3's
    (:func:`~pathnet_tpu_torch.kernels.pagg_encode.pagg_encode_fwd`, f32 or
    bf16; the GRU's weights packed), and each gradient has its input's shape
    and type (``dattw``, ``dattb`` zeros under mean and sum; the GRU's
    packed gradients hold zeros in the packing's zero blocks on the CPU and
    the contractions' entries on the card, which the packing's autograd
    drops: compare them after ``unpack_gru``).
    """
    dev = h.device
    f32 = torch.float32
    dt = compute_dtype(h, wd, bd, w_ih, w_hh, b_ih, b_hh)
    check_choices(agg, cell)
    build.require(h, "h", dt, (None, None), dev)
    n, H = h.shape
    build.require(paths, "paths", torch.int32, (None, None, None), dev)
    T, nw, wl = paths.shape
    build.require(g, "g", f32, (T, H), dev)
    build.require(dists, "dists", torch.int32, (T, nw, wl), dev)
    build.require(wd, "wd", dt, (wl, H, H), dev)
    build.require(bd, "bd", dt, (wl, H), dev)
    for t, name, shape in zip((w_ih, w_hh, b_ih, b_hh), ("w_ih", "w_hh", "b_ih", "b_hh"),
                              cell_shapes(cell, H)):
        build.require(t, name, dt, shape, dev)
    build.require(attw, "attw", f32, (2 * H,), dev)
    build.require(attb, "attb", f32, (1,), dev)
    check_keep_mask(keep_mask, keep, wl, T * nw, H, dev)
    if nw < 1 or wl < 1:
        raise ValueError(f"pagg_encode_bwd needs nw, wl >= 1, got {nw}, {wl}")
    if agg == "quirk":
        check_quirk(homo, h)
    if dev.type == "cpu":
        return pagg_encode_bwd_plain(g, h, paths, dists, wd, bd, w_ih, w_hh,
                                     b_ih, b_hh, attw, attb, keep_mask, keep, homo,
                                     agg=agg, cell=cell)
    _require_device(dev, "pagg_encode_bwd")
    if H > 1024:
        raise ValueError(f"pagg_encode_bwd: hidden {H} > 1024 is not supported")
    B = T * nw
    ego_paths = None
    if agg == "quirk":
        paths, dists, ego_paths, perm = quirk_layout(paths, dists)
        keep_mask = None if keep_mask is None else keep_mask[:, perm].contiguous()
    gru, mlp = cell == "gru", cell == "mlp"
    if mlp:   # no recurrence: its mean input in hp's place, no cs, no gt
        xr, xin, dsel = torch.empty((3, wl, B, H), dtype=f32, device=dev)
        hp, cs, gt = torch.empty((B, H), dtype=f32, device=dev), None, None
    else:
        xr, xin, hp, dsel, *cs = torch.empty((5 - gru, wl, B, H), dtype=f32, device=dev)
        cs = cs[0] if cs else None   # the GRU keeps no cell state
        gt = torch.empty((wl, B, 4 * H), dtype=f32, device=dev)
    # the row gradients: drow, then (hetero, attention) the ego rows'; homo
    # keeps the ego rows and (attention) their gradient apart
    att = agg in ("attention", "quirk")
    rows = torch.empty((wl + (att and not homo), B, H), dtype=f32, device=dev)
    if homo:
        ego, *dego = torch.empty((1 + att, B, H), dtype=f32, device=dev)
        dego = dego[0] if att else None
    else:
        ego, dego = None, (rows[wl] if att else None)
    hn = _launch_streams(h, paths, dists, wd, bd, w_ih, w_hh, b_ih, b_hh, keep_mask,
                         keep, (xr, xin, hp, cs, gt), ego, cell)
    dhn, dattw, dattb = _launch_attention(g, h, paths if ego_paths is None else ego_paths,
                                          hn, attw, attb, dego, ego, agg)
    del hn
    _launch_bptt(dhn, dists, *bptt_weights(wd, w_ih, w_hh), hp if gru else cs, gt,
                 keep_mask, keep, dsel, rows[:wl], (xin, ego, dego) if homo else None, cell)
    pagg_encode_bwd.launches += 1
    del ego, dego
    dh = segment_sum(rows.view(-1, H), row_nodes(paths, homo, agg, ego_paths), n)
    del rows
    dwd, dbd, dw_ih, dw_hh, db = contractions(xr, xin, hp, dsel, dhn if mlp else gt, dists,
                                              homo, cell)
    db_hh = db.new_zeros(0) if mlp else db
    if dt == f32:
        return dh, dwd, dbd, dw_ih, dw_hh, db, db_hh.clone(), dattw, dattb
    # the cast inputs' gradients in their type
    return (*(t.to(dt) for t in (dh, dwd, dbd, dw_ih, dw_hh, db, db_hh)), dattw, dattb)


pagg_encode_bwd.launches = 0


def encode_walks_streams(h, paths, dists, wd, bd, w_ih, w_hh, b_ih, b_hh,
                         keep_mask=None, keep=1.0, homo=False, cell="lstm"):
    """K4's forward recompute alone: ``(h_n, xr, xin, hp, cs, gt)`` (the GRU:
    ``cs`` None; the MLP: ``hp`` its mean input ``[T * nw, H]``, ``cs`` and
    ``gt`` None), and with ``homo`` the ego rows after them (see the module
    docstring). For timing and tests; it counts no launch."""
    enc = (h, paths, dists, wd, bd, w_ih, w_hh, b_ih, b_hh, keep_mask, keep)
    check_encode(*enc, cell)
    if h.device.type == "cpu":
        return encode_walks_streams_plain(*enc, homo, cell=cell)
    T, nw, wl = paths.shape
    H = h.shape[1]
    f32 = torch.float32
    if cell == "mlp":
        xr, xin = torch.empty((2, wl, T * nw, H), dtype=f32, device=h.device)
        hp, cs, gt = torch.empty((T * nw, H), dtype=f32, device=h.device), None, None
    else:
        gru = cell == "gru"
        xr, xin, hp, *cs = torch.empty((4 - gru, wl, T * nw, H), dtype=f32, device=h.device)
        cs = cs[0] if cs else None
        gt = torch.empty((wl, T * nw, 4 * H), dtype=f32, device=h.device)
    ego = torch.empty((T * nw, H), dtype=f32, device=h.device) if homo else None
    hn = _launch_streams(*enc, (xr, xin, hp, cs, gt), ego, cell)
    out = (hn, xr, xin, hp, cs, gt)
    return out + (ego,) if homo else out


def attention_bwd(g, h, paths, hn, attw, attb, ego=None, agg="attention"):
    """K4's attention backward alone: ``(dhn, dego, dattw, dattb)``, ``dego
    [T * nw, H]`` holding each walk's ego row gradient (None under the mean
    and sum readouts); homo where the ego rows ``ego [T * nw, H]`` are
    given; ``agg`` the readout ("quirk": ``paths`` holds the ego nodes at
    ``[:, :, 0]``, :func:`~pathnet_tpu_torch.kernels.pagg_encode.quirk_layout`'s
    ``ego``). For timing and tests; it counts no launch."""
    check_choices(agg)
    dev = h.device
    f32 = torch.float32
    build.require(h, "h", compute_dtype(h), (None, None), dev)
    H = h.shape[1]
    build.require(paths, "paths", torch.int32, (None, None, None), dev)
    T, nw, _ = paths.shape
    build.require(g, "g", f32, (T, H), dev)
    build.require(hn, "hn", f32, (T * nw, H), dev)
    if ego is not None:
        build.require(ego, "ego", f32, (T * nw, H), dev)
    build.require(attw, "attw", f32, (2 * H,), dev)
    build.require(attb, "attb", f32, (1,), dev)
    _require_device(dev, "attention_bwd")
    if dev.type == "cpu":
        return attention_bwd_plain(g, h, paths, hn, attw, attb, ego, agg)
    att = agg in ("attention", "quirk")
    dego = torch.empty((T * nw, H), dtype=f32, device=dev) if att else None
    dhn, dattw, dattb = _launch_attention(g, h, paths, hn, attw, attb, dego, ego, agg)
    return dhn, dego, dattw, dattb


def bptt(dhn, paths, dists, wd, w_ih, w_hh, state, gt, keep_mask=None, keep=1.0, homo=None,
         cell="lstm"):
    """K4's BPTT alone: ``(drow, dgates, dsel)`` from ``d h_n`` ``[T * nw, H]``
    and the recompute's ``gt`` and ``state``, its ``cs`` (LSTM) or ``hp``
    (``cell="gru"``; the MLP reads neither, and its ``dgates`` is None);
    ``drow [wl, T * nw, H]`` holds every gathered row's
    gradient, and ``homo`` is None or ``(xin, ego, dego)``, ``dego`` None
    under the mean and sum readouts (see :func:`bptt_plain`). As in the
    whole backward, the gate gradients are written over ``gt``, which is
    returned as ``dgates``. For timing and tests; it counts no launch."""
    dev = dhn.device
    f32 = torch.float32
    build.require(paths, "paths", torch.int32, (None, None, None), dev)
    T, nw, wl = paths.shape
    B = T * nw
    build.require(dhn, "dhn", f32, (B, None), dev)
    H = dhn.shape[1]
    build.require(dists, "dists", torch.int32, (T, nw, wl), dev)
    dt = compute_dtype(wd, w_ih, w_hh)
    check_choices(cell=cell)
    build.require(wd, "wd", dt, (wl, H, H), dev)
    shapes = cell_shapes(cell, H)
    build.require(w_ih, "w_ih", dt, shapes[0], dev)
    build.require(w_hh, "w_hh", dt, shapes[1], dev)
    mlp = cell == "mlp"
    if not mlp:
        build.require(state, "state", f32, (wl, B, H), dev)
        build.require(gt, "gt", f32, (wl, B, 4 * H), dev)
    if homo is not None:
        for name, t, shape in zip(("xin", "ego", "dego"), homo,
                                  ((wl, B, H), (B, H), (B, H))):
            if t is not None or name != "dego":
                build.require(t, name, f32, shape, dev)
    check_keep_mask(keep_mask, keep, wl, B, H, dev)
    _require_device(dev, "bptt")
    if dev.type == "cpu":
        drow, dgates, dsel = bptt_plain(dhn, paths, dists, wd, w_ih, w_hh, state, gt,
                                        keep_mask, keep, homo, cell=cell)
        return drow, None if mlp else gt.copy_(dgates), dsel
    if H > 1024:
        raise ValueError(f"bptt: hidden {H} > 1024 is not supported")
    drow, dsel = torch.empty((2, wl, B, H), dtype=f32, device=dev)
    _launch_bptt(dhn, dists, *bptt_weights(wd, w_ih, w_hh), state, gt, keep_mask, keep,
                 dsel, drow, homo, cell)
    return drow, None if mlp else gt, dsel
