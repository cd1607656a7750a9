"""K4 ``pagg_encode_bwd``: the backward of K3, f32.

Replaces the VJP of ``pathnet_tpu/models/pagg.py:235-303`` (what ``jax.grad``
derives for the encode block and the attention readout) together with the
gather VJP of the "h" gather mode (``pagg.py:83-93``). Given ``g``, the
gradient of K3's output ``[T, H]``, it returns the gradients of K3's inputs:
``dh [n, H]`` and those of ``wd, bd, w_ih, w_hh, b_ih, b_hh, attw, attb``.

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
   again from ``h_n``, ``d h_n`` into a second scratch ``[T * nw, H]``, and,
   with ``atomicAdd``, the ego rows' gradient into ``dh`` and the sums into
   ``dattw`` and ``dattb``.
3. BPTT on the same tiles: a thread keeps ``dh`` and ``dc`` of 8 walks x 2
   units in registers down the steps. Each step forms the pre-activation
   gate gradients (written over ``gt``); one register-tiled product with
   ``[w_ih; w_hh]^T`` gives the LSTM input's gradient and ``dh_{t-1}``; the
   keep mask turns the first into ``dsel`` (its stream); one product per
   distance class present in the tile with ``wd[k]^T`` gives each gathered
   row's gradient, scattered into ``dh`` with ``atomicAdd``.

The weight gradients are contractions of the streams over all rows
(:func:`contractions`), left to ``torch.matmul`` as the JAX package leaves
them to XLA dots. Memory held during the call: the streams, 9 ``H`` floats
per walk step (3.0 GB for one 8192-target bgp microbatch, nw = 40, wl = 4,
H = 64); the two scratches ``h_n`` and ``d h_n``, ``[T * nw, H]`` each
(84 MB each there); and 2 ``H`` floats a walk step more (0.67 GB) while
:func:`class_contractions` regroups ``xr`` and ``dsel`` by distance class.
All are freed on return.

:func:`encode_walks_streams`, :func:`attention_bwd` and :func:`bptt` launch
each stage alone (for timing and tests; they count no launch), beside plain
versions written out by hand; with :func:`contractions` the plain stages
compose to :func:`pagg_encode_bwd_plain`.

Bound on the H100: f32 operations, about 54 ``H^2`` flops per walk step
(forward recompute 18, backward products 18, weight-gradient contractions
18), about 290 GFLOP or 4.3 ms at 67 TFLOP/s per bgp microbatch.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import build
from .pagg_encode import _check as check_encode, check_keep_mask, pagg_encode_fwd_plain

Grads = Tuple[torch.Tensor, ...]


def pagg_encode_bwd_plain(g, h, paths, dists, wd, bd, w_ih, w_hh, b_ih, b_hh,
                          attw, attb, keep_mask=None, keep=1.0) -> Grads:
    """Plain PyTorch version: ``torch.autograd.grad`` through
    :func:`pagg_encode_fwd_plain` with the same mask."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True)
                  for t in (h, wd, bd, w_ih, w_hh, b_ih, b_hh, attw, attb)]
        lh, lwd, lbd, lwi, lwh, lbi, lbh, law, lab = leaves
        out = pagg_encode_fwd_plain(lh, paths, dists, lwd, lbd, lwi, lwh, lbi,
                                    lbh, law, lab, keep_mask, keep)
        return torch.autograd.grad(out, leaves, g)


def _step_classes(dists: torch.Tensor) -> torch.Tensor:
    """int64 ``[wl, T * nw]``: the clipped distance class of step ``t`` of
    each walk (step ``t`` holds position ``wl - 1 - t``)."""
    T, nw, wl = dists.shape
    return dists.flip(2).clamp(0, wl - 1).reshape(T * nw, wl).t().contiguous().long()


def encode_walks_streams_plain(h, paths, dists, wd, bd, w_ih, w_hh, b_ih, b_hh,
                               keep_mask=None, keep=1.0):
    """Plain version of the forward recompute: ``(h_n, xr, xin, hp, cs, gt)``."""
    T, nw, wl = paths.shape
    H = h.shape[1]
    B = T * nw
    xr = h[paths.long()].flip(2).reshape(B, wl, H).transpose(0, 1).contiguous()
    d = _step_classes(dists)[:, :, None]
    xin = torch.zeros_like(xr)
    for k in range(wl):
        xin = torch.where(d == k, xr @ wd[k] + bd[k], xin)
    if keep_mask is not None:
        xin = torch.where(keep_mask.bool(), xin / keep, 0.0)
    gx = xin @ w_ih + b_ih
    hprev = h.new_zeros((B, H))
    c = h.new_zeros((B, H))
    hp, cs, gt = [], [], []
    for t in range(wl):
        i, f, gg, o = (gx[t] + hprev @ w_hh + b_hh).chunk(4, dim=1)
        si, sf, tg, so = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(gg), torch.sigmoid(o)
        c = sf * c + si * tg
        hp.append(hprev)
        cs.append(c)
        gt.append(torch.cat([si, sf, tg, so], dim=1))
        hprev = so * torch.tanh(c)
    return hprev, xr, xin, torch.stack(hp), torch.stack(cs), torch.stack(gt)


def attention_bwd_plain(g, h, paths, hn, attw, attb):
    """Plain version of the attention backward: ``(dhn, dh, dattw, dattb)``,
    ``dh [n, H]`` holding the ego rows' gradient."""
    T, nw, _ = paths.shape
    n, H = h.shape
    h_n = hn.reshape(T, nw, H)
    ego_idx = paths[:, :, 0].long()
    ego = h[ego_idx]
    score = h_n @ attw[:H] + ego @ attw[H:] + attb                   # [T, nw]
    att = torch.softmax(F.leaky_relu(score, 0.01), dim=1)
    datt = (h_n * g[:, None, :]).sum(-1)
    ds = att * (datt - (att * datt).sum(1, keepdim=True))
    ds = ds * torch.where(score > 0, 1.0, 0.01)
    dhn = att[:, :, None] * g[:, None, :] + ds[:, :, None] * attw[:H]
    dh = h.new_zeros((n, H)).index_add_(
        0, ego_idx.reshape(-1), (ds[:, :, None] * attw[H:]).reshape(-1, H))
    dattw = torch.cat([(ds[:, :, None] * h_n).sum((0, 1)),
                       (ds[:, :, None] * ego).sum((0, 1))])
    return dhn.reshape(T * nw, H), dh, dattw, ds.sum().reshape(1)


def bptt_plain(dhn, paths, dists, wd, w_ih, w_hh, cs, gt, n, keep_mask=None, keep=1.0):
    """Plain version of the BPTT: ``(dh, dgates, dsel)``, ``dh [n, H]`` holding
    every gathered row's gradient, ``dgates [wl, T * nw, 4H]`` the
    pre-activation gate gradients and ``dsel [wl, T * nw, H]`` the gradient of
    the selected input."""
    wl, B, H = cs.shape
    d = _step_classes(dists)
    rows = paths.flip(2).reshape(B, wl).t().long()
    dh = cs.new_zeros((n, H))
    dgates = torch.empty_like(gt)
    dsel = torch.empty_like(cs)
    dht, dc = dhn, torch.zeros_like(dhn)
    for t in range(wl - 1, -1, -1):
        si, sf, tg, so = (gt[t, :, k * H:(k + 1) * H] for k in range(4))
        cp = cs[t - 1] if t > 0 else torch.zeros_like(dc)
        tc = torch.tanh(cs[t])
        dct = dc + dht * so * (1 - tc * tc)
        dg = torch.cat([dct * tg * si * (1 - si), dct * cp * sf * (1 - sf),
                        dct * si * (1 - tg * tg), dht * tc * so * (1 - so)], dim=1)
        dc = dct * sf
        dgates[t] = dg
        dxin = dg @ w_ih.t()
        dht = dg @ w_hh.t()
        if keep_mask is not None:
            dxin = torch.where(keep_mask[t].bool(), dxin / keep, 0.0)
        dsel[t] = dxin
        dx = torch.zeros_like(dxin)
        for k in range(wl):
            dx = torch.where(d[t, :, None] == k, dxin @ wd[k].t(), dx)
        dh.index_add_(0, rows[t], dx)
    return dh, dgates, dsel


def class_contractions(x: torch.Tensor, s: torch.Tensor, d: torch.Tensor,
                       classes: int, tile: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """``dw[k] = sum over rows r with d[r] = k of x[r]^T s[r]`` and
    ``db[k] = sum of those s[r]``, for ``x, s [R, H]`` and int64 ``d [R]`` in
    ``[0, classes)``.

    Each row is contracted once and nothing waits on the host, so the K4
    wrapper can be captured in a CUDA graph: the rows are copied into a
    buffer in which every class starts on a ``tile`` boundary, so each
    ``[H, tile] @ [tile, H]`` tile product belongs to one class.
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
    dw = x.new_zeros((classes, H, H)).index_add_(0, cls, prod)
    db = x.new_zeros((classes, H)).index_add_(0, cls, sp.sum(dim=1))
    return dw, db


def contractions(xr, xin, hp, dsel, dgates, dists) -> Grads:
    """The weight gradients from the streams: ``(dwd, dbd, dw_ih, dw_hh, db)``,
    ``db`` being both LSTM biases' gradient."""
    wl, B, H = xr.shape
    dg = dgates.view(wl * B, 4 * H)
    dw_ih = xin.view(-1, H).t() @ dg
    dw_hh = hp.view(-1, H).t() @ dg
    dwd, dbd = class_contractions(xr.view(-1, H), dsel.view(-1, H),
                                  _step_classes(dists).reshape(-1), wl)
    return dwd, dbd, dw_ih, dw_hh, dg.sum(dim=0)


def _require_device(dev: torch.device, what: str) -> None:
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")


def _launch_streams(h, paths, dists, wd, bd, w_ih, w_hh, b_ih, b_hh, keep_mask, keep,
                    streams):
    """Launch A into ``streams = (xr, xin, hp, cs, gt)``; returns ``h_n``."""
    T, nw, wl = paths.shape
    H = h.shape[1]
    hn = torch.empty((T * nw, H), dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        rc = build.library().pathnet_pagg_encode_walks_streams(
            h.data_ptr(), paths.data_ptr(), dists.data_ptr(), wd.data_ptr(),
            bd.data_ptr(), w_ih.data_ptr(), w_hh.data_ptr(), b_ih.data_ptr(),
            b_hh.data_ptr(), None if keep_mask is None else keep_mask.data_ptr(),
            float(keep), hn.data_ptr(), *(s.data_ptr() for s in streams),
            T, nw, wl, H, build.stream_ptr(h))
    build.check(rc, "pagg_encode_bwd (forward recompute)")
    return hn


def _launch_attention(g, h, paths, hn, attw, attb, dh, dattw, dattb):
    """Launch B: returns ``d h_n``; adds into ``dh``, ``dattw``, ``dattb``."""
    T, nw, wl = paths.shape
    H = h.shape[1]
    dhn = torch.empty((T * nw, H), dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        rc = build.library().pathnet_pagg_attention_bwd(
            g.data_ptr(), h.data_ptr(), paths.data_ptr(), hn.data_ptr(),
            attw.data_ptr(), attb.data_ptr(), dhn.data_ptr(), dh.data_ptr(),
            dattw.data_ptr(), dattb.data_ptr(), T, nw, wl, H, build.stream_ptr(h))
    build.check(rc, "pagg_encode_bwd (attention)")
    return dhn


def bptt_weights(wd, w_ih, w_hh):
    """The BPTT launch's operands: ``wd`` transposed per class and
    ``[w_ih; w_hh]^T`` ``[4H, 2H]``."""
    return (wd.transpose(1, 2).contiguous(),
            torch.cat([w_ih, w_hh], 0).t().contiguous())


def _launch_bptt(dhn, paths, dists, wd_t, w_t, cs, gt, keep_mask, keep, dsel, dh):
    """Launch C: gate gradients over ``gt``, ``dsel``, row gradients into ``dh``."""
    T, nw, wl = paths.shape
    H = dhn.shape[1]
    with torch.cuda.device(dhn.device):
        rc = build.library().pathnet_pagg_bptt(
            dhn.data_ptr(), paths.data_ptr(), dists.data_ptr(), wd_t.data_ptr(),
            w_t.data_ptr(), cs.data_ptr(), gt.data_ptr(),
            None if keep_mask is None else keep_mask.data_ptr(), float(keep),
            dsel.data_ptr(), dh.data_ptr(), T, nw, wl, H, build.stream_ptr(dhn))
    build.check(rc, "pagg_encode_bwd (bptt)")


def pagg_encode_bwd(g: torch.Tensor, h: torch.Tensor, paths: torch.Tensor,
                    dists: torch.Tensor, wd: torch.Tensor, bd: torch.Tensor,
                    w_ih: torch.Tensor, w_hh: torch.Tensor, b_ih: torch.Tensor,
                    b_hh: torch.Tensor, attw: torch.Tensor, attb: torch.Tensor,
                    keep_mask: Optional[torch.Tensor] = None,
                    keep: float = 1.0) -> Grads:
    """``(dh, dwd, dbd, dw_ih, dw_hh, db_ih, db_hh, dattw, dattb)``.

    ``g`` float32 ``[T, H]``; the other arguments are K3's
    (:func:`~pathnet_tpu_torch.kernels.pagg_encode.pagg_encode_fwd`), and each
    gradient has its input's shape.
    """
    dev = h.device
    f32 = torch.float32
    build.require(h, "h", f32, (None, None), dev)
    n, H = h.shape
    build.require(paths, "paths", torch.int32, (None, None, None), dev)
    T, nw, wl = paths.shape
    build.require(g, "g", f32, (T, H), dev)
    build.require(dists, "dists", torch.int32, (T, nw, wl), dev)
    build.require(wd, "wd", f32, (wl, H, H), dev)
    build.require(bd, "bd", f32, (wl, H), dev)
    build.require(w_ih, "w_ih", f32, (H, 4 * H), dev)
    build.require(w_hh, "w_hh", f32, (H, 4 * H), dev)
    build.require(b_ih, "b_ih", f32, (4 * H,), dev)
    build.require(b_hh, "b_hh", f32, (4 * H,), dev)
    build.require(attw, "attw", f32, (2 * H,), dev)
    build.require(attb, "attb", f32, (1,), dev)
    check_keep_mask(keep_mask, keep, wl, T * nw, H, dev)
    if nw < 1 or wl < 1:
        raise ValueError(f"pagg_encode_bwd needs nw, wl >= 1, got {nw}, {wl}")
    if dev.type == "cpu":
        return pagg_encode_bwd_plain(g, h, paths, dists, wd, bd, w_ih, w_hh,
                                     b_ih, b_hh, attw, attb, keep_mask, keep)
    _require_device(dev, "pagg_encode_bwd")
    if H > 1024:
        raise ValueError(f"pagg_encode_bwd: hidden {H} > 1024 is not supported")
    B = T * nw
    dh = torch.zeros((n, H), dtype=f32, device=dev)
    dattw = torch.zeros((2 * H,), dtype=f32, device=dev)
    dattb = torch.zeros((1,), dtype=f32, device=dev)
    xr, xin, hp, cs, dsel = torch.empty((5, wl, B, H), dtype=f32, device=dev)
    gt = torch.empty((wl, B, 4 * H), dtype=f32, device=dev)
    hn = _launch_streams(h, paths, dists, wd, bd, w_ih, w_hh, b_ih, b_hh, keep_mask,
                         keep, (xr, xin, hp, cs, gt))
    dhn = _launch_attention(g, h, paths, hn, attw, attb, dh, dattw, dattb)
    del hn
    _launch_bptt(dhn, paths, dists, *bptt_weights(wd, w_ih, w_hh), cs, gt, keep_mask,
                 keep, dsel, dh)
    pagg_encode_bwd.launches += 1
    dwd, dbd, dw_ih, dw_hh, db = contractions(xr, xin, hp, dsel, gt, dists)
    return dh, dwd, dbd, dw_ih, dw_hh, db, db.clone(), dattw, dattb


pagg_encode_bwd.launches = 0


def encode_walks_streams(h, paths, dists, wd, bd, w_ih, w_hh, b_ih, b_hh,
                         keep_mask=None, keep=1.0):
    """K4's forward recompute alone: ``(h_n, xr, xin, hp, cs, gt)`` (see the
    module docstring). For timing and tests; it counts no launch."""
    enc = (h, paths, dists, wd, bd, w_ih, w_hh, b_ih, b_hh, keep_mask, keep)
    check_encode(*enc)
    if h.device.type == "cpu":
        return encode_walks_streams_plain(*enc)
    T, nw, wl = paths.shape
    H = h.shape[1]
    xr, xin, hp, cs = torch.empty((4, wl, T * nw, H), dtype=torch.float32,
                                  device=h.device)
    gt = torch.empty((wl, T * nw, 4 * H), dtype=torch.float32, device=h.device)
    hn = _launch_streams(*enc, (xr, xin, hp, cs, gt))
    return hn, xr, xin, hp, cs, gt


def attention_bwd(g, h, paths, hn, attw, attb):
    """K4's attention backward alone: ``(dhn, dh, dattw, dattb)``, ``dh [n, H]``
    holding the ego rows' gradient. For timing and tests; it counts no launch."""
    dev = h.device
    f32 = torch.float32
    build.require(h, "h", f32, (None, None), dev)
    n, H = h.shape
    build.require(paths, "paths", torch.int32, (None, None, None), dev)
    T, nw, _ = paths.shape
    build.require(g, "g", f32, (T, H), dev)
    build.require(hn, "hn", f32, (T * nw, H), dev)
    build.require(attw, "attw", f32, (2 * H,), dev)
    build.require(attb, "attb", f32, (1,), dev)
    _require_device(dev, "attention_bwd")
    if dev.type == "cpu":
        return attention_bwd_plain(g, h, paths, hn, attw, attb)
    dh = torch.zeros((n, H), dtype=f32, device=dev)
    dattw = torch.zeros((2 * H,), dtype=f32, device=dev)
    dattb = torch.zeros((1,), dtype=f32, device=dev)
    dhn = _launch_attention(g, h, paths, hn, attw, attb, dh, dattw, dattb)
    return dhn, dh, dattw, dattb


def bptt(dhn, paths, dists, wd, w_ih, w_hh, cs, gt, n, keep_mask=None, keep=1.0):
    """K4's BPTT alone: ``(dh, dgates, dsel)`` from ``d h_n`` ``[T * nw, H]``
    and the recompute's ``cs`` and ``gt``; ``dh [n, H]`` holds every gathered
    row's gradient. As in the whole backward, the gate gradients are written
    over ``gt``, which is returned as ``dgates``. For timing and tests; it
    counts no launch."""
    dev = dhn.device
    f32 = torch.float32
    build.require(paths, "paths", torch.int32, (None, None, None), dev)
    T, nw, wl = paths.shape
    B = T * nw
    build.require(dhn, "dhn", f32, (B, None), dev)
    H = dhn.shape[1]
    build.require(dists, "dists", torch.int32, (T, nw, wl), dev)
    build.require(wd, "wd", f32, (wl, H, H), dev)
    build.require(w_ih, "w_ih", f32, (H, 4 * H), dev)
    build.require(w_hh, "w_hh", f32, (H, 4 * H), dev)
    build.require(cs, "cs", f32, (wl, B, H), dev)
    build.require(gt, "gt", f32, (wl, B, 4 * H), dev)
    check_keep_mask(keep_mask, keep, wl, B, H, dev)
    _require_device(dev, "bptt")
    if dev.type == "cpu":
        dh, dgates, dsel = bptt_plain(dhn, paths, dists, wd, w_ih, w_hh, cs, gt, n,
                                      keep_mask, keep)
        return dh, gt.copy_(dgates), dsel
    if H > 1024:
        raise ValueError(f"bptt: hidden {H} > 1024 is not supported")
    dh = torch.zeros((n, H), dtype=f32, device=dev)
    dsel = torch.empty_like(cs)
    _launch_bptt(dhn, paths, dists, *bptt_weights(wd, w_ih, w_hh), cs, gt,
                 keep_mask, keep, dsel, dh)
    return dh, gt, dsel

