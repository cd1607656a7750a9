"""K4 ``pagg_encode_bwd``: the backward of K3, f32.

Replaces the VJP of ``pathnet_tpu/models/pagg.py:235-303`` (what ``jax.grad``
derives for the encode block and the attention readout) together with the
gather VJP of the "h" gather mode (``pagg.py:83-93``). Given ``g``, the
gradient of K3's output ``[T, H]``, it returns the gradients of K3's inputs:
``dh [n, H]`` and those of ``wd, bd, w_ih, w_hh, b_ih, b_hh, attw, attb``.

Source: ``pathnet_tpu_torch/csrc/pagg_encode_bwd.cu``, one block per target.
The kernel recomputes the target's forward with K3's own code (no
activation is kept between K3 and K4), runs the attention backward and the LSTM BPTT, applies the
dropout mask and the distance transform's input gradient, and scatters every
row gradient, the ego rows' included, into ``dh`` with ``atomicAdd``. It
writes five per-row streams ``[wl, T * nw, H]`` (gathered rows, LSTM inputs,
``h_{t-1}``, ``c_t``, the gradient of the selected input) and the gate
stream ``[wl, T * nw, 4H]`` (activations, then their pre-activation
gradients); the weight gradients are contractions of those streams over all
rows, left to ``torch.matmul`` as the JAX package leaves them to XLA dots.
Memory held during the call: 9 ``H`` floats per walk step, 3.0 GB for one
8192-target bgp microbatch (nw = 40, wl = 4, H = 64), and 2 ``H`` more
(0.67 GB) while the gathered rows and ``dsel`` are regrouped by distance
class for ``dwd``; all freed on return.

Bound on the H100: f32 operations, about 54 ``H^2`` flops per walk step
(forward recompute 18, backward products 18, weight-gradient contractions
18), about 290 GFLOP or 4.3 ms at 67 TFLOP/s per bgp microbatch.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import build
from .pagg_encode import check_keep_mask, pagg_encode_fwd_plain

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
    if dev.type != "cuda":
        raise ValueError(f"pagg_encode_bwd: unsupported device {dev}")
    if H > 1024:
        raise ValueError(f"pagg_encode_bwd: hidden {H} > 1024 is not supported")
    B = T * nw
    dh = torch.zeros((n, H), dtype=f32, device=dev)
    dattw = torch.zeros((2 * H,), dtype=f32, device=dev)
    dattb = torch.zeros((1,), dtype=f32, device=dev)
    xr, xin, hp, cs, dsel = torch.empty((5, wl, B, H), dtype=f32, device=dev)
    gt = torch.empty((wl, B, 4 * H), dtype=f32, device=dev)
    wd_t = wd.transpose(1, 2).contiguous()
    w_ih_t = w_ih.t().contiguous()
    w_hh_t = w_hh.t().contiguous()
    lib = build.library()
    with torch.cuda.device(dev):
        rc = lib.pathnet_pagg_encode_bwd(
            g.data_ptr(), h.data_ptr(), paths.data_ptr(), dists.data_ptr(),
            wd.data_ptr(), wd_t.data_ptr(), bd.data_ptr(), w_ih.data_ptr(),
            w_hh.data_ptr(), w_ih_t.data_ptr(), w_hh_t.data_ptr(),
            b_ih.data_ptr(), b_hh.data_ptr(), attw.data_ptr(), attb.data_ptr(),
            None if keep_mask is None else keep_mask.data_ptr(), float(keep),
            dh.data_ptr(), dattw.data_ptr(), dattb.data_ptr(), xr.data_ptr(),
            xin.data_ptr(), hp.data_ptr(), cs.data_ptr(), gt.data_ptr(),
            dsel.data_ptr(), T, nw, wl, H, build.stream_ptr(h))
    build.check(rc, "pagg_encode_bwd")
    pagg_encode_bwd.launches += 1
    dg = gt.view(wl * B, 4 * H)
    dw_ih = xin.view(-1, H).t() @ dg
    dw_hh = hp.view(-1, H).t() @ dg
    db = dg.sum(dim=0)
    # rows of step t hold position wl - 1 - t of each walk
    d = dists.flip(2).clamp(0, wl - 1).reshape(B, wl).t().reshape(-1).long()
    dwd, dbd = class_contractions(xr.view(-1, H), dsel.view(-1, H), d, wl)
    return dh, dwd, dbd, dw_ih, dw_hh, db, db.clone(), dattw, dattb


pagg_encode_bwd.launches = 0
