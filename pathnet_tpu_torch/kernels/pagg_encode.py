"""K3 ``pagg_encode_fwd``: the PAGG encode forward and attention readout, f32.

Replaces ``pathnet_tpu/models/pagg.py:235-303`` (the encode block and the
attention readout of ``pagg_forward``, hetero / LSTM / attention), with
``_dist_select`` (``:150-177``) and ``nn/cells.py:22-46`` (``lstm_scan``). Per
target: gather its ``nw * wl`` rows of ``h``, flip each walk (far to near),
apply ``W[d] x + b[d]`` with ``d`` clipped to ``[0, wl - 1]``, run the
``wl``-step LSTM, score each walk by
``leaky_relu(attw . [h_n, h[walk start]] + attb)``, softmax over the walks,
and return the weighted **sum** of the ``h_n``: ``[T, H]``.

Training mode: with ``keep_mask`` (uint8 ``[wl, T * nw, H]``, the layout of
the LSTM input ``seq`` at ``pagg.py:274``) the selected input of step ``t`` of
walk ``b`` becomes ``keep_mask[t, b] ? s / keep : 0``, JAX's
``where(mask, x / keep, 0)``. The mask is an input, drawn by the caller, so
the kernel and its plain version see the same draws. Without a mask the
kernel is the serving kernel unchanged (a separate template instance).

Source: ``pathnet_tpu_torch/csrc/pagg_encode.cu``. One block per target;
thread ``(j, g)`` owns hidden unit ``j`` for 4 walks of group ``g``, so every
weight element it loads (from L1/L2; the weights are 192 KB at H = 64) feeds
4 walks, and the four gates of unit ``j`` meet in its registers. Gathered
rows, selected inputs, hidden states and the final states of all walks sit
in shared memory.

Bound on the H100: f32 FMA work, about 18 H^2 flops per walk step: at one
8192-target request (nw = 40, wl = 4, H = 64) about 97 GFLOP, 1.4 ms at the
67 TFLOP/s f32 rate, against about 29 MB of unique bytes (9 us). The kernel
computes in f32 on the CUDA cores, so the f32 rate, not the bf16 tensor-core
rate, is its bound in this form.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..nn.cells import lstm_scan
from . import build


def pagg_encode_fwd_plain(h, paths, dists, wd, bd, w_ih, w_hh, b_ih, b_hh,
                          attw, attb, keep_mask=None, keep=1.0) -> torch.Tensor:
    """Plain PyTorch version; same arguments and result as :func:`pagg_encode_fwd`."""
    T, nw, wl = paths.shape
    H = h.shape[1]
    nei = h[paths.long()]                                  # [T, nw, wl, H]
    x = nei.flip(2).reshape(-1, H)
    d = dists.flip(2).clamp(0, wl - 1).reshape(-1, 1)
    sel = torch.zeros_like(x)
    for k in range(wl):
        sel = torch.where(d == k, x @ wd[k] + bd[k], sel)
    seq = sel.reshape(T * nw, wl, H).transpose(0, 1)       # [wl, B, H]
    if keep_mask is not None:
        seq = torch.where(keep_mask.bool(), seq / keep, 0.0)
    _, h_n = lstm_scan({"w_ih": w_ih, "w_hh": w_hh, "b_ih": b_ih,
                        "b_hh": b_hh}, seq)
    h_n = h_n.reshape(T, nw, H)
    score = torch.cat([h_n, nei[:, :, 0, :]], dim=-1) @ attw + attb
    att = torch.softmax(F.leaky_relu(score, 0.01), dim=1)  # [T, nw]
    return (att[:, :, None] * h_n).sum(dim=1)


def pagg_encode_fwd(h: torch.Tensor, paths: torch.Tensor, dists: torch.Tensor,
                    wd: torch.Tensor, bd: torch.Tensor, w_ih: torch.Tensor,
                    w_hh: torch.Tensor, b_ih: torch.Tensor, b_hh: torch.Tensor,
                    attw: torch.Tensor, attb: torch.Tensor,
                    keep_mask: Optional[torch.Tensor] = None,
                    keep: float = 1.0) -> torch.Tensor:
    """Path-aggregated features ``float32 [T, H]`` of the ``T`` targets.

    ``h`` float32 ``[n, H]`` (projected node features), ``paths`` and
    ``dists`` int32 ``[T, nw, wl]`` (node ids in ``[0, n)``), ``wd``
    ``[wl, H, H]`` and ``bd`` ``[wl, H]`` (the distance transforms, ``x @
    wd[d]``), ``w_ih``/``w_hh`` ``[H, 4H]`` and ``b_ih``/``b_hh`` ``[4H]``
    (LSTM, gates i, f, g, o), ``attw`` ``[2H]`` and ``attb`` ``[1]``;
    ``keep_mask`` uint8 ``[wl, T * nw, H]`` and ``keep`` in ``(0, 1]`` for
    the training forward's dropout (see the module docstring).
    """
    dev = h.device
    f32 = torch.float32
    build.require(h, "h", f32, (None, None), dev)
    H = h.shape[1]
    build.require(paths, "paths", torch.int32, (None, None, None), dev)
    T, nw, wl = paths.shape
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
        raise ValueError(f"pagg_encode_fwd needs nw, wl >= 1, got {nw}, {wl}")
    if dev.type == "cpu":
        return pagg_encode_fwd_plain(h, paths, dists, wd, bd, w_ih, w_hh,
                                     b_ih, b_hh, attw, attb, keep_mask, keep)
    if dev.type != "cuda":
        raise ValueError(f"pagg_encode_fwd: unsupported device {dev}")
    if H > 1024:
        raise ValueError(f"pagg_encode_fwd: hidden {H} > 1024 is not supported")
    out = torch.empty((T, H), dtype=f32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        rc = lib.pathnet_pagg_encode_fwd(
            h.data_ptr(), paths.data_ptr(), dists.data_ptr(), wd.data_ptr(),
            bd.data_ptr(), w_ih.data_ptr(), w_hh.data_ptr(), b_ih.data_ptr(),
            b_hh.data_ptr(), attw.data_ptr(), attb.data_ptr(),
            None if keep_mask is None else keep_mask.data_ptr(), float(keep),
            out.data_ptr(), T, nw, wl, H, build.stream_ptr(h))
    build.check(rc, "pagg_encode_fwd")
    pagg_encode_fwd.launches += 1
    return out


pagg_encode_fwd.launches = 0


def check_keep_mask(keep_mask: Optional[torch.Tensor], keep: float, wl: int,
                    B: int, H: int, device: torch.device) -> None:
    """Raise unless ``keep_mask`` is None or uint8 ``[wl, B, H]`` on
    ``device`` with ``0 < keep <= 1``."""
    if keep_mask is None:
        return
    build.require(keep_mask, "keep_mask", torch.uint8, (wl, B, H), device)
    if not 0.0 < keep <= 1.0:
        raise ValueError(f"keep must lie in (0, 1], got {keep}")
