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

Source: ``pathnet_tpu_torch/csrc/pagg_encode.cu``, two launches behind the
one wrapper (one count a call). The first runs the encode over the flat walk
axis ``b = target * nw + walk`` in tiles of ``M`` walks (``M`` from ``H``: 64
at H = 64, 32 at H = 256; :func:`encode_tile`), each step a register-tiled f32
GEMM ``[M, 2H] x [2H, 4H]`` with ``[s_t | h_{t-1}]`` in shared memory and
``[w_ih; w_hh]`` staged through shared memory in double-buffered 16-byte
``cp.async`` chunks. A thread holds 8 walks x 2 hidden units x 4 gates of
accumulators, so the cell update is the GEMM's epilogue in registers and
``c`` never leaves them. The distance select is one such GEMM per distance
class present in the tile. It writes ``h_n`` ``[T * nw, H]`` to a scratch;
the second launch, one block per target, scores the walks, reduces the
softmax once and forms the weighted sum. :func:`encode_walks` and
:func:`readout` launch each stage alone (for timing and tests; they count no
launch), with plain versions :func:`encode_walks_plain` and
:func:`readout_plain`, whose composition is :func:`pagg_encode_fwd_plain`.

Bound on the H100: f32 FMA work, about 18 H^2 flops per walk step: at one
8192-target request (nw = 40, wl = 4, H = 64) about 97 GFLOP, 1.4 ms at the
67 TFLOP/s f32 rate, against about 29 MB of unique bytes (9 us). The kernel
computes in f32 on the CUDA cores, so the f32 rate, not the bf16 tensor-core
rate, is its bound in this form.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from ..nn.cells import lstm_scan
from . import build


def encode_walks_plain(h, paths, dists, wd, bd, w_ih, w_hh, b_ih, b_hh,
                       keep_mask=None, keep=1.0) -> torch.Tensor:
    """Plain PyTorch version of K3's first launch: ``h_n`` ``[T * nw, H]``."""
    T, nw, wl = paths.shape
    H = h.shape[1]
    x = h[paths.long()].flip(2).reshape(-1, H)
    d = dists.flip(2).clamp(0, wl - 1).reshape(-1, 1)
    sel = torch.zeros_like(x)
    for k in range(wl):
        sel = torch.where(d == k, x @ wd[k] + bd[k], sel)
    seq = sel.reshape(T * nw, wl, H).transpose(0, 1)       # [wl, B, H]
    if keep_mask is not None:
        seq = torch.where(keep_mask.bool(), seq / keep, 0.0)
    return lstm_scan({"w_ih": w_ih, "w_hh": w_hh, "b_ih": b_ih, "b_hh": b_hh}, seq)[1]


def readout_plain(h, paths, hn, attw, attb) -> torch.Tensor:
    """Plain PyTorch version of K3's second launch: the readout ``[T, H]``."""
    T, nw, _ = paths.shape
    h_n = hn.reshape(T, nw, hn.shape[1])
    score = torch.cat([h_n, h[paths[:, :, 0].long()]], dim=-1) @ attw + attb
    att = torch.softmax(F.leaky_relu(score, 0.01), dim=1)  # [T, nw]
    return (att[:, :, None] * h_n).sum(dim=1)


def pagg_encode_fwd_plain(h, paths, dists, wd, bd, w_ih, w_hh, b_ih, b_hh,
                          attw, attb, keep_mask=None, keep=1.0) -> torch.Tensor:
    """Plain PyTorch version; same arguments and result as :func:`pagg_encode_fwd`."""
    hn = encode_walks_plain(h, paths, dists, wd, bd, w_ih, w_hh, b_ih, b_hh,
                            keep_mask, keep)
    return readout_plain(h, paths, hn, attw, attb)


def _check(h, paths, dists, wd, bd, w_ih, w_hh, b_ih, b_hh, keep_mask, keep):
    """Raise unless the encode's inputs fit together and the device is the
    CPU or a CUDA card that takes their width."""
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
    check_keep_mask(keep_mask, keep, wl, T * nw, H, dev)
    if nw < 1 or wl < 1:
        raise ValueError(f"pagg_encode_fwd needs nw, wl >= 1, got {nw}, {wl}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"pagg_encode_fwd: unsupported device {dev}")
    if dev.type == "cuda" and H > 1024:
        raise ValueError(f"pagg_encode_fwd: hidden {H} > 1024 is not supported")


def _launch_walks(h, paths, dists, wd, bd, w_ih, w_hh, b_ih, b_hh, keep_mask, keep):
    T, nw, wl = paths.shape
    H = h.shape[1]
    hn = torch.empty((T * nw, H), dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        rc = build.library().pathnet_pagg_encode_walks(
            h.data_ptr(), paths.data_ptr(), dists.data_ptr(), wd.data_ptr(),
            bd.data_ptr(), w_ih.data_ptr(), w_hh.data_ptr(), b_ih.data_ptr(),
            b_hh.data_ptr(), None if keep_mask is None else keep_mask.data_ptr(),
            float(keep), hn.data_ptr(), T, nw, wl, H, build.stream_ptr(h))
    build.check(rc, "pagg_encode_fwd (encode)")
    return hn


def _launch_readout(h, paths, hn, attw, attb):
    T, nw, wl = paths.shape
    H = h.shape[1]
    out = torch.empty((T, H), dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        rc = build.library().pathnet_pagg_readout(
            h.data_ptr(), paths.data_ptr(), hn.data_ptr(), attw.data_ptr(),
            attb.data_ptr(), out.data_ptr(), T, nw, wl, H, build.stream_ptr(h))
    build.check(rc, "pagg_encode_fwd (readout)")
    return out


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
    enc = (h, paths, dists, wd, bd, w_ih, w_hh, b_ih, b_hh, keep_mask, keep)
    _check(*enc)
    build.require(attw, "attw", torch.float32, (2 * h.shape[1],), h.device)
    build.require(attb, "attb", torch.float32, (1,), h.device)
    if h.device.type == "cpu":
        return pagg_encode_fwd_plain(h, paths, dists, wd, bd, w_ih, w_hh,
                                     b_ih, b_hh, attw, attb, keep_mask, keep)
    out = _launch_readout(h, paths, _launch_walks(*enc), attw, attb)
    pagg_encode_fwd.launches += 1
    return out


def encode_walks(h, paths, dists, wd, bd, w_ih, w_hh, b_ih, b_hh,
                 keep_mask=None, keep=1.0) -> torch.Tensor:
    """K3's first launch alone: ``h_n`` ``[T * nw, H]`` of every walk.

    For timing and tests; it counts no launch (the model calls
    :func:`pagg_encode_fwd`)."""
    enc = (h, paths, dists, wd, bd, w_ih, w_hh, b_ih, b_hh, keep_mask, keep)
    _check(*enc)
    if h.device.type == "cpu":
        return encode_walks_plain(*enc)
    return _launch_walks(*enc)


def readout(h, paths, hn, attw, attb) -> torch.Tensor:
    """K3's second launch alone: the attention readout ``[T, H]`` from
    ``hn`` ``[T * nw, H]``. For timing and tests; it counts no launch."""
    dev = h.device
    build.require(h, "h", torch.float32, (None, None), dev)
    H = h.shape[1]
    build.require(paths, "paths", torch.int32, (None, None, None), dev)
    T, nw, _ = paths.shape
    build.require(hn, "hn", torch.float32, (T * nw, H), dev)
    build.require(attw, "attw", torch.float32, (2 * H,), dev)
    build.require(attb, "attb", torch.float32, (1,), dev)
    if dev.type == "cpu":
        return readout_plain(h, paths, hn, attw, attb)
    if dev.type != "cuda":
        raise ValueError(f"readout: unsupported device {dev}")
    return _launch_readout(h, paths, hn, attw, attb)


def encode_tile(H: int) -> dict:
    """K3's tile at width ``H`` as its launcher derives it (needs the built
    library): walks a block ``M``, ``threads``, ``shared_bytes``, and ``kc``,
    the weight rows a ``cp.async`` chunk."""
    out = (ctypes.c_int * 4)()
    build.check(build.library().pathnet_pagg_encode_tile(H, out), "encode_tile")
    return {"M": out[0], "threads": out[1], "shared_bytes": out[2], "kc": out[3]}


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
