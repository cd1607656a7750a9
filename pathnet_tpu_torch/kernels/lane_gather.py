"""K6 ``lane_gather``: ``out[i, j] = tbl[i, idx[i] mod D]``.

Replaces the Pallas probe body ``lane_gather_axis1``
(``scripts/pallas_gather_probe.py:45-50``, run by the ``pallas_call`` at
``:68``): ``take_along_axis(tbl, broadcast(idx[:, None] % D), axis=1)``, so
each row's one selected lane fills the whole row. The mod is JAX's ``%``, a
floor mod: a negative ``idx`` selects a lane in ``[0, D)``. It lies on no
path of the JAX package; the gather probe (``pathnet_tpu_torch.gather_probe``)
runs it. No backward: the probe takes no gradient.

Source: ``pathnet_tpu_torch/csrc/lane_gather.cu``. One warp per row, float4
stores when ``D`` is a multiple of 4. Bound on the H100: bytes, the ``n * D``
floats written plus ``idx`` and the ``n`` selected floats read, over
3.35 TB/s.
"""
from __future__ import annotations

import torch

from . import build


def lane_gather_plain(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`lane_gather`."""
    n, D = tbl.shape
    return torch.gather(tbl, 1, torch.remainder(idx.long(), D)[:, None].expand(n, D))


def lane_gather(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``float32 [n, D]``: row ``i`` filled with ``tbl[i, idx[i] mod D]``, for
    ``tbl`` float32 ``[n, D]`` (``D > 0``) and ``idx`` int32 ``[n]``."""
    dev = tbl.device
    build.require(tbl, "tbl", torch.float32, (None, None), dev)
    n, D = tbl.shape
    build.require(idx, "idx", torch.int32, (n,), dev)
    if D == 0:
        raise ValueError("lane_gather: tbl has no lanes (D = 0)")
    if dev.type == "cpu":
        return lane_gather_plain(tbl, idx)
    if dev.type != "cuda":
        raise ValueError(f"lane_gather: unsupported device {dev}")
    out = torch.empty((n, D), dtype=torch.float32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        rc = lib.pathnet_lane_gather(tbl.data_ptr(), idx.data_ptr(), out.data_ptr(),
                                     n, D, build.stream_ptr(tbl))
    build.check(rc, "lane_gather")
    lane_gather.launches += 1
    return out


lane_gather.launches = 0
