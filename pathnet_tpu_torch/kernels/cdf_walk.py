"""K1 ``cdf_walk``: inverse-CDF random walks, every step in one kernel.

Replaces ``pathnet_tpu/sample/alias.py:142-147`` (``CdfSampler.step``) as
scanned by ``pathnet_tpu/sample/walk.py:36-55`` (``sample_paths``). Per step
and walker: ``idx = #{j : cdf[cur, j] < u}``, ``next = nbr[cur, idx]``.

Source: ``pathnet_tpu_torch/csrc/walk_dists.cu``, the device code of
:func:`~pathnet_tpu_torch.kernels.walk_dists.walk_dists` run without its
distances (any walk length): the walks laid out flat across the grid, a
lane group per walk (1, 16 or 32 lanes, from D) that counts the CDF entries
below the uniform with warp votes, ``idx`` clamped to ``D - 1``, so a NaN or
unsaturated row stays in bounds. The
sampler's own path takes ``walk_dists``; this entry serves ``sample_paths``.
The uniforms ``u`` are an input, drawn by the caller from an explicit
generator: kernel and plain version give identical walks for the same
draws, and tests can feed JAX's own draws.

Bound on the H100: per 8192-target bgp request about 22 MB of unique bytes
(two ``[n, D]`` tables, ``u`` and the output), about 7 us at 3.35 TB/s. The
tables fit in the 50 MB L2, so the latency of the dependent row reads, not
bandwidth, sets the time.
"""
from __future__ import annotations

import torch

from . import build
from .walk_dists import launch


def cdf_walk_plain(nbr: torch.Tensor, cdf: torch.Tensor, starts: torch.Tensor,
                   u: torch.Tensor, num_walks: int) -> torch.Tensor:
    """Plain PyTorch version; same arguments and result as :func:`cdf_walk`."""
    D = nbr.shape[1]
    cur = starts.long().repeat_interleave(num_walks)
    trail = [cur]
    for t in range(u.shape[0]):
        idx = (cdf[cur] < u[t][:, None]).sum(dim=1).clamp_(max=D - 1)
        cur = nbr[cur, idx].long()
        trail.append(cur)
    walk = torch.stack(trail, dim=1).to(torch.int32)
    return walk.reshape(starts.shape[0], num_walks, u.shape[0] + 1)


def cdf_walk(nbr: torch.Tensor, cdf: torch.Tensor, starts: torch.Tensor,
             u: torch.Tensor, num_walks: int) -> torch.Tensor:
    """Walks ``int32 [S, num_walks, wl]`` with ``wl = u.shape[0] + 1``.

    ``nbr`` int32 ``[n, D]``, ``cdf`` float32 ``[n, D]`` (saturated to 1 from
    the last real slot on), ``starts`` int32 ``[S]``, ``u`` float32
    ``[wl - 1, S * num_walks]`` in ``[0, 1)``; walker ``w`` starts at
    ``starts[w // num_walks]``. Start ids must lie in ``[0, n)``.
    """
    dev = nbr.device
    build.require(nbr, "nbr", torch.int32, (None, None), dev)
    n, D = nbr.shape
    build.require(cdf, "cdf", torch.float32, (n, D), dev)
    build.require(starts, "starts", torch.int32, (None,), dev)
    S = starts.shape[0]
    build.require(u, "u", torch.float32, (None, S * num_walks), dev)
    if dev.type == "cpu":
        return cdf_walk_plain(nbr, cdf, starts, u, num_walks)
    if dev.type != "cuda":
        raise ValueError(f"cdf_walk: unsupported device {dev}")
    wl = u.shape[0] + 1
    out = torch.empty((S, num_walks, wl), dtype=torch.int32, device=dev)
    launch(nbr, cdf, None, None, starts, u, out, None)
    cdf_walk.launches += 1
    return out


cdf_walk.launches = 0
