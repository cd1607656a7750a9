"""K8 ``alias_walk``: alias-method random walks, every step in one kernel.

Replaces ``pathnet_tpu/sample/alias.py:93-104`` (``AliasSampler.step``) as
scanned by ``pathnet_tpu/sample/walk.py:36-55`` (``sample_paths``). Per step
and walker: ``d = max(deg[cur], 1)``, ``slot = min(int(u1 * d), d - 1)``
with the product in float32 (as JAX promotes int32 x float32), then
``lo[cur, slot]`` if ``u2 < split[cur, slot]``, else ``hi[cur, slot]``.

The uniforms are an input, ``u`` float32 ``[wl - 1, 2, W]``: ``u[t, 0]`` is
step ``t``'s ``u1`` (the slot, JAX's ``k1`` draw) and ``u[t, 1]`` its ``u2``
(the coin, JAX's ``k2`` draw). Kernel and plain version give identical walks
for the same draws, and tests can feed JAX's own.

Source: ``pathnet_tpu_torch/csrc/walk_dists.cu`` (``alias_step``), the
``ALIAS`` instance of the walk launch without distances, one lane a walk:
the step is four loads (``deg``, ``split``, ``lo`` or ``hi``) whatever the
table width. ``alias_walk_dists`` (``kernels/walk_dists.py``) and
``alias_walk_khop_dists`` (``kernels/khop_dists.py``) run the same step
fused with the distances, the sampler's path with the alias tables; this
entry serves the dense, host and ``none`` backends and ``sample_paths``.

Bound on the H100: the latency of each walk's chain of dependent loads
(``wl - 1`` steps of four); the tables fit in the 50 MB L2. The byte bound
(the tables, ``u`` and the walks once) is a few microseconds at the bgp
request.
"""
from __future__ import annotations

import torch

from .walk_dists import check_alias_tables, launch_alias


def alias_step_plain(lo: torch.Tensor, hi: torch.Tensor, split: torch.Tensor,
                     deg: torch.Tensor, cur: torch.Tensor, u1: torch.Tensor,
                     u2: torch.Tensor) -> torch.Tensor:
    """One step for the walkers at ``cur`` (int64 ``[W]``): the next nodes,
    int64 ``[W]``."""
    D = lo.shape[1]
    d = deg[cur].clamp(min=1)
    slot = torch.minimum((u1 * d.to(torch.float32)).to(torch.int32), d - 1)
    flat = cur * D + slot
    return torch.where(u2 < split.reshape(-1)[flat], lo.reshape(-1)[flat],
                       hi.reshape(-1)[flat]).long()


def alias_walk_plain(lo: torch.Tensor, hi: torch.Tensor, split: torch.Tensor,
                     deg: torch.Tensor, starts: torch.Tensor, u: torch.Tensor,
                     num_walks: int) -> torch.Tensor:
    """Plain PyTorch version; same arguments and result as :func:`alias_walk`."""
    cur = starts.long().repeat_interleave(num_walks)
    trail = [cur]
    for t in range(u.shape[0]):
        cur = alias_step_plain(lo, hi, split, deg, cur, u[t, 0], u[t, 1])
        trail.append(cur)
    walk = torch.stack(trail, dim=1).to(torch.int32)
    return walk.reshape(starts.shape[0], num_walks, u.shape[0] + 1)


def alias_walk(lo: torch.Tensor, hi: torch.Tensor, split: torch.Tensor, deg: torch.Tensor,
               starts: torch.Tensor, u: torch.Tensor, num_walks: int) -> torch.Tensor:
    """Walks ``int32 [S, num_walks, wl]`` with ``wl = u.shape[0] + 1``.

    ``lo``, ``hi`` int32 ``[n, D]``, ``split`` float32 ``[n, D]``, ``deg``
    int32 ``[n]`` (``sample.alias.build_alias_tables``), ``starts`` int32
    ``[S]`` in ``[0, n)``, ``u`` float32 ``[wl - 1, 2, S * num_walks]`` in
    ``[0, 1)`` (the module's layout); walker ``w`` starts at
    ``starts[w // num_walks]``.
    """
    dev = lo.device
    check_alias_tables(lo, hi, split, deg, starts, u, num_walks)
    if dev.type == "cpu":
        return alias_walk_plain(lo, hi, split, deg, starts, u, num_walks)
    if dev.type != "cuda":
        raise ValueError(f"alias_walk: unsupported device {dev}")
    out = torch.empty((starts.shape[0], num_walks, u.shape[0] + 1), dtype=torch.int32,
                      device=dev)
    launch_alias(lo, hi, split, deg, None, None, starts, u, out, None)
    alias_walk.launches += 1
    return out


alias_walk.launches = 0
