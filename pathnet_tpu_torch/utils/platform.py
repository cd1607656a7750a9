"""CPU ranks for tests and the dry run (counterpart of
``pathnet_tpu/utils/platform.py:16-26``).

The JAX package forces ``n`` virtual CPU devices so that one process can
hold a mesh. The port's mesh is one process a rank, so its counterpart runs
a function on ``n`` gloo ranks on the CPU.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

from ..parallel.comm import spawn


def force_cpu_devices(fn: Callable, n: int = 8, args: Sequence = (),
                      kwargs: Optional[dict] = None, timeout_s: float = 600.0,
                      data_axis: Optional[int] = None, model_axis: int = 1,
                      threads: Optional[int] = None) -> List[Any]:
    """``fn(grid, *args, **kwargs)`` on ``n`` gloo ranks on the CPU, as a
    ``data_axis x model_axis`` grid (all data by default); returns each
    rank's result, and raises when a rank fails or ``timeout_s`` passes
    (:func:`~pathnet_tpu_torch.parallel.comm.spawn`)."""
    return spawn(fn, n, device="cpu", backend="gloo", timeout_s=timeout_s, args=args,
                 kwargs=kwargs, data_axis=data_axis, model_axis=model_axis,
                 threads=threads)
