"""Profiling helpers (port of ``pathnet_tpu/utils/profiling.py``): a
``torch.profiler`` trace in place of ``jax.profiler``'s, and a throughput
counter.

``trace(log_dir)`` records the host's operators and, where a CUDA card is
present, its kernels (CUPTI), and writes one Chrome trace
(``trace_<pid>_<ns>.json``) into ``log_dir`` on exit, viewable in Perfetto or
``chrome://tracing``.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[str]:
    """Capture a ``torch.profiler`` trace of the enclosed block into
    ``log_dir``, the card's activity too when one is present."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    with profile(activities=activities) as prof:
        yield log_dir
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


class Throughput:
    """Running throughput counter: items/s since construction."""

    def __init__(self, unit: str = "paths"):
        self.unit = unit
        self.t0 = time.perf_counter()
        self.items = 0

    def add(self, n: int) -> None:
        self.items += n

    def rate(self) -> float:
        dt = time.perf_counter() - self.t0
        return self.items / dt if dt > 0 else 0.0

    def report(self) -> str:
        return f"{self.rate():,.0f} {self.unit}/s"
