"""Wall-clock phase timers (port of ``pathnet_tpu/utils/timing.py``; the
reference's commented-out probes, PathNet_run.py:316-396, as a utility).
Host clock only: a caller timing work on the card synchronizes first."""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict


class Timer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> str:
        lines = []
        for name in sorted(self.totals):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name}: total {t:.3f}s over {c} calls "
                         f"({1000 * t / max(c, 1):.1f} ms/call)")
        return "\n".join(lines)
