"""The gather probe on torch (port of ``scripts/pallas_gather_probe.py``).

    python -m pathnet_tpu_torch.gather_probe [--device cuda|cpu] [--out PATH]

The JAX probe runs four Pallas bodies on one input, ``tbl`` float32
``[512, 128]`` and ``idx`` int32 ``[512]`` in ``[0, 512)`` from
``default_rng(0)``, and the XLA row gather beside them. Here the three row
gathers (``int_indexing``, ``take``, ``row_shuffle_axis0``, which all compute
``tbl[idx]``) run K5 ``row_gather``, and ``lane_gather_axis1``
(``tbl[i, idx[i] % D]`` across row ``i``) runs K6 ``lane_gather``, on the
same inputs. Each case reports ``ok``, ``compile_s`` (the first call, which
builds or loads the kernel library), ``steady_us`` (mean over 50 calls,
timed with CUDA events on the card and the host clock on the CPU) and
``max_abs_err`` against the kernel's plain version. The baselines are one
PyTorch call each: ``tbl[idx]`` (``torch_row_gather``, the XLA row gather's
counterpart) and ``torch.gather`` along dim 1 (``torch_lane_gather``).

A kernel that fails raises; nothing is recorded as ``ok: false``. The report
is printed as one JSON line and written to ``--out`` when given. The JAX
probe's ``decision`` field, a question about the TPU's compiler, has no
counterpart here.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from .device import resolve_device
from .kernels import (lane_gather, lane_gather_plain, row_gather,
                      row_gather_plain)

N, D = 512, 128
REPS = 50
ROW_CASES = ("int_indexing", "take", "row_shuffle_axis0")
LANE_CASE = "lane_gather_axis1"


def probe_inputs(device: Union[str, torch.device] = "cpu"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(tbl float32 [512, 128], idx int32 [512])``, drawn as the JAX probe
    draws them."""
    rng = np.random.default_rng(0)
    tbl = rng.random((N, D)).astype(np.float32)
    idx = rng.integers(0, N, size=N).astype(np.int32)
    return torch.from_numpy(tbl).to(device), torch.from_numpy(idx).to(device)


def case_functions() -> Dict[str, Tuple[Callable, Callable]]:
    """Each probe case's ``(kernel wrapper, plain version)``."""
    cases = {name: (row_gather, row_gather_plain) for name in ROW_CASES}
    cases[LANE_CASE] = (lane_gather, lane_gather_plain)
    return cases


def _mean_us(fn: Callable[[], torch.Tensor], dev: torch.device, reps: int = REPS) -> float:
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / reps * 1e3
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e6


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_probe(device: Optional[Union[str, torch.device]] = None) -> dict:
    """The report: one entry per case and per baseline, and the device."""
    dev = resolve_device(device)
    tbl, idx = probe_inputs(dev)
    report = {}
    for name, (kern, plain) in case_functions().items():
        _sync(dev)
        t0 = time.perf_counter()
        out = kern(tbl, idx)
        _sync(dev)
        compile_s = time.perf_counter() - t0
        err = float((out - plain(tbl, idx)).abs().max())
        report[name] = {"ok": True, "compile_s": compile_s,
                        "steady_us": _mean_us(lambda: kern(tbl, idx), dev),
                        "max_abs_err": err}
    idx_l = idx.long()
    ids = torch.remainder(idx_l, D)[:, None].expand(N, D)
    for name, fn in (("torch_row_gather", lambda: tbl[idx_l]),
                     ("torch_lane_gather", lambda: torch.gather(tbl, 1, ids))):
        fn()
        _sync(dev)
        report[name] = {"ok": True, "steady_us": _mean_us(fn, dev)}
    report["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                        else str(dev))
    return report


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="row and lane gather probe (K5, K6)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs the "
                        "plain PyTorch versions)")
    p.add_argument("--out", type=str, default=None,
                   help="also write the report to this JSON file")
    args = p.parse_args(argv)
    report = run_probe(args.device)
    print(json.dumps(report))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
