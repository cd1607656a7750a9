"""Build ``csrc/*.cu`` with ``nvcc`` into one shared library and bind it with ctypes.

Every C entry point takes ``void*`` for each pointer and for the stream, and
returns ``cudaGetLastError()`` after its launch. The build lands in
``build/pathnet_tpu_torch/<hash of the sources, headers and flags>/lib.so`` at
the root of the checkout (``BUILD_ROOT``; ``utils.enable_compilation_cache``
moves it). One ``nvcc -c`` per source runs at the same time,
then one ``nvcc -shared`` links the objects, all in a fresh temporary
directory that is renamed into place only when the build succeeded: no lock
file exists, and a half-written build is never reused. Nothing is built when
a module is imported; the first launch, or an explicit :func:`build`, does it.

``python -m pathnet_tpu_torch.kernels.build`` times that build against one
``nvcc -shared csrc/*.cu`` call, each from nothing, and prints one JSON line.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
DEFAULT_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "pathnet_tpu_torch"
# moved by ``utils.enable_compilation_cache``
BUILD_ROOT = DEFAULT_BUILD_ROOT
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
TIMEOUT_S = 300

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argument types (all return int, a cudaError_t, but
# those in RESTYPES)
SIGNATURES = {
    # nbr, cdf, deg, srt, starts, u, paths, dists, D, S, nw, wl, walk, stream
    "pathnet_walk_dists": [_P] * 8 + [_I] * 5 + [_P],
    # K7: nbr, cdf, starts, u, tab, off, wid, paths, dists, D, S, nw, wl,
    # walk, stream
    "pathnet_khop_dists": [_P] * 9 + [_I] * 5 + [_P],
    # K8: lo, hi, split, deg, nbr, srt, starts, u, paths, dists, D, S, nw,
    # wl, stream
    "pathnet_alias_walk_dists": [_P] * 10 + [_I] * 4 + [_P],
    # K8 and K7: lo, hi, split, deg, starts, u, tab, off, wid, paths, dists,
    # D, S, nw, wl, stream
    "pathnet_alias_khop_dists": [_P] * 11 + [_I] * 4 + [_P],
    # h, paths, dists, wd, bd, w_ih, w_hh, b_ih, b_hh, mask, keep, hn, ego,
    # T, nw, wl, H, bf16, cell, stream (ego null: hetero; bf16 nonzero: h and
    # the six weights bf16; cell 0 the LSTM, 1 the GRU on packed weights, 2
    # the MLP; here and in K4's launches)
    "pathnet_pagg_encode_walks": [_P] * 10 + [_F, _P, _P] + [_I] * 6 + [_P],
    # h, paths, hn, ego, attw, attb, out, T, nw, wl, H, bf16, agg, stream
    # (agg: 0 attention, 1 mean, 2 sum, 3 quirk, here and in K4's attention
    # backward)
    "pathnet_pagg_readout": [_P] * 7 + [_I] * 6 + [_P],
    # H, bf16, out[4]: K3's tile (M, threads, shared bytes, KC)
    "pathnet_pagg_encode_tile": [_I, _I, _P],
    # K4's three launches. h, paths, dists, wd, bd, w_ih, w_hh, b_ih, b_hh,
    # mask, keep, hn, xr, xin, hp, cs, gt, ego, T, nw, wl, H, bf16, cell, stream
    "pathnet_pagg_encode_walks_streams": [_P] * 10 + [_F] + [_P] * 7 + [_I] * 6 + [_P],
    # g, h, paths, hn, ego, attw, attb, dhn, dego, part, T, nw, wl, H, bf16,
    # agg, stream
    "pathnet_pagg_attention_bwd": [_P] * 10 + [_I] * 6 + [_P],
    # dhn, dists, wd_t, w_t, cs (the GRU: hp), gt, mask, keep, xin, ego, dego,
    # dsel, drow, T, nw, wl, H, bf16, cell, stream
    "pathnet_pagg_bptt": [_P] * 7 + [_F] + [_P] * 5 + [_I] * 6 + [_P],
    # K4's weight contractions: xr, dsel, xin, hp, dg, dists, part, out, B, wl,
    # H, homo, mlp, tma (TMA copies, else 4-byte cp.async), stream
    "pathnet_pagg_contract": [_P] * 8 + [_I] * 6 + [_P],
    # B, wl, H, mlp: the floats of its scratch (returns a long long)
    "pathnet_pagg_contract_scratch": [_I] * 4,
    # rows, index, ints, units, offsets, part, out, R, n, H, stream
    "pathnet_segment_sum": [_P] * 7 + [_I] * 3 + [_P],
    # index, ints, units, offsets, R, n, stream
    "pathnet_segment_group": [_P] * 4 + [_I] * 2 + [_P],
    # R: the int32 scratch of the two above (returns a long long)
    "pathnet_segment_scratch": [_I],
    # tbl, idx, out, m, n, C, stream
    "pathnet_row_gather": [_P, _P, _P, _I, _I, _I, _P],
    # dout, idx, dtbl, m, C, stream
    "pathnet_row_gather_bwd": [_P, _P, _P, _I, _I, _P],
    # tbl, idx, out, n, D, stream
    "pathnet_lane_gather": [_P, _P, _P, _I, _I, _P],
    # S1: h, w (null: weight 1), ptr, perm, col, out, n, F, heads, types
    # (bit 0: h bf16, 1: w bf16, 2: out bf16), stream
    "pathnet_spmm": [_P] * 6 + [_I] * 4 + [_P],
    # S2: g, h, src, dst, out, E, F, heads, types (bit 0: h bf16, 1: g and
    # out bf16), stream
    "pathnet_edge_dot": [_P] * 5 + [_I] * 4 + [_P],
    # S3: s, ptr, perm, out, n, heads, bf16, stream
    "pathnet_segment_softmax": [_P] * 4 + [_I] * 3 + [_P],
    # S4: a, da, ptr, perm, ds, n, heads, bf16, stream
    "pathnet_segment_softmax_bwd": [_P] * 5 + [_I] * 3 + [_P],
    # stream: an empty kernel, the launch floor
    "pathnet_empty_launch": [_P],
}

RESTYPES = {"pathnet_segment_scratch": ctypes.c_longlong,
            "pathnet_pagg_contract_scratch": ctypes.c_longlong}

_lib: Optional[ctypes.CDLL] = None


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def find_nvcc() -> Optional[str]:
    """``$CUDA_HOME/bin/nvcc``, then ``/usr/local/cuda/bin/nvcc``, then ``PATH``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    return shutil.which("nvcc")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):   # the sources and their headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / source_hash() / "lib.so"


def _run_all(cmds: Sequence[List[str]]) -> str:
    """Start every command at once; wait for all within ``TIMEOUT_S``.

    Returns their joined output; raises ``RuntimeError`` with it when one
    fails or the time runs out (every process is then killed)."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    out, failed = [], []
    try:
        for cmd, p in zip(cmds, procs):
            try:
                text, _ = p.communicate(timeout=TIMEOUT_S)
            except subprocess.TimeoutExpired as e:
                raise RuntimeError(f"nvcc ran past {TIMEOUT_S} s: {' '.join(cmd)}") from e
            out.append(text)
            if p.returncode != 0:
                failed.append(f"nvcc failed (rc={p.returncode}): {' '.join(cmd)}\n{text}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(out)


def _compile(nvcc: str, out: Path, parallel: bool = True) -> str:
    """Write ``out/lib.so``: one ``nvcc -c`` per source, all at once, then a
    link (``parallel``), or one ``nvcc -shared`` over every source. Returns
    nvcc's report."""
    if not parallel:
        return _run_all([[nvcc, *FLAGS, "-shared", *map(str, sources()),
                          "-o", str(out / "lib.so")]])
    objs = [out / (src.stem + ".o") for src in sources()]
    report = _run_all([[nvcc, *FLAGS, "-c", str(src), "-o", str(obj)]
                       for src, obj in zip(sources(), objs)])
    report += _run_all([[nvcc, *FLAGS, "-shared", *map(str, objs),
                         "-o", str(out / "lib.so")]])
    for obj in objs:
        obj.unlink()
    return report


def _nvcc() -> str:
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return nvcc


def build() -> Tuple[Path, str]:
    """Compile every ``csrc/*.cu`` (one ``nvcc`` each, all at once) and link
    them into ``lib.so``.

    Returns the library's path and nvcc's ``-Xptxas -v`` report (empty when
    the library was already built). Raises ``RuntimeError`` with nvcc's
    output when the build fails or runs past ``TIMEOUT_S``.
    """
    final = library_path()
    if final.is_file():
        return final, ""
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT))
    try:
        report = _compile(nvcc, tmp)
        try:
            os.replace(tmp, final.parent)
        except OSError:
            # another process finished the same build first
            if not final.is_file():
                raise
        return final, report
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def time_builds(reps: int = 2) -> dict:
    """Seconds of each build from nothing, one-call and parallel alternating,
    in throwaway directories under ``BUILD_ROOT``."""
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    times = {"one_call_s": [], "parallel_s": []}
    for _ in range(reps):
        for key, parallel in (("one_call_s", False), ("parallel_s", True)):
            tmp = Path(tempfile.mkdtemp(prefix="time-", dir=BUILD_ROOT))
            try:
                t0 = time.perf_counter()
                _compile(nvcc, tmp, parallel)
                times[key].append(round(time.perf_counter() - t0, 2))
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
    return {"sources": len(sources()), **times}


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = RESTYPES.get(name, ctypes.c_int)
        lib.pathnet_error_string.argtypes = [ctypes.c_int]
        lib.pathnet_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def kernel_instance(mangled: str) -> Tuple[str, str]:
    """A kernel's name and its template arguments as mangled (``""`` without
    them) from the mangled name of its instance: the last length-prefixed
    identifier that ends in ``_kernel`` (a file's hash before it can read as
    a longer one)."""
    found = (mangled, "")
    for m in re.finditer(r"(?=(\d+))", mangled):   # every start of digits
        end = m.start() + len(m.group(1))
        ident = mangled[end:end + int(m.group(1))]
        if ident.endswith("_kernel") and ident[0].isalpha():
            args = re.match(r"I(.*?)Ev", mangled[end + len(ident):])
            found = (ident, args.group(1) if args else "")
    return found


def hmma_counts(kernel: str, flag: int) -> Dict[int, List[int]]:
    """The HMMA (tensor-core) instructions in each instance of ``kernel`` in
    the built library's SASS (``cuobjdump -sass``, from nvcc's directory),
    by the value of its integer or bool template argument number ``flag``."""
    path, _ = build()
    cuobjdump = Path(_nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(cuobjdump), "-sass", str(path)], capture_output=True,
                         text=True, timeout=TIMEOUT_S, check=True).stdout
    counts: Dict[int, List[int]] = {}
    key = None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name, args = kernel_instance(m.group(1))
            key = int(re.findall(r"L[bi](\d+)E", args)[flag]) if name == kernel else None
            if key is not None:
                counts.setdefault(key, []).append(0)
        elif key is not None and "HMMA" in line:
            counts[key][-1] += 1
    return counts


def check(rc: int, kernel: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        msg = library().pathnet_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed ({rc}: {msg})")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def empty_launch(device: torch.device) -> None:
    """One launch of an empty kernel on ``device``'s current stream: timed in
    a CUDA graph, the floor under any kernel's time per launch."""
    with torch.cuda.device(device):
        rc = library().pathnet_empty_launch(torch.cuda.current_stream(device).cuda_stream)
    check(rc, "empty_launch")


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            shape: Sequence[Optional[int]], device: torch.device) -> None:
    """Raise unless ``t`` has this dtype, rank and shape (``None`` matches any
    size), lies on ``device`` and is contiguous."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


if __name__ == "__main__":
    print(json.dumps({"build_times": time_builds()}))
