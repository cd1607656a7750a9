#!/usr/bin/env python3
"""Serve and train PathNet with the PyTorch/CUDA port on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py`` (no arguments,
one card). Phases, each with a start and an end line:

0. device: the card's name, ``nvidia-smi`` name and power limit, versions;
1. build: ``nvcc`` compiles ``pathnet_tpu_torch/csrc/*.cu`` (one process per
   source, all at once) into ``build/pathnet_tpu_torch/<hash>/lib.so``
   (ptxas registers and spills shown, those of K4's three launches
   among them), and K3's tile (walks a block M, threads, shared bytes),
   which K4 shares, at H = 64 and H = 256;
2. kernels: K1 ``cdf_walk``, K2 ``membership_dists``, the fused
   ``walk_dists`` (K1 and K2 in one launch, the sampler's path) and K3
   ``pagg_encode_fwd`` against their plain PyTorch versions on one
   8192-target request of the bgp stand-in (K1, K2, ``walk_dists`` exact;
   K3 within atol = rtol = 1e-4); each kernel timed per launch inside a
   CUDA graph (no host work between launches) and per eager wrapper call,
   each plain version per eager call, all with CUDA events; K3's two
   launches (the encode to h_n, the readout) also timed each alone; then
   ``walk_dists`` against its plain version on every node (the training
   path's grid, 63,977 starts), exact;
3. serve: the bgp stand-in (n = 63,977, F = 8, D = 25) at H = 64, nw = 40,
   wl = 4 with seeded torch-default weights: 8 requests of 8192 targets that
   cover every node, then one of 1024 targets with ``num_ensemble=4``; the
   launch counts must be what the path makes;
4. cornell at full width (F = 1703, D = 190): one request over all nodes, the
   kernels against their plain versions at its shapes, and ``predict`` on
   the card against ``predict`` on the host with the same draws;
5. training kernels on one 8192-target bgp microbatch with a seeded dropout
   mask: K3 in training mode (atol = rtol = 1e-4), K4 ``pagg_encode_bwd``
   (every gradient within 1e-4 of its plain version's largest entry;
   ``dattw``, ``dattb``, sums that cancel, of ``dh``'s if larger), K5
   ``row_gather`` (exact) and ``row_gather_bwd`` (1e-5), K5 also at the
   gather probe's shape; each of K4's three launches (the forward
   recompute with its streams, the attention backward, the BPTT) against
   its plain stage on the plain stage's inputs (within 1e-4 of each
   output's largest plain entry); ``segment_sum`` of those stages' row
   gradients into ``dh`` against its plain version (within 1e-5 of its
   largest entry, two calls bit-equal); timed as in phase 2, with the
   PyTorch calls ``index_select`` and ``index_add_`` as K5's library
   yardsticks and ``index_add_`` as ``segment_sum``'s, K3's two launches
   each alone, and K4's three launches and the wrapper's weight
   contractions each alone;
6. train: ``run_round`` on the bgp stand-in for 3 epochs (microbatch 8192,
   dropout 0.7, Adam, best-on-validation) with the launch counts of the path;
7. cornell at full width in training: one step on the card and on the host
   with the same walks and masks; logits and every gradient within 1e-4 of
   the host's largest entry (``attw.bias``, a sum that cancels to near 0,
   within 1e-4 of the largest entry of ``attw.weight``'s gradient); then
   ``segment_sum`` on rows of cornell's walks against its plain version;
7b. two ``run_round`` calls with one seed (cornell at full width, dropout
   0.7, 30 epochs; the bgp stand-in, microbatch 8192, 2 epochs) must give
   bit-equal validation accuracies, losses and best params;
8. gather probe: K6 ``lane_gather`` against its plain version (exact) at the
   probe's ``[512, 128]`` and at ``[63977, 64]`` (bgp rows x H), timed as in
   phase 2 with ``torch.gather`` as its library yardstick; then the probe
   (``pathnet_tpu_torch.gather_probe.main``) on the card, with its launches;
9. payloads and MERW, in a temporary ``data_root`` holding copies of
   ``data/edge_input/*.in``: ``load_dataset`` makes the cornell, Nba, texas
   and chameleon payloads from nothing (seconds and a sha256 of each array;
   cornell's and Nba's must equal ``PAYLOAD_SHA256``, the JAX package's
   arrays, which a CPU test pins); chameleon's MERW on the card; the port's
   ``merw_graph`` on the card on the bgp stand-in's structure, whose probs
   must lie within ``MERW_TOL`` of the file's; the registry's bgp SBM
   structure and the per-component MERW that ``run_protocol`` runs on the
   host for it, timed;
10. the cornell protocol through the CLI (``pathnet_tpu_torch.run``) at the
    reference defaults (``CORNELL_ROUNDS`` rounds x 1000 epochs, H = 64,
    nw = 40, wl = 4, dropout 0.7) with temporary data, results and checkpoint
    directories; the mean test accuracy must lie inside the JAX band
    80.00 +- 5.82 (``results/results.jsonl:106``);
11. Nba at H = 256: ``walk_dists`` against K1 then K2's plain versions on
    all 403 nodes (D = 442), K3 (with and without the keep mask), K4 and
    ``segment_sum`` against their plain versions, and K4's three launches
    against their plain stages, on
    all 193 train targets of round 0, timed (K3's two launches, K4's three
    and its contractions also each alone), then the protocol through the CLI for
    ``NBA_ROUNDS`` rounds x 1000 epochs at ``-hid 256``, whose mean test
    accuracy must lie inside the JAX band 58.54 +- 5.23
    (``results/results.jsonl:104``).

The protocol phases gate on their band when they run 10 rounds of 1000
epochs, and on accuracy above chance when a rehearsal cuts them shorter.

The line before the last is the kernels' JSON record (launches from phase 6,
the training path, which runs ``walk_dists``, K3, K4, ``segment_sum`` and
K5, and launches K1 and K2 no time: ``walk_dists`` replaces them there, as
each one's ``note`` says; K6's from phase 8);
the last is ``{"ok": true, "device": {...}}``. Any failure exits non-zero and
prints no result. Without a CUDA card, or outside a checkout, it exits
non-zero.
"""
from __future__ import annotations

import faulthandler
import glob
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
BGP = os.path.join(ROOT, "data", "bench_cache", "bgp_standin_63977.npz")
CORNELL = os.path.join(ROOT, "data", "edge_input", "cornell.in")
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
NW, WL, HIDDEN, REQUEST, EPOCHS = 40, 4, 64, 8192, 3
K3_TOL = 1e-4
K4_TOL = 1e-4      # of each gradient's largest plain entry
K5_BWD_TOL = 1e-5  # of the largest plain entry (atomics order the sums)
KERNELS = ("cdf_walk", "membership_dists", "pagg_encode_fwd", "pagg_encode_bwd",
           "row_gather", "row_gather_bwd", "lane_gather", "segment_sum", "walk_dists")
SEGMENT_TOL = 1e-5  # of the largest plain entry
# kernels that the main path no longer launches, and why
NOTES = {name: "0 launches on the main path: walk_dists replaces it there; still the "
               "entry of " + use
         for name, use in (("cdf_walk", "sample_paths"),
                           ("membership_dists", "distances of walks from elsewhere"))}
# the kernels a request launches, and those a training step adds
FORWARD_PATH = ("walk_dists", "pagg_encode_fwd", "row_gather")
BACKWARD_PATH = ("pagg_encode_bwd", "segment_sum", "row_gather_bwd")
K4_GRADS = ("dh", "dwd", "dbd", "dw_ih", "dw_hh", "db_ih", "db_hh", "dattw", "dattb")
MERW_TOL = 5e-5    # max abs against the stored bgp probs (f32 power iteration)
PAYLOADS = ("cornell", "Nba", "texas", "chameleon")
# sha256 of each payload array (dtype, shape, bytes) as the JAX package makes
# it; tests/test_torch_data_payload.py pins them against pathnet_tpu
PAYLOAD_SHA256 = {
    "cornell": {
        "src": "a2bb944d63e4bc1c953d6dc7c080ce1aa524a9be6e66b493634b36fb38180f5c",
        "dst": "e656f749b4b0d5c3844a47b244e9aff3513c151f29c7a19145f127080b2064b8",
        "prob": "e31fd02f792372e5509dfc399f8ea7383bc147e1fe696dde6e86323ebdf046d7",
        "features": "d1fc16331eb6ed2c5271afc1452f2c84c849678be82c8e6257f6b39c1d124f68",
        "labels": "e7052f43387da3ace7495e2929df4e4ee1b3f7de141395523ee1defa69120413",
    },
    "Nba": {
        "src": "70bda7ed570756633db4cea7d8dc9a36305cbf0ee7aac39d6b418e8e86800493",
        "dst": "1bdb6ee3f267ffbfc871f17e378177fe25dcc94b3a1a856b009fe0a6544be344",
        "prob": "a3b75bb678d16e3d246963b1e9e6af469b8cff171ee33066ad84c84fa82e3cc6",
        "features": "6e0d282230b44160610cffd7a564bab008d8ed6650b31e622ad941d877b05a95",
        "labels": "286c30f9f409167f46a9b244df2d90333e85d60232ba27a99c03bbdc8068c3af",
    },
}
# (mean, std) of the JAX package's 10 x 1000 test accuracy, results/results.jsonl
CORNELL_BAND = (0.8000000178813934, 0.05821799973974322)    # :106, H = 64
NBA_BAND = (0.5853658318519592, 0.05231123852817561)        # :104, H = 256
CORNELL_ROUNDS, NBA_ROUNDS, NBA_HIDDEN, PROTOCOL_EPOCHS = 10, 10, 256, 1000


def say(msg: str) -> None:
    print(msg, flush=True)


def array_sha256(a) -> str:
    """sha256 of an array's dtype, shape and bytes."""
    a = np.ascontiguousarray(a)
    return hashlib.sha256(f"{a.dtype.str}{a.shape}".encode() + a.tobytes()).hexdigest()


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.monotonic()
        say(f"[phase {self.name}] start")
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.monotonic() - self.t0
        state = "ok" if exc_type is None else f"FAILED ({exc_type.__name__}: {exc})"
        say(f"[phase {self.name}] {state} after {dt:.1f} s")
        return False


def nvidia_smi_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=10)
        return r.stdout.strip().splitlines()[0] if r.stdout.strip() else "nvidia-smi: no output"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {type(e).__name__}"


def time_ms(fn, iters: int) -> float:
    """Mean ms per call: CUDA events around ``iters`` warm eager calls, host
    work between them included."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Mean ms per launch on the card: ``iters`` calls captured in one CUDA
    graph and replayed warm, so no host work lies between the launches."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(nbytes_: float, ops: float):
    t_bytes = nbytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernels(tag, ps, model, X, idx, u, rec, timed):
    """Hold K1, K2, K3 against their plain versions on one request; time them
    when ``timed``. Updates ``rec[name]`` with errors, times and bounds."""
    import torch
    from pathnet_tpu_torch import kernels as K

    smp = ps.sampler
    paths = K.cdf_walk(smp.nbr, smp.cdf, idx, u, ps.num_walks)
    paths_p = K.cdf_walk_plain(smp.nbr, smp.cdf, idx, u, ps.num_walks)
    torch.cuda.synchronize()
    if not torch.equal(paths, paths_p):
        raise AssertionError(f"{tag}: cdf_walk differs from its plain version in "
                             f"{int((paths != paths_p).sum())} entries")
    dists = K.membership_dists(smp.nbr, smp.deg, idx, paths)
    dists_p = K.membership_dists_plain(smp.nbr, smp.deg, idx, paths)
    torch.cuda.synchronize()
    if not torch.equal(dists, dists_p):
        raise AssertionError(f"{tag}: membership_dists differs from its plain "
                             f"version in {int((dists != dists_p).sum())} entries")
    check_walk_dists(tag, smp, idx, u, ps.num_walks, (paths_p, dists_p), rec)
    h, w = model.encode_inputs(X)
    agg = K.pagg_encode_fwd(h, paths, dists, *w)
    agg_p = K.pagg_encode_fwd_plain(h, paths, dists, *w)
    torch.cuda.synchronize()
    err3 = float((agg - agg_p).abs().max())
    if not torch.allclose(agg, agg_p, atol=K3_TOL, rtol=K3_TOL):
        raise AssertionError(f"{tag}: pagg_encode_fwd max abs err {err3} "
                             f"beyond atol = rtol = {K3_TOL}")
    for name, err in (("cdf_walk", 0.0), ("membership_dists", 0.0),
                      ("pagg_encode_fwd", err3)):
        rec[name]["max_abs_err"] = max(rec[name].get("max_abs_err", 0.0), err)
    say(f"  {tag}: cdf_walk exact, membership_dists exact, walk_dists exact, "
        f"pagg_encode_fwd max abs "
        f"err {err3:.3e} within atol = rtol = {K3_TOL}  (T={idx.shape[0]}, nw={ps.num_walks}, "
        f"wl={ps.walk_len}, D={smp.max_deg}, H={h.shape[1]})")
    if not timed:
        return
    S, nw, wl = paths.shape
    H = h.shape[1]
    # K1: two tables, starts, u in; walks out. One compare per slot and step.
    b1 = nbytes(smp.nbr, smp.cdf, idx, u, paths)
    o1 = S * nw * (wl - 1) * smp.max_deg
    # K2: the compares this data needs: N1 tests of v2, v3 against deg(s)
    # slots, and the N2 test deg(v3) x deg(s) where v3 is not in N1(s).
    b2 = nbytes(smp.nbr, smp.deg, idx, paths, dists)
    ds = smp.deg[idx.long()].double()[:, None]
    dv3 = smp.deg[paths[:, :, 3].long()].double()
    o2 = float(((dists[:, :, 2] != 0).double() * ds).sum()
               + ((dists[:, :, 3] != 0).double() * ds).sum()
               + ((dists[:, :, 3] >= 2).double() * ds * dv3).sum())
    # the fused launch: both tables, deg, starts, u in; walks and distances
    # out (the sorted rows are this design's copy of nbr, not the function's
    # input); K1's compares and K2's
    bw = nbytes(smp.nbr, smp.cdf, smp.deg, idx, u, paths, dists)
    # K3: per walk step 2H^2 (select) + 16H^2 (gates); per walk 6H (readout).
    b3 = nbytes(h, paths, dists, agg, *w)
    o3 = S * nw * (wl * 18 * H * H + 6 * H)
    runs = {
        "cdf_walk": (lambda: K.cdf_walk(smp.nbr, smp.cdf, idx, u, nw),
                     lambda: K.cdf_walk_plain(smp.nbr, smp.cdf, idx, u, nw), b1, o1),
        "membership_dists": (lambda: K.membership_dists(smp.nbr, smp.deg, idx, paths),
                             lambda: K.membership_dists_plain(smp.nbr, smp.deg, idx, paths),
                             b2, o2),
        "walk_dists": (lambda: K.walk_dists(smp.nbr, smp.cdf, smp.deg, smp.srt, idx, u, nw),
                       lambda: K.walk_dists_plain(smp.nbr, smp.cdf, smp.deg, smp.srt, idx,
                                                  u, nw), bw, o1 + o2),
        "pagg_encode_fwd": (lambda: K.pagg_encode_fwd(h, paths, dists, *w),
                            lambda: K.pagg_encode_fwd_plain(h, paths, dists, *w), b3, o3),
    }
    for name, (kern, plain, b, o) in runs.items():
        ms = graph_ms(kern, 50)
        call_ms = time_ms(kern, 20)
        plain_ms = time_ms(plain, 5)
        bound_ms, bound_by = bound(b, o)
        rec[name].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=None)
        say(f"  {name}: {ms:.4f} ms per launch in a CUDA graph, {call_ms:.4f} ms per "
            f"eager wrapper call (plain {plain_ms:.4f} ms eager, bound {bound_ms:.4f} ms "
            f"by {bound_by}: {b / 1e6:.1f} MB, {o / 1e9:.3f} G ops)")
    time_k3_stages("pagg_encode_fwd", h, paths, dists, w)


def check_walk_dists(tag, smp, idx, u, nw, want, rec):
    """The fused walk-and-distance launch against K1 then K2's plain
    versions: both outputs exact."""
    import torch
    from pathnet_tpu_torch import kernels as K

    got = K.walk_dists(smp.nbr, smp.cdf, smp.deg, smp.srt, idx, u, nw)
    torch.cuda.synchronize()
    for name, a, b in zip(("paths", "dists"), got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"{tag}: walk_dists {name} differ from the plain "
                                 f"versions' in {int((a != b).sum())} entries")
    record_err(rec, "walk_dists", 0.0)


def check_segment_sum(tag, paths, rows, n, rec, timed_=False):
    """The segment sum of K4's row gradients against its plain version
    (within SEGMENT_TOL of the plain maximum); timed when ``timed_``, with
    ``index_add_`` as its library yardstick."""
    import torch
    from pathnet_tpu_torch import kernels as K

    nodes = K.row_nodes(paths)
    got = K.segment_sum(rows, nodes, n)
    again = K.segment_sum(rows, nodes, n)
    want = K.segment_sum_plain(rows, nodes, n)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not err <= SEGMENT_TOL * float(want.abs().max()):
        raise AssertionError(f"{tag}: segment_sum max abs err {err}")
    if not torch.equal(got, again):
        raise AssertionError(f"{tag}: segment_sum differs between two calls")
    record_err(rec, "segment_sum", err)
    say(f"  {tag}: segment_sum max abs err {err:.3e} within {SEGMENT_TOL} x max, two "
        f"calls bit-equal ({rows.shape[0]} rows of {rows.shape[1]} into {n} nodes)")
    if timed_:
        R, H = rows.shape
        idx_l = nodes.long()
        # the function's bytes: rows and their node ids read, dh written (the
        # sort order and offsets are this design's, not the function's)
        b = R * H * 4 + R * 4 + n * H * 4
        timed(rec, "segment_sum", lambda: K.segment_sum(rows, nodes, n),
              lambda: K.segment_sum_plain(rows, nodes, n), b, float(R * H), 20,
              library=lambda: torch.zeros((n, H), device=rows.device).index_add_(0, idx_l,
                                                                                  rows))


def timed(rec, name, kern, plain, b, o, iters=50, library=None, kern_graph=None):
    """Time a kernel per launch in a CUDA graph and per eager call, its plain
    version and (if given) the library call per eager call; record them."""
    ms = graph_ms(kern_graph or kern, iters)
    call_ms = time_ms(kern, max(2, iters // 3))
    plain_ms = time_ms(plain, 3)
    lib_ms = time_ms(library, 20) if library is not None else None
    bound_ms, bound_by = bound(b, o)
    rec[name].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                     library_ms=lib_ms)
    say(f"  {name}: {ms:.4f} ms per launch in a CUDA graph, {call_ms:.4f} ms per "
        f"eager wrapper call (plain {plain_ms:.4f} ms eager, library "
        + ("n/a" if lib_ms is None else f"{lib_ms:.4f} ms") +
        f", bound {bound_ms:.4f} ms by {bound_by}: {b / 1e6:.1f} MB, {o / 1e9:.3f} G ops)")


def time_k3_stages(tag, h, paths, dists, w, mask_args=()):
    """Each of K3's two launches alone, per launch in a CUDA graph."""
    from pathnet_tpu_torch import kernels as K

    hn = K.encode_walks(h, paths, dists, *w[:6], *mask_args)
    enc_ms = graph_ms(lambda: K.encode_walks(h, paths, dists, *w[:6], *mask_args), 20)
    read_ms = graph_ms(lambda: K.readout(h, paths, hn, *w[6:]), 50)
    say(f"  {tag}: K3's encode launch {enc_ms:.4f} ms, its readout launch "
        f"{read_ms:.4f} ms, per launch in a CUDA graph")


def check_k4_stages(tag, g, h, paths, dists, w, mask, keep):
    """Each of K4's three launches against its plain stage, on the plain
    stage's inputs: every output within K4_TOL of its plain version's
    largest entry (``dattw``, ``dattb``, sums that cancel, of the ego rows'
    ``dh`` if larger)."""
    import torch
    from pathnet_tpu_torch import kernels as K

    parts = []

    def hold(stage, names, got, want, cancel_scale=0.0):
        for name, a, b in zip(names, got, want):
            err = float((a - b).abs().max())
            top = float(b.abs().max())
            scale = max(top, cancel_scale) if name in ("dattw", "dattb") else top
            if not err <= K4_TOL * scale:
                raise AssertionError(f"{tag}: K4's {stage} launch, {name} max abs err "
                                     f"{err} beyond {K4_TOL} x {scale}")
            parts.append(f"{name} {err / max(top, 1e-30):.1e}")

    enc = (h, paths, dists, *w[:6], mask, keep)
    want = K.encode_walks_streams_plain(*enc)
    hold("recompute", ("hn", "xr", "xin", "hp", "cs", "gt"), K.encode_walks_streams(*enc),
         want)
    hn, _, _, _, cs, gt = want
    want = K.attention_bwd_plain(g, h, paths, hn, *w[6:])
    hold("attention", ("dhn", "dego", "dattw", "dattb"),
         K.attention_bwd(g, h, paths, hn, *w[6:]), want, float(want[1].abs().max()))
    dego = want[1]
    bargs = (want[0], paths, dists, w[0], w[2], w[3], cs)
    want = K.bptt_plain(*bargs, gt, mask, keep)
    hold("bptt", ("drow", "dgates", "dsel"), K.bptt(*bargs, gt.clone(), mask, keep), want)
    say(f"  {tag}: K4's three launches each within {K4_TOL} of its plain stage (error "
        "over each plain max: " + ", ".join(parts) + ")")
    H = h.shape[1]
    return torch.cat([want[0].reshape(-1, H), dego])   # the row gradients


def time_k4_stages(tag, g, h, paths, dists, w, mask, keep):
    """Each of K4's three launches and the wrapper's weight contractions
    alone, per launch in a CUDA graph."""
    from pathnet_tpu_torch import kernels as K

    enc = (h, paths, dists, *w[:6], mask, keep)
    hn, xr, xin, hp, cs, gt = K.encode_walks_streams(*enc)
    rec_ms = graph_ms(lambda: K.encode_walks_streams(*enc), 5)
    dhn = K.attention_bwd(g, h, paths, hn, *w[6:])[0]
    att_ms = graph_ms(lambda: K.attention_bwd(g, h, paths, hn, *w[6:]), 20)
    bargs = (dhn, paths, dists, w[0], w[2], w[3], cs, gt, mask, keep)
    _, dg, dsel = K.bptt(*bargs)
    # each replay writes over gt again; the time does not depend on the values
    bptt_ms = graph_ms(lambda: K.bptt(*bargs), 5)
    con_ms = graph_ms(lambda: K.contractions(xr, xin, hp, dsel, dg, dists), 5)
    say(f"  {tag}: K4's forward recompute {rec_ms:.4f} ms, attention backward "
        f"{att_ms:.4f} ms, BPTT {bptt_ms:.4f} ms, weight contractions {con_ms:.4f} ms "
        "(torch.matmul, bmm), each per launch in a CUDA graph")


def record_err(rec, name, err):
    rec[name]["max_abs_err"] = max(rec[name].get("max_abs_err", 0.0), err)


def check_k4(tag, got, want):
    """Each K4 gradient within K4_TOL of its plain version's largest entry;
    ``dattw`` and ``dattb`` (sums over all walks that cancel) against the
    larger of that and ``dh``'s largest entry. Returns the max abs error."""
    dh_max = float(want[0].abs().max())
    worst = 0.0
    parts = []
    for name, a, b in zip(K4_GRADS, got, want):
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        if name in ("dattw", "dattb"):
            scale = max(scale, dh_max)
        parts.append(f"{name} {err / max(float(b.abs().max()), 1e-30):.1e}")
        if not err <= K4_TOL * scale:
            raise AssertionError(f"{tag}: pagg_encode_bwd {name} max abs err {err} "
                                 f"beyond {K4_TOL} x {scale}")
        worst = max(worst, err)
    say(f"  {tag}: pagg_encode_bwd within {K4_TOL} (error over each plain max: "
        + ", ".join(parts) + ")")
    return worst


def encode_bounds(h, paths, dists, m1, agg, g, w):
    """(bytes, ops) of K3 with a mask and of K4 on these inputs. K3: per walk
    step 2H^2 (select) + 16H^2 (gates), per walk 6H (readout). K4: the
    forward recompute (18 H^2 per walk step), the backward products (18 H^2)
    and the weight contractions (18 H^2), and ~14 H per walk for the
    attention."""
    T, nw, wl = paths.shape
    H = h.shape[1]
    walks = T * nw
    b3 = nbytes(h, paths, dists, m1, agg, *w)
    o3 = walks * (wl * 18 * H * H + 6 * H)
    b4 = nbytes(g, h, paths, dists, m1, *w) + nbytes(h, *w)
    o4 = walks * (wl * 54 * H * H + 14 * H)
    return b3, o3, b4, o4


def check_encode_kernels(tag, ps, model, X, idx, u, gen, rec, time_segment=False):
    """K3 without and with a keep mask, K4 and the segment sum of K4's row
    gradients against their plain versions on the targets ``idx`` (the
    segment sum timed when ``time_segment``); returns the inputs and outputs
    for timing."""
    import torch
    from pathnet_tpu_torch import kernels as K
    from pathnet_tpu_torch.models import draw_dropout_masks

    paths, dists = ps.sample(idx, u=u)
    T, nw, wl = paths.shape
    h, w = model.encode_inputs(X)
    H = h.shape[1]
    keep = 1.0 - model.spec.dropout
    m1, _ = draw_dropout_masks(model.spec, T, nw, gen, X.device)
    for mask_args, what in (((), "without a mask"), ((m1, keep), "with the keep mask")):
        agg = K.pagg_encode_fwd(h, paths, dists, *w, *mask_args)
        agg_p = K.pagg_encode_fwd_plain(h, paths, dists, *w, *mask_args)
        torch.cuda.synchronize()
        err3 = float((agg - agg_p).abs().max())
        if not torch.allclose(agg, agg_p, atol=K3_TOL, rtol=K3_TOL):
            raise AssertionError(f"{tag}: pagg_encode_fwd {what} max abs err {err3}")
        record_err(rec, "pagg_encode_fwd", err3)
        say(f"  {tag}: pagg_encode_fwd {what} max abs err {err3:.3e} within atol = "
            f"rtol = {K3_TOL} (T={T}, nw={nw}, wl={wl}, H={H}, keep={keep:.2f})")
    g = torch.randn((T, H), generator=gen, device=X.device)
    bwd_args = (g, h, paths, dists, *w, m1, keep)
    got = K.pagg_encode_bwd(*bwd_args)
    want = K.pagg_encode_bwd_plain(*bwd_args)
    torch.cuda.synchronize()
    record_err(rec, "pagg_encode_bwd", check_k4(tag, got, want))
    del got, want
    rows = check_k4_stages(tag, g, h, paths, dists, w, m1, keep)
    check_segment_sum(tag, paths, rows, h.shape[0], rec, time_segment)
    del rows
    return paths, dists, h, w, m1, keep, agg, g, bwd_args


def check_training_kernels(ps, model, X, idx, u, gen, rec):
    """K3 with a mask, K4, K5 against their plain versions on one training
    microbatch, then the probe's shape for K5; time each."""
    import torch
    from pathnet_tpu_torch import kernels as K

    paths, dists, h, w, m1, keep, agg, g, bwd_args = check_encode_kernels(
        "bgp microbatch", ps, model, X, idx, u, gen, rec, time_segment=True)
    T, nw, wl = paths.shape
    H = h.shape[1]

    n = h.shape[0]
    probe_tbl = torch.randn((512, 128), generator=gen, device=X.device)
    probe_idx = torch.randint(0, 512, (512,), generator=gen, device=X.device,
                              dtype=torch.int32)
    for tag, tbl, ix in (("ego rows", h, idx), ("probe [512, 128]", probe_tbl, probe_idx)):
        out = K.row_gather(tbl, ix)
        if not torch.equal(out, K.row_gather_plain(tbl, ix)):
            raise AssertionError(f"row_gather differs from its plain version ({tag})")
        dout = torch.randn(out.shape, generator=gen, device=X.device)
        d = K.row_gather_bwd(dout, ix, tbl.shape[0])
        d_p = K.row_gather_bwd_plain(dout, ix, tbl.shape[0])
        err5 = float((d - d_p).abs().max())
        if not err5 <= K5_BWD_TOL * float(d_p.abs().max()):
            raise AssertionError(f"row_gather_bwd ({tag}) max abs err {err5}")
        record_err(rec, "row_gather", 0.0)
        record_err(rec, "row_gather_bwd", err5)
        say(f"  {tag}: row_gather exact, row_gather_bwd max abs err {err5:.3e} within "
            f"{K5_BWD_TOL} x max (n={tbl.shape[0]}, C={tbl.shape[1]}, m={ix.shape[0]})")

    b3, o3, b4, o4 = encode_bounds(h, paths, dists, m1, agg, g, w)
    uniq = int(torch.unique(idx).numel())
    b5 = (uniq * H + T * H + T) * 4      # distinct rows read, rows written, idx
    b5b = (T * H + T + n * H) * 4        # dout and idx read, all of dtbl written
    idx_l = idx.long()
    dout = torch.randn((T, H), generator=gen, device=X.device)
    # K3's record keeps its serving time (phase 2); this one is printed only
    timed({"pagg_encode_fwd with keep mask": {}}, "pagg_encode_fwd with keep mask",
          lambda: K.pagg_encode_fwd(h, paths, dists, *w, keep_mask=m1, keep=keep),
          lambda: K.pagg_encode_fwd_plain(h, paths, dists, *w, m1, keep), b3, o3, 20)
    time_k3_stages("pagg_encode_fwd with keep mask", h, paths, dists, w, (m1, keep))
    timed(rec, "pagg_encode_bwd", lambda: K.pagg_encode_bwd(*bwd_args),
          lambda: K.pagg_encode_bwd_plain(*bwd_args), b4, o4, 5)
    time_k4_stages("pagg_encode_bwd", g, h, paths, dists, w, m1, keep)
    timed(rec, "row_gather", lambda: K.row_gather(h, idx),
          lambda: K.row_gather_plain(h, idx), b5, 0.0, 50,
          library=lambda: torch.index_select(h, 0, idx_l),
          kern_graph=lambda: K.row_gather(h, idx, check=False))
    timed(rec, "row_gather_bwd", lambda: K.row_gather_bwd(dout, idx, n),
          lambda: K.row_gather_bwd_plain(dout, idx, n), b5b, float(T * H), 50,
          library=lambda: torch.zeros((n, H), device=X.device).index_add_(0, idx_l, dout),
          kern_graph=lambda: K.row_gather_bwd(dout, idx, n, check=False))


def check_gather_probe(dev, gen, rec):
    """K6 against its plain version at the probe's shape and at bgp rows x H,
    timed; then the probe on the card, whose launches are K6's record."""
    import torch
    from pathnet_tpu_torch import gather_probe
    from pathnet_tpu_torch import kernels as K

    for n, D, lo in ((gather_probe.N, gather_probe.D, 0), (63977, HIDDEN, -63977)):
        tbl = torch.rand((n, D), generator=gen, device=dev)
        ix = torch.randint(lo, n, (n,), generator=gen, device=dev, dtype=torch.int32)
        out = K.lane_gather(tbl, ix)
        if not torch.equal(out, K.lane_gather_plain(tbl, ix)):
            raise AssertionError(f"lane_gather differs from its plain version at [{n}, {D}]")
        record_err(rec, "lane_gather", 0.0)
        say(f"  [{n}, {D}], idx in [{lo}, {n}): lane_gather exact")
        ids = torch.remainder(ix.long(), D)[:, None].expand(n, D)
        # rows written; idx and each row's selected float read
        b = (n * D + 2 * n) * 4
        name = "lane_gather" if n == gather_probe.N else f"lane_gather [{n}, {D}]"
        timed(rec if name == "lane_gather" else {name: {}}, name,
              lambda: K.lane_gather(tbl, ix), lambda: K.lane_gather_plain(tbl, ix), b, 0.0,
              50, library=lambda: torch.gather(tbl, 1, ids))
    K.reset_launch_counts()
    report = gather_probe.main([])
    torch.cuda.synchronize()
    counts = K.launch_counts()
    calls = gather_probe.REPS + 1
    expect = {name: 0 for name in KERNELS}
    expect.update(row_gather=3 * calls, lane_gather=calls)
    say(f"  launches: {counts}")
    if counts != expect:
        raise AssertionError(f"gather probe launch counts {counts}, the probe makes {expect}")
    for case in gather_probe.case_functions():
        if not report[case]["ok"] or report[case]["max_abs_err"] != 0.0:
            raise AssertionError(f"gather probe case {case}: {report[case]}")
    rec["lane_gather"]["launches"] = counts["lane_gather"]


def make_payloads(root, dev, z):
    """Payloads from nothing in ``root``, held to the JAX package's digests
    where pinned; chameleon's MERW and the bgp stand-in's on the card."""
    import torch
    from pathnet_tpu_torch.data import Graph
    from pathnet_tpu_torch.data.registry import load_dataset, load_structure
    from pathnet_tpu_torch.merw import merw_graph, merw_graph_per_component

    os.makedirs(os.path.join(root, "edge_input"))
    for f in sorted(glob.glob(os.path.join(ROOT, "data", "edge_input", "*.in"))):
        shutil.copy(f, os.path.join(root, "edge_input"))
    graphs = {}
    for name in PAYLOADS:
        t0 = time.perf_counter()
        g = load_dataset(name, root, 0)[0]
        secs = time.perf_counter() - t0
        digests = {f: array_sha256(getattr(g, f))
                   for f in ("src", "dst", "prob", "features", "labels")}
        say(f"  {name}: n={g.n}, {len(g.src)} records, F={g.features.shape[1]}, made in "
            f"{secs:.3f} s; sha256 " + ", ".join(f"{k} {v[:16]}" for k, v in digests.items()))
        want = PAYLOAD_SHA256.get(name)
        if want is not None:
            bad = [k for k in want if digests[k] != want[k]]
            if bad:
                raise AssertionError(f"{name}: arrays {bad} differ from the JAX package's")
            say(f"  {name}: all five arrays equal the JAX package's")
        graphs[name] = g
    gch = graphs["chameleon"]
    t0 = time.perf_counter()
    mch = merw_graph_per_component(gch, device=dev)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if not (np.isfinite(mch.prob).all() and (mch.prob > 0).all()):
        raise AssertionError("chameleon MERW probabilities are not finite and positive")
    say(f"  chameleon MERW (one component: the power iteration on the card): {ms:.1f} ms")
    bg = Graph(n=int(z["n"]), src=z["src"], dst=z["dst"], prob=np.ones(len(z["src"])))
    t0 = time.perf_counter()
    mb = merw_graph(bg, device=dev)
    ms = (time.perf_counter() - t0) * 1e3
    err = float(np.abs(mb.prob - z["prob"]).max())
    say(f"  bgp stand-in merw_graph on the card (n={bg.n}, {len(bg.src)} records): "
        f"{ms:.1f} ms, probs max abs err {err:.3e} against the stored ones")
    if not err <= MERW_TOL:
        raise AssertionError(f"bgp MERW probs differ from the stored ones by {err}")
    # what run_protocol pays before the first bgp round: the registry's SBM
    # stand-in is disconnected, so per-component MERW on the host (f64
    # log-space solver)
    t0 = time.perf_counter()
    gs = load_structure("bgp", root)
    t1 = time.perf_counter()
    mp = merw_graph_per_component(gs, device=dev)
    t2 = time.perf_counter()
    if not (np.isfinite(mp.prob).all() and (mp.prob > 0).all()):
        raise AssertionError("bgp per-component MERW probabilities are not finite and positive")
    say(f"  bgp SBM structure (n={gs.n}, {len(gs.src)} records): made in {t1 - t0:.2f} s; "
        f"merw_graph_per_component on the host (f64 log-space solver) {t2 - t1:.1f} s")


def check_wide_encode(root, dev, gen, rec):
    """K3 (with and without the mask) and K4 against their plain versions at
    Nba's H = 256 on all train targets of round 0, timed."""
    import torch
    from pathnet_tpu_torch import kernels as K
    from pathnet_tpu_torch.data.registry import load_dataset
    from pathnet_tpu_torch.models import PaggSpec, PathNet
    from pathnet_tpu_torch.sample import PathSampler
    from pathnet_tpu_torch.sample.walk import draw_uniforms

    g, train, _, _, spec_d = load_dataset("Nba", root, 0)
    ps = PathSampler.build(g, NW, WL, device=dev)
    X = torch.from_numpy(np.array(g.features, np.float32)).to(dev)
    model = PathNet(PaggSpec(feat_dim=X.shape[1], hidden=NBA_HIDDEN,
                             out_dim=spec_d.num_classes, walk_len=WL, dropout=0.7),
                    device=dev, generator=torch.Generator().manual_seed(3))
    idx = torch.from_numpy(np.flatnonzero(train).astype(np.int32)).to(dev)
    u = draw_uniforms(WL, idx.shape[0] * NW, gen, dev)
    smp = ps.sampler
    every = torch.arange(g.n, dtype=torch.int32, device=dev)
    ua = draw_uniforms(WL, g.n * NW, gen, dev)
    pa = K.cdf_walk_plain(smp.nbr, smp.cdf, every, ua, NW)
    check_walk_dists("Nba", smp, every, ua, NW,
                     (pa, K.membership_dists_plain(smp.nbr, smp.deg, every, pa)), rec)
    say(f"  Nba, all {g.n} nodes (D={smp.max_deg}): walk_dists exact")
    paths, dists, h, w, m1, keep, agg, gout, bwd_args = check_encode_kernels(
        f"Nba round 0, {idx.shape[0]} train targets", ps, model, X, idx, u, gen, rec)
    b3, o3, b4, o4 = encode_bounds(h, paths, dists, m1, agg, gout, w)
    name3, name4 = f"pagg_encode_fwd H={NBA_HIDDEN} masked", f"pagg_encode_bwd H={NBA_HIDDEN}"
    timed({name3: {}}, name3,
          lambda: K.pagg_encode_fwd(h, paths, dists, *w, keep_mask=m1, keep=keep),
          lambda: K.pagg_encode_fwd_plain(h, paths, dists, *w, m1, keep), b3, o3, 20)
    time_k3_stages(name3, h, paths, dists, w, (m1, keep))
    timed({name4: {}}, name4, lambda: K.pagg_encode_bwd(*bwd_args),
          lambda: K.pagg_encode_bwd_plain(*bwd_args), b4, o4, 10)
    time_k4_stages(name4, gout, h, paths, dists, w, m1, keep)


def check_reproducible(dev, gc, Xc, X, z, psc, ps):
    """Two ``run_round`` calls with one seed give bit-equal validation
    accuracies, losses and best params: cornell at full width with dropout
    (full batch, 30 epochs) and the bgp stand-in (microbatch 8192, the last
    chunk padded, 2 epochs)."""
    import torch
    from pathnet_tpu_torch.config import TrainConfig
    from pathnet_tpu_torch.data.splits import get_whole_mask, ratio_masks
    from pathnet_tpu_torch.models import PaggSpec
    from pathnet_tpu_torch.train import run_round

    yc = torch.from_numpy(np.random.default_rng(1).integers(0, 5, size=gc.n)).to(dev)
    y = torch.from_numpy(z["y"].astype(np.int64)).to(dev)
    C = int(z["y"].max()) + 1
    cases = (("cornell", Xc, yc, psc, ratio_masks(gc.n, 1000, val_size=59)[:3], 5,
              TrainConfig(epochs=30)),
             ("bgp stand-in", X, y, ps, get_whole_mask(z["y"], seed=1), C,
              TrainConfig(epochs=2, microbatch=REQUEST)))
    for tag, Xx, yy, psx, masks, classes, cfg in cases:
        spec = PaggSpec(feat_dim=Xx.shape[1], hidden=HIDDEN, out_dim=classes, walk_len=WL,
                        dropout=0.7)
        a, b = (run_round(Xx, yy, psx, spec, cfg, *masks, classes, seed=4,
                          track_history=True, keep_params=True) for _ in range(2))
        same = {"history": np.array_equal(a.history, b.history),
                "losses": np.array_equal(a.losses, b.losses),
                "best_params": all(torch.equal(v, b.best_params[k])
                                   for k, v in a.best_params.items())}
        if not all(same.values()):
            raise AssertionError(f"{tag}: two seeded rounds differ: {same}; losses "
                                 f"{a.losses.tolist()} and {b.losses.tolist()}")
        say(f"  {tag}, {cfg.epochs} epochs: two rounds with seed 4 bit-equal in history, "
            f"losses and all {len(a.best_params)} best params (last loss "
            f"{float(a.losses[-1]):.6f}, best val {a.best_val_acc:.4f})")


def run_protocol_cli(name, root, tmp, rounds, hidden, band):
    """The protocol through the CLI on the card with temporary results and
    checkpoint directories; checks its launches, checkpoints and accuracy."""
    import torch
    from pathnet_tpu_torch import kernels as K
    from pathnet_tpu_torch import run
    from pathnet_tpu_torch.data.registry import DATASETS

    out = os.path.join(tmp, f"{name}_h{hidden}")
    argv = ["-data", name, "-pr", root, "-r", str(rounds), "-e", str(PROTOCOL_EPOCHS),
            "-hid", str(hidden),
            "--results-dir", os.path.join(out, "results"),
            "--ckpt-dir", os.path.join(out, "ckpt"), "--resume"]
    K.reset_launch_counts()
    t0 = time.perf_counter()
    agg = run.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = K.launch_counts()
    epochs = PROTOCOL_EPOCHS * rounds
    say(f"  launches: {counts}")
    fwd = counts["pagg_encode_fwd"]
    if not (counts["walk_dists"] == counts["pagg_encode_bwd"] == counts["segment_sum"]
            == counts["row_gather_bwd"] == epochs and counts["row_gather"] == fwd
            and 2 * epochs <= fwd <= 3 * epochs and counts["lane_gather"]
            == counts["cdf_walk"] == counts["membership_dists"] == 0):
        raise AssertionError(f"{name} protocol launch counts {counts}: {epochs} epochs make "
                             "one walk, distance and backward launch each, and 2-3 forwards")
    saved = glob.glob(os.path.join(out, "ckpt", "*", "round_*", "meta.json"))
    if len(saved) != rounds or not os.path.isfile(
            os.path.join(out, "results", f"result_for_{name}.txt")):
        raise AssertionError(f"{name}: {len(saved)} rounds checkpointed, or no result line")
    mean, std = agg["accuracy"]
    say(f"  {name}, {rounds} rounds x {PROTOCOL_EPOCHS} epochs at H = {hidden}: acc {mean:.4f} +- {std:.4f} "
        f"(JAX {band[0]:.4f} +- {band[1]:.4f}); {secs:.1f} s, {secs / rounds:.2f} s per round, "
        f"{secs / epochs * 1e3:.3f} ms per epoch (loading and the sampler build included)")
    if rounds == 10 and PROTOCOL_EPOCHS == 1000:
        if not abs(mean - band[0]) <= band[1]:
            raise AssertionError(f"{name}: mean accuracy {mean} outside the JAX band {band}")
    elif not mean > 1.0 / DATASETS[name].num_classes:
        raise AssertionError(f"{name}: mean accuracy {mean} not above chance")


def main() -> int:
    faulthandler.dump_traceback_later(900, exit=True)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    try:
        from pathnet_tpu_torch import kernels as K
        from pathnet_tpu_torch.data import Graph
        from pathnet_tpu_torch.kernels import build
        from pathnet_tpu_torch.models import PaggSpec, PathNet
        from pathnet_tpu_torch.sample import PathSampler
        from pathnet_tpu_torch.sample.walk import draw_uniforms
        from pathnet_tpu_torch.config import TrainConfig
        from pathnet_tpu_torch.data.splits import get_whole_mask, ratio_masks
        from pathnet_tpu_torch.models import draw_dropout_masks
        from pathnet_tpu_torch.train import predict, run_round
        from pathnet_tpu_torch.train.trainer import (STREAM_INIT, chunk_index,
                                                     chunked_grads, make_generator)
    except ImportError as e:
        print(f"chip_smoke: run it from the root of a checkout ({e})", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rec = {name: {} for name in KERNELS}
    meta = {
        "cdf_walk": ("pathnet_tpu_torch/csrc/walk_dists.cu", "pathnet_tpu/sample/alias.py:142"),
        "membership_dists": ("pathnet_tpu_torch/csrc/walk_dists.cu",
                             "pathnet_tpu/sample/distance.py:77"),
        "pagg_encode_fwd": ("pathnet_tpu_torch/csrc/pagg_encode.cu",
                            "pathnet_tpu/models/pagg.py:235"),
        "pagg_encode_bwd": ("pathnet_tpu_torch/csrc/pagg_encode_bwd.cu",
                            "pathnet_tpu/models/pagg.py:235"),
        "row_gather": ("pathnet_tpu_torch/csrc/row_gather.cu",
                       "scripts/pallas_gather_probe.py:68"),
        "row_gather_bwd": ("pathnet_tpu_torch/csrc/row_gather.cu",
                           "scripts/pallas_gather_probe.py:68"),
        "lane_gather": ("pathnet_tpu_torch/csrc/lane_gather.cu",
                        "scripts/pallas_gather_probe.py:68"),
        "segment_sum": ("pathnet_tpu_torch/csrc/segment_sum.cu",
                        "pathnet_tpu/models/pagg.py:83"),
        "walk_dists": ("pathnet_tpu_torch/csrc/walk_dists.cu",
                       "pathnet_tpu/sample/alias.py:142, pathnet_tpu/sample/distance.py:77"),
    }

    with Phase("0 device"):
        kind = torch.cuda.get_device_name(0)
        smi = nvidia_smi_line()
        say(f"  device: {kind}; count {torch.cuda.device_count()}")
        say(smi)
        say(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
            f"cuda {torch.version.cuda}")

    with Phase("1 build"):
        path, report = build.build()
        say(f"  library: {os.path.relpath(path, ROOT)}")
        for line in report.splitlines():
            if ("Compiling entry" in line or "registers" in line
                    or "spill" in line or line.startswith("==")):
                say("  " + line.strip())
        build.library()
        for H in (HIDDEN, NBA_HIDDEN):
            say(f"  K3 tile at H = {H}: " + ", ".join(
                f"{k} {v}" for k, v in K.encode_tile(H).items()))

    gen = torch.Generator(device=dev).manual_seed(0)
    with Phase("2 kernels vs plain (bgp, one 8192-target request)"):
        z = np.load(BGP)
        g = Graph(n=int(z["n"]), src=z["src"], dst=z["dst"], prob=z["prob"],
                  name="bgp_standin")
        X = torch.from_numpy(z["x"]).to(dev)
        C = int(z["y"].max()) + 1
        ps = PathSampler.build(g, NW, WL, device=dev)
        spec = PaggSpec(feat_dim=X.shape[1], hidden=HIDDEN, out_dim=C, walk_len=WL)
        model = PathNet(spec, device=dev, generator=torch.Generator().manual_seed(0))
        order = np.random.default_rng(0).permutation(g.n)
        idx = torch.from_numpy(order[:REQUEST].astype(np.int32)).to(dev)
        u = draw_uniforms(WL, REQUEST * NW, gen, dev)
        check_kernels("bgp", ps, model, X, idx, u, rec, timed=True)
        # the training path's grid: every node a start, once an epoch
        every = torch.arange(g.n, dtype=torch.int32, device=dev)
        ua = draw_uniforms(WL, g.n * NW, gen, dev)
        check_walk_dists(f"bgp, all {g.n} nodes", ps.sampler, every, ua, NW,
                         K.walk_dists_plain(ps.sampler.nbr, ps.sampler.cdf, ps.sampler.deg,
                                            ps.sampler.srt, every, ua, NW), rec)
        say(f"  bgp, all {g.n} nodes as starts: walk_dists exact")
        del every, ua

    with Phase("3 serve bgp stand-in"):
        requests = np.resize(order, 8 * REQUEST).reshape(8, REQUEST)
        if len(np.unique(requests)) != g.n:
            raise AssertionError("the requests do not cover every node")
        K.reset_launch_counts()
        times = []
        for r in requests:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logp = predict(model, X, ps, gen, idx=r)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if logp.shape != (REQUEST, C) or not torch.isfinite(logp).all():
                raise AssertionError("non-finite or misshapen log-probs")
            dev_lse = float(torch.logsumexp(logp, dim=-1).abs().max())
            if dev_lse > 1e-5:
                raise AssertionError(f"rows do not normalise: |logsumexp| {dev_lse}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logp = predict(model, X, ps, gen, idx=order[:1024], num_ensemble=4)
        torch.cuda.synchronize()
        ens_ms = (time.perf_counter() - t0) * 1e3
        if not torch.isfinite(logp).all() or float(
                torch.logsumexp(logp, dim=-1).abs().max()) > 1e-5:
            raise AssertionError("ensemble log-probs are not finite or do not normalise")
        counts = K.launch_counts()
        say(f"  launches: {counts}")
        serving = {name: 8 + 4 if name in FORWARD_PATH else 0 for name in KERNELS}
        if counts != serving:
            raise AssertionError(f"serving launch counts {counts}, the path makes {serving}")
        med = float(np.median(times))
        say(f"  8 x {REQUEST}-target requests: ms " + ", ".join(f"{t:.2f}" for t in times)
            + f"; median {med:.2f} ms, {REQUEST / med * 1e3:.0f} targets/s "
            "(first request included)")
        say(f"  1024 targets x num_ensemble 4: {ens_ms:.2f} ms")

    with Phase("4 cornell at full width"):
        gc = Graph.from_edge_input(CORNELL, name="cornell")
        Xc_np = np.random.default_rng(0).normal(size=(gc.n, 1703)).astype(np.float32)
        Xc = torch.from_numpy(Xc_np).to(dev)
        psc = PathSampler.build(gc, NW, WL, device=dev)
        specc = PaggSpec(feat_dim=1703, hidden=HIDDEN, out_dim=5, walk_len=WL)
        mc = PathNet(specc, device=dev, generator=torch.Generator().manual_seed(1))
        allc = torch.arange(gc.n, dtype=torch.int32, device=dev)
        uc = draw_uniforms(WL, gc.n * NW, gen, dev)
        check_kernels("cornell", psc, mc, Xc, allc, uc, rec, timed=False)
        K.reset_launch_counts()
        logp = predict(mc, Xc, psc, idx=allc, u=uc[None])
        torch.cuda.synchronize()
        counts = K.launch_counts()
        if counts != {name: int(name in FORWARD_PATH) for name in KERNELS}:
            raise AssertionError(f"cornell request launch counts {counts}, expected 1 "
                                 "of each forward kernel")
        ps_host = PathSampler.build(gc, NW, WL, device="cpu")
        m_host = PathNet(specc, device="cpu")
        m_host.load_state_dict({k: v.cpu() for k, v in mc.state_dict().items()})
        logp_host = predict(m_host, torch.from_numpy(Xc_np), ps_host,
                            idx=allc.cpu(), u=uc[None].cpu())
        err = float((logp.cpu() - logp_host).abs().max())
        say(f"  predict on the card vs the host (same draws): max abs err {err:.3e}")
        if not torch.isfinite(logp).all() or err > K3_TOL:
            raise AssertionError(f"cornell log-probs differ from the host's by {err}")

    with Phase("5 training kernels vs plain (bgp, one 8192-target microbatch)"):
        spec5 = PaggSpec(feat_dim=X.shape[1], hidden=HIDDEN, out_dim=C, walk_len=WL,
                         dropout=0.7)
        model5 = PathNet(spec5, device=dev, generator=torch.Generator().manual_seed(0))
        check_training_kernels(ps, model5, X, idx, u, gen, rec)
        del model5

    with Phase(f"6 train bgp stand-in ({EPOCHS} epochs)"):
        y = torch.from_numpy(z["y"].astype(np.int64)).to(dev)
        masks = get_whole_mask(z["y"], seed=1)
        chunks = [-(-int(m.sum()) // REQUEST) for m in masks]
        say(f"  train / val / test nodes {[int(m.sum()) for m in masks]}, "
            f"{chunks} microbatches of {REQUEST}")
        cfg = TrainConfig(epochs=EPOCHS, microbatch=REQUEST)
        spec6 = PaggSpec(feat_dim=X.shape[1], hidden=HIDDEN, out_dim=C, walk_len=WL,
                         dropout=0.7)
        K.reset_launch_counts()
        res = run_round(X, y, ps, spec6, cfg, *masks, C, seed=0, track_history=True,
                        keep_params=True)
        torch.cuda.synchronize()
        counts = K.launch_counts()
        best, improved = 0.0, 0
        for acc in res.history:
            if acc > best:
                best, improved = float(acc), improved + 1
        fwd = EPOCHS * (chunks[0] + chunks[1]) + improved * chunks[2]
        expect = {"cdf_walk": 0, "membership_dists": 0, "walk_dists": EPOCHS,
                  "pagg_encode_fwd": fwd, "row_gather": fwd,
                  "pagg_encode_bwd": EPOCHS * chunks[0], "segment_sum": EPOCHS * chunks[0],
                  "row_gather_bwd": EPOCHS * chunks[0], "lane_gather": 0}
        say(f"  launches: {counts} ({improved} epochs improved on validation)")
        if counts != expect:
            raise AssertionError(f"training launch counts {counts}, the path makes {expect}")
        for name, c in counts.items():
            rec[name]["launches"] = c
        if not np.isfinite(res.losses).all():
            raise AssertionError(f"non-finite training loss {res.losses}")
        if res.best_val_acc != float(res.history.max()):
            raise AssertionError("best_val_acc is not the best validation accuracy")
        init = PathNet(spec6, device=dev, generator=make_generator(0, 0, STREAM_INIT))
        moved = [k for k, v in init.state_dict().items()
                 if not torch.equal(v, res.best_params[k])]
        if not moved:
            raise AssertionError("no parameter moved")
        say(f"  loss per epoch {res.losses.tolist()}, val acc {res.history.tolist()}, "
            f"best {res.best_val_acc:.4f}, test acc {res.metrics['accuracy']:.4f}")
        epoch_ms = [t * 1e3 for t in res.epoch_seconds]
        say(f"  ms per epoch {', '.join(f'{t:.2f}' for t in epoch_ms)}; median of "
            f"epochs 2-{EPOCHS}: {float(np.median(epoch_ms[1:])):.2f} ms")
        paths6, dists6 = ps.sample(generator=gen)
        ic, wc, total = chunk_index(masks[0], REQUEST, dev)
        grad_ms = time_ms(lambda: chunked_grads(init, X, y, paths6, dists6, ic[:1], wc[:1],
                                                total, dropout_gen=lambda i: gen), 5)
        say(f"  one {REQUEST}-target microbatch grad (forward K3 + K5, backward K4 + "
            f"K5, weight contractions): {grad_ms:.2f} ms")
        del res, init, paths6, dists6

    with Phase("7 cornell training step at full width"):
        trc = ratio_masks(gc.n, 1000, val_size=59)[0]
        idx7 = torch.from_numpy(np.flatnonzero(trc).astype(np.int32))
        yc = torch.from_numpy(np.random.default_rng(1).integers(0, 5, size=gc.n))
        spec7 = PaggSpec(feat_dim=1703, hidden=HIDDEN, out_dim=5, walk_len=WL, dropout=0.7)
        u7 = torch.rand((WL - 1, gc.n * NW), generator=torch.Generator().manual_seed(7))
        masks7 = draw_dropout_masks(spec7, idx7.shape[0], NW,
                                    torch.Generator().manual_seed(8), "cpu")
        out = []
        for d, psx, Xx in ((dev, psc, Xc), ("cpu", ps_host, torch.from_numpy(Xc_np))):
            m7 = PathNet(spec7, device=d, generator=torch.Generator().manual_seed(2))
            K.reset_launch_counts()
            p7, d7 = psx.sample(u=u7.to(d))
            rows = idx7.long().to(d)
            logits = m7(Xx, p7[rows], d7[rows], idx7.to(d), train=True,
                        masks=tuple(t.to(d) for t in masks7))
            torch.nn.functional.cross_entropy(logits, yc[idx7.long()].to(d)).backward()
            if d == dev:
                torch.cuda.synchronize()
                step_counts = K.launch_counts()
            out.append({"logits": logits.detach().cpu(),
                        **{k: q.grad.cpu() for k, q in m7.named_parameters()}})
        if step_counts != {name: int(name in FORWARD_PATH or name in BACKWARD_PATH)
                           for name in KERNELS}:
            raise AssertionError(f"cornell step launch counts {step_counts}, expected 1 of "
                                 "each training kernel")
        worst, parts = 0.0, []
        for k, want in out[1].items():
            err = float((out[0][k] - want).abs().max())
            scale = float(want.abs().max())
            if k == "attw.bias":
                # a sum over all walks of the score gradients, which cancel
                # to near 0; its summands are those of attw.weight's gradient
                scale = max(scale, float(out[1]["attw.weight"].abs().max()))
            rel = err / max(float(want.abs().max()), 1e-30)
            worst = max(worst, rel)
            parts.append(f"{k} {rel:.1e}")
            if not err <= 1e-4 * scale:
                raise AssertionError(f"cornell step: {k} differs from the host's by {err}")
        say(f"  {idx7.shape[0]} train nodes, F = 1703: logits and all {len(out[1]) - 1} "
            f"gradients on the card against the host (error over the host's largest "
            f"entry): " + ", ".join(parts))
        pc = psc.sample(u=uc)[0]
        rows7 = torch.randn(((WL + 1) * gc.n * NW, HIDDEN), generator=gen, device=dev)
        check_segment_sum(f"cornell, all {gc.n} nodes", pc, rows7, gc.n, rec)

    with Phase("7b seeded rounds twice (cornell 30 epochs, bgp stand-in 2 epochs)"):
        check_reproducible(dev, gc, Xc, X, z, psc, ps)

    with Phase("8 gather probe"):
        check_gather_probe(dev, gen, rec)

    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "data")
        with Phase("9 payloads and MERW"):
            make_payloads(root, dev, z)

        with Phase(f"10 cornell protocol ({CORNELL_ROUNDS} x {PROTOCOL_EPOCHS})"):
            run_protocol_cli("cornell", root, tmp, CORNELL_ROUNDS, HIDDEN, CORNELL_BAND)

        with Phase(f"11 Nba at H = {NBA_HIDDEN} ({NBA_ROUNDS} x {PROTOCOL_EPOCHS})"):
            check_wide_encode(root, dev, gen, rec)
            run_protocol_cli("Nba", root, tmp, NBA_ROUNDS, NBA_HIDDEN, NBA_BAND)

    say(smi)
    say(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": meta[name][0],
         "replaces": meta[name][1], "launches": r["launches"],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"],
         **({"note": NOTES[name]} if name in NOTES else {})}
        for name, r in rec.items()]}))
    faulthandler.cancel_dump_traceback_later()
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr, flush=True)
        rc = 1
    sys.exit(rc)
