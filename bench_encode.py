#!/usr/bin/env python3
"""Time K3 (the PAGG encode forward) of the PyTorch/CUDA port on one CUDA card,
with K4 and the request and epoch times around it.

    python3 bench_encode.py                 # this checkout; one JSON line
    python3 bench_encode.py --ab OTHER      # OTHER, this, this, OTHER in turn
    python3 bench_encode.py [--ab OTHER] --profile   # where a bgp epoch's time goes

``OTHER`` is the root of another checkout (say the parent commit unpacked
with ``git archive``). Each turn runs in its own process, which imports
``pathnet_tpu_torch`` from that root, builds its kernels there and prints one
JSON line:

- ``k3_bgp_ms``: K3 per launch in a CUDA graph on one 8192-target request of
  the bgp stand-in (n = 63,977, H = 64, nw = 40, wl = 4, seeded weights);
- ``k3_nba_masked_ms``: K3 with the keep mask on Nba's 193 train targets of
  round 0 at H = 256 (payload made from ``data/edge_input`` in a temporary
  data root); ``k4_bgp_ms``, ``k4_nba_ms``: K4 on the same inputs with the mask;
- ``k3_*_encode_ms``, ``k3_*_readout_ms``: K3's two launches each alone,
  where the checkout has them;
- ``k4_{bgp,nba}_{recompute,attn,bptt}_ms``: K4's three launches each alone
  (the forward recompute with its streams, the attention backward, the
  BPTT), ``k4_*_contract_ms``, the weight contractions alone (the kernel
  ``pagg_contract`` where the checkout has it), ``k4_*_contract_plain_ms``,
  their plain composition (``torch.matmul``, ``bmm``), and
  ``k4_*_contract_{layout,copies,bmm,onehot,dw_ih,dw_hh,db}_ms``, that
  composition's steps each alone (``chip_smoke.contraction_parts``), and
  ``k4_*_dhsum_ms``, the segment sum of the row gradients into ``dh`` (its
  grouping included), where the checkout has them; the segment sum's parts:
  ``k4_*_rownodes_ms`` (``row_nodes``, the rows' node ids), ``k4_*_segments_ms``
  (``segments``, the grouping alone), each per call in a CUDA graph, and
  ``k4_*_dhsum_kernels_us``, the device time of each kernel of one
  ``segment_sum`` call by name (``torch.profiler`` over 20 eager calls);
- ``k5_bgp_ms``, ``k5_bgp_call_ms``: K5's forward on the request's ego rows
  (8192 x 64), per wrapper call in a CUDA graph and per eager call (CUDA
  events), and ``k5_bgp_kernels_us``, each of its kernels' device time a call;
- ``request_ms``: median host time of 8 ``predict`` calls of 8192 targets;
- ``bgp_epoch_ms``, ``nba_epoch_ms``, ``cornell_epoch_ms``: median host
  time of the epochs after the first of ``run_round`` (bgp stand-in: 3
  epochs, microbatch 8192; Nba at H = 256: 20 epochs; cornell at H = 64,
  full batch as in its protocol: 100 epochs);
- ``k3_bgp_bf16_ms``, ``k4_bgp_bf16_ms`` (and their launches' keys, as
  above), ``request_bf16_ms``, ``bgp_bf16_epoch_ms``: the same at bf16
  compute (``compute_dtype="bfloat16"``: K3's and K4's bf16 instances),
  where the checkout runs it;
- ``k3_bgp_h32_ms``, ``k4_bgp_h32_ms`` and their launches' keys (as
  above, ``k3_bgp_h32_encode_ms``, ``k4_bgp_h32_recompute_ms``, ...), at f32
  and (``..._h32_bf16_...``) at bf16: K3 and K4 at H = 32 (Electronics'
  width) on the same request and microbatch, seeded weights;
- ``k4_bgp_mlp_ms`` and its launches' keys (``k4_bgp_mlp_recompute_ms``,
  ...): K4 of the MLP encoder (``rnn="mlp"``) on the bgp microbatch;
- ``k4_bgp_mean_ms``: K4 under the mean readout (``agg="mean"``) on the
  bgp microbatch, with ``k4_bgp_mean_attn_ms`` (its attention backward
  launch alone) and ``k4_bgp_mean_dhsum_ms`` (the segment sum of the rows
  it gives, ego rows included where the checkout writes them), where the
  checkout runs it;
- ``k1_{shape}_ms``, ``k2_{shape}_ms``, ``walk_dists_{shape}_ms``: K1
  (``cdf_walk``), K2 (``membership_dists`` on K1's walks) and, where the
  checkout has it, the fused ``walk_dists``, per launch in a CUDA graph, at
  nw = 40, wl = 4, for the shapes ``bgp_request`` (8192 starts),
  ``bgp_epoch`` (all 63,977 nodes), ``cornell`` (all 183 nodes, D = 190)
  and ``nba`` (all 403 nodes, D = 442).

Every line carries the card's ``nvidia-smi`` name and power limit.

    python3 bench_encode.py --regs OTHER    # registers and spills, OTHER against this

builds the kernels of both checkouts from nothing (one ``nvcc -c`` per
source, as ``pathnet_tpu_torch.kernels.build`` does) and prints each
kernel instance's registers and spill bytes from ``ptxas -v``, keyed by
kernel and template arguments, with the instances that differ.

    python3 bench_encode.py --contract [--ab OTHER]   # pagg_contract's variants

times ``pagg_contract`` at the bgp microbatch for each of
``CONTRACT_VARIANTS`` (the kernel as committed, and copies that leave a part
out to show where the time goes), each built alone, with each instance's
registers and spills, and prints one JSON line. With ``--ab OTHER`` it first
times OTHER's and this checkout's kernel (each built alone) at each of
``CONTRACT_SHAPES`` in turns (OTHER, this, this, OTHER), beside the plain
version and the bound, on streams 4 bytes off a 16-byte boundary too, with
three cornell epochs and the host time of an eager call at cornell's shape
(``contract_times``), one JSON line a turn.
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def graph_ms(fn, iters: int) -> float:
    """Mean ms per launch: ``iters`` calls in one CUDA graph, replayed warm."""
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


def time_ms(fn, iters: int) -> float:
    """Mean ms per eager call: CUDA events around ``iters`` warm calls."""
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


def kernel_us(fn, iters: int = 20) -> dict:
    """Device microseconds a call of each kernel ``fn`` launches, by kernel
    name: ``torch.profiler`` over ``iters`` warm eager calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        us = evt.self_device_time_total / iters
        if us > 0:
            out[evt.key[:120]] = round(us, 3)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       timeout=10)
    return r.stdout.strip().splitlines()[0]


def encode_times(K, tag, h, paths, dists, w, mask_args, out):
    out[f"k3_{tag}_ms"] = graph_ms(lambda: K.pagg_encode_fwd(h, paths, dists, *w, *mask_args),
                                   20)
    if hasattr(K, "encode_walks"):
        hn = K.encode_walks(h, paths, dists, *w[:6], *mask_args)
        out[f"k3_{tag}_encode_ms"] = graph_ms(
            lambda: K.encode_walks(h, paths, dists, *w[:6], *mask_args), 20)
        out[f"k3_{tag}_readout_ms"] = graph_ms(lambda: K.readout(h, paths, hn, *w[6:]), 50)


def k4_stage_times(K, tag, g, h, paths, dists, w, mask_args, out, cell="lstm"):
    """K4's three launches, its weight contractions (and, where the checkout
    has them, their plain composition and its steps, ``chip_smoke``'s
    ``contraction_parts``) and, where the checkout has it, the segment sum
    of its row gradients, each alone."""
    import torch
    from chip_smoke import contraction_parts
    if not hasattr(K, "bptt"):
        return
    n = h.shape[0]
    enc = (h, paths, dists, *w[:6], *mask_args)
    cellarg = {} if cell == "lstm" else {"cell": cell}
    hn, xr, xin, hp, cs, gt = K.encode_walks_streams(*enc, **cellarg)
    out[f"k4_{tag}_recompute_ms"] = graph_ms(lambda: K.encode_walks_streams(*enc, **cellarg), 5)
    dhn = K.attention_bwd(g, h, paths, hn, *w[6:])[0]
    out[f"k4_{tag}_attn_ms"] = graph_ms(lambda: K.attention_bwd(g, h, paths, hn, *w[6:]), 20)
    bargs = (dhn, paths, dists, w[0], w[2], w[3], cs, gt, *mask_args)
    _, dg, dsel = K.bptt(*bargs, **cellarg)
    # each replay writes over gt again: the times do not depend on the values
    out[f"k4_{tag}_bptt_ms"] = graph_ms(lambda: K.bptt(*bargs, **cellarg), 5)
    con = (xr, xin, hp, dsel, dhn if cell == "mlp" else dg, dists) + (
        (False, cell) if cellarg else ())
    out[f"k4_{tag}_contract_ms"] = graph_ms(lambda: K.contractions(*con), 5)
    if hasattr(K, "contractions_plain"):
        out[f"k4_{tag}_contract_plain_ms"] = graph_ms(lambda: K.contractions_plain(*con), 5)
    if hasattr(K, "row_nodes"):   # the checkout's streams are contraction_parts' layout
        for k, fn in contraction_parts(*con).items():
            out[f"k4_{tag}_contract_{k}_ms"] = graph_ms(fn, 5)
    if hasattr(K, "segment_sum") and not cellarg:
        drow = K.bptt(*bargs)[0]
        dego = K.attention_bwd(g, h, paths, hn, *w[6:])[1]
        rows = torch.cat([drow.reshape(-1, drow.shape[-1]), dego])
        nodes = K.row_nodes(paths)
        out[f"k4_{tag}_dhsum_ms"] = graph_ms(lambda: K.segment_sum(rows, nodes, n), 20)
        out[f"k4_{tag}_rownodes_ms"] = graph_ms(lambda: K.row_nodes(paths), 20)
        seg = importlib.import_module(K.segment_sum.__module__)
        out[f"k4_{tag}_segments_ms"] = graph_ms(lambda: seg.segments(nodes, n), 20)
        out[f"k4_{tag}_dhsum_kernels_us"] = kernel_us(lambda: K.segment_sum(rows, nodes, n))


def mlp_times(K, X, C, paths, dists, m1, gout, out):
    """K4 of the MLP encoder (``rnn="mlp"``) on the bgp microbatch with its
    launches and contractions."""
    import torch
    from pathnet_tpu_torch.models import PaggSpec, PathNet

    spec = PaggSpec(feat_dim=X.shape[1], hidden=64, out_dim=C, walk_len=4, dropout=0.7,
                    rnn="mlp")
    model = PathNet(spec, device=X.device, generator=torch.Generator().manual_seed(0))
    h, w = model.encode_inputs(X)
    out["k4_bgp_mlp_ms"] = graph_ms(
        lambda: K.pagg_encode_bwd(gout, h, paths, dists, *w, m1, 0.3, cell="mlp"), 5)
    k4_stage_times(K, "bgp_mlp", gout, h, paths, dists, w, (m1, 0.3), out, cell="mlp")


def mean_times(K, g, h, paths, dists, w, mask_args, out):
    """K4 under the mean readout, its attention backward alone and the
    segment sum of its row gradients, where the checkout takes ``agg``."""
    import torch
    if "agg" not in K.pagg_encode_bwd.__code__.co_varnames:
        return
    n = h.shape[0]
    out["k4_bgp_mean_ms"] = graph_ms(
        lambda: K.pagg_encode_bwd(g, h, paths, dists, *w, *mask_args, agg="mean"), 5)
    hn, xr, xin, hp, cs, gt = K.encode_walks_streams(h, paths, dists, *w[:6], *mask_args)
    dhn, dego = K.attention_bwd(g, h, paths, hn, *w[6:], agg="mean")[:2]
    out["k4_bgp_mean_attn_ms"] = graph_ms(
        lambda: K.attention_bwd(g, h, paths, hn, *w[6:], agg="mean"), 20)
    drow = K.bptt(dhn, paths, dists, w[0], w[2], w[3], cs, gt, *mask_args)[0]
    rows = drow.reshape(-1, drow.shape[-1])
    if dego is None:   # no ego rows under mean
        nodes = K.row_nodes(paths, agg="mean")
    else:              # the attention layout, its ego rows zeros
        rows, nodes = torch.cat([rows, dego]), K.row_nodes(paths)
    out["k4_bgp_mean_dhsum_ms"] = graph_ms(lambda: K.segment_sum(rows, nodes, n), 20)


def width_times(K, X, C, paths, dists, gen, out, H=32):
    """K3 and K4 (with their launches) at hidden width ``H``, f32 and, where
    the checkout runs it, bf16, with seeded weights."""
    import torch
    from pathnet_tpu_torch.models import PaggSpec, PathNet, draw_dropout_masks

    T, nw, wl = paths.shape
    spec = PaggSpec(feat_dim=X.shape[1], hidden=H, out_dim=C, walk_len=wl, dropout=0.7)
    m1, _ = draw_dropout_masks(spec, T, nw, gen, X.device)
    g = torch.randn((T, H), generator=gen, device=X.device)
    for tag, sp in ((f"bgp_h{H}", spec),
                    (f"bgp_h{H}_bf16", dataclasses.replace(spec, compute_dtype="bfloat16"))):
        try:
            model = PathNet(sp, device=X.device, generator=torch.Generator().manual_seed(0))
        except NotImplementedError:
            continue
        h, w = model.encode_inputs(X)
        encode_times(K, tag, h, paths, dists, w, (), out)
        out[f"k4_{tag}_ms"] = graph_ms(
            lambda: K.pagg_encode_bwd(g, h, paths, dists, *w, m1, 0.3), 5)
        k4_stage_times(K, tag, g, h, paths, dists, w, (m1, 0.3), out)
        out.pop(f"k4_{tag}_dhsum_kernels_us", None)


def ptxas_report(root: str) -> str:
    """The ``ptxas -v`` report of a build from nothing of ``root``'s kernels,
    in a process of its own that imports ``root``'s build module."""
    code = ("import pathlib, shutil, sys, tempfile\n"
            f"sys.path.insert(0, {root!r})\n"
            "from pathnet_tpu_torch.kernels import build\n"
            "d = pathlib.Path(tempfile.mkdtemp())\n"
            "try:\n    sys.stdout.write(build._compile(build._nvcc(), d))\n"
            "finally:\n    shutil.rmtree(d, ignore_errors=True)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=900, check=True)
    return r.stdout


def kernel_regs(report: str) -> dict:
    """``{kernel<template args>: (registers, spill stores, spill loads)}`` from
    a ptxas report, each instance keyed by ``kernel_instance``."""
    import re
    from pathnet_tpu_torch.kernels.build import kernel_instance

    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = "{}<{}>".format(*kernel_instance(m.group(1)))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name] = out.get(name, (0,)) + (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = (int(m.group(1)),) + out.get(name, (0, 0, 0))[1:]
    return out


def compare_regs(other: str) -> None:
    """Registers and spills of ``other``'s kernels and this checkout's."""
    import re
    a, b = kernel_regs(ptxas_report(other)), kernel_regs(ptxas_report(HERE))
    # an instance that gained a last bool template argument is the other's
    # instance without it: the one with false (a new argument that defaults
    # to false, as ALIAS), then the one with true
    for flag in ("Lb0E", "Lb1E"):
        for k in [k for k in b if k not in a]:
            k0 = re.sub(flag + r"(E*>)$", r"\1", k)
            if k0 != k and k0 in a and k0 not in b:
                a[k] = a.pop(k0)
    # an instance whose bool argument became an int of the same value (the
    # encoder flag GRU, now the cell CELL: LSTM 0, GRU 1) is the other's
    for k in [k for k in b if k not in a]:
        for m in re.finditer(r"Li([01])E", k):
            k0 = k[:m.start()] + f"Lb{m.group(1)}E" + k[m.end():]
            if k0 in a and k0 not in b:
                a[k] = a.pop(k0)
                break
    same = [k for k in a if b.get(k) == a[k]]
    print(json.dumps({"device": smi(), "equal": len(same),
                      "differ": {k: [a[k], b[k]] for k in sorted(a) if k in b and a[k] != b[k]},
                      "only_other": {k: a[k] for k in sorted(set(a) - set(b))},
                      "only_this": {k: b[k] for k in sorted(set(b) - set(a))}}), flush=True)


def walk_times(K, shapes, gen, out):
    """K1, K2 and the fused walk-and-distance launch at each of ``shapes``,
    ``{tag: (sampler, starts)}``."""
    from pathnet_tpu_torch.sample.walk import draw_uniforms

    for tag, (ps, starts) in shapes.items():
        smp = ps.sampler
        u = draw_uniforms(4, starts.shape[0] * 40, gen, starts.device)
        paths = K.cdf_walk(smp.nbr, smp.cdf, starts, u, 40)
        out[f"k1_{tag}_ms"] = graph_ms(lambda: K.cdf_walk(smp.nbr, smp.cdf, starts, u, 40), 50)
        out[f"k2_{tag}_ms"] = graph_ms(
            lambda: K.membership_dists(smp.nbr, smp.deg, starts, paths), 50)
        if hasattr(K, "walk_dists"):
            out[f"walk_dists_{tag}_ms"] = graph_ms(
                lambda: K.walk_dists(smp.nbr, smp.cdf, smp.deg, smp.srt, starts, u, 40), 50)


def bf16_times(K, X, y, z, ps, spec, idx, order, paths, dists, m1, gout, gen, C, out):
    """The bgp request's, microbatch's and epoch's times at bf16 compute,
    where the checkout's model takes ``compute_dtype="bfloat16"``."""
    import torch
    from pathnet_tpu_torch.config import TrainConfig
    from pathnet_tpu_torch.data.splits import get_whole_mask
    from pathnet_tpu_torch.models import PathNet
    from pathnet_tpu_torch.train import predict, run_round

    spec = dataclasses.replace(spec, compute_dtype="bfloat16")
    try:
        model = PathNet(spec, device=X.device, generator=torch.Generator().manual_seed(0))
    except NotImplementedError:
        return
    h, w = model.encode_inputs(X)
    encode_times(K, "bgp_bf16", h, paths, dists, w, (), out)
    out["k4_bgp_bf16_ms"] = graph_ms(
        lambda: K.pagg_encode_bwd(gout, h, paths, dists, *w, m1, 0.3), 5)
    k4_stage_times(K, "bgp_bf16", gout, h, paths, dists, w, (m1, 0.3), out)
    times = []
    for r in np.resize(order, 9 * 8192).reshape(9, 8192):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predict(model, X, ps, gen, idx=r)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out["request_bf16_ms"] = float(np.median(times[1:]))
    res = run_round(X, y, ps, spec, TrainConfig(epochs=3, microbatch=8192),
                    *get_whole_mask(z["y"], seed=1), C, seed=0, track_history=True)
    out["bgp_bf16_epoch_ms"] = float(np.median(res.epoch_seconds[1:])) * 1e3


def measure(root: str) -> dict:
    """Every time of the module docstring, for the port under ``root``."""
    sys.path.insert(0, root)
    import torch
    from pathnet_tpu_torch import kernels as K
    from pathnet_tpu_torch.config import TrainConfig
    from pathnet_tpu_torch.data import Graph
    from pathnet_tpu_torch.data.splits import get_whole_mask
    from pathnet_tpu_torch.models import PaggSpec, PathNet, draw_dropout_masks
    from pathnet_tpu_torch.sample import PathSampler
    from pathnet_tpu_torch.sample.walk import draw_uniforms
    from pathnet_tpu_torch.train import predict, run_round

    if not torch.cuda.is_available():
        raise SystemExit("bench_encode: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    out = {"root": root, "device": smi()}
    from pathnet_tpu_torch.kernels import build
    build.library()
    gen = torch.Generator(device=dev).manual_seed(0)
    z = np.load(os.path.join(HERE, "data", "bench_cache", "bgp_standin_63977.npz"))
    g = Graph(n=int(z["n"]), src=z["src"], dst=z["dst"], prob=z["prob"])
    X = torch.from_numpy(z["x"]).to(dev)
    C = int(z["y"].max()) + 1
    ps = PathSampler.build(g, 40, 4, device=dev)
    spec = PaggSpec(feat_dim=X.shape[1], hidden=64, out_dim=C, walk_len=4, dropout=0.7)
    model = PathNet(spec, device=dev, generator=torch.Generator().manual_seed(0))
    order = np.random.default_rng(0).permutation(g.n)
    idx = torch.from_numpy(order[:8192].astype(np.int32)).to(dev)
    paths, dists = ps.sample(idx, u=draw_uniforms(4, 8192 * 40, gen, dev))
    h, w = model.encode_inputs(X)
    encode_times(K, "bgp", h, paths, dists, w, (), out)
    out["k5_bgp_ms"] = graph_ms(lambda: K.row_gather(h, idx), 50)
    out["k5_bgp_call_ms"] = time_ms(lambda: K.row_gather(h, idx), 50)
    out["k5_bgp_kernels_us"] = kernel_us(lambda: K.row_gather(h, idx))
    m1, _ = draw_dropout_masks(spec, 8192, 40, gen, dev)
    gout = torch.randn((8192, 64), generator=gen, device=dev)
    out["k4_bgp_ms"] = graph_ms(lambda: K.pagg_encode_bwd(gout, h, paths, dists, *w, m1, 0.3),
                                5)
    k4_stage_times(K, "bgp", gout, h, paths, dists, w, (m1, 0.3), out)
    mlp_times(K, X, C, paths, dists, m1, gout, out)
    mean_times(K, gout, h, paths, dists, w, (m1, 0.3), out)
    width_times(K, X, C, paths, dists, gen, out)

    times = []
    for r in np.resize(order, 9 * 8192).reshape(9, 8192):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predict(model, X, ps, gen, idx=r)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out["request_ms"] = float(np.median(times[1:]))

    y = torch.from_numpy(z["y"].astype(np.int64)).to(dev)
    res = run_round(X, y, ps, spec, TrainConfig(epochs=3, microbatch=8192),
                    *get_whole_mask(z["y"], seed=1), C, seed=0, track_history=True)
    out["bgp_epoch_ms"] = float(np.median(res.epoch_seconds[1:])) * 1e3
    bf16_times(K, X, y, z, ps, spec, idx, order, paths, dists, m1, gout, gen, C, out)

    (gn, train, val, test, sd), cornell = datasets("Nba", "cornell")
    psn = PathSampler.build(gn, 40, 4, device=dev)
    Xn = torch.from_numpy(np.array(gn.features, np.float32)).to(dev)
    specn = PaggSpec(feat_dim=Xn.shape[1], hidden=256, out_dim=sd.num_classes, walk_len=4,
                     dropout=0.7)
    mn = PathNet(specn, device=dev, generator=torch.Generator().manual_seed(3))
    it = torch.from_numpy(np.flatnonzero(train).astype(np.int32)).to(dev)
    pn, dn = psn.sample(it, u=draw_uniforms(4, it.shape[0] * 40, gen, dev))
    hn_, wn = mn.encode_inputs(Xn)
    mn1, _ = draw_dropout_masks(specn, it.shape[0], 40, gen, dev)
    encode_times(K, "nba_masked", hn_, pn, dn, wn, (mn1, 0.3), out)
    gn_out = torch.randn((it.shape[0], 256), generator=gen, device=dev)
    out["k4_nba_ms"] = graph_ms(
        lambda: K.pagg_encode_bwd(gn_out, hn_, pn, dn, *wn, mn1, 0.3), 10)
    k4_stage_times(K, "nba", gn_out, hn_, pn, dn, wn, (mn1, 0.3), out)
    yn = torch.from_numpy(np.array(gn.labels, np.int64)).to(dev)
    res = run_round(Xn, yn, psn, specn, TrainConfig(epochs=20), train, val, test,
                    sd.num_classes, seed=0, track_history=True)
    out["nba_epoch_ms"] = float(np.median(res.epoch_seconds[1:])) * 1e3

    out["cornell_epoch_ms"], psc = cornell_epoch(cornell, dev)

    def every_node(p):
        return torch.arange(p.sampler.n, dtype=torch.int32, device=dev)

    walk_times(K, {"bgp_request": (ps, idx), "bgp_epoch": (ps, every_node(ps)),
                   "cornell": (psc, every_node(psc)), "nba": (psn, every_node(psn))},
               gen, out)
    return out


def datasets(*names):
    """``load_dataset(name, root, 0)`` of each of ``names``, from a temporary
    data root that holds a copy of their ``data/edge_input`` files."""
    from pathnet_tpu_torch.data.registry import load_dataset
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(os.path.join(tmp, "edge_input"))
        for name in names:
            for f in glob.glob(os.path.join(HERE, "data", "edge_input", f"{name}*.in")):
                shutil.copy(f, os.path.join(tmp, "edge_input"))
        return [load_dataset(name, tmp, 0) for name in names]


def cornell_epoch(cornell, dev):
    """Median host ms of the epochs after the first of a 100-epoch cornell
    round (H = 64, full batch as in its protocol), and its sampler;
    ``cornell`` is ``load_dataset``'s result."""
    import torch
    from pathnet_tpu_torch.config import TrainConfig
    from pathnet_tpu_torch.models import PaggSpec
    from pathnet_tpu_torch.sample import PathSampler
    from pathnet_tpu_torch.train import run_round

    g, train, val, test, sd = cornell
    ps = PathSampler.build(g, 40, 4, device=dev)
    X = torch.from_numpy(np.array(g.features, np.float32)).to(dev)
    y = torch.from_numpy(np.array(g.labels, np.int64)).to(dev)
    spec = PaggSpec(feat_dim=X.shape[1], hidden=64, out_dim=sd.num_classes, walk_len=4,
                    dropout=0.7)
    res = run_round(X, y, ps, spec, TrainConfig(epochs=100), train, val, test,
                    sd.num_classes, seed=0, track_history=True)
    return float(np.median(res.epoch_seconds[1:])) * 1e3, ps


def profile_bgp_epochs(root: str) -> None:
    """``torch.profiler`` over two bgp stand-in epochs (microbatch 8192)
    after one warm round; prints the epochs' host ms and the 25 ops with the
    most device time."""
    sys.path.insert(0, root)
    import torch
    from torch.profiler import ProfilerActivity, profile
    from pathnet_tpu_torch.config import TrainConfig
    from pathnet_tpu_torch.data import Graph
    from pathnet_tpu_torch.data.splits import get_whole_mask
    from pathnet_tpu_torch.models import PaggSpec
    from pathnet_tpu_torch.sample import PathSampler
    from pathnet_tpu_torch.train import run_round

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    z = np.load(os.path.join(HERE, "data", "bench_cache", "bgp_standin_63977.npz"))
    g = Graph(n=int(z["n"]), src=z["src"], dst=z["dst"], prob=z["prob"])
    X = torch.from_numpy(z["x"]).to(dev)
    y = torch.from_numpy(z["y"].astype(np.int64)).to(dev)
    C = int(z["y"].max()) + 1
    ps = PathSampler.build(g, 40, 4, device=dev)
    spec = PaggSpec(feat_dim=X.shape[1], hidden=64, out_dim=C, walk_len=4, dropout=0.7)
    args = (X, y, ps, spec, TrainConfig(epochs=2, microbatch=8192),
            *get_whole_mask(z["y"], seed=1), C)
    run_round(*args, seed=0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = run_round(*args, seed=0, track_history=True)
        torch.cuda.synchronize()
    print(f"{root} ({smi()}): profiled bgp epochs ms "
          f"{[round(t * 1e3, 3) for t in res.epoch_seconds]}")
    print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=25,
                                    max_name_column_width=70))


# pagg_contract's variants: the kernel as committed (checked against the
# plain version), then copies that leave one part out (their sums are wrong
# on purpose) to show where its time goes; each a set of text substitutions.
# (Its tile constants were swept once; PERF.md §6 has the times.)
_WGMMA3 = """              wgmma<NU>(fresh, alo[jj], desc_sw128(hi_plane + off), j > 0);
              wgmma<NU>(fresh, ahi[jj], desc_sw128(lo_plane + off), 1);
              wgmma<NU>(fresh, ahi[jj], desc_sw128(hi_plane + off), 1);"""
CONTRACT_VARIANTS = {
    "as committed": {},
    "no TMA copies": {"mbar_expect_tx(full, copied * BOX_BYTES);": "mbar_expect_tx(full, 0);",
                      "            if (bst[i] >= 0)\n              tma_load(":
                      "            if (0)\n              tma_load("},
    "no hi/lo transposing pass": {"it < (kpad / 4) << tb_log;": "it < 0;"},
    "no products": {_WGMMA3: ""},
    "no class sort (each class over every row)": {
        "  return Cfg::SORT && G.classes > 0;": "  return false;"},
    "no distance reads (classes from the row)": {
        "d = L.dists[b * L.wl + (L.homo ? t : L.wl - 1 - t)];": "d = (int)(b % L.wl);"},
    "no dwd job": {"Group d = make_group(1, 0, -1, R, H, H,": "Group d = make_group(1, 0, -1, 0, H, H,"},
}

# pagg_contract's shapes for --contract: (targets, nw, wl, H, cell, homo),
# seeded normal streams and distances; the bgp microbatch, Nba's 193 train
# targets at H = 256, H = 32 (Electronics' width), cora's 2,708 targets
# (homo) and cornell's 183
CONTRACT_SHAPES = {"bgp": (8192, 40, 4, 64, "lstm", False),
                   "bgp_mlp": (8192, 40, 4, 64, "mlp", False),
                   "nba": (193, 40, 4, 256, "lstm", False),
                   "bgp_h32": (8192, 40, 4, 32, "lstm", False),
                   "cora_homo": (2708, 40, 4, 64, "lstm", True),
                   "cornell": (183, 40, 4, 64, "lstm", False)}


def contract_streams(shape, dev, gen):
    """``contractions``' arguments at ``shape``, seeded normals and distances
    in ``[-1, wl]`` (some clipped)."""
    import torch
    T, nw, wl, H, cell, homo = shape
    B = T * nw
    r = lambda *s: torch.randn(s, generator=gen, device=dev)
    dists = torch.randint(-1, wl + 1, (T, nw, wl), generator=gen, device=dev,
                          dtype=torch.int32)
    mlp = cell == "mlp"
    return (r(wl, B, H), r(wl, B, H), r(B, H) if mlp else r(wl, B, H), r(wl, B, H),
            r(B, H) if mlp else r(wl, B, 4 * H), dists, homo, cell)


def contract_only(build, text=None) -> str:
    """Point ``build`` at a temporary directory that holds ``errors.cu`` and
    ``pagg_contract.cu`` (``text`` in its place, if given) alone, bind only
    the contraction's entries, build; returns nvcc's report."""
    import pathlib
    csrc = pathlib.Path(build.__file__).resolve().parents[1] / "csrc"
    d = pathlib.Path(tempfile.mkdtemp())
    shutil.copy(csrc / "errors.cu", d)
    (d / "pagg_contract.cu").write_text(text if text is not None else
                                        (csrc / "pagg_contract.cu").read_text())
    build.SIGNATURES = {k: v for k, v in build.SIGNATURES.items() if "contract" in k}
    build.CSRC, build._lib = d, None
    try:
        shutil.rmtree(build.library_path().parent, ignore_errors=True)   # a report each time
        report = build.build()[1]
        build.library()   # loaded while its sources are there
        return report
    finally:
        shutil.rmtree(d, ignore_errors=True)


def offset_streams(args):
    """``args``' float streams as views that start 4 bytes past a 16-byte
    boundary (no tensor map describes them), with equal values."""
    out = []
    for t in args:
        if hasattr(t, "is_floating_point") and t.is_floating_point():
            buf = t.new_zeros(t.numel() + 1)
            buf[1:] = t.reshape(-1)
            t = buf[1:].view(t.shape)
        out.append(t)
    return out


def contract_times(root: str) -> dict:
    """``pagg_contract`` of ``root``'s checkout at each of ``CONTRACT_SHAPES``,
    per launch in a CUDA graph, beside its plain version
    (``contractions_plain``) and its bound (``chip_smoke.contract_bounds``:
    bytes at 3.35 TB/s or 3 x the flops at TF32's 495 TFLOP/s); at the bgp
    microbatch and Nba also on streams 4 bytes off a 16-byte boundary
    (``{tag}_offset_ms``: the 4-byte copies, where the checkout has two
    stagings), at the bgp microbatch cuBLAS's full-f32 dense products ``xin^T
    dg`` and ``hp^T dg`` alone (context: no one call computes the function),
    at cornell the eager call's host time (``cornell_call_host_us``, 200
    calls queued) and its time with the device's (``cornell_call_us``).
    First, with every kernel built, three 100-epoch cornell rounds
    (``cornell_epoch_ms``, :func:`cornell_epoch`); then the contraction's
    kernel is built alone."""
    sys.path.insert(0, root)
    import torch
    from chip_smoke import contract_bounds
    from pathnet_tpu_torch import kernels as K
    from pathnet_tpu_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    out = {"root": root, "device": smi()}
    cornell = datasets("cornell")[0]
    out["cornell_epoch_ms"] = [cornell_epoch(cornell, dev)[0] for _ in range(3)]
    contract_only(build)
    for tag, shape in CONTRACT_SHAPES.items():
        a = contract_streams(shape, dev, torch.Generator(device=dev).manual_seed(0))
        nbytes, ops = contract_bounds(*a)
        out[f"{tag}_ms"] = graph_ms(lambda: K.contractions(*a), 10)
        out[f"{tag}_plain_ms"] = graph_ms(lambda: K.contractions_plain(*a), 5)
        out[f"{tag}_bound_ms"] = max(nbytes / 3.35e12, ops / 495e12) * 1e3
        if tag in ("bgp", "nba"):
            moved = offset_streams(a)
            out[f"{tag}_offset_ms"] = graph_ms(lambda: K.contractions(*moved), 10)
            del moved
        if tag == "cornell":
            for _ in range(20):
                K.contractions(*a)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                K.contractions(*a)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            out["cornell_call_host_us"] = (t1 - t0) / 200 * 1e6
            out["cornell_call_us"] = (time.perf_counter() - t0) / 200 * 1e6
        if tag == "bgp":
            H = shape[3]
            x, hp, dg = a[1].view(-1, H), a[2].view(-1, H), a[4].view(-1, 4 * H)
            out["bgp_cublas_dense_ms"] = graph_ms(lambda: (x.t() @ dg, hp.t() @ dg), 5)
        del a
        torch.cuda.empty_cache()
    return out


def contract_variants(root: str) -> dict:
    """``pagg_contract`` at the bgp microbatch (LSTM and MLP streams of seeded
    normals) per launch in a CUDA graph, for each of ``CONTRACT_VARIANTS``:
    ``csrc/pagg_contract.cu`` with its text replaced, built alone with
    ``errors.cu``; each instance's registers and spill bytes from ``ptxas``;
    the kernel as committed also its error against the plain version in
    float64 over each gradient's largest entry."""
    sys.path.insert(0, root)
    import torch
    from pathnet_tpu_torch import kernels as K
    from pathnet_tpu_torch.kernels import build

    dev = torch.device("cuda")
    cases = {c: contract_streams(CONTRACT_SHAPES[c], dev,
                                 torch.Generator(device=dev).manual_seed(0))
             for c in ("bgp", "bgp_mlp")}
    want = {c: K.contractions_plain(*(t.double() if isinstance(t, torch.Tensor)
                                      and t.is_floating_point() else t for t in a))
            for c, a in cases.items()}
    src = (build.CSRC / "pagg_contract.cu").read_text()
    texts = {}   # every variant's source, checked before any is built
    for name, subs in CONTRACT_VARIANTS.items():
        text = src
        for key, val in subs.items():
            if text.count(key) != 1:
                raise SystemExit(f"bench_encode: {name}: {key!r} found {text.count(key)} times")
            text = text.replace(key, val)
        texts[name] = text
    out = {"device": smi()}
    for name, subs in CONTRACT_VARIANTS.items():
        # {instance: [registers, spill store bytes, spill load bytes]}
        row = {"regs": {k: list(v) for k, v in kernel_regs(contract_only(build, texts[name])).items()
                        if k.startswith("contract_kernel")}}
        for cell, a in cases.items():
            row[f"{cell}_ms"] = graph_ms(lambda: K.contractions(*a), 10)
            if not subs:
                got = K.contractions(*a)
                row[f"{cell}_err"] = max(
                    float((x.double() - y).abs().max()) / float(y.abs().max())
                    for x, y in zip(got, want[cell]) if y.numel())
        out[name] = row
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ab", metavar="OTHER", help="root of the checkout to compare with")
    ap.add_argument("--profile", action="store_true",
                    help="profile two bgp epochs instead (with --ab: OTHER, then this)")
    ap.add_argument("--regs", metavar="OTHER",
                    help="registers and spills of OTHER's kernels and this checkout's")
    ap.add_argument("--contract", action="store_true",
                    help="pagg_contract's variants (CONTRACT_VARIANTS) instead; with --ab, "
                         "first OTHER's and this kernel's times in turns")
    ap.add_argument("--root", help=argparse.SUPPRESS)   # a turn's checkout
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root or HERE)
    if args.contract and args.root is not None:   # one turn of --contract --ab
        print(json.dumps(contract_times(root)), flush=True)
        return 0
    if args.contract and args.ab is not None:
        other = os.path.abspath(args.ab)
        for root in (other, HERE, HERE, other):
            r = subprocess.run([sys.executable, os.path.abspath(__file__), "--contract",
                                "--root", root], cwd=root, timeout=900)
            if r.returncode != 0:
                return r.returncode
    if args.contract:
        print(json.dumps(contract_variants(HERE)), flush=True)
        return 0
    if args.regs is not None:
        compare_regs(os.path.abspath(args.regs))
        return 0
    if args.profile and args.ab is None:
        profile_bgp_epochs(root)
        return 0
    if args.ab is None:
        print(json.dumps(measure(root)), flush=True)
        return 0
    if args.profile:
        for root in (os.path.abspath(args.ab), HERE):
            r = subprocess.run([sys.executable, os.path.abspath(__file__), "--profile",
                                "--root", root], cwd=root, timeout=900)
            if r.returncode != 0:
                return r.returncode
        return 0
    other = os.path.abspath(args.ab)
    for root in (other, HERE, HERE, other):
        # each turn in a process of its own, so each imports its own package
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--root", root],
                           cwd=root, timeout=900)
        if r.returncode != 0:
            return r.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
