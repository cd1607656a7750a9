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
  BPTT), ``k4_*_contract_ms``, the wrapper's weight contractions alone, and
  ``k4_*_dhsum_ms``, the segment sum of the row gradients into ``dh`` (its
  sort included), where the checkout has them;
- ``request_ms``: median host time of 8 ``predict`` calls of 8192 targets;
- ``bgp_epoch_ms``, ``nba_epoch_ms``, ``cornell_epoch_ms``: median host
  time of the epochs after the first of ``run_round`` (bgp stand-in: 3
  epochs, microbatch 8192; Nba at H = 256: 20 epochs; cornell at H = 64,
  full batch as in its protocol: 100 epochs);
- ``k1_{shape}_ms``, ``k2_{shape}_ms``, ``walk_dists_{shape}_ms``: K1
  (``cdf_walk``), K2 (``membership_dists`` on K1's walks) and, where the
  checkout has it, the fused ``walk_dists``, per launch in a CUDA graph, at
  nw = 40, wl = 4, for the shapes ``bgp_request`` (8192 starts),
  ``bgp_epoch`` (all 63,977 nodes), ``cornell`` (all 183 nodes, D = 190)
  and ``nba`` (all 403 nodes, D = 442).

Every line carries the card's ``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import argparse
import glob
import inspect
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


def k4_stage_times(K, tag, g, h, paths, dists, w, mask_args, out):
    """K4's three launches, its weight contractions and, where the checkout
    has it, the segment sum of its row gradients, each alone."""
    import torch
    if not hasattr(K, "bptt"):
        return
    n = h.shape[0]
    enc = (h, paths, dists, *w[:6], *mask_args)
    hn, xr, xin, hp, cs, gt = K.encode_walks_streams(*enc)
    out[f"k4_{tag}_recompute_ms"] = graph_ms(lambda: K.encode_walks_streams(*enc), 5)
    dhn = K.attention_bwd(g, h, paths, hn, *w[6:])[0]
    out[f"k4_{tag}_attn_ms"] = graph_ms(lambda: K.attention_bwd(g, h, paths, hn, *w[6:]), 20)
    # the node count left the BPTT's arguments when it stopped adding into dh;
    # a checkout from before that still takes it, and --ab can time one
    with_n = "n" in inspect.signature(K.bptt).parameters
    bargs = (dhn, paths, dists, w[0], w[2], w[3], cs, gt, *([n] if with_n else []),
             *mask_args)
    _, dg, dsel = K.bptt(*bargs)
    # each replay writes over gt again: the times do not depend on the values
    out[f"k4_{tag}_bptt_ms"] = graph_ms(lambda: K.bptt(*bargs), 5)
    out[f"k4_{tag}_contract_ms"] = graph_ms(
        lambda: K.contractions(xr, xin, hp, dsel, dg, dists), 5)
    if hasattr(K, "segment_sum"):
        drow = K.bptt(*bargs)[0]
        dego = K.attention_bwd(g, h, paths, hn, *w[6:])[1]
        rows = torch.cat([drow.reshape(-1, drow.shape[-1]), dego])
        nodes = K.row_nodes(paths)
        out[f"k4_{tag}_dhsum_ms"] = graph_ms(lambda: K.segment_sum(rows, nodes, n), 20)


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


def measure(root: str) -> dict:
    """Every time of the module docstring, for the port under ``root``."""
    sys.path.insert(0, root)
    import torch
    from pathnet_tpu_torch import kernels as K
    from pathnet_tpu_torch.config import TrainConfig
    from pathnet_tpu_torch.data import Graph
    from pathnet_tpu_torch.data.registry import load_dataset
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
    m1, _ = draw_dropout_masks(spec, 8192, 40, gen, dev)
    gout = torch.randn((8192, 64), generator=gen, device=dev)
    out["k4_bgp_ms"] = graph_ms(lambda: K.pagg_encode_bwd(gout, h, paths, dists, *w, m1, 0.3),
                                5)
    k4_stage_times(K, "bgp", gout, h, paths, dists, w, (m1, 0.3), out)

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

    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(os.path.join(tmp, "edge_input"))
        for f in glob.glob(os.path.join(HERE, "data", "edge_input", "Nba*.in")):
            shutil.copy(f, os.path.join(tmp, "edge_input"))
        shutil.copy(os.path.join(HERE, "data", "edge_input", "cornell.in"),
                    os.path.join(tmp, "edge_input"))
        gn, train, val, test, sd = load_dataset("Nba", tmp, 0)
        gc, trc, vac, tec, sdc = load_dataset("cornell", tmp, 0)
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

    psc = PathSampler.build(gc, 40, 4, device=dev)
    Xc = torch.from_numpy(np.array(gc.features, np.float32)).to(dev)
    yc = torch.from_numpy(np.array(gc.labels, np.int64)).to(dev)
    specc = PaggSpec(feat_dim=Xc.shape[1], hidden=64, out_dim=sdc.num_classes, walk_len=4,
                     dropout=0.7)
    res = run_round(Xc, yc, psc, specc, TrainConfig(epochs=100), trc, vac, tec,
                    sdc.num_classes, seed=0, track_history=True)
    out["cornell_epoch_ms"] = float(np.median(res.epoch_seconds[1:])) * 1e3

    def every_node(p):
        return torch.arange(p.sampler.n, dtype=torch.int32, device=dev)

    walk_times(K, {"bgp_request": (ps, idx), "bgp_epoch": (ps, every_node(ps)),
                   "cornell": (psc, every_node(psc)), "nba": (psn, every_node(psn))},
               gen, out)
    return out


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ab", metavar="OTHER", help="root of the checkout to compare with")
    ap.add_argument("--profile", action="store_true",
                    help="profile two bgp epochs instead (with --ab: OTHER, then this)")
    ap.add_argument("--root", default=HERE, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.profile and args.ab is None:
        profile_bgp_epochs(os.path.abspath(args.root))
        return 0
    if args.ab is None:
        print(json.dumps(measure(os.path.abspath(args.root))), flush=True)
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
