"""The kernel wrappers: CPU dispatch, input checks, the build, and (on a card)
each CUDA kernel against its plain version.

Tests marked ``gpu`` need a CUDA card; the ``cuda`` fixture skips them where
there is none. This file imports no JAX, so it also runs where JAX is absent:
``python -m pytest tests/test_torch_port_kernels.py -m gpu --noconftest`` (the
suite's conftest imports JAX).
"""
import ast
import os
import re
import shutil

import numpy as np
import pytest
import torch

from pathnet_tpu_torch import kernels as K
from pathnet_tpu_torch.data import Graph
from pathnet_tpu_torch.kernels import build
from pathnet_tpu_torch.models import PaggSpec, PathNet
from pathnet_tpu_torch.sample import KhopTables, PathSampler, build_khop_tables
from pathnet_tpu_torch.train import predict

ROOT = os.path.join(os.path.dirname(__file__), "..")
EDGE = os.path.join(ROOT, "data", "edge_input")
PORT = os.path.join(ROOT, "pathnet_tpu_torch")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def case(name="cornell", nw=6, wl=4, H=16, S=None, seed=0, device="cpu"):
    """Tables, starts, draws, walks, dists and K3 weights for one request."""
    g = Graph.from_edge_input(os.path.join(EDGE, f"{name}.in"))
    ps = PathSampler.build(g, nw, wl, device=device)
    gen = torch.Generator().manual_seed(seed)
    S = g.n if S is None else S
    starts = torch.randperm(g.n, generator=gen)[:S].to(torch.int32).to(device)
    u = torch.rand((wl - 1, S * nw), generator=gen).to(device)
    paths = K.cdf_walk_plain(ps.sampler.nbr, ps.sampler.cdf, starts, u, nw)
    dists = K.membership_dists_plain(ps.sampler.nbr, ps.sampler.deg, starts, paths)
    h = (torch.randn((g.n, H), generator=gen) * 0.5).to(device)
    b = 1.0 / H ** 0.5
    rnd = lambda *s: ((torch.rand(s, generator=gen) * 2 - 1) * b).to(device)
    w = (rnd(wl, H, H), rnd(wl, H), rnd(H, 4 * H), rnd(H, 4 * H), rnd(4 * H),
         rnd(4 * H), rnd(2 * H), rnd(1))
    return ps, starts, u, paths, dists, h, w


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    ps, starts, u, paths, dists, h, w = case()
    K.reset_launch_counts()
    smp = ps.sampler
    assert torch.equal(K.cdf_walk(smp.nbr, smp.cdf, starts, u, 6), paths)
    assert torch.equal(K.membership_dists(smp.nbr, smp.deg, starts, paths), dists)
    got = K.walk_dists(smp.nbr, smp.cdf, smp.deg, smp.srt, starts, u, 6)
    assert torch.equal(got[0], paths) and torch.equal(got[1], dists)
    # f32 products on the host may round differently with buffer alignment
    torch.testing.assert_close(K.pagg_encode_fwd(h, paths, dists, *w),
                               K.pagg_encode_fwd_plain(h, paths, dists, *w),
                               atol=1e-6, rtol=1e-6)
    assert K.launch_counts() == {"cdf_walk": 0, "membership_dists": 0,
                                 "pagg_encode_fwd": 0, "pagg_encode_bwd": 0,
                                 "row_gather": 0, "row_gather_bwd": 0,
                                 "lane_gather": 0, "segment_sum": 0, "walk_dists": 0,
                                 "khop_dists": 0, "walk_khop_dists": 0, "alias_walk": 0,
                                 "alias_walk_dists": 0, "alias_walk_khop_dists": 0,
                                 "spmm": 0, "edge_dot": 0, "segment_softmax": 0,
                                 "segment_softmax_bwd": 0, "pagg_contract": 0}


def test_wrappers_reject_bad_inputs():
    ps, starts, u, paths, dists, h, w = case()
    smp = ps.sampler
    with pytest.raises(TypeError):
        K.cdf_walk(smp.nbr.long(), smp.cdf, starts, u, 6)
    with pytest.raises(ValueError):
        K.cdf_walk(smp.nbr, smp.cdf, starts, u[:, :-1], 6)
    with pytest.raises(ValueError):
        K.membership_dists(smp.nbr, smp.deg, starts, paths.transpose(0, 1))
    with pytest.raises(ValueError, match="walk_len"):
        K.membership_dists(smp.nbr, smp.deg, starts,
                           torch.cat([paths, paths[:, :, :1]], dim=2))
    with pytest.raises(ValueError, match="walk_len"):
        K.walk_dists(smp.nbr, smp.cdf, smp.deg, smp.srt, starts,
                     torch.cat([u, u[:1]]), 6)
    with pytest.raises(ValueError):
        K.walk_dists(smp.nbr, smp.cdf, smp.deg, smp.srt[:, :-1].contiguous(), starts, u, 6)
    with pytest.raises(TypeError):
        K.walk_dists(smp.nbr, smp.cdf, smp.deg.long(), smp.srt, starts, u, 6)
    with pytest.raises(ValueError, match="unsupported device"):
        K.walk_dists(*(t.to("meta") for t in (smp.nbr, smp.cdf, smp.deg, smp.srt, starts,
                                              u)), 6)
    with pytest.raises(TypeError):
        K.pagg_encode_fwd(h.double(), paths, dists, *w)
    with pytest.raises(ValueError):
        K.pagg_encode_fwd(h, paths, dists, w[0][:, :, :-1], *w[1:])
    with pytest.raises(ValueError, match="contiguous"):
        K.pagg_encode_fwd(h.t().contiguous().t(), paths, dists, *w)


def test_every_c_entry_point_is_defined_in_a_source():
    text = "".join(p.read_text() for p in build.sources())
    for name in list(build.SIGNATURES) + ["pathnet_error_string"]:
        assert re.search(rf'extern "C" \w[\w\s\*]* {name}\(', text), name


def test_build_without_nvcc_raises_and_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(build, "find_nvcc", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()
    assert not (tmp_path / "build").exists()


def test_source_hash_follows_the_sources(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = build.source_hash()
    assert before == build.source_hash()
    src = build.sources()[0]
    src.write_text(src.read_text() + "\n// changed\n")
    assert build.source_hash() != before


def test_source_hash_follows_the_headers(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = build.source_hash()
    headers = sorted(csrc.glob("*.cuh"))
    assert headers, "the encode kernels share a header"
    headers[0].write_text(headers[0].read_text() + "\n// changed\n")
    assert build.source_hash() != before


def test_port_holds_no_jax_no_library_kernels_and_no_cpu_fallback():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PORT):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    for f in files:
        text = open(f).read()
        for node in ast.walk(ast.parse(text)):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for m in mods:
                assert m.split(".")[0] not in ("jax", "pathnet_tpu"), (f, m)
        for banned in ("cpp_extension", "torch.compile(", "scaled_dot_product_attention",
                       "nn.functional.lstm", "self.LSTM("):
            assert banned not in text, (f, banned)
    for name in ("cdf_walk", "membership_dists", "pagg_encode", "pagg_encode_bwd",
                 "row_gather", "lane_gather", "segment_sum", "walk_dists", "khop_dists",
                 "alias_walk"):
        # a wrapper launches its kernel or raises: nothing catches a failure
        text = open(os.path.join(PORT, "kernels", name + ".py")).read()
        assert not re.search(r"\b(try|except)\b", text), name


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["cornell", "Nba"])
def test_walk_and_distance_kernels_equal_plain(cuda, name):
    ps, starts, u, paths, dists, h, w = case(name, nw=40, device=cuda)
    smp = ps.sampler
    got = K.cdf_walk(smp.nbr, smp.cdf, starts, u, 40)
    assert torch.equal(got, paths)
    assert torch.equal(K.membership_dists(smp.nbr, smp.deg, starts, got), dists)
    fused = K.walk_dists(smp.nbr, smp.cdf, smp.deg, smp.srt, starts, u, 40)
    assert torch.equal(fused[0], paths) and torch.equal(fused[1], dists)


def walk_graph(D, n=300, seed=0):
    """A graph of ``n`` nodes whose widest row has ``D`` records, one node of
    degree 0 (node 1), random transition probabilities and repeated
    records."""
    rng = np.random.default_rng(seed + D)
    deg = rng.integers(1, D + 1, size=n)
    deg[0], deg[1] = D, 0
    src = np.repeat(np.arange(n), deg).astype(np.int32)
    dst = rng.integers(0, n, size=len(src)).astype(np.int32)
    return Graph(n=n, src=src, dst=dst, prob=rng.random(len(src)) + 0.05)


# the fused launch against the plain walk and distances on widths 1 and bgp's
# 25 (a lane a walk), cornell's 190 and Nba's 442 (16 lanes) and 600 (32),
# with a node of degree 0 among the starts, a NaN row and a row that sums to
# 0.6
@pytest.mark.gpu
@pytest.mark.parametrize("D", [1, 25, 190, 442, 600])
@pytest.mark.parametrize("nw", [1, 40])
@pytest.mark.parametrize("wl", [1, 2, 3, 4])
def test_fused_walk_and_distance_kernel_equals_plain(cuda, D, nw, wl):
    ps = PathSampler.build(walk_graph(D), nw, wl, device=cuda)
    smp = ps.sampler
    assert smp.max_deg == D and int(smp.deg[1]) == 0
    cdf = smp.cdf.clone()
    cdf[2] = float("nan")
    cdf[3] = cdf[3] * 0.6
    gen = torch.Generator().manual_seed(D * 10 + wl)
    starts = torch.randperm(smp.n, generator=gen)[:257].to(torch.int32)
    starts[:4] = torch.arange(4)
    starts = starts.to(cuda)
    u = torch.rand((wl - 1, starts.shape[0] * nw), generator=gen).to(cuda)
    want = K.walk_dists_plain(smp.nbr, cdf, smp.deg, smp.srt, starts, u, nw)
    got = K.walk_dists(smp.nbr, cdf, smp.deg, smp.srt, starts, u, nw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(K.cdf_walk(smp.nbr, cdf, starts, u, nw), want[0])
    assert torch.equal(K.membership_dists(smp.nbr, smp.deg, starts, want[0]), want[1])


# K7, fused with the walk and alone, against the plain walk and the plain
# k-hop distances on the same widths, at every walk length to 6 (the levels
# 1..5 of the graph's k-hop tables), with the same degree-0, NaN and short
# rows among the starts. (These graphs' records are not symmetric, so K2's
# N2 test, which assumes they are, may differ from the k-hop levels here.)
@pytest.mark.gpu
@pytest.mark.parametrize("D", [1, 25, 190, 442, 600])
@pytest.mark.parametrize("nw", [1, 40])
@pytest.mark.parametrize("wl", [1, 2, 4, 5, 6])
def test_khop_kernels_equal_plain(cuda, D, nw, wl):
    g = walk_graph(D)
    ps = PathSampler.build(g, nw, 4, device=cuda)
    smp = ps.sampler
    tables = KhopTables.pack(build_khop_tables(g, 5, device=cuda))
    cdf = smp.cdf.clone()
    cdf[2] = float("nan")
    cdf[3] = cdf[3] * 0.6
    gen = torch.Generator().manual_seed(D * 10 + wl)
    starts = torch.randperm(smp.n, generator=gen)[:257].to(torch.int32)
    starts[:4] = torch.arange(4)
    starts = starts.to(cuda)
    u = torch.rand((wl - 1, starts.shape[0] * nw), generator=gen).to(cuda)
    want = K.walk_khop_dists_plain(smp.nbr, cdf, tables, starts, u, nw)
    got = K.walk_khop_dists(smp.nbr, cdf, tables, starts, u, nw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(K.khop_dists(tables, starts, want[0]), want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["cornell", "Nba"])
def test_khop_sampler_on_the_card_equals_the_host(cuda, name):
    """``PathSampler.sample`` at wl = 5 (one fused K7 launch) and the dense
    and host tables' lookups on the card: the host sampler's walks and
    distances for the same draws."""
    g = Graph.from_edge_input(os.path.join(EDGE, f"{name}.in"))
    u = torch.rand((4, g.n * 40), generator=torch.Generator().manual_seed(1))
    want = PathSampler.build(g, 40, 5, device="cpu").sample(u=u)
    for backend in ("khop", "dense", "host"):
        ps = PathSampler.build(g, 40, 5, distance_backend=backend, device=cuda)
        K.reset_launch_counts()
        got = ps.sample(u=u.to(cuda))
        torch.cuda.synchronize()
        counts = K.launch_counts()
        assert counts["walk_khop_dists" if backend == "khop" else "cdf_walk"] == 1
        assert sum(counts.values()) == 1
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


def uniform_graph(D, n=300, seed=0):
    """A graph whose symmetrized table (one self-loop a node) is ``D`` wide:
    node 0 sends ``D - 1`` records (repeats among them) to other nodes, a few
    hundred records join the rest, node 1 has none."""
    rng = np.random.default_rng(seed + D)
    hub = rng.integers(2, n, size=D - 1)
    a = rng.integers(2, n, size=n if D > 1 else 0)
    b = rng.integers(2, n, size=len(a))
    src = np.concatenate([np.zeros(D - 1, np.int64), a]).astype(np.int32)
    dst = np.concatenate([hub, b]).astype(np.int32)
    return Graph(n=n, src=src, dst=dst, prob=np.ones(len(src)))


def card_draws(n, nw, wl, seed, cuda, per_step=1):
    """257 starts (nodes 0-3 among them: a ragged last block at every lane
    count) and their draws, K1's or K8's layout."""
    gen = torch.Generator().manual_seed(seed)
    starts = torch.randperm(n, generator=gen)[:257].to(torch.int32)
    starts[:4] = torch.arange(4)
    shape = (wl - 1, 257 * nw) if per_step == 1 else (wl - 1, 2, 257 * nw)
    return starts.to(cuda), torch.rand(shape, generator=gen).to(cuda)


# K8 in its three launches (the walks alone, fused with K2, fused with K7)
# against the plain versions, at table widths about each lane count's edge
# (1 and 32: a lane a walk in the fused K2 launch; 33 and 512: 16 lanes;
# 513: 32), with a node of degree 0 among the starts, every walk length to
# 5 and the k-hop levels 1..5
@pytest.mark.gpu
@pytest.mark.parametrize("D", [1, 32, 33, 512, 513])
@pytest.mark.parametrize("nw", [1, 40])
@pytest.mark.parametrize("wl", [1, 2, 4, 5])
def test_alias_kernels_equal_plain(cuda, D, nw, wl):
    g = walk_graph(D)
    smp = PathSampler.build(g, nw, 4, sampler="alias", device=cuda).sampler
    assert smp.max_deg == D and int(smp.deg[1]) == 0
    tables = KhopTables.pack(build_khop_tables(g, 5, device=cuda))
    starts, u = card_draws(g.n, nw, wl, D * 10 + wl, cuda, per_step=2)
    al = (smp.lo, smp.hi, smp.split, smp.deg)
    want = K.alias_walk_plain(*al, starts, u, nw)
    assert torch.equal(K.alias_walk(*al, starts, u, nw), want)
    got = K.alias_walk_khop_dists(*al, tables, starts, u, nw)
    plain = K.alias_walk_khop_dists_plain(*al, tables, starts, u, nw)
    assert torch.equal(got[0], want) and torch.equal(plain[0], want)
    assert torch.equal(got[1], plain[1])
    if wl <= 4:
        got = K.alias_walk_dists(*al, smp.nbr, smp.srt, starts, u, nw)
        plain = K.alias_walk_dists_plain(*al, smp.nbr, smp.srt, starts, u, nw)
        assert torch.equal(got[0], want) and torch.equal(got[1], plain[1])


# the CDF launches on uniform tables (the symmetrized multigraph, duplicate
# records and a self-loop a node), and K8 on them, at the same widths
@pytest.mark.gpu
@pytest.mark.parametrize("D", [1, 32, 33, 512, 513])
@pytest.mark.parametrize("wl", [1, 2, 4, 5])
def test_uniform_table_kernels_equal_plain(cuda, D, wl):
    g = uniform_graph(D)
    smp = PathSampler.build(g, 40, 4, kind="uniform", device=cuda).sampler
    assert smp.max_deg == D
    sym = g.symmetrized(add_self_loops=True)
    tables = KhopTables.pack(build_khop_tables(sym, 5, device=cuda))
    starts, u = card_draws(g.n, 40, wl, D * 10 + wl, cuda)
    want = K.cdf_walk_plain(smp.nbr, smp.cdf, starts, u, 40)
    assert torch.equal(K.cdf_walk(smp.nbr, smp.cdf, starts, u, 40), want)
    got = K.walk_khop_dists(smp.nbr, smp.cdf, tables, starts, u, 40)
    assert torch.equal(got[0], want)
    assert torch.equal(got[1], K.khop_dists_plain(tables.levels, starts, want))
    if wl <= 4:
        got = K.walk_dists(smp.nbr, smp.cdf, smp.deg, smp.srt, starts, u, 40)
        plain = K.walk_dists_plain(smp.nbr, smp.cdf, smp.deg, smp.srt, starts, u, 40)
        assert torch.equal(got[0], want) and torch.equal(got[1], plain[1])
    ali = PathSampler.build(g, 40, 4, kind="uniform", sampler="alias", device=cuda).sampler
    ua = card_draws(g.n, 40, wl, D * 10 + wl, cuda, per_step=2)[1]
    al = (ali.lo, ali.hi, ali.split, ali.deg)
    assert torch.equal(K.alias_walk(*al, starts, ua, 40),
                       K.alias_walk_plain(*al, starts, ua, 40))


# the sampler with the alias tables and with uniform walks: one launch a
# call, of the backend's entry, and the host sampler's walks and distances
SAMPLER_CASES = [("merw", "alias", 4, "membership", "alias_walk_dists"),
                 ("merw", "alias", 5, "khop", "alias_walk_khop_dists"),
                 ("merw", "alias", 4, "dense", "alias_walk"),
                 ("merw", "alias", 4, "none", "alias_walk"),
                 ("uniform", "cdf", 4, "membership", "walk_dists"),
                 ("uniform", "cdf", 5, "khop", "walk_khop_dists"),
                 ("uniform", "alias", 4, "membership", "alias_walk_dists"),
                 ("uniform", "cdf", 4, "host", "cdf_walk")]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["cornell", "Nba"])
@pytest.mark.parametrize("kind,sampler,wl,backend,kernel", SAMPLER_CASES)
def test_alias_and_uniform_samplers_on_the_card_equal_the_host(cuda, name, kind, sampler, wl,
                                                               backend, kernel):
    g = Graph.from_edge_input(os.path.join(EDGE, f"{name}.in"))
    kw = dict(kind=kind, sampler=sampler, distance_backend=backend)
    host = PathSampler.build(g, 40, wl, device="cpu", **kw)
    u = host.draw_uniforms(g.n * 40, torch.Generator().manual_seed(2))
    want = host.sample(u=u)
    ps = PathSampler.build(g, 40, wl, device=cuda, **kw)
    K.reset_launch_counts()
    got = ps.sample(u=u.to(cuda))
    torch.cuda.synchronize()
    counts = K.launch_counts()
    assert counts[kernel] == 1 and sum(counts.values()) == 1
    assert torch.equal(got[0].cpu(), want[0])
    assert (got[1] is None and want[1] is None) or torch.equal(got[1].cpu(), want[1])


def wild_case(H, wl, nw, T, n=183, seed=0, device="cpu"):
    """Random walks of ``T`` targets, with distances also outside ``[0, wl -
    1]`` (the encode clips them), ``h`` and K3 weights."""
    gen = torch.Generator().manual_seed(seed)
    paths = torch.randint(0, n, (T, nw, wl), generator=gen, dtype=torch.int32)
    dists = torch.randint(-2, wl + 2, (T, nw, wl), generator=gen, dtype=torch.int32)
    h = torch.randn((n, H), generator=gen) * 0.5
    b = 1.0 / H ** 0.5
    rnd = lambda *s: (torch.rand(s, generator=gen) * 2 - 1) * b
    w = (rnd(wl, H, H), rnd(wl, H), rnd(H, 4 * H), rnd(H, 4 * H), rnd(4 * H),
         rnd(4 * H), rnd(2 * H), rnd(1))
    return (paths.to(device), dists.to(device), h.to(device),
            tuple(t.to(device) for t in w))


# The encode runs in tiles of M walks across targets (M = 64 at H = 64, 32 at
# H = 256, 16 at H = 512, 8 at H = 1024): cornell's 183 targets make a ragged
# last tile; T = 1, nw = 1, nw above M, wl of 1 and 5, widths that are not a
# multiple of 8 and distances outside [0, wl - 1] are the tile's edges.
@pytest.mark.gpu
@pytest.mark.parametrize("H,wl,nw,T,wild", [
    (16, 2, 6, None, False), (64, 4, 40, None, False), (64, 3, 17, None, False),
    (128, 4, 40, None, False),
    (64, 4, 200, None, False),   # 200 walks: over 48 KB of shared memory
    (64, 4, 40, 1, False), (64, 4, 1, None, False), (37, 5, 6, None, True),
    (256, 1, 40, None, True), (256, 4, 40, 7, True), (512, 4, 40, 50, True),
    (1024, 2, 3, 20, True), (1, 4, 6, None, False)])
def test_encode_kernel_matches_plain(cuda, H, wl, nw, T, wild):
    if wild:
        paths, dists, h, w = wild_case(H, wl, nw, T or 183, device=cuda)
    else:
        paths, dists, h, w = case(nw=nw, wl=wl, H=H, S=T, device=cuda)[3:]
    got = K.pagg_encode_fwd(h, paths, dists, *w)
    want = K.pagg_encode_fwd_plain(h, paths, dists, *w)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    # each of the two launches against its plain version
    hn = K.encode_walks_plain(h, paths, dists, *w[:6])
    torch.testing.assert_close(K.encode_walks(h, paths, dists, *w[:6]), hn,
                               atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(K.readout(h, paths, hn, *w[6:]),
                               K.readout_plain(h, paths, hn, *w[6:]), atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_encode_kernel_takes_weights_at_any_alignment(cuda):
    # the encode copies weight rows 16 bytes at a time only where every base
    # is 16-byte aligned; a view 4 bytes into its storage takes 4-byte copies
    paths, dists, h, w = case(nw=40, wl=4, H=64, device=cuda)[3:]
    shifted = []
    for t in w[:4]:
        buf = torch.empty(t.numel() + 1, device=cuda)
        buf[1:] = t.reshape(-1)
        shifted.append(buf[1:].view(t.shape))
    assert shifted[2].data_ptr() % 16 != 0
    got = K.pagg_encode_fwd(h, paths, dists, *shifted, *w[4:])
    torch.testing.assert_close(got, K.pagg_encode_fwd_plain(h, paths, dists, *w),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_predict_on_card_counts_launches_and_matches_host(cuda):
    g = Graph.from_edge_input(os.path.join(EDGE, "cornell.in"))
    X = np.random.default_rng(0).normal(size=(g.n, 32)).astype(np.float32)
    spec = PaggSpec(feat_dim=32, hidden=64, out_dim=5, walk_len=4)
    m_card, m_host = PathNet(spec, device=cuda), PathNet(spec, device="cpu")
    u = torch.rand((3, 3, g.n * 40), generator=torch.Generator().manual_seed(0))
    K.reset_launch_counts()
    got = predict(m_card, torch.from_numpy(X).to(cuda),
                  PathSampler.build(g, 40, 4, device=cuda), num_ensemble=3,
                  u=u.to(cuda))
    torch.cuda.synchronize()
    assert K.launch_counts() == {"cdf_walk": 0, "membership_dists": 0,
                                 "pagg_encode_fwd": 3, "pagg_encode_bwd": 0,
                                 "row_gather": 3, "row_gather_bwd": 0,
                                 "lane_gather": 0, "segment_sum": 0, "walk_dists": 3,
                                 "khop_dists": 0, "walk_khop_dists": 0, "alias_walk": 0,
                                 "alias_walk_dists": 0, "alias_walk_khop_dists": 0,
                                 "spmm": 0, "edge_dot": 0, "segment_softmax": 0,
                                 "segment_softmax_bwd": 0, "pagg_contract": 0}
    want = predict(m_host, torch.from_numpy(X), PathSampler.build(g, 40, 4, device="cpu"),
                   num_ensemble=3, u=u)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
