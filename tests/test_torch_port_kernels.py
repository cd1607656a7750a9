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
from pathnet_tpu_torch.sample import PathSampler
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
                                 "lane_gather": 0, "segment_sum": 0, "walk_dists": 0}


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
                 "row_gather", "lane_gather", "segment_sum", "walk_dists"):
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
                                 "lane_gather": 0, "segment_sum": 0, "walk_dists": 3}
    want = predict(m_host, torch.from_numpy(X), PathSampler.build(g, 40, 4, device="cpu"),
                   num_ensemble=3, u=u)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
