"""The port's host utilities against the JAX package's: the adjacency
transforms (exact, or within 1e-12 where an eigensolver's start vector
moves the last bits), homophily (exact), the edge-input and path-text
writers (byte for byte) and the path parser, the three synthetic functions
(exact: the same ``default_rng`` draws), the MERW companions of
``merw/extras.py`` (within 1e-5: the port's power iteration starts from
torch's generator, JAX's from threefry), the timers, the profiler trace and
the compilation cache."""
import json
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from pathnet_tpu.data import Graph as JGraph
from pathnet_tpu.data import formats as jformats
from pathnet_tpu.data import homophily as jhomophily
from pathnet_tpu.data import synthetic as jsynthetic
from pathnet_tpu.data import transforms as jtransforms
from pathnet_tpu.merw import extras as jextras

from pathnet_tpu_torch import data as port_data
from pathnet_tpu_torch.data import Graph, formats, homophily, synthetic, transforms
from pathnet_tpu_torch.data.validate import DataValidationError, validate_path_tensor
from pathnet_tpu_torch.kernels import build
from pathnet_tpu_torch.merw import extras
from pathnet_tpu_torch.utils import Throughput, Timer, enable_compilation_cache, trace
from pathnet_tpu_torch.utils.cache import ENV

EXTRAS_TOL = 1e-5


def port_graph(g):
    return Graph(n=g.n, src=g.src, dst=g.dst, prob=g.prob,
                 features=getattr(g, "features", None), labels=getattr(g, "labels", None))


@pytest.fixture(scope="module")
def graphs(small_graph, cornell_graph):
    """(name, port Graph, JAX Graph) for the suite's 60-node graph and
    cornell's structure."""
    return [("small", port_graph(small_graph), small_graph),
            ("cornell", port_graph(cornell_graph), cornell_graph)]


def same_sparse(a, b):
    a, b = sp.csr_matrix(a), sp.csr_matrix(b)
    a.sort_indices()
    b.sort_indices()
    return (a.shape == b.shape and a.dtype == b.dtype
            and np.array_equal(a.indptr, b.indptr) and np.array_equal(a.indices, b.indices)
            and np.array_equal(a.data, b.data))


@pytest.mark.parametrize("fn, args", [
    ("add_self_loops", ()), ("remove_self_loops", ()), ("sym_normalize", ()),
    ("rw_normalize", ()), ("laplacian", (True,)), ("laplacian", (False,)),
    ("nhood", (2,)), ("nhood", (3, False)), ("nhood_split", (3,))])
def test_transforms_equal_jax_exactly(graphs, fn, args):
    for name, g, jg in graphs:
        got = getattr(transforms, fn)(g.to_adjacency(), *args)
        want = getattr(jtransforms, fn)(jg.to_adjacency(), *args)
        if fn == "nhood_split":
            assert len(got) == len(want) == args[0]
            assert all(same_sparse(a, b) for a, b in zip(got, want)), name
        else:
            assert same_sparse(got, want), name


def test_chebyshev_polynomials_within_1e12_of_jax(graphs):
    for name, g, jg in graphs:
        got = transforms.chebyshev_polynomials(g.to_adjacency(), 3)
        want = jtransforms.chebyshev_polynomials(jg.to_adjacency(), 3)
        assert len(got) == len(want) == 4
        for a, b in zip(got, want):
            assert np.abs(a.toarray() - b.toarray()).max() <= 1e-12, name


def test_homophily_equals_jax_exactly(graphs):
    for name, g, jg in graphs:
        rng = np.random.default_rng(3)
        y = rng.integers(0, 4, size=g.n)
        y[rng.random(g.n) < 0.1] = -1          # unlabeled nodes are left out
        assert homophily.edge_homophily(g, y) == jhomophily.edge_homophily(jg, y)
        assert homophily.node_homophily(g, y) == jhomophily.node_homophily(jg, y)
        cm = homophily.compatibility_matrix(g, y, 4)
        assert np.array_equal(cm, jhomophily.compatibility_matrix(jg, y, 4)), name
    empty = Graph(n=3, src=np.array([0, 1], np.int32), dst=np.array([0, 1], np.int32),
                  prob=np.ones(2))
    assert homophily.edge_homophily(empty, np.zeros(3, np.int64)) == 0.0
    assert homophily.node_homophily(empty, np.zeros(3, np.int64)) == 0.0


def test_writers_are_byte_identical_to_jax(tmp_path, cornell_graph):
    g = cornell_graph
    prob = np.random.default_rng(0).random(len(g.src))
    formats.write_edge_input(tmp_path / "port.in", g.n, g.src, g.dst, prob)
    jformats.write_edge_input(tmp_path / "jax.in", g.n, g.src, g.dst, prob)
    assert (tmp_path / "port.in").read_bytes() == (tmp_path / "jax.in").read_bytes()
    n, src, dst, p = formats.read_edge_input(str(tmp_path / "port.in"))
    assert n == g.n and np.array_equal(src, g.src) and np.array_equal(dst, g.dst)
    assert np.array_equal(p, prob)       # repr of a float64 round-trips
    rng = np.random.default_rng(1)
    nodes = rng.integers(0, g.n, size=(2, 7, 3, 4))
    dists = rng.integers(0, 4, size=(2, 7, 3, 4))
    formats.write_path_file(tmp_path / "port.txt", nodes, dists)
    jformats.write_path_file(tmp_path / "jax.txt", nodes, dists)
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()


def test_parse_path_file_round_trips_and_equals_jax(tmp_path):
    rng = np.random.default_rng(2)
    for wl in (2, 4, 5):
        nodes = rng.integers(0, 1000, size=(9, wl))
        dists = rng.integers(0, wl, size=(9, wl))
        path = tmp_path / f"wl{wl}.txt"
        formats.write_path_file(path, nodes, dists)
        got_n, got_d = formats.parse_path_file(str(path), wl)
        assert got_n.dtype == got_d.dtype == np.int32
        assert np.array_equal(got_n, nodes) and np.array_equal(got_d, dists)
        want_n, want_d = jformats.parse_path_file(str(path), wl)
        assert np.array_equal(got_n, want_n) and np.array_equal(got_d, want_d)
        validate_path_tensor("dump", got_n, got_d, 1000, wl)
    with pytest.raises(DataValidationError, match="hop distance"):
        validate_path_tensor("dump", got_n, got_d + wl, 1000, wl)
    # blank lines and spacing take the line path and parse all the same
    (tmp_path / "loose.txt").write_text("[1, 2, 0, 1]\n\n  [3,4,0,1]  \n")
    got = formats.parse_path_file(str(tmp_path / "loose.txt"), 2)
    want = jformats.parse_path_file(str(tmp_path / "loose.txt"), 2)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert np.array_equal(got[0], [[1, 2], [3, 4]])


@pytest.mark.parametrize("text", ["[1, 2, 0, 1]\n[1, x, 0, 1]\n",
                                  "[1, 2, 0, 1]\n[1, 2, 0]\n"])
def test_malformed_path_record_raises_jax_message(tmp_path, text):
    path = tmp_path / "bad.txt"
    path.write_text(text)
    with pytest.raises(ValueError) as got:
        formats.parse_path_file(str(path), 2)
    with pytest.raises(ValueError) as want:
        jformats.parse_path_file(str(path), 2)
    assert str(got.value) == str(want.value)
    assert f"{path}:2:" in str(got.value)


def test_data_package_exports_what_jax_exports():
    import pathnet_tpu.data as jdata
    assert set(jdata.__all__) <= set(port_data.__all__)
    assert "write_path_file" in port_data.__all__


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_synthetic_functions_equal_jax_exactly(seed, small_graph):
    got = synthetic.csbm_graph(300, 5.0, 1.5, 2.0, 12, seed=seed)
    want = jsynthetic.csbm_graph(300, 5.0, 1.5, 2.0, 12, seed=seed)
    for k in ("src", "dst", "prob", "features", "labels"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert got.name == want.name
    g = port_graph(small_graph)
    y = synthetic.synthetic_labels(g, 3, 0.4, seed=seed)
    assert np.array_equal(y, jsynthetic.synthetic_labels(small_graph, 3, 0.4, seed=seed))
    base = synthetic.synthetic_graph(n=120, avg_deg=4, num_classes=2, feat_dim=8,
                                     homophily=0.5, seed=seed)
    jbase = JGraph(n=base.n, src=base.src, dst=base.dst, prob=base.prob)
    for wl in (2, 3):
        lab = synthetic.path_pattern_labels(base, walk_len=wl)
        assert lab.dtype == np.int64
        assert np.array_equal(lab, jsynthetic.path_pattern_labels(jbase, walk_len=wl))


def close(got, want, tol=EXTRAS_TOL):
    got = got.cpu().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    return float(np.abs(got - want).max()) <= tol


def test_merw_extras_within_1e5_of_jax(graphs):
    for name, g, jg in graphs:
        p, pi = extras.compute_grw(g, device="cpu")
        jp, jpi = jextras.compute_grw(jg)
        assert close(p, jp) and close(pi, jpi), name
        assert close(extras.p_distance(p), jextras.p_distance(jp)), name
        assert close(extras.basic_simrank(g, device="cpu"), jextras.basic_simrank(jg)), name
        s = extras.merw_simrank(g, alpha=0.6, iters=10, device="cpu")
        assert close(s, jextras.merw_simrank(jg, alpha=0.6, iters=10)), name
        assert torch.equal(torch.diagonal(s), torch.ones(g.n))


def test_merw_extras_take_a_device_and_a_dtype(cornell_graph):
    g = port_graph(cornell_graph)
    s64 = extras.basic_simrank(g, device="cpu", dtype=torch.float64)
    s32 = extras.basic_simrank(g, device="cpu")
    assert s64.dtype == torch.float64 and s32.dtype == torch.float32
    assert float((s64 - s32.double()).abs().max()) <= 1e-6
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            extras.compute_grw(g)


def test_timer_and_throughput():
    t = Timer()
    for _ in range(3):
        with t.phase("sample"):
            pass
    with t.phase("train"):
        pass
    assert t.counts == {"sample": 3, "train": 1}
    lines = t.summary().splitlines()
    assert lines[0].startswith("sample: total") and "over 3 calls" in lines[0]
    assert lines[1].startswith("train: total")
    tp = Throughput("paths")
    tp.add(1000)
    tp.add(500)
    assert tp.items == 1500 and tp.rate() > 0
    assert tp.report().endswith(" paths/s")


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    log_dir = tmp_path / "trace"
    with trace(str(log_dir)) as d:
        assert d == str(log_dir)
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = list(log_dir.glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_enable_compilation_cache_moves_the_build_root_and_restores_it(tmp_path, monkeypatch):
    monkeypatch.delenv(ENV, raising=False)
    start = build.BUILD_ROOT
    assert start == build.DEFAULT_BUILD_ROOT
    old = enable_compilation_cache(str(tmp_path / "cache"))
    try:
        assert old == start
        assert build.BUILD_ROOT == (tmp_path / "cache").resolve()
        assert build.library_path().parent.parent == build.BUILD_ROOT
        assert build.BUILD_ROOT.is_dir()
        monkeypatch.setenv(ENV, str(tmp_path / "env"))
        enable_compilation_cache()
        assert build.BUILD_ROOT == (tmp_path / "env").resolve()
        monkeypatch.delenv(ENV)
        enable_compilation_cache()
        assert build.BUILD_ROOT == build.DEFAULT_BUILD_ROOT
    finally:
        build.BUILD_ROOT = start
