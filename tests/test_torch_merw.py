"""The port's MERW against the JAX package's. The host solvers (per-component
log-space MERW, integer-weight recovery) run the same numpy in the same
order, so they are held exactly equal; the f32 power iteration starts from
another random vector (torch's generator, not threefry) and converges to the
same Perron vector, so its probabilities are held within 1e-5, the order of
what its eigenvector tolerance (1e-6 on entries of ~1/sqrt(n)) leaves."""
import os

import numpy as np
import pytest
import torch

from pathnet_tpu import merw as jmerw
from pathnet_tpu.data import Graph as JGraph
from pathnet_tpu.data import DeviceGraph as JDeviceGraph
from pathnet_tpu.data import registry as jreg

import chip_smoke
from pathnet_tpu_torch import merw
from pathnet_tpu_torch.data import DeviceGraph, Graph, registry
from pathnet_tpu_torch.merw import merw as merw_mod

ROOT = os.path.join(os.path.dirname(__file__), "..")
EDGE = os.path.join(ROOT, "data", "edge_input")


def both(g):
    """The same records as the port's and the JAX package's Graph."""
    return (Graph(n=g.n, src=g.src, dst=g.dst, prob=g.prob),
            JGraph(n=g.n, src=g.src, dst=g.dst, prob=g.prob))


def structure(name):
    g = Graph.from_edge_input(os.path.join(EDGE, registry.DATASETS[name].edge_file))
    return Graph(n=g.n, src=g.src, dst=g.dst, prob=g.prob)


def binary(g):
    return Graph(n=g.n, src=g.src, dst=g.dst, prob=np.ones(len(g.src)))


@pytest.mark.parametrize("name", ["Nba", "cora", "citeseer"])
def test_weight_recovery_and_per_component_merw_equal_jax(name):
    g, jg = both(structure(name))
    w = merw.recover_integer_weights(g, g.prob)
    jw = jmerw.recover_integer_weights(jg, jg.prob)
    assert w.dtype == jw.dtype and np.array_equal(w, jw)
    got = merw.merw_graph_per_component(binary(g), weights=w, force_log=True)
    want = jmerw.merw_graph_per_component(JGraph(n=g.n, src=g.src, dst=g.dst,
                                                 prob=np.ones(len(g.src))),
                                          weights=jw, force_log=True)
    assert got.prob.dtype == want.prob.dtype and np.array_equal(got.prob, want.prob)


@pytest.mark.parametrize("name", ["texas", "wisconsin"])
def test_per_component_merw_of_sbm_standins_equals_jax(name):
    s = registry.load_structure(name, ".")
    assert np.array_equal(s.prob, np.ones(len(s.src)))
    got = merw.merw_graph_per_component(s, device="cpu")
    want = jmerw.merw_graph_per_component(JGraph(n=s.n, src=s.src, dst=s.dst, prob=s.prob))
    assert np.array_equal(got.prob, want.prob)
    assert got.features is s.features and got.labels is s.labels


@pytest.fixture(scope="module")
def chameleon():
    return registry.load_structure("chameleon", ".")


@pytest.fixture(scope="module")
def cornell_binary():
    return binary(structure("cornell"))


@pytest.mark.parametrize("which", ["chameleon", "cornell_binary"])
def test_power_iteration_probs_within_1e5_of_jax(request, which):
    g = request.getfixturevalue(which)
    got = merw.merw_graph(g, device="cpu")
    want = jmerw.merw_graph(JGraph(n=g.n, src=g.src, dst=g.dst, prob=g.prob))
    assert np.abs(got.prob - want.prob).max() < 1e-5
    # a connected graph without force_log takes the same power iteration
    per = merw.merw_graph_per_component(g, device="cpu")
    assert np.array_equal(per.prob, got.prob)


@pytest.mark.parametrize("seed", [1, 2])
def test_the_start_vector_does_not_move_the_probs(cornell_binary, seed):
    a = merw.merw_graph(cornell_binary, device="cpu")
    b = merw.merw_graph(cornell_binary, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    assert np.abs(a.prob - b.prob).max() < 1e-5


def test_eigenpair_equals_jax_and_a_dense_solver(cornell_binary):
    g = cornell_binary
    psi, lam = merw.principal_eigenpair(g, device="cpu")
    jpsi, jlam = jmerw.principal_eigenpair(JGraph(n=g.n, src=g.src, dst=g.dst, prob=g.prob))
    assert psi.dtype == torch.float32 and psi.shape == (g.n,)
    assert np.abs(psi.numpy() - np.asarray(jpsi)).max() < 1e-5
    assert abs(float(lam) - float(jlam)) < 1e-4 * float(jlam)
    a = merw_mod._adjacency_csr(g).toarray()
    vals, vecs = np.linalg.eigh(a)
    assert abs(float(lam) - vals[-1]) < 1e-4 * vals[-1]
    assert np.abs(psi.numpy() - np.abs(vecs[:, -1])).max() < 1e-4


def test_eigenpair_of_a_device_graph_is_that_of_its_structure(cornell_binary):
    dg = DeviceGraph.from_graph(cornell_binary, device="cpu")
    a = merw.principal_eigenpair(dg, device="cpu")
    b = merw.principal_eigenpair(cornell_binary, device="cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_padded_probs_and_stationary_distribution_within_1e6_of_jax(cornell_binary):
    g = cornell_binary
    # one node more than cornell's structure: an isolated node, a self-loop row
    g2 = Graph(n=g.n + 1, src=g.src, dst=g.dst, prob=g.prob)
    psi, lam = merw.principal_eigenpair(g2, device="cpu")
    dg = DeviceGraph.from_graph(g2, device="cpu")
    jdg = JDeviceGraph.from_graph(JGraph(n=g2.n, src=g2.src, dst=g2.dst, prob=g2.prob))
    got = merw.merw_padded_probs(dg, psi, lam)
    want = np.asarray(jmerw.merw_padded_probs(jdg, psi.numpy(), float(lam)))
    assert got.shape == want.shape and np.abs(got.numpy() - want).max() < 1e-6
    assert got[g.n, 0] == 1.0 and float(got[g.n, 1:].abs().sum()) == 0.0
    torch.testing.assert_close(got.sum(dim=1), torch.ones(g2.n), atol=1e-6, rtol=0)
    pi = merw.stationary_distribution(psi)
    jpi = np.asarray(jmerw.stationary_distribution(psi.numpy()))
    assert np.abs(pi.numpy() - jpi).max() < 1e-6 and abs(float(pi.sum()) - 1) < 1e-6


def test_record_probs_equal_jax_with_weights(cornell_binary):
    g = cornell_binary
    psi, lam = merw.principal_eigenpair(g, device="cpu")
    w = np.random.default_rng(0).integers(1, 3, size=len(g.src)).astype(np.float64)
    jg = JGraph(n=g.n, src=g.src, dst=g.dst, prob=g.prob)
    for weights in (None, w):
        got = merw.merw_record_probs(g, psi.numpy(), float(lam), weights)
        want = jmerw.merw_record_probs(jg, psi.numpy(), float(lam), weights)
        assert np.array_equal(got, want)


def test_cornell_column_is_reproduced_from_recovered_weights():
    """The verify recipe's oracle: MERW of cornell's structure with the
    integer weights recovered from its file reproduces the file's column."""
    g = Graph.from_edge_input(os.path.join(EDGE, "cornell.in"))
    w = merw.recover_integer_weights(g, g.prob)
    g2 = merw.merw_graph(binary(g), weights=w, device="cpu")
    rel = np.abs(g2.prob - g.prob) / np.maximum(g.prob, 1e-12)
    assert rel.max() < 5e-3


def test_bgp_standin_probs_within_the_card_check_of_the_stored_ones():
    """``chip_smoke.py`` holds the card's ``merw_graph`` on the bgp stand-in's
    structure to ``MERW_TOL`` of the file's probs; the host takes the same
    iteration."""
    z = np.load(os.path.join(ROOT, "data", "bench_cache", "bgp_standin_63977.npz"))
    g = Graph(n=int(z["n"]), src=z["src"], dst=z["dst"], prob=np.ones(len(z["src"])))
    got = merw.merw_graph(g, device="cpu")
    assert np.abs(got.prob - z["prob"]).max() <= chip_smoke.MERW_TOL


@pytest.mark.parametrize("check_every", [1, 5, 32])
def test_power_iteration_stops_where_a_plain_loop_stops(cornell_binary, monkeypatch,
                                                        check_every):
    """Converged iterations are frozen on the device, so reading the flag only
    every ``CHECK_EVERY`` iterations changes nothing."""
    nbr, w, _ = merw_mod._padded_adjacency(merw_mod._adjacency_csr(cornell_binary))
    nbr, w = torch.from_numpy(nbr), torch.from_numpy(w)
    v0 = torch.rand(cornell_binary.n, generator=torch.Generator().manual_seed(0)) + 0.1
    v, it = v0 / torch.linalg.norm(v0), 0
    while it < 1000:
        u = (v[nbr.long()] * w).sum(dim=1)
        u = u / torch.clamp(torch.linalg.norm(u), min=1e-30)
        delta = (u - v).abs().max()
        v, it = u, it + 1
        if delta <= 1e-6:
            break
    assert 1 < it < 1000
    monkeypatch.setattr(merw_mod, "CHECK_EVERY", check_every)
    psi, lam = merw_mod._power_iteration(nbr, w, v0, 1000, 1e-6)
    want = v.abs() / torch.linalg.norm(v)
    assert torch.equal(psi, want)


def test_merw_graph_needs_a_card_without_a_device(cornell_binary, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        merw.merw_graph(cornell_binary)
