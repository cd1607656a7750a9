"""The alias sampler against the JAX package: Vose's tables bit for bit, K8's
walks on JAX's own draws for every distance backend, and its transition
frequencies against P.

K8 reads two uniforms a step, ``u [wl - 1, 2, W]``: JAX splits each step's
key again into ``k1`` (the slot) and ``k2`` (the coin), so the tests build
``u1`` and ``u2`` from those keys (:func:`jax_alias_uniforms`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathnet_tpu.data import DeviceGraph as JDeviceGraph
from pathnet_tpu.data import Graph as JGraph
from pathnet_tpu.sample import PathSampler as JPathSampler
from pathnet_tpu.sample import sample_paths as j_sample_paths
from pathnet_tpu.sample.alias import AliasSampler as JAliasSampler
from pathnet_tpu.sample.alias import _build_alias_tables_np
from pathnet_tpu.sample.alias import build_alias_tables as j_build_alias_tables

from pathnet_tpu_torch import kernels as K
from pathnet_tpu_torch.data import DeviceGraph, Graph
from pathnet_tpu_torch.sample import AliasSampler, PathSampler, build_alias_tables, sample_paths
from pathnet_tpu_torch.sample.walk import uniform_shape
from test_torch_port_sample import BGP, graph_pair, starts_for

NW = 6


def three_node_pair():
    """The 3-node graph of ``tests/test_sample.py``'s alias test."""
    args = dict(n=3, src=np.array([0, 0, 0, 1, 2], np.int32),
                dst=np.array([0, 1, 2, 0, 0], np.int32),
                prob=np.array([0.6, 0.3, 0.1, 1.0, 1.0]))
    return JGraph(**args), Graph(**args)


def bgp_slice_pair(n=3000):
    """The bgp stand-in's records among its first ``n`` nodes, with their
    MERW probabilities (rows renormalized by the padded CSR)."""
    z = np.load(BGP)
    keep = (z["src"] < n) & (z["dst"] < n)
    args = dict(n=n, src=z["src"][keep], dst=z["dst"][keep], prob=z["prob"][keep])
    return JGraph(**args), Graph(**args)


def pair(name):
    return {"three": three_node_pair, "bgp_slice": bgp_slice_pair}.get(
        name, lambda: graph_pair(name))()


def jax_alias_uniforms(key, walkers, wl):
    """The draws ``pathnet_tpu.sample.sample_paths`` makes under ``key`` with
    an ``AliasSampler``, in K8's layout ``[wl - 1, 2, walkers]``: each
    step's key split into ``k1`` (``u1``) and ``k2`` (``u2``)."""
    if wl == 1:
        return np.zeros((0, 2, walkers), np.float32)
    steps = []
    for k in jax.random.split(key, wl - 1):
        k1, k2 = jax.random.split(k)
        steps.append([np.asarray(jax.random.uniform(k1, (walkers,))),
                      np.asarray(jax.random.uniform(k2, (walkers,)))])
    return np.asarray(steps, np.float32)


def induced(lo, hi, split, deg, n):
    """``[rows, n]``: the next-node distribution an alias table draws from."""
    rows, D = lo.shape
    k = np.maximum(deg, 1).astype(np.float64)[:, None]
    real = np.arange(D)[None, :] < k
    r = np.repeat(np.arange(rows)[:, None], D, axis=1)
    out = np.zeros((rows, n))
    sp = split.astype(np.float64)
    np.add.at(out, (r[real], lo[real]), (sp / k)[real])
    np.add.at(out, (r[real], hi[real]), ((1.0 - sp) / k)[real])
    return out


@pytest.mark.parametrize("name", ["three", "cornell", "Nba", "bgp_slice"])
def test_alias_tables_are_bit_equal_to_jax(name):
    _, g = pair(name)
    nbr, prob, deg = g.padded_csr()
    got = build_alias_tables(nbr, prob, deg)
    want = _build_alias_tables_np(nbr, prob, deg)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["three", "cornell", "Nba"])
def test_alias_tables_induce_jax_distribution_and_P(name):
    """Against JAX's dispatching ``build_alias_tables`` (its C++ copy where
    it loads), by the distribution each row draws from, as
    ``tests/test_fastgraph.py`` compares the two; and that distribution is
    the row of P."""
    _, g = pair(name)
    nbr, prob, deg = g.padded_csr()
    mine = induced(*build_alias_tables(nbr, prob, deg), deg, g.n)
    theirs = induced(*j_build_alias_tables(nbr, prob, deg), deg, g.n)
    np.testing.assert_allclose(mine, theirs, atol=1e-5)
    P = np.zeros((g.n, g.n))
    real = np.arange(nbr.shape[1])[None, :] < np.maximum(deg, 1)[:, None]
    np.add.at(P, (np.nonzero(real)[0], nbr[real]), prob[real])
    np.testing.assert_allclose(mine, P, atol=1e-5)


@pytest.mark.parametrize("name", ["three", "cornell"])
def test_alias_sampler_holds_jax_tables_on_the_graphs_device(name):
    jg, g = pair(name)
    if name == "three":         # and an isolated node 3: a pure self-loop
        jg.n = g.n = 4
    want = JAliasSampler.from_device_graph(JDeviceGraph.from_graph(jg))
    smp = AliasSampler.from_device_graph(DeviceGraph.from_graph(g, device="cpu"))
    assert (smp.n, smp.max_deg) == (want.n, want.max_deg)
    for key in ("lo", "hi", "split", "deg"):
        t = getattr(smp, key)
        assert t.device == torch.device("cpu") and t.is_contiguous()
        np.testing.assert_array_equal(np.asarray(getattr(want, key)), t.numpy())
    # a row of degree <= 1 keeps split 1 and lo = hi = its neighbour row
    low = (smp.deg <= 1).nonzero().flatten()
    assert (smp.split[low] == 1).all()
    assert torch.equal(smp.lo[low], smp.hi[low]) and torch.equal(smp.lo[low], smp.nbr[low])
    if name == "three":
        assert low.tolist() == [1, 2, 3] and smp.lo[3].tolist() == [3, 3, 3]


@pytest.mark.parametrize("name,wl", [("cornell", 2), ("cornell", 4), ("cornell", 5),
                                     ("Nba", 4), ("bgp", 4)])
def test_alias_paths_match_jax_given_its_draws(name, wl):
    jg, g = graph_pair(name)
    starts = starts_for(name, g.n)
    key = jax.random.PRNGKey(30 + wl)
    jsmp = JAliasSampler.from_device_graph(JDeviceGraph.from_graph(jg))
    want = np.asarray(j_sample_paths(jsmp, key, jnp.asarray(starts), NW, wl))
    smp = AliasSampler.from_device_graph(DeviceGraph.from_graph(g, device="cpu"))
    u = torch.from_numpy(jax_alias_uniforms(key, len(starts) * NW, wl))
    got = sample_paths(smp, torch.from_numpy(starts), NW, wl, u=u)
    np.testing.assert_array_equal(want, got.numpy())


BACKEND_CASES = ([("membership", wl) for wl in (2, 3, 4)]
                 + [(b, wl) for b in ("khop", "dense", "none") for wl in (2, 3, 4, 5)])


@pytest.mark.parametrize("backend,wl", BACKEND_CASES)
def test_alias_sampler_matches_jax_for_every_backend(backend, wl):
    """``PathSampler.build(..., sampler="alias")``: on JAX's draws, JAX's
    walks and distances exactly (cornell, every node)."""
    jg, g = graph_pair("cornell")
    key = jax.random.PRNGKey(40 + wl)
    jp, jd = JPathSampler.build(jg, NW, wl, sampler="alias",
                                distance_backend=backend).sample(key)
    ps = PathSampler.build(g, NW, wl, sampler="alias", distance_backend=backend,
                           device="cpu")
    assert isinstance(ps.sampler, AliasSampler) and ps.backend == backend
    K.reset_launch_counts()
    p, d = ps.sample(u=torch.from_numpy(jax_alias_uniforms(key, g.n * NW, wl)))
    assert not any(K.launch_counts().values())
    np.testing.assert_array_equal(np.asarray(jp), p.numpy())
    if backend == "none":
        assert jd is None and d is None
    else:
        np.testing.assert_array_equal(np.asarray(jd), d.numpy())


def test_alias_transition_frequencies_match_P():
    _, g = three_node_pair()
    smp = AliasSampler.from_device_graph(DeviceGraph.from_graph(g, device="cpu"))
    walks = sample_paths(smp, torch.zeros(1, dtype=torch.int32), 200_000, 2,
                         generator=torch.Generator().manual_seed(3))
    freq = np.bincount(walks[0, :, 1].numpy(), minlength=3) / 200_000
    # 5e-3 is over 4.5 binomial standard errors (sqrt(0.3 * 0.7 / 2e5) = 1.0e-3)
    np.testing.assert_allclose(freq, [0.6, 0.3, 0.1], atol=5e-3)


def test_alias_transition_frequencies_match_P_on_cornell():
    """Every transition of a seeded 40-walk, 4-step epoch against P, edge
    by edge: within 5 binomial standard errors of each edge's count."""
    _, g = graph_pair("cornell")
    nbr, prob, deg = g.padded_csr()
    ps = PathSampler.build(g, 40, 4, sampler="alias", device="cpu")
    paths = ps.sample(generator=torch.Generator().manual_seed(4))[0].numpy()
    a, b = paths[:, :, :-1].ravel(), paths[:, :, 1:].ravel()
    counts = np.zeros((g.n, g.n))
    np.add.at(counts, (a, b), 1.0)
    visits = counts.sum(axis=1, keepdims=True)
    P = np.zeros((g.n, g.n))
    real = np.arange(nbr.shape[1])[None, :] < np.maximum(deg, 1)[:, None]
    np.add.at(P, (np.nonzero(real)[0], nbr[real]), prob[real])
    expect = visits * P
    se = np.sqrt(visits * P * (1 - P))
    assert np.all(np.abs(counts - expect) <= 5 * se + 1e-9)
    assert (counts[P == 0] == 0).all()


def test_alias_sampler_draws_two_uniforms_a_step():
    _, g = graph_pair("cornell")
    ps = PathSampler.build(g, NW, 4, sampler="alias", device="cpu")
    assert ps.uniform_shape(10) == (3, 2, 10) == uniform_shape(4, 10, 2)
    assert ps.draw_uniforms(10, torch.Generator().manual_seed(0)).shape == (3, 2, 10)
    with pytest.raises(ValueError):
        ps.sample(u=torch.rand(3, g.n * NW))          # K1's layout
    with pytest.raises(ValueError):
        ps.sample(u=torch.rand(2, 2, g.n * NW))       # one step short
    smp = ps.sampler
    starts = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        K.alias_walk(smp.lo, smp.hi, smp.split, smp.deg, starts, torch.rand(3, 4 * NW), NW)
    with pytest.raises(TypeError):
        K.alias_walk(smp.lo, smp.hi, smp.split.double(), smp.deg, starts,
                     torch.rand(3, 2, 4 * NW), NW)
    with pytest.raises(ValueError, match="walk_len"):
        K.alias_walk_dists(smp.lo, smp.hi, smp.split, smp.deg, smp.nbr, smp.srt, starts,
                           torch.rand(4, 2, 4 * NW), NW)
    with pytest.raises(ValueError, match="unsupported device"):
        K.alias_walk(*(t.to("meta") for t in (smp.lo, smp.hi, smp.split, smp.deg, starts,
                                              torch.rand(3, 2, 4 * NW))), NW)


def test_alias_wrappers_equal_their_plain_compositions():
    """On the host each fused wrapper is its walk's plain version followed
    by the distance's: the same walks as ``alias_walk``."""
    _, g = graph_pair("Nba")
    ps5 = PathSampler.build(g, NW, 5, sampler="alias", device="cpu")
    smp = ps5.sampler
    gen = torch.Generator().manual_seed(5)
    starts = torch.randperm(g.n, generator=gen)[:64].to(torch.int32)
    u = torch.rand((4, 2, 64 * NW), generator=gen)
    walks = K.alias_walk(smp.lo, smp.hi, smp.split, smp.deg, starts, u, NW)
    p, d = K.alias_walk_khop_dists(smp.lo, smp.hi, smp.split, smp.deg, ps5.khop, starts, u, NW)
    assert torch.equal(p, walks) and torch.equal(d, K.khop_dists(ps5.khop, starts, walks))
    p4, d4 = K.alias_walk_dists(smp.lo, smp.hi, smp.split, smp.deg, smp.nbr, smp.srt, starts,
                                u[:3], NW)
    assert torch.equal(p4, walks[:, :, :4])
    assert torch.equal(d4, K.membership_dists(smp.nbr, smp.deg, starts, p4))
