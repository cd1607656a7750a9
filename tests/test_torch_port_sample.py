"""Port vs JAX: walks, membership hop distances and the sampler's statistics."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathnet_tpu.data import DeviceGraph as JDeviceGraph
from pathnet_tpu.data import Graph as JGraph
from pathnet_tpu.sample import PathSampler as JPathSampler
from pathnet_tpu.sample import membership_dists as j_membership_dists
from pathnet_tpu.sample import sample_paths as j_sample_paths
from pathnet_tpu.sample.alias import CdfSampler as JCdfSampler

from pathnet_tpu_torch.data import DeviceGraph, Graph
from pathnet_tpu_torch.kernels import cdf_walk_plain, sorted_rows, walk_dists
from pathnet_tpu_torch.sample import CdfSampler, PathSampler, membership_dists, sample_paths

ROOT = os.path.join(os.path.dirname(__file__), "..")
EDGE = os.path.join(ROOT, "data", "edge_input")
BGP = os.path.join(ROOT, "data", "bench_cache", "bgp_standin_63977.npz")
NW = 6


def graph_pair(name):
    if name == "bgp":
        z = np.load(BGP)
        args = dict(n=int(z["n"]), src=z["src"], dst=z["dst"], prob=z["prob"])
        return JGraph(**args), Graph(**args)
    path = os.path.join(EDGE, f"{name}.in")
    return JGraph.from_edge_input(path), Graph.from_edge_input(path)


def jax_uniforms(key, walkers, wl):
    """The draws ``pathnet_tpu.sample.sample_paths`` makes under ``key``."""
    return np.stack([np.asarray(jax.random.uniform(k, (walkers,)))
                     for k in jax.random.split(key, wl - 1)])


def starts_for(name, n):
    """All nodes, or a fixed spread of 300 on the large graph."""
    if name == "bgp":
        return np.random.default_rng(0).choice(n, 300, replace=False).astype(np.int32)
    return np.arange(n, dtype=np.int32)


@pytest.mark.parametrize("name,wl", [("cornell", 2), ("cornell", 3), ("cornell", 4),
                                     ("Nba", 4), ("bgp", 4)])
def test_paths_match_jax_given_its_draws(name, wl):
    jg, g = graph_pair(name)
    starts = starts_for(name, g.n)
    key = jax.random.PRNGKey(wl)
    jsmp = JCdfSampler.from_device_graph(JDeviceGraph.from_graph(jg))
    want = np.asarray(j_sample_paths(jsmp, key, jnp.asarray(starts), NW, wl))
    smp = CdfSampler.from_device_graph(DeviceGraph.from_graph(g, device="cpu"))
    u = torch.from_numpy(jax_uniforms(key, len(starts) * NW, wl))
    got = sample_paths(smp, torch.from_numpy(starts), NW, wl, u=u)
    np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("wl", [2, 3, 4])
@pytest.mark.parametrize("name", ["cornell", "Nba", "bgp"])
def test_membership_dists_match_jax_on_jax_walks(name, wl):
    jg, g = graph_pair(name)
    starts = starts_for(name, g.n)[:120]
    jps = JPathSampler.build(jg, NW, wl)
    paths, _ = jps.sample(jax.random.PRNGKey(7), jnp.asarray(starts))
    want = np.asarray(j_membership_dists(jps.nbr, jps.deg, jnp.asarray(starts), paths))
    nbr, _, deg = g.padded_csr()
    got = membership_dists(torch.from_numpy(nbr), torch.from_numpy(deg),
                           torch.from_numpy(starts), torch.from_numpy(np.asarray(paths)))
    np.testing.assert_array_equal(want, got.numpy())
    assert want.max() <= wl - 1


def test_path_sampler_matches_jax_sample():
    jg, g = graph_pair("cornell")
    wl = 4
    key = jax.random.PRNGKey(11)
    jp, jd = JPathSampler.build(jg, NW, wl).sample(key)
    ps = PathSampler.build(g, NW, wl, device="cpu")
    p, d = ps.sample(u=torch.from_numpy(jax_uniforms(key, g.n * NW, wl)))
    np.testing.assert_array_equal(np.asarray(jp), p.numpy())
    np.testing.assert_array_equal(np.asarray(jd), d.numpy())


def test_transition_frequencies_match_P():
    g = Graph(n=3, src=np.array([0, 0, 0, 1, 2], np.int32),
              dst=np.array([0, 1, 2, 0, 0], np.int32),
              prob=np.array([0.25, 0.5, 0.25, 1.0, 1.0]))
    smp = CdfSampler.from_device_graph(DeviceGraph.from_graph(g, device="cpu"))
    gen = torch.Generator().manual_seed(1)
    walks = sample_paths(smp, torch.zeros(1, dtype=torch.int32), 100_000, 2,
                         generator=gen)
    freq = np.bincount(walks[0, :, 1].numpy(), minlength=3) / 100_000
    np.testing.assert_allclose(freq, [0.25, 0.5, 0.25], atol=6e-3)


def test_transition_frequencies_match_P_on_cornell():
    _, g = graph_pair("cornell")
    nbr, prob, deg = g.padded_csr()
    node = int(np.argmax(deg))
    P = np.bincount(nbr[node, :deg[node]], weights=prob[node, :deg[node]],
                    minlength=g.n)
    smp = CdfSampler.from_device_graph(DeviceGraph.from_graph(g, device="cpu"))
    walks = sample_paths(smp, torch.tensor([node], dtype=torch.int32), 200_000, 2,
                         generator=torch.Generator().manual_seed(2))
    freq = np.bincount(walks[0, :, 1].numpy(), minlength=g.n) / 200_000
    np.testing.assert_allclose(freq, P, atol=5e-3)


def test_walks_follow_edges_and_start_at_their_node():
    _, g = graph_pair("cornell")
    ps = PathSampler.build(g, 8, 4, device="cpu")
    paths, dists = ps.sample(generator=torch.Generator().manual_seed(0))
    paths = paths.numpy()
    assert paths.shape == (g.n, 8, 4)
    np.testing.assert_array_equal(paths[:, :, 0], np.arange(g.n)[:, None].repeat(8, 1))
    edges = set(zip(g.src.tolist(), g.dst.tolist()))
    for a, b in zip(paths[:, :, :-1].ravel(), paths[:, :, 1:].ravel()):
        assert (a, b) in edges
    assert (dists.numpy() <= np.arange(4)).all()


def test_walk_scan_stays_in_bounds_on_unsaturated_or_nan_rows():
    nbr = torch.tensor([[1, 2, 0], [0, 1, 1]], dtype=torch.int32)
    cdf = torch.tensor([[0.2, 0.4, 0.6], [float("nan")] * 3])
    u = torch.tensor([[0.9, 0.9]])
    got = cdf_walk_plain(nbr, cdf, torch.tensor([0, 1], dtype=torch.int32), u, 1)
    assert got[:, 0, 1].tolist() == [0, 0]      # idx clamped to D-1; NaN compares false


def jax_walk_dists(jsmp, key, starts, wl):
    """JAX's walks under ``key`` and their membership distances."""
    paths = j_sample_paths(jsmp, key, jnp.asarray(starts), NW, wl)
    return (np.asarray(paths),
            np.asarray(j_membership_dists(jsmp.nbr, jsmp.deg, jnp.asarray(starts), paths)))


def port_walk_dists(smp, key, starts, wl):
    walkers = len(starts) * NW
    u = (jax_uniforms(key, walkers, wl) if wl > 1 else np.zeros((0, walkers), np.float32))
    return walk_dists(smp.nbr, smp.cdf, smp.deg, smp.srt, torch.from_numpy(starts),
                      torch.from_numpy(u), NW)


@pytest.mark.parametrize("wl", [1, 2, 3, 4])
@pytest.mark.parametrize("name", ["cornell", "Nba"])
def test_walk_dists_equals_jax_walks_then_distances(name, wl):
    """The fused launch's plain version against JAX's ``sample_paths`` and
    ``membership_dists`` on JAX's own draws."""
    jg, g = graph_pair(name)
    starts = starts_for(name, g.n)
    key = jax.random.PRNGKey(20 + wl)
    want = jax_walk_dists(JCdfSampler.from_device_graph(JDeviceGraph.from_graph(jg)), key,
                          starts, wl)
    smp = CdfSampler.from_device_graph(DeviceGraph.from_graph(g, device="cpu"))
    got = port_walk_dists(smp, key, starts, wl)
    for w, gt in zip(want, got):
        np.testing.assert_array_equal(w, gt.numpy())


def test_walk_dists_equals_jax_on_nan_and_unsaturated_rows():
    """A NaN row (every compare false: idx 0) and a row that sums to 0.999
    give JAX's walks and distances; the key's draws all fall inside the
    short row, where JAX's gather would fill and the port clamps to D - 1."""
    nbr = np.array([[1, 2, 3, 0], [0, 2, 2, 2], [3, 1, 0, 0], [2, 2, 2, 2]], np.int32)
    deg = np.array([4, 2, 3, 1], np.int32)
    cdf = np.array([[0.2, 0.4, 0.6, 0.999], [np.nan] * 4, [0.3, 0.5, 1.0, 1.0],
                    [1.0] * 4], np.float32)
    starts = np.arange(4, dtype=np.int32)
    key = jax.random.PRNGKey(5)
    jsmp = JCdfSampler(n=4, max_deg=4, nbr=jnp.asarray(nbr), cdf=jnp.asarray(cdf),
                       deg=jnp.asarray(deg))
    want = jax_walk_dists(jsmp, key, starts, 4)
    assert (want[0] >= 0).all()     # no draw above the short row's 0.999
    tn, td = torch.from_numpy(nbr), torch.from_numpy(deg)
    smp = CdfSampler(n=4, max_deg=4, nbr=tn, cdf=torch.from_numpy(cdf), deg=td,
                     srt=sorted_rows(tn, td))
    got = port_walk_dists(smp, key, starts, 4)
    for w, gt in zip(want, got):
        np.testing.assert_array_equal(w, gt.numpy())
    assert (want[0][1, :, 1] == 0).all()     # the NaN row takes its first slot


def test_sorted_rows_keep_each_rows_real_entries_in_order():
    nbr = torch.tensor([[5, 1, 3, 3], [2, 0, 9, 9], [4, 4, 4, 4]], dtype=torch.int32)
    deg = torch.tensor([3, 2, 0], dtype=torch.int32)
    big = 2 ** 31 - 1
    assert sorted_rows(nbr, deg).tolist() == [[1, 3, 5, big], [0, 2, big, big],
                                              [big] * 4]


@pytest.mark.parametrize("kw", [{"kind": "uniform"}, {"sampler": "alias"},
                                {"distance_backend": "khop"},
                                {"distance_backend": "dense"}])
def test_unported_sampler_choices_raise(kw):
    _, g = graph_pair("cornell")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PathSampler.build(g, NW, 4, device="cpu", **kw)


def test_sampler_checks_draws():
    _, g = graph_pair("cornell")
    ps = PathSampler.build(g, NW, 4, device="cpu")
    with pytest.raises(ValueError):
        ps.sample(u=torch.rand(2, g.n * NW))
    with pytest.raises(ValueError):
        ps.sample()
