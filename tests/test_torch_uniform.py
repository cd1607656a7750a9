"""Uniform walks (``kind="uniform"``, ``-mk uniform``: RW-PathNet) and the
epoch's walk set against the JAX package.

The symmetrized graph's records, its padded CSR, CDF rows and k-hop tables
bit for bit; uniform walks and their distances on JAX's draws for every
distance backend, with either sampler; ``sample_epoch`` keyed as the trainer
keys its walks; and ``-mk uniform`` through the CLI on the host.
"""
import jax
import numpy as np
import pytest
import torch

from pathnet_tpu.data import DeviceGraph as JDeviceGraph
from pathnet_tpu.sample import PathSampler as JPathSampler
from pathnet_tpu.sample.alias import CdfSampler as JCdfSampler
from pathnet_tpu.sample.distance import build_khop_tables as j_build_khop_tables
from pathnet_tpu.train.results import format_result_line as j_format_result_line

from pathnet_tpu_torch import merw, run
from pathnet_tpu_torch.data import DeviceGraph, registry
from pathnet_tpu_torch.rng import STREAM_WALKS, make_generator
from pathnet_tpu_torch.sample import (CdfSampler, PathSampler, build_khop_tables,
                                      sample_epoch)
from pathnet_tpu_torch.train import trainer
from pathnet_tpu_torch.train.checkpoint import completed_rounds
from test_torch_alias import jax_alias_uniforms
from test_torch_port_sample import graph_pair, jax_uniforms, starts_for
from test_torch_train_loop import cornell_root  # noqa: F401  (a fixture)

NW = 6


@pytest.mark.parametrize("loops", [True, False])
@pytest.mark.parametrize("name", ["cornell", "Nba"])
def test_symmetrized_records_equal_jax(name, loops):
    jg, g = graph_pair(name)
    js, s = jg.symmetrized(add_self_loops=loops), g.symmetrized(add_self_loops=loops)
    assert s.n == js.n
    for key in ("src", "dst", "prob"):
        a, b = getattr(s, key), getattr(js, key)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["cornell", "Nba", "bgp"])
def test_symmetrized_device_graph_and_cdf_equal_jax(name):
    """``nbr``, ``deg`` and the CDF rows of the symmetrized multigraph (one
    self-loop a node, duplicate records kept), bit for bit: the blocked CDF
    sum at D = 381 (cornell), 885 (Nba) and 51 (bgp)."""
    jg, g = graph_pair(name)
    jdg = JDeviceGraph.from_graph(jg.symmetrized(add_self_loops=True))
    dg = DeviceGraph.from_graph(g.symmetrized(add_self_loops=True), device="cpu")
    assert dg.max_deg == jdg.max_deg == {"cornell": 381, "Nba": 885, "bgp": 51}[name]
    for key in ("nbr", "prob", "deg"):
        np.testing.assert_array_equal(np.asarray(getattr(jdg, key)), getattr(dg, key).numpy())
    want = np.asarray(JCdfSampler.from_device_graph(jdg).cdf)
    np.testing.assert_array_equal(want, CdfSampler.from_device_graph(dg).cdf.numpy())


@pytest.mark.parametrize("name", ["cornell", "Nba"])
def test_symmetrized_khop_tables_equal_jax(name):
    jg, g = graph_pair(name)
    want = j_build_khop_tables(jg.symmetrized(add_self_loops=True), 4)
    got = build_khop_tables(g.symmetrized(add_self_loops=True), 4, device="cpu")
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(b), a.numpy())


UNIFORM_CASES = ([("membership", wl, "cdf") for wl in (2, 3, 4)]
                 + [(b, wl, "cdf") for b in ("khop", "dense", "host", "none") for wl in (4, 5)]
                 + [(b, 4, "alias") for b in ("membership", "khop", "dense", "host", "none")]
                 + [("khop", 5, "alias")])


@pytest.mark.parametrize("backend,wl,sampler", UNIFORM_CASES)
def test_uniform_walks_and_distances_match_jax(backend, wl, sampler):
    """``kind="uniform"`` on cornell, every node: on JAX's draws, JAX's walks
    and distances exactly, each backend on the symmetrized graph."""
    jg, g = graph_pair("cornell")
    key = jax.random.PRNGKey(50 + wl)
    jp, jd = JPathSampler.build(jg, NW, wl, kind="uniform", sampler=sampler,
                                distance_backend=backend).sample(key)
    ps = PathSampler.build(g, NW, wl, kind="uniform", sampler=sampler,
                           distance_backend=backend, device="cpu")
    assert ps.backend == backend and ps.sampler.max_deg == 381
    draws = jax_alias_uniforms if sampler == "alias" else jax_uniforms
    p, d = ps.sample(u=torch.from_numpy(draws(key, g.n * NW, wl)))
    np.testing.assert_array_equal(np.asarray(jp), p.numpy())
    if backend == "none":
        assert jd is None and d is None
    else:
        np.testing.assert_array_equal(np.asarray(jd), d.numpy())


@pytest.mark.parametrize("name", ["Nba", "bgp"])
def test_uniform_walk_dists_match_jax_on_wider_tables(name):
    """The membership backend on Nba (D = 885) and 300 bgp starts (D = 51)."""
    jg, g = graph_pair(name)
    starts = starts_for(name, g.n)
    key = jax.random.PRNGKey(60)
    jp, jd = JPathSampler.build(jg, NW, 4, kind="uniform").sample(key, starts)
    ps = PathSampler.build(g, NW, 4, kind="uniform", device="cpu")
    p, d = ps.sample(torch.from_numpy(starts),
                     u=torch.from_numpy(jax_uniforms(key, len(starts) * NW, 4)))
    np.testing.assert_array_equal(np.asarray(jp), p.numpy())
    np.testing.assert_array_equal(np.asarray(jd), d.numpy())


def test_uniform_walks_follow_symmetrized_records_uniformly():
    """Every step of a uniform walk is a record of the symmetrized graph
    (both directions, or a self-loop); from the widest row the next node is
    drawn with its record count over the row's records, within 5 binomial
    standard errors."""
    _, g = graph_pair("cornell")
    ps = PathSampler.build(g, 8, 4, kind="uniform", device="cpu")
    paths = ps.sample(generator=torch.Generator().manual_seed(0))[0].numpy()
    edges = set(zip(g.src.tolist(), g.dst.tolist()))
    for a, b in zip(paths[:, :, :-1].ravel().tolist(), paths[:, :, 1:].ravel().tolist()):
        assert a == b or (a, b) in edges or (b, a) in edges
    sym = g.symmetrized(add_self_loops=True)
    node = int(np.argmax(sym.degrees()))
    P = np.bincount(sym.dst[sym.src == node], minlength=g.n) / sym.degrees()[node]
    draws = 200_000
    walks = PathSampler.build(g, draws, 2, kind="uniform", device="cpu").sample(
        torch.tensor([node], dtype=torch.int32), generator=torch.Generator().manual_seed(1))[0]
    freq = np.bincount(walks[0, :, 1].numpy(), minlength=g.n) / draws
    assert np.all(np.abs(freq - P) <= 5 * np.sqrt(P * (1 - P) / draws) + 1e-12)


@pytest.mark.parametrize("sampler", ["cdf", "alias"])
def test_sample_epoch_is_reproducible_and_varies_by_epoch(sampler):
    _, g = graph_pair("cornell")
    ps = PathSampler.build(g, 4, 4, sampler=sampler, device="cpu")
    p1, d1 = ps.sample_epoch(3, 0)
    p2, d2 = sample_epoch(ps, 3, 0)
    assert torch.equal(p1, p2) and torch.equal(d1, d2)
    assert not torch.equal(p1, ps.sample_epoch(3, 1)[0])
    assert not torch.equal(p1, ps.sample_epoch(4, 0)[0])
    # the trainer's walks of (seed, epoch): this generator's draws
    want = ps.sample(generator=make_generator(3, 0, STREAM_WALKS))
    assert torch.equal(p1, want[0]) and torch.equal(d1, want[1])


def test_run_round_draws_each_epochs_walks_from_sample_epoch(monkeypatch):
    _, g = graph_pair("cornell")
    ps = PathSampler.build(g, 4, 4, kind="uniform", device="cpu")
    seen = []
    real = PathSampler.sample_epoch
    monkeypatch.setattr(PathSampler, "sample_epoch",
                        lambda self, seed, epoch: seen.append((seed, epoch)) or real(
                            self, seed, epoch))
    X = torch.randn(g.n, 8, generator=torch.Generator().manual_seed(0))
    y = torch.arange(g.n) % 5
    masks = [np.arange(g.n) % 3 == i for i in range(3)]
    spec = trainer.PaggSpec(feat_dim=8, hidden=8, out_dim=5, walk_len=4)
    trainer.run_round(X, y, ps, spec, trainer.TrainConfig(epochs=3), *masks, 5, seed=7)
    assert seen == [(7, 0), (7, 1), (7, 2)]


def test_cli_runs_uniform_walks_on_the_host(cornell_root, capsys, monkeypatch):  # noqa: F811
    """``-mk uniform`` on cornell through the CLI: one round of 2 epochs on
    the host, no MERW (the payload's probabilities all 1, where ``merw``
    would run it), the sampler on the symmetrized graph, the round
    checkpointed under the JAX package's ``uniform`` key and the result line
    in JAX's format."""
    fp = registry.payload_fingerprint(registry.DATASETS["cornell"])
    path = cornell_root / "payload_cache" / f"cornell.{fp}.npz"
    z = dict(np.load(path))
    z["prob"] = np.ones_like(z["prob"])
    np.savez(path, **z)

    def no_merw(*a, **k):
        raise AssertionError("MERW ran for uniform walks")

    monkeypatch.setattr(merw, "merw_graph_per_component", no_merw)
    built = []
    real = trainer.PathSampler.build
    monkeypatch.setattr(trainer.PathSampler, "build", staticmethod(
        lambda *a, **k: (lambda ps: built.append((k.get("kind"), ps.sampler.max_deg)) or ps)(
            real(*a, **k))))
    agg = run.main(["-data", "cornell", "-pr", str(cornell_root), "-e", "2", "-r", "1",
                    "-hid", "8", "-nw", "4", "-mk", "uniform", "--device", "cpu",
                    "--results-dir", str(cornell_root / "res"),
                    "--ckpt-dir", str(cornell_root / "ck"), "--resume"])
    assert built == [("uniform", 381)]
    line = j_format_result_line("cornell", agg)
    assert line in capsys.readouterr().out
    text = (cornell_root / "res" / "result_for_cornell.txt").read_text()
    assert line in text and "marker: uniform" in text
    assert completed_rounds(str(cornell_root / "ck"),
                            f"cornell.{fp}.e2.h8.s0.nw4.wl4.dr0.7.uniform.lstm.attention") == 1
