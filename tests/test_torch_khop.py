"""Walk length 5 and the distance backends against the JAX package.

The k-hop tables array for array and the same ``ValueError`` at a small
``max_width``; K7's plain version (``khop_dists``, and fused with the walk in
``walk_khop_dists``) exactly on JAX-sampled walks at wl = 5 and 6, and equal
to the membership distances at wl = 4; the dense BFS table (int8, -1 beyond
truncation) and the scipy table exactly; ``PathSampler.build``'s choice of
backend, its fallback to the dense table under a lowered byte limit, the
2-D table lookup and the ``none`` backend, each against JAX's sampler on
JAX's draws; the PAGG model at wl = 5 (hetero and homo, dropout off and
JAX's masks): logits within 1e-5 and every gradient within atol 1e-5 +
rtol 1e-4 of ``pagg_forward`` and ``jax.grad``; and ``-wl 5`` through the CLI
on the host.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathnet_tpu.data import Graph as JGraph
from pathnet_tpu.models import pagg_forward
from pathnet_tpu.sample import PathSampler as JPathSampler
from pathnet_tpu.sample.distance import bfs_distance_table as j_bfs_distance_table
from pathnet_tpu.sample.distance import bfs_distance_table_host as j_bfs_distance_table_host
from pathnet_tpu.sample.distance import build_khop_tables as j_build_khop_tables
from pathnet_tpu.train.results import format_result_line as j_format_result_line
from pathnet_tpu.train.trainer import _loss_fn

from pathnet_tpu_torch import kernels as K
from pathnet_tpu_torch import run
from pathnet_tpu_torch.data import Graph, registry
from pathnet_tpu_torch.models import params_to_jax
from pathnet_tpu_torch.sample import (KhopTables, PathSampler, bfs_distance_table,
                                      bfs_distance_table_host, build_khop_tables, khop_dists,
                                      membership_dists)
from pathnet_tpu_torch.sample import walk as port_walk
from pathnet_tpu_torch.train import trainer
from pathnet_tpu_torch.train.checkpoint import completed_rounds
from test_torch_homo import homo_model
from test_torch_port_sample import graph_pair, jax_uniforms
from test_torch_train_grads import assert_grads_close, jax_masks, setup
from test_torch_train_loop import cornell_root  # noqa: F401  (a fixture)

NW = 6


def random_pair(n=50, m=120, seed=3):
    """A small random graph whose records are not all paired (some edges one
    way only), with a node that no record touches."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n - 1, size=m).astype(np.int32)
    dst = rng.integers(0, n - 1, size=m).astype(np.int32)
    src, dst = np.concatenate([src, dst[:m // 2]]), np.concatenate([dst, src[:m // 2]])
    prob = rng.random(len(src)) + 0.1
    return (JGraph(n=n, src=src, dst=dst, prob=prob), Graph(n=n, src=src, dst=dst, prob=prob))


def line_pair(n=12):
    """A path graph 0 - 1 - ... - n-1, both directions: distances pass any
    small ``max_hops``."""
    a = np.arange(n - 1, dtype=np.int32)
    src, dst = np.concatenate([a, a + 1]), np.concatenate([a + 1, a])
    prob = np.ones(len(src))
    return JGraph(n=n, src=src, dst=dst, prob=prob), Graph(n=n, src=src, dst=dst, prob=prob)


def pair(name):
    return {"random": random_pair, "line": line_pair}[name]() if name in (
        "random", "line") else graph_pair(name)


@pytest.mark.parametrize("name", ["cornell", "Nba", "random"])
def test_khop_tables_equal_jax(name):
    jg, g = pair(name)
    want = j_build_khop_tables(jg, 5)
    got = build_khop_tables(g, 5, device="cpu")
    assert len(got) == len(want) == 5
    for w, t in zip(want, got):
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(w, t.numpy())


def test_khop_tables_refuse_a_wide_level_as_jax():
    jg, g = graph_pair("cornell")
    with pytest.raises(ValueError) as want:
        j_build_khop_tables(jg, 4, max_width=100)
    with pytest.raises(ValueError) as got:
        build_khop_tables(g, 4, max_width=100, device="cpu")
    assert str(got.value) == str(want.value)
    assert "level 2" in str(got.value)


def jax_khop_walks(jg, wl, seed, starts=None):
    """JAX's khop sampler's walks and distances under ``PRNGKey(seed)``."""
    jps = JPathSampler.build(jg, NW, wl, distance_backend="khop")
    assert jps.khop is not None
    p, d = jps.sample(jax.random.PRNGKey(seed),
                      None if starts is None else jnp.asarray(starts))
    return np.array(p), np.array(d)


@pytest.mark.parametrize("wl", [5, 6])
@pytest.mark.parametrize("name", ["cornell", "Nba", "random"])
def test_khop_dists_equal_jax_on_jax_walks(name, wl):
    jg, g = pair(name)
    paths, want = jax_khop_walks(jg, wl, 30 + wl)
    starts = torch.arange(g.n, dtype=torch.int32)
    levels = build_khop_tables(g, wl - 1, device="cpu")
    got = khop_dists(levels, starts, torch.from_numpy(paths))
    np.testing.assert_array_equal(got.numpy(), want)
    plain = K.khop_dists_plain(levels, starts, torch.from_numpy(paths))
    np.testing.assert_array_equal(plain.numpy(), want)
    assert want.max() <= wl - 1 and (want[:, :, 0] == 0).all()


@pytest.mark.parametrize("name", ["cornell", "Nba"])
def test_khop_dists_equal_the_membership_dists_at_wl4(name):
    """At wl = 4 both backends give the same distances on the same walks (as
    ``tests/test_sample.py`` holds JAX's two)."""
    jg, g = graph_pair(name)
    starts = np.arange(g.n, dtype=np.int32)
    paths, _ = JPathSampler.build(jg, NW, 4).sample(jax.random.PRNGKey(5))
    paths = torch.from_numpy(np.array(paths))
    nbr, _, deg = g.padded_csr()
    want = membership_dists(torch.from_numpy(nbr), torch.from_numpy(deg),
                            torch.from_numpy(starts), paths)
    got = khop_dists(build_khop_tables(g, 3, device="cpu"), torch.from_numpy(starts), paths)
    assert torch.equal(got, want)


@pytest.mark.parametrize("wl", [5, 6])
@pytest.mark.parametrize("name", ["cornell", "Nba"])
def test_khop_sampler_equals_jax_on_its_draws(name, wl):
    """``PathSampler.sample`` (the fused walk and K7, plain on the host) on
    JAX's draws: JAX's walks and k-hop distances."""
    jg, g = graph_pair(name)
    key = jax.random.PRNGKey(40 + wl)
    jp, jd = JPathSampler.build(jg, NW, wl).sample(key)
    ps = PathSampler.build(g, NW, wl, device="cpu")
    assert ps.backend == "khop" and len(ps.khop) == wl - 1
    p, d = ps.sample(u=torch.from_numpy(jax_uniforms(key, g.n * NW, wl)))
    np.testing.assert_array_equal(np.asarray(jp), p.numpy())
    np.testing.assert_array_equal(np.asarray(jd), d.numpy())


def test_khop_wrappers_take_the_plain_versions_on_the_host_and_check_the_levels():
    _, g = graph_pair("cornell")
    ps = PathSampler.build(g, NW, 5, device="cpu")
    smp = ps.sampler
    starts = torch.arange(g.n, dtype=torch.int32)
    u = torch.rand((4, g.n * NW), generator=torch.Generator().manual_seed(0))
    K.reset_launch_counts()
    paths, dists = K.walk_khop_dists(smp.nbr, smp.cdf, ps.khop, starts, u, NW)
    assert torch.equal(paths, K.cdf_walk_plain(smp.nbr, smp.cdf, starts, u, NW))
    assert torch.equal(dists, K.khop_dists(ps.khop, starts, paths))
    assert all(c == 0 for c in K.launch_counts().values())
    longer = torch.cat([paths, paths[:, :, :2]], dim=2)     # wl = 7 > 4 levels + 1
    with pytest.raises(ValueError, match="levels 1..6"):
        K.khop_dists(ps.khop, starts, longer)
    with pytest.raises(ValueError, match="levels"):
        K.walk_khop_dists(smp.nbr, smp.cdf, ps.khop, starts, torch.cat([u, u[:2]]), NW)
    meta = KhopTables.pack([t.to("meta") for t in ps.khop.levels])
    with pytest.raises(ValueError, match="unsupported device"):
        K.khop_dists(meta, starts.to("meta"), paths.to("meta"))
    # the levels are views of one packed buffer, each at its offset and width
    assert [int(o) for o in ps.khop.offsets] == np.cumsum(
        [0] + [t.numel() for t in ps.khop.levels[:-1]]).tolist()
    assert ps.khop.widths.tolist() == [t.shape[1] for t in ps.khop.levels]


@pytest.mark.parametrize("name,max_hops,chunk", [("cornell", 5, 1024), ("cornell", 5, 64),
                                                 ("line", 3, 5)])
def test_bfs_distance_table_equals_jax(name, max_hops, chunk):
    jg, g = pair(name)
    want = np.asarray(j_bfs_distance_table(jg, max_hops, chunk))
    got = bfs_distance_table(g, max_hops, chunk, device="cpu")
    assert got.dtype == torch.int8 and got.shape == (g.n, g.n)
    np.testing.assert_array_equal(got.numpy(), want)
    if name == "line":
        assert (want == -1).any() and want.max() == max_hops


@pytest.mark.parametrize("name", ["cornell", "line"])
def test_bfs_distance_table_host_equals_jax(name):
    jg, g = pair(name)
    np.testing.assert_array_equal(bfs_distance_table_host(g, 3), j_bfs_distance_table_host(jg, 3))


def backend_of(jps):
    """The backend a JAX sampler holds state for."""
    if jps.nbr is not None:
        return "membership"
    if jps.khop is not None:
        return "khop"
    return "table" if jps.dist_table is not None else "none"


@pytest.mark.parametrize("wl,backend", [(4, "auto"), (5, "auto"), (3, "khop"), (5, "dense"),
                                        (5, "host"), (5, "none"), (4, "membership")])
def test_build_picks_the_backend_jax_picks(wl, backend):
    jg, g = graph_pair("cornell")
    jps = JPathSampler.build(jg, NW, wl, distance_backend=backend)
    ps = PathSampler.build(g, NW, wl, distance_backend=backend, device="cpu")
    want = backend_of(jps)
    assert (ps.backend if ps.backend in ("membership", "khop", "none") else "table") == want
    if want == "khop":
        for w, t in zip(jps.khop, ps.khop.levels):
            np.testing.assert_array_equal(np.asarray(w), t.numpy())
    if want == "table":
        np.testing.assert_array_equal(np.asarray(jps.dist_table), ps.dist_table.numpy())


def test_membership_refuses_wl5_as_jax():
    jg, g = graph_pair("cornell")
    with pytest.raises(ValueError, match="walk_len <= 4"):
        JPathSampler.build(jg, NW, 5, distance_backend="membership")
    with pytest.raises(ValueError, match="walk_len <= 4"):
        PathSampler.build(g, NW, 5, distance_backend="membership", device="cpu")


def test_khop_falls_back_to_the_dense_table_under_a_lowered_byte_limit(monkeypatch):
    """With the limit at 1 KiB a level's cap is max(64, 1024 // 4n) = 64 <
    cornell's 94-wide first level: the sampler holds JAX's dense table
    (``max_hops = walk_len``) and gives JAX's dense backend's distances."""
    jg, g = graph_pair("cornell")
    monkeypatch.setattr(port_walk, "KHOP_MAX_BYTES", 1 << 10)
    ps = PathSampler.build(g, NW, 5, device="cpu")
    assert ps.backend == "dense" and ps.khop is None
    np.testing.assert_array_equal(ps.dist_table.numpy(),
                                  np.asarray(j_bfs_distance_table(jg, 5)))
    key = jax.random.PRNGKey(8)
    jp, jd = JPathSampler.build(jg, NW, 5, distance_backend="dense").sample(key)
    p, d = ps.sample(u=torch.from_numpy(jax_uniforms(key, g.n * NW, 5)))
    np.testing.assert_array_equal(np.asarray(jp), p.numpy())
    np.testing.assert_array_equal(np.asarray(jd), d.numpy())
    monkeypatch.setattr(port_walk, "KHOP_MAX_BYTES", 1 << 30)
    assert PathSampler.build(g, NW, 5, device="cpu").backend == "khop"


@pytest.mark.parametrize("backend", ["dense", "host", "none"])
def test_table_lookups_and_none_equal_jax(backend):
    """The 2-D lookup ``table[starts, paths]`` on a subset of starts, and no
    distances at all for ``none``, as JAX's sampler gives them."""
    jg, g = graph_pair("Nba")
    starts = np.random.default_rng(1).choice(g.n, 90, replace=False).astype(np.int32)
    key = jax.random.PRNGKey(9)
    jp, jd = JPathSampler.build(jg, NW, 5, distance_backend=backend).sample(
        key, jnp.asarray(starts))
    ps = PathSampler.build(g, NW, 5, distance_backend=backend, device="cpu")
    p, d = ps.sample(torch.from_numpy(starts),
                     u=torch.from_numpy(jax_uniforms(key, len(starts) * NW, 5)))
    np.testing.assert_array_equal(np.asarray(jp), p.numpy())
    if backend == "none":
        assert jd is None and d is None
    else:
        assert d.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(jd), d.numpy())
        # and the k-hop backend's on the same walks
        _, dk = PathSampler.build(g, NW, 5, device="cpu").sample(
            torch.from_numpy(starts), u=torch.from_numpy(jax_uniforms(key, len(starts) * NW, 5)))
        assert torch.equal(dk, d)


@pytest.fixture(scope="module")
def jcornell():
    return graph_pair("cornell")[0]


@pytest.mark.parametrize("dropout", [0.0, 0.7])
def test_hetero_wl5_logits_and_grads_match_jax(jcornell, dropout):
    """One batch of 40 targets at wl = 5 (JAX's khop walks and distances):
    five distance transforms, logits and loss within 1e-5, every gradient
    within atol 1e-5 + rtol 1e-4 of ``jax.grad``."""
    jspec, params, spec, model, X, paths, dists, y, idx = setup(jcornell, 5, dropout)
    assert paths.shape[2] == 5 and dists.max() == 4 and len(model.nets) == 5
    key = jax.random.PRNGKey(7) if dropout > 0 else None
    args = (jnp.asarray(X), jnp.asarray(paths[idx]), jnp.asarray(dists[idx]),
            jnp.asarray(idx), jnp.asarray(y[idx]), jspec, key)
    jloss, jgrads = jax.value_and_grad(_loss_fn)(params, *args)
    jlogits = pagg_forward(params, *args[:4], jspec, train=True, key=key)
    masks = jax_masks(key, jspec, len(idx)) if key is not None else None
    logits = model(torch.from_numpy(X), torch.from_numpy(paths[idx]),
                   torch.from_numpy(dists[idx]), torch.from_numpy(idx), train=True, masks=masks)
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(y[idx]).long())
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=1e-5, rtol=0)
    grads = params_to_jax({k: p.grad for k, p in model.named_parameters()}, spec)
    assert grads["dist"]["w"].shape[0] == 5
    assert_grads_close(jgrads, grads)


@pytest.mark.parametrize("dropout", [0.0, 0.7])
def test_homo_wl5_logits_and_grads_match_jax(jcornell, dropout):
    F, H, T = 24, 16, 40
    jspec, params, spec, model = homo_model(F, H, 5, 11, dropout)
    rng = np.random.default_rng(12)
    X = rng.normal(size=(jcornell.n, F)).astype(np.float32)
    paths, dists = jax_khop_walks(jcornell, 5, 13)
    y = rng.integers(0, 5, size=jcornell.n).astype(np.int32)
    idx = np.sort(rng.choice(jcornell.n, T, replace=False)).astype(np.int32)
    key = jax.random.PRNGKey(7) if dropout > 0 else None
    args = (jnp.asarray(X), jnp.asarray(paths[idx]), jnp.asarray(dists[idx]),
            jnp.asarray(idx), jnp.asarray(y[idx]), jspec, key)
    jloss, jgrads = jax.value_and_grad(_loss_fn)(params, *args)
    jlogits = pagg_forward(params, *args[:4], jspec, train=True, key=key)
    masks = jax_masks(key, jspec, T) if key is not None else None
    logits = model(torch.from_numpy(X), torch.from_numpy(paths[idx]),
                   torch.from_numpy(dists[idx]), torch.from_numpy(idx), train=True, masks=masks)
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(y[idx]).long())
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=1e-5, rtol=0)
    assert_grads_close(jgrads, params_to_jax(
        {k: p.grad for k, p in model.named_parameters()}, spec))


def test_cli_runs_wl5_through_the_khop_backend_on_the_host(cornell_root, capsys,  # noqa: F811
                                                           monkeypatch):
    """``-wl 5`` on cornell through the CLI: one round of 3 epochs on the
    host, the sampler on the khop backend, the round checkpointed under the
    JAX package's ``wl5`` key and the result line in JAX's format."""
    backends = []
    real = trainer.PathSampler.build
    monkeypatch.setattr(trainer.PathSampler, "build", staticmethod(
        lambda *a, **k: (lambda ps: backends.append((ps.backend, ps.walk_len)) or ps)(
            real(*a, **k))))
    agg = run.main(["-data", "cornell", "-pr", str(cornell_root), "-e", "3", "-r", "1",
                    "-hid", "8", "-nw", "4", "-wl", "5", "--device", "cpu",
                    "--results-dir", str(cornell_root / "res"),
                    "--ckpt-dir", str(cornell_root / "ck"), "--resume"])
    assert backends == [("khop", 5)]
    line = j_format_result_line("cornell", agg)
    assert line in capsys.readouterr().out
    assert line in (cornell_root / "res" / "result_for_cornell.txt").read_text()
    fp = registry.payload_fingerprint(registry.DATASETS["cornell"])
    assert completed_rounds(str(cornell_root / "ck"),
                            f"cornell.{fp}.e3.h8.s0.nw4.wl5.dr0.7.merw.lstm.attention") == 1
