"""The baseline zoo's graphs, ops, init, LP / C&S, round and CLI against the JAX package.

``build_baseline_graphs`` bit-equal to JAX's (``src``, ``dst``, ``w``) for
every name; the plain ``spmm`` (single- and multi-head) and
``segment_softmax`` and their gradients within 1e-5 of JAX's ops and
``jax.vjp`` (an isolated node, an ``rw`` row of degree 0, F not a multiple
of 4); the init's tree, shapes and bounds against ``init_baseline``;
``label_propagation`` and ``correct_and_smooth`` within 1e-5; a short
dropout-free ``run_baseline_round`` from JAX's init equal to JAX's; the CLI's
``--model gcn`` and ``--model lp`` on the host under JAX's checkpoint key.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathnet_tpu.config import TrainConfig as JTrainConfig
from pathnet_tpu.data import Graph as JGraph
from pathnet_tpu.models.baselines import cs as jcs
from pathnet_tpu.models.baselines import ops as jops
from pathnet_tpu.models.baselines import zoo as jzoo
from pathnet_tpu.train.baseline_trainer import run_baseline_round as j_run_baseline_round

from pathnet_tpu_torch import run
from pathnet_tpu_torch.config import TrainConfig
from pathnet_tpu_torch.data import Graph
from pathnet_tpu_torch.data import registry
from pathnet_tpu_torch.models.baselines import (BASELINES, EXTRA_MODELS, Baseline,
                                                BaselineSpec, EdgeGraph,
                                                baseline_params_from_jax,
                                                baseline_params_to_jax,
                                                build_baseline_graphs, segment_softmax, spmm)
from pathnet_tpu_torch.models.baselines.cs import correct_and_smooth, label_propagation
from pathnet_tpu_torch.train import baseline_trainer
from pathnet_tpu_torch.train.checkpoint import completed_rounds, load_round
from test_torch_train_loop import CORNELL, cornell_root  # noqa: F401 (a fixture)

NAMES = BASELINES + EXTRA_MODELS


def port_graph(jg):
    return Graph(n=jg.n, src=np.asarray(jg.src), dst=np.asarray(jg.dst),
                 prob=np.asarray(jg.prob))


@pytest.fixture(scope="module")
def graphs(small_graph):
    """The suite's 60-node graph and cornell, each with two isolated nodes."""
    out = {}
    for key, jg in (("small", small_graph), ("cornell", JGraph.from_edge_input(CORNELL))):
        out[key] = JGraph(n=jg.n + 2, src=jg.src, dst=jg.dst, prob=jg.prob)
    return out


@pytest.mark.parametrize("which", ["small", "cornell"])
@pytest.mark.parametrize("name", NAMES)
def test_build_baseline_graphs_equal_jax(graphs, which, name):
    jg = graphs[which]
    want = jzoo.build_baseline_graphs(jg, name)
    got = build_baseline_graphs(port_graph(jg), name, "cpu")
    assert set(got) == set(want)
    for k, eg in want.items():
        assert got[k].n == eg.n
        for f in ("src", "dst", "w"):
            a, b = getattr(got[k], f).numpy(), np.asarray(getattr(eg, f))
            assert a.dtype == b.dtype and np.array_equal(a, b), (k, f)


def jax_edge_graph(jg, norm, loops):
    return jops.EdgeGraph.from_graph(jg, norm=norm, add_self_loops=loops)


@pytest.mark.parametrize("F", [7, 16])
@pytest.mark.parametrize("norm,loops", [("sym", True), ("rw", False), ("none", False)])
def test_plain_spmm_and_its_gradients_match_jax(graphs, norm, loops, F):
    jg = graphs["small"]
    jeg = jax_edge_graph(jg, norm, loops)
    eg = EdgeGraph.from_graph(port_graph(jg), norm, loops, device="cpu")
    rng = np.random.default_rng(F)
    h = rng.normal(size=(jg.n, F)).astype(np.float32)
    g = rng.normal(size=(jg.n, F)).astype(np.float32)
    want, vjp = jax.vjp(lambda a, w: jops.spmm(jeg, a, w), jnp.asarray(h), jeg.w)
    dh_want, dw_want = vjp(jnp.asarray(g))
    ht = torch.from_numpy(h).requires_grad_()
    wt = eg.w.clone().requires_grad_()
    out = spmm(eg, ht, wt)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(dh_want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(dw_want), atol=1e-5, rtol=0)
    if not loops:
        assert not out[-2:].any()   # the isolated nodes


@pytest.mark.parametrize("heads,hdim", [(1, 5), (3, 5), (4, 8)])
def test_plain_multihead_spmm_matches_jax(graphs, heads, hdim):
    """GAT's per-head message sum, ``segment_sum(z[src] * alpha[:, :, None])``."""
    jg = graphs["cornell"]
    jeg = jax_edge_graph(jg, "none", True)
    eg = EdgeGraph.from_graph(port_graph(jg), "none", True, device="cpu")
    rng = np.random.default_rng(heads)
    E = eg.num_edges
    z = rng.normal(size=(jg.n, heads, hdim)).astype(np.float32)
    a = rng.random(size=(E, heads)).astype(np.float32)
    g = rng.normal(size=(jg.n, heads, hdim)).astype(np.float32)

    def f(zz, aa):
        return jax.ops.segment_sum(zz[jeg.src] * aa[:, :, None], jeg.dst, num_segments=jeg.n)

    want, vjp = jax.vjp(f, jnp.asarray(z), jnp.asarray(a))
    dz_want, da_want = vjp(jnp.asarray(g))
    zt, at = torch.from_numpy(z).requires_grad_(), torch.from_numpy(a).requires_grad_()
    out = spmm(eg, zt, at)
    out.backward(torch.from_numpy(g))
    for got, w in ((out.detach(), want), (zt.grad, dz_want), (at.grad, da_want)):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=1e-5, rtol=0)


@pytest.mark.parametrize("heads", [1, 3])
def test_plain_segment_softmax_and_its_gradient_match_jax(graphs, heads):
    jg = graphs["cornell"]
    jeg = jax_edge_graph(jg, "none", True)
    eg = EdgeGraph.from_graph(port_graph(jg), "none", True, device="cpu")
    rng = np.random.default_rng(heads)
    s = (3 * rng.normal(size=(eg.num_edges, heads))).astype(np.float32)
    g = rng.normal(size=(eg.num_edges, heads)).astype(np.float32)

    def f(x):
        return jax.vmap(lambda c: jops.segment_softmax(c, jeg.dst, jeg.n),
                        in_axes=1, out_axes=1)(x)

    want, vjp = jax.vjp(f, jnp.asarray(s))
    (ds_want,) = vjp(jnp.asarray(g))
    st = torch.from_numpy(s).requires_grad_()
    out = segment_softmax(eg, st)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=1e-6, rtol=0)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(ds_want), atol=1e-5, rtol=0)


def leaf_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in sorted(tree.items()):
            yield from leaf_paths(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaf_paths(v, prefix + (i,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("name", NAMES)
def test_init_has_jaxs_tree_shapes_and_bounds(name):
    kw = dict(name=name, feat_dim=24, hidden=16, out_dim=5, heads=4, n_nodes=50)
    want = jzoo.init_baseline(jax.random.PRNGKey(0), jzoo.BaselineSpec(**kw))
    spec = BaselineSpec(**kw)
    got = baseline_params_to_jax(Baseline(spec, device="cpu").state_dict(), spec)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    linear = {p[:-1] for p, _ in leaf_paths(want) if p[-1] == "w"}
    for (path, a), (_, b) in zip(leaf_paths(got), leaf_paths(want)):
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if path[:-1] in linear:
            bound = 1.0 / math.sqrt(_fan_in(want, path))
        elif path[-1] in ("a_src", "a_dst"):
            bound = 1.0 / math.sqrt(a.shape[1])
        elif path[-1] == "w_nodes":
            bound = 1.0 / math.sqrt(50)
        else:   # batch norms, GIN's eps, GPRGNN's gamma, LINK's bias, LP's dummy
            np.testing.assert_array_equal(a, b)
            continue
        assert np.abs(a).max() <= bound and np.abs(a).max() > bound / 4, path


def _fan_in(tree, path):
    node = tree
    for p in path[:-1]:
        node = node[p]
    return np.asarray(node["w"]).shape[0]


def test_label_propagation_and_correct_and_smooth_match_jax(graphs):
    jg = graphs["small"]
    jeg = jax_edge_graph(jg, "sym", True)
    eg = EdgeGraph.from_graph(port_graph(jg), "sym", True, device="cpu")
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 3, size=jg.n)
    y1 = np.eye(3, dtype=np.float32)[labels]
    tr = rng.random(jg.n) < 0.5
    soft = rng.dirichlet(np.ones(3), size=jg.n).astype(np.float32)
    want_lp = jcs.label_propagation(jeg, jnp.asarray(y1), jnp.asarray(tr))
    want_cs = jcs.correct_and_smooth(jeg, jnp.asarray(soft), jnp.asarray(y1), jnp.asarray(tr))
    got_lp = label_propagation(eg, torch.from_numpy(y1), torch.from_numpy(tr))
    got_cs = correct_and_smooth(eg, torch.from_numpy(soft), torch.from_numpy(y1),
                                torch.from_numpy(tr))
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_cs.numpy(), np.asarray(want_cs), atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ["mlp", "gcn", "gat", "lp"])
def test_a_round_from_jaxs_init_equals_jaxs_round(small_graph, monkeypatch, name):
    """Dropout 0, 15 epochs, JAX's init params: ``best_val_acc`` and the five
    test metrics equal JAX's."""
    jg = small_graph
    kw = dict(name=name, feat_dim=jg.features.shape[1], hidden=16, out_dim=3, heads=2,
              dropout=0.0, n_nodes=jg.n)
    jspec, spec = jzoo.BaselineSpec(**kw), BaselineSpec(**kw)
    rng = np.random.default_rng(1)
    perm = rng.permutation(jg.n)
    masks = [np.zeros(jg.n, bool) for _ in range(3)]
    for m, part in zip(masks, np.split(perm, [30, 45])):
        m[part] = True
    want = j_run_baseline_round(jg, jspec, JTrainConfig(lr=0.01, epochs=15), *masks, 3, seed=2)
    kinit = jax.random.split(jax.random.PRNGKey(2))[0]
    sd = baseline_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jzoo.init_baseline(kinit, jspec)), spec)
    real = baseline_trainer.Baseline

    def from_jax(*a, **k):
        m = real(*a, **k)
        m.load_state_dict(sd)
        return m

    monkeypatch.setattr(baseline_trainer, "Baseline", from_jax)
    g = Graph(n=jg.n, src=jg.src, dst=jg.dst, prob=jg.prob, features=jg.features,
              labels=jg.labels)
    got = baseline_trainer.run_baseline_round(g, spec, TrainConfig(lr=0.01, epochs=15), *masks,
                                              3, seed=2, device="cpu")
    assert got.best_val_acc == want.best_val_acc
    assert got.metrics == want.metrics


def test_specs_refuse_unknown_names_and_bf16():
    """Unknown names and dtypes raise; bf16 is ported (the name stays from
    when it was refused)."""
    with pytest.raises(ValueError, match="unknown baseline"):
        BaselineSpec(name="gcn2", feat_dim=4, hidden=4, out_dim=2).check_ported()
    BaselineSpec(name="gcn", feat_dim=4, hidden=4, out_dim=2,
                 compute_dtype="bfloat16").check_ported()
    with pytest.raises(ValueError, match="compute_dtype"):
        BaselineSpec(name="gcn", feat_dim=4, hidden=4, out_dim=2,
                     compute_dtype="float16").check_ported()
    with pytest.raises(ValueError, match="unknown baseline"):
        run.main(["-data", "cornell", "--model", "gcn2"])


@pytest.mark.parametrize("model", ["gcn", "lp"])
def test_cli_runs_a_short_baseline_protocol_on_the_host(cornell_root, capsys, model):
    """``--model`` through the CLI: one round of 2 epochs on the host,
    checkpointed under the JAX CLI's key, the model's name in the result
    line; a second run resumes the round."""
    argv = ["-data", "cornell", "-pr", str(cornell_root), "-e", "2", "-r", "1", "-hid", "8",
            "--model", model, "--device", "cpu", "--results-dir", str(cornell_root / "res"),
            "--ckpt-dir", str(cornell_root / "ck"), "--resume"]
    agg = run.main(argv)
    assert 0.0 <= agg["accuracy"][0] <= 1.0
    out = capsys.readouterr().out
    assert f"{model} Avg for cornell: acc" in out
    fp = registry.payload_fingerprint(registry.DATASETS["cornell"])
    key = f"cornell.{model}.{fp}.e2.h8.s0.dr0.7"
    assert completed_rounds(str(cornell_root / "ck"), key) == 1
    meta = load_round(str(cornell_root / "ck"), key, 0)["meta"]
    assert run.main(argv)["accuracy"][0] == meta["metrics"]["accuracy"]
    assert "round 0: resumed" in capsys.readouterr().out
