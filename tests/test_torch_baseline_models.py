"""Each model of the baseline zoo against the JAX package, on the host.

After ``baseline_params_from_jax``: the stateless eval logits within 1e-5 of
``baseline_forward``; one training forward's loss and every gradient within
atol 1e-5 + rtol 1e-4 of ``jax.grad`` of ``baseline_forward_stateful``
(batch norms in train mode from the initial running statistics), without
dropout and with JAX's own keep masks (``jax.random.split(key, 16)`` in
``_drop``'s call order), and the advanced running statistics within 1e-6.
On the suite's 60-node graph for all 18 names, and on cornell at 8 heads
for the models whose edges carry weights with a gradient.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from pathnet_tpu.data import Graph as JGraph
from pathnet_tpu.models.baselines import zoo as jzoo

from pathnet_tpu_torch.data import Graph
from pathnet_tpu_torch.models.baselines import (BASELINES, EXTRA_MODELS, Baseline,
                                                BaselineSpec, baseline_params_from_jax,
                                                baseline_params_to_jax, bn_state_to_jax,
                                                build_baseline_graphs)

CORNELL = os.path.join(os.path.dirname(__file__), "..", "data", "edge_input", "cornell.in")
NAMES = BASELINES + EXTRA_MODELS
DROPOUT = 0.5


def setup(jg, name, F_, H, C, heads, seed):
    """JAX spec, params, graphs and inputs, and the port's model loaded
    with the same params."""
    n = jg.n
    kw = dict(name=name, feat_dim=F_, hidden=H, out_dim=C, heads=heads, dropout=DROPOUT,
              n_nodes=n)
    jspec, spec = jzoo.BaselineSpec(**kw), BaselineSpec(**kw)
    params = jzoo.init_baseline(jax.random.PRNGKey(seed), jspec)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, C, size=n)
    X = (np.eye(C, dtype=np.float32)[labels] if name == "lp"
         else rng.normal(size=(n, F_)).astype(np.float32))
    g = Graph(n=n, src=jg.src, dst=jg.dst, prob=jg.prob)
    model = Baseline(spec, device="cpu")
    model.load_state_dict(baseline_params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                                   spec))
    return (jspec, params, jzoo.build_baseline_graphs(jg, name), X, labels, model,
            build_baseline_graphs(g, name, "cpu"))


def jax_masks(key):
    keys = jax.random.split(key, 16)

    def mask(i, shape, device):
        return torch.from_numpy(np.array(jax.random.bernoulli(keys[i], 1.0 - DROPOUT, shape)))
    return mask


def check_step(case, key):
    jspec, params, jgraphs, X, labels, model, graphs = case
    tr = np.arange(0, len(labels), 2)
    bn0 = jzoo.init_bn_state(params)

    def loss_fn(p):
        logits, new = jzoo.baseline_forward_stateful(p, jspec, jnp.asarray(X), jgraphs, bn0,
                                                     train=True, key=key)
        ce = optax.softmax_cross_entropy_with_integer_labels(
            logits[tr], jnp.asarray(labels)[tr]).mean()
        return ce, new

    (want_loss, want_bn), want = jax.value_and_grad(loss_fn, has_aux=True)(params)
    logits = model(torch.from_numpy(X), graphs, train=True,
                   masks=None if key is None else jax_masks(key))
    loss = F.cross_entropy(logits[tr], torch.from_numpy(labels)[tr])
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=1e-5, rtol=0)
    grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
             for k, p in model.named_parameters()}
    got = baseline_params_to_jax(grads, model.spec)
    flat_got, tree_got = jax.tree_util.tree_flatten(got)
    flat_want, tree_want = jax.tree_util.tree_flatten(want)
    assert tree_got == tree_want
    for a, b in zip(flat_got, flat_want):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=1e-4)
    for a, b in zip(bn_state_to_jax(model.state_dict()), want_bn):
        for k in ("mean", "var"):
            np.testing.assert_allclose(a[k], np.asarray(b[k]), atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def small(small_graph):
    return small_graph


@pytest.fixture(scope="module")
def cornell():
    return JGraph.from_edge_input(CORNELL)


@pytest.mark.parametrize("name", NAMES)
def test_logits_match_baseline_forward(small, name):
    jspec, params, jgraphs, X, _, model, graphs = setup(small, name, 16, 8, 3, 2, seed=1)
    want = np.asarray(jzoo.baseline_forward(params, jspec, jnp.asarray(X), jgraphs))
    with torch.no_grad():
        got = model(torch.from_numpy(X), graphs, train=True).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dropout", ["off", "jax masks"])
@pytest.mark.parametrize("name", NAMES)
def test_step_matches_jax_grad(small, name, dropout):
    case = setup(small, name, 16, 8, 3, 2, seed=2)
    check_step(case, None if dropout == "off" else jax.random.PRNGKey(5))


@pytest.mark.parametrize("name", ["gat", "gatjk", "fagcn", "link"])
def test_step_matches_jax_grad_on_cornell_at_eight_heads(cornell, name):
    case = setup(cornell, name, 20, 8, 5, 8, seed=3)
    check_step(case, jax.random.PRNGKey(6))


def test_eval_with_running_statistics_matches_jax(small):
    """After a training forward, eval mode normalizes with the advanced
    running statistics, as ``baseline_forward_stateful(train=False)``."""
    jspec, params, jgraphs, X, _, model, graphs = setup(small, "gcnjk", 16, 8, 3, 2, seed=4)
    _, bn1 = jzoo.baseline_forward_stateful(params, jspec, jnp.asarray(X), jgraphs,
                                            jzoo.init_bn_state(params), train=True)
    want, bn2 = jzoo.baseline_forward_stateful(params, jspec, jnp.asarray(X), jgraphs, bn1,
                                               train=False)
    with torch.no_grad():
        model(torch.from_numpy(X), graphs, train=True)
        got = model(torch.from_numpy(X), graphs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    for a, b in zip(bn_state_to_jax(model.state_dict()), bn2):
        np.testing.assert_allclose(a["var"], np.asarray(b["var"]), atol=1e-6, rtol=0)
