"""Every model of the baseline zoo at bf16 against the JAX package, on the host.

After ``baseline_params_from_jax``, on the suite's 60-node graph for all 18
names (and on cornell at 8 heads for the models whose edges carry weights
with a gradient):

- each model's bf16 logits and gradients: within the larger of
  ``LOGIT_ULPS`` bf16 ulps of JAX's largest logit (gradients:
  ``GRAD_ULPS`` of each leaf's largest entry, or of its weight's for the
  bias of a linear that feeds a batch norm, whose gradient cancels) and
  ``F32_GAPS`` times JAX's own f32-to-bf16 gap, against JAX's eager
  ``baseline_forward`` (stateless batch norm in bf16) and
  ``baseline_forward_stateful`` with JAX's keep masks (f32 batch norm); the
  running statistics within **1e-6**; the parameters and their gradients
  stay f32. LP at bf16 is held against JAX's LP written out with JAX's ops
  (:func:`jax_lp_bf16`): JAX's own raises, since its ``fori_loop`` carries
  the bf16 labels into an f32 sum.

Measured on the host (JAX 0.9, these cases): the logits within 0.22 of
their limit (most bit for bit: what follows an f32 ``spmm`` is f32 on both
sides), the gradients within 0.67 of theirs (GAT without dropout: the
second layer's ``a_src`` lies 10.8 ulps of its largest entry from JAX's,
which lies only 5e-5 from its own f32 gradient; the port's lies 2.8e-4
from it, about as far as an op-by-op softmax VJP lies).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from pathnet_tpu.data import Graph as JGraph
from pathnet_tpu.models.baselines import ops as jops
from pathnet_tpu.models.baselines import zoo as jzoo

from pathnet_tpu_torch.models.baselines import (Baseline, BaselineSpec, baseline_params_from_jax,
                                                baseline_params_to_jax, bn_state_to_jax,
                                                build_baseline_graphs)
from test_torch_baseline_bf16 import BF, NAMES, ULP, cornell, port_graph, within_gap  # noqa: F401
from test_torch_train_loop import CORNELL

LOGIT_ULPS, GRAD_ULPS, F32_GAPS = 2, 16, 3
DROPOUT = 0.5


def bf16_case(jg, name, F_, H, C, heads, seed):
    """JAX's bf16 spec, params, graphs and inputs, and the port's bf16
    model holding the same params."""
    n = jg.n
    kw = dict(name=name, feat_dim=F_, hidden=H, out_dim=C, heads=heads, dropout=DROPOUT,
              n_nodes=n, compute_dtype="bfloat16")
    jspec, spec = jzoo.BaselineSpec(**kw), BaselineSpec(**kw)
    params = jzoo.init_baseline(jax.random.PRNGKey(seed), jspec)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, C, size=n)
    X = (np.eye(C, dtype=np.float32)[labels] if name == "lp"
         else rng.normal(size=(n, F_)).astype(np.float32))
    model = Baseline(spec, device="cpu")
    model.load_state_dict(baseline_params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                                   spec))
    return (jspec, params, jzoo.build_baseline_graphs(jg, name), X, labels, model,
            build_baseline_graphs(port_graph(jg), name, "cpu"))


def jax_masks(key):
    keys = jax.random.split(key, 16)

    def mask(i, shape, device):
        return torch.from_numpy(np.array(jax.random.bernoulli(keys[i], 1.0 - DROPOUT, shape)))
    return mask


def feeds_batch_norm(path, params) -> bool:
    """Whether ``path`` (in JAX's params) is the bias of a linear whose
    output a batch norm of its layer normalizes."""
    keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
    if "bns" not in params or keys[-1] != "b":
        return False
    if keys[0] in ("lins", "lin_l", "lin_r", "hop_lins"):
        return keys[1] < len(params["bns"])
    return keys[0] == "mlps" and keys[2] == "l2"


def jax_lp_bf16(params, jspec, X, jgraphs):
    """JAX's MultiLP (``zoo.py:476-491``) at bf16 with its loop written out:
    JAX's ``fori_loop`` refuses the bf16 one-hot labels as a carry that the
    f32 ``spmm`` promotes (``test_jax_refuses_lp_at_bf16``)."""
    eg = jgraphs["symnl"]
    y0 = res = jnp.asarray(X).astype(BF)
    for _ in range(50):
        for _ in range(jspec.k_hops):
            res = jops.spmm(eg, res)
        res = jspec.alpha * res + (1 - jspec.alpha) * y0
    return (res + 0.0 * params["dummy"].astype(BF)[0]).astype(jnp.float32)


def jax_forward(params, jspec, X, jgraphs, bn_state, train=False, key=None):
    """``baseline_forward_stateful``, or :func:`jax_lp_bf16` for LP at bf16."""
    if jspec.name == "lp" and jspec.compute_dtype == "bfloat16":
        return jax_lp_bf16(params, jspec, X, jgraphs), []
    return jzoo.baseline_forward_stateful(params, jspec, jnp.asarray(X), jgraphs, bn_state,
                                          train=train, key=key)


def test_jax_refuses_lp_at_bf16():
    jg = JGraph.from_edge_input(CORNELL)
    jspec = jzoo.BaselineSpec(name="lp", feat_dim=5, hidden=8, out_dim=5,
                              compute_dtype="bfloat16")
    X = jnp.eye(5)[np.arange(jg.n) % 5]
    with pytest.raises(TypeError, match="carry"):
        jzoo.baseline_forward(jzoo.init_baseline(jax.random.PRNGKey(0), jspec), jspec, X,
                              jzoo.build_baseline_graphs(jg, "lp"))


def check_bf16_logits(case):
    """The stateless logits (train-mode batch statistics, no dropout)
    against ``baseline_forward`` at bf16; returns (error, limit)."""
    jspec, params, jgraphs, X, _, model, graphs = case
    want = jax_forward(params, jspec, X, jgraphs, None)[0]
    want32 = jax_forward(params, dataclasses.replace(jspec, compute_dtype="float32"), X,
                         jgraphs, None)[0]
    with torch.no_grad():
        got = model(torch.from_numpy(X), graphs, train=True)
    assert got.dtype == torch.float32
    return within_gap(got, want, want32, LOGIT_ULPS, F32_GAPS)


def check_bf16_step(case, key):
    """One training step's loss, logits and every gradient against
    ``jax.grad`` at bf16: without ``key`` the stateless forward
    (``baseline_forward``, batch norms in bf16), with it the stateful one
    from the initial running statistics with JAX's keep masks, whose
    advanced running statistics must agree within 1e-6. Returns the worst
    error over its limit."""
    jspec, params, jgraphs, X, labels, model, graphs = case
    jspec32 = dataclasses.replace(jspec, compute_dtype="float32")
    tr = np.arange(0, len(labels), 2)
    bn0 = jzoo.init_bn_state(params) if key is not None else None

    def loss_fn(p, spec):
        logits, new = jax_forward(p, spec, X, jgraphs, bn0, train=True, key=key)
        ce = optax.softmax_cross_entropy_with_integer_labels(
            logits[tr], jnp.asarray(labels)[tr]).mean()
        return ce, (logits, new)

    (_, (want_logits, want_bn)), want = jax.value_and_grad(loss_fn, has_aux=True)(params, jspec)
    (_, (want_logits32, _)), want32 = jax.value_and_grad(loss_fn, has_aux=True)(params, jspec32)
    logits = model(torch.from_numpy(X), graphs, train=True,
                   masks=None if key is None else jax_masks(key))
    F.cross_entropy(logits[tr], torch.from_numpy(labels)[tr]).backward()
    ratios = [np.divide(*within_gap(logits, want_logits, want_logits32, LOGIT_ULPS, F32_GAPS))]
    assert all(p.dtype == torch.float32 for p in model.parameters())
    grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
             for k, p in model.named_parameters()}
    assert all(g.dtype == torch.float32 for g in grads.values())
    got = baseline_params_to_jax(grads, model.spec)
    leaves = jax.tree_util.tree_leaves_with_path
    flat32, flat = dict(leaves(want32)), dict(leaves(want))
    for (path, a), (_, b) in zip(leaves(got), leaves(want)):
        scale = np.abs(np.asarray(b)).max()
        if feeds_batch_norm(path, params):
            # a batch norm takes the mean over the nodes out of the bias,
            # whose gradient cancels to rounding noise; its summands are
            # those of its weight's gradient
            weight = flat[path[:-1] + (jax.tree_util.DictKey("w"),)]
            scale = max(scale, np.abs(np.asarray(weight)).max())
        err = float(np.abs(np.asarray(a) - np.asarray(b)).max())
        limit = max(GRAD_ULPS * ULP * scale,
                    F32_GAPS * float(np.abs(np.asarray(flat32[path]) - np.asarray(b)).max()))
        ratios.append(err / limit if limit > 0 else (0.0 if err == 0 else np.inf))
    if key is not None:
        for a, b in zip(bn_state_to_jax(model.state_dict()), want_bn):
            for k in ("mean", "var"):
                np.testing.assert_allclose(a[k], np.asarray(b[k]), atol=1e-6, rtol=0)
    return max(ratios)


@pytest.mark.parametrize("name", NAMES)
def test_bf16_logits_match_baseline_forward(small_graph, name):
    err, limit = check_bf16_logits(bf16_case(small_graph, name, 16, 8, 3, 2, seed=1))
    assert err <= limit


@pytest.mark.parametrize("dropout", ["off", "jax masks"])
@pytest.mark.parametrize("name", NAMES)
def test_bf16_step_matches_jax_grad(small_graph, name, dropout):
    case = bf16_case(small_graph, name, 16, 8, 3, 2, seed=2)
    assert check_bf16_step(case, None if dropout == "off" else jax.random.PRNGKey(5)) <= 1.0


@pytest.mark.parametrize("name", ["gat", "gatjk", "fagcn", "link"])
def test_bf16_step_matches_jax_grad_on_cornell_at_eight_heads(cornell, name):
    case = bf16_case(cornell, name, 20, 8, 5, 8, seed=3)
    assert check_bf16_step(case, jax.random.PRNGKey(6)) <= 1.0
