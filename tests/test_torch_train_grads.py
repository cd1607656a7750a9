"""Port vs JAX in training: loss, logits and every gradient against
``jax.grad`` of the JAX trainer's loss, microbatch accumulation, and Adam.

The port's gradients are compared in the JAX layout (``params_to_jax``).
Dropout: JAX draws its two masks from ``split(key)`` inside
``pagg_forward``; the test draws the same masks from the same keys and hands
them to the port.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathnet_tpu.data import Graph as JGraph
from pathnet_tpu.models import PaggSpec as JPaggSpec
from pathnet_tpu.models import init_pagg_params, pagg_forward
from pathnet_tpu.sample import PathSampler as JPathSampler
from pathnet_tpu.train.trainer import _chunked_grads, _loss_fn
from pathnet_tpu.train.trainer import _pad_chunks as j_pad_chunks
from pathnet_tpu.train.trainer import make_optimizer as j_make_optimizer

from pathnet_tpu_torch.models import PaggSpec, PathNet, params_from_jax, params_to_jax
from pathnet_tpu_torch.train.trainer import _pad_chunks, chunk_index, chunked_grads
from pathnet_tpu_torch.train.trainer import make_optimizer

ROOT = os.path.join(os.path.dirname(__file__), "..")
CORNELL = os.path.join(ROOT, "data", "edge_input", "cornell.in")
H, NW, F, C, T = 16, 6, 24, 5, 40


@pytest.fixture(scope="module")
def cornell():
    return JGraph.from_edge_input(CORNELL)


def setup(g, wl, dropout, gather_mode="auto", seed=0):
    """JAX params and spec, the port's model with the same params, and one
    batch: X, all nodes' walks, targets and labels (numpy)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(g.n, F)).astype(np.float32)
    paths, dists = JPathSampler.build(g, NW, wl).sample(jax.random.PRNGKey(seed))
    y = rng.integers(0, C, size=g.n).astype(np.int32)
    idx = np.sort(rng.choice(g.n, T, replace=False)).astype(np.int32)
    jspec = JPaggSpec(feat_dim=F, hidden=H, out_dim=C, walk_len=wl, dropout=dropout,
                      gather_mode=gather_mode)
    params = init_pagg_params(jax.random.PRNGKey(seed + 1), jspec)
    spec = PaggSpec(feat_dim=F, hidden=H, out_dim=C, walk_len=wl, dropout=dropout,
                    gather_mode=gather_mode)
    model = PathNet(spec, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                         spec), strict=True)
    return jspec, params, spec, model, X, np.array(paths), np.array(dists), y, idx


def jax_masks(key, spec, T_):
    """The masks ``pagg_forward`` draws from ``key`` (pagg.py:142-147,207)."""
    k1, k2 = jax.random.split(key)
    keep = 1.0 - spec.dropout
    m1 = jax.random.bernoulli(k1, keep, (spec.walk_len, T_ * NW, spec.hidden))
    m2 = jax.random.bernoulli(k2, keep, (T_, 2 * spec.hidden))
    return (torch.from_numpy(np.asarray(m1).astype(np.uint8)),
            torch.from_numpy(np.asarray(m2).astype(np.uint8)))


def assert_grads_close(jgrads, tgrads, atol=1e-5, rtol=1e-4):
    for path, leaf in jax.tree_util.tree_leaves_with_path(jgrads):
        a, b = path[0].key, path[1].key
        np.testing.assert_allclose(tgrads[a][b], np.asarray(leaf), atol=atol, rtol=rtol,
                                   err_msg=f"{a}.{b}")


@pytest.mark.parametrize("wl,dropout,gather_mode", [(3, 0.0, "x"), (3, 0.7, "h"),
                                                    (4, 0.0, "h"), (4, 0.7, "x")])
def test_loss_logits_and_grads_match_jax_grad(cornell, wl, dropout, gather_mode):
    """One batch through ``jax.grad(_loss_fn)`` (JAX's default dist_mode
    "onehot") and through the port's autograd: logits and loss within 1e-5,
    each gradient within atol 1e-5 + rtol 1e-4. JAX's "x" and "h" gather
    modes compute the same gradient; the port has one."""
    jspec, params, spec, model, X, paths, dists, y, idx = setup(cornell, wl, dropout,
                                                                gather_mode)
    key = jax.random.PRNGKey(7) if dropout > 0 else None
    args = (jnp.asarray(X), jnp.asarray(paths[idx]), jnp.asarray(dists[idx]),
            jnp.asarray(idx), jnp.asarray(y[idx]), jspec, key)
    jloss, jgrads = jax.value_and_grad(_loss_fn)(params, *args)
    jlogits = pagg_forward(params, *args[:4], jspec, train=True, key=key)
    masks = jax_masks(key, jspec, T) if key is not None else None
    logits = model(torch.from_numpy(X), torch.from_numpy(paths[idx]),
                   torch.from_numpy(dists[idx]), torch.from_numpy(idx),
                   train=True, masks=masks)
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(y[idx]).long())
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=1e-5, rtol=0)
    assert_grads_close(jgrads, params_to_jax(
        {k: p.grad for k, p in model.named_parameters()}, spec))


def test_params_to_jax_inverts_params_from_jax(cornell):
    jspec, params, spec, model, *_ = setup(cornell, 4, 0.7)
    back = params_to_jax(model.state_dict(), spec)
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        a, b = path[0].key, path[1].key
        assert np.array_equal(back[a][b], np.asarray(leaf)), (a, b)


@pytest.mark.parametrize("microbatch", [7, 16])
def test_microbatch_accumulation_is_exact(cornell, microbatch):
    """The port's chunked grads equal its full-batch grads to 1e-6, and the
    JAX trainer's ``_chunked_grads`` to 1e-5 (dropout off)."""
    jspec, params, spec, model, X, paths, dists, y, idx = setup(cornell, 4, 0.0)
    mask = np.zeros(cornell.n, bool)
    mask[idx] = True
    tX, ty = torch.from_numpy(X), torch.from_numpy(y).long()
    tp, td = torch.from_numpy(paths), torch.from_numpy(dists)
    grads = []
    for mb in (None, microbatch):
        ic, wc, total = chunk_index(mask, mb, torch.device("cpu"))
        chunked_grads(model, tX, ty, tp, td, ic, wc, total)
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()})
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], atol=1e-6, rtol=1e-6, msg=k)
    jic, jwc = j_pad_chunks(idx, microbatch)
    pic, pwc = _pad_chunks(idx, microbatch)
    assert np.array_equal(jic, pic) and np.array_equal(jwc, pwc)
    jgrads = _chunked_grads(params, jnp.asarray(X), jnp.asarray(paths), jnp.asarray(dists),
                            jnp.asarray(jic), jnp.asarray(y), jnp.asarray(jwc), jspec,
                            jax.random.PRNGKey(0))
    assert_grads_close(jgrads, params_to_jax(grads[1], spec))


def test_adam_step_matches_optax():
    """Two steps of ``make_optimizer`` (optax: additive L2, Adam, -lr) against
    ``torch.optim.Adam(lr, weight_decay)``: params and both moments to 1e-6."""
    jspec = JPaggSpec(feat_dim=F, hidden=H, out_dim=C, walk_len=4)
    spec = PaggSpec(feat_dim=F, hidden=H, out_dim=C, walk_len=4)
    params = init_pagg_params(jax.random.PRNGKey(3), jspec)
    model = PathNet(spec, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params), spec))
    rng = np.random.default_rng(0)
    jopt = j_make_optimizer(0.005, 0.0005)
    state = jopt.init(params)
    opt = make_optimizer(model.parameters(), 0.005, 0.0005)
    for _ in range(2):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32)), params)
        updates, state = jopt.update(grads, state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        tg = params_from_jax(jax.tree_util.tree_map(np.asarray, grads), spec)
        for k, p in model.named_parameters():
            p.grad = tg[k].clone()
        opt.step()
    names = dict(model.named_parameters())
    adam = state[1]
    for jtree, port in ((params, params_to_jax(model.state_dict(), spec)),
                        (adam.mu, params_to_jax({k: opt.state[p]["exp_avg"]
                                                 for k, p in names.items()}, spec)),
                        (adam.nu, params_to_jax({k: opt.state[p]["exp_avg_sq"]
                                                 for k, p in names.items()}, spec))):
        assert_grads_close(jtree, port, atol=1e-6, rtol=0)
