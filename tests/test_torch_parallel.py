"""The multi-device layer against the JAX package's on its 8-device virtual
CPU mesh: the ring and sparse exchanges, ``exchange_comm_words``,
``param_shardings``, ``sharded_train_step`` and ``make_sharded_predict``.

The port's side runs once, on 4 gloo ranks (``utils.force_cpu_devices``;
the rank functions are in ``torch_parallel_ranks.py``), as a 4 x 1 grid and
a 2 x 2 one; each test compares a part of what those ranks returned. The
sharded step takes JAX's own draws: the walk uniforms of ``kp`` and the
dropout masks of ``kd`` from ``split(key)``, as the JAX step draws them.
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
from pathnet_tpu.parallel import make_mesh
from pathnet_tpu.parallel import param_shardings as j_param_shardings
from pathnet_tpu.parallel import sharded_train_step as j_sharded_train_step
from pathnet_tpu.parallel.ring import make_ring_gather as j_ring
from pathnet_tpu.parallel.sparse import exchange_comm_words as j_comm_words
from pathnet_tpu.parallel.sparse import make_sparse_gather as j_sparse
from pathnet_tpu.parallel.sparse import make_sparse_gather_sharded as j_sparse_sharded
from pathnet_tpu.sample import PathSampler as JPathSampler
from pathnet_tpu.train import make_optimizer as j_make_optimizer
from pathnet_tpu.train.inference import make_sharded_predict as j_make_sharded_predict
from pathnet_tpu.train.trainer import _loss_fn

import torch_parallel_ranks as ranks
from pathnet_tpu_torch.models import PaggSpec, params_from_jax, params_to_jax
from pathnet_tpu_torch.parallel import (exchange_comm_words, param_shardings,
                                        shard_state_dict, unshard_state_dict)
from pathnet_tpu_torch.utils import force_cpu_devices

CORNELL = os.path.join(os.path.dirname(__file__), "..", "data", "edge_input", "cornell.in")
H, NW, F, C, WL = 16, 6, 24, 5, 4
SHAPES = ((4, 1), (2, 2))
T_TRAIN, T_VAL = 40, 24
STEP_CONFIGS = (((4, 1), "gspmd", True, False), ((4, 1), "ring", True, False),
                ((4, 1), "sparse", True, False), ((4, 1), "gspmd", False, False),
                ((2, 2), "gspmd", True, True), ((2, 2), "gspmd", True, False),
                ((2, 2), "sparse", True, True))
ENSEMBLE = 2


def jax_uniforms(key, walkers, wl):
    """The draws ``pathnet_tpu.sample.sample_paths`` makes under ``key``."""
    return np.stack([np.asarray(jax.random.uniform(k, (walkers,)))
                     for k in jax.random.split(key, wl - 1)])


def jax_masks(key, spec, t):
    """The dropout masks ``pagg_forward`` draws from ``key``."""
    k1, k2 = jax.random.split(key)
    keep = 1.0 - spec.dropout
    m1 = jax.random.bernoulli(k1, keep, (spec.walk_len, t * NW, spec.hidden))
    m2 = jax.random.bernoulli(k2, keep, (t, 2 * spec.hidden))
    return np.asarray(m1).astype(np.uint8), np.asarray(m2).astype(np.uint8)


def by_data_rank(results, shape, pick):
    """``pick(result)`` of each data-axis rank (model index 0), in order."""
    _, m = shape
    return [pick(r) for i, r in enumerate(results) if i % m == 0]


@pytest.fixture(scope="module")
def problem():
    jg = JGraph.from_edge_input(CORNELL)
    rng = np.random.default_rng(0)
    X = rng.normal(size=(jg.n, F)).astype(np.float32)
    y = rng.integers(0, C, size=jg.n).astype(np.int32)
    order = rng.permutation(jg.n).astype(np.int32)
    tr, va = order[:T_TRAIN], order[T_TRAIN:T_TRAIN + T_VAL]
    jspec = JPaggSpec(feat_dim=F, hidden=H, out_dim=C, walk_len=WL, dropout=0.7)
    params = init_pagg_params(jax.random.PRNGKey(3), jspec)
    spec = dict(feat_dim=F, hidden=H, out_dim=C, walk_len=WL, dropout=0.7)
    state = {k: v.numpy() for k, v in params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), PaggSpec(**spec)).items()}
    key = jax.random.PRNGKey(42)
    kp, kd = jax.random.split(key)
    return dict(jg=jg, X=X, y=y, tr=tr, va=va, jspec=jspec, params=params, spec=spec,
                state=state, key=key, kp=kp, kd=kd, order=order)


@pytest.fixture(scope="module")
def gather_inputs():
    h = np.array(jax.random.normal(jax.random.PRNGKey(0), (61, 16)))   # 61: not a multiple
    idx = np.array(jax.random.randint(jax.random.PRNGKey(1), (40, 5, 3), 0, 61), np.int32)
    w = np.array(jax.random.normal(jax.random.PRNGKey(2), (16,)))
    return h, idx, w


@pytest.fixture(scope="module")
def jax_gathers(gather_inputs):
    """Each JAX exchange on the 8-device mesh: its rows and the gradient of
    ``sum(rows * w)``, from one ``jax.vjp``."""
    h, idx, w = gather_inputs
    mesh = make_mesh(n_devices=8)
    out = {}
    for name, make in (("ring", j_ring), ("sparse", j_sparse),
                       ("sparse_sharded", j_sparse_sharded)):
        gather = make(mesh, "data")
        rows, vjp = jax.vjp(lambda a: gather(a, jnp.asarray(idx)), jnp.asarray(h))
        (grad,) = vjp(jnp.broadcast_to(jnp.asarray(w), rows.shape))
        out[name] = np.asarray(rows), np.asarray(grad)
    return out


@pytest.fixture(scope="module")
def port(problem, gather_inputs):
    """The port's side of every test in this file: one spawn of 4 gloo ranks."""
    p = problem
    step_prob = dict(edge=CORNELL, nw=NW, spec=p["spec"], state=p["state"], X=p["X"],
                     y=p["y"].astype(np.int64), train_idx=p["tr"], val_idx=p["va"],
                     u=jax_uniforms(p["kp"], p["jg"].n * NW, WL),
                     masks=jax_masks(p["kd"], p["jspec"], T_TRAIN), classes=C,
                     configs=STEP_CONFIGS)
    predict_prob = dict(edge=CORNELL, nw=NW, spec=p["spec"], state=p["state"], X=p["X"],
                        idx=p["order"][:32], u=jax_predict_draws(p["key"], 32 * NW))
    return force_cpu_devices(ranks.suite, 4, args=(
        (SHAPES, *gather_inputs), step_prob, predict_prob), timeout_s=240, threads=1)


def jax_predict_draws(key, walkers):
    """The uniforms JAX ``predict`` draws under ``key``: [E, wl - 1, walkers]."""
    return np.stack([jax_uniforms(k, walkers, WL) for k in jax.random.split(key, ENSEMBLE)])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", sorted(ranks.GATHERS))
def test_exchange_gathers_equal_take_and_jax(port, gather_inputs, jax_gathers, shape, name):
    """Each exchange's rows equal ``h[idx]`` and JAX's gather on the 8-device
    mesh bit for bit; the gradient of ``sum(rows * w)`` in ``h`` equals the
    plain scatter-add within atol 1e-6 + rtol 1e-6 (the ring adds each
    rank's part in ring order) and JAX's within 1e-5."""
    h, idx, w = gather_inputs
    want, jgrad = jax_gathers[name]
    parts = by_data_rank([r["gathers"] for r in port], shape, lambda r: r[shape, name])
    rows = (parts[0][0] if name == "sparse"
            else np.concatenate([p[0] for p in parts]))
    np.testing.assert_array_equal(rows, h[idx])
    np.testing.assert_array_equal(rows, want)
    grad = np.concatenate([p[1] for p in parts])[:h.shape[0]]
    th = torch.tensor(h, requires_grad=True)
    (th[torch.from_numpy(idx).long()] * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(grad, th.grad.numpy(), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(grad, jgrad, atol=1e-5, rtol=0)


@pytest.mark.parametrize("n,h,m,d", [(64000, 64, 64000 * 160 // 8, 8),
                                     (64000, 64, 256 * 160 // 8, 8), (10, 4, 3, 1),
                                     (63977, 64, 8192 * 160, 4), (183, 16, 7, 3)])
def test_exchange_comm_words_equal_jax(n, h, m, d):
    assert exchange_comm_words(n, h, m, d) == j_comm_words(n, h, m, d)


@pytest.mark.parametrize("rnn", ["lstm", "gru", "mlp"])
@pytest.mark.parametrize("model_axis", [2, 4])
def test_param_shardings_map_onto_jax_layout(problem, rnn, model_axis):
    """The same tensors are sharded as JAX shards, and rank j's shard of each
    torch ``[out, in]`` tensor is JAX's ``[..., in, out]`` leaf sliced on its
    last axis: JAX's shard converted with ``params_from_jax`` equals it."""
    jspec = JPaggSpec(feat_dim=F, hidden=12, out_dim=C, walk_len=3, rnn=rnn)
    spec = PaggSpec(feat_dim=F, hidden=12, out_dim=C, walk_len=3, rnn=rnn)
    params = jax.tree_util.tree_map(np.asarray, init_pagg_params(jax.random.PRNGKey(1), jspec))
    mesh = make_mesh(n_devices=8, model_axis=model_axis)
    jspecs = j_param_shardings(params, mesh)
    state = params_from_jax(params, spec)
    specs = param_shardings(state, model_axis)
    sharded_jax = {(top, leaf) for top, sub in jspecs.items() for leaf, s in sub.items()
                   if len(s) and s[-1] == "model"}
    assert sharded_jax, "JAX shards nothing"
    parts = []
    for j in range(model_axis):
        sliced = {top: {leaf: (v[..., j * (v.shape[-1] // model_axis):
                                  (j + 1) * (v.shape[-1] // model_axis)]
                               if (top, leaf) in sharded_jax else v)
                        for leaf, v in sub.items()} for top, sub in params.items()}
        want = params_from_jax(sliced, spec)
        got = shard_state_dict(state, specs, model_axis, j)
        assert got.keys() == want.keys()
        for k in got:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
        parts.append(got)
    # the sharded names are the torch names of JAX's sharded leaves
    n_sharded = sum(spec.walk_len if top == "dist" else 1 for top, _ in sharded_jax)
    assert sum(s is not None for s in specs.values()) == n_sharded
    back = unshard_state_dict(parts, specs)
    for k in state:
        assert torch.equal(back[k], state[k]), k


def jax_step(problem, shape, exchange, shard_features, shard_params):
    """JAX's sharded step on the virtual mesh: (loss, val_acc)."""
    p = problem
    d, m = shape
    mesh = make_mesh(n_devices=d * m, model_axis=m)
    opt = j_make_optimizer(0.005, 0.0005)
    ps = JPathSampler.build(p["jg"], NW, WL)
    Xp = jnp.pad(jnp.asarray(p["X"]), ((0, (-p["jg"].n) % 4), (0, 0)))
    step = j_sharded_train_step(mesh, p["jspec"], opt, C, shard_features=shard_features,
                                exchange=exchange, shard_params=shard_params,
                                params_example=p["params"] if shard_params else None)
    _, _, loss, acc = step(p["params"], opt.init(p["params"]), Xp, jnp.asarray(p["y"]), ps,
                           jnp.asarray(p["tr"]), jnp.asarray(p["va"]), p["key"])
    return float(loss), float(acc)


@pytest.fixture(scope="module")
def jax_reference(problem):
    """JAX's logits and ``jax.grad`` of its loss on the step's batch, walks
    and masks."""
    p = problem
    ps = JPathSampler.build(p["jg"], NW, WL)
    paths, dists = ps.sample(p["kp"])
    tr = jnp.asarray(p["tr"])
    args = (jnp.asarray(p["X"]), paths[tr], dists[tr], tr, jnp.asarray(p["y"])[tr],
            p["jspec"], p["kd"])
    loss, grads = jax.value_and_grad(_loss_fn)(p["params"], *args)
    logits = pagg_forward(p["params"], *args[:4], p["jspec"], train=True, key=p["kd"])
    return float(loss), np.asarray(logits), jax.tree_util.tree_map(np.asarray, grads)


@pytest.mark.parametrize("cfg", STEP_CONFIGS, ids=lambda c: f"{c[0][0]}x{c[0][1]}-{c[1]}"
                         f"{'-X' if c[2] else ''}{'-P' if c[3] else ''}")
def test_sharded_step_matches_jax(port, problem, jax_reference, cfg):
    """Logits within 1e-5 of JAX's, every summed gradient within atol 1e-5 +
    rtol 1e-4 of ``jax.grad``, the loss within 1e-5 and the validation
    accuracy (its count of correct targets) equal to JAX's
    ``sharded_train_step``'s on the same mesh shape."""
    shape = cfg[0]
    jloss, jlogits, jgrads = jax_reference
    got = [r["steps"][cfg] for r in port]
    logits = np.concatenate(by_data_rank(got, shape, lambda r: r["logits"]))
    np.testing.assert_allclose(logits, jlogits, atol=1e-5, rtol=0)
    assert all(abs(r["loss"] - jloss) < 1e-5 for r in got)
    grads = params_to_jax({k: torch.from_numpy(v) for k, v in got[0]["grads"].items()},
                          PaggSpec(**problem["spec"]))
    for path, leaf in jax.tree_util.tree_leaves_with_path(jgrads):
        a, b = path[0].key, path[1].key
        np.testing.assert_allclose(grads[a][b], leaf, atol=1e-5, rtol=1e-4,
                                   err_msg=f"{a}.{b}")
    loss, acc = jax_step(problem, *cfg)
    assert abs(got[0]["loss"] - loss) < 1e-5
    # JAX's accuracy is an f32 mean: compare the count of correct targets
    assert all(round(r["val_acc"] * T_VAL) == round(acc * T_VAL) for r in got)


def test_model_axis_sharding_leaves_the_step_unchanged(port):
    """On the 2 x 2 grid, sharding the parameters over the model axis gives
    the replicated step's parameters bit for bit (Adam is elementwise)."""
    a = port[0]["steps"][(2, 2), "gspmd", True, True]["params"]
    b = port[0]["steps"][(2, 2), "gspmd", True, False]["params"]
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_sharded_predict_matches_jax(port, problem):
    """``make_sharded_predict`` on 4 ranks (X row-sharded, the request
    replicated, the rows through the sparse exchange) against JAX's on a
    4-device mesh with the same draws: log-probs within 1e-5, the same on
    every rank."""
    p = problem
    fn = j_make_sharded_predict(make_mesh(n_devices=4), p["jspec"], num_ensemble=ENSEMBLE)
    want = np.asarray(fn(p["params"], jnp.asarray(p["X"]), JPathSampler.build(p["jg"], NW, WL),
                         p["key"], jnp.asarray(p["order"][:32])))
    for r in port:
        np.testing.assert_allclose(r["predict"], want, atol=1e-5, rtol=0)
        np.testing.assert_array_equal(r["predict"], port[0]["predict"])
