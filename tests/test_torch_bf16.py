"""bf16 compute (``compute_dtype="bfloat16"``) against the JAX package.

The same numpy-seeded inputs and the parameters carried across by
``models/convert.py`` go through JAX's bf16 path (``pathnet_tpu/models/
pagg.py:233-279``) and the port's, hetero and homo, in JAX's "x" and "h"
gather modes, at nw = 8, wl = 4, H = 16 and the odd H = 13, on cornell's walks;
the logits and gradients also under the mean and sum readouts (``agg``),
whose attention weights' gradients are exact zeros as JAX's are.

Tolerances, each resting on a host measurement (JAX 0.9 on the CPU, these
cases):

- the bf16 table and the selected rows (after the homo ReLU and, where
  masked, the dropout): **bit for bit**. A JAX CPU bf16 product is the f32
  product of the bf16 values, rounded once, and the port rounds at the same
  points (measured: equal in every case here);
- ``h_n``: within **4 bf16 ulps** of its largest entry, ``4 * 2**-8 *
  max|h_n|``. JAX's bf16 LSTM rounds its input product and runs its cell's
  sigmoid and tanh in bf16, which the port does not reproduce op by op
  (measured: 2.4 to 3.4 ulps);
- logits: within **one bf16 ulp of the largest logit**, ``2**-8 *
  max|logits|`` (measured: at most 0.33 of it, 3.1e-3 where the homo
  logits reach 5.4; JAX's own bf16 logits lie as far from its f32 ones);
- logits under the mean and sum readouts: within the larger of that ulp
  and **2 times** the distance of JAX's own f32 logits from its bf16 ones.
  The sum adds ``nw`` walks' ``h_n``, each within the 4 ulps above, where
  the softmax and the mean average them (measured: mean 0.06 to 0.32 ulps,
  as attention; sum 0.41 to 1.68 ulps against JAX's own f32-to-bf16 gap of
  0.50 to 1.37 ulps, at most 1.38 times that gap);
- gradients: each leaf within the larger of **2**-5** of the largest entry
  of JAX's bf16 ``jax.grad`` leaf (``attw.b``, a sum over all walks, of the
  larger of its and ``attw.w``'s, as in the f32 tests) and **3 times** the
  distance of JAX's own
  f32 gradient from its bf16 one. The second term matters where a
  gradient is a sum that nearly cancels: without dropout the hetero
  attention weights' gradient is ~1e-5 against ~1e-1 elsewhere, and JAX's
  f32 gradient lies up to 0.9 of the leaf's largest entry from its bf16 one
  (measured: the port at most 2.1 times that far, there; elsewhere at most
  2.45e-2 of the leaf's largest entry, ``attw.w``, where JAX's f32 lies
  2.7e-2 from its bf16).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathnet_tpu.data import Graph as JGraph
from pathnet_tpu.models import PaggSpec as JPaggSpec
from pathnet_tpu.models import init_pagg_params, pagg_forward
from pathnet_tpu.models.pagg import _dist_select, _encode
from pathnet_tpu.sample import PathSampler as JPathSampler
from pathnet_tpu.train.trainer import _loss_fn

from pathnet_tpu_torch import kernels as K
from pathnet_tpu_torch.config import TrainConfig
from pathnet_tpu_torch.data import Graph
from pathnet_tpu_torch.models import PaggSpec, PathNet, params_from_jax, params_to_jax
from pathnet_tpu_torch.sample import PathSampler
from pathnet_tpu_torch.train import predict, run_round

ROOT = os.path.join(os.path.dirname(__file__), "..")
CORNELL = os.path.join(ROOT, "data", "edge_input", "cornell.in")
NW, WL, C, T = 8, 4, 5, 40
ULP = 2.0 ** -8          # a bf16 ulp relative to the value
HN_ULPS = 4
GRAD_TOL = 2.0 ** -5
GRAD_F32_GAPS = 3        # times JAX's own f32-to-bf16 gradient distance
LOGIT_F32_GAPS = 2       # times JAX's own f32-to-bf16 logit distance (mean, sum)
BF = jnp.bfloat16
# (F, gather_mode, H): "auto" resolves to "x" at F = 24 and to "h" at F = 200
CASES = [(24, "auto", 16), (200, "auto", 16), (24, "h", 13), (200, "x", 13)]
VARIANTS = ["hetero", "homo"]


@pytest.fixture(scope="module")
def cornell():
    return JGraph.from_edge_input(CORNELL)


def bf16_model(F, H, variant, gather_mode, dropout=0.0, agg="attention"):
    """A JAX bf16 spec and params, and the port's model holding the same."""
    kw = dict(feat_dim=F, hidden=H, out_dim=C, walk_len=WL, variant=variant,
              dropout=dropout, gather_mode=gather_mode, compute_dtype="bfloat16", agg=agg)
    jspec = JPaggSpec(**kw)
    params = init_pagg_params(jax.random.PRNGKey(H + F), jspec)
    spec = PaggSpec(**kw)
    model = PathNet(spec, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                          spec), strict=True)
    return jspec, params, spec, model


def inputs(g, F):
    X = np.random.default_rng(F).normal(size=(g.n, F)).astype(np.float32)
    paths, dists = JPathSampler.build(g, NW, WL).sample(jax.random.PRNGKey(2))
    return X, np.array(paths), np.array(dists)


def cast_params(params):
    """JAX's bf16 copy of the encode's params (``pagg.py:249-253``)."""
    p = dict(params)
    for k in ("dist", "rnn", "fc0"):
        p[k] = jax.tree_util.tree_map(lambda x: x.astype(BF), p[k])
    return p


def jax_encode_block(jspec, params, X, paths, dists, mask=None):
    """JAX's bf16 encode block in pieces: the table ``[n, H]`` (the projected
    rows of "x" mode, as ``project`` computes them row by row, or the rounded
    ``h``), the selected rows after the homo ReLU and the dropout in the
    LSTM's layout ``[wl, T * nw, H]``, and ``h_n [T * nw, H]``."""
    pb = cast_params(params)
    X = jnp.asarray(X)
    if jspec.resolved_gather_mode() == "x":
        z = X.astype(BF) @ pb["fc0"]["w"] + pb["fc0"]["b"]
    else:
        z = X @ params["fc0"]["w"] + params["fc0"]["b"]
    if jspec.variant == "homo":
        z = jax.nn.relu(z)
    table = z.astype(BF)
    Tn, nw, wl = paths.shape
    H = table.shape[1]
    nei = table[paths]
    d = jnp.asarray(dists)
    if jspec.variant == "hetero":
        nei, d = jnp.flip(nei, 2), jnp.flip(d, 2)
    sel = _dist_select(pb, nei.reshape(-1, H), d.reshape(-1), wl, mode="onehot")
    if jspec.variant == "homo":
        sel = jax.nn.relu(sel)
    seq = sel.reshape(Tn * nw, wl, H).transpose(1, 0, 2)
    if mask is not None:
        seq = jnp.where(jnp.asarray(mask.astype(bool)), seq / (1.0 - jspec.dropout), 0.0)
    return table, seq, _encode(pb, seq, jspec.rnn)


def as_f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("F,gather_mode,H", CASES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_bf16_table_and_selected_rows_equal_jax_bit_for_bit(cornell, variant, F, gather_mode,
                                                           H, masked):
    """The bf16 table the port builds and the selected rows of its plain
    encode (``xin`` of the recompute's streams: after the homo ReLU, and after
    the dropout where masked) equal JAX's ``project``/``astype`` and
    ``_dist_select`` exactly; the kernels' plain stages see a bf16 table."""
    jspec, params, spec, model = bf16_model(F, H, variant, gather_mode, 0.7 if masked else 0.0)
    X, paths, dists = inputs(cornell, F)
    mask = ((np.random.default_rng(H).random((WL, cornell.n * NW, H)) < 0.3).astype(np.uint8)
            if masked else None)
    table, seq, _ = jax_encode_block(jspec, params, X, paths, dists, mask)
    hb, w = model.encode_inputs(torch.from_numpy(X))
    assert hb.dtype == torch.bfloat16 and all(t.dtype == torch.bfloat16 for t in w[:6])
    assert all(t.dtype == torch.float32 for t in w[6:])
    assert np.array_equal(hb.float().numpy(), as_f32(table))
    tm = None if mask is None else torch.from_numpy(mask)
    streams = K.encode_walks_streams_plain(hb, torch.from_numpy(paths), torch.from_numpy(dists),
                                           *w[:6], tm, 0.3 if masked else 1.0,
                                           homo=variant == "homo")
    assert np.array_equal(streams[2].numpy(), as_f32(seq))
    if variant == "homo":   # the ego rows: the rounded step-0 rows before dropout
        _, seq0, _ = jax_encode_block(jspec, params, X, paths, dists)
        assert np.array_equal(streams[6].numpy(), as_f32(seq0[0]))


@pytest.mark.parametrize("F,gather_mode,H", CASES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_bf16_h_n_within_4_ulps_of_jax(cornell, variant, F, gather_mode, H):
    jspec, params, spec, model = bf16_model(F, H, variant, gather_mode)
    X, paths, dists = inputs(cornell, F)
    _, _, jhn = jax_encode_block(jspec, params, X, paths, dists)
    hb, w = model.encode_inputs(torch.from_numpy(X))
    out = K.encode_walks_plain(hb, torch.from_numpy(paths), torch.from_numpy(dists), *w[:6],
                               homo=variant == "homo")
    hn = (out[0] if variant == "homo" else out).numpy()
    want = as_f32(jhn)
    assert hn.dtype == np.float32
    # h_n is a bf16 carry: every entry a bf16 value
    assert np.array_equal(hn, torch.from_numpy(hn).bfloat16().float().numpy())
    assert np.abs(hn - want).max() <= HN_ULPS * ULP * np.abs(want).max()


@pytest.mark.parametrize("F,gather_mode,H", CASES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_bf16_logits_match_pagg_forward(cornell, variant, F, gather_mode, H):
    check_bf16_logits(cornell, variant, F, gather_mode, H)


@pytest.mark.parametrize("agg", ["mean", "sum"])
@pytest.mark.parametrize("F,gather_mode,H", [CASES[0], CASES[3]])
@pytest.mark.parametrize("variant", VARIANTS)
def test_bf16_mean_and_sum_logits_match_pagg_forward(cornell, variant, F, gather_mode, H,
                                                     agg):
    check_bf16_logits(cornell, variant, F, gather_mode, H, agg, LOGIT_F32_GAPS)


def check_bf16_logits(cornell, variant, F, gather_mode, H, agg="attention", f32_gaps=0):
    """Every node's logits against ``pagg_forward`` at bf16, within one bf16
    ulp of the largest logit, or ``f32_gaps`` times as far as JAX's own f32
    logits lie from its bf16 ones."""
    jspec, params, spec, model = bf16_model(F, H, variant, gather_mode, agg=agg)
    X, paths, dists = inputs(cornell, F)
    idx = np.arange(cornell.n, dtype=np.int32)
    args = (jnp.asarray(X), jnp.asarray(paths), jnp.asarray(dists), jnp.asarray(idx))
    want = np.asarray(pagg_forward(params, *args, jspec))
    tol = ULP * np.abs(want).max()
    if f32_gaps:
        want32 = pagg_forward(params, *args, dataclasses.replace(jspec,
                                                                 compute_dtype="float32"))
        tol = max(tol, f32_gaps * np.abs(np.asarray(want32) - want).max())
    got = model(torch.from_numpy(X), torch.from_numpy(paths), torch.from_numpy(dists),
                torch.from_numpy(idx))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0)


def jax_masks(key, jspec, T_):
    """The masks ``pagg_forward`` draws from ``key`` (pagg.py:142-147,207)."""
    k1, k2 = jax.random.split(key)
    keep = 1.0 - jspec.dropout
    m1 = jax.random.bernoulli(k1, keep, (jspec.walk_len, T_ * NW, jspec.hidden))
    m2 = jax.random.bernoulli(k2, keep, (T_, 2 * jspec.hidden))
    return (torch.from_numpy(np.asarray(m1).astype(np.uint8)),
            torch.from_numpy(np.asarray(m2).astype(np.uint8)))


@pytest.mark.parametrize("dropout", [0.0, 0.7])
@pytest.mark.parametrize("F,gather_mode,H", CASES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_bf16_grads_match_jax_grad(cornell, variant, F, gather_mode, H, dropout):
    check_bf16_grads(cornell, variant, F, gather_mode, H, dropout)


@pytest.mark.parametrize("agg", ["mean", "sum"])
@pytest.mark.parametrize("dropout", [0.0, 0.7])
@pytest.mark.parametrize("variant", VARIANTS)
def test_bf16_mean_and_sum_grads_match_jax_grad(cornell, variant, dropout, agg):
    # under mean and sum the attention weights' gradients are JAX's exact
    # zeros: their tolerance below is 0
    got = check_bf16_grads(cornell, variant, *CASES[0], dropout, agg)
    assert not got["attw"]["w"].any() and not got["attw"]["b"].any()


def check_bf16_grads(cornell, variant, F, gather_mode, H, dropout, agg="attention"):
    """``T`` targets through ``jax.grad(_loss_fn)`` at bf16 and the port's
    autograd (K3 forward, K4 backward, the casts' gradients): every
    gradient within ``GRAD_TOL`` of the largest entry of JAX's leaf, or
    ``GRAD_F32_GAPS`` times as far as JAX's f32 gradient lies from it; with
    dropout, JAX's masks from the same key. Returns the port's gradients
    (JAX's layout)."""
    jspec, params, spec, model = bf16_model(F, H, variant, gather_mode, dropout, agg)
    jspec32 = dataclasses.replace(jspec, compute_dtype="float32")
    X, paths, dists = inputs(cornell, F)
    rng = np.random.default_rng(F + H)
    y = rng.integers(0, C, size=cornell.n).astype(np.int32)
    idx = np.sort(rng.choice(cornell.n, T, replace=False)).astype(np.int32)
    key = jax.random.PRNGKey(7) if dropout > 0 else None
    args = (jnp.asarray(X), jnp.asarray(paths[idx]), jnp.asarray(dists[idx]),
            jnp.asarray(idx), jnp.asarray(y[idx]), jspec, key)
    jgrads = jax.grad(_loss_fn)(params, *args)
    jgrads32 = jax.grad(_loss_fn)(params, *args[:5], jspec32, key)
    masks = jax_masks(key, jspec, T) if key is not None else None
    logits = model(torch.from_numpy(X), torch.from_numpy(paths[idx]),
                   torch.from_numpy(dists[idx]), torch.from_numpy(idx), train=True,
                   masks=masks)
    torch.nn.functional.cross_entropy(logits, torch.from_numpy(y[idx]).long()).backward()
    got = params_to_jax({k: p.grad for k, p in model.named_parameters()}, spec)
    attw_w = np.abs(np.asarray(jgrads["attw"]["w"])).max()
    for path, leaf in jax.tree_util.tree_leaves_with_path(jgrads):
        a, b = path[0].key, path[1].key
        want = np.asarray(leaf)
        scale = max(np.abs(want).max(), attw_w if (a, b) == ("attw", "b") else 0.0)
        gap32 = np.abs(np.asarray(jgrads32[a][b]) - want).max()
        tol = max(GRAD_TOL * scale, GRAD_F32_GAPS * gap32)
        assert got[a][b].dtype == np.float32, (a, b)
        assert np.abs(got[a][b] - want).max() <= tol, (a, b)
    return got


def test_bf16_model_keeps_f32_params_and_follows_the_gather_mode():
    """The parameters stay f32; the bf16 table of "h" mode is the rounded
    f32 projection, that of "x" mode the rounded product of the rounded rows
    plus the rounded bias, and they differ."""
    F, H = 24, 16
    X = torch.from_numpy(np.random.default_rng(0).normal(size=(60, F)).astype(np.float32))
    tables = {}
    for gm in ("h", "x"):
        spec = PaggSpec(feat_dim=F, hidden=H, out_dim=C, walk_len=WL, gather_mode=gm,
                        compute_dtype="bfloat16")
        model = PathNet(spec, device="cpu", generator=torch.Generator().manual_seed(1))
        assert all(p.dtype == torch.float32 for p in model.parameters())
        tables[gm] = model.encode_inputs(X)[0]
    W, b = model.fc0.weight, model.fc0.bias
    assert torch.equal(tables["h"], (X @ W.t() + b).to(torch.bfloat16))
    bf = torch.bfloat16
    z = (X.to(bf).float() @ W.to(bf).float().t()).to(bf)
    assert torch.equal(tables["x"], z + b.to(bf))
    assert not torch.equal(tables["h"], tables["x"])


def test_bf16_plain_backward_returns_each_gradient_in_its_inputs_type(cornell):
    """The plain K4 at bf16: ``dh`` and the six cast weights' gradients bf16,
    ``dattw`` and ``dattb`` f32; the gradients of an f32 copy of the same
    inputs under ``bf16=True`` are the same values before their rounding."""
    jspec, params, spec, model = bf16_model(24, 16, "hetero", "auto")
    X, paths, dists = inputs(cornell, 24)
    hb, w = model.encode_inputs(torch.from_numpy(X))
    tp, td = torch.from_numpy(paths[:T]), torch.from_numpy(dists[:T])
    g = torch.from_numpy(np.random.default_rng(3).normal(size=(T, 16)).astype(np.float32))
    got = K.pagg_encode_bwd(g, hb, tp, td, *w)
    assert [t.dtype for t in got] == [torch.bfloat16] * 7 + [torch.float32] * 2
    f32 = K.pagg_encode_bwd_plain(g, hb.float(), tp, td, *(t.float() for t in w), bf16=True)
    assert all(t.dtype == torch.float32 for t in f32)
    for a, b in zip(got, f32):
        assert torch.equal(a, b.to(a.dtype))


def test_bf16_plain_stages_compose_to_the_backward(cornell):
    """The bf16 plain stages (recompute, attention backward, BPTT, segment
    sum, contractions) compose to the plain backward within 1e-5 of each
    gradient's largest entry, before the final rounding to bf16."""
    jspec, params, spec, model = bf16_model(24, 13, "hetero", "auto")
    X, paths, dists = inputs(cornell, 24)
    hb, w = model.encode_inputs(torch.from_numpy(X))
    tp, td = torch.from_numpy(paths[:T]), torch.from_numpy(dists[:T])
    mask = (torch.rand((WL, T * NW, 13), generator=torch.Generator().manual_seed(0))
            < 0.3).to(torch.uint8)
    g = torch.from_numpy(np.random.default_rng(4).normal(size=(T, 13)).astype(np.float32))
    hn, xr, xin, hp, cs, gt = K.encode_walks_streams(hb, tp, td, *w[:6], mask, 0.3)
    dhn, dego, dattw, dattb = K.attention_bwd(g, hb, tp, hn, *w[6:])
    drow, dgates, dsel = K.bptt(dhn, tp, td, w[0], w[2], w[3], cs, gt, mask, 0.3)
    dh = K.segment_sum(torch.cat([drow.reshape(-1, 13), dego]), K.row_nodes(tp), hb.shape[0])
    dwd, dbd, dw_ih, dw_hh, db = K.contractions(xr, xin, hp, dsel, dgates, td)
    want = K.pagg_encode_bwd_plain(g, hb.float(), tp, td, *(t.float() for t in w), mask, 0.3,
                                   bf16=True)
    for a, b in zip((dh, dwd, dbd, dw_ih, dw_hh, db, db, dattw, dattb), want):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_bf16_wrappers_reject_a_mixed_set(cornell):
    """The table and the six cast weights are bf16 together or not at all."""
    jspec, params, spec, model = bf16_model(24, 16, "hetero", "auto")
    X, paths, dists = inputs(cornell, 24)
    hb, w = model.encode_inputs(torch.from_numpy(X))
    tp, td = torch.from_numpy(paths[:T]), torch.from_numpy(dists[:T])
    g = torch.zeros((T, 16))
    for bad in (((hb.float(),) + w), ((hb,) + (w[0].float(),) + w[1:]),
                ((hb,) + w[:5] + (w[5].float(),) + w[6:])):
        with pytest.raises(TypeError, match="float32 or all bfloat16"):
            K.pagg_encode_fwd(bad[0], tp, td, *bad[1:])
        with pytest.raises(TypeError, match="float32 or all bfloat16"):
            K.pagg_encode_bwd(g, bad[0], tp, td, *bad[1:])
    with pytest.raises(TypeError, match="attw"):
        K.pagg_encode_fwd(hb, tp, td, *w[:6], w[6].bfloat16(), w[7])


def test_bf16_predict_and_a_short_round_run_on_the_host(small_graph):
    g = Graph(n=small_graph.n, src=small_graph.src, dst=small_graph.dst,
              prob=small_graph.prob)
    X = torch.from_numpy(np.asarray(small_graph.features, np.float32))
    y = torch.from_numpy(np.asarray(small_graph.labels, np.int64))
    ps = PathSampler.build(g, 6, WL, device="cpu")
    spec = PaggSpec(feat_dim=X.shape[1], hidden=16, out_dim=3, walk_len=WL,
                    compute_dtype="bfloat16")
    model = PathNet(spec, device="cpu")
    logp = predict(model, X, ps, torch.Generator().manual_seed(0))
    assert logp.shape == (g.n, 3) and logp.dtype == torch.float32
    assert torch.isfinite(logp).all()
    torch.testing.assert_close(logp.logsumexp(-1), torch.zeros(g.n), atol=1e-5, rtol=0)
    perm = np.random.default_rng(0).permutation(g.n)
    masks = [np.isin(np.arange(g.n), part) for part in np.split(perm, [30, 45])]
    res = run_round(X, y, ps, spec, TrainConfig(epochs=2, lr=0.01), *masks, 3, seed=0,
                    track_history=True, keep_params=True)
    assert res.history.shape == (2,) and np.isfinite(res.losses).all()
    assert all(v.dtype == torch.float32 for v in res.best_params.values())
    moved = PathNet(spec, device="cpu").state_dict()
    assert 0.0 <= res.metrics["accuracy"] <= 1.0 and moved.keys() == res.best_params.keys()
