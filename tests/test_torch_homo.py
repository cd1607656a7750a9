"""The homo PAGG variant (cora, citeseer) against the JAX package.

Model: logits against ``pagg_forward`` and every gradient against
``jax.grad`` of the JAX trainer's loss with ``PaggSpec(variant="homo")``,
with dropout off and with JAX's own keep masks, at F <= 128 (JAX's "auto"
gather mode picks "x") and F > 128 (it picks "h"). Kernel stages: each homo
plain stage of K3 and K4 (the encode with its ego rows, the readout, the
recompute's streams, the attention backward, the BPTT, the rows' nodes)
against the matching intermediate of the JAX homo encode block, built from
the JAX package's ``_dist_select`` and ``_encode`` with the homo steps of
``pagg_forward`` (``pathnet_tpu/models/pagg.py:257-303``). Also xavier's
init and the param conversion for a homo tree.
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
from pathnet_tpu.models.pagg import _dist_select, _encode
from pathnet_tpu.sample import PathSampler as JPathSampler
from pathnet_tpu.train.trainer import _loss_fn

from pathnet_tpu_torch import kernels as K
from pathnet_tpu_torch.models import PaggSpec, PathNet, params_from_jax, params_to_jax
from pathnet_tpu_torch.nn import xavier_uniform_
from test_torch_train_grads import assert_grads_close, jax_masks

ROOT = os.path.join(os.path.dirname(__file__), "..")
CORNELL = os.path.join(ROOT, "data", "edge_input", "cornell.in")
NW, C, KEEP = 6, 5, 0.3
ATOL, RTOL = 1e-5, 1e-4   # the training tests' gradient tolerance
NAMES = ("dh", "dwd", "dbd", "dw_ih", "dw_hh", "db_ih", "db_hh", "dattw", "dattb")


@pytest.fixture(scope="module")
def cornell():
    return JGraph.from_edge_input(CORNELL)


def homo_model(F, H, wl, seed, dropout=0.0, gather_mode="auto"):
    """A JAX homo spec and params, and the port's model holding the same."""
    jspec = JPaggSpec(feat_dim=F, hidden=H, out_dim=C, walk_len=wl, variant="homo",
                      dropout=dropout, gather_mode=gather_mode)
    params = init_pagg_params(jax.random.PRNGKey(seed), jspec)
    spec = PaggSpec(feat_dim=F, hidden=H, out_dim=C, walk_len=wl, variant="homo",
                    dropout=dropout, gather_mode=gather_mode)
    model = PathNet(spec, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                         spec), strict=True)
    return jspec, params, spec, model


def walks(g, wl, seed):
    paths, dists = JPathSampler.build(g, NW, wl).sample(jax.random.PRNGKey(seed))
    return np.array(paths), np.array(dists)


@pytest.mark.parametrize("F,wl,gather_mode", [(24, 4, "auto"), (200, 4, "auto"),
                                              (24, 3, "h"), (200, 2, "x"), (24, 1, "auto")])
def test_homo_logits_match_pagg_forward(cornell, F, wl, gather_mode):
    jspec, params, spec, model = homo_model(F, 16, wl, wl + F, gather_mode=gather_mode)
    X = np.random.default_rng(F).normal(size=(cornell.n, F)).astype(np.float32)
    paths, dists = walks(cornell, wl, F + wl)
    idx = np.arange(cornell.n, dtype=np.int32)
    want = np.asarray(pagg_forward(params, jnp.asarray(X), jnp.asarray(paths),
                                   jnp.asarray(dists), jnp.asarray(idx), jspec))
    got = model(torch.from_numpy(X), torch.from_numpy(paths), torch.from_numpy(dists),
                torch.from_numpy(idx))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("F,wl,dropout,gather_mode", [
    (24, 3, 0.0, "x"), (24, 4, 0.7, "h"), (200, 4, 0.0, "auto"), (200, 4, 0.7, "auto")])
def test_homo_loss_logits_and_grads_match_jax_grad(cornell, F, wl, dropout, gather_mode):
    """One batch of 40 targets through ``jax.grad(_loss_fn)`` and the port's
    autograd (K3 forward, K4 backward): logits and loss within 1e-5, every
    gradient within atol 1e-5 + rtol 1e-4; with dropout, JAX's masks from
    the same key."""
    H, T = 16, 40
    jspec, params, spec, model = homo_model(F, H, wl, 5, dropout, gather_mode)
    rng = np.random.default_rng(F + wl)
    X = rng.normal(size=(cornell.n, F)).astype(np.float32)
    paths, dists = walks(cornell, wl, 6)
    y = rng.integers(0, C, size=cornell.n).astype(np.int32)
    idx = np.sort(rng.choice(cornell.n, T, replace=False)).astype(np.int32)
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
        {k: p.grad for k, p in model.named_parameters()}, spec), ATOL, RTOL)


# the JAX homo encode block, in pieces: the distance select before its
# ReLU, then the rest to (h_n, ego), then the readout
def jax_pre(params, h, paths, dists):
    T, nw, wl = paths.shape
    H = h.shape[1]
    pre = _dist_select(params, h[paths].reshape(-1, H), dists.reshape(-1), wl,
                       mode="onehot")
    return pre.reshape(T, nw, wl, H)


def jax_from_pre(params, pre, mask, keep):
    T, nw, wl, H = pre.shape
    sel = jax.nn.relu(pre)
    seq = sel.reshape(T * nw, wl, H).transpose(1, 0, 2)
    if mask is not None:
        seq = jnp.where(mask, seq / keep, 0.0)
    return _encode(params, seq, "lstm").reshape(T, nw, H), sel[:, :, 0, :]


def jax_readout(params, h_n, ego):
    score = (jnp.concatenate([h_n, ego], axis=-1) @ params["attw"]["w"]
             + params["attw"]["b"])
    return jnp.mean((1.0 + score) * h_n, axis=1)


def jax_encode(params, h, paths, dists, mask, keep):
    return jax_readout(params, *jax_from_pre(params, jax_pre(params, h, paths, dists),
                                             mask, keep))


def stage_case(g, H, masked, seed=0):
    """Cornell walks (wl = 4) with a converted homo model's ``h`` and K3
    weights, a keep mask, an output gradient, and the JAX counterparts."""
    wl, F = 4, 24
    jspec, params, spec, model = homo_model(F, H, wl, H + 1)
    rng = np.random.default_rng(H + seed)
    X = rng.normal(size=(g.n, F)).astype(np.float32)
    paths, dists = walks(g, wl, H)
    T = paths.shape[0]
    mask = (rng.random((wl, T * NW, H)) < KEEP).astype(np.uint8) if masked else None
    keep = KEEP if masked else 1.0
    gout = rng.normal(size=(T, H)).astype(np.float32)
    h, w = model.encode_inputs(torch.from_numpy(X))
    jax_in = (params, jnp.asarray(h.numpy()), jnp.asarray(paths), jnp.asarray(dists),
              None if mask is None else jnp.asarray(mask.astype(bool)), keep)
    tm = None if mask is None else torch.from_numpy(mask)
    return (h, torch.from_numpy(paths), torch.from_numpy(dists), w, tm, keep,
            torch.from_numpy(gout), jax_in)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("H", [16, 64])
def test_homo_encode_stages_match_jax(cornell, H, masked):
    h, tp, td, w, tm, keep, _, jax_in = stage_case(cornell, H, masked)
    params, jh, jp, jd, jm, _ = jax_in
    T = tp.shape[0]
    K.reset_launch_counts()
    hn, ego = K.encode_walks(h, tp, td, *w[:6], tm, keep, homo=True)
    got = K.readout(h, tp, hn, *w[6:], ego=ego)
    assert all(c == 0 for c in K.launch_counts().values())
    assert hn.shape == ego.shape == (T * NW, H)
    assert torch.equal(got, K.pagg_encode_fwd_plain(h, tp, td, *w, tm, keep, homo=True))
    assert torch.equal(got, K.pagg_encode_fwd(h, tp, td, *w, tm, keep, homo=True))
    jhn, jego = jax_from_pre(params, jax_pre(params, jh, jp, jd), jm, keep)
    np.testing.assert_allclose(hn.numpy(), np.asarray(jhn).reshape(-1, H), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(ego.numpy(), np.asarray(jego).reshape(-1, H), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_encode(*jax_in)), atol=1e-5,
                               rtol=1e-5)


def compose_stages(g, h, paths, dists, w, mask, keep):
    """K4's homo gradients from its three stage wrappers, the segment sum of
    the BPTT's row gradients and the contractions."""
    n, H = h.shape
    hn, xr, xin, hp, cs, gt, ego = K.encode_walks_streams(h, paths, dists, *w[:6], mask,
                                                          keep, homo=True)
    dhn, dego, dattw, dattb = K.attention_bwd(g, h, paths, hn, *w[6:], ego=ego)
    drow, dgates, dsel = K.bptt(dhn, paths, dists, w[0], w[2], w[3], cs, gt, mask, keep,
                                homo=(xin, ego, dego))
    dh = K.segment_sum(drow.reshape(-1, H), K.row_nodes(paths, homo=True), n)
    dwd, dbd, dw_ih, dw_hh, db = K.contractions(xr, xin, hp, dsel, dgates, dists,
                                                homo=True)
    return dh, dwd, dbd, dw_ih, dw_hh, db, db, dattw, dattb


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("H", [16, 64])
def test_homo_bwd_stages_compose_to_the_backward_and_to_jax(cornell, H, masked):
    h, tp, td, w, tm, keep, g, jax_in = stage_case(cornell, H, masked, seed=7)
    K.reset_launch_counts()
    got = compose_stages(g, h, tp, td, w, tm, keep)
    assert all(c == 0 for c in K.launch_counts().values())
    want = K.pagg_encode_bwd_plain(g, h, tp, td, *w, tm, keep, homo=True)
    for name, a, b in zip(NAMES, got, want):
        assert a.shape == b.shape, name
        torch.testing.assert_close(a, b, atol=ATOL, rtol=RTOL, msg=name)
    params, jh, jp, jd, jm, _ = jax_in
    _, vjp = jax.vjp(lambda p, x: jax_encode(p, x, jp, jd, jm, keep), params, jh)
    gp, gh = vjp(jnp.asarray(g.numpy()))
    ref = (gh, gp["dist"]["w"], gp["dist"]["b"], gp["rnn"]["w_ih"], gp["rnn"]["w_hh"],
           gp["rnn"]["b_ih"], gp["rnn"]["b_hh"], gp["attw"]["w"].reshape(-1),
           gp["attw"]["b"].reshape(-1))
    for name, a, b in zip(NAMES, got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=RTOL,
                                   err_msg=name)


@pytest.mark.parametrize("masked", [False, True])
def test_homo_attention_and_bptt_stages_match_jax_intermediates(cornell, masked):
    """The attention backward against ``jax.vjp`` of the homo readout in
    ``(h_n, ego, attw)``; the BPTT's ``dsel`` against the gradient of the
    distance select's output before its ReLU, and its ``drow`` against that
    of the gathered rows, each in the BPTT's layout (row ``t * T * nw + b``
    is position ``t`` of walk ``b``)."""
    H = 16
    h, tp, td, w, tm, keep, g, jax_in = stage_case(cornell, H, masked, seed=3)
    params, jh, jp, jd, jm, _ = jax_in
    T, nw, wl = tp.shape
    hn, xr, xin, hp, cs, gt, ego = K.encode_walks_streams(h, tp, td, *w[:6], tm, keep,
                                                          homo=True)
    dhn, dego, dattw, dattb = K.attention_bwd_plain(g, h, tp, hn, *w[6:], ego)
    jg = jnp.asarray(g.numpy())
    _, vjp = jax.vjp(lambda p, a, e: jax_readout(p, a.reshape(T, nw, H), e.reshape(T, nw, H)),
                     params, jnp.asarray(hn.numpy()), jnp.asarray(ego.numpy()))
    gp, ghn, gego = vjp(jg)
    for name, a, b in (("dhn", dhn, ghn), ("dego", dego, gego),
                       ("dattw", dattw, gp["attw"]["w"].reshape(-1)),
                       ("dattb", dattb, gp["attw"]["b"].reshape(-1))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=RTOL,
                                   err_msg=name)

    drow, _, dsel = K.bptt_plain(dhn, tp, td, w[0], w[2], w[3], cs, gt, tm, keep,
                                 (xin, ego, dego))
    pre = jax_pre(params, jh, jp, jd)
    _, vjp = jax.vjp(lambda x: jax_readout(params, *jax_from_pre(params, x, jm, keep)), pre)
    (gpre,) = vjp(jg)
    nei = jh[jp]
    _, vjp = jax.vjp(lambda x: jax_readout(params, *jax_from_pre(
        params, _dist_select(params, x.reshape(-1, H), jd.reshape(-1), wl,
                             mode="onehot").reshape(T, nw, wl, H), jm, keep)), nei)
    (gnei,) = vjp(jg)
    as_steps = lambda a: np.asarray(a).reshape(T * nw, wl, -1).transpose(1, 0, 2)
    np.testing.assert_allclose(dsel.numpy(), as_steps(gpre), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(drow.numpy(), as_steps(gnei), atol=ATOL, rtol=RTOL)
    nodes = K.row_nodes(tp, homo=True)
    assert nodes.shape == (wl * T * nw,)
    assert np.array_equal(nodes.numpy().reshape(wl, T * nw), as_steps(jp[..., None])[..., 0])


def test_xavier_uniform_draws_within_its_bound():
    gen = torch.Generator().manual_seed(0)
    t = xavier_uniform_(torch.empty(300, 200), gen)
    bound = np.sqrt(6.0 / 500)
    assert float(t.abs().max()) <= bound and float(t.abs().max()) > 0.99 * bound
    assert abs(float(t.mean())) < 0.01 * bound
    np.testing.assert_allclose(float(t.var()), bound ** 2 / 3, rtol=0.02)
    again = xavier_uniform_(torch.empty(300, 200), torch.Generator().manual_seed(0))
    assert torch.equal(t, again)


def test_homo_model_draws_xavier_weights_for_fc0_and_fc2():
    F, H = 24, 16
    kw = dict(feat_dim=F, hidden=H, out_dim=C, walk_len=4)
    homo = PathNet(PaggSpec(variant="homo", **kw), device="cpu",
                   generator=torch.Generator().manual_seed(3))
    hetero = PathNet(PaggSpec(**kw), device="cpu", generator=torch.Generator().manual_seed(3))
    sd, sd0 = homo.state_dict(), hetero.state_dict()
    for name, fan_in, fan_out in (("fc0.weight", F, H), ("fc2.weight", 2 * H, C)):
        x = sd[name]
        # above the torch default's bound, within xavier's
        assert 1.0 / np.sqrt(fan_in) < float(x.abs().max()) <= np.sqrt(6.0 / (fan_in + fan_out))
    # the same torch-default draws before; only the two weights are redrawn
    for name in sd:
        assert torch.equal(sd[name], sd0[name]) == (name not in ("fc0.weight", "fc2.weight"))


def test_homo_params_round_trip_through_convert():
    jspec = JPaggSpec(feat_dim=40, hidden=8, out_dim=C, walk_len=4, variant="homo")
    spec = PaggSpec(feat_dim=40, hidden=8, out_dim=C, walk_len=4, variant="homo")
    params = jax.tree_util.tree_map(np.asarray, init_pagg_params(jax.random.PRNGKey(0),
                                                                 jspec))
    model = PathNet(spec, device="cpu")
    model.load_state_dict(params_from_jax(params, spec), strict=True)
    back = params_to_jax(model.state_dict(), spec)
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        a, b = path[0].key, path[1].key
        assert np.array_equal(back[a][b], leaf), (a, b)
