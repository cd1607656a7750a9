"""The mean and sum readouts (``agg="mean"``, ``"sum"``) against the JAX package.

Model: logits against ``pagg_forward`` and every gradient against
``jax.grad`` of the JAX trainer's loss, hetero and homo, with the LSTM,
without and with dropout (JAX's own keep masks); ``attw``'s gradient is an
exact zero tensor, not None, so Adam's additive L2 decays ``attw`` as
optax does in JAX. Kernel stages: K3's readout and K4's attention backward
under mean and sum against ``jnp.mean``/``jnp.sum`` and their ``jax.vjp``;
K4's plain stages composed against autograd of K3's plain version. The CLI
runs ``--agg mean`` on the host.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathnet_tpu.data import Graph as JGraph
from pathnet_tpu.models import PaggSpec as JPaggSpec
from pathnet_tpu.models import init_pagg_params, pagg_forward
from pathnet_tpu.sample import PathSampler as JPathSampler
from pathnet_tpu.train.trainer import _loss_fn
from pathnet_tpu.train.trainer import make_optimizer as j_make_optimizer

from pathnet_tpu_torch import kernels as K
from pathnet_tpu_torch import run
from pathnet_tpu_torch.data import registry
from pathnet_tpu_torch.models import PaggSpec, PathNet, params_from_jax, params_to_jax
from pathnet_tpu_torch.train import trainer
from pathnet_tpu_torch.train.checkpoint import completed_rounds
from pathnet_tpu_torch.train.trainer import make_optimizer
from test_torch_train_grads import CORNELL, assert_grads_close, jax_masks
from test_torch_train_loop import cornell_root  # noqa: F401 (a fixture)

NW, C, T, KEEP = 6, 5, 40, 0.3
ATOL, RTOL = 1e-5, 1e-4   # the training tests' gradient tolerance
NAMES = ("dh", "dwd", "dbd", "dw_ih", "dw_hh", "db_ih", "db_hh", "dattw", "dattb")


@pytest.fixture(scope="module")
def cornell():
    return JGraph.from_edge_input(CORNELL)


def model_pair(F, H, wl, variant, agg, rnn="lstm", dropout=0.0, seed=1):
    """A JAX spec and params, and the port's model holding the same."""
    kw = dict(feat_dim=F, hidden=H, out_dim=C, walk_len=wl, variant=variant, rnn=rnn,
              agg=agg, dropout=dropout)
    jspec = JPaggSpec(**kw)
    params = init_pagg_params(jax.random.PRNGKey(seed), jspec)
    spec = PaggSpec(**kw)
    model = PathNet(spec, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                         spec), strict=True)
    return jspec, params, spec, model


def batch(g, F, wl, seed):
    """Features, every node's walks, labels and ``T`` sorted targets (numpy)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(g.n, F)).astype(np.float32)
    paths, dists = JPathSampler.build(g, NW, wl).sample(jax.random.PRNGKey(seed))
    y = rng.integers(0, C, size=g.n).astype(np.int32)
    idx = np.sort(rng.choice(g.n, T, replace=False)).astype(np.int32)
    return X, np.array(paths), np.array(dists), y, idx


def check_step(g, F, H, wl, variant, agg, rnn, dropout, seed=0):
    """One batch through ``jax.grad(_loss_fn)`` and the port's autograd (K3
    forward, K4 backward): logits and loss within 1e-5, every gradient
    within atol 1e-5 + rtol 1e-4. Returns the port's gradients (JAX
    layout)."""
    jspec, params, spec, model = model_pair(F, H, wl, variant, agg, rnn, dropout, seed + 1)
    X, paths, dists, y, idx = batch(g, F, wl, seed)
    key = jax.random.PRNGKey(7) if dropout > 0 else None
    args = (jnp.asarray(X), jnp.asarray(paths[idx]), jnp.asarray(dists[idx]),
            jnp.asarray(idx), jnp.asarray(y[idx]), jspec, key)
    jloss, jgrads = jax.value_and_grad(_loss_fn)(params, *args)
    jlogits = pagg_forward(params, *args[:4], jspec, train=True, key=key)
    masks = jax_masks(key, jspec, T) if key is not None else None
    logits = model(torch.from_numpy(X), torch.from_numpy(paths[idx]),
                   torch.from_numpy(dists[idx]), torch.from_numpy(idx), train=True,
                   masks=masks)
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(y[idx]).long())
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=1e-5, rtol=0)
    grads = params_to_jax({k: p.grad for k, p in model.named_parameters()}, spec)
    assert_grads_close(jgrads, grads, ATOL, RTOL)
    return grads


@pytest.mark.parametrize("variant", ["hetero", "homo"])
@pytest.mark.parametrize("agg", ["mean", "sum"])
@pytest.mark.parametrize("F,wl", [(24, 4), (200, 3)])
def test_readout_logits_match_pagg_forward(cornell, variant, agg, F, wl):
    jspec, params, spec, model = model_pair(F, 16, wl, variant, agg, seed=F + wl)
    X, paths, dists, _, _ = batch(cornell, F, wl, F)
    idx = np.arange(cornell.n, dtype=np.int32)
    want = np.asarray(pagg_forward(params, jnp.asarray(X), jnp.asarray(paths),
                                   jnp.asarray(dists), jnp.asarray(idx), jspec))
    got = model(torch.from_numpy(X), torch.from_numpy(paths), torch.from_numpy(dists),
                torch.from_numpy(idx))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("variant", ["hetero", "homo"])
@pytest.mark.parametrize("agg", ["mean", "sum"])
@pytest.mark.parametrize("dropout", [0.0, 0.7])
def test_readout_grads_match_jax_grad_and_attw_gets_zero(cornell, variant, agg, dropout):
    grads = check_step(cornell, 24, 16, 4, variant, agg, "lstm", dropout)
    for leaf in ("w", "b"):
        g = grads["attw"][leaf]
        assert g is not None and g.shape and not np.any(g), leaf


@pytest.mark.parametrize("variant", ["hetero", "homo"])
def test_adam_decays_attw_under_mean_as_jax(cornell, variant):
    """Three Adam steps (lr 0.005, additive L2 5e-4) on the real gradients
    under ``agg="mean"``: ``attw``, whose gradient is zero, decays as JAX's
    optax chain decays it, to 1e-6; it moves at all."""
    jspec, params, spec, model = model_pair(24, 16, 4, variant, "mean")
    X, paths, dists, y, idx = batch(cornell, 24, 4, 3)
    args = (jnp.asarray(X), jnp.asarray(paths[idx]), jnp.asarray(dists[idx]),
            jnp.asarray(idx), jnp.asarray(y[idx]), jspec, None)
    jopt = j_make_optimizer(0.005, 0.0005)
    state = jopt.init(params)
    opt = make_optimizer(model.parameters(), 0.005, 0.0005)
    init = {k: np.asarray(v) for k, v in params["attw"].items()}
    for _ in range(3):
        grads = jax.grad(_loss_fn)(params, *args)
        updates, state = jopt.update(grads, state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        opt.zero_grad()
        logits = model(torch.from_numpy(X), torch.from_numpy(paths[idx]),
                       torch.from_numpy(dists[idx]), torch.from_numpy(idx), train=True)
        torch.nn.functional.cross_entropy(logits, torch.from_numpy(y[idx]).long()).backward()
        assert not model.attw.weight.grad.any() and not model.attw.bias.grad.any()
        opt.step()
    port = params_to_jax(model.state_dict(), spec)
    for leaf in ("w", "b"):
        np.testing.assert_allclose(port["attw"][leaf], np.asarray(params["attw"][leaf]),
                                   atol=1e-6, rtol=0)
        assert not np.allclose(port["attw"][leaf], init[leaf], atol=1e-7, rtol=0)


@pytest.mark.parametrize("agg", ["mean", "sum"])
@pytest.mark.parametrize("homo", [False, True])
@pytest.mark.parametrize("Tn", [1, 9])
def test_readout_and_its_backward_match_jax(agg, homo, Tn):
    """K3's readout under mean and sum against ``jnp.mean``/``jnp.sum`` over
    the walks, and K4's attention backward against their ``jax.vjp``: ``d
    h_n`` within 1e-6, no ego rows' gradient (None) and ``dattw``, ``dattb``
    exact zeros. Neither reads ``attw``, ``attb`` or the ego rows. ``d h_n`` is a
    contiguous tensor of its own, one target too (the BPTT takes no view)."""
    rng = np.random.default_rng(int(homo))
    H = 12
    hn = rng.normal(size=(Tn * NW, H)).astype(np.float32)
    g = rng.normal(size=(Tn, H)).astype(np.float32)
    h = torch.from_numpy(rng.normal(size=(30, H)).astype(np.float32))
    paths = torch.from_numpy(rng.integers(0, 30, size=(Tn, NW, 4)).astype(np.int32))
    ego = torch.full((Tn * NW, H), float("nan")) if homo else None
    attw, attb = torch.full((2 * H,), float("nan")), torch.full((1,), float("nan"))
    red = jnp.mean if agg == "mean" else jnp.sum
    want, vjp = jax.vjp(lambda a: red(a.reshape(Tn, NW, H), axis=1), jnp.asarray(hn))
    got = K.readout(h, paths, torch.from_numpy(hn), attw, attb, ego, agg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    dhn, dego, dattw, dattb = K.attention_bwd(torch.from_numpy(g), h, paths,
                                              torch.from_numpy(hn), attw, attb, ego, agg)
    np.testing.assert_allclose(dhn.numpy(), np.asarray(vjp(jnp.asarray(g))[0]), atol=1e-6,
                               rtol=0)
    assert dhn.is_contiguous()
    assert dego is None
    for t, shape in ((dattw, (2 * H,)), (dattb, (1,))):
        assert t.shape == shape and not t.any()


@pytest.mark.parametrize("agg", ["mean", "sum"])
@pytest.mark.parametrize("homo", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_bwd_stages_compose_to_autograd_of_the_forward(agg, homo, masked):
    """K4's plain stages under mean and sum (the recompute, the attention
    backward, the BPTT, the segment sum of the rows without ego rows, the
    contractions) against ``torch.autograd`` of K3's
    plain version: every gradient within 1e-5 of its largest entry."""
    from test_torch_train_kernels import case

    _, paths, dists, h, w, mask, g = case(nw=NW, wl=4, H=16, T=30, seed=int(homo))
    m, keep = (mask, KEEP) if masked else (None, 1.0)
    want = K.pagg_encode_bwd_plain(g, h, paths, dists, *w, m, keep, homo, agg=agg)
    hn, xr, xin, hp, cs, gt, *ego = K.encode_walks_streams(h, paths, dists, *w[:6], m, keep,
                                                           homo)
    ego = ego[0] if homo else None
    dhn, dego, dattw, dattb = K.attention_bwd(g, h, paths, hn, *w[6:], ego, agg)
    drow, dgates, dsel = K.bptt(dhn, paths, dists, w[0], w[2], w[3], cs, gt, m, keep,
                                (xin, ego, dego) if homo else None)
    H = h.shape[1]
    assert dego is None
    rows = drow.reshape(-1, H)
    dh = K.segment_sum(rows, K.row_nodes(paths, homo, agg), h.shape[0])
    dwd, dbd, dw_ih, dw_hh, db = K.contractions(xr, xin, hp, dsel, dgates, dists, homo)
    got = (dh, dwd, dbd, dw_ih, dw_hh, db, db, dattw, dattb)
    for name, a, b in zip(NAMES, got, want):
        assert a.shape == b.shape, name
        assert float((a - b).abs().max()) <= 1e-5 * max(float(b.abs().max()), 1e-30), name
    assert not want[7].any() and not want[8].any()


@pytest.mark.parametrize("agg", ["mean", "sum"])
def test_hetero_rows_without_ego_rows_sum_to_the_old_layouts_dh(agg):
    """Under mean and sum the hetero row gradients leave out the ego rows
    (``wl`` a walk): through ``segment_sum_plain`` they give, bit for bit,
    the ``dh`` of the attention layout with its ``wl + 1`` rows a walk, the
    ego rows' exact zeros added after each node's other rows."""
    from test_torch_train_kernels import case

    _, paths, dists, h, w, mask, g = case(nw=NW, wl=4, H=16, T=30, seed=4)
    hn, xr, xin, hp, cs, gt = K.encode_walks_streams(h, paths, dists, *w[:6], mask, KEEP)
    dhn = K.attention_bwd(g, h, paths, hn, *w[6:], agg=agg)[0]
    drow = K.bptt(dhn, paths, dists, w[0], w[2], w[3], cs, gt, mask, KEEP)[0]
    B, H = hn.shape
    rows = drow.reshape(-1, H)
    nodes = K.row_nodes(paths, agg=agg)
    assert nodes.shape[0] == rows.shape[0] == 4 * B
    old = K.segment_sum_plain(torch.cat([rows, torch.zeros((B, H))]), K.row_nodes(paths),
                              h.shape[0])
    assert torch.equal(K.segment_sum_plain(rows, nodes, h.shape[0]), old)
    assert torch.equal(K.segment_sum(rows, nodes, h.shape[0]), old)


def test_cli_runs_a_short_mean_readout_protocol_on_the_host(cornell_root, capsys,
                                                            monkeypatch):
    """``--agg mean`` trains through the CLI: one round of 2 epochs on the
    host, checkpointed under the JAX package's key with ``.mean``."""
    specs = []
    real = trainer.run_round
    monkeypatch.setattr(trainer, "run_round",
                        lambda *a, **k: specs.append(a[3]) or real(*a, **k))
    agg = run.main(["-data", "cornell", "-pr", str(cornell_root), "-e", "2", "-r", "1",
                    "-hid", "8", "-nw", "4", "--agg", "mean", "--device", "cpu",
                    "--results-dir", str(cornell_root / "res"),
                    "--ckpt-dir", str(cornell_root / "ck"), "--resume"])
    assert [(s.agg, s.rnn) for s in specs] == [("mean", "lstm")]
    assert 0.0 <= agg["accuracy"][0] <= 1.0
    assert "pathnet Avg for cornell: acc" in capsys.readouterr().out
    fp = registry.payload_fingerprint(registry.DATASETS["cornell"])
    key = f"cornell.{fp}.e2.h8.s0.nw4.wl4.dr0.7.merw.lstm.mean"
    assert completed_rounds(str(cornell_root / "ck"), key) == 1
