"""``quirk_compat=True`` against the JAX package.

JAX's ``_hetero_quirk_forward`` (``pathnet_tpu/models/pagg.py:316-338``)
reproduces two index quirks of the reference's hetero forward: the distance
classes taken b-major against the flipped sequence's l-major rows, and the
walks grouped walk-major, with a softmax over each group followed by a mean.
It returns before ``compute_dtype``, ``agg``, ``gather_mode`` and
``dist_mode`` are read, and the homo variant ignores the flag (``:229``).

Here: the kernels' layout (``quirk_layout``: misaligned nodes, unflipped
classes, permuted walks and keep mask columns, explicit ego nodes) through
K3's and K4's plain stages equals the quirk as written
(``quirk_encode_plain``, and ``pagg_encode_fwd_plain``'s autograd); the
model's logits against ``pagg_forward`` and every gradient against
``jax.grad`` of the JAX trainer's loss within 1e-5 (atol 1e-5 + rtol 1e-4
for the gradients), with the LSTM, the GRU and the MLP, without and with
JAX's dropout masks; specs with ``compute_dtype="bfloat16"`` or ``agg="mean"``
give JAX's f32 attention-mean quirk, a homo spec ignores the flag;
``--quirk-compat`` through the CLI on the host.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathnet_tpu.data import Graph as JGraph
from pathnet_tpu.models import PaggSpec as JPaggSpec
from pathnet_tpu.models import init_pagg_params, pagg_forward
from pathnet_tpu.train.trainer import _loss_fn

from pathnet_tpu_torch import kernels as K
from pathnet_tpu_torch import run
from pathnet_tpu_torch.data import registry
from pathnet_tpu_torch.kernels.pagg_encode import quirk_encode_plain, quirk_layout
from pathnet_tpu_torch.models import PaggSpec, PathNet, params_from_jax, params_to_jax
from pathnet_tpu_torch.train import trainer
from pathnet_tpu_torch.train.checkpoint import completed_rounds
from test_torch_readout import ATOL, KEEP, NAMES, RTOL, T, batch
from test_torch_train_grads import CORNELL, assert_grads_close, jax_masks
from test_torch_train_kernels import case, cell_weights, unpacked
from test_torch_train_loop import cornell_root  # noqa: F401 (a fixture)

C = 5


@pytest.fixture(scope="module")
def cornell():
    return JGraph.from_edge_input(CORNELL)


def quirk_pair(F, H, wl, rnn="lstm", dropout=0.0, seed=1, **extra):
    """A JAX quirk spec and params, and the port's model holding the same."""
    kw = dict(feat_dim=F, hidden=H, out_dim=C, walk_len=wl, rnn=rnn, dropout=dropout,
              quirk_compat=True, **extra)
    jspec = JPaggSpec(**kw)
    params = init_pagg_params(jax.random.PRNGKey(seed), jspec)
    spec = PaggSpec(**kw)
    model = PathNet(spec, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params), spec),
                          strict=True)
    return jspec, params, spec, model


@pytest.mark.parametrize("nw,wl,T_", [(6, 4, 30), (5, 3, 7), (1, 2, 9), (4, 1, 3)])
def test_quirk_layout_matches_the_reference_index_walk(nw, wl, T_):
    """Step ``l`` of quirk walk ``b' = g * T + j`` (here walk ``j * nw + g``,
    position ``wl - 1 - l``) holds node ``pf[i % B, wl - 1 - i // B]``, ``i =
    b' * wl + l``, and class ``df[b', l]``; its ego node is ``pf[b', 0]``."""
    gen = torch.Generator().manual_seed(nw + wl)
    paths = torch.randint(0, 1000, (T_, nw, wl), generator=gen, dtype=torch.int32)
    dists = torch.randint(-1, 6, (T_, nw, wl), generator=gen, dtype=torch.int32)
    qp, qd, ego, perm = quirk_layout(paths, dists)
    B = T_ * nw
    pf, df = paths.reshape(B, wl), dists.reshape(B, wl)
    assert qp.dtype == qd.dtype == ego.dtype == torch.int32
    assert qp.shape == qd.shape == paths.shape and ego.shape == (T_, nw, 1)
    for j in range(T_):
        for g in range(nw):
            b = g * T_ + j
            assert int(perm[j * nw + g]) == b
            assert int(ego[j, g, 0]) == int(pf[b, 0])
            for l in range(wl):
                i = b * wl + l
                assert int(qp[j, g, wl - 1 - l]) == int(pf[i % B, wl - 1 - i // B])
                assert int(qd[j, g, wl - 1 - l]) == int(df[b, l])


@pytest.mark.parametrize("cell", ["lstm", "gru", "mlp"])
@pytest.mark.parametrize("masked", [False, True])
def test_quirk_stages_on_the_layout_equal_the_quirk_as_written(cell, masked):
    """K3's plain encode and readout on ``quirk_layout``'s walks, permuted
    keep mask and ego nodes equal ``quirk_encode_plain`` (JAX's formulation)
    and the plain forward within 1e-6; K4's plain stages on the same layout
    compose to autograd of the plain forward within 1e-5 of each gradient's
    largest entry."""
    _, paths, dists, h, w, mask, g = case(nw=6, wl=4, H=16, T=30, seed=5)
    w = cell_weights(w, cell)
    m, keep = (mask, KEEP) if masked else (None, 1.0)
    qp, qd, ego, perm = quirk_layout(paths, dists)
    qm = None if m is None else m[:, perm]
    hn = K.encode_walks(h, qp, qd, *w[:6], qm, keep, cell=cell)
    want_hn, first = quirk_encode_plain(h, paths, dists, *w[:6], m, keep, cell)
    T_, nw = paths.shape[:2]
    np.testing.assert_allclose(hn.reshape(T_, nw, -1).transpose(0, 1).numpy(),
                               want_hn.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(h[ego.reshape(T_, nw).t().long()].numpy(), first.numpy())
    out = K.readout(h, ego, hn, *w[6:], agg="quirk")
    want = K.pagg_encode_fwd_plain(h, paths, dists, *w, m, keep, agg="quirk", cell=cell)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(K.pagg_encode_fwd(h, paths, dists, *w, m, keep, agg="quirk",
                                                 cell=cell).numpy(), want.numpy(), atol=0,
                               rtol=0)
    # K4's stages on the layout
    grads = K.pagg_encode_bwd_plain(g, h, paths, dists, *w, m, keep, agg="quirk", cell=cell)
    hn, xr, xin, hp, cs, gt = K.encode_walks_streams(h, qp, qd, *w[:6], qm, keep, cell=cell)
    dhn, dego, dattw, dattb = K.attention_bwd(g, h, ego, hn, *w[6:], agg="quirk")
    state = hp if cell == "gru" else cs
    drow, dgates, dsel = K.bptt(dhn, qp, qd, w[0], w[2], w[3], state, gt, qm, keep, None,
                                cell)
    H = h.shape[1]
    dh = K.segment_sum(torch.cat([drow.reshape(-1, H), dego]),
                       K.row_nodes(qp, False, "quirk", ego), h.shape[0])
    dwd, dbd, dw_ih, dw_hh, db = K.contractions(xr, xin, hp, dsel,
                                                dhn if cell == "mlp" else dgates, qd,
                                                False, cell)
    db_hh = db.new_zeros(0) if cell == "mlp" else db
    got = (dh, dwd, dbd, dw_ih, dw_hh, db, db_hh, dattw, dattb)
    if cell == "gru":
        got, grads = unpacked(got), unpacked(grads)
    for name, a, b in zip(NAMES, got, grads):
        assert a.shape == b.shape, name
        if not b.numel():
            continue
        scale = float(b.abs().max())
        if name in ("dattw", "dattb"):
            scale = max(scale, float(grads[0].abs().max()))
        assert float((a - b).abs().max()) <= 1e-5 * max(scale, 1e-30), name


@pytest.mark.parametrize("rnn", ["lstm", "gru", "mlp"])
@pytest.mark.parametrize("extra", [{}, {"agg": "mean"}, {"compute_dtype": "bfloat16"}],
                         ids=["plain", "agg_mean", "bf16"])
def test_quirk_logits_match_pagg_forward(cornell, rnn, extra):
    """Every node's logits against JAX's quirk forward within 1e-5; specs
    with ``agg="mean"`` or bf16 compute give JAX's f32 attention-mean quirk
    (the spec without them, exactly as JAX's own results agree)."""
    jspec, params, spec, model = quirk_pair(24, 16, 4, rnn, seed=3, **extra)
    X, paths, dists, _, _ = batch(cornell, 24, 4, 5)
    idx = np.arange(cornell.n, dtype=np.int32)
    args = (jnp.asarray(X), jnp.asarray(paths), jnp.asarray(dists), jnp.asarray(idx))
    want = np.asarray(pagg_forward(params, *args, jspec))
    plain = dataclasses.replace(jspec, agg="attention", compute_dtype="float32")
    np.testing.assert_array_equal(want, np.asarray(pagg_forward(params, *args, plain)))
    got = model(*(torch.from_numpy(a) for a in (X, paths, dists, idx)))
    assert not model.bf16 and model.agg == "quirk"
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("rnn", ["lstm", "gru", "mlp"])
@pytest.mark.parametrize("dropout", [0.0, 0.7])
def test_quirk_grads_match_jax_grad(cornell, rnn, dropout):
    """One batch through ``jax.grad(_loss_fn)`` and the port's autograd (K3
    forward, K4 backward on the quirk layout): logits and loss within 1e-5,
    every gradient within atol 1e-5 + rtol 1e-4; with dropout, JAX's masks."""
    jspec, params, spec, model = quirk_pair(24, 16, 4, rnn, dropout, seed=2)
    X, paths, dists, y, idx = batch(cornell, 24, 4, 0)
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


def test_homo_spec_ignores_the_quirk(cornell):
    """The homo variant with ``quirk_compat=True`` is the homo variant, as
    in JAX (``pagg.py:229``): logits within 1e-5 of ``pagg_forward``, and
    equal to the port's own spec without the flag."""
    jspec, params, spec, model = quirk_pair(200, 16, 4, variant="homo", seed=4)
    X, paths, dists, _, _ = batch(cornell, 200, 4, 6)
    idx = np.arange(cornell.n, dtype=np.int32)
    want = np.asarray(pagg_forward(params, jnp.asarray(X), jnp.asarray(paths),
                                   jnp.asarray(dists), jnp.asarray(idx), jspec))
    tin = [torch.from_numpy(a) for a in (X, paths, dists, idx)]
    got = model(*tin)
    assert model.agg == "attention"
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    plain = PathNet(dataclasses.replace(spec, quirk_compat=False), device="cpu")
    plain.load_state_dict(model.state_dict())
    assert torch.equal(plain(*tin), got)


def test_quirk_refuses_the_homo_variant_and_bf16_at_the_wrappers():
    _, paths, dists, h, w, _, g = case(nw=4, wl=4, H=8, T=5, seed=1)
    with pytest.raises(ValueError, match="quirk"):
        K.pagg_encode_fwd(h, paths, dists, *w, homo=True, agg="quirk")
    with pytest.raises(ValueError, match="quirk"):
        K.pagg_encode_bwd(g, h.bfloat16(), paths, dists, *(t.bfloat16() for t in w[:6]),
                          *w[6:], agg="quirk")


def test_cli_runs_a_short_quirk_protocol_on_the_host(cornell_root, capsys, monkeypatch):
    """``--quirk-compat`` trains through the CLI: one round of 2 epochs on
    the host, checkpointed under the JAX package's key with ``.quirk``."""
    specs = []
    real = trainer.run_round
    monkeypatch.setattr(trainer, "run_round",
                        lambda *a, **k: specs.append(a[3]) or real(*a, **k))
    agg = run.main(["-data", "cornell", "-pr", str(cornell_root), "-e", "2", "-r", "1",
                    "-hid", "8", "-nw", "4", "--quirk-compat", "--device", "cpu",
                    "--results-dir", str(cornell_root / "res"),
                    "--ckpt-dir", str(cornell_root / "ck"), "--resume"])
    assert [s.quirk_compat for s in specs] == [True]
    assert 0.0 <= agg["accuracy"][0] <= 1.0
    assert "pathnet Avg for cornell: acc" in capsys.readouterr().out
    fp = registry.payload_fingerprint(registry.DATASETS["cornell"])
    key = f"cornell.{fp}.e2.h8.s0.nw4.wl4.dr0.7.merw.lstm.attention.quirk"
    assert completed_rounds(str(cornell_root / "ck"), key) == 1
