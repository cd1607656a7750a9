"""The GRU encoder (``rnn="gru"``) against the JAX package.

Cell: ``gru_scan`` against JAX's (``pathnet_tpu/nn/cells.py:49-68``). K3's
plain GRU encode, on weights packed into the LSTM's layout
(``pack_gru``), against JAX's ``_encode(params, seq, "gru")`` on JAX's
selected rows. Model: logits against ``pagg_forward`` and every gradient
against ``jax.grad`` of the JAX trainer's loss, hetero and homo, with the
attention, mean and sum readouts, without and with dropout. K4's plain GRU
stages composed against autograd of K3's plain version. The ``GRU.*``
state_dict round trip, the unknown choices' refusals, and ``--rnn gru`` through the CLI
on the host.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathnet_tpu.data import Graph as JGraph
from pathnet_tpu.models import init_pagg_params
from pathnet_tpu.models.pagg import _dist_select, _encode
from pathnet_tpu.models.torch_compat import params_from_state_dict
from pathnet_tpu.nn.cells import gru_scan as j_gru_scan
from pathnet_tpu.nn.init import torch_gru_init

from pathnet_tpu_torch import kernels as K
from pathnet_tpu_torch import run
from pathnet_tpu_torch.data import registry
from pathnet_tpu_torch.kernels.pagg_encode import pack_gru, unpack_gru
from pathnet_tpu_torch.models import PaggSpec, PathNet, params_from_jax, params_to_jax
from pathnet_tpu_torch.nn import gru_scan, torch_gru_init_
from pathnet_tpu_torch.train import trainer
from pathnet_tpu_torch.train.checkpoint import completed_rounds
from test_torch_readout import KEEP, NAMES, NW, batch, check_step, model_pair
from test_torch_train_grads import CORNELL
from test_torch_train_loop import cornell_root  # noqa: F401 (a fixture)


@pytest.fixture(scope="module")
def cornell():
    return JGraph.from_edge_input(CORNELL)


@pytest.mark.parametrize("L,B,F,H", [(4, 7, 5, 3), (1, 2, 16, 16), (5, 30, 8, 12)])
def test_gru_scan_matches_jax(L, B, F, H):
    p = torch_gru_init(jax.random.PRNGKey(L + F), F, H)
    xs = np.random.default_rng(B).normal(size=(L, B, F)).astype(np.float32)
    ys, hn = j_gru_scan(p, jnp.asarray(xs))
    tys, thn = gru_scan({k: torch.from_numpy(np.asarray(v)) for k, v in p.items()},
                        torch.from_numpy(xs))
    np.testing.assert_allclose(tys.numpy(), np.asarray(ys), atol=1e-6, rtol=0)
    np.testing.assert_allclose(thn.numpy(), np.asarray(hn), atol=1e-6, rtol=0)


def test_pack_gru_is_undone_by_unpack_and_its_gradient_flows_back_unpacked():
    H = 5
    gen = torch.Generator().manual_seed(0)
    w = [torch.randn(s, generator=gen, requires_grad=True)
         for s in ((H, 3 * H), (H, 3 * H), (3 * H,), (3 * H,))]
    packed = pack_gru(*w)
    assert [tuple(t.shape) for t in packed] == [(H, 4 * H), (H, 4 * H), (4 * H,), (4 * H,)]
    assert not packed[0][:, 3 * H:].any() and not packed[1][:, 2 * H:3 * H].any()
    assert not packed[2][3 * H:].any() and not packed[3][2 * H:3 * H].any()
    back = unpack_gru(*packed)
    for a, b in zip(w, (back["w_ih"], back["w_hh"], back["b_ih"], back["b_hh"])):
        assert torch.equal(a, b)
    gs = [torch.randn(t.shape, generator=gen) for t in packed]
    torch.autograd.backward(packed, gs)
    assert torch.equal(w[0].grad, gs[0][:, :3 * H])
    assert torch.equal(w[1].grad, torch.cat([gs[1][:, :2 * H], gs[1][:, 3 * H:]], 1))
    assert torch.equal(w[2].grad, gs[2][:3 * H])
    assert torch.equal(w[3].grad, torch.cat([gs[3][:2 * H], gs[3][3 * H:]]))


@pytest.mark.parametrize("variant", ["hetero", "homo"])
@pytest.mark.parametrize("wl", [1, 3, 4])
def test_plain_gru_encode_matches_jax_encode(cornell, variant, wl):
    """K3's plain GRU encode (and the recompute's plain ``h_n``) against
    ``_encode(params, seq, "gru")`` on the rows JAX's encode block selects
    (``pagg.py:180-188,257-275``): within 1e-6."""
    F, H = 24, 16
    jspec, params, spec, model = model_pair(F, H, wl, variant, "attention", "gru", seed=wl)
    X, paths, dists, _, _ = batch(cornell, F, wl, wl)
    T = paths.shape[0]
    h = jnp.asarray(X) @ params["fc0"]["w"] + params["fc0"]["b"]
    nei, d = h[jnp.asarray(paths)], jnp.asarray(dists)
    if variant == "hetero":
        nei, d = jnp.flip(nei, axis=2), jnp.flip(d, axis=2)
    else:
        nei = jax.nn.relu(nei)
    sel = _dist_select(params, nei.reshape(-1, H), d.reshape(-1), wl, mode="onehot")
    if variant == "homo":
        sel = jax.nn.relu(sel)
    seq = sel.reshape(T * NW, wl, H).transpose(1, 0, 2)
    want = np.asarray(_encode(params, seq, "gru"))
    table, w = model.encode_inputs(torch.from_numpy(X))
    enc = (table, torch.from_numpy(paths), torch.from_numpy(dists), *w[:6])
    homo = variant == "homo"
    out = K.encode_walks_plain(*enc, homo=homo, cell="gru")
    hn = out[0] if homo else out
    np.testing.assert_allclose(hn.numpy(), want, atol=1e-6, rtol=0)
    streams = K.encode_walks_streams_plain(*enc, homo=homo, cell="gru")
    assert streams[4] is None   # no cell state
    np.testing.assert_allclose(streams[0].numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("variant", ["hetero", "homo"])
@pytest.mark.parametrize("agg", ["attention", "mean", "sum"])
def test_gru_logits_match_pagg_forward(cornell, variant, agg):
    from pathnet_tpu.models import pagg_forward
    F = 24 if variant == "hetero" else 200
    jspec, params, spec, model = model_pair(F, 16, 4, variant, agg, "gru", seed=3)
    X, paths, dists, _, _ = batch(cornell, F, 4, 5)
    idx = np.arange(cornell.n, dtype=np.int32)
    want = np.asarray(pagg_forward(params, jnp.asarray(X), jnp.asarray(paths),
                                   jnp.asarray(dists), jnp.asarray(idx), jspec))
    got = model(torch.from_numpy(X), torch.from_numpy(paths), torch.from_numpy(dists),
                torch.from_numpy(idx))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("variant", ["hetero", "homo"])
@pytest.mark.parametrize("agg", ["attention", "mean", "sum"])
@pytest.mark.parametrize("dropout", [0.0, 0.7])
def test_gru_grads_match_jax_grad(cornell, variant, agg, dropout):
    grads = check_step(cornell, 24, 16, 4, variant, agg, "gru", dropout)
    if agg != "attention":
        assert not grads["attw"]["w"].any() and not grads["attw"]["b"].any()


@pytest.mark.parametrize("agg", ["attention", "mean"])
@pytest.mark.parametrize("homo", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_gru_bwd_stages_compose_to_autograd_of_the_forward(agg, homo, masked):
    """K4's plain GRU stages (the recompute without ``cs``, the attention
    backward, the BPTT from ``hp``, the segment sum, the contractions on the
    packed weights) against ``torch.autograd`` of K3's plain GRU version:
    every gradient, the packed weights' unpacked, within 1e-5 of its
    largest entry."""
    from test_torch_train_kernels import case, unpacked

    _, paths, dists, h, w, mask, g = case(nw=NW, wl=4, H=16, T=30, seed=2 + int(homo))
    H = h.shape[1]
    w = (*w[:2], *pack_gru(w[2][:, :3 * H], w[3][:, :3 * H], w[4][:3 * H], w[5][:3 * H]),
         *w[6:])
    m, keep = (mask, KEEP) if masked else (None, 1.0)
    want = K.pagg_encode_bwd_plain(g, h, paths, dists, *w, m, keep, homo, agg=agg,
                                   cell="gru")
    hn, xr, xin, hp, cs, gt, *ego = K.encode_walks_streams(h, paths, dists, *w[:6], m, keep,
                                                           homo, "gru")
    assert cs is None
    ego = ego[0] if homo else None
    dhn, dego, dattw, dattb = K.attention_bwd(g, h, paths, hn, *w[6:], ego, agg)
    drow, dgates, dsel = K.bptt(dhn, paths, dists, w[0], w[2], w[3], hp, gt, m, keep,
                                (xin, ego, dego) if homo else None, "gru")
    rows = drow.reshape(-1, H) if dego is None or homo else torch.cat([drow.reshape(-1, H),
                                                                        dego])
    dh = K.segment_sum(rows, K.row_nodes(paths, homo, agg), h.shape[0])
    dwd, dbd, dw_ih, dw_hh, db = K.contractions(xr, xin, hp, dsel, dgates, dists, homo)
    got = unpacked((dh, dwd, dbd, dw_ih, dw_hh, db, db, dattw, dattb))
    for name, a, b in zip(NAMES, got, unpacked(want)):
        assert a.shape == b.shape, name
        scale = float(b.abs().max())
        if name in ("dattw", "dattb"):
            # sums over the walks of softmax-gradient terms that cancel: their
            # rounding is bounded by the terms, of dh's size
            scale = max(scale, float(want[0].abs().max()))
        assert float((a - b).abs().max()) <= 1e-5 * max(scale, 1e-30), name


@pytest.mark.parametrize("variant", ["hetero", "homo"])
def test_gru_state_dict_round_trip(variant):
    """A JAX GRU tree to the port's ``state_dict`` under the reference's
    ``GRU.*`` names and back, exactly, and through the JAX package's own
    reader of those names (``params_from_state_dict``); the model draws its
    GRU from torch's default."""
    jspec, params, spec, model = model_pair(24, 16, 4, variant, "mean", "gru")
    sd = model.state_dict()
    rnn = {k for k in sd if not k.startswith(("fc0", "fc2", "nets", "attw"))}
    assert rnn == {"GRU.weight_ih_l0", "GRU.weight_hh_l0", "GRU.bias_ih_l0",
                   "GRU.bias_hh_l0"}
    assert tuple(sd["GRU.weight_hh_l0"].shape) == (48, 16)
    for back in (params_to_jax(sd, spec), params_from_state_dict(sd, jspec)):
        for path, leaf in jax.tree_util.tree_leaves_with_path(params):
            a, b = path[0].key, path[1].key
            np.testing.assert_array_equal(np.asarray(back[a][b]), np.asarray(leaf),
                                          err_msg=f"{a}.{b}")
    fresh = PathNet(spec, device="cpu", generator=torch.Generator().manual_seed(0))
    bound = 1.0 / 16 ** 0.5
    gen = torch.Generator().manual_seed(9)
    gru = torch.nn.GRU(16, 16)
    torch_gru_init_(gru, gen)
    for k in rnn:
        assert float(fresh.state_dict()[k].abs().max()) <= bound, k
        assert float(getattr(gru, k.split(".")[1]).abs().max()) <= bound, k


def test_the_remaining_encoder_choices_still_raise():
    # bf16 x GRU runs since PR 19 (tests/test_torch_bf16_cells.py); unknown
    # encoders and readouts still raise ValueError
    kw = dict(feat_dim=24, hidden=16, out_dim=5, walk_len=4)
    assert PathNet(PaggSpec(rnn="gru", compute_dtype="bfloat16", **kw), device="cpu").bf16
    with pytest.raises(ValueError, match="agg"):
        PaggSpec(agg="max", **kw).check_ported()
    with pytest.raises(ValueError, match="rnn"):
        PaggSpec(rnn="rnn", **kw).check_ported()
    _, _, _, model = model_pair(24, 16, 4, "hetero", "attention", "gru")
    X = torch.zeros((10, 24))
    table, w = model.encode_inputs(X)
    paths = torch.zeros((2, NW, 4), dtype=torch.int32)
    out = K.pagg_encode_fwd(table.bfloat16(), paths, paths,
                            *(t.bfloat16() for t in w[:6]), *w[6:], cell="gru")
    assert out.shape == (2, 16) and out.dtype == torch.float32
    with pytest.raises(ValueError, match="cell"):
        K.pagg_encode_fwd(table, paths, paths, *w, cell="rnn")
    with pytest.raises(ValueError, match="agg"):
        K.pagg_encode_bwd(torch.zeros((2, 16)), table, paths, paths, *w, agg="max")


def test_cli_runs_a_short_gru_protocol_on_the_host(cornell_root, capsys, monkeypatch):
    """``--rnn gru`` trains through the CLI: one round of 2 epochs on the
    host, checkpointed under the JAX package's key with ``.gru``, its best
    params under the ``GRU.*`` names."""
    from pathnet_tpu_torch.train.checkpoint import load_round
    specs = []
    real = trainer.run_round
    monkeypatch.setattr(trainer, "run_round",
                        lambda *a, **k: specs.append(a[3]) or real(*a, **k))
    agg = run.main(["-data", "cornell", "-pr", str(cornell_root), "-e", "2", "-r", "1",
                    "-hid", "8", "-nw", "4", "--rnn", "gru", "--device", "cpu",
                    "--results-dir", str(cornell_root / "res"),
                    "--ckpt-dir", str(cornell_root / "ck"), "--resume"])
    assert [(s.rnn, s.agg) for s in specs] == [("gru", "attention")]
    assert 0.0 <= agg["accuracy"][0] <= 1.0
    assert "pathnet Avg for cornell: acc" in capsys.readouterr().out
    fp = registry.payload_fingerprint(registry.DATASETS["cornell"])
    key = f"cornell.{fp}.e2.h8.s0.nw4.wl4.dr0.7.merw.gru.attention"
    assert completed_rounds(str(cornell_root / "ck"), key) == 1
    assert "GRU.weight_hh_l0" in load_round(str(cornell_root / "ck"), key, 0)["params"]
