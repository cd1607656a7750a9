"""The MLP encoder (``rnn="mlp"``) against the JAX package.

JAX's ``_encode(params, seq, "mlp")`` (``pathnet_tpu/models/pagg.py:180-188``)
is ``h_n = mean(seq, 0) @ W + b`` on the selected rows after dropout. K3's
plain MLP encode against it on JAX's selected rows; the model's logits
against ``pagg_forward`` and every gradient against ``jax.grad`` of the JAX
trainer's loss, hetero and homo, attention and mean, without and with JAX's
dropout masks (logits and loss within 1e-5, gradients within atol 1e-5 +
rtol 1e-4, as every f32 test of the port); K4's plain MLP stages composed
against autograd of K3's plain version; the ``MLP.*`` state_dict round
trip through JAX's params; ``--rnn mlp`` through the CLI on the host.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathnet_tpu.data import Graph as JGraph
from pathnet_tpu.models import pagg_forward
from pathnet_tpu.models.pagg import _dist_select, _encode

from pathnet_tpu_torch import kernels as K
from pathnet_tpu_torch import run
from pathnet_tpu_torch.data import registry
from pathnet_tpu_torch.kernels.pagg_encode import cell_shapes
from pathnet_tpu_torch.models import PathNet, params_from_jax, params_to_jax
from pathnet_tpu_torch.train import trainer
from pathnet_tpu_torch.train.checkpoint import completed_rounds, load_round
from test_torch_readout import KEEP, NAMES, NW, batch, check_step, model_pair
from test_torch_train_grads import CORNELL
from test_torch_train_kernels import case, mlp_weights
from test_torch_train_loop import cornell_root  # noqa: F401 (a fixture)


@pytest.fixture(scope="module")
def cornell():
    return JGraph.from_edge_input(CORNELL)


@pytest.mark.parametrize("variant", ["hetero", "homo"])
@pytest.mark.parametrize("wl", [1, 3, 4])
def test_plain_mlp_encode_matches_jax_encode(cornell, variant, wl):
    """K3's plain MLP encode (and the recompute's ``h_n`` and mean input)
    against ``_encode(params, seq, "mlp")`` on the rows JAX's encode block
    selects: within 1e-6."""
    F, H = 24, 16
    jspec, params, spec, model = model_pair(F, H, wl, variant, "attention", "mlp", seed=wl)
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
    want = np.asarray(_encode(params, seq, "mlp"))
    table, w = model.encode_inputs(torch.from_numpy(X))
    assert [tuple(t.shape) for t in w[2:6]] == list(cell_shapes("mlp", H))
    enc = (table, torch.from_numpy(paths), torch.from_numpy(dists), *w[:6])
    homo = variant == "homo"
    out = K.encode_walks_plain(*enc, homo=homo, cell="mlp")
    np.testing.assert_allclose((out[0] if homo else out).numpy(), want, atol=1e-6, rtol=0)
    streams = K.encode_walks_streams_plain(*enc, homo=homo, cell="mlp")
    assert streams[4] is None and streams[5] is None   # no cell state, no gates
    np.testing.assert_allclose(streams[0].numpy(), want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(streams[3].numpy(), np.asarray(seq.mean(0)), atol=1e-6, rtol=0)


@pytest.mark.parametrize("variant", ["hetero", "homo"])
@pytest.mark.parametrize("agg", ["attention", "mean"])
def test_mlp_logits_match_pagg_forward(cornell, variant, agg):
    F = 24 if variant == "hetero" else 200
    jspec, params, spec, model = model_pair(F, 16, 4, variant, agg, "mlp", seed=3)
    X, paths, dists, _, _ = batch(cornell, F, 4, 5)
    idx = np.arange(cornell.n, dtype=np.int32)
    want = np.asarray(pagg_forward(params, jnp.asarray(X), jnp.asarray(paths),
                                   jnp.asarray(dists), jnp.asarray(idx), jspec))
    got = model(torch.from_numpy(X), torch.from_numpy(paths), torch.from_numpy(dists),
                torch.from_numpy(idx))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("variant", ["hetero", "homo"])
@pytest.mark.parametrize("agg", ["attention", "mean"])
@pytest.mark.parametrize("dropout", [0.0, 0.7])
def test_mlp_grads_match_jax_grad(cornell, variant, agg, dropout):
    grads = check_step(cornell, 24, 16, 4, variant, agg, "mlp", dropout)
    assert set(grads["rnn"]) == {"w", "b"}
    if agg != "attention":
        assert not grads["attw"]["w"].any() and not grads["attw"]["b"].any()


@pytest.mark.parametrize("agg", ["attention", "mean"])
@pytest.mark.parametrize("homo", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_mlp_bwd_stages_compose_to_autograd_of_the_forward(agg, homo, masked):
    """K4's plain MLP stages (the recompute with the mean input in ``hp``'s
    place, the attention backward, the BPTT's one product a walk, the segment
    sum, the contractions ``dW = m^T d h_n``, ``db = sum d h_n``) against
    ``torch.autograd`` of K3's plain MLP version: every gradient within 1e-5
    of its largest entry, the recurrent weights' empty."""
    _, paths, dists, h, w, mask, g = case(nw=NW, wl=4, H=16, T=30, seed=2 + int(homo))
    w = mlp_weights(w)
    H = h.shape[1]
    m, keep = (mask, KEEP) if masked else (None, 1.0)
    want = K.pagg_encode_bwd_plain(g, h, paths, dists, *w, m, keep, homo, agg=agg,
                                   cell="mlp")
    hn, xr, xin, hp, cs, gt, *ego = K.encode_walks_streams(h, paths, dists, *w[:6], m, keep,
                                                           homo, "mlp")
    assert cs is None and gt is None and tuple(hp.shape) == (paths.shape[0] * NW, H)
    ego = ego[0] if homo else None
    dhn, dego, dattw, dattb = K.attention_bwd(g, h, paths, hn, *w[6:], ego, agg)
    drow, dgates, dsel = K.bptt(dhn, paths, dists, w[0], w[2], w[3], None, None, m, keep,
                                (xin, ego, dego) if homo else None, "mlp")
    assert dgates is None
    rows = drow.reshape(-1, H) if dego is None or homo else torch.cat([drow.reshape(-1, H),
                                                                        dego])
    dh = K.segment_sum(rows, K.row_nodes(paths, homo, agg), h.shape[0])
    dwd, dbd, dw, dw_hh, db = K.contractions(xr, xin, hp, dsel, dhn, dists, homo, "mlp")
    got = (dh, dwd, dbd, dw, dw_hh, db, db.new_zeros(0), dattw, dattb)
    for name, a, b in zip(NAMES, got, want):
        assert a.shape == b.shape, name
        if not b.numel():
            continue
        scale = float(b.abs().max())
        if name in ("dattw", "dattb"):
            scale = max(scale, float(want[0].abs().max()))
        assert float((a - b).abs().max()) <= 1e-5 * max(scale, 1e-30), name
    assert K.pagg_encode_bwd(g, h, paths, dists, *w, m, keep, homo, agg=agg,
                             cell="mlp")[4].shape == (H, 0)


@pytest.mark.parametrize("variant", ["hetero", "homo"])
def test_mlp_state_dict_round_trip(variant):
    """A JAX MLP tree (``rnn = {"w", "b"}``) to the port's ``state_dict``
    under ``MLP.weight`` (transposed, as ``nn.Linear`` keeps it) and
    ``MLP.bias``, and back, exactly; a fresh model draws them from
    ``nn.Linear``'s default, U(-1/sqrt(H), 1/sqrt(H))."""
    jspec, params, spec, model = model_pair(24, 16, 4, variant, "mean", "mlp")
    sd = model.state_dict()
    rnn = {k for k in sd if not k.startswith(("fc0", "fc2", "nets", "attw"))}
    assert rnn == {"MLP.weight", "MLP.bias"}
    np.testing.assert_array_equal(sd["MLP.weight"].numpy(), np.asarray(params["rnn"]["w"]).T)
    back = params_to_jax(sd, spec)
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        a, b = path[0].key, path[1].key
        np.testing.assert_array_equal(np.asarray(back[a][b]), np.asarray(leaf),
                                      err_msg=f"{a}.{b}")
    again = params_from_jax(back, spec)
    assert all(torch.equal(again[k], sd[k]) for k in sd)
    fresh = PathNet(spec, device="cpu", generator=torch.Generator().manual_seed(0))
    for k in rnn:
        assert 0 < float(fresh.state_dict()[k].abs().max()) <= 1.0 / 16 ** 0.5, k


def test_cli_runs_a_short_mlp_protocol_on_the_host(cornell_root, capsys, monkeypatch):
    """``--rnn mlp`` trains through the CLI: one round of 2 epochs on the
    host, checkpointed under the JAX package's key with ``.mlp``, its best
    params under the ``MLP.*`` names."""
    specs = []
    real = trainer.run_round
    monkeypatch.setattr(trainer, "run_round",
                        lambda *a, **k: specs.append(a[3]) or real(*a, **k))
    agg = run.main(["-data", "cornell", "-pr", str(cornell_root), "-e", "2", "-r", "1",
                    "-hid", "8", "-nw", "4", "--rnn", "mlp", "--device", "cpu",
                    "--results-dir", str(cornell_root / "res"),
                    "--ckpt-dir", str(cornell_root / "ck"), "--resume"])
    assert [(s.rnn, s.agg) for s in specs] == [("mlp", "attention")]
    assert 0.0 <= agg["accuracy"][0] <= 1.0
    assert "pathnet Avg for cornell: acc" in capsys.readouterr().out
    fp = registry.payload_fingerprint(registry.DATASETS["cornell"])
    key = f"cornell.{fp}.e2.h8.s0.nw4.wl4.dr0.7.merw.mlp.attention"
    assert completed_rounds(str(cornell_root / "ck"), key) == 1
    assert "MLP.weight" in load_round(str(cornell_root / "ck"), key, 0)["params"]
