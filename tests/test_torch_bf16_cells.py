"""bf16 compute with the GRU and the MLP encoders against the JAX package.

JAX runs ``gru_scan`` (``pathnet_tpu/nn/cells.py:49-68``) and the MLP's
``mean(seq) @ W + b`` in bf16 on the bf16 selected rows
(``pathnet_tpu/models/pagg.py:233-279``). The port's bf16 GRU takes one f32
product of the packed weights, rounds the product's two n-group columns
(``x W_in + b_in``, ``h W_hn + b_hn``: JAX's bf16 ``gx`` and ``gh`` there),
runs its cell in f32 and rounds ``h_t`` at every step; its bf16 MLP rounds
the mean and ``round(round(m @ W) + b)``.
Held at ``tests/test_torch_bf16.py``'s tolerances, on its cases (cornell's
walks, nw = 8, wl = 4; H = 16 and the odd 13; the "x" and "h" gather
modes; hetero and homo):

- ``h_n``: within **4 bf16 ulps** of its largest entry (measured on the
  host: the GRU within 3.2 ulps). Rounding ``h_t`` alone gave the same
  ``h_n`` distances, but its hetero ``attw.b`` gradient (a sum over the
  walks that nearly cancels, whose value a leaky ReLU's branch flipped by one
  ulp of a score decides) missed the gradient tolerance below in 2 of 16
  cases; with the n-group columns rounded none missed;
- logits: within **one bf16 ulp of the largest logit**;
- gradients: each leaf within the larger of **2**-5** of the largest entry
  of JAX's bf16 leaf and **3 times** the distance of JAX's own f32
  gradient from its bf16 one.
"""
import jax
import numpy as np
import pytest
import torch

from pathnet_tpu.models import PaggSpec as JPaggSpec
from pathnet_tpu.models import init_pagg_params

from pathnet_tpu_torch import kernels as K
from pathnet_tpu_torch.models import PaggSpec, PathNet, params_from_jax
from test_torch_bf16 import (CASES, HN_ULPS, T, ULP, VARIANTS, WL, as_f32,
                             check_bf16_grads, check_bf16_logits, cornell,  # noqa: F401
                             inputs, jax_encode_block)
from test_torch_train_kernels import unpacked

CELLS = ["gru", "mlp"]


def cell_model(F, H, variant, gather_mode, rnn, dropout=0.0, agg="attention"):
    kw = dict(feat_dim=F, hidden=H, out_dim=5, walk_len=WL, variant=variant,
              dropout=dropout, gather_mode=gather_mode, compute_dtype="bfloat16", agg=agg,
              rnn=rnn)
    jspec = JPaggSpec(**kw)
    params = init_pagg_params(jax.random.PRNGKey(H + F), jspec)
    spec = PaggSpec(**kw)
    model = PathNet(spec, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                          spec), strict=True)
    return jspec, params, spec, model


@pytest.fixture
def with_cell(monkeypatch, request):
    """``tests/test_torch_bf16.py``'s checks, their model built with the
    cell ``request.param``."""
    import test_torch_bf16
    rnn = request.param
    monkeypatch.setattr(test_torch_bf16, "bf16_model",
                        lambda F, H, variant, gather_mode, dropout=0.0, agg="attention":
                        cell_model(F, H, variant, gather_mode, rnn, dropout, agg))
    return rnn


@pytest.mark.parametrize("rnn", CELLS)
@pytest.mark.parametrize("F,gather_mode,H", CASES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_bf16_cell_h_n_within_4_ulps_of_jax(cornell, variant, F, gather_mode, H, rnn):
    jspec, params, spec, model = cell_model(F, H, variant, gather_mode, rnn)
    X, paths, dists = inputs(cornell, F)
    _, seq, jhn = jax_encode_block(jspec, params, X, paths, dists)
    want = as_f32(jhn)
    hb, w = model.encode_inputs(torch.from_numpy(X))
    args = (hb, torch.from_numpy(paths), torch.from_numpy(dists), *w[:6])
    out = K.encode_walks_plain(*args, homo=variant == "homo", cell=rnn)
    hn = (out[0] if variant == "homo" else out).numpy()
    # h_n is a bf16 carry (the GRU) or a bf16 result (the MLP)
    assert np.array_equal(hn, torch.from_numpy(hn).bfloat16().float().numpy())
    assert np.abs(hn - want).max() <= HN_ULPS * ULP * np.abs(want).max()
    streams = K.encode_walks_streams_plain(*args, homo=variant == "homo", cell=rnn)
    assert np.array_equal(streams[0].numpy(), hn)
    assert np.array_equal(streams[2].numpy(), as_f32(seq))


@pytest.mark.parametrize("with_cell", CELLS, indirect=True)
@pytest.mark.parametrize("F,gather_mode,H", CASES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_bf16_cell_logits_match_pagg_forward(cornell, with_cell, variant, F, gather_mode, H):
    check_bf16_logits(cornell, variant, F, gather_mode, H)


@pytest.mark.parametrize("with_cell", CELLS, indirect=True)
@pytest.mark.parametrize("dropout", [0.0, 0.7])
@pytest.mark.parametrize("F,gather_mode,H", [CASES[0], CASES[3]])
@pytest.mark.parametrize("variant", VARIANTS)
def test_bf16_cell_grads_match_jax_grad(cornell, with_cell, variant, F, gather_mode, H,
                                        dropout):
    got = check_bf16_grads(cornell, variant, F, gather_mode, H, dropout)
    assert set(got["rnn"]) == ({"w", "b"} if with_cell == "mlp" else
                               {"w_ih", "w_hh", "b_ih", "b_hh"})


@pytest.mark.parametrize("rnn", CELLS)
@pytest.mark.parametrize("homo", [False, True])
def test_bf16_cell_plain_stages_compose_to_the_backward(cornell, rnn, homo):
    """The bf16 plain stages of the GRU and the MLP (recompute, attention
    backward, BPTT, segment sum, contractions) compose to the plain backward
    within 1e-5 of each gradient's largest entry, before the final rounding
    to bf16; the backward returns the cast inputs' gradients as bf16."""
    jspec, params, spec, model = cell_model(24, 13, "homo" if homo else "hetero", "auto", rnn)
    X, paths, dists = inputs(cornell, 24)
    hb, w = model.encode_inputs(torch.from_numpy(X))
    tp, td = torch.from_numpy(paths[:T]), torch.from_numpy(dists[:T])
    H = 13
    mask = (torch.rand((WL, T * 8, H), generator=torch.Generator().manual_seed(0))
            < 0.3).to(torch.uint8)
    g = torch.from_numpy(np.random.default_rng(4).normal(size=(T, H)).astype(np.float32))
    hn, xr, xin, hp, cs, gt, *ego = K.encode_walks_streams(hb, tp, td, *w[:6], mask, 0.3,
                                                           homo, rnn)
    ego = ego[0] if homo else None
    dhn, dego, dattw, dattb = K.attention_bwd(g, hb, tp, hn, *w[6:], ego)
    drow, dgates, dsel = K.bptt(dhn, tp, td, w[0], w[2], w[3], hp if rnn == "gru" else None,
                                gt, mask, 0.3, (xin, ego, dego) if homo else None, rnn)
    rows = drow.reshape(-1, H) if homo else torch.cat([drow.reshape(-1, H), dego])
    dh = K.segment_sum(rows, K.row_nodes(tp, homo), hb.shape[0])
    mlp = rnn == "mlp"
    dwd, dbd, dw_ih, dw_hh, db = K.contractions(xr, xin, hp, dsel, dhn if mlp else dgates, td,
                                                homo, rnn)
    got = (dh, dwd, dbd, dw_ih, dw_hh, db, db.new_zeros(0) if mlp else db, dattw, dattb)
    want = K.pagg_encode_bwd_plain(g, hb.float(), tp, td, *(t.float() for t in w), mask, 0.3,
                                   homo, bf16=True, cell=rnn)
    if rnn == "gru":
        got, want = unpacked(got), unpacked(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        if b.numel():
            assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    out = K.pagg_encode_bwd(g, hb, tp, td, *w, mask, 0.3, homo, cell=rnn)
    assert [t.dtype for t in out] == [torch.bfloat16] * 7 + [torch.float32] * 2
