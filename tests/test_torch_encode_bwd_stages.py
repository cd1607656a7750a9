"""K4's three stages (the forward recompute with its streams, the attention
backward, the BPTT) and the weight contractions, against the whole backward
and against ``jax.vjp`` of the JAX package's encode block.

On the host each stage wrapper takes its plain version, written out by hand;
their composition is what ``pagg_encode_bwd`` launches on a card. The JAX
reference is ``jax_encode`` of ``tests/test_torch_encode_stages.py`` (the JAX
package's ``_dist_select`` and ``_encode`` with the hetero attention readout
of ``pagg_forward``), differentiated with ``jax.vjp`` on the same cornell
walks, converted weights and keep mask.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathnet_tpu.data import Graph as JGraph
from pathnet_tpu.models import PaggSpec as JPaggSpec
from pathnet_tpu.models import init_pagg_params
from pathnet_tpu.sample import PathSampler as JPathSampler

from pathnet_tpu_torch import kernels as K
from pathnet_tpu_torch.models import PaggSpec, PathNet, params_from_jax
from test_torch_encode_stages import jax_encode

ROOT = os.path.join(os.path.dirname(__file__), "..")
CORNELL = os.path.join(ROOT, "data", "edge_input", "cornell.in")
F, C, NW, WL, KEEP = 24, 5, 6, 4, 0.3
ATOL, RTOL = 1e-5, 1e-4   # the training tests' gradient tolerance
NAMES = ("dh", "dwd", "dbd", "dw_ih", "dw_hh", "db_ih", "db_hh", "dattw", "dattb")


@pytest.fixture(scope="module")
def cornell():
    return JGraph.from_edge_input(CORNELL)


def compose_stages(g, h, paths, dists, w, mask, keep):
    """K4's gradients from its three stage wrappers, the segment sum of their
    row gradients and the contractions."""
    n, H = h.shape
    hn, xr, xin, hp, cs, gt = K.encode_walks_streams(h, paths, dists, *w[:6], mask, keep)
    dhn, dego, dattw, dattb = K.attention_bwd(g, h, paths, hn, *w[6:])
    drow, dgates, dsel = K.bptt(dhn, paths, dists, w[0], w[2], w[3], cs, gt, mask, keep)
    assert dgates is gt   # written over the activations, as in the whole backward
    rows = torch.cat([drow.reshape(-1, H), dego])
    dh = K.segment_sum(rows, K.row_nodes(paths), n)
    dwd, dbd, dw_ih, dw_hh, db = K.contractions(xr, xin, hp, dsel, dgates, dists)
    return dh, dwd, dbd, dw_ih, dw_hh, db, db, dattw, dattb


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("H", [16, 64])
def test_bwd_stages_compose_to_the_backward_and_to_jax(cornell, H, masked):
    rng = np.random.default_rng(H + 7)
    X = rng.normal(size=(cornell.n, F)).astype(np.float32)
    paths, dists = JPathSampler.build(cornell, NW, WL).sample(jax.random.PRNGKey(H))
    paths, dists = np.array(paths), np.array(dists)
    T = paths.shape[0]
    mask = (rng.random((WL, T * NW, H)) < KEEP).astype(np.uint8) if masked else None
    keep = KEEP if masked else 1.0
    g = rng.normal(size=(T, H)).astype(np.float32)
    jspec = JPaggSpec(feat_dim=F, hidden=H, out_dim=C, walk_len=WL)
    params = init_pagg_params(jax.random.PRNGKey(H + 1), jspec)
    spec = PaggSpec(feat_dim=F, hidden=H, out_dim=C, walk_len=WL)
    model = PathNet(spec, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                         spec), strict=True)
    h, w = model.encode_inputs(torch.from_numpy(X))
    tp, td = torch.from_numpy(paths), torch.from_numpy(dists)
    tm = None if mask is None else torch.from_numpy(mask)
    tg = torch.from_numpy(g)

    K.reset_launch_counts()
    got = compose_stages(tg, h, tp, td, w, tm, keep)
    assert all(c == 0 for c in K.launch_counts().values())
    want = K.pagg_encode_bwd_plain(tg, h, tp, td, *w, tm, keep)
    for name, a, b in zip(NAMES, got, want):
        assert a.shape == b.shape, name
        torch.testing.assert_close(a, b, atol=ATOL, rtol=RTOL, msg=name)

    # jax.vjp of the JAX encode block at the same h, weights and mask
    jmask = None if mask is None else jnp.asarray(mask.astype(bool))
    _, vjp = jax.vjp(lambda p, jh: jax_encode(p, jh, jnp.asarray(paths), jnp.asarray(dists),
                                              jmask, keep),
                     params, jnp.asarray(h.numpy()))
    gp, gh = vjp(jnp.asarray(g))
    ref = (gh, gp["dist"]["w"], gp["dist"]["b"], gp["rnn"]["w_ih"], gp["rnn"]["w_hh"],
           gp["rnn"]["b_ih"], gp["rnn"]["b_hh"], gp["attw"]["w"].reshape(-1),
           gp["attw"]["b"].reshape(-1))
    for name, a, b in zip(NAMES, got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=RTOL,
                                   err_msg=name)


def test_recompute_stage_equals_the_encode_and_its_streams_fit_together(cornell):
    """``h_n`` of the recompute is K3's first stage; the streams hold the
    gathered rows, ``h_{t-1}`` shifted by one step, and gate activations in
    their ranges."""
    paths, dists = JPathSampler.build(cornell, NW, WL).sample(jax.random.PRNGKey(3))
    tp, td = torch.from_numpy(np.array(paths)), torch.from_numpy(np.array(dists))
    gen = torch.Generator().manual_seed(3)
    H = 16
    h = torch.randn((cornell.n, H), generator=gen)
    w = tuple((torch.rand(s, generator=gen) * 2 - 1) * 0.25
              for s in ((WL, H, H), (WL, H), (H, 4 * H), (H, 4 * H), (4 * H,), (4 * H,)))
    hn, xr, xin, hp, cs, gt = K.encode_walks_streams(h, tp, td, *w)
    B = tp.shape[0] * NW
    assert torch.equal(hn, K.encode_walks_plain(h, tp, td, *w))
    assert xr.shape == xin.shape == hp.shape == cs.shape == (WL, B, H)
    assert gt.shape == (WL, B, 4 * H)
    assert torch.equal(xr[0], h[tp[:, :, -1].reshape(-1).long()])   # far end first
    assert torch.equal(hp[0], torch.zeros((B, H)))
    si, sf, tg, so = gt.chunk(4, dim=2)
    torch.testing.assert_close(hp[1:], so[:-1] * torch.tanh(cs[:-1]), atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(hn, so[-1] * torch.tanh(cs[-1]), atol=1e-6, rtol=1e-6)
    assert float(torch.cat([si, sf, so]).min()) >= 0.0 and float(tg.abs().max()) <= 1.0


def test_bwd_stage_wrappers_reject_bad_inputs():
    gen = torch.Generator().manual_seed(0)
    T, nw, wl, H, n = 3, 2, 3, 8, 10
    h = torch.randn((n, H), generator=gen)
    paths = torch.randint(0, n, (T, nw, wl), generator=gen, dtype=torch.int32)
    dists = torch.zeros_like(paths)
    w = (torch.zeros(wl, H, H), torch.zeros(wl, H), torch.zeros(H, 4 * H),
         torch.zeros(H, 4 * H), torch.zeros(4 * H), torch.zeros(4 * H))
    att = (torch.zeros(2 * H), torch.zeros(1))
    g = torch.randn((T, H), generator=gen)
    hn, xr, xin, hp, cs, gt = K.encode_walks_streams(h, paths, dists, *w)
    dhn = K.attention_bwd(g, h, paths, hn, *att)[0]
    K.bptt(dhn, paths, dists, w[0], w[2], w[3], cs, gt)
    with pytest.raises(ValueError):
        K.encode_walks_streams(h, paths, dists[:, :, :-1].contiguous(), *w)
    with pytest.raises(TypeError):
        K.encode_walks_streams(h, paths, dists, *w, torch.ones((wl, T * nw, H)), 0.5)
    with pytest.raises(ValueError):
        K.attention_bwd(g[:-1], h, paths, hn, *att)
    with pytest.raises(TypeError):
        K.attention_bwd(g, h, paths, hn.double(), *att)
    with pytest.raises(ValueError):
        K.bptt(dhn[:-1], paths, dists, w[0], w[2], w[3], cs, gt)
    with pytest.raises(ValueError):
        K.bptt(dhn, paths, dists, w[0], w[2], w[3], cs, gt[:, :, :H].contiguous())
    with pytest.raises(ValueError, match="keep"):
        K.bptt(dhn, paths, dists, w[0], w[2], w[3], cs, gt,
               torch.ones((wl, T * nw, H), dtype=torch.uint8), 0.0)
    with pytest.raises(ValueError, match="contiguous"):
        K.bptt(dhn, paths, dists, w[0], w[2], w[3], cs.transpose(0, 1).contiguous()
               .transpose(0, 1), gt)
    meta = lambda *ts: tuple(t.to("meta") for t in ts)
    with pytest.raises(ValueError, match="unsupported device"):
        K.encode_walks_streams(*meta(h, paths, dists, *w))
    with pytest.raises(ValueError, match="unsupported device"):
        K.attention_bwd(*meta(g, h, paths, hn, *att))
    with pytest.raises(ValueError, match="unsupported device"):
        K.bptt(*meta(dhn, paths, dists, w[0], w[2], w[3], cs, gt))
