"""The training slice's kernels: K3 with a dropout mask, K4 (encode backward)
and K5 (row gather and its backward). On the host: CPU dispatch, input
checks, and the model's autograd wiring. On a card (tests marked ``gpu``):
each kernel against its plain version.

This file imports no JAX, so the card-only tests also run where JAX is
absent: ``python -m pytest tests/test_torch_train_kernels.py -m gpu
--noconftest``.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pathnet_tpu_torch import kernels as K
from pathnet_tpu_torch.data import Graph
from pathnet_tpu_torch.models import PaggSpec, PathNet, draw_dropout_masks
from pathnet_tpu_torch.sample import PathSampler

ROOT = os.path.join(os.path.dirname(__file__), "..")
CORNELL = os.path.join(ROOT, "data", "edge_input", "cornell.in")
KEEP = 0.3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def case(nw=6, wl=4, H=16, T=None, seed=0, device="cpu"):
    """Walks, dists, h, K3 weights, a keep mask and an output gradient for
    ``T`` cornell targets."""
    g = Graph.from_edge_input(CORNELL)
    ps = PathSampler.build(g, nw, wl, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    T = g.n if T is None else T
    starts = torch.randperm(g.n, generator=gen)[:T].to(torch.int32)
    paths, dists = ps.sample(starts, generator=gen)
    h = torch.randn((g.n, H), generator=gen) * 0.5
    b = 1.0 / H ** 0.5
    rnd = lambda *s: (torch.rand(s, generator=gen) * 2 - 1) * b
    w = (rnd(wl, H, H), rnd(wl, H), rnd(H, 4 * H), rnd(H, 4 * H), rnd(4 * H),
         rnd(4 * H), rnd(2 * H), rnd(1))
    mask = (torch.rand((wl, T * nw, H), generator=gen) < KEEP).to(torch.uint8)
    gout = torch.randn((T, H), generator=gen)
    to = lambda t: t.to(device)
    return (starts.to(device), to(paths), to(dists), to(h), tuple(map(to, w)),
            to(mask), to(gout))


def test_cpu_dispatch_of_the_training_kernels_counts_no_launch():
    starts, paths, dists, h, w, mask, gout = case()
    K.reset_launch_counts()
    torch.testing.assert_close(
        K.pagg_encode_fwd(h, paths, dists, *w, keep_mask=mask, keep=KEEP),
        K.pagg_encode_fwd_plain(h, paths, dists, *w, mask, KEEP), atol=1e-6, rtol=1e-6)
    for got, want in zip(K.pagg_encode_bwd(gout, h, paths, dists, *w, mask, KEEP),
                         K.pagg_encode_bwd_plain(gout, h, paths, dists, *w, mask, KEEP)):
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    assert torch.equal(K.row_gather(h, starts), h[starts.long()])
    assert torch.equal(K.row_gather_bwd(gout, starts, h.shape[0]),
                       K.row_gather_bwd_plain(gout, starts, h.shape[0]))
    assert all(c == 0 for c in K.launch_counts().values())


def test_masked_encode_drops_and_rescales_the_lstm_input():
    starts, paths, dists, h, w, mask, gout = case(T=20)
    ones = torch.ones_like(mask)
    plain = K.pagg_encode_fwd_plain(h, paths, dists, *w)
    # an all-ones mask with keep = 1 is the serving forward
    assert torch.equal(K.pagg_encode_fwd(h, paths, dists, *w, keep_mask=ones), plain)
    # a mask of zeros feeds the LSTM zeros: no dependence on h but the ego row
    zeros = torch.zeros_like(mask)
    a = K.pagg_encode_fwd(h, paths, dists, *w, keep_mask=zeros, keep=KEEP)
    assert not torch.allclose(a, plain)


@pytest.mark.parametrize("R, tile", [(1000, 64), (37, 4096), (4096, 1024)])
def test_class_contractions_equal_per_class_masked_sums(R, tile):
    from pathnet_tpu_torch.kernels.pagg_encode_bwd import class_contractions
    rng = np.random.default_rng(R)
    H, classes = 8, 4
    x = torch.from_numpy(rng.standard_normal((R, H)).astype(np.float32))
    s = torch.from_numpy(rng.standard_normal((R, H)).astype(np.float32))
    # class 2 left empty, class 3 most rows, 0 and 1 fewer than a tile
    d = torch.from_numpy(rng.choice([0, 1, 3, 3, 3], size=R))
    dw, db = class_contractions(x, s, d, classes, tile=tile)
    for k in range(classes):
        on = (d == k).float()[:, None]
        torch.testing.assert_close(dw[k], (x * on).t() @ s, atol=1e-4, rtol=1e-5)
        torch.testing.assert_close(db[k], (s * on).sum(0), atol=1e-4, rtol=1e-5)


def test_training_wrappers_reject_bad_inputs():
    starts, paths, dists, h, w, mask, gout = case(T=10)
    with pytest.raises(TypeError):
        K.pagg_encode_fwd(h, paths, dists, *w, keep_mask=mask.bool(), keep=KEEP)
    with pytest.raises(ValueError):
        K.pagg_encode_fwd(h, paths, dists, *w, keep_mask=mask[:, :-1], keep=KEEP)
    with pytest.raises(ValueError, match="keep"):
        K.pagg_encode_fwd(h, paths, dists, *w, keep_mask=mask, keep=0.0)
    with pytest.raises(ValueError):
        K.pagg_encode_bwd(gout[:-1], h, paths, dists, *w)
    with pytest.raises(TypeError):
        K.pagg_encode_bwd(gout.double(), h, paths, dists, *w)
    with pytest.raises(TypeError):
        K.row_gather(h, starts.long())
    with pytest.raises(IndexError):
        K.row_gather(h, torch.tensor([0, h.shape[0]], dtype=torch.int32))
    with pytest.raises(IndexError):
        K.row_gather_bwd(gout[:2], torch.tensor([-1, 0], dtype=torch.int32), h.shape[0])
    with pytest.raises(ValueError):
        K.row_gather_bwd(gout, starts[:-1], h.shape[0])


@pytest.mark.parametrize("fn", ["pagg_encode_fwd", "pagg_encode_bwd", "row_gather",
                                "row_gather_bwd"])
def test_training_wrappers_raise_on_a_device_that_is_neither_cpu_nor_cuda(fn):
    starts, paths, dists, h, w, mask, gout = case(T=4)
    meta = lambda t: t.to("meta")
    args = {"pagg_encode_fwd": (h, paths, dists, *w),
            "pagg_encode_bwd": (gout, h, paths, dists, *w),
            "row_gather": (h, starts), "row_gather_bwd": (gout, starts, h.shape[0])}[fn]
    args = tuple(meta(a) if isinstance(a, torch.Tensor) else a for a in args)
    with pytest.raises(ValueError, match="unsupported device"):
        getattr(K, fn)(*args)


@pytest.mark.parametrize("dropout", [0.0, 0.7])
def test_model_autograd_through_the_kernels_equals_plain_autograd(dropout):
    """``PathNet.forward(train=True)`` (K3 + K4 + K5 as autograd functions)
    against autograd through the plain forward written out, to 1e-6."""
    g = Graph.from_edge_input(CORNELL)
    nw, wl, H, T, Fd = 5, 4, 16, 30, 12
    spec = PaggSpec(feat_dim=Fd, hidden=H, out_dim=5, walk_len=wl, dropout=dropout)
    model = PathNet(spec, device="cpu", generator=torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(4)
    X = torch.randn((g.n, Fd), generator=gen)
    idx = torch.randperm(g.n, generator=gen)[:T].to(torch.int32)
    paths, dists = PathSampler.build(g, nw, wl, device="cpu").sample(idx, generator=gen)
    y = torch.randint(0, 5, (T,), generator=gen)
    masks = draw_dropout_masks(spec, T, nw, gen, "cpu")
    F.cross_entropy(model(X, paths, dists, idx, train=True, masks=masks), y).backward()
    got = {k: p.grad.clone() for k, p in model.named_parameters()}

    model.zero_grad()
    h, w = model._encode_inputs(X)
    m1, m2 = masks if masks is not None else (None, None)
    keep = 1.0 - dropout
    h_agg = K.pagg_encode_fwd_plain(h, paths, dists, *w, m1, keep)
    out = torch.cat([h[idx.long()], h_agg], dim=-1)
    if m2 is not None:
        out = torch.where(m2.bool(), out / keep, 0.0)
    F.cross_entropy(F.linear(out, model.fc2.weight, model.fc2.bias), y).backward()
    for k, p in model.named_parameters():
        torch.testing.assert_close(got[k], p.grad, atol=1e-6, rtol=1e-6, msg=k)


def test_dropout_masks_have_the_layouts_and_rate_of_the_forward():
    spec = PaggSpec(feat_dim=4, hidden=8, out_dim=2, walk_len=3, dropout=0.7)
    m1, m2 = draw_dropout_masks(spec, 50, 6, torch.Generator().manual_seed(0), "cpu")
    assert m1.shape == (3, 300, 8) and m1.dtype == torch.uint8
    assert m2.shape == (50, 16) and m2.dtype == torch.uint8
    assert abs(float(m1.float().mean()) - 0.3) < 0.02
    assert draw_dropout_masks(PaggSpec(feat_dim=4, hidden=8, out_dim=2, walk_len=3,
                                       dropout=0.0), 5, 2, torch.Generator(), "cpu") is None


def wild_case(H, wl, nw, T, n=183, seed=0, device="cpu"):
    """Random walks with distances also outside ``[0, wl - 1]`` (the encode
    clips them), ``h``, K3 weights, a keep mask and an output gradient."""
    gen = torch.Generator().manual_seed(seed)
    paths = torch.randint(0, n, (T, nw, wl), generator=gen, dtype=torch.int32)
    dists = torch.randint(-2, wl + 2, (T, nw, wl), generator=gen, dtype=torch.int32)
    h = torch.randn((n, H), generator=gen) * 0.5
    b = 1.0 / H ** 0.5
    rnd = lambda *s: (torch.rand(s, generator=gen) * 2 - 1) * b
    w = (rnd(wl, H, H), rnd(wl, H), rnd(H, 4 * H), rnd(H, 4 * H), rnd(4 * H),
         rnd(4 * H), rnd(2 * H), rnd(1))
    mask = (torch.rand((wl, T * nw, H), generator=gen) < KEEP).to(torch.uint8)
    gout = torch.randn((T, H), generator=gen)
    to = lambda t: t.to(device)
    return None, to(paths), to(dists), to(h), tuple(map(to, w)), to(mask), to(gout)


# K3 and K4 run in tiles of M walks across targets; the cases past (256, 4,
# 40, None) are the tile's edges: T = 1, nw = 1, nw above M, wl of 1 and 5,
# widths that are not a multiple of 8 (H = 1 and 37), H = 1024 (K4's BPTT
# tile takes 229,376 of the 232,448 shared bytes a block may use), distances
# outside [0, wl - 1] (see tests/test_torch_port_kernels.py)
@pytest.mark.gpu
@pytest.mark.parametrize("H,wl,nw,T,wild", [
    (16, 2, 6, None, False), (64, 4, 40, None, False), (64, 3, 17, None, False),
    (128, 4, 40, None, False),
    (64, 4, 200, None, False),   # 200 walks: over 48 KB of shared memory
    (256, 4, 40, None, False),   # Nba's width
    (64, 4, 40, 1, False), (64, 4, 1, None, False), (37, 5, 6, 183, True),
    (256, 1, 40, 30, True), (512, 4, 40, 50, True), (1, 4, 6, None, False),
    (1024, 2, 3, 20, True)])
def test_masked_encode_and_its_backward_match_plain_on_the_card(cuda, H, wl, nw, T, wild):
    if wild:
        starts, paths, dists, h, w, mask, gout = wild_case(H, wl, nw, T, device=cuda)
    else:
        starts, paths, dists, h, w, mask, gout = case(nw=nw, wl=wl, H=H, T=T, device=cuda)
    for m, keep in ((None, 1.0), (mask, KEEP)):
        got = K.pagg_encode_fwd(h, paths, dists, *w, keep_mask=m, keep=keep)
        want = K.pagg_encode_fwd_plain(h, paths, dists, *w, m, keep)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        got = K.pagg_encode_bwd(gout, h, paths, dists, *w, m, keep)
        want = K.pagg_encode_bwd_plain(gout, h, paths, dists, *w, m, keep)
        dh_max = float(want[0].abs().max())
        for name, a, b in zip(("dh", "dwd", "dbd", "dw_ih", "dw_hh", "db_ih", "db_hh",
                               "dattw", "dattb"), got, want):
            scale = float(b.abs().max())
            if name in ("dattw", "dattb"):
                # sums over all walks of softmax-gradient terms the size of
                # dh's entries; without dropout they cancel to near 0, so
                # their rounding is bounded by the terms, not by the sum
                scale = max(scale, dh_max)
            err = float((a - b).abs().max())
            assert err <= 1e-4 * scale, (name, keep, err, 1e-4 * scale)


def assert_within(got, want, names, tol=1e-4, cancel=(), cancel_scale=0.0):
    """Each of ``got`` within ``tol`` of its plain version's largest entry;
    those named in ``cancel`` (sums that cancel to near 0) within ``tol`` of
    the larger of that and ``cancel_scale``."""
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape, name
        scale = float(b.abs().max()) if b.numel() else 0.0
        if name in cancel:
            scale = max(scale, cancel_scale)
        err = float((a - b).abs().max()) if b.numel() else 0.0
        assert err <= tol * scale, (name, err, tol * scale)


@pytest.mark.gpu
def test_encode_backward_takes_weights_at_any_alignment(cuda):
    # K4's forward recompute copies weight rows 16 bytes at a time only where
    # every base is 16-byte aligned; a view 4 bytes into its storage takes
    # 4-byte copies. The BPTT reads the keep mask two bytes at a time only
    # where it is 2-byte aligned; a view 1 byte into its storage takes bytes.
    starts, paths, dists, h, w, mask, gout = case(nw=40, wl=4, H=64, device=cuda)

    def shift(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        buf[1:] = t.reshape(-1)
        return buf[1:].view(t.shape)

    shifted = [shift(t) for t in w]
    assert shifted[2].data_ptr() % 16 != 0
    odd_mask = shift(mask)
    assert odd_mask.data_ptr() % 2 != 0
    for m, keep in ((None, 1.0), (mask, KEEP), (odd_mask, KEEP)):
        got = K.pagg_encode_bwd(gout, h, paths, dists, *shifted, m, keep)
        want = K.pagg_encode_bwd_plain(gout, h, paths, dists, *w, m, keep)
        assert_within(got, want, ("dh", "dwd", "dbd", "dw_ih", "dw_hh", "db_ih", "db_hh",
                                  "dattw", "dattb"), cancel=("dattw", "dattb"),
                      cancel_scale=float(want[0].abs().max()))


# each of K4's three launches against its plain stage, on the plain stage's
# inputs, at the tile's widths (compiled H = 64 and 256, the run-time
# instance at H = 1, 37 and 1024), a ragged last tile and wild distances
@pytest.mark.gpu
@pytest.mark.parametrize("H,wl,nw,T,wild", [
    (64, 4, 40, None, False), (256, 4, 40, 30, True), (37, 5, 6, 183, True),
    (1, 3, 6, None, False), (1024, 2, 3, 20, True)])
def test_each_encode_backward_stage_matches_its_plain_stage_on_the_card(
        cuda, H, wl, nw, T, wild):
    if wild:
        starts, paths, dists, h, w, mask, gout = wild_case(H, wl, nw, T, device=cuda)
    else:
        starts, paths, dists, h, w, mask, gout = case(nw=nw, wl=wl, H=H, T=T, device=cuda)
    for m, keep in ((None, 1.0), (mask, KEEP)):
        want = K.encode_walks_streams_plain(h, paths, dists, *w[:6], m, keep)
        got = K.encode_walks_streams(h, paths, dists, *w[:6], m, keep)
        assert_within(got, want, ("hn", "xr", "xin", "hp", "cs", "gt"))
        hn, xr, xin, hp, cs, gt = want
        want = K.attention_bwd_plain(gout, h, paths, hn, *w[6:])
        got = K.attention_bwd(gout, h, paths, hn, *w[6:])
        assert_within(got, want, ("dhn", "dego", "dattw", "dattb"), cancel=("dattw", "dattb"),
                      cancel_scale=float(want[1].abs().max()))
        dhn = want[0]
        want = K.bptt_plain(dhn, paths, dists, w[0], w[2], w[3], cs, gt, m, keep)
        gt_io = gt.clone()
        got = K.bptt(dhn, paths, dists, w[0], w[2], w[3], cs, gt_io, m, keep)
        assert got[1] is gt_io   # the gate gradients are written over gt
        assert_within(got, want, ("drow", "dgates", "dsel"))


# the homo instances (HOMO = true) of K3's two and K4's three launches, at
# the compiled widths (64, 256), the run-time instance (H = 1, 16, 37, 1024),
# one target, a ragged last tile and wild distances
@pytest.mark.gpu
@pytest.mark.parametrize("H,wl,nw,T,wild", [
    (64, 4, 40, None, False), (256, 4, 40, 30, True), (37, 5, 6, 183, True),
    (16, 2, 6, None, False), (1, 3, 6, None, False), (64, 4, 40, 1, False),
    (1024, 2, 3, 20, True)])
def test_homo_encode_and_its_backward_match_plain_on_the_card(cuda, H, wl, nw, T, wild):
    if wild:
        starts, paths, dists, h, w, mask, gout = wild_case(H, wl, nw, T, device=cuda)
    else:
        starts, paths, dists, h, w, mask, gout = case(nw=nw, wl=wl, H=H, T=T, device=cuda)
    names = ("dh", "dwd", "dbd", "dw_ih", "dw_hh", "db_ih", "db_hh", "dattw", "dattb")
    for m, keep in ((None, 1.0), (mask, KEEP)):
        got = K.pagg_encode_fwd(h, paths, dists, *w, m, keep, homo=True)
        want = K.pagg_encode_fwd_plain(h, paths, dists, *w, m, keep, homo=True)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        got = K.pagg_encode_bwd(gout, h, paths, dists, *w, m, keep, homo=True)
        want = K.pagg_encode_bwd_plain(gout, h, paths, dists, *w, m, keep, homo=True)
        assert_within(got, want, names, cancel=("dattw", "dattb"),
                      cancel_scale=float(want[0].abs().max()))
        want = K.encode_walks_streams_plain(h, paths, dists, *w[:6], m, keep, homo=True)
        got = K.encode_walks_streams(h, paths, dists, *w[:6], m, keep, homo=True)
        assert_within(got, want, ("hn", "xr", "xin", "hp", "cs", "gt", "ego"))
        hn, xr, xin, hp, cs, gt, ego = want
        torch.testing.assert_close(K.readout(h, paths, hn, *w[6:], ego=ego),
                                   K.readout_plain(h, paths, hn, *w[6:], ego),
                                   atol=1e-4, rtol=1e-4)
        want = K.attention_bwd_plain(gout, h, paths, hn, *w[6:], ego)
        got = K.attention_bwd(gout, h, paths, hn, *w[6:], ego=ego)
        assert_within(got, want, ("dhn", "dego", "dattw", "dattb"), cancel=("dattw", "dattb"),
                      cancel_scale=float(want[1].abs().max()))
        dhn, dego = want[:2]
        want = K.bptt_plain(dhn, paths, dists, w[0], w[2], w[3], cs, gt, m, keep,
                            (xin, ego, dego))
        got = K.bptt(dhn, paths, dists, w[0], w[2], w[3], cs, gt.clone(), m, keep,
                     homo=(xin, ego, dego))
        assert_within(got, want, ("drow", "dgates", "dsel"))


def gru_weights(w):
    """K3's weights ``w`` with a GRU in the cell's slots: the first 3H
    columns of the LSTM's, packed into K3's layout."""
    from pathnet_tpu_torch.kernels.pagg_encode import pack_gru
    H = w[0].shape[1]
    return (*w[:2], *pack_gru(w[2][:, :3 * H], w[3][:, :3 * H], w[4][:3 * H], w[5][:3 * H]),
            *w[6:])


def unpacked(grads, cell="gru"):
    """K4's gradients with the GRU's packed weights' unpacked: the kernel
    leaves the entries of the packing's zero blocks as its contractions give
    them (the model's packing drops them), the plain version zeros."""
    from pathnet_tpu_torch.kernels.pagg_encode import unpack_gru
    if cell != "gru":
        return grads
    dh, dwd, dbd, *wb, dattw, dattb = grads
    return (dh, dwd, dbd, *unpack_gru(*wb).values(), dattw, dattb)


def assert_attention_bwd_within(got, want, agg):
    """The attention backward's ``(dhn, dego, dattw, dattb)``: attention (and
    the quirk's) within 1e-4 (``dattw``, ``dattb`` of ``dego``'s scale); mean
    and sum ``dhn`` within 1e-4, no ``dego`` and exact zero ``dattw``,
    ``dattb``."""
    if agg in ("attention", "quirk"):
        assert_within(got, want, ("dhn", "dego", "dattw", "dattb"),
                      cancel=("dattw", "dattb"), cancel_scale=float(want[1].abs().max()))
        return
    assert got[1] is None and want[1] is None
    assert_within(got[:1], want[:1], ("dhn",))
    assert not got[2].any() and not got[3].any()


def mlp_weights(w):
    """K3's weights ``w`` with the MLP in the cell's slots: ``W`` the first H
    columns of ``w_ih``, ``b`` of ``b_ih``, the recurrent weights empty."""
    H = w[0].shape[1]
    W, b = w[2][:, :H].contiguous(), w[4][:H].contiguous()
    return (*w[:2], W, W.new_zeros((H, 0)), b, b.new_zeros(0), *w[6:])


def cell_weights(w, cell):
    return gru_weights(w) if cell == "gru" else mlp_weights(w) if cell == "mlp" else w


def check_stages_on_the_card(h, paths, dists, w, m, keep, homo, agg, cell, gout, tol=1e-4):
    """K4's launches alone (the recompute, the readout, the attention
    backward, the BPTT) against their plain versions on the plain
    recompute's streams, each within ``tol`` of the plain result's largest
    entry."""
    names = ("hn", "xr", "xin", "hp", "cs", "gt", "ego")
    want = K.encode_walks_streams_plain(h, paths, dists, *w[:6], m, keep, homo, cell=cell)
    got = K.encode_walks_streams(h, paths, dists, *w[:6], m, keep, homo, cell)
    for name, a, b in zip(names, got, want):
        assert (a is None) == (b is None), name
        if b is not None:
            assert_within((a,), (b,), (name,), tol)
    hn, xr, xin, hp, cs, gt, *ego = want
    ego = ego[0] if homo else None
    assert_within([K.readout(h, paths, hn, *w[6:], ego, agg)],
                  [K.readout_plain(h, paths, hn, *w[6:], ego, agg)], ["readout"], 1e-5)
    want = K.attention_bwd_plain(gout, h, paths, hn, *w[6:], ego, agg)
    assert_attention_bwd_within(K.attention_bwd(gout, h, paths, hn, *w[6:], ego, agg), want,
                                agg)
    dhn, dego = want[:2]
    state = hp if cell == "gru" else None if cell == "mlp" else cs
    gt2 = None if gt is None else gt.clone()
    hargs = (xin, ego, dego) if homo else None
    want = K.bptt_plain(dhn, paths, dists, w[0], w[2], w[3], state, gt, m, keep, hargs,
                        cell=cell)
    got = K.bptt(dhn, paths, dists, w[0], w[2], w[3], state, gt2, m, keep, hargs, cell)
    assert (got[1] is None) == (want[1] is None) == (cell == "mlp")
    keep_ = [i for i in range(3) if want[i] is not None]
    assert_within([got[i] for i in keep_], [want[i] for i in keep_],
                  [("drow", "dgates", "dsel")[i] for i in keep_], tol)


def assert_stages_within(got, want, names):
    """``assert_within`` over the stages' outputs that exist (the GRU's
    recompute has no ``cs``)."""
    for name, a, b in zip(names, got, want):
        assert (a is None) == (b is None), name
        if b is not None:
            assert_within((a,), (b,), (name,))


# the GRU (GRU = true: compiled at H = 64 and at the run-time width) and the
# mean and sum readouts (AGG) of K3's two and K4's three launches, hetero
# and homo, at the tile's edges, against their plain versions and stages;
# the readouts' split of the walks into blockDim / H groups at H = 1, 16,
# 37, 64 and one group at H = 256 and 1024
@pytest.mark.gpu
@pytest.mark.parametrize("homo", [False, True])
@pytest.mark.parametrize("H,wl,nw,T,wild", [
    (64, 4, 40, None, False), (256, 4, 40, 30, True), (37, 5, 6, 183, True),
    (16, 2, 6, None, False), (1, 3, 6, None, False), (64, 4, 40, 1, False),
    (1024, 2, 3, 20, True)])
def test_gru_and_readout_instances_match_plain_on_the_card(cuda, homo, H, wl, nw, T, wild):
    if wild:
        starts, paths, dists, h, w, mask, gout = wild_case(H, wl, nw, T, device=cuda)
    else:
        starts, paths, dists, h, w, mask, gout = case(nw=nw, wl=wl, H=H, T=T, device=cuda)
    names = ("dh", "dwd", "dbd", "dw_ih", "dw_hh", "db_ih", "db_hh", "dattw", "dattb")
    for cell, agg in (("gru", "attention"), ("gru", "mean"), ("gru", "sum"),
                      ("lstm", "mean"), ("lstm", "sum")):
        wc = gru_weights(w) if cell == "gru" else w
        for m, keep in ((None, 1.0), (mask, KEEP)):
            kw = dict(homo=homo, agg=agg, cell=cell)
            got = K.pagg_encode_fwd(h, paths, dists, *wc, m, keep, **kw)
            want = K.pagg_encode_fwd_plain(h, paths, dists, *wc, m, keep, **kw)
            torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
            got = unpacked(K.pagg_encode_bwd(gout, h, paths, dists, *wc, m, keep, **kw), cell)
            want = unpacked(K.pagg_encode_bwd_plain(gout, h, paths, dists, *wc, m, keep, **kw),
                            cell)
            assert_within(got, want, names, cancel=("dattw", "dattb"),
                          cancel_scale=float(want[0].abs().max()))
            if agg != "attention":
                assert not got[7].any() and not got[8].any()
            want = K.encode_walks_streams_plain(h, paths, dists, *wc[:6], m, keep, homo,
                                                cell=cell)
            got = K.encode_walks_streams(h, paths, dists, *wc[:6], m, keep, homo, cell)
            assert_stages_within(got, want, ("hn", "xr", "xin", "hp", "cs", "gt", "ego"))
            hn, xr, xin, hp, cs, gt, *ego = want
            ego = ego[0] if homo else None
            torch.testing.assert_close(K.readout(h, paths, hn, *wc[6:], ego, agg),
                                       K.readout_plain(h, paths, hn, *wc[6:], ego, agg),
                                       atol=1e-4, rtol=1e-4)
            want = K.attention_bwd_plain(gout, h, paths, hn, *wc[6:], ego, agg)
            got = K.attention_bwd(gout, h, paths, hn, *wc[6:], ego, agg)
            assert_attention_bwd_within(got, want, agg)
            dhn, dego = want[:2]
            state = hp if cell == "gru" else cs
            hargs = (xin, ego, dego) if homo else None
            want = K.bptt_plain(dhn, paths, dists, wc[0], wc[2], wc[3], state, gt, m, keep,
                                hargs, cell=cell)
            got = K.bptt(dhn, paths, dists, wc[0], wc[2], wc[3], state, gt.clone(), m, keep,
                         hargs, cell)
            assert_within(got, want, ("drow", "dgates", "dsel"))


@pytest.mark.gpu
@pytest.mark.parametrize("homo", [False, True])
@pytest.mark.parametrize("H,wl,nw,T,wild", [
    (64, 4, 40, None, False), (256, 4, 40, 30, True), (37, 5, 6, 183, True),
    (16, 2, 6, None, False), (1, 3, 6, None, False), (64, 4, 40, 1, False),
    (1024, 2, 3, 20, True)])
def test_mlp_instances_match_plain_on_the_card(cuda, homo, H, wl, nw, T, wild):
    # the MLP encoder's f32 instances of K3 and K4 (no recurrence: the mean
    # of the selected rows, one product) against their plain versions, under
    # the attention and mean readouts, with and without the keep mask
    if wild:
        starts, paths, dists, h, w, mask, gout = wild_case(H, wl, nw, T, device=cuda)
    else:
        starts, paths, dists, h, w, mask, gout = case(nw=nw, wl=wl, H=H, T=T, device=cuda)
    wc = mlp_weights(w)
    for agg in ("attention", "mean"):
        for m, keep in ((None, 1.0), (mask, KEEP)):
            kw = dict(homo=homo, agg=agg, cell="mlp")
            got = K.pagg_encode_fwd(h, paths, dists, *wc, m, keep, **kw)
            want = K.pagg_encode_fwd_plain(h, paths, dists, *wc, m, keep, **kw)
            torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
            got = K.pagg_encode_bwd(gout, h, paths, dists, *wc, m, keep, **kw)
            want = K.pagg_encode_bwd_plain(gout, h, paths, dists, *wc, m, keep, **kw)
            assert got[4].shape == (H, 0) and got[6].shape == (0,)
            assert_within(got, want, GRADS, cancel=("dattw", "dattb"),
                          cancel_scale=float(want[0].abs().max()))
            check_stages_on_the_card(h, paths, dists, wc, m, keep, homo, agg, "mlp", gout)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["gru", "mlp"])
@pytest.mark.parametrize("H,wl,nw,T,wild,homo", [
    (64, 4, 40, None, False, False), (64, 4, 40, None, False, True),
    (32, 4, 40, None, False, False), (256, 4, 40, 30, True, False),
    (37, 5, 6, 183, True, True), (64, 4, 40, 1, False, False)])
def test_bf16_gru_and_mlp_instances_match_plain_on_the_card(cuda, cell, H, wl, nw, T, wild,
                                                            homo):
    # the GRU's and the MLP's bf16 instances (tensor-core products, the
    # cells' bf16 roundings) within four bf16 ulps of the plain versions'
    # largest entries, as the bf16 LSTM instances are held
    if wild:
        starts, paths, dists, h, w, mask, gout = wild_case(H, wl, nw, T, device=cuda)
    else:
        starts, paths, dists, h, w, mask, gout = case(nw=nw, wl=wl, H=H, T=T, device=cuda)
    hb, wb = bf16_inputs(h, cell_weights(w, cell))
    for agg in ("attention", "mean"):
        for m, keep in ((None, 1.0), (mask, KEEP)):
            kw = dict(homo=homo, agg=agg, cell=cell)
            got = K.pagg_encode_fwd(hb, paths, dists, *wb, m, keep, **kw)
            want = K.pagg_encode_fwd_plain(hb, paths, dists, *wb, m, keep, **kw)
            assert_within([got], [want], ["out"], BF16_TOL)
            got = unpacked(K.pagg_encode_bwd(gout, hb, paths, dists, *wb, m, keep, **kw), cell)
            want = unpacked(K.pagg_encode_bwd_plain(gout, hb, paths, dists, *wb, m, keep, **kw),
                            cell)
            assert [t.dtype for t in got] == [torch.bfloat16] * 7 + [torch.float32] * 2
            assert_within(as_f32(got), as_f32(want), GRADS, BF16_TOL,
                          cancel=("dattw", "dattb"),
                          cancel_scale=float(want[0].float().abs().max()))
            check_stages_on_the_card(hb, paths, dists, wb, m, keep, homo, agg, cell, gout,
                                     BF16_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["lstm", "gru", "mlp"])
@pytest.mark.parametrize("H,wl,nw,T,wild", [
    (64, 4, 40, None, False), (256, 4, 40, 30, True), (37, 5, 6, 183, True),
    (16, 1, 6, None, False), (64, 4, 1, 50, False)])
def test_quirk_instances_match_plain_on_the_card(cuda, cell, H, wl, nw, T, wild):
    # the quirk (the hetero launches on quirk_layout's walks, the readout's
    # softmax then mean over explicit ego nodes, their backward) against the
    # quirk as written (the plain forward and its autograd)
    from pathnet_tpu_torch.kernels.pagg_encode import quirk_layout
    if wild:
        starts, paths, dists, h, w, mask, gout = wild_case(H, wl, nw, T, device=cuda)
    else:
        starts, paths, dists, h, w, mask, gout = case(nw=nw, wl=wl, H=H, T=T, device=cuda)
    wc = cell_weights(w, cell)
    for m, keep in ((None, 1.0), (mask, KEEP)):
        kw = dict(agg="quirk", cell=cell)
        got = K.pagg_encode_fwd(h, paths, dists, *wc, m, keep, **kw)
        want = K.pagg_encode_fwd_plain(h, paths, dists, *wc, m, keep, **kw)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        got = unpacked(K.pagg_encode_bwd(gout, h, paths, dists, *wc, m, keep, **kw), cell)
        want = unpacked(K.pagg_encode_bwd_plain(gout, h, paths, dists, *wc, m, keep, **kw),
                        cell)
        assert_within(got, want, GRADS, cancel=("dattw", "dattb"),
                      cancel_scale=float(want[0].abs().max()))
        qp, qd, ego, perm = quirk_layout(paths, dists)
        hn = K.encode_walks_plain(h, qp, qd, *wc[:6], None if m is None else m[:, perm], keep,
                                  cell=cell)
        assert_within([K.readout(h, ego, hn, *wc[6:], agg="quirk")],
                      [K.readout_plain(h, ego, hn, *wc[6:], agg="quirk")], ["readout"], 1e-5)
        assert_attention_bwd_within(K.attention_bwd(gout, h, ego, hn, *wc[6:], agg="quirk"),
                                    K.attention_bwd_plain(gout, h, ego, hn, *wc[6:],
                                                          agg="quirk"), "quirk")


@pytest.mark.gpu
@pytest.mark.parametrize("agg", ["attention", "mean", "sum"])
def test_mean_and_sum_send_no_ego_rows_to_the_segment_sum_on_the_card(cuda, agg,
                                                                       monkeypatch):
    # hetero: the segment sum adds wl rows a walk under mean and sum (no ego
    # row gets a gradient), wl + 1 under attention
    import importlib
    k4 = importlib.import_module("pathnet_tpu_torch.kernels.pagg_encode_bwd")
    starts, paths, dists, h, w, mask, gout = case(nw=40, wl=4, H=64, device=cuda)
    seen = []
    real = k4.segment_sum

    def spy(rows, index, n):
        seen.append((rows.shape[0], index.shape[0]))
        return real(rows, index, n)

    monkeypatch.setattr(k4, "segment_sum", spy)
    got = K.pagg_encode_bwd(gout, h, paths, dists, *w, mask, KEEP, agg=agg)
    want = K.pagg_encode_bwd_plain(gout, h, paths, dists, *w, mask, KEEP, agg=agg)
    T, nw, wl = paths.shape
    rows = (wl + (agg == "attention")) * T * nw
    assert seen == [(rows, rows)]
    assert_within(got, want, GRADS, cancel=("dattw", "dattb"),
                  cancel_scale=float(want[0].abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("agg", ["mean", "sum"])
def test_mean_and_sum_readouts_take_rows_at_any_alignment_on_the_card(cuda, agg):
    # the mean and sum branches move float4s only where every row is
    # 16-byte aligned; views 4 bytes into their storage take floats
    gen = torch.Generator().manual_seed(1)
    T, nw, H = 33, 40, 64
    paths = torch.zeros((T, nw, 4), dtype=torch.int32, device=cuda)
    h = torch.zeros((5, H), device=cuda)
    att = (torch.zeros(2 * H, device=cuda), torch.zeros(1, device=cuda))

    def shifted(*shape):
        buf = torch.randn(int(np.prod(shape)) + 1, generator=gen).to(cuda)
        return buf[1:].view(shape)

    hn, g = shifted(T * nw, H), shifted(T, H)
    assert hn.data_ptr() % 16 != 0 and g.data_ptr() % 16 != 0
    for x, y in ((hn, g), (hn.clone(), g.clone())):
        torch.testing.assert_close(K.readout(h, paths, x, *att, agg=agg),
                                   K.readout_plain(h, paths, x, *att, agg=agg),
                                   atol=1e-5, rtol=1e-5)
        got = K.attention_bwd(y, h, paths, x, *att, agg=agg)
        want = K.attention_bwd_plain(y, h, paths, x, *att, agg=agg)
        assert got[1] is None and want[1] is None
        for a, b in zip((got[0], *got[2:]), (want[0], *want[2:])):
            torch.testing.assert_close(a, b, atol=0.0, rtol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("n,C,m", [(512, 128, 512), (63977, 64, 8192), (183, 5, 1000),
                                   (1000, 3, 4097), (300, 130, 999), (77, 1, 50),
                                   (403, 256, 193)])
def test_row_gather_matches_plain_on_the_card(cuda, n, C, m):
    gen = torch.Generator().manual_seed(n)
    tbl = torch.randn((n, C), generator=gen).to(cuda)
    idx = torch.randint(0, n, (m,), generator=gen, dtype=torch.int32).to(cuda)
    assert torch.equal(K.row_gather(tbl, idx), K.row_gather_plain(tbl, idx))
    dout = torch.randn((m, C), generator=gen).to(cuda)
    got = K.row_gather_bwd(dout, idx, n)
    want = K.row_gather_bwd_plain(dout, idx, n)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.gpu
def test_row_gather_is_one_launch_a_call_on_the_card(cuda):
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator().manual_seed(0)
    tbl = torch.randn((63977, 64), generator=gen).to(cuda)
    idx = torch.randint(0, 63977, (8192,), generator=gen, dtype=torch.int32).to(cuda)
    K.row_gather(tbl, idx)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        K.row_gather(tbl, idx)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "row_gather" in kernels[0], kernels


@pytest.mark.gpu
@pytest.mark.parametrize("bad", [8, -1])
def test_row_gather_stops_the_stream_on_an_index_out_of_range(cuda, bad):
    """In a process of its own, since the assert leaves the context unusable."""
    code = ("import torch\n"
            "from pathnet_tpu_torch import kernels as K\n"
            "tbl = torch.randn((8, 64), device='cuda')\n"
            f"idx = torch.tensor([0, {bad}, 3], dtype=torch.int32, device='cuda')\n"
            "out = K.row_gather(tbl, idx)\n"
            "torch.cuda.synchronize()\n"
            "print('no error', out.sum().item())\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode != 0 and "no error" not in r.stdout, r.stdout
    assert "assert" in r.stderr.lower(), r.stderr[-2000:]


@pytest.mark.gpu
def test_a_training_step_on_the_card_matches_the_host(cuda):
    training_step_on_the_card_and_the_host(cuda, "hetero")


@pytest.mark.gpu
def test_a_homo_training_step_on_the_card_matches_the_host(cuda):
    training_step_on_the_card_and_the_host(cuda, "homo")


def training_step_on_the_card_and_the_host(cuda, variant, compute_dtype="float32"):
    """One training step with dropout on the card and on the host from the
    same weights, walks and masks: logits and every gradient within 1e-4 of
    the host's largest entry (bf16 compute: four bf16 ulps of it)."""
    g = Graph.from_edge_input(CORNELL)
    spec = PaggSpec(feat_dim=32, hidden=64, out_dim=5, walk_len=4, variant=variant,
                    compute_dtype=compute_dtype)
    tol = 1e-4 if compute_dtype == "float32" else BF16_TOL
    gen = torch.Generator().manual_seed(0)
    X = torch.randn((g.n, 32), generator=gen)
    idx = torch.arange(0, g.n, 2, dtype=torch.int32)
    paths, dists = PathSampler.build(g, 40, 4, device="cpu").sample(idx, generator=gen)
    y = torch.randint(0, 5, (idx.shape[0],), generator=gen)
    masks = draw_dropout_masks(spec, idx.shape[0], 40, gen, "cpu")
    grads = []
    for dev in ("cpu", cuda):
        m = PathNet(spec, device=dev, generator=torch.Generator().manual_seed(1))
        to = lambda t: t.to(dev)
        K.reset_launch_counts()
        logits = m(to(X), to(paths), to(dists), to(idx), train=True,
                   masks=tuple(map(to, masks)))
        F.cross_entropy(logits, to(y)).backward()
        grads.append({"logits": logits.detach().cpu(),
                      **{k: p.grad.cpu() for k, p in m.named_parameters()}})
    counts = K.launch_counts()
    assert counts["pagg_encode_fwd"] == counts["pagg_encode_bwd"] == 1
    assert counts["row_gather"] == counts["row_gather_bwd"] == 1
    for k, want in grads[0].items():
        err = float((grads[1][k] - want).abs().max())
        scale = float(want.abs().max())
        if k == "attw.bias":
            # a sum over all walks of score gradients that cancel to near 0;
            # its summands are those of attw.weight's gradient
            scale = max(scale, float(grads[0]["attw.weight"].abs().max()))
        assert err <= tol * scale, (k, err)


@pytest.mark.gpu
def test_a_bf16_training_step_on_the_card_matches_the_host(cuda):
    training_step_on_the_card_and_the_host(cuda, "hetero", "bfloat16")


@pytest.mark.gpu
def test_a_bf16_homo_training_step_on_the_card_matches_the_host(cuda):
    training_step_on_the_card_and_the_host(cuda, "homo", "bfloat16")


# bf16 compute: four bf16 ulps of each output's largest entry. The kernel and
# its plain version round at the same points, but the kernel's sigmoid and
# tanh differ from torch's by a few f32 ulps, which can move a rounding of
# c_t or h_t by one bf16 ulp; such a flip carries on through later steps.
BF16_TOL = 4 * 2.0 ** -8
GRADS = ("dh", "dwd", "dbd", "dw_ih", "dw_hh", "db_ih", "db_hh", "dattw", "dattb")


def bf16_inputs(h, w):
    """The bf16 table and the six cast weights; ``attw``, ``attb`` stay f32."""
    return h.bfloat16(), tuple(t.bfloat16() for t in w[:6]) + tuple(w[6:])


def as_f32(ts):
    return [t.float() for t in ts]


# the bf16 instances: the compiled H = 64 and the run-time width (Nba's 256,
# an odd H, whose weight rows and table pairs are not 4-byte aligned, and
# the 1024 limit), both variants, one target, a ragged last tile, wild
# distances
@pytest.mark.gpu
@pytest.mark.parametrize("H,wl,nw,T,wild,homo", [
    (64, 4, 40, None, False, False), (64, 4, 40, None, False, True),
    (256, 4, 40, 30, True, False), (13, 4, 6, None, False, False),
    (13, 4, 6, None, False, True), (37, 5, 6, 183, True, True), (16, 2, 6, None, False, False),
    (64, 4, 40, 1, False, False), (1024, 2, 3, 20, True, False)])
def test_bf16_encode_and_its_backward_match_plain_on_the_card(cuda, H, wl, nw, T, wild, homo):
    if wild:
        starts, paths, dists, h, w, mask, gout = wild_case(H, wl, nw, T, device=cuda)
    else:
        starts, paths, dists, h, w, mask, gout = case(nw=nw, wl=wl, H=H, T=T, device=cuda)
    hb, wb = bf16_inputs(h, w)
    for m, keep in ((None, 1.0), (mask, KEEP)):
        got = K.pagg_encode_fwd(hb, paths, dists, *wb, m, keep, homo)
        want = K.pagg_encode_fwd_plain(hb, paths, dists, *wb, m, keep, homo)
        assert got.dtype == torch.float32
        assert_within([got], [want], ["out"], BF16_TOL)
        got = K.pagg_encode_bwd(gout, hb, paths, dists, *wb, m, keep, homo)
        want = K.pagg_encode_bwd_plain(gout, hb, paths, dists, *wb, m, keep, homo)
        assert [t.dtype for t in got] == [t.dtype for t in want] == (
            [torch.bfloat16] * 7 + [torch.float32] * 2)
        assert_within(as_f32(got), as_f32(want), GRADS, BF16_TOL, cancel=("dattw", "dattb"),
                      cancel_scale=float(want[0].abs().max()))
        # each launch alone against its plain stage, on the plain stage's inputs
        want = K.encode_walks_streams_plain(hb, paths, dists, *wb[:6], m, keep, homo)
        got = K.encode_walks_streams(hb, paths, dists, *wb[:6], m, keep, homo)
        assert_within(got, want, ("hn", "xr", "xin", "hp", "cs", "gt", "ego"), BF16_TOL)
        hn, xr, xin, hp, cs, gt = want[:6]
        ego = want[6] if homo else None
        assert_within([K.readout(hb, paths, hn, *wb[6:], ego)],
                      [K.readout_plain(hb, paths, hn, *wb[6:], ego)], ["readout"], BF16_TOL)
        want = K.attention_bwd_plain(gout, hb, paths, hn, *wb[6:], ego)
        got = K.attention_bwd(gout, hb, paths, hn, *wb[6:], ego)
        assert_within(got, want, ("dhn", "dego", "dattw", "dattb"), BF16_TOL,
                      cancel=("dattw", "dattb"), cancel_scale=float(want[1].abs().max()))
        dhn, hargs = want[0], ((xin, ego, want[1]) if homo else None)
        want = K.bptt_plain(dhn, paths, dists, wb[0], wb[2], wb[3], cs, gt, m, keep, hargs)
        got = K.bptt(dhn, paths, dists, wb[0], wb[2], wb[3], cs, gt.clone(), m, keep, hargs)
        assert_within(got, want, ("drow", "dgates", "dsel"), BF16_TOL)


# the bf16 instances under the mean and sum readouts (K3's readout and K4's
# attention backward with AGG on a bf16 table), both variants, one target,
# a ragged last tile, wild distances
@pytest.mark.gpu
@pytest.mark.parametrize("agg", ["mean", "sum"])
@pytest.mark.parametrize("H,wl,nw,T,wild,homo", [
    (64, 4, 40, None, False, False), (64, 4, 40, None, False, True),
    (256, 4, 40, 30, True, False), (37, 5, 6, 183, True, True), (64, 4, 40, 1, False, False)])
def test_bf16_mean_and_sum_instances_match_plain_on_the_card(cuda, agg, H, wl, nw, T, wild,
                                                             homo):
    if wild:
        starts, paths, dists, h, w, mask, gout = wild_case(H, wl, nw, T, device=cuda)
    else:
        starts, paths, dists, h, w, mask, gout = case(nw=nw, wl=wl, H=H, T=T, device=cuda)
    hb, wb = bf16_inputs(h, w)
    for m, keep in ((None, 1.0), (mask, KEEP)):
        kw = dict(homo=homo, agg=agg)
        got = K.pagg_encode_fwd(hb, paths, dists, *wb, m, keep, **kw)
        want = K.pagg_encode_fwd_plain(hb, paths, dists, *wb, m, keep, **kw)
        assert_within([got], [want], ["out"], BF16_TOL)
        got = K.pagg_encode_bwd(gout, hb, paths, dists, *wb, m, keep, **kw)
        want = K.pagg_encode_bwd_plain(gout, hb, paths, dists, *wb, m, keep, **kw)
        assert [t.dtype for t in got] == [t.dtype for t in want] == (
            [torch.bfloat16] * 7 + [torch.float32] * 2)
        assert_within(as_f32(got[:7]), as_f32(want[:7]), GRADS[:7], BF16_TOL)
        assert not got[7].any() and not got[8].any()
        # the readout's and the attention backward's launches alone
        want = K.encode_walks_streams_plain(hb, paths, dists, *wb[:6], m, keep, homo)
        hn, xr, xin, hp, cs, gt = want[:6]
        ego = want[6] if homo else None
        assert_within([K.readout(hb, paths, hn, *wb[6:], ego, agg)],
                      [K.readout_plain(hb, paths, hn, *wb[6:], ego, agg)], ["readout"], 1e-5)
        want = K.attention_bwd_plain(gout, hb, paths, hn, *wb[6:], ego, agg)
        got = K.attention_bwd(gout, hb, paths, hn, *wb[6:], ego, agg)
        assert got[1] is None and want[1] is None
        for a, b in zip((got[0], *got[2:]), (want[0], *want[2:])):
            torch.testing.assert_close(a, b, atol=0.0, rtol=1e-6)
        dhn, hargs = want[0], ((xin, ego, want[1]) if homo else None)
        want = K.bptt_plain(dhn, paths, dists, wb[0], wb[2], wb[3], cs, gt, m, keep, hargs)
        got = K.bptt(dhn, paths, dists, wb[0], wb[2], wb[3], cs, gt.clone(), m, keep, hargs)
        assert_within(got, want, ("drow", "dgates", "dsel"), BF16_TOL)


@pytest.mark.gpu
def test_bf16_instances_multiply_on_tensor_cores_and_f32_ones_do_not(cuda):
    # every BF16 instance of the encode (K3, and K4's recompute with STREAMS)
    # and of K4's BPTT runs its products as mma.sync (HMMA in its SASS); the
    # f32 instances, the GRU's and the MLP's among them, keep the CUDA-core
    # product
    from pathnet_tpu_torch.kernels import build
    # by the BF16 argument: masked x homo x H = 64, 32 or run time bf16
    # instances (x STREAMS for the encode; the BPTT's homo ones with and
    # without d ego), each for the LSTM, the GRU and the MLP
    for kernel, flag, n in (("pagg_encode_walks_kernel", 4, 72), ("pagg_bptt_kernel", 3, 54)):
        counts = build.hmma_counts(kernel, flag)
        assert len(counts[1]) == n and min(counts[1]) > 0, (kernel, counts)
        assert len(counts[0]) > 0 and not any(counts[0]), (kernel, counts)


@pytest.mark.gpu
def test_bf16_encode_takes_weights_and_a_table_at_any_alignment(cuda):
    # bf16 weight rows are staged 16 bytes at a time where every base allows
    # it, else 4 bytes (2 values), else value by value; table rows are read
    # in pairs only where the table is 4-byte aligned
    starts, paths, dists, h, w, mask, gout = case(nw=40, wl=4, H=64, device=cuda)
    hb, wb = bf16_inputs(h, w)

    def shift(t, by):
        buf = torch.empty(t.numel() + by, dtype=t.dtype, device=cuda)
        buf[by:] = t.reshape(-1)
        return buf[by:].view(t.shape)

    want_f = K.pagg_encode_fwd_plain(hb, paths, dists, *wb, mask, KEEP)
    want_b = K.pagg_encode_bwd_plain(gout, hb, paths, dists, *wb, mask, KEEP)
    for by in (1, 2):
        table = shift(hb, by)
        shifted = tuple(shift(t, by) for t in wb[:6]) + wb[6:]
        assert table.data_ptr() % 4 != 0 or by == 2
        got = K.pagg_encode_fwd(table, paths, dists, *shifted, mask, KEEP)
        assert_within([got], [want_f], ["out"], BF16_TOL)
        got = K.pagg_encode_bwd(gout, table, paths, dists, *shifted, mask, KEEP)
        assert_within(as_f32(got), as_f32(want_b), GRADS, BF16_TOL, cancel=("dattw", "dattb"),
                      cancel_scale=float(want_b[0].float().abs().max()))


@pytest.mark.gpu
def test_bf16_kernels_refuse_a_mixed_set_on_the_card(cuda):
    starts, paths, dists, h, w, mask, gout = case(nw=6, wl=4, H=16, device=cuda)
    hb, wb = bf16_inputs(h, w)
    K.reset_launch_counts()
    for table, weights in ((h, wb), (hb, w), (hb, wb[:3] + w[3:])):
        with pytest.raises(TypeError, match="float32 or all bfloat16"):
            K.pagg_encode_fwd(table, paths, dists, *weights, mask, KEEP)
        with pytest.raises(TypeError, match="float32 or all bfloat16"):
            K.pagg_encode_bwd(gout, table, paths, dists, *weights, mask, KEEP)
        with pytest.raises(TypeError, match="float32 or all bfloat16"):
            K.encode_walks(table, paths, dists, *weights[:6])
    assert all(c == 0 for c in K.launch_counts().values())
