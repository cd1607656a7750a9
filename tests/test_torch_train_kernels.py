"""The training slice's kernels: K3 with a dropout mask, K4 (encode backward)
and K5 (row gather and its backward). On the host: CPU dispatch, input
checks, and the model's autograd wiring. On a card (tests marked ``gpu``):
each kernel against its plain version.

This file imports no JAX, so the card-only tests also run where JAX is
absent: ``python -m pytest tests/test_torch_train_kernels.py -m gpu
--noconftest``.
"""
import os

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


@pytest.mark.gpu
@pytest.mark.parametrize("n,C,m", [(512, 128, 512), (63977, 64, 8192), (183, 5, 1000)])
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
def test_a_training_step_on_the_card_matches_the_host(cuda):
    g = Graph.from_edge_input(CORNELL)
    spec = PaggSpec(feat_dim=32, hidden=64, out_dim=5, walk_len=4)
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
        assert err <= 1e-4 * scale, (k, err)
