"""A seeded round is reproducible and keeps its parameters.

On the card (tests marked ``gpu``) and on a multi-threaded CPU: two
``run_round`` calls with one seed give bit-equal ``history``, ``losses`` and
``best_params``; every sum on the training path is taken in an order fixed
by the inputs (on the CPU the plain versions gather with ``index_select``,
whose backward ``index_add_`` adds in row order, where ``h[idx]``'s
``index_put_`` adds in thread order). This file imports
no JAX, so the card-only tests also run where JAX is absent:
``python -m pytest tests/test_torch_reproducible.py -m gpu --noconftest``.
"""
import os

import numpy as np
import pytest
import torch

from pathnet_tpu_torch import kernels as K
from pathnet_tpu_torch.config import TrainConfig
from pathnet_tpu_torch.data import Graph
from pathnet_tpu_torch.data.splits import ratio_masks
from pathnet_tpu_torch.kernels.pagg_encode_bwd import class_contractions
from pathnet_tpu_torch.kernels.pagg_encode_bwd import row_nodes
from pathnet_tpu_torch.kernels.segment_sum import RUN, segments, segments_plain
from pathnet_tpu_torch.models import PaggSpec
from pathnet_tpu_torch.sample import PathSampler
from pathnet_tpu_torch.train import run_round

ROOT = os.path.join(os.path.dirname(__file__), "..")
CORNELL = os.path.join(ROOT, "data", "edge_input", "cornell.in")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def cornell_round(dev, epochs, microbatch=None, hidden=64, variant="hetero"):
    """A seeded round on cornell's structure at full width (F = 1703,
    nw = 40, wl = 4, dropout 0.7) with features and labels from a seed."""
    g = Graph.from_edge_input(CORNELL)
    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.normal(size=(g.n, 1703)).astype(np.float32)).to(dev)
    labels = rng.integers(0, 5, size=g.n)
    y = torch.from_numpy(labels).to(dev)
    masks = ratio_masks(g.n, 1000, val_size=59)[:3]
    ps = PathSampler.build(g, 40, 4, device=dev)
    spec = PaggSpec(feat_dim=1703, hidden=hidden, out_dim=5, walk_len=4, dropout=0.7,
                    variant=variant)
    cfg = TrainConfig(epochs=epochs, microbatch=microbatch)
    return run_round(X, y, ps, spec, cfg, *masks, 5, seed=3, track_history=True,
                     keep_params=True)


def assert_bit_equal(a, b):
    assert np.array_equal(a.history, b.history)
    assert np.array_equal(a.losses, b.losses)
    assert a.metrics == b.metrics
    assert a.best_params.keys() == b.best_params.keys()
    for k, v in a.best_params.items():
        assert torch.equal(v, b.best_params[k]), k


@pytest.fixture
def threads():
    """More than one CPU thread for the test, as the driver's workers have."""
    before = torch.get_num_threads()
    torch.set_num_threads(max(before, 4))
    yield torch.get_num_threads()
    torch.set_num_threads(before)


def plain_backward_case(homo, bf16, H=16, seed=0):
    """K4's plain inputs on cornell's walks (183 targets, nw = 40, wl = 4:
    36,600 gathered rows into 183 nodes) with a keep mask."""
    g = Graph.from_edge_input(CORNELL)
    ps = PathSampler.build(g, 40, 4, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    paths, dists = ps.sample(torch.arange(g.n, dtype=torch.int32), generator=gen)
    h = torch.randn((g.n, H), generator=gen) * 0.5
    rnd = lambda *s: (torch.rand(s, generator=gen) * 2 - 1) / H ** 0.5
    w = [rnd(4, H, H), rnd(4, H), rnd(H, 4 * H), rnd(H, 4 * H), rnd(4 * H), rnd(4 * H)]
    if bf16:
        h, w = h.bfloat16(), [t.bfloat16() for t in w]
    mask = (torch.rand((4, g.n * 40, H), generator=gen) < 0.3).to(torch.uint8)
    gout = torch.randn((g.n, H), generator=gen)
    return (gout, h, paths, dists, *w, rnd(2 * H), rnd(1), mask, 0.3, homo)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("homo", [False, True], ids=["hetero", "homo"])
def test_plain_encode_backward_is_bit_equal_on_two_calls_on_the_host(threads, homo, bf16):
    assert threads > 1
    args = plain_backward_case(homo, bf16)
    first = K.pagg_encode_bwd_plain(*args)
    for _ in range(2):
        for name, a, b in zip(("dh", "dwd", "dbd", "dw_ih", "dw_hh", "db_ih", "db_hh",
                               "dattw", "dattb"), K.pagg_encode_bwd_plain(*args), first):
            assert torch.equal(a, b), name


@pytest.mark.parametrize("variant", ["hetero", "homo"])
def test_two_seeded_rounds_are_bit_equal_on_the_host(threads, variant):
    assert threads > 1
    a = cornell_round("cpu", 3, hidden=16, variant=variant)
    b = cornell_round("cpu", 3, hidden=16, variant=variant)
    assert np.isfinite(a.losses).all()
    assert_bit_equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("microbatch", [None, 32])
def test_two_seeded_rounds_are_bit_equal_on_the_card(cuda, microbatch):
    a = cornell_round(cuda, 30, microbatch)
    b = cornell_round(cuda, 30, microbatch)
    assert np.isfinite(a.losses).all()
    assert_bit_equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("microbatch", [None, 32])
def test_two_seeded_homo_rounds_are_bit_equal_on_the_card(cuda, microbatch):
    a = cornell_round(cuda, 30, microbatch, variant="homo")
    b = cornell_round(cuda, 30, microbatch, variant="homo")
    assert np.isfinite(a.losses).all()
    assert_bit_equal(a, b)


def old_class_contractions(x, s, d, classes, tile=4096):
    """``class_contractions`` as it summed its tiles before, with
    ``index_add_`` (whose order on a card changes from run to run)."""
    R, H = x.shape
    rank = (torch.arange(classes)[:, None] == d).cumsum(1)
    padded = (rank[:, -1] + tile - 1) // tile * tile
    ends = padded.cumsum(0)
    dest = (ends - padded)[d] + rank.gather(0, d[None])[0] - 1
    ntiles = R // tile + classes
    xp = x.new_zeros((ntiles * tile, H)).index_copy_(0, dest, x)
    sp = s.new_zeros((ntiles * tile, H)).index_copy_(0, dest, s).view(ntiles, tile, H)
    cls = torch.bucketize(torch.arange(ntiles) * tile, ends, right=True).clamp_(max=classes - 1)
    prod = torch.bmm(xp.view(ntiles, tile, H).transpose(1, 2), sp)
    return (x.new_zeros((classes, H, H)).index_add_(0, cls, prod),
            x.new_zeros((classes, H)).index_add_(0, cls, sp.sum(dim=1)))


@pytest.mark.parametrize("R, tile", [(1000, 64), (37, 4096), (9000, 1024)])
def test_class_contractions_sum_their_tiles_as_index_add_did(R, tile):
    rng = np.random.default_rng(R)
    H, classes = 16, 4
    x = torch.from_numpy(rng.standard_normal((R, H)).astype(np.float32))
    s = torch.from_numpy(rng.standard_normal((R, H)).astype(np.float32))
    d = torch.from_numpy(rng.choice([0, 1, 3, 3, 3], size=R))   # class 2 empty
    for got, want in zip(class_contractions(
            x, s, d, classes, tile=tile), old_class_contractions(x, s, d, classes, tile)):
        torch.testing.assert_close(got, want, atol=0, rtol=1e-6)


def segment_case(R=5000, n=300, H=24, seed=0):
    gen = torch.Generator().manual_seed(seed)
    rows = torch.randn((R, H), generator=gen)
    # skewed even node ids: a few nodes take many rows, odd ones none
    index = (torch.rand(R, generator=gen) ** 3 * (n // 2)).to(torch.int32) * 2
    return rows, index, n


def test_segment_sum_equals_index_add_and_repeats_bit_for_bit():
    rows, index, n = segment_case()
    want = torch.zeros((n, rows.shape[1])).index_add_(0, index.long(), rows)
    a = K.segment_sum(rows, index, n)
    b = K.segment_sum(rows.clone(), index.clone(), n)
    torch.testing.assert_close(a, want, atol=1e-6, rtol=0)
    assert torch.equal(a, b)
    assert torch.equal(a, K.segment_sum_plain(rows, index, n))
    assert (a[index.unique().long()].abs().sum(1) > 0).all()
    empty = torch.ones(n, dtype=torch.bool)
    empty[index.long()] = False
    assert empty.any() and torch.equal(a[empty], torch.zeros_like(a[empty]))


def test_segment_sum_orders_each_nodes_rows_as_they_lie():
    """A node's rows are added from 0 in their order in ``rows``: three
    values whose f32 sum depends on the order give the sequential sum
    ((1e8 + 1) - 1e8 = 0 in f32, where (1e8 - 1e8) + 1 = 1). The grouping
    names rows 0-2 as one unit of node 2 (first row 0, length 3) and row 3 as
    one of node 0."""
    rows = torch.tensor([[1e8], [1.0], [-1e8], [3.0]], dtype=torch.float32)
    index = torch.tensor([2, 2, 2, 0], dtype=torch.int32)
    out = K.segment_sum(rows, index, 3)
    assert out[:, 0].tolist() == [3.0, 0.0, 0.0]
    units, offsets = segments(index, 3)
    assert units[:2].tolist() == [3 * RUN + 0, 0 * RUN + 2] and offsets.tolist() == [0, 1, 1, 2]


def sequential_sum(rows, index, n):
    """Each node's rows added one after another in row order: a stable sort
    of the ids, then ``index_add_`` (sequential on the CPU)."""
    order = torch.sort(index, stable=True).indices
    return torch.zeros((n, rows.shape[1])).index_add_(0, index[order].long(), rows[order])


def k4_index(T, nw, wl, n, pad, seed):
    """``row_nodes`` of walks of ``T`` targets, the last ``pad`` of them the
    padding at node 0, as a microbatch of K4 lays them out."""
    gen = torch.Generator().manual_seed(seed)
    paths = torch.randint(0, n, (T, nw, wl), generator=gen, dtype=torch.int32)
    paths[:, :, 0] = torch.randperm(n - 1, generator=gen)[:T, None].to(torch.int32) + 1
    paths[T - pad:, :, 0] = 0
    return row_nodes(paths)


def grouping_case(kind):
    gen = torch.Generator().manual_seed(len(kind))
    if kind == "runs of equal ids":             # K4's runs of 40 ego and position-0 rows
        index, n = k4_index(50, 40, 4, 500, 0, 1), 500
    elif kind == "a run longer than a piece":   # padding: 2 runs of 40 x 300 rows to node 0
        index, n = k4_index(400, 40, 4, 5000, 300, 2), 5000
    elif kind == "empty nodes":                  # odd nodes and the top half have no row
        index, n = torch.randint(0, 200, (7000,), generator=gen, dtype=torch.int32) * 2, 800
    else:                                        # three radix passes on the card
        index = torch.randint(0, 70_000, (30_000,), generator=gen, dtype=torch.int32)
        index[1000:5000] = 69_999
        n = 70_001
    rows = torch.randn((index.shape[0], 8), generator=gen)
    return rows, index, n


@pytest.mark.parametrize("kind", ["runs of equal ids", "a run longer than a piece",
                                  "empty nodes", "more than 65,536 nodes"])
def test_grouping_keeps_each_nodes_rows_in_row_order(kind):
    """The units cover each row once, lie in (node, first row) order and
    stay inside their aligned window; the plain sum over them is bit-equal
    to the sequential sum of each node's rows in row order."""
    rows, index, n = grouping_case(kind)
    R = index.shape[0]
    units, offsets = segments_plain(index, n)
    U = int(offsets[-1])
    u = units[:U].long()
    first, length = u // RUN, u % RUN + 1
    assert ((first % RUN) + length <= RUN).all() and U < R
    covered = torch.zeros(R, dtype=torch.int64)
    for k in range(RUN):
        covered.index_add_(0, (first + k)[length > k], torch.ones(int((length > k).sum()),
                                                                  dtype=torch.int64))
    assert (covered == 1).all()
    key = index[first].long()
    assert (key[1:] > key[:-1]).logical_or((key[1:] == key[:-1]) & (first[1:] > first[:-1])).all()
    assert torch.equal(offsets.long(), torch.searchsorted(key, torch.arange(n + 1)))
    for k in range(RUN):   # each unit is one node's
        inside = length > k
        assert torch.equal(index[(first + k)[inside]].long(), key[inside])
    got = K.segment_sum(rows, index, n)
    assert torch.equal(got, sequential_sum(rows, index, n))
    assert torch.equal(got[torch.diff(offsets) == 0], torch.zeros((int((torch.diff(offsets) == 0).sum()), 8)))


def test_segment_sum_rejects_bad_inputs():
    rows, index, n = segment_case(R=10, n=4)
    with pytest.raises(TypeError):
        K.segment_sum(rows.double(), index, n)
    with pytest.raises(TypeError):
        K.segment_sum(rows, index.long(), n)
    with pytest.raises(ValueError):
        K.segment_sum(rows, index[:-1], n)
    with pytest.raises(ValueError, match="unsupported device"):
        K.segment_sum(rows.to("meta"), index.to("meta"), n)


def test_padded_targets_send_exact_zeros_to_the_ego_row_scatter(monkeypatch):
    """K5's backward adds with atomics, but its only repeated index in a
    chunk is node 0, where ``_pad_chunks`` puts the padding at weight 0: the
    padded rows' gradients are exact zeros, so its sums do not depend on
    the order."""
    from pathnet_tpu_torch.models import pagg
    from pathnet_tpu_torch.models import PathNet
    from pathnet_tpu_torch.train import trainer

    g = Graph.from_edge_input(CORNELL)
    rng = np.random.default_rng(1)
    X = torch.from_numpy(rng.normal(size=(g.n, 12)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 5, size=g.n))
    ps = PathSampler.build(g, 6, 4, device="cpu")
    spec = PaggSpec(feat_dim=12, hidden=16, out_dim=5, walk_len=4, dropout=0.7)
    model = PathNet(spec, device="cpu")
    mask = np.zeros(g.n, bool)
    mask[rng.choice(np.arange(1, g.n), 45, replace=False)] = True
    mask[0] = True                       # node 0 is also a real target
    ic, wc, total = trainer.chunk_index(mask, 32, torch.device("cpu"))
    seen = []
    real = pagg.row_gather_bwd

    def spy(g_, idx, n, check=True):
        seen.append((g_.clone(), idx.clone()))
        return real(g_, idx, n, check=check)

    monkeypatch.setattr(pagg, "row_gather_bwd", spy)
    paths, dists = ps.sample(generator=torch.Generator().manual_seed(0))
    trainer.chunked_grads(model, X, y, paths, dists, ic, wc, total,
                          dropout_gen=lambda i: torch.Generator().manual_seed(i))
    assert len(seen) == ic.shape[0] == 2
    for (grad, idx), w in zip(seen, wc):
        pad = w == 0
        assert torch.equal(grad[pad], torch.zeros_like(grad[pad]))
        assert (idx[pad] == 0).all()
        real_idx = idx[~pad]
        assert real_idx.unique().numel() == real_idx.numel()
    assert (seen[1][1] == 0).sum() > 1 and (wc[1] == 0).sum() > 0


def assert_segment_sum_on_the_card(rows, index, n, cuda):
    """The kernel's grouping equals the plain one; its sum is within 1e-5 of
    the plain maximum and the same on two calls."""
    units, offsets = segments(index.to(cuda), n)
    units_p, offsets_p = segments_plain(index, n)
    U = int(offsets_p[-1])
    assert torch.equal(offsets.cpu(), offsets_p)
    assert torch.equal(units[:U].cpu(), units_p[:U])
    want = K.segment_sum_plain(rows, index, n)
    got = K.segment_sum(rows.to(cuda), index.to(cuda), n)
    again = K.segment_sum(rows.to(cuda), index.to(cuda), n)
    assert torch.equal(got, again)
    assert float((got.cpu() - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("R,n,H", [(5000, 300, 24), (1_638_400, 63977, 64), (38600, 403, 256),
                                   (17400, 183, 64), (999, 50, 37), (10, 4, 1)])
def test_segment_sum_kernel_matches_plain_on_the_card(cuda, R, n, H):
    assert_segment_sum_on_the_card(*segment_case(R, n, H, seed=R), cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["runs of equal ids", "a run longer than a piece",
                                  "empty nodes", "more than 65,536 nodes",
                                  "bgp microbatch, padded"])
def test_segment_sum_kernel_on_runs_and_wide_ids_on_the_card(cuda, kind):
    if kind == "bgp microbatch, padded":   # the last train chunk of the bgp stand-in
        index = k4_index(8192, 40, 4, 63977, 2060, 5)
        gen = torch.Generator().manual_seed(5)
        rows, n = torch.randn((index.shape[0], 64), generator=gen), 63977
    else:
        rows, index, n = grouping_case(kind)
    assert_segment_sum_on_the_card(rows, index, n, cuda)
