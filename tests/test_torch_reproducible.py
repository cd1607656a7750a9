"""A seeded round is reproducible and keeps its parameters.

On the card (tests marked ``gpu``): two ``run_round`` calls with one seed
give bit-equal ``history``, ``losses`` and ``best_params``; every sum on the
training path is taken in an order fixed by the inputs. This file imports
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
from pathnet_tpu_torch.kernels.segment_sum import segments
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


def cornell_round(dev, epochs, microbatch=None, hidden=64):
    """A seeded round on cornell's structure at full width (F = 1703,
    nw = 40, wl = 4, dropout 0.7) with features and labels from a seed."""
    g = Graph.from_edge_input(CORNELL)
    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.normal(size=(g.n, 1703)).astype(np.float32)).to(dev)
    labels = rng.integers(0, 5, size=g.n)
    y = torch.from_numpy(labels).to(dev)
    masks = ratio_masks(g.n, 1000, val_size=59)[:3]
    ps = PathSampler.build(g, 40, 4, device=dev)
    spec = PaggSpec(feat_dim=1703, hidden=hidden, out_dim=5, walk_len=4, dropout=0.7)
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


@pytest.mark.gpu
@pytest.mark.parametrize("microbatch", [None, 32])
def test_two_seeded_rounds_are_bit_equal_on_the_card(cuda, microbatch):
    a = cornell_round(cuda, 30, microbatch)
    b = cornell_round(cuda, 30, microbatch)
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
    ((1e8 + 1) - 1e8 = 0 in f32, where (1e8 - 1e8) + 1 = 1)."""
    rows = torch.tensor([[1e8], [1.0], [-1e8], [3.0]], dtype=torch.float32)
    index = torch.tensor([2, 2, 2, 0], dtype=torch.int32)
    out = K.segment_sum(rows, index, 3)
    assert out[:, 0].tolist() == [3.0, 0.0, 0.0]
    order, offsets = segments(index, 3)
    assert order.tolist() == [3, 0, 1, 2] and offsets.tolist() == [0, 1, 1, 4]


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


@pytest.mark.gpu
@pytest.mark.parametrize("R,n,H", [(5000, 300, 24), (1_638_400, 63977, 64), (38600, 403, 256),
                                   (999, 50, 37), (10, 4, 1)])
def test_segment_sum_kernel_matches_plain_on_the_card(cuda, R, n, H):
    rows, index, n = segment_case(R, n, H, seed=R)
    want = K.segment_sum_plain(rows, index, n)
    got = K.segment_sum(rows.to(cuda), index.to(cuda), n)
    again = K.segment_sum(rows.to(cuda), index.to(cuda), n)
    assert torch.equal(got, again)
    assert float((got.cpu() - want).abs().max()) <= 1e-5 * float(want.abs().max())
