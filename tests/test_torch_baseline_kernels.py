"""The baseline zoo's kernels S1-S4 (``kernels/spmm.py``,
``kernels/segment_softmax.py``): CPU dispatch and input checks, a seeded
round bit-reproducible on the host, and (on a card) each kernel against its
plain version and two seeded GCN and GAT rounds bit-equal.

Tests marked ``gpu`` need a CUDA card; the ``cuda`` fixture skips them where
there is none. This file imports no JAX:
``python -m pytest tests/test_torch_baseline_kernels.py -m gpu --noconftest``.
"""
import os

import numpy as np
import pytest
import torch

from pathnet_tpu_torch import kernels as K
from pathnet_tpu_torch.config import TrainConfig
from pathnet_tpu_torch.data import Graph
from pathnet_tpu_torch.data.splits import ratio_masks
from pathnet_tpu_torch.kernels.spmm import csr_rows
from pathnet_tpu_torch.models.baselines import Baseline, BaselineSpec, EdgeGraph
from pathnet_tpu_torch.models.baselines import build_baseline_graphs
from pathnet_tpu_torch.train.baseline_trainer import dropout_masks, run_baseline_round

EDGE = os.path.join(os.path.dirname(__file__), "..", "data", "edge_input")
NEW = ("spmm", "edge_dot", "segment_softmax", "segment_softmax_bwd")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def cornell(F=12, isolated=3, seed=0):
    """Cornell's structure with ``isolated`` extra nodes of no edge, random
    features and labels."""
    g = Graph.from_edge_input(os.path.join(EDGE, "cornell.in"))
    rng = np.random.default_rng(seed)
    n = g.n + isolated
    return Graph(n=n, src=g.src, dst=g.dst, prob=g.prob,
                 features=rng.normal(size=(n, F)).astype(np.float32),
                 labels=rng.integers(0, 5, size=n))


def operands(eg: EdgeGraph, heads: int, hdim: int, seed=0, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    F = heads * hdim
    h = torch.randn((eg.n, F), generator=gen).to(device)
    g = torch.randn((eg.n, F), generator=gen).to(device)
    w = torch.rand((eg.num_edges, heads), generator=gen).to(device)
    s = torch.randn((eg.num_edges, heads), generator=gen).to(device)
    return h, g, w, s


def test_csr_orders_hold_every_edge_once_in_a_stable_row_order():
    g = cornell()
    for norm, loops in (("sym", True), ("rw", False), ("none", False)):
        eg = EdgeGraph.from_graph(g, norm, loops, device="cpu")
        for key, other, ptr, perm, col in ((eg.dst, eg.src, eg.dst_ptr, eg.dst_perm, eg.dst_col),
                                           (eg.src, eg.dst, eg.src_ptr, eg.src_perm, eg.src_col)):
            assert torch.equal(torch.sort(perm.long()).values, torch.arange(eg.num_edges))
            assert torch.equal(torch.diff(ptr.long()), torch.bincount(key.long(), minlength=eg.n))
            rows = csr_rows(ptr)
            assert torch.equal(key[perm.long()].long(), rows)
            # stable: a row's edges keep the edge list's order
            same = rows[1:] == rows[:-1]
            assert bool((perm[1:][same] > perm[:-1][same]).all())
            assert torch.equal(col, other[perm.long()])
        # the isolated nodes' rows: empty, or their self-loop alone
        assert int(eg.dst_ptr[-1] - eg.dst_ptr[-4]) == (3 if loops else 0)


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    eg = EdgeGraph.from_graph(cornell(), "none", True, device="cpu")
    h, g, w, s = operands(eg, 3, 5)
    K.reset_launch_counts()
    assert torch.equal(K.spmm(h, w, eg.dst_ptr, eg.dst_perm, eg.dst_col),
                       K.spmm_plain(h, w, eg.dst_ptr, eg.dst_perm, eg.dst_col))
    assert torch.equal(K.edge_dot(g, h, eg.src, eg.dst, 3),
                       K.edge_dot_plain(g, h, eg.src, eg.dst, 3))
    a = K.segment_softmax(s, eg.dst_ptr, eg.dst_perm)
    assert torch.equal(a, K.segment_softmax_plain(s, eg.dst_ptr, eg.dst_perm))
    assert torch.equal(K.segment_softmax_bwd(a, w, eg.dst_ptr, eg.dst_perm),
                       K.segment_softmax_bwd_plain(a, w, eg.dst_ptr, eg.dst_perm))
    assert all(K.launch_counts()[name] == 0 for name in NEW)


def test_wrappers_reject_bad_inputs():
    eg = EdgeGraph.from_graph(cornell(), "none", True, device="cpu")
    h, g, w, s = operands(eg, 2, 4)
    with pytest.raises(ValueError, match="heads"):
        K.spmm(h, torch.ones((eg.num_edges, 3)), eg.dst_ptr, eg.dst_perm, eg.dst_col)
    with pytest.raises(TypeError, match="int32"):
        K.spmm(h, w, eg.dst_ptr.long(), eg.dst_perm, eg.dst_col)
    with pytest.raises(TypeError, match="float32"):
        K.edge_dot(g.double(), h, eg.src, eg.dst, 2)
    with pytest.raises(ValueError, match="shape"):
        K.segment_softmax(s[:-1], eg.dst_ptr, eg.dst_perm)
    with pytest.raises(ValueError, match="shape"):
        K.segment_softmax_bwd(s, s[:, :1].contiguous(), eg.dst_ptr, eg.dst_perm)


def seeded_round(name, device, epochs, dropout=0.5):
    g = cornell(F=24)
    spec = BaselineSpec(name=name, feat_dim=24, hidden=16, out_dim=5, heads=4,
                        dropout=dropout, n_nodes=g.n)
    tr, va, te = ratio_masks(g.n, 1000, val_size=30)[:3]
    return run_baseline_round(g, spec, TrainConfig(epochs=epochs, lr=0.01), tr, va, te, 5,
                              seed=3, device=device)


@pytest.mark.parametrize("name", ["gcn", "gat", "fagcn"])
def test_a_seeded_baseline_round_is_bit_reproducible_on_the_host(name):
    torch.set_num_threads(max(4, torch.get_num_threads()))
    a, b = (seeded_round(name, "cpu", 12) for _ in range(2))
    assert a.best_val_acc == b.best_val_acc and a.metrics == b.metrics


def test_dropout_masks_are_keyed_by_seed_epoch_and_call():
    m = dropout_masks(1, 2, 0.5)
    shape, cpu = (40, 8), torch.device("cpu")
    assert torch.equal(m(0, shape, cpu), dropout_masks(1, 2, 0.5)(0, shape, cpu))
    others = (m(1, shape, cpu), dropout_masks(1, 3, 0.5)(0, shape, cpu),
              dropout_masks(2, 2, 0.5)(0, shape, cpu))
    assert all(not torch.equal(m(0, shape, cpu), o) for o in others)


@pytest.mark.gpu
@pytest.mark.parametrize("heads,hdim", [(1, 8), (1, 64), (1, 1703), (8, 64), (3, 5), (1, 5),
                                        (8, 8)])
def test_spmm_and_edge_dot_kernels_equal_plain(cuda, heads, hdim):
    """S1 on both CSR orders, S1 summing edge rows (no weights) and S2
    within 1e-5 of the plain versions' largest entry (the plain versions
    add with atomics on the card), empty rows exactly 0, two calls
    bit-equal."""
    eg = EdgeGraph.from_graph(cornell(), "none", False, device=cuda)   # 3 empty rows
    h, g, w, _ = operands(eg, heads, hdim, device=cuda)
    rows = torch.randn((eg.num_edges, heads * hdim), generator=torch.Generator().manual_seed(1))
    cases = [((h, w, eg.dst_ptr, eg.dst_perm, eg.dst_col), K.spmm, K.spmm_plain),
             ((g, w, eg.src_ptr, eg.src_perm, eg.src_col), K.spmm, K.spmm_plain),
             ((rows.to(cuda), None, eg.src_ptr, eg.src_perm, eg.src_perm), K.spmm, K.spmm_plain),
             ((g, h, eg.src, eg.dst, heads), K.edge_dot, K.edge_dot_plain)]
    for args, kern, plain in cases:
        K.reset_launch_counts()
        got, again = kern(*args), kern(*args)
        torch.cuda.synchronize()
        assert K.launch_counts()[kern.__name__] == 2
        want = plain(*args)
        assert float((got - want).abs().max()) <= 1e-5 * max(float(want.abs().max()), 1.0)
        assert torch.equal(got, again)
    out = K.spmm(h, w, eg.dst_ptr, eg.dst_perm, eg.dst_col)
    assert not out[-3:].any()


@pytest.mark.gpu
@pytest.mark.parametrize("heads", [1, 8, 3])
def test_segment_softmax_kernels_equal_plain(cuda, heads):
    eg = EdgeGraph.from_graph(cornell(), "none", True, device=cuda)
    _, _, da, s = operands(eg, heads, 1, device=cuda)
    K.reset_launch_counts()
    a, a2 = (K.segment_softmax(s, eg.dst_ptr, eg.dst_perm) for _ in range(2))
    ds, ds2 = (K.segment_softmax_bwd(a, da, eg.dst_ptr, eg.dst_perm) for _ in range(2))
    torch.cuda.synchronize()
    counts = K.launch_counts()
    assert counts["segment_softmax"] == counts["segment_softmax_bwd"] == 2
    assert torch.equal(a, a2) and torch.equal(ds, ds2)
    assert float((a - K.segment_softmax_plain(s, eg.dst_ptr, eg.dst_perm)).abs().max()) <= 1e-6
    want = K.segment_softmax_bwd_plain(a, da, eg.dst_ptr, eg.dst_perm)
    assert float((ds - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["gcn", "gat"])
def test_two_seeded_baseline_rounds_are_bit_equal_on_the_card(cuda, name):
    K.reset_launch_counts()
    a, b = (seeded_round(name, cuda, 30) for _ in range(2))
    assert a.best_val_acc == b.best_val_acc and a.metrics == b.metrics
    counts = K.launch_counts()
    assert counts["spmm"] > 0 and (name == "gcn" or all(counts[k] > 0 for k in NEW))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["gcn", "gat", "fagcn", "link"])
def test_a_training_step_on_the_card_equals_the_host(cuda, name):
    g = cornell(F=24)
    spec = BaselineSpec(name=name, feat_dim=24, hidden=16, out_dim=5, heads=8, dropout=0.5,
                        n_nodes=g.n)
    X = torch.from_numpy(g.features)
    y = torch.from_numpy(np.asarray(g.labels, np.int64))
    masks = dropout_masks(0, 0, 0.5)
    out = []
    for dev in (cuda, torch.device("cpu")):
        m = Baseline(spec, device=dev, generator=torch.Generator().manual_seed(1))
        logits = m(X.to(dev), build_baseline_graphs(g, name, dev), train=True,
                   masks=lambda i, s, d: masks(i, s, torch.device("cpu")).to(d))
        torch.nn.functional.cross_entropy(logits, y.to(dev)).backward()
        out.append({"logits": logits.detach().cpu(),
                    **{k: p.grad.cpu() for k, p in m.named_parameters()}})
    for k, want in out[1].items():
        assert float((out[0][k] - want).abs().max()) <= 1e-4 * max(float(want.abs().max()),
                                                                    1e-6), k
