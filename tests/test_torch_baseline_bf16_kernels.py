"""The bf16 instances of S1-S4 (``kernels/spmm.py``, ``kernels/segment_softmax.py``):
CPU dispatch and input checks, the per-add sum against a sequential one, a
seeded bf16 round bit-reproducible on the host, and (on a card) each
instance against its plain version on the host and two seeded bf16 GCN and
GAT rounds bit-equal.

On the card, the instances whose output is a bf16 sum rounded after each
add (all-bf16 S1 and S2, S1 of f32 terms into bf16) are bit-equal to their
plain versions on the host, which add in the same order; an f32 output
(bf16 rows with f32 weights) lies within 1e-6 of the plain version's
largest entry (the kernels' FMA); S3 within one bf16 ulp of each entry
(``expf``), S4 within one bf16 ulp of its largest entry (its f32 dot adds
with FMA on the card).

Tests marked ``gpu`` need a CUDA card; the ``cuda`` fixture skips them where
there is none. This file imports no JAX:
``python -m pytest tests/test_torch_baseline_bf16_kernels.py -m gpu --noconftest``.
"""
import os

import numpy as np
import pytest
import torch

from pathnet_tpu_torch import kernels as K
from pathnet_tpu_torch.config import TrainConfig
from pathnet_tpu_torch.data import Graph
from pathnet_tpu_torch.data.splits import ratio_masks
from pathnet_tpu_torch.kernels.spmm import per_add_rows
from pathnet_tpu_torch.models.baselines import Baseline, BaselineSpec, EdgeGraph
from pathnet_tpu_torch.models.baselines import build_baseline_graphs
from pathnet_tpu_torch.train.baseline_trainer import dropout_masks, run_baseline_round

EDGE = os.path.join(os.path.dirname(__file__), "..", "data", "edge_input")
B16 = torch.bfloat16
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


def instances(eg: EdgeGraph, heads: int, hdim: int, seed=0):
    """``(tag, wrapper, plain, args, kwargs, bits)`` for every bf16 instance
    at ``heads x hdim`` on ``eg`` (host tensors)."""
    gen = torch.Generator().manual_seed(seed)
    F = heads * hdim
    h, g = (torch.randn((eg.n, F), generator=gen) for _ in range(2))
    w = torch.rand((eg.num_edges, heads), generator=gen)
    rows = torch.randn((eg.num_edges, F), generator=gen).to(B16)
    D = (eg.dst_ptr, eg.dst_perm, eg.dst_col)
    S = (eg.src_ptr, eg.src_perm, eg.src_col)
    return [("S1 bf16 rows, f32 weights", K.spmm, K.spmm_plain, (h.to(B16), w) + D, {}, False),
            ("S1 f32 terms into bf16", K.spmm, K.spmm_plain, (g, w) + S, {"out_dtype": B16},
             True),
            ("S1 all bf16", K.spmm, K.spmm_plain, (h.to(B16), w.to(B16)) + D, {}, True),
            ("S1 all bf16, transposed", K.spmm, K.spmm_plain, (g.to(B16), w.to(B16)) + S, {},
             True),
            ("S1 bf16 edge rows by node", K.spmm, K.spmm_plain,
             (rows, None, eg.src_ptr, eg.src_perm, eg.src_perm), {}, True),
            ("S2 f32 g, bf16 h", K.edge_dot, K.edge_dot_plain,
             (g, h.to(B16), eg.src, eg.dst, heads), {}, False),
            ("S2 all bf16", K.edge_dot, K.edge_dot_plain,
             (g.to(B16), h.to(B16), eg.src, eg.dst, heads), {}, True)]


def test_per_add_rows_adds_one_term_at_a_time_in_row_order():
    """Rows of 0 to 40 terms (and a long one), against a sequential sum
    that rounds to bf16 after each add."""
    rng = np.random.default_rng(0)
    deg = np.concatenate([rng.integers(0, 40, 60), [0, 500, 0]])
    ptr = torch.from_numpy(np.concatenate([[0], np.cumsum(deg)]).astype(np.int32))
    terms = torch.from_numpy(rng.normal(size=(int(deg.sum()), 3)) * 10).to(B16)
    got = per_add_rows(terms, ptr)
    for i in range(len(deg)):
        acc = torch.zeros(3, dtype=B16)
        for j in range(int(ptr[i]), int(ptr[i + 1])):
            acc = (acc.float() + terms[j].float()).to(B16)
        assert torch.equal(got[i], acc), i


@pytest.mark.parametrize("heads,hdim", [(1, 8), (8, 64), (3, 5)])
def test_bf16_cpu_tensors_take_the_plain_versions_and_count_no_launch(heads, hdim):
    eg = EdgeGraph.from_graph(cornell(), "none", True, device="cpu")
    K.reset_launch_counts()
    for tag, kern, plain, args, kw, _ in instances(eg, heads, hdim):
        got = kern(*args, **kw)
        assert torch.equal(got, plain(*args, **kw)), tag
        want = B16 if ("into bf16" in tag or "all bf16" in tag or "by node" in tag) \
            else torch.float32
        assert got.dtype == want, tag
    s = 3 * torch.randn((eg.num_edges, heads), generator=torch.Generator().manual_seed(1))
    a = K.segment_softmax(s.to(B16), eg.dst_ptr, eg.dst_perm)
    assert a.dtype == B16 and torch.equal(a, K.segment_softmax_plain(s.to(B16), eg.dst_ptr,
                                                                     eg.dst_perm))
    ds = K.segment_softmax_bwd(a, s.to(B16), eg.dst_ptr, eg.dst_perm)
    assert ds.dtype == B16 and torch.equal(ds, K.segment_softmax_bwd_plain(a, s.to(B16),
                                                                           eg.dst_ptr,
                                                                           eg.dst_perm))
    assert all(K.launch_counts()[name] == 0 for name in NEW)


def test_the_wrappers_refuse_dtypes_without_an_instance():
    eg = EdgeGraph.from_graph(cornell(), "none", True, device="cpu")
    n, E = eg.n, eg.num_edges
    h, w = torch.randn((n, 4)), torch.rand((E, 1))
    D = (eg.dst_ptr, eg.dst_perm, eg.dst_col)
    for args, kw in (((h, w.to(B16)) + D, {}),                  # f32 rows, bf16 weights
                     ((h.to(B16), w) + D, {"out_dtype": B16}),   # bf16 rows, f32 weights
                     ((h.to(B16), w.to(B16)) + D, {"out_dtype": torch.float32}),
                     ((h.half(), w) + D, {})):
        with pytest.raises(TypeError):
            K.spmm(*args, **kw)
    with pytest.raises(TypeError, match="no instance"):
        K.edge_dot(h.to(B16), h, eg.src, eg.dst, 1)
    s = torch.randn((E, 2))
    with pytest.raises(TypeError, match="bfloat16"):
        K.segment_softmax_bwd(s.to(B16), s, eg.dst_ptr, eg.dst_perm)
    with pytest.raises(TypeError, match="bfloat16"):
        K.segment_softmax(s.half(), eg.dst_ptr, eg.dst_perm)


def seeded_round(name, device, epochs, dropout=0.5):
    g = cornell(F=24)
    spec = BaselineSpec(name=name, feat_dim=24, hidden=16, out_dim=5, heads=4,
                        dropout=dropout, n_nodes=g.n, compute_dtype="bfloat16")
    tr, va, te = ratio_masks(g.n, 1000, val_size=30)[:3]
    return run_baseline_round(g, spec, TrainConfig(epochs=epochs, lr=0.01), tr, va, te, 5,
                              seed=3, device=device, track_history=True)


@pytest.mark.parametrize("name", ["gcn", "gat"])
def test_a_seeded_bf16_baseline_round_is_bit_reproducible_on_the_host(name):
    torch.set_num_threads(max(4, torch.get_num_threads()))
    a, b = (seeded_round(name, "cpu", 8) for _ in range(2))
    assert a.best_val_acc == b.best_val_acc and a.metrics == b.metrics
    assert np.array_equal(a.losses, b.losses)


@pytest.mark.gpu
@pytest.mark.parametrize("heads,hdim", [(1, 8), (1, 64), (1, 1703), (8, 64), (3, 5), (8, 8),
                                        (8, 40)])
def test_bf16_spmm_and_edge_dot_instances_equal_plain_on_the_card(cuda, heads, hdim):
    """Each bf16 S1 and S2 instance on the card against its plain version on
    the host: bit-equal where the sum is bf16, else within 1e-6 of the
    plain version's largest entry; two calls bit-equal; empty rows 0."""
    eg = EdgeGraph.from_graph(cornell(), "none", False, device="cpu")   # 3 empty rows
    cpu = torch.device("cpu")
    for tag, kern, plain, args, kw, bits in instances(eg, heads, hdim):
        dargs = [a.to(cuda) if isinstance(a, torch.Tensor) else a for a in args]
        K.reset_launch_counts()
        got, again = kern(*dargs, **kw), kern(*dargs, **kw)
        torch.cuda.synchronize()
        assert K.launch_counts()[kern.__name__] == 2, tag
        want = plain(*args, **kw)
        got, again = got.to(cpu), again.to(cpu)
        assert got.dtype == want.dtype and torch.equal(got, again), tag
        if bits:
            assert torch.equal(got, want), tag
        else:
            err = float((got - want).abs().max())
            assert err <= 1e-6 * float(want.abs().max()), (tag, err)
        if kern is K.spmm:
            assert not got[-3:].any(), tag


@pytest.mark.gpu
@pytest.mark.parametrize("heads", [1, 8, 3])
def test_bf16_segment_softmax_instances_match_plain_on_the_card(cuda, heads):
    eg = EdgeGraph.from_graph(cornell(), "none", True, device="cpu")
    gen = torch.Generator().manual_seed(heads)
    s = (3 * torch.randn((eg.num_edges, heads), generator=gen)).to(B16)
    da = torch.randn((eg.num_edges, heads), generator=gen).to(B16)
    P = (eg.dst_ptr, eg.dst_perm)
    Pc = tuple(t.to(cuda) for t in P)
    K.reset_launch_counts()
    a, a2 = (K.segment_softmax(s.to(cuda), *Pc) for _ in range(2))
    want = K.segment_softmax_plain(s, *P)
    ds, ds2 = (K.segment_softmax_bwd(want.to(cuda), da.to(cuda), *Pc) for _ in range(2))
    torch.cuda.synchronize()
    counts = K.launch_counts()
    assert counts["segment_softmax"] == counts["segment_softmax_bwd"] == 2
    assert torch.equal(a, a2) and torch.equal(ds, ds2) and a.dtype == ds.dtype == B16
    w = want.float()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp(min=2.0 ** -126))) - 7)
    assert bool(((a.cpu().float() - w).abs() <= ulp).all())
    dwant = K.segment_softmax_bwd_plain(want, da, *P).float()
    assert float((ds.cpu().float() - dwant).abs().max()) <= 2.0 ** -8 * float(dwant.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["gcn", "gat"])
def test_two_seeded_bf16_baseline_rounds_are_bit_equal_on_the_card(cuda, name):
    K.reset_launch_counts()
    a, b = (seeded_round(name, cuda, 30) for _ in range(2))
    assert a.best_val_acc == b.best_val_acc and a.metrics == b.metrics
    assert np.array_equal(a.losses, b.losses) and np.array_equal(a.history, b.history)
    counts = K.launch_counts()
    assert counts["spmm"] > 0 and (name == "gcn" or all(counts[k] > 0 for k in NEW))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["gcn", "gat", "fagcn", "link"])
def test_a_bf16_training_step_on_the_card_is_near_the_host(cuda, name):
    """Logits and every gradient on the card within 2**-4 of the host's
    largest entry: the bf16 matmuls add in another order there, and a
    product that rounds the other way moves what follows by a bf16 ulp."""
    g = cornell(F=24)
    spec = BaselineSpec(name=name, feat_dim=24, hidden=16, out_dim=5, heads=8, dropout=0.5,
                        n_nodes=g.n, compute_dtype="bfloat16")
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
        assert out[0][k].dtype == torch.float32, k
        assert float((out[0][k] - want).abs().max()) <= 2.0 ** -4 * max(
            float(want.abs().max()), 1e-6), k
