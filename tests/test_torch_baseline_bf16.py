"""The baseline zoo at bf16 (``compute_dtype="bfloat16"``) against the JAX package, on the host.

JAX keeps the graphs' weights f32 under bf16 compute, so each sparse sum
takes the dtype JAX's promotion gives it, and where a sum stays bf16, XLA on
the CPU adds one term at a time, rounding to bf16 after each add, in edge
order. The same numpy-seeded inputs go through JAX's ops and the port's:

- **bit for bit**: JAX's ``segment_sum`` of 2,000 bf16 values in [0.5, 1.5]
  is 512, and so is the port's all-bf16 S1; the all-bf16 S1 (GAT's
  messages) and its transpose against ``segment_sum(z[src] * alpha)`` and
  ``jax.vjp``; the input gradient of ``spmm`` on bf16 rows (each f32 term
  rounded, then a bf16 per-add sum) and of a gather of bf16 rows; S2 of
  bf16 operands up to a head width of 32, where XLA's bf16 reduction adds
  one element at a time;
- ``spmm`` of bf16 rows with f32 weights (f32 out) and the f32 weight
  gradient of bf16 rows (FAGCN's): within **1e-6** of JAX's largest entry
  (the f32 instances' FMA);
- S3: within **one bf16 ulp** of each of JAX's outputs (``exp`` may differ
  by an f32 ulp);
- S2 past a head width of 32 and S4: within the larger of **4 ulps** of
  JAX's largest entry and **3 times** JAX's own f32-to-bf16 gap (XLA adds
  a wide bf16 row in an order of its own; S4 is the analytic VJP, rounded
  once, where JAX rounds op by op);
- every model's logits and gradients: ``test_torch_baseline_bf16_models.py``;
- a dropout-free 15-epoch round of gcn and gat from JAX's init: the best
  validation accuracy and the five test metrics equal JAX's jitted round;
- ``--model gcn|gat --dtype bfloat16`` through the CLI on the host.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathnet_tpu.config import TrainConfig as JTrainConfig
from pathnet_tpu.data import Graph as JGraph
from pathnet_tpu.models.baselines import ops as jops
from pathnet_tpu.models.baselines import zoo as jzoo
from pathnet_tpu.train.baseline_trainer import run_baseline_round as j_run_baseline_round

from pathnet_tpu_torch import kernels as K
from pathnet_tpu_torch import run
from pathnet_tpu_torch.config import TrainConfig
from pathnet_tpu_torch.data import Graph, registry
from pathnet_tpu_torch.models.baselines import (BASELINES, EXTRA_MODELS, Baseline,
                                                BaselineSpec, baseline_params_from_jax,
                                                build_baseline_graphs, segment_softmax, spmm)
from pathnet_tpu_torch.models.baselines.ops import gather_edges
from pathnet_tpu_torch.train import baseline_trainer
from pathnet_tpu_torch.train.checkpoint import completed_rounds, load_round
from test_torch_train_loop import CORNELL, cornell_root  # noqa: F401 (a fixture)

BF = jnp.bfloat16
B16 = torch.bfloat16
ULP = 2.0 ** -8           # a bf16 ulp relative to the value
NAMES = BASELINES + EXTRA_MODELS
KERNEL_ULPS, KERNEL_F32_GAPS = 4, 3   # S2 past 32, S4


def torch_of(x):
    """A JAX array as a torch tensor of its dtype (bf16 or f32)."""
    x = jnp.asarray(x)
    t = torch.from_numpy(np.array(x.astype(jnp.float32)))
    return t.to(B16) if x.dtype == BF else t


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def bit_equal(got: torch.Tensor, want) -> bool:
    return got.dtype == (B16 if jnp.asarray(want).dtype == BF else torch.float32) and \
        np.array_equal(f32(got), f32(want))


def port_graph(jg):
    return Graph(n=jg.n, src=np.asarray(jg.src), dst=np.asarray(jg.dst),
                 prob=np.asarray(jg.prob))


@pytest.fixture(scope="module")
def cornell():
    """Cornell with two isolated nodes."""
    jg = JGraph.from_edge_input(CORNELL)
    return JGraph(n=jg.n + 2, src=jg.src, dst=jg.dst, prob=jg.prob)


def edge_graphs(jg, name, key):
    """JAX's and the port's ``build_baseline_graphs(name)[key]``."""
    return (jzoo.build_baseline_graphs(jg, name)[key],
            build_baseline_graphs(port_graph(jg), name, "cpu")[key])


def within_gap(got, want, want32, ulps, gaps):
    """``|got - want|`` against the larger of ``ulps`` bf16 ulps of
    ``want``'s largest entry and ``gaps`` times JAX's own f32-to-bf16 gap
    ``|want32 - want|``; returns (error, limit)."""
    want, want32 = f32(want), f32(want32)
    err = float(np.abs(f32(got) - want).max())
    limit = max(ulps * ULP * float(np.abs(want).max()),
                gaps * float(np.abs(want32 - want).max()))
    return err, limit


def test_jax_adds_bf16_one_term_at_a_time_and_so_does_the_port():
    """The semantics probe: 2,000 bf16 values in [0.5, 1.5] summed into one
    segment give 512 (each add rounded: 512 + 1.5 is 512 in bf16), not
    2,000; the port's all-bf16 S1 gives the same bits, and so does torch's
    ``index_add_`` on a one-dimensional bf16 tensor."""
    v = jnp.asarray(np.random.default_rng(0).uniform(0.5, 1.5, 2000), BF)
    want = jax.ops.segment_sum(v, jnp.zeros(2000, jnp.int32), num_segments=1)
    assert float(want[0]) == 512.0
    assert abs(float(jnp.sum(v.astype(jnp.float32))) - 2000) < 20
    ptr = torch.tensor([0, 2000], dtype=torch.int32)
    perm = torch.arange(2000, dtype=torch.int32)
    got = K.spmm(torch_of(v)[:, None], None, ptr, perm, perm)
    assert bit_equal(got[:, 0], want)
    added = torch.zeros(1, dtype=B16).index_add_(0, torch.zeros(2000, dtype=torch.long),
                                                  torch_of(v))
    assert bit_equal(added, want)


@pytest.mark.parametrize("heads,hdim", [(1, 8), (8, 64), (3, 5)])
def test_all_bf16_spmm_and_its_transpose_are_bit_equal_to_jax(cornell, heads, hdim):
    """GAT's messages ``segment_sum(z[src] * alpha)``, all bf16: each product
    rounded, then a bf16 sum in edge order; the input gradient likewise over
    the source's edges."""
    jeg, eg = edge_graphs(cornell, "gat", "raw")
    rng = np.random.default_rng(heads * hdim)
    z = jnp.asarray(rng.normal(size=(cornell.n, heads, hdim)), BF)
    a = jnp.asarray(rng.random((eg.num_edges, heads)), BF)
    g = jnp.asarray(rng.normal(size=(cornell.n, heads, hdim)), BF)

    def f(zz, aa):
        return jax.ops.segment_sum(zz[jeg.src] * aa[:, :, None], jeg.dst, num_segments=jeg.n)

    want, vjp = jax.vjp(f, z, a)
    dz, _ = vjp(g)
    zt = torch_of(z).requires_grad_()
    out = spmm(eg, zt, torch_of(a))
    out.backward(torch_of(g))
    assert bit_equal(out, want) and bit_equal(zt.grad, dz)


@pytest.mark.parametrize("name,key,F_", [("gcn", "sym", 7), ("gcn", "sym", 64),
                                         ("sage", "mean", 16), ("fagcn", "symnl", 16)])
def test_spmm_of_bf16_rows_matches_jax_and_its_input_gradient_is_bit_equal(cornell, name, key,
                                                                           F_):
    """``spmm`` of bf16 rows with the graph's f32 weights: f32 out within
    1e-6 of JAX's largest entry; the gradient of the rows bit-equal (each
    f32 term ``g[dst] w`` rounded to bf16, then a bf16 sum in edge order);
    the weights' gradient (FAGCN's ``alpha * w``) within 1e-6."""
    jeg, eg = edge_graphs(cornell, name, key)
    rng = np.random.default_rng(F_)
    h = jnp.asarray(rng.normal(size=(cornell.n, F_)), BF)
    g = jnp.asarray(rng.normal(size=(cornell.n, F_)), jnp.float32)
    want, vjp = jax.vjp(lambda hh, ww: jops.spmm(jeg, hh, ww), h, jeg.w)
    dh, dw = vjp(g)
    ht, wt = torch_of(h).requires_grad_(), eg.w.clone().requires_grad_()
    out = spmm(eg, ht, wt)
    out.backward(torch_of(g))
    assert out.dtype == torch.float32 and wt.grad.dtype == torch.float32
    for got, w in ((out, want), (wt.grad, dw)):
        assert np.abs(f32(got) - f32(w)).max() <= 1e-6 * np.abs(f32(w)).max()
    assert bit_equal(ht.grad, dh)


@pytest.mark.parametrize("side", ["src", "dst"])
def test_the_gradient_of_a_bf16_gather_is_bit_equal_to_jax(cornell, side):
    jeg, eg = edge_graphs(cornell, "gat", "raw")
    rng = np.random.default_rng(len(side))
    x = jnp.asarray(rng.normal(size=(cornell.n, 3)), BF)
    g = jnp.asarray(rng.normal(size=(eg.num_edges, 3)), BF)
    idx = jeg.src if side == "src" else jeg.dst
    want, vjp = jax.vjp(lambda xx: xx[idx], x)
    (dx,) = vjp(g)
    xt = torch_of(x).requires_grad_()
    out = gather_edges(eg, xt, side)
    out.backward(torch_of(g))
    assert bit_equal(out, want) and bit_equal(xt.grad, dx)


@pytest.mark.parametrize("heads,hdim", [(2, 5), (1, 8), (8, 32), (8, 64), (1, 200)])
def test_bf16_edge_dot_matches_the_gradient_of_gats_weights(cornell, heads, hdim):
    """S2 of bf16 operands against ``jax.vjp`` in ``alpha``: each product
    rounded, added one element at a time; bit-equal up to a head width of 32,
    past it within ``KERNEL_ULPS`` ulps or ``KERNEL_F32_GAPS`` gaps."""
    jeg, eg = edge_graphs(cornell, "gat", "raw")
    rng = np.random.default_rng(heads + hdim)
    z = jnp.asarray(rng.normal(size=(cornell.n, heads, hdim)), BF)
    a = jnp.asarray(rng.random((eg.num_edges, heads)), BF)
    g = jnp.asarray(rng.normal(size=(cornell.n, heads, hdim)), BF)

    def da_of(zz, aa, gg):
        f = lambda a_: jax.ops.segment_sum(zz[jeg.src] * a_[:, :, None], jeg.dst,
                                           num_segments=jeg.n)
        return jax.vjp(f, aa)[1](gg)[0]

    want = da_of(z, a, g)
    got = K.edge_dot(torch_of(g).reshape(cornell.n, -1), torch_of(z).reshape(cornell.n, -1),
                     eg.src, eg.dst, heads)
    if hdim <= 32:
        assert bit_equal(got, want)
    else:
        want32 = da_of(*(t.astype(jnp.float32) for t in (z, a, g)))
        err, limit = within_gap(got, want, want32, KERNEL_ULPS, KERNEL_F32_GAPS)
        assert got.dtype == B16 and err <= limit


@pytest.mark.parametrize("heads", [1, 8])
def test_bf16_segment_softmax_within_an_ulp_of_jax_and_its_gradient_within_tolerance(cornell,
                                                                                      heads):
    """S3 on bf16 scores: every output within one bf16 ulp of JAX's; S4
    against ``jax.vjp`` within ``KERNEL_ULPS`` ulps or ``KERNEL_F32_GAPS``
    times JAX's own f32-to-bf16 gap."""
    jeg, eg = edge_graphs(cornell, "gat", "raw")
    rng = np.random.default_rng(heads)
    s = jnp.asarray(3 * rng.normal(size=(eg.num_edges, heads)), BF)
    g = jnp.asarray(rng.normal(size=(eg.num_edges, heads)), BF)

    def f(x):
        return jax.vmap(lambda c: jops.segment_softmax(c, jeg.dst, jeg.n),
                        in_axes=1, out_axes=1)(x)

    want, vjp = jax.vjp(f, s)
    (ds,) = vjp(g)
    _, vjp32 = jax.vjp(f, s.astype(jnp.float32))
    (ds32,) = vjp32(g.astype(jnp.float32))
    st = torch_of(s).requires_grad_()
    out = segment_softmax(eg, st)
    out.backward(torch_of(g))
    assert out.dtype == st.grad.dtype == B16
    w = f32(want)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 2.0 ** -126))) - 7)
    assert (np.abs(f32(out) - w) <= ulp).all()
    err, limit = within_gap(st.grad, ds, ds32, KERNEL_ULPS, KERNEL_F32_GAPS)
    assert err <= limit


@pytest.mark.parametrize("name", ["gcn", "gat"])
def test_a_bf16_round_from_jaxs_init_equals_jaxs_round(small_graph, monkeypatch, name):
    """Dropout 0, 15 epochs, bf16, JAX's init params: ``best_val_acc`` and
    the five test metrics equal those of JAX's jitted round."""
    jg = small_graph
    kw = dict(name=name, feat_dim=jg.features.shape[1], hidden=16, out_dim=3, heads=2,
              dropout=0.0, n_nodes=jg.n, compute_dtype="bfloat16")
    jspec, spec = jzoo.BaselineSpec(**kw), BaselineSpec(**kw)
    rng = np.random.default_rng(1)
    perm = rng.permutation(jg.n)
    masks = [np.zeros(jg.n, bool) for _ in range(3)]
    for m, part in zip(masks, np.split(perm, [30, 45])):
        m[part] = True
    want = j_run_baseline_round(jg, jspec, JTrainConfig(lr=0.01, epochs=15), *masks, 3, seed=2)
    kinit = jax.random.split(jax.random.PRNGKey(2))[0]
    sd = baseline_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jzoo.init_baseline(kinit, jspec)), spec)
    real = baseline_trainer.Baseline

    def from_jax(*a, **k):
        m = real(*a, **k)
        m.load_state_dict(sd)
        return m

    monkeypatch.setattr(baseline_trainer, "Baseline", from_jax)
    g = Graph(n=jg.n, src=jg.src, dst=jg.dst, prob=jg.prob, features=jg.features,
              labels=jg.labels)
    got = baseline_trainer.run_baseline_round(g, spec, TrainConfig(lr=0.01, epochs=15), *masks,
                                              3, seed=2, device="cpu")
    assert got.best_val_acc == want.best_val_acc
    assert got.metrics == want.metrics


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_cli_runs_a_short_bf16_baseline_protocol_on_the_host(cornell_root, capsys, model):
    """``--model <m> --dtype bfloat16`` through the CLI: one round of 2
    epochs on the host under the JAX CLI's key with its ``.bfloat16``
    suffix, the model's name in the result line."""
    argv = ["-data", "cornell", "-pr", str(cornell_root), "-e", "2", "-r", "1", "-hid", "8",
            "--model", model, "--dtype", "bfloat16", "--device", "cpu",
            "--results-dir", str(cornell_root / "res"), "--ckpt-dir", str(cornell_root / "ck"),
            "--resume"]
    agg = run.main(argv)
    assert 0.0 <= agg["accuracy"][0] <= 1.0
    assert f"{model} Avg for cornell: acc" in capsys.readouterr().out
    fp = registry.payload_fingerprint(registry.DATASETS["cornell"])
    key = f"cornell.{model}.{fp}.e2.h8.s0.dr0.7.bfloat16"
    assert completed_rounds(str(cornell_root / "ck"), key) == 1
    assert math.isfinite(load_round(str(cornell_root / "ck"), key, 0)["meta"]["best_val_acc"])
