"""Port vs JAX: the LSTM scan, the PAGG logits, parameter conversion, metrics."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathnet_tpu.data import Graph as JGraph
from pathnet_tpu.models import PaggSpec as JPaggSpec
from pathnet_tpu.models import init_pagg_params, pagg_forward
from pathnet_tpu.models.torch_compat import params_from_state_dict
from pathnet_tpu.nn.cells import lstm_scan as j_lstm_scan
from pathnet_tpu.nn.metrics import classification_metrics as j_classification_metrics
from pathnet_tpu.nn.metrics import confusion_matrix as j_confusion_matrix
from pathnet_tpu.sample import PathSampler as JPathSampler

from pathnet_tpu_torch.models import PaggSpec, PathNet, params_from_jax
from pathnet_tpu_torch.nn import classification_metrics, confusion_matrix, lstm_scan

ROOT = os.path.join(os.path.dirname(__file__), "..")
CORNELL = os.path.join(ROOT, "data", "edge_input", "cornell.in")
CKPT = os.path.join(ROOT, "data", "reference_checkpoints", "cornell.pth")
H, NW, F, C = 16, 6, 24, 5


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def cornell():
    return JGraph.from_edge_input(CORNELL)


def jax_walks(g, wl, seed):
    paths, dists = JPathSampler.build(g, NW, wl).sample(jax.random.PRNGKey(seed))
    return np.asarray(paths), np.asarray(dists)


def test_lstm_scan_matches_jax():
    rng = np.random.default_rng(0)
    p = {"w_ih": rng.normal(size=(H, 4 * H)), "w_hh": rng.normal(size=(H, 4 * H)),
         "b_ih": rng.normal(size=4 * H), "b_hh": rng.normal(size=4 * H)}
    p = {k: (0.3 * v).astype(np.float32) for k, v in p.items()}
    xs = rng.normal(size=(4, 9, H)).astype(np.float32)
    jys, jh = j_lstm_scan({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(xs))
    ys, h = lstm_scan({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(xs))
    np.testing.assert_allclose(np.asarray(jys), ys.numpy(), atol=1e-5)
    np.testing.assert_allclose(np.asarray(jh), h.numpy(), atol=1e-5)


@pytest.mark.parametrize("gather_mode", ["x", "h"])
@pytest.mark.parametrize("wl", [2, 3, 4])
def test_logits_match_pagg_forward(cornell, wl, gather_mode):
    X = np.random.default_rng(wl).normal(size=(cornell.n, F)).astype(np.float32)
    jspec = JPaggSpec(feat_dim=F, hidden=H, out_dim=C, walk_len=wl,
                      gather_mode=gather_mode)
    params = init_pagg_params(jax.random.PRNGKey(wl), jspec)
    paths, dists = jax_walks(cornell, wl, seed=wl)
    idx = np.arange(cornell.n, dtype=np.int32)
    want = np.asarray(pagg_forward(params, jnp.asarray(X), jnp.asarray(paths),
                                   jnp.asarray(dists), jnp.asarray(idx), jspec,
                                   train=False))
    spec = PaggSpec(feat_dim=F, hidden=H, out_dim=C, walk_len=wl,
                    gather_mode=gather_mode)
    model = PathNet(spec, device="cpu")
    model.load_state_dict(params_from_jax(to_numpy(params), spec), strict=True)
    got = model(torch.from_numpy(X), torch.from_numpy(paths), torch.from_numpy(dists),
                torch.from_numpy(idx))
    np.testing.assert_allclose(want, got.numpy(), atol=1e-5, rtol=0)


def test_reference_checkpoint_loads_strict_and_matches_jax(cornell):
    sd = torch.load(CKPT, map_location="cpu")
    spec = PaggSpec(feat_dim=1703, hidden=128, out_dim=5, walk_len=4)
    model = PathNet(spec, device="cpu")
    model.load_state_dict(sd, strict=True)
    jspec = JPaggSpec(feat_dim=1703, hidden=128, out_dim=5, walk_len=4)
    params = params_from_state_dict(sd, jspec)
    X = np.random.default_rng(0).normal(size=(cornell.n, 1703)).astype(np.float32)
    paths, dists = jax_walks(cornell, 4, seed=0)
    idx = np.arange(cornell.n, dtype=np.int32)
    want = np.asarray(pagg_forward(params, jnp.asarray(X), jnp.asarray(paths),
                                   jnp.asarray(dists), jnp.asarray(idx), jspec,
                                   train=False))
    got = model(torch.from_numpy(X), torch.from_numpy(paths), torch.from_numpy(dists),
                torch.from_numpy(idx))
    assert np.isfinite(got.numpy()).all()
    # trained weights over 1703 features give logits of order 10: f32
    # rounding of the two summation orders is then a few 1e-6 relative
    np.testing.assert_allclose(want, got.numpy(), atol=1e-5, rtol=1e-6)


def test_params_from_jax_uses_the_reference_names():
    spec = PaggSpec(feat_dim=1703, hidden=8, out_dim=5, walk_len=4)
    jspec = JPaggSpec(feat_dim=1703, hidden=8, out_dim=5, walk_len=4)
    sd = params_from_jax(to_numpy(init_pagg_params(jax.random.PRNGKey(0), jspec)), spec)
    assert set(sd) == set(torch.load(CKPT, map_location="cpu"))
    assert set(sd) == set(PathNet(spec, device="cpu").state_dict())


def test_weights_are_seeded_torch_default_draws():
    spec = PaggSpec(feat_dim=F, hidden=H, out_dim=C, walk_len=4)
    a = PathNet(spec, device="cpu", generator=torch.Generator().manual_seed(3))
    b = PathNet(spec, device="cpu", generator=torch.Generator().manual_seed(3))
    c = PathNet(spec, device="cpu", generator=torch.Generator().manual_seed(4))
    for (name, x), y, z in zip(a.state_dict().items(), b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(x, y) and not torch.equal(x, z), name
    fan_in = {"fc0": F, "nets": H, "LSTM": H, "attw": 2 * H, "fc2": 2 * H}
    for name, x in a.state_dict().items():
        bound = 1.0 / np.sqrt(fan_in[name.split(".")[0]])
        assert float(x.abs().max()) <= bound, name


@pytest.mark.parametrize("kw", [{"rnn": "rnn"}, {"agg": "max"}, {"variant": "both"}])
def test_unported_model_choices_raise(kw):
    # every choice of the JAX package's PathNet runs (the MLP, the quirk and
    # bf16 x GRU since PR 19); one it does not know raises ValueError
    with pytest.raises(ValueError, match=next(iter(kw))):
        PathNet(PaggSpec(feat_dim=F, hidden=H, out_dim=C, walk_len=4, **kw), device="cpu")


@pytest.mark.parametrize("variant", ["hetero", "homo"])
def test_spec_accepts_bf16_compute_and_refuses_other_dtypes(variant):
    spec = PaggSpec(feat_dim=F, hidden=H, out_dim=C, walk_len=4, variant=variant,
                    compute_dtype="bfloat16")
    model = PathNet(spec, device="cpu")
    assert model.bf16 and all(p.dtype == torch.float32 for p in model.parameters())
    with pytest.raises(ValueError, match="compute_dtype"):
        PaggSpec(feat_dim=F, hidden=H, out_dim=C, walk_len=4,
                 compute_dtype="float16").check_ported()
    assert PaggSpec(feat_dim=128, hidden=H, out_dim=C, walk_len=4).resolved_gather_mode() == "x"
    assert PaggSpec(feat_dim=129, hidden=H, out_dim=C, walk_len=4).resolved_gather_mode() == "h"


def test_confusion_matrix_and_metrics_match_jax():
    rng = np.random.default_rng(0)
    y = rng.integers(-1, C, size=200)          # -1: unlabeled, must be dropped
    pred = rng.integers(0, C - 1, size=200)    # one class never predicted
    w = rng.random(200).astype(np.float32)
    for weights in (None, w):
        jcm = j_confusion_matrix(jnp.asarray(y), jnp.asarray(pred), C,
                                 None if weights is None else jnp.asarray(weights))
        cm = confusion_matrix(torch.from_numpy(y), torch.from_numpy(pred), C,
                              None if weights is None else torch.from_numpy(weights))
        np.testing.assert_allclose(np.asarray(jcm), cm.numpy(), rtol=1e-6)
        jm = j_classification_metrics(jcm)
        m = classification_metrics(cm)
        assert set(jm) == set(m)
        for k in m:
            np.testing.assert_allclose(float(jm[k]), float(m[k]), rtol=1e-6, err_msg=k)
