"""The gather probe's port: K5 and K6's plain versions against the probe's own
Pallas bodies (``scripts/pallas_gather_probe.py``, run in interpret mode on
the CPU), K6's floor mod, the probe entry point, and (on a card) K6 against
its plain version. All comparisons are exact: a gather moves values and
computes none.

JAX is imported inside the ``jx`` fixture, so the card-only test at the end
also runs where JAX is absent:
``python -m pytest tests/test_torch_gather_probe.py -m gpu --noconftest``.
"""
import importlib.util
import os
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pathnet_tpu_torch import gather_probe
from pathnet_tpu_torch import kernels as K

PROBE = os.path.join(os.path.dirname(__file__), "..", "scripts", "pallas_gather_probe.py")


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    return SimpleNamespace(jax=jax, jnp=jax.numpy, pl=pl, pltpu=pltpu)


@pytest.fixture(scope="module")
def probe_module():
    spec = importlib.util.spec_from_file_location("pallas_gather_probe", PROBE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def pallas_body(jx, probe_module, name, n, D):
    """The probe's body ``name`` under ``pallas_call`` with the probe's VMEM
    specs, in interpret mode."""
    ns = {"jnp": jx.jnp}
    exec(textwrap.dedent(probe_module.CASES[name]), ns)
    vmem = jx.pl.BlockSpec(memory_space=jx.pltpu.VMEM)
    return jx.pl.pallas_call(
        ns["kernel"], out_shape=jx.jax.ShapeDtypeStruct((n, D), jx.jnp.float32),
        in_specs=[vmem, vmem], out_specs=vmem, interpret=True)


def test_the_port_has_every_case_of_the_probe(probe_module):
    assert set(gather_probe.case_functions()) == set(probe_module.CASES)


@pytest.mark.parametrize("name", ["int_indexing", "take", "row_shuffle_axis0",
                                  "lane_gather_axis1"])
def test_each_case_equals_the_probe_body_in_interpret_mode(jx, probe_module, name):
    jnp = jx.jnp
    tbl, idx = gather_probe.probe_inputs("cpu")
    rng = np.random.default_rng(0)   # the probe's own draw
    j_tbl = jnp.asarray(rng.random((512, 128)), jnp.float32)
    j_idx = jnp.asarray(rng.integers(0, 512, size=512), jnp.int32)
    assert np.array_equal(np.asarray(j_tbl), tbl.numpy())
    assert np.array_equal(np.asarray(j_idx), idx.numpy())
    want = np.asarray(pallas_body(jx, probe_module, name, 512, 128)(j_idx, j_tbl))
    wrapper, plain = gather_probe.case_functions()[name]
    assert np.array_equal(plain(tbl, idx).numpy(), want)
    assert np.array_equal(wrapper(tbl, idx).numpy(), want)


@pytest.mark.parametrize("D", [128, 37, 1])
def test_lane_gather_takes_a_floor_mod_as_jax_does(jx, D):
    jnp = jx.jnp
    rng = np.random.default_rng(D)
    n = 64
    tbl = rng.normal(size=(n, D)).astype(np.float32)
    idx = rng.integers(-5 * D - 3, 5 * D + 3, size=n).astype(np.int32)
    idx[:3] = (-1, np.iinfo(np.int32).min, np.iinfo(np.int32).max)
    want = np.asarray(jnp.take_along_axis(
        jnp.asarray(tbl), jnp.broadcast_to(jnp.asarray(idx)[:, None] % D, (n, D)), axis=1))
    got = K.lane_gather(torch.from_numpy(tbl), torch.from_numpy(idx))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(K.lane_gather_plain(torch.from_numpy(tbl),
                                              torch.from_numpy(idx)).numpy(), want)


def test_lane_gather_rejects_bad_inputs():
    tbl = torch.zeros((4, 8))
    idx = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        K.lane_gather(tbl, idx.long())
    with pytest.raises(ValueError):
        K.lane_gather(tbl, idx[:3])
    with pytest.raises(ValueError, match="D = 0"):
        K.lane_gather(torch.zeros((4, 0)), idx)
    with pytest.raises(ValueError, match="contiguous"):
        K.lane_gather(torch.zeros((8, 4)).t(), idx)
    with pytest.raises(ValueError, match="unsupported device"):
        K.lane_gather(tbl.to("meta"), idx.to("meta"))


def test_probe_main_reports_every_case_on_the_host(tmp_path, capsys):
    out = tmp_path / "probe.json"
    report = gather_probe.main(["--device", "cpu", "--out", str(out)])
    cases = ("int_indexing", "take", "row_shuffle_axis0", "lane_gather_axis1")
    for name in cases:
        assert set(report[name]) == {"ok", "compile_s", "steady_us", "max_abs_err"}
        assert report[name]["ok"] and report[name]["max_abs_err"] == 0.0
        assert report[name]["steady_us"] > 0
    for name in ("torch_row_gather", "torch_lane_gather"):
        assert set(report[name]) == {"ok", "steady_us"}
    assert report["device"] == "cpu" and "decision" not in report
    assert out.exists() and '"lane_gather_axis1"' in capsys.readouterr().out
    assert K.lane_gather.launches == 0


def test_probe_without_a_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gather_probe.main([])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n,D", [(512, 128), (63977, 64), (1000, 37), (7, 1)])
def test_lane_gather_matches_plain_on_the_card(cuda, n, D):
    gen = torch.Generator().manual_seed(n + D)
    tbl = torch.randn((n, D), generator=gen).to(cuda)
    idx = torch.randint(-4 * D, 4 * D, (n,), generator=gen, dtype=torch.int32).to(cuda)
    before = K.lane_gather.launches
    out = K.lane_gather(tbl, idx)
    torch.cuda.synchronize()
    assert K.lane_gather.launches == before + 1
    assert torch.equal(out, K.lane_gather_plain(tbl, idx))
