"""The multi-device layer in training and on the CLI, against the port's own
one-process round (this file imports no JAX): a 2-rank ``run_round`` whose
walks and dropout masks are the one-process round's bit for bit and whose
numbers equal it, the CLI's ``--mesh`` on gloo ranks, what ``--mesh``
refuses, and the dry run on 4 CPU ranks.

Tests marked ``gpu`` need a CUDA card; the ``cuda`` fixture skips them where
there is none:
``python -m pytest tests/test_torch_parallel_train.py -m gpu --noconftest``.
"""
import os

import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from pathnet_tpu_torch import run
from pathnet_tpu_torch.config import TrainConfig
from pathnet_tpu_torch.data.splits import ratio_masks
from pathnet_tpu_torch.models import PaggSpec
from pathnet_tpu_torch.parallel.dryrun import RING_TOL, dryrun
from pathnet_tpu_torch.train import run_round
from pathnet_tpu_torch.train.checkpoint import completed_rounds
from pathnet_tpu_torch.utils import force_cpu_devices

CORNELL = os.path.join(os.path.dirname(__file__), "..", "data", "edge_input", "cornell.in")
D = 2
EPOCHS, MICROBATCH = 4, 31        # 31: each chunk pads to 32 for the two ranks
RUNS = ((0.7, False, "gspmd"), (0.0, False, "gspmd"), (0.0, True, "gspmd"),
        (0.0, True, "ring"), (0.0, True, "sparse"))
# the model's other choices through each exchange (dropout 0.7, the masks given)
CHOICES = (dict(variant="homo"), dict(rnn="gru"), dict(rnn="mlp"), dict(agg="mean"),
           dict(quirk_compat=True), dict(compute_dtype="bfloat16"),
           dict(compute_dtype="bfloat16", gather_mode="h"),
           dict(variant="homo", compute_dtype="bfloat16"))
BF16_GRAD_TOL = 2.0 ** -5     # of each gradient's largest entry (tests/test_torch_bf16.py)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def prob():
    rng = np.random.default_rng(0)
    n = 183
    return dict(edge=CORNELL, nw=5, classes=5,
                spec=dict(feat_dim=12, hidden=8, out_dim=5, walk_len=4, dropout=0.7),
                X=rng.normal(size=(n, 12)).astype(np.float32),
                y=rng.integers(0, 5, size=n).astype(np.int64),
                masks=ratio_masks(n, 1), runs=RUNS,
                cfg=dict(epochs=EPOCHS, microbatch=MICROBATCH))


@pytest.fixture(scope="module")
def suite(prob):
    """The port's side on 2 gloo ranks: one spawn for this file's rounds and
    model choices."""
    return force_cpu_devices(ranks.train_suite, D, args=(prob, CHOICES), timeout_s=300,
                             threads=1)


@pytest.fixture(scope="module")
def sharded(suite):
    return [r["rounds"] for r in suite]


@pytest.fixture(scope="module")
def single(prob):
    """The one-process rounds of the same runs (the first with its
    training forwards' inputs)."""
    ps, X, y = ranks.round_setup(prob)
    out = {}
    for i, (dropout, _, _) in enumerate(RUNS[:2]):
        log = []
        undo = ranks.record_forwards(log) if i == 0 else (lambda: None)
        try:
            res = run_round(X, y, ps, PaggSpec(**{**prob["spec"], "dropout": dropout}),
                            TrainConfig(**prob["cfg"]), *prob["masks"], prob["classes"],
                            seed=3, track_history=True)
        finally:
            undo()
        out[dropout] = dict(history=res.history, losses=res.losses, metrics=res.metrics,
                            forwards=log)
    return out


def test_rank_walks_and_masks_are_the_one_process_rounds(sharded, single):
    """Every training forward of the 2-rank round (dropout 0.7, microbatches
    of 31 padded to 32): the ranks' targets, walks and both dropout masks,
    put back together, equal the one-process round's forward bit for bit;
    the padding target is node 0 with all-zero masks."""
    one = single[0.7]["forwards"]
    per_rank = [r[RUNS[0]]["forwards"] for r in sharded]
    assert len(one) % EPOCHS == 0 and all(len(f) == len(one) for f in per_rank)
    for i, (targets, paths, (m1, m2)) in enumerate(one):
        C = targets.shape[0]
        got_t = np.concatenate([f[i][0] for f in per_rank])
        got_p = np.concatenate([f[i][1] for f in per_rank])
        got_m1 = np.concatenate([f[i][2][0] for f in per_rank], axis=1)
        got_m2 = np.concatenate([f[i][2][1] for f in per_rank])
        nw = paths.shape[1]
        np.testing.assert_array_equal(got_t[:C], targets)
        np.testing.assert_array_equal(got_p[:C], paths)
        np.testing.assert_array_equal(got_m1[:, :C * nw], m1)
        np.testing.assert_array_equal(got_m2[:C], m2)
        assert (got_t[C:] == 0).all() and not got_m1[:, C * nw:].any()
        assert not got_m2[C:].any()


@pytest.mark.parametrize("run_", RUNS, ids=lambda r: f"dr{r[0]}-{'X-' if r[1] else ''}{r[2]}")
def test_sharded_round_equals_the_one_process_round(sharded, single, run_):
    """The 2-rank round's losses within 1e-5 (relative) of the one-process
    round's, and (dropout off) the same validation accuracies and test
    metrics, with X replicated and row-sharded through each exchange (the
    round's own ``gspmd``; ``ring`` and ``sparse`` through its epochs written
    out, ``torch_parallel_ranks.exchange_round``). Both ranks end with the
    same numbers."""
    dropout = run_[0]
    want = single[dropout]
    for r in sharded:
        got = r[run_]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5, atol=0)
        if dropout == 0.0:
            np.testing.assert_array_equal(got["history"], want["history"])
            assert got["metrics"] == pytest.approx(want["metrics"], abs=1e-6)
    assert sharded[0][run_]["metrics"] == sharded[1][run_]["metrics"]


@pytest.mark.parametrize("choice", CHOICES, ids=lambda c: "-".join(f"{v}" for v in c.values()))
def test_every_model_choice_through_each_exchange(suite, choice):
    """Each model choice (homo, GRU, MLP, mean, the quirk, bf16 in both
    gather modes) on 2 ranks with dropout: the step with X row-sharded
    through each exchange equals the step with X replicated; the loss
    within 1e-6, the gradients within atol 1e-6 + rtol 1e-5 in f32 and
    within 2^-5 of each gradient's largest entry in bf16 (the exchanges
    round the table's gradient at other points)."""
    got = suite[0]["variants"]
    key = tuple(sorted(choice.items()))
    loss0, grads0 = got[key, None]
    bf16 = choice.get("compute_dtype") == "bfloat16"
    for ex in ("gspmd", "ring", "sparse"):
        loss, grads = got[key, ex]
        assert abs(loss - loss0) <= 1e-6, ex
        assert suite[1]["variants"][key, ex][0] == loss
        for k, g0 in grads0.items():
            if bf16:
                assert np.abs(grads[k] - g0).max() <= BF16_GRAD_TOL * np.abs(g0).max(), (ex, k)
            else:
                np.testing.assert_allclose(grads[k], g0, atol=1e-6, rtol=1e-5,
                                           err_msg=f"{ex} {k}")


def test_cli_trains_with_mesh_and_sharded_features_on_cpu_ranks(tmp_path, capsys):
    """``--mesh 2 --shard-features --device cpu`` spawns two gloo ranks that
    make cornell's payload in an empty data root and train; the command
    writes one result line and saves the round once, under JAX's key."""
    res, ck = tmp_path / "res", tmp_path / "ck"
    agg = run.main(["-data", "cornell", "--mesh", "2", "--shard-features", "--device", "cpu",
                    "-e", "3", "-r", "1", "-hid", "8", "-nw", "4", "-pr", str(tmp_path),
                    "--results-dir", str(res), "--ckpt-dir", str(ck), "--resume"])
    assert 0.0 <= agg["accuracy"][0] <= 1.0
    assert "pathnet Avg for cornell: acc" in capsys.readouterr().out
    lines = (res / "result_for_cornell.txt").read_text().count("pathnet Avg for cornell")
    assert lines == 1
    key = "cornell.89c32d97.e3.h8.s0.nw4.wl4.dr0.7.merw.lstm.attention"
    assert completed_rounds(str(ck), key) == 1
    assert [p.name for p in ck.iterdir()] == [key]


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_cli_mesh_with_a_baseline_is_not_ported(model):
    with pytest.raises(NotImplementedError, match="ROADMAP §1 item 11"):
        run.main(["-data", "cornell", "--model", model, "--mesh", "2", "--device", "cpu"])


def test_cli_mesh_without_a_card_raises_and_never_falls_back():
    """``--mesh 2`` with the default device (the card) raises where there is
    no card; it never runs on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main(["-data", "cornell", "--mesh", "2", "-e", "1", "-r", "1"])


@pytest.mark.gpu
def test_mesh_past_the_card_count_raises(cuda):
    """NCCL takes one card a rank: a mesh of one rank more than the cards
    raises before any rank starts, naming the count."""
    from pathnet_tpu_torch.parallel import spawn

    count = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match=f"{count} (is|are) visible"):
        spawn(ranks.gathers, count + 1, device="cuda", args=((), None, None, None))
    with pytest.raises(RuntimeError, match=f"{count} (is|are) visible"):
        run.main(["-data", "cornell", "--mesh", str(count + 1), "-e", "1", "-r", "1"])


def test_dryrun_on_four_cpu_ranks(capsys):
    """The dry run's three lines on 4 gloo ranks: a finite loss, a finite
    round, and the ring's loss within 1e-4 of the gspmd exchange's."""
    lines = dryrun(4, n_nodes=1024, timeout_s=240, threads=1)
    out = capsys.readouterr().out
    assert [line.split(":")[0] for line in lines] == [
        "dryrun(4) step", "dryrun(4) round", "dryrun(4) ring+tp"]
    assert all(line in out for line in lines)
    vals = {k: float(v) for line in lines for k, v in
            (w.split("=") for w in line.split()[2:] if "=" in w)
            if k in ("loss", "best_val", "test_acc", "ring_loss", "tp_loss")}
    assert all(np.isfinite(v) for v in vals.values())
    assert abs(vals["ring_loss"] - vals["loss"]) < RING_TOL


def test_spawned_ranks_import_a_main_module_by_its_run_name(monkeypatch):
    """A rank imports its function by module name: a ``__main__`` run with
    ``-m`` (the CLI) by the dotted name ``-m`` ran, a script by its file
    name from its directory."""
    import importlib.machinery
    import types

    from pathnet_tpu_torch.parallel import comm

    def fn(grid):
        return grid
    fn.__module__, fn.__qualname__ = "__main__", "fn"
    main = types.ModuleType("__main__")
    main.__file__ = comm.PACKAGE_ROOT / "pathnet_tpu_torch" / "run.py"
    main.__spec__ = importlib.machinery.ModuleSpec("pathnet_tpu_torch.run", None)
    monkeypatch.setitem(__import__("sys").modules, "__main__", main)
    assert comm._module_of(fn) == (str(comm.PACKAGE_ROOT), "pathnet_tpu_torch.run", "fn")
    main.__spec__ = None
    main.__file__ = comm.PACKAGE_ROOT / "chip_smoke.py"
    assert comm._module_of(fn) == (str(comm.PACKAGE_ROOT), "chip_smoke", "fn")
