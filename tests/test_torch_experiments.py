"""The port's experiment runners (``pathnet_tpu_torch/experiments``) on the
host at a tiny depth (cornell, one round, two epochs; the path-pattern graph
at n = 200): their artifacts carry the keys of the JAX scripts' artifacts
under ``results/``, a stale artifact (another payload or platform) is
discarded and a matching one resumed, the comparison column is seeded only
from a matching protocol row and exits with code 3 while a column is
missing, the protocol sweep records a failing dataset and goes on, and
nothing is written under ``results/``."""
import json
import os

import numpy as np
import pytest
import torch

from pathnet_tpu_torch import train
from pathnet_tpu_torch.data.registry import DATASETS, payload_fingerprint
from pathnet_tpu_torch.experiments import (ablation_length, ablation_pattern,
                                           comparison_table, protocol_all)
from pathnet_tpu_torch.models.baselines import BASELINES
from pathnet_tpu_torch.train import baseline_trainer
from pathnet_tpu_torch.train.trainer import RoundResult

RESULTS = os.path.join(os.path.dirname(__file__), "..", "results")
CORNELL_FP = payload_fingerprint(DATASETS["cornell"])


def jax_keys(name):
    with open(os.path.join(RESULTS, name)) as f:
        return set(json.load(f))


def results_snapshot():
    return {f: os.stat(os.path.join(RESULTS, f)).st_mtime_ns for f in os.listdir(RESULTS)}


@pytest.fixture(autouse=True)
def one_thread():
    """The runners' tiny rounds: one intra-op thread keeps them from
    contending with the other test workers' threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def common(tmp_path):
    """The flags every runner takes: the host, a fresh data root and results
    directory."""
    return ["--device", "cpu", "--data-root", str(tmp_path / "data"),
            "--results-dir", str(tmp_path / "out")]


def read(tmp_path, name):
    with open(tmp_path / "out" / name) as f:
        return json.load(f)


def fake_protocol(calls, acc=0.5):
    def run_protocol(name, data_root="data", cfg=None, walk_len=4, **kw):
        calls.append(walk_len)
        return {"accuracy": (acc, 0.0)}, []
    return run_protocol


def test_ablation_length_runs_every_length_with_jax_keys(tmp_path, common):
    before = results_snapshot()
    rows = ablation_length.main(["cornell", "1", "2"] + common)
    assert sorted(rows) == [2, 3, 4, 5]
    art = read(tmp_path, "ablation_length_cornell.json")
    assert set(art) == jax_keys("ablation_length_cornell.json")
    assert (art["rounds"], art["epochs"], art["platform"], art["payload"]) == (
        1, 2, "cpu", CORNELL_FP)
    assert sorted(art["accuracy_by_len"]) == ["2", "3", "4", "5"]
    assert all(0.0 <= m <= 1.0 and s == 0.0 for m, s in art["accuracy_by_len"].values())
    assert results_snapshot() == before


@pytest.mark.parametrize("stale, runs", [
    ({}, [5]),                                  # matching: resume, run wl = 5 only
    ({"platform": "cuda"}, [2, 3, 4, 5]),
    ({"payload": "00000000"}, [2, 3, 4, 5]),
    ({"payload": None}, [2, 3, 4, 5]),          # a legacy artifact without the key
    ({"epochs": 3}, [2, 3, 4, 5])])
def test_ablation_length_resumes_only_a_matching_artifact(tmp_path, common, monkeypatch,
                                                           stale, runs):
    art = {"dataset": "cornell", "rounds": 1, "epochs": 2, "platform": "cpu",
           "payload": CORNELL_FP, "ts": 0.0,
           "accuracy_by_len": {"2": [0.1, 0.0], "3": [0.2, 0.0], "4": [0.3, 0.0]}}
    art.update(stale)
    if art["payload"] is None:
        del art["payload"]
    os.makedirs(tmp_path / "out")
    with open(tmp_path / "out" / "ablation_length_cornell.json", "w") as f:
        json.dump(art, f)
    calls = []
    monkeypatch.setattr(train, "run_protocol", fake_protocol(calls))
    ablation_length.main(["cornell", "1", "2"] + common)
    assert calls == runs
    got = read(tmp_path, "ablation_length_cornell.json")["accuracy_by_len"]
    assert got["5"] == [0.5, 0.0]
    assert got["2"] == ([0.1, 0.0] if runs == [5] else [0.5, 0.0])


def test_ablation_pattern_small_with_jax_keys_and_resume(tmp_path, common, monkeypatch):
    small = ["--n", "200", "--rounds", "1", "--epochs", "2", "--num-walks", "8"]
    out = ablation_pattern.main(small + common)
    art = read(tmp_path, "ablation_pattern.json")
    # the JAX artifact has no platform; the port's resume needs one
    assert set(art) == jax_keys("ablation_pattern.json") | {"platform"}
    assert (art["n"], art["num_walks"], art["agg"], art["avg_deg"]) == (200, 8, "sum", 4.0)
    assert art["platform"] == "cpu"
    assert art["num_classes"] == out["num_classes"] <= 5
    assert sorted(art["lengths"]) == ["2", "3", "4", "5"]
    assert all(set(v) == {"mean", "std"} for v in art["lengths"].values())
    g, C = ablation_pattern.pattern_graph(200)
    assert C == art["num_classes"] and g.features.shape == (200, 8)
    assert np.array_equal(g.features[:, 0], np.arange(200) % 2)
    # a matching artifact is resumed length by length; another size is not
    del art["lengths"]["5"]
    with open(tmp_path / "out" / "ablation_pattern.json", "w") as f:
        json.dump(art, f)
    calls = []

    def run_round(X, y, ps, spec, cfg, *masks, num_classes, seed):
        calls.append(spec.walk_len)
        return RoundResult(best_val_acc=0.0, metrics={"accuracy": 0.25})
    monkeypatch.setattr(train, "run_round", run_round)
    ablation_pattern.main(small + common)
    assert calls == [5]
    ablation_pattern.main(["--n", "200", "--rounds", "1", "--epochs", "3",
                           "--num-walks", "8"] + common)
    assert calls == [5, 2, 3, 4, 5]
    # nor is an artifact of another platform
    art["platform"] = "cuda"
    with open(tmp_path / "out" / "ablation_pattern.json", "w") as f:
        json.dump(art, f)
    ablation_pattern.main(small + common)
    assert calls == [5, 2, 3, 4, 5, 2, 3, 4, 5]


@pytest.mark.parametrize("n", [200, 2000])
def test_pattern_graph_equals_the_jax_scripts_construction(n):
    """``pattern_graph`` against ``scripts/ablation_pattern.py``'s inline
    construction, made here with the JAX package's synthetic module."""
    from pathnet_tpu.data import synthetic as jsynthetic

    base = jsynthetic.synthetic_graph(n=n, avg_deg=4.0, num_classes=2, feat_dim=8,
                                      homophily=0.5, seed=7)
    y = jsynthetic.path_pattern_labels(base, walk_len=3)
    uniq, counts = np.unique(y, return_counts=True)
    keep = uniq[np.argsort(counts)[::-1][:4]]
    remap = {int(p): i for i, p in enumerate(keep)}
    y = np.array([remap.get(int(v), len(keep)) for v in y], np.int64)
    rng = np.random.default_rng(0)
    x = np.concatenate([(np.arange(n) % 2)[:, None].astype(np.float32),
                        rng.normal(0, 1, (n, 7)).astype(np.float32)], 1)
    g, C = ablation_pattern.pattern_graph(n)
    assert C == len(keep) + 1
    assert g.labels.dtype == y.dtype and np.array_equal(g.labels, y)
    assert g.features.dtype == x.dtype and np.array_equal(g.features, x)
    assert np.array_equal(g.src, base.src) and np.array_equal(g.dst, base.dst)
    assert np.array_equal(g.prob, base.prob)


def test_comparison_table_runs_every_column_with_jax_keys(tmp_path, common):
    before = results_snapshot()
    col = comparison_table.main(["cornell", "1", "2"] + common)
    art = read(tmp_path, "comparison_cornell.json")
    assert set(art) == jax_keys("comparison_cornell.json")
    want = json.load(open(os.path.join(RESULTS, "comparison_cornell.json")))["accuracy"]
    assert list(art["accuracy"]) == list(want) == ["PathNet", *BASELINES]
    assert col.keys() == want.keys() and art["seeded"] == {}
    assert (art["platform"], art["payload"]) == ("cpu", CORNELL_FP)
    assert results_snapshot() == before


def protocol_line(model, acc, device="cpu", payload=CORNELL_FP, **config):
    c = {"model": model, "payload": payload, "round": 1, "epoch": 2, "hidden_size": 64,
         "num_of_walks": 40, "walk_length": 4, "dropout": 0.7, "dtype": "float32",
         "agg": "attention", "rnn": "lstm", "marker": "merw", "quirk_compat": False}
    c.update(config)
    return json.dumps({"name": "cornell", "config": c, "device": device,
                       "metrics": {"accuracy": {"mean": acc, "std": 0.01}}}) + "\n"


def fake_baselines(calls, fail=()):
    def run_baseline_round(g, spec, cfg, tr, va, te, num_classes, seed=0, device=None):
        calls.append(spec.name)
        if spec.name in fail:
            raise RuntimeError(f"{spec.name} failed")
        return RoundResult(best_val_acc=0.0, metrics={
            k: 0.3 for k in ("accuracy", "macro_precision", "macro_recall", "macro_f1",
                             "micro_f1")})
    return run_baseline_round


def test_comparison_table_seeds_from_matching_rows_and_exits_3_when_incomplete(
        tmp_path, common, monkeypatch):
    os.makedirs(tmp_path / "out")
    with open(tmp_path / "out" / "results.jsonl", "w") as f:
        f.write(protocol_line("pathnet", 0.11))
        f.write(protocol_line("mlp", 0.22))
        # later rows that must not match: another platform, payload, protocol
        f.write(protocol_line("pathnet", 0.91, device="TPU v5 lite0"))
        f.write(protocol_line("pathnet", 0.92, device="NVIDIA H100 80GB HBM3"))
        f.write(protocol_line("mlp", 0.93, payload="00000000"))
        f.write(protocol_line("pathnet", 0.94, marker="uniform"))
        f.write(protocol_line("pathnet", 0.95, walk_length=5))
        f.write(protocol_line("mlp", 0.96, epoch=1))
    calls = []
    monkeypatch.setattr(train, "run_protocol", fake_protocol(calls, 0.99))
    monkeypatch.setattr(baseline_trainer, "run_baseline_round",
                        fake_baselines(calls, fail=("gat",)))
    with pytest.raises(SystemExit) as e:
        comparison_table.main(["cornell", "1", "2"] + common)
    assert e.value.code == 3
    art = read(tmp_path, "comparison_cornell.json")
    assert art["accuracy"]["PathNet"] == [0.11, 0.01]
    assert art["accuracy"]["mlp"] == [0.22, 0.01]
    assert set(art["seeded"]) == {"pathnet", "mlp"}
    assert art["seeded"]["pathnet"]["hidden_size"] == 64
    assert "gat" not in art["accuracy"] and len(art["accuracy"]) == 1 + len(BASELINES) - 1
    assert calls == [m for m in BASELINES if m != "mlp"]
    # the rerun resumes the matching artifact and runs the missing column only
    calls.clear()
    monkeypatch.setattr(baseline_trainer, "run_baseline_round", fake_baselines(calls))
    col = comparison_table.main(["cornell", "1", "2"] + common)
    assert calls == ["gat"] and len(col) == 1 + len(BASELINES)
    art = read(tmp_path, "comparison_cornell.json")
    assert art["accuracy"]["PathNet"] == [0.11, 0.01] and set(art["seeded"]) == {"pathnet", "mlp"}


@pytest.mark.parametrize("stale", [{"platform": "cuda"}, {"payload": "00000000"},
                                   {"rounds": 2}])
def test_comparison_table_discards_a_stale_artifact(tmp_path, common, monkeypatch, stale):
    art = {"dataset": "cornell", "rounds": 1, "epochs": 2, "platform": "cpu",
           "payload": CORNELL_FP, "ts": 0.0, "seeded": {"pathnet": {}},
           "accuracy": {m: [0.9, 0.0] for m in ["PathNet", *BASELINES]}}
    art.update(stale)
    os.makedirs(tmp_path / "out")
    with open(tmp_path / "out" / "comparison_cornell.json", "w") as f:
        json.dump(art, f)
    calls = []
    monkeypatch.setattr(train, "run_protocol", fake_protocol(calls, 0.4))
    monkeypatch.setattr(baseline_trainer, "run_baseline_round", fake_baselines(calls))
    comparison_table.main(["cornell", "1", "2"] + common)
    assert calls == [4] + list(BASELINES)
    got = read(tmp_path, "comparison_cornell.json")
    assert got["accuracy"]["PathNet"] == [0.4, 0.0] and got["seeded"] == {}
    assert (got["platform"], got["payload"], got["rounds"]) == ("cpu", CORNELL_FP, 1)


def test_protocol_all_records_a_failure_and_goes_on(tmp_path, common, monkeypatch):
    monkeypatch.chdir(tmp_path)
    before = results_snapshot()
    summary = protocol_all.main(["nonexistent", "texas", "--rounds", "1", "--epochs", "2",
                                 "--device", "cpu"])
    status = json.load(open(tmp_path / "results_torch" / "protocol_all_status.json"))
    assert status == summary and list(status) == ["nonexistent", "texas"]
    assert status["nonexistent"]["ok"] is False and "nonexistent" in status["nonexistent"]["error"]
    assert status["texas"]["ok"] is True
    with open(os.path.join(RESULTS, "protocol_all_status.json")) as f:
        assert set(status["texas"]) == set(json.load(f)["Electronics"])
    rows = [json.loads(line) for line in open(tmp_path / "results_torch" / "results.jsonl")]
    assert [r["name"] for r in rows] == ["texas"]
    assert rows[0]["config"]["hidden_size"] == protocol_all.HYPERS["texas"]["hid"]
    assert results_snapshot() == before
    assert protocol_all.DEFAULT_ORDER[:3] == ["cornell", "texas", "wisconsin"]


def test_full_protocols_gates_hold_the_jax_artifacts():
    import full_protocols as fp

    length = json.load(open(os.path.join(RESULTS, "ablation_length_cornell.json")))
    assert (fp.JAX_ABLATION["rounds"], fp.JAX_ABLATION["epochs"],
            fp.JAX_ABLATION["payload"]) == (length["rounds"], length["epochs"], length["payload"])
    assert {str(k): list(v) for k, v in fp.JAX_ABLATION["rows"].items()} == \
        length["accuracy_by_len"]
    pattern = json.load(open(os.path.join(RESULTS, "ablation_pattern.json")))
    assert all(fp.JAX_PATTERN[k] == pattern[k]
               for k in ("rounds", "epochs", "n", "num_walks", "num_classes"))
    assert {str(k): {"mean": m, "std": s} for k, (m, s) in fp.JAX_PATTERN["rows"].items()} == \
        pattern["lengths"]
    column = json.load(open(os.path.join(RESULTS, "comparison_cornell.json")))
    assert (fp.JAX_COMPARISON["rounds"], fp.JAX_COMPARISON["epochs"],
            fp.JAX_COMPARISON["payload"]) == (column["rounds"], column["epochs"],
                                              column["payload"])
    assert {k: list(v) for k, v in fp.JAX_COMPARISON["rows"].items()} == column["accuracy"]
    assert fp.JAX_COMPARISON["payload"] == CORNELL_FP
    assert fp.gate("t", {"a": ((0.5, 0.1), (0.6, 0.1))}, 10) == []
    assert fp.gate("t", {"a": ((0.5, 0.1), (0.7, 0.1))}, 10) == ["a"]
