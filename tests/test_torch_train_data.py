"""Port vs JAX on the host side of training: splits, the registry's payload
cache read, config round trips and the result line, all exactly equal."""
import dataclasses
import os

import numpy as np
import pytest

from pathnet_tpu import config as jconfig
from pathnet_tpu.data import registry as jreg
from pathnet_tpu.data import splits as jsplits
from pathnet_tpu.train.results import format_result_line as j_format_result_line

from pathnet_tpu_torch import config
from pathnet_tpu_torch.data import registry, splits
from pathnet_tpu_torch.data.validate import DataValidationError, validate_masks
from pathnet_tpu_torch.train.results import aggregate_rounds, append_results
from pathnet_tpu_torch.train.results import format_result_line
from pathnet_tpu_torch.train.trainer import RoundResult


@pytest.mark.parametrize("seed", [1, 2, 3, 1234567])
def test_whole_mask_and_ratio_masks_equal_jax(seed):
    y = np.random.default_rng(seed).integers(-1, 5, size=301)
    for a, b in zip(splits.get_whole_mask(y, seed=seed), jsplits.get_whole_mask(y, seed=seed)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for val_size in (None, 59):
        for a, b in zip(splits.ratio_masks(183, seed, val_size=val_size),
                        jsplits.ratio_masks(183, seed, val_size=val_size)):
            assert np.array_equal(a, b)


def test_registry_table_and_fingerprints_equal_jax():
    assert set(registry.DATASETS) == set(jreg.DATASETS)
    for name, spec in registry.DATASETS.items():
        assert dataclasses.asdict(spec) == dataclasses.asdict(jreg.DATASETS[name])
        assert registry.payload_fingerprint(spec) == jreg.payload_fingerprint(
            jreg.DATASETS[name])


@pytest.fixture
def cornell_cache(tmp_path):
    """A payload-cache file for cornell under ``tmp_path`` (seeded arrays on
    the real structure, named with the real fingerprint)."""
    from pathnet_tpu_torch.data import Graph
    g = Graph.from_edge_input(os.path.join(os.path.dirname(__file__), "..", "data",
                                           "edge_input", "cornell.in"))
    rng = np.random.default_rng(0)
    spec = registry.DATASETS["cornell"]
    d = tmp_path / "payload_cache"
    d.mkdir()
    np.savez(d / f"cornell.{registry.payload_fingerprint(spec)}.npz", n=g.n, src=g.src,
             dst=g.dst, prob=g.prob,
             x=rng.normal(size=(g.n, spec.feat_dim)).astype(np.float32),
             y=rng.integers(0, spec.num_classes, size=g.n))
    yield str(tmp_path)
    registry.clear_payload_cache()
    jreg.clear_payload_cache()


@pytest.mark.parametrize("round_i", [0, 1, 2])
def test_load_dataset_reads_the_payload_cache_as_jax_does(cornell_cache, round_i):
    got = registry.load_dataset("cornell", cornell_cache, round_i)
    want = jreg.load_dataset("cornell", cornell_cache, round_i)
    for a, b in zip(got[1:4], want[1:4]):
        assert np.array_equal(a, b)
    for field in ("n", "src", "dst", "prob", "features", "labels"):
        assert np.array_equal(getattr(got[0], field), getattr(want[0], field)), field
    assert got[4] == registry.DATASETS["cornell"]


def test_random_split_datasets_use_the_whole_mask_rule(tmp_path):
    spec = registry.DATASETS["Nba"]
    rng = np.random.default_rng(1)
    n = 50
    d = tmp_path / "payload_cache"
    d.mkdir()
    src = np.arange(n, dtype=np.int32)
    np.savez(d / f"Nba.{registry.payload_fingerprint(spec)}.npz", n=n, src=src,
             dst=(src + 1) % n, prob=np.ones(n) * 0.5,
             x=rng.normal(size=(n, 3)).astype(np.float32), y=rng.integers(-1, 2, size=n))
    try:
        g, tr, va, te, _ = registry.load_dataset("Nba", str(tmp_path), 4)
        for a, b in zip((tr, va, te), splits.get_whole_mask(g.labels, seed=5)):
            assert np.array_equal(a, b)
    finally:
        registry.clear_payload_cache()


def test_validate_masks_rejects_overlap():
    a = np.zeros(5, bool)
    a[:3] = True
    with pytest.raises(DataValidationError):
        validate_masks("x", 5, a, a)


def test_config_round_trips_and_reads_jax_json():
    c = config.Config(dataset="Nba", train=config.TrainConfig(microbatch=8192, epochs=3))
    assert config.Config.from_json(c.to_json()) == c
    jc = jconfig.Config(dataset="bgp", model=jconfig.ModelConfig(hidden=32))
    assert config.Config.from_json(jc.to_json()).to_json() == jc.to_json()


def test_result_line_is_byte_equal_to_jax(tmp_path):
    rng = np.random.default_rng(0)
    keys = ("accuracy", "macro_precision", "macro_recall", "macro_f1", "micro_f1")
    rounds = [RoundResult(best_val_acc=0.5, metrics={k: float(rng.random()) for k in keys})
              for _ in range(4)]
    agg = aggregate_rounds(rounds)
    for k in keys:
        vals = [r.metrics[k] for r in rounds]
        assert agg[k] == (float(np.mean(vals)), float(np.std(vals)))
    assert format_result_line("cornell", agg) == j_format_result_line("cornell", agg)
    line = append_results(str(tmp_path), "cornell", agg, {"device": "cpu"})
    assert open(tmp_path / "result_for_cornell.txt").read().endswith(line + "\n")
    assert (tmp_path / "results.jsonl").read_text().count("\n") == 1
