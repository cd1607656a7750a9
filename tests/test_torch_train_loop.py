"""The port's training loop on the host: ``run_round`` (determinism,
best-on-validation selection, learning), checkpoints and resume, and the
``run.py`` CLI against the JAX CLI's flags."""
import os

import numpy as np
import pytest
import torch

from pathnet_tpu.run import build_parser as j_build_parser

from pathnet_tpu_torch import run
from pathnet_tpu_torch.config import TrainConfig
from pathnet_tpu_torch.data import Graph
from pathnet_tpu_torch.data import registry
from pathnet_tpu_torch.models import PaggSpec
from pathnet_tpu_torch.sample import PathSampler
from pathnet_tpu_torch.train import trainer
from pathnet_tpu_torch.train.checkpoint import completed_rounds, load_round, save_round
from pathnet_tpu_torch.train.trainer import RoundResult, run_protocol, run_round

CORNELL = os.path.join(os.path.dirname(__file__), "..", "data", "edge_input", "cornell.in")


@pytest.fixture(scope="module")
def planted(small_graph):
    """The suite's 60-node, 3-class graph with MERW probabilities; features
    carry the label."""
    g = Graph(n=small_graph.n, src=small_graph.src, dst=small_graph.dst,
              prob=small_graph.prob)
    X = torch.from_numpy(np.asarray(small_graph.features, np.float32))
    y = torch.from_numpy(np.asarray(small_graph.labels, np.int64))
    rng = np.random.default_rng(0)
    perm = rng.permutation(g.n)
    masks = [np.zeros(g.n, bool) for _ in range(3)]
    for m, part in zip(masks, np.split(perm, [30, 45])):
        m[part] = True
    return PathSampler.build(g, 6, 4, device="cpu"), X, y, masks


def round_of(planted, epochs, **kw):
    ps, X, y, (tr, va, te) = planted
    spec = PaggSpec(feat_dim=X.shape[1], hidden=16, out_dim=3, walk_len=4)
    cfg = TrainConfig(epochs=epochs, lr=0.01, microbatch=kw.pop("microbatch", None))
    return run_round(X, y, ps, spec, cfg, tr, va, te, 3, seed=kw.pop("seed", 0),
                     track_history=True, **kw)


def test_a_round_is_reproducible_and_keeps_the_first_best_epoch(planted):
    a = round_of(planted, 12, keep_params=True)
    b = round_of(planted, 12)
    assert np.array_equal(a.history, b.history) and a.metrics == b.metrics
    assert np.array_equal(a.losses, b.losses) and np.isfinite(a.losses).all()
    assert a.best_val_acc == float(a.history.max())
    first = int(np.argmax(a.history))
    # the result is the test matrix of the first epoch that reached the
    # best: a round cut right after it gives the same metrics and params
    cut = round_of(planted, first + 1, keep_params=True)
    assert cut.metrics == a.metrics
    for k, v in a.best_params.items():
        assert torch.equal(v, cut.best_params[k]), k
    assert round_of(planted, 3, seed=1).history.tolist() != a.history[:3].tolist()


def test_a_round_whose_validation_never_rises_keeps_its_init_params(planted, small_graph,
                                                                  tmp_path):
    """With an empty validation set the accuracy stays 0, so no epoch is
    ever best: both packages keep the init params (JAX through its scan's
    carry, pathnet_tpu/train/trainer.py:216-217), and the port saves them."""
    import jax
    from pathnet_tpu.config import TrainConfig as JTrainConfig
    from pathnet_tpu.models.pagg import PaggSpec as JPaggSpec, init_pagg_params
    from pathnet_tpu.sample import PathSampler as JPathSampler
    from pathnet_tpu.train.trainer import run_round as j_run_round
    from pathnet_tpu_torch.models import PathNet, params_from_jax

    ps, X, y, (tr, va, te) = planted
    va = np.zeros_like(va)
    spec = PaggSpec(feat_dim=X.shape[1], hidden=16, out_dim=3, walk_len=4)
    j_spec = JPaggSpec(feat_dim=X.shape[1], hidden=16, out_dim=3, walk_len=4)
    j_res = j_run_round(jax.numpy.asarray(X.numpy()), jax.numpy.asarray(y.numpy()),
                        JPathSampler.build(small_graph, 6, 4), j_spec,
                        JTrainConfig(epochs=3, lr=0.01), tr, va, te, 3, seed=5,
                        keep_params=True)
    res = run_round(X, y, ps, spec, TrainConfig(epochs=3, lr=0.01), tr, va, te, 3,
                    seed=5, keep_params=True)
    assert j_res.best_val_acc == res.best_val_acc == 0.0
    assert j_res.metrics == pytest.approx(res.metrics)
    to_np = lambda p: jax.tree_util.tree_map(np.asarray, p)
    j_kept = params_from_jax(to_np(j_res.best_params), spec)
    j_init = params_from_jax(to_np(init_pagg_params(
        jax.random.split(jax.random.PRNGKey(5))[0], j_spec)), spec)
    init = PathNet(spec, device="cpu",
                   generator=trainer.make_generator(5, 0, trainer.STREAM_INIT)).state_dict()
    assert j_kept.keys() == res.best_params.keys() == init.keys()
    for k, v in res.best_params.items():
        assert v.shape == j_kept[k].shape, k
        torch.testing.assert_close(j_kept[k], j_init[k], atol=1e-6, rtol=0)
        torch.testing.assert_close(v, init[k], atol=1e-6, rtol=0)
    save_round(str(tmp_path), "ck", 0, res)
    saved = load_round(str(tmp_path), "ck", 0)
    for k, v in init.items():
        torch.testing.assert_close(saved["params"][k], v, atol=1e-6, rtol=0)


def test_microbatched_round_equals_the_full_batch_round_without_dropout(planted):
    ps, X, y, (tr, va, te) = planted
    spec = PaggSpec(feat_dim=X.shape[1], hidden=16, out_dim=3, walk_len=4, dropout=0.0)
    res = [run_round(X, y, ps, spec, TrainConfig(epochs=4, microbatch=mb), tr, va, te, 3,
                     track_history=True) for mb in (None, 8)]
    np.testing.assert_allclose(res[0].losses, res[1].losses, rtol=1e-5)
    assert res[0].history.tolist() == res[1].history.tolist()


def test_training_beats_chance_on_a_planted_graph(planted):
    r = round_of(planted, 40)
    assert r.best_val_acc > 0.6 and r.metrics["accuracy"] > 0.6   # chance is 1/3


def test_stream_seeds_are_distinct_and_stable():
    seeds = {trainer.stream_seed(s, e, k, c) for s in range(3) for e in range(50)
             for k in range(3) for c in range(4)}
    assert len(seeds) == 3 * 50 * 3 * 4
    assert trainer.stream_seed(0, 1, 2, 3) == trainer.stream_seed(0, 1, 2, 3) < 2 ** 63


def test_checkpoint_round_trip(tmp_path):
    res = RoundResult(best_val_acc=0.75, metrics={"accuracy": 0.5},
                      best_params={"w": torch.arange(6.0).reshape(2, 3)})
    save_round(str(tmp_path), "key", 0, res, config={"e": 3})
    save_round(str(tmp_path), "key", 1, RoundResult(0.5, {"accuracy": 0.25}))
    got = load_round(str(tmp_path), "key", 0)
    assert got["meta"] == {"round": 0, "best_val_acc": 0.75,
                           "metrics": {"accuracy": 0.5}, "config": {"e": 3}}
    assert torch.equal(got["params"]["w"], res.best_params["w"])
    assert load_round(str(tmp_path), "key", 1)["params"] is None
    assert load_round(str(tmp_path), "key", 2) is None
    assert completed_rounds(str(tmp_path), "key") == 2
    os.makedirs(tmp_path / "key" / "round_005")
    assert load_round(str(tmp_path), "key", 5) is None


@pytest.fixture
def cornell_root(tmp_path):
    g = Graph.from_edge_input(CORNELL)
    spec = registry.DATASETS["cornell"]
    rng = np.random.default_rng(0)
    (tmp_path / "payload_cache").mkdir()
    np.savez(tmp_path / "payload_cache" / f"cornell.{registry.payload_fingerprint(spec)}.npz",
             n=g.n, src=g.src, dst=g.dst, prob=g.prob,
             x=rng.normal(size=(g.n, spec.feat_dim)).astype(np.float32),
             y=rng.integers(0, 5, size=g.n))
    yield tmp_path
    registry.clear_payload_cache()


def test_protocol_checkpoints_and_resumes_completed_rounds(cornell_root, monkeypatch):
    kw = dict(data_root=str(cornell_root), cfg=TrainConfig(epochs=2), rounds=2,
              num_walks=4, hidden=8, ckpt_dir=str(cornell_root / "ck"), verbose=False,
              device="cpu")
    agg, results = run_protocol("cornell", **kw)
    key = trainer.checkpoint_name("cornell", registry.payload_fingerprint(
        registry.DATASETS["cornell"]), kw["cfg"], 8, 4, 4, 0.7, "merw", "lstm",
        "attention")
    assert key == "cornell.89c32d97.e2.h8.s0.nw4.wl4.dr0.7.merw.lstm.attention"
    assert completed_rounds(kw["ckpt_dir"], key) == 2
    assert set(load_round(kw["ckpt_dir"], key, 1)["params"]) >= {"fc0.weight", "fc2.bias"}

    def no_training(*a, **k):
        raise AssertionError("a completed round was run again")
    monkeypatch.setattr(trainer, "run_round", no_training)
    agg2, results2 = run_protocol("cornell", **kw)
    assert agg2 == agg and [r.metrics for r in results2] == [r.metrics for r in results]


def jax_style_round(root, key, round_i):
    """A round directory in the JAX package's orbax layout: no meta.json."""
    d = root / key / f"round_{round_i:03d}"
    (d / "default").mkdir(parents=True)
    (d / "_CHECKPOINT_METADATA").write_text("{}")
    (d / "default" / "d").write_bytes(b"orbax")
    return d


def test_protocol_runs_rounds_over_another_packages_checkpoints(cornell_root, monkeypatch):
    kw = dict(data_root=str(cornell_root), cfg=TrainConfig(epochs=2), rounds=1,
              num_walks=4, hidden=8, ckpt_dir=str(cornell_root / "ck"), verbose=False,
              device="cpu")
    key = "cornell.89c32d97.e2.h8.s0.nw4.wl4.dr0.7.merw.lstm.attention"
    d = jax_style_round(cornell_root / "ck", key, 0)
    before = {p: p.read_bytes() for p in d.rglob("*") if p.is_file()}
    assert load_round(kw["ckpt_dir"], key, 0) is None
    assert completed_rounds(kw["ckpt_dir"], key) == 0
    ran = []
    real = trainer.run_round
    monkeypatch.setattr(trainer, "run_round", lambda *a, **k: ran.append(1) or real(*a, **k))
    with pytest.warns(UserWarning, match="another package"):
        agg, results = run_protocol("cornell", **kw)
    assert ran == [1] and len(results) == 1 and 0.0 <= agg["accuracy"][0] <= 1.0
    assert completed_rounds(kw["ckpt_dir"], key) == 0
    assert {p: p.read_bytes() for p in d.rglob("*") if p.is_file()} == before


def test_cli_writes_outside_the_jax_packages_records():
    args = run.build_parser().parse_args(["-data", "cornell"])
    assert (args.results_dir, args.ckpt_dir) == ("results_torch", "saved_models_torch")
    for d in (args.results_dir, args.ckpt_dir):
        assert d not in ("results", "saved_models")


def test_cli_takes_the_jax_flags():
    def options(parser):
        return {s for a in parser._actions for s in a.option_strings}
    mine, theirs = options(run.build_parser()), options(j_build_parser())
    assert mine - theirs == {"--device"} and theirs - mine == {"--platform"}


@pytest.mark.parametrize("argv", [["--model", "gcn"], ["--mesh", "4"], ["--shard-features"],
                                  ["--dtype", "bfloat16"], ["--rnn", "gru"],
                                  ["--agg", "mean"], ["--quirk-compat"], ["-mk", "uniform"]])
def test_cli_refuses_unported_choices(argv):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run.main(["-data", "cornell", *argv])


def test_cli_refuses_homo_datasets():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run.main(["-data", "cora"])


def test_cli_runs_a_short_protocol_on_the_host(cornell_root, capsys):
    run.main(["-data", "cornell", "-pr", str(cornell_root), "-e", "2", "-r", "1",
              "-hid", "8", "-nw", "4", "--device", "cpu",
              "--results-dir", str(cornell_root / "res")])
    out = capsys.readouterr().out
    assert "pathnet Avg for cornell: acc" in out
    assert (cornell_root / "res" / "result_for_cornell.txt").exists()
