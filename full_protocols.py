#!/usr/bin/env python3
"""The 10 x 1000 protocols that ``chip_smoke.py`` cuts to one round, and the
experiment runners at full depth.

Run from the root of a checkout on a machine with one CUDA card:
``python3 full_protocols.py [label ...]`` (default: every label). A label is

- a PathNet band through ``chip_smoke.run_protocol_cli`` (the CLI, 10 rounds
  x 1000 epochs, temporary results and checkpoint directories), the mean
  held inside the JAX band: ``cornell:merw``, ``cornell:uniform``,
  ``Nba:merw`` (H = 256), ``cora:merw``, ``citeseer:merw``, ``cornell:mlp``,
  ``cornell:quirk``, ``cornell:gru_bf16``, and ROADMAP's item 14:
  ``texas:merw``, ``wisconsin:merw``, ``Dblp:merw`` (full batch),
  ``pubmed:merw`` (homo, microbatch 8192) and ``Electronics:bf16`` (H = 32,
  bf16, microbatch 8192), each at its band row's configuration; pubmed's
  and Electronics' kernels are first held at that configuration
  (``chip_smoke.check_band_kernels``, which prints Electronics' count of
  attention scores flipping across the leaky ReLU);
- a baseline band through ``chip_smoke.run_baseline_cli``:
  ``<dataset>:zoo-<model>`` for ``chip_smoke.BASELINE_BANDS``
  (``cornell:zoo-mlp``, ``cora:zoo-mlp``, ``Nba:zoo-mlp``, ``bgp:zoo-mlp``,
  ``cornell:zoo-gcn``, ``cornell:zoo-gat``, ``cora:zoo-gcn``,
  ``cora:zoo-gat``) and ``cornell:zoo-gcn-bf16``, ``cornell:zoo-gat-bf16``
  for ``chip_smoke.BASELINE_BF16_BANDS`` at ``--dtype bfloat16``;
- a runner of ``pathnet_tpu_torch.experiments`` at the JAX artifact's depth,
  every row held against that artifact under ``results/`` by one rule,
  |mean_port - mean_jax| <= 3 sqrt((std_jax^2 + std_port^2) / R) at its R
  rounds: ``ablation:cornell`` (walk lengths 2-5, 10 x 1000,
  ``results/ablation_length_cornell.json``), ``pattern`` (the path-pattern
  task, 3 x 800 a length, ``results/ablation_pattern.json``) and
  ``comparison:cornell`` (PathNet and the 17 baselines, 10 x 1000,
  ``results/comparison_cornell.json``), each artifact's numbers copied into
  ``JAX_ABLATION``, ``JAX_PATTERN``, ``JAX_COMPARISON``. A row outside its
  gate is printed with its numbers.

It copies ``data/edge_input/*.in`` into a temporary data root; the runners
write into a temporary results directory. Exits 1 if any run lies outside
its band or gate, or fails.
"""
import collections
import glob
import math
import os
import shutil
import sys
import tempfile
import traceback

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke as cs  # noqa: E402

# (label, dataset, hidden, band, payload, run_protocol_cli's choices)
RUNS = [("cornell:merw", "cornell", cs.HIDDEN, cs.CORNELL_BAND, cs.CORNELL_PAYLOAD, {}),
        ("cornell:uniform", "cornell", cs.HIDDEN, cs.CORNELL_UNIFORM_BAND, cs.CORNELL_PAYLOAD,
         dict(marker="uniform")),
        ("Nba:merw", "Nba", cs.NBA_HIDDEN, cs.NBA_BAND, cs.NBA_PAYLOAD, {}),
        ("cora:merw", "cora", cs.HIDDEN, cs.CORA_BAND, cs.HOMO_PAYLOADS["cora"], {}),
        ("citeseer:merw", "citeseer", cs.HIDDEN, cs.CITESEER_BAND,
         cs.HOMO_PAYLOADS["citeseer"], {}),
        ("cornell:mlp", "cornell", cs.HIDDEN, cs.CORNELL_MLP_BAND, cs.CORNELL_PAYLOAD,
         dict(rnn="mlp")),
        ("cornell:quirk", "cornell", cs.HIDDEN, cs.CORNELL_QUIRK_BAND, cs.CORNELL_PAYLOAD,
         dict(quirk=True)),
        ("cornell:gru_bf16", "cornell", cs.HIDDEN, cs.CORNELL_GRU_BF16_BAND,
         cs.CORNELL_PAYLOAD, dict(rnn="gru", dtype="bfloat16"))]
RUNS += [(f"{name}:merw", name, cs.HIDDEN, band, payload, {})
         for name, (band, payload) in cs.SWEEP_BANDS.items()]
RUNS += [(f"{name}:{'merw' if dtype == 'float32' else 'bf16'}", name, hidden, band, payload,
          dict(dtype=dtype, microbatch=mb))
         for name, hidden, band, payload, dtype, mb in cs.BAND_PROTOCOLS]
RUNS += [(f"{name}:zoo-{model}", name, hidden, band, payload, dict(model=model))
         for (name, model), (band, payload, hidden) in cs.BASELINE_BANDS.items()]
RUNS += [(f"cornell:zoo-{model}-bf16", "cornell", hidden, band, payload,
          dict(model=model, dtype="bfloat16"))
         for model, (band, payload, hidden) in cs.BASELINE_BF16_BANDS.items()]


def gate(tag, rows, rounds):
    """Hold each ``{row: ((mean, std), (mean_jax, std_jax))}`` to
    |mean - mean_jax| <= 3 sqrt((std_jax^2 + std^2) / rounds); prints every
    row; returns the rows outside."""
    bad = []
    for key, ((m, s), (mj, sj)) in rows.items():
        lim = 3 * math.sqrt((sj * sj + s * s) / rounds)
        ok = abs(m - mj) <= lim
        cs.say(f"  {tag} {key}: port {m:.4f} +- {s:.4f}, JAX {mj:.4f} +- {sj:.4f}, |diff| "
               f"{abs(m - mj):.4f} {'<=' if ok else '>'} {lim:.4f}"
               + ("" if ok else "  OUTSIDE"))
        if not ok:
            bad.append(key)
    return bad


# The JAX artifacts the runners are held to, copied from ``results/`` so the
# script reads no tracked run output (``tests/test_torch_experiments.py``
# holds them equal to the files): rounds, epochs, payload, {row: (mean, std)}.
JAX_ABLATION = dict(  # results/ablation_length_cornell.json
    rounds=10, epochs=1000, payload="89c32d97",
    rows={2: (0.7972973167896271, 0.057013577308642205),
          3: (0.8054054200649261, 0.060192047686529936),
          4: (0.8000000178813934, 0.05821799973974322),
          5: (0.7972973167896271, 0.057013577308642205)})
JAX_PATTERN = dict(  # results/ablation_pattern.json
    rounds=3, epochs=800, n=2000, num_walks=80, num_classes=5,
    rows={2: (0.6324999928474426, 0.01594259018737086),
          3: (0.6941666603088379, 0.009646521552676568),
          4: (0.6891666452089945, 0.022391721481069767),
          5: (0.6983333230018616, 0.00942808142449295)})
JAX_COMPARISON = dict(  # results/comparison_cornell.json
    rounds=10, epochs=1000, payload="89c32d97",
    rows={"PathNet": (0.8000000178813934, 0.05821799973974322),
          "mlp": (0.8135135352611542, 0.04902259545490344),
          "gcn": (0.6162162303924561, 0.0869917742771089),
          "gat": (0.5378378510475159, 0.05976579667633952),
          "sage": (0.789189213514328, 0.044900665728183985),
          "sage1": (0.789189213514328, 0.044900665728183985),
          "gin": (0.6081081211566925, 0.0856803654143686),
          "sgc": (0.635135155916214, 0.07073649220900176),
          "fagcn": (0.7513513803482056, 0.07528859175895308),
          "h2gcn": (0.7918919146060943, 0.054121571295385806),
          "mixhop": (0.7486486732959747, 0.04990860405902853),
          "gprgnn": (0.7918919146060943, 0.05275465765600082),
          "appnp": (0.7216216385364532, 0.04017856629502896),
          "link": (0.27567568272352216, 0.05512453384065116),
          "gcnjk": (0.6027027189731597, 0.08022065645449966),
          "gatjk": (0.5297297477722168, 0.06531376847221852),
          "cheb": (0.7864865064620972, 0.054658766965324346),
          "lp": (0.2486486554145813, 0.05896600988726725)})


def check_payload(label, want):
    from pathnet_tpu_torch.data.registry import DATASETS, payload_fingerprint

    if want["payload"] != payload_fingerprint(DATASETS["cornell"]):
        raise AssertionError(f"{label}: the JAX artifact's payload {want['payload']} is not "
                             "cornell's")


def run_ablation(common):
    from pathnet_tpu_torch.experiments import ablation_length

    want = JAX_ABLATION
    check_payload("ablation:cornell", want)
    rows = ablation_length.main(["cornell", str(want["rounds"]), str(want["epochs"])] + common)
    return gate("ablation:cornell wl", {wl: (rows[wl], want["rows"][wl]) for wl in sorted(rows)},
                want["rounds"])


def run_pattern(common):
    from pathnet_tpu_torch.experiments import ablation_pattern

    want = JAX_PATTERN
    got = ablation_pattern.main(["--n", str(want["n"]), "--rounds", str(want["rounds"]),
                                 "--epochs", str(want["epochs"]), "--num-walks",
                                 str(want["num_walks"])] + common)
    if got["num_classes"] != want["num_classes"]:
        raise AssertionError(f"pattern: {got['num_classes']} classes, JAX {want['num_classes']}")
    rows = {int(wl): ((v["mean"], v["std"]), want["rows"][int(wl)])
            for wl, v in got["lengths"].items()}
    return gate("pattern wl", dict(sorted(rows.items())), want["rounds"])


def run_comparison(common):
    from pathnet_tpu_torch.experiments import comparison_table

    want = JAX_COMPARISON
    check_payload("comparison:cornell", want)
    try:
        got = comparison_table.main(["cornell", str(want["rounds"]), str(want["epochs"])]
                                    + common)
    except SystemExit as e:
        raise AssertionError(f"comparison:cornell exited with {e.code}: a column is missing")
    return gate("comparison:cornell", {m: (got[m], want["rows"][m]) for m in want["rows"]},
                want["rounds"])


RUNNERS = {"ablation:cornell": run_ablation, "pattern": run_pattern,
           "comparison:cornell": run_comparison}


def main(only) -> int:
    import torch

    print(cs.nvidia_smi_line(), flush=True)
    failed = []
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "data")
        os.makedirs(os.path.join(root, "edge_input"))
        for f in glob.glob(os.path.join(cs.ROOT, "data", "edge_input", "*.in")):
            shutil.copy(f, os.path.join(root, "edge_input"))
        for label, name, hidden, band, payload, kw in RUNS:
            if only and label not in only:
                continue
            try:
                if "model" in kw:
                    cs.run_baseline_cli(name, kw["model"], root, tmp, 10, hidden, band, payload,
                                        dtype=kw.get("dtype", "float32"))
                else:
                    if name in cs.BAND_KERNEL_CHECKS:
                        cs.check_band_kernels(name, root, torch.device("cuda"),
                                              torch.Generator(device="cuda").manual_seed(0),
                                              collections.defaultdict(dict), hidden,
                                              kw.get("dtype", "float32"))
                    cs.run_protocol_cli(name, root, tmp, 10, hidden, band, payload, **kw)
            except Exception:
                traceback.print_exc()
                failed.append(label)
        for label, run in RUNNERS.items():
            if only and label not in only:
                continue
            out = os.path.join(tmp, "runners", label.replace(":", "_"))
            try:
                bad = run(["--data-root", root, "--results-dir", out])
            except Exception:
                traceback.print_exc()
                bad = ["failed"]
            if bad:
                failed.append(f"{label} ({', '.join(map(str, bad))})")
    print("FAILED " + " ".join(failed) if failed else "ALL INSIDE THEIR BANDS", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
