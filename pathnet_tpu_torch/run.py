"""CLI (port of ``pathnet_tpu/run.py:20-221``): the JAX CLI's flags, on torch.

    python -m pathnet_tpu_torch.run -data cornell [--device cpu]

The same flags and defaults as ``python -m pathnet_tpu.run``, with
``--device`` in place of ``--platform`` (default: the CUDA card).
``--mesh N`` runs PathNet's rounds on ``N`` ranks that this command spawns
(``parallel.comm.spawn``): NCCL on the cards, one card a rank, or gloo with
``--device cpu``; ``--shard-features`` row-shards ``X`` over them, the rows
of other ranks coming through an all-gather (JAX's GSPMD exchange). A
config file's ``mesh.data_axis x mesh.model_axis`` sets ``--mesh`` as in
JAX. ``--mesh`` with a baseline ``--model`` raises ``NotImplementedError``
naming ROADMAP.md (the baseline trainer's mesh branch is not ported yet).
``--model <name>`` trains a model of the baseline zoo (``models/baselines``)
full batch, as the JAX CLI's baseline branch does: one payload load a round,
the seed ``--seed + round``, JAX's checkpoint key and the model's name in
the result line; with ``--dtype bfloat16`` it computes as JAX's bf16 zoo
does, through the bf16 instances of S1-S4 (key suffix ``.bfloat16``).
``-mk uniform`` walks the symmetrized graph with self-loops, uniformly, and
skips MERW (RW-PathNet), as in the JAX CLI. The homophily datasets (cora, citeseer, pubmed) train the
homo variant, as in the JAX CLI. ``--rnn gru`` and ``--rnn mlp`` run the GRU
and MLP encoders and ``--agg mean|sum`` the mean or sum readout, through K3's
and K4's cell and ``AGG`` instances; ``--quirk-compat`` runs JAX's quirk path
(hetero, f32) through their quirk readout. ``--dtype bfloat16`` computes the encode in bf16 through
K3's and K4's bf16 instances (the bgp band's configuration: ``-data bgp
--dtype bfloat16 --microbatch 8192``).
``--no-scan``, ``--scan-chunk`` and ``--remat`` are accepted and change
nothing. The result line and the JSONL record go to ``--results-dir`` as in
the JAX CLI. The port's defaults are ``--results-dir results_torch`` and
``--ckpt-dir saved_models_torch``: ``results/`` and ``saved_models/`` hold the
JAX package's records and checkpoints under the same names and keys.
"""
from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="pathnet_tpu_torch training CLI")
    p.add_argument("-data", "--data_name", type=str, required=True)
    p.add_argument("-lr", "--learning_rate", type=float, default=0.005)
    p.add_argument("-dr", "--dropout", type=float, default=0.7)
    p.add_argument("-e", "--epoch", type=int, default=1000)
    p.add_argument("-wd", "--weight_decay", type=float, default=0.0005)
    p.add_argument("-r", "--round", type=int, default=10)
    p.add_argument("-hid", "--hidden_size", type=int, default=64)
    p.add_argument("-nw", "--num_of_walks", type=int, default=40)
    p.add_argument("-wl", "--walk_length", type=int, default=4)
    p.add_argument("-mk", "--marker", type=str, default="merw",
                   choices=["merw", "uniform"])
    p.add_argument("-pr", "--data_root", type=str, default="data")
    p.add_argument("-mode", "--model_mode", type=str, default="pathnet")
    # reference-command parity (PathNet_run.py:57-63): -nd marks an
    # npy-triple dataset, -ndr points at the directory holding other_data/.
    # Our registry infers both, so -nd is accepted as a no-op and -ndr
    # rebinds the payload root.
    p.add_argument("-nd", "--is_new_data", action="store_true",
                   help="reference-parity flag; payload source is inferred "
                        "from the registry, so this is informational")
    p.add_argument("-ndr", "--new_data_root", type=str, default=None,
                   help="directory containing other_data/<name>/{x,y,"
                        "edge_index}.npy (reference -ndr); overrides "
                        "--data_root for payload lookup")
    p.add_argument("--model", type=str, default="pathnet",
                   help="pathnet or a baseline: mlp/gcn/gat/gatjk/sage/sage1/"
                        "gin/sgc/sgcmem/cheb/fagcn/h2gcn/mixhop/gprgnn/appnp/"
                        "link/gcnjk/lp")
    p.add_argument("--rnn", type=str, default="lstm",
                   choices=["lstm", "gru", "mlp"])
    p.add_argument("--agg", type=str, default="attention",
                   choices=["attention", "mean", "sum"])
    p.add_argument("--quirk-compat", action="store_true")
    p.add_argument("--remat", type=str, default="auto",
                   choices=["auto", "on", "off"],
                   help="accepted for the JAX CLI's sake; the encode "
                        "backward always recomputes its forward")
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="compute dtype of the encode (gather, distance "
                        "transform, LSTM); params, attention and head stay "
                        "float32")
    p.add_argument("--results-dir", type=str, default="results_torch")
    p.add_argument("--ckpt-dir", type=str, default="saved_models_torch")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-scan", action="store_true",
                   help="accepted for the JAX CLI's sake; the port always "
                        "runs a Python epoch loop")
    p.add_argument("--scan-chunk", type=int, default=100,
                   help="accepted for the JAX CLI's sake; no effect here")
    p.add_argument("--microbatch", type=int, default=None,
                   help="nodes per gradient-accumulation chunk (exact math; "
                        "bounds activation memory for 40k+-node graphs)")
    p.add_argument("--mesh", type=int, default=None,
                   help="run the round scan SPMD over an N-device data mesh")
    p.add_argument("--shard-features", action="store_true",
                   help="row-shard X over the mesh (graph-partitioned mode)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "the plain PyTorch versions of the kernels)")
    p.add_argument("-c", "--config", type=str, default=None,
                   help="Config JSON file (config.Config.to_json); its values "
                        "become the defaults, explicit CLI flags override")
    return p


def _apply_config_defaults(parser: argparse.ArgumentParser, path: str):
    """Seed parser defaults from a Config JSON (two-phase parse: a flag
    typed on the command line still wins over the file)."""
    from .config import Config

    with open(path) as f:
        c = Config.from_json(f.read())
    parser.set_defaults(
        data_name=c.dataset, data_root=c.data_root,
        learning_rate=c.train.lr, weight_decay=c.train.weight_decay,
        epoch=c.train.epochs, round=c.train.rounds, seed=c.train.seed,
        scan_chunk=c.train.scan_chunk or 0, microbatch=c.train.microbatch,
        hidden_size=c.model.hidden, dropout=c.model.dropout,
        rnn=c.model.rnn, agg=c.model.agg, quirk_compat=c.model.quirk_compat,
        num_of_walks=c.sample.num_walks, walk_length=c.sample.walk_len,
        marker=c.sample.kind,
        mesh=(c.mesh.data_axis * c.mesh.model_axis
              if c.mesh.data_axis * c.mesh.model_axis > 1 else None))
    # -data is required unless the config provides it
    for a in parser._actions:
        if a.dest == "data_name":
            a.required = False


def check_ported(args) -> None:
    """Raise ``NotImplementedError`` (naming ROADMAP) for a choice the port
    does not run yet, ``ValueError`` for a ``--model`` the JAX CLI does not
    know."""
    from .models.baselines import BASELINES, EXTRA_MODELS

    if args.model != "pathnet" and args.model not in BASELINES + EXTRA_MODELS:
        raise ValueError(f"unknown baseline {args.model}")
    if args.model != "pathnet" and args.mesh:
        raise NotImplementedError(
            f"--mesh with --model {args.model} is not ported yet (the baseline trainer's "
            "mesh branch, ROADMAP §1 item 11)")


def baseline_checkpoint_name(args, fingerprint: str) -> str:
    """The JAX CLI's baseline key (``pathnet_tpu/run.py:178-181``)."""
    return (f"{args.data_name}.{args.model}.{fingerprint}"
            f".e{args.epoch}.h{args.hidden_size}"
            f".s{args.seed}.dr{args.dropout}"
            + ("" if args.dtype == "float32" else f".{args.dtype}"))


def run_baselines(args, cfg):
    """The JAX CLI's baseline branch (``pathnet_tpu/run.py:163-208``): one
    ``load_dataset`` and one :func:`run_baseline_round` a round, the seed
    ``cfg.seed + round``, each round saved under JAX's key with
    ``--resume`` (and a saved round taken). Returns the aggregate."""
    from .data.registry import DATASETS, load_dataset, payload_fingerprint
    from .device import resolve_device
    from .models.baselines import BaselineSpec
    from .train.baseline_trainer import run_baseline_round
    from .train.checkpoint import load_round, save_round
    from .train.results import aggregate_rounds
    from .train.trainer import RoundResult

    name = args.data_name
    spec_d = DATASETS[name]
    ckpt_name = baseline_checkpoint_name(args, payload_fingerprint(spec_d))
    dev = resolve_device(args.device)
    results = []
    for round_i in range(cfg.rounds):
        if args.resume:
            prev = load_round(args.ckpt_dir, ckpt_name, round_i)
            if prev is not None:
                results.append(RoundResult(best_val_acc=prev["meta"]["best_val_acc"],
                                           metrics=prev["meta"]["metrics"]))
                print(f"round {round_i}: resumed "
                      f"(acc={prev['meta']['metrics']['accuracy']:.4f})")
                continue
        g, tr, va, te, _ = load_dataset(name, args.data_root, round_i)
        spec = BaselineSpec(name=args.model, feat_dim=g.features.shape[1],
                            hidden=args.hidden_size, out_dim=spec_d.num_classes,
                            dropout=args.dropout, n_nodes=g.n, compute_dtype=args.dtype)
        res = run_baseline_round(g, spec, cfg, tr, va, te, spec_d.num_classes,
                                 seed=cfg.seed + round_i, device=dev)
        if args.resume:
            save_round(args.ckpt_dir, ckpt_name, round_i, res)
        results.append(res)
        print(f"round {round_i}: acc={results[-1].metrics['accuracy']:.4f}", flush=True)
    return aggregate_rounds(results)


def train_config(args):
    from .config import TrainConfig

    return TrainConfig(lr=args.learning_rate, weight_decay=args.weight_decay,
                       epochs=args.epoch, rounds=args.round, seed=args.seed,
                       scan_epochs=not args.no_scan, microbatch=args.microbatch,
                       scan_chunk=args.scan_chunk or None)


def protocol_kwargs(args) -> dict:
    """``run_protocol``'s arguments from the flags (but ``cfg`` and the
    device)."""
    return dict(data_root=args.data_root, num_walks=args.num_of_walks,
                walk_len=args.walk_length, hidden=args.hidden_size, kind=args.marker,
                rnn=args.rnn, agg=args.agg, quirk_compat=args.quirk_compat,
                dropout=args.dropout, compute_dtype=args.dtype, remat=args.remat,
                ckpt_dir=args.ckpt_dir if args.resume else None)


def run_mesh_rank(grid, flags: dict):
    """One rank of ``--mesh``: the protocol on the grid; rank 0 returns the
    aggregate (and alone saves rounds), the others None."""
    args = argparse.Namespace(**flags)
    from .train import run_protocol

    agg, _ = run_protocol(args.data_name, cfg=train_config(args), mesh=grid,
                          shard_features=args.shard_features, **protocol_kwargs(args))
    return agg if grid.rank == 0 else None


def main(argv=None):
    """Run the protocol the flags describe; returns the mean/std of the five
    test metrics over the rounds."""
    parser = build_parser()
    av = list(sys.argv[1:] if argv is None else argv)
    for i, tok in enumerate(av):
        if tok in ("-c", "--config") and i + 1 < len(av):
            _apply_config_defaults(parser, av[i + 1])
            break
        if tok.startswith("--config="):
            _apply_config_defaults(parser, tok.split("=", 1)[1])
            break
    args = parser.parse_args(av)
    check_ported(args)

    from .data.registry import DATASETS, payload_fingerprint
    from .train.results import append_results

    cfg = train_config(args)
    name = args.data_name
    if args.new_data_root:
        args.data_root = args.new_data_root
    t0 = time.time()
    print(f"{name}: {vars(args)}")
    if args.model == "pathnet" and args.mesh:
        from .parallel import spawn

        agg = spawn(run_mesh_rank, args.mesh, device=args.device, args=(vars(args),),
                    timeout_s=None)[0]
        mode = args.model_mode
    elif args.model == "pathnet":
        from .train import run_protocol

        agg, _ = run_protocol(name, cfg=cfg, device=args.device, **protocol_kwargs(args))
        mode = args.model_mode
    else:
        agg = run_baselines(args, cfg)
        mode = args.model
    config = dict(vars(args))
    if name in DATASETS:
        config["payload"] = payload_fingerprint(DATASETS[name])
    line = append_results(args.results_dir, name, agg, config, mode)
    print(line)
    print(f"total {time.time() - t0:.1f}s")
    return agg


if __name__ == "__main__":
    main()
