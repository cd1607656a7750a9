"""Configuration dataclasses (port of ``pathnet_tpu/config.py:15-111``).

Field for field the JAX package's config tree, so a JAX config JSON loads
here unchanged. ``TrainConfig.scan_epochs`` and ``scan_chunk`` are kept for
that reason only: the port's epoch loop is a Python loop of eager steps,
and neither field changes its math or its results. ``MeshConfig`` is read by
``run.py`` and refused there until the multi-device layer is ported
(ROADMAP §1 item 11).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SampleConfig:
    """Path-sampling configuration (reference: gen_merw.cpp argv + constants)."""

    num_walks: int = 40          # -nw (PathNet_run.py:53)
    walk_len: int = 4            # -wl (PathNet_run.py:54)
    kind: str = "merw"           # -mk marker: "merw" | "uniform" (gen.cpp vs gen_merw.cpp)
    # uniform mode symmetrizes + adds self loops like gen.cpp:83-94
    add_self_loops: bool = True
    # distance backend (sample/walk.py PathSampler.build): "auto" picks
    # "membership" (N1/N2 row tests) for walk_len <= 4, else "khop" (sorted
    # k-hop rows, K7), which falls back to "dense" ([n, n] int8
    # truncated-BFS table) past its byte limit; "host" = scipy oracle.
    distance_backend: str = "auto"
    distance_chunk: int = 1024
    # sampler backend: "cdf" = inverse-CDF rows (K1); "alias" = O(1) Vose
    # rolls (K8). Both are ported; PathSampler.build(..., sampler=) takes it.
    sampler: str = "cdf"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """PAGG model configuration (reference: PathNet_run.py:150-278)."""

    hidden: int = 64             # -hid
    dropout: float = 0.7         # -dr
    variant: str = "auto"        # "hetero" | "homo" | "auto" (dispatch at :286-291)
    rnn: str = "lstm"            # "lstm" | "gru" | "mlp"  (paper ablation rows)
    agg: str = "attention"       # "attention" | "mean" | "sum" (paper ablation rows)
    # Reproduce the reference hetero walk-major mean-misgrouping
    # (PathNet_run.py:196-204, see SURVEY.md §2.4) for golden-value parity.
    quirk_compat: bool = False
    param_dtype: str = "float32"
    compute_dtype: str = "float32"  # or "bfloat16": the encode in bf16 (K3, K4)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training protocol (reference: PathNet_run.py:281-485)."""

    lr: float = 0.005            # -lr
    weight_decay: float = 0.0005  # -wd; torch Adam additive-L2 semantics
    epochs: int = 1000           # -e
    rounds: int = 10             # -r
    seed: int = 0
    # JAX's epoch-loop form (one scan, or chunks of scan_chunk epochs);
    # accepted and without effect in the port's Python epoch loop.
    scan_epochs: bool = True
    scan_chunk: Optional[int] = 100
    # Gradient-accumulation chunk size (nodes per microbatch). None = one
    # full-batch shot.  Identical math (grads sum, CE stays a mean over the
    # full mask); bounds activation memory on large graphs.
    microbatch: Optional[int] = None
    eval_every: int = 1
    checkpoint_dir: Optional[str] = None
    results_dir: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Multi-device layout: the CLI runs ``data_axis * model_axis`` ranks, as
    the JAX CLI sizes its mesh (``pathnet_tpu/run.py:106-107``)."""

    data_axis: int = 1           # node/path-partition parallel degree
    model_axis: int = 1          # hidden-dim parallel degree
    axis_names: Tuple[str, str] = ("data", "model")


@dataclasses.dataclass(frozen=True)
class Config:
    dataset: str = "cornell"
    data_root: str = "data"
    sample: SampleConfig = dataclasses.field(default_factory=SampleConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "Config":
        d = json.loads(s)
        return Config(
            dataset=d.get("dataset", "cornell"),
            data_root=d.get("data_root", "data"),
            sample=SampleConfig(**d.get("sample", {})),
            model=ModelConfig(**d.get("model", {})),
            train=TrainConfig(**d.get("train", {})),
            mesh=MeshConfig(**{**d.get("mesh", {}),
                               **({"axis_names": tuple(d["mesh"]["axis_names"])}
                                  if "mesh" in d and "axis_names" in d["mesh"] else {})}),
        )
