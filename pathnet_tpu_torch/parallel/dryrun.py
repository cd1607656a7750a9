"""The multi-device dry run on CPU ranks (counterpart of
``__graft_entry__.dryrun_multichip``, parts 1-3, ``__graft_entry__.py:43-133``).

On ``n`` gloo ranks on the CPU (``utils.force_cpu_devices``), on a synthetic
MERW graph of ``512 * max(8, n)`` nodes:

1. one sharded training step with row-sharded ``X`` (the ``gspmd`` exchange);
2. a 6-epoch microbatched round (``run_round(mesh=..., shard_features=True)``);
3. the same step through the ``ring`` exchange, held within 1e-4 of the
   ``gspmd`` loss, and (for even ``n``) a ``n/2 x 2`` grid with the
   parameters sharded over the model axis and ``X`` row-sharded.

Each part prints one line, as JAX's dry run does::

    python -m pathnet_tpu_torch.parallel.dryrun [N]
"""
from __future__ import annotations

import math
import sys
from typing import List, Optional

import numpy as np
import torch

RING_TOL = 1e-4


def _problem(n: int, feat: int = 64, classes: int = 4, nw: int = 8, wl: int = 4,
             hidden: int = 32, seed: int = 0):
    """JAX's ``_tiny_problem`` on the port: a synthetic graph with MERW
    probabilities, its sampler, the model's spec and X, y on the CPU."""
    from ..data import synthetic_graph
    from ..merw import merw_graph
    from ..models import PaggSpec
    from ..sample import PathSampler

    g = merw_graph(synthetic_graph(n=n, avg_deg=5, num_classes=classes, feat_dim=feat,
                                   homophily=0.5, seed=seed), device="cpu")
    ps = PathSampler.build(g, nw, wl, device="cpu")
    spec = PaggSpec(feat_dim=feat, hidden=hidden, out_dim=classes, walk_len=wl)
    X = torch.from_numpy(np.asarray(g.features, np.float32))
    y = torch.from_numpy(np.asarray(g.labels, np.int64))
    return g, ps, spec, X, y


def _rank(grid, n_nodes: int) -> Optional[List[str]]:
    from ..config import TrainConfig
    from ..models import PathNet
    from ..train.trainer import epoch_uniforms, run_round
    from .comm import regrid
    from .mesh import shard_rows, sharded_train_step

    g, ps, spec, X, y = _problem(n_nodes)
    d = grid.data
    t = (g.n // 2) // d * d
    train_idx = torch.arange(t, dtype=torch.int32)
    val_idx = torch.arange(t, 2 * t, dtype=torch.int32)
    u = epoch_uniforms(ps, 0, 0)

    def step(gr, **kw):
        model = PathNet(spec, device="cpu", generator=torch.Generator().manual_seed(0))
        st = sharded_train_step(gr, model, spec.out_dim, shard_features=True, **kw)
        return st(shard_rows(X, gr.data_axis), y, ps, train_idx, val_idx, u)

    lines = []
    res = step(grid)
    if not math.isfinite(res.loss):
        raise AssertionError("non-finite loss in the multi-device dry run")
    lines.append(f"dryrun({grid.world}) step: loss={res.loss:.4f} val_acc={res.val_acc:.3f} "
                 f"grid={grid.data}x{grid.model} n={g.n} shard_features=True")

    idx = np.arange(g.n)
    masks = (idx % 10 < 5, (idx % 10 >= 5) & (idx % 10 < 8), idx % 10 >= 8)
    cfg = TrainConfig(epochs=6, lr=5e-3, microbatch=g.n // (2 * d) // 2 * 2)
    rnd = run_round(X, y, ps, spec, cfg, *masks, num_classes=spec.out_dim, seed=0,
                    mesh=grid, shard_features=True)
    if not (math.isfinite(rnd.best_val_acc) and math.isfinite(rnd.metrics["accuracy"])):
        raise AssertionError("non-finite round result in the multi-device dry run")
    lines.append(f"dryrun({grid.world}) round: best_val={rnd.best_val_acc:.3f} "
                 f"test_acc={rnd.metrics['accuracy']:.3f} epochs={cfg.epochs} "
                 f"microbatch={cfg.microbatch}")

    ring = step(grid, exchange="ring")
    if not math.isfinite(ring.loss) or abs(ring.loss - res.loss) >= RING_TOL:
        raise AssertionError(f"ring exchange loss {ring.loss} != gspmd's {res.loss}")
    line = f"dryrun({grid.world}) ring+tp: ring_loss={ring.loss:.4f}"
    if grid.world % 2 == 0:
        gtp = regrid(grid, grid.world // 2, 2)
        tp = step(gtp, shard_params=True)
        if not math.isfinite(tp.loss):
            raise AssertionError("non-finite loss on the data x model grid")
        line += (f" tp_loss={tp.loss:.4f} grid_tp={gtp.data}x{gtp.model} "
                 "tp_shard_features=True")
    lines.append(line)
    return lines if grid.rank == 0 else None


def dryrun(n: int = 8, n_nodes: Optional[int] = None, timeout_s: float = 900.0,
           threads: Optional[int] = None) -> List[str]:
    """Run the three parts on ``n`` gloo CPU ranks; print and return their
    lines. ``n_nodes`` defaults to JAX's ``512 * max(8, n)``."""
    from ..utils.platform import force_cpu_devices

    lines = force_cpu_devices(_rank, n, args=(n_nodes or 512 * max(8, n),),
                              timeout_s=timeout_s, threads=threads)[0]
    for line in lines:
        print(line, flush=True)
    return lines


if __name__ == "__main__":
    dryrun(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
