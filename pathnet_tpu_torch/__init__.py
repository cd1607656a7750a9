"""pathnet_tpu_torch — the PyTorch/CUDA port of ``pathnet_tpu`` for one NVIDIA H100.

The layout mirrors the JAX package so each module's counterpart is easy to
find:

- ``pathnet_tpu_torch.data``    — the file readers and writers, the numpy ``Graph``, the
  padded-CSR ``DeviceGraph``, the synthetic payloads and SBM stand-ins, the
  dataset registry with its payload cache, splits and validation, the
  adjacency transforms and homophily measures.
- ``pathnet_tpu_torch.merw``    — MERW transition probabilities: the power
  iteration on the device, the per-component f64 log-space solver on the
  host, the recovery of integer edge weights, and the dense companions
  (``merw.extras``: random-walk transitions, SimRank, the P-distance).
- ``pathnet_tpu_torch.sample``  — the inverse-CDF walk sampler and the
  membership hop distances.
- ``pathnet_tpu_torch.nn``      — torch-default initializers, the plain LSTM
  and GRU scans, classification metrics.
- ``pathnet_tpu_torch.models``  — the PAGG model (``PathNet``) and the
  parameter conversion from the JAX package's pytree.
- ``pathnet_tpu_torch.train``   — training (``run_round``, ``run_protocol``,
  checkpoints, results) and serving (``predict``, ``evaluate``).
- ``pathnet_tpu_torch.parallel`` — the multi-device layer: ranks and
  collectives over ``torch.distributed``, the ring and sparse feature
  exchanges, data- and model-parallel steps, the CPU dry run.
- ``pathnet_tpu_torch.run``     — the training CLI.
- ``pathnet_tpu_torch.init_rw`` — the MERW edge-input writer CLI.
- ``pathnet_tpu_torch.experiments`` — the runners of the paper's tables: the
  walk-length and path-pattern ablations, the comparison column, the
  protocol sweep.
- ``pathnet_tpu_torch.utils``   — timers, throughput, a ``torch.profiler``
  trace, the kernel build directory as the compilation cache.
- ``pathnet_tpu_torch.gather_probe`` — the row and lane gather probe (K5, K6).
- ``pathnet_tpu_torch.kernels`` — the hand-written CUDA kernels (sources in
  ``csrc/``), each beside its plain PyTorch version.

Entry points take ``device=None``, which means the CUDA card; they raise when
no card is present and never fall back to the CPU. Pass ``device="cpu"`` to
run the plain PyTorch versions of the kernels.
"""
from .device import resolve_device

__version__ = "0.1.0"
__all__ = ["resolve_device"]
