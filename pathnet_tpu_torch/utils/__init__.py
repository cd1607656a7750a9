"""Host utilities (port of ``pathnet_tpu/utils``): phase timers, throughput
counters, a ``torch.profiler`` trace, and the kernel build directory as the
port's compilation cache. ``force_cpu_devices`` (the JAX package's virtual CPU
mesh) belongs to the multi-device layer, ROADMAP §1 item 11."""
from .cache import enable_compilation_cache
from .profiling import trace, Throughput
from .timing import Timer

__all__ = ["enable_compilation_cache", "Timer", "trace", "Throughput"]
