"""Host utilities (port of ``pathnet_tpu/utils``): phase timers, throughput
counters, a ``torch.profiler`` trace, and the kernel build directory as the
port's compilation cache, and ``force_cpu_devices``: gloo ranks on the CPU, the
counterpart of the JAX package's virtual CPU mesh."""
from .cache import enable_compilation_cache
from .platform import force_cpu_devices
from .profiling import trace, Throughput
from .timing import Timer

__all__ = ["enable_compilation_cache", "force_cpu_devices", "Timer", "trace", "Throughput"]
