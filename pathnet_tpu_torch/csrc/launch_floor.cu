// An empty kernel: one block of 32 threads that does nothing. Its time per
// launch in a CUDA graph is the launch floor against which a kernel at a
// small size is read (a kernel near it is bound by its launch, not its work).
#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int pathnet_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
