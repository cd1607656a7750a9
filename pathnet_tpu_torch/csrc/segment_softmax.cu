// S3 segment_softmax and S4 segment_softmax_bwd: GAT's per-destination,
// per-head softmax of edge scores, f32.
//
// Replace the XLA ops of pathnet_tpu/models/baselines/ops.py:76-82
// (segment_max, exp, segment_sum, divide by the sum clamped at 1e-16),
// vmapped over the heads in pathnet_tpu/models/baselines/zoo.py:327-328 and
// :447-448, and their VJP, ds_e = a_e (da_e - sum over e's row of a da).
// Scores and outputs are [E, heads] in the edge list's order; the rows are
// the destination-sorted CSR (ptr, perm). A thread takes a (row, head) pair
// (neighbouring threads the heads of one row, so a row's edges are read as
// heads-wide runs) and walks the row's edges in CSR order: the max, then
// the sum of exponentials, then the quotients (S4: the dot product, then
// the gradients), so every sum has one fixed order and no atomics.
// Bound on the H100: bytes, the scores (S4: a and da) read once, the CSR
// and the output written once, over 3.35 TB/s; a row's scores are read
// three times (S4 twice), from L1 or L2 after the first.
#include <cuda_runtime.h>
#include <math.h>

__global__ void __launch_bounds__(256) segment_softmax_kernel(const float* __restrict__ s,
                                                              const int* __restrict__ ptr,
                                                              const int* __restrict__ perm,
                                                              float* __restrict__ out, int n,
                                                              int heads) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= (long long)n * heads) return;
  const int row = (int)(t / heads), k = (int)(t - (long long)row * heads);
  const int beg = ptr[row], end = ptr[row + 1];
  float m = -INFINITY;
  for (int j = beg; j < end; ++j) m = fmaxf(m, s[(size_t)perm[j] * heads + k]);
  float sum = 0.f;
  for (int j = beg; j < end; ++j) sum += expf(s[(size_t)perm[j] * heads + k] - m);
  const float denom = fmaxf(sum, 1e-16f);
  for (int j = beg; j < end; ++j) {
    const size_t e = (size_t)perm[j] * heads + k;
    out[e] = expf(s[e] - m) / denom;
  }
}

__global__ void __launch_bounds__(256) segment_softmax_bwd_kernel(
    const float* __restrict__ a, const float* __restrict__ da, const int* __restrict__ ptr,
    const int* __restrict__ perm, float* __restrict__ ds, int n, int heads) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= (long long)n * heads) return;
  const int row = (int)(t / heads), k = (int)(t - (long long)row * heads);
  const int beg = ptr[row], end = ptr[row + 1];
  float dot = 0.f;
  for (int j = beg; j < end; ++j) {
    const size_t e = (size_t)perm[j] * heads + k;
    dot = fmaf(a[e], da[e], dot);
  }
  for (int j = beg; j < end; ++j) {
    const size_t e = (size_t)perm[j] * heads + k;
    ds[e] = a[e] * (da[e] - dot);
  }
}

static int blocks_for(int n, int heads) {
  return (int)(((long long)n * heads + 255) / 256);
}

// s [E, heads] f32, ptr int32 [n + 1], perm int32 [E], out [E, heads] f32.
extern "C" int pathnet_segment_softmax(const void* s, const void* ptr, const void* perm,
                                       void* out, int n, int heads, void* stream) {
  if (n == 0 || heads == 0) return 0;
  segment_softmax_kernel<<<blocks_for(n, heads), 256, 0, (cudaStream_t)stream>>>(
      (const float*)s, (const int*)ptr, (const int*)perm, (float*)out, n, heads);
  return (int)cudaGetLastError();
}

// a, da [E, heads] f32, ptr int32 [n + 1], perm int32 [E], ds [E, heads] f32.
extern "C" int pathnet_segment_softmax_bwd(const void* a, const void* da, const void* ptr,
                                           const void* perm, void* ds, int n, int heads,
                                           void* stream) {
  if (n == 0 || heads == 0) return 0;
  segment_softmax_bwd_kernel<<<blocks_for(n, heads), 256, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)da, (const int*)ptr, (const int*)perm, (float*)ds, n,
      heads);
  return (int)cudaGetLastError();
}
