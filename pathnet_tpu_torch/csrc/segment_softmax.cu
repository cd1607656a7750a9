// S3 segment_softmax and S4 segment_softmax_bwd: GAT's per-destination,
// per-head softmax of edge scores, f32 and bf16.
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
//
// The bf16 instances (bf16 scores in and out) share the f32 kernels' body,
// a template on the scores' type. S3 rounds to bf16 where XLA rounds JAX's
// bf16 segment_softmax on the CPU: s - max, its exp, the denominator after
// each add in edge order, the clamp at 1e-16 rounded to bf16, the quotient
// (expf may differ from XLA's exp by an f32 ulp, and so a quotient by a
// bf16 ulp). S4 computes the analytic VJP in f32 on the bf16 a and da and
// rounds each gradient once; JAX's VJP rounds op by op, so S4 agrees with
// it to a tolerance, not bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

__device__ __forceinline__ float ld(float v) { return v; }
__device__ __forceinline__ float ld(__nv_bfloat16 v) { return __bfloat162float(v); }

// x in T's precision: itself, or rounded to the nearest bf16
template <typename T>
__device__ __forceinline__ float rnd(float x) { return x; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void put(float& o, float v) { o = v; }
__device__ __forceinline__ void put(__nv_bfloat16& o, float v) { o = __float2bfloat16_rn(v); }

template <typename T>
__device__ __forceinline__ void softmax_row(const T* __restrict__ s, const int* __restrict__ ptr,
                                            const int* __restrict__ perm, T* __restrict__ out,
                                            int n, int heads) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= (long long)n * heads) return;
  const int row = (int)(t / heads), k = (int)(t - (long long)row * heads);
  const int beg = ptr[row], end = ptr[row + 1];
  float m = -INFINITY;
  for (int j = beg; j < end; ++j) m = fmaxf(m, ld(s[(size_t)perm[j] * heads + k]));
  float sum = 0.f;
  for (int j = beg; j < end; ++j)
    sum = rnd<T>(sum + rnd<T>(expf(rnd<T>(ld(s[(size_t)perm[j] * heads + k]) - m))));
  const float denom = fmaxf(sum, rnd<T>(1e-16f));
  for (int j = beg; j < end; ++j) {
    const size_t e = (size_t)perm[j] * heads + k;
    put(out[e], rnd<T>(expf(rnd<T>(ld(s[e]) - m))) / denom);
  }
}

template <typename T>
__device__ __forceinline__ void softmax_bwd_row(const T* __restrict__ a, const T* __restrict__ da,
                                                const int* __restrict__ ptr,
                                                const int* __restrict__ perm,
                                                T* __restrict__ ds, int n, int heads) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= (long long)n * heads) return;
  const int row = (int)(t / heads), k = (int)(t - (long long)row * heads);
  const int beg = ptr[row], end = ptr[row + 1];
  float dot = 0.f;
  for (int j = beg; j < end; ++j) {
    const size_t e = (size_t)perm[j] * heads + k;
    dot = fmaf(ld(a[e]), ld(da[e]), dot);
  }
  for (int j = beg; j < end; ++j) {
    const size_t e = (size_t)perm[j] * heads + k;
    put(ds[e], ld(a[e]) * (ld(da[e]) - dot));
  }
}

__global__ void __launch_bounds__(256) segment_softmax_kernel(const float* __restrict__ s,
                                                              const int* __restrict__ ptr,
                                                              const int* __restrict__ perm,
                                                              float* __restrict__ out, int n,
                                                              int heads) {
  softmax_row(s, ptr, perm, out, n, heads);
}

__global__ void __launch_bounds__(256) segment_softmax_bf16_kernel(
    const __nv_bfloat16* __restrict__ s, const int* __restrict__ ptr,
    const int* __restrict__ perm, __nv_bfloat16* __restrict__ out, int n, int heads) {
  softmax_row(s, ptr, perm, out, n, heads);
}

__global__ void __launch_bounds__(256) segment_softmax_bwd_kernel(
    const float* __restrict__ a, const float* __restrict__ da, const int* __restrict__ ptr,
    const int* __restrict__ perm, float* __restrict__ ds, int n, int heads) {
  softmax_bwd_row(a, da, ptr, perm, ds, n, heads);
}

__global__ void __launch_bounds__(256) segment_softmax_bwd_bf16_kernel(
    const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ da,
    const int* __restrict__ ptr, const int* __restrict__ perm, __nv_bfloat16* __restrict__ ds,
    int n, int heads) {
  softmax_bwd_row(a, da, ptr, perm, ds, n, heads);
}

static int blocks_for(int n, int heads) {
  return (int)(((long long)n * heads + 255) / 256);
}

// s [E, heads] f32 (bf16: bf16), ptr int32 [n + 1], perm int32 [E], out
// [E, heads] of s's type.
extern "C" int pathnet_segment_softmax(const void* s, const void* ptr, const void* perm,
                                       void* out, int n, int heads, int bf16, void* stream) {
  if (n == 0 || heads == 0) return 0;
  if (bf16)
    segment_softmax_bf16_kernel<<<blocks_for(n, heads), 256, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)s, (const int*)ptr, (const int*)perm, (__nv_bfloat16*)out, n,
        heads);
  else
    segment_softmax_kernel<<<blocks_for(n, heads), 256, 0, (cudaStream_t)stream>>>(
        (const float*)s, (const int*)ptr, (const int*)perm, (float*)out, n, heads);
  return (int)cudaGetLastError();
}

// a, da [E, heads] f32 (bf16: bf16), ptr int32 [n + 1], perm int32 [E], ds
// [E, heads] of a's type.
extern "C" int pathnet_segment_softmax_bwd(const void* a, const void* da, const void* ptr,
                                           const void* perm, void* ds, int n, int heads,
                                           int bf16, void* stream) {
  if (n == 0 || heads == 0) return 0;
  if (bf16)
    segment_softmax_bwd_bf16_kernel<<<blocks_for(n, heads), 256, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)a, (const __nv_bfloat16*)da, (const int*)ptr, (const int*)perm,
        (__nv_bfloat16*)ds, n, heads);
  else
    segment_softmax_bwd_kernel<<<blocks_for(n, heads), 256, 0, (cudaStream_t)stream>>>(
        (const float*)a, (const float*)da, (const int*)ptr, (const int*)perm, (float*)ds, n,
        heads);
  return (int)cudaGetLastError();
}
