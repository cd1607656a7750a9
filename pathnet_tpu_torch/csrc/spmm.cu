// S1 spmm and S2 edge_dot: the baseline zoo's message passing, f32.
//
// Replace the XLA ops of pathnet_tpu/models/baselines/ops.py:68-73 (spmm:
// the gather h[src], the scale by the edge weight, segment_sum into dst), of
// the per-head message sums of GAT, GATJK and FAGCN
// (pathnet_tpu/models/baselines/zoo.py:330-331, :450-452, :390-391) and of
// their VJPs.
//
// S1: out[i, k, :] = sum over the CSR row i of w[perm[j], k] * h[col[j], k, :]
// (h [*, heads, hdim] as [*, F], w [E, heads] in the edge list's order, or
// null for a weight of 1). Over the destination-sorted CSR (col = src) it is
// Â h; over the source-sorted CSR (col = dst) it is the transpose, the
// input gradient; with col = perm and no w it sums edge rows by node, the
// VJP of a gather by edge. A group of L lanes takes a row (L the row's
// float4s, or floats when hdim is not a multiple of 4, rounded up to a power
// of two, at most 32; 256 / L rows a block); each lane walks its columns and,
// for each, the row's edges in CSR order, so every sum has one fixed order
// and no atomics. An empty row writes zeros.
// S2: dw[e, k] = <g[dst_e, k, :], h[src_e, k, :]>, the edge weights'
// gradient: a group of lanes sized from hdim takes an edge, each head's sum
// reduced by a butterfly of shuffles in a fixed order.
// Bound on the H100: bytes, h (or g and h) read once, the CSR, w and the
// output, over 3.35 TB/s; the rows of h are gathered, so reads of a row
// that several edges share come from L2.
#include <cuda_runtime.h>

__device__ __forceinline__ void fma_into(float& acc, float w, float v) { acc = fmaf(w, v, acc); }

__device__ __forceinline__ void fma_into(float4& acc, float w, float4 v) {
  acc.x = fmaf(w, v.x, acc.x);
  acc.y = fmaf(w, v.y, acc.y);
  acc.z = fmaf(w, v.z, acc.z);
  acc.w = fmaf(w, v.w, acc.w);
}

__device__ __forceinline__ float dot(float a, float b) { return a * b; }

__device__ __forceinline__ float dot(float4 a, float4 b) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, a.x * b.x)));
}

template <typename V>
__device__ __forceinline__ V zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ float4 zero<float4>() { return make_float4(0.f, 0.f, 0.f, 0.f); }

// width, hdim: in units of V; heads = width / hdim.
template <typename V>
__global__ void __launch_bounds__(256) spmm_kernel(const V* __restrict__ h,
                                                   const float* __restrict__ w,
                                                   const int* __restrict__ ptr,
                                                   const int* __restrict__ perm,
                                                   const int* __restrict__ col,
                                                   V* __restrict__ out, int n, int width,
                                                   int hdim, int heads, int lanes_log2) {
  const int row = blockIdx.x * (256 >> lanes_log2) + (threadIdx.x >> lanes_log2);
  if (row >= n) return;
  const int beg = ptr[row], end = ptr[row + 1];
  for (int c = threadIdx.x & ((1 << lanes_log2) - 1); c < width; c += 1 << lanes_log2) {
    const int k = c / hdim;
    V acc = zero<V>();
    for (int j = beg; j < end; ++j) {
      const float we = w == nullptr ? 1.f : w[(size_t)perm[j] * heads + k];
      fma_into(acc, we, h[(size_t)col[j] * width + c]);
    }
    out[(size_t)row * width + c] = acc;
  }
}

template <typename V>
__global__ void __launch_bounds__(256) edge_dot_kernel(const V* __restrict__ g,
                                                       const V* __restrict__ h,
                                                       const int* __restrict__ src,
                                                       const int* __restrict__ dst,
                                                       float* __restrict__ out, int E,
                                                       int width, int hdim, int heads,
                                                       int lanes_log2) {
  const int e = blockIdx.x * (256 >> lanes_log2) + (threadIdx.x >> lanes_log2);
  const int lanes = 1 << lanes_log2;
  const int lane = threadIdx.x & (lanes - 1);
  const bool live = e < E;   // every lane of a warp takes part in the shuffles
  const V* gr = g + (size_t)(live ? dst[e] : 0) * width;
  const V* hr = h + (size_t)(live ? src[e] : 0) * width;
  for (int k = 0; k < heads; ++k) {
    float acc = 0.f;
    if (live)
      for (int d = lane; d < hdim; d += lanes) acc += dot(gr[k * hdim + d], hr[k * hdim + d]);
    for (int off = lanes >> 1; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (live && lane == 0) out[(size_t)e * heads + k] = acc;
  }
}

static int lanes_log2_for(int width) {
  int l = 0;
  while (l < 5 && (1 << l) < width) ++l;
  return l;
}

static bool aligned16(const void* p) { return ((size_t)p & 15) == 0; }

template <typename V>
static int launch_spmm(const void* h, const void* w, const void* ptr, const void* perm,
                       const void* col, void* out, int n, int width, int hdim, int heads,
                       void* stream) {
  const int l = lanes_log2_for(width);
  const int rows = 256 >> l;
  spmm_kernel<V><<<(n + rows - 1) / rows, 256, 0, (cudaStream_t)stream>>>(
      (const V*)h, (const float*)w, (const int*)ptr, (const int*)perm, (const int*)col,
      (V*)out, n, width, hdim, heads, l);
  return (int)cudaGetLastError();
}

template <typename V>
static int launch_edge_dot(const void* g, const void* h, const void* src, const void* dst,
                           void* out, int E, int width, int hdim, int heads, void* stream) {
  const int l = lanes_log2_for(hdim);
  const int edges = 256 >> l;
  edge_dot_kernel<V><<<(E + edges - 1) / edges, 256, 0, (cudaStream_t)stream>>>(
      (const V*)g, (const V*)h, (const int*)src, (const int*)dst, (float*)out, E, width,
      hdim, heads, l);
  return (int)cudaGetLastError();
}

// h [*, F] f32 (F = heads * hdim), w [E, heads] f32 or null, ptr int32 [n + 1],
// perm and col int32 [ptr[n]], out [n, F] f32.
extern "C" int pathnet_spmm(const void* h, const void* w, const void* ptr, const void* perm,
                            const void* col, void* out, int n, int F, int heads,
                            void* stream) {
  if (n == 0 || F == 0) return 0;
  const int hdim = F / heads;
  if (hdim % 4 == 0 && aligned16(h) && aligned16(out))
    return launch_spmm<float4>(h, w, ptr, perm, col, out, n, F / 4, hdim / 4, heads, stream);
  return launch_spmm<float>(h, w, ptr, perm, col, out, n, F, hdim, heads, stream);
}

// g, h [*, F] f32, src, dst int32 [E], out [E, heads] f32.
extern "C" int pathnet_edge_dot(const void* g, const void* h, const void* src, const void* dst,
                                void* out, int E, int F, int heads, void* stream) {
  if (E == 0 || heads == 0) return 0;
  const int hdim = F / heads;
  if (hdim % 4 == 0 && hdim > 0 && aligned16(g) && aligned16(h))
    return launch_edge_dot<float4>(g, h, src, dst, out, E, F / 4, hdim / 4, heads, stream);
  return launch_edge_dot<float>(g, h, src, dst, out, E, F, hdim, heads, stream);
}
