// S1 spmm and S2 edge_dot: the baseline zoo's message passing, f32 and bf16.
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
//
// The bf16 instances (JAX's compute_dtype="bfloat16", the graph's weights
// f32) are the same kernels on a template argument Bf16<...> in place of
// float or float4: the operands load as bf16 or f32 and the arithmetic is
// f32. An f32 output keeps the f32 instance's arithmetic (S1: bf16 rows, f32
// weights; S2: f32 g, bf16 h). A bf16 output does what XLA does on the CPU:
// each term w * h (S2: each product) is rounded to bf16, then the sum after
// each add, one edge (S2: one element of the head) at a time in order
// (measured bit for bit against jax.ops.segment_sum and its VJP, and against
// XLA's bf16 reduction up to 32 terms); no FMA, since the product is rounded
// before the add. S1 keeps a thread a (row, column) and a row's edges in CSR
// order, so its per-add order is the edge order; S2's bf16 instance gives
// an edge one lane, so a head's sum runs in element order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

struct __align__(8) bf16x4 {
  __nv_bfloat162 lo, hi;
};

// A bf16 instance: V the f32 arithmetic's vector (float or float4), HE the
// element type h loads as, WE that of w (S2: of g and the output), SUM16 a
// bf16 output summed per add.
template <typename V, typename HE, typename WE, bool SUM16>
struct Bf16 {};

// An instance's types: V the arithmetic's vector, H and G the loads of h's
// and g's vectors, W the weights' (S2: the output's) element, O the stores
// of S1's output vectors; the f32 instance (float or float4) loads and
// stores V.
template <typename T>
struct Inst {
  using V = T;
  using H = T;
  using G = T;
  using W = float;
  using O = T;
  static constexpr bool sum16 = false;
};

template <typename V, typename E>
struct Vec {
  using type = V;
};
template <>
struct Vec<float, __nv_bfloat16> {
  using type = __nv_bfloat16;
};
template <>
struct Vec<float4, __nv_bfloat16> {
  using type = bf16x4;
};

template <typename V_, typename HE, typename WE, bool SUM16>
struct Inst<Bf16<V_, HE, WE, SUM16>> {
  using V = V_;
  using H = typename Vec<V_, HE>::type;
  using G = typename Vec<V_, WE>::type;
  using W = WE;
  using O = typename Vec<V_, typename std::conditional<SUM16, __nv_bfloat16, float>::type>::type;
  static constexpr bool sum16 = SUM16;
};

__device__ __forceinline__ float f32(float v) { return v; }
__device__ __forceinline__ float4 f32(float4 v) { return v; }
__device__ __forceinline__ float f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float4 f32(bf16x4 v) {
  const float2 a = __bfloat1622float2(v.lo), b = __bfloat1622float2(v.hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void put(float& o, float v) { o = v; }
__device__ __forceinline__ void put(float4& o, float4 v) { o = v; }
__device__ __forceinline__ void put(__nv_bfloat16& o, float v) { o = __float2bfloat16_rn(v); }
__device__ __forceinline__ void put(bf16x4& o, float4 v) {
  o.lo = __floats2bfloat162_rn(v.x, v.y);
  o.hi = __floats2bfloat162_rn(v.z, v.w);
}

// x rounded to the nearest bf16, ties to even
__device__ __forceinline__ float rn16(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// acc + w * v with the product, then the sum, rounded to bf16
__device__ __forceinline__ void add16(float& acc, float w, float v) {
  acc = rn16(__fadd_rn(acc, rn16(__fmul_rn(w, v))));
}

__device__ __forceinline__ void fma_into(float& acc, float w, float v) { acc = fmaf(w, v, acc); }

__device__ __forceinline__ void fma_into(float4& acc, float w, float4 v) {
  acc.x = fmaf(w, v.x, acc.x);
  acc.y = fmaf(w, v.y, acc.y);
  acc.z = fmaf(w, v.z, acc.z);
  acc.w = fmaf(w, v.w, acc.w);
}

// acc + w * v: the f32 instance's FMA, or each element per add in bf16
template <bool SUM16>
__device__ __forceinline__ void add_term(float& acc, float w, float v) {
  if (SUM16)
    add16(acc, w, v);
  else
    fma_into(acc, w, v);
}

template <bool SUM16>
__device__ __forceinline__ void add_term(float4& acc, float w, float4 v) {
  if (SUM16) {
    add16(acc.x, w, v.x);
    add16(acc.y, w, v.y);
    add16(acc.z, w, v.z);
    add16(acc.w, w, v.w);
  } else {
    fma_into(acc, w, v);
  }
}

__device__ __forceinline__ float dot(float a, float b) { return a * b; }

__device__ __forceinline__ float dot(float4 a, float4 b) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, a.x * b.x)));
}

// acc + <a, b>: the f32 instance's dot, or each product and each add
// rounded to bf16 in element order
template <bool SUM16>
__device__ __forceinline__ void add_dot(float& acc, float a, float b) {
  if (SUM16)
    add16(acc, a, b);
  else
    acc += dot(a, b);
}

template <bool SUM16>
__device__ __forceinline__ void add_dot(float& acc, float4 a, float4 b) {
  if (SUM16) {
    add16(acc, a.x, b.x);
    add16(acc, a.y, b.y);
    add16(acc, a.z, b.z);
    add16(acc, a.w, b.w);
  } else {
    acc += dot(a, b);
  }
}

template <typename V>
__device__ __forceinline__ V zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ float4 zero<float4>() { return make_float4(0.f, 0.f, 0.f, 0.f); }

// width, hdim: in units of V; heads = width / hdim.
template <typename T>
__global__ void __launch_bounds__(256) spmm_kernel(const typename Inst<T>::H* __restrict__ h,
                                                   const typename Inst<T>::W* __restrict__ w,
                                                   const int* __restrict__ ptr,
                                                   const int* __restrict__ perm,
                                                   const int* __restrict__ col,
                                                   typename Inst<T>::O* __restrict__ out, int n,
                                                   int width, int hdim, int heads,
                                                   int lanes_log2) {
  using V = typename Inst<T>::V;
  const int row = blockIdx.x * (256 >> lanes_log2) + (threadIdx.x >> lanes_log2);
  if (row >= n) return;
  const int beg = ptr[row], end = ptr[row + 1];
  for (int c = threadIdx.x & ((1 << lanes_log2) - 1); c < width; c += 1 << lanes_log2) {
    const int k = c / hdim;
    V acc = zero<V>();
    for (int j = beg; j < end; ++j) {
      const float we = w == nullptr ? 1.f : f32(w[(size_t)perm[j] * heads + k]);
      add_term<Inst<T>::sum16>(acc, we, f32(h[(size_t)col[j] * width + c]));
    }
    put(out[(size_t)row * width + c], acc);
  }
}

template <typename T>
__global__ void __launch_bounds__(256) edge_dot_kernel(const typename Inst<T>::G* __restrict__ g,
                                                       const typename Inst<T>::H* __restrict__ h,
                                                       const int* __restrict__ src,
                                                       const int* __restrict__ dst,
                                                       typename Inst<T>::W* __restrict__ out,
                                                       int E, int width, int hdim, int heads,
                                                       int lanes_log2) {
  const int e = blockIdx.x * (256 >> lanes_log2) + (threadIdx.x >> lanes_log2);
  const int lanes = 1 << lanes_log2;
  const int lane = threadIdx.x & (lanes - 1);
  const bool live = e < E;   // every lane of a warp takes part in the shuffles
  const auto* gr = g + (size_t)(live ? dst[e] : 0) * width;
  const auto* hr = h + (size_t)(live ? src[e] : 0) * width;
  for (int k = 0; k < heads; ++k) {
    float acc = 0.f;
    if (live)
      for (int d = lane; d < hdim; d += lanes)
        add_dot<Inst<T>::sum16>(acc, f32(gr[k * hdim + d]), f32(hr[k * hdim + d]));
    for (int off = lanes >> 1; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (live && lane == 0) put(out[(size_t)e * heads + k], acc);
  }
}

static int lanes_log2_for(int width) {
  int l = 0;
  while (l < 5 && (1 << l) < width) ++l;
  return l;
}

static bool aligned(const void* p, size_t bytes) { return ((size_t)p & (bytes - 1)) == 0; }

template <typename T>
static int launch_spmm(const void* h, const void* w, const void* ptr, const void* perm,
                       const void* col, void* out, int n, int width, int hdim, int heads,
                       void* stream) {
  using I = Inst<T>;
  const int l = lanes_log2_for(width);
  const int rows = 256 >> l;
  spmm_kernel<T><<<(n + rows - 1) / rows, 256, 0, (cudaStream_t)stream>>>(
      (const typename I::H*)h, (const typename I::W*)w, (const int*)ptr, (const int*)perm,
      (const int*)col, (typename I::O*)out, n, width, hdim, heads, l);
  return (int)cudaGetLastError();
}

// lanes_log2 = -1: sized from hdim
template <typename T>
static int launch_edge_dot(const void* g, const void* h, const void* src, const void* dst,
                           void* out, int E, int width, int hdim, int heads, void* stream,
                           int lanes_log2 = -1) {
  using I = Inst<T>;
  const int l = lanes_log2 < 0 ? lanes_log2_for(hdim) : lanes_log2;
  const int edges = 256 >> l;
  edge_dot_kernel<T><<<(E + edges - 1) / edges, 256, 0, (cudaStream_t)stream>>>(
      (const typename I::G*)g, (const typename I::H*)h, (const int*)src, (const int*)dst,
      (typename I::W*)out, E, width, hdim, heads, l);
  return (int)cudaGetLastError();
}

// The S1 instance of types (bit 0: h bf16, bit 1: w bf16, bit 2: out bf16),
// on vectors of V.
template <typename V>
static int spmm_types(const void* h, const void* w, const void* ptr, const void* perm,
                      const void* col, void* out, int n, int width, int hdim, int heads,
                      int types, void* stream) {
  using B = __nv_bfloat16;
  switch (types) {
    case 0:
      return launch_spmm<V>(h, w, ptr, perm, col, out, n, width, hdim, heads, stream);
    case 1:   // bf16 rows, f32 weights, f32 sum (JAX's promotion)
      return launch_spmm<Bf16<V, B, float, false>>(h, w, ptr, perm, col, out, n, width, hdim,
                                                   heads, stream);
    case 5:   // bf16 rows and no weight (a gather's VJP), per add
    case 7:   // all bf16, per add
      return launch_spmm<Bf16<V, B, B, true>>(h, w, ptr, perm, col, out, n, width, hdim, heads,
                                              stream);
    case 4:   // f32 rows and weights, bf16 terms and sum: spmm's VJP on a bf16 h
      return launch_spmm<Bf16<V, float, float, true>>(h, w, ptr, perm, col, out, n, width, hdim,
                                                      heads, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// h [*, F] f32 or bf16 (F = heads * hdim), w [E, heads] f32 or bf16 or null,
// ptr int32 [n + 1], perm and col int32 [ptr[n]], out [n, F] f32 or bf16, as
// types says (spmm_types).
extern "C" int pathnet_spmm(const void* h, const void* w, const void* ptr, const void* perm,
                            const void* col, void* out, int n, int F, int heads, int types,
                            void* stream) {
  if (n == 0 || F == 0) return 0;
  const int hdim = F / heads;
  const size_t hb = (types & 1) ? 8 : 16, ob = (types & 4) ? 8 : 16;   // a vector's bytes
  if (hdim % 4 == 0 && aligned(h, hb) && aligned(out, ob))
    return spmm_types<float4>(h, w, ptr, perm, col, out, n, F / 4, hdim / 4, heads, types,
                              stream);
  return spmm_types<float>(h, w, ptr, perm, col, out, n, F, hdim, heads, types, stream);
}

// The S2 instance of types (bit 0: h bf16, bit 1: g bf16 and out bf16).
template <typename V>
static int edge_dot_types(const void* g, const void* h, const void* src, const void* dst,
                          void* out, int E, int width, int hdim, int heads, int types,
                          void* stream) {
  using B = __nv_bfloat16;
  switch (types) {
    case 0:
      return launch_edge_dot<V>(g, h, src, dst, out, E, width, hdim, heads, stream);
    case 1:   // f32 g, bf16 h, f32 dot (JAX's promotion)
      return launch_edge_dot<Bf16<V, B, float, false>>(g, h, src, dst, out, E, width, hdim,
                                                       heads, stream);
    case 3:   // all bf16, per add in element order: one lane an edge
      return launch_edge_dot<Bf16<V, B, B, true>>(g, h, src, dst, out, E, width, hdim, heads,
                                                  stream, 0);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// g, h [*, F] f32 or bf16, src, dst int32 [E], out [E, heads] f32 or bf16,
// as types says (edge_dot_types).
extern "C" int pathnet_edge_dot(const void* g, const void* h, const void* src, const void* dst,
                                void* out, int E, int F, int heads, int types, void* stream) {
  if (E == 0 || heads == 0) return 0;
  const int hdim = F / heads;
  const size_t gb = (types & 2) ? 8 : 16, hb = (types & 1) ? 8 : 16;
  if (hdim % 4 == 0 && hdim > 0 && aligned(g, gb) && aligned(h, hb))
    return edge_dot_types<float4>(g, h, src, dst, out, E, F / 4, hdim / 4, heads, types, stream);
  return edge_dot_types<float>(g, h, src, dst, out, E, F, hdim, heads, types, stream);
}
