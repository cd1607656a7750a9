// Segment sum: out[v] = the rows of node v added in a fixed order.
//
// Replaces the scatter-add that JAX's gather VJP makes of every gathered
// row's gradient (pathnet_tpu/models/pagg.py:83-93, XLA's scatter): K4's
// launches store one gradient row per (walk, position) and per ego row, and
// this launch sums them into dh [n, H]. The wrapper sorts the rows' node ids
// once (a stable sort, so the order depends only on the paths) and gives
// `order`, the rows in that order, and `offsets`, where each node's run
// starts. Two launches. The first cuts each node's run into pieces of P
// rows (P = 256) and gives each piece a warp, which adds the piece's rows
// one after another from 0, each lane over its own columns (two or four
// floats a load, eight rows' loads in flight), into its row of `partial`.
// The second gives each node a warp, which adds the node's pieces one after
// another from 0 into out. Every boundary and every order depends only on
// the index, so the result is the same on every run; it is the plain
// version's sequential sum up to rounding where a run is longer than P. A
// node no row names gets zeros: dh needs no zeroing before. The pieces keep
// a long run from holding one warp for all of it: the padded chunk of a
// microbatch sends ~0.16 M rows (its padding targets' walks and ego rows) to
// node 0, and one warp for that run made the launch 7.4 ms a call over a bgp
// epoch where it takes 0.3 ms on a microbatch without padding (PERF.md, section 6).
//
// Bound on the H100: bytes, each row read once (1.31 M + 0.33 M rows of
// 256 B at the bgp microbatch, ~0.42 GB, ~0.13 ms at 3.35 TB/s) plus the
// order and dh.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
};
template <>
struct Vec<2> {
  using T = float2;
};
template <>
struct Vec<4> {
  using T = float4;
};

__device__ __forceinline__ void add_to(float* a, float v) { a[0] += v; }
__device__ __forceinline__ void add_to(float* a, float2 v) {
  a[0] += v.x;
  a[1] += v.y;
}
__device__ __forceinline__ void add_to(float* a, float4 v) {
  a[0] += v.x;
  a[1] += v.y;
  a[2] += v.z;
  a[3] += v.w;
}

template <int VEC>
__device__ __forceinline__ void add_rows(float (&acc)[VEC], const float* __restrict__ src,
                                         const long long* __restrict__ order, long long lo,
                                         long long hi, int H, int c) {
  using V = typename Vec<VEC>::T;
  long long k = lo;
  for (; k + 8 <= hi; k += 8) {  // eight rows' loads in flight, added in order
    V x[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const long long r = order ? order[k + q] : k + q;
      x[q] = *reinterpret_cast<const V*>(src + r * H + c);
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) add_to(acc, x[q]);
  }
  for (; k < hi; ++k) {
    const long long r = order ? order[k] : k;
    add_to(acc, *reinterpret_cast<const V*>(src + r * H + c));
  }
}

// Launch 1: piece p of node v = piece_node[p] is rows order[offsets[v] +
// (p - piece_off[v]) * P ...] of v's run, at most P of them.
template <int VEC>
__global__ void segment_pieces_kernel(const float* __restrict__ rows,
                                      const long long* __restrict__ order,
                                      const int* __restrict__ offsets,
                                      const int* __restrict__ piece_off,
                                      const int* __restrict__ piece_node,
                                      float* __restrict__ partial, int n, int npieces, int H,
                                      int P) {
  const long long p = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (p >= npieces) return;
  const int v = piece_node[p];
  if (v < 0 || v >= n) return;  // past the last piece
  const long long lo = offsets[v] + (p - piece_off[v]) * (long long)P;
  const long long end = offsets[v + 1];
  const long long hi = lo + P < end ? lo + P : end;
  for (int c = lane * VEC; c < H; c += 32 * VEC) {
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
    add_rows<VEC>(acc, rows, order, lo, hi, H, c);
#pragma unroll
    for (int e = 0; e < VEC; ++e) partial[p * H + c + e] = acc[e];
  }
}

// Launch 2: out[v] = v's pieces added in order, zeros where it has none.
template <int VEC>
__global__ void segment_total_kernel(const float* __restrict__ partial,
                                     const int* __restrict__ piece_off,
                                     float* __restrict__ out, int n, int H) {
  const long long v = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (v >= n) return;
  for (int c = lane * VEC; c < H; c += 32 * VEC) {
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
    add_rows<VEC>(acc, partial, nullptr, piece_off[v], piece_off[v + 1], H, c);
#pragma unroll
    for (int e = 0; e < VEC; ++e) out[v * H + c + e] = acc[e];
  }
}

template <int VEC>
int launch(const float* rows, const long long* order, const int* offsets, const int* piece_off,
           const int* piece_node, float* partial, float* out, int n, int npieces, int H, int P,
           cudaStream_t st) {
  const int threads = 256;
  const unsigned b1 = (unsigned)(((long long)npieces * 32 + threads - 1) / threads);
  segment_pieces_kernel<VEC><<<b1, threads, 0, st>>>(rows, order, offsets, piece_off,
                                                     piece_node, partial, n, npieces, H, P);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  const unsigned b2 = (unsigned)(((long long)n * 32 + threads - 1) / threads);
  segment_total_kernel<VEC><<<b2, threads, 0, st>>>(partial, piece_off, out, n, H);
  return (int)cudaGetLastError();
}

}  // namespace

// rows [R, H] f32; order int64 [R] (row ids sorted by node, stably);
// offsets int32 [n + 1] (node v's rows are order[offsets[v] : offsets[v+1]]);
// piece_off int32 [n + 1] (v's pieces of at most P rows are
// piece_off[v] : piece_off[v + 1]); piece_node int32 [npieces] (each
// piece's node, n or more past the last piece); partial [npieces, H] f32
// scratch; out [n, H] f32, every entry written.
extern "C" int pathnet_segment_sum(const void* rows, const void* order, const void* offsets,
                                   const void* piece_off, const void* piece_node,
                                   void* partial, void* out, int n, int npieces, int H, int P,
                                   void* stream) {
  if (n == 0 || H == 0) return 0;
  const uintptr_t a = (uintptr_t)rows | (uintptr_t)partial | (uintptr_t)out;
  const float* r = (const float*)rows;
  const long long* o = (const long long*)order;
  const int *of = (const int*)offsets, *po = (const int*)piece_off, *pn = (const int*)piece_node;
  float *pa = (float*)partial, *ou = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (H % 4 == 0 && H >= 128 && a % 16 == 0)
    return launch<4>(r, o, of, po, pn, pa, ou, n, npieces, H, P, st);
  if (H % 2 == 0 && a % 8 == 0) return launch<2>(r, o, of, po, pn, pa, ou, n, npieces, H, P, st);
  return launch<1>(r, o, of, po, pn, pa, ou, n, npieces, H, P, st);
}
