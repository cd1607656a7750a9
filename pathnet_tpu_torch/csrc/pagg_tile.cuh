// The walk tile shared by K3 (pagg_encode.cu) and K4 (pagg_encode_bwd.cu):
// the tile's shape from H (tile_for), the cp.async staging of weight rows
// through shared memory, the register-tiled f32 product tile_gemm<NG>, and
// the encode over walk tiles, pagg_encode_walks_kernel. K3 serves with
// STREAMS = false; K4's forward recompute runs the same kernel with
// STREAMS = true, which also writes the per-step values K4's BPTT reads.
// HOMO = true is the homo variant: steps in sampled order, a ReLU on the
// selected row, and that row of step 0 (before dropout) stored as the
// walk's ego row. BF16 = true takes the gather table and the cast weights
// (wd, bd, w_ih, w_hh, b_ih, b_hh) as bf16, W below: the weight chunks are
// staged as bf16 and widened in the product's B load, every product and
// the cell stay f32 FMAs, and the values are rounded to bf16 where the JAX
// package's bf16 encode holds them in bf16 (pathnet_tpu/models/pagg.py:
// 233-279): the selected row round(round(x W[d]) + b[d]), the dropped-out
// input round(s / keep) (keep given rounded to bf16), and c_t and h_t at the
// end of each step. GRU = true runs the GRU (gates r, z, n) on weights
// packed into the LSTM's layout (see pagg_encode.cu): the same product, and
// an epilogue that reads h_{t-1} from the h half of A. The
// design and its bound are described in pagg_encode.cu.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

// The GRU's encode instances, each built in a translation unit of its own
// so that nvcc compiles them beside the others: K3's (pagg_encode_gru.cu)
// and K4's forward recompute (STREAMS, pagg_encode_bwd_gru.cu). The
// arguments are launch_encode's, the streams as their five pointers.
int pagg_encode_gru(const void* h, const void* paths, const void* dists, const void* wd,
                    const void* bd, const void* w_ih, const void* w_hh, const void* b_ih,
                    const void* b_hh, const void* mask, float keep, void* hn, void* ego,
                    long long B, int wl, int H, void* stream);
int pagg_encode_gru_streams(const void* h, const void* paths, const void* dists,
                            const void* wd, const void* bd, const void* w_ih,
                            const void* w_hh, const void* b_ih, const void* b_hh,
                            const void* mask, float keep, void* hn, void* ego, float* xr,
                            float* xin, float* hp, float* cs, float* gt, long long B,
                            int wl, int H, void* stream);

namespace {

constexpr int TM = 8;        // walks per thread
constexpr int TN = 2;        // hidden units per thread, four gates each
constexpr int NT_MAX = 512;  // threads per block at most
static_assert(TN == 2, "tile_gemm unpacks B in pairs of units");

struct Tile {
  int M, CT, NT, KC, LDA, smem;
};

// The readouts (K3's second launch, K4's attention backward, template
// parameter AGG); the values are the wrappers' codes.
enum { ATTENTION = 0, MEAN = 1, SUM = 2 };

// Whether the mean and sum branches move rows of width H four floats at a
// time: H a multiple of 4 and every pointer (any, or-ed) 16-byte aligned.
__host__ __device__ inline bool agg_vec4(int H, uintptr_t any) {
  return H % 4 == 0 && any % 16 == 0;
}

// The mean and sum readout's walk groups: a block of `threads` splits the
// row's loads (H / 4 float4s, or H floats) among itself and the walks
// among the groups, one where a row has more loads than the block threads.
__host__ __device__ inline int agg_groups(int H, int threads, bool vec4) {
  const int loads = vec4 ? H / 4 : H;
  return loads < threads ? threads / loads : 1;
}

// The element of the table and the cast weights: f32, or bf16 (BF16).
template <bool BF16>
using Elem = std::conditional_t<BF16, __nv_bfloat16, float>;

__host__ __device__ constexpr Tile tile_for(int H, bool bf16 = false) {
  const int CT = (H + TN - 1) / TN;
  const int nt = H >= 128 ? NT_MAX : 256;
  const int rt = nt / CT < 1 ? 1 : (nt / CT > 32 ? 32 : nt / CT);
  const int kc = 2048 / H;  // a weight chunk of at most 32 KB
  const int KC = kc < 1 ? 1 : (kc > 32 ? 32 : kc);
  const int M = TM * rt;
  const int LDA = M + 4;    // rows of A padded against bank conflicts on stores
  // A in f32, two weight chunks in the weights' type
  return Tile{M, CT, rt * CT, KC, LDA,
              (int)(2 * H * LDA * sizeof(float) + 2 * KC * 4 * H * (bf16 ? 2 : 4))};
}

// The widths compiled with H, and so the whole tile, as constants; any
// other width runs the instance with HC = 0, which reads them at run time.
// Two blocks a SM at H = 64 cap a thread at 128 registers (a few spill); one
// block of 256 threads without the cap, 8 warps a SM, ran slower on the H100.
constexpr int launch_threads(int HC) { return HC ? tile_for(HC).NT : NT_MAX; }
constexpr int launch_blocks(int HC) { return HC == 64 ? 2 : 1; }

// The fast exponential and division: a few 1e-6 relative from the accurate
// ones over the gates' range, and without their slow-path calls, which
// stalled the epilogue.
__device__ __forceinline__ float sigm(float x) { return __fdividef(1.0f, 1.0f + __expf(-x)); }
__device__ __forceinline__ float tanh_f(float x) { return 2.0f * sigm(2.0f * x) - 1.0f; }

__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p) { return __bfloat162float(*p); }
// x rounded to the nearest bf16, as an f32
__device__ __forceinline__ float rnd(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// How a weight chunk is staged: COPY16 16-byte cp.async copies, COPY4 4-byte
// ones, PLAIN ordinary loads and stores (bf16 rows at odd offsets, whose
// pairs are not 4-byte aligned). The widest mode that every row of width
// NB and every base (aligned to `align` bytes) allow.
enum { PLAIN = 0, COPY4 = 1, COPY16 = 2 };

template <typename W>
__host__ __device__ constexpr int copy_mode(int NB, int align) {
  return align % 16 == 0 && NB % (int)(16 / sizeof(W)) == 0 ? COPY16
         : align % 4 == 0 && NB % (int)(4 / sizeof(W)) == 0 ? COPY4
                                                             : PLAIN;
}

// The largest of 16, 4, 2 and 1 that divides every address.
__host__ __device__ constexpr int alignment(uintptr_t any) {
  return any % 16 == 0 ? 16 : any % 4 == 0 ? 4 : any % 2 == 0 ? 2 : 1;
}

// Rows ch*KC .. of B (NB elements each; row k from B0 + k*NB below K0, else
// from B1) into dst, as they lie, in copies of STEP elements (0: one
// element a plain load).
template <typename W, int STEP>
__device__ __forceinline__ void stage_rows(W* dst, int ch, int KC, int K,
                                           const W* __restrict__ B0, int K0,
                                           const W* __restrict__ B1, int NB, int NT) {
  const int k0 = ch * KC;
  const int rows = K - k0 < KC ? K - k0 : KC;
  constexpr int step = STEP ? STEP : 1;
  const int per_row = NB / step;
  for (int f = threadIdx.x; f < rows * per_row; f += NT) {
    const int kk = f / per_row, col = f % per_row * step;
    const int k = k0 + kk;
    const W* src = (k < K0 ? B0 + (size_t)k * NB : B1 + (size_t)(k - K0) * NB) + col;
    if constexpr (STEP * sizeof(W) == 16)
      cp_async16(dst + kk * NB + col, src);
    else if constexpr (STEP * sizeof(W) == 4)
      cp_async4(dst + kk * NB + col, src);
    else
      dst[kk * NB + col] = *src;
  }
}

// One chunk in the given copy mode; one cp.async group. f32 rows always
// take cp.async (a float is 4-byte aligned), so PLAIN is compiled for bf16
// only.
template <typename W>
__device__ __forceinline__ void stage_chunk(W* dst, int ch, int KC, int K,
                                            const W* __restrict__ B0, int K0,
                                            const W* __restrict__ B1, int NB, int NT,
                                            int mode) {
  constexpr int e16 = 16 / sizeof(W), e4 = 4 / sizeof(W);
  if (mode == COPY16)
    stage_rows<W, e16>(dst, ch, KC, K, B0, K0, B1, NB, NT);
  else if (sizeof(W) == 4 || mode == COPY4)
    stage_rows<W, e4>(dst, ch, KC, K, B0, K0, B1, NB, NT);
  else
    stage_rows<W, 0>(dst, ch, KC, K, B0, K0, B1, NB, NT);
  cp_async_commit();
}

// acc[i][u][g] += sum_k A[k][m0 + i] * B[k][g * H + 2c + u] over k < K, with
// B's rows (f32 or bf16, W) staged through Bs in double-buffered chunks of KC
// rows in copy mode `mode`. Every thread of the block calls it; it ends with
// a barrier, so A may be rewritten right after.
template <int NG, typename W>
__device__ __forceinline__ void tile_gemm(float (&acc)[TM][TN][NG],
                                          const float* As, int LDA, int m0, int K,
                                          const W* __restrict__ B0, int K0,
                                          const W* __restrict__ B1, W* Bs,
                                          int KC, const int (&jc)[TN], int H, int NT,
                                          int mode) {
  const int NB = NG * H;
  const int nch = (K + KC - 1) / KC;
  stage_chunk(Bs, 0, KC, K, B0, K0, B1, NB, NT, mode);
  for (int ch = 0; ch < nch; ++ch) {
    const W* cur = Bs + (ch & 1) * KC * NB;
    if (ch + 1 < nch) {
      stage_chunk(Bs + ((ch + 1) & 1) * KC * NB, ch + 1, KC, K, B0, K0, B1, NB, NT, mode);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = ch * KC;
    // a whole chunk where KC divides K: a constant trip count at H = 64, 256
    const int kn = K % KC == 0 || K - k0 >= KC ? KC : K - k0;
#pragma unroll 2
    for (int kk = 0; kk < kn; ++kk) {
      const float* a = As + (k0 + kk) * LDA + m0;
      float av[TM];
#pragma unroll
      for (int i = 0; i < TM; i += 4) {
        const float4 q = *reinterpret_cast<const float4*>(a + i);
        av[i] = q.x;
        av[i + 1] = q.y;
        av[i + 2] = q.z;
        av[i + 3] = q.w;
      }
      const W* bb = cur + kk * NB;
      float bv[NG][TN];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        if (H % 2 == 0) {  // units 2c, 2c + 1 side by side, a pair aligned
          float2 v;
          if constexpr (sizeof(W) == 4)
            v = *reinterpret_cast<const float2*>(bb + g * H + jc[0]);
          else
            v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bb + g * H + jc[0]));
          bv[g][0] = v.x;
          bv[g][1] = v.y;
        } else {
          bv[g][0] = ldf(bb + g * H + jc[0]);
          bv[g][1] = ldf(bb + g * H + jc[1]);
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int u = 0; u < TN; ++u)
#pragma unroll
          for (int g = 0; g < NG; ++g) acc[i][u][g] = fmaf(av[i], bv[g][u], acc[i][u][g]);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void store_rows(float* dst, const float (&v)[TM]) {
#pragma unroll
  for (int i = 0; i < TM; i += 4)
    *reinterpret_cast<float4*>(dst + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Thread (r, c) of the tile: a warp covers 4 row groups x 8 columns where
// the tile allows it, so its loads of A and B each touch few distinct words.
// Slot u of column c holds unit 2c + u, clamped to H - 1 in jc for loads;
// jv says whether the slot holds a unit.
__device__ __forceinline__ void tile_thread(int CT, int M, int H, int& r, int& c,
                                            int (&jc)[TN], bool (&jv)[TN]) {
  if (CT % 8 == 0 && (M / TM) % 4 == 0) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    c = (w % (CT / 8)) * 8 + (lane & 7);
    r = (w / (CT / 8)) * 4 + (lane >> 3);
  } else {
    c = threadIdx.x % CT;
    r = threadIdx.x / CT;
  }
#pragma unroll
  for (int u = 0; u < TN; ++u) {
    const int j = TN * c + u;
    jv[u] = j < H;
    jc[u] = jv[u] ? j : H - 1;
  }
}

// a and b, units 2c and 2c + 1, to row r of a row-major stream of width W
// at column off + 2c: one 8-byte store where H is even (both units held),
// else one store per unit held.
__device__ __forceinline__ void store_units(float* __restrict__ s, long long r, int W,
                                            int off, int H, const int (&jc)[TN],
                                            const bool (&jv)[TN], float a, float b) {
  float* p = s + r * W + off;
  if (H % 2 == 0) {
    *reinterpret_cast<float2*>(p + jc[0]) = make_float2(a, b);
  } else {
    if (jv[0]) p[jc[0]] = a;
    if (jv[1]) p[jc[1]] = b;
  }
}

// v[u][i] to rows r0 + i of a stream [.., H], for the first `left` rows
// (the walks of the launch).
__device__ __forceinline__ void store_pairs(float* __restrict__ s, long long r0,
                                            long long left, int H, const int (&jc)[TN],
                                            const bool (&jv)[TN], const float (&v)[TN][TM]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
    if (i < left) store_units(s, r0 + i, H, 0, H, jc, jv, v[0][i], v[1][i]);
}

// K4's per-step streams, rows t * B + b: the gathered row xr, the LSTM input
// xin after dropout, h_{t-1} as hp, c_t as cs ([.., H] each) and the gate
// activations (sigmoid i, sigmoid f, tanh g, sigmoid o) as gt [.., 4H]. All
// f32; under BF16 they hold the forward's rounded values, which f32 holds
// exactly (the gate activations are not rounded). The GRU writes no cs, and
// gt as (r, z, n, h_{t-1} W_hn + b_hn).
struct Streams {
  float* xr;
  float* xin;
  float* hp;
  float* cs;
  float* gt;
};

// Walk b's ego row: h[paths[b, 0]] (hetero, the table's type W), the ego
// scratch's row b (homo, f32). Read its entries with ldf.
template <bool HOMO, typename W>
__device__ __forceinline__ const std::conditional_t<HOMO, float, W>* ego_row(
    const W* __restrict__ h, const int* __restrict__ paths, const float* __restrict__ ego,
    long long b, int wl, int H) {
  if constexpr (HOMO)
    return ego + b * H;
  else
    return h + (long long)paths[b * wl] * H;
}

// Units jc[0], jc[1] of table row v (0 where v < 0) as f32; a bf16 row in
// one 4-byte load where `pair` says that each pair is aligned.
__device__ __forceinline__ void gather_units(const float* __restrict__ h, long long v, int H,
                                             const int (&jc)[TN], bool, float& a, float& b) {
  a = v >= 0 ? h[v * H + jc[0]] : 0.0f;
  b = v >= 0 ? h[v * H + jc[1]] : 0.0f;
}

__device__ __forceinline__ void gather_units(const __nv_bfloat16* __restrict__ h, long long v,
                                             int H, const int (&jc)[TN], bool pair, float& a,
                                             float& b) {
  if (v < 0) {
    a = b = 0.0f;
  } else if (pair) {
    const float2 p =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(h + v * H + jc[0]));
    a = p.x;
    b = p.y;
  } else {
    a = __bfloat162float(h[v * H + jc[0]]);
    b = __bfloat162float(h[v * H + jc[1]]);
  }
}

// The encode of every walk to h_n [B, H]; with STREAMS, also the per-step
// values of Streams (K4's forward recompute); with HOMO, also each walk's
// ego row, the ReLU'd selected row of step 0 before dropout, to ego [B, H];
// with BF16, from a bf16 table and bf16 weights, rounded as described at the
// top; with GRU, the GRU on packed weights. `align` is the alignment of wd,
// w_ih and w_hh in bytes.
template <bool MASKED, int HC, bool STREAMS, bool HOMO, bool BF16, bool GRU = false>
__global__ void __launch_bounds__(launch_threads(HC), launch_blocks(HC))
pagg_encode_walks_kernel(
    const Elem<BF16>* __restrict__ h, const int* __restrict__ paths,
    const int* __restrict__ dists, const Elem<BF16>* __restrict__ wd,
    const Elem<BF16>* __restrict__ bd, const Elem<BF16>* __restrict__ w_ih,
    const Elem<BF16>* __restrict__ w_hh, const Elem<BF16>* __restrict__ b_ih,
    const Elem<BF16>* __restrict__ b_hh, const uint8_t* __restrict__ mask, float keep,
    float* __restrict__ hn, float* __restrict__ ego, Streams st, long long B, int wl,
    int Hrt, int align) {
  using W = Elem<BF16>;
  constexpr Tile tc = tile_for(HC ? HC : 64);
  const Tile tr = tile_for(Hrt);
  const int H = HC ? HC : Hrt;
  const int CT = HC ? tc.CT : tr.CT;
  const int KC = HC ? tc.KC : tr.KC;
  const int LDA = HC ? tc.LDA : tr.LDA;
  const int M = HC ? tc.M : tr.M;
  const int NT = HC ? tc.NT : tr.NT;
  const int mode4 = copy_mode<W>(4 * H, align), mode1 = copy_mode<W>(H, align);
  // bf16 table rows read in pairs where every pair is 4-byte aligned
  const bool hpair = BF16 && H % 2 == 0 && (uintptr_t)h % 4 == 0;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                                  // [2H][LDA]: x_t then s_t, then h_{t-1}
  W* Bs = reinterpret_cast<W*>(As + 2 * H * LDA);    // [2][KC][4H] weight chunks
  int r, c, jc[TN];
  bool jv[TN];
  tile_thread(CT, M, H, r, c, jc, jv);
  const int m0 = r * TM;
  const long long b0 = (long long)blockIdx.x * M + m0;
  for (int e = threadIdx.x; e < H * LDA; e += NT) As[H * LDA + e] = 0.0f;
  float cs[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int u = 0; u < TN; ++u) cs[i][u] = 0.0f;

  for (int t = 0; t < wl; ++t) {
    const int pos = HOMO ? t : wl - 1 - t;  // hetero: far to near
    // gather x_t into the s half of A; each row's distance class to dq
    int dq[TM];
    float xv[TN][TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const long long b = b0 + i;
      int d = 0;
      long long v = -1;
      if (b < B) {
        v = paths[b * wl + pos];
        d = dists[b * wl + pos];
        d = d < 0 ? 0 : (d > wl - 1 ? wl - 1 : d);
      }
      dq[i] = d;
      gather_units(h, v, H, jc, hpair, xv[0][i], xv[1][i]);
    }
#pragma unroll
    for (int u = 0; u < TN; ++u)
      if (jv[u]) store_rows(As + jc[u] * LDA + m0, xv[u]);
    const long long r0 = (long long)t * B + b0;  // stream row of walk b0
    if constexpr (STREAMS) {
      const float zero[TN][TM] = {};
      store_pairs(st.xr, r0, B - b0, H, jc, jv, xv);
      if (t == 0) store_pairs(st.hp, r0, B - b0, H, jc, jv, zero);
    }

    // s_t = x_t @ W[d] + b[d]: one GEMM per class present in the tile
    float sv[TN][TM];
#pragma unroll
    for (int u = 0; u < TN; ++u)
#pragma unroll
      for (int i = 0; i < TM; ++i) sv[u][i] = 0.0f;
    for (int k = 0; k < wl; ++k) {
      bool mine = false;
#pragma unroll
      for (int i = 0; i < TM; ++i) mine |= dq[i] == k;
      if (!__syncthreads_or(mine)) continue;
      float acc[TM][TN][1];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int u = 0; u < TN; ++u) acc[i][u][0] = 0.0f;
      const W* wk = wd + (size_t)k * H * H;
      tile_gemm<1>(acc, As, LDA, m0, H, wk, H, wk, Bs, KC, jc, H, NT, mode1);
#pragma unroll
      for (int u = 0; u < TN; ++u) {
        const float bk = ldf(bd + (size_t)k * H + jc[u]);
#pragma unroll
        for (int i = 0; i < TM; ++i)
          if (dq[i] == k) sv[u][i] = BF16 ? rnd(rnd(acc[i][u][0]) + bk) : acc[i][u][0] + bk;
      }
    }
    if constexpr (HOMO) {
#pragma unroll
      for (int u = 0; u < TN; ++u)
#pragma unroll
        for (int i = 0; i < TM; ++i) sv[u][i] = fmaxf(sv[u][i], 0.0f);
      if (t == 0) store_pairs(ego, b0, B - b0, H, jc, jv, sv);
    }
    // dropout as s_t is written over x_t (the last GEMM ended with a barrier)
#pragma unroll
    for (int u = 0; u < TN; ++u) {
      if (!jv[u]) continue;
      if (MASKED) {
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const long long b = b0 + i;
          if (b < B) {
            const float q = sv[u][i] / keep;
            sv[u][i] = mask[((long long)t * B + b) * H + jc[u]] ? (BF16 ? rnd(q) : q) : 0.0f;
          }
        }
      }
      store_rows(As + jc[u] * LDA + m0, sv[u]);
    }
    if constexpr (STREAMS) store_pairs(st.xin, r0, B - b0, H, jc, jv, sv);
    __syncthreads();

    // gates = [s_t | h_{t-1}] @ [w_ih; w_hh] + b_ih + b_hh
    float acc[TM][TN][4];
#pragma unroll
    for (int u = 0; u < TN; ++u)
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float bias = ldf(b_ih + g * H + jc[u]) + ldf(b_hh + g * H + jc[u]);
#pragma unroll
        for (int i = 0; i < TM; ++i) acc[i][u][g] = bias;
      }
    tile_gemm<4>(acc, As, LDA, m0, 2 * H, w_ih, H, w_hh, Bs, KC, jc, H, NT, mode4);

    // cell update in registers; h_t back to A, or out as h_n after the last
    // step; BF16 rounds c_t, then h_t from the rounded c_t
    if constexpr (GRU) {
      // acc holds r and z before their sigmoids, x W_in + b_in and
      // h W_hn + b_hn; h_{t-1} is this thread's own entries of A's h half,
      // which no other thread writes, read before any is written over
      float hv[TN][TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        float gv[4][TN];
#pragma unroll
        for (int u = 0; u < TN; ++u) {
          const float hq = As[(H + jc[u]) * LDA + m0 + i];
          gv[0][u] = sigm(acc[i][u][0]);
          gv[1][u] = sigm(acc[i][u][1]);
          gv[3][u] = acc[i][u][3];
          gv[2][u] = tanh_f(acc[i][u][2] + gv[0][u] * gv[3][u]);
          hv[u][i] = (1.0f - gv[1][u]) * gv[2][u] + gv[1][u] * hq;
        }
        if constexpr (STREAMS) {
          if (i < B - b0) {
#pragma unroll
            for (int g = 0; g < 4; ++g)
              store_units(st.gt, r0 + i, 4 * H, g * H, H, jc, jv, gv[g][0], gv[g][1]);
            if (t + 1 < wl) store_units(st.hp, r0 + B + i, H, 0, H, jc, jv, hv[0][i], hv[1][i]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < TN; ++u) {
        if (!jv[u]) continue;
        if (t + 1 < wl) {
          store_rows(As + (H + jc[u]) * LDA + m0, hv[u]);
        } else {
#pragma unroll
          for (int i = 0; i < TM; ++i)
            if (b0 + i < B) hn[(b0 + i) * H + jc[u]] = hv[u][i];
        }
      }
    } else if constexpr (STREAMS) {
      // the same update row by row, so both units of a row are stored at once
      float hv[TN][TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        float gv[4][TN];
#pragma unroll
        for (int u = 0; u < TN; ++u) {
          gv[0][u] = sigm(acc[i][u][0]);
          gv[1][u] = sigm(acc[i][u][1]);
          gv[2][u] = tanh_f(acc[i][u][2]);
          gv[3][u] = sigm(acc[i][u][3]);
          cs[i][u] = gv[1][u] * cs[i][u] + gv[0][u] * gv[2][u];
          if constexpr (BF16) cs[i][u] = rnd(cs[i][u]);
          hv[u][i] = gv[3][u] * tanh_f(cs[i][u]);
          if constexpr (BF16) hv[u][i] = rnd(hv[u][i]);
        }
        if (i < B - b0) {
#pragma unroll
          for (int g = 0; g < 4; ++g)
            store_units(st.gt, r0 + i, 4 * H, g * H, H, jc, jv, gv[g][0], gv[g][1]);
          store_units(st.cs, r0 + i, H, 0, H, jc, jv, cs[i][0], cs[i][1]);
          if (t + 1 < wl) store_units(st.hp, r0 + B + i, H, 0, H, jc, jv, hv[0][i], hv[1][i]);
        }
      }
#pragma unroll
      for (int u = 0; u < TN; ++u) {
        if (!jv[u]) continue;
        if (t + 1 < wl) {
          store_rows(As + (H + jc[u]) * LDA + m0, hv[u]);
        } else {
#pragma unroll
          for (int i = 0; i < TM; ++i)
            if (b0 + i < B) hn[(b0 + i) * H + jc[u]] = hv[u][i];
        }
      }
    } else {
#pragma unroll
      for (int u = 0; u < TN; ++u) {
        float hv[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float si = sigm(acc[i][u][0]), sf = sigm(acc[i][u][1]);
          const float tg = tanh_f(acc[i][u][2]), so = sigm(acc[i][u][3]);
          cs[i][u] = sf * cs[i][u] + si * tg;
          if constexpr (BF16) cs[i][u] = rnd(cs[i][u]);
          hv[i] = so * tanh_f(cs[i][u]);
          if constexpr (BF16) hv[i] = rnd(hv[i]);
        }
        if (!jv[u]) continue;
        if (t + 1 < wl) {
          store_rows(As + (H + jc[u]) * LDA + m0, hv);
        } else {
#pragma unroll
          for (int i = 0; i < TM; ++i)
            if (b0 + i < B) hn[(b0 + i) * H + jc[u]] = hv[i];
        }
      }
    }
  }
}

template <bool BF16>
using EncodeKernel = void (*)(const Elem<BF16>*, const int*, const int*, const Elem<BF16>*,
                              const Elem<BF16>*, const Elem<BF16>*, const Elem<BF16>*,
                              const Elem<BF16>*, const Elem<BF16>*, const uint8_t*, float,
                              float*, float*, Streams, long long, int, int, int);

template <bool STREAMS, int HC, bool BF16, bool GRU = false>
EncodeKernel<BF16> encode_instance(bool masked, bool homo) {
  return masked ? (homo ? pagg_encode_walks_kernel<true, HC, STREAMS, true, BF16, GRU>
                        : pagg_encode_walks_kernel<true, HC, STREAMS, false, BF16, GRU>)
                : (homo ? pagg_encode_walks_kernel<false, HC, STREAMS, true, BF16, GRU>
                        : pagg_encode_walks_kernel<false, HC, STREAMS, false, BF16, GRU>);
}

template <typename Kernel>
int allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   bytes);
}

// The encode on K3's grid of tiles at width H: f32, the instance with the
// tile compiled in where there is one (H = 64, 256); bf16 and the GRU (f32
// only), the H = 64 instance or the run-time one. Masked where mask is
// given, homo where ego is given.
template <bool STREAMS, bool BF16, bool GRU>
int launch_encode_as(const void* h, const void* paths, const void* dists, const void* wd,
                     const void* bd, const void* w_ih, const void* w_hh, const void* b_ih,
                     const void* b_hh, const void* mask, float keep, void* hn, void* ego,
                     Streams st, long long B, int wl, int H, void* stream) {
  using W = Elem<BF16>;
  const Tile tl = tile_for(H, BF16);
  const bool masked = mask != nullptr, homo = ego != nullptr;
  EncodeKernel<BF16> kernel;
  if constexpr (BF16 || GRU)
    kernel = H == 64 ? encode_instance<STREAMS, 64, BF16, GRU>(masked, homo)
                     : encode_instance<STREAMS, 0, BF16, GRU>(masked, homo);
  else
    kernel = H == 64    ? encode_instance<STREAMS, 64, false>(masked, homo)
             : H == 256 ? encode_instance<STREAMS, 256, false>(masked, homo)
                        : encode_instance<STREAMS, 0, false>(masked, homo);
  if (int e = allow_smem(kernel, tl.smem)) return e;
  kernel<<<(unsigned)((B + tl.M - 1) / tl.M), tl.NT, tl.smem, (cudaStream_t)stream>>>(
      (const W*)h, (const int*)paths, (const int*)dists, (const W*)wd, (const W*)bd,
      (const W*)w_ih, (const W*)w_hh, (const W*)b_ih, (const W*)b_hh, (const uint8_t*)mask,
      keep, (float*)hn, (float*)ego, st, B, wl, H,
      alignment((uintptr_t)wd | (uintptr_t)w_ih | (uintptr_t)w_hh));
  return (int)cudaGetLastError();
}

// The encode, f32 or (bf16) with a bf16 table and bf16 weights; the LSTM,
// or (gru) the GRU on packed weights, f32 only, whose instances are built
// apart (see pagg_encode_gru above).
template <bool STREAMS>
int launch_encode(const void* h, const void* paths, const void* dists, const void* wd,
                  const void* bd, const void* w_ih, const void* w_hh, const void* b_ih,
                  const void* b_hh, const void* mask, float keep, void* hn, void* ego,
                  Streams st, int T, int nw, int wl, int H, int bf16, int gru,
                  void* stream) {
  const long long B = (long long)T * nw;
  if (B == 0) return 0;
  if (gru && bf16) return (int)cudaErrorInvalidValue;
  if (gru) {
    if constexpr (STREAMS)
      return pagg_encode_gru_streams(h, paths, dists, wd, bd, w_ih, w_hh, b_ih, b_hh, mask,
                                     keep, hn, ego, st.xr, st.xin, st.hp, st.cs, st.gt, B,
                                     wl, H, stream);
    else
      return pagg_encode_gru(h, paths, dists, wd, bd, w_ih, w_hh, b_ih, b_hh, mask, keep,
                             hn, ego, B, wl, H, stream);
  }
  return (bf16 ? launch_encode_as<STREAMS, true, false>
               : launch_encode_as<STREAMS, false, false>)(
      h, paths, dists, wd, bd, w_ih, w_hh, b_ih, b_hh, mask, keep, hn, ego, st, B, wl, H,
      stream);
}

}  // namespace
