// The walk tile shared by K3 (pagg_encode.cu) and K4 (pagg_encode_bwd.cu):
// the tile's shape from H (tile_for), the cp.async staging of weight rows
// through shared memory, the register-tiled f32 product tile_gemm<NG>, the
// bf16 tensor-core product mma_gemm<NG>, and the encode over walk tiles,
// pagg_encode_walks_kernel. K3 serves with STREAMS = false; K4's forward
// recompute runs the same kernel with STREAMS = true, which also writes the
// per-step values K4's BPTT reads.
// HOMO = true is the homo variant: steps in sampled order, a ReLU on the
// selected row, and that row of step 0 (before dropout) stored as the
// walk's ego row. BF16 = true takes the gather table and the cast weights
// (wd, bd, w_ih, w_hh, b_ih, b_hh) as bf16, W below, and rounds the values
// to bf16 where the JAX package's bf16 encode holds them in bf16
// (pathnet_tpu/models/pagg.py:233-279): the selected row
// round(round(x W[d]) + b[d]), the dropped-out input round(s / keep) (keep
// given rounded to bf16), and c_t and h_t at the end of each step. CELL is
// the encoder: LSTM_CELL; GRU_CELL, the GRU (gates r, z, n) on weights
// packed into the LSTM's layout (see pagg_encode.cu): the same product, and
// an epilogue that reads h_{t-1} from the h half of A (BF16 rounds its two
// n-group columns and h_t); MLP_CELL, h_n = mean_t(s_t) @ W + b with W as
// w_ih and b as b_ih: the selected rows summed in registers over the steps,
// then one [M, H] x [H, H] product of their mean, no gate product (BF16
// rounds the mean, then h_n = round(round(m W) + b)). The design and its
// bound are described in pagg_encode.cu.
//
// The BF16 instances' products run on the bf16 tensor cores (mma_gemm,
// mma.sync m16n8k16 with f32 accumulators). A [s_t | h_{t-1}] holds bf16
// values only (the gathered row, the rounded selected row, the rounded
// h_{t-1}), so it is kept in bf16 and its operands are exact; the products
// then differ from the f32 CUDA-core product (tile_gemm, which the f32
// instances keep) only in the order of the f32 sums. What bounds them
// on the H100 is not the tensor cores (18 H^2 flops a walk step are 0.098
// ms at the bgp request at 989 TFLOP/s) but shared memory and the tile's
// epilogue: mma_gemm stages each product's f32 result through a C tile in
// shared memory, so the LSTM and select epilogues take their accumulators
// in the CUDA-core tile's layout (a thread's 8 walks x 2 units x 4 gates)
// and stay as they were; the weights pass through shared memory once per
// block and step as for tile_gemm, in half the bytes. The tile (tile_for
// with bf16) keeps two blocks a SM at H = 64.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

// The encoders (template parameter CELL; the C entries' cell codes).
enum { LSTM_CELL = 0, GRU_CELL = 1, MLP_CELL = 2 };

// The encode instances of the GRU and the MLP, f32 and (bf16 nonzero) bf16,
// each set built in a translation unit of its own so that nvcc compiles them
// beside the others: K3's (pagg_encode_gru.cu, pagg_encode_mlp.cu) and K4's
// forward recompute (STREAMS: pagg_encode_bwd_gru.cu, pagg_encode_bwd_mlp.cu).
// The arguments are launch_encode's, the streams as their five pointers.
#define PAGG_ENCODE_SET_ARGS                                                                 \
  int bf16, const void *h, const void *paths, const void *dists, const void *wd,            \
      const void *bd, const void *w_ih, const void *w_hh, const void *b_ih,                 \
      const void *b_hh, const void *mask, float keep, void *hn, void *ego, float *xr,       \
      float *xin, float *hp, float *cs, float *gt, long long B, int wl, int H, void *stream
int pagg_encode_gru(PAGG_ENCODE_SET_ARGS);
int pagg_encode_gru_streams(PAGG_ENCODE_SET_ARGS);
int pagg_encode_mlp(PAGG_ENCODE_SET_ARGS);
int pagg_encode_mlp_streams(PAGG_ENCODE_SET_ARGS);

namespace {

constexpr int TM = 8;        // walks per thread
constexpr int TN = 2;        // hidden units per thread, four gates each
constexpr int NT_MAX = 512;  // threads per block at most
static_assert(TN == 2, "tile_gemm unpacks B in pairs of units");

struct Tile {
  int M, CT, NT, KC, LDA, smem, Mp;
};

// The readouts (K3's second launch, K4's attention backward, template
// parameter AGG); the values are the wrappers' codes. QUIRK is the hetero
// attention readout followed by a mean over the walks in place of its sum
// (JAX's quirk_compat), on ego rows the wrapper names.
enum { ATTENTION = 0, MEAN = 1, SUM = 2, QUIRK = 3 };

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

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// A bf16 row of at least n elements holding an odd number of 16-byte units,
// so that ldmatrix's eight rows fall in eight bank groups.
__host__ __device__ constexpr int odd_units(int n) { return n / 8 % 2 ? n : n + 8; }

// The tensor-core product of the BF16 instances (mma_gemm below) at width H
// for NG column groups of H units (each padded to Hp, a multiple of 8),
// on a tile of Mp walks (8, the top half of one m16-tile, or a power of two
// times 16) and NT threads: each of the NT / 32 warps takes WN n8-tiles of
// all the m16-tiles (at most TILES tiles, 4 f32 accumulators each a thread,
// and at most 4 n8-tiles); the columns go in chunks of CW, each staged
// through shared memory as KC rows of LDB bf16 and written back as an f32 C
// tile [Mp][LDC], from which each thread takes its entries.
struct MmaShape {
  int WN, CW, LDB, LDC, KC;
};

// The BF16 instances' compiled widths: bgp's H = 64 and Electronics' 32;
// any other width runs the run-time instance (HC = 0).
__host__ __device__ constexpr bool bf16_compiled(int H) { return H == 64 || H == 32; }

// A warp's tiles: 16 where H is compiled in and the tile shape is
// constants; in the run-time instance, which also holds the shape in
// registers, 8 and one n8-tile a warp (more spilled there). Host and device
// agree on it.
__host__ __device__ constexpr int mma_tiles(int H) { return bf16_compiled(H) ? 16 : 8; }

__host__ __device__ constexpr MmaShape mma_shape(int NG, int H, int Mp, int NT) {
  const int N = NG * ((H + 7) / 8 * 8);
  const int MT = Mp < 16 ? 1 : Mp / 16, nwp = NT / 32, tiles = mma_tiles(H) / MT;
  // a warp spans one column tile where every warp then has one (the select
  // at H = 64), else as many as its tiles allow, at most 4
  const int WN = nwp >= N / 8 || !bf16_compiled(H) ? 1 : (tiles < 4 ? tiles : 4);
  const int CW = nwp * WN * 8 < N ? nwp * WN * 8 : N;
  const int LDB = odd_units(CW);
  return MmaShape{WN, CW, LDB, CW + 4, 2 * 32 * LDB * 2 <= 40960 ? 32 : 16};
}

// The shared bytes of one product: its two weight chunks or its C tile,
// which reuses them.
__host__ __device__ constexpr int mma_bytes(int NG, int H, int Mp, int NT) {
  const MmaShape s = mma_shape(NG, H, Mp, NT);
  const int b = 2 * s.KC * s.LDB * 2, c = Mp * s.LDC * 4;
  return b > c ? b : c;
}

// The shared bytes of the BF16 encode (bptt false: A [roundup(2H, 16)][LDA]
// bf16, then the larger of its two products' regions) and of the BF16 BPTT
// (A's two bf16 halves [roundup(4H, 16)][LDA], then its products' region)
// on a tile of Mp walks and NT threads.
__host__ __device__ constexpr int bf16_smem(int H, int Mp, int NT, bool bptt) {
  const int LDA = odd_units(Mp);
  const int a = bptt ? mma_bytes(2, H, Mp, NT) : mma_bytes(4, H, Mp, NT);
  const int b = mma_bytes(1, H, Mp, NT);
  return (bptt ? 2 * round_up(4 * H, 16) : round_up(2 * H, 16)) * LDA * 2 + (a > b ? a : b);
}

constexpr int SMEM_MAX = 232448;  // the shared bytes a block may use on the H100

__host__ __device__ constexpr Tile tile_for(int H, bool bf16 = false) {
  const int CT = (H + TN - 1) / TN;
  const int nt = H >= 128 ? NT_MAX : 256;
  const int rt = nt / CT < 1 ? 1 : (nt / CT > 32 ? 32 : nt / CT);
  const int kc = 2048 / H;  // a weight chunk of at most 32 KB
  const int KC = kc < 1 ? 1 : (kc > 32 ? 32 : kc);
  if (bf16) {
    // the tensor-core tile, shared by the BF16 encode and BPTT: row groups a
    // power of two (M = 8, or a power of two times 16, the m-tiles), as many
    // as the BPTT's shared bytes allow; whole warps (a thread past rt * CT
    // holds no walk); A in bf16 (see bf16_smem)
    int r2 = 1;
    while (r2 * 2 <= rt && TM * r2 * 2 <= 16 * mma_tiles(H)) r2 *= 2;
    while (r2 > 1 && bf16_smem(H, TM * r2, round_up(r2 * CT, 32), true) > SMEM_MAX) r2 /= 2;
    const int M = TM * r2, NT = round_up(r2 * CT, 32);
    return Tile{M, CT, NT, KC, odd_units(M), bf16_smem(H, M, NT, false), M};
  }
  const int M = TM * rt;
  const int LDA = M + 4;    // rows of A padded against bank conflicts on stores
  // A in f32, two weight chunks
  return Tile{M, CT, rt * CT, KC, LDA, (int)(2 * H * LDA * sizeof(float) + 2 * KC * 4 * H * 4),
              M};
}

// The widths compiled with H, and so the whole tile, as constants; any
// other width runs the instance with HC = 0, which reads them at run time.
// Two blocks a SM at H = 64 cap a thread at 128 registers (a few spill); one
// block of 256 threads without the cap, 8 warps a SM, ran slower on the H100.
constexpr int launch_threads(int HC) { return HC ? tile_for(HC).NT : NT_MAX; }
constexpr int launch_blocks(int HC) { return HC == 64 || HC == 32 ? 2 : 1; }

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

// ---- The BF16 instances' products on bf16 tensor cores ----
// mma.sync m16n8k16 (bf16 in, f32 accumulate) with fragments from ldmatrix.
// A lies k-major in shared memory ([k][LDA] bf16, so .trans gives the
// row-major A fragment); B's chunks lie [k][LDB] (.trans gives the col-major
// B fragment). The encode's A and B hold bf16 values, so its operands are
// exact and only the f32 sums' order differs from the CUDA-core product's.
// The BPTT's A holds f32 cotangents as two bf16 halves, hi = bf16(a) and
// lo = bf16(a - hi), each multiplied into the same accumulators: within
// ~2^-16 relative of the f32 product.

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ void ldsm_x2_t(unsigned& r0, unsigned& r1, const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows k0 .. k0 + KC of B (row k from B0 + k * NB below K0, else from B1;
// zero at k >= K) at the padded columns c0 .. c0 + cw (column n is unit
// n % Hp of group n / Hp, zero past H) into dst [KC][LDB], in pieces of 8
// (16-byte cp.async), 2 (4-byte cp.async) or 1 (plain) elements by `mode`;
// one cp.async group.
__device__ __forceinline__ void stage_mma_chunk(__nv_bfloat16* dst, int k0, int KC, int K,
                                                const __nv_bfloat16* __restrict__ B0, int K0,
                                                const __nv_bfloat16* __restrict__ B1, int NB,
                                                int c0, int cw, int Hp, int H, int LDB,
                                                int NT, int mode) {
  const int step = mode == COPY16 ? 8 : mode == COPY4 ? 2 : 1;
  const int per_row = cw / step;
  for (int f = threadIdx.x; f < KC * per_row; f += NT) {
    const int kk = f / per_row, col = f % per_row * step;
    const int k = k0 + kk, n = c0 + col;
    const int g = n / Hp, j = n - g * Hp;
    __nv_bfloat16* d = dst + kk * LDB + col;
    const bool real = k < K && j < H;
    const __nv_bfloat16* src =
        (k < K0 ? B0 + (size_t)k * NB : B1 + (size_t)(k - K0) * NB) + g * H + j;
    if (mode == COPY16) {
      if (real)
        cp_async16(d, src);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    } else if (mode == COPY4) {
      if (real)
        cp_async4(d, src);
      else
        *reinterpret_cast<unsigned*>(d) = 0u;
    } else {
      *d = real ? *src : __float2bfloat16_rn(0.0f);
    }
  }
  cp_async_commit();
}

// What one product's arguments hold: A (and, for an f32 A, its low half
// A2, else null) k-major [.][LDA] over Mp walks, K rows of it used; B's
// rows of NB elements (B0 below K0, then B1); the initial value of column
// (g, j), bias0[g * H + j] + bias1[g * H + j] (0 without them); the shared
// region for B's chunks and C's; the chunk [c0, c0 + cw) being computed.
struct MmaArgs {
  float* Cs;
  const __nv_bfloat16* As;
  const __nv_bfloat16* As2;
  int LDA, K;
  const __nv_bfloat16* B0;
  int K0;
  const __nv_bfloat16* B1;
  int NB;
  const __nv_bfloat16* bias0;
  const __nv_bfloat16* bias1;
  __nv_bfloat16* Bs;
  MmaShape s;
  int c0, cw, Hp, H, NT, mode;
};

// One chunk of columns of C = init + A B on the tensor cores, written to
// Cs [Mp][s.LDC] (f32): warp w takes n-tiles w * WN .. w * WN + WN - 1 of the
// chunk over WM m16-tiles (HALF: one tile of which rows 0-7 hold walks and
// rows 8-15 are zeros that are neither loaded nor stored). Every thread of
// the block calls it; it ends with a barrier.
template <int WM, int WN, bool HALF = false>
__device__ __forceinline__ void mma_chunk(const MmaArgs& p) {
  const MmaShape& s = p.s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nt0 = warp * WN;  // the warp's first n-tile of the chunk
  const int ntl = p.cw / 8;
  float d[WM][WN][4];
#pragma unroll
  for (int q = 0; q < WN; ++q) {
    float b[2] = {0.0f, 0.0f};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = p.c0 + (nt0 + q) * 8 + (lane & 3) * 2 + e;
      const int g = n / p.Hp, j = n - g * p.Hp;
      if (p.bias0 && nt0 + q < ntl && j < p.H)
        b[e] = __bfloat162float(p.bias0[g * p.H + j]) + __bfloat162float(p.bias1[g * p.H + j]);
    }
#pragma unroll
    for (int m = 0; m < WM; ++m) {
      d[m][q][0] = d[m][q][2] = b[0];
      d[m][q][1] = d[m][q][3] = b[1];
    }
  }
  const int Kp = round_up(p.K, 16);
  const int nch = (Kp + s.KC - 1) / s.KC;
  const int halves = p.As2 ? 2 : 1;
  stage_mma_chunk(p.Bs, 0, s.KC, p.K, p.B0, p.K0, p.B1, p.NB, p.c0, p.cw, p.Hp, p.H, s.LDB,
                  p.NT, p.mode);
  for (int ch = 0; ch < nch; ++ch) {
    const __nv_bfloat16* cur = p.Bs + (ch & 1) * s.KC * s.LDB;
    if (ch + 1 < nch) {
      stage_mma_chunk(p.Bs + ((ch + 1) & 1) * s.KC * s.LDB, (ch + 1) * s.KC, s.KC, p.K, p.B0,
                      p.K0, p.B1, p.NB, p.c0, p.cw, p.Hp, p.H, s.LDB, p.NT, p.mode);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = ch * s.KC;
    const int kn = Kp - k0 < s.KC ? Kp - k0 : s.KC;
    if (nt0 < ntl) {
      // lane l points ldmatrix at row l % 8 of matrix l / 8
      const int mi = lane >> 3, mr = lane & 7;
      for (int kk = 0; kk < kn; kk += 16) {
        // B: matrices (k 0-7, tile q), (k 8-15, tile q), then tile q + 1's
        unsigned b[WN][2];
        const __nv_bfloat16* bp = cur + (kk + (mi & 1) * 8 + mr) * s.LDB + nt0 * 8;
        if constexpr (WN == 1) {
          ldsm_x2_t(b[0][0], b[0][1], bp);
        } else {
#pragma unroll
          for (int q = 0; q < WN; q += 2) {
            if (nt0 + q + 1 < ntl) {
              unsigned r[4];
              ldsm_x4_t(r, bp + (q + (mi >> 1)) * 8);
              b[q][0] = r[0];
              b[q][1] = r[1];
              b[q + 1][0] = r[2];
              b[q + 1][1] = r[3];
            } else if (nt0 + q < ntl) {  // the chunk's last tile alone
              ldsm_x2_t(b[q][0], b[q][1], bp + q * 8);
            }
          }
        }
        const int krow = k0 + kk + (mi >> 1) * 8 + mr;
        for (int half = 0; half < halves; ++half) {
          const __nv_bfloat16* A = half ? p.As2 : p.As;
#pragma unroll
          for (int m = 0; m < WM; ++m) {
            unsigned a[4];
            if constexpr (HALF) {
              // (rows 0-7, k 0-7) and (rows 0-7, k 8-15): lanes 0-7 and 8-15
              ldsm_x2_t(a[0], a[2], A + (k0 + kk + (mi & 1) * 8 + mr) * p.LDA);
              a[1] = a[3] = 0u;
            } else {
              ldsm_x4_t(a, A + krow * p.LDA + m * 16 + (mi & 1) * 8);
            }
#pragma unroll
            for (int q = 0; q < WN; ++q)
              if (nt0 + q < ntl) mma_bf16(d[m][q], a, b[q][0], b[q][1]);
          }
        }
      }
    }
    __syncthreads();
  }
  // the accumulators to C: rows lane / 4 and lane / 4 + 8 of each m-tile
#pragma unroll
  for (int q = 0; q < WN; ++q) {
    if (nt0 + q >= ntl) break;
    const int col = (nt0 + q) * 8 + (lane & 3) * 2;
#pragma unroll
    for (int m = 0; m < WM; ++m) {
      const int row = m * 16 + (lane >> 2);
      *reinterpret_cast<float2*>(p.Cs + row * s.LDC + col) = make_float2(d[m][q][0], d[m][q][1]);
      if (!HALF)
        *reinterpret_cast<float2*>(p.Cs + (row + 8) * s.LDC + col) =
            make_float2(d[m][q][2], d[m][q][3]);
    }
  }
  __syncthreads();
}

// acc[i][u][g] = init + sum_k A[k][m0 + i] * B[k][g * H + jc[u]] over k < K
// for the thread's walks and held units (jv; 0 in the units it does not
// hold), as tile_gemm's accumulators (tile_gemm adds to them; this sets
// them): A bf16 k-major [.][LDA] over Mp walks (A2, if given, its low half:
// both are multiplied in), B bf16 rows of NB = NG * H as tile_gemm takes
// them, init the sum of bias0 and bias1 at the column (0 where they are
// null). The region holds the weight chunks, then the C chunks; `mode` is
// copy_mode<bf16>(H, align); TILES is mma_tiles(H). Every thread of the
// block calls it; it ends with a barrier, so A may be rewritten right after.
template <int NG, int TILES>
__device__ __forceinline__ void mma_gemm(float (&acc)[TM][TN][NG], const __nv_bfloat16* As,
                                         const __nv_bfloat16* As2, int LDA, int Mp, int m0,
                                         int K, const __nv_bfloat16* __restrict__ B0, int K0,
                                         const __nv_bfloat16* __restrict__ B1,
                                         const __nv_bfloat16* __restrict__ bias0,
                                         const __nv_bfloat16* __restrict__ bias1, void* region,
                                         const int (&jc)[TN], const bool (&jv)[TN], int H,
                                         int NT, int mode) {
  const MmaShape s = mma_shape(NG, H, Mp, NT);
  const int Hp = round_up(H, 8), N = NG * Hp;
  MmaArgs p{reinterpret_cast<float*>(region), As, As2, LDA, K, B0, K0, B1, NG * H, bias0,
            bias1, reinterpret_cast<__nv_bfloat16*>(region), s, 0, 0, Hp, H, NT, mode};
  // one warp tile where H is compiled in; the run-time width's with at most
  // 8 tiles and one n8-tile (TILES)
  constexpr bool T16 = TILES == 16;
  for (int c0 = 0; c0 < N; c0 += s.CW) {
    p.c0 = c0;
    p.cw = N - c0 < s.CW ? N - c0 : s.CW;
    // the warp tile (WM m16-tiles, or the top half of one, by WN n8-tiles)
    // as template constants (mma_shape's choices)
    if (s.WN == 1) {
      switch (Mp / 16) {
        case 0: mma_chunk<1, 1, true>(p); break;
        case 1: mma_chunk<1, 1>(p); break;
        case 2: mma_chunk<2, 1>(p); break;
        case 4: mma_chunk<4, 1>(p); break;
        case 8: mma_chunk<8, 1>(p); break;
        default: if constexpr (T16) mma_chunk<16, 1>(p); break;
      }
    } else if constexpr (T16) {
      switch (Mp / 16) {
        case 0: mma_chunk<1, 4, true>(p); break;
        case 1: mma_chunk<1, 4>(p); break;
        case 2: mma_chunk<2, 4>(p); break;
        case 4: mma_chunk<4, 4>(p); break;
        default: mma_chunk<8, 2>(p); break;
      }
    }
    const float* Cs = p.Cs;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int u = 0; u < TN; ++u) {
        const int col = g * Hp + jc[u] - c0;
        if (!jv[u]) {
          if (c0 == 0)
#pragma unroll
            for (int i = 0; i < TM; ++i) acc[i][u][g] = 0.0f;
          continue;
        }
        if (col < 0 || col >= p.cw) continue;
#pragma unroll
        for (int i = 0; i < TM; ++i) acc[i][u][g] = Cs[(m0 + i) * s.LDC + col];
      }
    __syncthreads();
  }
}

// Eight values of a bf16 A's column (bf16 values already: exact), one
// 16-byte store; and four values of an f32 cotangent as its bf16 halves
// hi and lo into two such A's, one 8-byte store each.
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const float (&v)[TM]) {
  static_assert(TM == 8, "eight bf16 a 16-byte store");
  __nv_bfloat162 q[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(q);
}

__device__ __forceinline__ void store_split4(__nv_bfloat16* hi, __nv_bfloat16* lo, float a,
                                             float b, float c, float d) {
  const float v[4] = {a, b, c, d};
  __nv_bfloat162 qh[2], ql[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qh[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    const float2 f = __bfloat1622float2(qh[i]);
    ql[i] = __floats2bfloat162_rn(v[2 * i] - f.x, v[2 * i + 1] - f.y);
  }
  *reinterpret_cast<uint2*>(hi) = *reinterpret_cast<const uint2*>(qh);
  *reinterpret_cast<uint2*>(lo) = *reinterpret_cast<const uint2*>(ql);
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
// gt as (r, z, n, h_{t-1} W_hn + b_hn); the MLP writes xr, xin and, in hp,
// its mean input m [B, H] (one row a walk), no cs and no gt.
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
// top; CELL the encoder. `align` is the alignment of wd, w_ih and w_hh in
// bytes.
template <bool MASKED, int HC, bool STREAMS, bool HOMO, bool BF16, int CELL = LSTM_CELL>
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
  constexpr bool GRU = CELL == GRU_CELL, MLP = CELL == MLP_CELL;
  constexpr Tile tc = tile_for(HC ? HC : 64, BF16);
  const Tile tr = tile_for(Hrt, BF16);
  const int H = HC ? HC : Hrt;
  const int CT = HC ? tc.CT : tr.CT;
  const int KC = HC ? tc.KC : tr.KC;
  const int LDA = HC ? tc.LDA : tr.LDA;
  const int M = HC ? tc.M : tr.M;
  const int Mp = HC ? tc.Mp : tr.Mp;
  const int NT = HC ? tc.NT : tr.NT;
  const int mode4 = copy_mode<W>(4 * H, align), mode1 = copy_mode<W>(H, align);
  // bf16 table rows read in pairs where every pair is 4-byte aligned
  const bool hpair = BF16 && H % 2 == 0 && (uintptr_t)h % 4 == 0;
  extern __shared__ __align__(16) float smem[];
  // A [2H][LDA]: x_t then s_t, then h_{t-1}; f32, or under BF16 bf16 with
  // its rows padded to a multiple of 16 (zeros)
  W* As = reinterpret_cast<W*>(smem);
  W* Bs = reinterpret_cast<W*>(As + 2 * H * LDA);    // f32: [2][KC][4H] weight chunks
  void* region = As + round_up(2 * H, 16) * LDA;     // BF16: mma_gemm's chunks and C tiles
  int r, c, jc[TN];
  bool jv[TN];
  tile_thread(CT, M, H, r, c, jc, jv);
  const int m0 = r * TM;
  // BF16: a thread past the tile's row groups (the block is whole warps)
  // holds no walk and no unit, but takes its part in the products
  const bool idle = BF16 && threadIdx.x >= M / TM * CT;
  if (idle) jv[0] = jv[1] = false;
  const long long b0 = idle ? B : (long long)blockIdx.x * M + m0;
  if constexpr (BF16) {
    for (int e = threadIdx.x; e < round_up(2 * H, 16) * LDA; e += NT)
      As[e] = __float2bfloat16_rn(0.0f);
  } else {
    for (int e = threadIdx.x; e < H * LDA; e += NT) As[H * LDA + e] = 0.0f;
  }
  float cs[TM][TN];  // c_t; the MLP's running sum of s_t
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
      if (t == 0 && !MLP) store_pairs(st.hp, r0, B - b0, H, jc, jv, zero);
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
      if constexpr (BF16)
        mma_gemm<1, mma_tiles(HC)>(acc, As, nullptr, LDA, Mp, m0, H, wk, H, wk, nullptr,
                                   nullptr, region, jc, jv, H, NT, mode1);
      else
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
      if constexpr (!MLP) store_rows(As + jc[u] * LDA + m0, sv[u]);
    }
    if constexpr (STREAMS) store_pairs(st.xin, r0, B - b0, H, jc, jv, sv);
    if constexpr (MLP) {
      // s_t into the running sum; after the last step its mean m to A's s
      // half (and to hp), then h_n = m W + b, one product
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int u = 0; u < TN; ++u) cs[i][u] += sv[u][i];
      if (t + 1 < wl) continue;
      float mv[TN][TM];
#pragma unroll
      for (int u = 0; u < TN; ++u) {
#pragma unroll
        for (int i = 0; i < TM; ++i) mv[u][i] = BF16 ? rnd(cs[i][u] / wl) : cs[i][u] / wl;
        if (jv[u]) store_rows(As + jc[u] * LDA + m0, mv[u]);
      }
      if constexpr (STREAMS) store_pairs(st.hp, b0, B - b0, H, jc, jv, mv);
      __syncthreads();
      float acc[TM][TN][1];
      if constexpr (BF16) {
        mma_gemm<1, mma_tiles(HC)>(acc, As, nullptr, LDA, Mp, m0, H, w_ih, H, w_ih, nullptr,
                                   nullptr, region, jc, jv, H, NT, mode1);
      } else {
#pragma unroll
        for (int u = 0; u < TN; ++u) {
          const float bias = ldf(b_ih + jc[u]);
#pragma unroll
          for (int i = 0; i < TM; ++i) acc[i][u][0] = bias;
        }
        tile_gemm<1>(acc, As, LDA, m0, H, w_ih, H, w_ih, Bs, KC, jc, H, NT, mode1);
      }
#pragma unroll
      for (int u = 0; u < TN; ++u) {
        if (!jv[u]) continue;
        const float bias = ldf(b_ih + jc[u]);
#pragma unroll
        for (int i = 0; i < TM; ++i)
          if (b0 + i < B)
            hn[(b0 + i) * H + jc[u]] = BF16 ? rnd(rnd(acc[i][u][0]) + bias) : acc[i][u][0];
      }
      continue;
    }
    __syncthreads();

    // gates = [s_t | h_{t-1}] @ [w_ih; w_hh] + b_ih + b_hh, the bias the
    // accumulators' initial value
    float acc[TM][TN][4];
    if constexpr (BF16) {
      mma_gemm<4, mma_tiles(HC)>(acc, As, nullptr, LDA, Mp, m0, 2 * H, w_ih, H, w_hh, b_ih,
                                 b_hh, region, jc, jv, H, NT, mode1);
    } else {
#pragma unroll
      for (int u = 0; u < TN; ++u)
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float bias = ldf(b_ih + g * H + jc[u]) + ldf(b_hh + g * H + jc[u]);
#pragma unroll
          for (int i = 0; i < TM; ++i) acc[i][u][g] = bias;
        }
      tile_gemm<4>(acc, As, LDA, m0, 2 * H, w_ih, H, w_hh, Bs, KC, jc, H, NT, mode4);
    }

    // cell update in registers; h_t back to A, or out as h_n after the last
    // step; BF16 rounds c_t, then h_t from the rounded c_t
    if constexpr (GRU) {
      // acc holds r and z before their sigmoids, x W_in + b_in and
      // h W_hn + b_hn (BF16: both rounded); h_{t-1} is this thread's own
      // entries of A's h half, which no other thread writes, read before any
      // is written over
      float hv[TN][TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        float gv[4][TN];
#pragma unroll
        for (int u = 0; u < TN; ++u) {
          const float hq = ldf(As + (H + jc[u]) * LDA + m0 + i);
          gv[0][u] = sigm(acc[i][u][0]);
          gv[1][u] = sigm(acc[i][u][1]);
          gv[3][u] = BF16 ? rnd(acc[i][u][3]) : acc[i][u][3];
          gv[2][u] = tanh_f((BF16 ? rnd(acc[i][u][2]) : acc[i][u][2]) + gv[0][u] * gv[3][u]);
          hv[u][i] = (1.0f - gv[1][u]) * gv[2][u] + gv[1][u] * hq;
          if constexpr (BF16) hv[u][i] = rnd(hv[u][i]);
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

template <bool STREAMS, int HC, bool BF16, int CELL = LSTM_CELL>
EncodeKernel<BF16> encode_instance(bool masked, bool homo) {
  return masked ? (homo ? pagg_encode_walks_kernel<true, HC, STREAMS, true, BF16, CELL>
                        : pagg_encode_walks_kernel<true, HC, STREAMS, false, BF16, CELL>)
                : (homo ? pagg_encode_walks_kernel<false, HC, STREAMS, true, BF16, CELL>
                        : pagg_encode_walks_kernel<false, HC, STREAMS, false, BF16, CELL>);
}

template <typename Kernel>
int allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   bytes);
}

// The encode on K3's grid of tiles at width H: f32, the instance with the
// tile compiled in where there is one (H = 64, 256; the GRU and the MLP, 64);
// bf16, H = 64, 32 or the run-time one. Masked where mask is given, homo
// where ego is given.
template <bool STREAMS, bool BF16, int CELL>
int launch_encode_as(const void* h, const void* paths, const void* dists, const void* wd,
                     const void* bd, const void* w_ih, const void* w_hh, const void* b_ih,
                     const void* b_hh, const void* mask, float keep, void* hn, void* ego,
                     Streams st, long long B, int wl, int H, void* stream) {
  using W = Elem<BF16>;
  const Tile tl = tile_for(H, BF16);
  const bool masked = mask != nullptr, homo = ego != nullptr;
  EncodeKernel<BF16> kernel;
  if constexpr (BF16)
    kernel = H == 64   ? encode_instance<STREAMS, 64, true, CELL>(masked, homo)
             : H == 32 ? encode_instance<STREAMS, 32, true, CELL>(masked, homo)
                       : encode_instance<STREAMS, 0, true, CELL>(masked, homo);
  else if constexpr (CELL != LSTM_CELL)
    kernel = H == 64 ? encode_instance<STREAMS, 64, false, CELL>(masked, homo)
                     : encode_instance<STREAMS, 0, false, CELL>(masked, homo);
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

// One cell's encode set (see PAGG_ENCODE_SET_ARGS): the f32 or the bf16
// instances by bf16.
template <bool STREAMS, int CELL>
int launch_encode_set(int bf16, const void* h, const void* paths, const void* dists,
                      const void* wd, const void* bd, const void* w_ih, const void* w_hh,
                      const void* b_ih, const void* b_hh, const void* mask, float keep,
                      void* hn, void* ego, float* xr, float* xin, float* hp, float* cs,
                      float* gt, long long B, int wl, int H, void* stream) {
  return (bf16 ? launch_encode_as<STREAMS, true, CELL> : launch_encode_as<STREAMS, false, CELL>)(
      h, paths, dists, wd, bd, w_ih, w_hh, b_ih, b_hh, mask, keep, hn, ego,
      Streams{xr, xin, hp, cs, gt}, B, wl, H, stream);
}

// The encode, f32 or (bf16) with a bf16 table and bf16 weights, of the
// encoder `cell`; the GRU's and the MLP's instances are built apart (see
// PAGG_ENCODE_SET_ARGS above).
template <bool STREAMS>
int launch_encode(const void* h, const void* paths, const void* dists, const void* wd,
                  const void* bd, const void* w_ih, const void* w_hh, const void* b_ih,
                  const void* b_hh, const void* mask, float keep, void* hn, void* ego,
                  Streams st, int T, int nw, int wl, int H, int bf16, int cell,
                  void* stream) {
  const long long B = (long long)T * nw;
  if (B == 0) return 0;
  if (cell == GRU_CELL || cell == MLP_CELL) {
    const auto set = cell == GRU_CELL ? (STREAMS ? pagg_encode_gru_streams : pagg_encode_gru)
                                      : (STREAMS ? pagg_encode_mlp_streams : pagg_encode_mlp);
    return set(bf16, h, paths, dists, wd, bd, w_ih, w_hh, b_ih, b_hh, mask, keep, hn, ego,
               st.xr, st.xin, st.hp, st.cs, st.gt, B, wl, H, stream);
  }
  if (cell != LSTM_CELL) return (int)cudaErrorInvalidValue;
  return (bf16 ? launch_encode_as<STREAMS, true, LSTM_CELL>
               : launch_encode_as<STREAMS, false, LSTM_CELL>)(
      h, paths, dists, wd, bd, w_ih, w_hh, b_ih, b_hh, mask, keep, hn, ego, st, B, wl, H,
      stream);
}

}  // namespace
