// K3: PAGG encode forward for the hetero / LSTM / attention model, f32.
//
// Replaces pathnet_tpu/models/pagg.py:235-303 (the encode block and the
// attention readout of pagg_forward) with _dist_select (:150-177) and
// nn/cells.py:22-46 (lstm_scan). For every walk b = target * nw + walk:
//   x_t   = h[paths[wl-1-t]]                     (hetero: far -> near)
//   s_t   = x_t @ W[d] + b[d],  d = clip(dists[wl-1-t], 0, wl-1)
//   s_t   = mask ? s_t / keep : 0                (training only, pagg.py:274)
//   gates = s_t @ w_ih + b_ih + h_{t-1} @ w_hh + b_hh   (i, f, g, o)
//   c_t = f c_{t-1} + i g,  h_t = o tanh(c_t)
// and per target:
//   score = leaky_relu(attw . [h_n, h[paths[0]]] + attb), softmax over nw
//   out   = sum over walks of softmax * h_n                  -> [T, H]
//
// Bound on the H100: f32 FMA work on the CUDA cores, 18 H^2 flops per walk
// step (2 H^2 for the selected distance transform, 16 H^2 for the gates):
// 1.44 ms for an 8192-target request at H = 64 (nw = 40, wl = 4) at
// 67 TFLOP/s, against ~29 MB of unique bytes (9 us). The weights are small
// (w_ih + w_hh = 32 H^2 bytes, wd 4 H^2 bytes a class) but every step reads
// all of them, so what a design pays beyond the bound is how often they
// cross from L2 and how many shared or L1 loads feed each FMA. The design
// before this one ran one block per target, re-read the weights from L2 for
// every group of 4 to 16 walks, and fed 2 FMAs per load (10.6 ms a request
// on the H100 at 700 W).
//
// Design: two launches.
// 1. pagg_encode_walks_kernel runs over the flat walk axis in tiles of M
//    consecutive walks (grid ceil(T * nw / M), the ragged last tile
//    masked). Each block streams ~(32 + 4 * classes) H^2 bytes of weights
//    from L2 per step, so a launch streams ~(T * nw / M) * wl * 36 H^2
//    bytes: 3.4 GB at the bgp request (H = 64, M = 64), 2.9 GB at H = 256
//    (M = 32) on 7,720 walks.
//    Each step is a register-tiled f32 GEMM [M, 2H] x [2H, 4H]: A =
//    [s_t | h_{t-1}] lives in shared memory transposed ([2H][M + 4]), and
//    B = [w_ih; w_hh] passes through shared memory in chunks of KC rows,
//    double-buffered with 16-byte cp.async copies of the rows as they lie.
//    Thread (r, c) owns walks 8r .. 8r+7 and hidden units 2c, 2c+1, all
//    four gates of each (64 accumulators), so the cell update is the GEMM's
//    epilogue in registers: c_t stays in registers across the wl steps and
//    h_t goes back to shared memory as the next step's A. A warp spans 4
//    row groups x 8 columns: per k it issues two 16-byte loads of A and four
//    8-byte loads of B (one shared wavefront each) for 64 FMAs.
//    The distance select is one such GEMM [M, H] x [H, H] per class present
//    in the tile at that step (classes 0..pos under membership distances,
//    ~2.25 passes a step on the bgp request), each row keeping the class it
//    holds; x_t is gathered into the s half of A and overwritten by s_t,
//    dropped out as it is written. The last step writes h_n [T * nw, H] to
//    a scratch the wrapper allocates. H = 64 and 256 are compiled with the
//    tile as constants; other widths take the instance that reads it at run
//    time.
// 2. pagg_readout_kernel: one block per target; a warp per walk scores it,
//    warp 0 reduces the max and the denominator once, and the block forms
//    the weighted sum over nw.
// M and KC are derived from H in tile_for; nothing is a knob.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TM = 8;        // walks per thread
constexpr int TN = 2;        // hidden units per thread, four gates each
constexpr int NT_MAX = 512;  // threads per block at most
static_assert(TN == 2, "tile_gemm unpacks B in pairs of units");

struct Tile {
  int M, CT, NT, KC, LDA, smem;
};

__host__ __device__ constexpr Tile tile_for(int H) {
  const int CT = (H + TN - 1) / TN;
  const int nt = H >= 128 ? NT_MAX : 256;
  const int rt = nt / CT < 1 ? 1 : (nt / CT > 32 ? 32 : nt / CT);
  const int kc = 2048 / H;  // a weight chunk of at most 32 KB
  const int KC = kc < 1 ? 1 : (kc > 32 ? 32 : kc);
  const int M = TM * rt;
  const int LDA = M + 4;    // rows of A padded against bank conflicts on stores
  return Tile{M, CT, rt * CT, KC, LDA,
              (int)((2 * H * LDA + 2 * KC * 4 * H) * sizeof(float))};
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

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
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

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// Rows ch*KC .. of B (NB floats each; row k from B0 + k*NB below K0, else
// from B1) into dst, as they lie, in copies of STEP floats.
template <int STEP>
__device__ __forceinline__ void stage_rows(float* dst, int ch, int KC, int K,
                                           const float* __restrict__ B0, int K0,
                                           const float* __restrict__ B1, int NB, int NT) {
  const int k0 = ch * KC;
  const int rows = K - k0 < KC ? K - k0 : KC;
  const int per_row = NB / STEP;
  for (int f = threadIdx.x; f < rows * per_row; f += NT) {
    const int kk = f / per_row, col = f % per_row * STEP;
    const int k = k0 + kk;
    const float* src = (k < K0 ? B0 + (size_t)k * NB : B1 + (size_t)(k - K0) * NB) + col;
    if (STEP == 4)
      cp_async16(dst + kk * NB + col, src);
    else
      cp_async4(dst + kk * NB + col, src);
  }
}

// 16-byte copies where every row and base is 16-byte aligned (vec), else
// 4-byte ones; one cp.async group.
__device__ __forceinline__ void stage_chunk(float* dst, int ch, int KC, int K,
                                            const float* __restrict__ B0, int K0,
                                            const float* __restrict__ B1, int NB,
                                            int NT, bool vec) {
  if (vec)
    stage_rows<4>(dst, ch, KC, K, B0, K0, B1, NB, NT);
  else
    stage_rows<1>(dst, ch, KC, K, B0, K0, B1, NB, NT);
  cp_async_commit();
}

// acc[i][u][g] += sum_k A[k][m0 + i] * B[k][g * H + 2c + u] over k < K, with
// B's rows staged through Bs in double-buffered chunks of KC rows. Every
// thread of the block calls it; it ends with a barrier, so A may be
// rewritten right after.
template <int NG>
__device__ __forceinline__ void tile_gemm(float (&acc)[TM][TN][NG],
                                          const float* As, int LDA, int m0, int K,
                                          const float* __restrict__ B0, int K0,
                                          const float* __restrict__ B1, float* Bs,
                                          int KC, const int (&jc)[TN], int H, int NT,
                                          bool vec) {
  const int NB = NG * H;
  const int nch = (K + KC - 1) / KC;
  stage_chunk(Bs, 0, KC, K, B0, K0, B1, NB, NT, vec);
  for (int ch = 0; ch < nch; ++ch) {
    const float* cur = Bs + (ch & 1) * KC * NB;
    if (ch + 1 < nch) {
      stage_chunk(Bs + ((ch + 1) & 1) * KC * NB, ch + 1, KC, K, B0, K0, B1, NB, NT, vec);
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
      const float* bb = cur + kk * NB;
      float bv[NG][TN];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        if (H % 2 == 0) {  // units 2c, 2c + 1 side by side, 8-byte aligned
          const float2 v = *reinterpret_cast<const float2*>(bb + g * H + jc[0]);
          bv[g][0] = v.x;
          bv[g][1] = v.y;
        } else {
          bv[g][0] = bb[g * H + jc[0]];
          bv[g][1] = bb[g * H + jc[1]];
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

template <bool MASKED, int HC>
__global__ void __launch_bounds__(launch_threads(HC), launch_blocks(HC))
pagg_encode_walks_kernel(
    const float* __restrict__ h, const int* __restrict__ paths,
    const int* __restrict__ dists, const float* __restrict__ wd,
    const float* __restrict__ bd, const float* __restrict__ w_ih,
    const float* __restrict__ w_hh, const float* __restrict__ b_ih,
    const float* __restrict__ b_hh, const uint8_t* __restrict__ mask, float keep,
    float* __restrict__ hn, long long B, int wl, int Hrt, bool aligned) {
  constexpr Tile tc = tile_for(HC ? HC : 64);
  const Tile tr = tile_for(Hrt);
  const int H = HC ? HC : Hrt;
  const int CT = HC ? tc.CT : tr.CT;
  const int KC = HC ? tc.KC : tr.KC;
  const int LDA = HC ? tc.LDA : tr.LDA;
  const int M = HC ? tc.M : tr.M;
  const int NT = HC ? tc.NT : tr.NT;
  const bool vec4 = aligned, vec1 = aligned && H % 4 == 0;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;               // [2H][LDA]: x_t then s_t, then h_{t-1}
  float* Bs = As + 2 * H * LDA;   // [2][KC][4H] weight chunks
  // thread (r, c): a warp covers 4 row groups x 8 columns where the tile
  // allows it, so its loads of A and B each touch few distinct words
  int c, r;
  if (CT % 8 == 0 && (M / TM) % 4 == 0) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    c = (w % (CT / 8)) * 8 + (lane & 7);
    r = (w / (CT / 8)) * 4 + (lane >> 3);
  } else {
    c = threadIdx.x % CT;
    r = threadIdx.x / CT;
  }
  const int m0 = r * TM;
  const long long b0 = (long long)blockIdx.x * M + m0;
  int jc[TN];      // unit of slot u, clamped to H - 1 for loads
  bool jv[TN];     // whether slot u holds a unit
#pragma unroll
  for (int u = 0; u < TN; ++u) {
    const int j = TN * c + u;
    jv[u] = j < H;
    jc[u] = jv[u] ? j : H - 1;
  }
  for (int e = threadIdx.x; e < H * LDA; e += NT) As[H * LDA + e] = 0.0f;
  float cs[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int u = 0; u < TN; ++u) cs[i][u] = 0.0f;

  for (int t = 0; t < wl; ++t) {
    const int pos = wl - 1 - t;
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
#pragma unroll
      for (int u = 0; u < TN; ++u) xv[u][i] = v >= 0 ? h[v * H + jc[u]] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < TN; ++u)
      if (jv[u]) store_rows(As + jc[u] * LDA + m0, xv[u]);

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
      const float* wk = wd + (size_t)k * H * H;
      tile_gemm<1>(acc, As, LDA, m0, H, wk, H, wk, Bs, KC, jc, H, NT, vec1);
#pragma unroll
      for (int u = 0; u < TN; ++u) {
        const float bk = bd[(size_t)k * H + jc[u]];
#pragma unroll
        for (int i = 0; i < TM; ++i)
          if (dq[i] == k) sv[u][i] = acc[i][u][0] + bk;
      }
    }
    // dropout as s_t is written over x_t (the last GEMM ended with a barrier)
#pragma unroll
    for (int u = 0; u < TN; ++u) {
      if (!jv[u]) continue;
      if (MASKED) {
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const long long b = b0 + i;
          if (b < B)
            sv[u][i] = mask[((long long)t * B + b) * H + jc[u]] ? sv[u][i] / keep : 0.0f;
        }
      }
      store_rows(As + jc[u] * LDA + m0, sv[u]);
    }
    __syncthreads();

    // gates = [s_t | h_{t-1}] @ [w_ih; w_hh] + b_ih + b_hh
    float acc[TM][TN][4];
#pragma unroll
    for (int u = 0; u < TN; ++u)
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float bias = b_ih[g * H + jc[u]] + b_hh[g * H + jc[u]];
#pragma unroll
        for (int i = 0; i < TM; ++i) acc[i][u][g] = bias;
      }
    tile_gemm<4>(acc, As, LDA, m0, 2 * H, w_ih, H, w_hh, Bs, KC, jc, H, NT, vec4);

    // cell update in registers; h_t back to A, or out as h_n after the last step
#pragma unroll
    for (int u = 0; u < TN; ++u) {
      float hv[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float si = sigm(acc[i][u][0]), sf = sigm(acc[i][u][1]);
        const float tg = tanh_f(acc[i][u][2]), so = sigm(acc[i][u][3]);
        cs[i][u] = sf * cs[i][u] + si * tg;
        hv[i] = so * tanh_f(cs[i][u]);
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

__global__ void pagg_readout_kernel(const float* __restrict__ h,
                                    const int* __restrict__ paths,
                                    const float* __restrict__ hn,
                                    const float* __restrict__ attw,
                                    const float* __restrict__ attb,
                                    float* __restrict__ out, int nw, int wl, int H) {
  extern __shared__ float sc[];  // [nw] scores, then softmax weights
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const long long b0 = (long long)blockIdx.x * nw;
  for (int p = warp; p < nw; p += nwarps) {
    const float* hr = hn + (b0 + p) * H;
    const float* ego = h + (long long)paths[(b0 + p) * wl] * H;
    float s = 0.0f;
    for (int k = lane; k < H; k += 32) s += attw[k] * hr[k] + attw[H + k] * ego[k];
    s = warp_sum(s) + attb[0];
    if (lane == 0) sc[p] = s > 0.0f ? s : 0.01f * s;
  }
  __syncthreads();
  if (warp == 0) {
    float m = -INFINITY;
    for (int p = lane; p < nw; p += 32) m = fmaxf(m, sc[p]);
    m = warp_max(m);
    float den = 0.0f;
    for (int p = lane; p < nw; p += 32) den += expf(sc[p] - m);
    den = warp_sum(den);
    for (int p = lane; p < nw; p += 32) sc[p] = expf(sc[p] - m) / den;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < H; j += blockDim.x) {
    float o = 0.0f;
    for (int p = 0; p < nw; ++p) o += sc[p] * hn[(b0 + p) * H + j];
    out[(long long)blockIdx.x * H + j] = o;
  }
}

}  // namespace

// K3's tile at width H: out[0..3] = M (walks a block), threads, shared bytes, KC.
extern "C" int pathnet_pagg_encode_tile(int H, void* out) {
  const Tile t = tile_for(H);
  int* o = (int*)out;
  o[0] = t.M;
  o[1] = t.NT;
  o[2] = t.smem;
  o[3] = t.KC;
  return 0;
}

// Launch 1: h_n [T * nw, H] of every walk.
extern "C" int pathnet_pagg_encode_walks(
    const void* h, const void* paths, const void* dists, const void* wd,
    const void* bd, const void* w_ih, const void* w_hh, const void* b_ih,
    const void* b_hh, const void* mask, float keep, void* hn, int T, int nw,
    int wl, int H, void* stream) {
  const long long B = (long long)T * nw;
  if (B == 0) return 0;
  const Tile tl = tile_for(H);
  auto kernel = H == 64    ? (mask ? pagg_encode_walks_kernel<true, 64>
                                   : pagg_encode_walks_kernel<false, 64>)
                : H == 256 ? (mask ? pagg_encode_walks_kernel<true, 256>
                                   : pagg_encode_walks_kernel<false, 256>)
                           : (mask ? pagg_encode_walks_kernel<true, 0>
                                   : pagg_encode_walks_kernel<false, 0>);
  if (tl.smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, tl.smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long grid = (B + tl.M - 1) / tl.M;
  kernel<<<(unsigned)grid, tl.NT, tl.smem, (cudaStream_t)stream>>>(
      (const float*)h, (const int*)paths, (const int*)dists, (const float*)wd,
      (const float*)bd, (const float*)w_ih, (const float*)w_hh,
      (const float*)b_ih, (const float*)b_hh, (const uint8_t*)mask, keep,
      (float*)hn, B, wl, H,
      ((uintptr_t)wd | (uintptr_t)w_ih | (uintptr_t)w_hh) % 16 == 0);
  return (int)cudaGetLastError();
}

// Launch 2: the attention readout [T, H] from h_n.
extern "C" int pathnet_pagg_readout(const void* h, const void* paths,
                                    const void* hn, const void* attw,
                                    const void* attb, void* out, int T, int nw,
                                    int wl, int H, void* stream) {
  if (T == 0) return 0;
  const size_t smem = (size_t)nw * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pagg_readout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  pagg_readout_kernel<<<T, H > 128 ? 256 : 128, smem, (cudaStream_t)stream>>>(
      (const float*)h, (const int*)paths, (const float*)hn, (const float*)attw,
      (const float*)attb, (float*)out, nw, wl, H);
  return (int)cudaGetLastError();
}
