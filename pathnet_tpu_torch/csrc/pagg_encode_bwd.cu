// K4: PAGG encode backward for the hetero / LSTM / attention model, f32.
//
// Replaces the VJP of pathnet_tpu/models/pagg.py:235-303 (the encode block
// and attention readout that K3 computes), with the gather VJP of the "h"
// gather mode (pagg.py:83-93): given g = d h_agg [T, H] it writes the
// gradient of every gathered row, one row per (walk, position) plus one per
// walk for its ego row, which csrc/segment_sum.cu then sums into dh [n, H]
// in an order fixed by the paths; the attention weights' gradient as one
// partial sum per target, which the wrapper sums in a fixed order; and the
// per-row streams from which the wrapper contracts the weight gradients
// (dW_ih = xin^T dgates, dW_hh = hprev^T dgates, dwd[k] = sum over rows with
// d = k of xr^T dsel). No launch adds with atomics, so one input gives one
// result, bit for bit, on every run.
//
// Bound on the H100: f32 FMA work, about 54 H^2 flops per walk step (forward
// recompute 18, backward products 18, the wrapper's weight-gradient
// contractions 18): 4.3 ms per 8192-target bgp microbatch (nw = 40, wl = 4,
// H = 64) at 67 TFLOP/s. The streams, 9 H floats a walk step (3.0 GB there),
// are written once and read once or twice, ~1-2 ms of HBM at 3.35 TB/s where
// nothing overlaps them.
//
// Design: three launches on K3's walk tile (pagg_tile.cuh); nothing is kept
// between K3 and K4, so launch A recomputes the forward.
// A. pagg_encode_walks_kernel<MASKED, HC, STREAMS = true>: K3's encode on
//    K3's grid and tile, which also stores per step the values launch C and
//    the contractions read (xr, xin, hp, cs, gt: see Streams) and writes
//    h_n [T * nw, H] to a scratch.
// B. pagg_attention_bwd_kernel: one block per target, shaped like K3's
//    readout. A warp per walk recomputes its score and d att = g . h_n;
//    warp 0 forms the softmax and each walk's d score; the block writes
//    d h_n [T * nw, H] to a second scratch, the ego rows' gradient to its
//    rows [T * nw, H], and its sums over the walks (d attw, d attb) to its
//    row of the partial sums [T, 2H + 1].
// C. pagg_bptt_kernel: BPTT on K3's grid of M-walk tiles. Thread (r, c)
//    owns walks 8r .. 8r+7 and units 2c, 2c+1 of its tile and carries their
//    dh, dc and c_t in registers down the steps, from d h_n. Step t, from
//    wl - 1 down to 0: the epilogue forms the pre-activation gate gradients
//    from gt and cs, writes them over gt (the wrapper contracts them) and
//    into A [4H][M + 4] in shared memory; one tile_gemm<2> multiplies A by
//    [w_ih; w_hh]^T [4H, 2H] into the LSTM input's gradient and dh_{t-1},
//    which stays in registers; the keep mask turns the first into dsel,
//    written to its stream and over A as [H][M + 4]; one tile_gemm<1> per
//    distance class present in the tile multiplies it by wd[k]^T (K3's
//    select loop), and each gathered row's gradient is stored to its row of
//    the [wl, T * nw, H] row gradients, dsel's layout. Shared memory 4H (M + 4) + 4 KC H floats: 102,400 B at
//    H = 64 (two blocks a SM, as K3), 229,376 B at H = 1024.
#include "pagg_tile.cuh"

namespace {

// Launch C's shared bytes at width H: A [4H][LDA], then two chunks of KC
// rows of the [4H, 2H] weight (the [H][LDA] dsel and [H, H] chunks fit inside).
__host__ __device__ constexpr int bptt_smem(int H) {
  return (int)((4 * H * tile_for(H).LDA + 4 * tile_for(H).KC * H) * sizeof(float));
}

// Units 2c, 2c + 1 of row r of a row-major stream of width W at column
// off (the loads' counterpart of store_units): one 8-byte load where H is
// even, else one load per unit held, 0 in a slot without one.
__device__ __forceinline__ float2 load_units(const float* __restrict__ s, long long r, int W,
                                             int off, int H, const int (&jc)[TN],
                                             const bool (&jv)[TN]) {
  const float* p = s + r * W + off;
  if (H % 2 == 0) return *reinterpret_cast<const float2*>(p + jc[0]);
  return make_float2(jv[0] ? p[jc[0]] : 0.0f, jv[1] ? p[jc[1]] : 0.0f);
}

__device__ __forceinline__ float leaky(float s) { return s > 0.0f ? s : 0.01f * s; }

__global__ void pagg_attention_bwd_kernel(
    const float* __restrict__ g, const float* __restrict__ h,
    const int* __restrict__ paths, const float* __restrict__ hn,
    const float* __restrict__ attw, const float* __restrict__ attb,
    float* __restrict__ dhn, float* __restrict__ dego, float* __restrict__ part,
    int nw, int wl, int H) {
  extern __shared__ float sm[];
  float* sc = sm;        // [nw] scores before the leaky relu
  float* at = sc + nw;   // [nw] softmax weights
  float* ds = at + nw;   // [nw] d att, then d score
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const long long b0 = (long long)blockIdx.x * nw;
  const float* gr = g + (long long)blockIdx.x * H;
  for (int p = warp; p < nw; p += nwarps) {
    const float* hr = hn + (b0 + p) * H;
    const float* ego = h + (long long)paths[(b0 + p) * wl] * H;
    float s = 0.0f, da = 0.0f;
    for (int k = lane; k < H; k += 32) {
      s += attw[k] * hr[k] + attw[H + k] * ego[k];
      da += gr[k] * hr[k];
    }
    s = warp_sum(s) + attb[0];
    da = warp_sum(da);
    if (lane == 0) {
      sc[p] = s;
      ds[p] = da;
    }
  }
  __syncthreads();
  if (warp == 0) {
    // softmax over the walks; d score = att (d att - sum att d att) leaky'
    float m = -INFINITY;
    for (int p = lane; p < nw; p += 32) m = fmaxf(m, leaky(sc[p]));
    m = warp_max(m);
    float den = 0.0f;
    for (int p = lane; p < nw; p += 32) den += expf(leaky(sc[p]) - m);
    den = warp_sum(den);
    float dot = 0.0f;
    for (int p = lane; p < nw; p += 32) {
      at[p] = expf(leaky(sc[p]) - m) / den;
      dot += at[p] * ds[p];
    }
    dot = warp_sum(dot);
    for (int p = lane; p < nw; p += 32)
      ds[p] = at[p] * (ds[p] - dot) * (sc[p] > 0.0f ? 1.0f : 0.01f);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nw * H; e += blockDim.x) {
    const int p = e / H, j = e % H;
    dhn[(b0 + p) * H + j] = at[p] * gr[j] + ds[p] * attw[j];
    dego[(b0 + p) * H + j] = ds[p] * attw[H + j];
  }
  // this target's terms of d attw and d attb, summed over its walks in order
  float* pr = part + (long long)blockIdx.x * (2 * H + 1);
  for (int j = threadIdx.x; j < H; j += blockDim.x) {
    float dw = 0.0f, de = 0.0f;
    for (int p = 0; p < nw; ++p) {
      dw += ds[p] * hn[(b0 + p) * H + j];
      de += ds[p] * h[(long long)paths[(b0 + p) * wl] * H + j];
    }
    pr[j] = dw;
    pr[H + j] = de;
  }
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int p = 0; p < nw; ++p) s += ds[p];
    pr[2 * H] = s;
  }
}

template <bool MASKED, int HC>
__global__ void __launch_bounds__(launch_threads(HC), launch_blocks(HC))
pagg_bptt_kernel(const float* __restrict__ dhn,
                 const int* __restrict__ dists, const float* __restrict__ wd_t,
                 const float* __restrict__ w_t, const float* __restrict__ cs,
                 float* __restrict__ gt, const uint8_t* __restrict__ mask, float keep,
                 float* __restrict__ dsel, float* __restrict__ drow, long long B, int wl,
                 int Hrt, bool aligned) {
  constexpr Tile tc = tile_for(HC ? HC : 64);
  const Tile tr = tile_for(Hrt);
  const int H = HC ? HC : Hrt;
  const int CT = HC ? tc.CT : tr.CT;
  const int KC = HC ? tc.KC : tr.KC;
  const int LDA = HC ? tc.LDA : tr.LDA;
  const int M = HC ? tc.M : tr.M;
  const int NT = HC ? tc.NT : tr.NT;
  const bool vec2 = aligned && H % 2 == 0, vec1 = aligned && H % 4 == 0;
  const bool mask2 = H % 2 == 0 && (uintptr_t)mask % 2 == 0;  // mask pairs in one load
  // one division here: a division in the loop calls a slow path that spills
  const float rkeep = 1.0f / keep;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;               // [4H][LDA]: gate gradients, then dsel [H][LDA]
  float* Bs = As + 4 * H * LDA;   // [2][KC][2H] weight chunks
  int r, c, jc[TN];
  bool jv[TN];
  tile_thread(CT, M, H, r, c, jc, jv);
  const int m0 = r * TM;
  const long long b0 = (long long)blockIdx.x * M + m0;
  const long long left = B - b0;  // walks of the launch from b0 on
  // dh, dc and c_t of the thread's walks and units, carried down the steps
  float dhv[TM][TN], dcv[TM][TN], cv[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int u = 0; u < TN; ++u) {
      const bool ok = i < left && jv[u];
      dhv[i][u] = ok ? dhn[(b0 + i) * H + jc[u]] : 0.0f;
      cv[i][u] = ok ? cs[((long long)(wl - 1) * B + b0 + i) * H + jc[u]] : 0.0f;
      dcv[i][u] = 0.0f;
    }

  for (int t = wl - 1; t >= 0; --t) {
    const int pos = wl - 1 - t;
    const long long r0 = (long long)t * B + b0;  // stream row of walk b0
    // gate gradients, rows in halves of 4 so that both units of a row move
    // through global memory in one access: over gt, and into A transposed
#pragma unroll
    for (int ih = 0; ih < TM; ih += 4) {
      float q[TN][4][4];  // [unit][gate][row]
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = ih + ii;
        float2 gv[4] = {}, cp = {};
        if (i < left) {
#pragma unroll
          for (int g = 0; g < 4; ++g) gv[g] = load_units(gt, r0 + i, 4 * H, g * H, H, jc, jv);
          if (t > 0) cp = load_units(cs, r0 - B + i, H, 0, H, jc, jv);
        }
#pragma unroll
        for (int u = 0; u < TN; ++u) {
          const float si = u ? gv[0].y : gv[0].x, sf = u ? gv[1].y : gv[1].x;
          const float tg = u ? gv[2].y : gv[2].x, so = u ? gv[3].y : gv[3].x;
          const float tcv = tanhf(cv[i][u]);
          const float dc = dcv[i][u] + dhv[i][u] * so * (1.0f - tcv * tcv);
          q[u][0][ii] = dc * tg * si * (1.0f - si);
          q[u][1][ii] = dc * (u ? cp.y : cp.x) * sf * (1.0f - sf);
          q[u][2][ii] = dc * si * (1.0f - tg * tg);
          q[u][3][ii] = dhv[i][u] * tcv * so * (1.0f - so);
          dcv[i][u] = dc * sf;
          cv[i][u] = u ? cp.y : cp.x;
        }
        if (i < left) {
#pragma unroll
          for (int g = 0; g < 4; ++g)
            store_units(gt, r0 + i, 4 * H, g * H, H, jc, jv, q[0][g][ii], q[1][g][ii]);
        }
      }
#pragma unroll
      for (int u = 0; u < TN; ++u) {
        if (!jv[u]) continue;
#pragma unroll
        for (int g = 0; g < 4; ++g)
          *reinterpret_cast<float4*>(As + (g * H + jc[u]) * LDA + m0 + ih) =
              make_float4(q[u][g][0], q[u][g][1], q[u][g][2], q[u][g][3]);
      }
    }
    __syncthreads();

    // [d xin | dh_{t-1}] = dgates @ [w_ih; w_hh]^T
    float acc[TM][TN][2];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int u = 0; u < TN; ++u) acc[i][u][0] = acc[i][u][1] = 0.0f;
    tile_gemm<2>(acc, As, LDA, m0, 4 * H, w_t, 4 * H, w_t, Bs, KC, jc, H, NT, vec2);

    // dh_{t-1} stays in registers; d xin, dropped out, is dsel: to its
    // stream and over A (the product ended with a barrier)
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int u = 0; u < TN; ++u) dhv[i][u] = acc[i][u][1];
      if (i >= left) continue;
      if (MASKED) {
        const uint8_t* mr = mask + (r0 + i) * H;
        bool k0, k1;
        if (mask2) {
          const uchar2 mk = *reinterpret_cast<const uchar2*>(mr + jc[0]);
          k0 = mk.x;
          k1 = mk.y;
        } else {
          k0 = mr[jc[0]];
          k1 = mr[jc[1]];
        }
        acc[i][0][0] = k0 ? acc[i][0][0] * rkeep : 0.0f;
        acc[i][1][0] = k1 ? acc[i][1][0] * rkeep : 0.0f;
      }
      store_units(dsel, r0 + i, H, 0, H, jc, jv, acc[i][0][0], acc[i][1][0]);
    }
#pragma unroll
    for (int u = 0; u < TN; ++u) {
      if (!jv[u]) continue;
      float v[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) v[i] = acc[i][u][0];
      store_rows(As + jc[u] * LDA + m0, v);
    }

    // dx = dsel @ wd[d]^T: one product per class present in the tile
    int dq[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      int d = 0;
      if (i < left) {
        d = dists[(b0 + i) * wl + pos];
        d = d < 0 ? 0 : (d > wl - 1 ? wl - 1 : d);
      }
      dq[i] = d;
    }
    float dx[TN][TM];
#pragma unroll
    for (int u = 0; u < TN; ++u)
#pragma unroll
      for (int i = 0; i < TM; ++i) dx[u][i] = 0.0f;
    for (int k = 0; k < wl; ++k) {
      bool mine = false;
#pragma unroll
      for (int i = 0; i < TM; ++i) mine |= dq[i] == k;
      if (!__syncthreads_or(mine)) continue;
      float a1[TM][TN][1];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int u = 0; u < TN; ++u) a1[i][u][0] = 0.0f;
      const float* wk = wd_t + (size_t)k * H * H;
      tile_gemm<1>(a1, As, LDA, m0, H, wk, H, wk, Bs, KC, jc, H, NT, vec1);
#pragma unroll
      for (int u = 0; u < TN; ++u)
#pragma unroll
        for (int i = 0; i < TM; ++i)
          if (dq[i] == k) dx[u][i] = a1[i][u][0];
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
      if (i < left) store_units(drow, r0 + i, H, 0, H, jc, jv, dx[0][i], dx[1][i]);
  }
}

template <typename Kernel>
int allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   bytes);
}

}  // namespace

// Launch A: h_n [T * nw, H] and the streams xr, xin, hp, cs [wl, T * nw, H]
// and gt [wl, T * nw, 4H].
extern "C" int pathnet_pagg_encode_walks_streams(
    const void* h, const void* paths, const void* dists, const void* wd,
    const void* bd, const void* w_ih, const void* w_hh, const void* b_ih,
    const void* b_hh, const void* mask, float keep, void* hn, void* xr, void* xin,
    void* hp, void* cs, void* gt, int T, int nw, int wl, int H, void* stream) {
  const long long B = (long long)T * nw;
  if (B == 0) return 0;
  const Tile tl = tile_for(H);
  auto kernel = H == 64    ? (mask ? pagg_encode_walks_kernel<true, 64, true>
                                   : pagg_encode_walks_kernel<false, 64, true>)
                : H == 256 ? (mask ? pagg_encode_walks_kernel<true, 256, true>
                                   : pagg_encode_walks_kernel<false, 256, true>)
                           : (mask ? pagg_encode_walks_kernel<true, 0, true>
                                   : pagg_encode_walks_kernel<false, 0, true>);
  if (int e = allow_smem(kernel, tl.smem)) return e;
  const Streams st = {(float*)xr, (float*)xin, (float*)hp, (float*)cs, (float*)gt};
  kernel<<<(unsigned)((B + tl.M - 1) / tl.M), tl.NT, tl.smem, (cudaStream_t)stream>>>(
      (const float*)h, (const int*)paths, (const int*)dists, (const float*)wd,
      (const float*)bd, (const float*)w_ih, (const float*)w_hh,
      (const float*)b_ih, (const float*)b_hh, (const uint8_t*)mask, keep,
      (float*)hn, st, B, wl, H,
      ((uintptr_t)wd | (uintptr_t)w_ih | (uintptr_t)w_hh) % 16 == 0);
  return (int)cudaGetLastError();
}

// Launch B: d h_n [T * nw, H] from g [T, H] and h_n; writes the ego rows'
// gradient dego [T * nw, H] and each target's terms of the attention
// weights' gradient, part [T, 2H + 1] (d attw, then d attb).
extern "C" int pathnet_pagg_attention_bwd(
    const void* g, const void* h, const void* paths, const void* hn,
    const void* attw, const void* attb, void* dhn, void* dego, void* part,
    int T, int nw, int wl, int H, void* stream) {
  if (T == 0) return 0;
  const int smem = 3 * nw * (int)sizeof(float);
  if (int e = allow_smem(pagg_attention_bwd_kernel, smem)) return e;
  pagg_attention_bwd_kernel<<<T, H > 128 ? 256 : 128, smem, (cudaStream_t)stream>>>(
      (const float*)g, (const float*)h, (const int*)paths, (const float*)hn,
      (const float*)attw, (const float*)attb, (float*)dhn, (float*)dego,
      (float*)part, nw, wl, H);
  return (int)cudaGetLastError();
}

// Launch C: BPTT from d h_n; overwrites gt with the pre-activation gate
// gradients and writes dsel and every gathered row's gradient drow, both
// [wl, T * nw, H]. wd_t = wd transposed per class [wl, H, H]; w_t =
// [w_ih; w_hh]^T [4H, 2H].
extern "C" int pathnet_pagg_bptt(const void* dhn, const void* dists,
                                 const void* wd_t, const void* w_t, const void* cs,
                                 void* gt, const void* mask, float keep, void* dsel,
                                 void* drow, int T, int nw, int wl, int H, void* stream) {
  const long long B = (long long)T * nw;
  if (B == 0) return 0;
  const Tile tl = tile_for(H);
  const int smem = bptt_smem(H);
  auto kernel = H == 64    ? (mask ? pagg_bptt_kernel<true, 64> : pagg_bptt_kernel<false, 64>)
                : H == 256 ? (mask ? pagg_bptt_kernel<true, 256> : pagg_bptt_kernel<false, 256>)
                           : (mask ? pagg_bptt_kernel<true, 0> : pagg_bptt_kernel<false, 0>);
  if (int e = allow_smem(kernel, smem)) return e;
  kernel<<<(unsigned)((B + tl.M - 1) / tl.M), tl.NT, smem, (cudaStream_t)stream>>>(
      (const float*)dhn, (const int*)dists, (const float*)wd_t,
      (const float*)w_t, (const float*)cs, (float*)gt, (const uint8_t*)mask, keep,
      (float*)dsel, (float*)drow, B, wl, H,
      ((uintptr_t)wd_t | (uintptr_t)w_t) % 16 == 0);
  return (int)cudaGetLastError();
}
