// K4's launch C, pagg_bptt_kernel, and its launch: BPTT on K3's walk tile.
// Shared by pagg_encode_bwd.cu (the LSTM instances, f32 and bf16),
// pagg_encode_bwd_gru.cu (the GRU's) and pagg_encode_bwd_mlp.cu (the
// MLP's), which nvcc builds side by side; the design is described in
// pagg_encode_bwd.cu.
#pragma once
#include "pagg_tile.cuh"

// Launch C's GRU and MLP instances, f32 and (bf16 nonzero) bf16, compiled in
// pagg_encode_bwd_gru.cu and pagg_encode_bwd_mlp.cu; the other arguments
// are launch_bptt's.
#define PAGG_BPTT_SET_ARGS                                                                  \
  int bf16, const void *dhn, const void *dists, const void *wd_t, const void *w_t,         \
      const void *cs, void *gt, const void *mask, float keep, const void *xin,             \
      const void *ego, const void *dego, void *dsel, void *drow, long long B, int wl,      \
      int H, void *stream
int pagg_bptt_gru(PAGG_BPTT_SET_ARGS);
int pagg_bptt_mlp(PAGG_BPTT_SET_ARGS);

namespace {
// Launch C's shared bytes at width H: A [4H][LDA] in f32, then two chunks of
// KC rows of the [4H, 2H] weight (the [H][LDA] dsel and [H, H] chunks fit
// inside); bf16, the tensor-core tile's (bf16_smem).
__host__ __device__ constexpr int bptt_smem(int H, bool bf16 = false) {
  return bf16 ? bf16_smem(H, tile_for(H, true).M, tile_for(H, true).NT, true)
              : (int)(4 * H * tile_for(H).LDA * sizeof(float) + 4 * tile_for(H).KC * H * 4);
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

// HOMO also reads xin and ego (launch A's) and, with DEGO (the attention
// readout), dego (launch B's); BF16 takes the weights as bf16 and multiplies
// on the tensor cores, A's f32 cotangents split into bf16 hi and lo halves
// (pagg_tile.cuh); CELL = GRU_CELL runs the GRU's BPTT, cs then being the hp
// stream; CELL = MLP_CELL the MLP's pass (w_t = W^T [H, H]; cs and gt not
// read). `align` is the alignment of wd_t and w_t in bytes.
template <bool MASKED, int HC, bool HOMO, bool BF16, int CELL = LSTM_CELL, bool DEGO = true>
__global__ void __launch_bounds__(launch_threads(HC), launch_blocks(HC))
pagg_bptt_kernel(const float* __restrict__ dhn,
                 const int* __restrict__ dists, const Elem<BF16>* __restrict__ wd_t,
                 const Elem<BF16>* __restrict__ w_t, const float* __restrict__ cs,
                 float* __restrict__ gt, const uint8_t* __restrict__ mask, float keep,
                 const float* __restrict__ xin, const float* __restrict__ ego,
                 const float* __restrict__ dego, float* __restrict__ dsel,
                 float* __restrict__ drow, long long B, int wl, int Hrt, int align) {
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
  const int mode2 = copy_mode<W>(2 * H, align), mode1 = copy_mode<W>(H, align);
  const bool mask2 = H % 2 == 0 && (uintptr_t)mask % 2 == 0;  // mask pairs in one load
  // one division here: a division in the loop calls a slow path that spills
  const float rkeep = 1.0f / keep;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;               // [4H][LDA]: gate gradients, then dsel [H][LDA]
  W* Bs = reinterpret_cast<W*>(As + 4 * H * LDA);  // [2][KC][2H] weight chunks
  // BF16: A as its bf16 halves hi and lo, [roundup(4H, 16)][LDA] each, then
  // mma_gemm's chunks and C tiles
  auto* Ahi = reinterpret_cast<__nv_bfloat16*>(smem);
  auto* Alo = Ahi + round_up(4 * H, 16) * LDA;
  void* region = Alo + round_up(4 * H, 16) * LDA;
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
    // A's rows past 4H (the MLP: past H, its products' K) to a multiple of
    // 16 meet zero weight rows: finite
    const int k0 = MLP ? H : 4 * H;
    const int pad = (round_up(k0, 16) - k0) * LDA;
    for (int e = threadIdx.x; e < pad; e += NT)
      Ahi[k0 * LDA + e] = Alo[k0 * LDA + e] = __float2bfloat16_rn(0.0f);
  }
  const long long left = B - b0;  // walks of the launch from b0 on
  // dh, dc and c_t of the thread's walks and units, carried down the steps
  // (the GRU: dh, and in dcv the direct term z dh of the step; the MLP: in
  // dcv the step's d s, the same for every step)
  float dhv[TM][TN], dcv[TM][TN], cv[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int u = 0; u < TN; ++u) {
      const bool ok = i < left && jv[u];
      dhv[i][u] = ok ? dhn[(b0 + i) * H + jc[u]] : 0.0f;
      cv[i][u] = ok && !GRU && !MLP ? cs[((long long)(wl - 1) * B + b0 + i) * H + jc[u]] : 0.0f;
      dcv[i][u] = 0.0f;
    }
  if constexpr (MLP) {
    // d s = (d h_n W^T) / wl: d h_n to A transposed (BF16: its hi and lo
    // halves), one product
#pragma unroll
    for (int u = 0; u < TN; ++u) {
      if (!jv[u]) continue;
      float v[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) v[i] = dhv[i][u];
      if constexpr (BF16) {
        const int e = jc[u] * LDA + m0;
        store_split4(Ahi + e, Alo + e, v[0], v[1], v[2], v[3]);
        store_split4(Ahi + e + 4, Alo + e + 4, v[4], v[5], v[6], v[7]);
      } else {
        store_rows(As + jc[u] * LDA + m0, v);
      }
    }
    __syncthreads();
    float a1[TM][TN][1];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int u = 0; u < TN; ++u) a1[i][u][0] = 0.0f;
    if constexpr (BF16)
      mma_gemm<1, mma_tiles(HC)>(a1, Ahi, Alo, LDA, Mp, m0, H, w_t, H, w_t, nullptr, nullptr,
                                 region, jc, jv, H, NT, mode1);
    else
      tile_gemm<1>(a1, As, LDA, m0, H, w_t, H, w_t, Bs, KC, jc, H, NT, mode1);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int u = 0; u < TN; ++u) dcv[i][u] = a1[i][u][0] / wl;
  }

  for (int t = wl - 1; t >= 0; --t) {
    const int pos = HOMO ? t : wl - 1 - t;
    const long long r0 = (long long)t * B + b0;  // stream row of walk b0
    float acc[TM][TN][2];
    if constexpr (MLP) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int u = 0; u < TN; ++u) acc[i][u][0] = dcv[i][u];
    } else {
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
            if (GRU)  // h_{t-1}
              cp = load_units(cs, r0 + i, H, 0, H, jc, jv);
            else if (t > 0)
              cp = load_units(cs, r0 - B + i, H, 0, H, jc, jv);
          }
#pragma unroll
          for (int u = 0; u < TN; ++u) {
            if constexpr (GRU) {
              const float r = u ? gv[0].y : gv[0].x, z = u ? gv[1].y : gv[1].x;
              const float n = u ? gv[2].y : gv[2].x, a3 = u ? gv[3].y : gv[3].x;
              const float dh = dhv[i][u];
              const float da = dh * (1.0f - z) * (1.0f - n * n);
              q[u][0][ii] = da * a3 * r * (1.0f - r);
              q[u][1][ii] = dh * ((u ? cp.y : cp.x) - n) * z * (1.0f - z);
              q[u][2][ii] = da;
              q[u][3][ii] = da * r;
              dcv[i][u] = dh * z;
              continue;
            }
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
          for (int g = 0; g < 4; ++g) {
            if constexpr (BF16) {
              const int e = (g * H + jc[u]) * LDA + m0 + ih;
              store_split4(Ahi + e, Alo + e, q[u][g][0], q[u][g][1], q[u][g][2], q[u][g][3]);
            } else {
              *reinterpret_cast<float4*>(As + (g * H + jc[u]) * LDA + m0 + ih) =
                  make_float4(q[u][g][0], q[u][g][1], q[u][g][2], q[u][g][3]);
            }
          }
        }
      }
      __syncthreads();

      // [d xin | dh_{t-1}] = dgates @ [w_ih; w_hh]^T
      if constexpr (BF16) {
        mma_gemm<2, mma_tiles(HC)>(acc, Ahi, Alo, LDA, Mp, m0, 4 * H, w_t, 4 * H, w_t, nullptr,
                                   nullptr, region, jc, jv, H, NT, mode1);
      } else {
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int u = 0; u < TN; ++u) acc[i][u][0] = acc[i][u][1] = 0.0f;
        tile_gemm<2>(acc, As, LDA, m0, 4 * H, w_t, 4 * H, w_t, Bs, KC, jc, H, NT, mode2);
      }
    }

    // dh_{t-1} stays in registers (the GRU adds its direct term); d xin (the
    // MLP: d s), dropped out, is dsel: to its stream and over A (the product,
    // or the last step's select products, ended with a barrier)
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      if constexpr (!MLP) {
#pragma unroll
        for (int u = 0; u < TN; ++u) dhv[i][u] = GRU ? acc[i][u][1] + dcv[i][u] : acc[i][u][1];
      }
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
      if constexpr (HOMO) {
        // step 0 also takes the ego row's gradient; then the ReLU's derivative,
        // the sign of s read from the ego row (step 0) or from xin (see above)
        const float2 sgn = t == 0 ? load_units(ego, b0 + i, H, 0, H, jc, jv)
                                  : load_units(xin, r0 + i, H, 0, H, jc, jv);
        if (DEGO && t == 0) {  // no dego under the mean and sum readouts
          const float2 de = load_units(dego, b0 + i, H, 0, H, jc, jv);
          acc[i][0][0] += de.x;
          acc[i][1][0] += de.y;
        }
        acc[i][0][0] = sgn.x > 0.0f ? acc[i][0][0] : 0.0f;
        acc[i][1][0] = sgn.y > 0.0f ? acc[i][1][0] : 0.0f;
      }
      store_units(dsel, r0 + i, H, 0, H, jc, jv, acc[i][0][0], acc[i][1][0]);
    }
#pragma unroll
    for (int u = 0; u < TN; ++u) {
      if (!jv[u]) continue;
      float v[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) v[i] = acc[i][u][0];
      if constexpr (BF16) {
        const int e = jc[u] * LDA + m0;
        store_split4(Ahi + e, Alo + e, v[0], v[1], v[2], v[3]);
        store_split4(Ahi + e + 4, Alo + e + 4, v[4], v[5], v[6], v[7]);
      } else {
        store_rows(As + jc[u] * LDA + m0, v);
      }
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
      const W* wk = wd_t + (size_t)k * H * H;
      if constexpr (BF16)
        mma_gemm<1, mma_tiles(HC)>(a1, Ahi, Alo, LDA, Mp, m0, H, wk, H, wk, nullptr, nullptr,
                                   region, jc, jv, H, NT, mode1);
      else
        tile_gemm<1>(a1, As, LDA, m0, H, wk, H, wk, Bs, KC, jc, H, NT, mode1);
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

template <bool BF16>
using BpttKernel = void (*)(const float*, const int*, const Elem<BF16>*, const Elem<BF16>*,
                            const float*, float*, const uint8_t*, float, const float*,
                            const float*, const float*, float*, float*, long long, int, int,
                            int);

// The homo instances without d ego (the mean and sum readouts) are apart
// (DEGO false), so the attention instances are the code they were.
template <int HC, bool BF16, int CELL = LSTM_CELL>
BpttKernel<BF16> bptt_instance(bool masked, bool homo, bool dego) {
  if (homo && !dego)
    return masked ? pagg_bptt_kernel<true, HC, true, BF16, CELL, false>
                  : pagg_bptt_kernel<false, HC, true, BF16, CELL, false>;
  return masked ? (homo ? pagg_bptt_kernel<true, HC, true, BF16, CELL>
                        : pagg_bptt_kernel<true, HC, false, BF16, CELL>)
                : (homo ? pagg_bptt_kernel<false, HC, true, BF16, CELL>
                        : pagg_bptt_kernel<false, HC, false, BF16, CELL>);
}

// Launch C at width H: f32, the instance with the tile compiled in where
// there is one (H = 64, 256; the GRU and the MLP, 64); bf16, H = 64, 32 or
// the run-time one.
template <bool BF16, int CELL>
int launch_bptt(const void* dhn, const void* dists, const void* wd_t, const void* w_t,
                const void* cs, void* gt, const void* mask, float keep, const void* xin,
                const void* ego, const void* dego, void* dsel, void* drow, long long B,
                int wl, int H, void* stream) {
  using W = Elem<BF16>;
  const Tile tl = tile_for(H, BF16);
  const int smem = bptt_smem(H, BF16);
  const bool masked = mask != nullptr, homo = ego != nullptr, de = dego != nullptr;
  // a named type, not one deduced from an instance: deducing it would
  // compile the f32 LSTM instances into the GRU's translation unit too
  BpttKernel<BF16> kernel;
  if constexpr (BF16)
    kernel = H == 64   ? bptt_instance<64, true, CELL>(masked, homo, de)
             : H == 32 ? bptt_instance<32, true, CELL>(masked, homo, de)
                       : bptt_instance<0, true, CELL>(masked, homo, de);
  else if constexpr (CELL != LSTM_CELL)
    kernel = H == 64 ? bptt_instance<64, false, CELL>(masked, homo, de)
                     : bptt_instance<0, false, CELL>(masked, homo, de);
  else
    kernel = H == 64    ? bptt_instance<64, false>(masked, homo, de)
             : H == 256 ? bptt_instance<256, false>(masked, homo, de)
                        : bptt_instance<0, false>(masked, homo, de);
  if (int e = allow_smem(kernel, smem)) return e;
  kernel<<<(unsigned)((B + tl.M - 1) / tl.M), tl.NT, smem, (cudaStream_t)stream>>>(
      (const float*)dhn, (const int*)dists, (const W*)wd_t, (const W*)w_t, (const float*)cs,
      (float*)gt, (const uint8_t*)mask, keep, (const float*)xin, (const float*)ego,
      (const float*)dego, (float*)dsel, (float*)drow, B, wl, H,
      alignment((uintptr_t)wd_t | (uintptr_t)w_t));
  return (int)cudaGetLastError();
}

// One cell's launch C set (see PAGG_BPTT_SET_ARGS): the f32 or the bf16
// instances by bf16.
template <int CELL>
int launch_bptt_set(PAGG_BPTT_SET_ARGS) {
  return (bf16 ? launch_bptt<true, CELL> : launch_bptt<false, CELL>)(
      dhn, dists, wd_t, w_t, cs, gt, mask, keep, xin, ego, dego, dsel, drow, B, wl, H, stream);
}

}  // namespace
