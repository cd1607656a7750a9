// K4: PAGG encode backward for the hetero / LSTM / attention model, f32.
//
// Replaces the VJP of pathnet_tpu/models/pagg.py:235-303 (the encode block
// and attention readout that K3 computes), with the gather VJP of the "h"
// gather mode (pagg.py:83-93): given g = d h_agg [T, H] it returns
// dh [n, H] (every gathered row's gradient scattered with atomicAdd, the
// ego rows included) and dattw, dattb, and writes the per-row streams from
// which the caller contracts the weight gradients (dW_ih = xin^T dgates,
// dW_hh = hprev^T dgates, dwd[k] = sum over rows with d = k of xr^T dsel).
//
// One block per target, threads (j, g) as in K3: unit j of PB walks of group
// g. Phase A recomputes the forward of all nw walks with K3's own code
// (lstm_group_fwd in pagg_lstm.cuh, the natural remat: no activation is kept
// between K3 and K4) and writes, per walk step, the gathered row xr, the LSTM
// input xin (after dropout), h_{t-1}, c_t and the four gate activations; the
// final h_n of every walk stays in shared memory.
// Phase B is the attention backward: softmax over nw of leaky-relu scores,
// into d h_n and the ego rows' gradient. Phase C runs BPTT per group of walks
// from those streams, overwrites the gate activations with the gradients of
// the pre-activation gates, applies the dropout mask, the distance
// transform's input gradient dx = dsel wd[d]^T, and scatters dx into dh.
// Bound on the H100: f32 FMA work, about 54 H^2 flops per walk step (forward
// recompute, backward products and weight-gradient contractions), about
// 4.3 ms per 8192-target bgp microbatch at 67 TFLOP/s.
#include "pagg_lstm.cuh"

template <bool MASKED>
__global__ void pagg_encode_bwd_kernel(
    const float* __restrict__ gin, const float* __restrict__ h,
    const int* __restrict__ paths, const int* __restrict__ dists,
    const float* __restrict__ wd, const float* __restrict__ wd_t,
    const float* __restrict__ bd, const float* __restrict__ w_ih,
    const float* __restrict__ w_hh, const float* __restrict__ w_ih_t,
    const float* __restrict__ w_hh_t, const float* __restrict__ b_ih,
    const float* __restrict__ b_hh, const float* __restrict__ attw,
    const float* __restrict__ attb, const uint8_t* __restrict__ mask,
    float keep, float* __restrict__ dh, float* __restrict__ dattw,
    float* __restrict__ dattb, float* __restrict__ xr, float* __restrict__ xin,
    float* __restrict__ hp, float* __restrict__ cs, float* __restrict__ gt,
    float* __restrict__ dsel, int nw, int wl, int H, int NG) {
  extern __shared__ float smem[];
  const int P = NG * PB;
  // phase A uses xs, ss, hs; phase C uses dG and dS over the same floats
  float* xs = smem;            // [P][H]
  float* ss = xs + P * H;      // [P][H]
  float* hs = ss + P * H;      // [P][H]
  float* dG = smem;            // [P][4H]
  float* dS = dG + 4 * P * H;  // [P][H]
  float* hn = smem + 5 * P * H;  // [nw][H] final hidden states
  float* dhn = hn + nw * H;    // [nw][H] their gradients
  float* gs = dhn + nw * H;    // [H] d h_agg of this target
  float* sc = gs + H;          // [nw] scores before the leaky relu
  float* at = sc + nw;         // [nw] attention weights
  float* ds = at + nw;         // [nw] d att, then d score
  float* red = ds + nw;        // [1]
  const int j = threadIdx.x % H;
  const int g = threadIdx.x / H;
  const int H4 = 4 * H;
  const long long B = (long long)gridDim.x * nw;
  const long long b0 = (long long)blockIdx.x * nw;
  const int* tp = paths + b0 * wl;
  const int* td = dists + b0 * wl;

  // ---- phase A: forward of every walk, streams written per step ----
  const LstmStreams st = {xr, xin, hp, cs, gt};
  for (int p0 = 0; p0 < nw; p0 += P) {
    lstm_group_fwd<MASKED, true>(p0, h, tp, td, wd, bd, w_ih, w_hh, b_ih, b_hh,
                                 mask, keep, st, xs, ss, hs, hn, nw, wl, H, j,
                                 g, B, b0);
    __syncthreads();
  }

  // ---- phase B: attention backward ----
  if (threadIdx.x < H) gs[threadIdx.x] = gin[(long long)blockIdx.x * H + threadIdx.x];
  for (int p = threadIdx.x; p < nw; p += blockDim.x) {
    const float* ego = h + (long long)tp[p * wl] * H;
    float s = attb[0];
    for (int k = 0; k < H; ++k) s += attw[k] * hn[p * H + k] + attw[H + k] * ego[k];
    sc[p] = s;
  }
  __syncthreads();
  for (int p = threadIdx.x; p < nw; p += blockDim.x) {
    float m = sc[0] > 0.0f ? sc[0] : 0.01f * sc[0];
    for (int q = 1; q < nw; ++q) {
      const float z = sc[q] > 0.0f ? sc[q] : 0.01f * sc[q];
      m = fmaxf(m, z);
    }
    float den = 0.0f;
    for (int q = 0; q < nw; ++q) {
      const float z = sc[q] > 0.0f ? sc[q] : 0.01f * sc[q];
      den += expf(z - m);
    }
    const float z = sc[p] > 0.0f ? sc[p] : 0.01f * sc[p];
    at[p] = expf(z - m) / den;
    float datt = 0.0f;   // d att_p = g . h_n,p
    for (int k = 0; k < H; ++k) datt += gs[k] * hn[p * H + k];
    ds[p] = datt;
  }
  __syncthreads();
  if (threadIdx.x == 0) {   // sum over walks of att_q * d att_q
    float s = 0.0f;
    for (int q = 0; q < nw; ++q) s += at[q] * ds[q];
    red[0] = s;
  }
  __syncthreads();
  for (int p = threadIdx.x; p < nw; p += blockDim.x)
    ds[p] = at[p] * (ds[p] - red[0]) * (sc[p] > 0.0f ? 1.0f : 0.01f);
  __syncthreads();
  for (int p = g; p < nw; p += NG) {
    dhn[p * H + j] = at[p] * gs[j] + ds[p] * attw[j];
    atomicAdd(dh + (long long)tp[p * wl] * H + j, ds[p] * attw[H + j]);
  }
  if (g == 0) {
    float a = 0.0f, e = 0.0f;
    for (int p = 0; p < nw; ++p) {
      a += ds[p] * hn[p * H + j];
      e += ds[p] * h[(long long)tp[p * wl] * H + j];
    }
    atomicAdd(dattw + j, a);
    atomicAdd(dattw + H + j, e);
  }
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int p = 0; p < nw; ++p) s += ds[p];
    atomicAdd(dattb, s);
  }
  __syncthreads();

  // ---- phase C: BPTT per group of walks ----
  for (int p0 = 0; p0 < nw; p0 += P) {
    float dhq[PB], dcq[PB];
#pragma unroll
    for (int q = 0; q < PB; ++q) {
      const int p = p0 + g * PB + q;
      dhq[q] = p < nw ? dhn[p * H + j] : 0.0f;
      dcq[q] = 0.0f;
    }
    for (int t = wl - 1; t >= 0; --t) {
#pragma unroll
      for (int q = 0; q < PB; ++q) {
        const int slot = g * PB + q;
        const int p = p0 + slot;
        float* dgs = dG + slot * H4 + j;
        if (p < nw) {
          const long long r = (long long)t * B + b0 + p;
          float* gr = gt + r * H4 + j;
          const float si = gr[0], sf = gr[H], tg = gr[2 * H], so = gr[3 * H];
          const float c = cs[r * H + j];
          const float cp = t > 0 ? cs[(r - B) * H + j] : 0.0f;
          const float tc = tanhf(c);
          const float dc = dcq[q] + dhq[q] * so * (1.0f - tc * tc);
          const float di = dc * tg * si * (1.0f - si);
          const float df = dc * cp * sf * (1.0f - sf);
          const float dg = dc * si * (1.0f - tg * tg);
          const float dout = dhq[q] * tc * so * (1.0f - so);
          dcq[q] = dc * sf;
          gr[0] = di;
          gr[H] = df;
          gr[2 * H] = dg;
          gr[3 * H] = dout;
          dgs[0] = di;
          dgs[H] = df;
          dgs[2 * H] = dg;
          dgs[3 * H] = dout;
        } else {
          dgs[0] = 0.0f;
          dgs[H] = 0.0f;
          dgs[2 * H] = 0.0f;
          dgs[3 * H] = 0.0f;
        }
      }
      __syncthreads();
      float ah[PB], ax[PB];
#pragma unroll
      for (int q = 0; q < PB; ++q) {
        ah[q] = 0.0f;
        ax[q] = 0.0f;
      }
      for (int k = 0; k < H4; ++k) {
        const float wh = w_hh_t[(long long)k * H + j];
        const float wi = w_ih_t[(long long)k * H + j];
#pragma unroll
        for (int q = 0; q < PB; ++q) {
          const float a = dG[(g * PB + q) * H4 + k];
          ah[q] += wh * a;
          ax[q] += wi * a;
        }
      }
      int dq[PB];
#pragma unroll
      for (int q = 0; q < PB; ++q) {
        const int p = p0 + g * PB + q;
        dhq[q] = ah[q];
        float v = ax[q];
        int d = 0;
        if (p < nw) {
          const long long r = ((long long)t * B + b0 + p) * H + j;
          if (MASKED) v = mask[r] ? v / keep : 0.0f;
          dsel[r] = v;
          d = td[p * wl + (wl - 1 - t)];
          d = d < 0 ? 0 : (d > wl - 1 ? wl - 1 : d);
        } else {
          v = 0.0f;
        }
        dq[q] = d;
        dS[(g * PB + q) * H + j] = v;
      }
      __syncthreads();
      float dx[PB];
#pragma unroll
      for (int q = 0; q < PB; ++q) dx[q] = 0.0f;
      for (int k = 0; k < H; ++k) {
#pragma unroll
        for (int q = 0; q < PB; ++q)
          dx[q] += wd_t[((long long)dq[q] * H + k) * H + j] * dS[(g * PB + q) * H + k];
      }
#pragma unroll
      for (int q = 0; q < PB; ++q) {
        const int p = p0 + g * PB + q;
        if (p < nw)
          atomicAdd(dh + (long long)tp[p * wl + (wl - 1 - t)] * H + j, dx[q]);
      }
      __syncthreads();
    }
  }
}

extern "C" int pathnet_pagg_encode_bwd(
    const void* g, const void* h, const void* paths, const void* dists,
    const void* wd, const void* wd_t, const void* bd, const void* w_ih,
    const void* w_hh, const void* w_ih_t, const void* w_hh_t, const void* b_ih,
    const void* b_hh, const void* attw, const void* attb, const void* mask,
    float keep, void* dh, void* dattw, void* dattb, void* xr, void* xin,
    void* hp, void* cs, void* gt, void* dsel, int T, int nw, int wl, int H,
    void* stream) {
  if (T == 0) return 0;
  const int NG = H >= 256 ? 1 : 256 / H;
  const int P = NG * PB;
  const size_t smem =
      ((size_t)5 * P * H + (size_t)2 * nw * H + H + 3 * (size_t)nw + 1) * sizeof(float);
  auto kernel = mask ? pagg_encode_bwd_kernel<true> : pagg_encode_bwd_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<T, NG * H, smem, (cudaStream_t)stream>>>(
      (const float*)g, (const float*)h, (const int*)paths, (const int*)dists,
      (const float*)wd, (const float*)wd_t, (const float*)bd,
      (const float*)w_ih, (const float*)w_hh, (const float*)w_ih_t,
      (const float*)w_hh_t, (const float*)b_ih, (const float*)b_hh,
      (const float*)attw, (const float*)attb, (const uint8_t*)mask, keep,
      (float*)dh, (float*)dattw, (float*)dattb, (float*)xr, (float*)xin,
      (float*)hp, (float*)cs, (float*)gt, (float*)dsel, nw, wl, H, NG);
  return (int)cudaGetLastError();
}
