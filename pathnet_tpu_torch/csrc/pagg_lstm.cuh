// The LSTM forward of one group of walks, used only by K4's forward
// recompute (pagg_encode_bwd.cu). K3 (pagg_encode.cu) no longer calls it: it
// runs its own tiled forward, walk tiles across targets.
//
// Per walk step t (hetero: far -> near, pathnet_tpu/models/pagg.py:235-303):
//   x_t   = h[paths[wl-1-t]]
//   s_t   = x_t @ W[d] + b[d],  d = clip(dists[wl-1-t], 0, wl-1)
//   s_t   = mask ? s_t / keep : 0                       (MASKED, pagg.py:274)
//   gates = s_t @ w_ih + b_ih + h_{t-1} @ w_hh + b_hh   (i, f, g, o)
//   c_t = f c_{t-1} + i g,  h_t = o tanh(c_t)
// Thread (j, g) owns hidden unit j of PB walks of path group g, so each
// weight element it loads from L1/L2 serves PB walks, and the four gates of
// unit j meet in its registers with no exchange. The gathered rows xs, the
// selected inputs ss and the hidden states hs live in shared memory ([P][H]
// each, P = NG * PB walks in flight); the final hidden state of walk p goes
// to hn[p]. With STREAMS, the step's values that K4's BPTT reads are written
// to global memory, row (t * B + b) with b the walk's global index: the
// gathered row xr, the LSTM input xin, h_{t-1} as hp, c_t as cs and the gate
// activations (sigmoid i, sigmoid f, tanh g, sigmoid o) as gt [.., 4H].
// Both flags are template arguments, so the serving instance carries none of
// this code.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#define PB 4  // walks per thread (register blocking over the weights)

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

struct LstmStreams {
  float* xr;
  float* xin;
  float* hp;
  float* cs;
  float* gt;
};

// Walks p0 .. p0 + P - 1 of the target whose paths and dists start at tp, td
// (b0 = its first walk's global index, B = walks in the launch). Ends after
// the last step's cell update; the caller synchronises before reading hn.
template <bool MASKED, bool STREAMS>
__device__ __forceinline__ void lstm_group_fwd(
    int p0, const float* __restrict__ h, const int* __restrict__ tp,
    const int* __restrict__ td, const float* __restrict__ wd,
    const float* __restrict__ bd, const float* __restrict__ w_ih,
    const float* __restrict__ w_hh, const float* __restrict__ b_ih,
    const float* __restrict__ b_hh, const uint8_t* __restrict__ mask,
    float keep, LstmStreams st, float* xs, float* ss, float* hs, float* hn,
    int nw, int wl, int H, int j, int g, long long B, long long b0) {
  const int H4 = 4 * H;
  float c[PB], hq[PB];
#pragma unroll
  for (int q = 0; q < PB; ++q) {
    c[q] = 0.0f;
    hq[q] = 0.0f;
    hs[(g * PB + q) * H + j] = 0.0f;
  }
  for (int t = 0; t < wl; ++t) {
    const int pos = wl - 1 - t;
    int dq[PB];
#pragma unroll
    for (int q = 0; q < PB; ++q) {
      const int slot = g * PB + q;
      const int p = p0 + slot;
      float x = 0.0f;
      int d = 0;
      if (p < nw) {
        const int v = tp[p * wl + pos];
        d = td[p * wl + pos];
        d = d < 0 ? 0 : (d > wl - 1 ? wl - 1 : d);
        x = h[(long long)v * H + j];
        if (STREAMS) {
          const long long r = ((long long)t * B + b0 + p) * H + j;
          st.xr[r] = x;
          st.hp[r] = hq[q];
        }
      }
      dq[q] = d;
      xs[slot * H + j] = x;
    }
    __syncthreads();
    float acc[PB];
#pragma unroll
    for (int q = 0; q < PB; ++q) acc[q] = bd[dq[q] * H + j];
    for (int k = 0; k < H; ++k) {
#pragma unroll
      for (int q = 0; q < PB; ++q)
        acc[q] += xs[(g * PB + q) * H + k] *
                  wd[((long long)dq[q] * H + k) * H + j];
    }
#pragma unroll
    for (int q = 0; q < PB; ++q) {
      const int p = p0 + g * PB + q;
      if ((MASKED || STREAMS) && p < nw) {
        const long long r = ((long long)t * B + b0 + p) * H + j;
        if (MASKED) acc[q] = mask[r] ? acc[q] / keep : 0.0f;
        if (STREAMS) st.xin[r] = acc[q];
      }
      ss[(g * PB + q) * H + j] = acc[q];
    }
    __syncthreads();
    float gi[PB], gf[PB], gg[PB], go[PB];
    const float bi = b_ih[j] + b_hh[j];
    const float bf = b_ih[H + j] + b_hh[H + j];
    const float bg = b_ih[2 * H + j] + b_hh[2 * H + j];
    const float bo = b_ih[3 * H + j] + b_hh[3 * H + j];
#pragma unroll
    for (int q = 0; q < PB; ++q) {
      gi[q] = bi;
      gf[q] = bf;
      gg[q] = bg;
      go[q] = bo;
    }
    for (int k = 0; k < H; ++k) {
      const float* wi = w_ih + (long long)k * H4 + j;
      const float* wh = w_hh + (long long)k * H4 + j;
      const float wi0 = wi[0], wi1 = wi[H], wi2 = wi[2 * H], wi3 = wi[3 * H];
      const float wh0 = wh[0], wh1 = wh[H], wh2 = wh[2 * H], wh3 = wh[3 * H];
#pragma unroll
      for (int q = 0; q < PB; ++q) {
        const float a = ss[(g * PB + q) * H + k];
        const float b = hs[(g * PB + q) * H + k];
        gi[q] += a * wi0 + b * wh0;
        gf[q] += a * wi1 + b * wh1;
        gg[q] += a * wi2 + b * wh2;
        go[q] += a * wi3 + b * wh3;
      }
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < PB; ++q) {
      const float si = sigmoid_f(gi[q]), sf = sigmoid_f(gf[q]);
      const float tg = tanhf(gg[q]), so = sigmoid_f(go[q]);
      c[q] = sf * c[q] + si * tg;
      hq[q] = so * tanhf(c[q]);
      hs[(g * PB + q) * H + j] = hq[q];
      const int p = p0 + g * PB + q;
      if (STREAMS && p < nw) {
        const long long r = (long long)t * B + b0 + p;
        float* gr = st.gt + r * H4 + j;
        gr[0] = si;
        gr[H] = sf;
        gr[2 * H] = tg;
        gr[3 * H] = so;
        st.cs[r * H + j] = c[q];
      }
    }
  }
#pragma unroll
  for (int q = 0; q < PB; ++q) {
    const int p = p0 + g * PB + q;
    if (p < nw) hn[p * H + j] = hq[q];
  }
}
