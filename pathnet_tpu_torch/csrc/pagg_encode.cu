// K3: PAGG encode forward for the hetero / LSTM / attention model, f32.
//
// Replaces pathnet_tpu/models/pagg.py:235-303 (the encode block and the
// attention readout of pagg_forward) with _dist_select (:150-177) and
// nn/cells.py:22-46 (lstm_scan). Per target node, over its nw walks:
//   x_t   = h[paths[wl-1-t]]                     (hetero: far -> near)
//   s_t   = x_t @ W[d] + b[d],  d = clip(dists[wl-1-t], 0, wl-1)
//   gates = s_t @ w_ih + b_ih + h_{t-1} @ w_hh + b_hh   (i, f, g, o)
//   c_t = f c_{t-1} + i g,  h_t = o tanh(c_t)
//   score = leaky_relu(attw . [h_n, h[paths[0]]] + attb), softmax over nw
//   out   = sum over walks of softmax * h_n                  -> [T, H]
// One block per target. The walks run in groups through lstm_group_fwd
// (pagg_lstm.cuh, shared with K4's recompute); the final hidden state of
// every walk stays in shared memory for the readout.
// Training mode (pagg.py:274): with a keep mask (uint8 [wl, T*nw, H], the
// LSTM input's layout) the selected input of step t becomes
// mask ? s_t / keep : 0 before the LSTM. The kernel is a template on that
// choice, so the serving instantiation is the unmasked code unchanged.
// Bound on the H100: f32 FMA work (18 H^2 flops per walk step), about 1.4 ms
// per 8192-target request at 67 TFLOP/s; the bytes bound is ~100x lower.
#include "pagg_lstm.cuh"

template <bool MASKED>
__global__ void pagg_encode_fwd_kernel(
    const float* __restrict__ h, const int* __restrict__ paths,
    const int* __restrict__ dists, const float* __restrict__ wd,
    const float* __restrict__ bd, const float* __restrict__ w_ih,
    const float* __restrict__ w_hh, const float* __restrict__ b_ih,
    const float* __restrict__ b_hh, const float* __restrict__ attw,
    const float* __restrict__ attb, const uint8_t* __restrict__ mask,
    float keep, float* __restrict__ out, int nw, int wl, int H, int NG) {
  extern __shared__ float smem[];
  const int P = NG * PB;       // walks in flight per block
  float* xs = smem;            // [P][H] gathered rows of this step
  float* ss = xs + P * H;      // [P][H] distance-selected inputs
  float* hs = ss + P * H;      // [P][H] LSTM hidden states
  float* hn = hs + P * H;      // [nw][H] final hidden state of every walk
  float* sc = hn + nw * H;     // [nw] attention scores
  const int j = threadIdx.x % H;
  const int g = threadIdx.x / H;
  const long long B = (long long)gridDim.x * nw;
  const long long b0 = (long long)blockIdx.x * nw;
  const int* tp = paths + b0 * wl;
  const int* td = dists + b0 * wl;
  const LstmStreams none = {nullptr, nullptr, nullptr, nullptr, nullptr};

  for (int p0 = 0; p0 < nw; p0 += P)
    lstm_group_fwd<MASKED, false>(p0, h, tp, td, wd, bd, w_ih, w_hh, b_ih, b_hh,
                                  mask, keep, none, xs, ss, hs, hn, nw, wl, H,
                                  j, g, B, b0);
  __syncthreads();
  for (int p = threadIdx.x; p < nw; p += blockDim.x) {
    const float* ego = h + (long long)tp[p * wl] * H;
    float s = attb[0];
    for (int k = 0; k < H; ++k) s += attw[k] * hn[p * H + k] + attw[H + k] * ego[k];
    sc[p] = s > 0.0f ? s : 0.01f * s;
  }
  __syncthreads();
  float m = sc[0];
  for (int p = 1; p < nw; ++p) m = fmaxf(m, sc[p]);
  float den = 0.0f;
  for (int p = 0; p < nw; ++p) den += expf(sc[p] - m);
  if (g == 0) {
    float o = 0.0f;
    for (int p = 0; p < nw; ++p) o += expf(sc[p] - m) * hn[p * H + j];
    out[(long long)blockIdx.x * H + j] = o / den;
  }
}

extern "C" int pathnet_pagg_encode_fwd(
    const void* h, const void* paths, const void* dists, const void* wd,
    const void* bd, const void* w_ih, const void* w_hh, const void* b_ih,
    const void* b_hh, const void* attw, const void* attb, const void* mask,
    float keep, void* out, int T, int nw, int wl, int H, void* stream) {
  if (T == 0) return 0;
  const int NG = H >= 256 ? 1 : 256 / H;
  const int P = NG * PB;
  const size_t smem = ((size_t)3 * P * H + (size_t)nw * H + nw) * sizeof(float);
  auto kernel = mask ? pagg_encode_fwd_kernel<true> : pagg_encode_fwd_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<T, NG * H, smem, (cudaStream_t)stream>>>(
      (const float*)h, (const int*)paths, (const int*)dists,
      (const float*)wd, (const float*)bd, (const float*)w_ih,
      (const float*)w_hh, (const float*)b_ih, (const float*)b_hh,
      (const float*)attw, (const float*)attb, (const uint8_t*)mask, keep,
      (float*)out, nw, wl, H, NG);
  return (int)cudaGetLastError();
}
