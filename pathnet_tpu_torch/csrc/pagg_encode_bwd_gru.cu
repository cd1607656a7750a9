// K4's GRU instances (f32, H = 64 and the run-time width; masked or not,
// hetero or homo): launch A, pagg_encode_walks_kernel with STREAMS and GRU,
// and launch C, pagg_bptt_kernel with GRU, described in pagg_encode_bwd.cu.
// They sit in a file of their own only so that nvcc builds them beside the
// LSTM instances rather than after them.
#include "pagg_bptt.cuh"

int pagg_encode_gru_streams(const void* h, const void* paths, const void* dists,
                            const void* wd, const void* bd, const void* w_ih,
                            const void* w_hh, const void* b_ih, const void* b_hh,
                            const void* mask, float keep, void* hn, void* ego, float* xr,
                            float* xin, float* hp, float* cs, float* gt, long long B,
                            int wl, int H, void* stream) {
  return launch_encode_as<true, false, true>(h, paths, dists, wd, bd, w_ih, w_hh, b_ih,
                                             b_hh, mask, keep, hn, ego,
                                             Streams{xr, xin, hp, cs, gt}, B, wl, H, stream);
}

int pagg_bptt_gru(const void* dhn, const void* dists, const void* wd_t, const void* w_t,
                  const void* hp, void* gt, const void* mask, float keep, const void* xin,
                  const void* ego, const void* dego, void* dsel, void* drow, long long B,
                  int wl, int H, void* stream) {
  return launch_bptt<false, true>(dhn, dists, wd_t, w_t, hp, gt, mask, keep, xin, ego, dego,
                                  dsel, drow, B, wl, H, stream);
}
