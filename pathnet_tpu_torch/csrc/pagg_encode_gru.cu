// K3's GRU instances (f32, H = 64 and the run-time width; masked or not,
// hetero or homo): pagg_encode_walks_kernel with GRU = true, described in
// pagg_encode.cu and pagg_tile.cuh. They sit in a file of their own only so
// that nvcc builds them beside the LSTM instances rather than after them.
#include "pagg_tile.cuh"

int pagg_encode_gru(const void* h, const void* paths, const void* dists, const void* wd,
                    const void* bd, const void* w_ih, const void* w_hh, const void* b_ih,
                    const void* b_hh, const void* mask, float keep, void* hn, void* ego,
                    long long B, int wl, int H, void* stream) {
  return launch_encode_as<false, false, true>(h, paths, dists, wd, bd, w_ih, w_hh, b_ih,
                                              b_hh, mask, keep, hn, ego, Streams{}, B, wl,
                                              H, stream);
}
