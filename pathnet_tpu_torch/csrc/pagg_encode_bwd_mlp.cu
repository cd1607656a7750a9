// K4's MLP instances (CELL = MLP_CELL; f32 at H = 64 and the run-time width,
// bf16 at H = 64, 32 and the run-time width; masked or not, hetero or homo):
// launch A, pagg_encode_walks_kernel with STREAMS, and launch C,
// pagg_bptt_kernel, described in pagg_encode_bwd.cu. They sit in a file of
// their own only so that nvcc builds them beside the others rather than
// after them.
#include "pagg_bptt.cuh"

int pagg_encode_mlp_streams(PAGG_ENCODE_SET_ARGS) {
  return launch_encode_set<true, MLP_CELL>(bf16, h, paths, dists, wd, bd, w_ih, w_hh, b_ih,
                                           b_hh, mask, keep, hn, ego, xr, xin, hp, cs, gt, B,
                                           wl, H, stream);
}

int pagg_bptt_mlp(PAGG_BPTT_SET_ARGS) {
  return launch_bptt_set<MLP_CELL>(bf16, dhn, dists, wd_t, w_t, cs, gt, mask, keep, xin, ego,
                                   dego, dsel, drow, B, wl, H, stream);
}
