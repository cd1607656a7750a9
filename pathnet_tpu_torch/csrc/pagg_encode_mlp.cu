// K3's MLP instances (CELL = MLP_CELL; f32 at H = 64 and the run-time
// width, bf16 at H = 64, 32 and the run-time width; masked or not, hetero or
// homo): pagg_encode_walks_kernel, described in pagg_encode.cu and
// pagg_tile.cuh. They sit in a file of their own only so that nvcc builds
// them beside the others rather than after them.
#include "pagg_tile.cuh"

int pagg_encode_mlp(PAGG_ENCODE_SET_ARGS) {
  return launch_encode_set<false, MLP_CELL>(bf16, h, paths, dists, wd, bd, w_ih, w_hh, b_ih,
                                            b_hh, mask, keep, hn, ego, xr, xin, hp, cs, gt, B,
                                            wl, H, stream);
}
