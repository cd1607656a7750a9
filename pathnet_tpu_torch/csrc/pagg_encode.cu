// K3: PAGG encode forward, hetero and homo variants, the LSTM and the GRU,
// the attention, mean and sum readouts, f32 and bf16 compute.
//
// Replaces pathnet_tpu/models/pagg.py:235-307 (the encode block and the
// readout of pagg_forward) with _dist_select (:150-177) and nn/cells.py:
// 22-68 (lstm_scan, gru_scan). For every walk b = target * nw + walk:
//   x_t   = h[paths[p_t]],  p_t = wl-1-t (hetero: far -> near), t (homo)
//   s_t   = x_t @ W[d] + b[d],  d = clip(dists[p_t], 0, wl-1)
//   s_t   = relu(s_t)                            (homo only, pagg.py:269)
//   ego   = h[paths[0]] (hetero),  s_0 here (homo, before dropout, :270)
//   s_t   = mask ? s_t / keep : 0                (training only, pagg.py:274)
//   gates = s_t @ w_ih + b_ih + h_{t-1} @ w_hh + b_hh   (i, f, g, o)
//   c_t = f c_{t-1} + i g,  h_t = o tanh(c_t)
// and per target, with score = attw . [h_n, ego] + attb:
//   hetero: softmax over nw of leaky_relu(score); out = sum of softmax * h_n
//   homo:   out = mean over nw of (1 + score) * h_n          -> [T, H]
// or, under the mean and sum readouts (AGG, pagg.py:304-307, either
// variant), out = the mean or the sum over nw of h_n: no score, no ego row.
// The GRU (CELL = GRU_CELL, nn/cells.py:49-68) takes its weights packed by the
// wrapper into the LSTM's [H, 4H] layout: w_ih = [W_ir, W_iz, W_in, 0],
// w_hh = [W_hr, W_hz, 0, W_hn], b_ih = [b_ir, b_iz, b_in, 0], b_hh =
// [b_hr, b_hz, 0, b_hn]. The gate product below is then unchanged, and its
// four column groups are r and z before their sigmoids, x W_in + b_in, and
// h W_hn + b_hn kept apart, so the epilogue forms
//   r = sig(g0), z = sig(g1), n = tanh(g2 + r g3), h_t = (1 - z) n + z h_{t-1}
// with b_hn inside the product with r, as torch.nn.GRU and JAX have it.
// The packed product does 16 H^2 flops a step where the GRU needs 12 H^2
// (a first kernel: a [2H, 3H] product with a split n group is for later).
// h_{t-1} is read back from A's h half, where the last step left it.
// The MLP (CELL = MLP_CELL, pagg.py:180-188): h_n = mean_t(s_t) @ W + b, W
// and b given as w_ih and b_ih (w_hh, b_hh empty). Each step's select and
// dropout are the LSTM's; s_t is added into registers (c_t's), and after
// the last step the mean goes to A's s half and one [M, H] x [H, H] product
// (the select's tile_gemm<1>, or mma_gemm<1> under BF16) plus b gives h_n:
// no gate product. Its bound is 2 H^2 flops a walk step for the select
// plus 2 H^2 a walk (2.5 H^2 a step at wl = 4: 0.20 ms at the bgp request
// at 67 TFLOP/s, against ~29 MB of unique bytes, 9 us); the select's
// product per class present in the tile is then most of the work.
// The cell (CELL) and AGG are template parameters, so the LSTM / attention
// instances are the code they were; the GRU's and the MLP's instances, f32
// at H = 64 and the run-time width and bf16 at H = 64, 32 and the run-time
// width, are compiled in pagg_encode_gru.cu and pagg_encode_mlp.cu.
// The quirk readout (AGG = QUIRK, JAX's quirk_compat, pagg.py:316-338):
// the wrapper lays the walks out so that the hetero encode reads them in
// the quirk's order, and passes the ego nodes as one-step walks (paths with
// wl = 1); the readout is the hetero attention's, its weighted sum divided
// by nw.
// HOMO is a template parameter of both launches, so the hetero instances
// are the code they were; the homo encode also stores the walk's ego row
// to a scratch [T * nw, H] that the readout reads in place of h[paths[0]].
// The variant changes per-element work only: the bound below holds for both.
// bf16 compute (the JAX package's compute_dtype="bfloat16", pagg.py:233-279)
// is the template parameter BF16 of the encode and the table's type in the
// readout: the table and wd, bd, w_ih, w_hh, b_ih, b_hh are bf16 (the
// weight chunks staged as bf16 at half the bytes), A = [s_t | h_{t-1}] is
// held in bf16 (it holds bf16 values only), both products run on the bf16
// tensor cores with f32 accumulators (mma_gemm in pagg_tile.cuh; the bias
// the accumulators' initial value, as below) and hand their sums to the
// f32 epilogue below unchanged; the encode rounds
// s_t = round(round(x_t @ W[d]) + b[d]), the dropped-out round(s_t / keep)
// (the wrapper passes keep rounded to bf16, as JAX divides by it),
// c_t and h_t to bf16; the readout runs in f32 on the bf16 table's ego rows
// (hetero) or the rounded step-0 rows (homo). Its bound is the same flops at
// bf16's tensor-core rate (~989 TFLOP/s dense: ~0.10 ms at the bgp request);
// the tile's shared-memory traffic and its epilogue keep it well above that
// (pagg_tile.cuh). The bf16 instances are compiled at H = 64 (bgp) and 32
// (Electronics) and at the run-time width. The bf16 GRU rounds its n-group
// columns x W_in + b_in and h W_hn + b_hn (JAX's bf16 gx and gh there) and
// h_t.
//
// Bound on the H100: f32 FMA work on the CUDA cores, 18 H^2 flops per walk
// step (2 H^2 for the selected distance transform, 16 H^2 for the gates):
// 1.44 ms for an 8192-target request at H = 64 (nw = 40, wl = 4) at
// 67 TFLOP/s, against ~29 MB of unique bytes (9 us); the GRU needs 14 H^2
// (1.12 ms), the mean and sum readouts read h_n once (84 MB, 0.025 ms). The weights are small
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
//    warp 0 reduces the max and the denominator once (hetero), and the
//    block forms the weighted sum over nw. Under mean and sum the block's
//    threads split a row's loads (H / 4 float4s where H is a multiple of 4
//    and h_n is 16-byte aligned, else H floats) and the walks into groups
//    (blockDim / loads, one where a row has more loads than the block has
//    threads), each thread summing its units over its group's walks, and
//    the groups' sums are added in group order: a fixed order, no atomics.
// M and KC are derived from H in tile_for; nothing is a knob.
//
// The tile machinery and the encode kernel live in pagg_tile.cuh, which K4
// shares: its forward recompute is this encode with STREAMS = true.
#include "pagg_tile.cuh"

namespace {

template <int AGG, bool HOMO, typename W>
__global__ void pagg_readout_kernel(const W* __restrict__ h,
                                    const int* __restrict__ paths,
                                    const float* __restrict__ hn,
                                    const float* __restrict__ ego,
                                    const float* __restrict__ attw,
                                    const float* __restrict__ attb,
                                    float* __restrict__ out, int nw, int wl, int H) {
  extern __shared__ float sc[];  // [nw] scores, then the walks' weights
  if constexpr (AGG == MEAN || AGG == SUM) {
    // part holds [G][H] partial sums: group q adds walks q, q + G, ..., a
    // float4 of units at a time where the rows allow it
    extern __shared__ __align__(16) float part[];
    const long long b0 = (long long)blockIdx.x * nw;
    const bool v4 = agg_vec4(H, (uintptr_t)hn);
    const int G = agg_groups(H, blockDim.x, v4);
    const int L = v4 ? H / 4 : H;  // loads a row
    for (int e = threadIdx.x; e < G * L; e += blockDim.x) {
      const int q = e / L, c = e % L;
      if (v4) {
        float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int p = q; p < nw; p += G) {
          const float4 v = reinterpret_cast<const float4*>(hn + (b0 + p) * H)[c];
          s.x += v.x;
          s.y += v.y;
          s.z += v.z;
          s.w += v.w;
        }
        reinterpret_cast<float4*>(part + q * H)[c] = s;
      } else {
        float s = 0.0f;
        for (int p = q; p < nw; p += G) s += hn[(b0 + p) * H + c];
        part[e] = s;
      }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      float o = 0.0f;
      for (int q = 0; q < G; ++q) o += part[q * H + j];
      out[(long long)blockIdx.x * H + j] = AGG == MEAN ? o / nw : o;
    }
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const long long b0 = (long long)blockIdx.x * nw;
  for (int p = warp; p < nw; p += nwarps) {
    const float* hr = hn + (b0 + p) * H;
    const auto* er = ego_row<HOMO>(h, paths, ego, b0 + p, wl, H);
    float s = 0.0f;
    for (int k = lane; k < H; k += 32) s += attw[k] * hr[k] + attw[H + k] * ldf(er + k);
    s = warp_sum(s) + attb[0];
    if (lane == 0) sc[p] = HOMO ? 1.0f + s : (s > 0.0f ? s : 0.01f * s);
  }
  __syncthreads();
  if (!HOMO && warp == 0) {
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
    out[(long long)blockIdx.x * H + j] = HOMO || AGG == QUIRK ? o / nw : o;
  }
}

template <typename W>
int launch_readout(const void* h, const void* paths, const void* hn, const void* ego,
                   const void* attw, const void* attb, void* out, int T, int nw, int wl,
                   int H, int agg, void* stream) {
  const int threads = H > 128 ? 256 : 128;
  // attention: nw scores; mean, sum: the groups' partial sums (see the kernel)
  const bool att = agg == ATTENTION || agg == QUIRK;
  const int smem =
      (att ? nw : agg_groups(H, threads, agg_vec4(H, (uintptr_t)hn)) * H) * (int)sizeof(float);
  // mean and sum read neither the table nor the ego rows
  const auto kernel = agg == MEAN    ? pagg_readout_kernel<MEAN, false, W>
                      : agg == SUM   ? pagg_readout_kernel<SUM, false, W>
                      : agg == QUIRK ? pagg_readout_kernel<QUIRK, false, W>
                      : ego          ? pagg_readout_kernel<ATTENTION, true, W>
                                     : pagg_readout_kernel<ATTENTION, false, W>;
  if (int e = allow_smem(kernel, smem)) return e;
  kernel<<<T, threads, smem, (cudaStream_t)stream>>>(
      (const W*)h, (const int*)paths, (const float*)hn, (const float*)ego,
      (const float*)attw, (const float*)attb, (float*)out, nw, wl, H);
  return (int)cudaGetLastError();
}

}  // namespace

// K3's tile at width H (bf16: with bf16 weight chunks): out[0..3] = M
// (walks a block), threads, shared bytes, KC.
extern "C" int pathnet_pagg_encode_tile(int H, int bf16, void* out) {
  const Tile t = tile_for(H, bf16 != 0);
  int* o = (int*)out;
  o[0] = t.M;
  o[1] = t.NT;
  o[2] = t.smem;
  o[3] = t.KC;
  return 0;
}

// Launch 1: h_n [T * nw, H] of every walk; homo where ego [T * nw, H] is
// given, which then receives each walk's ego row; bf16 where bf16 is
// nonzero (h and the six weights bf16); cell 0 the LSTM, 1 the GRU on packed
// weights, 2 the MLP (W as w_ih, b as b_ih).
extern "C" int pathnet_pagg_encode_walks(
    const void* h, const void* paths, const void* dists, const void* wd,
    const void* bd, const void* w_ih, const void* w_hh, const void* b_ih,
    const void* b_hh, const void* mask, float keep, void* hn, void* ego, int T, int nw,
    int wl, int H, int bf16, int cell, void* stream) {
  return launch_encode<false>(h, paths, dists, wd, bd, w_ih, w_hh, b_ih, b_hh, mask, keep,
                              hn, ego, Streams{}, T, nw, wl, H, bf16, cell, stream);
}

// Launch 2: the readout [T, H] from h_n: agg 0 attention (homo where ego,
// launch 1's, is given; the hetero ego rows from a bf16 table where bf16 is
// nonzero), 1 mean, 2 sum (h, paths, ego, attw and attb not read), 3 quirk
// (hetero attention, its sum divided by nw; paths holds each walk's ego node
// with wl = 1).
extern "C" int pathnet_pagg_readout(const void* h, const void* paths,
                                    const void* hn, const void* ego, const void* attw,
                                    const void* attb, void* out, int T, int nw,
                                    int wl, int H, int bf16, int agg, void* stream) {
  if (T == 0) return 0;
  if (agg < ATTENTION || agg > QUIRK) return (int)cudaErrorInvalidValue;
  return (bf16 ? launch_readout<__nv_bfloat16> : launch_readout<float>)(
      h, paths, hn, ego, attw, attb, out, T, nw, wl, H, agg, stream);
}
