// K4: PAGG encode backward, hetero and homo variants, the LSTM and the GRU,
// the attention, mean and sum readouts, f32 and bf16 compute.
//
// Replaces the VJP of pathnet_tpu/models/pagg.py:235-307 (the encode block
// and readout that K3 computes), with the gather VJP of the "h"
// gather mode (pagg.py:83-93): given g = d h_agg [T, H] it writes the
// gradient of every gathered row, one row per (walk, position) plus, for
// the hetero variant, one per walk for its ego row h[paths[0]] (the homo
// ego row is step 0's selected row, so its gradient joins that step's
// dsel), which csrc/segment_sum.cu then sums into dh [n, H]
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
// HOMO is a template parameter of all three launches (the hetero instances
// are the code they were); it changes per-element work only, so the bound
// above holds for both variants. Under HOMO launch A also writes the ego
// rows [T * nw, H] (the ReLU'd step-0 selected rows before dropout); launch B
// reads them in place of h[paths[0]], with d score = g . h_n / nw and
// d h_n = (1 + score) g / nw + d score attw[:H], and writes d ego = d score
// attw[H:] to a scratch [T * nw, H]; launch C adds d ego to step 0's dsel and
// multiplies dsel by the ReLU's derivative 1[s > 0]. The sign of s comes from
// the ego row at step 0 and from xin, the dropped-out input, after it: where
// the mask dropped a row its dsel is 0 whatever the sign, and where it kept
// it xin = s / keep has the sign of s. So the homo variant keeps no second
// copy of the inputs: its extra scratch is the ego rows and d ego, 2 H floats
// a walk (168 MB at the bgp-sized microbatch) against the H floats a walk of
// the hetero ego-row gradients it does not write.
//
// The mean and sum readouts (AGG, either variant) write only what the VJP
// of a mean or a sum needs. Launch B is pagg_agg_bwd_kernel: it reads g and
// writes d h_n = g / nw (mean) or g (sum) to every walk, and nothing else;
// the wrapper makes d attw and d attb exact zero tensors. The hetero ego
// rows get no gradient, so the segment sum adds wl rows a walk (20% fewer
// than attention's wl + 1 at wl = 4), and the homo launch C is given no
// d ego: it skips that read, and still takes the ReLU's sign at step 0 from
// launch A's ego rows. Its bound is bytes, 86 MB at the bgp microbatch
// (0.0257 ms); the design before this one also wrote zero ego-row
// gradients and zero partial sums (88 MB more) to keep the attention
// layout, and lost to one repeat_interleave.
//
// The GRU (CELL = GRU_CELL; K3's packed weights, see pagg_encode.cu): launch A
// writes gt as (r, z, n, h W_hn + b_hn), hp, and no cs. Launch C reads
// h_{t-1} from hp in place of cs and carries only dh: with dn = dh (1 - z),
// dz = dh (h_{t-1} - n) and da = dn (1 - n^2), the packed pre-activation
// gate gradients are (da (h W_hn + b_hn) r (1 - r), dz z (1 - z), da, da r),
// the shared product with [w_ih; w_hh]^T gives d xin and the gates' part of
// dh_{t-1}, and the direct term z dh, kept in the LSTM's dc registers, is
// added after it. The contractions then give the packed weights' gradients.
// Bound: 42 H^2 flops a walk step (3.37 ms at the bgp microbatch), though
// the packed products run the LSTM's 54. Under BF16 launch A is K3's bf16
// GRU (its n-group columns and h_t rounded, gt holding the rounded
// h W_hn + b_hn), and launch C is unchanged but for its products.
// The MLP (CELL = MLP_CELL, W as w_ih, b as b_ih): launch A writes xr, xin
// and, in hp's place, the walks' mean input m [T * nw, H], no cs and no gt;
// launch C has no recurrence: one product a tile, d s = (d h_n W^T) / wl
// (w_t = W^T [H, H]), the same for every step, then each step's dropout,
// homo ReLU and select products as the LSTM's. The wrapper contracts dW =
// m^T d h_n and db = sum d h_n. Bound: 2 H^2 flops a walk step for each of
// the recompute's select, launch C's select products and dwd's contraction,
// plus 6 H^2 a walk (the mean's product, d s, dW): 7.5 H^2 a step at wl =
// 4, 0.59 ms at the bgp microbatch at 67 TFLOP/s; the streams, 3 H floats
// a walk step (1.0 GB there), make the bytes' bound about 0.5 ms.
// The GRU's and the MLP's instances of launches A and C, f32 at H = 64 and
// the run-time width and bf16 at H = 64, 32 and the run-time width, are
// compiled in pagg_encode_bwd_gru.cu and pagg_encode_bwd_mlp.cu, launch C's
// kernel being in pagg_bptt.cuh.
//
// The quirk readout (AGG = QUIRK, pagg.py:316-338): the wrapper runs the
// hetero launches on the quirk's layout (pagg_encode.cu), launch B reads
// the ego rows at the nodes the wrapper passes as one-step walks and scales
// its cotangent by 1 / nw (the readout's mean), and the segment sum takes
// the ego rows' gradients to those nodes.
//
// bf16 compute (BF16, the table and the six cast weights bf16): launch A is
// K3's bf16 encode with STREAMS, so the streams hold exactly the forward's
// rounded values (in f32, which holds them exactly); launch B reads the
// hetero ego rows from the bf16 table; launch C stages the bf16 weights as
// K3 does and multiplies on the bf16 tensor cores too. Every cotangent stays
// f32: rounding's derivative is taken as the identity, as JAX's convert VJP
// is. Launch C's A holds f32 cotangents, which a bf16 operand would round,
// so it holds each as two bf16 halves, hi = bf16(a) and lo = bf16(a - hi),
// and both are multiplied into the same f32 accumulators: within ~2^-16
// relative of the f32 product, at twice the tensor-core work (still far
// under the CUDA cores' time). The wrapper returns dh and the cast
// weights' gradients as bf16, the type of their inputs. The bf16 instances
// are compiled at H = 64, 32 and the run-time width.
//
// Design: three launches on K3's walk tile (pagg_tile.cuh); nothing is kept
// between K3 and K4, so launch A recomputes the forward.
// A. pagg_encode_walks_kernel<MASKED, HC, STREAMS = true, HOMO>: K3's encode on
//    K3's grid and tile, which also stores per step the values launch C and
//    the contractions read (xr, xin, hp, cs, gt: see Streams) and writes
//    h_n [T * nw, H] to a scratch.
// B. pagg_attention_bwd_kernel (attention; pagg_agg_bwd_kernel under mean
//    and sum, above): one block per target, shaped like K3's
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
//    the [wl, T * nw, H] row gradients, dsel's layout. Shared memory
//    4H (M + 4) + 4 KC H floats: 102,400 B at H = 64 (two blocks a SM, as
//    K3), 229,376 B at H = 1024. BF16: A's two bf16 halves and mma_gemm's
//    region (bf16_smem in pagg_tile.cuh), 107,520 B at H = 64.
#include "pagg_bptt.cuh"

namespace {

__device__ __forceinline__ float leaky(float s) { return s > 0.0f ? s : 0.01f * s; }

// Launch B under the mean and sum readouts: d h_n = g / nw (mean) or g
// (sum) to every walk, and nothing else, one float4 (or, where a row or a
// pointer does not allow it, one float) a thread over the flat [T * nw, H].
// What bounds it is the bytes: g read, d h_n written (86 MB at the bgp
// microbatch, 0.0257 ms at 3.35 TB/s); the flat grid keeps every thread on
// one 16-byte store, consecutive threads on consecutive addresses.
template <int AGG>
__global__ void pagg_agg_bwd_kernel(const float* __restrict__ g, float* __restrict__ dhn,
                                    int nw, int H, long long n, bool vec4) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  if (vec4) {
    const int L = H / 4;
    const long long b = e / L;  // the walk
    float4 v = reinterpret_cast<const float4*>(g)[b / nw * L + e % L];
    if (AGG == MEAN) {
      v.x /= nw;
      v.y /= nw;
      v.z /= nw;
      v.w /= nw;
    }
    reinterpret_cast<float4*>(dhn)[e] = v;
  } else {
    const float v = g[e / H / nw * H + e % H];
    dhn[e] = AGG == MEAN ? v / nw : v;
  }
}

// QUIRK: the hetero attention backward of g / nw (the quirk readout's mean).
template <bool HOMO, typename W, bool QUIRK = false>
__global__ void pagg_attention_bwd_kernel(
    const float* __restrict__ g, const W* __restrict__ h,
    const int* __restrict__ paths, const float* __restrict__ hn,
    const float* __restrict__ ego, const float* __restrict__ attw,
    const float* __restrict__ attb, float* __restrict__ dhn, float* __restrict__ dego,
    float* __restrict__ part, int nw, int wl, int H) {
  extern __shared__ float sm[];
  float* sc = sm;        // [nw] scores (hetero: before the leaky relu)
  float* at = sc + nw;   // [nw] each walk's weight on g: softmax, or (1 + score) / nw
  float* ds = at + nw;   // [nw] d att, then d score
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const long long b0 = (long long)blockIdx.x * nw;
  const float* gr = g + (long long)blockIdx.x * H;
  for (int p = warp; p < nw; p += nwarps) {
    const float* hr = hn + (b0 + p) * H;
    const auto* er = ego_row<HOMO>(h, paths, ego, b0 + p, wl, H);
    float s = 0.0f, da = 0.0f;
    for (int k = lane; k < H; k += 32) {
      s += attw[k] * hr[k] + attw[H + k] * ldf(er + k);
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
  if (HOMO && warp == 0) {
    // out = mean of (1 + score) h_n: d score = d att / nw
    for (int p = lane; p < nw; p += 32) {
      at[p] = (1.0f + sc[p]) / nw;
      ds[p] = ds[p] / nw;
    }
  } else if (warp == 0) {
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
    for (int p = lane; p < nw; p += 32) {
      ds[p] = at[p] * (ds[p] - dot) * (sc[p] > 0.0f ? 1.0f : 0.01f);
      if (QUIRK) {
        ds[p] /= nw;
        at[p] /= nw;
      }
    }
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
      de += ds[p] * ldf(ego_row<HOMO>(h, paths, ego, b0 + p, wl, H) + j);
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

template <typename W>
int launch_attention(const void* g, const void* h, const void* paths, const void* hn,
                     const void* ego, const void* attw, const void* attb, void* dhn,
                     void* dego, void* part, int T, int nw, int wl, int H, int agg,
                     void* stream) {
  if (agg == MEAN || agg == SUM) {
    const long long B = (long long)T * nw;
    const bool v4 = agg_vec4(H, (uintptr_t)g | (uintptr_t)dhn);
    const long long n = B * (v4 ? H / 4 : H);
    const auto kernel = agg == MEAN ? pagg_agg_bwd_kernel<MEAN> : pagg_agg_bwd_kernel<SUM>;
    kernel<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
        (const float*)g, (float*)dhn, nw, H, n, v4);
    return (int)cudaGetLastError();
  }
  const int smem = 3 * nw * (int)sizeof(float);
  const auto kernel = agg == QUIRK ? pagg_attention_bwd_kernel<false, W, true>
                      : ego        ? pagg_attention_bwd_kernel<true, W>
                                   : pagg_attention_bwd_kernel<false, W>;
  if (int e = allow_smem(kernel, smem)) return e;
  kernel<<<T, H > 128 ? 256 : 128, smem, (cudaStream_t)stream>>>(
      (const float*)g, (const W*)h, (const int*)paths, (const float*)hn,
      (const float*)ego, (const float*)attw, (const float*)attb, (float*)dhn,
      (float*)dego, (float*)part, nw, wl, H);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch A: h_n [T * nw, H] and the streams xr, xin, hp, cs [wl, T * nw, H]
// and gt [wl, T * nw, 4H]; homo where ego [T * nw, H] is given, which then
// receives each walk's ego row; bf16 where bf16 is nonzero (h and the six
// weights bf16); cell 0 the LSTM, 1 the GRU on packed weights (cs is not
// written and may be null), 2 the MLP (hp receives the mean input [T * nw,
// H]; cs and gt are not written and may be null).
extern "C" int pathnet_pagg_encode_walks_streams(
    const void* h, const void* paths, const void* dists, const void* wd,
    const void* bd, const void* w_ih, const void* w_hh, const void* b_ih,
    const void* b_hh, const void* mask, float keep, void* hn, void* xr, void* xin,
    void* hp, void* cs, void* gt, void* ego, int T, int nw, int wl, int H, int bf16,
    int cell, void* stream) {
  const Streams st = {(float*)xr, (float*)xin, (float*)hp, (float*)cs, (float*)gt};
  return launch_encode<true>(h, paths, dists, wd, bd, w_ih, w_hh, b_ih, b_hh, mask, keep,
                             hn, ego, st, T, nw, wl, H, bf16, cell, stream);
}

// Launch B: d h_n [T * nw, H] from g [T, H] and h_n; under agg 0
// (attention; homo where ego, launch A's, is given; the hetero ego rows from
// a bf16 table where bf16 is nonzero) also the ego rows' gradient dego
// [T * nw, H] and each target's terms of the attention weights' gradient,
// part [T, 2H + 1] (d attw, then d attb). Under agg 1 (mean) and 2 (sum) it
// reads g alone and writes d h_n alone: h, paths, hn, ego, attw, attb, dego
// and part may be null. agg 3 (quirk): the hetero attention's of g / nw,
// paths holding each walk's ego node with wl = 1.
extern "C" int pathnet_pagg_attention_bwd(
    const void* g, const void* h, const void* paths, const void* hn, const void* ego,
    const void* attw, const void* attb, void* dhn, void* dego, void* part,
    int T, int nw, int wl, int H, int bf16, int agg, void* stream) {
  if (T == 0) return 0;
  if (agg < ATTENTION || agg > QUIRK) return (int)cudaErrorInvalidValue;
  return (bf16 ? launch_attention<__nv_bfloat16> : launch_attention<float>)(
      g, h, paths, hn, ego, attw, attb, dhn, dego, part, T, nw, wl, H, agg, stream);
}

// Launch C: BPTT from d h_n; overwrites gt with the pre-activation gate
// gradients and writes dsel and every gathered row's gradient drow, both
// [wl, T * nw, H]. wd_t = wd transposed per class [wl, H, H]; w_t =
// [w_ih; w_hh]^T [4H, 2H]; both bf16 where bf16 is nonzero. Homo where ego
// is given, with xin (launch A's) and dego (launch B's; null under the mean
// and sum readouts, which give the ego row no gradient). cell 0: cs is
// launch A's cs; 1 (the GRU): its hp; 2 (the MLP): w_t = W^T [H, H], and
// cs and gt are not read (they may be null).
extern "C" int pathnet_pagg_bptt(const void* dhn, const void* dists,
                                 const void* wd_t, const void* w_t, const void* cs,
                                 void* gt, const void* mask, float keep, const void* xin,
                                 const void* ego, const void* dego, void* dsel,
                                 void* drow, int T, int nw, int wl, int H, int bf16,
                                 int cell, void* stream) {
  const long long B = (long long)T * nw;
  if (B == 0) return 0;
  if (cell == GRU_CELL || cell == MLP_CELL)
    return (cell == GRU_CELL ? pagg_bptt_gru : pagg_bptt_mlp)(
        bf16, dhn, dists, wd_t, w_t, cs, gt, mask, keep, xin, ego, dego, dsel, drow, B, wl, H,
        stream);
  if (cell != LSTM_CELL) return (int)cudaErrorInvalidValue;
  return (bf16 ? launch_bptt<true, LSTM_CELL> : launch_bptt<false, LSTM_CELL>)(
      dhn, dists, wd_t, w_t, cs, gt, mask, keep, xin, ego, dego, dsel, drow, B, wl, H,
      stream);
}
