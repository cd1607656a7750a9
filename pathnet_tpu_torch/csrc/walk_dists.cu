// K1 + K2: inverse-CDF random walks and their hop distances, one launch.
//
// Replaces pathnet_tpu/sample/alias.py:142-147 (CdfSampler.step) as scanned
// by pathnet_tpu/sample/walk.py:36-55 (sample_paths), and
// pathnet_tpu/sample/distance.py:77-139 (membership_dists, wl <= 4). Three
// entries share this device code: walk_dists (walks and distances, the
// sampler's path), cdf_walk (walks only, any wl) and membership_dists
// (distances of given walks).
//
// Work split: a lane group of G lanes (1, 16 or 32, picked from D) per
// walk, the walks laid out flat across the grid, a start's nw walks side by
// side. Every lane of a warp runs every loop and vote, so the
// groups of a warp stay converged; a lane past the last walk votes false.
// Each walk is a chain of dependent loads, so the card's time goes to how
// many walks are in flight: at bgp's D = 25 one lane a walk (G = 1) keeps
// the most in flight, at Nba's D = 442 a wider group shortens each step.
//
// Walk step: the group's lanes compare G CDF entries at a time against the
// walk's uniform, several chunks' loads in flight, and count the hits with
// __ballot_sync / __popc (a lane alone counts in a register): idx =
// #{j < D : cdf[cur, j] < u}, clamped to D - 1, exactly the plain version's
// count. A count and not a binary search of the row, because the CDF row is
// not promised to be nondecreasing (its blocked sums may step down by an
// ulp) and a NaN row must give the plain version's idx.
//
// Distances: d0 = 0; d1 = v1 != s; d2 adds the N1 test (v2 in N(s)); d3 adds
// the N2 test (N(v3) and N(s) share a node). Membership in N(s) is a binary
// search of the start's row sorted once per graph on the card (srt, as
// sorted_rows in kernels/walk_dists.py makes it: the first deg entries of
// each row ascending, then INT_MAX, so the search runs over all D slots and
// needs no deg[s]). Chosen over a bitmap of node ids in shared memory: a
// sorted row takes D ints whatever n is (a bitmap takes n bits a block and
// caps n by shared memory), and a search is log2(D) + 1 loads, several
// searches in lockstep with their loads in flight together. The row is read
// where it lies: a start's walks are neighbours in the grid, so after the
// first search it is an L1 hit for all of them; staging it in shared memory
// tied the grid to one start a block and put a load chain and a barrier
// before every start's walks (PERF.md, section 6). The N2 test reads nbr[v3]
// coalesced, G entries a chunk, tests each against the row and stops at
// the group's first hit.
//
// Bound on the H100: latency of each walk's dependent loads (the start, the
// CDF chunks and nbr[cur, idx] for each step, then deg[v3], nbr[v3] and the
// searches); the tables of every graph the port runs fit in the 50 MB L2.
// The byte bound (the tables, u, paths and dists once) is far lower.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int clamp_deg(int d, int D) { return d < 0 ? 0 : (d > D ? D : d); }

// For each of the K values v[q]: is it among row[0 : len), ascending? The
// K binary searches run in lockstep, so each step's K loads are in flight
// together: log2(len) + 1 rounds of loads for all of them.
template <int K>
__device__ __forceinline__ void in_sorted(const int* __restrict__ row, int len, const int (&v)[K],
                                          bool (&found)[K]) {
  int pos[K];
#pragma unroll
  for (int q = 0; q < K; ++q) pos[q] = 0;
  int top = 1;
  while (2 * top <= len) top *= 2;
  for (int step = len > 0 ? top : 0; step > 0; step >>= 1) {
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int k = pos[q] + step;
      if (k <= len && row[k - 1] < v[q]) pos[q] = k;
    }
  }
#pragma unroll
  for (int q = 0; q < K; ++q) found[q] = pos[q] < len && row[pos[q]] == v[q];
}

// The G lanes of one walk: votes over the group (a lane alone needs none).
template <int G>
struct Group {
  unsigned mask;
  __device__ __forceinline__ int count(bool p) const {
    if (G == 1) return p;
    return __popc(__ballot_sync(FULL, p) & mask);
  }
  __device__ __forceinline__ bool any(bool p) const { return count(p) != 0; }
  // the loop condition of a loop whose body votes: the warp's, so that every
  // lane runs each vote
  __device__ __forceinline__ bool keep_going(bool p) const {
    if (G == 1) return p;
    return __any_sync(FULL, p);
  }
};

// WALK: draw the walks from u (else read them from paths); DISTS: write the
// distances. Walk w of start starts[w / nw] is row w of paths and dists
// [W, wl], W = S * nw.
template <int G, bool WALK, bool DISTS>
__global__ void __launch_bounds__(256)
walk_dists_kernel(const int* __restrict__ nbr, const float* __restrict__ cdf,
                  const int* __restrict__ deg, const int* __restrict__ srt,
                  const int* __restrict__ starts, const float* __restrict__ u,
                  int* __restrict__ paths, int* __restrict__ dists, int D, long long W, int nw,
                  int wl) {
  constexpr int U = G >= 8 ? 4 : 8;  // chunks whose loads are in flight together
  const long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  const int lane = threadIdx.x & 31;
  const int gl = lane & (G - 1);
  const Group<G> grp{G == 32 ? FULL : ((1u << G) - 1u) << (lane - gl)};
  const bool live = w < W;
  const int s = live ? starts[w / nw] : 0;
  int* po = paths + w * wl;
  int v1 = s, v2 = s, v3 = s;
  if (WALK) {
    // the first three steps' uniforms, loaded before the walk needs them
    float x1 = 0.0f, x2 = 0.0f, x3 = 0.0f;
    if (live) {
      if (wl > 1) x1 = u[w];
      if (wl > 2) x2 = u[W + w];
      if (wl > 3) x3 = u[2 * W + w];
    }
    if (live && gl == 0) po[0] = s;
    int cur = s;
    for (int t = 1; t < wl; ++t) {
      const float x = t == 1   ? x1
                      : t == 2 ? x2
                      : t == 3 ? x3
                               : (live ? u[(long long)(t - 1) * W + w] : 0.0f);
      const float* cr = cdf + (long long)cur * D;
      int idx = 0;
      for (int j0 = 0; j0 < D; j0 += U * G) {
        float c[U];
#pragma unroll
        for (int q = 0; q < U; ++q) {
          const int j = j0 + q * G + gl;
          c[q] = live && j < D ? cr[j] : 0.0f;
        }
#pragma unroll
        for (int q = 0; q < U; ++q) idx += grp.count(live && j0 + q * G + gl < D && c[q] < x);
      }
      idx = idx < D - 1 ? idx : D - 1;
      cur = live ? nbr[(long long)cur * D + idx] : 0;
      if (live && gl == 0) po[t] = cur;
      if (t == 1) v1 = cur;
      if (t == 2) v2 = cur;
      if (t == 3) v3 = cur;
    }
  } else if (live) {
    if (wl > 1) v1 = po[1];
    if (wl > 2) v2 = po[2];
    if (wl > 3) v3 = po[3];
  }
  if (!DISTS) return;
  const int* row = srt + (long long)s * D;
  const int dv3 = deg[v3];  // issued early; used only by the N2 test
  const int d1 = v1 == s ? 0 : 1;
  const int v23[2] = {v2, v3};
  bool in1[2];  // v2, v3 in N(s)
  in_sorted<2>(row, D, v23, in1);
  const int d2 = v2 == s ? 0 : (in1[0] ? 1 : 2);
  int d3 = 0;
  bool n2 = false;  // v3 needs the N2 test
  if (wl > 3 && v3 != s) {
    if (in1[1])
      d3 = 1;
    else
      n2 = live;
  }
  const int dv = n2 ? clamp_deg(dv3, D) : 0;
  const int* nv = nbr + (long long)v3 * D;
  bool hit = false;
  for (int j0 = 0; grp.keep_going(j0 < dv && !hit); j0 += U * G) {
    int e[U];
#pragma unroll
    for (int q = 0; q < U; ++q) {
      const int j = j0 + q * G + gl;
      e[q] = j < dv ? nv[j] : -1;  // node ids are >= 0: -1 is never in a row
    }
    bool f[U];
    in_sorted<U>(row, D, e, f);
    bool h = false;
#pragma unroll
    for (int q = 0; q < U; ++q) h |= f[q];
    const bool found = grp.any(!hit && h);  // every lane votes
    hit = hit || found;
  }
  if (n2) d3 = hit ? 2 : 3;
  if (live)
    for (int t = gl; t < wl; t += G) dists[w * wl + t] = t == 0 ? 0 : t == 1 ? d1 : t == 2 ? d2 : d3;
}

template <int G, bool WALK, bool DISTS>
int launch(const int* nbr, const float* cdf, const int* deg, const int* srt, const int* starts,
           const float* u, int* paths, int* dists, int D, int S, int nw, int wl,
           cudaStream_t stream) {
  const long long W = (long long)S * nw;
  const int threads = 256;
  const unsigned blocks = (unsigned)((W * G + threads - 1) / threads);
  walk_dists_kernel<G, WALK, DISTS><<<blocks, threads, 0, stream>>>(
      nbr, cdf, deg, srt, starts, u, paths, dists, D, W, nw, wl);
  return (int)cudaGetLastError();
}

// The lanes a walk gets at table width D, from a sweep of every power of two
// to 32 (PERF.md, section 6): one at D <= 32 (bgp's 25), where the most
// walks in flight win; 16 at cornell's 190 and Nba's 442; 32 past 512.
template <bool WALK, bool DISTS>
int launch_for_width(const int* nbr, const float* cdf, const int* deg, const int* srt,
                     const int* starts, const float* u, int* paths, int* dists, int D, int S,
                     int nw, int wl, cudaStream_t st) {
  if (D <= 32)
    return launch<1, WALK, DISTS>(nbr, cdf, deg, srt, starts, u, paths, dists, D, S, nw, wl, st);
  if (D <= 512)
    return launch<16, WALK, DISTS>(nbr, cdf, deg, srt, starts, u, paths, dists, D, S, nw, wl, st);
  return launch<32, WALK, DISTS>(nbr, cdf, deg, srt, starts, u, paths, dists, D, S, nw, wl, st);
}

}  // namespace

// nbr int32 [n, D]; cdf f32 [n, D]; deg int32 [n]; srt int32 [n, D] (see the
// header); starts int32 [S]; u f32 [wl - 1, S * nw]; paths, dists int32
// [S, nw, wl]. walk = 1: the walks are drawn from u into paths, and the
// distances go to dists unless it is NULL (then deg and srt may be NULL);
// walk = 0: the walks are read from paths (cdf and u may be NULL).
extern "C" int pathnet_walk_dists(const void* nbr, const void* cdf, const void* deg,
                                  const void* srt, const void* starts, const void* u,
                                  void* paths, void* dists, int D, int S, int nw, int wl,
                                  int walk, void* stream) {
  if (S == 0 || nw == 0) return 0;
  const int *nb = (const int*)nbr, *dg = (const int*)deg, *sr = (const int*)srt,
            *st = (const int*)starts;
  const float *cd = (const float*)cdf, *uu = (const float*)u;
  int *pa = (int*)paths, *di = (int*)dists;
  cudaStream_t cs = (cudaStream_t)stream;
  if (walk && dists)
    return launch_for_width<true, true>(nb, cd, dg, sr, st, uu, pa, di, D, S, nw, wl, cs);
  if (walk)
    return launch_for_width<true, false>(nb, cd, dg, sr, st, uu, pa, di, D, S, nw, wl, cs);
  return launch_for_width<false, true>(nb, cd, dg, sr, st, uu, pa, di, D, S, nw, wl, cs);
}
