// K1 + K2: inverse-CDF random walks and their hop distances, one launch;
// K7: the k-hop distance probes, alone or fused with the walk;
// K8: the alias walk step, in place of K1's in each walking launch.
//
// Replaces pathnet_tpu/sample/alias.py:142-147 (CdfSampler.step) as scanned
// by pathnet_tpu/sample/walk.py:36-55 (sample_paths),
// pathnet_tpu/sample/distance.py:77-139 (membership_dists, wl <= 4) and
// pathnet_tpu/sample/distance.py:194-229 (_row_membership, khop_dists, any
// wl); K8 replaces pathnet_tpu/sample/alias.py:93-104 (AliasSampler.step)
// as scanned by sample_paths. Eight entries share this device code through
// four C functions: pathnet_walk_dists runs walk_dists (walks and membership
// distances, the sampler's path at wl <= 4), cdf_walk (walks only, any wl)
// and membership_dists (distances of given walks); pathnet_khop_dists runs
// walk_khop_dists (walks and k-hop distances, the sampler's path at wl >= 5)
// and khop_dists (k-hop distances of given walks); pathnet_alias_walk_dists
// runs alias_walk_dists (K8's walks and membership distances) and alias_walk
// (K8's walks only); pathnet_alias_khop_dists runs alias_walk_khop_dists
// (K8's walks and k-hop distances).
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
// Alias step (K8), the template parameter ALIAS of walk_dists_kernel and
// khop_dists_kernel: d = max(deg[cur], 1), slot = min((int)(u1 * d), d - 1)
// with the product in f32 (JAX promotes int32 x float32 to float32;
// __fmul_rn keeps it a rounded product, never contracted), then lo[cur,
// slot] if u2 < split[cur, slot], else hi[cur, slot]: four loads a step,
// whatever D is. It reads two uniforms a step from u [wl - 1, 2, W] (u1 at
// row 2 (t - 1), u2 at row 2 t - 1 of the flat [2 (wl - 1), W]) and draws
// none. The walks alone take one lane a walk; fused with the distances it
// takes the group the distance part needs: G from D with the membership
// test (its N2 scan votes), one lane with K7's searches. Every lane of a
// group makes the same step (broadcast loads) and lane 0 writes. The CDF
// instances (ALIAS false) compile as before: the step is an if constexpr
// branch beside theirs.
//
// K-hop distances (K7): d0 = 0; d1 = v1 != s; at position t >= 2 the
// smallest level k in 1..t-1 whose sorted row tables[k-1][s] holds v_t,
// else t, and 0 where v_t == s. The levels of build_khop_tables come packed
// in one buffer, each level's element offset and width beside it (off,
// wid); a row is padded with the sentinel n, greater than every node id, so
// a search over the whole padded row (in_sorted over wid[k-1] slots) needs
// no row length. Each position's distance is found as the walk reaches it,
// the levels tried from 1 up and the search stopped at the first hit, so
// the walk length has no cap and no position is held in a register. In the
// fused launch every lane of a walk's group runs the same searches (the
// loads of one address broadcast to the group) and lane 0 writes; the given
// walks' launch takes one lane a walk. Written for correctness first: at
// cornell and Nba a launch moves well under a megabyte, so it sits near the
// launch floor whatever its searches cost.
//
// Bound on the H100: latency of each walk's dependent loads (the start, the
// CDF chunks and nbr[cur, idx] for each step, or K8's deg, split, lo and hi,
// then deg[v3], nbr[v3] and the searches); the tables of every graph the
// port runs fit in the 50 MB L2. The byte bound (the tables, u, paths and
// dists once) is far lower.
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

// K8's tables (sample/alias.py AliasSampler): row cur's deg[cur] slots hold
// lo, hi and split, D slots a row. All null in the CDF instances.
struct AliasTables {
  const int* lo;
  const int* hi;
  const float* split;
  const int* deg;
};

// K8, one alias step from cur (see the header): the slot from x1, the side
// from the coin x2.
__device__ __forceinline__ int alias_step(const AliasTables& at, int cur, float x1, float x2,
                                          int D) {
  int d = at.deg[cur];
  d = d > 1 ? d : 1;
  int slot = (int)__fmul_rn(x1, (float)d);
  slot = slot < d - 1 ? slot : d - 1;
  const long long f = (long long)cur * D + slot;
  return x2 < at.split[f] ? at.lo[f] : at.hi[f];
}

// K7's walk step from cur, walk_dists_kernel's step as a function: the
// group counts the CDF entries below x, U * G at a time; returns nbr[cur,
// idx] (0 past the last walk). walk_dists_kernel keeps the step written out:
// calling this function there changed the registers of its instances.
template <int G>
__device__ __forceinline__ int cdf_step(const int* __restrict__ nbr, const float* __restrict__ cdf,
                                        int cur, float x, int D, bool live, int gl,
                                        const Group<G>& grp) {
  constexpr int U = G >= 8 ? 4 : 8;  // chunks whose loads are in flight together
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
  return live ? nbr[(long long)cur * D + idx] : 0;
}

// WALK: draw the walks from u (else read them from paths), with K8's step
// from at if ALIAS, else K1's from cdf; DISTS: write the distances. Walk w
// of start starts[w / nw] is row w of paths and dists [W, wl], W = S * nw.
template <int G, bool WALK, bool DISTS, bool ALIAS = false>
__global__ void __launch_bounds__(256)
walk_dists_kernel(const int* __restrict__ nbr, const float* __restrict__ cdf,
                  const int* __restrict__ deg, const int* __restrict__ srt,
                  const int* __restrict__ starts, const float* __restrict__ u,
                  int* __restrict__ paths, int* __restrict__ dists, int D, long long W, int nw,
                  int wl, AliasTables at) {
  constexpr int U = G >= 8 ? 4 : 8;  // chunks whose loads are in flight together
  const long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  const int lane = threadIdx.x & 31;
  const int gl = lane & (G - 1);
  const Group<G> grp{G == 32 ? FULL : ((1u << G) - 1u) << (lane - gl)};
  const bool live = w < W;
  const int s = live ? starts[w / nw] : 0;
  int* po = paths + w * wl;
  int v1 = s, v2 = s, v3 = s;
  if constexpr (WALK && ALIAS) {
    if (live && gl == 0) po[0] = s;
    int cur = s;
    for (int t = 1; t < wl; ++t) {
      // the step's uniforms do not depend on cur: in flight with deg[cur]
      const float x1 = live ? u[(2LL * t - 2) * W + w] : 0.0f;
      const float x2 = live ? u[(2LL * t - 1) * W + w] : 0.0f;
      cur = live ? alias_step(at, cur, x1, x2, D) : 0;
      if (live && gl == 0) po[t] = cur;
      if (t == 1) v1 = cur;
      if (t == 2) v2 = cur;
      if (t == 3) v3 = cur;
    }
  } else if (WALK) {
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

template <int G, bool WALK, bool DISTS, bool ALIAS = false>
int launch(const int* nbr, const float* cdf, const int* deg, const int* srt, const int* starts,
           const float* u, int* paths, int* dists, int D, int S, int nw, int wl,
           cudaStream_t stream, const AliasTables& at = AliasTables{}) {
  const long long W = (long long)S * nw;
  const int threads = 256;
  const unsigned blocks = (unsigned)((W * G + threads - 1) / threads);
  walk_dists_kernel<G, WALK, DISTS, ALIAS><<<blocks, threads, 0, stream>>>(
      nbr, cdf, deg, srt, starts, u, paths, dists, D, W, nw, wl, at);
  return (int)cudaGetLastError();
}

// The lanes a walk gets at table width D, from a sweep of every power of two
// to 32 (PERF.md, section 6): one at D <= 32 (bgp's 25), where the most
// walks in flight win; 16 at cornell's 190 and Nba's 442; 32 past 512.
template <bool WALK, bool DISTS, bool ALIAS = false>
int launch_for_width(const int* nbr, const float* cdf, const int* deg, const int* srt,
                     const int* starts, const float* u, int* paths, int* dists, int D, int S,
                     int nw, int wl, cudaStream_t st, const AliasTables& at = AliasTables{}) {
  if (D <= 32)
    return launch<1, WALK, DISTS, ALIAS>(nbr, cdf, deg, srt, starts, u, paths, dists, D, S, nw,
                                         wl, st, at);
  if (D <= 512)
    return launch<16, WALK, DISTS, ALIAS>(nbr, cdf, deg, srt, starts, u, paths, dists, D, S, nw,
                                          wl, st, at);
  return launch<32, WALK, DISTS, ALIAS>(nbr, cdf, deg, srt, starts, u, paths, dists, D, S, nw,
                                        wl, st, at);
}

// K7. WALK: draw the walks from u into paths (else read them from paths),
// with K8's step from at if ALIAS, else K1's from cdf; the k-hop distances
// into dists. tab holds the levels' [n, wid[k]] rows at element offsets
// off[k]; wl - 2 <= the number of levels.
template <int G, bool WALK, bool ALIAS = false>
__global__ void __launch_bounds__(256)
khop_dists_kernel(const int* __restrict__ nbr, const float* __restrict__ cdf,
                  const int* __restrict__ starts, const float* __restrict__ u,
                  const int* __restrict__ tab, const long long* __restrict__ off,
                  const int* __restrict__ wid, int* __restrict__ paths, int* __restrict__ dists,
                  int D, long long W, int nw, int wl, AliasTables at) {
  const long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  const int lane = threadIdx.x & 31;
  const int gl = lane & (G - 1);
  const Group<G> grp{G == 32 ? FULL : ((1u << G) - 1u) << (lane - gl)};
  const bool live = w < W;
  const bool writes = live && gl == 0;
  const int s = live ? starts[w / nw] : 0;
  int* po = paths + w * wl;
  int* dq = dists + w * wl;
  if (writes) {
    if (WALK) po[0] = s;
    dq[0] = 0;
  }
  int cur = s;
  for (int t = 1; t < wl; ++t) {
    if (WALK) {
      if constexpr (ALIAS) {
        const float x1 = live ? u[(2LL * t - 2) * W + w] : 0.0f;
        const float x2 = live ? u[(2LL * t - 1) * W + w] : 0.0f;
        cur = live ? alias_step(at, cur, x1, x2, D) : 0;
      } else {
        const float x = live ? u[(long long)(t - 1) * W + w] : 0.0f;
        cur = cdf_step<G>(nbr, cdf, cur, x, D, live, gl, grp);
      }
      if (writes) po[t] = cur;
    } else {
      cur = live ? po[t] : s;
    }
    // the smallest level k < t whose row of s holds cur, else t; 0 at s
    int d = cur == s ? 0 : t;
    for (int k = 1; d == t && k < t; ++k) {
      const int width = wid[k - 1];
      const int v[1] = {cur};
      bool hit[1];
      in_sorted<1>(tab + off[k - 1] + (long long)s * width, width, v, hit);
      if (hit[0]) d = k;
    }
    if (writes) dq[t] = d;
  }
}

template <int G, bool WALK, bool ALIAS = false>
int launch_khop(const int* nbr, const float* cdf, const int* starts, const float* u,
                const int* tab, const long long* off, const int* wid, int* paths, int* dists,
                int D, int S, int nw, int wl, cudaStream_t stream,
                const AliasTables& at = AliasTables{}) {
  const long long W = (long long)S * nw;
  const int threads = 256;
  const unsigned blocks = (unsigned)((W * G + threads - 1) / threads);
  khop_dists_kernel<G, WALK, ALIAS><<<blocks, threads, 0, stream>>>(
      nbr, cdf, starts, u, tab, off, wid, paths, dists, D, W, nw, wl, at);
  return (int)cudaGetLastError();
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

// K7. nbr int32 [n, D]; cdf f32 [n, D]; starts int32 [S]; u f32 [wl - 1,
// S * nw]; tab int32: the k-hop levels' sorted rows, level k's [n, wid[k]]
// at element offset off[k] (off int64, wid int32, one entry a level, at
// least wl - 2 levels, on the card); paths, dists int32 [S, nw, wl]. walk =
// 1: the walks are drawn from u into paths (the lanes a walk gets from D,
// as pathnet_walk_dists picks them); walk = 0: the walks are read from
// paths, one lane a walk (nbr, cdf and u may be NULL).
extern "C" int pathnet_khop_dists(const void* nbr, const void* cdf, const void* starts,
                                  const void* u, const void* tab, const void* off,
                                  const void* wid, void* paths, void* dists, int D, int S,
                                  int nw, int wl, int walk, void* stream) {
  if (S == 0 || nw == 0) return 0;
  const int *nb = (const int*)nbr, *st = (const int*)starts, *tb = (const int*)tab,
            *wd = (const int*)wid;
  const long long* of = (const long long*)off;
  const float *cd = (const float*)cdf, *uu = (const float*)u;
  int *pa = (int*)paths, *di = (int*)dists;
  cudaStream_t cs = (cudaStream_t)stream;
  if (!walk)
    return launch_khop<1, false>(nb, cd, st, uu, tb, of, wd, pa, di, D, S, nw, wl, cs);
  if (D <= 32)
    return launch_khop<1, true>(nb, cd, st, uu, tb, of, wd, pa, di, D, S, nw, wl, cs);
  if (D <= 512)
    return launch_khop<16, true>(nb, cd, st, uu, tb, of, wd, pa, di, D, S, nw, wl, cs);
  return launch_khop<32, true>(nb, cd, st, uu, tb, of, wd, pa, di, D, S, nw, wl, cs);
}

// K8. lo, hi int32 [n, D], split f32 [n, D], deg int32 [n]: the alias tables
// (sample/alias.py build_alias_tables); starts int32 [S]; u f32 [wl - 1, 2,
// S * nw]: step t's u1, then its u2; paths, dists int32 [S, nw, wl]. dists
// NULL: the walks alone, one lane a walk (nbr and srt may be NULL); else
// their membership distances too (wl <= 4; nbr and srt as
// pathnet_walk_dists takes them), the lanes a walk from D as there.
extern "C" int pathnet_alias_walk_dists(const void* lo, const void* hi, const void* split,
                                        const void* deg, const void* nbr, const void* srt,
                                        const void* starts, const void* u, void* paths,
                                        void* dists, int D, int S, int nw, int wl,
                                        void* stream) {
  if (S == 0 || nw == 0) return 0;
  const AliasTables at{(const int*)lo, (const int*)hi, (const float*)split, (const int*)deg};
  const int *nb = (const int*)nbr, *sr = (const int*)srt, *st = (const int*)starts;
  const float* uu = (const float*)u;
  int *pa = (int*)paths, *di = (int*)dists;
  cudaStream_t cs = (cudaStream_t)stream;
  if (!dists)
    return launch<1, true, false, true>(nb, nullptr, at.deg, sr, st, uu, pa, di, D, S, nw, wl,
                                        cs, at);
  return launch_for_width<true, true, true>(nb, nullptr, at.deg, sr, st, uu, pa, di, D, S, nw,
                                            wl, cs, at);
}

// K8 and K7. lo, hi, split, deg, starts and u as pathnet_alias_walk_dists
// takes them; tab, off, wid as pathnet_khop_dists takes them; paths, dists
// int32 [S, nw, wl]: the walks and their k-hop distances, one lane a walk.
extern "C" int pathnet_alias_khop_dists(const void* lo, const void* hi, const void* split,
                                        const void* deg, const void* starts, const void* u,
                                        const void* tab, const void* off, const void* wid,
                                        void* paths, void* dists, int D, int S, int nw, int wl,
                                        void* stream) {
  if (S == 0 || nw == 0) return 0;
  const AliasTables at{(const int*)lo, (const int*)hi, (const float*)split, (const int*)deg};
  return launch_khop<1, true, true>(nullptr, nullptr, (const int*)starts, (const float*)u,
                                    (const int*)tab, (const long long*)off, (const int*)wid,
                                    (int*)paths, (int*)dists, D, S, nw, wl,
                                    (cudaStream_t)stream, at);
}
