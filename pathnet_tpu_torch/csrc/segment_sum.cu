// Segment sum: out[v] = the rows of node v added in an order fixed by the ids.
//
// Replaces the scatter-add that JAX's gather VJP makes of every gathered
// row's gradient (pathnet_tpu/models/pagg.py:83-93, XLA's scatter): K4's
// launches store one gradient row per (walk, position) and per ego row, and
// this sums them into dh [n, H].
//
// Units. Rows lie in runs of equal ids (K4's position-0 and ego rows come 40
// a target, the padding of a microbatch as one long run to node 0). A unit is
// a run cut at every RUN-th row: at most RUN rows, named by its first row and
// its length. Only units are grouped (0.99 M of the 1.64 M rows at the bgp
// microbatch), and a long run becomes many units that different warps add.
//
// Grouping, the port's own stable LSD radix sort of the units by node, 8 bits
// a pass (one pass to n = 256, two to 65,536, three beyond), three launches a
// pass: each block of TILE items counts its digits; a warp per digit scans
// those counts over the blocks; each block ranks its items stably (a warp
// over 32 items at a time, equal digits found with __match_any_sync), stages
// them in shared memory in (digit, order) order and writes each digit's run
// out contiguously. The first pass reads the ids themselves and finds the
// units as it goes (a warp's ballot over 32 rows). Then a launch writes
// offsets[v], node v's first unit in sorted order. The order is int32 and
// depends only on the ids.
//
// Sum. A warp per TASK consecutive sorted units adds their rows one after
// another from 0, one row a load across the lanes (16-byte or 8-byte loads,
// DEPTH rows in flight), and writes each node it holds whole into out. A node
// that spans tasks leaves its part in each task in `part`, and the last launch
// adds those parts into out in an order fixed by the task count, and writes
// zeros for a node no row names. Every boundary depends only on the ids, so
// two calls give the same bits; the sum is the plain version's (each node's
// rows in row order, one after another) up to rounding where a node spans
// tasks.
//
// Bound on the H100: bytes, each row read once (1.64 M rows of 256 B at the
// bgp microbatch, ~0.42 GB, ~0.13 ms at 3.35 TB/s), plus the ids and dh. The
// sum reads the rows in node order, 256-byte rows from anywhere in the 0.42
// GB, which the card serves at ~2.5 TB/s (PERF.md, section 6).
#include <assert.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RUN_BITS = 4;
constexpr int RUN = 1 << RUN_BITS;   // rows of an aligned window; no unit crosses one
constexpr int RADIX_BITS = 8;
constexpr int RADIX = 1 << RADIX_BITS;
constexpr int WARPS = RADIX / 32;    // a sort block has a thread per digit
constexpr int CHUNKS = 16;           // 32 items a warp takes CHUNKS times in a tile
constexpr int TILE = WARPS * CHUNKS * 32;
constexpr int TASK = 32;             // units a summing warp takes, one a lane
constexpr int DEPTH = 16;            // rows a summing warp has in flight
constexpr int LONG = 32;             // tasks past which a node's parts take a whole block
constexpr unsigned FULL = 0xffffffffu;

struct Item {
  int key;   // the node
  int unit;  // first row * RUN + length - 1
  bool ok;
};

// A warp's CHUNKS x 32 items of a tile, from item `base` on, all loads
// issued before any is used. Pass 0 (ROWS): item e is row e when a unit
// starts there (the first row of a window, or an id unlike the row before),
// and its unit runs to the next start. Later passes: item e of the previous
// pass's output. `count` items in all. Every lane of the warp calls it.
template <bool ROWS>
__device__ __forceinline__ void load_items(const int* __restrict__ keys,
                                           const int* __restrict__ units, int count, int base,
                                           Item (&it)[CHUNKS]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int e = base + c * 32 + lane;
    it[c].ok = e < count;
    it[c].key = it[c].ok ? keys[e] : -1;
    it[c].unit = !ROWS && it[c].ok ? units[e] : 0;
  }
  if (!ROWS) return;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int prev = __shfl_up_sync(FULL, it[c].key, 1);
    const bool start = (lane & (RUN - 1)) == 0 || it[c].key != prev;  // a row past R starts one
    const unsigned starts = __ballot_sync(FULL, start);
    const unsigned later = lane == 31 ? 0u : starts & (FULL << (lane + 1));
    const int end = later ? __ffs(later) - 1 : 32;
    it[c].unit = ((base + c * 32 + lane) << RUN_BITS) | (end - lane - 1);
    it[c].ok = it[c].ok && start;
  }
}

__device__ __forceinline__ int warp_inclusive_scan(int x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// hist[d * tiles + b] = the items of tile b whose digit is d.
template <bool ROWS>
__global__ void __launch_bounds__(RADIX) radix_count_kernel(
    const int* __restrict__ keys, const int* __restrict__ units, const int* __restrict__ count,
    int R, int shift, int* __restrict__ hist, int tiles) {
  __shared__ int h[RADIX];
  h[threadIdx.x] = 0;
  __syncthreads();
  const int total = ROWS ? R : *count;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (blockIdx.x * TILE < total) {
    Item it[CHUNKS];
    load_items<ROWS>(keys, units, total, blockIdx.x * TILE + warp * CHUNKS * 32, it);
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c)
      if (it[c].ok) atomicAdd(&h[(it[c].key >> shift) & (RADIX - 1)], 1);
  }
  __syncthreads();
  hist[threadIdx.x * tiles + blockIdx.x] = h[threadIdx.x];
}

// A warp per digit d: hist[d][b] becomes the items of digit d in tiles
// before b; total[d] the items of digit d.
__global__ void radix_scan_kernel(int* __restrict__ hist, int* __restrict__ total, int tiles) {
  const int d = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (d >= RADIX) return;
  int* row = hist + (size_t)d * tiles;
  int run = 0;
  for (int b0 = 0; b0 < tiles; b0 += 32) {
    const int b = b0 + lane;
    const int v = b < tiles ? row[b] : 0;
    const int x = warp_inclusive_scan(v);
    if (b < tiles) row[b] = run + x - v;
    run += __shfl_sync(FULL, x, 31);
  }
  if (lane == 0) total[d] = run;
}

// Tile b's items to their places: digit d's items of earlier digits and
// tiles first, then tile b's in the order they lie. The tile is ranked and
// staged in shared memory in (digit, order) order first, so each digit's
// items go out as one contiguous run. count_out, where given, gets the
// number of items.
template <bool ROWS>
__global__ void __launch_bounds__(RADIX, 3) radix_place_kernel(
    const int* __restrict__ keys, const int* __restrict__ units, const int* count, int R,
    int shift, const int* __restrict__ hist, const int* __restrict__ total, int tiles,
    int* __restrict__ keys_out, int* __restrict__ units_out, int* count_out) {
  __shared__ int warp_sum[WARPS];
  __shared__ int start[WARPS][RADIX];  // per warp and digit: its items, then its first stage place
  __shared__ int shift_out[RADIX];     // digit d's global place minus its stage place
  __shared__ int staged;               // the tile's items
  __shared__ int stage_key[TILE], stage_unit[TILE];
  const int t = threadIdx.x;           // also a digit
  const int warp = t >> 5, lane = t & 31;
  const int tot = total[t];
  int x = warp_inclusive_scan(tot);
  if (lane == 31) warp_sum[warp] = x;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) start[w][t] = 0;
  __syncthreads();
  int digit_start = x - tot;
  for (int w = 0; w < warp; ++w) digit_start += warp_sum[w];
  if (count_out != nullptr && blockIdx.x == 0 && t == RADIX - 1) *count_out = digit_start + tot;
  const int items = ROWS ? R : *count;
  if (blockIdx.x * TILE >= items) return;  // the whole block: no item here
  Item it[CHUNKS];
  load_items<ROWS>(keys, units, items, blockIdx.x * TILE + warp * CHUNKS * 32, it);
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int d = it[c].ok ? (it[c].key >> shift) & (RADIX - 1) : RADIX;
    const unsigned peers = __match_any_sync(FULL, d);
    if (it[c].ok && lane == __ffs(peers) - 1) start[warp][d] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  int mine = 0;  // the tile's items of digit t
#pragma unroll
  for (int w = 0; w < WARPS; ++w) mine += start[w][t];
  x = warp_inclusive_scan(mine);
  __syncthreads();  // every warp_sum read above
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  int run = x - mine;
  for (int w = 0; w < warp; ++w) run += warp_sum[w];
  shift_out[t] = digit_start + hist[t * tiles + blockIdx.x] - run;
  if (t == RADIX - 1) staged = run + mine;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int c = start[w][t];
    start[w][t] = run;
    run += c;
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int d = it[c].ok ? (it[c].key >> shift) & (RADIX - 1) : RADIX;
    const unsigned peers = __match_any_sync(FULL, d);
    if (it[c].ok) {
      const int pos = start[warp][d] + __popc(peers & ((1u << lane) - 1));
      stage_key[pos] = it[c].key;
      stage_unit[pos] = it[c].unit;
    }
    __syncwarp();
    if (it[c].ok && lane == __ffs(peers) - 1) start[warp][d] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  for (int i = t; i < staged; i += RADIX) {
    const int key = stage_key[i];
    const int pos = shift_out[(key >> shift) & (RADIX - 1)] + i;
    keys_out[pos] = key;
    units_out[pos] = stage_unit[i];
  }
}

// offsets[v] = the first sorted unit whose node is v or more; offsets[n] =
// the units. Item i writes the nodes after unit i - 1's up to unit i's. A
// node id outside [0, n) stops the stream here, before any launch uses one
// as an address.
__global__ void unit_offsets_kernel(const int* __restrict__ keys, const int* __restrict__ count,
                                    int n, int* __restrict__ offsets) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int units = *count;
  if (i > units) return;
  const int key = i == units ? n : keys[i];
  assert(key >= 0 && key <= n && (i == units || key < n));
  const int lo = i == 0 ? 0 : max(keys[i - 1] + 1, 0);
  const int hi = min(key, n);
  for (int v = lo; v <= hi; ++v) offsets[v] = i;
}

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
};
template <>
struct Vec<2> {
  using T = float2;
};
template <>
struct Vec<4> {
  using T = float4;
};

__device__ __forceinline__ void add_to(float* a, float v) { a[0] += v; }
__device__ __forceinline__ void add_to(float* a, float2 v) {
  a[0] += v.x;
  a[1] += v.y;
}
__device__ __forceinline__ void add_to(float* a, float4 v) {
  a[0] += v.x;
  a[1] += v.y;
  a[2] += v.z;
  a[3] += v.w;
}

template <int VEC>
__device__ __forceinline__ void store_to(float* __restrict__ dst, const float (&acc)[VEC]) {
  using V = typename Vec<VEC>::T;
  V v;
  float* f = reinterpret_cast<float*>(&v);
#pragma unroll
  for (int e = 0; e < VEC; ++e) f[e] = acc[e];
  *reinterpret_cast<V*>(dst) = v;
}

// A warp per task of TASK sorted units: their rows added in order, a node at
// a time. A node held whole goes to out; the first node, where it began in
// an earlier task, to part[2 task]; else the last, where it goes on past the
// task, to part[2 task + 1].
template <int VEC>
__global__ void __launch_bounds__(256, VEC == 4 ? 2 : 4) unit_sum_kernel(
    const float* __restrict__ rows, const int* __restrict__ keys, const int* __restrict__ units,
    const int* __restrict__ count, int H, float* __restrict__ out, float* __restrict__ part) {
  using V = typename Vec<VEC>::T;
  const int task = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  const int total = *count;
  const int first = task * TASK;
  if (first >= total) return;
  const int j = first + lane;
  const bool has = j < total;
  const int key = has ? keys[j] : -1;
  const int unit = has ? units[j] : 0;
  const int before = first > 0 ? keys[first - 1] : -1;  // loaded with the task's own
  const int after = first + TASK < total ? keys[first + TASK] : -1;
  const int len = has ? (unit & (RUN - 1)) + 1 : 0;
  const int row0 = unit >> RUN_BITS;
  const int incl = warp_inclusive_scan(len);
  const int begin = incl - len;                  // the unit's first slot in the task
  const int nrows = __shfl_sync(FULL, incl, 31);
  const int nunits = total - first < TASK ? total - first : TASK;
  const int key_first = __shfl_sync(FULL, key, 0);
  const int key_last = __shfl_sync(FULL, key, nunits - 1);
  const bool cont_in = before == key_first;
  const bool cont_out = after == key_last;
  for (int c0 = 0; c0 < H; c0 += 32 * VEC) {
    const int c = c0 + lane * VEC;
    const bool col = c < H;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
    int cur = key_first;
    bool lead = true;  // cur is the task's first node
    auto flush = [&]() {
      if (!col) return;
      float* dst = lead && cont_in ? part + (size_t)(2 * task) * H
                   : cur == key_last && cont_out ? part + (size_t)(2 * task + 1) * H
                                                 : out + (size_t)cur * H;
      store_to<VEC>(dst + c, acc);
    };
    for (int s0 = 0; s0 < nrows; s0 += DEPTH) {
      V x[DEPTH];
      int k[DEPTH];
#pragma unroll
      for (int q = 0; q < DEPTH; ++q) {
        const int s = s0 + q;
        const int u = __popc(__ballot_sync(FULL, has && begin <= s)) - 1;  // the unit of slot s
        const int r = __shfl_sync(FULL, row0, u) + s - __shfl_sync(FULL, begin, u);
        k[q] = __shfl_sync(FULL, key, u);
        if (s < nrows && col) {
          x[q] = *reinterpret_cast<const V*>(rows + (size_t)r * H + c);
        } else {
          x[q] = V();
        }
      }
#pragma unroll
      for (int q = 0; q < DEPTH; ++q) {
        if (s0 + q >= nrows) break;
        if (k[q] != cur) {
          flush();
          cur = k[q];
          lead = false;
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
        }
        add_to(acc, x[q]);
      }
    }
    flush();
  }
}

// The part of task k that node v's sum takes: the last of its first task
// k0, the first of each later one.
__device__ __forceinline__ size_t part_row(int k0, int k) {
  return k == k0 ? 2 * (size_t)k0 + 1 : 2 * (size_t)k;
}

// A group of 2^lanes_log2 lanes per node, 256 >> lanes_log2 nodes a block.
// A node that spans at most LONG tasks gets its parts added in task order by
// its group; a node with no unit gets zeros; any other its task wrote. A
// node that spans more (the padding's run to node 0: ~320 tasks at the bgp
// microbatch) is added by the whole block after: group g adds the parts
// g, g + G, g + 2G, ... (G groups) in order, and the G sums are added in
// group order, so the order still depends only on the ids.

template <int VEC>
__global__ void __launch_bounds__(256) unit_fixup_kernel(const int* __restrict__ offsets,
                                                         const float* __restrict__ part,
                                                         float* __restrict__ out, int n, int H,
                                                         int lanes_log2) {
  using V = typename Vec<VEC>::T;
  __shared__ int longs;
  __shared__ int long_node[256];
  __shared__ float group_sum[256 * VEC];
  const int L = 1 << lanes_log2, G = 256 >> lanes_log2;
  const int g = threadIdx.x >> lanes_log2, sub = threadIdx.x & (L - 1);
  const long long v = (long long)blockIdx.x * G + g;
  if (threadIdx.x == 0) longs = 0;
  __syncthreads();
  if (v < n) {
    const int lo = offsets[v], hi = offsets[v + 1];
    const int k0 = lo / TASK, k1 = hi > lo ? (hi - 1) / TASK : k0;
    if (k1 - k0 > LONG) {
      if (sub == 0) long_node[atomicAdd(&longs, 1)] = g;
    } else if (hi == lo || k0 != k1) {
      for (int c = sub * VEC; c < H; c += VEC * L) {
        float acc[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
        for (int k = k0; k <= k1 && hi > lo; ++k)
          add_to(acc, *reinterpret_cast<const V*>(part + part_row(k0, k) * H + c));
        store_to<VEC>(out + v * H + c, acc);
      }
    }
  }
  __syncthreads();
  // the block's long nodes, in the order the atomic gave (each one's sum
  // does not depend on it)
  for (int i = 0; i < longs; ++i) {
    const long long w = (long long)blockIdx.x * G + long_node[i];
    const int k0 = offsets[w] / TASK, k1 = (offsets[w + 1] - 1) / TASK;
    for (int c0 = 0; c0 < H; c0 += VEC * L) {
      const int c = c0 + sub * VEC;
      float acc[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
      if (c < H) {
#pragma unroll 4
        for (int k = k0 + g; k <= k1; k += G)
          add_to(acc, *reinterpret_cast<const V*>(part + part_row(k0, k) * H + c));
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) group_sum[threadIdx.x * VEC + e] = acc[e];
      __syncthreads();
      if (g == 0 && c < H) {
        for (int q = 1; q < G; ++q)
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] += group_sum[(q * L + sub) * VEC + e];
        store_to<VEC>(out + w * H + c, acc);
      }
      __syncthreads();
    }
  }
}

int tiles_for(int R) { return (R + TILE - 1) / TILE; }

int passes_for(int n) {
  int bits = 0;
  while (bits < 31 && ((unsigned)(n - 1) >> bits) != 0) ++bits;
  const int p = (bits + RADIX_BITS - 1) / RADIX_BITS;
  return p > 0 ? p : 1;
}

// The scratch of `ints`: keys_t, units_t, keys [R] each, hist [RADIX * tiles],
// total [RADIX], count [1].
struct Scratch {
  int *keys_t, *units_t, *keys, *hist, *total, *count;
  Scratch(int* p, int R) {
    keys_t = p;
    units_t = keys_t + R;
    keys = units_t + R;
    hist = keys + R;
    total = hist + (size_t)RADIX * tiles_for(R);
    count = total + RADIX;
  }
};

// The units of index [R] grouped by node into s.keys and units [R] (the
// first *s.count entries) and offsets [n + 1].
int group(const int* index, int R, int n, const Scratch& s, int* units, int* offsets,
          cudaStream_t st) {
  const int tiles = tiles_for(R);
  const int passes = passes_for(n);
  const int* src_k = index;
  const int* src_u = nullptr;
  for (int p = 0; p < passes; ++p) {
    // the last pass writes keys and units, the one before it the scratch pair
    int* dst_k = (passes - 1 - p) % 2 == 0 ? s.keys : s.keys_t;
    int* dst_u = (passes - 1 - p) % 2 == 0 ? units : s.units_t;
    const int shift = p * RADIX_BITS;
    if (p == 0) {
      radix_count_kernel<true><<<tiles, RADIX, 0, st>>>(src_k, src_u, s.count, R, shift,
                                                        s.hist, tiles);
    } else {
      radix_count_kernel<false><<<tiles, RADIX, 0, st>>>(src_k, src_u, s.count, R, shift,
                                                         s.hist, tiles);
    }
    if (cudaError_t e = cudaGetLastError()) return (int)e;
    radix_scan_kernel<<<RADIX * 32 / 256, 256, 0, st>>>(s.hist, s.total, tiles);
    if (cudaError_t e = cudaGetLastError()) return (int)e;
    if (p == 0) {
      radix_place_kernel<true><<<tiles, RADIX, 0, st>>>(src_k, src_u, s.count, R, shift, s.hist,
                                                        s.total, tiles, dst_k, dst_u, s.count);
    } else {
      radix_place_kernel<false><<<tiles, RADIX, 0, st>>>(src_k, src_u, s.count, R, shift,
                                                         s.hist, s.total, tiles, dst_k, dst_u,
                                                         nullptr);
    }
    if (cudaError_t e = cudaGetLastError()) return (int)e;
    src_k = dst_k;
    src_u = dst_u;
  }
  unit_offsets_kernel<<<(R + 1 + 255) / 256, 256, 0, st>>>(s.keys, s.count, n, offsets);
  return (int)cudaGetLastError();
}

template <int VEC>
int sum_units(const float* rows, const Scratch& s, const int* units, const int* offsets, int R,
              int n, int H, float* part, float* out, cudaStream_t st) {
  const int tasks = (R + TASK - 1) / TASK;
  unit_sum_kernel<VEC><<<(unsigned)(((long long)tasks * 32 + 255) / 256), 256, 0, st>>>(
      rows, s.keys, units, s.count, H, out, part);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  // the fixup reads only part and out, whose rows are 16-byte aligned when
  // H is a multiple of 4: a lane per float4, as few lanes a node as cover it
  const bool v4 = H % 4 == 0 && ((uintptr_t)part | (uintptr_t)out) % 16 == 0;
  const int vec = v4 ? 4 : VEC;
  int lanes_log2 = 0;
  while (lanes_log2 < 5 && (vec << lanes_log2) < H) ++lanes_log2;
  const unsigned blocks = (unsigned)((((long long)n << lanes_log2) + 255) / 256);
  if (v4) {
    unit_fixup_kernel<4><<<blocks, 256, 0, st>>>(offsets, part, out, n, H, lanes_log2);
  } else {
    unit_fixup_kernel<VEC><<<blocks, 256, 0, st>>>(offsets, part, out, n, H, lanes_log2);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The int32 scratch that pathnet_segment_group and pathnet_segment_sum take.
extern "C" long long pathnet_segment_scratch(int R) {
  return 3LL * R + (long long)RADIX * tiles_for(R) + RADIX + 1;
}

// index int32 [R], each in [0, n), R <= 2^26; ints int32
// [pathnet_segment_scratch(R)]. units int32 [R]: entry j < offsets[n] is the
// j-th unit in (node, first row) order, first row * 16 + length - 1;
// offsets int32 [n + 1]: node v's units are units[offsets[v] : offsets[v + 1]].
extern "C" int pathnet_segment_group(const void* index, void* ints, void* units,
                                     void* offsets, int R, int n, void* stream) {
  if (n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (R == 0) return (int)cudaMemsetAsync(offsets, 0, (size_t)(n + 1) * sizeof(int), st);
  return group((const int*)index, R, n, Scratch((int*)ints, R), (int*)units, (int*)offsets,
               st);
}

// rows [R, H] f32; index, ints, units, offsets as pathnet_segment_group's;
// part f32 [2 ceil(R / 32), H] scratch; out [n, H] f32, every entry written.
extern "C" int pathnet_segment_sum(const void* rows, const void* index, void* ints,
                                   void* units, void* offsets, void* part, void* out, int R,
                                   int n, int H, void* stream) {
  if (n == 0 || H == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (R == 0) return (int)cudaMemsetAsync(out, 0, (size_t)n * H * sizeof(float), st);
  const Scratch s((int*)ints, R);
  int* u = (int*)units;
  int* of = (int*)offsets;
  const int rc = group((const int*)index, R, n, s, u, of, st);
  if (rc != 0) return rc;
  const uintptr_t a = (uintptr_t)rows | (uintptr_t)part | (uintptr_t)out;
  const float* r = (const float*)rows;
  float *p = (float*)part, *o = (float*)out;
  if (H % 4 == 0 && H >= 128 && a % 16 == 0) return sum_units<4>(r, s, u, of, R, n, H, p, o, st);
  if (H % 2 == 0 && a % 8 == 0) return sum_units<2>(r, s, u, of, R, n, H, p, o, st);
  return sum_units<1>(r, s, u, of, R, n, H, p, o, st);
}

