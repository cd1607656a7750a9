// pagg_contract: K4's weight contractions, the weight gradients from the
// streams of K4's launches, on Hopper's TMA and wgmma (sm_90a).
//
// Replaces the parameter part of the VJP of pathnet_tpu/models/pagg.py:235-303
// (what jax.grad derives for the weights of the encode block): _dist_select
// (pagg.py:150-176) gives dwd and dbd, lstm_scan / gru_scan
// (pathnet_tpu/nn/cells.py:22,49) give dw_ih, dw_hh and the bias sum, the MLP
// head (pagg.py:185-186) gives w = m^T d h_n and b. Over the R = wl * B walk
// steps (row t * B + b is step t of walk b; B = T * nw):
//
//   dwd[k]  = sum over rows r of class k of xr[r]^T dsel[r]    [wl, H, H]
//   dbd[k]  = sum over those rows of dsel[r]                    [wl, H]
//   dw_ih   = sum over rows of xin[r]^T dg[r]                   [H, 4H]
//   db      = sum over rows of dg[r]                            [4H]
//   dw_hh   = sum over rows of hp[r]^T dg[r]                    [H, 4H]
//
// The class of row t * B + b is walk b's clipped distance at the position
// step t holds (wl - 1 - t, homo t), read from dists [B, wl]. The GRU's
// packed gates make it the LSTM's contraction. The MLP: dwd and dbd as above,
// then dw_ih = m^T d h_n and db = sum d h_n over the B walk rows (hp holds m,
// dg d h_n, both [B, H]), and no dw_hh.
//
// Bounds on the H100. bgp microbatch (B = 327,680, wl = 4, H = 64): 96.6
// GFLOP, as 3 x 96.6 on the TF32 tensor cores (495 TFLOP/s) 0.59 ms; its
// bytes, each stream read once (xr, dsel, xin, hp 335.5 MB each, dg 1.34
// GB), 2.68 GB at 3.35 TB/s, 0.80 ms: bytes bound it. At H = 256 a row
// carries 4x the bytes and 16x the flops: operations bound it (Nba's 7,720
// walks: 3 x 36.4 GFLOP, 0.22 ms, against 0.08 ms of bytes).
//
// Design. The streams fall into groups that share rows: the class group
// (xr, dsel and dists: dwd, dbd) and the gate group (xin, hp, dg: dw_ih,
// dw_hh, db; the MLP's m and d h_n: its w and b). Each is a product D =
// A^T [B1 | B2] over the group's rows, A the gradient stream (dsel, dg,
// d h_n), B the input streams (xr; xin and hp; m), D the weights transposed.
// A block takes a tile of D, for every class, over a range of rows (a
// split). Its warps: two consumer warpgroups, a producer warp and three
// transposer warps, which meet only at mbarriers (full and empty a ring
// slot and a plane buffer), never at a block-wide barrier. Against what
// holds a split-K design with mma.sync back (a block an output tile):
// 1. Each stream staged once a tile. The class group's tile is all of D at
//    H = 64, so a split stages xr and dsel once. The gate group's tile is
//    128 gradient columns by 128 input columns (a warpgroup holds 64 x 128
//    sums and their 64 x 128 fresh stage sums, all a thread's registers
//    hold): at H = 64 a split's two tiles each stage half of dg and all of
//    xin and hp, side by side, so the second read of the narrow streams
//    comes from L2. Global to shared at the bgp microbatch: 3.36 GB, against
//    the 2.68 GB floor (a tile a job and 128 output columns: 5.37 GB). At H = 256 tiles of at
//    most 256 staged columns are chosen to stage the fewest floats a row.
// 2. TMA. The producer warp fills a ring of stages (32 rows of 32-column
//    boxes, the 128-byte swizzle) with cp.async.bulk.tensor; the maps come
//    from cuTensorMapEncodeTiled, looked up through the runtime,
//    and are __grid_constant__ parameters. A stream whose row is not a
//    multiple of 16 bytes (H % 4 != 0) or that is not 16-byte aligned takes
//    4-byte cp.async into the same layout, a route the wrapper picks before
//    the launch (contract_route).
// 3. One split a stage. TF32 wgmma reads B from shared memory K-major only,
//    and a staged tile is [rows, columns]: the transposer warps write each
//    stage's input columns' hi and lo halves (hi = x cut to TF32 by a bit
//    mask, lo = the rest cut the same way) K-major and swizzled into one of
//    two plane buffers; the consumers take A (the gradient columns) from the
//    staged boxes into registers, split there once a warpgroup and k-step,
//    and multiply with wgmma m64nNk8 (N = 128 for the gate group, 64 for the
//    class group): hi * hi + hi * lo + lo * hi, f32 accuracy.
// 4. Short chains, no sum pass of atomics. Each stage's products go to fresh
//    sums (scale-d 0, at most 12 products a chain), which f32 adds carry into
//    the block's sums. A block writes its tile's sums to its split's slot of
//    a scratch per group (17.5 MB at the bgp microbatch), and a last launch
//    adds the splits in split order: one input gives one result, bit for
//    bit. The column sums (dbd, db) are f32 sums of A's fragments in row
//    order.
// And dwd by class: the producer warp reads each stage's distances four
// stages ahead and sorts the stage's rows by clipped class with ballots,
// each class's run zero-padded to the wgmma depth of 8 rows; the planes and
// A's rows follow that order, and each run is multiplied into its class's
// sums alone (10.7 GFLOP at the bgp microbatch before the padding, where
// masked copies of every class take 43). A block holds at most 5 classes
// (MAX_CLASSES: a sorted stage's 64 places, its units): past wl = 5 the
// classes go in chunks, each chunk its own blocks over the same rows.
// The class group (with the MLP's) runs as one launch, the gate group as the
// next, then the sum.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KC = 32;                    // rows a stage: a 128-byte row of K in the planes
constexpr int BOX = 32;                   // columns a TMA box: the 128-byte swizzle span
constexpr int BOX_BYTES = KC * BOX * 4;   // 4 KB, each at a 1 KB boundary
constexpr int CONSUMERS = 256;            // two warpgroups
constexpr int TRANSPOSERS = 96;           // three warps
constexpr int THREADS = CONSUMERS + 32 + TRANSPOSERS;   // and the producer warp
constexpr int MAX_CLASSES = 5;
constexpr int NO_ROW = -(1 << 30);        // a row past the group's end
constexpr int META = 96;                  // ints of a stage's sort: perm[64], ks[8], nk[8], kpad
constexpr int TARGET_BLOCKS = 132;        // a launch: one block an SM

// The two instances. NU: a unit's sum columns (a wgmma's N); UW: units a
// warpgroup; TBMAX, TSUM: a tile's input columns (a power of 2 times NU, as
// NU is) and staged columns at most; ATOMS: 32-row blocks of K in the planes
// (a sorted stage pads each class to 8 rows: at most 64); PARTS: a unit's A
// fragments (its k-steps of a stage) are loaded in parts, each multiplied and
// waited for (32 / PARTS fragment registers beside the unit's sums and fresh
// sums: the class instance's three units' sums spill at 2, none at 4); SORT:
// stages sorted by class.
struct GateCfg {
  static constexpr int NU = 128, UW = 1, STAGES = 4, ATOMS = 1, TBMAX = 128, TSUM = 256;
  static constexpr int PARTS = 2;
  static constexpr bool SORT = false;
};
struct ClassCfg {
  static constexpr int NU = 64, UW = 3, STAGES = 3, ATOMS = 2, TBMAX = 128, TSUM = 192;
  static constexpr int PARTS = 4;
  static constexpr bool SORT = true;
};

// the ring of STAGES slots, two buffers of hi and lo planes, the stages'
// sorts, the barriers (full and empty a slot, full and empty a buffer)
template <class C>
constexpr int smem_bytes() {
  return 1024 + C::STAGES * (C::TSUM / BOX) * BOX_BYTES + 4 * C::ATOMS * C::TBMAX * 128 +
         C::STAGES * META * 4 + (2 * C::STAGES + 4) * 8;
}

// One group of streams that share rows: D [acols, nb * Hp] = A^T [B1 | B2].
struct Group {
  int a;              // the gradient stream (A), an index into the streams
  int b[2];           // the input streams (B), nb of them
  int nb, rows, acols, H, Hp;   // Hp: H rounded up to a box
  int classes;        // classes a block (a chunk's); 0: every row in one sum
  int chunks, cls_total;   // class chunks (each its own blocks), all classes
  int TA, TB;         // a tile: gradient columns (x 64), input columns (x NU)
  int tiles_a, tiles_b, splits, first;   // first: its first block in the launch
  long long span;     // rows a split, a multiple of KC
  long long part, size;   // its partials [splits, size] in the scratch
  long long prod0, prod1, cls_stride, bias;   // its region: products, column sums
  double cost;        // planning only
};

struct Launch {
  Group g[2];
  int count, blocks;
  const float* ptr[5];   // xr, dsel, xin, hp, dg
  int cols[5];
  const int* dists;      // [B, wl]
  int B, wl, homo;
};

struct Maps {
  CUtensorMap m[5];
};

struct Sums {
  long long out[2], size[2], part[2];
  int splits[2], count;
  long long total;
};

__host__ __device__ inline long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.u32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// until the phase of this parity has completed; a wait that never ends
// (2^26 tries: minutes on the card) traps rather than hold it
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (int i = 0; !mbar_try(bar, parity); ++i)
    if (i == 1 << 26) __trap();
}

// a box of 32 rows x 32 columns at (col, row) into dst, its bytes to bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(col), "r"(row)
      : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

// an arrival on bar once this thread's cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps reads of d after the wgmma_wait before it
template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]));
}

// keeps the computation of x before the next asm statement
__device__ __forceinline__ void pin(uint32_t& x) { asm volatile("" : "+r"(x)); }

// a K-major operand with the 128-byte swizzle at this shared address: 8-row
// groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// d (+)= a b: A 64 x 8 TF32 from registers, B 8 x 128 TF32 from shared memory
// (K-major, 128-byte swizzle), f32 sums; scale_d 0 drops d's old value
__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// d (+)= a b: A 64 x 8 TF32 from registers, B 8 x 64 TF32 from shared memory
// (K-major, 128-byte swizzle), f32 sums; scale_d 0 drops d's old value
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <int NU>
__device__ __forceinline__ void wgmma(float (&d)[NU / 2], const uint32_t (&a)[4], uint64_t desc,
                                      int scale_d);
template <>
__device__ __forceinline__ void wgmma<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                           int scale_d) {
  wgmma_n128(d, a, desc, scale_d);
}
template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                          int scale_d) {
  wgmma_n64(d, a, desc, scale_d);
}

// x = hi + lo + O(2^-20 |x|): hi is x cut to TF32's 10-bit mantissa, lo the
// rest cut the same way
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// element (r, c) of a staged box: 128-byte rows, 16-byte chunks swizzled by r
__device__ __forceinline__ int box_off(int r, int c) {
  return r * 128 + ((((c >> 2) ^ (r & 7))) << 4) + (c & 3) * 4;
}

// whether this group's stages are sorted by class
template <class Cfg>
__device__ __forceinline__ bool sorts(const Group& G) {
  return Cfg::SORT && G.classes > 0;
}

// Box i of a stage: the A boxes (gradient columns a0 + 32 i), then the B
// boxes (input columns b0 + 32 i in [B1 | B2], each stream padded to Hp):
// its stream and first column, or false for a box wholly past A's columns or
// the input streams (it feeds only sums that are not written).
__device__ __forceinline__ bool box_of(const Group& G, int i, int a0, int b0, int& st,
                                       int& c0) {
  const int nab = G.TA / BOX;
  if (i < nab) {
    st = G.a;
    c0 = a0 + i * BOX;
    return c0 < G.acols;
  }
  const int p = b0 + (i - nab) * BOX, s = p / G.Hp;
  st = s ? G.b[1] : G.b[0];
  c0 = p % G.Hp;
  return s < G.nb;
}

// A stage's sort by class (the producer warp; lane: the stage's row of
// distance d, NO_ROW past the group's rows), over the block's chunk of
// classes cb .. cb + G.classes - 1 (rows of other classes are left out):
// each row's place is its class's run (zero-padded to the wgmma depth of 8
// rows), then its rank in it; into meta: perm[64] (the row at each place, -1
// for padding; 32 rows in at most MAX_CLASSES runs pad to 64), the runs'
// first k-steps [64 + c] and lengths [72 + c], the padded rows [80].
__device__ __forceinline__ void sort_stage(const Launch& L, const Group& G, int* meta, int lane,
                                           int d, int cb) {
  const int cls = d == NO_ROW ? -1 : (d < 0 ? 0 : (d > L.wl - 1 ? L.wl - 1 : d)) - cb;
  int start = 0;
#pragma unroll
  for (int c = 0; c < MAX_CLASSES; ++c) {
    if (c < G.classes) {
      const unsigned bal = __ballot_sync(0xffffffffu, cls == c);
      const int cnt = __popc(bal), padded = (cnt + 7) & ~7;
      if (cls == c) meta[start + __popc(bal & ((1u << lane) - 1u))] = lane;
      if (lane < padded - cnt) meta[start + cnt + lane] = -1;
      if (lane == 0) {
        meta[64 + c] = start / 8;
        meta[72 + c] = padded / 8;
      }
      start += padded;
    }
  }
  if (lane == 0) meta[80] = start;
}

// The distance of row rs + lane of the class group (NO_ROW past its rows),
// where (pt, pb) is the step and walk of row rs (row pt * B + pb: walk pb's
// entry at the position step pt holds); moves (pt, pb) on by a stage.
__device__ __forceinline__ int stage_dist(const Launch& L, const Group& G, long long rs,
                                          long long& pt, long long& pb, int lane) {
  int d = NO_ROW;
  if (rs + lane < G.rows) {
    long long t = pt, b = pb + lane;
    for (; b >= L.B; b -= L.B) ++t;
    d = L.dists[b * L.wl + (L.homo ? t : L.wl - 1 - t)];
  }
  for (pb += KC; pb >= L.B; pb -= L.B) ++pt;
  return d;
}

// The producer warp: each stage of the block's rows into its slot, by TMA
// (or 4-byte cp.async) copies of the tile's boxes (rows past the group's end
// land as zeros); a sorted stage also gets its sort in meta, from distances
// read AHEAD stages before their stage is filled.
template <class Cfg, bool TMA>
__device__ __forceinline__ void producer(const Maps& maps, const Launch& L, const Group& G,
                                         uint8_t* raw, int* meta, uint64_t* bars, long long r0,
                                         int stages, int a0, int b0, int cb, int lane) {
  constexpr int STAGES = Cfg::STAGES, SLOT = (Cfg::TSUM / BOX) * BOX_BYTES;
  constexpr int MAXBOX = Cfg::TSUM / BOX, AHEAD = 4;
  // the tile's boxes: stream (-1: not copied) and first column
  int bst[MAXBOX], bcol[MAXBOX], copied = 0;
#pragma unroll
  for (int i = 0; i < MAXBOX; ++i) {
    int st = -1, c0 = 0;
    const bool on = i < (G.TA + G.TB) / BOX && box_of(G, i, a0, b0, st, c0);
    bst[i] = on ? st : -1;
    bcol[i] = c0;
    copied += on;
  }
  const bool sort = sorts<Cfg>(G);
  long long pt = 0, pb = 0;
  if (sort) {
    pt = r0 / L.B;
    pb = r0 - pt * L.B;
  }
  int ahead[AHEAD];
#pragma unroll
  for (int j = 0; j < AHEAD; ++j)
    ahead[j] = sort && j < stages ? stage_dist(L, G, r0 + (long long)j * KC, pt, pb, lane) : 0;
  for (int s0 = 0; s0 < stages; s0 += AHEAD) {
#pragma unroll
    for (int j = 0; j < AHEAD; ++j) {
      const int s = s0 + j, slot = s % STAGES, d = ahead[j];
      if (s >= stages) break;
      const long long rs = r0 + (long long)s * KC;
      if (sort && s + AHEAD < stages) ahead[j] = stage_dist(L, G, rs + AHEAD * KC, pt, pb, lane);
      const uint32_t full = smem_u32(bars + slot);
      uint8_t* dst = raw + slot * SLOT;
      mbar_wait(smem_u32(bars + STAGES + slot), ((s / STAGES) & 1) ^ 1);
      if (TMA) {
        if (lane == 0) {
          mbar_expect_tx(full, copied * BOX_BYTES);
#pragma unroll
          for (int i = 0; i < MAXBOX; ++i)
            if (bst[i] >= 0)
              tma_load(smem_u32(dst + i * BOX_BYTES), &maps.m[bst[i]], full, bcol[i], (int)rs);
        }
      } else {
#pragma unroll
        for (int i = 0; i < MAXBOX; ++i) {
          if (bst[i] < 0) continue;
          const float* src = L.ptr[bst[i]];
          const int ld = L.cols[bst[i]], c0 = bcol[i];
          for (int e = lane; e < KC * BOX; e += 32) {
            const int r = e / BOX, c = e % BOX;
            const long long row = rs + r;
            const bool ok = row < G.rows && c0 + c < ld;
            cp_async4(smem_u32(dst + i * BOX_BYTES + box_off(r, c)),
                      ok ? src + row * ld + c0 + c : src, ok ? 4 : 0);
          }
        }
        cp_async_arrive(full);
      }
      if (sort) sort_stage(L, G, meta + slot * META, lane, d, cb);
      mbar_arrive(full);
    }
  }
}

// The transposer warps (96 threads): each stage's input columns into the hi
// and lo planes of buffer s % 2, K-major: plane row n holds column b0 + n, K
// in 128-byte rows of 32 (a sorted stage's order, its padding as zeros). A
// thread takes 4 rows of one column, the lanes of a warp 32 columns
// (conflict-free reads and 16-byte writes).
template <class Cfg>
__device__ __forceinline__ void transpose(const Group& G, uint8_t* raw, uint8_t* planes,
                                          const int* meta, uint64_t* bars, int stages) {
  constexpr int STAGES = Cfg::STAGES;
  constexpr int SLOT = (Cfg::TSUM / BOX) * BOX_BYTES;
  constexpr int ATOM = Cfg::TBMAX * 128;
  constexpr int PLANE = Cfg::ATOMS * ATOM;
  const bool sorted = sorts<Cfg>(G);
  const int t = threadIdx.x - CONSUMERS - 32, lane = t % 32;
  const int tb_log = __ffs(G.TB) - 1, nab = G.TA / BOX;   // TB: a power of 2
  for (int s = 0; s < stages; ++s) {
    const int slot = s % STAGES, buf = s & 1;
    mbar_wait(smem_u32(bars + slot), (s / STAGES) & 1);
    mbar_wait(smem_u32(bars + 2 * STAGES + 2 + buf), ((s >> 1) & 1) ^ 1);
    const uint8_t* src = raw + slot * SLOT;
    const int* m = meta + slot * META;
    uint8_t* hi = planes + buf * 2 * PLANE;
    const int kpad = sorted ? m[80] : KC;
#pragma unroll 2
    for (int it = t; it < (kpad / 4) << tb_log; it += TRANSPOSERS) {
      const int n = it & (G.TB - 1), k = 4 * (it >> tb_log);
      int4 rows = make_int4(k, k + 1, k + 2, k + 3);
      if (sorted) rows = *(const int4*)(m + k);
      const int r[4] = {rows.x, rows.y, rows.z, rows.w};
      const uint8_t* bsrc = src + (nab + n / BOX) * BOX_BYTES;
      uint32_t h[4], l[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split(r[e] >= 0 ? *(const float*)(bsrc + box_off(r[e], n % BOX)) : 0.0f, h[e], l[e]);
      const int off = (k >> 5) * ATOM + n * 128 + ((((k & 31) >> 2) ^ (n & 7)) << 4);
      *(uint4*)(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
      *(uint4*)(hi + PLANE + off) = make_uint4(l[0], l[1], l[2], l[3]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(smem_u32(bars + 2 * STAGES + buf));   // the planes are in
      mbar_arrive(smem_u32(bars + STAGES + slot));      // this warp is done with the slot
    }
  }
}

// The consumers' part of a block (threads 0-255, two warpgroups): each
// stage's units' products (A from the staged boxes, split here; B from the
// transposers' planes), then the block's sums into its split's slot of the
// group's partials.
template <class Cfg>
__device__ __forceinline__ void consume(const Group& G, uint8_t* raw, uint8_t* planes, int* meta,
                                        uint64_t* bars, float* __restrict__ part, int split_i,
                                        int stages, int a0, int b0, int tb, int cb) {
  constexpr int NU = Cfg::NU, UW = Cfg::UW, STAGES = Cfg::STAGES;
  constexpr int SLOT = (Cfg::TSUM / BOX) * BOX_BYTES;
  constexpr int ATOM = Cfg::TBMAX * 128;         // 32 rows of K in a plane
  constexpr int PLANE = Cfg::ATOMS * ATOM;
  constexpr int KS = KC / 8;                     // k-steps of an unsorted stage
  constexpr int PARTS = Cfg::PARTS, KH = KS / PARTS;
  const bool sorted = sorts<Cfg>(G);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tid = threadIdx.x, wg = tid / 128, w = warp % 4, g = lane / 4, q = lane % 4;
  // the chunk's classes (the last chunk may hold fewer)
  const int ncls = G.classes > 0 ? min(G.classes, G.cls_total - cb) : 1;
  const int na = G.TA / 64, nbn = G.TB / NU, units = na * nbn * ncls;
  float acc[UW][NU / 2], fresh[NU / 2], cs[UW][2];
#pragma unroll
  for (int u = 0; u < UW; ++u) {
#pragma unroll
    for (int i = 0; i < NU / 2; ++i) acc[u][i] = 0.0f;
    cs[u][0] = cs[u][1] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < NU / 2; ++i) fresh[i] = 0.0f;

  for (int s = 0; s < stages; ++s) {
    const int slot = s % STAGES, buf = s & 1;
    mbar_wait(smem_u32(bars + slot), (s / STAGES) & 1);
    mbar_wait(smem_u32(bars + 2 * STAGES + buf), (s >> 1) & 1);
    const uint8_t* src = raw + slot * SLOT;
    const int* m = meta + slot * META;
    const uint32_t hi_plane = smem_u32(planes + buf * 2 * PLANE), lo_plane = hi_plane + PLANE;

    // each unit: its class's k-steps of A (gradient columns mt * 64 ..,
    // from the staged boxes, split here) times its plane columns
#pragma unroll
    for (int u = 0; u < UW; ++u) {
      const int ug = wg + 2 * u;
      if (ug < units) {
        const int nc = ug % nbn, mt = ug / nbn % na, c = ug / (nbn * na);
        // warp-uniform to the compiler (redux), so the wgmma chain is not
        // serialized as if its k-steps diverged
        const int ks = __reduce_max_sync(0xffffffffu, sorted ? m[64 + c] : 0);
        const int nk = __reduce_max_sync(0xffffffffu, sorted ? m[72 + c] : KS);
        if (nk == 0) continue;   // no row of this class in the stage
        const bool owner = nc == 0 && tb == 0;   // it takes the column sums
        const int col = mt * 64 + 16 * w + g, c0 = col % BOX;
        const uint8_t* abox = src + col / BOX * BOX_BYTES;
        const uint32_t nbase = nc * NU * 128;
#pragma unroll
        for (int h = 0; h < PARTS; ++h) {
          if (h * KH >= nk) break;   // a short class run
          uint32_t ahi[KH][4], alo[KH][4];
#pragma unroll
          for (int jj = 0; jj < KH; ++jj) {
            const int j = h * KH + jj;
            if (j < nk) {
              float a[4];
#pragma unroll
              for (int e = 0; e < 2; ++e) {   // rows q and q + 4 of the k-step
                const int pos = (ks + j) * 8 + q + 4 * e;
                const int r = sorted ? m[pos] : pos;
                a[2 * e] = r >= 0 ? *(const float*)(abox + box_off(r, c0)) : 0.0f;
                a[2 * e + 1] = r >= 0 ? *(const float*)(abox + box_off(r, c0 + 8)) : 0.0f;
              }
              // a0 (g, q), a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8, q + 4)
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                split(a[i], ahi[jj][i], alo[jj][i]);
                pin(ahi[jj][i]);   // split before the fence, not between the products
                pin(alo[jj][i]);
              }
              if (owner) {
                cs[u][0] += a[0] + a[2];
                cs[u][1] += a[1] + a[3];
              }
            }
          }
          wgmma_fence();
#pragma unroll
          for (int jj = 0; jj < KH; ++jj) {
            const int j = h * KH + jj;
            if (j < nk) {
              const int kst = ks + j;
              const uint32_t off = (kst >> 2) * ATOM + nbase + (kst & 3) * 32;
              wgmma<NU>(fresh, alo[jj], desc_sw128(hi_plane + off), j > 0);
              wgmma<NU>(fresh, ahi[jj], desc_sw128(lo_plane + off), 1);
              wgmma<NU>(fresh, ahi[jj], desc_sw128(hi_plane + off), 1);
            }
          }
          wgmma_commit();
          wgmma_wait();
        }
        hold(fresh);
#pragma unroll
        for (int i = 0; i < NU / 2; ++i) acc[u][i] += fresh[i];
      }
    }
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(smem_u32(bars + STAGES + slot));          // the slot is read
      mbar_arrive(smem_u32(bars + 2 * STAGES + 2 + buf));   // so are the planes
    }
  }

  // D's entry (m, n) of class c: input column n % Hp of input stream n / Hp
  float* P = part + G.part + split_i * G.size;
#pragma unroll
  for (int u = 0; u < UW; ++u) {
    const int ug = wg + 2 * u;
    if (ug < units) {
      const int nc = ug % nbn, mt = ug / nbn % na, c = ug / (nbn * na);
      const int mrow = a0 + mt * 64 + 16 * w + g;
#pragma unroll
      for (int i = 0; i < NU / 2; ++i) {
        const int mm = mrow + ((i >> 1) & 1) * 8;
        const int n = b0 + nc * NU + (i >> 2) * 8 + 2 * q + (i & 1);
        const int st = n / G.Hp, j = n % G.Hp;
        if (mm < G.acols && st < G.nb && j < G.H)
          P[(st ? G.prod1 : G.prod0) + (cb + c) * G.cls_stride + (long long)j * G.acols + mm] =
              acc[u][i];
      }
      if (nc == 0 && tb == 0) {
        // a column's rows lie with the four lanes of its quad
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float t = cs[u][e] + __shfl_xor_sync(0xffffffffu, cs[u][e], 1);
          t += __shfl_xor_sync(0xffffffffu, t, 2);
          const int mm = mrow + 8 * e;
          if (q == 0 && mm < G.acols) P[G.bias + (long long)(cb + c) * G.acols + mm] = t;
        }
      }
    }
  }
}

// One tile of one group's D over one split's rows, into that split's slot of
// the group's partials. Warps 0-7: two consumer warpgroups; warps 8-11: the
// producer warp and three transposer warps (setmaxnreg moves their
// registers to the consumers). Grid: the launch's groups' tiles x class
// chunks x splits, one group after another.
template <class Cfg, bool TMA>
__global__ void __launch_bounds__(THREADS, 1)
    contract_kernel(const __grid_constant__ Maps maps, const __grid_constant__ Launch L,
                    float* __restrict__ part) {
  constexpr int STAGES = Cfg::STAGES;
  constexpr int SLOT = (Cfg::TSUM / BOX) * BOX_BYTES;
  constexpr int PLANE = Cfg::ATOMS * Cfg::TBMAX * 128;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* raw = (uint8_t*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  uint8_t* planes = raw + STAGES * SLOT;         // two buffers, each hi then lo
  int* meta = (int*)(planes + 4 * PLANE);
  // full[STAGES], empty[STAGES], then the planes' full[2] and empty[2]
  uint64_t* bars = (uint64_t*)(meta + STAGES * META);

  const int gi = L.count > 1 && (int)blockIdx.x >= L.g[1].first ? 1 : 0;
  const Group G = gi ? L.g[1] : L.g[0];
  const int local = (int)blockIdx.x - G.first, tiles = G.tiles_a * G.tiles_b;
  const int tile = local % tiles, chunk = local / tiles % G.chunks;
  const int split_i = local / tiles / G.chunks, cb = chunk * G.classes;
  const int tb = tile % G.tiles_b;
  const int a0 = tile / G.tiles_b * G.TA, b0 = tb * G.TB;
  const long long r0 = split_i * G.span;
  const long long r1 = r0 + G.span < G.rows ? r0 + G.span : G.rows;
  const int stages = r0 < r1 ? (int)cdiv(r1 - r0, KC) : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(bars + s), TMA ? 32 : 64);
      mbar_init(smem_u32(bars + STAGES + s), (CONSUMERS + TRANSPOSERS) / 32);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(smem_u32(bars + 2 * STAGES + b), TRANSPOSERS / 32);
      mbar_init(smem_u32(bars + 2 * STAGES + 2 + b), CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= CONSUMERS / 32) {
    // the producer's warpgroup (the producer warp, the transposers) hands
    // its registers to the consumers: 128 x 120 + 256 x 192 = 384 x 168, the
    // launch's (an inc past what the decs free would wait for ever); at 56 /
    // 224 the producer's roles spill
    asm volatile("setmaxnreg.dec.sync.aligned.u32 120;\n" ::: "memory");
    if (warp == CONSUMERS / 32) {
      producer<Cfg, TMA>(maps, L, G, raw, meta, bars, r0, stages, a0, b0, cb, lane);
    } else {
      transpose<Cfg>(G, raw, planes, meta, bars, stages);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 192;\n" ::: "memory");
    consume<Cfg>(G, raw, planes, meta, bars, part, split_i, stages, a0, b0, tb, cb);
  }
}

// out[i] = the splits' partials of entry i added in split order.
__global__ void contract_sum_kernel(const float* __restrict__ part, float* __restrict__ out,
                                    const Sums S) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < S.total;
       i += (long long)gridDim.x * blockDim.x) {
    const int k = S.count > 1 && i >= S.out[1] ? 1 : 0;
    const long long j = i - S.out[k], size = S.size[k];
    const float* p = part + S.part[k] + j;
    float s = p[0];
    for (int t = 1; t < S.splits[k]; ++t) s += p[t * size];
    out[i] = s;
  }
}

// The tile of D that stages the fewest floats a row, all tiles counted, with
// at most 2 UW units (64 x NU sums of one class) a block.
template <class Cfg>
void choose_tile(Group& G) {
  const int Ap = (int)cdiv(G.acols, 64) * 64, Bp = G.nb * G.Hp;
  const int C = G.classes > 0 ? G.classes : 1;
  long long best = -1;
  for (int TA = 64; TA <= Ap && TA + Cfg::NU <= Cfg::TSUM; TA += 64)
    for (int TB = Cfg::NU; TB <= Cfg::TBMAX && TA + TB <= Cfg::TSUM && TB < Bp + Cfg::NU;
         TB += Cfg::NU) {
      if ((TA / 64) * (TB / Cfg::NU) * C > 2 * Cfg::UW) continue;
      const long long tiles = cdiv(Ap, TA) * cdiv(Bp, TB), cost = tiles * (TA + TB);
      if (best < 0 || cost < best || (cost == best && tiles < (long long)G.tiles_a * G.tiles_b)) {
        best = cost;
        G.TA = TA;
        G.TB = TB;
        G.tiles_a = (int)cdiv(Ap, TA);
        G.tiles_b = (int)cdiv(Bp, TB);
      }
    }
  // a row's time in a tile (s): its staged bytes at a 132nd of 3.35 TB/s or
  // its 3xTF32 flops at a 132nd of 330 TFLOP/s, the larger
  const double bytes = (G.TA + G.TB) * 4.0, flops = 6.0 * G.TA * G.TB * (C > 1 ? 1.3 : 1.0);
  const double t = bytes / 25e9 > flops / 2.5e12 ? bytes / 25e9 : flops / 2.5e12;
  G.cost = t * G.rows * G.tiles_a * G.tiles_b * G.chunks;
}

Group make_group(int a, int b0, int b1, long long rows, int acols, int H, int classes) {
  Group G{};
  G.a = a;
  G.b[0] = b0;
  G.b[1] = b1;
  G.nb = b1 < 0 ? 1 : 2;
  G.rows = (int)rows;
  G.acols = acols;
  G.H = H;
  G.Hp = (int)cdiv(H, BOX) * BOX;
  G.classes = classes;
  G.chunks = 1;
  return G;
}

// Splits for a launch's groups, each group's blocks in proportion to its
// cost, a launch TARGET_BLOCKS (each split 4 stages at least); their
// partials from offset `at` in the scratch.
void plan_splits(Launch& L, long long& at) {
  double total = 0;
  for (int i = 0; i < L.count; ++i) total += L.g[i].cost;
  L.blocks = 0;
  for (int i = 0; i < L.count; ++i) {
    Group& G = L.g[i];
    const int tiles = G.tiles_a * G.tiles_b * G.chunks;   // blocks a split
    long long splits = total > 0 ? (long long)(TARGET_BLOCKS * G.cost / total / tiles + 0.5) : 1;
    const long long most = cdiv(G.rows, 4 * KC);
    splits = splits < most ? splits : most;
    splits = splits > 0 ? splits : 1;
    G.span = cdiv(cdiv(G.rows, splits), KC) * KC;
    G.span = G.span > 0 ? G.span : KC;
    G.splits = (int)(G.rows > 0 ? cdiv(G.rows, G.span) : 1);
    G.first = L.blocks;
    L.blocks += tiles * G.splits;
    G.part = at;
    at += G.splits * G.size;
  }
}

struct Plan {
  Launch cls, gate;   // gate.count 0: the MLP
  Sums sums;
  long long scratch;
};

// The groups at these shapes: the class group (dwd, dbd: the output's first
// region), then the gate group (dw_ih, db, dw_hh) or the MLP's (w, b).
Plan make_plan(int B, int wl, int H, bool homo, bool mlp) {
  Plan P{};
  const long long R = (long long)wl * B;
  const int G4 = 4 * H;
  // wl classes in chunks of at most MAX_CLASSES, each chunk its own blocks
  // (a stage's sort and a block's units hold MAX_CLASSES classes)
  const int chunks = wl > MAX_CLASSES ? (int)cdiv(wl, MAX_CLASSES) : 1;
  Group d = make_group(1, 0, -1, R, H, H, (int)cdiv(wl, chunks));
  d.chunks = chunks;
  d.cls_total = wl;
  d.size = (long long)wl * H * H + (long long)wl * H;
  d.cls_stride = (long long)H * H;
  d.bias = (long long)wl * H * H;
  choose_tile<ClassCfg>(d);
  Group e = mlp ? make_group(4, 3, -1, B, H, H, 0) : make_group(4, 2, 3, R, G4, H, 0);
  if (mlp) {
    e.size = (long long)H * H + H;
    e.bias = (long long)H * H;
    choose_tile<ClassCfg>(e);
  } else {
    e.size = 2LL * H * G4 + G4;
    e.bias = (long long)H * G4;
    e.prod1 = (long long)H * G4 + G4;
    choose_tile<GateCfg>(e);
  }
  long long at = 0;
  P.cls.g[0] = d;
  P.cls.count = 1;
  if (mlp) {
    P.cls.g[P.cls.count++] = e;
  } else {
    P.gate.g[0] = e;
    P.gate.count = 1;
  }
  plan_splits(P.cls, at);
  if (!mlp) plan_splits(P.gate, at);
  P.scratch = at;
  const Group& E = mlp ? P.cls.g[1] : P.gate.g[0];
  P.sums.count = 2;
  P.sums.out[0] = 0;
  P.sums.out[1] = d.size;
  P.sums.size[0] = d.size;
  P.sums.size[1] = E.size;
  P.sums.part[0] = P.cls.g[0].part;
  P.sums.part[1] = E.part;
  P.sums.splits[0] = P.cls.g[0].splits;
  P.sums.splits[1] = E.splits;
  P.sums.total = d.size + E.size;
  Launch* Ls[2] = {&P.cls, &P.gate};
  for (Launch* L : Ls) {
    L->B = B;
    L->wl = wl;
    L->homo = homo;
  }
  return P;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// a [rows, cols] f32 row-major stream as 32 x 32 boxes, 128-byte swizzle,
// out-of-bounds rows and columns read as zeros
bool encode(EncodeTiled fn, CUtensorMap* map, const float* ptr, long long rows, int cols) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t box[2] = {BOX, KC}, one[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, (void*)ptr, dims, strides, box, one,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class Cfg, bool TMA>
cudaError_t launch(const Maps& maps, const Launch& L, float* part, cudaStream_t st) {
  if (L.count == 0 || L.blocks == 0) return cudaSuccess;
  // the shared-memory size is set once a device (two threads may both set it)
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64 || !ready[dev]) {
    e = cudaFuncSetAttribute(contract_kernel<Cfg, TMA>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<Cfg>());
    if (e != cudaSuccess) return e;
    if (dev < 64) ready[dev] = true;
  }
  contract_kernel<Cfg, TMA><<<L.blocks, THREADS, smem_bytes<Cfg>(), st>>>(maps, L, part);
  return cudaGetLastError();
}

}  // namespace

// Floats of the scratch `part` of pathnet_pagg_contract at these shapes: each
// group's splits x its outputs.
extern "C" long long pathnet_pagg_contract_scratch(int B, int wl, int H, int mlp) {
  return make_plan(B, wl, H, false, mlp != 0).scratch;
}

// xr, dsel, xin, hp [wl, B, H] f32 (the MLP: xin unread, hp [B, H]); dg [wl,
// B, 4H] (the MLP: d h_n [B, H]); dists int32 [B, wl]; part f32
// [pathnet_pagg_contract_scratch]; out f32: dwd [wl, H, H], dbd [wl, H],
// dw_ih [H, G], db [G] and (not the MLP) dw_hh [H, 4H], one after another (G
// = 4H, the MLP H). tma: every stream 16-byte aligned and H % 4 == 0 (TMA
// copies; else 4-byte cp.async).
extern "C" int pathnet_pagg_contract(const void* xr, const void* dsel, const void* xin,
                                     const void* hp, const void* dg, const void* dists,
                                     void* part, void* out, int B, int wl, int H, int homo,
                                     int mlp, int tma, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Plan P = make_plan(B, wl, H, homo != 0, mlp != 0);
  if (P.sums.total == 0) return 0;
  const Launch* planned[2] = {&P.cls, &P.gate};
  for (const Launch* L : planned)
    for (int i = 0; i < L->count; ++i)
      if (L->g[i].TA == 0) return (int)cudaErrorInvalidValue;   // no tile at these shapes
  const long long R = (long long)wl * B;
  const float* ptr[5] = {(const float*)xr, (const float*)dsel, (const float*)xin,
                         (const float*)hp, (const float*)dg};
  const long long rows[5] = {R, R, R, mlp ? B : R, mlp ? B : R};
  const int cols[5] = {H, H, H, H, mlp ? H : 4 * H};
  Launch* Ls[2] = {&P.cls, &P.gate};
  for (Launch* L : Ls) {
    L->dists = (const int*)dists;
    for (int i = 0; i < 5; ++i) {
      L->ptr[i] = ptr[i];
      L->cols[i] = cols[i];
    }
  }
  Maps maps{};
  if (tma && R > 0) {
    const EncodeTiled fn = encoder();
    if (fn == nullptr) return (int)cudaErrorNotSupported;
    for (int i = 0; i < 5; ++i)
      if (ptr[i] != nullptr && !encode(fn, &maps.m[i], ptr[i], rows[i], cols[i]))
        return (int)cudaErrorInvalidValue;
  }
  float* pt = (float*)part;
  cudaError_t e = tma ? launch<ClassCfg, true>(maps, P.cls, pt, st)
                      : launch<ClassCfg, false>(maps, P.cls, pt, st);
  if (e != cudaSuccess) return (int)e;
  e = tma ? launch<GateCfg, true>(maps, P.gate, pt, st)
          : launch<GateCfg, false>(maps, P.gate, pt, st);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = cdiv(P.sums.total, 256) < 132 * 16 ? cdiv(P.sums.total, 256) : 132 * 16;
  contract_sum_kernel<<<(int)blocks, 256, 0, st>>>(pt, (float*)out, P.sums);
  return (int)cudaGetLastError();
}
