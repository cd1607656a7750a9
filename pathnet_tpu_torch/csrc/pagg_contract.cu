// pagg_contract: K4's weight contractions, the weight gradients from the
// streams of K4's launches.
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
// Design. Each contraction is a job C[M, N] = A^T B over its rows, A [rows,
// M] and B [rows, N] read in place, row-major. A block takes a BM x BN tile
// of one job's output and a range of rows: the rows are split across blocks
// (split-K), each block staging KC rows of its A and B columns into shared
// memory with 16-byte cp.async (4-byte where H is not a multiple of 4), a
// ring of STAGES, and multiplying them on the tensor cores: mma.sync m16n8k8
// TF32 with the 3xTF32 split, hi = a cut to TF32, lo = (a - hi) cut to TF32,
// hi*hi + hi*lo + lo*hi (within ~2^-20 relative of the f32 product). Its
// warps each hold a 32 x 32 tile, 2 along M and WN along N. The tensor cores' f32
// sums drop low bits on every add, so each stage's products go to fresh sums
// that f32 adds carry into the block's. dwd is one job whose B has wl
// classes side by side: column c * hp + n is dsel's column n masked to the
// rows of class c (hp, a power of 2 >= H), so a block stages xr and dsel
// once and its warps take different classes: wl x the products of dwd (43
// GFLOP in place of 10.7 at the bgp microbatch), no regrouping copy. The
// blocks at the first M tile also take the column sums of their B (dbd, db).
// The column sums come from the B fragments of the warps at the first 32 A
// columns, added across each quad of lanes with shuffles. A block reads
// each of its rows of A and B once; the blocks of a split run
// side by side, so what two of them share (dg, for dw_ih and dw_hh) comes
// from L2. Every block writes its partial sums to its split's row of the
// scratch `part` [splits, total]; no atomics. A second launch adds the
// splits in split order, so one input gives one result, bit for bit.
//
// Bound on the H100 (bgp microbatch: B = 327,680, wl = 4, H = 64): the
// function's 96.6 GFLOP (2 R H^2 + 2 x 2 R H 4H) as 3 x 96.6 on the TF32
// tensor cores (495 TFLOP/s) take 0.59 ms; its bytes, each stream read once
// (xr, dsel, xin, hp 335.5 MB each, dg 1.34 GB), 2.68 GB at 3.35 TB/s, 0.80
// ms: bytes bound it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KC = 32;               // rows a stage
constexpr int STAGES = 3;            // a ring of stages in shared memory
constexpr int WN = 4;                // warps along N (2 along M), each a 32 x 32 tile
constexpr int MIN_BLOCKS = 2;        // blocks an SM holds at least (caps the registers)
constexpr int BM = 64, BN = 32 * WN;   // a block's output tile
constexpr int THREADS = 64 * WN;
constexpr int LDA = BM + 8;          // a staged row of A, padded: fragment loads hit 32 banks
constexpr int MAX_JOBS = 3;
constexpr int TARGET_BLOCKS = 132 * 8;   // blocks a launch aims at: splits x tiles
// (WN, MIN_BLOCKS) = (4, 2) is as fast as (8, 1) and faster than (2, 4) at
// the bgp microbatch (bench_encode.py --contract, PERF.md)
constexpr int SMEM = STAGES * (KC * LDA + KC * (BN + 8) + KC) * 4;   // dynamic shared bytes

struct Job {
  const float* a;   // [rows, M]
  const float* b;   // [rows, N]
  long long out;    // offset of its [max(classes, 1), M, N] sums in a split's partials
  long long bias;   // offset of its [max(classes, 1), N] column sums of b, or -1
  int rows, M, N, classes;   // classes 0: one sum over every row
  int hp;           // a class's columns in the tile's numbering (classes 0: past any)
  int sb;           // B columns a block stages, min(hp, BN)
  int tiles_m, tiles_n, tiles;
};

struct Jobs {
  Job job[MAX_JOBS];
  int count, splits;
  const int* dists;   // [B, wl]
  int B, wl, homo;
  long long total;    // floats of one split's partials
};

__host__ __device__ inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

// The jobs at these shapes: dwd (+ dbd), then dw_ih (+ db), then dw_hh; the
// partials (and the output) in that order.
Jobs make_jobs(const float* xr, const float* dsel, const float* xin, const float* hp,
               const float* dg, const int* dists, int B, int wl, int H, bool homo, bool mlp) {
  Jobs J{};
  const long long R = (long long)wl * B;
  const int G = mlp ? H : 4 * H;
  auto add = [&](const float* a, const float* b, long long rows, int N, int classes,
                 bool bias) {
    Job& j = J.job[J.count++];
    j.a = a;
    j.b = b;
    j.rows = (int)rows;
    j.M = H;
    j.N = N;
    j.classes = classes;
    j.out = J.total;
    const int c = classes > 0 ? classes : 1;
    J.total += (long long)c * H * N;
    j.bias = bias ? J.total : -1;
    if (bias) J.total += (long long)c * N;
    j.hp = 1 << 30;
    if (classes > 0)
      for (j.hp = 32; j.hp < N;) j.hp *= 2;
    j.sb = j.hp < BN ? j.hp : BN;
    j.tiles_m = cdiv(H, BM);
    j.tiles_n = cdiv(classes > 0 ? (long long)classes * j.hp : N, BN);
    j.tiles = j.tiles_m * j.tiles_n;
  };
  add(xr, dsel, R, H, wl, true);
  if (mlp) {
    add(hp, dg, B, G, 0, true);
  } else {
    add(xin, dg, R, G, 0, true);
    add(hp, dg, R, G, 0, false);
  }
  int tiles = 0;
  for (int i = 0; i < J.count; ++i) tiles += J.job[i].tiles;
  // enough blocks to fill the card, each over 8 stages of rows at least
  J.splits = cdiv(TARGET_BLOCKS, tiles);
  const int most = cdiv(R, 8 * KC);
  J.splits = J.splits < most ? J.splits : most;
  J.splits = J.splits > 0 ? J.splits : 1;
  J.dists = dists;
  J.B = B;
  J.wl = wl;
  J.homo = homo;
  return J;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x = hi + lo + O(2^-20 |x|): hi is x cut to TF32's 10-bit mantissa, lo the
// rest cut the same way (two bit masks and a subtraction; a cvt.rna.tf32
// costs more issue slots than the product it feeds)
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// d += a b: A 16 x 8 (row), B 8 x 8 (col), TF32 in, f32 sums
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a distance's class: clipped to [0, wl - 1]
__device__ __forceinline__ int clip(int d, int wl) { return d < 0 ? 0 : (d > wl - 1 ? wl - 1 : d); }

// Where the distance of row r of dwd's job lies: walk b's entry at the
// position step t holds.
__device__ __forceinline__ const int* row_dist(const Jobs& J, long long r) {
  const int t = (int)(r / J.B);
  const long long b = r - (long long)t * J.B;
  return J.dists + b * J.wl + (J.homo ? t : J.wl - 1 - t);
}

// Rows r0 .. r0 + KC - 1 of A's columns m0 .. m0 + BM - 1 and B's columns
// b0 .. b0 + sb - 1 into As, Bs (rows past r1 and columns past M, N as
// zeros), and the rows' distances, unclipped, into cs (those past r1 as 0:
// their rows are zeros); one cp.async group.
template <bool V16>
__device__ __forceinline__ void stage(float* As, float* Bs, int* cs, const Jobs& J,
                                      const Job& jb, long long r0, long long r1, int m0,
                                      int b0) {
  constexpr int W = V16 ? 4 : 1;
  const int pa = BM / W, pb = jb.sb / W, na = KC * pa, ldb = jb.sb + 8;
  for (int i = threadIdx.x; i < na + KC * pb; i += THREADS) {
    const bool isb = i >= na;
    const int j = isb ? i - na : i;
    const int per = isb ? pb : pa;
    const int k = j / per, c = j % per * W;
    const float* src = isb ? jb.b : jb.a;
    const int ld = isb ? jb.N : jb.M;
    const int col = (isb ? b0 : m0) + c;
    const long long r = r0 + k;
    const bool ok = r < r1 && col < ld;   // ld % W == 0: a copy lies in or out whole
    const float* p = ok ? src + r * ld + col : src;
    float* dst = isb ? Bs + k * ldb + c : As + k * LDA + c;
    if (V16)
      cp_async16(dst, p, ok ? 16 : 0);
    else
      cp_async4(dst, p, ok ? 4 : 0);
  }
  if (jb.classes > 0 && threadIdx.x < KC) {
    const long long r = r0 + threadIdx.x;
    cp_async4(cs + threadIdx.x, r < r1 ? row_dist(J, r) : J.dists, r < r1 ? 4 : 0);
  }
  cp_async_commit();
}

// One BM x BN tile of one job's sums over one split's rows, into that
// split's partials. Grid: (tiles of every job, splits).
template <bool V16>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    contract_kernel(const Jobs J, float* __restrict__ part) {
  extern __shared__ __align__(16) float smem[];
  constexpr int SLOT = KC * LDA + KC * (BN + 8) + KC;   // floats a stage

  int x = blockIdx.x, ji = 0;
#pragma unroll
  for (int i = 0; i + 1 < MAX_JOBS; ++i)
    if (ji == i && x >= J.job[i].tiles) {
      x -= J.job[i].tiles;
      ji = i + 1;
    }
  const Job jb = ji == 0 ? J.job[0] : ji == 1 ? J.job[1] : J.job[2];
  const int m0 = x / jb.tiles_n * BM, n0 = x % jb.tiles_n * BN;
  const int b0 = n0 % jb.hp;   // the first B column staged
  const int ldb = jb.sb + 8;
  const bool masked = jb.classes > 0;
  const bool bias = jb.bias >= 0 && m0 == 0;

  // this split's rows: whole stages, the last split's cut at the rows' end
  const long long span = (long long)cdiv(cdiv(jb.rows, J.splits), KC) * KC;
  const long long r0 = blockIdx.y * span;
  const long long r1 = r0 + span < jb.rows ? r0 + span : jb.rows;
  const int stages = r0 < r1 ? cdiv(r1 - r0, KC) : 0;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 32;
  // each n-tile's staged column and class (the tile's 8 columns share one)
  int bcol[4], bcls[4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    bcol[nt] = (wn + nt * 8 + g) % jb.sb;
    bcls[nt] = (n0 + wn + nt * 8) / jb.hp;
  }
  // the column sums (the warps at wm 0, from their B fragments)
  const bool sums = bias && wm == 0;
  float acc[2][4][4] = {};
  float colsum[4] = {};

  // STAGES - 1 stages in flight while one is used
#pragma unroll
  for (int s = 0; s + 1 < STAGES; ++s) {
    float* slot = smem + s * SLOT;
    if (s < stages)
      stage<V16>(slot, slot + KC * LDA, (int*)(slot + KC * LDA + KC * (BN + 8)), J, jb,
                 r0 + (long long)s * KC, r1, m0, b0);
    else
      cp_async_commit();
  }
  for (int s = 0; s < stages; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // stage s is in; every thread is done with slot (s - 1) % STAGES
    const int next = s + STAGES - 1;
    if (next < stages) {
      float* slot = smem + next % STAGES * SLOT;
      stage<V16>(slot, slot + KC * LDA, (int*)(slot + KC * LDA + KC * (BN + 8)), J, jb,
                 r0 + (long long)next * KC, r1, m0, b0);
    } else {
      cp_async_commit();
    }
    const float* A = smem + s % STAGES * SLOT;
    const float* Bt = A + KC * LDA;
    const int* c = (const int*)(Bt + KC * (BN + 8));
    float sum[2][4][4] = {};
#pragma unroll
    for (int k0 = 0; k0 < KC; k0 += 8) {
      const int c0 = masked ? clip(c[k0 + q], J.wl) : 0;
      const int c1 = masked ? clip(c[k0 + q + 4], J.wl) : 0;
      unsigned ah[2][4], al[2][4], bhi[4][2], blo[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int m = wm + mt * 16 + g;
        split(A[(k0 + q) * LDA + m], ah[mt][0], al[mt][0]);
        split(A[(k0 + q) * LDA + m + 8], ah[mt][1], al[mt][1]);
        split(A[(k0 + q + 4) * LDA + m], ah[mt][2], al[mt][2]);
        split(A[(k0 + q + 4) * LDA + m + 8], ah[mt][3], al[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float v0 = c0 == bcls[nt] ? Bt[(k0 + q) * ldb + bcol[nt]] : 0.0f;
        const float v1 = c1 == bcls[nt] ? Bt[(k0 + q + 4) * ldb + bcol[nt]] : 0.0f;
        split(v0, bhi[nt][0], blo[nt][0]);
        split(v1, bhi[nt][1], blo[nt][1]);
        if (sums) colsum[nt] += v0 + v1;
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          mma_tf32(sum[mt][nt], al[mt], bhi[nt][0], bhi[nt][1]);
          mma_tf32(sum[mt][nt], ah[mt], blo[nt][0], blo[nt][1]);
          mma_tf32(sum[mt][nt], ah[mt], bhi[nt][0], bhi[nt][1]);
        }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] += sum[mt][nt][i];
  }
  cp_async_wait<0>();

  // column v of the tile's numbering is class v / hp's column v % hp
  const int C = masked ? jb.classes : 1;
  float* out = part + (long long)blockIdx.y * J.total + jb.out;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + wm + mt * 16 + g + (i / 2) * 8;
        const int v = n0 + wn + nt * 8 + 2 * q + i % 2;
        const int cl = v / jb.hp, n = v % jb.hp;
        if (m < jb.M && n < jb.N && cl < C)
          out[((long long)cl * jb.M + m) * jb.N + n] = acc[mt][nt][i];
      }
  if (sums) {
    // a column's rows lie with the four lanes of its quad
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float t = colsum[nt] + __shfl_xor_sync(0xffffffffu, colsum[nt], 1);
      t += __shfl_xor_sync(0xffffffffu, t, 2);
      const int v = n0 + wn + nt * 8 + g, cl = v / jb.hp, n = v % jb.hp;
      if (q == 0 && n < jb.N && cl < C)
        part[(long long)blockIdx.y * J.total + jb.bias + (long long)cl * jb.N + n] = t;
    }
  }
}

template <bool V16>
cudaError_t launch(const Jobs& J, int tiles, float* part, cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(contract_kernel<V16>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return e;
  contract_kernel<V16><<<dim3(tiles, J.splits), THREADS, SMEM, st>>>(J, part);
  return cudaGetLastError();
}

// out[i] = the splits' partials of entry i added in split order.
__global__ void contract_sum_kernel(const float* __restrict__ part, float* __restrict__ out,
                                    long long total, int splits) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    float s = part[i];
    for (int k = 1; k < splits; ++k) s += part[(long long)k * total + i];
    out[i] = s;
  }
}

}  // namespace

// Floats of the scratch `part` of pathnet_pagg_contract at these shapes:
// splits x the output's floats.
extern "C" long long pathnet_pagg_contract_scratch(int B, int wl, int H, int mlp) {
  const Jobs J = make_jobs(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, B, wl, H,
                           false, mlp != 0);
  return J.splits * J.total;
}

// xr, dsel, xin, hp [wl, B, H] f32 (the MLP: xin unread, hp [B, H]); dg [wl,
// B, 4H] (the MLP: d h_n [B, H]); dists int32 [B, wl]; part f32
// [pathnet_pagg_contract_scratch]; out f32: dwd [wl, H, H], dbd [wl, H],
// dw_ih [H, G], db [G] and (not the MLP) dw_hh [H, 4H], one after another (G
// = 4H, the MLP H). vec16: every stream 16-byte aligned and H % 4 == 0.
extern "C" int pathnet_pagg_contract(const void* xr, const void* dsel, const void* xin,
                                     const void* hp, const void* dg, const void* dists,
                                     void* part, void* out, int B, int wl, int H, int homo,
                                     int mlp, int vec16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Jobs J = make_jobs((const float*)xr, (const float*)dsel, (const float*)xin,
                           (const float*)hp, (const float*)dg, (const int*)dists, B, wl, H,
                           homo != 0, mlp != 0);
  if (J.total == 0) return 0;
  int tiles = 0;
  for (int i = 0; i < J.count; ++i) tiles += J.job[i].tiles;
  const cudaError_t e = vec16 ? launch<true>(J, tiles, (float*)part, st)
                              : launch<false>(J, tiles, (float*)part, st);
  if (e != cudaSuccess) return (int)e;
  const int blocks = cdiv(J.total, 256) < 132 * 16 ? cdiv(J.total, 256) : 132 * 16;
  contract_sum_kernel<<<blocks, 256, 0, st>>>((const float*)part, (float*)out, J.total,
                                              J.splits);
  return (int)cudaGetLastError();
}
