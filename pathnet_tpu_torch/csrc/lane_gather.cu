// K6: lane gather out[i, j] = tbl[i, idx[i] mod D], f32, mod a floor mod.
//
// Replaces the Pallas probe body lane_gather_axis1
// (scripts/pallas_gather_probe.py:45-50, run by the pallas_call at :68),
// which gathers along the lane axis with take_along_axis(tbl, ids, axis=1)
// for ids = broadcast(idx[:, None] % D): each row's one selected lane is
// written across the whole row. JAX's % is a floor mod, so a negative idx
// selects a lane in [0, D); C's % truncates, and the kernel adds D back.
// One warp per row: every lane loads the same selected element (one
// broadcast transaction), then the warp writes the row with float4 stores
// when D is a multiple of 4 (a row then starts on a 16-byte boundary), else
// with float stores; consecutive lanes write consecutive addresses. Bound on
// the H100: bytes, n D floats written plus 2 n words read, over 3.35 TB/s.
#include <cuda_runtime.h>

template <bool VEC>
__global__ void lane_gather_kernel(const float* __restrict__ tbl,
                                   const int* __restrict__ idx,
                                   float* __restrict__ out, int n, int D) {
  const int lane = threadIdx.x & 31;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long i = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
       i < n; i += warps) {
    int k = idx[i] % D;
    if (k < 0) k += D;
    const float v = tbl[i * D + k];
    float* row = out + i * D;
    if (VEC) {
      const float4 v4 = make_float4(v, v, v, v);
      float4* row4 = reinterpret_cast<float4*>(row);
      for (int j = lane; j < D / 4; j += 32) row4[j] = v4;
    } else {
      for (int j = lane; j < D; j += 32) row[j] = v;
    }
  }
}

extern "C" int pathnet_lane_gather(const void* tbl, const void* idx, void* out,
                                   int n, int D, void* stream) {
  if (n == 0 || D == 0) return 0;
  const int threads = 256;                       // 8 rows per block
  long long blocks = ((long long)n + 7) / 8;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (D % 4 == 0 && ((size_t)out & 15) == 0) {
    lane_gather_kernel<true><<<(int)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)tbl, (const int*)idx, (float*)out, n, D);
  } else {
    lane_gather_kernel<false><<<(int)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)tbl, (const int*)idx, (float*)out, n, D);
  }
  return (int)cudaGetLastError();
}
