// K5: row gather out[i, :] = tbl[idx[i], :] and its VJP, f32.
//
// Replaces the Pallas row-gather probe, scripts/pallas_gather_probe.py:68
// (bodies int_indexing, take, row_shuffle_axis0 at :31-44), and the
// function that pagg_forward's gather_fn hook computes for the ego rows
// (pathnet_tpu/models/pagg.py:209,309). The backward scatters each output
// row's gradient back into dtbl [n, C] with atomicAdd (the caller zeroes
// dtbl), which is what index_add_ computes.
// One thread moves one float4 (or one float when C is not a multiple of 4);
// consecutive threads take consecutive columns of a row, so each row is one
// coalesced read and one coalesced write. Bound on the H100: bytes, 2 m C
// floats plus the indices, over 3.35 TB/s.
#include <cuda_runtime.h>

__global__ void row_gather_vec_kernel(const float4* __restrict__ tbl,
                                      const int* __restrict__ idx,
                                      float4* __restrict__ out, long long total,
                                      int C4) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const long long i = e / C4;
    const int c = (int)(e - i * C4);
    out[e] = tbl[(long long)idx[i] * C4 + c];
  }
}

__global__ void row_gather_kernel(const float* __restrict__ tbl,
                                  const int* __restrict__ idx,
                                  float* __restrict__ out, long long total, int C) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const long long i = e / C;
    const int c = (int)(e - i * C);
    out[e] = tbl[(long long)idx[i] * C + c];
  }
}

__global__ void row_gather_bwd_kernel(const float* __restrict__ dout,
                                      const int* __restrict__ idx,
                                      float* __restrict__ dtbl, long long total,
                                      int C) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const long long i = e / C;
    const int c = (int)(e - i * C);
    atomicAdd(dtbl + (long long)idx[i] * C + c, dout[e]);
  }
}

static int grid_for(long long total) {
  long long blocks = (total + 255) / 256;
  return (int)(blocks < 132 * 32 ? (blocks > 0 ? blocks : 1) : 132 * 32);
}

extern "C" int pathnet_row_gather(const void* tbl, const void* idx, void* out,
                                  int m, int C, void* stream) {
  if (m == 0 || C == 0) return 0;
  if (C % 4 == 0 && ((size_t)tbl & 15) == 0 && ((size_t)out & 15) == 0) {
    const long long total = (long long)m * (C / 4);
    row_gather_vec_kernel<<<grid_for(total), 256, 0, (cudaStream_t)stream>>>(
        (const float4*)tbl, (const int*)idx, (float4*)out, total, C / 4);
  } else {
    const long long total = (long long)m * C;
    row_gather_kernel<<<grid_for(total), 256, 0, (cudaStream_t)stream>>>(
        (const float*)tbl, (const int*)idx, (float*)out, total, C);
  }
  return (int)cudaGetLastError();
}

extern "C" int pathnet_row_gather_bwd(const void* dout, const void* idx,
                                      void* dtbl, int m, int C, void* stream) {
  if (m == 0 || C == 0) return 0;
  const long long total = (long long)m * C;
  row_gather_bwd_kernel<<<grid_for(total), 256, 0, (cudaStream_t)stream>>>(
      (const float*)dout, (const int*)idx, (float*)dtbl, total, C);
  return (int)cudaGetLastError();
}
