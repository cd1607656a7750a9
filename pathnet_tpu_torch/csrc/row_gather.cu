// K5: row gather out[i, :] = tbl[idx[i], :] and its VJP, f32.
//
// Replaces the Pallas row-gather probe, scripts/pallas_gather_probe.py:68
// (bodies int_indexing, take, row_shuffle_axis0 at :31-44), and the
// function that pagg_forward's gather_fn hook computes for the ego rows
// (pathnet_tpu/models/pagg.py:209,309). The backward scatters each output
// row's gradient back into dtbl [n, C] with atomicAdd (the caller zeroes
// dtbl), which is what index_add_ computes.
// Forward: a group of L lanes per row (L the row's float4s, or floats when C
// is not a multiple of 4, rounded up to a power of two, at most 32), 256 / L
// rows a block; each lane reads the row's index once (one load a group) and
// moves its columns with 32-bit offsets from the row's start. An index
// outside [0, n) stops the stream with a device-side assert, as tbl[idx]
// does, so a call is one launch. Bound on the H100: bytes, the rows read and
// written plus the indices, over 3.35 TB/s.
#include <assert.h>
#include <cuda_runtime.h>

template <typename V>
__global__ void __launch_bounds__(256) row_gather_kernel(const V* __restrict__ tbl,
                                                         const int* __restrict__ idx,
                                                         V* __restrict__ out, int m, int n,
                                                         int width, int lanes_log2) {
  const int i = blockIdx.x * (256 >> lanes_log2) + (threadIdx.x >> lanes_log2);
  if (i >= m) return;
  const int v = idx[i];
  assert(v >= 0 && v < n);
  const V* src = tbl + (size_t)v * width;
  V* dst = out + (size_t)i * width;
  for (int c = threadIdx.x & ((1 << lanes_log2) - 1); c < width; c += 1 << lanes_log2)
    dst[c] = src[c];
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

template <typename V>
static int gather(const void* tbl, const void* idx, void* out, int m, int n, int width,
                  void* stream) {
  int lanes_log2 = 0;
  while (lanes_log2 < 5 && (1 << lanes_log2) < width) ++lanes_log2;
  const int rows = 256 >> lanes_log2;
  row_gather_kernel<V><<<(m + rows - 1) / rows, 256, 0, (cudaStream_t)stream>>>(
      (const V*)tbl, (const int*)idx, (V*)out, m, n, width, lanes_log2);
  return (int)cudaGetLastError();
}

// tbl [n, C] f32, idx int32 [m], out [m, C] f32.
extern "C" int pathnet_row_gather(const void* tbl, const void* idx, void* out, int m, int n,
                                  int C, void* stream) {
  if (m == 0 || C == 0) return 0;
  if (C % 4 == 0 && ((size_t)tbl & 15) == 0 && ((size_t)out & 15) == 0)
    return gather<float4>(tbl, idx, out, m, n, C / 4, stream);
  return gather<float>(tbl, idx, out, m, n, C, stream);
}

extern "C" int pathnet_row_gather_bwd(const void* dout, const void* idx,
                                      void* dtbl, int m, int C, void* stream) {
  if (m == 0 || C == 0) return 0;
  const long long total = (long long)m * C;
  row_gather_bwd_kernel<<<grid_for(total), 256, 0, (cudaStream_t)stream>>>(
      (const float*)dout, (const int*)idx, (float*)dtbl, total, C);
  return (int)cudaGetLastError();
}
