// Tile products on the fp32 CUDA cores, for the SSD backward
// (ssd_backward.cuh).  Operands are staged in shared
// memory as fp32 rows; a thread computes 4 x 4 output elements at a time.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace simt_tile {

__device__ __forceinline__ float as_float(float x) { return x; }
__device__ __forceinline__ float as_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// d rounded up to whole 4-column micro tiles
__host__ __device__ constexpr int round4(int d) { return (d + 3) / 4 * 4; }
// row stride (floats) of a staged [rows][d] tile: odd, so a walk down a
// column touches distinct banks
__host__ __device__ constexpr int stride_of(int d) { return round4(d) + 1; }

// c[i][j] += sum_{t < K} A[i * sam + t * sak] * B[t * sbk + j * sbn]
__device__ __forceinline__ void micro(const float* A, int sam, int sak,
                                      const float* B, int sbk, int sbn, int K,
                                      float c[4][4]) {
  for (int t = 0; t < K; ++t) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = A[i * sam + t * sak];
      b[i] = B[t * sbk + i * sbn];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
  }
}

__device__ __forceinline__ void zero(float c[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
}

// dst[r][c] (row stride ds) = src[r * row_stride + c] as fp32 for r <
// valid_rows and c < d, zeros elsewhere in [rows][round4(d)]
template <int kThreads, typename T>
__device__ void stage(float* dst, int ds, const T* src, int64_t row_stride,
                      int rows, int valid_rows, int d) {
  const int dp = round4(d);
  for (int idx = threadIdx.x; idx < rows * dp; idx += kThreads) {
    const int r = idx / dp, c = idx - r * dp;
    dst[r * ds + c] =
        r < valid_rows && c < d ? as_float(src[r * row_stride + c]) : 0.f;
  }
}

// dst[i] = 0 for i < n
template <int kThreads>
__device__ void clear(float* dst, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = 0.f;
}

}  // namespace simt_tile
