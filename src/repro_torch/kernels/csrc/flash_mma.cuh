// Split-TF32 tile pieces of the f32-capable flash kernels (flash_simt.cuh,
// flash_backward.cuh): the split, the three products, the fragment loaders
// and the cp.async staging come from tf32x3.cuh (shared with the SSD
// kernels; its notes give the split and the fragment k orders); here are
// the product over a row of n-tiles that P V and the backward's dK / dV
// take, and the walk over the tiles some row can see.
#pragma once

#include "flash_common.cuh"
#include "hopper_ptx.cuh"
#include "tf32x3.cuh"

namespace flash {
namespace mma {

using tf32x3::copy_bytes;
using tf32x3::exact;
using tf32x3::from_c;
using tf32x3::ld2;
using tf32x3::load_a;
using tf32x3::load_b_cols;
using tf32x3::load_b_pairs;
using tf32x3::mma3;
using tf32x3::parts;
using tf32x3::prow;
using tf32x3::round8;
using tf32x3::split;
using tf32x3::split_tile;
using tf32x3::stage;
using tf32x3::stage_scalars;
using tf32x3::stage_vec;
using tf32x3::stride_cols;
using tf32x3::stride_pairs;
using tf32x3::zero_cols;

// 32-bit words of a bitmask over n tiles
__host__ __device__ constexpr int mask_words(int n) { return (n + 31) / 32; }

// acc[i][n] += A_i B(n) for the n-tiles n < nt of N and each of M A
// fragments: B(n) is the "from C" fragment at p + 8n, read once
// for the M products (row 2t + 1 `next` elements after row 2t).  A whole group of 8 n-tiles (or N's last few) runs
// without a branch a tile, so one tile's loads can overlap another's
// products; only the group that nt cuts tests each tile.
template <int M, int N, typename T>
__device__ __forceinline__ void mma_cols(float (&acc)[M][N][4],
                                         const uint32_t (&ab)[M][4],
                                         const uint32_t (&as)[M][4],
                                         const T* p, int soff, int next,
                                         int nt) {
#pragma unroll
  for (int g8 = 0; g8 < N; g8 += 8) {
    const int end = g8 + 8 < N ? g8 + 8 : N;
    if (end <= nt) {
#pragma unroll
      for (int n = g8; n < end; ++n) {
        uint32_t bb[2], bs[2];
        load_b_cols(p + 8 * n, soff, next, bb, bs);
#pragma unroll
        for (int i = 0; i < M; ++i)
          mma3<false, exact<T>()>(acc[i][n], ab[i], as[i], bb, bs);
      }
    } else if (g8 < nt) {
#pragma unroll
      for (int n = g8; n < end; ++n) {
        if (n < nt) {
          uint32_t bb[2], bs[2];
          load_b_cols(p + 8 * n, soff, next, bb, bs);
#pragma unroll
          for (int i = 0; i < M; ++i)
            mma3<false, exact<T>()>(acc[i][n], ab[i], as[i], bb, bs);
        }
      }
    }
  }
}

// -- the tiles some row can see --------------------------------------------------

// Whether a key at kp may be seen by some row with positions in [qlo, qhi]
// (causal keeps kp <= qp, a window kp > qp - w: each bound met by some
// row; a superset of the exact answer, which the per-element mask settles)
__device__ __forceinline__ bool key_may_see(int kp, int qlo, int qhi,
                                            int causal, int window) {
  bool ok = kp < kValidPosLimit;
  if (causal) ok = ok && kp <= qhi;
  if (window > 0) ok = ok && kp > qlo - window;
  return ok;
}

// Whether a row at qp may see some key with positions in [klo, khi] (the
// valid keys'; none when klo > khi)
__device__ __forceinline__ bool row_may_see(int qp, int klo, int khi,
                                            int causal, int window) {
  bool ok = klo <= khi;
  if (causal) ok = ok && klo <= qp;
  if (window > 0) ok = ok && khi > qp - window;
  return ok;
}

// (min, max) over a warp of each lane's pair
__device__ __forceinline__ void warp_range(int& lo, int& hi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
}

// the first tile at or after `from` whose bit is set, or n
__device__ __forceinline__ int next_tile(const uint32_t* bits, int from,
                                         int n) {
  for (int w = from >> 5; w * 32 < n; ++w) {
    uint32_t m = bits[w];
    if (w == from >> 5) m &= ~0u << (from & 31);
    if (m != 0u) return min(w * 32 + __ffs(m) - 1, n);
  }
  return n;
}

}  // namespace mma
}  // namespace flash
