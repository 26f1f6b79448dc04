// Split-TF32 products on mma.sync, shared by the f32-capable kernels
// (flash_simt.cuh, flash_backward.cuh through flash_mma.cuh; ssd_simt.cuh,
// ssd_backward.cuh): fragments of mma.sync m16n8k8 read from shared
// memory, the split of an fp32 operand into two TF32 parts, the three
// products that stand in for one fp32 product, tiles staged by cp.async.
//
// The split (CUTLASS's OpMultiplyAddFastF32, "3xTF32"): big = tf32(x) and
// small = tf32(x - big), both rounded to nearest with ties away from zero
// (cvt.rna), so big + small keeps ~22 of fp32's 24 bits.  A product a b is
// taken as a_big b_small + a_small b_big + a_big b_big in fp32, the two
// small terms first; a_small b_small (~2^-22 of it) is dropped.  A bf16
// value is exact in TF32 (small = 0): its small products are skipped.
// An operand that many warps read may be split once when its tile lands
// (split_tile, and the B loaders that read both parts); one a warp reads
// alone, or a tile whose small parts would not fit, is split as it is
// read (load_a, from_c and the *_x B loaders).
//
// Fragment k order.  The hardware pairs A's column k with B's row k; any
// permutation of k that both operands follow gives the same sum.  Two
// permutations are used: "pairs", where a lane's k = t and t + 4 are the
// adjacent columns 8c + 2t and 8c + 2t + 1 of a row (one 8-byte load for
// each of the lane's rows), and "from C", where A is an accumulator tile
// of an earlier product (lane (g, t) holds columns 2t and 2t + 1 of rows g
// and g + 8), used as A with k = t and t + 4 standing for those columns, so
// B's rows k are the source rows 2t and 2t + 1.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "hopper_ptx.cuh"

namespace tf32x3 {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
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

// a multiple of 8 at least d: the k extent of a product over d columns
__host__ __device__ constexpr int round8(int d) { return (d + 7) / 8 * 8; }

// Row stride (elements) of a tile read as "pairs" fragments: 8 mod 16, so
// the 8 rows of a fragment fall on distinct banks
__host__ __device__ constexpr int stride_pairs(int d) {
  return round8(d) % 16 == 0 ? round8(d) + 8 : round8(d);
}

// Row stride of a tile read one column of rows 2t and 2t + 1 at a time (B
// in the "from C" order): fp32 4 mod 8 (rows 0, 2, 4, 6 on distinct banks),
// bf16 as "pairs"
template <typename T>
__host__ __device__ constexpr int stride_cols(int d) {
  return sizeof(T) == 4 ? round8(d) + 4 : stride_pairs(d);
}

// The row where a tile read both ways (as "pairs" and as "from C" B
// fragments: the backward's Q, dO and K) keeps its row r: within each 8
// rows the order 0 2 1 3 6 4 7 5, which puts the 4 rows of either read
// (rows g of a half warp; rows 2t, or 2t + 1) on 4 distinct rows mod 4,
// so at a stride of 8 mod 16 words neither read meets a bank conflict
__host__ __device__ constexpr int prow(int r) {
  return (r & ~7) | (int)((0x57463120u >> (4 * (r & 7))) & 7u);
}

// -- operands ---------------------------------------------------------------------

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// x as TF32 parts; EXACT (a bf16 source) keeps x whole in `big`
template <bool EXACT, int N>
__device__ __forceinline__ void split(const float (&x)[N], uint32_t (&big)[N],
                                      uint32_t (&small)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (EXACT) {
      big[i] = __float_as_uint(x[i]);
      small[i] = 0u;
    } else {
      big[i] = hopper::tf32_rna(x[i]);
      small[i] = hopper::tf32_rna(x[i] - __uint_as_float(big[i]));
    }
  }
}

// d += a b as the split products, small terms first
template <bool EXACT_A, bool EXACT_B>
__device__ __forceinline__ void mma3(float* d, const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4],
                                     const uint32_t (&bb)[2],
                                     const uint32_t (&bs)[2]) {
  if constexpr (!EXACT_B) hopper::mma_tf32(d, ab, bs);
  if constexpr (!EXACT_A) hopper::mma_tf32(d, as, bb);
  hopper::mma_tf32(d, ab, bb);
}

// A bf16 operand is exact in TF32
template <typename T>
__host__ __device__ constexpr bool exact() { return sizeof(T) == 2; }

// The A fragment, "pairs" order, of rows r and r + 8 of a tile whose row r
// starts at `p` (already offset by 2t), columns 8c + 2t, 8c + 2t + 1, split
// as it is read
template <typename T>
__device__ __forceinline__ void load_a(const T* p, int stride, int c,
                                       uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
  const float2 x0 = ld2(p + 8 * c), x1 = ld2(p + 8 * stride + 8 * c);
  const float x[4] = {x0.x, x1.x, x0.y, x1.y};
  split<exact<T>()>(x, big, small);
}

// The A fragment, "from C" order, of an fp32 accumulator tile
__device__ __forceinline__ void from_c(const float (&c)[4], uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
  const float x[4] = {c[0], c[2], c[1], c[3]};
  split<false>(x, big, small);
}

// B fragments read from a tile shared by the block's warps: an fp32 tile
// split once (split_tile: the big parts in place, the small ones `soff`
// elements on), a bf16 tile as it is (exact)
__device__ __forceinline__ void parts(float2 b, float2 s, uint32_t (&big)[2],
                                      uint32_t (&small)[2]) {
  big[0] = __float_as_uint(b.x);
  big[1] = __float_as_uint(b.y);
  small[0] = __float_as_uint(s.x);
  small[1] = __float_as_uint(s.y);
}

// "pairs" order: row n = g of an 8-row group starting at `p` (already
// offset by g rows and 2t columns), columns 8c + 2t, + 1
template <typename T>
__device__ __forceinline__ void load_b_pairs(const T* p, int soff, int c,
                                             uint32_t (&big)[2],
                                             uint32_t (&small)[2]) {
  if constexpr (exact<T>()) {
    const float2 y = ld2(p + 8 * c);
    parts(y, make_float2(0.f, 0.f), big, small);
  } else {
    parts(ld2(p + 8 * c), ld2(p + soff + 8 * c), big, small);
  }
}

// "from C" order: column g of source rows 2t and 2t + 1 (`p` already
// offset to row 2t, column g of the tile's 8 columns; row 2t + 1 `next`
// elements on)
template <typename T>
__device__ __forceinline__ void load_b_cols(const T* p, int soff, int next,
                                            uint32_t (&big)[2],
                                            uint32_t (&small)[2]) {
  if constexpr (exact<T>()) {
    parts(make_float2(to_float(p[0]), to_float(p[next])),
          make_float2(0.f, 0.f), big, small);
  } else {
    parts(make_float2(to_float(p[0]), to_float(p[next])),
          make_float2(to_float(p[soff]), to_float(p[soff + next])), big,
          small);
  }
}

// B fragments split as they are read (fp32; bf16 exact).  "pairs" order:
// row n = g at `p` (already offset by g rows and 2t columns), columns 8c +
// 2t, + 1
template <typename T>
__device__ __forceinline__ void load_b_pairs_x(const T* p, int c,
                                               uint32_t (&big)[2],
                                               uint32_t (&small)[2]) {
  const float2 y = ld2(p + 8 * c);
  const float x[2] = {y.x, y.y};
  split<exact<T>()>(x, big, small);
}

// "from C" order: column g of source rows 2t and 2t + 1 (`p` at row 2t,
// row 2t + 1 `next` elements on)
template <typename T>
__device__ __forceinline__ void load_b_cols_x(const T* p, int next,
                                              uint32_t (&big)[2],
                                              uint32_t (&small)[2]) {
  const float x[2] = {to_float(p[0]), to_float(p[next])};
  split<exact<T>()>(x, big, small);
}

// An fp32 tile [rows][stride] split in place over its first d8 columns
// (a multiple of 8): the big parts stay, the small ones go to the same
// places of `small`.  Four float4s a thread a round, loaded before any is
// split.
__device__ __forceinline__ void split_tile(float* tile, float* small,
                                           int stride, int rows, int d8,
                                           int tid, int nthreads) {
  const int per_row = d8 / 4;
  const int total = rows * per_row;
  const int step_r = nthreads / per_row, step_c = nthreads - step_r * per_row;
  int r = tid / per_row, c = tid - r * per_row;
  for (int i = tid; i < total; i += 4 * nthreads) {
    int off[4];
    float4 x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      off[u] = r * stride + 4 * c;
      if (i + u * nthreads < total)
        x[u] = *reinterpret_cast<const float4*>(tile + off[u]);
      r += step_r;
      c += step_c;
      if (c >= per_row) {
        c -= per_row;
        ++r;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (i + u * nthreads >= total) continue;
      const float xs[4] = {x[u].x, x[u].y, x[u].z, x[u].w};
      uint32_t bg[4], sm[4];
      split<false>(xs, bg, sm);
      *reinterpret_cast<float4*>(tile + off[u]) =
          make_float4(__uint_as_float(bg[0]), __uint_as_float(bg[1]),
                      __uint_as_float(bg[2]), __uint_as_float(bg[3]));
      *reinterpret_cast<float4*>(small + off[u]) =
          make_float4(__uint_as_float(sm[0]), __uint_as_float(sm[1]),
                      __uint_as_float(sm[2]), __uint_as_float(sm[3]));
    }
  }
}

// -- staging ------------------------------------------------------------------------

template <typename T, int VEC>
__device__ __forceinline__ void stage_vec(T* dst, int ds, const T* src,
                                          int64_t gs, int rows, int valid,
                                          int d, bool perm, int tid,
                                          int nthreads) {
  constexpr int E = VEC / (int)sizeof(T);
  const int per_row = d / E;
  const int total = rows * per_row;
  if (total == 0) return;
  const int step_r = nthreads / per_row, step_c = nthreads - step_r * per_row;
  int r = tid / per_row, c = tid - r * per_row;
  for (int i = tid; i < total; i += nthreads) {
    const bool in = r < valid;
    hopper::cp_async<VEC>(hopper::smem_u32(dst + (perm ? prow(r) : r) * ds
                                           + c * E),
                          src + (int64_t)(in ? r : 0) * gs + c * E, in);
    r += step_r;
    c += step_c;
    if (c >= per_row) {
      c -= per_row;
      ++r;
    }
  }
}

// dst[r][c] (row stride ds) = src[r * gs + c] for r < valid, c < d; zeros
// in rows valid..rows-1; with `perm` row r goes to row prow(r).  By
// cp.async in chunks of `vec` bytes (16, 8 or 4, which divide d's bytes
// and align every address) in this thread's open group, or by plain loads
// and stores where vec is 0.  Columns from d on are not written
// (zero_cols clears them once).
template <typename T>
__device__ __forceinline__ void stage(T* dst, int ds, const T* src, int64_t gs,
                                      int rows, int valid, int d, int vec,
                                      int tid, int nthreads,
                                      bool perm = false) {
  if (vec == 16) {
    stage_vec<T, 16>(dst, ds, src, gs, rows, valid, d, perm, tid, nthreads);
  } else if (vec == 8) {
    stage_vec<T, 8>(dst, ds, src, gs, rows, valid, d, perm, tid, nthreads);
  } else if (vec == 4) {
    stage_vec<T, 4>(dst, ds, src, gs, rows, valid, d, perm, tid, nthreads);
  } else {
    for (int i = tid; i < rows * d; i += nthreads) {
      const int r = i / d, c = i - r * d;
      dst[(perm ? prow(r) : r) * ds + c] =
          r < valid ? src[(int64_t)r * gs + c] : from_float<T>(0.f);
    }
  }
}

// one int32 a row (positions) or fp32 (lse, D) by 4-byte cp.async: rows
// from `valid` on read 0
template <typename U>
__device__ __forceinline__ void stage_scalars(U* dst, const U* src,
                                              int64_t gs, int rows, int valid,
                                              int tid, int nthreads) {
  for (int i = tid; i < rows; i += nthreads)
    hopper::cp_async<4>(hopper::smem_u32(dst + i),
                        src + (int64_t)(i < valid ? i : 0) * gs, i < valid);
}

// columns d..round8(d)-1 of `rows` rows set to zero: a product's k extent
// past d reads them
template <typename T>
__device__ __forceinline__ void zero_cols(T* dst, int ds, int rows, int d,
                                          int tid, int nthreads) {
  const int w = round8(d) - d;
  for (int i = tid; i < rows * w; i += nthreads) {
    const int r = i / w;
    dst[r * ds + d + (i - r * w)] = from_float<T>(0.f);
  }
}

// the largest of 16, 8, 4 that divides each row's bytes and aligns each
// base, 0 for none: the kernels' copy width
inline int copy_bytes(size_t elem, std::initializer_list<const void*> ptrs,
                      std::initializer_list<int> dims) {
  for (int w = 16; w >= 4; w /= 2) {
    bool ok = true;
    for (const void* p : ptrs) ok = ok && reinterpret_cast<uintptr_t>(p) % w == 0;
    for (int d : dims) ok = ok && (d * elem) % w == 0;
    if (ok) return w;
  }
  return 0;
}

}  // namespace tf32x3
