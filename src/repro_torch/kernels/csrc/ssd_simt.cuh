// The simt variant of the SSD scan: f32, and every shape the tensor-core
// variant tc does not take (see ssd_scan.cu).  The name is historical: the
// variant first ran on the fp32 CUDA cores.  It now takes its products on
// the tensor cores, mma.sync m16n8k8 on TF32 operands with fp32
// accumulators, each fp32 operand split in two TF32 parts and each product
// taken as three (tf32x3.cuh: ~22 of fp32's 24 bits); bf16 operands are
// exact in TF32.  Two kernels, after tc's (ssd_tc.cuh), every sum in fp32:
//
// state_kernel, one block of 4 warps per (64 columns of N, head, b): the
//   only serial part.  It walks the chunks in order with its [P, 64] slice
//   of the carried state in the warps' accumulators (a warp 16 rows of P).
//   Per chunk: dacum = cumsum(dt * a) by one thread, the serial fp32 sum
//   the plain version takes; w[j] = exp(dacum[L-1] - dacum[j]) dt[j]; the
//   slice entering the chunk goes to scratch (fp32 [B, nc, H, P, N]) and
//   the first slice's block writes dacum and dt ([B, nc, H, 2, L]); then
//   state = exp(dacum[L-1]) state + (w x)^T B over the chunk's rows.  x
//   and B arrive 32 rows a tile by cp.async in a ring of two stages (the
//   next chunk's dt with its first tile), so the next tile's copy overlaps
//   this tile's products; both are read down their columns (row strides 8
//   mod 32 words); x is split as each warp reads its columns, B, which
//   every warp reads, once when its tile lands.
// chunk_kernel, one block of 4 warps per (b, chunk, 64-row strip, 2 heads),
//   every chunk in parallel, the longest strips first; a warp owns 16 rows.
//   Per head y = exp(dacum_i) C . state^T from the entering state in
//   scratch; then per 32-column tile up to the diagonal C B^T once for the
//   two heads, and per head W = C B^T * exp(dacum_i - dacum_j) * dt_j,
//   masked to j <= i, formed on the accumulator fragment (one exp an
//   element of W, by the SFU on the fp32 difference) and taken as the A
//   operand of y += W x ("from C" order).  The entering states, then the
//   tiles (B and each head's x), arrive by cp.async in a ring of two
//   stages.  C is staged once and split by each warp as it reads its rows;
//   the shared tiles are split as they are read too (their small parts
//   would not leave room for two blocks an SM).
//
// P and N are zero-padded to multiples of 8 in shared memory and a ragged
// chunk tail to whole tiles (zero rows), which adds nothing.  No atomics:
// two calls give equal bits.  y is rounded once to x's type; the state
// stays fp32.
// Bound by operations at a model's f32 widths; the kernels reach about a
// fifth of mma.sync's TF32 rate there (tools/ssd_simt_profile.py), held
// back by the latency of few warps an SM, not by the split's operations.
// Instantiations: state_kernel and chunk_kernel, each in f32 and bf16.
// Shared memory (f32, L 256): state_kernel 2 x 32 rows x (72 + 72) floats
// for x and B, B's small parts, dt (two chunks), dacum and w: 50,176 B
// (three blocks an SM by its 160 registers); chunk_kernel the C strip (64
// x stride_pairs(N)), dacum and dt of two heads, two stages of max(B + two
// x tiles, one entering state): 75,776 B at (P 64, N 64) and 108,544 B at
// (P 64, N 128) (three and two blocks an SM).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_ptx.cuh"
#include "tf32x3.cuh"

namespace ssd {
namespace simt {

using tf32x3::exact;
using tf32x3::round8;
using tf32x3::stride_cols;
using tf32x3::stride_pairs;
using tf32x3::to_float;

constexpr int kThreads = 128;   // four warps
constexpr int kStrip = 64;      // rows of a chunk_kernel strip; columns of
                                // a state_kernel slice
constexpr int kJ = 32;          // rows of a staged tile
constexpr int kHeads = 2;       // heads of a chunk_kernel block
constexpr int kPMax = 64;       // head_dim the kernels take at most
constexpr int kNMax = 128;      // d_state the kernels take at most
constexpr int kMaxSmem = 232448;

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Row stride (elements) of a tile read down its columns (lanes on 8
// consecutive columns of 4 rows): 8 mod 32 words, so no two lanes meet on
// a bank
template <typename T>
__host__ __device__ constexpr int stride_down(int d) {
  return sizeof(T) == 4 ? round_up(d, 32) + 8 : round_up(d, 64) + 16;
}

// columns [from, to) of `rows` rows set to zero
template <typename T>
__device__ __forceinline__ void clear_cols(T* dst, int ds, int rows, int from,
                                           int to, int tid) {
  const int w = to - from;
  for (int i = tid; i < rows * w; i += kThreads) {
    const int r = i / w;
    dst[r * ds + from + (i - r * w)] = tf32x3::from_float<T>(0.f);
  }
}

// An fp32 [rows][ld] tile of kStrip columns that every warp reads split
// once (the big parts in place, the small ones at `small`), then a
// barrier; nothing for bf16
template <typename T>
__device__ __forceinline__ void split_shared(T* tile, float* small, int ld,
                                             int rows, int tid) {
  if constexpr (!exact<T>()) {
    tf32x3::split_tile(reinterpret_cast<float*>(tile), small, ld, rows,
                       kStrip, tid, kThreads);
    __syncthreads();
  }
}

// cum[l] = sum_{j <= l} dt[j] * a, one fp32 step at a time (the sum the
// plain version takes), by the calling thread
__device__ __forceinline__ void serial_cumsum(const float* __restrict__ dt,
                                              float* __restrict__ cum,
                                              float a, int L) {
  float run = 0.f;
#pragma unroll 8
  for (int l = 0; l < L; ++l) {
    run += dt[l] * a;
    cum[l] = run;
  }
}

// acc[n] += (w X)^T Y over kJ rows of staged tiles: the state product.
// Rows of the result are X's columns p0 + g (e 0, 1) and p0 + g + 8 (e 2,
// 3); columns Y's 8n + 2t (+ 1).  X [kJ][ldx] and Y [kJ][ldy] are read
// down their columns (A: k = t, t + 4 the rows j; B the same rows), w
// [kJ] weighs X's rows.  X is split as read (each warp its own columns);
// Y, which every warp reads, was split once (split_tile: fp32 big parts in
// place, the small ones `ysoff` elements on; bf16 is exact).
template <typename T, int NT>
__device__ __forceinline__ void wxty(float (&acc)[NT][4], const T* X, int ldx,
                                     const T* Y, int ldy, int ysoff,
                                     const float* w, int p0) {
  constexpr bool kExact = exact<T>();
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll 2
  for (int k0 = 0; k0 < kJ; k0 += 8) {
    const float w0 = w[k0 + t], w1 = w[k0 + t + 4];
    const T* xa = X + (k0 + t) * ldx + p0 + g;
    const T* xb = xa + 4 * ldx;
    const float av[4] = {to_float(xa[0]) * w0, to_float(xa[8]) * w0,
                         to_float(xb[0]) * w1, to_float(xb[8]) * w1};
    uint32_t ab[4], as[4];
    tf32x3::split<false>(av, ab, as);
    const T* yr = Y + (k0 + t) * ldy + g;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t bb[2], bs[2];
      const T* y0 = yr + 8 * n;
      tf32x3::parts(make_float2(to_float(y0[0]), to_float(y0[4 * ldy])),
                    kExact ? make_float2(0.f, 0.f)
                           : make_float2(to_float(y0[ysoff]),
                                         to_float(y0[ysoff + 4 * ldy])),
                    bb, bs);
      tf32x3::mma3<false, kExact>(acc[n], ab, as, bb, bs);
    }
  }
}

// -- state_kernel -------------------------------------------------------------

// the small parts of an fp32 [kJ][ld] tile that every warp reads (none
// for bf16)
template <typename T>
__host__ __device__ constexpr size_t small_bytes(int ld) {
  return exact<T>() ? 0 : sizeof(float) * (size_t)kJ * ld;
}

template <typename T>
__host__ __device__ constexpr size_t state_smem(int L) {
  return 2 * 2 * (size_t)kJ * stride_down<T>(kStrip) * sizeof(T) +
         small_bytes<T>(stride_down<T>(kStrip)) +
         4 * (size_t)round_up(L, kJ) * sizeof(float);
}

// states: fp32 [B, nc, H, P, N] (the slice entering each chunk); meta:
// fp32 [B, nc, H, 2, L] (dacum, then dt); hout: fp32 [B, H, P, N].
template <typename T>
__global__ void __launch_bounds__(kThreads)
state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ a, const T* __restrict__ bm,
             const float* __restrict__ h0, float* __restrict__ states,
             float* __restrict__ meta, float* __restrict__ hout, int S, int H,
             int P, int N, int L, int vec) {
  constexpr int ld = stride_down<T>(kStrip);
  const int Lr = round_up(L, kJ);
  extern __shared__ float4 smem4[];
  T* Xs = reinterpret_cast<T*>(smem4);                       // [2][kJ][ld]
  T* Bs = Xs + 2 * kJ * ld;                                  // [2][kJ][ld]
  float* Bsm = reinterpret_cast<float*>(Bs + 2 * kJ * ld);   // [kJ][ld] f32
  float* dts = Bsm + small_bytes<T>(ld) / sizeof(float);     // [2][Lr]
  float* cum = dts + 2 * Lr;                                 // [Lr]
  float* w = cum + Lr;                                       // [Lr]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * kStrip, h = blockIdx.y, b = blockIdx.z;
  const int nn = min(kStrip, N - n0);      // columns of this slice
  const int nc = S / L, tiles = (L + kJ - 1) / kJ, total = nc * tiles;
  const int p0 = 16 * warp;
  const bool active = p0 < P;
  const int64_t xrow = (int64_t)H * P;
  const T* x_b = x + (int64_t)b * S * xrow + (int64_t)h * P;
  const T* bm_b = bm + (int64_t)b * S * N + n0;
  const float* dt_b = dt + (int64_t)b * S * H + h;
  const float ah = a[h];

  clear_cols(Xs, ld, 2 * kJ, P, kStrip, tid);
  clear_cols(Bs, ld, 2 * kJ, nn, kStrip, tid);
  // tile q (chunk q / tiles, rows from (q % tiles) kJ) into stage q & 1,
  // with the chunk's dt at its first tile
  auto issue = [&](int q) {
    const int c = q / tiles, j0 = (q - c * tiles) * kJ;
    const int nv = min(kJ, L - j0);
    const int64_t row0 = (int64_t)c * L + j0;
    tf32x3::stage(Xs + (q & 1) * kJ * ld, ld, x_b + row0 * xrow, xrow, kJ, nv,
                  P, vec, tid, kThreads);
    tf32x3::stage(Bs + (q & 1) * kJ * ld, ld, bm_b + row0 * N, N, kJ, nv, nn,
                  vec, tid, kThreads);
    if (j0 == 0)
      tf32x3::stage_scalars(dts + (c & 1) * Lr, dt_b + row0 * H, H, Lr, L,
                            tid, kThreads);
  };

  // the state slice: rows p0 + g, + 8; columns 8n + 2t, + 1 of the slice
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + g + 8 * (e >> 1), col = 8 * n + 2 * t + (e & 1);
      acc[n][e] = h0 != nullptr && p < P && col < nn
                      ? h0[(((int64_t)b * H + h) * P + p) * N + n0 + col]
                      : 0.f;
    }

  issue(0);
  hopper::cp_async_commit();
  for (int q = 0; q < total; ++q) {
    const int c = q / tiles, jt = q - c * tiles;
    // tile q (and at a chunk's first, its dt) has landed for every thread;
    // the last tile's readers are done with the other stage
    hopper::cp_async_wait<0>();
    __syncthreads();
    if (jt == 0) {
      const float* dtc = dts + (c & 1) * Lr;
      if (tid == 0) serial_cumsum(dtc, cum, ah, L);
      __syncthreads();
      const float last = cum[L - 1];
      for (int i = tid; i < Lr; i += kThreads)
        w[i] = i < L ? expf(last - cum[i]) * dtc[i] : 0.f;
      const int64_t bch = ((int64_t)b * nc + c) * H + h;
      if (blockIdx.x == 0)
        for (int i = tid; i < L; i += kThreads) {
          meta[bch * 2 * L + i] = cum[i];
          meta[bch * 2 * L + L + i] = dtc[i];
        }
      // the slice entering chunk c, then its decay over the chunk
      const float decay = expf(last);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int p = p0 + g + 8 * hf, col = 8 * n + 2 * t;
          if (p < P && col < nn)
            *reinterpret_cast<float2*>(states + (bch * P + p) * N + n0 +
                                       col) =
                make_float2(acc[n][2 * hf], acc[n][2 * hf + 1]);
          acc[n][2 * hf] *= decay;
          acc[n][2 * hf + 1] *= decay;
        }
      __syncthreads();
    }
    T* Bq = Bs + (q & 1) * kJ * ld;
    split_shared(Bq, Bsm, ld, kJ, tid);   // B split once for the warps
    if (q + 1 < total) issue(q + 1);
    hopper::cp_async_commit();
    if (active)
      wxty<T, 8>(acc, Xs + (q & 1) * kJ * ld, ld, Bq, ld,
                 (int)(Bsm - reinterpret_cast<float*>(Bq)), w + jt * kJ, p0);
  }
  hopper::cp_async_wait<0>();
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int p = p0 + g + 8 * hf, col = 8 * n + 2 * t;
      if (p < P && col < nn)
        *reinterpret_cast<float2*>(
            hout + (((int64_t)b * H + h) * P + p) * N + n0 + col) =
            make_float2(acc[n][2 * hf], acc[n][2 * hf + 1]);
    }
}

// -- chunk_kernel -------------------------------------------------------------

// one ring stage: a B tile and each head's x tile, or one entering state
template <typename T>
__host__ __device__ constexpr size_t stage_bytes(int P, int N) {
  const size_t tiles = sizeof(T) * (size_t)kJ *
                       (stride_pairs(N) + kHeads * stride_cols<T>(P));
  const size_t state = sizeof(float) * (size_t)round8(P) * stride_pairs(N);
  return round_up((int)(tiles > state ? tiles : state), 16);
}

template <typename T>
__host__ __device__ constexpr size_t chunk_smem(int P, int N, int L) {
  return sizeof(T) * (size_t)kStrip * stride_pairs(N) +
         sizeof(float) * (size_t)kHeads * 2 * round_up(L, kJ) +
         2 * stage_bytes<T>(P, N);
}

// y [B, S, H, P] from the entering states and dacum / dt that state_kernel
// writes; vec_s the copy width of the states.
template <typename T>
__global__ void __launch_bounds__(kThreads)
chunk_kernel(const T* __restrict__ x, const T* __restrict__ bm,
             const T* __restrict__ cm, const float* __restrict__ states,
             const float* __restrict__ meta, T* __restrict__ y, int S, int H,
             int P, int N, int L, int vec, int vec_s) {
  constexpr bool kExact = exact<T>();
  const int lc = stride_pairs(N), lx = stride_cols<T>(P);
  const int nk = round8(N) / 8, np = round8(P) / 8;
  const int Lr = round_up(L, kJ);
  const int strips = (L + kStrip - 1) / kStrip;
  const int c = blockIdx.x / strips;
  const int i0 = (strips - 1 - (blockIdx.x - c * strips)) * kStrip;
  const int hb = blockIdx.y * kHeads, nh = min(kHeads, H - hb);
  const int b = blockIdx.z;
  const int nc = S / L;
  const int jend = min(L, i0 + kStrip);    // columns the strip's rows see
  const int ntj = (jend + kJ - 1) / kJ;
  const size_t sb = stage_bytes<T>(P, N);
  extern __shared__ float4 smem4[];
  T* Cs = reinterpret_cast<T*>(smem4);                             // [64][lc]
  float* mt = reinterpret_cast<float*>(Cs + kStrip * lc);  // [kHeads][2][Lr]
  char* ring = reinterpret_cast<char*>(mt + kHeads * 2 * Lr);      // [2][sb]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = 16 * warp;                 // the warp's rows of the strip
  const int ri = i0 + r0 + g;               // chunk rows ri and ri + 8
  const bool rows_in = i0 + r0 < L;
  const int64_t t0 = (int64_t)b * S + (int64_t)c * L;   // the chunk's row 0
  const int64_t xrow = (int64_t)H * P;
  const int64_t bch = ((int64_t)b * nc + c) * H + hb;

  // the C strip and each head's dacum and dt up to jend
  tf32x3::zero_cols(Cs, lc, kStrip, N, tid, kThreads);
  tf32x3::stage(Cs, lc, cm + (t0 + i0) * N, N, kStrip, min(kStrip, L - i0),
                N, vec, tid, kThreads);
  for (int hl = 0; hl < nh; ++hl) {
    tf32x3::stage_scalars(mt + hl * 2 * Lr, meta + (bch + hl) * 2 * L, 1,
                          jend, jend, tid, kThreads);
    tf32x3::stage_scalars(mt + hl * 2 * Lr + Lr,
                          meta + (bch + hl) * 2 * L + L, 1, jend, jend, tid,
                          kThreads);
  }
  // load q into stage q & 1: the entering state of head q for q < kHeads,
  // then the column tiles (B, each head's x)
  auto issue = [&](int q) {
    char* st = ring + (q & 1) * sb;
    if (q < kHeads) {
      if (q >= nh) return;
      float* Ss = reinterpret_cast<float*>(st);          // [round8(P)][lc]
      tf32x3::stage(Ss, lc, states + (bch + q) * P * N, N, round8(P), P, N,
                    vec_s, tid, kThreads);
      tf32x3::zero_cols(Ss, lc, round8(P), N, tid, kThreads);
      return;
    }
    const int j0 = (q - kHeads) * kJ, nv = min(kJ, L - j0);
    T* Bt = reinterpret_cast<T*>(st);                    // [kJ][lc]
    tf32x3::stage(Bt, lc, bm + (t0 + j0) * N, N, kJ, nv, N, vec, tid,
                  kThreads);
    tf32x3::zero_cols(Bt, lc, kJ, N, tid, kThreads);
    for (int hl = 0; hl < nh; ++hl)                      // [kJ][lx] each
      tf32x3::stage(Bt + kJ * lc + hl * kJ * lx, lx,
                    x + (t0 + j0) * xrow + (int64_t)(hb + hl) * P, xrow, kJ,
                    nv, P, vec, tid, kThreads);
  };

  float yacc[kHeads][8][4];
#pragma unroll
  for (int hl = 0; hl < kHeads; ++hl)
#pragma unroll
    for (int m = 0; m < 8; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[hl][m][e] = 0.f;
  const T* ca = Cs + (r0 + g) * lc + 2 * t;   // the warp's C rows (pairs)

  issue(0);
  hopper::cp_async_commit();
  const int total = kHeads + ntj;
  for (int q = 0; q < total; ++q) {
    hopper::cp_async_wait<0>();
    __syncthreads();
    if (q + 1 < total) issue(q + 1);
    hopper::cp_async_commit();
    const char* st = ring + (q & 1) * sb;
    if (q < kHeads) {
      // y = exp(dacum_i) C . state^T for head q (the accumulators indexed
      // by a constant: a head chosen at run time would put them in memory)
      if (q >= nh || !rows_in) continue;
      const float* sp = reinterpret_cast<const float*>(st) + g * lc + 2 * t;
      const float* cum = mt + q * 2 * Lr;
#pragma unroll
      for (int hl = 0; hl < kHeads; ++hl) {
        if (hl != q) continue;
#pragma unroll 2
        for (int kk = 0; kk < nk; ++kk) {
          uint32_t ab[4], as[4];
          tf32x3::load_a(ca, lc, kk, ab, as);
#pragma unroll
          for (int m = 0; m < 8; ++m) {
            if (m < np) {
              uint32_t bb[2], bs[2];
              tf32x3::load_b_pairs_x(sp + 8 * m * lc, kk, bb, bs);
              tf32x3::mma3<kExact, false>(yacc[hl][m], ab, as, bb, bs);
            }
          }
        }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int i = ri + 8 * hf;
          const float e = i < L ? expf(cum[i]) : 0.f;
#pragma unroll
          for (int m = 0; m < 8; ++m) {
            yacc[hl][m][2 * hf] *= e;
            yacc[hl][m][2 * hf + 1] *= e;
          }
        }
      }
      continue;
    }
    // column tile j0: C B^T once for the heads, then per head y += W x
    const int j0 = (q - kHeads) * kJ;
    if (!rows_in || j0 > i0 + r0 + 15) continue;   // all above the diagonal
    const T* Bt = reinterpret_cast<const T*>(st);
    float cb[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) cb[n][e] = 0.f;
    const T* bp = Bt + g * lc + 2 * t;
#pragma unroll 2
    for (int kk = 0; kk < nk; ++kk) {
      uint32_t ab[4], as[4];
      tf32x3::load_a(ca, lc, kk, ab, as);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        uint32_t bb[2], bs[2];
        tf32x3::load_b_pairs_x(bp + 8 * n * lc, kk, bb, bs);
        tf32x3::mma3<kExact, kExact>(cb[n], ab, as, bb, bs);
      }
    }
#pragma unroll
    for (int hl = 0; hl < kHeads; ++hl) {
      if (hl >= nh) continue;
      const float* cum = mt + hl * 2 * Lr;
      const float* dtv = cum + Lr;
      const float ci[2] = {cum[min(ri, jend - 1)], cum[min(ri + 8, jend - 1)]};
      const T* xb = Bt + kJ * lc + hl * kJ * lx + 2 * t * lx + g;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        float wv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = ri + 8 * (e >> 1), j = j0 + 8 * n + 2 * t + (e & 1);
          wv[e] = j <= i && j < L
                      ? cb[n][e] * __expf(ci[e >> 1] - cum[j]) * dtv[j]
                      : 0.f;
        }
        uint32_t ab[4], as[4];
        tf32x3::from_c(wv, ab, as);
        const T* xn = xb + 8 * n * lx;
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          if (m < np) {
            uint32_t bb[2], bs[2];
            tf32x3::load_b_cols_x(xn + 8 * m, lx, bb, bs);
            tf32x3::mma3<false, kExact>(yacc[hl][m], ab, as, bb, bs);
          }
        }
      }
    }
  }
  hopper::cp_async_wait<0>();

#pragma unroll
  for (int hl = 0; hl < kHeads; ++hl) {
    if (hl >= nh) continue;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i = ri + 8 * hf;
      if (i >= L) continue;
      T* yr = y + ((t0 + i) * H + hb + hl) * P;
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int p = 8 * m + 2 * t;
        if (p < P) yr[p] = tf32x3::from_float<T>(yacc[hl][m][2 * hf]);
        if (p + 1 < P)
          yr[p + 1] = tf32x3::from_float<T>(yacc[hl][m][2 * hf + 1]);
      }
    }
  }
}

// -- host side --------------------------------------------------------------

// scratch: the entering states (fp32 [B, nc, H, P, N]) and each chunk's
// dacum and dt (fp32 [B, nc, H, 2, L])
inline void scratch_floats(int B, int S, int H, int P, int N, int L,
                           long long* states, long long* meta) {
  const long long bch = (long long)B * (S / L) * H;
  *states = bch * P * N;
  *meta = bch * 2 * L;
}

// the largest dynamic shared memory, opted into once per kernel
template <typename K>
int opt_in(K kernel, size_t smem, bool& configured) {
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (configured) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  configured = err == cudaSuccess;
  return (int)err;
}

// state_kernel alone (the backward's phase (i) too): entering states, dacum
// / dt and the final state.  h0 null: zeros.
template <typename T>
int launch_state(const void* x, const void* dt, const void* a, const void* bm,
                 const void* h0, float* states, float* meta, float* hout,
                 int B, int S, int H, int P, int N, int L,
                 cudaStream_t stream) {
  const size_t smem = state_smem<T>(L);
  static bool configured = false;
  int err = opt_in(state_kernel<T>, smem, configured);
  if (err) return err;
  const int vec = tf32x3::copy_bytes(sizeof(T), {x, bm}, {P, N});
  const dim3 grid((N + kStrip - 1) / kStrip, H, B);
  state_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(bm),
      static_cast<const float*>(h0), states, meta, hout, S, H, P, N, L, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* dt, const void* a, const void* bm,
           const void* cm, const void* h0, void* y, void* hout, float* states,
           float* meta, int B, int S, int H, int P, int N, int L,
           cudaStream_t stream) {
  const size_t smem = chunk_smem<T>(P, N, L);
  static bool configured = false;
  int err = opt_in(chunk_kernel<T>, smem, configured);
  if (err) return err;
  const long long strips = (long long)(S / L) * ((L + kStrip - 1) / kStrip);
  if (strips > 0x7fffffffLL || (H + kHeads - 1) / kHeads > 65535 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  err = launch_state<T>(x, dt, a, bm, h0, states, meta,
                        static_cast<float*>(hout), B, S, H, P, N, L, stream);
  if (err) return err;
  const int vec = tf32x3::copy_bytes(sizeof(T), {x, bm, cm}, {P, N});
  const int vec_s = tf32x3::copy_bytes(sizeof(float), {states}, {N});
  const dim3 grid((unsigned)strips, (H + kHeads - 1) / kHeads, B);
  chunk_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(bm),
      static_cast<const T*>(cm), states, meta, static_cast<T*>(y), S, H, P, N,
      L, vec, vec_s);
  return (int)cudaGetLastError();
}

}  // namespace simt
}  // namespace ssd
