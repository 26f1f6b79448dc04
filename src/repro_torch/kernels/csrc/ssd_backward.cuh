// The SSD scan's backward (n_groups == 1), variant simt: the gradients of
// the chunked scan ssd_scan.cu computes, for every shape either forward
// variant takes.  The name is historical (the kernels first ran on the fp32
// CUDA cores): every product now runs on split-TF32 mma.sync, as the
// forward simt (tf32x3.cuh: each fp32 operand as two TF32 parts, three
// products for one, fp32 accumulators in registers; bf16 operands exact).
// For one head and a chunk of length L, dacum = cumsum(dt * a), M[l, m] =
// exp(dacum[l] - dacum[m]) for m <= l (0 above), r[m] = exp(dacum[L-1] -
// dacum[m]) and h_in the state entering the chunk:
//   y[l]  = sum_m (C[l] . B[m]) M[l, m] dt[m] x[m] + exp(dacum[l]) C[l] h_in
//   h_out = exp(dacum[L-1]) h_in + sum_m r[m] dt[m] x[m] (x) B[m]
// Given dy and the final state's gradient dfinal, in three phases:
//
// (i) the fp32 state entering each chunk, [B, nc, H, P, N], into scratch:
//   own_kernel (mode 0) forms each chunk's own state, sum_m r[m] dt[m] x[m]
//   (x) B[m], per (64 columns of N, head, chunk, b), every chunk in
//   parallel (the forward state_kernel's product, ssd_simt.cuh, over
//   32-row tiles in a cp.async ring), with dacum a serial fp32 sum it
//   writes beside dt ([B, nc, H, 2, L]); scan_kernel carries h0 through
//   them.
// (ii) the reverse pass: dh entering chunk c is exp(dacum_c[L-1]) dh(c + 1)
//   + sum_l exp(dacum[l]) dy[l] (x) C[l], from dfinal: own_kernel (mode 1)
//   forms each chunk's own term, scan_kernel carries dfinal backwards
//   through them, leaving in scratch the gradient of the state leaving
//   each chunk, and writes dh0.
// (iii) chunk_kernel, one block of 4 warps per (chunk, group of heads, b):
//   two heads in bf16 at N <= 64, one otherwise.  Pass A walks the 64-row
//   tiles l (a warp 16 rows) against 32-column tiles m <= l: C B^T once
//   for the group,
//   per head dW = dY X^T, dCB = dW * M * dt on the fragment, its rows' sums
//   against CB for d(dacum), dC += dCB B ("from C" A operand, shared by the
//   group's heads); then per head the carried state's terms (C h_in^T
//   dotted with dY for d(dacum), dC += exp(dacum) dY h_in).  Pass B walks
//   the 64-row tiles m against 32-row tiles l >= m in the transposed
//   orientation: B C^T once, per head X dY^T, dx += (CB^T * M^T) dY and dB
//   += (dW^T * M^T * dt) C, the columns' sums of dW * CB * M; then the
//   leaving state's terms (B G^T, X G, G its gradient).  The 64-row tile's
//   own operands are staged once (a warp reads only its rows, split as
//   read); the 32-row tiles and the states, which every warp reads, arrive
//   by cp.async in a ring of two stages, rows in prow order (read both as
//   "pairs" and down their columns without a bank conflict), and are split
//   once when they land.  d(da) is d(dacum) summed from the end; ddt += a
//   d(da) and the chunk's part of da is sum dt d(da).
// Then reduce_kernel sums the groups' dB and dC partials, and da_kernel da
// over (b, chunk), each in a fixed order: no atomics, so two calls give
// equal bits.  Each gradient is rounded once to its input's type.
// Instantiations: own_kernel <mode 0, 1> in f32 and bf16; chunk_kernel <N
// n-tiles, heads> <8, 1> and <16, 1> in f32, <8, 2> and <16, 1> in bf16.
// Shared memory (P 64, L 256): chunk_kernel in f32 97,792 B at N 64 (two
// blocks an SM) and 163,328 B at N 128 (one), in bf16 94,208 B at N 64
// (two heads); own_kernel 49,152 B in f32.
#pragma once

#include <math.h>

#include "ssd_simt.cuh"
#include "tf32x3.cuh"

namespace ssd {
namespace backward {

using simt::kJ;
using simt::kStrip;
using simt::round_up;
using simt::stride_down;
using tf32x3::exact;
using tf32x3::prow;
using tf32x3::round8;
using tf32x3::stride_pairs;
using tf32x3::to_float;

constexpr int kThreads = 256;        // scan, reduce and da kernels
constexpr int kBlock = simt::kThreads;   // own and chunk kernels: 4 warps
constexpr int kPMax = 64;
constexpr int kNMax = 128;

// heads of a chunk_kernel block: two in bf16 where dB's and dC's shared
// accumulators are 8 n-tiles (N <= 64), else one: an f32 pair's staging
// leaves one block an SM, and one head's two (more warps to hide the
// products' latency are worth more than C B^T formed once for two heads)
__host__ __device__ constexpr int heads(int N, size_t elem) {
  return elem == 2 && N <= 64 ? 2 : 1;
}

// -- (i), (ii) own_kernel ---------------------------------------------------

template <typename T>
__host__ __device__ constexpr size_t own_smem_bytes(int L) {
  return 2 * 2 * (size_t)kJ * stride_down<T>(kStrip) * sizeof(T) +
         simt::small_bytes<T>(stride_down<T>(kStrip)) +
         3 * sizeof(float) * (size_t)round_up(L, kJ);
}

// Each chunk's own term, out [B, nc, H, P, N]: MODE 0 sum_m r[m] dt[m]
// x[m] (x) B[m], with dacum a serial fp32 sum of dt * a by one thread
// (written to meta [B, nc, H, 2, L] with dt); MODE 1 sum_l exp(dacum[l])
// dy[l] (x) C[l], dacum from meta.  declog [B, nc, H] = dacum[L-1].  xs /
// ys: x and B (MODE 0) or dy and C (MODE 1).
template <typename T, int MODE>
__global__ void __launch_bounds__(kBlock)
own_kernel(const T* __restrict__ xs, const T* __restrict__ ys,
           const float* __restrict__ dt, const float* __restrict__ a,
           float* __restrict__ meta, float* __restrict__ out,
           float* __restrict__ declog, int S, int H, int P, int N, int L,
           int vec) {
  constexpr int ld = stride_down<T>(kStrip);
  const int Lr = round_up(L, kJ);
  extern __shared__ float4 smem4[];
  T* Xs = reinterpret_cast<T*>(smem4);                       // [2][kJ][ld]
  T* Ys = Xs + 2 * kJ * ld;                                  // [2][kJ][ld]
  float* Ysm = reinterpret_cast<float*>(Ys + 2 * kJ * ld);   // [kJ][ld] f32
  float* w = Ysm + simt::small_bytes<T>(ld) / sizeof(float); // [Lr]
  float* dts = w + Lr;                                       // [Lr]
  float* cum = dts + Lr;                                     // [Lr]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int slices = (N + kStrip - 1) / kStrip;
  const int slice = blockIdx.x % slices, h = blockIdx.x / slices;
  const int n0 = slice * kStrip, c = blockIdx.y, b = blockIdx.z;
  const int nn = min(kStrip, N - n0);
  const int nc = gridDim.y, tiles = (L + kJ - 1) / kJ;
  const int p0 = 16 * warp;
  const int64_t bch = ((int64_t)b * nc + c) * H + h;
  const int64_t t0 = (int64_t)b * S + (int64_t)c * L;
  const int64_t xrow = (int64_t)H * P;
  float* mt = meta + bch * 2 * L;

  simt::clear_cols(Xs, ld, 2 * kJ, P, kStrip, tid);
  simt::clear_cols(Ys, ld, 2 * kJ, nn, kStrip, tid);
  if constexpr (MODE == 0) {
    for (int i = tid; i < L; i += kBlock) dts[i] = dt[(t0 + i) * H + h];
    __syncthreads();
    if (tid == 0) simt::serial_cumsum(dts, cum, a[h], L);
    __syncthreads();
    const float last = cum[L - 1];
    for (int i = tid; i < Lr; i += kBlock)
      w[i] = i < L ? expf(last - cum[i]) * dts[i] : 0.f;
    if (slice == 0)
      for (int i = tid; i < L; i += kBlock) {
        mt[i] = cum[i];
        mt[L + i] = dts[i];
      }
    if (slice == 0 && tid == 0) declog[bch] = last;
  } else {
    for (int i = tid; i < Lr; i += kBlock) w[i] = i < L ? expf(mt[i]) : 0.f;
    if (slice == 0 && tid == 0) declog[bch] = mt[L - 1];
  }
  auto issue = [&](int q) {
    const int j0 = q * kJ, nv = min(kJ, L - j0);
    tf32x3::stage(Xs + (q & 1) * kJ * ld, ld, xs + (t0 + j0) * xrow +
                  (int64_t)h * P, xrow, kJ, nv, P, vec, tid, kBlock);
    tf32x3::stage(Ys + (q & 1) * kJ * ld, ld, ys + (t0 + j0) * N + n0, N, kJ,
                  nv, nn, vec, tid, kBlock);
  };
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  issue(0);
  hopper::cp_async_commit();
  for (int q = 0; q < tiles; ++q) {
    hopper::cp_async_wait<0>();
    __syncthreads();
    T* Yq = Ys + (q & 1) * kJ * ld;
    simt::split_shared(Yq, Ysm, ld, kJ, tid);
    if (q + 1 < tiles) issue(q + 1);
    hopper::cp_async_commit();
    if (p0 < P)
      simt::wxty<T, 8>(acc, Xs + (q & 1) * kJ * ld, ld, Yq, ld,
                       (int)(Ysm - reinterpret_cast<float*>(Yq)), w + q * kJ,
                       p0);
  }
  hopper::cp_async_wait<0>();
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int p = p0 + g + 8 * hf, col = 8 * n + 2 * t;
      if (p < P && col < nn)
        *reinterpret_cast<float2*>(out + (bch * P + p) * N + n0 + col) =
            make_float2(acc[n][2 * hf], acc[n][2 * hf + 1]);
    }
}

// buf [B, nc, H, P*N] holds each chunk's own term.  Forward: it becomes the
// state entering each chunk, carried from init (h0; null: zeros).
// Reverse: it becomes the gradient of the state leaving each chunk, carried
// from init (dfinal; null: zeros) backwards, and the carry's end is dh0.
__global__ void __launch_bounds__(kThreads)
scan_kernel(float* __restrict__ buf, const float* __restrict__ declog,
            const float* __restrict__ init, float* __restrict__ end, int B,
            int nchunks, int H, int PN, int reverse) {
  const int64_t id = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (id >= (int64_t)B * H * PN) return;
  const int e = (int)(id % PN);
  const int h = (int)((id / PN) % H);
  const int b = (int)(id / ((int64_t)PN * H));
  float carry = init != nullptr ? init[id] : 0.f;
  for (int i = 0; i < nchunks; ++i) {
    const int c = reverse ? nchunks - 1 - i : i;
    const int64_t bch = ((int64_t)b * nchunks + c) * H + h;
    const float own = buf[bch * PN + e];
    buf[bch * PN + e] = carry;
    carry = carry * expf(declog[bch]) + own;
  }
  if (end != nullptr) end[id] = carry;
}

// -- (iii) chunk_kernel -----------------------------------------------------

// One step of chunk_kernel's walk: the pass (0 A, 1 B), its 64-row tile,
// and what the ring brings: a 32-row tile (kind 0, its index in 32-row
// tiles) or a head's state (kind 1: h_in in pass A, G in pass B)
struct Step {
  int pass, tile, kind, idx;
};

// the k-th step: pass A's tiles I each take the 32-column tiles up to
// their last row, then the heads' entering states; pass B's tiles J the
// 32-row tiles from their first row to the end, then the heads' G
__device__ __forceinline__ Step step_at(int k, int L, int hg) {
  const int n64 = (L + 63) / 64, n32 = (L + 31) / 32;
  for (int i = 0; i < n64; ++i) {
    const int nj = (min(L, 64 * i + 64) + 31) / 32;
    if (k < nj) return {0, i, 0, k};
    k -= nj;
    if (k < hg) return {0, i, 1, k};
    k -= hg;
  }
  for (int j = 0; j < n64; ++j) {
    const int ni = n32 - 2 * j;
    if (k < ni) return {1, j, 0, 2 * j + k};
    k -= ni;
    if (k < hg) return {1, j, 1, k};
    k -= hg;
  }
  return {-1, 0, 0, 0};
}

__host__ __device__ constexpr int steps(int L, int hg) {
  const int n64 = (L + 63) / 64, n32 = (L + 31) / 32;
  int k = 0;
  for (int i = 0; i < n64; ++i) {
    const int rows = 64 * i + 64 < L ? 64 * i + 64 : L;
    k += (rows + 31) / 32 + hg + (n32 - 2 * i) + hg;
  }
  return k;
}

// a ring stage: a 32-row tile of B or C and each head's x or dy, or one
// head's [P][N] state
template <typename T>
__host__ __device__ constexpr size_t chunk_stage(int P, int N, int hg) {
  const size_t tile = sizeof(T) * (size_t)kJ *
                      (stride_pairs(N) + hg * stride_pairs(P));
  const size_t state = sizeof(float) * (size_t)round8(P) * stride_pairs(N);
  return round_up((int)(tile > state ? tile : state), 16);
}

// the small parts of the stage in use: its fp32 tiles' (none in bf16, which
// is exact) or a state's
template <typename T>
__host__ __device__ constexpr size_t chunk_small(int P, int N, int hg) {
  const size_t tile = exact<T>() ? 0
                                 : sizeof(float) * (size_t)kJ *
                                       (stride_pairs(N) + hg * stride_pairs(P));
  const size_t state = sizeof(float) * (size_t)round8(P) * stride_pairs(N);
  return tile > state ? tile : state;
}

template <typename T>
__host__ __device__ constexpr size_t chunk_smem(int P, int N, int L, int hg) {
  return sizeof(float) * (size_t)hg * (5 * round_up(L, kJ) + kBlock) +
         sizeof(T) * (size_t)kStrip * (stride_pairs(N) + hg * stride_pairs(P))
         + 2 * chunk_stage<T>(P, N, hg) + chunk_small<T>(P, N, hg);
}

// (iii): per (chunk, head group, b).  entering / gout: [B, nc, H, P, N]
// from (i) and (ii); meta: dacum and dt [B, nc, H, 2, L].  Writes dx, ddt,
// the groups' partials dBp / dCp [B, nc, groups, L, N] and dap [B, nc, H].
template <typename T, int NQ, int HG>
__global__ void __launch_bounds__(kBlock)
chunk_kernel(const T* __restrict__ x, const float* __restrict__ a,
             const T* __restrict__ bm, const T* __restrict__ cm,
             const T* __restrict__ dy, const float* __restrict__ entering,
             const float* __restrict__ gout, const float* __restrict__ meta,
             T* __restrict__ dx, float* __restrict__ ddt,
             float* __restrict__ dBp, float* __restrict__ dCp,
             float* __restrict__ dap, int S, int H, int P, int N, int L,
             int vec, int vec_s) {
  constexpr bool kExact = exact<T>();
  // the k loops' unrolling: two steps, one where a head pair's
  // accumulators leave no registers for a second step's fragments
  constexpr int kUnroll = HG == 2 ? 1 : 2;
  const int lc = stride_pairs(N), lp = stride_pairs(P);
  const int nk = round8(N) / 8, np = round8(P) / 8;
  const int Lr = round_up(L, kJ);
  const int c = blockIdx.x, grp = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, groups = gridDim.y;
  const int hb = grp * HG, nh = min(HG, H - hb);
  const size_t sb = chunk_stage<T>(P, N, HG);
  extern __shared__ float4 smem4[];
  float* mt = reinterpret_cast<float*>(smem4);   // [HG][2][Lr] dacum, dt
  float* dd = mt + HG * 2 * Lr;                  // [HG][3][Lr] d(dacum),
                                                 // e (columns), f
  float* red = dd + HG * 3 * Lr;                 // [HG][kBlock]
  T* Os = reinterpret_cast<T*>(red + HG * kBlock);   // [64][lc], then
                                                     // [HG][64][lp]
  char* ring = reinterpret_cast<char*>(Os + kStrip * (lc + HG * lp));
  float* small = reinterpret_cast<float*>(ring + 2 * sb);  // the stage in
                                                           // use's small parts

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = 16 * warp;
  const int64_t t0 = (int64_t)b * S + (int64_t)c * L;
  const int64_t xrow = (int64_t)H * P;
  const int64_t bch0 = ((int64_t)b * nc + c) * H + hb;
  const int64_t part0 = (((int64_t)b * nc + c) * groups + grp) * L * N;
  // rows 2t and 2t + 1 of a prow-ordered 8-row group: where they sit
  const int pr0 = prow(2 * t), pr1 = prow(2 * t + 1), prg = prow(g);

  for (int hl = 0; hl < nh; ++hl) {
    tf32x3::stage_scalars(mt + hl * 2 * Lr, meta + (bch0 + hl) * 2 * L, 1,
                          Lr, L, tid, kBlock);
    tf32x3::stage_scalars(mt + hl * 2 * Lr + Lr,
                          meta + (bch0 + hl) * 2 * L + L, 1, Lr, L, tid,
                          kBlock);
  }
  for (int i = tid; i < HG * 3 * Lr; i += kBlock) dd[i] = 0.f;
  tf32x3::zero_cols(Os, lc, kStrip, N, tid, kBlock);
  tf32x3::zero_cols(Os + kStrip * lc, lp, HG * kStrip, P, tid, kBlock);

  // the ring's loads: a 32-row tile (rows in prow order) or a state
  auto issue = [&](const Step& st, char* dst) {
    if (st.kind == 1) {
      if (st.idx >= nh) return;
      float* Ss = reinterpret_cast<float*>(dst);           // [round8(P)][lc]
      tf32x3::stage(Ss, lc, (st.pass == 0 ? entering : gout) +
                    (bch0 + st.idx) * P * N, N, round8(P), P, N, vec_s, tid,
                    kBlock, true);
      tf32x3::zero_cols(Ss, lc, round8(P), N, tid, kBlock);
      return;
    }
    const int j0 = st.idx * kJ, nv = min(kJ, L - j0);
    T* Nt = reinterpret_cast<T*>(dst);                     // [kJ][lc]
    tf32x3::stage(Nt, lc, (st.pass == 0 ? bm : cm) + (t0 + j0) * N, N, kJ,
                  nv, N, vec, tid, kBlock, true);
    tf32x3::zero_cols(Nt, lc, kJ, N, tid, kBlock);
    for (int hl = 0; hl < nh; ++hl) {                      // [kJ][lp] each
      T* Pt = Nt + kJ * lc + hl * kJ * lp;
      tf32x3::stage(Pt, lp, (st.pass == 0 ? x : dy) + (t0 + j0) * xrow +
                    (int64_t)(hb + hl) * P, xrow, kJ, nv, P, vec, tid, kBlock,
                    true);
      tf32x3::zero_cols(Pt, lp, kJ, P, tid, kBlock);
    }
  };

  float accN[NQ][4];      // dC (pass A) or dB (pass B), rows of the group
  float accP[HG][8][4];   // dx (pass B), per head
  float rs[HG][2];        // row sums: d(dacum) (pass A), e (pass B)
  const int total = steps(L, HG);
  issue(step_at(0, L, HG), ring);
  hopper::cp_async_commit();
  for (int k = 0; k < total; ++k) {
    const Step st = step_at(k, L, HG);
    const int row0 = 64 * st.tile;               // the 64-row tile's first
    hopper::cp_async_wait<0>();
    __syncthreads();
    if (st.kind == 0 && st.idx == (st.pass == 0 ? 0 : 2 * st.tile)) {
      // a new 64-row tile: its own operands (pass A: C and dy; pass B: B
      // and x), and its accumulators cleared
      const int nv = min(kStrip, L - row0);
      tf32x3::stage(Os, lc, (st.pass == 0 ? cm : bm) + (t0 + row0) * N, N,
                    kStrip, nv, N, vec, tid, kBlock);
      for (int hl = 0; hl < nh; ++hl)
        tf32x3::stage(Os + kStrip * lc + hl * kStrip * lp, lp,
                      (st.pass == 0 ? dy : x) + (t0 + row0) * xrow +
                          (int64_t)(hb + hl) * P,
                      xrow, kStrip, nv, P, vec, tid, kBlock);
      hopper::cp_async_commit();
      hopper::cp_async_wait<0>();
      __syncthreads();
#pragma unroll
      for (int q = 0; q < NQ; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) accN[q][e] = 0.f;
#pragma unroll
      for (int hl = 0; hl < HG; ++hl) {
#pragma unroll
        for (int q = 0; q < 8; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) accP[hl][q][e] = 0.f;
        rs[hl][0] = rs[hl][1] = 0.f;
      }
    }
    // the stage's tiles every warp reads, split once: fp32 tiles (bf16 is
    // exact) or a state, the big parts in place, the small ones at `small`
    float* stf = reinterpret_cast<float*>(ring + (k & 1) * sb);
    if (st.kind == 1) {
      if (st.idx < nh)
        tf32x3::split_tile(stf, small, lc, round8(P), round8(N), tid, kBlock);
    } else if constexpr (!kExact) {
      tf32x3::split_tile(stf, small, lc, kJ, round8(N), tid, kBlock);
      for (int hl = 0; hl < nh; ++hl) {
        const int off = kJ * lc + hl * kJ * lp;
        tf32x3::split_tile(stf + off, small + off, lp, kJ, round8(P), tid,
                           kBlock);
      }
    }
    __syncthreads();
    const int soff = (int)(small - stf);      // small part of a tile element
    if (k + 1 < total) issue(step_at(k + 1, L, HG), ring + ((k + 1) & 1) * sb);
    hopper::cp_async_commit();

    const char* stg = ring + (k & 1) * sb;
    const int rw = row0 + r0 + g;                // the warp's rows rw, rw + 8
    const bool rows_in = row0 + r0 < L;
    const T* oa = Os + (r0 + g) * lc + 2 * t;    // C or B rows (pairs)
    if (st.kind == 0 && rows_in) {
      const int j0 = st.idx * kJ;   // pass A: columns m; pass B: rows l
      // pass A: no m <= l in this tile for the warp's rows; pass B: no
      // l >= m
      const bool seen = st.pass == 0 ? j0 <= row0 + r0 + 15
                                     : j0 + kJ - 1 >= row0 + r0;
      if (seen) {
        const T* Nt = reinterpret_cast<const T*>(stg);
        // C B^T (pass A) or B C^T (pass B): [warp rows][32]
        float cb[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) cb[n][e] = 0.f;
#pragma unroll (kUnroll)
        for (int kk = 0; kk < nk; ++kk) {
          uint32_t ab[4], as[4];
          tf32x3::load_a(oa, lc, kk, ab, as);
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            uint32_t bb[2], bs[2];
            tf32x3::load_b_pairs(Nt + (8 * n + prg) * lc + 2 * t, soff, kk,
                                 bb, bs);
            tf32x3::mma3<kExact, kExact>(cb[n], ab, as, bb, bs);
          }
        }
#pragma unroll
        for (int hl = 0; hl < HG; ++hl) {
          if (hl >= nh) continue;
          const float* cum = mt + hl * 2 * Lr;
          const float* dtv = cum + Lr;
          const T* Pt = Nt + kJ * lc + hl * kJ * lp;   // x (A) or dy (B)
          const T* pa = Os + kStrip * lc + hl * kStrip * lp + (r0 + g) * lp +
                        2 * t;                          // dy (A) or x (B)
          // dW = dY X^T (pass A) or X dY^T (pass B)
          float dw[4][4];
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) dw[n][e] = 0.f;
#pragma unroll (kUnroll)
          for (int kk = 0; kk < np; ++kk) {
            uint32_t ab[4], as[4];
            tf32x3::load_a(pa, lp, kk, ab, as);
#pragma unroll
            for (int n = 0; n < 4; ++n) {
              uint32_t bb[2], bs[2];
              tf32x3::load_b_pairs(Pt + (8 * n + prg) * lp + 2 * t, soff, kk,
                                   bb, bs);
              tf32x3::mma3<kExact, kExact>(dw[n], ab, as, bb, bs);
            }
          }
          const float cr[2] = {cum[min(rw, L - 1)], cum[min(rw + 8, L - 1)]};
          const float dr[2] = {rw < L ? dtv[rw] : 0.f,
                               rw + 8 < L ? dtv[rw + 8] : 0.f};
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const int r8 = 8 * n;
            if (st.pass == 0) {
              // dCB = dW * M * dt[m]; d(dacum[l]) += dCB . CB; dC += dCB B
              float v[4];
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int l = rw + 8 * (e >> 1), m = j0 + r8 + 2 * t + (e & 1);
                const bool ok = m <= l && l < L;
                const float d = ok ? dw[n][e] * __expf(cr[e >> 1] - cum[m]) *
                                         dtv[m]
                                   : 0.f;
                rs[hl][e >> 1] += d * cb[n][e];
                v[e] = d;
              }
              uint32_t ab[4], as[4];
              tf32x3::from_c(v, ab, as);
              const T* bp = Nt + (r8 + pr0) * lc + g;
#pragma unroll
              for (int q = 0; q < NQ; ++q) {
                if (q < nk) {
                  uint32_t bb[2], bs[2];
                  tf32x3::load_b_cols(bp + 8 * q, soff, (pr1 - pr0) * lc, bb,
                                      bs);
                  tf32x3::mma3<false, kExact>(accN[q], ab, as, bb, bs);
                }
              }
            } else {
              // T1 = CB^T * M^T, T2 = dW^T * M^T; e[m] += T2 . CB^T;
              // dx += T1 dY; dB += (T2 dt[m]) C
              float v1[4], v2[4];
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int m = rw + 8 * (e >> 1), l = j0 + r8 + 2 * t + (e & 1);
                const bool ok = l >= m && l < L;
                const float mk = ok ? __expf(cum[l] - cr[e >> 1]) : 0.f;
                const float t2 = dw[n][e] * mk;
                v1[e] = cb[n][e] * mk;
                rs[hl][e >> 1] += t2 * cb[n][e];
                v2[e] = t2 * dr[e >> 1];
              }
              uint32_t ab[4], as[4];
              tf32x3::from_c(v1, ab, as);
              const T* yp = Pt + (r8 + pr0) * lp + g;
#pragma unroll
              for (int q = 0; q < 8; ++q) {
                if (q < np) {
                  uint32_t bb[2], bs[2];
                  tf32x3::load_b_cols(yp + 8 * q, soff, (pr1 - pr0) * lp, bb,
                                      bs);
                  tf32x3::mma3<false, kExact>(accP[hl][q], ab, as, bb, bs);
                }
              }
              tf32x3::from_c(v2, ab, as);
              const T* cp = Nt + (r8 + pr0) * lc + g;
#pragma unroll
              for (int q = 0; q < NQ; ++q) {
                if (q < nk) {
                  uint32_t bb[2], bs[2];
                  tf32x3::load_b_cols(cp + 8 * q, soff, (pr1 - pr0) * lc, bb,
                                      bs);
                  tf32x3::mma3<false, kExact>(accN[q], ab, as, bb, bs);
                }
              }
            }
          }
        }
      }
    }
    if (st.kind == 1 && rows_in) {
#pragma unroll
      for (int hl = 0; hl < HG; ++hl) {
        if (hl != st.idx || hl >= nh) continue;
        const float* cum = mt + hl * 2 * Lr;
        const float* dtv = cum + Lr;
        const float* Ss = reinterpret_cast<const float*>(stg);  // h_in or G
        const T* pa = Os + kStrip * lc + hl * kStrip * lp + (r0 + g) * lp +
                      2 * t;                                     // dy or x
        // C h_in^T (pass A) or B G^T (pass B): [warp rows][P]
        float sp[8][4];
#pragma unroll
        for (int q = 0; q < 8; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) sp[q][e] = 0.f;
#pragma unroll (kUnroll)
        for (int kk = 0; kk < nk; ++kk) {
          uint32_t ab[4], as[4];
          tf32x3::load_a(oa, lc, kk, ab, as);
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            if (q < np) {
              uint32_t bb[2], bs[2];
              tf32x3::load_b_pairs(Ss + (8 * q + prg) * lc + 2 * t, soff, kk,
                                   bb, bs);
              tf32x3::mma3<kExact, false>(sp[q], ab, as, bb, bs);
            }
          }
        }
        // per row: pass A exp(dacum[l]); pass B r[m] and r[m] dt[m]
        float sc[2], sa[2];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int i = rw + 8 * hf;
          const bool in = i < L;
          sc[hf] = !in ? 0.f
                       : st.pass == 0 ? expf(cum[i])
                                      : expf(cum[L - 1] - cum[i]);
          sa[hf] = st.pass == 0 ? sc[hf] : (in ? sc[hf] * dtv[i] : 0.f);
        }
        // the row's dot with its own dy (pass A) or x (pass B)
        float dot[2] = {0.f, 0.f};
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if (q < np) {
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const float2 o = tf32x3::ld2(pa + 8 * hf * lp + 8 * q);
              dot[hf] += o.x * sp[q][2 * hf] + o.y * sp[q][2 * hf + 1];
            }
          }
        }
        if (st.pass == 0) {
          rs[hl][0] += sc[0] * dot[0];
          rs[hl][1] += sc[1] * dot[1];
        } else {
          // f[m] = r[m] x[m] . (B G^T)[m]; dx += r[m] (B G^T)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            float f = sc[hf] * dot[hf];
            f += __shfl_xor_sync(0xffffffffu, f, 1);
            f += __shfl_xor_sync(0xffffffffu, f, 2);
            const int i = rw + 8 * hf;
            if (t == 0 && i < L) dd[(hl * 3 + 2) * Lr + i] = f;
#pragma unroll
            for (int q = 0; q < 8; ++q) {
              accP[hl][q][2 * hf] += sc[hf] * sp[q][2 * hf];
              accP[hl][q][2 * hf + 1] += sc[hf] * sp[q][2 * hf + 1];
            }
          }
        }
        // dC += exp(dacum) dy h_in (A), dB += r dt x G (B): the rows of
        // dy / x scaled, the state read down its columns
#pragma unroll (kUnroll)
        for (int kk = 0; kk < np; ++kk) {
          const float2 o0 = tf32x3::ld2(pa + 8 * kk);
          const float2 o1 = tf32x3::ld2(pa + 8 * lp + 8 * kk);
          const float av[4] = {o0.x * sa[0], o1.x * sa[1], o0.y * sa[0],
                               o1.y * sa[1]};
          uint32_t ab[4], as[4];
          tf32x3::split<false>(av, ab, as);
          const float* sp_k = Ss + (8 * kk + pr0) * lc + g;
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
            if (q < nk) {
              uint32_t bb[2], bs[2];
              tf32x3::load_b_cols(sp_k + 8 * q, soff, (pr1 - pr0) * lc, bb,
                                  bs);
              tf32x3::mma3<false, false>(accN[q], ab, as, bb, bs);
            }
          }
        }
      }
    }
    if (st.kind == 1 && st.idx == HG - 1 && rows_in) {
      // the 64-row tile's last step: its rows' sums and outputs
#pragma unroll
      for (int hl = 0; hl < HG; ++hl) {
        if (hl >= nh) continue;
        const float* dtv = mt + hl * 2 * Lr + Lr;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float v = rs[hl][hf];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          const int i = rw + 8 * hf;
          if (i >= L) continue;
          if (t == 0) dd[(hl * 3 + st.pass) * Lr + i] = v;
          if (st.pass == 1) {   // dx = dt[m] (sum T1 dY + r (B G^T))
            T* row = dx + (t0 + i) * xrow + (int64_t)(hb + hl) * P;
#pragma unroll
            for (int q = 0; q < 8; ++q) {
              const int p = 8 * q + 2 * t;
              if (p < P)
                row[p] = tf32x3::from_float<T>(dtv[i] *
                                               accP[hl][q][2 * hf]);
              if (p + 1 < P)
                row[p + 1] = tf32x3::from_float<T>(dtv[i] *
                                                   accP[hl][q][2 * hf + 1]);
            }
          }
        }
      }
      float* part = (st.pass == 0 ? dCp : dBp) + part0;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = rw + 8 * hf;
        if (i >= L) continue;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int n = 8 * q + 2 * t;
          if (q < nk && n < N)
            *reinterpret_cast<float2*>(part + (int64_t)i * N + n) =
                make_float2(accN[q][2 * hf], accN[q][2 * hf + 1]);
        }
      }
    }
  }
  hopper::cp_async_wait<0>();

  // ---- d(dacum) -> d(da), ddt, the chunk's part of da, per head ----
  __syncthreads();
  for (int hl = 0; hl < nh; ++hl) {
    const float* hin = entering + (bch0 + hl) * P * N;
    const float* gn = gout + (bch0 + hl) * P * N;
    float hsum = 0.f;     // h_in . G, for the decay of the entering state
    for (int e = tid; e < P * N; e += kBlock) hsum += hin[e] * gn[e];
    red[hl * kBlock + tid] = hsum;
    const float* dtv = mt + hl * 2 * Lr + Lr;
    float* dcum = dd + hl * 3 * Lr;
    for (int i = tid; i < L; i += kBlock)
      dcum[i] -= dtv[i] * (dcum[Lr + i] + dcum[2 * Lr + i]);
  }
  __syncthreads();
  if (lane == 0 && warp < nh) {
    const int hl = warp;
    const float* cum = mt + hl * 2 * Lr;
    const float* dtv = cum + Lr;
    float* dcum = dd + hl * 3 * Lr;
    const float* ecol = dcum + Lr;
    const float* fd = dcum + 2 * Lr;
    float hs = 0.f, fs = 0.f;
    for (int i = 0; i < kBlock; ++i) hs += red[hl * kBlock + i];
    for (int m = 0; m < L; ++m) fs += dtv[m] * fd[m];
    dcum[L - 1] += fs + expf(cum[L - 1]) * hs;
    const float ah = a[hb + hl];
    float dda = 0.f, part = 0.f;
    for (int i = L - 1; i >= 0; --i) {
      dda += dcum[i];
      ddt[(t0 + i) * H + hb + hl] = ecol[i] + fd[i] + ah * dda;
      part += dtv[i] * dda;
    }
    dap[bch0 + hl] = part;
  }
}

// dB[b, s, n] = sum_h dBp[b, c, h, l, n] (s = c L + l), the same for dC,
// heads in order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
reduce_kernel(const float* __restrict__ dBp, const float* __restrict__ dCp,
              T* __restrict__ db, T* __restrict__ dc, int B, int S, int H,
              int N, int L) {
  const int64_t id = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (id >= (int64_t)B * S * N) return;
  const int n = (int)(id % N);
  const int64_t bs = id / N;
  const int s = (int)(bs % S);
  const int b = (int)(bs / S);
  const int c = s / L, l = s - c * L;
  const int nchunks = S / L;
  const int64_t first = (((int64_t)b * nchunks + c) * H) * L * N +
                        (int64_t)l * N + n;
  const int64_t step = (int64_t)L * N;
  float sb = 0.f, sc = 0.f;
  for (int h = 0; h < H; ++h) {
    sb += dBp[first + h * step];
    sc += dCp[first + h * step];
  }
  db[id] = tf32x3::from_float<T>(sb);
  dc[id] = tf32x3::from_float<T>(sc);
}

// da[h] = sum over (b, chunk) of dap, in order
__global__ void __launch_bounds__(kThreads)
da_kernel(const float* __restrict__ dap, float* __restrict__ da, int bnc,
          int H) {
  const int h = blockIdx.x * kThreads + threadIdx.x;
  if (h >= H) return;
  float s = 0.f;
  for (int i = 0; i < bnc; ++i) s += dap[(int64_t)i * H + h];
  da[h] = s;
}

// -- host side --------------------------------------------------------------

__host__ __device__ constexpr long long pad4(long long v) {
  return (v + 3) / 4 * 4;
}

// fp32 scratch, in order (each part a multiple of 4 floats): the entering
// states and the leaving states' gradients ([B, nc, H, P, N] each), dacum
// and dt ([B, nc, H, 2, L]), declog and dap ([B, nc, H] each), the groups'
// dB and dC partials ([B, nc, groups, L, N] each)
struct Scratch {
  long long entering, gout, meta, declog, dap, dbp, dcp, total;
};

inline Scratch scratch_layout(int B, int S, int H, int P, int N, int L,
                              size_t elem) {
  const long long bch = (long long)B * (S / L) * H;
  const int hg = heads(N, elem);
  const long long parts = (long long)B * (S / L) * ((H + hg - 1) / hg) * L *
                          N;
  Scratch s;
  s.entering = 0;
  s.gout = s.entering + pad4(bch * P * N);
  s.meta = s.gout + pad4(bch * P * N);
  s.declog = s.meta + pad4(bch * 2 * L);
  s.dap = s.declog + pad4(bch);
  s.dbp = s.dap + pad4(bch);
  s.dcp = s.dbp + parts;
  s.total = s.dcp + parts;
  return s;
}

inline long long scratch_floats(int B, int S, int H, int P, int N, int L,
                                size_t elem) {
  return scratch_layout(B, S, H, P, N, L, elem).total;
}

// each chunk's own term (own_kernel): MODE 0 from x and B (dacum and dt
// into meta), MODE 1 from dy and C (dacum from meta: either variant's
// layout, [B, nc, H, 2, L]); declog = dacum[L-1]
template <typename T, int MODE>
int launch_own(const void* xs, const void* ys, const void* dt,
               const void* a, float* meta, float* out, float* declog, int B,
               int S, int H, int P, int N, int L, cudaStream_t s) {
  const size_t smem = own_smem_bytes<T>(L);
  static bool configured = false;
  int err = simt::opt_in(own_kernel<T, MODE>, smem, configured);
  if (err) return err;
  const int vec = tf32x3::copy_bytes(sizeof(T), {xs, ys}, {P, N});
  const dim3 grid(((N + kStrip - 1) / kStrip) * H, S / L, B);
  own_kernel<T, MODE><<<grid, kBlock, smem, s>>>(
      static_cast<const T*>(xs), static_cast<const T*>(ys),
      static_cast<const float*>(dt), static_cast<const float*>(a), meta, out,
      declog, S, H, P, N, L, vec);
  return (int)cudaGetLastError();
}

template <typename T, int NQ, int HG>
int launch_chunk(const void* x, const float* a, const void* bm,
                 const void* cm, const void* dy, const float* entering,
                 const float* gout, const float* meta, void* dx, float* ddt,
                 float* dbp, float* dcp, float* dap, int B, int S, int H,
                 int P, int N, int L, cudaStream_t s) {
  const size_t smem = chunk_smem<T>(P, N, L, HG);
  static bool configured = false;
  int err = simt::opt_in(chunk_kernel<T, NQ, HG>, smem, configured);
  if (err) return err;
  const int vec = tf32x3::copy_bytes(sizeof(T), {x, bm, cm, dy}, {P, N});
  const int vec_s = tf32x3::copy_bytes(sizeof(float), {entering, gout}, {N});
  const dim3 grid(S / L, (H + HG - 1) / HG, B);
  chunk_kernel<T, NQ, HG><<<grid, kBlock, smem, s>>>(
      static_cast<const T*>(x), a, static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<const T*>(dy), entering, gout,
      meta, static_cast<T*>(dx), ddt, dbp, dcp, dap, S, H, P, N, L, vec,
      vec_s);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x_, const void* dt_, const void* a_, const void* bm_,
           const void* cm_, const void* h0_, const void* dy_,
           const void* dfinal_, void* dx_, void* ddt_, void* da_, void* db_,
           void* dc_, void* dh0_, float* scratch, int B, int S, int H, int P,
           int N, int L, cudaStream_t s) {
  const Scratch sc = scratch_layout(B, S, H, P, N, L, sizeof(T));
  const int nchunks = S / L;
  float* entering = scratch + sc.entering;
  float* gout = scratch + sc.gout;
  float* meta = scratch + sc.meta;
  float* declog = scratch + sc.declog;
  float* dap = scratch + sc.dap;
  float* dBp = scratch + sc.dbp;
  float* dCp = scratch + sc.dcp;
  const float* a = static_cast<const float*>(a_);
  const long long scan_threads = (long long)B * H * P * N;
  const long long scan_blocks = (scan_threads + kThreads - 1) / kThreads;
  const long long red_blocks = ((long long)B * S * N + kThreads - 1) /
                               kThreads;
  if (scan_blocks > 0x7fffffffLL || red_blocks > 0x7fffffffLL ||
      nchunks > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;

  // (i) each chunk's dacum, dt and own state, carried into the states
  // entering each chunk
  int err = launch_own<T, 0>(x_, bm_, dt_, a_, meta, entering, declog, B, S,
                             H, P, N, L, s);
  if (err) return err;
  scan_kernel<<<(unsigned)scan_blocks, kThreads, 0, s>>>(
      entering, declog, static_cast<const float*>(h0_), nullptr, B, nchunks,
      H, P * N, 0);
  // (ii) the gradient of the state leaving each chunk, and dh0
  err = launch_own<T, 1>(dy_, cm_, nullptr, nullptr, meta, gout, declog, B,
                         S, H, P, N, L, s);
  if (err) return err;
  scan_kernel<<<(unsigned)scan_blocks, kThreads, 0, s>>>(
      gout, declog, static_cast<const float*>(dfinal_),
      static_cast<float*>(dh0_), B, nchunks, H, P * N, 1);
  // (iii) per (chunk, head group, b), then the sums over the groups and
  // over (b, chunk)
  const int hg = heads(N, sizeof(T));
  if (N > 64)
    err = launch_chunk<T, 16, 1>(x_, a, bm_, cm_, dy_, entering, gout, meta,
                                 dx_, static_cast<float*>(ddt_), dBp, dCp,
                                 dap, B, S, H, P, N, L, s);
  else
    err = launch_chunk<T, 8, heads(64, sizeof(T))>(
        x_, a, bm_, cm_, dy_, entering, gout, meta, dx_,
        static_cast<float*>(ddt_), dBp, dCp, dap, B, S, H, P, N, L, s);
  if (err) return err;
  const int groups = (H + hg - 1) / hg;
  reduce_kernel<T><<<(unsigned)red_blocks, kThreads, 0, s>>>(
      dBp, dCp, static_cast<T*>(db_), static_cast<T*>(dc_), B, S, groups, N,
      L);
  da_kernel<<<(H + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      dap, static_cast<float*>(da_), B * nchunks, H);
  return (int)cudaGetLastError();
}

}  // namespace backward
}  // namespace ssd
