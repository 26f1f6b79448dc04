// The tensor-core variant of the SSD scan (tc): bf16 x, B and C; P = 64;
// N in {64, 128}; the chunk L a multiple of 64, at most 256.  See
// ssd_scan.cu for the design notes; this file holds its two kernels,
// ssd_state and ssd_chunk_scan, and their launches.
#pragma once

#include <math.h>

#include "hopper_ptx.cuh"

namespace ssd {
namespace tc {

using namespace ::hopper;

constexpr int kP = 64;                     // head dim
constexpr int kT = 64;                     // rows of a sub-tile or strip
constexpr int kMaxL = 256;                 // longest chunk
constexpr int kMaxTiles = kMaxL / kT;
constexpr int kConsumers = 128;            // one warpgroup
constexpr int kThreads = kConsumers + 32;  // plus a producer warp
constexpr int kRow = 128;                  // bytes of a swizzled row (64 bf16)
constexpr int kBox = kT * kRow;            // one [64][64] bf16 box: 8 KB
constexpr int kStateStages = 2;            // ssd_state: ring of 64-row sub-tiles
constexpr int kHeadStages = 2;             // ssd_chunk_scan: ring of heads
constexpr int kHeadGroup = 16;             // heads of one ssd_chunk_scan block
constexpr int kMaxSmem = 232448;

// Shared-memory plans, byte offsets from a 1024-aligned base (the 128-byte
// swizzle repeats every 8 rows = 1024 bytes; TMA and wgmma both assume it).
// A [rows][N] bf16 tile is stored as N / 64 boxes of [rows][64].
struct StatePlan {
  static constexpr int kStage = 2 * kBox;              // x box, then a B box
  static constexpr int kLo = kStateStages * kStage;    // lo part of weighted x
  static constexpr int kSt = kLo + kBox;               // two state boxes out
  static constexpr int kW = kSt + 2 * kBox;            // float [kMaxL] weights
  static constexpr int kDac = kW + 4 * kMaxL;          // float [kMaxL] dacum
  static constexpr int kBar = kDac + 4 * kMaxL;        // u64 full, empty
  static constexpr int kBytes = kBar + 2 * kStateStages * 8;
  static constexpr int kAlloc = kBytes + 1024;         // alignment slack
};

template <int N>
struct ChunkPlan {
  static constexpr int kC = 0;                               // C strip
  static constexpr int kB = kC + kBox * (N / 64);            // B tiles
  static constexpr int kStage0 = kB + kMaxTiles * kBox * (N / 64);
  // one head's stage: entering state [P][N], x tiles, dacum and dt
  static constexpr int kX = kBox * (N / 64);
  static constexpr int kMeta = kX + kMaxTiles * kBox;
  static constexpr int kStage = kMeta + 2 * 4 * kMaxL;
  static constexpr int kY = kStage0 + kHeadStages * kStage;  // two y boxes out
  static constexpr int kBar = kY + 2 * kBox;                  // cb, full, empty
  static constexpr int kBytes = kBar + (1 + 2 * kHeadStages) * 8;
  static constexpr int kAlloc = kBytes + 1024;
};

constexpr float kLog2e = 1.4426950408889634f;

// 2^x by the SFU (relative error ~2^-22; W is rounded to bf16 after it)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A 64 x 64 fp32 accumulator fragment (rows r0 and r0 + 8; columns
// 8 j + c and 8 j + c + 1, j < 8) rounded to bf16 into a [64][64] box with
// the 128-byte swizzle, as a TMA store reads it
__device__ __forceinline__ void frag_to_box(uint8_t* box, const float* acc,
                                            int r0, int c) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = r0 + 8 * hr;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(box + r * kRow +
                                         ((j ^ (r & 7)) << 4) + 2 * c) =
          __floats2bfloat162_rn(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]);
  }
}

// two bf16 of x times w: the bf16 rounding in place, the rest as lo
__device__ __forceinline__ void split_scaled(uint32_t& v, uint32_t& lo,
                                             float w) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  const float x0 = f.x * w, x1 = f.y * w;
  const __nv_bfloat162 hv = __floats2bfloat162_rn(x0, x1);
  lo = pack_bf16(x0 - __low2float(hv), x1 - __high2float(hv));
  v = *reinterpret_cast<const uint32_t*>(&hv);
}

// ssd_state: one block per (b, head, 64 columns of N), the column blocks
// of a head adjacent.  The consumer warpgroup keeps its [P, 64] slice of
// the carried fp32 state in its wgmma accumulator from h0 to the final
// state; per chunk it writes the slice entering the chunk (bf16, by TMA
// store), and the first column block the chunk's dacum and dt (fp32), for
// ssd_chunk_scan; it decays the state by exp(dacum[L-1]) and adds (x *
// exp(dacum[L-1] - dacum) * dt)^T . B over 64-row sub-tiles, the weighted
// x as bf16 hi + lo.  Warp 4 is the producer: x and B sub-tiles by TMA
// into a ring.
template <int N>
__global__ void __launch_bounds__(kThreads, 3)   // three blocks an SM
ssd_state_kernel(const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap tb,
                 const __grid_constant__ CUtensorMap ts,
                 const float* __restrict__ dt, const float* __restrict__ a,
                 const float* __restrict__ h0, float* __restrict__ meta,
                 float* __restrict__ hout, int S, int H, int L) {
  using Pl = StatePlan;
  constexpr int kAcc = 32;
  constexpr int kPerLane = kMaxL / 32;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw);
  float* wts = reinterpret_cast<float*>(sm + Pl::kW);
  float* dac = reinterpret_cast<float*>(sm + Pl::kDac);
  const uint32_t full_bar = base + Pl::kBar;
  const uint32_t empty_bar = full_bar + 8 * kStateStages;

  const int n0 = 64 * (blockIdx.x % (N / 64));   // this block's columns
  const int h = blockIdx.x / (N / 64) % H;
  const int b = blockIdx.x / (N / 64) / H;
  const int nc = S / L;
  const int nsub = L / kT;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  if (tid == 0) {
    for (int s = 0; s < kStateStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // ---- producer: the x box and the B box of each 64-row sub-tile ----
    if (lane != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int c = 0; c < nc; ++c)
      for (int k = 0; k < nsub; ++k) {
        mbar_wait(empty_bar + 8 * stage, phase ^ 1);
        const uint32_t fb = full_bar + 8 * stage;
        const uint32_t dst = base + stage * Pl::kStage;
        const int row = c * L + k * kT;
        mbar_arrive_expect_tx(fb, Pl::kStage);
        tma_load_4d(dst, &tx, fb, 0, h, row, b);
        tma_load_4d(dst + kBox, &tb, fb, n0, 0, row, b);
        if (++stage == kStateStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    return;
  }

  // ---- consumers: accumulator element i is state row r0 + 8 * (i % 4 /
  // 2), column n0 + 8 * (i / 4) + c0 + i % 2 ----
  const int r0 = warp * 16 + lane / 4;
  const int cl = 2 * (lane % 4);   // within the block's 64 columns
  const int c0 = n0 + cl;
  const int64_t bh = (int64_t)b * H + h;
  float acc[kAcc];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const float2 v = *reinterpret_cast<const float2*>(
          h0 + (bh * kP + r0 + 8 * hr) * N + 8 * j + c0);
      acc[4 * j + 2 * hr] = v.x;
      acc[4 * j + 2 * hr + 1] = v.y;
    }
  const float ah = a[h];
  const int per = L / 32;   // steps of the chunk a lane of warp 0 scans
  float dtv[kPerLane];
  auto load_dt = [&](int c) {
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) {
      const int l = lane * per + e;
      dtv[e] = e < per && c < nc
                   ? dt[((int64_t)b * S + (int64_t)c * L + l) * H + h]
                   : 0.f;
    }
  };
  if (warp == 0) load_dt(0);
  const uint32_t lo_addr = base + Pl::kLo;
  uint8_t* lo_ptr = sm + Pl::kLo;
  int stage = 0;
  uint32_t phase = 0;
  for (int c = 0; c < nc; ++c) {
    const int64_t bch = ((int64_t)b * nc + c) * H + h;
    if (warp == 0) {
      // dacum = cumsum(dt * a): each lane runs its `per` consecutive steps,
      // then a warp scan adds the lanes before it
      float run[kPerLane];
      float tot = 0.f;
#pragma unroll
      for (int e = 0; e < kPerLane; ++e)
        if (e < per) {
          tot += dtv[e] * ah;
          run[e] = tot;
        }
      float incl = tot;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.f;
      const float last = __shfl_sync(0xffffffffu, incl, 31);
      float* mrow = meta + bch * 2 * L;
#pragma unroll
      for (int e = 0; e < kPerLane; ++e)
        if (e < per) {
          const int l = lane * per + e;
          const float d = excl + run[e];
          dac[l] = d;
          wts[l] = expf(last - d) * dtv[e];
          if (n0 == 0) {
            mrow[l] = d;
            mrow[L + l] = dtv[e];
          }
        }
      load_dt(c + 1);   // the next chunk's dt, in flight during this one
      if (lane == 0) bulk_wait_read<1>();   // chunk c - 2's box is read
    }
    named_bar_sync(1, kConsumers);

    // the state entering chunk c, rounded once to bf16 into a box that a
    // TMA store takes out after the first sub-tile's barrier
    uint8_t* sbox = sm + Pl::kSt + (c % 2) * kBox;
    frag_to_box(sbox, acc, r0, cl);
    const float decay = expf(dac[L - 1]);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] *= decay;

    for (int k = 0; k < nsub; ++k) {
      mbar_wait(full_bar + 8 * stage, phase);
      uint8_t* xs = sm + stage * Pl::kStage;
      // 16-byte chunk q of the swizzled x box holds 8 values of row q / 8
      // (the swizzle permutes chunks within a row): weight them in place
      // by their row's w, keep the bf16 rounding there and the rest in lo
#pragma unroll
      for (int q = tid; q < kT * 8; q += kConsumers) {
        const float w = wts[k * kT + q / 8];
        uint4 v = *reinterpret_cast<const uint4*>(xs + 16 * q);
        uint4 lo;
        split_scaled(v.x, lo.x, w);
        split_scaled(v.y, lo.y, w);
        split_scaled(v.z, lo.z, w);
        split_scaled(v.w, lo.w, w);
        *reinterpret_cast<uint4*>(xs + 16 * q) = v;
        *reinterpret_cast<uint4*>(lo_ptr + 16 * q) = lo;
      }
      fence_proxy_async();
      named_bar_sync(1, kConsumers);
      if (tid == 0 && k == 0) {
        tma_store_4d(&ts, smem_u32(sbox), n0, 0, h, b * nc + c);
        bulk_commit();
      }
      // state += (x_hi + x_lo)^T . B: A is x^T (MN-major), B MN-major
      const uint32_t xa = base + stage * Pl::kStage;
      const uint32_t ba = xa + kBox;
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < kT / 16; ++t)
        wgmma_ss_m64n64k16<1, 1>(acc,
                                 smem_desc(xa + t * 16 * kRow, kBox, 1024),
                                 smem_desc(ba + t * 16 * kRow, kBox, 1024), 1);
#pragma unroll
      for (int t = 0; t < kT / 16; ++t)
        wgmma_ss_m64n64k16<1, 1>(
            acc, smem_desc(lo_addr + t * 16 * kRow, kBox, 1024),
            smem_desc(ba + t * 16 * kRow, kBox, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<kAcc>(acc);
      mbar_arrive(empty_bar + 8 * stage);
      if (++stage == kStateStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      *reinterpret_cast<float2*>(hout + (bh * kP + r0 + 8 * hr) * N + 8 * j +
                                 c0) =
          make_float2(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]);
  if (tid == 0) bulk_wait_read<0>();
}

// ssd_chunk_scan: one block per (b, chunk, 64-row strip, group of heads),
// the longest strips first, heads fastest.  C_strip . B^T of each column
// tile up to the diagonal is computed once (n_groups == 1) and kept in
// registers; per head, y = exp(dacum_i) * C_strip . state^T + W . x over
// those tiles, W = C.B^T * exp(dacum_i - dacum_j) * dt_j (j <= i), formed
// on the fragment and fed as a register-A bf16 operand; y leaves by TMA
// store from two alternating boxes.  Warp 4 is the producer: C and B by
// TMA, then per head the entering state and the x tiles by TMA and dacum /
// dt by a bulk copy, into a 2-stage ring.
template <int N>
__global__ void __launch_bounds__(kThreads, 1)
ssd_chunk_kernel(const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap tb,
                 const __grid_constant__ CUtensorMap tcm,
                 const __grid_constant__ CUtensorMap ts,
                 const __grid_constant__ CUtensorMap ty,
                 const float* __restrict__ meta, int B, int S, int H,
                 int L) {
  using Pl = ChunkPlan<N>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw);
  const uint32_t cb_bar = base + Pl::kBar;
  const uint32_t full_bar = cb_bar + 8;
  const uint32_t empty_bar = full_bar + 8 * kHeadStages;

  const int nc = S / L;
  const int n_hg = (H + kHeadGroup - 1) / kHeadGroup;
  const int per_strip = B * nc * n_hg;
  int id = blockIdx.x;
  const int s = L / kT - 1 - id / per_strip;   // longest strips first
  id %= per_strip;
  const int hg = id % n_hg;
  id /= n_hg;
  const int c = id % nc;
  const int b = id / nc;
  const int i0 = s * kT;
  const int nt = s + 1;            // column tiles up to the diagonal
  const int t0 = c * L;            // the chunk's first step
  const int hfirst = hg * kHeadGroup;
  const int nh = min(kHeadGroup, H - hfirst);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  if (tid == 0) {
    mbar_init(cb_bar, 1);
    for (int st = 0; st < kHeadStages; ++st) {
      mbar_init(full_bar + 8 * st, 1);
      mbar_init(empty_bar + 8 * st, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // ---- producer ----
    if (lane != 0) return;
    mbar_arrive_expect_tx(cb_bar, kBox * (N / 64) * (1 + nt));
#pragma unroll
    for (int cc = 0; cc < N / 64; ++cc)
      tma_load_4d(base + Pl::kC + cc * kBox, &tcm, cb_bar, 64 * cc, 0,
                  t0 + i0, b);
    for (int t = 0; t < nt; ++t)
#pragma unroll
      for (int cc = 0; cc < N / 64; ++cc)
        tma_load_4d(base + Pl::kB + (t * (N / 64) + cc) * kBox, &tb, cb_bar,
                    64 * cc, 0, t0 + t * kT, b);
    int stage = 0;
    uint32_t phase = 0;
    for (int k = 0; k < nh; ++k) {
      const int h = hfirst + k;
      mbar_wait(empty_bar + 8 * stage, phase ^ 1);
      const uint32_t fb = full_bar + 8 * stage;
      const uint32_t dst = base + Pl::kStage0 + stage * Pl::kStage;
      mbar_arrive_expect_tx(fb, kBox * (N / 64 + nt) + 8 * L);
#pragma unroll
      for (int cc = 0; cc < N / 64; ++cc)
        tma_load_4d(dst + cc * kBox, &ts, fb, 64 * cc, 0, h, b * nc + c);
      for (int t = 0; t < nt; ++t)
        tma_load_4d(dst + Pl::kX + t * kBox, &tx, fb, 0, h, t0 + t * kT, b);
      bulk_load(dst + Pl::kMeta,
                meta + (((int64_t)b * nc + c) * H + h) * 2 * L, 8 * L, fb);
      if (++stage == kHeadStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // ---- consumers: accumulator element i is row r0 + 8 * (i % 4 / 2),
  // column 8 * (i / 4) + c0 + i % 2 of a 64 x 64 tile ----
  const int r0 = warp * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  const uint32_t c_addr = base + Pl::kC;

  // C_strip . B^T per column tile (K = N, both K-major)
  float cb[kMaxTiles][32];
  mbar_wait(cb_bar, 0);
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < kMaxTiles; ++t) {
    if (t >= nt) break;
    const uint32_t b_addr = base + Pl::kB + t * (N / 64) * kBox;
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
      wgmma_ss_m64n64k16(cb[t], smem_desc(c_addr + off, 16, 1024),
                         smem_desc(b_addr + off, 16, 1024), kk > 0);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int t = 0; t < kMaxTiles; ++t) fence_regs<32>(cb[t]);

  int stage = 0;
  uint32_t phase = 0;
  for (int k = 0; k < nh; ++k) {
    const int h = hfirst + k;
    mbar_wait(full_bar + 8 * stage, phase);
    const uint32_t st = base + Pl::kStage0 + stage * Pl::kStage;
    const float* dac = reinterpret_cast<const float*>(
        sm + Pl::kStage0 + stage * Pl::kStage + Pl::kMeta);
    const float* dts = dac + L;

    // carried term: C_strip . state^T (the state [P][N] is K-major B)
    float acc[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
      wgmma_ss_m64n64k16(acc, smem_desc(c_addr + off, 16, 1024),
                         smem_desc(st + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(acc);
    float di[2];   // this thread's rows' dacum (log2 units after the scale)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) di[hr] = dac[i0 + r0 + 8 * hr];
    const float g0 = expf(di[0]), g1 = expf(di[1]);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] *= (i % 4) / 2 ? g1 : g0;
    di[0] *= kLog2e;
    di[1] *= kLog2e;

    // intra-chunk term: W . x over the column tiles up to the diagonal
#pragma unroll
    for (int t = 0; t < kMaxTiles; ++t) {
      if (t >= nt) break;
      const bool diag = t == s;
      // this thread's 16 columns j = t * 64 + 8 * jj + c0 + e: their
      // dacum (log2 units) and dt, read once for both rows
      float dj[16], dtj[16];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = t * kT + 8 * jj + c0;
        const float2 d = *reinterpret_cast<const float2*>(dac + j);
        const float2 g = *reinterpret_cast<const float2*>(dts + j);
        dj[2 * jj] = d.x * kLog2e;
        dj[2 * jj + 1] = d.y * kLog2e;
        dtj[2 * jj] = g.x;
        dtj[2 * jj + 1] = g.y;
      }
      uint32_t w[16];
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int hr = q % 2;
        const int i = r0 + 8 * hr;          // row and column in the tiles
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int jj = 2 * (q / 2) + e;
          const int j = 8 * (q / 2) + c0 + e;
          v[e] = !diag || j <= i
                     ? cb[t][2 * q + e] * ex2(di[hr] - dj[jj]) * dtj[jj]
                     : 0.f;
        }
        w[q] = pack_bf16(v[0], v[1]);
      }
      const uint32_t x_addr = st + Pl::kX + t * kBox;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk)
        wgmma_rs_m64n64k16(acc, w + 4 * kk,
                           smem_desc(x_addr + kk * 16 * kRow, kBox, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<32>(acc);
      fence_regs<16>(w);
    }
    mbar_arrive(empty_bar + 8 * stage);
    if (++stage == kHeadStages) {
      stage = 0;
      phase ^= 1;
    }

    // y rounded once to bf16 into one of two boxes, out by TMA
    uint8_t* ybox = sm + Pl::kY + (k % 2) * kBox;
    if (tid == 0) bulk_wait_read<1>();   // head k - 2's box is read
    named_bar_sync(1, kConsumers);
    frag_to_box(ybox, acc, r0, c0);
    fence_proxy_async();
    named_bar_sync(1, kConsumers);
    if (tid == 0) {
      tma_store_4d(&ty, smem_u32(ybox), 0, h, t0 + i0, b);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait_read<0>();
}

// -- host side ------------------------------------------------------------------

template <typename K>
int opt_in(K kernel, int bytes) {
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// [B, nc, H, P, N] bf16 entering states: boxes of [P][64]
inline int make_state_map(CUtensorMap* map, const void* states, int B,
                          int nc, int H, int N) {
  const long long dims[4] = {N, kP, H, (long long)B * nc};
  const long long strides[3] = {N, (long long)kP * N, (long long)H * kP * N};
  const int box[4] = {64, kP, 1, 1};
  return make_map_4d(map, states, dims, strides, box);
}

template <int N>
int launch_state(const void* x, const void* dt, const void* a,
                 const void* bm, const void* h0, void* states, void* meta,
                 void* hout, int B, int S, int H, int L,
                 cudaStream_t stream) {
  CUtensorMap tx, tb, ts;
  int err = make_map(&tx, x, B, S, H, kP, kT);
  if (!err) err = make_map(&tb, bm, B, S, 1, N, kT);
  if (!err) err = make_state_map(&ts, states, B, S / L, H, N);
  if (err) return err;
  auto kernel = ssd_state_kernel<N>;
  static bool configured = false;  // one opt-in per instantiation
  if (!configured) {
    if ((err = opt_in(kernel, StatePlan::kAlloc))) return err;
    configured = true;
  }
  kernel<<<(unsigned)(B * H * (N / 64)), kThreads, StatePlan::kAlloc,
           stream>>>(
      tx, tb, ts, static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const float*>(h0), static_cast<float*>(meta),
      static_cast<float*>(hout), S, H, L);
  return (int)cudaGetLastError();
}

template <int N>
int launch_chunk(const void* x, const void* bm, const void* cm,
                 const void* states, const void* meta, void* y, int B, int S,
                 int H, int L, cudaStream_t stream) {
  const int nc = S / L;
  CUtensorMap tx, tb, tcm, ts, ty;
  int err = make_map(&tx, x, B, S, H, kP, kT);
  if (!err) err = make_map(&tb, bm, B, S, 1, N, kT);
  if (!err) err = make_map(&tcm, cm, B, S, 1, N, kT);
  if (!err) err = make_state_map(&ts, states, B, nc, H, N);
  if (!err) err = make_map(&ty, y, B, S, H, kP, kT);
  if (err) return err;
  auto kernel = ssd_chunk_kernel<N>;
  static bool configured = false;
  if (!configured) {
    if ((err = opt_in(kernel, ChunkPlan<N>::kAlloc))) return err;
    configured = true;
  }
  const long long blocks = (long long)(L / kT) * B * nc *
                           ((H + kHeadGroup - 1) / kHeadGroup);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, ChunkPlan<N>::kAlloc, stream>>>(
      tx, tb, tcm, ts, ty, static_cast<const float*>(meta), B, S, H, L);
  return (int)cudaGetLastError();
}

}  // namespace tc
}  // namespace ssd
