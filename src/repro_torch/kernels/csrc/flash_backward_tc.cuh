// The tensor-core flash backward (tc): bf16, (Dk, Dv) in {(64, 64), (80,
// 80), (128, 128), (192, 128)}, more than 64 query rows per kv head.
// FlashAttention-2's backward (Dao, arXiv:2307.08691, section 3.2) on
// Hopper; see flash_attention.cu for the design notes.  Kernels:
//
// dkdv_tc: one block per (64-key tile, b, kv head, share of the GQA group),
//   key tiles slowest (under a causal mask the first tiles see the most
//   rows, so they start first).  K and V arrive once by TMA; a producer warp
//   walks the q tiles (64 rows) of the share's q heads, skips a tile whose
//   positions hide every key of the block from every row, and feeds Q, dO
//   and the rows' lse, D and positions into a 2-stage ring.  One consumer
//   warpgroup computes S^T = K Q^T and dP^T = V dO^T on wgmma (both
//   operands K-major in shared memory), forms P^T = exp(S^T - lse) and dS^T
//   = P^T (dP^T - D) (times 1 - tanh^2 under a softcap) in fp32 on the
//   accumulator fragment, rounds them once to bf16 as register A operands,
//   and accumulates dV += P^T dO and dK += dS^T Q in fp32 registers
//   (register-A wgmma, dO and Q MN-major).  With one share the block
//   writes dK scale and dV rounded once; with several, fp32 partials that
//   reduce_tc sums over the shares in order and rounds once (no atomics).
// dkdv_tc2: dkdv_tc for a pair whose dK and dV do not fit one warpgroup's
//   registers beside S and dP (MLA's (192, 128): 96 + 64 + 32 + 32 fp32 a
//   thread).  The same grid, producer and roundings over a 3-stage ring;
//   two consumer warpgroups share each q tile.  A computes S^T = K Q^T and
//   P^T, and dV += P^T dO; B computes dP^T = V dO^T, dS^T and dK += dS^T Q
//   (64 x 64 x 320 of products each).  A hands B the tile's P^T (times 1 -
//   tanh^2 under a softcap) in one of two fp32 buffers of shared memory:
//   the two warpgroups' m64n64 fragments give a thread index the same
//   (row, column)s, so B reads, element for element, what A's thread of
//   the same index wrote.  A "P full" and a "P empty" barrier per buffer
//   let A run up to two tiles ahead of B; all 256 consumers release a ring
//   stage.
// dq_tc: one block per (64-row q tile, b, q head), the longest causal
//   tiles first.  Q and dO once, a ring of 64-key K/V tiles (skipped and
//   flagged as prefill_tc does); S = Q K^T and dP = dO V^T on wgmma, dS in
//   fp32, rounded once to bf16, dQ += dS K (register-A wgmma, K MN-major),
//   scaled and rounded once.
//
// A head dim that is not a multiple of 64 is stored and computed at its
// 64-column panel width, as prefill_tc does: TMA fills the columns past it
// with zeros, S and dP take ceil(D / 16) k-steps, the accumulators run at
// the panel width and the epilogue stores the real columns.
#pragma once

#include "flash_backward.cuh"
#include "flash_common.cuh"
#include "flash_prefill_tc.cuh"
#include "hopper_ptx.cuh"

namespace flash {
namespace backward_tc {

using namespace ::hopper;

constexpr int kT = 64;                     // keys of a dkdv block; q tile rows
constexpr int kStages = 2;                 // ring depth
constexpr int kConsumers = 128;            // one warpgroup
constexpr int kThreads = kConsumers + 32;  // plus a producer warp
constexpr int kBox = kBox64;               // one [64][64] bf16 box: 8 KB
constexpr int kTargetBlocks = 264;         // two waves of 132 SMs
constexpr int kWideStages = 3;             // dkdv_tc2's ring depth
constexpr int kWideThreads = 2 * kConsumers + 32;   // dkdv_tc2: two groups
using prefill_tc::kLog2e;
using prefill_tc::panel_width;

// Tile flags the producer hands the consumers.
constexpr int kMaskBit = 1;   // some pair of the tile is hidden: mask each

// Shared-memory plan of the kernels, byte offsets from a 1024-aligned
// base.  A [64][D] bf16 tile is panel_width(D) / 64 boxes of [64][64], each
// swizzled.  Fixed: the block's own tiles (dkdv: K, V; dq: Q, dO), then
// PBUFS fp32 P^T tiles (dkdv_tc2's hand-over, 16 KB each); per ring stage
// (STAGES of them): the streamed tiles (dkdv: Q, dO; dq: K, V) and 64 rows'
// (dkdv) or keys' (dq) side data.  At (128, 128): 32 KB fixed + 2 x 33 KB;
// dkdv_tc2 at (192, 128): 40 + 32 KB fixed + 3 x 41 KB.
template <int DK, int DV, int STAGES = kStages, int PBUFS = 0>
struct Plan {
  static_assert(DK % 8 == 0 && DV % 8 == 0, "rows of whole 16-byte units");
  static constexpr int kRing = STAGES;
  static constexpr int kPDK = panel_width(DK);
  static constexpr int kPDV = panel_width(DV);
  static constexpr int kKBytes = kPDK / 64 * kBox;   // a [64][DK] tile
  static constexpr int kVBytes = kPDV / 64 * kBox;   // a [64][DV] tile
  static constexpr int kFixK = 0;                     // K (dkdv) or Q (dq)
  static constexpr int kFixV = kKBytes;               // V (dkdv) or dO (dq)
  static constexpr int kPBuf = 32 * kConsumers * 4;   // an fp32 [64][64] tile
  static constexpr int kP0 = kFixV + kVBytes;
  static constexpr int kStage0 = kP0 + PBUFS * kPBuf;
  // a stage: the DK-wide tile, the DV-wide tile, then 3 x 64 words of side
  // data (dkdv: lse, D, q positions; dq: key positions)
  static constexpr int kSide = kKBytes + kVBytes;
  static constexpr int kStage = (kSide + 3 * kT * 4 + 1023) / 1024 * 1024;
  static constexpr int kMeta = kStage0 + STAGES * kStage;   // int [STAGES][4]
  static constexpr int kBar = kMeta + STAGES * 16;          // u64 barriers
  static constexpr int kBytes = kBar + (2 * STAGES + 1 + 2 * PBUFS) * 8;
  static constexpr int kAlloc = kBytes + 1024;
  static_assert(kAlloc <= 232448, "227 KB of shared memory a block");
};

// dkdv_tc2 where one warpgroup cannot hold dK and dV (fp32, at their panel
// widths) beside S and dP: past 64 + 64 registers a thread
template <int DK, int DV>
constexpr bool two_groups() {
  return (panel_width(DK) + panel_width(DV)) / 2 > 128;
}

// 2^x by the SFU
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One score's P from its raw product q.k, and in dcap 1 - tanh^2 under a
// softcap (1 otherwise); lse is +inf on rows past Sq (P = 0 there).
__device__ __forceinline__ float p_and_dcap(float qk, float lse_l2,
                                            float scale, float softcap,
                                            bool vis, float* dcap) {
  float x;
  *dcap = 1.f;
  if (softcap > 0.f) {
    const float t = tanhf(qk * scale / softcap);
    x = softcap * t * kLog2e;
    *dcap = 1.f - t * t;
  } else {
    x = qk * scale * kLog2e;
  }
  return vis ? ex2(x - lse_l2) : 0.f;
}

// One score's P and dS from its raw products q.k and dO.v
__device__ __forceinline__ void p_ds(float qk, float dov, float lse_l2,
                                     float delta, float scale, float softcap,
                                     bool vis, float* p, float* ds) {
  float dcap;
  const float pv = p_and_dcap(qk, lse_l2, scale, softcap, vis, &dcap);
  *p = pv;
  *ds = pv * (dov - delta) * dcap;
}

// dkdv_tc's and dkdv_tc2's producer warp: K and V of the block's keys
// once; then, over the share's q heads and q tiles, each tile that some key
// of the block is visible to (flagged where some pair is hidden) with its
// rows' lse, D and positions into P's ring; then an end stage whose q0 is
// -1.
template <class P>
__device__ __forceinline__ void dkdv_producer(
    uint8_t* sm, uint32_t base, int* meta, uint32_t full_bar,
    uint32_t empty_bar, uint32_t kv_bar, const CUtensorMap* tq,
    const CUtensorMap* tk, const CUtensorMap* tv, const CUtensorMap* tdo,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int32_t* __restrict__ qpos, const int32_t* __restrict__ kpos,
    int lane, int b, int hk, int k0, int h_first, int nh, int n_qt, int Sq,
    int Skv, int Hq, int causal, int window) {
  // the block's keys: two a lane; the range of the valid ones
  int kmin = INT_MAX, kmax = INT_MIN;
  bool all_valid = true;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int j = k0 + lane + 32 * e;
    const int p = j < Skv ? kpos[(int64_t)b * Skv + j] : kValidPosLimit;
    const bool valid = p < kValidPosLimit;
    all_valid = all_valid && valid;
    if (valid) {
      kmin = min(kmin, p);
      kmax = max(kmax, p);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    kmin = min(kmin, __shfl_xor_sync(0xffffffffu, kmin, off));
    kmax = max(kmax, __shfl_xor_sync(0xffffffffu, kmax, off));
  }
  all_valid = __all_sync(0xffffffffu, all_valid);
  const bool any_valid = kmin <= kmax;
  if (lane == 0) {
    mbar_arrive_expect_tx(kv_bar, P::kKBytes + P::kVBytes);
#pragma unroll
    for (int c = 0; c < P::kPDK / 64; ++c)
      tma_load_4d(base + P::kFixK + c * kBox, tk, kv_bar, 64 * c, hk, k0,
                  b);
#pragma unroll
    for (int c = 0; c < P::kPDV / 64; ++c)
      tma_load_4d(base + P::kFixV + c * kBox, tv, kv_bar, 64 * c, hk, k0,
                  b);
  }
  int stage = 0;
  uint32_t phase = 0;
  for (int hh = 0; hh < nh && any_valid; ++hh) {
    const int h = h_first + hh;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int q0 = qt * kT;
      int qp[2];
      int qmin = INT_MAX, qmax = INT_MIN;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = q0 + lane + 32 * e;
        qp[e] = r < Sq ? qpos[(int64_t)b * Sq + r] : 0;
        if (r < Sq) {
          qmin = min(qmin, qp[e]);
          qmax = max(qmax, qp[e]);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        qmin = min(qmin, __shfl_xor_sync(0xffffffffu, qmin, off));
        qmax = max(qmax, __shfl_xor_sync(0xffffffffu, qmax, off));
      }
      // no pair of the tile is visible: skip; every pair is: no mask
      const bool none =
          (causal && kmin > qmax) ||
          (window > 0 && (long long)kmax <= (long long)qmin - window);
      if (none) continue;
      const bool whole =
          all_valid && (!causal || kmax <= qmin) &&
          (window <= 0 || (long long)kmin > (long long)qmax - window);
      mbar_wait(empty_bar + 8 * stage, phase ^ 1);
      uint8_t* st = sm + P::kStage0 + stage * P::kStage;
      float* lse_s = reinterpret_cast<float*>(st + P::kSide);
      float* del_s = lse_s + kT;
      int* qp_s = reinterpret_cast<int*>(del_s + kT);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = lane + 32 * e;
        const int r = q0 + i;
        const int64_t at = ((int64_t)b * Sq + r) * Hq + h;
        lse_s[i] = r < Sq ? lse[at] * kLog2e : INFINITY;
        del_s[i] = r < Sq ? delta[at] : 0.f;
        qp_s[i] = qp[e];
      }
      if (lane == 0) {
        meta[4 * stage] = q0;
        meta[4 * stage + 1] = h;
        meta[4 * stage + 2] = whole ? 0 : kMaskBit;
        const uint32_t fb = full_bar + 8 * stage;
        const uint32_t dst = base + P::kStage0 + stage * P::kStage;
        mbar_arrive_expect_tx(fb, P::kKBytes + P::kVBytes);
#pragma unroll
        for (int c = 0; c < P::kPDK / 64; ++c)
          tma_load_4d(dst + c * kBox, tq, fb, 64 * c, h, q0, b);
#pragma unroll
        for (int c = 0; c < P::kPDV / 64; ++c)
          tma_load_4d(dst + P::kKBytes + c * kBox, tdo, fb, 64 * c, h, q0,
                      b);
      } else {
        mbar_arrive(full_bar + 8 * stage);
      }
      if (++stage == P::kRing) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
  // end of the sweep: a stage whose q0 is -1
  mbar_wait(empty_bar + 8 * stage, phase ^ 1);
  if (lane == 0) meta[4 * stage] = -1;
  mbar_arrive(full_bar + 8 * stage);
}

// Grid: blockIdx.x = ((kt * B + b) * Hkv + hk) * splits + s.
template <int DK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_tc_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap tdo,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const int32_t* __restrict__ qpos,
               const int32_t* __restrict__ kpos,
               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
               float* __restrict__ part_k, float* __restrict__ part_v, int B,
               int Sq, int Skv, int Hq, int Hkv, int splits, int per_split,
               float scale, float softcap, int causal, int window) {
  using P = Plan<DK, DV>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw);
  int* meta = reinterpret_cast<int*>(sm + P::kMeta);   // [stage]: q0, h, flags
  const uint32_t full_bar = base + P::kBar;
  const uint32_t empty_bar = full_bar + 8 * kStages;
  const uint32_t kv_bar = empty_bar + 8 * kStages;

  int id = blockIdx.x;
  const int split = id % splits;
  id /= splits;
  const int hk = id % Hkv;
  id /= Hkv;
  const int b = id % B;
  const int k0 = (id / B) * kT;
  const int group = Hq / Hkv;
  const int h_first = hk * group + split * per_split;
  const int nh = min(per_split, group - split * per_split);
  const int n_qt = (Sq + kT - 1) / kT;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + 8 * s, 32);
      mbar_init(empty_bar + 8 * s, kConsumers);
    }
    mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    dkdv_producer<P>(sm, base, meta, full_bar, empty_bar, kv_bar, &tq, &tk,
                     &tv, &tdo, lse, delta, qpos, kpos, lane, b, hk, k0,
                     h_first, nh, n_qt, Sq, Skv, Hq, causal, window);
    return;
  }

  // ---- consumers: accumulator element i is key row r0 + 8 * (i % 4 / 2),
  // column 8 * (i / 4) + c0 + i % 2 (a q row of S^T, a head-dim column of
  // dK and dV) ----
  const int r0 = warp * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  int kp[2];
  bool kvalid[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int j = k0 + r0 + 8 * hr;
    kp[hr] = j < Skv ? kpos[(int64_t)b * Skv + j] : kValidPosLimit;
    kvalid[hr] = kp[hr] < kValidPosLimit;
  }
  float acc_k[P::kPDK / 2], acc_v[P::kPDV / 2];
#pragma unroll
  for (int i = 0; i < P::kPDK / 2; ++i) acc_k[i] = 0.f;
#pragma unroll
  for (int i = 0; i < P::kPDV / 2; ++i) acc_v[i] = 0.f;
  const uint32_t k_addr = base + P::kFixK;
  const uint32_t v_addr = base + P::kFixV;

  mbar_wait(kv_bar, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (;;) {
    mbar_wait(full_bar + 8 * stage, phase);
    if (meta[4 * stage] < 0) break;
    const bool masked = meta[4 * stage + 2] & kMaskBit;
    const uint32_t q_addr = base + P::kStage0 + stage * P::kStage;
    const uint32_t do_addr = q_addr + P::kKBytes;
    const uint8_t* st = sm + P::kStage0 + stage * P::kStage;
    const float* lse_s = reinterpret_cast<const float*>(st + P::kSide);
    const float* del_s = lse_s + kT;
    const int* qp_s = reinterpret_cast<const int*>(del_s + kT);

    float s[32], dp[32];
    wgmma_fence();
    kmajor_64x64<DK>(s, k_addr, q_addr);
    kmajor_64x64<DV>(dp, v_addr, do_addr);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(s);
    fence_regs<32>(dp);

#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + c0;
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + col);
      const float2 d2 = *reinterpret_cast<const float2*>(del_s + col);
      const int2 q2 = *reinterpret_cast<const int2*>(qp_s + col);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int i = 4 * j + 2 * hr + e;
          const bool vis =
              !masked ||
              (kvalid[hr] &&
               backward::visible(e ? q2.y : q2.x, kp[hr], causal, window));
          p_ds(s[i], dp[i], e ? l2.y : l2.x, e ? d2.y : d2.x, scale,
               softcap, vis, &s[i], &dp[i]);
        }
      }
    }
    uint32_t pa[16], da[16];
    pack_frag(s, pa);
    pack_frag(dp, da);
    wgmma_fence();
    rs_64xN<P::kPDV>(acc_v, pa, do_addr);
    rs_64xN<P::kPDK>(acc_k, da, q_addr);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<P::kPDV / 2>(acc_v);
    fence_regs<P::kPDK / 2>(acc_k);
    fence_regs<16>(pa);
    fence_regs<16>(da);
    mbar_arrive(empty_bar + 8 * stage);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  // epilogue: the real rows and columns; bf16 at once with one share,
  // fp32 partials otherwise
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = k0 + r0 + 8 * hr;
    if (key >= Skv) continue;
    const int64_t row = ((int64_t)b * Skv + key) * Hkv + hk;
    if (splits == 1) {
#pragma unroll
      for (int j = 0; j < P::kPDK / 8; ++j)
        if (8 * j + c0 < DK)
          *reinterpret_cast<__nv_bfloat162*>(dk + row * DK + 8 * j + c0) =
              __floats2bfloat162_rn(acc_k[4 * j + 2 * hr] * scale,
                                    acc_k[4 * j + 2 * hr + 1] * scale);
#pragma unroll
      for (int j = 0; j < P::kPDV / 8; ++j)
        if (8 * j + c0 < DV)
          *reinterpret_cast<__nv_bfloat162*>(dv + row * DV + 8 * j + c0) =
              __floats2bfloat162_rn(acc_v[4 * j + 2 * hr],
                                    acc_v[4 * j + 2 * hr + 1]);
    } else {
      const int64_t prow = (int64_t)split * B * Skv * Hkv + row;
#pragma unroll
      for (int j = 0; j < P::kPDK / 8; ++j)
        if (8 * j + c0 < DK)
          *reinterpret_cast<float2*>(part_k + prow * DK + 8 * j + c0) =
              make_float2(acc_k[4 * j + 2 * hr], acc_k[4 * j + 2 * hr + 1]);
#pragma unroll
      for (int j = 0; j < P::kPDV / 8; ++j)
        if (8 * j + c0 < DV)
          *reinterpret_cast<float2*>(part_v + prow * DV + 8 * j + c0) =
              make_float2(acc_v[4 * j + 2 * hr], acc_v[4 * j + 2 * hr + 1]);
    }
  }
}

// dK and dV with two consumer warpgroups (dkdv_tc2 above).  Grid and
// arguments as dkdv_tc_kernel's.
template <int DK, int DV>
__global__ void __launch_bounds__(kWideThreads, 1)
dkdv_tc2_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tdo,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const int32_t* __restrict__ qpos,
                const int32_t* __restrict__ kpos,
                __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                float* __restrict__ part_k, float* __restrict__ part_v, int B,
                int Sq, int Skv, int Hq, int Hkv, int splits, int per_split,
                float scale, float softcap, int causal, int window) {
  using P = Plan<DK, DV, kWideStages, 2>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw);
  int* meta = reinterpret_cast<int*>(sm + P::kMeta);   // [stage]: q0, h, flags
  const uint32_t full_bar = base + P::kBar;
  const uint32_t empty_bar = full_bar + 8 * kWideStages;
  const uint32_t kv_bar = empty_bar + 8 * kWideStages;
  const uint32_t pfull_bar = kv_bar + 8;       // [2]: A wrote the P^T buffer
  const uint32_t pempty_bar = pfull_bar + 16;  // [2]: B read it

  int id = blockIdx.x;
  const int split = id % splits;
  id /= splits;
  const int hk = id % Hkv;
  id /= Hkv;
  const int b = id % B;
  const int k0 = (id / B) * kT;
  const int group = Hq / Hkv;
  const int h_first = hk * group + split * per_split;
  const int nh = min(per_split, group - split * per_split);
  const int n_qt = (Sq + kT - 1) / kT;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  if (tid == 0) {
    for (int s = 0; s < kWideStages; ++s) {
      mbar_init(full_bar + 8 * s, 32);
      mbar_init(empty_bar + 8 * s, 2 * kConsumers);
    }
    mbar_init(kv_bar, 1);
    for (int i = 0; i < 2; ++i) {
      mbar_init(pfull_bar + 8 * i, kConsumers);
      mbar_init(pempty_bar + 8 * i, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 2 * kConsumers / 32) {
    dkdv_producer<P>(sm, base, meta, full_bar, empty_bar, kv_bar, &tq, &tk,
                     &tv, &tdo, lse, delta, qpos, kpos, lane, b, hk, k0,
                     h_first, nh, n_qt, Sq, Skv, Hq, causal, window);
    return;
  }

  // ---- consumers: warpgroup 0 is A (S, P, dV), 1 is B (dP, dS, dK).
  // Element i of a thread's fragment is key row r0 + 8 * (i % 4 / 2), column
  // 8 * (i / 4) + c0 + i % 2 in both; P^T element i of thread t sits in a
  // buffer at float4 [i / 4][t] ----
  const int group_id = tid / kConsumers;
  const int t = tid % kConsumers;
  const int r0 = (t / 32) * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  const uint32_t k_addr = base + P::kFixK;
  const uint32_t v_addr = base + P::kFixV;
  float4* pbufs = reinterpret_cast<float4*>(sm + P::kP0) + t;
  int stage = 0, pb = 0;
  uint32_t phase = 0, pphase = 0;
  mbar_wait(kv_bar, 0);

  if (group_id == 0) {
    int kp[2];
    bool kvalid[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int j = k0 + r0 + 8 * hr;
      kp[hr] = j < Skv ? kpos[(int64_t)b * Skv + j] : kValidPosLimit;
      kvalid[hr] = kp[hr] < kValidPosLimit;
    }
    float acc_v[P::kPDV / 2];
#pragma unroll
    for (int i = 0; i < P::kPDV / 2; ++i) acc_v[i] = 0.f;
    for (;;) {
      mbar_wait(full_bar + 8 * stage, phase);
      if (meta[4 * stage] < 0) break;
      const bool masked = meta[4 * stage + 2] & kMaskBit;
      const uint32_t q_addr = base + P::kStage0 + stage * P::kStage;
      const uint32_t do_addr = q_addr + P::kKBytes;
      const float* lse_s = reinterpret_cast<const float*>(
          sm + P::kStage0 + stage * P::kStage + P::kSide);
      const int* qp_s = reinterpret_cast<const int*>(lse_s + 2 * kT);

      float s[32];
      wgmma_fence();
      kmajor_64x64<DK>(s, k_addr, q_addr);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<32>(s);

      mbar_wait(pempty_bar + 8 * pb, pphase ^ 1);
      float4* out = pbufs + pb * (P::kPBuf / 16);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 8 * j + c0;
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + col);
        const int2 q2 = *reinterpret_cast<const int2*>(qp_s + col);
        float w[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int i = 4 * j + 2 * hr + e;
            const bool vis =
                !masked ||
                (kvalid[hr] &&
                 backward::visible(e ? q2.y : q2.x, kp[hr], causal, window));
            float dcap;
            s[i] = p_and_dcap(s[i], e ? l2.y : l2.x, scale, softcap, vis,
                              &dcap);
            w[2 * hr + e] = s[i] * dcap;
          }
        }
        out[j * kConsumers] = make_float4(w[0], w[1], w[2], w[3]);
      }
      mbar_arrive(pfull_bar + 8 * pb);
      if (++pb == 2) {
        pb = 0;
        pphase ^= 1;
      }
      uint32_t pa[16];
      pack_frag(s, pa);
      wgmma_fence();
      rs_64xN<P::kPDV>(acc_v, pa, do_addr);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<P::kPDV / 2>(acc_v);
      fence_regs<16>(pa);
      mbar_arrive(empty_bar + 8 * stage);
      if (++stage == kWideStages) {
        stage = 0;
        phase ^= 1;
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int key = k0 + r0 + 8 * hr;
      if (key >= Skv) continue;
      const int64_t row = ((int64_t)b * Skv + key) * Hkv + hk;
#pragma unroll
      for (int j = 0; j < P::kPDV / 8; ++j) {
        if (8 * j + c0 >= DV) continue;
        const float x = acc_v[4 * j + 2 * hr], y = acc_v[4 * j + 2 * hr + 1];
        if (splits == 1)
          *reinterpret_cast<__nv_bfloat162*>(dv + row * DV + 8 * j + c0) =
              __floats2bfloat162_rn(x, y);
        else
          *reinterpret_cast<float2*>(
              part_v + ((int64_t)split * B * Skv * Hkv + row) * DV + 8 * j +
              c0) = make_float2(x, y);
      }
    }
    return;
  }

  float acc_k[P::kPDK / 2];
#pragma unroll
  for (int i = 0; i < P::kPDK / 2; ++i) acc_k[i] = 0.f;
  for (;;) {
    mbar_wait(full_bar + 8 * stage, phase);
    if (meta[4 * stage] < 0) break;
    const uint32_t q_addr = base + P::kStage0 + stage * P::kStage;
    const uint32_t do_addr = q_addr + P::kKBytes;
    const float* del_s = reinterpret_cast<const float*>(
                             sm + P::kStage0 + stage * P::kStage + P::kSide) +
                         kT;

    float dp[32];
    wgmma_fence();
    kmajor_64x64<DV>(dp, v_addr, do_addr);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(dp);

    mbar_wait(pfull_bar + 8 * pb, pphase);
    const float4* in = pbufs + pb * (P::kPBuf / 16);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 d2 = *reinterpret_cast<const float2*>(del_s + 8 * j + c0);
      const float4 w = in[j * kConsumers];
      dp[4 * j] = w.x * (dp[4 * j] - d2.x);
      dp[4 * j + 1] = w.y * (dp[4 * j + 1] - d2.y);
      dp[4 * j + 2] = w.z * (dp[4 * j + 2] - d2.x);
      dp[4 * j + 3] = w.w * (dp[4 * j + 3] - d2.y);
    }
    mbar_arrive(pempty_bar + 8 * pb);
    if (++pb == 2) {
      pb = 0;
      pphase ^= 1;
    }
    uint32_t da[16];
    pack_frag(dp, da);
    wgmma_fence();
    rs_64xN<P::kPDK>(acc_k, da, q_addr);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<P::kPDK / 2>(acc_k);
    fence_regs<16>(da);
    mbar_arrive(empty_bar + 8 * stage);
    if (++stage == kWideStages) {
      stage = 0;
      phase ^= 1;
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = k0 + r0 + 8 * hr;
    if (key >= Skv) continue;
    const int64_t row = ((int64_t)b * Skv + key) * Hkv + hk;
#pragma unroll
    for (int j = 0; j < P::kPDK / 8; ++j) {
      if (8 * j + c0 >= DK) continue;
      const float x = acc_k[4 * j + 2 * hr], y = acc_k[4 * j + 2 * hr + 1];
      if (splits == 1)
        *reinterpret_cast<__nv_bfloat162*>(dk + row * DK + 8 * j + c0) =
            __floats2bfloat162_rn(x * scale, y * scale);
      else
        *reinterpret_cast<float2*>(
            part_k + ((int64_t)split * B * Skv * Hkv + row) * DK + 8 * j +
            c0) = make_float2(x, y);
    }
  }
}

// dK = scale * sum_s part_k[s], dV = sum_s part_v[s], shares in order,
// rounded once; one thread per element of dK, then of dV
__global__ void __launch_bounds__(256)
reduce_tc_kernel(const float* __restrict__ part_k,
                 const float* __restrict__ part_v,
                 __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                 int64_t nk, int64_t nv, int splits, float scale) {
  const int64_t id = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (id < nk) {
    float s = 0.f;
    for (int i = 0; i < splits; ++i) s += part_k[i * nk + id];
    dk[id] = __float2bfloat16(s * scale);
  } else if (id < nk + nv) {
    const int64_t j = id - nk;
    float s = 0.f;
    for (int i = 0; i < splits; ++i) s += part_v[i * nv + j];
    dv[j] = __float2bfloat16(s);
  }
}

// Grid: blockIdx.x = ((n_qt - 1 - qt) * B + b) * Hq + h.
template <int DK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
dq_tc_kernel(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             const __grid_constant__ CUtensorMap tdo,
             const float* __restrict__ lse, const float* __restrict__ delta,
             const int32_t* __restrict__ qpos,
             const int32_t* __restrict__ kpos, __nv_bfloat16* __restrict__ dq,
             int B, int Sq, int Skv, int Hq, int Hkv, float scale,
             float softcap, int causal, int window) {
  using P = Plan<DK, DV>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw);
  int* meta = reinterpret_cast<int*>(sm + P::kMeta);   // [stage]: k0, flags
  const uint32_t full_bar = base + P::kBar;
  const uint32_t empty_bar = full_bar + 8 * kStages;
  const uint32_t q_bar = empty_bar + 8 * kStages;

  const int n_qt = (Sq + kT - 1) / kT;
  int id = blockIdx.x;
  const int h = id % Hq;
  id /= Hq;
  const int b = id % B;
  const int q0 = (n_qt - 1 - id / B) * kT;
  const int hk = h / (Hq / Hkv);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + 8 * s, 32);
      mbar_init(empty_bar + 8 * s, kConsumers);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // ---- producer: as prefill_tc's, one warpgroup of 64 rows ----
    int qmin = INT_MAX, qmax = INT_MIN;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = q0 + lane + 32 * e;
      if (r < Sq) {
        const int p = qpos[(int64_t)b * Sq + r];
        qmin = min(qmin, p);
        qmax = max(qmax, p);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      qmin = min(qmin, __shfl_xor_sync(0xffffffffu, qmin, off));
      qmax = max(qmax, __shfl_xor_sync(0xffffffffu, qmax, off));
    }
    // a valid key at p is seen by some row iff some_lo <= p <= some_hi,
    // by every row iff all_lo <= p <= all_hi
    const int some_hi = causal ? qmax : INT_MAX;
    const int all_hi = causal ? qmin : INT_MAX;
    const int some_lo =
        window > 0 ? (int)max((long long)qmin - window + 1, (long long)INT_MIN)
                   : INT_MIN;
    const int all_lo =
        window > 0 ? (int)max((long long)qmax - window + 1, (long long)INT_MIN)
                   : INT_MIN;
    if (lane == 0) {
      mbar_arrive_expect_tx(q_bar, P::kKBytes + P::kVBytes);
#pragma unroll
      for (int c = 0; c < P::kPDK / 64; ++c)
        tma_load_4d(base + P::kFixK + c * kBox, &tq, q_bar, 64 * c, h, q0, b);
#pragma unroll
      for (int c = 0; c < P::kPDV / 64; ++c)
        tma_load_4d(base + P::kFixV + c * kBox, &tdo, q_bar, 64 * c, h, q0,
                    b);
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int k0 = 0; k0 < Skv; k0 += kT) {
      int kp[2];
      bool any = false, every = true;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = k0 + lane + 32 * e;
        kp[e] = j < Skv ? kpos[(int64_t)b * Skv + j] : kValidPosLimit;
        const bool valid = kp[e] < kValidPosLimit;
        any = any || (valid && kp[e] >= some_lo && kp[e] <= some_hi);
        every = every && valid && kp[e] >= all_lo && kp[e] <= all_hi;
      }
      if (!__any_sync(0xffffffffu, any)) continue;
      const bool whole = __all_sync(0xffffffffu, every);
      mbar_wait(empty_bar + 8 * stage, phase ^ 1);
      int* kp_s = reinterpret_cast<int*>(sm + P::kStage0 +
                                         stage * P::kStage + P::kSide);
#pragma unroll
      for (int e = 0; e < 2; ++e) kp_s[lane + 32 * e] = kp[e];
      if (lane == 0) {
        meta[4 * stage] = k0;
        meta[4 * stage + 1] = whole ? 0 : kMaskBit;
        const uint32_t fb = full_bar + 8 * stage;
        const uint32_t dst = base + P::kStage0 + stage * P::kStage;
        mbar_arrive_expect_tx(fb, P::kKBytes + P::kVBytes);
#pragma unroll
        for (int c = 0; c < P::kPDK / 64; ++c)
          tma_load_4d(dst + c * kBox, &tk, fb, 64 * c, hk, k0, b);
#pragma unroll
        for (int c = 0; c < P::kPDV / 64; ++c)
          tma_load_4d(dst + P::kKBytes + c * kBox, &tv, fb, 64 * c, hk, k0,
                      b);
      } else {
        mbar_arrive(full_bar + 8 * stage);
      }
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    mbar_wait(empty_bar + 8 * stage, phase ^ 1);
    if (lane == 0) meta[4 * stage] = -1;
    mbar_arrive(full_bar + 8 * stage);
    return;
  }

  // ---- consumers: element i is q row r0 + 8 * (i % 4 / 2), column 8 * (i
  // / 4) + c0 + i % 2 (a key of S, a head-dim column of dQ) ----
  const int r0 = warp * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  float lse_r[2], del_r[2];
  int qp_r[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = q0 + r0 + 8 * hr;
    const int64_t at = ((int64_t)b * Sq + r) * Hq + h;
    lse_r[hr] = r < Sq ? lse[at] * kLog2e : INFINITY;
    del_r[hr] = r < Sq ? delta[at] : 0.f;
    qp_r[hr] = r < Sq ? qpos[(int64_t)b * Sq + r] : 0;
  }
  float acc[P::kPDK / 2];
#pragma unroll
  for (int i = 0; i < P::kPDK / 2; ++i) acc[i] = 0.f;
  const uint32_t q_addr = base + P::kFixK;
  const uint32_t do_addr = base + P::kFixV;

  mbar_wait(q_bar, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (;;) {
    mbar_wait(full_bar + 8 * stage, phase);
    const int k0 = meta[4 * stage];
    if (k0 < 0) break;
    const bool masked = meta[4 * stage + 1] & kMaskBit;
    const uint32_t k_addr = base + P::kStage0 + stage * P::kStage;
    const uint32_t v_addr = k_addr + P::kKBytes;
    const int* kp_s = reinterpret_cast<const int*>(
        sm + P::kStage0 + stage * P::kStage + P::kSide);

    float s[32], dp[32];
    wgmma_fence();
    kmajor_64x64<DK>(s, q_addr, k_addr);
    kmajor_64x64<DV>(dp, do_addr, v_addr);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(s);
    fence_regs<32>(dp);

#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + c0;
      const int2 k2 = *reinterpret_cast<const int2*>(kp_s + col);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpe = e ? k2.y : k2.x;
        const bool in = k0 + col + e < Skv;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int i = 4 * j + 2 * hr + e;
          const bool vis =
              !masked ||
              (in && backward::visible(qp_r[hr], kpe, causal, window));
          float p;
          p_ds(s[i], dp[i], lse_r[hr], del_r[hr], scale, softcap, vis, &p,
               &dp[i]);
        }
      }
    }
    uint32_t da[16];
    pack_frag(dp, da);
    wgmma_fence();
    rs_64xN<P::kPDK>(acc, da, k_addr);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<P::kPDK / 2>(acc);
    fence_regs<16>(da);
    mbar_arrive(empty_bar + 8 * stage);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = q0 + r0 + 8 * hr;
    if (r >= Sq) continue;
    __nv_bfloat16* row = dq + (((int64_t)b * Sq + r) * Hq + h) * DK;
#pragma unroll
    for (int j = 0; j < P::kPDK / 8; ++j)
      if (8 * j + c0 < DK)
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + c0) =
            __floats2bfloat162_rn(acc[4 * j + 2 * hr] * scale,
                                  acc[4 * j + 2 * hr + 1] * scale);
  }
}

// -- host side ----------------------------------------------------------------

// Shares of a GQA group's q heads over dkdv_tc blocks: one while B x Hkv x
// key tiles fills two waves of the card, else enough to, each share
// ceil(group / shares) heads.  *per_split receives that.
inline int splits_for(int B, int Skv, int Hkv, int group, int* per_split) {
  const long long base = (long long)B * Hkv * ((Skv + kT - 1) / kT);
  int want = base >= kTargetBlocks
                 ? 1
                 : (int)((kTargetBlocks + base - 1) / base);
  want = min(want, group);
  const int per = (group + want - 1) / want;
  *per_split = per;
  return (group + per - 1) / per;
}

// fp32 partials of dK and dV: none with one share
inline long long partial_floats(int B, int Skv, int Hq, int Hkv, int Dk,
                                int Dv) {
  int per;
  const int splits = splits_for(B, Skv, Hkv, Hq / Hkv, &per);
  return splits == 1 ? 0
                     : (long long)splits * B * Skv * Hkv * (Dk + Dv);
}

template <typename K>
int opt_in(K kernel, int bytes, bool* configured) {
  if (*configured) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  *configured = true;
  return 0;
}

// delta: fp32 [B * Sq * Hq]; part: the fp32 partials (partial_floats)
template <int DK, int DV>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const float* lse, const void* qpos,
           const void* kpos, void* dq, void* dk, void* dv, float* delta,
           float* part, int B, int Sq, int Skv, int Hq, int Hkv, float scale,
           float softcap, int causal, int window, cudaStream_t s) {
  using P = Plan<DK, DV>;
  CUtensorMap tq, tk, tv, tdo;
  int err = make_map(&tq, q, B, Sq, Hq, DK, kT);
  if (!err) err = make_map(&tk, k, B, Skv, Hkv, DK, kT);
  if (!err) err = make_map(&tv, v, B, Skv, Hkv, DV, kT);
  if (!err) err = make_map(&tdo, dout, B, Sq, Hq, DV, kT);
  if (err) return err;
  static bool dkdv_ready = false, dq_ready = false;
  using W = Plan<DK, DV, kWideStages, 2>;
  if constexpr (two_groups<DK, DV>())
    err = opt_in(dkdv_tc2_kernel<DK, DV>, W::kAlloc, &dkdv_ready);
  else
    err = opt_in(dkdv_tc_kernel<DK, DV>, P::kAlloc, &dkdv_ready);
  if (err) return err;
  if ((err = opt_in(dq_tc_kernel<DK, DV>, P::kAlloc, &dq_ready))) return err;

  const int64_t rows = (int64_t)B * Sq * Hq;
  const int64_t dblocks = (rows + 7) / 8;
  int per;
  const int splits = splits_for(B, Skv, Hkv, Hq / Hkv, &per);
  const long long kv_blocks =
      (long long)((Skv + kT - 1) / kT) * B * Hkv * splits;
  const long long q_blocks = (long long)((Sq + kT - 1) / kT) * B * Hq;
  if (dblocks > 0x7fffffffLL || kv_blocks > 0x7fffffffLL ||
      q_blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  backward::delta_kernel<__nv_bfloat16><<<(unsigned)dblocks, 256, 0, s>>>(
      static_cast<const __nv_bfloat16*>(out),
      static_cast<const __nv_bfloat16*>(dout), delta, rows, DV);
  if ((err = (int)cudaGetLastError())) return err;
  const int64_t nk = (int64_t)B * Skv * Hkv * DK;
  const int64_t nv = (int64_t)B * Skv * Hkv * DV;
  float* part_k = splits > 1 ? part : nullptr;
  float* part_v = splits > 1 ? part + splits * nk : nullptr;
  if constexpr (two_groups<DK, DV>())
    dkdv_tc2_kernel<DK, DV>
        <<<(unsigned)kv_blocks, kWideThreads, W::kAlloc, s>>>(
            tq, tk, tv, tdo, lse, delta, static_cast<const int32_t*>(qpos),
            static_cast<const int32_t*>(kpos),
            static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
            part_k, part_v, B, Sq, Skv, Hq, Hkv, splits, per, scale, softcap,
            causal, window);
  else
    dkdv_tc_kernel<DK, DV><<<(unsigned)kv_blocks, kThreads, P::kAlloc, s>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<const int32_t*>(qpos),
        static_cast<const int32_t*>(kpos), static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), part_k, part_v, B, Sq, Skv, Hq, Hkv,
        splits, per, scale, softcap, causal, window);
  if ((err = (int)cudaGetLastError())) return err;
  if (splits > 1) {
    const int64_t rblocks = (nk + nv + 255) / 256;
    if (rblocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    reduce_tc_kernel<<<(unsigned)rblocks, 256, 0, s>>>(
        part_k, part_v, static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), nk, nv, splits, scale);
    if ((err = (int)cudaGetLastError())) return err;
  }
  dq_tc_kernel<DK, DV><<<(unsigned)q_blocks, kThreads, P::kAlloc, s>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<const int32_t*>(qpos),
      static_cast<const int32_t*>(kpos), static_cast<__nv_bfloat16*>(dq), B,
      Sq, Skv, Hq, Hkv, scale, softcap, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace backward_tc
}  // namespace flash
