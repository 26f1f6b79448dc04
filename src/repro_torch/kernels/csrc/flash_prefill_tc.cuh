// The tensor-core prefill variant (prefill_tc): bf16, (Dk, Dv) in {(64, 64),
// (80, 80), (128, 128), (192, 128)}, more than 64 query rows per kv head.  See
// flash_attention.cu for the design notes; this file holds the kernel and
// its launch.  The PTX wrappers (mbarrier, TMA, descriptors, wgmma) and the
// tensor-map builder are in hopper_ptx.cuh.
#pragma once

#include "flash_common.cuh"
#include "hopper_ptx.cuh"

namespace flash {
namespace prefill_tc {

using namespace ::hopper;

constexpr int kBM = 128;              // q rows per block: two warpgroups of 64
constexpr int kBN = 128;              // keys per kv tile (S is m64n128)
constexpr int kStages = 2;            // K/V ring depth
constexpr int kConsumers = 256;       // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // plus a producer warpgroup
constexpr int kProducerRegs = 56;     // setmaxnreg: registers move from the
constexpr int kConsumerRegs = 224;    // producer warpgroup to the consumers
constexpr int kSwizzleRow = 128;      // bytes of one swizzled smem row (64 bf16)
constexpr float kLog2e = 1.4426950408889634f;

// A head dim D is stored and computed at its panel width, D rounded up to
// 64 columns: TMA reads the columns past D, outside the tensor, as zeros.
constexpr int panel_width(int d) { return (d + 63) / 64 * 64; }

// Shared-memory plan, byte offsets from a 1024-aligned base (the 128-byte
// swizzle repeats every 8 rows = 1024 bytes; TMA and wgmma both assume it).
// A [rows][D] bf16 tile is stored as panel_width(D) / 64 column boxes of
// [rows][64], each swizzled, one after the other.  Q and K tiles are DK's
// panel width wide, V tiles DV's.  At (192, 128): Q 48 KB, K 2 x 48 KB, V
// 2 x 32 KB, 208 KB of tiles; (80, 80) takes (128, 128)'s plan.
template <int DK, int DV>
struct Plan {
  // TMA: a row of D bf16 is a multiple of 16 bytes
  static_assert(DK % 8 == 0 && DV % 8 == 0, "rows of whole 16-byte units");
  static constexpr int kPDK = panel_width(DK);
  static constexpr int kPDV = panel_width(DV);
  static constexpr int kQBytes = kBM * kPDK * 2;
  static constexpr int kKTileBytes = kBN * kPDK * 2;        // one K tile
  static constexpr int kVTileBytes = kBN * kPDV * 2;        // one V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;                    // [kStages] tiles
  static constexpr int kV = kK + kStages * kKTileBytes;      // [kStages] tiles
  static constexpr int kKpos = kV + kStages * kVTileBytes;   // int [kStages][kBN]
  static constexpr int kMeta = kKpos + kStages * kBN * 4;    // int [kStages][2]
  static constexpr int kBar = kMeta + kStages * 8;           // u64 barriers
  static constexpr int kBytes = kBar + (2 * kStages + 1) * 8;
  static constexpr int kAlloc = kBytes + 1024;               // alignment slack
  static_assert(kAlloc <= 232448, "227 KB of shared memory a block");
};

// Tile flags the producer hands the consumers, per warpgroup g: some key
// is hidden from some row (run the per-element mask), or every key is
// hidden from every row (skip the tile).
constexpr int kMaskBit = 1;    // << g
constexpr int kSkipBit = 4;    // << g

// Grid: one block per (b, q head, 128-row q tile), q heads fastest (a GQA
// group's blocks read the same K/V, from L2), q tiles from the last (the
// longest under a causal mask) to the first.  Block: warps 0-7 are two
// consumer warpgroups of 64 rows each; of the third warpgroup, which hands
// its registers to them, warp 8 is the producer and warps 9-11 exit.
template <int DK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
prefill_tc_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const int32_t* __restrict__ qpos,
                  const int32_t* __restrict__ kpos,
                  __nv_bfloat16* __restrict__ out, int B, int Sq, int Skv,
                  int Hq, int Hkv, float scale, float softcap, int causal,
                  int window) {
  using P = Plan<DK, DV>;
  constexpr int kKeysPerLane = kBN / 32;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw);
  int* kpos_s = reinterpret_cast<int*>(sm + P::kKpos);
  int* meta = reinterpret_cast<int*>(sm + P::kMeta);   // [stage]: k0, flags
  const uint32_t full_bar = base + P::kBar;              // [kStages]
  const uint32_t empty_bar = full_bar + 8 * kStages;     // [kStages]
  const uint32_t q_bar = empty_bar + 8 * kStages;

  const int n_qt = (Sq + kBM - 1) / kBM;
  int id = blockIdx.x;
  const int h = id % Hq;
  id /= Hq;
  const int b = id % B;
  const int q0 = (n_qt - 1 - id / B) * kBM;
  const int hk = h / (Hq / Hkv);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + 8 * s, 32);          // the producer warp's lanes
      mbar_init(empty_bar + 8 * s, kConsumers); // every consumer thread
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp > kConsumers / 32) return;
    // ---- producer: decide each kv tile from its positions, then TMA ----
    // q positions: min and max over the valid rows of each warpgroup
    int qmin[2] = {INT_MAX, INT_MAX}, qmax[2] = {INT_MIN, INT_MIN};
#pragma unroll
    for (int i = 0; i < kBM / 32; ++i) {
      const int r = i * 32 + lane;   // warpgroup i / 2's row
      if (q0 + r < Sq) {
        const int p = qpos[(int64_t)b * Sq + q0 + r];
        qmin[i / 2] = min(qmin[i / 2], p);
        qmax[i / 2] = max(qmax[i / 2], p);
      }
    }
    // a valid key at position p is seen by some row of warpgroup g iff
    // some_lo[g] <= p <= some_hi[g], and by every row iff all_lo[g] <= p
    // <= all_hi[g]
    int some_lo[2], some_hi[2], all_lo[2], all_hi[2];
#pragma unroll
    for (int g = 0; g < 2; ++g) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        qmin[g] = min(qmin[g], __shfl_xor_sync(0xffffffffu, qmin[g], off));
        qmax[g] = max(qmax[g], __shfl_xor_sync(0xffffffffu, qmax[g], off));
      }
      some_hi[g] = causal ? qmax[g] : INT_MAX;
      all_hi[g] = causal ? qmin[g] : INT_MAX;
      some_lo[g] = window > 0 ? (int)max((long long)qmin[g] - window + 1,
                                         (long long)INT_MIN)
                              : INT_MIN;
      all_lo[g] = window > 0 ? (int)max((long long)qmax[g] - window + 1,
                                        (long long)INT_MIN)
                             : INT_MIN;
    }
    if (lane == 0) {
      // a box's bytes count whole, the zeros past D included
      mbar_arrive_expect_tx(q_bar, P::kQBytes);
#pragma unroll
      for (int c = 0; c < P::kPDK / 64; ++c)
        tma_load_4d(base + P::kQ + c * kBM * kSwizzleRow, &tq, q_bar, 64 * c,
                    h, q0, b);
    }
    // this lane's keys of tile k0: k0 + lane + 32 e
    auto load_pos = [&](int k0, int* kp) {
#pragma unroll
      for (int e = 0; e < kKeysPerLane; ++e) {
        const int j = k0 + lane + 32 * e;
        kp[e] = j < Skv ? kpos[(int64_t)b * Skv + j] : kValidPosLimit;
      }
    };
    int kp[kKeysPerLane], kp_next[kKeysPerLane];
    load_pos(0, kp_next);
    int stage = 0;
    uint32_t phase = 0;
    for (int k0 = 0; k0 < Skv; k0 += kBN) {
#pragma unroll
      for (int e = 0; e < kKeysPerLane; ++e) kp[e] = kp_next[e];
      load_pos(k0 + kBN, kp_next);   // in flight while this tile is decided
      // per warpgroup: some row sees some key / every row sees every key
      bool seen[2] = {false, false}, whole[2] = {true, true};
#pragma unroll
      for (int e = 0; e < kKeysPerLane; ++e) {
        const int p = kp[e];
        const bool valid = k0 + lane + 32 * e < Skv && p < kValidPosLimit;
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          seen[g] = seen[g] || (valid && p >= some_lo[g] && p <= some_hi[g]);
          whole[g] = whole[g] && valid && p >= all_lo[g] && p <= all_hi[g];
        }
      }
      int flags = 0;
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        if (!__any_sync(0xffffffffu, seen[g])) flags |= kSkipBit << g;
        if (!__all_sync(0xffffffffu, whole[g])) flags |= kMaskBit << g;
      }
      const int skip = kSkipBit | (kSkipBit << 1);
      if ((flags & skip) == skip) continue;   // hidden from the block
      mbar_wait(empty_bar + 8 * stage, phase ^ 1);
#pragma unroll
      for (int e = 0; e < kKeysPerLane; ++e)
        kpos_s[stage * kBN + lane + 32 * e] = kp[e];
      if (lane == 0) {
        meta[2 * stage] = k0;
        meta[2 * stage + 1] = flags;
        const uint32_t fb = full_bar + 8 * stage;
        mbar_arrive_expect_tx(fb, P::kKTileBytes + P::kVTileBytes);
        // K and V boxes interleaved while both have one left
#pragma unroll
        for (int c = 0; c < (P::kPDK > P::kPDV ? P::kPDK : P::kPDV) / 64;
             ++c) {
          if (c < P::kPDK / 64)
            tma_load_4d(base + P::kK + stage * P::kKTileBytes +
                            c * kBN * kSwizzleRow,
                        &tk, fb, 64 * c, hk, k0, b);
          if (c < P::kPDV / 64)
            tma_load_4d(base + P::kV + stage * P::kVTileBytes +
                            c * kBN * kSwizzleRow,
                        &tv, fb, 64 * c, hk, k0, b);
        }
      } else {
        mbar_arrive(full_bar + 8 * stage);
      }
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    // end of the sweep: a stage whose k0 is -1
    mbar_wait(empty_bar + 8 * stage, phase ^ 1);
    if (lane == 0) meta[2 * stage] = -1;
    mbar_arrive(full_bar + 8 * stage);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    // ---- consumers: S = Q K^T, online softmax, O += (P_hi + P_lo) V ----
    const int wg = warp / 4;
    const int r0 = wg * 64 + (warp % 4) * 16 + lane / 4;   // +8: second row
    const int c0 = 2 * (lane % 4);
    // row hr sees a valid key at position p iff lo[hr] <= p <= hi[hr]
    int lo[2], hi[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = q0 + r0 + 8 * hr;
      const long long qp = row < Sq ? qpos[(int64_t)b * Sq + row] : 0;
      hi[hr] = causal ? (int)qp : INT_MAX;
      lo[hr] = window > 0 ? (int)max(qp - window + 1, (long long)INT_MIN)
                          : INT_MIN;
    }
    float o[P::kPDV / 2];
#pragma unroll
    for (int i = 0; i < P::kPDV / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    const uint32_t q_addr = base + P::kQ + wg * 64 * kSwizzleRow;

    mbar_wait(q_bar, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (;;) {
      mbar_wait(full_bar + 8 * stage, phase);
      const int k0 = meta[2 * stage];
      if (k0 < 0) break;
      const int flags = meta[2 * stage + 1];
      if (!((flags >> wg) & kSkipBit)) {
        const uint32_t k_addr = base + P::kK + stage * P::kKTileBytes;
        const uint32_t v_addr = base + P::kV + stage * P::kVTileBytes;
        float s[kBN / 2];
        wgmma_fence();
        // ceil(DK / 16) k-steps over the swizzled panels of Q and K (the
        // zero columns past DK are not read)
#pragma unroll
        for (int kk = 0; kk < (DK + 15) / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;   // 16 bf16 along K
          wgmma_ss_m64n128k16(
              s,
              smem_desc(q_addr + (kk / 4) * kBM * kSwizzleRow + off, 16, 1024),
              smem_desc(k_addr + (kk / 4) * kBN * kSwizzleRow + off, 16, 1024),
              kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<kBN / 2>(s);

        // scores: scale, softcap, mask; element i is row r0 + 8 * (i % 4 /
        // 2), key 8 * (i / 4) + c0 + i % 2 of the tile
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i) {
          float x = s[i] * scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          s[i] = x;
        }
        if ((flags >> wg) & kMaskBit) {
          const bool ragged = k0 + kBN > Skv;
#pragma unroll
          for (int j = 0; j < kBN / 8; ++j) {
            const int2 pp = *reinterpret_cast<const int2*>(
                kpos_s + stage * kBN + 8 * j + c0);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int p = e ? pp.y : pp.x;
              const bool in = !ragged || k0 + 8 * j + c0 + e < Skv;
              const bool valid = in && p < kValidPosLimit;
#pragma unroll
              for (int hr = 0; hr < 2; ++hr) {
                const int i = 4 * j + 2 * hr + e;
                const bool ok = valid && p <= hi[hr] && p >= lo[hr];
                // hidden keys take NEG_INF; keys past the end take no part
                s[i] = ok ? s[i] : (in ? kNegInf : -INFINITY);
              }
            }
          }
        }
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i)
          mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], s[i]);
        float alpha[2];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
          mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
          const float m_new = fmaxf(m[hr], mx[hr]);
          alpha[hr] = exp2f((m[hr] - m_new) * kLog2e);
          m[hr] = m_new;
          l[hr] *= alpha[hr];   // this thread's partial row sum
        }
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i) {
          const int hr = (i % 4) / 2;
          s[i] = exp2f((s[i] - m[hr]) * kLog2e);
          l[hr] += s[i];
        }
#pragma unroll
        for (int i = 0; i < P::kPDV / 2; ++i) o[i] *= alpha[(i % 4) / 2];

        // P as bf16 hi + lo in the A-fragment layout: k-step t (keys
        // 16t..16t+15) takes accumulator elements 8t..8t+7, two a register
        uint32_t ph[kBN / 4], pl[kBN / 4];
#pragma unroll
        for (int i = 0; i < kBN / 4; ++i) {
          const float a = s[2 * i], c = s[2 * i + 1];
          const __nv_bfloat162 hv = __floats2bfloat162_rn(a, c);
          ph[i] = *reinterpret_cast<const uint32_t*>(&hv);
          pl[i] = pack_bf16(a - __low2float(hv), c - __high2float(hv));
        }
        wgmma_fence();
#pragma unroll
        for (int t = 0; t < kBN / 16; ++t)
          wgmma_rs<P::kPDV>(o, ph + 4 * t,
                       smem_desc(v_addr + t * 16 * kSwizzleRow,
                                 kBN * kSwizzleRow, 1024));
#pragma unroll
        for (int t = 0; t < kBN / 16; ++t)
          wgmma_rs<P::kPDV>(o, pl + 4 * t,
                       smem_desc(v_addr + t * 16 * kSwizzleRow,
                                 kBN * kSwizzleRow, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<P::kPDV / 2>(o);
        fence_regs<kBN / 4>(ph);
        fence_regs<kBN / 4>(pl);
      }
      mbar_arrive(empty_bar + 8 * stage);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    // epilogue: the row sums over the four lanes of a row, acc / l in fp32,
    // rounded once to bf16; the DV columns of the tensor, not the panels
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
      l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = q0 + r0 + 8 * hr;
      if (row >= Sq) continue;
      const float safe = l[hr] > 0.f ? l[hr] : 1.f;
      __nv_bfloat16* orow = out + ((int64_t)b * Sq + row) * Hq * DV +
                            (int64_t)h * DV;
#pragma unroll
      for (int j = 0; j < DV / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + c0) =
            __floats2bfloat162_rn(o[4 * j + 2 * hr] / safe,
                                  o[4 * j + 2 * hr + 1] / safe);
    }
  }
}

// -- host side ------------------------------------------------------------------

template <int DK, int DV>
int launch(const void* q, const void* k, const void* v, const void* qpos,
           const void* kpos, void* out, int B, int Sq, int Skv, int Hq,
           int Hkv, float scale, float softcap, int causal, int window,
           cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, B, Sq, Hq, DK, kBM);
  if (!err) err = make_map(&tk, k, B, Skv, Hkv, DK, kBN);
  if (!err) err = make_map(&tv, v, B, Skv, Hkv, DV, kBN);
  if (err) return err;
  auto kernel = prefill_tc_kernel<DK, DV>;
  using P = Plan<DK, DV>;
  static bool configured = false;  // one opt-in per instantiation
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kAlloc);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const long long blocks = (long long)((Sq + kBM - 1) / kBM) * Hq * B;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, P::kAlloc, stream>>>(
      tq, tk, tv, static_cast<const int32_t*>(qpos),
      static_cast<const int32_t*>(kpos), static_cast<__nv_bfloat16*>(out), B,
      Sq, Skv, Hq, Hkv, scale, softcap, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace prefill_tc
}  // namespace flash
