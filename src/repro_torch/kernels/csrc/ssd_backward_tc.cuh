// The tensor-core SSD backward (tc): bf16 x / B / C, P = 64, N in {64, 128},
// the chunk L a multiple of 64 up to 256 -- the forward tc's shapes.  See
// ssd_scan.cu for the design notes; this file holds chunk_tc, phase (iii),
// and the launch of all phases.  For one head and chunk (notation of
// ssd_backward.cuh), with CB = C B^T, M[l, m] = exp(dacum[l] - dacum[m])
// (m <= l), dW = dY X^T and dCB = dW * M * dt[m]:
//   dx[m]  = dt[m] (sum_l (CB * M)[l, m] dY[l] + r[m] (B G^T)[m])
//   dC[l] += sum_m dCB[l, m] B[m] + exp(dacum[l]) dY[l] h_in
//   dB[m] += sum_l dCB[l, m] C[l] + r[m] dt[m] X[m] G
// and the fp32 sums behind d(dacum): rows of dCB * CB, the columns' e[m] =
// sum_l dW * CB * M, f[m] = r[m] X[m] . (B G^T)[m].
#pragma once

#include <math.h>

#include "hopper_ptx.cuh"
#include "ssd_backward.cuh"
#include "ssd_tc.cuh"

namespace ssd {
namespace backward_tc {

using namespace ::hopper;

using ssd::tc::ex2;
using ssd::tc::kBox;       // one [64][64] bf16 box: 8 KB
using ssd::tc::kLog2e;
using ssd::tc::kMaxL;
using ssd::tc::kP;         // head dim
using ssd::tc::kRow;       // bytes of a swizzled row (64 bf16)
using ssd::tc::kT;         // rows of a tile
constexpr int kThreads = 128;              // one warpgroup

// heads of one chunk_tc block: two at N 64 (when H is even), else one
constexpr int heads_per_block(int N, int H) {
  return N == 64 && H % 2 == 0 ? 2 : 1;
}

// Shared-memory plan, byte offsets from a 1024-aligned base.  A "step" is
// one shared [64][N] tile (N / 64 boxes) and the G heads' [64][64] tiles
// of the same rows: pass A's inner steps are (B_J, X_J), its outer ones
// (C_I, dY_I); pass B's the other way round.  A ring of two inner steps,
// one outer step, the heads' [P][N] state tiles (h_in in pass A, the
// leaving state's gradient G in pass B), each head's dacum and dt, and its
// three fp32 row sums.  N 64 with two heads and N 128 with one: 24 KB a
// step, 97 KB in all, so two blocks share an SM.
template <int N, int G>
struct Plan {
  static constexpr int kNB = N / 64;
  static constexpr int kStep = (kNB + G) * kBox;
  static constexpr int kOuter = 2 * kStep;
  static constexpr int kState = kOuter + kStep;
  static constexpr int kMeta = kState + G * kNB * kBox;   // float [G][2 L]
  static constexpr int kSums = kMeta + G * 2 * kMaxL * 4; // float [G][3][kMaxL]
  static constexpr int kRed = kSums + G * 3 * kMaxL * 4;  // float [8]
  static constexpr int kBar = kRed + 32;   // full[2], outer, state, meta
  static constexpr int kBytes = kBar + 5 * 8;
  static constexpr int kAlloc = kBytes + 1024;
  static_assert(kAlloc <= 113 * 1024, "two blocks an SM");
};

template <int NN, int TA, int TB>
__device__ __forceinline__ void ss(float* acc, uint64_t da, uint64_t db,
                                   int scale_d) {
  if constexpr (NN == 128)
    wgmma_ss_m64n128k16<TA, TB>(acc, da, db, scale_d);
  else
    wgmma_ss_m64n64k16<TA, TB>(acc, da, db, scale_d);
}

// acc[64][NN] (+)= A[64][64] (K-major box) . T[64][NN] (MN-major boxes)
template <int NN>
__device__ __forceinline__ void mnprod(float* acc, uint32_t a, uint32_t t,
                                       int accumulate) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ss<NN, 0, 1>(acc, smem_desc(a + kk * 32, 16, 1024),
                 smem_desc(t + kk * 16 * kRow, kBox, 1024),
                 accumulate || kk > 0);
}

// element (r, col) of a [64][*] bf16 tile stored as swizzled 64-column boxes
__device__ __forceinline__ const __nv_bfloat162* at2(const uint8_t* tile,
                                                     int r, int col) {
  return reinterpret_cast<const __nv_bfloat162*>(
      tile + (col / 64) * kBox + r * kRow +
      ((((col % 64) / 8) ^ (r & 7)) << 4) + (col % 8) * 2);
}

// the sum of a row's value over the four lanes that hold it
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// chunk_tc: one block per (b, chunk, G heads).  meta [B, nc, H, 2, L]
// (dacum, dt) and states (bf16 entering states) from ssd_state; gout (fp32
// gradient of the state leaving each chunk).  Writes dx, ddt, the head
// groups' partials dBp / dCp [B, nc, H / G, L, N] and dap [B, nc, H].
template <int N, int G>
__global__ void __launch_bounds__(kThreads, 2)
chunk_tc_kernel(const __grid_constant__ CUtensorMap tx,
                const __grid_constant__ CUtensorMap tdy,
                const __grid_constant__ CUtensorMap tb,
                const __grid_constant__ CUtensorMap tcm,
                const __grid_constant__ CUtensorMap ts,
                const float* __restrict__ meta, const float* __restrict__ a,
                const float* __restrict__ gout,
                __nv_bfloat16* __restrict__ dx, float* __restrict__ ddt,
                float* __restrict__ dBp, float* __restrict__ dCp,
                float* __restrict__ dap, int S, int H, int L) {
  using Pl = Plan<N, G>;
  constexpr int kNB = Pl::kNB;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw);
  const uint32_t full_bar = base + Pl::kBar;
  const uint32_t outer_bar = full_bar + 16;
  const uint32_t state_bar = outer_bar + 8;
  const uint32_t meta_bar = state_bar + 8;
  const float* mt = reinterpret_cast<const float*>(sm + Pl::kMeta);
  float* sums = reinterpret_cast<float*>(sm + Pl::kSums);
  float* red = reinterpret_cast<float*>(sm + Pl::kRed);

  const int nc = S / L;
  const int nhg = H / G;
  const int nT = L / kT;
  int id = blockIdx.x;
  const int hg = id % nhg;
  id /= nhg;
  const int c = id % nc;
  const int b = id / nc;
  const int h0 = hg * G;
  const int t0 = c * L;
  const int n_inner = nT * (nT + 1) / 2;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int r0 = warp * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);

  // inner step k of both passes: pass A's (I, J <= I) I-major loads (B_J,
  // X_J); pass B's (J, I >= J) J-major loads (C_I, dY_I)
  auto issue_inner = [&](int k) {
    const uint32_t fb = full_bar + 8 * (k & 1);
    const uint32_t dst = base + (k & 1) * Pl::kStep;
    const bool pass_a = k < n_inner;
    int s = pass_a ? k : k - n_inner, t = 0;
    if (pass_a) {
      for (int I = 0;; ++I) {
        if (s <= I) { t = s; break; }
        s -= I + 1;
      }
    } else {
      for (int J = 0;; ++J) {
        if (s < nT - J) { t = J + s; break; }
        s -= nT - J;
      }
    }
    const int row = t0 + t * kT;
    mbar_arrive_expect_tx(fb, Pl::kStep);
#pragma unroll
    for (int cc = 0; cc < kNB; ++cc)
      tma_load_4d(dst + cc * kBox, pass_a ? &tb : &tcm, fb, 64 * cc, 0, row,
                  b);
#pragma unroll
    for (int g = 0; g < G; ++g)
      tma_load_4d(dst + (kNB + g) * kBox, pass_a ? &tx : &tdy, fb, 0, h0 + g,
                  row, b);
  };
  // the outer step of tile t: pass A (C_t, dY_t), pass B (B_t, X_t)
  auto issue_outer = [&](bool pass_a, int t) {
    const uint32_t dst = base + Pl::kOuter;
    const int row = t0 + t * kT;
    mbar_arrive_expect_tx(outer_bar, Pl::kStep);
#pragma unroll
    for (int cc = 0; cc < kNB; ++cc)
      tma_load_4d(dst + cc * kBox, pass_a ? &tcm : &tb, outer_bar, 64 * cc, 0,
                  row, b);
#pragma unroll
    for (int g = 0; g < G; ++g)
      tma_load_4d(dst + (kNB + g) * kBox, pass_a ? &tdy : &tx, outer_bar, 0,
                  h0 + g, row, b);
  };

  if (tid == 0) {
    for (int s = 0; s < 2; ++s) mbar_init(full_bar + 8 * s, 1);
    mbar_init(outer_bar, 1);
    mbar_init(state_bar, 1);
    mbar_init(meta_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(meta_bar, G * 8 * L);
    mbar_arrive_expect_tx(state_bar, G * kNB * kBox);
    for (int g = 0; g < G; ++g) {
      const int64_t bch = ((int64_t)b * nc + c) * H + h0 + g;
      bulk_load(base + Pl::kMeta + g * 8 * kMaxL, meta + bch * 2 * L, 8 * L,
                meta_bar);
#pragma unroll
      for (int cc = 0; cc < kNB; ++cc)
        tma_load_4d(base + Pl::kState + (g * kNB + cc) * kBox, &ts, state_bar,
                    64 * cc, 0, h0 + g, b * nc + c);
    }
    issue_outer(true, 0);
    issue_inner(0);
    if (2 * n_inner > 1) issue_inner(1);
  }
  for (int i = tid; i < G * 3 * kMaxL; i += kThreads) sums[i] = 0.f;
  mbar_wait(meta_bar, 0);
  __syncthreads();
  // head g's dacum, dt and row sums (d(dacum), e, f)
  auto cum = [&](int g) { return mt + g * 2 * kMaxL; };
  auto dtv = [&](int g) { return mt + g * 2 * kMaxL + L; };
  auto dcum = [&](int g) { return sums + g * 3 * kMaxL; };
  auto ecol = [&](int g) { return sums + g * 3 * kMaxL + kMaxL; };
  auto fsum = [&](int g) { return sums + g * 3 * kMaxL + 2 * kMaxL; };

  const uint32_t outer = base + Pl::kOuter;
  const uint8_t* outer_p = sm + Pl::kOuter;
  const uint32_t state = base + Pl::kState;
  int step = 0;
  uint32_t outer_phase = 0;
  auto next_inner = [&]() {
    __syncthreads();   // every thread is done with this step's stage
    if (tid == 0 && step + 2 < 2 * n_inner) issue_inner(step + 2);
    ++step;
  };

  // ---- pass A: row tiles I -> dC and the rows' part of d(dacum) ----
  mbar_wait(state_bar, 0);
  for (int I = 0; I < nT; ++I) {
    if (I > 0) {
      __syncthreads();   // the last outer tile is read
      if (tid == 0) issue_outer(true, I);
    }
    mbar_wait(outer_bar, outer_phase);
    outer_phase ^= 1;
    float dc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) dc[i] = 0.f;
    float cl[G][2];   // this thread's rows' dacum, per head
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        cl[g][hr] = cum(g)[I * kT + r0 + 8 * hr] * kLog2e;
    for (int J = 0; J <= I; ++J) {
      mbar_wait(full_bar + 8 * (step & 1), (step >> 1) & 1);
      const uint32_t bj = base + (step & 1) * Pl::kStep;
      float cb[32];
      wgmma_fence();
      kmajor_64x64<N>(cb, outer, bj);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<32>(cb);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dw[32];
        wgmma_fence();
        kmajor_64x64<kP>(dw, outer + (kNB + g) * kBox, bj + (kNB + g) * kBox);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<32>(dw);
        const float* cm = cum(g);
        const float* dm = dtv(g);
        float z[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int m = J * kT + 8 * j + c0;
          const float2 cmv = *reinterpret_cast<const float2*>(cm + m);
          const float2 dmv = *reinterpret_cast<const float2*>(dm + m);
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              const int i = 4 * j + 2 * hr + e;
              const bool in = I > J || 8 * j + c0 + e <= r0 + 8 * hr;
              const float mk =
                  in ? ex2(cl[g][hr] - (e ? cmv.y : cmv.x) * kLog2e) : 0.f;
              const float v = dw[i] * mk * (e ? dmv.y : dmv.x);
              z[hr] += v * cb[i];
              dw[i] = v;
            }
        }
        uint32_t pa[16];
        pack_frag(dw, pa);
        wgmma_fence();
        rs_64xN<N>(dc, pa, bj);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<N / 2>(dc);
        fence_regs<16>(pa);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float t = quad_sum(z[hr]);
          if (c0 == 0) dcum(g)[I * kT + r0 + 8 * hr] += t;
        }
      }
      next_inner();
    }
    // the carried state: dC += exp(dacum[l]) dY h_in, d(dacum[l]) += C[l] .
    // that
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float off[N / 2];
      wgmma_fence();
      mnprod<N>(off, outer + (kNB + g) * kBox, state + g * kNB * kBox, 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<N / 2>(off);
      float z[2] = {0.f, 0.f};
      float el[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) el[hr] = ex2(cl[g][hr]);
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int i = 4 * j + 2 * hr;
          const float2 cv = __bfloat1622float2(
              *at2(outer_p, r0 + 8 * hr, 8 * j + c0));
          const float o0 = off[i] * el[hr], o1 = off[i + 1] * el[hr];
          dc[i] += o0;
          dc[i + 1] += o1;
          z[hr] += cv.x * o0 + cv.y * o1;
        }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const float t = quad_sum(z[hr]);
        if (c0 == 0) dcum(g)[I * kT + r0 + 8 * hr] += t;
      }
    }
    float* dst = dCp + ((((int64_t)b * nc + c) * nhg + hg) * L + I * kT) * N;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        *reinterpret_cast<float2*>(dst + (r0 + 8 * hr) * N + 8 * j + c0) =
            make_float2(dc[4 * j + 2 * hr], dc[4 * j + 2 * hr + 1]);
  }

  // ---- G, the leaving state's gradient, as bf16 boxes over h_in; and
  // hsum = h_in . G (fp32 G, bf16 h_in) ----
  __syncthreads();   // pass A's reads of h_in are done
  if (tid == 0) issue_outer(false, 0);
  float hs[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int64_t bch = ((int64_t)b * nc + c) * H + h0 + g;
    const float* gp = gout + bch * kP * N;
    uint8_t* box = sm + Pl::kState + g * kNB * kBox;
    float acc = 0.f;
    for (int q = tid; q < kP * N / 8; q += kThreads) {
      const int p = q / (N / 8), n = (q % (N / 8)) * 8;
      const float4 lo = *reinterpret_cast<const float4*>(gp + p * N + n);
      const float4 hi = *reinterpret_cast<const float4*>(gp + p * N + n + 4);
      uint4* cell = reinterpret_cast<uint4*>(
          box + (n / 64) * kBox + p * kRow + ((((n % 64) / 8) ^ (p & 7)) << 4));
      const uint4 hv = *cell;
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&hv);
      const float2 h01 = __bfloat1622float2(h2[0]);
      const float2 h23 = __bfloat1622float2(h2[1]);
      const float2 h45 = __bfloat1622float2(h2[2]);
      const float2 h67 = __bfloat1622float2(h2[3]);
      acc += h01.x * lo.x + h01.y * lo.y + h23.x * lo.z + h23.y * lo.w +
             h45.x * hi.x + h45.y * hi.y + h67.x * hi.z + h67.y * hi.w;
      *cell = make_uint4(pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w),
                         pack_bf16(hi.x, hi.y), pack_bf16(hi.z, hi.w));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) red[g * 4 + warp] = acc;
  }
  fence_proxy_async();
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g)
    hs[g] = (red[g * 4] + red[g * 4 + 1]) + (red[g * 4 + 2] + red[g * 4 + 3]);

  // ---- pass B: column tiles J -> dx, dB, the columns' sums ----
  for (int J = 0; J < nT; ++J) {
    if (J > 0) {
      __syncthreads();
      if (tid == 0) issue_outer(false, J);
    }
    mbar_wait(outer_bar, outer_phase);
    outer_phase ^= 1;
    float dxa[G][32];
    float db[N / 2];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < 32; ++i) dxa[g][i] = 0.f;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) db[i] = 0.f;
    float cmr[G][2], dtr[G][2];   // this thread's rows m: dacum (log2), dt
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        cmr[g][hr] = cum(g)[J * kT + r0 + 8 * hr] * kLog2e;
        dtr[g][hr] = dtv(g)[J * kT + r0 + 8 * hr];
      }
    for (int I = J; I < nT; ++I) {
      mbar_wait(full_bar + 8 * (step & 1), (step >> 1) & 1);
      const uint32_t ci = base + (step & 1) * Pl::kStep;
      float cbt[32];
      wgmma_fence();
      kmajor_64x64<N>(cbt, outer, ci);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<32>(cbt);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dwt[32];
        wgmma_fence();
        kmajor_64x64<kP>(dwt, outer + (kNB + g) * kBox,
                         ci + (kNB + g) * kBox);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<32>(dwt);
        const float* cm = cum(g);
        float ez[2] = {0.f, 0.f};
        uint32_t pm[16], pd[16];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int l = I * kT + 8 * j + c0;
          const float2 clv = *reinterpret_cast<const float2*>(cm + l);
          float w[2][2], d[2][2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              const int i = 4 * j + 2 * hr + e;
              const bool in = I > J || 8 * j + c0 + e >= r0 + 8 * hr;
              const float mk =
                  in ? ex2((e ? clv.y : clv.x) * kLog2e - cmr[g][hr]) : 0.f;
              const float cbm = cbt[i] * mk;
              ez[hr] += dwt[i] * cbm;
              w[hr][e] = cbm;
              d[hr][e] = dwt[i] * mk * dtr[g][hr];
            }
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            pm[2 * j + hr] = pack_bf16(w[hr][0], w[hr][1]);
            pd[2 * j + hr] = pack_bf16(d[hr][0], d[hr][1]);
          }
        }
        wgmma_fence();
        rs_64xN<kP>(dxa[g], pm, ci + (kNB + g) * kBox);
        rs_64xN<N>(db, pd, ci);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<32>(dxa[g]);
        fence_regs<N / 2>(db);
        fence_regs<16>(pm);
        fence_regs<16>(pd);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float t = quad_sum(ez[hr]);
          if (c0 == 0) ecol(g)[J * kT + r0 + 8 * hr] += t;
        }
      }
      next_inner();
    }
    // the leaving state: BG = B G^T [m][p], XG = X G [m][n]; dx = dt (acc +
    // r BG), dB += r dt XG, f[m] = r X[m] . BG[m]
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float lg = cum(g)[L - 1] * kLog2e;
      float bgm[32], xg[N / 2];
      wgmma_fence();
      kmajor_64x64<N>(bgm, outer, state + g * kNB * kBox);
      mnprod<N>(xg, outer + (kNB + g) * kBox, state + g * kNB * kBox, 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<32>(bgm);
      fence_regs<N / 2>(xg);
      float r[2], f[2] = {0.f, 0.f};
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) r[hr] = ex2(lg - cmr[g][hr]);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int i = 4 * j + 2 * hr;
          const float2 xv = __bfloat1622float2(
              *at2(outer_p + (kNB + g) * kBox, r0 + 8 * hr, 8 * j + c0));
          f[hr] += xv.x * bgm[i] + xv.y * bgm[i + 1];
        }
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int i = 4 * j + 2 * hr;
          const float w = r[hr] * dtr[g][hr];
          db[i] += w * xg[i];
          db[i + 1] += w * xg[i + 1];
        }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const float t = quad_sum(f[hr]);
        if (c0 == 0) fsum(g)[J * kT + r0 + 8 * hr] = r[hr] * t;
        const int64_t row = ((int64_t)b * S + t0 + J * kT + r0 + 8 * hr) * H +
                            h0 + g;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int i = 4 * j + 2 * hr;
          *reinterpret_cast<__nv_bfloat162*>(dx + row * kP + 8 * j + c0) =
              __floats2bfloat162_rn(
                  dtr[g][hr] * (dxa[g][i] + r[hr] * bgm[i]),
                  dtr[g][hr] * (dxa[g][i + 1] + r[hr] * bgm[i + 1]));
        }
      }
    }
    float* dst = dBp + ((((int64_t)b * nc + c) * nhg + hg) * L + J * kT) * N;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        *reinterpret_cast<float2*>(dst + (r0 + 8 * hr) * N + 8 * j + c0) =
            make_float2(db[4 * j + 2 * hr], db[4 * j + 2 * hr + 1]);
  }

  // ---- d(dacum) -> d(da) (summed from the end), ddt, the chunk's da ----
  __syncthreads();
  if (warp < G) {
    const int g = warp;
    const int h = h0 + g;
    const float* cm = cum(g);
    const float* dm = dtv(g);
    const float* dc = dcum(g);
    const float* ec = ecol(g);
    const float* fd = fsum(g);
    const int per = L / 32;   // a lane's consecutive steps
    float v[kMaxL / 32];
    float fs = 0.f, tot = 0.f;
#pragma unroll
    for (int e = 0; e < kMaxL / 32; ++e)
      if (e < per) {
        const int i = lane * per + e;
        v[e] = dc[i] - dm[i] * (ec[i] + fd[i]);
        fs += dm[i] * fd[i];
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      fs += __shfl_xor_sync(0xffffffffu, fs, off);
    // the decay of the whole chunk: the last step's d(dacum) also takes
    // sum dt f and exp(dacum[L-1]) h_in . G
    const float hsg = G == 2 && g == 1 ? hs[G - 1] : hs[0];
#pragma unroll
    for (int e = 0; e < kMaxL / 32; ++e)
      if (e < per) {
        if (lane == 31 && e == per - 1) v[e] += fs + expf(cm[L - 1]) * hsg;
        tot += v[e];
      }
    // the sum of the lanes after this one
    float after = tot;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_down_sync(0xffffffffu, after, off);
      if (lane + off < 32) after += u;
    }
    after -= tot;
    const float ah = a[h];
    float run = after, part = 0.f;
#pragma unroll
    for (int e = kMaxL / 32 - 1; e >= 0; --e)
      if (e < per) {
        const int i = lane * per + e;
        run += v[e];
        ddt[((int64_t)b * S + t0 + i) * H + h] = ec[i] + fd[i] + ah * run;
        part += dm[i] * run;
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (lane == 0) dap[((int64_t)b * nc + c) * H + h] = part;
  }
}

// -- host side ----------------------------------------------------------------

// fp32 scratch, in order: the entering states (bf16, from ssd_state), each
// chunk's dacum and dt, ssd_state's final state and a zero h0, the leaving
// states' gradients, their log decays, dap, and the head groups' dB / dC
// partials
struct Scratch {
  long long states, meta, hout, h0, gout, declog, dap, dbp, dcp, total;
};

inline Scratch scratch_layout(int B, int S, int H, int N, int L) {
  const long long bch = (long long)B * (S / L) * H;
  const long long bhpn = (long long)B * H * kP * N;
  const long long parts =
      (long long)B * (S / L) * (H / heads_per_block(N, H)) * L * N;
  Scratch s;
  s.states = 0;
  s.meta = s.states + bch * kP * N / 2;
  s.hout = s.meta + bch * 2 * L;
  s.h0 = s.hout + bhpn;
  s.gout = s.h0 + bhpn;
  s.declog = s.gout + bch * kP * N;
  s.dap = s.declog + (bch + 3) / 4 * 4;
  s.dbp = s.dap + (bch + 3) / 4 * 4;
  s.dcp = s.dbp + parts;
  s.total = s.dcp + parts;
  return s;
}

template <int N, int G>
int launch_chunk(const void* x, const void* dy, const void* bm,
                 const void* cm, const void* states, const float* meta,
                 const float* a, const float* gout, void* dx, float* ddt,
                 float* dbp, float* dcp, float* dap, int B, int S, int H,
                 int L, cudaStream_t s) {
  CUtensorMap tx, tdy, tb, tcm, ts;
  int err = make_map(&tx, x, B, S, H, kP, kT);
  if (!err) err = make_map(&tdy, dy, B, S, H, kP, kT);
  if (!err) err = make_map(&tb, bm, B, S, 1, N, kT);
  if (!err) err = make_map(&tcm, cm, B, S, 1, N, kT);
  if (!err) err = ssd::tc::make_state_map(&ts, states, B, S / L, H, N);
  if (err) return err;
  auto kernel = chunk_tc_kernel<N, G>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Plan<N, G>::kAlloc);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const long long blocks = (long long)B * (S / L) * (H / G);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, Plan<N, G>::kAlloc, s>>>(
      tx, tdy, tb, tcm, ts, meta, a, gout, static_cast<__nv_bfloat16*>(dx),
      ddt, dbp, dcp, dap, S, H, L);
  return (int)cudaGetLastError();
}

template <int N>
int launch(const void* x, const void* dt, const void* a, const void* bm,
           const void* cm, const void* h0, const void* dy,
           const void* dfinal, void* dx, void* ddt, void* da, void* db,
           void* dc, void* dh0, float* scratch, int B, int S, int H, int L,
           cudaStream_t s) {
  using T = __nv_bfloat16;
  namespace sb = ::ssd::backward;
  const Scratch sc = scratch_layout(B, S, H, N, L);
  const int nchunks = S / L;
  float* states = scratch + sc.states;
  float* meta = scratch + sc.meta;
  float* gout = scratch + sc.gout;
  float* declog = scratch + sc.declog;
  float* dap = scratch + sc.dap;
  const float* a_ = static_cast<const float*>(a);
  const long long bhpn = (long long)B * H * kP * N;
  if (h0 == nullptr) {
    const cudaError_t e =
        cudaMemsetAsync(scratch + sc.h0, 0, sizeof(float) * bhpn, s);
    if (e != cudaSuccess) return (int)e;
    h0 = scratch + sc.h0;
  }
  // (i) the entering states (bf16) and each chunk's dacum and dt
  int err = ssd::tc::launch_state<N>(x, dt, a, bm, h0, states, meta,
                                     scratch + sc.hout, B, S, H, L, s);
  if (err) return err;
  // (ii) the gradient of the state leaving each chunk, and dh0
  const long long scan_blocks = (bhpn + sb::kThreads - 1) / sb::kThreads;
  const long long red_blocks =
      ((long long)B * S * N + sb::kThreads - 1) / sb::kThreads;
  if (scan_blocks > 0x7fffffffLL || red_blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if ((err = sb::launch_own<T, 1>(dy, cm, nullptr, nullptr, meta, gout,
                                  declog, B, S, H, kP, N, L, s)))
    return err;
  sb::scan_kernel<<<(unsigned)scan_blocks, sb::kThreads, 0, s>>>(
      gout, declog, static_cast<const float*>(dfinal),
      static_cast<float*>(dh0), B, nchunks, H, kP * N, 1);
  if ((err = (int)cudaGetLastError())) return err;
  // (iii) per (b, chunk, head group), then the sums over the groups and
  // over (b, chunk)
  float* dbp = scratch + sc.dbp;
  float* dcp = scratch + sc.dcp;
  if constexpr (N == 64) {
    if (heads_per_block(N, H) == 2)
      err = launch_chunk<64, 2>(x, dy, bm, cm, states, meta, a_, gout, dx,
                                static_cast<float*>(ddt), dbp, dcp, dap, B, S,
                                H, L, s);
    else
      err = launch_chunk<64, 1>(x, dy, bm, cm, states, meta, a_, gout, dx,
                                static_cast<float*>(ddt), dbp, dcp, dap, B, S,
                                H, L, s);
  } else {
    err = launch_chunk<N, 1>(x, dy, bm, cm, states, meta, a_, gout, dx,
                             static_cast<float*>(ddt), dbp, dcp, dap, B, S, H,
                             L, s);
  }
  if (err) return err;
  sb::reduce_kernel<T><<<(unsigned)red_blocks, sb::kThreads, 0, s>>>(
      dbp, dcp, static_cast<T*>(db), static_cast<T*>(dc), B, S,
      H / heads_per_block(N, H), N, L);
  sb::da_kernel<<<(H + sb::kThreads - 1) / sb::kThreads, sb::kThreads, 0,
                  s>>>(dap, static_cast<float*>(da), B * nchunks, H);
  return (int)cudaGetLastError();
}

}  // namespace backward_tc
}  // namespace ssd
