// The `simt` flash backward (FlashAttention-2's algorithm, Dao,
// arXiv:2307.08691, section 3.2): the input gradients of the function
// every forward variant computes, from the forward's output O and its
// rows' log-sum-exp (lse), at f32 and every shape the tc backward does not
// take (flash_attention.cu).  The name is historical: the variant first
// ran on the fp32 CUDA cores.  Its products now run on the tensor cores as
// split-TF32 mma.sync m16n8k8 (flash_mma.cuh): each fp32 operand, P and dS
// included, is split in two TF32 parts and each product taken as three in
// fp32; bf16 operands (Q, K, V, dO in bf16) are exact in TF32 and take one
// part.  Three kernels, no atomics, so two calls give equal bits:
//
// delta: D = rowsum(dO * O) in fp32, one warp a (b, q row, q head).
// dkdv:  one block per (b, kv head, 16 * PAIRS keys), a pair of warps per
//   16 keys.  K and V are staged once; the block walks the q tiles (BQ
//   rows) of every q head of its GQA group some row of which may see a key
//   of the block, each tile's Q, dO, lse, D and positions arriving by
//   cp.async in a ring of two stages.  Warp A of a pair computes S^T = K
//   Q^T, the softcap and P^T = exp(S^T - lse) on the visible pairs (causal
//   and window by position, kv positions >= 2^29 are padding, 0
//   elsewhere), and dV += P^T dO; warp B computes dP^T = V dO^T and, from
//   the P^T (times 1 - tanh^2 under a softcap) that A hands it through
//   shared memory (both fragments give a lane the same elements, so a lane
//   reads what A's lane of the same index wrote), dS^T = P^T (dP^T - D)
//   and dK += dS^T Q.  dV and dK stay in fp32 registers (acc[32][4]: Dv,
//   Dk <= 256); dK is scaled once at the end.
// dq:    one block per (b, q head, 16 * WARPS rows), 16 rows a warp, over
//   the key tiles (BK keys) some row may see, K/V tiles in a ring of two
//   stages by cp.async: S and dP again, dS, dQ += dS K in fp32 registers,
//   scaled once.
//
// What costs besides the products is the split, so the tile every warp of
// a block reads (Q and dO in dkdv, K and V in dq) is split once, in f32,
// when it lands: the big parts in place, the small ones in one more fp32
// buffer; each warp splits its own operand (K and V in dkdv, Q and dO in
// dq) as it reads it.  A tile read both ways (as "pairs" and "from C" B
// fragments: Q and dO in dkdv, K in dq) keeps its rows in prow order,
// conflict-free both ways.  Each gradient is rounded once to its input's
// type.  Head dims are zero-padded to multiples of 8 in shared memory.
// The launcher takes the tiles by shape: dkdv <4 pairs, 32 rows> in f32
// (64 rows would spill) where it fits 227 KB, else <2, 16>, and <4, 64> in
// bf16; dq <4 warps, 32 keys> with dQ in 8 n-tiles to Dk 64 (two blocks an
// SM) or 16 to Dk 128, else <4, 16 keys, 32 n-tiles>, else <1, 16, 32>,
// and <4, 32, 32> in bf16.  In f32 at zamba2's (64, 64): dkdv <4, 32>, dq
// <4, 32, 8>; at MLA's (192, 128): <4, 32> (224,008 B at S 2048) and <4,
// 16, 32>; at (256, 256): <2, 16> and <1, 16, 32>.  A row that sees no key
// gets no gradient (its lse is -inf, or the forward filled it from hidden
// keys alone).
#pragma once

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace flash {
namespace backward {

using mma::round8;
using mma::stride_pairs;

constexpr int kThreads = 256;

__device__ __forceinline__ bool visible(int qp, int kp, int causal,
                                        int window) {
  bool ok = kp < kValidPosLimit;
  if (causal) ok = ok && kp <= qp;
  if (window > 0) ok = ok && kp > qp - window;
  return ok;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
             float* __restrict__ delta, int64_t rows, int Dv) {
  const int64_t row =
      (int64_t)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* o = out + row * Dv;
  const T* d = dout + row * Dv;
  float acc = 0.f;
  for (int c = lane; c < Dv; c += 32)
    acc = fmaf(to_float(o[c]), to_float(d[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// P = exp(x - lse) on a visible pair (0 elsewhere) from the raw product
// q.k, and the softcap's 1 - tanh^2 (1 without one)
__device__ __forceinline__ float prob(float qk, float lse, bool vis,
                                      float scale, float softcap,
                                      float* dcap) {
  float x = qk * scale;
  *dcap = 1.f;
  if (softcap > 0.f) {
    const float th = tanhf(x / softcap);
    x = softcap * th;
    *dcap = 1.f - th * th;
  }
  return vis ? expf(x - lse) : 0.f;
}

// shared memory of each kernel; in f32 the tile the warps share (Q and dO
// in dkdv, K and V in dq) has one more buffer, in fp32, for the small parts
template <typename T>
constexpr size_t dkdv_bytes(int pairs, int bq, int dk, int dv, int sq) {
  const size_t qo = (size_t)bq * (stride_pairs(dk) + stride_pairs(dv));
  return sizeof(float) * (size_t)pairs * bq * 16            // P hand-over
         + sizeof(T) * ((size_t)16 * pairs * (stride_pairs(dk) + stride_pairs(dv))
                        + 2 * qo)
         + (mma::exact<T>() ? 0 : sizeof(float) * qo)
         + sizeof(float) * 2 * 3 * bq                       // lse, D, qp
         + sizeof(uint32_t) * mma::mask_words((sq + bq - 1) / bq);
}

template <typename T>
constexpr size_t dq_bytes(int warps, int bk, int dk, int dv, int skv) {
  const size_t kv = (size_t)bk * (stride_pairs(dk) + stride_pairs(dv));
  return sizeof(T) * ((size_t)16 * warps * (stride_pairs(dk) + stride_pairs(dv))
                      + 2 * kv)
         + (mma::exact<T>() ? 0 : sizeof(float) * kv)
         + sizeof(int) * 2 * bk
         + sizeof(uint32_t) * mma::mask_words((skv + bk - 1) / bk);
}

// rows [q0, q0 + BQ) of q head h: Q, dO, lse, D and positions into a
// stage, by cp.async (Q's and dO's rows in prow order: both are read
// both ways)
template <typename T>
__device__ __forceinline__ void stage_rows(
    T* Qt, T* dOt, float* ls, float* ds, int* qp, const T* q, const T* dout,
    const float* lse, const float* delta, const int32_t* qp_b, int64_t qbase,
    int h, int Hq, int nq, int bq, int64_t q_row, int64_t o_row, int Dk,
    int Dv, int ks, int vs, int vec, int tid, int nthreads) {
  mma::stage(Qt, ks, q + qbase * q_row + (int64_t)h * Dk, q_row, bq, nq, Dk,
             vec, tid, nthreads, true);
  mma::stage(dOt, vs, dout + qbase * o_row + (int64_t)h * Dv, o_row, bq, nq,
             Dv, vec, tid, nthreads, true);
  mma::stage_scalars(ls, lse + qbase * Hq + h, Hq, bq, nq, tid, nthreads);
  mma::stage_scalars(ds, delta + qbase * Hq + h, Hq, bq, nq, tid, nthreads);
  mma::stage_scalars(qp, qp_b, 1, bq, nq, tid, nthreads);
}

template <typename T, int PAIRS, int BQ>
__global__ void __launch_bounds__(PAIRS * 64)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            const int32_t* __restrict__ qpos,
            const int32_t* __restrict__ kpos, T* __restrict__ dk,
            T* __restrict__ dv, int Sq, int Skv, int Hq, int Hkv, int Dk,
            int Dv, float scale, float softcap, int causal, int window,
            int vec) {
  constexpr int kThr = PAIRS * 64;
  constexpr int BK = 16 * PAIRS;
  constexpr int NQ = BQ / 8;               // 8-row n-tiles of S^T
  constexpr bool kExact = mma::exact<T>();
  const int ks = stride_pairs(Dk), vs = stride_pairs(Dv);
  const int kst = round8(Dk) / 8, vst = round8(Dv) / 8;
  const int nqt = (Sq + BQ - 1) / BQ;
  extern __shared__ float4 smem4[];
  float* Pb = reinterpret_cast<float*>(smem4);              // [PAIRS][NQ][32][4]
  T* Ks = reinterpret_cast<T*>(Pb + PAIRS * BQ * 16);       // [BK][ks]
  T* Vs = Ks + BK * ks;                                     // [BK][vs]
  T* Qs = Vs + BK * vs;                                     // [2][BQ][ks]
  T* dOs = Qs + 2 * BQ * ks;                                // [2][BQ][vs]
  float* Qsm = reinterpret_cast<float*>(dOs + 2 * BQ * vs); // [BQ][ks]
  float* dOsm = Qsm + (kExact ? 0 : BQ * ks);               // [BQ][vs]
  float* lse_s = dOsm + (kExact ? 0 : BQ * vs);             // [2][BQ]
  float* del_s = lse_s + 2 * BQ;                            // [2][BQ]
  int* qp_s = reinterpret_cast<int*>(del_s + 2 * BQ);       // [2][BQ]
  uint32_t* seen = reinterpret_cast<uint32_t*>(qp_s + 2 * BQ);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int pair = warp / 2;
  const bool role_a = warp % 2 == 0;
  const int k0 = blockIdx.x * BK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = Hq / Hkv;
  const int nk = min(BK, Skv - k0);
  const int64_t q_row = (int64_t)Hq * Dk, o_row = (int64_t)Hq * Dv;
  const int64_t k_row = (int64_t)Hkv * Dk, v_row = (int64_t)Hkv * Dv;
  const int64_t kbase = (int64_t)b * Skv + k0;
  const int32_t* kp_b = kpos + kbase;
  const int32_t* qp_b = qpos + (int64_t)b * Sq;

  // this thread's keys kr0 and kr0 + 8, and the range of the block's valid
  // keys
  const int kr0 = 16 * pair + g;
  const int kp0 = kr0 < nk ? kp_b[kr0] : kValidPosLimit;
  const int kp1 = kr0 + 8 < nk ? kp_b[kr0 + 8] : kValidPosLimit;
  int klo = INT_MAX, khi = INT_MIN;
  for (int j = lane; j < nk; j += 32) {
    const int p = kp_b[j];
    if (p < kValidPosLimit) {
      klo = min(klo, p);
      khi = max(khi, p);
    }
  }
  mma::warp_range(klo, khi);

  // the q tiles some row of which may see a key of the block
  for (int w = tid; w < mma::mask_words(nqt); w += kThr) seen[w] = 0u;
  mma::zero_cols(Ks, ks, BK, Dk, tid, kThr);
  mma::zero_cols(Vs, vs, BK, Dv, tid, kThr);
  mma::zero_cols(Qs, ks, 2 * BQ, Dk, tid, kThr);
  mma::zero_cols(dOs, vs, 2 * BQ, Dv, tid, kThr);
  __syncthreads();
  for (int qt = warp; qt < nqt; qt += 2 * PAIRS) {
    bool any = false;
    for (int i = qt * BQ + lane; i < min(Sq, (qt + 1) * BQ); i += 32)
      any |= mma::row_may_see(qp_b[i], klo, khi, causal, window);
    if (__any_sync(0xffffffffu, any) && lane == 0)
      atomicOr(seen + (qt >> 5), 1u << (qt & 31));
  }
  __syncthreads();

  mma::stage(Ks, ks, k + kbase * k_row + (int64_t)hk * Dk, k_row, BK, nk, Dk,
             vec, tid, kThr);
  mma::stage(Vs, vs, v + kbase * v_row + (int64_t)hk * Dv, v_row, BK, nk, Dv,
             vec, tid, kThr);

  // acc: dV (warp A) or dK (warp B), 16 keys x 8 columns an n-tile
  float acc[1][32][4];
#pragma unroll
  for (int n = 0; n < 32; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][n][e] = 0.f;
  float* pb = Pb + ((size_t)pair * NQ * 32 + lane) * 4;

  // the walk: every visible q tile of each q head of the group in turn
  const int first = mma::next_tile(seen, 0, nqt);
  int hh = first < nqt ? 0 : group, qt = first;
  if (hh < group)
    stage_rows(Qs, dOs, lse_s, del_s, qp_s, q, dout, lse, delta,
               qp_b + qt * BQ, (int64_t)b * Sq + qt * BQ, hk * group + hh, Hq,
               min(BQ, Sq - qt * BQ), BQ, q_row, o_row, Dk, Dv, ks, vs, vec,
               tid, kThr);
  hopper::cp_async_commit();   // K, V and the first tile
  for (int i = 0; hh < group; ++i) {
    int nh = hh, nt = mma::next_tile(seen, qt + 1, nqt);
    if (nt == nqt) {
      nh = hh + 1;
      nt = first;
    }
    const int st = i & 1, nq = min(BQ, Sq - qt * BQ);
    // this tile has landed for every thread, and the last tile's readers
    // are done with the other stage, the small parts and P
    hopper::cp_async_wait<0>();
    __syncthreads();
    T* Qt = Qs + st * BQ * ks;
    T* dOt = dOs + st * BQ * vs;
    const float* ls = lse_s + st * BQ;
    const float* ds_ = del_s + st * BQ;
    const int* qp = qp_s + st * BQ;
    if (nh < group)               // the next tile's copy overlaps this one
      stage_rows(Qs + (st ^ 1) * BQ * ks, dOs + (st ^ 1) * BQ * vs,
                 lse_s + (st ^ 1) * BQ, del_s + (st ^ 1) * BQ,
                 qp_s + (st ^ 1) * BQ, q, dout, lse, delta, qp_b + nt * BQ,
                 (int64_t)b * Sq + nt * BQ, hk * group + nh, Hq,
                 min(BQ, Sq - nt * BQ), BQ, q_row, o_row, Dk, Dv, ks, vs, vec,
                 tid, kThr);
    hopper::cp_async_commit();
    if constexpr (!kExact) {      // Q and dO split once for every warp
      mma::split_tile(Qt, Qsm, ks, BQ, 8 * kst, tid, kThr);
      mma::split_tile(dOt, dOsm, vs, BQ, 8 * vst, tid, kThr);
    }
    if constexpr (!kExact) __syncthreads();
    const int qoff = kExact ? 0 : (int)(Qsm - reinterpret_cast<float*>(Qt));
    const int ooff = kExact ? 0 : (int)(dOsm - reinterpret_cast<float*>(dOt));

    // S^T (warp A) or dP^T (warp B): this pair's 16 keys x the tile's rows
    float s[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    const T* ka = (role_a ? Ks + kr0 * ks : Vs + kr0 * vs) + 2 * t;
    const T* qb = (role_a ? Qt + mma::prow(g) * ks
                          : dOt + mma::prow(g) * vs) + 2 * t;
    const int sa = role_a ? ks : vs, boff = role_a ? qoff : ooff;
    const int steps = role_a ? kst : vst;
#pragma unroll 2
    for (int c = 0; c < steps; ++c) {
      uint32_t ab[4], as[4];
      mma::load_a(ka, sa, c, ab, as);
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        uint32_t bb[2], bs[2];
        mma::load_b_pairs(qb + 8 * j * sa, boff, c, bb, bs);
        mma::mma3<kExact, kExact>(s[j], ab, as, bb, bs);
      }
    }

    // lane (g, t) holds rows 8j + 2t, + 1 of keys kr0 (e 0, 1) and kr0 + 8
    // (e 2, 3)
    if (role_a) {
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        float pc[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 8 * j + 2 * t + (e & 1);
          const bool vis = row < nq &&
                           visible(qp[row], e < 2 ? kp0 : kp1, causal, window);
          float dcap;
          s[j][e] = prob(s[j][e], ls[row], vis, scale, softcap, &dcap);
          pc[e] = s[j][e] * dcap;
        }
        *reinterpret_cast<float4*>(pb + j * 128) =
            make_float4(pc[0], pc[1], pc[2], pc[3]);
      }
      hopper::named_bar_arrive(1 + pair, 64);
    } else {
      hopper::named_bar_sync(1 + pair, 64);
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const float4 pc = *reinterpret_cast<const float4*>(pb + j * 128);
        const float d0 = ds_[8 * j + 2 * t], d1 = ds_[8 * j + 2 * t + 1];
        s[j][0] = pc.x * (s[j][0] - d0);
        s[j][1] = pc.y * (s[j][1] - d1);
        s[j][2] = pc.z * (s[j][2] - d0);
        s[j][3] = pc.w * (s[j][3] - d1);
      }
    }

    // dV += P^T dO (warp A) or dK += dS^T Q (warp B): rows 8j + 2t, + 1
    const T* src = role_a ? dOt : Qt;
    const int ss = role_a ? vs : ks, soff = role_a ? ooff : qoff;
    const int ncols = role_a ? vst : kst;
    const T* bp = src + mma::prow(2 * t) * ss + g;
    const int next = (mma::prow(2 * t + 1) - mma::prow(2 * t)) * ss;
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      uint32_t ab[1][4], as[1][4];
      mma::from_c(s[j], ab[0], as[0]);
      mma::mma_cols(acc, ab, as, bp + 8 * j * ss, soff, next, ncols);
    }
    hh = nh;
    qt = nt;
  }
  hopper::cp_async_wait<0>();

  // dV (warp A) or dK times the scale (warp B), rounded once
  T* dst = role_a ? dv : dk;
  const int d = role_a ? Dv : Dk;
  const int64_t drow = role_a ? v_row : k_row;
  const float mul = role_a ? 1.f : scale;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = kr0 + 8 * half;
    if (key >= nk) continue;
    T* row = dst + (kbase + key) * drow + (int64_t)hk * d;
#pragma unroll
    for (int n = 0; n < 32; ++n) {
      const int c = 8 * n + 2 * t;
      if (c < d) row[c] = from_float<T>(acc[0][n][2 * half] * mul);
      if (c + 1 < d)
        row[c + 1] = from_float<T>(acc[0][n][2 * half + 1] * mul);
    }
  }
}

// keys [k0, k0 + bk) of kv head hk: K, V and positions into a stage (K's
// rows in prow order: it is read both ways)
template <typename T>
__device__ __forceinline__ void stage_keys(T* Kt, T* Vt, int* kp, const T* k_b,
                                           const T* v_b, const int32_t* kp_b,
                                           int k0, int Skv, int bk,
                                           int64_t k_row, int64_t v_row,
                                           int Dk, int Dv, int ks, int vs,
                                           int vec, int tid, int nthreads) {
  const int nk = min(bk, Skv - k0);
  mma::stage(Kt, ks, k_b + k0 * k_row, k_row, bk, nk, Dk, vec, tid, nthreads,
             true);
  mma::stage(Vt, vs, v_b + k0 * v_row, v_row, bk, nk, Dv, vec, tid, nthreads);
  mma::stage_scalars(kp, kp_b + k0, 1, bk, nk, tid, nthreads);
}

template <typename T, int WARPS, int BK, int NK>
__global__ void __launch_bounds__(WARPS * 32, NK <= 8 ? 2 : 1)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          const int32_t* __restrict__ qpos, const int32_t* __restrict__ kpos,
          T* __restrict__ dq, int Sq, int Skv, int Hq, int Hkv, int Dk, int Dv,
          float scale, float softcap, int causal, int window, int vec) {
  constexpr int kThr = WARPS * 32;
  constexpr int BQ = 16 * WARPS;
  constexpr int NT = BK / 8;               // 8-key n-tiles of S
  constexpr bool kExact = mma::exact<T>();
  const int ks = stride_pairs(Dk), vs = stride_pairs(Dv);
  const int kst = round8(Dk) / 8, vst = round8(Dv) / 8;
  const int ntiles = (Skv + BK - 1) / BK;
  extern __shared__ float4 smem4[];
  T* Qs = reinterpret_cast<T*>(smem4);                      // [BQ][ks]
  T* dOs = Qs + BQ * ks;                                    // [BQ][vs]
  T* Ks = dOs + BQ * vs;                                    // [2][BK][ks]
  T* Vs = Ks + 2 * BK * ks;                                 // [2][BK][vs]
  float* Ksm = reinterpret_cast<float*>(Vs + 2 * BK * vs);  // [BK][ks]
  float* Vsm = Ksm + (kExact ? 0 : BK * ks);                // [BK][vs]
  int* kp_s = reinterpret_cast<int*>(Vsm + (kExact ? 0 : BK * vs));
  uint32_t* seen = reinterpret_cast<uint32_t*>(kp_s + 2 * BK);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int nq = min(BQ, Sq - q0);
  const int64_t q_row = (int64_t)Hq * Dk, o_row = (int64_t)Hq * Dv;
  const int64_t k_row = (int64_t)Hkv * Dk, v_row = (int64_t)Hkv * Dv;
  const int64_t qbase = (int64_t)b * Sq + q0;
  const int32_t* qp_b = qpos + qbase;
  const int32_t* kp_b = kpos + (int64_t)b * Skv;
  const T* k_b = k + (int64_t)b * Skv * k_row + (int64_t)hk * Dk;
  const T* v_b = v + (int64_t)b * Skv * v_row + (int64_t)hk * Dv;

  // this thread's rows r0 and r0 + 8: positions, lse, D; the block's range
  const int r0 = warp * 16 + g;
  int qp_r[2];
  float lse_r[2], del_r[2];
  bool ok_r[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    ok_r[half] = r < nq;
    qp_r[half] = ok_r[half] ? qp_b[r] : 0;
    lse_r[half] = ok_r[half] ? lse[(qbase + r) * Hq + h] : 0.f;
    del_r[half] = ok_r[half] ? delta[(qbase + r) * Hq + h] : 0.f;
  }
  int qlo = INT_MAX, qhi = INT_MIN;
  for (int i = lane; i < nq; i += 32) {
    qlo = min(qlo, qp_b[i]);
    qhi = max(qhi, qp_b[i]);
  }
  mma::warp_range(qlo, qhi);

  for (int w = tid; w < mma::mask_words(ntiles); w += kThr) seen[w] = 0u;
  mma::zero_cols(Qs, ks, BQ, Dk, tid, kThr);
  mma::zero_cols(dOs, vs, BQ, Dv, tid, kThr);
  mma::zero_cols(Ks, ks, 2 * BK, Dk, tid, kThr);
  mma::zero_cols(Vs, vs, 2 * BK, Dv, tid, kThr);
  __syncthreads();
  for (int tt = warp; tt < ntiles; tt += WARPS) {
    bool any = false;
    for (int j = tt * BK + lane; j < min(Skv, (tt + 1) * BK); j += 32)
      any |= mma::key_may_see(kp_b[j], qlo, qhi, causal, window);
    if (__any_sync(0xffffffffu, any) && lane == 0)
      atomicOr(seen + (tt >> 5), 1u << (tt & 31));
  }
  __syncthreads();

  mma::stage(Qs, ks, q + qbase * q_row + (int64_t)h * Dk, q_row, BQ, nq, Dk,
             vec, tid, kThr);
  mma::stage(dOs, vs, dout + qbase * o_row + (int64_t)h * Dv, o_row, BQ, nq,
             Dv, vec, tid, kThr);

  float acc[1][NK][4];   // dQ, 16 rows x 8 columns an n-tile
#pragma unroll
  for (int n = 0; n < NK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][n][e] = 0.f;

  int tt = mma::next_tile(seen, 0, ntiles);
  if (tt < ntiles)
    stage_keys(Ks, Vs, kp_s, k_b, v_b, kp_b, tt * BK, Skv, BK, k_row, v_row,
               Dk, Dv, ks, vs, vec, tid, kThr);
  hopper::cp_async_commit();   // Q, dO and the first tile
  for (int i = 0; tt < ntiles; ++i) {
    const int tn = mma::next_tile(seen, tt + 1, ntiles);
    const int st = i & 1, k0 = tt * BK;
    // this tile has landed for every thread, and the last tile's readers
    // are done with the other stage and the small parts
    hopper::cp_async_wait<0>();
    __syncthreads();
    T* Kt = Ks + st * BK * ks;
    T* Vt = Vs + st * BK * vs;
    const int* kp = kp_s + st * BK;
    if (tn < ntiles)              // the next tile's copy overlaps this one
      stage_keys(Ks + (st ^ 1) * BK * ks, Vs + (st ^ 1) * BK * vs,
                 kp_s + (st ^ 1) * BK, k_b, v_b, kp_b, tn * BK, Skv, BK,
                 k_row, v_row, Dk, Dv, ks, vs, vec, tid, kThr);
    hopper::cp_async_commit();
    if constexpr (!kExact) {      // K and V split once for every warp
      mma::split_tile(Kt, Ksm, ks, BK, 8 * kst, tid, kThr);
      mma::split_tile(Vt, Vsm, vs, BK, 8 * vst, tid, kThr);
    }
    if constexpr (!kExact) __syncthreads();
    const int koff = kExact ? 0 : (int)(Ksm - reinterpret_cast<float*>(Kt));
    const int voff = kExact ? 0 : (int)(Vsm - reinterpret_cast<float*>(Vt));

    // S = Q K^T and dP = dO V^T for the warp's rows and the tile's keys
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    {
      const T* qa = Qs + r0 * ks + 2 * t;
      const T* kb = Kt + mma::prow(g) * ks + 2 * t;
#pragma unroll 2
      for (int c = 0; c < kst; ++c) {
        uint32_t ab[4], as[4];
        mma::load_a(qa, ks, c, ab, as);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t bb[2], bs[2];
          mma::load_b_pairs(kb + 8 * j * ks, koff, c, bb, bs);
          mma::mma3<kExact, kExact>(s[j], ab, as, bb, bs);
        }
      }
      const T* oa = dOs + r0 * vs + 2 * t;
      const T* vb = Vt + g * vs + 2 * t;
#pragma unroll 2
      for (int c = 0; c < vst; ++c) {
        uint32_t ab[4], as[4];
        mma::load_a(oa, vs, c, ab, as);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t bb[2], bs[2];
          mma::load_b_pairs(vb + 8 * j * vs, voff, c, bb, bs);
          mma::mma3<kExact, kExact>(dp[j], ab, as, bb, bs);
        }
      }
    }

    // dS on the fragment: lane (g, t) holds keys 8j + 2t, + 1 of rows r0
    // (e 0, 1) and r0 + 8 (e 2, 3)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 8 * j + 2 * t + (e & 1), half = e >> 1;
        const bool vis = ok_r[half] && k0 + key < Skv &&
                         visible(qp_r[half], kp[key], causal, window);
        float dcap;
        const float p = prob(s[j][e], lse_r[half], vis, scale, softcap, &dcap);
        s[j][e] = p * (dp[j][e] - del_r[half]) * dcap;
      }

    // dQ += dS K: K's rows 8j + 2t, + 1
    const T* kc = Kt + mma::prow(2 * t) * ks + g;
    const int next = (mma::prow(2 * t + 1) - mma::prow(2 * t)) * ks;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t ab[1][4], as[1][4];
      mma::from_c(s[j], ab[0], as[0]);
      mma::mma_cols(acc, ab, as, kc + 8 * j * ks, koff, next, kst);
    }
    tt = tn;
  }
  hopper::cp_async_wait<0>();

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (!ok_r[half]) continue;
    T* row = dq + (qbase + r0 + 8 * half) * q_row + (int64_t)h * Dk;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      const int c = 8 * n + 2 * t;
      if (c < Dk) row[c] = from_float<T>(acc[0][n][2 * half] * scale);
      if (c + 1 < Dk)
        row[c + 1] = from_float<T>(acc[0][n][2 * half + 1] * scale);
    }
  }
}

// -- host side ------------------------------------------------------------------

template <typename K>
int opt_in(K kernel, size_t smem) {
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int PAIRS, int BQ>
int launch_dkdv(const T* q, const T* k, const T* v, const T* dout,
                const float* lse, const float* delta, const int32_t* qpos,
                const int32_t* kpos, T* dk, T* dv, int B, int Sq, int Skv,
                int Hq, int Hkv, int Dk, int Dv, float scale, float softcap,
                int causal, int window, int vec, cudaStream_t s) {
  auto kernel = dkdv_kernel<T, PAIRS, BQ>;
  const size_t smem = dkdv_bytes<T>(PAIRS, BQ, Dk, Dv, Sq);
  const int err = opt_in(kernel, smem);
  if (err) return err;
  const dim3 grid((Skv + 16 * PAIRS - 1) / (16 * PAIRS), Hkv, B);
  kernel<<<grid, PAIRS * 64, smem, s>>>(q, k, v, dout, lse, delta, qpos, kpos,
                                        dk, dv, Sq, Skv, Hq, Hkv, Dk, Dv, scale,
                                        softcap, causal, window, vec);
  return (int)cudaGetLastError();
}

template <typename T, int WARPS, int BK, int NK>
int launch_dq(const T* q, const T* k, const T* v, const T* dout,
              const float* lse, const float* delta, const int32_t* qpos,
              const int32_t* kpos, T* dq, int B, int Sq, int Skv, int Hq,
              int Hkv, int Dk, int Dv, float scale, float softcap, int causal,
              int window, int vec, cudaStream_t s) {
  auto kernel = dq_kernel<T, WARPS, BK, NK>;
  const size_t smem = dq_bytes<T>(WARPS, BK, Dk, Dv, Skv);
  const int err = opt_in(kernel, smem);
  if (err) return err;
  const dim3 grid((Sq + 16 * WARPS - 1) / (16 * WARPS), Hq, B);
  kernel<<<grid, WARPS * 32, smem, s>>>(q, k, v, dout, lse, delta, qpos, kpos,
                                        dq, Sq, Skv, Hq, Hkv, Dk, Dv, scale,
                                        softcap, causal, window, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q_, const void* k_, const void* v_, const void* out_,
           const void* dout_, const float* lse, const void* qpos_,
           const void* kpos_, void* dq_, void* dk_, void* dv_, float* delta,
           int B, int Sq, int Skv, int Hq, int Hkv, int Dk, int Dv,
           float scale, float softcap, int causal, int window,
           cudaStream_t s) {
  const T* q = static_cast<const T*>(q_);
  const T* k = static_cast<const T*>(k_);
  const T* v = static_cast<const T*>(v_);
  const T* dout = static_cast<const T*>(dout_);
  const int32_t* qpos = static_cast<const int32_t*>(qpos_);
  const int32_t* kpos = static_cast<const int32_t*>(kpos_);
  T* dq = static_cast<T*>(dq_);
  T* dk = static_cast<T*>(dk_);
  T* dv = static_cast<T*>(dv_);
  const int64_t rows = (int64_t)B * Sq * Hq;
  const int64_t blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  delta_kernel<T><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const T*>(out_), dout, delta, rows, Dv);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int vec = mma::copy_bytes(sizeof(T), {q, k, v, dout}, {Dk, Dv});
  const size_t cap = kMaxSmem;
  // the largest tiles whose staging fits, by shape (bf16 always fits the
  // first plan of each kernel)
  if constexpr (mma::exact<T>()) {
    err = launch_dkdv<T, 4, 64>(q, k, v, dout, lse, delta, qpos, kpos, dk, dv,
                                B, Sq, Skv, Hq, Hkv, Dk, Dv, scale, softcap,
                                causal, window, vec, s);
  } else {   // f32 at 32 rows, as 64 would spill
    if (dkdv_bytes<T>(4, 32, Dk, Dv, Sq) <= cap)
      err = launch_dkdv<T, 4, 32>(q, k, v, dout, lse, delta, qpos, kpos, dk,
                                  dv, B, Sq, Skv, Hq, Hkv, Dk, Dv, scale,
                                  softcap, causal, window, vec, s);
    else
      err = launch_dkdv<T, 2, 16>(q, k, v, dout, lse, delta, qpos, kpos, dk,
                                  dv, B, Sq, Skv, Hq, Hkv, Dk, Dv, scale,
                                  softcap, causal, window, vec, s);
  }
  if (err) return err;
  if constexpr (mma::exact<T>()) {
    return launch_dq<T, 4, 32, 32>(q, k, v, dout, lse, delta, qpos, kpos, dq,
                                   B, Sq, Skv, Hq, Hkv, Dk, Dv, scale, softcap,
                                   causal, window, vec, s);
  } else {   // dQ's columns in 16 n-tiles to Dk 128, else 16-key tiles
    if (Dk <= 64 && dq_bytes<T>(4, 32, Dk, Dv, Skv) <= cap / 2)
      return launch_dq<T, 4, 32, 8>(q, k, v, dout, lse, delta, qpos, kpos, dq,
                                    B, Sq, Skv, Hq, Hkv, Dk, Dv, scale,
                                    softcap, causal, window, vec, s);
    if (Dk <= 128 && dq_bytes<T>(4, 32, Dk, Dv, Skv) <= cap)
      return launch_dq<T, 4, 32, 16>(q, k, v, dout, lse, delta, qpos, kpos,
                                     dq, B, Sq, Skv, Hq, Hkv, Dk, Dv, scale,
                                     softcap, causal, window, vec, s);
    if (dq_bytes<T>(4, 16, Dk, Dv, Skv) <= cap)
      return launch_dq<T, 4, 16, 32>(q, k, v, dout, lse, delta, qpos, kpos,
                                     dq, B, Sq, Skv, Hq, Hkv, Dk, Dv, scale,
                                     softcap, causal, window, vec, s);
    return launch_dq<T, 1, 16, 32>(q, k, v, dout, lse, delta, qpos, kpos, dq,
                                   B, Sq, Skv, Hq, Hkv, Dk, Dv, scale, softcap,
                                   causal, window, vec, s);
  }
}

}  // namespace backward
}  // namespace flash
