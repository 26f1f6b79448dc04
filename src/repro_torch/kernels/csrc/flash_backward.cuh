// The flash-attention backward (FlashAttention-2's algorithm, Dao,
// arXiv:2307.08691, section 3.2) on the fp32 CUDA cores: the input
// gradients of the function every forward variant computes, from the
// forward's output O and its rows' log-sum-exp (lse).  Three kernels, no
// atomics, so two calls give equal bits:
//
// delta: D = rowsum(dO * O) in fp32, one warp a (b, q row, q head).
// dkdv:  one block per (b, kv head, BK-key tile), K and V staged once.  It
//   walks the q tiles of every q head of its GQA group (tiles whose
//   positions hide every key of the block are skipped) and per tile
//   recomputes S^T = K Q^T scale, the softcap, P = exp(S - lse) on the
//   visible keys (causal and window by position, kv positions >= 2^29 are
//   padding, 0 elsewhere), dP^T = V dO^T, dS = P (dP - D) (times 1 - tanh^2
//   under a softcap), then dV += P^T dO and dK += dS^T Q into fp32
//   accumulators in shared memory; dK is scaled once at the end.
// dq:    one block per (b, q head, BQ-row tile) over the key tiles: S and
//   dS again, dQ += dS K, scaled once.
//
// Each gradient is rounded once to its input's type.  Operands are staged
// as fp32 rows in shared memory and multiplied in 4 x 4 micro tiles
// (simt_tile.cuh); the launcher takes the largest tiles whose staging
// fits 227 KB (64 x 64, then 64 x 32, then 32 x 32), so every (Dk, Dv) up
// to (256, 256) runs.  A row that sees no key gets no gradient (its lse
// is -inf, or the forward filled it from hidden keys alone).
#pragma once

#include "flash_common.cuh"
#include "simt_tile.cuh"

namespace flash {
namespace backward {

using simt_tile::micro;
using simt_tile::round4;
using simt_tile::stride_of;

constexpr int kThreads = 256;

__device__ __forceinline__ bool visible(int qp, int kp, int causal,
                                        int window) {
  bool ok = kp < kValidPosLimit;
  if (causal) ok = ok && kp <= qp;
  if (window > 0) ok = ok && kp > qp - window;
  return ok;
}

// One score's probability and dS from its raw product q.k and dO.v.
__device__ __forceinline__ void score_grad(float qk, float dov, float lse,
                                           float delta, bool vis, float scale,
                                           float softcap, float* p,
                                           float* ds) {
  float x = qk * scale, dcap = 1.f;
  if (softcap > 0.f) {
    const float t = tanhf(x / softcap);
    x = softcap * t;
    dcap = 1.f - t * t;
  }
  *p = vis ? expf(x - lse) : 0.f;
  *ds = *p * (dov - delta) * dcap;
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

// shared-memory floats of each kernel's staging (positions count as floats)
__host__ __device__ constexpr size_t dkdv_floats(int BK, int BQ, int Dk,
                                                 int Dv) {
  return (size_t)2 * BK * (stride_of(Dk) + stride_of(Dv))     // K V dK dV
         + (size_t)BQ * (stride_of(Dk) + stride_of(Dv))       // Q dO
         + (size_t)2 * BK * (BQ + 1)                          // P dS
         + 3 * BQ + BK;                                       // lse D qp kp
}

__host__ __device__ constexpr size_t dq_floats(int BQ, int BK, int Dk,
                                               int Dv) {
  return (size_t)2 * BQ * stride_of(Dk) + (size_t)BQ * stride_of(Dv)  // Q dQ dO
         + (size_t)BK * (stride_of(Dk) + stride_of(Dv))               // K V
         + (size_t)BQ * (BK + 1)                                      // dS
         + 3 * BQ + BK;
}

template <typename T, int BK, int BQ>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            const int32_t* __restrict__ qpos,
            const int32_t* __restrict__ kpos, T* __restrict__ dk,
            T* __restrict__ dv, int Sq, int Skv, int Hq, int Hkv, int Dk,
            int Dv, float scale, float softcap, int causal, int window) {
  constexpr int kPS = BQ + 1;             // row stride of P and dS [BK][BQ]
  constexpr int kTiles = (BK / 4) * (BQ / 4);
  const int dks = stride_of(Dk), dvs = stride_of(Dv);
  const int dkc = round4(Dk) / 4, dvc = round4(Dv) / 4;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);   // [BK][dks]
  float* Vs = Ks + BK * dks;                     // [BK][dvs]
  float* dKa = Vs + BK * dvs;                    // [BK][dks]
  float* dVa = dKa + BK * dks;                   // [BK][dvs]
  float* Qs = dVa + BK * dvs;                    // [BQ][dks]
  float* dOs = Qs + BQ * dks;                    // [BQ][dvs]
  float* Ps = dOs + BQ * dvs;                    // [BK][kPS]
  float* dSs = Ps + BK * kPS;                    // [BK][kPS]
  float* lse_s = dSs + BK * kPS;                 // [BQ]
  float* del_s = lse_s + BQ;                     // [BQ]
  int* qp_s = reinterpret_cast<int*>(del_s + BQ);  // [BQ]
  int* kp_s = qp_s + BQ;                         // [BK]

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = Hq / Hkv;
  const int nk = min(BK, Skv - k0);
  const int64_t q_row = (int64_t)Hq * Dk, o_row = (int64_t)Hq * Dv;
  const int64_t k_row = (int64_t)Hkv * Dk, v_row = (int64_t)Hkv * Dv;
  const int64_t kbase = ((int64_t)b * Skv + k0);

  simt_tile::stage<kThreads>(Ks, dks, k + kbase * k_row + (int64_t)hk * Dk,
                             k_row, BK, nk, Dk);
  simt_tile::stage<kThreads>(Vs, dvs, v + kbase * v_row + (int64_t)hk * Dv,
                             v_row, BK, nk, Dv);
  simt_tile::clear<kThreads>(dKa, BK * dks);
  simt_tile::clear<kThreads>(dVa, BK * dvs);
  for (int j = tid; j < BK; j += kThreads)
    kp_s[j] = j < nk ? kpos[(int64_t)b * Skv + k0 + j] : kValidPosLimit;

  for (int hh = 0; hh < group; ++hh) {
    const int h = hk * group + hh;
    for (int q0 = 0; q0 < Sq; q0 += BQ) {
      const int nq = min(BQ, Sq - q0);
      __syncthreads();   // the last tile's readers are done
      for (int i = tid; i < BQ; i += kThreads)
        qp_s[i] = i < nq ? qpos[(int64_t)b * Sq + q0 + i] : 0;
      __syncthreads();
      bool any = false;
      for (int t = tid; t < kTiles; t += kThreads) {
        const int tk = t / (BQ / 4), tj = t % (BQ / 4);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int kk = 4 * tk + i, jj = 4 * tj + j;
            any |= kk < nk && jj < nq &&
                   visible(qp_s[jj], kp_s[kk], causal, window);
          }
      }
      if (!__syncthreads_or(any)) continue;   // no row sees a key here

      const int64_t qbase = (int64_t)b * Sq + q0;
      simt_tile::stage<kThreads>(Qs, dks, q + qbase * q_row + (int64_t)h * Dk,
                                 q_row, BQ, nq, Dk);
      simt_tile::stage<kThreads>(dOs, dvs,
                                 dout + qbase * o_row + (int64_t)h * Dv,
                                 o_row, BQ, nq, Dv);
      for (int i = tid; i < BQ; i += kThreads) {
        const int64_t r = (qbase + i) * Hq + h;
        lse_s[i] = i < nq ? lse[r] : 0.f;
        del_s[i] = i < nq ? delta[r] : 0.f;
      }
      __syncthreads();

      // S^T and dP^T, 4 keys x 4 rows a micro tile -> P and dS
      for (int t = tid; t < kTiles; t += kThreads) {
        const int tk = t / (BQ / 4), tj = t % (BQ / 4);
        float s[4][4], dp[4][4];
        simt_tile::zero(s);
        simt_tile::zero(dp);
        micro(Ks + 4 * tk * dks, dks, 1, Qs + 4 * tj * dks, 1, dks, Dk, s);
        micro(Vs + 4 * tk * dvs, dvs, 1, dOs + 4 * tj * dvs, 1, dvs, Dv, dp);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int kk = 4 * tk + i, jj = 4 * tj + j;
            const bool vis = kk < nk && jj < nq &&
                             visible(qp_s[jj], kp_s[kk], causal, window);
            score_grad(s[i][j], dp[i][j], lse_s[jj], del_s[jj], vis, scale,
                       softcap, &Ps[kk * kPS + jj], &dSs[kk * kPS + jj]);
          }
      }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q, each element owned by one thread
      for (int t = tid; t < (BK / 4) * dvc; t += kThreads) {
        const int tk = t / dvc, tc = t % dvc;
        float c[4][4];
        simt_tile::zero(c);
        micro(Ps + 4 * tk * kPS, kPS, 1, dOs + 4 * tc, dvs, 1, BQ, c);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            dVa[(4 * tk + i) * dvs + 4 * tc + j] += c[i][j];
      }
      for (int t = tid; t < (BK / 4) * dkc; t += kThreads) {
        const int tk = t / dkc, tc = t % dkc;
        float c[4][4];
        simt_tile::zero(c);
        micro(dSs + 4 * tk * kPS, kPS, 1, Qs + 4 * tc, dks, 1, BQ, c);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            dKa[(4 * tk + i) * dks + 4 * tc + j] += c[i][j];
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < nk * Dk; idx += kThreads) {
    const int j = idx / Dk, c = idx - j * Dk;
    dk[(kbase + j) * k_row + (int64_t)hk * Dk + c] =
        from_float<T>(dKa[j * dks + c] * scale);
  }
  for (int idx = tid; idx < nk * Dv; idx += kThreads) {
    const int j = idx / Dv, c = idx - j * Dv;
    dv[(kbase + j) * v_row + (int64_t)hk * Dv + c] =
        from_float<T>(dVa[j * dvs + c]);
  }
}

template <typename T, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          const int32_t* __restrict__ qpos, const int32_t* __restrict__ kpos,
          T* __restrict__ dq, int Sq, int Skv, int Hq, int Hkv, int Dk, int Dv,
          float scale, float softcap, int causal, int window) {
  constexpr int kSS = BK + 1;             // row stride of dS [BQ][BK]
  constexpr int kTiles = (BQ / 4) * (BK / 4);
  const int dks = stride_of(Dk), dvs = stride_of(Dv);
  const int dkc = round4(Dk) / 4;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [BQ][dks]
  float* dQa = Qs + BQ * dks;                    // [BQ][dks]
  float* dOs = dQa + BQ * dks;                   // [BQ][dvs]
  float* Ks = dOs + BQ * dvs;                    // [BK][dks]
  float* Vs = Ks + BK * dks;                     // [BK][dvs]
  float* dSs = Vs + BK * dvs;                    // [BQ][kSS]
  float* lse_s = dSs + BQ * kSS;                 // [BQ]
  float* del_s = lse_s + BQ;                     // [BQ]
  int* qp_s = reinterpret_cast<int*>(del_s + BQ);  // [BQ]
  int* kp_s = qp_s + BQ;                         // [BK]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int nq = min(BQ, Sq - q0);
  const int64_t q_row = (int64_t)Hq * Dk, o_row = (int64_t)Hq * Dv;
  const int64_t k_row = (int64_t)Hkv * Dk, v_row = (int64_t)Hkv * Dv;
  const int64_t qbase = (int64_t)b * Sq + q0;

  simt_tile::stage<kThreads>(Qs, dks, q + qbase * q_row + (int64_t)h * Dk,
                             q_row, BQ, nq, Dk);
  simt_tile::stage<kThreads>(dOs, dvs, dout + qbase * o_row + (int64_t)h * Dv,
                             o_row, BQ, nq, Dv);
  simt_tile::clear<kThreads>(dQa, BQ * dks);
  for (int i = tid; i < BQ; i += kThreads) {
    const int64_t r = (qbase + i) * Hq + h;
    lse_s[i] = i < nq ? lse[r] : 0.f;
    del_s[i] = i < nq ? delta[r] : 0.f;
    qp_s[i] = i < nq ? qpos[qbase + i] : 0;
  }

  for (int k0 = 0; k0 < Skv; k0 += BK) {
    const int nk = min(BK, Skv - k0);
    __syncthreads();   // the last tile's readers are done
    for (int j = tid; j < BK; j += kThreads)
      kp_s[j] = j < nk ? kpos[(int64_t)b * Skv + k0 + j] : kValidPosLimit;
    __syncthreads();
    bool any = false;
    for (int t = tid; t < kTiles; t += kThreads) {
      const int tj = t / (BK / 4), tk = t % (BK / 4);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int jj = 4 * tj + j, kk = 4 * tk + i;
          any |= kk < nk && jj < nq &&
                 visible(qp_s[jj], kp_s[kk], causal, window);
        }
    }
    if (!__syncthreads_or(any)) continue;   // no row sees a key here

    const int64_t kbase = (int64_t)b * Skv + k0;
    simt_tile::stage<kThreads>(Ks, dks, k + kbase * k_row + (int64_t)hk * Dk,
                               k_row, BK, nk, Dk);
    simt_tile::stage<kThreads>(Vs, dvs, v + kbase * v_row + (int64_t)hk * Dv,
                               v_row, BK, nk, Dv);
    __syncthreads();

    // S and dP, 4 rows x 4 keys a micro tile -> dS
    for (int t = tid; t < kTiles; t += kThreads) {
      const int tj = t / (BK / 4), tk = t % (BK / 4);
      float s[4][4], dp[4][4];
      simt_tile::zero(s);
      simt_tile::zero(dp);
      micro(Qs + 4 * tj * dks, dks, 1, Ks + 4 * tk * dks, 1, dks, Dk, s);
      micro(dOs + 4 * tj * dvs, dvs, 1, Vs + 4 * tk * dvs, 1, dvs, Dv, dp);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int jj = 4 * tj + j, kk = 4 * tk + i;
          const bool vis = kk < nk && jj < nq &&
                           visible(qp_s[jj], kp_s[kk], causal, window);
          float p;
          score_grad(s[j][i], dp[j][i], lse_s[jj], del_s[jj], vis, scale,
                     softcap, &p, &dSs[jj * kSS + kk]);
        }
    }
    __syncthreads();

    // dQ += dS K, each element owned by one thread
    for (int t = tid; t < (BQ / 4) * dkc; t += kThreads) {
      const int tj = t / dkc, tc = t % dkc;
      float c[4][4];
      simt_tile::zero(c);
      micro(dSs + 4 * tj * kSS, kSS, 1, Ks + 4 * tc, dks, 1, BK, c);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dQa[(4 * tj + j) * dks + 4 * tc + i] += c[j][i];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < nq * Dk; idx += kThreads) {
    const int i = idx / Dk, c = idx - i * Dk;
    dq[(qbase + i) * q_row + (int64_t)h * Dk + c] =
        from_float<T>(dQa[i * dks + c] * scale);
  }
}

// -- host side ------------------------------------------------------------------

template <typename K>
int opt_in(K kernel, size_t smem) {
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int BK, int BQ>
int launch_dkdv(const T* q, const T* k, const T* v, const T* dout,
                const float* lse, const float* delta, const int32_t* qpos,
                const int32_t* kpos, T* dk, T* dv, int B, int Sq, int Skv,
                int Hq, int Hkv, int Dk, int Dv, float scale, float softcap,
                int causal, int window, cudaStream_t s) {
  auto kernel = dkdv_kernel<T, BK, BQ>;
  const size_t smem = sizeof(float) * dkdv_floats(BK, BQ, Dk, Dv);
  const int err = opt_in(kernel, smem);
  if (err) return err;
  const dim3 grid((Skv + BK - 1) / BK, Hkv, B);
  kernel<<<grid, kThreads, smem, s>>>(q, k, v, dout, lse, delta, qpos, kpos,
                                      dk, dv, Sq, Skv, Hq, Hkv, Dk, Dv, scale,
                                      softcap, causal, window);
  return (int)cudaGetLastError();
}

template <typename T, int BQ, int BK>
int launch_dq(const T* q, const T* k, const T* v, const T* dout,
              const float* lse, const float* delta, const int32_t* qpos,
              const int32_t* kpos, T* dq, int B, int Sq, int Skv, int Hq,
              int Hkv, int Dk, int Dv, float scale, float softcap, int causal,
              int window, cudaStream_t s) {
  auto kernel = dq_kernel<T, BQ, BK>;
  const size_t smem = sizeof(float) * dq_floats(BQ, BK, Dk, Dv);
  const int err = opt_in(kernel, smem);
  if (err) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  kernel<<<grid, kThreads, smem, s>>>(q, k, v, dout, lse, delta, qpos, kpos,
                                      dq, Sq, Skv, Hq, Hkv, Dk, Dv, scale,
                                      softcap, causal, window);
  return (int)cudaGetLastError();
}

// the tile plan (0: 64 x 64, 1: 64 x 32, 2: 32 x 32) the launcher takes for
// these head dims: the largest whose staging fits 227 KB
inline int tile_plan(int Dk, int Dv) {
  const size_t cap = kMaxSmem / sizeof(float);
  if (dkdv_floats(64, 64, Dk, Dv) <= cap && dq_floats(64, 64, Dk, Dv) <= cap)
    return 0;
  if (dkdv_floats(64, 32, Dk, Dv) <= cap && dq_floats(32, 64, Dk, Dv) <= cap)
    return 1;
  return 2;
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
  switch (tile_plan(Dk, Dv)) {
    case 0:
      err = launch_dkdv<T, 64, 64>(q, k, v, dout, lse, delta, qpos, kpos, dk,
                                   dv, B, Sq, Skv, Hq, Hkv, Dk, Dv, scale,
                                   softcap, causal, window, s);
      if (err) return err;
      return launch_dq<T, 64, 64>(q, k, v, dout, lse, delta, qpos, kpos, dq,
                                  B, Sq, Skv, Hq, Hkv, Dk, Dv, scale, softcap,
                                  causal, window, s);
    case 1:
      err = launch_dkdv<T, 64, 32>(q, k, v, dout, lse, delta, qpos, kpos, dk,
                                   dv, B, Sq, Skv, Hq, Hkv, Dk, Dv, scale,
                                   softcap, causal, window, s);
      if (err) return err;
      return launch_dq<T, 32, 64>(q, k, v, dout, lse, delta, qpos, kpos, dq,
                                  B, Sq, Skv, Hq, Hkv, Dk, Dv, scale, softcap,
                                  causal, window, s);
    default:
      err = launch_dkdv<T, 32, 32>(q, k, v, dout, lse, delta, qpos, kpos, dk,
                                   dv, B, Sq, Skv, Hq, Hkv, Dk, Dv, scale,
                                   softcap, causal, window, s);
      if (err) return err;
      return launch_dq<T, 32, 32>(q, k, v, dout, lse, delta, qpos, kpos, dq,
                                  B, Sq, Skv, Hq, Hkv, Dk, Dv, scale, softcap,
                                  causal, window, s);
  }
}

}  // namespace backward
}  // namespace flash
