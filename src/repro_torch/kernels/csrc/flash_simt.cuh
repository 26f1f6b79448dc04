// The SIMT variant: one block per (batch, q head, tile of BQ query rows),
// fp32 CUDA cores throughout.  It serves f32 prefill and the head dims the
// tensor-core and split-KV variants do not take (see flash_attention.cu).
#pragma once

#include "flash_common.cuh"

namespace flash {
namespace simt {

constexpr int kBK = 64;        // keys per kv tile
constexpr int kPad = 4;        // row padding of the staged tiles (elements)

template <int BQ, int DV_CHUNKS, typename T>
constexpr size_t smem_bytes(int dk) {
  return sizeof(float) * BQ * (kBK + kPad)              // probabilities
         + sizeof(T) * dk * (BQ + kPad)                 // q, transposed
         + sizeof(T) * dk * (kBK + kPad)                // k, transposed
         + sizeof(T) * kBK * 64 * DV_CHUNKS             // v
         + sizeof(int) * (BQ + kBK);                    // positions
}

template <typename T, int BQ, int DV_CHUNKS>
__global__ void __launch_bounds__((BQ / 4) * (kBK / 4))
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int32_t* __restrict__ qpos,
             const int32_t* __restrict__ kpos, T* __restrict__ out,
             float* __restrict__ lse, int Sq, int Skv, int Hq, int Hkv,
             int Dk, int Dv, float scale, float softcap, int causal,
             int window) {
  constexpr int kThreads = (BQ / 4) * (kBK / 4);
  constexpr int kQS = BQ + kPad;       // row stride of the staged q
  constexpr int kKS = kBK + kPad;      // row stride of staged k and of p
  constexpr int kVS = 64 * DV_CHUNKS;  // row stride of the staged v
  extern __shared__ float4 smem4[];
  float* Ps = reinterpret_cast<float*>(smem4);              // [BQ][kKS]
  T* Qt = reinterpret_cast<T*>(Ps + BQ * kKS);              // [Dk][kQS]
  T* Kt = Qt + Dk * kQS;                                    // [Dk][kKS]
  T* Vs = Kt + Dk * kKS;                                    // [kBK][kVS]
  int* qp_s = reinterpret_cast<int*>(Vs + kBK * kVS);       // [BQ]
  int* kp_s = qp_s + BQ;                                    // [kBK]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int64_t q_row = (int64_t)Hq * Dk;
  const int64_t k_row = (int64_t)Hkv * Dk;
  const int64_t v_row = (int64_t)Hkv * Dv;

  const T* qb = q + ((int64_t)b * Sq + q0) * q_row + (int64_t)h * Dk;
  for (int idx = tid; idx < BQ * Dk; idx += kThreads) {
    const int i = idx / Dk, d = idx - i * Dk;
    Qt[d * kQS + i] = q0 + i < Sq ? qb[i * q_row + d] : from_float<T>(0.f);
  }
  for (int i = tid; i < BQ; i += kThreads)
    qp_s[i] = q0 + i < Sq ? qpos[(int64_t)b * Sq + q0 + i] : 0;

  float m_i[4], l_i[4], acc[4][4 * DV_CHUNKS];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m_i[r] = kNegInf;
    l_i[r] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * DV_CHUNKS; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = 0; k0 < Skv; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int j = tid; j < kBK; j += kThreads)
      kp_s[j] = k0 + j < Skv ? kpos[(int64_t)b * Skv + k0 + j]
                             : kValidPosLimit;
    __syncthreads();

    bool vis[4][4];
    bool any = false;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = 4 * ty + r;
      const int qp = qp_s[row];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kp = kp_s[4 * tx + c];
        bool ok = q0 + row < Sq && kp < kValidPosLimit;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        vis[r][c] = ok;
        any |= ok;
      }
    }
    if (!__syncthreads_or(any)) continue;  // the whole tile is hidden

    const T* kb = k + ((int64_t)b * Skv + k0) * k_row + (int64_t)hk * Dk;
    const T* vb = v + ((int64_t)b * Skv + k0) * v_row + (int64_t)hk * Dv;
    for (int idx = tid; idx < kBK * Dk; idx += kThreads) {
      const int j = idx / Dk, d = idx - j * Dk;
      Kt[d * kKS + j] = k0 + j < Skv ? kb[j * k_row + d] : from_float<T>(0.f);
    }
    for (int idx = tid; idx < kBK * kVS; idx += kThreads) {
      const int j = idx / kVS, c = idx - j * kVS;
      Vs[j * kVS + c] = k0 + j < Skv && c < Dv ? vb[j * v_row + c]
                                               : from_float<T>(0.f);
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
    for (int d = 0; d < Dk; ++d) {
      const float4 qv = load4(Qt + d * kQS + 4 * ty);
      const float4 kv = load4(Kt + d * kKS + 4 * tx);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          s[r][c] = fmaf(lane(qv, r), lane(kv, c), s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[r][c] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        // keys past the end take no part; hidden keys take NEG_INF
        x = vis[r][c] ? x : (k0 + 4 * tx + c < Skv ? kNegInf : -INFINITY);
        s[r][c] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[r], mx);
      const float alpha = expf(m_i[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = expf(s[r][c] - m_new);
        sum += s[r][c];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_i[r] = l_i[r] * alpha + sum;
      m_i[r] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * DV_CHUNKS; ++c) acc[r][c] *= alpha;
      *reinterpret_cast<float4*>(Ps + (4 * ty + r) * kKS + 4 * tx) =
          make_float4(s[r][0], s[r][1], s[r][2], s[r][3]);
    }
    __syncthreads();

    for (int j = 0; j < kBK; j += 4) {
      float4 pr[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pr[r] = *reinterpret_cast<const float4*>(Ps + (4 * ty + r) * kKS + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int cc = 0; cc < DV_CHUNKS; ++cc) {
          const float4 vv = load4(Vs + (j + jj) * kVS + 64 * cc + 4 * tx);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float p = lane(pr[r], jj);
            acc[r][4 * cc + 0] = fmaf(p, vv.x, acc[r][4 * cc + 0]);
            acc[r][4 * cc + 1] = fmaf(p, vv.y, acc[r][4 * cc + 1]);
            acc[r][4 * cc + 2] = fmaf(p, vv.z, acc[r][4 * cc + 2]);
            acc[r][4 * cc + 3] = fmaf(p, vv.w, acc[r][4 * cc + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + 4 * ty + r;
    if (row >= Sq) continue;
    const float safe = l_i[r] > 0.f ? l_i[r] : 1.f;
    T* orow = out + ((int64_t)b * Sq + row) * Hq * Dv + (int64_t)h * Dv;
#pragma unroll
    for (int cc = 0; cc < DV_CHUNKS; ++cc)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 64 * cc + 4 * tx + e;
        if (c < Dv) orow[c] = from_float<T>(acc[r][4 * cc + e] / safe);
      }
    // on request, the row's log-sum-exp (-inf where no key reached it)
    if (lse != nullptr && tx == 0)
      lse[((int64_t)b * Sq + row) * Hq + h] =
          l_i[r] > 0.f ? m_i[r] + logf(l_i[r]) : -INFINITY;
  }
}

template <typename T, int BQ, int DV_CHUNKS>
int launch(const void* q, const void* k, const void* v, const void* qpos,
           const void* kpos, void* out, float* lse, int B, int Sq, int Skv,
           int Hq, int Hkv, int Dk, int Dv, float scale, float softcap,
           int causal, int window, cudaStream_t stream) {
  auto kernel = flash_kernel<T, BQ, DV_CHUNKS>;
  const size_t smem = smem_bytes<BQ, DV_CHUNKS, T>(Dk);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  static bool configured = false;  // one opt-in per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  kernel<<<grid, (BQ / 4) * (kBK / 4), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(qpos),
      static_cast<const int32_t*>(kpos), static_cast<T*>(out), lse, Sq, Skv,
      Hq, Hkv, Dk, Dv, scale, softcap, causal, window);
  return (int)cudaGetLastError();
}

template <typename T, int BQ>
int dispatch_dv(const void* q, const void* k, const void* v, const void* qpos,
                const void* kpos, void* out, float* lse, int B, int Sq,
                int Skv, int Hq, int Hkv, int Dk, int Dv, float scale,
                float softcap, int causal, int window, cudaStream_t stream) {
  switch ((Dv + 63) / 64) {
    case 1:
      return launch<T, BQ, 1>(q, k, v, qpos, kpos, out, lse, B, Sq, Skv, Hq,
                              Hkv, Dk, Dv, scale, softcap, causal, window,
                              stream);
    case 2:
      return launch<T, BQ, 2>(q, k, v, qpos, kpos, out, lse, B, Sq, Skv, Hq,
                              Hkv, Dk, Dv, scale, softcap, causal, window,
                              stream);
    case 3:
      return launch<T, BQ, 3>(q, k, v, qpos, kpos, out, lse, B, Sq, Skv, Hq,
                              Hkv, Dk, Dv, scale, softcap, causal, window,
                              stream);
    case 4:
      return launch<T, BQ, 4>(q, k, v, qpos, kpos, out, lse, B, Sq, Skv, Hq,
                              Hkv, Dk, Dv, scale, softcap, causal, window,
                              stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// lse: null, or fp32 [B, Sq, Hq] for the rows' log-sum-exp
template <typename T>
int dispatch_bq(const void* q, const void* k, const void* v, const void* qpos,
                const void* kpos, void* out, float* lse, int B, int Sq,
                int Skv, int Hq, int Hkv, int Dk, int Dv, float scale,
                float softcap, int causal, int window, cudaStream_t stream) {
  if (Sq <= 16)
    return dispatch_dv<T, 16>(q, k, v, qpos, kpos, out, lse, B, Sq, Skv, Hq,
                              Hkv, Dk, Dv, scale, softcap, causal, window,
                              stream);
  return dispatch_dv<T, 64>(q, k, v, qpos, kpos, out, lse, B, Sq, Skv, Hq,
                            Hkv, Dk, Dv, scale, softcap, causal, window,
                            stream);
}

}  // namespace simt
}  // namespace flash
