// The SIMT variant of the SSD scan (simt): f32, and every shape the
// tensor-core variant does not take.  See ssd_scan.cu for the design
// notes; this file holds PR 12's kernel, unchanged, and its launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ssd {
namespace simt {

constexpr int kThreads = 256;
constexpr int kT = 64;          // rows of a strip, columns of a tile
constexpr int kTS = kT + 4;     // padded row stride of transposed tiles
constexpr int kPMax = 64;       // head_dim the kernel takes at most
constexpr int kSP = kPMax + 4;  // padded row stride over p
constexpr int kNMax = 128;      // d_state the kernel takes at most
constexpr int kMaxSmem = 232448;

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

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// shared-memory floats: state, C strip, B tile, x tiles, W, dt, dacum
__host__ __device__ constexpr int region_b(int n) {
  return n * kTS > kT * (n + 4) ? n * kTS : kT * (n + 4);
}
__host__ __device__ constexpr size_t smem_floats(int hb, int n, int l) {
  return (size_t)hb * n * kSP + (size_t)n * kTS + region_b(n) +
         (size_t)hb * kT * kSP + (size_t)kT * kTS + 2 * (size_t)hb * l;
}

template <typename T, int HB>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a, const T* __restrict__ bm,
           const T* __restrict__ cm, const float* __restrict__ h0,
           T* __restrict__ y, float* __restrict__ hout, int S, int H, int P,
           int N, int L) {
  extern __shared__ float4 smem4[];
  float* St = reinterpret_cast<float*>(smem4);   // [HB][N][kSP]  state^T
  float* Ct = St + HB * N * kSP;                 // [N][kTS]      C strip^T
  float* Bt = Ct + N * kTS;                      // [N][kTS] B^T, or [kT][N+4]
  float* Xs = Bt + region_b(N);                  // [HB][kT][kSP]
  float* Wt = Xs + HB * kT * kSP;                // [kT(j)][kTS(i)]
  float* dts = Wt + kT * kTS;                    // [HB][L]
  float* dac = dts + HB * L;                     // [HB][L]

  const int tid = threadIdx.x;
  const int tx = tid % 16;   // columns 4tx..4tx+3 (j, or p)
  const int ty = tid / 16;   // rows 4ty..4ty+3 (i), or p rows in the update
  const int hh0 = blockIdx.x * HB;
  const int b = blockIdx.y;
  const int nc = S / L;
  const int NS = N + 4;      // row stride of B in the state update

  for (int idx = tid; idx < HB * N * kPMax; idx += kThreads) {
    const int hl = idx / (N * kPMax);
    const int rem = idx - hl * N * kPMax;
    const int p = rem / N, n = rem - p * N;
    St[(hl * N + n) * kSP + p] =
        p < P ? h0[(((int64_t)b * H + hh0 + hl) * P + p) * N + n] : 0.f;
  }

  for (int c = 0; c < nc; ++c) {
    const int64_t t0 = (int64_t)b * S + (int64_t)c * L;  // first row
    __syncthreads();  // the previous chunk's state update is done
    for (int idx = tid; idx < HB * L; idx += kThreads) {
      const int hl = idx / L, l = idx - hl * L;
      dts[idx] = dt[(t0 + l) * H + hh0 + hl];
    }
    __syncthreads();
    if (tid < HB) {
      const float ah = a[hh0 + tid];
      float run = 0.f;
      for (int l = 0; l < L; ++l) {
        run += dts[tid * L + l] * ah;
        dac[tid * L + l] = run;
      }
    }

    // --- outputs, one 64-row strip at a time --------------------------------
    for (int i0 = 0; i0 < L; i0 += kT) {
      __syncthreads();  // dacum written; the last strip's readers are done
      for (int idx = tid; idx < kT * N; idx += kThreads) {
        const int i = idx / N, n = idx - i * N;
        Ct[n * kTS + i] = i0 + i < L ? to_float(cm[(t0 + i0 + i) * N + n])
                                     : 0.f;
      }
      __syncthreads();

      // carried-state term: exp(dacum[i]) * C[i] . state[p]
      float yacc[HB][4][4];
#pragma unroll
      for (int hl = 0; hl < HB; ++hl) {
        float s[4][4] = {};
        const float* sth = St + hl * N * kSP;
        for (int n = 0; n < N; ++n) {
          const float4 cv = ld4(Ct + n * kTS + 4 * ty);
          const float4 sv = ld4(sth + n * kSP + 4 * tx);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[r][e] = fmaf(lane(cv, r), lane(sv, e), s[r][e]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + 4 * ty + r;
          const float g = i < L ? expf(dac[hl * L + i]) : 0.f;
#pragma unroll
          for (int e = 0; e < 4; ++e) yacc[hl][r][e] = s[r][e] * g;
        }
      }

      // intra-chunk term, column tiles up to the diagonal
      for (int j0 = 0; j0 <= i0; j0 += kT) {
        __syncthreads();  // the last tile's readers of Bt / Xs / Wt are done
        for (int idx = tid; idx < kT * N; idx += kThreads) {
          const int j = idx / N, n = idx - j * N;
          Bt[n * kTS + j] = j0 + j < L ? to_float(bm[(t0 + j0 + j) * N + n])
                                       : 0.f;
        }
        for (int idx = tid; idx < HB * kT * kPMax; idx += kThreads) {
          const int hl = idx / (kT * kPMax);
          const int rem = idx - hl * kT * kPMax;
          const int j = rem / kPMax, p = rem - j * kPMax;
          Xs[(hl * kT + j) * kSP + p] =
              j0 + j < L && p < P
                  ? to_float(x[((t0 + j0 + j) * H + hh0 + hl) * P + p])
                  : 0.f;
        }
        __syncthreads();

        float cb[4][4] = {};
        for (int n = 0; n < N; ++n) {
          const float4 cv = ld4(Ct + n * kTS + 4 * ty);
          const float4 bv = ld4(Bt + n * kTS + 4 * tx);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              cb[r][e] = fmaf(lane(cv, r), lane(bv, e), cb[r][e]);
        }

#pragma unroll
        for (int hl = 0; hl < HB; ++hl) {
          const float* dach = dac + hl * L;
          const float* dth = dts + hl * L;
          __syncthreads();  // the previous head's readers of Wt are done
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = j0 + 4 * tx + e;
            float w[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int i = i0 + 4 * ty + r;
              w[r] = j <= i && i < L
                         ? cb[r][e] * expf(dach[i] - dach[j]) * dth[j]
                         : 0.f;
            }
            *reinterpret_cast<float4*>(Wt + (4 * tx + e) * kTS + 4 * ty) =
                make_float4(w[0], w[1], w[2], w[3]);
          }
          __syncthreads();
          const float* xh = Xs + hl * kT * kSP;
          for (int j = 0; j < kT; ++j) {
            const float4 wv = ld4(Wt + j * kTS + 4 * ty);
            const float4 xv = ld4(xh + j * kSP + 4 * tx);
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                yacc[hl][r][e] = fmaf(lane(wv, r), lane(xv, e),
                                      yacc[hl][r][e]);
          }
        }
      }

#pragma unroll
      for (int hl = 0; hl < HB; ++hl)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + 4 * ty + r;
          if (i >= L) continue;
          T* yr = y + ((t0 + i) * H + hh0 + hl) * P;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int p = 4 * tx + e;
            if (p < P) yr[p] = from_float<T>(yacc[hl][r][e]);
          }
        }
    }

    // --- state update: state * exp(dacum[L-1]) + (x * tail * dt)^T . B -------
    float* Bs = Bt;   // [kT][NS], row-major this time
    float* Xd = Xs;   // [kT][kSP], one head at a time
#pragma unroll
    for (int hl = 0; hl < HB; ++hl) {
      const float* dach = dac + hl * L;
      const float* dth = dts + hl * L;
      const float last = dach[L - 1];
      float upd[4][8] = {};
      for (int j0 = 0; j0 < L; j0 += kT) {
        __syncthreads();
        for (int idx = tid; idx < kT * N; idx += kThreads) {
          const int j = idx / N, n = idx - j * N;
          Bs[j * NS + n] = j0 + j < L ? to_float(bm[(t0 + j0 + j) * N + n])
                                      : 0.f;
        }
        for (int idx = tid; idx < kT * kPMax; idx += kThreads) {
          const int j = idx / kPMax, p = idx - j * kPMax;
          const int jj = j0 + j;
          Xd[j * kSP + p] =
              jj < L && p < P
                  ? to_float(x[((t0 + jj) * H + hh0 + hl) * P + p]) *
                        (expf(last - dach[jj]) * dth[jj])
                  : 0.f;
        }
        __syncthreads();
        for (int j = 0; j < kT; ++j) {
          const float4 xv = ld4(Xd + j * kSP + 4 * ty);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int n0 = 64 * half + 4 * tx;
            if (n0 >= N) continue;
            const float4 bv = ld4(Bs + j * NS + n0);
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                upd[r][4 * half + e] =
                    fmaf(lane(xv, r), lane(bv, e), upd[r][4 * half + e]);
          }
        }
      }
      const float decay = expf(last);
      float* sth = St + hl * N * kSP;
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = 64 * half + 4 * tx + e;
          if (n >= N) continue;
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int p = 4 * ty + r;
            sth[n * kSP + p] = sth[n * kSP + p] * decay + upd[r][4 * half + e];
          }
        }
    }
  }

  __syncthreads();
  for (int idx = tid; idx < HB * P * N; idx += kThreads) {
    const int hl = idx / (P * N);
    const int rem = idx - hl * P * N;
    const int p = rem / N, n = rem - p * N;
    hout[(((int64_t)b * H + hh0 + hl) * P + p) * N + n] =
        St[(hl * N + n) * kSP + p];
  }
}

template <typename T, int HB>
int launch(const void* x, const void* dt, const void* a, const void* bm,
           const void* cm, const void* h0, void* y, void* hout, int B, int S,
           int H, int P, int N, int L, cudaStream_t stream) {
  auto kernel = ssd_kernel<T, HB>;
  const size_t smem = sizeof(float) * smem_floats(HB, N, L);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  static bool configured = false;  // one opt-in per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid(H / HB, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<const float*>(h0),
      static_cast<T*>(y), static_cast<float*>(hout), S, H, P, N, L);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hb(const void* x, const void* dt, const void* a, const void* bm,
                const void* cm, const void* h0, void* y, void* hout, int B,
                int S, int H, int P, int N, int L, int hb,
                cudaStream_t stream) {
  if (hb == 1)
    return launch<T, 1>(x, dt, a, bm, cm, h0, y, hout, B, S, H, P, N, L,
                        stream);
  if (hb == 2)
    return launch<T, 2>(x, dt, a, bm, cm, h0, y, hout, B, S, H, P, N, L,
                        stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace simt
}  // namespace ssd
