// The SSD scan's backward (n_groups == 1) on the fp32 CUDA cores: the
// gradients of the chunked scan ssd_scan.cu computes, for every shape either
// forward variant takes.  For one head and a chunk of length L, dacum =
// cumsum(dt * a), M[l, m] = exp(dacum[l] - dacum[m]) for m <= l (0 above),
// r[m] = exp(dacum[L-1] - dacum[m]) and h_in the state entering the chunk:
//   y[l]  = sum_m (C[l] . B[m]) M[l, m] dt[m] x[m] + exp(dacum[l]) C[l] h_in
//   h_out = exp(dacum[L-1]) h_in + sum_m r[m] dt[m] x[m] (x) B[m]
// Given dy and the final state's gradient dfinal, in three phases:
//
// (i) the fp32 state entering each chunk, [B, nc, H, P, N], into scratch:
//   own_kernel (mode 0) sums each chunk's own state, sum_m r[m] dt[m] x[m]
//   (x) B[m], per (b, chunk, head) and its log decay dacum[L-1]; scan_kernel
//   carries h0 through them, one thread per (b, head, state element).
// (ii) the reverse pass: dh entering chunk c is exp(dacum_c[L-1]) dh(c + 1)
//   + sum_l exp(dacum[l]) dy[l] (x) C[l], from dfinal: own_kernel (mode 1)
//   then scan_kernel backwards, which leaves in scratch the gradient of the
//   state leaving each chunk and writes dh0.
// (iii) chunk_kernel, per (b, chunk, head), in 64-row tiles: pass A walks
//   the row tiles l (each against the column tiles m <= l) for dC and the
//   row side of d(dacum); pass B walks the column tiles m (against l >= m)
//   for dx, dB, the direct part of ddt and the column side of d(dacum); the
//   carried state's terms close each tile.  d(da) is d(dacum) summed from the
//   end; ddt += a d(da) and the chunk's part of da is sum dt d(da).
// Then reduce_kernel sums dB and dC over the heads, and da_kernel da over
// (b, chunk), each in a fixed order: no atomics, so two calls give equal
// bits.  Every product runs on fp32 operands staged in shared memory
// (simt_tile.cuh), and each gradient is rounded once to its input's type.
#pragma once

#include <math.h>

#include "simt_tile.cuh"

namespace ssd {
namespace backward {

using simt_tile::micro;
using simt_tile::round4;
using simt_tile::stride_of;

constexpr int kThreads = 256;
constexpr int kTL = 64;            // rows of a tile
constexpr int kTS = kTL + 1;       // row stride of a [kTL][kTL] tile
constexpr int kPMax = 64;
constexpr int kNMax = 128;
constexpr int kMaxSmem = 232448;

// dacum over one chunk by one thread: cum[i] = sum_{j <= i} dt[j] * a
__device__ __forceinline__ void chunk_cumsum(const float* dt, int64_t stride,
                                             float a, int L, float* dtv,
                                             float* cum) {
  if (threadIdx.x == 0) {
    float c = 0.f;
    for (int i = 0; i < L; ++i) {
      const float d = dt[i * stride];
      dtv[i] = d;
      c += d * a;
      cum[i] = c;
    }
  }
}

__host__ __device__ constexpr size_t own_floats(int L, int P, int N) {
  return (size_t)2 * L + (size_t)kTL * (stride_of(P) + stride_of(N)) +
         (size_t)P * stride_of(N);
}

// MODE 0: out = sum_m r[m] dt[m] x[m] (x) B[m]; MODE 1: out = sum_l
// exp(dacum[l]) dy[l] (x) C[l].  out [B, nc, H, P, N]; declog (unless null)
// = dacum[L-1].
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
own_kernel(const T* __restrict__ xs_in, const float* __restrict__ dt,
           const float* __restrict__ a, const T* __restrict__ ys_in,
           float* __restrict__ out, float* __restrict__ declog, int S, int H,
           int P, int N, int L) {
  const int xs = stride_of(P), ns = stride_of(N);
  const int pc = round4(P) / 4, nc4 = round4(N) / 4;
  extern __shared__ float4 smem4[];
  float* dtv = reinterpret_cast<float*>(smem4);   // [L]
  float* cum = dtv + L;                           // [L]
  float* Xs = cum + L;                            // [kTL][xs] weighted rows
  float* Ys = Xs + kTL * xs;                      // [kTL][ns]
  float* acc = Ys + kTL * ns;                     // [P][ns]
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int nchunks = gridDim.y;
  const int64_t t0 = (int64_t)b * S + (int64_t)c * L;   // first step
  chunk_cumsum(dt + t0 * H + h, H, a[h], L, dtv, cum);
  simt_tile::clear<kThreads>(acc, P * ns);
  __syncthreads();
  const float last = cum[L - 1];
  for (int l0 = 0; l0 < L; l0 += kTL) {
    const int nl = min(kTL, L - l0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < kTL * round4(P); idx += kThreads) {
      const int r = idx / round4(P), p = idx - r * round4(P);
      float v = 0.f;
      if (r < nl && p < P) {
        const int l = l0 + r;
        const float w = MODE == 0 ? expf(last - cum[l]) * dtv[l]
                                  : expf(cum[l]);
        v = w * simt_tile::as_float(xs_in[((t0 + l) * H + h) * P + p]);
      }
      Xs[r * xs + p] = v;
    }
    simt_tile::stage<kThreads>(Ys, ns, ys_in + (t0 + l0) * N, N, kTL, nl, N);
    __syncthreads();
    for (int t = threadIdx.x; t < pc * nc4; t += kThreads) {
      const int tp = t / nc4, tn = t % nc4;
      float o[4][4];
      simt_tile::zero(o);
      micro(Xs + 4 * tp, 1, xs, Ys + 4 * tn, ns, 1, kTL, o);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (4 * tp + i < P) acc[(4 * tp + i) * ns + 4 * tn + j] += o[i][j];
    }
  }
  __syncthreads();
  float* dst = out + (((int64_t)b * nchunks + c) * H + h) * P * N;
  for (int idx = threadIdx.x; idx < P * N; idx += kThreads) {
    const int p = idx / N, n = idx - p * N;
    dst[idx] = acc[p * ns + n];
  }
  if (declog != nullptr && threadIdx.x == 0)
    declog[((int64_t)b * nchunks + c) * H + h] = last;
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

__host__ __device__ constexpr size_t chunk_floats(int L, int P, int N) {
  return (size_t)5 * L + (size_t)3 * kTL * stride_of(P) +
         (size_t)3 * kTL * stride_of(N) + (size_t)3 * kTL * kTS + kThreads;
}

// (iii): per (b, chunk, head).  entering / gout: [B, nc, H, P, N] from (i)
// and (ii).  Writes dx, ddt and the per-head partials dBp / dCp [B, nc, H,
// L, N] and dap [B, nc, H].
template <typename T>
__global__ void __launch_bounds__(kThreads)
chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ a, const T* __restrict__ bm,
             const T* __restrict__ cm, const T* __restrict__ dy,
             const float* __restrict__ entering,
             const float* __restrict__ gout, T* __restrict__ dx,
             float* __restrict__ ddt, float* __restrict__ dBp,
             float* __restrict__ dCp, float* __restrict__ dap, int S, int H,
             int P, int N, int L) {
  const int xs = stride_of(P), ns = stride_of(N);
  const int pc = round4(P) / 4, nc4 = round4(N) / 4;
  constexpr int kT4 = kTL / 4;
  extern __shared__ float4 smem4[];
  float* dtv = reinterpret_cast<float*>(smem4);   // [L]
  float* cum = dtv + L;                           // [L]
  float* dcum = cum + L;                          // [L] d(dacum)
  float* ecol = dcum + L;                         // [L] ddt's diagonal part
  float* fd = ecol + L;                           // [L] ddt's state part
  float* A1 = fd + L;                             // [kTL][xs] dy rows l
  float* B1 = A1 + kTL * xs;                      // [kTL][xs] x rows m
  float* acc2 = B1 + kTL * xs;                    // [kTL][xs] dx
  float* A2 = acc2 + kTL * xs;                    // [kTL][ns] C rows l
  float* B2 = A2 + kTL * ns;                      // [kTL][ns] B rows m
  float* acc1 = B2 + kTL * ns;                    // [kTL][ns] dC / dB
  float* T1 = acc1 + kTL * ns;                    // [kTL][kTS]
  float* T2 = T1 + kTL * kTS;
  float* T3 = T2 + kTL * kTS;
  float* red = T3 + kTL * kTS;                    // [kThreads]

  const int tid = threadIdx.x;
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int nchunks = gridDim.y;
  const int64_t t0 = (int64_t)b * S + (int64_t)c * L;
  const int64_t bch = ((int64_t)b * nchunks + c) * H + h;
  const int64_t xrow = (int64_t)H * P;
  const T* x_c = x + t0 * xrow + (int64_t)h * P;
  const T* dy_c = dy + t0 * xrow + (int64_t)h * P;
  const T* b_c = bm + t0 * N;
  const T* c_c = cm + t0 * N;
  const float* hin = entering + bch * P * N;
  const float* gn = gout + bch * P * N;
  const float ah = a[h];
  chunk_cumsum(dt + t0 * H + h, H, ah, L, dtv, cum);
  simt_tile::clear<kThreads>(dcum, 2 * L);     // dcum and ecol
  __syncthreads();
  const float last = cum[L - 1];
  const int n_tiles = (L + kTL - 1) / kTL;
  // M[l, m] between global chunk rows (0 where m > l or l is past L)
  auto decay = [&](int lg, int mg) -> float {
    return lg < L && mg <= lg ? expf(cum[lg] - cum[mg]) : 0.f;
  };

  // ---- pass A: row tiles l -> dC, the row side of d(dacum) ----
  for (int I = 0; I < n_tiles; ++I) {
    const int l0 = I * kTL, nl = min(kTL, L - l0);
    __syncthreads();
    simt_tile::stage<kThreads>(A1, xs, dy_c + l0 * xrow, xrow, kTL, nl, P);
    simt_tile::stage<kThreads>(A2, ns, c_c + (int64_t)l0 * N, N, kTL, nl, N);
    simt_tile::clear<kThreads>(acc1, kTL * ns);
    for (int J = 0; J <= I; ++J) {
      const int m0 = J * kTL, nm = min(kTL, L - m0);
      __syncthreads();
      simt_tile::stage<kThreads>(B1, xs, x_c + m0 * xrow, xrow, kTL, nm, P);
      simt_tile::stage<kThreads>(B2, ns, b_c + (int64_t)m0 * N, N, kTL, nm,
                                 N);
      __syncthreads();
      // T1 = dW M dt_m (dCB), T2 = T1 CB
      for (int t = tid; t < kT4 * kT4; t += kThreads) {
        const int tl = t / kT4, tm = t % kT4;
        float dw[4][4], cb[4][4];
        simt_tile::zero(dw);
        simt_tile::zero(cb);
        micro(A1 + 4 * tl * xs, xs, 1, B1 + 4 * tm * xs, 1, xs, P, dw);
        micro(A2 + 4 * tl * ns, ns, 1, B2 + 4 * tm * ns, 1, ns, N, cb);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int lg = l0 + 4 * tl + i, mg = m0 + 4 * tm + j;
            const float mk = decay(lg, mg);
            const float dcb = mk != 0.f ? dw[i][j] * mk * dtv[mg] : 0.f;
            T1[(4 * tl + i) * kTS + 4 * tm + j] = dcb;
            T2[(4 * tl + i) * kTS + 4 * tm + j] = dcb * cb[i][j];
          }
      }
      __syncthreads();
      // dC[l] += dCB B[m]
      for (int t = tid; t < kT4 * nc4; t += kThreads) {
        const int tl = t / nc4, tn = t % nc4;
        float o[4][4];
        simt_tile::zero(o);
        micro(T1 + 4 * tl * kTS, kTS, 1, B2 + 4 * tn, ns, 1, kTL, o);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc1[(4 * tl + i) * ns + 4 * tn + j] += o[i][j];
      }
      for (int r = tid; r < nl; r += kThreads) {
        float s = 0.f;
        for (int m = 0; m < kTL; ++m) s += T2[r * kTS + m];
        dcum[l0 + r] += s;
      }
    }
    // the carried state's term: dC[l] += exp(dacum[l]) dy[l] h_in, and
    // d(dacum[l]) += exp(dacum[l]) dy[l] . (h_in C[l])
    __syncthreads();
    simt_tile::stage<kThreads>(B2, ns, hin, N, P, P, N);   // h_in [P][N]
    __syncthreads();
    for (int t = tid; t < kT4 * pc; t += kThreads) {
      const int tl = t / pc, tp = t % pc;
      float o[4][4];
      simt_tile::zero(o);
      micro(A2 + 4 * tl * ns, ns, 1, B2 + 4 * tp * ns, 1, ns, N, o);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          T1[(4 * tl + i) * kTS + 4 * tp + j] = o[i][j];
    }
    for (int t = tid; t < kT4 * nc4; t += kThreads) {
      const int tl = t / nc4, tn = t % nc4;
      float o[4][4];
      simt_tile::zero(o);
      micro(A1 + 4 * tl * xs, xs, 1, B2 + 4 * tn, ns, 1, P, o);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int lg = l0 + 4 * tl + i;
        const float e = lg < L ? expf(cum[lg]) : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc1[(4 * tl + i) * ns + 4 * tn + j] += e * o[i][j];
      }
    }
    __syncthreads();
    for (int r = tid; r < nl; r += kThreads) {
      float s = 0.f;
      for (int p = 0; p < P; ++p) s += A1[r * xs + p] * T1[r * kTS + p];
      dcum[l0 + r] += expf(cum[l0 + r]) * s;
    }
    float* dst = dCp + bch * L * N;
    for (int idx = tid; idx < nl * N; idx += kThreads) {
      const int r = idx / N, n = idx - r * N;
      dst[(int64_t)(l0 + r) * N + n] = acc1[r * ns + n];
    }
  }

  // ---- pass B: column tiles m -> dx, dB, ddt's direct parts ----
  for (int J = 0; J < n_tiles; ++J) {
    const int m0 = J * kTL, nm = min(kTL, L - m0);
    __syncthreads();
    simt_tile::stage<kThreads>(B1, xs, x_c + m0 * xrow, xrow, kTL, nm, P);
    simt_tile::stage<kThreads>(B2, ns, b_c + (int64_t)m0 * N, N, kTL, nm, N);
    simt_tile::clear<kThreads>(acc1, kTL * ns);
    simt_tile::clear<kThreads>(acc2, kTL * xs);
    for (int I = J; I < n_tiles; ++I) {
      const int l0 = I * kTL, nl = min(kTL, L - l0);
      __syncthreads();
      simt_tile::stage<kThreads>(A1, xs, dy_c + l0 * xrow, xrow, kTL, nl, P);
      simt_tile::stage<kThreads>(A2, ns, c_c + (int64_t)l0 * N, N, kTL, nl,
                                 N);
      __syncthreads();
      // T1 = CB^T M^T, T2 = dW^T M^T, T3 = dW^T CB^T M^T, [m][l]
      for (int t = tid; t < kT4 * kT4; t += kThreads) {
        const int tm = t / kT4, tl = t % kT4;
        float dw[4][4], cb[4][4];
        simt_tile::zero(dw);
        simt_tile::zero(cb);
        micro(B1 + 4 * tm * xs, xs, 1, A1 + 4 * tl * xs, 1, xs, P, dw);
        micro(B2 + 4 * tm * ns, ns, 1, A2 + 4 * tl * ns, 1, ns, N, cb);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int mg = m0 + 4 * tm + i, lg = l0 + 4 * tl + j;
            const float mk = decay(lg, mg);
            const int at = (4 * tm + i) * kTS + 4 * tl + j;
            T1[at] = cb[i][j] * mk;
            T2[at] = dw[i][j] * mk;
            T3[at] = dw[i][j] * cb[i][j] * mk;
          }
      }
      __syncthreads();
      // dx[m] += (CB M)^T dy (dt_m later); dB[m] += (dW M)^T C (dt_m later)
      for (int t = tid; t < kT4 * pc; t += kThreads) {
        const int tm = t / pc, tp = t % pc;
        float o[4][4];
        simt_tile::zero(o);
        micro(T1 + 4 * tm * kTS, kTS, 1, A1 + 4 * tp, xs, 1, kTL, o);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc2[(4 * tm + i) * xs + 4 * tp + j] += o[i][j];
      }
      for (int t = tid; t < kT4 * nc4; t += kThreads) {
        const int tm = t / nc4, tn = t % nc4;
        float o[4][4];
        simt_tile::zero(o);
        micro(T2 + 4 * tm * kTS, kTS, 1, A2 + 4 * tn, ns, 1, kTL, o);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc1[(4 * tm + i) * ns + 4 * tn + j] += o[i][j];
      }
      for (int r = tid; r < nm; r += kThreads) {
        float s = 0.f;
        for (int l = 0; l < kTL; ++l) s += T3[r * kTS + l];
        ecol[m0 + r] += s;
      }
    }
    // the state leaving the chunk: with G its gradient, BG = B G^T [m][p]
    // and XG = x G [m][n]; dx += r dt BG, dB += r dt XG, ddt += r x . BG
    __syncthreads();
    simt_tile::stage<kThreads>(A2, ns, gn, N, P, P, N);   // G [P][N]
    __syncthreads();
    for (int t = tid; t < kT4 * pc; t += kThreads) {
      const int tm = t / pc, tp = t % pc;
      float o[4][4];
      simt_tile::zero(o);
      micro(B2 + 4 * tm * ns, ns, 1, A2 + 4 * tp * ns, 1, ns, N, o);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          T1[(4 * tm + i) * kTS + 4 * tp + j] = o[i][j];
    }
    float* dst = dBp + bch * L * N;
    for (int t = tid; t < kT4 * nc4; t += kThreads) {
      const int tm = t / nc4, tn = t % nc4;
      float o[4][4];
      simt_tile::zero(o);
      micro(B1 + 4 * tm * xs, xs, 1, A2 + 4 * tn, ns, 1, P, o);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int mg = m0 + 4 * tm + i;
        if (mg >= L) continue;
        const float rdt = expf(last - cum[mg]) * dtv[mg];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = 4 * tn + j;
          if (n < N)
            dst[(int64_t)mg * N + n] =
                dtv[mg] * acc1[(4 * tm + i) * ns + n] + rdt * o[i][j];
        }
      }
    }
    __syncthreads();
    for (int r = tid; r < nm; r += kThreads) {
      const int mg = m0 + r;
      float s = 0.f;
      for (int p = 0; p < P; ++p) s += B1[r * xs + p] * T1[r * kTS + p];
      fd[mg] = expf(last - cum[mg]) * s;
    }
    for (int idx = tid; idx < nm * P; idx += kThreads) {
      const int r = idx / P, p = idx - r * P;
      const int mg = m0 + r;
      const float rm = expf(last - cum[mg]);
      dx[(t0 + mg) * xrow + (int64_t)h * P + p] = simt_tile::from_float<T>(
          dtv[mg] * (acc2[r * xs + p] + rm * T1[r * kTS + p]));
    }
  }

  // ---- d(dacum) -> d(da), ddt, the chunk's part of da ----
  __syncthreads();
  float hsum = 0.f;     // h_in . G, for the decay of the entering state
  for (int e = tid; e < P * N; e += kThreads) hsum += hin[e] * gn[e];
  red[tid] = hsum;
  for (int i = tid; i < L; i += kThreads)
    dcum[i] -= dtv[i] * (ecol[i] + fd[i]);
  __syncthreads();
  if (tid == 0) {
    float hs = 0.f, fs = 0.f;
    for (int i = 0; i < kThreads; ++i) hs += red[i];
    for (int m = 0; m < L; ++m) fs += dtv[m] * fd[m];
    dcum[L - 1] += fs + expf(last) * hs;
    float dda = 0.f, part = 0.f;
    for (int i = L - 1; i >= 0; --i) {
      dda += dcum[i];
      ddt[(t0 + i) * H + h] = ecol[i] + fd[i] + ah * dda;
      part += dtv[i] * dda;
    }
    dap[bch] = part;
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
  db[id] = simt_tile::from_float<T>(sb);
  dc[id] = simt_tile::from_float<T>(sc);
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

// -- host side ------------------------------------------------------------------

// fp32 scratch: entering states and gout ([B, nc, H, P, N] each), declog
// and dap ([B, nc, H] each), dBp and dCp ([B, nc, H, L, N] each)
inline long long scratch_floats(int B, int S, int H, int P, int N, int L) {
  const long long bch = (long long)B * (S / L) * H;
  return bch * (2LL * P * N + 2 + 2LL * L * N);
}

template <typename K>
int opt_in(K kernel, size_t smem) {
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T>
int launch(const void* x_, const void* dt_, const void* a_, const void* bm_,
           const void* cm_, const void* h0_, const void* dy_,
           const void* dfinal_, void* dx_, void* ddt_, void* da_, void* db_,
           void* dc_, void* dh0_, float* scratch, int B, int S, int H, int P,
           int N, int L, cudaStream_t s) {
  const T* x = static_cast<const T*>(x_);
  const float* dt = static_cast<const float*>(dt_);
  const float* a = static_cast<const float*>(a_);
  const T* bm = static_cast<const T*>(bm_);
  const T* cm = static_cast<const T*>(cm_);
  const T* dy = static_cast<const T*>(dy_);
  const int nchunks = S / L;
  const long long bch = (long long)B * nchunks * H;
  float* entering = scratch;
  float* gout = entering + bch * P * N;
  float* declog = gout + bch * P * N;
  float* dap = declog + bch;
  float* dBp = dap + bch;
  float* dCp = dBp + bch * L * N;

  const dim3 grid(H, nchunks, B);
  const size_t own_smem = sizeof(float) * own_floats(L, P, N);
  const size_t chunk_smem = sizeof(float) * chunk_floats(L, P, N);
  int err = opt_in(own_kernel<T, 0>, own_smem);
  if (!err) err = opt_in(own_kernel<T, 1>, own_smem);
  if (!err) err = opt_in(chunk_kernel<T>, chunk_smem);
  if (err) return err;
  const long long scan_threads = (long long)B * H * P * N;
  const long long scan_blocks = (scan_threads + kThreads - 1) / kThreads;
  const long long red_blocks = ((long long)B * S * N + kThreads - 1) /
                               kThreads;
  if (scan_blocks > 0x7fffffffLL || red_blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;

  // (i) the states entering each chunk
  own_kernel<T, 0><<<grid, kThreads, own_smem, s>>>(x, dt, a, bm, entering,
                                                    declog, S, H, P, N, L);
  scan_kernel<<<(unsigned)scan_blocks, kThreads, 0, s>>>(
      entering, declog, static_cast<const float*>(h0_), nullptr, B, nchunks,
      H, P * N, 0);
  // (ii) the gradient of the state leaving each chunk, and dh0
  own_kernel<T, 1><<<grid, kThreads, own_smem, s>>>(dy, dt, a, cm, gout,
                                                    nullptr, S, H, P, N, L);
  scan_kernel<<<(unsigned)scan_blocks, kThreads, 0, s>>>(
      gout, declog, static_cast<const float*>(dfinal_),
      static_cast<float*>(dh0_), B, nchunks, H, P * N, 1);
  // (iii) per chunk, then the sums over heads and over (b, chunk)
  chunk_kernel<T><<<grid, kThreads, chunk_smem, s>>>(
      x, dt, a, bm, cm, dy, entering, gout, static_cast<T*>(dx_),
      static_cast<float*>(ddt_), dBp, dCp, dap, S, H, P, N, L);
  reduce_kernel<T><<<(unsigned)red_blocks, kThreads, 0, s>>>(
      dBp, dCp, static_cast<T*>(db_), static_cast<T*>(dc_), B, S, H, N, L);
  da_kernel<<<(H + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      dap, static_cast<float*>(da_), B * nchunks, H);
  return (int)cudaGetLastError();
}

}  // namespace backward
}  // namespace ssd
