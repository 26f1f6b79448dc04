// The `simt` variant of the flash forward: f32 prefill, the head dims and
// (Dk, Dv) pairs the other variants do not take, and few rows at (80, 80)
// and (192, 128) (see flash_attention.cu).  The name is historical: the
// variant first ran on the fp32 CUDA cores.  It now takes S = Q K^T and
// O += P V on the tensor cores, mma.sync m16n8k8 on TF32 operands with
// fp32 accumulators, each fp32 operand split in two TF32 parts and each
// product taken as three (flash_mma.cuh: ~22 of fp32's 24 bits, the method
// of PyTorch's memory-efficient SDPA for float).  bf16 operands are exact
// in TF32: Q K^T is one product, P V (fp32 P) two.
//
// Bound by operations: 2 (Dk + Dv) flops a visible (row, key) pair, three
// TF32 products each (mma.sync's own TF32 rate is below wgmma's: see
// tools/mma_sync_rate.py).  Besides the products the costs are the split (a few integer operations an element,
// at half the fp32 rate) and shared-memory bandwidth (each product reads
// two B parts), so the split is done once for what the warps share and a
// warp's B fragments serve as many of its rows as its registers allow.
// Design:
//   - one block per (b, q head, 128 q rows); each warp owns MT m-tiles of
//     16 rows: eight warps of one m-tile, or in f32 at Dv <= 96 where two
//     blocks fit an SM four warps of two (each B fragment read once for
//     both); where eight warps' staging does not fit (f32 at head dims near
//     256), or where Sq <= 16 (a decode, MLA's multi-token step), one
//     warp of 16 rows.  A warp whose rows all lie past Sq stages and
//     splits but computes nothing;
//   - the online softmax runs in fp32 on the S fragment, a row's max and
//     sum reduced over the 4 lanes of a quad, and P goes from S's
//     accumulator to P V's A operand in registers (flash_mma.cuh's "from
//     C" order: V's rows follow it), split there;
//   - Q staged once and split by each warp as it reads its rows; K/V
//     tiles of 32 keys in a ring of two stages by cp.async, the next
//     tile's copy issued as this tile's products start; in f32 the block
//     splits the tile in use once (the big parts in place, the small ones
//     beside) and every warp reads both; head dims zero-padded to
//     multiples of 8; two block barriers a tile (one in bf16);
//   - a prologue marks the key tiles some row of the block may see (from
//     the rows' smallest and largest positions); the walk visits those
//     only, and the per-element mask settles the rest.
// Instantiations <T, warps, m-tiles, Dv n-tiles>: <8, 1, 16>, <8, 1, 32>
// and <1, 1, 16> in f32 and bf16; in f32 also <4, 2, 12> and <1, 1, 32>.  Shared
// memory: Q 128 x stride_pairs(Dk), two stages of 32 keys x
// (stride_pairs(Dk) + stride_cols(Dv)), in f32 one more in fp32 for the
// small parts, the stages' positions and a bit a key tile: at S 2048 in
// f32, 230,152 B at MLA's (192, 128), 111,368 B at hubert's (80, 80)
// (two blocks an SM).
#pragma once

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace flash {
namespace simt {

using mma::round8;
using mma::stride_cols;
using mma::stride_pairs;

constexpr int kBK = 32;   // keys of a K/V tile

// Q, the K/V ring, in f32 the small parts of the tile in use, the ring's
// positions and the key tiles' bits
template <typename T>
constexpr size_t smem_bytes(int bq, int dk, int dv, int skv) {
  const size_t kv = (size_t)kBK * (stride_pairs(dk) + stride_cols<T>(dv));
  return sizeof(T) * ((size_t)bq * stride_pairs(dk) + 2 * kv)
         + (mma::exact<T>() ? 0 : sizeof(float) * kv)
         + sizeof(int) * 2 * kBK
         + sizeof(uint32_t) * mma::mask_words((skv + kBK - 1) / kBK);
}

// one K/V tile and its positions into a stage, by cp.async
template <typename T>
__device__ __forceinline__ void stage_kv(T* Kt, T* Vt, int* kp, const T* k,
                                         const T* v, const int32_t* kp_b,
                                         int k0, int Skv, int64_t k_row,
                                         int64_t v_row, int Dk, int Dv,
                                         int ks, int vs, int vec, int tid,
                                         int nthreads) {
  const int nk = min(kBK, Skv - k0);
  mma::stage(Kt, ks, k + k0 * k_row, k_row, kBK, nk, Dk, vec, tid, nthreads);
  mma::stage(Vt, vs, v + k0 * v_row, v_row, kBK, nk, Dv, vec, tid, nthreads);
  mma::stage_scalars(kp, kp_b + k0, 1, kBK, nk, tid, nthreads);
}

template <typename T, int WARPS, int MT, int NV>
__global__ void __launch_bounds__(WARPS * 32, 1)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int32_t* __restrict__ qpos,
             const int32_t* __restrict__ kpos, T* __restrict__ out,
             float* __restrict__ lse, int Sq, int Skv, int Hq, int Hkv,
             int Dk, int Dv, float scale, float softcap, int causal,
             int window, int vec) {
  constexpr int kThreads = WARPS * 32;
  constexpr int BQ = 16 * MT * WARPS;
  constexpr int BK = kBK;
  constexpr int NT = BK / 8;                // 8-key n-tiles of S
  constexpr bool kExact = mma::exact<T>();  // bf16: exact in TF32
  const int ks = stride_pairs(Dk), vs = stride_cols<T>(Dv);
  const int kst = round8(Dk) / 8, nvt = round8(Dv) / 8;
  const int ntiles = (Skv + BK - 1) / BK;
  extern __shared__ float4 smem4[];
  T* Qs = reinterpret_cast<T*>(smem4);                      // [BQ][ks]
  T* Ks = Qs + BQ * ks;                                     // [2][BK][ks]
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
  const int64_t q_row = (int64_t)Hq * Dk;
  const int64_t k_row = (int64_t)Hkv * Dk, v_row = (int64_t)Hkv * Dv;
  const int32_t* qp_b = qpos + (int64_t)b * Sq + q0;
  const int32_t* kp_b = kpos + (int64_t)b * Skv;
  const T* k_b = k + (int64_t)b * Skv * k_row + (int64_t)hk * Dk;
  const T* v_b = v + (int64_t)b * Skv * v_row + (int64_t)hk * Dv;

  // this thread's rows: m-tile i of the warp holds rows 16 (MT warp + i)
  // + g (hf 0) and that + 8 (hf 1); and the range of the block's rows
  const int r0 = 16 * MT * warp + g;
  bool ok[MT][2];
  int qp[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = r0 + 16 * i + 8 * hf;
      ok[i][hf] = row < nq;
      qp[i][hf] = ok[i][hf] ? qp_b[row] : 0;
    }
  int qlo = INT_MAX, qhi = INT_MIN;
  for (int i = lane; i < nq; i += 32) {
    qlo = min(qlo, qp_b[i]);
    qhi = max(qhi, qp_b[i]);
  }
  mma::warp_range(qlo, qhi);

  // the key tiles some row may see, one warp a tile
  for (int w = tid; w < mma::mask_words(ntiles); w += kThreads) seen[w] = 0u;
  mma::zero_cols(Qs, ks, BQ, Dk, tid, kThreads);
  mma::zero_cols(Ks, ks, 2 * BK, Dk, tid, kThreads);
  mma::zero_cols(Vs, vs, 2 * BK, Dv, tid, kThreads);
  __syncthreads();
  for (int tt = warp; tt < ntiles; tt += WARPS) {
    bool any = false;
    for (int j = tt * BK + lane; j < min(Skv, (tt + 1) * BK); j += 32)
      any |= mma::key_may_see(kp_b[j], qlo, qhi, causal, window);
    if (__any_sync(0xffffffffu, any) && lane == 0)
      atomicOr(seen + (tt >> 5), 1u << (tt & 31));
  }
  __syncthreads();

  mma::stage(Qs, ks, q + ((int64_t)b * Sq + q0) * q_row + (int64_t)h * Dk,
             q_row, BQ, nq, Dk, vec, tid, kThreads);
  float m[MT][2], l[MT][2], o[MT][NV][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      m[i][hf] = -INFINITY;
      l[i][hf] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][n][e] = 0.f;
  }

  int tt = mma::next_tile(seen, 0, ntiles);
  if (tt < ntiles)
    stage_kv(Ks, Vs, kp_s, k_b, v_b, kp_b, tt * BK, Skv, k_row, v_row, Dk, Dv,
             ks, vs, vec, tid, kThreads);
  hopper::cp_async_commit();   // Q and the first tile
  for (int it = 0; tt < ntiles; ++it) {
    const int tn = mma::next_tile(seen, tt + 1, ntiles);
    const int st = it & 1, k0 = tt * BK;
    // this tile has landed for every thread, and the last tile's readers
    // are done with the other stage and the small parts
    hopper::cp_async_wait<0>();
    __syncthreads();
    T* Kt = Ks + st * BK * ks;
    T* Vt = Vs + st * BK * vs;
    const int* kp = kp_s + st * BK;
    if (tn < ntiles)              // the next tile's copy overlaps this one
      stage_kv(Ks + (st ^ 1) * BK * ks, Vs + (st ^ 1) * BK * vs,
               kp_s + (st ^ 1) * BK, k_b, v_b, kp_b, tn * BK, Skv, k_row,
               v_row, Dk, Dv, ks, vs, vec, tid, kThreads);
    hopper::cp_async_commit();
    if constexpr (!kExact) {      // K and V split once for every warp
      mma::split_tile(Kt, Ksm, ks, BK, 8 * kst, tid, kThreads);
      mma::split_tile(Vt, Vsm, vs, BK, 8 * nvt, tid, kThreads);
    }
    if constexpr (!kExact) __syncthreads();
    const int koff = kExact ? 0 : (int)(Ksm - reinterpret_cast<float*>(Kt));
    const int voff = kExact ? 0 : (int)(Vsm - reinterpret_cast<float*>(Vt));
    if (16 * MT * warp >= nq) {   // a warp past Sq only stages and splits
      tt = tn;
      continue;
    }

    // S = Q K^T for the warp's rows and the tile's BK keys, each B
    // fragment read once for the warp's MT m-tiles
    float s[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][j][e] = 0.f;
    const T* qa = Qs + r0 * ks + 2 * t;
    const T* kb = Kt + g * ks + 2 * t;
#pragma unroll 2
    for (int c = 0; c < kst; ++c) {
      uint32_t ab[MT][4], as[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        mma::load_a(qa + 16 * i * ks, ks, c, ab[i], as[i]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t bb[2], bs[2];
        mma::load_b_pairs(kb + 8 * j * ks, koff, c, bb, bs);
#pragma unroll
        for (int i = 0; i < MT; ++i)
          mma::mma3<kExact, kExact>(s[i][j], ab[i], as[i], bb, bs);
      }
    }

    // the mask, the softcap and the online softmax on the fragment: lane
    // (g, t) holds keys 8j + 2t, + 1 of an m-tile's rows r (e 0, 1) and
    // r + 8 (e 2, 3)
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = 8 * j + 2 * t + (e & 1), hf = e >> 1;
          const int kpv = kp[key];
          const bool inside = k0 + key < Skv;
          bool vis = ok[i][hf] && inside && kpv < kValidPosLimit;
          if (causal) vis = vis && kpv <= qp[i][hf];
          if (window > 0) vis = vis && kpv > qp[i][hf] - window;
          float x = s[i][j][e] * scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          // keys past the end take no part; hidden keys take NEG_INF
          x = vis ? x : (inside ? kNegInf : -INFINITY);
          s[i][j][e] = x;
          mx[hf] = fmaxf(mx[hf], x);
        }
      float al[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
        for (int off = 1; off < 4; off <<= 1)
          mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], off));
        mx[hf] = fmaxf(m[i][hf], mx[hf]);
        al[hf] = expf(m[i][hf] - mx[hf]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[i][j][e] = expf(s[i][j][e] - mx[e >> 1]);
          sum[e >> 1] += s[i][j][e];
        }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
        for (int off = 1; off < 4; off <<= 1)
          sum[hf] += __shfl_xor_sync(0xffffffffu, sum[hf], off);
        l[i][hf] = l[i][hf] * al[hf] + sum[hf];
        m[i][hf] = mx[hf];
      }
#pragma unroll
      for (int n = 0; n < NV; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][n][e] *= al[e >> 1];
    }

    // O += P V: P from S's fragment, V's rows 8j + 2t and 8j + 2t + 1,
    // each B fragment read once for the warp's m-tiles
    const T* vb = Vt + 2 * t * vs + g;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t ab[MT][4], as[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) mma::from_c(s[i][j], ab[i], as[i]);
      mma::mma_cols(o, ab, as, vb + 8 * j * vs, voff, vs, nvt);
    }
    tt = tn;
  }
  hopper::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      if (!ok[i][hf]) continue;
      const int row = r0 + 16 * i + 8 * hf;
      const float safe = l[i][hf] > 0.f ? l[i][hf] : 1.f;
      T* orow = out + (((int64_t)b * Sq + q0 + row) * Hq + h) * Dv;
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        const int c = 8 * n + 2 * t;
        if (c < Dv) orow[c] = from_float<T>(o[i][n][2 * hf] / safe);
        if (c + 1 < Dv)
          orow[c + 1] = from_float<T>(o[i][n][2 * hf + 1] / safe);
      }
      // on request, the row's log-sum-exp (-inf where no key reached it)
      if (lse != nullptr && t == 0)
        lse[((int64_t)b * Sq + q0 + row) * Hq + h] =
            l[i][hf] > 0.f ? m[i][hf] + logf(l[i][hf]) : -INFINITY;
    }
}

template <typename T, int WARPS, int MT, int NV>
int launch(const void* q, const void* k, const void* v, const void* qpos,
           const void* kpos, void* out, float* lse, int B, int Sq, int Skv,
           int Hq, int Hkv, int Dk, int Dv, float scale, float softcap,
           int causal, int window, int vec, cudaStream_t stream) {
  auto kernel = flash_kernel<T, WARPS, MT, NV>;
  constexpr int BQ = 16 * MT * WARPS;
  const size_t smem = smem_bytes<T>(BQ, Dk, Dv, Skv);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  static bool configured = false;  // one opt-in per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  kernel<<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(qpos),
      static_cast<const int32_t*>(kpos), static_cast<T*>(out), lse, Sq, Skv,
      Hq, Hkv, Dk, Dv, scale, softcap, causal, window, vec);
  return (int)cudaGetLastError();
}

// shared memory that lets two blocks share an SM (228 KB, 1 KB each kept)
constexpr size_t kHalfSm = 233472 / 2 - 1024;

// lse: null, or fp32 [B, Sq, Hq] for the rows' log-sum-exp.  The plan by
// shape: where Sq <= 16 and Dv <= 128 one warp (16 rows: a decode or
// MLA's multi-token step); in f32 at Dv <= 96 where two blocks fit an SM,
// four warps of two m-tiles (128 rows; each B fragment read for two
// m-tiles: hubert's (80, 80)); else eight warps of one (128 rows; a warp
// past Sq only stages and splits) where their staging fits 227 KB; else
// one warp (f32 at head dims near 256)
template <typename T>
int dispatch_bq(const void* q, const void* k, const void* v, const void* qpos,
                const void* kpos, void* out, float* lse, int B, int Sq,
                int Skv, int Hq, int Hkv, int Dk, int Dv, float scale,
                float softcap, int causal, int window, cudaStream_t stream) {
  const int vec = mma::copy_bytes(sizeof(T), {q, k, v}, {Dk, Dv});
  if (Sq <= 16 && Dv <= 128)
    return launch<T, 1, 1, 16>(q, k, v, qpos, kpos, out, lse, B, Sq, Skv, Hq,
                               Hkv, Dk, Dv, scale, softcap, causal, window,
                               vec, stream);
  if constexpr (!mma::exact<T>()) {
    if (Sq > 16 && Dv <= 96 && smem_bytes<T>(128, Dk, Dv, Skv) <= kHalfSm)
      return launch<T, 4, 2, 12>(q, k, v, qpos, kpos, out, lse, B, Sq, Skv,
                                 Hq, Hkv, Dk, Dv, scale, softcap, causal,
                                 window, vec, stream);
    if (smem_bytes<T>(128, Dk, Dv, Skv) > (size_t)kMaxSmem)
      return launch<T, 1, 1, 32>(q, k, v, qpos, kpos, out, lse, B, Sq, Skv,
                                 Hq, Hkv, Dk, Dv, scale, softcap, causal,
                                 window, vec, stream);
  }
  if (Dv <= 128)
    return launch<T, 8, 1, 16>(q, k, v, qpos, kpos, out, lse, B, Sq, Skv, Hq,
                               Hkv, Dk, Dv, scale, softcap, causal, window,
                               vec, stream);
  return launch<T, 8, 1, 32>(q, k, v, qpos, kpos, out, lse, B, Sq, Skv, Hq,
                             Hkv, Dk, Dv, scale, softcap, causal, window, vec,
                             stream);
}

}  // namespace simt
}  // namespace flash
