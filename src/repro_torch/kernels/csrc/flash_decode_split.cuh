// The split-KV decode variant (decode_split): f32 or bf16, Dk = Dv in
// {64, 128}, at most 64 query rows per kv head (Sq x group).  See
// flash_attention.cu for the design notes.
#pragma once

#include "flash_common.cuh"

namespace flash {
namespace decode_split {

constexpr int kBK = 32;          // keys per tile: one per lane
constexpr int kSegTiles = 4;     // tiles loaded at once
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxRows = 64;     // Sq x group
constexpr int kTargetBlocks = 264;   // two waves of the H100's 132 SMs
constexpr int kMinKeys = 64;     // keys per split, at least
constexpr int kMaxSplits = kTargetBlocks;   // n_splits never exceeds it

// splits of the kv sweep, from the shapes alone
inline int n_splits(int B, int Hkv, int Skv) {
  const int bh = B * Hkv;
  const int want = (kTargetBlocks + bh - 1) / bh;
  const int most = Skv / kMinKeys;
  const int n = want < most ? want : most;
  return n > 1 ? n : 1;
}

// fp32 scratch of the partials, per (b, kv head, split, row): the (m, l)
// pairs, then (16-byte aligned) the acc[D] rows
__host__ __device__ inline long long ml_floats(long long slots) {
  return (2 * slots + 3) / 4 * 4;
}
inline long long scratch_floats(int B, int Hkv, int Skv, int rows, int D) {
  const long long slots = (long long)B * Hkv * n_splits(B, Hkv, Skv) * rows;
  return ml_floats(slots) + slots * D;
}

// Shared memory: the block's q rows as fp32, then a segment of kSegTiles
// K and V tiles (rows padded by 16 bytes: lanes reading 16 bytes of
// consecutive rows hit distinct banks).
template <typename T, int D>
struct Plan {
  static constexpr int kRow = D * (int)sizeof(T) + 16;   // padded tile row
  static constexpr int kTile = kBK * kRow;
  static constexpr int kTiles = 2 * kSegTiles * kTile;    // K then V
  static int bytes(int rows) { return rows * D * 4 + kTiles; }
  static constexpr int kMaxBytes = kMaxRows * D * 4 + kTiles;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  // an invalid source reads nothing and zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 8 consecutive elements of a staged row as floats (16-byte aligned)
__device__ __forceinline__ void load8(const float* p, float* x) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 c = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = c.x; x[5] = c.y; x[6] = c.z; x[7] = c.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* x) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// N = D / 32 consecutive elements (N in {2, 4}) as floats
template <int N>
__device__ __forceinline__ void load_n(const float* p, float* x) {
  if constexpr (N == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  } else {
    const float2 a = *reinterpret_cast<const float2*>(p);
    x[0] = a.x; x[1] = a.y;
  }
}
template <int N>
__device__ __forceinline__ void load_n(const __nv_bfloat16* p, float* x) {
  if constexpr (N == 4) {
    const float4 a = load4(p);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  } else {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(p));
    x[0] = a.x; x[1] = a.y;
  }
}

// Grid (B * Hkv, n_split).  Row r of the block's tile is query (r / group)
// of q head hk * group + r % group.  Warp w owns rows w, w + 8, ...: lane j
// computes their scores against key j of each tile, the warp their softmax
// by shuffles, and lane c their P.V columns c * D/32 ... (the weights
// broadcast from the lane that holds them).  The split's keys go in
// segments of kSegTiles tiles: every warp reads the segment's positions
// (the same keys in every warp, so every warp reaches the same verdict
// without a block barrier), tiles no row sees are neither loaded nor
// computed, and the visible ones arrive by one batch of 16-byte cp.async.
// Writes the split's (m, l, acc) in fp32; the combine kernel merges them.
template <typename T, int D, int RPW>
__global__ void __launch_bounds__(kThreads)
split_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int32_t* __restrict__ qpos,
             const int32_t* __restrict__ kpos, float* __restrict__ part,
             int Sq, int Skv, int Hq, int Hkv, int n_split, int chunk,
             float scale, float softcap, int causal, int window) {
  using P = Plan<T, D>;
  constexpr int kCols = D / 32;                       // P.V columns per lane
  constexpr int kPieces = D * (int)sizeof(T) / 16;    // 16-byte pieces a row
  constexpr int kPer = 16 / (int)sizeof(T);           // elements a piece
  extern __shared__ float4 smem4[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(smem4);
  float* Qs = reinterpret_cast<float*>(sm);

  const int bh = blockIdx.x;
  const int split = blockIdx.y;
  const int b = bh / Hkv, hk = bh % Hkv;
  const int G = Hq / Hkv;
  const int R = Sq * G;
  uint8_t* tiles = sm + R * D * 4;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kbeg = split * chunk;
  const int kend = min(Skv, kbeg + chunk);

  // q rows: row r = (sq, g) is q head hk * G + g of query sq
  for (int idx = tid; idx < R * kPieces; idx += kThreads) {
    const int r = idx / kPieces, c = idx % kPieces;
    const T* src = q + (((int64_t)b * Sq + r / G) * Hq + hk * G + r % G) * D +
                   c * kPer;
    float* dst = Qs + r * D + c * kPer;
    if constexpr (kPer == 8) {
      float x[8];
      load8(src, x);
      reinterpret_cast<float4*>(dst)[0] = make_float4(x[0], x[1], x[2], x[3]);
      reinterpret_cast<float4*>(dst)[1] = make_float4(x[4], x[5], x[6], x[7]);
    } else {
      *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
    }
  }
  long long qmin = INT_MAX, qmax = INT_MIN;
  for (int i = 0; i < Sq; ++i) {
    const long long p = qpos[(int64_t)b * Sq + i];
    qmin = min(qmin, p);
    qmax = max(qmax, p);
  }
  int qp[RPW];
  float m[RPW], l[RPW], acc[RPW][kCols];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp + kWarps * i;
    qp[i] = r < R ? qpos[(int64_t)b * Sq + r / G] : 0;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  const T* kb = k + ((int64_t)b * Skv * Hkv + hk) * D;
  const T* vb = v + ((int64_t)b * Skv * Hkv + hk) * D;
  for (int seg = kbeg; seg < kend; seg += kSegTiles * kBK) {
    // positions of this lane's key in each tile; which tiles some row sees
    int kp[kSegTiles];
    unsigned vis = 0;
#pragma unroll
    for (int t = 0; t < kSegTiles; ++t) {
      const int j = seg + t * kBK + lane;
      kp[t] = j < kend ? kpos[(int64_t)b * Skv + j] : kValidPosLimit;
      const bool seen = kp[t] < kValidPosLimit &&
                        (!causal || kp[t] <= qmax) &&
                        (window <= 0 || kp[t] > qmin - window);
      if (__any_sync(0xffffffffu, seen)) vis |= 1u << t;
    }
    if (seg > kbeg) __syncthreads();   // the last segment's readers are done
    if (vis) {
      for (int idx = tid; idx < 2 * kSegTiles * kBK * kPieces;
           idx += kThreads) {
        const int rem = idx % (kSegTiles * kBK * kPieces);
        const int t = rem / (kBK * kPieces);
        if (!((vis >> t) & 1)) continue;
        const bool is_v = idx >= kSegTiles * kBK * kPieces;
        const int j = (rem / kPieces) % kBK, c = rem % kPieces;
        const int key = seg + t * kBK + j;
        const bool ok = key < kend;
        const T* src = (is_v ? vb : kb) + (ok ? (int64_t)key * Hkv * D : 0) +
                       c * kPer;
        cp_async16(tiles + (is_v ? kSegTiles * P::kTile : 0) + t * P::kTile +
                       j * P::kRow + c * 16,
                   src, ok);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();   // the tiles, and at first the q rows, are in
    if (!vis) continue;

    // scores of this lane's key in each visible tile, for the warp's rows
    float s[kSegTiles][RPW];
#pragma unroll
    for (int t = 0; t < kSegTiles; ++t)
#pragma unroll
      for (int i = 0; i < RPW; ++i) s[t][i] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 8) {
      float qx[RPW][8];
#pragma unroll
      for (int i = 0; i < RPW; ++i)
        if (warp + kWarps * i < R) load8(Qs + (warp + kWarps * i) * D + d,
                                          qx[i]);
#pragma unroll
      for (int t = 0; t < kSegTiles; ++t) {
        if (!((vis >> t) & 1)) continue;
        float kx[8];
        load8(reinterpret_cast<const T*>(tiles + t * P::kTile +
                                         lane * P::kRow) + d,
              kx);
#pragma unroll
        for (int i = 0; i < RPW; ++i)
#pragma unroll
          for (int e = 0; e < 8; ++e) s[t][i] = fmaf(qx[i][e], kx[e], s[t][i]);
      }
    }
    // online softmax over the segment's visible keys
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      if (warp + kWarps * i >= R) continue;
      float mx = -INFINITY;
#pragma unroll
      for (int t = 0; t < kSegTiles; ++t) {
        if (!((vis >> t) & 1)) continue;
        const bool in = seg + t * kBK + lane < kend;
        float x = s[t][i] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool ok = in && kp[t] < kValidPosLimit;
        if (causal) ok = ok && kp[t] <= qp[i];
        if (window > 0) ok = ok && (long long)kp[t] > (long long)qp[i] - window;
        // hidden keys take NEG_INF; keys outside the split take no part
        x = ok ? x : (in ? kNegInf : -INFINITY);
        s[t][i] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < kSegTiles; ++t) {
        if (!((vis >> t) & 1)) continue;
        s[t][i] = expf(s[t][i] - m_new);
        sum += s[t][i];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    // P.V: key j's weight broadcast from lane j
#pragma unroll
    for (int t = 0; t < kSegTiles; ++t) {
      if (!((vis >> t) & 1)) continue;
      const int n = min(kBK, kend - (seg + t * kBK));   // keys in the tile
      const uint8_t* vt = tiles + kSegTiles * P::kTile + t * P::kTile;
      for (int j = 0; j < n; ++j) {
        float vx[kCols];
        load_n<kCols>(reinterpret_cast<const T*>(vt + j * P::kRow) +
                          lane * kCols,
                      vx);
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          const float p = __shfl_sync(0xffffffffu, s[t][i], j);
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(p, vx[c], acc[i][c]);
        }
      }
    }
  }

  // partials: (m, l) block, then acc; a split that saw nothing has l = 0
  const int64_t slot = ((int64_t)bh * n_split + split) * R;
  float* ml = part;
  float* pacc = part + ml_floats((int64_t)gridDim.x * n_split * R);
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp + kWarps * i;
    if (r >= R) continue;
    if (lane == 0) {
      ml[(slot + r) * 2] = m[i];
      ml[(slot + r) * 2 + 1] = l[i];
    }
    float* dst = pacc + (slot + r) * D + lane * kCols;
    if constexpr (kCols == 4)
      *reinterpret_cast<float4*>(dst) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    else
      *reinterpret_cast<float2*>(dst) = make_float2(acc[i][0], acc[i][1]);
  }
}

// One block per (b, kv head, row), one thread per column.  The splits'
// (m, l) go to shared memory first, one split a thread, so the weights
// exp(m_s - m) over the splits with l_s > 0 are computed once and every
// column's sum reads only independent acc values; rounds once.  With lse
// set, thread 0 also writes the row's log-sum-exp of its (scaled, capped,
// masked) scores, m + log(sum_s w_s l_s) in fp32, -inf for a row that saw
// no key: what a seq-sharded decode's ranks exchange to merge their chunks.
template <typename T, int D>
__global__ void __launch_bounds__(D)
combine_kernel(const float* __restrict__ part, T* __restrict__ out,
               float* __restrict__ lse, int Sq, int Hq, int Hkv,
               int n_split) {
  __shared__ float w_s[kMaxSplits];
  __shared__ float red[D / 32];
  const int G = Hq / Hkv;
  const int R = Sq * G;
  const int r = blockIdx.x % R;
  const int bh = blockIdx.x / R;
  const int b = bh / Hkv, hk = bh % Hkv;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const float* ml = part;
  const float* pacc = part + ml_floats((int64_t)gridDim.x * n_split);
  const int64_t slot = (int64_t)bh * n_split * R + r;   // split s: + s * R
  // the largest m over the splits that saw a key (kNegInf when none did)
  float mx = -INFINITY;
  for (int s = tid; s < n_split; s += D) {
    const float2 v = reinterpret_cast<const float2*>(ml)[slot + (int64_t)s * R];
    w_s[s] = v.y;                                      // l_s for now
    if (v.y > 0.f) mx = fmaxf(mx, v.x);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  mx = red[0];
#pragma unroll
  for (int i = 1; i < D / 32; ++i) mx = fmaxf(mx, red[i]);
  __syncthreads();   // red is reused below
  // weights, and the denominator sum_s w_s l_s
  float den = 0.f;
  for (int s = tid; s < n_split; s += D) {
    const float ls = w_s[s];
    const float w = ls > 0.f ? expf(ml[(slot + (int64_t)s * R) * 2] - mx) : 0.f;
    w_s[s] = w;
    den = fmaf(w, ls, den);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    den += __shfl_xor_sync(0xffffffffu, den, off);
  if (lane == 0) red[warp] = den;
  __syncthreads();
  den = 0.f;
#pragma unroll
  for (int i = 0; i < D / 32; ++i) den += red[i];
  float num = 0.f;
#pragma unroll 8
  for (int s = 0; s < n_split; ++s)
    num = fmaf(w_s[s], pacc[(slot + (int64_t)s * R) * D + tid], num);
  const int64_t row = ((int64_t)b * Sq + r / G) * Hq + hk * G + r % G;
  out[row * D + tid] = from_float<T>(num / (den > 0.f ? den : 1.f));
  if (lse != nullptr && tid == 0)
    lse[row] = den > 0.f ? mx + logf(den) : -INFINITY;
}

template <typename T, int D, int RPW>
int launch_rows(const void* q, const void* k, const void* v, const void* qpos,
                const void* kpos, void* out, float* lse, float* part, int B,
                int Sq, int Skv, int Hq, int Hkv, float scale, float softcap,
                int causal, int window, cudaStream_t stream) {
  auto kernel = split_kernel<T, D, RPW>;
  const int smem = Plan<T, D>::bytes(Sq * (Hq / Hkv));
  static bool configured = false;  // one opt-in per instantiation
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Plan<T, D>::kMaxBytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int n_split = n_splits(B, Hkv, Skv);
  const int chunk = (Skv + n_split - 1) / n_split;
  const int R = Sq * (Hq / Hkv);
  kernel<<<dim3(B * Hkv, n_split), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(qpos),
      static_cast<const int32_t*>(kpos), part, Sq, Skv, Hq, Hkv, n_split,
      chunk, scale, softcap, causal, window);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  combine_kernel<T, D><<<B * Hkv * R, D, 0, stream>>>(
      part, static_cast<T*>(out), lse, Sq, Hq, Hkv, n_split);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* qpos,
           const void* kpos, void* out, float* lse, float* part, int B,
           int Sq, int Skv, int Hq, int Hkv, float scale, float softcap,
           int causal, int window, cudaStream_t stream) {
  const int rpw = (Sq * (Hq / Hkv) + kWarps - 1) / kWarps;   // rows a warp
  if (rpw <= 1)
    return launch_rows<T, D, 1>(q, k, v, qpos, kpos, out, lse, part, B, Sq,
                                Skv, Hq, Hkv, scale, softcap, causal, window,
                                stream);
  if (rpw <= 2)
    return launch_rows<T, D, 2>(q, k, v, qpos, kpos, out, lse, part, B, Sq,
                                Skv, Hq, Hkv, scale, softcap, causal, window,
                                stream);
  if (rpw <= 4)
    return launch_rows<T, D, 4>(q, k, v, qpos, kpos, out, lse, part, B, Sq,
                                Skv, Hq, Hkv, scale, softcap, causal, window,
                                stream);
  return launch_rows<T, D, 8>(q, k, v, qpos, kpos, out, lse, part, B, Sq,
                              Skv, Hq, Hkv, scale, softcap, causal, window,
                              stream);
}

}  // namespace decode_split
}  // namespace flash
