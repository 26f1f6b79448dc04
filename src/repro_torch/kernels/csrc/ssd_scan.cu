// Mamba2 SSD chunked scan on Hopper (sm_90a), n_groups == 1.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py (ssd_scan /
// _ssd_kernel).  That kernel walks a (B, head blocks, chunks) grid whose
// innermost chunk axis runs in order on one core, carrying the [Hb, P, N]
// fp32 state in VMEM scratch, and builds the whole [Hb, L, L] decay matrix
// of a chunk in VMEM.  Hopper's blocks run in parallel and in no order.
//
// For one head, chunk of length L starting at t0, dacum = cumsum(dt * a):
//   y[i]   = exp(dacum[i]) * C[i] . state                      (carried)
//          + sum_{j <= i} (C[i] . B[j]) exp(dacum[i] - dacum[j]) dt[j] x[j]
//   state <- state * exp(dacum[L-1])
//          + sum_j exp(dacum[L-1] - dacum[j]) dt[j] x[j] (x) B[j]
// Only the state depends on the chunks before; the rest of a chunk's work
// depends on its own rows and the state entering it.  This is the chunked
// state-space-duality algorithm (Dao & Gu, arXiv:2405.21060, section 6).
//
// The launcher picks one of two variants from the dtype and the shapes
// (choose_variant below; the Python wrapper's variant() is its twin):
//
// tc (ssd_tc.cuh): bf16 x / B / C, P = 64, N in {64, 128}, L a multiple of
//   64 up to 256.  Two kernels, the products on wgmma (bf16 tensor cores,
//   fp32 accumulators) fed by TMA (128-byte swizzle, mbarrier rings, a
//   producer warp beside one consumer warpgroup):
//   - ssd_state, one block per (b, head, 64 columns of N): the only
//     serial part.  Its slice of the carried [P, N] state lives in the
//     wgmma accumulator from h0 to the final state.  Per chunk a warp scan
//     computes dacum; the block writes the slice entering the chunk (bf16,
//     rounded once, by TMA store) and the chunk's dacum and dt (fp32) to
//     scratch, decays the state by exp(dacum[L-1]) and adds (x *
//     exp(dacum[L-1] - dacum) * dt)^T . B as SS wgmma m64n64k16 over
//     64-row sub-tiles, both operands MN-major as TMA lands them.  The
//     weighted x goes in as bf16 hi + lo parts, two passes: one bf16
//     rounding of it misses the state's atol 2e-3 (its error grows with
//     the carried state), hi + lo keeps ~16 bits.  Splitting N gives 384
//     blocks at mamba2-780m, three an SM.
//   - ssd_chunk_scan, one block per (b, chunk, 64-row strip, 16 heads),
//     every chunk in parallel, longest strips first: C_strip . B^T per
//     column tile up to the diagonal once for the heads (n_groups == 1),
//     kept in registers; per head y = exp(dacum_i) * C_strip . state^T
//     (SS wgmma, the bf16 entering state K-major) + W . x over those tiles
//     (register-A wgmma, x MN-major), W = C.B^T * exp(dacum_i - dacum_j) *
//     dt_j masked to j <= i, formed in fp32 on the accumulator fragment
//     and rounded once to bf16.  The exp is the SFU's ex2 on log2-scaled
//     dacum, each column's dacum and dt read once: with the library expf
//     per element, forming W took two thirds of the kernel.  y is rounded
//     once and leaves by TMA store (4-byte stores from the fragment took a
//     fifth of it).
//   Bound: bytes at mamba2-780m's shapes (x, B, C, y and the states once,
//   ~35 us at 3.35 TB/s); this design also writes and reads the entering
//   states (B * nc * H * P * N bf16, 25 MB there), which puts its floor
//   near twice that.  Roundings: W and the entering state once each to
//   bf16 (y's limit is 1e-2 of max |y|); the state itself stays fp32.
//
// simt (ssd_simt.cuh): everything else -- f32, P != 64, other N, chunk
//   32 or not a multiple of 64.  PR 12's kernel: one block of 256 threads
//   per (batch, block of 2 heads; 1 when H is odd) sweeps the chunks in a
//   loop with the fp32 state in shared memory, the intra-chunk term in
//   64 x 64 tiles on the fp32 CUDA cores, a sequential fp32 dacum.  It
//   keeps f32 within 2e-5 of max |y|, which the tensor cores cannot.
//
// The kernels allocate nothing and do not synchronise: tc's entering
// states and dacum / dt live in scratch the caller allocates.  The
// launcher returns cudaGetLastError() so a refused launch is reported at
// once; a tc-shaped call never falls back to simt.

#include "ssd_simt.cuh"
#include "ssd_tc.cuh"

namespace {

enum Variant { kSimt = 0, kTc = 1 };

int choose_variant(int dtype, int P, int N, int L) {
  const bool tc = dtype == 1 && P == ssd::tc::kP && (N == 64 || N == 128) &&
                  L % ssd::tc::kT == 0 && L <= ssd::tc::kMaxL;
  return tc ? kTc : kSimt;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

bool valid_shape(int B, int S, int H, int P, int N, int L) {
  return B > 0 && S > 0 && L > 0 && S % L == 0 && H > 0 && P > 0 && N > 0;
}

// tc's scratch: entering states (bf16 elements) and dacum / dt (floats)
void tc_scratch(int B, int S, int H, int N, int L, long long* state_elems,
                long long* meta_floats) {
  const long long bch = (long long)B * (S / L) * H;
  *state_elems = bch * ssd::tc::kP * N;
  *meta_floats = bch * 2 * L;
}

int tc_state(const void* x, const void* dt, const void* a, const void* bm,
             const void* h0, void* states, void* meta, void* hout, int B,
             int S, int H, int N, int L, cudaStream_t s) {
  if (N == 64)
    return ssd::tc::launch_state<64>(x, dt, a, bm, h0, states, meta, hout, B,
                                     S, H, L, s);
  return ssd::tc::launch_state<128>(x, dt, a, bm, h0, states, meta, hout, B,
                                    S, H, L, s);
}

int tc_chunk(const void* x, const void* bm, const void* cm,
             const void* states, const void* meta, void* y, int B, int S,
             int H, int N, int L, cudaStream_t s) {
  if (N == 64)
    return ssd::tc::launch_chunk<64>(x, bm, cm, states, meta, y, B, S, H, L,
                                     s);
  return ssd::tc::launch_chunk<128>(x, bm, cm, states, meta, y, B, S, H, L,
                                    s);
}

bool tc_args_ok(const void* x, const void* bm, const void* cm,
                const void* states, const void* meta) {
  return states != nullptr && meta != nullptr && aligned16(x) &&
         aligned16(bm) && aligned16(cm) && aligned16(states) &&
         aligned16(meta);
}

}  // namespace

// The variant the launcher takes for these arguments (0 simt, 1 tc), and
// tc's scratch: entering states in bf16 elements, dacum / dt in floats (0
// for simt).
extern "C" int ssd_scan_variant(int dtype, int B, int S, int H, int P, int N,
                                int L, long long* state_elems,
                                long long* meta_floats) {
  const int var = choose_variant(dtype, P, N, L);
  *state_elems = *meta_floats = 0;
  if (var == kTc && valid_shape(B, S, H, P, N, L))
    tc_scratch(B, S, H, N, L, state_elems, meta_floats);
  return var;
}

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y share it); dt, a, h0 and
// the final state are float32; S is a multiple of L.  simt: hb (heads per
// block) is 1 or 2 and divides H; P <= 64; N <= 128 and a multiple of 4.
// tc: states / meta hold at least ssd_scan_variant's scratch; x, B, C and
// the scratch 16-byte aligned.  *chosen receives the variant launched.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a,
                               const void* bm, const void* cm, const void* h0,
                               void* y, void* hout, void* states, void* meta,
                               int dtype, int B, int S, int H, int P, int N,
                               int L, int hb, long long state_elems,
                               long long meta_floats, int* chosen,
                               void* stream) {
  if (!valid_shape(B, S, H, P, N, L) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int var = choose_variant(dtype, P, N, L);
  *chosen = var;
  if (var == kTc) {
    long long need_states, need_meta;
    tc_scratch(B, S, H, N, L, &need_states, &need_meta);
    if (state_elems < need_states || meta_floats < need_meta)
      return (int)cudaErrorInvalidValue;
    if (!tc_args_ok(x, bm, cm, states, meta))
      return (int)cudaErrorMisalignedAddress;
    const int err =
        tc_state(x, dt, a, bm, h0, states, meta, hout, B, S, H, N, L, s);
    if (err) return err;
    return tc_chunk(x, bm, cm, states, meta, y, B, S, H, N, L, s);
  }
  if (hb <= 0 || H % hb != 0 || P > ssd::simt::kPMax ||
      N > ssd::simt::kNMax || N % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return ssd::simt::dispatch_hb<float>(x, dt, a, bm, cm, h0, y, hout, B, S,
                                         H, P, N, L, hb, s);
  return ssd::simt::dispatch_hb<__nv_bfloat16>(x, dt, a, bm, cm, h0, y, hout,
                                               B, S, H, P, N, L, hb, s);
}

// tc's first kernel alone (ssd_state): entering states, dacum / dt and the
// final state.  Same argument rules as ssd_scan_launch's tc variant.
extern "C" int ssd_tc_state_launch(const void* x, const void* dt,
                                   const void* a, const void* bm,
                                   const void* h0, void* states, void* meta,
                                   void* hout, int B, int S, int H, int N,
                                   int L, void* stream) {
  if (!valid_shape(B, S, H, ssd::tc::kP, N, L) ||
      choose_variant(1, ssd::tc::kP, N, L) != kTc)
    return (int)cudaErrorInvalidValue;
  if (!tc_args_ok(x, bm, bm, states, meta))
    return (int)cudaErrorMisalignedAddress;
  return tc_state(x, dt, a, bm, h0, states, meta, hout, B, S, H, N, L,
                  static_cast<cudaStream_t>(stream));
}

// tc's second kernel alone (ssd_chunk_scan): y from the entering states
// and dacum / dt that ssd_state writes.
extern "C" int ssd_tc_chunk_launch(const void* x, const void* bm,
                                   const void* cm, const void* states,
                                   const void* meta, void* y, int B, int S,
                                   int H, int N, int L, void* stream) {
  if (!valid_shape(B, S, H, ssd::tc::kP, N, L) ||
      choose_variant(1, ssd::tc::kP, N, L) != kTc)
    return (int)cudaErrorInvalidValue;
  if (!tc_args_ok(x, bm, cm, states, meta))
    return (int)cudaErrorMisalignedAddress;
  return tc_chunk(x, bm, cm, states, meta, y, B, S, H, N, L,
                  static_cast<cudaStream_t>(stream));
}
