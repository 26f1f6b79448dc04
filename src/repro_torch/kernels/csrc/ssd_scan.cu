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
//   32 or not a multiple of 64.  The name is historical (PR 12's kernel ran
//   on the fp32 CUDA cores): tc's two-kernel plan on split-TF32 mma.sync.
//   state_kernel carries the fp32 state of one (64 columns of N, head, b)
//   through the chunks in its accumulators and writes the state entering
//   each chunk (fp32) and the chunk's dacum / dt (a serial fp32 sum) to
//   scratch; chunk_kernel computes y per (b, chunk, 64-row strip, 2 heads)
//   in parallel, C B^T once for its heads.  Each fp32 operand is taken as
//   two TF32 parts and each product as three (~22 of fp32's 24 bits), x,
//   B and C arrive by cp.async in rings of two stages; f32 stays within
//   2e-5 of max |y|.  Bound by operations at f32's full widths (split-TF32
//   at a third of the TF32 rate); by bytes at launch-sized shapes.
//
// The backward (its own entry point below): the gradients of the same scan
// (x, dt, A, B, C and h0) for dy and the final state's gradient, in three
// phases -- the entering states, a reverse pass over the chunks carrying
// the state's gradient, then every chunk's own gradients in parallel -- and
// fixed-order sums over heads and (b, chunk) (no atomics: two calls give
// equal bits).  Two variants, chosen as the forward's (the same shapes take
// tc; backward_variant() in Python is the twin):
//
// tc (ssd_backward_tc.cuh): the forward tc's shapes.  (i) is the forward's
//   ssd_state kernel itself (bf16 entering states, fp32 dacum and dt). (ii)
//   stays on the CUDA cores (own_kernel, scan_kernel), the largest part of tc's
//   time that is left.  (iii) chunk_tc, one warpgroup per (b, chunk, 2 heads at
//   N 64, 1 at N 128), puts every product on wgmma as 64 x 64 bf16 tiles with
//   fp32 accumulators, fed by TMA (a 2-stage ring, 97 KB of shared memory, two
//   blocks an SM).  Pass A walks row tiles I against column tiles J <= I: C_I
//   B_J^T once for the block's heads, per head dW = dY_I X_J^T, dCB = dW * M *
//   dt in fp32 on the fragment (the decay M from fp32 dacum by the SFU's ex2),
//   its rows' sums against CB for d(dacum), then dC_I += bf16(dCB) B_J
//   (register-A wgmma); the carried state's term dY_I h_in (SS wgmma) scaled by
//   exp(dacum) in fp32.  Pass B walks column tiles J against I >= J in the
//   transposed orientation: B_J C_I^T once, per head X_J dY_I^T, then dx_J +=
//   bf16(CB^T * M^T) dY_I and dB_J += bf16(dCB^T) C_I (register-A wgmma), and
//   the leaving state's terms B_J G^T and X_J G (G, its gradient, rounded to
//   bf16 in shared memory).  Each tile is rounded once, after its decay; the
//   d(dacum) sums stay fp32 products of the fp32 accumulators.  dB and dC leave
//   as fp32 partials per head group and reduce_kernel sums them in order.
//   Bound by bytes, as the forward.
// simt (ssd_backward.cuh): everything else (f32, other shapes): the same
//   three phases with every product on split-TF32 mma.sync, as the forward
//   simt: (i) each chunk's own state in parallel (fp32) and a scan, (ii)
//   as tc's, (iii) per (b, chunk, 2 heads in bf16 at N <= 64, else 1).
//
// The kernels allocate nothing and do not synchronise: the entering states
// and dacum / dt, and the backward's fp32 partials, live in scratch the
// caller allocates.  The
// launcher returns cudaGetLastError() so a refused launch is reported at
// once; a tc-shaped call never falls back to simt.

#include "ssd_backward.cuh"
#include "ssd_backward_tc.cuh"
#include "ssd_simt.cuh"
#include "ssd_tc.cuh"

namespace {

enum Variant { kSimt = 0, kTc = 1 };

int choose_variant(int dtype, int P, int N, int L) {
  const bool tc = dtype == 1 && P == ssd::tc::kP && (N == 64 || N == 128) &&
                  L % ssd::tc::kT == 0 && L <= ssd::tc::kMaxL;
  return tc ? kTc : kSimt;
}

// the backward takes tc where the forward does
long long backward_scratch_floats(int var, int dtype, int B, int S, int H,
                                  int P, int N, int L) {
  return var == kTc
             ? ssd::backward_tc::scratch_layout(B, S, H, N, L).total
             : ssd::backward::scratch_floats(B, S, H, P, N, L,
                                             dtype == 1 ? 2 : 4);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

bool valid_shape(int B, int S, int H, int P, int N, int L) {
  return B > 0 && S > 0 && L > 0 && S % L == 0 && H > 0 && P > 0 && N > 0;
}

// The forward's scratch: entering states (bf16 elements for tc, floats for
// simt) and dacum / dt (floats)
void fwd_scratch(int var, int B, int S, int H, int P, int N, int L,
                 long long* state_elems, long long* meta_floats) {
  if (var == kSimt) {
    ssd::simt::scratch_floats(B, S, H, P, N, L, state_elems, meta_floats);
    return;
  }
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
// its scratch: entering states in elements (tc bf16, simt fp32), dacum /
// dt in floats.
extern "C" int ssd_scan_variant(int dtype, int B, int S, int H, int P, int N,
                                int L, long long* state_elems,
                                long long* meta_floats) {
  const int var = choose_variant(dtype, P, N, L);
  *state_elems = *meta_floats = 0;
  if (valid_shape(B, S, H, P, N, L))
    fwd_scratch(var, B, S, H, P, N, L, state_elems, meta_floats);
  return var;
}

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y share it); dt, a, h0 and
// the final state are float32; S is a multiple of L.  states / meta hold
// at least ssd_scan_variant's scratch (tc: bf16 states; simt: fp32),
// 16-byte aligned.  simt: P <= 64; N <= 128 and a multiple of 4.  tc: x, B
// and C 16-byte aligned.  *chosen receives the variant launched.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a,
                               const void* bm, const void* cm, const void* h0,
                               void* y, void* hout, void* states, void* meta,
                               int dtype, int B, int S, int H, int P, int N,
                               int L, long long state_elems,
                               long long meta_floats, int* chosen,
                               void* stream) {
  if (!valid_shape(B, S, H, P, N, L) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int var = choose_variant(dtype, P, N, L);
  *chosen = var;
  long long need_states, need_meta;
  fwd_scratch(var, B, S, H, P, N, L, &need_states, &need_meta);
  if (state_elems < need_states || meta_floats < need_meta)
    return (int)cudaErrorInvalidValue;
  if (var == kTc) {
    if (!tc_args_ok(x, bm, cm, states, meta))
      return (int)cudaErrorMisalignedAddress;
    const int err =
        tc_state(x, dt, a, bm, h0, states, meta, hout, B, S, H, N, L, s);
    if (err) return err;
    return tc_chunk(x, bm, cm, states, meta, y, B, S, H, N, L, s);
  }
  if (P > ssd::simt::kPMax || N > ssd::simt::kNMax || N % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (states == nullptr || meta == nullptr || !aligned16(states) ||
      !aligned16(meta))
    return (int)cudaErrorMisalignedAddress;
  float* st = static_cast<float*>(states);
  float* mt = static_cast<float*>(meta);
  if (dtype == 0)
    return ssd::simt::launch<float>(x, dt, a, bm, cm, h0, y, hout, st, mt, B,
                                    S, H, P, N, L, s);
  return ssd::simt::launch<__nv_bfloat16>(x, dt, a, bm, cm, h0, y, hout, st,
                                          mt, B, S, H, P, N, L, s);
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

// The backward variant for these arguments (0 simt, 1 tc) and the fp32
// scratch it needs.
extern "C" int ssd_scan_backward_variant(int dtype, int B, int S, int H,
                                         int P, int N, int L,
                                         long long* scratch_floats) {
  const int var = choose_variant(dtype, P, N, L);
  *scratch_floats = valid_shape(B, S, H, P, N, L)
                        ? backward_scratch_floats(var, dtype, B, S, H, P, N, L)
                        : 0;
  return var;
}

// The gradients dx (x's type), ddt (f32 [B, S, H]), da (f32 [H]), db and dc
// (x's type, [B, S, 1, N]) and dh0 (f32 [B, H, P, N]) of ssd_scan_launch's
// scan for dy (x's type) and dfinal (f32 [B, H, P, N], or null: zero).  h0
// null: zeros.  scratch: fp32, at least ssd_scan_backward_variant's
// scratch_floats, 16-byte aligned.  P <= 64; N <= 128 and a multiple of 4;
// S a multiple of L.  want: -1 the launcher's choice, 0 simt at any shape
// (to time it beside tc), 1 tc (refused where the shapes do not take it);
// *chosen receives the variant launched.
extern "C" int ssd_scan_backward_launch(
    const void* x, const void* dt, const void* a, const void* bm,
    const void* cm, const void* h0, const void* dy, const void* dfinal,
    void* dx, void* ddt, void* da, void* db, void* dc, void* dh0,
    void* scratch, long long scratch_floats, int dtype, int B, int S, int H,
    int P, int N, int L, int want, int* chosen, void* stream) {
  if (!valid_shape(B, S, H, P, N, L) || (dtype != 0 && dtype != 1) ||
      P > ssd::backward::kPMax || N > ssd::backward::kNMax || N % 4 != 0 ||
      scratch == nullptr || dh0 == nullptr)
    return (int)cudaErrorInvalidValue;
  const int var = want == 0 ? 0 : choose_variant(dtype, P, N, L);
  *chosen = var;
  if (want > 0 && want != var) return (int)cudaErrorInvalidValue;
  if (scratch_floats < backward_scratch_floats(var, dtype, B, S, H, P, N, L))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  if (var == kTc) {
    if (!(aligned16(x) && aligned16(bm) && aligned16(cm) && aligned16(dy) &&
          aligned16(scratch) && (h0 == nullptr || aligned16(h0))))
      return (int)cudaErrorMisalignedAddress;
    if (N == 64)
      return ssd::backward_tc::launch<64>(x, dt, a, bm, cm, h0, dy, dfinal,
                                          dx, ddt, da, db, dc, dh0, sc, B, S,
                                          H, L, s);
    return ssd::backward_tc::launch<128>(x, dt, a, bm, cm, h0, dy, dfinal, dx,
                                         ddt, da, db, dc, dh0, sc, B, S, H, L,
                                         s);
  }
  if (dtype == 0)
    return ssd::backward::launch<float>(x, dt, a, bm, cm, h0, dy, dfinal, dx,
                                        ddt, da, db, dc, dh0, sc, B, S, H, P,
                                        N, L, s);
  return ssd::backward::launch<__nv_bfloat16>(x, dt, a, bm, cm, h0, dy,
                                              dfinal, dx, ddt, da, db, dc,
                                              dh0, sc, B, S, H, P, N, L, s);
}
