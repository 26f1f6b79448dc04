// Online-softmax (flash) grouped-query attention on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention / _flash_kernel).  That kernel walks a (B, Hq, nQ, nK)
// grid whose innermost kv axis runs in order on one core, carrying the
// running max, normaliser and accumulator in VMEM scratch from one grid
// step to the next.  Hopper's blocks run in parallel and in no order, so
// here the kv sweep is a loop inside a block, or is split across blocks and
// merged by a second kernel.
//
// Semantics, as in the Pallas kernel, in every variant: masking by position
// (kv positions >= 2^29 are padding; causal keeps kp <= qp; a window w keeps
// kp > qp - w); hidden scores take the finite NEG_INF (-0.7 * FLT_MAX);
// tanh softcap and an explicit scale; the kv head is h / (Hq / Hkv), taken
// from the index (no head replication); fp32 max, normaliser and
// accumulator; a row whose normaliser is 0 writes 0; the output [B, Sq,
// Hq, Dv] in the inputs' type, rounded once.  Keys past Skv take no part.
//
// The launcher picks one of three variants from the dtype and the shapes
// (choose_variant below; the Python wrapper's variant() is its twin):
//
// prefill_tc (flash_prefill_tc.cuh): bf16, (Dk, Dv) in {(64, 64), (80, 80),
//   (128, 128), (192, 128)} ((80, 80) is hubert's head dim; (192, 128)
//   deepseek-v2's MLA: 128 + 64 rope dims against a 128-wide V), more than 64
//   query rows per kv head (Sq x group).  Bound by
//   operations: 2 Sq Skv (Dk + Dv) FLOPs per head, halved by a causal mask, at
//   989 TFLOP/s on the bf16 tensor cores.  One block per (b, q head, 128-row q
//   tile), q heads fastest so a GQA group's blocks share K/V in L2, causal
//   tiles longest first.  Two consumer warpgroups own 64 q rows each; a third
//   warpgroup hands them its registers (setmaxnreg) and its first warp is the
//   producer.  The producer loads Q once and K/V tiles of 128 keys into a
//   2-stage ring by TMA (128-byte swizzle, mbarrier completion).  The kernel
//   is a template on (Dk, Dv): Q and K tiles are Dk wide, stored as Dk / 64
//   swizzled panels of 64 columns, V tiles and the accumulator Dv wide.  At
//   (192, 128) Q, the K ring and the V ring take 48 + 96 + 64 KB of the
//   block's 227 KB: the ring keeps both stages and 128-key tiles, and the
//   registers are those of D = 128 (S is 64 x 128 and O 64 x Dv fp32 a
//   warpgroup), so only S's k-steps grow, from 8 to 12.  A head dim that is
//   not a multiple of 64 is stored and computed at its panel width, rounded
//   up to 64: (80, 80) runs (128, 128)'s plan, TMA fills the columns past 80
//   with zeros (the tensor map's inner extent is the logical 80), S takes
//   ceil(80 / 16) = 5 k-steps, P V runs at N = 128 and the epilogue stores
//   the 80 real columns; its floor is (128 + 2 x 128) / 160 = 2.4x the
//   bound's operations.  Before it issues a tile it reads the tile's
//   positions (those of the next tile are already in flight), skips a tile
//   no row of the block can see, and flags per warpgroup whether every key
//   is hidden from it (it skips the tile) or some key is hidden from some
//   row (it runs the per-element mask: the causal diagonal, a window edge, a
//   ragged last tile).  Consumers run S = Q K^T on wgmma (both
//   operands in shared memory), the online softmax in fp32 on the accumulator
//   fragment, and P V as two register-A wgmmas, on P_hi = bf16(P) and P_lo =
//   bf16(P - P_hi), into one fp32 accumulator.  The split keeps ~16 bits of P:
//   a single bf16 P rounds the weights to 2^-9 and misses the two-ulp output
//   limit in the early causal rows, where a few large weights cancel.  It
//   costs (Dk + 2 Dv) / (Dk + Dv) times the function's operations, so this
//   design's floor is 1.5x the bound at Dk = Dv and 1.4x at (192, 128).
//
// decode_split (flash_decode_split.cuh): f32 or bf16, Dk = Dv in {64, 128},
//   at most 64 query rows per kv head (MLA's decode never reaches flash:
//   it runs as absorbed einsums).  Bound by bytes: reading the kv
//   cache once.  The group's q heads (x Sq) are the rows of one tile, so
//   each K/V byte is read once per (b, kv head), and the kv sweep is split
//   over n_split blocks (about two waves of 132 SMs, >= 64 keys a split).
//   Each split reads its keys' positions, then loads the visible ones in
//   segments of up to four 32-key tiles, each segment by one batch of
//   16-byte cp.async (tiles no row sees are neither loaded nor computed),
//   computes scores and P V in fp32 on the CUDA cores (a decode call's
//   arithmetic is a few microseconds there) and writes fp32 partials
//   (m, l, acc); a combine kernel weights split s by exp(m_s - m) over the
//   splits with l_s > 0 and rounds once.  On request it also writes each
//   row's fp32 log-sum-exp [B, Sq, Hq] from the same (m, l) pairs: the
//   softmax statistic a seq-sharded decode merges its ranks' chunks by.
//
// simt (flash_simt.cuh): everything else -- f32 prefill, other head dims
//   and (Dk, Dv) pairs, and (80, 80) and (192, 128) at 64 rows or fewer.
//   The name is historical (it first ran on the fp32 CUDA cores): one
//   block per (b, q head, 128 or 16 q rows), S = Q K^T and P V on the
//   tensor cores as split-TF32 mma.sync (each fp32 operand in two TF32
//   parts, three products for each; bf16 operands exact), K/V tiles of 32
//   keys by cp.async in a ring of two stages, split once for the block's
//   warps.  Bound by operations (three TF32 products at 495 TFLOP/s for
//   each fp32 one).  No model path the port runs at full width reaches it
//   but MLA's multi-token steps (bf16, few rows).
//
// On request every variant also writes each row's fp32 log-sum-exp [B, Sq,
// Hq] (m + log l) and leaves the output's bits as they are without it.  A
// row that saw no key gets kNegInf + log of the hidden keys its tiles held,
// or -inf where every tile was skipped: no weight in a merge.  The seq-sharded paths merge their ranks'
// chunks by it, and the backward recomputes P from it.
//
// The backward (its own entry point below): the input gradients of the same
// function from q, k, v, the output, its lse and the output's gradient,
// deterministic (no atomics), in one of two variants chosen from the dtype
// and the shapes alone (choose_backward_variant; backward_variant() in
// Python is its twin).  Both start with the pre-pass D = rowsum(dO O).
//
// tc (flash_backward_tc.cuh): bf16, (Dk, Dv) in {(64, 64), (80, 80), (128,
//   128), (192, 128)}, more than 64 query rows per kv head:
//   FlashAttention-2's backward on wgmma.  Bound by operations (S, dP, dV,
//   dK, dQ on the visible pairs: 2 (3 Dk + 2 Dv) flops a pair at 989
//   TFLOP/s).  dkdv_tc takes one block per (64 keys, b, kv head, share of
//   the GQA group): a producer warp loads K and V once and rings Q, dO and
//   the rows' lse, D and positions by TMA over the share's q tiles,
//   skipping the tiles whose positions hide every key from every row and
//   flagging those that need the per-element mask; one consumer warpgroup
//   computes S^T = K Q^T and dP^T = V dO^T (SS wgmma, m64n64), forms P^T
//   and dS^T in fp32 on the fragment, rounds each once to bf16 as a
//   register operand and accumulates dV += P^T dO and dK += dS^T Q (RS
//   wgmma) in fp32 registers.  At glm4's GQA (Hkv 2, B 1, S 2048) B x Hkv x
//   key tiles is 64 blocks for 132 SMs, so when it falls short of two waves
//   the group's q heads are split over blocks (4 shares of 4 heads there):
//   each writes fp32 partials and reduce_tc sums them in order and rounds
//   once.  dq_tc takes one block per (64 rows, b, q head), longest causal
//   tiles first: Q and dO once, a 2-stage ring of 64-key K/V tiles, S and
//   dP (SS wgmma), dS rounded once, dQ += dS K (RS wgmma).  P and dS are
//   single bf16 roundings (the forward's P_hi + P_lo split is not needed: a
//   gradient's limit is 2e-2 of its largest element).
//   One warpgroup holds dK and dV (Dk / 2 + Dv / 2 fp32 registers a thread,
//   64 + 64 at (128, 128)) beside S and dP (32 + 32).  At MLA's (192, 128)
//   that is 96 + 64 + 64: 255 registers and a spill, so its dK and dV come
//   from dkdv_tc2, two consumer warpgroups and the producer (288 threads,
//   224 registers a thread at most).  A owns S, P and dV (32 + 64 fp32), B
//   dP, dS and dK (32 + 96), 64 x 64 x 320 of products a tile each; A hands
//   B each tile's P^T (times 1 - tanh^2 under a softcap) through two fp32
//   64 x 64 buffers in shared memory, as both fragments map a thread index
//   to the same elements, and a 3-stage Q/dO ring keeps A up to two tiles
//   ahead (40 + 32 + 3 x 41 KB of shared memory).  The other way to fit,
//   dK in two 96-column halves over separate blocks that each recompute S
//   and dP, costs 38% more operations and reads Q and dO twice.
//   dq_tc<192, 128> fits one warpgroup (S, dP and dQ: 32 + 32 + 96).
// simt (flash_backward.cuh): everything else -- f32, other head dims and
//   pairs, and 64 rows or fewer per kv head (decode_split's shapes under
//   grad).  Three kernels (the pre-pass, dK/dV per key tile with a pair of
//   warps per 16 keys, dQ per q tile), the products split-TF32 mma.sync as
//   the forward simt's; the name is historical, as there.
//
// The kernels allocate nothing and do not synchronise: decode_split's
// partials live in a scratch the caller allocates.  The launcher returns
// cudaGetLastError() so a refused launch is reported at once.

#include "flash_backward.cuh"
#include "flash_backward_tc.cuh"
#include "flash_common.cuh"
#include "flash_decode_split.cuh"
#include "flash_prefill_tc.cuh"
#include "flash_simt.cuh"

namespace {

enum Variant { kSimt = 0, kPrefillTc = 1, kDecodeSplit = 2 };

int choose_variant(int dtype, int Sq, int Hq, int Hkv, int Dk, int Dv) {
  const bool square = Dk == Dv && (Dk == 64 || Dk == 128);
  const bool prefill_dims =
      square || (Dk == 80 && Dv == 80) || (Dk == 192 && Dv == 128);
  const long long rows = (long long)Sq * (Hq / Hkv);
  const bool few_rows = rows <= flash::decode_split::kMaxRows;
  if (square && few_rows) return kDecodeSplit;
  if (prefill_dims && !few_rows && dtype == 1) return kPrefillTc;
  return kSimt;
}

enum BackwardVariant { kBwdSimt = 0, kBwdTc = 1 };

int choose_backward_variant(int dtype, int Sq, int Hq, int Hkv, int Dk,
                            int Dv) {
  const bool dims = (Dk == 64 && Dv == 64) || (Dk == 80 && Dv == 80) ||
                    (Dk == 128 && Dv == 128) || (Dk == 192 && Dv == 128);
  const long long rows = (long long)Sq * (Hq / Hkv);
  return dtype == 1 && dims && rows > flash::decode_split::kMaxRows
             ? kBwdTc
             : kBwdSimt;
}

// the backward's fp32 scratch: D for every row (rounded up to 16 bytes),
// then tc's dK / dV partials where it splits the GQA group
long long backward_scratch_floats(int var, int B, int Sq, int Skv, int Hq,
                                  int Hkv, int Dk, int Dv) {
  const long long rows = ((long long)B * Sq * Hq + 3) / 4 * 4;
  return rows + (var == kBwdTc ? flash::backward_tc::partial_floats(
                                     B, Skv, Hq, Hkv, Dk, Dv)
                               : 0);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
int launch_decode(const void* q, const void* k, const void* v,
                  const void* qpos, const void* kpos, void* out, float* lse,
                  float* part, int B, int Sq, int Skv, int Hq, int Hkv, int D,
                  float scale, float softcap, int causal, int window,
                  cudaStream_t s) {
  if (D == 64)
    return flash::decode_split::launch<T, 64>(q, k, v, qpos, kpos, out, lse,
                                              part, B, Sq, Skv, Hq, Hkv,
                                              scale, softcap, causal, window,
                                              s);
  return flash::decode_split::launch<T, 128>(q, k, v, qpos, kpos, out, lse,
                                             part, B, Sq, Skv, Hq, Hkv, scale,
                                             softcap, causal, window, s);
}

}  // namespace

// The variant the launcher takes for these arguments (0 simt, 1 prefill_tc,
// 2 decode_split), and the fp32 scratch it needs (0 but for decode_split).
extern "C" int flash_attention_variant(int dtype, int B, int Sq, int Skv,
                                       int Hq, int Hkv, int Dk, int Dv,
                                       long long* scratch_floats) {
  const int var = choose_variant(dtype, Sq, Hq, Hkv, Dk, Dv);
  *scratch_floats = var == kDecodeSplit
      ? flash::decode_split::scratch_floats(B, Hkv, Skv, Sq * (Hq / Hkv), Dv)
      : 0;
  return var;
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).
// window <= 0: no sliding window.  softcap <= 0: no softcap.
// scratch: fp32, at least flash_attention_variant's scratch_floats.
// lse: null, or fp32 [B, Sq, Hq] for the rows' log-sum-exp.  *chosen
// receives the variant launched.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, const void* qpos,
                                      const void* kpos, void* out, int dtype,
                                      int B, int Sq, int Skv, int Hq, int Hkv,
                                      int Dk, int Dv, float scale,
                                      float softcap, int causal, int window,
                                      void* scratch,
                                      long long scratch_floats, int* chosen,
                                      void* lse, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Dk <= 0 ||
      Dk > 256 || Dv <= 0 || Dv > 256 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int var = choose_variant(dtype, Sq, Hq, Hkv, Dk, Dv);
  *chosen = var;
  if (var != kSimt &&
      !(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out)))
    return (int)cudaErrorMisalignedAddress;
  float* l = static_cast<float*>(lse);
  if (var == kPrefillTc) {
    if (Dk == 64)
      return flash::prefill_tc::launch<64, 64>(q, k, v, qpos, kpos, out, l, B,
                                               Sq, Skv, Hq, Hkv, scale,
                                               softcap, causal, window, s);
    if (Dk == 80)
      return flash::prefill_tc::launch<80, 80>(q, k, v, qpos, kpos, out, l, B,
                                               Sq, Skv, Hq, Hkv, scale,
                                               softcap, causal, window, s);
    if (Dk == 128)
      return flash::prefill_tc::launch<128, 128>(q, k, v, qpos, kpos, out, l,
                                                 B, Sq, Skv, Hq, Hkv, scale,
                                                 softcap, causal, window, s);
    return flash::prefill_tc::launch<192, 128>(q, k, v, qpos, kpos, out, l,
                                               B, Sq, Skv, Hq, Hkv, scale,
                                               softcap, causal, window, s);
  }
  if (var == kDecodeSplit) {
    const long long need = flash::decode_split::scratch_floats(
        B, Hkv, Skv, Sq * (Hq / Hkv), Dv);
    if (scratch == nullptr || scratch_floats < need)
      return (int)cudaErrorInvalidValue;
    float* part = static_cast<float*>(scratch);
    if (dtype == 0)
      return launch_decode<float>(q, k, v, qpos, kpos, out, l, part, B, Sq,
                                  Skv, Hq, Hkv, Dk, scale, softcap, causal,
                                  window, s);
    return launch_decode<__nv_bfloat16>(q, k, v, qpos, kpos, out, l, part, B,
                                        Sq, Skv, Hq, Hkv, Dk, scale, softcap,
                                        causal, window, s);
  }
  if (dtype == 0)
    return flash::simt::dispatch_bq<float>(q, k, v, qpos, kpos, out, l, B, Sq,
                                           Skv, Hq, Hkv, Dk, Dv, scale,
                                           softcap, causal, window, s);
  return flash::simt::dispatch_bq<__nv_bfloat16>(q, k, v, qpos, kpos, out, l,
                                                 B, Sq, Skv, Hq, Hkv, Dk, Dv,
                                                 scale, softcap, causal,
                                                 window, s);
}

// The backward variant for these arguments (0 simt, 1 tc) and the fp32
// scratch it needs.
extern "C" int flash_attention_backward_variant(int dtype, int B, int Sq,
                                                int Skv, int Hq, int Hkv,
                                                int Dk, int Dv,
                                                long long* scratch_floats) {
  const int var = choose_backward_variant(dtype, Sq, Hq, Hkv, Dk, Dv);
  *scratch_floats =
      backward_scratch_floats(var, B, Sq, Skv, Hq, Hkv, Dk, Dv);
  return var;
}

// The input gradients dq, dk, dv (the inputs' shapes and dtype) of the
// forward above for the output gradient dout, from the forward's out and
// lse (fp32 [B, Sq, Hq]).  scratch: fp32, at least
// flash_attention_backward_variant's scratch_floats, 16-byte aligned.
// Arguments as the forward's otherwise.  want: -1 the launcher's choice, 0
// simt at any shape (to time it beside tc), 1 tc (refused where the shapes
// do not take it); *chosen receives the variant launched.
extern "C" int flash_attention_backward_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, const void* qpos, const void* kpos,
    void* dq, void* dk, void* dv, void* scratch, long long scratch_floats,
    int dtype, int B, int Sq, int Skv, int Hq, int Hkv, int Dk, int Dv,
    float scale, float softcap, int causal, int window, int want, int* chosen,
    void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Dk <= 0 ||
      Dk > 256 || Dv <= 0 || Dv > 256 || (dtype != 0 && dtype != 1) ||
      lse == nullptr || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const int var =
      want == 0 ? 0 : choose_backward_variant(dtype, Sq, Hq, Hkv, Dk, Dv);
  *chosen = var;
  if (want > 0 && want != var) return (int)cudaErrorInvalidValue;
  if (scratch_floats <
      backward_scratch_floats(var, B, Sq, Skv, Hq, Hkv, Dk, Dv))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(scratch);
  if (var == kBwdTc) {
    if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout) &&
          aligned16(scratch)))
      return (int)cudaErrorMisalignedAddress;
    float* part = d + ((long long)B * Sq * Hq + 3) / 4 * 4;
    if (Dk == 64)
      return flash::backward_tc::launch<64, 64>(
          q, k, v, out, dout, l, qpos, kpos, dq, dk, dv, d, part, B, Sq, Skv,
          Hq, Hkv, scale, softcap, causal, window, s);
    if (Dk == 80)
      return flash::backward_tc::launch<80, 80>(
          q, k, v, out, dout, l, qpos, kpos, dq, dk, dv, d, part, B, Sq, Skv,
          Hq, Hkv, scale, softcap, causal, window, s);
    if (Dk == 128)
      return flash::backward_tc::launch<128, 128>(
          q, k, v, out, dout, l, qpos, kpos, dq, dk, dv, d, part, B, Sq, Skv,
          Hq, Hkv, scale, softcap, causal, window, s);
    return flash::backward_tc::launch<192, 128>(
        q, k, v, out, dout, l, qpos, kpos, dq, dk, dv, d, part, B, Sq, Skv,
        Hq, Hkv, scale, softcap, causal, window, s);
  }
  if (dtype == 0)
    return flash::backward::launch<float>(q, k, v, out, dout, l, qpos, kpos,
                                          dq, dk, dv, d, B, Sq, Skv, Hq, Hkv,
                                          Dk, Dv, scale, softcap, causal,
                                          window, s);
  return flash::backward::launch<__nv_bfloat16>(
      q, k, v, out, dout, l, qpos, kpos, dq, dk, dv, d, B, Sq, Skv, Hq, Hkv,
      Dk, Dv, scale, softcap, causal, window, s);
}
