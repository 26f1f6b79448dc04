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
//   One block per (b, q head, q tile) on the fp32 CUDA cores.  No model
//   path the port runs at full width reaches it.
//
// The kernels allocate nothing and do not synchronise: decode_split's
// partials live in a scratch the caller allocates.  The launcher returns
// cudaGetLastError() so a refused launch is reported at once.

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
// lse: null, or fp32 [B, Sq, Hq] for the rows' log-sum-exp (decode_split
// only: another variant refuses it).  *chosen receives the variant launched.
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
  if (lse != nullptr && var != kDecodeSplit)
    return (int)cudaErrorInvalidValue;
  if (var != kSimt &&
      !(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out)))
    return (int)cudaErrorMisalignedAddress;
  if (var == kPrefillTc) {
    if (Dk == 64)
      return flash::prefill_tc::launch<64, 64>(q, k, v, qpos, kpos, out, B,
                                               Sq, Skv, Hq, Hkv, scale,
                                               softcap, causal, window, s);
    if (Dk == 80)
      return flash::prefill_tc::launch<80, 80>(q, k, v, qpos, kpos, out, B,
                                               Sq, Skv, Hq, Hkv, scale,
                                               softcap, causal, window, s);
    if (Dk == 128)
      return flash::prefill_tc::launch<128, 128>(q, k, v, qpos, kpos, out, B,
                                                 Sq, Skv, Hq, Hkv, scale,
                                                 softcap, causal, window, s);
    return flash::prefill_tc::launch<192, 128>(q, k, v, qpos, kpos, out, B,
                                               Sq, Skv, Hq, Hkv, scale,
                                               softcap, causal, window, s);
  }
  if (var == kDecodeSplit) {
    const long long need = flash::decode_split::scratch_floats(
        B, Hkv, Skv, Sq * (Hq / Hkv), Dv);
    if (scratch == nullptr || scratch_floats < need)
      return (int)cudaErrorInvalidValue;
    float* part = static_cast<float*>(scratch);
    float* l = static_cast<float*>(lse);
    if (dtype == 0)
      return launch_decode<float>(q, k, v, qpos, kpos, out, l, part, B, Sq,
                                  Skv, Hq, Hkv, Dk, scale, softcap, causal,
                                  window, s);
    return launch_decode<__nv_bfloat16>(q, k, v, qpos, kpos, out, l, part, B,
                                        Sq, Skv, Hq, Hkv, Dk, scale, softcap,
                                        causal, window, s);
  }
  if (dtype == 0)
    return flash::simt::dispatch_bq<float>(q, k, v, qpos, kpos, out, B, Sq,
                                           Skv, Hq, Hkv, Dk, Dv, scale,
                                           softcap, causal, window, s);
  return flash::simt::dispatch_bq<__nv_bfloat16>(q, k, v, qpos, kpos, out, B,
                                                 Sq, Skv, Hq, Hkv, Dk, Dv,
                                                 scale, softcap, causal,
                                                 window, s);
}
