// Batched TL2 certification on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/lease_validate.py
// (lease_validate / _validate_kernel).  That kernel tiles the version
// table into VMEM chunks and replaces the gather by a chunk-local masked
// compare, because the TPU has no fast random gather.  Hopper does: the
// version table of a replica (4.6 MB at 1.14 M items) sits in the 50 MB
// L2, so each read or write slot is one direct gather.
//
// Design: one warp per transaction, WARPS_PER_BLOCK transactions per
// block.  The lanes stride over the R read slots and then the W write
// slots (neighbouring lanes load neighbouring slots: the row loads are
// coalesced), gather store_versions[item] / write_locks[item], and OR a
// per-lane "bad" flag.  __any_sync combines the warp and lane 0 writes
// ok[b].  A slot with a negative item always passes; an item past the end
// is clipped to n_items - 1, as in repro.kernels.ref.lease_validate_ref.
//
// Bound: bytes.  Per transaction it moves 8*R + 4*W bytes of rows plus
// one 4-byte gather per valid slot and does one compare per slot, so at
// every shape it is far below the card's compare rate.  At the shapes the
// simulator gives it (B = 8..16 transactions) it is bound by the launch.
//
// The kernel allocates nothing and does not synchronise; the launcher
// returns cudaGetLastError() so a refused launch is reported at once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
lease_validate_kernel(const int32_t* __restrict__ store_versions,
                      const int32_t* __restrict__ read_items,
                      const int32_t* __restrict__ read_versions,
                      const int32_t* __restrict__ write_locks,
                      const int32_t* __restrict__ write_items,
                      uint8_t* __restrict__ ok,
                      int n_items, int n_txns, int n_reads, int n_writes) {
  const int lane = threadIdx.x % kWarp;
  const int txn = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (txn >= n_txns) return;  // warp-uniform: the whole warp leaves
  const int last = n_items - 1;

  bool bad = false;
  const int32_t* items = read_items + (int64_t)txn * n_reads;
  const int32_t* vers = read_versions + (int64_t)txn * n_reads;
  for (int r = lane; r < n_reads; r += kWarp) {
    const int32_t item = __ldg(items + r);
    if (item >= 0) {
      const int32_t cur = __ldg(store_versions + min(item, last));
      bad |= cur != __ldg(vers + r);
    }
  }
  const int32_t* witems = write_items + (int64_t)txn * n_writes;
  for (int w = lane; w < n_writes; w += kWarp) {
    const int32_t item = __ldg(witems + w);
    if (item >= 0) bad |= __ldg(write_locks + min(item, last)) > 0;
  }
  const bool any_bad = __any_sync(0xffffffffu, bad);
  if (lane == 0) ok[txn] = any_bad ? 0 : 1;
}

}  // namespace

extern "C" int lease_validate_launch(const void* store_versions,
                                     const void* read_items,
                                     const void* read_versions,
                                     const void* write_locks,
                                     const void* write_items, void* ok,
                                     int n_items, int n_txns, int n_reads,
                                     int n_writes, void* stream) {
  const int blocks = (n_txns + kWarpsPerBlock - 1) / kWarpsPerBlock;
  lease_validate_kernel<<<blocks, kWarp * kWarpsPerBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(store_versions),
      static_cast<const int32_t*>(read_items),
      static_cast<const int32_t*>(read_versions),
      static_cast<const int32_t*>(write_locks),
      static_cast<const int32_t*>(write_items), static_cast<uint8_t*>(ok),
      n_items, n_txns, n_reads, n_writes);
  return static_cast<int>(cudaGetLastError());
}
