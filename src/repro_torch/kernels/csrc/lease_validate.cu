// Batched TL2 certification on Hopper (sm_90a): two variants.
//
// Both replace the Pallas TPU kernel repro/kernels/lease_validate.py
// (lease_validate / _validate_kernel).  That kernel tiles the version
// table into VMEM chunks and replaces the gather by a chunk-local masked
// compare, because the TPU has no fast random gather.  Hopper does: the
// version table of a replica (4.6 MB at 1.14 M items) sits in the 50 MB
// L2, so each read or write slot is one direct gather.
//
// ---------------------------------------------------------------------------
// gather: certification against a per-item lock table
// ---------------------------------------------------------------------------
//
// One warp per transaction, kWarpsPerBlock transactions per block.  The
// lanes stride over the R read slots and then the W write slots
// (neighbouring lanes load neighbouring slots: the row loads are
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
//
// ---------------------------------------------------------------------------
// drain: one certification drain in one launch (lease_drain_launch)
// ---------------------------------------------------------------------------
//
// A drain used to be some eight device operations around gather: a
// per-item lock table derived over every item (an int64 gather through
// item -> class and three elementwise passes), a scatter of the store's
// written versions, three pageable host->device copies and a blocking
// copy back.  At the simulator's shapes the kernel itself is a ~2 us
// launch; the drain cost ~10x that in launches, copies and dispatch.  The
// drain variant does the whole composition in one launch:
//
//   phase 1  scatter the store's dirty (item, version) pairs into the int32
//            device version table;
//   phase 2  certify each transaction against the updated table: reads as
//            in gather; a write item is locked when
//            owner = owners[item_cc[item]] has owner >= 0 && owner != node,
//            the cluster's per-item lock rule applied to the write slots
//            only (B * W lookups instead of n_items).
//
// Inputs.  The host packs everything a drain needs (a header, the dirty
// pairs, the class owners, the read rows as (item, version) pairs and the
// write rows) into one staging area of pinned, device-mapped memory
// (cudaHostAllocMapped, one per store, lease_staging_alloc), and the
// kernel writes ok[B] back into the same area.  Zero-copy: the kernel reads
// the few KB over PCIe where they lie, so no copy is enqueued (one
// cudaMemcpyAsync of the area first measured slower on the card: PERF.md).
// A thread issues all of its first loads of the area (its first dirty
// pair, its warp's first read pair and first write item) before phase 1,
// so that they share one PCIe round trip.  The launcher reads the header on
// the host, checks it and every dirty index, and passes the scalars as
// kernel parameters.  The area is reused by the next drain: that is safe
// only because every drain waits for its verdicts (wait = 1:
// cudaStreamSynchronize inside the same call) before the host packs the
// next one.
//
// Grid (drain::plan; kernels/lease_validate.py: variant() is its twin):
//   - one CTA of 1024 threads (one warp per transaction) when B <= 32 and
//     n_dirty <= 8192 (8 pairs a thread): phase 1 over all threads,
//     __syncthreads(), phase 2;
//   - otherwise ctas = max(ceil(B / 32), ceil(n_dirty / 8192)) CTAs; up to
//     8 (the portable cluster size) they form one thread-block cluster
//     and barrier.cluster.arrive.release / wait.acquire separates the
//     phases;
//   - above 8, two launches on the stream: the scatter, then the
//     certification.
//
// Trap: phase 2 reads the version table that phase 1 wrote in the same
// launch.  So the table pointer is neither const nor __restrict__ and its
// loads are __ldcg (L2, never the non-coherent or L1 path); item_cc is
// read-only device memory and uses __ldg.  The write check reads no table
// entry, so it runs before the phase barrier, behind the scatter.  A class
// outside [0, n_classes) fails closed (the slot counts as locked).
//
// Bound: bytes, as gather, plus 8 bytes a dirty pair; at these shapes the
// launch, two PCIe round trips (the rows, then the owners of the write
// items' classes) and the wait bound it.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

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


namespace drain {

constexpr int kThreads = 1024;                   // 32 warps
constexpr int kTxnsPerCta = kThreads / kWarp;    // one warp per transaction
constexpr int kDirtyPerCta = 8 * kThreads;       // 8 pairs a thread
constexpr int kMaxCluster = 8;                   // portable cluster size
constexpr int kHeaderWords = 8;

// launcher refusals (CUDA errors are positive)
constexpr int kBadHeader = -1;
constexpr int kAreaTooSmall = -2;
constexpr int kBadDirtyItem = -3;
constexpr int kClassViewMismatch = -4;
constexpr int kNoUnifiedAddress = -5;

// Word offsets of the staging area's sections, each padded to 16 bytes:
// header[8] = {n_dirty, B, R, W, node, n_classes, 0, 0}, dirty_idx,
// dirty_ver, owners, reads [B, R, 2] as (item, version) pairs (the host
// copies each transaction's interleaved read log into its row as it is),
// write_items [B, W], ok [B] bytes.  kernels/lease_validate.py's
// drain_layout() is its twin.
struct Layout {
  long long dirty_idx, dirty_ver, owners, reads, write_items, ok, bytes;
};

inline long long pad4(long long words) { return (words + 3) & ~3LL; }

Layout layout(long long n_dirty, long long b, long long r, long long w,
              long long n_classes) {
  Layout l;
  l.dirty_idx = kHeaderWords;
  l.dirty_ver = l.dirty_idx + pad4(n_dirty);
  l.owners = l.dirty_ver + pad4(n_dirty);
  l.reads = l.owners + pad4(n_classes);
  l.write_items = l.reads + pad4(2 * b * r);
  l.ok = l.write_items + pad4(b * w);
  l.bytes = 4 * (l.ok + pad4((b + 3) / 4));
  return l;
}

struct Plan {
  int ctas, kernels;
};

Plan plan(int b, int n_dirty) {
  const int ctas = std::max({1, (b + kTxnsPerCta - 1) / kTxnsPerCta,
                             (n_dirty + kDirtyPerCta - 1) / kDirtyPerCta});
  return {ctas, ctas <= kMaxCluster ? 1 : 2};
}

struct Args {
  int32_t* table;                        // written in phase 1, read in 2
  const int32_t* __restrict__ item_cc;   // [n_items] or null: no class view
  const int32_t* dirty_idx;              // the rest: mapped host memory
  const int32_t* dirty_ver;
  const int32_t* owners;
  const int32_t* reads;                  // [B, R, 2] (item, version)
  const int32_t* write_items;
  uint8_t* ok;
  int n_items, n_dirty, b, r, w, node, n_classes;
};

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// A write item is locked when its class is owned by another replica; a
// class outside the owners fails closed.
__device__ __forceinline__ bool locked(const Args& a, int32_t item) {
  const int32_t cc = __ldg(a.item_cc + min(item, a.n_items - 1));
  if (static_cast<unsigned>(cc) >= static_cast<unsigned>(a.n_classes))
    return true;
  const int32_t owner = a.owners[cc];
  return owner >= 0 && owner != a.node;
}

template <bool kScatter, bool kCertify>
__global__ void __launch_bounds__(kThreads)
drain_kernel(Args a, int clustered) {
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int txn = blockIdx.x * kTxnsPerCta + warp;
  const bool mine = kCertify && txn < a.b;  // warp-uniform
  const bool classes = a.item_cc != nullptr;
  const int2* pairs = reinterpret_cast<const int2*>(a.reads) +
                      static_cast<int64_t>(txn) * a.r;
  const int32_t* witems = a.write_items + static_cast<int64_t>(txn) * a.w;

  // This thread's first loads of the area, all in flight at once.
  const int first = blockIdx.x * kThreads + tid;
  int32_t dirty_item = -1, dirty_ver = 0;
  if (kScatter && first < a.n_dirty) {
    dirty_item = a.dirty_idx[first];
    dirty_ver = a.dirty_ver[first];
  }
  int2 read0 = make_int2(-1, 0);
  int32_t write0 = -1;
  if (mine && lane < a.r) read0 = pairs[lane];
  if (mine && classes && lane < a.w) write0 = witems[lane];

  // phase 1: the dirty pairs into the version table, over every thread
  if (kScatter) {
    if (dirty_item >= 0) a.table[dirty_item] = dirty_ver;
    const int stride = gridDim.x * kThreads;
    for (int i = first + stride; i < a.n_dirty; i += stride)
      a.table[a.dirty_idx[i]] = a.dirty_ver[i];
  }

  // The write check reads no table entry: it runs before the barrier.
  bool bad = false;
  if (mine && classes) {
    if (write0 >= 0) bad = locked(a, write0);
    for (int k = lane + kWarp; k < a.w; k += kWarp) {
      const int32_t item = witems[k];
      if (item >= 0) bad |= locked(a, item);
    }
  }
  if (kScatter && kCertify) {
    if (clustered)
      cluster_sync();
    else
      __syncthreads();
  }
  if (!mine) return;

  // phase 2: one warp per transaction, its reads against the updated table
  const int last = a.n_items - 1;
  if (read0.x >= 0) bad |= __ldcg(a.table + min(read0.x, last)) != read0.y;
  for (int k = lane + kWarp; k < a.r; k += kWarp) {
    const int2 read = pairs[k];  // (item, version)
    if (read.x >= 0) bad |= __ldcg(a.table + min(read.x, last)) != read.y;
  }
  const bool any_bad = __any_sync(0xffffffffu, bad);
  if (lane == 0) a.ok[txn] = any_bad ? 0 : 1;
}

__global__ void empty_kernel() {}

}  // namespace drain

// The staging area of one store: `bytes` of pinned host memory mapped into
// the device's address space.  Unified addressing gives the mapped memory
// the same address on both sides; the launcher relies on it, so it is
// checked here.
extern "C" int lease_staging_alloc(long long bytes, int device, void** host) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  *host = nullptr;
  err = cudaHostAlloc(host, static_cast<size_t>(bytes), cudaHostAllocMapped);
  void* dev_ptr = nullptr;
  if (err == cudaSuccess) err = cudaHostGetDevicePointer(&dev_ptr, *host, 0);
  int out = static_cast<int>(err);
  if (out == 0 && dev_ptr != *host) out = drain::kNoUnifiedAddress;
  if (out != 0 && *host != nullptr) {
    cudaFreeHost(*host);
    *host = nullptr;
  }
  cudaSetDevice(prev);
  return out;
}

extern "C" int lease_staging_free(void* host) {
  return static_cast<int>(cudaFreeHost(host));
}

// One drain: reads the header of `area`, launches per drain::plan on
// `stream`, and with `wait` synchronises the stream before it returns
// (without it only for a CUDA-graph capture, which must not wait).
// plan_out[0..1] = (CTAs, kernels), for the wrapper to hold against its
// twin.  Returns 0, a CUDA error, or a negative refusal (nothing launched).
extern "C" int lease_drain_launch(void* area, long long area_bytes,
                                  void* table, int n_items,
                                  const void* item_cc, int wait,
                                  int* plan_out, void* stream) {
  using namespace drain;
  const int32_t* h = static_cast<const int32_t*>(area);
  const int n_dirty = h[0], b = h[1], r = h[2], w = h[3], node = h[4],
            n_classes = h[5];
  if (n_dirty < 0 || b < 0 || r < 0 || w < 0 || n_classes < 0 ||
      n_items < 1)
    return kBadHeader;
  if ((item_cc != nullptr) != (n_classes > 0)) return kClassViewMismatch;
  const Layout l = layout(n_dirty, b, r, w, n_classes);
  if (l.bytes > area_bytes) return kAreaTooSmall;
  for (int i = 0; i < n_dirty; ++i) {
    const int32_t item = h[l.dirty_idx + i];
    if (item < 0 || item >= n_items) return kBadDirtyItem;
  }
  const Plan p = plan(b, n_dirty);
  plan_out[0] = p.ctas;
  plan_out[1] = p.kernels;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);

  Args a;
  a.table = static_cast<int32_t*>(table);
  a.item_cc = static_cast<const int32_t*>(item_cc);
  a.dirty_idx = h + l.dirty_idx;
  a.dirty_ver = h + l.dirty_ver;
  a.owners = h + l.owners;
  a.reads = h + l.reads;
  a.write_items = h + l.write_items;
  a.ok = reinterpret_cast<uint8_t*>(static_cast<int32_t*>(area) + l.ok);
  a.n_items = n_items;
  a.n_dirty = n_dirty;
  a.b = b;
  a.r = r;
  a.w = w;
  a.node = node;
  a.n_classes = n_classes;

  if (p.kernels == 2) {
    const int scatter_ctas =
        std::max(1, (n_dirty + kDirtyPerCta - 1) / kDirtyPerCta);
    drain_kernel<true, false><<<scatter_ctas, kThreads, 0, s>>>(a, 0);
    const int certify_ctas =
        std::max(1, (b + kTxnsPerCta - 1) / kTxnsPerCta);
    drain_kernel<false, true><<<certify_ctas, kThreads, 0, s>>>(a, 0);
  } else if (p.ctas == 1) {
    drain_kernel<true, true><<<1, kThreads, 0, s>>>(a, 0);
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(p.ctas, 1, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.ctas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err =
        cudaLaunchKernelEx(&cfg, drain_kernel<true, true>, a, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess && wait) err = cudaStreamSynchronize(s);
  return static_cast<int>(err);
}

// The design's floor: an empty kernel through the same call and wait.
extern "C" int lease_drain_empty(void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  drain::empty_kernel<<<1, drain::kThreads, 0, s>>>();
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) err = cudaStreamSynchronize(s);
  return static_cast<int>(err);
}

// gather's floor: an empty kernel through the same call (gather does not
// wait).
extern "C" int lease_validate_empty(void* stream) {
  drain::empty_kernel<<<1, drain::kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
