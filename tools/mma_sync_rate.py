"""The card's rate for the split-TF32 kernels' building block, mma.sync.

Builds a small CUDA program with ``nvcc`` (into ``build/mma_sync_rate``)
and runs it: every SM's warps issue independent ``mma.sync`` products
back to back, m16n8k8 on TF32 operands and m16n8k16 on bf16, at a few
chain counts a warp and warps a block; then one warp a chain of dependent
TF32 products, for the product's latency.  Prints the card's
``nvidia-smi`` name and power limit, then one line per case in TFLOP/s
(the flops of the products issued over CUDA-event time)::

    python3 tools/mma_sync_rate.py

The flash ``simt`` kernels take every fp32 product as three TF32
``mma.sync`` products (``src/repro_torch/kernels/csrc/flash_mma.cuh``),
so this rate, not the card's 495 TFLOP/s of TF32 on ``wgmma``, is the
ceiling they work under.
"""
from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

SOURCE = r"""
#include <cstdio>
#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int CHAINS, bool BF16>
__global__ void products(float* out, int iters) {
  float acc[CHAINS][4];
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = 0x3f800000u + threadIdx.x + i;
  b[0] = 0x3f800000u + threadIdx.x;
  b[1] = 0x3f000000u + threadIdx.x;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c)
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) {
      if (BF16) mma_bf16(acc[c], a, b);
      else mma_tf32(acc[c], a, b);
    }
  }
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c)
    s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int CHAINS, bool BF16>
void rate(int sms, int blocks_per_sm, int warps, int iters) {
  float* out;
  const int blocks = sms * blocks_per_sm;
  cudaMalloc(&out, (size_t)blocks * warps * 32 * sizeof(float));
  products<CHAINS, BF16><<<blocks, warps * 32>>>(out, 16);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  products<CHAINS, BF16><<<blocks, warps * 32>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  const double flops = 2.0 * (BF16 ? 16 * 8 * 16 : 16 * 8 * 8) * CHAINS *
                       (double)iters * blocks * warps;
  printf("%s chains=%d warps=%d blocks/SM=%d: %.1f TFLOP/s\n",
         BF16 ? "bf16 m16n8k16" : "tf32 m16n8k8", CHAINS, warps,
         blocks_per_sm, flops / ms / 1e9);
  cudaFree(out);
}

int main() {
  int sms;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  rate<1, false>(sms, 8, 4, 4096);
  rate<4, false>(sms, 8, 4, 4096);
  rate<8, false>(sms, 8, 8, 4096);
  rate<16, false>(sms, 8, 8, 4096);
  rate<8, true>(sms, 8, 8, 4096);
  float* out;
  cudaMalloc(&out, (size_t)sms * 32 * sizeof(float));
  products<1, false><<<sms, 32>>>(out, 16);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  const int iters = 65536;
  cudaEventRecord(e0);
  products<1, false><<<sms, 32>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  int khz;
  cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0);
  printf("tf32 m16n8k8 dependent chain: %.2f ns a product, %.1f cycles at "
         "the %d MHz clock rate\n", ms * 1e6 / iters,
         ms * 1e6 / iters * khz / 1e6, khz / 1000);
  return 0;
}
"""


def main() -> int:
    out = Path(__file__).resolve().parents[1] / "build" / "mma_sync_rate"
    out.mkdir(parents=True, exist_ok=True)
    (out / "rate.cu").write_text(SOURCE)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-o", str(out / "rate"), str(out / "rate.cu")],
                   check=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip()
    print(smi, flush=True)
    return subprocess.run([str(out / "rate")], check=False).returncode


if __name__ == "__main__":
    sys.exit(main())
