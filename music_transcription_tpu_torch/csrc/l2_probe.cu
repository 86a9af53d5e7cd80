// How fast this card's blocks can stream a buffer from L2 into shared memory
// by TMA bulk copies: the weight stream of K5's walk (conv_bn_relu.cu), which
// every block reads from L2 once a step. Not a kernel of the model's path;
// ops/l2_probe.py runs it.
//
// Every block (one an SM) keeps `stages` bulk copies of `chunk` bytes in
// flight through a ring of full mbarriers, cycling over a buffer that stays
// in L2, and takes nothing out: the rate is the copies' alone. With
// `multicast`, blocks run in clusters of 2 and rank 0 issues each copy once
// with .multicast::cluster into both blocks; rank 1 tells rank 0 through an
// empty mbarrier (a remote arrive) when a stage has landed, before rank 0
// reuses it.

#include <cuda_runtime.h>

#include <cstdint>

#include "warpgroup.cuh"

namespace {

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n"
               ::: "memory");
}

__global__ void probe_kernel(const unsigned char* __restrict__ buf, int nchunks, int chunk,
                             int stages, int copies, int multicast) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t full = base + stages * chunk, empty = full + 8 * stages;
  const uint32_t rank = multicast ? cluster_rank() : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (multicast) cluster_sync();
  else __syncthreads();
  if (threadIdx.x == 0) {
    const int first = (multicast ? blockIdx.x / 2 : blockIdx.x) % nchunks;
    for (int n = 0; n < copies + stages; ++n) {
      if (n >= stages) {  // retire copy n - stages
        const int m = n - stages, s = m % stages, parity = (m / stages) & 1;
        mbar_wait(full + 8 * s, parity);
        if (multicast && rank == 1) {
          asm volatile(
              "{\n.reg .b32 r;\nmapa.shared::cluster.u32 r, %0, 0;\n"
              "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [r];\n}\n" ::"r"(empty + 8 * s)
              : "memory");
        } else if (multicast) {
          mbar_wait(empty + 8 * s, parity);
        }
      }
      if (n >= copies) continue;
      const int s = n % stages;
      const uint32_t bar = full + 8 * s, dst = base + s * chunk;
      const unsigned char* src = buf + (size_t)((first + n) % nchunks) * chunk;
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                   "r"(chunk)
                   : "memory");
      if (!multicast) {
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
            "[%3];\n" ::"r"(dst), "l"(src), "r"(chunk), "r"(bar)
            : "memory");
      } else if (rank == 0) {
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
            "[%0], [%1], %2, [%3], %4;\n" ::"r"(dst), "l"(src), "r"(chunk), "r"(bar),
            "h"((unsigned short)3)
            : "memory");
      }
    }
  }
  if (multicast) cluster_sync();
}

}  // namespace

extern "C" {

// Runs the probe once on `blocks` blocks (even with multicast) and returns
// 0 or a cudaError_t code; *ms its time under CUDA events. Each block issues
// `copies` copies of `chunk` bytes (rank 1 of a cluster none of its own).
int l2_probe(const void* buf, long long buf_bytes, int chunk, int stages, int copies,
             int multicast, int blocks, float* ms) {
  if (chunk <= 0 || chunk % 16 || stages <= 0 || buf_bytes < chunk || (multicast && blocks % 2))
    return cudaErrorInvalidValue;
  // shared memory enough for one block an SM
  const int smem = 160 * 1024 > stages * (chunk + 16) ? 160 * 1024 : stages * (chunk + 16);
  cudaError_t e =
      cudaFuncSetAttribute(probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(32);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = multicast ? 2 : 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaEvent_t start, stop;
  cudaEventCreate(&start);
  cudaEventCreate(&stop);
  const int nchunks = (int)(buf_bytes / chunk);
  const unsigned char* b = static_cast<const unsigned char*>(buf);
  e = cudaLaunchKernelEx(&cfg, probe_kernel, b, nchunks, chunk, stages, copies, multicast);  // warm
  if (e == cudaSuccess) {
    cudaEventRecord(start);
    e = cudaLaunchKernelEx(&cfg, probe_kernel, b, nchunks, chunk, stages, copies, multicast);
    cudaEventRecord(stop);
  }
  if (e == cudaSuccess) e = cudaEventSynchronize(stop);
  if (e == cudaSuccess) e = cudaEventElapsedTime(ms, start, stop);
  cudaEventDestroy(start);
  cudaEventDestroy(stop);
  return e == cudaSuccess ? (int)cudaGetLastError() : (int)e;
}

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
