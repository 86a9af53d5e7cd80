// Shared-memory tiles of 16-channel rows and the tensor-core fragment
// operations on them, for the conv kernels: conv_bn_relu.cu (K5) and
// res_block.cu (K6). A tile row holds 16 bf16 channels of one pixel (or of
// one weight row), 32 bytes, its two 16-byte halves swapped in rows 4-7 of
// every 8, so that the 8 rows an ldmatrix phase reads fall on distinct banks.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int CK = 16;  // channels per tile row

// 16 bytes from global to shared memory without a register round trip
// (cp.async); zeros instead when !valid (src-size 0 reads nothing).
__device__ __forceinline__ void copy16_async(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void wait_async_copies() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Offset (bf16) of the 16-byte half h of row `row` in a tile of 32-byte rows
// (16 channels), the halves swapped in rows 4-7 of every 8.
__device__ __forceinline__ int swizzled(int row, int h) {
  return row * CK + 8 * (h ^ ((row >> 2) & 1));
}

__device__ __forceinline__ unsigned shared_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices, one 16-byte row address per lane (lanes 8m..8m+7
// address matrix m), into r[m].
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace
