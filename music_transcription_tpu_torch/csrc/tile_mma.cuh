// Shared-memory tiles of 16-channel rows and the warpgroup products on them,
// for the conv kernels: conv_bn_relu.cu (K5) and res_block.cu (K6). A tile
// row holds 16 bf16 channels of one pixel (or of one weight row), 32 bytes,
// its two 16-byte halves swapped in rows 4-7 of every 8: wgmma's 32-byte
// swizzle, under which the 8 rows an ldmatrix phase reads fall on distinct
// banks.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "warpgroup.cuh"

namespace {

constexpr int CK = 16;               // channels per tile row
constexpr int PIX_BYTES = CK * 2;    // 32: one pixel's (or weight row's) 16 channels

// Byte offset of the 16-byte half h of row `row` in a tile of 32-byte rows.
__device__ __forceinline__ uint32_t swizzled_bytes(int row, int h) {
  return (uint32_t)(row * PIX_BYTES + 16 * (h ^ ((row >> 2) & 1)));
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

// wgmma's descriptor of a K-major B tile of 32-byte rows (16 bf16 of K) in
// the 32-byte swizzle: 8-row groups 256 bytes apart. The tile's base is a
// multiple of 256 bytes, so the swizzle's phase is 0.
__device__ __forceinline__ uint64_t sw32_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)1 << 16 | (uint64_t)(256 >> 4) << 32 |
         3ull << 62;
}

// d (64 x 64 fp32) += a (64 x 16 bf16 in registers, each warp's 16 rows in
// the mma.sync m16n8k16 A layout) . b, b a K-major tile in shared memory.
__device__ __forceinline__ void wgmma_rs_kmajor(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : WGMMA_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// Makes the compiler compute both values here, on every thread's path: an
// accumulator read inside a branch of one thread's own would make ptxas
// serialize the products (a warpgroup arrive in a divergent path).
__device__ __forceinline__ void settle(float& a, float& b) {
  asm volatile("" : "+f"(a), "+f"(b));
}

}  // namespace
