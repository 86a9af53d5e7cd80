// Fused inference ConvBNRelu [+ (2,1) max-pool over frequency] on the H100: K5.
// bf16 in / bf16 out.
//
// Replaces music_transcription_tpu/ops/conv_pallas.py:
//   K5  fused_conv_bn_relu -> _conv_bn_kernel
//
//   x    (B, C_in, F, T) bf16, NCHW (T contiguous)
//   w    (KH, KW, C_out, C_in) bf16 (the wrapper's permute of torch's weight)
//   bias, scale, offset  (C_out,) fp32: the conv bias and the BatchNorm
//        running-statistics affine s = g / sqrt(var + eps), o = b - mean * s
//   out  (B, C_out, F, T) bf16, or (B, C_out, F/2, T) with pool
//
//   acc[n, f, t] = sum_{c, df, dt} x[c, f + df - KH/2, t + dt - KW/2] * w[df, dt, n, c]
//                  (SAME: zeros outside the tensor; exact bf16 products, fp32 sums)
//   y[n, f, t]   = bf16( relu( float(bf16(acc + bias[n])) * scale[n] + offset[n] ) )
//   pool: out[n, f, t] = max(y[n, 2f, t], y[n, 2f+1, t])
// the Pallas kernel's rounding points (_bn_relu_bf16). Rounding is monotone,
// so the max is taken before the last bf16 rounding.
//
// What bounds it on the H100. The 89M model's two ConvBNRelu stages at the
// 30 s route's shape (B=4, T=938): conv1 (3x3, C 1->32, F=320, pool) does
// 0.69 GFLOP and must move 40.8 MB, almost all of it the output: bytes,
// 0.0122 ms at 3.35 TB/s. freq_aware_conv (7x3, C 128->256, F=80, pool) does
// 413 GFLOP on 155 MB: operations, 0.418 ms at the 989 TFLOP/s bf16
// tensor-core rate. So two kernels:
//
// conv_bn_relu_tc_kernel (C_in >= 16): an implicit-GEMM convolution on the
// tensor cores (mma.sync m16n8k16 bf16, fp32 accumulators in registers,
// operands from shared memory by ldmatrix). M is a tile of FR = 2 output rows
// (one pool pair, so a tile never splits one) x TM = 64 columns; N a tile of
// NT output channels (32, 64 or 128); K runs over chunks of CK = 16 input
// channels and, inside a chunk, over the KH x KW taps. Each chunk stages in
// shared memory (the weights by cp.async, in flight while the threads gather
// the input) the input rows
// f0 - KH/2 .. f0 + FR - 1 + KH/2 and columns t0 - KW/2 .. t0 + TM - 1 + KW/2,
// channel-innermost ([row][col][16 channels], 32 bytes a pixel) with zeros
// outside the tensor, and the chunk's weights, also channel-innermost
// ([tap][NT][16 channels]). So both operands are K-contiguous rows of 32
// bytes: the A operand of tap (df, dt) is the 16 staged pixels from a shifted
// row, no im2col copy, and one ldmatrix.x4 reads a 16 x 16 operand of either.
// The two 16-byte halves of a row are swapped in rows 4-7 of every 8, so the
// 8 rows an ldmatrix phase reads fall on distinct banks (unswizzled, rows r
// and r + 4 share them). The epilogue writes the accumulators to shared memory
// (over the staging buffers) and each thread takes one (channel, column):
// + bias, bf16, affine, ReLU, the max of the pair, bf16, stored along T
// (coalesced).
//
// conv_bn_relu_cc_kernel (C_in < 16, conv1's C_in = 1): K = C_in*KH*KW (9 at
// conv1) gives the tensor cores nothing to do, so fp32 FMAs on the CUDA cores.
// A block takes 4 output rows x 128 columns, one column and one row pair per
// thread; the input window (fp32) and all weights (fp32, [c][tap][C_out
// padded to 16]) sit in shared memory. A thread holds the accumulators of 16
// channels for its two rows, reads two inputs and four float4 weight vectors
// per tap (the weights are one address for the whole block: a broadcast),
// and writes its 16 outputs along T. The same epilogue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tile_mma.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may have

// tensor-core kernel tile
constexpr int FR = 2;             // output rows per tile (one pool pair)
constexpr int TM = 64;            // output columns per tile
constexpr int kMFrags = FR * TM / 16;
constexpr int LDC = FR * TM + 4;  // row stride of the fp32 [NT][FR*TM] epilogue tile

// CUDA-core kernel tile
constexpr int FRC = 4;            // output rows per block: two row pairs
constexpr int TC = 128;           // output columns per block
constexpr int NC = 16;            // output channels a thread accumulates at once

// + conv bias in fp32, one bf16 rounding, the BN affine in fp32, ReLU.
__device__ __forceinline__ float bn_relu(float acc, float bias, float s, float o) {
  const float h = __bfloat162float(__float2bfloat16(acc + bias));
  return fmaxf(h * s + o, 0.0f);
}

// ---------------------------------------------------------------------------
// C_in >= 16: implicit GEMM on the tensor cores
// ---------------------------------------------------------------------------

size_t smem_bytes_tc(int NT, int KH, int KW) {
  const size_t staging =
      sizeof(bf16) * ((size_t)(FR + KH - 1) * (TM + KW - 1) + (size_t)KH * KW * NT) * CK;
  const size_t epilogue = sizeof(float) * (size_t)NT * LDC;
  return staging > epilogue ? staging : epilogue;
}

template <int NT>
__global__ void __launch_bounds__(kThreads, 2)
conv_bn_relu_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                       const float* __restrict__ bias, const float* __restrict__ scale,
                       const float* __restrict__ offset, bf16* __restrict__ out, int C_in,
                       int C_out, int F, int T, int KH, int KW, int pool) {
  // warps: WARPS_M x WARPS_N; each owns FM blocks of 16 pixels x FN blocks of
  // 16 channels (2 FN mma tiles of 8 channels)
  constexpr int FN = 2, WARPS_N = NT / 16 / FN, WARPS_M = kWarps / WARPS_N;
  constexpr int FM = kMFrags / WARPS_M;
  static_assert(WARPS_M * WARPS_N == kWarps && FM * WARPS_M == kMFrags, "warp layout");

  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int R = FR + KH - 1, W = TM + KW - 1, taps = KH * KW;
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [R][W][CK], swizzled halves
  bf16* ws = xs + R * W * CK;                     // [taps][NT][CK], swizzled halves
  float* cs = reinterpret_cast<float*>(smem_raw); // [NT][LDC], after the K loop

  const int n_tiles = (C_out + NT - 1) / NT;
  const int b = blockIdx.z / n_tiles, n0 = (blockIdx.z % n_tiles) * NT;
  const int t0 = blockIdx.x * TM;
  const int f0 = blockIdx.y * FR;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const bf16 zero = __float2bfloat16(0.0f);
  // the row and half each lane addresses: A (pixels 0-15; halves 0 then 1) and
  // B (channels 0-7 halves 0, 1, then channels 8-15 halves 0, 1)
  const int a_row = lane % 16, a_half = lane / 16;
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_half = (lane >> 3) & 1;

  float acc[FM][2 * FN][4];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < 2 * FN; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;

  for (int c0 = 0; c0 < C_in; c0 += CK) {
    __syncthreads();  // the previous chunk's tiles are consumed
    // the chunk's weights, zeros past C_in and C_out: per (tap, n) row of
    // 16 channels, two 16-byte halves
    if (C_in % 8 == 0) {
      for (int e = tid; e < taps * NT * 2; e += kThreads) {
        const int row = e / 2, half = e % 2, tap = row / NT, n = row % NT;
        const int c = c0 + 8 * half;
        const bool valid = c < C_in && n0 + n < C_out;
        copy16_async(ws + swizzled(row, half),
                     valid ? w + ((size_t)tap * C_out + n0 + n) * C_in + c : w, valid);
      }
    } else {
      for (int e = tid; e < taps * NT * CK; e += kThreads) {
        const int row = e / CK, k = e % CK, c = c0 + k, tap = row / NT, n = row % NT;
        ws[swizzled(row, k / 8) + k % 8] =
            c < C_in && n0 + n < C_out ? w[((size_t)tap * C_out + n0 + n) * C_in + c] : zero;
      }
    }
    // input window, channel-innermost, zeros outside the tensor
    for (int e = tid; e < R * W; e += kThreads) {
      const int r = e / W, col = e % W;
      const int gr = f0 - KH / 2 + r, gt = t0 - KW / 2 + col;
      const bool inside = gr >= 0 && gr < F && gt >= 0 && gt < T;
      uint32_t pk[CK / 2];  // channel pairs, the lower channel in the low half
#pragma unroll
      for (int p = 0; p < CK / 2; ++p) {
        const int c = c0 + 2 * p;
        uint32_t lo = 0, hi = 0;
        if (inside && c < C_in) {
          const bf16* src = x + (((size_t)b * C_in + c) * F + gr) * T + gt;
          lo = __bfloat16_as_ushort(src[0]);
          if (c + 1 < C_in) hi = __bfloat16_as_ushort(src[(size_t)F * T]);
        }
        pk[p] = lo | hi << 16;
      }
      *reinterpret_cast<uint4*>(xs + swizzled(e, 0)) = make_uint4(pk[0], pk[1], pk[2], pk[3]);
      *reinterpret_cast<uint4*>(xs + swizzled(e, 1)) = make_uint4(pk[4], pk[5], pk[6], pk[7]);
    }
    wait_async_copies();
    __syncthreads();

    for (int df = 0; df < KH; ++df) {
      for (int dt = 0; dt < KW; ++dt) {
        const int tap = df * KW + dt;
        unsigned b[FN][4];
#pragma unroll
        for (int j = 0; j < FN; ++j) {
          const int row = tap * NT + (wn * FN + j) * 16 + b_row;
          ldmatrix_x4(b[j], shared_address(ws + swizzled(row, b_half)));
        }
#pragma unroll
        for (int i = 0; i < FM; ++i) {
          const int mi = wm * FM + i, r = mi / (TM / 16), cb = mi % (TM / 16);
          const int pixel = (r + df) * W + cb * 16 + dt + a_row;
          unsigned a[4];
          ldmatrix_x4(a, shared_address(xs + swizzled(pixel, a_half)));
#pragma unroll
          for (int j = 0; j < FN; ++j) {
            mma_bf16(acc[i][2 * j], a, b[j][0], b[j][1]);
            mma_bf16(acc[i][2 * j + 1], a, b[j][2], b[j][3]);
          }
        }
      }
    }
  }

  __syncthreads();  // the staging buffers are free for the epilogue tile
  // accumulator q of an m16n8 tile: pixel lane / 4 (+8 for q >= 2), channel
  // 2 (lane % 4) (+1 for odd q)
  const int g = lane / 4, c2 = 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < FM; ++i) {
    const int mi = wm * FM + i, m0 = (mi / (TM / 16)) * TM + (mi % (TM / 16)) * 16 + g;
#pragma unroll
    for (int j = 0; j < 2 * FN; ++j) {
      float* col = cs + (wn * FN * 16 + j * 8 + c2) * LDC + m0;
      col[0] = acc[i][j][0];
      col[LDC] = acc[i][j][1];
      col[8] = acc[i][j][2];
      col[LDC + 8] = acc[i][j][3];
    }
  }
  __syncthreads();

  for (int e = tid; e < NT * TM; e += kThreads) {
    const int n = e / TM, t = e % TM, gn = n0 + n, gt = t0 + t;
    if (gn >= C_out || gt >= T) continue;
    const float bi = bias[gn], s = scale[gn], o = offset[gn];
    const float y0 = bn_relu(cs[n * LDC + t], bi, s, o);
    const float y1 = bn_relu(cs[n * LDC + TM + t], bi, s, o);
    if (pool) {
      out[(((size_t)b * C_out + gn) * (F / 2) + blockIdx.y) * T + gt] = __float2bfloat16(fmaxf(y0, y1));
    } else {
      bf16* o_at = out + (((size_t)b * C_out + gn) * F + f0) * T + gt;
      o_at[0] = __float2bfloat16(y0);
      o_at[T] = __float2bfloat16(y1);
    }
  }
}

// ---------------------------------------------------------------------------
// C_in < 16: CUDA cores
// ---------------------------------------------------------------------------

size_t smem_bytes_cc(int C_in, int C_out, int KH, int KW) {
  const int cp = (C_out + NC - 1) / NC * NC;
  return sizeof(float) * ((size_t)C_in * KH * KW * cp + (size_t)C_in * (FRC + KH - 1) * (TC + KW - 1));
}

__global__ void __launch_bounds__(kThreads)
conv_bn_relu_cc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                       const float* __restrict__ bias, const float* __restrict__ scale,
                       const float* __restrict__ offset, bf16* __restrict__ out, int C_in,
                       int C_out, int F, int T, int KH, int KW, int pool) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int R = FRC + KH - 1, W = TC + KW - 1, taps = KH * KW;
  const int cp = (C_out + NC - 1) / NC * NC;
  float* wsm = reinterpret_cast<float*>(smem_raw);  // [C_in][taps][cp]
  float* xs = wsm + C_in * taps * cp;                // [C_in][R][W]

  const int t0 = blockIdx.x * TC;
  const int f0 = blockIdx.y * FRC;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;

  for (int e = tid; e < C_in * taps * cp; e += kThreads) {
    const int c = e / (taps * cp), tap = (e / cp) % taps, n = e % cp;
    wsm[e] = n < C_out ? __bfloat162float(w[((size_t)tap * C_out + n) * C_in + c]) : 0.0f;
  }
  for (int e = tid; e < C_in * R * W; e += kThreads) {
    const int c = e / (R * W), r = (e / W) % R, col = e % W;
    const int gr = f0 - KH / 2 + r, gt = t0 - KW / 2 + col;
    xs[e] = gr >= 0 && gr < F && gt >= 0 && gt < T
                ? __bfloat162float(x[(((size_t)b * C_in + c) * F + gr) * T + gt]) : 0.0f;
  }
  __syncthreads();

  const int t = tid % TC, lr = 2 * (tid / TC);  // column, first row of the pair
  const int gt = t0 + t, fa = f0 + lr;           // rows fa, fa + 1
  if (gt >= T || (!pool && fa >= F)) return;     // no barrier follows

  for (int nb = 0; nb < C_out; nb += NC) {
    float a0[NC], a1[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) a0[j] = a1[j] = 0.0f;
    for (int c = 0; c < C_in; ++c) {
      for (int df = 0; df < KH; ++df) {
        const float* xr = xs + (c * R + lr + df) * W + t;
        for (int dt = 0; dt < KW; ++dt) {
          const float v0 = xr[dt], v1 = xr[W + dt];
          const float4* wv = reinterpret_cast<const float4*>(wsm + (c * taps + df * KW + dt) * cp + nb);
#pragma unroll
          for (int q = 0; q < NC / 4; ++q) {
            const float4 w4 = wv[q];
            a0[4 * q] = fmaf(v0, w4.x, a0[4 * q]);
            a0[4 * q + 1] = fmaf(v0, w4.y, a0[4 * q + 1]);
            a0[4 * q + 2] = fmaf(v0, w4.z, a0[4 * q + 2]);
            a0[4 * q + 3] = fmaf(v0, w4.w, a0[4 * q + 3]);
            a1[4 * q] = fmaf(v1, w4.x, a1[4 * q]);
            a1[4 * q + 1] = fmaf(v1, w4.y, a1[4 * q + 1]);
            a1[4 * q + 2] = fmaf(v1, w4.z, a1[4 * q + 2]);
            a1[4 * q + 3] = fmaf(v1, w4.w, a1[4 * q + 3]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int n = nb + j;
      if (n >= C_out) break;
      const float y0 = bn_relu(a0[j], bias[n], scale[n], offset[n]);
      const float y1 = bn_relu(a1[j], bias[n], scale[n], offset[n]);
      if (pool) {
        out[(((size_t)b * C_out + n) * (F / 2) + fa / 2) * T + gt] = __float2bfloat16(fmaxf(y0, y1));
      } else {
        bf16* o_at = out + (((size_t)b * C_out + n) * F + fa) * T + gt;
        o_at[0] = __float2bfloat16(y0);
        o_at[T] = __float2bfloat16(y1);
      }
    }
  }
}

// Set the kernel's dynamic shared memory and launch it on `stream`.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, size_t smem, void* stream, Args... args) {
  if (smem > (size_t)kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return cudaGetLastError();
}

int forward(const bf16* x, const bf16* w, const float* bias, const float* scale,
            const float* offset, bf16* out, int B, int C_in, int C_out, int F, int T, int KH,
            int KW, int pool, void* stream) {
  const size_t cc_smem = smem_bytes_cc(C_in, C_out, KH, KW);
  if (C_in < 16 && cc_smem <= (size_t)kSmemLimit)
    return launch(conv_bn_relu_cc_kernel,
                  dim3((T + TC - 1) / TC, (F + FRC - 1) / FRC, B), cc_smem, stream, x, w, bias,
                  scale, offset, out, C_in, C_out, F, T, KH, KW, pool);
  const int NT = C_out > 64 ? 128 : C_out > 32 ? 64 : 32;
  const dim3 grid((T + TM - 1) / TM, F / FR, B * ((C_out + NT - 1) / NT));
  if (grid.z > 65535) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes_tc(NT, KH, KW);
  if (NT == 128)
    return launch(conv_bn_relu_tc_kernel<128>, grid, smem, stream, x, w, bias, scale,
                  offset, out, C_in, C_out, F, T, KH, KW, pool);
  if (NT == 64)
    return launch(conv_bn_relu_tc_kernel<64>, grid, smem, stream, x, w, bias, scale,
                  offset, out, C_in, C_out, F, T, KH, KW, pool);
  return launch(conv_bn_relu_tc_kernel<32>, grid, smem, stream, x, w, bias, scale,
                offset, out, C_in, C_out, F, T, KH, KW, pool);
}

}  // namespace

extern "C" {

// K5 on `stream`. Returns 0 or a cudaError_t code.
int conv_bn_relu_forward(const void* x, const void* w, const void* bias, const void* scale,
                         const void* offset, void* out, int B, int C_in, int C_out, int F, int T,
                         int KH, int KW, int pool, void* stream) {
  if (B <= 0 || C_in <= 0 || C_out <= 0 || F <= 0 || T <= 0 || KH <= 0 || KW <= 0 || F % 2 ||
      (pool && F % 4) || F > 65535 * FR || B > 65535)
    return cudaErrorInvalidValue;
  return forward(static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                 static_cast<const float*>(bias), static_cast<const float*>(scale),
                 static_cast<const float*>(offset), static_cast<bf16*>(out), B, C_in, C_out, F,
                 T, KH, KW, pool, stream);
}

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
