// Fused inference ResidualBlock [+ (2,1) max-pool over frequency] on the H100: K6.
// bf16 in / bf16 out, one launch per block call.
//
// Replaces music_transcription_tpu/ops/conv_pallas.py:
//   K6  fused_res_block -> _res_block_kernel
//
//   x    (B, C_in, F, T) bf16, NCHW (T contiguous)
//   w1   (3, 3, C_mid, C_in), w2 (3, 3, C_out, C_mid), ws (1, 1, C_out, C_in) bf16
//        (the wrapper's permutes of torch's weights); ws null: the identity skip
//   b*, s*, o*  fp32 per channel: each conv's bias and its BatchNorm's
//        running-statistics affine s = g / sqrt(var + eps), o = b - mean * s
//   out  (B, C_out, F, T) bf16, or (B, C_out, F/2, T) with pool
//
//   h1  = bf16(relu(float(bf16(conv3x3(x) + b1)) * s1 + o1)), 0 outside the tensor
//   h2  = float(bf16(conv3x3(h1) + b2)) * s2 + o2                (fp32, no ReLU)
//   sk  = float(bf16(conv1x1(x) + bs)) * ss + os, or float(x)   (C_in == C_out)
//   y   = bf16(relu(h2 + sk));  pool: out[f] = max(y[2f], y[2f+1])
// SAME convolutions (zeros outside the tensor), exact bf16 products summed in
// fp32: the Pallas kernel's rounding points. Every affine is a product and a
// sum each rounded once (__fmul_rn, __fadd_rn, never a fused multiply-add),
// as PyTorch's plain version computes it, so that the two differ only where
// sums taken in another order straddle a bf16 rounding boundary.
//
// What bounds it on the H100. The 89M model's blocks at the 30 s route's shape
// (B=4, T=938): res_block1 (C 32->64, F=160, pool) does 68.85 GFLOP on 77.0 MB,
// res_block2 (C 64->128, F=80) 137.70 GFLOP on 115.7 MB: operations, 0.070
// and 0.139 ms at the 989 TFLOP/s bf16 tensor-core rate. h1 never goes to
// device memory.
//
// Design. A block takes an output tile of FR = 2 rows (one pool pair) x
// TM = 62 columns, all output channels, and holds in shared memory:
//   * the x window, rows f0-2 .. f0+3 and columns t0-2 .. t0+63 (6 x 66
//     pixels), all C_in channels, zeros outside the tensor;
//   * the h1 tile, rows f0-1 .. f0+2 and columns t0-1 .. t0+62 (4 x 64
//     pixels, stored with a row stride of 66 whose last two columns are
//     zero), all C_mid channels, since conv2 contracts over all of them;
//   * one chunk of weights: 9 taps x 64 output channels x 16 input channels.
// Both pixel tiles are channel-innermost in chunks of 16 channels ([chunk]
// [pixel][16], 32 bytes a pixel, the two 16-byte halves swapped in rows 4-7
// of every 8 so that an ldmatrix phase falls on distinct banks: tile_mma.cuh,
// shared with K5). So every product is an implicit GEMM on the tensor cores
// (ldmatrix + mma.sync m16n8k16 bf16, fp32 accumulators in registers) whose A
// operand is read in place: the lane's pixel address moved by the tap.
//   1. conv1 over the 4 x 64 h1 pixels (16 m16 fragments, 4 a warp), 64
//      channels of C_mid at a time, over chunks of 16 input channels; its
//      epilogue writes bf16 h1 into shared memory, zero at every row and
//      column outside the tensor (a value computed there from the zero-padded
//      x is not zero: o1, then ReLU).
//   2. conv2 over the 2 x 64 output pixels (the last 2 columns of each row
//      are computed and dropped), 64 output channels at a time, over chunks
//      of 16 h1 channels; the 1x1 skip reads the centre of the staged x
//      window into accumulators of its own (or the identity reads x there);
//      the epilogue (both affines, the sum, ReLU, bf16) writes the tile to
//      shared memory over the weight chunk, and the threads store it along T
//      (coalesced), taking the max of each row pair with pool.
// The h1 halo rows are computed by both neighbouring tiles: conv1 runs over
// 4 rows for 2 output rows, some 33% more operations than the block needs
// (res_block2: conv1 over 256 pixels and conv2 over 128 per tile, about equal),
// plus 2 dropped columns in 64. The weights are staged by cp.async and
// waited for: no pipelining.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tile_mma.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr int kThreads = 256;
constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may have

constexpr int FR = 2;           // output rows per tile (one pool pair)
constexpr int TM = 62;          // output columns per tile
constexpr int W = TM + 4;       // 66: the x window's width, the h1 tile's row stride
constexpr int XPIX = (FR + 4) * W;  // x window pixels
constexpr int HC = TM + 2;      // 64 h1 columns computed
constexpr int HPIX = (FR + 2) * W;  // h1 tile pixels
constexpr int OC = 64;          // output columns computed per row
constexpr int NT = 64;          // output channels per N chunk
constexpr int OBS = FR * OC + 8;  // row stride (bf16) of the [NT][FR x OC] output tile
constexpr int WCHUNK = 9 * NT * CK;  // bf16 of one weight chunk
static_assert(NT * OBS <= WCHUNK, "the output tile fits in the weight chunk");

size_t smem_bytes(int C_in, int C_mid) {
  return sizeof(bf16) * ((size_t)XPIX * C_in + (size_t)HPIX * C_mid + WCHUNK);
}

// Offset (bf16) of channel c of pixel `px` in a [chunk][pixels][16] tile.
__device__ __forceinline__ int channel_at(int c, int px, int pixels) {
  return (c / CK) * pixels * CK + swizzled(px, (c % CK) / 8) + c % 8;
}

// + conv bias in fp32, one bf16 rounding, the BN affine in fp32 (rounded
// after the product and after the sum).
__device__ __forceinline__ float bn_affine(float acc, float bias, float s, float o) {
  const float h = __bfloat162float(__float2bfloat16(__fadd_rn(acc, bias)));
  return __fadd_rn(__fmul_rn(h, s), o);
}

// Stage the weight chunk of output channels n0 .. n0+NT-1 and input channels
// k0 .. k0+15 of w (taps, C_n, C_k) as [tap][NT][16] (swizzled halves),
// zeros past C_n, and wait for it.
__device__ __forceinline__ void stage_weights(bf16* wsm, const bf16* __restrict__ w, int taps,
                                              int C_n, int C_k, int n0, int k0) {
  for (int e = threadIdx.x; e < taps * NT * 2; e += kThreads) {
    const int row = e / 2, half = e % 2, tap = row / NT, n = row % NT;
    const bool valid = n0 + n < C_n;
    copy16_async(wsm + swizzled(row, half),
                 valid ? w + ((size_t)tap * C_n + n0 + n) * C_k + k0 + 8 * half : w, valid);
  }
  wait_async_copies();
}

// acc[i] += the KH x KW taps of the staged weight chunk (the warp's 32 output
// channels: 4 n8 tiles) times the A operand of fragment i: 16 pixels of `src`
// (a [pixels][16] chunk tile), the lane's at a_pix[i], moved by df * W + dt.
template <int FM, int KH, int KW>
__device__ __forceinline__ void mma_taps(float (&acc)[FM][4][4], const bf16* src,
                                         const bf16* wsm, const int (&a_pix)[FM], int wn,
                                         int lane) {
  const int a_half = lane / 16;
  // B: channels 0-7 halves 0, 1, then channels 8-15 halves 0, 1
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_half = (lane >> 3) & 1;
#pragma unroll
  for (int df = 0; df < KH; ++df) {
#pragma unroll
    for (int dt = 0; dt < KW; ++dt) {
      const int tap = df * KW + dt;
      unsigned b[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        ldmatrix_x4(b[j], shared_address(wsm + swizzled(tap * NT + (wn * 2 + j) * 16 + b_row,
                                                        b_half)));
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        unsigned a[4];
        ldmatrix_x4(a, shared_address(src + swizzled(a_pix[i] + df * W + dt, a_half)));
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mma_bf16(acc[i][2 * j], a, b[j][0], b[j][1]);
          mma_bf16(acc[i][2 * j + 1], a, b[j][2], b[j][3]);
        }
      }
    }
  }
}

template <int FM>
__device__ __forceinline__ void zero(float (&acc)[FM][4][4]) {
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;
}

__global__ void __launch_bounds__(kThreads, 2)
res_block_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                 const float* __restrict__ b1, const float* __restrict__ s1,
                 const float* __restrict__ o1, const bf16* __restrict__ w2,
                 const float* __restrict__ b2, const float* __restrict__ s2,
                 const float* __restrict__ o2, const bf16* __restrict__ ws,
                 const float* __restrict__ bs, const float* __restrict__ ss,
                 const float* __restrict__ os, bf16* __restrict__ out, int C_in, int C_mid,
                 int C_out, int F, int T, int pool) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [C_in / 16][XPIX][16]
  bf16* hs = xs + XPIX * C_in;                    // [C_mid / 16][HPIX][16]
  bf16* wsm = hs + HPIX * C_mid;                  // [taps][NT][16], or the output tile

  const int t0 = blockIdx.x * TM, f0 = blockIdx.y * FR, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;  // 4 x 2 warps; a warp's 32 of NT channels
  const int a_row = lane % 16;
  // accumulator q of an m16n8 tile: pixel lane / 4 (+8 for q >= 2), channel
  // 2 (lane % 4) (+1 for odd q)
  const int g = lane / 4, c2 = 2 * (lane % 4);

  // the x window, channel-innermost, zeros outside the tensor
  for (int e = tid; e < (C_in / CK) * XPIX; e += kThreads) {
    const int kc = e / XPIX, px = e % XPIX;
    const int gr = f0 - 2 + px / W, gt = t0 - 2 + px % W;
    uint32_t pk[CK / 2] = {};  // channel pairs, the lower channel in the low half
    if (gr >= 0 && gr < F && gt >= 0 && gt < T) {
      const bf16* src = x + (((size_t)b * C_in + kc * CK) * F + gr) * T + gt;
#pragma unroll
      for (int p = 0; p < CK / 2; ++p)
        pk[p] = __bfloat16_as_ushort(src[(size_t)(2 * p) * F * T]) |
                (uint32_t)__bfloat16_as_ushort(src[(size_t)(2 * p + 1) * F * T]) << 16;
    }
    bf16* dst = xs + kc * XPIX * CK;
    *reinterpret_cast<uint4*>(dst + swizzled(px, 0)) = make_uint4(pk[0], pk[1], pk[2], pk[3]);
    *reinterpret_cast<uint4*>(dst + swizzled(px, 1)) = make_uint4(pk[4], pk[5], pk[6], pk[7]);
  }
  // the h1 tile's last two columns of each row (read only for dropped outputs)
  for (int e = tid; e < (C_mid / CK) * (FR + 2) * (W - HC) * 2; e += kThreads) {
    const int half = e % 2, q = e / 2, per_chunk = (FR + 2) * (W - HC);
    const int kc = q / per_chunk, r = (q % per_chunk) / (W - HC), col = HC + q % (W - HC);
    *reinterpret_cast<uint4*>(hs + kc * HPIX * CK + swizzled(r * W + col, half)) =
        make_uint4(0, 0, 0, 0);
  }

  // 1. conv1 -> h1: warp wm takes h1 row wm, its 4 fragments of 16 columns
  {
    int a_pix[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a_pix[i] = wm * W + i * 16 + a_row;
    const int gr = f0 - 1 + wm;
    const bool row_inside = gr >= 0 && gr < F;
    for (int n0 = 0; n0 < C_mid; n0 += NT) {
      float acc[4][4][4];
      zero(acc);
      for (int k0 = 0; k0 < C_in; k0 += CK) {
        __syncthreads();  // the previous chunk is consumed (first: the tiles are written)
        stage_weights(wsm, w1, 9, C_mid, C_in, n0, k0);
        __syncthreads();
        mma_taps<4, 3, 3>(acc, xs + (k0 / CK) * XPIX * CK, wsm, a_pix, wn, lane);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int n = n0 + wn * 32 + j * 8 + c2, col = i * 16 + g + 8 * h;
            if (n >= C_mid) continue;
            const int gt = t0 - 1 + col;
            const bool inside = row_inside && gt >= 0 && gt < T;
            float v0 = 0.0f, v1 = 0.0f;
            if (inside) {
              v0 = fmaxf(bn_affine(acc[i][j][2 * h], b1[n], s1[n], o1[n]), 0.0f);
              v1 = fmaxf(bn_affine(acc[i][j][2 * h + 1], b1[n + 1], s1[n + 1], o1[n + 1]), 0.0f);
            }
            *reinterpret_cast<__nv_bfloat162*>(hs + channel_at(n, wm * W + col, HPIX)) =
                __floats2bfloat162_rn(v0, v1);
          }
    }
  }

  // 2. conv2 + the skip -> out: warp wm takes output fragments 2 wm, 2 wm + 1
  // (row mi / 4, columns 16 (mi % 4) ..)
  int a_pix[2], s_pix[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int mi = wm * 2 + i, r = mi / 4, col = (mi % 4) * 16 + a_row;
    a_pix[i] = r * W + col;            // h1 pixel (r + df, col + dt) at tap (df, dt)
    s_pix[i] = (r + 2) * W + col + 2;  // the x pixel of output (r, col)
  }
  for (int n0 = 0; n0 < C_out; n0 += NT) {
    float acc[2][4][4], accs[2][4][4];
    zero(acc);
    zero(accs);
    for (int k0 = 0; k0 < C_mid; k0 += CK) {
      __syncthreads();
      stage_weights(wsm, w2, 9, C_out, C_mid, n0, k0);
      __syncthreads();
      mma_taps<2, 3, 3>(acc, hs + (k0 / CK) * HPIX * CK, wsm, a_pix, wn, lane);
    }
    if (ws != nullptr) {
      for (int k0 = 0; k0 < C_in; k0 += CK) {
        __syncthreads();
        stage_weights(wsm, ws, 1, C_out, C_in, n0, k0);
        __syncthreads();
        mma_taps<2, 1, 1>(accs, xs + (k0 / CK) * XPIX * CK, wsm, s_pix, wn, lane);
      }
    }
    __syncthreads();  // the weight chunk is consumed: it takes the output tile
    bf16* tile = wsm;  // [NT][OBS]: output row r at columns r * OC ..
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int mi = wm * 2 + i, r = mi / 4, col = (mi % 4) * 16 + g + 8 * (q / 2);
          const int nl = wn * 32 + j * 8 + c2 + q % 2, n = n0 + nl;
          if (n >= C_out) continue;
          const float h2 = bn_affine(acc[i][j][q], b2[n], s2[n], o2[n]);
          const float sk =
              ws != nullptr ? bn_affine(accs[i][j][q], bs[n], ss[n], os[n])
                            : __bfloat162float(xs[channel_at(n, (r + 2) * W + col + 2, XPIX)]);
          tile[nl * OBS + r * OC + col] = __float2bfloat16(fmaxf(__fadd_rn(h2, sk), 0.0f));
        }
    __syncthreads();
    for (int e = tid; e < NT * TM; e += kThreads) {
      const int nl = e / TM, col = e % TM, n = n0 + nl, gt = t0 + col;
      if (n >= C_out || gt >= T) continue;
      const bf16 y0 = tile[nl * OBS + col], y1 = tile[nl * OBS + OC + col];
      if (pool) {
        out[(((size_t)b * C_out + n) * (F / 2) + blockIdx.y) * T + gt] =
            __float2bfloat16(fmaxf(__bfloat162float(y0), __bfloat162float(y1)));
      } else {
        bf16* o_at = out + (((size_t)b * C_out + n) * F + f0) * T + gt;
        o_at[0] = y0;
        o_at[T] = y1;
      }
    }
  }
}

}  // namespace

extern "C" {

// K6 on `stream`; ws, bs, ss, os null for the identity skip (C_in == C_out).
// Returns 0 or a cudaError_t code.
int res_block_forward(const void* x, const void* w1, const void* b1, const void* s1,
                      const void* o1, const void* w2, const void* b2, const void* s2,
                      const void* o2, const void* ws, const void* bs, const void* ss,
                      const void* os, void* out, int B, int C_in, int C_mid, int C_out, int F,
                      int T, int pool, void* stream) {
  const bool skip = ws != nullptr;
  if (B <= 0 || C_in <= 0 || C_mid <= 0 || C_out <= 0 || F <= 0 || T <= 0 || C_in % CK ||
      C_mid % CK || C_out % CK || F % 2 || (pool && F % 4) || F / FR > 65535 || B > 65535 ||
      (!skip && C_in != C_out) || (skip && (bs == nullptr || ss == nullptr || os == nullptr)))
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(C_in, C_mid);
  if (smem > (size_t)kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(res_block_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((T + TM - 1) / TM, F / FR, B);
  res_block_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(s1), static_cast<const float*>(o1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(s2), static_cast<const float*>(o2),
      static_cast<const bf16*>(ws), static_cast<const float*>(bs), static_cast<const float*>(ss),
      static_cast<const float*>(os), static_cast<bf16*>(out), C_in, C_mid, C_out, F, T, pool);
  return cudaGetLastError();
}

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
