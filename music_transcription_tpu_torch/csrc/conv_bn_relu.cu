// Fused inference ConvBNRelu [+ (2,1) max-pool over frequency] on the H100: K5.
// bf16 out; a call launches the weight packing, then K5.
//
// Replaces music_transcription_tpu/ops/conv_pallas.py:
//   K5  fused_conv_bn_relu -> _conv_bn_kernel
//
//   x    (B, C_in, F, T), NCHW (T contiguous), fp32 / bf16 / fp16 / fp64
//   w    (C_out, C_in, KH, KW), torch's layout, in any of those types
//   bias, g, beta, mean, var  (C_out,): the conv bias and the BatchNorm's
//        scale, bias and running statistics, in any of those types
//   out  (B, C_out, F, T) bf16, or (B, C_out, F/2, T) with pool
//
//   acc[n, f, t] = sum_{c, df, dt} x[c, f + df - KH/2, t + dt - KW/2] * w[n, c, df, dt]
//                  (SAME: zeros outside the tensor; x and w rounded to bf16,
//                  exact products, fp32 sums)
//   s = g / sqrt(var + 1e-5), o = beta - mean * s      (fp32, each op rounded once)
//   y[n, f, t]   = bf16( relu( float(bf16(acc + bias[n])) * s[n] + o[n] ) )
//   pool: out[n, f, t] = max(y[n, 2f, t], y[n, 2f+1, t])
// the Pallas kernel's rounding points (_bn_relu_bf16). Rounding is monotone,
// so the max is taken before the last bf16 rounding. The affine is a product
// and a sum each rounded once (__fmul_rn, __fadd_rn), as PyTorch's plain
// version computes it.
//
// A call is two launches. pack_kernel computes every channel's (bias, s, o)
// from the raw vectors and writes the weights, as the main kernel reads
// them, into scratch: the wrapper does no host-side conversion.
//
// What bounds it on the H100. The 89M model's two ConvBNRelu stages at the
// 30 s route's shape (B=4, T=938): conv1 (3x3, C 1->32, F=320, pool) does
// 0.69 GFLOP and must move 40.8 MB, almost all of it the output: bytes,
// 0.0122 ms at 3.35 TB/s. freq_aware_conv (7x3, C 128->256, F=80, pool) does
// 413 GFLOP on 155 MB: operations, 0.418 ms at the 989 TFLOP/s bf16
// tensor-core rate. Its weights (1.38 MB) do not fit in shared memory, so
// they stream from L2 once for every tile of M output pixels: 1.38 MB x
// pixels / M a call. So two kernels:
//
// conv_bn_relu_tc_kernel (C_in >= 16): a walk down F on wgmma. A block owns
// a strip of TM = 64 output columns of one image over a segment of output
// rows and walks it in steps of STEP = 4 rows (two pool pairs): M = 256
// pixels a step, so the weights come from L2 once for every 256 outputs
// (1.65 GB a call at freq_aware_conv, from 3.30 GB with 2 x 64 tiles). It
// keeps every input channel of the rows a step needs in a ring in shared
// memory ([chunk][row][pixel][16], 32 bytes a pixel, tile_mma.cuh's swizzle):
// KH + 3 rows of TM + KW - 1 pixels, zeros outside the tensor, so each x
// element is gathered once a segment. A step needs the ring's rows
// 4i .. 4i + KH + 2; the next step replaces the 4 oldest, chunk by chunk:
// the loaders refill a chunk's rows as soon as the step's last output group
// is done with that chunk, while the products of the later chunks run, so
// no spare rows are needed (at freq_aware_conv the ring takes 169 KB).
// The weights are cut into stages of one 16-channel input chunk x 7 taps
// (3 for a 3x3 filter, 1 for one whose taps are no multiple of 7 or 3) x 64
// output channels (14 KB at 7), packed into scratch as a stage holds
// them ([tap][64][16], the swizzle), and stream through a ring with full and
// empty mbarriers, one TMA bulk copy a stage from one elected thread, ahead
// of the consumers. 384 threads: two consumer warpgroups (one pool pair of
// the step each; its 128 pixels are two wgmma m64 tiles of 32 columns x 2
// rows, so a pool pair is in one thread's registers), one warp for the
// weights, three warps that gather the x rows (2-byte loads along T of 16
// channels packed into pixel rows). Every product is wgmma m64n64k16 (bf16
// in, fp32 accumulators in registers) with A from registers -- ldmatrix.x4
// at the lane's pixel moved by the tap's ring row and dt gives the A
// fragment -- and B a stage's tap through a 32-byte-swizzle K-major
// descriptor; output channels in groups of 64. A stage's products (2 m-tiles
// x its taps, a fixed sequence: the stage's taps are a template parameter)
// are one committed group, waited for before the stage is released; the two
// warpgroups' groups overlap each other. The epilogue runs
// from the registers: + bias, bf16, the affine, ReLU, the max of the pair,
// bf16, stored along T. The segment height makes strips x B x segments fill the
// SMs (freq_aware_conv at B=4, T=938 on 132 SMs: 2 segments of 40 rows,
// 120 blocks), at least 8 rows. No atomics: every output is summed in the
// same order in every launch.
//
// conv_bn_relu_cc_kernel (C_in < 16, conv1's C_in = 1): K = C_in KH KW (9 at
// conv1) gives the tensor cores nothing to do, so fp32 FMAs on the CUDA
// cores, with the weights (fp32) and affines in shared memory. Its bound is
// the output, so every store of a thread writes 8 consecutive outputs of one
// channel, 16 bytes. T = 938 is no multiple of 8, so a row of the output is
// not 16-byte aligned; a thread takes instead 8 consecutive elements of a
// channel's (F_out, T) plane, aligned in memory, which may end one row and
// start the next. When every plane is a multiple of 8 elements and the
// filter is conv1's (C_in = 1, 3x3), a thread loads the input window of its
// chunk (4 rows x 10 columns, and a second window where the chunk crosses a
// row end) into registers once and computes its 8 outputs of CG = 16 output
// channels from it (chunks of 16 channels, not all 32, spread conv1's work
// evenly over a grid sized to the SMs). Otherwise (any other C_in < 16 or filter, or planes that
// are no multiple of 8) a thread computes its 8 outputs element by element;
// the wrapper pads the output's storage to a multiple of 8 elements, so the
// last store stays whole. The grid is sized to the SMs and walks the chunks.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tile_mma.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may have

// the dtype codes of the raw tensors (the wrapper's _DTYPE_CODES)
enum : int { kF32 = 0, kBF16 = 1, kF16 = 2, kF64 = 3 };

// the tensor-core walk
constexpr int kConsumers = 256;     // two consumer warpgroups
constexpr int kLoaders = 96;        // three warps gather the x rows
constexpr int kThreads = kConsumers + 32 + kLoaders;  // and one warp loads the weights
constexpr int TM = 64;              // output columns of a strip
constexpr int STEP = 4;             // output rows a step: two pool pairs
constexpr int NW = 64;              // output channels of a group (n64)
constexpr int TAP_BYTES = NW * PIX_BYTES;  // one tap's weight rows of a chunk and group
constexpr int kMaxStages = 8;
constexpr int kMinSegmentRows = 8;

// the CUDA-core chunks
constexpr int kCcThreads = 128;
constexpr int kCcBlocksPerSm = 3;
constexpr int CW = 8;               // outputs of one store (16 bytes)
constexpr int CG = 16;              // output channels of a chunk (conv1's case)

// What a launch computes where, the same for every block (host-side plan).
struct Plan {
  int B, C_in, C_out, F, T, KH, KW, pool;
  int tc;          // 1: the tensor-core walk; 0: the CUDA-core chunks
  int n_prm;       // per-channel affines in scratch: g * 64 on the walk, else C_out
  uint32_t w_scratch;  // byte offset of the packed weights in scratch
  // the tensor-core walk
  int seg_rows;    // output rows of a segment (a multiple of STEP, or F)
  int W, R;        // pixels of a ring row (TM + KW - 1); ring rows (KH + STEP - 1)
  int nk, g;       // 16-channel input chunks; 64-channel output groups
  int taps, spt, sper;  // taps; taps a weight stage (7, 3 or 1); stages a (group, chunk)
  int per_step;    // weight stages a step: g nk sper
  int stages;      // weight ring stages
  int stage_bytes; // spt * TAP_BYTES
  // from the 1024-aligned base (x ring at 0): the affines, the weight
  // stages, the barriers
  uint32_t prm_off, w_off, bar_off;
  // the CUDA-core chunks
  int fast;        // conv1's case: a thread's windows in registers, CG channels
};

__device__ __forceinline__ float load_float(const void* p, size_t i, int code) {
  switch (code) {
    case kBF16: return __bfloat162float(static_cast<const bf16*>(p)[i]);
    case kF16: return __half2float(static_cast<const __half*>(p)[i]);
    case kF64: return __double2float_rn(static_cast<const double*>(p)[i]);
    default: return static_cast<const float*>(p)[i];
  }
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// + conv bias in fp32, one bf16 rounding, the BN affine in fp32 (rounded
// after the product and after the sum), ReLU; c = (bias, s, o).
__device__ __forceinline__ float bn_relu(float acc, float4 c) {
  const float h = bf16_round(__fadd_rn(acc, c.x));
  return fmaxf(__fadd_rn(__fmul_rn(h, c.y), c.z), 0.0f);
}

// ---------------------------------------------------------------------------
// The packing: affines, then the weights as the main kernel reads them
// ---------------------------------------------------------------------------

// Scratch: [n_prm] float4 (bias, s, o, 0), zeros past C_out; at w_scratch
// the weights. The walk's: weight stage c of a step (its place in the step's
// order: group, chunk, stage) at c * stage_bytes, [tap][64][16] bf16 in the
// 32-byte swizzle, zeros past C_out and C_in. The CUDA-core kernel's: fp32
// (C_out, C_in, KH, KW), rounded to bf16 values.
__global__ void pack_kernel(const void* __restrict__ w, const void* __restrict__ bias,
                            const void* __restrict__ g, const void* __restrict__ beta,
                            const void* __restrict__ mean, const void* __restrict__ var,
                            int dtypes, unsigned char* __restrict__ scratch, const Plan p) {
  const int code_w = dtypes >> 3 & 7;
  const long long n_w = p.tc ? (long long)p.per_step * p.spt * NW * 2
                             : (long long)p.C_out * p.C_in * p.KH * p.KW;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < p.n_prm + n_w;
       e += (long long)gridDim.x * blockDim.x) {
    if (e < p.n_prm) {
      const int n = (int)e;
      float4 c = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (n < p.C_out) {
        const float gv = load_float(g, n, dtypes >> 9 & 7), bv = load_float(beta, n, dtypes >> 12 & 7);
        const float mv = load_float(mean, n, dtypes >> 15 & 7), vv = load_float(var, n, dtypes >> 18 & 7);
        const float s = __fdiv_rn(gv, __fsqrt_rn(__fadd_rn(vv, 1e-5f)));
        c = make_float4(load_float(bias, n, dtypes >> 6 & 7), s, __fsub_rn(bv, __fmul_rn(mv, s)), 0.0f);
      }
      reinterpret_cast<float4*>(scratch)[n] = c;
      continue;
    }
    const long long i = e - p.n_prm;
    if (!p.tc) {
      reinterpret_cast<float*>(scratch + p.w_scratch)[i] = bf16_round(load_float(w, i, code_w));
      continue;
    }
    const int per_stage = p.spt * NW * 2;  // 16-byte halves of a stage
    const int c = (int)(i / per_stage), rem = (int)(i % per_stage), row = rem / 2, half = rem % 2;
    const int s = c % p.sper, kc = (c / p.sper) % p.nk, ng = c / (p.sper * p.nk);
    const int tap = s * p.spt + row / NW, n = ng * NW + row % NW;
    const int df = tap / p.KW, dt = tap % p.KW;
    uint32_t pk[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      unsigned short v[2];
#pragma unroll
      for (int l = 0; l < 2; ++l) {
        const int ch = kc * CK + 8 * half + 2 * k + l;
        const float f = n < p.C_out && ch < p.C_in
                            ? load_float(w, (((size_t)n * p.C_in + ch) * p.KH + df) * p.KW + dt, code_w)
                            : 0.0f;
        v[l] = __bfloat16_as_ushort(__float2bfloat16(f));
      }
      pk[k] = v[0] | (uint32_t)v[1] << 16;
    }
    *reinterpret_cast<uint4*>(scratch + p.w_scratch + (size_t)c * p.stage_bytes +
                              swizzled_bytes(row, half)) = make_uint4(pk[0], pk[1], pk[2], pk[3]);
  }
}

// ---------------------------------------------------------------------------
// C_in >= 16: the walk down F on wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void zero(float (&acc)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
}

// Keeps A fragments alive (unreused) until the products that read them
// have completed.
template <int N>
__device__ __forceinline__ void keep(const uint32_t (&a)[N][4]) {
#pragma unroll
  for (int t = 0; t < N; ++t)
    asm volatile("" ::"r"(a[t][0]), "r"(a[t][1]), "r"(a[t][2]), "r"(a[t][3]));
}

// The A fragments of taps tap0 .. tap0 + N - 1 for one m-tile, from a
// chunk's ring at a_base: the lane's pixel is ring row slot0 + df (mod R),
// column col + dt.
template <int N>
__device__ __forceinline__ void load_a(uint32_t (&a)[N][4], uint32_t a_base, int slot0, int col,
                                       int half, int tap0, const Plan& p) {
  int df = tap0 / p.KW, dt = tap0 - df * p.KW;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int slot = slot0 + df < p.R ? slot0 + df : slot0 + df - p.R;
    ldmatrix_x4(a[k], a_base + swizzled_bytes(slot * p.W + col + dt, half));
    if (++dt == p.KW) dt = 0, ++df;
  }
}

// SPT: the taps of a weight stage (a divisor of KH KW: 7, 3 or 1), fixed at
// compile time, so that a stage's products are a fixed sequence with no
// branch between them.
template <int SPT>
__global__ void __launch_bounds__(kThreads, 1)
conv_bn_relu_tc_kernel(const void* __restrict__ x, int x_code,
                       const unsigned char* __restrict__ scratch, bf16* __restrict__ out,
                       const Plan p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (shared_address(smem_raw) & 1023)) & 1023);
  const uint32_t xs = shared_address(base);  // x ring: [nk][R][W][16]
  const uint32_t wsm = xs + p.w_off;         // weight stages
  float4* prm = reinterpret_cast<float4*>(base + p.prm_off);
  // full[stages], empty[stages], x_full[nk], x_empty[nk]
  const uint32_t wfull = xs + p.bar_off, wempty = wfull + 8 * p.stages,
                 xfull = wempty + 8 * p.stages, xempty = xfull + 8 * p.nk;
  const int chunk_bytes = p.R * p.W * PIX_BYTES;  // one chunk's ring

  const int t0 = blockIdx.x * TM, f0 = blockIdx.y * p.seg_rows, b = blockIdx.z;
  const int f_end = p.F - f0 < p.seg_rows ? p.F : f0 + p.seg_rows;
  const int steps = (f_end - f0 + STEP - 1) / STEP;
  // the warp's index as a value ptxas knows to be the same on all its lanes
  // (else it cannot tell that the roles' branches, and the products in
  // them, do not diverge, and serializes the products)
  const int tid = threadIdx.x, warp = __shfl_sync(0xffffffffu, tid / 32, 0), lane = tid % 32;

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(wfull + 8 * s, 1);
      mbar_init(wempty + 8 * s, 8);
    }
    for (int kc = 0; kc < p.nk; ++kc) {
      mbar_init(xfull + 8 * kc, kLoaders);
      mbar_init(xempty + 8 * kc, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int c = tid; c < p.n_prm; c += kThreads) prm[c] = reinterpret_cast<const float4*>(scratch)[c];
  __syncthreads();

  if (warp == kConsumers / 32) {  // the weight warp: one thread's bulk copies
    if (lane == 0) {
      const unsigned char* packed = scratch + p.w_scratch;
      for (int n = 0; n < steps * p.per_step; ++n) {
        const int s = n % p.stages, c = n % p.per_step;
        const uint32_t bar = wfull + 8 * s, bytes = p.stage_bytes;
        if (n >= p.stages) mbar_wait(wempty + 8 * s, (n / p.stages - 1) & 1);
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                     "r"(bytes)
                     : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
            "[%3];\n" ::"r"(wsm + (uint32_t)(s * p.stage_bytes)),
            "l"(packed + (size_t)c * p.stage_bytes), "r"(bytes), "r"(bar)
            : "memory");
      }
    }
    return;
  }
  if (warp > kConsumers / 32) {  // the x loaders: step i's new rows, chunk by chunk
    const int lt = tid - kConsumers - 32;
    const size_t plane = (size_t)p.F * p.T;
    const unsigned short* x16 = static_cast<const unsigned short*>(x);
    for (int i = 0; i < steps; ++i) {
      const int r0 = i == 0 ? 0 : p.R + STEP * (i - 1), nrows = i == 0 ? p.R : STEP;
      for (int kc = 0; kc < p.nk; ++kc) {
        if (i > 0) mbar_wait(xempty + 8 * kc, (i - 1) & 1);  // its oldest rows are done
        const int nch = p.C_in - kc * CK < CK ? p.C_in - kc * CK : CK;
        for (int e = lt; e < nrows * p.W; e += kLoaders) {
          const int lr = r0 + e / p.W, px = e % p.W;
          const int gr = f0 - p.KH / 2 + lr, gt = t0 - p.KW / 2 + px;
          uint32_t pk[CK / 2] = {};  // channel pairs, the lower channel in the low half
          if (gr >= 0 && gr < p.F && gt >= 0 && gt < p.T) {
            const size_t at = (((size_t)b * p.C_in + kc * CK) * p.F + gr) * p.T + gt;
            unsigned short v[CK];
            if (x_code == kBF16) {
#pragma unroll
              for (int ch = 0; ch < CK; ++ch) v[ch] = ch < nch ? __ldg(x16 + at + ch * plane) : 0;
            } else {
#pragma unroll
              for (int ch = 0; ch < CK; ++ch)
                v[ch] = ch < nch ? __bfloat16_as_ushort(
                                       __float2bfloat16(load_float(x, at + ch * plane, x_code)))
                                 : 0;
            }
#pragma unroll
            for (int q = 0; q < CK / 2; ++q) pk[q] = v[2 * q] | (uint32_t)v[2 * q + 1] << 16;
          }
          unsigned char* dst = base + kc * chunk_bytes;
          const int pix = (lr % p.R) * p.W + px;
          *reinterpret_cast<uint4*>(dst + swizzled_bytes(pix, 0)) =
              make_uint4(pk[0], pk[1], pk[2], pk[3]);
          *reinterpret_cast<uint4*>(dst + swizzled_bytes(pix, 1)) =
              make_uint4(pk[4], pk[5], pk[6], pk[7]);
        }
        mbar_arrive(xfull + 8 * kc);
      }
    }
    return;
  }

  // The consumers. Warpgroup wg takes output rows 2 wg, 2 wg + 1 of a step
  // (one pool pair); its m-tile m columns 32 m .. 32 m + 31 of both rows:
  // warp wq of it columns 32 m + 8 wq .. + 7, its 16 M rows (row 0 of the
  // pair at rows 0-7, row 1 at rows 8-15). This lane addresses M row mr for
  // ldmatrix; its accumulators hold column 32 m + 8 wq + g of both rows,
  // channels 8 j + 2 q, + 1 of the group (j = 0 .. 7).
  const int wg = warp / 4, wq = warp % 4;
  const int mr = lane % 16, jr = mr / 8, half = lane / 16;
  const int g = lane / 4, q = lane % 4;
  const int mcol = 8 * wq + mr % 8, acol = 8 * wq + g;
  const int rows_out = p.pool ? p.F / 2 : p.F;
  const size_t plane = (size_t)rows_out * p.T;  // from one channel's output to the next
  int n_stage = 0;                              // weight stages consumed

  for (int i = 0; i < steps; ++i) {
    const int fr = f0 + STEP * i + 2 * wg;  // the warpgroup's first output row
    const bool rows_in = fr < f_end;        // its pool pair lies in the segment
    const int slot0 = (STEP * i + 2 * wg + jr) % p.R;
    for (int ng = 0; ng < p.g; ++ng) {
      // A stage's products (both m-tiles, SPT taps) are one committed group,
      // waited for before the stage is released; the two warpgroups' groups
      // overlap each other. (Loading the next stage's A fragments while a
      // group runs, with wgmma.wait_group 1, made ptxas serialize the
      // products: slower.) m-tile 1 runs even where all its columns lie
      // past T (zeros in the ring; nothing stored): a branch around products
      // costs more than they do.
      float acc[2][32];
      zero(acc[0]);
      zero(acc[1]);
      for (int kc = 0; kc < p.nk; ++kc) {
        if (ng == 0) mbar_wait(xfull + 8 * kc, i & 1);
        const uint32_t a_base = xs + kc * chunk_bytes;
        for (int s = 0; s < p.sper; ++s) {
          const int st = n_stage % p.stages;
          const uint32_t b_tile = wsm + (uint32_t)(st * p.stage_bytes);
          mbar_wait(wfull + 8 * st, (n_stage / p.stages) & 1);
          if (rows_in) {
            uint32_t a[2][SPT][4];  // [m-tile][tap]
            load_a<SPT>(a[0], a_base, slot0, mcol, half, s * SPT, p);
            load_a<SPT>(a[1], a_base, slot0, mcol + 32, half, s * SPT, p);
            wgmma_fence();
#pragma unroll
            for (int k = 0; k < SPT; ++k) {
              const uint64_t desc = sw32_desc(b_tile + k * TAP_BYTES);
              wgmma_rs_kmajor(acc[0], a[0][k], desc);
              wgmma_rs_kmajor(acc[1], a[1][k], desc);
            }
            wgmma_commit();
            wgmma_wait_all();
            fence_acc(acc[0]);
            fence_acc(acc[1]);
            keep(a[0]);
            keep(a[1]);
          }
          if (lane == 0) mbar_arrive(wempty + 8 * st);
          ++n_stage;
        }
        if (ng == p.g - 1) {  // the step's last use of the chunk's oldest rows
          __syncwarp();
          if (lane == 0) mbar_arrive(xempty + 8 * kc);
        }
      }
      const float4* prm_at = prm + ng * NW + 2 * q;
      const int nvalid = p.C_out - ng * NW - 2 * q;
      const int gt = t0 + acol;  // m-tile 1's column is 32 further
      bf16* o_at = out + ((size_t)b * p.C_out + ng * NW + 2 * q) * plane +
                   (size_t)(p.pool ? fr / 2 : fr) * p.T + gt;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // one pair of channels' affines at a time (the compiler would
        // otherwise load all 16 ahead and spill accumulators for them)
        asm volatile("" ::: "memory");
        const float4 c[2] = {prm_at[8 * j], prm_at[8 * j + 1]};
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          float y[2][2];  // [channel 8 j + 2 q + e][row]
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int h = 0; h < 2; ++h) y[e][h] = bn_relu(acc[m][4 * j + 2 * h + e], c[e]);
          settle(y[0][0], y[0][1]);
          settle(y[1][0], y[1][1]);
          if (!rows_in || gt + 32 * m >= p.T) continue;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (8 * j + e >= nvalid) continue;
            bf16* at = o_at + (size_t)(8 * j + e) * plane + 32 * m;
            if (p.pool) {
              at[0] = __float2bfloat16(fmaxf(y[e][0], y[e][1]));
            } else {
              at[0] = __float2bfloat16(y[e][0]);
              at[p.T] = __float2bfloat16(y[e][1]);
            }
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// C_in < 16: chunks of 8 outputs on the CUDA cores
// ---------------------------------------------------------------------------

// conv1's input window of a chunk (C_in = 1, 3x3): rows row0 .. row0 + 3 (the
// pool pair's 2 + 2 halo, or 1 + 2 without pool) and columns col0 .. col0 +
// 9 of image plane x[plane0 ..], bf16 values, zeros outside the tensor.
__device__ __forceinline__ void load_window(float (&v)[4][10], const void* x, int code,
                                            size_t plane0, int row0, int col0, const Plan& p) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = row0 + r;
#pragma unroll
    for (int j = 0; j < 10; ++j) {
      const int col = col0 + j;
      v[r][j] = row >= 0 && row < p.F && col >= 0 && col < p.T
                    ? bf16_round(load_float(x, plane0 + (size_t)row * p.T + col, code))
                    : 0.0f;
    }
  }
}

// Outputs of the 8 columns of a window (pooled over its pair of rows with
// pool), one channel: weights w, affine c.
__device__ __forceinline__ void conv8(float (&y)[8], const float (&v)[4][10],
                                      const float (&w)[3][3], float4 c, int pool) {
  float acc[2][8] = {};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (h == 1 && !pool) break;
#pragma unroll
    for (int df = 0; df < 3; ++df)
#pragma unroll
      for (int dt = 0; dt < 3; ++dt)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[h][j] = fmaf(v[h + df][j + dt], w[df][dt], acc[h][j]);
  }
  // bn_relu two values at a time (one conversion to a bf16 pair): with pool
  // a column's two rows, then their max; else two columns
  const auto affine = [&](float h) { return __fadd_rn(__fmul_rn(h, c.y), c.z); };
  const auto rounded = [&](float a0, float a1) {
    return __bfloat1622float2(__floats2bfloat162_rn(__fadd_rn(a0, c.x), __fadd_rn(a1, c.x)));
  };
  if (pool) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 h = rounded(acc[0][j], acc[1][j]);
      y[j] = fmaxf(fmaxf(affine(h.x), affine(h.y)), 0.0f);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      const float2 h = rounded(acc[0][j], acc[0][j + 1]);
      y[j] = fmaxf(affine(h.x), 0.0f);
      y[j + 1] = fmaxf(affine(h.y), 0.0f);
    }
  }
}

// The output at (b, n, fo, t), element by element (any C_in < 16 and filter).
__device__ float output_at(const void* x, int code, const float* wsm, float4 c, int b, int n,
                           int fo, int t, const Plan& p) {
  const int taps = p.KH * p.KW, r0 = (p.pool ? 2 * fo : fo) - p.KH / 2, c0 = t - p.KW / 2;
  float a0 = 0.0f, a1 = 0.0f;
  for (int ci = 0; ci < p.C_in; ++ci) {
    const size_t plane0 = ((size_t)b * p.C_in + ci) * p.F * p.T;
    const float* wc = wsm + ((size_t)n * p.C_in + ci) * taps;
    for (int df = 0; df < p.KH; ++df) {
      const int row = r0 + df;
      for (int dt = 0; dt < p.KW; ++dt) {
        const int col = c0 + dt;
        if (col < 0 || col >= p.T) continue;
        const float w = wc[df * p.KW + dt];
        if (row >= 0 && row < p.F)
          a0 = fmaf(bf16_round(load_float(x, plane0 + (size_t)row * p.T + col, code)), w, a0);
        if (p.pool && row + 1 >= 0 && row + 1 < p.F)
          a1 = fmaf(bf16_round(load_float(x, plane0 + (size_t)(row + 1) * p.T + col, code)), w, a1);
      }
    }
  }
  const float y0 = bn_relu(a0, c);
  return p.pool ? fmaxf(y0, bn_relu(a1, c)) : y0;
}

__device__ __forceinline__ uint4 pack8(const float (&y)[8]) {
  uint32_t pk[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(y[2 * k], y[2 * k + 1]);
    pk[k] = *reinterpret_cast<const uint32_t*>(&v);
  }
  return make_uint4(pk[0], pk[1], pk[2], pk[3]);
}

__global__ void __launch_bounds__(kCcThreads, kCcBlocksPerSm)
conv_bn_relu_cc_kernel(const void* __restrict__ x, int x_code,
                       const unsigned char* __restrict__ scratch, bf16* __restrict__ out,
                       const Plan p) {
  extern __shared__ float4 smem_cc[];
  float4* prm = smem_cc;                                  // [C_out]
  float* wsm = reinterpret_cast<float*>(prm + p.C_out);   // [C_out][C_in][KH][KW]
  const float* wg = reinterpret_cast<const float*>(scratch + p.w_scratch);
  for (int i = threadIdx.x; i < p.C_out; i += kCcThreads)
    prm[i] = reinterpret_cast<const float4*>(scratch)[i];
  if (p.fast) {  // conv1's 9 taps a channel padded to 12: three float4 loads
    for (int i = threadIdx.x; i < 12 * p.C_out; i += kCcThreads)
      wsm[i] = i % 12 < 9 ? wg[i / 12 * 9 + i % 12] : 0.0f;
  } else {
    for (int i = threadIdx.x; i < p.C_out * p.C_in * p.KH * p.KW; i += kCcThreads) wsm[i] = wg[i];
  }
  __syncthreads();

  const long long plane = (long long)(p.pool ? p.F / 2 : p.F) * p.T;  // outputs of a channel
  const long long first = blockIdx.x * (long long)kCcThreads + threadIdx.x,
                  stride = (long long)gridDim.x * kCcThreads;
  if (p.fast) {  // a chunk of 8 outputs of CG channels, from windows in registers
    const long long per_image = plane / CW;
    const int groups = (p.C_out + CG - 1) / CG;
    for (long long u = first; u < p.B * groups * per_image; u += stride) {
      const int b = (int)(u / per_image / groups), n0 = (int)(u / per_image % groups) * CG;
      const int n1 = p.C_out - n0 < CG ? p.C_out : n0 + CG;
      const long long e0 = u % per_image * CW;
      const int fo = (int)(e0 / p.T), t0 = (int)(e0 % p.T);
      const int split = p.T - t0;  // outputs of the chunk in row fo; the rest start row fo + 1
      const int rows = p.pool ? 2 : 1;
      float va[4][10], vb[4][10];
      load_window(va, x, x_code, (size_t)b * p.F * p.T, rows * fo - 1, t0 - 1, p);
      if (split < CW) load_window(vb, x, x_code, (size_t)b * p.F * p.T, rows * (fo + 1) - 1,
                                  t0 - p.T - 1, p);
      bf16* o = out + ((size_t)b * p.C_out + n0) * plane + e0;
      // channel n's weights and affine, loaded while channel n - 1 computes
      const float4* wv = reinterpret_cast<const float4*>(wsm);
      float4 w0 = wv[3 * n0], w1 = wv[3 * n0 + 1], w2 = wv[3 * n0 + 2], cn = prm[n0];
      for (int n = n0; n < n1; ++n, o += plane) {
        const float w[3][3] = {{w0.x, w0.y, w0.z}, {w0.w, w1.x, w1.y}, {w1.z, w1.w, w2.x}};
        const float4 c = cn;
        if (n + 1 < n1) w0 = wv[3 * n + 3], w1 = wv[3 * n + 4], w2 = wv[3 * n + 5], cn = prm[n + 1];
        float ya[8], yb[8];
        conv8(ya, va, w, c, p.pool);
        if (split < CW) {
          conv8(yb, vb, w, c, p.pool);
#pragma unroll
          for (int j = 0; j < CW; ++j) ya[j] = j < split ? ya[j] : yb[j];
        }
        *reinterpret_cast<uint4*>(o) = pack8(ya);
      }
    }
    return;
  }
  // element by element: chunk u is outputs 8 u .. 8 u + 7 of the whole
  // tensor (the storage is padded to a multiple of 8)
  const long long total = p.B * p.C_out * plane;
  for (long long u = first; u < (total + CW - 1) / CW; u += stride) {
    float y[CW];
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      const long long e = u * CW + j;
      y[j] = 0.0f;
      if (e >= total) continue;
      const long long bn = e / plane, in = e % plane;
      const int n = (int)(bn % p.C_out);
      y[j] = output_at(x, x_code, wsm, prm[n], (int)(bn / p.C_out), n, (int)(in / p.T),
                       (int)(in % p.T), p);
    }
    *reinterpret_cast<uint4*>(out + u * CW) = pack8(y);
  }
}

// ---------------------------------------------------------------------------
// Host side: the plan and the launches
// ---------------------------------------------------------------------------

// Per-device facts a launch needs, looked up once a device: its SM count and
// the dynamic shared memory each kernel has been allowed (host time a call
// would otherwise pay).
constexpr int kMaxDevices = 64;
int g_sms[kMaxDevices], g_tc_smem[8][kMaxDevices], g_cc_smem[kMaxDevices];  // g_tc_smem[SPT]

int current_device() {
  int dev = 0;
  return cudaGetDevice(&dev) == cudaSuccess && dev >= 0 && dev < kMaxDevices ? dev : -1;
}

int sm_count() {
  const int dev = current_device();
  if (dev < 0) return 0;
  if (g_sms[dev] == 0 &&
      cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    g_sms[dev] = 0;
  return g_sms[dev];
}

// Allows `kernel` `smem` bytes of dynamic shared memory on the current device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, int (&allowed)[kMaxDevices]) {
  const int dev = current_device();
  if (dev < 0) return cudaErrorInvalidDevice;
  if ((size_t)allowed[dev] >= smem) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) allowed[dev] = (int)smem;
  return e;
}

// Output rows of a segment of the walk: enough segments that strips x B x
// segments fill the SMs (one block an SM), at least kMinSegmentRows rows,
// a multiple of STEP; F if that leaves one segment.
int segment_rows(int B, int F, int T, int sms) {
  const long units = (long)((T + TM - 1) / TM) * B;
  const int nseg = units >= sms ? 1 : (int)(sms / units);
  int rows = (F + nseg - 1) / nseg;
  rows = (rows + STEP - 1) / STEP * STEP;
  if (rows < kMinSegmentRows) rows = kMinSegmentRows;
  return rows < F ? rows : F;
}

uint32_t round_up(size_t v, size_t to) { return (uint32_t)((v + to - 1) / to * to); }

size_t cc_smem_bytes(int C_in, int C_out, int KH, int KW) {
  return sizeof(float4) * C_out + sizeof(float) * (size_t)C_out * C_in * KH * KW;
}

// The launch's plan (from its shapes; seg_rows and fast set by the caller)
// and the main kernel's shared memory; false if the walk's rings and one
// weight stage do not fit.
bool make_plan(Plan& p, size_t& smem) {
  p.taps = p.KH * p.KW;
  p.tc = p.C_in >= CK || cc_smem_bytes(p.C_in, p.C_out, p.KH, p.KW) > (size_t)kSmemLimit;
  if (!p.tc) {
    p.n_prm = p.C_out;
    p.w_scratch = round_up(sizeof(float4) * p.n_prm, 1024);
    smem = cc_smem_bytes(p.C_in, p.C_out, p.KH, p.KW);
    return true;
  }
  p.W = TM + p.KW - 1;
  p.R = p.KH + STEP - 1;
  p.nk = (p.C_in + CK - 1) / CK;
  p.g = (p.C_out + NW - 1) / NW;
  p.spt = p.taps % 7 == 0 ? 7 : p.taps % 3 == 0 ? 3 : 1;
  p.sper = p.taps / p.spt;
  p.per_step = p.g * p.nk * p.sper;
  p.stage_bytes = p.spt * TAP_BYTES;
  p.n_prm = p.g * NW;
  p.w_scratch = round_up(sizeof(float4) * p.n_prm, 1024);
  p.prm_off = round_up((size_t)p.nk * p.R * p.W * PIX_BYTES, 1024);
  p.w_off = p.prm_off + round_up(sizeof(float4) * p.n_prm, 1024);
  const size_t fixed = 1024 + p.w_off + 16 * p.nk;  // alignment slack, x barriers
  const size_t stage = p.stage_bytes + 16;           // and a stage's two barriers
  if (fixed + stage > (size_t)kSmemLimit) return false;
  const size_t fit = ((size_t)kSmemLimit - fixed) / stage;
  p.stages = fit < (size_t)kMaxStages ? (int)fit : kMaxStages;
  p.bar_off = p.w_off + p.stages * p.stage_bytes;
  smem = fixed + p.stages * stage;
  return true;
}

}  // namespace

extern "C" {

// Output rows of a segment of K5's walk (C_in >= 16) at (B, F, T) on the
// current device.
int conv_bn_relu_segment_rows(int B, int F, int T) { return segment_rows(B, F, T, sm_count()); }

// Bytes of the scratch conv_bn_relu_forward packs the affines and weights
// into, or -1 where the walk's rings and one weight stage do not fit in
// shared memory.
long long conv_bn_relu_scratch_bytes(int C_in, int C_out, int KH, int KW) {
  Plan p{};
  p.C_in = C_in, p.C_out = C_out, p.KH = KH, p.KW = KW;
  size_t smem = 0;
  if (C_in <= 0 || C_out <= 0 || KH <= 0 || KW <= 0 || !make_plan(p, smem)) return -1;
  return p.w_scratch + (p.tc ? (long long)p.per_step * p.stage_bytes
                             : (long long)sizeof(float) * C_out * C_in * KH * KW);
}

// K5 on `stream`: pack_kernel, then the walk or the chunks. `dtypes`: the
// dtype codes (0 fp32, 1 bf16, 2 fp16, 3 fp64) of x, w, bias, g, beta, mean
// and var, 3 bits each from bit 0. `out`: 16-byte aligned, its storage a
// multiple of 8 outputs. `scratch`: conv_bn_relu_scratch_bytes of device
// memory. Returns 0 or a cudaError_t code.
int conv_bn_relu_forward(const void* x, const void* w, const void* bias, const void* g,
                         const void* beta, const void* mean, const void* var, void* out,
                         void* scratch, int dtypes, int B, int C_in, int C_out, int F, int T,
                         int KH, int KW, int pool, void* stream) {
  if (B <= 0 || C_in <= 0 || C_out <= 0 || F <= 0 || T <= 0 || KH <= 0 || KW <= 0 || F % 2 ||
      (pool && F % 4) || B > 65535 || scratch == nullptr || (reinterpret_cast<uintptr_t>(out) & 15))
    return cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  Plan p{};
  p.B = B, p.C_in = C_in, p.C_out = C_out, p.F = F, p.T = T, p.KH = KH, p.KW = KW, p.pool = pool;
  size_t smem = 0;
  if (!make_plan(p, smem)) return cudaErrorInvalidValue;
  const long long plane = (long long)(pool ? F / 2 : F) * T;
  p.seg_rows = p.tc ? segment_rows(B, F, T, sms) : 0;
  p.fast = !p.tc && C_in == 1 && KH == 3 && KW == 3 && T >= CW && plane % CW == 0 &&
           cc_smem_bytes(12, C_out, 1, 1) <= (size_t)kSmemLimit;
  if (p.fast) smem = cc_smem_bytes(12, C_out, 1, 1);  // the weights padded to 12 a channel
  if (p.tc && (F + p.seg_rows - 1) / p.seg_rows > 65535) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned char* sc = static_cast<unsigned char*>(scratch);

  const long long items = p.n_prm + (p.tc ? (long long)p.per_step * p.spt * NW * 2
                                          : (long long)C_out * C_in * KH * KW);
  const long long pack_blocks = (items + 255) / 256;
  pack_kernel<<<(unsigned)(pack_blocks < 8 * sms ? pack_blocks : 8 * sms), 256, 0, st>>>(
      w, bias, g, beta, mean, var, dtypes, sc, p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const int x_code = dtypes & 7;
  bf16* o = static_cast<bf16*>(out);
  if (p.tc) {
    const auto kernel = p.spt == 7 ? conv_bn_relu_tc_kernel<7>
                        : p.spt == 3 ? conv_bn_relu_tc_kernel<3> : conv_bn_relu_tc_kernel<1>;
    e = allow_smem(kernel, smem, g_tc_smem[p.spt]);
    if (e != cudaSuccess) return e;
    const dim3 grid((T + TM - 1) / TM, (F + p.seg_rows - 1) / p.seg_rows, B);
    kernel<<<grid, kThreads, smem, st>>>(x, x_code, sc, o, p);
    return cudaGetLastError();
  }
  e = allow_smem(conv_bn_relu_cc_kernel, smem, g_cc_smem);
  if (e != cudaSuccess) return e;
  const long long units = p.fast ? (long long)B * ((C_out + CG - 1) / CG) * (plane / CW)
                                 : (B * C_out * plane + CW - 1) / CW;
  const long long want = (units + kCcThreads - 1) / kCcThreads;
  const long long blocks = want < (long long)kCcBlocksPerSm * sms ? want : kCcBlocksPerSm * sms;
  conv_bn_relu_cc_kernel<<<(unsigned)blocks, kCcThreads, smem, st>>>(x, x_code, sc, o, p);
  return cudaGetLastError();
}

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
