// Fused inference ResidualBlock [+ (2,1) max-pool over frequency] on the H100: K6.
// bf16 in / bf16 out; a block call launches the weight packing, then K6.
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
// device memory. A block must also read the weights: res_block2's 448 KiB do
// not fit in shared memory, so they stream from L2 once for every step of the
// walk below (1.17 GB a call at 2 output rows a step).
//
// Design (Hopper). A block owns a strip of TM = 62 output columns of one
// image over a segment of output rows, and walks down the segment in steps
// of 2 output rows (one pool pair). It keeps in shared memory, every pixel
// channel-innermost in chunks of 16 channels ([chunk][pixel][16], 32 bytes a
// pixel, the two 16-byte halves swapped in rows 4-7 of every 8: tile_mma.cuh's
// layout, which is wgmma's 32-byte swizzle):
//   * a ring of x rows f-2 .. f+3 (6 rows of 66 pixels, columns t0-2 ..
//     t0+63), zeros outside the tensor;
//   * a ring of h1 rows f-1 .. f+2 (4 rows of 64 pixels, columns t0-1 ..
//     t0+62, a row stride of 66 whose last two columns stay zero), zeros
//     outside the tensor (a value computed there from the zero-padded x is
//     not zero: o1, then ReLU);
//   * the per-channel affines, a float4 each;
//   * the weights in chunks of one 16-channel input chunk x all 9 taps x 64
//     output channels (18 KB; the skip's chunk holds up to 9 input chunks):
//     resident when all of a step's chunks fit beside the rings (res_block1:
//     112 KiB, loaded once a block), else a ring of stages with a full and an
//     empty mbarrier each (res_block2: 26 chunks a step through 5 stages).
//     The entry first packs every chunk, as a stage holds it, into scratch,
//     so that one thread loads a stage with one bulk copy (TMA).
// 384 threads in four roles: two consumer warpgroups; one warp whose first
// lane issues the weights' bulk copies; three warps that gather the next x
// rows (2-byte loads along T of 16 channels, packed into 32-byte pixel rows)
// into a ring of 3 row pairs with full / empty mbarriers of their own.
// A step of the walk: conv1 computes the 2 new h1 rows (M = 128 pixels, 64 a
// consumer warpgroup); conv2 and the 1x1 skip the 2 output rows (M = 128: a
// warpgroup takes 32 columns of both rows, so a pool pair is in one thread's
// registers). The segment's first step also computes its 2 top h1 rows, so
// conv1 computes 2 rows a segment again, not 2 of every 4. Every product is
// wgmma m64n64k16 (bf16 in, fp32 accumulators in registers), A from
// registers -- ldmatrix.x4 of each warp's 16 pixels, moved by the tap's
// df * 66 + dt, gives exactly the A fragment -- and B a weight stage's
// [tap][64][16] rows through a 32-byte-swizzle K-major descriptor; output
// channels in groups of 64. Epilogues: conv1's writes bf16 h1 into its ring;
// conv2's sums both affines, applies ReLU and bf16 (and the pool) and stores
// along T from the registers. Two named barriers a step order the
// warpgroups' h1 writes and reads. The segment height makes strips x B x
// segments fill the SMs (res_block1 and res_block2 at B=4, T=938 on 132
// SMs: 2 segments of 80 and 40 rows, 128 blocks), at least 8 rows. No
// atomics: every output is summed in the same order in every launch and in
// every segment layout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tile_mma.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may have
constexpr int kConsumers = 256;     // two consumer warpgroups
constexpr int kLoaders = 96;        // three warps gather the x rows
constexpr int kThreads = kConsumers + 32 + kLoaders;  // and one warp loads the weights

constexpr int TM = 62;                 // output columns of a strip
constexpr int W = TM + 4;              // 66: pixels of a ring row
constexpr int XROWS = 6, HROWS = 4;    // rows of the x and h1 rings
constexpr int XPIX = XROWS * W, HPIX = HROWS * W;
constexpr int NW = 64;                 // output channels of a product (n64)
constexpr int TAP_BYTES = NW * PIX_BYTES;   // one tap's (or input chunk's) weight rows
constexpr int CHUNK_BYTES = 9 * TAP_BYTES;  // a weight chunk, a ring stage
constexpr int kMaxStages = 8;
constexpr int kMinSegmentRows = 8;

// What a launch computes where, the same for every block (host-side plan).
struct Plan {
  int C_in, C_mid, C_out, F, T, pool, skip;
  int seg_rows;   // output rows of a segment (even)
  int g1, g2;     // groups of 64 channels of C_mid (conv1) and C_out
  int nk1, nk2;   // 16-channel input chunks of conv1 (and the skip), conv2
  int ns;         // skip chunks a group (up to 9 input chunks each), 0 without
  int per_step;   // weight chunks a step: g1 nk1 + g2 (ns + nk2)
  int stages;     // weight ring stages; 0: all of a step's chunks resident
  // from the 1024-aligned base (x ring at 0): the h1 ring, the per-channel
  // affines, the weights, the barriers
  uint32_t h_off, prm_off, w_off, bar_off;
};

// Keeps A fragments alive (unreused) until the products that read them
// have completed.
__device__ __forceinline__ void keep(const uint32_t (&a)[9][4]) {
#pragma unroll
  for (int t = 0; t < 9; ++t)
    asm volatile("" ::"r"(a[t][0]), "r"(a[t][1]), "r"(a[t][2]), "r"(a[t][3]));
}

// + conv bias in fp32, one bf16 rounding, the BN affine in fp32 (rounded
// after the product and after the sum).
__device__ __forceinline__ float bn_affine(float acc, float bias, float s, float o) {
  const float h = __bfloat162float(__float2bfloat16(__fadd_rn(acc, bias)));
  return __fadd_rn(__fmul_rn(h, s), o);
}

__device__ __forceinline__ void zero(float (&acc)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
}

// acc += the products of `n` (<= 9) A operands with the weight chunk at `b`
// ([n][64][16]): A number k at the lane's pixel px[k] of the [pixels][16]
// tile at a_tile + k * a_stride. The 9 taps of a conv chunk share one tile;
// the skip's input chunks are one tile each. `active` false: all of the
// warpgroup's pixels lie past T, and it takes no part in the products.
__device__ __forceinline__ void mma_chunk(float (&acc)[32], uint32_t a_tile, uint32_t a_stride,
                                          const int (&px)[9], int n, uint32_t b, int half,
                                          bool active) {
  if (!active) return;
  uint32_t a[9][4];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    if (k < n) {
      ldmatrix_x4(a[k], a_tile + k * a_stride + swizzled_bytes(px[k], half));
      wgmma_fence();
      wgmma_rs_kmajor(acc, a[k], sw32_desc(b + k * TAP_BYTES));
    }
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_acc(acc);
  keep(a);
}

// Weight chunk `c` of a step (its place in the step's order: conv1's g1 x
// nk1, then for each group of 64 output channels the skip's ns and conv2's
// nk2): its rows (taps, or the skip's input chunks, x 64 output channels),
// and where row `row`'s 16-byte half `half` comes from in w1 / ws / w2
// (taps, C_n, C_k); null past C_n.
struct ChunkRow {
  int rows;
  const bf16* src;
};
__device__ __forceinline__ ChunkRow chunk_row(int c, int row, int half, const Plan& p,
                                              const bf16* __restrict__ w1,
                                              const bf16* __restrict__ w2,
                                              const bf16* __restrict__ ws) {
  const bf16* w;
  int C_n, C_k, ng, k0, rows;
  bool skip = false;  // rows are (input chunk, n); convs: (tap, n)
  if (c < p.g1 * p.nk1) {
    w = w1, C_n = p.C_mid, C_k = p.C_in, ng = c / p.nk1, k0 = (c % p.nk1) * CK, rows = 9 * NW;
  } else {
    const int r = c - p.g1 * p.nk1, per = p.ns + p.nk2, j = r % per;
    ng = r / per;
    if (j < p.ns) {
      w = ws, C_n = p.C_out, C_k = p.C_in, k0 = j * 9 * CK, skip = true;
      rows = (p.nk1 - j * 9 < 9 ? p.nk1 - j * 9 : 9) * NW;
    } else {
      w = w2, C_n = p.C_out, C_k = p.C_mid, k0 = (j - p.ns) * CK, rows = 9 * NW;
    }
  }
  const int outer = row / NW, n = ng * NW + row % NW;
  if (w == nullptr || row >= rows || n >= C_n) return {rows, nullptr};
  return {rows, w + (skip ? (size_t)n * C_k + k0 + outer * CK + 8 * half
                          : ((size_t)outer * C_n + n) * C_k + k0 + 8 * half)};
}

// Every weight chunk of a step as a stage holds it ([tap or input chunk][64]
// [16], 32-byte swizzle, zeros past C_n), chunk c at packed + c *
// CHUNK_BYTES: what K6's bulk copies read. One block a chunk.
__global__ void pack_weights_kernel(const bf16* __restrict__ w1, const bf16* __restrict__ w2,
                                    const bf16* __restrict__ ws, unsigned char* __restrict__ packed,
                                    const Plan p) {
  const int c = blockIdx.x, rows = chunk_row(c, 0, 0, p, w1, w2, ws).rows;
  for (int e = threadIdx.x; e < rows * 2; e += blockDim.x) {
    const ChunkRow at = chunk_row(c, e / 2, e % 2, p, w1, w2, ws);
    *reinterpret_cast<uint4*>(packed + (size_t)c * CHUNK_BYTES + swizzled_bytes(e / 2, e % 2)) =
        at.src ? *reinterpret_cast<const uint4*>(at.src) : make_uint4(0, 0, 0, 0);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
res_block_kernel(const bf16* __restrict__ x, const unsigned char* __restrict__ packed,
                 const float* __restrict__ b1, const float* __restrict__ s1,
                 const float* __restrict__ o1, const float* __restrict__ b2,
                 const float* __restrict__ s2, const float* __restrict__ o2,
                 const float* __restrict__ bs, const float* __restrict__ ss,
                 const float* __restrict__ os, bf16* __restrict__ out, const Plan p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (shared_address(smem_raw) & 1023)) & 1023);
  const uint32_t xs = shared_address(base);  // x ring: [nk1][XPIX][16]
  const uint32_t hs = xs + p.h_off;          // h1 ring: [nk2][HPIX][16]
  const uint32_t wsm = xs + p.w_off;         // weight stages, CHUNK_BYTES each
  const bool resident = p.stages == 0;
  const int nstage = resident ? p.per_step : p.stages;
  // full[nstage], empty[nstage] (ring only), x_full[3], x_empty[3]
  const uint32_t wfull = xs + p.bar_off, wempty = wfull + 8 * nstage,
                 xfull = wempty + 8 * nstage, xempty = xfull + 24;
  // per-channel affines: conv1 (b1, s1, o1), conv2 (b2, s2, o2), skip (bs, ss, os)
  float4* prm1 = reinterpret_cast<float4*>(base + p.prm_off);
  float4* prm2 = prm1 + p.C_mid;
  float4* prms = prm2 + p.C_out;

  const int t0 = blockIdx.x * TM, f0 = blockIdx.y * p.seg_rows, b = blockIdx.z;
  const int steps = (p.F - f0 < p.seg_rows ? p.F - f0 : p.seg_rows) / 2;
  // the warp's index as a value ptxas knows to be the same on all its lanes
  // (else it cannot tell that the roles' branches, and the products in
  // them, do not diverge, and serializes the products)
  const int tid = threadIdx.x, warp = __shfl_sync(0xffffffffu, tid / 32, 0), lane = tid % 32;

  if (tid == 0) {
    for (int s = 0; s < nstage; ++s) {
      mbar_init(wfull + 8 * s, 1);
      mbar_init(wempty + 8 * s, 8);
    }
    for (int s = 0; s < 3; ++s) {
      mbar_init(xfull + 8 * s, kLoaders);
      mbar_init(xempty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int c = tid; c < p.C_mid + 2 * p.C_out; c += kThreads) {
    if (c < p.C_mid) {
      prm1[c] = make_float4(b1[c], s1[c], o1[c], 0.0f);
    } else if (c < p.C_mid + p.C_out) {
      const int k = c - p.C_mid;
      prm2[k] = make_float4(b2[k], s2[k], o2[k], 0.0f);
    } else if (p.skip) {
      const int k = c - p.C_mid - p.C_out;
      prms[k] = make_float4(bs[k], ss[k], os[k], 0.0f);
    }
  }
  // the h1 ring's last two columns of each row (read only for dropped outputs)
  for (int e = tid; e < p.nk2 * HROWS * (W - 64) * 2; e += kThreads) {
    const int half = e % 2, q = e / 2, kc = q / (HROWS * (W - 64)), r = q % (HROWS * (W - 64));
    *reinterpret_cast<uint4*>(base + p.h_off + kc * HPIX * PIX_BYTES +
                              swizzled_bytes((r / (W - 64)) * W + 64 + r % (W - 64), half)) =
        make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // the weight warp: one thread's bulk copies
    if (lane == 0) {
      const auto issue = [&](int c, int s) {
        const uint32_t bar = wfull + 8 * s,
                       bytes = chunk_row(c, 0, 0, p, nullptr, nullptr, nullptr).rows * PIX_BYTES;
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                     "r"(bytes)
                     : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
            "[%3];\n" ::"r"(wsm + (uint32_t)s * CHUNK_BYTES),
            "l"(packed + (size_t)c * CHUNK_BYTES), "r"(bytes), "r"(bar)
            : "memory");
      };
      if (resident) {
        for (int c = 0; c < p.per_step; ++c) issue(c, c);
      } else {
        const int first = p.g1 * p.nk1, total = first + steps * p.per_step;
        for (int n = 0; n < total; ++n) {
          const int s = n % p.stages;
          if (n >= p.stages) mbar_wait(wempty + 8 * s, (n / p.stages - 1) & 1);
          issue(n < first ? n : (n - first) % p.per_step, s);
        }
      }
    }
    return;
  }
  if (warp > kConsumers / 32) {  // the x loaders: row pairs 0 .. steps + 1
    const int lt = tid - kConsumers - 32;
    const size_t plane = (size_t)p.F * p.T;
    for (int pr = 0; pr < steps + 2; ++pr) {
      const int slot = pr % 3;
      if (pr >= 3) mbar_wait(xempty + 8 * slot, (pr / 3 - 1) & 1);
      for (int e = lt; e < p.nk1 * 2 * W; e += kLoaders) {
        const int kc = e / (2 * W), r = (e / W) % 2, px = e % W;
        const int gr = f0 - 2 + 2 * pr + r, gt = t0 - 2 + px;
        uint32_t pk[CK / 2] = {};  // channel pairs, the lower channel in the low half
        if (gr >= 0 && gr < p.F && gt >= 0 && gt < p.T) {
          const unsigned short* src = reinterpret_cast<const unsigned short*>(x) +
                                      (((size_t)b * p.C_in + kc * CK) * p.F + gr) * p.T + gt;
          unsigned short v[CK];
#pragma unroll
          for (int ch = 0; ch < CK; ++ch) v[ch] = __ldg(src + ch * plane);
#pragma unroll
          for (int q = 0; q < CK / 2; ++q) pk[q] = v[2 * q] | (uint32_t)v[2 * q + 1] << 16;
        }
        unsigned char* dst = base + kc * XPIX * PIX_BYTES;
        const int pix = (2 * slot + r) * W + px;
        *reinterpret_cast<uint4*>(dst + swizzled_bytes(pix, 0)) =
            make_uint4(pk[0], pk[1], pk[2], pk[3]);
        *reinterpret_cast<uint4*>(dst + swizzled_bytes(pix, 1)) =
            make_uint4(pk[4], pk[5], pk[6], pk[7]);
      }
      mbar_arrive(xfull + 8 * slot);
    }
    return;
  }

  // The consumers. Warpgroup wg takes columns wg * 32 .. + 31 of both rows
  // of a step: warp wq of it columns cb .. cb + 7, its 16 M rows (row 0 of
  // the pair at rows 0-7, row 1 at rows 8-15). This lane addresses M row mr
  // for ldmatrix; its accumulators hold column cb + g of both rows,
  // channels 8 j + 2 q, + 1 of the group (j = 0 .. 7).
  const int wg = warp / 4, cb = wg * 32 + (warp % 4) * 8;
  const int mr = lane % 16, jr = mr / 8, mc = cb + mr % 8, half = lane / 16;
  const int g = lane / 4, q = lane % 4;
  const int col = cb + g;                    // this thread's output (and h1) column
  const bool act1 = t0 - 1 + wg * 32 < p.T;  // some h1 column of the warpgroup is inside
  const bool act2 = t0 + wg * 32 < p.T;      // some output column is
  int n_chunk = 0;                           // weight chunks consumed

  const auto acquire = [&](int c) -> uint32_t {
    const int s = resident ? c : n_chunk % p.stages;
    mbar_wait(wfull + 8 * s, resident ? 0 : (n_chunk / p.stages) & 1);
    return wsm + (uint32_t)s * CHUNK_BYTES;
  };
  const auto release = [&]() {
    if (!resident && lane == 0) mbar_arrive(wempty + 8 * (n_chunk % p.stages));
    ++n_chunk;
  };
  // the lane's A pixel of each tap, in a ring of `rows` rows whose local
  // row r is in slot r % rows, for the pair of rows from local row0 + jr
  const auto tap_pixels = [&](int (&px)[9], int row0, int rows) {
#pragma unroll
    for (int df = 0; df < 3; ++df)
#pragma unroll
      for (int dt = 0; dt < 3; ++dt) px[3 * df + dt] = ((row0 + jr + df) % rows) * W + mc + dt;
  };

  // conv1 -> h1 local rows hb, hb + 1 (global f0 - 1 + hb ..) from x local
  // rows hb .. hb + 3. `order`: wait at the named barrier 1 before the
  // first write (the other warpgroup is done reading the rows replaced).
  const auto conv1 = [&](int hb, bool order) {
    int px[9];
    tap_pixels(px, hb, XROWS);
    for (int ng = 0; ng < p.g1; ++ng) {
      float acc[32];
      zero(acc);
      for (int kc = 0; kc < p.nk1; ++kc) {
        mma_chunk(acc, xs + kc * XPIX * PIX_BYTES, 0, px, 9, acquire(ng * p.nk1 + kc), half,
                  act1);
        release();
      }
      if (order && ng == 0) asm volatile("bar.sync 1, 256;\n" ::: "memory");
      // this thread's channels ng * 64 + 8 j + 2 q, + 1: in 16-channel
      // chunk ng * 4 + j / 2, half j % 2, at byte 4 q of it
      const float4* prm = prm1 + ng * NW + 2 * q;
      const int nvalid = p.C_mid - ng * NW;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int hr = hb + h, gr = f0 - 1 + hr, gt = t0 - 1 + col;
        const bool inside = gr >= 0 && gr < p.F && gt >= 0 && gt < p.T;
        const int hpx = (hr % HROWS) * W + col;
        unsigned char* at = base + p.h_off + ng * 4 * HPIX * PIX_BYTES + hpx * PIX_BYTES + 4 * q;
        const int sw = (hpx >> 2) & 1;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 c0 = prm[8 * j], c1 = prm[8 * j + 1];
          float v0 = fmaxf(bn_affine(acc[4 * j + 2 * h], c0.x, c0.y, c0.z), 0.0f);
          float v1 = fmaxf(bn_affine(acc[4 * j + 2 * h + 1], c1.x, c1.y, c1.z), 0.0f);
          settle(v0, v1);
          if (8 * j < nvalid)
            *reinterpret_cast<__nv_bfloat162*>(at + (j / 2) * HPIX * PIX_BYTES +
                                               (((j & 1) ^ sw) << 4)) =
                __floats2bfloat162_rn(inside ? v0 : 0.0f, inside ? v1 : 0.0f);
        }
      }
    }
  };

  // the segment's top h1 rows, from x row pairs 0 and 1
  mbar_wait(xfull, 0);
  mbar_wait(xfull + 8, 0);
  conv1(0, false);
  __syncwarp();
  if (lane == 0) mbar_arrive(xempty);

  for (int i = 0; i < steps; ++i) {
    const int pr = i + 2;  // the row pair conv1 needs next (pair i + 1 is in)
    mbar_wait(xfull + 8 * (pr % 3), (pr / 3) & 1);
    conv1(2 + 2 * i, true);
    asm volatile("bar.sync 2, 256;\n" ::: "memory");  // both warpgroups' h1 rows written

    // output local rows ob, ob + 1 (global f0 + ob ..): h1 local rows
    // ob .. ob + 3, x local rows ob + 2, ob + 3 (row pair i + 1)
    const int ob = 2 * i;
    int px[9];
    tap_pixels(px, ob, HROWS);
    const int spx = ((ob + jr + 2) % XROWS) * W + mc + 2;  // the skip's, in every input chunk
    const int skip_px[9] = {spx, spx, spx, spx, spx, spx, spx, spx, spx};
    const int gt = t0 + col;
    const bool store = col < TM && gt < p.T;
    for (int ng = 0; ng < p.g2; ++ng) {
      const int c0 = p.g1 * p.nk1 + ng * (p.ns + p.nk2);  // the group's first chunk
      uint32_t skp[16];  // bf16(skip + bs) of both rows, channel pairs
      if (p.skip) {
        float acc[32];
        zero(acc);
        for (int j = 0; j < p.ns; ++j) {
          const int kcs = p.nk1 - j * 9 < 9 ? p.nk1 - j * 9 : 9;
          mma_chunk(acc, xs + j * 9 * XPIX * PIX_BYTES, XPIX * PIX_BYTES, skip_px, kcs,
                    acquire(c0 + j), half, act2);
          release();
        }
        const float4* prm = prms + ng * NW + 2 * q;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const __nv_bfloat162 v =
                __floats2bfloat162_rn(__fadd_rn(acc[4 * j + 2 * h], prm[8 * j].x),
                                      __fadd_rn(acc[4 * j + 2 * h + 1], prm[8 * j + 1].x));
            skp[2 * j + h] = *reinterpret_cast<const uint32_t*>(&v);
          }
      }
      float acc[32];
      zero(acc);
      for (int kc = 0; kc < p.nk2; ++kc) {
        mma_chunk(acc, hs + kc * HPIX * PIX_BYTES, 0, px, 9, acquire(c0 + p.ns + kc), half,
                  act2);
        release();
      }
      // h2 + skip, ReLU, bf16 [and the pool's max], stored along T: every
      // value first (accumulators are read outside any branch of this
      // thread's own), then the stores of the columns inside the strip and
      // the tensor. Channel 8 j + 2 q + e of the group is at a constant
      // offset from this thread's first one in every table and tile.
      const float4* pr2 = prm2 + ng * NW + 2 * q;
      const float4* prs = prms + ng * NW + 2 * q;
      const int nvalid = p.C_out - ng * NW;
      const int rows_out = p.pool ? p.F / 2 : p.F;
      const size_t plane = (size_t)rows_out * p.T;  // from one channel's output to the next
      bf16* o_at = out + ((size_t)b * p.C_out + ng * NW + 2 * q) * plane +
                   (size_t)(p.pool ? (f0 + ob) / 2 : f0 + ob) * p.T + gt;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float y[2][2];  // [channel 8 j + 2 q + e][row]
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float4 c2 = pr2[8 * j + e], cs = prs[8 * j + e];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float h2 = bn_affine(acc[4 * j + 2 * h + e], c2.x, c2.y, c2.z);
            float sk;
            if (p.skip) {
              const uint32_t pair = skp[2 * j + h];
              const float v = __bfloat162float(
                  __ushort_as_bfloat16((unsigned short)(e ? pair >> 16 : pair & 0xFFFF)));
              sk = __fadd_rn(__fmul_rn(v, cs.y), cs.z);
            } else {
              const int xpx = ((ob + h + 2) % XROWS) * W + col + 2;
              sk = __bfloat162float(*reinterpret_cast<const bf16*>(
                  base + (ng * 4 + j / 2) * XPIX * PIX_BYTES + xpx * PIX_BYTES +
                  ((((j & 1) ^ (xpx >> 2)) & 1) << 4) + 4 * q + 2 * e));
            }
            y[e][h] = __bfloat162float(__float2bfloat16(fmaxf(__fadd_rn(h2, sk), 0.0f)));
          }
        }
        settle(y[0][0], y[0][1]);
        settle(y[1][0], y[1][1]);
        if (!store || 8 * j >= nvalid) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          bf16* at = o_at + (size_t)(8 * j + e) * plane;
          if (p.pool) {
            at[0] = __float2bfloat16(fmaxf(y[e][0], y[e][1]));
          } else {
            at[0] = __float2bfloat16(y[e][0]);
            at[p.T] = __float2bfloat16(y[e][1]);
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(xempty + 8 * ((i + 1) % 3));  // row pair i + 1 is done
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms;
}

// Output rows of a segment: enough segments that strips x B x segments fill
// the SMs (one block an SM), at least kMinSegmentRows rows (F if fewer), even.
int segment_rows(int B, int F, int T, int sms) {
  const long units = (long)((T + TM - 1) / TM) * B;
  const int nseg = units >= sms ? 1 : (int)(sms / units);
  int rows = (F + nseg - 1) / nseg;
  rows += rows & 1;
  if (rows < kMinSegmentRows) rows = kMinSegmentRows;
  return rows < F ? rows : F;
}

uint32_t round_up(size_t v, size_t to) { return (uint32_t)((v + to - 1) / to * to); }

// The launch's plan (from its channel counts and skip) and its shared
// memory; false if the rings and one stage do not fit.
bool make_plan(Plan& p, size_t& smem) {
  p.g1 = (p.C_mid + NW - 1) / NW;
  p.g2 = (p.C_out + NW - 1) / NW;
  p.nk1 = p.C_in / CK;
  p.nk2 = p.C_mid / CK;
  p.ns = p.skip ? (p.nk1 + 8) / 9 : 0;
  p.per_step = p.g1 * p.nk1 + p.g2 * (p.ns + p.nk2);
  p.h_off = round_up((size_t)XPIX * PIX_BYTES * p.nk1, 1024);
  p.prm_off = p.h_off + round_up((size_t)HPIX * PIX_BYTES * p.nk2, 1024);
  p.w_off = p.prm_off + round_up(sizeof(float4) * (p.C_mid + 2 * p.C_out), 1024);
  const size_t fixed = 1024 + p.w_off + 8 * 6;  // alignment slack, x barriers
  const size_t stage = CHUNK_BYTES + 16;        // and a stage's two barriers
  if (fixed + p.per_step * stage <= (size_t)kSmemLimit) {
    p.stages = 0;
    p.bar_off = p.w_off + p.per_step * CHUNK_BYTES;
    smem = fixed + p.per_step * stage;
    return true;
  }
  if (fixed + stage > (size_t)kSmemLimit) return false;
  const size_t fit = ((size_t)kSmemLimit - fixed) / stage;
  p.stages = fit < (size_t)kMaxStages ? (int)fit : kMaxStages;
  p.bar_off = p.w_off + p.stages * CHUNK_BYTES;
  smem = fixed + p.stages * stage;
  return true;
}

}  // namespace

extern "C" {

// Output rows of a segment of K6's walk at (B, F, T) on the current device.
int res_block_segment_rows(int B, int F, int T) { return segment_rows(B, F, T, sm_count()); }

// Bytes of the scratch res_block_forward packs the weights into (every
// weight chunk of a step, as a stage holds it), or -1 where the kernel's
// rings and one stage do not fit in shared memory.
long long res_block_scratch_bytes(int C_in, int C_mid, int C_out, int skip) {
  Plan p{};
  p.C_in = C_in, p.C_mid = C_mid, p.C_out = C_out, p.skip = skip;
  size_t smem = 0;
  if (C_in <= 0 || C_mid <= 0 || C_out <= 0 || C_in % CK || C_mid % CK || C_out % CK ||
      !make_plan(p, smem))
    return -1;
  return (long long)p.per_step * CHUNK_BYTES;
}

// K6 on `stream`; ws, bs, ss, os null for the identity skip (C_in == C_out).
// `scratch`: res_block_scratch_bytes of device memory, which a first kernel
// fills with the packed weights. Returns 0 or a cudaError_t code.
int res_block_forward(const void* x, const void* w1, const void* b1, const void* s1,
                      const void* o1, const void* w2, const void* b2, const void* s2,
                      const void* o2, const void* ws, const void* bs, const void* ss,
                      const void* os, void* out, int B, int C_in, int C_mid, int C_out, int F,
                      int T, int pool, void* scratch, void* stream) {
  const bool skip = ws != nullptr;
  if (B <= 0 || C_in <= 0 || C_mid <= 0 || C_out <= 0 || F <= 0 || T <= 0 || C_in % CK ||
      C_mid % CK || C_out % CK || F % 2 || (pool && F % 4) || B > 65535 || scratch == nullptr ||
      (!skip && C_in != C_out) || (skip && (bs == nullptr || ss == nullptr || os == nullptr)))
    return cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  Plan p{};
  p.C_in = C_in, p.C_mid = C_mid, p.C_out = C_out, p.F = F, p.T = T, p.pool = pool;
  p.skip = skip;
  p.seg_rows = segment_rows(B, F, T, sms);
  size_t smem = 0;
  if (!make_plan(p, smem) || (F + p.seg_rows - 1) / p.seg_rows > 65535)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(res_block_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned char* packed = static_cast<unsigned char*>(scratch);
  pack_weights_kernel<<<p.per_step, 256, 0, st>>>(static_cast<const bf16*>(w1),
                                                  static_cast<const bf16*>(w2),
                                                  static_cast<const bf16*>(ws), packed, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 grid((T + TM - 1) / TM, (F + p.seg_rows - 1) / p.seg_rows, B);
  res_block_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const bf16*>(x), packed, static_cast<const float*>(b1),
      static_cast<const float*>(s1), static_cast<const float*>(o1), static_cast<const float*>(b2),
      static_cast<const float*>(s2), static_cast<const float*>(o2), static_cast<const float*>(bs),
      static_cast<const float*>(ss), static_cast<const float*>(os), static_cast<bf16*>(out), p);
  return cudaGetLastError();
}

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
