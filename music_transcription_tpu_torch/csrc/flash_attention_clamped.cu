// Clamped flash attention on the H100: K3 (forward, optionally with the per-row
// logsumexp) and its backward, K4a (dQ) and K4b (dK, dV). bf16 in / bf16 out,
// or fp32 in / fp32 out (compute_dtype="float32").
//
// Replaces music_transcription_tpu/ops/attention_pallas.py:
//   K3   flash_attention_clamped -> _fwd_call -> _flash_kernel (with_lse or not)
//   K4a  _flash_bwd -> _bwd_dq_kernel
//   K4b  _flash_bwd -> _bwd_dkv_kernel
//
//   q, k, v, o, dO, dQ, dK, dV  (B, T, NH, D), contiguous
//   lse, delta                  (B, NH, T) fp32, one value per row
//   o[b, t, h] = softmax_s( clip(q[b,t,h] . k[b,s,h] * scale, -clip, +clip) ) @ v[b,:,h]
//   lse[b, h, t] = m + log(l), the logsumexp of that row's clamped scores
//
// The backward recomputes each score tile (FlashAttention-2), as the Pallas
// kernels do (_recompute_p_ds):
//   z = q k^T * scale (fp32), p = exp(clip(z) - lse), 0 at keys >= T,
//   delta = rowsum(dO * o) (fp32, from the stored o), dP = dO v^T (fp32),
//   dS = p * (dP - delta) * 1{-clip <= z <= clip} * scale   (gate on the PRE-clip z),
//   dQ = dS K (K4a), dK = dS^T Q and dV = P^T dO (K4b), with dS and p cast to
//   the input dtype before the products and fp32 accumulation.
// K4a walks the key tiles for one tile of query rows; K4b walks the query
// tiles for one tile of key rows. Neither uses atomics, so the gradients are
// the same bits from run to run.
//
// What bounds them on the H100: operations. At the training shape (B*NH=192,
// T=938, D=192) the forward does 4*B*NH*T^2*D = 0.130 TFLOP (0.131 ms at the
// 989 TFLOP/s bf16 tensor-core rate), K4a 6*B*NH*T^2*D (three products,
// 0.197 ms), K4b 8*B*NH*T^2*D (four products, 0.262 ms), against some
// 0.07-0.42 GB of q, k, v, o, dO, lse and gradients (0.12 ms at 3.35 TB/s
// for K4a). So the products run on the tensor cores and no (T x T) tile
// ever reaches device memory.
//
// Design of the bf16 K3, K4a and K4b (Hopper): warp-specialised blocks of
// two consumer warpgroups and one producer warpgroup (384 threads).
//   * The producer warpgroup streams tiles into a ring of shared-memory stages
//     with cp.async 16-byte copies, written in the 128-byte-swizzled layout
//     (rows of 64 bf16, the 16-byte group g of row r at g ^ (r % 8); head_dim
//     in chunks of 64 columns) that wgmma's shared-memory descriptors read.
//     Each stage has a "full" mbarrier (the producer threads arrive once their
//     copies have landed: cp.async.mbarrier.arrive) and an "empty" one (each
//     consumer warp arrives once its products have read the stage). Rows
//     past T and columns past D are zero-filled. Rows that are not 16-byte
//     aligned (D % 8 != 0) take plain loads and stores into the same layout.
//     (TMA would need 16-byte row strides, which D = 18 does not have.)
//   * Every product is wgmma m64n64k16 (bf16 in, fp32 accumulate): the score
//     products with both operands in shared memory (K-major), the
//     accumulating products with the bf16 probabilities (or dS) in registers
//     as the A operand -- the score accumulator's fragment layout is the A
//     operand's, so no shuffle -- and the second operand in shared memory,
//     MN-major (its rows are the product's K dimension).
//   * K3: block = (batch*head, 128 query rows), 64 rows a warpgroup; key
//     tiles of 64. The clamp, the key mask, the running max and sum and the
//     rescale of O stay in registers (row statistics by quad shuffles); O
//     (64 x D fp32 a warpgroup, 96 registers a thread at D=192) never leaves
//     them. No block-wide barrier in the key loop.
//   * K4a: block = (batch*head, 64 query rows); the producer loads q and dO
//     once and streams k and v tiles of 64 keys. Warpgroup 0 computes
//     S = Q K^T and the gated p (lse of its rows read once into registers;
//     exp by __expf); warpgroup 1 dP = dO V^T, dS and dQ += dS K, the same
//     stage's k tile read MN-major. Query rows fall on the M dimension, so dQ
//     (96 registers a thread at D=192) never leaves warpgroup 1's registers;
//     p crosses as in K4b. Warpgroup 1 computes delta of its rows from o
//     before the loop, while the ring fills (four lanes a row, every 16-byte
//     load issued before the first multiply): o is read once.
//   * K4b: block = (batch*head, 64 key rows); the producer loads k and v once
//     and streams q, dO, lse and delta tiles of 64 query rows. Warpgroup 0
//     computes S^T = K Q^T, p and dV += P^T dO; warpgroup 1 dP^T = V dO^T,
//     dS and dK += dS^T Q. Key rows fall on the M dimension, so both
//     accumulators stay in registers; the gated fp32 p goes from warpgroup 0
//     to warpgroup 1 through a 16 KB shared tile (two named barriers).
//     delta comes from a pre-pass kernel (one warp per row) launched by the
//     same entry, instead of re-reading o for every query tile.
//   head_dim is padded to 64, 128, 192 or 256 (a template parameter), and
//   the ring holds as many stages (up to 4) as the 227 KB of shared memory
//   a block may have allow. At D=192 K3 takes 197,688 bytes (q 48 KB, 3
//   stages of k and v, 48 KB each), K4a 214,072 (q and dO 48 KB, 3 stages of
//   k and v, the p tile), K4b 215,608 (k and v 48 KB, 3 stages of q and dO,
//   the p tile); at D=256 K4a's ring has 2 stages. At D=192 ptxas gives all
//   three 168 registers a thread, the most 384 threads allow, with no
//   spills (fewer at smaller D); at D=256 (128 accumulator registers) they
//   spill some 0.3-0.6 KB a thread.
//
// fp32 inputs: the tensor cores take no full-fp32 operands, so every product
// is an fp32 FMA on the CUDA cores (67 TFLOP/s at most; no TF32).
//   * K3-fp32 (with and without lse), K4a-fp32 and K4b-fp32 are register-
//     tiled, in blocks of 4 warps, two blocks an SM (at most 113 KB of
//     shared memory each, up to 255 registers a thread). A thread holds an 8 x 4
//     block of the 64-column score tile and 8 rows x DP / 16 columns of the
//     accumulator (O in K3; dQ in K4a; dV or dK in K4b), reads its operands
//     from shared memory as 16-byte vectors (128 FMAs for every 12 vectors in
//     the score product, 96 for every 5 in the accumulating one) and combines
//     row statistics by shuffles over the 16 lanes of a row. p (and dS)
//     cross from the score layout to the accumulating one through a padded
//     [64][16] tile a warp. head_dim is padded to 64, 128, 192 or 256 (a
//     template parameter), columns past D zero-filled.
//   * A cp.async ring (16-byte copies; plain loads and stores when D % 4 !=
//     0) streams each tile in chunks, one __syncthreads a chunk: the next
//     chunks are in flight during the products on this one. K3: block =
//     (batch*head, 64 query rows), q loaded once; a key tile of 64 comes as
//     DP / 32 chunks of k (64 keys x 32 columns) for S, then 8 chunks of v
//     (8 keys x DP) for P v, with the online softmax between them. K4a:
//     block = (batch*head, 32 query rows), q and dO loaded once, the rows'
//     lse and delta (from o, before the loop) in their padding; warps 0-1
//     compute S, warps 2-3 dP; a key tile of 64 comes as DP / 32 chunks
//     (DP / 16 at DP = 256) of k and v for the score products, then chunks
//     of 16 keys (8 at DP = 256) of k for dQ += dS K. The keys fall in runs
//     of 8 (4) that alternate between the warp pairs: each pair forms p and
//     dS of its own keys (the two cross z - lse and dP - delta through a
//     shared tile, each taking half the exponentials) and a partial dQ, and
//     warps 0-1 add the two at the end. K4b: block = (batch*head, 32 key
//     rows), k and v loaded once; warps 0-1 compute S^T, p and dV, warps 2-3
//     dP^T, dS and dK; a query tile of 64 comes as DP / 16 chunks of q and
//     dO (the last with the tile's lse and delta) for the score products,
//     then chunks of 8 rows (4 at DP = 256) of q and dO for the accumulating
//     ones; the gated p crosses from warps 0-1 to 2-3 through a shared tile,
//     which warps 2-3 overwrite with dS. K4b's delta comes from the same
//     pre-pass kernel as in bf16, launched by the entry.
//     At D=192 K3-fp32 takes 107,520 bytes (4 stages) and 255 registers,
//     K4a-fp32 115,712 (3 stages) and 255, K4b-fp32 108,288 (3 stages) and
//     247, with no spills; at D=256 all three spill (148, 60 and 28 bytes a
//     thread).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

#include "warpgroup.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr int BQ = 64, BK = 64;
constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kMaxD = 256;
constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may have
constexpr float kNegInf = -1e9f;

__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }

// sum_d dO[d] * o[d] in fp32 over one row of D (bf16 or fp32), by the 32
// lanes of a warp (lane-strided, then a butterfly): K4b's delta pre-pass.
template <typename E>
__device__ __forceinline__ float warp_row_dot(const E* dos, const E* __restrict__ orow, int D,
                                              int lane) {
  float acc = 0.0f;
  for (int d = lane; d < D; d += 32) acc += to_f32(dos[d]) * to_f32(orow[d]);
#pragma unroll
  for (int off = 16; off; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

// ---------------------------------------------------------------------------
// Hopper building blocks of the bf16 K3 and K4b: 128-byte-swizzled tiles,
// wgmma, mbarriers (the generic ones in warpgroup.cuh)
// ---------------------------------------------------------------------------

constexpr int kConsumers = 256;                   // two consumer warpgroups
constexpr int kProducers = 128;                   // the producer warpgroup
constexpr int kWsThreads = kConsumers + kProducers;
constexpr int kChunk = 64;            // bf16 columns of a swizzled row (128 bytes)
constexpr int kRowBytes = 128;

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma's shared-memory matrix descriptor of a 128-byte-swizzled tile: rows
// of 128 bytes, 8-row groups 1024 bytes apart (the stride byte offset).
// `lbo`: the leading byte offset (K-major: unused; MN-major: the distance
// between 64-column chunks).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(1024 >> 4) << 32 | 1ull << 62;
}

// d (64 x 64 fp32, accumulator layout) += a (64 x 16) . b (64 x 16)^T, both
// K-major tiles in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WGMMA_ACC32(d)
      : "l"(a), "l"(b), "r"(1));
}

// d += a (64 x 16 bf16, in registers in the accumulator's fragment layout)
// . b (16 x 64), b an MN-major tile in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WGMMA_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The A fragments of four k16 steps from a 64 x 64 accumulator: wgmma's A
// layout in registers is its accumulator layout (two bf16 a register).
__device__ __forceinline__ void to_a_fragments(uint32_t (&a)[4][4], const float (&d)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 x = __floats2bfloat162_rn(d[8 * kk + 2 * j], d[8 * kk + 2 * j + 1]);
      a[kk][j] = *reinterpret_cast<const uint32_t*>(&x);
    }
}

// Rows [t0, t0 + ROWS) of one head (row t at src + t * stride elements) into
// the 128-byte-swizzled tile at shared address dst: DP / 64 chunks, each of
// ROWS rows of 64 bf16, the 16-byte group g of row r stored at group
// g ^ (r % 8) (the layout of a TMA load with a 128-byte swizzle). Zeros at
// rows >= T and columns >= D. By the producer warpgroup's threads (pt =
// 0..127): cp.async when `vec` (D % 8 == 0, 16-byte aligned rows), else
// plain loads and stores. In the cp.async loop a thread copies group pt % 8
// of rows pt / 8 + 16 p of every chunk, whose swizzled place is the same in
// every pass p: one add a copy for each address.
template <int DP, int ROWS>
__device__ __forceinline__ void load_sw128(uint32_t dst, const bf16* __restrict__ src,
                                           size_t stride, int t0, int T, int D, bool vec,
                                           int pt) {
  if (vec) {
    constexpr int kPass = kProducers / 8;  // rows a pass
    const int r0 = pt / 8, g8 = pt % 8;
    const uint32_t to = dst + r0 * kRowBytes + ((g8 ^ (r0 & 7)) << 4);
    const bf16* from = src + (size_t)(t0 + r0) * stride + g8 * 8;
#pragma unroll
    for (int c = 0; c < DP / kChunk; ++c) {
      const bool col_ok = c * kChunk + g8 * 8 < D;
#pragma unroll
      for (int p = 0; p < ROWS / kPass; ++p) {
        const bool ok = col_ok && t0 + r0 + p * kPass < T;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                         to + (c * ROWS + p * kPass) * kRowBytes),
                     "l"(ok ? from + (size_t)p * kPass * stride + c * kChunk : src),
                     "r"(ok ? 16 : 0)
                     : "memory");
      }
    }
  } else {
    for (int e = pt; e < ROWS * DP; e += kProducers) {
      const int r = e / DP, c = e % DP;
      unsigned short val = 0;
      if (t0 + r < T && c < D) val = __bfloat16_as_ushort(src[(size_t)(t0 + r) * stride + c]);
      const uint32_t to = dst + (c >> 6) * ROWS * kRowBytes + r * kRowBytes +
                          ((((c >> 3) & 7) ^ (r & 7)) << 4) + (c & 7) * 2;
      asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(to), "h"(val) : "memory");
    }
  }
}

// n fp32 values src[t0 + r] (0 at t0 + r >= T) into shared memory at dst, by
// the producer warpgroup's threads, as load_sw128 does.
__device__ __forceinline__ void load_row_values(uint32_t dst, const float* __restrict__ src,
                                                int t0, int n, int T, bool vec, int pt) {
  for (int r = pt; r < n; r += kProducers) {
    const bool ok = t0 + r < T;
    if (vec) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst + 4 * r),
                   "l"(ok ? src + t0 + r : src), "r"(ok ? 4 : 0)
                   : "memory");
    } else {
      asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(dst + 4 * r), "f"(ok ? src[t0 + r] : 0.0f)
                   : "memory");
    }
  }
}

// The producer thread's share of a stage is issued: one arrival on `bar` once
// its copies have landed (cp.async), or now (plain stores, made visible to
// wgmma's reads first).
__device__ __forceinline__ void stage_issued(uint32_t bar, bool vec) {
  if (vec) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
  } else {
    fence_proxy_async();
    mbar_arrive(bar);
  }
}

// The barriers of a producer / consumer ring: one for the tiles loaded once
// (q in K3, k and v in K4b), then full[S] and empty[S]. The producer threads
// arrive on the first two, the 8 consumer warps on empty.
__device__ __forceinline__ void init_ring(uint32_t bars, int stages) {
  if (threadIdx.x == 0) {
    mbar_init(bars, kProducers);
    for (int s = 0; s < stages; ++s) {
      mbar_init(bars + 8 * (1 + s), kProducers);
      mbar_init(bars + 8 * (1 + stages + s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// Named barrier `id` of N threads (the two consumer warpgroups by default).
template <int N = kConsumers>
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(N) : "memory");
}
template <int N = kConsumers>
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(N) : "memory");
}

// o's or a gradient's values of one row, cols c * 64 + 8 j + 2 quad (+1), from
// a warpgroup accumulator (row half `half` of the thread's two rows), as bf16.
template <int NC>
__device__ __forceinline__ void store_row(bf16* __restrict__ out, const float (&acc)[NC][32],
                                          int half, float div, int quad, int D, bool vec) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c * kChunk + 8 * j + 2 * quad;
      const float x0 = acc[c][4 * j + 2 * half] / div, x1 = acc[c][4 * j + 2 * half + 1] / div;
      if (vec) {
        if (col < D) *reinterpret_cast<__nv_bfloat162*>(out + col) = __floats2bfloat162_rn(x0, x1);
      } else {
        if (col < D) out[col] = __float2bfloat16(x0);
        if (col + 1 < D) out[col + 1] = __float2bfloat16(x1);
      }
    }
}

// ---------------------------------------------------------------------------
// K3, bf16
// ---------------------------------------------------------------------------

constexpr int kFwdRows = 128;  // query rows a block, 64 a consumer warpgroup

template <int DP>
struct FwdTiles {
  static constexpr int kQ = kFwdRows * DP * 2;  // bytes of the q tile
  static constexpr int kKV = BK * DP * 2;       // bytes of one k or v tile
  // stages that fit beside q, the 1024 bytes of alignment slack and the barriers
  static constexpr int kFit = (kSmemLimit - 1024 - kQ - 128) / (2 * kKV);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr size_t kSmem = 1024 + kQ + 2 * (size_t)kKV * kStages + 8 * (1 + 2 * kStages);
};

template <int DP, bool kLse>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                 int T, int NH, int D, float scale, float clip, int vec) {
  using L = FwdTiles<DP>;
  constexpr int S = L::kStages, NC = DP / kChunk;
  extern __shared__ __align__(1024) unsigned char smem_ws[];
  const uint32_t sq = (shared_address(smem_ws) + 1023) & ~1023u;  // [NC][128 rows][64]
  const uint32_t skv = sq + L::kQ;  // stage s: k tile at skv + 2 s kKV, v tile after it
  const uint32_t bars = skv + 2 * L::kKV * S;
  const int bh = blockIdx.y, b = bh / NH, h = bh % NH;
  const int q0 = blockIdx.x * kFwdRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nk = (T + BK - 1) / BK;
  const size_t head = ((size_t)b * T * NH + h) * D, stride = (size_t)NH * D;
  init_ring(bars, S);

  if (threadIdx.x >= kConsumers) {  // the producer warpgroup
    const int pt = threadIdx.x - kConsumers;
    load_sw128<DP, kFwdRows>(sq, q + head, stride, q0, T, D, vec, pt);
    stage_issued(bars, vec);
    for (int i = 0; i < nk; ++i) {
      const int s = i % S;
      if (i >= S) mbar_wait(bars + 8 * (1 + S + s), (i / S - 1) & 1);
      const uint32_t ks = skv + 2 * L::kKV * s;
      load_sw128<DP, BK>(ks, k + head, stride, i * BK, T, D, vec, pt);
      load_sw128<DP, BK>(ks + L::kKV, v + head, stride, i * BK, T, D, vec, pt);
      stage_issued(bars + 8 * (1 + s), vec);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // consumer warpgroup wg: query rows q0 + 64 wg + [0, 64); this thread's
  // rows `row` and `row` + 8 of them, columns 8 j + 2 quad (+1) of each
  // 64-column accumulator
  const int wg = warp / 4, row = 16 * (warp % 4) + lane / 4, quad = lane % 4;
  const uint32_t qa = sq + wg * 64 * kRowBytes;
  float oacc[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) oacc[c][e] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  mbar_wait(bars, 0);

  for (int i = 0; i < nk; ++i) {
    const int s = i % S;
    mbar_wait(bars + 8 * (1 + s), (i / S) & 1);
    fence_proxy_async();
    const uint32_t ks = skv + 2 * L::kKV * s, vs = ks + L::kKV;

    // S = q k^T for this warpgroup's 64 rows and the 64 keys of the tile
    float sacc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sacc[e] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk & 3) * 32;  // 16 columns of the chunk: 32 bytes
      wgmma_ss(sacc, sw128_desc(qa + (kk >> 2) * kFwdRows * kRowBytes + off, 16),
               sw128_desc(ks + (kk >> 2) * BK * kRowBytes + off, 16));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(sacc);

    // online softmax of the two rows over this key tile: clamp, then mask
    // keys >= T (only the last tile has any)
#pragma unroll
    for (int e = 0; e < 32; ++e) sacc[e] = fminf(fmaxf(sacc[e] * scale, -clip), clip);
    if ((i + 1) * BK > T) {
#pragma unroll
      for (int e = 0; e < 32; ++e)
        if (i * BK + 8 * (e / 4) + 2 * quad + (e & 1) >= T) sacc[e] = kNegInf;
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int e = 0; e < 32; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sacc[e]);
    float alpha[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_next = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_next);
      m[r] = m_next;
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const float p = expf(sacc[e] - m[(e >> 1) & 1]);
      sum[(e >> 1) & 1] += p;
      sacc[e] = p;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = alpha[r] * l[r] + sum[r];
    }
    uint32_t pa[4][4];  // p rounded to bf16, as the A operand of P v
    to_a_fragments(pa, sacc);

    // O = alpha O + P v; alpha is 1 (O * 1 == O) once a row's max stops moving
    if (__any_sync(0xffffffffu, alpha[0] != 1.0f || alpha[1] != 1.0f)) {
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 32; ++e) oacc[c][e] *= alpha[(e >> 1) & 1];
    }
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs(oacc[c], pa[kk],
                 sw128_desc(vs + c * BK * kRowBytes + kk * 16 * kRowBytes, BK * kRowBytes));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < NC; ++c) fence_acc(oacc[c]);
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (1 + S + s));  // this warp is done with the stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q0 + wg * 64 + row + 8 * r;
    if (t >= T) continue;
    const float div = l[r] == 0.0f ? 1.0f : l[r];
    store_row<NC>(o + head + (size_t)t * stride, oacc, r, div, quad, D, vec);
    if (kLse && quad == 0) lse[(size_t)bh * T + t] = m[r] + logf(div);
  }
}

// ---------------------------------------------------------------------------
// K3 and K4b, fp32 (CUDA cores): register-tiled products fed by a cp.async ring
// ---------------------------------------------------------------------------

// Blocks of 4 warps, two an SM (each under 113 KB of shared memory), so that
// a thread may hold 8 rows of a score tile and of an accumulator (up to 255
// registers). Lane (rg, kg) = (lane / 16, lane % 16) of warp w owns rows
// 16 w + rg + 2 i (i < 8) of the block's tiles (interleaved, so that the two
// half-warps read neighbouring rows, which lie in different banks), columns
// kg + 16 j (j < 4) of a 64-column score tile and columns 64 c + 4 kg .. + 3
// of each 64-column chunk of an accumulator. In a warp's [64][16] p tile the
// thread's rows are columns 8 rg .. 8 rg + 7.
constexpr int kF32Threads = 128;
constexpr int kF32Rows = 64;        // rows of a 4-warp tile, 16 a warp
constexpr int kF32Ri = 8;           // rows a thread
constexpr int kPL = 20;             // row stride of a warp's [64][16] p tile (16 rows + 4)
constexpr int kF32Stages = 6;       // the most stages a ring holds
constexpr int kF32Smem = 115712;    // bytes of shared memory a block, two an SM

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Until at most N of this thread's committed cp.async groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + ROWS) of one head (row t at src + t * stride), columns
// [c0, c0 + COLS), into a [ROWS][COLS + 4] fp32 shared tile at dst (the row
// padded by 4 words, so that 16-byte reads of rows 1 apart take distinct
// banks); zeros at rows >= T and columns >= D. By the block's kF32Threads
// threads: 16-byte cp.async copies when `vec` (D % 4 == 0, 16-byte aligned
// rows), else plain loads and stores.
template <int ROWS, int COLS>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* __restrict__ src,
                                              size_t stride, int r0, int c0, int T, int D,
                                              bool vec) {
  constexpr int G = COLS / 4, LD = COLS + 4, kN = ROWS * G;
  if (vec) {
    const uint32_t base = shared_address(dst);
#pragma unroll
    for (int p = 0; p < (kN + kF32Threads - 1) / kF32Threads; ++p) {
      const int e = threadIdx.x + p * kF32Threads;
      if (kN % kF32Threads != 0 && e >= kN) break;
      const int r = e / G, g = e % G, col = c0 + 4 * g;
      const bool ok = r0 + r < T && col < D;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       base + 4 * (r * LD + 4 * g)),
                   "l"(ok ? src + (size_t)(r0 + r) * stride + col : src), "r"(ok ? 16 : 0)
                   : "memory");
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * COLS; e += kF32Threads) {
      const int r = e / COLS, c = e % COLS;
      dst[r * LD + c] = r0 + r < T && c0 + c < D ? src[(size_t)(r0 + r) * stride + c0 + c] : 0.0f;
    }
  }
}

// acc[i][j] += sum_{d < N} a[2 i * LDA + d] * b[JS j * LDB + d]: the
// thread's 8 rows, 2 apart, of the resident tile (a at the first) against its
// 4 rows, JS apart, of a streamed chunk (b at the first), both read as 16-byte
// vectors: 128 FMAs for every 12 vectors. d runs in order, as in a plain dot
// product.
template <int N, int LDA, int LDB, int JS = 16>
__device__ __forceinline__ void score_product(float (&acc)[kF32Ri][4], const float* a,
                                              const float* b) {
#pragma unroll
  for (int d = 0; d < N; d += 4) {
    float4 bv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = *reinterpret_cast<const float4*>(b + JS * j * LDB + d);
#pragma unroll
    for (int i = 0; i < kF32Ri; ++i) {
      const float4 av = *reinterpret_cast<const float4*>(a + 2 * i * LDA + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(av.x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av.y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av.z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av.w, bv[j].w, acc[i][j]);
      }
    }
  }
}

// acc[i][4 c + e] += sum_{r < N} p[kPL r + i] * m[r * LDM + 64 c + e]: the
// thread's 8 rows of its warp's [.][kPL] p tile (p at its first value of
// step 0: two 16-byte vectors a step) times N streamed rows (m at row 0,
// column 4 kg), 4 columns of each 64-column chunk: 32 FMAs a vector of m.
template <int N, int NC, int LDM>
__device__ __forceinline__ void accumulate_product(float (&acc)[kF32Ri][4 * NC], const float* p,
                                                   const float* m) {
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const float4 p0 = *reinterpret_cast<const float4*>(p + kPL * r);
    const float4 p1 = *reinterpret_cast<const float4*>(p + kPL * r + 4);
    const float pr[kF32Ri] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float4 mv = *reinterpret_cast<const float4*>(m + r * LDM + 64 * c);
#pragma unroll
      for (int i = 0; i < kF32Ri; ++i) {
        acc[i][4 * c] = fmaf(pr[i], mv.x, acc[i][4 * c]);
        acc[i][4 * c + 1] = fmaf(pr[i], mv.y, acc[i][4 * c + 1]);
        acc[i][4 * c + 2] = fmaf(pr[i], mv.z, acc[i][4 * c + 2]);
        acc[i][4 * c + 3] = fmaf(pr[i], mv.w, acc[i][4 * c + 3]);
      }
    }
  }
}

// The thread's 4 x 4 values of column group j (vals[i][j], rows i) into its
// warp's p tile at pt (column r at pt + kPL r): two 16-byte stores a column.
__device__ __forceinline__ void store_p_columns(float* pt, const float (&vals)[kF32Ri][4], int kg) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float* at = pt + kPL * (kg + 16 * j);
    *reinterpret_cast<float4*>(at) = make_float4(vals[0][j], vals[1][j], vals[2][j], vals[3][j]);
    *reinterpret_cast<float4*>(at + 4) =
        make_float4(vals[4][j], vals[5][j], vals[6][j], vals[7][j]);
  }
}

// One accumulator row (columns 64 c + 4 kg + e) divided by div, into the
// global row at out; 16-byte stores when `vec`.
template <int NC>
__device__ __forceinline__ void store_row_f32(float* __restrict__ out, const float (&acc)[4 * NC],
                                              float div, int kg, int D, bool vec) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = 64 * c + 4 * kg;
    const float x[4] = {acc[4 * c] / div, acc[4 * c + 1] / div, acc[4 * c + 2] / div,
                        acc[4 * c + 3] / div};
    if (vec) {
      if (col < D) *reinterpret_cast<float4*>(out + col) = make_float4(x[0], x[1], x[2], x[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (col + e < D) out[col + e] = x[e];
    }
  }
}

// K3-fp32: block = (batch*head, 64 query rows). A key tile of 64 comes
// through the ring as DP / 32 chunks of k (64 keys x 32 columns: S += q k^T,
// the thread's 8 x 4 scores) and then 8 chunks of v (8 keys x DP: O += P v,
// the thread's 8 rows x DP / 16 columns); between them the online softmax of
// the tile (row statistics by shuffles over the 16 lanes of a row) and the
// probabilities into the warp's [64 keys][16 rows] shared tile.
template <int DP>
struct F32FwdTiles {
  static constexpr int kCW = 32, kRW = 8;   // columns of a k chunk, rows of a v chunk
  static constexpr int kQS = DP + 4;        // row stride of the q tile and the v chunks
  static constexpr int kQ = kF32Rows * kQS;                 // floats of the q tile
  static constexpr int kP = kF32Threads / 32 * BK * kPL;    // the warps' p tiles
  static constexpr int kK = BK * (kCW + 4), kV = kRW * kQS;
  static constexpr int kStage = kK > kV ? kK : kV;
  static constexpr int kFit = (kF32Smem / 4 - kQ - kP) / kStage;
  static constexpr int kStages = kFit < kF32Stages ? kFit : kF32Stages;
  static_assert(kStages >= 2, "K3-fp32's ring needs two stages");
  static constexpr int kChunks = DP / kCW, kSteps = kChunks + BK / kRW;  // stages a key tile
  static constexpr size_t kSmem = 4 * ((size_t)kQ + kP + (size_t)kStages * kStage);
};

template <int DP, bool kLse>
__global__ void __launch_bounds__(kF32Threads, 2)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                     int T, int NH, int D, float scale, float clip, int vec) {
  using L = F32FwdTiles<DP>;
  constexpr int S = L::kStages, NC = DP / 64, R = kF32Ri;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [64][kQS]
  float* ps = qs + L::kQ;                           // warp w's p tile at ps + 64 kPL w
  float* ring = ps + L::kP;                         // S stages of kStage floats
  const int bh = blockIdx.y, b = bh / NH, h = bh % NH;
  const int q0 = blockIdx.x * kF32Rows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = lane / 16, kg = lane % 16, row0 = 16 * warp + rg;
  const size_t head = ((size_t)b * T * NH + h) * D, stride = (size_t)NH * D;
  const int steps = (T + BK - 1) / BK * L::kSteps;

  // stage `it` of the walk into its slot, then one commit (empty past the end)
  auto issue = [&](int it) {
    if (it < steps) {
      float* st = ring + (it % S) * L::kStage;
      const int t0 = it / L::kSteps * BK, c = it % L::kSteps;
      if (c < L::kChunks)
        load_rows_f32<BK, L::kCW>(st, k + head, stride, t0, c * L::kCW, T, D, vec);
      else
        load_rows_f32<L::kRW, DP>(st, v + head, stride, t0 + (c - L::kChunks) * L::kRW, 0, T, D,
                                  vec);
    }
    cp_async_commit();
  };
  load_rows_f32<kF32Rows, DP>(qs, q + head, stride, q0, 0, T, D, vec);
  for (int s = 0; s + 1 < S; ++s) issue(s);  // q lands with stage 0

  float acc[R][4 * NC], sc[R][4], m[R], l[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int e = 0; e < 4 * NC; ++e) acc[i][e] = 0.0f;
    m[i] = kNegInf;
    l[i] = 0.0f;
  }
  float* pt = ps + BK * kPL * warp + R * rg;  // the thread's rows of its warp's p tile
  const float* qa = qs + row0 * L::kQS;

  for (int it = 0; it < steps; ++it) {
    cp_async_wait<S - 2>();
    __syncthreads();  // stage it has landed; every thread is done with stage it - 1's slot
    issue(it + S - 1);
    const float* st = ring + (it % S) * L::kStage;
    const int c = it % L::kSteps;
    if (c < L::kChunks) {
      if (c == 0) {
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
      }
      score_product<L::kCW, L::kQS, L::kCW + 4>(sc, qa + c * L::kCW, st + kg * (L::kCW + 4));
      if (c == L::kChunks - 1) {
        // online softmax of the rows over this key tile: clamp, then mask
        // keys >= T (only the last tile has any)
        const int t0 = it / L::kSteps * BK;
        float alpha[R];
        bool moved = false;
#pragma unroll
        for (int i = 0; i < R; ++i) {
          float mx = kNegInf;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float x = fminf(fmaxf(sc[i][j] * scale, -clip), clip);
            if (t0 + kg + 16 * j >= T) x = kNegInf;
            sc[i][j] = x;
            mx = fmaxf(mx, x);
          }
#pragma unroll
          for (int off = 8; off; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
          const float m_next = fmaxf(m[i], mx);
          alpha[i] = expf(m[i] - m_next);
          moved |= alpha[i] != 1.0f;
          m[i] = m_next;
          float sum = 0.0f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            sc[i][j] = expf(sc[i][j] - m_next);
            sum += sc[i][j];
          }
#pragma unroll
          for (int off = 8; off; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
          l[i] = alpha[i] * l[i] + sum;
        }
        // O = alpha O (+ P v below); alpha is 1 once a row's max stops moving
        if (__any_sync(0xffffffffu, moved)) {
#pragma unroll
          for (int i = 0; i < R; ++i)
#pragma unroll
            for (int e = 0; e < 4 * NC; ++e) acc[i][e] *= alpha[i];
        }
        store_p_columns(pt, sc, kg);
        __syncwarp();  // the rows' probabilities come from the 16 lanes of their half-warp
      }
    } else {
      accumulate_product<L::kRW, NC, L::kQS>(acc, pt + kPL * (c - L::kChunks) * L::kRW,
                                             st + 4 * kg);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int t = q0 + row0 + 2 * i;
    if (t >= T) continue;
    const float div = l[i] == 0.0f ? 1.0f : l[i];
    store_row_f32<NC>(o + head + (size_t)t * stride, acc[i], div, kg, D, vec);
    if (kLse && kg == 0) lse[(size_t)bh * T + t] = m[i] + logf(div);
  }
}

// K4b-fp32: block = (batch*head, 32 key rows), k and v loaded once. Warps 0
// and 1 (group 0) compute S^T = K Q^T, p and dV += P^T dO; warps 2 and 3
// (group 1) dP^T = V dO^T, dS and dK += dS^T Q. Warp 2 g + w owns key rows
// 16 w .. 16 w + 15, lane (rg, kg) keys 16 w + rg + 2 i and, of each query
// tile, queries kg + 16 j. A query tile of 64 comes through the ring as DP /
// 16 chunks of q and dO (64 rows x 16 columns each; the last with the tile's
// lse and delta) for the score products, then chunks of kRW rows x DP for
// the accumulating ones. Group 0 writes p into its warps' [64 queries][16
// keys] tiles and the gated p into the crossing tiles xs; after the next
// block barrier group 1 turns xs into dS in place.
template <int DP>
struct F32DkvTiles {
  static constexpr int kRows = kF32Rows / 2;  // key rows a block: 16 a warp of each group
  static constexpr int kCW = 16;              // columns of a score chunk
  static constexpr int kRW = DP > 192 ? 4 : 8;  // rows of an accumulating chunk
  static constexpr int kRS = DP + 4;          // row stride of k, v and the accumulating chunks
  static constexpr int kKV = kRows * kRS;     // floats of k or v
  static constexpr int kP = 2 * BQ * kPL;     // a group's p (or dS) tiles
  static constexpr int kStage1 = 2 * BQ * (kCW + 4) + 2 * BQ;  // q, dO chunks; lse, delta
  static constexpr int kStage2 = 2 * kRW * kRS;
  static constexpr int kStage = kStage1 > kStage2 ? kStage1 : kStage2;
  static constexpr int kFit = (kF32Smem / 4 - 2 * kKV - 2 * kP) / kStage;
  static constexpr int kStages = kFit < kF32Stages ? kFit : kF32Stages;
  static_assert(kStages >= 2, "K4b-fp32's ring needs two stages");
  static_assert(kF32Threads == 2 * BQ, "one lse or delta value a thread");
  static constexpr int kChunks = DP / kCW, kSteps = kChunks + BQ / kRW;  // stages a query tile
  static constexpr size_t kSmem = 4 * (2 * (size_t)kKV + 2 * kP + (size_t)kStages * kStage);
};

template <int DP>
__global__ void __launch_bounds__(kF32Threads, 2)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, int T, int NH, int D,
                         float scale, float clip, int vec) {
  using L = F32DkvTiles<DP>;
  constexpr int S = L::kStages, NC = DP / 64, LC = L::kCW + 4, R = kF32Ri;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);  // [32][kRS]
  float* vs = ks + L::kKV;
  float* pa = vs + L::kKV;  // group 0's p tiles: warp w's at pa + 64 kPL w, [64 queries][16 keys]
  float* xs = pa + L::kP;   // the gated p, group 0 to group 1, which overwrites it with dS
  float* ring = xs + L::kP;
  const int bh = blockIdx.y, b = bh / NH, h = bh % NH;
  const int kv0 = blockIdx.x * L::kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = warp / 2, gw = warp % 2, rg = lane / 16, kg = lane % 16;
  const int key0 = 16 * gw + rg;
  const size_t head = ((size_t)b * T * NH + h) * D, stride = (size_t)NH * D;
  const int steps = (T + BQ - 1) / BQ * L::kSteps;

  auto issue = [&](int it) {
    if (it < steps) {
      float* st = ring + (it % S) * L::kStage;
      const int t0 = it / L::kSteps * BQ, c = it % L::kSteps;
      if (c < L::kChunks) {
        load_rows_f32<BQ, L::kCW>(st, q + head, stride, t0, c * L::kCW, T, D, vec);
        load_rows_f32<BQ, L::kCW>(st + BQ * LC, dout + head, stride, t0, c * L::kCW, T, D, vec);
        if (c == L::kChunks - 1) {  // the tile's lse (threads 0-63) and delta (64-127)
          const int half = threadIdx.x / BQ;
          load_row_values(shared_address(st + 2 * BQ * LC + BQ * half),
                          (half ? delta : lse) + (size_t)bh * T, t0, BQ, T, true,
                          threadIdx.x % BQ);
        }
      } else {
        const int r0 = t0 + (c - L::kChunks) * L::kRW;
        load_rows_f32<L::kRW, DP>(st, q + head, stride, r0, 0, T, D, vec);
        load_rows_f32<L::kRW, DP>(st + L::kRW * L::kRS, dout + head, stride, r0, 0, T, D, vec);
      }
    }
    cp_async_commit();
  };
  load_rows_f32<L::kRows, DP>(ks, k + head, stride, kv0, 0, T, D, vec);
  load_rows_f32<L::kRows, DP>(vs, v + head, stride, kv0, 0, T, D, vec);
  for (int s = 0; s + 1 < S; ++s) issue(s);  // k and v land with stage 0

  const float* a = (grp == 0 ? ks : vs) + key0 * L::kRS;
  float* pt = (grp == 0 ? pa : xs) + BQ * kPL * gw + R * rg;  // p (group 0) or dS (1)
  float* xt = xs + BQ * kPL * gw + R * rg;
  bool key_ok[R];
  float acc[R][4 * NC], sc[R][4], rv[4];  // rv: lse (group 0) or delta (1) of the thread's queries
#pragma unroll
  for (int i = 0; i < R; ++i) {
    key_ok[i] = kv0 + key0 + 2 * i < T;
#pragma unroll
    for (int e = 0; e < 4 * NC; ++e) acc[i][e] = 0.0f;
  }

  for (int it = 0; it < steps; ++it) {
    cp_async_wait<S - 2>();
    __syncthreads();  // stage it has landed; every thread is done with stage it - 1's slot
    issue(it + S - 1);
    const float* st = ring + (it % S) * L::kStage;
    const int c = it % L::kSteps;
    if (c < L::kChunks) {
      if (c == 0) {
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
      }
      // S^T over k and the q chunk (group 0), dP^T over v and the dO chunk (1)
      score_product<L::kCW, L::kRS, LC>(sc, a + c * L::kCW, st + grp * BQ * LC + kg * LC);
      if (c == L::kChunks - 1) {
        const int t0 = it / L::kSteps * BQ;
        const float* vals = st + 2 * BQ * LC + grp * BQ;
#pragma unroll
        for (int j = 0; j < 4; ++j) rv[j] = vals[kg + 16 * j];
        if (grp == 0) {
          // p (0 at keys and queries >= T), and p gated on the pre-clip z for dS
          float pg[R][4];
#pragma unroll
          for (int i = 0; i < R; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float z = sc[i][j] * scale;
              float p = 0.0f, g = 0.0f;
              if (key_ok[i] && t0 + kg + 16 * j < T) {
                p = expf(fminf(fmaxf(z, -clip), clip) - rv[j]);
                if (z >= -clip && z <= clip) g = p;
              }
              sc[i][j] = p;
              pg[i][j] = g;
            }
          store_p_columns(pt, sc, kg);
          store_p_columns(xt, pg, kg);
          __syncwarp();
        }
      }
    } else {
      if (grp == 1 && c == L::kChunks) {
        // group 0's gated p of this tile is in xs since this step's barrier
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            float4* x = reinterpret_cast<float4*>(xt + kPL * (kg + 16 * j) + 4 * hf);
            const float4 g = *x;
            const int i = 4 * hf;
            *x = make_float4(g.x * (sc[i][j] - rv[j]) * scale, g.y * (sc[i + 1][j] - rv[j]) * scale,
                             g.z * (sc[i + 2][j] - rv[j]) * scale,
                             g.w * (sc[i + 3][j] - rv[j]) * scale);
          }
        __syncwarp();
      }
      // dV += P^T dO (group 0) or dK += dS^T Q (group 1) over the chunk's rows
      accumulate_product<L::kRW, NC, L::kRS>(acc, pt + kPL * (c - L::kChunks) * L::kRW,
                                             st + (grp == 0 ? L::kRW * L::kRS : 0) + 4 * kg);
    }
  }
  cp_async_wait<0>();

  float* out = grp == 0 ? dv : dk;
#pragma unroll
  for (int i = 0; i < R; ++i)
    if (key_ok[i])
      store_row_f32<NC>(out + head + (size_t)(kv0 + key0 + 2 * i) * stride, acc[i], 1.0f, kg, D,
                        vec);
}

// ---------------------------------------------------------------------------
// K4a (dQ), bf16
// ---------------------------------------------------------------------------

constexpr int kDqRows = 64;  // query rows a block; key tiles of BK rows
static_assert(BK == kDqRows, "K4a's q, dO, k and v tiles share one size");

template <int DP>
struct DqTiles {
  static constexpr int kTile = kDqRows * DP * 2;  // bytes of one q, dO, k or v tile
  static constexpr int kX = 32 * 128 * 4;        // the gated p, warpgroup 0 -> 1
  static constexpr int kFit =  // as in FwdTiles, beside q, dO and the p tile
      (kSmemLimit - 1024 - 2 * kTile - kX - 128) / (2 * kTile);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static_assert(kStages >= 2, "K4a's ring needs two stages");
  static constexpr size_t kSmem =
      1024 + (2 + 2 * (size_t)kStages) * kTile + kX + 8 * (1 + 2 * kStages);
};

// acc = a . b^T over the DP columns of two K-major 64-row swizzled tiles,
// waited for.
template <int DP>
__device__ __forceinline__ void tile_product_abt(float (&acc)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.0f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t off = (kk >> 2) * 64 * kRowBytes + (kk & 3) * 32;
    wgmma_ss(acc, sw128_desc(a + off, 16), sw128_desc(b + off, 16));
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_acc(acc);
}

// delta = sum_d dO[d] * o[d] in fp32 of the thread's two rows (0 unless
// `ok`), by the four lanes of a quad: lane `quad` takes the 16-byte groups
// quad, quad + 4, ... of both rows (`vec`: all its loads issued before the
// first multiply) or the columns quad, quad + 4, ..., then two shuffles.
template <int DP>
__device__ __forceinline__ void quad_row_dots(float (&delta)[2], const bf16* __restrict__ dout,
                                              const bf16* __restrict__ o, const size_t (&at)[2],
                                              const bool (&ok)[2], int D, bool vec, int quad) {
  constexpr int G = DP / 32;  // 16-byte groups of a row a lane takes
  if (vec) {
    uint4 a[2][G], b[2][G];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int col = 8 * (4 * j + quad);
        const bool in = ok[r] && col < D;
        a[r][j] = in ? __ldg(reinterpret_cast<const uint4*>(dout + at[r] + col)) : make_uint4(0, 0, 0, 0);
        b[r][j] = in ? __ldg(reinterpret_cast<const uint4*>(o + at[r] + col)) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const uint32_t x[4] = {a[r][j].x, a[r][j].y, a[r][j].z, a[r][j].w};
        const uint32_t y[4] = {b[r][j].x, b[r][j].y, b[r][j].z, b[r][j].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // a bf16's float is its bits in the high half
          acc += __uint_as_float(x[e] << 16) * __uint_as_float(y[e] << 16);
          acc += __uint_as_float(x[e] & 0xffff0000u) * __uint_as_float(y[e] & 0xffff0000u);
        }
      }
      delta[r] = acc;
    }
  } else {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float acc = 0.0f;
      if (ok[r])
        for (int d = quad; d < D; d += 4)
          acc += __bfloat162float(dout[at[r] + d]) * __bfloat162float(o[at[r] + d]);
      delta[r] = acc;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 1);
    delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 2);
  }
}

template <int DP>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ o,
                    const bf16* __restrict__ dout, const float* __restrict__ lse,
                    bf16* __restrict__ dq, int T, int NH, int D, float scale, float clip,
                    int vec) {
  using L = DqTiles<DP>;
  constexpr int S = L::kStages, NC = DP / kChunk;
  extern __shared__ __align__(1024) unsigned char smem_ws[];
  const uint32_t raw = shared_address(smem_ws);
  const uint32_t sq = (raw + 1023) & ~1023u, sdo = sq + L::kTile;  // [NC][64 rows][64]
  const uint32_t skv = sdo + L::kTile;  // stage s: k tile at skv + 2 s kTile, v tile after it
  const uint32_t sx = skv + 2 * L::kTile * S;
  const uint32_t bars = sx + L::kX;
  float* xbuf = reinterpret_cast<float*>(smem_ws + (sx - raw));  // [32][128]
  const int bh = blockIdx.y, b = bh / NH, h = bh % NH;
  const int q0 = blockIdx.x * kDqRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nk = (T + BK - 1) / BK;
  const size_t head = ((size_t)b * T * NH + h) * D, stride = (size_t)NH * D;
  init_ring(bars, S);

  if (threadIdx.x >= kConsumers) {  // the producer warpgroup
    const int pt = threadIdx.x - kConsumers;
    load_sw128<DP, kDqRows>(sq, q + head, stride, q0, T, D, vec, pt);
    load_sw128<DP, kDqRows>(sdo, dout + head, stride, q0, T, D, vec, pt);
    stage_issued(bars, vec);
    for (int i = 0; i < nk; ++i) {
      const int s = i % S;
      if (i >= S) mbar_wait(bars + 8 * (1 + S + s), (i / S - 1) & 1);
      const uint32_t ks = skv + 2 * L::kTile * s;
      load_sw128<DP, BK>(ks, k + head, stride, i * BK, T, D, vec, pt);
      load_sw128<DP, BK>(ks + L::kTile, v + head, stride, i * BK, T, D, vec, pt);
      stage_issued(bars + 8 * (1 + s), vec);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // Warpgroup 0: S = Q K^T and the gated p; warpgroup 1: dP = dO V^T, dS and
  // dQ += dS K. This thread's query rows q0 + row and q0 + row + 8, key
  // columns 8 j + 2 quad (+1) of the tile.
  const int wg = warp / 4, tid = threadIdx.x % 128;
  const int row = 16 * (warp % 4) + lane / 4, quad = lane % 4;
  const bool row_ok[2] = {q0 + row < T, q0 + row + 8 < T};

  if (wg == 0) {
    float lse_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) lse_r[r] = row_ok[r] ? lse[(size_t)bh * T + q0 + row + 8 * r] : 0.0f;
    mbar_wait(bars, 0);
    for (int i = 0; i < nk; ++i) {
      const int s = i % S;
      mbar_wait(bars + 8 * (1 + s), (i / S) & 1);
      fence_proxy_async();
      float sacc[32];
      tile_product_abt<DP>(sacc, sq, skv + 2 * L::kTile * s);
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (1 + S + s));  // this warp is done with the stage

      // p gated on the pre-clip z (where it passes, clip(z) = z <= lse), 0 at
      // keys >= T (only the last tile has any); __expf (ex2.approx, a few ulp
      // on z - lse <= 0) in place of the accurate expf, whose extra
      // instructions here held both warpgroups back
      const bool tail = (i + 1) * BK > T;
      if (i > 0) named_sync(2);  // warpgroup 1 has read the previous tile's
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const float z = sacc[e] * scale;
        float pg = 0.0f;
        if ((!tail || i * BK + 8 * (e / 4) + 2 * quad + (e & 1) < T) && z >= -clip && z <= clip)
          pg = __expf(z - lse_r[(e >> 1) & 1]);
        xbuf[e * 128 + tid] = pg;
      }
      named_arrive(1);
    }
    return;
  }

  // warpgroup 1: delta of its two rows from o (read once), while the ring fills
  float delta_r[2];
  const size_t at[2] = {head + (size_t)(q0 + row) * stride, head + (size_t)(q0 + row + 8) * stride};
  quad_row_dots<DP>(delta_r, dout, o, at, row_ok, D, vec, quad);
  float acc[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[c][e] = 0.0f;
  mbar_wait(bars, 0);

  for (int i = 0; i < nk; ++i) {
    const int s = i % S;
    mbar_wait(bars + 8 * (1 + s), (i / S) & 1);
    fence_proxy_async();
    const uint32_t ks = skv + 2 * L::kTile * s;
    float ds[32];
    tile_product_abt<DP>(ds, sdo, ks + L::kTile);  // dP

    named_sync(1);  // warpgroup 0's gated p of this tile is in xbuf
#pragma unroll
    for (int e = 0; e < 32; ++e) ds[e] = xbuf[e * 128 + tid] * (ds[e] - delta_r[(e >> 1) & 1]) * scale;
    if (i + 1 < nk) named_arrive(2);
    uint32_t fa[4][4];  // dS rounded to bf16, as the A operand
    to_a_fragments(fa, ds);

    // dQ += dS K, the k tile read MN-major (its rows are the product's K)
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs(acc[c], fa[kk],
                 sw128_desc(ks + c * BK * kRowBytes + kk * 16 * kRowBytes, BK * kRowBytes));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < NC; ++c) fence_acc(acc[c]);
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (1 + S + s));  // this warp is done with the stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (row_ok[r])
      store_row<NC>(dq + head + (size_t)(q0 + row + 8 * r) * stride, acc, r, 1.0f, quad, D, vec);
}

// ---------------------------------------------------------------------------
// K4b (dK, dV), bf16, and the delta pre-pass of both K4b entries
// ---------------------------------------------------------------------------

// delta[b, h, t] = sum_d dO[b, t, h, d] o[b, t, h, d] in fp32, one warp a row
// (warp_row_dot), from bf16 or fp32 o and dO; rows are (b, t, h) in memory
// order, R = B * T * NH. The pre-pass of both K4b entries.
template <typename E>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const E* __restrict__ o, const E* __restrict__ dout,
                       float* __restrict__ delta, int R, int T, int NH, int D) {
  const int r = blockIdx.x * kWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (r >= R) return;
  const float acc = warp_row_dot(dout + (size_t)r * D, o + (size_t)r * D, D, lane);
  const int h = r % NH, t = (r / NH) % T, b = r / NH / T;
  if (lane == 0) delta[((size_t)b * NH + h) * T + t] = acc;
}

constexpr int kDkvRows = 64;  // key rows a block; query tiles of 64 rows

template <int DP>
struct DkvTiles {
  static constexpr int kTile = kDkvRows * DP * 2;  // bytes of one k, v, q or dO tile
  static constexpr int kX = 32 * 128 * 4;         // the gated p, warpgroup 0 -> 1
  static constexpr int kRowVals = 2 * BQ * 4;     // a stage's lse and delta
  static constexpr int kFit =  // as in FwdTiles, beside k, v and the p tile
      (kSmemLimit - 1024 - 2 * kTile - kX - 128) / (2 * kTile + kRowVals);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr size_t kSmem = 1024 + (2 + 2 * (size_t)kStages) * kTile + kX +
                                  (size_t)kRowVals * kStages + 8 * (1 + 2 * kStages);
};

template <int DP>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int T, int NH, int D,
                     float scale, float clip, int vec) {
  using L = DkvTiles<DP>;
  constexpr int S = L::kStages, NC = DP / kChunk;
  extern __shared__ __align__(1024) unsigned char smem_ws[];
  const uint32_t raw = shared_address(smem_ws);
  const uint32_t sk = (raw + 1023) & ~1023u, sv = sk + L::kTile;  // [NC][64 rows][64]
  const uint32_t sstage = sv + L::kTile;  // stage s: q tile at sstage + 2 s kTile, dO after it
  const uint32_t sx = sstage + 2 * L::kTile * S;
  const uint32_t srow = sx + L::kX;       // stage s: lse[64] at srow + s kRowVals, delta after
  const uint32_t bars = srow + L::kRowVals * S;
  float* xbuf = reinterpret_cast<float*>(smem_ws + (sx - raw));  // [32][128]
  const float* rowvals = reinterpret_cast<const float*>(smem_ws + (srow - raw));
  const int bh = blockIdx.y, b = bh / NH, h = bh % NH;
  const int kv0 = blockIdx.x * kDkvRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nq = (T + BQ - 1) / BQ;
  const size_t head = ((size_t)b * T * NH + h) * D, stride = (size_t)NH * D;
  init_ring(bars, S);

  if (threadIdx.x >= kConsumers) {  // the producer warpgroup
    const int pt = threadIdx.x - kConsumers;
    load_sw128<DP, kDkvRows>(sk, k + head, stride, kv0, T, D, vec, pt);
    load_sw128<DP, kDkvRows>(sv, v + head, stride, kv0, T, D, vec, pt);
    stage_issued(bars, vec);
    for (int i = 0; i < nq; ++i) {
      const int s = i % S;
      if (i >= S) mbar_wait(bars + 8 * (1 + S + s), (i / S - 1) & 1);
      const uint32_t st = sstage + 2 * L::kTile * s, sr = srow + L::kRowVals * s;
      load_sw128<DP, BQ>(st, q + head, stride, i * BQ, T, D, vec, pt);
      load_sw128<DP, BQ>(st + L::kTile, dout + head, stride, i * BQ, T, D, vec, pt);
      load_row_values(sr, lse + (size_t)bh * T, i * BQ, BQ, T, vec, pt);
      load_row_values(sr + 4 * BQ, delta + (size_t)bh * T, i * BQ, BQ, T, vec, pt);
      stage_issued(bars + 8 * (1 + s), vec);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // Warpgroup 0: S^T = K Q^T, p, dV += P^T dO; warpgroup 1: dP^T = V dO^T,
  // dS, dK += dS^T Q. This thread's key rows kv0 + row and kv0 + row + 8,
  // query columns 8 j + 2 quad (+1) of the tile.
  const int wg = warp / 4, tid = threadIdx.x % 128;
  const int row = 16 * (warp % 4) + lane / 4, quad = lane % 4;
  const bool key_ok[2] = {kv0 + row < T, kv0 + row + 8 < T};
  const uint32_t a_tile = wg == 0 ? sk : sv;
  float acc[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[c][e] = 0.0f;
  mbar_wait(bars, 0);

  for (int i = 0; i < nq; ++i) {
    const int s = i % S;
    mbar_wait(bars + 8 * (1 + s), (i / S) & 1);
    fence_proxy_async();
    const uint32_t sq = sstage + 2 * L::kTile * s, sdo = sq + L::kTile;
    const float* lse_s = rowvals + 2 * BQ * s;
    const float* delta_s = lse_s + BQ;

    // S^T (warpgroup 0) or dP^T (warpgroup 1): 64 keys x 64 queries
    float sacc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sacc[e] = 0.0f;
    const uint32_t b_tile = wg == 0 ? sq : sdo;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kDkvRows * kRowBytes + (kk & 3) * 32;
      wgmma_ss(sacc, sw128_desc(a_tile + off, 16), sw128_desc(b_tile + off, 16));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(sacc);

    if (wg == 0) {
      // p (0 at keys and queries >= T), and p gated on the pre-clip z for dS
      if (i > 0) named_sync(2);  // warpgroup 1 has read the previous tile's
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int col = 8 * (e / 4) + 2 * quad + (e & 1);
        const float z = sacc[e] * scale;
        float p = 0.0f, pg = 0.0f;
        if (key_ok[(e >> 1) & 1] && i * BQ + col < T) {
          p = expf(fminf(fmaxf(z, -clip), clip) - lse_s[col]);
          if (z >= -clip && z <= clip) pg = p;
        }
        xbuf[e * 128 + tid] = pg;
        sacc[e] = p;
      }
      named_arrive(1);
    } else {
      named_sync(1);  // warpgroup 0's gated p of this tile is in xbuf
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int col = 8 * (e / 4) + 2 * quad + (e & 1);
        sacc[e] = xbuf[e * 128 + tid] * (sacc[e] - delta_s[col]) * scale;
      }
      if (i + 1 < nq) named_arrive(2);
    }
    uint32_t fa[4][4];  // p^T or dS^T rounded to bf16, as the A operand
    to_a_fragments(fa, sacc);

    // dV += P^T dO (warpgroup 0) or dK += dS^T Q (warpgroup 1)
    const uint32_t c_tile = wg == 0 ? sdo : sq;
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs(acc[c], fa[kk],
                 sw128_desc(c_tile + c * BQ * kRowBytes + kk * 16 * kRowBytes, BQ * kRowBytes));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < NC; ++c) fence_acc(acc[c]);
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (1 + S + s));  // this warp is done with the stage
  }

  bf16* out = wg == 0 ? dv : dk;
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (key_ok[r]) store_row<NC>(out + head + (size_t)(kv0 + row + 8 * r) * stride, acc, r, 1.0f,
                                 quad, D, vec);
}

// ---------------------------------------------------------------------------
// K4a (dQ), fp32 (CUDA cores): register-tiled products fed by a cp.async ring
// ---------------------------------------------------------------------------

// K4a-fp32: block = (batch*head, 32 query rows), q and dO loaded once. Warps
// 0 and 1 (group 0) compute S = Q K^T, warps 2 and 3 (group 1) delta of the
// rows (from o, before the key loop) and dP = dO V^T. Warp 2 g + w owns query
// rows 16 w .. 16 w + 15, lane (rg, kg) rows 16 w + rg + 2 i. A key tile of
// 64 comes through the ring as DP / kCW chunks of k and v (64 keys x kCW
// columns each) for the score products, then chunks of 2 kRW keys x DP of k
// for dQ += dS K: group g takes the g-th kRW keys of each chunk, so the keys
// of the tile fall in runs of kRW that alternate between the groups. A lane's
// 4 score columns are one key of each of 4 consecutive runs (keys kg % kRW +
// 4 kRW (kg / kRW) + kRW j), so that keys j = 0, 2 are group 0's and j = 1, 3
// group 1's. After the last score chunk the two groups cross what the other
// needs through the crossing tiles xs (two named barriers): group 0 the
// exponent z - lse of group 1's keys, group 1 dP - delta of group 0's; then
// each forms p (half the exponentials each) and dS of its own keys in place
// and accumulates a partial dQ of the thread's 8 rows x DP / 16 columns. At
// the end group 1's partial dQ goes to group 0 through shared memory, and
// group 0 adds it to its own (one fixed order, so the bits are the same from
// run to run) and stores.
template <int DP>
struct F32DqTiles {
  static constexpr int kRows = kF32Rows / 2;  // query rows a block: 16 a warp of each group
  static constexpr int kCW = DP > 192 ? 16 : 32;  // columns of a score chunk
  static constexpr int kRW = DP > 192 ? 4 : 8;    // keys of a dQ chunk each group takes
  static constexpr int kRS = DP + 4;  // row stride of q, dO and the dQ chunks (4 words of padding)
  static constexpr int kQD = kRows * kRS;     // floats of q or dO
  static constexpr int kX = 2 * BK * kPL;     // crossing tiles: warps w, 2 + w share the w-th
  static constexpr int kStage1 = 2 * BK * (kCW + 4);  // k and v chunks
  static constexpr int kStage2 = 2 * kRW * kRS;       // a k chunk of 2 kRW keys
  static constexpr int kStage = kStage1 > kStage2 ? kStage1 : kStage2;
  static constexpr int kFit = (kF32Smem / 4 - 2 * kQD - kX) / kStage;
  static constexpr int kStages = kFit < kF32Stages ? kFit : kF32Stages;
  static_assert(kStages >= 2, "K4a-fp32's ring needs two stages");
  static_assert(kRows * kRS >= kF32Threads / 2 * kF32Ri * DP / 16,
                "group 1's partial dQ fits in the q tile");
  static constexpr int kChunks = DP / kCW, kSteps = kChunks + BK / (2 * kRW);  // stages a key tile
  static constexpr size_t kSmem = 4 * (2 * (size_t)kQD + kX + (size_t)kStages * kStage);
};

// delta = sum_d dO[d] o[d] in fp32 of rows t0 + 2 i (i < 8; 0 at rows >= T),
// by the 16 lanes of a half-warp: lane kg takes columns 64 c + 4 kg .. + 3
// (`vec`: 16-byte loads, all of a row's issued before its multiplies) or
// kg, kg + 16, ..., then four shuffles.
template <int DP>
__device__ __forceinline__ void half_warp_row_dots(float (&delta)[kF32Ri],
                                                   const float* __restrict__ dout,
                                                   const float* __restrict__ o, size_t stride,
                                                   int t0, int T, int D, bool vec, int kg) {
  constexpr int NC = DP / 64;
#pragma unroll
  for (int i = 0; i < kF32Ri; ++i) {
    const int t = t0 + 2 * i;
    const float* a = dout + (size_t)t * stride;
    const float* b = o + (size_t)t * stride;
    float acc = 0.0f;
    if (t < T) {
      if (vec) {
        float4 x[NC], y[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int col = 64 * c + 4 * kg;
          const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          x[c] = col < D ? __ldg(reinterpret_cast<const float4*>(a + col)) : zero;
          y[c] = col < D ? __ldg(reinterpret_cast<const float4*>(b + col)) : zero;
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          acc = fmaf(x[c].x, y[c].x, acc);
          acc = fmaf(x[c].y, y[c].y, acc);
          acc = fmaf(x[c].z, y[c].z, acc);
          acc = fmaf(x[c].w, y[c].w, acc);
        }
      } else {
        for (int d = kg; d < D; d += 16) acc = fmaf(a[d], b[d], acc);
      }
    }
#pragma unroll
    for (int off = 8; off; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    delta[i] = acc;
  }
}

template <int DP>
__global__ void __launch_bounds__(kF32Threads, 2)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ o,
                        const float* __restrict__ dout, const float* __restrict__ lse,
                        float* __restrict__ dq, int T, int NH, int D, float scale, float clip,
                        int vec) {
  using L = F32DqTiles<DP>;
  constexpr int S = L::kStages, NC = DP / 64, LC = L::kCW + 4, R = kF32Ri;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [32][kRS]
  float* dos = qs + L::kQD;
  float* xs = dos + L::kQD;  // tile w ([64 keys][16 rows], p, then dS) at xs + 64 kPL w
  float* ring = xs + L::kX;
  const int bh = blockIdx.y, b = bh / NH, h = bh % NH;
  const int q0 = blockIdx.x * L::kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = warp / 2, gw = warp % 2, rg = lane / 16, kg = lane % 16;
  const int row0 = 16 * gw + rg;
  const size_t head = ((size_t)b * T * NH + h) * D, stride = (size_t)NH * D;
  const int steps = (T + BK - 1) / BK * L::kSteps;

  auto issue = [&](int it) {
    if (it < steps) {
      float* st = ring + (it % S) * L::kStage;
      const int t0 = it / L::kSteps * BK, c = it % L::kSteps;
      if (c < L::kChunks) {
        load_rows_f32<BK, L::kCW>(st, k + head, stride, t0, c * L::kCW, T, D, vec);
        load_rows_f32<BK, L::kCW>(st + BK * LC, v + head, stride, t0, c * L::kCW, T, D, vec);
      } else {
        load_rows_f32<2 * L::kRW, DP>(st, k + head, stride,
                                      t0 + (c - L::kChunks) * 2 * L::kRW, 0, T, D, vec);
      }
    }
    cp_async_commit();
  };
  load_rows_f32<L::kRows, DP>(qs, q + head, stride, q0, 0, T, D, vec);
  load_rows_f32<L::kRows, DP>(dos, dout + head, stride, q0, 0, T, D, vec);
  for (int s = 0; s + 1 < S; ++s) issue(s);  // q and dO land with stage 0

  // lse (group 0) or delta (group 1) of the thread's rows, kept in the first
  // padding word of each row of q or dO (row row0 + 2 i at rvals[2 i kRS]):
  // the score products read columns < DP. delta from o, read once, while the
  // ring fills.
  const float* a = (grp == 0 ? qs : dos) + row0 * L::kRS;
  float* rvals = (grp == 0 ? qs : dos) + row0 * L::kRS + DP;
  if (grp == 0) {
    if (kg == 0) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int t = q0 + row0 + 2 * i;
        rvals[2 * i * L::kRS] = t < T ? lse[(size_t)bh * T + t] : 0.0f;
      }
    }
  } else {
    float delta[R];
    half_warp_row_dots<DP>(delta, dout + head, o + head, stride, q0 + row0, T, D, vec, kg);
    if (kg == 0) {
#pragma unroll
      for (int i = 0; i < R; ++i) rvals[2 * i * L::kRS] = delta[i];
    }
  }

  const int key0 = kg % L::kRW + 4 * L::kRW * (kg / L::kRW);  // the lane's first key of a tile
  float* xt = xs + BK * kPL * gw + R * rg;  // the thread's rows of its crossing tile
  float acc[R][4 * NC], sc[R][4];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 4 * NC; ++e) acc[i][e] = 0.0f;

  // the thread's 8 rows of score column j in its crossing tile: two 16-byte
  // vectors
  auto column = [&](int j) { return reinterpret_cast<float4*>(xt + kPL * (key0 + L::kRW * j)); };
  for (int it = 0; it < steps; ++it) {
    cp_async_wait<S - 2>();
    __syncthreads();  // stage it has landed; every thread is done with stage it - 1's slot
    issue(it + S - 1);
    const float* st = ring + (it % S) * L::kStage;
    const int c = it % L::kSteps;
    if (c < L::kChunks) {
      if (c == 0) {
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
      }
      // S over q and the k chunk (group 0), dP over dO and the v chunk (1)
      score_product<L::kCW, L::kRS, LC, L::kRW>(sc, a + c * L::kCW,
                                                st + grp * BK * LC + key0 * LC);
      if (c == L::kChunks - 1) {
        // dS = p (dP - delta) scale, p = exp(z - lse) gated on the pre-clip z
        // (where the gate passes, clip(z) = z) and 0 at keys >= T (only the
        // last tile has any)
        const int t0 = it / L::kSteps * BK;
        if (grp == 0) {
#pragma unroll
          for (int i = 0; i < R; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float z = sc[i][j] * scale;
              const bool pass = t0 + key0 + L::kRW * j < T && z >= -clip && z <= clip;
              sc[i][j] = pass ? z - rvals[2 * i * L::kRS] : kNegInf;  // exp(kNegInf) = 0
            }
#pragma unroll
          for (int j = 1; j < 4; j += 2) {
            column(j)[0] = make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
            column(j)[1] = make_float4(sc[4][j], sc[5][j], sc[6][j], sc[7][j]);
          }
          named_arrive<kF32Threads>(1);
#pragma unroll
          for (int i = 0; i < R; ++i)
#pragma unroll
            for (int j = 0; j < 4; j += 2) sc[i][j] = expf(sc[i][j]);
          named_sync<kF32Threads>(2);  // group 1's dP - delta of group 0's keys is in xs
          // dS of group 0's keys in place: p (dP - delta) scale
#pragma unroll
          for (int j = 0; j < 4; j += 2)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const float4 y = column(j)[hf];
              const int i = 4 * hf;
              column(j)[hf] = make_float4(sc[i][j] * y.x * scale, sc[i + 1][j] * y.y * scale,
                                          sc[i + 2][j] * y.z * scale, sc[i + 3][j] * y.w * scale);
            }
        } else {
#pragma unroll
          for (int i = 0; i < R; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) sc[i][j] -= rvals[2 * i * L::kRS];
#pragma unroll
          for (int j = 0; j < 4; j += 2) {
            column(j)[0] = make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
            column(j)[1] = make_float4(sc[4][j], sc[5][j], sc[6][j], sc[7][j]);
          }
          named_arrive<kF32Threads>(2);
          named_sync<kF32Threads>(1);  // group 0's z - lse of group 1's keys is in xs
          // dS of group 1's keys in place: exp(z - lse) (dP - delta) scale
#pragma unroll
          for (int j = 1; j < 4; j += 2)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const float4 x = column(j)[hf];
              const int i = 4 * hf;
              column(j)[hf] = make_float4(
                  expf(x.x) * sc[i][j] * scale, expf(x.y) * sc[i + 1][j] * scale,
                  expf(x.z) * sc[i + 2][j] * scale, expf(x.w) * sc[i + 3][j] * scale);
            }
        }
        __syncwarp();  // the dQ product reads the rows' dS from the warp's 16 lanes
      }
    } else {
      // dQ += dS K over the group's kRW keys of the chunk
      const int key = (c - L::kChunks) * 2 * L::kRW + grp * L::kRW;
      accumulate_product<L::kRW, NC, L::kRS>(acc, xt + kPL * key,
                                             st + grp * L::kRW * L::kRS + 4 * kg);
    }
  }
  cp_async_wait<0>();

  // group 1's partial dQ to group 0 through the q tile (no longer read: its
  // last reader passed the barrier of the last tile's first dQ step)
  float4* part = reinterpret_cast<float4*>(qs) + threadIdx.x % (kF32Threads / 2);
  if (grp == 1) {
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        part[(i * NC + c) * (kF32Threads / 2)] =
            make_float4(acc[i][4 * c], acc[i][4 * c + 1], acc[i][4 * c + 2], acc[i][4 * c + 3]);
  }
  __syncthreads();
  if (grp == 0) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 x = part[(i * NC + c) * (kF32Threads / 2)];
        acc[i][4 * c] += x.x;
        acc[i][4 * c + 1] += x.y;
        acc[i][4 * c + 2] += x.z;
        acc[i][4 * c + 3] += x.w;
      }
      const int t = q0 + row0 + 2 * i;
      if (t < T) store_row_f32<NC>(dq + head + (size_t)t * stride, acc[i], 1.0f, kg, D, vec);
    }
  }
}

bool bad_shape(int B, int T, int NH, int D) {
  return B <= 0 || T <= 0 || NH <= 0 || D <= 0 || D > kMaxD || B * NH > 65535;
}

// Set the kernel's dynamic shared memory and launch it on `stream`.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, int threads, size_t smem, void* stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return cudaGetLastError();
}

// The Hopper kernels' head_dim, padded to whole 64-column chunks.
int padded_dim(int D) { return D <= 64 ? 64 : D <= 128 ? 128 : D <= 192 ? 192 : 256; }

// Rows of D elements that cp.async can copy in 16-byte pieces: D a multiple
// of the elements in 16 bytes (8 bf16, 4 fp32) and every base address
// 16-byte aligned.
bool rows16(int D, int per16, std::initializer_list<const void*> ptrs) {
  if (D % per16 != 0) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

template <int DP>
int forward_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse, int B, int T,
                 int NH, int D, float scale, float clip, int vec, void* stream) {
  const dim3 grid((T + kFwdRows - 1) / kFwdRows, B * NH);
  const size_t smem = FwdTiles<DP>::kSmem;
  if (lse)
    return launch(flash_fwd_kernel<DP, true>, grid, kWsThreads, smem, stream, q, k, v, o, lse, T,
                  NH, D, scale, clip, vec);
  return launch(flash_fwd_kernel<DP, false>, grid, kWsThreads, smem, stream, q, k, v, o, lse, T,
                NH, D, scale, clip, vec);
}

template <int DP>
int dq_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* o, const bf16* dout,
            const float* lse, bf16* dq, int B, int T, int NH, int D, float scale, float clip,
            int vec, void* stream) {
  return launch(flash_bwd_dq_kernel<DP>, dim3((T + kDqRows - 1) / kDqRows, B * NH), kWsThreads,
                DqTiles<DP>::kSmem, stream, q, k, v, o, dout, lse, dq, T, NH, D, scale, clip, vec);
}

template <int DP>
int dkv_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, const float* lse,
             const float* delta, bf16* dk, bf16* dv, int B, int T, int NH, int D, float scale,
             float clip, int vec, void* stream) {
  return launch(flash_bwd_dkv_kernel<DP>, dim3((T + kDkvRows - 1) / kDkvRows, B * NH), kWsThreads,
                DkvTiles<DP>::kSmem, stream, q, k, v, dout, lse, delta, dk, dv, T, NH, D, scale,
                clip, vec);
}

template <int DP>
int forward_f32(const float* q, const float* k, const float* v, float* o, float* lse, int B, int T,
                int NH, int D, float scale, float clip, int vec, void* stream) {
  using L = F32FwdTiles<DP>;
  const dim3 grid((T + kF32Rows - 1) / kF32Rows, B * NH);
  if (lse)
    return launch(flash_fwd_f32_kernel<DP, true>, grid, kF32Threads, L::kSmem, stream, q, k, v, o,
                  lse, T, NH, D, scale, clip, vec);
  return launch(flash_fwd_f32_kernel<DP, false>, grid, kF32Threads, L::kSmem, stream, q, k, v, o,
                lse, T, NH, D, scale, clip, vec);
}

template <int DP>
int dq_f32(const float* q, const float* k, const float* v, const float* o, const float* dout,
           const float* lse, float* dq, int B, int T, int NH, int D, float scale, float clip,
           int vec, void* stream) {
  using L = F32DqTiles<DP>;
  return launch(flash_bwd_dq_f32_kernel<DP>, dim3((T + L::kRows - 1) / L::kRows, B * NH),
                kF32Threads, L::kSmem, stream, q, k, v, o, dout, lse, dq, T, NH, D, scale, clip,
                vec);
}

template <int DP>
int dkv_f32(const float* q, const float* k, const float* v, const float* dout, const float* lse,
            const float* delta, float* dk, float* dv, int B, int T, int NH, int D, float scale,
            float clip, int vec, void* stream) {
  using L = F32DkvTiles<DP>;
  return launch(flash_bwd_dkv_f32_kernel<DP>, dim3((T + L::kRows - 1) / L::kRows, B * NH),
                kF32Threads, L::kSmem, stream, q, k, v, dout, lse, delta, dk, dv, T, NH, D, scale,
                clip, vec);
}

}  // namespace

extern "C" {

// K3, bf16 q, k, v, o; lse (B, NH, T) fp32, or null for none. Launch on
// `stream`. Returns 0 or a cudaError_t code (as every function below).
int flash_attention_clamped_forward(const void* q, const void* k, const void* v, void* o,
                                    void* lse, int B, int T, int NH, int D, float scale,
                                    float clip, void* stream) {
  if (bad_shape(B, T, NH, D)) return cudaErrorInvalidValue;
  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp = static_cast<const bf16*>(v);
  auto* op = static_cast<bf16*>(o);
  auto* lp = static_cast<float*>(lse);
  const int vec = rows16(D, 8, {q, k, v, o});
  switch (padded_dim(D)) {
    case 64: return forward_bf16<64>(qp, kp, vp, op, lp, B, T, NH, D, scale, clip, vec, stream);
    case 128: return forward_bf16<128>(qp, kp, vp, op, lp, B, T, NH, D, scale, clip, vec, stream);
    case 192: return forward_bf16<192>(qp, kp, vp, op, lp, B, T, NH, D, scale, clip, vec, stream);
    default: return forward_bf16<256>(qp, kp, vp, op, lp, B, T, NH, D, scale, clip, vec, stream);
  }
}

// K3, fp32 q, k, v, o; lse as above.
int flash_attention_clamped_forward_f32(const void* q, const void* k, const void* v, void* o,
                                        void* lse, int B, int T, int NH, int D, float scale,
                                        float clip, void* stream) {
  if (bad_shape(B, T, NH, D)) return cudaErrorInvalidValue;
  const auto* qp = static_cast<const float*>(q);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  auto* op = static_cast<float*>(o);
  auto* lp = static_cast<float*>(lse);
  const int vec = rows16(D, 4, {q, k, v, o});
  switch (padded_dim(D)) {
    case 64: return forward_f32<64>(qp, kp, vp, op, lp, B, T, NH, D, scale, clip, vec, stream);
    case 128: return forward_f32<128>(qp, kp, vp, op, lp, B, T, NH, D, scale, clip, vec, stream);
    case 192: return forward_f32<192>(qp, kp, vp, op, lp, B, T, NH, D, scale, clip, vec, stream);
    default: return forward_f32<256>(qp, kp, vp, op, lp, B, T, NH, D, scale, clip, vec, stream);
  }
}

// K4a: dq from q, k, v, o, dout (bf16) and lse (fp32).
int flash_attention_clamped_backward_dq(const void* q, const void* k, const void* v,
                                        const void* o, const void* dout, const void* lse,
                                        void* dq, int B, int T, int NH, int D, float scale,
                                        float clip, void* stream) {
  if (bad_shape(B, T, NH, D)) return cudaErrorInvalidValue;
  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp = static_cast<const bf16*>(v);
  const auto* op = static_cast<const bf16*>(o);
  const auto* gp = static_cast<const bf16*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  auto* dqp = static_cast<bf16*>(dq);
  const int vec = rows16(D, 8, {q, k, v, o, dout, dq});
  switch (padded_dim(D)) {
    case 64: return dq_bf16<64>(qp, kp, vp, op, gp, lp, dqp, B, T, NH, D, scale, clip, vec, stream);
    case 128: return dq_bf16<128>(qp, kp, vp, op, gp, lp, dqp, B, T, NH, D, scale, clip, vec, stream);
    case 192: return dq_bf16<192>(qp, kp, vp, op, gp, lp, dqp, B, T, NH, D, scale, clip, vec, stream);
    default: return dq_bf16<256>(qp, kp, vp, op, gp, lp, dqp, B, T, NH, D, scale, clip, vec, stream);
  }
}

// K4b: dk, dv from q, k, v, o, dout (bf16) and lse (fp32). `delta` is
// scratch for (B, NH, T) fp32, which the pre-pass fills with rowsum(dout * o)
// before the kernel reads it; both run on `stream`.
int flash_attention_clamped_backward_dkv(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const void* lse,
                                         void* delta, void* dk, void* dv, int B, int T, int NH,
                                         int D, float scale, float clip, void* stream) {
  if (bad_shape(B, T, NH, D)) return cudaErrorInvalidValue;
  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp = static_cast<const bf16*>(v);
  const auto* gp = static_cast<const bf16*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  auto* dl = static_cast<float*>(delta);
  auto* dkp = static_cast<bf16*>(dk);
  auto* dvp = static_cast<bf16*>(dv);
  const int rows = B * T * NH;
  int err = launch(flash_bwd_delta_kernel<bf16>, dim3((rows + kWarps - 1) / kWarps), kThreads, 0, stream,
                   static_cast<const bf16*>(o), gp, dl, rows, T, NH, D);
  if (err != cudaSuccess) return err;
  const int vec = rows16(D, 8, {q, k, v, dout, dk, dv});
  switch (padded_dim(D)) {
    case 64: return dkv_bf16<64>(qp, kp, vp, gp, lp, dl, dkp, dvp, B, T, NH, D, scale, clip, vec, stream);
    case 128: return dkv_bf16<128>(qp, kp, vp, gp, lp, dl, dkp, dvp, B, T, NH, D, scale, clip, vec, stream);
    case 192: return dkv_bf16<192>(qp, kp, vp, gp, lp, dl, dkp, dvp, B, T, NH, D, scale, clip, vec, stream);
    default: return dkv_bf16<256>(qp, kp, vp, gp, lp, dl, dkp, dvp, B, T, NH, D, scale, clip, vec, stream);
  }
}

// K4a, fp32.
int flash_attention_clamped_backward_dq_f32(const void* q, const void* k, const void* v,
                                            const void* o, const void* dout, const void* lse,
                                            void* dq, int B, int T, int NH, int D, float scale,
                                            float clip, void* stream) {
  if (bad_shape(B, T, NH, D)) return cudaErrorInvalidValue;
  const auto* qp = static_cast<const float*>(q);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  const auto* op = static_cast<const float*>(o);
  const auto* gp = static_cast<const float*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  auto* dqp = static_cast<float*>(dq);
  const int vec = rows16(D, 4, {q, k, v, o, dout, dq});
  switch (padded_dim(D)) {
    case 64: return dq_f32<64>(qp, kp, vp, op, gp, lp, dqp, B, T, NH, D, scale, clip, vec, stream);
    case 128: return dq_f32<128>(qp, kp, vp, op, gp, lp, dqp, B, T, NH, D, scale, clip, vec, stream);
    case 192: return dq_f32<192>(qp, kp, vp, op, gp, lp, dqp, B, T, NH, D, scale, clip, vec, stream);
    default: return dq_f32<256>(qp, kp, vp, op, gp, lp, dqp, B, T, NH, D, scale, clip, vec, stream);
  }
}

// K4b, fp32: as the bf16 entry, delta scratch included.
int flash_attention_clamped_backward_dkv_f32(const void* q, const void* k, const void* v,
                                             const void* o, const void* dout, const void* lse,
                                             void* delta, void* dk, void* dv, int B, int T,
                                             int NH, int D, float scale, float clip,
                                             void* stream) {
  if (bad_shape(B, T, NH, D)) return cudaErrorInvalidValue;
  const auto* qp = static_cast<const float*>(q);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  const auto* gp = static_cast<const float*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  auto* dl = static_cast<float*>(delta);
  auto* dkp = static_cast<float*>(dk);
  auto* dvp = static_cast<float*>(dv);
  const int rows = B * T * NH;
  int err = launch(flash_bwd_delta_kernel<float>, dim3((rows + kWarps - 1) / kWarps), kThreads, 0,
                   stream, static_cast<const float*>(o), gp, dl, rows, T, NH, D);
  if (err != cudaSuccess) return err;
  const int vec = rows16(D, 4, {q, k, v, dout, dk, dv});
  switch (padded_dim(D)) {
    case 64: return dkv_f32<64>(qp, kp, vp, gp, lp, dl, dkp, dvp, B, T, NH, D, scale, clip, vec, stream);
    case 128: return dkv_f32<128>(qp, kp, vp, gp, lp, dl, dkp, dvp, B, T, NH, D, scale, clip, vec, stream);
    case 192: return dkv_f32<192>(qp, kp, vp, gp, lp, dl, dkp, dvp, B, T, NH, D, scale, clip, vec, stream);
    default: return dkv_f32<256>(qp, kp, vp, gp, lp, dl, dkp, dvp, B, T, NH, D, scale, clip, vec, stream);
  }
}

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
