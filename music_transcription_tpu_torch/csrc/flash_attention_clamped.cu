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
//   lse                         (B, NH, T) fp32, one value per row
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
// Design of the bf16 kernels: one block of 8 warps per (batch*head, tile of 64
// rows); tiles of the other operand stream through shared memory; every
// product runs on the tensor cores through WMMA (bf16 16x16x16 fragments,
// fp32 accumulation), with the fp32 accumulators in shared memory; the
// elementwise softmax / dS work uses 4 consecutive threads per row. head_dim
// is padded to a multiple of 16 inside shared memory (192 needs none); padded
// columns are zero and add nothing. Rows past T are zero-filled and never
// stored; keys past T are masked AFTER the clamp (clamping afterwards would
// bring them back at -clip).
//   K3:  148 KB of shared memory at D=192 (q tile, k and v tiles, scores,
//        probabilities, output accumulator).
//   K4a: 189 KB (q, dO, k, v tiles, S and dP, dS, dQ accumulator); above
//        D=192 the key tiles hold 32 rows.
//   K4b: 225 KB with 64 key rows per block (k, v, q, dO tiles, S and dP, the
//        dK and dV accumulators), of the 227 KB a block may have: p and dS in
//        bf16 overwrite the fp32 scores once these are in registers. Above
//        D=192 the block takes 32 key rows.
//
// fp32 inputs: the tensor cores take no full-fp32 operands, so every product
// is an fp32 FMA on the CUDA cores (67 TFLOP/s at most, and the loops read one
// shared-memory operand per FMA, which caps them lower). K3-fp32 and K4a-fp32:
// 256 threads per 64 query rows, key / value tiles of 32 rows, four lanes per
// query row, each owning key columns part, part+4, ... of the score tile and
// output columns part, part+4, ... in registers. K4b-fp32: 256 threads per 32
// key rows and query tiles of 64 rows; the score step uses the same four
// lanes per query row, the accumulation step eight lanes per key row, each
// owning dK and dV columns cpart, cpart+8, ... in registers. Rows of the
// shared tiles are padded by one word so the lanes of a warp read distinct
// banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

using namespace nvcuda;
using bf16 = __nv_bfloat16;

namespace {

constexpr int BQ = 64, BK = 64;
constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kMaxD = 256;
constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may have
constexpr float kNegInf = -1e9f;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragAT = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBT = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Copy rows [t0, t0+rows) of head h of batch b into a [rows][DP] shared tile,
// zero-filling rows >= T and columns >= D.
__device__ void load_tile(bf16* dst, const bf16* __restrict__ src, int b, int h, int t0, int rows,
                          int T, int NH, int D, int DP) {
  if (D % 8 == 0) {
    const int vpr = DP / 8;  // 16-byte vectors per shared row
    for (int e = threadIdx.x; e < rows * vpr; e += kThreads) {
      const int r = e / vpr, d = (e % vpr) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (t0 + r < T && d < D)
        val = __ldg(reinterpret_cast<const uint4*>(src + (((size_t)b * T + t0 + r) * NH + h) * D + d));
      *reinterpret_cast<uint4*>(dst + r * DP + d) = val;
    }
  } else {
    for (int e = threadIdx.x; e < rows * DP; e += kThreads) {
      const int r = e / DP, d = e % DP;
      bf16 val = __float2bfloat16(0.0f);
      if (t0 + r < T && d < D) val = src[(((size_t)b * T + t0 + r) * NH + h) * D + d];
      dst[r * DP + d] = val;
    }
  }
}

// Rows [t0, t0+rows) of head h of batch b into a [rows][stride] fp32 shared
// tile, zero-filling rows >= T.
__device__ void load_tile_f32(float* dst, int stride, const float* __restrict__ src, int b, int h,
                              int t0, int rows, int T, int NH, int D) {
  for (int e = threadIdx.x; e < rows * D; e += kThreads) {
    const int r = e / D, d = e % D;
    dst[r * stride + d] = t0 + r < T ? src[(((size_t)b * T + t0 + r) * NH + h) * D + d] : 0.0f;
  }
}

// out[M][N] (fp32, row stride ldo) = a[M][DP] . bt[N][DP]^T over the padded
// head dim: the (M/16) x (N/16) tiles of 16x16, dealt to the warps from
// `first` in steps of `step`.
__device__ void product_abt(float* out, int ldo, const bf16* a, const bf16* bt, int M, int N,
                            int DP, int first, int step) {
  const int tn = N / 16;
  for (int tile = first; tile < (M / 16) * tn; tile += step) {
    const int tr = tile / tn, tc = tile % tn;
    FragC acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < DP / 16; ++kk) {
      FragA fa;
      FragBT fb;
      wmma::load_matrix_sync(fa, a + tr * 16 * DP + kk * 16, DP);
      wmma::load_matrix_sync(fb, bt + tc * 16 * DP + kk * 16, DP);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(out + tr * 16 * ldo + tc * 16, acc, ldo, wmma::mem_row_major);
  }
}

// delta[r] = sum_d dO[r, d] * o[r, d] in fp32 for the rows [t0, t0+rows) of
// head h of batch b: dO from its shared tile, o from device memory; one warp
// per row. Rows >= T get 0.
__device__ void row_delta(float* delta_s, const bf16* dos, const bf16* __restrict__ o, int b,
                          int h, int t0, int rows, int T, int NH, int D, int DP) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += kWarps) {
    float acc = 0.0f;
    if (t0 + r < T) {
      const bf16* orow = o + (((size_t)b * T + t0 + r) * NH + h) * D;
      for (int d = lane; d < D; d += 32)
        acc += __bfloat162float(dos[r * DP + d]) * __bfloat162float(orow[d]);
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) delta_s[r] = acc;
  }
}

// ---------------------------------------------------------------------------
// K3, bf16
// ---------------------------------------------------------------------------

size_t smem_bytes(int DP) {
  return sizeof(bf16) * ((size_t)BQ * DP + 2 * (size_t)BK * DP + (size_t)BQ * BK) +
         sizeof(float) * ((size_t)BQ * BK + (size_t)BQ * DP + 3 * BQ);
}

template <bool kLse>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                 int T, int NH, int D, int DP, float scale, float clip) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][DP]
  bf16* ks = qs + BQ * DP;                        // [BK][DP]
  bf16* vs = ks + BK * DP;                        // [BK][DP]
  bf16* ps = vs + BK * DP;                        // [BQ][BK] probabilities
  float* ss = reinterpret_cast<float*>(ps + BQ * BK);  // [BQ][BK] scores
  float* os = ss + BQ * BK;                       // [BQ][DP] output accumulator
  float* m_s = os + BQ * DP;                      // [BQ] running max
  float* l_s = m_s + BQ;                          // [BQ] running sum
  float* a_s = l_s + BQ;                          // [BQ] rescale factor

  const int bh = blockIdx.y, b = bh / NH, h = bh % NH;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid / 32;
  const int nt = DP / 16;  // 16-wide column tiles of the output

  load_tile(qs, q, b, h, q0, BQ, T, NH, D, DP);
  for (int e = tid; e < BQ * DP; e += kThreads) os[e] = 0.0f;
  for (int e = tid; e < BQ; e += kThreads) { m_s[e] = kNegInf; l_s[e] = 0.0f; }

  // softmax lanes: 4 consecutive threads per query row, 16 key columns each
  const int srow = tid / 4, spart = tid % 4;

  for (int k0 = 0; k0 < T; k0 += BK) {
    load_tile(ks, k, b, h, k0, BK, T, NH, D, DP);
    load_tile(vs, v, b, h, k0, BK, T, NH, D, DP);
    __syncthreads();

    // S = q k^T: 16 tiles of 16x16, two per warp
    product_abt(ss, BK, qs, ks, BQ, BK, DP, warp, kWarps);
    __syncthreads();

    // online softmax over this key tile
    {
      float sv[16];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int col = spart * 16 + c;
        float s = ss[srow * BK + col] * scale;
        s = fminf(fmaxf(s, -clip), clip);
        if (k0 + col >= T) s = kNegInf;
        sv[c] = s;
        mx = fmaxf(mx, s);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[srow];
      const float m_next = fmaxf(m_prev, mx);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(sv[c] - m_next);
        sum += p;
        ps[srow * BK + spart * 16 + c] = __float2bfloat16(p);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (spart == 0) {
        const float alpha = expf(m_prev - m_next);
        a_s[srow] = alpha;
        l_s[srow] = alpha * l_s[srow] + sum;
        m_s[srow] = m_next;
      }
    }
    __syncthreads();

    for (int e = tid; e < BQ * DP; e += kThreads) os[e] *= a_s[e / DP];
    __syncthreads();

    // O += P v: (BQ/16) x nt output tiles over the warps
    for (int tile = warp; tile < (BQ / 16) * nt; tile += kWarps) {
      const int tr = tile / nt, tc = tile % nt;
      FragC acc;
      wmma::load_matrix_sync(acc, os + tr * 16 * DP + tc * 16, DP, wmma::mem_row_major);
      for (int kk = 0; kk < BK / 16; ++kk) {
        FragA fa;
        FragB fb;
        wmma::load_matrix_sync(fa, ps + tr * 16 * BK + kk * 16, BK);
        wmma::load_matrix_sync(fb, vs + kk * 16 * DP + tc * 16, DP);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(os + tr * 16 * DP + tc * 16, acc, DP, wmma::mem_row_major);
    }
    __syncthreads();  // ks, vs, ps, os settled before the next key tile
  }

  for (int e = tid; e < BQ * D; e += kThreads) {
    const int r = e / D, d = e % D;
    if (q0 + r >= T) continue;
    const float l = l_s[r];
    o[(((size_t)b * T + q0 + r) * NH + h) * D + d] =
        __float2bfloat16(os[r * DP + d] / (l == 0.0f ? 1.0f : l));
  }
  if (kLse) {
    for (int r = tid; r < BQ; r += kThreads) {
      if (q0 + r >= T) continue;
      const float l = l_s[r];
      lse[(size_t)bh * T + q0 + r] = m_s[r] + logf(l == 0.0f ? 1.0f : l);
    }
  }
}

// ---------------------------------------------------------------------------
// K3, fp32
// ---------------------------------------------------------------------------

constexpr int BK32 = 32;                // key rows per tile, fp32 kernels
constexpr int PS = BK32 + 1;            // padded row stride of an fp32 [rows][BK32] tile
constexpr int kColsPerLane = kMaxD / 4;  // output columns a lane accumulates

size_t smem_bytes_f32(int D) {
  return sizeof(float) * ((size_t)(BQ + BK32) * (D + 1) + (size_t)BK32 * D + (size_t)BQ * PS);
}

template <bool kLse>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                     int T, int NH, int D, float scale, float clip) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int DS = D + 1;  // padded row stride of the q and k tiles
  float* qs = reinterpret_cast<float*>(smem_raw);  // [BQ][DS]
  float* ks = qs + BQ * DS;                         // [BK32][DS]
  float* vs = ks + BK32 * DS;                       // [BK32][D]
  float* ps = vs + BK32 * D;                        // [BQ][PS] probabilities

  const int bh = blockIdx.y, b = bh / NH, h = bh % NH;
  const int q0 = blockIdx.x * BQ;
  const int r = threadIdx.x / 4, part = threadIdx.x % 4;

  load_tile_f32(qs, DS, q, b, h, q0, BQ, T, NH, D);
  float acc[kColsPerLane];
#pragma unroll
  for (int i = 0; i < kColsPerLane; ++i) acc[i] = 0.0f;
  float m = kNegInf, l = 0.0f;

  for (int k0 = 0; k0 < T; k0 += BK32) {
    __syncthreads();  // the previous tile's ks, vs and ps are consumed
    load_tile_f32(ks, DS, k, b, h, k0, BK32, T, NH, D);
    load_tile_f32(vs, D, v, b, h, k0, BK32, T, NH, D);
    __syncthreads();

    float s[BK32 / 4];
#pragma unroll
    for (int j = 0; j < BK32 / 4; ++j) s[j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float qd = qs[r * DS + d];
#pragma unroll
      for (int j = 0; j < BK32 / 4; ++j) s[j] = fmaf(qd, ks[(part + 4 * j) * DS + d], s[j]);
    }

    // online softmax of row r over this tile: clamp, then mask keys >= T
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < BK32 / 4; ++j) {
      float x = fminf(fmaxf(s[j] * scale, -clip), clip);
      if (k0 + part + 4 * j >= T) x = kNegInf;
      s[j] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_next = fmaxf(m, mx);
    const float alpha = expf(m - m_next);
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < BK32 / 4; ++j) {
      const float p = expf(s[j] - m_next);
      sum += p;
      ps[r * PS + part + 4 * j] = p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l = alpha * l + sum;
    m = m_next;
    __syncwarp();  // row r's probabilities come from the four lanes of this warp

    // O = alpha * O + P v, in registers
#pragma unroll
    for (int i = 0; i < kColsPerLane; ++i) acc[i] *= alpha;
    for (int c = 0; c < BK32; ++c) {
      const float p = ps[r * PS + c];
      const float* vrow = vs + c * D + part;
#pragma unroll
      for (int i = 0; i < kColsPerLane; ++i)
        if (part + 4 * i < D) acc[i] = fmaf(p, vrow[4 * i], acc[i]);
    }
  }

  if (q0 + r < T) {
    const float div = l == 0.0f ? 1.0f : l;
    float* orow = o + (((size_t)b * T + q0 + r) * NH + h) * D;
#pragma unroll
    for (int i = 0; i < kColsPerLane; ++i)
      if (part + 4 * i < D) orow[part + 4 * i] = acc[i] / div;
    if (kLse && part == 0) lse[(size_t)bh * T + q0 + r] = m + logf(div);
  }
}

// ---------------------------------------------------------------------------
// K4a (dQ), bf16; BKT key rows per tile (64, or 32 above D=192)
// ---------------------------------------------------------------------------

size_t smem_bytes_dq(int BKT, int DP) {
  return sizeof(bf16) * (2 * (size_t)BQ * DP + 2 * (size_t)BKT * DP + (size_t)BQ * BKT) +
         sizeof(float) * (2 * (size_t)BQ * BKT + (size_t)BQ * DP + 2 * BQ);
}

template <int BKT>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ o,
                    const bf16* __restrict__ dout, const float* __restrict__ lse,
                    bf16* __restrict__ dq, int T, int NH, int D, int DP, float scale, float clip) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][DP]
  bf16* dos = qs + BQ * DP;                       // [BQ][DP] dO
  bf16* ks = dos + BQ * DP;                       // [BKT][DP]
  bf16* vs = ks + BKT * DP;                       // [BKT][DP]
  bf16* dss = vs + BKT * DP;                      // [BQ][BKT] dS, bf16
  float* ss = reinterpret_cast<float*>(dss + BQ * BKT);  // [BQ][BKT] S
  float* dps = ss + BQ * BKT;                     // [BQ][BKT] dP
  float* acc_s = dps + BQ * BKT;                  // [BQ][DP] dQ accumulator
  float* lse_s = acc_s + BQ * DP;                 // [BQ]
  float* delta_s = lse_s + BQ;                    // [BQ]

  constexpr int CPL = BKT / 4;  // score columns of each of a row's 4 lanes
  const int bh = blockIdx.y, b = bh / NH, h = bh % NH;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid / 32;
  const int nt = DP / 16;

  load_tile(qs, q, b, h, q0, BQ, T, NH, D, DP);
  load_tile(dos, dout, b, h, q0, BQ, T, NH, D, DP);
  for (int e = tid; e < BQ * DP; e += kThreads) acc_s[e] = 0.0f;
  for (int r = tid; r < BQ; r += kThreads) lse_s[r] = q0 + r < T ? lse[(size_t)bh * T + q0 + r] : 0.0f;
  __syncthreads();
  row_delta(delta_s, dos, o, b, h, q0, BQ, T, NH, D, DP);  // read after the loop's first barrier

  const int srow = tid / 4, spart = tid % 4;
  for (int k0 = 0; k0 < T; k0 += BKT) {
    load_tile(ks, k, b, h, k0, BKT, T, NH, D, DP);
    load_tile(vs, v, b, h, k0, BKT, T, NH, D, DP);
    __syncthreads();

    // S = q k^T and dP = dO v^T
    product_abt(ss, BKT, qs, ks, BQ, BKT, DP, warp, kWarps);
    product_abt(dps, BKT, dos, vs, BQ, BKT, DP, warp, kWarps);
    __syncthreads();

    // dS, gated on the pre-clip z, 0 at keys >= T
    {
      const float lse_r = lse_s[srow], delta_r = delta_s[srow];
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int col = spart * CPL + c, idx = srow * BKT + col;
        const float z = ss[idx] * scale;
        float ds = 0.0f;
        if (k0 + col < T && z >= -clip && z <= clip)
          ds = expf(z - lse_r) * (dps[idx] - delta_r) * scale;
        dss[idx] = __float2bfloat16(ds);
      }
    }
    __syncthreads();

    // dQ += dS K: (BQ/16) x nt tiles over the warps
    for (int tile = warp; tile < (BQ / 16) * nt; tile += kWarps) {
      const int tr = tile / nt, tc = tile % nt;
      FragC acc;
      wmma::load_matrix_sync(acc, acc_s + tr * 16 * DP + tc * 16, DP, wmma::mem_row_major);
      for (int kk = 0; kk < BKT / 16; ++kk) {
        FragA fa;
        FragB fb;
        wmma::load_matrix_sync(fa, dss + tr * 16 * BKT + kk * 16, BKT);
        wmma::load_matrix_sync(fb, ks + kk * 16 * DP + tc * 16, DP);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(acc_s + tr * 16 * DP + tc * 16, acc, DP, wmma::mem_row_major);
    }
    __syncthreads();  // ks, vs, dss, acc_s settled before the next key tile
  }

  for (int e = tid; e < BQ * D; e += kThreads) {
    const int r = e / D, d = e % D;
    if (q0 + r < T) dq[(((size_t)b * T + q0 + r) * NH + h) * D + d] = __float2bfloat16(acc_s[r * DP + d]);
  }
}

// ---------------------------------------------------------------------------
// K4b (dK, dV), bf16; BKV key rows per block (64, or 32 above D=192)
// ---------------------------------------------------------------------------

size_t smem_bytes_dkv(int BKV, int DP) {
  return sizeof(bf16) * (2 * (size_t)BKV * DP + 2 * (size_t)BQ * DP) +
         sizeof(float) * (2 * (size_t)BQ * BKV + 2 * (size_t)BKV * DP + 2 * BQ);
}

template <int BKV>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ o,
                     const bf16* __restrict__ dout, const float* __restrict__ lse,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int T, int NH, int D, int DP,
                     float scale, float clip) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [BKV][DP]
  bf16* vs = ks + BKV * DP;                       // [BKV][DP]
  bf16* qs = vs + BKV * DP;                       // [BQ][DP]
  bf16* dos = qs + BQ * DP;                       // [BQ][DP] dO
  float* ss = reinterpret_cast<float*>(dos + BQ * DP);  // [BQ][BKV] S
  bf16* ps = reinterpret_cast<bf16*>(ss);         // [BQ][BKV] p, over S once S is read
  bf16* dss = ps + BQ * BKV;                      // [BQ][BKV] dS, over S too
  float* dps = ss + BQ * BKV;                     // [BQ][BKV] dP
  float* dk_s = dps + BQ * BKV;                   // [BKV][DP] dK accumulator
  float* dv_s = dk_s + BKV * DP;                  // [BKV][DP] dV accumulator
  float* lse_s = dv_s + BKV * DP;                 // [BQ]
  float* delta_s = lse_s + BQ;                    // [BQ]

  constexpr int CPL = BKV / 4;  // score columns of each of a row's 4 lanes
  const int bh = blockIdx.y, b = bh / NH, h = bh % NH;
  const int kv0 = blockIdx.x * BKV;
  const int tid = threadIdx.x, warp = tid / 32;
  const int nt = DP / 16;
  const int srow = tid / 4, spart = tid % 4;

  load_tile(ks, k, b, h, kv0, BKV, T, NH, D, DP);
  load_tile(vs, v, b, h, kv0, BKV, T, NH, D, DP);
  for (int e = tid; e < BKV * DP; e += kThreads) { dk_s[e] = 0.0f; dv_s[e] = 0.0f; }

  for (int q0 = 0; q0 < T; q0 += BQ) {
    load_tile(qs, q, b, h, q0, BQ, T, NH, D, DP);
    load_tile(dos, dout, b, h, q0, BQ, T, NH, D, DP);
    for (int r = tid; r < BQ; r += kThreads) lse_s[r] = q0 + r < T ? lse[(size_t)bh * T + q0 + r] : 0.0f;
    __syncthreads();

    row_delta(delta_s, dos, o, b, h, q0, BQ, T, NH, D, DP);
    // S = q k^T and dP = dO v^T over this query tile
    product_abt(ss, BKV, qs, ks, BQ, BKV, DP, warp, kWarps);
    product_abt(dps, BKV, dos, vs, BQ, BKV, DP, warp, kWarps);
    __syncthreads();

    // p (0 at rows and keys >= T) and dS, gated on the pre-clip z; into
    // registers first, since their bf16 copies overwrite S
    float pv[CPL], dsv[CPL];
    {
      const float lse_r = lse_s[srow], delta_r = delta_s[srow];
      const bool row_ok = q0 + srow < T;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int col = spart * CPL + c, idx = srow * BKV + col;
        const float z = ss[idx] * scale;
        float p = 0.0f, ds = 0.0f;
        if (row_ok && kv0 + col < T) {
          p = expf(fminf(fmaxf(z, -clip), clip) - lse_r);
          if (z >= -clip && z <= clip) ds = p * (dps[idx] - delta_r) * scale;
        }
        pv[c] = p;
        dsv[c] = ds;
      }
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int idx = srow * BKV + spart * CPL + c;
      ps[idx] = __float2bfloat16(pv[c]);
      dss[idx] = __float2bfloat16(dsv[c]);
    }
    __syncthreads();

    // dV += p^T dO and dK += dS^T q: 2 x (BKV/16) x nt tiles over the warps;
    // p^T and dS^T are read as column-major views of the [BQ][BKV] tiles
    for (int tile = warp; tile < 2 * (BKV / 16) * nt; tile += kWarps) {
      const bool is_k = tile >= (BKV / 16) * nt;
      const int t = is_k ? tile - (BKV / 16) * nt : tile;
      const int tr = t / nt, tc = t % nt;
      const bf16* a = is_k ? dss : ps;
      const bf16* bm = is_k ? qs : dos;
      float* out = (is_k ? dk_s : dv_s) + tr * 16 * DP + tc * 16;
      FragC acc;
      wmma::load_matrix_sync(acc, out, DP, wmma::mem_row_major);
      for (int kk = 0; kk < BQ / 16; ++kk) {
        FragAT fa;
        FragB fb;
        wmma::load_matrix_sync(fa, a + kk * 16 * BKV + tr * 16, BKV);
        wmma::load_matrix_sync(fb, bm + kk * 16 * DP + tc * 16, DP);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(out, acc, DP, wmma::mem_row_major);
    }
    __syncthreads();  // qs, dos, ps, dss consumed before the next query tile
  }

  for (int e = tid; e < BKV * D; e += kThreads) {
    const int r = e / D, d = e % D;
    if (kv0 + r >= T) continue;
    const size_t at = (((size_t)b * T + kv0 + r) * NH + h) * D + d;
    dk[at] = __float2bfloat16(dk_s[r * DP + d]);
    dv[at] = __float2bfloat16(dv_s[r * DP + d]);
  }
}

// ---------------------------------------------------------------------------
// K4a and K4b, fp32 (CUDA cores)
// ---------------------------------------------------------------------------

size_t smem_bytes_dq_f32(int D) {
  return sizeof(float) * (2 * (size_t)(BQ + BK32) * (D + 1) + (size_t)BQ * PS);
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ o,
                        const float* __restrict__ dout, const float* __restrict__ lse,
                        float* __restrict__ dq, int T, int NH, int D, float scale, float clip) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int DS = D + 1;
  float* qs = reinterpret_cast<float*>(smem_raw);  // [BQ][DS]
  float* dos = qs + BQ * DS;                        // [BQ][DS] dO
  float* ks = dos + BQ * DS;                        // [BK32][DS]
  float* vs = ks + BK32 * DS;                       // [BK32][DS]
  float* dss = vs + BK32 * DS;                      // [BQ][PS] dS

  const int bh = blockIdx.y, b = bh / NH, h = bh % NH;
  const int q0 = blockIdx.x * BQ;
  const int r = threadIdx.x / 4, part = threadIdx.x % 4;
  const bool row_ok = q0 + r < T;

  load_tile_f32(qs, DS, q, b, h, q0, BQ, T, NH, D);
  load_tile_f32(dos, DS, dout, b, h, q0, BQ, T, NH, D);
  __syncthreads();
  float delta = 0.0f;
  if (row_ok) {
    const float* orow = o + (((size_t)b * T + q0 + r) * NH + h) * D;
    for (int d = part; d < D; d += 4) delta += dos[r * DS + d] * orow[d];
  }
  delta += __shfl_xor_sync(0xffffffffu, delta, 1);
  delta += __shfl_xor_sync(0xffffffffu, delta, 2);
  const float lse_r = row_ok ? lse[(size_t)bh * T + q0 + r] : 0.0f;

  float acc[kColsPerLane];
#pragma unroll
  for (int i = 0; i < kColsPerLane; ++i) acc[i] = 0.0f;

  for (int k0 = 0; k0 < T; k0 += BK32) {
    __syncthreads();  // the previous tile's ks, vs and dss are consumed
    load_tile_f32(ks, DS, k, b, h, k0, BK32, T, NH, D);
    load_tile_f32(vs, DS, v, b, h, k0, BK32, T, NH, D);
    __syncthreads();

    float s[BK32 / 4], dp[BK32 / 4];
#pragma unroll
    for (int j = 0; j < BK32 / 4; ++j) s[j] = dp[j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float qd = qs[r * DS + d], gd = dos[r * DS + d];
#pragma unroll
      for (int j = 0; j < BK32 / 4; ++j) {
        s[j] = fmaf(qd, ks[(part + 4 * j) * DS + d], s[j]);
        dp[j] = fmaf(gd, vs[(part + 4 * j) * DS + d], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < BK32 / 4; ++j) {
      const float z = s[j] * scale;
      float ds = 0.0f;
      if (k0 + part + 4 * j < T && z >= -clip && z <= clip)
        ds = expf(z - lse_r) * (dp[j] - delta) * scale;
      dss[r * PS + part + 4 * j] = ds;
    }
    __syncwarp();  // row r's dS comes from the four lanes of this warp

    for (int c = 0; c < BK32; ++c) {
      const float g = dss[r * PS + c];
      const float* krow = ks + c * DS + part;
#pragma unroll
      for (int i = 0; i < kColsPerLane; ++i)
        if (part + 4 * i < D) acc[i] = fmaf(g, krow[4 * i], acc[i]);
    }
  }

  if (row_ok) {
    float* out = dq + (((size_t)b * T + q0 + r) * NH + h) * D;
#pragma unroll
    for (int i = 0; i < kColsPerLane; ++i)
      if (part + 4 * i < D) out[part + 4 * i] = acc[i];
  }
}

constexpr int kColsPerLane8 = kMaxD / 8;  // dK / dV columns a lane accumulates

size_t smem_bytes_dkv_f32(int D) {
  return sizeof(float) * (2 * (size_t)(BK32 + BQ) * (D + 1) + 2 * (size_t)BQ * PS);
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ o,
                         const float* __restrict__ dout, const float* __restrict__ lse,
                         float* __restrict__ dk, float* __restrict__ dv, int T, int NH, int D,
                         float scale, float clip) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int DS = D + 1;
  float* ks = reinterpret_cast<float*>(smem_raw);  // [BK32][DS]
  float* vs = ks + BK32 * DS;                       // [BK32][DS]
  float* qs = vs + BK32 * DS;                       // [BQ][DS]
  float* dos = qs + BQ * DS;                        // [BQ][DS] dO
  float* ps = dos + BQ * DS;                        // [BQ][PS] p
  float* dss = ps + BQ * PS;                        // [BQ][PS] dS

  const int bh = blockIdx.y, b = bh / NH, h = bh % NH;
  const int kv0 = blockIdx.x * BK32;
  // score step: 4 lanes per query row r; accumulation step: 8 lanes per key row
  const int r = threadIdx.x / 4, part = threadIdx.x % 4;
  const int key = threadIdx.x / 8, cpart = threadIdx.x % 8;

  load_tile_f32(ks, DS, k, b, h, kv0, BK32, T, NH, D);
  load_tile_f32(vs, DS, v, b, h, kv0, BK32, T, NH, D);
  float dk_acc[kColsPerLane8], dv_acc[kColsPerLane8];
#pragma unroll
  for (int i = 0; i < kColsPerLane8; ++i) dk_acc[i] = dv_acc[i] = 0.0f;

  for (int q0 = 0; q0 < T; q0 += BQ) {
    __syncthreads();  // the previous query tile's qs, dos, ps and dss are consumed
    load_tile_f32(qs, DS, q, b, h, q0, BQ, T, NH, D);
    load_tile_f32(dos, DS, dout, b, h, q0, BQ, T, NH, D);
    __syncthreads();

    const bool row_ok = q0 + r < T;
    float delta = 0.0f;
    if (row_ok) {
      const float* orow = o + (((size_t)b * T + q0 + r) * NH + h) * D;
      for (int d = part; d < D; d += 4) delta += dos[r * DS + d] * orow[d];
    }
    delta += __shfl_xor_sync(0xffffffffu, delta, 1);
    delta += __shfl_xor_sync(0xffffffffu, delta, 2);
    const float lse_r = row_ok ? lse[(size_t)bh * T + q0 + r] : 0.0f;

    float s[BK32 / 4], dp[BK32 / 4];
#pragma unroll
    for (int j = 0; j < BK32 / 4; ++j) s[j] = dp[j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float qd = qs[r * DS + d], gd = dos[r * DS + d];
#pragma unroll
      for (int j = 0; j < BK32 / 4; ++j) {
        s[j] = fmaf(qd, ks[(part + 4 * j) * DS + d], s[j]);
        dp[j] = fmaf(gd, vs[(part + 4 * j) * DS + d], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < BK32 / 4; ++j) {
      const float z = s[j] * scale;
      float p = 0.0f, ds = 0.0f;
      if (row_ok && kv0 + part + 4 * j < T) {
        p = expf(fminf(fmaxf(z, -clip), clip) - lse_r);
        if (z >= -clip && z <= clip) ds = p * (dp[j] - delta) * scale;
      }
      ps[r * PS + part + 4 * j] = p;
      dss[r * PS + part + 4 * j] = ds;
    }
    __syncthreads();

    // dV[key] += sum_r p[r, key] dO[r], dK[key] += sum_r dS[r, key] q[r]
    for (int rr = 0; rr < BQ; ++rr) {
      const float p = ps[rr * PS + key], g = dss[rr * PS + key];
      const float* dorow = dos + rr * DS + cpart;
      const float* qrow = qs + rr * DS + cpart;
#pragma unroll
      for (int i = 0; i < kColsPerLane8; ++i) {
        if (cpart + 8 * i < D) {
          dv_acc[i] = fmaf(p, dorow[8 * i], dv_acc[i]);
          dk_acc[i] = fmaf(g, qrow[8 * i], dk_acc[i]);
        }
      }
    }
  }

  if (kv0 + key < T) {
    const size_t at = (((size_t)b * T + kv0 + key) * NH + h) * D;
#pragma unroll
    for (int i = 0; i < kColsPerLane8; ++i) {
      if (cpart + 8 * i < D) {
        dk[at + cpart + 8 * i] = dk_acc[i];
        dv[at + cpart + 8 * i] = dv_acc[i];
      }
    }
  }
}

bool bad_shape(int B, int T, int NH, int D) {
  return B <= 0 || T <= 0 || NH <= 0 || D <= 0 || D > kMaxD || B * NH > 65535;
}

// Set the kernel's dynamic shared memory and launch it on `stream`.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, size_t smem, void* stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K3, bf16 q, k, v, o; lse (B, NH, T) fp32, or null for none. Launch on
// `stream`. Returns 0 or a cudaError_t code (as every function below).
int flash_attention_clamped_forward(const void* q, const void* k, const void* v, void* o,
                                    void* lse, int B, int T, int NH, int D, float scale,
                                    float clip, void* stream) {
  if (bad_shape(B, T, NH, D)) return cudaErrorInvalidValue;
  const int DP = (D + 15) / 16 * 16;
  const dim3 grid((T + BQ - 1) / BQ, B * NH);
  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp = static_cast<const bf16*>(v);
  auto* op = static_cast<bf16*>(o);
  auto* lp = static_cast<float*>(lse);
  if (lse)
    return launch(flash_fwd_kernel<true>, grid, smem_bytes(DP), stream, qp, kp, vp, op, lp, T, NH,
                  D, DP, scale, clip);
  return launch(flash_fwd_kernel<false>, grid, smem_bytes(DP), stream, qp, kp, vp, op, lp, T, NH,
                D, DP, scale, clip);
}

// K3, fp32 q, k, v, o; lse as above.
int flash_attention_clamped_forward_f32(const void* q, const void* k, const void* v, void* o,
                                        void* lse, int B, int T, int NH, int D, float scale,
                                        float clip, void* stream) {
  if (bad_shape(B, T, NH, D)) return cudaErrorInvalidValue;
  const dim3 grid((T + BQ - 1) / BQ, B * NH);
  const auto* qp = static_cast<const float*>(q);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  auto* op = static_cast<float*>(o);
  auto* lp = static_cast<float*>(lse);
  if (lse)
    return launch(flash_fwd_f32_kernel<true>, grid, smem_bytes_f32(D), stream, qp, kp, vp, op, lp,
                  T, NH, D, scale, clip);
  return launch(flash_fwd_f32_kernel<false>, grid, smem_bytes_f32(D), stream, qp, kp, vp, op, lp,
                T, NH, D, scale, clip);
}

// K4a: dq from q, k, v, o, dout (bf16) and lse (fp32).
int flash_attention_clamped_backward_dq(const void* q, const void* k, const void* v,
                                        const void* o, const void* dout, const void* lse,
                                        void* dq, int B, int T, int NH, int D, float scale,
                                        float clip, void* stream) {
  if (bad_shape(B, T, NH, D)) return cudaErrorInvalidValue;
  const int DP = (D + 15) / 16 * 16;
  const dim3 grid((T + BQ - 1) / BQ, B * NH);
  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp = static_cast<const bf16*>(v);
  const auto* op = static_cast<const bf16*>(o);
  const auto* gp = static_cast<const bf16*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  auto* dqp = static_cast<bf16*>(dq);
  if (smem_bytes_dq(64, DP) <= (size_t)kSmemLimit)
    return launch(flash_bwd_dq_kernel<64>, grid, smem_bytes_dq(64, DP), stream, qp, kp, vp, op,
                  gp, lp, dqp, T, NH, D, DP, scale, clip);
  return launch(flash_bwd_dq_kernel<32>, grid, smem_bytes_dq(32, DP), stream, qp, kp, vp, op, gp,
                lp, dqp, T, NH, D, DP, scale, clip);
}

// K4b: dk, dv from q, k, v, o, dout (bf16) and lse (fp32).
int flash_attention_clamped_backward_dkv(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const void* lse,
                                         void* dk, void* dv, int B, int T, int NH, int D,
                                         float scale, float clip, void* stream) {
  if (bad_shape(B, T, NH, D)) return cudaErrorInvalidValue;
  const int DP = (D + 15) / 16 * 16;
  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp = static_cast<const bf16*>(v);
  const auto* op = static_cast<const bf16*>(o);
  const auto* gp = static_cast<const bf16*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  auto* dkp = static_cast<bf16*>(dk);
  auto* dvp = static_cast<bf16*>(dv);
  if (smem_bytes_dkv(64, DP) <= (size_t)kSmemLimit)
    return launch(flash_bwd_dkv_kernel<64>, dim3((T + 63) / 64, B * NH), smem_bytes_dkv(64, DP),
                  stream, qp, kp, vp, op, gp, lp, dkp, dvp, T, NH, D, DP, scale, clip);
  return launch(flash_bwd_dkv_kernel<32>, dim3((T + 31) / 32, B * NH), smem_bytes_dkv(32, DP),
                stream, qp, kp, vp, op, gp, lp, dkp, dvp, T, NH, D, DP, scale, clip);
}

// K4a, fp32.
int flash_attention_clamped_backward_dq_f32(const void* q, const void* k, const void* v,
                                            const void* o, const void* dout, const void* lse,
                                            void* dq, int B, int T, int NH, int D, float scale,
                                            float clip, void* stream) {
  if (bad_shape(B, T, NH, D)) return cudaErrorInvalidValue;
  return launch(flash_bwd_dq_f32_kernel, dim3((T + BQ - 1) / BQ, B * NH), smem_bytes_dq_f32(D),
                stream, static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<const float*>(o),
                static_cast<const float*>(dout), static_cast<const float*>(lse),
                static_cast<float*>(dq), T, NH, D, scale, clip);
}

// K4b, fp32.
int flash_attention_clamped_backward_dkv_f32(const void* q, const void* k, const void* v,
                                             const void* o, const void* dout, const void* lse,
                                             void* dk, void* dv, int B, int T, int NH, int D,
                                             float scale, float clip, void* stream) {
  if (bad_shape(B, T, NH, D)) return cudaErrorInvalidValue;
  return launch(flash_bwd_dkv_f32_kernel, dim3((T + BK32 - 1) / BK32, B * NH),
                smem_bytes_dkv_f32(D), stream, static_cast<const float*>(q),
                static_cast<const float*>(k), static_cast<const float*>(v),
                static_cast<const float*>(o), static_cast<const float*>(dout),
                static_cast<const float*>(lse), static_cast<float*>(dk), static_cast<float*>(dv),
                T, NH, D, scale, clip);
}

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
