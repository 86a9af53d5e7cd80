// K3: clamped flash attention, forward only; bf16 in / bf16 out, or fp32 in /
// fp32 out (compute_dtype="float32").
//
// Replaces music_transcription_tpu/ops/attention_pallas.py:
// flash_attention_clamped -> _fwd_call -> _flash_kernel (forward, no lse).
//
//   q, k, v, o  (B, T, NH, D) bf16 or fp32, contiguous
//   o[b, t, h] = softmax_s( clip(q[b,t,h] . k[b,s,h] * scale, -clip, +clip) ) @ v[b,:,h]
//
// What bounds it on the H100. 4 * B*NH * T^2 * D operations (0.35 TFLOP at
// B*NH=32, T=3751, D=192: 0.35 ms at the 989 TFLOP/s bf16 tensor-core rate)
// against 4 * B*T*NH*D * 2 bytes of q, k, v and o (184 MB there: 55 us at
// 3.35 TB/s). It is bound by operations: the matrix products have to run on
// the tensor cores, and the (T x T) scores must never reach device memory
// (the fp32 score tensor alone is 1.8 GB at that shape).
//
// Design. One block of 8 warps per (batch*head, tile of 64 query rows):
//   * the q tile stays in shared memory; key/value tiles of 64 rows stream
//     through shared memory; scores S = q k^T and the update O += P v run on
//     the tensor cores through WMMA (bf16 16x16x16 fragments, fp32
//     accumulation);
//   * the softmax is the online one, in fp32: per row a running max m and
//     sum l; the clamp is applied to the scaled fp32 scores, and keys >= T
//     are set to -1e9 AFTER the clamp (clamping afterwards would bring them
//     back at -clip), as the Pallas kernel does;
//   * P is cast to bf16 before P v, as the Pallas kernel casts p to v's type;
//   * the fp32 output accumulator lives in shared memory, rescaled by
//     exp(m_old - m_new) before each update; the store divides by l, with
//     l = 0 guarded;
//   * head_dim is padded to a multiple of 16 inside shared memory (192 needs
//     no padding); padded q/k columns are zero and add nothing to S.
// Shared memory: 148 KB at D=192, so one block per SM.
//
// fp32 inputs (flash_fwd_f32_kernel). The tensor cores take no full-fp32
// operands, so every product is an fp32 FMA on the CUDA cores: 67 TFLOP/s
// at most, and the loop reads one shared-memory operand per FMA, which caps
// it lower. One block of 256 threads per (batch*head, 64 query rows), key /
// value tiles of 32 rows. Four consecutive lanes share a query row: each
// computes the scores of key columns part, part+4, ..., keeps the row's
// online max and sum in registers (joined by shuffles), and accumulates
// output columns part, part+4, ... in registers. Rows of the q and k tiles
// are padded by one word so the lanes of a warp read distinct banks.

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
constexpr float kNegInf = -1e9f;

size_t smem_bytes(int DP) {
  return sizeof(bf16) * ((size_t)BQ * DP + 2 * (size_t)BK * DP + (size_t)BQ * BK) +
         sizeof(float) * ((size_t)BQ * BK + (size_t)BQ * DP + 3 * BQ);
}

// Copy rows [t0, t0+64) of head h of batch b into a [64][DP] shared tile,
// zero-filling rows >= T and columns >= D.
__device__ void load_tile(bf16* dst, const bf16* __restrict__ src, int b, int h, int t0, int T,
                          int NH, int D, int DP) {
  if (D % 8 == 0) {
    const int vpr = DP / 8;  // 16-byte vectors per shared row
    for (int e = threadIdx.x; e < BQ * vpr; e += kThreads) {
      const int r = e / vpr, d = (e % vpr) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (t0 + r < T && d < D)
        val = __ldg(reinterpret_cast<const uint4*>(src + (((size_t)b * T + t0 + r) * NH + h) * D + d));
      *reinterpret_cast<uint4*>(dst + r * DP + d) = val;
    }
  } else {
    for (int e = threadIdx.x; e < BQ * DP; e += kThreads) {
      const int r = e / DP, d = e % DP;
      bf16 val = __float2bfloat16(0.0f);
      if (t0 + r < T && d < D) val = src[(((size_t)b * T + t0 + r) * NH + h) * D + d];
      dst[r * DP + d] = val;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int T, int NH, int D, int DP,
                 float scale, float clip) {
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

  load_tile(qs, q, b, h, q0, T, NH, D, DP);
  for (int e = tid; e < BQ * DP; e += kThreads) os[e] = 0.0f;
  for (int e = tid; e < BQ; e += kThreads) { m_s[e] = kNegInf; l_s[e] = 0.0f; }

  // softmax lanes: 4 consecutive threads per query row, 16 key columns each
  const int srow = tid / 4, spart = tid % 4;

  for (int k0 = 0; k0 < T; k0 += BK) {
    load_tile(ks, k, b, h, k0, T, NH, D, DP);
    load_tile(vs, v, b, h, k0, T, NH, D, DP);
    __syncthreads();

    // S = q k^T: 16 tiles of 16x16, two per warp
    for (int tile = warp; tile < (BQ / 16) * (BK / 16); tile += kWarps) {
      const int tr = tile / (BK / 16), tc = tile % (BK / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
      for (int kk = 0; kk < nt; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, qs + tr * 16 * DP + kk * 16, DP);
        wmma::load_matrix_sync(fb, ks + tc * 16 * DP + kk * 16, DP);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(ss + tr * 16 * BK + tc * 16, acc, BK, wmma::mem_row_major);
    }
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
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, os + tr * 16 * DP + tc * 16, DP, wmma::mem_row_major);
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
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
}

constexpr int BK32 = 32;                // key rows per tile, fp32 kernel
constexpr int kColsPerLane = kMaxD / 4;  // output columns a lane accumulates

size_t smem_bytes_f32(int D) {
  return sizeof(float) * ((size_t)(BQ + BK32) * (D + 1) + (size_t)BK32 * D + (size_t)BQ * (BK32 + 1));
}

// Rows [t0, t0+rows) of head h of batch b into a [rows][stride] shared tile,
// zero-filling rows >= T.
__device__ void load_tile_f32(float* dst, int stride, const float* __restrict__ src, int b, int h,
                              int t0, int rows, int T, int NH, int D) {
  for (int e = threadIdx.x; e < rows * D; e += kThreads) {
    const int r = e / D, d = e % D;
    dst[r * stride + d] = t0 + r < T ? src[(((size_t)b * T + t0 + r) * NH + h) * D + d] : 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int T, int NH, int D,
                     float scale, float clip) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int DS = D + 1;  // padded row stride of the q and k tiles
  constexpr int PS = BK32 + 1;
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
  }
}

}  // namespace

extern "C" {

// bf16 q, k, v, o. Launch on `stream`. Returns 0 or a cudaError_t code.
int flash_attention_clamped_forward(const void* q, const void* k, const void* v, void* o, int B,
                                    int T, int NH, int D, float scale, float clip,
                                    void* stream) {
  if (B <= 0 || T <= 0 || NH <= 0 || D <= 0 || D > kMaxD || B * NH > 65535)
    return cudaErrorInvalidValue;
  const int DP = (D + 15) / 16 * 16;
  const size_t smem = smem_bytes(DP);
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((T + BQ - 1) / BQ, B * NH);
  flash_fwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), T, NH, D, DP, scale, clip);
  return cudaGetLastError();
}

// fp32 q, k, v, o. Launch on `stream`. Returns 0 or a cudaError_t code.
int flash_attention_clamped_forward_f32(const void* q, const void* k, const void* v, void* o,
                                        int B, int T, int NH, int D, float scale, float clip,
                                        void* stream) {
  if (B <= 0 || T <= 0 || NH <= 0 || D <= 0 || D > kMaxD || B * NH > 65535)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes_f32(D);
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_f32_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((T + BQ - 1) / BQ, B * NH);
  flash_fwd_f32_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), T, NH, D, scale, clip);
  return cudaGetLastError();
}

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
