// The fused-direction LSTM recurrence, fp32: forward (K1), forward with the
// cell-state sequence for training (K2a) and backward through time (K2b).
//
// Replaces music_transcription_tpu/ops/lstm_pallas.py:
//   K1  lstm_recurrence_pallas -> _recurrence_kernel        (lstm_pallas.py:71)
//   K2a _lstm_recurrence_fwd_impl -> _recurrence_fwd_kernel (lstm_pallas.py:128)
//   K2b _lstm_recurrence_bwd -> _recurrence_bwd_kernel      (lstm_pallas.py:147)
//
//   xw  (2B, T, 4H)  input projections; rows [0,B) forward direction,
//                    rows [B,2B) backward direction already time-reversed
//   wh  (2, H, 4H)   recurrent weights of the two directions
//   h   (2B, T, H)   hidden states;  c (2B, T, H) cell states (K2a)
//   per step t, torch gate order (i, f, g, o), zero initial state:
//     gates = xw[:, t] + blockdiag(h_{t-1}) . wh
//     c = sig(f) c + sig(i) tanh(g);  h = sig(o) tanh(c)
//   K2b walks t = T-1 .. 0 with the carries dh, dc (zero at T-1):
//     dh_t' = dh[:, t] + dh_carry;  dc_t' = dh_t' sig(o) (1 - tanh(c_t)^2) + dc_carry
//     dgates = (dc_t' tanh(g) i(1-i), dc_t' c_{t-1} f(1-f), dc_t' i (1-g^2), dh_t' tanh(c_t) o(1-o))
//     dxw[:, t] = dgates;  dh_carry = blockdiag(dgates) . wh^T;  dc_carry = dc_t' f
//   (dW_hh = sum_t h_{t-1}^T dgates_t has no sequential dependence and is one
//   matrix product outside the kernel, as in the JAX package.)
//
// What bounds it on the H100. The roofline: the forward does 2 * 2B * T * H
// * 4H fp32 operations (94.4 GFLOP at 2B=48, T=938, H=512: 1.41 ms at the
// 67 TFLOP/s fp32 rate; 0.235 ms at 2B=8) against some 370 MB of xw, h and c
// (0.11 ms at 3.35 TB/s); the backward twice the operations (the gate
// product is recomputed, and dh_carry is a second product of the same
// size). But the T steps are strictly sequential and each needs all of
// h_{t-1} (forward) or dgates_{t+1} (backward) of its direction: the second
// floor is T exchanges between the blocks of a direction.
// `lstm_recurrence_floor` measures it: the same grid doing nothing but its T
// barriers (chip_smoke.py prints it as floor_ms beside each kernel).
//
// Design. One persistent cooperative launch; the launch checks with the
// occupancy API that every block is resident, which the hand-made barrier
// needs.
//   * block = (direction, U consecutive hidden units): it owns the 4U gate
//     columns {i,f,g,o} x units, so the cell update (forward) and dgates
//     (backward) need no data from other blocks. At H=512, U=8: 128 blocks
//     of 256 threads, one per SM; at H=256, U=4.
//   * A barrier per direction instead of a grid-wide one: a monotone arrive
//     counter per direction in device memory (zeroed by the wrapper), one
//     red.release.gpu per block and step after a __syncthreads, spun on by
//     one thread with ld.acquire.gpu. The directions never exchange data, so
//     each 64 blocks wait only for each other.
//   * The gate product over all rows of the direction in one pass per step
//     (rows are walked in passes only where the shared memory cannot hold
//     them all: at H=512, 2B above some 140 in the forward, above 48 in
//     K2b), register-blocked: the block's
//     W_hh column slice (H x 4U, 64 KB at U=8) lives in registers, 64 floats
//     a thread (the persistent-RNN layout). A thread owns 4 columns and
//     H / (256 / U) rows of k, interleaved by 4; h_{t-1} is staged by
//     cp.async into shared memory and read as 16-byte loads, which the 8
//     threads of a k group share as one broadcast: 16 FMAs per shared load,
//     4 rows at a time. The k groups of a warp are summed by a
//     reduce-scatter of shuffles (3 for 4 columns), the 8 warps once per row
//     through shared memory. Sums therefore run in another order than the
//     old one-warp-per-slice kernel and than the plain version (fp32, within
//     the unchanged 1e-4 tolerances).
//   * The cell update is spread over all threads: one thread per (row, gate
//     column) sums its 8 warp partials, adds xw and applies its activation;
//     the four gates of a unit sit in four neighbouring lanes and meet by
//     shuffles.
//   * Loads that do not depend on the previous step go out before the
//     barrier wait: xw_t (and in K2b c_t, c_{t-1}, dh_t and the h_{t-1} rows
//     of the gate recompute) by cp.async into shared memory, double-buffered
//     where the previous step still reads them. Only the exchanged tensor
//     stays on the critical path: h_{t-1} (forward), dgates_{t+1} (backward).
//   * K2b: the gate recompute (phase 1) needs only inputs, so it runs before
//     the barrier wait; after it, the dh product (phase 2) streams the
//     direction's dgates_{t+1} rows from L2 through a double-buffered
//     cp.async ring of 8 rows, while the block's W_hh rows (U x 4H, 64 KB at
//     U=8) sit in registers beside the column slice: 8 k a thread, 64 FMAs
//     per two 16-byte shared loads, 2 rows at a time, a reduce-scatter over
//     the warp and one sum over the 8 warps. dgates_t go to dxw, as before;
//     no atomics, so every launch gives the same bits.
//   * fp32 on the CUDA cores, no TF32 anywhere. Both products were also
//     written as mma.sync m16n8k8 with the error-compensated 3xTF32 split
//     (within the tolerances); with the A operand split per element and both
//     weight slices held in registers they spilled and ran slower than
//     these CUDA-core loops on the H100, so they were not kept.
//   * K2a is K1 with one more store per unit and step: c_t, for the backward.
// Shapes: any even 2B (while a pass of the rows fits in shared memory), any
// T; H up to 512 where the grid takes 8 units a block (H / 8 blocks per
// direction), up to 1024 with 4 units, and for K2b up to 256 with 1 or 2
// units (every H the port runs is at most 512). Other shapes return
// kNotTaken, which the wrapper raises as ValueError.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;        // rows of the gate product's register tile
constexpr int kRing = 8;        // rows of dgates per stage of K2b's cp.async ring
constexpr int kStages = 2;      // stages of the ring
constexpr int kDhRows = 2;      // rows of the dh product's register tile
constexpr int kCounterStride = 32;  // the two directions' counters, 128 bytes apart
constexpr int kNotTaken = -1;   // a shape the kernels do not take

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

template <int U>
struct Shape {
  static_assert(U == 1 || U == 2 || U == 4 || U == 8, "U is 1, 2, 4 or 8");
  static constexpr int C = 4 * U;            // gate columns of a block
  static constexpr int KQ = 32 / U;          // k groups in a warp (lane = kq * U + cg)
  static constexpr int NKG = kWarps * KQ;    // k groups in the block
  static constexpr int KSTEP = 4 * NKG;      // k covered by one 4-chunk of every thread
  static constexpr int KCH = U >= 4 ? 4 : U; // most 4-chunks of k a thread holds: H <= KCH * KSTEP
  // most 4-chunks of 4H (stride 1024) a thread holds: H <= 256 KCC; one where
  // U <= 2, whose grids may need two blocks an SM (128 registers a thread)
  static constexpr int KCC = U == 8 ? 2 : U == 4 ? 4 : 1;
  static constexpr int LOG_U = U == 8 ? 3 : U == 4 ? 2 : U == 2 ? 1 : 0;
};

template <int U>
__host__ __device__ constexpr int gate_chunks(int H) { return (H + Shape<U>::KSTEP - 1) / Shape<U>::KSTEP; }
__host__ __device__ constexpr int row_chunks(int H) { return (4 * H + 1023) / 1024; }

// ---- asynchronous copies and the per-direction barrier --------------------

__device__ __forceinline__ unsigned shared_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes, through L2 only (never a stale L1 line of another SM's writes)
__device__ __forceinline__ void copy16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(shared_address(dst)), "l"(src)
               : "memory");
}
// 4 bytes of a read-only input
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(shared_address(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void commit_copies() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// After a __syncthreads that follows the block's stores of this step.
__device__ __forceinline__ void arrive(unsigned* counter) {
  if (threadIdx.x == 0) asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(counter) : "memory");
}

// Until `target` arrivals are counted; ends with a __syncthreads. A wait of
// some seconds means a broken grid: trap rather than hang the card.
__device__ __forceinline__ void wait_for(const unsigned* counter, unsigned target) {
  if (threadIdx.x == 0) {
    unsigned seen, spins = 0;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(seen) : "l"(counter) : "memory");
      if (++spins == (1u << 26)) __trap();
    } while (seen < target);
  }
  __syncthreads();
}

// Rows [0, nr) of H floats, row r at src + r * stride, into dst (row stride
// ds): cp.async when 16-byte aligned, else plain L2 loads.
__device__ __forceinline__ void stage_rows(float* dst, int ds, const float* src, size_t stride,
                                           int nr, int H) {
  if ((H & 3) == 0) {
    const int q = H >> 2;
    for (int e = threadIdx.x; e < nr * q; e += kThreads) {
      const int r = e / q, k = (e - r * q) * 4;
      copy16(dst + r * ds + k, src + r * stride + k);
    }
  } else {
    for (int e = threadIdx.x; e < nr * H; e += kThreads) {
      const int r = e / H, k = e - r * H;
      dst[r * ds + k] = __ldcg(src + r * stride + k);
    }
  }
}

// xw of step t for the block's columns, all B rows: xs[r][u * 4 + g].
template <int U>
__device__ __forceinline__ void prefetch_xw(float* xs, const float* xwd, int B, int T, int H, int j0,
                                            int t) {
  constexpr int C = Shape<U>::C;
  for (int e = threadIdx.x; e < B * C; e += kThreads) {
    const int r = e / C, q = e - r * C, g = q / U, u = q - g * U;
    copy4(xs + r * C + u * 4 + g, xwd + ((size_t)r * T + t) * 4 * H + g * H + j0 + u);
  }
}

// ---- the register-blocked products -------------------------------------------

// Sum N values a lane holds over the warp's lanes that differ in bits
// [STOP, 16] of the lane index; returns one sum a lane: the value of index
// (lane >> (5 - log2 N)) & (N - 1), summed over those lanes. The first
// log2 N rounds halve the values each (a reduce-scatter), the rest add.
template <int N, int STOP>
__device__ __forceinline__ float reduce_scatter(float (&a)[N], int lane) {
  int mask = 16;
#pragma unroll
  for (int half = N / 2; half >= 1; half /= 2, mask /= 2) {
    const bool up = lane & mask;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = up ? a[i] : a[i + half];
      a[i] = (up ? a[i + half] : a[i]) + __shfl_xor_sync(0xffffffffu, send, mask);
    }
  }
  float v = a[0];
#pragma unroll
  for (int m = 16 / N; m >= STOP; m /= 2) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// The block's W_hh column slice: w[i][j][c] = wh_d[k][gate * H + j0 + unit]
// for k = i * KSTEP + kg * 4 + j, gate column cc = cg * 4 + c (gate cc / U,
// unit cc % U); zero past H.
template <int U>
__device__ __forceinline__ void load_gate_columns(float (&w)[Shape<U>::KCH][4][4], const float* whd,
                                                  int H, int j0) {
  using S = Shape<U>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cg = lane % U, kg = warp * S::KQ + lane / U;
#pragma unroll
  for (int i = 0; i < S::KCH; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int k = i * S::KSTEP + kg * 4 + j, cc = cg * 4 + c;
        w[i][j][c] = k < H ? __ldg(whd + (size_t)k * 4 * H + (cc / U) * H + j0 + cc % U) : 0.0f;
      }
}

// part[warp][r][unit * 4 + gate] = the warp's share of h[r] . W[:, column],
// for rows [0, nr) of hs (row stride HS, zero past H). Rows are taken kRows
// at a time; rows past nr up to the next multiple compute and are dropped.
template <int U>
__device__ __forceinline__ void gate_product(const float (&w)[Shape<U>::KCH][4][4], const float* hs,
                                             int HS, int nr, int kc, float* part, int PR) {
  using S = Shape<U>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cg = lane % U, kg = warp * S::KQ + lane / U;
  const int cc = cg * 4 + (lane >> 3);            // the column this lane ends with
  const int slot = (cc % U) * 4 + cc / U;
  const bool writer = (lane & 7 & ~(U - 1)) == 0;  // one lane of each set holding the same sum
  for (int r0 = 0; r0 < nr; r0 += kRows) {
    float acc[kRows][4];
#pragma unroll
    for (int m = 0; m < kRows; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[m][c] = 0.0f;
#pragma unroll
    for (int i = 0; i < S::KCH; ++i) {
      if (i < kc) {
#pragma unroll
        for (int m = 0; m < kRows; ++m) {
          const float4 h = *reinterpret_cast<const float4*>(hs + (r0 + m) * HS + i * S::KSTEP + kg * 4);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[m][c] = fmaf(h.x, w[i][0][c], acc[m][c]);
            acc[m][c] = fmaf(h.y, w[i][1][c], acc[m][c]);
            acc[m][c] = fmaf(h.z, w[i][2][c], acc[m][c]);
            acc[m][c] = fmaf(h.w, w[i][3][c], acc[m][c]);
          }
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      const float v = reduce_scatter<4, U>(acc[m], lane);
      if (writer && r0 + m < nr) part[(warp * PR + r0 + m) * S::C + slot] = v;
    }
  }
}

// The block's W_hh rows for the dh product: wr[i][j][u] = wh_d[j0 + u][k]
// for k = i * 1024 + tid * 4 + j; zero past 4H.
template <int U>
__device__ __forceinline__ void load_gate_rows(float (&wr)[Shape<U>::KCC][4][U], const float* whd,
                                               int H, int j0) {
#pragma unroll
  for (int i = 0; i < Shape<U>::KCC; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = i * 1024 + threadIdx.x * 4 + j;
        wr[i][j][u] = k < 4 * H ? __ldg(whd + (size_t)(j0 + u) * 4 * H + k) : 0.0f;
      }
}

// part2[warp][r][u] = the warp's share of dgates[r] . W_hh[j0 + u, :] for the
// B rows of the direction, dgates row r at dg + r * stride (4H floats),
// streamed through the kStages stages of `ring` (row stride H4S, zero past
// 4H) by cp.async, the next stages loading while the current one is
// multiplied.
// Ends with a __syncthreads.
template <int U>
__device__ __forceinline__ void dh_product(const float (&wr)[Shape<U>::KCC][4][U], const float* dg,
                                           size_t stride, float* ring, int H4S, int B, int H,
                                           int kcc, float* part2) {
  using S = Shape<U>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool writer = (lane & ((32 >> S::LOG_U) - 1)) == 0;
  const int unit = lane >> (5 - S::LOG_U);
  const int chunks = (B + kRing - 1) / kRing;
  auto load_chunk = [&](int ch) {
    if (ch < chunks)
      stage_rows(ring + (ch % kStages) * kRing * H4S, H4S, dg + (size_t)ch * kRing * stride, stride,
                 min(kRing, B - ch * kRing), 4 * H);
    commit_copies();
  };
  for (int ch = 0; ch < kStages; ++ch) load_chunk(ch);
  for (int ch = 0; ch < chunks; ++ch) {
    wait_copies<kStages - 1>();
    __syncthreads();
    const float* st = ring + (ch % kStages) * kRing * H4S;
    const int rows = min(kRing, B - ch * kRing);
#pragma unroll
    for (int m0 = 0; m0 < kRing; m0 += kDhRows) {
      if (m0 < rows) {  // kDhRows rows at a time, those past `rows` computed and dropped
        float acc[kDhRows][U];
#pragma unroll
        for (int m = 0; m < kDhRows; ++m)
#pragma unroll
          for (int u = 0; u < U; ++u) acc[m][u] = 0.0f;
#pragma unroll
        for (int i = 0; i < S::KCC; ++i) {
          if (i < kcc) {
#pragma unroll
            for (int m = 0; m < kDhRows; ++m) {
              const float4 g =
                  *reinterpret_cast<const float4*>(st + (m0 + m) * H4S + i * 1024 + threadIdx.x * 4);
#pragma unroll
              for (int u = 0; u < U; ++u) {
                acc[m][u] = fmaf(g.x, wr[i][0][u], acc[m][u]);
                acc[m][u] = fmaf(g.y, wr[i][1][u], acc[m][u]);
                acc[m][u] = fmaf(g.z, wr[i][2][u], acc[m][u]);
                acc[m][u] = fmaf(g.w, wr[i][3][u], acc[m][u]);
              }
            }
          }
        }
#pragma unroll
        for (int m = 0; m < kDhRows; ++m) {
          const float v = reduce_scatter<U, 1>(acc[m], lane);
          if (writer && m0 + m < rows) part2[(warp * B + ch * kRing + m0 + m) * U + unit] = v;
        }
      }
    }
    __syncthreads();  // the stage is loaded again kStages chunks on
    load_chunk(ch + kStages);
  }
}

// Sum of the 8 warps' partials of one (row, gate column) of a pass.
__device__ __forceinline__ float warp_sum(const float* part, int PR, int C, int r, int q) {
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += part[(w * PR + r) * C + q];
  return s;
}

__device__ __forceinline__ void zero_shared(float* smem, int n) {
  for (int e = threadIdx.x; e < n; e += kThreads) smem[e] = 0.0f;
}

// ---- shared-memory plans (floats), the same on both sides ---------------------

template <int U>
__host__ __device__ constexpr int fwd_floats(int B, int PR, int H) {
  return PR * gate_chunks<U>(H) * Shape<U>::KSTEP + kWarps * PR * Shape<U>::C + B * Shape<U>::C + B * U;
}

template <int U>
__host__ __device__ constexpr int bwd_floats(int B, int PR, int H) {
  return PR * gate_chunks<U>(H) * Shape<U>::KSTEP + kWarps * PR * Shape<U>::C +
         2 * B * Shape<U>::C + 6 * B * U + B * U + kWarps * B * U +
         kStages * kRing * row_chunks(H) * 1024;
}

// ---- the kernels -----------------------------------------------------------------

template <int U, bool kWriteC>
__global__ void __launch_bounds__(kThreads, 1)
lstm_recurrence_kernel(const float* __restrict__ xw, const float* __restrict__ wh, float* out,
                       float* cout, unsigned* sync, int B, int T, int H, int PR) {
  using S = Shape<U>;
  constexpr int C = S::C;
  const int tid = threadIdx.x, lane = tid & 31;
  const int blocks_per_dir = H / U;
  const int dir = blockIdx.x / blocks_per_dir;
  const int j0 = (blockIdx.x % blocks_per_dir) * U;
  const int kc = gate_chunks<U>(H), HS = kc * S::KSTEP;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* hs = smem;                        // [PR][HS]     h_{t-1} rows of a pass
  float* part = hs + PR * HS;              // [kWarps][PR][C] warp partials
  float* xs = part + kWarps * PR * C;      // [B][C]       xw_t, (unit, gate) order
  float* cs = xs + B * C;                  // [B][U]       cell state
  zero_shared(smem, fwd_floats<U>(B, PR, H));

  float w[S::KCH][4][4];
  load_gate_columns<U>(w, wh + (size_t)dir * H * 4 * H, H, j0);
  unsigned* counter = sync + dir * kCounterStride;
  const float* xwd = xw + (size_t)dir * B * T * 4 * H;
  float* outd = out + (size_t)dir * B * T * H;
  float* coutd = kWriteC ? cout + (size_t)dir * B * T * H : nullptr;
  __syncthreads();
  prefetch_xw<U>(xs, xwd, B, T, H, j0, 0);
  commit_copies();

  for (int t = 0; t < T; ++t) {
    if (t > 0) wait_for(counter, (unsigned)(blocks_per_dir * t));  // h_{t-1} of the direction
    for (int r0 = 0; r0 < B; r0 += PR) {
      const int nr = min(PR, B - r0);
      if (t > 0) stage_rows(hs, HS, outd + ((size_t)r0 * T + t - 1) * H, (size_t)T * H, nr, H);
      commit_copies();
      wait_copies<0>();
      __syncthreads();
      if (t > 0) {
        gate_product<U>(w, hs, HS, nr, kc, part, PR);
        __syncthreads();
      }
      // cell update: a thread per (row, gate column); a unit's four gates in
      // four neighbouring lanes
      const int n = nr * C;
      for (int base = 0; base < n; base += kThreads) {
        const int e = base + tid;
        const bool on = e < n;
        const int r = on ? e / C : 0, q = e - (e / C) * C, u = q >> 2, g = q & 3;
        float pre = 0.0f, c_old = 0.0f;
        if (on) {
          pre = xs[(r0 + r) * C + q] + (t > 0 ? warp_sum(part, PR, C, r, q) : 0.0f);
          c_old = cs[(r0 + r) * U + u];
        }
        const float a = g == 2 ? tanhf(pre) : sigmoidf(pre);
        const int l0 = lane & ~3;
        const float ig = __shfl_sync(0xffffffffu, a, l0), fg = __shfl_sync(0xffffffffu, a, l0 + 1);
        const float gg = __shfl_sync(0xffffffffu, a, l0 + 2), og = __shfl_sync(0xffffffffu, a, l0 + 3);
        const float c = fg * c_old + ig * gg;
        __syncwarp();
        if (on) {
          const size_t o = ((size_t)(r0 + r) * T + t) * H + j0 + u;
          if (g == 0) {
            cs[(r0 + r) * U + u] = c;
            __stcg(outd + o, og * tanhf(c));
          } else if (kWriteC && g == 1) {
            __stcg(coutd + o, c);
          }
        }
      }
      __syncthreads();  // hs, part reused by the next pass; xs by the next prefetch
    }
    arrive(counter);
    if (t + 1 < T) {
      prefetch_xw<U>(xs, xwd, B, T, H, j0, t + 1);
      commit_copies();
    }
  }
}

// Two blocks an SM where U <= 2 (the grid of an odd H such as 99 needs them).
template <int U>
__global__ void __launch_bounds__(kThreads, U <= 2 ? 2 : 1)
lstm_recurrence_bwd_kernel(const float* __restrict__ xw, const float* __restrict__ wh,
                           const float* __restrict__ hseq, const float* __restrict__ cseq,
                           const float* __restrict__ dh, float* dxw, unsigned* sync, int B, int T,
                           int H, int PR) {
  using S = Shape<U>;
  constexpr int C = S::C;
  const int tid = threadIdx.x, lane = tid & 31;
  const int H4 = 4 * H;
  const int blocks_per_dir = H / U;
  const int dir = blockIdx.x / blocks_per_dir;
  const int j0 = (blockIdx.x % blocks_per_dir) * U;
  const int kc = gate_chunks<U>(H), HS = kc * S::KSTEP;
  const int kcc = row_chunks(H), H4S = kcc * 1024;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* hs = smem;                        // [PR][HS]     h_{t-1} rows of a pass
  float* part = hs + PR * HS;              // [kWarps][PR][C] warp partials of the gates
  float* ring = part + kWarps * PR * C;    // [kStages][kRing][H4S] dgates_{t+1} rows (16-byte aligned)
  float* xs = ring + kStages * kRing * H4S;  // [B][C]     xw_t, (unit, gate) order
  float* act = xs + B * C;                 // [B][C]       gate activations of step t
  float* cells = act + B * C;              // [2][3][B][U] c_t, c_{t-1}, dh_t, by step parity
  float* dcc = cells + 6 * B * U;          // [B][U]       dc carry
  float* part2 = dcc + B * U;              // [kWarps][B][U] warp partials of the dh carry
  zero_shared(smem, bwd_floats<U>(B, PR, H));

  const float* whd = wh + (size_t)dir * H * H4;
  float w[S::KCH][4][4];
  load_gate_columns<U>(w, whd, H, j0);
  float wr[S::KCC][4][U];
  load_gate_rows<U>(wr, whd, H, j0);
  unsigned* counter = sync + dir * kCounterStride;
  const size_t off = (size_t)dir * B * T;
  const float* xwd = xw + off * H4;
  const float* hd = hseq + off * H;
  const float* cd = cseq + off * H;
  const float* dhd = dh + off * H;
  float* dxwd = dxw + off * H4;
  const bool one_pass = B <= PR;

  // the loads of step t that depend on no other block: xw_t, c_t, c_{t-1},
  // dh_t, and the first pass's h_{t-1} rows
  auto prefetch = [&](int t) {
    prefetch_xw<U>(xs, xwd, B, T, H, j0, t);
    float* cb = cells + (t & 1) * 3 * B * U;
    for (int e = tid; e < B * U; e += kThreads) {
      const int r = e / U, u = e - r * U;
      const size_t o = ((size_t)r * T + t) * H + j0 + u;
      copy4(cb + e, cd + o);
      if (t > 0) copy4(cb + B * U + e, cd + o - H);
      else cb[B * U + e] = 0.0f;
      copy4(cb + 2 * B * U + e, dhd + o);
    }
    if (one_pass && t > 0) stage_rows(hs, HS, hd + (size_t)(t - 1) * H, (size_t)T * H, B, H);
    commit_copies();
  };
  __syncthreads();
  prefetch(T - 1);

  for (int t = T - 1; t >= 0; --t) {
    // phase 1: the gates of step t, recomputed (no dependence on other blocks)
    for (int r0 = 0; r0 < B; r0 += PR) {
      const int nr = min(PR, B - r0);
      if (!one_pass && t > 0)
        stage_rows(hs, HS, hd + ((size_t)r0 * T + t - 1) * H, (size_t)T * H, nr, H);
      commit_copies();
      wait_copies<0>();
      __syncthreads();
      if (t > 0) {
        gate_product<U>(w, hs, HS, nr, kc, part, PR);
        __syncthreads();
      }
      for (int e = tid; e < nr * C; e += kThreads) {
        const int r = e / C, q = e - r * C;
        const float pre = xs[(r0 + r) * C + q] + (t > 0 ? warp_sum(part, PR, C, r, q) : 0.0f);
        act[(r0 + r) * C + q] = (q & 3) == 2 ? tanhf(pre) : sigmoidf(pre);
      }
      __syncthreads();  // hs, part reused by the next pass; xs by the next prefetch
    }
    if (t > 0) prefetch(t - 1);

    // phase 2: the dh carry from every block's dgates_{t+1}
    if (t < T - 1) {
      wait_for(counter, (unsigned)(blocks_per_dir * (T - 1 - t)));
      dh_product<U>(wr, dxwd + (size_t)(t + 1) * H4, (size_t)T * H4, ring, H4S, B, H, kcc, part2);
    }

    // dgates of step t: a thread per (row, gate column)
    const float* cb = cells + (t & 1) * 3 * B * U;
    const int n = B * C;
    for (int base = 0; base < n; base += kThreads) {
      const int e = base + tid;
      const bool on = e < n;
      const int r = on ? e / C : 0, q = e - (e / C) * C, u = q >> 2, g = q & 3;
      const float a = on ? act[r * C + q] : 0.0f;
      const int l0 = lane & ~3;
      const float ig = __shfl_sync(0xffffffffu, a, l0), fg = __shfl_sync(0xffffffffu, a, l0 + 1);
      const float gg = __shfl_sync(0xffffffffu, a, l0 + 2), og = __shfl_sync(0xffffffffu, a, l0 + 3);
      if (on) {
        const int p = r * U + u;
        float carry = 0.0f;
        if (t < T - 1) {
#pragma unroll
          for (int w8 = 0; w8 < kWarps; ++w8) carry += part2[w8 * B * U + p];
        }
        const float tc = tanhf(cb[p]), cp = cb[B * U + p];
        const float dht = cb[2 * B * U + p] + carry;
        const float dct = dht * og * (1.0f - tc * tc) + dcc[p];
        const float d = g == 0 ? dct * gg * ig * (1.0f - ig)
                      : g == 1 ? dct * cp * fg * (1.0f - fg)
                      : g == 2 ? dct * ig * (1.0f - gg * gg)
                               : dht * tc * og * (1.0f - og);
        __stcg(dxwd + ((size_t)r * T + t) * H4 + g * H + j0 + u, d);
        __syncwarp(0xfu << (lane & ~3));  // the unit's four lanes have read dcc
        if (g == 0) dcc[p] = dct * fg;
      }
    }
    __syncthreads();  // dgates_t stored, part2 and act read
    arrive(counter);
  }
}

// The sequential floor: the grid of the kernels above doing its T
// per-direction barriers and nothing else.
__global__ void __launch_bounds__(kThreads, 1)
lstm_barrier_floor_kernel(unsigned* sync, int blocks_per_dir, int T) {
  unsigned* counter = sync + (blockIdx.x / blocks_per_dir) * kCounterStride;
  for (int t = 0; t < T; ++t) {
    __syncthreads();
    arrive(counter);
    wait_for(counter, (unsigned)(blocks_per_dir * (t + 1)));
  }
}

// ---- host side -------------------------------------------------------------------

// Cooperative launch of `kernel` with 2 * (H / U) blocks after checking
// that all of them can be resident at once (the barriers need it).
cudaError_t launch_cooperative(const void* kernel, int H, int U, size_t smem, void** args,
                               cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return e;
  const int blocks = 2 * (H / U);
  if (blocks > per_sm * sms) return cudaErrorCooperativeLaunchTooLarge;
  e = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads), args, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// U (hidden units per block) is the smallest of 1, 2, 4, 8 that divides H
// and gives at most one block per SM; if none does, the largest that
// divides H, and the occupancy check decides whether all blocks fit.
cudaError_t units_per_block(int H, int* u) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  *u = 1;
  for (int cand = 1; cand <= 8; cand *= 2)
    if (H % cand == 0 && 2 * (H / cand) <= sms) { *u = cand; return cudaSuccess; }
  for (int cand = 8; cand >= 1; cand /= 2)
    if (H % cand == 0) { *u = cand; return cudaSuccess; }
  return cudaSuccess;
}

// Rows a pass of the gate product takes: all B (rounded up to the register
// tile) where the shared memory holds them, else the most it holds.
// Returns 0, kNotTaken, or a CUDA error; sets *pr and *smem (bytes).
template <int U>
int plan(int B, int H, bool backward, int* pr, size_t* smem) {
  if (gate_chunks<U>(H) > Shape<U>::KCH || row_chunks(H) > Shape<U>::KCC) return kNotTaken;
  int dev = 0, limit = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  for (int p = (B + kRows - 1) / kRows * kRows; p >= kRows; p -= kRows) {
    const size_t bytes = sizeof(float) * (size_t)(backward ? bwd_floats<U>(B, p, H) : fwd_floats<U>(B, p, H));
    if (bytes <= (size_t)limit) {
      *pr = p;
      *smem = bytes;
      return 0;
    }
  }
  return kNotTaken;
}

template <int U>
int launch_fwd(const float* xw, const float* wh, float* out, float* cout, unsigned* sync, int B,
               int T, int H, cudaStream_t stream) {
  int pr = 0;
  size_t smem = 0;
  if (int e = plan<U>(B, H, false, &pr, &smem)) return e;
  void* args[] = {(void*)&xw, (void*)&wh, (void*)&out, (void*)&cout, (void*)&sync,
                  (void*)&B,  (void*)&T,  (void*)&H,   (void*)&pr};
  const void* kernel = cout ? (const void*)lstm_recurrence_kernel<U, true>
                            : (const void*)lstm_recurrence_kernel<U, false>;
  return launch_cooperative(kernel, H, U, smem, args, stream);
}

template <int U>
int launch_bwd(const float* xw, const float* wh, const float* h, const float* c, const float* dh,
               float* dxw, unsigned* sync, int B, int T, int H, cudaStream_t stream) {
  int pr = 0;
  size_t smem = 0;
  if (int e = plan<U>(B, H, true, &pr, &smem)) return e;
  void* args[] = {(void*)&xw, (void*)&wh, (void*)&h, (void*)&c, (void*)&dh, (void*)&dxw,
                  (void*)&sync, (void*)&B, (void*)&T, (void*)&H, (void*)&pr};
  return launch_cooperative((const void*)lstm_recurrence_bwd_kernel<U>, H, U, smem, args, stream);
}

int forward(const void* xw, const void* wh, void* out, void* cout, void* sync, int two_b, int T,
            int H, void* stream) {
  if (two_b <= 0 || two_b % 2 || T <= 0 || H <= 0 || sync == nullptr) return cudaErrorInvalidValue;
  int u = 1;
  cudaError_t e = units_per_block(H, &u);
  if (e != cudaSuccess) return e;
  const float* x = static_cast<const float*>(xw);
  const float* w = static_cast<const float*>(wh);
  float* o = static_cast<float*>(out);
  float* c = static_cast<float*>(cout);
  unsigned* sy = static_cast<unsigned*>(sync);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int B = two_b / 2;
  switch (u) {
    case 8: return launch_fwd<8>(x, w, o, c, sy, B, T, H, s);
    case 4: return launch_fwd<4>(x, w, o, c, sy, B, T, H, s);
    case 2: return launch_fwd<2>(x, w, o, c, sy, B, T, H, s);
    default: return launch_fwd<1>(x, w, o, c, sy, B, T, H, s);
  }
}

}  // namespace

extern "C" {

// Every entry launches on `stream` and returns 0, kNotTaken (-1) for a
// shape the kernels do not take, or a cudaError_t code. `sync` is 64 zeroed
// 32-bit words of device memory: the two directions' barrier counters.

// K1.
int lstm_recurrence_forward(const void* xw, const void* wh, void* out, void* sync, int two_b,
                            int T, int H, void* stream) {
  return forward(xw, wh, out, nullptr, sync, two_b, T, H, stream);
}

// K2a: K1 that also writes the cell states to `cout` (2B, T, H).
int lstm_recurrence_forward_train(const void* xw, const void* wh, void* out, void* cout,
                                  void* sync, int two_b, int T, int H, void* stream) {
  if (cout == nullptr) return cudaErrorInvalidValue;
  return forward(xw, wh, out, cout, sync, two_b, T, H, stream);
}

// K2b: dxw (2B, T, 4H) from xw, wh, the forward's h and c (2B, T, H) and the
// incoming gradient dh (2B, T, H).
int lstm_recurrence_backward(const void* xw, const void* wh, const void* h, const void* c,
                             const void* dh, void* dxw, void* sync, int two_b, int T, int H,
                             void* stream) {
  if (two_b <= 0 || two_b % 2 || T <= 0 || H <= 0 || sync == nullptr) return cudaErrorInvalidValue;
  int u = 1;
  cudaError_t e = units_per_block(H, &u);
  if (e != cudaSuccess) return e;
  const float* x = static_cast<const float*>(xw);
  const float* w = static_cast<const float*>(wh);
  const float* hs = static_cast<const float*>(h);
  const float* cs = static_cast<const float*>(c);
  const float* g = static_cast<const float*>(dh);
  float* d = static_cast<float*>(dxw);
  unsigned* sy = static_cast<unsigned*>(sync);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int B = two_b / 2;
  switch (u) {
    case 8: return launch_bwd<8>(x, w, hs, cs, g, d, sy, B, T, H, s);
    case 4: return launch_bwd<4>(x, w, hs, cs, g, d, sy, B, T, H, s);
    case 2: return launch_bwd<2>(x, w, hs, cs, g, d, sy, B, T, H, s);
    default: return launch_bwd<1>(x, w, hs, cs, g, d, sy, B, T, H, s);
  }
}

// The sequential floor of the kernels at (2B, T, H): their grid doing T
// per-direction barriers and no work. For measurement only.
int lstm_recurrence_floor(void* sync, int two_b, int T, int H, void* stream) {
  if (two_b <= 0 || two_b % 2 || T <= 0 || H <= 0 || sync == nullptr) return cudaErrorInvalidValue;
  int u = 1;
  cudaError_t e = units_per_block(H, &u);
  if (e != cudaSuccess) return e;
  unsigned* sy = static_cast<unsigned*>(sync);
  int blocks_per_dir = H / u;
  void* args[] = {(void*)&sy, (void*)&blocks_per_dir, (void*)&T};
  return launch_cooperative((const void*)lstm_barrier_floor_kernel, H, u, 0, args,
                            static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int err) {
  return err == kNotTaken ? "shape not taken by the recurrence kernels"
                          : cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
