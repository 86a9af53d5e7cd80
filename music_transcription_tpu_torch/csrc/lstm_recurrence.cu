// The fused-direction LSTM recurrence, fp32: forward (K1), forward with the
// cell-state sequence for training (K2a) and backward through time (K2b).
//
// Replaces music_transcription_tpu/ops/lstm_pallas.py:
//   K1  lstm_recurrence_pallas -> _recurrence_kernel
//   K2a _lstm_recurrence_fwd_impl -> _recurrence_fwd_kernel
//   K2b _lstm_recurrence_bwd -> _recurrence_bwd_kernel
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
// What bounds it on the H100. Forward: 2 * 2B * T * H * 4H fp32 operations
// (15.7 GFLOP at 2B=8, T=938, H=512: 0.23 ms at the 67 TFLOP/s fp32 rate)
// against ~61 MB of xw (18 us at 3.35 TB/s), so the roofline says
// operations; the backward does twice the operations (the gate product is
// recomputed, and dh_carry is a second product of the same size). But the T
// steps are strictly sequential and each needs all of h_{t-1} (forward) or
// all of dgates_t (backward): the real floor is T times the cost of one
// device-wide exchange, which the roofline does not count.
//
// Design. The Pallas kernels keep both directions' W_hh (8 MB at H=512) in
// one TPU core's VMEM and walk a sequential grid. No SM holds 8 MB, so here
// one persistent cooperative launch spreads W_hh over the SMs instead:
//   * block = (direction, U consecutive hidden units); it owns the 4U gate
//     columns {i,f,g,o} x units of its slice, so the cell update (forward)
//     and dgates (backward) need no data from other blocks. At H=512, U=8:
//     128 blocks, one per SM.
//   * its W_hh column slice (H x 4U fp32, 64 KB at U=8) is loaded into
//     shared memory once and stays there for all T steps; the backward also
//     keeps its W_hh row slice (U x 4H, 64 KB) for dh_carry of its units;
//   * the cell state (forward) or the dh, dc carries (backward) of its units
//     live in shared memory for all steps;
//   * what the other blocks need goes to device memory through L2 (__stcg)
//     and is read back after a grid-wide barrier (__ldcg, bypassing L1):
//     h_t in the forward, dgates_t (= dxw[:, t]) in the backward. Every step
//     writes a new time slot, so one barrier per step suffices and no double
//     buffer is needed;
//   * K2a is K1 with one more store per unit and step: c_t, for the backward.
// Inside a block, the H-long dot products of the gate columns are split
// over the 8 warps (one slice of H each); a lane owns one gate column and up
// to 8 batch rows, so a W_hh element read from shared memory feeds 8 FMAs.
// In the backward's dh_carry product each warp owns 8 of the tile's 64
// (row, unit) outputs and its lanes walk the 4H columns, then reduce with
// shuffles. Batch rows are walked in tiles, so any 2B and any T are taken.
// The host side checks with the occupancy API that every block can be
// resident before launching.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerLane = 8;

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

template <int U>
struct Shape {
  static constexpr int C = 4 * U;             // gate columns owned by a block
  static constexpr int LG = 32 / C;           // row groups per warp
  static constexpr int R = LG * kRowsPerLane; // batch rows per tile
  static_assert(R * U == kWarps * 8, "the backward's dh product: 8 outputs per warp");
};

template <int U>
size_t fwd_smem_bytes(int B, int H) {
  using S = Shape<U>;
  return sizeof(float) * ((size_t)H * S::C + (size_t)S::R * (H + 1) +
                          (size_t)kWarps * S::R * S::C + (size_t)B * U);
}

template <int U>
size_t bwd_smem_bytes(int B, int H) {
  using S = Shape<U>;
  const size_t h_tile = (size_t)S::R * (H + 1), dg_tile = (size_t)S::R * 4 * H;
  return sizeof(float) * ((size_t)H * S::C + (size_t)U * 4 * H +
                          (h_tile > dg_tile ? h_tile : dg_tile) +
                          (size_t)kWarps * S::R * S::C + 2 * (size_t)B * U);
}

// Load the block's W_hh column slice: ws[i][cc] = wh_d[i][(cc / U) * H + j0 + cc % U].
template <int U>
__device__ void load_columns(float* ws, const float* whd, int H, int j0) {
  constexpr int C = Shape<U>::C;
  for (int e = threadIdx.x; e < H * C; e += kThreads) {
    const int i = e / C, cc = e % C;
    ws[e] = whd[(size_t)i * 4 * H + (cc / U) * H + j0 + (cc % U)];
  }
}

// part[w][r][cc] = sum over warp w's slice of i of hprev[r][i] * ws[i][cc],
// for the nr rows of the tile starting at row `row0` of hseq (time t - 1);
// zeros at t = 0. `hs` is the [R][H+1] staging tile. Ends with a barrier.
template <int U, bool kCoherent>
__device__ void gate_partials(const float* hseq, const float* ws, float* hs, float* part,
                              int row0, int nr, int t, int T, int H) {
  using S = Shape<U>;
  constexpr int C = S::C, LG = S::LG, R = S::R;
  const int HP = H + 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col = lane % C, lg = lane / C;
  float acc[kRowsPerLane];
#pragma unroll
  for (int m = 0; m < kRowsPerLane; ++m) acc[m] = 0.0f;
  if (t > 0) {
    for (int e = tid; e < nr * H; e += kThreads) {
      const int r = e / H, i = e % H;
      const float* src = hseq + ((size_t)(row0 + r) * T + (t - 1)) * H + i;
      hs[r * HP + i] = kCoherent ? __ldcg(src) : __ldg(src);
    }
    for (int e = nr * H + tid; e < R * H; e += kThreads) hs[(e / H) * HP + e % H] = 0.0f;
    __syncthreads();
    const int kchunk = (H + kWarps - 1) / kWarps;
    const int i_lo = min(H, warp * kchunk), i_hi = min(H, i_lo + kchunk);
    for (int i = i_lo; i < i_hi; ++i) {
      const float w = ws[i * C + col];
#pragma unroll
      for (int m = 0; m < kRowsPerLane; ++m) acc[m] = fmaf(hs[(lg + LG * m) * HP + i], w, acc[m]);
    }
  }
#pragma unroll
  for (int m = 0; m < kRowsPerLane; ++m) part[(warp * R + lg + LG * m) * C + col] = acc[m];
  __syncthreads();
}

// gates of tile row r, unit jj: xw + the warps' partial dot products.
template <int U>
__device__ __forceinline__ void tile_gates(float g[4], const float* xw_t, const float* part, int r,
                                           int jj, int H) {
  using S = Shape<U>;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float hw = 0.0f;
    for (int w = 0; w < kWarps; ++w) hw += part[(w * S::R + r) * S::C + k * U + jj];
    g[k] = __ldg(xw_t + k * H) + hw;
  }
}

template <int U, bool kWriteC>
__global__ void __launch_bounds__(kThreads, 1)
lstm_recurrence_kernel(const float* __restrict__ xw, const float* __restrict__ wh, float* out,
                       float* cout, int B, int T, int H) {
  using S = Shape<U>;
  constexpr int C = S::C, R = S::R;
  extern __shared__ float smem[];
  float* ws = smem;                     // [H][C]   W_hh column slice
  float* hs = ws + (size_t)H * C;       // [R][H+1] h_{t-1} tile
  float* part = hs + (size_t)R * (H + 1);  // [kWarps][R][C] per-warp partial dots
  float* cs = part + kWarps * R * C;    // [B][U]   cell state

  const int blocks_per_dir = H / U;
  const int dir = blockIdx.x / blocks_per_dir;
  const int j0 = (blockIdx.x % blocks_per_dir) * U;
  load_columns<U>(ws, wh + (size_t)dir * H * 4 * H, H, j0);
  for (int e = threadIdx.x; e < B * U; e += kThreads) cs[e] = 0.0f;
  __syncthreads();

  const size_t xw_row = (size_t)T * 4 * H;
  cg::grid_group grid = cg::this_grid();
  for (int t = 0; t < T; ++t) {
    for (int r0 = 0; r0 < B; r0 += R) {
      const int nr = min(R, B - r0);
      gate_partials<U, true>(out, ws, hs, part, dir * B + r0, nr, t, T, H);
      for (int e = threadIdx.x; e < nr * U; e += kThreads) {
        const int r = e / U, jj = e % U;
        const int row = dir * B + r0 + r;
        float g[4];
        tile_gates<U>(g, xw + (size_t)row * xw_row + (size_t)t * 4 * H + j0 + jj, part, r, jj, H);
        float& c = cs[(r0 + r) * U + jj];
        c = sigmoidf(g[1]) * c + sigmoidf(g[0]) * tanhf(g[2]);
        const size_t o = ((size_t)row * T + t) * H + j0 + jj;
        __stcg(out + o, sigmoidf(g[3]) * tanhf(c));
        if (kWriteC) __stcg(cout + o, c);
      }
      __syncthreads();  // hs and part are reused by the next tile
    }
    grid.sync();  // h_t visible to every block before step t+1
  }
}

template <int U>
__global__ void __launch_bounds__(kThreads, 1)
lstm_recurrence_bwd_kernel(const float* __restrict__ xw, const float* __restrict__ wh,
                           const float* __restrict__ hseq, const float* __restrict__ cseq,
                           const float* __restrict__ dh, float* dxw, int B, int T, int H) {
  using S = Shape<U>;
  constexpr int C = S::C, R = S::R;
  const int H4 = 4 * H;
  extern __shared__ float smem[];
  const size_t h_tile = (size_t)R * (H + 1), dg_tile = (size_t)R * H4;
  float* ws = smem;                       // [H][C]   W_hh column slice (gate recompute)
  float* wr = ws + (size_t)H * C;         // [U][4H]  W_hh rows of the block's units (dh carry)
  float* stage = wr + (size_t)U * H4;     // [R][H+1] h_{t-1} tile, or [R][4H] dgates tile
  float* part = stage + (h_tile > dg_tile ? h_tile : dg_tile);  // [kWarps][R][C]
  float* dhc = part + kWarps * R * C;     // [B][U]   dh carry
  float* dcc = dhc + B * U;               // [B][U]   dc carry

  const int blocks_per_dir = H / U;
  const int dir = blockIdx.x / blocks_per_dir;
  const int j0 = (blockIdx.x % blocks_per_dir) * U;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* whd = wh + (size_t)dir * H * H4;
  load_columns<U>(ws, whd, H, j0);
  for (int e = tid; e < U * H4; e += kThreads) wr[e] = whd[(size_t)(j0 + e / H4) * H4 + e % H4];
  for (int e = tid; e < 2 * B * U; e += kThreads) dhc[e] = 0.0f;  // dhc and dcc
  __syncthreads();

  const size_t xw_row = (size_t)T * H4;
  cg::grid_group grid = cg::this_grid();
  for (int t = T - 1; t >= 0; --t) {
    // dgates of the block's gate columns at time t, from recomputed gates
    for (int r0 = 0; r0 < B; r0 += R) {
      const int nr = min(R, B - r0);
      gate_partials<U, false>(hseq, ws, stage, part, dir * B + r0, nr, t, T, H);
      for (int e = tid; e < nr * U; e += kThreads) {
        const int r = e / U, jj = e % U;
        const int row = dir * B + r0 + r;
        const size_t xo = (size_t)row * xw_row + (size_t)t * H4 + j0 + jj;
        float g[4];
        tile_gates<U>(g, xw + xo, part, r, jj, H);
        const float ig = sigmoidf(g[0]), fg = sigmoidf(g[1]), gg = tanhf(g[2]), og = sigmoidf(g[3]);
        const size_t so = ((size_t)row * T + t) * H + j0 + jj;
        const float tc = tanhf(__ldg(cseq + so));
        const float cp = t > 0 ? __ldg(cseq + so - H) : 0.0f;
        const int q = (r0 + r) * U + jj;
        const float dht = __ldg(dh + so) + dhc[q];
        const float dct = dht * og * (1.0f - tc * tc) + dcc[q];
        __stcg(dxw + xo, dct * gg * ig * (1.0f - ig));
        __stcg(dxw + xo + H, dct * cp * fg * (1.0f - fg));
        __stcg(dxw + xo + 2 * H, dct * ig * (1.0f - gg * gg));
        __stcg(dxw + xo + 3 * H, dht * tc * og * (1.0f - og));
        dcc[q] = dct * fg;
      }
      __syncthreads();  // stage and part are reused by the next tile
    }
    if (t == 0) break;  // uniform over the grid: no carry is needed past t = 0
    grid.sync();        // dgates_t of every block visible before the dh product
    // dh carry of the block's units: dgates_t[row, :] . W_hh[j0 + u, :]
    for (int r0 = 0; r0 < B; r0 += R) {
      const int nr = min(R, B - r0);
      for (int e = tid; e < nr * H4; e += kThreads) {
        const int r = e / H4, k = e % H4;
        stage[e] = __ldcg(dxw + (size_t)(dir * B + r0 + r) * xw_row + (size_t)t * H4 + k);
      }
      __syncthreads();
      float acc[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[q] = 0.0f;
      for (int k = lane; k < H4; k += 32) {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int o = warp * 8 + q, r = o / U, u = o % U;
          acc[q] = fmaf(stage[(size_t)r * H4 + k], wr[(size_t)u * H4 + k], acc[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        float v = acc[q];
#pragma unroll
        for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
        const int o = warp * 8 + q, r = o / U, u = o % U;
        if (lane == 0 && r < nr) dhc[(r0 + r) * U + u] = v;
      }
      __syncthreads();  // stage is reused by the next tile
    }
  }
}

// Cooperative launch of `kernel` with 2 * (H / U) blocks after checking
// that all of them can be resident at once.
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

template <int U>
int launch_fwd(const float* xw, const float* wh, float* out, float* cout, int B, int T, int H,
               cudaStream_t stream) {
  void* args[] = {(void*)&xw, (void*)&wh, (void*)&out, (void*)&cout, (void*)&B, (void*)&T, (void*)&H};
  const void* kernel = cout ? (const void*)lstm_recurrence_kernel<U, true>
                            : (const void*)lstm_recurrence_kernel<U, false>;
  return launch_cooperative(kernel, H, U, fwd_smem_bytes<U>(B, H), args, stream);
}

template <int U>
int launch_bwd(const float* xw, const float* wh, const float* h, const float* c, const float* dh,
               float* dxw, int B, int T, int H, cudaStream_t stream) {
  void* args[] = {(void*)&xw, (void*)&wh, (void*)&h, (void*)&c, (void*)&dh, (void*)&dxw,
                  (void*)&B, (void*)&T, (void*)&H};
  return launch_cooperative((const void*)lstm_recurrence_bwd_kernel<U>, H, U,
                            bwd_smem_bytes<U>(B, H), args, stream);
}

// U (hidden units per block) is the smallest of 1, 2, 4, 8 that divides H
// and gives at most one block per SM; if none does, the largest that
// divides H, and the occupancy check decides whether all blocks fit.
cudaError_t units_per_block(int H, int* u) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  *u = 0;
  for (int cand = 1; cand <= 8; cand *= 2)
    if (H % cand == 0 && 2 * (H / cand) <= sms) { *u = cand; return cudaSuccess; }
  for (int cand = 8; cand >= 1; cand /= 2)
    if (H % cand == 0) { *u = cand; return cudaSuccess; }
  return cudaSuccess;
}

int forward(const void* xw, const void* wh, void* out, void* cout, int two_b, int T, int H,
            void* stream) {
  if (two_b <= 0 || two_b % 2 || T <= 0 || H <= 0) return cudaErrorInvalidValue;
  int u = 1;
  cudaError_t e = units_per_block(H, &u);
  if (e != cudaSuccess) return e;
  const float* x = static_cast<const float*>(xw);
  const float* w = static_cast<const float*>(wh);
  float* o = static_cast<float*>(out);
  float* c = static_cast<float*>(cout);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int B = two_b / 2;
  switch (u) {
    case 8: return launch_fwd<8>(x, w, o, c, B, T, H, s);
    case 4: return launch_fwd<4>(x, w, o, c, B, T, H, s);
    case 2: return launch_fwd<2>(x, w, o, c, B, T, H, s);
    default: return launch_fwd<1>(x, w, o, c, B, T, H, s);
  }
}

}  // namespace

extern "C" {

// K1. Launch on `stream`. Returns 0 or a cudaError_t code.
int lstm_recurrence_forward(const void* xw, const void* wh, void* out, int two_b, int T, int H,
                            void* stream) {
  return forward(xw, wh, out, nullptr, two_b, T, H, stream);
}

// K2a: K1 that also writes the cell states to `cout` (2B, T, H).
int lstm_recurrence_forward_train(const void* xw, const void* wh, void* out, void* cout,
                                  int two_b, int T, int H, void* stream) {
  if (cout == nullptr) return cudaErrorInvalidValue;
  return forward(xw, wh, out, cout, two_b, T, H, stream);
}

// K2b: dxw (2B, T, 4H) from xw, wh, the forward's h and c (2B, T, H) and the
// incoming gradient dh (2B, T, H).
int lstm_recurrence_backward(const void* xw, const void* wh, const void* h, const void* c,
                             const void* dh, void* dxw, int two_b, int T, int H, void* stream) {
  if (two_b <= 0 || two_b % 2 || T <= 0 || H <= 0) return cudaErrorInvalidValue;
  int u = 1;
  cudaError_t e = units_per_block(H, &u);
  if (e != cudaSuccess) return e;
  const float* x = static_cast<const float*>(xw);
  const float* w = static_cast<const float*>(wh);
  const float* hs = static_cast<const float*>(h);
  const float* cs = static_cast<const float*>(c);
  const float* g = static_cast<const float*>(dh);
  float* d = static_cast<float*>(dxw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int B = two_b / 2;
  switch (u) {
    case 8: return launch_bwd<8>(x, w, hs, cs, g, d, B, T, H, s);
    case 4: return launch_bwd<4>(x, w, hs, cs, g, d, B, T, H, s);
    case 2: return launch_bwd<2>(x, w, hs, cs, g, d, B, T, H, s);
    default: return launch_bwd<1>(x, w, hs, cs, g, d, B, T, H, s);
  }
}

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
