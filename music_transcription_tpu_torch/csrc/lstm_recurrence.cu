// K1: fused-direction LSTM recurrence, forward only, fp32.
//
// Replaces music_transcription_tpu/ops/lstm_pallas.py:
// lstm_recurrence_pallas -> _recurrence_kernel.
//
//   xw  (2B, T, 4H)  input projections; rows [0,B) forward direction,
//                    rows [B,2B) backward direction already time-reversed
//   wh  (2, H, 4H)   recurrent weights of the two directions
//   out (2B, T, H)   hidden states
//   per step t, torch gate order (i, f, g, o), zero initial state:
//     gates = xw[:, t] + blockdiag(h_{t-1}) . wh
//     c = sig(f) c + sig(i) tanh(g);  h = sig(o) tanh(c)
//
// What bounds it on the H100. The work is 2 * 2B * T * H * 4H fp32
// operations (15.7 GFLOP at 2B=8, T=938, H=512: 0.23 ms at the 67 TFLOP/s
// fp32 rate) against ~61 MB of xw (18 us at 3.35 TB/s), so the roofline says
// operations. But the T steps are strictly sequential and each needs all of
// h_{t-1}: the real floor is T times the cost of one device-wide exchange of
// h, which the roofline does not count.
//
// Design. The Pallas kernel keeps both directions' W_hh (8 MB at H=512) in
// one TPU core's VMEM and walks a sequential grid. No SM holds 8 MB, so here
// one persistent cooperative launch spreads W_hh over the SMs instead:
//   * block = (direction, U consecutive hidden units); it owns the 4U gate
//     columns {i,f,g,o} x units of its slice, so the cell update needs no
//     data from other blocks. At H=512, U=8: 128 blocks, one per SM.
//   * its W_hh slice (H x 4U fp32, 64 KB at U=8) is loaded into shared
//     memory once and stays there for all T steps;
//   * the cell state c of its units lives in shared memory for all steps;
//   * h_t is written straight into `out` (through L2, __stcg) and read back
//     at step t+1 by every block of the direction (__ldcg, bypassing L1);
//     each step writes a new time slot, so no double buffer is needed;
//   * one grid-wide barrier (cooperative_groups grid.sync) per step makes
//     h_t visible to all blocks before step t+1 reads it.
// Inside a block, the H-long dot products are split over the 8 warps (one
// slice of H each); a lane owns one gate column and up to 8 batch rows, so a
// W_hh element read from shared memory feeds 8 FMAs. Batch rows are walked
// in tiles, so any 2B and any T are taken. The host side checks with the
// occupancy API that every block can be resident before launching.

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
};

template <int U>
size_t smem_bytes(int B, int H) {
  using S = Shape<U>;
  return sizeof(float) * ((size_t)H * S::C + (size_t)S::R * (H + 1) +
                          (size_t)kWarps * S::R * S::C + (size_t)B * U);
}

template <int U>
__global__ void __launch_bounds__(kThreads, 1)
lstm_recurrence_kernel(const float* __restrict__ xw, const float* __restrict__ wh,
                       float* out, int B, int T, int H) {
  using S = Shape<U>;
  constexpr int C = S::C, LG = S::LG, R = S::R;
  extern __shared__ float smem[];
  const int HP = H + 1;                 // padded row stride of the h tile
  float* ws = smem;                     // [H][C]   W_hh slice
  float* hs = ws + (size_t)H * C;       // [R][HP]  h_{t-1} tile
  float* part = hs + (size_t)R * HP;    // [kWarps][R][C] per-warp partial dots
  float* cs = part + kWarps * R * C;    // [B][U]   cell state

  const int blocks_per_dir = H / U;
  const int dir = blockIdx.x / blocks_per_dir;
  const int j0 = (blockIdx.x % blocks_per_dir) * U;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col = lane % C, lg = lane / C;

  const float* whd = wh + (size_t)dir * H * 4 * H;
  for (int e = tid; e < H * C; e += kThreads) {
    const int i = e / C, cc = e % C;
    ws[e] = whd[(size_t)i * 4 * H + (cc / U) * H + j0 + (cc % U)];
  }
  for (int e = tid; e < B * U; e += kThreads) cs[e] = 0.0f;
  __syncthreads();

  const int kchunk = (H + kWarps - 1) / kWarps;
  const int i_lo = min(H, warp * kchunk), i_hi = min(H, i_lo + kchunk);
  const size_t xw_row = (size_t)T * 4 * H;
  cg::grid_group grid = cg::this_grid();

  for (int t = 0; t < T; ++t) {
    for (int r0 = 0; r0 < B; r0 += R) {
      const int nr = min(R, B - r0);
      float acc[kRowsPerLane];
#pragma unroll
      for (int m = 0; m < kRowsPerLane; ++m) acc[m] = 0.0f;
      if (t > 0) {
        for (int e = tid; e < nr * H; e += kThreads) {
          const int r = e / H, i = e % H;
          hs[r * HP + i] = __ldcg(out + ((size_t)(dir * B + r0 + r) * T + (t - 1)) * H + i);
        }
        for (int e = nr * H + tid; e < R * H; e += kThreads) hs[(e / H) * HP + e % H] = 0.0f;
        __syncthreads();
        for (int i = i_lo; i < i_hi; ++i) {
          const float w = ws[i * C + col];
#pragma unroll
          for (int m = 0; m < kRowsPerLane; ++m)
            acc[m] = fmaf(hs[(lg + LG * m) * HP + i], w, acc[m]);
        }
      }
#pragma unroll
      for (int m = 0; m < kRowsPerLane; ++m) part[(warp * R + lg + LG * m) * C + col] = acc[m];
      __syncthreads();
      for (int e = tid; e < nr * U; e += kThreads) {
        const int r = e / U, jj = e % U;
        const int row = dir * B + r0 + r;
        const float* x = xw + (size_t)row * xw_row + (size_t)t * 4 * H + j0 + jj;
        float g[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float hw = 0.0f;
          for (int w = 0; w < kWarps; ++w) hw += part[(w * R + r) * C + k * U + jj];
          g[k] = __ldg(x + k * H) + hw;
        }
        float& c = cs[(r0 + r) * U + jj];
        c = sigmoidf(g[1]) * c + sigmoidf(g[0]) * tanhf(g[2]);
        __stcg(out + ((size_t)row * T + t) * H + j0 + jj, sigmoidf(g[3]) * tanhf(c));
      }
      __syncthreads();  // hs and part are reused by the next tile
    }
    grid.sync();  // h_t visible to every block before step t+1
  }
}

template <int U>
int launch(const float* xw, const float* wh, float* out, int B, int T, int H,
           cudaStream_t stream) {
  auto kernel = lstm_recurrence_kernel<U>;
  const size_t smem = smem_bytes<U>(B, H);
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
  void* args[] = {(void*)&xw, (void*)&wh, (void*)&out, (void*)&B, (void*)&T, (void*)&H};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks), dim3(kThreads), args, smem,
                                  stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`. Returns 0 or a cudaError_t code. U (hidden units per
// block) is the smallest of 1, 2, 4, 8 that divides H and gives at most one
// block per SM; if none does, the largest that divides H, and the occupancy
// check decides whether all blocks fit.
int lstm_recurrence_forward(const void* xw, const void* wh, void* out, int two_b, int T, int H,
                            void* stream) {
  if (two_b <= 0 || two_b % 2 || T <= 0 || H <= 0) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  int u = 0;
  for (int cand = 1; cand <= 8; cand *= 2)
    if (H % cand == 0 && 2 * (H / cand) <= sms) { u = cand; break; }
  if (u == 0)
    for (int cand = 8; cand >= 1; cand /= 2)
      if (H % cand == 0) { u = cand; break; }
  const float* x = static_cast<const float*>(xw);
  const float* w = static_cast<const float*>(wh);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int B = two_b / 2;
  switch (u) {
    case 8: return launch<8>(x, w, o, B, T, H, s);
    case 4: return launch<4>(x, w, o, B, T, H, s);
    case 2: return launch<2>(x, w, o, B, T, H, s);
    default: return launch<1>(x, w, o, B, T, H, s);
  }
}

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
