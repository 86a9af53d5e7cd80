// The exact three-term bf16 split of an fp32 gradient, in one pass:
// ops/precision.py's split_bf16 (its plain version is split_bf16_plain).
//
//   g      (rows, n)   fp32, contiguous
//   parts  (rows, 3w)  bf16, each row [lo | mid | hi], each block w >= n wide
//                      and zero past its first n columns
//   hi  = g with its lower 16 bits cleared (g rounded toward zero to bf16)
//   mid = the same of g - hi (exact in fp32)
//   lo  = g - hi - mid (exact in fp32, then rounded to nearest bf16: exact
//         wherever bf16 holds g's lowest bit, |g| >= 2^-110)
//
// No multiply, and __fsub_rn, so nothing is contracted into an FMA; built
// without fast math, so subnormals are kept. The work is bytes: 4 read and 6
// written an element. Each thread takes V consecutive columns of one row
// (V = 4, 2 or 1, the largest that divides n and w): a 4V-byte load and
// three 2V-byte stores; consecutive threads take consecutive slots, so the
// loads and stores of a warp are contiguous runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ void split_one(float g, uint16_t& lo, uint16_t& mid, uint16_t& hi) {
  const uint32_t hi_bits = __float_as_uint(g) & 0xFFFF0000u;
  const float rest = __fsub_rn(g, __uint_as_float(hi_bits));
  const uint32_t mid_bits = __float_as_uint(rest) & 0xFFFF0000u;
  const float last = __fsub_rn(rest, __uint_as_float(mid_bits));
  hi = static_cast<uint16_t>(hi_bits >> 16);
  mid = static_cast<uint16_t>(mid_bits >> 16);
  lo = __bfloat16_as_ushort(__float2bfloat16_rn(last));
}

template <int V>
struct Vec;
template <>
struct Vec<4> {
  using F = float4;
  using H = uint2;
  static __device__ __forceinline__ void get(const F& x, float* v) {
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
  static __device__ __forceinline__ H pack(const uint16_t* h) {
    return make_uint2(h[0] | (uint32_t(h[1]) << 16), h[2] | (uint32_t(h[3]) << 16));
  }
};
template <>
struct Vec<2> {
  using F = float2;
  using H = uint32_t;
  static __device__ __forceinline__ void get(const F& x, float* v) { v[0] = x.x; v[1] = x.y; }
  static __device__ __forceinline__ H pack(const uint16_t* h) {
    return h[0] | (uint32_t(h[1]) << 16);
  }
};
template <>
struct Vec<1> {
  using F = float;
  using H = uint16_t;
  static __device__ __forceinline__ void get(const F& x, float* v) { v[0] = x; }
  static __device__ __forceinline__ H pack(const uint16_t* h) { return h[0]; }
};

template <int V>
__global__ void split_bf16_kernel(const float* __restrict__ g, uint16_t* __restrict__ parts,
                                  long long rows, int n, int w) {
  using T = Vec<V>;
  const long long per_row = w / V;
  const long long slots = rows * per_row;
  for (long long s = blockIdx.x * (long long)blockDim.x + threadIdx.x; s < slots;
       s += (long long)gridDim.x * blockDim.x) {
    const long long r = s / per_row;
    const int c = int(s - r * per_row) * V;
    uint16_t lo[V], mid[V], hi[V];
    if (c < n) {  // V divides n: a slot is wholly inside the row or wholly past it
      float v[V];
      T::get(*reinterpret_cast<const typename T::F*>(g + r * n + c), v);
#pragma unroll
      for (int i = 0; i < V; ++i) split_one(v[i], lo[i], mid[i], hi[i]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) lo[i] = mid[i] = hi[i] = 0;
    }
    uint16_t* out = parts + r * 3 * (long long)w + c;
    *reinterpret_cast<typename T::H*>(out) = T::pack(lo);
    *reinterpret_cast<typename T::H*>(out + w) = T::pack(mid);
    *reinterpret_cast<typename T::H*>(out + 2 * w) = T::pack(hi);
  }
}

template <int V>
int launch(const void* g, void* parts, long long rows, int n, int w, cudaStream_t stream) {
  const int threads = 256;
  const long long slots = rows * (w / V);
  const long long blocks = (slots + threads - 1) / threads;
  split_bf16_kernel<V><<<int(blocks < 132 * 32 ? blocks : 132 * 32), threads, 0, stream>>>(
      static_cast<const float*>(g), static_cast<uint16_t*>(parts), rows, n, w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns 0 or a cudaError_t code; -1 for a shape
// it does not take (w < n). parts starts 16-byte aligned; V also follows
// g's own alignment.
int split_bf16(const void* g, void* parts, long long rows, int n, int w, void* stream) {
  if (w < n || n < 0) return -1;
  if (rows == 0 || w == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t at = reinterpret_cast<uintptr_t>(g);
  if (n % 4 == 0 && w % 4 == 0 && at % 16 == 0) return launch<4>(g, parts, rows, n, w, s);
  if (n % 2 == 0 && w % 2 == 0 && at % 8 == 0) return launch<2>(g, parts, rows, n, w, s);
  return launch<1>(g, parts, rows, n, w, s);
}

const char* kernel_error_string(int err) {
  return err == -1 ? "shape not taken by the split kernel" : cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
