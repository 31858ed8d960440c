// Shared device code of the port's kernels: the 64-bit candidate keys of
// the top-k kernels (selected by topk_select.cuh), the warp dot product
// that mips_topk scores with, and the cp.async copies of
// ivf_probe's wave (K5) and ssd_scan.
//
// A candidate is one 64-bit key: the high word is an order-preserving image
// of its f32 score, the low word is (0xFFFFFFFF - tie), where `tie` is the
// candidate's rank among equal scores (lower wins). Sorting keys in
// descending order therefore sorts by score, highest first, and among exact
// ties by ascending `tie` -- one integer comparison carries the reference's
// whole tie order. Key 0 is "no candidate": it sorts below every real key
// (even a score of -inf) and decodes to id -1, score -inf.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace rt {

constexpr int kWarp = 32;
constexpr uint64_t kNoKey = 0ull;

__device__ __forceinline__ uint32_t ord_f32(float x) {
  if (x == 0.0f) x = 0.0f;  // fold -0 onto +0: they tie, as in the plain sort
  uint32_t u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unord_f32(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u);
}

__device__ __forceinline__ uint64_t make_key(float score, uint32_t tie) {
  return (static_cast<uint64_t>(ord_f32(score)) << 32) |
         static_cast<uint64_t>(0xFFFFFFFFu - tie);
}

__device__ __forceinline__ float key_score(uint64_t key) {
  return unord_f32(static_cast<uint32_t>(key >> 32));
}

__device__ __forceinline__ uint32_t key_tie(uint64_t key) {
  return 0xFFFFFFFFu - static_cast<uint32_t>(key & 0xFFFFFFFFull);
}

// <row, q> over d floats by one warp, f32 accumulation; every lane returns
// the sum. `vec` says both pointers are 16-byte aligned and d % 4 == 0.
__device__ __forceinline__ float warp_dot(const float* __restrict__ row,
                                          const float* __restrict__ q, int d,
                                          int lane, int vec) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  if (vec) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    const float4* q4 = reinterpret_cast<const float4*>(q);
    const int d4 = d >> 2;
    int i = lane;
    // four independent 16-byte loads in flight per lane
    for (; i + 3 * kWarp < d4; i += 4 * kWarp) {
      float4 x0 = __ldg(r4 + i), x1 = __ldg(r4 + i + kWarp);
      float4 x2 = __ldg(r4 + i + 2 * kWarp), x3 = __ldg(r4 + i + 3 * kWarp);
      float4 y0 = __ldg(q4 + i), y1 = __ldg(q4 + i + kWarp);
      float4 y2 = __ldg(q4 + i + 2 * kWarp), y3 = __ldg(q4 + i + 3 * kWarp);
      a0 += x0.x * y0.x + x0.y * y0.y + x0.z * y0.z + x0.w * y0.w;
      a1 += x1.x * y1.x + x1.y * y1.y + x1.z * y1.z + x1.w * y1.w;
      a2 += x2.x * y2.x + x2.y * y2.y + x2.z * y2.z + x2.w * y2.w;
      a3 += x3.x * y3.x + x3.y * y3.y + x3.z * y3.z + x3.w * y3.w;
    }
    for (; i < d4; i += kWarp) {
      float4 x = __ldg(r4 + i), y = __ldg(q4 + i);
      a0 += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
    }
  } else {
    for (int i = lane; i < d; i += kWarp) a0 += __ldg(row + i) * __ldg(q + i);
  }
  float acc = (a0 + a1) + (a2 + a3);
  for (int off = kWarp / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

// cp.async copies of 16 or 4 bytes from device to shared memory; `bytes`
// below the size zero-fills the rest (0: a zero fill that reads nothing).
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

inline int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

__host__ __device__ inline long long ceil_div(long long a, long long b) {
  return (a + b - 1) / b;
}

constexpr int kMaxK = 8192;

// Streaming multiprocessors of the current device, which the top-k kernels
// size their grids from; 0 if the device cannot be queried.
inline int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0 &&
      cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    cached[dev] = 0;
  return cached[dev];
}

}  // namespace rt

// Message for a code returned by one of the launch functions.
extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
