// Shared device code of the port's kernels: the warp dot product every
// kernel scores with, and the streaming top-k of mips_topk and ivf_probe.
//
// A candidate is one 64-bit key: the high word is an order-preserving image
// of its f32 score, the low word is (0xFFFFFFFF - tie), where `tie` is the
// candidate's rank among equal scores (lower wins). Sorting keys in
// descending order therefore sorts by score, highest first, and among exact
// ties by ascending `tie` -- one integer comparison carries the reference's
// whole tie order. Key 0 is "no candidate": it sorts below every real key
// (even a score of -inf) and decodes to id -1, score -inf.
//
// A top-k is found in two stages: each block of the scoring kernel sorts its
// own candidates in shared memory and writes its best `kout`; then
// `topk_merge_kernel` rounds sort groups of `group` keys and keep the best
// `k` of each, until one sorted run is left. Only the candidates' keys ever
// reach device memory, never the full score vector. A batched probe merges
// several independent top-k at once: lane l's keys start `stride` keys after
// lane l-1's, and the merge grid's second dimension is the lane.
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

// Sort s[0..S) descending in shared memory (S a power of two).
__device__ __forceinline__ void bitonic_sort_desc(uint64_t* s, int S) {
  for (int size = 2; size <= S; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int i = threadIdx.x; i < S; i += blockDim.x) {
        const int j = i ^ stride;
        if (j > i) {
          const uint64_t a = s[i], b = s[j];
          const bool desc = (i & size) == 0;
          if (desc ? (a < b) : (a > b)) {
            s[i] = b;
            s[j] = a;
          }
        }
      }
    }
  }
  __syncthreads();
}

// Each block sorts `group` keys of `in` and writes its best k to `out`;
// blockIdx.y is the lane, whose keys lie `stride` keys apart in both.
__global__ void topk_merge_kernel(const uint64_t* __restrict__ in, long long n_in,
                                  int group, int k, uint64_t* __restrict__ out,
                                  long long stride) {
  extern __shared__ uint64_t s[];
  in += blockIdx.y * stride;
  out += blockIdx.y * stride;
  const long long base = static_cast<long long>(blockIdx.x) * group;
  for (int i = threadIdx.x; i < group; i += blockDim.x) {
    const long long g = base + i;
    s[i] = g < n_in ? in[g] : kNoKey;
  }
  bitonic_sort_desc(s, group);
  for (int i = threadIdx.x; i < k; i += blockDim.x)
    out[static_cast<long long>(blockIdx.x) * k + i] = s[i];
}

inline int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

inline long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

constexpr int kMergeThreads = 1024;
constexpr int kMaxK = 8192;

inline int merge_group(int k) {
  const int g = 2 * next_pow2(k);
  return g < 4096 ? 4096 : g;
}

// Scratch keys needed to merge `n0` keys down to one sorted run of k:
// two buffers, each as large as any round's input or output.
inline long long merge_scratch_len(long long n0, int k) {
  long long m = n0;
  const long long first = ceil_div(n0, merge_group(k)) * k;
  if (first > m) m = first;
  if (k > m) m = k;
  return 2 * m;
}

// Merge rounds on the stream. `a` holds n0 keys in `runs` sorted runs (for
// each of `lanes` lanes, `stride` keys apart; `b` likewise); *result points
// at the one sorted run left (length *len, lanes still `stride` apart).
inline cudaError_t merge_rounds(uint64_t* a, uint64_t* b, long long n0, int runs,
                                int k, cudaStream_t stream,
                                const uint64_t** result, long long* len,
                                int lanes = 1, long long stride = 0) {
  const int group = merge_group(k);
  const size_t smem = static_cast<size_t>(group) * sizeof(uint64_t);
  cudaError_t err = cudaFuncSetAttribute(
      topk_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  long long n = n0;
  bool single = runs <= 1;
  while (!single) {
    const long long groups = ceil_div(n, group);
    const dim3 grid(static_cast<unsigned>(groups), static_cast<unsigned>(lanes));
    topk_merge_kernel<<<grid, kMergeThreads, smem, stream>>>(a, n, group, k, b,
                                                             stride);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    n = groups * k;
    single = groups == 1;
    uint64_t* t = a;
    a = b;
    b = t;
  }
  *result = a;
  *len = n;
  return cudaSuccess;
}

}  // namespace rt

// Message for a code returned by one of the launch functions.
extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
