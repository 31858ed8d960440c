// Streaming top-k MIPS on Hopper (kernel K1 of the port).
//
// Replaces the TPU kernel `_kernel` / `mips_topk_pallas` of
// src/repro/kernels/mips_topk/mips_topk.py: the top-k of <V_j, q> over the n
// rows of V without writing the (n,) score vector to device memory.
//
// Bound: device-memory bytes. Each row is read once (n*d*4 bytes) for 2*d
// flops, about 0.5 flop per byte, far under the card's balance point. The
// design therefore spends its effort on keeping loads in flight: one warp
// per row with four independent 16-byte loads per lane, and enough blocks
// (about two per SM) to cover the card. Each block keeps its candidates in
// shared memory, sorts them there and writes only its best k keys; merge
// rounds (common.cuh) reduce the blocks' keys to the final k.
//
// Modes:
//   0 plain: rank by <V_j, q>, ties to the lower row id;
//   1 abs:   rank by |<V_j, q>|, ties to the lower row id;
//   2 aug:   each row gives +s as id j and -s as id j+n (the complement row
//            of paper §3.4). Among exact ties the lower row j wins, and for
//            one row +id j comes before -id j+n. (The TPU kernel's order
//            among exact ties depends on its tile size; this one does not.)
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * rt::kWarp;
constexpr int kTargetBlocks = 264;  // two per SM of an H100 SXM
constexpr int kMaxRowsPerWarp = 32;

struct Plan {
  int rows_per_block, ncand, S, kout;
  long long nblocks, n0;
};

Plan make_plan(int n, int k, int mode) {
  Plan p;
  long long rpw = rt::ceil_div(n, static_cast<long long>(kWarps) * kTargetBlocks);
  if (rpw < 1) rpw = 1;
  if (rpw > kMaxRowsPerWarp) rpw = kMaxRowsPerWarp;
  p.rows_per_block = static_cast<int>(kWarps * rpw);
  p.ncand = mode == 2 ? 2 * p.rows_per_block : p.rows_per_block;
  p.S = rt::next_pow2(p.ncand);
  p.kout = k < p.ncand ? k : p.ncand;
  p.nblocks = rt::ceil_div(n, p.rows_per_block);
  p.n0 = p.nblocks * p.kout;
  return p;
}

__global__ void __launch_bounds__(kThreads)
mips_score_topk_kernel(const float* __restrict__ V, const float* __restrict__ q,
                       int n, int d, int mode, int vec, int rows_per_block, int S,
                       int kout, uint64_t* __restrict__ out) {
  extern __shared__ uint64_t s[];
  const int warp = threadIdx.x / rt::kWarp, lane = threadIdx.x % rt::kWarp;
  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  for (int i = threadIdx.x; i < S; i += blockDim.x) s[i] = rt::kNoKey;
  __syncthreads();
  for (int r = warp; r < rows_per_block; r += kWarps) {
    const long long j = row0 + r;
    if (j >= n) break;
    const float acc = rt::warp_dot(V + j * d, q, d, lane, vec);
    if (lane == 0) {
      const uint32_t jj = static_cast<uint32_t>(j);
      if (mode == 0) {
        s[r] = rt::make_key(acc, jj);
      } else if (mode == 1) {
        s[r] = rt::make_key(fabsf(acc), jj);
      } else {
        s[2 * r] = rt::make_key(acc, 2u * jj);
        s[2 * r + 1] = rt::make_key(-acc, 2u * jj + 1u);
      }
    }
  }
  rt::bitonic_sort_desc(s, S);
  for (int i = threadIdx.x; i < kout; i += blockDim.x)
    out[static_cast<long long>(blockIdx.x) * kout + i] = s[i];
}

__global__ void mips_decode_kernel(const uint64_t* __restrict__ keys, long long len,
                                   int k, int n, int mode, int* __restrict__ out_ids,
                                   float* __restrict__ out_scores) {
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const uint64_t key = i < len ? keys[i] : rt::kNoKey;
    if (key == rt::kNoKey) {
      out_ids[i] = -1;
      out_scores[i] = -INFINITY;
      continue;
    }
    const uint32_t tie = rt::key_tie(key);
    out_scores[i] = rt::key_score(key);
    out_ids[i] = mode == 2 ? static_cast<int>(tie >> 1) + ((tie & 1u) ? n : 0)
                           : static_cast<int>(tie);
  }
}

}  // namespace

extern "C" long long mips_topk_scratch_len(int n, int k, int mode) {
  const Plan p = make_plan(n, k, mode);
  return rt::merge_scratch_len(p.n0, k);
}

// Returns a cudaError_t code (0 on success). Launches on `stream` and does
// not synchronise.
extern "C" int mips_topk_launch(const float* V, const float* q, int n, int d, int k,
                                int mode, long long* scratch, long long scratch_len,
                                int* out_ids, float* out_scores, void* stream) {
  if (n <= 0 || d <= 0 || k <= 0 || k > rt::kMaxK || mode < 0 || mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(n, k, mode);
  const long long need = rt::merge_scratch_len(p.n0, k);
  if (scratch_len < need) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint64_t* a = reinterpret_cast<uint64_t*>(scratch);
  uint64_t* b = a + need / 2;
  const int vec = (d % 4 == 0) && (reinterpret_cast<uintptr_t>(V) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(q) % 16 == 0);
  const size_t smem = static_cast<size_t>(p.S) * sizeof(uint64_t);
  mips_score_topk_kernel<<<static_cast<unsigned>(p.nblocks), kThreads, smem, st>>>(
      V, q, n, d, mode, vec, p.rows_per_block, p.S, p.kout, a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint64_t* run = nullptr;
  long long len = 0;
  err = rt::merge_rounds(a, b, p.n0, static_cast<int>(p.nblocks), k, st, &run, &len);
  if (err != cudaSuccess) return static_cast<int>(err);
  mips_decode_kernel<<<1, 256, 0, st>>>(run, len, k, n, mode, out_ids, out_scores);
  return static_cast<int>(cudaGetLastError());
}
