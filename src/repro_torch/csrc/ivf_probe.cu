// Fused IVF cell probe on Hopper (kernel K4 of the port).
//
// Replaces the TPU kernel `_stream_kernel` / `ivf_probe_stream_pallas` of
// src/repro/kernels/ivf_probe/ivf_probe.py: the top-k of <row, q> over only
// the rows of the nprobe probed cells, read from the cell-grouped table
// `rows` (nlist, cap, d) -- the candidate matrix is never gathered.
//
// Bound: device-memory bytes, about 0.5 flop per byte read. The TPU kernel
// streams one cell per grid step and learns the cell id by scalar prefetch;
// here each block reads its cell id from device memory (`probe`) and turns
// it into a row offset, and the grid is (probed cell, row slice) so that
// enough blocks run to cover the card. Pad slots (id -1) are skipped without
// reading their rows.
//
// Tie order: a candidate's rank is its position in the flat probe-major,
// slot-minor candidate vector (probe slot * cap + slot), so among exact ties
// earlier probed cells win, then lower slots -- the reference's stable merge.
// Ids past the valid candidates come back -1 with score -inf, and `n_valid`
// counts the valid slots of the probed cells.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * rt::kWarp;
constexpr int kTargetBlocks = 264;
constexpr int kMaxRowsPerWarp = 32;

struct Plan {
  int rows_per_block, chunks, S, kout;
  long long nblocks, n0;
};

Plan make_plan(int nprobe, int cap, int k) {
  Plan p;
  const long long want = rt::ceil_div(kTargetBlocks, nprobe);  // slices per cell
  long long rpw = rt::ceil_div(rt::ceil_div(cap, want), kWarps);
  if (rpw < 1) rpw = 1;
  if (rpw > kMaxRowsPerWarp) rpw = kMaxRowsPerWarp;
  p.rows_per_block = static_cast<int>(kWarps * rpw);
  p.chunks = static_cast<int>(rt::ceil_div(cap, p.rows_per_block));
  p.S = rt::next_pow2(p.rows_per_block);
  p.kout = k < p.rows_per_block ? k : p.rows_per_block;
  p.nblocks = static_cast<long long>(nprobe) * p.chunks;
  p.n0 = p.nblocks * p.kout;
  return p;
}

__global__ void __launch_bounds__(kThreads)
ivf_score_topk_kernel(const int* __restrict__ probe, const float* __restrict__ rows,
                      const int* __restrict__ ids, const float* __restrict__ q,
                      int cap, int d, int vec, int rows_per_block, int S, int kout,
                      uint64_t* __restrict__ out, int* __restrict__ n_valid) {
  extern __shared__ uint64_t s[];
  const int warp = threadIdx.x / rt::kWarp, lane = threadIdx.x % rt::kWarp;
  const int pi = blockIdx.x;     // probe slot
  const int chunk = blockIdx.y;  // row slice of the cell
  const long long cell = probe[pi];
  const float* cell_rows = rows + cell * cap * static_cast<long long>(d);
  const int* cell_ids = ids + cell * cap;
  const int slot0 = chunk * rows_per_block;
  for (int i = threadIdx.x; i < S; i += blockDim.x) s[i] = rt::kNoKey;
  __syncthreads();
  int valid = 0;
  for (int r = warp; r < rows_per_block; r += kWarps) {
    const int slot = slot0 + r;
    if (slot >= cap) break;
    if (cell_ids[slot] < 0) continue;  // pad slot: same branch for the warp
    const float acc =
        rt::warp_dot(cell_rows + static_cast<long long>(slot) * d, q, d, lane, vec);
    if (lane == 0) {
      s[r] = rt::make_key(acc, static_cast<uint32_t>(pi) * cap + slot);
      ++valid;
    }
  }
  if (lane == 0 && valid > 0) atomicAdd(n_valid, valid);
  rt::bitonic_sort_desc(s, S);
  const long long b = static_cast<long long>(pi) * gridDim.y + chunk;
  for (int i = threadIdx.x; i < kout; i += blockDim.x) out[b * kout + i] = s[i];
}

__global__ void ivf_decode_kernel(const uint64_t* __restrict__ keys, long long len,
                                  int k, const int* __restrict__ probe,
                                  const int* __restrict__ ids, int cap,
                                  int* __restrict__ out_ids,
                                  float* __restrict__ out_scores) {
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const uint64_t key = i < len ? keys[i] : rt::kNoKey;
    if (key == rt::kNoKey) {
      out_ids[i] = -1;
      out_scores[i] = -INFINITY;
      continue;
    }
    const uint32_t pos = rt::key_tie(key);
    const long long cell = probe[pos / cap];
    out_ids[i] = ids[cell * cap + pos % cap];
    out_scores[i] = rt::key_score(key);
  }
}

}  // namespace

extern "C" long long ivf_probe_scratch_len(int nprobe, int cap, int k) {
  const Plan p = make_plan(nprobe, cap, k);
  return rt::merge_scratch_len(p.n0, k);
}

// Returns a cudaError_t code (0 on success). Launches on `stream` and does
// not synchronise. `rows` is (nlist, cap, d) and `ids` (nlist, cap), both
// contiguous; `probe` holds nprobe cell ids on the device.
extern "C" int ivf_probe_launch(const int* probe, int nprobe, const float* rows,
                                const int* ids, int cap, int d, const float* q, int k,
                                long long* scratch, long long scratch_len,
                                int* out_ids, float* out_scores, int* n_valid,
                                void* stream) {
  if (nprobe <= 0 || cap <= 0 || d <= 0 || k <= 0 || k > rt::kMaxK ||
      static_cast<long long>(nprobe) * cap >= 0xFFFFFFFFll)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(nprobe, cap, k);
  const long long need = rt::merge_scratch_len(p.n0, k);
  if (scratch_len < need) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint64_t* a = reinterpret_cast<uint64_t*>(scratch);
  uint64_t* b = a + need / 2;
  cudaError_t err = cudaMemsetAsync(n_valid, 0, sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = (d % 4 == 0) && (reinterpret_cast<uintptr_t>(rows) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(q) % 16 == 0);
  const size_t smem = static_cast<size_t>(p.S) * sizeof(uint64_t);
  const dim3 grid(static_cast<unsigned>(nprobe), static_cast<unsigned>(p.chunks));
  ivf_score_topk_kernel<<<grid, kThreads, smem, st>>>(
      probe, rows, ids, q, cap, d, vec, p.rows_per_block, p.S, p.kout, a, n_valid);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint64_t* run = nullptr;
  long long len = 0;
  err = rt::merge_rounds(a, b, p.n0, static_cast<int>(p.nblocks), k, st, &run, &len);
  if (err != cudaSuccess) return static_cast<int>(err);
  ivf_decode_kernel<<<1, 256, 0, st>>>(run, len, k, probe, ids, cap, out_ids,
                                       out_scores);
  return static_cast<int>(cudaGetLastError());
}
