// Fused IVF cell probe on Hopper: kernel K4 (one probe) and kernel K5 (a
// wave of B probes, at the end of this file).
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

// ---------------------------------------------------------------------------
// K5: the wave-batched probe.
//
// Replaces the TPU kernel `_stream_batch_kernel` / `ivf_probe_stream_batch_pallas`
// of src/repro/kernels/ivf_probe/ivf_probe.py: B probe vectors at once, over
// the deduplicated union of the cells they probe (`slots`, planned by
// `batch_probe_slots`: unique cells ascending, then a duplicate tail that no
// lane is a member of). Each unique cell's rows are read from device memory
// once for the whole wave and scored against every lane; a lane that did
// not probe the cell (`member[slot, lane] == 0`) gets no candidate from it,
// and each lane keeps its own top-k.
//
// Bound: device-memory bytes. At B = 8 a row read is 4 bytes for 2·B = 16
// flop, 4 flop a byte, under the card's f32 ridge (~20); the least traffic is
// the unique cells' valid rows plus the B probes. The B probes do not fit in
// shared memory whole (B·d floats, 512 KB at d = 2^14, B = 8), so a block
// takes a slice of rows of one slot's cell and walks d in tiles: it stages a
// (B x kDTile) slice of the probes in shared memory and each warp keeps a
// (RPW rows x B lanes) accumulator in registers -- a small GEMM on the FMA
// units, each probe value read from shared memory once for RPW rows. The
// grid is (slot, row slice), so the 10-ish probed cells of a lane times B
// lanes give enough blocks; the count of unique slots lives on the device,
// so the grid covers all B·nprobe slots and a block whose slot has no
// member lane (the duplicate tail), or whose slice holds only pad rows,
// writes empty keys and exits before it reads a row. Pad rows (id -1) are
// not read.
//
// Tie order: a candidate's rank is (slot position) · cap + row slot, so among
// exact ties a lower unique cell id wins, then a lower slot -- the order of
// the batch reference, which can differ from a single-lane K4 probe (probe
// order) on exact ties only. `n_valid[l]` counts the valid rows of lane l's
// own probed cells.
namespace {

constexpr int kBatchWarps = 8;
constexpr int kBatchThreads = kBatchWarps * rt::kWarp;
constexpr int kDTile = 512;  // probe floats of one lane staged per d tile
constexpr int kMaxLanes = 16;

struct BatchPlan {
  int lanes_p2, rpw, rows_per_block, chunks, kout;
  long long nblocks, n0;  // blocks, and keys a lane holds after scoring
};

BatchPlan make_batch_plan(int n_slots, int cap, int k, int lanes) {
  BatchPlan p;
  p.lanes_p2 = rt::next_pow2(lanes);
  p.rpw = p.lanes_p2 > 8 ? 4 : 8;  // RPW x B accumulators stay <= 64 a thread
  p.rows_per_block = kBatchWarps * p.rpw;
  p.chunks = static_cast<int>(rt::ceil_div(cap, p.rows_per_block));
  p.kout = k < p.rows_per_block ? k : p.rows_per_block;
  p.nblocks = static_cast<long long>(n_slots) * p.chunks;
  p.n0 = p.nblocks * p.kout;
  return p;
}

long long batch_lane_stride(const BatchPlan& p, int k) {
  return rt::merge_scratch_len(p.n0, k) / 2;
}

__device__ __forceinline__ float4 load_row4(const float* __restrict__ p, int rem,
                                            int vec) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(p));
  float4 x;
  x.x = rem > 0 ? __ldg(p) : 0.0f;
  x.y = rem > 1 ? __ldg(p + 1) : 0.0f;
  x.z = rem > 2 ? __ldg(p + 2) : 0.0f;
  x.w = rem > 3 ? __ldg(p + 3) : 0.0f;
  return x;
}

// Sort each of `nseg` segments of `seg` keys (a power of two) descending.
__device__ __forceinline__ void bitonic_sort_segments_desc(uint64_t* s, int seg,
                                                           int nseg) {
  const int n = seg * nseg;
  for (int size = 2; size <= seg; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int j = i ^ stride;  // stays in i's segment: stride < seg
        if (j > i) {
          const uint64_t a = s[i], b = s[j];
          const bool desc = ((i % seg) & size) == 0;
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

template <int NB, int RPW>
__global__ void __launch_bounds__(kBatchThreads)
ivf_batch_score_kernel(const int* __restrict__ slots, const float* __restrict__ member,
                       int lanes, const float* __restrict__ rows,
                       const int* __restrict__ ids, const float* __restrict__ qb,
                       int cap, int d, int vec, int kout, long long lane_stride,
                       uint64_t* __restrict__ out, int* __restrict__ n_valid) {
  constexpr int R = kBatchWarps * RPW;
  __shared__ __align__(16) float qs[NB * kDTile];
  __shared__ uint64_t keys[NB * R];
  __shared__ int in_lane[NB];
  __shared__ int block_valid;
  const int warp = threadIdx.x / rt::kWarp, lane = threadIdx.x % rt::kWarp;
  const int si = blockIdx.x, chunk = blockIdx.y;
  const long long blk = static_cast<long long>(si) * gridDim.y + chunk;
  const int tid = threadIdx.x;
  if (tid < NB)
    in_lane[tid] = tid < lanes && member[static_cast<long long>(si) * lanes + tid] > 0.0f;
  if (tid == 0) block_valid = 0;
  __syncthreads();
  int any = 0;
#pragma unroll
  for (int l = 0; l < NB; ++l) any |= in_lane[l];
  const long long cell = any ? slots[si] : 0;
  const int* cell_ids = ids + cell * cap;
  // Rows of this slice that hold a candidate; a pad-only slice (the tail of
  // a cell past its valid rows) or a duplicate tail slot reads nothing more.
  if (any && tid < R && chunk * R + tid < cap && cell_ids[chunk * R + tid] >= 0)
    atomicAdd(&block_valid, 1);
  __syncthreads();
  if (block_valid == 0) {
    for (int i = tid; i < lanes * kout; i += blockDim.x)
      out[(i / kout) * lane_stride + blk * kout + i % kout] = rt::kNoKey;
    return;
  }
  const float* cell_rows = rows + cell * cap * static_cast<long long>(d);
  const int row0 = chunk * R + warp * RPW;  // this warp's RPW rows
  bool valid[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) valid[r] = row0 + r < cap && cell_ids[row0 + r] >= 0;
  float acc[RPW][NB];
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int l = 0; l < NB; ++l) acc[r][l] = 0.0f;

  for (int d0 = 0; d0 < d; d0 += kDTile) {
    __syncthreads();  // the previous tile's probe slice is no longer read
    for (int i = threadIdx.x; i < NB * kDTile; i += blockDim.x) {
      const int l = i / kDTile, e = d0 + i % kDTile;
      qs[i] = (l < lanes && e < d) ? __ldg(qb + static_cast<long long>(l) * d + e) : 0.0f;
    }
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < kDTile / 4 / rt::kWarp; ++j) {
      const int u = lane + j * rt::kWarp;  // float4 unit of the tile
      const int e = d0 + 4 * u;
      if (e < d) {
        float4 x[RPW];
#pragma unroll
        for (int r = 0; r < RPW; ++r)
          x[r] = valid[r] ? load_row4(cell_rows + static_cast<long long>(row0 + r) * d + e,
                                      d - e, vec)
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int l = 0; l < NB; ++l) {
          const float4 q = *reinterpret_cast<const float4*>(qs + l * kDTile + 4 * u);
#pragma unroll
          for (int r = 0; r < RPW; ++r)
            acc[r][l] += x[r].x * q.x + x[r].y * q.y + x[r].z * q.z + x[r].w * q.w;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
#pragma unroll
    for (int l = 0; l < NB; ++l) {
      float a = acc[r][l];
      for (int off = rt::kWarp / 2; off > 0; off >>= 1)
        a += __shfl_xor_sync(0xffffffffu, a, off);
      if (lane == 0)
        keys[l * R + warp * RPW + r] =
            (in_lane[l] && valid[r])
                ? rt::make_key(a, static_cast<uint32_t>(si) * cap + row0 + r)
                : rt::kNoKey;
    }
  }
  bitonic_sort_segments_desc(keys, R, NB);  // syncs first
  if (tid < lanes && in_lane[tid] && block_valid > 0)
    atomicAdd(n_valid + tid, block_valid);
  for (int i = threadIdx.x; i < lanes * kout; i += blockDim.x)
    out[(i / kout) * lane_stride + blk * kout + i % kout] = keys[(i / kout) * R + i % kout];
}

__global__ void ivf_batch_decode_kernel(const uint64_t* __restrict__ keys,
                                        long long len, long long lane_stride, int k,
                                        const int* __restrict__ slots,
                                        const int* __restrict__ ids, int cap,
                                        int* __restrict__ out_ids,
                                        float* __restrict__ out_scores) {
  const int l = blockIdx.x;
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const uint64_t key = i < len ? keys[l * lane_stride + i] : rt::kNoKey;
    const long long o = static_cast<long long>(l) * k + i;
    if (key == rt::kNoKey) {
      out_ids[o] = -1;
      out_scores[o] = -INFINITY;
      continue;
    }
    const uint32_t pos = rt::key_tie(key);
    const long long cell = slots[pos / cap];
    out_ids[o] = ids[cell * cap + pos % cap];
    out_scores[o] = rt::key_score(key);
  }
}

template <int NB, int RPW>
cudaError_t launch_batch_score(dim3 grid, cudaStream_t st, const int* slots,
                               const float* member, int lanes, const float* rows,
                               const int* ids, const float* qb, int cap, int d, int vec,
                               int kout, long long lane_stride, uint64_t* out,
                               int* n_valid) {
  ivf_batch_score_kernel<NB, RPW><<<grid, kBatchThreads, 0, st>>>(
      slots, member, lanes, rows, ids, qb, cap, d, vec, kout, lane_stride, out,
      n_valid);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ivf_probe_batch_max_lanes() { return kMaxLanes; }

extern "C" long long ivf_probe_batch_scratch_len(int n_slots, int cap, int k,
                                                 int lanes) {
  const BatchPlan p = make_batch_plan(n_slots, cap, k, lanes);
  return 2 * lanes * batch_lane_stride(p, k);
}

// Returns a cudaError_t code (0 on success). Launches on `stream` and does
// not synchronise. `slots` (n_slots,) cell ids and `member` (n_slots, lanes)
// 0/1 floats are on the device; `qb` is (lanes, d), `rows` (nlist, cap, d),
// `ids` (nlist, cap); outputs are (lanes, k) ids and scores and (lanes,)
// n_valid.
extern "C" int ivf_probe_batch_launch(const int* slots, const float* member,
                                      int n_slots, int lanes, const float* rows,
                                      const int* ids, int cap, int d, const float* qb,
                                      int k, long long* scratch, long long scratch_len,
                                      int* out_ids, float* out_scores, int* n_valid,
                                      void* stream) {
  if (n_slots <= 0 || lanes <= 0 || lanes > kMaxLanes || cap <= 0 || d <= 0 ||
      k <= 0 || k > rt::kMaxK ||
      static_cast<long long>(n_slots) * cap >= 0xFFFFFFFFll)
    return static_cast<int>(cudaErrorInvalidValue);
  const BatchPlan p = make_batch_plan(n_slots, cap, k, lanes);
  const long long stride = batch_lane_stride(p, k);
  if (scratch_len < 2 * lanes * stride) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint64_t* a = reinterpret_cast<uint64_t*>(scratch);
  uint64_t* b = a + lanes * stride;
  cudaError_t err = cudaMemsetAsync(n_valid, 0, sizeof(int) * lanes, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = (d % 4 == 0) && (reinterpret_cast<uintptr_t>(rows) % 16 == 0);
  const dim3 grid(static_cast<unsigned>(n_slots), static_cast<unsigned>(p.chunks));
  switch (p.lanes_p2) {
    case 1:
      err = launch_batch_score<1, 8>(grid, st, slots, member, lanes, rows, ids, qb,
                                     cap, d, vec, p.kout, stride, a, n_valid);
      break;
    case 2:
      err = launch_batch_score<2, 8>(grid, st, slots, member, lanes, rows, ids, qb,
                                     cap, d, vec, p.kout, stride, a, n_valid);
      break;
    case 4:
      err = launch_batch_score<4, 8>(grid, st, slots, member, lanes, rows, ids, qb,
                                     cap, d, vec, p.kout, stride, a, n_valid);
      break;
    case 8:
      err = launch_batch_score<8, 8>(grid, st, slots, member, lanes, rows, ids, qb,
                                     cap, d, vec, p.kout, stride, a, n_valid);
      break;
    default:
      err = launch_batch_score<16, 4>(grid, st, slots, member, lanes, rows, ids, qb,
                                      cap, d, vec, p.kout, stride, a, n_valid);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint64_t* run = nullptr;
  long long len = 0;
  err = rt::merge_rounds(a, b, p.n0, static_cast<int>(p.nblocks), k, st, &run, &len,
                         lanes, stride);
  if (err != cudaSuccess) return static_cast<int>(err);
  ivf_batch_decode_kernel<<<lanes, 256, 0, st>>>(run, len, stride, k, slots, ids, cap,
                                                 out_ids, out_scores);
  return static_cast<int>(cudaGetLastError());
}
