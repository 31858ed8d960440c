// Streaming top-k MIPS on Hopper (kernel K1 of the port).
//
// Replaces the TPU kernel `_kernel` / `mips_topk_pallas` of
// src/repro/kernels/mips_topk/mips_topk.py: the top-k of <V_j, q> over the n
// rows of V without writing the (n,) score vector to device memory.
//
// Bound: device-memory bytes. Each row is read once (n*d*4 bytes) for 2*d
// flops, about 0.5 flop per byte, far under the card's balance point. So the
// scoring keeps loads in flight on every SM, and the selection
// (topk_select.cuh) touches each candidate's 8-byte key at most twice. Every
// grid is sized from the device's SM count. Three routes, by shape:
//   split  (at most 4096 candidates: the LP dual's 1024 rows, the IVF
//          centroids): one launch. d is split across blocks too -- a warp
//          scores one row's slice of d with 16-byte loads, grid (row groups,
//          splits) with about four blocks an SM -- and the last block to
//          arrive sums each row's partial dots in split order (the bits
//          repeat from run to run), keys the candidates in shared memory,
//          selects, ranks and writes the top k.
//   narrow (d <= 32, many rows: the LP's rows of 21): a block loads whole
//          tiles of 256 rows with coalesced 16-byte loads into shared
//          memory and each thread scores one row.
//   rows   (d > 32, many rows: the flat probe over Q): a warp a row, four
//          16-byte loads in flight a lane.
// narrow and rows write every candidate's key once and count its top 12
// bits; `topk_filter_kernel` keeps the keys at or above the bucket of the
// k-th largest, and one block selects, ranks and decodes those.
//
// Modes:
//   0 plain: rank by <V_j, q>, ties to the lower row id;
//   1 abs:   rank by |<V_j, q>|, ties to the lower row id;
//   2 aug:   each row gives +s as id j and -s as id j+n (the complement row
//            of paper §3.4). Among exact ties the lower row j wins, and for
//            one row +id j comes before -id j+n. (The TPU kernel's order
//            among exact ties depends on its tile size; this one does not.)
#include "topk_select.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * rt::kWarp;
constexpr int kMaxRowsPerWarp = 32;
constexpr int kSplitMaxCand = 4096;  // candidates the split route selects in shared memory
constexpr int kNarrowD = 32;         // rows this short take the narrow route
constexpr int kTileRows = kThreads;  // rows a narrow tile holds, one a thread

enum Route { kSplit = 0, kNarrow = 1, kRows = 2 };

struct Plan {
  int route, S, dsplit, rows_per_block, cache;
  long long n_cand, blocks, filter_blocks, scratch;  // scratch in 8-byte words
};

bool make_plan(int n, int d, int k, int mode, Plan* p) {
  const int sms = rt::sm_count();
  if (sms <= 0) return false;
  p->n_cand = mode == 2 ? 2LL * n : n;
  p->S = 1;
  p->dsplit = d;
  p->rows_per_block = kTileRows;
  p->cache = static_cast<int>(p->n_cand < sel::kCacheKeys ? p->n_cand : sel::kCacheKeys);
  if (p->n_cand <= kSplitMaxCand) {
    p->route = kSplit;
    p->blocks = rt::ceil_div(n, kWarps);
    long long S = rt::ceil_div(4LL * sms, p->blocks);  // about 4 blocks an SM
    const long long smax = rt::ceil_div(d, 128);       // a slice is >= 128 floats
    if (S > smax) S = smax;
    if (S < 1) S = 1;
    p->dsplit = static_cast<int>(4 * rt::ceil_div(rt::ceil_div(d, S), 4));
    p->S = static_cast<int>(rt::ceil_div(d, p->dsplit));
    p->filter_blocks = 0;
    p->scratch = rt::ceil_div(static_cast<long long>(p->S) * n, 2);
    return true;
  }
  if (d <= kNarrowD) {
    p->route = kNarrow;
    p->blocks = rt::ceil_div(n, kTileRows);  // tiles; the launch caps the grid
  } else {
    p->route = kRows;
    long long rpw = rt::ceil_div(n, 2LL * kWarps * sms);  // about 2 blocks an SM
    if (rpw < 1) rpw = 1;
    if (rpw > kMaxRowsPerWarp) rpw = kMaxRowsPerWarp;
    p->rows_per_block = static_cast<int>(kWarps * rpw);
    p->blocks = rt::ceil_div(n, p->rows_per_block);
  }
  const long long fb = rt::ceil_div(p->n_cand, sel::kFilterThreads);
  p->filter_blocks = fb < 4LL * sms ? fb : 4LL * sms;
  p->scratch = 2 * p->n_cand;  // the keys, then the filtered list
  return true;
}

// Writes row j's key (two in aug mode) at its fixed place in `keys` and
// counts its top digit in `hist`. All 32 lanes of the warp call it.
__device__ __forceinline__ void emit(float acc, long long j, bool on, int mode,
                                     uint64_t* __restrict__ keys, unsigned* hist) {
  const uint32_t jj = static_cast<uint32_t>(j);
  if (mode == 2) {
    const uint64_t a = rt::make_key(acc, 2u * jj), b = rt::make_key(-acc, 2u * jj + 1u);
    if (on) reinterpret_cast<ulonglong2*>(keys)[j] = make_ulonglong2(a, b);
    sel::warp_hist_add(hist, sel::top_digit(a), on);
    sel::warp_hist_add(hist, sel::top_digit(b), on);
  } else {
    const uint64_t a = rt::make_key(mode == 1 ? fabsf(acc) : acc, jj);
    if (on) keys[j] = a;
    sel::warp_hist_add(hist, sel::top_digit(a), on);
  }
}

__device__ __forceinline__ void merge_hist(const unsigned* s_hist,
                                           unsigned* __restrict__ hist) {
  for (int b = threadIdx.x; b < sel::kTopBins; b += blockDim.x)
    if (s_hist[b] != 0) atomicAdd(hist + b, s_hist[b]);
}

struct MipsOut {
  int* ids;
  float* scores;
  int n, mode;
  __device__ void operator()(int, int r, uint64_t key) const {
    if (key == rt::kNoKey) {
      ids[r] = -1;
      scores[r] = -INFINITY;
      return;
    }
    const uint32_t tie = rt::key_tie(key);
    scores[r] = rt::key_score(key);
    ids[r] = mode == 2 ? static_cast<int>(tie >> 1) + ((tie & 1u) ? n : 0)
                       : static_cast<int>(tie);
  }
};

// Route split: grid (ceil(n / 8), S); warp w of block (x, s) scores row
// 8x + w over d in [s*dsplit, (s+1)*dsplit). The last block to finish
// selects. `part` holds the (S, n) partial dots.
__global__ void __launch_bounds__(kThreads)
mips_split_kernel(const float* __restrict__ V, const float* __restrict__ q, int n,
                  int d, int k, int mode, int vec, int dsplit, float* __restrict__ part,
                  unsigned* __restrict__ ticket, MipsOut out) {
  extern __shared__ uint64_t s_keys[];  // the candidates' keys, then the selected
  __shared__ sel::Scratch sc;
  __shared__ bool s_last;
  const int warp = threadIdx.x / rt::kWarp, lane = threadIdx.x % rt::kWarp;
  const int S = gridDim.y, s = blockIdx.y, d0 = s * dsplit;
  const long long j = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (j < n) {
    const int len = d - d0 < dsplit ? d - d0 : dsplit;
    const float acc = rt::warp_dot(V + j * d + d0, q + d0, len, lane, vec);
    if (lane == 0) part[static_cast<long long>(s) * n + j] = acc;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(ticket, 1u) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int i = threadIdx.x; i < n; i += kThreads) {
    float acc = 0.0f;
    for (int t = 0; t < S; ++t) acc += __ldcg(part + static_cast<long long>(t) * n + i);
    const uint32_t ii = static_cast<uint32_t>(i);
    if (mode == 2) {
      s_keys[2 * i] = rt::make_key(acc, 2u * ii);
      s_keys[2 * i + 1] = rt::make_key(-acc, 2u * ii + 1u);
    } else {
      s_keys[i] = rt::make_key(mode == 1 ? fabsf(acc) : acc, ii);
    }
  }
  if (threadIdx.x == 0) *ticket = 0;
  __syncthreads();
  const int n_cand = mode == 2 ? 2 * n : n;
  uint64_t* chosen = s_keys + n_cand;
  const int ns = sel::block_select(s_keys, n_cand, k, chosen, sc);
  sel::block_rank(chosen, ns, k, [&](int r, uint64_t key) { out(0, r, key); });
}

// Route narrow: tiles of kTileRows whole rows, one thread a row.
__global__ void __launch_bounds__(kThreads)
mips_narrow_kernel(const float* __restrict__ V, const float* __restrict__ q, int n,
                   int d, int mode, int vec, uint64_t* __restrict__ keys,
                   unsigned* __restrict__ hist) {
  extern __shared__ __align__(16) float tile[];  // kTileRows x d
  __shared__ unsigned s_hist[sel::kTopBins];
  __shared__ float s_q[kNarrowD];
  const int tid = threadIdx.x;
  for (int b = tid; b < sel::kTopBins; b += kThreads) s_hist[b] = 0;
  if (tid < d) s_q[tid] = q[tid];
  const long long tiles = rt::ceil_div(n, kTileRows);
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long row0 = t * kTileRows;
    const int rows = n - row0 < kTileRows ? static_cast<int>(n - row0) : kTileRows;
    const int nf = rows * d;
    const float* src = V + row0 * d;
    __syncthreads();  // the previous tile is scored
    int done = 0;
    if (vec) {  // row0 * d is a multiple of 4, so src is 16-byte aligned
      const float4* s4 = reinterpret_cast<const float4*>(src);
      float4* t4 = reinterpret_cast<float4*>(tile);
      for (int i = tid; i < nf / 4; i += kThreads) t4[i] = __ldg(s4 + i);
      done = nf / 4 * 4;
    }
    for (int i = done + tid; i < nf; i += kThreads) tile[i] = __ldg(src + i);
    __syncthreads();
    float acc = 0.0f;
    if (tid < rows) {
      const float* row = tile + tid * d;  // stride d: conflict-free for odd d
      for (int e = 0; e < d; ++e) acc += row[e] * s_q[e];
    }
    emit(acc, row0 + tid, tid < rows, mode, keys, s_hist);
  }
  __syncthreads();
  merge_hist(s_hist, hist);
}

// Route rows: a warp a row, rows_per_block rows a block.
__global__ void __launch_bounds__(kThreads)
mips_rows_kernel(const float* __restrict__ V, const float* __restrict__ q, int n, int d,
                 int mode, int vec, int rows_per_block, uint64_t* __restrict__ keys,
                 unsigned* __restrict__ hist) {
  __shared__ unsigned s_hist[sel::kTopBins];
  const int warp = threadIdx.x / rt::kWarp, lane = threadIdx.x % rt::kWarp;
  for (int b = threadIdx.x; b < sel::kTopBins; b += kThreads) s_hist[b] = 0;
  __syncthreads();
  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  for (int r = warp; r < rows_per_block; r += kWarps) {
    const long long j = row0 + r;
    if (j >= n) break;
    const float acc = rt::warp_dot(V + j * d, q, d, lane, vec);
    emit(acc, j, lane == 0, mode, keys, s_hist);
  }
  __syncthreads();
  merge_hist(s_hist, hist);
}

cudaError_t set_smem(const void* fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// The launch plan: out = {route (0 split, 1 narrow, 2 rows), splits of d,
// scoring blocks, filter blocks, scratch words}. Returns 0, or -1 if the
// device cannot be queried.
extern "C" int mips_topk_plan(int n, int d, int k, int mode, long long* out) {
  Plan p;
  if (!make_plan(n, d, k, mode, &p)) return -1;
  out[0] = p.route;
  out[1] = p.S;
  out[2] = p.blocks;
  out[3] = p.filter_blocks;
  out[4] = p.scratch;
  return 0;
}

// Returns a cudaError_t code (0 on success). Launches on `stream` and does
// not synchronise. `ws` is the zeroed workspace of topk_select.cuh.
extern "C" int mips_topk_launch(const float* V, const float* q, int n, int d, int k,
                                int mode, long long* scratch, long long scratch_len,
                                int* ws, long long ws_len, int* out_ids,
                                float* out_scores, void* stream) {
  Plan p;
  if (n <= 0 || d <= 0 || k <= 0 || k > rt::kMaxK || mode < 0 || mode > 2 ||
      !make_plan(n, d, k, mode, &p) || k > p.n_cand || scratch_len < p.scratch ||
      ws_len < topk_workspace_len(1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned* w = reinterpret_cast<unsigned*>(ws);
  const MipsOut out{out_ids, out_scores, n, mode};
  const bool aligned = reinterpret_cast<uintptr_t>(V) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const int vec = d % 4 == 0 && aligned;
  cudaError_t err;
  if (p.route == kSplit) {
    const size_t smem = static_cast<size_t>(p.n_cand + (k < p.n_cand ? k : p.n_cand)) *
                        sizeof(uint64_t);
    err = set_smem(reinterpret_cast<const void*>(mips_split_kernel), smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(static_cast<unsigned>(p.blocks), static_cast<unsigned>(p.S));
    mips_split_kernel<<<grid, kThreads, smem, st>>>(
        V, q, n, d, k, mode, vec, p.dsplit, reinterpret_cast<float*>(scratch),
        w + sel::kWsTickets, out);
    return static_cast<int>(cudaGetLastError());
  }
  // Every attribute is set before the first launch: a refused launch must
  // not leave the workspace's histogram counted.
  size_t fsmem = 0;
  err = sel::finish_prepare<MipsOut>(k, p.cache, &fsmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  uint64_t* keys = reinterpret_cast<uint64_t*>(scratch);
  uint64_t* list = keys + p.n_cand;
  unsigned* hist = w + sel::kWsHist;
  unsigned* count = w + sel::kWsCounts;
  if (p.route == kNarrow) {
    const size_t smem = static_cast<size_t>(kTileRows) * d * sizeof(float);
    err = set_smem(reinterpret_cast<const void*>(mips_narrow_kernel), smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mips_narrow_kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long cap = static_cast<long long>(per_sm > 0 ? per_sm : 1) * rt::sm_count();
    const long long blocks = p.blocks < cap ? p.blocks : cap;
    mips_narrow_kernel<<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(
        V, q, n, d, mode, reinterpret_cast<uintptr_t>(V) % 16 == 0, keys, hist);
  } else {
    mips_rows_kernel<<<static_cast<unsigned>(p.blocks), kThreads, 0, st>>>(
        V, q, n, d, mode, vec, p.rows_per_block, keys, hist);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sel::topk_filter_kernel<<<static_cast<unsigned>(p.filter_blocks), sel::kFilterThreads,
                            0, st>>>(keys, p.n_cand, hist, k, list, count);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sel::topk_finish_kernel<MipsOut><<<1, sel::kFinishThreads, fsmem, st>>>(
      list, 0, count, k, p.cache, hist, sel::kTopBins, nullptr, out);
  return static_cast<int>(cudaGetLastError());
}
