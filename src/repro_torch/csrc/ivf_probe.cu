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
// it into a row offset, and the grid is (probed cell, row slice), sized from
// the device's SM count, so that enough blocks run to cover the card. A warp
// scores a row. Pad slots (id -1) are skipped without reading their rows.
// Each block appends its valid rows' keys to one list, and one block selects
// the top k of the list (topk_select.cuh); the list's length is `n_valid`.
//
// Tie order: a candidate's rank is its position in the flat probe-major,
// slot-minor candidate vector (probe slot * cap + slot), so among exact ties
// earlier probed cells win, then lower slots -- the reference's stable merge.
// Ids past the valid candidates come back -1 with score -inf, and `n_valid`
// counts the valid slots of the probed cells.
#include "topk_select.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * rt::kWarp;
constexpr int kMaxRowsPerWarp = 32;

// Decodes a key of slot position pos = (slot * cap + row) into the row id
// of `cells` (slot `slot` holds cell cells_of[slot]); lane l's k outputs
// start at l * k.
struct ProbeOut {
  const int* cells_of;
  const int* ids;
  int cap, k;
  int* out_ids;
  float* out_scores;
  __device__ void operator()(int lane, int r, uint64_t key) const {
    const long long o = static_cast<long long>(lane) * k + r;
    if (key == rt::kNoKey) {
      out_ids[o] = -1;
      out_scores[o] = -INFINITY;
      return;
    }
    const uint32_t pos = rt::key_tie(key);
    const long long cell = cells_of[pos / cap];
    out_ids[o] = ids[cell * cap + pos % cap];
    out_scores[o] = rt::key_score(key);
  }
};

struct Plan {
  int rows_per_block, chunks, cache;
  long long list_len;
};

bool make_plan(int nprobe, int cap, Plan* p) {
  const int sms = rt::sm_count();
  if (sms <= 0) return false;
  const long long want = rt::ceil_div(2LL * sms, nprobe);  // slices a cell
  long long rpw = rt::ceil_div(rt::ceil_div(cap, want), kWarps);
  if (rpw < 1) rpw = 1;
  if (rpw > kMaxRowsPerWarp) rpw = kMaxRowsPerWarp;
  p->rows_per_block = static_cast<int>(kWarps * rpw);
  p->chunks = static_cast<int>(rt::ceil_div(cap, p->rows_per_block));
  p->list_len = static_cast<long long>(nprobe) * cap;
  p->cache = static_cast<int>(p->list_len < sel::kCacheKeys ? p->list_len
                                                            : sel::kCacheKeys);
  return true;
}

__global__ void __launch_bounds__(kThreads)
ivf_score_kernel(const int* __restrict__ probe, const float* __restrict__ rows,
                 const int* __restrict__ ids, const float* __restrict__ q, int cap,
                 int d, int vec, int rows_per_block, uint64_t* __restrict__ list,
                 unsigned* __restrict__ count) {
  __shared__ uint64_t s_keys[kWarps * kMaxRowsPerWarp];
  __shared__ unsigned s_n, s_base;
  const int warp = threadIdx.x / rt::kWarp, lane = threadIdx.x % rt::kWarp;
  const int pi = blockIdx.x;     // probe slot
  const int chunk = blockIdx.y;  // row slice of the cell
  const long long cell = probe[pi];
  const float* cell_rows = rows + cell * cap * static_cast<long long>(d);
  const int* cell_ids = ids + cell * cap;
  const int slot0 = chunk * rows_per_block;
  if (threadIdx.x == 0) s_n = 0;
  __syncthreads();
  for (int r = warp; r < rows_per_block; r += kWarps) {
    const int slot = slot0 + r;
    if (slot >= cap) break;
    if (cell_ids[slot] < 0) continue;  // pad slot: same branch for the warp
    const float acc =
        rt::warp_dot(cell_rows + static_cast<long long>(slot) * d, q, d, lane, vec);
    if (lane == 0)
      s_keys[atomicAdd(&s_n, 1u)] =
          rt::make_key(acc, static_cast<uint32_t>(pi) * cap + slot);
  }
  __syncthreads();
  if (s_n == 0) return;
  if (threadIdx.x == 0) s_base = atomicAdd(count, s_n);
  __syncthreads();
  for (unsigned i = threadIdx.x; i < s_n; i += kThreads) list[s_base + i] = s_keys[i];
}

}  // namespace

// Scratch words (8-byte) a launch needs, or -1 if the device cannot be queried.
extern "C" long long ivf_probe_scratch_len(int nprobe, int cap) {
  Plan p;
  return make_plan(nprobe, cap, &p) ? p.list_len : -1;
}

// Returns a cudaError_t code (0 on success). Launches on `stream` and does
// not synchronise. `rows` is (nlist, cap, d) and `ids` (nlist, cap), both
// contiguous; `probe` holds nprobe cell ids on the device; `ws` is the
// zeroed workspace of topk_select.cuh.
extern "C" int ivf_probe_launch(const int* probe, int nprobe, const float* rows,
                                const int* ids, int cap, int d, const float* q, int k,
                                long long* scratch, long long scratch_len, int* ws,
                                long long ws_len, int* out_ids, float* out_scores,
                                int* n_valid, void* stream) {
  Plan p;
  if (nprobe <= 0 || cap <= 0 || d <= 0 || k <= 0 || k > rt::kMaxK ||
      static_cast<long long>(nprobe) * cap >= 0xFFFFFFFFll || !make_plan(nprobe, cap, &p) ||
      scratch_len < p.list_len || ws_len < topk_workspace_len(0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  size_t fsmem = 0;
  cudaError_t err = sel::finish_prepare<ProbeOut>(k, p.cache, &fsmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  uint64_t* list = reinterpret_cast<uint64_t*>(scratch);
  unsigned* count = reinterpret_cast<unsigned*>(ws) + sel::kWsCounts;
  const int vec = (d % 4 == 0) && (reinterpret_cast<uintptr_t>(rows) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(q) % 16 == 0);
  const dim3 grid(static_cast<unsigned>(nprobe), static_cast<unsigned>(p.chunks));
  ivf_score_kernel<<<grid, kThreads, 0, st>>>(probe, rows, ids, q, cap, d, vec,
                                             p.rows_per_block, list, count);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sel::topk_finish_kernel<ProbeOut><<<1, sel::kFinishThreads, fsmem, st>>>(
      list, 0, count, k, p.cache, nullptr, 0, n_valid,
      ProbeOut{probe, ids, cap, k, out_ids, out_scores});
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
// flop, 4 flop a byte, under the card's f32 ridge (~20), so the FMA units
// suffice; the least traffic is the unique cells' valid rows plus the B
// probes. A wave's lanes share most cells -- at the main path's shape the 80
// slots of 8 lanes hold about ten unique cells -- so the work is split three
// ways to fill the card: an item is a (slot, 8·RPW-row chunk) pair, and d is
// cut into S slices of `dsplit` floats, S sized so that the items a wave is
// likely to keep busy (nprobe cells, half their chunks) give two blocks an
// SM. The grid is (workers, S): as many blocks as fit the card, each keeping
// one d-slice and walking the items `workers` apart. A block streams an
// item's rows and the B probes' matching floats through a three-stage
// cp.async ring of 128-float tiles, two tiles in flight while one is scored,
// with one barrier a tile; a lane keeps an (RPW rows x B lanes) accumulator.
// The count of unique slots lives on the device: every block finds the last
// slot any lane is a member of, and items past it, items of a slot no lane is
// a member of, and chunks of pad rows only are skipped before a row is read;
// pad rows are not read. Each block writes its (row, lane) partial dots; the
// last of an item's S blocks sums them in split order (the bits repeat from
// run to run), keys them and appends each lane's keys to that lane's list. A
// second launch selects each lane's top k (one block a lane,
// topk_select.cuh).
//
// Tie order: a candidate's rank is (slot position) · cap + row slot, so among
// exact ties a lower unique cell id wins, then a lower slot -- the order of
// the batch reference, which can differ from a single-lane K4 probe (probe
// order) on exact ties only. `n_valid[l]` counts the valid rows of lane l's
// own probed cells: the length of lane l's list.
namespace {

constexpr int kStageW = 128;  // floats of a row (and of a probe) a ring tile holds
constexpr int kStages = 3;
constexpr int kMaxLanes = 16;

struct WavePlan {
  int nb, rpw, rows, chunks, dsplit, S, workers;
  long long items, part_len, list_stride, scratch;  // part_len in floats
  size_t smem;
};

bool make_wave_plan(int n_slots, int cap, int d, int lanes, WavePlan* p) {
  const int sms = rt::sm_count();
  if (sms <= 0) return false;
  p->nb = rt::next_pow2(lanes);
  p->rpw = p->nb >= 8 ? 4 : 8;  // RPW x B accumulators stay <= 64 a thread
  p->rows = kWarps * p->rpw;
  p->chunks = static_cast<int>(rt::ceil_div(cap, p->rows));
  p->smem = static_cast<size_t>(kStages) * (p->rows + p->nb) * kStageW * sizeof(float);
  const int per_sm = static_cast<int>(227 * 1024 / (p->smem + 1024));
  // items a wave keeps busy: each lane's nprobe cells, about half their chunks
  const long long nprobe = rt::ceil_div(n_slots, lanes);
  const long long busy = nprobe * rt::ceil_div(p->chunks, 2);
  long long S = rt::ceil_div(2LL * sms, busy);
  const long long smax = rt::ceil_div(d, kStageW);
  if (S > smax) S = smax;
  if (S < 1) S = 1;
  p->dsplit = static_cast<int>(kStageW * rt::ceil_div(rt::ceil_div(d, S), kStageW));
  p->S = static_cast<int>(rt::ceil_div(d, p->dsplit));
  p->items = static_cast<long long>(n_slots) * p->chunks;
  long long w = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms / p->S;
  if (w < 1) w = 1;
  if (w > p->items) w = p->items;
  p->workers = static_cast<int>(w);
  p->part_len = p->items * p->S * p->rows * p->nb;
  p->list_stride = static_cast<long long>(n_slots) * cap;
  p->scratch = rt::ceil_div(p->part_len, 2) + lanes * p->list_stride;
  return true;
}

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

// Copies 16 bytes at src (row floats [e, e + 4) of a row whose slice ends at
// `end`) to dst, zero past `end`; `vec`: the floats are 16-byte aligned.
__device__ __forceinline__ void copy_unit(float* dst, const float* row, int e, int end,
                                          int vec) {
  if (vec) {
    cp_async16(dst, e < end ? row + e : row, e < end ? 16 : 0);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      cp_async4(dst + i, e + i < end ? row + e + i : row, e + i < end ? 4 : 0);
  }
}

template <int NB, int RPW>
__global__ void __launch_bounds__(kThreads)
wave_score_kernel(const int* __restrict__ slots, const float* __restrict__ member,
                  int n_slots, int lanes, const float* __restrict__ rows,
                  const int* __restrict__ ids, const float* __restrict__ qb, int cap,
                  int d, int vec, int chunks, int dsplit, float* __restrict__ part,
                  unsigned* __restrict__ tickets, unsigned* __restrict__ next,
                  unsigned* __restrict__ counts, uint64_t* __restrict__ lists,
                  long long list_stride) {
  constexpr int R = kWarps * RPW;    // rows of an item
  constexpr int RN = R * NB;         // (row, lane) partial dots of an item
  constexpr int TILE = (R + NB) * kStageW;  // a ring stage: R rows, then NB probes
  constexpr int UNITS = (R + NB) * (kStageW / 4);  // 16-byte units of a stage
  constexpr int CPT = (UNITS + kThreads - 1) / kThreads;  // units a thread copies
  constexpr int PER = (RN + kThreads - 1) / kThreads;
  extern __shared__ __align__(16) float ring[];  // kStages x TILE
  __shared__ int s_last_slot;
  __shared__ long long s_it;
  __shared__ bool s_in[NB], s_valid[R], s_fin;
  __shared__ unsigned s_cnt[NB], s_base[NB];
  const int tid = threadIdx.x, warp = tid / rt::kWarp, lane = tid % rt::kWarp;
  const int split = blockIdx.y, S = gridDim.y;
  const int d0 = split * dsplit;
  const int dlen = d - d0 < dsplit ? d - d0 : dsplit;
  const int nst = (dlen + kStageW - 1) / kStageW;

  if (tid == 0) s_last_slot = -1;
  __syncthreads();
  for (int i = tid; i < n_slots * lanes; i += kThreads)
    if (member[i] > 0.0f) atomicMax(&s_last_slot, i / lanes);
  __syncthreads();
  const long long items = static_cast<long long>(s_last_slot + 1) * chunks;

  // The blocks of a split take its items in turn from the counter next[split]
  // (zeroed again by the select launch), so a block that drew pad rows or a
  // slot no lane probes moves on at once.
  for (;;) {
    if (tid == 0) s_it = atomicAdd(next + split, 1u);
    __syncthreads();
    const long long it = s_it;
    if (it >= items) break;
    const int si = static_cast<int>(it / chunks), c = static_cast<int>(it % chunks);
    const bool in_l =
        tid < NB && tid < lanes && member[static_cast<long long>(si) * lanes + tid] > 0.0f;
    if (tid < NB) s_in[tid] = in_l;
    if (!__syncthreads_or(in_l)) continue;  // no lane probes this slot
    const long long cell = slots[si];
    const int slot = c * R + tid;
    const bool ok = tid < R && slot < cap && ids[cell * cap + slot] >= 0;
    if (tid < R) s_valid[tid] = ok;
    if (__syncthreads_count(ok) == 0) continue;  // pad rows only

    // Stage st holds floats [st·128, st·128 + 128) of the slice. Thread t
    // copies the same units of every stage: units t, t + 256, ... (unit u:
    // ring row u / 32 -- an item row, then a probe -- floats 4·(u % 32)).
    const float* src[CPT];
    int off[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int u = tid + j * kThreads, r = u / (kStageW / 4);
      off[j] = r * kStageW + 4 * (u % (kStageW / 4));
      src[j] = nullptr;
      if (u < UNITS && r < R && s_valid[r])
        src[j] = rows + (cell * cap + c * R + r) * static_cast<long long>(d) + d0;
      else if (u < UNITS && r >= R && r - R < lanes)
        src[j] = qb + static_cast<long long>(r - R) * d + d0;
    }
    auto issue = [&](int st) {
      if (st < nst) {
        float* tile = ring + (st % kStages) * TILE;
#pragma unroll
        for (int j = 0; j < CPT; ++j)
          if (src[j] != nullptr)
            copy_unit(tile + off[j], src[j], st * kStageW + off[j] % kStageW, dlen, vec);
      }
      cp_async_commit();  // an empty group past the last stage keeps the count
    };
    bool rv[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) rv[r] = s_valid[warp * RPW + r];
    float acc[RPW][NB];
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
      for (int l = 0; l < NB; ++l) acc[r][l] = 0.0f;

    issue(0);
    issue(1);
    for (int st = 0; st < nst; ++st) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // stage st landed for all; stage st - 1 is scored
      issue(st + kStages - 1);
      const float* tile = ring + (st % kStages) * TILE + 4 * lane;
      float4 x[RPW];
#pragma unroll
      for (int r = 0; r < RPW; ++r)
        x[r] = rv[r] ? *reinterpret_cast<const float4*>(tile + (warp * RPW + r) * kStageW)
                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int l = 0; l < NB; ++l) {
        const float4 q = *reinterpret_cast<const float4*>(tile + (R + l) * kStageW);
#pragma unroll
        for (int r = 0; r < RPW; ++r)
          acc[r][l] += x[r].x * q.x + x[r].y * q.y + x[r].z * q.z + x[r].w * q.w;
      }
    }
    cp_async_wait<0>();

    float* pout = part + (it * S + split) * RN;
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
      for (int l = 0; l < NB; ++l) {
        float v = acc[r][l];
#pragma unroll
        for (int off = rt::kWarp / 2; off > 0; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == ((r * NB + l) & (rt::kWarp - 1))) pout[(warp * RPW + r) * NB + l] = v;
      }
    __threadfence();
    __syncthreads();  // also: every warp is done with the ring
    if (tid == 0) s_fin = atomicAdd(tickets + it, 1u) == static_cast<unsigned>(S - 1);
    __syncthreads();
    if (!s_fin) continue;
    // The item's last block: sum the S slices, key and append.
    __threadfence();
    if (tid == 0) tickets[it] = 0;
    if (tid < NB) s_cnt[tid] = 0;
    __syncthreads();
    uint64_t key[PER];
    int at[PER];
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int e = tid + u * kThreads;
      const int r = e / NB, l = e % NB;
      at[u] = -1;
      if (e < RN && s_valid[r] && s_in[l]) {
        float v = 0.0f;
        for (int t = 0; t < S; ++t) v += __ldcg(part + (it * S + t) * RN + e);
        key[u] = rt::make_key(v, static_cast<uint32_t>(si) * cap + c * R + r);
        at[u] = static_cast<int>(atomicAdd(&s_cnt[l], 1u));
      }
    }
    __syncthreads();
    if (tid < NB && s_cnt[tid] > 0) s_base[tid] = atomicAdd(counts + tid, s_cnt[tid]);
    __syncthreads();
#pragma unroll
    for (int u = 0; u < PER; ++u)
      if (at[u] >= 0) {
        const int l = (tid + u * kThreads) % NB;
        lists[l * list_stride + s_base[l] + at[u]] = key[u];
      }
    __syncthreads();  // s_in, s_valid and s_base are rewritten for the next item
  }
}

template <int NB, int RPW>
cudaError_t launch_wave(const WavePlan& p, cudaStream_t st, const int* slots,
                        const float* member, int n_slots, int lanes, const float* rows,
                        const int* ids, const float* qb, int cap, int d, int vec,
                        float* part, unsigned* tickets, unsigned* next,
                        unsigned* counts, uint64_t* lists) {
  cudaError_t err = cudaFuncSetAttribute(wave_score_kernel<NB, RPW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(p.smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(p.workers), static_cast<unsigned>(p.S));
  wave_score_kernel<NB, RPW><<<grid, kThreads, p.smem, st>>>(
      slots, member, n_slots, lanes, rows, ids, qb, cap, d, vec, p.chunks, p.dsplit,
      part, tickets, next, counts, lists, p.list_stride);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ivf_probe_batch_max_lanes() { return kMaxLanes; }

// The wave's launch plan: out = {splits of d (S), floats a split, rows an
// item, chunks a slot, blocks a split (workers), items, scratch words}.
// Returns 0, or -1 if the device cannot be queried.
extern "C" int ivf_probe_batch_plan(int n_slots, int cap, int d, int lanes,
                                    long long* out) {
  WavePlan p;
  if (lanes <= 0 || lanes > kMaxLanes || !make_wave_plan(n_slots, cap, d, lanes, &p))
    return -1;
  out[0] = p.S;
  out[1] = p.dsplit;
  out[2] = p.rows;
  out[3] = p.chunks;
  out[4] = p.workers;
  out[5] = p.items;
  out[6] = p.scratch;
  return 0;
}

// Returns a cudaError_t code (0 on success). Launches on `stream` and does
// not synchronise. `slots` (n_slots,) cell ids and `member` (n_slots, lanes)
// 0/1 floats are on the device; `qb` is (lanes, d), `rows` (nlist, cap, d),
// `ids` (nlist, cap); outputs are (lanes, k) ids and scores and (lanes,)
// n_valid. `ws` is the zeroed workspace of topk_select.cuh, with a ticket
// for each of the plan's items and a work counter for each split.
extern "C" int ivf_probe_batch_launch(const int* slots, const float* member,
                                      int n_slots, int lanes, const float* rows,
                                      const int* ids, int cap, int d, const float* qb,
                                      int k, long long* scratch, long long scratch_len,
                                      int* ws, long long ws_len, int* out_ids,
                                      float* out_scores, int* n_valid, void* stream) {
  WavePlan p;
  if (n_slots <= 0 || lanes <= 0 || lanes > kMaxLanes || cap <= 0 || d <= 0 ||
      k <= 0 || k > rt::kMaxK || static_cast<long long>(n_slots) * cap >= 0xFFFFFFFFll ||
      !make_wave_plan(n_slots, cap, d, lanes, &p) || scratch_len < p.scratch ||
      ws_len < topk_workspace_len(p.items + p.S))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cache = static_cast<int>(
      p.list_stride < sel::kCacheKeys ? p.list_stride : sel::kCacheKeys);
  size_t fsmem = 0;
  cudaError_t err = sel::finish_prepare<ProbeOut>(k, cache, &fsmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* part = reinterpret_cast<float*>(scratch);
  uint64_t* lists = reinterpret_cast<uint64_t*>(scratch) + rt::ceil_div(p.part_len, 2);
  unsigned* w = reinterpret_cast<unsigned*>(ws);
  unsigned* counts = w + sel::kWsCounts;
  unsigned* tickets = w + sel::kWsTickets;
  unsigned* next = tickets + p.items;  // a work counter a split
  const int vec = (d % 4 == 0) && (reinterpret_cast<uintptr_t>(rows) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(qb) % 16 == 0);
  switch (p.nb) {
    case 1:
      err = launch_wave<1, 8>(p, st, slots, member, n_slots, lanes, rows, ids, qb, cap,
                              d, vec, part, tickets, next, counts, lists);
      break;
    case 2:
      err = launch_wave<2, 8>(p, st, slots, member, n_slots, lanes, rows, ids, qb, cap,
                              d, vec, part, tickets, next, counts, lists);
      break;
    case 4:
      err = launch_wave<4, 8>(p, st, slots, member, n_slots, lanes, rows, ids, qb, cap,
                              d, vec, part, tickets, next, counts, lists);
      break;
    case 8:
      err = launch_wave<8, 4>(p, st, slots, member, n_slots, lanes, rows, ids, qb, cap,
                              d, vec, part, tickets, next, counts, lists);
      break;
    default:
      err = launch_wave<16, 4>(p, st, slots, member, n_slots, lanes, rows, ids, qb, cap,
                               d, vec, part, tickets, next, counts, lists);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  sel::topk_finish_kernel<ProbeOut><<<lanes, sel::kFinishThreads, fsmem, st>>>(
      lists, p.list_stride, counts, k, cache, next, p.S, n_valid,
      ProbeOut{slots, ids, cap, k, out_ids, out_scores});
  return static_cast<int>(cudaGetLastError());
}
