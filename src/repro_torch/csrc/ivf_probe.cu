// Fused IVF cell probe on Hopper: kernel K4 (one probe) and kernel K5 (a
// wave of B probes, at the end of this file).
//
// K4 replaces the TPU kernel `_stream_kernel` / `ivf_probe_stream_pallas` of
// src/repro/kernels/ivf_probe/ivf_probe.py: the top-k of <row, q> over only
// the rows of the nprobe probed cells, read from the cell-grouped table
// `rows` (nlist, cap, d) -- the candidate matrix is never gathered.
//
// Bound: device-memory bytes, the probed cells' valid rows, about 0.5 flop
// a byte. The TPU kernel streams one cell a grid step. A grid of (cell, row
// chunk) blocks sized from cap leaves most blocks on pad slots here, since
// the index fills a cell's slots in order and about two thirds of a cell's
// capacity is pad; so the work follows the valid rows, not cap. Two routes,
// picked by kernels/ivf_probe/ops.py::probe_plan(nprobe, cap, d, sms); the
// launch function checks the same limits:
// * split (d > kNarrowD = 32: the release path's 2^14, the dual's 300): one
//   block an SM. Every block scans the probed cells' slot ids (one ballot a
//   32-slot chunk, the cell read through `probe`) into chunk masks and rank
//   offsets in shared memory, so all blocks agree on each valid slot's rank
//   and on their count n_valid. The items are the (valid slot, kSeg-float
//   segment) pairs, item t = (segment t / n_valid, rank t % n_valid); warp w
//   of W takes the contiguous share [w q, w q + q). A warp reads a row
//   segment with kSegLoads 16-byte loads a lane in flight, keeps the probe's
//   segment in registers while its share stays in one segment, and finds
//   the next item's slot and cell while the current row is in flight. Pad
//   slots are never read. A slot of one segment is keyed at once; else its
//   segment partials go to a scratch, and the item that draws its slot's
//   ticket last (one zeroed workspace word a slot) sums them in segment
//   order and keys the slot. A valid slot's key lands at its rank.
// * narrow (d <= kNarrowD: the LP rows [A_i, b_i], 21 wide): a thread a
//   slot, kNarrowThreads slots a block; the block's rows are read whole,
//   coalesced, into shared memory while the slot ids are read (a pad row is
//   read but never keyed), each valid slot's thread sums its row in order,
//   and the keys are appended to the list by one atomic a warp.
// Both routes copy the probed cell ids to shared memory first: read from
// device memory by every warp for every slot, their one cache line would
// serialise the whole grid. When the probed cells hold at most
// sel::kCacheKeys slots, the scoring blocks also count each key's top 12
// bits in a histogram in the workspace, and the block that finishes last
// (one ticket) reads the digit of the k-th largest key off it, keeps the
// keys at or above that digit in shared memory (k and a few dozen more at
// the main paths' shapes) and counting-sorts them by digit, so no radix
// pass runs over the list; row ids travel beside the keys, and it writes
// the outputs in the same launch. Past kCacheKeys slots a second launch,
// `topk_finish_kernel`, selects. Every workspace word a launch raises is
// set back to 0.
//
// Tie order: a candidate's rank is its position in the flat probe-major,
// slot-minor candidate vector (probe slot * cap + slot), so among exact ties
// earlier probed cells win, then lower slots -- the reference's stable merge.
// Ids past the valid candidates come back -1 with score -inf, and `n_valid`
// counts the valid slots of the probed cells.
#include "topk_select.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * rt::kWarp;     // K4's split route, K5
constexpr int kSeg = 2048;                       // K4 split: floats a segment
constexpr int kSegLoads = kSeg / 4 / rt::kWarp;  // 16-byte row loads a lane a segment
constexpr int kFlagLoads = 16;                   // slot-id chunks a warp scans at once
constexpr int kNarrowD = 32;                     // K4 narrow: most d
constexpr int kNarrowThreads = 512;              // K4 narrow: slots a block
constexpr int kMaxSlots = 1 << 18;               // K4: most nprobe * cap
constexpr int kMaxProbe = 4096;                  // K4: most nprobe (held in shared memory)
constexpr int kDigitWords = sel::kTopBins + sel::kTopBins / rt::kWarp;  // K4 last block
enum { kSplitRoute = 0, kNarrowRoute = 1 };

// Decodes a key of slot position pos = (slot * cap + row) into the row id
// of `cells` (slot `slot` holds cell cells_of[slot]); lane l's k outputs
// start at l * k.
struct ProbeOut {
  const int* cells_of;
  const int* ids;
  int cap, k;
  int* out_ids;
  float* out_scores;
  __device__ int id_of(uint64_t key) const {
    const uint32_t pos = rt::key_tie(key);
    const long long cell = cells_of[pos / cap];
    return ids[cell * cap + pos % cap];
  }
  __device__ void put(int lane, int r, uint64_t key, int id) const {
    const long long o = static_cast<long long>(lane) * k + r;
    out_ids[o] = key == rt::kNoKey ? -1 : id;
    out_scores[o] = key == rt::kNoKey ? -INFINITY : rt::key_score(key);
  }
  __device__ void operator()(int lane, int r, uint64_t key) const {
    put(lane, r, key, key == rt::kNoKey ? -1 : id_of(key));
  }
};

// Dynamic shared memory: the select's region when the scoring launch selects
// (the survivors; the chosen ones or the digit-sorted copy; the row ids of up
// to 2 · kNarrowThreads survivors and their sorted copy; the digit
// histogram), before the split route's chunk offsets and masks or after the
// narrow route's row tile; then the probed cell ids.
__host__ __device__ inline size_t select_bytes(int total, int k) {
  const int room = k > 2 * kNarrowThreads ? k : 2 * kNarrowThreads;
  return static_cast<size_t>(total + room) * sizeof(uint64_t) +
         4 * kNarrowThreads * sizeof(int) + kDigitWords * sizeof(unsigned);
}
// The last block's digit histogram: the select region's last words (the
// digits, padded as `dpad` says), after the row ids of up to
// 2 · kNarrowThreads survivors and their sorted copy.
__device__ __forceinline__ unsigned* digit_hist(uint64_t* s_keys, int total, int k) {
  return reinterpret_cast<unsigned*>(reinterpret_cast<unsigned char*>(s_keys) +
                                     select_bytes(total, k)) - kDigitWords;
}
__device__ __forceinline__ int* survivor_ids(uint64_t* s_keys, int total, int k) {
  return reinterpret_cast<int*>(digit_hist(s_keys, total, k)) - 4 * kNarrowThreads;
}
__host__ __device__ inline size_t split_bytes(int total, int nprobe) {
  return static_cast<size_t>(2 * rt::ceil_div(total, rt::kWarp) + 1 + nprobe) * sizeof(int);
}
__host__ __device__ inline size_t narrow_bytes(int d) {
  return static_cast<size_t>(kNarrowThreads) * d * sizeof(float);
}

// The probed cell ids into shared memory, once a block: every warp reads
// them for every slot, and one cache line read by the whole grid at once
// would serialise.
__device__ __forceinline__ void load_probe(const int* __restrict__ probe, int nprobe,
                                           int* s_probe) {
  for (int i = threadIdx.x; i < nprobe; i += blockDim.x) s_probe[i] = __ldg(probe + i);
  __syncthreads();
}

// The flat slot of the valid slot of rank r, from the block's exclusive
// chunk offsets and chunk masks; every lane gets the same.
__device__ __forceinline__ int slot_of_rank(int r, const int* s_off,
                                            const unsigned* s_mask, int nch) {
  int lo = 0, hi = nch;  // s_off[lo] <= r < s_off[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (s_off[mid] <= r) lo = mid;
    else hi = mid;
  }
  unsigned bal = s_mask[lo];
  for (int need = r - s_off[lo]; need > 0; --need) bal &= bal - 1;
  return lo * rt::kWarp + __ffs(bal) - 1;
}

// A segment of len <= kSeg floats into registers: lane l's register e holds
// floats 4j .. 4j + 3 of the segment, j = l + 32e, by one 16-byte load, or by
// four 4-byte loads where the row or the probe is not 16-byte aligned -- the
// same floats in the same places, so both paths sum in the same order. Pads
// read as 0.
__device__ __forceinline__ void load_segment(const float* __restrict__ p, int len,
                                             int lane, int vec, float4 (&x)[kSegLoads]) {
  if (vec) {
    const float4* p4 = reinterpret_cast<const float4*>(p);
    const int n4 = len >> 2;
#pragma unroll
    for (int e = 0; e < kSegLoads; ++e) {
      const int i = lane + e * rt::kWarp;
      x[e] = i < n4 ? __ldg(p4 + i) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  } else {
#pragma unroll
    for (int e = 0; e < kSegLoads; ++e) {
      const int i = 4 * (lane + e * rt::kWarp);
      x[e].x = i < len ? __ldg(p + i) : 0.0f;
      x[e].y = i + 1 < len ? __ldg(p + i + 1) : 0.0f;
      x[e].z = i + 2 < len ? __ldg(p + i + 2) : 0.0f;
      x[e].w = i + 3 < len ? __ldg(p + i + 3) : 0.0f;
    }
  }
}

// <row segment, probe segment> from registers, by one warp in a fixed order;
// every lane returns the sum.
__device__ __forceinline__ float segment_sum(const float4 (&x)[kSegLoads],
                                             const float4 (&y)[kSegLoads]) {
  float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int e = 0; e < kSegLoads; ++e)
    a[e % 4] += x[e].x * y[e].x + x[e].y * y[e].y + x[e].z * y[e].z + x[e].w * y[e].w;
  float acc = (a[0] + a[1]) + (a[2] + a[3]);
  for (int off = rt::kWarp / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

// Whether this block is the grid's last to arrive, after its writes are
// fenced; the last one sets the ticket back to 0.
__device__ __forceinline__ bool last_block(unsigned* done) {
  __shared__ bool s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd(done, 1u) == gridDim.x - 1;
    if (s_last) *done = 0;
  }
  __syncthreads();
  if (s_last) __threadfence();
  return s_last;
}

// A thread's bins of the histogram: thread t of T holds the B = 4096 / T
// bins (16 or 8) below 4096 − B·t, in c[0 … B).
__device__ __forceinline__ void load_bins(const unsigned* __restrict__ hist,
                                          unsigned (&c)[16]) {
  const int B = sel::kTopBins / blockDim.x;
  const int lo = sel::kTopBins - B * (threadIdx.x + 1);
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const uint4 x = 4 * v < B ? __ldcg(reinterpret_cast<const uint4*>(hist + lo) + v)
                              : make_uint4(0u, 0u, 0u, 0u);
    c[4 * v] = x.x, c[4 * v + 1] = x.y, c[4 * v + 2] = x.z, c[4 * v + 3] = x.w;
  }
}

// The top digit (12 bits) of the k-th largest of the keys counted in the
// histogram whose bins `load_bins` gave, or 0 when it counts no more than
// k; then hist is zeroed. Every thread of a block of 256 or 512 calls it.
__device__ __forceinline__ int threshold_digit(unsigned* __restrict__ hist,
                                               const unsigned (&c)[16],
                               int k) {
  __shared__ unsigned s_warp[kNarrowThreads / rt::kWarp];
  __shared__ int s_digit;
  const int T = blockDim.x, tid = threadIdx.x, lane = tid % rt::kWarp;
  const int warp = tid / rt::kWarp, B = sel::kTopBins / T;  // 16 or 8 bins a thread
  const int lo = sel::kTopBins - B * (tid + 1);  // thread 0 holds the top B bins
  unsigned s = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) s += c[j];
  unsigned inc = s;
  for (int off = 1; off < rt::kWarp; off <<= 1) {
    const unsigned u = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += u;
  }
  if (lane == rt::kWarp - 1) s_warp[warp] = inc;
  if (tid == 0) s_digit = 0;
  __syncthreads();
  for (int w = 0; w < warp; ++w) inc += s_warp[w];
  const unsigned before = inc - s, kk = static_cast<unsigned>(k);
  if (before < kk && inc >= kk) {  // one thread holds the k-th largest
    unsigned run = before;
    int hit = 0;
#pragma unroll
    for (int j = 15; j >= 0; --j) {
      if (j < B && run < kk) {
        run += c[j];
        if (run >= kk) hit = lo + j;
      }
    }
    s_digit = hit;
  }
  __syncthreads();
#pragma unroll
  for (int v = 0; v < 4; ++v)
    if (4 * v < B) reinterpret_cast<uint4*>(hist + lo)[v] = make_uint4(0u, 0u, 0u, 0u);
  return s_digit;
}

// The digit histogram's index of digit d: one word of padding every 32
// digits, so a thread's run of consecutive digits falls in distinct banks.
__device__ __forceinline__ int dpad(int d) { return d + d / rt::kWarp; }

// For the lanes of a warp with `on`: base + the lane's rank among the lanes
// with its digit d, where base comes from one atomicAdd of their count to
// hist[dpad(d)] (`grab`), or just that count added (otherwise). All 32
// lanes call it.
__device__ __forceinline__ unsigned digit_add(unsigned* hist, int d, bool on, bool grab) {
  const int lane = threadIdx.x % rt::kWarp;
  const unsigned peers = __match_any_sync(0xffffffffu, on ? d : -1);
  const int leader = __ffs(peers) - 1;
  unsigned base = 0;
  if (on && lane == leader) base = atomicAdd(hist + dpad(d), static_cast<unsigned>(__popc(peers)));
  if (!grab) return 0;
  base = __shfl_sync(0xffffffffu, base, leader);
  return base + __popc(peers & ((1u << lane) - 1u));
}

// Ranks the s <= 2 · blockDim.x distinct keys at `keys` and writes the top
// k of them, decoded, with -1 / -inf for ranks in [s, k): a counting sort on
// the keys' top 12 bits (a histogram and one scan over `hist`, kDigitWords
// words of shared memory) puts each digit's keys in one group of `sorted`,
// in digit order, and a key's rank is its group's start plus the count of
// larger keys in its group -- a few compares where the scores spread over
// many digits. Each key's row id (`sid`, read beside it from the list)
// moves with it, so no decode reads device memory.
__device__ __forceinline__ void digit_sort_top_k(const uint64_t* keys, const int* sid, int s,
                                                 int k, uint64_t* sorted, int* sorted_id,
                                                 unsigned* hist, const ProbeOut& out) {
  __shared__ unsigned s_warp[kNarrowThreads / rt::kWarp];
  const int T = blockDim.x, tid = threadIdx.x, lane = tid % rt::kWarp;
  const int warp = tid / rt::kWarp, B = sel::kTopBins / T;
  const int lo = sel::kTopBins - B * (tid + 1);  // thread 0: the top B digits
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (j < B) hist[dpad(lo + j)] = 0;
  __syncthreads();
  for (int base = 0; base < s; base += T) {
    const int i = base + tid;
    digit_add(hist, i < s ? sel::top_digit(keys[i]) : 0, i < s, false);
  }
  __syncthreads();
  // exclusive offsets, largest digit first: hist[d] = keys with a larger digit
  unsigned c[16], sum = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    c[j] = j < B ? hist[dpad(lo + j)] : 0u;
    sum += c[j];
  }
  unsigned inc = sum;
  for (int off = 1; off < rt::kWarp; off <<= 1) {
    const unsigned u = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += u;
  }
  if (lane == rt::kWarp - 1) s_warp[warp] = inc;
  __syncthreads();
  unsigned run = inc - sum;
  for (int w = 0; w < warp; ++w) run += s_warp[w];
#pragma unroll
  for (int j = 15; j >= 0; --j) {
    if (j < B) {
      hist[dpad(lo + j)] = run;
      run += c[j];
    }
  }
  __syncthreads();
  for (int base = 0; base < s; base += T) {  // scatter; hist[d] ends at its group's end
    const int i = base + tid;
    const uint64_t key = i < s ? keys[i] : rt::kNoKey;
    const unsigned p = digit_add(hist, sel::top_digit(key), i < s, true);
    if (i < s) {
      sorted[p] = key;
      sorted_id[p] = sid[i];
    }
  }
  __syncthreads();
  for (int p = tid; p < s; p += T) {
    const uint64_t key = sorted[p];
    const int id = sorted_id[p];
    const int d = sel::top_digit(key);
    const int start = d == sel::kTopBins - 1 ? 0 : static_cast<int>(hist[dpad(d + 1)]);
    const int end = static_cast<int>(hist[dpad(d)]);
    int r = start;
    for (int q = start; q < end; ++q) r += sorted[q] > key;
    if (r < k) out.put(0, r, key, id);
  }
  for (int r = s + tid; r < k; r += T) out.put(0, r, rt::kNoKey, -1);
}

// The last block: the top k of the n keys at `list`, sorted and decoded;
// n_valid = n. The scoring blocks counted every key's top 12 bits in
// `hist`, so one read of it (in the same round trip as the list's first
// keys) gives the digit of the k-th largest, and one pass over the list
// keeps the keys at or above it -- k plus that digit's other keys -- in
// shared memory `keys` (room for n, then for k or 2 · blockDim.x if more).
// Up to 2 · blockDim.x survivors -- k and a few dozen at the main paths'
// shapes -- are counting-sorted by digit (`digit_sort_top_k`, its histogram
// in `hist_s`); more (ties, or a k near the list's length) are cut to
// exactly k by the radix select and ranked by counting.
__device__ __forceinline__ void select_last(const uint64_t* __restrict__ list,
                            const int* __restrict__ rids, int n, int k, uint64_t* keys,
                            int* sid, unsigned* hist, unsigned* hist_s,
                            sel::Scratch& sc, int* n_valid, const ProbeOut& out) {
  constexpr int kBatch = 8;  // keys a thread has in flight
  const int T = blockDim.x, lane = threadIdx.x % rt::kWarp;
  uint64_t key[kBatch];
  int rid[kBatch];
#pragma unroll
  for (int e = 0; e < kBatch; ++e) {
    const int i = e * T + threadIdx.x;
    key[e] = i < n ? __ldcg(list + i) : rt::kNoKey;
    rid[e] = i < n ? __ldcg(rids + i) : -1;
  }
  unsigned bins[16];
  load_bins(hist, bins);
  const int digit = threshold_digit(hist, bins, k);
  if (threadIdx.x == 0) {
    sc.n_sel = 0;
    *n_valid = n;
  }
  __syncthreads();
  for (int base = 0; base < n; base += kBatch * T) {
    if (base > 0) {
#pragma unroll
      for (int e = 0; e < kBatch; ++e) {
        const int i = base + e * T + threadIdx.x;
        key[e] = i < n ? __ldcg(list + i) : rt::kNoKey;
        rid[e] = i < n ? __ldcg(rids + i) : -1;
      }
    }
#pragma unroll
    for (int e = 0; e < kBatch; ++e) {
      const int i = base + e * T + threadIdx.x;
      const bool on = i < n && sel::top_digit(key[e]) >= digit;
      const unsigned b = __ballot_sync(0xffffffffu, on);
      unsigned pos = 0;
      if (lane == 0 && b) pos = atomicAdd(&sc.n_sel, static_cast<unsigned>(__popc(b)));
      pos = __shfl_sync(0xffffffffu, pos, 0) + __popc(b & ((1u << lane) - 1u));
      if (on) keys[pos] = key[e];
      if (on && pos < 2 * kNarrowThreads) sid[pos] = rid[e];
    }
  }
  __syncthreads();
  const int s = static_cast<int>(sc.n_sel);
  __syncthreads();  // sc is reused by the select
  if (s <= 2 * T) {
    digit_sort_top_k(keys, sid, s, k, keys + s, sid + 2 * kNarrowThreads, hist_s, out);
  } else {
    const int ns = sel::block_select(keys, s, k, keys + s, sc);
    sel::block_rank(keys + s, ns, k, [&](int r, uint64_t key) { out(0, r, key); });
  }
}

// K4 split route; see the note at the top of the file. `part` holds nseg
// floats a rank and `ticket` one zeroed word a rank (nseg > 1 only); the
// keys go to list[rank]. `here`: this launch selects (else *count = n_valid
// for the finish launch).
__global__ void __launch_bounds__(kThreads, 1)
ivf_split_kernel(const int* __restrict__ probe, const float* __restrict__ rows,
                 const int* __restrict__ ids, const float* __restrict__ q, int cap,
                 int total, int d, int nseg, int vec, int k, int here,
                 float* __restrict__ part, uint64_t* __restrict__ list,
                 int* __restrict__ rids, unsigned* __restrict__ ticket,
                 unsigned* __restrict__ done,
                 unsigned* __restrict__ count, unsigned* __restrict__ hist,
                 int* __restrict__ n_valid, ProbeOut out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_warp[kWarps];
  __shared__ sel::Scratch sc;
  const int tid = threadIdx.x, warp = tid / rt::kWarp, lane = tid % rt::kWarp;
  const int nch = (total + rt::kWarp - 1) / rt::kWarp;
  uint64_t* s_keys = reinterpret_cast<uint64_t*>(smem);
  int* s_off = reinterpret_cast<int*>(smem + (here ? select_bytes(total, k) : 0));
  unsigned* s_mask = reinterpret_cast<unsigned*>(s_off + nch + 1);
  int* s_probe = reinterpret_cast<int*>(s_mask + nch);
  load_probe(probe, total / cap, s_probe);

  // Each chunk's mask and count: warp w takes chunks w, w + 8, ...,
  // kFlagLoads of them in flight, a lane a slot.
  for (int c0 = warp; c0 < nch; c0 += kWarps * kFlagLoads) {
    int f[kFlagLoads];  // every load issued before any is used
#pragma unroll
    for (int i = 0; i < kFlagLoads; ++i) {
      const int c = (c0 + i * kWarps) * rt::kWarp + lane;
      f[i] = c < total ? __ldg(ids + static_cast<long long>(s_probe[c / cap]) * cap + c % cap)
                       : -1;
    }
#pragma unroll
    for (int i = 0; i < kFlagLoads; ++i) {
      const int ch = c0 + i * kWarps;
      const unsigned m = __ballot_sync(0xffffffffu, f[i] >= 0);
      if (ch < nch && lane == 0) {
        s_mask[ch] = m;
        s_off[ch] = __popc(m);
      }
    }
  }
  __syncthreads();
  // the counts into exclusive offsets: a thread a run of chunks, then warps
  const int per = (nch + kThreads - 1) / kThreads;
  const int lo = tid * per, hi = min(nch, lo + per);
  int cnt = 0;
  for (int i = lo; i < hi; ++i) cnt += s_off[i];
  int x = cnt;
  for (int o = 1; o < rt::kWarp; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == rt::kWarp - 1) s_warp[warp] = x;
  __syncthreads();
  int run = 0;
  for (int w = 0; w < warp; ++w) run += s_warp[w];
  run += x - cnt;
  for (int i = lo; i < hi; ++i) {
    const int n = s_off[i];
    s_off[i] = run;
    run += n;
  }
  if (tid == kThreads - 1) s_off[nch] = run;  // every valid slot
  __syncthreads();

  const int n_act = s_off[nch];
  const long long n_items = static_cast<long long>(n_act) * nseg;
  const long long W = static_cast<long long>(gridDim.x) * kWarps;
  const long long qn = rt::ceil_div(n_items, W);
  const long long k0 = (static_cast<long long>(blockIdx.x) * kWarps + warp) * qn;
  const long long k1 = k0 + qn < n_items ? k0 + qn : n_items;
  if (k0 < k1) {
    float4 y[kSegLoads];   // the probe's segment
    float4 xr[kSegLoads];  // the row's segment: every load issued first
    int y_seg = -1;
    int my_r = 0, my_c = 0, my_seg = 0, my_id = -1;  // lane i: the batch's i-th item
    float my_acc = 0.0f;
    int r = static_cast<int>(k0 % n_act);
    int c = slot_of_rank(r, s_off, s_mask, nch);
    long long cell = s_probe[c / cap];
    int id = __ldg(ids + cell * cap + c % cap);
    for (long long t = k0; t < k1; ++t) {
      const int seg = static_cast<int>(t / n_act);
      const int s_lo = seg * kSeg;
      const int len = min(kSeg, d - s_lo);
      if (seg != y_seg) {
        load_segment(q + s_lo, len, lane, vec, y);
        y_seg = seg;
      }
      load_segment(rows + (cell * cap + c % cap) * static_cast<long long>(d) + s_lo, len,
                   lane, vec, xr);
      // the next item's slot and cell while the row is in flight
      int r_next = r, c_next = c, id_next = id;
      long long cell_next = cell;
      if (t + 1 < k1) {
        r_next = static_cast<int>((t + 1) % n_act);
        c_next = slot_of_rank(r_next, s_off, s_mask, nch);
        cell_next = s_probe[c_next / cap];
        id_next = __ldg(ids + cell_next * cap + c_next % cap);
      }
      const float acc = segment_sum(xr, y);
      const int i = static_cast<int>((t - k0) % rt::kWarp);
      if (lane == i) {
        my_r = r;
        my_c = c;
        my_seg = seg;
        my_acc = acc;
        my_id = id;
      }
      if (i == rt::kWarp - 1 || t + 1 == k1) {  // publish the batch, a lane an item
        const bool has = lane <= i;
        bool keyed = has;
        uint64_t key = rt::make_key(my_acc, static_cast<uint32_t>(my_c));
        if (nseg > 1) {
          const long long at = static_cast<long long>(my_r) * nseg;
          if (has) part[at + my_seg] = my_acc;
          __threadfence();
          keyed = has && atomicAdd(ticket + my_r, 1u) == static_cast<unsigned>(nseg - 1);
          if (keyed) {
            __threadfence();  // the slot's last item: sum its partials in order
            float sum = 0.0f;
            for (int e = 0; e < nseg; ++e) sum += __ldcg(part + at + e);
            key = rt::make_key(sum, static_cast<uint32_t>(my_c));
            ticket[my_r] = 0;
          }
        }
        if (keyed) {
          list[my_r] = key;
          rids[my_r] = my_id;
        }
        if (here) sel::warp_hist_add(hist, sel::top_digit(key), keyed);
      }
      r = r_next;
      c = c_next;
      cell = cell_next;
      id = id_next;
    }
  }
  if (!here) {
    if (blockIdx.x == 0 && tid == 0) *count = static_cast<unsigned>(n_act);
    return;
  }
  if (last_block(done))  // decode through the block's copy of the cell ids
    select_last(list, rids, n_act, k, s_keys, survivor_ids(s_keys, total, k), hist,
                digit_hist(s_keys, total, k), sc, n_valid,
                ProbeOut{s_probe, out.ids, cap, k, out.out_ids, out.out_scores});
}

// K4 narrow route; see the note at the top of the file. Thread t of block x
// scores flat slot x * kNarrowThreads + t.
__global__ void __launch_bounds__(kNarrowThreads)
ivf_narrow_kernel(const int* __restrict__ probe, const float* __restrict__ rows,
                  const int* __restrict__ ids, const float* __restrict__ q, int cap,
                  int total, int d, int k, int here, uint64_t* __restrict__ list,
                  int* __restrict__ rids, unsigned* __restrict__ done,
                  unsigned* __restrict__ count,
                  unsigned* __restrict__ hist, int* __restrict__ n_valid, ProbeOut out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* tile = reinterpret_cast<float*>(smem);  // kNarrowThreads x d
  uint64_t* s_keys = reinterpret_cast<uint64_t*>(smem + narrow_bytes(d));
  int* s_probe = reinterpret_cast<int*>(smem + narrow_bytes(d) +
                                        (here ? select_bytes(total, k) : 0));
  __shared__ long long s_at[kNarrowThreads];  // a slot's row offset
  __shared__ float s_q[kNarrowD];
  __shared__ sel::Scratch sc;
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kNarrowThreads, c = c0 + tid;
  load_probe(probe, total / cap, s_probe);
  long long slot = -1;
  if (c < total) slot = static_cast<long long>(s_probe[c / cap]) * cap + c % cap;
  s_at[tid] = slot * d;
  if (tid < d) s_q[tid] = __ldg(q + tid);
  __syncthreads();
  // the block's rows, whole (pad rows too: their slots are never keyed), in
  // flight together with the slot ids: consecutive threads read consecutive
  // floats of a cell's run of rows
  const int nf = min(kNarrowThreads, total - c0) * d;
  const int valid = slot >= 0 ? __ldg(ids + slot) : -1;
  // f / d as a multiply-high (d > 1): exact for f < kNarrowThreads * kNarrowD
  const unsigned magic = 0xFFFFFFFFu / static_cast<unsigned>(d) + 1u;
  float v[kNarrowD];
#pragma unroll
  for (int e = 0; e < kNarrowD; ++e) {
    const int f = tid + e * kNarrowThreads;
    const int r = d == 1 ? f : static_cast<int>(__umulhi(static_cast<unsigned>(f), magic));
    v[e] = f < nf ? __ldg(rows + s_at[r] + (f - r * d)) : 0.0f;
  }
#pragma unroll
  for (int e = 0; e < kNarrowD; ++e)
    if (tid + e * kNarrowThreads < nf) tile[tid + e * kNarrowThreads] = v[e];
  const long long at = valid >= 0 ? slot * d : -1;
  __syncthreads();
  float acc = 0.0f;
  if (at >= 0) {
    const float* row = tile + tid * d;  // stride d: conflict-free for odd d
    for (int e = 0; e < d; ++e) acc += row[e] * s_q[e];
  }
  const uint64_t key = rt::make_key(acc, static_cast<uint32_t>(c));
  {  // append the key and its row id at one position, one atomic a warp
    const int lane = tid % rt::kWarp;
    const unsigned b = __ballot_sync(0xffffffffu, at >= 0);
    unsigned base = 0;
    if (lane == 0 && b) base = atomicAdd(count, static_cast<unsigned>(__popc(b)));
    base = __shfl_sync(0xffffffffu, base, 0) + __popc(b & ((1u << lane) - 1u));
    if (at >= 0) {
      list[base] = key;
      rids[base] = valid;
    }
  }
  if (here) sel::warp_hist_add(hist, sel::top_digit(key), at >= 0);
  if (!here || !last_block(done)) return;
  const int n = static_cast<int>(__ldcg(count));
  __syncthreads();
  if (tid == 0) *count = 0;
  select_last(list, rids, n, k, s_keys, survivor_ids(s_keys, total, k), hist,
              digit_hist(s_keys, total, k), sc, n_valid,
              ProbeOut{s_probe, out.ids, cap, k, out.out_ids, out.out_scores});
}

cudaError_t set_smem(const void* fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" int ivf_probe_seg() { return kSeg; }
extern "C" int ivf_probe_narrow_d() { return kNarrowD; }
extern "C" int ivf_probe_narrow_threads() { return kNarrowThreads; }
extern "C" int ivf_probe_max_slots() { return kMaxSlots; }
extern "C" int ivf_probe_max_probe() { return kMaxProbe; }
extern "C" int ivf_probe_cache_keys() { return sel::kCacheKeys; }

// Returns a cudaError_t code (0 on success). Launches on `stream` and does
// not synchronise. `rows` is (nlist, cap, d) and `ids` (nlist, cap), both
// contiguous; `probe` holds nprobe cell ids on the device. route, blocks and
// here are kernels/ivf_probe/ops.py::probe_plan's, for nprobe <= kMaxProbe
// and total = nprobe * cap <= kMaxSlots: route 0 (split) needs d > kNarrowD and blocks >= 1, route 1
// (narrow) d <= kNarrowD and blocks = ceil(total / kNarrowThreads); here = 1
// (select in the scoring launch) exactly when total <= sel::kCacheKeys.
// `scratch` holds total keys, their row ids (total int32), then (split,
// d > kSeg) total * nseg floats;
// `ws` is the zeroed workspace of topk_select.cuh with one ticket, and
// (split, d > kSeg) one more a slot.
extern "C" int ivf_probe_launch(const int* probe, int nprobe, const float* rows,
                                const int* ids, int cap, int d, const float* q, int k,
                                int route, int blocks, int here, long long* scratch,
                                long long scratch_len, int* ws, long long ws_len,
                                int* out_ids, float* out_scores, int* n_valid,
                                void* stream) {
  if (nprobe <= 0 || nprobe > kMaxProbe || cap <= 0 || d <= 0 || k <= 0 || k > rt::kMaxK ||
      static_cast<long long>(nprobe) * cap > kMaxSlots)
    return static_cast<int>(cudaErrorInvalidValue);
  const int total = nprobe * cap;
  const bool narrow = d <= kNarrowD;
  const int nseg = static_cast<int>(rt::ceil_div(d, kSeg));
  const bool parts = !narrow && nseg > 1;
  if (route != (narrow ? kNarrowRoute : kSplitRoute) || blocks < 1 ||
      (narrow && blocks != rt::ceil_div(total, kNarrowThreads)) ||
      here != (total <= sel::kCacheKeys ? 1 : 0) ||
      scratch_len < total + rt::ceil_div(total, 2) +
                        (parts ? rt::ceil_div(static_cast<long long>(total) * nseg, 2) : 0) ||
      ws_len < topk_workspace_len(1 + (parts ? total : 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint64_t* list = reinterpret_cast<uint64_t*>(scratch);
  int* rids = reinterpret_cast<int*>(scratch + total);  // each key's row id
  float* part = reinterpret_cast<float*>(scratch + total + rt::ceil_div(total, 2));
  unsigned* w = reinterpret_cast<unsigned*>(ws);
  unsigned* hist = w + sel::kWsHist;  // the keys' top 12 bits, when `here`
  unsigned* count = w + sel::kWsCounts;
  unsigned* done = w + sel::kWsTickets;
  unsigned* ticket = done + 1;  // a slot's, split route with segments
  const ProbeOut out{probe, ids, cap, k, out_ids, out_scores};
  const size_t keys = here ? select_bytes(total, k) : 0;
  cudaError_t err;
  if (narrow) {
    const size_t smem = narrow_bytes(d) + keys + nprobe * sizeof(int);
    err = set_smem(reinterpret_cast<const void*>(ivf_narrow_kernel), smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ivf_narrow_kernel<<<blocks, kNarrowThreads, smem, st>>>(
        probe, rows, ids, q, cap, total, d, k, here, list, rids, done, count, hist, n_valid,
        out);
  } else {
    const int vec = (d % 4 == 0) && (reinterpret_cast<uintptr_t>(rows) % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(q) % 16 == 0);
    const size_t smem = keys + split_bytes(total, nprobe);
    err = set_smem(reinterpret_cast<const void*>(ivf_split_kernel), smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ivf_split_kernel<<<blocks, kThreads, smem, st>>>(probe, rows, ids, q, cap, total, d,
                                                     nseg, vec, k, here, part, list,
                                                     rids, ticket, done, count, hist,
                                                     n_valid, out);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || here) return static_cast<int>(err);
  size_t fsmem = 0;
  err = sel::finish_prepare<ProbeOut>(k, sel::kCacheKeys, &fsmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  sel::topk_finish_kernel<ProbeOut><<<1, sel::kFinishThreads, fsmem, st>>>(
      list, 0, count, k, sel::kCacheKeys, nullptr, 0, n_valid, out);
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

// Copies 16 bytes at src (row floats [e, e + 4) of a row whose slice ends at
// `end`) to dst, zero past `end`; `vec`: the floats are 16-byte aligned.
__device__ __forceinline__ void copy_unit(float* dst, const float* row, int e, int end,
                                          int vec) {
  if (vec) {
    rt::cp_async16(dst, e < end ? row + e : row, e < end ? 16 : 0);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      rt::cp_async4(dst + i, e + i < end ? row + e + i : row, e + i < end ? 4 : 0);
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
      rt::cp_async_commit();  // an empty group past the last stage keeps the count
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
      rt::cp_async_wait<kStages - 2>();
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
    rt::cp_async_wait<0>();

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
