// Top-k selection shared by the port's top-k kernels (K1 mips_topk, K4 and
// K5 ivf_probe): a radix select over the 64-bit keys of common.cuh.
//
// A kernel scores its candidates into keys; then
//   * a list that one block can hold (a few thousand keys) is selected by
//     `block_select`: digit by digit from the top, 8 bits a pass, with one
//     shared-memory histogram of the keys that still match the prefix. The
//     bucket that holds the k-th largest key extends the prefix, and the
//     passes stop as soon as that bucket is taken whole. Keys are unique
//     (score, then tie rank), so exactly k keys survive;
//   * a long list (K1 over up to 2^18 candidates) is first cut on its top 12
//     bits: the scoring blocks add a histogram of those bits into a global
//     one, and `topk_filter_kernel` keeps the keys at or above the bucket
//     that holds the k-th largest -- k plus a few hundred on spread scores --
//     for one block to finish.
// The survivors (at most k) are ranked by counting the larger survivors, so
// no sort runs over a key that is not in the output.
//
// Counters, tickets and the global histogram live in a workspace that the
// wrapper keeps zeroed for the process (`_build.workspace`): every kernel
// that raises a word there sets it back to 0 before it exits, so no call
// pays for a memset. Calls that share it run on one stream.
#pragma once

#include "common.cuh"

namespace sel {

constexpr int kTopBits = 12;
constexpr int kTopBins = 1 << kTopBits;
constexpr int kTopShift = 64 - kTopBits;
constexpr int kFilterThreads = 256;  // block_top_digit: 16 bins a thread
constexpr int kFinishThreads = 512;
constexpr int kCacheKeys = 8192;     // a list up to this long is selected in shared memory

// Workspace layout, in 32-bit words.
constexpr int kWsHist = 0;                // kTopBins: K1's top-digit histogram
constexpr int kWsCounts = kTopBins;       // 16: a list's length, one a lane
constexpr int kWsTickets = kTopBins + 16;  // arrival tickets from here on

__device__ __forceinline__ int top_digit(uint64_t key) {
  return static_cast<int>(key >> kTopShift);
}

// Adds one to hist[bin] for every lane with `on`, one atomic for each
// distinct bin of the warp. All 32 lanes of the warp call it.
__device__ __forceinline__ void warp_hist_add(unsigned* hist, int bin, bool on) {
  const unsigned peers = __match_any_sync(0xffffffffu, on ? bin : -1);
  if (on && __ffs(peers) - 1 == static_cast<int>(threadIdx.x % rt::kWarp))
    atomicAdd(hist + bin, static_cast<unsigned>(__popc(peers)));
}

// Appends `key` for every lane with `on` at list[*count ...], one atomic a
// warp. All 32 lanes of the warp call it; returns nothing.
__device__ __forceinline__ void warp_append(uint64_t* list, unsigned* count,
                                            uint64_t key, bool on) {
  const int lane = threadIdx.x % rt::kWarp;
  const unsigned b = __ballot_sync(0xffffffffu, on);
  unsigned base = 0;
  if (lane == 0 && b) base = atomicAdd(count, static_cast<unsigned>(__popc(b)));
  base = __shfl_sync(0xffffffffu, base, 0);
  if (on) list[base + __popc(b & ((1u << lane) - 1u))] = key;
}

struct Scratch {
  unsigned hist[256];
  int digit, need, count;
  unsigned n_sel;
};

// Picks the top min(k, n) of the n distinct keys at `src` (shared or global
// memory) into `sel` (shared memory, in no order) and returns how many.
// Every thread of the block calls it; blockDim.x is a multiple of 32.
__device__ int block_select(const uint64_t* src, int n, int k, uint64_t* sel,
                            Scratch& sc) {
  const int tid = threadIdx.x, lane = tid % rt::kWarp;
  uint64_t prefix = 0, mask = 0;  // keys with (key & mask) >= prefix survive
  if (n > k) {
    int need = k;  // keys still to take among those matching the prefix
    for (int shift = 56;; shift -= 8) {
      for (int b = tid; b < 256; b += blockDim.x) sc.hist[b] = 0;
      __syncthreads();
      for (int base = 0; base < n; base += blockDim.x) {
        const int i = base + tid;
        const uint64_t key = i < n ? src[i] : rt::kNoKey;
        warp_hist_add(sc.hist, static_cast<int>((key >> shift) & 0xFF),
                      i < n && (key & mask) == prefix);
      }
      __syncthreads();
      if (tid < rt::kWarp) {  // the bucket of the need-th largest: lane l
        unsigned c[8], s = 0;  // holds bins 255-8l down to 248-8l
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          c[j] = sc.hist[255 - 8 * lane - j];
          s += c[j];
        }
        unsigned inc = s;
#pragma unroll
        for (int off = 1; off < rt::kWarp; off <<= 1) {
          const unsigned t = __shfl_up_sync(0xffffffffu, inc, off);
          if (lane >= off) inc += t;
        }
        const unsigned hit = __ballot_sync(0xffffffffu, inc >= static_cast<unsigned>(need));
        if (lane == __ffs(hit) - 1) {
          unsigned run = inc - s;
          for (int j = 0; j < 8; ++j) {
            if (run + c[j] >= static_cast<unsigned>(need)) {
              sc.digit = 255 - 8 * lane - j;
              sc.need = need - static_cast<int>(run);
              sc.count = static_cast<int>(c[j]);
              break;
            }
            run += c[j];
          }
        }
      }
      __syncthreads();
      need = sc.need;
      prefix |= static_cast<uint64_t>(sc.digit) << shift;
      mask |= 0xFFull << shift;
      if (sc.count == need || shift == 0) break;  // the bucket is taken whole
    }
  }
  if (tid == 0) sc.n_sel = 0;
  __syncthreads();
  for (int base = 0; base < n; base += blockDim.x) {
    const int i = base + tid;
    const uint64_t key = i < n ? src[i] : rt::kNoKey;
    const bool on = i < n && (key & mask) >= prefix;
    const unsigned b = __ballot_sync(0xffffffffu, on);
    unsigned pos = 0;
    if (lane == 0 && b) pos = atomicAdd(&sc.n_sel, static_cast<unsigned>(__popc(b)));
    pos = __shfl_sync(0xffffffffu, pos, 0) + __popc(b & ((1u << lane) - 1u));
    if (on && pos < static_cast<unsigned>(k)) sel[pos] = key;
  }
  __syncthreads();
  return n < k ? n : k;
}

// Hands the ns distinct keys of `sel` to out(rank, key), rank 0 the largest,
// then out(i, kNoKey) for i in [ns, k).
template <class Out>
__device__ void block_rank(const uint64_t* sel, int ns, int k, const Out& out) {
  for (int i = threadIdx.x; i < ns; i += blockDim.x) {
    const uint64_t key = sel[i];
    int r = 0;
    for (int j = 0; j < ns; ++j) r += sel[j] > key;
    out(r, key);
  }
  for (int i = ns + static_cast<int>(threadIdx.x); i < k; i += blockDim.x)
    out(i, rt::kNoKey);
}

// The top digit (12 bits) of the k-th largest of the keys counted in the
// global histogram `hist`, or 0 when it counts no more than k keys. Every
// thread of a kFilterThreads block calls it.
__device__ int block_top_digit(const unsigned* __restrict__ hist, int k) {
  __shared__ unsigned s_warp[kFilterThreads / rt::kWarp];
  __shared__ int s_digit;
  const int tid = threadIdx.x, lane = tid % rt::kWarp, warp = tid / rt::kWarp;
  const int lo = kTopBins - 16 * (tid + 1);  // thread 0 holds the top 16 bins
  const uint4* h4 = reinterpret_cast<const uint4*>(hist + lo);
  unsigned c[16], s = 0;
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const uint4 x = h4[v];
    c[4 * v] = x.x;
    c[4 * v + 1] = x.y;
    c[4 * v + 2] = x.z;
    c[4 * v + 3] = x.w;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) s += c[j];
  unsigned inc = s;
#pragma unroll
  for (int off = 1; off < rt::kWarp; off <<= 1) {
    const unsigned t = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += t;
  }
  if (lane == rt::kWarp - 1) s_warp[warp] = inc;
  if (tid == 0) s_digit = 0;
  __syncthreads();
  for (int w = 0; w < warp; ++w) inc += s_warp[w];
  const unsigned before = inc - s, kk = static_cast<unsigned>(k);
  if (before < kk && inc >= kk) {  // one thread holds the k-th largest
    unsigned run = before;
    for (int j = 15; j >= 0; --j) {
      if (run + c[j] >= kk) {
        s_digit = lo + j;
        break;
      }
      run += c[j];
    }
  }
  __syncthreads();
  return s_digit;
}

// Appends to `list` (counting in *count) the keys among keys[0..n) whose top
// digit is at or above that of the k-th largest, read off `hist`.
__global__ void __launch_bounds__(kFilterThreads)
topk_filter_kernel(const uint64_t* __restrict__ keys, long long n,
                   const unsigned* __restrict__ hist, int k,
                   uint64_t* __restrict__ list, unsigned* __restrict__ count) {
  const int digit = block_top_digit(hist, k);
  const long long step = static_cast<long long>(gridDim.x) * kFilterThreads;
  for (long long base = static_cast<long long>(blockIdx.x) * kFilterThreads; base < n;
       base += step) {
    const long long i = base + threadIdx.x;
    const uint64_t key = i < n ? keys[i] : rt::kNoKey;
    warp_append(list, count, key, i < n && top_digit(key) >= digit);
  }
}

// One block a lane: the top k of the lane's list (lists + lane * stride,
// counts[lane] keys long), ranked and handed to out(lane, rank, key). Sets
// n_valid[lane] (when given) to the list's length, then zeroes counts[lane]
// and, in lane 0's block, the n_clear words at `clear`.
template <class Out>
__global__ void __launch_bounds__(kFinishThreads)
topk_finish_kernel(const uint64_t* __restrict__ lists, long long stride,
                   unsigned* __restrict__ counts, int k, int cache,
                   unsigned* __restrict__ clear, int n_clear, int* __restrict__ n_valid,
                   Out out) {
  extern __shared__ uint64_t smem[];  // k selected keys, then the cached list
  __shared__ Scratch sc;
  const int lane = blockIdx.x;
  const uint64_t* list = lists + lane * stride;
  const int n = static_cast<int>(counts[lane]);
  const uint64_t* src = list;
  if (n <= cache) {
    uint64_t* buf = smem + k;
    for (int i = threadIdx.x; i < n; i += blockDim.x) buf[i] = list[i];
    __syncthreads();
    src = buf;
  }
  const int ns = block_select(src, n, k, smem, sc);
  block_rank(smem, ns, k, [&](int r, uint64_t key) { out(lane, r, key); });
  if (threadIdx.x == 0) {
    if (n_valid != nullptr) n_valid[lane] = n;
    counts[lane] = 0;
  }
  if (lane == 0)
    for (int i = threadIdx.x; i < n_clear; i += blockDim.x) clear[i] = 0;
}

// Sets the dynamic shared memory a finish launch of `k` and `cache` needs.
template <class Out>
cudaError_t finish_prepare(int k, int cache, size_t* smem) {
  *smem = static_cast<size_t>(k + cache) * sizeof(uint64_t);
  return cudaFuncSetAttribute(topk_finish_kernel<Out>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

}  // namespace sel

// Workspace words (32-bit) a launch with `tickets` arrival tickets needs.
extern "C" long long topk_workspace_len(long long tickets) {
  return sel::kWsTickets + tickets;
}
