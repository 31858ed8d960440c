// The fused MWEM step and the lazy-EM tail scorers on Hopper (kernels K2, K3,
// K6).
//
// K2 replaces `_kernel` / `mwem_step_pallas` of
// src/repro/kernels/mwem_step/mwem_step.py: measure -> multiplicative-weights
// update (rule paper, signed or hardt) -> max-shift -> softmax -> p_sum += p'.
// It moves 8 U-vectors (5 read, 3 written): a few hundred kilobytes at the
// main paths' U, so a launch is bound by its latency and by what the few SMs
// it runs on pull from memory, not by the card's rate. It has two routes;
// kernels/mwem_step/ops.py::plan(U, lanes) picks one and the launch function
// checks the same limits:
// * one thread-block cluster a lane (U <= kClusterU = 32768), one launch:
//   S = 1, 2, 4 or 8 blocks of 1024 threads, each holding an even slice of
//   the lane (a multiple of 128 elements) in registers, up to 4 values a
//   thread. plan picks the least S that holds the lane: a block's time grows
//   with the bytes its one SM moves, and a fourth of a 2^14 lane a block
//   beat one block holding all of it. A block reads the winner row straight
//   from the (R, U) table by the id in device memory, reduces its partial
//   dots <q, h> and <q, p> in one pass, then its softmax pair -- max m_b and
//   sum s_b of exp(lw' - m_b), merged thread to warp to block so each exp is
//   of a value minus a max at least as large -- each into its own shared
//   memory. After each cluster barrier every block reads all S partials
//   through distributed shared memory in rank order, so every block reduces
//   in the same fixed order and a run repeats itself bit for bit: the dots,
//   then M = max m_b and Z = sum_b s_b * exp(m_b - M) (the three-launch
//   route's arithmetic). A block arrives at a last cluster barrier once it
//   has read the others' partials and waits on it after writing lw' - M,
//   p' = exp(lw' - M) / Z and p_sum + p', so no block exits while another
//   may still read its shared memory. Past 32768 a cluster of 8 would hold
//   more values a thread and was slower on the card than the three launches,
//   which therefore keep every larger U.
// * three launches (any larger U): each block owns a kChunk-element slice of
//   a lane, and three launches replace the block-wide reductions with
//   per-block partials in a scratch buffer: (1) the partial dots <q, h> and
//   <q, p>; (2) the update, written to out_lw, with the block's max and its
//   sum of exp(lw' - block max); (3) the lane's max M and sum
//   S = sum_b s_b * exp(m_b - M), then lw' - M, p' = exp(lw' - M) / S and
//   p_sum + p'. Every block reduces its lane's partials itself, one thread in
//   block order, with no float atomics, so a run repeats itself bit for bit.
//   The three launches move the same 8 U-vectors plus the out_lw round trip,
//   over as many SMs as the lane has chunks.
// A wave of B lanes runs in the same launch (B clusters, or the lane as the
// three launches' second grid dimension), as the TPU kernel's grid does:
// lane b reads its state, winner id, noise and -- when `h` is per lane -- its histogram
// (`h_stride` floats apart; 0 when shared), and does exactly the arithmetic
// of a single-lane launch on the same route.
//
// K3 replaces `_score_kernel` / `gather_score_pallas` of the same file:
// sign[c] * <q_rows[base[c]], v> for the lazy-EM tail candidates, one warp per
// candidate, the augmented id j decoded in the kernel to (j % m, +1 if j < m
// else -1). Candidates whose `active` flag is clear are not read (their score
// is written as 0), so the bytes follow the tail the draw actually asked for.
// Bound: device-memory bytes, one row of U floats per active candidate. A
// wave scores all its lanes' tails in one launch: candidate c of the (B, C)
// buffers belongs to lane c / C and is scored against that lane's probe.
//
// K6 replaces `_marginal_score_kernel` / `marginal_gather_score_pallas` of
// the same file: K3's contract for a factored k-way marginal workload, where
// no row table exists. Query (clique, offset) is the indicator of the domain
// points whose digits on the clique's attributes spell the cell `offset`, so
// it has exactly U / cells points, and one block per candidate walks only
// those. The block decodes its augmented id, reads its query's clique and
// offset and the clique's row of the walk table (kernels/mwem_step/ops.py::
// walk_table, built once per workload on the host: the clique's attributes
// sorted by ascending domain stride ds, with inert columns -- pads and
// cardinality 1 -- last, each with its cardinality, cell stride and the
// multiply-high magic number and shift of a division by ds), and turns the
// offset into one digit an attribute, d_j = (offset / cstride_j) % card_j: the block's only
// run-time divisions. A free index r in [0, U / cells) then becomes its point
// by inserting the digits one attribute at a time in ascending stride,
// u = (u / ds_j) * ds_j * card_j + d_j * ds_j + u % ds_j
//   = u + (u / ds_j) * ds_j * (card_j - 1) + d_j * ds_j,
// where u / ds_j is a multiply-high and a shift (exact for u < 2^31, and U
// is below 2^31): no division in the per-point loop. Threads take r in
// strides of the block, four loads in flight, and sum v[u]; the block sums
// its threads. The work is U / cells points a candidate (2048 of 32768 for
// all 4-way marginals over 15 binary attributes) from a v that stays in L2,
// so a launch is bound by its latency; the bound counts the points of v the
// active candidates' cells cover and one add a point.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using rt::kWarp;
constexpr int kStepThreads = 1024;
constexpr int kElems = 4;        // cluster K2: values a thread
constexpr int kBlockU = kStepThreads * kElems;
constexpr int kMaxCluster = 8;   // cluster K2: most blocks a cluster (portable)
constexpr int kClusterU = kMaxCluster * kBlockU;  // cluster K2: most U
constexpr int kScoreWarps = 8;
constexpr int kMbThreads = 256;  // three-launch K2: threads a block
constexpr int kMbElems = 8;      // values a thread
constexpr int kChunk = kMbThreads * kMbElems;
constexpr int kMargThreads = 256;  // K6: threads a block (one candidate)
constexpr int kMargLoads = 4;      // K6: loads in flight a thread
constexpr int kMaxK = 32;          // K6: most attributes in a clique
constexpr int kWalkCols = 6;       // K6: ints a column of the walk table

enum Rule { kPaper = 0, kSigned = 1, kHardt = 2 };

template <bool kMax>
__device__ __forceinline__ float warp_reduce(float x) {
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, off);
    x = kMax ? fmaxf(x, y) : x + y;
  }
  return x;
}

// Block-wide sum or max; every thread gets the result. `red` holds 32 floats.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float x, float* red) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  x = warp_reduce<kMax>(x);
  __syncthreads();  // `red` may still be read by the previous reduction
  if (lane == 0) red[warp] = x;
  __syncthreads();
  const int nw = blockDim.x / kWarp;
  float y = lane < nw ? red[lane] : (kMax ? -INFINITY : 0.0f);
  return warp_reduce<kMax>(y);
}

// Cluster barrier in two halves: `arrive` once this block has read what it
// needs of the others' shared memory, `wait` before it exits.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// (max, sum of exp(x - max)) of two parts, each exp of a value minus a max
// at least as large; a part with no values has sum 0 and adds nothing.
__device__ __forceinline__ void softmax_merge(float& m, float& s, float m2, float s2) {
  const float mx = fmaxf(m, m2);
  s = (s > 0.0f ? s * expf(m - mx) : 0.0f) + (s2 > 0.0f ? s2 * expf(m2 - mx) : 0.0f);
  m = mx;
}

// Two warp-wide reductions in one pass: sums of (a, b), or with kSoftmax the
// softmax pair (max a, sum b) by `softmax_merge`; every lane gets the result.
template <bool kSoftmax>
__device__ __forceinline__ void warp_reduce2(float& a, float& b) {
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const float a2 = __shfl_xor_sync(0xffffffffu, a, off);
    const float b2 = __shfl_xor_sync(0xffffffffu, b, off);
    if (kSoftmax) {
      softmax_merge(a, b, a2, b2);
    } else {
      a += a2;
      b += b2;
    }
  }
}

// `warp_reduce2` over the block, in a fixed order; every thread gets the
// result. `red` holds 32 float2.
template <bool kSoftmax>
__device__ __forceinline__ void block_reduce2(float& a, float& b, float2* red) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  warp_reduce2<kSoftmax>(a, b);
  __syncthreads();  // `red` may still be read by the previous reduction
  if (lane == 0) red[warp] = make_float2(a, b);
  __syncthreads();
  const int nw = blockDim.x / kWarp;
  const float2 y = lane < nw ? red[lane] : make_float2(kSoftmax ? -INFINITY : 0.0f, 0.0f);
  a = y.x;
  b = y.y;
  warp_reduce2<kSoftmax>(a, b);
}

// Cluster K2: the (S * lanes,) grid runs one cluster of S blocks a lane;
// block rank x of lane blockIdx.x / S owns elements [x * slice,
// min(U, (x + 1) * slice)), kElems values a thread (slice <= kBlockU); see
// the note at the top of the file.
__global__ void __launch_bounds__(kStepThreads)
mwem_step_cluster_kernel(const long long* __restrict__ sel,
                         const float* __restrict__ lw, const float* __restrict__ p,
                         const float* __restrict__ ps, const float* __restrict__ q_rows,
                         const float* __restrict__ h, const float* __restrict__ noise,
                         int U, int slice, long long h_stride, int rule, float eta,
                         float* __restrict__ out_lw, float* __restrict__ out_p,
                         float* __restrict__ out_ps) {
  __shared__ float2 red[kWarp];
  __shared__ float part[4];  // <q, h>, <q, p>, max m_b, sum of exp(lw' - m_b)
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned S = cluster.num_blocks();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = static_cast<int>(blockIdx.x / S);  // the lane
  const long long off = static_cast<long long>(b) * U;
  lw += off;
  p += off;
  ps += off;
  out_lw += off;
  out_p += off;
  out_ps += off;
  h += b * h_stride;
  const float* q = q_rows + sel[b] * static_cast<long long>(U);
  const int lo = rank * slice + static_cast<int>(threadIdx.x);
  const int hi = min(U, (rank + 1) * slice);
  float qv[kElems], lv[kElems], sv[kElems];
  float dot_h = 0.0f, dot_p = 0.0f;
#pragma unroll
  for (int e = 0; e < kElems; ++e) {
    const int i = lo + e * kStepThreads;
    qv[e] = 0.0f;
    lv[e] = -INFINITY;
    sv[e] = 0.0f;
    if (i < hi) {
      qv[e] = q[i];
      lv[e] = lw[i];
      sv[e] = ps[i];
      if (rule != kPaper) {
        dot_h += qv[e] * h[i];
        dot_p += qv[e] * p[i];
      }
    }
  }
  if (rule == kPaper) {
#pragma unroll
    for (int e = 0; e < kElems; ++e) lv[e] = lv[e] - eta * qv[e];
  } else {
    block_reduce2<false>(dot_h, dot_p, red);
    if (threadIdx.x == 0) {
      part[0] = dot_h;
      part[1] = dot_p;
    }
    cluster.sync();
    float sum_h = 0.0f, sum_p = 0.0f;
    for (unsigned k = 0; k < S; ++k) {  // rank order, the same in every block
      const float* pk = cluster.map_shared_rank(part, k);
      sum_h += pk[0];
      sum_p += pk[1];
    }
    const float diff = (sum_h + noise[b]) - sum_p;
    if (rule == kSigned) {
      const float step = eta * static_cast<float>((diff > 0.0f) - (diff < 0.0f));
#pragma unroll
      for (int e = 0; e < kElems; ++e) lv[e] = lv[e] + step * qv[e];
    } else {
#pragma unroll
      for (int e = 0; e < kElems; ++e) lv[e] = lv[e] + qv[e] * diff / 2.0f;
    }
  }
  float mx = -INFINITY;
#pragma unroll
  for (int e = 0; e < kElems; ++e)
    if (lo + e * kStepThreads < hi) mx = fmaxf(mx, lv[e]);
  float sum = 0.0f;
#pragma unroll
  for (int e = 0; e < kElems; ++e)
    if (lo + e * kStepThreads < hi) sum += expf(lv[e] - mx);
  block_reduce2<true>(mx, sum, red);
  if (threadIdx.x == 0) {
    part[2] = mx;
    part[3] = sum;
  }
  cluster.sync();
  float lane_mx = -INFINITY, lane_sum = 0.0f;
  for (unsigned k = 0; k < S; ++k) {  // rank order
    const float* pk = cluster.map_shared_rank(part, k);
    softmax_merge(lane_mx, lane_sum, pk[2], pk[3]);
  }
  cluster_arrive();  // done with the other blocks' shared memory
#pragma unroll
  for (int e = 0; e < kElems; ++e) {
    const int i = lo + e * kStepThreads;
    if (i < hi) {
      const float l2 = lv[e] - lane_mx;
      const float pn = expf(l2) / lane_sum;
      out_lw[i] = l2;
      out_p[i] = pn;
      out_ps[i] = sv[e] + pn;
    }
  }
  cluster_wait();  // ... and the others with this block's
}

__global__ void __launch_bounds__(kScoreWarps * kWarp)
gather_score_kernel(const float* __restrict__ q_rows, int m, int U,
                    const float* __restrict__ v, const long long* __restrict__ aug,
                    const uint8_t* __restrict__ active, int C, int lanes, int vec,
                    float* __restrict__ out) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const long long c = static_cast<long long>(blockIdx.x) * kScoreWarps + warp;
  if (c >= static_cast<long long>(C) * lanes) return;
  v += (c / C) * U;  // the candidate's lane's probe
  if (active != nullptr && !active[c]) {
    if (lane == 0) out[c] = 0.0f;
    return;
  }
  const long long j = aug[c];
  const long long base = j % m;
  const float sign = j < m ? 1.0f : -1.0f;
  const float acc = rt::warp_dot(q_rows + base * U, v, U, lane, vec);
  if (lane == 0) out[c] = acc * sign;
}


// Three-launch K2, pass 1: the block's partial <q, h> and <q, p>, written to
// part[(lane * nblk + block) * 2 + {0, 1}].
__global__ void __launch_bounds__(kMbThreads)
mwem_step_dots_kernel(const long long* __restrict__ sel, const float* __restrict__ p,
                      const float* __restrict__ q_rows, const float* __restrict__ h,
                      int U, long long h_stride, float* __restrict__ part) {
  __shared__ float red[kWarp];
  const int b = blockIdx.y, nblk = gridDim.x;
  p += static_cast<long long>(b) * U;
  h += b * h_stride;
  const float* q = q_rows + sel[b] * static_cast<long long>(U);
  const int i0 = blockIdx.x * kChunk + static_cast<int>(threadIdx.x);
  float dot_h = 0.0f, dot_p = 0.0f;
#pragma unroll
  for (int e = 0; e < kMbElems; ++e) {
    const int i = i0 + e * kMbThreads;
    if (i < U) {
      const float qi = q[i];
      dot_h += qi * h[i];
      dot_p += qi * p[i];
    }
  }
  dot_h = block_reduce<false>(dot_h, red);
  dot_p = block_reduce<false>(dot_p, red);
  if (threadIdx.x == 0) {
    float* out = part + (static_cast<long long>(b) * nblk + blockIdx.x) * 2;
    out[0] = dot_h;
    out[1] = dot_p;
  }
}

// Three-launch K2, pass 2: the update of the block's slice, written to out_lw
// before the shift, and the block's max m and sum of exp(lw' - m), written to
// mpart[(lane * nblk + block) * 2 + {0, 1}]. The dots are the sums of pass
// 1's partials, taken by one thread in block order.
__global__ void __launch_bounds__(kMbThreads)
mwem_step_update_kernel(const long long* __restrict__ sel, const float* __restrict__ lw,
                        const float* __restrict__ q_rows,
                        const float* __restrict__ noise,
                        const float* __restrict__ part, int U, int rule, float eta,
                        float* __restrict__ out_lw, float* __restrict__ mpart) {
  __shared__ float red[kWarp];
  __shared__ float diff_s;
  const int b = blockIdx.y, nblk = gridDim.x;
  const long long off = static_cast<long long>(b) * U;
  lw += off;
  out_lw += off;
  const float* q = q_rows + sel[b] * static_cast<long long>(U);
  if (rule != kPaper && threadIdx.x == 0) {
    const float* pl = part + static_cast<long long>(b) * nblk * 2;
    float dot_h = 0.0f, dot_p = 0.0f;
    for (int k = 0; k < nblk; ++k) {
      dot_h += pl[2 * k];
      dot_p += pl[2 * k + 1];
    }
    diff_s = (dot_h + noise[b]) - dot_p;
  }
  __syncthreads();
  const int i0 = blockIdx.x * kChunk + static_cast<int>(threadIdx.x);
  float lv[kMbElems];
  float mx = -INFINITY;
#pragma unroll
  for (int e = 0; e < kMbElems; ++e) {
    const int i = i0 + e * kMbThreads;
    lv[e] = -INFINITY;
    if (i < U) {
      const float qi = q[i];
      if (rule == kPaper) {
        lv[e] = lw[i] - eta * qi;
      } else if (rule == kSigned) {
        const float d = diff_s;
        lv[e] = lw[i] + eta * static_cast<float>((d > 0.0f) - (d < 0.0f)) * qi;
      } else {
        lv[e] = lw[i] + qi * diff_s / 2.0f;
      }
      out_lw[i] = lv[e];
      mx = fmaxf(mx, lv[e]);
    }
  }
  mx = block_reduce<true>(mx, red);
  float sum = 0.0f;
#pragma unroll
  for (int e = 0; e < kMbElems; ++e)
    if (i0 + e * kMbThreads < U) sum += expf(lv[e] - mx);
  sum = block_reduce<false>(sum, red);
  if (threadIdx.x == 0) {
    float* out = mpart + (static_cast<long long>(b) * nblk + blockIdx.x) * 2;
    out[0] = mx;
    out[1] = sum;
  }
}

// Three-launch K2, pass 3: the lane's max M and sum S from pass 2's partials
// (one thread, block order), then lw' - M, p' = exp(lw' - M) / S and
// p_sum + p' over the block's slice.
__global__ void __launch_bounds__(kMbThreads)
mwem_step_norm_kernel(const float* __restrict__ ps, const float* __restrict__ mpart,
                      int U, float* __restrict__ out_lw, float* __restrict__ out_p,
                      float* __restrict__ out_ps) {
  __shared__ float mx_s, sum_s;
  const int b = blockIdx.y, nblk = gridDim.x;
  const long long off = static_cast<long long>(b) * U;
  ps += off;
  out_lw += off;
  out_p += off;
  out_ps += off;
  if (threadIdx.x == 0) {
    const float* ml = mpart + static_cast<long long>(b) * nblk * 2;
    float mx = -INFINITY;
    for (int k = 0; k < nblk; ++k) mx = fmaxf(mx, ml[2 * k]);
    float sum = 0.0f;
    for (int k = 0; k < nblk; ++k) sum += ml[2 * k + 1] * expf(ml[2 * k] - mx);
    mx_s = mx;
    sum_s = sum;
  }
  __syncthreads();
  const float mx = mx_s, sum = sum_s;
  const int i0 = blockIdx.x * kChunk + static_cast<int>(threadIdx.x);
#pragma unroll
  for (int e = 0; e < kMbElems; ++e) {
    const int i = i0 + e * kMbThreads;
    if (i < U) {
      const float l2 = out_lw[i] - mx;
      const float pn = expf(l2) / sum;
      out_lw[i] = l2;
      out_p[i] = pn;
      out_ps[i] = ps[i] + pn;
    }
  }
}

// K6: the point of free index u in the candidate's cell, from the block's
// inserting columns (multiply-high magic, shift, ds * (card - 1), d * ds);
// a column of magic 0 divides by ds = 1.
__device__ __forceinline__ unsigned cell_point(unsigned u, const unsigned (*col)[4],
                                               int n) {
  for (int a = 0; a < n; ++a) {
    const unsigned q = col[a][0] ? __umulhi(u, col[a][0]) >> col[a][1] : u;
    u += q * col[a][2] + col[a][3];
  }
  return u;
}

// K6: one block per candidate; see the note at the top of the file. The
// walk table is (n_cliques, kmax, kWalkCols) int32: a column is (magic,
// shift, ds, card, cstride, U / cells), ascending ds, inert columns last.
__global__ void __launch_bounds__(kMargThreads)
marginal_gather_score_kernel(const int* __restrict__ q_clique,
                             const int* __restrict__ q_offset,
                             const int* __restrict__ cl_walk, int kmax, int m,
                             const float* __restrict__ v,
                             const long long* __restrict__ aug,
                             const uint8_t* __restrict__ active,
                             float* __restrict__ out) {
  __shared__ unsigned col[kMaxK][4];
  __shared__ unsigned points;
  __shared__ float red[kWarp];
  const int c = blockIdx.x;
  if (active != nullptr && !active[c]) {  // the same for the whole block
    if (threadIdx.x == 0) out[c] = 0.0f;
    return;
  }
  const long long j = aug[c];
  const long long base = j % m;
  const float sign = j < m ? 1.0f : -1.0f;
  bool inserts = false;
  if (static_cast<int>(threadIdx.x) < kmax) {  // one column a thread
    const int* w = cl_walk + (static_cast<long long>(q_clique[base]) * kmax +
                              threadIdx.x) * kWalkCols;
    const unsigned ds = w[2], card = w[3];
    inserts = card > 1;
    if (inserts) {
      const unsigned digit = (static_cast<unsigned>(q_offset[base]) /
                              static_cast<unsigned>(w[4])) % card;
      col[threadIdx.x][0] = static_cast<unsigned>(w[0]);
      col[threadIdx.x][1] = static_cast<unsigned>(w[1]);
      col[threadIdx.x][2] = ds * (card - 1);
      col[threadIdx.x][3] = digit * ds;
    }
    if (threadIdx.x == 0) points = static_cast<unsigned>(w[5]);
  }
  const int n = __syncthreads_count(inserts);  // the inserting columns lead
  const unsigned npts = points;
  float acc = 0.0f;
  for (unsigned r0 = threadIdx.x; r0 < npts; r0 += kMargLoads * kMargThreads) {
    float x[kMargLoads];
#pragma unroll
    for (int e = 0; e < kMargLoads; ++e) {
      const unsigned r = r0 + e * kMargThreads;
      x[e] = r < npts ? __ldg(v + cell_point(r, col, n)) : 0.0f;
    }
#pragma unroll
    for (int e = 0; e < kMargLoads; ++e) acc += x[e];
  }
  acc = block_reduce<false>(acc, red);
  if (threadIdx.x == 0) out[c] = acc * sign;
}

}  // namespace

extern "C" int mwem_step_cluster_u() { return kClusterU; }
extern "C" int mwem_step_max_cluster() { return kMaxCluster; }
extern "C" int mwem_step_chunk() { return kChunk; }
extern "C" int marginal_gather_score_max_k() { return kMaxK; }
extern "C" int marginal_gather_score_walk_cols() { return kWalkCols; }

// Returns a cudaError_t code (0 on success). Launches on `stream` and does
// not synchronise. The state and outputs are (lanes, U); `sel` and `noise`
// hold one value a lane on the device; `h` is (U,) with h_stride 0 or
// (lanes, U) with h_stride U. `cluster` picks the route, as
// kernels/mwem_step/ops.py::plan does: 1, 2, 4 or 8 blocks a lane take the
// cluster route, which needs
// ceil(U / cluster) <= mwem_step_cluster_u() / mwem_step_max_cluster() and
// ignores `scratch`; 0 takes the three launches, which need
// U > mwem_step_cluster_u(), lanes <= 65535 and a `scratch` of
// lanes * ceil(U / mwem_step_chunk()) * 4 floats.
extern "C" int mwem_step_launch(const long long* sel, const float* lw, const float* p,
                                const float* ps, const float* q_rows, const float* h,
                                const float* noise, int lanes, int U,
                                long long h_stride, int rule, float eta,
                                float* out_lw, float* out_p, float* out_ps,
                                int cluster, float* scratch, void* stream) {
  if (lanes <= 0 || U <= 0 || rule < kPaper || rule > kHardt ||
      (h_stride != 0 && h_stride != U))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cluster != 0) {
    if ((cluster & (cluster - 1)) != 0 || cluster < 0 || cluster > kMaxCluster ||
        rt::ceil_div(U, cluster) > kBlockU ||
        static_cast<long long>(lanes) * cluster > 0x7FFFFFFFll)
      return static_cast<int>(cudaErrorInvalidValue);
    // even slices, each a multiple of 128 elements (aligned rows of a warp)
    const int slice = static_cast<int>(rt::ceil_div(rt::ceil_div(U, cluster), 128) * 128);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(lanes * cluster));
    cfg.blockDim = dim3(kStepThreads);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, mwem_step_cluster_kernel, sel, lw, p, ps, q_rows, h,
                                             noise, U, slice, h_stride, rule, eta,
                                             out_lw, out_p, out_ps);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
  }
  if (U <= kClusterU || scratch == nullptr || lanes > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nblk = (U + kChunk - 1) / kChunk;
  const dim3 grid(nblk, lanes);
  float* part = scratch;
  float* mpart = scratch + static_cast<long long>(lanes) * nblk * 2;
  if (rule != kPaper) {
    mwem_step_dots_kernel<<<grid, kMbThreads, 0, st>>>(sel, p, q_rows, h, U, h_stride,
                                                       part);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  mwem_step_update_kernel<<<grid, kMbThreads, 0, st>>>(sel, lw, q_rows, noise, part, U,
                                                       rule, eta, out_lw, mpart);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  mwem_step_norm_kernel<<<grid, kMbThreads, 0, st>>>(ps, mpart, U, out_lw, out_p,
                                                     out_ps);
  return static_cast<int>(cudaGetLastError());
}

// `v` is (lanes, U); `aug` holds (lanes, C) int64 augmented ids in [0, 2m);
// `active` is (lanes, C) bytes or null; `out` is (lanes, C).
extern "C" int gather_score_launch(const float* q_rows, int m, int U, const float* v,
                                   const long long* aug, const uint8_t* active, int C,
                                   int lanes, float* out, void* stream) {
  if (m <= 0 || U <= 0 || C < 0 || lanes <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0) return 0;
  const int vec = (U % 4 == 0) && (reinterpret_cast<uintptr_t>(q_rows) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(v) % 16 == 0);
  const long long total = static_cast<long long>(C) * lanes;
  const unsigned blocks = static_cast<unsigned>((total + kScoreWarps - 1) / kScoreWarps);
  gather_score_kernel<<<blocks, kScoreWarps * kWarp, 0,
                        static_cast<cudaStream_t>(stream)>>>(q_rows, m, U, v, aug,
                                                             active, C, lanes, vec,
                                                             out);
  return static_cast<int>(cudaGetLastError());
}

// K6. `aug` holds C int64 augmented ids in [0, 2m); `active` is C bytes or
// null; `cl_walk` is the (n_cliques, kmax, marginal_gather_score_walk_cols())
// int32 walk table with kmax <= marginal_gather_score_max_k();
// `q_clique` / `q_offset` are (m,) int32; `v` is (U,) with U < 2^31; `out` is
// (C,).
extern "C" int marginal_gather_score_launch(const int* q_clique, const int* q_offset,
                                            const int* cl_walk, int kmax, int m,
                                            const float* v, const long long* aug,
                                            const uint8_t* active, int C, float* out,
                                            void* stream) {
  if (m <= 0 || C < 0 || kmax <= 0 || kmax > kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0) return 0;
  marginal_gather_score_kernel<<<C, kMargThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      q_clique, q_offset, cl_walk, kmax, m, v, aug, active, out);
  return static_cast<int>(cudaGetLastError());
}
