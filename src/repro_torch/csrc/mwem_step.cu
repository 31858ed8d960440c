// The fused MWEM step and the lazy-EM tail scorers on Hopper (kernels K2, K3,
// K6).
//
// K2 replaces `_kernel` / `mwem_step_pallas` of
// src/repro/kernels/mwem_step/mwem_step.py: measure -> multiplicative-weights
// update (rule paper, signed or hardt) -> max-shift -> softmax -> p_sum += p'.
// It has two routes, chosen by U at the launch:
// * one block (U <= 16384): 1024 threads hold the whole (U,) state in
//   registers (at most kElems values a thread), read the winner row straight
//   from the (R, U) table by the id in device memory, and do the two dots, the
//   max and the sum of exponentials as block reductions. It moves 8 U-vectors
//   (5 read, 3 written): a few hundred kilobytes, so one launch is bound by
//   its latency and by what one SM can pull from memory, not by the card's
//   rate.
// * several blocks (any larger U): each block owns a kChunk-element slice of
//   a lane, and three launches replace the block-wide reductions with
//   per-block partials in a scratch buffer: (1) the partial dots <q, h> and
//   <q, p>; (2) the update, written to out_lw, with the block's max and its
//   sum of exp(lw' - block max); (3) the lane's max M and sum
//   S = sum_b s_b * exp(m_b - M), then lw' - M, p' = exp(lw' - M) / S and
//   p_sum + p'. Every block reduces its lane's partials itself, one thread in
//   block order, with no float atomics, so a run repeats itself bit for bit.
//   Each exp is taken of a value minus a max at least as large. The three
//   launches move the same 8 U-vectors plus the out_lw round trip; the
//   bound is the card's memory rate once U is large.
// A wave of B lanes runs on a (B,) grid (one block a lane, or the lane as the
// grid's second dimension), as the TPU kernel's grid does: lane b reads its
// state, winner id, noise and -- when `h` is per lane -- its histogram
// (`h_stride` floats apart; 0 when shared), and does exactly the arithmetic
// of a single-lane launch.
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
// no row table exists. One block per candidate decodes its augmented id,
// reads its query's clique id and cell offset and the clique's mixed-radix
// parameters (domain strides, cardinalities, cell strides; the analogue of
// the TPU kernel's scalar prefetch) from device memory, then strides over
// the U domain points, rebuilds each point's cell
// cm(u) = sum_j ((u / dstride_j) % card_j) * cstride_j in 32-bit integers,
// and sums v[u] where cm(u) equals the offset. The bytes are v (read from L2
// by every block) and a few parameters; what bounds it is the integer
// arithmetic: 2 * kmax divisions by values known only at run time, each a
// sequence of some twenty instructions, for each of the C * U (candidate,
// point) pairs -- far above the C * U operations the bound counts. Walking
// only the U / cells points of the candidate's cell is later work.
#include "common.cuh"

namespace {

using rt::kWarp;
constexpr int kStepThreads = 1024;
constexpr int kElems = 16;
constexpr int kMaxU = kStepThreads * kElems;
constexpr int kScoreWarps = 8;
constexpr int kMbThreads = 256;  // multi-block K2: threads a block
constexpr int kMbElems = 8;      // values a thread
constexpr int kChunk = kMbThreads * kMbElems;
constexpr int kMargThreads = 256;  // K6: threads a block (one candidate)
constexpr int kMaxK = 32;          // K6: most attributes in a clique

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

__global__ void __launch_bounds__(kStepThreads)
mwem_step_kernel(const long long* __restrict__ sel, const float* __restrict__ lw,
                 const float* __restrict__ p, const float* __restrict__ ps,
                 const float* __restrict__ q_rows, const float* __restrict__ h,
                 const float* __restrict__ noise, int U, long long h_stride,
                 int rule, float eta, float* __restrict__ out_lw,
                 float* __restrict__ out_p, float* __restrict__ out_ps) {
  __shared__ float red[kWarp];
  const int b = blockIdx.x;  // the lane
  const long long off = static_cast<long long>(b) * U;
  lw += off;
  p += off;
  ps += off;
  out_lw += off;
  out_p += off;
  out_ps += off;
  h += b * h_stride;
  const float* q = q_rows + sel[b] * static_cast<long long>(U);
  float qv[kElems], lv[kElems];
  float dot_h = 0.0f, dot_p = 0.0f;
#pragma unroll
  for (int e = 0; e < kElems; ++e) {
    const int i = static_cast<int>(threadIdx.x) + e * kStepThreads;
    qv[e] = 0.0f;
    lv[e] = -INFINITY;
    if (i < U) {
      qv[e] = q[i];
      lv[e] = lw[i];
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
    const float measured = block_reduce<false>(dot_h, red) + noise[b];
    const float est = block_reduce<false>(dot_p, red);
    const float diff = measured - est;
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
    if (static_cast<int>(threadIdx.x) + e * kStepThreads < U) mx = fmaxf(mx, lv[e]);
  mx = block_reduce<true>(mx, red);
  float sum = 0.0f;
#pragma unroll
  for (int e = 0; e < kElems; ++e) {
    const bool in = static_cast<int>(threadIdx.x) + e * kStepThreads < U;
    lv[e] = in ? lv[e] - mx : 0.0f;
    qv[e] = in ? expf(lv[e]) : 0.0f;  // qv now holds exp(lw')
    sum += qv[e];
  }
  sum = block_reduce<false>(sum, red);
#pragma unroll
  for (int e = 0; e < kElems; ++e) {
    const int i = static_cast<int>(threadIdx.x) + e * kStepThreads;
    if (i < U) {
      const float pn = qv[e] / sum;
      out_lw[i] = lv[e];
      out_p[i] = pn;
      out_ps[i] = ps[i] + pn;
    }
  }
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


// Multi-block K2, pass 1: the block's partial <q, h> and <q, p>, written to
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

// Multi-block K2, pass 2: the update of the block's slice, written to out_lw
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

// Multi-block K2, pass 3: the lane's max M and sum S from pass 2's partials
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

// K6: one block per candidate; see the note at the top of the file. The
// clique tables are (n_cliques, kmax) int32, row-major.
__global__ void __launch_bounds__(kMargThreads)
marginal_gather_score_kernel(const int* __restrict__ q_clique,
                             const int* __restrict__ q_offset,
                             const int* __restrict__ cl_dstride,
                             const int* __restrict__ cl_card,
                             const int* __restrict__ cl_stride, int kmax, int m, int U,
                             const float* __restrict__ v,
                             const long long* __restrict__ aug,
                             const uint8_t* __restrict__ active,
                             float* __restrict__ out) {
  __shared__ unsigned prm[3 * kMaxK];
  __shared__ float red[kWarp];
  const int c = blockIdx.x;
  if (active != nullptr && !active[c]) {  // the same for the whole block
    if (threadIdx.x == 0) out[c] = 0.0f;
    return;
  }
  const long long j = aug[c];
  const long long base = j % m;
  const float sign = j < m ? 1.0f : -1.0f;
  const long long cl = q_clique[base];
  const unsigned offset = static_cast<unsigned>(q_offset[base]);
  if (static_cast<int>(threadIdx.x) < kmax) {
    const long long at = cl * kmax + threadIdx.x;
    prm[threadIdx.x] = static_cast<unsigned>(cl_dstride[at]);
    prm[kMaxK + threadIdx.x] = static_cast<unsigned>(cl_card[at]);
    prm[2 * kMaxK + threadIdx.x] = static_cast<unsigned>(cl_stride[at]);
  }
  __syncthreads();
  float acc = 0.0f;
  for (unsigned u = threadIdx.x; u < static_cast<unsigned>(U); u += kMargThreads) {
    unsigned cm = 0;
    for (int a = 0; a < kmax; ++a)
      cm += ((u / prm[a]) % prm[kMaxK + a]) * prm[2 * kMaxK + a];
    if (cm == offset) acc += __ldg(v + u);
  }
  acc = block_reduce<false>(acc, red);
  if (threadIdx.x == 0) out[c] = acc * sign;
}

}  // namespace

extern "C" int mwem_step_max_u() { return kMaxU; }
extern "C" int mwem_step_chunk() { return kChunk; }
extern "C" int marginal_gather_score_max_k() { return kMaxK; }

// Returns a cudaError_t code (0 on success). Launches on `stream` and does
// not synchronise. The state and outputs are (lanes, U); `sel` and `noise`
// hold one value a lane on the device; `h` is (U,) with h_stride 0 or
// (lanes, U) with h_stride U. U <= mwem_step_max_u() takes the one-block
// route and ignores `scratch`; a larger U takes the multi-block route, whose
// `scratch` holds lanes * ceil(U / mwem_step_chunk()) * 4 floats.
extern "C" int mwem_step_launch(const long long* sel, const float* lw, const float* p,
                                const float* ps, const float* q_rows, const float* h,
                                const float* noise, int lanes, int U,
                                long long h_stride, int rule, float eta,
                                float* out_lw, float* out_p, float* out_ps,
                                float* scratch, void* stream) {
  if (lanes <= 0 || U <= 0 || rule < kPaper || rule > kHardt ||
      (h_stride != 0 && h_stride != U))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (U <= kMaxU) {
    mwem_step_kernel<<<lanes, kStepThreads, 0, st>>>(
        sel, lw, p, ps, q_rows, h, noise, U, h_stride, rule, eta, out_lw, out_p,
        out_ps);
    return static_cast<int>(cudaGetLastError());
  }
  if (scratch == nullptr || lanes > 65535) return static_cast<int>(cudaErrorInvalidValue);
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
// null; the clique tables are (n_cliques, kmax) int32 with kmax <=
// marginal_gather_score_max_k(); `q_clique` / `q_offset` are (m,) int32;
// `v` is (U,); `out` is (C,).
extern "C" int marginal_gather_score_launch(const int* q_clique, const int* q_offset,
                                            const int* cl_dstride, const int* cl_card,
                                            const int* cl_stride, int kmax, int m, int U,
                                            const float* v, const long long* aug,
                                            const uint8_t* active, int C, float* out,
                                            void* stream) {
  if (m <= 0 || U <= 0 || C < 0 || kmax <= 0 || kmax > kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0) return 0;
  marginal_gather_score_kernel<<<C, kMargThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      q_clique, q_offset, cl_dstride, cl_card, cl_stride, kmax, m, U, v, aug, active,
      out);
  return static_cast<int>(cudaGetLastError());
}
