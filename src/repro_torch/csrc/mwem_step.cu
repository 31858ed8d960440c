// The fused MWEM step and the lazy-EM tail scorer on Hopper (kernels K2, K3).
//
// K2 replaces `_kernel` / `mwem_step_pallas` of
// src/repro/kernels/mwem_step/mwem_step.py: measure -> multiplicative-weights
// update (rule paper, signed or hardt) -> max-shift -> softmax -> p_sum += p'.
// One block of 1024 threads holds the whole (U,) state in registers (at most
// kElems values a thread, so U <= 16384), reads the winner row straight from
// the (R, U) table by the id in device memory, and does the two dots, the max
// and the sum of exponentials as block reductions. It moves 8 U-vectors
// (5 read, 3 written): a few hundred kilobytes, so one launch is bound by its
// latency and by what one SM can pull from memory, not by the card's rate.
// A wave of B lanes runs on a (B,) grid, one block a lane, as the TPU kernel's
// grid does: block b reads lane b's state, winner id, noise and -- when `h` is
// per lane -- its histogram (`h_stride` floats apart; 0 when shared), and
// does exactly the arithmetic of a single-lane launch.
//
// K3 replaces `_score_kernel` / `gather_score_pallas` of the same file:
// sign[c] * <q_rows[base[c]], v> for the lazy-EM tail candidates, one warp per
// candidate, the augmented id j decoded in the kernel to (j % m, +1 if j < m
// else -1). Candidates whose `active` flag is clear are not read (their score
// is written as 0), so the bytes follow the tail the draw actually asked for.
// Bound: device-memory bytes, one row of U floats per active candidate. A
// wave scores all its lanes' tails in one launch: candidate c of the (B, C)
// buffers belongs to lane c / C and is scored against that lane's probe.
#include "common.cuh"

namespace {

using rt::kWarp;
constexpr int kStepThreads = 1024;
constexpr int kElems = 16;
constexpr int kMaxU = kStepThreads * kElems;
constexpr int kScoreWarps = 8;

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

}  // namespace

extern "C" int mwem_step_max_u() { return kMaxU; }

// Returns a cudaError_t code (0 on success). Launches on `stream` and does
// not synchronise. The state and outputs are (lanes, U); `sel` and `noise`
// hold one value a lane on the device; `h` is (U,) with h_stride 0 or
// (lanes, U) with h_stride U.
extern "C" int mwem_step_launch(const long long* sel, const float* lw, const float* p,
                                const float* ps, const float* q_rows, const float* h,
                                const float* noise, int lanes, int U,
                                long long h_stride, int rule, float eta,
                                float* out_lw, float* out_p, float* out_ps,
                                void* stream) {
  if (lanes <= 0 || U <= 0 || U > kMaxU || rule < kPaper || rule > kHardt ||
      (h_stride != 0 && h_stride != U))
    return static_cast<int>(cudaErrorInvalidValue);
  mwem_step_kernel<<<lanes, kStepThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      sel, lw, p, ps, q_rows, h, noise, U, h_stride, rule, eta, out_lw, out_p,
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
