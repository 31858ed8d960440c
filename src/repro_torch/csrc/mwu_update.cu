// The fused multiplicative-weights update on Hopper (kernel K7 of the port).
//
// Replaces the TPU kernel `_kernel` / `mwu_update_pallas` of
// src/repro/kernels/mwu_update/mwu_update.py (wrapper `mwu_update` in
// ops.py there): lw' = lw + coef * c over a row of U log-weights, with the
// row's max m and sum of exponentials s = sum_i exp(lw'_i - m) taken online
// (a running (max, sumexp) pair rescaled when the max grows, as flash
// attention does), so lw and c are read once. Because the next consumer
// always needs p = exp(lw' - m) / s, this launch writes p too.
//
// The private LP solvers run it every iteration: the primal player's update
// lw + (-eta/rho) * A[sel] (U = d, the winner's row read from the (n, U)
// table by the id in device memory, so the selection never goes back to the
// host), and the dual player's lw + (-eta) * loss (U = m, a dense row).
//
// Design: one block per row (the TPU kernel's sequential grid over U tiles
// becomes a block-stride loop); each thread keeps its own running (max,
// sumexp) pair, the pairs merge by warp shuffles and then across warps in
// shared memory; a second sweep writes p. The update is an explicit
// multiply and add (no fused multiply-add), so lw' is the plain version's
// bit for bit, and m is exact; s and p differ from a sum in another order
// by rounding only.
//
// Bound: device-memory bytes, 16 per element (lw and c read, lw' and p
// written). On the LP paths U is 20 or 300, so a launch moves a few
// kilobytes and is bound by its launch latency; a row of 2^20 runs on one
// SM, far from the card's memory rate. Spreading a long row over blocks is
// later work.
#include "common.cuh"

namespace {

using rt::kWarp;
constexpr int kMaxThreads = 1024;

// Fold one value into a running (max, sumexp) pair.
__device__ __forceinline__ void online_add(float& m, float& s, float x) {
  if (x > m) {
    s = s * expf(m - x) + 1.0f;  // m == -inf on the first value: s = 1
    m = x;
  } else if (m != -INFINITY) {
    s += expf(x - m);
  }
}

// Merge the pair (m2, s2) into (m, s); a pair that saw nothing is (-inf, 0).
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  if (m2 == -INFINITY) return;
  if (m == -INFINITY) {
    m = m2;
    s = s2;
    return;
  }
  const float M = fmaxf(m, m2);
  s = s * expf(m - M) + s2 * expf(m2 - M);
  m = M;
}

__device__ __forceinline__ void warp_merge(float& m, float& s) {
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    merge(m, s, m2, s2);
  }
}

__global__ void __launch_bounds__(kMaxThreads)
mwu_update_kernel(const float* __restrict__ lw, const float* __restrict__ c,
                  const long long* __restrict__ rows, int U, float coef,
                  float* __restrict__ out_lw, float* __restrict__ out_p,
                  float* __restrict__ out_m, float* __restrict__ out_s) {
  __shared__ float red_m[kWarp], red_s[kWarp];
  __shared__ float row_m, row_s;
  const int b = blockIdx.x;  // the row
  const long long off = static_cast<long long>(b) * U;
  lw += off;
  out_lw += off;
  out_p += off;
  c += (rows != nullptr ? rows[b] : static_cast<long long>(b)) *
       static_cast<long long>(U);
  float m = -INFINITY, s = 0.0f;
  for (int i = threadIdx.x; i < U; i += blockDim.x) {
    const float x = __fadd_rn(lw[i], __fmul_rn(coef, c[i]));
    out_lw[i] = x;
    online_add(m, s, x);
  }
  warp_merge(m, s);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  if (lane == 0) {
    red_m[warp] = m;
    red_s[warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x / kWarp;
    m = lane < nw ? red_m[lane] : -INFINITY;
    s = lane < nw ? red_s[lane] : 0.0f;
    warp_merge(m, s);
    if (lane == 0) {
      row_m = m;
      row_s = s;
      out_m[b] = m;
      out_s[b] = s;
    }
  }
  __syncthreads();
  const float M = row_m, S = row_s;
  for (int i = threadIdx.x; i < U; i += blockDim.x)
    out_p[i] = expf(out_lw[i] - M) / S;  // this thread's own writes above
}

}  // namespace

// lw, out_lw, out_p: (B, U) f32; out_m, out_s: (B,) f32. `rows` null: c is
// (B, U), row b updates with c[b]; else c is an (n, U) table and row b
// updates with c[rows[b]] (int64 ids on the device). Returns a cudaError_t
// code (0 on success). Launches on `stream` and does not synchronise.
extern "C" int mwu_update_launch(const float* lw, const float* c,
                                 const long long* rows, int B, int U, float coef,
                                 float* out_lw, float* out_p, float* out_m,
                                 float* out_s, void* stream) {
  if (B < 1 || U < 1) return static_cast<int>(cudaErrorInvalidValue);
  int threads = ((U + kWarp - 1) / kWarp) * kWarp;
  if (threads > kMaxThreads) threads = kMaxThreads;
  mwu_update_kernel<<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      lw, c, rows, U, coef, out_lw, out_p, out_m, out_s);
  return static_cast<int>(cudaGetLastError());
}
