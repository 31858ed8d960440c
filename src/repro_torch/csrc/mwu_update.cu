// The fused multiplicative-weights update on Hopper (kernel K7 of the port).
//
// Replaces the TPU kernel `_kernel` / `mwu_update_pallas` of
// src/repro/kernels/mwu_update/mwu_update.py (wrapper `mwu_update` in
// ops.py there): lw' = lw + coef * c over a row of U log-weights, the row's
// max m and sum of exponentials s = sum_i exp(lw'_i - m), and, because the
// next consumer always needs it, p = exp(lw' - m) / s.
//
// The private LP solvers run it every iteration: the primal player's update
// lw + (-eta/rho) * A[sel] (U = d, the winner's row read from the (n, U)
// table by the id in device memory, so the selection never goes back to the
// host), and the dual player's lw + (-eta) * loss (U = m, a dense row).
//
// Bound: device-memory bytes, 16 per element (lw and c read, lw' and p
// written). The LP rows (U = 20 or 300) move a few kilobytes, so a launch
// is bound by its latency and by the chain of dependent steps inside it; a
// row of 2^20 moves 16 MB, which only the whole card streams at its rate.
// So the route goes by row length; kernels/mwu_update/ops.py::plan(U, sms)
// picks it from U and the SM count alone (never from the number of rows,
// so a single row equals its row of a grid bit for bit), and the launch
// function checks the same limits:
// * warp  (U <= kWarpU = 1024): one warp a row, kWarpRows rows a block. The
//   row id is loaded first, then all of lw and c in one burst into
//   registers (V <= 32 values a lane); the max comes from a butterfly of
//   shuffles with no exp in it, then the sum of exp(lw' - m) from a second
//   one, and p is written from registers: no shared memory, no block
//   barrier, no re-read of out_lw.
// * block (U <= kBlockU = 8192): one block of 1024 threads a row, the row in
//   registers (up to 8 values a thread), a block max then a block sum.
// * grid  (longer rows): S blocks a row, each owning a slice of whole tiles
//   of kGridTile elements, S up to kGridBlocksPerSm blocks an SM so that the
//   whole card streams the row. Launch 1 writes lw' and each block's
//   partial (m_b, s_b) -- a per-thread running pair merged tile by tile,
//   then over the block -- to a scratch buffer the wrapper allocates.
//   Launch 2: every block combines its row's S partials in the same fixed
//   order (thread-strided, then a fixed shuffle tree), M = max m_b exactly,
//   Z = sum_b s_b * exp(m_b - M), so a run repeats itself bit for bit with
//   no float atomics; then writes p from lw', which the first launch left in
//   L2 (4 MB for a row of 2^20 against 50 MB of L2).
// Every route forms lw' with an explicit multiply and add (no fused
// multiply-add), so lw' is the plain version's bit for bit and m is exact;
// s and p differ from a sum in another order by rounding only.
#include "common.cuh"

namespace {

using rt::kWarp;
constexpr int kWarpU = 1024;          // warp route: most U, 32 values a lane
constexpr int kWarpRows = 4;          // warp route: rows (warps) a block
constexpr int kBlockThreads = 1024;   // block route
constexpr int kBlockU = 8192;         // block route: most U, 8 values a thread
constexpr int kGridThreads = 256;     // grid route
constexpr int kGridV = 8;             // grid route: values a thread a tile
constexpr int kGridTile = kGridThreads * kGridV;
constexpr int kGridBlocksPerSm = 4;   // grid route: most blocks an SM (ops.py)

enum Route { kWarpRoute = 0, kBlockRoute = 1, kGridRoute = 2 };

__device__ __forceinline__ float update(float lw, float coef, float c) {
  return __fadd_rn(lw, __fmul_rn(coef, c));
}

template <bool kMax>
__device__ __forceinline__ float warp_reduce(float x) {
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, off);
    x = kMax ? fmaxf(x, y) : x + y;
  }
  return x;
}

// Block-wide sum or max, in a fixed order; every thread gets the result.
// `red` holds 32 floats.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float x, float* red) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  x = warp_reduce<kMax>(x);
  __syncthreads();  // `red` may still be read by the previous reduction
  if (lane == 0) red[warp] = x;
  __syncthreads();
  const int nw = blockDim.x / kWarp;
  return warp_reduce<kMax>(lane < nw ? red[lane] : (kMax ? -INFINITY : 0.0f));
}

// (max, sum of exp(x - max)) of two parts; a part with no values has sum 0.
__device__ __forceinline__ void pair_merge(float& m, float& s, float m2, float s2) {
  const float mx = fmaxf(m, m2);
  s = (s > 0.0f ? s * expf(m - mx) : 0.0f) + (s2 > 0.0f ? s2 * expf(m2 - mx) : 0.0f);
  m = mx;
}

// The row's c: row `rows[b]` of the table, or row b of the dense c.
__device__ __forceinline__ const float* c_row(const float* c, const long long* rows,
                                              long long b, int U) {
  return c + (rows != nullptr ? rows[b] : b) * static_cast<long long>(U);
}

// Warp route: warp w of block x updates row x * kWarpRows + w; value e of
// lane l is element e * 32 + l.
template <int V>
__global__ void __launch_bounds__(kWarpRows * kWarp)
mwu_warp_kernel(const float* __restrict__ lw, const float* __restrict__ c,
                const long long* __restrict__ rows, int B, int U, float coef,
                float* __restrict__ out_lw, float* __restrict__ out_p,
                float* __restrict__ out_m, float* __restrict__ out_s) {
  const int lane = threadIdx.x % kWarp;
  const long long b = static_cast<long long>(blockIdx.x) * kWarpRows + threadIdx.x / kWarp;
  if (b >= B) return;
  const float* cr = c_row(c, rows, b, U);
  const long long off = b * U;
  float x[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const int i = e * kWarp + lane;
    x[e] = i < U ? update(lw[off + i], coef, cr[i]) : -INFINITY;
  }
  float m = x[0];
#pragma unroll
  for (int e = 1; e < V; ++e) m = fmaxf(m, x[e]);
  m = warp_reduce<true>(m);
  float ex[V], s = 0.0f;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    ex[e] = expf(x[e] - m);  // a pad value gives exp(-inf) = 0
    s += ex[e];
  }
  s = warp_reduce<false>(s);
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const int i = e * kWarp + lane;
    if (i < U) {
      out_lw[off + i] = x[e];
      out_p[off + i] = ex[e] / s;
    }
  }
  if (lane == 0) {
    out_m[b] = m;
    out_s[b] = s;
  }
}

// Block route: block b updates row b; value e of thread t is element
// e * 1024 + t.
template <int V>
__global__ void __launch_bounds__(kBlockThreads)
mwu_block_kernel(const float* __restrict__ lw, const float* __restrict__ c,
                 const long long* __restrict__ rows, int U, float coef,
                 float* __restrict__ out_lw, float* __restrict__ out_p,
                 float* __restrict__ out_m, float* __restrict__ out_s) {
  __shared__ float red[kWarp];
  const long long b = blockIdx.x;
  const float* cr = c_row(c, rows, b, U);
  const long long off = b * U;
  const int t = threadIdx.x;
  float x[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const int i = e * kBlockThreads + t;
    x[e] = i < U ? update(lw[off + i], coef, cr[i]) : -INFINITY;
  }
  float m = x[0];
#pragma unroll
  for (int e = 1; e < V; ++e) m = fmaxf(m, x[e]);
  m = block_reduce<true>(m, red);
  float ex[V], s = 0.0f;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    ex[e] = expf(x[e] - m);
    s += ex[e];
  }
  s = block_reduce<false>(s, red);
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const int i = e * kBlockThreads + t;
    if (i < U) {
      out_lw[off + i] = x[e];
      out_p[off + i] = ex[e] / s;
    }
  }
  if (t == 0) {
    out_m[b] = m;
    out_s[b] = s;
  }
}

// Grid route, launch 1: block k of row b (block index b * S + k) owns
// elements [k * slice, min(U, (k + 1) * slice)), a whole number of tiles;
// it writes lw' there and its (max, sum of exp(lw' - max)) to part[2 * block].
__global__ void __launch_bounds__(kGridThreads)
mwu_grid_partial_kernel(const float* __restrict__ lw, const float* __restrict__ c,
                        const long long* __restrict__ rows, int U, float coef, int S,
                        int slice, float* __restrict__ out_lw, float* __restrict__ part) {
  __shared__ float red_m[kWarp], red_s[kWarp];
  const long long b = blockIdx.x / S;
  const int k = static_cast<int>(blockIdx.x % S), t = threadIdx.x;
  const float* cr = c_row(c, rows, b, U);
  const long long off = b * U;
  const int lo = k * slice, hi = min(U, lo + slice);
  float m = -INFINITY, s = 0.0f;
  for (int t0 = lo; t0 < hi; t0 += kGridTile) {
    float x[kGridV];
    float tm = -INFINITY;
#pragma unroll
    for (int e = 0; e < kGridV; ++e) {
      const int i = t0 + e * kGridThreads + t;
      x[e] = i < hi ? update(lw[off + i], coef, cr[i]) : -INFINITY;
      tm = fmaxf(tm, x[e]);
    }
#pragma unroll
    for (int e = 0; e < kGridV; ++e) {
      const int i = t0 + e * kGridThreads + t;
      if (i < hi) out_lw[off + i] = x[e];
    }
    if (tm == -INFINITY) continue;  // no value of this thread in the tile
    if (tm > m) {
      s = s > 0.0f ? s * expf(m - tm) : 0.0f;
      m = tm;
    }
#pragma unroll
    for (int e = 0; e < kGridV; ++e) s += expf(x[e] - m);
  }
  // the block's pair: shuffles, then warp 0 over the warps' pairs
  const int warp = t / kWarp, lane = t % kWarp;
  for (int o = kWarp / 2; o > 0; o >>= 1)
    pair_merge(m, s, __shfl_xor_sync(0xffffffffu, m, o), __shfl_xor_sync(0xffffffffu, s, o));
  if (lane == 0) {
    red_m[warp] = m;
    red_s[warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = kGridThreads / kWarp;
    m = lane < nw ? red_m[lane] : -INFINITY;
    s = lane < nw ? red_s[lane] : 0.0f;
    for (int o = kWarp / 2; o > 0; o >>= 1)
      pair_merge(m, s, __shfl_xor_sync(0xffffffffu, m, o),
                 __shfl_xor_sync(0xffffffffu, s, o));
    if (lane == 0) {
      part[2LL * blockIdx.x] = m;
      part[2LL * blockIdx.x + 1] = s;
    }
  }
}

// Grid route, launch 2: the row's M and Z from its S partials, in the same
// order in every block, then p over the block's slice from lw'.
__global__ void __launch_bounds__(kGridThreads)
mwu_grid_norm_kernel(const float* __restrict__ part, int U, int S, int slice,
                     const float* __restrict__ out_lw, float* __restrict__ out_p,
                     float* __restrict__ out_m, float* __restrict__ out_s) {
  __shared__ float red[kWarp];
  const long long b = blockIdx.x / S;
  const int k = static_cast<int>(blockIdx.x % S), t = threadIdx.x;
  const float2* pr = reinterpret_cast<const float2*>(part) + b * S;
  float m = -INFINITY;
  for (int j = t; j < S; j += kGridThreads) m = fmaxf(m, pr[j].x);
  m = block_reduce<true>(m, red);  // exact: a max in any order
  float z = 0.0f;
  for (int j = t; j < S; j += kGridThreads) {
    const float2 q = pr[j];
    z += q.y * expf(q.x - m);
  }
  z = block_reduce<false>(z, red);
  const long long off = b * U;
  const int lo = k * slice, hi = min(U, lo + slice);
  for (int t0 = lo; t0 < hi; t0 += kGridTile) {
    float x[kGridV];
#pragma unroll
    for (int e = 0; e < kGridV; ++e) {
      const int i = t0 + e * kGridThreads + t;
      x[e] = i < hi ? out_lw[off + i] : 0.0f;
    }
#pragma unroll
    for (int e = 0; e < kGridV; ++e) {
      const int i = t0 + e * kGridThreads + t;
      if (i < hi) out_p[off + i] = expf(x[e] - m) / z;
    }
  }
  if (k == 0 && t == 0) {
    out_m[b] = m;
    out_s[b] = z;
  }
}

struct Args {
  const float* lw;
  const float* c;
  const long long* rows;
  int B, U;
  float coef;
  float *out_lw, *out_p, *out_m, *out_s;
  cudaStream_t st;
};

template <int V>
cudaError_t launch_warp(const Args& a) {
  mwu_warp_kernel<V><<<static_cast<unsigned>(rt::ceil_div(a.B, kWarpRows)),
                       kWarpRows * kWarp, 0, a.st>>>(a.lw, a.c, a.rows, a.B, a.U, a.coef,
                                                     a.out_lw, a.out_p, a.out_m, a.out_s);
  return cudaGetLastError();
}

template <int V>
cudaError_t launch_block(const Args& a) {
  mwu_block_kernel<V><<<static_cast<unsigned>(a.B), kBlockThreads, 0, a.st>>>(
      a.lw, a.c, a.rows, a.U, a.coef, a.out_lw, a.out_p, a.out_m, a.out_s);
  return cudaGetLastError();
}

// Values a lane (warp route) or a thread (block route): the least power of
// two that holds the row.
int values_per(int U, int threads) {
  int v = 1;
  while (v * threads < U) v <<= 1;
  return v;
}

}  // namespace

extern "C" int mwu_update_warp_u() { return kWarpU; }
extern "C" int mwu_update_block_u() { return kBlockU; }
extern "C" int mwu_update_grid_tile() { return kGridTile; }
extern "C" int mwu_update_grid_blocks_per_sm() { return kGridBlocksPerSm; }

// lw, out_lw, out_p: (B, U) f32; out_m, out_s: (B,) f32. `rows` null: c is
// (B, U), row b updates with c[b]; else c is an (n, U) table and row b
// updates with c[rows[b]] (int64 ids on the device). `route` and `S` are
// kernels/mwu_update/ops.py::plan's: route 0 (warp) needs U <= kWarpU and
// S = 1, route 1 (block) kWarpU < U <= kBlockU and S = 1, route 2 (grid)
// U > kBlockU, S blocks a row with slice = ceil(ceil(U / tile) / S) * tile
// and (S - 1) * slice < U (no block without values), and a `scratch` of
// 2 * B * S floats. Returns a cudaError_t code (0 on success). Launches on
// `stream` and does not synchronise.
extern "C" int mwu_update_launch(const float* lw, const float* c,
                                 const long long* rows, int B, int U, float coef,
                                 float* out_lw, float* out_p, float* out_m,
                                 float* out_s, int route, int S, float* scratch,
                                 void* stream) {
  if (B < 1 || U < 1 || S < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == kWarpRoute || route == kBlockRoute) {
    const bool warp = route == kWarpRoute;
    if (S != 1 || (warp ? U > kWarpU : (U <= kWarpU || U > kBlockU)))
      return static_cast<int>(cudaErrorInvalidValue);
    const Args a{lw, c, rows, B, U, coef, out_lw, out_p, out_m, out_s, st};
    switch (warp ? values_per(U, kWarp) : values_per(U, kBlockThreads)) {
      case 1: return static_cast<int>(launch_warp<1>(a));
      case 2: return static_cast<int>(warp ? launch_warp<2>(a) : launch_block<2>(a));
      case 4: return static_cast<int>(warp ? launch_warp<4>(a) : launch_block<4>(a));
      case 8: return static_cast<int>(warp ? launch_warp<8>(a) : launch_block<8>(a));
      case 16: return static_cast<int>(launch_warp<16>(a));
      case 32: return static_cast<int>(launch_warp<32>(a));
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (route != kGridRoute || U <= kBlockU || scratch == nullptr ||
      static_cast<long long>(B) * S > 0x7FFFFFFFll)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long slice = rt::ceil_div(rt::ceil_div(U, kGridTile), S) * kGridTile;
  if ((S - 1) * slice >= U) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(B * S);
  mwu_grid_partial_kernel<<<grid, kGridThreads, 0, st>>>(lw, c, rows, U, coef, S,
                                                         static_cast<int>(slice), out_lw,
                                                         scratch);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  mwu_grid_norm_kernel<<<grid, kGridThreads, 0, st>>>(scratch, U, S,
                                                      static_cast<int>(slice), out_lw,
                                                      out_p, out_m, out_s);
  return static_cast<int>(cudaGetLastError());
}
