// Mamba-2 SSD chunked scan on Hopper (kernel K9 of the port).
//
// Replaces the TPU kernel `_kernel` / `ssd_scan_pallas` of
// src/repro/kernels/ssd_scan/ssd_scan.py: the recurrence
//     h_t = exp(dt_t·A)·h_{t−1} + (dt_t·x_t) ⊗ B_t,   y_t = h_t·C_t
// over a sequence, in chunks of Q steps. Within a chunk it is a masked
// quadratic form; across chunks only the (P × N) state is carried. Per chunk,
// as at ssd_scan.py:30-56, all in f32:
//     cum     = cumsum(dt·A)                                (Q,)
//     W[i,j]  = (C_i·B_j)·exp(cum_i − cum_j)·dt_j,  j ≤ i   (Q × Q)
//     y       = W·x + exp(cum) ⊙ (C·stateᵀ)                 (Q × P)
//     state   = exp(cum_Q)·state + (x ⊙ exp(cum_Q − cum)·dt)ᵀ·B
// Unlike the TPU kernel, this one also writes the final state (B, H, P, N):
// the model's prefill hands it to decode.
//
// Work layout. One block of 256 threads per (batch, head) walks the chunks
// in order — the loop that replaces the TPU's sequential chunk axis, since
// Hopper blocks share nothing. The state lives in shared memory for the
// whole walk (64 × 128 f32 = 32 KB at mamba2-130m's widths) and reaches
// device memory once, at the end. Each chunk's x, dt, B and C tiles are
// staged in shared memory (rows past S load as zeros with dt = 0: the
// identity transition, so a ragged last chunk needs no padding in memory and
// leaves the final state unchanged); the four products run as register tiles
// of 16 × 16 threads over shared memory, row strides padded to odd lengths
// so a warp's reads fall in distinct banks.
//
// Bound on this card: operations. A chunk is ≈ 2·Q·(Q·N + Q·P + 2·P·N)
// flops against Q·(2P + 2N + 1) floats read, ≈ 30 flops a byte at Q = 64,
// P = 64, N = 128 — above the card's f32 CUDA-core balance, so the CUDA
// cores set the pace. At mamba2-130m's prefill the grid is only B·H blocks
// (4 × 24 = 96 on 132 SMs, one block an SM for its 133 KB of shared
// memory); splitting the sequence would need a second pass over the chunk
// states. Tensor cores (wgmma on the chunk products) are later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 16 × 16
constexpr int kMaxQ = 64, kMaxP = 128, kMaxN = 128;

// acc(m, n) = Σ_k A[m·sam + k·sak] · Bv[n·sbn + k·sbk] for the outputs
// m = ty + 16·i < M, n = tx + 16·j < N this thread owns.
template <int MI, int NJ>
__device__ __forceinline__ void tile_gemm(float (&acc)[MI][NJ], const float* A,
                                          int sam, int sak, const float* Bv, int sbn,
                                          int sbk, int M, int N, int K, int ty,
                                          int tx) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  for (int k = 0; k < K; ++k) {
    float av[MI], bv[NJ];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int m = ty + 16 * i;
      av[i] = m < M ? A[m * sam + k * sak] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = tx + 16 * j;
      bv[j] = n < N ? Bv[n * sbn + k * sbk] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, float* __restrict__ y,
                float* __restrict__ hT, int S, int H, int P, int N, int Q) {
  extern __shared__ float smem[];
  const int XS = P + 1, BS = N + 1, WS = Q + 1, SS = N + 1;
  float* xs = smem;             // (Q, XS)  x of the chunk
  float* Bs = xs + Q * XS;      // (Q, BS)
  float* Cs = Bs + Q * BS;      // (Q, BS)
  float* Ws = Cs + Q * BS;      // (Q, WS)
  float* st = Ws + Q * WS;      // (P, SS)  the carried state
  float* cum = st + P * SS;     // (Q,)
  float* dts = cum + Q;         // (Q,)

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const float a_h = A[h];
  for (int u = tid; u < P * SS; u += kThreads) st[u] = 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    __syncthreads();  // the previous chunk's tiles are no longer read
    for (int u = tid; u < Q * P; u += kThreads) {
      const int i = u / P, p = u % P, s = c0 + i;
      xs[i * XS + p] =
          s < S ? x[((static_cast<long long>(b) * S + s) * H + h) * P + p] : 0.f;
    }
    for (int u = tid; u < Q * N; u += kThreads) {
      const int i = u / N, n = u % N, s = c0 + i;
      const long long off = (static_cast<long long>(b) * S + s) * N + n;
      Bs[i * BS + n] = s < S ? Bm[off] : 0.f;
      Cs[i * BS + n] = s < S ? Cm[off] : 0.f;
    }
    for (int i = tid; i < Q; i += kThreads) {
      const int s = c0 + i;
      dts[i] = s < S ? dt[(static_cast<long long>(b) * S + s) * H + h] : 0.f;
    }
    __syncthreads();
    if (tid == 0) {  // inclusive cumsum of dt·A, in order
      float run = 0.f;
      for (int i = 0; i < Q; ++i) {
        run += dts[i] * a_h;
        cum[i] = run;
      }
    }
    __syncthreads();

    // W[i, j] = (C_i·B_j)·exp(cum_i − cum_j)·dt_j for j ≤ i
    {
      float sij[4][4];
      tile_gemm<4, 4>(sij, Cs, BS, 1, Bs, BS, 1, Q, Q, N, ty, tx);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = ty + 16 * ii;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = tx + 16 * jj;
          if (i < Q && j < Q)
            Ws[i * WS + j] = j <= i ? sij[ii][jj] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
        }
      }
    }
    __syncthreads();

    // y = W·x + exp(cum) ⊙ (C·stateᵀ)
    {
      float yi[4][8], ye[4][8];
      tile_gemm<4, 8>(yi, Ws, WS, 1, xs, 1, XS, Q, P, Q, ty, tx);
      tile_gemm<4, 8>(ye, Cs, BS, 1, st, SS, 1, Q, P, N, ty, tx);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = ty + 16 * ii, s = c0 + i;
        if (i >= Q || s >= S) continue;
        const float e = expf(cum[i]);
        float* yrow = y + ((static_cast<long long>(b) * S + s) * H + h) * P;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int p = tx + 16 * jj;
          if (p < P) yrow[p] = yi[ii][jj] + e * ye[ii][jj];
        }
      }
    }
    __syncthreads();  // the state and x are read; now scale x, then update

    const float cum_last = cum[Q - 1];
    for (int u = tid; u < Q * P; u += kThreads) {
      const int i = u / P, p = u % P;
      xs[i * XS + p] *= expf(cum_last - cum[i]) * dts[i];
    }
    __syncthreads();
    {
      float upd[8][8];
      tile_gemm<8, 8>(upd, xs, 1, XS, Bs, 1, BS, P, N, Q, ty, tx);
      const float g_last = expf(cum_last);
#pragma unroll
      for (int ii = 0; ii < 8; ++ii) {
        const int p = ty + 16 * ii;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int n = tx + 16 * jj;
          if (p < P && n < N) st[p * SS + n] = g_last * st[p * SS + n] + upd[ii][jj];
        }
      }
    }
  }
  __syncthreads();
  float* out = hT + (static_cast<long long>(b) * H + h) * P * N;
  for (int u = tid; u < P * N; u += kThreads) out[u] = st[(u / N) * SS + u % N];
}

size_t smem_bytes(int P, int N, int Q) {
  return sizeof(float) * (static_cast<size_t>(Q) * (P + 1) + 2 * Q * (N + 1) +
                          Q * (Q + 1) + P * (N + 1) + 2 * Q);
}

}  // namespace

// x (B, S, H, P), dt (B, S, H), A (H,), Bm / Cm (B, S, N) → y (B, S, H, P) and
// the final state hT (B, H, P, N); all f32, contiguous. Q ≤ 64, P ≤ 128,
// N ≤ 128. Returns a cudaError_t code (0 on success); launches on `stream`
// and does not synchronise.
extern "C" int ssd_scan_launch(const float* x, const float* dt, const float* A,
                               const float* Bm, const float* Cm, float* y, float* hT,
                               int B, int S, int H, int P, int N, int Q, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || Q <= 0 || Q > kMaxQ ||
      P > kMaxP || N > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(P, N, Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(H), static_cast<unsigned>(B));
  ssd_scan_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, dt, A, Bm, Cm, y, hT, S, H, P, N, Q);
  return static_cast<int>(cudaGetLastError());
}
