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
// Bound on this card: operations, ≈ 30 flops a byte read at mamba2-130m's
// Q = 64, P = 64, N = 128, above the card's f32 CUDA-core balance. Row p of
// the state depends only on column p of x, and B and C are shared by every
// head (the reference's G = 1), so the work splits two ways with no
// communication, in two launches; kernels/ssd_scan/ops.py::plan(B, S, H, P,
// N, Q, sms) picks the split and the launch function checks the same limits:
// * launch 1 (`ssd_cb_kernel`, a block a (chunk, batch, 16 rows)): CB =
//   C_c·B_cᵀ (Q × Q) once a chunk into a scratch the wrapper allocates (655
//   KB at the prefill's shape, which stays in L2), not once a head;
// * launch 2 (`ssd_chunk_kernel`, grid (P / Ps slices, H, B)): a block owns
//   Ps rows of one head's state, keeps them in registers for the whole walk
//   and walks the chunks in order. Per chunk one warp scans dt·A into cum
//   in order (scaled by log2 e, so exponentials are exp2); all eight warps
//   then make W from CB in place (the same arithmetic in every slice of a
//   head), y's Ps columns, W·x + exp(cum) ⊙ (C·stateᵀ), as register tiles
//   of 2 rows × Ps/8 columns a lane, x ⊙ w in place, and the state update
//   (x ⊙ w)ᵀ·B as tiles of Ps/8 rows × 4 states a lane. Tiles are read as
//   16-byte vectors along the summed axis, the next step's operands loaded
//   while this step's products run, row strides padded by 4 floats so a
//   warp's reads fall in distinct banks. FULL compiles the real shape's
//   Q = 64 and N = 128 in, so those loops unroll and copies index by
//   shifts. Ps = 32 (192 blocks at the prefill's shape, 110 KB of shared
//   memory each, two fit an SM); 16-row slices (384 blocks) measured
//   slower, since each slice re-reads the chunk's B, C and CB from L2. The
//   next chunk's CB and C come in by cp.async while the state update runs
//   (only y reads them), and its B while the next cum, W and y run; its x
//   slice and dt (small) follow the update. So each tile has one buffer.
// Rows past S load as zeros with dt = 0: the identity transition, so a
// ragged last chunk needs no padding in memory and leaves the final state
// unchanged. Arithmetic is f32 on the CUDA cores, with no TF32: the scan is
// held to 2e-4 of its plain version, and TF32 keeps about three decimal
// digits. Every sum runs in a fixed order and no atomics are used, so two
// calls agree bit for bit.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / rt::kWarp;
constexpr int kMaxQ = 64, kMaxP = 128, kMaxN = 128;
constexpr int kPs = 32;  // state rows a block owns (ops.py::PS)
constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = exp2(x·log2 e)

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// Loads of one column of 4 floats (16 bytes) of a row whose first `avail`
// floats exist: one 16-byte copy when `vec` (aligned, whole units), else four
// 4-byte copies; a zero fill past `avail` or for a row that is not there.
__device__ __forceinline__ void copy4(float* dst, const float* src, int avail, int vec,
                                      const float* base) {
  if (vec) {
    rt::cp_async16(dst, avail > 0 ? src : base, avail > 0 ? 16 : 0);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      rt::cp_async4(dst + e, e < avail ? src + e : base, e < avail ? 4 : 0);
  }
}

// Launch 1: cb[b, c, i, j] = Σ_n C[c·Q + i, n]·B[c·Q + j, n] for i < Q and
// j < QP = round4(Q) (0 past Q), summed in n order. Block (c, b, z) takes
// rows i = 16z … 16z + 15; thread (ti, tj) row 16z + ti, columns tj + 16e.
__global__ void __launch_bounds__(kThreads)
ssd_cb_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm,
              float* __restrict__ cb, int S, int N, int Q, int vn) {
  extern __shared__ __align__(16) float smem[];
  const int NP = round4(N), RS = NP + 4, QP = round4(Q);
  const int c = blockIdx.x, b = blockIdx.y, i0 = 16 * blockIdx.z, nc = gridDim.x;
  if (i0 >= Q) return;
  float* Bs = smem;         // (Q, RS): every row of the chunk
  float* Cs = Bs + Q * RS;  // (16, RS): the block's rows
  const int tid = threadIdx.x, rows = min(16, Q - i0);
  const long long r0 = static_cast<long long>(b) * S + static_cast<long long>(c) * Q;
  for (int u = tid; u < (Q + rows) * (NP / 4); u += kThreads) {
    const int i = u / (NP / 4), n = 4 * (u % (NP / 4));
    const bool is_b = i < Q;
    const int row = is_b ? i : i0 + i - Q;  // row of the chunk
    const float* src = (is_b ? Bm : Cm) + (r0 + row) * N + n;
    copy4((is_b ? Bs + i * RS : Cs + (i - Q) * RS) + n, src,
          c * Q + row < S ? min(4, N - n) : 0, vn, Bm);
  }
  rt::cp_async_commit();
  rt::cp_async_wait<0>();
  __syncthreads();
  const int ti = tid / 16, tj = tid % 16;
  const float* crow = Cs + min(ti, rows - 1) * RS;
  float acc[4] = {};
  for (int n = 0; n < NP; n += 4) {
    const float4 cv = *reinterpret_cast<const float4*>(crow + n);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float4 bv =
          *reinterpret_cast<const float4*>(Bs + min(tj + 16 * e, Q - 1) * RS + n);
      float t = fmaf(cv.x, bv.x, acc[e]);
      t = fmaf(cv.y, bv.y, t);
      t = fmaf(cv.z, bv.z, t);
      acc[e] = fmaf(cv.w, bv.w, t);
    }
  }
  if (ti >= rows) return;
  float* out = cb + ((static_cast<long long>(b) * nc + c) * Q + i0 + ti) * QP;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int j = tj + 16 * e;
    if (j < QP) out[j] = j < Q ? acc[e] : 0.0f;
  }
}

// Launch 2's shared memory in floats: C (Q, NP + 4), B (Q, NP), CB and then
// W (Q, QP + 4), x (QP, Ps), the state (Ps, NP + 4), and cum·log2 e,
// w = exp(cum_Q − cum)·dt and dt (QP each).
__host__ __device__ inline int chunk_smem_floats(int ps, int N, int Q) {
  const int NP = round4(N), QP = round4(Q);
  return Q * (NP + 4) + Q * NP + Q * (QP + 4) + QP * ps + ps * (NP + 4) + 3 * QP;
}

// R consecutive floats of shared memory (16-byte aligned for R = 4, 8-byte
// for R = 2).
template <int R>
__device__ __forceinline__ void load_row(const float* p, float (&v)[R]) {
  if constexpr (R == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else if constexpr (R == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = p[0];
  }
}

// Launch 2; see the note at the top of the file. Block (slice, h, b) owns
// state rows p0 = slice·kPs … p0 + kPs − 1 of head h in batch b. FULL: Q = 64
// and N = 128, compiled in, so loops unroll and copies index by shifts.
// `vx`: x rows and the slices are 16-byte aligned (P % 4 == 0); `vn`: so
// are B's and C's rows (N % 4 == 0).
template <bool FULL>
__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ Bm,
                 const float* __restrict__ Cm, const float* __restrict__ cb,
                 float* __restrict__ y, float* __restrict__ hT, int S, int H, int P,
                 int Nr, int Qr, int vx, int vn) {
  constexpr int PS = kPs, RP = PS / 8;  // a lane's y columns and its state rows
  extern __shared__ __align__(16) float smem[];
  const int Q = FULL ? kMaxQ : Qr, N = FULL ? kMaxN : Nr;
  const int NP = FULL ? kMaxN : round4(N), RS = NP + 4;
  const int QP = FULL ? kMaxQ : round4(Q), WS = QP + 4;
  float* Cs = smem;            // (Q, RS)
  float* Bs = Cs + Q * RS;     // (Q, NP)
  float* Ws = Bs + Q * NP;     // (Q, WS): CB, then W in place
  float* xs = Ws + Q * WS;     // (QP, PS): rows past Q are zeros
  float* sts = xs + QP * PS;   // (PS, RS): the state, for C·stateᵀ
  float* cum = sts + PS * RS;  // (QP,): cum·log2 e
  float* wj = cum + QP;        // (QP,): exp(cum_Q − cum)·dt
  float* dts = wj + QP;        // (QP,)

  const int p0 = blockIdx.x * PS, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / rt::kWarp, lane = tid % rt::kWarp;
  const int nc = (S + Q - 1) / Q;
  const float a2 = __ldg(A + h) * kLog2e;
  const long long bs0 = static_cast<long long>(b) * S;

  // group A: the chunk's CB and C (read by y only); group X: its x slice and
  // dt; group B: its B (read by the state update only).
  auto issue_a = [&](int c) {
    const float* cbc = cb + (static_cast<long long>(b) * nc + c) * Q * QP;
    for (int u = tid; u < Q * (QP / 4); u += kThreads) {
      const int i = u / (QP / 4), j = 4 * (u % (QP / 4));
      rt::cp_async16(Ws + i * WS + j, cbc + i * QP + j, 16);
    }
    for (int u = tid; u < Q * (NP / 4); u += kThreads) {
      const int i = u / (NP / 4), n = 4 * (u % (NP / 4)), s = c * Q + i;
      copy4(Cs + i * RS + n, Cm + (bs0 + s) * N + n, s < S ? min(4, N - n) : 0, vn, Cm);
    }
  };
  auto issue_x = [&](int c) {
    for (int u = tid; u < QP * (PS / 4); u += kThreads) {
      const int i = u / (PS / 4), p = 4 * (u % (PS / 4)), s = c * Q + i;
      copy4(xs + i * PS + p, x + ((bs0 + s) * H + h) * P + p0 + p,
            i < Q && s < S ? min(4, P - p0 - p) : 0, vx, x);
    }
    for (int i = tid; i < QP; i += kThreads) {
      const int s = c * Q + i;
      const bool row = i < Q && s < S;
      rt::cp_async4(dts + i, row ? dt + (bs0 + s) * H + h : dt, row ? 4 : 0);
    }
  };
  auto issue_b = [&](int c) {
    for (int u = tid; u < Q * (NP / 4); u += kThreads) {
      const int i = u / (NP / 4), n = 4 * (u % (NP / 4)), s = c * Q + i;
      copy4(Bs + i * NP + n, Bm + (bs0 + s) * N + n, s < S ? min(4, N - n) : 0, vn, Bm);
    }
  };

  // y tile: lane (yi, yp) of warp w holds rows 16(w & 3) + yi + 8r (r < 2)
  // and columns q0 + s (s < RP), q0 = (w >> 2)·PS/2 + yp·RP.
  const int wi = warp & 3;
  const int i_r[2] = {16 * wi + (lane & 7), 16 * wi + (lane & 7) + 8};
  const int q0 = (warp >> 2) * (PS / 2) + (lane >> 3) * RP;
  const int jmax = min(QP, 16 * wi + 16);  // W[i, j] = 0 for j > i
  // state tile: lane (sp, nq) of warp w holds rows sp·RP + r (r < RP) and
  // states n0 … n0 + 3, n0 = 16w + 4nq.
  const int sp = lane & 7, n0 = 16 * warp + 4 * (lane >> 3);
  const bool s_on = n0 < NP;
  float st[RP][4] = {};
  for (int u = tid; u < PS * RS; u += kThreads) sts[u] = 0.0f;

  issue_a(0);
  rt::cp_async_commit();
  issue_x(0);
  rt::cp_async_commit();
  issue_b(0);
  rt::cp_async_commit();
  for (int c = 0; c < nc; ++c) {
    rt::cp_async_wait<1>();  // groups A and X of chunk c (B may be in flight)
    __syncthreads();
    if (warp == 0) {  // cum: inclusive scan of dt·A in order, two steps a lane
      const int i = 2 * lane;
      const float v0 = i < Q ? dts[i] * a2 : 0.0f;
      const float v1 = i + 1 < Q ? dts[i + 1] * a2 : 0.0f;
      float inc = v0 + v1;
      for (int o = 1; o < rt::kWarp; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += t;
      }
      const float c0v = (inc - (v0 + v1)) + v0;
      if (i < QP) cum[i] = c0v;
      if (i + 1 < QP) cum[i + 1] = c0v + v1;
    }
    __syncthreads();
    const float cum_last = cum[Q - 1];
    if (tid < QP) wj[tid] = tid < Q ? exp2f(cum_last - cum[tid]) * dts[tid] : 0.0f;
    {  // W from CB, in place: thread t takes row t / 4, columns t % 4 + 4m
      const int i = tid / 4;
      if (i < Q) {
        const float ci = cum[i];
        float* wr = Ws + i * WS;
#pragma unroll
        for (int j = tid % 4; j < QP; j += 4)
          wr[j] = j <= i ? wr[j] * exp2f(ci - cum[j]) * dts[j] : 0.0f;
      }
    }
    __syncthreads();

    {  // y = W·x + exp(cum) ⊙ (C·stateᵀ) on the lane's 2 × RP tile
      float yi[2][RP] = {}, ye[2][RP] = {};
      const float* w0r = Ws + min(i_r[0], Q - 1) * WS;
      const float* w1r = Ws + min(i_r[1], Q - 1) * WS;
#pragma unroll
      for (int j = 0; j < QP; j += 4) {
        if (j >= jmax) break;
        const float4 w0 = *reinterpret_cast<const float4*>(w0r + j);
        const float4 w1 = *reinterpret_cast<const float4*>(w1r + j);
        const float wv0[4] = {w0.x, w0.y, w0.z, w0.w}, wv1[4] = {w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float xr[RP];
          load_row<RP>(xs + (j + jj) * PS + q0, xr);
#pragma unroll
          for (int s = 0; s < RP; ++s) {
            yi[0][s] = fmaf(wv0[jj], xr[s], yi[0][s]);
            yi[1][s] = fmaf(wv1[jj], xr[s], yi[1][s]);
          }
        }
      }
      const float* c0r = Cs + min(i_r[0], Q - 1) * RS;
      const float* c1r = Cs + min(i_r[1], Q - 1) * RS;
      const float* st_r[RP];
#pragma unroll
      for (int s = 0; s < RP; ++s) st_r[s] = sts + (q0 + s) * RS;
      // software-pipelined: the next step's operands load while this one's
      // products run
      float4 c0 = *reinterpret_cast<const float4*>(c0r);
      float4 c1 = *reinterpret_cast<const float4*>(c1r);
      float4 v[RP];
#pragma unroll
      for (int s = 0; s < RP; ++s) v[s] = *reinterpret_cast<const float4*>(st_r[s]);
#pragma unroll 2
      for (int n = 0; n < NP; n += 4) {
        const int nn = n + 4 < NP ? n + 4 : n;
        const float4 c0n = *reinterpret_cast<const float4*>(c0r + nn);
        const float4 c1n = *reinterpret_cast<const float4*>(c1r + nn);
        float4 vn[RP];
#pragma unroll
        for (int s = 0; s < RP; ++s)
          vn[s] = *reinterpret_cast<const float4*>(st_r[s] + nn);
#pragma unroll
        for (int s = 0; s < RP; ++s) {
          float t0 = fmaf(c0.x, v[s].x, ye[0][s]), t1 = fmaf(c1.x, v[s].x, ye[1][s]);
          t0 = fmaf(c0.y, v[s].y, t0);
          t1 = fmaf(c1.y, v[s].y, t1);
          t0 = fmaf(c0.z, v[s].z, t0);
          t1 = fmaf(c1.z, v[s].z, t1);
          ye[0][s] = fmaf(c0.w, v[s].w, t0);
          ye[1][s] = fmaf(c1.w, v[s].w, t1);
        }
        c0 = c0n;
        c1 = c1n;
#pragma unroll
        for (int s = 0; s < RP; ++s) v[s] = vn[s];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i_r[r], s_t = c * Q + i;
        if (i >= Q || s_t >= S) continue;
        const float e = exp2f(cum[i]);
        float* yrow = y + ((bs0 + s_t) * H + h) * P + p0 + q0;
#pragma unroll
        for (int s = 0; s < RP; ++s)
          if (p0 + q0 + s < P) yrow[s] = yi[r][s] + e * ye[r][s];
      }
    }
    __syncthreads();  // CB, W, C, x and the state are read
    if (c + 1 < nc) issue_a(c + 1);
    rt::cp_async_commit();
    for (int u = tid; u < Q * PS; u += kThreads) xs[u] *= wj[u / PS];  // x ⊙ w
    rt::cp_async_wait<1>();  // group B of chunk c
    __syncthreads();

    // state = exp(cum_Q)·state + (x ⊙ w)ᵀ·B on the lane's RP × 4 tile,
    // software-pipelined as y is
    if (s_on) {
      float upd[RP][4] = {};
      const float* xrow = xs + sp * RP;
      const float* brow = Bs + n0;
      float xv[RP];
      load_row<RP>(xrow, xv);
      float4 bv = *reinterpret_cast<const float4*>(brow);
#pragma unroll 4
      for (int i = 0; i < Q; ++i) {
        const int in = i + 1 < Q ? i + 1 : i;
        float xn[RP];
        load_row<RP>(xrow + in * PS, xn);
        const float4 bn = *reinterpret_cast<const float4*>(brow + in * NP);
#pragma unroll
        for (int r = 0; r < RP; ++r) {
          upd[r][0] = fmaf(xv[r], bv.x, upd[r][0]);
          upd[r][1] = fmaf(xv[r], bv.y, upd[r][1]);
          upd[r][2] = fmaf(xv[r], bv.z, upd[r][2]);
          upd[r][3] = fmaf(xv[r], bv.w, upd[r][3]);
        }
#pragma unroll
        for (int r = 0; r < RP; ++r) xv[r] = xn[r];
        bv = bn;
      }
      const float g = exp2f(cum_last);
#pragma unroll
      for (int r = 0; r < RP; ++r) {
#pragma unroll
        for (int e = 0; e < 4; ++e) st[r][e] = g * st[r][e] + upd[r][e];
        *reinterpret_cast<float4*>(sts + (sp * RP + r) * RS + n0) =
            make_float4(st[r][0], st[r][1], st[r][2], st[r][3]);
      }
    }
    __syncthreads();  // x, dt, w and B are read; the state is written
    if (c + 1 < nc) {
      issue_x(c + 1);
      rt::cp_async_commit();
      issue_b(c + 1);
    } else {
      rt::cp_async_commit();
    }
    rt::cp_async_commit();
  }
  rt::cp_async_wait<0>();
  if (!s_on) return;
#pragma unroll
  for (int r = 0; r < RP; ++r) {
    const int p = p0 + sp * RP + r;
    if (p >= P) continue;
    float* out = hT + ((static_cast<long long>(b) * H + h) * P + p) * N;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (n0 + e < N) out[n0 + e] = st[r][e];
  }
}

template <bool FULL>
cudaError_t launch_chunks(dim3 grid, size_t smem, cudaStream_t st, const float* x,
                          const float* dt, const float* A, const float* Bm,
                          const float* Cm, const float* cb, float* y, float* hT, int S,
                          int H, int P, int N, int Q, int vx, int vn) {
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_kernel<FULL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ssd_chunk_kernel<FULL><<<grid, kThreads, smem, st>>>(x, dt, A, Bm, Cm, cb, y, hT, S, H,
                                                       P, N, Q, vx, vn);
  return cudaGetLastError();
}

}  // namespace

// Launch 2's shared memory in bytes for a slice of ps rows.
extern "C" long long ssd_scan_smem_bytes(int ps, int N, int Q) {
  return static_cast<long long>(sizeof(float)) * chunk_smem_floats(ps, N, Q);
}

// x (B, S, H, P), dt (B, S, H), A (H,), Bm / Cm (B, S, N) → y (B, S, H, P) and
// the final state hT (B, H, P, N); all f32, contiguous. Q ≤ 64, P ≤ 128,
// N ≤ 128; `ps` is kernels/ssd_scan/ops.py::plan's slice, which must be 32; `cb` is a
// scratch of B · ceil(S / Q) · Q · round4(Q) floats. Returns a cudaError_t
// code (0 on success); launches on `stream` and does not synchronise.
extern "C" int ssd_scan_launch(const float* x, const float* dt, const float* A,
                               const float* Bm, const float* Cm, float* y, float* hT,
                               float* cb, int B, int S, int H, int P, int N, int Q, int ps,
                               void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || Q <= 0 || Q > kMaxQ ||
      P > kMaxP || N > kMaxN || ps != kPs)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nc = (S + Q - 1) / Q;
  const int vx = P % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vn = N % 4 == 0 && reinterpret_cast<uintptr_t>(Bm) % 16 == 0 &&
                 reinterpret_cast<uintptr_t>(Cm) % 16 == 0;
  const size_t cb_smem = sizeof(float) * (Q + 16) * (round4(N) + 4);
  cudaError_t err = cudaFuncSetAttribute(ssd_cb_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(cb_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_cb_kernel<<<dim3(nc, B, (Q + 15) / 16), kThreads, cb_smem, st>>>(Bm, Cm, cb, S, N, Q,
                                                                       vn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((P + ps - 1) / ps, H, B);
  const size_t smem = sizeof(float) * chunk_smem_floats(ps, N, Q);
  err = Q == kMaxQ && N == kMaxN
            ? launch_chunks<true>(grid, smem, st, x, dt, A, Bm, Cm, cb, y, hT, S, H, P, N,
                                  Q, vx, vn)
            : launch_chunks<false>(grid, smem, st, x, dt, A, Bm, Cm, cb, y, hT, S, H, P, N,
                                   Q, vx, vn);
  return static_cast<int>(err);
}
