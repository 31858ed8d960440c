// GQA flash-attention forward on Hopper (kernel K8 of the port).
//
// Replaces the TPU kernel `_kernel` / `flash_attention_pallas` of
// src/repro/kernels/flash_attention/flash_attention.py: softmax(q·kᵀ·scale)·v
// with an online softmax over kv tiles, so the (Sq × Skv) logits never reach
// device memory. Masks full | causal | window | chunk, a `q_offset` (row i
// sits at global position q_offset + i; decode passes the cache position),
// an optional logit softcap. q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D), f32 or
// bf16; scores, statistics and the accumulator in f32; out in q's type. A
// row that sees no key gives 0, as the reference's oracle does.
//
// Work layout. A block owns one (batch, kv head) and a tile of BQ "rows" of
// that kv head's query group, numbered position-major: row ρ is query
// position ρ / g of query head kv_head·g + ρ % g (g = Hq / Hkv). So the
// group's g heads share every K/V tile a block loads (GQA without repeating
// K/V), a tile's rows span a contiguous range of positions (the tile-level
// mask below is exact), and one decode token of g heads is one tile of g
// rows. The block walks its kv tiles in order — the loop that replaces the
// TPU's sequential grid axis — keeping the running max m, sum l and the
// (BQ × D) accumulator in registers. Tiles no row of the block can see are
// never visited: the causal reach ends the walk at the block's last
// position, a window or chunk starts it at the first key the block's first
// position may see (the reasoning of flash_attention.py:44-56, as a range).
// Ragged Sq, Skv and D are masked in the kernel; nothing is padded in
// memory.
//
// Two tile heights: BQ = 64 rows (prefill) and BQ = 16 rows (decode and
// other short queries, g·Sq ≤ 16). When the (row tile × kv head × batch)
// grid alone would leave SMs idle — a decode step has B·Hkv blocks — the kv
// range is split over `nsplit` blocks that write (m, l, acc) partials, and
// a second kernel combines them (flash-decoding).
//
// Bound on this card. Prefill is operations: 4·Sq·Skv·D flops a head
// (halved by the causal mask) against Sq·D + 2·Skv·D elements. This kernel
// runs them on the CUDA cores in f32 from shared memory (register tiles of
// 4 × 8 scores and 4 × D/8 outputs a thread), not on the tensor cores; a
// wgmma/TMA version is later work. Decode is bytes: each K/V element is read
// once for g·Sq rows; the split keeps enough blocks in flight to stream it.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // 16 row groups × 8 column groups
constexpr int kBKV = 64;       // keys a tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Eight consecutive elements of a row as f32 (d0 + 8 ≤ D when `vec`).
template <typename T>
__device__ __forceinline__ void load8(const T* __restrict__ row, int d0, int D,
                                      bool vec, float* out);

template <>
__device__ __forceinline__ void load8<float>(const float* __restrict__ row, int d0,
                                             int D, bool vec, float* out) {
  if (vec) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(row + d0));
    const float4 b = __ldg(reinterpret_cast<const float4*>(row + d0) + 1);
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) out[e] = d0 + e < D ? __ldg(row + d0 + e) : 0.f;
  }
}

template <>
__device__ __forceinline__ void load8<__nv_bfloat16>(const __nv_bfloat16* __restrict__ row,
                                                     int d0, int D, bool vec, float* out) {
  if (vec) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(row + d0));
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
    for (int e = 0; e < 8; ++e) out[e] = __bfloat162float(h[e]);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      out[e] = d0 + e < D ? __bfloat162float(row[d0 + e]) : 0.f;
  }
}

struct Args {
  int B, Hq, Hkv, Sq, Skv, D, g, rows;
  int mode, window, q_offset, nsplit;
  float scale, softcap;
  int vec;
};

// Whether key position kp is visible from query position qp.
__device__ __forceinline__ bool visible(int mode, int window, int qp, int kp) {
  if (mode == 0) return true;                                 // full
  if (kp > qp) return false;                                  // causal reach
  if (mode == 2) return kp > qp - window;                     // window
  if (mode == 3) return (kp / window) == (qp / window);       // chunk
  return true;                                                // causal
}

template <typename T, int RPT, int NC>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       float* __restrict__ part, Args a) {
  constexpr int BQ = 16 * RPT;
  constexpr int DP = 8 * NC;         // D padded to a multiple of 8
  constexpr int QS = DP + 1, KS = DP + 1, VS = DP, PS = kBKV + 1;
  extern __shared__ float smem[];
  float* Qs = smem;                  // (BQ, QS) q·scale
  float* Ks = Qs + BQ * QS;          // (kBKV, KS)
  float* Vs = Ks + kBKV * KS;        // (kBKV, VS)
  float* Ps = Vs + kBKV * VS;        // (BQ, PS) probabilities of the tile

  const int tid = threadIdx.x, tr = tid / 8, tc = tid % 8;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z / a.nsplit, split = blockIdx.z % a.nsplit;
  const int rho0 = blockIdx.x * BQ;
  const int rho_last = min(rho0 + BQ, a.rows) - 1;
  const T* kb = k + (static_cast<long long>(b) * a.Hkv + kvh) * a.Skv * a.D;
  const T* vb = v + (static_cast<long long>(b) * a.Hkv + kvh) * a.Skv * a.D;

  // ---- the block's query rows, scaled, into shared memory
  for (int u = tid; u < BQ * NC; u += kThreads) {
    const int r = u / NC, d0 = (u % NC) * 8, rho = rho0 + r;
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (rho < a.rows && d0 < a.D) {
      const int h = kvh * a.g + rho % a.g, i = rho / a.g;
      load8<T>(q + ((static_cast<long long>(b) * a.Hq + h) * a.Sq + i) * a.D, d0,
               a.D, a.vec, x);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) Qs[r * QS + d0 + e] = x[e] * a.scale;
  }

  // ---- the kv tiles some row of this block can see, and this split's part
  const int first_q = a.q_offset + rho0 / a.g;
  const int last_q = a.q_offset + rho_last / a.g;
  int lo = 0, hi = a.Skv;
  if (a.mode != 0) hi = min(hi, last_q + 1);
  if (a.mode == 2) lo = max(0, first_q - a.window + 1);
  if (a.mode == 3) lo = max(0, (first_q / a.window) * a.window);
  int t_lo = lo / kBKV, t_hi = hi > lo ? (hi + kBKV - 1) / kBKV : t_lo;
  const int per = (t_hi - t_lo + a.nsplit - 1) / a.nsplit;
  t_lo = min(t_hi, t_lo + split * per);
  t_hi = min(t_hi, t_lo + per);

  // per-thread rows r = tr + 16·i, columns c = tc + 8·j (scores) and
  // d = tc + 8·n (output)
  int qpos[RPT];
  bool row_ok[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int rho = rho0 + tr + 16 * i;
    row_ok[i] = rho < a.rows;
    qpos[i] = a.q_offset + rho / a.g;
  }
  float m[RPT], l[RPT], acc[RPT][NC];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = 0.f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int kv0 = t * kBKV;
    __syncthreads();  // the previous tile's Ks/Vs/Ps are no longer read
    for (int u = tid; u < kBKV * NC; u += kThreads) {
      const int c = u / NC, d0 = (u % NC) * 8, kp = kv0 + c;
      float xk[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float xv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (kp < a.Skv && d0 < a.D) {
        load8<T>(kb + static_cast<long long>(kp) * a.D, d0, a.D, a.vec, xk);
        load8<T>(vb + static_cast<long long>(kp) * a.D, d0, a.D, a.vec, xv);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        Ks[c * KS + d0 + e] = xk[e];
        Vs[c * VS + d0 + e] = xv[e];
      }
    }
    __syncthreads();

    float s[RPT][8];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float qv[RPT], kv[8];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = Qs[(tr + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = Ks[(tc + 8 * j) * KS + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      bool ok[8];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kp = kv0 + tc + 8 * j;
        ok[j] = row_ok[i] && kp < a.Skv && visible(a.mode, a.window, qpos[i], kp);
        float x = s[i][j];
        if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
        s[i][j] = ok[j] ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        Ps[(tr + 16 * i) * PS + tc + 8 * j] = p;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < NC; ++n) acc[i][n] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBKV; ++j) {
      float pv[RPT], vv[NC];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = Ps[(tr + 16 * i) * PS + j];
#pragma unroll
      for (int n = 0; n < NC; ++n) vv[n] = Vs[j * VS + tc + 8 * n];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int n = 0; n < NC; ++n) acc[i][n] = fmaf(pv[i], vv[n], acc[i][n]);
    }
  }

  // ---- emit: the normalised rows, or this split's partials
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    if (!row_ok[i]) continue;
    const int rho = rho0 + tr + 16 * i;
    if (a.nsplit == 1) {
      const int h = kvh * a.g + rho % a.g, qi = rho / a.g;
      T* orow = o + ((static_cast<long long>(b) * a.Hq + h) * a.Sq + qi) * a.D;
      const float inv_den = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const int d = tc + 8 * n;
        if (d < a.D) store_as(orow + d, acc[i][n] * inv_den);
      }
    } else {
      // partial row: [m, l, acc[0..DP)] at ((b·nsplit + split)·Hkv + kvh)·rows + ρ
      float* prow = part + ((static_cast<long long>(blockIdx.z) * a.Hkv + kvh) *
                                a.rows + rho) * (DP + 2);
      if (tc == 0) {
        prow[0] = m[i];
        prow[1] = l[i];
      }
#pragma unroll
      for (int n = 0; n < NC; ++n) prow[2 + tc + 8 * n] = acc[i][n];
    }
  }
}

// One thread per (batch, kv head, row, d): merge the nsplit partials.
template <typename T>
__global__ void flash_attention_combine_kernel(const float* __restrict__ part,
                                               T* __restrict__ o, Args a, int DP) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long total = static_cast<long long>(a.B) * a.Hkv * a.rows * a.D;
  if (idx >= total) return;
  const int d = static_cast<int>(idx % a.D);
  long long r = idx / a.D;
  const int rho = static_cast<int>(r % a.rows);
  r /= a.rows;
  const int kvh = static_cast<int>(r % a.Hkv);
  const int b = static_cast<int>(r / a.Hkv);
  const long long lane = static_cast<long long>(a.Hkv) * a.rows * (DP + 2);
  const float* p0 = part + ((static_cast<long long>(b) * a.nsplit * a.Hkv + kvh) *
                                a.rows + rho) * (DP + 2);
  float M = kNegInf;
  for (int s = 0; s < a.nsplit; ++s) M = fmaxf(M, p0[s * lane]);
  float L = 0.f, A = 0.f;
  for (int s = 0; s < a.nsplit; ++s) {
    const float* p = p0 + s * lane;
    const float w = expf(p[0] - M);
    L += p[1] * w;
    A += p[2 + d] * w;
  }
  const int h = kvh * a.g + rho % a.g, qi = rho / a.g;
  store_as(o + ((static_cast<long long>(b) * a.Hq + h) * a.Sq + qi) * a.D + d,
           A / fmaxf(L, 1e-30f));
}

template <typename T, int RPT, int NC>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* part,
                   const Args& a, cudaStream_t st) {
  constexpr int BQ = 16 * RPT, DP = 8 * NC;
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(BQ) * (DP + 1) + kBKV * (DP + 1) + kBKV * DP +
       BQ * (kBKV + 1));
  auto kern = flash_attention_kernel<T, RPT, NC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(rt::ceil_div(a.rows, BQ)),
                  static_cast<unsigned>(a.Hkv),
                  static_cast<unsigned>(a.B * a.nsplit));
  kern<<<grid, kThreads, smem, st>>>(static_cast<const T*>(q),
                                     static_cast<const T*>(k),
                                     static_cast<const T*>(v), static_cast<T*>(o),
                                     part, a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.nsplit == 1) return err;
  const long long total = static_cast<long long>(a.B) * a.Hkv * a.rows * a.D;
  flash_attention_combine_kernel<T><<<static_cast<unsigned>(rt::ceil_div(total, 256)),
                                      256, 0, st>>>(part, static_cast<T*>(o), a, DP);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int bq, int dp, const void* q, const void* k, const void* v,
                     void* o, float* part, const Args& a, cudaStream_t st) {
  if (bq == 64) {
    if (dp == 32) return launch<T, 4, 4>(q, k, v, o, part, a, st);
    if (dp == 64) return launch<T, 4, 8>(q, k, v, o, part, a, st);
    if (dp == 128) return launch<T, 4, 16>(q, k, v, o, part, a, st);
  } else if (bq == 16) {
    if (dp == 32) return launch<T, 1, 4>(q, k, v, o, part, a, st);
    if (dp == 64) return launch<T, 1, 8>(q, k, v, o, part, a, st);
    if (dp == 128) return launch<T, 1, 16>(q, k, v, o, part, a, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Floats of partials a launch with `nsplit` > 1 needs (0 for one split).
extern "C" long long flash_attention_scratch_len(int B, int Hq, int Hkv, int Sq, int dp,
                                                 int nsplit) {
  if (nsplit <= 1) return 0;
  const long long rows = static_cast<long long>(Hq / Hkv) * Sq;
  return static_cast<long long>(B) * nsplit * Hkv * rows * (dp + 2);
}

// dtype 0 = f32, 1 = bf16 (q, k, v and o alike); mode 0 full, 1 causal,
// 2 window, 3 chunk; bq ∈ {16, 64} rows a block, dp ∈ {32, 64, 128} ≥ D.
// Returns a cudaError_t code (0 on success); launches on `stream` and does
// not synchronise.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* o, int dtype, int B, int Hq, int Hkv,
                                      int Sq, int Skv, int D, int mode, int window,
                                      int q_offset, float scale, float softcap,
                                      int bq, int dp, int nsplit, float* scratch,
                                      long long scratch_len, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Skv <= 0 || D <= 0 ||
      D > dp || mode < 0 || mode > 3 || ((mode >= 2) && window <= 0) ||
      q_offset < 0 || nsplit < 1 || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (scratch_len < flash_attention_scratch_len(B, Hq, Hkv, Sq, dp, nsplit))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.B = B; a.Hq = Hq; a.Hkv = Hkv; a.Sq = Sq; a.Skv = Skv; a.D = D;
  a.g = Hq / Hkv; a.rows = a.g * Sq;
  a.mode = mode; a.window = window; a.q_offset = q_offset; a.nsplit = nsplit;
  a.scale = scale; a.softcap = softcap;
  a.vec = (D % 8 == 0) &&  // rows of 8-element chunks on 16-byte boundaries
          (reinterpret_cast<uintptr_t>(q) % 16 == 0) &&
          (reinterpret_cast<uintptr_t>(k) % 16 == 0) &&
          (reinterpret_cast<uintptr_t>(v) % 16 == 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? dispatch<float>(bq, dp, q, k, v, o, scratch, a, st)
                 : dispatch<__nv_bfloat16>(bq, dp, q, k, v, o, scratch, a, st);
  return static_cast<int>(err);
}
