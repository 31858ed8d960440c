// GQA flash-attention forward on Hopper (kernel K8 of the port).
//
// Replaces the TPU kernel of src/repro/kernels/flash_attention/
// flash_attention.py — `flash_attention` :112, `flash_attention_pallas`
// :99, body `_kernel` :34: softmax(q·kᵀ·scale)·v with an online softmax
// over kv tiles, so the (Sq × Skv) logits never reach device memory. Masks
// full | causal | window | chunk, a `q_offset` (row i sits at global
// position q_offset + i; decode passes the cache position), an optional
// logit softcap. q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D), f32 or bf16,
// D ≤ 128; scores, statistics and the accumulator in f32; out in q's type.
// A row that sees no key gives 0, as the reference's oracle does.
//
// Rows. A block owns one (batch, kv head) and rows of that kv head's query
// group, numbered position-major: row ρ is query position ρ / g of query
// head kv_head·g + ρ % g (g = Hq / Hkv). So the group's g heads share every
// K/V tile a block loads (GQA without repeating K/V), and a block's rows
// span a contiguous range of positions, which makes the tile-level mask
// exact: kv tiles of 64 keys that no row of the block can see are never
// visited (the causal reach ends the walk at the block's last position, a
// window or chunk starts it at the first key the block's first position may
// see — flash_attention.py:44-56, as a range). Ragged Sq, Skv and D are
// masked, or zero-padded in shared memory and registers; nothing is padded
// in device memory.
//
// Three routes, chosen by dtype and rows g·Sq in the wrapper's `plan()`
// (kernels/flash_attention/ops.py): this is dispatch by dtype and shape,
// not a fallback. Each route is a kernel of this file and returns its own
// launch error; none gives way to another.
//
// `mma` — bf16, g·Sq > 16 rows (prefill, refill). Bound on this card:
//   operations, 4·D flops a visible (query, key) pair against 2·(2·Sq·Hq +
//   2·Skv·Hkv)·D bytes (llama3.2-3b's first wave: 86 GFLOP, 0.087 ms of bf16
//   tensor-core time against 0.015 ms of bytes). So both products run on the
//   tensor cores in FlashAttention-2's schedule: a block of 4 warps owns
//   BQ = 64 rows, 16 a warp, whose Q fragments are loaded once by `ldmatrix`
//   and stay in registers; 64-key K/V tiles stay bf16 in shared memory, rows
//   padded by 8 elements so `ldmatrix` is free of bank conflicts, copied by
//   16-byte `cp.async` into a ring of two stages so tile t + 1 streams in
//   while tile t computes (one barrier a tile; Q waits in the second stage
//   until it is in registers, so the ring is all the shared memory and
//   three blocks fit an SM); S = Q·Kᵀ and O += P·V by `mma.sync` m16n8k16
//   with f32 accumulators. The online softmax runs on S's C fragments in the
//   log2 domain (scale·log2 e applied to S in f32, quad shuffles for the row
//   max); P is rounded to bf16 in registers and reused as P·V's A operand
//   (two n8 C fragments make one k16 A fragment), V's B fragments come from
//   `ldmatrix.trans`, so P never touches shared memory. Per-element masks
//   run only on tiles that straddle a mask edge or Skv's end. Under a mask
//   the row tiles with the most kv tiles launch first. D is zero-padded to
//   DP ∈ {32, 64, 128} in shared memory, by scalar loads when rows are not
//   16-byte aligned. `wgmma` fed by TMA is the next step for this route:
//   with 16 rows a warp every warp reads all of each K/V tile through
//   `ldmatrix`, so shared-memory bandwidth shares the bound with the MMAs.
// `decode` — g·Sq ≤ 16 rows, f32 or bf16 (a decode step: one token of g
//   heads a kv head). Bound: bytes, each K/V element read once for g·Sq
//   rows. A block of 4 warps owns (batch, kv head, kv split); `plan()` sizes
//   the splits so the grid holds up to two blocks an SM in one wave, and
//   each split covers whole 64-key tiles. Each group of lanes walks its own
//   keys: a key's D is spread over 16-byte chunks, one a lane (16 lanes a
//   key at D = 128 in bf16, so a warp takes two keys a step), read straight
//   from device memory in the input's type — a step's chunks of U keys a
//   group in flight at once, the next step's loading into a second register
//   buffer while this one computes. q's chunk of every row sits in
//   registers. A lane forms every row's partial dot; shuffles finish them.
//   Each group keeps its own (m, l, acc) per row; groups merge by shuffles,
//   warps through shared memory, splits in `flash_attention_combine_kernel`.
// `f32` — f32, g·Sq > 16 rows. The tensor cores would take the products in
//   TF32 or bf16 and break the f32 tolerance, so they run on the CUDA cores:
//   BQ = 64 rows from shared memory, register tiles of 4 × 8 scores and
//   4 × DP/8 outputs a thread, the kv range split over blocks when the grid
//   is small. Bound: operations, against 67 TFLOP/s of f32.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBKV = 64;           // keys a tile
constexpr float kNegInf = -1e30f;  // running max before any key: finite, so
                                   // exp of (masked − max) is 0, never NaN
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Args {
  int B, Hq, Hkv, Sq, Skv, D, g, rows;
  int mode, window, q_offset, nsplit;
  float scale, softcap;
  int vec;
};

__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// Whether key position kp is visible from query position qp.
__device__ __forceinline__ bool visible(int mode, int window, int qp, int kp) {
  if (mode == 0) return true;                                 // full
  if (kp > qp) return false;                                  // causal reach
  if (mode == 2) return kp > qp - window;                     // window
  if (mode == 3) return (kp / window) == (qp / window);       // chunk
  return true;                                                // causal
}

// Whether every position in [first_q, last_q] sees every key in [k0, k1].
__device__ __forceinline__ bool all_visible(int mode, int window, int first_q,
                                            int last_q, int k0, int k1) {
  if (mode == 0) return true;
  if (k1 > first_q) return false;
  if (mode == 2) return k0 > last_q - window;
  if (mode == 3) return k0 / window == last_q / window;
  return true;
}

// The kv tiles [t_lo, t_hi) that some position in [first_q, last_q] can
// see, then split `split` of `nsplit` of them.
__device__ __forceinline__ void tile_range(const Args& a, int first_q, int last_q,
                                           int split, int& t_lo, int& t_hi) {
  int lo = 0, hi = a.Skv;
  if (a.mode != 0) hi = min(hi, last_q + 1);
  if (a.mode == 2) lo = max(0, first_q - a.window + 1);
  if (a.mode == 3) lo = max(0, (first_q / a.window) * a.window);
  t_lo = lo / kBKV;
  t_hi = hi > lo ? (hi + kBKV - 1) / kBKV : t_lo;
  const int per = (t_hi - t_lo + a.nsplit - 1) / a.nsplit;
  t_lo = min(t_hi, t_lo + split * per);
  t_hi = min(t_hi, t_lo + per);
}

// ------------------------------------------------------------ route `f32`

// Eight consecutive elements of a row (d0 + 8 ≤ D when `vec`).
__device__ __forceinline__ void load8(const float* __restrict__ row, int d0, int D,
                                      bool vec, float* out) {
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

constexpr int kF32Threads = 128;  // 16 row groups × 8 column groups
constexpr int kF32Rows = 64;      // BQ: 4 rows a row group

template <int NC>
__global__ void __launch_bounds__(kF32Threads)
flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           float* __restrict__ part, Args a) {
  constexpr int RPT = kF32Rows / 16, BQ = kF32Rows;
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
  const float* kb = k + (static_cast<long long>(b) * a.Hkv + kvh) * a.Skv * a.D;
  const float* vb = v + (static_cast<long long>(b) * a.Hkv + kvh) * a.Skv * a.D;

  // ---- the block's query rows, scaled, into shared memory
  for (int u = tid; u < BQ * NC; u += kF32Threads) {
    const int r = u / NC, d0 = (u % NC) * 8, rho = rho0 + r;
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (rho < a.rows && d0 < a.D) {
      const int h = kvh * a.g + rho % a.g, i = rho / a.g;
      load8(q + ((static_cast<long long>(b) * a.Hq + h) * a.Sq + i) * a.D, d0,
            a.D, a.vec, x);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) Qs[r * QS + d0 + e] = x[e] * a.scale;
  }

  int t_lo, t_hi;
  tile_range(a, a.q_offset + rho0 / a.g, a.q_offset + rho_last / a.g, split,
             t_lo, t_hi);

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
    for (int u = tid; u < kBKV * NC; u += kF32Threads) {
      const int c = u / NC, d0 = (u % NC) * 8, kp = kv0 + c;
      float xk[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float xv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (kp < a.Skv && d0 < a.D) {
        load8(kb + static_cast<long long>(kp) * a.D, d0, a.D, a.vec, xk);
        load8(vb + static_cast<long long>(kp) * a.D, d0, a.D, a.vec, xv);
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
      float* orow = o + ((static_cast<long long>(b) * a.Hq + h) * a.Sq + qi) * a.D;
      const float inv_den = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const int d = tc + 8 * n;
        if (d < a.D) orow[d] = acc[i][n] * inv_den;
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

// One block per (batch, kv head, row), a thread per d: merge the nsplit
// partials (m in the natural-log domain) with a running (max, sum, acc),
// every split's three loads independent of the merge before it.
constexpr int kCombineThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
flash_attention_combine_kernel(const float* __restrict__ part, T* __restrict__ o, Args a,
                               int DP) {
  const int rho = static_cast<int>(blockIdx.x) % a.rows;
  const int pair = static_cast<int>(blockIdx.x) / a.rows;
  const int kvh = pair % a.Hkv, b = pair / a.Hkv;
  const long long lane = static_cast<long long>(a.Hkv) * a.rows * (DP + 2);
  const float* p0 = part + ((static_cast<long long>(b) * a.nsplit * a.Hkv + kvh) *
                                a.rows + rho) * (DP + 2);
  const int h = kvh * a.g + rho % a.g, qi = rho / a.g;
  T* orow = o + ((static_cast<long long>(b) * a.Hq + h) * a.Sq + qi) * a.D;
  for (int d = threadIdx.x; d < a.D; d += kCombineThreads) {
    float M = kNegInf, L = 0.f, A = 0.f;
#pragma unroll 4
    for (int s = 0; s < a.nsplit; ++s) {
      const float* ps = p0 + s * lane;
      const float m = ps[0], l = ps[1], x = ps[2 + d];
      const float mn = fmaxf(M, m), w_old = expf(M - mn), w_new = expf(m - mn);
      L = L * w_old + l * w_new;
      A = A * w_old + x * w_new;
      M = mn;
    }
    store_as(orow + d, A / fmaxf(L, 1e-30f));
  }
}

template <typename T>
cudaError_t combine(const float* part, T* o, const Args& a, int dp, cudaStream_t st) {
  flash_attention_combine_kernel<T><<<static_cast<unsigned>(a.B * a.Hkv * a.rows),
                                      kCombineThreads, 0, st>>>(part, o, a, dp);
  return cudaGetLastError();
}

template <int NC>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       float* part, const Args& a, cudaStream_t st) {
  constexpr int BQ = kF32Rows, DP = 8 * NC;
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(BQ) * (DP + 1) + kBKV * (DP + 1) + kBKV * DP +
       BQ * (kBKV + 1));
  auto kern = flash_attention_f32_kernel<NC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(rt::ceil_div(a.rows, BQ)),
                  static_cast<unsigned>(a.Hkv),
                  static_cast<unsigned>(a.B * a.nsplit));
  kern<<<grid, kF32Threads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), part, a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.nsplit == 1) return err;
  return combine<float>(part, static_cast<float*>(o), a, DP, st);
}

// ------------------------------------------------------------ route `mma`

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared, asynchronously; the bytes past `src_bytes` are
// zero-filled (0 reads nothing).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Four 8×8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8. `trans` hands each lane a column pair instead
// of a row pair.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// c (16×8, f32) += a (16×16, bf16, row) · b (16×8, bf16, col).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Eight bf16 of `row` from d0 into shared memory (16 bytes): a `cp.async`
// when rows are 16-byte aligned (`vec`), else scalar loads; zeros past D or
// when !ok.
__device__ __forceinline__ void chunk_to_smem(bf16* dst, const bf16* __restrict__ row,
                                              int d0, int D, bool ok, bool vec) {
  if (vec) {
    cp_async16(dst, ok && d0 < D ? row + d0 : row, ok && d0 < D ? 16 : 0);
  } else {
    const unsigned short* r = reinterpret_cast<const unsigned short*>(row);
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = d0 + 2 * e;
      const uint32_t lo = ok && d < D ? __ldg(r + d) : 0u;
      const uint32_t hi = ok && d + 1 < D ? __ldg(r + d + 1) : 0u;
      w[e] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Four warps a block and three blocks an SM: the registers are capped at
// 168 a thread, and the ring (68 KB at DP = 128) leaves room for three.
constexpr int kMmaWarps = 4;
constexpr int kMmaRows = 16 * kMmaWarps;  // BQ

template <int DP>
__global__ void __launch_bounds__(kMmaWarps * 32, 3)
flash_attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ o, Args a) {
  constexpr int BQ = kMmaRows;     // rows a block, 16 a warp
  constexpr int STR = DP + 8;      // shared row stride: 16-byte pad
  constexpr int NCH = DP / 8;      // 16-byte chunks a row
  constexpr int KD = DP / 16;      // k16 steps of Q·Kᵀ
  constexpr int NT = kBKV / 8;     // n8 tiles of S
  constexpr int ND = DP / 8;       // n8 tiles of O
  constexpr int NTHR = kMmaWarps * 32;
  // A ring of two stages, each a K tile then a V tile of (kBKV, STR). The
  // block's Q rows (BQ ≤ 2·kBKV) sit in stage 1 until they are in registers.
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  bf16* Qs = ring + 2 * kBKV * STR;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int pairs = a.B * a.Hkv, n_rt = (a.rows + BQ - 1) / BQ;
  int rt_i = static_cast<int>(blockIdx.x) / pairs;
  if (a.mode != 0) rt_i = n_rt - 1 - rt_i;  // most kv tiles first
  const int pair = static_cast<int>(blockIdx.x) % pairs;
  const int kvh = pair % a.Hkv, b = pair / a.Hkv;
  const int rho0 = rt_i * BQ, rho_last = min(rho0 + BQ, a.rows) - 1;
  const long long kv_off = (static_cast<long long>(b) * a.Hkv + kvh) * a.Skv * a.D;
  const bf16* kb = k + kv_off;
  const bf16* vb = v + kv_off;
  const int first_q = a.q_offset + rho0 / a.g;
  const int last_q = a.q_offset + rho_last / a.g;
  int t_lo, t_hi;
  tile_range(a, first_q, last_q, 0, t_lo, t_hi);
  const bool vec = a.vec != 0;

  // ---- copies: the block's Q rows, and K/V tile t into stage `st`
  for (int u = tid; u < BQ * NCH; u += NTHR) {
    const int r = u / NCH, d0 = (u % NCH) * 8, rho = rho0 + r;
    const bool ok = rho < a.rows;
    const bf16* row = q;
    if (ok) {
      const int h = kvh * a.g + rho % a.g, i = rho / a.g;
      row = q + ((static_cast<long long>(b) * a.Hq + h) * a.Sq + i) * a.D;
    }
    chunk_to_smem(Qs + r * STR + d0, row, d0, a.D, ok, vec);
  }
  auto load_kv = [&](int t, int st) {
    bf16* ks = ring + st * 2 * kBKV * STR;
    bf16* vs = ks + kBKV * STR;
    for (int u = tid; u < kBKV * NCH; u += NTHR) {
      const int c = u / NCH, d0 = (u % NCH) * 8, kp = t * kBKV + c;
      const bool ok = kp < a.Skv;
      const long long off = static_cast<long long>(ok ? kp : 0) * a.D;
      chunk_to_smem(ks + c * STR + d0, kb + off, d0, a.D, ok, vec);
      chunk_to_smem(vs + c * STR + d0, vb + off, d0, a.D, ok, vec);
    }
  };
  if (t_lo < t_hi) load_kv(t_lo, 0);
  cp_async_commit();

  // this thread's rows of S and O: r_a = warp·16 + lane/4 and r_a + 8
  const int r_a = warp * 16 + lane / 4;
  const int qp_a = a.q_offset + (rho0 + r_a) / a.g;
  const int qp_b = a.q_offset + (rho0 + r_a + 8) / a.g;
  const int col = 2 * (lane % 4);  // first of the thread's column pair
  const float sc = a.scale * kLog2e;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  uint32_t qf[KD][4];

  for (int t = t_lo; t < t_hi; ++t) {
    const int st = (t - t_lo) & 1;
    cp_async_wait_all();
    // tile t has landed for every thread, and every warp is done with tile
    // t − 1, whose stage tile t + 1 takes
    __syncthreads();
    if (t == t_lo) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        ldsm_x4(qf[kk], Qs + (warp * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * STR +
                            16 * kk + (lane >> 4) * 8);
      __syncthreads();  // Q is in registers before stage 1 is refilled
    }
    if (t + 1 < t_hi) {
      load_kv(t + 1, st ^ 1);  // streams in while tile t computes
      cp_async_commit();
    }
    const bf16* ks = ring + st * 2 * kBKV * STR;
    const bf16* vs = ks + kBKV * STR;

    // ---- S = Q·Kᵀ (16 × 64 a warp)
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kf[4];
        ldsm_x4(kf, ks + (16 * np + (lane >> 4) * 8 + (lane & 7)) * STR + 16 * kk +
                        ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[kk], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // ---- logits in the log2 domain; masks on edge tiles only
    const int kv0 = t * kBKV;
    if (a.softcap > 0.f) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = a.softcap * tanhf(s[j][e] * a.scale / a.softcap) * kLog2e;
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= sc;
    }
    if (!(kv0 + kBKV <= a.Skv &&
          all_visible(a.mode, a.window, first_q, last_q, kv0, kv0 + kBKV - 1))) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = kv0 + 8 * j + col + (e & 1);
          if (kp >= a.Skv || !visible(a.mode, a.window, e < 2 ? qp_a : qp_b, kp))
            s[j][e] = -INFINITY;
        }
    }

    // ---- online softmax: a row lives in one quad of lanes
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float al_a = exp2f(m_a - mn_a), al_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = exp2f(s[j][0] - mn_a);
      s[j][1] = exp2f(s[j][1] - mn_a);
      s[j][2] = exp2f(s[j][2] - mn_b);
      s[j][3] = exp2f(s[j][3] - mn_b);
      sum_a += s[j][0] + s[j][1];
      sum_b += s[j][2] + s[j][3];
    }
    l_a = l_a * al_a + sum_a;  // this thread's columns; the quad sums at the end
    l_b = l_b * al_b + sum_b;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= al_a;
      acc[n][1] *= al_a;
      acc[n][2] *= al_b;
      acc[n][3] *= al_b;
    }

    // ---- O += P·V: P's C fragments become A fragments in registers
#pragma unroll
    for (int kk = 0; kk < kBKV / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, vs + (16 * kk + ((lane >> 3) & 1) * 8 + (lane & 7)) * STR +
                              16 * dp + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], pa, vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
  }
  cp_async_wait_all();  // a block with no tile still has its Q copies in flight

  // ---- emit the normalised rows
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const bool pairs_ok = (a.D & 1) == 0;  // bf16 pairs 4-byte aligned
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int rho = rho0 + r_a + 8 * half;
    if (rho >= a.rows) continue;
    const float inv = 1.f / fmaxf(half ? l_b : l_a, 1e-30f);
    const int h = kvh * a.g + rho % a.g, i = rho / a.g;
    bf16* orow = o + ((static_cast<long long>(b) * a.Hq + h) * a.Sq + i) * a.D;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int d = 8 * n + col;
      const float x0 = acc[n][2 * half] * inv, x1 = acc[n][2 * half + 1] * inv;
      if (pairs_ok && d + 1 < a.D) {
        *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(x0, x1);
      } else {
        if (d < a.D) orow[d] = __float2bfloat16_rn(x0);
        if (d + 1 < a.D) orow[d + 1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

template <int DP>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       const Args& a, cudaStream_t st) {
  constexpr int BQ = kMmaRows;
  static_assert(BQ <= 2 * kBKV, "Q overlays one ring stage");
  const size_t smem = sizeof(bf16) * static_cast<size_t>(4 * kBKV) * (DP + 8);
  auto kern = flash_attention_mma_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>(rt::ceil_div(a.rows, BQ)) * a.B * a.Hkv;
  kern<<<static_cast<unsigned>(blocks), kMmaWarps * 32, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), a);
  return cudaGetLastError();
}

// --------------------------------------------------------- route `decode`

constexpr int kDecWarps = 4;

// One 16-byte chunk of `row` from d0: zeros past D or when !ok; scalar
// loads when rows are not 16-byte aligned.
__device__ __forceinline__ uint4 load_chunk(const float* __restrict__ row, int d0,
                                            int D, bool ok, bool vec) {
  if (!ok || d0 >= D) return make_uint4(0u, 0u, 0u, 0u);
  if (vec) return __ldg(reinterpret_cast<const uint4*>(row + d0));
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) w[e] = d0 + e < D ? __float_as_uint(__ldg(row + d0 + e)) : 0u;
  return make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ uint4 load_chunk(const bf16* __restrict__ row, int d0,
                                            int D, bool ok, bool vec) {
  if (!ok || d0 >= D) return make_uint4(0u, 0u, 0u, 0u);
  if (vec) return __ldg(reinterpret_cast<const uint4*>(row + d0));
  const unsigned short* r = reinterpret_cast<const unsigned short*>(row);
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int d = d0 + 2 * e;
    w[e] = (d < D ? static_cast<uint32_t>(__ldg(r + d)) : 0u) |
           ((d + 1 < D ? static_cast<uint32_t>(__ldg(r + d + 1)) : 0u) << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void unpack(const uint4& u, float (&x)[4]) {
  x[0] = __uint_as_float(u.x);
  x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z);
  x[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&x)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    x[2 * e] = __uint_as_float(w[e] << 16);
    x[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
  }
}

template <typename T, int DP, int RMAX>
__global__ void __launch_bounds__(kDecWarps * 32)
flash_attention_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, T* __restrict__ o,
                              float* __restrict__ part, Args a) {
  constexpr int E = 16 / sizeof(T);  // elements a 16-byte chunk
  constexpr int LPK = DP / E;        // lanes a key
  constexpr int SPW = 32 / LPK;      // key groups a warp
  constexpr int SLOTS = kDecWarps * SPW;
  constexpr int U = RMAX <= 4 ? 4 : (RMAX <= 8 ? 2 : 1);  // keys a group a step
  constexpr bool kQReg = RMAX * E <= 32;  // q's chunk of every row in registers
  __shared__ __align__(16) float Qs[RMAX][DP];
  __shared__ float Ms[kDecWarps][RMAX], Ls[kDecWarps][RMAX];
  __shared__ __align__(16) float As[kDecWarps][RMAX][DP];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int slot = warp * SPW + lane / LPK, d0 = (lane % LPK) * E;
  const int split = static_cast<int>(blockIdx.x) % a.nsplit;
  const int pair = static_cast<int>(blockIdx.x) / a.nsplit;
  const int kvh = pair % a.Hkv, b = pair / a.Hkv;
  const int R = a.rows;
  const int last_q = a.q_offset + (R - 1) / a.g;
  int t_lo, t_hi;
  tile_range(a, a.q_offset, last_q, split, t_lo, t_hi);
  const int k0 = t_lo * kBKV, k1 = min(t_hi * kBKV, a.Skv);
  const long long kv_off = (static_cast<long long>(b) * a.Hkv + kvh) * a.Skv * a.D;
  const T* kb = k + kv_off;
  const T* vb = v + kv_off;
  const bool vec = a.vec != 0;
  const float sc = a.scale * kLog2e;

  // A step takes U keys a group, all of their chunks in flight at once; the
  // next step's chunks load while this one computes, and the first step's
  // while q comes in. Steps are uniform across the block, so every shuffle
  // has all lanes.
  constexpr int STEP = U * SLOTS;
  uint4 kr[U], vr[U];
  auto load_step = [&](int base, uint4 (&kx)[U], uint4 (&vx)[U]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kp = base + u * SLOTS + slot;
      const long long off = static_cast<long long>(kp < k1 ? kp : 0) * a.D;
      kx[u] = load_chunk(kb + off, d0, a.D, kp < k1, vec);
      vx[u] = load_chunk(vb + off, d0, a.D, kp < k1, vec);
    }
  };
  load_step(k0, kr, vr);

  for (int u = tid; u < RMAX * DP; u += kDecWarps * 32) {
    const int r = u / DP, d = u % DP;
    float x = 0.f;
    if (r < R && d < a.D) {
      const int h = kvh * a.g + r % a.g, i = r / a.g;
      x = to_f32(q[((static_cast<long long>(b) * a.Hq + h) * a.Sq + i) * a.D + d]);
    }
    Qs[r][d] = x;
  }
  __syncthreads();
  float qreg[kQReg ? RMAX : 1][kQReg ? E : 1];
  if constexpr (kQReg) {
#pragma unroll
    for (int r = 0; r < RMAX; ++r)
#pragma unroll
      for (int e = 0; e < E; ++e) qreg[r][e] = Qs[r][d0 + e];
  }

  float m[RMAX], l[RMAX], acc[RMAX][E];
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  }

  for (int base = k0; base < k1; base += STEP) {
    uint4 kn[U], vn[U];
    load_step(base + STEP, kn, vn);
    float kf[U][E], s[RMAX][U];
#pragma unroll
    for (int u = 0; u < U; ++u) unpack(kr[u], kf[u]);
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      float qv[E];
      if constexpr (kQReg) {
#pragma unroll
        for (int e = 0; e < E; ++e) qv[e] = qreg[r][e];
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) qv[e] = Qs[r][d0 + e];
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float x = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) x = fmaf(qv[e], kf[u][e], x);
        s[r][u] = x;
      }
    }
#pragma unroll
    for (int off = LPK / 2; off > 0; off >>= 1)
#pragma unroll
      for (int r = 0; r < RMAX; ++r)
#pragma unroll
        for (int u = 0; u < U; ++u)
          s[r][u] += __shfl_xor_sync(0xffffffffu, s[r][u], off);
    if (a.softcap > 0.f) {
#pragma unroll
      for (int r = 0; r < RMAX; ++r)
#pragma unroll
        for (int u = 0; u < U; ++u)
          s[r][u] = a.softcap * tanhf(s[r][u] * a.scale / a.softcap) * kLog2e;
    } else {
#pragma unroll
      for (int r = 0; r < RMAX; ++r)
#pragma unroll
        for (int u = 0; u < U; ++u) s[r][u] *= sc;
    }
    // masks only where some key of the step is past k1 or hidden from a row
    // (rows past R never reach the output)
    if (!(base + STEP <= k1 &&
          all_visible(a.mode, a.window, a.q_offset, last_q, base, base + STEP - 1))) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int kp = base + u * SLOTS + slot;
#pragma unroll
        for (int r = 0; r < RMAX; ++r)
          if (kp >= k1 || r >= R || !visible(a.mode, a.window, a.q_offset + r / a.g, kp))
            s[r][u] = -INFINITY;
      }
    }
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[r][u]);
      const float mn = fmaxf(m[r], mx), al = exp2f(m[r] - mn);
      m[r] = mn;
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[r][u] = exp2f(s[r][u] - mn);
        sum += s[r][u];
      }
      l[r] = l[r] * al + sum;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] *= al;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[E];
      unpack(vr[u], vf);
#pragma unroll
      for (int r = 0; r < RMAX; ++r)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] = fmaf(s[r][u], vf[e], acc[r][e]);
      kr[u] = kn[u];
      vr[u] = vn[u];
    }
  }

  // ---- merge the warp's key groups (butterfly), then the warps
#pragma unroll
  for (int off = LPK; off < 32; off <<= 1) {
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], off);
      const float mn = fmaxf(m[r], mo);
      const float ws = exp2f(m[r] - mn), wo = exp2f(mo - mn);
      l[r] = l[r] * ws + lo * wo;
      m[r] = mn;
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[r][e] = acc[r][e] * ws + __shfl_xor_sync(0xffffffffu, acc[r][e], off) * wo;
    }
  }
  if (lane < LPK) {
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
#pragma unroll
      for (int e = 0; e < E; ++e) As[warp][r][d0 + e] = acc[r][e];
      if (lane == 0) {
        Ms[warp][r] = m[r];
        Ls[warp][r] = l[r];
      }
    }
  }
  __syncthreads();
  const int z = static_cast<int>(blockIdx.x) / (a.Hkv * a.nsplit) * a.nsplit + split;
  for (int u = tid; u < R * DP; u += kDecWarps * 32) {
    const int r = u / DP, d = u % DP;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) M = fmaxf(M, Ms[w][r]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      const float wt = exp2f(Ms[w][r] - M);
      L += Ls[w][r] * wt;
      A += As[w][r][d] * wt;
    }
    if (a.nsplit == 1) {
      if (d < a.D) {
        const int h = kvh * a.g + r % a.g, i = r / a.g;
        store_as(o + ((static_cast<long long>(b) * a.Hq + h) * a.Sq + i) * a.D + d,
                 A / fmaxf(L, 1e-30f));
      }
    } else {
      // partial row [m (natural log), l, acc[0..DP)], the combine's layout
      float* prow = part + ((static_cast<long long>(z) * a.Hkv + kvh) * a.rows + r) *
                               (DP + 2);
      if (d == 0) {
        prow[0] = M * kLn2;
        prow[1] = L;
      }
      prow[2 + d] = A;
    }
  }
}

template <typename T, int DP, int RMAX>
cudaError_t launch_decode(const void* q, const void* k, const void* v, void* o,
                          float* part, const Args& a, cudaStream_t st) {
  const long long blocks = static_cast<long long>(a.B) * a.Hkv * a.nsplit;
  flash_attention_decode_kernel<T, DP, RMAX><<<static_cast<unsigned>(blocks),
                                               kDecWarps * 32, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), part, a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.nsplit == 1) return err;
  return combine<T>(part, static_cast<T*>(o), a, DP, st);
}

template <typename T, int DP>
cudaError_t decode_rows(int bq, const void* q, const void* k, const void* v,
                            void* o, float* part, const Args& a, cudaStream_t st) {
  if (bq == 1) return launch_decode<T, DP, 1>(q, k, v, o, part, a, st);
  if (bq == 2) return launch_decode<T, DP, 2>(q, k, v, o, part, a, st);
  if (bq == 3) return launch_decode<T, DP, 3>(q, k, v, o, part, a, st);
  if (bq == 4) return launch_decode<T, DP, 4>(q, k, v, o, part, a, st);
  if (bq == 8) return launch_decode<T, DP, 8>(q, k, v, o, part, a, st);
  if (bq == 16) return launch_decode<T, DP, 16>(q, k, v, o, part, a, st);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_decode(int bq, int dp, const void* q, const void* k,
                            const void* v, void* o, float* part, const Args& a,
                            cudaStream_t st) {
  if (dp == 32) return decode_rows<T, 32>(bq, q, k, v, o, part, a, st);
  if (dp == 64) return decode_rows<T, 64>(bq, q, k, v, o, part, a, st);
  if (dp == 128) return decode_rows<T, 128>(bq, q, k, v, o, part, a, st);
  return cudaErrorInvalidValue;
}

cudaError_t dispatch(int route, int bq, int dp, const void* q, const void* k,
                     const void* v, void* o, float* part, int dtype, const Args& a,
                     cudaStream_t st) {
  if (route == 0 && dtype == 0 && bq == kF32Rows) {
    if (dp == 32) return launch_f32<4>(q, k, v, o, part, a, st);
    if (dp == 64) return launch_f32<8>(q, k, v, o, part, a, st);
    if (dp == 128) return launch_f32<16>(q, k, v, o, part, a, st);
  } else if (route == 1 && dtype == 1 && a.nsplit == 1) {
    if (bq == kMmaRows && dp == 32) return launch_mma<32>(q, k, v, o, a, st);
    if (bq == kMmaRows && dp == 64) return launch_mma<64>(q, k, v, o, a, st);
    if (bq == kMmaRows && dp == 128) return launch_mma<128>(q, k, v, o, a, st);
  } else if (route == 2 && a.rows <= bq) {
    return dtype == 0 ? dispatch_decode<float>(bq, dp, q, k, v, o, part, a, st)
                      : dispatch_decode<bf16>(bq, dp, q, k, v, o, part, a, st);
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
// 2 window, 3 chunk; route 0 = `f32` (bq 64), 1 = `mma` (bf16, bq 64, one
// split), 2 = `decode` (bq ∈ {1, 2, 3, 4, 8, 16} ≥ g·Sq); dp ∈ {32, 64,
// 128} ≥ D. Returns a cudaError_t code (0 on success); launches on `stream`
// and does not synchronise.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* o, int dtype, int B, int Hq, int Hkv,
                                      int Sq, int Skv, int D, int mode, int window,
                                      int q_offset, float scale, float softcap,
                                      int route, int bq, int dp, int nsplit,
                                      float* scratch, long long scratch_len,
                                      void* stream) {
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
  return static_cast<int>(dispatch(route, bq, dp, q, k, v, o, scratch, dtype, a,
                                   static_cast<cudaStream_t>(stream)));
}
