// Blockwise (flash) attention with GQA and a sliding window, for Hopper
// (sm_90a), one launch. Replaces the TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py:90):
//
//   q (B, T, Hq, hd), k and v (B, S, Hkv, hd), fp32 or bf16, one dtype;
//   query head h reads KV head h / (Hq / Hkv);
//   score(t, s) = q[t] . k[s] / sqrt(hd), kept where
//       (!causal || s <= t) && (!window || t - s < window)
//   and -1e30 elsewhere (causal is top-left, also when T != S; the window
//   bounds only the past, with or without causal);
//   out[t] = softmax_s(score(t, .)) . v, fp32 inside, rounded once to q's
//   dtype.
//
// The -1e30 is the reference's (src/repro/kernels/ref.py:81): a row whose
// every key is masked (T > S with a window) weighs all S keys equally and
// never gives NaN. Keys past S take no weight at all.
//
// What bounds it: operations. At the prefill_32k shape of mixtral-8x7b
// (T = S = 32,768, Hq = 32, Hkv = 8, hd = 128, window 4,096, causal, bf16)
// the unmasked pairs take 2.1 PFLOP, 2.1 ms at the card's 989 TFLOP/s for
// bf16, against 0.4 GB of q, k, v and out (0.13 ms at 3.35 TB/s).
//
// Design. Two paths share the masking, the tile skipping and the online
// softmax (running max m, sum l, fp32, base 2 via exp2f); each block is a
// (query tile of 64 rows, head, batch), and 64-key tiles of K and V stream
// through shared memory with all of a thread's loads issued before it
// stores any.
//
// bf16 inputs with hd a multiple of 8 (every model config of the repo) run
// on the tensor cores: 4 warps of 16 query rows each, mma.sync.m16n8k16
// with bf16 operands and fp32 sums, in the FlashAttention-2 layout. A warp
// keeps its Q fragments in registers, computes its 16 x 64 scores from K
// in shared memory, scales them to the base-2 domain in fp32, and turns
// the probabilities, rounded to bf16, straight into the A fragments of
// P.V; V's B fragments come from transposing ldmatrix loads. hd = 120 is
// zero-padded to 128 in shared memory.
//
// fp32 inputs (and bf16 with another hd) run on the fp32 CUDA cores
// (67 TFLOP/s), so fp32 keeps its precision: 256 threads, the tiles
// widened to fp32 in shared memory, the 64 x 64 score tile register-
// blocked 4 x 4 a thread from 16-byte shared loads, rows reduced across
// the 16 threads that share them with shuffles, the probabilities through
// shared memory into the P.V product.
//
// Key tiles wholly outside the causal or window mask of every row of the
// query tile are skipped, as the TPU kernel's `run` predicate does
// (flash_attention.py:49-55), also without causal; a query tile that holds
// a fully masked row visits every key, so the reference's answer comes
// out. The final divide is by max(l, 1e-30).
//
// What this design leaves on the table (later work): wgmma and TMA, a
// cp.async/TMA ring that overlaps the next tile's loads with this tile's
// products, and one block per KV head serving its G query heads so K and V
// are read once, not G times.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kBr = 64;        // query rows a block
constexpr int kBc = 64;        // keys a tile
constexpr int kThreads = 256;  // thread (ty, tx) of 16 x 16: rows 4ty..4ty+3
constexpr float kMasked = -1e30f;

struct Mask {
  int n_k;
  int causal;
  int has_window;
  int window;
  // The keys [lo(t), hi(t)] that row t may see; lo > hi when it sees none.
  __device__ int lo(int t) const {
    return has_window ? max(0, t - window + 1) : 0;
  }
  __device__ int hi(int t) const { return causal ? min(t, n_k - 1) : n_k - 1; }
  __device__ bool ok(int t, int s) const {
    return (!causal || s <= t) && (!has_window || t - s < window);
  }
};

// Copy rows [row0, row0 + 64) of a (rows, hd) operand whose rows lie `pitch`
// elements apart into shared memory as fp32 times `scale`, zero past `rows`
// and past hd. Each thread issues kBatch loads before it stores any, so a
// tile costs a few round trips to device memory, not one per element.
template <int HD, typename T>
__device__ __forceinline__ void stage_tile(float* dst, int ld,
                                           const T* __restrict__ src,
                                           long long pitch, int row0,
                                           int rows, int hd, float scale) {
  constexpr int kPer = kBc * HD / kThreads;  // elements a thread: 8 to 32
  constexpr int kBatch = 8;
  static_assert(kBr == kBc && kPer % kBatch == 0, "tile shape");
  const int tid = threadIdx.x;
#pragma unroll
  for (int j0 = 0; j0 < kPer; j0 += kBatch) {
    float x[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int e = tid + (j0 + j) * kThreads;
      const int r = e / HD, c = e % HD;
      x[j] = (row0 + r < rows && c < hd)
                 ? to_f32(src[(row0 + r) * pitch + c]) * scale
                 : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int e = tid + (j0 + j) * kThreads;
      dst[(e / HD) * ld + e % HD] = x[j];
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int n_q, int n_heads, int n_kv_heads, int hd,
    Mask mask, float qk_scale) {
  constexpr int kLd = HD + 4;    // Q, K rows: 16-byte aligned, 4 banks apart
  constexpr int kLdP = kBc + 4;
  constexpr int kCols = HD / 16;  // output columns a thread: tx + 16c
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // kBr x kLd
  float* ks = qs + kBr * kLd;                   // kBc x kLd
  float* vs = ks + kBc * kLd;                   // kBc x HD
  float* ps = vs + kBc * HD;                    // kBr x kLdP

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * kBr;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int hk = h / (n_heads / n_kv_heads);
  const int n_k = mask.n_k;
  const long long q_row = (long long)n_heads * hd;  // from one t to the next
  const long long kv_row = (long long)n_kv_heads * hd;
  const T* qb = q + (b * n_q * n_heads + h) * hd;
  const T* kb = k + (b * n_k * n_kv_heads + hk) * hd;
  const T* vb = v + (b * n_k * n_kv_heads + hk) * hd;
  T* ob = out + (b * n_q * n_heads + h) * hd;

  stage_tile<HD>(qs, kLd, qb, q_row, q0, n_q, hd, qk_scale);
  const int q_last = min(q0 + kBr, n_q) - 1;
  const int t_own = q0 + tid;
  const bool dead =
      tid < kBr && t_own < n_q && mask.lo(t_own) > mask.hi(t_own);
  const bool any_dead = __syncthreads_or(dead);  // also: Q is staged
  const int k_begin = any_dead ? 0 : mask.lo(q0);
  const int k_end = any_dead ? n_k : mask.hi(q_last) + 1;

  float m[4], l[4], o[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[i][c] = 0.f;
  }

  for (int k0 = (k_begin / kBc) * kBc; k0 < k_end; k0 += kBc) {
    __syncthreads();  // the last tile's K, V and P are read
    stage_tile<HD>(ks, kLd, kb, kv_row, k0, n_k, hd, 1.f);
    stage_tile<HD>(vs, HD, vb, kv_row, k0, n_k, hd, 1.f);
    __syncthreads();

    // S = Q K^T on this tile: rows 4ty + i, keys tx + 16j.
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < HD; c += 4) {
      float4 a[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(qs + (4 * ty + i) * kLd + c);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kk[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * kLd + c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float s = sc[i][j];
          s = fmaf(a[i].x, kk[j].x, s);
          s = fmaf(a[i].y, kk[j].y, s);
          s = fmaf(a[i].z, kk[j].z, s);
          s = fmaf(a[i].w, kk[j].w, s);
          sc[i][j] = s;
        }
    }

    // Mask, and the online softmax of each row over the 16 threads that
    // hold it (lanes 0-15 or 16-31 of a warp).
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = q0 + 4 * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = k0 + tx + 16 * j;
        const float x =
            s >= n_k ? -INFINITY : (mask.ok(t, s) ? sc[i][j] : kMasked);
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);  // >= -1e30: key k0 is < S
      const float corr = exp2f(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(sc[i][j] - m_new);
        ps[(4 * ty + i) * kLdP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) o[i][c] *= corr;
    }
    __syncthreads();

    // O += P V: rows 4ty + i, columns tx + 16c.
#pragma unroll 2
    for (int s = 0; s < kBc; s += 4) {
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 x =
            *reinterpret_cast<const float4*>(ps + (4 * ty + i) * kLdP + s);
        p[i][0] = x.x;
        p[i][1] = x.y;
        p[i][2] = x.z;
        p[i][3] = x.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) vv[c] = vs[(s + u) * HD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            o[i][c] = fmaf(p[i][u], vv[c], o[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + 4 * ty + i;
    if (t >= n_q) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < hd) store_as(ob + t * q_row + col, o[i][c] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// The tensor-core path: bf16 inputs with hd a multiple of 8.
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kWarps = 4;            // 16 query rows a warp
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;   // query rows a block (= kBr)
static_assert(kRows == kBr, "one query tile");

// d += a.b on the tensor cores: a 16x16 bf16 (row), b 16x8 bf16 (col), d
// 16x8 fp32, in the fragment layouts of PTX's mma.m16n8k16.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory, transposed: lane l names row
// l % 8 of matrix l / 8, and gets from each matrix the pair (2(l%4), l/4),
// (2(l%4)+1, l/4) -- the B fragment of mma for a row-major (k, n) tile.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t word(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Rows [row0, row0 + 64) of a (rows, hd) bf16 operand whose rows lie
// `pitch` elements apart, into shared memory (row stride ld), zero past
// `rows` and past hd, in 16-byte loads all issued before any store.
template <int HD>
__device__ __forceinline__ void stage(__nv_bfloat16* dst, int ld,
                                      const __nv_bfloat16* __restrict__ src,
                                      long long pitch, int row0, int rows,
                                      int hd) {
  constexpr int kVecs = HD / 8;                 // 16-byte vectors a row
  constexpr int kPer = kRows * kVecs / kThreads;  // 2, 4 or 8 a thread
  uint4 x[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = threadIdx.x + j * kThreads;
    const int r = e / kVecs, c = (e % kVecs) * 8;
    x[j] = (row0 + r < rows && c < hd)
               ? *reinterpret_cast<const uint4*>(src + (row0 + r) * pitch + c)
               : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = threadIdx.x + j * kThreads;
    *reinterpret_cast<uint4*>(dst + (e / kVecs) * ld + (e % kVecs) * 8) =
        x[j];
  }
}

// Warp w owns query rows q0 + 16w .. q0 + 16w + 15; lane (g, t) = (lane/4,
// lane%4) holds, of each 16 x 8 fragment, rows g and g + 8 and columns 2t,
// 2t + 1. Scores and P.V sums are fp32 in the fragments; P is rounded to
// bf16 for the tensor cores, and the row sum l adds the rounded values.
template <int HD>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    int n_q, int n_heads, int n_kv_heads, int hd, Mask mask, float qk_scale) {
  constexpr int kLd = HD + 8;  // rows 16-byte aligned, 4 banks apart
  constexpr int kSteps = HD / 16;  // k-steps of Q.K^T
  constexpr int kTiles = HD / 8;   // 8-column tiles of the output
  extern __shared__ uint4 smem_tc[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_tc);
  __nv_bfloat16* ks = qs + kRows * kLd;
  __nv_bfloat16* vs = ks + kBc * kLd;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int hk = h / (n_heads / n_kv_heads);
  const int n_k = mask.n_k;
  const long long q_row = (long long)n_heads * hd;
  const long long kv_row = (long long)n_kv_heads * hd;
  const __nv_bfloat16* qb = q + (b * n_q * n_heads + h) * hd;
  const __nv_bfloat16* kb = k + (b * n_k * n_kv_heads + hk) * hd;
  const __nv_bfloat16* vb = v + (b * n_k * n_kv_heads + hk) * hd;
  __nv_bfloat16* ob = out + (b * n_q * n_heads + h) * hd;

  stage<HD>(qs, kLd, qb, q_row, q0, n_q, hd);
  const int q_last = min(q0 + kRows, n_q) - 1;
  const int t_own = q0 + tid;
  const bool dead =
      tid < kRows && t_own < n_q && mask.lo(t_own) > mask.hi(t_own);
  const bool any_dead = __syncthreads_or(dead);  // also: Q is staged
  const int k_begin = any_dead ? 0 : mask.lo(q0);
  const int k_end = any_dead ? n_k : mask.hi(q_last) + 1;

  uint32_t qf[kSteps][4];
  const __nv_bfloat16* qw = qs + warp * 16 * kLd;
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    qf[kk][0] = word(qw + g * kLd + kk * 16 + 2 * t4);
    qf[kk][1] = word(qw + (g + 8) * kLd + kk * 16 + 2 * t4);
    qf[kk][2] = word(qw + g * kLd + kk * 16 + 8 + 2 * t4);
    qf[kk][3] = word(qw + (g + 8) * kLd + kk * 16 + 8 + 2 * t4);
  }
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[kTiles][4];
#pragma unroll
  for (int n = 0; n < kTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int k0 = (k_begin / kBc) * kBc; k0 < k_end; k0 += kBc) {
    __syncthreads();  // the last tile's K and V are read
    stage<HD>(ks, kLd, kb, kv_row, k0, n_k, hd);
    stage<HD>(vs, kLd, vb, kv_row, k0, n_k, hd);
    __syncthreads();

    // S = Q K^T: 8 fragments of 8 keys.
    float sc[kBc / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBc / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
      const __nv_bfloat16* kp = ks + (nt * 8 + g) * kLd + 2 * t4;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk)
        mma(sc[nt], qf[kk], word(kp + kk * 16), word(kp + kk * 16 + 8));
    }

    // Scale into the base-2 domain, mask, and the online softmax of the two
    // rows, each spread over the 4 lanes of a quad.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kBc / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * t4 + (e & 1);
        const float x =
            key >= n_k ? -INFINITY
                       : (mask.ok(row[e >> 1], key) ? sc[nt][e] * qk_scale
                                                    : kMasked);
        sc[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float m_new[2], corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      m_new[r] = fmaxf(m[r], mx[r]);  // >= -1e30: key k0 is < S
      corr[r] = exp2f(m[r] - m_new[r]);
    }
    // P as the A fragments of P.V: keys 16j .. 16j + 15 are score
    // fragments 2j and 2j + 1.
    uint32_t pf[kBc / 16][4];
#pragma unroll
    for (int nt = 0; nt < kBc / 8; ++nt) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = __bfloat162float(
            __float2bfloat16(exp2f(sc[nt][e] - m_new[e >> 1])));
        sum[e >> 1] += p[e];
      }
      const __nv_bfloat162 lo = __floats2bfloat162_rn(p[0], p[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p[2], p[3]);
      pf[nt / 2][(nt % 2) * 2] = *reinterpret_cast<const uint32_t*>(&lo);
      pf[nt / 2][(nt % 2) * 2 + 1] = *reinterpret_cast<const uint32_t*>(&hi);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * corr[r] + sum[r];
      m[r] = m_new[r];
    }
#pragma unroll
    for (int n = 0; n < kTiles; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // O += P V, V's B fragments by transposing loads, 16 columns at once.
    const int mtx = lane >> 3;
#pragma unroll
    for (int j = 0; j < kBc / 16; ++j)
#pragma unroll
      for (int n2 = 0; n2 < kTiles / 2; ++n2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(
            vf, vs + (j * 16 + (mtx & 1) * 8 + (lane & 7)) * kLd + n2 * 16 +
                    (mtx >> 1) * 8);
        mma(o[2 * n2], pf[j], vf[0], vf[1]);
        mma(o[2 * n2 + 1], pf[j], vf[2], vf[3]);
      }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= n_q) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int n = 0; n < kTiles; ++n) {
      const int col = n * 8 + 2 * t4;
      if (col < hd) {
        const __nv_bfloat162 x =
            __floats2bfloat162_rn(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
        *reinterpret_cast<__nv_bfloat162*>(ob + row[r] * q_row + col) = x;
      }
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int n_q, int n_heads, int n_kv_heads, int hd, Mask mask,
           float qk_scale, cudaStream_t stream) {
  const size_t smem = (size_t)(kRows + 2 * kBc) * (HD + 8) * 2;
  auto kernel = flash_attention_kernel<HD>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((n_q + kRows - 1) / kRows, n_heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      n_q, n_heads, n_kv_heads, hd, mask, qk_scale);
  return (int)cudaGetLastError();
}

}  // namespace tc

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int n_q, int n_heads, int n_kv_heads, int hd, Mask mask,
           float qk_scale, cudaStream_t stream) {
  const size_t smem =
      (size_t)(kBr * (HD + 4) + kBc * (HD + 4) + kBc * HD + kBr * (kBc + 4)) *
      sizeof(float);
  auto kernel = flash_attention_kernel<T, HD>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((n_q + kBr - 1) / kBr, n_heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), n_q, n_heads,
      n_kv_heads, hd, mask, qk_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* out,
              int batch, int n_q, int n_heads, int n_kv_heads, int hd,
              Mask mask, float qk_scale, cudaStream_t stream) {
  if (hd <= 32)
    return launch<T, 32>(q, k, v, out, batch, n_q, n_heads, n_kv_heads, hd,
                         mask, qk_scale, stream);
  if (hd <= 64)
    return launch<T, 64>(q, k, v, out, batch, n_q, n_heads, n_kv_heads, hd,
                         mask, qk_scale, stream);
  return launch<T, 128>(q, k, v, out, batch, n_q, n_heads, n_kv_heads, hd,
                        mask, qk_scale, stream);
}

}  // namespace

// q (B, T, Hq, hd), k and v (B, S, Hkv, hd), out (B, T, Hq, hd), one dtype;
// 1 <= hd <= 128, Hq a multiple of Hkv. bf16 with hd a multiple of 8 (and
// 16-byte aligned tensors) takes the tensor cores, the rest the fp32 CUDA
// cores. `window` counts only when
// has_window. qk_scale = log2(e) / sqrt(hd).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int bf16,
                                      int batch, int n_q, int n_k,
                                      int n_heads, int n_kv_heads, int hd,
                                      int causal, int has_window, int window,
                                      float qk_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Mask mask{n_k, causal, has_window, window};
  const uintptr_t any_bits = reinterpret_cast<uintptr_t>(q) |
                             reinterpret_cast<uintptr_t>(k) |
                             reinterpret_cast<uintptr_t>(v) |
                             reinterpret_cast<uintptr_t>(out);
  if (bf16 && hd % 8 == 0 && any_bits % 16 == 0) {  // 16-byte row loads
    if (hd <= 32)
      return tc::launch<32>(q, k, v, out, batch, n_q, n_heads, n_kv_heads,
                            hd, mask, qk_scale, s);
    if (hd <= 64)
      return tc::launch<64>(q, k, v, out, batch, n_q, n_heads, n_kv_heads,
                            hd, mask, qk_scale, s);
    return tc::launch<128>(q, k, v, out, batch, n_q, n_heads, n_kv_heads, hd,
                           mask, qk_scale, s);
  }
  if (bf16)
    return launch_hd<__nv_bfloat16>(q, k, v, out, batch, n_q, n_heads,
                                    n_kv_heads, hd, mask, qk_scale, s);
  return launch_hd<float>(q, k, v, out, batch, n_q, n_heads, n_kv_heads, hd,
                          mask, qk_scale, s);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
