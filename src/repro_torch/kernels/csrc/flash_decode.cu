// One-token GQA decode attention over a KV cache, for Hopper (sm_90a).
// Replaces the TPU kernel `flash_decode_pallas`
// (src/repro/kernels/flash_decode.py:75):
//
//   q (B, Hq, hd), k_cache and v_cache (B, S, Hkv, hd), fp32 or bf16, one
//   dtype; lengths (B,) int32 or int64. Query head h reads KV head
//   h / (Hq / Hkv) over the first n = min(lengths[b], S) cache rows:
//   out[b, h] = softmax_s(q . k[s] / sqrt(hd)) . v, fp32 inside, rounded
//   once to q's dtype.
//
// A length of 0 (or below) follows the reference (src/repro/kernels/ref.py:
// 105): every score is -1e30, so the answer is the mean of v over all S
// rows. (The TPU kernel returns 0 there: it skips every block.)
//
// What bounds it: device-memory bytes. Each valid cache row is read once
// and used for G = Hq / Hkv query heads, about 2G FLOP a byte at bf16. At
// the decode_32k shape of mixtral-8x7b (B = 128, S = 32,768, Hkv = 8,
// hd = 128, bf16) the whole cache is 17.2 GB, 5.1 ms at 3.35 TB/s if every
// length were S.
//
// Design: one block of 8 warps per (b, KV head, group of up to 4 of its
// query heads, chunk of the valid rows). The caller picks the number of
// chunks (flash-decoding's split over S) so that even a small batch fills
// the card: each b's n valid rows are cut into equal chunks, so only valid
// rows are read. A lane loads 16 bytes of a row at once (8 bf16 or 4 fp32
// columns), LPR lanes cover a row, so a warp takes 32 / LPR rows a step
// (two at bf16, hd = 128) and four steps at once, their loads issued
// together. The q of the block's heads, pre-scaled by log2(e)/sqrt(hd),
// stays in registers. Each score is a sum over the row's LPR lanes
// (shuffles); the scores of the four steps then update a base-2 online
// softmax (running max, sum and output, fp32) with one rescale per step
// group. Each row slot of each warp keeps its own state; the block merges
// them through shared memory. With one chunk it writes the output,
// dividing by max(l, 1e-30); with more it writes its (max, sum, output)
// in fp32, and a second kernel merges the chunks.
//
// Optional `lse` (B, Hq) fp32: each (b, head)'s natural log-sum-exp of
// its scores over the rows it read, ln(sum) + max, written by whichever
// kernel writes the output; -1e30 where the length was 0 (every score
// masked, as the reference's masked logsumexp gives in fp32). A caller
// that splits a cache along S combines the slices' outputs with it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kHeads = 4;   // query heads a block
constexpr int kUnroll = 4;  // row steps a warp loads at once
constexpr float kMasked = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

// ln(sum) + max of a base-2 online softmax state; kMasked when every
// score was masked.
__device__ __forceinline__ float natural_lse(float mx, float sum) {
  return mx <= kMasked ? kMasked : (mx + log2f(sum)) * kLn2;
}

// The 16 bytes of columns [col, col + 16 / sizeof(T)) of a row, zero past
// hd. `vec`: hd is a multiple of the vector and the row 16-byte aligned.
template <typename T>
__device__ __forceinline__ uint4 load16(const T* row, int col, int hd,
                                        bool vec) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec)
    return col < hd ? __ldg(reinterpret_cast<const uint4*>(row + col))
                    : make_uint4(0u, 0u, 0u, 0u);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    if (col + i >= hd) break;
    if constexpr (sizeof(T) == 4)
      w[i] = __float_as_uint(to_f32(row[col + i]));
    else
      w[i / 2] |= (uint32_t)__bfloat16_as_ushort(row[col + i])
                  << (16 * (i & 1));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// 16 loaded bytes as fp32: exact for both types.
__device__ __forceinline__ void unpack(uint4 r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(uint4 r, float (&f)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T, int LPR>  // LPR lanes a row: LPR * 16 / sizeof(T) >= hd
__global__ void __launch_bounds__(kWarps * 32) flash_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_cache,
    const T* __restrict__ v_cache, const void* __restrict__ lengths,
    int lengths_i64, T* __restrict__ out, float* __restrict__ part,
    float* __restrict__ lse, int n_k, int n_heads, int n_kv_heads, int hd,
    float qk_scale, int vec) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kRows = 32 / LPR;              // rows a warp step
  constexpr int kStates = kWarps * kRows;
  constexpr int kStep = kWarps * kRows;        // rows a block step
  __shared__ float m_s[kStates][kHeads];
  __shared__ float l_s[kStates][kHeads];
  __shared__ float acc_s[kStates][kHeads][LPR * kVec];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int slot = lane / LPR;
  const int col = (lane % LPR) * kVec;
  const int groups = n_heads / n_kv_heads;
  const int splits = (groups + kHeads - 1) / kHeads;
  const int hk = blockIdx.x / splits;
  const int h0 = hk * groups + (blockIdx.x % splits) * kHeads;
  const int nh = min(kHeads, (hk + 1) * groups - h0);
  const long long b = blockIdx.y;
  const int chunk = blockIdx.z, n_chunks = gridDim.z;
  const long long len =
      lengths_i64 ? static_cast<const long long*>(lengths)[b]
                  : (long long)static_cast<const int32_t*>(lengths)[b];
  const bool empty = len <= 0;
  const int n_keys = empty ? n_k : (int)min(len, (long long)n_k);
  const int per = (n_keys + n_chunks - 1) / n_chunks;
  const int lo = min(n_keys, chunk * per), hi = min(n_keys, lo + per);

  float qv[kHeads][kVec], m[kHeads], l[kHeads], acc[kHeads][kVec];
#pragma unroll
  for (int i = 0; i < kHeads; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      qv[i][c] = (i < nh && col + c < hd)
                     ? to_f32(q[(b * n_heads + h0 + i) * hd + col + c]) *
                           qk_scale
                     : 0.f;
      acc[i][c] = 0.f;
    }
  }

  const long long row = (long long)n_kv_heads * hd;
  const T* kb = k_cache + (b * n_k * n_kv_heads + hk) * hd;
  const T* vb = v_cache + (b * n_k * n_kv_heads + hk) * hd;
  // The loop bound is the same for the whole warp (shuffles need every
  // lane); a row slot past hi loads nothing and weighs nothing.
  for (int s0 = lo + warp * kRows; s0 < hi; s0 += kStep * kUnroll) {
    uint4 kr[kUnroll], vr[kUnroll];
    bool valid[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long s = s0 + u * kStep + slot;
      valid[u] = s < hi;
      kr[u] = valid[u] ? load16(kb + s * row, col, hd, vec)
                       : make_uint4(0u, 0u, 0u, 0u);
      vr[u] = valid[u] ? load16(vb + s * row, col, hd, vec)
                       : make_uint4(0u, 0u, 0u, 0u);
    }
    float x[kUnroll][kHeads];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kf[kVec];
      unpack(kr[u], kf);
#pragma unroll
      for (int i = 0; i < kHeads; ++i) {
        float d = 0.f;
#pragma unroll
        for (int c = 0; c < kVec; ++c) d = fmaf(qv[i][c], kf[c], d);
        x[u][i] = d;
      }
    }
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int i = 0; i < kHeads; ++i)
          x[u][i] += __shfl_xor_sync(0xffffffffu, x[u][i], off);
    // One rescale for the four steps, then their weights. m stays -inf
    // while a slot has seen no valid row; corr = 0 once it sees one.
#pragma unroll
    for (int i = 0; i < kHeads; ++i) {
      float mx = m[i];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        x[u][i] = !valid[u] ? -INFINITY : (empty ? kMasked : x[u][i]);
        mx = fmaxf(mx, x[u][i]);
      }
      const float corr = mx == -INFINITY ? 1.f : exp2f(m[i] - mx);
      l[i] *= corr;
#pragma unroll
      for (int c = 0; c < kVec; ++c) acc[i][c] *= corr;
      m[i] = mx;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float vf[kVec];
      unpack(vr[u], vf);
#pragma unroll
      for (int i = 0; i < kHeads; ++i) {
        const float p = valid[u] ? exp2f(x[u][i] - m[i]) : 0.f;
        l[i] += p;
#pragma unroll
        for (int c = 0; c < kVec; ++c) acc[i][c] = fmaf(p, vf[c], acc[i][c]);
      }
    }
  }

  const int st = warp * kRows + slot;
#pragma unroll
  for (int i = 0; i < kHeads; ++i) {
    if (lane % LPR == 0) {
      m_s[st][i] = m[i];
      l_s[st][i] = l[i];
    }
#pragma unroll
    for (int c = 0; c < kVec; ++c) acc_s[st][i][col + c] = acc[i][c];
  }
  __syncthreads();
  // Merge the slots' states; a slot that saw no row (m = -inf) weighs
  // nothing. A chunk with no row at all leaves (-inf, 0, 0).
  for (int e = threadIdx.x; e < nh * hd; e += blockDim.x) {
    const int i = e / hd, c = e - i * hd;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kStates; ++w) mx = fmaxf(mx, m_s[w][i]);
    float sum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kStates; ++w) {
      const float f = m_s[w][i] == -INFINITY ? 0.f : exp2f(m_s[w][i] - mx);
      sum = fmaf(l_s[w][i], f, sum);
      o = fmaf(acc_s[w][i][c], f, o);
    }
    const long long bh = b * n_heads + h0 + i;
    if (n_chunks == 1) {
      store_as(out + bh * hd + c, o / fmaxf(sum, 1e-30f));
      if (lse != nullptr && c == 0) lse[bh] = natural_lse(mx, sum);
    } else {
      float* p = part + (bh * n_chunks + chunk) * (hd + 2);
      p[c] = o;
      if (c == 0) {
        p[hd] = mx;
        p[hd + 1] = sum;
      }
    }
  }
}

// out[bh] from the n_chunks partial states of (b, h): one block a (b, h).
template <typename T>
__global__ void merge_chunks_kernel(const float* __restrict__ part,
                                    T* __restrict__ out,
                                    float* __restrict__ lse, int n_chunks,
                                    int hd) {
  const long long bh = blockIdx.x;
  const float* p = part + bh * n_chunks * (hd + 2);
  for (int c = threadIdx.x; c < hd; c += blockDim.x) {
    float mx = -INFINITY;
    for (int j = 0; j < n_chunks; ++j) mx = fmaxf(mx, p[j * (hd + 2) + hd]);
    float sum = 0.f, o = 0.f;
    for (int j = 0; j < n_chunks; ++j) {
      const float* pj = p + j * (hd + 2);
      const float f = pj[hd] == -INFINITY ? 0.f : exp2f(pj[hd] - mx);
      sum = fmaf(pj[hd + 1], f, sum);
      o = fmaf(pj[c], f, o);
    }
    store_as(out + bh * hd + c, o / fmaxf(sum, 1e-30f));
    if (lse != nullptr && c == 0) lse[bh] = natural_lse(mx, sum);
  }
}

template <typename T, int LPR>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           int lengths_i64, void* out, void* part, float* lse, int n_chunks,
           int batch, int n_k, int n_heads, int n_kv_heads, int hd,
           float qk_scale, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int vec = hd % kVec == 0 &&
                  (reinterpret_cast<uintptr_t>(k) |
                   reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  const int splits = (n_heads / n_kv_heads + kHeads - 1) / kHeads;
  const dim3 grid(n_kv_heads * splits, batch, n_chunks);
  flash_decode_kernel<T, LPR><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, lengths_i64, static_cast<T*>(out),
      static_cast<float*>(part), lse, n_k, n_heads, n_kv_heads, hd,
      qk_scale, vec);
  if (n_chunks > 1)
    merge_chunks_kernel<T><<<batch * n_heads, 128, 0, stream>>>(
        static_cast<const float*>(part), static_cast<T*>(out), lse, n_chunks,
        hd);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v,
              const void* lengths, int lengths_i64, void* out, void* part,
              float* lse, int n_chunks, int batch, int n_k, int n_heads,
              int n_kv_heads, int hd, float qk_scale, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (hd <= 4 * kVec)
    return launch<T, 4>(q, k, v, lengths, lengths_i64, out, part, lse,
                        n_chunks, batch, n_k, n_heads, n_kv_heads, hd,
                        qk_scale, stream);
  if (hd <= 8 * kVec)
    return launch<T, 8>(q, k, v, lengths, lengths_i64, out, part, lse,
                        n_chunks, batch, n_k, n_heads, n_kv_heads, hd,
                        qk_scale, stream);
  if (hd <= 16 * kVec)
    return launch<T, 16>(q, k, v, lengths, lengths_i64, out, part, lse,
                         n_chunks, batch, n_k, n_heads, n_kv_heads, hd,
                         qk_scale, stream);
  return launch<T, 32>(q, k, v, lengths, lengths_i64, out, part, lse,
                       n_chunks, batch, n_k, n_heads, n_kv_heads, hd,
                       qk_scale, stream);
}

}  // namespace

// q (B, Hq, hd), caches (B, S, Hkv, hd), out (B, Hq, hd), one dtype;
// lengths (B,) int32 or int64; 1 <= hd <= 128, Hq a multiple of Hkv.
// qk_scale = log2(e) / sqrt(hd). n_chunks >= 1 splits each b's valid rows;
// above 1, part holds B * Hq * n_chunks * (hd + 2) fp32 of scratch. lse,
// if not null, receives (B, Hq) fp32 natural log-sum-exps.
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* lengths,
                                   int lengths_i64, void* out, void* part,
                                   void* lse, int n_chunks, int bf16,
                                   int batch, int n_k, int n_heads,
                                   int n_kv_heads, int hd, float qk_scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (bf16)
    return launch_hd<__nv_bfloat16>(q, k, v, lengths, lengths_i64, out,
                                    part, l, n_chunks, batch, n_k, n_heads,
                                    n_kv_heads, hd, qk_scale, s);
  return launch_hd<float>(q, k, v, lengths, lengths_i64, out, part, l,
                          n_chunks, batch, n_k, n_heads, n_kv_heads, hd,
                          qk_scale, s);
}

extern "C" const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
