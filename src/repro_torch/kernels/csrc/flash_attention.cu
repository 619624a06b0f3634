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
// What bounds it: operations. At the prefill shape of mixtral-8x7b
// (T = S = 32,768, Hq = 32, Hkv = 8, hd = 128, window 4,096, causal, bf16)
// the unmasked pairs take 2.1 PFLOP, 2.1 ms at the card's 989 TFLOP/s for
// bf16, against 0.4 GB of q, k, v and out (0.13 ms at 3.35 TB/s). Only
// the tensor cores' wgmma reaches that rate; the kernel must keep them fed
// (K and V tiles in shared memory before they are needed) and keep the
// softmax's exponentials, on the slower special-function units, beside the
// products rather than between them.
//
// Design of the bf16 path (hd a multiple of 8, 16-byte aligned tensors:
// every model config of the repo). A block is (128 query rows, head,
// batch) and three warpgroups:
//   - a producer whose first thread issues TMA copies (cp.async.bulk.tensor
//     with mbarrier completion): Q once, then 128-key tiles of K and V into
//     a ring of 2 stages, each tile as 64-column chunks in the 128-byte-
//     swizzled layout that wgmma's descriptors read. The tensor maps are
//     4-D (hd, heads, rows, batch); hd that is not a multiple of 64 (120,
//     or any hd % 16 == 8) is zero-padded by TMA's out-of-bounds fill, as
//     are rows past T or S. K and V have barriers of their own, so a K tile
//     is refilled as soon as its scores are taken;
//   - two consumer warpgroups of 64 query rows, which get the producer's
//     registers (setmaxnreg): S = Q.K^T is wgmma m64n128k16 with both
//     operands in shared memory; O += P.V takes P from registers (rounded
//     to bf16; l adds the rounded values) and V through the descriptor's
//     transpose bit, since V's tile is MN-major for that product. Tile i's
//     scores are issued together with tile i-1's P.V (commit groups), and
//     tile i's softmax runs while that P.V is still on the tensor cores;
//     the softmax writes neither the scores nor P while products are in
//     flight, which would make ptxas serialize every wgmma. The two
//     warpgroups take turns at issuing (named barriers), so that one's
//     softmax, on the special-function units, runs beside the other's
//     products.
// Blocks of one KV group read the same K and V through the 50 MB L2 (32 MB
// of K and V at T = 8,192).
//
// fp32 inputs (and bf16 with another hd or alignment) run on the fp32
// CUDA cores (67 TFLOP/s), so fp32 keeps its precision: 256 threads, 64-row
// query tiles, the tiles widened to fp32 in shared memory, the 64 x 64
// score tile register-blocked 4 x 4 a thread from 16-byte shared loads,
// rows reduced across the 16 threads that share them with shuffles, the
// probabilities through shared memory into the P.V product.
//
// Both paths share the masking, the tile skipping and the online softmax
// (running max m, sum l, fp32, base 2: exp2f on the CUDA cores, one ex2
// instruction on the tensor-core path). Key tiles wholly outside
// the causal or window mask of every row of the query tile are skipped, as
// the TPU kernel's `run` predicate does (flash_attention.py:49-55), also
// without causal; a query tile that holds a fully masked row visits every
// key, so the reference's answer comes out. The final divide is by
// max(l, 1e-30).
//
// Left for later: a persistent grid, wider key tiles, and one block per KV
// head serving its G query heads so that K and V are read once, not G
// times.
#include <cuda.h>
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

// ---------------------------------------------------------------------------
// The tensor-core path: bf16 inputs with hd a multiple of 8, on TMA and
// wgmma. Block = 3 warpgroups: two consumers of 64 query rows each, then a
// producer whose first thread issues every TMA copy.
// ---------------------------------------------------------------------------
namespace wg {

constexpr int kRows = 128;        // query rows a block
constexpr int kKeys = 128;        // keys a tile of K and V
constexpr int kStages = 2;        // K and V tiles in flight
constexpr int kChunkCols = 64;    // columns of one 128-byte swizzled chunk
constexpr int kChunkBytes = 128 * 128;  // a 128-row chunk: 16 KB
constexpr int kThreads = 384;
constexpr int kConsumerWarps = 8;
// Registers a thread after the split: 128 x 24 + 256 x 240 <= 65,536.
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// Shared memory of a block at head width HD (64 or 128: hd rounded up), in
// bytes from a 1024-aligned base: Q, then kStages K tiles, kStages V
// tiles, then the mbarriers. A tile is HD / 64 chunks of 128 rows x 128
// bytes, each in the 128-byte-swizzled layout TMA writes and wgmma reads.
template <int HD>
struct Smem {
  static constexpr int kChunks = HD / kChunkCols;
  static constexpr int kTile = kChunks * kChunkBytes;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;
  // q_full, then k_full, v_full, k_empty, v_empty: kStages each
  static constexpr int kBytes = kBar + 8 * (1 + 4 * kStages) + 1024;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// One box of a 4-D tensor map (hd, heads, rows, batch) into shared memory;
// its bytes complete a transaction on `bar`. Coordinates past the tensor
// are zero-filled.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory descriptor of the 128-byte-swizzled layout:
// start address, leading and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of registers that a wgmma
// in flight owns across this point.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// D (64 x 128, fp32) (+)= A (64 x 16, smem) . B (128 x 16, smem)^T, both
// K-major; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D (64 x 64, fp32) += A (64 x 16, bf16 in registers) . B (16 x 64, smem,
// MN-major: the transpose bit set).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 128, fp32) += A (64 x 16, bf16 in registers) . B (16 x 128, smem,
// MN-major: the transpose bit set).
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// 2^x in one special-function instruction (results below 2^-126 flush to
// zero: weights that small add nothing beside the row's largest, 1).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Named barriers 1 and 2: the consumer warpgroups take turns issuing
// their products, so one's softmax runs while the other's products do.
__device__ __forceinline__ void turn_wait(int grp) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + grp) : "memory");
}
__device__ __forceinline__ void turn_pass(int grp) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - grp) : "memory");
}

// Consumer thread (warp w of its warpgroup, lane (g, t4) = (lane/4, lane%4))
// holds rows 16w + g and 16w + g + 8 of its warpgroup's 64; of each 8-column
// block n of a wgmma sum, entries 4n .. 4n+3 are (row g: cols 8n + 2t4,
// +1), (row g + 8: the same cols). Scores and O are fp32 there; P is rounded
// to bf16 for the P.V product, and the row sum l adds the rounded values.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_kernel(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ out,
    int n_q, int n_heads, int n_kv_heads, int hd, Mask mask, float qk_scale) {
  using L = Smem<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sq = base + L::kQ, sk = base + L::kK, sv = base + L::kV;
  const uint32_t q_full = base + L::kBar;
  auto k_full = [&](int s) { return q_full + 8 * (1 + s); };
  auto v_full = [&](int s) { return q_full + 8 * (1 + kStages + s); };
  auto k_empty = [&](int s) { return q_full + 8 * (1 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return q_full + 8 * (1 + 3 * kStages + s); };

  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (n_heads / n_kv_heads);
  const int n_k = mask.n_k;
  const int q_last = min(q0 + kRows, n_q) - 1;
  // A block that holds a row whose every key is masked visits every key;
  // any other skips the key tiles outside every row's mask.
  bool any_dead = false;
  for (int t = q0; t <= q_last; ++t) any_dead |= mask.lo(t) > mask.hi(t);
  const int k_begin = any_dead ? 0 : mask.lo(q0);
  const int k_end = any_dead ? n_k : mask.hi(q_last) + 1;
  const int first = k_begin / kKeys;
  const int n_tiles = (k_end - first * kKeys + kKeys - 1) / kKeys;  // >= 1

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), kConsumerWarps);
      mbar_init(v_empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 2 * 128) {
    // ---- producer: Q once, then K and V tiles into the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 2 * 128) {
      mbar_expect_tx(q_full, L::kTile);
#pragma unroll
      for (int c = 0; c < L::kChunks; ++c)
        tma_load(sq + c * kChunkBytes, &q_map, q_full, c * kChunkCols, h, q0,
                 b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        const int parity = ((i / kStages) & 1) ^ 1;  // the first round passes
        const int k0 = (first + i) * kKeys;
        mbar_wait(k_empty(s), parity);
        mbar_expect_tx(k_full(s), L::kTile);
#pragma unroll
        for (int c = 0; c < L::kChunks; ++c)
          tma_load(sk + s * L::kTile + c * kChunkBytes, &k_map, k_full(s),
                   c * kChunkCols, hk, k0, b);
        mbar_wait(v_empty(s), parity);
        mbar_expect_tx(v_full(s), L::kTile);
#pragma unroll
        for (int c = 0; c < L::kChunks; ++c)
          tma_load(sv + s * L::kTile + c * kChunkBytes, &v_map, v_full(s),
                   c * kChunkCols, hk, k0, b);
      }
    }
  } else {
    // ---- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int grp = threadIdx.x >> 7;  // consumer warpgroup: rows 64 grp ..
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int r0 = q0 + 64 * grp;
    const int row[2] = {r0 + 16 * warp + g, r0 + 16 * warp + g + 8};
    constexpr int kSteps = HD / 16;  // k-steps of Q.K^T
    constexpr int kO = HD / 2;       // O's fp32 registers a thread

    float o[kO], s[kKeys / 2];
    uint32_t p[kKeys / 16][4];
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kO; ++i) o[i] = 0.f;

    // S = Q K^T of tile i, issued and committed (the caller waits)
    auto issue_qk = [&](int i) {
      const int st = i % kStages;
      const uint32_t kt = sk + st * L::kTile;
      const uint32_t qa = sq + grp * 64 * 128;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        const uint32_t off = (kk / 4) * kChunkBytes + (kk % 4) * 32;
        wgmma_ss(s, desc(qa + off, 16, 1024), desc(kt + off, 16, 1024),
                 kk > 0);
      }
      wgmma_commit();
    };
    // O += P V of tile i: V's tile is MN-major for this product, 64-column
    // chunks kChunkBytes apart, 8-key row groups 1024 bytes apart
    auto issue_pv = [&](int i) {
      const uint32_t vt = sv + (i % kStages) * L::kTile;
#pragma unroll
      for (int j = 0; j < kKeys / 16; ++j)
        wgmma_rs(o, p[j], desc(vt + j * 16 * 128, kChunkBytes, 1024));
      wgmma_commit();
    };
    auto release = [&](uint32_t bar) {
      if (lane == 0) mbar_arrive(bar);
    };
    // The online softmax of tile i (base 2, masked where the tile reaches
    // past a row's mask or past S): P rounded to bf16 into pn, each row's
    // rescale of the sums so far into corr.
    auto softmax = [&](int i, uint32_t (&pn)[kKeys / 16][4],
                       float (&corr)[2]) {
      const int k0 = (first + i) * kKeys;
      const bool masked = any_dead || k0 + kKeys > n_k ||
                          (mask.causal && k0 + kKeys - 1 > r0) ||
                          (mask.has_window && r0 + 63 - k0 >= mask.window);
      // score idx of the thread's 64 (row (idx % 4) / 2 of its two) in the
      // base-2 domain, masked; the scores are never written, as the next
      // tile's products own their registers
      auto masked_x = [&](int idx) {
        const int key = k0 + 8 * (idx / 4) + 2 * t4 + (idx & 1);
        return key >= n_k ? -INFINITY
                          : (mask.ok(row[(idx % 4) / 2], key)
                                 ? s[idx] * qk_scale
                                 : kMasked);
      };
      float mx[2] = {-INFINITY, -INFINITY};
      if (masked) {
#pragma unroll
        for (int idx = 0; idx < kKeys / 2; ++idx)
          mx[(idx % 4) / 2] = fmaxf(mx[(idx % 4) / 2], masked_x(idx));
      } else {  // scaled in the exponent below; max * scale is exact
#pragma unroll
        for (int idx = 0; idx < kKeys / 2; ++idx)
          mx[(idx % 4) / 2] = fmaxf(mx[(idx % 4) / 2], s[idx]);
        mx[0] *= qk_scale;
        mx[1] *= qk_scale;
      }
      float m_new[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        m_new[r] = fmaxf(m[r], mx[r]);  // >= -1e30: key k0 is < S
        corr[r] = ex2(m[r] - m_new[r]);
      }
      // P as the A fragments of P.V: keys 16j .. 16j + 15 are the score
      // blocks 2j and 2j + 1; x_of(idx, m) is score idx's exponent
      auto exps = [&](auto x_of) {
#pragma unroll
        for (int j = 0; j < kKeys / 16; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int idx = 8 * j + 2 * q;  // row q & 1, keys 2t4 + 8(q/2)
            const float m_r = m_new[q & 1];
            pn[j][q] = pack_bf16(ex2(x_of(idx, m_r)), ex2(x_of(idx + 1, m_r)));
            sum[q & 1] += __uint_as_float(pn[j][q] << 16) +
                          __uint_as_float(pn[j][q] & 0xffff0000u);
          }
      };
      if (masked)
        exps([&](int idx, float m_r) { return masked_x(idx) - m_r; });
      else
        exps([&](int idx, float m_r) { return fmaf(s[idx], qk_scale, -m_r); });
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l[r] = l[r] * corr[r] + sum[r];
        m[r] = m_new[r];
      }
    };

    // P for the next P.V, moved from pn once the last P.V has finished:
    // registers that a wgmma reads must not be written by other
    // instructions while wgmmas are in flight (the softmax's packs into pn
    // are), or ptxas serializes every wgmma (C7513; 1.06 against 0.86 ms
    // on the H100 at T = S = 8,192).
    auto take_p = [&](const uint32_t (&pn)[kKeys / 16][4]) {
#pragma unroll
      for (int j = 0; j < kKeys / 16; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          asm volatile("mov.b32 %0, %1;\n" : "=r"(p[j][q]) : "r"(pn[j][q]));
    };
    // Tile i's scores are computed while tile i-1's P.V runs, and tile
    // i's softmax overlaps that product. The two warpgroups take turns at
    // issuing their products (n_tiles + 1 turns each; warpgroup 1 lets 0
    // go first and passes no turn after its last), so that one's softmax
    // runs while the other's products do (0.866 against 0.836 ms at T = S
    // = 8,192 on the H100).
    float corr[2];
    uint32_t pn[kKeys / 16][4];
    if (grp == 1) turn_pass(grp);
    auto issue = [&](int i, bool qk, bool pv, bool last_turn) {
      turn_wait(grp);
      pin(o);
      pin(p);
      wgmma_fence();
      if (qk) issue_qk(i);
      if (pv) issue_pv(i - 1);
      if (!(grp == 1 && last_turn)) turn_pass(grp);
    };
    mbar_wait(q_full, 0);
    mbar_wait(k_full(0), 0);
    issue(0, true, false, false);
    wgmma_wait<0>();
    pin(s);
    release(k_empty(0));
    softmax(0, pn, corr);
    take_p(pn);
    for (int i = 1; i < n_tiles; ++i) {
      const int st = i % kStages, prev = (i - 1) % kStages;
      mbar_wait(k_full(st), (i / kStages) & 1);
      mbar_wait(v_full(prev), ((i - 1) / kStages) & 1);
      issue(i, true, true, false);
      wgmma_wait<1>();
      pin(s);
      release(k_empty(st));
      softmax(i, pn, corr);
      wgmma_wait<0>();
      pin(o);
      pin(p);
      release(v_empty(prev));
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        o[4 * n + 0] *= corr[0];
        o[4 * n + 1] *= corr[0];
        o[4 * n + 2] *= corr[1];
        o[4 * n + 3] *= corr[1];
      }
      take_p(pn);
    }
    const int last = n_tiles - 1;
    mbar_wait(v_full(last % kStages), (last / kStages) & 1);
    issue(n_tiles, false, true, true);
    wgmma_wait<0>();
    pin(o);
    release(v_empty(last % kStages));

    const long long q_row = (long long)n_heads * hd;
    __nv_bfloat16* ob = out + ((long long)b * n_q * n_heads + h) * hd;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row[r] >= n_q) continue;
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        const int col = 8 * n + 2 * t4;
        if (col < hd)
          *reinterpret_cast<uint32_t*>(ob + row[r] * q_row + col) =
              pack_bf16(o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
      }
    }
  }
}

// cuTensorMapEncodeTiled from the driver, reached through the runtime so
// that the library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// The map of a (batch, rows, heads, hd) bf16 tensor as 4-D (hd, heads,
// rows, batch), boxes of 64 columns x 1 head x 128 rows, 128-byte swizzle;
// columns past hd and rows past `rows` read as zeros.
bool tensor_map(CUtensorMap* map, const void* base, int batch, int rows,
                int heads, int hd) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)rows * heads * hd * 2};
  const cuuint32_t box[4] = {kChunkCols, 1, kRows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  static_assert(kRows == kKeys, "one box shape for Q, K and V");
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int n_q, int n_k, int n_heads, int n_kv_heads, int hd, Mask mask,
           float qk_scale, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  if (!tensor_map(&qm, q, batch, n_q, n_heads, hd) ||
      !tensor_map(&km, k, batch, n_k, n_kv_heads, hd) ||
      !tensor_map(&vm, v, batch, n_k, n_kv_heads, hd))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_attention_kernel<HD>;
  const int smem = Smem<HD>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_q + kRows - 1) / kRows, n_heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(out), n_q, n_heads, n_kv_heads,
      hd, mask, qk_scale);
  return (int)cudaGetLastError();
}

}  // namespace wg

}  // namespace

// q (B, T, Hq, hd), k and v (B, S, Hkv, hd), out (B, T, Hq, hd), one dtype;
// 1 <= hd <= 128, Hq a multiple of Hkv. bf16 with hd a multiple of 8 (and
// 16-byte aligned tensors) takes the tensor cores, the rest the fp32 CUDA
// cores. `window` counts only when has_window. qk_scale = log2(e) /
// sqrt(hd).
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
  if (bf16 && hd % 8 == 0 && any_bits % 16 == 0) {  // TMA's row strides
    if (hd <= 64)
      return wg::launch<64>(q, k, v, out, batch, n_q, n_k, n_heads,
                            n_kv_heads, hd, mask, qk_scale, s);
    return wg::launch<128>(q, k, v, out, batch, n_q, n_k, n_heads, n_kv_heads,
                           hd, mask, qk_scale, s);
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
