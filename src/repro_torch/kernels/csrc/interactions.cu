// DLRM feature interaction for Hopper (sm_90a), one launch. Replaces the TPU
// kernel `interactions_pallas` (src/repro/kernels/interactions.py:31):
//
//   A[b]   = [bot_out[b]; pooled[b, 0]; ...; pooled[b, T-1]]  (T+1, d) fp32
//   out[b] = [bot_out[b] | A[b, i] . A[b, j]
//             for (i, j) in tril_indices(T+1, -1)]
//
// bot_out and pooled may each be fp32 or bf16; bf16 is widened exactly on
// load, and every product and sum is fp32 on the CUDA cores (no TF32). The
// TPU kernel wrote the whole (B, T+1, T+1) matrix and gathered the strict
// lower triangle and prepended bot_out outside its launch; here the
// triangle is written straight into the output in numpy's row-major order
// (the order csrc/fused_serve.cu emits) and bot_out is copied into the
// first d columns, so no square matrix is written.
//
// What bounds it: device-memory bytes, and at the serve shapes the latency
// of one short launch. At B = 800, T = 40, d = 32 one call reads 4.2 MB and
// writes 2.7 MB (2.1 us at 3.35 TB/s) against 42 MFLOP (0.6 us of fp32);
// at B = 25 the bytes take 0.1 us and the launch, one round trip to memory
// and one sample's sums are the time. On the card the sums, not the
// bytes, set the pace at a large batch, at 3-4x their FMA issue (PERF.md).
//
// Design. The grid is at most one wave of resident blocks; each takes an
// even share of the batch's samples. A sample's A lands in shared memory
// by 16-byte cp.async (a bf16 row: 8-byte copies into raw cells that the
// copying thread widens once its copies are in), the next sample's copies
// issued once the current one is summed, in float4 chunks of a row whose
// position is XOR-swizzled by the row's tile so that the lanes of a warp
// reading different rows hit different banks. The strict lower triangle is
// cut into 4 x 4 tiles of pairs (i, j); a tile is KS lanes' work (KS = 4
// at a small batch, so that its dot products are short chains over more
// warps, else 2): each lane keeps 16 sums in registers over its share of
// the d/4 chunks, reading 8 float4 a chunk (the next chunk's while this
// one's 64 FMAs run), and the KS lanes add their sums with shuffles; lanes
// past the last tile sit out. A sample's pairs go into its output row
// staged in shared memory, which leaves in 16-byte coalesced stores when a
// row is a whole number of float4 (it is at d = 32 or 128, T = 40). Rows
// that are not whole float4s, pointers off 16-byte (bf16: 8-byte)
// alignment, and shapes whose raw cells do not fit beside A take scalar
// loads that widen in registers, in the same kernel; an output row that
// does not fit beside A is written from registers. Row offsets are 64-bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kTile = 4;         // a tile: 4 x 4 pairs
constexpr int kMaxThreads = 512;
constexpr int kMaxKs = 4;        // lanes that split one tile's chunks
constexpr int kDepth = 1;        // samples loaded ahead of the one summed
// KS = 4 while B * tiles * 4 stays under this many threads an SM, else 2
constexpr int kThreadsPerSm = 256;
constexpr size_t kSmemMax = 227 * 1024;

template <typename X>
constexpr bool kBf16 = std::is_same<X, __nv_bfloat16>::value;

struct Shape {
  int n_tables, dim;
  int s1;          // T + 1 rows of A
  int nc;          // float4 chunks of a row: ceil(d / 4)
  int ldc;         // chunks a row takes in shared memory: nc rounded up to 8
  int rows;        // rows of A in shared memory: s1 rounded up to kTile
  int tiles;       // ni (ni + 1) / 2 tiles of the lower triangle, ni = rows / 4
  int row_len;     // d + T(T+1)/2 floats of an output row
  int raw_slot;    // 8-byte raw cells a slot: s1 * nc rounded up to 2, or 0
  int slots;       // samples a block holds: kDepth + 1, or 1
  int share, extra;  // samples a block: share, and one more for the first extra
};

// A raw cell: the four bf16 of a chunk, widened exactly.
__device__ __forceinline__ float4 widen(uint2 u) {
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// The n (< 4) real elements of a row's last chunk, or of a row off 16-byte
// (bf16: 8-byte) alignment, one by one; the rest read as 0.
template <typename X>
__device__ __forceinline__ float4 load_scalar(const X* p, int n) {
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = k < n ? to_f32(p[k]) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// The chunk a row's chunk c lands on: rows of tile r / 4 are XOR-swizzled
// by that tile (times KS, so the KS lanes of a tile, reading neighbouring
// chunks, and the neighbouring tiles of a warp spread over the 8 groups of
// 4 banks).
template <int KS>
__device__ __forceinline__ int swizzle(int tile) {
  return (tile * KS) & 7;
}

__device__ __forceinline__ float dot4(float4 x, float4 y, float acc) {
  acc = fmaf(x.x, y.x, acc);
  acc = fmaf(x.y, y.y, acc);
  acc = fmaf(x.z, y.z, acc);
  return fmaf(x.w, y.w, acc);
}

// A chunk of a row into shared memory: an fp32 row's straight into A, a
// bf16 row's into its raw cell.
template <typename X>
__device__ __forceinline__ void land(float4* dst, uint2* cell, const X* src) {
  const unsigned d = static_cast<unsigned>(
      __cvta_generic_to_shared(kBf16<X> ? (void*)cell : (void*)dst));
  if constexpr (kBf16<X>)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until this thread's copies are in: with kDepth = 1 the only group
// in flight is the sample about to be summed.
static_assert(kDepth == 1, "a sample ahead, waited for whole");
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

template <typename Bot, typename Pooled, int KS>
__global__ void __launch_bounds__(kMaxThreads) interactions_kernel(
    const Bot* __restrict__ bot, const Pooled* __restrict__ pooled,
    float* __restrict__ out, Shape s, int vec, int staged, int vec_out) {
  static_assert(KS == 2 || KS == 4, "two or four lanes a tile");
  extern __shared__ float4 smem[];
  const size_t a_slot = (size_t)s.rows * s.ldc;         // float4s
  float4* a = smem;                                     // slots x A
  uint2* raw = reinterpret_cast<uint2*>(a + s.slots * a_slot);
  float* stage = reinterpret_cast<float*>(raw + s.slots * s.raw_slot);
  const int per_sample = s.s1 * s.nc;
  const int depth = s.slots - 1;
  // this block's samples: an even share
  const int lo = blockIdx.x * s.share + min((int)blockIdx.x, s.extra);
  const int hi = lo + s.share + ((int)blockIdx.x < s.extra);

  // A of sample b into slot k: copies straight into shared memory, or
  // scalar loads through registers when a row is not whole aligned chunks
  auto issue = [&](long long b, int k) {
    for (int e = threadIdx.x; e < per_sample; e += blockDim.x) {
      const int r = e / s.nc, c = e - r * s.nc;
      float4* dst = a + k * a_slot + r * s.ldc + (c ^ swizzle<KS>(r / kTile));
      uint2* cell = raw + (size_t)k * s.raw_slot + e;
      if (r == 0) {
        const Bot* src = bot + b * s.dim + 4 * c;
        if (vec)
          land(dst, cell, src);
        else
          *dst = load_scalar(src, min(4, s.dim - 4 * c));
      } else {
        const Pooled* src = pooled + (b * s.n_tables + r - 1) * s.dim + 4 * c;
        if (vec)
          land(dst, cell, src);
        else
          *dst = load_scalar(src, min(4, s.dim - 4 * c));
      }
    }
    cp_async_commit();
  };
  auto copy_out = [&](int k, long long b) {
    const float* src = stage + (size_t)k * s.row_len;
    float* dst = out + b * s.row_len;
    if (vec_out) {
      for (int e = threadIdx.x; e < s.row_len / 4; e += blockDim.x)
        reinterpret_cast<float4*>(dst)[e] =
            reinterpret_cast<const float4*>(src)[e];
    } else {
      for (int e = threadIdx.x; e < s.row_len; e += blockDim.x) dst[e] = src[e];
    }
  };

  // samples lo .. lo + depth - 1 in flight before the first is summed; each
  // later one is issued once the sample before it is summed, into its slot
  for (int j = 0; j < depth; ++j)
    if (lo + j < hi) issue(lo + j, j);
    else cp_async_commit();
  const int in_flight = blockDim.x / KS;
  const int ks = threadIdx.x % KS;
  const int rounds = (s.tiles + in_flight - 1) / in_flight;
  for (int b = lo; b < hi; ++b) {
    const int k = (b - lo) % s.slots;
    // the last sample's tiles are summed and its staged row leaves
    if (b > lo) __syncthreads();
    if (staged && b > lo) copy_out((b - 1 - lo) % s.slots, b - 1);
    if (depth == 0) issue(b, k);
    cp_async_wait_all();
    if (vec && (kBf16<Bot> || kBf16<Pooled>))
      for (int e = threadIdx.x; e < per_sample; e += blockDim.x) {
        const int r = e / s.nc, c = e - r * s.nc;
        if (r == 0 ? kBf16<Bot> : kBf16<Pooled>)
          a[k * a_slot + r * s.ldc + (c ^ swizzle<KS>(r / kTile))] =
              widen(raw[(size_t)k * s.raw_slot + e]);
      }
    __syncthreads();

    const float4* ak = a + k * a_slot;
    float* row = staged ? stage + (size_t)k * s.row_len
                        : out + (long long)b * s.row_len;
    // bot_out's row, the first d columns
    for (int c = threadIdx.x; c < s.nc; c += blockDim.x) {
      const float4 v = ak[c];
      const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (4 * c + q < s.dim) row[4 * c + q] = x[q];
    }
    // the tiles, KS lanes a tile; lanes past the last tile sit out
    for (int round = 0; round < rounds; ++round) {
      const int t = round * in_flight + threadIdx.x / KS;
      const bool active = t < s.tiles;
      const unsigned mask = __ballot_sync(0xffffffffu, active);
      if (!active) continue;
      int I = (int)((sqrtf(8.f * (float)t + 1.f) - 1.f) * 0.5f);
      while (I * (I + 1) / 2 > t) --I;
      while ((I + 1) * (I + 2) / 2 <= t) ++I;
      const int J = t - I * (I + 1) / 2;
      const float4* ai = ak + I * kTile * s.ldc;
      const float4* aj = ak + J * kTile * s.ldc;
      const int si = swizzle<KS>(I), sj = swizzle<KS>(J);
      float acc[kTile][kTile];
#pragma unroll
      for (int m = 0; m < kTile; ++m)
#pragma unroll
        for (int q = 0; q < kTile; ++q) acc[m][q] = 0.f;
      // the next chunk's 8 float4 are read while this one's 64 FMAs run;
      // at d <= 4 lane 1 reads nothing and adds zeros
      float4 x[kTile], y[kTile];
      if (ks < s.nc)
#pragma unroll
        for (int q = 0; q < kTile; ++q) {
          x[q] = ai[q * s.ldc + (ks ^ si)];
          y[q] = aj[q * s.ldc + (ks ^ sj)];
        }
#pragma unroll 1
      for (int c = ks; c < s.nc; c += KS) {
        float4 xn[kTile], yn[kTile];
        const int cn = c + KS < s.nc ? c + KS : c;
#pragma unroll
        for (int q = 0; q < kTile; ++q) {
          xn[q] = ai[q * s.ldc + (cn ^ si)];
          yn[q] = aj[q * s.ldc + (cn ^ sj)];
        }
#pragma unroll
        for (int m = 0; m < kTile; ++m)
#pragma unroll
          for (int q = 0; q < kTile; ++q)
            acc[m][q] = dot4(x[m], y[q], acc[m][q]);
#pragma unroll
        for (int q = 0; q < kTile; ++q) {
          x[q] = xn[q];
          y[q] = yn[q];
        }
      }
      // a tile's KS lanes are all active or all idle: the mask holds them
#pragma unroll
      for (int o = KS / 2; o > 0; o /= 2)
#pragma unroll
        for (int m = 0; m < kTile; ++m)
#pragma unroll
          for (int q = 0; q < kTile; ++q)
            acc[m][q] += __shfl_xor_sync(mask, acc[m][q], o);
#pragma unroll
      for (int m = 0; m < kTile; ++m)
#pragma unroll
        for (int q = 0; q < kTile; ++q) {
          const int i = I * kTile + m, j = J * kTile + q;
          if ((m * kTile + q) % KS == ks && i < s.s1 && j < i)
            row[s.dim + i * (i - 1) / 2 + j] = acc[m][q];
        }
    }
    // sample b's slot is read by this thread only; sample b - 1's, free
    // since the barrier above, takes sample b + depth
    if (depth > 0) {
      if (b + depth < hi) issue(b + depth, (b + depth - lo) % s.slots);
      else cp_async_commit();
    }
  }
  if (staged && hi > lo) {
    __syncthreads();
    copy_out((hi - 1 - lo) % s.slots, hi - 1);
  }
}

__global__ void empty_kernel() {}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Shared memory of one slot, rounded to 16 bytes: A, the raw cells bf16
// rows land in, and the output row when staged.
size_t slot_smem(const Shape& s, bool staged) {
  const size_t bytes = (size_t)s.rows * s.ldc * sizeof(float4) +
                       (size_t)s.raw_slot * sizeof(uint2) +
                       (staged ? (size_t)s.row_len * sizeof(float) : 0);
  return (bytes + 15) / 16 * 16;
}

template <typename Bot, typename Pooled, int KS>
int launch_ks(const Bot* bot, const Pooled* pooled, float* out, int batch,
              Shape s, bool vec, bool vec_out, int device, int sms,
              cudaStream_t stream) {
  auto kernel = interactions_kernel<Bot, Pooled, KS>;
  // blocks an SM at (threads, shared memory), kept for the last query of
  // this instance: the main path asks once
  static struct {
    int device = -1, threads = 0, per_sm = 0;
    size_t smem = 0;
  } occ;
  auto per_sm = [&](int threads, size_t smem, int* n) {
    if (occ.device == device && occ.threads == threads && occ.smem == smem) {
      *n = occ.per_sm;
      return cudaSuccess;
    }
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemMax);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, kernel, threads,
                                                          smem);
    if (err == cudaSuccess) occ = {device, threads, *n, smem};
    return err;
  };
  // beside A, as far as they fit: the raw cells bf16 rows land in (else
  // scalar loads), then the staged output row (else stores from registers)
  s.raw_slot = vec && (kBf16<Bot> || kBf16<Pooled>)
                   ? (s.s1 * s.nc + 1) / 2 * 2 : 0;
  if (s.raw_slot > 0 && slot_smem(s, false) > kSmemMax) {
    s.raw_slot = 0;
    vec = false;
  }
  const bool staged = slot_smem(s, true) <= kSmemMax;
  const size_t per = slot_smem(s, staged);
  if (per > kSmemMax) return (int)cudaErrorInvalidValue;
  s.slots = (kDepth + 1) * per <= kSmemMax ? kDepth + 1 : 1;
  const int threads = std::min(kMaxThreads, (s.tiles * KS + 31) / 32 * 32);
  int n = 0;
  cudaError_t err = per_sm(threads, s.slots * per, &n);
  if (err != cudaSuccess) return (int)err;
  const long long resident = (long long)n * sms;
  if (resident == 0) return (int)cudaErrorInvalidValue;
  // each block an even share of the samples, kDepth of them loading while
  // it sums one; a sample a block when the batch fits one wave
  if (batch <= resident) s.slots = 1;
  const int blocks = (int)std::min<long long>(batch, resident);
  s.share = batch / blocks;
  s.extra = batch % blocks;
  kernel<<<blocks, threads, s.slots * per, stream>>>(
      bot, pooled, out, s, (int)vec, (int)staged, (int)vec_out);
  return (int)cudaGetLastError();
}

template <typename Bot, typename Pooled>
int launch(const void* bot_v, const void* pooled_v, void* out_v, int batch,
           int n_tables, int dim, cudaStream_t stream) {
  const Bot* bot = static_cast<const Bot*>(bot_v);
  const Pooled* pooled = static_cast<const Pooled*>(pooled_v);
  float* out = static_cast<float*>(out_v);
  Shape s;
  s.n_tables = n_tables;
  s.dim = dim;
  s.s1 = n_tables + 1;
  s.nc = (dim + 3) / 4;
  s.ldc = (s.nc + 7) / 8 * 8;
  s.rows = (s.s1 + kTile - 1) / kTile * kTile;
  const int ni = s.rows / kTile;
  s.tiles = ni * (ni + 1) / 2;
  s.row_len = dim + s.s1 * (s.s1 - 1) / 2;
  s.raw_slot = 0;
  s.slots = 1;

  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;

  // whole 16-byte chunks (8-byte for bf16) when d is a multiple of 4 and
  // both inputs are aligned; a sample's rows then stay aligned (4k elements)
  const bool vec = dim % 4 == 0 && aligned(bot, 4 * sizeof(Bot)) &&
                   aligned(pooled, 4 * sizeof(Pooled));
  const bool vec_out = s.row_len % 4 == 0 && aligned(out, 16);
  // 4 lanes a tile while the batch leaves the card's threads idle, else 2
  if (s.nc >= kMaxKs &&
      (long long)batch * s.tiles * kMaxKs <= (long long)kThreadsPerSm * sms)
    return launch_ks<Bot, Pooled, 4>(bot, pooled, out, batch, s, vec,
                                     vec_out, device, sms, stream);
  return launch_ks<Bot, Pooled, 2>(bot, pooled, out, batch, s, vec, vec_out,
                                   device, sms, stream);
}

}  // namespace

// bot (B, d) and pooled (B, T, d), each fp32 or bf16 -> out (B, d + T(T+1)/2)
// fp32.
extern "C" int interactions_launch(const void* bot, int bot_bf16,
                                   const void* pooled, int pooled_bf16,
                                   void* out, int batch, int n_tables,
                                   int dim, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bot_bf16 && pooled_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(bot, pooled, out, batch,
                                                 n_tables, dim, s);
  if (bot_bf16)
    return launch<__nv_bfloat16, float>(bot, pooled, out, batch, n_tables,
                                        dim, s);
  if (pooled_bf16)
    return launch<float, __nv_bfloat16>(bot, pooled, out, batch, n_tables,
                                        dim, s);
  return launch<float, float>(bot, pooled, out, batch, n_tables, dim, s);
}

// One empty block: the least device time a launch takes, the floor that
// row 7's time at a small batch is read against (chip_smoke.py).
extern "C" int interactions_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

extern "C" const char* interactions_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
