// Embedding bags for Hopper (sm_90a): gather + sum-pool, one launch.
// Three entry points share one per-row pooling body:
//
//   embedding_bag_launch replaces the TPU kernel `embedding_bag_pallas`
//   (src/repro/kernels/embedding_bag.py:45):
//     out[b, t] = sum_l tables[t, ids[b, t, l]]                 (fp32)
//
//   cached_embedding_bag_launch replaces `cached_embedding_bag_pallas`
//   (src/repro/kernels/cached_embedding_bag.py:47), the tiered store's
//   two-tier bag over pre-translated slots:
//     out[b, t] = sum_l fast[t, fast_ids[b, t, l]]
//               + sum_l bulk[t, bulk_ids[b, t, l]]              (fp32)
//   Both rows of every lookup are read and summed, as in the reference: the
//   kernel does not assume that the pad slot (S or R) holds zeros.
//
//   embedding_bag_blocked_launch replaces `embedding_bag_pallas_blocked`
//   (src/repro/kernels/embedding_bag.py:107): the same bag, read a block of
//   `lblk` consecutive rows at a time when the whole id stream is ALIGNED,
//   i.e. every L-block of lblk lookups is exactly the rows
//   [k*lblk, (k+1)*lblk) of its table (`blocked_stream_aligned`, :90); any
//   other stream pools the whole batch row by row, as row 4 does. A block
//   that passes the reference's predicate but reaches past the table (base
//   a multiple of lblk, base + lblk > R) counts as NOT aligned here, so its
//   answer is `embedding_bag_ref`'s (NaN for the rows past R) and never a
//   read out of bounds. The predicate is computed on the device: a check
//   kernel clears or sets one flag, and the pooling kernel reads it, so the
//   launch never waits for the host.
//
// What bounds them: device-memory bytes. At the RM2-small shape (B=200, T=40,
// L=80, d=32, fp32) one call gathers 640,000 128-byte rows (81.9 MB; twice
// that for the two-tier bag) against 20 FLOP a row: nothing but the row
// reads matter, and random rows do not stream or stay in the 50 MB L2.
//
// Design: one warp per (b, t) bag, 8 bags a block, so B*T bags spread over
// all 132 SMs at any batch (8,000 warps at B=200). Row by row, a lane owns V
// adjacent columns of d: at d=32 fp32 a row is one coalesced 128-byte read;
// when d is a multiple of 128 each lane issues 16-byte (fp32) or 8-byte
// (bf16) vector loads. The warp loads 32 ids at once and broadcasts them
// with shuffles, and the unrolled l loop keeps several row reads in flight.
// Block by block, a block is lblk*d contiguous elements (1 KB at lblk=8,
// d=32 fp32): d/4 lanes span a row with 16-byte (fp32) or 8-byte (bf16)
// loads, the other lanes of the warp take the block's other rows (two
// loads a lane a block at d=32, lblk=8), and a shuffle reduction over the
// lanes that hold the same columns gives the block's sum; the block loop
// is unrolled 4 deep so that later blocks' loads are in flight during
// earlier blocks' reductions. As in the reference, a block of bf16 rows
// sums to one bf16 value before the fp32 sum over blocks. Other d take
// scalar loads.
// Ids follow jnp.take: a negative id counts from the end of its table, and
// an id outside [-rows, rows) reads as NaN rather than out of bounds. Row
// offsets are 64-bit: 40 x 4,194,304 x 32 elements overflow int32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;

template <typename Row, int V>
struct RowLoad;

template <>
struct RowLoad<float, 1> {
  static __device__ __forceinline__ void run(const float* p, float* v) {
    v[0] = __ldg(p);
  }
};

template <>
struct RowLoad<float, 4> {
  static __device__ __forceinline__ void run(const float* p, float* v) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
};

template <>
struct RowLoad<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void run(const __nv_bfloat16* p,
                                             float* v) {
    v[0] = __bfloat162float(p[0]);
  }
};

template <>
struct RowLoad<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void run(const __nv_bfloat16* p,
                                             float* v) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 lo = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&x.x));
    const float2 hi = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&x.y));
    v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
  }
};

// Adds sum_l tab[ids[l], k .. k+V) into acc[0 .. V). Every lane of the warp
// calls it (the shuffles need all 32); `active` lanes load.
template <typename Row, int V>
__device__ __forceinline__ void pool(const Row* __restrict__ tab,
                                     long long n_rows,
                                     const int32_t* __restrict__ ids,
                                     int n_lookups, int dim, int k,
                                     bool active, int lane, float* acc) {
  const float nan = __int_as_float(0x7fc00000);
  for (int l0 = 0; l0 < n_lookups; l0 += 32) {
    const int n = min(32, n_lookups - l0);
    const int mine = lane < n ? ids[l0 + lane] : 0;
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      long long r = __shfl_sync(0xffffffffu, mine, j);
      if (r < 0) r += n_rows;
      float v[V];
      if (r >= 0 && r < n_rows) {
        if (active) RowLoad<Row, V>::run(tab + r * dim + k, v);
      } else {
#pragma unroll
        for (int u = 0; u < V; ++u) v[u] = nan;
      }
      if (active) {
#pragma unroll
        for (int u = 0; u < V; ++u) acc[u] += v[u];
      }
    }
  }
}

// Pools bag (b, t) = `bag` row by row into out[bag]. Tier a is always read;
// tier b (the bulk tier of the two-tier bag) when `tab_b` is not null. All
// 32 lanes of the warp call it.
template <typename Row, int V>
__device__ __forceinline__ void pool_bag(
    const Row* __restrict__ tab_a, long long rows_a,
    const int32_t* __restrict__ ids_a, const Row* __restrict__ tab_b,
    long long rows_b, const int32_t* __restrict__ ids_b,
    float* __restrict__ out, long long bag, int n_tables, int n_lookups,
    int dim, int lane) {
  const int t = (int)(bag % n_tables);
  const long long id_off = bag * n_lookups;
  const Row* ta = tab_a + (long long)t * rows_a * dim;
  const Row* tb = tab_b == nullptr ? nullptr
                                   : tab_b + (long long)t * rows_b * dim;
  float* out_bag = out + bag * dim;
  for (int k0 = 0; k0 < dim; k0 += 32 * V) {
    const int k = k0 + lane * V;
    const bool active = k < dim;
    float sa[V], sb[V];
#pragma unroll
    for (int u = 0; u < V; ++u) sa[u] = sb[u] = 0.f;
    pool<Row, V>(ta, rows_a, ids_a + id_off, n_lookups, dim, k, active, lane,
                 sa);
    if (tb != nullptr)
      pool<Row, V>(tb, rows_b, ids_b + id_off, n_lookups, dim, k, active,
                   lane, sb);
    if (active) {
#pragma unroll
      for (int u = 0; u < V; ++u) out_bag[k + u] = sa[u] + sb[u];
    }
  }
}

// Bag (b, t) = blockIdx.x * kWarpsPerBlock + warp.
template <typename Row, int V>
__global__ void __launch_bounds__(kWarpsPerBlock * 32) embedding_bag_kernel(
    const Row* __restrict__ tab_a, long long rows_a,
    const int32_t* __restrict__ ids_a, const Row* __restrict__ tab_b,
    long long rows_b, const int32_t* __restrict__ ids_b,
    float* __restrict__ out, long long n_bags, int n_tables, int n_lookups,
    int dim) {
  const long long bag =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (bag >= n_bags) return;  // uniform across the warp
  pool_bag<Row, V>(tab_a, rows_a, ids_a, tab_b, rows_b, ids_b, out, bag,
                   n_tables, n_lookups, dim, threadIdx.x & 31);
}

// One thread an id: sets *misaligned when the id's L-block is not the rows
// [base, base + lblk) of its table with base a multiple of lblk and base +
// lblk <= n_rows. L % lblk == 0, so a block never straddles two bags and
// its first id sits at i - i % lblk of the flat (B, T, L) stream. Every
// writer writes the same 1.
__global__ void blocked_check_kernel(const int32_t* __restrict__ ids,
                                     long long n_ids, int lblk,
                                     long long n_rows, int* misaligned) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_ids) return;
  const int j = (int)(i % lblk);
  const long long base = ids[i - j];
  const bool ok = base >= 0 && base % lblk == 0 && base + lblk <= n_rows &&
                  (long long)ids[i] == base + j;
  if (!ok) *misaligned = 1;
}

// A block's sum in the tables' dtype: the reference sums a block of bf16
// rows into one bf16 value (`rows_ref[...].sum(axis=1)`) before the fp32
// accumulation.
__device__ __forceinline__ float block_sum_as(float x, const float*) {
  return x;
}
__device__ __forceinline__ float block_sum_as(float x,
                                              const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

// Pools one bag of an aligned stream: block k is the rows [base_k, base_k +
// lblk) of `tab` (one table), base_k = ids[k * lblk]. A row is nv = dim / V
// vectors; `span` lanes cover one row (nv when nv divides 32, else 32 lanes
// walk the row in steps of 32 vectors) and the warp's 32 / span lane groups
// take a block's rows in turn. Each block's sum is reduced across the
// groups by shuffles, rounded as block_sum_as says, and added in L order.
// All 32 lanes call it.
template <typename Row, int V>
__device__ __forceinline__ void pool_blocks(const Row* __restrict__ tab,
                                            const int32_t* __restrict__ ids,
                                            int n_lookups, int lblk, int dim,
                                            int lane,
                                            float* __restrict__ out_bag) {
  const int nv = dim / V;
  const int span = (nv <= 32 && 32 % nv == 0) ? nv : 32;
  const int groups = 32 / span;
  const int cv = lane % span, rg = lane / span;
  const int rows_per_lane = (lblk + groups - 1) / groups;
  const int n_blocks = n_lookups / lblk;
  for (int c0 = 0; c0 < nv; c0 += span) {
    const int c = c0 + cv;
    const bool active = c < nv;
    const Row* col = tab + (long long)c * V;
    float acc[V];
#pragma unroll
    for (int w = 0; w < V; ++w) acc[w] = 0.f;
    for (int k0 = 0; k0 < n_blocks; k0 += 32) {
      const int nb = min(32, n_blocks - k0);
      const int mine = lane < nb ? ids[(long long)(k0 + lane) * lblk] : 0;
      // unrolled, so later blocks' loads issue before earlier reductions
#pragma unroll 4
      for (int k = 0; k < nb; ++k) {
        const long long base = __shfl_sync(0xffffffffu, mine, k);
        float s[V];
#pragma unroll
        for (int w = 0; w < V; ++w) s[w] = 0.f;
#pragma unroll 2
        for (int i = 0; i < rows_per_lane; ++i) {
          const int j = rg + groups * i;
          if (active && j < lblk) {
            float v[V];
            RowLoad<Row, V>::run(col + (base + j) * dim, v);
#pragma unroll
            for (int w = 0; w < V; ++w) s[w] += v[w];
          }
        }
        // lanes lane ^ span, lane ^ 2 span, ... hold the same columns
        for (int off = span; off < 32; off <<= 1) {
#pragma unroll
          for (int w = 0; w < V; ++w)
            s[w] += __shfl_xor_sync(0xffffffffu, s[w], off);
        }
#pragma unroll
        for (int w = 0; w < V; ++w) acc[w] += block_sum_as(s[w], tab);
      }
    }
    if (active && rg == 0) {
#pragma unroll
      for (int w = 0; w < V; ++w) out_bag[c * V + w] = acc[w];
    }
  }
}

// Bag (b, t) = blockIdx.x * kWarpsPerBlock + warp. The flag written by
// blocked_check_kernel picks the branch for the whole batch: VB is the
// vector width of the blocked branch, VR that of the per-row one (row 4's).
template <typename Row, int VB, int VR>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    embedding_bag_blocked_kernel(const Row* __restrict__ tab,
                                 long long n_rows,
                                 const int32_t* __restrict__ ids,
                                 const int* __restrict__ misaligned,
                                 float* __restrict__ out, long long n_bags,
                                 int n_tables, int n_lookups, int dim,
                                 int lblk) {
  const int lane = threadIdx.x & 31;
  const long long bag =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (bag >= n_bags) return;  // uniform across the warp
  if (*misaligned) {
    pool_bag<Row, VR>(tab, n_rows, ids, nullptr, 0, nullptr, out, bag,
                      n_tables, n_lookups, dim, lane);
    return;
  }
  const int t = (int)(bag % n_tables);
  pool_blocks<Row, VB>(tab + (long long)t * n_rows * dim,
                       ids + bag * n_lookups, n_lookups, lblk, dim, lane,
                       out + bag * dim);
}

template <typename Row>
int launch(const void* tab_a, long long rows_a, const void* ids_a,
           const void* tab_b, long long rows_b, const void* ids_b, void* out,
           int batch, int n_tables, int n_lookups, int dim,
           cudaStream_t stream) {
  const long long n_bags = (long long)batch * n_tables;
  const long long blocks = (n_bags + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks), block(kWarpsPerBlock * 32);
  const Row* a = static_cast<const Row*>(tab_a);
  const Row* b = static_cast<const Row*>(tab_b);
  const int32_t* ia = static_cast<const int32_t*>(ids_a);
  const int32_t* ib = static_cast<const int32_t*>(ids_b);
  float* o = static_cast<float*>(out);
  if (dim % 128 == 0)
    embedding_bag_kernel<Row, 4><<<grid, block, 0, stream>>>(
        a, rows_a, ia, b, rows_b, ib, o, n_bags, n_tables, n_lookups, dim);
  else
    embedding_bag_kernel<Row, 1><<<grid, block, 0, stream>>>(
        a, rows_a, ia, b, rows_b, ib, o, n_bags, n_tables, n_lookups, dim);
  return (int)cudaGetLastError();
}

template <typename Row>
int launch_blocked(const void* tables, long long n_rows, const void* ids,
                   void* misaligned, void* out, int batch, int n_tables,
                   int n_lookups, int dim, int lblk, cudaStream_t stream) {
  if (lblk < 1 || n_lookups % lblk != 0)
    return (int)cudaErrorInvalidValue;
  const long long n_bags = (long long)batch * n_tables;
  const long long n_ids = n_bags * n_lookups;
  const long long blocks = (n_bags + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const long long check_blocks = (n_ids + 255) / 256;
  if (blocks > 0x7fffffffLL || check_blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  int* flag = static_cast<int*>(misaligned);
  cudaError_t err = cudaMemsetAsync(flag, 0, sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  const int32_t* id = static_cast<const int32_t*>(ids);
  blocked_check_kernel<<<(unsigned)check_blocks, 256, 0, stream>>>(
      id, n_ids, lblk, n_rows, flag);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const Row* tab = static_cast<const Row*>(tables);
  float* o = static_cast<float*>(out);
  const bool vec_block =
      dim % 4 == 0 &&
      reinterpret_cast<uintptr_t>(tables) % (4 * sizeof(Row)) == 0;
  const bool vec_row = dim % 128 == 0;   // as launch() picks for row 4
  const dim3 grid((unsigned)blocks), block(kWarpsPerBlock * 32);
#define BLOCKED(VB, VR)                                                     \
  embedding_bag_blocked_kernel<Row, VB, VR><<<grid, block, 0, stream>>>(   \
      tab, n_rows, id, flag, o, n_bags, n_tables, n_lookups, dim, lblk)
  if (vec_block && vec_row) BLOCKED(4, 4);
  else if (vec_block) BLOCKED(4, 1);
  else if (vec_row) BLOCKED(1, 4);
  else BLOCKED(1, 1);
#undef BLOCKED
  return (int)cudaGetLastError();
}

}  // namespace

// tables (T, R, d), ids (B, T, L) int32 -> out (B, T, d) fp32.
extern "C" int embedding_bag_launch(const void* tables, int tables_bf16,
                                    long long n_rows, const void* ids,
                                    void* out, int batch, int n_tables,
                                    int n_lookups, int dim, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tables_bf16)
    return launch<__nv_bfloat16>(tables, n_rows, ids, nullptr, 0, nullptr,
                                 out, batch, n_tables, n_lookups, dim, s);
  return launch<float>(tables, n_rows, ids, nullptr, 0, nullptr, out, batch,
                       n_tables, n_lookups, dim, s);
}

// fast (T, S+1, d), bulk (T, R+1, d) of one dtype; fast_ids, bulk_ids
// (B, T, L) int32 -> out (B, T, d) fp32.
extern "C" int cached_embedding_bag_launch(
    const void* fast, const void* bulk, int tables_bf16, long long fast_rows,
    long long bulk_rows, const void* fast_ids, const void* bulk_ids,
    void* out, int batch, int n_tables, int n_lookups, int dim,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tables_bf16)
    return launch<__nv_bfloat16>(fast, fast_rows, fast_ids, bulk, bulk_rows,
                                 bulk_ids, out, batch, n_tables, n_lookups,
                                 dim, s);
  return launch<float>(fast, fast_rows, fast_ids, bulk, bulk_rows, bulk_ids,
                       out, batch, n_tables, n_lookups, dim, s);
}

// tables (T, R, d), ids (B, T, L) int32 with L % lblk == 0, misaligned one
// int32 of scratch -> out (B, T, d) fp32; *misaligned ends as 1 when the
// stream took the per-row branch, else 0.
extern "C" int embedding_bag_blocked_launch(const void* tables,
                                            int tables_bf16, long long n_rows,
                                            const void* ids, void* misaligned,
                                            void* out, int batch,
                                            int n_tables, int n_lookups,
                                            int dim, int lblk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tables_bf16)
    return launch_blocked<__nv_bfloat16>(tables, n_rows, ids, misaligned,
                                         out, batch, n_tables, n_lookups,
                                         dim, lblk, s);
  return launch_blocked<float>(tables, n_rows, ids, misaligned, out, batch,
                               n_tables, n_lookups, dim, lblk, s);
}

extern "C" const char* embedding_bag_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
