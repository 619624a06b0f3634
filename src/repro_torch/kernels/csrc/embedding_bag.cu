// Embedding bags for Hopper (sm_90a): gather + sum-pool, one launch.
// Two entry points share one kernel:
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
// What bounds it: device-memory bytes. At the RM2-small shape (B=200, T=40,
// L=80, d=32, fp32) one call gathers 640,000 random 128-byte rows (81.9 MB;
// twice that for the two-tier bag) against 20 FLOP a row: nothing but the
// row reads matter, and random rows do not stream or stay in the 50 MB L2.
//
// Design: one warp per (b, t) bag, 8 bags a block, so B*T bags spread over
// all 132 SMs at any batch (8,000 warps at B=200). A lane owns V adjacent
// columns of d: at d=32 fp32 a row is one coalesced 128-byte read; when d
// is a multiple of 128 each lane issues 16-byte (fp32) or 8-byte (bf16)
// vector loads. The warp loads 32 ids at once and broadcasts them with
// shuffles, and the unrolled l loop keeps several row reads in flight.
// Ids follow jnp.take: a negative id counts from the end of its table, and
// an id outside [-rows, rows) reads as NaN rather than out of bounds. Row
// offsets are 64-bit: 40 x 4,194,304 x 32 elements overflow int32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// Bag (b, t) = blockIdx.x * kWarpsPerBlock + warp. Tier a is always read;
// tier b (the bulk tier of the two-tier bag) when `tab_b` is not null.
template <typename Row, int V>
__global__ void __launch_bounds__(kWarpsPerBlock * 32) embedding_bag_kernel(
    const Row* __restrict__ tab_a, long long rows_a,
    const int32_t* __restrict__ ids_a, const Row* __restrict__ tab_b,
    long long rows_b, const int32_t* __restrict__ ids_b,
    float* __restrict__ out, long long n_bags, int n_tables, int n_lookups,
    int dim) {
  const int lane = threadIdx.x & 31;
  const long long bag =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (bag >= n_bags) return;  // uniform across the warp
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

extern "C" const char* embedding_bag_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
