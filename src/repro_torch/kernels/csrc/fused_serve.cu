// Fused DLRM serve hot path for Hopper (sm_90a): gather -> sum-pool ->
// pairwise feature interaction, one launch. Three entry points share one
// kernel:
//
//   fused_bag_interactions_launch replaces the TPU kernel
//   `fused_bag_interactions_pallas` (src/repro/kernels/fused_serve.py:134):
//   one stacked group of tables.
//
//   fused_grouped_bag_interactions_launch replaces
//   `fused_grouped_bag_interactions_pallas` (fused_serve.py:244): the
//   tiered plan's two table groups, fast (Tf, Rf, d) and bulk (Tb, Rb, d),
//   with ids already permuted to concat(fast, bulk) order. Table t of that
//   order reads its row from the fast group if t < Tf, else from the bulk
//   group: only the owning group's row is read (the TPU kernel fetched a
//   clamped row from both groups every step, an artifact of its BlockSpecs).
//   The output is in the ORIGINAL table order: feature i of the original
//   order (0 = bot_out, 1 + table) lives in accumulator slot pos[i], with
//   pos = [0] + [1 + inv_perm], so the pair loop reads slots pos[i], pos[j]
//   and the reference's un-permuting gather (`_finalize(inv_perm=...)`)
//   costs nothing. An empty group (Tf = 0 or Tb = 0) is the same kernel.
//
//   fused_cached_bag_interactions_launch replaces
//   `fused_cached_bag_interactions_pallas` (fused_serve.py:181): the tiered
//   store's two tiers, fast (T, S+1, d) and bulk (T, R+1, d), with
//   pre-translated ids fast_ids and bulk_ids (B, T, L). Every lookup reads
//   BOTH rows, fast[t, fast_ids] and bulk[t, bulk_ids], each id against its
//   own tier's row count; the two are pooled apart and added, in the order
//   of the reference (cached_embedding_bag_ref, then interactions). The
//   kernel does not skip the pad slot on the assumption that it is zero.
//
// Computes, per sample b:
//   A[0]   = bot_out[b]
//   A[1+t] = sum_l tables[t, ids[b, t, l]]             (fp32, in l order;
//            two tiers: sum_l fast[..] + sum_l bulk[..])
//   out[b] = [bot_out[b] | A[pos[i]].A[pos[j]] for (i, j) in
//             tril_indices(T+1, -1)]                    (pos = identity
//                                                        for one group)
// with the strict lower triangle in numpy's row-major order, so the static
// gather the TPU kernel ran outside its launch (`_finalize`) is folded in
// and no (B, T+1, T+1) matrix is ever written.
//
// What bounds it (every entry point): device-memory bytes. At the
// RM2-small serve shape (B=200, T=40, L=80, d=32, fp32) one query gathers
// 640,000 random 128-byte rows (81.9 MB) and reads 2.56 MB of ids, against
// 10.5 MFLOP of contraction: about 0.1 FLOP per byte, far below the
// ~20 FLOP/byte at which fp32 CUDA-core math would bound it. The rows are
// random, so the 50 MB L2 does not help. Under the planner's default depth
// a 200-sample query runs as 8 launches of 25 samples: 25 blocks on 132
// SMs, so at that shape too few rows are in flight to near the bound.
// The two-tier entry point reads two rows a lookup, twice the bytes.
//
// Design: one block per sample, so there is no batch padding. The
// (T+1) x d fp32 accumulator lives in shared memory (5.4 KB at d=32) and
// never touches device memory. Warp w pools tables t = w (mod warps): a
// lane owns one column of d, so each gathered row is one coalesced read
// (128 B at d=32 fp32); the warp loads 32 ids at once and broadcasts them
// with shuffles, and the unrolled l loop keeps several row reads in flight
// per warp. After one barrier, each thread computes whole pair dot products
// from shared memory, with the accumulator rows padded to d+1 floats so
// the lanes of a warp hit distinct banks. Ids follow jnp.take: a negative
// id counts from the end of the table, and an id outside [-R, R) reads as
// NaN rather than out of bounds.
//
// What this design leaves on the table (later work): more rows in flight
// per warp (cp.async / TMA gathers into a shared ring), several samples
// per block to fill 132 SMs at small B, and vector loads at d=128.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

// Row r of a table of n_rows rows, column k, as jnp.take reads it: a
// negative id counts from the end, an id outside [-n_rows, n_rows) is NaN.
template <typename Row>
__device__ __forceinline__ float take(const Row* tab, long long n_rows,
                                      long long r, int k, int dim) {
  if (r < 0) r += n_rows;
  if (r < 0 || r >= n_rows) return __int_as_float(0x7fc00000);
  return k < dim ? to_f32(tab[r * dim + k]) : 0.f;
}

// Tables 0..n_fast-1 of the kernel order live in `fast` (fast_rows rows
// each), the rest in `bulk` (bulk_rows rows each). `pos` (T+1 entries) maps
// an output feature to its accumulator slot; nullptr means the identity.
// kTwoTier: every table lives in both (n_fast = T), and lookup l of table t
// reads fast[t, ids] and bulk[t, ids2].
template <typename Row, bool kTwoTier>
__global__ void fused_bag_interactions_kernel(
    const Row* __restrict__ fast, long long fast_rows, int n_fast,
    const Row* __restrict__ bulk, long long bulk_rows,
    const int32_t* __restrict__ pos, const int32_t* __restrict__ ids,
    const int32_t* __restrict__ ids2, const float* __restrict__ bot,
    float* __restrict__ out, int n_tables, int n_lookups, int dim) {
  extern __shared__ float acc[];  // (T+1) rows of `ld` floats, then pos
  const int ld = dim + 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const long long b = blockIdx.x;
  const int s1 = n_tables + 1;
  float* out_b = out + b * (dim + s1 * (s1 - 1) / 2);
  int* slot = reinterpret_cast<int*>(acc + s1 * ld);

  for (int i = threadIdx.x; i < s1; i += blockDim.x)
    slot[i] = pos == nullptr ? i : pos[i];
  for (int k = threadIdx.x; k < dim; k += blockDim.x) {
    const float v = bot[b * dim + k];
    acc[k] = v;
    out_b[k] = v;
  }

  const long long ids_b = b * n_tables * n_lookups;
  for (int t = warp; t < n_tables; t += n_warps) {
    const bool in_fast = kTwoTier || t < n_fast;
    const long long n_rows = in_fast ? fast_rows : bulk_rows;
    const Row* tab = in_fast ? fast + (long long)t * fast_rows * dim
                             : bulk + (long long)(t - n_fast) * bulk_rows * dim;
    const Row* tab2 = bulk + (long long)t * bulk_rows * dim;  // kTwoTier
    const long long ids_t = ids_b + (long long)t * n_lookups;
    for (int k0 = 0; k0 < dim; k0 += 32) {
      const int k = k0 + lane;
      float s = 0.f, s2 = 0.f;
      for (int l0 = 0; l0 < n_lookups; l0 += 32) {
        const int n = min(32, n_lookups - l0);
        const int mine = lane < n ? ids[ids_t + l0 + lane] : 0;
        int mine2 = 0;
        if constexpr (kTwoTier)
          mine2 = lane < n ? ids2[ids_t + l0 + lane] : 0;
#pragma unroll 8
        for (int j = 0; j < n; ++j) {
          s += take(tab, n_rows, __shfl_sync(0xffffffffu, mine, j), k, dim);
          if constexpr (kTwoTier)
            s2 += take(tab2, bulk_rows, __shfl_sync(0xffffffffu, mine2, j), k,
                       dim);
        }
      }
      if (k < dim) acc[(t + 1) * ld + k] = kTwoTier ? s + s2 : s;
    }
  }
  __syncthreads();
  write_pairs(acc, ld, slot, s1, dim, out_b + dim);
}

template <typename Row, bool kTwoTier = false>
int launch(const void* fast, long long fast_rows, int n_fast,
           const void* bulk, long long bulk_rows, const void* pos,
           const void* ids, const void* ids2, const void* bot, void* out,
           int batch, int n_tables, int n_lookups, int dim,
           cudaStream_t stream) {
  // ceil(T / 32) tables a warp, and as few warps as that allows, so the
  // tables spread evenly (T=40: 20 warps of 2 tables).
  const int tables_per_warp = (n_tables + 31) / 32;
  const int n_warps = (n_tables + tables_per_warp - 1) / tables_per_warp;
  const size_t smem = (size_t)(n_tables + 1) * (dim + 1) * sizeof(float) +
                      (size_t)(n_tables + 1) * sizeof(int);
  auto kernel = fused_bag_interactions_kernel<Row, kTwoTier>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<batch, n_warps * 32, smem, stream>>>(
      static_cast<const Row*>(fast), fast_rows, n_fast,
      static_cast<const Row*>(bulk), bulk_rows,
      static_cast<const int32_t*>(pos), static_cast<const int32_t*>(ids),
      static_cast<const int32_t*>(ids2), static_cast<const float*>(bot),
      static_cast<float*>(out), n_tables, n_lookups, dim);
  return (int)cudaGetLastError();
}

}  // namespace

// One stacked group: tables (T, R, d).
extern "C" int fused_bag_interactions_launch(
    const void* tables, int tables_bf16, const void* ids, const void* bot,
    void* out, int batch, int n_tables, long long n_rows, int n_lookups,
    int dim, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tables_bf16)
    return launch<__nv_bfloat16>(tables, n_rows, n_tables, nullptr, 0,
                                 nullptr, ids, nullptr, bot, out, batch,
                                 n_tables, n_lookups, dim, s);
  return launch<float>(tables, n_rows, n_tables, nullptr, 0, nullptr, ids,
                       nullptr, bot, out, batch, n_tables, n_lookups, dim, s);
}

// Two groups: fast (n_fast, fast_rows, d) and bulk (n_bulk, bulk_rows, d)
// of one dtype; ids (B, n_fast + n_bulk, L) in concat(fast, bulk) order;
// pos (n_fast + n_bulk + 1) int32 = [0] + [1 + inv_perm].
extern "C" int fused_grouped_bag_interactions_launch(
    const void* fast, const void* bulk, int tables_bf16, long long fast_rows,
    int n_fast, long long bulk_rows, int n_bulk, const void* pos,
    const void* ids, const void* bot, void* out, int batch, int n_lookups,
    int dim, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tables = n_fast + n_bulk;
  if (tables_bf16)
    return launch<__nv_bfloat16>(fast, fast_rows, n_fast, bulk, bulk_rows,
                                 pos, ids, nullptr, bot, out, batch, n_tables,
                                 n_lookups, dim, s);
  return launch<float>(fast, fast_rows, n_fast, bulk, bulk_rows, pos, ids,
                       nullptr, bot, out, batch, n_tables, n_lookups, dim, s);
}

// Two tiers of the same T tables: fast (T, fast_rows, d) and bulk
// (T, bulk_rows, d) of one dtype; fast_ids and bulk_ids (B, T, L) int32.
extern "C" int fused_cached_bag_interactions_launch(
    const void* fast, const void* bulk, int tables_bf16, long long fast_rows,
    long long bulk_rows, const void* fast_ids, const void* bulk_ids,
    const void* bot, void* out, int batch, int n_tables, int n_lookups,
    int dim, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tables_bf16)
    return launch<__nv_bfloat16, true>(fast, fast_rows, n_tables, bulk,
                                       bulk_rows, nullptr, fast_ids,
                                       bulk_ids, bot, out, batch, n_tables,
                                       n_lookups, dim, s);
  return launch<float, true>(fast, fast_rows, n_tables, bulk, bulk_rows,
                             nullptr, fast_ids, bulk_ids, bot, out, batch,
                             n_tables, n_lookups, dim, s);
}

extern "C" const char* fused_serve_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
