// Fused DLRM serve hot path for Hopper (sm_90a): gather -> sum-pool ->
// pairwise feature interaction, one launch. Three entry points:
//
//   fused_bag_interactions_launch replaces the TPU kernel
//   `fused_bag_interactions_pallas` (src/repro/kernels/fused_serve.py:134):
//   one stacked group of tables.
//
//   fused_grouped_bag_interactions_launch replaces
//   `fused_grouped_bag_interactions_pallas` (fused_serve.py:244): a tiered
//   plan's two table groups, fast (Tf, Rf, d) and bulk (Tb, Rb, d). Table k
//   of the kernel reads its row from the group that holds concat position
//   c = src[k] (fast if c < Tf, else bulk table c - Tf): only the owning
//   group's row is read (the TPU kernel fetched a clamped row from both
//   groups every step, an artifact of its BlockSpecs). Two call forms:
//     - ids in ORIGINAL table order and src = inv_perm: table t of the
//       kernel is the plan's table t, so the table permutation costs no
//       launch of its own (the serve path's form);
//     - ids already permuted to concat(fast, bulk) order (src = nullptr,
//       the identity) and pos = [0] + [1 + inv_perm]: the pair loop reads
//       accumulator slots pos[i], pos[j], which un-permutes the output as
//       the reference's `_finalize(inv_perm=...)` does (the kernels API's
//       reference-shaped op).
//   An empty group (Tf = 0 or Tb = 0) is the same kernel.
//
//   fused_cached_bag_interactions_launch replaces
//   `fused_cached_bag_interactions_pallas` (fused_serve.py:181): the tiered
//   store's two tiers, fast (T, S+1, d) and bulk (T, R+1, d), with
//   pre-translated ids fast_ids and bulk_ids (B, T, L), each id against
//   its own tier's row count. A lookup's answer is the sum of its two rows,
//   as in the reference (cached_embedding_bag_ref, then interactions); on
//   the store one of the two is always its tier's pad (slot S or R), and
//   nothing assumes that pad is zero.
//
// Computes, per sample b:
//   A[0]   = bot_out[b]
//   A[1+t] = sum_l tables[t, ids[b, t, l]]       (fp32; bf16 rows widened)
//   out[b] = [bot_out[b] | A[pos[i]].A[pos[j]] for (i, j) in
//             tril_indices(T+1, -1)]
// with the strict lower triangle in numpy's row-major order, so no
// (B, T+1, T+1) matrix is ever written. Ids follow jnp.take: a negative id
// counts from the end of the table, and an id outside [-R, R) makes its
// pooled row NaN rather than reading out of bounds.
//
// What bounds it: device-memory bytes. At the RM2-small serve shape (T=40,
// L=80, d=32, fp32) a sample gathers 3,200 random 128-byte rows (410 KB)
// against 53 KFLOP of contraction: about 0.1 FLOP a byte, far below the
// ~20 FLOP a byte at which fp32 CUDA-core math would bound it. The rows
// are random, so the 50 MB L2 does not help. The planner's depth 8 serves
// a 200-sample query as 8 launches of 25 samples: 80,000 rows, 10 MB, 3 us
// at 3.35 TB/s, so a launch is short and the whole card must gather at
// once. Keeping 3.35 TB/s busy over ~0.6 us of latency takes ~2 MB in
// flight, ~16,000 rows.
//
// Design: one cluster kernel for all three entry points (the single-group
// and grouped ones are the kernel the serve path launches once a
// micro-batch):
//   - A thread-block cluster per sample: B x C blocks, C = min(8, T)
//     (8 is the portable cluster size), block c pooling tables
//     [c*T/C, (c+1)*T/C) (T=40: 5 tables a block, 200 blocks at B=25,
//     where one block a sample gave 25).
//   - A table's bag goes to one warp; while the grid has fewer than 8
//     warps an SM (B=25 at T=40), or a block holds few tables, a bag is
//     split over 2, 4 or 8 warps, each pooling a segment of its lookups.
//   - 16-byte row vectors: a group of G lanes reads one row (G = the row's
//     16-byte vectors, rounded up to a power of two, at least 4), so a warp
//     load instruction reads 32/G rows (d=32 fp32: 4 rows; bf16: 8 rows).
//   - Rows in flight: a warp reads 32 of its bag's ids at a time,
//     coalesced, broadcasts them by shuffle, and issues 16 rows of loads
//     (at d=32, 4 float4 loads a lane) before it sums them. At 40
//     registers a thread (Occupancy below) an SM holds ~10 blocks of 5
//     warps, ~800 rows in flight. Shots of 80 rows (a whole bag at once)
//     measured slower on an H100 at every B >= 100.
//   - Pairs through distributed shared memory: each block pushes its
//     pooled rows into its peers' shared memory (map_shared_rank; at T=40,
//     d=32, 5 rows to each of 7 peers), a warp a row, once every block of
//     the cluster has started (a barrier arrived at the kernel's start and
//     waited for here). After cluster.sync() every block holds the
//     sample's (T+1) x d accumulator (5.2 KB) and writes its 1/C share of
//     the (T+1)T/2 pair dot products (block 0 also bot_out). No block
//     touches a peer's memory after that barrier, so each exits when its
//     pairs are written. Pulling the peers' rows after the barrier instead
//     measured slower on an H100 at every B: a pull waits a round trip,
//     and a block must then wait again until its peers have read it.
//   - Rows whose byte width is not a multiple of 16, or whose tables are
//     not 16-byte aligned, take a scalar path: a lane a column.
//   - The two-tier entry point pools with pool_bag2, row 6's idea
//     (embedding_bag.cu) on pool_bag's lanes and shots: a lookup loads
//     only its real row (the fast row unless its fast slot is the pad S,
//     else the bulk row), and the other tier's pad row, loaded into
//     registers once a bag, is added beside it; half the rows of the
//     first design's reads go. Both pads, both rows real and a slot
//     outside its tier take branches of their own. The fast tier's rows
//     (hot by construction) and the pads are loaded through L1, where they
//     repeat; the bulk tier's are read once (7% less time at B = 200 and
//     5% at 800 on an H100, 2% more at 100). Its own instantiation (kTwo),
//     so the single-group and grouped kernels compile as before.
// fp32 summation order: within a bag, lane group g sums rows g, g+P,
// g+2P, ... (P = rows a load instruction) in lookup order, the P group
// sums are added by a butterfly of shuffles (pairs of groups at distance
// 1, 2, 4, ... groups), and a bag split over warps adds its segments' sums
// in lookup order. A pair's dot product runs over d in order.
//
// What this design leaves for later: cp.async or TMA gather rings that
// keep a warp's next shot in flight while it sums the last, and a
// persistent grid that overlaps one sample's pairs with the next one's
// gather (a block now idles at the cluster barrier).
#include <algorithm>
#include <type_traits>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;

// ------------------------------------------------------ cluster kernel
constexpr int kClusterMax = 8;   // the portable cluster size
constexpr int kMaxWarps = 16;    // 512 threads a block at most
constexpr int kMaxSegs = 8;      // warps a bag at most
constexpr int kFillWarps = 8;    // warps an SM the grid should reach
constexpr int kShot = 16;        // rows a warp has in flight

// The row loads of one warp, by G = lanes that read a row as 16-byte
// vectors (4, 8, 16 or 32; 0 is the scalar path, a lane a column):
// P rows a load instruction, U loads a lane issues before it sums (a shot
// of kShot rows). Shots of 16 rows (4 float4 loads a lane at d=32) beat
// shots of 32 and 80 rows on an H100 at B >= 100: more rows in flight a
// warp only queued longer.
template <int G>
struct Shot {
  static_assert(G == 0 || 32 % G == 0, "G divides the warp");
  static constexpr int P = G == 0 ? 1 : 32 / G;
  static constexpr int U = kShot / P;
};

// Blocks of kMaxWarps warps an SM that the register budget must allow:
// 3 (at most 42 registers a thread) where a shot's row vectors take 8
// registers or fewer (G = 4, 8: the d=32 rows). A block waits at the
// cluster barrier for its slowest peer; more resident blocks keep the SM
// gathering meanwhile (64 registers, 6 blocks of 5 warps an SM, measured
// slower on an H100 at B >= 100 than 40 registers, 10 blocks). The
// two-tier body holds both tiers' pads beside its shot: 2 (64 registers;
// on an H100, 3 spilled and ran 15-28% slower at B = 200-800, and 8-row
// shots at 42 registers ran 16% faster at B = 100, within 5% either way
// at 200, and 3% and 16% slower at B = 800 and 25).
template <int G, bool kTwo>
struct Occupancy {
  static constexpr int kMinBlocks = G == 4 || G == 8 ? (kTwo ? 2 : 3) : 1;
};

// A 16-byte load that does not allocate in L1: a gathered row is read once.
__device__ __forceinline__ uint4 load_row_vec(const uint4* p) {
  uint4 r;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
}

// Add a row vector of `tab`'s element type to the lane's fp32 sums.
__device__ __forceinline__ void add_vec(float* s, uint4 v, const float*) {
  s[0] += __uint_as_float(v.x);
  s[1] += __uint_as_float(v.y);
  s[2] += __uint_as_float(v.z);
  s[3] += __uint_as_float(v.w);
}

// bf16 -> fp32 is exact: the bf16 bits are the fp32's top half.
__device__ __forceinline__ void add_vec(float* s, uint4 v,
                                        const __nv_bfloat16*) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s[2 * i] += __uint_as_float(w[i] << 16);
    s[2 * i + 1] += __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Pool lookups [lo, hi) of one bag (ids at idp) of the table at `tab`
// (n_rows rows of dim elements) into dst[0, dim), by one whole warp.
template <typename Row, int G>
__device__ __forceinline__ void pool_bag(const Row* __restrict__ tab,
                                         long long n_rows,
                                         const int32_t* __restrict__ idp,
                                         int lo, int hi, int dim, int lane,
                                         float* dst) {
  using S = Shot<G>;
  // a lane's row values: one 16-byte vector of E elements, or one element
  constexpr int E = G == 0 ? 1 : 16 / (int)sizeof(Row);
  constexpr int W = G == 0 ? 32 : G;       // columns (vectors) a pass
  const int grp = G == 0 ? 0 : lane / G;   // this lane's row of a load
  const int col = G == 0 ? lane : lane % G;
  const int n_cols = dim / E;              // G == 0: E == 1, columns
  for (int c0 = 0; c0 < n_cols; c0 += W) {
    const int c = c0 + col;
    const bool mine = c < n_cols;
    float sum[E];
#pragma unroll
    for (int e = 0; e < E; ++e) sum[e] = 0.f;
    bool bad = false;
    for (int l0 = lo; l0 < hi; l0 += 32) {
      const int ids32 = l0 + lane < hi ? idp[l0 + lane] : 0;
#pragma unroll 1
      for (int h = 0; h < 32 && l0 + h < hi; h += kShot) {
        if constexpr (G == 0) {
          float v[S::U];
#pragma unroll
          for (int u = 0; u < S::U; ++u) {
            long long id = __shfl_sync(kFull, ids32, h + u);
            if (id < 0) id += n_rows;
            const bool live = l0 + h + u < hi;
            const bool in = id >= 0 && id < n_rows;
            bad |= live && !in;
            v[u] = live && in && mine ? to_f32(tab[id * dim + c]) : 0.f;
          }
#pragma unroll
          for (int u = 0; u < S::U; ++u) sum[0] += v[u];
        } else {
          uint4 v[S::U];
          const uint4* vt = reinterpret_cast<const uint4*>(tab);
#pragma unroll
          for (int u = 0; u < S::U; ++u) {
            const int r = h + u * S::P + grp;  // this lane's row of the shot
            long long id = __shfl_sync(kFull, ids32, r);
            if (id < 0) id += n_rows;
            const bool live = l0 + r < hi;
            const bool in = id >= 0 && id < n_rows;
            bad |= live && !in;
            v[u] = live && in && mine ? load_row_vec(vt + id * n_cols + c)
                                      : make_uint4(0u, 0u, 0u, 0u);
          }
#pragma unroll
          for (int u = 0; u < S::U; ++u) add_vec(sum, v[u], tab);
        }
      }
    }
    if constexpr (G != 0) {
#pragma unroll
      for (int off = G; off < 32; off <<= 1)
#pragma unroll
        for (int e = 0; e < E; ++e)
          sum[e] += __shfl_xor_sync(kFull, sum[e], off);
    }
    bad = __any_sync(kFull, bad);
    if (grp == 0 && mine)
#pragma unroll
      for (int e = 0; e < E; ++e)
        dst[c * E + e] = bad ? __int_as_float(0x7fc00000) : sum[e];
  }
}

// A lookup's slot in one tier of `rows` < 2^31 rows: the row (a negative
// id counts from the end of the tier), whether that row lies inside the
// tier, and whether it is the tier's last row, its pad.
struct Slot {
  int row;
  bool inside, pad;
};

__device__ __forceinline__ Slot slot_of(int id, int rows) {
  const int r = id < 0 ? id + rows : id;
  return {r, (unsigned)r < (unsigned)rows, r == rows - 1};
}

// A lane's part of a row for the row path G: one 16-byte vector (G > 0)
// or one element (G == 0) of a table of n_cols vectors or elements a row.
// load reads a row once (no L1 allocation); load_reused keeps it in L1,
// for the fast tier's hot rows and the pads, which repeat within an SM.
template <typename Row, int G>
struct Part {
  using T = uint4;
  static __device__ __forceinline__ T zero() { return make_uint4(0, 0, 0, 0); }
  static __device__ __forceinline__ T load(const Row* tab, int row,
                                           int n_cols, int c) {
    return load_row_vec(reinterpret_cast<const uint4*>(tab) +
                        (long long)row * n_cols + c);
  }
  static __device__ __forceinline__ T load_reused(const Row* tab, int row,
                                                  int n_cols, int c) {
    return __ldg(reinterpret_cast<const uint4*>(tab) +
                 (long long)row * n_cols + c);
  }
  static __device__ __forceinline__ void add(float* s, T v) {
    add_vec(s, v, static_cast<const Row*>(nullptr));
  }
};

template <typename Row>
struct Part<Row, 0> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ T load(const Row* tab, int row,
                                           int n_cols, int c) {
    return to_f32(tab[(long long)row * n_cols + c]);
  }
  static __device__ __forceinline__ T load_reused(const Row* tab, int row,
                                                  int n_cols, int c) {
    return to_f32(__ldg(tab + (long long)row * n_cols + c));
  }
  static __device__ __forceinline__ void add(float* s, T v) { s[0] += v; }
};

// The two-tier bag of one table: lookups [lo, hi) of the slots at fidp
// (fast tier, fast_rows rows) and bidp (bulk tier, bulk_rows rows), each
// tier's last row its pad, pooled into dst[0, dim) by one whole warp, with
// pool_bag's lanes, shots and sums. As row 6's body (embedding_bag.cu): a
// lookup loads only its real row, the fast row unless the fast slot is the
// pad, else the bulk row, and adds the other tier's pad from registers
// (loaded once a bag, so a pad need not be zero). Both pads, both rows
// real (the bulk row loaded outside the shot) and a slot outside its tier
// (the bag's sum is NaN) take branches of their own.
template <typename Row, int G>
__device__ __forceinline__ void pool_bag2(const Row* __restrict__ fast,
                                          int fast_rows,
                                          const Row* __restrict__ bulk,
                                          int bulk_rows,
                                          const int32_t* __restrict__ fidp,
                                          const int32_t* __restrict__ bidp,
                                          int lo, int hi, int dim, int lane,
                                          float* dst) {
  using S = Shot<G>;
  using V = Part<Row, G>;
  constexpr int E = G == 0 ? 1 : 16 / (int)sizeof(Row);
  constexpr int W = G == 0 ? 32 : G;
  const int grp = G == 0 ? 0 : lane / G;
  const int col = G == 0 ? lane : lane % G;
  const int n_cols = dim / E;
  for (int c0 = 0; c0 < n_cols; c0 += W) {
    const int c = c0 + col;
    const bool mine = c < n_cols;
    float sum[E];
#pragma unroll
    for (int e = 0; e < E; ++e) sum[e] = 0.f;
    const typename V::T pad_f =
        mine ? V::load_reused(fast, fast_rows - 1, n_cols, c) : V::zero();
    const typename V::T pad_b =
        mine ? V::load_reused(bulk, bulk_rows - 1, n_cols, c) : V::zero();
    bool bad = false;
    for (int l0 = lo; l0 < hi; l0 += 32) {
      const int f32 = l0 + lane < hi ? fidp[l0 + lane] : 0;
      const int b32 = l0 + lane < hi ? bidp[l0 + lane] : 0;
#pragma unroll 1
      for (int h = 0; h < 32 && l0 + h < hi; h += kShot) {
        typename V::T v[S::U];
#pragma unroll
        for (int u = 0; u < S::U; ++u) {
          const int r = h + u * S::P + grp;  // this lane's lookup of the shot
          const Slot sf = slot_of(__shfl_sync(kFull, f32, r), fast_rows);
          const Slot sb = slot_of(__shfl_sync(kFull, b32, r), bulk_rows);
          const bool live = l0 + r < hi;
          const bool real_f = sf.inside && !sf.pad;
          const bool real_b = sb.inside && !sb.pad;
          const bool out = !sf.inside || !sb.inside;
          bad |= live && out;
          v[u] = V::zero();
          if (live && !out && mine) {
            if (real_f != real_b) {  // one real row and the other's pad
              v[u] = real_f ? V::load_reused(fast, sf.row, n_cols, c)
                            : V::load(bulk, sb.row, n_cols, c);
              V::add(sum, real_f ? pad_b : pad_f);
            } else if (real_f) {     // both rows real
              v[u] = V::load_reused(fast, sf.row, n_cols, c);
              V::add(sum, V::load(bulk, sb.row, n_cols, c));
            } else {                 // both pads
              V::add(sum, pad_f);
              V::add(sum, pad_b);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < S::U; ++u) V::add(sum, v[u]);
      }
    }
    if constexpr (G != 0) {
#pragma unroll
      for (int off = G; off < 32; off <<= 1)
#pragma unroll
        for (int e = 0; e < E; ++e)
          sum[e] += __shfl_xor_sync(kFull, sum[e], off);
    }
    bad = __any_sync(kFull, bad);
    if (grp == 0 && mine)
#pragma unroll
      for (int e = 0; e < E; ++e)
        dst[c * E + e] = bad ? __int_as_float(0x7fc00000) : sum[e];
  }
}

// Row i of pair p = i(i-1)/2 + j (0 <= j < i) of the strict lower
// triangle in numpy's row-major order.
__device__ __forceinline__ int pair_row(int p) {
  int i = (int)((1.f + sqrtf(1.f + 8.f * (float)p)) * 0.5f);
  while (i * (i - 1) / 2 > p) --i;
  while ((i + 1) * i / 2 <= p) ++i;
  return i;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Grid B x C blocks in clusters of C: block `rank` of sample b's cluster
// pools kernel tables [rank*T/C, (rank+1)*T/C). Kernel table k reads ids
// column k and concat position src[k] (nullptr: k) of fast (n_fast tables
// of fast_rows rows) then bulk (bulk_rows rows), into accumulator row 1+k;
// the pair loop reads rows slot[i], slot[j] (nullptr: i, j).
// kTwo: the two tiers of the same tables, fast (T, fast_rows, d) and bulk
// (T, bulk_rows, d); table k pools fast slots ids and bulk slots ids2
// (pool_bag2), and src and slot are nullptr.
template <typename Row, int G, bool kTwo>
__global__ void __launch_bounds__(kMaxWarps * 32,
                                  Occupancy<G, kTwo>::kMinBlocks)
cluster_bag_interactions_kernel(
    const Row* __restrict__ fast, long long fast_rows, int n_fast,
    const Row* __restrict__ bulk, long long bulk_rows,
    const int32_t* __restrict__ src, const int32_t* __restrict__ slot,
    const int32_t* __restrict__ ids, const int32_t* __restrict__ ids2,
    const float* __restrict__ bot, float* __restrict__ out, int n_tables,
    int n_lookups, int dim, int segs) {
  // (T+1) accumulator rows of ld floats, the slot map, then (segs > 1) a
  // partial row per (table, segment) of this block
  extern __shared__ float acc[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const long long b = blockIdx.x / C;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int s1 = n_tables + 1;
  const int ld = dim + 1;
  int* slot_s = reinterpret_cast<int*>(acc + s1 * ld);
  float* part = acc + s1 * ld + s1;
  const int t0 = rank * n_tables / C;
  const int t1 = (rank + 1) * n_tables / C;

  const int n_pairs = s1 * (s1 - 1) / 2;
  cluster_arrive();  // this block has started (waited for before a push)

  for (int i = threadIdx.x; i < s1; i += blockDim.x)
    slot_s[i] = slot == nullptr ? i : slot[i];
  for (int k = threadIdx.x; k < dim; k += blockDim.x)
    acc[k] = bot[b * dim + k];

  const int n_items = (t1 - t0) * segs;
  for (int it = warp; it < n_items; it += n_warps) {
    const int t = t0 + it / segs;
    const int seg = it % segs;
    const long long bag = (b * n_tables + t) * n_lookups;
    const int lo = seg * n_lookups / segs, hi = (seg + 1) * n_lookups / segs;
    float* dst = segs == 1 ? acc + (1 + t) * ld : part + it * ld;
    if constexpr (kTwo) {
      pool_bag2<Row, G>(fast + (long long)t * fast_rows * dim, (int)fast_rows,
                        bulk + (long long)t * bulk_rows * dim, (int)bulk_rows,
                        ids + bag, ids2 + bag, lo, hi, dim, lane, dst);
    } else {
      const int c = src == nullptr ? t : src[t];
      const bool in_fast = c < n_fast;
      const Row* tab = in_fast
          ? fast + (long long)c * fast_rows * dim
          : bulk + (long long)(c - n_fast) * bulk_rows * dim;
      pool_bag<Row, G>(tab, in_fast ? fast_rows : bulk_rows, ids + bag, lo,
                       hi, dim, lane, dst);
    }
  }
  if (segs > 1) {
    __syncthreads();
    for (int i = threadIdx.x; i < (t1 - t0) * dim; i += blockDim.x) {
      const int tl = i / dim, k = i - tl * dim;
      float s = 0.f;
      for (int g = 0; g < segs; ++g) s += part[(tl * segs + g) * ld + k];
      acc[(1 + t0 + tl) * ld + k] = s;
    }
  }
  // Push this block's pooled rows into every peer's shared memory (DSMEM
  // stores: the warp does not wait for them, where a pull waits a round
  // trip). Pushing only the rows a peer's pairs read measured slower on an
  // H100: the test for each row costs more than the stores it saves.
  __syncthreads();   // this block's rows are complete
  cluster_wait();    // every block of the cluster has started
  for (int t = t0 + warp; t < t1; t += n_warps)
    for (int q = 0; q < C; ++q) {
      if (q == rank) continue;
      float* peer = cluster.map_shared_rank(acc, q);
      for (int k = lane; k < dim; k += 32)
        peer[(1 + t) * ld + k] = acc[(1 + t) * ld + k];
    }
  cluster.sync();  // every push has landed; no block touches a peer again

  float* out_b = out + b * (dim + n_pairs);
  if (rank == 0)
    for (int k = threadIdx.x; k < dim; k += blockDim.x) out_b[k] = acc[k];
  const int p1 = (rank + 1) * n_pairs / C;
  for (int p = rank * n_pairs / C + threadIdx.x; p < p1; p += blockDim.x) {
    const int i = pair_row(p);
    const int j = p - i * (i - 1) / 2;
    const float* ai = acc + slot_s[i] * ld;
    const float* aj = acc + slot_s[j] * ld;
    float s = 0.f;
    for (int k = 0; k < dim; ++k) s = fmaf(ai[k], aj[k], s);
    out_b[dim + p] = s;
  }
}

template <typename Row, int G, bool kTwo>
cudaError_t launch_cluster(const Row* fast, long long fast_rows, int n_fast,
                           const Row* bulk, long long bulk_rows,
                           const int32_t* src, const int32_t* slot,
                           const int32_t* ids, const int32_t* ids2,
                           const float* bot, float* out, int batch,
                           int n_tables, int n_lookups, int dim,
                           cudaStream_t stream) {
  static int n_sms = 0;
  if (n_sms == 0) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err != cudaSuccess) return err;
  }
  const int C = std::min(kClusterMax, n_tables);
  const int per_block = (n_tables + C - 1) / C;  // the fullest block
  // A bag a warp; while the grid has fewer than kFillWarps warps an SM,
  // split each bag over 2, 4, ... warps (B=25, T=40: 2 warps a bag).
  const long long bags = (long long)batch * C * per_block;
  int segs = 1;
  while (segs < kMaxSegs && per_block * segs * 2 <= kMaxWarps &&
         bags * segs < (long long)kFillWarps * n_sms)
    segs *= 2;
  const int n_warps = std::min(kMaxWarps, per_block * segs);
  const size_t smem =
      ((size_t)(n_tables + 1) * (dim + 1) + (n_tables + 1) +
       (segs > 1 ? (size_t)per_block * segs * (dim + 1) : 0)) * 4;
  auto kernel = cluster_bag_interactions_kernel<Row, G, kTwo>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)batch * (unsigned)C);
  config.blockDim = dim3(n_warps * 32);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &config, kernel, fast, fast_rows, n_fast, bulk, bulk_rows, src, slot,
      ids, ids2, bot, out, n_tables, n_lookups, dim, segs);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The row path for these tables: 16-byte vectors when every row is whole
// 16-byte vectors and each group with tables starts 16-byte aligned,
// G = the vectors a row rounded up to a power of two in [4, 32]; else the
// scalar path. Single and grouped tables: kTwo false, n_fast + n_bulk
// tables; two tiers: kTwo, n_fast = n_bulk = T tables and bulk slots ids2.
template <typename Row, bool kTwo = false>
cudaError_t launch_rows(const void* fast, long long fast_rows, int n_fast,
                        const void* bulk, long long bulk_rows, int n_bulk,
                        const void* src, const void* slot, const void* ids,
                        const void* ids2, const void* bot, void* out,
                        int batch, int n_lookups, int dim,
                        cudaStream_t stream) {
  auto go = [&](auto g) {
    return launch_cluster<Row, decltype(g)::value, kTwo>(
        static_cast<const Row*>(fast), fast_rows, n_fast,
        static_cast<const Row*>(bulk), bulk_rows,
        static_cast<const int32_t*>(src), static_cast<const int32_t*>(slot),
        static_cast<const int32_t*>(ids), static_cast<const int32_t*>(ids2),
        static_cast<const float*>(bot), static_cast<float*>(out), batch,
        kTwo ? n_fast : n_fast + n_bulk, n_lookups, dim, stream);
  };
  const size_t row_bytes = (size_t)dim * sizeof(Row);
  const bool aligned =
      (n_fast == 0 || reinterpret_cast<uintptr_t>(fast) % 16 == 0) &&
      (n_bulk == 0 || reinterpret_cast<uintptr_t>(bulk) % 16 == 0);
  const size_t vecs = row_bytes / 16;
  if (row_bytes % 16 != 0 || !aligned)
    return go(std::integral_constant<int, 0>());
  if (vecs <= 4) return go(std::integral_constant<int, 4>());
  if (vecs <= 8) return go(std::integral_constant<int, 8>());
  if (vecs <= 16) return go(std::integral_constant<int, 16>());
  return go(std::integral_constant<int, 32>());
}

}  // namespace

// One stacked group: tables (T, R, d).
extern "C" int fused_bag_interactions_launch(
    const void* tables, int tables_bf16, const void* ids, const void* bot,
    void* out, int batch, int n_tables, long long n_rows, int n_lookups,
    int dim, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tables_bf16)
    return (int)launch_rows<__nv_bfloat16>(tables, n_rows, n_tables, nullptr,
                                           0, 0, nullptr, nullptr, ids,
                                           nullptr, bot, out, batch,
                                           n_lookups, dim, s);
  return (int)launch_rows<float>(tables, n_rows, n_tables, nullptr, 0, 0,
                                 nullptr, nullptr, ids, nullptr, bot, out,
                                 batch, n_lookups, dim, s);
}

// Two groups: fast (n_fast, fast_rows, d) and bulk (n_bulk, bulk_rows, d)
// of one dtype; ids (B, n_fast + n_bulk, L). Either src (n_fast + n_bulk
// int32, the concat position of each table: inv_perm) with ids in original
// table order, or pos (n_fast + n_bulk + 1 int32, [0] + [1 + inv_perm])
// with ids in concat(fast, bulk) order; the other is nullptr.
extern "C" int fused_grouped_bag_interactions_launch(
    const void* fast, const void* bulk, int tables_bf16, long long fast_rows,
    int n_fast, long long bulk_rows, int n_bulk, const void* src,
    const void* pos, const void* ids, const void* bot, void* out, int batch,
    int n_lookups, int dim, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tables_bf16)
    return (int)launch_rows<__nv_bfloat16>(fast, fast_rows, n_fast, bulk,
                                           bulk_rows, n_bulk, src, pos, ids,
                                           nullptr, bot, out, batch,
                                           n_lookups, dim, s);
  return (int)launch_rows<float>(fast, fast_rows, n_fast, bulk, bulk_rows,
                                 n_bulk, src, pos, ids, nullptr, bot, out,
                                 batch, n_lookups, dim, s);
}

// Two tiers of the same T tables: fast (T, fast_rows, d) and bulk
// (T, bulk_rows, d) of one dtype, each tier's last row its pad, fewer than
// 2^31 rows a tier; fast_ids and bulk_ids (B, T, L) int32.
extern "C" int fused_cached_bag_interactions_launch(
    const void* fast, const void* bulk, int tables_bf16, long long fast_rows,
    long long bulk_rows, const void* fast_ids, const void* bulk_ids,
    const void* bot, void* out, int batch, int n_tables, int n_lookups,
    int dim, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fast_rows > INT32_MAX || bulk_rows > INT32_MAX)
    return (int)cudaErrorInvalidValue;  // slots are 32-bit in the kernel
  if (tables_bf16)
    return (int)launch_rows<__nv_bfloat16, true>(
        fast, fast_rows, n_tables, bulk, bulk_rows, n_tables, nullptr,
        nullptr, fast_ids, bulk_ids, bot, out, batch, n_lookups, dim, s);
  return (int)launch_rows<float, true>(
      fast, fast_rows, n_tables, bulk, bulk_rows, n_tables, nullptr, nullptr,
      fast_ids, bulk_ids, bot, out, batch, n_lookups, dim, s);
}

extern "C" const char* fused_serve_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
