// Embedding bags for Hopper (sm_90a): gather + sum-pool, one launch.
// Three entry points share one per-row pooling body (`pool_bag`):
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
//   The bulk tier may also be ONE (R+1, d) tier that every table reads (a
//   table stride of 0): the host tier's flat chunk cache, read in place by
//   the cache positions, where the reference first gathers it into a fake
//   (T, B*L, d) slab. Both rows of every lookup are read and summed, as in
//   the reference: the kernel does not assume that the pad slot (S or R)
//   holds zeros.
//
//   embedding_bag_blocked_launch replaces `embedding_bag_pallas_blocked`
//   (src/repro/kernels/embedding_bag.py:107): the same bag, read a block of
//   `lblk` consecutive rows at a time when the whole id stream is ALIGNED,
//   i.e. every L-block of lblk lookups is exactly the rows
//   [k*lblk, (k+1)*lblk) of its table (`blocked_stream_aligned`, :90); any
//   other stream pools the whole batch through `pool_bag`, as row 4 does. A
//   block that passes the reference's predicate but reaches past the table
//   (base a multiple of lblk, base + lblk > R) counts as NOT aligned here,
//   so its answer is `embedding_bag_ref`'s (NaN for the rows past R) and
//   never a read out of bounds. The predicate is computed on the device: a
//   check kernel clears or sets one flag, and the pooling kernel reads it,
//   so the launch never waits for the host.
//
// What bounds them: device-memory bytes. At the RM2-small shape (B=200, T=40,
// L=80, d=32, fp32) one call gathers 640,000 128-byte rows (81.9 MB; the
// two-tier bag names twice as many slots, one of each pair a pad) against
// 20 FLOP a row: nothing but the row reads matter, and random rows do not
// stream. What a kernel can do about
// it is keep enough independent row reads in flight to cover the memory's
// latency, issue few instructions per byte, and read no byte twice.
//
// Design of `pool_bag`: one warp per (b, t) bag, 4 bags a block, so B*T bags
// spread over all 132 SMs at any batch (8,000 warps at B=200). No cluster:
// a bag shares nothing with another, so no block waits for a peer.
//   - Row loads of 16 bytes (fp32; 8 bytes bf16) when d % 4 == 0 and the
//     tiers are aligned to them: a row is nv = d/4 vectors, a group of
//     `span` lanes (nv rounded up to a power of two, at most 32) takes a
//     row, and the warp's 32/span groups take as many rows per load
//     instruction (4 at d = 32, where one lane a column took one row). Other
//     d and misaligned tiers take scalar loads through the same body (nv =
//     d); rows wider than 32 vectors are walked in passes of 32.
//   - Ids are fetched ahead: the warp reads a bag's ids 32 at a time in one
//     coalesced load, the next 32 while it pools these, and broadcasts them
//     with shuffles. Each group issues kBatch (4) row loads, its lookups g,
//     g + groups, ..., before it adds any: 16 rows in flight a warp at
//     d = 32. Larger batches measured slower: their registers cost warps.
//   - The two tiers are read in the same step, and a lookup loads only its
//     real row: tier a's unless that slot is the pad, else tier b's.
//   - Pad rows come from registers: each tier's last row (fast[t, S],
//     bulk[t, R], or the shared tier's pad) is loaded once a bag, and a
//     lookup whose slot is that row adds the register copy. On the tiered
//     store and the host tier every lookup has one pad slot, so half the
//     row reads go. The value and its place in the sum are the same as a
//     load's. The rare lookups (two pads, two real rows, a row outside its
//     tier) take a branch of their own.
//   - Few instructions a lookup: slots in 32-bit arithmetic (a tier has
//     fewer than 2^31 rows: the ids are int32), 64-bit only for the row's
//     offset.
//   - The groups' partial sums meet by shuffles at the end of the bag.
// Ids follow jnp.take: a negative id counts from the end of its table, and
// an id outside [-rows, rows) reads as NaN rather than out of bounds. Row
// offsets are 64-bit: 40 x 4,194,304 x 32 elements overflow int32, and the
// host tier's cache is 41,943,041 rows of 128.
//
// The blocked branch (`pool_blocks`): a block is lblk*d contiguous elements
// (1 KB at lblk=8, d=32 fp32): d/4 lanes span a row with 16-byte (fp32) or
// 8-byte (bf16) loads, the other lanes of the warp take the block's other
// rows (two loads a lane a block at d=32, lblk=8), and a shuffle reduction
// over the lanes that hold the same columns gives the block's sum; the block
// loop is unrolled 4 deep so that later blocks' loads are in flight during
// earlier blocks' reductions. As in the reference, a block of bf16 rows sums
// to one bf16 value before the fp32 sum over blocks. The per-row branch is a
// call out of line (`pool_bag_apart`), so that its registers do not weigh
// on the blocked branch's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <cstdint>

namespace {

// Bags (warps) a block: 4 for pool_bag's kernel, 8 for the blocked one.
// Row loads a lane group issues before it adds any. Tuned on the H100 at
// B=200, d=32 and B=600, d=128: batches of 2, 4, 6, 8 and 4 or 8 warps a
// block; larger batches hold more registers and fewer warps.
constexpr int kBagWarps = 4;
constexpr int kBlockedWarps = 8;
constexpr int kBatch = 4;

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

// One tier of a bag: table 0 at `tab`, `stride` elements between tables (0
// when every table reads the same tier), `rows` rows a table, (B, T, L) ids.
template <typename Row>
struct Tier {
  const Row* tab;
  long long stride;
  long long rows;
  const int32_t* ids;
};

// A lookup's slot in one tier of `rows` < 2^31 rows: the row (a negative
// id counts from the end of the tier), whether that row lies inside the
// tier, and whether it is the tier's last row, its pad. 32-bit arithmetic:
// on the H100 the 64-bit form cost row 6 time in issue slots.
struct Slot {
  int row;
  bool inside, pad;
};

__device__ __forceinline__ Slot slot_of(int id, int rows) {
  const int r = id < 0 ? id + rows : id;
  return {r, (unsigned)r < (unsigned)rows, r == rows - 1};
}

// Pools bag (b, t) = `bag` into out[bag]: tier a always, tier b too when
// kTwo (the two-tier bag, whose tiers' last rows are its pads). All 32
// lanes of the warp call it (the shuffles need them all).
//
// A two-tier lookup normally has one real row and one pad: it loads the
// real row (tier a's unless that is the pad) in the batch and adds the
// other tier's pad from registers. A lookup whose two rows are both real
// loads tier b's row at once, outside the batch; one whose two slots are
// both pads loads nothing.
template <typename Row, int V, bool kTwo>
__device__ __forceinline__ void pool_bag(const Tier<Row>& a,
                                         const Tier<Row>& b,
                                         float* __restrict__ out,
                                         long long bag, int n_tables,
                                         int n_lookups, int dim, int lane) {
  const int t = (int)(bag % n_tables);
  const long long id_off = bag * n_lookups;
  const Row* ta = a.tab + (long long)t * a.stride;
  const Row* tb = kTwo ? b.tab + (long long)t * b.stride : nullptr;
  const int32_t* ia = a.ids + id_off;
  const int32_t* ib = kTwo ? b.ids + id_off : nullptr;
  const int nv = dim / V;
  const int span = nv >= 32 ? 32 : 1 << (32 - __clz(nv - 1));
  const int groups = 32 / span;
  const int cv = lane & (span - 1), rg = lane / span;
  const int rows_a = (int)a.rows, rows_b = kTwo ? (int)b.rows : 1;
  const float nan = __int_as_float(0x7fc00000);
  float* out_bag = out + bag * dim;
  for (int c0 = 0; c0 < nv; c0 += span) {
    const int k = (c0 + cv) * V;
    const bool active = c0 + cv < nv;
    float acc[V], pad_a[V], pad_b[V];
#pragma unroll
    for (int u = 0; u < V; ++u) acc[u] = pad_a[u] = pad_b[u] = 0.f;
    if (kTwo && active) {
      RowLoad<Row, V>::run(ta + (a.rows - 1) * dim + k, pad_a);
      RowLoad<Row, V>::run(tb + (b.rows - 1) * dim + k, pad_b);
    }
    int next_a = lane < n_lookups ? __ldg(ia + lane) : 0;
    int next_b = kTwo && lane < n_lookups ? __ldg(ib + lane) : 0;
    for (int l0 = 0; l0 < n_lookups; l0 += 32) {
      const int n = min(32, n_lookups - l0);
      const int mine_a = next_a, mine_b = next_b;
      const int ahead = l0 + 32 + lane;       // the next 32 ids, in flight
      if (ahead < n_lookups) {
        next_a = __ldg(ia + ahead);
        if (kTwo) next_b = __ldg(ib + ahead);
      }
      const int steps = (n + groups - 1) / groups;
      for (int s0 = 0; s0 < steps; s0 += kBatch) {
        float v[kBatch][V];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int j = (s0 + u) * groups + rg;
          const bool live = active && j < n;
          const Slot sa =
              slot_of(__shfl_sync(0xffffffffu, mine_a, j & 31), rows_a);
          const Slot sb = kTwo ? slot_of(__shfl_sync(0xffffffffu, mine_b,
                                                     j & 31), rows_b)
                               : Slot{0, true, true};
          const bool real_a = sa.inside && !(kTwo && sa.pad);
          const bool real_b = kTwo && sb.inside && !sb.pad;
          const bool bad = !sa.inside || !sb.inside;
          // beside its batched load, a lookup with one real row adds the
          // other tier's pad from registers; the rare ones (a row outside
          // its tier: NaN; two pads; two real rows, the second loaded
          // here) take a branch of their own
          if (kTwo && live && !bad && real_a != real_b) {
#pragma unroll
            for (int w = 0; w < V; ++w) acc[w] += real_a ? pad_b[w] : pad_a[w];
          } else if (live && (bad || (kTwo && real_a == real_b))) {
            float y[V];
            if (bad) {
#pragma unroll
              for (int w = 0; w < V; ++w) y[w] = nan;
            } else if (real_a) {
              RowLoad<Row, V>::run(tb + (long long)sb.row * dim + k, y);
            } else {
#pragma unroll
              for (int w = 0; w < V; ++w) y[w] = pad_a[w] + pad_b[w];
            }
#pragma unroll
            for (int w = 0; w < V; ++w) acc[w] += y[w];
          }
#pragma unroll
          for (int w = 0; w < V; ++w) v[u][w] = 0.f;
          if (live && !bad && (real_a || real_b))
            RowLoad<Row, V>::run(
                !kTwo || real_a ? ta + (long long)sa.row * dim + k
                                : tb + (long long)sb.row * dim + k,
                v[u]);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
#pragma unroll
          for (int w = 0; w < V; ++w) acc[w] += v[u][w];
        }
      }
    }
    // lanes lane ^ span, lane ^ 2 span, ... hold the same columns
    for (int off = span; off < 32; off <<= 1) {
#pragma unroll
      for (int w = 0; w < V; ++w)
        acc[w] += __shfl_xor_sync(0xffffffffu, acc[w], off);
    }
    if (active && rg == 0) {
#pragma unroll
      for (int w = 0; w < V; ++w) out_bag[k + w] = acc[w];
    }
  }
}

// Bag (b, t) = blockIdx.x * kBagWarps + warp.
template <typename Row, int V, bool kTwo>
__global__ void __launch_bounds__(kBagWarps * 32) embedding_bag_kernel(
    Tier<Row> a, Tier<Row> b, float* __restrict__ out, long long n_bags,
    int n_tables, int n_lookups, int dim) {
  const long long bag =
      (long long)blockIdx.x * kBagWarps + (threadIdx.x >> 5);
  if (bag >= n_bags) return;  // uniform across the warp
  pool_bag<Row, V, kTwo>(a, b, out, bag, n_tables, n_lookups, dim,
                         threadIdx.x & 31);
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


// The blocked kernel's per-row branch, out of line: inlined into the
// blocked kernel, it made ptxas spill in the blocked branch too, which ran
// 2% slower on the H100 (aligned, B = 200, d = 32).
template <typename Row, int V>
__device__ __noinline__ void pool_bag_apart(Tier<Row> a,
                                            float* __restrict__ out,
                                            long long bag, int n_tables,
                                            int n_lookups, int dim,
                                            int lane) {
  pool_bag<Row, V, false>(a, a, out, bag, n_tables, n_lookups, dim, lane);
}

// Bag (b, t) = blockIdx.x * kBlockedWarps + warp. The flag written by
// blocked_check_kernel picks the branch for the whole batch: V is the
// vector width of both branches.
template <typename Row, int V>
__global__ void __launch_bounds__(kBlockedWarps * 32)
    embedding_bag_blocked_kernel(const Row* __restrict__ tab,
                                 long long n_rows,
                                 const int32_t* __restrict__ ids,
                                 const int* __restrict__ misaligned,
                                 float* __restrict__ out, long long n_bags,
                                 int n_tables, int n_lookups, int dim,
                                 int lblk) {
  const int lane = threadIdx.x & 31;
  const long long bag =
      (long long)blockIdx.x * kBlockedWarps + (threadIdx.x >> 5);
  if (bag >= n_bags) return;  // uniform across the warp
  if (*misaligned) {
    pool_bag_apart<Row, V>(Tier<Row>{tab, n_rows * dim, n_rows, ids}, out,
                           bag, n_tables, n_lookups, dim, lane);
    return;
  }
  const int t = (int)(bag % n_tables);
  pool_blocks<Row, V>(tab + (long long)t * n_rows * dim,
                      ids + bag * n_lookups, n_lookups, lblk, dim, lane,
                      out + bag * dim);
}

// 16-byte (fp32) or 8-byte (bf16) loads need d % 4 == 0 and tiers aligned
// to them; anything else takes scalar loads.
template <typename Row>
bool vector_rows(const void* p, int dim) {
  return dim % 4 == 0 &&
         reinterpret_cast<uintptr_t>(p) % (4 * sizeof(Row)) == 0;
}

template <typename Row>
int launch(const Tier<Row>& a, const Tier<Row>* b, void* out, int batch,
           int n_tables, int n_lookups, int dim, cudaStream_t stream) {
  if (a.rows > 0x7fffffffLL || (b != nullptr && b->rows > 0x7fffffffLL))
    return (int)cudaErrorInvalidValue;   // int32 ids: rows < 2^31
  const long long n_bags = (long long)batch * n_tables;
  const long long blocks = (n_bags + kBagWarps - 1) / kBagWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks), block(kBagWarps * 32);
  float* o = static_cast<float*>(out);
  const bool vec = vector_rows<Row>(a.tab, dim) &&
                   (b == nullptr || vector_rows<Row>(b->tab, dim));
#define BAG(V, TWO)                                                         \
  embedding_bag_kernel<Row, V, TWO><<<grid, block, 0, stream>>>(           \
      a, b == nullptr ? a : *b, o, n_bags, n_tables, n_lookups, dim)
  if (b != nullptr) {
    if (vec) BAG(4, true);
    else BAG(1, true);
  } else {
    if (vec) BAG(4, false);
    else BAG(1, false);
  }
#undef BAG
  return (int)cudaGetLastError();
}

template <typename Row>
int launch_blocked(const void* tables, long long n_rows, const void* ids,
                   void* misaligned, void* out, int batch, int n_tables,
                   int n_lookups, int dim, int lblk, cudaStream_t stream) {
  if (lblk < 1 || n_lookups % lblk != 0 || n_rows > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const long long n_bags = (long long)batch * n_tables;
  const long long n_ids = n_bags * n_lookups;
  const long long blocks = (n_bags + kBlockedWarps - 1) / kBlockedWarps;
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
  const dim3 grid((unsigned)blocks), block(kBlockedWarps * 32);
  if (vector_rows<Row>(tables, dim))
    embedding_bag_blocked_kernel<Row, 4><<<grid, block, 0, stream>>>(
        tab, n_rows, id, flag, o, n_bags, n_tables, n_lookups, dim, lblk);
  else
    embedding_bag_blocked_kernel<Row, 1><<<grid, block, 0, stream>>>(
        tab, n_rows, id, flag, o, n_bags, n_tables, n_lookups, dim, lblk);
  return (int)cudaGetLastError();
}

template <typename Row>
int bag(const void* tables, long long n_rows, const void* ids, void* out,
        int batch, int n_tables, int n_lookups, int dim,
        cudaStream_t stream) {
  const Tier<Row> a{static_cast<const Row*>(tables), n_rows * dim, n_rows,
                    static_cast<const int32_t*>(ids)};
  return launch<Row>(a, nullptr, out, batch, n_tables, n_lookups, dim,
                     stream);
}

template <typename Row>
int cached_bag(const void* fast, const void* bulk, long long fast_rows,
               long long bulk_rows, int bulk_shared, const void* fast_ids,
               const void* bulk_ids, void* out, int batch, int n_tables,
               int n_lookups, int dim, cudaStream_t stream) {
  const Tier<Row> a{static_cast<const Row*>(fast), fast_rows * dim,
                    fast_rows, static_cast<const int32_t*>(fast_ids)};
  const Tier<Row> b{static_cast<const Row*>(bulk),
                    bulk_shared ? 0 : bulk_rows * dim, bulk_rows,
                    static_cast<const int32_t*>(bulk_ids)};
  return launch<Row>(a, &b, out, batch, n_tables, n_lookups, dim, stream);
}

}  // namespace

// tables (T, R, d), ids (B, T, L) int32 -> out (B, T, d) fp32.
extern "C" int embedding_bag_launch(const void* tables, int tables_bf16,
                                    long long n_rows, const void* ids,
                                    void* out, int batch, int n_tables,
                                    int n_lookups, int dim, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tables_bf16)
    return bag<__nv_bfloat16>(tables, n_rows, ids, out, batch, n_tables,
                              n_lookups, dim, s);
  return bag<float>(tables, n_rows, ids, out, batch, n_tables, n_lookups,
                    dim, s);
}

// fast (T, S+1, d) and bulk (T, R+1, d), or bulk (R+1, d) shared by every
// table when bulk_shared, of one dtype; fast_ids, bulk_ids (B, T, L) int32
// -> out (B, T, d) fp32.
extern "C" int cached_embedding_bag_launch(
    const void* fast, const void* bulk, int tables_bf16, long long fast_rows,
    long long bulk_rows, int bulk_shared, const void* fast_ids,
    const void* bulk_ids, void* out, int batch, int n_tables, int n_lookups,
    int dim, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tables_bf16)
    return cached_bag<__nv_bfloat16>(fast, bulk, fast_rows, bulk_rows,
                                     bulk_shared, fast_ids, bulk_ids, out,
                                     batch, n_tables, n_lookups, dim, s);
  return cached_bag<float>(fast, bulk, fast_rows, bulk_rows, bulk_shared,
                           fast_ids, bulk_ids, out, batch, n_tables,
                           n_lookups, dim, s);
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
