// DLRM feature interaction for Hopper (sm_90a), one launch. Replaces the TPU
// kernel `interactions_pallas` (src/repro/kernels/interactions.py:31):
//
//   A[b]   = [bot_out[b]; pooled[b, 0]; ...; pooled[b, T-1]]  (T+1, d) fp32
//   out[b] = [bot_out[b] | A[b, i] . A[b, j]
//             for (i, j) in tril_indices(T+1, -1)]
//
// bot_out and pooled may each be fp32 or bf16; bf16 is widened exactly on
// load, and every product and sum is fp32. The TPU kernel wrote the whole
// (B, T+1, T+1) matrix and gathered the strict lower triangle and prepended
// bot_out outside its launch; here the triangle is written straight into
// the output in numpy's row-major order (the order csrc/fused_serve.cu
// emits) and bot_out is copied into the first d columns without going
// through the product, so no square matrix is written.
//
// What bounds it: device-memory bytes, and at the serve shapes launch time.
// At B=200, T=40, d=32 one call reads 1.05 MB and writes 0.68 MB against
// 10.5 MFLOP: about 6 FLOP a byte, below the ~20 at which fp32 CUDA-core
// math would bound it, and half a microsecond of traffic at 3.35 TB/s.
//
// Design: one block per sample. A is staged in shared memory (rows padded to
// d+1 floats so a warp's lanes hit distinct banks) with coalesced loads,
// then each thread computes whole pair dot products from shared memory.
// Offsets are 64-bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// The pairwise interaction of one sample, from its (s1 x dim) fp32 rows
// `acc` in shared memory (row stride `ld`): out[p] = A[i] . A[j] for pair
// p = i(i-1)/2 + j, 0 <= j < i < s1, the strict lower triangle in numpy's
// row-major `tril_indices(s1, k=-1)` order. Each thread computes whole
// pairs; the caller pads `ld` to dim + 1 so the lanes of a warp hit
// distinct banks.
__device__ __forceinline__ void write_pairs(const float* acc, int ld, int s1,
                                            int dim, float* out) {
  const int n_pairs = s1 * (s1 - 1) / 2;
  for (int p = threadIdx.x; p < n_pairs; p += blockDim.x) {
    int i = (int)((1.f + sqrtf(1.f + 8.f * (float)p)) * 0.5f);
    while (i * (i - 1) / 2 > p) --i;
    while ((i + 1) * i / 2 <= p) ++i;
    const int j = p - i * (i - 1) / 2;
    const float* ai = acc + i * ld;
    const float* aj = acc + j * ld;
    float s = 0.f;
    for (int k = 0; k < dim; ++k) s = fmaf(ai[k], aj[k], s);
    out[p] = s;
  }
}

template <typename Bot, typename Pooled>
__global__ void __launch_bounds__(kThreads) interactions_kernel(
    const Bot* __restrict__ bot, const Pooled* __restrict__ pooled,
    float* __restrict__ out, int n_tables, int dim) {
  extern __shared__ float a[];  // (T+1) rows of ld floats
  const int ld = dim + 1;
  const int s1 = n_tables + 1;
  const long long b = blockIdx.x;
  float* out_b = out + b * (dim + s1 * (s1 - 1) / 2);
  for (int k = threadIdx.x; k < dim; k += blockDim.x) {
    const float v = to_f32(bot[b * dim + k]);
    a[k] = v;
    out_b[k] = v;
  }
  const Pooled* pooled_b = pooled + b * n_tables * dim;
  for (int e = threadIdx.x; e < n_tables * dim; e += blockDim.x) {
    const int t = e / dim;
    a[(t + 1) * ld + (e - t * dim)] = to_f32(pooled_b[e]);
  }
  __syncthreads();
  write_pairs(a, ld, s1, dim, out_b + dim);
}

template <typename Bot, typename Pooled>
int launch(const void* bot, const void* pooled, void* out, int batch,
           int n_tables, int dim, cudaStream_t stream) {
  const size_t smem = (size_t)(n_tables + 1) * (dim + 1) * sizeof(float);
  auto kernel = interactions_kernel<Bot, Pooled>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<batch, kThreads, smem, stream>>>(
      static_cast<const Bot*>(bot), static_cast<const Pooled*>(pooled),
      static_cast<float*>(out), n_tables, dim);
  return (int)cudaGetLastError();
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

extern "C" const char* interactions_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
