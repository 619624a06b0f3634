// Device helpers shared by the kernels of csrc/. A change here rebuilds
// every library (kernels/_build.py hashes the headers with each source).
#pragma once

#include <cuda_bf16.h>

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Round an fp32 value once into the output's type (bf16: to nearest even).
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// The pairwise interaction of one sample, from its (s1 x dim) fp32 rows
// `acc` in shared memory (row stride `ld`): out[p] = A[slot[i]] . A[slot[j]]
// for pair p = i(i-1)/2 + j, 0 <= j < i < s1, the strict lower triangle in
// numpy's row-major `tril_indices(s1, k=-1)` order. `slot` maps a feature to
// its row; nullptr means the identity. Each thread computes whole pairs; the
// caller pads `ld` to dim + 1 so the lanes of a warp hit distinct banks.
__device__ __forceinline__ void write_pairs(const float* acc, int ld,
                                            const int* slot, int s1, int dim,
                                            float* out) {
  const int n_pairs = s1 * (s1 - 1) / 2;
  for (int p = threadIdx.x; p < n_pairs; p += blockDim.x) {
    int i = (int)((1.f + sqrtf(1.f + 8.f * (float)p)) * 0.5f);
    while (i * (i - 1) / 2 > p) --i;
    while ((i + 1) * i / 2 <= p) ++i;
    const int j = p - i * (i - 1) / 2;
    const float* ai = acc + (slot == nullptr ? i : slot[i]) * ld;
    const float* aj = acc + (slot == nullptr ? j : slot[j]) * ld;
    float s = 0.f;
    for (int k = 0; k < dim; ++k) s = fmaf(ai[k], aj[k], s);
    out[p] = s;
  }
}
