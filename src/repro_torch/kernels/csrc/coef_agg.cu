// The coefficient-weighted aggregate out[b, l] = sum_n c[b, n] * w[b, n, l],
// for sm_90a.  The cold-boot means of both HieAvg layers (eq. 2/3).
//
// Replaces the Pallas kernel src/repro/kernels/coef_agg.py:coef_agg, which
// the JAX package vmaps over the engine's edge axis; here that axis is the
// grid's y axis (w [B, n, L], c [B, n], out [B, L] float32).
//
// What bounds it on the H100: 4n bytes read and 4 written per column for
// 2n FLOPs: device-memory bandwidth.  Design: one thread per column loops
// over the n participants; each operand element is read once, the
// coefficients once per block into shared memory.  A zero coefficient
// (a padded slot) adds exactly 0.
#include <cuda_runtime.h>

namespace {

__global__ void coef_agg_kernel(const float* __restrict__ w,
                                const float* __restrict__ coef,
                                float* __restrict__ out, int n, long long L) {
  extern __shared__ float sc[];  // [n]
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    sc[i] = coef[(size_t)b * n + i];
  __syncthreads();
  const long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  float acc = 0.f;
  for (int j = 0; j < n; ++j) acc += sc[j] * w[((size_t)b * n + j) * L + l];
  out[(size_t)b * L + l] = acc;
}

}  // namespace

extern "C" int coef_agg_launch(const float* w, const float* coef, float* out,
                               int B, int n, long long L, void* stream) {
  if (L == 0 || B == 0) return 0;
  const int threads = 256;
  dim3 grid((unsigned)((L + threads - 1) / threads), B);
  coef_agg_kernel<<<grid, threads, n * sizeof(float), (cudaStream_t)stream>>>(
      w, coef, out, n, L);
  return (int)cudaGetLastError();
}
