// The coefficient-weighted aggregates, for sm_90a:
//
//   coef_agg:      out[b, l] = sum_n c[b, n] * w[b, n, l]
//   coef_agg_pair: out[b, l] = sum_n ca[b, n] * w[b, n, l] + cb[b, n] * aux[b, n, l]
//
// The first is the cold-boot mean of both HieAvg layers (eq. 2/3) and
// FedAvg; the second the delayed-gradient mix, where a missing slot adds
// its staleness-discounted pending update (aux) in place of a fresh one.
//
// Replaces the Pallas kernels src/repro/kernels/coef_agg.py:coef_agg and
// :coef_agg_pair, which the JAX package vmaps over the engine's edge axis;
// here that axis is the grid's y axis (w, aux [B, n, L], c [B, n] or
// [B, 2, n] = (ca, cb), out [B, L], all float32).
//
// What bounds them on the H100: per column 4n (pair: 8n) bytes read and 4
// written for 2n (pair: 4n) FLOPs: device-memory bandwidth.  Design: one
// thread per column loops over the n participants; each operand element
// is read once, the coefficients once per block into shared memory.  A
// zero coefficient (a padded or dropped slot) adds exactly 0.
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

__global__ void coef_agg_pair_kernel(const float* __restrict__ w,
                                     const float* __restrict__ aux,
                                     const float* __restrict__ coef,
                                     float* __restrict__ out, int n,
                                     long long L) {
  extern __shared__ float sc[];  // [2, n]: ca then cb
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < 2 * n; i += blockDim.x)
    sc[i] = coef[(size_t)b * 2 * n + i];
  __syncthreads();
  const long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  float acc = 0.f;
  for (int j = 0; j < n; ++j) {
    const size_t o = ((size_t)b * n + j) * L + l;
    acc += sc[j] * w[o] + sc[n + j] * aux[o];
  }
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

extern "C" int coef_agg_pair_launch(const float* w, const float* aux,
                                    const float* coef, float* out, int B,
                                    int n, long long L, void* stream) {
  if (L == 0 || B == 0) return 0;
  const int threads = 256;
  dim3 grid((unsigned)((L + threads - 1) / threads), B);
  coef_agg_pair_kernel<<<grid, threads, 2 * n * sizeof(float),
                         (cudaStream_t)stream>>>(w, aux, coef, out, n, L);
  return (int)cudaGetLastError();
}
