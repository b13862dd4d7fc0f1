// HieAvg's mix and history update in one pass (eq. 4/5), for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/hieavg_agg.py:hieavg_agg,
// which the JAX package vmaps over the engine's edge axis.  Here that axis
// is the grid's y axis: w, prev and dmean are [B, n, L] (B edges of n
// participants, or B = 1 at the global layer), vec is [B, 4, n] =
// (mask, coef_present, coef_est, n_obs).
//
//   agg[b, l]      = sum_n cp*w + ce*(prev + dmean)
//   nprev[b, n, l] = m*w + (1-m)*(prev + dmean)
//   ndmean[b,n,l]  = m*((dmean*n_obs + (w - prev)) / (n_obs + 1))
//                    + (1-m)*dmean
//
// What bounds it on the H100: per element of a participant 12 bytes read
// and 8 written for ~12 FLOPs: device-memory bandwidth.  Design: one
// thread per column l loops over the n participants, so every operand
// element is read once and every output written once, neighbouring
// threads on neighbouring addresses; the [4, n] coefficients are read
// once per block into shared memory.  A zero coefficient adds exactly 0.
#include <cuda_runtime.h>

namespace {

__global__ void hieavg_agg_kernel(const float* __restrict__ w,
                                  const float* __restrict__ prev,
                                  const float* __restrict__ dmean,
                                  const float* __restrict__ vec,
                                  float* __restrict__ agg,
                                  float* __restrict__ nprev,
                                  float* __restrict__ ndmean, int n,
                                  long long L) {
  extern __shared__ float sv[];  // [4, n]
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < 4 * n; i += blockDim.x)
    sv[i] = vec[(size_t)b * 4 * n + i];
  __syncthreads();
  const long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  float acc = 0.f;
  for (int j = 0; j < n; ++j) {
    const size_t o = ((size_t)b * n + j) * L + l;
    const float wv = w[o], pv = prev[o], dv = dmean[o];
    const float m = sv[j], cp = sv[n + j], ce = sv[2 * n + j];
    const float nb = sv[3 * n + j];
    const float est = pv + dv;
    acc += cp * wv + ce * est;
    nprev[o] = m * wv + (1.f - m) * est;
    const float mean = (dv * nb + (wv - pv)) / (nb + 1.f);
    ndmean[o] = m * mean + (1.f - m) * dv;
  }
  agg[(size_t)b * L + l] = acc;
}

}  // namespace

extern "C" int hieavg_agg_launch(const float* w, const float* prev,
                                 const float* dmean, const float* vec,
                                 float* agg, float* nprev, float* ndmean,
                                 int B, int n, long long L, void* stream) {
  if (L == 0 || B == 0) return 0;
  const int threads = 256;
  dim3 grid((unsigned)((L + threads - 1) / threads), B);
  hieavg_agg_kernel<<<grid, threads, 4 * n * sizeof(float),
                      (cudaStream_t)stream>>>(w, prev, dmean, vec, agg, nprev,
                                              ndmean, n, L);
  return (int)cudaGetLastError();
}
