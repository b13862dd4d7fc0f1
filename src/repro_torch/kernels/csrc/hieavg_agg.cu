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
// w and agg are float32.  The history (prev, dmean, nprev, ndmean) is
// stored in float32, bfloat16 or float8_e4m3fn (the engine's
// history_dtype): the math is float32, each history value is widened on
// load and rounded to nearest even on store.  A float8 store gives NaN
// where |x| > 464, for +-inf and for NaN (no saturation), as JAX's cast.
//
// What bounds it on the H100: per element of a participant 4 + 2s bytes
// read and 2s written (s = 4, 2 or 1 bytes of history) for ~12 FLOPs:
// device-memory bandwidth.  Design: one thread per column l loops over the
// n participants, so every operand element is read once and every output
// written once, neighbouring threads on neighbouring addresses; the
// [4, n] coefficients are read once per block into shared memory.  A zero
// coefficient adds exactly 0.
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load(const __nv_fp8_storage_t* p) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(*p, __NV_E4M3)));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store(__nv_fp8_storage_t* p, float x) {
  *p = __nv_cvt_float_to_fp8(x, __NV_NOSAT, __NV_E4M3);
}

template <typename H>
__global__ void hieavg_agg_kernel(const float* __restrict__ w,
                                  const H* __restrict__ prev,
                                  const H* __restrict__ dmean,
                                  const float* __restrict__ vec,
                                  float* __restrict__ agg,
                                  H* __restrict__ nprev,
                                  H* __restrict__ ndmean, int n,
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
    const float wv = w[o], pv = load(prev + o), dv = load(dmean + o);
    const float m = sv[j], cp = sv[n + j], ce = sv[2 * n + j];
    const float nb = sv[3 * n + j];
    const float est = pv + dv;
    acc += cp * wv + ce * est;
    store(nprev + o, m * wv + (1.f - m) * est);
    const float mean = (dv * nb + (wv - pv)) / (nb + 1.f);
    store(ndmean + o, m * mean + (1.f - m) * dv);
  }
  agg[(size_t)b * L + l] = acc;
}

template <typename H>
int launch(const float* w, const void* prev, const void* dmean,
           const float* vec, float* agg, void* nprev, void* ndmean, int B,
           int n, long long L, cudaStream_t stream) {
  const int threads = 256;
  dim3 grid((unsigned)((L + threads - 1) / threads), B);
  hieavg_agg_kernel<H><<<grid, threads, 4 * n * sizeof(float), stream>>>(
      w, (const H*)prev, (const H*)dmean, vec, agg, (H*)nprev, (H*)ndmean, n,
      L);
  return (int)cudaGetLastError();
}

}  // namespace

// hist: the history storage type, 0 = float32, 1 = bfloat16,
// 2 = float8_e4m3fn (kernels/hieavg_agg.py:HIST_CODES).
extern "C" int hieavg_agg_launch(const float* w, const void* prev,
                                 const void* dmean, const float* vec,
                                 float* agg, void* nprev, void* ndmean,
                                 int B, int n, long long L, int hist,
                                 void* stream) {
  if (L == 0 || B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (hist) {
    case 0:
      return launch<float>(w, prev, dmean, vec, agg, nprev, ndmean, B, n, L,
                           s);
    case 1:
      return launch<__nv_bfloat16>(w, prev, dmean, vec, agg, nprev, ndmean,
                                   B, n, L, s);
    case 2:
      return launch<__nv_fp8_storage_t>(w, prev, dmean, vec, agg, nprev,
                                        ndmean, B, n, L, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
