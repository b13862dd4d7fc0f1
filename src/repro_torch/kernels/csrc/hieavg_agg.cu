// HieAvg's mix and history update in one pass (eq. 4/5) over every leaf of
// a model in one launch, for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/hieavg_agg.py:hieavg_agg,
// which the JAX package calls once per leaf and vmaps over the engine's
// edge axis.  Here one launch takes every leaf of an aggregate: leaf k is
// w, prev, dmean [B, n, L_k] (B edges of n participants, or B = 1 at the
// global layer), and the coefficients are four [B, n] vectors (mask,
// coef_present, coef_est, n_obs) shared by all leaves.
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
// where |x| > 464, for +-inf and for NaN, as JAX's cast does: sm_90 has a
// hardware conversion only with saturation (cvt.rn.satfinite), which
// rounds |x| <= 464 exactly as the non-saturating cast (464 itself ties
// to 448), so a select puts the NaN of x's sign everywhere else.
//
// What bounds it on the H100: per element of a participant 4 + 2s bytes
// read and 2s written (s = 4, 2 or 1 bytes of history) for ~12 FLOPs:
// device-memory bandwidth, ~0.02 ms at the paper's CNN (144266 parameters,
// B = n = 5) with float32 history, against ~0.5 ms of host time for a
// launch per leaf.  So the design spends one launch an aggregate: the
// launcher copies the leaves' pointers, lengths and output offsets into a
// by-value kernel parameter (as csrc/sgd_update.cu does), and the grid
// walks (leaf, column block, b), so the small bias leaves ride in the same
// launch.  A thread takes four neighbouring columns of a row (16-byte
// loads of w, 4 history values in one load, 16-byte stores) where the
// leaf's rows are aligned to that, one column elsewhere, and loops over
// the n participants with the next participant's operands already
// loading.  Every operand is read once and every output written once.
// The outputs of all leaves are one flat array per output kind, leaf k at
// column start[k] (a multiple of 4) of each [B] or [B, n] row block.  The
// per-element arithmetic and the order over participants are those of the
// one-leaf kernel before it, so a run's rows do not move.  A zero
// coefficient adds exactly 0.
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int MAX_LEAVES = 64;  // 64 x 48 bytes of the kernel parameter
constexpr int THREADS = 256;
constexpr int VEC = 4;          // columns a thread on an aligned leaf

struct Leaves {
  const float* w[MAX_LEAVES];
  const void* prev[MAX_LEAVES];
  const void* dmean[MAX_LEAVES];
  long long L[MAX_LEAVES];
  long long start[MAX_LEAVES];   // first column of leaf k in the outputs
  int block[MAX_LEAVES + 1];     // first block of leaf k
  int vec[MAX_LEAVES];           // 1: VEC columns a thread
  int n;
};

struct Coef {                    // one participant's coefficients
  float m, cp, ce, nb;
};

// float8_e4m3fn as JAX casts: round to nearest even, NaN past 464
__device__ __forceinline__ unsigned to_f8(float x) {
  const unsigned r = __nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E4M3);
  return fabsf(x) <= 464.f ? r : (((__float_as_uint(x) >> 24) & 0x80u) | 0x7Fu);
}

__device__ __forceinline__ float from_f8(unsigned byte) {
  return __half2float(
      __half(__nv_cvt_fp8_to_halfraw((__nv_fp8_storage_t)byte, __NV_E4M3)));
}

__device__ __forceinline__ float from_bf16(unsigned short h) {
  return __uint_as_float((unsigned)h << 16);
}

__device__ __forceinline__ unsigned short to_bf16(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// one history value
__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return from_bf16(*reinterpret_cast<const unsigned short*>(p));
}
__device__ __forceinline__ float load1(const __nv_fp8_storage_t* p) {
  return from_f8(*p);
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *reinterpret_cast<unsigned short*>(p) = to_bf16(x);
}
__device__ __forceinline__ void store1(__nv_fp8_storage_t* p, float x) {
  *p = (__nv_fp8_storage_t)to_f8(x);
}

// VEC neighbouring history values in one load or store
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xFFFF0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xFFFF0000u));
}
__device__ __forceinline__ float4 load4(const __nv_fp8_storage_t* p) {
  const unsigned u = *reinterpret_cast<const unsigned*>(p);
  return make_float4(from_f8(u & 0xFFu), from_f8((u >> 8) & 0xFFu),
                     from_f8((u >> 16) & 0xFFu), from_f8(u >> 24));
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  uint2 u;
  u.x = (unsigned)to_bf16(v.x) | ((unsigned)to_bf16(v.y) << 16);
  u.y = (unsigned)to_bf16(v.z) | ((unsigned)to_bf16(v.w) << 16);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ void store4(__nv_fp8_storage_t* p, float4 v) {
  *reinterpret_cast<unsigned*>(p) =
      to_f8(v.x) | (to_f8(v.y) << 8) | (to_f8(v.z) << 16) | (to_f8(v.w) << 24);
}

// one element of one participant: the sum term into acc, the two history
// values out
__device__ __forceinline__ void mix(const Coef& k, float wv, float pv,
                                    float dv, float& acc, float& np,
                                    float& nd) {
  const float est = pv + dv;
  acc += k.cp * wv + k.ce * est;
  np = k.m * wv + (1.f - k.m) * est;
  const float mean = (dv * k.nb + (wv - pv)) / (k.nb + 1.f);
  nd = k.m * mean + (1.f - k.m) * dv;
}

template <typename H>
__global__ void __launch_bounds__(THREADS)
    hieavg_agg_kernel(const __grid_constant__ Leaves p,
                      const float* __restrict__ mask,
                      const float* __restrict__ cp,
                      const float* __restrict__ ce,
                      const float* __restrict__ nobs,
                      float* __restrict__ agg, H* __restrict__ nprev,
                      H* __restrict__ ndmean, int B, int n) {
  extern __shared__ Coef sk[];  // [n]
  int leaf = 0;
  while (blockIdx.x >= (unsigned)p.block[leaf + 1]) ++leaf;
  const int local = blockIdx.x - p.block[leaf];
  const int b = local % B;
  for (int j = threadIdx.x; j < n; j += THREADS) {
    const int i = b * n + j;
    sk[j] = Coef{mask[i], cp[i], ce[i], nobs[i]};
  }
  __syncthreads();
  const long long L = p.L[leaf];
  const size_t row = (size_t)b * n * L;    // participant 0 of edge b
  const float* w = p.w[leaf] + row;
  const H* pr = static_cast<const H*>(p.prev[leaf]) + row;
  const H* dm = static_cast<const H*>(p.dmean[leaf]) + row;
  const size_t out = (size_t)B * n * p.start[leaf] + row;
  H* np_ = nprev + out;
  H* nd_ = ndmean + out;
  float* ag = agg + (size_t)B * p.start[leaf] + (size_t)b * L;
  if (p.vec[leaf]) {
    const long long l =
        ((long long)(local / B) * THREADS + threadIdx.x) * VEC;
    if (l >= L) return;                     // L % VEC == 0
    float4 wv = load4(w + l), pv = load4(pr + l), dv = load4(dm + l);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < n; ++j) {
      const size_t o = (size_t)j * L + l;
      float4 wn = wv, pn = pv, dn = dv;
      if (j + 1 < n) {                      // the next participant's row
        wn = load4(w + o + L);
        pn = load4(pr + o + L);
        dn = load4(dm + o + L);
      }
      const Coef k = sk[j];
      float4 a, d;
      mix(k, wv.x, pv.x, dv.x, acc.x, a.x, d.x);
      mix(k, wv.y, pv.y, dv.y, acc.y, a.y, d.y);
      mix(k, wv.z, pv.z, dv.z, acc.z, a.z, d.z);
      mix(k, wv.w, pv.w, dv.w, acc.w, a.w, d.w);
      store4(np_ + o, a);
      store4(nd_ + o, d);
      wv = wn;
      pv = pn;
      dv = dn;
    }
    *reinterpret_cast<float4*>(ag + l) = acc;
  } else {
    const long long l = (long long)(local / B) * THREADS + threadIdx.x;
    if (l >= L) return;
    float acc = 0.f;
    for (int j = 0; j < n; ++j) {
      const size_t o = (size_t)j * L + l;
      float a, d;
      mix(sk[j], w[o], load1(pr + o), load1(dm + o), acc, a, d);
      store1(np_ + o, a);
      store1(nd_ + o, d);
    }
    ag[l] = acc;
  }
}

bool aligned(const void* q, size_t bytes) {
  return reinterpret_cast<uintptr_t>(q) % bytes == 0;
}

template <typename H>
int launch(Leaves& p, const float* const* vecs, float* agg, void* nprev,
           void* ndmean, int B, int n, cudaStream_t stream) {
  const size_t hb = sizeof(H) * VEC;      // bytes of VEC history values
  const bool outs = aligned(agg, 16) && aligned(nprev, hb) &&
                    aligned(ndmean, hb);
  long long blocks = 0;
  for (int k = 0; k < p.n; ++k) {
    p.vec[k] = outs && p.L[k] % VEC == 0 && p.start[k] % VEC == 0 &&
               aligned(p.w[k], 16) && aligned(p.prev[k], hb) &&
               aligned(p.dmean[k], hb);
    const long long cols = (long long)THREADS * (p.vec[k] ? VEC : 1);
    p.block[k] = (int)blocks;
    blocks += (long long)B * ((p.L[k] + cols - 1) / cols);
    if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  }
  p.block[p.n] = (int)blocks;
  if (blocks == 0) return 0;
  hieavg_agg_kernel<H><<<(unsigned)blocks, THREADS, n * sizeof(Coef),
                         stream>>>(p, vecs[0], vecs[1], vecs[2], vecs[3], agg,
                                   (H*)nprev, (H*)ndmean, B, n);
  return (int)cudaGetLastError();
}

}  // namespace

// leaves: host array of 3 * n_leaves device pointers (w, prev, dmean of
// each leaf); L, start: host arrays of each leaf's columns and its first
// column in the flat outputs; vecs: host array of the four [B, n] float32
// coefficient vectors (mask, coef_present, coef_est, n_obs); agg
// [B, sum], nprev/ndmean [B, n, sum] in the history type, sum the last
// leaf's start + L.  hist: 0 = float32, 1 = bfloat16, 2 = float8_e4m3fn
// (kernels/hieavg_agg.py:HIST_CODES).  At most MAX_LEAVES leaves.
extern "C" int hieavg_agg_launch(const void* const* leaves,
                                 const long long* L, const long long* start,
                                 int n_leaves, const float* const* vecs,
                                 float* agg, void* nprev, void* ndmean, int B,
                                 int n, int hist, void* stream) {
  if (n_leaves < 0 || n_leaves > MAX_LEAVES) return (int)cudaErrorInvalidValue;
  if (B == 0 || n == 0) return 0;
  Leaves p;
  p.n = n_leaves;
  for (int k = 0; k < n_leaves; ++k) {
    p.w[k] = static_cast<const float*>(leaves[3 * k]);
    p.prev[k] = leaves[3 * k + 1];
    p.dmean[k] = leaves[3 * k + 2];
    p.L[k] = L[k];
    p.start[k] = start[k];
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (hist) {
    case 0:
      return launch<float>(p, vecs, agg, nprev, ndmean, B, n, s);
    case 1:
      return launch<__nv_bfloat16>(p, vecs, agg, nprev, ndmean, B, n, s);
    case 2:
      return launch<__nv_fp8_storage_t>(p, vecs, agg, nprev, ndmean, B, n, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
