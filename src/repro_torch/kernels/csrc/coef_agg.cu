// The coefficient-weighted aggregates over every leaf of a model in one
// launch, for sm_90a:
//
//   coef_agg:      out[b, l] = sum_n c[b, n] * w[b, n, l]
//   coef_agg_pair: out[b, l] = sum_n ca[b, n] * w[b, n, l] + cb[b, n] * aux[b, n, l]
//
// The first is the cold-boot mean of both HieAvg layers (eq. 2/3) and
// FedAvg; the second the delayed-gradient mix, where a missing slot adds
// its staleness-discounted pending update (aux) in place of a fresh one.
//
// Replaces the Pallas kernels src/repro/kernels/coef_agg.py:coef_agg (:62)
// and :coef_agg_pair (:88), which the JAX package calls once per leaf and
// vmaps over the engine's edge axis.  Here one launch takes every leaf of
// an aggregate: leaf k is w (and aux) [B, n, L_k] float32 (B edges of n
// participants, or B = 1 at the global layer), and the coefficients
// c [B, n], or [B, 2, n] = (ca, cb) for the pair, are shared by all
// leaves.  The outputs of all leaves are one flat float32 array [B, sum],
// leaf k at column start[k] (a multiple of 4) of each row block.
//
// What bounds them on the H100: per column 4n (pair: 8n) bytes read and 4
// written for 2n (pair: 4n) FLOPs: device-memory bandwidth.  At the
// paper's CNN (six leaves, 144266 parameters, B = n = 5) that is 17.3 MB,
// 0.0052 ms at 3.35 TB/s, and 31.7 MB, 0.0095 ms, for the pair, against
// ~0.03 ms of host time a launch when each leaf took its own.  So the
// design spends one launch an aggregate: the launcher copies the leaves'
// pointers, lengths, output offsets and 16-byte flags into a by-value
// kernel parameter (as csrc/hieavg_agg.cu does), and the grid walks
// (leaf, column block, b), so the small bias leaves ride in the same
// launch as the 125440-column dense leaf.  A thread takes four
// neighbouring columns of a row with 16-byte loads and stores where the
// wrapper found the leaf's rows aligned to that, one column elsewhere, and
// loops over the n participants with the next participant's operands
// already loading.  Every operand is read once and every output written
// once; the coefficients are read once per block into shared memory.
// The per-element expression and the order over participants are those of
// the one-leaf kernels before it, so a run's rows do not move.  A zero
// coefficient (a padded or dropped slot) adds exactly 0.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int MAX_LEAVES = 64;  // 64 x 40 bytes of the kernel parameter
constexpr int THREADS = 256;
constexpr int VEC = 4;          // columns a thread on an aligned leaf

struct Leaves {
  const float* w[MAX_LEAVES];
  const float* aux[MAX_LEAVES];  // the pair's second operand
  long long L[MAX_LEAVES];
  long long start[MAX_LEAVES];   // first column of leaf k in the output
  int block[MAX_LEAVES + 1];     // first block of leaf k
  int vec[MAX_LEAVES];           // 1: VEC columns a thread
  int n;
};

// one participant's term of one element
__device__ __forceinline__ void term(float& acc, const float* sc, int j,
                                     int n, float wv, float xv, bool pair) {
  if (pair)
    acc += sc[j] * wv + sc[n + j] * xv;
  else
    acc += sc[j] * wv;
}

template <bool PAIR>
__global__ void __launch_bounds__(THREADS)
    coef_agg_kernel(const __grid_constant__ Leaves p,
                    const float* __restrict__ coef, float* __restrict__ out,
                    int B, int n) {
  extern __shared__ float sc[];  // [n], or [2, n]: ca then cb
  int leaf = 0;
  while (blockIdx.x >= (unsigned)p.block[leaf + 1]) ++leaf;
  const int local = blockIdx.x - p.block[leaf];
  const int b = local % B;
  const int nc = PAIR ? 2 * n : n;
  for (int i = threadIdx.x; i < nc; i += THREADS)
    sc[i] = coef[(size_t)b * nc + i];
  __syncthreads();
  const long long L = p.L[leaf];
  const size_t row = (size_t)b * n * L;    // participant 0 of edge b
  const float* w = p.w[leaf] + row;
  const float* x = PAIR ? p.aux[leaf] + row : nullptr;
  float* o = out + (size_t)B * p.start[leaf] + (size_t)b * L;
  if (p.vec[leaf]) {
    const long long l =
        ((long long)(local / B) * THREADS + threadIdx.x) * VEC;
    if (l >= L) return;                     // L % VEC == 0
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 wv = zero, xv = zero;
    if (n > 0) {
      wv = *reinterpret_cast<const float4*>(w + l);
      if (PAIR) xv = *reinterpret_cast<const float4*>(x + l);
    }
    float4 acc = zero;
    for (int j = 0; j < n; ++j) {
      float4 wn = wv, xn = xv;
      if (j + 1 < n) {                      // the next participant's row
        const size_t o1 = (size_t)(j + 1) * L + l;
        wn = *reinterpret_cast<const float4*>(w + o1);
        if (PAIR) xn = *reinterpret_cast<const float4*>(x + o1);
      }
      term(acc.x, sc, j, n, wv.x, xv.x, PAIR);
      term(acc.y, sc, j, n, wv.y, xv.y, PAIR);
      term(acc.z, sc, j, n, wv.z, xv.z, PAIR);
      term(acc.w, sc, j, n, wv.w, xv.w, PAIR);
      wv = wn;
      xv = xn;
    }
    *reinterpret_cast<float4*>(o + l) = acc;
  } else {
    const long long l = (long long)(local / B) * THREADS + threadIdx.x;
    if (l >= L) return;
    float acc = 0.f;
    for (int j = 0; j < n; ++j) {
      const size_t i = (size_t)j * L + l;
      term(acc, sc, j, n, w[i], PAIR ? x[i] : 0.f, PAIR);
    }
    o[l] = acc;
  }
}

bool aligned(const void* q) {
  return reinterpret_cast<uintptr_t>(q) % 16 == 0;
}

template <bool PAIR>
int launch(const void* const* leaves, const long long* L,
           const long long* start, const int* vec, int n_leaves,
           const float* coef, float* out, int B, int n, void* stream) {
  if (n_leaves < 0 || n_leaves > MAX_LEAVES || B < 0 || n < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  Leaves p;
  p.n = n_leaves;
  const int ops = PAIR ? 2 : 1;             // operands a leaf
  long long blocks = 0;
  for (int k = 0; k < n_leaves; ++k) {
    p.w[k] = static_cast<const float*>(leaves[ops * k]);
    p.aux[k] = PAIR ? static_cast<const float*>(leaves[ops * k + 1])
                    : nullptr;
    p.L[k] = L[k];
    p.start[k] = start[k];
    p.vec[k] = vec[k];
    // the wrapper's 16-byte flag, held to what a float4 access needs: a
    // misaligned one would fault the context, so it is refused here
    if (vec[k] && (L[k] % VEC || start[k] % VEC || !aligned(out) ||
                   !aligned(p.w[k]) || (PAIR && !aligned(p.aux[k]))))
      return (int)cudaErrorMisalignedAddress;
    const long long cols = (long long)THREADS * (vec[k] ? VEC : 1);
    p.block[k] = (int)blocks;
    blocks += (long long)B * ((L[k] + cols - 1) / cols);
    if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  }
  p.block[n_leaves] = (int)blocks;
  if (blocks == 0) return 0;
  coef_agg_kernel<PAIR><<<(unsigned)blocks, THREADS,
                          (PAIR ? 2 : 1) * n * sizeof(float),
                          (cudaStream_t)stream>>>(p, coef, out, B, n);
  return (int)cudaGetLastError();
}

}  // namespace

// leaves: host array of the leaves' device pointers (w of each leaf; the
// pair: w, aux of each leaf); L, start: host arrays of each leaf's columns
// and its first column in the flat output; vec: host array of each leaf's
// 16-byte flag (1 where L % 4 == 0 and every operand of the leaf is
// 16-byte aligned); coef [B, n] float32 (the pair: [B, 2, n], ca then
// cb); out [B, sum] float32, sum the last leaf's start + L.  At most
// MAX_LEAVES leaves.
extern "C" int coef_agg_launch(const void* const* leaves, const long long* L,
                               const long long* start, const int* vec,
                               int n_leaves, const float* coef, float* out,
                               int B, int n, void* stream) {
  return launch<false>(leaves, L, start, vec, n_leaves, coef, out, B, n,
                       stream);
}

extern "C" int coef_agg_pair_launch(const void* const* leaves,
                                    const long long* L,
                                    const long long* start, const int* vec,
                                    int n_leaves, const float* coef,
                                    float* out, int B, int n, void* stream) {
  return launch<true>(leaves, L, start, vec, n_leaves, coef, out, B, n,
                      stream);
}
