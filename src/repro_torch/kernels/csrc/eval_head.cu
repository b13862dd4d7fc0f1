// The classifier head's correct-count: rows where argmax(f W + b) == y,
// for sm_90a.  The logits are never stored.
//
// Replaces the Pallas kernel src/repro/kernels/eval_head.py:eval_head
// (a [256, F] feature tile against the whole [F, C] matrix in VMEM, one
// int32 partial count per tile).
//
// What bounds it on the H100: at the paper's DEFAULT widths f is
// [n_test, 12544] float32 (50 MB at n_test = 1000) against 2*F*C = 251k
// FLOPs per row: device-memory bandwidth on f.  W is 502 KB and does not
// fit in shared memory.  Design: one warp per row, eight rows per block.
// The block stages W through shared memory in chunks of FC features, so
// each chunk is read from L2 once per eight rows.  The lanes of a warp
// read neighbouring features (coalesced).  Each thread loads its whole
// chunk of f, and its share of the W chunk, into registers before using
// any of it: with one warp per row the loads must be in flight together,
// or each waits out a memory latency in turn.  The lanes keep C partial
// logits in registers, reduced by shuffles at the end.  Lane 0 takes the
// first maximum (strict >, as argmax does), compares it with the label
// (-1 never matches) and adds to the block's count; one int32 per block
// is written and summed outside.
#include <cuda_runtime.h>

namespace {

constexpr int CMAX = 16;         // classes held in registers
constexpr int FC = 512;          // features per chunk: 32 KB of W
constexpr int WARPS = 8;         // rows per block
constexpr int WLOAD = FC * CMAX / (WARPS * 32);  // W loads per thread

__global__ void __launch_bounds__(WARPS * 32)
    eval_head_kernel(const float* __restrict__ f, const float* __restrict__ W,
                     const float* __restrict__ bias,
                     const int* __restrict__ labels, int* __restrict__ counts,
                     int M, int F, int C) {
  __shared__ float sW[FC * CMAX];
  __shared__ int s_count;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * WARPS + warp;
  if (threadIdx.x == 0) s_count = 0;
  float acc[CMAX];
#pragma unroll
  for (int c = 0; c < CMAX; ++c) acc[c] = 0.f;

  for (int f0 = 0; f0 < F; f0 += FC) {
    const int fc = F - f0 < FC ? F - f0 : FC;
    // the row's chunk of f goes into registers first: FC / 32 loads in
    // flight per lane, started before the block waits for W
    float x[FC / 32];
    const float* fr = f + (size_t)row * F + f0;
#pragma unroll
    for (int q = 0; q < FC / 32; ++q) {
      const int ff = lane + 32 * q;
      x[q] = (row < M && ff < fc) ? fr[ff] : 0.f;
    }
    // and so does this block's share of the W chunk
    float wv[WLOAD];
#pragma unroll
    for (int q = 0; q < WLOAD; ++q) {
      const int i = threadIdx.x + q * WARPS * 32;
      wv[q] = i < fc * C ? W[(size_t)f0 * C + i] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < WLOAD; ++q) {
      const int i = threadIdx.x + q * WARPS * 32;
      if (i < fc * C) sW[i] = wv[q];
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < FC / 32; ++q) {
      const int ff = lane + 32 * q;
      if (ff < fc) {
#pragma unroll
        for (int c = 0; c < CMAX; ++c)
          if (c < C) acc[c] = fmaf(x[q], sW[ff * C + c], acc[c]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < CMAX; ++c)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
  if (lane == 0 && row < M) {
    int best = 0;
    float top = acc[0] + bias[0];
#pragma unroll
    for (int c = 1; c < CMAX; ++c) {
      if (c < C) {
        const float z = acc[c] + bias[c];
        if (z > top) { top = z; best = c; }
      }
    }
    if (best == labels[row]) atomicAdd(&s_count, 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) counts[blockIdx.x] = s_count;
}

}  // namespace

extern "C" int eval_head_launch(const float* feats, const float* wmat,
                                const float* bias, const int* labels,
                                int* block_counts, int M, int F, int C,
                                void* stream) {
  if (M == 0) return 0;
  if (C < 1 || C > CMAX) return (int)cudaErrorInvalidValue;
  const int blocks = (M + WARPS - 1) / WARPS;
  eval_head_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      feats, wmat, bias, labels, block_counts, M, F, C);
  return (int)cudaGetLastError();
}
