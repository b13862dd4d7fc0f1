// The classifier head's correct-count: rows where argmax(f W + b) == y,
// for sm_90a.  The logits are never stored.
//
// Replaces the Pallas kernel src/repro/kernels/eval_head.py:eval_head
// (a [256, F] feature tile against the whole [F, C] matrix in VMEM, one
// int32 partial count per tile, summed outside).
//
// What bounds it on the H100: at the paper's DEFAULT widths f is
// [n_test, 12544] float32 (50 MB at n_test = 1000) against 2*F*C = 251k
// FLOPs per row: device-memory bandwidth on f, 0.015 ms; at C = 100 the
// FP32 FLOPs, 0.037 ms.  Few rows and a long F: a block per row tile alone
// gives fewer blocks than SMs, each streaming all of W.  Design (split F):
//   * a block takes one slice of FS = 512 features and one tile of CT = 16
//     classes; its slice of W goes into shared memory once, transposed to
//     [class][feature] and zero-padded past C and F, behind one barrier;
//     then it walks row tiles of RB = 32 rows, every G-th, G picked so
//     that the grid fills the card in few waves of equal blocks (M =
//     1000, C = 10: 25 slices x 8 row groups of 4 tiles = 200 blocks);
//   * a warp owns 4 rows of a tile; each lane reads 4 neighbouring
//     features of each row with a 16-byte load (the next 128 features, or
//     the next tile's first, already loading) and holds 4 x 16 partial
//     logits, so one 16-byte read of W serves 4 rows;
//   * the 64 partial logits of a warp are summed over its lanes by a
//     butterfly that halves what each lane holds at every step (62
//     shuffles, not 64 x 5), leaving two per lane, written to a
//     [S, M, C] workspace of the slices' partial logits;
//   * a second pass, a warp a row, sums the S partials of each logit in
//     slice order, adds the bias, takes the first maximum (strict >, ties
//     to the lower class, as argmax does), compares it with the label (-1
//     never matches) and adds its block's hits to the int64 count with an
//     integer atomic.  (Done by the last block of the first pass to reach
//     a row tile instead, the argmax ran behind that block's later tiles,
//     serially: 1.2 ms at C = 100.)
// No float atomics: the count is the same bits on every run.  Any C: the
// classes are tiled, tile by tile along the grid's fastest axis, so the
// blocks of one slice and row group read f while it is in L2.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RW = 4;             // rows a warp
constexpr int RB = WARPS * RW;    // rows a block
constexpr int CT = 16;            // classes a tile
constexpr int FS = 512;           // features a slice
constexpr int FSP = FS + 4;       // a class's row in shared memory
constexpr int QS = FS / 128;      // 128-feature steps a slice
constexpr int NV = RW * CT;       // partial logits a thread: 64
constexpr int WLOAD = CT * FS / THREADS;  // W loads a thread

static_assert(NV == 64, "the butterfly leaves NV / 32 = 2 sums a lane");

template <bool VEC>
__device__ __forceinline__ float4 load_f(const float* p, int ff, int fs,
                                         bool ok) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (!ok || ff >= fs) return v;
  if (VEC) return __ldg(reinterpret_cast<const float4*>(p + ff));
  v.x = p[ff];
  if (ff + 1 < fs) v.y = p[ff + 1];
  if (ff + 2 < fs) v.z = p[ff + 2];
  if (ff + 3 < fs) v.w = p[ff + 3];
  return v;
}

// one butterfly step: lanes that differ in bit O swap halves of their
// first 2*O sums; each keeps one half, plus its partner's
template <int O>
__device__ __forceinline__ void fold(float (&v)[NV], int lane) {
  const bool up = (lane & O) != 0;
#pragma unroll
  for (int i = 0; i < 2 * O; ++i) {
    const float send = up ? v[i] : v[i + 2 * O];
    const float keep = up ? v[i + 2 * O] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// The second pass, a warp a row: lane l sums the S slice partials of
// classes l, l + 32, ... in slice order, adds the bias and keeps its first
// maximum; the warp takes the first maximum of its lanes' (ties to the
// lower class), compares it with the label, and the block adds its hits
// to the count.
__global__ void __launch_bounds__(THREADS)
    eval_head_argmax_kernel(const float* __restrict__ part,
                            const float* __restrict__ bias,
                            const int* __restrict__ labels,
                            unsigned long long* __restrict__ count, int M,
                            int C, int S) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  float best = -INFINITY;
  int arg = INT_MAX;
  if (row < M) {
    for (int c = lane; c < C; c += 32) {
      const float* p = part + (size_t)row * C + c;
      float z = 0.f;
#pragma unroll 8
      for (int s2 = 0; s2 < S; ++s2) z += p[(size_t)s2 * M * C];
      z += bias[c];
      if (arg == INT_MAX || z > best) {
        best = z;
        arg = c;
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, o);
    const int oa = __shfl_xor_sync(0xffffffffu, arg, o);
    if (ob > best || (ob == best && oa < arg)) {
      best = ob;
      arg = oa;
    }
  }
  const int hits =
      __syncthreads_count(lane == 0 && row < M && arg == labels[row]);
  if (threadIdx.x == 0 && hits > 0)
    atomicAdd(count, (unsigned long long)hits);
}

// Block (class tile ct, feature slice s, row group g) of the first pass
// loads its W slice once and walks row tiles g, g + G, ...: the partial
// logits of each tile's 32 rows.
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
    eval_head_kernel(const float* __restrict__ f, const float* __restrict__ W,
                     float* __restrict__ part, unsigned long long* count,
                     int M, int F, int C, int S, int nct, int G) {
  __shared__ __align__(16) float sW[CT * FSP];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (blockIdx.x == 0 && tid == 0) *count = 0;   // the argmax pass adds
  const int ct = blockIdx.x % nct;
  const int s = (blockIdx.x / nct) % S;
  const int g = blockIdx.x / (nct * S);
  const int c0 = ct * CT, f0 = s * FS, fs = min(FS, F - f0);
  const int tiles = (M + RB - 1) / RB;

  // a tile's rows of this warp: the first one's features and how many
  // of the warp's RW rows lie in f
  auto rows = [&](int rt, const float*& base, int& valid) {
    const int row0 = rt * RB + warp * RW;
    valid = rt < tiles ? min(RW, M - row0) : 0;
    base = f + (size_t)(valid > 0 ? row0 : 0) * F + f0;
  };
  int rt = g, valid;
  const float* fb;
  rows(rt, fb, valid);
  float4 x[RW];                     // the first features load meanwhile
#pragma unroll
  for (int r = 0; r < RW; ++r)
    x[r] = load_f<VEC>(fb + (size_t)r * F, 4 * lane, fs, r < valid);

  {  // the W slice, transposed: sW[c][ff] = W[f0 + ff][c0 + c]
    float wv[WLOAD];
#pragma unroll
    for (int k = 0; k < WLOAD; ++k) {
      const int i = tid + k * THREADS, ff = i / CT, c = i % CT;
      wv[k] = ff < fs && c0 + c < C ? W[(size_t)(f0 + ff) * C + c0 + c] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < WLOAD; ++k) {
      const int i = tid + k * THREADS;
      sW[(i % CT) * FSP + i / CT] = wv[k];
    }
  }
  __syncthreads();

  for (; rt < tiles; rt += G) {
    const float* nb;                // the next tile's rows
    int nvalid;
    rows(rt + G, nb, nvalid);
    float acc[NV];                  // acc[r * CT + c]
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[i] = 0.f;
#pragma unroll
    for (int q = 0; q < QS; ++q) {
      const int ff = 128 * q + 4 * lane;
      float4 nx[RW];                // the next 128 features, or the next
#pragma unroll                      // tile's first
      for (int r = 0; r < RW; ++r)
        nx[r] = q + 1 < QS
                    ? load_f<VEC>(fb + (size_t)r * F, ff + 128, fs, r < valid)
                    : load_f<VEC>(nb + (size_t)r * F, 4 * lane, fs,
                                  r < nvalid);
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        const float4 w4 = *reinterpret_cast<const float4*>(&sW[c * FSP + ff]);
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          float a = acc[r * CT + c];
          a = fmaf(x[r].x, w4.x, a);
          a = fmaf(x[r].y, w4.y, a);
          a = fmaf(x[r].z, w4.z, a);
          a = fmaf(x[r].w, w4.w, a);
          acc[r * CT + c] = a;
        }
      }
#pragma unroll
      for (int r = 0; r < RW; ++r) x[r] = nx[r];
    }

    // the lanes' sums: lane l ends with logits 2l and 2l + 1 of the warp's
    // 4 x 16, i.e. row l / 8, classes 2 (l % 8) and 2 (l % 8) + 1
    fold<16>(acc, lane);
    fold<8>(acc, lane);
    fold<4>(acc, lane);
    fold<2>(acc, lane);
    fold<1>(acc, lane);
    {
      const int row = rt * RB + warp * RW + (lane >> 3);
      const int c = c0 + 2 * (lane & 7);
      if (row < M) {
        float* p = part + ((size_t)s * M + row) * C + c;
        if (c < C) p[0] = acc[0];
        if (c + 1 < C) p[1] = acc[1];
      }
    }
    fb = nb;
    valid = nvalid;
  }
}

int slots(const void* kernel) {   // blocks the card holds at once
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
  return (per_sm > 0 ? per_sm : 1) * sms;
}

template <bool VEC>
int partials(const float* feats, const float* wmat, float* part,
             unsigned long long* count, int M, int F, int C, int S, int nct,
             int tiles, cudaStream_t st) {
  static const int held = slots((const void*)eval_head_kernel<VEC>);
  // row groups G: the fewest that minimise waves x row tiles a block (the
  // card holds `held` blocks at once), each group the same number of
  // tiles.  M = 1000: C = 10 takes 8 groups of 4 tiles (200 blocks, one
  // wave), C = 100 3 groups of 11 (525 blocks, two waves).
  long long cost = LLONG_MAX;
  int per = tiles;
  for (int g = 1; g <= tiles; ++g) {
    const int p = (tiles + g - 1) / g;
    const long long waves = ((long long)g * S * nct + held - 1) / held;
    if (waves * p < cost) {
      cost = waves * p;
      per = p;
    }
  }
  const int G = (tiles + per - 1) / per;
  const long long blocks = (long long)G * S * nct;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  eval_head_kernel<VEC><<<(unsigned)blocks, THREADS, 0, st>>>(
      feats, wmat, part, count, M, F, C, S, nct, G);
  return (int)cudaGetLastError();
}

}  // namespace

// count: int64 scalar; part: float32 [S, M, C] workspace of the partial
// logits, S = max(1, ceil(F / 512)) (kernels/eval_head.py mirrors it).
// Two launches: the partial logits (which also zero the count), then the
// argmax a row tile.
extern "C" int eval_head_launch(const float* feats, const float* wmat,
                                const float* bias, const int* labels,
                                float* part, long long* count, int M, int F,
                                int C, void* stream) {
  if (M < 0 || F < 0 || C < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned long long* cnt = reinterpret_cast<unsigned long long*>(count);
  if (M == 0) return (int)cudaMemsetAsync(count, 0, sizeof(long long), st);
  const int S = F > FS ? (F + FS - 1) / FS : 1;
  const int nct = (C + CT - 1) / CT;
  const int tiles = (M + RB - 1) / RB;
  const int rc =
      F % 4 == 0 && reinterpret_cast<uintptr_t>(feats) % 16 == 0
          ? partials<true>(feats, wmat, part, cnt, M, F, C, S, nct, tiles, st)
          : partials<false>(feats, wmat, part, cnt, M, F, C, S, nct, tiles,
                            st);
  if (rc != 0) return rc;
  eval_head_argmax_kernel<<<(M + WARPS - 1) / WARPS, THREADS, 0, st>>>(
      part, bias, labels, cnt, M, C, S);
  return (int)cudaGetLastError();
}
