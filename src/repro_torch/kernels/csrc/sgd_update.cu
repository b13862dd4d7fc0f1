// The train step's SGD update out = w - s * g on every leaf of a model in
// one launch, for sm_90a; s is one host float, or one entry of a vector of
// per-row scales.
//
// Replaces the Pallas kernel src/repro/kernels/sgd_update.py:sgd_update
// (a [n, 2048] VMEM tile per grid step, one call per leaf, vmapped over a
// sweep's points with one scale each).  Here the leading device axis is
// just part of each leaf's flat index, and one launch takes every leaf of
// a local step: the launcher copies the leaves' pointers, their offsets in
// the concatenated index space and their row lengths into a by-value
// kernel parameter (as PyTorch's multi_tensor_apply does), and the grid
// walks that index space, each thread finding its leaf from the offsets.
// The output is one flat array in that index space, so every leaf's result
// is a view of one allocation.
//
// A sweep folds its points into the leading axis (D = points x devices),
// and the points differ in lr (lr0, lr_decay, padded rounds) and in which
// steps are real (a padded step scales by 0): then every leaf row d takes
// its own scale[d], the row found per element from the leaf's row length.
// One element a thread, so no access spans two rows.  A standalone run
// passes one host float, and that path is the one-scale kernel as before.
//
// What bounds it on the H100: 12 bytes per element (read w and g, write
// out) for 2 FLOPs: device-memory bandwidth, 3.35 TB/s; at the paper's
// CNN (144266 parameters x 25 devices in six leaves) 0.013 ms, which is
// less than the host's cost of a launch.  So the design spends one launch
// a step, not one a leaf: one read of each operand and one write,
// neighbouring threads on neighbouring addresses; the per-row scales
// (4 bytes a row) stay in L1.  The multiply and the subtract are rounded
// separately (no FMA contraction), as the plain PyTorch version rounds
// them, and s = 0 is an exact identity.
#include <cuda_runtime.h>

namespace {

constexpr int MAX_LEAVES = 64;  // 64 x 32 bytes of pointers and offsets

struct Leaves {
  const float* w[MAX_LEAVES];
  const float* g[MAX_LEAVES];
  long long start[MAX_LEAVES + 1];  // leaf i is [start[i], start[i + 1])
  long long row[MAX_LEAVES];        // elements a row of leaf i (numel/rows)
  int n;
};

// ROWS: the scale of element i of a leaf is scale[i / row], else s
template <bool ROWS>
__global__ void sgd_update_kernel(const __grid_constant__ Leaves p,
                                  float* __restrict__ out, float s,
                                  const float* __restrict__ scale) {
  const long long total = p.start[p.n];
  const long long stride = (long long)gridDim.x * blockDim.x;
  int leaf = 0;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    while (e >= p.start[leaf + 1]) ++leaf;   // e only grows
    const long long i = e - p.start[leaf];
    float si = s;
    if (ROWS) {
      const long long len = p.row[leaf];
      // a 32-bit division where both fit, the 64-bit one elsewhere
      const long long r = ((i | len) >> 32) == 0
                              ? (long long)((unsigned)i / (unsigned)len)
                              : i / len;
      si = scale[r];
    }
    out[e] = __fsub_rn(p.w[leaf][i], __fmul_rn(si, p.g[leaf][i]));
  }
}

}  // namespace

// w, g: host arrays of n device pointers; numel: host array of n element
// counts; out: the flat output of numel's sum; s: the scale of every row,
// or, where scale is not null, scale: a device vector of one scale per row
// of every leaf, each leaf's numel rows * its row length.  At most
// MAX_LEAVES leaves.
extern "C" int sgd_update_launch(const float* const* w,
                                 const float* const* g,
                                 const long long* numel, int n, float* out,
                                 float s, const float* scale, long long rows,
                                 void* stream) {
  if (n < 0 || n > MAX_LEAVES) return (int)cudaErrorInvalidValue;
  Leaves p;
  p.n = n;
  p.start[0] = 0;
  for (int i = 0; i < n; ++i) {
    p.w[i] = w[i];
    p.g[i] = g[i];
    p.start[i + 1] = p.start[i] + numel[i];
    if (scale != nullptr && numel[i] > 0) {
      if (rows <= 0 || numel[i] % rows) return (int)cudaErrorInvalidValue;
      p.row[i] = numel[i] / rows;
    } else {
      p.row[i] = 1;
    }
  }
  const long long total = p.start[n];
  if (total == 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 65536) blocks = 65536;
  cudaStream_t st = (cudaStream_t)stream;
  if (scale != nullptr)
    sgd_update_kernel<true><<<(unsigned)blocks, threads, 0, st>>>(p, out, s,
                                                                  scale);
  else
    sgd_update_kernel<false><<<(unsigned)blocks, threads, 0, st>>>(
        p, out, s, nullptr);
  return (int)cudaGetLastError();
}
