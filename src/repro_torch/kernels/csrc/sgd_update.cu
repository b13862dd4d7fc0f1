// The train step's SGD update out = w - s * g on every leaf of a model in
// one launch, for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/sgd_update.py:sgd_update
// (a [n, 2048] VMEM tile per grid step, one call per leaf).  Here the
// leading device axis is just part of each leaf's flat index, and one
// launch takes every leaf of a local step: the launcher copies the leaves'
// pointers and their offsets in the concatenated index space into a
// by-value kernel parameter (as PyTorch's multi_tensor_apply does), and
// the grid walks that index space, each thread finding its leaf from the
// offsets.  The output is one flat array in that index space, so every
// leaf's result is a view of one allocation.
//
// What bounds it on the H100: 12 bytes per element (read w and g, write
// out) for 2 FLOPs: device-memory bandwidth, 3.35 TB/s; at the paper's
// CNN (144266 parameters x 25 devices in six leaves) 0.013 ms, which is
// less than the host's cost of a launch.  So the design spends one launch
// a step, not one a leaf: one read of each operand and one write,
// neighbouring threads on neighbouring addresses.  The multiply and the
// subtract are rounded separately (no FMA contraction), as the plain
// PyTorch version rounds them, and s = 0 is an exact identity.
#include <cuda_runtime.h>

namespace {

constexpr int MAX_LEAVES = 64;  // 64 x 24 bytes of pointers and offsets

struct Leaves {
  const float* w[MAX_LEAVES];
  const float* g[MAX_LEAVES];
  long long start[MAX_LEAVES + 1];  // leaf i is [start[i], start[i + 1])
  int n;
};

__global__ void sgd_update_kernel(const __grid_constant__ Leaves p,
                                  float* __restrict__ out, float s) {
  const long long total = p.start[p.n];
  const long long stride = (long long)gridDim.x * blockDim.x;
  int leaf = 0;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    while (e >= p.start[leaf + 1]) ++leaf;   // e only grows
    const long long i = e - p.start[leaf];
    out[e] = __fsub_rn(p.w[leaf][i], __fmul_rn(s, p.g[leaf][i]));
  }
}

}  // namespace

// w, g: host arrays of n device pointers; numel: host array of n element
// counts; out: the flat output of numel's sum.  At most MAX_LEAVES leaves.
extern "C" int sgd_update_launch(const float* const* w,
                                 const float* const* g,
                                 const long long* numel, int n, float* out,
                                 float s, void* stream) {
  if (n < 0 || n > MAX_LEAVES) return (int)cudaErrorInvalidValue;
  Leaves p;
  p.n = n;
  p.start[0] = 0;
  for (int i = 0; i < n; ++i) {
    p.w[i] = w[i];
    p.g[i] = g[i];
    p.start[i + 1] = p.start[i] + numel[i];
  }
  const long long total = p.start[n];
  if (total == 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 65536) blocks = 65536;
  sgd_update_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      p, out, s);
  return (int)cudaGetLastError();
}
