// The train step's SGD update out = w - s * g on one flat leaf, for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/sgd_update.py:sgd_update
// (a [n, 2048] VMEM tile per grid step).  Here the leading device axis is
// just part of the flat index: one thread per element, grid-strided.
//
// What bounds it on the H100: 12 bytes per element (read w and g, write
// out) for 2 FLOPs: device-memory bandwidth, 3.35 TB/s.  Design: one
// read of each operand and one write, neighbouring threads on
// neighbouring addresses, and nothing else.  The multiply and the
// subtract are rounded separately (no FMA contraction), as the plain
// PyTorch version rounds them, and s = 0 is an exact identity.
#include <cuda_runtime.h>

namespace {

__global__ void sgd_update_kernel(const float* __restrict__ w,
                                  const float* __restrict__ g,
                                  float* __restrict__ out, long long n,
                                  float s) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = __fsub_rn(w[i], __fmul_rn(s, g[i]));
}

}  // namespace

extern "C" int sgd_update_launch(const float* w, const float* g, float* out,
                                 long long n, float s, void* stream) {
  if (n == 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 65536) blocks = 65536;
  sgd_update_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      w, g, out, n, s);
  return (int)cudaGetLastError();
}
