// The conv block's im2col matmul with its bias + ReLU epilogue, and its
// backward, as batched FP32 GEMMs for sm_90a.
//
// Replaces the Pallas kernels of src/repro/kernels/conv3x3.py:
// _fwd_call (relu(cols @ W + b) per 256-row tile) and _bwd_call
// (dz = dy * (y > 0), dcols = dz W^T, per-tile dW = cols^T dz and
// db = sum dz partials summed outside).  The TPU kernels get the stacked
// device axis from vmap; here it is the grid's z axis.
//
// What bounds it on the H100: at the paper's DEFAULT widths the second
// layer is [D*B*784, 288] x [288, 64] per device, 2*M*K*N = 23 GFLOP per
// direction per SGD step against ~0.9 GB of operands: above the FP32
// ridge (67 TFLOP/s over 3.35 TB/s = 20 FLOP/B), so it is bound by FP32
// operations.  TF32 and the tensor cores would lift that bound; the port
// stays in full FP32 on this path (a later, opt-in mode).
//
// Design: one GEMM template for the three products.  A 64x64 output tile
// per 256-thread block, each thread a 4x4 micro-tile at stride 16 (so a
// half-warp stores 16 consecutive floats), the reduction staged through
// shared memory 16 deep.  The tile loaders know each operand's layout
// and read along its contiguous axis; ragged M, K and N are masked with
// zeros, never padded by a copy.  The relu mask of the backward is
// applied as dz is loaded, so dz is never stored.  dW and db are one
// product: the cols^T operand gets an extra row of ones, whose output row
// is sum(dz) = db.  Each z-block reduces a fixed run of rows into its own
// [K+1, N] partial; torch.sum adds the partials outside, so the result is
// deterministic (no atomics).
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;   // output rows per block
constexpr int BN = 64;   // output cols per block
constexpr int BK = 16;   // reduction depth per shared-memory stage
constexpr int NT = 256;  // threads per block (16 x 16)

enum Mode { FWD = 0, DCOLS = 1, DW = 2 };

struct Params {
  const float* cols;  // [D, M, K]
  const float* wmat;  // [D, K, N]
  const float* bias;  // [D, N]               (FWD)
  const float* y;     // [D, M, N]  relu out  (DCOLS, DW)
  const float* dy;    // [D, M, N]            (DCOLS, DW)
  float* out;         // FWD y [D, M, N]; DCOLS dcols [D, M, K];
                      // DW partials [D, nt, K + 1, N]
  long long M;
  int K, N;
  int rows;           // DW: rows reduced per partial
  int nt;             // DW: partials per device
};

// The GEMM view per mode (output OM x ON, reduction R):
//   FWD   A(i, r) = cols[i, r]           B(r, j) = W[r, j]    OM=M  ON=N R=K
//   DCOLS A(i, r) = dz[i, r]             B(r, j) = W[j, r]    OM=M  ON=K R=N
//   DW    A(i, r) = cols[m0 + r, i] | 1  B(r, j) = dz[m0+r,j] OM=K+1 ON=N
//                                                             R=rows
template <int MODE>
__global__ void __launch_bounds__(NT) gemm_kernel(const Params p) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const long long i0 = (long long)blockIdx.x * BM;
  const int j0 = blockIdx.y * BN;

  int d;
  long long m0 = 0, R, OM;
  int ON;
  if (MODE == DW) {
    d = blockIdx.z / p.nt;
    m0 = (long long)(blockIdx.z % p.nt) * p.rows;
    R = p.M - m0 < p.rows ? p.M - m0 : p.rows;
    OM = p.K + 1;
    ON = p.N;
  } else if (MODE == FWD) {
    d = blockIdx.z;
    R = p.K;
    OM = p.M;
    ON = p.N;
  } else {
    d = blockIdx.z;
    R = p.N;
    OM = p.M;
    ON = p.K;
  }
  const size_t MK = (size_t)p.M * p.K, MN = (size_t)p.M * p.N;
  const float* cols = p.cols + (size_t)d * MK;
  const float* W = p.wmat + (size_t)d * p.K * p.N;
  const float* y = MODE == FWD ? nullptr : p.y + (size_t)d * MN;
  const float* dy = MODE == FWD ? nullptr : p.dy + (size_t)d * MN;

  float acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;

  for (long long r0 = 0; r0 < R; r0 += BK) {
#pragma unroll
    for (int q = 0; q < (BM * BK) / NT; ++q) {
      const int e = tid + q * NT;
      int ii, rr;
      if (MODE == DW) { ii = e % BM; rr = e / BM; }   // cols^T: i contiguous
      else            { rr = e % BK; ii = e / BK; }   // r contiguous
      const long long i = i0 + ii, r = r0 + rr;
      float v = 0.f;
      if (i < OM && r < R) {
        if (MODE == FWD) {
          v = cols[i * p.K + r];
        } else if (MODE == DCOLS) {
          const size_t o = (size_t)i * p.N + r;
          v = y[o] > 0.f ? dy[o] : 0.f;
        } else {
          v = i < p.K ? cols[(m0 + r) * p.K + i] : 1.f;
        }
      }
      As[rr][ii] = v;
    }
#pragma unroll
    for (int q = 0; q < (BN * BK) / NT; ++q) {
      const int e = tid + q * NT;
      int jj, rr;
      if (MODE == DCOLS) { rr = e % BK; jj = e / BK; }  // W^T: r contiguous
      else               { jj = e % BN; rr = e / BN; }  // j contiguous
      const long long r = r0 + rr;
      const int j = j0 + jj;
      float v = 0.f;
      if (j < ON && r < R) {
        if (MODE == FWD) {
          v = W[r * p.N + j];
        } else if (MODE == DCOLS) {
          v = W[(size_t)j * p.N + r];
        } else {
          const size_t o = (size_t)(m0 + r) * p.N + j;
          v = y[o] > 0.f ? dy[o] : 0.f;
        }
      }
      Bs[rr][jj] = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] = As[k][ty + 16 * u];
#pragma unroll
      for (int v = 0; v < 4; ++v) b[v] = Bs[k][tx + 16 * v];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(a[u], b[v], acc[u][v]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const long long i = i0 + ty + 16 * u;
    if (i >= OM) continue;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int j = j0 + tx + 16 * v;
      if (j >= ON) continue;
      if (MODE == FWD) {
        const float z = acc[u][v] + p.bias[(size_t)d * p.N + j];
        p.out[(size_t)d * MN + (size_t)i * p.N + j] = fmaxf(z, 0.f);
      } else if (MODE == DCOLS) {
        p.out[(size_t)d * MK + (size_t)i * p.K + j] = acc[u][v];
      } else {
        p.out[((size_t)blockIdx.z * (p.K + 1) + i) * p.N + j] = acc[u][v];
      }
    }
  }
}

}  // namespace

// y = relu(cols @ wmat + bias) for each of D devices.
extern "C" int conv3x3_fwd_launch(const float* cols, const float* wmat,
                                  const float* bias, float* y, int D,
                                  long long M, int K, int N, void* stream) {
  Params p{cols, wmat, bias, nullptr, nullptr, y, M, K, N, 0, 1};
  dim3 grid((unsigned)((M + BM - 1) / BM), (N + BN - 1) / BN, D);
  gemm_kernel<FWD><<<grid, NT, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// dcols = (dy * (y > 0)) @ wmat^T (skipped when dcols is null) and the
// [D, nt, K + 1, N] partials of [cols^T; 1] @ (dy * (y > 0)), nt =
// ceil(M / rows).
extern "C" int conv3x3_bwd_launch(const float* cols, const float* wmat,
                                  const float* y, const float* dy,
                                  float* dcols, float* dw_part, int D,
                                  long long M, int K, int N, int rows,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nt = (int)((M + rows - 1) / rows);
  if (dcols != nullptr) {
    Params p{cols, wmat, nullptr, y, dy, dcols, M, K, N, 0, 1};
    dim3 grid((unsigned)((M + BM - 1) / BM), (K + BN - 1) / BN, D);
    gemm_kernel<DCOLS><<<grid, NT, 0, s>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  Params p{cols, wmat, nullptr, y, dy, dw_part, M, K, N, rows, nt};
  dim3 grid((K + 1 + BM - 1) / BM, (N + BN - 1) / BN, D * nt);
  gemm_kernel<DW><<<grid, NT, 0, s>>>(p);
  return (int)cudaGetLastError();
}
