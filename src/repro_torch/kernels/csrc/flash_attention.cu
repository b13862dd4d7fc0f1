// Flash attention over GQA heads, for sm_90a: softmax(q k^T / sqrt(Dh)) v
// with causal and sliding-window masks, the [Sq, Skv] logits never stored.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py:
// flash_attention_1h (one head; BQ = BK = 256 blocks, the grid (nq, nk)
// with kv innermost, the running max, sum and accumulator carried in VMEM
// from one grid step to the next) and the vmap over batch, kv heads and
// the query group in src/repro/kernels/ops.py:flash_attention.
//
// On Hopper blocks run in no order, so the carry becomes a loop inside
// the block.  One block of 256 threads per (tile of 64 query rows, query
// head, batch entry); query head h reads kv head h / G.  q, k and v are
// read where they lie, [B, S, H, Dh] with the strides the wrapper passes
// (Dh contiguous); the output is [B, Sq, H, Dh], contiguous, in the
// input type.  The block stages its q tile and then each 64-row kv tile
// in shared memory, widened to float32; the running max, the running
// sum and the [64, Dh] accumulator stay in float32 registers (each thread
// owns 4 query rows; the 16 threads of a half-warp share them and reduce
// a row's max and sum with shuffles).  kv tiles wholly above the causal
// diagonal or wholly left of the window are skipped, not masked: at the
// serving shape of h2o-danube-1.8b (q [2, 8192, 32, 80], k/v [2, 8192,
// 8, 80], window 4096) that leaves 25.2 M of the 67.1 M (q, k) pairs per
// head.  Partial tiles mask as the Pallas kernel does (kpos < Skv,
// kpos <= qpos, kpos > qpos - window); masked logits never enter exp, and
// a row that sees no key writes 0.  The scale is 1/sqrt(Dh).
//
// What bounds it on the H100: FP32 FMA, no tensor cores (the port runs
// without TF32).  At the serving shape one launch does 5.15e11 FLOPs,
// 7.7 ms at 67 TFLOP/s; it moves 210 MB, 0.063 ms at 3.35 TB/s.  This
// first design is also bound by shared-memory reads (8 loads per 16 FMAs
// in q k^T).  A later redesign: products of bf16 values are exact in
// float32, so q k^T can move to bf16 wgmma (989 TFLOP/s) without changing
// a bit of its sums' inputs; p v cannot, because p is not a bf16 value.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // kv rows per tile
constexpr int THREADS = 256;     // 16 x 16: ty picks rows, tx kv columns
constexpr int RPT = BQ / 16;     // query rows per thread
constexpr int CPT = BK / 16;     // kv columns per thread
constexpr int LP = BK + 1;       // row stride of the probabilities

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int H, G, Sq, Skv;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
  int causal, window, q_offset;  // window < 0: none
  float scale;
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int DH>
constexpr size_t smem_bytes() {
  // q and k tiles with an odd row stride (column reads hit 16 banks), the
  // v tile, the probabilities
  return sizeof(float) * (2 * BQ * (DH + 1) + BK * DH + BQ * LP);
}

template <int DH, typename T>
__global__ void __launch_bounds__(THREADS)
    flash_attention_kernel(const Params p) {
  constexpr int LD = DH + 1;
  constexpr int DPT = DH / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;              // [BQ][LD]
  float* sK = sQ + BQ * LD;      // [BK][LD]
  float* sV = sK + BK * LD;      // [BK][DH]
  float* sP = sV + BK * DH;      // [BQ][LP]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.G;
  const T* Q = static_cast<const T*>(p.q) + b * p.qsb + h * p.qsh;
  const T* K = static_cast<const T*>(p.k) + b * p.ksb + hk * p.ksh;
  const T* V = static_cast<const T*>(p.v) + b * p.vsb + hk * p.vsh;

  for (int e = threadIdx.x; e < BQ * DH; e += THREADS) {
    const int r = e / DH, d = e - r * DH;
    sQ[r * LD + d] = q0 + r < p.Sq ? widen(Q[(q0 + r) * p.qss + d]) : 0.f;
  }

  // the kv rows any query row of this tile can see: [kbeg, kend)
  const int nrows = min(BQ, p.Sq - q0);
  const long long qlo = (long long)p.q_offset + q0, qhi = qlo + nrows - 1;
  long long kbeg = 0, kend = p.Skv;
  if (p.causal && qhi + 1 < kend) kend = qhi + 1;
  if (p.window >= 0 && qlo - p.window + 1 > kbeg) kbeg = qlo - p.window + 1;

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  for (long long k0 = kbeg / BK * BK; k0 < kend; k0 += BK) {
    __syncthreads();             // the last tile's readers are done
    for (int e = threadIdx.x; e < BK * DH; e += THREADS) {
      const int r = e / DH, d = e - r * DH;
      const bool in = k0 + r < p.Skv;
      sK[r * LD + d] = in ? widen(K[(k0 + r) * p.kss + d]) : 0.f;
      sV[r * DH + d] = in ? widen(V[(k0 + r) * p.vss + d]) : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 16
    for (int d = 0; d < DH; ++d) {
      float a[RPT], c[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) a[i] = sQ[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) c[j] = sK[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const long long qpos = qlo + ty + 16 * i;
      bool ok[CPT];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const long long kpos = k0 + tx + 16 * j;
        ok[j] = kpos < p.Skv && (!p.causal || kpos <= qpos) &&
                (p.window < 0 || kpos > qpos - p.window);
        s[i][j] *= p.scale;
        if (ok[j]) mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mnew = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float pj = ok[j] ? expf(s[i][j] - mnew) : 0.f;
        sP[(ty + 16 * i) * LP + tx + 16 * j] = pj;
        rs += pj;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      // nothing was summed while the max was -inf: the factor is moot
      const float alpha = m[i] == -INFINITY ? 0.f : expf(m[i] - mnew);
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
      m[i] = mnew;
    }
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < BK; ++c) {
      float pv[RPT], vv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = sP[(ty + 16 * i) * LP + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) vv[j] = sV[c * DH + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  T* O = static_cast<T*>(p.o);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.Sq) continue;
    const float den = l[i] == 0.f ? 1.f : l[i];  // a row with no key: 0
    T* orow = O + (((size_t)b * p.Sq + row) * p.H + h) * DH;
#pragma unroll
    for (int j = 0; j < DPT; ++j) put(orow + tx + 16 * j, acc[i][j] / den);
  }
}

template <int DH, typename T>
int launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes<DH>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_kernel<DH, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, B);
  flash_attention_kernel<DH, T><<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_typed(const Params& p, int B, int dtype, cudaStream_t stream) {
  if (dtype == 0) return launch<DH, float>(p, B, stream);
  if (dtype == 1) return launch<DH, __nv_bfloat16>(p, B, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v and o alike); window < 0: none.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int Hkv, int Sq, int Skv, int D, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, int causal, int window,
    int q_offset, int dtype, void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return 0;
  if (Hkv < 1 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  Params p{q,   k,   v,   o,   H,   H / Hkv, Sq,     Skv,      qsb,
           qss, qsh, ksb, kss, ksh, vsb,     vss,    vsh,      causal,
           window, q_offset, (float)(1.0 / sqrt((double)D))};
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 32: return launch_typed<32>(p, B, dtype, st);
    case 64: return launch_typed<64>(p, B, dtype, st);
    case 80: return launch_typed<80>(p, B, dtype, st);
    case 128: return launch_typed<128>(p, B, dtype, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
