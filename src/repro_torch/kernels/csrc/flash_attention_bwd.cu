// The backward of flash attention over GQA heads, for sm_90a: the gradients
// dq, dk, dv of o = softmax(q k^T / sqrt(Dh)) v against do, with causal and
// sliding-window masks, the [Sq, Skv] probabilities never stored.
//
// The Pallas kernel src/repro/kernels/flash_attention.py:flash_attention_1h
// has no backward (no custom_vjp), so the JAX package trains through its
// XLA einsum path (repro/models/attention.py:_sdpa), whose gradient this
// computes.  The forward kernel (flash_attention.cu) hands over each row's
// log-sum-exp lse, so the probabilities are recomputed exactly as
// P = exp(t - lse), t = q k^T / sqrt(Dh), without a running max:
//
//   delta = rowsum(do * o)          (kernel a: one warp a row, float64
//                                    sums: a row of one key, p = 1, then
//                                    gets dS = 0 within do v^T's rounding)
//   dv    = sum_g P^T do            (kernel b: one block a kv tile)
//   dS    = P * (do v^T - delta)
//   dk    = sum_g dS^T q / sqrt(Dh)
//   dq    = dS k / sqrt(Dh)         (kernel c: one block a q tile)
//
// Work: 10 Dh FLOPs a visible (q, k) pair in the formulas (q k^T, do v^T,
// P^T do, dS^T q, dS k; 1.29e12 at the serving shape of h2o-danube-1.8b,
// q [2, 8192, 32, 80], window 4096), 19.2 ms at the card's FP32 peak and
// 1.30 ms at its bf16 tensor-core peak; the bytes (q, k, v, o, do, dq, dk,
// dv) are 0.1 ms: compute bound.  This first design is FP32 FMA for both
// input types (bfloat16 is widened into shared memory, every sum float32)
// and runs q k^T and do v^T in both kernels b and c (14 Dh FLOPs a pair):
// simple and right first, tensor cores (wgmma, TMA) are a later design.
//
// Kernel b owns a 64-row kv tile of one kv head of one batch entry: it
// walks the G query heads of its group and, of each, only the 64-row q
// tiles whose rows can see a key of the tile (query positions in
// [k0, k1 + window) under the causal and window masks), and accumulates dk
// and dv in registers, each written once: the sum over the group stays in
// the block, with no atomics, so the gradients are bitwise on repeat.
// Kernel c owns a 64-row q tile of one query head and walks the kv tiles
// its rows can see, as the forward does.  Both tile 64 x 64 products over
// 256 threads, 4 x 4 a thread (the forward's float32 layout: q rows by ty,
// kv rows by tx, odd row strides so column reads hit distinct banks).
// Rows past Sq and keys past Skv read as zeros and are masked; a row that
// sees no key (lse = +inf) has P = 0: its dq is 0 and it adds nothing to
// dk, dv.  q, k and v are read through their strides (Dh contiguous); o,
// do and the outputs are contiguous [B, S, H, Dh].
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // query rows per tile
constexpr int BK = 64;         // kv rows per tile
constexpr int THREADS = 256;   // 16 x 16: ty picks q rows, tx kv rows
constexpr int RPT = BQ / 16;   // q rows per thread
constexpr int CPT = BK / 16;   // kv rows per thread
constexpr int LP = BK + 1;     // row stride of P and dS

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;    // [B, Sq, H, Dh] contiguous
  const float* lse;    // [B, H, Sq]
  const float* delta;  // [B, H, Sq]
  void* dq;            // [B, Sq, H, Dh]
  void* dk;            // [B, Skv, Hkv, Dh]
  void* dv;
  int H, Hkv, G, Sq, Skv;
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

// ------------------------------------------------ (a) delta = rowsum(do o)
template <typename T>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_delta_kernel(const T* o, const T* dout, float* delta, int H,
                           int Sq, int D, long long rows) {
  const long long r =
      (long long)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;  // a whole warp: r is the warp's
  const T* a = o + r * D;
  const T* c = dout + r * D;
  double acc = 0.0;  // free in a pass bound by its bytes
  for (int d = lane; d < D; d += 32)
    acc = fma((double)widen(a[d]), (double)widen(c[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {  // r = (b Sq + i) H + h -> delta[b, h, i]
    const long long h = r % H, bi = r / H, i = bi % Sq, b = bi / Sq;
    delta[(b * H + h) * Sq + i] = (float)acc;
  }
}

// rows r0.. of a [*, DH] operand with row stride `rs` into a [64][DH + 1]
// float32 tile; rows at or past `n` read as zeros
template <int DH, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long rs, long long r0,
                                          long long n) {
  constexpr int LD = DH + 1;
  for (int e = threadIdx.x; e < 64 * DH; e += THREADS) {
    const int r = e / DH, d = e - r * DH;
    dst[r * LD + d] = r0 + r < n ? widen(src[(r0 + r) * rs + d]) : 0.f;
  }
}

// lse and delta of q rows q0.. of head h; rows past Sq see nothing
__device__ __forceinline__ void load_rows(float* sL, float* sD,
                                          const Params& p, int b, int h,
                                          int q0) {
  if (threadIdx.x < BQ) {
    const int row = q0 + threadIdx.x;
    const size_t at = ((size_t)b * p.H + h) * p.Sq + row;
    sL[threadIdx.x] = row < p.Sq ? p.lse[at] : INFINITY;
    sD[threadIdx.x] = row < p.Sq ? p.delta[at] : 0.f;
  }
}

// P and dS of the 64 x 64 tile (q rows q0 + ty + 16 i, kv rows k0 + tx +
// 16 j): s = q k^T and dp = do v^T as FMA chains over d, then
// P = exp(s scale - lse) where the masks keep the pair, dS = P (dp - delta)
template <int DH>
__device__ __forceinline__ void tile_p_ds(
    const float* sQ, const float* sDO, const float* sK, const float* sV,
    const float* sL, const float* sD, const Params& p, int q0, long long k0,
    float (&pr)[RPT][CPT], float (&ds)[RPT][CPT]) {
  constexpr int LD = DH + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < DH; ++d) {
    float a[RPT], e[RPT], c[CPT], w[CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      a[i] = sQ[(ty + 16 * i) * LD + d];
      e[i] = sDO[(ty + 16 * i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      c[j] = sK[(tx + 16 * j) * LD + d];
      w[j] = sV[(tx + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        s[i][j] = fmaf(a[i], c[j], s[i][j]);
        dp[i][j] = fmaf(e[i], w[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty + 16 * i;
    const long long qpos = (long long)p.q_offset + row;
    const float lse = sL[ty + 16 * i], dl = sD[ty + 16 * i];
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const long long kpos = k0 + tx + 16 * j;
      const bool ok = row < p.Sq && kpos < p.Skv &&
                      (!p.causal || kpos <= qpos) &&
                      (p.window < 0 || kpos > qpos - p.window);
      pr[i][j] = ok ? expf(s[i][j] * p.scale - lse) : 0.f;
      ds[i][j] = pr[i][j] * (dp[i][j] - dl);
    }
  }
}

template <int DH>
constexpr size_t dkdv_smem() {  // k, v, q, do tiles; P, dS; lse, delta
  return sizeof(float) * (4 * 64 * (DH + 1) + 2 * BQ * LP + 2 * BQ);
}
template <int DH>
constexpr size_t dq_smem() {  // q, do, k, v tiles; dS; lse, delta
  return sizeof(float) * (4 * 64 * (DH + 1) + BQ * LP + 2 * BQ);
}

// ------------------------------------------ (b) dk, dv: one block a kv tile
template <int DH, typename T>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkdv_kernel(const Params p) {
  constexpr int LD = DH + 1, DPT = DH / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BK * LD;
  float* sQ = sV + BK * LD;
  float* sDO = sQ + BQ * LD;
  float* sP = sDO + BQ * LD;
  float* sS = sP + BQ * LP;
  float* sL = sS + BQ * LP;
  float* sD = sL + BQ;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  load_tile<DH>(sK, static_cast<const T*>(p.k) + b * p.ksb + hk * p.ksh,
                p.kss, k0, p.Skv);
  load_tile<DH>(sV, static_cast<const T*>(p.v) + b * p.vsb + hk * p.vsh,
                p.vss, k0, p.Skv);

  // the q rows that can see a key of this tile: positions [k0, k1 + window)
  const long long k1 = min(k0 + BK, p.Skv) - 1;
  long long ilo = 0, ihi = p.Sq;
  if (p.causal) ilo = max(0LL, (long long)k0 - p.q_offset);
  if (p.window >= 0) ihi = min(ihi, k1 + p.window - p.q_offset);

  float dk[RPT][DPT], dv[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) dk[i][j] = dv[i][j] = 0.f;

  const size_t ds_row = (size_t)p.H * DH;  // do's row stride
  for (int g = 0; g < p.G; ++g) {
    const int h = hk * p.G + g;
    const T* Q = static_cast<const T*>(p.q) + b * p.qsb + h * p.qsh;
    const T* DO = static_cast<const T*>(p.dout) + (size_t)b * p.Sq * ds_row +
                  (size_t)h * DH;
    for (long long q0 = ilo / BQ * BQ; q0 < ihi; q0 += BQ) {
      __syncthreads();  // the last tile's readers are done
      load_tile<DH>(sQ, Q, p.qss, q0, p.Sq);
      load_tile<DH>(sDO, DO, (long long)ds_row, q0, p.Sq);
      load_rows(sL, sD, p, b, h, (int)q0);
      __syncthreads();
      float pr[RPT][CPT], ds[RPT][CPT];
      tile_p_ds<DH>(sQ, sDO, sK, sV, sL, sD, p, (int)q0, k0, pr, ds);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          sP[(ty + 16 * i) * LP + tx + 16 * j] = pr[i][j];
          sS[(ty + 16 * i) * LP + tx + 16 * j] = ds[i][j];
        }
      __syncthreads();
      // this thread's kv rows ty + 16 i, columns tx + 16 j of dk and dv
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float pv[RPT], sv[RPT], ov[DPT], qv[DPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          pv[i] = sP[r * LP + ty + 16 * i];
          sv[i] = sS[r * LP + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          ov[j] = sDO[r * LD + tx + 16 * j];
          qv[j] = sQ[r * LD + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < DPT; ++j) {
            dv[i][j] = fmaf(pv[i], ov[j], dv[i][j]);
            dk[i][j] = fmaf(sv[i], qv[j], dk[i][j]);
          }
      }
    }
  }

  T* DK = static_cast<T*>(p.dk);
  T* DV = static_cast<T*>(p.dv);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= p.Skv) continue;
    const size_t at = (((size_t)b * p.Skv + row) * p.Hkv + hk) * DH;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      put(DK + at + tx + 16 * j, dk[i][j] * p.scale);
      put(DV + at + tx + 16 * j, dv[i][j]);
    }
  }
}

// --------------------------------------------- (c) dq: one block a q tile
template <int DH, typename T>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const Params p) {
  constexpr int LD = DH + 1, DPT = DH / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + BQ * LD;
  float* sK = sDO + BQ * LD;
  float* sV = sK + BK * LD;
  float* sS = sV + BK * LD;
  float* sL = sS + BQ * LP;
  float* sD = sL + BQ;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.G;
  const size_t ds_row = (size_t)p.H * DH;
  load_tile<DH>(sQ, static_cast<const T*>(p.q) + b * p.qsb + h * p.qsh,
                p.qss, q0, p.Sq);
  load_tile<DH>(sDO, static_cast<const T*>(p.dout) +
                         (size_t)b * p.Sq * ds_row + (size_t)h * DH,
                (long long)ds_row, q0, p.Sq);
  load_rows(sL, sD, p, b, h, q0);
  const T* K = static_cast<const T*>(p.k) + b * p.ksb + hk * p.ksh;
  const T* V = static_cast<const T*>(p.v) + b * p.vsb + hk * p.vsh;

  // the kv rows any q row of this tile can see: [kbeg, kend)
  const int nrows = min(BQ, p.Sq - q0);
  const long long qlo = (long long)p.q_offset + q0, qhi = qlo + nrows - 1;
  long long kbeg = 0, kend = p.Skv;
  if (p.causal && qhi + 1 < kend) kend = qhi + 1;
  if (p.window >= 0 && qlo - p.window + 1 > kbeg) kbeg = qlo - p.window + 1;

  float dq[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) dq[i][j] = 0.f;

  for (long long k0 = kbeg / BK * BK; k0 < kend; k0 += BK) {
    __syncthreads();  // the last tile's readers are done
    load_tile<DH>(sK, K, p.kss, k0, p.Skv);
    load_tile<DH>(sV, V, p.vss, k0, p.Skv);
    __syncthreads();
    float pr[RPT][CPT], ds[RPT][CPT];
    tile_p_ds<DH>(sQ, sDO, sK, sV, sL, sD, p, q0, k0, pr, ds);
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        sS[(ty + 16 * i) * LP + tx + 16 * j] = ds[i][j];
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float sv[RPT], kv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) sv[i] = sS[(ty + 16 * i) * LP + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) kv[j] = sK[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j)
          dq[i][j] = fmaf(sv[i], kv[j], dq[i][j]);
    }
  }

  T* DQ = static_cast<T*>(p.dq);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.Sq) continue;
    const size_t at = (((size_t)b * p.Sq + row) * p.H + h) * DH;
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      put(DQ + at + tx + 16 * j, dq[i][j] * p.scale);
  }
}

template <int DH, typename T>
int launch_dkdv(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = dkdv_smem<DH>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<DH, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.Skv + BK - 1) / BK, p.Hkv, B);
  flash_bwd_dkdv_kernel<DH, T><<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int DH, typename T>
int launch_dq(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = dq_smem<DH>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<DH, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, B);
  flash_bwd_dq_kernel<DH, T><<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// kernel b (dq = false) or c (dq = true) at head dim D and input type dtype
template <int DH, typename T>
int launch(bool dq, const Params& p, int B, cudaStream_t st) {
  return dq ? launch_dq<DH, T>(p, B, st) : launch_dkdv<DH, T>(p, B, st);
}

template <typename T>
int dispatch(bool dq, const Params& p, int B, int D, cudaStream_t st) {
  switch (D) {
    case 32: return launch<32, T>(dq, p, B, st);
    case 64: return launch<64, T>(dq, p, B, st);
    case 80: return launch<80, T>(dq, p, B, st);
    case 128: return launch<128, T>(dq, p, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int run(bool dq, const void* q, const void* k, const void* v,
        const void* dout, const float* lse, const float* delta, void* dqp,
        void* dkp, void* dvp, int B, int H, int Hkv, int Sq, int Skv, int D,
        long long qsb, long long qss, long long qsh, long long ksb,
        long long kss, long long ksh, long long vsb, long long vss,
        long long vsh, int causal, int window, int q_offset, int dtype,
        void* stream) {
  if (Hkv < 1 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  // an empty grid; every block of a non-empty one writes its tile, zeros
  // where it sees nothing (dq of Skv = 0, dk and dv of Sq = 0)
  if (B == 0 || (dq ? Sq : Skv) == 0) return 0;
  const Params p{q,   k,    v,     dout,   lse,    delta,  dqp, dkp,
                 dvp, H,    Hkv,   H / Hkv, Sq,    Skv,    qsb, qss,
                 qsh, ksb,  kss,   ksh,    vsb,    vss,    vsh, causal,
                 window, q_offset, (float)(1.0 / sqrt((double)D))};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return dispatch<float>(dq, p, B, D, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(dq, p, B, D, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Kernel a: delta[b, h, i] = sum_d do[b, i, h, d] o[b, i, h, d], o and do
// contiguous [B, Sq, H, D]; dtype 0 float32, 1 bfloat16.  Returns a
// cudaError_t.
extern "C" int flash_attention_bwd_delta_launch(const void* o,
                                                const void* dout,
                                                float* delta, int B, int H,
                                                int Sq, int D, int dtype,
                                                void* stream) {
  const long long rows = (long long)B * Sq * H;
  if (rows == 0) return 0;
  const long long blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    flash_bwd_delta_kernel<float><<<(unsigned)blocks, THREADS, 0, st>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout), delta,
        H, Sq, D, rows);
  else if (dtype == 1)
    flash_bwd_delta_kernel<__nv_bfloat16><<<(unsigned)blocks, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(o),
        static_cast<const __nv_bfloat16*>(dout), delta, H, Sq, D, rows);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Kernel b: dk, dv (contiguous [B, Skv, Hkv, D]) from q, k, v (strides
// (sb, ss, sh), D contiguous), do (contiguous [B, Sq, H, D]), the
// forward's lse and kernel a's delta ([B, H, Sq] float32).  window < 0:
// none.  Returns a cudaError_t.
extern "C" int flash_attention_bwd_dkdv_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, int B, int H,
    int Hkv, int Sq, int Skv, int D, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, int causal, int window,
    int q_offset, int dtype, void* stream) {
  return run(false, q, k, v, dout, lse, delta, nullptr, dk, dv, B, H, Hkv,
             Sq, Skv, D, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, causal,
             window, q_offset, dtype, stream);
}

// Kernel c: dq (contiguous [B, Sq, H, D]) from the same inputs.
extern "C" int flash_attention_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, int B, int H, int Hkv,
    int Sq, int Skv, int D, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, int causal, int window, int q_offset,
    int dtype, void* stream) {
  return run(true, q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, H,
             Hkv, Sq, Skv, D, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh,
             causal, window, q_offset, dtype, stream);
}
