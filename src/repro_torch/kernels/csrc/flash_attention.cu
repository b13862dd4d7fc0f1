// Flash attention over GQA heads, for sm_90a: softmax(q k^T / sqrt(Dh)) v
// with causal and sliding-window masks, the [Sq, Skv] logits never stored.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py:
// flash_attention_1h (one head; BQ = BK = 256 blocks, the grid (nq, nk)
// with kv innermost, the running max, sum and accumulator carried in VMEM
// from one grid step to the next) and the vmap over batch, kv heads and
// the query group in src/repro/kernels/ops.py:flash_attention.  On Hopper
// blocks run in no order, so the carry becomes a loop inside the block.
// Query head h reads kv head h / G.  q, k and v are read where they lie,
// [B, S, H, Dh] with the strides the wrapper passes (Dh contiguous); the
// output is [B, Sq, H, Dh], contiguous, in the input type.  kv tiles
// wholly above the causal diagonal or wholly left of the window are
// skipped, not masked: at the serving shape of h2o-danube-1.8b (q [2, 8192,
// 32, 80], k/v [2, 8192, 8, 80], window 4096) that leaves 25.2 M of the
// 67.1 M (q, k) pairs per head.  Partial tiles mask as the Pallas kernel
// does (kpos < Skv, kpos <= qpos, kpos > qpos - window); masked logits
// never enter exp, and a row that sees no key writes 0.  The scale
// 1/sqrt(Dh) multiplies the float32 sum.  The input type picks the design.
// The Hopper parts the bf16 design shares with the backward
// (flash_attention_bwd.cu) are in flash_hopper.cuh.
//
// bfloat16 (the serving path): 4 Dh FLOPs per visible pair, 5.15e11 at the
// serving shape, 0.52 ms at the card's 989 TFLOP/s of bf16 tensor-core
// rate; it moves 210 MB, 0.063 ms at 3.35 TB/s: tensor-core bound (the
// three-term p v below doubles the tensor work: 1.04 ms).  One
// block of three warpgroups per (tile of 128 query rows, query head,
// batch entry), the longest tiles first.  Warpgroups 0 and 1 consume, 64
// query rows each (the M of wgmma); one thread of warpgroup 2 produces:
// TMA loads the block's q tile once and each 128-row kv tile into a ring
// of two stages, with a full and an empty mbarrier per stage (setmaxnreg
// moves the producer's registers to the consumers).  Tiles are stored in
// 16-column chunks of 32-byte rows with TMA's 32-byte swizzle: one chunk
// is one wgmma k-step, and 16 divides every head dim built (32, 64, 80,
// 96, 128, 192, 256; 80 is 160 bytes a row, no whole number of 128-byte
// atoms).  Above Dh 128 the kv tile is 64 rows (kv_rows): at 128 the q
// tile and the two-stage ring would need 240 KB of shared memory at Dh
// 192, over the 227 KB a block may have; at 64 they take 144 KB, and a
// consumer thread holds 96 o and 32 s accumulators (multi-head latent
// attention runs at Dh 96, 64 + 32, and 192, 128 + 64).  At Dh 256
// (recurrentgemma's local attention) the kv tile is 32 rows: a consumer
// thread holds 128 o accumulators, and a 64-row tile's 32 s and 48 p
// registers beside them would spill under setmaxnreg's 240; at 32 rows
// it holds 16 s and 24 p, and the q tile and ring take 128 KB.  p v is
// then one m64n256k16 per term and k-step.
//   s = q k^T runs on bf16 wgmma (m64nBKk16, both operands from shared
// memory, K-major) into float32: products of bf16 values are exact in
// float32, so only the order of the float32 sums differs from the plain
// version.  The online softmax works on the accumulator fragment: each
// thread holds 2 rows x BK / 4 columns, reduces row max and sum across the
// quad that shares a row, and takes p = exp(t - m) (on ex2.approx) with t the
// scaled float32 sum and m the running max of the t's, so every p and
// every rescale refer to one exact max (see softmax_tile).  Only tiles that
// cut a row's visible range are masked, from a per-row column interval;
// masked logits become -inf, whose exp is 0.  Large logits near the max
// (|t| >= 8, within 20 of it) are summed again as one float32 FMA chain
// over d, the plain version's order: there the order of the float32 sum,
// not the kernel's accuracy, decides the output (see softmax_tile).
//   o += p v also runs on bf16 wgmma (m64nDhk16, v N-major from shared
// memory), with p in registers: the accumulator fragment of s is the
// A-operand fragment of the next product, so p never goes through shared
// memory.  p in [0, 1] is no bf16 value, so it is split into three bf16
// terms p = p1 + p2 + p3, each the round-to-nearest of what the terms
// before it left (the differences are exact in float32); the three
// products against one v tile leave at most 2^-24 p per product, float32's
// own rounding (two terms would leave 2^-16 p).  l sums the float32 p; the
// rescale exp(m_old - m_new) is applied to the o fragment in registers.
// Each warpgroup runs a tile's two products in turn; the other
// consumer's softmax fills the tensor cores' gaps (overlapping a tile's
// softmax with the previous tile's p v inside one warpgroup, on a third
// stage, measured slower).
//
// float32: the first design, FP32 FMA on operands widened in shared
// memory (209 KB of it at Dh 256) (no tensor cores; the port runs without TF32), bound by shared-
// memory loads (8 per 16 FMAs in q k^T).  One block of 256 threads per
// (tile of 64 query rows, query head, batch entry); each thread owns 4
// query rows, the 16 threads of a half-warp reduce a row's max and sum
// with shuffles.
#include <math.h>

#include "flash_hopper.cuh"

namespace {

// ------------------------------------------------------ float32: FP32 FMA
namespace f32 {

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
  float* lse;  // [B, H, Sq], or null: not written
  int H, G, Sq, Skv;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
  int causal, window, q_offset;  // window < 0: none
  float scale;
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }

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
    if (p.lse != nullptr && tx == 0)  // the half-warp agrees on m and l
      p.lse[((size_t)b * p.H + h) * p.Sq + row] =
          l[i] == 0.f ? INFINITY : m[i] + logf(l[i]);
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

}  // namespace f32

// -------------------------------------------------- bfloat16: wgmma + TMA
namespace bf16 {

using namespace hopper;

constexpr int BQ = 128;       // query rows per block, 64 per consumer
constexpr int STAGES = 2;     // the kv ring
constexpr int THREADS = 384;  // warpgroups 0, 1 consume, 2 produces
constexpr int CONSUMER_WARPS = 8;

// kv rows per tile: 128; 64 above Dh 128, where a 128-row ring does not
// fit in shared memory beside the q tile; 32 above Dh 192, where a
// consumer thread's 128 o accumulators leave no room for a 64-row tile's
// s and p registers under setmaxnreg's 240
constexpr int kv_rows(int dh) { return dh > 192 ? 32 : dh > 128 ? 64 : 128; }

template <int DH>
struct Layout {               // byte offsets in shared memory
  static constexpr int BK = kv_rows(DH);      // kv rows per tile
  static constexpr int NCH = DH / KSTEP;      // chunks per tile row
  static constexpr int QCHUNK = BQ * ROW;     // [BQ rows][16 columns]
  static constexpr int KCHUNK = BK * ROW;     // [BK rows][16 columns]
  static constexpr int Q = 0;
  static constexpr int K = Q + NCH * QCHUNK;             // [STAGES][NCH]
  static constexpr int V = K + STAGES * NCH * KCHUNK;    // [STAGES][NCH]
  static constexpr int BAR = V + STAGES * NCH * KCHUNK;  // full, empty, q
  static constexpr int BYTES = BAR + 8 * (2 * STAGES + 1);
  static constexpr int Q_TX = BQ * DH * 2;               // bytes per load
  static constexpr int KV_TX = 2 * BK * DH * 2;
  static_assert(BYTES + 1024 <= 232448, "over a block's shared memory");
};

struct Params {
  void* o;
  float* lse;  // [B, H, Sq], or null: not written
  int H, G, Sq, Skv, causal, window, q_offset;  // window < 0: none
  float scale;
};

__device__ __forceinline__ float2 ld_bf16x2(uint32_t addr) {  // shared
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One consumer thread's rows: r0 and r0 + 8 of its warpgroup's 64.
struct Rows {
  float m[2] = {-INFINITY, -INFINITY};  // running max of the logits
  float l[2] = {0.f, 0.f};              // running sum of p
  float a[2];                           // this tile's rescale of o
  int lo[2], hi[2];  // the tile's visible columns per row: [lo, hi)
};

// The online softmax on the s fragment of one kv tile: element i sits at
// row r0 (+8 when i & 2), column 8 (i / 4) + cq + (i & 1).  Each logit is
// the float32 sum times the scale, rounded once, and the running max is one
// of them, so t - m and m_old - m_new are exact differences: every p and
// every rescale refers to the same max, as in the plain version.  (Folding
// the scale into the exponent, 2^(s c - round(m c)), breaks that: at logits
// in the hundreds the rounding of m c weighs one tile's p against
// another's by up to 2^-15, which a row that mixes two keys of cancelling
// v turns into errors far above float32's.)  p = 2^((t - m) log2 e) on
// ex2.approx.  Masked logits become -inf, whose 2^x is +0; a row whose max
// is still -inf takes an offset of 0, so nothing of it enters exp as NaN,
// and its rescale is 0 (nothing was summed).
//   Where logits are large (|t| >= REFINE_ABOVE), a few ulps of t move p
// by more than float32's own rounding of the output, and the order of the
// float32 sum decides them: at the serving model's logits in the hundreds,
// in a row that mixes two keys of comparable p and cancelling v, the
// tensor cores' order and the plain version's sequential FMA chain give
// outputs that differ by many times float32's rounding of them, each as
// far from the float64 value.  So the logits within REFINE_WITHIN of the
// running max are recomputed by `chain` as one float32 FMA chain over d,
// the order the plain version's GEMM and the float32 path sum in.  Random
// inputs of unit scale never take this path.
constexpr float REFINE_ABOVE = 8.f;   // |logit|: ulp(8) = 2^-20
constexpr float REFINE_WITHIN = 20.f;  // below the max: p < 2e-9
template <bool MASK, int NS, typename Chain>
__device__ __forceinline__ void softmax_tile(float (&s)[NS], Rows& r, int cq,
                                             float scale, Chain chain) {
  float mx[2] = {r.m[0], r.m[1]};
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int h = (i >> 1) & 1, col = 8 * (i / 4) + cq + (i & 1);
    s[i] *= scale;
    if (MASK && (col < r.lo[h] || col >= r.hi[h])) s[i] = -INFINITY;
    mx[h] = fmaxf(mx[h], s[i]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) mx[h] = quad_max(mx[h]);
  auto big = [](float x) { return x > -INFINITY && fabsf(x) >= REFINE_ABOVE; };
  if (__any_sync(0xffffffffu, big(mx[0]) || big(mx[1]))) {
    uint64_t need = 0;  // bit i: element i is recomputed
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int h = (i >> 1) & 1;
      if (s[i] > mx[h] - REFINE_WITHIN && fabsf(s[i]) >= REFINE_ABOVE)
        need |= 1ull << i;
    }
    while (need) {  // each lane its own elements, the lanes side by side
      const int j = __ffsll(need) - 1;
      need &= need - 1;
      const float t = chain(j) * scale;
#pragma unroll
      for (int i = 0; i < NS; ++i)
        if (i == j) s[i] = t;  // a register array takes no runtime index
    }
    mx[0] = r.m[0];
    mx[1] = r.m[1];
#pragma unroll
    for (int i = 0; i < NS; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
    for (int h = 0; h < 2; ++h) mx[h] = quad_max(mx[h]);
  }
  float off[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    off[h] = mx[h] == -INFINITY ? 0.f : mx[h];
    r.a[h] = r.m[h] == -INFINITY ? 0.f : ex2((r.m[h] - mx[h]) * LOG2E);
    r.m[h] = mx[h];
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int h = (i >> 1) & 1;
    s[i] = ex2((s[i] - off[h]) * LOG2E);
    rs[h] += s[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) r.l[h] = r.l[h] * r.a[h] + quad_sum(rs[h]);
}

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
    flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv,
                                 const Params p) {
  using L = Layout<DH>;
  constexpr int NCH = L::NCH, NO = DH / 2, BK = L::BK, NS = BK / 2;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the swizzle pattern repeats every 256 bytes: align every chunk to 1024
  const uint32_t base =
      ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = base + L::BAR, empty = full + 8 * STAGES,
                 qbar = empty + 8 * STAGES;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // the longest first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / p.G;

  // the kv tiles any query row of this block can see
  const int nrows = min(BQ, p.Sq - q0);
  const long long qlo = (long long)p.q_offset + q0, qhi = qlo + nrows - 1;
  long long kbeg = 0, kend = p.Skv;
  if (p.causal && qhi + 1 < kend) kend = qhi + 1;
  if (p.window >= 0 && qlo - p.window + 1 > kbeg) kbeg = qlo - p.window + 1;
  const int t0 = (int)(kbeg / BK);
  const int ntiles = kend > kbeg ? (int)((kend + BK - 1) / BK) - t0 : 0;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMER_WARPS);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 2 * 128) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 2 * 128 && ntiles > 0) {
      mbar_expect_tx(qbar, L::Q_TX);
      for (int c = 0; c < NCH; ++c)
        tma_load(base + L::Q + c * L::QCHUNK, &tq, qbar, c * KSTEP, q0, h, b);
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % STAGES;
        const uint32_t bar = full + 8 * s;
        mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(bar, L::KV_TX);
        const int k0 = (t0 + it) * BK;
        for (int c = 0; c < NCH; ++c) {
          tma_load(base + L::K + (s * NCH + c) * L::KCHUNK, &tk, bar,
                   c * KSTEP, k0, hk, b);
          tma_load(base + L::V + (s * NCH + c) * L::KCHUNK, &tv, bar,
                   c * KSTEP, k0, hk, b);
        }
      }
    }
    return;
  }

  // ------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3,
            lane = threadIdx.x & 31;
  const int cq = (lane & 3) * 2;                   // the quad's columns
  const int rw = q0 + wg * 64;                     // this warpgroup's rows
  const int r0 = rw + warp * 16 + (lane >> 2);     // rows r0 and r0 + 8
  const int nrw = max(0, min(64, p.Sq - rw));
  const long long qlw = (long long)p.q_offset + rw, qhw = qlw + nrw - 1;

  float o[NO], s[NS];
  uint32_t pa[3 * BK / KSTEP * 4];  // p's three bf16 terms, A fragments
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  Rows rows;

  // whether this warpgroup's rows see any of the tile
  auto seen = [&](int it) {
    const long long k0 = (long long)(t0 + it) * BK;
    return nrw > 0 && k0 < p.Skv && (!p.causal || k0 <= qhw) &&
           (p.window < 0 || k0 + BK - 1 > qlw - p.window);
  };
  // s = q k^T: NCH k-steps, both operands K-major in shared memory
  auto issue_s = [&](int it) {
    const uint32_t qa = base + L::Q + wg * 64 * ROW,
                   ka = base + L::K + (it % STAGES) * NCH * L::KCHUNK;
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      wgmma_ss<BK>(s, desc32(qa + c * L::QCHUNK, 16, 8 * ROW),
                   desc32(ka + c * L::KCHUNK, 16, 8 * ROW), c > 0);
    wgmma_commit();
  };
  // o += p v, three terms per k-step; v N-major: 16 kv rows of 32 bytes
  // per k-step, the next 16 columns one chunk on (LBO), the next 8 rows
  // 256 bytes on (SBO)
  auto issue_pv = [&](int it) {
    const uint32_t va = base + L::V + (it % STAGES) * NCH * L::KCHUNK;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / KSTEP; ++kk) {
      const uint64_t dv = desc32(va + kk * KSTEP * ROW, L::KCHUNK, 8 * ROW);
#pragma unroll
      for (int t = 0; t < 3; ++t)
        wgmma_pv<DH>(o, &pa[(kk * 3 + t) * 4], dv);
    }
    wgmma_commit();
  };
  // the sum of element i of tile it's s as one float32 FMA chain over d,
  // from the swizzled chunks in shared memory (a row's 16-byte halves swap
  // when bit 2 of the row is set)
  auto chain_of = [&](int it) {
    return [&, it](int i) {
      const int qr = wg * 64 + warp * 16 + (lane >> 2) + 8 * ((i >> 1) & 1),
                kr = 8 * (i / 4) + cq + (i & 1);
      const uint32_t qrow = base + L::Q + qr * ROW,
                     krow = base + L::K + (it % STAGES) * NCH * L::KCHUNK +
                            kr * ROW,
                     swq = ((qr >> 2) & 1) << 4, swk = ((kr >> 2) & 1) << 4;
      float acc = 0.f;
#pragma unroll 1
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int j = 0; j < KSTEP / 2; ++j) {
          const float2 a = ld_bf16x2(qrow + c * L::QCHUNK + ((4 * j) ^ swq));
          const float2 b = ld_bf16x2(krow + c * L::KCHUNK + ((4 * j) ^ swk));
          acc = fmaf(a.x, b.x, acc);
          acc = fmaf(a.y, b.y, acc);
        }
      return acc;
    };
  };
  // the softmax of tile it; masks only where some row sees part of it
  auto softmax = [&](int it) {
    const long long k0 = (long long)(t0 + it) * BK;
    if (k0 + BK <= p.Skv && (!p.causal || k0 + BK - 1 <= qlw) &&
        (p.window < 0 || k0 > qhw - p.window)) {
      softmax_tile<false>(s, rows, cq, p.scale, chain_of(it));
      return;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const long long qpos = (long long)p.q_offset + r0 + 8 * j;
      long long hi = p.Skv, lo = 0;
      if (p.causal && qpos + 1 < hi) hi = qpos + 1;
      if (p.window >= 0) lo = qpos - p.window + 1;
      rows.lo[j] = (int)min(max(lo - k0, 0LL), (long long)BK);
      rows.hi[j] = (int)min(max(hi - k0, 0LL), (long long)BK);
    }
    softmax_tile<true>(s, rows, cq, p.scale, chain_of(it));
  };
  // o *= a per row, then p into its three bf16 terms: k-step kk takes
  // columns 16 kk.. of p, the fragment's registers 8 kk.., which are in
  // the A operand's order
  auto rescale_and_split = [&]() {
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= rows.a[(i >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < BK / KSTEP; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split_terms<3>(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1],
                       &pa[kk * 3 * 4 + r], 4);
  };

  // each tile's two products run in turn; the other consumer warpgroup's
  // softmax fills the tensor cores' gaps
  if (ntiles > 0) mbar_wait(qbar, 0);
  for (int it = 0; it < ntiles; ++it) {
    const int st = it % STAGES;
    mbar_wait(full + 8 * st, (it / STAGES) & 1);
    if (seen(it)) {
      issue_s(it);
      wgmma_wait_all();
      fence_regs(s);
      softmax(it);
      rescale_and_split();
      issue_pv(it);
      wgmma_wait_all();
      fence_regs(o);
      fence_regs(pa);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);
  }

  // rows past Sq are not stored; a row that saw no key writes 0
  const float d0 = rows.l[0] == 0.f ? 1.f : rows.l[0],
              d1 = rows.l[1] == 0.f ? 1.f : rows.l[1];
  __nv_bfloat16* O = static_cast<__nv_bfloat16*>(p.o);
  __nv_bfloat16* o0 = O + (((size_t)b * p.Sq + r0) * p.H + h) * DH + cq;
  __nv_bfloat16* o1 = o0 + (size_t)8 * p.H * DH;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    if (r0 < p.Sq)
      *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * j) =
          __floats2bfloat162_rn(o[4 * j] / d0, o[4 * j + 1] / d0);
    if (r0 + 8 < p.Sq)
      *reinterpret_cast<__nv_bfloat162*>(o1 + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2] / d1, o[4 * j + 3] / d1);
  }
  if (p.lse != nullptr && (lane & 3) == 0) {  // the quad agrees on m and l
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (r0 + 8 * j < p.Sq)
        p.lse[((size_t)b * p.H + h) * p.Sq + r0 + 8 * j] =
            rows.l[j] == 0.f ? INFINITY : rows.m[j] + logf(rows.l[j]);
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const Params& p,
           int B, int Hkv, long long qsb, long long qss, long long qsh,
           long long ksb, long long kss, long long ksh, long long vsb,
           long long vss, long long vsh, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  const int skv = p.Skv > 0 ? p.Skv : 1;  // no key: no tile is loaded
  int rc = encode(&tq, q, B, p.Sq, p.H, DH, qsb, qss, qsh, BQ);
  constexpr int BK = Layout<DH>::BK;
  if (rc == 0) rc = encode(&tk, k, B, skv, Hkv, DH, ksb, kss, ksh, BK);
  if (rc == 0) rc = encode(&tv, v, B, skv, Hkv, DH, vsb, vss, vsh, BK);
  if (rc != 0) return rc;
  const int smem = Layout<DH>::BYTES + 1024;  // + the alignment to 1024
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel<DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, B);
  flash_attention_wgmma_kernel<DH><<<grid, THREADS, smem, stream>>>(
      tq, tk, tv, p);
  return (int)cudaGetLastError();
}

}  // namespace bf16

}  // namespace

// dtype: 0 float32 (the FMA design), 1 bfloat16 (wgmma + TMA; every
// pointer 16-byte aligned and every stride of a dim longer than 1 a
// multiple of 8 elements, which the wrapper checks); window < 0: none.
// scale multiplies the logits: 1/sqrt(Dh) of the caller's head dim, which
// is below D where the wrapper zero-padded the operands to a built D.
// lse: each row's log-sum-exp of its scaled logits, [B, H, Sq] float32
// (+inf for a row that sees no key), for the backward; null writes none.
// Returns a cudaError_t, or 1000 + the CUresult of a failed tensor-map
// encoding.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int B, int H,
    int Hkv, int Sq, int Skv, int D, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, int causal, int window,
    int q_offset, float scale, int dtype, void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return 0;
  if (Hkv < 1 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    f32::Params p{q,   k,   v,   o,   lse, H,   H / Hkv, Sq,     Skv,
                  qsb, qss, qsh, ksb, kss, ksh, vsb,     vss,    vsh,
                  causal, window, q_offset, scale};
    switch (D) {
      case 32: return f32::launch<32, float>(p, B, st);
      case 64: return f32::launch<64, float>(p, B, st);
      case 80: return f32::launch<80, float>(p, B, st);
      case 96: return f32::launch<96, float>(p, B, st);
      case 128: return f32::launch<128, float>(p, B, st);
      case 192: return f32::launch<192, float>(p, B, st);
      case 256: return f32::launch<256, float>(p, B, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const bf16::Params p{o,      lse,    H,        H / Hkv, Sq,
                       Skv,    causal, window,   q_offset, scale};
#define WG_LAUNCH(DH)                                                      \
  bf16::launch<DH>(q, k, v, p, B, Hkv, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, \
                 vsh, st)
  switch (D) {
    case 32: return WG_LAUNCH(32);
    case 64: return WG_LAUNCH(64);
    case 80: return WG_LAUNCH(80);
    case 96: return WG_LAUNCH(96);
    case 128: return WG_LAUNCH(128);
    case 192: return WG_LAUNCH(192);
    case 256: return WG_LAUNCH(256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef WG_LAUNCH
}
