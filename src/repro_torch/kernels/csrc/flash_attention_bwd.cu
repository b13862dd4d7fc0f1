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
// Three launches a backward (kernel b in two passes above Dh 128, see
// below).  Kernel b owns a kv tile of one kv head of one
// batch entry: it walks the G query heads of its group and, of each, only
// the q tiles whose rows can see a key of the tile (query positions in
// [k0, k1 + window) under the causal and window masks), and accumulates dk
// and dv in registers, each written once: the sum over the group stays in
// the block, with no atomics, so the gradients are bitwise on repeat.
// Kernel c owns a q tile of one query head and walks the kv tiles its rows
// can see, as the forward does.  Rows past Sq and keys past Skv read as
// zeros; a row that sees no key (lse = +inf) has P = 0: its dq is exactly 0
// and it adds nothing to dk, dv.  q, k and v are read through their strides
// (Dh contiguous); o, do and the outputs are contiguous [B, S, H, Dh].
//
// Work: 10 Dh FLOPs a visible (q, k) pair in the formulas (q k^T, do v^T,
// P^T do, dS^T q, dS k; 1.29e12 at the serving shape of h2o-danube-1.8b,
// q [2, 8192, 32, 80], window 4096): 1.30 ms at the card's 989 TFLOP/s of
// bf16 tensor-core rate, 19.2 ms at its FP32 peak; the bytes (q, k, v, o,
// do, dq, dk, dv) are 0.1 ms: compute bound.  The input type picks the
// design.
//
// bfloat16 (the train path): bf16 wgmma fed by TMA, the forward's parts
// (flash_hopper.cuh).  Both kernels are blocks of three warpgroups: two
// consumers own 64 rows each of the block's 128 (the M of wgmma); one
// thread of the third (one warp in kernel b) produces.  It TMA-loads the
// block's own tiles once and streams 64-row tiles through a ring of two
// stages with a full and an empty mbarrier each (setmaxnreg moves the
// producer's registers to the consumers).  In the one chunk layout every
// tile serves both as a K-major and as an N-major wgmma operand.
//   Kernel b (block: 128 kv rows; stream: the q and do tiles of the walk).
// S^T = K Q^T and dP^T = V do^T are ss products (m64n64k16, both operands
// K-major); P^T = exp(S^T scale - lse) and dS^T = P^T (dP^T - delta) are
// computed in the accumulator fragment, whose columns are q rows: the
// producer warp stages each q tile's lse and delta in shared memory beside
// it (+inf and 0 for rows past Sq).  The fragment is then the A operand of
// dV += P^T do and dK += dS^T q, rs products (m64nDhk16) with do and q
// N-major from the same tiles: P and dS never go through shared memory.
//   Above Dh 128 kernel b runs in two passes (two launches of one launcher
// call): dV alone (S^T, P^T, dV += P^T do), then dK alone (S^T, dP^T,
// dS^T, dK += dS^T q).  Both accumulators of 64 kv rows at Dh 192 would
// take 192 registers a consumer thread before S, dP and their split A
// operands; one a pass leaves 160 (dV) and 192 (dK) under setmaxnreg's
// 240.  The second pass recomputes S^T: 2 Dh FLOPs more a visible pair.
//   At Dh 256 (recurrentgemma's local attention) the streamed tiles are
// 32 rows (stream_rows): two 64-row stages beside the owned tiles would
// take 256 KB of shared memory, and the 128 accumulators of dK (or dQ)
// beside a 64-row tile's S, dP and split dS (32 + 32 + 32 registers)
// would spill under setmaxnreg's 240; at 32 rows they are 16 + 16 + 16,
// and the tiles take 192 KB.  The ss products are then m64n32k16, the
// rs products m64n256k16.
//   Kernel c (block: 128 q rows, q and do loaded once; stream: k and v).
// S = Q K^T and dP = do V^T are ss products; P and dS in the fragment;
// dQ += dS K an rs product with K N-major.  The separate dq kernel
// recomputes S and dP (8 Dh a pair); one pass with dq partials per kv tile
// would need ~5.5 GB of float32 scratch at the serving shape.
//   Precision: products of bf16 values are exact in float32 and every sum is
// float32, but P and dS are float32 values, not bf16 ones: each is split
// into TERMS = 2 bf16 terms (the second the round-to-nearest of what the
// first left), which rebuild it within 2^-16 of its magnitude.  One term
// (2^-8) leaves a CPU model of this arithmetic at 0.46-0.85 of the bound
// FLASH_BWD_REL (2^-7 of each gradient's largest), two at 0.12-0.27,
// three at 0.07-0.21: most of what is left is the one rounding of each
// gradient to bf16 (tests/test_torch_launchers.py).  So the kernels
// execute (8 + 6 TERMS) Dh = 20 Dh FLOPs a visible pair on the tensor
// cores, plus the masked part of the tiles that cut a visible range; only
// those tiles are masked.
//
// float32 (flash_bwd_fma.cu): FP32 FMA, the port running without TF32.
// The same kernels b and c on 64-row owned tiles, resident in shared
// memory, and a 3-stage cp.async ring of the streamed tiles: in column
// chunks for S and dP, in row chunks for the products that sum over the
// streamed rows; 4 x 4 register tiles fed by 16-byte reads; dk/dv in a dV
// and a dK pass above Dh 128, as in bfloat16.
#include <math.h>

#include "flash_bwd_fma.cuh"
#include "flash_hopper.cuh"

namespace {

constexpr int THREADS = 256;   // kernel a: a warp a row

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

// ------------------------------------- bfloat16: wgmma + TMA (kernels b, c)
namespace wg {

using namespace hopper;

constexpr int BM = 128;       // rows a block owns: kv rows (b), q rows (c)
constexpr int STAGES = 2;     // the ring of streamed tiles
constexpr int THREADS = 384;  // warpgroups 0, 1 consume, 2 produces
constexpr int CONSUMER_WARPS = 8;
constexpr int TERMS = 2;      // bf16 terms of P and dS (header note)

// rows of a streamed tile, q rows (b) or kv rows (c): 64, and 32 above Dh
// 192, where two 64-row stages beside the owned tiles would need 256 KB of
// shared memory and the 128 accumulators of dK or dQ leave a consumer
// thread no room for a 64-row tile's S, dP and split dS under 240
constexpr int stream_rows(int dh) { return dh > 192 ? 32 : 64; }

template <int DH>
struct Layout {               // byte offsets in shared memory
  static constexpr int BN = stream_rows(DH);  // rows of a streamed tile
  static constexpr int NS = BN / 2;  // accumulators of an ss product
  static constexpr int NA = BN / KSTEP * 4 * TERMS;  // A registers of a
                                                     // split operand
  static constexpr int NCH = DH / KSTEP;      // chunks per tile row
  static constexpr int OWN = BM * ROW;        // a chunk of an owned tile
  static constexpr int STR = BN * ROW;        // a chunk of a streamed tile
  static constexpr int A0 = 0;                // owned: k (b), q (c)
  static constexpr int A1 = A0 + NCH * OWN;   // owned: v (b), do (c)
  static constexpr int S0 = A1 + NCH * OWN;   // [STAGES][NCH] q (b), k (c)
  static constexpr int S1 = S0 + STAGES * NCH * STR;   // do (b), v (c)
  static constexpr int ROWS = S1 + STAGES * NCH * STR;  // b: [STAGES] lse,
                                                        // delta of BN rows
  static constexpr int BAR = ROWS + STAGES * 2 * BN * 4;  // full, empty, own
  static constexpr int BYTES = BAR + 8 * (2 * STAGES + 1);
  static constexpr int OWN_TX = 2 * BM * DH * 2;  // bytes per load
  static constexpr int STR_TX = 2 * BN * DH * 2;
  static_assert(BYTES + 1024 <= 232448, "over a block's shared memory");
};

// kernel b's passes: dK and dV in one (BOTH), or, above Dh 128, dV alone
// then dK alone (header note)
enum Part { BOTH = 0, DV_ONLY = 1, DK_ONLY = 2 };
constexpr bool two_pass(int dh) { return dh > 128; }

struct Params {
  const float* lse;    // [B, H, Sq]
  const float* delta;  // [B, H, Sq]
  void* out0;          // b: dk, c: dq
  void* out1;          // b: dv
  int H, Hkv, G, Sq, Skv, causal, window, q_offset;  // window < 0: none
  float scale;
};

__device__ __forceinline__ bool visible(long long kpos, long long qpos,
                                        const Params& p) {
  return (!p.causal || kpos <= qpos) &&
         (p.window < 0 || kpos > qpos - p.window);
}

// the rs products of one streamed tile: d += A B over BN / KSTEP k-steps of
// TERMS terms each, A the split fragment a, B N-major in shared memory at
// `tile` (the next 16 columns one chunk on, the next 8 rows 256 bytes on)
template <int DH>
__device__ __forceinline__ void rs_tile(float (&d)[DH / 2],
                                        const uint32_t (&a)[Layout<DH>::NA],
                                        uint32_t tile) {
#pragma unroll
  for (int kk = 0; kk < Layout<DH>::BN / KSTEP; ++kk) {
    const uint64_t db = desc32(tile + kk * KSTEP * ROW, Layout<DH>::STR,
                               8 * ROW);
#pragma unroll
    for (int t = 0; t < TERMS; ++t)
      wgmma_pv<DH>(d, &a[(kk * TERMS + t) * 4], db);
  }
}

// the two ss products of one streamed tile, s = A0w S0^T and dp = A1w S1^T
// over NCH k-steps (A the consumer's 64 rows of the owned tiles, B the
// streamed tiles, both K-major), in two commit groups; returns once s is
// done, dp still in flight (wait_all before reading it)
template <int DH>
__device__ __forceinline__ void issue_ss(float (&s)[Layout<DH>::NS],
                                         float (&dp)[Layout<DH>::NS],
                                         uint32_t a0, uint32_t a1,
                                         uint32_t b0, uint32_t b1) {
  using L = Layout<DH>;
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < L::NCH; ++c)
    wgmma_ss<L::BN>(s, desc32(a0 + c * L::OWN, 16, 8 * ROW),
                    desc32(b0 + c * L::STR, 16, 8 * ROW), c > 0);
  wgmma_commit();
#pragma unroll
  for (int c = 0; c < L::NCH; ++c)
    wgmma_ss<L::BN>(dp, desc32(a1 + c * L::OWN, 16, 8 * ROW),
                    desc32(b1 + c * L::STR, 16, 8 * ROW), c > 0);
  wgmma_commit();
  wgmma_wait_one_pending();
  fence_regs(s);
}

// s = A0w S0^T alone (kernel b's dV pass), waited for
template <int DH>
__device__ __forceinline__ void issue_s(float (&s)[Layout<DH>::NS],
                                        uint32_t a0, uint32_t b0) {
  using L = Layout<DH>;
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < L::NCH; ++c)
    wgmma_ss<L::BN>(s, desc32(a0 + c * L::OWN, 16, 8 * ROW),
                    desc32(b0 + c * L::STR, 16, 8 * ROW), c > 0);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(s);
}

// x (NS accumulators, k-step kk in registers 8 kk..) into its TERMS bf16
// terms in the A operand's order
template <int DH>
__device__ __forceinline__ void split_fragment(
    const float (&x)[Layout<DH>::NS], uint32_t (&a)[Layout<DH>::NA]) {
#pragma unroll
  for (int kk = 0; kk < Layout<DH>::BN / KSTEP; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_terms<TERMS>(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1],
                         &a[kk * TERMS * 4 + r], 4);
}

// element i of a fragment sits at row (warp 16 + lane / 4) (+8 when i & 2)
// of the warpgroup's 64, column 8 (i / 4) + 2 (lane % 4) + (i & 1)
__device__ __forceinline__ int frag_row(int i) { return 8 * ((i >> 1) & 1); }
__device__ __forceinline__ int frag_col(int i) { return 8 * (i / 4) + (i & 1); }

// ------------------------------------------ (b) dk, dv: one block a kv tile
template <int DH, int PART>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const __grid_constant__ CUtensorMap tdo,
                                const Params p) {
  using L = Layout<DH>;
  constexpr int NCH = L::NCH, NO = DH / 2, BN = L::BN, NS = L::NS,
                NA = L::NA;
  constexpr bool WANT_DK = PART != DV_ONLY, WANT_DV = PART != DK_ONLY;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the swizzle pattern repeats every 256 bytes: align every chunk to 1024
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* rows = reinterpret_cast<float*>(smem_raw + (base - raw) + L::ROWS);
  const uint32_t full = base + L::BAR, empty = full + 8 * STAGES,
                 own = empty + 8 * STAGES;

  const int k0 = blockIdx.x * BM, hk = blockIdx.y, b = blockIdx.z;
  // the q rows that can see a key of this tile: positions [k0, k1 + window)
  const long long k1 = min(k0 + BM, p.Skv) - 1;
  long long ilo = 0, ihi = p.Sq;
  if (p.causal) ilo = max(0LL, (long long)k0 - p.q_offset);
  if (p.window >= 0) ihi = min(ihi, k1 + p.window - p.q_offset);
  const int tlo = (int)(ilo / BN);
  const int ntq =
      ihi > (long long)tlo * BN ? (int)((ihi + BN - 1) / BN) - tlo : 0;
  const int total = p.G * ntq;  // the walk: head g's tiles, g = 0.. G - 1

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 32);  // the producer warp's lanes
      mbar_init(empty + 8 * s, CONSUMER_WARPS);
    }
    mbar_init(own, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 2 * 128) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    const int lane = threadIdx.x & 31;
    if (threadIdx.x < 2 * 128 + 32 && total > 0) {
      if (lane == 0) {
        mbar_expect_tx(own, L::OWN_TX);
        for (int c = 0; c < NCH; ++c) {
          tma_load(base + L::A0 + c * L::OWN, &tk, own, c * KSTEP, k0, hk, b);
          tma_load(base + L::A1 + c * L::OWN, &tv, own, c * KSTEP, k0, hk, b);
        }
      }
      for (int it = 0; it < total; ++it) {
        const int s = it % STAGES, h = hk * p.G + it / ntq;
        const int q0 = (tlo + it % ntq) * BN;
        const uint32_t bar = full + 8 * s;
        mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
        float* rs = rows + s * 2 * BN;
        for (int r = lane; r < BN; r += 32) {
          const int row = q0 + r;
          const size_t at = ((size_t)b * p.H + h) * p.Sq + row;
          rs[r] = row < p.Sq ? p.lse[at] : INFINITY;
          rs[BN + r] = row < p.Sq ? p.delta[at] : 0.f;
        }
        if (lane == 0) {  // its arrival carries the tiles' bytes
          mbar_expect_tx(bar, L::STR_TX);
          for (int c = 0; c < NCH; ++c) {
            tma_load(base + L::S0 + (s * NCH + c) * L::STR, &tq, bar,
                     c * KSTEP, q0, h, b);
            tma_load(base + L::S1 + (s * NCH + c) * L::STR, &tdo, bar,
                     c * KSTEP, q0, h, b);
          }
        } else {
          mbar_arrive(bar);
        }
      }
    }
    return;
  }

  // ------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int wgi = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3,
            lane = threadIdx.x & 31;
  const int cq = (lane & 3) * 2;                // the quad's columns
  const int kw0 = k0 + wgi * 64;                // this warpgroup's kv rows
  const int rl = warp * 16 + (lane >> 2);       // rows rl and rl + 8 of them
  const int nkw = max(0, min(64, p.Skv - kw0));
  const long long khi = (long long)kw0 + nkw - 1;
  const uint32_t ka = base + L::A0 + wgi * 64 * ROW,
                 va = base + L::A1 + wgi * 64 * ROW;

  float dk[WANT_DK ? NO : 1], dv[WANT_DV ? NO : 1], st[NS], dp[NS];
  uint32_t pa[NA], da[NA];
#pragma unroll
  for (int i = 0; i < NO; ++i) {
    if constexpr (WANT_DK) dk[i] = 0.f;
    if constexpr (WANT_DV) dv[i] = 0.f;
  }

  if (total > 0) mbar_wait(own, 0);
  for (int it = 0; it < total; ++it) {
    const int s = it % STAGES;
    const int q0 = (tlo + it % ntq) * BN;
    mbar_wait(full + 8 * s, (it / STAGES) & 1);
    const int nq = min(BN, p.Sq - q0);
    const long long qlo = (long long)p.q_offset + q0, qhi = qlo + nq - 1;
    // whether this warpgroup's rows see any of the tile, and all of it
    const bool seen = nkw > 0 && nq > 0 && (!p.causal || kw0 <= qhi) &&
                      (p.window < 0 || khi > qlo - p.window);
    if (seen) {
      const uint32_t qs = base + L::S0 + s * NCH * L::STR,
                     dos = base + L::S1 + s * NCH * L::STR;
      if constexpr (WANT_DK)
        issue_ss<DH>(st, dp, ka, va, qs, dos);  // S^T = K Q^T, dP^T = V do^T
      else
        issue_s<DH>(st, ka, qs);  // S^T alone
      const bool all = (!p.causal || khi <= qlo) &&
                       (p.window < 0 || kw0 > qhi - p.window);
      const float* lr = rows + s * 2 * BN;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {  // P^T, its columns' lse
        const float2 l2 = *reinterpret_cast<const float2*>(lr + 8 * j + cq);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          st[i] = ex2((st[i] * p.scale - (e & 1 ? l2.y : l2.x)) * LOG2E);
          if (!all && !visible(kw0 + rl + frag_row(i),
                               qlo + frag_col(i) + cq, p))
            st[i] = 0.f;
        }
      }
      if constexpr (WANT_DV) split_fragment<DH>(st, pa);
      if constexpr (WANT_DK) {
        wgmma_wait_all();
        fence_regs(dp);
      }
      if constexpr (WANT_DV) {
        wgmma_fence();
        rs_tile<DH>(dv, pa, dos);  // dV += P^T do, while dS^T is formed
      }
      if constexpr (WANT_DK) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {  // dS^T = P^T (dP^T - delta)
          const float2 d2 =
              *reinterpret_cast<const float2*>(lr + BN + 8 * j + cq);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            dp[i] = st[i] * (dp[i] - (e & 1 ? d2.y : d2.x));
          }
        }
        split_fragment<DH>(dp, da);
        wgmma_fence();
        rs_tile<DH>(dk, da, qs);  // dK += dS^T q
      }
      wgmma_commit();
      wgmma_wait_all();
      if constexpr (WANT_DV) {
        fence_regs(dv);
        fence_regs(pa);
      }
      if constexpr (WANT_DK) {
        fence_regs(dk);
        fence_regs(da);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

  // rows past Skv are not stored; a tile no q row sees writes 0
  __nv_bfloat16* DK = static_cast<__nv_bfloat16*>(p.out0);
  __nv_bfloat16* DV = static_cast<__nv_bfloat16*>(p.out1);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = kw0 + rl + 8 * hh;
    if (row >= p.Skv) continue;
    const size_t at = (((size_t)b * p.Skv + row) * p.Hkv + hk) * DH + cq;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      if constexpr (WANT_DK)
        *reinterpret_cast<__nv_bfloat162*>(DK + at + 8 * j) =
            __floats2bfloat162_rn(dk[4 * j + 2 * hh] * p.scale,
                                  dk[4 * j + 2 * hh + 1] * p.scale);
      if constexpr (WANT_DV)
        *reinterpret_cast<__nv_bfloat162*>(DV + at + 8 * j) =
            __floats2bfloat162_rn(dv[4 * j + 2 * hh],
                                  dv[4 * j + 2 * hh + 1]);
    }
  }
}

// --------------------------------------------- (c) dq: one block a q tile
template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              const Params p) {
  using L = Layout<DH>;
  constexpr int NCH = L::NCH, NO = DH / 2, BN = L::BN, NS = L::NS,
                NA = L::NA;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base =
      ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = base + L::BAR, empty = full + 8 * STAGES,
                 own = empty + 8 * STAGES;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;  // the longest first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / p.G;

  // the kv tiles any q row of this block can see
  const int nrows = min(BM, p.Sq - q0);
  const long long qlo = (long long)p.q_offset + q0, qhi = qlo + nrows - 1;
  long long kbeg = 0, kend = p.Skv;
  if (p.causal && qhi + 1 < kend) kend = qhi + 1;
  if (p.window >= 0 && qlo - p.window + 1 > kbeg) kbeg = qlo - p.window + 1;
  const int t0 = (int)(kbeg / BN);
  const int ntiles = kend > kbeg ? (int)((kend + BN - 1) / BN) - t0 : 0;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMER_WARPS);
    }
    mbar_init(own, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 2 * 128) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 2 * 128 && ntiles > 0) {
      mbar_expect_tx(own, L::OWN_TX);
      for (int c = 0; c < NCH; ++c) {
        tma_load(base + L::A0 + c * L::OWN, &tq, own, c * KSTEP, q0, h, b);
        tma_load(base + L::A1 + c * L::OWN, &tdo, own, c * KSTEP, q0, h, b);
      }
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % STAGES;
        const uint32_t bar = full + 8 * s;
        mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(bar, L::STR_TX);
        const int k0 = (t0 + it) * BN;
        for (int c = 0; c < NCH; ++c) {
          tma_load(base + L::S0 + (s * NCH + c) * L::STR, &tk, bar,
                   c * KSTEP, k0, hk, b);
          tma_load(base + L::S1 + (s * NCH + c) * L::STR, &tv, bar,
                   c * KSTEP, k0, hk, b);
        }
      }
    }
    return;
  }

  // ------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int wgi = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3,
            lane = threadIdx.x & 31;
  const int cq = (lane & 3) * 2;                 // the quad's columns
  const int rw = q0 + wgi * 64;                  // this warpgroup's rows
  const int r0 = rw + warp * 16 + (lane >> 2);   // rows r0 and r0 + 8
  const int nrw = max(0, min(64, p.Sq - rw));
  const long long qlw = (long long)p.q_offset + rw, qhw = qlw + nrw - 1;
  const uint32_t qa = base + L::A0 + wgi * 64 * ROW,
                 doa = base + L::A1 + wgi * 64 * ROW;

  float lse[2], dl[2];  // rows past Sq see nothing
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r0 + 8 * hh;
    const size_t at = ((size_t)b * p.H + h) * p.Sq + row;
    lse[hh] = row < p.Sq ? p.lse[at] : INFINITY;
    dl[hh] = row < p.Sq ? p.delta[at] : 0.f;
  }

  float dq[NO], st[NS], dp[NS];
  uint32_t da[NA];
#pragma unroll
  for (int i = 0; i < NO; ++i) dq[i] = 0.f;

  if (ntiles > 0) mbar_wait(own, 0);
  for (int it = 0; it < ntiles; ++it) {
    const int s = it % STAGES;
    const long long k0 = (long long)(t0 + it) * BN;
    mbar_wait(full + 8 * s, (it / STAGES) & 1);
    const bool seen = nrw > 0 && k0 < p.Skv && (!p.causal || k0 <= qhw) &&
                      (p.window < 0 || k0 + BN - 1 > qlw - p.window);
    if (seen) {
      const uint32_t ks = base + L::S0 + s * NCH * L::STR,
                     vs = base + L::S1 + s * NCH * L::STR;
      issue_ss<DH>(st, dp, qa, doa, ks, vs);  // S = Q K^T, dP = do V^T
      // the tile's visible columns per row, [lo, hi); all where no row
      // meets a mask or the end of the keys
      int lo[2] = {0, 0}, hi[2] = {BN, BN};
      if (!(k0 + BN <= p.Skv && (!p.causal || k0 + BN - 1 <= qlw) &&
            (p.window < 0 || k0 > qhw - p.window))) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const long long qpos = (long long)p.q_offset + r0 + 8 * hh;
          long long e = p.Skv, a = 0;
          if (p.causal && qpos + 1 < e) e = qpos + 1;
          if (p.window >= 0) a = qpos - p.window + 1;
          lo[hh] = (int)min(max(a - k0, 0LL), (long long)BN);
          hi[hh] = (int)min(max(e - k0, 0LL), (long long)BN);
        }
      }
#pragma unroll
      for (int i = 0; i < NS; ++i) {  // P
        const int hh = (i >> 1) & 1, col = frag_col(i) + cq;
        st[i] = ex2((st[i] * p.scale - lse[hh]) * LOG2E);
        if (col < lo[hh] || col >= hi[hh]) st[i] = 0.f;
      }
      wgmma_wait_all();
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < NS; ++i)  // dS = P (dP - delta)
        dp[i] = st[i] * (dp[i] - dl[(i >> 1) & 1]);
      split_fragment<DH>(dp, da);
      wgmma_fence();
      rs_tile<DH>(dq, da, ks);  // dQ += dS K
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dq);
      fence_regs(da);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

  // rows past Sq are not stored; a row that sees no key writes 0
  __nv_bfloat16* DQ = static_cast<__nv_bfloat16*>(p.out0);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r0 + 8 * hh;
    if (row >= p.Sq) continue;
    __nv_bfloat16* out = DQ + (((size_t)b * p.Sq + row) * p.H + h) * DH + cq;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
          __floats2bfloat162_rn(dq[4 * j + 2 * hh] * p.scale,
                                dq[4 * j + 2 * hh + 1] * p.scale);
  }
}

typedef void (*Kernel)(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap,
                       Params);

// one launch of `kernel` on its grid with the shared memory of Layout<DH>
template <int DH>
int launch_one(Kernel kernel, dim3 grid, const CUtensorMap& tq,
               const CUtensorMap& tk, const CUtensorMap& tv,
               const CUtensorMap& tdo, const Params& p, cudaStream_t stream) {
  const int smem = Layout<DH>::BYTES + 1024;  // + the alignment to 1024
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, THREADS, smem, stream>>>(tq, tk, tv, tdo, p);
  return (int)cudaGetLastError();
}

// kernel b (dq = false; in two passes above Dh 128) or c (dq = true) at
// head dim DH: the tensor maps (q and do in boxes of the streamed or the
// owned rows, k and v the other way round), the shared memory, the grid
template <int DH>
int launch(bool dq, const void* q, const void* k, const void* v,
           const void* dout, const Params& p, int B, long long qsb,
           long long qss, long long qsh, long long ksb, long long kss,
           long long ksh, long long vsb, long long vss, long long vsh,
           cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  constexpr int BN = Layout<DH>::BN;
  const int qrows = dq ? BM : BN, krows = dq ? BN : BM;
  // an empty side loads no tile, but its map must encode
  const int sq = p.Sq > 0 ? p.Sq : 1, skv = p.Skv > 0 ? p.Skv : 1;
  const long long drow = (long long)p.H * DH;  // do's row stride
  int rc = encode(&tq, q, B, sq, p.H, DH, qsb, qss, qsh, qrows);
  if (rc == 0)
    rc = encode(&tdo, dout, B, sq, p.H, DH, (long long)sq * drow, drow, DH,
                qrows);
  if (rc == 0) rc = encode(&tk, k, B, skv, p.Hkv, DH, ksb, kss, ksh, krows);
  if (rc == 0) rc = encode(&tv, v, B, skv, p.Hkv, DH, vsb, vss, vsh, krows);
  if (rc != 0) return rc;
  const dim3 grid(((dq ? p.Sq : p.Skv) + BM - 1) / BM, dq ? p.H : p.Hkv, B);
  if (dq)
    return launch_one<DH>(flash_bwd_dq_wgmma_kernel<DH>, grid, tq, tk, tv,
                          tdo, p, stream);
  if constexpr (!two_pass(DH)) {
    return launch_one<DH>(flash_bwd_dkdv_wgmma_kernel<DH, BOTH>, grid, tq,
                          tk, tv, tdo, p, stream);
  } else {
    rc = launch_one<DH>(flash_bwd_dkdv_wgmma_kernel<DH, DV_ONLY>, grid, tq,
                        tk, tv, tdo, p, stream);
    if (rc != 0) return rc;
    return launch_one<DH>(flash_bwd_dkdv_wgmma_kernel<DH, DK_ONLY>, grid, tq,
                          tk, tv, tdo, p, stream);
  }
}

}  // namespace wg

int run(bool dq, const void* q, const void* k, const void* v,
        const void* dout, const float* lse, const float* delta, void* dqp,
        void* dkp, void* dvp, int B, int H, int Hkv, int Sq, int Skv, int D,
        long long qsb, long long qss, long long qsh, long long ksb,
        long long kss, long long ksh, long long vsb, long long vss,
        long long vsh, int causal, int window, int q_offset, float scale,
        int dtype, void* stream) {
  if (Hkv < 1 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  // an empty grid; every block of a non-empty one writes its tile, zeros
  // where it sees nothing (dq of Skv = 0, dk and dv of Sq = 0)
  if (B == 0 || (dq ? Sq : Skv) == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    // 16-byte copies where every row of q, k, v and do starts on 16 bytes
    // (do is contiguous, its rows D floats: its base decides)
    const bool vec = ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                      (uintptr_t)dout) % 16 == 0 &&
                     (qsb | qss | qsh | ksb | kss | ksh | vsb | vss | vsh) %
                             4 == 0;
    const flash_fma::Params p{
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dqp), static_cast<float*>(dkp),
        static_cast<float*>(dvp), B, H, Hkv, H / Hkv, Sq, Skv, qsb, qss, qsh,
        ksb, kss, ksh, vsb, vss, vsh, causal, window, q_offset, scale,
        (int)vec};
    return flash_fma::launch(dq, p, D, st);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const wg::Params w{lse,     delta, dq ? dqp : dkp, dvp,  H,
                     Hkv,     H / Hkv, Sq,          Skv,  causal,
                     window,  q_offset, scale};
#define WG_LAUNCH(DH)                                                     \
  wg::launch<DH>(dq, q, k, v, dout, w, B, qsb, qss, qsh, ksb, kss, ksh, \
                 vsb, vss, vsh, st)
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
// none.  scale: the forward's, 1/sqrt(Dh) of the caller's head dim (below
// D where the wrapper zero-padded the operands).  Returns a cudaError_t.
extern "C" int flash_attention_bwd_dkdv_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, int B, int H,
    int Hkv, int Sq, int Skv, int D, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, int causal, int window,
    int q_offset, float scale, int dtype, void* stream) {
  return run(false, q, k, v, dout, lse, delta, nullptr, dk, dv, B, H, Hkv,
             Sq, Skv, D, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, causal,
             window, q_offset, scale, dtype, stream);
}

// Kernel c: dq (contiguous [B, Sq, H, D]) from the same inputs.
extern "C" int flash_attention_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, int B, int H, int Hkv,
    int Sq, int Skv, int D, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, int causal, int window, int q_offset,
    float scale, int dtype, void* stream) {
  return run(true, q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, H,
             Hkv, Sq, Skv, D, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh,
             causal, window, q_offset, scale, dtype, stream);
}
