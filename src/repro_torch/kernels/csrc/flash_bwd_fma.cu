// The float32 backward of flash attention (flash_attention_bwd.cu's kernels
// b and c for float32 inputs) on FP32 FMA, for sm_90a.  The port runs
// without TF32, and the card has no float32 tensor-core route without it,
// so every product here is an FFMA.
//
// Replaces no TPU kernel: the Pallas kernel src/repro/kernels/
// flash_attention.py:flash_attention_1h has no backward (see
// flash_attention_bwd.cu's header, which also gives the formulas).
//
// What bounds it: 10 Dh FLOPs a visible (q, k) pair in the formulas, at
// the FP32 rate (67 TFLOP/s) 17.95 ms at recurrentgemma's float32 shape
// (q [2, 8192, 16, 256], window 2048), against 0.1 ms of bytes: compute
// bound.  The kernels execute 14 Dh a pair (16 Dh above Dh 128, where the
// dk/dv kernel runs a dV and a dK pass, each recomputing S), so the aim is
// the FFMA pipes' rate, which needs operands fed from shared memory at a
// quarter of a load a FMA or less and copies that never stall the FMAs.
//
// Both kernels run one body.  A block of 256 threads owns 64 rows (kv rows
// in kernel b, q rows in kernel c), whose operands A0, A1 (k, v; q, do)
// stay resident in shared memory, and walks the 64-row tiles of the other
// side that its rows can see (kernel b: the q tiles of each of the G query
// heads of its group; kernel c: the kv tiles), streamed through a 3-stage
// cp.async ring of 16-byte copies.  For each streamed tile (S0, S1: q, do;
// k, v):
//   phase 1  X = A0 S0^T and Y = A1 S1^T, [64 own x 64 streamed], over Dh
//            in column chunks of DC (32; 40 at Dh 80, 48 at Dh 96) a
//            stage; each thread holds a 4 x 4 register tile of both and
//            reads its operands as float4 along d (rows 16 apart, row
//            strides of 4 mod 8 float4s: a warp's reads hit distinct bank
//            quads or broadcast);
//            then P = exp(X scale - lse) where the masks keep the pair, dS
//            = P (Y - delta), written to shared memory as [streamed][own];
//   phase 2  out[own, d] += sum_r M[r, own] S[r, d] (dV += P^T do, dK +=
//            dS^T q; dQ += dS k) over the tile's rows in chunks of RC (32;
//            16 above Dh 128) a stage: the streamed operand is fetched a
//            second time, row-wise, so that a stage holds all Dh columns;
//            each thread owns 4 consecutive own rows (one float4 of M) by
//            Dh / 16 columns (float4, float2 or scalar reads, 16 apart).
// The sums run in a fixed order (d, then the walk's tiles, then rows), with
// no atomics: the gradients are bitwise on repeat.  Kernel b sums the group's
// heads in its registers as before.  Rows past Sq and keys past Skv are
// copied as zeros and masked; a row that sees no key has lse = +inf and
// P = 0, so its dq is exactly 0 and it adds nothing to dk, dv.
//
// Shared memory at Dh 256 (kernel c, kernel b's dK pass): 133 KB resident,
// 55 KB of ring, 17 KB of dS: one block of 8 warps an SM, which the
// accumulators (up to 64 a thread beside X and Y's 32) want anyway.
#include <math.h>

#include "flash_bwd_fma.cuh"

namespace flash_fma {
namespace {

constexpr int NT = 256;      // threads: 16 x 16
constexpr int BR = 64;       // rows of the owned and of a streamed tile
constexpr int NS = 3;        // stages of the ring
constexpr int LM = BR + 4;   // row stride of the P and dS buffers

// what a launch computes: kernel b's dk and dv in one pass, or its dV and
// its dK pass (above Dh 128), or kernel c's dq
enum Kind { BOTH = 0, DV_ONLY = 1, DK_ONLY = 2, DQ = 3 };

template <int DH, int KIND>
struct Cfg {
  static constexpr bool KV = KIND != DQ;   // owns kv rows (kernel b)
  static constexpr bool Y = KIND != DV_ONLY;         // Y = A1 S1^T wanted
  static constexpr bool OUT_P = KIND == BOTH || KIND == DV_ONLY;  // dV
  static constexpr bool OUT_S = KIND != DV_ONLY;     // dK or dQ
  static constexpr int N1 = Y ? 2 : 1;                // phase-1 operands
  static constexpr int N2 = (OUT_P ? 1 : 0) + (OUT_S ? 1 : 0);  // phase 2
  static constexpr int DC = DH == 80 ? 40 : DH == 96 ? 48 : 32;
  static constexpr int NC1 = DH / DC;       // phase-1 stages a tile
  static constexpr int RC = DH > 128 ? 16 : 32;
  static constexpr int NC2 = BR / RC;       // phase-2 stages a tile
  static constexpr int NST = NC1 + NC2;
  // phase 2's columns a thread: TQ groups of CW, 16 CW apart
  static constexpr int CW = DH % 64 == 0 ? 4 : DH % 32 == 0 ? 2 : 1;
  static constexpr int TQ = DH / (16 * CW);
  static constexpr int LO = DH + 4;  // row stride of the owned tiles
  static constexpr int L1 = DC + 4;  // of a phase-1 chunk
  static constexpr int L2 = DH + 4;  // of a phase-2 chunk
  static constexpr int SLOT0 = N1 * BR * L1, SLOT1 = N2 * RC * L2;
  static constexpr int SLOT = ((SLOT0 > SLOT1 ? SLOT0 : SLOT1) + 3) / 4 * 4;
  // float offsets: A0 | A1 | ring | P | dS | lse, delta (x 2 tiles)
  static constexpr int A1 = BR * LO;
  static constexpr int RING = A1 + (Y ? BR * LO : 0);
  static constexpr int MP = RING + NS * SLOT;
  static constexpr int MS = MP + (OUT_P ? BR * LM : 0);
  static constexpr int ST = MS + (OUT_S ? BR * LM : 0);
  static constexpr int FLOATS = ST + (KV ? 4 * BR : 0);
  static constexpr size_t BYTES = sizeof(float) * FLOATS;
  static_assert(DH % DC == 0 && DC % 4 == 0, "phase-1 chunks");
  static_assert(TQ * 16 * CW == DH, "phase-2 columns");
  static_assert(BYTES <= 232448, "over a block's shared memory");
};

// 4- and 16-byte asynchronous copies to shared memory; ok false zero-fills
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows r0 .. r0 + ROWS - 1 (zeros at or past n), columns c0 .. c0 + COLS - 1
// of an operand with row stride rs into a [ROWS][LD] tile
template <int ROWS, int COLS, int LD>
__device__ __forceinline__ void copy_tile(float* dst, const float* src,
                                          long long rs, long long r0,
                                          long long n, int c0, bool vec) {
  constexpr int U = COLS / 4;  // 16-byte units a row
  for (int e = threadIdx.x; e < ROWS * U; e += NT) {
    const int r = e / U, u = e - r * U;
    const bool ok = r0 + r < n;
    const float* s = src + (ok ? (r0 + r) * rs + c0 + 4 * u : 0);
    float* d = dst + r * LD + 4 * u;
    if (vec) {
      cp_async16(d, s, ok);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) cp_async4(d + j, s + j, ok);
    }
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// CW consecutive floats at p into v
template <int CW>
__device__ __forceinline__ void ldw(const float* p, float* v) {
  if constexpr (CW == 4) {
    const float4 f = ld4(p);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else if constexpr (CW == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x; v[1] = f.y;
  } else {
    v[0] = p[0];
  }
}

template <int CW>
__device__ __forceinline__ void stw(float* p, const float* v, float s) {
  if constexpr (CW == 4) {
    *reinterpret_cast<float4*>(p) =
        make_float4(v[0] * s, v[1] * s, v[2] * s, v[3] * s);
  } else if constexpr (CW == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0] * s, v[1] * s);
  } else {
    p[0] = v[0] * s;
  }
}

// x[i][j] += the dot product over 4 d of a[i] and b[j], in d order
__device__ __forceinline__ void fma4x4(float (&x)[4][4], const float4 (&a)[4],
                                       const float4 (&b)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x[i][j] = fmaf(a[i].x, b[j].x, x[i][j]);
      x[i][j] = fmaf(a[i].y, b[j].y, x[i][j]);
      x[i][j] = fmaf(a[i].z, b[j].z, x[i][j]);
      x[i][j] = fmaf(a[i].w, b[j].w, x[i][j]);
    }
}

template <int DH, int KIND>
__device__ __forceinline__ void body(const Params& p) {
  using C = Cfg<DH, KIND>;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* sA0 = sm;
  float* sA1 = sm + C::A1;
  float* ring = sm + C::RING;
  float* sP = sm + C::MP;
  float* sS = sm + C::MS;
  float* sStat = sm + C::ST;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // phase 1: own rows ro + 16 i, streamed rows rs + 16 j; phase 2: own rows
  // 4 ro + i, columns CW cg + 16 CW v (a warp: 4 x 8 of these)
  const int ro = (warp >> 1) * 4 + (lane >> 3);
  const int rs = (warp & 1) * 8 + (lane & 7);
  const int cg = rs;

  // the block's owned tile and head, the longest walks first
  const int lin = blockIdx.x;
  const int heads = C::KV ? p.Hkv : p.H;
  const int hb = lin % (heads * p.B), hd = hb % heads, b = hb / heads;
  const int ntile = ((C::KV ? p.Skv : p.Sq) + BR - 1) / BR;
  const int t = lin / (heads * p.B);
  const long long own0 = (long long)BR * (C::KV ? t : ntile - 1 - t);

  const float *A0, *A1, *S0, *S1;
  long long a0s, a1s, s0s, s1s, ownN, strN;
  long long s0h = 0, s1h = 0;  // head steps of S0, S1 (kernel b's walk)
  if constexpr (C::KV) {
    A0 = p.k + b * p.ksb + hd * p.ksh;
    A1 = p.v + b * p.vsb + hd * p.vsh;
    a0s = p.kss;
    a1s = p.vss;
    S0 = p.q + b * p.qsb + (long long)hd * p.G * p.qsh;
    S1 = p.dout + ((long long)b * p.Sq * p.H + (long long)hd * p.G) * DH;
    s0s = p.qss;
    s1s = (long long)p.H * DH;
    s0h = p.qsh;
    s1h = DH;
    ownN = p.Skv;
    strN = p.Sq;
  } else {
    A0 = p.q + b * p.qsb + hd * p.qsh;
    A1 = p.dout + ((long long)b * p.Sq * p.H + hd) * DH;
    a0s = p.qss;
    a1s = (long long)p.H * DH;
    const int hk = hd / p.G;
    S0 = p.k + b * p.ksb + hk * p.ksh;
    S1 = p.v + b * p.vsb + hk * p.vsh;
    s0s = p.kss;
    s1s = p.vss;
    ownN = p.Sq;
    strN = p.Skv;
  }
  const bool vec = p.vec != 0;

  // the streamed tiles these rows can see: first tile t0, ntq of them
  long long lo = 0, hi = strN;
  const long long own1 = min(own0 + BR, ownN) - 1;
  if constexpr (C::KV) {  // q rows seeing keys [own0, own1]:
                          // positions [own0, own1 + window)
    if (p.causal) lo = max(0LL, own0 - p.q_offset);
    if (p.window >= 0) hi = min(hi, own1 + p.window - p.q_offset);
  } else {  // keys seen by q positions [q_offset + own0, q_offset + own1]
    const long long qlo = p.q_offset + own0, qhi = p.q_offset + own1;
    if (p.causal) hi = min(hi, qhi + 1);
    if (p.window >= 0) lo = max(lo, qlo - p.window + 1);
  }
  const int t0 = lo < hi ? (int)(lo / BR) : 0;
  const int ntq = lo < hi ? (int)((hi + BR - 1) / BR) - t0 : 0;
  const int total = (C::KV ? p.G : 1) * ntq * C::NST;  // stages

  // the owned operands: their own commit group
  copy_tile<BR, DH, C::LO>(sA0, A0, a0s, own0, ownN, 0, vec);
  if constexpr (C::Y)
    copy_tile<BR, DH, C::LO>(sA1, A1, a1s, own0, ownN, 0, vec);
  cp_async_commit();

  // stage n = (tile n / NST, step n % NST); tile = g * ntq + tile index
  auto prefetch = [&](int n) {
    if (n < total) {
      const int tile = n / C::NST, step = n - tile * C::NST;
      const int g = C::KV ? tile / ntq : 0;
      const long long r0 = (long long)BR * (t0 + tile - g * ntq);
      const float* s0 = S0 + g * s0h;
      const float* s1 = S1 + g * s1h;
      float* slot = ring + (n % NS) * C::SLOT;
      if (step < C::NC1) {
        const int c0 = step * C::DC;
        copy_tile<BR, C::DC, C::L1>(slot, s0, s0s, r0, strN, c0, vec);
        if constexpr (C::Y)
          copy_tile<BR, C::DC, C::L1>(slot + BR * C::L1, s1, s1s, r0, strN,
                                      c0, vec);
        if (C::KV && step == 0 && tid < BR) {  // the q rows' lse and delta
          const long long row = r0 + tid;
          const size_t at = ((size_t)b * p.H + hd * p.G + g) * p.Sq + row;
          float* st = sStat + (tile & 1) * 2 * BR;
          st[tid] = row < p.Sq ? p.lse[at] : INFINITY;
          st[BR + tid] = row < p.Sq ? p.delta[at] : 0.f;
        }
      } else {
        const long long rr = r0 + (step - C::NC1) * C::RC;
        if constexpr (C::OUT_S)
          copy_tile<C::RC, DH, C::L2>(slot, s0, s0s, rr, strN, 0, vec);
        if constexpr (C::OUT_P)
          copy_tile<C::RC, DH, C::L2>(slot + (C::OUT_S ? C::RC * C::L2 : 0),
                                      s1, s1s, rr, strN, 0, vec);
      }
    }
    cp_async_commit();
  };

  // kernel c: its own rows' lse and delta (rows past Sq see nothing)
  float lr[4], dr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lr[i] = INFINITY;
    dr[i] = 0.f;
    if constexpr (!C::KV) {
      const long long row = own0 + ro + 16 * i;
      const size_t at = ((size_t)b * p.H + hd) * p.Sq + row;
      if (row < p.Sq) {
        lr[i] = p.lse[at];
        dr[i] = p.delta[at];
      }
    }
  }

  float x[4][4], y[4][4];
  float accp[C::OUT_P ? 4 : 1][C::TQ * C::CW];
  float accs[C::OUT_S ? 4 : 1][C::TQ * C::CW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) x[i][j] = y[i][j] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < C::TQ * C::CW; ++c) {
      if constexpr (C::OUT_P) accp[i][c] = 0.f;
      if constexpr (C::OUT_S) accs[i][c] = 0.f;
    }

#pragma unroll
  for (int s = 0; s < NS - 1; ++s) prefetch(s);

  int tile = 0, step = 0;
  for (int n = 0; n < total; ++n) {
    cp_async_wait<NS - 2>();
    __syncthreads();  // stage n is in; every thread is done with n - 1
    prefetch(n + NS - 1);
    const float* slot = ring + (n % NS) * C::SLOT;
    if (step < C::NC1) {
      // ------------------------------------------------------ phase 1
      const int c0 = step * C::DC;
      const float* a0 = sA0 + ro * C::LO + c0;
      const float* a1 = sA1 + ro * C::LO + c0;
      const float* b0 = slot + rs * C::L1;
      const float* b1 = slot + BR * C::L1 + rs * C::L1;
#pragma unroll
      for (int d = 0; d < C::DC; d += 4) {
        float4 av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = ld4(a0 + 16 * i * C::LO + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = ld4(b0 + 16 * j * C::L1 + d);
        fma4x4(x, av, bv);
        if constexpr (C::Y) {
#pragma unroll
          for (int i = 0; i < 4; ++i) av[i] = ld4(a1 + 16 * i * C::LO + d);
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = ld4(b1 + 16 * j * C::L1 + d);
          fma4x4(y, av, bv);
        }
      }
      if (step == C::NC1 - 1) {
        // P and dS of the tile pair, into shared memory as [streamed][own]
        const int g = C::KV ? tile / ntq : 0;
        const long long s0r = (long long)BR * (t0 + tile - g * ntq);
        const long long q0 = C::KV ? s0r : own0, k0 = C::KV ? own0 : s0r;
        const bool all = q0 + BR <= p.Sq && k0 + BR <= p.Skv &&
                         (!p.causal || k0 + BR - 1 <= p.q_offset + q0) &&
                         (p.window < 0 ||
                          k0 > p.q_offset + q0 + BR - 1 - p.window);
        const float* st = sStat + (tile & 1) * 2 * BR;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int o = ro + 16 * i, r = rs + 16 * j;
            const long long qr = C::KV ? q0 + r : q0 + o;
            const long long kr = C::KV ? k0 + o : k0 + r;
            const long long qpos = p.q_offset + qr;
            const bool ok = all || (qr < p.Sq && kr < p.Skv &&
                                    (!p.causal || kr <= qpos) &&
                                    (p.window < 0 || kr > qpos - p.window));
            const float l = C::KV ? st[r] : lr[i];
            const float pr = ok ? expf(x[i][j] * p.scale - l) : 0.f;
            if constexpr (C::OUT_P) sP[r * LM + o] = pr;
            if constexpr (C::OUT_S) {
              const float dl = C::KV ? st[BR + r] : dr[i];
              sS[r * LM + o] = pr * (y[i][j] - dl);
            }
            x[i][j] = 0.f;
            y[i][j] = 0.f;
          }
      }
    } else {
      // ------------------------------------------------------ phase 2
      const int r0 = (step - C::NC1) * C::RC;
      const float* sv0 = slot + cg * C::CW;  // dK/dQ's operand (S0)
      const float* sv1 = slot + (C::OUT_S ? C::RC * C::L2 : 0) + cg * C::CW;
#pragma unroll 4
      for (int r = 0; r < C::RC; ++r) {
        if constexpr (C::OUT_P) {
          const float4 m = ld4(sP + (r0 + r) * LM + 4 * ro);
          const float mv[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
          for (int v = 0; v < C::TQ; ++v) {
            float w[C::CW];
            ldw<C::CW>(sv1 + r * C::L2 + 16 * C::CW * v, w);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int c = 0; c < C::CW; ++c)
                accp[i][v * C::CW + c] =
                    fmaf(mv[i], w[c], accp[i][v * C::CW + c]);
          }
        }
        if constexpr (C::OUT_S) {
          const float4 m = ld4(sS + (r0 + r) * LM + 4 * ro);
          const float mv[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
          for (int v = 0; v < C::TQ; ++v) {
            float w[C::CW];
            ldw<C::CW>(sv0 + r * C::L2 + 16 * C::CW * v, w);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int c = 0; c < C::CW; ++c)
                accs[i][v * C::CW + c] =
                    fmaf(mv[i], w[c], accs[i][v * C::CW + c]);
          }
        }
      }
    }
    if (++step == C::NST) {
      step = 0;
      ++tile;
    }
  }
  cp_async_wait<0>();

  // this thread's own rows 4 ro + i, columns CW cg + 16 CW v; rows past the
  // end are not stored, a tile no row of the other side sees writes 0
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = own0 + 4 * ro + i;
    if (row >= ownN) continue;
    if constexpr (C::KV) {
      const size_t at = (((size_t)b * p.Skv + row) * p.Hkv + hd) * DH;
#pragma unroll
      for (int v = 0; v < C::TQ; ++v) {
        const int col = C::CW * cg + 16 * C::CW * v;
        if constexpr (C::OUT_S)
          stw<C::CW>(p.dk + at + col, &accs[i][v * C::CW], p.scale);
        if constexpr (C::OUT_P)
          stw<C::CW>(p.dv + at + col, &accp[i][v * C::CW], 1.f);
      }
    } else {
      const size_t at = (((size_t)b * p.Sq + row) * p.H + hd) * DH;
#pragma unroll
      for (int v = 0; v < C::TQ; ++v) {
        const int col = C::CW * cg + 16 * C::CW * v;
        stw<C::CW>(p.dq + at + col, &accs[i][v * C::CW], p.scale);
      }
    }
  }
}

template <int DH, int KIND>
__global__ void __launch_bounds__(NT, 1)
    flash_bwd_dkdv_fma_kernel(const Params p) {
  body<DH, KIND>(p);
}

template <int DH>
__global__ void __launch_bounds__(NT, 1)
    flash_bwd_dq_fma_kernel(const Params p) {
  body<DH, DQ>(p);
}

// one launch of `kernel` over every owned tile of every head and batch
template <int DH, int KIND>
int launch_one(void (*kernel)(const Params), const Params& p,
               cudaStream_t stream) {
  constexpr size_t smem = Cfg<DH, KIND>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const bool kv = KIND != DQ;
  const long long blocks = (long long)(((kv ? p.Skv : p.Sq) + BR - 1) / BR) *
                           (kv ? p.Hkv : p.H) * p.B;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, NT, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_dh(bool dq, const Params& p, cudaStream_t st) {
  if (dq) return launch_one<DH, DQ>(flash_bwd_dq_fma_kernel<DH>, p, st);
  if constexpr (DH <= 128) {
    return launch_one<DH, BOTH>(flash_bwd_dkdv_fma_kernel<DH, BOTH>, p, st);
  } else {
    const int rc =
        launch_one<DH, DV_ONLY>(flash_bwd_dkdv_fma_kernel<DH, DV_ONLY>, p, st);
    if (rc != 0) return rc;
    return launch_one<DH, DK_ONLY>(flash_bwd_dkdv_fma_kernel<DH, DK_ONLY>, p,
                                   st);
  }
}

}  // namespace

int launch(bool dq, const Params& p, int D, cudaStream_t st) {
  switch (D) {
    case 32: return launch_dh<32>(dq, p, st);
    case 64: return launch_dh<64>(dq, p, st);
    case 80: return launch_dh<80>(dq, p, st);
    case 96: return launch_dh<96>(dq, p, st);
    case 128: return launch_dh<128>(dq, p, st);
    case 192: return launch_dh<192>(dq, p, st);
    case 256: return launch_dh<256>(dq, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace flash_fma
