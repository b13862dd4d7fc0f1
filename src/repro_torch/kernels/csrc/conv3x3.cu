// The CNN conv block relu(conv3x3_same(x, w) + b) and its backward as
// implicit-GEMM FP32 kernels for sm_90a: no im2col and no col2im.
//
// Replaces the Pallas kernels of src/repro/kernels/conv3x3.py: _fwd_call
// (relu(cols @ W + b) over im2col patches) and _bwd_call (dz = dy*(y > 0),
// dcols = dz W^T, per-tile dW = cols^T dz and db = sum dz partials summed
// outside).  The TPU version builds the patches in XLA and gets dx from
// the autodiff of that construction (col2im); on Hopper the patches cost
// far more than the products: at the paper's DEFAULT train shape the
// second layer's cols is 25 x 25088 x 288 floats = 722 MB a step against
// an 80 MB input.  Here the nine taps are read from a halo of the input
// in shared memory, and dx is the same kernel run over dz with the
// flipped, transposed weights.  Layouts are the JAX package's:
// x [D, B, H, W, Cin], w [D, 3, 3, Cin, Cout], b [D, Cout],
// y [D, B, H, W, Cout]; the device axis D is the grid's z axis.
//
// What bounds it on the H100: the second layer at the DEFAULT train shape
// (D 25, 25088 pixels a device, Cin 32, Cout 64) does 2.31e10 FLOPs a
// direction for ~243 MB of operands, above the FP32 ridge (67 TFLOP/s
// over 3.35 TB/s = 20 FLOP/B): 0.345 ms forward and 0.690 ms backward at
// the FP32 rate.  The port stays in full FP32 (no TF32), so the design
// aims at keeping the FFMA pipes busy:
//
// conv3x3_fwd_kernel / conv3x3_dx_kernel (one body, conv_tile):
//   * a block of 8 warps owns 64 output channels (WM 1: each warp 8 of
//     them) or 32 (WM 2: two warps along the pixels) and walks over tiles
//     of whole image rows (32 * WM groups of TM = 7 pixels: 8 or 16 rows
//     of a 28-wide image) of one device; its slice of w stays resident in
//     shared memory, loaded once;
//   * each tile's input halo (its rows, one above and one below, one
//     zero column each side) comes into a 3-stage cp.async ring in chunks
//     of CK channels (8 at the DEFAULT widths), zero-filled outside the
//     image (the SAME pad), while the block computes on the chunk before;
//   * where a block's [9, Ck, BN] weights do not fit beside the ring (Ck
//     above about 140), the _ws kernels stream them instead: each stage
//     holds the chunk's [9, CK, BN] weights beside its halo chunk, and the
//     accumulators run on in registers across the chunks;
//   * an image row wider than 32 groups of 7 pixels is split into column
//     segments of at most 32 groups, each a tile of its own with its own
//     two halo columns (the _ws kernels too, which stream a chunk of a
//     single channel where there is one);
//   * each thread holds TM x 8 accumulators: per channel and tap row it
//     reads TM + 2 inputs once and uses them for the three column taps;
//     a warp shares its weights (broadcast float4 reads), and the halo's
//     row stride is picked so that a warp's input reads hit 32 banks;
//   * rows of another image (a tile may span two) and rows outside the
//     batch read a row of zeros instead;
//   * the forward adds the bias and applies the ReLU in the epilogue
//     (16-byte stores); the dx pass reads dz = dy * (y > 0) (both halos
//     copied, dz masked in place, never stored), with w flipped in both
//     spatial axes and transposed to [tap][Cout][Cin] as it is loaded:
//     dx[p, ci] = sum_{i,j,co} dz[p + (1 - i, 1 - j), co] w[i, j, ci, co],
//     and the zero halo drops the contributions to padded positions
//     exactly as col2im of the SAME pad does.  So dx needs neither the
//     patches nor their transpose.
//
// conv3x3_dw_kernel: dW[i, j, ci, co] = sum_p x[p + (i-1, j-1), ci] dz[p, co]
//   and db = sum_p dz[p, :].  A block of 9 warps reduces a fixed run of
//   image rows of one device into its own [9*Cin + 1, Cout] partial (the
//   last row is db: the row of ones of the TPU kernel's [cols^T; 1]
//   product), one image row a stage (x rows r-1..r+1, dy and y row r
//   through the same kind of ring).  At the DEFAULT widths a warp is one
//   tap and each thread owns 8 input x 8 output channels of it (16-byte
//   reads of x and dz); where the channels leave threads over, the
//   threads also split the row's pixels and their sums are added in
//   shared memory in a fixed order.  Where a stage of every channel of a
//   whole row does not fit (the paper's widths above 85 pixels, or wide
//   channels), conv3x3_dw_wide_kernel takes a window of the input- and
//   output-channel groups a block (blockIdx.y) and walks each row in
//   column segments, its accumulators running on across them.  The
//   partials are summed outside (torch.sum), so every result is the same
//   run to run: no atomics.
//
// Limits: none below the card's memory; any image width and channel count
// fits a block's shared memory.
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;           // threads of a fwd/dx block (8 warps)
constexpr int TM = 7;             // output pixels a thread, along a row
constexpr int TN = 8;             // output channels a thread
constexpr int NS = 3;             // stages of the cp.async rings
constexpr int DW_NT = 288;        // threads of a dW block (9 warps)
constexpr int SMEM_MAX = 232448;  // dynamic shared memory of one block

// 4-byte asynchronous copy to shared memory; ok false zero-fills it
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

// 16-byte asynchronous copy to shared memory; ok false zero-fills it
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

// The tiling of one device's flattened [B*H, W] pixel rows.
struct Tile {
  int rows, H, W;  // B*H image rows of a device, image height and width
  int seg;         // column segments a row: ceil(ceil(W / TM) / 32)
  int gpr;         // pixel groups of TM a segment: <= 32
  int rb;          // image rows a tile: 32 * WM / gpr
  int hw;          // halo columns used: gpr*TM + 2
  int cs;          // halo row stride in shared memory (floats), >= hw
  int ntiles;      // ceil(rows / rb) * seg, the segments of a row adjacent
};

// q = start, start + step, ... walked as (a, b) = (q / per, q % per)
// without a division a step
struct Walk {
  int a, b, da, db, per;
  __device__ Walk(int start, int step, int per_)
      : a(start / per_), b(start % per_), da(step / per_), db(step % per_),
        per(per_) {}
  __device__ void next() {
    a += da;
    b += db;
    if (b >= per) {
      b -= per;
      ++a;
    }
  }
};

enum { FWD = 0, DX = 1 };

// out[p, n] = sum_{i,j,k} in[p + (i-1, j-1), k] * W[i, j, k, n] over one
// device; FWD: in = x, W = w, out = y = relu(. + bias), Ck = Cin,
// Cn = Cout.  DX: in = dy masked by gate = y > 0, W = w flipped and
// transposed, out = dx, Ck = Cout, Cn = Cin.  WS (the wide variant): the
// weights come with each stage (a chunk's [9][CK][BN] ahead of its halo)
// instead of staying resident, and a row may be cut into column segments
// (g.seg > 1); without it the tiles are whole rows.
template <int MODE, int CK, int WM, bool WS>
__device__ __forceinline__ void conv_tile(
    const float* __restrict__ in, const float* __restrict__ gate,
    const float* __restrict__ w, const float* __restrict__ bias,
    float* __restrict__ out, int Ck, int Cn, const Tile g) {
  constexpr int WN = 8 / WM, BN = WN * TN;
  constexpr int WF = WS ? 9 * CK * BN : 0;  // a stage's weights (floats)
  extern __shared__ float4 smem4[];
  const int ckp = (Ck + CK - 1) / CK * CK;
  float* ws = reinterpret_cast<float*>(smem4);        // [9][ckp][BN]
  float* zrow = ws + (WS ? 0 : 9 * ckp * BN);          // cs zeros
  float* ring = zrow + (WS ? (g.cs + 3) / 4 * 4 : g.cs);  // NS stages
  const int half = CK * (g.rb + 2) * g.cs;  // one halo [CK][rb+2][cs]
  // floats a stage (WS: 16-byte aligned, for the weights' float4 reads)
  const int sf = WS ? (WF + (MODE == DX ? 2 : 1) * half + 3) / 4 * 4
                    : (MODE == DX ? 2 * half : half);

  const int tid = threadIdx.x, wn = (tid >> 5) % WN;
  const int d = blockIdx.z, co0 = blockIdx.y * BN;
  const size_t plane = (size_t)g.rows * g.W;
  const float* in_d = in + (size_t)d * plane * Ck;
  const float* gate_d = gate + (MODE == DX ? (size_t)d * plane * Ck : 0);
  const float* w_d = w + (size_t)d * 9 * Ck * Cn;
  float* out_d = out + (size_t)d * plane * Cn;

  // the block's weights, zero beyond Ck and Cn, read along their
  // contiguous global axis
  for (int e = tid; e < (WS ? 0 : 9 * ckp * BN); e += NT) {
    int tap, k, n;
    if (MODE == FWD) {
      n = e % BN;
      k = (e / BN) % ckp;
      tap = e / (BN * ckp);
    } else {
      k = e % ckp;
      n = (e / ckp) % BN;
      tap = e / (ckp * BN);
    }
    float v = 0.f;
    if (k < Ck && co0 + n < Cn)
      v = MODE == FWD ? w_d[((size_t)tap * Ck + k) * Cn + co0 + n]
                      : w_d[((size_t)(8 - tap) * Cn + co0 + n) * Ck + k];
    ws[(tap * ckp + k) * BN + n] = v;
  }
  for (int e = tid; e < g.cs; e += NT) zrow[e] = 0.f;

  const int nchunk = ckp / CK;
  const int bx = blockIdx.x, gx = gridDim.x;
  const int my_tiles = bx < g.ntiles ? (g.ntiles - 1 - bx) / gx + 1 : 0;
  const int steps = my_tiles * nchunk;  // (tile, channel chunk) pairs
  const int kk = tid % CK;              // the halo channel this thread copies

  // tile t: image rows from (t / seg) * rb, columns from c0
  auto tile_at = [&](int t, int& r0, int& c0) {
    if constexpr (WS) {
      const int rt = t / g.seg;
      r0 = rt * g.rb;
      c0 = (t - rt * g.seg) * g.gpr * TM;
    } else {
      r0 = t * g.rb;
      c0 = 0;
    }
  };
  // step s: channel chunk s % nchunk of tile bx + (s / nchunk) * gx; the
  // thread copies halo elements tid / CK, + NT / CK, ... of channel kk
  auto prefetch = [&](int s) {
    if (s < steps) {
      const int chunk = s % nchunk;
      const int k = chunk * CK + kk;
      int r0, c0;
      tile_at(bx + (s / nchunk) * gx, r0, c0);
      --r0;
      float* stage = ring + (s % NS) * sf;
      float* buf = stage + WF + kk * (g.rb + 2) * g.cs;
      for (Walk q(tid / CK, NT / CK, g.hw); q.a < g.rb + 2; q.next()) {
        const int r = r0 + q.a, c = c0 + q.b - 1;
        const bool ok = k < Ck && r >= 0 && r < g.rows && c >= 0 && c < g.W;
        const size_t off = ok ? ((size_t)r * g.W + c) * Ck + k : 0;
        cp_async4(buf + q.a * g.cs + q.b, in_d + off, ok);
        if constexpr (MODE == DX)
          cp_async4(buf + half + q.a * g.cs + q.b, gate_d + off, ok);
      }
      if constexpr (WS) {  // the chunk's weights, as the resident ones
        for (int e = tid; e < WF; e += NT) {
          int tap, kc, n;
          if (MODE == FWD) {
            n = e % BN;
            kc = (e / BN) % CK;
            tap = e / (BN * CK);
          } else {
            kc = e % CK;
            n = (e / CK) % BN;
            tap = e / (CK * BN);
          }
          const int kg = chunk * CK + kc;
          const bool ok = kg < Ck && co0 + n < Cn;
          const size_t off =
              !ok ? 0
                  : MODE == FWD ? ((size_t)tap * Ck + kg) * Cn + co0 + n
                                : ((size_t)(8 - tap) * Cn + co0 + n) * Ck + kg;
          cp_async4(stage + (tap * CK + kc) * BN + n, w_d + off, ok);
        }
      }
    }
    cp_async_commit();
  };
  // dz = dy * (y > 0) on the elements this thread copied (its own copies
  // are complete after the wait)
  auto mask = [&](int s) {
    float* buf = ring + (s % NS) * sf + WF + kk * (g.rb + 2) * g.cs;
    for (Walk q(tid / CK, NT / CK, g.hw); q.a < g.rb + 2; q.next()) {
      float* z = buf + q.a * g.cs + q.b;
      if (!(z[half] > 0.f)) z[0] = 0.f;
    }
  };

  // this thread: pixels lg*TM .. lg*TM + TM - 1 of the tile's row lr,
  // output channels co0 + wn*TN .. + TN - 1
  const int pg = (tid >> 5) / WN * 32 + (tid & 31);
  const int lr = pg / g.gpr, lg = pg - lr * g.gpr;
  const bool active = lr < g.rb;
  const int cob = co0 + wn * TN;
  float bv[TN];
#pragma unroll
  for (int n = 0; n < TN; ++n)
    bv[n] = MODE == FWD && cob + n < Cn ? bias[(size_t)d * Cn + cob + n] : 0.f;

#pragma unroll
  for (int s = 0; s < NS - 1; ++s) prefetch(s);
  float acc[TM][TN];
  for (int s = 0; s < steps; ++s) {
    prefetch(s + NS - 1);
    cp_async_wait<NS - 1>();
    if constexpr (MODE == DX) mask(s);
    __syncthreads();
    const int chunk = s % nchunk;
    int row, c0;
    tile_at(bx + (s / nchunk) * gx, row, c0);
    row += lr;
    const int h = row % g.H;
    const bool live = active && row < g.rows;
    if (chunk == 0) {
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int n = 0; n < TN; ++n) acc[m][n] = 0.f;
    }
    // the three tap rows of this thread's pixels, a row of zeros where the
    // tap falls outside the image; kst steps to the next channel
    const float* xrow[3];
    int kst[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const bool ok = live && h + i >= 1 && h + i <= g.H;
      xrow[i] = ok ? ring + (s % NS) * sf + WF + (lr + i) * g.cs + lg * TM
                   : zrow;
      kst[i] = ok ? (g.rb + 2) * g.cs : 0;
    }
#pragma unroll
    for (int k = 0; k < CK; ++k) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float* xr = xrow[i] + k * kst[i];
        float a[TM + 2];
#pragma unroll
        for (int q = 0; q < TM + 2; ++q) a[q] = xr[q];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float4* wr = reinterpret_cast<const float4*>(
              WS ? ring + (s % NS) * sf + ((i * 3 + j) * CK + k) * BN +
                       wn * TN
                 : ws + ((i * 3 + j) * ckp + chunk * CK + k) * BN + wn * TN);
          float wv[TN];
#pragma unroll
          for (int v = 0; v < TN / 4; ++v) {
            const float4 f = wr[v];
            wv[4 * v] = f.x;
            wv[4 * v + 1] = f.y;
            wv[4 * v + 2] = f.z;
            wv[4 * v + 3] = f.w;
          }
#pragma unroll
          for (int n = 0; n < TN; ++n)
#pragma unroll
            for (int m = 0; m < TM; ++m)
              acc[m][n] = fmaf(a[m + j], wv[n], acc[m][n]);
        }
      }
    }
    if (chunk == nchunk - 1 && live) {
      float* orow = out_d + (size_t)row * g.W * Cn + cob;
      const bool vec = Cn % 4 == 0 && cob + TN <= Cn;
#pragma unroll
      for (int m = 0; m < TM; ++m) {
        const int c = c0 + lg * TM + m;
        if (c < g.W) {
          float o[TN];
#pragma unroll
          for (int n = 0; n < TN; ++n)
            o[n] = MODE == FWD ? fmaxf(acc[m][n] + bv[n], 0.f) : acc[m][n];
          float* dst = orow + (size_t)c * Cn;
          if (vec) {
#pragma unroll
            for (int v = 0; v < TN / 4; ++v)
              reinterpret_cast<float4*>(dst)[v] = make_float4(
                  o[4 * v], o[4 * v + 1], o[4 * v + 2], o[4 * v + 3]);
          } else {
#pragma unroll
            for (int n = 0; n < TN; ++n)
              if (cob + n < Cn) dst[n] = o[n];
          }
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
}

template <int CK, int WM>
__global__ void __launch_bounds__(NT, 2)
    conv3x3_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                       const float* __restrict__ b, float* __restrict__ y,
                       int Cin, int Cout, Tile g) {
  conv_tile<FWD, CK, WM, false>(x, nullptr, w, b, y, Cin, Cout, g);
}

template <int CK, int WM>
__global__ void __launch_bounds__(NT, 2)
    conv3x3_dx_kernel(const float* __restrict__ dy, const float* __restrict__ y,
                      const float* __restrict__ w, float* __restrict__ dx,
                      int Cin, int Cout, Tile g) {
  conv_tile<DX, CK, WM, false>(dy, y, w, nullptr, dx, Cout, Cin, g);
}

// the same two, wide: the weights streamed a chunk a stage, rows in column
// segments (for weights too wide to stay resident, or rows past 224)
template <int CK, int WM>
__global__ void __launch_bounds__(NT, 2)
    conv3x3_fwd_ws_kernel(const float* __restrict__ x,
                          const float* __restrict__ w,
                          const float* __restrict__ b, float* __restrict__ y,
                          int Cin, int Cout, Tile g) {
  conv_tile<FWD, CK, WM, true>(x, nullptr, w, b, y, Cin, Cout, g);
}

template <int CK, int WM>
__global__ void __launch_bounds__(NT, 2)
    conv3x3_dx_ws_kernel(const float* __restrict__ dy,
                         const float* __restrict__ y,
                         const float* __restrict__ w, float* __restrict__ dx,
                         int Cin, int Cout, Tile g) {
  conv_tile<DX, CK, WM, true>(dy, y, w, nullptr, dx, Cout, Cin, g);
}

// A dW block's share of the channels and columns: the input-channel groups
// [gi0, gi0 + nwi) and output-channel groups [go0, go0 + nwo) of window
// blockIdx.y / spw (windows numbered output-fastest, wo along the output
// groups), the window's groups over spw blocks of GB, and each image row
// in seg column segments of wc pixels (the last may be narrower).  One
// window and one segment where a stage of every channel of a whole row
// fits.
struct DwPlan {
  int nwi, nwo;  // groups of a window: input (TCI channels), output (8)
  int wo;        // windows along the output-channel groups
  int spw, GB;   // blocks a window, groups a block
  int wc, seg;   // pixels of a column segment, segments a row
};

// dW/db partials: block (t, y, d) reduces image rows [t*rpp, (t+1)*rpp)
// of device d into part[d, t] = [9*Cin + 1, Cout], for the thread groups
// [s*GB, s*GB + GB) of its window (y = window * spw + s).  A group is one
// tap x TCI input x 8 output channels (4*go .. +3 and 4*(ngo + go) .. +3,
// so that neighbouring lanes read neighbouring 16-byte words of dz),
// numbered output channels fastest, then input, then tap (a warp shares
// its tap and reads few distinct inputs).  When the groups do not fill
// the block, its DW_NT / GB slices split each segment's pixels.  WIDE
// (conv3x3_dw_wide_kernel): the plan's windows and segments; without it
// (conv3x3_dw_kernel) one window of every channel and whole rows.
template <int TCI, bool WIDE>
__device__ __forceinline__ void dw_body(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ dy, float* __restrict__ part, int rows, int H,
    int W, int Cin, int Cout, int rpp, int nparts, const DwPlan& p) {
  constexpr int ACC = TCI * 8 + 8;  // dW accumulators, then db's
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  const int ngi = (Cin + TCI - 1) / TCI, ngo = (Cout + 7) / 8;
  // the window's groups and a segment's pixels: without WIDE every group
  // and the whole row
  const int nwi = WIDE ? p.nwi : ngi, nwo = WIDE ? p.nwo : ngo;
  const int wc = WIDE ? p.wc : W;
  const int cip = TCI * nwi, cop = 8 * nwo;  // a window's channel strides
  // a stage: x rows r-1..r+1 [3][wc+2][cip] | dz row [wc][cop] | y row
  const int xf = (3 * (wc + 2) * cip + 3) / 4 * 4, zf = wc * cop;
  const int sf = xf + 2 * zf;
  const int tid = threadIdx.x, d = blockIdx.z, t = blockIdx.x;
  const int win = WIDE ? blockIdx.y / p.spw : 0;
  const int sl = WIDE ? blockIdx.y - win * p.spw : blockIdx.y;
  const int gi0 = WIDE ? win / p.wo * nwi : 0;
  const int go0 = WIDE ? win % p.wo * nwo : 0;
  const int nps = DW_NT / p.GB, slot = tid % p.GB, ps = tid / p.GB;
  const int G = 9 * nwi * nwo, gidx = sl * p.GB + slot;
  const int lgo = gidx % nwo, lgi = gidx / nwo % nwi;
  const int tap = gidx / (nwo * nwi);
  const bool act = ps < nps && gidx < G &&
                   (!WIDE || (gi0 + lgi < ngi && go0 + lgo < ngo));
  const int ti = tap / 3, tj = tap - 3 * ti;
  const int cpp = (wc + nps - 1) / nps;  // pixels of a segment per slice
  const int r_lo = t * rpp, nrow = min(rpp, rows - r_lo);
  const int steps = WIDE ? nrow * p.seg : nrow;  // (row, segment) stages
  const size_t plane = (size_t)rows * W;
  const float* x_d = x + (size_t)d * plane * Cin;
  const float* y_d = y + (size_t)d * plane * Cout;
  const float* dy_d = dy + (size_t)d * plane * Cout;
  const bool xvec = Cin % 4 == 0, zvec = Cout % 4 == 0;
  const int ci0 = gi0 * TCI, ncx = min(cip, Cin - ci0);  // x channels copied

  // the pad channels are never copied: zero them once
  for (int e = tid; e < NS * sf; e += DW_NT) ring[e] = 0.f;
  __syncthreads();

  // copy units of a pixel: 16 bytes where the channels allow, else 4; the
  // dz and y units: the window's two halves of output channels (4*go0 ..
  // 4*(go0 + nwo) - 1, and the same 4*ngo on), zero-filled out of range
  const int xu = WIDE ? (xvec ? ncx / 4 : ncx) : (xvec ? Cin / 4 : Cin);
  const int zu = WIDE ? (zvec ? 2 * nwo : cop) : (zvec ? Cout / 4 : Cout);
  auto zchan = [&](int u, bool& ok) {  // unit u's first global channel
    const int c = zvec ? 4 * u : u, hn = 4 * nwo;
    const int lo = c < hn ? c : c - hn;  // its channel within its half
    const int gc = c < hn ? 4 * go0 + lo : 4 * (ngo + go0) + lo;
    ok = gc < Cout && go0 + lo / 4 < ngo;
    return gc;
  };
  // stage s: row r_lo + rs, segment sg (s = rs * seg + sg)
  auto prefetch = [&](int s, int rs, int sg) {
    if (s < steps) {
      const int r = r_lo + rs;
      float* xs = ring + (s % NS) * sf;
      float* zs = xs + xf;
      float* ys = zs + zf;
      if constexpr (!WIDE) {
        // x rows r-1..r+1 lie one after another in global memory; the pad
        // columns are never copied
        for (Walk q(tid, DW_NT, xu); q.a < 3 * W; q.next()) {
          const int hr = q.a >= 2 * W ? 2 : (q.a >= W ? 1 : 0);
          const bool ok = r - 1 + hr >= 0 && r - 1 + hr < rows;
          const float* src =
              x_d + (ok ? ((size_t)(r - 1) * W + q.a) * Cin : 0);
          float* dst = xs + (q.a + 2 * hr + 1) * cip;
          if (xvec)
            cp_async16(dst + 4 * q.b, src + 4 * q.b, ok);
          else
            cp_async4(dst + q.b, src + q.b, ok);
        }
        for (Walk q(tid, DW_NT, zu); q.a < W; q.next()) {
          const size_t o = ((size_t)r * W + q.a) * Cout;
          const int so = q.a * cop;
          if (zvec) {
            cp_async16(zs + so + 4 * q.b, dy_d + o + 4 * q.b, true);
            cp_async16(ys + so + 4 * q.b, y_d + o + 4 * q.b, true);
          } else {
            cp_async4(zs + so + q.b, dy_d + o + q.b, true);
            cp_async4(ys + so + q.b, y_d + o + q.b, true);
          }
        }
      } else {
        const int c0 = sg * wc, wcs = min(wc, W - c0), pw = wcs + 2;
        // x rows r-1..r+1, columns c0-1 .. c0+wcs (zeros outside the image)
        for (Walk q(tid, DW_NT, xu); q.a < 3 * pw; q.next()) {
          const int hr = q.a >= 2 * pw ? 2 : (q.a >= pw ? 1 : 0);
          const int col = q.a - hr * pw, gr = r - 1 + hr, gc = c0 + col - 1;
          const bool ok = gr >= 0 && gr < rows && gc >= 0 && gc < W;
          const float* src =
              x_d + (ok ? ((size_t)gr * W + gc) * Cin + ci0 : 0);
          float* dst = xs + (hr * (wc + 2) + col) * cip;
          if (xvec)
            cp_async16(dst + 4 * q.b, src + 4 * q.b, ok);
          else
            cp_async4(dst + q.b, src + q.b, ok);
        }
        for (Walk q(tid, DW_NT, zu); q.a < wcs; q.next()) {
          bool ok;
          const int gc = zchan(q.b, ok);
          const size_t o = ok ? ((size_t)r * W + c0 + q.a) * Cout + gc : 0;
          const int so = q.a * cop + (zvec ? 4 * q.b : q.b);
          if (zvec) {
            cp_async16(zs + so, dy_d + o, ok);
            cp_async16(ys + so, y_d + o, ok);
          } else {
            cp_async4(zs + so, dy_d + o, ok);
            cp_async4(ys + so, y_d + o, ok);
          }
        }
      }
    }
    cp_async_commit();
  };
  // dz = dy * (y > 0) on the elements this thread copied
  auto mask = [&](int s, int wcs) {
    float* zs = ring + (s % NS) * sf + xf;
    const float* ys = zs + zf;
    for (Walk q(tid, DW_NT, zu); q.a < wcs; q.next()) {
      if (zvec) {
        const int o = q.a * cop + 4 * q.b;
        float4 z = *reinterpret_cast<float4*>(zs + o);
        const float4 yv = *reinterpret_cast<const float4*>(ys + o);
        z.x = yv.x > 0.f ? z.x : 0.f;
        z.y = yv.y > 0.f ? z.y : 0.f;
        z.z = yv.z > 0.f ? z.z : 0.f;
        z.w = yv.w > 0.f ? z.w : 0.f;
        *reinterpret_cast<float4*>(zs + o) = z;
      } else {
        const int o = q.a * cop + q.b;
        if (!(ys[o] > 0.f)) zs[o] = 0.f;
      }
    }
  };

  float acc[ACC];
#pragma unroll
  for (int v = 0; v < ACC; ++v) acc[v] = 0.f;

  // stage s's taps over the pixels [c_lo, c_hi) of its row's segment
  auto accumulate = [&](int s, int h, int c_lo, int c_hi) {
    // a tap row outside the image adds nothing
    if (h + ti >= 1 && h + ti <= H) {
      const float* xp = ring + (s % NS) * sf +
                        (ti * (wc + 2) + tj + c_lo) * cip + lgi * TCI;
      const float* zp = ring + (s % NS) * sf + xf + c_lo * cop + 4 * lgo;
      for (int c = c_lo; c < c_hi; ++c, xp += cip, zp += cop) {
        float xv[TCI], zv[8];
        if constexpr (TCI == 8) {
          const float4 a0 = *reinterpret_cast<const float4*>(xp);
          const float4 a1 = *reinterpret_cast<const float4*>(xp + 4);
          xv[0] = a0.x; xv[1] = a0.y; xv[2] = a0.z; xv[3] = a0.w;
          xv[4] = a1.x; xv[5] = a1.y; xv[6] = a1.z; xv[7] = a1.w;
        } else {
          xv[0] = xp[0];
        }
        const float4 z0 = *reinterpret_cast<const float4*>(zp);
        const float4 z1 = *reinterpret_cast<const float4*>(zp + 4 * nwo);
        zv[0] = z0.x; zv[1] = z0.y; zv[2] = z0.z; zv[3] = z0.w;
        zv[4] = z1.x; zv[5] = z1.y; zv[6] = z1.z; zv[7] = z1.w;
#pragma unroll
        for (int u = 0; u < TCI; ++u)
#pragma unroll
          for (int n = 0; n < 8; ++n)
            acc[u * 8 + n] = fmaf(xv[u], zv[n], acc[u * 8 + n]);
        if (tap == 4) {  // the centre tap sees every pixel: db's row of ones
#pragma unroll
          for (int n = 0; n < 8; ++n) acc[TCI * 8 + n] += zv[n];
        }
      }
    }
  };
  if constexpr (!WIDE) {  // a stage a row, the slice's pixels fixed
    const int c_lo = act ? min(W, ps * cpp) : W, c_hi = min(W, c_lo + cpp);
#pragma unroll
    for (int s = 0; s < NS - 1; ++s) prefetch(s, s, 0);
    for (int s = 0; s < nrow; ++s) {
      prefetch(s + NS - 1, s + NS - 1, 0);
      cp_async_wait<NS - 1>();
      mask(s, W);
      __syncthreads();
      accumulate(s, (r_lo + s) % H, c_lo, c_hi);
      __syncthreads();
    }
  } else {  // a stage a (row, segment)
    Walk pf(0, 1, p.seg), st(0, 1, p.seg);
#pragma unroll
    for (int s = 0; s < NS - 1; ++s, pf.next()) prefetch(s, pf.a, pf.b);
    for (int s = 0; s < steps; ++s, st.next()) {
      prefetch(s + NS - 1, pf.a, pf.b);
      pf.next();
      const int wcs = min(wc, W - st.b * wc);
      cp_async_wait<NS - 1>();
      mask(s, wcs);
      __syncthreads();
      const int c_lo = act ? min(wcs, ps * cpp) : wcs;
      accumulate(s, (r_lo + st.a) % H, c_lo, min(wcs, c_lo + cpp));
      __syncthreads();
    }
  }
  cp_async_wait<0>();

  // part row of accumulator v of the window's group gid; -1 where it has
  // none
  auto row_of = [&](int gid, int v, int& col) {
    const int o = go0 + gid % nwo, i = gi0 + gid / nwo % nwi;
    const int tp = gid / (nwo * nwi);
    if (o >= ngo || i >= ngi) return -1;
    const int n = v % 8;
    col = n < 4 ? 4 * o + n : 4 * (ngo + o) + n - 4;
    if (v < TCI * 8) {
      const int ci = i * TCI + v / 8;
      return ci < Cin && col < Cout ? tp * Cin + ci : -1;
    }
    return tp == 4 && i == 0 && col < Cout ? 9 * Cin : -1;
  };
  float* pd = part + ((size_t)d * nparts + t) * (9 * Cin + 1) * Cout;
  if (nps == 1) {
    if (!act) return;
#pragma unroll
    for (int v = 0; v < ACC; ++v) {
      int col;
      const int r = row_of(gidx, v, col);
      if (r >= 0) pd[(size_t)r * Cout + col] = acc[v];
    }
    return;
  }
  // add the pixel slices' sums in a fixed order, slice 0 first
  float* red = ring;
#pragma unroll
  for (int v = 0; v < ACC; ++v) red[tid * ACC + v] = acc[v];
  __syncthreads();
  for (int e = tid; e < p.GB * ACC; e += DW_NT) {
    const int g2 = e / ACC, v = e - g2 * ACC;
    if (sl * p.GB + g2 >= G) continue;
    float sum = 0.f;
    for (int q = 0; q < nps; ++q) sum += red[(q * p.GB + g2) * ACC + v];
    int col;
    const int r = row_of(sl * p.GB + g2, v, col);
    if (r >= 0) pd[(size_t)r * Cout + col] = sum;
  }
}

template <int TCI>
__global__ void __launch_bounds__(DW_NT, 2)
    conv3x3_dw_kernel(const float* __restrict__ x, const float* __restrict__ y,
                      const float* __restrict__ dy, float* __restrict__ part,
                      int rows, int H, int W, int Cin, int Cout, int rpp,
                      int nparts, DwPlan p) {
  dw_body<TCI, false>(x, y, dy, part, rows, H, W, Cin, Cout, rpp, nparts, p);
}

template <int TCI>
__global__ void __launch_bounds__(DW_NT, 2)
    conv3x3_dw_wide_kernel(const float* __restrict__ x,
                           const float* __restrict__ y,
                           const float* __restrict__ dy,
                           float* __restrict__ part, int rows, int H, int W,
                           int Cin, int Cout, int rpp, int nparts,
                           DwPlan p) {
  dw_body<TCI, true>(x, y, dy, part, rows, H, W, Cin, Cout, rpp, nparts, p);
}

// ---------------------------------------------------------------- host side

// The halo row stride: at least hw, and such that a warp's first reads
// (lane -> row lane / gpr, column (lane % gpr) * TM) fall into as few
// lanes a bank as can be.
int pick_cs(int gpr, int hw) {
  int best = hw, best_deg = 33;
  const int lanes = 32 / gpr * gpr;
  for (int cs = hw; cs < hw + 32; ++cs) {
    int cnt[32] = {0}, deg = 0;
    for (int lane = 0; lane < lanes; ++lane) {
      const int bank = ((lane / gpr) * cs + (lane % gpr) * TM) % 32;
      deg = ++cnt[bank] > deg ? cnt[bank] : deg;
    }
    if (deg < best_deg) {
      best_deg = deg;
      best = cs;
    }
  }
  return best;
}

Tile make_tile(int rows, int H, int W, int wm) {
  Tile g;
  g.rows = rows;
  g.H = H;
  g.W = W;
  const int groups = (W + TM - 1) / TM;
  g.seg = (groups + 31) / 32;
  g.gpr = (groups + g.seg - 1) / g.seg;
  g.rb = 32 * wm / g.gpr;
  g.hw = g.gpr * TM + 2;
  g.cs = pick_cs(g.gpr, g.hw);
  g.ntiles = (rows + g.rb - 1) / g.rb * g.seg;
  return g;
}

// dynamic shared memory of a conv_tile block (ws: the streamed weights)
size_t tile_smem(int mode, int CK, int wm, int Ck, const Tile& g, bool ws) {
  const size_t bn = (8 / wm) * TN;
  const size_t half = (size_t)CK * (g.rb + 2) * g.cs;
  const size_t halos = half * (mode == DX ? 2 : 1);
  if (ws)
    return 4 * ((g.cs + 3) / 4 * 4 + NS * ((9 * CK * bn + halos + 3) / 4 * 4));
  const size_t ckp = (Ck + CK - 1) / CK * CK;
  return 4 * (9 * ckp * bn + g.cs + NS * halos);
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// Launch a conv_tile kernel: as many blocks a device and channel slice as
// the card holds at once at its occupancy (at least one), each walking
// over its share of the device's tiles.
template <typename... P, typename... A>
int launch_tile(void (*kernel)(P...), size_t smem, int D, int Cn, int BN,
                const Tile& g, cudaStream_t st, A... args) {
  if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidConfiguration;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  const int ny = (Cn + BN - 1) / BN;
  const int slots = (per_sm > 0 ? per_sm : 1) * sm_count();
  int nx = slots / (D * ny);
  nx = nx < 1 ? 1 : (nx > g.ntiles ? g.ntiles : nx);
  dim3 grid(nx, ny, D);
  kernel<<<grid, NT, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

// The forward (MODE FWD) or dx (DX) pass: Ck channels in, Cn out.  A block
// takes 64 output channels (WM 1) where more than 32 are wanted and its
// weights fit, else 32 (WM 2: two warps along the pixels).  The halo
// chunk: CK 1 for a single input channel; 8 where the channels come in
// eights and the ring fits (half the barriers of 4: the DEFAULT second
// layer's forward and dx, the latter at one block an SM); else 4.  Rows
// wider than 224 pixels, and weights of which not even 32 output
// channels' fit, take the wide kernels (WS): weights streamed in chunks
// of 8 channels (1 for a single one) beside each column segment's halo,
// which fit at any width.
template <int MODE, int CK, int WM, bool WS>
int tile_run(const float* in, const float* gate, const float* w,
             const float* b, float* out, int D, int rows, int H, int W,
             int Cin, int Cout, cudaStream_t st) {
  const int Ck = MODE == FWD ? Cin : Cout, Cn = MODE == FWD ? Cout : Cin;
  const Tile g = make_tile(rows, H, W, WM);
  const size_t smem = tile_smem(MODE, CK, WM, Ck, g, WS);
  constexpr int BN = 8 / WM * TN;
  if constexpr (WS) {
    if (MODE == FWD)
      return launch_tile(conv3x3_fwd_ws_kernel<CK, WM>, smem, D, Cn, BN, g,
                         st, in, w, b, out, Cin, Cout, g);
    return launch_tile(conv3x3_dx_ws_kernel<CK, WM>, smem, D, Cn, BN, g, st,
                       in, gate, w, out, Cin, Cout, g);
  }
  if (MODE == FWD)
    return launch_tile(conv3x3_fwd_kernel<CK, WM>, smem, D, Cn, BN, g, st,
                       in, w, b, out, Cin, Cout, g);
  return launch_tile(conv3x3_dx_kernel<CK, WM>, smem, D, Cn, BN, g, st, in,
                     gate, w, out, Cin, Cout, g);
}

template <int MODE>
int tile_pass(const float* in, const float* gate, const float* w,
              const float* b, float* out, int D, int rows, int H, int W,
              int Cin, int Cout, cudaStream_t st) {
  const int Ck = MODE == FWD ? Cin : Cout, Cn = MODE == FWD ? Cout : Cin;
  const Tile g1 = make_tile(rows, H, W, 1), g2 = make_tile(rows, H, W, 2);
  auto fits = [&](int ck, int wm) {
    return tile_smem(MODE, ck, wm, Ck, wm == 1 ? g1 : g2, false) <=
           (size_t)SMEM_MAX;
  };
#define RUN(CK, WM, WS)                                                    \
  tile_run<MODE, CK, WM, WS>(in, gate, w, b, out, D, rows, H, W, Cin, Cout, \
                             st)
  if (g1.seg > 1) {
    if (Ck == 1) return Cn > 32 ? RUN(1, 1, true) : RUN(1, 2, true);
    return Cn > 32 ? RUN(8, 1, true) : RUN(8, 2, true);
  }
  if (Ck == 1) return Cn > 32 && fits(1, 1) ? RUN(1, 1, false)
                                            : RUN(1, 2, false);
  if (Cn > 32 && fits(4, 1))
    return Ck % 8 == 0 && fits(8, 1) ? RUN(8, 1, false) : RUN(4, 1, false);
  if (fits(4, 2))
    return Ck % 8 == 0 && fits(8, 2) ? RUN(8, 2, false) : RUN(4, 2, false);
  return Cn > 32 ? RUN(8, 1, true) : RUN(8, 2, true);
#undef RUN
}

// The dW pass's plan: every channel of a whole row a stage where NS such
// stages fit; else windows of the channel groups, halved (the wider side
// first) until a segment of min(W, 32) columns fits, and each row in the
// fewest equal segments that fit.
template <int TCI>
DwPlan dw_plan(int W, int Cin, int Cout) {
  const int ngi = (Cin + TCI - 1) / TCI, ngo = (Cout + 7) / 8;
  DwPlan p;
  p.nwi = ngi;
  p.nwo = ngo;
  auto stage = [&](long long wc) {  // bytes of the NS stages
    return 4LL * NS *
           ((3 * (wc + 2) * TCI * p.nwi + 3) / 4 * 4 + 2 * wc * 8 * p.nwo);
  };
  auto widest = [&]() {  // the widest segment that fits, at most W
    long long wc = W;
    while (wc > 1 && stage(wc) > SMEM_MAX) {
      const long long per = 4LL * NS * (3 * TCI * p.nwi + 16 * p.nwo);
      const long long over = (stage(wc) - SMEM_MAX + per - 1) / per;
      wc = wc - over > 1 ? wc - over : 1;
    }
    return (int)wc;
  };
  const int want = W < 32 ? W : 32;
  while (widest() < want) {
    if (TCI == 8 && p.nwi > 1 && TCI * p.nwi >= 8 * p.nwo)
      p.nwi = (p.nwi + 1) / 2;
    else if (p.nwo > 1)
      p.nwo = (p.nwo + 1) / 2;
    else if (TCI == 8 && p.nwi > 1)
      p.nwi = (p.nwi + 1) / 2;
    else
      break;
  }
  const int wc = widest();
  p.seg = (W + wc - 1) / wc;
  p.wc = (W + p.seg - 1) / p.seg;
  p.wo = (ngo + p.nwo - 1) / p.nwo;
  const int G = 9 * p.nwi * p.nwo;
  p.GB = G < DW_NT ? G : DW_NT;
  p.spw = (G + p.GB - 1) / p.GB;
  return p;
}

template <int TCI>
int dw_run(const float* x, const float* y, const float* dy, float* part,
           int D, int rows, int H, int W, int Cin, int Cout, int rpp,
           cudaStream_t st) {
  const DwPlan p = dw_plan<TCI>(W, Cin, Cout);
  const int ngi = (Cin + TCI - 1) / TCI;
  const size_t xf = (3 * (size_t)(p.wc + 2) * TCI * p.nwi + 3) / 4 * 4;
  size_t smem = 4 * NS * (xf + 2 * (size_t)p.wc * 8 * p.nwo);
  const size_t red = 4 * (size_t)DW_NT * (TCI * 8 + 8);
  if (DW_NT / p.GB > 1 && smem < red) smem = red;
  if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidConfiguration;
  const bool wide = p.seg > 1 || p.nwi < ngi || p.wo > 1;
  auto kernel = wide ? conv3x3_dw_wide_kernel<TCI> : conv3x3_dw_kernel<TCI>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int nparts = (rows + rpp - 1) / rpp;
  const int windows = (ngi + p.nwi - 1) / p.nwi * p.wo;
  dim3 grid(nparts, windows * p.spw, D);
  kernel<<<grid, DW_NT, smem, st>>>(x, y, dy, part, rows, H, W, Cin, Cout,
                                    rpp, nparts, p);
  return (int)cudaGetLastError();
}

}  // namespace

// y = relu(conv3x3_same(x, w) + b) for each of D devices; x [D, rows, W,
// Cin] with rows = B*H image rows of height H.  Returns a cudaError_t.
extern "C" int conv3x3_fwd_launch(const float* x, const float* w,
                                  const float* b, float* y, int D, int rows,
                                  int H, int W, int Cin, int Cout,
                                  void* stream) {
  return tile_pass<FWD>(x, nullptr, w, b, y, D, rows, H, W, Cin, Cout,
                        (cudaStream_t)stream);
}

// dx (skipped when dx is null) and the [D, nparts, 9*Cin + 1, Cout]
// partials of dW (rows tap*Cin + ci) and db (the last row), nparts =
// ceil(rows / rpp), from x, w, the forward's y and dy.  Returns a
// cudaError_t.
extern "C" int conv3x3_bwd_launch(const float* x, const float* w,
                                  const float* y, const float* dy, float* dx,
                                  float* dw_part, int D, int rows, int H,
                                  int W, int Cin, int Cout, int rpp,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dx != nullptr) {
    const int rc = tile_pass<DX>(dy, y, w, nullptr, dx, D, rows, H, W, Cin,
                                 Cout, st);
    if (rc != 0) return rc;
  }
  return Cin % 8 == 0 || Cin > 8
             ? dw_run<8>(x, y, dy, dw_part, D, rows, H, W, Cin, Cout, rpp, st)
             : dw_run<1>(x, y, dy, dw_part, D, rows, H, W, Cin, Cout, rpp,
                         st);
}
