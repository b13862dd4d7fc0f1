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
constexpr int DW2_NT = 192;       // of a conv3x3_dw_wide_kernel block
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

// conv3x3_dx_wide_kernel: dx where a block's weights cannot stay resident
// and dx has more than 64 channels (the S2 geometry's 256 -> 128).  The
// pass is conv_tile's DX pass with the weights streamed a chunk of CK dz
// channels a stage beside the chunk's dz and y halos, with three changes
// for its FMA rate:
//   * a thread computes DXM = 14 pixels (two groups of TM side by side) x
//     DXN = 8 dx channels: per channel and tap row it reads 16 inputs and
//     24 weights for 336 FMAs (conv_tile: 9 and 24 for 168), so that its
//     shared-memory reads, which bound conv_tile's loop, fall by 40% a
//     FMA; a block of 8 warps covers 32 groups x 64 channels (255
//     registers, none spilled);
//   * one barrier a stage: the next copy is issued after it, into the
//     slot of the stage before;
//   * one block an SM over all the units: the blocks walk the D x ny x
//     ntiles (device, channel slice, tile) units in turn, so every SM gets
//     the same share (conv_tile's grid gives a device's tiles to whole
//     blocks, 100 of them on 132 SMs at S2).
// The sums run in conv_tile's order (dz channel, tap row, tap column), so
// dx is the same bits as conv_tile's on the same shape.
constexpr int DXM = 2 * TM, DXN = TN, DXT = NT;  // the tile, the threads

template <int CK>
__device__ __forceinline__ void dx_wide_body(
    const float* __restrict__ dy, const float* __restrict__ y,
    const float* __restrict__ w, float* __restrict__ dx, int Cin, int Cout,
    int D, const Tile g) {
  constexpr int BN = DXT / 32 * DXN;  // dx channels a block
  constexpr int WF = 9 * CK * BN;     // a stage's weights (floats)
  extern __shared__ float4 smem4[];
  float* zrow = reinterpret_cast<float*>(smem4);  // cs zeros
  float* ring = zrow + (g.cs + 3) / 4 * 4;         // NS stages
  const int half = CK * (g.rb + 2) * g.cs;  // one halo [CK][rb+2][cs]
  const int sf = (WF + 2 * half + 3) / 4 * 4;
  const int tid = threadIdx.x, wn = tid >> 5, lane = tid & 31;
  const int ny = (Cin + BN - 1) / BN, nchunk = (Cout + CK - 1) / CK;
  const size_t plane = (size_t)g.rows * g.W;
  const long long units = (long long)D * ny * g.ntiles;
  const int bx = blockIdx.x, gx = gridDim.x;
  const int my = bx < units ? (int)((units - 1 - bx) / gx) + 1 : 0;
  const int steps = my * nchunk;  // (unit, dz channel chunk) pairs
  const int kk = tid % CK;        // the halo channel this thread copies
  for (int e = tid; e < g.cs; e += DXT) zrow[e] = 0.f;

  // step s: chunk s % nchunk of unit bx + (s / nchunk) gx = (device d,
  // channel slice cy, tile t), tile t at image rows from r0, columns c0
  auto unit = [&](int s, int& d, int& cy, int& r0, int& c0, int& chunk) {
    const int i = s / nchunk;
    chunk = s - i * nchunk;
    const long long u = bx + (long long)i * gx;
    const int t = (int)(u % g.ntiles);
    const long long q = u / g.ntiles;
    cy = (int)(q % ny);
    d = (int)(q / ny);
    const int rt = t / g.seg;
    r0 = rt * g.rb;
    c0 = (t - rt * g.seg) * g.gpr * DXM;
  };
  // the dz and y halos of the step's chunk (channel kk of it by this
  // thread) and its weights, flipped and transposed to [tap][CK][BN]
  auto prefetch = [&](int s) {
    if (s < steps) {
      int d, cy, r0, c0, chunk;
      unit(s, d, cy, r0, c0, chunk);
      --r0;
      const float* in_d = dy + (size_t)d * plane * Cout;
      const float* gate_d = y + (size_t)d * plane * Cout;
      const float* w_d = w + (size_t)d * 9 * Cout * Cin;
      const int k = chunk * CK + kk, co0 = cy * BN;
      float* stage = ring + (s % NS) * sf;
      float* buf = stage + WF + kk * (g.rb + 2) * g.cs;
      for (Walk q(tid / CK, DXT / CK, g.hw); q.a < g.rb + 2; q.next()) {
        const int r = r0 + q.a, c = c0 + q.b - 1;
        const bool ok =
            k < Cout && r >= 0 && r < g.rows && c >= 0 && c < g.W;
        const size_t off = ok ? ((size_t)r * g.W + c) * Cout + k : 0;
        cp_async4(buf + q.a * g.cs + q.b, in_d + off, ok);
        cp_async4(buf + half + q.a * g.cs + q.b, gate_d + off, ok);
      }
      for (int e = tid; e < WF; e += DXT) {
        const int kc = e % CK, n = (e / CK) % BN, tap = e / (CK * BN);
        const int kg = chunk * CK + kc;
        const bool ok = kg < Cout && co0 + n < Cin;
        const size_t off =
            ok ? ((size_t)(8 - tap) * Cin + co0 + n) * Cout + kg : 0;
        cp_async4(stage + (tap * CK + kc) * BN + n, w_d + off, ok);
      }
    }
    cp_async_commit();
  };
  // dz = dy * (y > 0) on the elements this thread copied
  auto mask = [&](int s) {
    float* buf = ring + (s % NS) * sf + WF + kk * (g.rb + 2) * g.cs;
    for (Walk q(tid / CK, DXT / CK, g.hw); q.a < g.rb + 2; q.next()) {
      float* z = buf + q.a * g.cs + q.b;
      if (!(z[half] > 0.f)) z[0] = 0.f;
    }
  };

  // this thread: pixels lg DXM .. lg DXM + DXM - 1 of the tile's row lr,
  // dx channels co0 + wn DXN .. + DXN - 1
  const int lr = lane / g.gpr, lg = lane - lr * g.gpr;
  const bool active = lr < g.rb;

#pragma unroll
  for (int s = 0; s < NS - 1; ++s) prefetch(s);
  float acc[DXM][DXN];
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<NS - 2>();
    mask(s);
    __syncthreads();  // stage s is in; every thread is done with s - 1
    prefetch(s + NS - 1);
    int d, cy, row, c0, chunk;
    unit(s, d, cy, row, c0, chunk);
    row += lr;
    const int h = row % g.H;
    const bool live = active && row < g.rows;
    if (chunk == 0) {
#pragma unroll
      for (int m = 0; m < DXM; ++m)
#pragma unroll
        for (int n = 0; n < DXN; ++n) acc[m][n] = 0.f;
    }
    // the three tap rows of this thread's pixels, a row of zeros where the
    // tap falls outside the image; kst steps to the next channel
    const float* xrow[3];
    int kst[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const bool ok = live && h + i >= 1 && h + i <= g.H;
      xrow[i] = ok ? ring + (s % NS) * sf + WF + (lr + i) * g.cs + lg * DXM
                   : zrow;
      kst[i] = ok ? (g.rb + 2) * g.cs : 0;
    }
    const float* ws = ring + (s % NS) * sf + wn * DXN;
    // two channels an iteration: the loop body fully unrolled over CK is
    // ~8000 FMAs of code, past what the instruction cache keeps
#pragma unroll 2
    for (int k = 0; k < CK; ++k) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float* xr = xrow[i] + k * kst[i];
        float a[DXM + 2];
#pragma unroll
        for (int q = 0; q < DXM + 2; ++q) a[q] = xr[q];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float4* wr = reinterpret_cast<const float4*>(
              ws + ((i * 3 + j) * CK + k) * BN);
          float wv[DXN];
#pragma unroll
          for (int v = 0; v < DXN / 4; ++v) {
            const float4 f = wr[v];
            wv[4 * v] = f.x;
            wv[4 * v + 1] = f.y;
            wv[4 * v + 2] = f.z;
            wv[4 * v + 3] = f.w;
          }
#pragma unroll
          for (int n = 0; n < DXN; ++n)
#pragma unroll
            for (int m = 0; m < DXM; ++m)
              acc[m][n] = fmaf(a[m + j], wv[n], acc[m][n]);
        }
      }
    }
    if (chunk == nchunk - 1 && live) {
      const int cob = cy * BN + wn * DXN;
      float* orow = dx + (size_t)d * plane * Cin + (size_t)row * g.W * Cin +
                    cob;
      const bool vec = Cin % 4 == 0 && cob + DXN <= Cin;
#pragma unroll
      for (int m = 0; m < DXM; ++m) {
        const int c = c0 + lg * DXM + m;
        if (c < g.W) {
          float* dst = orow + (size_t)c * Cin;
          if (vec) {
#pragma unroll
            for (int v = 0; v < DXN / 4; ++v)
              reinterpret_cast<float4*>(dst)[v] =
                  make_float4(acc[m][4 * v], acc[m][4 * v + 1],
                              acc[m][4 * v + 2], acc[m][4 * v + 3]);
          } else {
#pragma unroll
            for (int n = 0; n < DXN; ++n)
              if (cob + n < Cin) dst[n] = acc[m][n];
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

template <int CK>
__global__ void __launch_bounds__(DXT, 1)
    conv3x3_dx_wide_kernel(const float* __restrict__ dy,
                           const float* __restrict__ y,
                           const float* __restrict__ w,
                           float* __restrict__ dx, int Cin, int Cout, int D,
                           Tile g) {
  dx_wide_body<CK>(dy, y, w, dx, Cin, Cout, D, g);
}

// A dW block's share of the groups, the channels and the columns.
// conv3x3_dw_kernel: every group, its G groups over spw blocks of GB
// (blockIdx.y is the block's slice).  conv3x3_dw_wide_kernel: the input-
// channel groups [gi0, gi0 + nwi) and output-channel groups [go0, go0 +
// nwo) of window blockIdx.y (windows numbered output-fastest, wo along the
// output groups), GB = 3 nwi nwo threads of it, and each image row in seg
// column segments of wc pixels (the last may be narrower).
struct DwPlan {
  int nwi, nwo;  // groups of a window: input (TCI channels), output (8
                 // channels in dw_body, 4 in the wide kernel)
  int wo;        // windows along the output-channel groups
  int spw, GB;   // blocks a window, groups (threads) a block
  int wc, seg;   // pixels of a column segment, segments a row
};

// dW/db partials: block (t, y, d) reduces image rows [t*rpp, (t+1)*rpp)
// of device d into part[d, t] = [9*Cin + 1, Cout], for the thread groups
// [s*GB, s*GB + GB) of its window (y = window * spw + s).  A group is one
// tap x TCI input x 8 output channels (4*go .. +3 and 4*(ngo + go) .. +3,
// so that neighbouring lanes read neighbouring 16-byte words of dz),
// numbered output channels fastest, then input, then tap (a warp shares
// its tap and reads few distinct inputs).  When the groups do not fill
// the block, its DW_NT / GB slices split each row's pixels.
template <int TCI>
__device__ __forceinline__ void dw_body(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ dy, float* __restrict__ part, int rows, int H,
    int W, int Cin, int Cout, int rpp, int nparts, const DwPlan& p) {
  constexpr int ACC = TCI * 8 + 8;  // dW accumulators, then db's
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  const int ngi = (Cin + TCI - 1) / TCI, ngo = (Cout + 7) / 8;
  const int nwi = ngi, nwo = ngo, wc = W;
  const int cip = TCI * nwi, cop = 8 * nwo;  // a pixel's channel strides
  // a stage: x rows r-1..r+1 [3][wc+2][cip] | dz row [wc][cop] | y row
  const int xf = (3 * (wc + 2) * cip + 3) / 4 * 4, zf = wc * cop;
  const int sf = xf + 2 * zf;
  const int tid = threadIdx.x, d = blockIdx.z, t = blockIdx.x;
  const int sl = blockIdx.y;
  const int nps = DW_NT / p.GB, slot = tid % p.GB, ps = tid / p.GB;
  const int G = 9 * nwi * nwo, gidx = sl * p.GB + slot;
  const int lgo = gidx % nwo, lgi = gidx / nwo % nwi;
  const int tap = gidx / (nwo * nwi);
  const bool act = ps < nps && gidx < G;
  const int ti = tap / 3, tj = tap - 3 * ti;
  const int cpp = (wc + nps - 1) / nps;  // pixels of a row per slice
  const int r_lo = t * rpp, nrow = min(rpp, rows - r_lo);
  const int steps = nrow;
  const size_t plane = (size_t)rows * W;
  const float* x_d = x + (size_t)d * plane * Cin;
  const float* y_d = y + (size_t)d * plane * Cout;
  const float* dy_d = dy + (size_t)d * plane * Cout;
  const bool xvec = Cin % 4 == 0, zvec = Cout % 4 == 0;

  // the pad channels are never copied: zero them once
  for (int e = tid; e < NS * sf; e += DW_NT) ring[e] = 0.f;
  __syncthreads();

  // copy units of a pixel: 16 bytes where the channels allow, else 4
  const int xu = xvec ? Cin / 4 : Cin;
  const int zu = zvec ? Cout / 4 : Cout;
  // stage s: row r_lo + rs
  auto prefetch = [&](int s, int rs) {
    if (s < steps) {
      const int r = r_lo + rs;
      float* xs = ring + (s % NS) * sf;
      float* zs = xs + xf;
      float* ys = zs + zf;
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

  // stage s's taps over the pixels [c_lo, c_hi) of its row
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
  // a stage a row, the slice's pixels fixed
  const int c_lo = act ? min(W, ps * cpp) : W, c_hi = min(W, c_lo + cpp);
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) prefetch(s, s);
  for (int s = 0; s < nrow; ++s) {
    prefetch(s + NS - 1, s + NS - 1);
    cp_async_wait<NS - 1>();
    mask(s, W);
    __syncthreads();
    accumulate(s, (r_lo + s) % H, c_lo, c_hi);
    __syncthreads();
  }
  cp_async_wait<0>();

  // part row of accumulator v of group gid; -1 where it has none
  auto row_of = [&](int gid, int v, int& col) {
    const int o = gid % nwo, i = gid / nwo % nwi;
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
  dw_body<TCI>(x, y, dy, part, rows, H, W, Cin, Cout, rpp, nparts, p);
}

// conv3x3_dw_wide_kernel: where a stage of every channel of a whole row
// does not fit dw_body, block (t, y, d) reduces the same rows into part[d,
// t] for one window of the channel groups (blockIdx.y), each row in p.seg
// column segments of p.wc pixels, segment after segment.
//   A thread owns one tap row ti and one group of TCI input by 4 output
// channels, for the three taps (ti, 0..2): 12 TCI accumulators (96 at
// TCI 8; two blocks of 6 warps an SM).  Along its pixels it slides a
// window of three x vectors, so that a pixel costs one new x vector (TCI
// floats) and one dz vector (4 floats) for 12 TCI FMAs: 8 FMAs a float
// read from shared memory at TCI 8, against 4 for dw_body's one tap of
// 8 x 8 (those reads, and the fixed cost of a stage of one row, bound
// that loop, not the FMAs).  Threads are numbered output groups fastest,
// then input groups, then tap row; where the groups do not fill the
// block, its DW2_NT / GB slices split each segment's pixels.
//   The x rows come through a ring of XR row slots, one new row a stage:
// each x row is copied once a segment and serves its three tap rows; a
// stage carries one x row, one dz row and one y row (the segment's first
// stage carries its first two x rows and nothing to compute).  db is
// summed where dz is masked: each thread masks the same 4 (or 1) output
// channels at every stage (its copy units' channel is fixed, zu dividing
// DW2_NT), and the threads of a channel are added in a fixed order at the
// end, as are the slices.  No atomics: the same bits on repeat.
template <int TCI>
__device__ __forceinline__ void dw_ring(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ dy, float* __restrict__ part, int rows, int H,
    int W, int Cin, int Cout, int rpp, int nparts, const DwPlan& p) {
  constexpr int ACC = 12 * TCI;  // [tap column][TCI][4]
  constexpr int XR = 6;  // x rows held: 3 read, those of the next 2 stages
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int ngi = (Cin + TCI - 1) / TCI, ngo = (Cout + 3) / 4;
  const int nwi = p.nwi, nwo = p.nwo, wc = p.wc;
  const int cip = TCI * nwi, cop = 4 * nwo;  // a window's channel strides
  const int xs = ((wc + 2) * cip + 3) / 4 * 4, zf = wc * cop;
  float* xring = sm;             // [XR][wc + 2][cip]
  float* zring = sm + XR * xs;   // [NS][dz, y][wc][cop]
  const int tid = threadIdx.x, d = blockIdx.z, t = blockIdx.x;
  const int gi0 = blockIdx.y / p.wo * nwi, go0 = blockIdx.y % p.wo * nwo;
  const int nps = DW2_NT / p.GB, slot = tid % p.GB, ps = tid / p.GB;
  const int lgo = slot % nwo, lgi = slot / nwo % nwi;
  const int ti = slot / (nwo * nwi);
  const bool act = ps < nps && gi0 + lgi < ngi && go0 + lgo < ngo;
  const int cpp = (wc + nps - 1) / nps;  // pixels of a segment per slice
  const int r_lo = t * rpp, nrow = min(rpp, rows - r_lo);
  const int per = nrow + 1;              // stages a segment
  const int steps = per * p.seg;
  const size_t plane = (size_t)rows * W;
  const float* x_d = x + (size_t)d * plane * Cin;
  const float* y_d = y + (size_t)d * plane * Cout;
  const float* dy_d = dy + (size_t)d * plane * Cout;
  const bool xvec = Cin % 4 == 0, zvec = Cout % 4 == 0;
  const int ci0 = gi0 * TCI, ncx = min(cip, Cin - ci0);  // x channels copied
  const int co0 = 4 * go0;

  // the pad channels are never copied: zero them once
  for (int e = tid; e < XR * xs + NS * 2 * zf; e += DW2_NT) sm[e] = 0.f;
  __syncthreads();

  // copy units of a pixel: 16 bytes where the channels allow, else 4;
  // a thread's dz units are all of channel unit tid % zu
  const int xu = xvec ? ncx / 4 : ncx;
  const int zu = zvec ? nwo : cop;
  const Walk xw(tid, DW2_NT, xu), zw(tid, DW2_NT, zu);  // a stage's copies
  // x row r, columns c0 - 1 .. c0 + wcs (zeros outside the image), into
  // the slot of the x row numbered q
  auto load_x = [&](int q, int r, int c0, int wcs) {
    float* dst0 = xring + (q % XR) * xs;
    for (Walk u = xw; u.a < wcs + 2; u.next()) {
      const int gc = c0 + u.a - 1;
      const bool ok = r >= 0 && r < rows && gc >= 0 && gc < W;
      const float* src = x_d + (ok ? ((size_t)r * W + gc) * Cin + ci0 : 0);
      float* dst = dst0 + u.a * cip;
      if (xvec)
        cp_async16(dst + 4 * u.b, src + 4 * u.b, ok);
      else
        cp_async4(dst + u.b, src + u.b, ok);
    }
  };
  // stage s = sg * per + k of segment sg: k = 0 brings x rows r_lo - 1 and
  // r_lo (x rows numbered sg * (nrow + 2) + 0, 1); k > 0 computes row
  // r_lo + k - 1 and brings x row r_lo + k (numbered + k + 1) and that
  // row's dz and y.  Called for s = 0, 1, 2, ... in turn (pf is (sg, k))
  Walk pf(0, 1, per);
  auto prefetch = [&](int s) {
    if (s < steps) {
      const int sg = pf.a, k = pf.b;
      pf.next();
      const int c0 = sg * wc, wcs = min(wc, W - c0), q0 = sg * (nrow + 2);
      if (k == 0) {
        load_x(q0, r_lo - 1, c0, wcs);
        load_x(q0 + 1, r_lo, c0, wcs);
      } else {
        const int r = r_lo + k - 1;
        load_x(q0 + k + 1, r + 1, c0, wcs);
        float* zs = zring + (s % NS) * 2 * zf;
        for (Walk u = zw; u.a < wcs; u.next()) {
          const int ch = zvec ? 4 * u.b : u.b;
          const bool ok = co0 + ch < Cout;
          const size_t o = ok ? ((size_t)r * W + c0 + u.a) * Cout + co0 + ch
                              : 0;
          const int so = u.a * cop + ch;
          if (zvec) {
            cp_async16(zs + so, dy_d + o, ok);
            cp_async16(zs + zf + so, y_d + o, ok);
          } else {
            cp_async4(zs + so, dy_d + o, ok);
            cp_async4(zs + zf + so, y_d + o, ok);
          }
        }
      }
    }
    cp_async_commit();
  };
  // dz = dy * (y > 0) on the elements this thread copied, summed into db
  float db[4] = {0.f, 0.f, 0.f, 0.f};
  auto mask = [&](int s, int wcs) {
    float* zs = zring + (s % NS) * 2 * zf;
    const float* ys = zs + zf;
    for (Walk u = zw; u.a < wcs; u.next()) {
      if (zvec) {
        const int o = u.a * cop + 4 * u.b;
        float4 z = *reinterpret_cast<float4*>(zs + o);
        const float4 yv = *reinterpret_cast<const float4*>(ys + o);
        z.x = yv.x > 0.f ? z.x : 0.f;
        z.y = yv.y > 0.f ? z.y : 0.f;
        z.z = yv.z > 0.f ? z.z : 0.f;
        z.w = yv.w > 0.f ? z.w : 0.f;
        *reinterpret_cast<float4*>(zs + o) = z;
        db[0] += z.x;
        db[1] += z.y;
        db[2] += z.z;
        db[3] += z.w;
      } else {
        const int o = u.a * cop + u.b;
        if (!(ys[o] > 0.f)) zs[o] = 0.f;
        db[0] += zs[o];
      }
    }
  };

  float acc[ACC];
#pragma unroll
  for (int v = 0; v < ACC; ++v) acc[v] = 0.f;

  // one pixel: x0, x1 hold the x vectors of its tap columns 0 and 1; x2
  // (column 2) is read, then the three taps take dz
  auto load = [&](const float* xq, float (&v)[TCI]) {
    if constexpr (TCI == 8) {
      const float4 a = *reinterpret_cast<const float4*>(xq);
      const float4 b = *reinterpret_cast<const float4*>(xq + 4);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    } else {
      v[0] = xq[0];
    }
  };
  auto pixel = [&](const float* xq, const float* zq, const float (&x0)[TCI],
                   const float (&x1)[TCI], float (&x2)[TCI]) {
    load(xq + 2 * cip, x2);
    const float4 z4 = *reinterpret_cast<const float4*>(zq);
    const float z[4] = {z4.x, z4.y, z4.z, z4.w};
#pragma unroll
    for (int u = 0; u < TCI; ++u)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int i = u * 4 + n;  // tap columns 0, 1, 2: 4 TCI apart
        acc[i] = fmaf(x0[u], z[n], acc[i]);
        acc[i + 4 * TCI] = fmaf(x1[u], z[n], acc[i + 4 * TCI]);
        acc[i + 8 * TCI] = fmaf(x2[u], z[n], acc[i + 8 * TCI]);
      }
  };
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) prefetch(s);
  Walk st(0, 1, per);  // (segment, k) of stage s
  int h = 0;           // the image row of row r_lo + k - 1
  for (int s = 0; s < steps; ++s, st.next()) {
    const int wcs = min(wc, W - st.a * wc);
    cp_async_wait<NS - 2>();
    if (st.b > 0) mask(s, wcs);
    __syncthreads();  // stage s is in; every thread is done with s - 1
    prefetch(s + NS - 1);
    h = st.b == 1 ? r_lo % H : (h + 1 == H ? 0 : h + 1);
    // a tap row outside the image adds nothing
    if (act && st.b > 0 && h + ti >= 1 && h + ti <= H) {
      const int c_lo = min(wcs, ps * cpp), c_hi = min(wcs, c_lo + cpp);
      const int q = st.a * (nrow + 2) + st.b - 1 + ti;  // x row r - 1 + ti
      const float* xp = xring + (q % XR) * xs + c_lo * cip + lgi * TCI;
      const float* zp = zring + (s % NS) * 2 * zf + c_lo * cop + 4 * lgo;
      float xa[TCI], xb[TCI], xc[TCI];
      load(xp, xa);
      load(xp + cip, xb);
      int c = c_lo;
      for (; c + 3 <= c_hi; c += 3, xp += 3 * cip, zp += 3 * cop) {
        pixel(xp, zp, xa, xb, xc);
        pixel(xp + cip, zp + cop, xb, xc, xa);
        pixel(xp + 2 * cip, zp + 2 * cop, xc, xa, xb);
      }
      if (c < c_hi) pixel(xp, zp, xa, xb, xc);
      if (c + 1 < c_hi) pixel(xp + cip, zp + cop, xb, xc, xa);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the rings' readers are done

  // the slices' sums and the db partials of the threads of a channel, each
  // added in a fixed order
  float* red = sm;                   // [DW2_NT][ACC]
  float* dbr = sm + DW2_NT * ACC;    // [DW2_NT][4]
#pragma unroll
  for (int v = 0; v < ACC; ++v) red[tid * ACC + v] = acc[v];
#pragma unroll
  for (int n = 0; n < 4; ++n) dbr[tid * 4 + n] = db[n];
  __syncthreads();
  float* pd = part + ((size_t)d * nparts + t) * (9 * Cin + 1) * Cout;
  for (int e = tid; e < p.GB * ACC; e += DW2_NT) {
    const int g2 = e / ACC, v = e - g2 * ACC;
    const int o = go0 + g2 % nwo, i = gi0 + g2 / nwo % nwi;
    const int tr = g2 / (nwo * nwi), tc = v / (4 * TCI);
    const int ci = i * TCI + v / 4 % TCI, col = 4 * o + v % 4;
    if (o >= ngo || i >= ngi || ci >= Cin || col >= Cout) continue;
    float sum = 0.f;
    for (int q = 0; q < nps; ++q) sum += red[(q * p.GB + g2) * ACC + v];
    pd[(size_t)((3 * tr + tc) * Cin + ci) * Cout + col] = sum;
  }
  if (gi0 == 0) {  // db: one window of input channels writes it
    for (int e = tid; e < cop; e += DW2_NT) {
      const int b = zvec ? e / 4 : e, n = zvec ? e % 4 : 0;
      if (co0 + e >= Cout) continue;
      float sum = 0.f;
      for (int q = b; q < DW2_NT; q += zu) sum += dbr[q * 4 + n];
      pd[(size_t)9 * Cin * Cout + co0 + e] = sum;
    }
  }
}

template <int TCI>
__global__ void __launch_bounds__(DW2_NT, 2)
    conv3x3_dw_wide_kernel(const float* __restrict__ x,
                           const float* __restrict__ y,
                           const float* __restrict__ dy,
                           float* __restrict__ part, int rows, int H, int W,
                           int Cin, int Cout, int rpp, int nparts,
                           DwPlan p) {
  dw_ring<TCI>(x, y, dy, part, rows, H, W, Cin, Cout, rpp, nparts, p);
}

// ---------------------------------------------------------------- host side

// The halo row stride: at least hw, and such that a warp's first reads
// (lane -> row lane / gpr, column (lane % gpr) * TM) fall into as few
// lanes a bank as can be.
int pick_cs(int gpr, int hw, int tm = TM) {
  int best = hw, best_deg = 33;
  const int lanes = 32 / gpr * gpr;
  for (int cs = hw; cs < hw + 32; ++cs) {
    int cnt[32] = {0}, deg = 0;
    for (int lane = 0; lane < lanes; ++lane) {
      const int bank = ((lane / gpr) * cs + (lane % gpr) * tm) % 32;
      deg = ++cnt[bank] > deg ? cnt[bank] : deg;
    }
    if (deg < best_deg) {
      best_deg = deg;
      best = cs;
    }
  }
  return best;
}

Tile make_tile(int rows, int H, int W, int wm, int tm = TM) {
  Tile g;
  g.rows = rows;
  g.H = H;
  g.W = W;
  const int groups = (W + tm - 1) / tm;
  g.seg = (groups + 31) / 32;
  g.gpr = (groups + g.seg - 1) / g.seg;
  g.rb = 32 * wm / g.gpr;
  g.hw = g.gpr * tm + 2;
  g.cs = pick_cs(g.gpr, g.hw, tm);
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

// dynamic shared memory of a conv3x3_dx_wide_kernel<8> block
size_t dx_wide_smem(const Tile& g) {
  const size_t half = (size_t)8 * (g.rb + 2) * g.cs;
  return 4 * ((g.cs + 3) / 4 * 4 +
               NS * ((9 * 8 * (DXT / 32 * DXN) + 2 * half + 3) / 4 * 4));
}

// dx on conv3x3_dx_wide_kernel<8>: as many blocks as the card holds at
// once, each walking its share of the units
int dx_wide_run(const float* dy, const float* y, const float* w, float* dx,
                int D, int rows, int H, int W, int Cin, int Cout,
                cudaStream_t st) {
  const Tile g = make_tile(rows, H, W, 1, DXM);
  const size_t smem = dx_wide_smem(g);
  auto kernel = conv3x3_dx_wide_kernel<8>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, DXT,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  constexpr int BN = DXT / 32 * DXN;
  const long long units = (long long)D * ((Cin + BN - 1) / BN) * g.ntiles;
  const long long slots = (long long)(per_sm > 0 ? per_sm : 1) * sm_count();
  const int blocks = (int)(units < slots ? units : slots);
  kernel<<<blocks, DXT, smem, st>>>(dy, y, w, dx, Cin, Cout, D, g);
  return (int)cudaGetLastError();
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
  // dx past 64 channels with streamed weights: conv3x3_dx_wide_kernel
  // where its ring fits
  bool wide = false;
  if constexpr (MODE == DX)
    wide = Ck > 1 && Cn > 64 &&
           dx_wide_smem(make_tile(rows, H, W, 1, DXM)) <= (size_t)SMEM_MAX;
  if (g1.seg > 1) {
    if (Ck == 1) return Cn > 32 ? RUN(1, 1, true) : RUN(1, 2, true);
    if (wide)
      return dx_wide_run(in, gate, w, out, D, rows, H, W, Cin, Cout, st);
    return Cn > 32 ? RUN(8, 1, true) : RUN(8, 2, true);
  }
  if (Ck == 1) return Cn > 32 && fits(1, 1) ? RUN(1, 1, false)
                                            : RUN(1, 2, false);
  if (Cn > 32 && fits(4, 1))
    return Ck % 8 == 0 && fits(8, 1) ? RUN(8, 1, false) : RUN(4, 1, false);
  if (fits(4, 2))
    return Ck % 8 == 0 && fits(8, 2) ? RUN(8, 2, false) : RUN(4, 2, false);
  if (wide) return dx_wide_run(in, gate, w, out, D, rows, H, W, Cin, Cout,
                               st);
  return Cn > 32 ? RUN(8, 1, true) : RUN(8, 2, true);
#undef RUN
}

// dynamic shared memory of a conv3x3_dw_wide_kernel block: XR x rows and
// NS dz and y rows, or the slices' sums and the db partials after them
template <int TCI>
size_t dw_ring_smem(const DwPlan& p) {
  const size_t xs = ((p.wc + 2) * (size_t)TCI * p.nwi + 3) / 4 * 4;
  const size_t ring = 6 * xs + NS * 2 * (size_t)p.wc * 4 * p.nwo;
  const size_t red = (size_t)DW2_NT * (12 * TCI + 4);
  return 4 * (ring > red ? ring : red);
}

// conv3x3_dw_wide_kernel's plan: the window of at most DW2_NT / 3 groups
// (a power of 2 of output groups whose dz copy units, nwo of 16 bytes or
// 4 nwo of 4 where Cout % 4 != 0, divide DW2_NT, so that a thread's dz
// units keep their channels) whose pixels copy the fewest bytes a FMA
// (TCI nwi x channels and 2 x 4 nwo dz and y channels, for 12 TCI nwi nwo
// FMAs a tap row), and each row in the fewest equal segments whose block
// fits half an SM's shared memory (two blocks an SM), or a block's.
template <int TCI>
DwPlan dw_wide_plan(int W, int Cin, int Cout) {
  const int ngi = (Cin + TCI - 1) / TCI, ngo = (Cout + 3) / 4;
  DwPlan p;
  double best = 0;
  for (int i = 1; i <= ngi; ++i)
    for (int o = 1; o <= ngo && 3 * i * o <= DW2_NT; o *= 2) {
      if (DW2_NT % (Cout % 4 ? 4 * o : o) != 0) continue;
      const double cost = (double)(TCI * i + 8 * o) / (TCI * i * o);
      if (best == 0 || cost < best) {
        best = cost;
        p.nwi = i;
        p.nwo = o;
      }
    }
  p.wo = (ngo + p.nwo - 1) / p.nwo;
  p.GB = 3 * p.nwi * p.nwo;
  p.spw = 1;
  const long long caps[2] = {SMEM_MAX / 2 - 1024, SMEM_MAX};
  for (const long long cap : caps) {
    for (p.seg = 1; p.seg <= W; ++p.seg) {
      p.wc = (W + p.seg - 1) / p.seg;
      if (dw_ring_smem<TCI>(p) <= (size_t)cap) return p;
      if (p.wc < 32 && cap < SMEM_MAX) break;  // narrower: try more room
    }
  }
  return p;
}

// conv3x3_dw_kernel's plan: every channel of a whole row a stage, its
// groups over spw blocks of at most DW_NT
template <int TCI>
DwPlan dw_plan(int W, int Cin, int Cout) {
  DwPlan p;
  p.nwi = (Cin + TCI - 1) / TCI;
  p.nwo = (Cout + 7) / 8;
  p.wo = 1;
  p.wc = W;
  p.seg = 1;
  const int G = 9 * p.nwi * p.nwo;
  p.GB = G < DW_NT ? G : DW_NT;
  p.spw = (G + p.GB - 1) / p.GB;
  return p;
}

// dynamic shared memory of a conv3x3_dw_kernel block: NS stages of x rows
// r-1..r+1 and a dz and a y row, or the slices' sums after them
template <int TCI>
size_t dw_smem(int W, int Cin, int Cout) {
  const DwPlan p = dw_plan<TCI>(W, Cin, Cout);
  const size_t xf = (3 * (size_t)(W + 2) * TCI * p.nwi + 3) / 4 * 4;
  const size_t smem = 4 * NS * (xf + 2 * (size_t)W * 8 * p.nwo);
  const size_t red = 4 * (size_t)DW_NT * (TCI * 8 + 8);
  return DW_NT / p.GB > 1 && smem < red ? red : smem;
}

// The dW pass: conv3x3_dw_kernel where a stage of every channel of a
// whole row fits, else conv3x3_dw_wide_kernel.
template <typename... A>
int dw_launch(void (*kernel)(A...), size_t smem, const DwPlan& p, int nwin,
              int nth, const float* x, const float* y, const float* dy,
              float* part, int D, int rows, int H, int W, int Cin, int Cout,
              int rpp, cudaStream_t st) {
  if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidConfiguration;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int nparts = (rows + rpp - 1) / rpp;
  dim3 grid(nparts, nwin, D);
  kernel<<<grid, nth, smem, st>>>(x, y, dy, part, rows, H, W, Cin, Cout,
                                  rpp, nparts, p);
  return (int)cudaGetLastError();
}

int dw_pass(const float* x, const float* y, const float* dy, float* part,
            int D, int rows, int H, int W, int Cin, int Cout, int rpp,
            cudaStream_t st) {
  const bool t8 = Cin % 8 == 0 || Cin > 8;
  const size_t smem = t8 ? dw_smem<8>(W, Cin, Cout) : dw_smem<1>(W, Cin, Cout);
  if (smem <= (size_t)SMEM_MAX) {
    if (t8) {
      const DwPlan p = dw_plan<8>(W, Cin, Cout);
      return dw_launch(conv3x3_dw_kernel<8>, smem, p, p.spw, DW_NT, x, y, dy,
                       part, D, rows, H, W, Cin, Cout, rpp, st);
    }
    const DwPlan p = dw_plan<1>(W, Cin, Cout);
    return dw_launch(conv3x3_dw_kernel<1>, smem, p, p.spw, DW_NT, x, y, dy,
                     part, D, rows, H, W, Cin, Cout, rpp, st);
  }
  if (t8) {
    const DwPlan p = dw_wide_plan<8>(W, Cin, Cout);
    return dw_launch(conv3x3_dw_wide_kernel<8>, dw_ring_smem<8>(p), p,
                     (Cin + 8 * p.nwi - 1) / (8 * p.nwi) * p.wo, DW2_NT, x,
                     y, dy, part, D, rows, H, W, Cin, Cout, rpp, st);
  }
  const DwPlan p = dw_wide_plan<1>(W, Cin, Cout);
  return dw_launch(conv3x3_dw_wide_kernel<1>, dw_ring_smem<1>(p), p,
                   (Cin + p.nwi - 1) / p.nwi * p.wo, DW2_NT, x, y, dy, part,
                   D, rows, H, W, Cin, Cout, rpp, st);
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
  return dw_pass(x, y, dy, dw_part, D, rows, H, W, Cin, Cout, rpp, st);
}
