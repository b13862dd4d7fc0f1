// The float32 flash backward's kernels b (dk, dv) and c (dq) on FP32 FMA
// (flash_bwd_fma.cu), called by flash_attention_bwd.cu's launchers.
#pragma once

#include <cuda_runtime.h>

namespace flash_fma {

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;   // [B, Sq, H, Dh] contiguous
  const float* lse;    // [B, H, Sq]
  const float* delta;  // [B, H, Sq]
  float* dq;           // [B, Sq, H, Dh]
  float* dk;           // [B, Skv, Hkv, Dh]
  float* dv;
  int B, H, Hkv, G, Sq, Skv;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
  int causal, window, q_offset;  // window < 0: none
  float scale;
  int vec;  // every row of q, k, v and do starts on 16 bytes: 16-byte copies
};

// kernel b (dq false: one launch, two above Dh 128) or c (dq true) at head
// dim D; returns a cudaError_t
int launch(bool dq, const Params& p, int D, cudaStream_t stream);

}  // namespace flash_fma
