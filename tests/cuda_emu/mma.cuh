// Emulation of gofr_tpu_torch/csrc/mma.cuh: the warp deposits its
// fragments, then each lane computes its four outputs from the whole
// 16x16 A and 16x8 B, read back through the PTX m16n8k16 fragment layout.
#pragma once
#include "cuda_mock.h"

inline float mock_bf16_half(uint32_t word, int hi) {
  return __uint_as_float(hi ? (word & 0xffff0000u) : (word << 16));
}

inline void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  uint32_t* f = mock_ctx->frag.data();
  for (int i = 0; i < 4; ++i) f[6 * tid + i] = a[i];
  f[6 * tid + 4] = b[0];
  f[6 * tid + 5] = b[1];
  mock_warp_sync();
  const uint32_t* wf = f + 6 * 32 * w;
  auto A = [&](int row, int col) {  // a[reg] of lane (row%8)*4 + (col%8)/2
    const int reg = (row >= 8 ? 1 : 0) + (col >= 8 ? 2 : 0);
    return mock_bf16_half(wf[6 * ((row % 8) * 4 + (col % 8) / 2) + reg], col % 2);
  };
  auto B = [&](int k, int n) {  // b[reg] of lane n*4 + (k%8)/2
    return mock_bf16_half(wf[6 * (n * 4 + (k % 8) / 2) + 4 + (k >= 8 ? 1 : 0)], k % 2);
  };
  const int g = lane / 4, t = lane % 4;
  for (int e = 0; e < 4; ++e) {
    const int row = g + (e >= 2 ? 8 : 0), col = 2 * t + (e % 2);
    float acc = d[e];
    for (int k = 0; k < 16; ++k) acc += A(row, k) * B(k, col);
    d[e] = acc;
  }
  mock_warp_sync();
}

inline uint32_t pack_bf16x2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}
