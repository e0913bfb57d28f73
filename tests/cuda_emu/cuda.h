// Shim: the CPU emulation of the CUDA subset the port's kernels use, with
// libcuda's tensor-map type reduced to what the emulated TMA reads.
#pragma once
#include "cuda_mock.h"

struct CUtensorMap {
  const unsigned char* base;
  uint64_t dims[4];     // innermost first
  uint64_t strides[3];  // bytes, of dims 1..3
  uint32_t box[4];
};
