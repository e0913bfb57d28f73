// CPU emulation of the small CUDA subset the torch port's kernels use
// (gofr_tpu_torch/csrc/*.cu), so that the kernels' own code can be compiled
// by a host C++ compiler and run in the CPU tests.
//
// Each CUDA thread of a block is a fiber (ucontext) on the calling OS
// thread; blocks run one after another. __syncthreads is a barrier over
// the block's fibers and __shfl_xor_sync an exchange between two barriers
// over the warp's: a fiber that reaches one yields until every fiber of its
// block (or warp) has arrived, so a kernel whose threads diverge at either
// one deadlocks, which the scheduler detects and aborts on, as it would
// misbehave on a card. Dynamic shared memory is one static buffer, filled
// with NaN bytes before every block so that reads of unwritten shared
// memory show in the output. The Hopper primitives (wgmma, mbarrier,
// cp.async, TMA, named barriers) are emulated in sm90.cuh on top of this.
#pragma once
#include <ucontext.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__ __restrict
#define __launch_bounds__(...)
#define __shared__
#define __align__(n)
#define __grid_constant__

using std::max;
using std::min;

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline thread_local dim3 blockDim, gridDim;

struct alignas(16) uint4 { unsigned x, y, z, w; };
struct alignas(8) uint2 { unsigned x, y; };
inline uint2 make_uint2(unsigned x, unsigned y) { return {x, y}; }
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) { return {x, y, z, w}; }
struct __nv_bfloat16 { uint16_t v; };
inline uint16_t __bfloat16_as_ushort(__nv_bfloat16 b) { return b.v; }

inline float __uint_as_float(uint32_t u) { float f; std::memcpy(&f, &u, 4); return f; }
inline float __bfloat162float(__nv_bfloat16 b) { return __uint_as_float(uint32_t(b.v) << 16); }
inline __nv_bfloat16 __float2bfloat16(float f) {  // round to nearest even
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if (std::isnan(f)) return {uint16_t(0x7fc0)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {uint16_t(u >> 16)};
}
inline float __expf(float x) { return std::exp(x); }

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorNotSupported = 801 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F> int cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
inline int cudaGetLastError() { return 0; }

// 1024-byte aligned, as the 128-byte swizzle's phase needs.
alignas(1024) inline thread_local unsigned char mock_smem[256 * 1024];

struct MockBarrier {
  unsigned gen = 0, count = 0;
};

// An mbarrier: the arrivals still expected in the current phase, the
// transaction bytes still expected, and the number of completed phases.
struct MockMbar {
  unsigned count = 0, pending = 0, phases = 0;
  long long tx = 0;
};

struct MockBlock {
  int nt = 0, cur = 0;
  unsigned long progress = 0;  // barrier arrivals and finished fibers
  std::vector<ucontext_t> ctx;
  std::vector<char> done;
  std::vector<std::vector<char>> stacks;
  ucontext_t sched;
  const std::function<void()>* body = nullptr;
  MockBarrier bar;
  std::vector<MockBarrier> warp;
  std::vector<float> xch;
  std::vector<uint32_t> frag;  // 6 words per thread: an mma's A and B fragments
  std::vector<MockBarrier> named;  // bar.sync ids 0..15
  std::vector<MockBarrier> wgroup;  // one per warpgroup (wgmma is collective)
  std::vector<MockMbar> mbar;       // indexed by shared-memory offset / 8
};
inline thread_local MockBlock* mock_ctx = nullptr;

inline void mock_yield() { swapcontext(&mock_ctx->ctx[mock_ctx->cur], &mock_ctx->sched); }

inline void mock_barrier(MockBarrier& b, unsigned n) {
  const unsigned g = b.gen;
  ++mock_ctx->progress;
  if (++b.count == n) {
    b.count = 0;
    ++b.gen;
    return;
  }
  while (b.gen == g) mock_yield();
}

inline void __syncthreads() { mock_barrier(mock_ctx->bar, mock_ctx->nt); }
inline void mock_warp_sync() { mock_barrier(mock_ctx->warp[threadIdx.x / 32], 32); }

inline float __shfl_xor_sync(unsigned, float v, int off) {
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  mock_ctx->xch[tid] = v;
  mock_warp_sync();
  const float r = mock_ctx->xch[w * 32 + (lane ^ off)];
  mock_warp_sync();
  return r;
}

inline void mock_fiber_entry() {
  (*mock_ctx->body)();
  mock_ctx->done[mock_ctx->cur] = 1;
  ++mock_ctx->progress;
}  // returns to mock_ctx->sched through uc_link

// Stands in for `kernel<<<grid, block, smem, stream>>>(args...)`.
template <class K, class... A>
void mock_launch(K kernel, dim3 grid, dim3 block, size_t smem, cudaStream_t, A... args) {
  constexpr size_t kStack = 256 * 1024;
  gridDim = grid;
  blockDim = block;
  const int nt = block.x * block.y * block.z;
  if (smem > sizeof(mock_smem) || nt % 32) std::abort();
  const std::function<void()> body = [&] { kernel(args...); };
  MockBlock b;
  b.nt = nt;
  b.body = &body;
  b.ctx.resize(nt);
  b.stacks.assign(nt, std::vector<char>(kStack));
  b.xch.assign(nt, 0.f);
  b.frag.assign(6 * nt, 0u);
  mock_ctx = &b;
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        std::memset(mock_smem, 0xff, smem);
        blockIdx = dim3(x, y, z);
        b.bar = MockBarrier{};
        b.warp.assign(nt / 32, MockBarrier{});
        b.named.assign(16, MockBarrier{});
        b.wgroup.assign((nt + 127) / 128, MockBarrier{});
        b.mbar.assign(sizeof(mock_smem) / 8, MockMbar{});
        b.done.assign(nt, 0);
        for (int t = 0; t < nt; ++t) {
          getcontext(&b.ctx[t]);
          b.ctx[t].uc_stack.ss_sp = b.stacks[t].data();
          b.ctx[t].uc_stack.ss_size = kStack;
          b.ctx[t].uc_link = &b.sched;
          makecontext(&b.ctx[t], mock_fiber_entry, 0);
        }
        for (int left = nt; left > 0;) {
          const unsigned long before = b.progress;
          left = 0;
          for (int t = 0; t < nt; ++t) {
            if (b.done[t]) continue;
            b.cur = t;
            threadIdx = dim3(t);
            swapcontext(&b.sched, &b.ctx[t]);
            left += !b.done[t];
          }
          if (left > 0 && b.progress == before) std::abort();  // threads diverged at a barrier
        }
      }
  mock_ctx = nullptr;
}
