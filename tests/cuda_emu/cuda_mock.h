// CPU emulation of the small CUDA subset the torch port's kernels use
// (gofr_tpu_torch/csrc/*.cu), so that the kernels' own code can be compiled
// by a host C++ compiler and run in the CPU tests.
//
// Each CUDA thread of a block is a fiber (ucontext) on the calling OS
// thread. Blocks run one cluster at a time: a plain launch is clusters of
// one block, and the blocks of one cluster (mock_launch_cluster, the
// stand-in for a cudaLaunchKernelEx with a cluster dimension) run together,
// their fibers interleaved. __syncthreads is a barrier over the block's
// fibers, __shfl_xor_sync and __shfl_sync exchanges behind a barrier over
// the warp's and the cluster barrier one over every fiber of the cluster: a fiber that reaches one yields until every fiber of its block
// (warp, cluster) has arrived, so a kernel whose threads diverge at any of them deadlocks,
// which the scheduler detects and aborts on, as it would misbehave on a
// card. Each block of a cluster has its own dynamic shared memory, filled
// with NaN bytes before the block starts so that reads of unwritten shared
// memory show in the output; a peer's is reached through the emulated mapa
// (sm90.cuh). The Hopper primitives (wgmma, mbarrier, cp.async, bulk copies,
// TMA, named barriers, clusters) are emulated in sm90.cuh on top of this.
#pragma once
#include <ucontext.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
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
struct alignas(16) float4 { float x, y, z, w; };
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

// CUDA graphs (csrc/graph_while.cu) have no CPU mode: the types compile,
// and every call reports cudaErrorNotSupported.
#define CUDART_VERSION 12080
typedef struct MockGraph* cudaGraph_t;
typedef struct MockGraphExec* cudaGraphExec_t;
typedef struct MockGraphNode* cudaGraphNode_t;
typedef unsigned long long cudaGraphConditionalHandle;
enum { cudaGraphCondAssignDefault = 1 };
enum cudaGraphCondType { cudaGraphCondTypeIf, cudaGraphCondTypeWhile };
enum cudaGraphNodeType { cudaGraphNodeTypeConditional = 13 };
struct cudaKernelNodeParams {
  void* func;
  dim3 gridDim, blockDim;
  unsigned sharedMemBytes;
  void** kernelParams;
  void** extra;
};
struct cudaConditionalNodeParams {
  cudaGraphConditionalHandle handle;
  cudaGraphCondType type;
  unsigned size;
  cudaGraph_t* phGraph_out;
};
struct cudaGraphNodeParams {
  cudaGraphNodeType type;
  cudaConditionalNodeParams conditional;
};
inline int cudaGraphCreate(cudaGraph_t*, unsigned) { return cudaErrorNotSupported; }
inline int cudaGraphConditionalHandleCreate(cudaGraphConditionalHandle*, cudaGraph_t, unsigned,
                                            unsigned) { return cudaErrorNotSupported; }
inline int cudaGraphAddChildGraphNode(cudaGraphNode_t*, cudaGraph_t, const cudaGraphNode_t*,
                                      size_t, cudaGraph_t) { return cudaErrorNotSupported; }
inline int cudaGraphAddKernelNode(cudaGraphNode_t*, cudaGraph_t, const cudaGraphNode_t*, size_t,
                                  const cudaKernelNodeParams*) { return cudaErrorNotSupported; }
inline int cudaGraphAddNode(cudaGraphNode_t*, cudaGraph_t, const cudaGraphNode_t*, size_t,
                            cudaGraphNodeParams*) { return cudaErrorNotSupported; }
inline int cudaGraphInstantiate(cudaGraphExec_t*, cudaGraph_t, unsigned long long) {
  return cudaErrorNotSupported;
}
inline int cudaGraphLaunch(cudaGraphExec_t, cudaStream_t) { return cudaErrorNotSupported; }
inline int cudaGraphExecDestroy(cudaGraphExec_t) { return cudaErrorNotSupported; }
inline int cudaGraphDestroy(cudaGraph_t) { return cudaErrorNotSupported; }
inline void cudaGraphSetConditional(cudaGraphConditionalHandle, unsigned) {}

struct MockBarrier {
  unsigned gen = 0, count = 0;
};

// An mbarrier: the arrivals still expected in the current phase, the
// transaction bytes still expected, and the number of completed phases.
struct MockMbar {
  unsigned count = 0, pending = 0, phases = 0;
  long long tx = 0;
};

constexpr size_t kMockSmem = 256 * 1024;  // the most a block may ask for here

// One block of the running cluster: its fibers, barriers and shared memory.
struct MockBlock {
  dim3 idx;
  unsigned rank = 0;  // in its cluster
  unsigned char* smem = nullptr;  // 1024-byte aligned, as the 128-byte swizzle's phase needs
  std::vector<ucontext_t> ctx;
  std::vector<char> done;
  MockBarrier bar;
  std::vector<MockBarrier> warp;
  std::vector<float> xch;          // two exchange buffers of one float per thread
  std::vector<char> shfl_parity;  // per thread: the buffer of its last exchange
  std::vector<uint32_t> frag;  // 6 words per thread: an mma's A and B fragments
  std::vector<MockBarrier> named;  // bar.sync ids 0..15
  std::vector<MockBarrier> wgroup;  // one per warpgroup (wgmma is collective)
  std::vector<MockMbar> mbar;       // indexed by shared-memory offset / 8
};

struct MockCluster {
  int nt = 0;                     // threads per block
  std::vector<MockBlock> blocks;  // its blocks, by rank
  ucontext_t* cur = nullptr;      // the running fiber
  ucontext_t sched;
  const std::function<void()>* body = nullptr;
  MockBarrier cbar;  // barrier.cluster
};
inline thread_local MockCluster* mock_cl = nullptr;
inline thread_local MockBlock* mock_ctx = nullptr;  // the running fiber's block
inline thread_local unsigned long mock_progress = 0;  // barrier arrivals and finished fibers

// The running block's dynamic shared memory.
#define mock_smem (mock_ctx->smem)

inline void mock_yield() { swapcontext(mock_cl->cur, &mock_cl->sched); }

inline void mock_barrier(MockBarrier& b, unsigned n) {
  const unsigned g = b.gen;
  ++mock_progress;
  if (++b.count == n) {
    b.count = 0;
    ++b.gen;
    return;
  }
  while (b.gen == g) mock_yield();
}

inline void __syncthreads() { mock_barrier(mock_ctx->bar, mock_cl->nt); }
inline void mock_warp_sync() { mock_barrier(mock_ctx->warp[threadIdx.x / 32], 32); }
inline void __syncwarp(unsigned = 0xffffffffu) { mock_warp_sync(); }

// A warp exchange: each lane publishes v, then reads lane `src`'s. Lanes
// alternate between two buffers, so one barrier suffices: a lane can start
// the next exchange early, but not the one after it before every lane has
// read this one.
inline float mock_shfl(float v, int src) {
  const int tid = threadIdx.x, w = tid / 32;
  const int buf = mock_ctx->shfl_parity[tid] ^= 1;
  float* x = mock_ctx->xch.data() + buf * mock_ctx->xch.size() / 2;
  x[tid] = v;
  mock_warp_sync();
  return x[w * 32 + (src & 31)];
}
inline float __shfl_xor_sync(unsigned, float v, int off) {
  return mock_shfl(v, (threadIdx.x % 32) ^ off);
}
inline float __shfl_sync(unsigned, float v, int src) { return mock_shfl(v, src); }

inline void mock_fiber_entry() {
  (*mock_cl->body)();
  mock_ctx->done[threadIdx.x] = 1;
  ++mock_progress;
}  // returns to mock_cl->sched through uc_link

// Runs `kernel(args...)` over `grid` in clusters of `cluster` blocks along
// x (which must divide grid.x); each cluster's blocks run together.
template <class K, class... A>
void mock_launch_cluster(unsigned cluster, K kernel, dim3 grid, dim3 block, size_t smem,
                         A... args) {
  constexpr size_t kStack = 256 * 1024;
  gridDim = grid;
  blockDim = block;
  const int nt = block.x * block.y * block.z;
  if (smem > kMockSmem || nt % 32 || cluster == 0 || grid.x % cluster) std::abort();
  const std::function<void()> body = [&] { kernel(args...); };
  MockCluster cl;
  cl.nt = nt;
  cl.body = &body;
  cl.blocks.resize(cluster);
  // Stacks are touched only as deep as a fiber goes (new[] leaves them
  // uncommitted), so a cluster of 8 blocks costs what its fibers use.
  std::vector<std::unique_ptr<char[]>> stacks(cluster * nt);
  for (auto& s : stacks) s.reset(new char[kStack]);
  std::vector<std::unique_ptr<unsigned char[]>> smems(cluster);
  for (unsigned r = 0; r < cluster; ++r) {
    smems[r].reset(new unsigned char[kMockSmem + 1024]);
    const uintptr_t a = reinterpret_cast<uintptr_t>(smems[r].get());
    MockBlock& b = cl.blocks[r];
    b.smem = smems[r].get() + ((1024 - a % 1024) % 1024);
    b.rank = r;
    b.ctx.resize(nt);
    b.xch.assign(2 * nt, 0.f);
    b.frag.assign(6 * nt, 0u);
  }
  mock_cl = &cl;
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x0 = 0; x0 < grid.x; x0 += cluster) {
        cl.cbar = MockBarrier{};
        for (unsigned r = 0; r < cluster; ++r) {
          MockBlock& b = cl.blocks[r];
          std::memset(b.smem, 0xff, smem);
          b.idx = dim3(x0 + r, y, z);
          b.bar = MockBarrier{};
          b.warp.assign(nt / 32, MockBarrier{});
          b.named.assign(16, MockBarrier{});
          b.wgroup.assign((nt + 127) / 128, MockBarrier{});
          b.mbar.assign(smem / 8 + 1, MockMbar{});
          b.done.assign(nt, 0);
          b.shfl_parity.assign(nt, 0);
          for (int t = 0; t < nt; ++t) {
            getcontext(&b.ctx[t]);
            b.ctx[t].uc_stack.ss_sp = stacks[r * nt + t].get();
            b.ctx[t].uc_stack.ss_size = kStack;
            b.ctx[t].uc_link = &cl.sched;
            makecontext(&b.ctx[t], mock_fiber_entry, 0);
          }
        }
        for (int left = 1; left > 0;) {
          const unsigned long before = mock_progress;
          left = 0;
          for (MockBlock& b : cl.blocks)
            for (int t = 0; t < nt; ++t) {
              if (b.done[t]) continue;
              mock_ctx = &b;
              cl.cur = &b.ctx[t];
              threadIdx = dim3(t);
              blockIdx = b.idx;
              swapcontext(&cl.sched, &b.ctx[t]);
              left += !b.done[t];
            }
          if (left > 0 && mock_progress == before) std::abort();  // threads diverged at a barrier
        }
      }
  mock_cl = nullptr;
  mock_ctx = nullptr;
}

// Stands in for `kernel<<<grid, block, smem, stream>>>(args...)`.
template <class K, class... A>
void mock_launch(K kernel, dim3 grid, dim3 block, size_t smem, cudaStream_t, A... args) {
  mock_launch_cluster(1, kernel, grid, block, smem, args...);
}
