// Self-checks of the Hopper primitives in sm90.cuh, each a small kernel
// with a C entry, run against a plain product or copy on the card by
// chip_smoke.py (before the attention kernels are trusted) and
// tests/test_torch_gpu.py, and under the CPU emulator by
// tests/test_torch_cuda_emulation.py:
//
// - gofr_sm90_wgmma_test: one warpgroup's D(64 x N) = A(64 x 128) . B(128
//   x N) in 8 k-steps of wgmma m64nNk16 (N 64 or 128), A from swizzled
//   shared memory or from registers, B K-major (stored [N, 128], as K in
//   S = Q.K^T) or MN-major (stored [128, N], as V in O = P.V). The tiles are
//   written by cp.async through sm90::tile_chunk, the layout the attention
//   kernels use, so a wrong swizzle or descriptor shows here as a wrong
//   product.
// - gofr_sm90_ring_test: a producer warpgroup streams n_tiles tiles through
//   a ring of 3 shared-memory stages (cp.async, full/empty mbarriers) to a
//   consumer warpgroup that copies them out rotated by 37 threads; the
//   ring's phases wrap every 3 tiles.
// - gofr_sm90_tma_test: one TMA box of 128 rows x 64 columns from a
//   [rows, cols] bf16 matrix at row r0, unswizzled into [128, 64]; rows past
//   the matrix must arrive as zeros.
// - gofr_sm90_bulk_test: one warp; lane 0 announces and issues a 1-D bulk
//   copy of `bytes` bytes into shared memory while every lane copies some of
//   `n_words` 4-byte words by cp.async and arrives when they land (the int8
//   scales' path in flash_decode.cu); one mbarrier phase covers both, and
//   the block copies shared memory back out.
// - gofr_sm90_cluster_test: a cluster of 4 blocks; each writes its 128
//   words into its shared memory, and after the cluster barrier reads its
//   neighbour's (rank + 1) through distributed shared memory, rotated by 37
//   threads, and writes them out with its rank.
//
// Not on any main path: none of these is a ported kernel.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"
#include "attn_sm90.cuh"

namespace {

constexpr int kK = 128;  // depth of the test product

template <int N>
__global__ void __launch_bounds__(128) wgmma_test_kernel(const __nv_bfloat16* __restrict__ a,
                                                         const __nv_bfloat16* __restrict__ b,
                                                         float* __restrict__ d, int b_mn_major,
                                                         int a_regs) {
  unsigned char* smem = sm90::dyn_smem();
  unsigned char* sA = smem;                // [64, kK], K-major
  unsigned char* sB = smem + 64 * kK * 2;  // [N, kK] K-major or [kK, N] MN-major
  const int t = threadIdx.x;
  for (int ch = t; ch < 64 * kK / 8; ch += 128)
    sm90::cp_async16(sA + sm90::tile_chunk(ch / (kK / 8), ch % (kK / 8), 64), a + ch * 8, true);
  if (b_mn_major) {
    for (int ch = t; ch < kK * N / 8; ch += 128)
      sm90::cp_async16(sB + sm90::tile_chunk(ch / (N / 8), ch % (N / 8), kK), b + ch * 8, true);
  } else {
    for (int ch = t; ch < N * kK / 8; ch += 128)
      sm90::cp_async16(sB + sm90::tile_chunk(ch / (kK / 8), ch % (kK / 8), N), b + ch * 8, true);
  }
  sm90::cp_async_commit();
  sm90::cp_async_wait<0>();
  sm90::fence_async_shared();
  __syncthreads();

  const int w = t / 32, g = (t % 32) / 4, q = t % 4;
  uint32_t ar[kK / 16][4];  // A registers: rows 16w + g (+8), columns 16ks + 2q (+8)
#pragma unroll
  for (int ks = 0; ks < kK / 16; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      ar[ks][i] = *reinterpret_cast<const uint32_t*>(
          a + (16 * w + g + 8 * (i & 1)) * kK + 16 * ks + 2 * q + 8 * (i >> 1));
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  sm90::fence_operand(acc);
  sm90::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kK / 16; ++ks) {
    const uint64_t da = sm90::desc_sw128(sA + (ks >> 2) * 64 * 128 + (ks & 3) * 32, 0, 1024);
    if (b_mn_major) {
      const uint64_t db = sm90::desc_sw128(sB + ks * 16 * 128, kK * 128, 1024);
      if (a_regs) sm90::wgmma_rs<N, 1>(acc, ar[ks], db, 1);
      else sm90::wgmma_ss<N, 1>(acc, da, db, 1);
    } else {
      const uint64_t db = sm90::desc_sw128(sB + (ks >> 2) * N * 128 + (ks & 3) * 32, 0, 1024);
      if (a_regs) sm90::wgmma_rs<N, 0>(acc, ar[ks], db, 1);
      else sm90::wgmma_ss<N, 0>(acc, da, db, 1);
    }
  }
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_operand(acc);
#pragma unroll
  for (int i = 0; i < N / 2; ++i)
    d[(16 * w + g + 8 * ((i >> 1) & 1)) * N + 8 * (i / 4) + 2 * q + (i & 1)] = acc[i];
}

constexpr int kRingStages = 3;

__global__ void __launch_bounds__(256) ring_test_kernel(const uint4* __restrict__ src,
                                                        uint4* __restrict__ dst, int n_tiles) {
  unsigned char* smem = sm90::dyn_smem();
  uint4* tiles = reinterpret_cast<uint4*>(smem);  // kRingStages x 128 chunks
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kRingStages * 128 * 16);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRingStages; ++s) {
      sm90::mbar_init(&bars[s], 128);                // full
      sm90::mbar_init(&bars[kRingStages + s], 128);  // empty
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();
  const int t = threadIdx.x % 128;
  attn::Ring<kRingStages> ring;
  if (threadIdx.x >= 128) {  // producer
    for (int it = 0; it < n_tiles; ++it) {
      sm90::mbar_wait(&bars[kRingStages + ring.stage], ring.phase ^ 1u);
      sm90::cp_async16(&tiles[ring.stage * 128 + t], src + it * 128 + t, true);
      sm90::cp_async_commit();
      sm90::cp_async_wait<0>();
      sm90::fence_async_shared();
      sm90::mbar_arrive(&bars[ring.stage]);
      ring.next();
    }
  } else {  // consumer: reads what another producer thread wrote
    for (int it = 0; it < n_tiles; ++it) {
      sm90::mbar_wait(&bars[ring.stage], ring.phase);
      dst[it * 128 + t] = tiles[ring.stage * 128 + (t + 37) % 128];
      sm90::mbar_arrive(&bars[kRingStages + ring.stage]);
      ring.next();
    }
  }
}

__global__ void __launch_bounds__(128) tma_test_kernel(const __grid_constant__ CUtensorMap map,
                                                       int r0, __nv_bfloat16* __restrict__ dst) {
  unsigned char* smem = sm90::dyn_smem();
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + 128 * 128);
  if (threadIdx.x == 0) {
    sm90::mbar_init(bar, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    sm90::mbar_arrive_expect_tx(bar, 128 * 128);
    sm90::tma_load_4d(smem, &map, bar, 0, 0, r0, 0);
  }
  sm90::mbar_wait(bar, 0);
  for (int ch = threadIdx.x; ch < 128 * 8; ch += 128)
    *reinterpret_cast<uint4*>(dst + ch * 8) =
        *reinterpret_cast<const uint4*>(smem + sm90::tile_chunk(ch / 8, ch % 8, 128));
}

__global__ void __launch_bounds__(32) bulk_test_kernel(const unsigned char* __restrict__ src,
                                                       int bytes,
                                                       const uint32_t* __restrict__ words,
                                                       int n_words, unsigned char* __restrict__ dst,
                                                       uint32_t* __restrict__ dst_words) {
  unsigned char* smem = sm90::dyn_smem();
  uint32_t* sw = reinterpret_cast<uint32_t*>(smem + bytes);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sw + ((n_words + 3) & ~3));
  const int lane = threadIdx.x;
  if (lane == 0) {
    sm90::mbar_init(bar, 1 + 32);  // the bulk copy's announcer and 32 cp.async arrivals
    sm90::mbar_fence_init();
  }
  __syncthreads();
  if (lane == 0) {
    sm90::mbar_arrive_expect_tx(bar, bytes);
    sm90::bulk_load(smem, src, bytes, bar);
  }
  for (int i = lane; i < n_words; i += 32) sm90::cp_async4(&sw[i], &words[i]);
  sm90::cp_async_mbar_arrive(bar);
  sm90::mbar_wait(bar, 0);
  for (int i = lane; i < bytes / 16; i += 32)
    reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(smem)[i];
  for (int i = lane; i < n_words; i += 32) dst_words[i] = sw[i];
}

constexpr int kClusterTest = 4;

__global__ void __launch_bounds__(128) cluster_test_kernel(const uint32_t* __restrict__ src,
                                                           uint32_t* __restrict__ dst,
                                                           uint32_t* __restrict__ ranks) {
  uint32_t* mine = reinterpret_cast<uint32_t*>(sm90::dyn_smem());
  const uint32_t rank = sm90::cluster_rank();
  const int t = threadIdx.x;
  mine[t] = src[blockIdx.x * 128 + t];
  sm90::cluster_sync();  // every block's words are written
  const uint32_t* peer = sm90::cluster_map(mine, (rank + 1) % sm90::cluster_size());
  dst[blockIdx.x * 128 + t] = peer[(t + 37) % 128];
  if (t == 0) ranks[blockIdx.x] = rank;
  sm90::cluster_sync();  // no block leaves while a peer still reads its memory
}

}  // namespace

// src: `bytes` bytes (a multiple of 16, 16-byte aligned); words: n_words
// uint32; dst, dst_words alike. Returns the cudaError_t of the launch.
extern "C" int gofr_sm90_bulk_test(const void* src, void* dst, int bytes, const void* words,
                                   void* dst_words, int n_words, void* stream) {
  if (bytes <= 0 || bytes % 16 || n_words < 0) return cudaErrorInvalidValue;
  const size_t smem = bytes + 4 * ((n_words + 3) & ~3) + 8 + 1024;
  const cudaError_t err = cudaFuncSetAttribute(
      bulk_test_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  bulk_test_kernel<<<1, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(src), bytes, static_cast<const uint32_t*>(words),
      n_words, static_cast<unsigned char*>(dst), static_cast<uint32_t*>(dst_words));
  return cudaGetLastError();
}

// src, dst: [n_clusters * 4, 128] uint32; ranks: [n_clusters * 4] uint32.
// dst[b][t] = src[peer][(t + 37) % 128] with peer the next block of b's
// cluster; ranks[b] = b's rank in it.
extern "C" int gofr_sm90_cluster_test(const void* src, void* dst, void* ranks, int n_clusters,
                                      void* stream) {
  if (n_clusters <= 0) return cudaErrorInvalidValue;
  return sm90::launch_cluster(cluster_test_kernel, dim3(n_clusters * kClusterTest), dim3(128),
                              128 * 4 + 1024, static_cast<cudaStream_t>(stream),
                              kClusterTest, static_cast<const uint32_t*>(src),
                              static_cast<uint32_t*>(dst), static_cast<uint32_t*>(ranks));
}

// a: [64, 128] bf16; b: [n, 128] (b_mn_major 0) or [128, n] (1) bf16;
// d: [64, n] f32; n 64 or 128; a_regs: A from registers. Returns the
// cudaError_t of the launch.
extern "C" int gofr_sm90_wgmma_test(const void* a, const void* b, void* d, int n, int b_mn_major,
                                    int a_regs, void* stream) {
  const size_t smem = (64 + n) * kK * 2 + 1024;
  cudaStream_t sm = static_cast<cudaStream_t>(stream);
  auto run = [&](auto kernel) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<1, 128, smem, sm>>>(static_cast<const __nv_bfloat16*>(a),
                                 static_cast<const __nv_bfloat16*>(b), static_cast<float*>(d),
                                 b_mn_major, a_regs);
    return (int)cudaGetLastError();
  };
  if (n == 64) return run(wgmma_test_kernel<64>);
  if (n == 128) return run(wgmma_test_kernel<128>);
  return cudaErrorInvalidValue;
}

// src, dst: n_tiles x 128 chunks of 16 bytes. dst[i][t] = src[i][(t + 37) % 128].
extern "C" int gofr_sm90_ring_test(const void* src, void* dst, int n_tiles, void* stream) {
  const size_t smem = kRingStages * 128 * 16 + 2 * kRingStages * 8 + 1024;
  ring_test_kernel<<<1, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), static_cast<uint4*>(dst), n_tiles);
  return cudaGetLastError();
}

// src: [rows, cols] bf16 (cols a multiple of 8, at least 64); dst: [128,
// 64] bf16, rows r0.. of src's first 64 columns, zeros past its end.
extern "C" int gofr_sm90_tma_test(const void* src, void* dst, int rows, int cols, int r0,
                                  void* stream) {
  CUtensorMap map;
  const uint64_t dims[4] = {(uint64_t)cols, 1, (uint64_t)rows, 1};
  const uint64_t strides[3] = {(uint64_t)cols * 2, (uint64_t)cols * 2, (uint64_t)rows * cols * 2};
  const uint32_t box[4] = {64, 1, 128, 1};
  const int err = sm90::make_tensor_map_bf16(&map, src, dims, strides, box);
  if (err != cudaSuccess) return err;
  const size_t smem = 128 * 128 + 8 + 1024;
  tma_test_kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      map, r0, static_cast<__nv_bfloat16*>(dst));
  return cudaGetLastError();
}
