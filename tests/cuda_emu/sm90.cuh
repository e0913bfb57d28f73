// Emulation of gofr_tpu_torch/csrc/sm90.cuh on the CPU (see cuda_mock.h):
// the same functions, with the semantics the kernels rely on.
//
// - wgmma is a warpgroup collective (a barrier over its 128 fibers, so a
//   kernel whose warpgroup diverges at one deadlocks and aborts). Each thread
//   computes its own accumulator elements (the documented m64nNk16 layout)
//   from A and B read through the operand descriptors: start address, LBO,
//   SBO and the 128-byte swizzle, K-major or MN-major (TRANS_B); register A
//   is gathered from the warp's fragments in the documented layout. Products
//   complete at issue (commit and wait are no-ops).
// - mbarrier: arrivals and transaction bytes complete a phase; a wait
//   yields the fiber until the phase of the given parity has completed.
// - cp.async, the 1-D bulk copy and TMA copy at issue (zero fill where not
//   valid or out of bounds); the bulk copy and TMA complete their bytes on
//   the barrier, and cp.async's barrier arrival is immediate. TMA writes the 128-byte-swizzled box and completes its bytes
//   on the barrier, and its tensor map is checked as cuTensorMapEncodeTiled checks it
//   (16-byte aligned base and strides, an inner box of 128 bytes at most).
// - Clusters: the blocks of a cluster run together (cuda_mock.h); the
//   cluster barrier is a barrier over all their threads, and mapa maps an
//   address to the same offset in a peer block's shared memory.
// - Named barriers are barriers over their thread count; setmaxnreg and the
//   proxy and operand fences are no-ops.
//
// The swizzle formula sw128 is shared by the kernels' own cp.async
// placement, the emulated TMA and the emulated wgmma, so the emulator
// checks that they agree with each other and with the descriptors the
// kernels build, not the formula itself: only the card checks that
// (chip_smoke.py's pre-phase, tests/test_torch_gpu.py, through
// csrc/sm90_selftest.cu).
#pragma once
#include "cuda.h"

namespace sm90 {

constexpr uint32_t sw128(uint32_t off) { return off ^ (((off >> 7) & 7u) << 4); }

constexpr uint32_t tile_chunk(int row, int chunk, int rows) {
  return sw128((uint32_t)((chunk >> 3) * rows * 128 + row * 128 + (chunk & 7) * 16));
}

inline uint32_t smem_addr(const void* p) {
  return (uint32_t)(static_cast<const unsigned char*>(p) - mock_smem);
}

inline unsigned char* dyn_smem() { return mock_smem; }

// ---- mbarrier -------------------------------------------------------------

inline MockMbar& mock_mbar(uint64_t* bar) { return mock_ctx->mbar[smem_addr(bar) / 8]; }

inline void mock_mbar_settle(MockMbar& b) {
  if (b.pending == 0 && b.tx == 0) {
    ++b.phases;
    b.pending = b.count;
  }
}

inline void mbar_init(uint64_t* bar, uint32_t count) {
  MockMbar& b = mock_mbar(bar);
  b = MockMbar{};
  b.count = b.pending = count;
}

inline void mbar_fence_init() {}

inline void mbar_arrive(uint64_t* bar) {
  MockMbar& b = mock_mbar(bar);
  if (b.pending == 0) std::abort();  // more arrivals than the phase expects
  --b.pending;
  ++mock_progress;
  mock_mbar_settle(b);
}

inline void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  mock_mbar(bar).tx += bytes;
  mbar_arrive(bar);
}

inline void mock_complete_tx(uint64_t* bar, uint32_t bytes) {
  MockMbar& b = mock_mbar(bar);
  b.tx -= bytes;
  ++mock_progress;
  mock_mbar_settle(b);
}

inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  while ((mock_mbar(bar).phases & 1u) == parity) mock_yield();
}

inline void cp_async_mbar_arrive(uint64_t* bar) { mbar_arrive(bar); }

// ---- cp.async -------------------------------------------------------------

inline void cp_async16(void* smem, const void* gmem, bool valid) {
  if (valid) std::memcpy(smem, gmem, 16);
  else std::memset(smem, 0, 16);
}
inline void cp_async_commit() {}
template <int N>
inline void cp_async_wait() {}
inline void fence_async_shared() {}

// A 4-byte cp.async; the arrival that waits for this thread's cp.asyncs
// (.noinc: counted in the barrier's init count) arrives at once, since the
// copies land at issue.
inline void cp_async4(void* smem, const void* gmem) { std::memcpy(smem, gmem, 4); }
inline void cp_async_mbar_arrive(uint64_t* bar);

// ---- bulk copies and clusters ----------------------------------------------

// The 1-D bulk copy: lands at issue and completes its bytes on the barrier;
// aborts on what the card refuses (a size or an address that is not a
// multiple of 16 bytes).
inline void bulk_load(void* smem, const void* gmem, uint32_t bytes, uint64_t* bar) {
  if (smem_addr(smem) % 16 || reinterpret_cast<uintptr_t>(gmem) % 16 || bytes % 16 ||
      smem_addr(smem) + bytes > kMockSmem)
    std::abort();
  std::memcpy(smem, gmem, bytes);
  mock_complete_tx(bar, bytes);
}

inline uint32_t cluster_rank() { return mock_ctx->rank; }
inline uint32_t cluster_size() { return (uint32_t)mock_cl->blocks.size(); }

// A barrier over every thread of every block of the cluster.
inline void cluster_sync() {
  mock_barrier(mock_cl->cbar, (unsigned)(mock_cl->nt * mock_cl->blocks.size()));
}

// `p` (in this block's shared memory) in block `rank` of the cluster.
template <typename T>
inline T* cluster_map(T* p, uint32_t rank) {
  if (rank >= mock_cl->blocks.size()) std::abort();
  const uint32_t off = smem_addr(p);
  return reinterpret_cast<T*>(mock_cl->blocks[rank].smem + off);
}

// Stands in for a cudaLaunchKernelEx with a cluster dimension of `cluster`
// along x.
template <class K, class... A>
inline cudaError_t launch_cluster(K kernel, dim3 grid, dim3 block, size_t smem, cudaStream_t,
                                  unsigned cluster, A... args) {
  mock_launch_cluster(cluster, kernel, grid, block, smem, args...);
  return cudaSuccess;
}

// The emulator runs one cluster at a time; this stands in for an H100's
// 132 SMs at one block each, which only a wrapper on a card asks for.
template <class K>
inline int max_active_clusters(K, dim3, size_t, unsigned cluster) {
  return 132 / (int)cluster;
}

// ---- TMA ------------------------------------------------------------------

inline void tma_load_4d(void* smem, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2,
                        int c3) {
  unsigned char* dst = static_cast<unsigned char*>(smem);
  if (smem_addr(dst) % 1024) std::abort();  // the swizzle needs 1024-byte alignment
  const uint32_t* box = map->box;
  const int c[4] = {c0, c1, c2, c3};
  uint32_t linear = 0;
  for (uint32_t i3 = 0; i3 < box[3]; ++i3)
    for (uint32_t i2 = 0; i2 < box[2]; ++i2)
      for (uint32_t i1 = 0; i1 < box[1]; ++i1)
        for (uint32_t i0 = 0; i0 < box[0]; ++i0, linear += 2) {
          const long long x[4] = {c[0] + (long long)i0, c[1] + (long long)i1,
                                  c[2] + (long long)i2, c[3] + (long long)i3};
          uint16_t v = 0;
          bool in = true;
          for (int d = 0; d < 4; ++d) in = in && x[d] >= 0 && x[d] < (long long)map->dims[d];
          if (in)
            std::memcpy(&v, map->base + x[0] * 2 + x[1] * map->strides[0] +
                                x[2] * map->strides[1] + x[3] * map->strides[2], 2);
          std::memcpy(dst + sw128(linear), &v, 2);
        }
  mock_complete_tx(bar, linear);
}

inline int make_tensor_map_bf16(CUtensorMap* map, const void* base, const uint64_t (&dims)[4],
                                const uint64_t (&strides)[3], const uint32_t (&box)[4]) {
  if (reinterpret_cast<uintptr_t>(base) % 16 || box[0] * 2 > 128) return cudaErrorInvalidValue;
  for (int d = 0; d < 4; ++d)
    if (dims[d] == 0 || box[d] == 0 || box[d] > 256) return cudaErrorInvalidValue;
  for (int d = 0; d < 3; ++d)
    if (strides[d] % 16) return cudaErrorInvalidValue;
  map->base = static_cast<const unsigned char*>(base);
  for (int d = 0; d < 4; ++d) map->dims[d] = dims[d], map->box[d] = box[d];
  for (int d = 0; d < 3; ++d) map->strides[d] = strides[d];
  return cudaSuccess;
}

// ---- wgmma ----------------------------------------------------------------

inline uint64_t desc_sw128(const void* smem, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr(smem) & 0x3FFFFu) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) | (1ull << 62);
}

inline void wgmma_fence() {}
inline void wgmma_commit() {}
template <int N>
inline void wgmma_wait() {}
template <int M>
inline void fence_operand(float (&)[M]) {}

inline void mock_warpgroup_sync() { mock_barrier(mock_ctx->wgroup[threadIdx.x / 128], 128); }

// Element (row, k) of a K-major operand (row = M or N index, k < 16) or
// (k, col) of an MN-major one, read through its descriptor.
inline float mock_desc_read(uint64_t desc, int mn, int k, bool mn_major) {
  if ((desc >> 62) != 1) std::abort();  // only the 128-byte swizzle is emulated
  const uint32_t start = (uint32_t)(desc & 0x3FFFu) << 4;
  const uint32_t lbo = (uint32_t)((desc >> 16) & 0x3FFFu) << 4;
  const uint32_t sbo = (uint32_t)((desc >> 32) & 0x3FFFu) << 4;
  const uint32_t addr =
      mn_major ? start + (mn % 64) * 2 + (mn / 64) * lbo + (k % 8) * 128 + (k / 8) * sbo
               : start + (mn % 8) * 128 + (mn / 8) * sbo + k * 2;
  uint16_t v;
  std::memcpy(&v, mock_smem + sw128(addr), 2);
  return __bfloat162float(__nv_bfloat16{v});
}

// This thread's accumulator elements: d[4j + e] = D[16w + g + 8(e/2)][8j + 2q + e%2].
template <int N, class A>
inline void mock_wgmma(float (&d)[N / 2], A a_at, uint64_t desc_b, bool trans_b, int scale_d) {
  const int t = threadIdx.x % 128, w = t / 32, g = (t % 32) / 4, q = t % 4;
  for (int i = 0; i < N / 2; ++i) {
    const int row = 16 * w + g + 8 * ((i >> 1) & 1), col = 8 * (i / 4) + 2 * q + (i & 1);
    float acc = scale_d ? d[i] : 0.f;
    for (int k = 0; k < 16; ++k) acc += a_at(row, k) * mock_desc_read(desc_b, col, k, trans_b);
    d[i] = acc;
  }
}

template <int N, int TRANS_B>
inline void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  mock_warpgroup_sync();
  mock_wgmma<N>(d, [&](int row, int k) { return mock_desc_read(desc_a, row, k, false); }, desc_b,
                TRANS_B, scale_d);
}

template <int N, int TRANS_B>
inline void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  const int tid = threadIdx.x, wbase = tid / 32 * 32;
  uint32_t* f = mock_ctx->frag.data();
  for (int i = 0; i < 4; ++i) f[6 * tid + i] = a[i];
  mock_warpgroup_sync();
  // A[16w + r][k] is a[(r >= 8) + 2 (k >= 8)] of lane (r % 8) * 4 + (k % 8) / 2.
  auto a_at = [&](int row, int k) {
    const int r = row % 16, reg = (r >= 8 ? 1 : 0) + (k >= 8 ? 2 : 0);
    const uint32_t word = f[6 * (wbase + (r % 8) * 4 + (k % 8) / 2) + reg];
    return __uint_as_float((k % 2) ? (word & 0xffff0000u) : (word << 16));
  };
  mock_wgmma<N>(d, a_at, desc_b, TRANS_B, scale_d);
  mock_warpgroup_sync();
}

// ---- registers and named barriers -----------------------------------------

template <int R>
inline void reg_alloc() {}
template <int R>
inline void reg_dealloc() {}

inline void named_bar_sync(int id, int n) { mock_barrier(mock_ctx->named[id], n); }

inline float exp2_approx(float x) { return std::exp2(x); }

inline uint32_t pack_bf16x2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}

}  // namespace sm90
