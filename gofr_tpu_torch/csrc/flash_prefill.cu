// flash_cache_attention for Hopper (sm_90a): a [P, c] chunk of queries per
// row attends its slot's KV-cache prefix in place (chunked prefill).
//
// Replaces: gofr_tpu/ops/pallas/flash_prefill.py::flash_cache_attention (bf16
// or int8 cache, contiguous or paged, with or without the sliding window).
// Row p's query t sits at global position starts[p] + t and sees keys
// [0, starts[p] + t] of cache slot slots[p] (with a window > 0 only those
// above starts[p] + t - window); the chunk's own K/V are already written
// there. Rows with t >= lens[p] return 0.
//
// What bounds it on the H100: operations. A chunk of c queries against a
// context of n keys does 4 * c * n * n_heads * hd FLOPs over
// (n * n_kv + c * n_heads) * hd * 2 bytes, hundreds of FLOPs per byte once the
// context passes a few hundred keys, so the floor is the FLOPs over
// 989 TFLOP/s bf16 (the tensor-core rate).
//
// What the design does about it: the mainloop of attn_sm90.cuh. Both
// products run on wgmma (the only way to the tensor cores' full rate), from
// 128-byte-swizzled shared-memory tiles; one block per (row p, kv head, 128
// query rows), two consumer warpgroups of 64 rows and one producer
// warpgroup. Queries are grouped kv-head-major with row = t * rep + head,
// as in the TPU kernel, so the rep query heads of a kv head share each K/V
// stage and the causal bound of a row is starts[p] + row / rep. Key rows
// come through a slot index, optionally a block table, optionally int8, so
// the producer copies them with cp.async (16 bytes a thread, written into
// the swizzled layout by hand) into a ring of 2 stages of 128 keys (64 at
// hd 256, where Q and two stages of 128 keys would not fit in shared
// memory) that runs ahead of the consumers; the same code path serves
// every cache kind.
// The key-tile loop stops at the last key any row of the block can see, so
// the cost follows the true context. Scores and the online softmax state
// (running max, denominator) are f32 in registers, and the probabilities
// feed P.V from registers, rounded to bf16.
//
// Window: the key tiles start at the window edge of the block's first
// query row, max(0, starts[p] + t_lo - window + 1), the loosest edge of its
// rows, rounded down to 64 keys, so keys wholly below it are never read;
// each row's own edge is a second bound beside the causal one on the tiles
// that straddle it. Tiles depend only on starts, lens and the window, never
// on the cache kind, so a windowed pool still equals the windowed slot
// cache bit for bit. Whether the edge compare exists is a template flag
// chosen at launch, so window = 0 compiles to the unwindowed loop.
//
// Paged: logical key j of slot slots[p] lives in pool block
// table[slots[p]][j / B] at offset j % B. The block copies the entries of
// that table row its keys need (from its first kept tile on) into shared
// memory once; each staged key row computes its address from it, so a
// 128-key tile may span several pool blocks, and a pool gives the
// contiguous cache's result bit for bit. Rows
// past the tile's last visible key are never read (the parking block 0 and
// unallocated entries hold garbage).
//
// Int8: the raw rows land by cp.async in a staging tile, and the producer
// widens them exactly to bf16 into the stage's wgmma tiles, so the
// consumers stay on the tensor cores and both products are unchanged; the
// tile's K and V scales (one f32 per key) are staged beside them. At hd 256
// the staging area holds one raw tile, K's and then V's: with room for both
// (32 KB) the int8 layout would pass the 227 KB of shared memory by 40
// bytes at a table of 256 entries (Mistral-length rows in blocks of 32). As in
// the TPU kernel, scores are (q.k) * scale * k_scale[j], the denominator
// takes the probabilities before the V scale, and only P is multiplied by
// v_scale[j] before it is rounded to bf16.


#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"
#include "attn_sm90.cuh"

namespace {

using attn::kBQ;
constexpr int kStages = 2;
constexpr int kProducers = attn::kThreads - attn::kConsumerThreads;

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16(x));
}

// Eight int8 values (a uint2), widened exactly to eight bf16 (a uint4).
__device__ __forceinline__ uint4 widen8(uint2 raw) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t word = (i < 2 ? raw.x : raw.y) >> (16 * (i % 2));
    w[i] = bf16_bits((float)(int8_t)(word & 0xffu)) |
           (bf16_bits((float)(int8_t)((word >> 8) & 0xffu)) << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// q, out: [P, c, n_heads, HD] bf16; caches T (bf16 or int8): [S, n_kv, B,
// HD] (contiguous, B = max_len) or a pool [n_blocks, n_kv, B, HD] with
// block_table [S, n_tab] int32 (n_tab = 0: contiguous); k_scale/v_scale
// (int8 only): f32, the caches' shape without HD; slots, starts, lens: [P]
// int32; window: sliding window (WINDOW: window > 0). Grid (ceil(c * rep /
// BQ), n_kv, P).
template <typename T, int HD, bool WINDOW>
__global__ void __launch_bounds__(attn::kThreads, 1) flash_cache_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const T* __restrict__ k_cache,
    const T* __restrict__ v_cache, const int* __restrict__ slots,
    const int* __restrict__ starts, const int* __restrict__ lens,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int* __restrict__ block_table, __nv_bfloat16* __restrict__ out,
    int c, int n_heads, int n_kv, int B, int n_tab, int window, float scale) {
  constexpr bool kQuant = sizeof(T) == 1;
  constexpr int HDP = attn::padded<HD>();
  constexpr int CH = HDP / 8;  // 16-byte bf16 chunks of a tile row
  constexpr int BK = attn::block_keys<HD>();
  constexpr int kRaw = attn::staging_tiles<HD>();  // raw int8 tiles staged at once

  const int tile = blockIdx.x;
  const int kvh = blockIdx.y;
  const int p = blockIdx.z;
  const int rep = n_heads / n_kv;
  const int n_rows = c * rep;
  const int r0 = tile * kBQ;
  const int slot = slots[p];
  const int start = starts[p];
  const int len = max(0, min(lens[p], c));

  // Offset of global query row r (t = r / rep, head kvh * rep + r % rep).
  auto row_off = [&](int r) -> size_t {
    const int t = r / rep;
    return (((size_t)p * c + t) * n_heads + (size_t)kvh * rep + (r - t * rep)) * HD;
  };
  // The last key query row r sees (its global position); -1 for padding.
  auto last_key = [&](int r) -> int {
    return (r < n_rows && r / rep < len) ? start + r / rep : -1;
  };
  // The first key a row whose last key is `lim` sees (its window's edge).
  auto first_key = [&](int lim) -> int {
    return lim - window + 1;
  };

  const int t_lo = r0 / rep;
  if (t_lo >= len) {  // every row of the tile is padding: zeros
    for (int idx = threadIdx.x; idx < kBQ * HD; idx += attn::kThreads) {
      const int r = r0 + idx / HD;
      if (r < n_rows) out[row_off(r) + idx % HD] = __float2bfloat16(0.f);
    }
    return;
  }
  const bool paged = n_tab > 0;
  const int t_hi = min((min(r0 + kBQ, n_rows) - 1) / rep, len - 1);
  // Keys any row of the tile sees.
  const int ctx = min(start + t_hi + 1, paged ? n_tab * B : B);
  // Key tiles start at the first row's window edge, rounded down to 64 keys.
  const int kbase = WINDOW ? max(0, first_key(start + t_lo)) & ~63 : 0;
  const int n_kt = max(0, (ctx - kbase + BK - 1) / BK);

  const attn::Layout L = attn::layout<HD, kStages>(kQuant, n_tab);
  unsigned char* smem = sm90::dyn_smem();
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  if (threadIdx.x == 0) attn::init_barriers<kStages>(bars, kProducers, kProducers);
  __syncthreads();

  if (threadIdx.x >= attn::kConsumerThreads) {  // producer warpgroup
    sm90::reg_dealloc<attn::kProducerRegs>();
    const int pt = threadIdx.x - attn::kConsumerThreads;
    int* sTab = reinterpret_cast<int*>(smem + L.table);  // paged
    if (paged) {
      for (int i = kbase / B + pt; i < (ctx + B - 1) / B; i += kProducers)
        sTab[i] = block_table[(size_t)slot * n_tab + i];
      sm90::named_bar_sync(1, kProducers);
    }
    // Cache row of logical key j: rows are [block][n_kv][B], the slot itself
    // being the block of a contiguous cache. Times HD: the key's values.
    auto row_of = [&](int j) -> size_t {
      if (!paged) return ((size_t)slot * n_kv + kvh) * (size_t)B + j;
      const int b = j / B;
      return ((size_t)sTab[b] * n_kv + kvh) * (size_t)B + (j - b * B);
    };

    // Q: the block's rows, zeros past the chunk and in the padded columns.
    for (int ch = pt; ch < kBQ * CH; ch += kProducers) {
      const int row = ch / CH, cc = ch % CH, r = r0 + row;
      const bool ok = r < n_rows && cc < HD / 8;
      sm90::cp_async16(smem + L.q + sm90::tile_chunk(row, cc, kBQ),
                       ok ? q + row_off(r) + cc * 8 : q, ok);
    }
    sm90::cp_async_commit();
    sm90::cp_async_wait<0>();
    sm90::fence_async_shared();
    sm90::mbar_arrive(&bars[0]);

    attn::Ring<kStages> ring;
    for (int it = 0; it < n_kt; ++it) {
      const int kc0 = kbase + it * BK;
      sm90::mbar_wait(&bars[1 + kStages + ring.stage], ring.phase ^ 1u);
      unsigned char* sK = smem + L.stages + ring.stage * 2 * BK * HDP * 2;
      unsigned char* sV = sK + BK * HDP * 2;
      if constexpr (!kQuant) {
        // Keys at or past ctx are zeros, never read.
        for (int ch = pt; ch < BK * CH; ch += kProducers) {
          const int kk = ch / CH, cc = ch % CH, kc = kc0 + kk;
          const bool ok = kc < ctx && cc < HD / 8;
          const size_t off = (ok ? row_of(kc) : 0) * HD + (ok ? cc * 8 : 0);
          const uint32_t dst = sm90::tile_chunk(kk, cc, BK);
          sm90::cp_async16(sK + dst, k_cache + off, ok);
          sm90::cp_async16(sV + dst, v_cache + off, ok);
        }
        sm90::cp_async_commit();
        sm90::cp_async_wait<0>();
      } else {
        // The raw int8 rows of K and V through the staging area, kRaw
        // tiles at a time; the scales beside the stage load while the first
        // copies fly.
        const T* const src[2] = {k_cache, v_cache};
        unsigned char* const dst_tile[2] = {sK, sV};
        unsigned char* raw = smem + L.staging;
#pragma unroll
        for (int t0 = 0; t0 < 2; t0 += kRaw) {
          for (int ch = pt; ch < BK * (HD / 16); ch += kProducers) {
            const int kk = ch / (HD / 16), cc = ch % (HD / 16), kc = kc0 + kk;
            const bool ok = kc < ctx;
            const size_t off = (ok ? row_of(kc) * HD + cc * 16 : 0);
#pragma unroll
            for (int i = 0; i < kRaw; ++i)
              sm90::cp_async16(raw + i * BK * HD + kk * HD + cc * 16, src[t0 + i] + off, ok);
          }
          sm90::cp_async_commit();
          if (t0 == 0) {
            float* sc = reinterpret_cast<float*>(smem + L.scales) + ring.stage * 2 * BK;
            for (int j = pt; j < BK; j += kProducers) {
              const int kc = kc0 + j;
              const size_t row = kc < ctx ? row_of(kc) : 0;
              sc[j] = kc < ctx ? k_scale[row] : 0.f;
              sc[BK + j] = kc < ctx ? v_scale[row] : 0.f;
            }
          }
          sm90::cp_async_wait<0>();
          sm90::named_bar_sync(1, kProducers);  // the staged tiles landed
          for (int ch = pt; ch < BK * CH; ch += kProducers) {
            const int kk = ch / CH, cc = ch % CH;
            // Every staged tile's chunk is read before any is stored: the
            // stores could alias the staging area for all the compiler knows.
            uint4 w[kRaw];
#pragma unroll
            for (int i = 0; i < kRaw; ++i) {
              w[i] = make_uint4(0u, 0u, 0u, 0u);
              if (cc < HD / 8)
                w[i] = widen8(*reinterpret_cast<const uint2*>(raw + i * BK * HD + kk * HD + cc * 8));
            }
            const uint32_t dst = sm90::tile_chunk(kk, cc, BK);
#pragma unroll
            for (int i = 0; i < kRaw; ++i) *reinterpret_cast<uint4*>(dst_tile[t0 + i] + dst) = w[i];
          }
          sm90::named_bar_sync(1, kProducers);  // the staging area is free again
        }
      }
      sm90::fence_async_shared();
      sm90::mbar_arrive(&bars[1 + ring.stage]);
      ring.next();
    }
    return;
  }

  sm90::reg_alloc<attn::kConsumerRegs>();
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  // This thread's rows (fragment rows g and g + 8 of its warp).
  const int ra = r0 + wg * 64 + (t / 32) * 16 + (t % 32) / 4;
  const int rb = ra + 8;
  const int w0 = r0 + wg * 64;  // the warpgroup's first row
  attn::Rows R;
  R.lim_a = last_key(ra);
  R.lim_b = last_key(rb);
  R.lo_a = WINDOW ? first_key(R.lim_a) : 0;
  R.lo_b = WINDOW ? first_key(R.lim_b) : 0;
  R.active = last_key(w0) >= 0;
  R.wlim = last_key(w0);
  // The warpgroup's last row that is not padding sets the loosest edge.
  R.wlo = WINDOW ? first_key(start + min(min(w0 + 63, n_rows - 1) / rep, len - 1)) : 0;
  float o[HDP / 2], l_a, l_b;
  attn::consume<HDP, BK, kStages, WINDOW, kQuant>(smem, L, wg, R, kbase, n_kt, scale, o, l_a,
                                                  l_b);

  // Padding rows (t >= lens[p]) write exact zeros (their scores may have
  // run unmasked on an interior tile).
  const int q4 = t & 3;
  const float inv_a = l_a > 0.f ? 1.f / l_a : 0.f;
  const float inv_b = l_b > 0.f ? 1.f / l_b : 0.f;
  if (ra < n_rows) {
    uint32_t* oa = reinterpret_cast<uint32_t*>(out + row_off(ra));
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      oa[4 * j + q4] =
          R.lim_a < 0 ? 0u : sm90::pack_bf16x2(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
  }
  if (rb < n_rows) {
    uint32_t* ob = reinterpret_cast<uint32_t*>(out + row_off(rb));
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      ob[4 * j + q4] =
          R.lim_b < 0 ? 0u : sm90::pack_bf16x2(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k_cache, const void* v_cache,
                   const void* slots, const void* starts, const void* lens,
                   const void* k_scale, const void* v_scale, const void* block_table,
                   void* out, int n_rows_p, int c, int n_heads, int n_kv, int B, int n_tab,
                   int window, float scale, cudaStream_t stream) {
  const size_t smem = attn::smem_request<HD, kStages>(sizeof(T) == 1, n_tab);
  if (smem > attn::kMaxSmem) return cudaErrorInvalidValue;  // a table too wide
  const int rep = n_heads / n_kv;
  const dim3 grid((c * rep + kBQ - 1) / kBQ, n_kv, n_rows_p);
  auto kernel = window > 0 ? flash_cache_attention_kernel<T, HD, true>
                           : flash_cache_attention_kernel<T, HD, false>;
  const cudaError_t err = window > 0 ? attn::allow_smem<flash_cache_attention_kernel<T, HD, true>>()
                                     : attn::allow_smem<flash_cache_attention_kernel<T, HD, false>>();
  if (err != cudaSuccess) return err;
  kernel<<<grid, attn::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k_cache),
      static_cast<const T*>(v_cache), static_cast<const int*>(slots),
      static_cast<const int*>(starts), static_cast<const int*>(lens),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int*>(block_table), static_cast<__nv_bfloat16*>(out), c, n_heads,
      n_kv, B, n_tab, window, scale);
  return cudaGetLastError();
}

#define GOFR_PREFILL_ARGS \
  q, k_cache, v_cache, slots, starts, lens, k_scale, v_scale, block_table, out, n_rows_p, c, \
      n_heads, n_kv, B, n_tab, window, scale, stream

template <typename T>
cudaError_t launch_hd(int head_dim, const void* q, const void* k_cache, const void* v_cache,
                      const void* slots, const void* starts, const void* lens,
                      const void* k_scale, const void* v_scale, const void* block_table,
                      void* out, int n_rows_p, int c, int n_heads, int n_kv, int B, int n_tab,
                      int window, float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch<T, 32>(GOFR_PREFILL_ARGS);
    case 64: return launch<T, 64>(GOFR_PREFILL_ARGS);
    case 128: return launch<T, 128>(GOFR_PREFILL_ARGS);
    case 256: return launch<T, 256>(GOFR_PREFILL_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry bound with ctypes (gofr_tpu_torch/ops/cuda/flash_prefill.py).
// k_scale and v_scale both null (bf16 cache) or both set (int8 cache);
// block_table null with n_tab 0 (contiguous, B = max_len) or set with n_tab
// its width (paged, B the pool's block, a multiple of 16); window 0 (none) or
// the sliding window. Returns the cudaError_t of the launch (0 on success).
extern "C" int gofr_flash_cache_attention(const void* q, const void* k_cache,
                                          const void* v_cache, const void* slots,
                                          const void* starts, const void* lens,
                                          const void* k_scale, const void* v_scale,
                                          const void* block_table, void* out, int n_rows_p,
                                          int c, int n_heads, int n_kv, int B, int n_tab,
                                          int head_dim, int window, float scale,
                                          void* stream_ptr) {
  if (n_kv <= 0 || n_heads % n_kv != 0 || B <= 0 ||
      (k_scale == nullptr) != (v_scale == nullptr) || (block_table == nullptr) != (n_tab == 0) ||
      n_tab < 0 || (n_tab > 0 && B % 16 != 0) || window < 0)
    return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (k_scale != nullptr)
    return launch_hd<int8_t>(head_dim, GOFR_PREFILL_ARGS);
  return launch_hd<__nv_bfloat16>(head_dim, GOFR_PREFILL_ARGS);
}
