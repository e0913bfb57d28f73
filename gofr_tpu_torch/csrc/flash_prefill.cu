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
// What the design does about it: both products run on the tensor cores in
// bf16 (mma.sync m16n8k16, f32 accumulation). One block per (row p, kv
// head, tile of 64 query rows), four warps of 16 rows each. Queries are
// grouped kv-head-major with row = t * rep + head, as in the TPU kernel, so
// the rep query heads of a kv head share each K/V tile staged in shared
// memory and the causal bound of a row is starts[p] + row / rep. A warp's
// Q fragments stay in registers for the whole block; the TPU grid's
// sequential kv-block axis is a loop over 64-key tiles that stops at the
// last key any row of the tile can see, so the cost follows the true
// context. Scores and the online softmax state (running max, denominator)
// are f32 in registers, and the probabilities feed the P.V product straight
// from the score accumulators, rounded to bf16. V is staged transposed so
// both products read their B fragments as 32-bit words; the row pads keep
// those reads free of bank conflicts. First version: no copy/compute
// overlap (cp.async/TMA) and no wgmma yet.
//
// Window: the key-tile loop starts at the tile holding the window edge of
// the query tile's first row, max(0, starts[p] + t_lo - window + 1), the
// loosest edge of its rows, so key tiles wholly below it are never read;
// each row's own edge is a second bound beside the causal one where the
// fragments are masked. The tiles kept have the unwindowed shapes and
// order, so a windowed pool still equals the windowed slot cache bit for
// bit. Whether that compare runs per score is a template flag chosen at
// launch, so window = 0 runs the unwindowed loop as it was.
//
// Paged: logical key j of slot slots[p] lives in pool block
// table[slots[p]][j / B] at offset j % B. The block copies the entries of
// that table row its keys need (from its first kept tile on) into shared
// memory once; each staged key row computes its address from it, so a
// 64-key tile may span several pool blocks, and a pool gives the
// contiguous cache's result bit for bit. Rows
// past the tile's last visible key are never read (the parking block 0 and
// unallocated entries hold garbage).
//
// Int8: a staged row's 16-byte loads carry 16 values, widened exactly to
// bf16 on their way into the same shared tiles, so both products are
// unchanged; the tile's K and V scales (one f32 per key) are staged beside
// them. As in the TPU kernel, scores are (q.k) * scale * k_scale[j], the
// denominator takes the probabilities before the V scale, and only the P
// fragment of the P.V product is multiplied by v_scale[j] (then rounded to
// bf16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kBQ = 64;        // query rows per block, 16 per warp
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;  // four warps

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int HD>
__host__ __device__ constexpr size_t tile_bytes() {
  // sK [BK][HD+8] and sVt [HD][BK+8], bf16 bits.
  return (size_t)(kBK * (HD + 8) + HD * (kBK + 8)) * sizeof(uint16_t);
}

// Dynamic shared memory: the tiles, the tile's K and V scales (int8) and
// the row's table entries (paged).
template <int HD>
size_t smem_bytes(bool quant, int n_tab) {
  return tile_bytes<HD>() + (quant ? 2 * kBK * sizeof(float) : 0) +
         (size_t)n_tab * sizeof(int);
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16(x));
}

// Eight cache values of a 16-byte load, as bf16 bit pairs (low half first).
__device__ __forceinline__ void widen(const uint4 raw, const __nv_bfloat16*, uint32_t (&w)[4]) {
  w[0] = raw.x;
  w[1] = raw.y;
  w[2] = raw.z;
  w[3] = raw.w;
}

// Sixteen int8 of a 16-byte load, widened exactly to bf16 bit pairs.
__device__ __forceinline__ void widen(const uint4 raw, const int8_t*, uint32_t (&w)[8]) {
  const uint32_t b[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t word = b[i / 2] >> (16 * (i % 2));
    w[i] = bf16_bits((float)(int8_t)(word & 0xffu)) |
           (bf16_bits((float)(int8_t)((word >> 8) & 0xffu)) << 16);
  }
}

// q, out: [P, c, n_heads, HD] bf16; caches T (bf16 or int8): [S, n_kv, B,
// HD] (contiguous, B = max_len) or a pool [n_blocks, n_kv, B, HD] with
// block_table [S, n_tab] int32 (n_tab = 0: contiguous); k_scale/v_scale
// (int8 only): f32, the caches' shape without HD; slots, starts, lens: [P]
// int32; window: sliding window (WINDOW: window > 0). Grid (ceil(c * rep /
// BQ), n_kv, P).
template <typename T, int HD, bool WINDOW>
__global__ void __launch_bounds__(kThreads) flash_cache_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const T* __restrict__ k_cache,
    const T* __restrict__ v_cache, const int* __restrict__ slots,
    const int* __restrict__ starts, const int* __restrict__ lens,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int* __restrict__ block_table, __nv_bfloat16* __restrict__ out,
    int c, int n_heads, int n_kv, int B, int n_tab, int window, float scale) {
  constexpr bool kQuant = sizeof(T) == 1;
  constexpr int KS = HD / 16;   // k-steps of Q.K^T
  constexpr int NT = kBK / 8;   // score n-tiles per warp
  constexpr int OT = HD / 8;    // output n-tiles per warp
  constexpr int KP = HD + 8;    // sK row stride (bf16)
  constexpr int VP = kBK + 8;   // sVt row stride (bf16)
  constexpr int VPL = 16 / sizeof(T);  // cache values per 16-byte load
  constexpr int CH = HD / VPL;         // 16-byte loads per cache row

  const int tile = blockIdx.x;
  const int kvh = blockIdx.y;
  const int p = blockIdx.z;
  const int rep = n_heads / n_kv;
  const int n_rows = c * rep;
  const int r0 = tile * kBQ;
  const int slot = slots[p];
  const int start = starts[p];
  const int len = max(0, min(lens[p], c));
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row group
  const int tg = lane & 3;  // thread in group

  // Offset of global query row r (t = r / rep, head kvh * rep + r % rep).
  auto row_off = [&](int r) -> size_t {
    const int t = r / rep;
    return (((size_t)p * c + t) * n_heads + (size_t)kvh * rep + (r - t * rep)) * HD;
  };

  const int t_lo = r0 / rep;
  if (t_lo >= len) {  // every row of the tile is padding: zeros
    for (int idx = tid; idx < kBQ * HD; idx += kThreads) {
      const int r = r0 + idx / HD;
      if (r < n_rows) out[row_off(r) + idx % HD] = __float2bfloat16(0.f);
    }
    return;
  }
  const bool paged = n_tab > 0;
  const int t_hi = min((min(r0 + kBQ, n_rows) - 1) / rep, len - 1);
  // Keys any row of the tile sees.
  const int ctx = min(start + t_hi + 1, paged ? n_tab * B : B);
  // First key tile any row of the tile sees: its first row's window edge.
  const int kt0 = window > 0 ? max(0, start + t_lo - window + 1) / kBK : 0;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* sK = reinterpret_cast<uint16_t*>(smem_raw);  // [BK][KP]
  uint16_t* sVt = sK + kBK * KP;                          // [HD][VP]
  float* sKs = reinterpret_cast<float*>(smem_raw + tile_bytes<HD>());  // [BK], int8
  float* sVs = sKs + kBK;                                              // [BK], int8
  int* sTab = reinterpret_cast<int*>(sKs + (kQuant ? 2 * kBK : 0));   // [n_tab], paged
  if (paged)  // read after the key loop's first barrier
    for (int i = kt0 * kBK / B + tid; i < (ctx + B - 1) / B; i += kThreads)
      sTab[i] = block_table[(size_t)slot * n_tab + i];
  // Cache row of logical key j: rows are [block][n_kv][B], the slot itself
  // being the block of a contiguous cache. Times HD: the key's values.
  auto row_of = [&](int j) -> size_t {
    if (!paged) return ((size_t)slot * n_kv + kvh) * (size_t)B + j;
    const int b = j / B;
    return ((size_t)sTab[b] * n_kv + kvh) * (size_t)B + (j - b * B);
  };

  // This lane's two rows: ra (fragment row g) and rb (row g + 8).
  const int ra = r0 + warp * 16 + g;
  const int rb = ra + 8;
  const int lim_a = (ra < n_rows && ra / rep < len) ? start + ra / rep : -1;
  const int lim_b = (rb < n_rows && rb / rep < len) ? start + rb / rep : -1;
  // Their first visible key (the window's edge; 0 without a window).
  const int lo_a = window > 0 ? lim_a - window + 1 : 0;
  const int lo_b = window > 0 ? lim_b - window + 1 : 0;

  // Q fragments (A operand), read once from global memory.
  uint32_t qa[KS][4];
  {
    const uint16_t* qra = ra < n_rows ? reinterpret_cast<const uint16_t*>(q + row_off(ra)) : nullptr;
    const uint16_t* qrb = rb < n_rows ? reinterpret_cast<const uint16_t*>(q + row_off(rb)) : nullptr;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int col = ks * 16 + tg * 2;
      qa[ks][0] = qra ? ld32(qra + col) : 0u;
      qa[ks][1] = qrb ? ld32(qrb + col) : 0u;
      qa[ks][2] = qra ? ld32(qra + col + 8) : 0u;
      qa[ks][3] = qrb ? ld32(qrb + col + 8) : 0u;
    }
  }

  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  float o[OT][4];
#pragma unroll
  for (int ot = 0; ot < OT; ++ot)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[ot][e] = 0.f;

  const int n_kt = (ctx + kBK - 1) / kBK;
  for (int kt = kt0; kt < n_kt; ++kt) {
    const int kc0 = kt * kBK;
    __syncthreads();  // the previous tile's reads of sK/sVt are done
    for (int ch = tid; ch < kBK * CH; ch += kThreads) {
      const int kk = ch / CH;
      const int col = (ch % CH) * VPL;
      const int kc = kc0 + kk;
      uint4 kr = make_uint4(0u, 0u, 0u, 0u), vr = make_uint4(0u, 0u, 0u, 0u);
      if (kc < ctx) {
        const size_t row = row_of(kc);
        kr = *reinterpret_cast<const uint4*>(k_cache + row * HD + col);
        vr = *reinterpret_cast<const uint4*>(v_cache + row * HD + col);
      }
      uint32_t kw[VPL / 2], vw[VPL / 2];
      widen(kr, k_cache, kw);
      widen(vr, v_cache, vw);
#pragma unroll
      for (int i = 0; i < VPL / 2; ++i) {
        *reinterpret_cast<uint32_t*>(sK + kk * KP + col + 2 * i) = kw[i];
        sVt[(col + 2 * i) * VP + kk] = (uint16_t)(vw[i] & 0xffffu);
        sVt[(col + 2 * i + 1) * VP + kk] = (uint16_t)(vw[i] >> 16);
      }
    }
    if (kQuant && tid < kBK) {
      const int kc = kc0 + tid;
      const size_t row = kc < ctx ? row_of(kc) : 0;
      sKs[tid] = kc < ctx ? k_scale[row] : 0.f;
      sVs[tid] = kc < ctx ? v_scale[row] : 0.f;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys.
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      const uint16_t* kb = sK + (nt * 8 + g) * KP + tg * 2;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const uint32_t b[2] = {ld32(kb + ks * 16), ld32(kb + ks * 16 + 8)};
        mma_bf16_16816(s[nt], qa[ks], b);
      }
    }

    // Causal and window mask at global positions, scale, online softmax
    // (f32).
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = kc0 + nt * 8 + tg * 2 + e;
        s[nt][e] *= scale;
        s[nt][2 + e] *= scale;
        if (kQuant) {
          s[nt][e] *= sKs[col - kc0];
          s[nt][2 + e] *= sKs[col - kc0];
        }
        if (col <= lim_a && (!WINDOW || col >= lo_a)) mx_a = fmaxf(mx_a, s[nt][e]);
        if (col <= lim_b && (!WINDOW || col >= lo_b)) mx_b = fmaxf(mx_b, s[nt][2 + e]);
      }
    }
    // The 4 lanes of a row group hold that row's columns.
    mx_a = fmaxf(mx_a, __shfl_xor_sync(kFullMask, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(kFullMask, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(kFullMask, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(kFullMask, mx_b, 2));
    const float mn_a = fmaxf(m_a, mx_a);
    const float mn_b = fmaxf(m_b, mx_b);
    const float corr_a = __expf(m_a - mn_a);
    const float corr_b = __expf(m_b - mn_b);
    float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = kc0 + nt * 8 + tg * 2 + e;
        s[nt][e] = (col <= lim_a && (!WINDOW || col >= lo_a)) ? __expf(s[nt][e] - mn_a) : 0.f;
        s[nt][2 + e] =
            (col <= lim_b && (!WINDOW || col >= lo_b)) ? __expf(s[nt][2 + e] - mn_b) : 0.f;
        rs_a += s[nt][e];
        rs_b += s[nt][2 + e];
      }
    }
    rs_a += __shfl_xor_sync(kFullMask, rs_a, 1);
    rs_a += __shfl_xor_sync(kFullMask, rs_a, 2);
    rs_b += __shfl_xor_sync(kFullMask, rs_b, 1);
    rs_b += __shfl_xor_sync(kFullMask, rs_b, 2);
    l_a = l_a * corr_a + rs_a;  // the denominator takes p before the V scale
    l_b = l_b * corr_b + rs_b;
    if (kQuant) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float vs = sVs[nt * 8 + tg * 2 + e];
          s[nt][e] *= vs;
          s[nt][2 + e] *= vs;
        }
    }
    m_a = mn_a;
    m_b = mn_b;
#pragma unroll
    for (int ot = 0; ot < OT; ++ot) {
      o[ot][0] *= corr_a;
      o[ot][1] *= corr_a;
      o[ot][2] *= corr_b;
      o[ot][3] *= corr_b;
    }

    // O += P V: the score accumulators of n-tiles 2j, 2j+1 are the A
    // fragment of k-step j.
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      const uint32_t pa[4] = {
          pack_bf16x2(s[2 * j][0], s[2 * j][1]), pack_bf16x2(s[2 * j][2], s[2 * j][3]),
          pack_bf16x2(s[2 * j + 1][0], s[2 * j + 1][1]),
          pack_bf16x2(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int ot = 0; ot < OT; ++ot) {
        const uint16_t* vb = sVt + (ot * 8 + g) * VP + j * 16 + tg * 2;
        const uint32_t b[2] = {ld32(vb), ld32(vb + 8)};
        mma_bf16_16816(o[ot], pa, b);
      }
    }
  }

  const float inv_a = l_a > 0.f ? 1.f / l_a : 0.f;
  const float inv_b = l_b > 0.f ? 1.f / l_b : 0.f;
  if (ra < n_rows) {
    __nv_bfloat16* oa = out + row_off(ra);
#pragma unroll
    for (int ot = 0; ot < OT; ++ot)
#pragma unroll
      for (int e = 0; e < 2; ++e) oa[ot * 8 + tg * 2 + e] = __float2bfloat16(o[ot][e] * inv_a);
  }
  if (rb < n_rows) {
    __nv_bfloat16* ob = out + row_off(rb);
#pragma unroll
    for (int ot = 0; ot < OT; ++ot)
#pragma unroll
      for (int e = 0; e < 2; ++e) ob[ot * 8 + tg * 2 + e] = __float2bfloat16(o[ot][2 + e] * inv_b);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k_cache, const void* v_cache,
                   const void* slots, const void* starts, const void* lens,
                   const void* k_scale, const void* v_scale, const void* block_table,
                   void* out, int n_rows_p, int c, int n_heads, int n_kv, int B, int n_tab,
                   int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>(sizeof(T) == 1, n_tab);
  const int rep = n_heads / n_kv;
  const dim3 grid((c * rep + kBQ - 1) / kBQ, n_kv, n_rows_p);
  auto kernel = window > 0 ? flash_cache_attention_kernel<T, HD, true>
                           : flash_cache_attention_kernel<T, HD, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(
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
