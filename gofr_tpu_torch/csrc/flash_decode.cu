// flash_decode for Hopper (sm_90a): one query token per slot attends that
// slot's KV-cache prefix.
//
// Replaces: gofr_tpu/ops/pallas/flash_decode.py::flash_decode (bf16 or int8
// cache, contiguous or paged; the split convention, where the current
// token's k_new/v_new merge at the end and `lengths` excludes it, and the
// already-written convention, where `lengths` includes it). Not yet: the
// sliding window.
//
// What bounds it on the H100: bytes. A step reads the valid prefix of every
// slot's cache once (sum(lengths) * n_kv * hd * 2 bytes for K and for V in
// bf16; hd bytes each plus a 4-byte scale in int8) and does about 2 FLOPs
// per byte read, far below the ~295 FLOP/byte ridge of the card, so the
// floor is those bytes over 3.35 TB/s.
//
// What the design does about it: one block per (slot, kv head). The rep
// query heads of a kv head share every K/V row the block reads (GQA), so
// each byte of the prefix is read once for all of them. A key row of hd
// values is split over hd/8 lanes that each load 8 values (16 bytes in
// bf16, 8 in int8), so neighbouring lanes read neighbouring addresses, and
// a warp keeps U loads of 256/hd rows in flight. Only rows below the slot's
// length are read: the cost follows the true context, not max_len. Keys
// are dealt round-robin to lane groups, each of which carries its own
// online softmax (running max, denominator, accumulator) in f32 registers;
// the TPU grid's sequential kv-block axis is this loop. Groups then merge
// by warp shuffles, warps through shared memory in a fixed order (so a
// result does not change from run to run), and in split mode the current
// token merges last. Empty and masked states use the TPU kernel's finite
// NEG_INF = -1e30: an empty prefix then gives exp(-1e30 - s) = 0 instead
// of NaN, and split mode returns attention to the new token alone, the
// written convention 0.
//
// Paged: logical key j of a slot lives in pool block table[slot][j / B] at
// offset j % B. The block copies the slot's table row (only the entries its
// length needs) into shared memory once, and each load computes its row's
// address from it; nothing else changes, so a pool gives the contiguous
// cache's result bit for bit. Rows at or past the length are never read:
// the parking block 0 and unallocated entries hold garbage.
//
// Int8: the row's 8 values load as 8 bytes and widen exactly to f32; one
// f32 scale per key row for K and one for V. As in the TPU kernel, the
// score is (q.k) * scale * k_scale[j], the denominator takes the
// probability before the V scale, and only the P.V product sees
// p * v_scale[j]; the split convention's new token arrives already
// fake-quantized in bf16 and merges unscaled.
//
// Known limit: the grid has n_slots * n_kv blocks (64 at 8 slots and 8 kv
// heads), which underfills the 132 SMs. Splitting each slot's key range
// over several blocks (flash-decoding) is the first redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;

// Eight bf16 from one 16-byte load, widened to f32 by shifting the bits
// (a bf16 is the top half of an f32; the lower address is the low half).
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Eight int8 from one 8-byte load, widened to f32 (exact; the lowest
// address is the lowest byte).
__device__ __forceinline__ void load8(const int8_t* p, float (&f)[8]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const uint32_t w[2] = {raw.x, raw.y};
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = (float)(int8_t)(w[i / 4] >> (8 * (i % 4)));
}

// Shared memory of one block: the warps' partial states, the new token's
// scores and, paged, the slot's table row.
template <int HD, int REP, int NW>
constexpr size_t smem_floats() {
  return (size_t)NW * REP * HD + 2 * NW * REP + REP;
}

// q: [S, n_kv*REP, HD] bf16; caches T (bf16 or int8): [S, n_kv, B, HD]
// (contiguous, B = max_len) or a pool [n_blocks, n_kv, B, HD] with
// block_table [S, n_tab] int32 (n_tab = 0: contiguous); k_scale/v_scale
// (int8 only): f32, the caches' shape without HD; lengths: [S] int32;
// k_new/v_new: [S, n_kv, HD] bf16 or null; out: [S, n_kv*REP, HD] bf16.
// Grid (S, n_kv), NW warps.
template <typename T, int HD, int REP, int NW, int U>
__global__ void __launch_bounds__(NW * 32) flash_decode_kernel(
    const __nv_bfloat16* __restrict__ q, const T* __restrict__ k_cache,
    const T* __restrict__ v_cache, const int* __restrict__ lengths,
    const __nv_bfloat16* __restrict__ k_new,
    const __nv_bfloat16* __restrict__ v_new,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int* __restrict__ block_table, __nv_bfloat16* __restrict__ out,
    int n_kv, int B, int n_tab, float scale) {
  constexpr bool kQuant = sizeof(T) == 1;
  constexpr int LPK = HD / 8;         // lanes per key row, 8 values each
  constexpr int KPW = 32 / LPK;       // rows one warp covers per load
  constexpr int STRIDE = NW * KPW;    // rows the block covers per load
  static_assert(HD % 8 == 0 && 32 % LPK == 0, "HD must be 32, 64, 128 or 256");

  const int slot = blockIdx.x;
  const int kvh = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int sub = lane / LPK;   // which row of the warp's KPW
  const int part = lane % LPK;  // which 8 dims of that row
  const bool paged = n_tab > 0;
  const int length = max(0, min(lengths[slot], paged ? n_tab * B : B));
  const bool has_new = k_new != nullptr;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm_acc = reinterpret_cast<float*>(smem_raw);  // [NW][REP][HD]
  float* sm_m = sm_acc + NW * REP * HD;                 // [NW][REP]
  float* sm_l = sm_m + NW * REP;                        // [NW][REP]
  float* sm_sn = sm_l + NW * REP;                       // [REP]
  int* sm_tab = reinterpret_cast<int*>(sm_sn + REP);    // [n_tab], paged
  if (paged) {
    for (int i = threadIdx.x; i < (length + B - 1) / B; i += NW * 32)
      sm_tab[i] = block_table[(size_t)slot * n_tab + i];
    __syncthreads();
  }
  // Cache row of logical key j: rows are [block][n_kv][B], the slot itself
  // being the block of a contiguous cache. Times HD: the key's values.
  auto row_of = [&](int j) -> size_t {
    if (!paged) return ((size_t)slot * n_kv + kvh) * (size_t)B + j;
    const int b = j / B;
    return ((size_t)sm_tab[b] * n_kv + kvh) * (size_t)B + (j - b * B);
  };

  // This lane's 8 dims of each query head of the group, f32, pre-scaled.
  const size_t head0 = ((size_t)slot * n_kv + kvh) * REP;
  float qf[REP][8];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    load8(q + (head0 + r) * HD + part * 8, qf[r]);
#pragma unroll
    for (int i = 0; i < 8; ++i) qf[r][i] *= scale;
  }

  float m[REP], l[REP], acc[REP][8];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[r][i] = 0.f;
  }

  // `base` is warp-uniform, so every lane of a warp runs the same number of
  // iterations and the shuffles below see the whole warp.
  for (int base = warp * KPW; base < length; base += STRIDE * U) {
    float kf[U][8], vf[U][8], ks[U], vs[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = base + u * STRIDE + sub;
      ok[u] = j < length;
      ks[u] = vs[u] = 1.f;
      if (ok[u]) {
        const size_t row = row_of(j);
        load8(k_cache + row * HD + part * 8, kf[u]);
        load8(v_cache + row * HD + part * 8, vf[u]);
        if (kQuant) {
          ks[u] = k_scale[row];
          vs[u] = v_scale[row];
        }
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) kf[u][i] = vf[u][i] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float s[REP];
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) d += qf[r][i] * kf[u][i];
        s[r] = d;
      }
#pragma unroll
      for (int off = LPK / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int r = 0; r < REP; ++r) s[r] += __shfl_xor_sync(kFullMask, s[r], off);
      }
      if (ok[u]) {
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          const float sr = kQuant ? s[r] * ks[u] : s[r];
          const float m_new = fmaxf(m[r], sr);
          const float corr = __expf(m[r] - m_new);
          const float p = __expf(sr - m_new);
          l[r] = l[r] * corr + p;  // the denominator takes p before the V scale
          const float pv = kQuant ? p * vs[u] : p;
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[r][i] = acc[r][i] * corr + pv * vf[u][i];
          m[r] = m_new;
        }
      }
    }
  }

  // Merge the warp's row groups (lanes that differ in `sub`). Both lanes of
  // a pair compute the same sums in swapped order, which float addition
  // makes bit-identical.
#pragma unroll
  for (int off = LPK; off < 32; off <<= 1) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const float mo = __shfl_xor_sync(kFullMask, m[r], off);
      const float lo = __shfl_xor_sync(kFullMask, l[r], off);
      const float mn = fmaxf(m[r], mo);
      const float ca = __expf(m[r] - mn);
      const float cb = __expf(mo - mn);
      l[r] = l[r] * ca + lo * cb;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float ao = __shfl_xor_sync(kFullMask, acc[r][i], off);
        acc[r][i] = acc[r][i] * ca + ao * cb;
      }
      m[r] = mn;
    }
  }

  if (sub == 0) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
#pragma unroll
      for (int i = 0; i < 8; ++i) sm_acc[(warp * REP + r) * HD + part * 8 + i] = acc[r][i];
      if (part == 0) {
        sm_m[warp * REP + r] = m[r];
        sm_l[warp * REP + r] = l[r];
      }
    }
  }
  const size_t new_row = ((size_t)slot * n_kv + kvh) * HD;
  if (has_new) {
    // The current token's score for each query head, one warp per head.
    for (int r = warp; r < REP; r += NW) {
      const __nv_bfloat16* qr = q + (head0 + r) * HD;
      float s = 0.f;
      for (int d = lane; d < HD; d += 32)
        s += __bfloat162float(qr[d]) * __bfloat162float(k_new[new_row + d]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFullMask, s, off);
      if (lane == 0) sm_sn[r] = s * scale;
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < REP * HD; idx += NW * 32) {
    const int r = idx / HD;
    const int d = idx % HD;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm_m[w * REP + r]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = __expf(sm_m[w * REP + r] - mx);
      den += sm_l[w * REP + r] * c;
      num += sm_acc[(w * REP + r) * HD + d] * c;
    }
    float o;
    if (has_new) {
      const float sn = sm_sn[r];
      const float mn = fmaxf(mx, sn);
      const float c = __expf(mx - mn);
      const float e = __expf(sn - mn);
      const float vn = __bfloat162float(v_new[new_row + d]);
      o = (num * c + e * vn) / (den * c + e);
    } else {
      o = den > 0.f ? num / den : 0.f;
    }
    out[(head0 + r) * HD + d] = __float2bfloat16(o);
  }
}

template <typename T, int HD, int REP>
cudaError_t launch(const void* q, const void* k_cache, const void* v_cache,
                   const void* lengths, const void* k_new, const void* v_new,
                   const void* k_scale, const void* v_scale, const void* block_table,
                   void* out, int n_slots, int n_kv, int B, int n_tab, float scale,
                   cudaStream_t stream) {
  constexpr int NW = (REP * HD <= 512) ? 8 : 4;
  constexpr int U = (REP <= 4) ? 4 : 2;
  const size_t smem = smem_floats<HD, REP, NW>() * sizeof(float) + (size_t)n_tab * sizeof(int);
  const dim3 grid(n_slots, n_kv);
  auto kernel = flash_decode_kernel<T, HD, REP, NW, U>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, NW * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k_cache),
      static_cast<const T*>(v_cache), static_cast<const int*>(lengths),
      static_cast<const __nv_bfloat16*>(k_new), static_cast<const __nv_bfloat16*>(v_new),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int*>(block_table), static_cast<__nv_bfloat16*>(out), n_kv, B,
      n_tab, scale);
  return cudaGetLastError();
}

#define GOFR_DECODE_ARGS \
  q, k_cache, v_cache, lengths, k_new, v_new, k_scale, v_scale, block_table, out, n_slots, \
      n_kv, B, n_tab, scale, stream

template <typename T, int HD>
cudaError_t launch_rep(int rep, const void* q, const void* k_cache, const void* v_cache,
                       const void* lengths, const void* k_new, const void* v_new,
                       const void* k_scale, const void* v_scale, const void* block_table,
                       void* out, int n_slots, int n_kv, int B, int n_tab, float scale,
                       cudaStream_t stream) {
  switch (rep) {
    case 1: return launch<T, HD, 1>(GOFR_DECODE_ARGS);
    case 2: return launch<T, HD, 2>(GOFR_DECODE_ARGS);
    case 4: return launch<T, HD, 4>(GOFR_DECODE_ARGS);
    case 8: return launch<T, HD, 8>(GOFR_DECODE_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_hd(int head_dim, int rep, const void* q, const void* k_cache,
                      const void* v_cache, const void* lengths, const void* k_new,
                      const void* v_new, const void* k_scale, const void* v_scale,
                      const void* block_table, void* out, int n_slots, int n_kv, int B,
                      int n_tab, float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch_rep<T, 32>(rep, GOFR_DECODE_ARGS);
    case 64: return launch_rep<T, 64>(rep, GOFR_DECODE_ARGS);
    case 128: return launch_rep<T, 128>(rep, GOFR_DECODE_ARGS);
    case 256: return launch_rep<T, 256>(rep, GOFR_DECODE_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry bound with ctypes (gofr_tpu_torch/ops/cuda/flash_decode.py). k_new
// and v_new are both null (already-written convention) or both set (split);
// k_scale and v_scale both null (bf16 cache) or both set (int8 cache);
// block_table null with n_tab 0 (contiguous, B = max_len) or set with n_tab
// its width (paged, B the pool's block, a multiple of 16). Returns the
// cudaError_t of the launch (0 on success).
extern "C" int gofr_flash_decode(const void* q, const void* k_cache, const void* v_cache,
                                 const void* lengths, const void* k_new, const void* v_new,
                                 const void* k_scale, const void* v_scale,
                                 const void* block_table, void* out, int n_slots, int n_heads,
                                 int n_kv, int B, int n_tab, int head_dim, float scale,
                                 void* stream_ptr) {
  if (n_kv <= 0 || n_heads % n_kv != 0 || B <= 0 || (k_new == nullptr) != (v_new == nullptr) ||
      (k_scale == nullptr) != (v_scale == nullptr) || (block_table == nullptr) != (n_tab == 0) ||
      n_tab < 0 || (n_tab > 0 && B % 16 != 0))
    return cudaErrorInvalidValue;
  const int rep = n_heads / n_kv;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (k_scale != nullptr)
    return launch_hd<int8_t>(head_dim, rep, GOFR_DECODE_ARGS);
  return launch_hd<__nv_bfloat16>(head_dim, rep, GOFR_DECODE_ARGS);
}
