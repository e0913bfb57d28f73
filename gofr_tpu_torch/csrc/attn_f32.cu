// The f32 variants of flash_cache_attention and flash_attention for Hopper
// (sm_90a), on CUDA cores.
//
// Replaces: gofr_tpu/ops/pallas/flash_prefill.py::flash_cache_attention and
// gofr_tpu/ops/pallas/flash_attention.py::flash_attention for f32 inputs
// (the Pallas kernels take any dtype, with f32 accumulators). The bf16
// kernels (flash_prefill.cu, flash_attention.cu) run both products on
// wgmma, which takes f32 operands only as tf32 (about 3 decimal digits):
// that would not meet an f32 tolerance, so these kernels compute in full
// f32 with FMAs. Every variant the bf16 wrappers accept is here: for the
// chunk, the slot cache or a pool through the block table, int8 values with
// their scales, the window; for full sequences, the causal offset, per-row
// key lengths, the causal window and GQA, q/k/v read through their strides.
//
// What bounds it on the H100: operations, on CUDA cores (67 TFLOP/s f32),
// at the sizes f32 models are run (test-size configs): a plain tiled
// kernel, not tuned. hd 32 to 256; at 256 a block's tiles take ~73 KB of
// shared memory, past the 48 KB a launch gets without asking.
//
// What the design does: one block of kRows warps takes kRows query rows of
// one kv head (row r = token r / rep, head kvh * rep + r % rep, so the
// rows share every staged key), each warp one row. Key tiles of kKeys keys
// from the block's first visible key to its last are staged in shared
// memory (int8 widened exactly to f32, with the tile's scales); each lane
// scores one key of the tile against its warp's row, the warp keeps the
// online softmax (running max and denominator) in f32 with the TPU
// kernel's finite NEG_INF, and each lane accumulates hd / 32 output
// columns. A key outside a row's bounds is masked by selects, never by a
// product, so whatever sits in a key it does not see (NaN below the window,
// garbage past the length) cannot reach its output; keys below the block's
// first visible key are never read. As in the TPU kernel, an int8 score is
// times k_scale, the denominator takes p before the V scale, and only the
// P.V product sees p * v_scale. Sums run in a fixed order, so a result is
// the same from run to run. Rows that see no key write exact zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kRows = 8;  // query rows of a block: one warp each
constexpr int kKeys = 32;  // keys of a staged tile: one lane each
constexpr int kThreads = kRows * 32;

// Shared memory of a block: its rows' queries (pre-scaled), a K tile (rows
// padded by one float, so the lanes' score reads hit distinct banks), a V
// tile and the tile's scales.
template <int HD>
struct Smem {
  float q[kRows][HD];
  float k[kKeys][HD + 1];
  float v[kKeys][HD];
  float ks[kKeys], vs[kKeys];
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(int8_t x) { return (float)x; }

// One warp's row against the block's keys [k0, k1), staged kKeys at a time
// by `stage(key, d, &k, &v)` and, with QUANT, `scales(key, &ks, &vs)`; the
// row sees keys [lo, lim]. Leaves the row's unnormalised output columns
// lane + 32 i in acc and its denominator in l. Every warp of the block
// calls it with the same k0 and k1 (it synchronises the block).
template <int HD, bool QUANT, class Stage, class Scales>
__device__ __forceinline__ void attend(Smem<HD>& sm, int k0, int k1, int lo, int lim,
                                       Stage stage, Scales scales, float (&acc)[HD / 32],
                                       float& l) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  float m = kNegInf;
  l = 0.f;
#pragma unroll
  for (int i = 0; i < HD / 32; ++i) acc[i] = 0.f;
  for (int kc0 = k0; kc0 < k1; kc0 += kKeys) {
    __syncthreads();  // the previous tile is consumed (and the queries written)
    for (int idx = threadIdx.x; idx < kKeys * HD; idx += kThreads) {
      const int jj = idx / HD, d = idx % HD;
      if (kc0 + jj < k1) stage(kc0 + jj, d, sm.k[jj][d], sm.v[jj][d]);
    }
    if (QUANT) {
      for (int jj = threadIdx.x; jj < kKeys; jj += kThreads)
        if (kc0 + jj < k1) scales(kc0 + jj, sm.ks[jj], sm.vs[jj]);
    }
    __syncthreads();
    auto sees = [&](int key) { return key < k1 && key >= lo && key <= lim; };
    const bool vis = sees(kc0 + lane);
    float s = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) s += sm.q[w][d] * sm.k[lane][d];
    if (QUANT) s *= sm.ks[lane];
    s = vis ? s : kNegInf;
    float mx = s;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, off));
    const float mn = fmaxf(m, mx);
    const float corr = __expf(m - mn);
    const float p = vis ? __expf(s - mn) : 0.f;
    float ps = p;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ps += __shfl_xor_sync(kFullMask, ps, off);
    l = l * corr + ps;  // the denominator takes p before the V scale
    const float pv = QUANT ? (vis ? p * sm.vs[lane] : 0.f) : p;
#pragma unroll
    for (int i = 0; i < HD / 32; ++i) acc[i] *= corr;
    for (int j = 0; j < kKeys; ++j) {
      const float pj = __shfl_sync(kFullMask, pv, j);
      if (sees(kc0 + j)) {
#pragma unroll
        for (int i = 0; i < HD / 32; ++i) acc[i] += pj * sm.v[j][lane + 32 * i];
      }
    }
    m = mn;
  }
}

// This lane's columns of a row: acc / l, or zeros where the row sees no key.
template <int HD>
__device__ __forceinline__ void write_row(float* row, const float (&acc)[HD / 32], float l) {
  const int lane = threadIdx.x % 32;
  const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
  for (int i = 0; i < HD / 32; ++i) row[lane + 32 * i] = acc[i] * inv;
}

// q, out: [P, c, n_heads, HD] f32; caches TC (f32, or int8 with f32 scales
// of the caches' shape without HD): [S, n_kv, B, HD] (contiguous, B =
// max_len) or a pool [n_blocks, n_kv, B, HD] with block_table [S, n_tab]
// (n_tab = 0: contiguous); slots, starts, lens: [P] int32; window: sliding
// window (0: none). Grid (ceil(c * rep / kRows), n_kv, P).
template <typename TC, int HD>
__global__ void __launch_bounds__(kThreads) flash_cache_attention_f32_kernel(
    const float* __restrict__ q, const TC* __restrict__ k_cache, const TC* __restrict__ v_cache,
    const int* __restrict__ slots, const int* __restrict__ starts,
    const int* __restrict__ lens, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ block_table,
    float* __restrict__ out, int c, int n_heads, int n_kv, int B, int n_tab, int window,
    float scale) {
  constexpr bool kQuant = sizeof(TC) == 1;
  Smem<HD>& sm = *reinterpret_cast<Smem<HD>*>(sm90::dyn_smem());
  const int kvh = blockIdx.y, p = blockIdx.z;
  const int rep = n_heads / n_kv, n_rows = c * rep;
  const int r0 = blockIdx.x * kRows, r = r0 + threadIdx.x / 32, lane = threadIdx.x % 32;
  const int slot = slots[p], start = starts[p], len = max(0, min(lens[p], c));
  const bool paged = n_tab > 0;
  const int capacity = paged ? n_tab * B : B;
  // The last and first keys row rr sees (its global position and its
  // window's edge); lim -1 for a padding row.
  auto last_key = [&](int rr) { return rr < n_rows && rr / rep < len ? start + rr / rep : -1; };
  auto first_key = [&](int lim) { return window > 0 ? max(0, lim - window + 1) : 0; };
  const int lim = min(last_key(r), capacity - 1), lo = first_key(lim);
  // Keys any row of the block sees: from its first row's edge to its last
  // live row's position.
  const int t_hi = min((min(r0 + kRows, n_rows) - 1) / rep, len - 1);
  const int k0 = r0 / rep < len ? first_key(start + r0 / rep) : 0;
  const int k1 = r0 / rep < len ? min(start + t_hi + 1, capacity) : 0;
  auto row_of = [&](int j) -> size_t {
    if (!paged) return ((size_t)slot * n_kv + kvh) * (size_t)B + j;
    const int b = j / B;
    return ((size_t)block_table[(size_t)slot * n_tab + b] * n_kv + kvh) * (size_t)B +
           (j - b * B);
  };
  const size_t q_off = r < n_rows ? (((size_t)p * c + r / rep) * n_heads + (size_t)kvh * rep +
                                     r % rep) * HD
                                  : 0;
  for (int d = lane; d < HD; d += 32) sm.q[threadIdx.x / 32][d] = r < n_rows ? q[q_off + d] * scale : 0.f;
  float acc[HD / 32], l;
  attend<HD, kQuant>(
      sm, k0, k1, lo, lim,
      [&](int key, int d, float& kk, float& vv) {
        const size_t row = row_of(key);
        kk = widen(k_cache[row * HD + d]);
        vv = widen(v_cache[row * HD + d]);
      },
      [&](int key, float& ks, float& vs) {
        const size_t row = row_of(key);
        ks = k_scale[row];
        vs = v_scale[row];
      },
      acc, l);
  if (r < n_rows) write_row<HD>(out + q_off, acc, lim >= 0 ? l : 0.f);
}

// q: [b, s_q, n_heads, HD], k, v: [b, s_kv, n_kv, HD] f32 read through the
// element strides st (batch, sequence, head of q, k, v; unit stride along
// HD); out: [b, s_q, n_heads, HD] contiguous; lengths: [b] int32 or null;
// causal with offset s_kv - s_q; window: causal sliding window (0: none).
// Grid (ceil(s_q * rep / kRows), n_kv, b).
template <int HD>
__global__ void __launch_bounds__(kThreads) flash_attention_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const int* __restrict__ lengths, float* __restrict__ out, int s_q, int s_kv, int n_heads,
    int n_kv, int causal, int window, long long sqb, long long sqs, long long sqh,
    long long skb, long long sks, long long skh, long long svb, long long svs, long long svh,
    float scale) {
  Smem<HD>& sm = *reinterpret_cast<Smem<HD>*>(sm90::dyn_smem());
  const int kvh = blockIdx.y, bi = blockIdx.z;
  const int rep = n_heads / n_kv, n_rows = s_q * rep;
  const int r0 = blockIdx.x * kRows, r = r0 + threadIdx.x / 32, lane = threadIdx.x % 32;
  const int offset = s_kv - s_q;
  const int len = lengths ? max(0, min(lengths[bi], s_kv)) : s_kv;
  // The last key token t sees (-1: none; also for rows past s_q), its first.
  auto last_key = [&](int t) { return t >= s_q ? -1 : causal ? min(t + offset, len - 1) : len - 1; };
  auto first_key = [&](int t) { return window > 0 ? max(0, t + offset - window + 1) : 0; };
  const int t = r / rep;
  const int lim = last_key(t), lo = first_key(t);
  const int t_last = min((min(r0 + kRows, n_rows) - 1) / rep, s_q - 1);
  const int k0 = first_key(r0 / rep);
  const int k1 = last_key(t_last) + 1;
  const int h = kvh * rep + r % rep;
  for (int d = lane; d < HD; d += 32)
    sm.q[threadIdx.x / 32][d] = r < n_rows ? q[bi * sqb + t * sqs + h * sqh + d] * scale : 0.f;
  float acc[HD / 32], l;
  attend<HD, false>(
      sm, k0, k1, lo, lim,
      [&](int key, int d, float& kk, float& vv) {
        kk = k[bi * skb + key * sks + kvh * skh + d];
        vv = v[bi * svb + key * svs + kvh * svh + d];
      },
      [](int, float&, float&) {}, acc, l);
  if (r < n_rows) write_row<HD>(out + (((size_t)bi * s_q + t) * n_heads + h) * HD, acc, l);
}

// Lets `Kernel` take the Smem<HD> it launches with (past the 48 KB default
// at hd 256), once per process.
template <auto Kernel, int HD>
inline cudaError_t allow_smem() {
  static const cudaError_t err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)(sizeof(Smem<HD>) + 1024));
  return err;
}

template <typename TC, int HD>
cudaError_t launch_prefill(const void* q, const void* k_cache, const void* v_cache,
                           const void* slots, const void* starts, const void* lens,
                           const void* k_scale, const void* v_scale, const void* block_table,
                           void* out, int n_rows_p, int c, int n_heads, int n_kv, int B,
                           int n_tab, int window, float scale, cudaStream_t stream) {
  const int rep = n_heads / n_kv;
  const dim3 grid((c * rep + kRows - 1) / kRows, n_kv, n_rows_p);
  auto* const kernel = flash_cache_attention_f32_kernel<TC, HD>;
  const cudaError_t attr = allow_smem<flash_cache_attention_f32_kernel<TC, HD>, HD>();
  if (attr != cudaSuccess) return attr;
  kernel<<<grid, kThreads, sizeof(Smem<HD>) + 1024, stream>>>(
      static_cast<const float*>(q), static_cast<const TC*>(k_cache),
      static_cast<const TC*>(v_cache), static_cast<const int*>(slots),
      static_cast<const int*>(starts), static_cast<const int*>(lens),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int*>(block_table), static_cast<float*>(out), c, n_heads, n_kv, B,
      n_tab, window, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_attention(const void* q, const void* k, const void* v, const void* lengths,
                             void* out, const long long* st, int b, int s_q, int s_kv,
                             int n_heads, int n_kv, int causal, int window, float scale,
                             cudaStream_t stream) {
  const int rep = n_heads / n_kv;
  const dim3 grid((s_q * rep + kRows - 1) / kRows, n_kv, b);
  auto* const kernel = flash_attention_f32_kernel<HD>;
  const cudaError_t attr = allow_smem<flash_attention_f32_kernel<HD>, HD>();
  if (attr != cudaSuccess) return attr;
  kernel<<<grid, kThreads, sizeof(Smem<HD>) + 1024, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(lengths), static_cast<float*>(out), s_q, s_kv, n_heads, n_kv,
      causal, window, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale);
  return cudaGetLastError();
}

#define GOFR_PREFILL_F32_ARGS \
  q, k_cache, v_cache, slots, starts, lens, k_scale, v_scale, block_table, out, n_rows_p, c, \
      n_heads, n_kv, B, n_tab, window, scale, stream

template <typename TC>
cudaError_t prefill_hd(int head_dim, const void* q, const void* k_cache, const void* v_cache,
                       const void* slots, const void* starts, const void* lens,
                       const void* k_scale, const void* v_scale, const void* block_table,
                       void* out, int n_rows_p, int c, int n_heads, int n_kv, int B, int n_tab,
                       int window, float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch_prefill<TC, 32>(GOFR_PREFILL_F32_ARGS);
    case 64: return launch_prefill<TC, 64>(GOFR_PREFILL_F32_ARGS);
    case 128: return launch_prefill<TC, 128>(GOFR_PREFILL_F32_ARGS);
    case 256: return launch_prefill<TC, 256>(GOFR_PREFILL_F32_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry bound with ctypes (gofr_tpu_torch/ops/cuda/flash_prefill.py): the
// arguments of gofr_flash_cache_attention, with f32 q and out and caches of
// f32 (k_scale, v_scale null) or int8 (both set). Returns the cudaError_t
// of the launch (0 on success).
extern "C" int gofr_flash_cache_attention_f32(const void* q, const void* k_cache,
                                              const void* v_cache, const void* slots,
                                              const void* starts, const void* lens,
                                              const void* k_scale, const void* v_scale,
                                              const void* block_table, void* out, int n_rows_p,
                                              int c, int n_heads, int n_kv, int B, int n_tab,
                                              int head_dim, int window, float scale,
                                              void* stream_ptr) {
  if (n_rows_p <= 0 || c <= 0 || n_kv <= 0 || n_heads % n_kv != 0 || B <= 0 ||
      (k_scale == nullptr) != (v_scale == nullptr) || (block_table == nullptr) != (n_tab == 0) ||
      n_tab < 0 || window < 0)
    return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (k_scale != nullptr) return prefill_hd<int8_t>(head_dim, GOFR_PREFILL_F32_ARGS);
  return prefill_hd<float>(head_dim, GOFR_PREFILL_F32_ARGS);
}

// C entry bound with ctypes (gofr_tpu_torch/ops/cuda/flash_attention.py): the
// arguments of gofr_flash_attention, with f32 q, k, v and out; strides: the
// 9 element strides of q, k, v (batch, sequence, head). Returns the
// cudaError_t of the launch (0 on success).
extern "C" int gofr_flash_attention_f32(const void* q, const void* k, const void* v,
                                        const void* lengths, void* out, int b, int s_q,
                                        int s_kv, int n_heads, int n_kv, int head_dim,
                                        int causal, int window, const long long* strides,
                                        float scale, void* stream) {
  if (b <= 0 || s_q <= 0 || s_kv < 0 || n_kv <= 0 || n_heads % n_kv != 0 || window < 0 ||
      (window > 0 && !causal))
    return cudaErrorInvalidValue;
  cudaStream_t sm = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return launch_attention<32>(q, k, v, lengths, out, strides, b, s_q, s_kv, n_heads, n_kv,
                                  causal, window, scale, sm);
    case 64:
      return launch_attention<64>(q, k, v, lengths, out, strides, b, s_q, s_kv, n_heads, n_kv,
                                  causal, window, scale, sm);
    case 128:
      return launch_attention<128>(q, k, v, lengths, out, strides, b, s_q, s_kv, n_heads, n_kv,
                                   causal, window, scale, sm);
    case 256:
      return launch_attention<256>(q, k, v, lengths, out, strides, b, s_q, s_kv, n_heads, n_kv,
                                   causal, window, scale, sm);
    default: return cudaErrorInvalidValue;
  }
}
