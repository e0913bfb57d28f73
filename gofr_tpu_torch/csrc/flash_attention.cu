// flash_attention for Hopper (sm_90a): full-sequence attention over
// q [b, s_q, n_heads, hd] and k, v [b, s_kv, n_kv, hd] (training forward,
// padded-batch serving prefill, encoders).
//
// Replaces: gofr_tpu/ops/pallas/flash_attention.py::flash_attention, both
// of its pallas_calls (without and with per-row key lengths). Query row r
// of batch row bi sees key c when c < lengths[bi] (s_kv without lengths)
// and, if causal, c <= r + (s_kv - s_q); query head h reads kv head
// h / (n_heads / n_kv). With a causal window > 0 (Mistral's sliding
// window) row r sees only keys c > r + (s_kv - s_q) - window as well. A row
// that sees no key returns exactly 0 (the TPU kernel's guarded finish),
// e.g. under lengths[bi] == 0, a negative causal offset, or a window wholly
// past the row's length.
//
// What bounds it on the H100: operations. Causal training attention at
// s = 2048 does 4 * hd * n_heads * s^2 / 2 FLOPs per batch row over
// (2 * s * n_heads + 2 * s * n_kv) * hd * 2 bytes, about a thousand FLOPs
// per byte, so the floor is the FLOPs over 989 TFLOP/s bf16.
//
// What the design does about it: both products run on the tensor cores in
// bf16 (mma.sync m16n8k16, f32 accumulation), as in flash_prefill.cu. One
// block per (tile of 64 query rows, query head, batch row), four warps of
// 16 rows each; a tile is one head's consecutive positions. q, k and v are
// read in place through their strides (no transposed or padded copies);
// ragged edges are bounds-checked. A warp's Q fragments stay in registers;
// the TPU grid's sequential kv-block axis is a loop over 64-key tiles that
// stops at the last key any row of the tile sees (the causal bound of its
// last row, clamped by lengths), so the cost follows the visible pairs.
// Scores and the online softmax state are f32 in registers with the TPU
// kernel's finite NEG_INF and explicit masking of the probabilities, and
// the probabilities feed P.V straight from the score accumulators, rounded
// to bf16. V is staged transposed so both products read their B fragments
// as 32-bit words. Causal tiles are launched longest first to shorten the
// tail. Every sum runs in a fixed order, so the output is deterministic.
// Window: the key-tile loop starts at the tile holding the first row's
// window edge, max(0, row0 + offset - window + 1), so tiles wholly below it
// are never read, and each row's own edge masks the fragments beside the
// causal bound. Whether that compare runs per score is a template flag
// chosen at launch, so window = 0 runs the unwindowed loop as it was.
// First version: no copy/compute overlap (cp.async/TMA) and no wgmma yet.

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

// Element strides of the batch, sequence and head axes of q, k and v (the
// head_dim axis has stride 1).
struct Strides {
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh;
};

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int HD>
constexpr size_t smem_bytes() {
  // sK [BK][HD+8] and sVt [HD][BK+8], bf16 bits.
  return (size_t)(kBK * (HD + 8) + HD * (kBK + 8)) * sizeof(uint16_t);
}

// out: [b, s_q, n_heads, HD] contiguous; lengths: [b] int32 or null;
// window: causal sliding window (WINDOW: window > 0). Grid (ceil(s_q / BQ),
// n_heads, b).
template <int HD, bool WINDOW>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ lengths,
    __nv_bfloat16* __restrict__ out, Strides st, int s_q, int s_kv, int n_heads,
    int n_kv, int causal, int window, float scale) {
  constexpr int KS = HD / 16;   // k-steps of Q.K^T
  constexpr int NT = kBK / 8;   // score n-tiles per warp
  constexpr int OT = HD / 8;    // output n-tiles per warp
  constexpr int KP = HD + 8;    // sK row stride (bf16)
  constexpr int VP = kBK + 8;   // sVt row stride (bf16)
  constexpr int CH = HD / 8;    // 16-byte chunks per key row

  const int tile = gridDim.x - 1 - blockIdx.x;  // longest causal tiles first
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const int kvh = h / (n_heads / n_kv);
  const int r0 = tile * kBQ;
  const int offset = s_kv - s_q;
  const int len = lengths ? max(0, min(lengths[bi], s_kv)) : s_kv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row group
  const int tg = lane & 3;  // thread in group

  // The last key query row r sees; -1 when it sees none.
  auto last_key = [&](int r) -> int {
    return causal ? min(r + offset, len - 1) : len - 1;
  };
  auto out_row = [&](int r) -> uint32_t* {
    return reinterpret_cast<uint32_t*>(out + (((size_t)bi * s_q + r) * n_heads + h) * HD);
  };

  const int ctx = last_key(min(r0 + kBQ, s_q) - 1) + 1;  // keys any row of the tile sees
  if (ctx <= 0) {  // no row of the tile sees a key: zeros
    for (int idx = tid; idx < kBQ * HD / 2; idx += kThreads) {
      const int r = r0 + idx / (HD / 2);
      if (r < s_q) out_row(r)[idx % (HD / 2)] = 0u;
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* sK = reinterpret_cast<uint16_t*>(smem_raw);  // [BK][KP]
  uint16_t* sVt = sK + kBK * KP;                          // [HD][VP]

  // This lane's two rows: ra (fragment row g) and rb (row g + 8).
  const int ra = r0 + warp * 16 + g;
  const int rb = ra + 8;
  const int lim_a = ra < s_q ? last_key(ra) : -1;
  const int lim_b = rb < s_q ? last_key(rb) : -1;
  // Their first visible key (the window's edge; 0 without a window).
  const int lo_a = window > 0 ? ra + offset - window + 1 : 0;
  const int lo_b = window > 0 ? rb + offset - window + 1 : 0;

  // Q fragments (A operand), read once from global memory.
  uint32_t qa[KS][4];
  {
    const uint16_t* qh = reinterpret_cast<const uint16_t*>(q + bi * st.qb + h * st.qh);
    const uint16_t* qra = ra < s_q ? qh + ra * st.qs : nullptr;
    const uint16_t* qrb = rb < s_q ? qh + rb * st.qs : nullptr;
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

  const __nv_bfloat16* kh = k + bi * st.kb + kvh * st.kh;
  const __nv_bfloat16* vh = v + bi * st.vb + kvh * st.vh;
  const int n_kt = (ctx + kBK - 1) / kBK;
  // First key tile any row of the tile sees: its first row's window edge.
  const int kt0 = window > 0 ? max(0, r0 + offset - window + 1) / kBK : 0;
  for (int kt = kt0; kt < n_kt; ++kt) {
    const int kc0 = kt * kBK;
    __syncthreads();  // the previous tile's reads of sK/sVt are done
    for (int ch = tid; ch < kBK * CH; ch += kThreads) {
      const int kk = ch / CH;
      const int col = (ch % CH) * 8;
      const int kc = kc0 + kk;
      uint4 kr = make_uint4(0u, 0u, 0u, 0u), vr = make_uint4(0u, 0u, 0u, 0u);
      if (kc < ctx) {
        kr = *reinterpret_cast<const uint4*>(kh + kc * st.ks + col);
        vr = *reinterpret_cast<const uint4*>(vh + kc * st.vs + col);
      }
      const uint32_t kw[4] = {kr.x, kr.y, kr.z, kr.w};
      const uint32_t vw[4] = {vr.x, vr.y, vr.z, vr.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        *reinterpret_cast<uint32_t*>(sK + kk * KP + col + 2 * i) = kw[i];
        sVt[(col + 2 * i) * VP + kk] = (uint16_t)(vw[i] & 0xffffu);
        sVt[(col + 2 * i + 1) * VP + kk] = (uint16_t)(vw[i] >> 16);
      }
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

    // Mask (causal bound and lengths, folded into lim; the window's edge),
    // scale, online softmax (f32).
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = kc0 + nt * 8 + tg * 2 + e;
        s[nt][e] *= scale;
        s[nt][2 + e] *= scale;
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
    l_a = l_a * corr_a + rs_a;
    l_b = l_b * corr_b + rs_b;
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

  // Rows that saw no key have l == 0 and o == 0: they write exact zeros.
  const float inv_a = l_a > 0.f ? 1.f / l_a : 0.f;
  const float inv_b = l_b > 0.f ? 1.f / l_b : 0.f;
  if (ra < s_q) {
    uint32_t* oa = out_row(ra);
#pragma unroll
    for (int ot = 0; ot < OT; ++ot) oa[ot * 4 + tg] = pack_bf16x2(o[ot][0] * inv_a, o[ot][1] * inv_a);
  }
  if (rb < s_q) {
    uint32_t* ob = out_row(rb);
#pragma unroll
    for (int ot = 0; ot < OT; ++ot) ob[ot * 4 + tg] = pack_bf16x2(o[ot][2] * inv_b, o[ot][3] * inv_b);
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* lengths, void* out,
                   const Strides& st, int b, int s_q, int s_kv, int n_heads, int n_kv,
                   int causal, int window, float scale, cudaStream_t stream) {
  static_assert(smem_bytes<HD>() <= 48 * 1024, "tiles must fit the default 48 KB");
  const dim3 grid((s_q + kBQ - 1) / kBQ, n_heads, b);
  auto kernel = window > 0 ? flash_attention_kernel<HD, true> : flash_attention_kernel<HD, false>;
  kernel<<<grid, kThreads, smem_bytes<HD>(), stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(out), st, s_q, s_kv, n_heads, n_kv, causal, window,
      scale);
  return cudaGetLastError();
}

}  // namespace

// C entry bound with ctypes (gofr_tpu_torch/ops/cuda/flash_attention.py).
// strides: the 9 element strides of q, k, v (batch, sequence, head axes).
// lengths may be null; window 0 (none) or a causal sliding window. Returns
// the cudaError_t of the launch (0 on success).
extern "C" int gofr_flash_attention(const void* q, const void* k, const void* v,
                                    const void* lengths, void* out, int b, int s_q,
                                    int s_kv, int n_heads, int n_kv, int head_dim,
                                    int causal, int window, const long long* strides,
                                    float scale, void* stream) {
  if (b <= 0 || s_q <= 0 || s_kv < 0 || n_kv <= 0 || n_heads % n_kv != 0 || window < 0 ||
      (window > 0 && !causal))
    return cudaErrorInvalidValue;
  const Strides st{strides[0], strides[1], strides[2], strides[3], strides[4],
                   strides[5], strides[6], strides[7], strides[8]};
  cudaStream_t sm = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch<64>(q, k, v, lengths, out, st, b, s_q, s_kv, n_heads, n_kv, causal, window,
                        scale, sm);
    case 128:
      return launch<128>(q, k, v, lengths, out, st, b, s_q, s_kv, n_heads, n_kv, causal, window,
                         scale, sm);
    default: return cudaErrorInvalidValue;
  }
}
