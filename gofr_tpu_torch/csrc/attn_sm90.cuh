// The Hopper attention mainloop shared by flash_attention.cu and
// flash_prefill.cu (include sm90.cuh first).
//
// A block owns kBQ = 128 query rows of one head group and runs three
// warpgroups. Warpgroups 0 and 1 consume: each owns 64 query rows, keeps
// its output O (64 x hd) and its online-softmax state in f32 registers,
// and per key tile computes S = Q.K^T (wgmma, Q and K from shared memory,
// both K-major), the online softmax, and O += P.V (wgmma, P from registers,
// V from shared memory in MN-major mode, so V is never transposed).
// Warpgroup 2 produces: it fills a ring of STAGES shared-memory stages, each
// a K tile and a V tile of kBK = 128 keys, with asynchronous copies (TMA in
// flash_attention.cu, cp.async in flash_prefill.cu), so the copies of the
// next tiles overlap the consumers' products. Each stage has a "full"
// mbarrier (the producer's copies have landed) and an "empty" one (all 256
// consumer threads have retired their wgmma reads of it); Q has its own
// "full" barrier. setmaxnreg gives the consumers the producer's registers.
//
// What a kernel supplies: its producer (how stage i's rows are fetched),
// each consumer thread's two rows' bounds (Rows: where a query row sits)
// and its epilogue. Key tiles start at `kbase` (0, or the first query
// row's window edge rounded down to 64 keys, so tiles wholly below the
// window are never read) and a tile is masked only where it straddles a
// bound of the warpgroup's rows (the causal diagonal, the lengths, the
// window's edge, the ragged end); interior tiles skip the per-score
// compare. Every sum runs in a fixed order, so the output is deterministic.
#pragma once

namespace attn {

constexpr int kBQ = 128;               // query rows per block: 64 per consumer warpgroup
constexpr int kBK = 128;               // keys per tile
constexpr int kConsumerThreads = 256;  // warpgroups 0 and 1
constexpr int kThreads = 384;          // + the producer warpgroup
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kNegInf = -1e30f;

// Head dims below one 64-column panel are padded to it with zeros.
template <int HD>
__host__ __device__ constexpr int padded() {
  return HD < 64 ? 64 : HD;
}

// Byte offsets of the block's shared memory (from a 1024-byte boundary):
// Q [kBQ rows], STAGES x (K tile, V tile) [kBK rows each], an int8 staging
// tile for K and V, STAGES x (K scales, V scales) [kBK f32 each], the block
// table's entries, then the mbarriers: Q full, STAGES full, STAGES empty.
struct Layout {
  uint32_t q, stages, staging, scales, table, bars, total;
};

template <int HD, int STAGES>
__host__ __device__ inline Layout layout(bool quant, int n_tab) {
  constexpr int HDP = padded<HD>();
  Layout l{};
  l.q = 0;
  l.stages = kBQ * HDP * 2;
  l.staging = l.stages + STAGES * 2 * kBK * HDP * 2;
  l.scales = l.staging + (quant ? 2 * kBK * HD : 0);
  l.table = l.scales + (quant ? STAGES * 2 * kBK * 4 : 0);
  l.bars = (l.table + 4 * (uint32_t)n_tab + 7u) & ~7u;
  l.total = l.bars + (1 + 2 * STAGES) * 8;
  return l;
}

// Dynamic shared memory to request: the layout and room to align it.
template <int HD, int STAGES>
inline size_t smem_request(bool quant, int n_tab) {
  return layout<HD, STAGES>(quant, n_tab).total + 1024;
}

// Lets `Kernel` take up to the H100's 227 KB of dynamic shared memory, once
// per process (a host call that would otherwise cost every launch).
template <auto Kernel>
inline cudaError_t allow_smem() {
  static const cudaError_t err =
      cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  return err;
}

template <int STAGES>
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

// Called by one thread; __syncthreads() follows.
template <int STAGES>
__device__ __forceinline__ void init_barriers(uint64_t* bars, uint32_t q_count,
                                              uint32_t full_count) {
  sm90::mbar_init(&bars[0], q_count);
  for (int s = 0; s < STAGES; ++s) {
    sm90::mbar_init(&bars[1 + s], full_count);
    sm90::mbar_init(&bars[1 + STAGES + s], kConsumerThreads);
  }
  sm90::mbar_fence_init();
}

// A consumer thread's two rows (a: 16w + g, b: 16w + g + 8 of its
// warpgroup's 64) and its warpgroup's rows that are written.
struct Rows {
  int lim_a, lim_b;  // last key each row sees (-1: none)
  int lo_a, lo_b;    // first key each row sees (the window's edge; 0 without)
  int wlim;          // the least lim of the warpgroup's rows (-1: some see none)
  int wlo;           // the greatest lo of those rows
  bool active;       // the warpgroup has a row to compute
};

__device__ __forceinline__ bool visible(int col, int lim, int lo, bool window) {
  return col <= lim && (!window || col >= lo);
}

// Scale (and the int8 K scale), mask, online softmax of one 64 x kBK score
// tile in the accumulator layout: s[4j + e] is row a (e < 2) or b, column
// kc0 + 8j + 2q + e % 2. Scores are kept in the log2 domain (scale2 =
// scale * log2(e), so exp(x * scale - m) is one exp2 of an FFMA's result).
// Leaves the probabilities in s (times the int8 V scale, after the
// denominator took them) and returns the corrections of O.
template <bool MASK, bool WINDOW, bool QUANT>
__device__ __forceinline__ void softmax_tile(float (&s)[kBK / 2], int kc0, int q, const Rows& R,
                                             const float* ks, const float* vs, float scale2,
                                             float& m_a, float& m_b, float& l_a, float& l_b,
                                             float& corr_a, float& corr_b) {
  float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) {
    const int j = 8 * (i / 4) + 2 * q + (i & 1);  // column in the tile
    float x = s[i] * scale2;
    if (QUANT) x *= ks[j];
    s[i] = x;
    if (i & 2) {
      if (!MASK || visible(kc0 + j, R.lim_b, R.lo_b, WINDOW)) mx_b = fmaxf(mx_b, x);
    } else {
      if (!MASK || visible(kc0 + j, R.lim_a, R.lo_a, WINDOW)) mx_a = fmaxf(mx_a, x);
    }
  }
  // The 4 threads of a row group hold that row's columns.
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
  const float mn_a = fmaxf(m_a, mx_a);
  const float mn_b = fmaxf(m_b, mx_b);
  corr_a = sm90::exp2_approx(m_a - mn_a);
  corr_b = sm90::exp2_approx(m_b - mn_b);
  m_a = mn_a;
  m_b = mn_b;
  float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) {
    const int j = 8 * (i / 4) + 2 * q + (i & 1);
    if (i & 2) {
      s[i] = (!MASK || visible(kc0 + j, R.lim_b, R.lo_b, WINDOW)) ? sm90::exp2_approx(s[i] - mn_b)
                                                                 : 0.f;
      rs_b += s[i];
    } else {
      s[i] = (!MASK || visible(kc0 + j, R.lim_a, R.lo_a, WINDOW)) ? sm90::exp2_approx(s[i] - mn_a)
                                                                 : 0.f;
      rs_a += s[i];
    }
  }
  rs_a += __shfl_xor_sync(0xffffffffu, rs_a, 1);
  rs_a += __shfl_xor_sync(0xffffffffu, rs_a, 2);
  rs_b += __shfl_xor_sync(0xffffffffu, rs_b, 1);
  rs_b += __shfl_xor_sync(0xffffffffu, rs_b, 2);
  l_a = l_a * corr_a + rs_a;  // the denominator takes p before the V scale
  l_b = l_b * corr_b + rs_b;
  if (QUANT) {
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) s[i] *= vs[8 * (i / 4) + 2 * q + (i & 1)];
  }
}

// A consumer warpgroup's mainloop over n_kt key tiles from kbase: returns
// O (unnormalised, the accumulator layout over HDP columns) and the two
// rows' denominators. `smem` is the aligned base of the Layout L. Each tile
// runs S = Q K^T, the softmax and O += P V in turn; the other consumer
// warpgroup's products fill the tensor cores during this one's softmax.
// (Issuing tile i + 1's scores before tile i's P V, with or without the
// two warpgroups taking turns, measured slower with 2 stages and at most
// 10% faster with 3 on an H100: the simple loop stays.)
template <int HDP, int STAGES, bool WINDOW, bool QUANT>
__device__ __forceinline__ void consume(unsigned char* smem, const Layout& L, int wg,
                                        const Rows& R, int kbase, int n_kt, float scale,
                                        float (&o)[HDP / 2], float& l_a, float& l_b) {
  constexpr uint32_t kTile = kBK * HDP * 2;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;
  const int q = threadIdx.x & 3;
  const float scale2 = scale * 1.4426950408889634f;  // log2(e)
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) o[i] = 0.f;
  l_a = l_b = 0.f;
  float m_a = kNegInf, m_b = kNegInf;
  Ring<STAGES> ring;
  if (!R.active) {  // keep the ring's count: wait for each tile and release it
    for (int it = 0; it < n_kt; ++it) {
      sm90::mbar_wait(&full[ring.stage], ring.phase);
      sm90::mbar_arrive(&empty[ring.stage]);
      ring.next();
    }
    return;
  }
  const unsigned char* sQ = smem + L.q + wg * 64 * 128;
  sm90::mbar_wait(&bars[0], 0);
  for (int it = 0; it < n_kt; ++it) {
    const int kc0 = kbase + it * kBK;
    sm90::mbar_wait(&full[ring.stage], ring.phase);
    const unsigned char* sK = smem + L.stages + ring.stage * 2 * kTile;
    const unsigned char* sV = sK + kTile;

    // S = Q K^T: k-steps of 16 along the head dim, 4 per 64-column panel.
    float s[kBK / 2];
    sm90::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < HDP / 16; ++ks) {
      const uint32_t col = (ks & 3) * 32;
      sm90::wgmma_ss<kBK, 0>(s, sm90::desc_sw128(sQ + (ks >> 2) * kBQ * 128 + col, 0, 1024),
                             sm90::desc_sw128(sK + (ks >> 2) * kBK * 128 + col, 0, 1024),
                             ks > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operand(s);

    const float* ks = nullptr;
    const float* vs = nullptr;
    if (QUANT) {
      ks = reinterpret_cast<const float*>(smem + L.scales) + ring.stage * 2 * kBK;
      vs = ks + kBK;
    }
    // Only a tile that straddles a bound of the warpgroup's rows is masked.
    float corr_a, corr_b;
    if (kc0 + kBK - 1 > R.wlim || (WINDOW && kc0 < R.wlo))
      softmax_tile<true, WINDOW, QUANT>(s, kc0, q, R, ks, vs, scale2, m_a, m_b, l_a, l_b,
                                        corr_a, corr_b);
    else
      softmax_tile<false, WINDOW, QUANT>(s, kc0, q, R, ks, vs, scale2, m_a, m_b, l_a, l_b,
                                         corr_a, corr_b);

    // O = O * corr + P V: the score accumulators of column blocks 2j, 2j+1,
    // rounded to bf16, are the A registers of k-step j; V is read MN-major
    // (16 keys of 128 bytes a k-step).
    sm90::fence_operand(o);
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) o[i] *= (i & 2) ? corr_b : corr_a;
    uint32_t p[kBK / 16][4];
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      p[j][0] = sm90::pack_bf16x2(s[8 * j], s[8 * j + 1]);
      p[j][1] = sm90::pack_bf16x2(s[8 * j + 2], s[8 * j + 3]);
      p[j][2] = sm90::pack_bf16x2(s[8 * j + 4], s[8 * j + 5]);
      p[j][3] = sm90::pack_bf16x2(s[8 * j + 6], s[8 * j + 7]);
    }
    sm90::fence_operand(o);
    sm90::wgmma_fence();
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j)
      sm90::wgmma_rs<HDP, 1>(o, p[j], sm90::desc_sw128(sV + j * 16 * 128, kBK * 128, 1024), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operand(o);
    sm90::mbar_arrive(&empty[ring.stage]);
    ring.next();
  }
}

}  // namespace attn
