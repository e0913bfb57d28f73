// flash_decode for Hopper (sm_90a): one query token per slot attends that
// slot's KV-cache prefix.
//
// Replaces: gofr_tpu/ops/pallas/flash_decode.py::flash_decode (bf16, f32 or
// int8 cache, contiguous or paged; the split convention, where the current
// token's k_new/v_new merge at the end and `lengths` excludes it, and the
// already-written convention, where `lengths` includes it; Mistral's
// sliding window, where the query at q_pos = length (split) or length - 1
// (written) sees only keys in (q_pos - window, q_pos]).
//
// What bounds it on the H100: bytes. A step reads the visible rows of every
// slot's cache once (K and V: hd values each, 2 bytes in bf16, 4 in f32,
// 1 plus a 4-byte scale in int8) and does about 2 FLOPs per byte read, far
// below the ~295 FLOP/byte ridge of the card, so the floor is those bytes
// over 3.35 TB/s.
//
// What the design does about it: spreads each slot's keys over more SMs,
// keeps bytes in flight without registers, and gives the arithmetic enough
// warps (measured on an H100: with the copies alone, a Mistral-7B window
// of 67 MB moves in ~28 us; the scores and softmax, on 4 consumer warps a
// block, took ~50 us; see PERF.md).
//
// - Split-K over a thread-block cluster. Each (slot, kv head) gets a
//   cluster of C blocks (1, 2, 4 or 8; the wrapper picks the largest C whose
//   grid the card runs in one wave: an H100 holds 66 clusters of 2 of these
//   blocks but only 30 of 4, so 32 (slot, kv head) pairs at C = 4 would run
//   in two waves), launched once with a cluster dimension. The visible
//   range [k_lo, length) is cut into key tiles of TK rows (aligned to TK
//   in the slot's logical key space), and rank r takes a contiguous run of
//   them; a rank with no visible key contributes m = NEG_INF, l = 0, and so
//   nothing. Each rank merges its warps' states into one (m, l, acc) in its
//   shared memory; after a cluster barrier, every rank merges the ranks'
//   states in rank order through distributed shared memory (mapa) for its
//   own slice of the output's REP x HD values, in split mode merges the new
//   token last, and writes that slice; a second barrier keeps every rank's
//   shared memory alive until its peers have read it. One launch per call,
//   no global scratch, no second combine kernel.
// - Bytes in flight without registers. One producer warp copies each tile's
//   K and V rows into a ring of kStages shared-memory stages with 1-D bulk
//   copies (the copy engine; no tensor map, so nothing is encoded on the
//   host), one copy per run of rows contiguous in memory: a tile of a slot
//   cache is one copy, a tile of a pool one per page it touches, each
//   page's address from the slot's table row staged in shared memory. An
//   int8 tile's scales (4 bytes a row) come by 4-byte cp.async whose
//   arrival the same stage's mbarrier waits for. Each stage has a full and
//   an empty mbarrier. Only the visible rows [k_lo, length) of a tile are
//   copied, and the consumers read only those: rows below the window, past
//   the length, or in the parking block are never read.
// - Consumers: consumer_warps() warps compute the REP scores of each key row
//   from shared memory on CUDA cores (at ~2 FLOP a byte, the tensor cores
//   would buy nothing). A key row of hd values is split over hd/8 lanes of
//   8 values each; rows are dealt to (warp, lane group) by their logical
//   index j, so the arithmetic depends on (j, k_lo, length, C) and never on
//   where a row lives: a pool gives the slot cache's result bit for bit.
//   Each lane group keeps its online softmax (running max, denominator,
//   accumulator) in f32 registers, in increasing j; groups merge by warp
//   shuffles, warps through shared memory in a fixed order, ranks in rank
//   order, so a result does not change from run to run. Empty and masked
//   states use the TPU kernel's finite NEG_INF = -1e30: an empty prefix
//   gives exp(-1e30 - s) = 0 instead of NaN, and split mode returns the new
//   token alone, the written convention 0.
//
// Window: k_lo = max(0, q_pos - window + 1); window = 0 gives k_lo = 0.
//
// Int8: the row's 8 values widen exactly to f32. As in the TPU kernel, the
// score is (q.k) * scale * k_scale[j], the denominator takes the
// probability before the V scale, and only the P.V product sees
// p * v_scale[j]; the split convention's new token arrives already
// fake-quantized in the query's type and merges unscaled.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;
// Consumer warps of a block: 12 (3 a scheduler, to hide each other's
// latency; one block fills an SM's registers), 4 at REP 8, whose larger
// state leaves room for fewer. Threads: those and the producer warp.
template <int REP>
__host__ __device__ constexpr int consumer_warps() {
  return REP <= 4 ? 12 : 4;
}
template <int REP>
__host__ __device__ constexpr int threads() {
  return (consumer_warps<REP>() + 1) * 32;
}
constexpr int kStages = 4;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kTileBytes = 12288;

// Rows of a key tile: kTileBytes of K (and of V) per stage, 16 to 128
// rows. ops/cuda/flash_decode.py::tile_rows computes the same.
template <int HD, typename TC>
__host__ __device__ constexpr int tile_rows() {
  return kTileBytes / (HD * (int)sizeof(TC)) < 16    ? 16
         : kTileBytes / (HD * (int)sizeof(TC)) > 128 ? 128
                                                     : kTileBytes / (HD * (int)sizeof(TC));
}

// Eight values from 16 bytes of bf16, 8 of int8 or 32 of f32, widened to
// f32 (exactly: a bf16 is the top half of an f32, an int8 a small integer).
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load8(const int8_t* p, float (&f)[8]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const uint32_t w[2] = {raw.x, raw.y};
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = (float)(int8_t)(w[i / 4] >> (8 * (i % 4)));
}
__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

// Byte offsets of a block's shared memory (from a 1024-byte boundary): the
// ring (kStages x (K tile, V tile)), the int8 scales (kStages x (K, V) x TK
// f32), the warps' states, the block's merged state (read by rank 0), the
// new token's scores, the slot's table entries, then the mbarriers
// (kStages full, kStages empty).
struct Layout {
  uint32_t ring, scales, acc, m, l, pub_acc, pub_m, pub_l, sn, tab, bars, total;
};

template <typename TC, int HD, int REP>
__host__ __device__ inline Layout layout(bool quant, int n_tab) {
  constexpr int TK = tile_rows<HD, TC>();
  constexpr int NW = consumer_warps<REP>();
  Layout L{};
  L.ring = 0;
  L.scales = L.ring + kStages * 2 * TK * HD * (uint32_t)sizeof(TC);
  L.acc = L.scales + (quant ? kStages * 2 * TK * 4 : 0);
  L.m = L.acc + NW * REP * HD * 4;
  L.l = L.m + NW * REP * 4;
  L.pub_acc = L.l + NW * REP * 4;
  L.pub_m = L.pub_acc + REP * HD * 4;
  L.pub_l = L.pub_m + REP * 4;
  L.sn = L.pub_l + REP * 4;
  L.tab = L.sn + REP * 4;
  L.bars = (L.tab + 4 * (uint32_t)n_tab + 7u) & ~7u;
  L.total = L.bars + 2 * kStages * 8;
  return L;
}

struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next() {
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

// q: [S, n_kv*REP, HD] TQ (bf16 or f32); caches TC (TQ, or int8 with f32
// k_scale/v_scale of the caches' shape without HD): [S, n_kv, B, HD]
// (contiguous, B = max_len) or a pool [n_blocks, n_kv, B, HD] with
// block_table [S, n_tab] int32 (n_tab = 0: contiguous); lengths: [S]
// int32; k_new/v_new: [S, n_kv, HD] TQ or null; out: [S, n_kv*REP, HD] TQ;
// window: sliding window, 0 = none. Grid (C, S, n_kv) in clusters of (C, 1,
// 1): blockIdx.x is the block's rank.
template <typename TQ, typename TC, int HD, int REP>
__global__ void __launch_bounds__(threads<REP>()) flash_decode_kernel(
    const TQ* __restrict__ q, const TC* __restrict__ k_cache, const TC* __restrict__ v_cache,
    const int* __restrict__ lengths, const TQ* __restrict__ k_new,
    const TQ* __restrict__ v_new, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ block_table,
    TQ* __restrict__ out, int n_kv, int B, int n_tab, int window, float scale) {
  constexpr bool kQuant = sizeof(TC) == 1;
  constexpr int TK = tile_rows<HD, TC>();
  constexpr int NW = consumer_warps<REP>();
  constexpr int kThreads = threads<REP>();
  constexpr int LPK = HD / 8;  // lanes per key row, 8 values each
  constexpr int KPW = 32 / LPK;  // rows one warp covers per step
  constexpr int U = 2;  // rows a lane group takes per step, one rescale for them
  constexpr uint32_t kRowBytes = HD * sizeof(TC);
  static_assert(HD % 8 == 0 && 32 % LPK == 0, "HD must be 32, 64, 128 or 256");
  static_assert(TK % KPW == 0 && (kRowBytes % 16) == 0, "tiles of whole 16-byte rows");

  const int C = gridDim.x;
  const int rank = blockIdx.x;
  const int slot = blockIdx.y;
  const int kvh = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool paged = n_tab > 0;
  const int length = max(0, min(lengths[slot], paged ? n_tab * B : B));
  const bool has_new = k_new != nullptr;
  // First visible key: the window's edge below the query's position.
  const int k_lo = window > 0 ? max(0, (has_new ? length : length - 1) - window + 1) : 0;
  // Key tiles [t_lo, t_lo + n_t) hold the visible keys; this rank takes
  // tiles [my0, my1) and, of them, the keys [lo, hi).
  const int t_lo = k_lo / TK;
  const int n_t = length > k_lo ? (length + TK - 1) / TK - t_lo : 0;
  const int my0 = t_lo + n_t * rank / C, my1 = t_lo + n_t * (rank + 1) / C;
  const int lo = max(k_lo, my0 * TK), hi = min(length, my1 * TK);

  const Layout L = layout<TC, HD, REP>(kQuant, n_tab);
  unsigned char* smem = sm90::dyn_smem();
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + kStages;
  float* sm_acc = reinterpret_cast<float*>(smem + L.acc);  // [NW][REP][HD]
  float* sm_m = reinterpret_cast<float*>(smem + L.m);      // [NW][REP]
  float* sm_l = reinterpret_cast<float*>(smem + L.l);      // [NW][REP]
  float* pub_acc = reinterpret_cast<float*>(smem + L.pub_acc);  // [REP][HD]
  float* pub_m = reinterpret_cast<float*>(smem + L.pub_m);      // [REP]
  float* pub_l = reinterpret_cast<float*>(smem + L.pub_l);      // [REP]
  float* sm_sn = reinterpret_cast<float*>(smem + L.sn);         // [REP]
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      // The producer's announcing arrival, plus its 32 lanes' cp.async
      // arrivals for an int8 tile's scales.
      sm90::mbar_init(&full[s], kQuant ? 1 + 32 : 1);
      sm90::mbar_init(&empty[s], NW * 32);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const size_t head0 = ((size_t)slot * n_kv + kvh) * REP;
  if (warp == NW) {  // producer
    int* sm_tab = reinterpret_cast<int*>(smem + L.tab);  // paged: [n_tab]
    if (paged && hi > lo) {
      for (int i = lo / B + lane; i <= (hi - 1) / B; i += 32)
        sm_tab[i] = block_table[(size_t)slot * n_tab + i];
      __syncwarp();
    }
    // Cache row of logical key j: rows are [block][n_kv][B], the slot itself
    // being the block of a contiguous cache.
    auto row_of = [&](int j) -> size_t {
      if (!paged) return ((size_t)slot * n_kv + kvh) * (size_t)B + j;
      const int b = j / B;
      return ((size_t)sm_tab[b] * n_kv + kvh) * (size_t)B + (j - b * B);
    };
    Ring ring;
    for (int t = my0; t < my1; ++t) {
      const int a = max(lo, t * TK), b = min(hi, (t + 1) * TK);
      sm90::mbar_wait(&empty[ring.stage], ring.phase ^ 1u);
      unsigned char* sK = smem + L.ring + ring.stage * 2 * TK * kRowBytes;
      unsigned char* sV = sK + TK * kRowBytes;
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(&full[ring.stage], 2 * (b - a) * kRowBytes);
        // One copy per run of rows contiguous in memory (a pool's page).
        for (int j = a; j < b;) {
          const int e = paged ? min(b, (j / B + 1) * B) : b;
          const size_t row = row_of(j);
          const uint32_t off = (j - t * TK) * kRowBytes, bytes = (e - j) * kRowBytes;
          sm90::bulk_load(sK + off, k_cache + row * HD, bytes, &full[ring.stage]);
          sm90::bulk_load(sV + off, v_cache + row * HD, bytes, &full[ring.stage]);
          j = e;
        }
      }
      if constexpr (kQuant) {
        float* sc = reinterpret_cast<float*>(smem + L.scales) + ring.stage * 2 * TK;
        for (int j = a + lane; j < b; j += 32) {
          const size_t row = row_of(j);
          sm90::cp_async4(&sc[j - t * TK], &k_scale[row]);
          sm90::cp_async4(&sc[TK + j - t * TK], &v_scale[row]);
        }
        sm90::cp_async_mbar_arrive(&full[ring.stage]);
      }
      ring.next();
    }
  } else {  // consumers
    const int sub = lane / LPK;   // which row of the warp's KPW
    const int part = lane % LPK;  // which 8 dims of that row
    // This lane's 8 dims of each query head of the group, f32, pre-scaled.
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

    Ring ring;
    for (int t = my0; t < my1; ++t) {
      const int a = max(lo, t * TK), b = min(hi, (t + 1) * TK);
      sm90::mbar_wait(&full[ring.stage], ring.phase);
      const TC* sK = reinterpret_cast<const TC*>(smem + L.ring + ring.stage * 2 * TK * kRowBytes);
      const TC* sV = sK + TK * HD;
      const float* sks = reinterpret_cast<const float*>(smem + L.scales) + ring.stage * 2 * TK;
      // Row j belongs to warp (j / KPW) % NW, lane group j % KPW. `blk` is
      // warp-uniform, so every lane of a warp runs the same iterations and
      // the shuffles below see the whole warp.
      int blk = a / KPW;
      blk += ((warp - blk % NW) % NW + NW) % NW;
      for (; blk * KPW < b; blk += NW * U) {
        float kf[U][8], vf[U][8], ks[U], vs[U];
        bool ok[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int j = (blk + u * NW) * KPW + sub;
          ok[u] = j >= a && j < b;
          ks[u] = vs[u] = 1.f;
          if (ok[u]) {
            load8(sK + (j - t * TK) * HD + part * 8, kf[u]);
            load8(sV + (j - t * TK) * HD + part * 8, vf[u]);
            if (kQuant) {
              ks[u] = sks[j - t * TK];
              vs[u] = sks[TK + j - t * TK];
            }
          } else {
#pragma unroll
            for (int i = 0; i < 8; ++i) kf[u][i] = vf[u][i] = 0.f;
          }
        }
        // The U rows' scores (each summed over the row's LPK lanes), then one
        // online-softmax step for all of them: a single rescale of the state
        // per U rows, and no chain from one row's update to the next.
        float s[U][REP];
#pragma unroll
        for (int u = 0; u < U; ++u) {
#pragma unroll
          for (int r = 0; r < REP; ++r) {
            float d = 0.f;
#pragma unroll
            for (int i = 0; i < 8; ++i) d += qf[r][i] * kf[u][i];
            s[u][r] = d;
          }
        }
#pragma unroll
        for (int off = LPK / 2; off > 0; off >>= 1) {
#pragma unroll
          for (int u = 0; u < U; ++u) {
#pragma unroll
            for (int r = 0; r < REP; ++r) s[u][r] += __shfl_xor_sync(kFullMask, s[u][r], off);
          }
        }
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          float m_new = m[r];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (kQuant) s[u][r] *= ks[u];
            if (ok[u]) m_new = fmaxf(m_new, s[u][r]);
          }
          const float corr = __expf(m[r] - m_new);
          float psum = 0.f, pv[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const float p = ok[u] ? __expf(s[u][r] - m_new) : 0.f;
            psum += p;  // the denominator takes p before the V scale
            pv[u] = kQuant ? p * vs[u] : p;
          }
          l[r] = l[r] * corr + psum;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            float a = acc[r][i] * corr;
#pragma unroll
            for (int u = 0; u < U; ++u) a += pv[u] * vf[u][i];
            acc[r][i] = a;
          }
          m[r] = m_new;
        }
      }
      sm90::mbar_arrive(&empty[ring.stage]);
      ring.next();
    }

    // Merge the warp's row groups (lanes that differ in `sub`). Both lanes of
    // a pair compute the same sums in swapped order, which float addition
    // makes bit-identical.
#pragma unroll
    for (int off = LPK; off < 32; off <<= 1) {
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const float mo = __shfl_xor_sync(kFullMask, m[r], off);
        const float lo_ = __shfl_xor_sync(kFullMask, l[r], off);
        const float mn = fmaxf(m[r], mo);
        const float ca = __expf(m[r] - mn);
        const float cb = __expf(mo - mn);
        l[r] = l[r] * ca + lo_ * cb;
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
    if (has_new) {
      // The current token's score for each query head, one warp per head.
      const size_t new_row = ((size_t)slot * n_kv + kvh) * HD;
      for (int r = warp; r < REP; r += NW) {
        const TQ* qr = q + (head0 + r) * HD;
        float s = 0.f;
        for (int d = lane; d < HD; d += 32) s += to_f32(qr[d]) * to_f32(k_new[new_row + d]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFullMask, s, off);
        if (lane == 0) sm_sn[r] = s * scale;
      }
    }
  }
  __syncthreads();

  // The block's state: its warps merged in a fixed order.
  for (int idx = threadIdx.x; idx < REP * HD; idx += kThreads) {
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
    pub_acc[idx] = num;
    if (d == 0) {
      pub_m[r] = mx;
      pub_l[r] = den;
    }
  }
  if (C > 1) sm90::cluster_sync();  // every rank's state is published
  else __syncthreads();

  // The output: the ranks' states merged in rank order. Each rank takes a
  // slice of the REP x HD elements (the same arithmetic whichever rank does
  // it), reading its peers' states through distributed shared memory with
  // the loads of all ranks issued together.
  {
    const size_t new_row = ((size_t)slot * n_kv + kvh) * HD;
    const int per = (REP * HD + C - 1) / C;
    for (int idx = rank * per + threadIdx.x; idx < min(REP * HD, (rank + 1) * per);
         idx += kThreads) {
      const int r = idx / HD;
      const int d = idx % HD;
      float mc[kMaxCluster];
#pragma unroll
      for (int c = 0; c < kMaxCluster; ++c)
        mc[c] = c < C ? *sm90::cluster_map(pub_m + r, c) : kNegInf;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kMaxCluster; ++c) mx = fmaxf(mx, mc[c]);
      float den = 0.f, num = 0.f;
#pragma unroll
      for (int c = 0; c < kMaxCluster; ++c) {
        if (c < C) {
          const float cc = __expf(mc[c] - mx);
          den += *sm90::cluster_map(pub_l + r, c) * cc;
          num += *sm90::cluster_map(pub_acc + idx, c) * cc;
        }
      }
      float o;
      if (has_new) {
        const float sn = sm_sn[r];
        const float mn = fmaxf(mx, sn);
        const float c = __expf(mx - mn);
        const float e = __expf(sn - mn);
        const float vn = to_f32(v_new[new_row + d]);
        o = (num * c + e * vn) / (den * c + e);
      } else {
        o = den > 0.f ? num / den : 0.f;
      }
      out[(head0 + r) * HD + d] = from_f32<TQ>(o);
    }
  }
  if (C > 1) sm90::cluster_sync();  // no rank leaves while a peer reads it
}

// Dynamic shared memory of an instantiation, with its limit raised to the
// H100's 227 KB once per process (a host call that would otherwise cost
// every launch).
template <typename TQ, typename TC, int HD, int REP>
cudaError_t prepare(int n_tab, size_t* smem) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_decode_kernel<TQ, TC, HD, REP>, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  *smem = layout<TC, HD, REP>(sizeof(TC) == 1, n_tab).total + 1024;
  return attr;
}

struct Launch {
  const void *q, *k_cache, *v_cache, *lengths, *k_new, *v_new, *k_scale, *v_scale,
      *block_table;
  void* out;
  int n_slots, n_kv, B, n_tab, window, cluster;
  float scale;
  cudaStream_t stream;

  template <typename TQ, typename TC, int HD, int REP>
  int run() const {
    size_t smem;
    const cudaError_t attr = prepare<TQ, TC, HD, REP>(n_tab, &smem);
    if (attr != cudaSuccess) return attr;
    const cudaError_t err = sm90::launch_cluster(
        flash_decode_kernel<TQ, TC, HD, REP>, dim3(cluster, n_slots, n_kv),
        dim3(threads<REP>()), smem, stream, cluster, static_cast<const TQ*>(q),
        static_cast<const TC*>(k_cache), static_cast<const TC*>(v_cache),
        static_cast<const int*>(lengths), static_cast<const TQ*>(k_new),
        static_cast<const TQ*>(v_new), static_cast<const float*>(k_scale),
        static_cast<const float*>(v_scale), static_cast<const int*>(block_table),
        static_cast<TQ*>(out), n_kv, B, n_tab, window, scale);
    return err != cudaSuccess ? err : cudaGetLastError();
  }
};

struct MaxClusters {
  int n_tab, cluster;

  template <typename TQ, typename TC, int HD, int REP>
  int run() const {
    size_t smem;
    const cudaError_t attr = prepare<TQ, TC, HD, REP>(n_tab, &smem);
    if (attr != cudaSuccess) return -(int)attr;
    return sm90::max_active_clusters(flash_decode_kernel<TQ, TC, HD, REP>,
                                     dim3(threads<REP>()), smem, cluster);
  }
};

// f.run<TQ, TC, HD, REP>() for the query type (bf16 or f32), the cache type
// (the query's or int8), the head dim and the GQA ratio; `bad` for any other.
template <typename TQ, typename TC, int HD, typename F>
int dispatch_rep(int rep, const F& f, int bad) {
  switch (rep) {
    case 1: return f.template run<TQ, TC, HD, 1>();
    case 2: return f.template run<TQ, TC, HD, 2>();
    case 4: return f.template run<TQ, TC, HD, 4>();
    case 8: return f.template run<TQ, TC, HD, 8>();
    default: return bad;
  }
}

template <typename TQ, typename TC, typename F>
int dispatch_hd(int head_dim, int rep, const F& f, int bad) {
  switch (head_dim) {
    case 32: return dispatch_rep<TQ, TC, 32>(rep, f, bad);
    case 64: return dispatch_rep<TQ, TC, 64>(rep, f, bad);
    case 128: return dispatch_rep<TQ, TC, 128>(rep, f, bad);
    case 256: return dispatch_rep<TQ, TC, 256>(rep, f, bad);
    default: return bad;
  }
}

template <typename F>
int dispatch(int q_f32, bool quant, int head_dim, int rep, const F& f, int bad) {
  if (q_f32) {
    return quant ? dispatch_hd<float, int8_t>(head_dim, rep, f, bad)
                 : dispatch_hd<float, float>(head_dim, rep, f, bad);
  }
  return quant ? dispatch_hd<__nv_bfloat16, int8_t>(head_dim, rep, f, bad)
               : dispatch_hd<__nv_bfloat16, __nv_bfloat16>(head_dim, rep, f, bad);
}

}  // namespace

// C entry bound with ctypes (gofr_tpu_torch/ops/cuda/flash_decode.py). q,
// k_new, v_new and out are bf16 (q_f32 0) or f32 (1); k_new and v_new are
// both null (already-written convention) or both set (split); k_scale and
// v_scale both null (caches of the query's type) or both set (int8
// caches); block_table null with n_tab 0 (contiguous, B = max_len) or set
// with n_tab its width (paged, B the pool's block, a multiple of 16); window
// 0 (none) or the sliding window; cluster: blocks per (slot, kv head), 1,
// 2, 4 or 8. Returns the cudaError_t of the launch (0 on success).
extern "C" int gofr_flash_decode(const void* q, const void* k_cache, const void* v_cache,
                                 const void* lengths, const void* k_new, const void* v_new,
                                 const void* k_scale, const void* v_scale,
                                 const void* block_table, void* out, int n_slots, int n_heads,
                                 int n_kv, int B, int n_tab, int head_dim, int window, int q_f32,
                                 int cluster, float scale, void* stream_ptr) {
  if (n_slots <= 0 || n_kv <= 0 || n_heads % n_kv != 0 || B <= 0 ||
      (k_new == nullptr) != (v_new == nullptr) || (k_scale == nullptr) != (v_scale == nullptr) ||
      (block_table == nullptr) != (n_tab == 0) || n_tab < 0 || (n_tab > 0 && B % 16 != 0) ||
      window < 0 || (q_f32 != 0 && q_f32 != 1) ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8))
    return cudaErrorInvalidValue;
  const Launch launch{q, k_cache, v_cache, lengths, k_new, v_new, k_scale, v_scale,
                      block_table, out, n_slots, n_kv, B, n_tab, window, cluster, scale,
                      static_cast<cudaStream_t>(stream_ptr)};
  return dispatch(q_f32, k_scale != nullptr, head_dim, n_heads / n_kv, launch,
                  cudaErrorInvalidValue);
}

// How many clusters of `cluster` blocks of the instantiation for these
// types and shapes (n_tab: the table width, 0 for a contiguous cache) the
// card runs at once; negative on an error. The wrapper picks its cluster
// size from it.
extern "C" int gofr_flash_decode_max_clusters(int head_dim, int rep, int q_f32, int quant,
                                              int n_tab, int cluster) {
  if (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) return -cudaErrorInvalidValue;
  return dispatch(q_f32, quant != 0, head_dim, rep, MaxClusters{n_tab, cluster},
                  -cudaErrorInvalidValue);
}
