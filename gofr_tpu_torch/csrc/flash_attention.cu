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
// What the design does about it: the mainloop of attn_sm90.cuh. Both
// products run on wgmma (the only way to the tensor cores' full rate), from
// 128-byte-swizzled shared-memory tiles; one block per (128 query rows,
// group of G query heads of one kv head, batch row), two consumer
// warpgroups of 64 rows and one producer warp. A block's rows are 128 / G
// consecutive tokens of G heads (G the largest power of two up to 8 that
// divides n_heads / n_kv), so the G heads share each K/V tile staged in
// shared memory, as the rep heads of flash_cache_attention do: 4x fewer
// K/V bytes per FLOP at llama's GQA (measured 12% faster than one head a
// block at the training shape). The rows are a regular strided tensor, so
// the producer copies with TMA: the C entry encodes one tensor map each
// for q, k and v over [b, s, heads, hd] with the given strides (no copies
// of strided views; TMA zero-fills the ragged end of a box), and one
// thread keeps a ring of 2 K/V stages of 128 keys (64 at hd 256, whose Q
// tile and stages would not fit in shared memory otherwise; the Q box stays
// 128 rows) in flight ahead of the consumers. The key-tile loop stops at the last key any row of the block sees (the
// causal bound of its last row, clamped by lengths), so the cost follows
// the visible pairs; causal blocks launch longest first to shorten the
// tail. Scores and the online softmax state are f32 in registers with the
// TPU kernel's finite NEG_INF and explicitly masked probabilities, and
// P feeds P.V from registers, rounded to bf16. Window: the key tiles start
// at the first query row's window edge rounded down to 64 keys, so tiles
// wholly below it are never read, and a row's own edge masks only the tiles
// that straddle it; whether that compare exists is a template flag, so
// window = 0 compiles to the unwindowed loop. hd 32 runs on a 64-column
// panel: the tensor maps describe the 32 real columns and TMA zero-fills
// the box's other 32, so both products see zeros there and the epilogue
// writes the 32 real columns only. hd 256 runs the same loop on four
// panels, with key tiles of 64 (S is then 32 registers a thread beside O's
// 128) and P.V as two products of 128 columns.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"
#include "attn_sm90.cuh"

namespace {

using attn::kBQ;
constexpr int kStages = 2;

// out: [b, s_q, n_heads, HD] contiguous; lengths: [b] int32 or null;
// window: causal sliding window (WINDOW: window > 0); group: G, the query
// heads of one kv head a block takes together (a power of two dividing
// n_heads / n_kv). Block row r is query token t0 + r / G of head h0 + r % G,
// so the G heads share each K/V stage. The tensor maps read q as [b, s,
// heads, HD] in boxes of (64 columns, G heads, 128 / G tokens, 1 batch
// row), which land as those rows, and k, v in boxes of (64, 1, BK, 1).
// Grid (ceil(s_q / (BQ / G)), n_heads / G, b).
template <int HD, bool WINDOW>
__global__ void __launch_bounds__(attn::kThreads, 1) flash_attention_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const int* __restrict__ lengths,
    __nv_bfloat16* __restrict__ out, int s_q, int s_kv, int n_heads, int n_kv, int group,
    int causal, int window, float scale) {
  constexpr int HDP = attn::padded<HD>();  // columns of a tile row: whole 64-column panels
  constexpr int BK = attn::block_keys<HD>();
  const int tile = gridDim.x - 1 - blockIdx.x;  // longest causal tiles first
  const int h0 = blockIdx.y * group;
  const int bi = blockIdx.z;
  const int kvh = h0 / (n_heads / n_kv);
  const int tpb = kBQ / group;  // query tokens per block
  const int t0 = tile * tpb;
  const int offset = s_kv - s_q;
  const int len = lengths ? max(0, min(lengths[bi], s_kv)) : s_kv;

  // The last key query token r sees; -1 when it sees none.
  auto last_key = [&](int r) -> int {
    return causal ? min(r + offset, len - 1) : len - 1;
  };
  // The first key query token r sees (its window's edge).
  auto first_key = [&](int r) -> int {
    return r + offset - window + 1;
  };
  // Block row r: its token, and its output row (null past s_q).
  auto token = [&](int r) -> int { return t0 + r / group; };
  auto out_row = [&](int r) -> uint32_t* {
    const int t = token(r);
    return t < s_q ? reinterpret_cast<uint32_t*>(
                         out + (((size_t)bi * s_q + t) * n_heads + h0 + r % group) * HD)
                   : nullptr;
  };

  const int ctx = last_key(min(t0 + tpb, s_q) - 1) + 1;  // keys any row of the block sees
  if (ctx <= 0) {  // no row of the block sees a key: zeros
    for (int idx = threadIdx.x; idx < kBQ * HD / 2; idx += attn::kThreads) {
      uint32_t* row = out_row(idx / (HD / 2));
      if (row) row[idx % (HD / 2)] = 0u;
    }
    return;
  }
  // Key tiles start at the first token's window edge, rounded down to 64 keys.
  const int kbase = WINDOW ? max(0, first_key(t0)) & ~63 : 0;
  const int n_kt = max(0, (ctx - kbase + BK - 1) / BK);

  const attn::Layout L = attn::layout<HD, kStages>(false, 0);
  unsigned char* smem = sm90::dyn_smem();
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  if (threadIdx.x == 0) attn::init_barriers<kStages>(bars, 1, 1);
  __syncthreads();

  if (threadIdx.x >= attn::kConsumerThreads) {  // producer warpgroup
    sm90::reg_dealloc<attn::kProducerRegs>();
    if (threadIdx.x == attn::kConsumerThreads) {
      sm90::mbar_arrive_expect_tx(&bars[0], kBQ * HDP * 2);
      for (int p = 0; p < HDP / 64; ++p)
        sm90::tma_load_4d(smem + L.q + p * kBQ * 128, &tq, &bars[0], 64 * p, h0, t0, bi);
      attn::Ring<kStages> ring;
      for (int it = 0; it < n_kt; ++it) {
        const int kc0 = kbase + it * BK;
        sm90::mbar_wait(&bars[1 + kStages + ring.stage], ring.phase ^ 1u);
        unsigned char* sK = smem + L.stages + ring.stage * 2 * BK * HDP * 2;
        unsigned char* sV = sK + BK * HDP * 2;
        uint64_t* full = &bars[1 + ring.stage];
        // TMA counts the whole box, zero-filled rows past s_kv (and columns
        // past hd) included.
        sm90::mbar_arrive_expect_tx(full, 2 * BK * HDP * 2);
        for (int p = 0; p < HDP / 64; ++p) {
          sm90::tma_load_4d(sK + p * BK * 128, &tk, full, 64 * p, kvh, kc0, bi);
          sm90::tma_load_4d(sV + p * BK * 128, &tv, full, 64 * p, kvh, kc0, bi);
        }
        ring.next();
      }
    }
    return;
  }

  sm90::reg_alloc<attn::kConsumerRegs>();
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  // This thread's rows (fragment rows g and g + 8 of its warp), and its
  // warpgroup's first row and last row that is written.
  const int ra = wg * 64 + (t / 32) * 16 + (t % 32) / 4;
  const int rb = ra + 8;
  const int w0 = token(wg * 64);
  const int w1 = min(token(wg * 64 + 63), s_q - 1);
  attn::Rows R;
  R.lim_a = token(ra) < s_q ? last_key(token(ra)) : -1;
  R.lim_b = token(rb) < s_q ? last_key(token(rb)) : -1;
  R.lo_a = WINDOW ? first_key(token(ra)) : 0;
  R.lo_b = WINDOW ? first_key(token(rb)) : 0;
  R.active = w0 < s_q;
  R.wlim = R.active ? last_key(w0) : -1;
  R.wlo = WINDOW ? first_key(w1) : 0;
  float o[HDP / 2], l_a, l_b;
  attn::consume<HDP, BK, kStages, WINDOW, false>(smem, L, wg, R, kbase, n_kt, scale, o, l_a,
                                                 l_b);

  // Rows that saw no key have l == 0 and o == 0: they write exact zeros.
  const int q4 = t & 3;
  const float inv_a = l_a > 0.f ? 1.f / l_a : 0.f;
  const float inv_b = l_b > 0.f ? 1.f / l_b : 0.f;
  if (uint32_t* oa = out_row(ra)) {
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      oa[4 * j + q4] = sm90::pack_bf16x2(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
  }
  if (uint32_t* ob = out_row(rb)) {
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      ob[4 * j + q4] = sm90::pack_bf16x2(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b);
  }
}

// A tensor map over a [b, s, heads, HD] bf16 view with element strides
// (batch, sequence, head) and unit stride along HD, in boxes of 64 columns
// (for HD 32, 32 of them past the tensor's edge: zeros), `heads_box` heads
// and `rows_box` rows.
template <int HD>
int tensor_map(CUtensorMap* map, const void* base, int b, int s, int heads, long long sb,
               long long ss, long long sh, int heads_box, int rows_box) {
  const uint64_t dims[4] = {(uint64_t)HD, (uint64_t)heads, (uint64_t)max(s, 1), (uint64_t)b};
  const uint64_t strides[3] = {(uint64_t)sh * 2, (uint64_t)ss * 2, (uint64_t)sb * 2};
  const uint32_t box[4] = {64, (uint32_t)heads_box, (uint32_t)rows_box, 1};
  return sm90::make_tensor_map_bf16(map, base, dims, strides, box);
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* lengths, void* out,
                   const long long* st, int b, int s_q, int s_kv, int n_heads, int n_kv,
                   int causal, int window, float scale, cudaStream_t stream) {
  // The query heads a block takes together: the largest power of two that
  // divides the GQA group (capped so a block keeps at least 16 tokens).
  const int rep = n_heads / n_kv;
  int group = 1;
  while (group < 8 && rep % (2 * group) == 0) group *= 2;
  CUtensorMap tq, tk, tv;
  constexpr int BK = attn::block_keys<HD>();
  int err = tensor_map<HD>(&tq, q, b, s_q, n_heads, st[0], st[1], st[2], group, kBQ / group);
  if (err == cudaSuccess)
    err = tensor_map<HD>(&tk, k, b, s_kv, n_kv, st[3], st[4], st[5], 1, BK);
  if (err == cudaSuccess)
    err = tensor_map<HD>(&tv, v, b, s_kv, n_kv, st[6], st[7], st[8], 1, BK);
  if (err != cudaSuccess) return static_cast<cudaError_t>(err);
  const size_t smem = attn::smem_request<HD, kStages>(false, 0);
  if (smem > attn::kMaxSmem) return cudaErrorInvalidValue;
  const int tpb = kBQ / group;
  const dim3 grid((s_q + tpb - 1) / tpb, n_heads / group, b);
  auto kernel = window > 0 ? flash_attention_kernel<HD, true> : flash_attention_kernel<HD, false>;
  const cudaError_t attr = window > 0 ? attn::allow_smem<flash_attention_kernel<HD, true>>()
                                      : attn::allow_smem<flash_attention_kernel<HD, false>>();
  if (attr != cudaSuccess) return attr;
  kernel<<<grid, attn::kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<const int*>(lengths), static_cast<__nv_bfloat16*>(out), s_q, s_kv,
      n_heads, n_kv, group, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// C entry bound with ctypes (gofr_tpu_torch/ops/cuda/flash_attention.py).
// strides: the 9 element strides of q, k, v (batch, sequence, head axes),
// each a multiple of 8 (16 bytes, as TMA needs; so must the bases be
// aligned). lengths may be null; window 0 (none) or a causal sliding
// window. Returns the cudaError_t of the launch (0 on success).
extern "C" int gofr_flash_attention(const void* q, const void* k, const void* v,
                                    const void* lengths, void* out, int b, int s_q,
                                    int s_kv, int n_heads, int n_kv, int head_dim,
                                    int causal, int window, const long long* strides,
                                    float scale, void* stream) {
  if (b <= 0 || s_q <= 0 || s_kv < 0 || n_kv <= 0 || n_heads % n_kv != 0 || window < 0 ||
      (window > 0 && !causal))
    return cudaErrorInvalidValue;
  for (int i = 0; i < 9; ++i)
    if (strides[i] % 8 != 0) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t sm = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return launch<32>(q, k, v, lengths, out, strides, b, s_q, s_kv, n_heads, n_kv, causal,
                        window, scale, sm);
    case 64:
      return launch<64>(q, k, v, lengths, out, strides, b, s_q, s_kv, n_heads, n_kv, causal,
                        window, scale, sm);
    case 128:
      return launch<128>(q, k, v, lengths, out, strides, b, s_q, s_kv, n_heads, n_kv, causal,
                         window, scale, sm);
    case 256:
      return launch<256>(q, k, v, lengths, out, strides, b, s_q, s_kv, n_heads, n_kv, causal,
                         window, scale, sm);
    default: return cudaErrorInvalidValue;
  }
}
