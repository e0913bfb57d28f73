"""Device programs of the serving engine: the sampler, the chunked-prefill
step, the multi-chunk prefill, the k-step decode window and the mega
window — the port of the reference's ``serving/programs.py`` (``sample``,
``row_keys``, ``_prefill_core``, ``prefill_multi_chunk``,
``make_decode_body``/``decode_window``, ``mega_window``), without
speculation.

PyTorch runs eagerly, so a "program" is a function that enqueues its
work on the current stream and returns device tensors; the per-slot
planes (``SlotPlanes``) are updated in place on the device, and the host
reads one block per decode window. On the card the engine replays the
decode programs as CUDA graphs (``DecodeGraphs``): the reference's one
jitted dispatch per window is one graph launch here, and the mega
window's device-side exit is a conditional WHILE node
(``ops/cuda/graph_while.py``).

The sampler runs the reference's order: ``logit_bias`` on the raw f32
logits, then frequency/presence penalties over the generated tokens,
then the greedy argmax; sampled rows then take ``logits / temperature``,
the engine-wide top-k and the per-slot nucleus (top-p). The reported
logprob, and the ``top_logprobs`` alternatives, are the log-softmax of
the biased and penalised logits. Each feature runs only when the
engine enables it (``SamplerFlags``, the reference's compile choices);
the logit bias runs only on a call some row of which has one (the
reference's ``use_bias``). A neutral row's options are exact no-ops (a
zero bias or penalty, ``top_p`` 1), so its logits are bit-identical
with the features on or off.

Sampling is counter-based, in the spirit of the reference's
``fold_in(fold_in(base, seed), n)`` keys: the noise of a request's n-th
sampled token is a hash of (engine seed, request seed, n, vocab index),
so a seeded stream is the same whatever else shares the batch. The
draw is Gumbel-max over the filtered ``logits / temperature``, an exact
categorical sample. It does not reproduce JAX's threefry bits.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from gofr_tpu_torch.models.transformer import (
    Rope,
    TransformerConfig,
    decode_step,
    prefill_chunk,
)
from gofr_tpu_torch.ops.cuda import _count, record_counts
from gofr_tpu_torch.ops.kv_cache import KVCache, PagedKVCache
from gofr_tpu_torch.serving.types import LOGIT_BIAS_K

_M32 = 0xFFFFFFFF
_MIX = 0x45D9F3B  # < 2**27: a 32-bit value times it stays inside int64
_GOLDEN = 0x9E3779B9
_NEG_INF = float("-inf")


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash on int64 tensors holding values in [0, 2**32)."""
    x = (((x >> 16) ^ x) * _MIX) & _M32
    x = (((x >> 16) ^ x) * _MIX) & _M32
    return (x >> 16) ^ x


def counter_uniform(
    base_seed: int, seeds: torch.Tensor, counters: torch.Tensor, n: int
) -> torch.Tensor:
    """[rows, n] f32 uniforms in (0, 1), a pure function of (base_seed,
    seeds[row], counters[row], column): the same row key gives the same
    draws on any batch."""
    key = _mix32((seeds.long() ^ (base_seed & _M32)) & _M32)
    key = _mix32((key + (counters.long() & _M32) * _GOLDEN) & _M32)
    cols = torch.arange(n, device=seeds.device, dtype=torch.long)
    h = _mix32(_mix32((key[:, None] + cols[None, :]) & _M32))
    return ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))


def gumbel_noise(
    base_seed: int, seeds: torch.Tensor, counters: torch.Tensor, n: int
) -> torch.Tensor:
    """[rows, n] standard Gumbel noise from the counter-based uniforms."""
    return -torch.log(-torch.log(counter_uniform(base_seed, seeds, counters, n)))


@dataclass(frozen=True)
class SamplerFlags:
    """The sampler features an engine enables (the reference compiles each
    into its programs only when enabled): the engine-wide ``top_k`` (0 =
    off), the per-slot nucleus, the frequency/presence penalties and the
    number of ``top_logprobs`` alternatives."""

    top_k: int = 0
    top_p: bool = False
    penalties: bool = False
    top_logprobs: int = 0


def sample(
    logits: torch.Tensor,
    seeds: torch.Tensor,
    counters: torch.Tensor,
    temps: torch.Tensor,
    greedy: torch.Tensor,
    topps: torch.Tensor,
    base_seed: int,
    flags: SamplerFlags,
    *,
    sampling: bool,
    bias: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    pen: Optional[tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(token [rows] int64, logprob [rows] f32, top ids [rows, T] int64,
    top logprobs [rows, T] f32); the last two are None unless
    ``flags.top_logprobs``.

    bias: (idx [rows, K] int64 padded with -1, val [rows, K] f32), added
    to the raw logits. pen: (counts [rows, V] int32 of generated tokens,
    frequency [rows], presence [rows]). ``sampling`` is host-known: some
    row is not greedy."""
    logits = logits.float()
    if bias is not None:
        bidx, bval = bias
        logits = logits.scatter_add(
            1, bidx.clamp(min=0), torch.where(bidx >= 0, bval, 0.0)
        )
    if pen is not None:
        counts, fpen, ppen = pen
        cf = counts.float()
        logits = (
            logits - fpen[:, None] * cf - ppen[:, None] * (cf > 0).float()
        )
    chosen = torch.argmax(logits, dim=-1)
    if sampling:
        scaled = logits / torch.clamp(temps, min=1e-4)[:, None]
        V = scaled.shape[-1]
        sorted_p = None
        if flags.top_k > 0:
            # Descending top-k values: the reference's sorted list with
            # the positions past k masked, without a vocab-wide sort.
            sorted_p = torch.topk(scaled, min(flags.top_k, V), dim=-1).values
            scaled = scaled.masked_fill(scaled < sorted_p[:, -1:], _NEG_INF)
        if flags.top_p:
            if sorted_p is None:
                sorted_p = torch.sort(scaled, dim=-1, descending=True).values
            cum = torch.cumsum(torch.softmax(sorted_p, dim=-1), dim=-1)
            # The predicate must hold somewhere: an f32 cumsum can top
            # out just below a top_p near 1, and a first-True search over
            # all-False would collapse the row to greedy.
            cum[:, -1] = 2.0
            cut_idx = torch.argmax(
                (cum >= topps[:, None]).to(torch.int8), dim=-1, keepdim=True
            )
            cutoff = sorted_p.gather(1, cut_idx)
            scaled = scaled.masked_fill(
                (topps < 1.0)[:, None] & (scaled < cutoff), _NEG_INF
            )
        noise = gumbel_noise(base_seed, seeds, counters, V)
        sampled = torch.argmax(scaled + noise, dim=-1)
        chosen = torch.where(greedy, chosen, sampled)
    logp_all = torch.log_softmax(logits, dim=-1)
    logp = logp_all.gather(1, chosen[:, None])[:, 0]
    if flags.top_logprobs:
        top_l, top_i = torch.topk(logp_all, flags.top_logprobs, dim=-1)
        return chosen, logp, top_i, top_l
    return chosen, logp, None, None


@dataclass
class SlotPlanes:
    """Per-slot device state: the token entering the next decode step,
    the slot's sample counter, and the sampling contract of the request it
    holds ([n_slots] each), the generated-token counts ([n_slots, vocab]
    int32 with penalties, else [n_slots, 1]) and the sparse logit bias
    ([n_slots, LOGIT_BIAS_K], ids padded with -1)."""

    tokens: torch.Tensor  # int64
    nsteps: torch.Tensor  # int64
    seeds: torch.Tensor  # int64
    temps: torch.Tensor  # f32
    greedy: torch.Tensor  # bool
    active: torch.Tensor  # bool
    topps: torch.Tensor  # f32
    fpen: torch.Tensor  # f32
    ppen: torch.Tensor  # f32
    pcounts: torch.Tensor  # int32
    bidx: torch.Tensor  # int64
    bval: torch.Tensor  # f32

    @classmethod
    def create(
        cls,
        n_slots: int,
        device: torch.device,
        vocab_size: int = 1,
        flags: SamplerFlags = SamplerFlags(),
    ) -> "SlotPlanes":
        def z(dtype: torch.dtype, *shape: int) -> torch.Tensor:
            return torch.zeros((n_slots, *shape), dtype=dtype, device=device)

        return cls(
            tokens=z(torch.long), nsteps=z(torch.long), seeds=z(torch.long),
            temps=torch.ones((n_slots,), device=device),
            greedy=torch.ones((n_slots,), dtype=torch.bool, device=device),
            active=z(torch.bool),
            topps=torch.ones((n_slots,), device=device),
            fpen=z(torch.float32), ppen=z(torch.float32),
            pcounts=z(torch.int32, vocab_size if flags.penalties else 1),
            bidx=torch.full((n_slots, LOGIT_BIAS_K), -1, dtype=torch.long,
                            device=device),
            bval=z(torch.float32, LOGIT_BIAS_K),
        )


def prefill_chunk_step(
    params: dict,
    cache: KVCache | PagedKVCache,
    cfg: TransformerConfig,
    rope: Rope,
    planes: SlotPlanes,
    flags: SamplerFlags,
    tokens: torch.Tensor,
    slots: torch.Tensor,
    starts: torch.Tensor,
    lens: torch.Tensor,
    finalize: torch.Tensor,
    row_valid: torch.Tensor,
    temps: torch.Tensor,
    greedy: torch.Tensor,
    topps: torch.Tensor,
    base_seed: int,
    *,
    sampling: bool,
    use_bias: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """One [P, c] chunk: write K/V and attend; on rows whose prompt
    finishes (``finalize`` and ``row_valid``) sample the first token with
    counter 0 (logit bias and filters apply; penalties do not: no token
    was generated yet) and merge it into the slot planes on the device,
    set the slot's cache length and its counter to 1, and (penalties)
    reset the slot's counts to the first token. Padding rows duplicate
    row 0 (identical writes; ``row_valid`` keeps them out of the merge).
    Returns the rows' (first token, logprob, top ids, top logprobs)."""
    logits = prefill_chunk(
        params, tokens, cache, slots, starts, lens, cfg, rope=rope
    )
    sl = slots.long()
    first, first_lp, top_i, top_l = sample(
        logits, planes.seeds[sl], torch.zeros_like(sl), temps, greedy, topps,
        base_seed, flags, sampling=sampling,
        bias=(planes.bidx[sl], planes.bval[sl]) if use_bias else None,
    )
    S = planes.tokens.shape[0]
    match = (
        (torch.arange(S, device=sl.device)[:, None] == sl[None, :])
        & finalize[None, :] & row_valid[None, :]
    )  # [S, P]
    has = match.any(dim=1)
    idx = match.to(torch.int32).argmax(dim=1)
    planes.tokens.copy_(torch.where(has, first[idx], planes.tokens))
    cache.lengths.copy_(
        torch.where(has, (starts + lens)[idx], cache.lengths)
    )
    planes.nsteps.copy_(torch.where(has, 1, planes.nsteps))
    if flags.penalties:
        planes.pcounts.masked_fill_(has[:, None], 0)
        planes.pcounts.scatter_add_(
            1, planes.tokens[:, None], has.to(torch.int32)[:, None]
        )
    return first, first_lp, top_i, top_l


def decode_window(
    params: dict,
    cache: KVCache | PagedKVCache,
    cfg: TransformerConfig,
    rope: Rope,
    planes: SlotPlanes,
    flags: SamplerFlags,
    k: int,
    base_seed: int,
    *,
    sampling: bool,
    use_bias: bool = False,
) -> torch.Tensor:
    """Run k decode steps over every slot on the device and return the
    [2 + 2T, k, S] f32 block the host fetches once per window: row 0 the
    token each step produced (exact in f32 below 2**24), row 1 its
    logprob, rows 2 .. 2+T the top-logprob ids and 2+T .. 2+2T their
    logprobs (T = ``flags.top_logprobs``). Active slots advance their
    counter once per step and, with penalties, count the token they
    produced."""
    S = planes.tokens.shape[0]
    T = flags.top_logprobs
    emitted = torch.empty((2 + 2 * T, k, S), dtype=torch.float32,
                          device=planes.tokens.device)
    step_inc = planes.active.to(torch.long)
    count_inc = planes.active.to(torch.int32)[:, None]
    bias = (planes.bidx, planes.bval) if use_bias else None
    pen = (planes.pcounts, planes.fpen, planes.ppen) if flags.penalties else None
    for step in range(k):
        logits = decode_step(
            params, planes.tokens, cache, planes.active, cfg, rope=rope
        )
        nxt, nlp, top_i, top_l = sample(
            logits, planes.seeds, planes.nsteps, planes.temps, planes.greedy,
            planes.topps, base_seed, flags, sampling=sampling, bias=bias,
            pen=pen,
        )
        planes.nsteps += step_inc
        planes.tokens.copy_(nxt)
        if flags.penalties:
            planes.pcounts.scatter_add_(1, nxt[:, None], count_inc)
        emitted[0, step] = nxt.float()
        emitted[1, step] = nlp
        if top_i is not None:
            emitted[2: 2 + T, step] = top_i.T.float()
            emitted[2 + T:, step] = top_l.T
    return emitted


def prefill_multi_chunk(
    params: dict,
    cache: KVCache | PagedKVCache,
    cfg: TransformerConfig,
    rope: Rope,
    tokens3: torch.Tensor,
    slots: torch.Tensor,
    starts0: torch.Tensor,
) -> None:
    """``d`` full, non-finalizing [P, c] chunks in one host call
    (``tokens3`` [d, P, c]; chunk i of row r starts at ``starts0[r] + i *
    c``), the port of the reference's ``prefill_multi_chunk``: the chunks
    are enqueued back to back with no fetch between them. No sampling and
    no length update: both belong to the finalize chunk, which always goes
    through ``prefill_chunk_step``. Padding rows duplicate row 0."""
    d, P, c = tokens3.shape
    lens = torch.full((P,), c, dtype=torch.int32, device=tokens3.device)
    for i in range(d):
        prefill_chunk(params, tokens3[i], cache, slots, starts0 + i * c, lens, cfg,
                      rope=rope)


@dataclass
class MegaState:
    """The device state of a mega window, in fixed buffers that a captured
    graph binds: the [2 + 2T, m·k, S] block (``decode_window``'s rows,
    window w at columns w·k .. w·k + k), the windows run, each slot's
    tokens still to cover (``remaining``, set by the host before each
    dispatch), whether an EOS retires the slot (``eos_stop``) and the
    loop's condition ``go`` (int32: what the WHILE node reads)."""

    emitted: torch.Tensor  # f32
    w: torch.Tensor  # [] int64
    remaining: torch.Tensor  # [S] int64
    eos_stop: torch.Tensor  # [S] bool
    go: torch.Tensor  # [] int32

    @classmethod
    def create(cls, n_slots: int, k: int, m: int, top_logprobs: int,
               device: torch.device) -> "MegaState":
        return cls(
            emitted=torch.zeros((2 + 2 * top_logprobs, m * k, n_slots), device=device),
            w=torch.zeros((), dtype=torch.long, device=device),
            remaining=torch.zeros((n_slots,), dtype=torch.long, device=device),
            eos_stop=torch.zeros((n_slots,), dtype=torch.bool, device=device),
            go=torch.zeros((), dtype=torch.int32, device=device),
        )


def mega_begin(state: MegaState) -> None:
    """Before the first window: no window run, a zero block, and the
    reference's condition ``(w < m) & any(remaining > 0)`` at w = 0."""
    state.w.zero_()
    state.emitted.zero_()
    state.go.copy_((state.remaining > 0).any())


def mega_step(
    params: dict,
    cache: KVCache | PagedKVCache,
    cfg: TransformerConfig,
    rope: Rope,
    planes: SlotPlanes,
    flags: SamplerFlags,
    k: int,
    m: int,
    base_seed: int,
    eos_id: int,
    state: MegaState,
    *,
    sampling: bool,
    use_bias: bool = False,
) -> None:
    """One window of the mega loop, all on the device (the body of the
    reference's ``win_body``): a k-step ``decode_window``, its block
    stored at columns w·k .., each slot's ``remaining`` less k (0 once the
    window produced EOS where ``eos_stop`` holds), w + 1, and the next
    condition."""
    e = decode_window(params, cache, cfg, rope, planes, flags, k, base_seed,
                      sampling=sampling, use_bias=use_bias)
    cols = state.w * k + torch.arange(k, device=e.device)
    state.emitted.index_copy_(1, cols, e)
    hit = (e[0] == eos_id).any(dim=0) & state.eos_stop
    state.remaining.copy_(torch.where(hit, 0, (state.remaining - k).clamp(min=0)))
    state.w += 1
    state.go.copy_((state.w < m) & (state.remaining > 0).any())


def mega_window(
    params: dict,
    cache: KVCache | PagedKVCache,
    cfg: TransformerConfig,
    rope: Rope,
    planes: SlotPlanes,
    flags: SamplerFlags,
    k: int,
    m: int,
    base_seed: int,
    eos_id: int,
    state: MegaState,
    *,
    sampling: bool,
    use_bias: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Up to ``m`` k-step windows in one call, with the reference's exit:
    windows run while ``(w < m) & any(remaining > 0)``. Returns the
    state's block and windows run; columns past ``w·k`` are zeros the host
    must not read. Slots whose budget ran out while others continue keep
    computing junk in their own rows of the cache (writes past ``max_len``
    park), which the host drops after retirement. This is the plain
    version: the condition is read on the host once a window (on the card
    the engine runs ``DecodeGraphs.mega``, the same steps under a WHILE
    node)."""
    mega_begin(state)
    while bool(state.go):
        mega_step(params, cache, cfg, rope, planes, flags, k, m, base_seed, eos_id,
                  state, sampling=sampling, use_bias=use_bias)
    return state.emitted, state.w


# The static variants of the decode programs: the reference's
# static_argnames (sampling, use_bias) for the engine's k and flags.
VARIANTS = tuple((s, b) for s in (False, True) for b in (False, True))


class Captured:
    """One CUDA graph capture of ``fn`` on ``pool``, on the calling
    thread (``capture_error_mode="thread_local"``: the App's other threads
    may keep using the card). ``fn`` runs once eagerly on a side stream
    first (kernels' one-time set-up, cuBLAS handles, the decode kernel's
    cluster-size query). ``out`` is what the capture returned (static:
    every replay rewrites it), ``launches`` the kernel launches one replay
    runs, by kernel name. With ``keep_graph`` the graph is kept
    uninstantiated for ``raw()``, to be built into another graph."""

    def __init__(self, fn: Callable[[], object], pool: object, *,
                 keep_graph: bool = False) -> None:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        self.graph = torch.cuda.CUDAGraph(keep_graph=keep_graph)
        t0 = time.perf_counter()
        with _count.recording() as record, torch.cuda.graph(
            self.graph, pool=pool, capture_error_mode="thread_local"
        ):
            self.out = fn()
        self.capture_s = time.perf_counter() - t0
        self.record = record
        self.launches = record_counts(record)

    def replay(self) -> object:
        self.graph.replay()
        _count.replayed(self.record)
        return self.out

    def raw(self) -> int:
        return self.graph.raw_cuda_graph()


class DecodeGraphs:
    """The engine's decode programs as CUDA graphs, captured once per
    static variant on the engine's own planes, cache and weights, in one
    graph memory pool per engine, and replayed on the current stream.
    Give one of the two programs: an engine with mega windows dispatches
    only mega windows, one without only k-step windows.

    With ``window_fn``, ``window(sampling, use_bias)`` replays the k-step
    ``decode_window`` and returns its static block. With ``mega_fns``
    (``mega_begin``, ``mega_step`` and the state's ``go``),
    ``mega(sampling, use_bias)`` launches the mega window: a graph whose
    WHILE node runs the captured ``mega_step`` while the device's ``go``
    says so (``ops/cuda/graph_while.py``); the caller reads ``state.w``
    and counts the returned launch record once per window run.

    Capture runs every variant once eagerly and so advances every active
    slot: build this only while no slot is active (inactive slots park
    their writes and add 0 to their counters)."""

    def __init__(self, window_fn: Optional[Callable[[bool, bool], torch.Tensor]] = None,
                 mega_fns: Optional[tuple] = None) -> None:
        if (window_fn is None) == (mega_fns is None):
            raise ValueError("DecodeGraphs captures either window_fn or mega_fns")
        self.pool = torch.cuda.graph_pool_handle()
        self.windows: dict = {}
        self.megas: dict = {}
        if window_fn is not None:
            self.windows = {
                v: Captured(lambda v=v: window_fn(*v), self.pool) for v in VARIANTS
            }
        else:
            from gofr_tpu_torch.ops.cuda.graph_while import WhileGraph

            begin_fn, step_fn, go = mega_fns
            self.prologue = Captured(begin_fn, self.pool, keep_graph=True)
            for v in VARIANTS:
                begin_fn()  # the warm-up window starts at w = 0
                body = Captured(lambda v=v: step_fn(*v), self.pool, keep_graph=True)
                self.megas[v] = (WhileGraph(self.prologue.raw(), body.raw(), go), body)
        self.capture_s = {f"window {v}": c.capture_s for v, c in self.windows.items()}
        self.capture_s.update({f"mega {v}": b.capture_s for v, (_, b) in self.megas.items()})

    def window(self, sampling: bool, use_bias: bool) -> torch.Tensor:
        return self.windows[(sampling, use_bias)].replay()

    def mega(self, sampling: bool, use_bias: bool):
        """Launch the mega window; returns the body's launch record (count
        it with ``ops.cuda.replayed(record, windows_run)``)."""
        graph, body = self.megas[(sampling, use_bias)]
        graph.launch()
        return body.record
