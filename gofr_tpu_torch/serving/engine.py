"""The continuous-batching serving engine of the port — the counterpart of
``gofr_tpu/serving/engine.py`` ``InferenceEngine`` with the scheduling of
``serving/scheduler.py`` on this slice's configuration.

A scheduler thread owns the device. Each pass reaps cancelled and
expired requests, admits queued requests into free cache slots, runs one
fixed-shape [prefill_batch, prefill_chunk] chunk step for the slots
mid-prefill (a long prompt takes several passes, so it never stalls
decode; with ``prefill_depth`` > 1, rows with at least two full chunks
left take up to that many in one dispatch; while under a quarter of the
slots decode, it keeps prefilling), then dispatches one k-step decode
window over all slots (``mega_windows`` > 1: up to that many windows in
one dispatch, with the reference's device-side exit) and processes the
oldest window once ``pipeline_depth`` windows are in flight: windows are
pipelined, window n+D dispatched before window n is fetched, and each
window's processing uses the slot snapshot of its dispatch. A prompt's
first token, sampled on the device with its last chunk, is emitted when
its copy to the host lands. A request retires on EOS, on a stop
sequence, on its token budget or at the context limit, and its slot is
reused.

With ``spec_tokens`` = G > 0 (``TPU_SPEC_TOKENS``) each window is a
speculative one, the reference's exact verify: every step drafts G tokens
by n-gram lookup in the slot's token history and verifies them through
the plain decode step, one candidate position at a time, so a step emits
1 to G+1 tokens and the streams are the spec-off streams. ``auto`` turns
it on only where the reference does (``resolve_spec_tokens``: a TPU
backend), so on ``cuda`` it stays off unless asked for.

On the card the decode programs run as CUDA graphs captured per static
variant when the scheduler starts (``programs.DecodeGraphs``), host
arrays go up through pinned staging buffers without a wait, and each
window's block comes down into pinned memory behind an event: the only
host wait of a steady-state window is that event.

Served: bf16 (or f32) weights, or int8/int4 weights (``quant``,
``TPU_QUANT``: ``ops/quant.py``, made quantized a layer at a time, or
quantized by ``apply_quantization``), random from ``seed`` or loaded from
``TPU_CHECKPOINT`` (an HF safetensors directory through
``serving/hf_loader.py``, else a ``serving/checkpoint.py`` file); dense
and MoE decoders; the slot cache or the paged block pool
(``kv_block``, ``kv_pool_blocks``), bf16 or int8 K/V (``kv_quant``),
tp=1; the reference's sampler (temperature, engine-wide ``top_k``,
per-request ``top_p``, frequency/presence penalties, ``logit_bias``,
``top_logprobs``, stop sequences) behind the same engine flags; and the
request lifecycle (deadlines, cancel tokens, tenants and SLO classes,
the submit-time sheds, the class-priority admission queue). Any option
outside it raises ``NotImplementedError``; none is ignored.

With a pool, admission allocates each request's prompt blocks (plus one
token) from a host-side ``BlockAllocator`` and a host mirror of the block
table, uploaded to the device when it changed; before each decode window
every live slot's allocation is grown to cover the window; retirement
and reaping return the blocks. A request the whole pool cannot hold fails
at admission, one that waits on a dry pool stays at the head of the
queue, and one whose pool runs dry mid-generation fails, as in the
reference.

The prefix cache, as the reference's. With ``auto_prefix`` (a pool only)
a retiring request's full prompt blocks go into a radix index
(``serving/radix_cache.py``) instead of back to the free list, and
admission aliases the longest cached prefix into the new slot's table:
the prefill starts at the hit, no byte moves. When the hit covers the
whole prompt the boundary block is copied on write (``paged_copy_block``)
because the last chunk rewrites its last position. Cached blocks nobody
references are evicted, LRU, when the free list runs dry, over
``prefix_cache_blocks``, or below ``prefix_evict_watermark`` free blocks.
With ``prefix_slots`` (the slot cache only) ``register_prefix`` prefills a
prefix once into a pool (``serving/prefix_cache.py``) whose rows admission
copies into a matching request's slot. Every cache write, the copies
included, goes on the engine's one stream in issue order, so a copy or a
reused block lands after the windows in flight that still write the
slots' earlier occupants.

An encoder, vision or seq2seq model (``ModelSpec.family``) takes the
reference's other engine shape: no scheduler, cache or graphs, its
requests coalesced by the dynamic batcher into one eager batch forward
(T5: one batched greedy generate; ``serving/modalities.py``).

The engine is also the App's container member: ``from_config`` builds it
from the ``TPU_*`` keys (the reference's names and defaults; a key of an
unported feature set to anything but its default raises), ``start`` /
``stop(drain_s)`` give the reference's drain semantics, ``health_check``
feeds ``/.well-known/health``, and with a ``metrics`` manager it records
the reference's ``app_tpu_*`` instruments once per prefill chunk or decode
window. The scheduler thread starts at construction (the reference's
starts in ``start``), so ``start_sync`` on a new engine is a no-op.
"""

from __future__ import annotations

import asyncio
import collections
import math
import os
import queue
import random
import threading
import time
import traceback
from concurrent.futures import Future, InvalidStateError
from concurrent.futures import TimeoutError as FutureTimeout
from dataclasses import dataclass
from typing import Any, AsyncIterator, Optional

import numpy as np
import torch

from gofr_tpu_torch import build_cache
from gofr_tpu_torch.analysis import lockcheck
from gofr_tpu_torch.device import resolve_device
from gofr_tpu_torch.errors import (
    ErrorDeadlineExceeded,
    ErrorInvalidParam,
    ErrorPromptTooLong,
    ErrorRequestCancelled,
    ErrorServiceUnavailable,
    ErrorTooManyRequests,
)
from gofr_tpu_torch.models.registry import get_model
from gofr_tpu_torch.models.transformer import (
    check_supported,
    init_lora,
    init_params,
    rope_tables,
)
from gofr_tpu_torch.ops.cuda import _build, replayed
from gofr_tpu_torch.ops.kv_cache import (
    BlockAllocator,
    KVCache,
    PagedKVCache,
    paged_copy_block,
)
from gofr_tpu_torch.ops.quant import (
    params_quant_mode,
    quant_fn,
    quantize_params,
    quantized_bytes,
)
from gofr_tpu_torch.serving.checkpoint import maybe_restore_params
from gofr_tpu_torch.serving.device_telemetry import (
    CompileTracker,
    CountingCall,
    HBMLedger,
    tree_device_bytes,
)
from gofr_tpu_torch.serving.hf_loader import is_hf_checkpoint, load_hf_llama, load_hf_t5
from gofr_tpu_torch.serving.lora_runtime import LoRARuntimeMixin
from gofr_tpu_torch.serving.modalities import ModalityMixin
from gofr_tpu_torch.serving.lifecycle import (
    AggregateThroughput,
    CancelToken,
    ClassPriorityQueue,
    Deadline,
    coalesce_deadline,
    normalize_slo_class,
    parse_tenant_class_map,
)
from gofr_tpu_torch.serving.programs import (
    Captured,
    DecodeGraphs,
    MegaState,
    SamplerFlags,
    SlotPlanes,
    decode_window,
    mega_begin,
    mega_step,
    mega_window,
    prefill_chunk_step,
    prefill_multi_chunk,
    spec_window,
)
from gofr_tpu_torch.serving import profiler_capture
from gofr_tpu_torch.serving.prefix_cache import PrefixPool
from gofr_tpu_torch.serving.radix_cache import RadixPrefixIndex
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer, tokenizer_from_config
from gofr_tpu_torch.serving.types import LOGIT_BIAS_K, GenerationResult, GenRequest

# Reference options this slice accepts only at their neutral value, each
# with the ROADMAP item that ports it.
_OPS_PLANE = "ROADMAP Queue 1 item 7: the operations plane"
_NEUTRAL_SUBMIT_OPTIONS = {
    "pin_replica": (False, _OPS_PLANE + " (the replica pool)"),
}

# TPU_* keys the reference's from_config and backend read and the port
# does not serve yet: (key, the reference's default, ROADMAP item). Set to
# anything else, each raises NotImplementedError naming its item.
_MULTI = "ROADMAP Queue 1 item 8: multi-device"
_UNPORTED_KEYS = (
    ("TPU_TP", "1", _MULTI), ("TPU_MESH_TP", "1", _MULTI),
    ("TPU_MESH_CP", "1", _MULTI),
    ("TPU_WATCHDOG_S", "0", _OPS_PLANE), ("TPU_RESTART_MAX", "0", _OPS_PLANE),
    ("TPU_RESTART_BACKOFF_S", "0.5", _OPS_PLANE),
    ("TPU_REPLAY_EXACT", "true", _OPS_PLANE),
    ("TPU_TENANT_LEDGER", "1", _OPS_PLANE),
    ("TPU_TENANT_LABEL_MAX", "8", _OPS_PLANE),
    ("TPU_TENANT_TABLE_MAX", "256", _OPS_PLANE),
    ("TPU_TENANT_FAIR_SHARE", "0", _OPS_PLANE),
    ("TPU_SLO_TTFT_MS", "0", _OPS_PLANE), ("TPU_SLO_E2E_MS", "0", _OPS_PLANE),
    ("TPU_SLO_AVAILABILITY", "0", _OPS_PLANE),
    ("TPU_BROWNOUT", "1", _OPS_PLANE), ("TPU_BROWNOUT_ENTER", "2", _OPS_PLANE),
    ("TPU_BROWNOUT_EXIT", "1", _OPS_PLANE),
    ("TPU_BROWNOUT_SUSTAIN_S", "10", _OPS_PLANE),
    ("TPU_BROWNOUT_EXIT_SUSTAIN_S", "30", _OPS_PLANE),
    ("TPU_BROWNOUT_MAX_NEW", "256", _OPS_PLANE),
    ("TPU_BROWNOUT_AIMD_CUT", "0.5", _OPS_PLANE),
    ("TPU_BROWNOUT_RECOVER_PER_S", "0.02", _OPS_PLANE),
    ("TPU_BROWNOUT_MIN_HEADROOM", "0", _OPS_PLANE),
    ("TPU_CONTROL_PLANE", "1", _OPS_PLANE), ("TPU_CONTROL_STALE_S", "10", _OPS_PLANE),
    ("TPU_CONTROL_TENANT_ENTER", "2", _OPS_PLANE),
    ("TPU_CONTROL_TENANT_EXIT", "1", _OPS_PLANE),
    ("TPU_CONTROL_TENANT_SUSTAIN_S", "10", _OPS_PLANE),
    ("TPU_CONTROL_TENANT_EXIT_SUSTAIN_S", "30", _OPS_PLANE),
    ("TPU_CONTROL_TENANT_MAX_NEW", "256", _OPS_PLANE),
    ("TPU_CONTROL_TENANT_AIMD_CUT", "0.5", _OPS_PLANE),
    ("TPU_CONTROL_TENANT_RECOVER_PER_S", "0.02", _OPS_PLANE),
    ("TPU_CONTROL_TENANT_TABLE", "64", _OPS_PLANE),
    ("TPU_CONTROL_HOST_RATIO", "0.85", _OPS_PLANE),
    ("TPU_CONTROL_HOST_UTIL", "0.75", _OPS_PLANE),
    ("TPU_CONTROL_HOST_SUSTAIN_S", "30", _OPS_PLANE),
    ("TPU_CONTROL_PREDICT_WINDOW_S", "60", _OPS_PLANE),
    ("TPU_CONTROL_PREDICT_HORIZON_S", "30", _OPS_PLANE),
    ("TPU_CONTROL_PREDICT_DEPTH", "0", _OPS_PLANE),
    ("TPU_CONTROL_PREDICT_HOLD_S", "30", _OPS_PLANE),
    ("TPU_FLIGHT_RECORDER", "1", _OPS_PLANE), ("TPU_FLIGHT_RECORDS", "256", _OPS_PLANE),
    ("TPU_FLIGHT_SLOW_S", "5", _OPS_PLANE),
    ("TPU_LOOP_PROFILE", "1", _OPS_PLANE), ("TPU_LOOP_STALL_S", "1.0", _OPS_PLANE),
    ("TPU_LOOP_STALL_FACTOR", "10", _OPS_PLANE),
    ("TPU_LOOP_ANOMALIES", "64", _OPS_PLANE), ("TPU_LOOP_TRACE_MS", "0", _OPS_PLANE),
    ("TPU_LOOP_TRACE_COOLDOWN_S", "60", _OPS_PLANE),
    # The replica pool's keys (gofr_tpu/serving/backend.py).
    ("TPU_REPLICA_OPS_ADDRS", "", _OPS_PLANE), ("TPU_REPLICA_ROLES", "", _OPS_PLANE),
    ("TPU_ROUTE_WEIGHTED", "true", _OPS_PLANE),
    ("TPU_PROBE_INTERVAL_S", "30", _OPS_PLANE),
    ("TPU_PROBE_TIMEOUT_S", "30", _OPS_PLANE),
    ("TPU_HEDGE_DELAY_S", "2.0", _OPS_PLANE), ("TPU_HEDGE_BUDGET", "8", _OPS_PLANE),
    ("TPU_HEDGE_RATE_PER_S", "2", _OPS_PLANE),
    ("TPU_POOL_MIN_REPLICAS", "", _OPS_PLANE),
    ("TPU_POOL_MAX_REPLICAS", "0", _OPS_PLANE),
    ("TPU_SCALE_UP_LOAD", "4", _OPS_PLANE), ("TPU_SCALE_DOWN_LOAD", "0.5", _OPS_PLANE),
    ("TPU_SCALE_UP_HEADROOM", "0", _OPS_PLANE),
    ("TPU_SCALE_UP_BROWNOUT", "1", _OPS_PLANE),
    ("TPU_SCALE_UP_CONTROL", "1", _OPS_PLANE),
    ("TPU_SCALE_UP_WAIT_S", "10", _OPS_PLANE),
    ("TPU_SCALE_DOWN_WAIT_S", "60", _OPS_PLANE),
    ("TPU_SCALE_INTERVAL_S", "5", _OPS_PLANE),
    ("TPU_TRANSFER_RETRIES", "2", _OPS_PLANE),
    ("TPU_TRANSFER_TIMEOUT_S", "10", _OPS_PLANE),
    ("TPU_TRANSFER_LEG", "", _OPS_PLANE), ("TPU_SOURCE_TIMEOUT_S", "2.0", _OPS_PLANE),
    ("TPU_REMOTE_STREAM", "true", _OPS_PLANE),
    ("TPU_REMOTE_STREAM_IDLE_S", "30", _OPS_PLANE),
)
# Per-tenant SLO overrides (TPU_SLO_TENANT_<NAME>_TTFT_MS and kin) are
# read by prefix, from the process environment and a MockConfig's map.
_SLO_TENANT_PREFIX = "TPU_SLO_TENANT_"
_TRUTHY = ("1", "true", "yes")
_FALSY = ("", "0", "false", "no")
# The engine state gauge's encoding (app_tpu_engine_state).
_STATE_CODES = {"SERVING": 0, "DEGRADED": 1, "RESTARTING": 2, "DOWN": 3}


def _is_default(raw: str, default: str) -> bool:
    """``raw`` says the same as ``default``: equal text, equal numbers, or
    the same truth value in the reference's spellings."""
    a, b = raw.strip().lower(), default.lower()
    if a == b:
        return True
    if (a in _TRUTHY and b in _TRUTHY) or (a in _FALSY and b in _FALSY):
        return True
    try:
        return float(a) == float(b)
    except ValueError:
        return False


def _truthy(config: Any, key: str, default: str) -> bool:
    return config.get_or_default(key, default).strip().lower() in _TRUTHY


def check_unported_keys(config: Any) -> None:
    """Raise ``NotImplementedError`` naming its ROADMAP item for the first
    ``TPU_*`` key of an unported feature that is set to something other
    than the reference's default."""
    for key, default, item in _UNPORTED_KEYS:
        raw = config.get(key)
        if raw is not None and raw != "" and not _is_default(raw, default):
            raise NotImplementedError(
                f"{key}={raw!r} is not ported yet ({item}); the port serves "
                f"it only at the reference's default {default!r}"
            )
    keys = set(os.environ)
    keys.update(getattr(config, "_values", None) or ())
    tenant_slo = sorted(k for k in keys if k.startswith(_SLO_TENANT_PREFIX))
    if tenant_slo:
        raise NotImplementedError(
            f"{tenant_slo[0]} is set; per-tenant SLOs are not ported yet "
            f"({_OPS_PLANE})"
        )


# Draft length the TPU_SPEC_TOKENS=auto default resolves to where the
# bench gate holds (BENCH_SPEC_WORKLOAD: G=2 is the measured knee —
# longer drafts inflate the per-step decode-forward count faster than
# n-gram acceptance grows).
SPEC_AUTO_TOKENS = 2


def resolve_spec_tokens(
    raw: str,
    backend: str,
    enable_penalties: bool,
    top_logprobs: int,
) -> "tuple[int, Optional[str]]":
    """Resolve ``TPU_SPEC_TOKENS`` (``auto``/int) to a draft count.

    ``auto`` — the default — flips speculation ON exactly where the
    two-metric bench gate holds, and OFF where it measurably does not:

    * The numerics-exact spec window runs the decode-step program once
      per candidate position, so device compute per emitted token is
      never below the plain decode window's; speculation's entire win
      is per-dispatch amortization (an accepted draft means fewer
      windows — fewer host↔device round trips and scheduler passes —
      per token). On dispatch/host-overhead-bound TPU serving (the
      regime ``app_tpu_loop_host_overhead_ratio`` measures) the
      BENCH_SPEC_WORKLOAD A/B holds: tok/s up, host overhead flat. On
      compute-bound backends (CPU) the same A/B measures tok/s DOWN —
      the extra forwards dominate — so ``auto`` resolves to 0 there
      rather than shipping the gate's own counterexample.
    * Compile features the spec window's emission block excludes
      (penalties' evolving count plane, the top_logprobs alternatives
      plane) win over an *implicit* default: ``auto`` resolves to 0
      with a boot note instead of refusing to boot. An EXPLICIT
      ``TPU_SPEC_TOKENS>0`` alongside them still raises in the
      constructor — that combination is a contradiction the user
      typed, not one a default created.

    Returns ``(spec_tokens, note)``; ``note`` explains any auto
    resolution so boots are attributable in logs. The port's engine
    passes its device type (``"cuda"`` or ``"cpu"``) as ``backend``.
    """
    val = (raw or "auto").strip().lower()
    if val == "auto":
        conflicts = [
            name
            for name, on in (
                ("TPU_PENALTIES", enable_penalties),
                ("TPU_TOP_LOGPROBS", top_logprobs > 0),
            )
            if on
        ]
        if conflicts:
            return 0, (
                "speculative decoding default-on skipped: "
                + "/".join(conflicts)
                + " needs per-step planes the spec window's emission "
                "block excludes (set TPU_SPEC_TOKENS explicitly to "
                "choose the other way)"
            )
        if backend != "tpu":
            return 0, (
                f"speculative decoding stays off on backend={backend!r}: "
                "the exact verify pays one decode forward per emitted "
                "token, and the BENCH_SPEC_WORKLOAD gate (tok/s up AND "
                "host_overhead_ratio flat) only holds on dispatch-bound "
                "TPU serving (set TPU_SPEC_TOKENS>0 to force)"
            )
        return SPEC_AUTO_TOKENS, (
            f"speculative decoding ON by default (G={SPEC_AUTO_TOKENS}, "
            "numerics-exact verify; TPU_SPEC_TOKENS=0 disables)"
        )
    try:
        n = int(val)
    except ValueError:
        raise ValueError(
            f"TPU_SPEC_TOKENS={raw!r}: expected an integer or 'auto'"
        ) from None
    return max(0, n), None


@dataclass
class _Window:
    """A dispatched decode window, until it is processed: its block on
    the host (pinned memory the device fills; the array itself on the
    CPU), the event after that copy (None on the CPU), the slots'
    requests at dispatch, the dispatch time, and for a mega window the
    windows run (on the host once the event passed) and the captured
    body's launch record (None when it ran eagerly)."""

    host: np.ndarray
    event: Any
    snapshot: list
    t0: float
    wrun: Any = None
    record: Any = None


@dataclass
class _Prefill:
    """A slot mid-chunked-prefill."""

    request: GenRequest
    done: int = 0  # prompt tokens already written to the cache


class InferenceEngine(LoRARuntimeMixin, ModalityMixin):
    """One loaded model and its serving loop.

    ``device`` defaults to CUDA (raises without it); pass ``"cpu"`` to run
    the plain versions of the kernels on the host. ``params`` is a port
    parameter dict (``weights.params_from_jax`` / ``init_params``, plain or
    quantized, read by ``params_quant_mode``) on that device; without it
    weights are made from ``seed`` on the device. ``quant`` (``"int8"`` /
    ``"int4"``) makes them quantized a layer at a time, or quantizes the
    plain ``params`` given, before the scheduler starts (``self.quant``).

    The decode loop, as the reference's: ``pipeline_depth`` windows in
    flight (at least 1), ``mega_windows`` k-step windows a dispatch (0 or
    1 = one), ``prefill_depth`` full chunks a multi-chunk prefill dispatch
    (1 = off), ``spec_tokens`` drafts verified a step (0 = off; exclusive
    with penalties and ``top_logprobs``, as in the reference).

    Sampler flags, as the reference's: ``top_k`` (engine-wide, 0 = off),
    ``enable_top_p`` (per-request nucleus), ``enable_penalties`` (the
    per-slot generated-token count plane), ``top_logprobs`` (the most
    alternatives a request may ask for). Admission: ``queue_max``
    requests and ``queue_max_tokens`` (prompt + budget, 0 = unbounded) in
    the queue, ``tenant_queue_max`` queued requests per tenant (0 = off),
    ``class_promote_s`` (SLO-class priority dequeue with this starvation
    bound; 0 = FIFO), ``tenant_slo_class`` (``"acme=batch,..."``, each
    tenant's default class) and ``expected_tps`` (the throughput prior of
    projected-wait shedding; 0 = measured). ``truncate_prompts`` keeps the
    tail of an overlong prompt instead of raising ``ErrorPromptTooLong``.
    ``logger`` (a ``gofr_tpu_torch.logging.Logger``) gets the shed
    warnings and reap notes; ``metrics`` (a ``gofr_tpu_torch.metrics``
    manager with the container's instruments registered) gets the
    ``app_tpu_*`` recordings.

    The prefix cache, as the reference's: ``auto_prefix`` (needs
    ``kv_block``), ``prefix_cache_blocks`` (cap on cached blocks, 0 = the
    pool), ``prefix_evict_watermark`` (free blocks the loop keeps by
    evicting, 0 = off), ``queue_prefix_aware`` (a request with a hit pops
    first within its class); ``prefix_slots`` (rows of the explicit prefix
    pool, slot cache only; see ``register_prefix``).

    Multi-LoRA, as the reference's: ``lora_slots`` adapter slots (0 = no
    adapter leaves at all) of rank ``lora_rank`` over the comma-separated
    ``lora_targets``; ``load_lora`` / ``unload_lora``
    (``serving/lora_runtime.py``) fill and clear them while serving, and a
    request picks one by name (``adapter=``). Every slot's requests batch
    in the same windows, each row under its own adapter.

    Device services, as the reference's (``serving/device_telemetry.py``):
    an HBM ledger over the engine's device tensors (``hbm_ledger``,
    ``hbm_headroom_ratio``) against ``hbm_budget_bytes`` (0 = the card's
    own memory, or on the CPU the ledger's total); ``admit_min_headroom``
    sheds a submit with 429 ``hbm_headroom`` below that headroom (0 =
    off); ``prefix_evict_hbm_frac`` derives the radix eviction watermark
    from the ledger (an explicit ``prefix_evict_watermark`` wins). A
    compile tracker counts the CUDA graph captures and the kernel
    library's load (``compile_stats``, ``mark_steady_state``).
    ``compile_cache_dir`` points the native builds (the kernel library,
    the BPE core) at a directory a later process reuses; it takes effect
    only before the first build of the process (``build_cache``). It may
    also be the record ``build_cache.use_dir`` already returned for it.

    An encoder (``bert-*``), vision (``resnet-*``, ``vit-*``) or seq2seq
    (``flan-t5-small``, ``t5-tiny``) model serves behind the dynamic batcher
    instead (``serving/modalities.py``): ``max_batch`` requests a flush at
    most, ``max_wait_s`` after the oldest; ``embed`` / ``classify`` /
    ``seq2seq`` and ``infer`` by family. The LLM options do not apply to
    it; ``quant`` quantizes a seq2seq model and raises for the others, as
    in the reference.
    """

    family = "llm"

    def __init__(
        self,
        model_name: str,
        *,
        n_slots: int = 8,
        max_len: int = 1024,
        window_k: int = 8,
        pipeline_depth: int = 2,
        mega_windows: int = 0,
        prefill_depth: int = 1,
        spec_tokens: int = 0,
        prefill_chunk: int = 256,
        prefill_batch: int = 8,
        truncate_prompts: bool = False,
        top_k: int = 0,
        enable_top_p: bool = False,
        enable_penalties: bool = False,
        top_logprobs: int = 0,
        kv_block: int = 0,
        kv_pool_blocks: int = 0,
        kv_quant: str = "",
        auto_prefix: bool = False,
        prefix_cache_blocks: int = 0,
        prefix_evict_watermark: int = 0,
        prefix_slots: int = 0,
        queue_prefix_aware: bool = False,
        prefix_evict_hbm_frac: float = 0.0,
        admit_min_headroom: float = 0.0,
        hbm_budget_bytes: int = 0,
        compile_cache_dir: str | dict[str, Any] = "",
        lora_slots: int = 0,
        lora_rank: int = 16,
        lora_targets: str = "wq,wk,wv,wo",
        max_batch: int = 8,
        max_wait_s: float = 0.005,
        queue_max: int = 1024,
        queue_max_tokens: int = 0,
        class_promote_s: float = 5.0,
        tenant_queue_max: int = 0,
        tenant_slo_class: str = "",
        expected_tps: float = 0.0,
        tokenizer: Any = None,
        params: Optional[dict] = None,
        quant: str = "",
        seed: int = 0,
        device: Any = None,
        logger: Any = None,
        metrics: Any = None,
        **unsupported: Any,
    ) -> None:
        if unsupported:
            raise NotImplementedError(
                "engine options outside this slice of the torch port: "
                f"{sorted(unsupported)} (ROADMAP: the rest of the serving "
                "features)"
            )
        # The build directory (TPU_COMPILE_CACHE_DIR) first: it holds only
        # if no native build of this process read the default before.
        # from_config passes the record its own use_dir call returned.
        self._compile_cache_info: Optional[dict[str, Any]] = (
            compile_cache_dir if isinstance(compile_cache_dir, dict)
            else build_cache.use_dir(compile_cache_dir) if compile_cache_dir
            else None
        )
        spec = get_model(model_name)
        if spec.family != "llm":
            # The encoder and vision families serve behind the dynamic
            # batcher (serving/modalities.py); the LLM options are theirs
            # to ignore, as in the reference.
            self._init_batch_family(
                spec, max_len=max_len, max_batch=max_batch, max_wait_s=max_wait_s,
                tokenizer=tokenizer, params=params, quant=quant, seed=seed,
                device=device, hbm_budget_bytes=hbm_budget_bytes,
                logger=logger, metrics=metrics,
            )
            return
        for name, val in (("n_slots", n_slots), ("window_k", window_k),
                          ("prefill_chunk", prefill_chunk),
                          ("prefill_batch", prefill_batch)):
            if int(val) < 1:
                raise ValueError(f"{name} must be >= 1, got {val}")
        # The cache never outgrows the model's context (the reference's
        # clamp).
        max_len = min(int(max_len), get_model(model_name).config.max_len)
        if enable_penalties and spec_tokens > 0:
            raise ValueError(
                "TPU_PENALTIES and TPU_SPEC_TOKENS are mutually exclusive: "
                "penalties evolve within a step sequence, which breaks the "
                "parallel speculative verify"
            )
        if top_logprobs and spec_tokens > 0:
            raise ValueError(
                "TPU_TOP_LOGPROBS and TPU_SPEC_TOKENS are mutually "
                "exclusive (the verify step has no per-emission "
                "alternatives plane)"
            )
        # Each speculative step verifies spec_tokens drafts + 1, so a
        # window can write up to window_k * (spec_tokens+1) positions.
        self.spec_tokens = max(0, int(spec_tokens))
        step_tokens = int(window_k) * (self.spec_tokens + 1)
        reserve = 1 + (max(1, int(pipeline_depth)) + 1) * step_tokens
        if max_len <= reserve:
            raise ValueError(
                f"max_len={max_len} too small: need > {reserve} "
                f"(1 + (pipeline_depth+1)*window_k*(spec_tokens+1)) so "
                f"admission can reserve pipelined-window overshoot "
                f"room; lower window_k/pipeline_depth/spec_tokens or "
                f"raise max_len"
            )
        if kv_block < 0 or kv_pool_blocks < 0:
            raise ValueError("kv_block and kv_pool_blocks must be >= 0")
        if kv_block and max_len % kv_block:
            raise ValueError(
                f"max_len={max_len} must be a multiple of kv_block={kv_block}"
            )
        # The reference's prefix-cache validation, word for word.
        if auto_prefix and not kv_block:
            raise ValueError(
                "TPU_AUTO_PREFIX requires the paged KV cache "
                "(TPU_KV_BLOCK > 0): prefix hits alias pool blocks "
                "through the block table"
            )
        if kv_block and prefix_slots > 0:
            raise ValueError(
                "prefix-KV reuse and the paged cache are mutually "
                "exclusive (the pool copies slot rows; use "
                "TPU_AUTO_PREFIX for paged prefix sharing)"
            )
        self.device = resolve_device(device)
        if kv_block % 16 and self.device.type == "cuda":
            raise ValueError(
                f"the CUDA kernels take kv_block a multiple of 16, got {kv_block}"
            )
        self.model_name = model_name
        self.spec = get_model(model_name)
        self.cfg = self.spec.config
        check_supported(self.cfg, self.device)
        self._logger = logger
        self._metrics = metrics
        # The compile tracker: the CUDA graph captures (one program per
        # captured graph) and the kernel library's first load in the
        # process. It takes the trace ambient here, so a traced boot owns
        # its capture spans.
        self._compiles = CompileTracker(model_name, metrics=metrics, logger=logger)
        if self._compile_cache_info is not None:
            self._compiles.set_cache_info(self._compile_cache_info)
        self._capture_calls: dict[str, Any] = {}
        self._ledger: Optional[HBMLedger] = None
        self.prefix_evict_hbm_frac = max(0.0, float(prefix_evict_hbm_frac))
        self.admit_min_headroom = max(0.0, float(admit_min_headroom))
        self.hbm_budget_bytes = max(0, int(hbm_budget_bytes))
        self.n_slots = int(n_slots)
        self.max_len = int(max_len)
        self.window_k = int(window_k)
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.mega_windows = max(0, int(mega_windows))
        self.prefill_depth = max(1, int(prefill_depth))
        self.kv_block = int(kv_block)
        # The reference's clamps: a chunk of 16 to max_len tokens, no more
        # prefill rows than slots.
        self.prefill_chunk = max(16, min(int(prefill_chunk), self.max_len))
        self.prefill_batch = max(1, min(int(prefill_batch), self.n_slots))
        self.truncate_prompts = bool(truncate_prompts)
        # The sampler's features, each present only when enabled (the
        # reference's compile choices).
        self.enable_top_p = bool(enable_top_p)
        self.enable_penalties = bool(enable_penalties)
        self.top_logprobs = max(0, int(top_logprobs))
        self.sampler = SamplerFlags(
            top_k=max(0, int(top_k)), top_p=self.enable_top_p,
            penalties=self.enable_penalties, top_logprobs=self.top_logprobs,
        )
        self.tokenizer = tokenizer if tokenizer is not None else ByteTokenizer()
        self._seed = int(seed)
        self._base_seed = self._seed + 2
        self._seed_rng = random.Random(os.urandom(16))

        quant = (quant or "").lower()
        if quant:
            quant_fn(quant)  # the reference's ValueError, before any weight is made
        self.quant = ""
        if params is not None:
            self.quant = params_quant_mode(params)
        elif quant:
            # Made quantized a layer at a time: the bf16 tree of a large
            # model (Mixtral-8x7B's 93 GB) never exists.
            params = init_params(self.cfg, self._seed, self.device, quant=quant)
            self.quant = quant
        else:
            params = init_params(self.cfg, self._seed, self.device)
        for name, t in params.items():
            if t.device != self.device:
                raise ValueError(
                    f"param {name} is on {t.device}, engine device is "
                    f"{self.device}"
                )
        self.params = params
        if quant and not self.quant:
            self.apply_quantization(quant)
        # Multi-LoRA: zero stacked adapter leaves merged in after the
        # quantization (they stay cfg.dtype on an int8/int4 base); slot 0
        # is the base, load_lora fills 1..lora_slots in place. An engine
        # without slots has no adapter leaf and computes no delta.
        self.lora_slots = max(0, int(lora_slots))
        self.lora_rank = max(1, int(lora_rank))
        self._lora_targets = tuple(
            t.strip() for t in lora_targets.split(",") if t.strip()
        )
        self._lora_names: dict[str, int] = {}
        # Per adapter slot, its load generation: bumped by every load and
        # unload, so a request or prefix stamped under older weights is
        # caught.
        self._lora_gen = [0] * (self.lora_slots + 1)
        if self.lora_slots:
            self.params = {**self.params, **init_lora(
                self.cfg, 1 + self.lora_slots, self.lora_rank, self._lora_targets,
                self.device,
            )}
        cfg = self.cfg
        if self.kv_block:
            self.cache = PagedKVCache.create(
                cfg.n_layers, self.n_slots, self.max_len, cfg.n_kv_heads,
                cfg.head_dim, dtype=cfg.dtype, quant=kv_quant,
                block=self.kv_block, n_blocks=int(kv_pool_blocks),
                device=self.device,
            )
            self._allocator = BlockAllocator(self.cache.n_blocks)
            # Host mirror of the block table and each slot's blocks, and
            # the decode tokens dispatched per slot (scheduler thread only).
            self._table_host = np.zeros(
                tuple(self.cache.block_table.shape), dtype=np.int32
            )
            self._slot_blocks: list[list[int]] = [[] for _ in range(self.n_slots)]
            self._dispatched_tokens = [0] * self.n_slots
            self._table_dirty = False
            self.kv_blocks_peak = 0  # most blocks in use at once
            self.kv_admission_waits = 0  # passes that held a request back
        else:
            if kv_pool_blocks:
                raise ValueError("kv_pool_blocks needs kv_block > 0")
            self.cache = KVCache.create(
                cfg.n_layers, self.n_slots, self.max_len, cfg.n_kv_heads,
                cfg.head_dim, dtype=cfg.dtype, quant=kv_quant,
                device=self.device,
            )
        # The prefix cache. The radix index maps token content to physical
        # pool blocks; the explicit pool copies slot-cache rows.
        self.auto_prefix = bool(auto_prefix)
        self.prefix_cache_blocks = max(0, int(prefix_cache_blocks))
        self.prefix_evict_watermark = max(0, int(prefix_evict_watermark))
        self.prefix_slots = max(0, int(prefix_slots))
        self.queue_prefix_aware = bool(queue_prefix_aware)
        self._radix: Optional[RadixPrefixIndex] = (
            RadixPrefixIndex(self.kv_block, self._allocator,
                             max_blocks=self.prefix_cache_blocks)
            if self.auto_prefix else None
        )
        self._prefix_pool: Optional[PrefixPool] = (
            PrefixPool(self.prefix_slots, self.cache) if self.prefix_slots else None
        )
        # Host mirrors of app_tpu_prefix_{lookup,hit_tokens}_total, and the
        # (free, cached) signature of the last watermark sweep that found
        # nothing to evict (the loop skips re-scanning until it changes).
        self._prefix_lookups = 0
        self._prefix_hit_tokens = 0
        self._wm_fruitless: Optional[tuple[int, int]] = None
        self.rope = rope_tables(cfg, self.max_len, self.device)
        self.planes = SlotPlanes.create(
            self.n_slots, self.device, cfg.vocab_size, self.sampler,
            history_len=self.max_len if self.spec_tokens else 1,
        )
        # The mega window's fixed device buffers, and on the card the
        # captured decode programs (made when the scheduler starts).
        self._mega = (
            MegaState.create(self.n_slots, self.window_k, self.mega_windows,
                             self.top_logprobs, self.device, self.spec_tokens)
            if self.mega_windows > 1 else None
        )
        self._graphs: Optional[DecodeGraphs] = None
        # The HBM ledger over what this engine allocated, and the eviction
        # watermark: the explicit one, else derived from the ledger.
        self._build_hbm_ledger()
        self.effective_evict_watermark = self.prefix_evict_watermark
        if (self.prefix_evict_watermark <= 0 and self.prefix_evict_hbm_frac > 0
                and self.kv_block):
            self.effective_evict_watermark = self._ledger.derive_block_watermark(
                self.prefix_evict_hbm_frac
            )

        # Host-side scheduler state (scheduler thread only).
        self._slots: list[Optional[GenRequest]] = [None] * self.n_slots
        self._prefilling: dict[int, _Prefill] = {}
        self._seeds_host = np.zeros((self.n_slots,), dtype=np.int64)
        self._aids_host = np.zeros((self.n_slots,), dtype=np.int64)
        self._bidx_host = np.full((self.n_slots, LOGIT_BIAS_K), -1, dtype=np.int64)
        self._bval_host = np.zeros((self.n_slots, LOGIT_BIAS_K), dtype=np.float32)
        self._seeds_dirty = False
        self._slot_state_dirty = False
        # Tokens each live slot's dispatched windows cover (1 at admission
        # to decode: the prompt's first token), the windows in flight,
        # and the first tokens whose copy to the host is on its way.
        self._tokens_in_flight = [0] * self.n_slots
        self._inflight: "collections.deque[_Window]" = collections.deque()
        self._prefill_emits: list[tuple] = []
        # Device steps dispatched (prefill dispatches, k-step windows,
        # mega dispatches) and the windows each recent mega dispatch ran.
        self.prefill_steps = 0
        self.decode_windows = 0
        self.mega_dispatches = 0
        self.windows_run: "collections.deque[int]" = collections.deque(maxlen=1024)
        # Tokens emitted since the last app_tpu_tokens_generated add.
        self._unpublished_tokens = 0

        # Admission control (guarded by self._submit_lock): the class-priority
        # queue, its token backlog and per-tenant seats, and the aggregate
        # throughput estimate behind projected-wait shedding.
        self.queue_max = max(1, int(queue_max))
        self.queue_max_tokens = max(0, int(queue_max_tokens))
        self.class_promote_s = max(0.0, float(class_promote_s))
        self.tenant_queue_max = max(0, int(tenant_queue_max))
        self._tenant_class_map = parse_tenant_class_map(tenant_slo_class)
        self._expected_tps = max(0.0, float(expected_tps))
        self._tput = AggregateThroughput()
        self._queued_tokens = 0
        self._tenant_queued: dict[str, int] = {}
        # Prefix-aware admission order probes the index without mutating
        # it (peek: no increfs, no LRU refresh).
        prefix_probe = None
        if self.queue_prefix_aware and self._radix is not None:
            radix = self._radix
            prefix_probe = lambda req: radix.peek(  # noqa: E731
                list(req.prompt_ids), req.aid) > 0
        self._pending = ClassPriorityQueue(
            maxsize=self.queue_max, promote_after_s=self.class_promote_s,
            prefix_probe=prefix_probe,
        )
        # Submit-time sheds and lifecycle reaps, by reason (the
        # reference's app_tpu_requests_shed_total{reason} and its
        # deadline-exceeded / cancelled counters).
        self.shed_counts: collections.Counter[str] = collections.Counter()
        self.reap_counts: collections.Counter[str] = collections.Counter()
        self._work = threading.Event()
        # Requests taken off the queue that wait for KV blocks (loop only).
        self._backlog: "collections.deque[GenRequest]" = collections.deque()
        # Lifecycle flags (written under self._submit_lock): running, draining
        # for a graceful stop (submits get 503), and the error that killed
        # the scheduler. The scheduler sets _idle_evt once a drain finds
        # no work left.
        self._submit_lock = lockcheck.make_lock("InferenceEngine._submit_lock")
        # Held by the scheduler thread for each pass and the graph capture,
        # and by load_lora/unload_lora for their slot writes
        # (_device_turn): an adapter write lands between two passes, in
        # stream order. The scheduler stands aside between passes while a
        # writer waits (_device_waiters, under self._submit_lock). It stays
        # a plain RLock outside lockcheck: the reference has no such lock
        # (so no name in its lock model), and lockcheck instruments plain
        # mutexes only, raising on the re-acquisition an RLock allows.
        self._device_lock = threading.RLock()
        self._device_waiters = 0
        # Calls another thread hands to the scheduler thread, run at the
        # top of its loop between two passes (run_between_passes: the
        # profiler capture's start and stop).
        self._handoffs: "collections.deque[tuple[Any, Future]]" = collections.deque()
        self._running = False
        self._draining = False
        self._error: Optional[BaseException] = None
        self._idle_evt = threading.Event()
        self._state = "DOWN"
        self._thread: Optional[threading.Thread] = None
        # Set by the scheduler once its graphs are captured (or it died).
        self._ready = threading.Event()
        # The profiler's CUDA tracer attaches here, on the constructing
        # thread, before the scheduler captures its CUDA graphs.
        profiler_capture.warm_up(self.device)
        self.start_sync()

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    @property
    def max_prompt_tokens(self) -> int:
        """Longest admissible prompt: one generated token plus the windows
        in flight (``pipeline_depth + 1`` of them, as the reference
        reserves) must still fit in the cache."""
        return self.max_len - 2 - (self.pipeline_depth + 1) * self.window_k

    def kv_pool_counts(self) -> tuple[int, int, int]:
        """``(total, used, cached)`` blocks of the paged pool, the
        reference's accounting: allocatable blocks (block 0 parks), blocks
        held by live tables or the radix index, and the index's
        (reclaimable) share. ``(0, 0, 0)`` for the slot cache."""
        if not self.kv_block:
            return 0, 0, 0
        total = self.cache.n_blocks - 1
        cached = self._radix.n_cached_blocks if self._radix is not None else 0
        return total, max(0, total - self._allocator.n_free), cached

    def submit_generate(
        self,
        prompt: str | list[int],
        max_new_tokens: int = 128,
        temperature: float = 0.0,
        stop_on_eos: bool = True,
        stop: Optional[list[str]] = None,
        top_p: float = 1.0,
        frequency_penalty: float = 0.0,
        presence_penalty: float = 0.0,
        seed: Optional[int] = None,
        logit_bias: Optional[dict] = None,
        top_logprobs: int = 0,
        adapter: str = "",
        deadline: Optional[Deadline] = None,
        deadline_s: Optional[float] = None,
        cancel: Optional[CancelToken] = None,
        tenant: str = "",
        slo_class: str = "",
        traceparent: Optional[str] = None,
        **options: Any,
    ) -> GenRequest:
        """Queue a generate request; returns its record (``future``
        resolves with the ``GenerationResult`` or the error that retired
        it, ``stream`` yields token ids then ``None``). The checks, their
        order, error types and messages are the reference's.
        ``traceparent`` (the caller's W3C trace context) is kept on the
        request, as the reference keeps it with its request-observability
        layer off. ``adapter`` names a loaded LoRA adapter ("" = the base
        model). ``pin_replica`` is accepted at its neutral value and raises
        ``NotImplementedError`` naming its ROADMAP item otherwise; a name
        the reference does not take raises ``TypeError``."""
        if self.family != "llm":
            raise RuntimeError(f"model {self.model_name} is not a generative LLM")
        for key, val in options.items():
            if key not in _NEUTRAL_SUBMIT_OPTIONS:
                raise TypeError(f"submit_generate() got an unexpected option {key!r}")
            neutral, item = _NEUTRAL_SUBMIT_OPTIONS[key]
            if val is not None and val != neutral:
                raise NotImplementedError(f"{key}={val!r} is not ported yet ({item})")
        aid = 0
        if adapter:
            if adapter not in self._lora_names:
                raise ErrorInvalidParam([
                    f"unknown LoRA adapter {adapter!r}; loaded: "
                    f"{sorted(self._lora_names)}"
                ])
            aid = self._lora_names[adapter]
        if not 0.0 < top_p <= 1.0:
            raise ErrorInvalidParam(["top_p must be in (0, 1]"])
        if top_p < 1.0 and not self.enable_top_p:
            raise ErrorInvalidParam([
                "top_p requires TPU_TOP_P=true (compiles the nucleus "
                "sort into the sampler)"
            ])
        if frequency_penalty or presence_penalty:
            if not self.enable_penalties:
                raise ErrorInvalidParam([
                    "frequency/presence penalties require TPU_PENALTIES="
                    "true (compiles the per-slot token-count plane into "
                    "the sampler)"
                ])
            if not (-2.0 <= frequency_penalty <= 2.0
                    and -2.0 <= presence_penalty <= 2.0):
                raise ErrorInvalidParam(["penalties must be in [-2, 2]"])
        if top_logprobs:
            if not 0 < int(top_logprobs) <= self.top_logprobs:
                raise ErrorInvalidParam([
                    f"top_logprobs must be in [1, {self.top_logprobs}] "
                    f"(the engine compiles TPU_TOP_LOGPROBS="
                    f"{self.top_logprobs} alternatives)"
                    if self.top_logprobs else
                    "top_logprobs requires TPU_TOP_LOGPROBS>0 (compiles "
                    "the per-step alternatives top_k into the sampler)"
                ])
        bias = self._check_logit_bias(logit_bias) if logit_bias else {}
        ids = (
            self.tokenizer.encode(prompt) if isinstance(prompt, str)
            else [int(i) for i in prompt]
        )
        # Overlong prompts are rejected up front unless truncation was
        # enabled, which keeps the tail and flags the result.
        max_prompt = self.max_prompt_tokens
        truncated = False
        if len(ids) > max_prompt:
            if not self.truncate_prompts:
                raise ErrorPromptTooLong(len(ids), max_prompt)
            ids = ids[-max_prompt:]
            truncated = True
        # The reference decodes whatever it is given; torch's embedding
        # gather raises on an empty row or an id outside the vocabulary,
        # so those are refused here instead of failing the engine.
        if not ids:
            raise ErrorInvalidParam(["prompt must be at least one token"])
        if any(not 0 <= i < self.cfg.vocab_size for i in ids):
            raise ErrorInvalidParam([
                f"prompt token ids must be in [0, {self.cfg.vocab_size})"
            ])
        # SLO class: an explicit, valid class wins, then the tenant's
        # default, then "standard".
        cls = normalize_slo_class(slo_class)
        if not cls:
            cls = self._tenant_class_map.get(str(tenant or "").lower(), "standard")
        req = GenRequest(
            prompt_ids=ids,
            max_new_tokens=int(max_new_tokens),
            temperature=float(temperature),
            stop_on_eos=bool(stop_on_eos),
            truncated=truncated,
            stop_texts=list(stop or []),
            top_p=float(top_p),
            frequency_penalty=float(frequency_penalty),
            presence_penalty=float(presence_penalty),
            # Unseeded requests draw a fresh seed (distinct streams).
            seed=(
                int(seed) & 0x7FFFFFFF if seed is not None
                else self._seed_rng.getrandbits(31)
            ),
            logit_bias=bias,
            top_logprobs=int(top_logprobs or 0),
            aid=aid,
            adapter=adapter,
            # The adapter slot's generation: a reload or unload while the
            # request is queued fails it at admission.
            lora_gen=self._lora_gen[aid] if aid else 0,
            deadline=coalesce_deadline(deadline, deadline_s),
            tenant=str(tenant or ""),
            slo_class=cls,
            traceparent=traceparent,
        )
        if cancel is not None:
            # Share the transport's token, so tripping it retires the
            # request mid-decode.
            req.cancel = cancel
        self._enqueue(req)
        return req

    def _check_logit_bias(self, logit_bias: Any) -> dict[int, float]:
        if not isinstance(logit_bias, dict):
            raise ErrorInvalidParam([
                "logit_bias must be an object mapping token ids to numbers"
            ])
        if len(logit_bias) > LOGIT_BIAS_K:
            raise ErrorInvalidParam([
                f"logit_bias supports at most {LOGIT_BIAS_K} entries"
            ])
        try:
            if any(isinstance(t, float) and t != int(t) for t in logit_bias):
                raise ValueError("fractional token id")
            bias = {int(t): float(b) for t, b in logit_bias.items()}
        except (TypeError, ValueError):
            raise ErrorInvalidParam([
                "logit_bias must map integral token ids to numbers"
            ]) from None
        if any(not 0 <= t < self.cfg.vocab_size for t in bias) or any(
            not -100.0 <= b <= 100.0 for b in bias.values()
        ):
            raise ErrorInvalidParam([
                f"logit_bias token ids must be in [0, "
                f"{self.cfg.vocab_size}) and biases in [-100, 100]"
            ])
        return bias

    def _throughput_tps(self) -> float:
        """Tokens/s for projected-wait shedding: the ``expected_tps``
        prior wins, then the measured aggregate rate, then 50 tok/s as the
        cold-start floor."""
        if self._expected_tps > 0:
            return self._expected_tps
        rate = self._tput.rate()
        return rate if rate > 0 else 50.0

    def _projected_wait_s(self, cost_tokens: int) -> float:
        """Seconds of queue ahead of a request costing ``cost_tokens``
        (prompt + budget). Read under ``self._submit_lock``."""
        return (self._queued_tokens + cost_tokens) / self._throughput_tps()

    def _retry_after_s(self, cost: int, reason: str = "") -> float:
        """The Retry-After of an admission shed: the queue-drain
        projection, plus for ``hbm_headroom`` the in-flight decode backlog
        (headroom recovers as live work retires) — the reference's
        ``shed_retry_after_s`` without the brownout, tenant-ledger and
        control-plane floors, not ported."""
        wait = self._projected_wait_s(max(0, cost))
        if reason == "hbm_headroom":
            inflight = sum(
                max(0, max(1, req.max_new_tokens) - len(req.token_ids))
                for req in self._slots if req is not None
            )
            wait += inflight / self._throughput_tps()
        return max(wait, 0.5)

    def _shed(self, reason: str, retry_after_s: float) -> None:
        self.shed_counts[reason] += 1
        if self._metrics is not None:
            self._metrics.increment_counter(
                "app_tpu_requests_shed_total",
                "model", self.model_name, "reason", reason,
            )
        if self._logger is not None:
            self._logger.warnf(
                "shedding request (%s); retry in ~%.0fs", reason, retry_after_s,
            )

    def _enqueue(self, req: GenRequest) -> None:
        cost = len(req.prompt_ids) + req.max_new_tokens
        with self._submit_lock:
            if self._draining:
                raise ErrorServiceUnavailable(
                    "engine draining for shutdown; retry against another replica"
                )
            if self._error is not None:
                raise RuntimeError(
                    f"engine scheduler died: {self._error}"
                ) from self._error
            if not self._running:
                raise RuntimeError("engine not started")
            wait_s = self._projected_wait_s(cost)
            # Per-tenant quota first: one tenant's flood sheds on its own
            # budget before it exhausts the global one.
            if (
                self.tenant_queue_max
                and req.tenant
                and self._tenant_queued.get(req.tenant, 0) >= self.tenant_queue_max
            ):
                retry = self._retry_after_s(cost)
                self._shed("tenant_quota", retry)
                raise ErrorTooManyRequests(
                    f"tenant {req.tenant!r} has "
                    f"{self._tenant_queued[req.tenant]} queued request(s) "
                    f"(TPU_TENANT_QUEUE_MAX={self.tenant_queue_max})",
                    retry_after_s=retry,
                )
            if self.admit_min_headroom > 0:
                # Below the HBM headroom floor new work is shed 429: a
                # nearly full pool answers "retry elsewhere" instead of a
                # mid-stream pool-exhausted failure. A non-finite ratio
                # reads as no signal, never as pressure.
                headroom = self.hbm_headroom_ratio()
                if math.isfinite(headroom) and headroom < self.admit_min_headroom:
                    retry = self._retry_after_s(cost, "hbm_headroom")
                    self._shed("hbm_headroom", retry)
                    raise ErrorTooManyRequests(
                        f"HBM headroom {headroom:.3f} below the "
                        f"admission floor {self.admit_min_headroom:.3f} "
                        f"(TPU_ADMIT_MIN_HEADROOM); retry against "
                        f"another replica",
                        retry_after_s=retry,
                    )
            if (
                self.queue_max_tokens
                and self._queued_tokens + cost > self.queue_max_tokens
            ):
                retry = self._retry_after_s(cost)
                self._shed("queue_tokens", retry)
                raise ErrorTooManyRequests(
                    f"submit queue token budget exhausted "
                    f"({self._queued_tokens} queued + {cost} requested > "
                    f"{self.queue_max_tokens}; TPU_QUEUE_TOKENS)",
                    retry_after_s=retry,
                )
            # A deadline that cannot survive the projected queue wait is
            # rejected now, before it burns a slot.
            if req.deadline is not None and (
                req.deadline.expired() or req.deadline.remaining() <= wait_s
            ):
                self._shed("deadline", wait_s)
                raise ErrorDeadlineExceeded(
                    f"projected queue wait {wait_s:.2f}s exceeds the "
                    f"request deadline "
                    f"({max(req.deadline.remaining(), 0.0):.2f}s left)"
                )
            try:
                self._pending.put_nowait(req)
            except queue.Full:
                retry = self._retry_after_s(cost)
                self._shed("queue_full", retry)
                raise ErrorTooManyRequests(
                    f"submit queue full ({self._pending.maxsize} requests; "
                    f"TPU_QUEUE_MAX)",
                    retry_after_s=retry,
                ) from None
            self._queued_tokens += cost
            if self.tenant_queue_max and req.tenant:
                self._tenant_queued[req.tenant] = (
                    self._tenant_queued.get(req.tenant, 0) + 1
                )
        self._work.set()

    def _note_dequeued(self, req: GenRequest) -> None:
        """Return a popped request's tokens and tenant seat to the
        submit budgets."""
        cost = len(req.prompt_ids) + req.max_new_tokens
        with self._submit_lock:
            self._queued_tokens = max(0, self._queued_tokens - cost)
            if req.tenant and req.tenant in self._tenant_queued:
                left = self._tenant_queued[req.tenant] - 1
                if left > 0:
                    self._tenant_queued[req.tenant] = left
                else:
                    del self._tenant_queued[req.tenant]

    def register_prefix(self, prompt: str | list[int], adapter: str = "") -> GenRequest:
        """Prefill a shared prompt prefix once and park its K/V rows in the
        prefix pool; a later prompt starting with it has the rows copied
        into its slot at admission and prefills only the rest. The
        request's future resolves with the pool row. Needs ``prefix_slots
        > 0`` (``TPU_PREFIX_SLOTS``); the checks and messages are the
        reference's. With ``adapter``, the prefix prefills under that LoRA
        adapter and only same-adapter requests reuse it."""
        aid = 0
        if adapter:
            if adapter not in self._lora_names:
                raise KeyError(f"no loaded LoRA adapter {adapter!r}")
            aid = self._lora_names[adapter]
        if self._prefix_pool is None:
            raise RuntimeError(
                "prefix pool disabled — construct the engine with "
                "prefix_slots > 0 (TPU_PREFIX_SLOTS)"
            )
        ids = (
            self.tokenizer.encode(prompt) if isinstance(prompt, str)
            else [int(i) for i in prompt]
        )
        if not ids:
            raise ValueError("prefix must be at least one token")
        if len(ids) > self.max_prompt_tokens:
            raise ErrorPromptTooLong(len(ids), self.max_prompt_tokens)
        if any(not 0 <= i < self.cfg.vocab_size for i in ids):
            raise ErrorInvalidParam([
                f"prompt token ids must be in [0, {self.cfg.vocab_size})"
            ])
        req = GenRequest(
            prompt_ids=ids, max_new_tokens=1, temperature=0.0,
            stop_on_eos=False, seed=0, prefix_store=True, aid=aid,
            lora_gen=self._lora_gen[aid] if aid else 0,
        )
        self._enqueue(req)
        return req

    def register_prefix_sync(
        self, prompt: Any, timeout: float = 300.0, adapter: str = ""
    ) -> int:
        return self.register_prefix(prompt, adapter=adapter).future.result(
            timeout=timeout
        )

    def generate_sync(
        self, prompt: Any, timeout: float = 300.0, **kw: Any
    ) -> GenerationResult:
        return self.submit_generate(prompt, **kw).future.result(timeout=timeout)

    async def generate(self, prompt: Any, **kw: Any) -> GenerationResult:
        req = self.submit_generate(prompt, **kw)
        return await asyncio.wrap_future(req.future)

    async def generate_stream(self, prompt: Any, **kw: Any) -> AsyncIterator[int]:
        """Async iterator over generated token ids."""
        req = self.submit_generate(prompt, **kw)
        loop = asyncio.get_running_loop()
        while True:
            tok = await loop.run_in_executor(None, req.stream.get)
            if tok is None:
                if req.future.done() and not req.future.cancelled() and (
                    req.future.exception() is not None
                ):
                    raise req.future.exception()
                return
            yield tok

    @staticmethod
    def _infer_dict(result: GenerationResult) -> dict:
        return {
            "text": result.text,
            "tokens": len(result.token_ids),
            "ttft_ms": round(result.ttft_s * 1e3, 2),
        }

    async def infer(self, inputs: Any, model: str = "", **kw: Any) -> dict:
        """The ``ctx.infer`` seam: dispatch on the family (an LLM's text,
        an encoder's embedding, a vision model's logits and class)."""
        if self.family != "llm":
            return await self._batch_infer(inputs)
        return self._infer_dict(await self.generate(inputs, **kw))

    def infer_sync(self, inputs: Any, model: str = "", **kw: Any) -> dict:
        if self.family != "llm":
            return self._batch_infer_sync(inputs)
        return self._infer_dict(self.generate_sync(inputs, **kw))

    # -- weights ----------------------------------------------------------

    def apply_quantization(self, mode: str) -> None:
        """Quantize the weights in place, the reference's: int8 or int4, only
        while the scheduler does not run (the constructor calls it before it
        starts the scheduler; later, after ``stop_sync``). A no-op for ""
        and for the mode the weights already have. The decode programs
        captured from the old weights are dropped and captured again at the
        next start."""
        mode = (mode or "").lower()
        if not mode:
            return
        if self.quant:
            if self.quant == mode:
                return
            raise RuntimeError(
                f"params already quantized as {self.quant!r}; cannot "
                f"re-quantize as {mode!r}"
            )
        quant_fn(mode)  # the reference's ValueError for any other mode
        if self.family not in ("llm", "seq2seq"):
            raise ValueError("quantization supports llm and seq2seq models only")
        if getattr(self, "_running", False):  # the constructor calls this first
            raise RuntimeError("quantize before starting the engine")
        if self.family == "seq2seq":
            from gofr_tpu_torch.models.t5 import quantize_t5_params

            self.params = quantize_t5_params(self.params, mode)
            self.quant = mode
            if self._ledger is not None:
                self._build_hbm_ledger()
            return
        self.params = quantize_params(self.params, mode)
        self.quant = mode
        self._graphs = None
        if self._ledger is not None:  # the constructor builds it after this
            self._build_hbm_ledger()

    def param_bytes(self) -> int:
        """Parameter bytes as stored (``ops.quant.quantized_bytes``)."""
        return quantized_bytes(self.params)

    # -- device services (serving/device_telemetry.py) ---------------------

    def _device_memory_stats(self) -> Optional[dict]:
        """The card's own memory accounting under the reference's key
        names (``bytes_limit``: the device's memory, ``bytes_in_use`` /
        ``peak_bytes_in_use``: PyTorch's allocated bytes); None on the
        CPU, as the reference's CPU backend."""
        if self.device.type != "cuda":
            return None
        _, total = torch.cuda.mem_get_info(self.device)
        return {
            "bytes_limit": int(total),
            "bytes_in_use": int(torch.cuda.memory_allocated(self.device)),
            "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(self.device)),
        }

    def _build_hbm_ledger(self) -> None:
        """Account every device tensor this engine allocated into an
        ``HBMLedger``: ``params`` (stored bytes, adapter leaves apart),
        ``lora``, ``kv_pool`` (exactly ``cache.hbm_bytes()``),
        ``prefix_pool`` and ``workspace`` (the cache's lengths and block
        table, the slots' request planes, the mega window's buffers).
        Sizes are metadata reads, fixed until a re-quantize. An encoder or
        vision engine has ``params`` alone (its batch workspace is
        transient), built once."""
        if self.family != "llm":
            self._ledger = HBMLedger(
                {"params": tree_device_bytes(self.params)},
                budget_bytes=self.hbm_budget_bytes,
                device_stats=self._device_memory_stats,
            )
            self._ledger.publish(self._metrics, self.model_name)
            return
        lora_bytes = sum(
            tree_device_bytes(v) for k, v in self.params.items()
            if k.endswith("_lora_a") or k.endswith("_lora_b")
        )
        components: dict[str, int] = {
            "params": tree_device_bytes(self.params) - lora_bytes,
        }
        if lora_bytes:
            components["lora"] = lora_bytes
        cache = self.cache
        components["kv_pool"] = cache.hbm_bytes()
        components["workspace"] = tree_device_bytes([
            cache.lengths, getattr(cache, "block_table", None),
            self.planes, self._mega,
        ])
        if self._prefix_pool is not None:
            components["prefix_pool"] = self._prefix_pool.hbm_bytes()
        block_bytes = n_blocks = 0
        if self.kv_block:
            block_bytes = cache.block_bytes()
            n_blocks = cache.n_blocks
        self._ledger = HBMLedger(
            components,
            block_bytes=block_bytes,
            n_blocks=n_blocks,
            budget_bytes=self.hbm_budget_bytes,
            device_stats=self._device_memory_stats,
        )
        self._ledger.publish(self._metrics, self.model_name)

    def hbm_ledger(self) -> dict:
        """The HBM ledger's snapshot: components, totals, budget and its
        source, headroom, and the card's own accounting beside them."""
        if self._ledger is None:
            return {}
        return dict(self._ledger.snapshot(self._ledger_free_blocks()))

    def _ledger_free_blocks(self) -> int:
        return int(self._allocator.n_free) if self.kv_block else 0

    def hbm_headroom_ratio(self) -> float:
        """The saturation signal: the free fraction of the HBM budget
        (budget slack + free paged blocks). Read by admission
        (``admit_min_headroom``). Host arithmetic only."""
        if self._ledger is None:
            return 1.0
        return float(self._ledger.headroom_ratio(self._ledger_free_blocks()))

    def mark_steady_state(self) -> None:
        """Arm the compile tracker's warm-up fence: every capture or build
        after this call counts (and warns) as a steady-state recompile."""
        self._compiles.mark_warm()

    def compile_stats(self) -> dict:
        """The compile tracker's snapshot: per-program compiles and their
        seconds, the steady-state recompiles, whether the fence is armed,
        and the build directory's provenance."""
        return dict(self._compiles.snapshot())

    def capacity_report(self) -> dict:
        """``/debug/capacity``'s per-engine record (reference
        ``engine.py:3130-3180``): the HBM ledger, compile counts and
        paged-pool pressure in one read. The reference's loop, tenant,
        SLO, brownout and control blocks belong to components the port
        has not got (ROADMAP Queue 1 item 7), and are absent as in a
        reference engine without them."""
        report: dict[str, Any] = {
            "model": self.model_name,
            "state": self._state,
            "hbm": self.hbm_ledger(),
            "compiles": self.compile_stats(),
        }
        if self.family == "llm" and self.kv_block:
            total, used, cached = self.kv_pool_counts()
            pool: dict[str, Any] = {
                "block_tokens": self.kv_block,
                "total_blocks": total,
                "free_blocks": total - used,
                "used_blocks": used,
                "occupancy_ratio": round(used / max(1, total), 6),
                "evict_watermark": self.effective_evict_watermark,
                "evict_watermark_source": (
                    "explicit" if self.prefix_evict_watermark > 0
                    else ("hbm_frac" if self.effective_evict_watermark > 0 else "off")
                ),
            }
            if self._radix is not None:
                pool["cached_blocks"] = cached
                pool["fragmentation_ratio"] = round(cached / used, 6) if used else 0.0
            report["kv_pool"] = pool
        return report

    # -- lifecycle (the reference's start/stop and drain semantics) --------

    async def start(self) -> None:
        self.start_sync()

    def start_sync(self) -> None:
        """Start the scheduler thread (an encoder or vision engine: its
        batcher); a no-op while it runs (the constructor starts it), a
        restart after a stop. On the card it returns once the scheduler
        has captured its decode programs: a device-wide synchronize on any
        other thread during a capture (the caller's next line, say)
        invalidates it."""
        if self.family != "llm":
            self._batch_start()
            return
        with self._submit_lock:
            if self._running:
                return
            self._running = True
            self._draining = False
            self._error = None
            self._queued_tokens = 0
            self._tenant_queued.clear()
            self._idle_evt.clear()
        self._tput.reset()
        self._set_state("SERVING")
        self._ready = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name=f"gofr-torch-engine-{self.model_name}",
            daemon=True,
        )
        self._thread.start()
        if self.device.type == "cuda":
            self._ready.wait()

    async def stop(self, drain_s: float = 0.0) -> None:
        if drain_s > 0:
            await asyncio.get_running_loop().run_in_executor(
                None, self.stop_sync, drain_s
            )
        else:
            self.stop_sync()

    def stop_sync(self, drain_s: float = 0.0, timeout: float = 30.0) -> None:
        """Stop the engine. ``drain_s > 0`` is graceful: new submits get
        503 while queued and in-flight generations run to completion, up
        to ``drain_s`` seconds. Whatever is left then fails with
        ``RuntimeError``; later submits raise (503 after a graceful stop,
        "engine not started" after a hard one, as in the reference). An
        encoder or vision engine stops its batcher (no drain, as in the
        reference)."""
        if self.family != "llm":
            self._batch_stop()
            return
        if drain_s > 0 and self._running:
            with self._submit_lock:
                self._draining = True
                self._idle_evt.clear()
            self._work.set()
            deadline = time.monotonic() + drain_s
            while (left := deadline - time.monotonic()) > 0:
                # Only the scheduler declares the engine idle (it checks
                # every queue under the lock), so a request in transit
                # between two structures is never missed.
                if self._idle_evt.wait(timeout=left) or not self._running:
                    break
        with self._submit_lock:
            self._running = False
        self._work.set()  # wake the loop
        thread = self._thread
        if thread is not None:
            thread.join(timeout=timeout)
            if thread.is_alive():
                raise RuntimeError("engine scheduler thread did not stop")
            self._thread = None
            self._fail_all(RuntimeError("engine stopped"))
        self._set_state("DOWN")

    def close(self, timeout: float = 30.0) -> None:
        """Stop the engine at once; requests still queued or in flight
        fail with ``RuntimeError``."""
        self.stop_sync(timeout=timeout)

    @property
    def state(self) -> str:
        return self._state

    def _set_state(self, state: str) -> None:
        """SERVING, DEGRADED (the scheduler died) or DOWN (stopped),
        mirrored to the app_tpu_engine_state gauge."""
        self._state = state
        if self._metrics is not None:
            self._metrics.set_gauge(
                "app_tpu_engine_state", _STATE_CODES.get(state, 3),
                "model", self.model_name,
            )

    def health_check(self) -> dict:
        """The reference's health payload for the state the port has."""
        if self.device.type == "cuda":
            devices = [f"{self.device} ({torch.cuda.get_device_name(self.device)})"]
        else:
            devices = [str(self.device)]
        details: dict[str, Any] = {
            "model": self.model_name,
            "family": self.family,
            "devices": devices,
            "running": self._running,
            "state": self._state,
        }
        if self.family == "llm":
            details.update({
                "kv_slots": {
                    "total": self.n_slots,
                    "in_use": sum(1 for s in self._slots if s is not None),
                },
                "max_len": self.max_len,
                "pending": self._pending.qsize(),
                "prefilling": len(self._prefilling),
                # The loaded adapters (a replica pool routes LoRA requests
                # by them).
                "lora_adapters": self.lora_names(),
            })
        if self.kv_block:
            details["kv_blocks"] = {
                "block": self.kv_block,
                "total": self.cache.n_blocks - 1,  # block 0 parks
                "free": self._allocator.n_free,
            }
            if self._radix is not None:
                details["prefix_cache"] = {
                    "cached_blocks": self._radix.n_cached_blocks,
                    "lookups": self._prefix_lookups,
                    "hit_tokens": self._prefix_hit_tokens,
                }
        if self._ledger is not None:
            # The ledger's compact form and the compile counts, the
            # reference's health detail.
            snap = self.hbm_ledger()
            details["hbm_ledger"] = {
                "components": snap.get("components", {}),
                "total_bytes": snap.get("total_bytes", 0),
                "per_device_bytes": snap.get("per_device_bytes", 0),
                "budget_bytes": snap.get("budget_bytes", 0),
                "budget_source": snap.get("budget_source", ""),
                "headroom_ratio": snap.get("headroom_ratio", 1.0),
            }
            details["compiles"] = {
                "total": self._compiles.total,
                "steady_state_recompiles": self._compiles.steady_state_recompiles,
            }
            if self._compiles.cache_info is not None:
                details["compiles"]["compile_cache"] = dict(self._compiles.cache_info)
        up = self._running and self._state == "SERVING"
        return {"status": "UP" if up else "DOWN", "state": self._state,
                "details": details}

    @classmethod
    def from_config(
        cls, config: Any, logger: Any = None, metrics: Any = None,
    ) -> "InferenceEngine":
        """Build the engine from ``TPU_*`` keys, with the key names and
        defaults of the reference's ``InferenceEngine.from_config``.
        ``TPU_DEVICE`` (``cuda``, ``cuda:N`` or ``cpu``; unset = ``cuda``)
        is the port's own key. A key of a feature the port does not serve
        yet raises ``NotImplementedError`` unless it holds the reference's
        default (``check_unported_keys``). ``TPU_CHECKPOINT`` and
        ``TPU_QUANT`` in the reference's order: an HF directory loads
        through ``load_hf_llama`` with the quant mode (a seq2seq model's
        through ``load_hf_t5``, held against the registry's config);
        anything else is restored by ``maybe_restore_params`` over the
        seed-0 weights, then quantized. ``TPU_SPEC_TOKENS`` is resolved
        by ``resolve_spec_tokens`` before the constructor, with the
        device's type as the backend (so ``auto`` is 0 here); its note
        goes to ``logger``. ``TPU_LORA_SLOTS`` / ``TPU_LORA_RANK`` /
        ``TPU_LORA_TARGETS`` shape the adapter slots, and
        ``TPU_LORA_ADAPTERS`` (``name=path,name2=path2``, HF PEFT
        directories) loads adapters at boot. ``TPU_TOKENIZER`` serves a
        ``tokenizer.json`` directory (``tokenizer_from_config``; the byte
        tokenizer when it cannot be read), ``TPU_HBM_BYTES``,
        ``TPU_ADMIT_MIN_HEADROOM`` and ``TPU_PREFIX_EVICT_HBM_FRAC`` are
        the device services' knobs, and ``TPU_COMPILE_CACHE_DIR`` the
        native builds' directory, set before the tokenizer's core is
        built. An encoder, vision or seq2seq ``TPU_MODEL`` serves behind the
        dynamic batcher (``TPU_MAX_BATCH``, ``TPU_BATCH_WAIT_MS``; T5 reads
        ``TPU_SEQ2SEQ_MAX_NEW`` and ``TPU_SEQ2SEQ_CHUNK`` from the process
        environment, as the reference); an encoder's or vision model's
        ``TPU_CHECKPOINT`` is a ``serving/checkpoint.py`` file over the
        seed-0 weights (the HF loader reads decoders and T5)."""
        check_unported_keys(config)
        compile_cache_dir = config.get_or_default("TPU_COMPILE_CACHE_DIR", "")
        # Before the tokenizer below builds the BPE core into it.
        compile_cache = build_cache.use_dir(compile_cache_dir) if compile_cache_dir else ""
        tokenizer = tokenizer_from_config(config, logger)
        tok_path = config.get_or_default("TPU_TOKENIZER", "")
        if tok_path and logger is not None:
            logger.infof("serving tokenizer %s from %s", type(tokenizer).__name__, tok_path)

        def num(key: str, default: str, kind: type = int) -> Any:
            return kind(config.get_or_default(key, default))

        device = resolve_device(config.get_or_default("TPU_DEVICE", "") or None)
        top_logprobs = num("TPU_TOP_LOGPROBS", "0")
        penalties = _truthy(config, "TPU_PENALTIES", "false")
        spec_tokens, spec_note = resolve_spec_tokens(
            config.get_or_default("TPU_SPEC_TOKENS", "auto"),
            device.type, penalties, top_logprobs,
        )
        if spec_note and logger is not None:
            logger.infof("%s", spec_note)
        model_name = config.get_or_default("TPU_MODEL", "llama-tiny")
        quant = config.get_or_default("TPU_QUANT", "")
        params = None
        ckpt = config.get_or_default("TPU_CHECKPOINT", "")
        spec = get_model(model_name)
        if ckpt and spec.family in ("encoder", "vision"):
            if is_hf_checkpoint(ckpt):
                raise ValueError(
                    f"TPU_CHECKPOINT={ckpt!r} is an HF directory; the HF loader reads "
                    f"decoder checkpoints, and {model_name} is of the {spec.family} family"
                )
            params = maybe_restore_params(config, spec.init(spec.config, 0, device), logger)
        elif ckpt and spec.family == "seq2seq":
            if is_hf_checkpoint(ckpt):
                # flan-t5 / t5 safetensors, each projection quantized as it
                # lands with TPU_QUANT, checked against the registry's config.
                params = load_hf_t5(ckpt, spec.config, quant=quant, device=device)
            else:
                params = maybe_restore_params(config, spec.init(spec.config, 0, device), logger)
        elif ckpt and spec.family == "llm":
            cfg = spec.config
            if is_hf_checkpoint(ckpt):
                # Real weights, quantized on the device a layer at a time
                # as they land: the bf16 tree never exists whole.
                params = load_hf_llama(ckpt, cfg, quant=quant, logger=logger,
                                       device=device)
            else:
                # A checkpoint file over the seed-0 weights (kept if the
                # restore fails, as the reference); TPU_QUANT then
                # quantizes it in the constructor.
                params = maybe_restore_params(config, init_params(cfg, 0, device), logger)

        engine = cls(
            model_name,
            n_slots=num("TPU_KV_SLOTS", "8"),
            max_len=num("TPU_MAX_LEN", "1024"),
            window_k=num("TPU_DECODE_WINDOW", "8"),
            pipeline_depth=num("TPU_PIPELINE_DEPTH", "2"),
            mega_windows=num("TPU_MEGA_WINDOWS", "0"),
            prefill_depth=num("TPU_PREFILL_DEPTH", "1"),
            spec_tokens=spec_tokens,
            prefill_chunk=num("TPU_PREFILL_CHUNK", "256"),
            prefill_batch=num("TPU_PREFILL_BATCH", "8"),
            kv_quant=config.get_or_default("TPU_KV_QUANT", ""),
            kv_block=num("TPU_KV_BLOCK", "0"),
            kv_pool_blocks=num("TPU_KV_POOL_BLOCKS", "0"),
            auto_prefix=_truthy(config, "TPU_AUTO_PREFIX", "false"),
            prefix_cache_blocks=num("TPU_PREFIX_CACHE_BLOCKS", "0"),
            prefix_evict_watermark=num("TPU_PREFIX_EVICT_WM", "0"),
            prefix_evict_hbm_frac=num("TPU_PREFIX_EVICT_HBM_FRAC", "0", float),
            admit_min_headroom=num("TPU_ADMIT_MIN_HEADROOM", "0", float),
            hbm_budget_bytes=num("TPU_HBM_BYTES", "0"),
            compile_cache_dir=compile_cache,
            prefix_slots=num("TPU_PREFIX_SLOTS", "0"),
            lora_slots=num("TPU_LORA_SLOTS", "0"),
            lora_rank=num("TPU_LORA_RANK", "16"),
            lora_targets=config.get_or_default("TPU_LORA_TARGETS", "wq,wk,wv,wo"),
            # The reference's reading: anything but an off spelling is on.
            queue_prefix_aware=config.get_or_default(
                "TPU_QUEUE_PREFIX_AWARE", "0").lower() not in _FALSY,
            truncate_prompts=_truthy(config, "TPU_TRUNCATE_PROMPTS", "false"),
            top_k=num("TPU_TOP_K", "0"),
            top_logprobs=top_logprobs,
            enable_top_p=_truthy(config, "TPU_TOP_P", "false"),
            enable_penalties=penalties,
            queue_max=num("TPU_QUEUE_MAX", "1024"),
            queue_max_tokens=num("TPU_QUEUE_TOKENS", "0"),
            class_promote_s=num("TPU_QUEUE_CLASS_PROMOTE_S", "5", float),
            tenant_queue_max=num("TPU_TENANT_QUEUE_MAX", "0"),
            tenant_slo_class=config.get_or_default("TPU_TENANT_SLO_CLASS", ""),
            expected_tps=num("TPU_EXPECTED_TPS", "0", float),
            max_batch=num("TPU_MAX_BATCH", "8"),
            max_wait_s=num("TPU_BATCH_WAIT_MS", "5", float) / 1e3,
            tokenizer=tokenizer,
            params=params,
            quant=quant,
            device=device,
            logger=logger,
            metrics=metrics,
        )
        # Boot-time LoRA adapters: TPU_LORA_ADAPTERS="name=path,name2=p2"
        # (HF PEFT checkpoint dirs); more load at run time by load_lora.
        adapters_cfg = config.get_or_default("TPU_LORA_ADAPTERS", "")
        if adapters_cfg:
            try:
                for entry in adapters_cfg.replace(";", ",").split(","):
                    entry = entry.strip()
                    if not entry:
                        continue
                    if "=" not in entry:
                        raise ValueError(
                            f"TPU_LORA_ADAPTERS entry {entry!r} is not "
                            f"name=path"
                        )
                    name, path = entry.split("=", 1)
                    engine.load_lora(name.strip(), path.strip())
            except BaseException:
                engine.close()  # its scheduler thread runs already
                raise
        return engine

    # ------------------------------------------------------------------
    # scheduler loop (its own thread; the only code that touches the
    # device state and the slot tables)
    # ------------------------------------------------------------------

    def run_between_passes(self, fn: Any, timeout: float = 30.0) -> Any:
        """Run ``fn()`` on the scheduler thread between two passes and
        return its result (or raise its error); on the caller's thread when
        the scheduler does not run (or is the caller). A call not taken
        within ``timeout`` seconds is withdrawn and raises
        ``TimeoutError``. The profiler capture starts and stops its trace
        here (``serving/profiler_capture.py``)."""
        fut: Future = Future()
        with self._submit_lock:
            queued = (self._running and self._thread is not None
                      and self._thread is not threading.current_thread())
            if queued:
                self._handoffs.append((fn, fut))
        if not queued:
            return fn()
        self._work.set()
        try:
            return fut.result(timeout=timeout)
        except FutureTimeout:
            if fut.cancel():
                raise TimeoutError(
                    f"the scheduler did not take the call within {timeout} s") from None
            return fut.result()  # it started just now: wait for it

    def _run_handoffs(self) -> None:
        while self._handoffs:
            fn, fut = self._handoffs.popleft()
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fut.set_result(fn())
            except BaseException as exc:  # the caller's error, raised there
                fut.set_exception(exc)

    def _run(self) -> None:
        on_card = self.device.type == "cuda"
        # A profiler capture starts and stops on this thread while it runs.
        profiler_capture.note_device_owner(self, True)
        try:
            if on_card:
                torch.cuda.set_device(self.device)
            with torch.inference_mode():
                if on_card and self._graphs is None:
                    with self._device_lock:
                        self._load_kernels()
                        self._capture_graphs()
                self._ready.set()
                while self._running:
                    if self._device_waiters:
                        time.sleep(0.0005)  # a writer takes the lock first
                        continue
                    with self._device_lock:
                        self._run_handoffs()
                        self._pass()
        except Exception as exc:  # the loop's boundary: report, fail callers
            traceback.print_exc()
            with self._submit_lock:
                self._error = exc
                self._running = False
            self._set_state("DEGRADED")
            if self._logger is not None:
                self._logger.errorf("engine scheduler died: %s", exc)
            self._fail_all(exc)
            self._idle_evt.set()  # a drain waiting on this engine ends
        finally:
            self._ready.set()  # a failed capture releases start_sync too
            # Calls handed over before _running fell are run, so no caller
            # waits out its timeout; later ones run on their own thread.
            with torch.inference_mode():
                self._run_handoffs()
            profiler_capture.note_device_owner(self, False)

    def _pass(self) -> None:
        """One scheduler pass, the reference's loop body
        (``gofr_tpu/serving/scheduler.py::_scheduler_loop``)."""
        # Cancelled and expired requests retire here, once a pass, so a
        # dead stream's slot and blocks free within one decode window.
        self._reap_lifecycle()
        if self._radix is not None:
            self._radix_watermark_sweep()
        self._admit()
        progressed = self._prefill_step()
        # Wave admission: while live streams fill under a quarter of the
        # slots, another chunk costs them little next to the idle
        # capacity, so keep prefilling; past that, one chunk a pass.
        while progressed and sum(s is not None for s in self._slots) * 4 < self.n_slots:
            self._admit()
            if not self._prefill_step():
                break
        self._flush_prefill_emits()
        any_active = any(s is not None for s in self._slots)
        if not any_active and not self._inflight:
            if self._prefill_emits:
                time.sleep(0.001)  # a first token's copy is on its way
            elif not progressed:
                if self._draining:
                    self._note_idle()
                self._work.wait(timeout=0.05)
                self._work.clear()
            return
        # Dispatch only while some live slot still has budget beyond what
        # the windows in flight cover: a wave of same-length requests
        # otherwise ends in windows whose tokens are all dropped.
        wants_more = any(
            req is not None and self._tokens_in_flight[i] < req.max_new_tokens
            for i, req in enumerate(self._slots)
        )
        if wants_more and (win := self._dispatch_window()) is not None:
            self._inflight.append(win)
        elif not self._inflight and self._prefill_emits:
            time.sleep(0.001)  # only first tokens are on their way
        while len(self._inflight) > (self.pipeline_depth if wants_more else 0):
            self._process_window(self._inflight.popleft())

    def _capture_graphs(self) -> None:
        """Capture the decode programs before the first request, while
        every slot is inactive (the capture's eager warm-up runs then park
        their writes and add 0 to the slots' counters)."""
        if self._mega is not None:
            self._graphs = DecodeGraphs(mega_fns=(
                lambda: mega_begin(self._mega),
                lambda sampling, use_bias: self._mega_step(sampling, use_bias),
                self._mega.go,
            ), capture=self._capture, name="spec_mega" if self.spec_tokens else "mega")
        else:
            self._graphs = DecodeGraphs(
                window_fn=lambda sampling, use_bias: self._window_eager(sampling, use_bias),
                capture=self._capture,
                name="spec_window" if self.spec_tokens else "window",
            )

    def _load_kernels(self) -> None:
        """Load the kernel library; the process's first load (a build or
        a read from the build directory) counts as one compile."""
        if _build.loaded():
            return
        w0, t0 = time.time_ns(), time.perf_counter()
        _build.lib()
        self._compiles._note_compile("kernel_library", time.perf_counter() - t0, w0)

    def _capture(self, program: str, fn: Any, pool: Any, keep_graph: bool = False):
        """One CUDA graph capture of ``program``, counted by the compile
        tracker (every capture compiles: a recapture after
        ``mark_steady_state`` is a steady-state recompile)."""
        call = self._capture_calls.get(program)
        if call is None:
            call = self._capture_calls[program] = self._compiles.wrap(
                program, CountingCall(Captured)
            )
        return call(fn, pool, keep_graph=keep_graph)

    def _note_idle(self) -> None:
        """During a drain: publish idle once nothing is queued, waiting
        for blocks, prefilling or decoding (submits are refused by then,
        so idle stays idle)."""
        with self._submit_lock:
            if (self._pending.qsize() == 0 and not self._backlog
                    and not self._prefilling and not self._inflight
                    and not self._prefill_emits
                    and all(s is None for s in self._slots)):
                self._idle_evt.set()

    def _pop_pending(self) -> Optional[GenRequest]:
        try:
            req = self._pending.get_nowait()
        except queue.Empty:
            return None
        self._note_dequeued(req)
        return req

    def _fail_all(self, exc: BaseException) -> None:
        reqs = [s for s in self._slots if s is not None]
        reqs += [st.request for st in self._prefilling.values()]
        reqs += list(self._backlog)
        self._backlog.clear()
        while (req := self._pop_pending()) is not None:
            reqs.append(req)
        self._slots = [None] * self.n_slots
        self._prefilling.clear()
        self._inflight.clear()
        self._prefill_emits = []
        self._slot_state_dirty = True
        if self.kv_block:
            # Failed requests index nothing; their rows must be empty for
            # the next admission, which aliases cached blocks from row 0.
            for slot in range(self.n_slots):
                self._release_blocks(slot)
        for req in reqs:
            self._resolve(req, exc=exc)

    @staticmethod
    def _resolve(
        req: GenRequest,
        result: Optional[GenerationResult] = None,
        exc: Optional[BaseException] = None,
    ) -> None:
        """Resolve the request's future (unless the caller cancelled it)
        and end its stream."""
        try:
            if not req.future.done():
                if exc is not None:
                    req.future.set_exception(exc)
                else:
                    req.future.set_result(result)
        except InvalidStateError:  # the caller cancelled concurrently
            pass
        req.stream.put(None)

    # -- lifecycle reap ---------------------------------------------------

    @staticmethod
    def _reap_reason(req: GenRequest) -> Optional[str]:
        """The one retirement predicate of the lifecycle: "cancelled",
        "deadline" or None."""
        if req.cancel.cancelled or req.future.cancelled():
            return "cancelled"
        if req.deadline is not None and req.deadline.expired():
            return "deadline"
        return None

    def _reap_request(self, req: GenRequest, slot: int = -1) -> bool:
        """Retire ``req`` if it was cancelled or its deadline expired: its
        future gets the terminal error, its stream the sentinel, and
        ``slot`` (when >= 0) is released with its KV blocks."""
        reason = self._reap_reason(req)
        if reason is None:
            return False
        if reason == "deadline":
            exc: BaseException = ErrorDeadlineExceeded(
                f"after {len(req.token_ids)} generated token(s)"
            )
        else:
            exc = ErrorRequestCancelled()
        self._resolve(req, exc=exc)
        if slot >= 0:
            self._release_slot(slot)
        self.reap_counts[reason] += 1
        if self._metrics is not None:
            self._metrics.increment_counter(
                "app_tpu_deadline_exceeded_total" if reason == "deadline"
                else "app_tpu_requests_cancelled_total",
                "model", self.model_name,
            )
        if self._logger is not None:
            self._logger.debugf(
                "retired request (%s) after %d token(s)",
                reason, len(req.token_ids),
            )
        return True

    def _reap_lifecycle(self) -> None:
        """Every live request the caller may have abandoned: active slots,
        slots mid-prefill and requests waiting for KV blocks. Queued
        requests are checked when admission pops them."""
        for i, req in enumerate(self._slots):
            if req is not None:
                self._reap_request(req, slot=i)
        for slot, st in list(self._prefilling.items()):
            self._reap_request(st.request, slot=slot)
        if self._backlog and any(
            self._reap_reason(r) is not None for r in self._backlog
        ):
            kept = [r for r in self._backlog if not self._reap_request(r)]
            self._backlog.clear()
            self._backlog.extend(kept)

    def _release_slot(self, slot: int) -> None:
        """Free a slot and (pool) drop its block references, indexing the
        full prompt blocks of a request that finished its prefill in the
        radix cache first (a slot mid-prefill holds no request in
        ``_slots``, so its blocks are never indexed)."""
        req = self._slots[slot]
        self._slots[slot] = None
        self._prefilling.pop(slot, None)
        self._slot_state_dirty = True
        if self.kv_block:
            adopted: set[int] = set()
            if self._radix is not None and req is not None:
                adopted = self._cache_prompt_blocks(req, slot)
            self._release_blocks(slot, adopted)
            if self._metrics is not None:
                self._metrics.set_gauge(
                    "app_tpu_kv_blocks_free", self._allocator.n_free,
                    "model", self.model_name,
                )
                self._publish_prefix_gauge()

    # -- admission ----------------------------------------------------------

    def _admit(self) -> None:
        free = [
            i for i, s in enumerate(self._slots)
            if s is None and i not in self._prefilling
        ]
        while free:
            req = self._backlog.popleft() if self._backlog else self._pop_pending()
            if req is None:
                return
            # A request cancelled or expired while queued never takes a
            # slot.
            if self._reap_request(req):
                continue
            if req.aid and req.lora_gen != self._lora_gen[req.aid]:
                # The adapter slot was reloaded or unloaded while the
                # request was queued: admitting it would run weights the
                # caller never asked for.
                self._reject_stale(req, "queued")
                continue
            # Clamp the budget so the windows in flight past the last
            # token still land inside the cache (below the parking row).
            ids = req.prompt_ids
            room = (
                self.max_len - 1 - len(ids)
                - (self.pipeline_depth + 1) * self.window_k
                * (self.spec_tokens + 1)
            )
            req.max_new_tokens = max(1, min(req.max_new_tokens, room))
            cached_done = 0
            if self.kv_block:
                B = self.kv_block
                need = (min(len(ids) + 1, self.max_len) + B - 1) // B
                if need > self.cache.n_blocks - 1:
                    self._resolve(req, exc=RuntimeError(
                        f"prompt needs {need} KV blocks but the pool "
                        f"has {self.cache.n_blocks - 1}; raise "
                        f"TPU_KV_POOL_BLOCKS"
                    ))
                    continue
                # The prefix cache: alias the longest cached full-block
                # prefix into the slot's table and prefill the rest.
                cached_done = self._alias_prefix_blocks(free[0], req)
                # Cover the prompt and the first decode token now; windows
                # top up before they run. A dry pool holds the request at
                # the head of the queue until retirements refill it, and
                # drops any aliased references (the row must be empty).
                if not self._ensure_blocks(free[0], len(ids) + 1):
                    self._release_blocks(free[0])
                    self._backlog.appendleft(req)
                    self.kv_admission_waits += 1
                    return
                self._dispatched_tokens[free[0]] = 0
            slot = free.pop(0)
            self._seeds_host[slot] = req.seed
            self._aids_host[slot] = req.aid
            self._bidx_host[slot, :] = -1
            self._bval_host[slot, :] = 0.0
            for j, (tok, val) in enumerate(req.logit_bias.items()):
                self._bidx_host[slot, j] = tok
                self._bval_host[slot, j] = val
            self._seeds_dirty = True
            # The aliased blocks hold positions [0, done); done < the
            # prompt's length, so the last chunk still runs and samples
            # the first token.
            state = self._prefilling[slot] = _Prefill(request=req, done=cached_done)
            if self._prefix_pool is not None and not req.prefix_store:
                idx, plen = self._prefix_pool.lookup(ids, req.aid)
                if idx >= 0:
                    # Copy the pooled rows in and prefill the remainder
                    # (rewriting the boundary position is idempotent).
                    self._prefix_pool.load(self.cache, idx, slot, plen)
                    state.done = min(plen, len(ids) - 1)
                    if self._metrics is not None:
                        self._metrics.increment_counter(
                            "app_tpu_prefix_hits", "model", self.model_name
                        )
            if req.aid and req.lora_gen != self._lora_gen[req.aid]:
                # A load or unload raced this admission (its generation
                # bump after the check above, its failure snapshot before
                # the request showed in _prefilling): surrender the slot
                # and any aliased blocks holding the old weights' K/V, and
                # fail the request as at the queue.
                del self._prefilling[slot]
                if self.kv_block:
                    self._release_blocks(slot)
                free.insert(0, slot)
                self._reject_stale(req, "being admitted")
                continue
            if cached_done:
                # Counted once admission is certain: a dry-pool deferral
                # walks the index again when the request is readmitted.
                self._prefix_hit_tokens += cached_done
                if self._metrics is not None:
                    self._metrics.add_counter(
                        "app_tpu_prefix_hit_tokens_total", cached_done,
                        "model", self.model_name,
                    )

    def _reject_stale(self, req: GenRequest, when: str) -> None:
        """Retire a request whose adapter slot was reloaded or unloaded
        since it was stamped: a prefix registration resolves -1 (its
        stale-store outcome), a generate request fails."""
        if req.prefix_store:
            self._resolve(req, result=-1)
            return
        self._resolve(req, exc=RuntimeError(
            f"LoRA adapter slot {req.aid} was reloaded or unloaded while "
            f"this request was {when}; resubmit against the current adapter set"
        ))

    def _publish_prefix_gauge(self) -> None:
        """``app_tpu_prefix_cached_blocks``, after any path that grows or
        shrinks the radix index."""
        if self._metrics is not None and self._radix is not None:
            self._metrics.set_gauge(
                "app_tpu_prefix_cached_blocks", self._radix.n_cached_blocks,
                "model", self.model_name,
            )

    def _alloc_block(self) -> Optional[int]:
        """One free pool block, evicting an unreferenced cached block (LRU)
        when the free list is dry: cached prefixes never starve live
        requests."""
        bid = self._allocator.alloc()
        if bid is None and self._radix is not None and self._radix.evict(1):
            bid = self._allocator.alloc()
            self._publish_prefix_gauge()
        return bid

    def _ensure_blocks(self, slot: int, tokens: int) -> bool:
        """Grow ``slot``'s allocation to cover ``tokens`` logical tokens.
        False when the pool is dry, with any partial grab rolled back. A
        shortfall first evicts cached blocks in one batch."""
        B = self.kv_block
        target = min((min(tokens, self.max_len) + B - 1) // B,
                     self._table_host.shape[1])
        row = self._slot_blocks[slot]
        start_len = len(row)
        shortfall = (target - start_len) - self._allocator.n_free
        if shortfall > 0 and self._radix is not None and self._radix.evict(shortfall):
            self._publish_prefix_gauge()
        while len(row) < target:
            blk = self._alloc_block()
            if blk is None:
                while len(row) > start_len:  # roll back the partial grab
                    self._table_host[slot, len(row) - 1] = 0
                    self._allocator.decref(row.pop())
                return False
            self._table_host[slot, len(row)] = blk
            row.append(blk)
            self._table_dirty = True
        self.kv_blocks_peak = max(self.kv_blocks_peak, self.kv_pool_counts()[1])
        if self._metrics is not None and len(row) != start_len:
            self._metrics.set_gauge(
                "app_tpu_kv_blocks_free", self._allocator.n_free,
                "model", self.model_name,
            )
        return True

    def _release_blocks(self, slot: int, adopted: frozenset | set = frozenset()) -> None:
        """Drop ``slot``'s references on its table row, skipping the blocks
        whose reference the radix index just adopted, and clear the row.
        Blocks still aliased by other slots or cached survive."""
        row = self._slot_blocks[slot]
        if row:
            for blk in row:
                if blk not in adopted:
                    self._allocator.decref(blk)
            self._slot_blocks[slot] = []
            self._table_host[slot, :] = 0
            self._table_dirty = True
        self._dispatched_tokens[slot] = 0

    def _cache_prompt_blocks(self, req: GenRequest, slot: int) -> set[int]:
        """Index a retiring request's full prompt blocks in the radix cache
        instead of freeing them. Only blocks the prompt covers wholly
        qualify (the boundary and decode blocks hold generated tokens), and
        only for a completed prefill. Returns the blocks whose reference
        the index adopted."""
        if req.prefix_store or req.effective_prompt_len <= 0:
            return set()
        if req.aid and req.lora_gen != self._lora_gen[req.aid]:
            # The adapter slot was reloaded since admission: these blocks
            # hold K/V of superseded weights.
            return set()
        row = self._slot_blocks[slot]
        n_full = min(len(req.prompt_ids) // self.kv_block, len(row))
        if n_full <= 0:
            return set()
        flags = self._radix.insert(req.prompt_ids, row[:n_full], req.aid)
        if req.aid and req.lora_gen != self._lora_gen[req.aid]:
            # A load or unload raced this insert (its bump after the check
            # above, its purge maybe before the insert). The bump always
            # precedes the purge, so this re-check catches every
            # interleaving: purge the slot again. The purge consumes the
            # index's reference for adopted blocks (the caller still skips
            # them) and the incumbent's for duplicates.
            self._radix.purge_aid(req.aid)
        return {row[j] for j, f in enumerate(flags) if f}

    def _alias_prefix_blocks(self, slot: int, req: GenRequest) -> int:
        """Admission's zero-copy prefix hit: alias the longest cached
        full-block prefix of the prompt into ``slot``'s (empty) table row
        and return the prompt tokens the prefill may skip. The lookup's
        references move to the row. When the hit covers the whole prompt,
        the last chunk rewrites the last prompt position, so the boundary
        block is copied on write and the row points at the copy (a slot
        never writes a block with refcount > 1); with no block free for
        the copy, the last aliased block is surrendered instead."""
        radix = self._radix
        if radix is None or req.prefix_store:
            return 0
        ids = req.prompt_ids
        blocks, matched = radix.lookup(ids, req.aid)
        self._prefix_lookups += 1
        if self._metrics is not None:
            self._metrics.increment_counter(
                "app_tpu_prefix_lookup_total", "model", self.model_name,
                "result", "hit" if blocks else "miss",
            )
        if not blocks:
            return 0
        B, width = self.kv_block, self._table_host.shape[1]
        for bid in blocks[width:]:
            self._allocator.decref(bid)  # beyond the table's width
        blocks = blocks[:width]
        matched = len(blocks) * B
        done = min(matched, len(ids) - 1)
        row = self._slot_blocks[slot]
        for j, bid in enumerate(blocks):
            self._table_host[slot, j] = bid
            row.append(bid)
        self._table_dirty = True
        if done < matched:
            src = row[-1]
            dst = self._alloc_block()
            if dst is None:
                row.pop()
                self._table_host[slot, len(row)] = 0
                self._allocator.decref(src)
                done = min(len(row) * B, len(ids) - 1)
            else:
                paged_copy_block(self.cache, src, dst)
                row[-1] = dst
                self._table_host[slot, len(row) - 1] = dst
                self._allocator.decref(src)
        return done

    def _radix_watermark_sweep(self) -> None:
        """Keep ``effective_evict_watermark`` pool blocks free by evicting
        LRU cached blocks once a loop pass, so admission under pressure
        finds free blocks instead of evicting inside its own grow (0 =
        off). After a sweep that found nothing evictable it waits until
        the free count or the cache changes."""
        wm = self.effective_evict_watermark
        if not wm:
            return
        short = wm - self._allocator.n_free
        if short <= 0:
            return
        sig = (self._allocator.n_free, self._radix.n_cached_blocks)
        if sig == self._wm_fruitless:
            return
        if self._radix.evict(short):
            self._wm_fruitless = None
            self._publish_prefix_gauge()
            if self._metrics is not None:
                self._metrics.set_gauge(
                    "app_tpu_kv_blocks_free", self._allocator.n_free,
                    "model", self.model_name,
                )
        else:
            self._wm_fruitless = sig

    def _push_table(self) -> None:
        """Upload the block-table mirror if admission or top-ups changed it."""
        if self.kv_block and self._table_dirty:
            self.cache.block_table.copy_(self._up(self._table_host))
            self._table_dirty = False

    def _up(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device. On the card it goes through
        a pinned staging copy with ``non_blocking``: the host does not wait
        for the device (a pageable copy would wait for every window in
        flight), and PyTorch's pinned-memory cache keeps the staging buffer
        until an event says the copy ran."""
        t = torch.from_numpy(a)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _to_host(self, t: torch.Tensor):
        """Enqueue ``t``'s copy to the host: (its host array, the event
        after the copy). On the CPU the array is a copy made now and the
        event None. The array is valid once the event has passed. On the
        card it lands in fresh pinned memory from PyTorch's caching host
        allocator, which hands a block out again only once it is freed and
        the copy's event has passed; stream order runs the copy before a
        later replay rewrites ``t``."""
        if self.device.type != "cuda":
            return t.numpy().copy(), None
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host.numpy(), event

    # -- device steps -------------------------------------------------------

    def _uses(self, reqs: list[GenRequest]) -> dict[str, bool]:
        """The sampler's host-known switches for a batch of requests: it
        samples when some row is not greedy and adds the logit bias when
        some row has one."""
        return dict(
            sampling=any(r.temperature > 0 for r in reqs),
            use_bias=any(r.logit_bias for r in reqs),
        )

    def _prefill_step(self) -> bool:
        """One prefill dispatch for the slots mid-prefill: a multi-chunk
        dispatch when ``prefill_depth`` > 1 and some row has two full
        chunks left before its last, else one [P, c] chunk step whose
        finalizing rows sample their first token on the device and move
        to decode (the token is emitted when its copy lands). Returns
        whether it dispatched."""
        if not self._prefilling:
            return False
        self._push_table()
        if self._seeds_dirty:
            # Seeds, adapter slots and logit-bias rows change only at
            # admission (before both prefill paths read them).
            self.planes.seeds.copy_(self._up(self._seeds_host))
            self.planes.aids.copy_(self._up(self._aids_host))
            self.planes.bidx.copy_(self._up(self._bidx_host))
            self.planes.bval.copy_(self._up(self._bval_host))
            self._seeds_dirty = False
        self.prefill_steps += 1
        rows = list(self._prefilling.items())[: self.prefill_batch]
        if self.prefill_depth > 1 and self._prefill_multi(rows):
            return True
        P, c = self.prefill_batch, self.prefill_chunk
        tokens = np.zeros((P, c), dtype=np.int64)
        slots = np.zeros((P,), dtype=np.int32)
        starts = np.zeros((P,), dtype=np.int32)
        lens = np.zeros((P,), dtype=np.int32)
        finalize = np.zeros((P,), dtype=bool)
        row_valid = np.zeros((P,), dtype=bool)
        temps = np.ones((P,), dtype=np.float32)
        topps = np.ones((P,), dtype=np.float32)
        greedy = np.ones((P,), dtype=bool)
        for i, (slot, st) in enumerate(rows):
            ids = st.request.prompt_ids
            chunk = ids[st.done: st.done + c]
            tokens[i, : len(chunk)] = chunk
            slots[i], starts[i], lens[i] = slot, st.done, len(chunk)
            finalize[i] = st.done + len(chunk) >= len(ids)
            row_valid[i] = True
            temps[i] = max(st.request.temperature, 0.0)
            topps[i] = st.request.top_p
            greedy[i] = st.request.temperature <= 0
        for i in range(len(rows), P):
            # Padding rows duplicate row 0: identical K/V writes to the
            # same positions, and row_valid=False keeps them out of the
            # finalize merge.
            tokens[i] = tokens[0]
            slots[i], starts[i], lens[i] = slots[0], starts[0], lens[0]
            temps[i], greedy[i], topps[i] = temps[0], greedy[0], topps[0]
        t0 = time.time()
        first, first_lp, top_i, top_l = prefill_chunk_step(
            self.params, self.cache, self.cfg, self.rope, self.planes,
            self.sampler, self._up(tokens), self._up(slots), self._up(starts),
            self._up(lens), self._up(finalize), self._up(row_valid),
            self._up(temps), self._up(greedy), self._up(topps),
            self._base_seed, **self._uses([st.request for _, st in rows]),
            history=bool(self.spec_tokens),
        )
        if self._metrics is not None:
            self._metrics.record_histogram(
                "app_tpu_infer_latency", time.time() - t0, "kind", "prefill"
            )
            self._metrics.record_histogram(
                "app_tpu_batch_size", len(rows), "batcher", "prefill"
            )
        done_rows = []
        for i, (slot, st) in enumerate(rows):
            st.done += int(lens[i])
            if finalize[i]:
                st.request.effective_prompt_len = st.done
                del self._prefilling[slot]
                stale = (st.request.aid
                         and st.request.lora_gen != self._lora_gen[st.request.aid])
                if st.request.prefix_store:
                    # Park the rows in the prefix pool (a copy queued after
                    # this chunk); the slot goes straight back to the free
                    # list and the future gets the pool row. A prefix whose
                    # adapter was reloaded or unloaded while it prefilled
                    # ran the wrong weights: dropped, -1.
                    idx = -1 if stale else self._prefix_pool.store(
                        st.request.prompt_ids, self.cache, slot, st.request.aid)
                    self._resolve(st.request, result=idx)
                elif stale:
                    # A generate request whose adapter slot was reloaded
                    # after admission must not start decoding.
                    self._resolve(st.request, exc=RuntimeError(
                        f"LoRA adapter slot {st.request.aid} was "
                        "reloaded while this request was prefilling; "
                        "resubmit against the current adapter set"
                    ))
                    self._release_slot(slot)
                else:
                    done_rows.append((i, slot, st.request))
        if done_rows:
            # The first tokens were sampled on the device with the chunk;
            # their copy to the host (with logprob and alternatives, one
            # transfer) is enqueued now and they are emitted when it lands
            # (_flush_prefill_emits), before any window's tokens.
            parts = [first.float()[:, None], first_lp[:, None]]
            if top_i is not None:
                parts += [top_i.float(), top_l]
            host, event = self._to_host(torch.cat(parts, dim=1))
            for i, slot, req in done_rows:
                self._slots[slot] = req
                self._slot_state_dirty = True
                self._tokens_in_flight[slot] = 1
                self._prefill_emits.append((host, event, i, slot, req))
        self._publish_step_metrics()
        return True

    def _prefill_multi(self, rows: list) -> bool:
        """The reference's multi-chunk branch: rows with at least two full
        chunks before their last one take ``d`` = min(their chunks left,
        ``prefill_depth``) chunks in one dispatch (no sampling, no length
        update; the last chunk always takes the single-chunk step). Only
        these deep rows join: a short prompt admitted beside a long one
        must not turn the dispatch off for it. Returns whether it
        dispatched."""
        P, c = self.prefill_batch, self.prefill_chunk
        deep = [
            (slot, st, rem)
            for slot, st in rows
            for rem in [(len(st.request.prompt_ids) - st.done - 1) // c]
            if rem >= 2
        ]
        if not deep:
            return False
        d = min(min(rem for _, _, rem in deep), self.prefill_depth)
        tokens3 = np.zeros((d, P, c), dtype=np.int64)
        slots = np.zeros((P,), dtype=np.int32)
        starts = np.zeros((P,), dtype=np.int32)
        for i, (slot, st, _) in enumerate(deep):
            ids = st.request.prompt_ids
            for j in range(d):
                lo = st.done + j * c
                tokens3[j, i, :] = ids[lo: lo + c]
            slots[i], starts[i] = slot, st.done
        for i in range(len(deep), P):  # padding rows duplicate row 0
            tokens3[:, i, :] = tokens3[:, 0, :]
            slots[i], starts[i] = slots[0], starts[0]
        t0 = time.time()
        prefill_multi_chunk(self.params, self.cache, self.cfg, self.rope,
                            self._up(tokens3), self._up(slots), self._up(starts),
                            self.planes.history if self.spec_tokens else None,
                            self.planes.aids)
        for _, st, _ in deep:
            st.done += d * c
        if self._metrics is not None:
            self._metrics.record_histogram(
                "app_tpu_infer_latency", time.time() - t0, "kind", "prefill_multi"
            )
        self._publish_step_metrics()
        return True

    def _flush_prefill_emits(self) -> None:
        """Emit each finished prompt's first token whose copy to the host
        has landed (an event poll; no wait), in dispatch order. A request
        reaped meanwhile retires instead."""
        if not self._prefill_emits:
            return
        keep = []
        T = self.top_logprobs
        for entry in self._prefill_emits:
            host, event, row, slot, req = entry
            if req.future.done() or req.token_ids:
                continue
            if self._reap_request(req, slot=slot if self._slots[slot] is req else -1):
                continue
            if event is not None and not event.query():
                keep.append(entry)
                continue
            top = None
            if req.top_logprobs:
                top = [(int(host[row, 2 + j]), float(host[row, 2 + T + j]))
                       for j in range(req.top_logprobs)]
            self._emit(slot, req, int(host[row, 0]), float(host[row, 1]), top)
        self._prefill_emits = keep

    def _publish_step_metrics(self) -> None:
        """Once per prefill dispatch or processed decode window: the tokens
        emitted since the last call, and the slot, queue and pool
        gauges."""
        m = self._metrics
        if m is None:
            return
        if self._unpublished_tokens:
            m.add_counter("app_tpu_tokens_generated", self._unpublished_tokens,
                          "model", self.model_name)
            self._unpublished_tokens = 0
        in_use = sum(1 for s in self._slots if s is not None)
        m.set_gauge("app_tpu_kv_slots_in_use", in_use, "model", self.model_name)
        m.set_gauge("app_tpu_queue_depth", self._pending.qsize(), "batcher", "generate")
        m.set_gauge("app_tpu_hbm_headroom_ratio", self.hbm_headroom_ratio(),
                    "model", self.model_name)
        if self.kv_block:
            total, used, _ = self.kv_pool_counts()
            m.set_gauge("app_tpu_kv_pool_occupancy_ratio", used / max(1, total),
                        "model", self.model_name)

    def _window_eager(self, sampling: bool, use_bias: bool) -> torch.Tensor:
        if self.spec_tokens:
            return spec_window(
                self.params, self.cache, self.cfg, self.rope, self.planes,
                self.sampler, self.window_k, self.spec_tokens, self._base_seed,
                sampling=sampling, use_bias=use_bias,
            )
        return decode_window(
            self.params, self.cache, self.cfg, self.rope, self.planes,
            self.sampler, self.window_k, self._base_seed,
            sampling=sampling, use_bias=use_bias,
        )

    def _mega_step(self, sampling: bool, use_bias: bool) -> None:
        mega_step(
            self.params, self.cache, self.cfg, self.rope, self.planes,
            self.sampler, self.window_k, self.mega_windows, self._base_seed,
            self.tokenizer.eos_id, self._mega, sampling=sampling, use_bias=use_bias,
            spec_tokens=self.spec_tokens,
        )

    def _refresh_slot_state(self) -> None:
        """Upload the [n_slots] request planes once the slots' composition
        changed; a steady-state window uploads nothing."""
        if not self._slot_state_dirty:
            return
        active = np.zeros((self.n_slots,), dtype=bool)
        temps = np.ones((self.n_slots,), dtype=np.float32)
        topps = np.ones((self.n_slots,), dtype=np.float32)
        greedy = np.ones((self.n_slots,), dtype=bool)
        fpen = np.zeros((self.n_slots,), dtype=np.float32)
        ppen = np.zeros((self.n_slots,), dtype=np.float32)
        for i, req in enumerate(self._slots):
            if req is not None:
                active[i] = True
                temps[i] = max(req.temperature, 0.0)
                topps[i] = req.top_p
                greedy[i] = req.temperature <= 0
                fpen[i] = req.frequency_penalty
                ppen[i] = req.presence_penalty
        self.planes.active.copy_(self._up(active))
        self.planes.temps.copy_(self._up(temps))
        self.planes.topps.copy_(self._up(topps))
        self.planes.greedy.copy_(self._up(greedy))
        self.planes.fpen.copy_(self._up(fpen))
        self.planes.ppen.copy_(self._up(ppen))
        self._slot_state_dirty = False

    def _dispatch_window(self) -> Optional[_Window]:
        """Dispatch one k-step window (with ``mega_windows`` > 1, one mega
        window) without waiting for it, and enqueue its block's copy to
        the host; None when a dry block pool failed every live request
        and nothing is left to dispatch. The returned snapshot of the
        slots matters: by processing time a retired slot may hold a new
        request."""
        k, mega = self.window_k, self.mega_windows
        remaining = eos_stop = None
        if mega > 1:
            # Each slot's tokens not yet covered, for the device's exit:
            # it runs windows until every slot's is covered or its EOS
            # came (where the request stops on EOS), at most mega.
            remaining = np.zeros((self.n_slots,), dtype=np.int64)
            eos_stop = np.zeros((self.n_slots,), dtype=bool)
            for i, req in enumerate(self._slots):
                if req is not None:
                    remaining[i] = max(0, req.max_new_tokens - self._tokens_in_flight[i])
                    eos_stop[i] = req.stop_on_eos
        if self.kv_block:
            # Allocation stays ahead of the windows in flight (their writes
            # land before the host sees their tokens): a window writes
            # k·(G+1) positions (a speculative step writes every
            # candidate's K/V); a slot's real writes in a mega window
            # cover its remaining tokens in at most ceil(remaining / k)
            # windows (a window produces at least k), and its junk past
            # them parks in block 0. A dry pool mid-stream fails the
            # request: the honest outcome of an oversubscribed pool.
            step_tokens = k * (self.spec_tokens + 1)
            for i, req in enumerate(self._slots):
                if req is None:
                    continue
                wt = (step_tokens if mega <= 1
                      else min(mega, -(-int(remaining[i]) // k)) * step_tokens)
                need = len(req.prompt_ids) + self._dispatched_tokens[i] + wt + 1
                if self._ensure_blocks(i, need):
                    self._dispatched_tokens[i] += wt
                    continue
                self._resolve(req, exc=RuntimeError(
                    "KV block pool exhausted mid-generation "
                    "(raise TPU_KV_POOL_BLOCKS or lower concurrency)"
                ))
                self._release_slot(i)
                if mega > 1:
                    remaining[i], eos_stop[i] = 0, False
            self._push_table()
            if all(s is None for s in self._slots):
                self._publish_step_metrics()
                return None  # the dry pool failed every live request
        # The tokens the windows are sure to produce (a speculative step
        # produces at least one).
        for i, req in enumerate(self._slots):
            if req is not None:
                self._tokens_in_flight[i] += (
                    min(k * mega, int(remaining[i])) if mega > 1 else k
                )
        self._refresh_slot_state()
        use = self._uses([r for r in self._slots if r is not None])
        t0 = time.time()
        if mega > 1:
            state = self._mega
            state.remaining.copy_(self._up(remaining))
            state.eos_stop.copy_(self._up(eos_stop))
            record = None
            if self._graphs is not None:
                record = self._graphs.mega(**use)
            else:
                mega_window(
                    self.params, self.cache, self.cfg, self.rope, self.planes,
                    self.sampler, k, mega, self._base_seed, self.tokenizer.eos_id,
                    state, spec_tokens=self.spec_tokens, **use,
                )
            self.mega_dispatches += 1
            host, _ = self._to_host(state.emitted)
            wrun, event = self._to_host(state.w)
            return _Window(host, event, list(self._slots), t0, wrun, record)
        if self._graphs is not None:
            emitted = self._graphs.window(**use)
        else:
            emitted = self._window_eager(**use)
        self.decode_windows += 1
        host, event = self._to_host(emitted)
        return _Window(host, event, list(self._slots), t0)

    def _process_window(self, win: _Window) -> None:
        """Wait for a window's block (the loop's one host wait on the
        device), then emit its tokens to the requests of its snapshot that
        are still live. While a mega window runs, the host keeps admitting
        and prefilling (the chunks queue behind it on the stream) and
        emits first tokens that land."""
        t_fetch = time.time()
        lockcheck.note_device_sync("decode_window_fetch")
        if win.event is not None:
            if self._prefill_emits or win.wrun is not None:
                while not win.event.query():
                    if win.wrun is not None:
                        self._admit()
                        self._prefill_step()
                    self._flush_prefill_emits()
                    time.sleep(0.001)  # a readiness poll, not a delay
            win.event.synchronize()
        steps = self.window_k
        if win.wrun is not None:
            n = int(win.wrun)
            steps = n * self.window_k
            self.decode_windows += n
            self.windows_run.append(n)
            if win.record is not None:
                replayed(win.record, n)
        if self._metrics is not None:
            # decode_fetch: the host's blocking wait (what pipelining
            # hides); decode_window_pipeline: dispatch to processed, with
            # pipeline_depth windows queued (not one window's latency).
            now = time.time()
            self._metrics.record_histogram(
                "app_tpu_infer_latency", now - t_fetch, "kind", "decode_fetch"
            )
            self._metrics.record_histogram(
                "app_tpu_infer_latency", now - win.t0, "kind", "decode_window_pipeline"
            )
            if steps:
                self._metrics.set_gauge(
                    "app_tpu_decode_step_seconds", (now - win.t0) / steps,
                    "model", self.model_name,
                )
        # First tokens copied before this window landed before it.
        self._flush_prefill_emits()
        host, T, G = win.host, self.top_logprobs, self.spec_tokens
        for i, req in enumerate(win.snapshot):
            if req is None:
                continue
            if req.future.done():
                # Retired by an earlier window (its tokens here overshoot),
                # cancelled by the caller mid-flight or failed by an
                # adapter reload: free the slot if it still holds the
                # request.
                if self._slots[i] is req and not self._reap_request(req, slot=i):
                    self._release_slot(i)
                continue
            if G:
                # Each step's first counts tokens, in order, up to the
                # first that finishes the request.
                toks = ((host[j, step, i], host[G + 1 + j, step, i])
                        for step in range(steps)
                        for j in range(int(host[2 * G + 2, step, i])))
                for tok, lp in toks:
                    if self._emit(i, req, int(tok), float(lp)):
                        break
                continue
            for step in range(steps):
                top = None
                if req.top_logprobs:
                    top = [(int(host[2 + j, step, i]), float(host[2 + T + j, step, i]))
                           for j in range(req.top_logprobs)]
                if self._emit(i, req, int(host[0, step, i]), float(host[1, step, i]), top):
                    break
        if G and self._metrics is not None:
            # Acceptance: tokens a live step produced (1 = no draft
            # accepted, G+1 = all), averaged over the window.
            counts = host[2 * G + 2, :steps]
            live = counts > 0
            if live.any():
                self._metrics.record_histogram(
                    "app_tpu_spec_tokens_per_step", float(counts[live].mean()),
                    "model", self.model_name,
                )
        self._publish_step_metrics()

    # -- emission and retirement -------------------------------------------

    def _emit(
        self,
        slot: int,
        req: GenRequest,
        tok: int,
        logprob: float,
        top: Optional[list[tuple[int, float]]] = None,
    ) -> bool:
        """Deliver one token; retire the request (and free its slot) when
        it is finished. Returns True on retirement."""
        now = time.time()
        if not req.token_ids:
            req.ttft_s = now - req.enqueued_at
        if req.top_logprobs:
            req.token_top_logprobs.append(top)
        req.token_ids.append(tok)
        req.token_logprobs.append(logprob)
        req.token_times.append(now)
        req.stream.put(tok)
        # Every emission of every slot feeds the aggregate rate behind
        # projected-wait shedding.
        self._tput.note(1)
        self._unpublished_tokens += 1
        if not self._finished(req):
            return False
        self._retire(slot, req)
        return True

    def _finished(self, req: GenRequest) -> bool:
        eos = self.tokenizer.eos_id
        if req.stop_on_eos and req.token_ids[-1] == eos:
            return True
        if req.stop_texts:
            text = self.tokenizer.decode(req.token_ids)
            at = min(
                (p for p in (text.find(s) for s in req.stop_texts) if p != -1),
                default=-1,
            )
            if at != -1:
                req.stop_cut = at
                return True
        if len(req.token_ids) >= req.max_new_tokens:
            return True
        return len(req.prompt_ids) + len(req.token_ids) >= self.max_len - 1

    def _retire(self, slot: int, req: GenRequest) -> None:
        text = self.tokenizer.decode(req.token_ids)
        ids, lps = list(req.token_ids), list(req.token_logprobs)
        tops = list(req.token_top_logprobs) if req.top_logprobs else None
        if req.stop_cut >= 0:
            # Stop sequence: cut the text at the match and the ids,
            # logprobs and alternatives to the longest prefix whose decode
            # fits the kept text, so they stay aligned.
            text = text[: req.stop_cut]
            keep = 0
            for i in range(1, len(ids) + 1):
                if len(self.tokenizer.decode(ids[:i])) <= req.stop_cut:
                    keep = i
                else:
                    break
            ids, lps = ids[:keep], lps[:keep]
            if tops is not None:
                tops = tops[:keep]
            reason = "stop"
        elif req.stop_on_eos and ids and ids[-1] == self.tokenizer.eos_id:
            reason = "stop"
        else:
            reason = "length"  # token budget or context window exhausted
        result = GenerationResult(
            text=text,
            token_ids=ids,
            prompt_tokens=len(req.prompt_ids),
            ttft_s=req.ttft_s,
            duration_s=time.time() - req.enqueued_at,
            truncated=req.truncated,
            token_logprobs=lps,
            finish_reason=reason,
            token_top_logprobs=tops,
        )
        self._release_slot(slot)
        self._resolve(req, result=result)
