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

On the card the decode programs run as CUDA graphs captured per static
variant when the scheduler starts (``programs.DecodeGraphs``), host
arrays go up through pinned staging buffers without a wait, and each
window's block comes down into pinned memory behind an event: the only
host wait of a steady-state window is that event.

Served: bf16 (or f32) weights, the slot cache or the paged block pool
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
import os
import queue
import random
import threading
import time
import traceback
from concurrent.futures import InvalidStateError
from dataclasses import dataclass
from typing import Any, AsyncIterator, Optional

import numpy as np
import torch

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
from gofr_tpu_torch.models.transformer import check_supported, init_params, rope_tables
from gofr_tpu_torch.ops.cuda import replayed
from gofr_tpu_torch.ops.kv_cache import BlockAllocator, KVCache, PagedKVCache
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
)
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer
from gofr_tpu_torch.serving.types import LOGIT_BIAS_K, GenerationResult, GenRequest

# Reference options this slice accepts only at their neutral value, each
# with the ROADMAP item that ports it.
_OPS_PLANE = "ROADMAP Queue 1 item 7: the operations plane"
_NEUTRAL_SUBMIT_OPTIONS = {
    "adapter": ("", "ROADMAP Queue 1 item 6: LoRA adapters"),
    "pin_replica": (False, _OPS_PLANE + " (the replica pool)"),
}

# TPU_* keys the reference's from_config and backend read and the port
# does not serve yet: (key, the reference's default, ROADMAP item). Set to
# anything else, each raises NotImplementedError naming its item.
_LOADERS = "ROADMAP Queue 1 item 6: loaders and device services"
_SPEC = "ROADMAP Queue 1 item 3: exact-verify speculative decoding"
_PREFIX = "ROADMAP Queue 1 item 4: the prefix cache"
_ENCODERS = "ROADMAP Queue 1 item 5: the encoder families"
_MULTI = "ROADMAP Queue 1 item 8: multi-device"
_UNPORTED_KEYS = (
    ("TPU_CHECKPOINT", "", _LOADERS), ("TPU_QUANT", "", _LOADERS),
    ("TPU_TOKENIZER", "", _LOADERS), ("TPU_HBM_BYTES", "0", _LOADERS),
    ("TPU_ADMIT_MIN_HEADROOM", "0", _LOADERS),
    ("TPU_COMPILE_CACHE_DIR", "", _LOADERS),
    ("TPU_LORA_SLOTS", "0", _LOADERS), ("TPU_LORA_RANK", "16", _LOADERS),
    ("TPU_LORA_TARGETS", "wq,wk,wv,wo", _LOADERS),
    ("TPU_LORA_ADAPTERS", "", _LOADERS),
    ("TPU_TP", "1", _MULTI), ("TPU_MESH_TP", "1", _MULTI),
    ("TPU_MESH_CP", "1", _MULTI),
    ("TPU_AUTO_PREFIX", "false", _PREFIX), ("TPU_PREFIX_SLOTS", "0", _PREFIX),
    ("TPU_PREFIX_CACHE_BLOCKS", "0", _PREFIX),
    ("TPU_PREFIX_EVICT_WM", "0", _PREFIX),
    ("TPU_PREFIX_EVICT_HBM_FRAC", "0", _PREFIX),
    ("TPU_QUEUE_PREFIX_AWARE", "0", _PREFIX),
    ("TPU_EMBED_CHECKPOINT", "", _ENCODERS), ("TPU_EMBED_TOKENIZER", "", _ENCODERS),
    ("TPU_MAX_BATCH", "8", _OPS_PLANE), ("TPU_BATCH_WAIT_MS", "5", _OPS_PLANE),
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
    than the reference's default. ``TPU_SPEC_TOKENS`` may be ``auto``
    (the reference's default, which means off here) or 0."""
    for key, default, item in _UNPORTED_KEYS:
        raw = config.get(key)
        if raw is not None and raw != "" and not _is_default(raw, default):
            raise NotImplementedError(
                f"{key}={raw!r} is not ported yet ({item}); the port serves "
                f"it only at the reference's default {default!r}"
            )
    spec = config.get_or_default("TPU_SPEC_TOKENS", "auto").strip().lower()
    if spec != "auto" and not _is_default(spec, "0"):
        raise NotImplementedError(
            f"TPU_SPEC_TOKENS={spec!r} is not ported yet ({_SPEC}); "
            "the port serves auto (off) or 0"
        )
    keys = set(os.environ)
    keys.update(getattr(config, "_values", None) or ())
    tenant_slo = sorted(k for k in keys if k.startswith(_SLO_TENANT_PREFIX))
    if tenant_slo:
        raise NotImplementedError(
            f"{tenant_slo[0]} is set; per-tenant SLOs are not ported yet "
            f"({_OPS_PLANE})"
        )


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


class InferenceEngine:
    """One loaded model and its serving loop.

    ``device`` defaults to CUDA (raises without it); pass ``"cpu"`` to run
    the plain versions of the kernels on the host. ``params`` is a port
    parameter dict (``weights.params_from_jax`` / ``init_params``) on that
    device; without it weights are made from ``seed`` on the device.

    The decode loop, as the reference's: ``pipeline_depth`` windows in
    flight (at least 1), ``mega_windows`` k-step windows a dispatch (0 or
    1 = one), ``prefill_depth`` full chunks a multi-chunk prefill dispatch
    (1 = off).

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
        queue_max: int = 1024,
        queue_max_tokens: int = 0,
        class_promote_s: float = 5.0,
        tenant_queue_max: int = 0,
        tenant_slo_class: str = "",
        expected_tps: float = 0.0,
        tokenizer: Any = None,
        params: Optional[dict] = None,
        seed: int = 0,
        device: Any = None,
        logger: Any = None,
        metrics: Any = None,
        **unsupported: Any,
    ) -> None:
        if "auto_prefix" in unsupported:
            raise NotImplementedError(
                "auto_prefix (the radix prefix cache over the block pool) is "
                "not ported yet (ROADMAP Queue 1 item 4)"
            )
        if unsupported:
            raise NotImplementedError(
                "engine options outside this slice of the torch port: "
                f"{sorted(unsupported)} (ROADMAP: the rest of the serving "
                "features)"
            )
        for name, val in (("n_slots", n_slots), ("window_k", window_k),
                          ("prefill_chunk", prefill_chunk),
                          ("prefill_batch", prefill_batch)):
            if int(val) < 1:
                raise ValueError(f"{name} must be >= 1, got {val}")
        # The cache never outgrows the model's context (the reference's
        # clamp).
        max_len = min(int(max_len), get_model(model_name).config.max_len)
        reserve = 1 + (max(1, int(pipeline_depth)) + 1) * int(window_k)
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
        self.device = resolve_device(device)
        if kv_block % 16 and self.device.type == "cuda":
            raise ValueError(
                f"the CUDA kernels take kv_block a multiple of 16, got {kv_block}"
            )
        self.model_name = model_name
        self.spec = get_model(model_name)
        self.cfg = self.spec.config
        check_supported(self.cfg)
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

        if params is None:
            params = init_params(self.cfg, self._seed, self.device)
        for name, t in params.items():
            if t.device != self.device:
                raise ValueError(
                    f"param {name} is on {t.device}, engine device is "
                    f"{self.device}"
                )
        self.params = params
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
        self.rope = rope_tables(cfg, self.max_len, self.device)
        self.planes = SlotPlanes.create(
            self.n_slots, self.device, cfg.vocab_size, self.sampler
        )
        # The mega window's fixed device buffers, and on the card the
        # captured decode programs (made when the scheduler starts).
        self._mega = (
            MegaState.create(self.n_slots, self.window_k, self.mega_windows,
                             self.top_logprobs, self.device)
            if self.mega_windows > 1 else None
        )
        self._graphs: Optional[DecodeGraphs] = None

        # Host-side scheduler state (scheduler thread only).
        self._slots: list[Optional[GenRequest]] = [None] * self.n_slots
        self._prefilling: dict[int, _Prefill] = {}
        self._seeds_host = np.zeros((self.n_slots,), dtype=np.int64)
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

        # Admission control (guarded by self._lock): the class-priority
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
        self._pending = ClassPriorityQueue(
            maxsize=self.queue_max, promote_after_s=self.class_promote_s
        )
        # Submit-time sheds and lifecycle reaps, by reason (the
        # reference's app_tpu_requests_shed_total{reason} and its
        # deadline-exceeded / cancelled counters).
        self.shed_counts: collections.Counter[str] = collections.Counter()
        self.reap_counts: collections.Counter[str] = collections.Counter()
        self._work = threading.Event()
        # Requests taken off the queue that wait for KV blocks (loop only).
        self._backlog: "collections.deque[GenRequest]" = collections.deque()
        self._logger = logger
        self._metrics = metrics
        # Lifecycle flags (written under self._lock): running, draining
        # for a graceful stop (submits get 503), and the error that killed
        # the scheduler. The scheduler sets _idle_evt once a drain finds
        # no work left.
        self._lock = threading.Lock()
        self._running = False
        self._draining = False
        self._error: Optional[BaseException] = None
        self._idle_evt = threading.Event()
        self._state = "DOWN"
        self._thread: Optional[threading.Thread] = None
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
        """``(total, used, cached)`` blocks of the paged pool: allocatable
        blocks (block 0 parks), blocks held by live tables, and 0 (no
        radix cache yet). ``(0, 0, 0)`` for the slot cache."""
        if not self.kv_block:
            return 0, 0, 0
        total = self.cache.n_blocks - 1
        return total, max(0, total - self._allocator.n_free), 0

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
        layer off. ``adapter`` and ``pin_replica`` are accepted at their
        neutral value and raise ``NotImplementedError`` naming their
        ROADMAP item otherwise; a name the reference does not take raises
        ``TypeError``."""
        for key, val in options.items():
            if key not in _NEUTRAL_SUBMIT_OPTIONS:
                raise TypeError(f"submit_generate() got an unexpected option {key!r}")
            neutral, item = _NEUTRAL_SUBMIT_OPTIONS[key]
            if val is not None and val != neutral:
                raise NotImplementedError(f"{key}={val!r} is not ported yet ({item})")
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
        (prompt + budget). Read under ``self._lock``."""
        return (self._queued_tokens + cost_tokens) / self._throughput_tps()

    def _retry_after_s(self, cost: int) -> float:
        """The Retry-After of an admission shed: the queue-drain
        projection (the reference's ``shed_retry_after_s`` without the
        brownout, tenant-ledger and control-plane floors, not ported)."""
        return max(self._projected_wait_s(max(0, cost)), 0.5)

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
        with self._lock:
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
        with self._lock:
            self._queued_tokens = max(0, self._queued_tokens - cost)
            if req.tenant and req.tenant in self._tenant_queued:
                left = self._tenant_queued[req.tenant] - 1
                if left > 0:
                    self._tenant_queued[req.tenant] = left
                else:
                    del self._tenant_queued[req.tenant]

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
        """The ``ctx.infer`` seam for an LLM engine."""
        return self._infer_dict(await self.generate(inputs, **kw))

    def infer_sync(self, inputs: Any, model: str = "", **kw: Any) -> dict:
        return self._infer_dict(self.generate_sync(inputs, **kw))

    # -- lifecycle (the reference's start/stop and drain semantics) --------

    async def start(self) -> None:
        self.start_sync()

    def start_sync(self) -> None:
        """Start the scheduler thread; a no-op while it runs (the
        constructor starts it), a restart after a stop."""
        with self._lock:
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
        self._thread = threading.Thread(
            target=self._run, name=f"gofr-torch-engine-{self.model_name}",
            daemon=True,
        )
        self._thread.start()

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
        "engine not started" after a hard one, as in the reference)."""
        if drain_s > 0 and self._running:
            with self._lock:
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
        with self._lock:
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

    def lora_names(self) -> list[str]:
        """Loaded LoRA adapters: none until LoRA is ported (ROADMAP Queue
        1 item 6)."""
        return []

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
            "kv_slots": {
                "total": self.n_slots,
                "in_use": sum(1 for s in self._slots if s is not None),
            },
            "max_len": self.max_len,
            "pending": self._pending.qsize(),
            "prefilling": len(self._prefilling),
        }
        if self.kv_block:
            details["kv_blocks"] = {
                "block": self.kv_block,
                "total": self.cache.n_blocks - 1,  # block 0 parks
                "free": self._allocator.n_free,
            }
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
        default (``check_unported_keys``)."""
        check_unported_keys(config)

        def num(key: str, default: str, kind: type = int) -> Any:
            return kind(config.get_or_default(key, default))

        return cls(
            config.get_or_default("TPU_MODEL", "llama-tiny"),
            n_slots=num("TPU_KV_SLOTS", "8"),
            max_len=num("TPU_MAX_LEN", "1024"),
            window_k=num("TPU_DECODE_WINDOW", "8"),
            pipeline_depth=num("TPU_PIPELINE_DEPTH", "2"),
            mega_windows=num("TPU_MEGA_WINDOWS", "0"),
            prefill_depth=num("TPU_PREFILL_DEPTH", "1"),
            prefill_chunk=num("TPU_PREFILL_CHUNK", "256"),
            prefill_batch=num("TPU_PREFILL_BATCH", "8"),
            kv_quant=config.get_or_default("TPU_KV_QUANT", ""),
            kv_block=num("TPU_KV_BLOCK", "0"),
            kv_pool_blocks=num("TPU_KV_POOL_BLOCKS", "0"),
            truncate_prompts=_truthy(config, "TPU_TRUNCATE_PROMPTS", "false"),
            top_k=num("TPU_TOP_K", "0"),
            top_logprobs=num("TPU_TOP_LOGPROBS", "0"),
            enable_top_p=_truthy(config, "TPU_TOP_P", "false"),
            enable_penalties=_truthy(config, "TPU_PENALTIES", "false"),
            queue_max=num("TPU_QUEUE_MAX", "1024"),
            queue_max_tokens=num("TPU_QUEUE_TOKENS", "0"),
            class_promote_s=num("TPU_QUEUE_CLASS_PROMOTE_S", "5", float),
            tenant_queue_max=num("TPU_TENANT_QUEUE_MAX", "0"),
            tenant_slo_class=config.get_or_default("TPU_TENANT_SLO_CLASS", ""),
            expected_tps=num("TPU_EXPECTED_TPS", "0", float),
            device=config.get_or_default("TPU_DEVICE", "") or None,
            logger=logger,
            metrics=metrics,
        )

    # ------------------------------------------------------------------
    # scheduler loop (its own thread; the only code that touches the
    # device state and the slot tables)
    # ------------------------------------------------------------------

    def _run(self) -> None:
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            with torch.inference_mode():
                if self.device.type == "cuda" and self._graphs is None:
                    self._capture_graphs()
                while self._running:
                    self._pass()
        except Exception as exc:  # the loop's boundary: report, fail callers
            traceback.print_exc()
            with self._lock:
                self._error = exc
                self._running = False
            self._set_state("DEGRADED")
            if self._logger is not None:
                self._logger.errorf("engine scheduler died: %s", exc)
            self._fail_all(exc)
            self._idle_evt.set()  # a drain waiting on this engine ends

    def _pass(self) -> None:
        """One scheduler pass, the reference's loop body
        (``gofr_tpu/serving/scheduler.py::_scheduler_loop``)."""
        # Cancelled and expired requests retire here, once a pass, so a
        # dead stream's slot and blocks free within one decode window.
        self._reap_lifecycle()
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
            ))
        else:
            self._graphs = DecodeGraphs(
                window_fn=lambda sampling, use_bias: self._window_eager(sampling, use_bias)
            )

    def _note_idle(self) -> None:
        """During a drain: publish idle once nothing is queued, waiting
        for blocks, prefilling or decoding (submits are refused by then,
        so idle stays idle)."""
        with self._lock:
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
        self._slots[slot] = None
        self._prefilling.pop(slot, None)
        self._slot_state_dirty = True
        if self.kv_block:
            self._release_blocks(slot)
            if self._metrics is not None:
                self._metrics.set_gauge(
                    "app_tpu_kv_blocks_free", self._allocator.n_free,
                    "model", self.model_name,
                )

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
            # Clamp the budget so the windows in flight past the last
            # token still land inside the cache (below the parking row).
            room = (
                self.max_len - 1 - len(req.prompt_ids)
                - (self.pipeline_depth + 1) * self.window_k
            )
            req.max_new_tokens = max(1, min(req.max_new_tokens, room))
            if self.kv_block:
                B = self.kv_block
                need = (min(len(req.prompt_ids) + 1, self.max_len) + B - 1) // B
                if need > self.cache.n_blocks - 1:
                    self._resolve(req, exc=RuntimeError(
                        f"prompt needs {need} KV blocks but the pool has "
                        f"{self.cache.n_blocks - 1}; raise kv_pool_blocks"
                    ))
                    continue
                # Cover the prompt and the first decode token now; windows
                # top up before they run. A dry pool holds the request at
                # the head of the queue until retirements refill it.
                if not self._ensure_blocks(free[0], len(req.prompt_ids) + 1):
                    self._backlog.appendleft(req)
                    self.kv_admission_waits += 1
                    return
                self._dispatched_tokens[free[0]] = 0
            slot = free.pop(0)
            self._seeds_host[slot] = req.seed
            self._bidx_host[slot, :] = -1
            self._bval_host[slot, :] = 0.0
            for j, (tok, val) in enumerate(req.logit_bias.items()):
                self._bidx_host[slot, j] = tok
                self._bval_host[slot, j] = val
            self._seeds_dirty = True
            self._prefilling[slot] = _Prefill(request=req)

    def _ensure_blocks(self, slot: int, tokens: int) -> bool:
        """Grow ``slot``'s allocation to cover ``tokens`` logical tokens.
        False when the pool is dry, with any partial grab rolled back."""
        B = self.kv_block
        target = min((min(tokens, self.max_len) + B - 1) // B,
                     self._table_host.shape[1])
        row = self._slot_blocks[slot]
        start_len = len(row)
        while len(row) < target:
            blk = self._allocator.alloc()
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

    def _release_blocks(self, slot: int) -> None:
        """Return ``slot``'s blocks to the pool and clear its table row."""
        row = self._slot_blocks[slot]
        if row:
            for blk in row:
                self._allocator.decref(blk)
            self._slot_blocks[slot] = []
            self._table_host[slot, :] = 0
            self._table_dirty = True
        self._dispatched_tokens[slot] = 0

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
            # Seeds and logit-bias rows change only at admission.
            self.planes.seeds.copy_(self._up(self._seeds_host))
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
                del self._prefilling[slot]
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
                            self._up(tokens3), self._up(slots), self._up(starts))
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
        if self.kv_block:
            total, used, _ = self.kv_pool_counts()
            m.set_gauge("app_tpu_kv_pool_occupancy_ratio", used / max(1, total),
                        "model", self.model_name)

    def _window_eager(self, sampling: bool, use_bias: bool) -> torch.Tensor:
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
            # land before the host sees their tokens): a slot's real
            # writes in a mega window cover its remaining tokens, and its
            # junk past them parks in block 0. A dry pool mid-stream fails
            # the request: the honest outcome of an oversubscribed pool.
            for i, req in enumerate(self._slots):
                if req is None:
                    continue
                wt = k if mega <= 1 else min(mega, -(-int(remaining[i]) // k)) * k
                need = len(req.prompt_ids) + self._dispatched_tokens[i] + wt + 1
                if self._ensure_blocks(i, need):
                    self._dispatched_tokens[i] += wt
                    continue
                self._resolve(req, exc=RuntimeError(
                    "KV block pool exhausted mid-generation (raise "
                    "kv_pool_blocks or lower concurrency)"
                ))
                self._release_slot(i)
                if mega > 1:
                    remaining[i], eos_stop[i] = 0, False
            self._push_table()
            if all(s is None for s in self._slots):
                self._publish_step_metrics()
                return None  # the dry pool failed every live request
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
                    state, **use,
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
        host, T = win.host, self.top_logprobs
        for i, req in enumerate(win.snapshot):
            if req is None:
                continue
            if req.future.done():
                # Retired by an earlier window (its tokens here overshoot)
                # or cancelled by the caller mid-flight: free the slot if
                # it still holds the request.
                if self._slots[i] is req:
                    self._reap_request(req, slot=i)
                continue
            for step in range(steps):
                top = None
                if req.top_logprobs:
                    top = [(int(host[2 + j, step, i]), float(host[2 + T + j, step, i]))
                           for j in range(req.top_logprobs)]
                if self._emit(i, req, int(host[0, step, i]), float(host[1, step, i]), top):
                    break
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
