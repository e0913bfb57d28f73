"""The continuous-batching serving engine of the port — the counterpart of
``gofr_tpu/serving/engine.py`` ``InferenceEngine`` with the scheduling of
``serving/scheduler.py`` on this slice's configuration.

A scheduler thread owns the device. Each pass admits queued requests into
free cache slots, runs one fixed-shape [prefill_batch, prefill_chunk]
chunk step for the slots mid-prefill (a long prompt takes several passes,
so it never stalls decode), then one k-step decode window over all slots
with one host fetch per window. A request retires on EOS, on its token
budget or at the context limit, and its slot is reused.

Only the slice's configuration is served: bf16 (or f32) weights, the
slot cache or the paged block pool (``kv_block``, ``kv_pool_blocks``),
bf16 or int8 K/V (``kv_quant``), tp=1, greedy and temperature sampling.
Any option outside it raises ``NotImplementedError``; none is ignored.

With a pool, admission allocates each request's prompt blocks (plus one
token) from a host-side ``BlockAllocator`` and a host mirror of the block
table, uploaded to the device when it changed; before each decode window
every live slot's allocation is grown to cover the window; retirement
returns the blocks. A request the whole pool cannot hold fails at
admission, one that waits on a dry pool stays at the head of the queue,
and one whose pool runs dry mid-generation fails, as in the reference.
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
from dataclasses import dataclass
from typing import Any, AsyncIterator, Optional

import numpy as np
import torch

from gofr_tpu_torch.device import resolve_device
from gofr_tpu_torch.models.registry import get_model
from gofr_tpu_torch.models.transformer import check_supported, init_params, rope_tables
from gofr_tpu_torch.ops.kv_cache import BlockAllocator, KVCache, PagedKVCache
from gofr_tpu_torch.serving.programs import (
    SlotPlanes,
    decode_window,
    prefill_chunk_step,
)
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer
from gofr_tpu_torch.serving.types import GenerationResult, GenRequest

# Reference options this slice accepts only at their neutral value, each
# with the ROADMAP item that ports it.
_SAMPLER = "ROADMAP Queue 1 item 1: the rest of the sampler"
_LIFECYCLE = "ROADMAP Queue 1 item 2: request lifecycle"
_NEUTRAL_SUBMIT_OPTIONS = {
    "top_p": (1.0, _SAMPLER),
    "frequency_penalty": (0.0, _SAMPLER),
    "presence_penalty": (0.0, _SAMPLER),
    "logit_bias": (None, _SAMPLER),
    "top_logprobs": (0, _SAMPLER),
    "stop": (None, _SAMPLER),
    "adapter": ("", "ROADMAP Queue 1 item 6: LoRA adapters"),
    "deadline": (None, _LIFECYCLE),
    "deadline_s": (None, _LIFECYCLE),
    "cancel": (None, _LIFECYCLE),
    "tenant": ("", _LIFECYCLE),
    "slo_class": ("", _LIFECYCLE),
    "pin_replica": (False, _LIFECYCLE),
    "traceparent": (None, _LIFECYCLE),
}


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
    """

    def __init__(
        self,
        model_name: str,
        *,
        n_slots: int = 8,
        max_len: int = 1024,
        window_k: int = 8,
        pipeline_depth: int = 2,
        prefill_chunk: int = 256,
        prefill_batch: int = 8,
        kv_block: int = 0,
        kv_pool_blocks: int = 0,
        kv_quant: str = "",
        tokenizer: Any = None,
        params: Optional[dict] = None,
        seed: int = 0,
        device: Any = None,
        **unsupported: Any,
    ) -> None:
        if "auto_prefix" in unsupported:
            raise NotImplementedError(
                "auto_prefix (the radix prefix cache over the block pool) is "
                "not ported yet (ROADMAP Queue 1 item 5)"
            )
        if unsupported:
            raise NotImplementedError(
                "engine options outside this slice of the torch port: "
                f"{sorted(unsupported)} (ROADMAP: the rest of the serving "
                "features)"
            )
        if pipeline_depth != 2:
            raise NotImplementedError(
                "the port runs one decode window at a time; pipeline_depth "
                "only sizes the room reserved for windows in flight and "
                f"stays at the reference's default 2, got {pipeline_depth} "
                "(ROADMAP Queue 1 item 3)"
            )
        for name, val in (("n_slots", n_slots), ("window_k", window_k),
                          ("prefill_chunk", prefill_chunk),
                          ("prefill_batch", prefill_batch)):
            if int(val) < 1:
                raise ValueError(f"{name} must be >= 1, got {val}")
        if max_len < window_k + 4:
            raise ValueError(f"max_len {max_len} too small for window_k {window_k}")
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
        self.pipeline_depth = int(pipeline_depth)
        self.kv_block = int(kv_block)
        self.prefill_chunk = int(prefill_chunk)
        self.prefill_batch = int(prefill_batch)
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
        self.planes = SlotPlanes.create(self.n_slots, self.device)

        # Host-side scheduler state (scheduler thread only).
        self._slots: list[Optional[GenRequest]] = [None] * self.n_slots
        self._prefilling: dict[int, _Prefill] = {}
        self._seeds_host = np.zeros((self.n_slots,), dtype=np.int64)
        self._seeds_dirty = False
        self._slot_state_dirty = False
        # Device steps dispatched (prefill chunks / decode windows).
        self.prefill_steps = 0
        self.decode_windows = 0

        self._pending: "queue.Queue[Optional[GenRequest]]" = queue.Queue()
        # Requests taken off the queue but not yet admitted (loop only).
        self._backlog: "collections.deque[GenRequest]" = collections.deque()
        self._lock = threading.Lock()
        self._closed = False
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._run, name=f"gofr-torch-engine-{model_name}",
            daemon=True,
        )
        self._thread.start()

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
        seed: Optional[int] = None,
        **options: Any,
    ) -> GenRequest:
        """Queue a generate request; returns its record (``future`` resolves
        with the ``GenerationResult``, ``stream`` yields token ids then
        ``None``). Reference options outside this slice (top_p, penalties,
        logit_bias, top_logprobs, stop sequences, adapters, deadlines,
        cancel tokens, tenant, SLO class, replica pinning, trace context)
        raise ``NotImplementedError`` unless at their neutral value; a name
        the reference does not take raises ``TypeError``."""
        for key, val in options.items():
            if key not in _NEUTRAL_SUBMIT_OPTIONS:
                raise TypeError(f"submit_generate() got an unexpected option {key!r}")
            neutral, item = _NEUTRAL_SUBMIT_OPTIONS[key]
            if val is not None and val != neutral and (
                not isinstance(val, (dict, list)) or val
            ):
                raise NotImplementedError(f"{key}={val!r} is not ported yet ({item})")
        if temperature < 0:
            raise ValueError("temperature must be >= 0")
        if int(max_new_tokens) < 1:
            raise ValueError("max_new_tokens must be >= 1")
        ids = (
            self.tokenizer.encode(prompt) if isinstance(prompt, str)
            else [int(i) for i in prompt]
        )
        if not ids:
            raise ValueError("prompt must be at least one token")
        if any(not 0 <= i < self.cfg.vocab_size for i in ids):
            raise ValueError(f"token ids must be in [0, {self.cfg.vocab_size})")
        if len(ids) > self.max_prompt_tokens:
            raise ValueError(
                f"prompt of {len(ids)} tokens exceeds the engine's "
                f"{self.max_prompt_tokens}"
            )
        req = GenRequest(
            prompt_ids=ids,
            max_new_tokens=int(max_new_tokens),
            temperature=float(temperature),
            stop_on_eos=bool(stop_on_eos),
            seed=(
                int(seed) & 0x7FFFFFFF if seed is not None
                else self._seed_rng.getrandbits(31)
            ),
        )
        with self._lock:
            if self._closed:
                raise RuntimeError("engine is closed")
            if self._error is not None:
                raise RuntimeError("engine stopped after an error") from self._error
            self._pending.put(req)
        return req

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
                if req.future.done() and req.future.exception() is not None:
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

    def close(self, timeout: float = 30.0) -> None:
        """Stop the scheduler thread; requests still queued or in flight
        fail with ``RuntimeError``."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._pending.put(None)  # wake the loop
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            raise RuntimeError("engine scheduler thread did not stop")
        self._fail_all(RuntimeError("engine closed"))

    # ------------------------------------------------------------------
    # scheduler loop (its own thread; the only code that touches the
    # device state and the slot tables)
    # ------------------------------------------------------------------

    def _run(self) -> None:
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            with torch.inference_mode():
                while not self._closed:
                    self._admit()
                    busy = False
                    if self._prefilling:
                        self._prefill_step()
                        busy = True
                    if any(s is not None for s in self._slots):
                        self._decode_window()
                        busy = True
                    if not busy:
                        self._wait_for_work()
        except Exception as exc:  # the loop's boundary: report, fail callers
            traceback.print_exc()
            with self._lock:
                self._error = exc
            self._fail_all(exc)

    def _next_request(self, timeout: Optional[float] = None) -> Optional[GenRequest]:
        """The oldest queued request (waiting up to ``timeout`` when given),
        or None."""
        if self._backlog:
            return self._backlog.popleft()
        while True:
            try:
                req = (
                    self._pending.get(timeout=timeout) if timeout
                    else self._pending.get_nowait()
                )
            except queue.Empty:
                return None
            if req is not None:  # None only wakes the loop
                return req
            if timeout:
                return None

    def _wait_for_work(self) -> None:
        req = self._next_request(timeout=0.05)
        if req is not None:
            self._backlog.appendleft(req)

    def _fail_all(self, exc: BaseException) -> None:
        reqs = [s for s in self._slots if s is not None]
        reqs += [st.request for st in self._prefilling.values()]
        while (req := self._next_request()) is not None:
            reqs.append(req)
        self._slots = [None] * self.n_slots
        self._prefilling.clear()
        for req in reqs:
            self._fail(req, exc)

    def _admit(self) -> None:
        free = [
            i for i, s in enumerate(self._slots)
            if s is None and i not in self._prefilling
        ]
        while free:
            req = self._next_request()
            if req is None:
                return
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
                    self._fail(req, RuntimeError(
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
            self._seeds_dirty = True
            self._prefilling[slot] = _Prefill(request=req)

    @staticmethod
    def _fail(req: GenRequest, exc: BaseException) -> None:
        if not req.future.done():
            req.future.set_exception(exc)
        req.stream.put(None)

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
        return torch.from_numpy(a).to(self.device)

    def _prefill_step(self) -> None:
        self._push_table()
        P, c = self.prefill_batch, self.prefill_chunk
        rows = list(self._prefilling.items())[:P]
        tokens = np.zeros((P, c), dtype=np.int64)
        slots = np.zeros((P,), dtype=np.int32)
        starts = np.zeros((P,), dtype=np.int32)
        lens = np.zeros((P,), dtype=np.int32)
        finalize = np.zeros((P,), dtype=bool)
        row_valid = np.zeros((P,), dtype=bool)
        temps = np.ones((P,), dtype=np.float32)
        greedy = np.ones((P,), dtype=bool)
        for i, (slot, st) in enumerate(rows):
            ids = st.request.prompt_ids
            chunk = ids[st.done: st.done + c]
            tokens[i, : len(chunk)] = chunk
            slots[i], starts[i], lens[i] = slot, st.done, len(chunk)
            finalize[i] = st.done + len(chunk) >= len(ids)
            row_valid[i] = True
            temps[i] = max(st.request.temperature, 0.0)
            greedy[i] = st.request.temperature <= 0
        for i in range(len(rows), P):
            # Padding rows duplicate row 0: identical K/V writes to the
            # same positions, and row_valid=False keeps them out of the
            # finalize merge.
            tokens[i] = tokens[0]
            slots[i], starts[i], lens[i] = slots[0], starts[0], lens[0]
            temps[i], greedy[i] = temps[0], greedy[0]
        if self._seeds_dirty:
            self.planes.seeds.copy_(self._up(self._seeds_host))
            self._seeds_dirty = False
        sampling = any(st.request.temperature > 0 for _, st in rows)
        first, first_lp = prefill_chunk_step(
            self.params, self.cache, self.cfg, self.rope, self.planes,
            self._up(tokens), self._up(slots), self._up(starts),
            self._up(lens), self._up(finalize), self._up(row_valid),
            self._up(temps), self._up(greedy), self._base_seed, sampling,
        )
        self.prefill_steps += 1
        done_rows = []
        for i, (slot, st) in enumerate(rows):
            st.done += int(lens[i])
            if finalize[i]:
                del self._prefilling[slot]
                done_rows.append((i, slot, st.request))
        if not done_rows:
            return
        # The first token was sampled on the device with the chunk; fetch
        # it now so it is emitted without waiting for a decode window.
        first_h = first.cpu().numpy()
        first_lp_h = first_lp.cpu().numpy()
        for i, slot, req in done_rows:
            self._slots[slot] = req
            self._slot_state_dirty = True
            self._emit(slot, req, int(first_h[i]), float(first_lp_h[i]))

    def _decode_window(self) -> None:
        if self.kv_block:
            # Allocation stays ahead of the window about to run (its writes
            # land before the host sees its tokens). A dry pool mid-stream
            # fails the request: the honest outcome of an oversubscribed
            # pool.
            for i, req in enumerate(self._slots):
                if req is None:
                    continue
                need = (len(req.prompt_ids) + self._dispatched_tokens[i]
                        + self.window_k + 1)
                if self._ensure_blocks(i, need):
                    self._dispatched_tokens[i] += self.window_k
                    continue
                self._fail(req, RuntimeError(
                    "KV block pool exhausted mid-generation (raise "
                    "kv_pool_blocks or lower concurrency)"
                ))
                self._slots[i] = None
                self._slot_state_dirty = True
                self._release_blocks(i)
            self._push_table()
            if all(s is None for s in self._slots):
                return
        if self._slot_state_dirty:
            active = np.zeros((self.n_slots,), dtype=bool)
            temps = np.ones((self.n_slots,), dtype=np.float32)
            greedy = np.ones((self.n_slots,), dtype=bool)
            for i, req in enumerate(self._slots):
                if req is not None:
                    active[i] = True
                    temps[i] = max(req.temperature, 0.0)
                    greedy[i] = req.temperature <= 0
            self.planes.active.copy_(self._up(active))
            self.planes.temps.copy_(self._up(temps))
            self.planes.greedy.copy_(self._up(greedy))
            self._slot_state_dirty = False
        sampling = any(r is not None and r.temperature > 0 for r in self._slots)
        emitted = decode_window(
            self.params, self.cache, self.cfg, self.rope, self.planes,
            self.window_k, self._base_seed, sampling,
        )
        self.decode_windows += 1
        host = emitted.cpu().numpy()  # the window's one device→host fetch
        for i, req in enumerate(list(self._slots)):
            if req is None:
                continue
            for step in range(self.window_k):
                if self._emit(i, req, int(host[0, step, i]), float(host[1, step, i])):
                    break

    def _emit(self, slot: int, req: GenRequest, tok: int, logprob: float) -> bool:
        """Deliver one token; retire the request (and free its slot) when
        it is finished. Returns True on retirement."""
        now = time.time()
        if not req.token_ids:
            req.ttft_s = now - req.enqueued_at
        req.token_ids.append(tok)
        req.token_logprobs.append(logprob)
        req.token_times.append(now)
        req.stream.put(tok)
        if not self._finished(req):
            return False
        self._retire(slot, req)
        return True

    def _finished(self, req: GenRequest) -> bool:
        eos = self.tokenizer.eos_id
        if req.stop_on_eos and req.token_ids[-1] == eos:
            return True
        if len(req.token_ids) >= req.max_new_tokens:
            return True
        return len(req.prompt_ids) + len(req.token_ids) >= self.max_len - 1

    def _retire(self, slot: int, req: GenRequest) -> None:
        ids = list(req.token_ids)
        if req.stop_on_eos and ids[-1] == self.tokenizer.eos_id:
            reason = "stop"
        else:
            reason = "length"
        result = GenerationResult(
            text=self.tokenizer.decode(ids),
            token_ids=ids,
            prompt_tokens=len(req.prompt_ids),
            ttft_s=req.ttft_s,
            duration_s=time.time() - req.enqueued_at,
            token_logprobs=list(req.token_logprobs),
            finish_reason=reason,
        )
        self._slots[slot] = None
        self._slot_state_dirty = True
        if self.kv_block:
            self._release_blocks(slot)
        if not req.future.done():
            req.future.set_result(result)
        req.stream.put(None)
