"""Runtime multi-LoRA adapter lifecycle: load and unload into stacked
adapter slots, with a generation stamp per slot so a completion never
mixes two weight sets — the port of ``gofr_tpu/serving/lora_runtime.py``
(``LoRARuntimeMixin``, mixed into ``InferenceEngine``).

The adapter leaves ``{t}_lora_a`` [L, 1 + lora_slots, d_in, r] and
``{t}_lora_b`` [L, 1 + lora_slots, r, d_out] are allocated once, when the
engine is built, before the decode programs are captured as CUDA graphs.
A captured graph reads a tensor by its address, so an adapter is written
into its slot in place (``zero_``, ``copy_``) and never by rebinding
``self.params``: every replayed window then reads the slot's current
values, and every leaf keeps its storage for the engine's life.

Ordering against the windows in flight: the scheduler thread holds the
engine's ``_device_lock`` for each scheduler pass (and for the graph
capture), and ``load_lora`` / ``unload_lora`` take the same lock
(``_device_turn``: the scheduler stands aside for a waiting writer) for the
generation bump, the failure of the slot's live requests, the prefix
purges and the slot write. The write then goes on the stream the passes
use, between two passes: the windows dispatched before it read the old
values and those after it the new ones. The adapter's host tensors go
to the device before the lock is taken. The name routes to the slot only
once the write is on the stream.
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterator

import torch

from gofr_tpu_torch.serving.lora import load_peft_adapter, validate_adapter_leaves


class LoRARuntimeMixin:
    """Adapter slot management (``load_lora`` / ``unload_lora``)."""

    @contextlib.contextmanager
    def _device_turn(self) -> Iterator[None]:
        """Hold the engine's device lock between two scheduler passes: the
        scheduler sees a waiter and stands aside instead of taking the lock
        straight back."""
        with self._submit_lock:
            self._device_waiters += 1
        self._work.set()
        try:
            self._device_lock.acquire()
        finally:
            with self._submit_lock:
                self._device_waiters -= 1
        try:
            yield
        finally:
            self._device_lock.release()

    def _live_aid_requests(self, idx: int) -> list:
        """In-flight generate requests (decoding or prefilling) routed to
        adapter slot ``idx``. Prefix registrations are left out: their
        generation stamp resolves them to -1 at finalize."""
        reqs = [
            req for req in list(self._slots)
            if req is not None and req.aid == idx and not req.prefix_store
        ]
        reqs += [
            st.request for st in list(self._prefilling.values())
            if st.request.aid == idx and not st.request.prefix_store
        ]
        return reqs

    def _fail_aid_requests(self, idx: int, why: str) -> None:
        """Fail in-flight requests routed to adapter slot ``idx``: a
        completion must never mix tokens from two weight sets. The
        scheduler releases their slots at the next processed window (a
        done future there is a retired request)."""
        for req in self._live_aid_requests(idx):
            if not req.future.done():
                req.future.set_exception(RuntimeError(why))
            req.stream.put(None)

    def _purge_aid(self, idx: int) -> None:
        """Drop the prefixes prefilled under adapter slot ``idx`` from the
        explicit pool and the radix index. Blocks still aliased by live
        tables survive until those slots release."""
        if self._prefix_pool is not None:
            self._prefix_pool.purge_aid(idx)
        if self._radix is not None:
            self._radix.purge_aid(idx)
            self._publish_prefix_gauge()

    def _write_lora_slot(self, idx: int, leaves: dict) -> None:
        """Zero adapter slot ``idx`` of every leaf (a reload with fewer
        targets must not leave the old version's other deltas live), then
        copy ``leaves`` ({target: (a, b)} in ``cfg.dtype`` on the engine's
        device) in: in place, on the current stream (under inference mode,
        which allows the in-place write whether or not the leaves were made
        in it)."""
        with torch.inference_mode():
            for t in self._lora_targets:
                for suffix in ("_lora_a", "_lora_b"):
                    self.params[t + suffix][:, idx].zero_()
            for t, (a, b) in leaves.items():
                self.params[t + "_lora_a"][:, idx].copy_(a)
                self.params[t + "_lora_b"][:, idx].copy_(b)

    def _publish_lora_gauge(self) -> None:
        if self._metrics is not None:
            self._metrics.set_gauge(
                "app_tpu_lora_adapters", float(len(self._lora_names)),
                "model", self.model_name,
            )

    def load_lora(self, name: str, source: Any) -> int:
        """Load a LoRA adapter into a free adapter slot under ``name``.

        source: an HF PEFT checkpoint dir (``adapter_config.json`` +
        safetensors) or a raw ``{target: (a [L, d_in, r], b [L, r,
        d_out])}`` dict of tensors or arrays. Re-loading an existing name
        overwrites its slot. Returns the adapter slot index (≥1). Safe
        while serving (see the module's notes on ordering). Requests still
        generating against the slot being overwritten (same-name reload,
        or a freed slot only dirty slots remain for) are FAILED rather
        than switched mid-completion; fresh loads prefer a free slot with
        no in-flight traffic.
        """
        if self.family != "llm":
            raise RuntimeError("LoRA adapters are for llm engines")
        if not self.lora_slots:
            raise RuntimeError(
                "engine compiled without adapter slots — set "
                "TPU_LORA_SLOTS>0"
            )
        if isinstance(source, str):
            leaves = load_peft_adapter(
                source, self.cfg, self.lora_rank, self._lora_targets
            )
        else:
            leaves = dict(source)
            validate_adapter_leaves(
                leaves, self.cfg, self.lora_rank, self._lora_targets
            )
        # On the device before the lock: a copy from host memory may wait
        # for the windows in flight, and the scheduler must not.
        dt = self.cfg.dtype
        leaves = {
            t: tuple(torch.as_tensor(x).detach().to(device=self.device, dtype=dt)
                     for x in ab)
            for t, ab in leaves.items()
        }
        with self._device_turn():
            idx = self._lora_names.get(name)
            if idx is None:
                used = set(self._lora_names.values())
                free = [
                    i for i in range(1, self.lora_slots + 1) if i not in used
                ]
                if not free:
                    raise RuntimeError(
                        f"all {self.lora_slots} adapter slots in use "
                        f"(TPU_LORA_SLOTS); unload_lora one first"
                    )
                # Prefer a freed slot nothing still generates against
                # (an unload lets in-flight requests finish on base
                # weights); reuse a draining one only when forced to.
                idx = next(
                    (i for i in free if not self._live_aid_requests(i)),
                    free[0],
                )
            # The generation first: from here on admission rejects any
            # queued request stamped under the old weights, so the failure
            # snapshot below cannot miss one. It also marks the prefixes
            # computed under the slot's previous occupant stale.
            self._lora_gen[idx] += 1
            self._fail_aid_requests(
                idx,
                f"LoRA adapter slot {idx} is being overwritten by a load of "
                f"{name!r} while this request was generating; resubmit",
            )
            self._purge_aid(idx)
            self._write_lora_slot(idx, leaves)
            self._lora_names[name] = idx
        if self._logger is not None:
            self._logger.infof(
                "LoRA adapter %s loaded into slot %d (targets: %s)",
                name, idx, ",".join(sorted(leaves)),
            )
        self._publish_lora_gauge()
        return idx

    def unload_lora(self, name: str) -> None:
        """Zero ``name``'s adapter slot and free it. In-flight requests
        routed to the slot finish against the zeroed (= base) weights —
        callers should drain first if that matters."""
        with self._device_turn():
            idx = self._lora_names.pop(name, None)
            if idx is None:
                raise KeyError(f"no loaded LoRA adapter {name!r}")
            self._lora_gen[idx] += 1
            # The slot may be reused by a later load: prefixes prefilled
            # under it are stale the moment it frees.
            self._purge_aid(idx)
            self._write_lora_slot(idx, {})
        self._publish_lora_gauge()

    def lora_names(self) -> list[str]:
        """Loaded adapter names (the OpenAI surface lists them as models)."""
        if self.family != "llm" or not getattr(self, "lora_slots", 0):
            return []
        return sorted(self._lora_names)
