"""The engine's encoder and vision families — the port of the encoder and
vision halves of ``gofr_tpu/serving/modalities.py``, a mixin on
``InferenceEngine``.

Both families serve behind the dynamic batcher (``serving/batcher.py``):
concurrent ``embed`` / ``classify`` calls coalesce into one padded batch
forward, flushed on ``max_batch`` or on the oldest request's
``max_wait_s``. An encoder flush pads its token rows to the smallest of
``_PREFILL_BUCKETS`` that holds the longest (clamped to ``max_len``) and
runs ``bert_embed`` under a padding mask; a vision flush stacks its
images and runs the model's ``forward``. Forwards are eager PyTorch (no
CUDA graph), each flush's result copied to the host before its futures
resolve. The compile tracker counts each new batch shape of the
``embed`` and ``classify`` programs, as the reference counts its jit
compiles, and ``app_tpu_infer_latency{kind}`` records each flush.

The seq2seq family (T5) is not ported: an engine for it raises, naming
its ROADMAP item.
"""

from __future__ import annotations

import asyncio
import time
from typing import Any, Optional

import numpy as np
import torch

from gofr_tpu_torch.analysis import lockcheck
from gofr_tpu_torch.device import resolve_device
from gofr_tpu_torch.models.vit import ViTConfig
from gofr_tpu_torch.serving.batcher import DynamicBatcher, pad_bucket
from gofr_tpu_torch.serving.device_telemetry import CompileTracker
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer
from gofr_tpu_torch.serving.types import _PREFILL_BUCKETS

T5_ITEM = ("ROADMAP Queue 1 item 5: T5, stream_seq2seq, quantize_t5_params, "
           "load_hf_t5 and the seq2seq family")


class ModalityMixin:
    """Encoder / vision execution, their batcher, and the family dispatch
    of ``infer``."""

    def _init_batch_family(
        self, spec: Any, *, max_len: int, max_batch: int, max_wait_s: float,
        tokenizer: Any, params: Optional[dict], quant: str, seed: int,
        device: Any, hbm_budget_bytes: int, logger: Any, metrics: Any,
    ) -> None:
        """The constructor of an encoder or vision engine: weights (given,
        or from ``seed``), the program, the batcher (started, as the LLM
        engine's scheduler is at construction) and the HBM ledger, built
        once. ``quant`` raises, as in the reference."""
        if spec.family == "seq2seq":
            raise NotImplementedError(
                f"model {spec.name} is a seq2seq model, not ported yet ({T5_ITEM})"
            )
        if spec.family not in ("encoder", "vision"):
            raise ValueError(f"unknown model family {spec.family}")
        if quant:
            raise ValueError("quantization supports llm and seq2seq models only")
        self.device = resolve_device(device)
        self.model_name = spec.name
        self.spec = spec
        self.family = spec.family
        self.cfg = spec.config
        self._logger = logger
        self._metrics = metrics
        self.quant = ""
        self.kv_block = 0
        self.tokenizer = tokenizer if tokenizer is not None else ByteTokenizer()
        self._compiles = CompileTracker(spec.name, metrics=metrics, logger=logger)
        if self._compile_cache_info is not None:
            self._compiles.set_cache_info(self._compile_cache_info)
        self._ledger = None
        self.hbm_budget_bytes = max(0, int(hbm_budget_bytes))
        self.params = params if params is not None else spec.init(
            self.cfg, seed, self.device)
        if self.family == "encoder":
            self.max_len = min(int(max_len), self.cfg.max_len)
            self._build_encoder_step()
            execute, name = self._execute_embed, "embed"
        else:
            self._build_vision_step()
            execute, name = self._execute_classify, "classify"
        if self.device.type == "cuda" and isinstance(self.cfg, ViTConfig):
            # ViT's attention is the flash_attention kernel: the library
            # loads (or builds) here, not inside the first flush.
            self._load_kernels()
        self._batcher = DynamicBatcher(
            execute, max_batch=max(1, int(max_batch)), max_wait_s=float(max_wait_s),
            metrics=metrics, name=name,
        )
        self._build_hbm_ledger()
        self._submit_lock = lockcheck.make_lock("InferenceEngine._submit_lock")
        self._running = False
        self._state = "DOWN"
        self.start_sync()

    def _build_encoder_step(self) -> None:
        from gofr_tpu_torch.models.bert import bert_embed

        cfg = self.cfg
        self._embed_step = self._compiles.wrap(
            "embed", lambda params, tokens, mask: bert_embed(params, tokens, mask, cfg))

    def _build_vision_step(self) -> None:
        fwd = self.spec.forward
        if fwd is None:
            raise ValueError(
                f"vision model {self.model_name} registered without a "
                f"forward fn (ModelSpec.forward)"
            )
        cfg = self.cfg
        self._classify_step = self._compiles.wrap(
            "classify", lambda params, images: fwd(params, images, cfg))

    # ------------------------------------------------------------------
    # the batcher's flushes (its worker thread)
    # ------------------------------------------------------------------

    def _execute_embed(self, texts: list) -> list:
        encoded = [
            self.tokenizer.encode(t)[: self.max_len] if isinstance(t, str) else list(t)
            for t in texts
        ]
        bucket = pad_bucket(max(len(e) for e in encoded), _PREFILL_BUCKETS)
        bucket = min(bucket, self.max_len)
        tokens = np.zeros((len(encoded), bucket), dtype=np.int64)
        mask = np.zeros((len(encoded), bucket), dtype=np.int64)
        for i, ids in enumerate(encoded):
            ids = ids[:bucket]
            tokens[i, : len(ids)] = ids
            mask[i, : len(ids)] = 1
        t0 = time.time()
        with torch.inference_mode():
            out = self._embed_step(self.params, torch.from_numpy(tokens).to(self.device),
                                   torch.from_numpy(mask).to(self.device)).cpu().numpy()
        if self._metrics is not None:
            self._metrics.record_histogram(
                "app_tpu_infer_latency", time.time() - t0, "kind", "embed"
            )
        return [out[i] for i in range(len(encoded))]

    def _execute_classify(self, images: list) -> list:
        batch = np.stack([np.asarray(img, dtype=np.float32) for img in images])
        t0 = time.time()
        with torch.inference_mode():
            logits = self._classify_step(
                self.params, torch.from_numpy(batch).to(self.device)).cpu().numpy()
        if self._metrics is not None:
            self._metrics.record_histogram(
                "app_tpu_infer_latency", time.time() - t0, "kind", "classify"
            )
        return [logits[i] for i in range(len(images))]

    # ------------------------------------------------------------------
    # encoder / vision APIs (dynamic batching)
    # ------------------------------------------------------------------

    def embed_sync(self, text: Any, timeout: float = 60.0) -> np.ndarray:
        return self._batcher.submit(text).result(timeout=timeout)

    async def embed(self, text: Any) -> np.ndarray:
        return await asyncio.wrap_future(self._batcher.submit(text))

    def classify_sync(self, image: Any, timeout: float = 60.0) -> np.ndarray:
        return self._batcher.submit(image).result(timeout=timeout)

    async def classify(self, image: Any) -> np.ndarray:
        return await asyncio.wrap_future(self._batcher.submit(image))

    # ------------------------------------------------------------------
    # lifecycle and health of a batched engine
    # ------------------------------------------------------------------

    def _batch_start(self) -> None:
        with self._submit_lock:
            if self._running:
                return
            self._running = True
        self._set_state("SERVING")
        self._batcher.start()

    def _batch_stop(self) -> None:
        with self._submit_lock:
            self._running = False
        self._batcher.stop()
        self._set_state("DOWN")

    # ------------------------------------------------------------------
    # generic dispatch (the container's ctx.infer seam)
    # ------------------------------------------------------------------

    async def _batch_infer(self, inputs: Any) -> dict:
        if self.family == "encoder":
            emb = await self.embed(inputs)
            return {"embedding": emb.tolist()}
        vec = await self.classify(inputs)
        return {"logits": vec.tolist(), "class": int(np.argmax(vec))}

    def _batch_infer_sync(self, inputs: Any) -> dict:
        if self.family == "encoder":
            return {"embedding": self.embed_sync(inputs).tolist()}
        vec = self.classify_sync(inputs)
        return {"logits": vec.tolist(), "class": int(np.argmax(vec))}
