"""The engine's encoder, vision and seq2seq families — the port of
``gofr_tpu/serving/modalities.py``, a mixin on ``InferenceEngine``.

The three families serve behind the dynamic batcher (``serving/batcher.py``):
concurrent ``embed`` / ``classify`` calls coalesce into one padded batch
forward, flushed on ``max_batch`` or on the oldest request's
``max_wait_s``. An encoder flush pads its token rows to the smallest of
``_PREFILL_BUCKETS`` that holds the longest (clamped to ``max_len``) and
runs ``bert_embed`` under a padding mask; a vision flush stacks its
images and runs the model's ``forward``; a seq2seq flush pads its rows
the same way and runs ``t5_generate`` (``TPU_SEQ2SEQ_MAX_NEW`` greedy
steps, default 64), each answer trimmed at EOS only (id 0 is a real
token). Forwards are eager PyTorch (no CUDA graph), each flush's result
copied to the host before its futures resolve. The compile tracker counts
each new batch shape of the ``embed``, ``classify``, ``seq2seq``,
``seq2seq_encode`` and ``seq2seq_chunk`` programs, as the reference counts
its jit compiles, and ``app_tpu_infer_latency{kind}`` records each flush.

Streaming seq2seq (``seq2seq_stream``) runs outside the batcher: the
encoder once, then ``t5_generate_chunk`` advances a ``[1, 1 + N]`` answer
buffer ``TPU_SEQ2SEQ_CHUNK`` steps a dispatch (default 8; ``N`` is
``TPU_SEQ2SEQ_MAX_NEW`` rounded up to a chunk multiple), with one host
read a chunk to see EOS. Its ids are the one-shot program's.
"""

from __future__ import annotations

import asyncio
import os
import time
from typing import Any, Optional

import numpy as np
import torch

from gofr_tpu_torch.analysis import lockcheck
from gofr_tpu_torch.device import resolve_device
from gofr_tpu_torch.models.vit import ViTConfig
from gofr_tpu_torch.ops.quant import params_quant_mode, quant_fn
from gofr_tpu_torch.serving.batcher import DynamicBatcher, pad_bucket
from gofr_tpu_torch.serving.device_telemetry import CompileTracker
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer
from gofr_tpu_torch.serving.types import _PREFILL_BUCKETS


class ModalityMixin:
    """Encoder / vision / seq2seq execution, their batcher, and the family
    dispatch of ``infer``."""

    def _init_batch_family(
        self, spec: Any, *, max_len: int, max_batch: int, max_wait_s: float,
        tokenizer: Any, params: Optional[dict], quant: str, seed: int,
        device: Any, hbm_budget_bytes: int, logger: Any, metrics: Any,
    ) -> None:
        """The constructor of an encoder, vision or seq2seq engine: weights
        (given, or from ``seed``), the programs, the batcher (started, as
        the LLM engine's scheduler is at construction) and the HBM ledger,
        built once. ``quant`` quantizes a seq2seq model's weights (given
        quantized weights keep their mode) and raises for the others, as
        in the reference."""
        if spec.family not in ("encoder", "vision", "seq2seq"):
            raise ValueError(f"unknown model family {spec.family}")
        quant = (quant or "").lower()
        if quant:
            quant_fn(quant)  # the reference's ValueError for any other mode
            if spec.family != "seq2seq":
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
        if params is not None:
            self.quant = params_quant_mode(params)
        self._running = False
        if quant and not self.quant:
            self.apply_quantization(quant)
        if self.family == "encoder":
            self.max_len = min(int(max_len), self.cfg.max_len)
            self._build_encoder_step()
            execute, name = self._execute_embed, "embed"
        elif self.family == "seq2seq":
            self.max_len = min(int(max_len), self.cfg.max_len)
            self._build_seq2seq_step()
            execute, name = self._execute_seq2seq, "seq2seq"
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
        self._state = "DOWN"
        self.start_sync()

    def _build_encoder_step(self) -> None:
        from gofr_tpu_torch.models.bert import bert_embed

        cfg = self.cfg
        self._embed_step = self._compiles.wrap(
            "embed", lambda params, tokens, mask: bert_embed(params, tokens, mask, cfg))

    def _build_seq2seq_step(self) -> None:
        """The one-shot program (``t5_generate`` of ``TPU_SEQ2SEQ_MAX_NEW``
        steps) and the streaming pair (``t5_encode``, then
        ``t5_generate_chunk`` of ``TPU_SEQ2SEQ_CHUNK`` steps over a buffer
        padded to a chunk multiple, so every dispatch has one shape)."""
        from gofr_tpu_torch.models.t5 import t5_encode, t5_generate, t5_generate_chunk

        cfg = self.cfg
        eos = self.spec.eos_token
        max_new = self._seq2seq_max_new = int(os.environ.get("TPU_SEQ2SEQ_MAX_NEW", "64"))
        chunk = self._seq2seq_chunk = max(1, int(os.environ.get("TPU_SEQ2SEQ_CHUNK", "8")))
        self._seq2seq_buf_len = ((max_new + chunk - 1) // chunk) * chunk
        self._seq2seq_step = self._compiles.wrap(
            "seq2seq", lambda params, tokens, lengths: t5_generate(
                params, tokens, lengths, cfg, max_new=max_new, eos_id=eos))
        self._seq2seq_encode = self._compiles.wrap(
            "seq2seq_encode", lambda params, tokens, lengths: t5_encode(
                params, tokens, lengths, cfg))
        # ``start`` comes as a host scalar tensor (the reference's traced
        # index): one program for every chunk position.
        self._seq2seq_chunk_step = self._compiles.wrap(
            "seq2seq_chunk", lambda params, buf, done, enc, lengths, start: t5_generate_chunk(
                params, buf, done, enc, lengths, int(start), cfg, chunk, eos))

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

    def _seq2seq_rows(self, texts: list) -> tuple[np.ndarray, np.ndarray]:
        """Inputs → right-padded token rows of one bucket and their
        lengths."""
        encoded = [
            self.tokenizer.encode(t)[: self.max_len] if isinstance(t, str) else list(t)
            for t in texts
        ]
        bucket = min(pad_bucket(max(max(len(e) for e in encoded), 1), _PREFILL_BUCKETS),
                     self.max_len)
        tokens = np.zeros((len(encoded), bucket), dtype=np.int64)
        lengths = np.zeros((len(encoded),), dtype=np.int64)
        for i, ids in enumerate(encoded):
            ids = ids[:bucket]
            tokens[i, : len(ids)] = ids
            lengths[i] = len(ids)
        return tokens, lengths

    def _execute_seq2seq(self, texts: list) -> list:
        tokens, lengths = self._seq2seq_rows(texts)
        t0 = time.time()
        with torch.inference_mode():
            out = self._seq2seq_step(self.params, torch.from_numpy(tokens).to(self.device),
                                     torch.from_numpy(lengths).to(self.device)).cpu().numpy()
        if self._metrics is not None:
            self._metrics.record_histogram(
                "app_tpu_infer_latency", time.time() - t0, "kind", "seq2seq"
            )
        eos = self.spec.eos_token
        results = []
        for row in out:
            ids = row.tolist()
            # Trim at EOS only: pad zeros exist solely after an emitted
            # EOS, and id 0 is a token a model may emit mid-sequence.
            if eos in ids:
                ids = ids[: ids.index(eos)]
            results.append(ids)
        return results

    # ------------------------------------------------------------------
    # seq2seq streaming (stepped decode, outside the batcher)
    # ------------------------------------------------------------------

    def seq2seq_stream_blocking(self, text: Any):
        """Stepped seq2seq decode: yields lists of fresh token ids, one list
        a chunk dispatch (EOS-trimmed; stops at EOS or ``max_new``). Its ids
        are ``seq2seq_sync``'s: both run the same decoder over the same
        masked buffer."""
        if self.family != "seq2seq":
            raise RuntimeError(f"model {self.model_name} is not a seq2seq model")
        tokens, lengths = self._seq2seq_rows([text])
        dev = self.device
        eos = self.spec.eos_token
        chunk = self._seq2seq_chunk
        emitted = 0
        t0 = time.time()
        # Inference mode is thread-local and a consumer may resume this
        # generator on another thread (seq2seq_stream's executor): it is
        # entered around each dispatch, never held across a yield.
        with torch.inference_mode():
            lengths_d = torch.from_numpy(lengths).to(dev)
            enc = self._seq2seq_encode(self.params, torch.from_numpy(tokens).to(dev), lengths_d)
            buf = torch.zeros((1, 1 + self._seq2seq_buf_len), dtype=torch.long, device=dev)
            done = torch.zeros((1,), dtype=torch.bool, device=dev)
        for start in range(0, self._seq2seq_buf_len, chunk):
            with torch.inference_mode():
                buf, done = self._seq2seq_chunk_step(
                    self.params, buf, done, enc, lengths_d, torch.tensor(start))
                # The designed sync point: each chunk's tokens reach the
                # host to see EOS before the next chunk is dispatched.
                toks = buf[0, start + 1: start + 1 + chunk].tolist()
            fresh, hit_eos = [], False
            for t in toks:
                if t == eos:
                    hit_eos = True
                    break
                fresh.append(int(t))
            fresh = fresh[: self._seq2seq_max_new - emitted]
            emitted += len(fresh)
            if fresh:
                yield fresh
            if hit_eos or emitted >= self._seq2seq_max_new:
                break
        if self._metrics is not None:
            self._metrics.record_histogram(
                "app_tpu_infer_latency", time.time() - t0, "kind", "seq2seq_stream"
            )

    async def seq2seq_stream(self, text: Any):
        """Async bridge over ``seq2seq_stream_blocking`` (the device waits
        run in the default executor, so the event loop stays live)."""
        loop = asyncio.get_running_loop()
        gen = self.seq2seq_stream_blocking(text)
        while True:
            toks = await loop.run_in_executor(None, next, gen, None)
            if toks is None:
                return
            yield toks

    # ------------------------------------------------------------------
    # encoder / vision / seq2seq APIs (dynamic batching)
    # ------------------------------------------------------------------

    def seq2seq_sync(self, text: Any, timeout: float = 120.0) -> list:
        """Text-to-text generation (T5): the generated ids, EOS-trimmed."""
        return self._batcher.submit(text).result(timeout=timeout)

    async def seq2seq(self, text: Any) -> list:
        return await asyncio.wrap_future(self._batcher.submit(text))

    async def seq2seq_text(self, text: Any) -> tuple:
        """(decoded text, token ids): the one dispatch-and-decode of
        ``ctx.infer``."""
        ids = await self.seq2seq(text)
        decoded = self.tokenizer.decode(ids) if self.tokenizer is not None else ""
        return decoded, ids

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
        if self.family == "seq2seq":
            text, ids = await self.seq2seq_text(inputs)
            return {"text": text, "token_ids": ids}
        vec = await self.classify(inputs)
        return {"logits": vec.tolist(), "class": int(np.argmax(vec))}

    def _batch_infer_sync(self, inputs: Any) -> dict:
        if self.family == "encoder":
            return {"embedding": self.embed_sync(inputs).tolist()}
        if self.family == "seq2seq":
            ids = self.seq2seq_sync(inputs)
            text = self.tokenizer.decode(ids) if self.tokenizer is not None else ""
            return {"text": text, "token_ids": ids}
        vec = self.classify_sync(inputs)
        return {"logits": vec.tolist(), "class": int(np.argmax(vec))}
