"""TPU backend container member — the port's copy of
``gofr_tpu/serving/backend.py::new_tpu_from_config``, the single-engine
path.

``new_tpu_from_config`` is the container seam, gated on ``TPU_MODEL``. It
differs from the reference in one deliberate way: the reference logs an
engine that fails to build and returns ``None`` (the App then serves with
no engine); here the error propagates, so an App whose engine cannot be
built — for example with no CUDA and no ``TPU_DEVICE=cpu`` — raises at
construction instead of answering every request "no TPU engine
configured". The replica pool (``TPU_REPLICAS > 1``,
``TPU_REPLICA_ADDRS``) is not ported yet and raises.

The engine's tokenizer (``TPU_TOKENIZER``) comes through
``InferenceEngine.from_config``, which calls ``tokenizer_from_config`` as
the reference's does.

``new_tpu_embed_from_config`` is the secondary encoder engine
(``TPU_EMBED_MODEL``), so one App serves chat from the primary engine and
``/v1/embeddings`` from an encoder. It keeps the reference's family check,
its own tokenizer (``TPU_EMBED_TOKENIZER``, else the byte tokenizer: the
chat model's vocabulary would index outside BERT's table), the batcher
keys and ``TPU_EMBED_CHECKPOINT``; ``TPU_DEVICE`` places it, as it places
the primary. As there, an encoder that cannot be built raises where the
reference logs and returns ``None``. A BERT ``tokenizer.json`` (WordPiece)
is read by the port's own reader, as any ``TPU_TOKENIZER``.
"""

from __future__ import annotations

from typing import Any, Optional

_POOL_ITEM = "ROADMAP Queue 1 item 7: the replica pool"


def new_tpu_from_config(
    config: Any, logger: Any = None, metrics: Any = None
) -> Optional[object]:
    model = config.get_or_default("TPU_MODEL", "")
    if not model:
        return None
    n_replicas = int(config.get_or_default("TPU_REPLICAS", "1"))
    remote_addrs = [
        a.strip()
        for a in config.get_or_default("TPU_REPLICA_ADDRS", "").split(",")
        if a.strip()
    ]
    if n_replicas > 1 or remote_addrs:
        raise NotImplementedError(
            f"TPU_REPLICAS={n_replicas} / TPU_REPLICA_ADDRS={remote_addrs} "
            f"is not ported yet ({_POOL_ITEM})"
        )
    from gofr_tpu_torch.serving.engine import InferenceEngine

    engine = InferenceEngine.from_config(config, logger=logger, metrics=metrics)
    if logger is not None:
        logger.infof("TPU backend initialised with model %s", model)
    return engine


def new_tpu_embed_from_config(
    config: Any, logger: Any = None, metrics: Any = None
) -> Optional[object]:
    """The secondary encoder engine of ``TPU_EMBED_MODEL`` (None when
    unset)."""
    model = config.get_or_default("TPU_EMBED_MODEL", "")
    if not model:
        return None
    from gofr_tpu_torch.device import resolve_device
    from gofr_tpu_torch.models.registry import get_model
    from gofr_tpu_torch.serving.checkpoint import restore_checkpoint
    from gofr_tpu_torch.serving.engine import InferenceEngine
    from gofr_tpu_torch.serving.tokenizer import ByteTokenizer, tokenizer_from_config

    spec = get_model(model)
    if spec.family != "encoder":
        raise ValueError(
            f"TPU_EMBED_MODEL={model!r} is family {spec.family!r}, "
            f"need an encoder (e.g. bert-base)"
        )
    tok_path = config.get_or_default("TPU_EMBED_TOKENIZER", "")
    if tok_path:
        tokenizer = tokenizer_from_config(_Overlay(config, {"TPU_TOKENIZER": tok_path}), logger)
    else:
        tokenizer = ByteTokenizer()
    engine = InferenceEngine(
        model,
        max_batch=int(config.get_or_default("TPU_MAX_BATCH", "8")),
        max_wait_s=float(config.get_or_default("TPU_BATCH_WAIT_MS", "5")) / 1e3,
        max_len=int(config.get_or_default("TPU_MAX_LEN", "1024")),
        device=resolve_device(config.get_or_default("TPU_DEVICE", "") or None),
        logger=logger,
        metrics=metrics,
        tokenizer=tokenizer,
    )
    ckpt = config.get_or_default("TPU_EMBED_CHECKPOINT", "")
    if ckpt:
        try:
            engine.params = restore_checkpoint(ckpt, like=engine.params)
        except BaseException:
            engine.close()  # its batcher runs already
            raise
        if logger is not None:
            logger.infof("restored embed params from %s", ckpt)
    if logger is not None:
        logger.infof("TPU embed backend initialised with model %s", model)
    return engine


class _Overlay:
    """Config view with a few keys overridden (keeps the Config protocol)."""

    def __init__(self, base: Any, overrides: dict) -> None:
        self._base, self._overrides = base, overrides

    def get(self, key: str) -> Any:
        if key in self._overrides:
            return self._overrides[key]
        return self._base.get(key)

    def get_or_default(self, key: str, default: str) -> str:
        if key in self._overrides:
            return self._overrides[key]
        return self._base.get_or_default(key, default)
