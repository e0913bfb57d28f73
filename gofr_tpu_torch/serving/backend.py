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
the reference's does. The reference's other call, for the encoder engine's
``TPU_EMBED_TOKENIZER`` (``new_tpu_embed_from_config``), waits for the
encoder families (ROADMAP Queue 1 item 5).
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
