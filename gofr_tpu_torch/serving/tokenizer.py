"""Tokenizers of the serving engine — the port's copy of the reference's
``gofr_tpu/serving/tokenizer.py``.

The default is the self-contained byte-level tokenizer (``ByteTokenizer``:
ids 0..255 = raw bytes, 256 = BOS, 257 = EOS, 258 = PAD). With
``TPU_TOKENIZER=<directory>``, :func:`tokenizer_from_config` serves the
directory's ``tokenizer.json`` through the port's own reader
(``hf_tokenizer.HFTokenizer``: byte-level BPE on the native core) where
the reference loads it with ``transformers``; a directory it cannot read
is logged through ``logger.errorf`` and the byte tokenizer is served, as
the reference does when its load fails.
"""

from __future__ import annotations

from typing import Any, Sequence


class ByteTokenizer:
    bos_id = 256
    eos_id = 257
    pad_id = 258
    vocab_size = 259

    def encode(self, text: str) -> list[int]:
        return [self.bos_id] + list(text.encode("utf-8"))

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(i for i in ids if 0 <= i < 256)
        return data.decode("utf-8", "replace")


def tokenizer_from_config(config: Any, logger: Any = None) -> Any:
    """An ``HFTokenizer`` for ``TPU_TOKENIZER``, else a ``ByteTokenizer``."""
    path = config.get_or_default("TPU_TOKENIZER", "")
    if path:
        try:
            from gofr_tpu_torch.serving.hf_tokenizer import HFTokenizer

            return HFTokenizer(path)
        except Exception as exc:  # noqa: BLE001 — the reference's fallback
            if logger is not None:
                logger.errorf(
                    "could not load tokenizer %s (%s); using byte tokenizer",
                    path,
                    exc,
                )
    return ByteTokenizer()
