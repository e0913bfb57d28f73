"""Checkpoints in torch's format (``gofr_tpu_torch/serving/checkpoint.py``):
save/restore round trips of a bf16, an int8 and an int4 parameter tree
(bit for bit, each leaf's kind, dtype and shape), a file that
``torch.load(weights_only=True)`` reads alone, ``restore_checkpoint``'s
layout check against ``like``, and ``maybe_restore_params`` keeping the
params it was given on a bad path with an error-level log line, as the
reference's does; and ``from_config`` restoring a file through
``TPU_CHECKPOINT`` (then ``TPU_QUANT``).
"""

import numpy as np
import pytest
import torch

from gofr_tpu.config import MockConfig as RefMockConfig
from gofr_tpu.serving.checkpoint import maybe_restore_params as ref_maybe_restore
from gofr_tpu_torch.config import MockConfig
from gofr_tpu_torch.models.registry import get_model
from gofr_tpu_torch.models.transformer import init_params
from gofr_tpu_torch.ops import quant
from gofr_tpu_torch.serving.checkpoint import (
    maybe_restore_params,
    restore_checkpoint,
    save_checkpoint,
)
from gofr_tpu_torch.serving.engine import InferenceEngine

MODEL = "llama-tiny"


def _same(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        assert type(g) is type(w), k
        for a, b in ((g.q, w.q), (g.s, w.s)) if quant.is_quantized(w) else ((g, w),):
            assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), k


class _Log:
    def __init__(self):
        self.lines = []

    def infof(self, fmt, *args):
        self.lines.append(("info", fmt % args))

    def errorf(self, fmt, *args):
        self.lines.append(("error", fmt % args))


@pytest.mark.parametrize("mode", ["", "int8", "int4"], ids=["bf16", "int8", "int4"])
def test_round_trip_bit_for_bit(tmp_path, mode):
    params = init_params(get_model(MODEL).config, 1, "cpu", quant=mode)
    path = str(tmp_path / "ckpt" / "params.pt")
    save_checkpoint(path, params)
    _same(restore_checkpoint(path), params)
    _same(restore_checkpoint(path, like=params), params)
    # Only tensors, dicts and strings: the file loads with weights_only alone.
    raw = torch.load(path, weights_only=True)
    if mode:
        assert raw["wqkv"]["quant"] == mode and raw["wqkv"]["q"].dtype in (torch.int8,
                                                                            torch.uint8)
    with pytest.raises(FileExistsError):
        save_checkpoint(path, params, force=False)
    save_checkpoint(path, params, force=True)


def test_restore_checks_the_layout_of_like(tmp_path):
    """A restore onto ``like`` refuses other leaves, kinds, shapes or
    dtypes: an int8 save does not restore over plain weights (the
    reference restores, then quantizes)."""
    cfg = get_model(MODEL).config
    params = init_params(cfg, 1, "cpu")
    path = str(tmp_path / "p.pt")
    save_checkpoint(path, params)
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(path, like={k: v for k, v in params.items() if k != "embed"})
    with pytest.raises(ValueError, match="wo is"):
        restore_checkpoint(path, like=dict(params, wo=params["wo"].float()))
    q8 = quant.quantize_params(params, "int8")
    save_checkpoint(path, q8)
    with pytest.raises(ValueError, match="wqkv is a Q8, expected a Tensor"):
        restore_checkpoint(path, like=params)
    _same(restore_checkpoint(path, like=q8), q8)


def test_maybe_restore_keeps_params_on_a_bad_path(tmp_path):
    """No TPU_CHECKPOINT: the params as they are, no log. A path that does
    not load: one error-level line naming it, and the params as they were,
    in the port as in the reference. A good one: restored, logged at info."""
    params = init_params(get_model(MODEL).config, 1, "cpu")
    log = _Log()
    assert maybe_restore_params(MockConfig({}), params, log) is params and not log.lines
    bad = str(tmp_path / "missing.pt")
    for maybe, config in ((ref_maybe_restore, RefMockConfig({"TPU_CHECKPOINT": bad})),
                          (maybe_restore_params, MockConfig({"TPU_CHECKPOINT": bad}))):
        log = _Log()
        sentinel = {"w": np.zeros(3)} if maybe is ref_maybe_restore else params
        assert maybe(config, sentinel, log) is sentinel
        assert len(log.lines) == 1 and log.lines[0][0] == "error"
        assert log.lines[0][1].startswith(f"could not restore checkpoint {bad}: ")
    good = str(tmp_path / "good.pt")
    other = init_params(get_model(MODEL).config, 2, "cpu")
    save_checkpoint(good, other)
    log = _Log()
    _same(maybe_restore_params(MockConfig({"TPU_CHECKPOINT": good}), params, log), other)
    assert log.lines == [("info", f"restored model params from {good}")]


@pytest.mark.parametrize("quant_mode", ["", "int8"], ids=["bf16", "int8"])
def test_from_config_restores_a_checkpoint_file(tmp_path, quant_mode):
    """TPU_CHECKPOINT naming a file: the engine serves the saved weights
    (quantized by TPU_QUANT after the restore), the same stream as an
    engine given those weights directly."""
    cfg = get_model(MODEL).config
    saved = init_params(cfg, 5, "cpu")
    path = str(tmp_path / "params.pt")
    save_checkpoint(path, saved)
    keys = {"TPU_MODEL": MODEL, "TPU_DEVICE": "cpu", "TPU_KV_SLOTS": "2", "TPU_MAX_LEN": "64",
            "TPU_SPEC_TOKENS": "0", "TPU_CHECKPOINT": path, "TPU_QUANT": quant_mode}
    gen = dict(max_new_tokens=6, temperature=0.0, stop_on_eos=False)
    eng = InferenceEngine.from_config(MockConfig(keys))
    try:
        assert eng.quant == quant_mode
        want_params = quant.quantize_params(saved, quant_mode) if quant_mode else saved
        _same(eng.params, want_params)
        got = eng.generate_sync([1, 2, 3, 4], **gen).token_ids
    finally:
        eng.close()
    direct = InferenceEngine(MODEL, device="cpu", n_slots=2, max_len=64, params=saved,
                             quant=quant_mode)
    try:
        assert direct.generate_sync([1, 2, 3, 4], **gen).token_ids == got
    finally:
        direct.close()
