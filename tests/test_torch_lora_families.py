"""Multi-LoRA on the other dense families, against the reference: the
four forwards with an adapter plane on NeoX (``neox-tiny``: the non-gated
MLP with biases, so ``w_up``/``w_down`` and their biases' order), a
Qwen2-shaped tiny (the QKV bias after each target's delta on its slice of
the fused ``wqkv``) and Gemma (``gemma-tiny``: GeGLU, an explicit head
dim), all in f32; and MoE, whose experts take no adapter (attention
deltas only). The helpers are ``tests/test_torch_lora.py``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import transformer as ref_tf
from gofr_tpu_torch.models import transformer as tf
from gofr_tpu_torch.weights import params_from_jax
from tests.test_torch_families import family_configs, family_weights
from tests.test_torch_lora import ALL, adapter_leaves, forwards_match_reference
from tests.test_torch_model import _np_tree


@pytest.mark.parametrize("name,targets", [
    ("neox-tiny", ("wq", "wv", "wo", "w_up", "w_down")),
    ("qwen2-tiny", ALL),
    ("gemma-tiny", ALL),
])
def test_family_forwards_with_aids_match_reference(name, targets):
    forwards_match_reference(name, "f32", targets)


def test_moe_forward_ignores_adapter_plane():
    """A MoE config's experts take no adapter: the forward with an aids
    plane and attention adapters equals the reference's (attention deltas
    only)."""
    ref_cfg, cfg = family_configs("moe-tiny", "f32")
    jparams, _ = family_weights(ref_cfg, cfg)
    leaves = adapter_leaves(ref_cfg, ("wq", "wo"))
    tree = _np_tree(jparams)
    tree = {**tree, "layers": {**tree["layers"], **leaves}}
    params = params_from_jax(tree, cfg, device="cpu")
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    aids = np.array([1, 0], np.int32)
    want = ref_tf.transformer_forward(jax.tree_util.tree_map(jnp.asarray, tree),
                                      jnp.asarray(tokens), ref_cfg, aids=jnp.asarray(aids))
    with torch.no_grad():
        got = tf.transformer_forward(params, torch.from_numpy(tokens).long(), cfg,
                                     aids=torch.from_numpy(aids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
