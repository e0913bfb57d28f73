"""Mixtral's MoE FFN in the port's serving forwards against the
reference: two prefill chunks then three decode steps
(tests/test_torch_families.py's helper, the reference's cache state
carried over) on ``moe-tiny`` and its f32 twin, on the slot cache, a
shuffled B=16 pool and an int8 cache, and with int8 experts. The routing
is pinned to the reference's at router near-ties, and the tolerances are
those of tests/test_torch_moe.py.
"""

import pytest

from tests.test_torch_families import TOL, chunk_then_decode_matches_reference, family_configs
from tests.test_torch_moe import (  # noqa: F401 (fixtures)
    _weights,
    pinned_routing,
    recorded_reference_routing,
)

# The MoE FFN is the same code on every cache: each cache kind once, in
# the dtype whose tolerance is tightest for it.
CASES = [("bf16", "slot"), ("f32", "slot"), ("f32", "pool"), ("bf16", "int8")]


@pytest.mark.parametrize("dtype,variant", CASES, ids=[f"{d}-{v}" for d, v in CASES])
def test_chunk_then_decode_match_reference(dtype, variant, pinned_routing):
    ref_cfg, cfg = family_configs("moe-tiny", dtype)
    tree, params = _weights(ref_cfg, cfg)
    chunk_then_decode_matches_reference(ref_cfg, cfg, tree, params, variant, TOL[dtype])


def test_int8_experts_chunk_then_decode_match_reference(pinned_routing):
    """The f32 twin with the reference's int8 weights (experts included)."""
    ref_cfg, cfg = family_configs("moe-tiny", "f32")
    tree, params = _weights(ref_cfg, cfg, mode="int8")
    chunk_then_decode_matches_reference(ref_cfg, cfg, tree, params, "slot", TOL["f32"])
