"""The port's full-sequence attention (``gofr_tpu_torch.ops.attention.
attention`` and the plain version of its kernel, ``flash_attention_plain``)
against the reference's Pallas ``flash_attention`` (interpret mode, as the
reference's own tests run it on the CPU) and against the gradients of its
``_flash_attention_ad`` (the interpret kernel plus the dense VJP), on the
same numpy inputs. The CUDA kernel itself is held against the plain
version under emulation (``test_torch_cuda_emulation.py``) and on a card
(``test_torch_gpu.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.ops.attention import _flash_attention_ad
from gofr_tpu.ops.attention import attention as ref_attention
from gofr_tpu.ops.pallas import flash_attention as ref_flash_attention
from gofr_tpu_torch.ops import attention as port
from gofr_tpu_torch.ops.cuda import flash_attention as fa
from gofr_tpu_torch.ops.cuda import launch_counts

# f32 on both sides, the same online-vs-dense softmax algebra in another
# order: the reference's own kernel tests hold interpret mode to 2e-5.
TOL = 2e-5
# bf16: the reference's own bf16 kernel-vs-dense tolerance
# (tests/test_pallas_kernels.py::test_flash_attention_bf16) — the kernel
# keeps f32 probabilities where the dense formula rounds them to bf16, and
# outputs of magnitude ~1 round to bf16 (2**-8 relative).
BF16_TOL = 3e-2
# Gradients in f32: both sides differentiate the same dense formula; a
# gradient sums over up to s_q rows, so a little above the forward's 2e-5.
GRAD_TOL = 1e-4

CASES = [
    # b, s_q, s_kv, n_heads, n_kv, hd, causal, lengths
    (2, 64, 64, 4, 4, 32, True, None),              # MHA, on the block
    (2, 50, 50, 4, 2, 32, True, None),              # GQA, off the block
    (2, 50, 103, 4, 2, 32, True, None),             # causal offset 53
    (1, 40, 24, 2, 2, 32, True, None),              # negative offset: rows see nothing
    (2, 103, 103, 4, 1, 64, False, None),           # non-causal MQA
    (3, 50, 50, 4, 2, 32, True, [50, 17, 0]),       # lengths: full, short, empty
    (3, 40, 40, 4, 2, 64, False, [0, 40, 13]),      # non-causal lengths
]
IDS = ["mha", "gqa_off_block", "offset", "neg_offset", "noncausal_mqa",
       "lengths", "noncausal_lengths"]


def _inputs(seed, b, s_q, s_kv, n_heads, n_kv, hd):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, s_q, n_heads, hd)).astype(np.float32),
        rng.standard_normal((b, s_kv, n_kv, hd)).astype(np.float32),
        rng.standard_normal((b, s_kv, n_kv, hd)).astype(np.float32),
    )


def _ref_kernel(q, k, v, lengths, causal):
    lens = None if lengths is None else jnp.asarray(np.array(lengths, np.int32))
    return np.asarray(ref_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), lens, causal=causal,
        block_q=32, block_k=32, interpret=True,
    ).astype(jnp.float32))


@pytest.mark.parametrize("b,s_q,s_kv,n_heads,n_kv,hd,causal,lengths", CASES, ids=IDS)
def test_plain_and_attention_match_the_pallas_kernel(
    b, s_q, s_kv, n_heads, n_kv, hd, causal, lengths
):
    q, k, v = _inputs(0, b, s_q, s_kv, n_heads, n_kv, hd)
    want = _ref_kernel(q, k, v, lengths, causal)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tl = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    before = launch_counts()
    plain = fa.flash_attention_plain(tq, tk, tv, tl, causal=causal)
    via_attention = port.attention(tq, tk, tv, causal=causal, lengths=tl)
    np.testing.assert_allclose(plain.numpy(), want, atol=TOL, rtol=TOL)
    torch.testing.assert_close(via_attention, plain, rtol=0, atol=0)
    assert launch_counts() == before  # CPU tensors launch no kernel
    # Rows that see no key are exactly 0; rows past a length that still
    # see keys (causal padding queries) are not.
    vis = fa.visible_keys(b, s_q, s_kv, causal=causal, lengths=tl).any(-1)
    vis = vis.expand(b, s_q).numpy()
    assert np.all(plain.numpy()[~vis] == 0.0)
    assert np.all(np.abs(plain.numpy()[vis]).max(axis=(-1, -2)) > 0)


@pytest.mark.parametrize("lengths", [None, [64, 9]], ids=["causal", "lengths"])
def test_plain_bf16_matches_the_pallas_kernel(lengths):
    q, k, v = _inputs(1, 2, 64, 64, 4, 2, 64)
    bf = [torch.from_numpy(a).bfloat16() for a in (q, k, v)]
    # The same bf16-rounded values on both sides.
    q, k, v = (t.float().numpy() for t in bf)
    want = np.asarray(ref_flash_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
        None if lengths is None else jnp.asarray(np.array(lengths, np.int32)),
        causal=True, block_q=32, block_k=32, interpret=True,
    ).astype(jnp.float32))
    tl = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    got = fa.flash_attention_plain(*bf, tl)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize(
    "b,s_q,s_kv,n_heads,n_kv,hd,causal",
    [
        (1, 40, 40, 4, 2, 32, True),     # GQA causal (training's shape)
        (1, 24, 24, 2, 2, 32, False),    # non-causal
        (1, 16, 40, 4, 2, 32, True),     # causal suffix (offset 24)
    ],
    ids=["gqa_causal", "noncausal", "offset"],
)
def test_flash_attention_fn_gradients_match_jax(b, s_q, s_kv, n_heads, n_kv, hd, causal):
    q, k, v = _inputs(2, b, s_q, s_kv, n_heads, n_kv, hd)
    w = np.random.default_rng(3).standard_normal(q.shape).astype(np.float32)

    def ref_loss(q, k, v):
        return jnp.sum(_flash_attention_ad(q, k, v, causal, None) * w)

    ref_grads = jax.grad(ref_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    )
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = port.FlashAttentionFn.apply(tq, tk, tv, causal, None)
    (out * torch.from_numpy(w)).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), ref_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=GRAD_TOL, rtol=GRAD_TOL)


def test_mask_takes_the_reference_dense_formula():
    q, k, v = _inputs(4, 2, 32, 32, 4, 2, 32)
    mask = np.random.default_rng(5).random((2, 32, 32)) < 0.7
    mask[:, :, 0] = True
    want = np.asarray(ref_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jnp.asarray(mask),
        kernel=False,
    ))
    got = port.attention(
        *(torch.from_numpy(a) for a in (q, k, v)), mask=torch.from_numpy(mask)
    )
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_window_raises_unless_it_cannot_bind():
    q, k, v = (torch.from_numpy(a) for a in _inputs(6, 1, 32, 32, 4, 2, 32))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port.attention(q, k, v, window=8)
    a = port.attention(q, k, v, window=32)  # cannot bind: plain causal
    torch.testing.assert_close(a, port.attention(q, k, v), rtol=0, atol=0)
    with pytest.raises(ValueError):
        port.attention(q, k, v, mask=torch.ones(1, 32, 32, dtype=torch.bool),
                       lengths=torch.tensor([3], dtype=torch.int32))
