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
    """The window's rules, as the reference's: a window without causal
    attention raises, one that cannot bind (window >= s_kv) is dropped, and
    a binding one is computed (no longer refused)."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(6, 1, 32, 32, 4, 2, 32))
    with pytest.raises(ValueError, match="causal"):
        port.attention(q, k, v, causal=False, window=8)
    a = port.attention(q, k, v, window=32)  # cannot bind: plain causal
    torch.testing.assert_close(a, port.attention(q, k, v), rtol=0, atol=0)
    torch.testing.assert_close(
        port.attention(q, k, v, window=8),
        fa.flash_attention_plain(q, k, v, causal=True, window=8), rtol=0, atol=0)
    with pytest.raises(ValueError):
        port.attention(q, k, v, mask=torch.ones(1, 32, 32, dtype=torch.bool),
                       lengths=torch.tensor([3], dtype=torch.int32))


WINDOW_CASES = [
    # b, s_q, s_kv, n_heads, n_kv, hd, lengths, window (causal)
    (2, 64, 64, 4, 2, 32, None, 16),            # GQA, blocks below the edge
    (2, 50, 103, 4, 2, 32, None, 20),           # causal offset 53
    (3, 50, 50, 4, 2, 32, [50, 17, 0], 8),      # lengths: full, short, empty
    (2, 40, 40, 2, 2, 32, [40, 5], 10),         # rows 14+ of row 1 see nothing
    (1, 33, 33, 2, 1, 64, None, 1),             # each query sees itself only
]
WINDOW_IDS = ["gqa", "offset", "lengths", "empty_rows", "window_1"]


@pytest.mark.parametrize("b,s_q,s_kv,n_heads,n_kv,hd,lengths,window", WINDOW_CASES,
                         ids=WINDOW_IDS)
def test_windowed_plain_and_attention_match_the_pallas_kernel(
    b, s_q, s_kv, n_heads, n_kv, hd, lengths, window
):
    """f32 at TOL against the reference's windowed Pallas kernel (interpret
    mode), with and without per-row lengths; ``attention(window=)`` is the
    plain version exactly on CPU tensors, and so is its dense path
    (kernel=False) on rows that see a key."""
    q, k, v = _inputs(7, b, s_q, s_kv, n_heads, n_kv, hd)
    lens = None if lengths is None else jnp.asarray(np.array(lengths, np.int32))
    want = np.asarray(ref_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), lens, causal=True,
        block_q=16, block_k=16, window=window, interpret=True,
    ))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tl = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    plain = fa.flash_attention_plain(tq, tk, tv, tl, causal=True, window=window)
    np.testing.assert_allclose(plain.numpy(), want, atol=TOL, rtol=TOL)
    via = port.attention(tq, tk, tv, lengths=tl, window=window)
    torch.testing.assert_close(via, plain, rtol=0, atol=0)
    vis = fa.visible_keys(b, s_q, s_kv, causal=True, lengths=tl, window=window)
    vis = vis.any(-1).expand(b, s_q).numpy()
    assert np.all(plain.numpy()[~vis] == 0.0)
    dense = port.attention(tq, tk, tv, lengths=tl, window=window, kernel=False)
    ref_dense = np.asarray(ref_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), lengths=lens,
        window=window, kernel=False))
    np.testing.assert_allclose(dense.numpy()[vis], ref_dense[vis], atol=TOL, rtol=TOL)


@pytest.mark.parametrize(
    "b,s_q,s_kv,n_heads,n_kv,hd,window",
    [(1, 40, 40, 4, 2, 32, 8), (1, 16, 40, 4, 2, 32, 12)],
    ids=["gqa", "offset"],
)
def test_windowed_flash_attention_fn_gradients_match_jax(b, s_q, s_kv, n_heads, n_kv, hd,
                                                         window):
    """FlashAttentionFn carries the window into its kernel forward and its
    dense-recompute backward, as ``_flash_attention_ad`` does: f32
    gradients against ``jax.grad`` of the reference at GRAD_TOL."""
    q, k, v = _inputs(8, b, s_q, s_kv, n_heads, n_kv, hd)
    w = np.random.default_rng(9).standard_normal(q.shape).astype(np.float32)

    def ref_loss(q, k, v):
        return jnp.sum(_flash_attention_ad(q, k, v, True, None, window) * w)

    ref_grads = jax.grad(ref_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    )
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = port.attention(tq, tk, tv, window=window)
    (out * torch.from_numpy(w)).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), ref_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=GRAD_TOL, rtol=GRAD_TOL)
    # The window binds: the unwindowed gradients differ.
    tq2 = torch.from_numpy(q).requires_grad_(True)
    (port.attention(tq2, tk.detach(), tv.detach()) * torch.from_numpy(w)).sum().backward()
    assert not torch.allclose(tq2.grad, tq.grad, atol=1e-3)
