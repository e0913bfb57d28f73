"""The port's training slice (``transformer_forward``, ``transformer_prefill``,
``make_train_step``) against the reference on the same weights and tokens,
all on the CPU.

The reference side runs once per config in a module-scoped fixture: its own
``make_train_step`` on a one-device mesh (``make_mesh({"dp": 1})``), whose
``init_state`` params cross to the port through ``params_from_jax(...,
dtype=torch.float32)`` (f32 masters, unrounded), three steps on one batch,
and the step-1 gradients of the same loss (``jax.grad``). The reference's
attention takes its dense formula on the CPU; the port takes the plain
version of its kernel there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gofr_tpu.models.registry import get_model as ref_get_model
from gofr_tpu.models.transformer import init_transformer
from gofr_tpu.models.transformer import transformer_forward as ref_forward
from gofr_tpu.models.transformer import transformer_prefill as ref_prefill
from gofr_tpu.ops.kv_cache import KVCache as RefKVCache
from gofr_tpu.parallel import make_mesh
from gofr_tpu.parallel import make_train_step as ref_make_train_step
from gofr_tpu.parallel.sharding import cross_entropy_loss as ref_cross_entropy
from gofr_tpu_torch.models.registry import get_model
from gofr_tpu_torch.models.transformer import transformer_forward, transformer_prefill
from gofr_tpu_torch.ops.kv_cache import KVCache
from gofr_tpu_torch.parallel.sharding import (
    AdamW,
    cross_entropy_loss,
    loss_and_grads,
    make_train_step,
)
from gofr_tpu_torch.weights import params_from_jax, params_to_reference

NAMES = ["llama-tiny-f32", "llama-tiny"]
LR = 3e-4
B, S = 2, 24

# Logits (forward, prefill): as tests/test_torch_model.py — f32 agrees to
# ~1e-6 relative over 2 layers; bf16 differs by a few bf16 ulps (2**-7)
# on logits of magnitude ~1 (rounding at other places in the two
# frameworks).
LOGIT_TOL = {"llama-tiny-f32": 1e-4, "llama-tiny": 6e-2}
# Per-step losses, relative: f32 read <= 2.2e-7; bf16 compute (f32
# masters) read <= 5.7e-4 over two batches (bf16 rounding of logits of
# magnitude ~1, at other places in the two frameworks).
LOSS_RTOL = {"llama-tiny-f32": 1e-5, "llama-tiny": 2e-3}
# Step-1 gradients, per leaf ||port - ref|| / ||ref||: f32 read <= 1.2e-6;
# bf16 read <= 1.4e-2.
GRAD_RTOL = {"llama-tiny-f32": 1e-5, "llama-tiny": 3e-2}
# Params after three AdamW steps, per leaf, in units of the learning rate
# (a first Adam step is ~lr * sign(g)). f32: mean |diff| read <= 3.1e-6 lr,
# so 1e-4 lr, which a weight decay of 1e-2 instead of optax's 1e-4 breaks
# (it shifts the mean by >= 1.5e-3 lr); max |diff| read 0.048 lr, on the
# few elements whose gradient is near Adam's eps, so 0.1 lr. bf16: rounding
# flips the sign of small gradients, so only the mean is bounded: read
# <= 0.029 lr, limit 0.1 lr.
PARAM_MEAN_TOL = {"llama-tiny-f32": 1e-4, "llama-tiny": 0.1}
PARAM_MAX_TOL = {"llama-tiny-f32": 0.1, "llama-tiny": None}


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _leaves(tree):
    return [(jax.tree_util.keystr(p), a) for p, a in jax.tree_util.tree_leaves_with_path(tree)]


@pytest.fixture(scope="module")
def ref():
    runs = {}
    rng = np.random.default_rng(0)
    for name in NAMES:
        cfg = ref_get_model(name).config
        tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        init_state, step, _ = ref_make_train_step(cfg, make_mesh({"dp": 1}), learning_rate=LR)
        params, opt_state = init_state(jax.random.PRNGKey(0))
        p0 = _np_tree(params)

        def loss(p):
            p = jax.tree_util.tree_map(lambda x: x.astype(cfg.dtype), p)
            logits = ref_forward(p, jnp.asarray(tokens), cfg)
            return ref_cross_entropy(logits[:, :-1], jnp.asarray(tokens)[:, 1:])

        grads1 = _np_tree(jax.grad(loss)(params))
        losses = []
        for _ in range(3):  # the step donates params: p0 was copied first
            value, params, opt_state = step(params, opt_state, jnp.asarray(tokens))
            losses.append(float(value))
        runs[name] = dict(tokens=tokens, p0=p0, grads1=grads1, losses=losses,
                          p3=_np_tree(params))
    return runs


def _port_params(ref, name, dtype=torch.float32):
    return params_from_jax(ref[name]["p0"], get_model(name).config, device="cpu", dtype=dtype)


@pytest.mark.parametrize("name", NAMES)
def test_transformer_forward_matches_reference(ref, name):
    cfg, ref_cfg = get_model(name).config, ref_get_model(name).config
    jparams = init_transformer(jax.random.PRNGKey(1), ref_cfg)
    params = params_from_jax(_np_tree(jparams), cfg, device="cpu")
    tokens = ref[name]["tokens"]
    want = np.asarray(ref_forward(jparams, jnp.asarray(tokens), ref_cfg))
    got = transformer_forward(params, torch.from_numpy(tokens).long(), cfg)
    assert got.dtype == torch.float32 and got.shape == (B, S, cfg.vocab_size)
    tol = LOGIT_TOL[name]
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=tol)


@pytest.fixture(scope="module")
def emulated_flash_attention(tmp_path_factory):
    """The port's ``flash_attention`` with its CUDA kernels run under the
    CPU emulator of ``tests/test_torch_cuda_emulation.py``: the wgmma kernel
    for bf16 (hd 32 on a 64-column panel) and the CUDA-core kernel of
    ``csrc/attn_f32.cu`` for f32, q/k/v read through their strides."""
    import ctypes

    from tests.test_torch_cuda_emulation import CSRC, _emulate

    lib = _emulate({stem: (CSRC / f"{stem}.cu").read_text()
                    for stem in ("flash_attention", "attn_f32")},
                   tmp_path_factory.mktemp("cuda_emu_train"))

    def flash_attention(q, k, v, lengths=None, *, causal=True, scale=None, window=0):
        b, s_q, n_heads, hd = q.shape
        s_kv, n_kv = k.shape[1], k.shape[2]
        out = torch.full((b, s_q, n_heads, hd), float("nan"), dtype=q.dtype)
        strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
        entry = (lib.gofr_flash_attention_f32 if q.dtype == torch.float32
                 else lib.gofr_flash_attention)
        rc = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   None if lengths is None else lengths.data_ptr(), out.data_ptr(), b, s_q,
                   s_kv, n_heads, n_kv, hd, int(causal), window, strides,
                   hd**-0.5 if scale is None else scale, None)
        assert rc == 0
        return out

    return flash_attention


@pytest.mark.parametrize("name", NAMES)
def test_emulated_kernels_forward_and_prefill_match_reference(
    ref, name, emulated_flash_attention, monkeypatch
):
    """llama-tiny-f32 (the f32 kernel) and llama-tiny (bf16, hd 32: the
    wgmma kernel on a padded panel) through ``transformer_forward`` and
    ``transformer_prefill`` (lengths 16, 7, 1) with ``flash_attention``'s
    CUDA code run under the emulator, against the reference's logits."""
    import gofr_tpu_torch.ops.attention as port_attention

    monkeypatch.setattr(port_attention, "flash_attention", emulated_flash_attention)
    cfg, ref_cfg = get_model(name).config, ref_get_model(name).config
    jparams = init_transformer(jax.random.PRNGKey(1), ref_cfg)
    params = params_from_jax(_np_tree(jparams), cfg, device="cpu")
    tokens = ref[name]["tokens"]
    tol = LOGIT_TOL[name]
    want = np.asarray(ref_forward(jparams, jnp.asarray(tokens), ref_cfg))
    got = transformer_forward(params, torch.from_numpy(tokens).long(), cfg)
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)
    prompt = np.resize(tokens, (3, 16)).astype(np.int32)
    lengths = np.array([16, 7, 1], np.int32)
    slots = np.array([2, 0, 3], np.int32)
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    ref_cache = RefKVCache.create(L, 4, 32, KV, hd, dtype=ref_cfg.dtype)
    want, _ = ref_prefill(jparams, jnp.asarray(prompt), jnp.asarray(lengths), ref_cache,
                          jnp.asarray(slots), ref_cfg)
    got = transformer_prefill(params, torch.from_numpy(prompt).long(), torch.from_numpy(lengths),
                              KVCache.create(L, 4, 32, KV, hd, dtype=cfg.dtype),
                              torch.from_numpy(slots), cfg)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("name", NAMES)
def test_transformer_prefill_matches_reference(name):
    """Right-padded rows of lengths 16, 7 and 1 into slots 2, 0 and 3 of a
    4-slot cache: last-token logits, every written cache row (prefix,
    padding positions and the zeroed tail) and the slot lengths."""
    cfg, ref_cfg = get_model(name).config, ref_get_model(name).config
    jparams = init_transformer(jax.random.PRNGKey(2), ref_cfg)
    params = params_from_jax(_np_tree(jparams), cfg, device="cpu")
    L, KV, hd, n_slots, max_len, s = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, 4, 32, 16
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (3, s)).astype(np.int32)
    lengths = np.array([16, 7, 1], np.int32)
    slots = np.array([2, 0, 3], np.int32)
    ref_cache = RefKVCache.create(L, n_slots, max_len, KV, hd, dtype=ref_cfg.dtype)
    want, ref_cache = ref_prefill(
        jparams, jnp.asarray(tokens), jnp.asarray(lengths), ref_cache,
        jnp.asarray(slots), ref_cfg,
    )
    cache = KVCache.create(L, n_slots, max_len, KV, hd, dtype=cfg.dtype)
    cache.k.fill_(7.0)  # stale contents the prefill must overwrite
    got = transformer_prefill(
        params, torch.from_numpy(tokens).long(), torch.from_numpy(lengths), cache,
        torch.from_numpy(slots), cfg,
    )
    tol = LOGIT_TOL[name]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=tol)
    for buf, ref_buf in ((cache.k, ref_cache.k), (cache.v, ref_cache.v)):
        np.testing.assert_allclose(
            buf[:, slots].float().numpy(),
            np.asarray(ref_buf[:, slots], dtype=np.float32), atol=tol, rtol=tol,
        )
    np.testing.assert_array_equal(cache.lengths.numpy()[slots], lengths)


@pytest.mark.parametrize("name", NAMES)
def test_three_train_steps_match_reference(ref, name):
    cfg = get_model(name).config
    run = ref[name]
    init_state, train_step, optimizer = make_train_step(cfg, learning_rate=LR, device="cpu")
    params = _port_params(ref, name)
    assert all(p.dtype == torch.float32 for p in params.values())
    opt_state = optimizer.init(params)
    tokens = torch.from_numpy(run["tokens"])

    _, grads = loss_and_grads(params, tokens.long(), cfg)
    assert all(grads[k].dtype == torch.float32 for k in params)
    for (path, got), (_, want) in zip(_leaves(params_to_reference(grads, cfg)),
                                      _leaves(run["grads1"])):
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= GRAD_RTOL[name], f"grad {path}: {rel}"

    losses = []
    for _ in range(3):
        loss, params, opt_state = train_step(params, opt_state, tokens)
        losses.append(loss.item())
    np.testing.assert_allclose(losses, run["losses"], rtol=LOSS_RTOL[name], atol=0)
    assert losses[-1] < losses[0]
    for (path, got), (_, want) in zip(_leaves(params_to_reference(params, cfg)),
                                      _leaves(run["p3"])):
        d = np.abs(got - want) / LR
        assert d.mean() <= PARAM_MEAN_TOL[name], f"{path}: mean {d.mean()} lr"
        if PARAM_MAX_TOL[name] is not None:
            assert d.max() <= PARAM_MAX_TOL[name], f"{path}: max {d.max()} lr"


def test_remat_gives_the_same_losses(ref):
    name = "llama-tiny-f32"
    cfg = get_model(name).config
    tokens = torch.from_numpy(ref[name]["tokens"])
    losses = {}
    for remat in (False, True):
        _, train_step, optimizer = make_train_step(cfg, remat=remat, device="cpu")
        params = _port_params(ref, name)
        opt_state = optimizer.init(params)
        losses[remat] = [train_step(params, opt_state, tokens)[0].item() for _ in range(2)]
    assert losses[True] == losses[False]


def test_adamw_matches_optax_adamw_defaults():
    """One and two steps of the port's AdamW against ``optax.adamw(lr)`` on
    the same numpy params and gradients (optax's weight decay is 1e-4, not
    torch.optim.AdamW's 1e-2). f32 elementwise: a few ulps."""
    rng = np.random.default_rng(4)
    params = {"a": rng.standard_normal((64, 8)).astype(np.float32),
              "b": np.ones(16, np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * 1e-2).astype(np.float32)
              for k, v in params.items()} for _ in range(2)]
    opt = optax.adamw(LR)
    ref_p = {k: jnp.asarray(v) for k, v in params.items()}
    ref_state = opt.init(ref_p)
    port = AdamW(LR)
    assert (port.b1, port.b2, port.eps, port.weight_decay) == (0.9, 0.999, 1e-8, 1e-4)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = port.init(tp)
    for g in grads:
        updates, ref_state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, ref_state, ref_p)
        ref_p = optax.apply_updates(ref_p, updates)
        port.step(tp, {k: torch.from_numpy(v) for k, v in g.items()}, state)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(ref_p[k]), rtol=1e-6, atol=1e-9)
    assert state.count == 2


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 3
    targets = rng.integers(0, 11, (2, 5)).astype(np.int32)
    want = float(ref_cross_entropy(jnp.asarray(logits), jnp.asarray(targets)))
    got = cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(targets)).item()
    assert abs(got - want) <= 1e-6 * abs(want)


def test_params_to_reference_inverts_params_from_jax(ref):
    name = "llama-tiny-f32"
    back = params_to_reference(_port_params(ref, name), get_model(name).config)
    for (pa, got), (pb, want) in zip(_leaves(back), _leaves(ref[name]["p0"])):
        assert pa == pb
        np.testing.assert_array_equal(got, want)


def test_init_state_makes_f32_masters_from_a_seed():
    cfg = get_model("llama-tiny").config
    init_state, _, optimizer = make_train_step(cfg, device="cpu")
    params, opt_state = init_state(0)
    again, _ = init_state(0)
    assert all(p.dtype == torch.float32 for p in params.values())
    for k in params:
        torch.testing.assert_close(params[k], again[k], rtol=0, atol=0)
        assert opt_state.mu[k].shape == params[k].shape
    # The masters hold bf16 values (init in cfg.dtype, then cast).
    assert torch.equal(params["wo"], params["wo"].bfloat16().float())


def test_mesh_and_missing_cuda_raise(monkeypatch):
    cfg = get_model("llama-tiny").config
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 8"):
        make_train_step(cfg, mesh=make_mesh({"dp": 1}), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_train_step(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_jax(_np_tree(init_transformer(jax.random.PRNGKey(0), ref_get_model(
            "llama-tiny").config)), cfg)
