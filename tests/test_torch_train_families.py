"""Training the other decoder families and MoE: the port's
``make_train_step`` and ``make_lora_train_step`` against the reference's
on the same weights and tokens, all on the CPU.

The families are the tiny Gemma (``gemma-tiny``: GeGLU, ``(1 + w)``
RMSNorm, the ``sqrt(d_model)`` embedding scale rounded to the dtype, an
explicit head dim), the Qwen2-shaped tiny (QKV bias before RoPE, 7 query
heads over one KV head), NeoX (``neox-tiny``: LayerNorm with bias,
parallel residual, 25% rotary, a non-gated erf-gelu MLP, biases
everywhere), GPT-2 (``gpt2-tiny``: learned positions clipped to the table)
and MoE (``moe-tiny``: the router's gradient through the gathered top-k
softmax weights, no auxiliary loss), each in bf16 and as its f32 twin.

The reference side runs once per config in a module-scoped fixture: its
own ``make_train_step`` on a one-device mesh, whose ``init_state`` params
get seeded noise on every bias and norm leaf (so a dropped or misplaced
one shows), then three steps on one batch, and the step-1 gradients of
the same loss (``jax.grad``). The params cross to the port through
``params_from_jax(..., dtype=torch.float32)`` (f32 masters, unrounded).
The tolerances are ``tests/test_torch_train.py``'s for Llama.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gofr_tpu.models.registry import get_model as ref_get_model
from gofr_tpu.models.transformer import init_transformer
from gofr_tpu.models.transformer import transformer_forward as ref_forward
from gofr_tpu.parallel import make_mesh
from gofr_tpu.parallel import make_train_step as ref_make_train_step
from gofr_tpu.parallel.sharding import cross_entropy_loss as ref_cross_entropy
from gofr_tpu.parallel.sharding import make_lora_train_step as ref_make_lora_train_step
from gofr_tpu_torch.models.registry import get_model
from gofr_tpu_torch.models.transformer import LORA_TARGETS, lora_dims
from gofr_tpu_torch.parallel.sharding import loss_and_grads, make_lora_train_step, make_train_step
from gofr_tpu_torch.weights import params_from_jax, params_to_reference
from tests.test_torch_families import family_configs
from tests.test_torch_model import _np_tree
from tests.test_torch_train import GRAD_RTOL, LOSS_RTOL, LR

DENSE = ["gemma-tiny", "qwen2-tiny", "neox-tiny", "gpt2-tiny"]
FAMILIES = DENSE + ["moe-tiny"]
DTYPES = ["f32", "bf16"]
# The tolerances of llama-tiny-f32 and llama-tiny.
TWIN = {"f32": "llama-tiny-f32", "bf16": "llama-tiny"}
B, S = 2, 24
# After three AdamW steps, the mean |param difference| in units of the
# learning rate (a first Adam step is ~lr * sign(g)): test_torch_train's
# PARAM_MEAN_TOL (f32 1e-4, bf16 0.1), over each leaf's elements whose
# step-1 gradient stands clear of the two packages' rounding: |g| above
# NOISE_FLOOR x the leaf's rms step-1 gradient difference, and above
# ADAM_FLOOR. Below that the update g / (|g| + eps) follows the rounding,
# not the model: a sign flips (bf16), or a difference dg moves the update
# by dg * eps / g**2 (f32: at g = 1e-6 a 3e-8 difference is 3e-4 lr; at
# ADAM_FLOOR, 1,000x Adam's eps, 3e-6 lr). The key biases are the leaves
# with such elements in number: without RoPE (GPT-2, below) the softmax
# cancels them exactly, and on the dims a rotary table barely turns over
# 24 positions it nearly does (Qwen2, NeoX); in bf16 the router's small
# gradients flip too. Elements with no gradient on either side (the
# embedding rows of tokens not in the batch) are held as well.
PARAM_MEAN_TOL = {"f32": 1e-4, "bf16": 0.1}
NOISE_FLOOR = 3.0
ADAM_FLOOR = 1e-5
# GPT-2's key bias, without RoPE, shifts every score of a query row by the
# same q . b_k, which the softmax cancels: its gradient is zero in exact
# arithmetic, and both sides return rounding noise (read: f32 ~2e-8, bf16
# ~3e-4 against ~0.11 for the query bias). Held in units of the query
# bias gradient's norm instead.
ZERO_GRAD_LEAVES = {"gpt2-tiny": "['layers']['wk_b']"}


def configs(name: str, dtype: str):
    """(reference config, port config): the registered MoE tiny, or a
    dense family of ``tests/test_torch_families.py``, in bf16 or f32."""
    if name != "moe-tiny":
        return family_configs(name, dtype)
    ref_cfg, cfg = ref_get_model(name).config, get_model(name).config
    if dtype == "f32":
        ref_cfg = dataclasses.replace(ref_cfg, dtype=jnp.float32)
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    return ref_cfg, cfg


def _noisy(params, seed: int):
    """The reference params with seeded N(0, 0.1) noise on every bias and
    norm leaf (zeros or ones at init, which would hide a misplaced one)."""
    rng = np.random.default_rng(seed)

    def bump(path, a):
        key = jax.tree_util.keystr(path)
        if key.endswith("_b']") or "norm" in key:
            return a + jnp.asarray(rng.normal(0.0, 0.1, a.shape), a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(bump, params)


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(a, np.float32))
            for p, a in jax.tree_util.tree_leaves_with_path(tree)]


@pytest.fixture(scope="module", params=[(n, d) for n in FAMILIES for d in DTYPES],
                ids=[f"{n}-{d}" for n in FAMILIES for d in DTYPES])
def ref_run(request):
    name, dtype = request.param
    ref_cfg, cfg = configs(name, dtype)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    init_state, step, optimizer = ref_make_train_step(ref_cfg, make_mesh({"dp": 1}),
                                                      learning_rate=LR)
    params, _ = init_state(jax.random.PRNGKey(0))
    params = _noisy(params, seed=5)
    opt_state = optimizer.init(params)
    p0 = _np_tree(params)

    def loss(p):
        p = jax.tree_util.tree_map(lambda x: x.astype(ref_cfg.dtype), p)
        logits = ref_forward(p, jnp.asarray(tokens), ref_cfg)
        return ref_cross_entropy(logits[:, :-1], jnp.asarray(tokens)[:, 1:])

    # One compiled program, not op-by-op dispatch: ~2x faster to build.
    grads1 = _np_tree(jax.jit(jax.grad(loss))(params))
    losses = []
    for _ in range(3):  # the step donates params: p0 was copied first
        value, params, opt_state = step(params, opt_state, jnp.asarray(tokens))
        losses.append(float(value))
    return dict(name=name, dtype=dtype, cfg=cfg, tokens=tokens, p0=p0, grads1=grads1,
                losses=losses, p3=_np_tree(params))


def test_step1_gradients_match_jax_grad(ref_run):
    """Every leaf's step-1 gradient within GRAD_RTOL (||port - ref|| /
    ||ref||) of ``jax.grad`` of the reference's loss."""
    run, cfg = ref_run, ref_run["cfg"]
    params = params_from_jax(run["p0"], cfg, device="cpu", dtype=torch.float32)
    loss, grads = loss_and_grads(params, torch.from_numpy(run["tokens"]).long(), cfg)
    tol = GRAD_RTOL[TWIN[run["dtype"]]]
    got = dict(_leaves(params_to_reference(grads, cfg)))
    want = dict(_leaves(run["grads1"]))
    assert got.keys() == want.keys()
    zero = ZERO_GRAD_LEAVES.get(run["name"])
    for path, w in want.items():
        denom = np.linalg.norm(w)
        if path == zero:
            denom = np.linalg.norm(want[path.replace("wk_b", "wq_b")])
        rel = np.linalg.norm(got[path] - w) / denom
        assert rel <= tol, f"grad {path}: {rel}"


def test_three_train_steps_match_reference(ref_run):
    """make_train_step: three steps' losses within LOSS_RTOL, falling, and
    the params after them within PARAM_MEAN_TOL learning rates."""
    run, cfg = ref_run, ref_run["cfg"]
    init_state, train_step, optimizer = make_train_step(cfg, learning_rate=LR, device="cpu")
    params = params_from_jax(run["p0"], cfg, device="cpu", dtype=torch.float32)
    _, grads = loss_and_grads(params, torch.from_numpy(run["tokens"]).long(), cfg)
    port_g1 = dict(_leaves(params_to_reference(grads, cfg)))
    opt_state = optimizer.init(params)
    losses = []
    for _ in range(3):
        loss, params, opt_state = train_step(params, opt_state,
                                             torch.from_numpy(run["tokens"]))
        losses.append(loss.item())
    np.testing.assert_allclose(losses, run["losses"], rtol=LOSS_RTOL[TWIN[run["dtype"]]],
                               atol=0)
    assert losses[-1] < losses[0]
    ref_g1 = dict(_leaves(run["grads1"]))
    for (path, got), (_, want) in zip(_leaves(params_to_reference(params, cfg)),
                                      _leaves(run["p3"])):
        if path == ZERO_GRAD_LEAVES.get(run["name"]):
            continue  # all rounding: held in the gradient test
        g = np.abs(ref_g1[path])
        noise = np.sqrt(np.mean((port_g1[path] - ref_g1[path]) ** 2))
        held = ((g > NOISE_FLOOR * noise) & (g > ADAM_FLOOR)) | (
            (ref_g1[path] == 0) & (port_g1[path] == 0))
        assert held.any(), path
        d = (np.abs(got - want) / LR)[held]
        assert d.mean() <= PARAM_MEAN_TOL[run["dtype"]], f"{path}: mean {d.mean()} lr"


@pytest.mark.parametrize("name", FAMILIES)
def test_init_state_builds_every_family(name):
    """make_train_step takes every family: f32 masters of the port's init
    for the config, and AdamW state of the same leaves."""
    cfg = configs(name, "bf16")[1]
    init_state, _, _ = make_train_step(cfg, device="cpu")
    params, opt_state = init_state(0)
    assert all(p.dtype == torch.float32 for p in params.values())
    assert opt_state.mu.keys() == params.keys()
    if cfg.is_moe:
        assert params["router"].shape == (cfg.n_layers, cfg.d_model, cfg.n_experts)


RANK = 4


def lora_targets(cfg) -> tuple:
    """Every target the config's FFN has (a non-gated MLP has no gate)."""
    return tuple(t for t in LORA_TARGETS if not (t == "w_gate" and cfg.ffn == "mlp"))


def lora_factors(cfg, targets: tuple, seed: int = 8) -> dict:
    """{target: (a ~ N(0, 1)/r, b ~ N(0, 0.05))} f32 numpy, so every
    factor has a gradient at step 1."""
    rng = np.random.default_rng(seed)
    out = {}
    for t in targets:
        d_in, d_out = lora_dims(cfg, t)
        out[t] = (rng.standard_normal((cfg.n_layers, d_in, RANK)).astype(np.float32) / RANK,
                  rng.normal(0.0, 0.05, (cfg.n_layers, RANK, d_out)).astype(np.float32))
    return out


@pytest.mark.parametrize("name", DENSE)
def test_lora_steps_match_reference(name):
    """make_lora_train_step on each dense family (f32 twin, every target):
    three steps' losses within 1e-5 relative and the factors after each
    within 1e-5 of the reference's, from the same injected factors on the
    same frozen base (seeded bias and norm noise); the base untouched."""
    ref_cfg, cfg = configs(name, "f32")
    tree = _noisy(init_transformer(jax.random.PRNGKey(3), ref_cfg), seed=6)
    base = params_from_jax(_np_tree(tree), cfg, device="cpu")
    before = {k: v.clone() for k, v in base.items()}
    targets = lora_targets(cfg)
    init = lora_factors(cfg, targets)
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    _, ref_step = ref_make_lora_train_step(ref_cfg, tree, RANK, targets, learning_rate=1e-3)
    ref_lora = {t: (jnp.asarray(a), jnp.asarray(b)) for t, (a, b) in init.items()}
    ref_opt = optax.adamw(1e-3).init(ref_lora)
    init_state, step = make_lora_train_step(cfg, base, RANK, targets, learning_rate=1e-3,
                                            device="cpu")
    lora, opt = init_state(0)
    for t, (a, b) in init.items():
        lora[t][0].copy_(torch.from_numpy(a))
        lora[t][1].copy_(torch.from_numpy(b))
    losses = []
    for i in range(3):
        want, ref_lora, ref_opt = ref_step(ref_lora, ref_opt, jnp.asarray(tokens))
        got, lora, opt = step(lora, opt, torch.from_numpy(tokens))
        losses.append(got.item())
        assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want)), (i, got, want)
        for t in targets:
            for mine, ref in zip(lora[t], ref_lora[t]):
                np.testing.assert_allclose(mine.numpy(), np.asarray(ref), atol=1e-5, rtol=0,
                                           err_msg=f"step {i + 1} {t}")
    assert losses[-1] < losses[0]
    assert all(torch.equal(base[k], v) for k, v in before.items())


def test_lora_training_refuses_moe_as_the_reference():
    """MoE has no adapter path: both packages raise the same ValueError."""
    errs = []
    for fn, cfg in ((ref_make_lora_train_step, ref_get_model("moe-tiny").config),
                    (make_lora_train_step, get_model("moe-tiny").config)):
        with pytest.raises(ValueError) as err:
            fn(cfg, {}, 4)
        errs.append(str(err.value))
    assert errs[0] == errs[1] == "LoRA training does not support MoE models"
