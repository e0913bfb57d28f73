#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gofr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of a checkout, on a machine with one CUDA card, the CUDA
toolkit (nvcc) and PyTorch built for CUDA. It

1. builds the hand-written kernels from gofr_tpu_torch/csrc/ and prints
   nvcc's registers, spills and stack per attention kernel;
1a. holds the Hopper primitives the tiled kernels are built from against
   torch (csrc/sm90_selftest.cu): wgmma m64nNk16 for N 64 and 128, A from
   shared memory and registers, B K-major and MN-major; a 3-stage mbarrier
   ring; a TMA box on a ragged edge;
2. holds each kernel against its plain PyTorch version, and times kernel,
   plain version and a PyTorch library call on the same problem: the two
   serving kernels at the serving shapes of llama-3-8b, on the bf16 slot
   cache and on their paged (pool blocks of 32 and 128 under a shuffled
   table, garbage in every block no row owns), int8 and paged+int8
   variants, each paged case also against the slot cache's kernel output
   bit for bit; flash_attention at llama-1b training (b=4, s=2048, causal
   GQA), the same with per-row key lengths including an empty row, a
   causal suffix (256 queries over 2048 keys) and ViT-B/16 (non-causal,
   197 tokens, hd 64);
3. holds FlashAttentionFn's gradients (kernel forward, dense-recompute
   backward) against autograd through the f32 plain version;
3a. holds mistral-7b's sliding window (4096) in all three kernels at its
   shapes (max_len 8192): flash_decode on lengths around the window's
   edge in both conventions and flash_cache_attention on chunks past it,
   each on the bf16 slot cache, a pool of 32, int8 and an int8 pool of 32
   (pools bit for bit against the slot cache); flash_attention at s=8192
   with and without per-row lengths; every case rerun with NaN in the rows
   or key tiles below the window, which must not change a bit; the
   windowed decode timed beside the unwindowed one; and the windowed
   FlashAttentionFn gradients at b=1, s=6144;
4. serves Llama-3-8B (32 layers, bf16, random weights from a seed) on the
   card: a forward check of one prefill chunk and two decode steps through
   the kernels against the plain path, on the slot cache, on pools of 32
   and 128 (against the slot cache) and on int8 caches (against the int8
   plain path); then 10 concurrent requests through the port's
   InferenceEngine on the bf16 slot cache and again on an int8 pool of
   161 blocks of 32, each run with the kernels' launch counters watched;
4a. serves the reference's whole request surface on both caches: an
   engine with every sampler flag on (top_k 50, top_p, penalties,
   top_logprobs 5) takes 10 concurrent requests with mixed options
   (neutral greedy, penalties, logit_bias, top_logprobs, a stop string,
   a seeded top_p pair, a deadline and a cancel token that retire their
   requests mid-stream), each held against the greedy streams of step 4;
4b. serves the same model through the port's own App over HTTP: the App
   built from config alone (TPU_MODEL=llama-3-8b, phase_serve's geometry,
   the same seed-0 weights), add_openai_routes and a ctx.infer route;
   phase_serve's 10 prompts as concurrent streaming /v1/completions over
   real sockets, each greedy stream equal to phase_serve's token for
   token; a chat completion, a ctx.infer request, an overlong prompt (413
   before any SSE header) and a 0.05 s X-Request-Timeout (ends early);
   /metrics against what the client received; tok/s, TTFT p50 and ITL
   p50 over HTTP beside the direct engine's; App.stop frees every slot;
4c. the decode loop (every serve above already runs it: pipeline depth 2,
   each window a CUDA graph replay, launches counted through replays, no
   stream sync allowed in a serve): the captured window against the eager
   one on copies of one state, every static variant (greedy / sampled x
   logit bias; tokens identical, logprobs within 1e-3, launches equal);
   one mega window (m = 4, a conditional WHILE node) against plain
   windows with windows_run = min(m, ceil(max(remaining) / k)); the
   capture time and graph pool bytes; then phase_serve's 10 prompts at
   pipeline depth 1 and 3 and at mega 4: greedy streams equal
   phase_serve's (a difference passes only at a top-2 logit margin below
   1e-2), tok/s, TTFT p50, ITL p50, windows, mega dispatches, launches and
   stream syncs per setting;
5. profiles one 8-step decode window (eager, then as a CUDA graph replay)
   and one [8, 256] prefill chunk with
   torch.profiler: host wall time, device busy time, idle share, GPU
   kernels launched and the top kernels by device time; the window again
   with every sampler option on every slot, and the sampler's own device
   time per window, flags on and off;
5a. serves Mistral-7B (32 layers, bf16, random weights from a seed,
   after Llama-3-8B is freed) past its window: a forward check from
   prefixes of 5,000, 3,900 and 4,096 tokens (one chunk and two decode
   steps, kernels against the plain path on the slot cache, a pool of 32,
   int8 caches, and with the window off, which must move only the rows
   past it); 6 concurrent requests (prompts 17 to 6,500 tokens) through
   InferenceEngine(max_len=8192) on the bf16 slot cache, again at
   prefill depth 4 (multi-chunk prefill: streams equal, dispatches and
   TTFT p50 beside depth 1's), and on an int8
   pool of 641 blocks of 32; and transformer_prefill on a right-padded
   [2, 8192] batch and transformer_forward on [1, 8192], the windowed
   flash_attention's two entry points; then profiles one decode window
   over 4 slots and one [4, 256] prefill chunk at 6,000 tokens of context;
6. trains llama-1b (22 layers, full width, f32 master weights and AdamW,
   bf16 compute, random weights from a seed) through make_train_step on a
   fixed [4, 2048] batch: step-1 loss and gradients through the kernel
   against the plain path, 6 steps with finite and falling loss, one
   remat step, flash_attention launched exactly once per layer per
   forward; prints step time, tokens/s, peak memory and train_mfu, and
   profiles one training step;
7. checks transformer_prefill (right-padded llama-1b batch, the kernel's
   lengths variant) against the plain path;
8. prints the card, the kernels line and, last, {"ok": true, ...}.

Device times come from torch.profiler. On a machine where its trace holds
no GPU kernel, they come from CUDA events around calls queued behind a
spin kernel (queued_ms), and a profile whose step waits for the device
itself reports its device busy time as not measured.

Any failed phase exits non-zero before the last line is printed. Nothing
of JAX or of the gofr_tpu package is imported.
"""

from __future__ import annotations

import collections
import gc
import http.client
import json
import math
import re
import statistics
import subprocess
import sys
import threading
import time

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, dense bf16 and f32 rates.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12  # f32 outside the tensor cores
# Kernel vs plain: the plain version runs in f32 on the kernel's inputs
# upcast, so what differs is the kernel's bf16 output rounding (2**-9
# relative), its bf16 probabilities in the prefill P.V product, and the
# summation order. Each output row (one query head's hd values) is held
# to max|got - want| <= ROW_REL_TOL * rms(want row), so a short slot and a
# 2047-key slot are held alike; rows that must be 0 (padding queries, an
# empty prefix) must be exactly 0. At the shapes below, rounding the f32
# answer to bf16 alone reads ~0.012 (printed as the floor), while leaving
# out a single key of the 2047-key slot fails the check
# (tests/test_torch_kernels.py).
ROW_REL_TOL = 3e-2
# Full llama-3-8b forward, kernels vs the plain path (which rounds the
# probabilities to bf16 as the reference's dense formula does), on logits
# within about +-5: max|dlogits| read 0.094-0.106 on an NVIDIA H100 80GB
# HBM3 at a 700 W power limit (as every reading below).
FORWARD_DLOGITS_TOL = 0.25
# FlashAttentionFn's dq/dk/dv (bf16 in, dense-recompute backward with bf16
# probabilities and bf16 products) against autograd through the f32 plain
# version, per row as above. Read on the H100: dk 0.016 and dv 0.018 (near
# their bf16 floors), dq 0.224. The worst dq rows are early queries (the
# same check on the CPU puts its worst at query 2): their dq is a
# cancellation over a few keys (exactly 0 for the first query), so the bf16
# rounding of the probability gradients is large against that row's rms.
GRAD_ROW_REL_TOL = 0.5
# llama-1b training, kernel path vs plain path (the dense formula) on the
# same f32 master weights and batch: |loss difference| and, per parameter
# tensor, ||grad difference|| / ||plain grad||. Read on the H100: |dloss|
# 1.03e-4 on a loss of 10.91, gradients 0.0285 at most (embed), from the
# bf16 rounding of the forward's activations.
TRAIN_DLOSS_TOL = 1e-3
TRAIN_GRAD_REL_TOL = 0.06
# transformer_prefill logits (llama-1b, lengths 2048/700/1), kernel vs
# plain: read 0.031 on logits within +-6.
PREFILL_DLOGITS_TOL = 0.08
TIMED_RUNS = 30
# A paged kernel against the slot cache's on the same logical keys: the
# same arithmetic on the same values, only the addresses differ.
PAGED_VS_CONTIGUOUS_TOL = 0.0
# The llama-3-8b forward on a pool against the slot cache, both through
# the kernels: expected 0 for the reason above.
FORWARD_PAGED_TOL = 1e-3
# Fill of the parking block and every pool block no row owns: a key read
# from there would swamp its row's output.
GARBAGE = 3e4
# Prompt lengths of the llama-3-8b serve run (the last two: one seeded
# sampled prompt submitted twice).
LLAMA_PROMPTS = (1, 17, 64, 255, 256, 257, 400, 520, 700, 700)
# mistral-7b's sliding window, and the prompts of its serve run: around,
# across (4090 + 32 new tokens) and past the window.
MISTRAL_WINDOW = 4096
MISTRAL_PROMPTS = (17, 700, 4090, 4100, 5000, 6500)
# The f32 kernels (flash_decode's f32 instantiations, csrc/attn_f32.cu)
# against their f32 plain versions, per output row: another summation
# order in f32 (2**-24 relative a rounding).
F32_ROW_REL_TOL = 1e-4
# llama-tiny-f32 logits, kernels vs the plain path: f32 attention outputs
# that differ in their last bits, through 2 layers.
TINY_F32_DLOGITS_TOL = 1e-3
# llama-tiny (bf16, hd 32) logits, kernels vs the plain path (which rounds
# the probabilities to bf16): the CPU tests' port-vs-reference limit.
TINY_BF16_DLOGITS_TOL = 6e-2
# torch.profiler windows for a kernel's device time.
DEVICE_RUNS = 20
# Spin-kernel cycles a second (torch.cuda._sleep counts clock64 ticks): at
# least the card's highest SM clock (1,980 MHz on an H100 SXM), so a spin
# sized from it lasts at least as long as asked.
SPIN_HZ = 2.5e9
# What device_ms and the profiles read device time from. torch.profiler
# (CUPTI) first; where its trace holds no GPU kernel, every later device
# time comes from CUDA events around calls queued behind a spin kernel.
DEVICE_TIMER = {"by": "torch.profiler"}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, runs: int = TIMED_RUNS) -> float:
    """Median milliseconds of ``fn`` over ``runs`` launches, each timed by
    CUDA events, after two warm-up calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def queued_ms(torch, fn, runs: int = DEVICE_RUNS) -> float | None:
    """Device time of one call of ``fn`` from CUDA events, without the
    host's launch time: a spin kernel holds the stream while the host
    queues ``runs`` calls, so the events time them back to back on the
    device. None where the queue drains before the host has queued every
    call even behind a spin 16 times the host's time (``fn`` waits for the
    device itself)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    for margin in (4, 16):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(margin * host_s * SPIN_HZ) + 100_000)
        start.record()
        for _ in range(runs):
            fn()
        end.record()
        held = not start.query()
        end.synchronize()
        if held:
            return start.elapsed_time(end) / runs
    return None


def _profiler_traces_nothing() -> None:
    if DEVICE_TIMER["by"] == "torch.profiler":
        DEVICE_TIMER["by"] = "CUDA events, calls queued behind a spin kernel"
        log("device time: the torch.profiler trace holds no GPU kernel on this machine; "
            "every device time from here on is from CUDA events around calls queued "
            "behind a spin kernel (chip_smoke.queued_ms)")


def device_ms(torch, fn, runs: int = DEVICE_RUNS, required: bool = True) -> float | None:
    """Device time of one call of ``fn``: every GPU kernel's time in a
    torch.profiler trace of ``runs`` calls (after a warm-up), over
    ``runs``. Unlike CUDA events around each call, it leaves out the
    host's launch time. Where the trace holds no GPU kernel, the time
    comes from ``queued_ms`` (DEVICE_TIMER says which), once a second
    trace holds none either. Where neither can time ``fn`` (it waits for
    the device itself), the run fails, or returns None (not measured)
    for a time that is not ``required``: a profile's, not a kernel's."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2 if DEVICE_TIMER["by"] == "torch.profiler" else 0):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        total_us = sum(a.self_device_time_total for a in prof.key_averages()
                       if a.self_device_time_total > 0)
        if total_us > 0:
            return total_us / runs / 1e3
    _profiler_traces_nothing()
    ms = queued_ms(torch, fn, runs)
    if ms is None and required:
        fail("device_ms: torch.profiler traces no GPU kernel and the calls do not queue "
             "behind a spin kernel")
    return ms


def decode_extras(torch, fd, name: str, fn, q, k_cache, table, window: int,
                  library=None) -> dict:
    """For a flash_decode case: the cluster size the wrapper launches with,
    two launches bit for bit equal (fixed-order merges), the kernel's
    device time, the same from queued CUDA events (``queued_ms``, a check
    of the one timer against the other) and, where one PyTorch call
    computes the same function, that call's device time."""
    cluster = fd.launch_cluster_size(q, k_cache, table, window)
    a, b = fn(), fn()
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        fail(f"{name}: two launches on the same inputs differ")
    dev = device_ms(torch, fn)
    lib_dev = None if library is None else device_ms(torch, library)
    queued = queued_ms(torch, fn)
    log(f"{name}: cluster of {cluster} blocks per (slot, kv head), grid {q.shape[0]} x "
        f"{k_cache.shape[1]} x {cluster}; device time {dev:.4f} ms a launch "
        f"({DEVICE_TIMER['by']}, {DEVICE_RUNS} launches)"
        + ("" if lib_dev is None else f", sdpa device time {lib_dev:.4f} ms")
        + ("" if queued is None else f"; queued CUDA events {queued:.4f} ms a launch")
        + "; two launches bit-equal")
    return dict(cluster=cluster, device_ms=dev, device_ms_by=DEVICE_TIMER["by"],
                queued_event_ms=queued, library_device_ms=lib_dev, repeat_bit_equal=True)


def check_close(torch, name: str, got, want32, tol: float = ROW_REL_TOL) -> tuple[float, float]:
    """(max |got - want|, max over rows of max|got - want| / rms(want));
    fails on non-finite output, a row over ``tol``, or a nonzero value
    where the plain version gives a zero row."""
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        fail(f"{name}: kernel output has non-finite values")
    hd = got.shape[-1]
    g, w = got.float().reshape(-1, hd), want32.float().reshape(-1, hd)
    d = (g - w).abs().amax(dim=-1)
    rms = w.pow(2).mean(dim=-1).sqrt()
    zero = rms == 0
    if zero.any() and d[zero].max().item() != 0.0:
        fail(f"{name}: rows that must be 0 are not (max {d[zero].max().item()})")
    rel = (d[~zero] / rms[~zero]).max().item()
    err = d.max().item()
    floor = ((w.bfloat16().float() - w).abs().amax(dim=-1)[~zero] / rms[~zero]).max().item()
    log(f"{name}: max row error / row rms {rel:.4g} (limit {tol}, "
        f"bf16 rounding floor {floor:.4g}), max_abs_err {err:.4g}")
    if rel > tol:
        fail(f"{name}: kernel disagrees with the f32 plain version "
             f"(max row error / row rms = {rel:.4g} > {tol}, "
             f"max_abs_err={err:.4g})")
    return err, rel


def kernel_resources(log: dict) -> list:
    """Per kernel entry of ``_build.ptxas_log`` (nvcc -Xptxas -v): source,
    registers, spill bytes (stores + loads) and stack bytes."""
    out = []
    for src, text in sorted(log.items()):
        cur = None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                # ..._cu_<hash><len><name>I<template arguments>E...
                name = re.search(r"(?<=\d)([a-z][a-z_]*_kernel)(I\w*?E)E*v", m.group(1))
                cur = {"source": src, "kernel": name.group(1) if name else m.group(1),
                       "template": name.group(2) if name else "", "mangled": m.group(1)}
                out.append(cur)
                continue
            if cur is None:
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m:
                cur.update(stack=int(m.group(1)), spill=int(m.group(2)) + int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
    return out


def phase_sm90_primitives(torch, dev) -> None:
    """Before the attention kernels are trusted: the Hopper primitives they
    are built from (csrc/sm90_selftest.cu) against torch on the card. One
    warpgroup's wgmma m64nNk16 over 8 k-steps for N 64 and 128, A from
    shared memory and from registers, B K-major (as K in Q.K^T) and MN-major
    (as V in P.V), from tiles in the kernels' swizzled layout; a 3-stage
    mbarrier ring whose phases wrap three times; a TMA box on a ragged
    edge."""
    from gofr_tpu_torch.ops.cuda import sm90_selftest as st

    gen = torch.Generator(device=dev).manual_seed(90)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    for n in (64, 128):
        for mn in (False, True):
            for regs in (False, True):
                a, b = rnd(64, st.K), (rnd(st.K, n) if mn else rnd(n, st.K))
                got = st.wgmma_product(a, b, b_mn_major=mn, a_regs=regs)
                want = st.wgmma_product_plain(a, b, b_mn_major=mn)
                err = (got - want).abs().max().item()
                log(f"sm90 wgmma m64n{n}k16 A {'registers' if regs else 'smem'}, B "
                    f"{'MN' if mn else 'K'}-major: max|D - torch| {err:.3g} (limit 1e-3, "
                    f"|D| up to {want.abs().max().item():.3g})")
                if not err <= 1e-3:
                    fail(f"sm90 wgmma (n={n}, mn_major={mn}, a_regs={regs}) disagrees with torch")
    src = torch.randint(-30000, 30000, (10, 128, 8), generator=gen, device=dev,
                        dtype=torch.int32).to(torch.int16)
    if not torch.equal(st.ring_roundtrip(src), st.ring_roundtrip_plain(src)):
        fail("sm90 mbarrier ring: a tile came back wrong")
    m = rnd(100, 72)
    for r0 in (0, 64):
        if not torch.equal(st.tma_box(m, r0), st.tma_box_plain(m, r0)):
            fail(f"sm90 TMA box at row {r0} of 100: wrong values or no zero fill")
    log("sm90: 10 tiles through a 3-stage mbarrier ring and TMA boxes on a ragged edge "
        "match torch bit for bit")
    raw = torch.randint(0, 256, (8192,), generator=gen, device=dev,
                        dtype=torch.int32).to(torch.uint8)
    words = torch.randint(-2**31, 2**31 - 1, (100,), generator=gen, device=dev,
                          dtype=torch.int32)
    got, got_words = st.bulk_roundtrip(raw, words)
    if not (torch.equal(got, raw) and torch.equal(got_words, words)):
        fail("sm90 bulk copy / 4-byte cp.async: the bytes came back wrong")
    x = torch.randint(-2**31, 2**31 - 1, (132 * 4, 128), generator=gen, device=dev,
                      dtype=torch.int32)
    got, ranks = st.cluster_exchange(x)
    want, want_ranks = st.cluster_exchange_plain(x)
    if not (torch.equal(got, want) and torch.equal(ranks, want_ranks)):
        fail("sm90 cluster: a block read the wrong words from its peer's shared memory")
    log("sm90: a 8192-byte bulk copy and 100 cp.async words on one mbarrier phase, and 132 "
        "clusters of 4 blocks reading their peers' shared memory, match torch bit for bit")


def phase_kernels(torch, dev) -> dict:
    """Kernel vs plain at llama-3-8b head shapes (H=32, KV=8, hd=128)."""
    from gofr_tpu_torch.ops.cuda import flash_decode as fd
    from gofr_tpu_torch.ops.cuda import flash_prefill as fp

    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device=dev).manual_seed(1234)
    H, KV, hd, max_len = 32, 8, 128, 2048
    i32 = dict(dtype=torch.int32, device=dev)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    out = {}
    # -- flash_decode: S=8 slots, ragged lengths incl. 0, 1, off-tile, 2047
    S = 8
    lengths = [0, 1, 100, 257, 1000, 1536, 700, 2047]
    q, kc, vc = rnd(S, H, hd), rnd(S, KV, max_len, hd), rnd(S, KV, max_len, hd)
    kn, vn = rnd(S, KV, hd), rnd(S, KV, hd)
    lens = torch.tensor(lengths, **i32)
    q32, kc32, vc32, kn32, vn32 = (t.float() for t in (q, kc, vc, kn, vn))
    err_w, rel_w = check_close(torch, "flash_decode (written)",
                               fd.flash_decode(q, kc, vc, lens),
                               fd.flash_decode_plain(q32, kc32, vc32, lens))
    err_s, rel_s = check_close(
        torch, "flash_decode (split)",
        fd.flash_decode(q, kc, vc, lens, k_new=kn, v_new=vn),
        fd.flash_decode_plain(q32, kc32, vc32, lens, k_new=kn32, v_new=vn32))
    del q32, kc32, vc32, kn32, vn32
    ms = time_ms(torch, lambda: fd.flash_decode(q, kc, vc, lens, k_new=kn, v_new=vn))
    ms_w = time_ms(torch, lambda: fd.flash_decode(q, kc, vc, lens))
    plain_ms = time_ms(torch, lambda: fd.flash_decode_plain(
        q, kc, vc, lens, k_new=kn, v_new=vn))
    # Library yardstick: SDPA computes the already-written convention on
    # the same q and caches (valid-prefix mask, GQA); the split merge has
    # no single library call.
    mask = (torch.arange(max_len, device=dev)[None, :] < lens[:, None])[:, None, None, :]
    lib_ms = time_ms(torch, lambda: sdpa(
        q[:, :, None, :], kc, vc, attn_mask=mask, enable_gqa=True))
    # Bound (split convention, the main path): q, valid K/V prefix, the
    # new token's K/V and the output cross HBM once; 4 FLOPs per
    # (query head, key, dim).
    tok = sum(lengths)
    bytes_ = (2 * S * H * hd * 2 + tok * KV * hd * 2 * 2 + 2 * S * KV * hd * 2 + S * 4)
    flops = 4 * (tok + S) * H * hd
    bound_ms = max(bytes_ / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
    extras = decode_extras(
        torch, fd, "flash_decode (split)",
        lambda: fd.flash_decode(q, kc, vc, lens, k_new=kn, v_new=vn), q, kc, None, 0,
        library=lambda: sdpa(q[:, :, None, :], kc, vc, attn_mask=mask, enable_gqa=True))
    out["flash_decode"] = dict(
        max_abs_err=max(err_w, err_s), max_row_rel_err=max(rel_w, rel_s),
        ms=ms, ms_written=ms_w, plain_ms=plain_ms,
        library_ms=lib_ms, bound_ms=bound_ms,
        bound_by="bytes" if bytes_ / HBM_BYTES_PER_S >= flops / BF16_FLOPS else "operations",
        shape=f"S={S} H={H} KV={KV} hd={hd} max_len={max_len} lengths={lengths}", **extras,
    )
    log(f"flash_decode: kernel {ms:.4f} ms (written {ms_w:.4f}), plain {plain_ms:.4f} ms, "
        f"sdpa {lib_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes {bytes_})")
    del q, kc, vc, kn, vn, mask

    # -- flash_cache_attention: P=8 rows of c=256, starts 0/256/1024/...,
    # one short row, the last row a padding duplicate of row 0.
    P, c = 8, 256
    rows = [(0, 0, 256), (1, 256, 256), (2, 1024, 256), (3, 512, 100),
            (4, 1536, 256), (5, 0, 37), (6, 1792, 200), (0, 0, 256)]
    q = rnd(P, c, H, hd)
    q[P - 1] = q[0]
    kc, vc = rnd(S, KV, max_len, hd), rnd(S, KV, max_len, hd)
    slots = torch.tensor([r[0] for r in rows], **i32)
    starts = torch.tensor([r[1] for r in rows], **i32)
    lns = torch.tensor([r[2] for r in rows], **i32)
    args = (q, kc, vc, slots, starts, lns)
    err, rel = check_close(
        torch, "flash_cache_attention", fp.flash_cache_attention(*args),
        fp.flash_cache_attention_plain(q.float(), kc.float(), vc.float(),
                                       slots, starts, lns))
    ms = time_ms(torch, lambda: fp.flash_cache_attention(*args))
    plain_ms = time_ms(torch, lambda: fp.flash_cache_attention_plain(*args), runs=20)
    # Library yardstick: SDPA on the equivalent dense problem (each row's
    # slot gathered beforehand, causal-at-global-position mask).
    ck, cv = kc[slots.long()], vc[slots.long()]
    t = torch.arange(c, device=dev)
    pos = starts.long()[:, None] + t[None, :]
    dmask = (torch.arange(max_len, device=dev)[None, None, :] <= pos[:, :, None]) \
        & (t[None, :] < lns.long()[:, None])[:, :, None]
    qt = q.transpose(1, 2)
    lib_ms = time_ms(torch, lambda: sdpa(qt, ck, cv, attn_mask=dmask[:, None], enable_gqa=True))
    uniq = sorted(set(rows))
    flops = sum(4 * H * hd * sum(s + tt + 1 for tt in range(n)) for _, s, n in uniq)
    bytes_ = 2 * P * c * H * hd * 2 + sum((s + n) * KV * hd * 2 * 2 for _, s, n in uniq)
    bound_ms = max(bytes_ / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
    out["flash_cache_attention"] = dict(
        max_abs_err=err, max_row_rel_err=rel, ms=ms, plain_ms=plain_ms,
        library_ms=lib_ms, tflops=flops / ms / 1e9, library_tflops=flops / lib_ms / 1e9,
        bound_ms=bound_ms,
        bound_by="bytes" if bytes_ / HBM_BYTES_PER_S >= flops / BF16_FLOPS else "operations",
        shape=f"P={P} c={c} H={H} KV={KV} hd={hd} max_len={max_len} rows={rows}",
    )
    log(f"flash_cache_attention: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"(flops {flops}, {flops / ms / 1e9:.1f} TFLOP/s achieved, sdpa "
        f"{flops / lib_ms / 1e9:.1f} on the same useful flops)")
    return out


def kv_bytes(rows: int, KV: int, hd: int, quant: bool) -> int:
    """Bytes of ``rows`` cached positions' K and V across KV heads: bf16
    values, or int8 values and one f32 scale each."""
    return rows * KV * 2 * (hd + 4 if quant else 2 * hd)


def make_pool(torch, gen, logical: list, keys: list, B: int, extra: int = 16):
    """The keys [0, keys[r]) of each row of the logical caches (tensors
    [rows, KV, max_len, ...]) moved into pools [n_blocks, KV, B, ...] under
    a table that is a random permutation of a pool larger than needed;
    the parking block 0, ``extra`` unused blocks and every table entry past
    a row's keys (0) hold garbage. Returns (pools, table int32)."""
    rows, KV, max_len = logical[0].shape[:3]
    dev = logical[0].device
    need = [-(-n // B) for n in keys]
    n_blocks = sum(need) + 1 + extra
    perm = (torch.randperm(n_blocks - 1, generator=gen, device=dev) + 1).tolist()
    table = torch.zeros((rows, max_len // B), dtype=torch.int32)
    pools = []
    for t in logical:
        shape = (n_blocks, KV, B, *t.shape[3:])
        if t.dtype == torch.int8:
            pool = torch.randint(-127, 128, shape, generator=gen, device=dev).to(torch.int8)
        else:
            pool = torch.full(shape, GARBAGE, dtype=t.dtype, device=dev)
        pools.append(pool)
    i = 0
    for r in range(rows):
        for j in range(need[r]):
            blk = perm[i]
            i += 1
            table[r, j] = blk
            for pool, t in zip(pools, logical):
                pool[blk] = t[r, :, j * B:(j + 1) * B]
    return pools, table.to(dev)


def decode_cluster_sweep(torch, dev) -> list:
    """flash_decode's device time at each cluster size, in the split
    convention on the bf16 slot cache, at the shapes of the two profiled
    decode windows (llama-3-8b: 8 slots at 256 tokens, max_len 2048;
    mistral-7b: 4 slots at 6,000 tokens, window 4096, max_len 8192) and of
    the kernel table's row 1, beside the size the wrapper picks. Every
    size must give the plain version's answer (the split only changes the
    summation order)."""
    from gofr_tpu_torch.ops.cuda import flash_decode as fd

    gen = torch.Generator(device=dev).manual_seed(88)
    H, KV, hd = 32, 8, 128
    shapes = [("llama-3-8b decode at 256 tokens", [256] * 8, 2048, 0),
              ("mistral-7b decode at 6,000 tokens", [6000] * 4, 8192, MISTRAL_WINDOW),
              ("row 1 lengths", [0, 1, 100, 257, 1000, 1536, 700, 2047], 2048, 0)]
    out = []
    for label, lengths, max_len, window in shapes:
        S = len(lengths)
        q, kn, vn = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                     for shape in ((S, H, hd), (S, KV, hd), (S, KV, hd)))
        kc, vc = (torch.randn((S, KV, max_len, hd), generator=gen, device=dev)
                  .to(torch.bfloat16) for _ in range(2))
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        want = fd.flash_decode_plain(q.float(), kc.float(), vc.float(), lens, k_new=kn.float(),
                                     v_new=vn.float(), window=window)
        times = {}
        for c in (1, 2, 4, 8):
            def run(c=c):
                return fd.launch_with_cluster(q, kc, vc, lens, kn, vn, None, None, None,
                                              hd**-0.5, window, c)
            check_close(torch, f"flash_decode {label}, cluster {c}", run(), want)
            times[c] = device_ms(torch, run)
        picked = fd.launch_cluster_size(q, kc, None, window)
        fits = {c: fd.max_active_clusters(q, kc, 0, c) for c in (1, 2, 4, 8)}
        rows = sum(min(n, window - 1) if window else n for n in lengths)
        bound = (kv_bytes(rows, KV, hd, False) + 4 * S * H * hd + 4 * S * KV * hd) \
            / HBM_BYTES_PER_S * 1e3
        out.append(dict(shape=label, pairs=S * KV, device_ms=times, max_active_clusters=fits,
                        picked=picked, bound_ms=bound))
        log("flash_decode cluster sweep: " + json.dumps(out[-1]))
        del q, kn, vn, kc, vc, want
    return out


def phase_kernel_variants(torch, dev) -> dict:
    """The serving kernels' paged (B=32, B=128), int8 and paged+int8 (B=32)
    variants at the llama-3-8b serving shapes of ``phase_kernels``: each
    against its plain version run in f32, each paged case against the
    contiguous kernel on the same logical keys (must be bit-equal);
    kernel, plain and bound times. No single PyTorch call computes paged
    or int8-scaled attention, so ``library_ms`` is null."""
    from gofr_tpu_torch.ops.cuda import flash_decode as fd
    from gofr_tpu_torch.ops.cuda import flash_prefill as fp
    from gofr_tpu_torch.ops.kv_cache import fake_quantize_kv, quantize_kv

    gen = torch.Generator(device=dev).manual_seed(2024)
    H, KV, hd, max_len, S = 32, 8, 128, 2048, 8
    i32 = dict(dtype=torch.int32, device=dev)
    variants = [("paged B=32", False, 32), ("paged B=128", False, 128),
                ("int8", True, 0), ("paged+int8 B=32", True, 32)]

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def caches(quant):
        k, v = rnd(S, KV, max_len, hd), rnd(S, KV, max_len, hd)
        if not quant:
            return [k, v]
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        return [k, v, ks, vs]

    def kw(cache, table):
        out = dict(k_cache=cache[0], v_cache=cache[1])
        if len(cache) == 4:
            out.update(k_scale=cache[2], v_scale=cache[3])
        if table is not None:
            out["block_table"] = table
        return out

    def f32(d):
        return {k: (t.float() if t.dtype == torch.bfloat16 else t) for k, t in d.items()}

    def bound(bytes_, flops):
        return (max(bytes_ / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3,
                "bytes" if bytes_ / HBM_BYTES_PER_S >= flops / BF16_FLOPS else "operations")

    out = {"flash_decode": [], "flash_cache_attention": []}
    # -- flash_decode, split convention (the main path) and written.
    lengths = [0, 1, 100, 257, 1000, 1536, 700, 2047]
    lens = torch.tensor(lengths, **i32)
    q, kn, vn = rnd(S, H, hd), rnd(S, KV, hd), rnd(S, KV, hd)
    logical = {quant: caches(quant) for quant in (False, True)}
    for label, quant, B in variants:
        knq, vnq = kn, vn
        if quant:  # the decode step attends its new token fake-quantized
            knq, vnq = fake_quantize_kv(kn), fake_quantize_kv(vn)
        cache, table = logical[quant], None
        if B:
            cache, table = make_pool(torch, gen, cache, lengths, B)
        args = kw(cache, table)
        name = f"flash_decode {label}"
        got = fd.flash_decode(q, lengths=lens, k_new=knq, v_new=vnq, **args)
        err, rel = check_close(torch, name + " (split)", got, fd.flash_decode_plain(
            q.float(), lengths=lens, k_new=knq.float(), v_new=vnq.float(), **f32(args)))
        got_w = fd.flash_decode(q, lengths=lens, **args)
        err_w, rel_w = check_close(torch, name + " (written)", got_w, fd.flash_decode_plain(
            q.float(), lengths=lens, **f32(args)))
        if B:  # the slot cache's kernel on the same logical keys
            flat = fd.flash_decode(q, lengths=lens, k_new=knq, v_new=vnq,
                                   **kw(logical[quant], None))
            d = (got.float() - flat.float()).abs().max().item()
            d_w = (got_w.float() - fd.flash_decode(q, lengths=lens, **kw(logical[quant], None))
                   .float()).abs().max().item()
            log(f"{name}: max|paged - contiguous| {d} (split), {d_w} (written); "
                f"limit {PAGED_VS_CONTIGUOUS_TOL}")
            if max(d, d_w) > PAGED_VS_CONTIGUOUS_TOL:
                fail(f"{name}: the pool's result differs from the slot cache's")
        ms = time_ms(torch, lambda: fd.flash_decode(q, lengths=lens, k_new=knq, v_new=vnq, **args))
        plain_ms = time_ms(torch, lambda: fd.flash_decode_plain(
            q, lengths=lens, k_new=knq, v_new=vnq, **args))
        tok = sum(lengths)
        bytes_ = (2 * S * H * hd * 2 + kv_bytes(tok, KV, hd, quant) + 2 * S * KV * hd * 2
                  + S * 4 + (4 * sum(-(-n // B) for n in lengths) if B else 0))
        bound_ms, bound_by = bound(bytes_, 4 * (tok + S) * H * hd)
        extras = decode_extras(
            torch, fd, name + " (split)",
            lambda: fd.flash_decode(q, lengths=lens, k_new=knq, v_new=vnq, **args), q,
            args["k_cache"], table, 0)
        out["flash_decode"].append(dict(
            case=label, max_abs_err=max(err, err_w), max_row_rel_err=max(rel, rel_w),
            ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
            shape=f"S={S} H={H} KV={KV} hd={hd} max_len={max_len} lengths={lengths}"
                  + (f" block={B}" if B else "") + (" int8" if quant else ""), **extras,
        ))
        log(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}, {bytes_} bytes)")
        del cache, table, args
    del logical

    # -- flash_cache_attention: the rows of phase_kernels.
    P, c = 8, 256
    rows = [(0, 0, 256), (1, 256, 256), (2, 1024, 256), (3, 512, 100),
            (4, 1536, 256), (5, 0, 37), (6, 1792, 200), (0, 0, 256)]
    q = rnd(P, c, H, hd)
    q[P - 1] = q[0]
    slots = torch.tensor([r[0] for r in rows], **i32)
    starts = torch.tensor([r[1] for r in rows], **i32)
    lns = torch.tensor([r[2] for r in rows], **i32)
    keys = [max([s0 + n for sl, s0, n in rows if sl == r] or [0]) for r in range(S)]
    logical = {quant: caches(quant) for quant in (False, True)}
    uniq = sorted(set(rows))
    flops = sum(4 * H * hd * sum(s0 + tt + 1 for tt in range(n)) for _, s0, n in uniq)
    for label, quant, B in variants:
        cache, table = logical[quant], None
        if B:
            cache, table = make_pool(torch, gen, cache, keys, B)
        args = kw(cache, table)
        name = f"flash_cache_attention {label}"
        got = fp.flash_cache_attention(q, slots=slots, starts=starts, lens=lns, **args)
        err, rel = check_close(torch, name, got, fp.flash_cache_attention_plain(
            q.float(), slots=slots, starts=starts, lens=lns, **f32(args)))
        if B:
            flat = fp.flash_cache_attention(q, slots=slots, starts=starts, lens=lns,
                                            **kw(logical[quant], None))
            d = (got.float() - flat.float()).abs().max().item()
            log(f"{name}: max|paged - contiguous| {d}; limit {PAGED_VS_CONTIGUOUS_TOL}")
            if d > PAGED_VS_CONTIGUOUS_TOL:
                fail(f"{name}: the pool's result differs from the slot cache's")
        ms = time_ms(torch, lambda: fp.flash_cache_attention(
            q, slots=slots, starts=starts, lens=lns, **args))
        plain_ms = time_ms(torch, lambda: fp.flash_cache_attention_plain(
            q, slots=slots, starts=starts, lens=lns, **args), runs=20)
        bytes_ = (2 * P * c * H * hd * 2 + sum(kv_bytes(s0 + n, KV, hd, quant) for _, s0, n in uniq)
                  + (4 * sum(-(-n // B) for n in keys) if B else 0))
        bound_ms, bound_by = bound(bytes_, flops)
        out["flash_cache_attention"].append(dict(
            case=label, max_abs_err=err, max_row_rel_err=rel, ms=ms, plain_ms=plain_ms,
            library_ms=None, bound_ms=bound_ms, bound_by=bound_by, tflops=flops / ms / 1e9,
            shape=f"P={P} c={c} H={H} KV={KV} hd={hd} max_len={max_len} rows={rows}"
                  + (f" block={B}" if B else "") + (" int8" if quant else ""),
        ))
        log(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}, {flops / ms / 1e9:.1f} TFLOP/s achieved)")
        del cache, table, args
    return out


def phase_flash_attention(torch, dev) -> dict:
    """flash_attention vs its f32 plain version, per row, at the training,
    lengths, causal-suffix and ViT-B/16 shapes; kernel, plain and SDPA
    times and the bound of each."""
    from gofr_tpu_torch.ops.cuda import flash_attention as fa

    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device=dev).manual_seed(4321)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    cases = [
        # label, b, s_q, s_kv, H, KV, hd, causal, lengths
        ("llama-1b training", 4, 2048, 2048, 16, 4, 128, True, None),
        ("llama-1b lengths", 4, 2048, 2048, 16, 4, 128, True, [2048, 1500, 257, 0]),
        ("causal suffix", 4, 256, 2048, 16, 4, 128, True, None),
        ("vit-b/16", 8, 197, 197, 12, 12, 64, False, None),
    ]
    out = []
    for label, b, s_q, s_kv, H, KV, hd, causal, lengths in cases:
        q, k, v = rnd(b, s_q, H, hd), rnd(b, s_kv, KV, hd), rnd(b, s_kv, KV, hd)
        lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32, device=dev)
        name = f"flash_attention ({label})"
        err, rel = check_close(
            torch, name, fa.flash_attention(q, k, v, lens, causal=causal),
            fa.flash_attention_plain(q.float(), k.float(), v.float(), lens, causal=causal))
        ms = time_ms(torch, lambda: fa.flash_attention(q, k, v, lens, causal=causal))
        plain_ms = time_ms(torch, lambda: fa.flash_attention_plain(
            q, k, v, lens, causal=causal), runs=10)
        # Library yardstick: SDPA in its [b, H, s, hd] layout on the same
        # tensors; its is_causal aligns the diagonal at the top left, so the
        # offset and lengths cases pass the visibility as a mask.
        vis = fa.visible_keys(b, s_q, s_kv, causal=causal, lengths=lens, device=dev)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        gqa = dict(enable_gqa=True) if KV != H else {}
        if lengths is None and s_q == s_kv:
            lib_ms = time_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=causal, **gqa))
        else:
            mask = vis[:, None]
            lib_ms = time_ms(torch, lambda: sdpa(qt, kt, vt, attn_mask=mask, **gqa))
        pairs = int(vis.sum().item()) * (b // vis.shape[0])  # visible (query, key) per head
        keys = sum(min(n, s_kv) for n in lengths) if lengths else b * s_kv
        flops = 4 * H * hd * pairs
        bytes_ = 2 * b * s_q * H * hd * 2 + 2 * keys * KV * hd * 2 + (4 * b if lengths else 0)
        bound_ms = max(bytes_ / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
        out.append(dict(
            case=label, max_abs_err=err, max_row_rel_err=rel, ms=ms, plain_ms=plain_ms,
            library_ms=lib_ms, bound_ms=bound_ms, tflops=flops / ms / 1e9,
            library_tflops=flops / lib_ms / 1e9,
            bound_by="bytes" if bytes_ / HBM_BYTES_PER_S >= flops / BF16_FLOPS else "operations",
            shape=f"b={b} s_q={s_q} s_kv={s_kv} H={H} KV={KV} hd={hd} causal={causal} "
                  f"lengths={lengths}",
        ))
        log(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms (flops {flops}, {flops / ms / 1e9:.1f} TFLOP/s achieved, "
            f"sdpa {flops / lib_ms / 1e9:.1f} on the same useful flops)")
        del q, k, v, vis
    return {"cases": out, **{key: out[0][key] for key in (
        "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "shape")},
        "max_abs_err": max(c["max_abs_err"] for c in out),
        "max_row_rel_err": max(c["max_row_rel_err"] for c in out)}


def phase_f32_kernels(torch, dev) -> dict:
    """The f32 variants of the three kernels at small shapes (the sizes f32
    models run at): flash_decode's f32 instantiations (f32 and int8 caches,
    contiguous and paged, both conventions, with and without the window)
    and csrc/attn_f32.cu for flash_cache_attention (slot cache, pool,
    int8, window) and flash_attention (causal GQA, lengths, window,
    non-causal), each against its f32 plain version per row at
    F32_ROW_REL_TOL, each launching its kernel once. Returns the largest
    max_abs_err per kernel."""
    from gofr_tpu_torch.ops.cuda import flash_attention as fa
    from gofr_tpu_torch.ops.cuda import flash_decode as fd
    from gofr_tpu_torch.ops.cuda import flash_prefill as fp
    from gofr_tpu_torch.ops.kv_cache import fake_quantize_kv, quantize_kv

    gen = torch.Generator(device=dev).manual_seed(32)
    S, H, KV, hd, max_len, W = 4, 8, 2, 64, 256, 60
    i32 = dict(dtype=torch.int32, device=dev)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def once(mod, name, fn, want):
        before = mod.launches
        got = fn()
        torch.cuda.synchronize()
        if mod.launches != before + 1 or got.dtype != torch.float32:
            fail(f"{name}: not one f32 kernel launch")
        return check_close(torch, name, got, want, tol=F32_ROW_REL_TOL)[0]

    def timed(name, fn, plain, bytes_, flops, library=None, peak=F32_FLOPS):
        """Event and device time of one call, its plain version's time, the
        library call's event and device time where there is one, and its
        bound (the f32 CUDA-core peak for the operations, or ``peak``)."""
        ms, dev_ms, plain_ms = time_ms(torch, fn), device_ms(torch, fn), time_ms(torch, plain)
        bound = max(bytes_ / HBM_BYTES_PER_S, flops / peak) * 1e3
        lib = {"library_ms": None}
        if library is not None:
            lib = {"library_ms": time_ms(torch, library),
                   "library_device_ms": device_ms(torch, library)}
        log(f"{name}: kernel {ms:.4f} ms (device {dev_ms:.4f}), plain {plain_ms:.4f} ms, "
            f"library {lib}, bound {bound:.5f} ms")
        return dict(case=name, ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound,
                    bound_by="bytes" if bytes_ / HBM_BYTES_PER_S >= flops / peak
                    else "operations", bound_bytes_ms=bytes_ / HBM_BYTES_PER_S * 1e3,
                    bound_operations_ms=flops / peak * 1e3, **lib)

    errs = {"flash_decode": 0.0, "flash_cache_attention": 0.0, "flash_attention": 0.0}
    times = {}
    lengths = [0, 1, 100, 255]
    lens = torch.tensor(lengths, **i32)
    q = rnd(S, H, hd)
    for quant in (False, True):
        k, v = rnd(S, KV, max_len, hd), rnd(S, KV, max_len, hd)
        cache = [k, v]
        new = dict(k_new=rnd(S, KV, hd), v_new=rnd(S, KV, hd))
        if quant:
            (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
            cache = [k, v, ks, vs]
            new = {key: fake_quantize_kv(t) for key, t in new.items()}
        for B in (0, 32):
            kw = dict(zip(("k_cache", "v_cache", "k_scale", "v_scale"), cache))
            if B:
                pools, table = make_pool(torch, gen, cache, lengths, B)
                kw = dict(zip(("k_cache", "v_cache", "k_scale", "v_scale"), pools),
                          block_table=table)
            for split in (False, True):
                for w in (0, W):
                    label = (f"flash_decode f32{' int8' if quant else ''}"
                             f"{f' paged B={B}' if B else ''} "
                             f"({'split' if split else 'written'}, window {w})")
                    nk = new if split else {}
                    errs["flash_decode"] = max(errs["flash_decode"], once(
                        fd, label, lambda: fd.flash_decode(q, lengths=lens, window=w, **nk, **kw),
                        fd.flash_decode_plain(q, lengths=lens, window=w, **nk, **kw)))
    rows = sum(lengths)
    times["flash_decode"] = timed(
        "flash_decode f32 int8 paged B=32 (written, window 0)",
        lambda: fd.flash_decode(q, lengths=lens, **kw),
        lambda: fd.flash_decode_plain(q, lengths=lens, **kw),
        2 * S * H * hd * 4 + kv_bytes(rows, KV, hd, True), 4 * rows * H * hd)
    rows = [(2, 0, 40), (2, 50, 17), (3, 200, 40), (1, 0, 0)]
    slots, starts, lns = (torch.tensor([r[i] for r in rows], **i32) for i in range(3))
    qc = rnd(len(rows), 40, H, hd)
    k, v = rnd(S, KV, max_len, hd), rnd(S, KV, max_len, hd)
    (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
    keys = [0, 1, 100, 255]
    pools, table = make_pool(torch, gen, [k8, v8, ks, vs], keys, 32)
    for label, kw in (("slot cache", dict(k_cache=k, v_cache=v)),
                      ("int8 pool B=32", dict(zip(("k_cache", "v_cache", "k_scale", "v_scale"),
                                                  pools), block_table=table))):
        for w in (0, W):
            args = dict(slots=slots, starts=starts, lens=lns, window=w, **kw)
            errs["flash_cache_attention"] = max(errs["flash_cache_attention"], once(
                fp, f"flash_cache_attention f32 {label} (window {w})",
                lambda: fp.flash_cache_attention(qc, **args),
                fp.flash_cache_attention_plain(qc, **args)))
    pairs = sum(min(s0 + t + 1, W) for _, s0, n in rows for t in range(n))
    times["flash_cache_attention"] = timed(
        f"flash_cache_attention f32 int8 pool B=32 (window {W})",
        lambda: fp.flash_cache_attention(qc, **args), lambda: fp.flash_cache_attention_plain(
            qc, **args), 2 * qc.numel() * 4 + kv_bytes(sum(s0 + n for _, s0, n in rows), KV, hd,
                                                        True), 4 * pairs * H * hd)
    b, s_ = 2, 300
    qa, ka, va = rnd(b, s_, H, hd), rnd(b, s_, KV, hd), rnd(b, s_, KV, hd)
    for causal, lengths_, w in ((True, None, 0), (True, [300, 120], 80), (False, [300, 0], 0)):
        ln = None if lengths_ is None else torch.tensor(lengths_, **i32)
        errs["flash_attention"] = max(errs["flash_attention"], once(
            fa, f"flash_attention f32 (causal={causal}, lengths={lengths_}, window {w})",
            lambda: fa.flash_attention(qa, ka, va, ln, causal=causal, window=w),
            fa.flash_attention_plain(qa, ka, va, ln, causal=causal, window=w)))
    # SDPA on the same tensors in its [b, H, s, hd] layout: one call
    # computes causal GQA attention in f32 (row 3f) and in bf16 at hd 32
    # (row 3h).
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def sdpa_causal(q_, k_, v_):
        qt, kt, vt = (t.transpose(1, 2) for t in (q_, k_, v_))
        return lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)

    pairs = b * s_ * (s_ + 1) // 2
    times["flash_attention"] = timed(
        f"flash_attention f32 (b={b}, s={s_}, H={H}, KV={KV}, hd={hd}, causal)",
        lambda: fa.flash_attention(qa, ka, va), lambda: fa.flash_attention_plain(qa, ka, va),
        4 * (2 * qa.numel() + 2 * ka.numel()), 4 * H * hd * pairs,
        library=sdpa_causal(qa, ka, va))
    # Row 3h: the bf16 kernel at hd 32 (a 64-column panel) on the same
    # shape, against its f32 plain version at the bf16 limit.
    q16, k16, v16 = (rnd(b, s_, n, 32).to(torch.bfloat16) for n in (H, KV, KV))
    before = fa.launches
    got = fa.flash_attention(q16, k16, v16)
    torch.cuda.synchronize()
    if fa.launches != before + 1:
        fail("flash_attention hd 32: not one kernel launch")
    err32 = check_close(torch, "flash_attention bf16 hd 32 (causal)", got,
                        fa.flash_attention_plain(q16.float(), k16.float(), v16.float()))[0]
    times["flash_attention"]["hd32"] = timed(
        f"flash_attention bf16 hd 32 (b={b}, s={s_}, H={H}, KV={KV}, causal)",
        lambda: fa.flash_attention(q16, k16, v16),
        lambda: fa.flash_attention_plain(q16, k16, v16),
        2 * (2 * q16.numel() + 2 * k16.numel()), 4 * H * 32 * pairs,
        library=sdpa_causal(q16, k16, v16), peak=BF16_FLOPS)
    times["flash_attention"]["hd32"]["max_abs_err"] = err32
    return errs, times


def phase_tiny_models(torch, dev) -> dict:
    """llama-tiny-f32 (f32) and llama-tiny (bf16), both hd 32, on the card
    through the kernels: transformer_forward and transformer_prefill
    (lengths 96 and 40) against the plain path's logits; InferenceEngine's
    greedy streams (prompts of 5, 40 and 77 tokens, 16 new each) against a
    plain-path greedy loop (the full sequence recomputed through the dense
    formula each step), identical in f32; make_train_step for 3 steps,
    finite and falling, one flash_attention launch per layer per forward.
    Returns each model's launch counts over its phase."""
    import numpy as np

    from gofr_tpu_torch.models.registry import get_model
    from gofr_tpu_torch.models.transformer import (
        init_params,
        transformer_forward,
        transformer_prefill,
    )
    from gofr_tpu_torch.ops.cuda import flash_attention as fa
    from gofr_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from gofr_tpu_torch.ops.kv_cache import KVCache
    from gofr_tpu_torch.parallel.sharding import make_train_step
    from gofr_tpu_torch.serving.engine import InferenceEngine

    out = {}
    for name, tol in (("llama-tiny-f32", TINY_F32_DLOGITS_TOL),
                      ("llama-tiny", TINY_BF16_DLOGITS_TOL)):
        cfg = get_model(name).config
        reset_launch_counts()
        with torch.inference_mode():
            params = init_params(cfg, seed=0, device=dev)
            gen = torch.Generator(device=dev).manual_seed(31)
            tokens = torch.randint(0, cfg.vocab_size, (2, 96), generator=gen, device=dev)
            d_fwd = (transformer_forward(params, tokens, cfg)
                     - transformer_forward(params, tokens, cfg, dense_attn=True)).abs().max().item()
            lens = torch.tensor([96, 40], dtype=torch.int32, device=dev)
            slots = torch.arange(2, dtype=torch.int32, device=dev)
            pre = [transformer_prefill(params, tokens, lens, KVCache.create(
                       cfg.n_layers, 2, 128, cfg.n_kv_heads, cfg.head_dim, dtype=cfg.dtype,
                       device=dev), slots, cfg, dense_attn=dense) for dense in (False, True)]
            d_pre = (pre[0] - pre[1]).abs().max().item()
        log(f"{name} ({cfg.dtype}, hd {cfg.head_dim}): max|dlogits| kernels vs plain: "
            f"transformer_forward [2, 96] {d_fwd:.4g}, transformer_prefill (lengths 96, 40) "
            f"{d_pre:.4g} (limit {tol})")
        if not max(d_fwd, d_pre) <= tol:
            fail(f"{name}: the kernels' logits disagree with the plain path's")
        eng = InferenceEngine(name, n_slots=4, max_len=256, window_k=4, prefill_chunk=32,
                              prefill_batch=4, params=params, seed=0, device=dev)
        try:
            rng = np.random.default_rng(5)
            prompts = [rng.integers(0, cfg.vocab_size, m).tolist() for m in (5, 40, 77)]
            reqs = [eng.submit_generate(p, max_new_tokens=16) for p in prompts]
            streams = [r.future.result(timeout=600).token_ids for r in reqs]
        finally:
            eng.close()
        plain = []
        with torch.inference_mode():
            for p, got in zip(prompts, streams):
                seq, toks = list(p), []
                for _ in got:
                    logits = transformer_forward(
                        params, torch.tensor([seq], device=dev), cfg, dense_attn=True)
                    toks.append(int(logits[0, -1].argmax()))
                    seq.append(toks[-1])
                plain.append(toks)
        agree = sum(a == b for g, p in zip(streams, plain) for a, b in zip(g, p))
        total = sum(len(g) for g in streams)
        log(f"{name}: engine greedy streams on the kernels vs the plain path's greedy loop: "
            f"{agree} of {total} tokens agree; first tokens {[g[:6] for g in streams]}")
        if cfg.dtype == torch.float32 and streams != plain:
            fail(f"{name}: the engine's greedy streams differ from the plain path's in f32")
        init_state, train_step, _ = make_train_step(cfg, device=dev)
        masters, opt_state = init_state(0)
        batch = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen, device=dev)
        before = fa.launches
        losses = []
        for _ in range(3):
            loss, masters, opt_state = train_step(masters, opt_state, batch)
            losses.append(loss.item())
        launched = fa.launches - before
        log(f"{name}: make_train_step losses {[round(x, 5) for x in losses]}, "
            f"{launched} flash_attention launches over 3 steps")
        if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
            fail(f"{name}: training losses {losses} are not finite and falling")
        if launched != 3 * cfg.n_layers:
            fail(f"{name}: {launched} flash_attention launches in 3 steps, not "
                 f"{3 * cfg.n_layers}")
        out[name] = launch_counts()
        log(f"{name}: launch counts over the phase {out[name]}")
        del params, masters, opt_state, eng
        torch.cuda.empty_cache()
    return out


def phase_attention_grad(torch, dev) -> None:
    """FlashAttentionFn's gradients (kernel forward, dense-recompute
    backward, bf16) against autograd through the f32 plain version, at
    b=1, s=1024, H=16, KV=4, hd=128, causal."""
    from gofr_tpu_torch.ops.attention import FlashAttentionFn
    from gofr_tpu_torch.ops.cuda import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(99)
    b, s, H, KV, hd = 1, 1024, 16, 4, 128
    q, k, v, g = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                  for shape in ((b, s, H, hd), (b, s, KV, hd), (b, s, KV, hd), (b, s, H, hd)))
    xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    FlashAttentionFn.apply(*xs, True, None).backward(g)
    ys = [t.float().requires_grad_(True) for t in (q, k, v)]
    fa.flash_attention_plain(*ys, causal=True).backward(g.float())
    for name, x, y in zip(("dq", "dk", "dv"), xs, ys):
        check_close(torch, f"FlashAttentionFn {name}", x.grad, y.grad, tol=GRAD_ROW_REL_TOL)


def nan_below(torch, cache: list, table, B: int, rows_below: list) -> list:
    """A copy of the cache tensors with NaN in logical rows [0, n) of each
    slot (K and V; an int8 cache: its scales), through the table for a
    pool: rows a windowed kernel must never read."""
    out = [t.clone() for t in cache]
    targets = out[2:] if len(out) == 4 else out[:2]
    for r, n in enumerate(rows_below):
        if n <= 0:
            continue
        if table is None:
            for t in targets:
                t[r, :, :n] = float("nan")
            continue
        j = torch.arange(n, device=table.device)
        blk, off = table[r, j // B].long(), j % B
        for t in targets:
            t[blk, :, off] = float("nan")
    return out


def plain_attention_rows(torch, fa, q, k, v, lens, window: int, chunk: int = 1024):
    """The f32 plain flash_attention (causal, s_q == s_kv) computed in
    query chunks of ``chunk`` rows, each against the keys it can see: the
    [b, KV, rep, s, s] f32 scores of s = 8192 would not fit."""
    b, s = q.shape[:2]
    outs = []
    for i in range(0, s, chunk):
        n = min(chunk, s - i)
        ln = None if lens is None else lens.clamp(max=i + n)
        outs.append(fa.flash_attention_plain(
            q[:, i:i + n].float(), k[:, :i + n].float(), v[:, :i + n].float(), ln,
            causal=True, window=window))
    return torch.cat(outs, dim=1)


def phase_window_kernels(torch, dev) -> dict:
    """Mistral-7b's sliding window (4096) in all three kernels at its
    shapes (H=32, KV=8, hd=128, max_len 8192): flash_decode on lengths
    around the window's edge in both conventions, flash_cache_attention on
    chunks whose window edge skips whole key tiles, each on the bf16 slot
    cache, a pool of 32, int8 and an int8 pool of 32; flash_attention at
    s=8192 with and without per-row lengths. Each against its f32 plain
    version per row, each pool bit for bit against the slot cache, and
    each rerun with NaN in every row (decode) or key tile (the tiled
    kernels) below the window, which must not change a bit. Kernel, plain,
    bound and library times; the windowed decode beside the unwindowed
    one on the same lengths."""
    from gofr_tpu_torch.ops.cuda import flash_attention as fa
    from gofr_tpu_torch.ops.cuda import flash_decode as fd
    from gofr_tpu_torch.ops.cuda import flash_prefill as fp
    from gofr_tpu_torch.ops.kv_cache import fake_quantize_kv, quantize_kv

    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device=dev).manual_seed(4096)
    H, KV, hd, max_len, S, W = 32, 8, 128, 8192, 8, MISTRAL_WINDOW
    i32 = dict(dtype=torch.int32, device=dev)
    variants = [("bf16 slot cache", False, 0), ("paged B=32", False, 32),
                ("int8", True, 0), ("paged+int8 B=32", True, 32)]

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def caches(quant):
        k, v = rnd(S, KV, max_len, hd), rnd(S, KV, max_len, hd)
        if not quant:
            return [k, v]
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        return [k, v, ks, vs]

    def kw(cache, table):
        out = dict(k_cache=cache[0], v_cache=cache[1])
        if len(cache) == 4:
            out.update(k_scale=cache[2], v_scale=cache[3])
        if table is not None:
            out["block_table"] = table
        return out

    def f32(d):
        return {k: (t.float() if t.dtype == torch.bfloat16 else t) for k, t in d.items()}

    def bound(bytes_, flops):
        return (max(bytes_ / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3,
                "bytes" if bytes_ / HBM_BYTES_PER_S >= flops / BF16_FLOPS else "operations")

    def same_bits(name: str, got, again) -> None:
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            d = (got.float() - again.float()).abs().max().item()
            fail(f"{name}: output changed (max |d| {d}) with NaN where nothing may be read")

    out = {"flash_decode": [], "flash_cache_attention": [], "flash_attention": []}
    # -- flash_decode: lengths around the edge in both conventions (the
    # split query sits at `length`, the written one at `length - 1`).
    lengths = [0, 1, 100, 4095, 4096, 4097, 6000, 8191]
    lens = torch.tensor(lengths, **i32)
    q, kn, vn = rnd(S, H, hd), rnd(S, KV, hd), rnd(S, KV, hd)
    logical = {quant: caches(quant) for quant in (False, True)}
    for label, quant, B in variants:
        knq, vnq = (fake_quantize_kv(kn), fake_quantize_kv(vn)) if quant else (kn, vn)
        new = dict(k_new=knq, v_new=vnq)
        cache, table = logical[quant], None
        if B:
            cache, table = make_pool(torch, gen, cache, lengths, B)
        args = kw(cache, table)
        name = f"flash_decode window {W} {label}"
        got = fd.flash_decode(q, lengths=lens, window=W, **new, **args)
        err, rel = check_close(torch, name + " (split)", got, fd.flash_decode_plain(
            q.float(), lengths=lens, window=W, **f32(new), **f32(args)))
        got_w = fd.flash_decode(q, lengths=lens, window=W, **args)
        err_w, rel_w = check_close(torch, name + " (written)", got_w, fd.flash_decode_plain(
            q.float(), lengths=lens, window=W, **f32(args)))
        if B:
            flat = kw(logical[quant], None)
            d = max((got.float() - fd.flash_decode(q, lengths=lens, window=W, **new, **flat)
                     .float()).abs().max().item(),
                    (got_w.float() - fd.flash_decode(q, lengths=lens, window=W, **flat)
                     .float()).abs().max().item())
            log(f"{name}: max|paged - contiguous| {d}; limit {PAGED_VS_CONTIGUOUS_TOL}")
            if d > PAGED_VS_CONTIGUOUS_TOL:
                fail(f"{name}: the pool's result differs from the slot cache's")
        for split, ref in ((True, got), (False, got_w)):
            below = [max(0, (n if split else n - 1) - W + 1) for n in lengths]
            poisoned = kw(nan_below(torch, cache, table, B, below), table)
            same_bits(f"{name} ({'split' if split else 'written'})", ref, fd.flash_decode(
                q, lengths=lens, window=W, **(new if split else {}), **poisoned))
            del poisoned
        log(f"{name}: NaN in every row below the window changes no output bit")
        ms = time_ms(torch, lambda: fd.flash_decode(q, lengths=lens, window=W, **new, **args))
        ms_full = time_ms(torch, lambda: fd.flash_decode(q, lengths=lens, **new, **args))
        plain_ms = time_ms(torch, lambda: fd.flash_decode_plain(
            q, lengths=lens, window=W, **new, **args))
        lib_ms = library = None
        if label == "bf16 slot cache":
            # SDPA with the written convention's window as a boolean mask.
            cols = torch.arange(max_len, device=dev)[None, :]
            mask = ((cols < lens[:, None]) & (cols > (lens[:, None] - 1 - W)))[:, None, None, :]

            def library():
                return sdpa(q[:, :, None, :], cache[0], cache[1], attn_mask=mask,
                            enable_gqa=True)

            lib_ms = time_ms(torch, library)
        extras = decode_extras(
            torch, fd, name + " (split)",
            lambda: fd.flash_decode(q, lengths=lens, window=W, **new, **args), q,
            args["k_cache"], table, W, library=library)
        # Bound (split convention): the cache rows inside each slot's window
        # (min(length, window - 1) below the new token), q, the new K/V and
        # the output once, and the table entries those rows need.
        rows = sum(min(n, W - 1) for n in lengths)
        tab = sum(-(-n // B) - max(0, n - W + 1) // B for n in lengths if n) if B else 0
        bytes_ = (2 * S * H * hd * 2 + kv_bytes(rows, KV, hd, quant) + 2 * S * KV * hd * 2
                  + S * 4 + 4 * tab)
        bound_ms, bound_by = bound(bytes_, 4 * (rows + S) * H * hd)
        out["flash_decode"].append(dict(
            case=f"window {W} {label}", max_abs_err=max(err, err_w),
            max_row_rel_err=max(rel, rel_w), ms=ms, ms_unwindowed=ms_full, plain_ms=plain_ms,
            library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
            shape=f"S={S} H={H} KV={KV} hd={hd} max_len={max_len} window={W} "
                  f"lengths={lengths}" + (f" block={B}" if B else "") + (" int8" if quant else ""),
            **extras,
        ))
        log(f"{name}: kernel {ms:.4f} ms (unwindowed on the same lengths {ms_full:.4f}), "
            f"plain {plain_ms:.4f} ms, sdpa {lib_ms}, bound {bound_ms:.4f} ms ({bound_by}, "
            f"{bytes_} bytes)")
        del cache, table, args
    del logical, q, kn, vn

    # -- flash_cache_attention: one full chunk per slot at starts around and
    # past the window (row 3 a short chunk); the window edge of a row
    # starting at s lies at s - 4095.
    P, c = 8, 256
    rows = [(i, s0, 100 if i == 3 else c)
            for i, s0 in enumerate((0, 3900, 4000, 4096, 5000, 6000, 7000, 7936))]
    q = rnd(P, c, H, hd)
    slots, starts, lns = (torch.tensor([r[i] for r in rows], **i32) for i in range(3))
    keys = [s0 + n for _, s0, n in rows]
    logical = {quant: caches(quant) for quant in (False, True)}
    pos = starts.long()[:, None] + torch.arange(c, device=dev)[None, :]
    live = torch.arange(c, device=dev)[None, :] < lns.long()[:, None]
    flops = 4 * H * hd * int(torch.where(live, pos.clamp(max=W - 1) + 1, 0).sum().item())
    read = sum(s0 + n - max(0, s0 - W + 1) for _, s0, n in rows)
    below = [max(0, s0 - W + 1) // 64 * 64 for _, s0, _ in rows]  # whole key tiles
    for label, quant, B in variants:
        cache, table = logical[quant], None
        if B:
            cache, table = make_pool(torch, gen, cache, keys, B)
        args = kw(cache, table)
        rk = dict(slots=slots, starts=starts, lens=lns, window=W)
        name = f"flash_cache_attention window {W} {label}"
        got = fp.flash_cache_attention(q, **rk, **args)
        err, rel = check_close(torch, name, got, fp.flash_cache_attention_plain(
            q.float(), **rk, **f32(args)))
        if B:
            d = (got.float() - fp.flash_cache_attention(q, **rk, **kw(logical[quant], None))
                 .float()).abs().max().item()
            log(f"{name}: max|paged - contiguous| {d}; limit {PAGED_VS_CONTIGUOUS_TOL}")
            if d > PAGED_VS_CONTIGUOUS_TOL:
                fail(f"{name}: the pool's result differs from the slot cache's")
        poisoned = kw(nan_below(torch, cache, table, B, below), table)
        same_bits(name, got, fp.flash_cache_attention(q, **rk, **poisoned))
        del poisoned
        log(f"{name}: NaN in every key tile below the window ({sum(below)} rows) changes "
            "no output bit")
        ms = time_ms(torch, lambda: fp.flash_cache_attention(q, **rk, **args))
        plain_ms = time_ms(torch, lambda: fp.flash_cache_attention_plain(q, **rk, **args),
                           runs=10)
        lib_ms = None
        if label == "bf16 slot cache":
            cols = torch.arange(max_len, device=dev)[None, None, :]
            dmask = ((cols <= pos[:, :, None]) & (cols > pos[:, :, None] - W)
                     & live[:, :, None])
            lib_ms = time_ms(torch, lambda: sdpa(q.transpose(1, 2), cache[0], cache[1],
                                                 attn_mask=dmask[:, None], enable_gqa=True))
        bytes_ = (2 * P * c * H * hd * 2 + kv_bytes(read, KV, hd, quant)
                  + (4 * sum(-(-(s0 + n) // B) - max(0, s0 - W + 1) // B for _, s0, n in rows)
                     if B else 0))
        bound_ms, bound_by = bound(bytes_, flops)
        out["flash_cache_attention"].append(dict(
            case=f"window {W} {label}", max_abs_err=err, max_row_rel_err=rel, ms=ms,
            plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
            tflops=flops / ms / 1e9,
            library_tflops=None if lib_ms is None else flops / lib_ms / 1e9,
            shape=f"P={P} c={c} H={H} KV={KV} hd={hd} max_len={max_len} window={W} "
                  f"rows={rows}" + (f" block={B}" if B else "") + (" int8" if quant else ""),
        ))
        log(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms}, bound "
            f"{bound_ms:.4f} ms ({bound_by}, {flops / ms / 1e9:.1f} TFLOP/s achieved)")
        del cache, table, args
    del logical, q

    # -- flash_attention: causal s=8192 with the window, without and with
    # per-row lengths (8192, 5000).
    s = max_len
    for label, b, lengths in (("window 4096", 1, None), ("window 4096 lengths", 2, [8192, 5000])):
        q, k, v = rnd(b, s, H, hd), rnd(b, s, KV, hd), rnd(b, s, KV, hd)
        lens = None if lengths is None else torch.tensor(lengths, **i32)
        name = f"flash_attention ({label})"
        got = fa.flash_attention(q, k, v, lens, causal=True, window=W)
        err, rel = check_close(torch, name, got, plain_attention_rows(torch, fa, q, k, v, lens, W))
        # A causal suffix (the last 1024 queries): key tiles wholly below
        # its first query tile's window edge (keys 0-3071) are never read.
        sq = 1024
        edge = (s - sq - W + 1) // 64 * 64
        ref = fa.flash_attention(q[:, -sq:], k, v, lens, causal=True, window=W)
        k2, v2 = k.clone(), v.clone()
        k2[:, :edge] = float("nan")
        v2[:, :edge] = float("nan")
        same_bits(name + " suffix", ref, fa.flash_attention(q[:, -sq:], k2, v2, lens,
                                                            causal=True, window=W))
        log(f"{name}: NaN in keys 0-{edge - 1} below a {sq}-query suffix's window changes "
            "no output bit")
        del k2, v2, ref
        ms = time_ms(torch, lambda: fa.flash_attention(q, k, v, lens, causal=True, window=W))
        plain_ms = time_ms(torch, lambda: plain_attention_rows(torch, fa, q, k, v, lens, W),
                           runs=3)
        vis = fa.visible_keys(b, s, s, causal=True, lengths=lens, window=W, device=dev)
        lib_ms = time_ms(torch, lambda: sdpa(q.transpose(1, 2), k.transpose(1, 2),
                                             v.transpose(1, 2), attn_mask=vis[:, None],
                                             enable_gqa=True), runs=10)
        pairs = int(vis.sum().item()) * (b // vis.shape[0])
        keys = sum(min(n, s) for n in lengths) if lengths else b * s
        bytes_ = 2 * b * s * H * hd * 2 + 2 * keys * KV * hd * 2 + (4 * b if lengths else 0)
        bound_ms, bound_by = bound(bytes_, 4 * H * hd * pairs)
        out["flash_attention"].append(dict(
            case=label, max_abs_err=err, max_row_rel_err=rel, ms=ms,
            plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
            tflops=4 * H * hd * pairs / ms / 1e9,
            library_tflops=4 * H * hd * pairs / lib_ms / 1e9,
            shape=f"b={b} s_q={s} s_kv={s} H={H} KV={KV} hd={hd} causal=True window={W} "
                  f"lengths={lengths}",
        ))
        log(f"{name}: kernel {ms:.4f} ms, plain (1024-query chunks) {plain_ms:.4f} ms, "
            f"sdpa {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
            f"{4 * H * hd * pairs / ms / 1e9:.1f} TFLOP/s achieved)")
        del q, k, v, vis
    return out


def phase_window_grad(torch, dev) -> None:
    """FlashAttentionFn with mistral-7b's window: gradients (kernel
    forward, dense-recompute backward under the same window, bf16) against
    autograd through the f32 plain version, at one Mistral layer's shape
    past the window (b=1, s=6144, H=32, KV=8, hd=128, window 4096)."""
    from gofr_tpu_torch.ops.attention import FlashAttentionFn
    from gofr_tpu_torch.ops.cuda import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(98)
    b, s, H, KV, hd, W = 1, 6144, 32, 8, 128, MISTRAL_WINDOW
    q, k, v, g = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                  for shape in ((b, s, H, hd), (b, s, KV, hd), (b, s, KV, hd), (b, s, H, hd)))
    xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    FlashAttentionFn.apply(*xs, True, None, W).backward(g)
    grads = [x.grad for x in xs]
    del xs
    ys = [t.float().requires_grad_(True) for t in (q, k, v)]
    fa.flash_attention_plain(*ys, causal=True, window=W).backward(g.float())
    for name, got, y in zip(("dq", "dk", "dv"), grads, ys):
        check_close(torch, f"FlashAttentionFn window {W} {name}", got, y.grad,
                    tol=GRAD_ROW_REL_TOL)
    del ys, grads
    torch.cuda.empty_cache()


def compare_logits(label: str, got: list, want: list, tol: float,
                   near_ties: bool = False) -> float:
    """Logits of a prefill chunk and two decode steps (7 live rows each):
    max |dlogits| within ``tol`` and the same top-1 token on every row;
    with ``near_ties``, a row may pick another token whose logit on the
    ``want`` side is within ``tol`` of that row's best. Returns the
    largest max |dlogits|."""
    worst = 0.0
    for name, a, b in zip(("prefill", "decode1", "decode2"), got, want):
        d = (a - b).abs().max().item()
        worst = max(worst, d)
        pick = a.argmax(-1)
        differ = pick != b.argmax(-1)
        gap = (b.max(-1).values - b.gather(-1, pick[:, None])[:, 0])[differ]
        log(f"forward {name}, {label}: max|dlogits| = {d:.4g} (limit {tol}; logit "
            f"range {a.min().item():.3g}..{a.max().item():.3g}), top-1 agreement "
            f"{1 - differ.float().mean().item():.3f}"
            + (f", differing rows' top-1 gaps {gap.tolist()}" if differ.any() else ""))
        if d > tol:
            fail(f"forward {name}, {label}: max|dlogits| {d} over {tol}")
        if differ.any() and not (near_ties and gap.max().item() <= tol):
            fail(f"forward {name}, {label}: top-1 differs on {int(differ.sum())} of the "
                 "7 rows beyond a near-tie")
    return worst


def phase_forward(torch, dev, cfg, params) -> dict:
    """One prefill chunk and two decode steps, each run on its own cache:
    the bf16 slot cache through the kernels and through the plain path
    (dense_attn=True); pools of 32 and 128 (shuffled tables) through the
    kernels, against the slot cache's kernel run; int8 caches, slot and
    pool of 32, through the kernels against the int8 pool's plain path.
    Returns the kernels' launch counts over each variant's run."""
    from gofr_tpu_torch.models.transformer import decode_step, prefill_chunk, rope_tables
    from gofr_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from gofr_tpu_torch.ops.kv_cache import KVCache, PagedKVCache

    S, max_len, P, c = 8, 2048, 8, 256
    gen = torch.Generator(device=dev).manual_seed(7)
    rope = rope_tables(cfg, max_len, dev)
    lens_l = [256, 256, 100, 1, 200, 256, 50, 256]
    tokens = torch.randint(0, cfg.vocab_size, (P, c), generator=gen, device=dev)
    tokens[P - 1] = tokens[0]
    i32 = dict(dtype=torch.int32, device=dev)
    slots = torch.tensor([0, 1, 2, 3, 4, 5, 6, 0], **i32)
    starts = torch.zeros((P,), **i32)
    lens = torch.tensor(lens_l, **i32)
    active = torch.tensor([True] * 7 + [False], device=dev)
    step_tokens = [torch.randint(0, cfg.vocab_size, (S,), generator=gen, device=dev)
                   for _ in range(2)]
    geo = (cfg.n_layers, S, max_len, cfg.n_kv_heads, cfg.head_dim)

    def run(quant: str, block: int, dense: bool) -> list:
        if block:
            cache = PagedKVCache.create(*geo, dtype=cfg.dtype, quant=quant, block=block,
                                        device=dev)
            n = S * (max_len // block)  # every block of every slot, shuffled
            perm = torch.randperm(n, generator=gen, device=dev) + 1
            cache.block_table.copy_(perm.reshape(S, -1).to(torch.int32))
        else:
            cache = KVCache.create(*geo, dtype=cfg.dtype, quant=quant, device=dev)
        logits = [prefill_chunk(params, tokens, cache, slots, starts, lens, cfg,
                                rope=rope, dense_attn=dense)[:7]]
        cache.lengths[:7] = lens[:7]
        for st in step_tokens:
            logits.append(decode_step(params, st, cache, active, cfg, rope=rope,
                                      dense_attn=dense)[:7])
        torch.cuda.synchronize()
        for name, a in zip(("prefill", "decode1", "decode2"), logits):
            if not torch.isfinite(a).all():
                fail(f"forward {name} (quant={quant!r}, block={block}): non-finite logits")
        return logits

    compare = compare_logits
    counts = {}

    def counted(key: str, *args) -> list:
        reset_launch_counts()
        logits = run(*args)
        counts[key] = launch_counts()
        return logits

    flat = counted("contiguous", "", 0, False)
    compare("kernels vs plain", flat, run("", 0, True), FORWARD_DLOGITS_TOL)
    for B in (32, 128):
        compare(f"pool of {B} vs slot cache (kernels)", counted(f"paged B={B}", "", B, False),
                flat, FORWARD_PAGED_TOL)
    int8_paged = counted("paged+int8 B=32", "int8", 32, False)
    # int8 values make more near-ties between the top two logits than the
    # bf16 check above has met so far; one flipped on an H100 at a gap of
    # under 0.1.
    compare("int8 pool of 32, kernels vs plain", int8_paged, run("int8", 32, True),
            FORWARD_DLOGITS_TOL, near_ties=True)
    compare("int8 slot cache vs int8 pool of 32 (kernels)", counted("int8", "int8", 0, False),
            int8_paged, FORWARD_PAGED_TOL)
    for name, a, b in zip(("prefill", "decode1", "decode2"), int8_paged, flat):
        log(f"forward {name}: int8 cache vs bf16 cache (kernels), the quantization's "
            f"effect: max|dlogits| {(a - b).abs().max().item():.4g}, top-1 agreement "
            f"{(a.argmax(-1) == b.argmax(-1)).float().mean().item():.3f} (no limit)")
    log(f"forward: launch counts per run {json.dumps(counts)}")
    return counts


def load_prefix(torch, cache, base) -> None:
    """Copy a bf16 slot cache's contents (``base``, a KVCache) into
    ``cache`` of any kind: quantized for int8 (as the model writes it),
    scattered through the table for a pool whose table maps every logical
    block; and its lengths."""
    from gofr_tpu_torch.ops.kv_cache import PagedKVCache, quantize_kv

    L, S, KV, max_len, hd = base.k.shape
    for layer in range(L):
        for dst, dst_s, src in ((cache.k, cache.k_s, base.k), (cache.v, cache.v_s, base.v)):
            vals, sc = (quantize_kv(src[layer]) if cache.quantized else (src[layer], None))
            if not isinstance(cache, PagedKVCache):
                dst[layer].copy_(vals)
                if sc is not None:
                    dst_s[layer].copy_(sc)
                continue
            B, nb = cache.block, max_len // cache.block
            for slot in range(S):
                blocks = cache.block_table[slot, :nb].long()
                dst[layer, blocks] = vals[slot].reshape(KV, nb, B, hd).transpose(0, 1)
                if sc is not None:
                    dst_s[layer, blocks] = sc[slot].reshape(KV, nb, B).transpose(0, 1)
    cache.lengths.copy_(base.lengths)


def phase_mistral_forward(torch, dev, cfg, params) -> dict:
    """mistral-7b past its window: three slots first get prompts of 5,000,
    3,900 and 4,096 tokens through the kernels; then, from that state, one
    prefill chunk (rows at 5000, across the window at 3900 and 4096, and
    inside it; a padding row) and two decode steps run on the bf16 slot
    cache through the kernels and through the plain path, on a pool of 32
    (against the slot cache), on int8 caches (slot and pool of 32, through
    the kernels against the int8 plain path), and once more with the window
    off, to show what it changes. Returns the kernels' launch counts over
    each variant's run."""
    import dataclasses

    from gofr_tpu_torch.models.transformer import decode_step, prefill_chunk, rope_tables
    from gofr_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from gofr_tpu_torch.ops.kv_cache import KVCache, PagedKVCache

    S, max_len, P, c = 8, 8192, 8, 256
    gen = torch.Generator(device=dev).manual_seed(17)
    rope = rope_tables(cfg, max_len, dev)
    i32 = dict(dtype=torch.int32, device=dev)
    geo = (cfg.n_layers, S, max_len, cfg.n_kv_heads, cfg.head_dim)
    prefix = {0: 5000, 1: 3900, 3: 4096}
    base = KVCache.create(*geo, dtype=cfg.dtype, device=dev)
    for i in range(-(-max(prefix.values()) // c)):
        toks = torch.randint(0, cfg.vocab_size, (len(prefix), c), generator=gen, device=dev)
        prefill_chunk(params, toks, base, torch.tensor(list(prefix), **i32),
                      torch.full((len(prefix),), i * c, **i32),
                      torch.tensor([min(c, max(0, n - i * c)) for n in prefix.values()], **i32),
                      cfg, rope=rope)
    for slot, n in prefix.items():
        base.lengths[slot] = n
    # The compared chunk: (slot, start, tokens); row 7 pads, duplicating row 0.
    rows = [(0, 5000, 256), (1, 3900, 256), (2, 0, 256), (3, 4096, 100), (4, 0, 1),
            (5, 0, 200), (6, 0, 50), (0, 5000, 256)]
    tokens = torch.randint(0, cfg.vocab_size, (P, c), generator=gen, device=dev)
    tokens[P - 1] = tokens[0]
    slots, starts, lens = (torch.tensor([r[i] for r in rows], **i32) for i in range(3))
    after = torch.tensor([5256, 4156, 256, 4196, 1, 200, 50, 0], **i32)
    active = torch.tensor([True] * 7 + [False], device=dev)
    step_tokens = [torch.randint(0, cfg.vocab_size, (S,), generator=gen, device=dev)
                   for _ in range(2)]

    def run(quant: str, block: int, dense: bool, run_cfg=cfg) -> list:
        if block:
            cache = PagedKVCache.create(*geo, dtype=cfg.dtype, quant=quant, block=block,
                                        device=dev)
            n = S * (max_len // block)  # every block of every slot, shuffled
            perm = torch.randperm(n, generator=gen, device=dev) + 1
            cache.block_table.copy_(perm.reshape(S, -1).to(torch.int32))
        else:
            cache = KVCache.create(*geo, dtype=cfg.dtype, quant=quant, device=dev)
        load_prefix(torch, cache, base)
        logits = [prefill_chunk(params, tokens, cache, slots, starts, lens, run_cfg,
                                rope=rope, dense_attn=dense)[:7]]
        cache.lengths.copy_(after)
        for st in step_tokens:
            logits.append(decode_step(params, st, cache, active, run_cfg, rope=rope,
                                      dense_attn=dense)[:7])
        torch.cuda.synchronize()
        for name, a in zip(("prefill", "decode1", "decode2"), logits):
            if not torch.isfinite(a).all():
                fail(f"mistral forward {name} (quant={quant!r}, block={block}): "
                     "non-finite logits")
        del cache
        torch.cuda.empty_cache()
        return logits

    counts = {}

    def counted(key: str, *args) -> list:
        reset_launch_counts()
        logits = run(*args)
        counts[key] = launch_counts()
        return logits

    log("mistral forward: prefixes of 5000, 3900 and 4096 tokens written through the kernels")
    flat = counted("contiguous", "", 0, False)
    # The near-tie rule of the llama-3-8b int8 check: random weights put
    # the top two logits of a row within a bf16 ulp of each other (a gap of
    # 0.031 on the plain side in a run on an H100).
    noise = compare_logits("mistral-7b kernels vs plain", flat, run("", 0, True),
                           FORWARD_DLOGITS_TOL, near_ties=True)
    compare_logits("mistral-7b pool of 32 vs slot cache (kernels)",
                   counted("paged B=32", "", 32, False), flat, FORWARD_PAGED_TOL)
    int8_paged = counted("paged+int8 B=32", "int8", 32, False)
    compare_logits("mistral-7b int8 pool of 32, kernels vs plain", int8_paged,
                   run("int8", 32, True), FORWARD_DLOGITS_TOL, near_ties=True)
    compare_logits("mistral-7b int8 slot cache vs int8 pool of 32 (kernels)",
                   counted("int8", "int8", 0, False), int8_paged, FORWARD_PAGED_TOL)
    # The window's effect: rows 2, 4, 5, 6 never pass position 4095 and
    # must not move; row 0 (slot 0, at 5000-5257) must move by more than
    # the kernels' own distance from the plain path.
    full = run("", 0, False, dataclasses.replace(cfg, sliding_window=0))
    inside = [2, 4, 5, 6]
    for name, a, b in zip(("prefill", "decode1", "decode2"), flat, full):
        d_in = (a[inside] - b[inside]).abs().max().item()
        d_past = [(a[r] - b[r]).abs().max().item() for r in (0, 1, 3)]
        log(f"mistral forward {name}: window 4096 vs none (kernels): max|dlogits| {d_in:.4g} "
            f"on rows inside the window (limit {FORWARD_PAGED_TOL}); rows past it (slots 0, "
            f"1, 3): {[round(x, 4) for x in d_past]} (slot 0 must exceed {noise:.4g}, the "
            "kernels' distance from the plain path)")
        if d_in > FORWARD_PAGED_TOL or d_past[0] <= noise:
            fail(f"mistral forward {name}: the window did not act as a window")
    del base
    torch.cuda.empty_cache()
    log(f"mistral forward: launch counts per run {json.dumps(counts)}")
    return counts


def phase_mistral_full_sequence(torch, dev, cfg, params) -> dict:
    """mistral-7b through the two full-sequence entry points with the
    window: transformer_prefill on a right-padded [2, 8192] batch (lengths
    8192 and 5000, the kernel's lengths variant) and the eval forward
    transformer_forward on [1, 8192] (FlashAttentionFn); finite logits and
    one flash_attention launch per layer each. Returns the launches."""
    from gofr_tpu_torch.models.transformer import transformer_forward, transformer_prefill
    from gofr_tpu_torch.ops.cuda import flash_attention as fa
    from gofr_tpu_torch.ops.kv_cache import KVCache

    gen = torch.Generator(device=dev).manual_seed(23)
    s = 8192
    tokens = torch.randint(0, cfg.vocab_size, (2, s), generator=gen, device=dev)
    cache = KVCache.create(cfg.n_layers, 2, s, cfg.n_kv_heads, cfg.head_dim,
                           dtype=cfg.dtype, device=dev)
    out = {}
    before = fa.launches
    t0 = time.perf_counter()
    logits = transformer_prefill(params, tokens, torch.tensor([s, 5000], dtype=torch.int32,
                                                              device=dev),
                                 cache, torch.arange(2, dtype=torch.int32, device=dev), cfg)
    torch.cuda.synchronize()
    out["transformer_prefill"] = fa.launches - before
    log(f"mistral transformer_prefill [2, {s}] (lengths {s}, 5000): "
        f"{time.perf_counter() - t0:.3f} s, {out['transformer_prefill']} flash_attention "
        f"launches, logits {tuple(logits.shape)}")
    del cache
    before = fa.launches
    t0 = time.perf_counter()
    full = transformer_forward(params, tokens[:1], cfg)
    torch.cuda.synchronize()
    out["transformer_forward"] = fa.launches - before
    log(f"mistral transformer_forward [1, {s}]: {time.perf_counter() - t0:.3f} s, "
        f"{out['transformer_forward']} flash_attention launches")
    if not (torch.isfinite(logits).all() and torch.isfinite(full).all()):
        fail("mistral full-sequence entry points: non-finite logits")
    # The prefill's row 0 is the forward's row at its last position (the
    # same kernel arithmetic; the GEMMs run at other batch shapes).
    d = (logits[0] - full[0, -1]).abs().max().item()
    log(f"mistral: transformer_prefill vs transformer_forward at position {s - 1}: "
        f"max|dlogits| {d:.4g} (limit {FORWARD_DLOGITS_TOL})")
    if d > FORWARD_DLOGITS_TOL:
        fail("mistral: the padded prefill and the forward disagree on the same tokens")
    for key, n in out.items():
        if n != cfg.n_layers:
            fail(f"mistral {key}: {n} flash_attention launches, not {cfg.n_layers}")
    del full, logits
    torch.cuda.empty_cache()
    return out


def watch_steps(eng) -> dict:
    """From now on, the rows of each prefill dispatch the engine makes (the
    slots mid-prefill when it starts, at most prefill_batch: how admission
    spread the requests over the scheduler's passes) and the host wall
    time of each decode window from its dispatch to its tokens emitted
    (ms; with pipeline_depth windows queued before it). Stop with
    ``unwatch_steps(eng)``."""
    seen = {"rows": [], "window_ms": []}
    prefill, process = eng._prefill_step, eng._process_window

    def counted_prefill():
        if eng._prefilling:
            seen["rows"].append(min(len(eng._prefilling), eng.prefill_batch))
        return prefill()

    def timed_window(win):
        process(win)
        seen["window_ms"].append((time.time() - win.t0) * 1e3)

    eng._prefill_step, eng._process_window = counted_prefill, timed_window
    return seen


def unwatch_steps(eng) -> None:
    del eng._prefill_step, eng._process_window


def steps_line(seen: dict) -> str:
    w = seen["window_ms"]
    return (f"prefill rows per dispatch {seen['rows']}; {len(w)} decode dispatches, "
            f"dispatch to processed median {statistics.median(w):.1f} ms" if w
            else f"prefill rows {seen['rows']}")


# Stream synchronizations (torch.cuda.set_sync_debug_mode "warn": a
# synchronizing copy, .item(), .cpu() ...) counted by the warnings hook
# main installs, while ``count_syncs`` is on.
SYNCS = {"on": False, "n": 0, "first": []}


def count_syncs(torch, on: bool) -> int:
    """Turn sync counting on (from 0) or off; returns the count so far."""
    torch.cuda.set_sync_debug_mode("warn" if on else 0)
    if on:
        SYNCS.update(n=0, first=[])
    SYNCS["on"] = on
    return SYNCS["n"]


def check_sync_counter(torch, dev) -> None:
    """The counter must see a sync it is known to be shown: one .item() on
    another thread, as the engine's scheduler thread would make it."""
    count_syncs(torch, True)
    t = threading.Thread(target=lambda: torch.ones(1, device=dev).item())
    t.start()
    t.join()
    n = count_syncs(torch, False)
    log(f"sync counter: one .item() on another thread counted {n} stream sync(s)")
    if n < 1:
        fail("the stream-sync counter does not see a known sync: its zeros mean nothing")


def _install_sync_hook() -> None:
    import traceback
    import warnings

    shown = warnings.showwarning

    def show(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing" in str(message):
            if SYNCS["on"]:
                SYNCS["n"] += 1
                if len(SYNCS["first"]) < 3:
                    SYNCS["first"].append("".join(traceback.format_stack(limit=8)))
            return
        if "Synchronization debug mode is a prototype" in str(message):
            return
        shown(message, category, filename, lineno, file, line)

    warnings.showwarning = show
    warnings.filterwarnings("always", message=".*called a synchronizing")


def phase_serve(torch, dev, params, *, model: str = "llama-3-8b", n_slots: int = 8,
                max_len: int = 2048, lengths: tuple = LLAMA_PROMPTS, sampled: bool = True,
                solo: int = 4, **kv) -> dict:
    """Concurrent requests (more than the slots) through the port's engine,
    32 new tokens each, on the slot cache or on the cache ``kv`` asks for
    (``kv_block``, ``kv_pool_blocks``, ``kv_quant``; and the decode loop's
    ``pipeline_depth``, ``mega_windows``, ``prefill_depth``): greedy, except
    (with ``sampled``) the last two, one seeded sampled prompt submitted
    twice; prompt ``solo`` rerun alone must repeat its batched stream; the
    run may make no stream synchronization. Returns the
    kernels' launch counts over the concurrent run (graph replays counted),
    each request's token ids and the run's tok/s, TTFT p50, ITL p50,
    decode windows, mega dispatches, prefill dispatches and stream syncs."""
    import numpy as np

    from gofr_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from gofr_tpu_torch.serving.engine import InferenceEngine

    eng = InferenceEngine(
        model, n_slots=n_slots, max_len=max_len, window_k=8, prefill_chunk=256,
        prefill_batch=8, params=params, seed=0, device=dev, **kv,
    )
    label = f"serve {model} {json.dumps(kv) if kv else '(bf16 slot cache)'}"
    n = len(lengths)
    try:
        rng = np.random.default_rng(0)
        vocab = eng.cfg.vocab_size
        prompts = [rng.integers(0, vocab, m).tolist() for m in lengths]
        kws = [dict(max_new_tokens=32)] * n
        if sampled:  # the seeded sampled request, submitted twice
            prompts[n - 1] = prompts[n - 2]
            kws[n - 2:] = [dict(max_new_tokens=32, temperature=0.8, seed=4242)] * 2
        # Warm-up: cuBLAS handles and the first launches, off the record.
        eng.generate_sync([1, 2, 3], max_new_tokens=2, timeout=600)
        torch.cuda.synchronize()
        if eng._graphs is not None:
            log(f"{label}: decode programs captured as CUDA graphs, capture s by variant "
                + json.dumps({k: round(v, 3) for k, v in eng._graphs.capture_s.items()}))
        reset_launch_counts()
        seen = watch_steps(eng)
        steps0 = (eng.decode_windows, eng.mega_dispatches, eng.prefill_steps)
        count_syncs(torch, True)
        t0 = time.perf_counter()
        reqs = [eng.submit_generate(p, **kw) for p, kw in zip(prompts, kws)]
        results = [r.future.result(timeout=600) for r in reqs]
        wall = time.perf_counter() - t0
        syncs = count_syncs(torch, False)
        unwatch_steps(eng)
        counts = launch_counts()
        windows, megas, prefills = (a - b for a, b in zip(
            (eng.decode_windows, eng.mega_dispatches, eng.prefill_steps), steps0))
        log(f"{label}: launch counts over the {n}-request run: {counts}")
        log(f"{label}: {windows} decode windows ({megas} mega dispatches, windows run "
            f"{list(eng.windows_run)[-megas:] if megas else []}), {prefills} prefill "
            f"dispatches, {syncs} stream syncs ({syncs / max(windows, 1):.3f} a window)")
        if syncs:
            fail(f"{label}: {syncs} stream synchronizations in the run; the first at\n"
                 + "\n".join(SYNCS["first"]))
        log(f"{label}: over the run: {steps_line(seen)}")
        eos = eng.tokenizer.eos_id
        for i, (r, res) in enumerate(zip(reqs, results)):
            m = len(res.token_ids)
            if not (m == 32 or (res.finish_reason == "stop" and res.token_ids[-1] == eos)):
                fail(f"{label}: request {i} ended with {m} tokens ({res.finish_reason})")
            if not np.all(np.isfinite(res.token_logprobs)):
                fail(f"{label}: request {i} has non-finite logprobs (NaN logits)")
        if sampled and results[n - 2].token_ids != results[n - 1].token_ids:
            fail(f"{label}: the two seeded sampled runs differ")
        alone = eng.generate_sync(prompts[solo], max_new_tokens=32, timeout=600)
        if alone.token_ids != results[solo].token_ids:
            fail(f"{label}: a greedy prompt alone differs from the same prompt in the batch")
        for name in ("flash_decode", "flash_cache_attention"):
            if counts[name] <= 0:
                fail(f"{label}: kernel {name} was not launched on the main path")
        stats = serve_stats(reqs, wall)
        stats.update(windows=windows, mega_dispatches=megas, prefill_dispatches=prefills,
                     syncs=syncs, counts=counts)
        log(f"{label}: {n} requests (prompts {list(lengths)}, 32 new tokens each) in "
            f"{wall:.3f} s: {stats['tok_s']:.1f} generated tok/s, TTFT p50 "
            f"{stats['ttft_p50_ms']:.1f} ms (max {stats['ttft_max_ms']:.1f}), "
            f"inter-token latency p50 {stats['itl_p50_ms']:.2f} ms; "
            f"{eng.prefill_steps} prefill dispatches, {eng.decode_windows} decode windows "
            "(warm-up included)")
        log(f"{label}: first tokens {[r.token_ids[:4] for r in results]}")
        log(f"{label}: KV cache {eng.cache.hbm_bytes()} bytes on the card")
        if kv.get("kv_block"):
            total, used, _ = eng.kv_pool_counts()
            log(f"{label}: pool of {total} allocatable blocks: peak {eng.kv_blocks_peak} in "
                f"use at once, {used} in use after the run, {eng.kv_admission_waits} "
                "admission passes held back by a dry pool")
            if used != 0 or eng._allocator.n_free != total:
                fail(f"{label}: {used} blocks still held after every request retired")
        return counts, [r.token_ids for r in results], stats
    finally:
        eng.close()


def serve_stats(reqs, wall: float) -> dict:
    """Generated tok/s over the run's wall time, TTFT p50 and max, and the
    p50 of each request's inter-token latency, over the requests that
    emitted tokens (a reaped request counts what it emitted)."""
    done = [r for r in reqs if r.token_times]
    ttfts = sorted(r.ttft_s for r in done)
    itls = [
        (rq.token_times[-1] - rq.token_times[0]) / (len(rq.token_times) - 1)
        for rq in done if len(rq.token_times) > 1
    ]
    return {"tok_s": sum(len(r.token_ids) for r in done) / wall,
            "ttft_p50_ms": statistics.median(ttfts) * 1e3, "ttft_max_ms": ttfts[-1] * 1e3,
            "itl_p50_ms": statistics.median(itls) * 1e3}


class IdTokenizer:
    """Decodes every id of a large vocabulary to text ("<id>" each, so a
    stop string matches at token boundaries only); the byte tokenizer's
    BOS/EOS ids. The serving phases submit token ids, so encode is the
    byte tokenizer's."""

    bos_id, eos_id = 256, 257

    def encode(self, text: str) -> list:
        return [self.bos_id] + list(text.encode("utf-8"))

    def decode(self, ids) -> str:
        return "".join(f"<{int(i)}>" for i in ids)


def _max_repeat(ids) -> int:
    return max(collections.Counter(ids).values())


def _stop_case(base: list, tok) -> tuple:
    """A (prompt index, stop string, expected text, expected kept ids)
    from the greedy baseline streams: the decoded text of tokens j, j+1
    of a stream, where that string first occurs at token j, so the request
    must stop there; j from 4 to 24 where a stream allows it (a stream
    that loops early repeats its pairs), else the latest j below 4."""
    for js in (range(4, 25), range(3, -1, -1)):
        for i in (5, 4, 6, 7, 2, 3):
            ids = base[i]
            text = tok.decode(ids)
            for j in js:
                if j + 2 > len(ids):
                    continue
                stop = tok.decode(ids[j: j + 2])
                cut = text.find(stop)
                if cut == len(tok.decode(ids[:j])):
                    return i, stop, text[:cut], ids[:j]
    fail("serve options: no greedy baseline stream of two tokens or more")


def phase_serve_options(torch, dev, params, base: list, base_stats: dict, **kv) -> dict:
    """The reference's whole request surface through the port's engine at
    full width: InferenceEngine(top_k=50, enable_top_p, enable_penalties,
    top_logprobs=5, class_promote_s=5) serves 10 concurrent requests (32
    new tokens each, the prompts of phase_serve) with mixed options, on
    the cache ``kv`` asks for, and each is checked against the greedy
    baseline streams ``base`` of phase_serve on the same cache:

    two neutral greedy requests equal their baselines (the flags change
    nothing for them); frequency 1.5 + presence 0.5 on the baseline that
    repeats most changes it and repeats no token more often; logit_bias
    {t: 100} emits only t; top_logprobs=5: every step's first alternative
    is the token and its logprob equals the token's within 1e-5; a stop
    string from a baseline's own text ends with finish_reason "stop", the
    text cut at the match and ids and logprobs trimmed alike; two sampled
    requests (temperature 0.8, top_p 0.9, one seed) are identical; one
    request's Deadline expires once it has a token (an injectable clock,
    so the expiry lands mid-stream whatever the host's timing) and one
    request's CancelToken is cancelled after its first token: each raises
    its lifecycle error after at least one token, and every slot and pool
    block is free after the run. flash_decode and flash_cache_attention
    must launch on this run. Returns the launch counts and the run's
    tok/s, TTFT p50 and ITL p50."""
    import numpy as np

    from gofr_tpu_torch.errors import ErrorDeadlineExceeded, ErrorRequestCancelled
    from gofr_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from gofr_tpu_torch.serving.engine import InferenceEngine
    from gofr_tpu_torch.serving.lifecycle import CancelToken, Deadline

    tok = IdTokenizer()
    eng = InferenceEngine(
        "llama-3-8b", n_slots=8, max_len=2048, window_k=8, prefill_chunk=256,
        prefill_batch=8, params=params, seed=0, device=dev, tokenizer=tok,
        top_k=50, enable_top_p=True, enable_penalties=True, top_logprobs=5,
        class_promote_s=5.0, **kv,
    )
    label = f"serve options llama-3-8b {json.dumps(kv) if kv else '(bf16 slot cache)'}"
    try:
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, eng.cfg.vocab_size, m).tolist() for m in LLAMA_PROMPTS]
        pen_i = max(range(8), key=lambda i: _max_repeat(base[i]))
        stop_i, stop, stop_text, stop_ids = _stop_case(base, tok)
        forced = 12345 % eng.cfg.vocab_size
        # Remaining 1e9 s until the request holds a token, then expired:
        # no projected wait sheds it at submit, and it dies mid-stream.
        box = {}
        expired = Deadline(1e9, clock=lambda: 2e9 if box.get("deadline") is not None
                           and box["deadline"].token_ids else 0.0)
        cancel = CancelToken()
        sampled = dict(temperature=0.8, top_p=0.9, seed=4242)
        plan = [
            ("neutral 0", 0, {}),
            ("neutral 1", 1, {}),
            ("penalties", pen_i, dict(frequency_penalty=1.5, presence_penalty=0.5)),
            ("logit_bias", 3, dict(logit_bias={forced: 100.0})),
            ("top_logprobs", 4, dict(top_logprobs=5)),
            ("stop", stop_i, dict(stop=[stop])),
            ("sampled a", 6, sampled),
            ("sampled b", 6, sampled),
            ("deadline", 8, dict(deadline=expired)),
            ("cancel", 9, dict(cancel=cancel)),
        ]
        # Warm-up, off the record: a greedy request and one with every
        # sampler option, so the run does not pay for loading the
        # sampler's kernels at their first use.
        eng.generate_sync([1, 2, 3], max_new_tokens=2, timeout=600)
        eng.generate_sync([1, 2, 3], max_new_tokens=9, timeout=600, temperature=0.8,
                          top_p=0.9, frequency_penalty=0.5, presence_penalty=0.5,
                          logit_bias={forced: 1.0}, top_logprobs=5, seed=1)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        reqs = {}
        for name, i, kw in plan:
            reqs[name] = eng.submit_generate(prompts[i], max_new_tokens=32, **kw)
            if name == "deadline":
                box["deadline"] = reqs[name]
        if reqs["cancel"].stream.get(timeout=600) is None:
            fail(f"{label}: the request to cancel ended before its first token")
        cancel.cancel()
        results, errors = {}, {}
        for name, r in reqs.items():
            try:
                results[name] = r.future.result(timeout=600)
            except (ErrorDeadlineExceeded, ErrorRequestCancelled) as exc:
                errors[name] = exc
        wall = time.perf_counter() - t0
        counts = launch_counts()
        stats = serve_stats(list(reqs.values()), wall)
        log(f"{label}: launch counts over the 10-request run: {counts}")
        for k in ("flash_decode", "flash_cache_attention"):
            if counts[k] <= 0:
                fail(f"{label}: kernel {k} was not launched on the main path")
        if set(errors) != {"deadline", "cancel"}:
            fail(f"{label}: lifecycle errors {sorted(errors)}, expected deadline and cancel")
        if not isinstance(errors["deadline"], ErrorDeadlineExceeded) or not isinstance(
                errors["cancel"], ErrorRequestCancelled):
            fail(f"{label}: wrong lifecycle errors {errors}")
        for name in ("deadline", "cancel"):
            n_tok = len(reqs[name].token_ids)
            if not 1 <= n_tok < 32:
                fail(f"{label}: the {name} request was retired after {n_tok} tokens")
        for i in (0, 1):
            if results[f"neutral {i}"].token_ids != base[i]:
                fail(f"{label}: neutral request {i} differs from the default engine's "
                     "greedy stream")
        pen = results["penalties"].token_ids
        if pen == base[pen_i] or _max_repeat(pen) > _max_repeat(base[pen_i]):
            fail(f"{label}: penalties left prompt {pen_i}'s stream unchanged or repeated a "
                 f"token more often ({_max_repeat(pen)} vs {_max_repeat(base[pen_i])})")
        if results["logit_bias"].token_ids != [forced] * 32:
            fail(f"{label}: logit_bias {{{forced}: 100}} emitted "
                 f"{results['logit_bias'].token_ids[:8]}")
        top = results["top_logprobs"]
        top_err = max(abs(alts[0][1] - lp) for alts, lp in zip(
            top.token_top_logprobs, top.token_logprobs))
        if any(len(a) != 5 or a[0][0] != t for a, t in zip(
                top.token_top_logprobs, top.token_ids)) or top_err > 1e-5:
            fail(f"{label}: top_logprobs' first alternative is not the greedy token "
                 f"(logprob gap {top_err})")
        st = results["stop"]
        if (st.finish_reason, st.text, st.token_ids) != ("stop", stop_text, stop_ids) or len(
                st.token_logprobs) != len(st.token_ids):
            fail(f"{label}: stop {stop!r} gave {st.finish_reason}, {len(st.token_ids)} ids, "
                 f"{len(st.token_logprobs)} logprobs; expected {len(stop_ids)} ids")
        if results["sampled a"].token_ids != results["sampled b"].token_ids:
            fail(f"{label}: the two seeded top_p requests differ")
        for name, res in results.items():
            if not np.all(np.isfinite(res.token_logprobs)):
                fail(f"{label}: {name} has non-finite logprobs")
        if any(s is not None for s in eng._slots) or eng._prefilling:
            fail(f"{label}: a slot is still held after the run")
        if eng.reap_counts != {"deadline": 1, "cancelled": 1}:
            fail(f"{label}: reaps {dict(eng.reap_counts)}")
        if kv.get("kv_block"):
            total, used, _ = eng.kv_pool_counts()
            if used != 0 or eng._allocator.n_free != total:
                fail(f"{label}: {used} pool blocks still held after the run")
        log(f"{label}: every check passed: neutral streams equal the default engine's; "
            f"penalties on prompt {pen_i} (max repeat {_max_repeat(pen)} vs "
            f"{_max_repeat(base[pen_i])}); logit_bias forced {forced} x32; top_logprobs "
            f"first-alternative gap {top_err:.2e}; stop {stop!r} cut at "
            f"{len(stop_ids)} tokens; sampled pair identical; deadline after "
            f"{len(reqs['deadline'].token_ids)} tokens, cancel after "
            f"{len(reqs['cancel'].token_ids)}; reaps {dict(eng.reap_counts)}")
        log(f"{label}: {stats['tok_s']:.1f} generated tok/s, TTFT p50 "
            f"{stats['ttft_p50_ms']:.1f} ms, ITL p50 {stats['itl_p50_ms']:.2f} ms; beside the "
            f"greedy serve on the same cache: {base_stats['tok_s']:.1f} tok/s, TTFT p50 "
            f"{base_stats['ttft_p50_ms']:.1f} ms, ITL p50 {base_stats['itl_p50_ms']:.2f} ms")
        return {"counts": counts, "stats": stats}
    finally:
        eng.close()


def first_difference(torch, cfg, params, prompt: list, want: list, got: list) -> dict | None:
    """Where a greedy stream ``got`` leaves ``want`` (None if it does not):
    the step, the two tokens and the top-2 logit margin there, from the
    plain forward over the prompt and the common prefix (a near-tie below
    NEAR_TIE is accepted as reduction order, anything else is a state
    hazard)."""
    from gofr_tpu_torch.models.transformer import transformer_forward

    step = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b), None)
    if step is None:
        return None if len(want) == len(got) else {"step": min(len(want), len(got)),
                                                   "margin": float("inf")}
    ids = torch.tensor([prompt + want[:step]], device=params["embed"].device)
    logits = transformer_forward(params, ids, cfg)[0, -1].float()
    top = torch.topk(logits, 2).values
    return {"step": step, "want": want[step], "got": got[step],
            "margin": float(top[0] - top[1])}


# A greedy stream may leave another only at a top-2 logit margin below this.
NEAR_TIE = 1e-2


def phase_decode_loop(torch, dev, cfg, params, base: list, base_stats: dict) -> dict:
    """The decode loop at phase_serve's geometry (Llama-3-8B, 8 slots,
    max_len 2048, k = 8): (1) the captured window against the eager one on
    copies of one state after a prefill, every static variant (greedy /
    sampled x logit bias): identical tokens, logprobs within 1e-3, an
    identical cache, the same launches (counted through the replay); the
    mega window (m = 4, a WHILE node) against plain windows, with
    windows_run equal to the reference's exit on the same budgets: two
    sets of budgets without EOS, where it is min(m, ceil(max(remaining) /
    k)), and one where slot 6 stops on an EOS id its third plain window
    produces, where the device's EOS exit ends the loop early; the capture
    time per variant and the graph pools' bytes; (2) phase_serve's 10
    prompts at pipeline depth 1 and 3 and at mega 4 (depth 2 is
    phase_serve's own run): greedy streams equal phase_serve's (a
    difference passes only as a near-tie), the seeded pair equal, no
    stream sync, tok/s, TTFT p50, ITL p50, windows, mega dispatches and
    launches per setting."""
    from gofr_tpu_torch.models.transformer import rope_tables
    from gofr_tpu_torch.ops.cuda import launch_counts, replayed, reset_launch_counts
    from gofr_tpu_torch.ops.kv_cache import KVCache
    from gofr_tpu_torch.serving import programs as pg

    S, L, k, m, c = 8, 2048, 8, 4, 256
    flags = pg.SamplerFlags()
    rope = rope_tables(cfg, L, dev)
    with torch.inference_mode():
        def state():
            cache = KVCache.create(cfg.n_layers, S, L, cfg.n_kv_heads, cfg.head_dim,
                                   dtype=cfg.dtype, device=dev)
            return cache, pg.SlotPlanes.create(S, dev, cfg.vocab_size, flags)

        def copy_state(dst, src):
            for a, b in ((dst[0].k, src[0].k), (dst[0].v, src[0].v),
                         (dst[0].lengths, src[0].lengths)):
                a.copy_(b)
            for f in ("tokens", "nsteps", "seeds", "temps", "greedy", "active", "topps",
                      "fpen", "ppen", "pcounts", "bidx", "bval"):
                getattr(dst[1], f).copy_(getattr(src[1], f))

        def win(st, sampling, use_bias):
            return pg.decode_window(params, st[0], cfg, rope, st[1], flags, k, 2,
                                    sampling=sampling, use_bias=use_bias)

        def capture(**fns):
            """DecodeGraphs on ``graphed`` while every slot of it is
            inactive, as the engine captures before its first request:
            (the graphs, seconds with the warm-ups, pool bytes reserved)."""
            graphed[1].active.fill_(False)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            reserved0 = torch.cuda.memory_reserved()
            t0 = time.perf_counter()
            graphs = pg.DecodeGraphs(**fns)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            torch.cuda.empty_cache()
            return graphs, seconds, torch.cuda.memory_reserved() - reserved0

        eager, graphed = state(), state()
        graphs, capture_s, pool = capture(window_fn=lambda s, b: win(graphed, s, b))
        log(f"decode loop: captured 4 window variants in {capture_s:.2f} s (warm-up "
            "included); capture alone by variant "
            + json.dumps({key: round(v, 3) for key, v in graphs.capture_s.items()})
            + f"; graph memory pool {pool} bytes reserved; launches a replayed window "
            + json.dumps({str(v): g.launches for v, g in graphs.windows.items()}))

        # One prefill chunk puts a prompt in every slot.
        gen = torch.Generator(device=dev).manual_seed(0)
        i32 = dict(dtype=torch.int32, device=dev)
        ones = torch.ones((S,), dtype=torch.bool, device=dev)
        lens = torch.tensor((1, 17, 64, 100, 150, 200, 255, 256), **i32)
        toks = torch.randint(0, cfg.vocab_size, (S, c), generator=gen, device=dev)
        planes = eager[1]
        planes.seeds.copy_(torch.arange(S, device=dev) * 7 + 1)
        planes.bidx[:, :3] = torch.randint(0, cfg.vocab_size, (S, 3), generator=gen, device=dev)
        planes.bval[:, :3] = 5.0
        sampled_rows = torch.arange(S, device=dev) % 2 == 1
        pg.prefill_chunk_step(params, eager[0], cfg, rope, planes, flags, toks,
                              torch.arange(S, **i32), torch.zeros((S,), **i32), lens, ones,
                              ones, torch.full((S,), 0.8, device=dev), ~sampled_rows,
                              torch.ones((S,), device=dev), 2, sampling=True)
        planes.active.fill_(True)
        planes.temps.fill_(0.8)
        planes.greedy.copy_(~sampled_rows)
        start = state()
        copy_state(start, eager)
        results = {}
        for v in pg.VARIANTS:
            copy_state(eager, start)
            copy_state(graphed, start)
            reset_launch_counts()
            e = win(eager, *v).clone()
            torch.cuda.synchronize()
            eager_counts = launch_counts()
            reset_launch_counts()
            g = graphs.window(*v).clone()
            torch.cuda.synchronize()
            graph_counts = launch_counts()
            dlp = float((e[1] - g[1]).abs().max())
            results[str(v)] = {"tokens_equal": bool(torch.equal(e[0], g[0])),
                               "max_abs_dlogprob": dlp, "bitwise": bool(torch.equal(e, g)),
                               "cache_equal": bool(torch.equal(eager[0].k, graphed[0].k)
                                                   and torch.equal(eager[0].v, graphed[0].v)),
                               "launches_eager": eager_counts, "launches_graph": graph_counts}
            r = results[str(v)]
            if not r["tokens_equal"] or dlp > 1e-3 or not r["cache_equal"]:
                fail(f"decode loop: the captured window {v} differs from the eager one: {r}")
            if eager_counts != graph_counts or graph_counts["flash_decode"] != k * cfg.n_layers:
                fail(f"decode loop: launches eager {eager_counts} vs replayed {graph_counts}")
        log("decode loop: captured window vs eager, (sampling, use_bias): "
            + json.dumps({key: {x: y for x, y in r.items() if not x.startswith("launches")}
                          for key, r in results.items()})
            + f"; launches a window eager = replayed = {graph_counts}")
        del graphs

        # m plain windows from the start; the EOS id of the mega graphs is
        # a token slot 6 first produces in its third window, so that the
        # device's EOS exit is reached on the card.
        copy_state(eager, start)
        plain = torch.cat([win(eager, False, False) for _ in range(m)], dim=1)
        streams = plain[0].long().t().tolist()  # [S][m·k]
        eos_slot, s6 = 6, streams[6]
        eos = s6[next((p for p in range(2 * k, 3 * k) if s6[p] not in s6[:p]), 2 * k)]
        mega = pg.MegaState.create(S, k, m, 0, dev)
        megas, mega_capture_s, mega_pool = capture(mega_fns=(
            lambda: pg.mega_begin(mega),
            lambda s, b: pg.mega_step(params, graphed[0], cfg, rope, graphed[1], flags, k,
                                      m, 2, eos, mega, sampling=s, use_bias=b),
            mega.go))
        log(f"decode loop: captured 4 mega-body variants in {mega_capture_s:.2f} s (warm-up "
            "included); capture alone by variant "
            + json.dumps({key: round(v, 3) for key, v in megas.capture_s.items()})
            + f"; graph memory pool {mega_pool} bytes reserved; EOS id {eos}")

        def exit_after(remaining, stop):
            """The reference's exit on the host: windows run while (w < m)
            & any(remaining > 0), remaining less k a window, 0 on EOS
            where the slot stops on it."""
            rem, w = list(remaining), 0
            while w < m and any(x > 0 for x in rem):
                rem = [0 if stop[i] and eos in streams[i][w * k:(w + 1) * k]
                       else max(0, x - k) for i, x in enumerate(rem)]
                w += 1
            return w

        no_stop = (False,) * S
        eos_stop = tuple(i == eos_slot for i in range(S))
        for remaining, stop in (((0, 5, 9, 17, 3, 12, 30, 1), no_stop),
                                ((0, 5, 9, 12, 3, 1, 0, 2), no_stop),
                                ((0, 5, 9, 3, 3, 1, 30, 1), eos_stop)):
            want_w = exit_after(remaining, stop)
            budget_w = min(m, -(-max(remaining) // k))
            if stop is no_stop and want_w != budget_w:
                fail(f"decode loop: the exit {want_w} is not min(m, ceil(max / k)) {budget_w}")
            if stop is eos_stop and want_w >= budget_w:
                fail(f"decode loop: EOS id {eos} does not end slot {eos_slot}'s windows early")
            copy_state(graphed, start)
            mega.remaining.copy_(torch.tensor(remaining, device=dev))
            mega.eos_stop.copy_(torch.tensor(stop, device=dev))
            reset_launch_counts()
            record = megas.mega(False, False)
            torch.cuda.synchronize()
            w = int(mega.w)
            replayed(record, w)
            got, want = mega.emitted[:, : w * k], plain[:, : want_w * k]
            ok = (w == want_w and torch.equal(got[0], want[0])
                  and float((got[1] - want[1]).abs().max()) <= 1e-3
                  and not mega.emitted[:, w * k:].any())
            log(f"decode loop: mega window (m={m}) with remaining {list(remaining)}, EOS stop "
                f"{[i for i, x in enumerate(stop) if x]}: windows_run {w} (the reference's exit "
                f"{want_w}; budgets alone {budget_w}); tokens equal to {want_w} plain windows: "
                f"{w == want_w and bool(torch.equal(got[0], want[0]))}, bitwise "
                f"{w == want_w and bool(torch.equal(got, want))}; launches {launch_counts()}")
            if not ok:
                fail("decode loop: the mega window's graph differs from plain windows")
            if launch_counts()["flash_decode"] != w * k * cfg.n_layers:
                fail("decode loop: the mega window's launches are not its windows'")
        del megas, eager, graphed, start, mega, plain
        gc.collect()
        torch.cuda.empty_cache()

    rng = __import__("numpy").random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in LLAMA_PROMPTS]
    settings = {"depth 2 (phase_serve's run)": base_stats}
    for label, kw in (("depth 1", dict(pipeline_depth=1)), ("depth 3", dict(pipeline_depth=3)),
                      ("mega 4 depth 2", dict(mega_windows=4))):
        counts, streams, stats = phase_serve(torch, dev, params, **kw)
        for i in range(len(LLAMA_PROMPTS) - 2):  # the greedy ones
            diff = first_difference(torch, cfg, params, prompts[i], base[i], streams[i])
            if diff is None:
                continue
            log(f"decode loop {label}: request {i} leaves phase_serve's stream: {diff}")
            if diff["margin"] >= NEAR_TIE:
                fail(f"decode loop {label}: request {i} differs from phase_serve's stream "
                     f"at a top-2 margin {diff['margin']:.4g} >= {NEAR_TIE}: a state hazard")
        for name in ("flash_decode", "flash_cache_attention"):
            if counts[name] <= 0:
                fail(f"decode loop {label}: kernel {name} was not launched")
        settings[label] = stats
    log("decode loop settings: " + json.dumps({
        label: {key: st.get(key) for key in (
            "tok_s", "ttft_p50_ms", "itl_p50_ms", "windows", "mega_dispatches",
            "prefill_dispatches", "syncs", "counts")}
        for label, st in settings.items()}))
    return {"capture_s": capture_s, "pool_bytes": pool, "mega_capture_s": mega_capture_s,
            "mega_pool_bytes": mega_pool, "settings": settings}


class _SSEClient(threading.Thread):
    """One streaming /v1/completions request over its own socket: the
    status, each SSE line with its arrival time (perf_counter), and the
    submit time. Lines are parsed after the run, so the client's share of
    the GIL while tokens arrive stays small."""

    def __init__(self, port: int, body: dict, headers: dict | None = None) -> None:
        super().__init__(daemon=True)
        self.port, self.body, self.headers = port, body, dict(headers or {})
        self.status, self.content_type, self.lines, self.error = 0, "", [], None

    def run(self) -> None:
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=600)
        try:
            self.t_submit = time.perf_counter()
            conn.request("POST", "/v1/completions", body=json.dumps(self.body),
                         headers={"Content-Type": "application/json", **self.headers})
            resp = conn.getresponse()
            self.status, self.content_type = resp.status, resp.getheader("Content-Type", "")
            if self.content_type != "text/event-stream":
                self.lines.append((time.perf_counter(), resp.read()))
                return
            while line := resp.readline():
                if line.startswith(b"data: "):
                    self.lines.append((time.perf_counter(), line[6:].strip()))
        except Exception as exc:  # reported by the phase as a failed check
            self.error = exc
        finally:
            conn.close()

    def events(self) -> list:
        """(arrival time, parsed event or "[DONE]") for an SSE response."""
        return [(t, raw.decode() if raw == b"[DONE]" else json.loads(raw))
                for t, raw in self.lines]

    def token_arrivals(self) -> list:
        """(arrival time, token id) for every id the stream delivered
        (``stream_options.include_tokens``)."""
        return [(t, tok) for t, ev in self.events() if isinstance(ev, dict)
                for ch in ev.get("choices", []) for tok in ch.get("token_ids", [])]


def _http_json(port: int, method: str, path: str, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request(method, path, body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def phase_http(torch, dev, base: list, base_stats: dict, *, model: str = "llama-3-8b",
               lengths: tuple = LLAMA_PROMPTS, geometry: dict | None = None) -> dict:
    """The port's own App serving over HTTP at full width: App(config=
    MockConfig) built from config alone (TPU_MODEL and phase_serve's
    geometry, ports 0; the engine makes the same seed-0 weights as
    phase_serve's), add_openai_routes and one ctx.infer route, started on
    an event-loop thread. Checks: the engine is on CUDA and
    /.well-known/health is UP and names the card; phase_serve's 10
    prompts sent concurrently over real sockets as streaming
    /v1/completions (token-id prompts, 32 tokens, include_tokens): the 8
    greedy streams equal phase_serve's ``base`` token for token and the
    seeded pair (temperature 0.8, seed 4242) equal each other; one chat
    completion, one ctx.infer request, one overlong prompt that gets 413
    with ErrorPromptTooLong's message before any SSE header, and one
    request with X-Request-Timeout 0.05 that ends early (504, or a stream
    ended by the deadline's error event); /metrics: app_tpu_tokens_generated
    equals the tokens the client received and app_http_response counts
    each (path, status) the client saw; flash_decode and
    flash_cache_attention launched in the phase; after App.stop (no
    TPU_DRAIN_S) every slot is free. Prints tok/s, TTFT p50 (client clock:
    submit to the first SSE chunk that carries a token) and ITL p50 over
    HTTP beside the direct engine's ``base_stats``."""
    import asyncio

    import numpy as np

    from gofr_tpu_torch import App
    from gofr_tpu_torch.config import MockConfig
    from gofr_tpu_torch.errors import ErrorPromptTooLong
    from gofr_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from gofr_tpu_torch.serving.openai_compat import add_openai_routes

    geometry = geometry or {"TPU_KV_SLOTS": "8", "TPU_MAX_LEN": "2048",
                            "TPU_DECODE_WINDOW": "8", "TPU_PREFILL_CHUNK": "256",
                            "TPU_PREFILL_BATCH": "8"}
    label = f"http {model}"
    t0 = time.perf_counter()
    app = App(config=MockConfig({
        "APP_NAME": "chip-smoke", "HTTP_PORT": "0", "METRICS_PORT": "0",
        "LOG_LEVEL": "WARN", "TPU_MODEL": model, "TPU_DEVICE": str(dev), **geometry}))
    eng = app.container.tpu
    log(f"{label}: App built from config in {time.perf_counter() - t0:.1f} s "
        f"(engine on {eng.device}, {eng.n_slots} slots x {eng.max_len}, k={eng.window_k}, "
        f"chunk {eng.prefill_batch} x {eng.prefill_chunk})")
    add_openai_routes(app)

    @app.post("/infer")
    async def infer(ctx):
        body = ctx.request.json()
        return await ctx.infer(body["prompt"], max_new_tokens=32, temperature=0.0)

    loop = asyncio.new_event_loop()
    loop_thread = threading.Thread(target=loop.run_forever, name="http-loop", daemon=True)
    loop_thread.start()
    stopped = False
    try:
        asyncio.run_coroutine_threadsafe(app.start(), loop).result(timeout=120)
        port = app.http_port
        if eng.device.type != dev.type:
            fail(f"{label}: the App's engine is on {eng.device}, not {dev}")
        status, raw = _http_json(port, "GET", "/.well-known/health")
        health = json.loads(raw)["data"]
        devices = health["details"]["tpu"]["details"]["devices"]
        if status != 200 or health["status"] != "UP" or (
                dev.type == "cuda" and torch.cuda.get_device_name(dev) not in devices[0]):
            fail(f"{label}: /.well-known/health {status} {health['status']} {devices}")
        log(f"{label}: /.well-known/health UP on {devices}")
        seen = collections.Counter({("/.well-known/health", 200): 1})
        received = 0  # generated tokens the client was sent
        # Warm-up over HTTP, off the record (the first launches).
        status, raw = _http_json(port, "POST", "/v1/completions", {
            "prompt": [1, 2, 3], "max_tokens": 2, "temperature": 0})
        seen[("/v1/completions", status)] += 1
        received += json.loads(raw)["usage"]["completion_tokens"]
        if dev.type == "cuda":
            torch.cuda.synchronize()

        rng = np.random.default_rng(0)
        vocab = eng.cfg.vocab_size
        prompts = [rng.integers(0, vocab, m).tolist() for m in lengths]
        n = len(prompts)
        prompts[n - 1] = prompts[n - 2]
        sampling = [dict(temperature=0.0)] * (n - 2) + [dict(temperature=0.8, seed=4242)] * 2
        # The engine's own records of the run's requests (submit time,
        # first-token time), to split the client's TTFT into the spread of
        # arrivals, the engine's TTFT and the delivery.
        submitted = []
        submit = eng.submit_generate

        def spy(*args, **kw):
            req = submit(*args, **kw)
            submitted.append(req)
            return req

        eng.submit_generate = spy
        steps = watch_steps(eng)
        reset_launch_counts()
        clients = [_SSEClient(port, {
            "prompt": p, "max_tokens": 32, "stream": True,
            "stream_options": {"include_tokens": True}, **kw})
            for p, kw in zip(prompts, sampling)]
        t_run = time.perf_counter()
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=600)
        wall = time.perf_counter() - t_run
        del eng.submit_generate
        unwatch_steps(eng)
        streams = []
        for i, c in enumerate(clients):
            seen[("/v1/completions", c.status)] += 1
            if c.error is not None or c.status != 200 or c.content_type != "text/event-stream":
                fail(f"{label}: stream {i}: status {c.status} {c.content_type} {c.error!r}")
            events = c.events()
            if events[-1][1] != "[DONE]" or "error" in events[-2][1]:
                fail(f"{label}: stream {i} did not end cleanly: {events[-2:]}")
            streams.append([tok for _, tok in c.token_arrivals()])
            received += len(streams[-1])
        for i in range(n - 2):
            if streams[i] != base[i]:
                fail(f"{label}: greedy stream {i} over HTTP differs from phase_serve's: "
                     f"{streams[i][:8]} vs {base[i][:8]}")
        if streams[n - 2] != streams[n - 1]:
            fail(f"{label}: the two seeded sampled streams differ")
        arrivals = [c.token_arrivals() for c in clients]
        ttfts = sorted(a[0][0] - c.t_submit for a, c in zip(arrivals, clients))
        itls = [(a[-1][0] - a[0][0]) / (len(a) - 1) for a in arrivals if len(a) > 1]
        stats = {"tok_s": sum(len(s) for s in streams) / wall,
                 "ttft_p50_ms": statistics.median(ttfts) * 1e3, "ttft_max_ms": ttfts[-1] * 1e3,
                 "itl_p50_ms": statistics.median(itls) * 1e3}
        t_first_submit = min(r.enqueued_at for r in submitted)
        stats.update(
            arrival_spread_ms=(max(r.enqueued_at for r in submitted) - t_first_submit) * 1e3,
            engine_ttft_p50_ms=statistics.median(r.ttft_s for r in submitted) * 1e3,
            engine_itl_p50_ms=statistics.median(
                (r.token_times[-1] - r.token_times[0]) / (len(r.token_times) - 1)
                for r in submitted if len(r.token_times) > 1) * 1e3)

        status, raw = _http_json(port, "POST", "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "hello"}], "max_tokens": 16,
            "temperature": 0})
        seen[("/v1/chat/completions", status)] += 1
        chat = json.loads(raw)
        if status != 200 or chat["object"] != "chat.completion":
            fail(f"{label}: chat completion {status}: {raw[:200]!r}")
        received += chat["usage"]["completion_tokens"]
        status, raw = _http_json(port, "POST", "/infer", {"prompt": prompts[0]})
        seen[("/infer", status)] += 1
        infer_out = json.loads(raw)["data"]
        if status != 201 or not 1 <= infer_out["tokens"] <= 32:
            fail(f"{label}: ctx.infer {status}: {raw[:200]!r}")
        received += infer_out["tokens"]
        long_prompt = rng.integers(0, vocab, eng.max_len + 50).tolist()
        too_long = _SSEClient(port, {"prompt": long_prompt, "max_tokens": 4, "stream": True})
        too_long.run()
        seen[("/v1/completions", too_long.status)] += 1
        want = str(ErrorPromptTooLong(len(long_prompt), eng.max_prompt_tokens))
        got = json.loads(too_long.lines[0][1]) if too_long.lines else {}
        if (too_long.status, too_long.content_type) != (413, "application/json") or got.get(
                "error", {}).get("message") != want:
            fail(f"{label}: overlong prompt gave {too_long.status} {too_long.content_type} "
                 f"{got}; expected 413 before any SSE header with {want!r}")
        late = _SSEClient(port, {"prompt": prompts[3], "max_tokens": 32, "temperature": 0,
                                 "stream": True, "stream_options": {"include_tokens": True}},
                          headers={"X-Request-Timeout": "0.05"})
        late.run()
        seen[("/v1/completions", late.status)] += 1
        if late.status == 504:
            how = "504 before admission"
        else:
            events = late.events() if late.status == 200 else []
            err = events[-2][1].get("error", {}) if len(events) >= 2 else {}
            if err.get("code") != 504:
                fail(f"{label}: the 0.05 s deadline request did not end early: "
                     f"{late.status} {late.lines[-2:]}")
            received += len(late.token_arrivals())
            how = f"stream cut after {len(late.token_arrivals())} tokens"
        counts = launch_counts()

        status, raw = _http_json(app.metrics_port, "GET", "/metrics")
        text = raw.decode()
        m = re.search(r'^app_tpu_tokens_generated\{model="([^"]+)"\} (\S+)$', text, re.M)
        if m is None or float(m.group(2)) != received:
            fail(f"{label}: app_tpu_tokens_generated {m and m.group(2)} != {received} tokens "
                 "the client received")
        http_counts = collections.Counter()
        for path, code, value in re.findall(
                r'^app_http_response_count\{method="\w+",path="([^"]+)",status="(\d+)"\} '
                r'(\d+)$', text, re.M):
            http_counts[(path, int(code))] += int(value)
        if http_counts != seen:
            fail(f"{label}: app_http_response counts {dict(http_counts)} != the client's "
                 f"{dict(seen)}")
        for k in ("flash_decode", "flash_cache_attention"):
            if counts[k] <= 0:
                fail(f"{label}: kernel {k} was not launched in the HTTP phase")
        log(f"{label}: launch counts over the phase: {counts}")
        log(f"{label}: every check passed: 8 greedy streams equal phase_serve's, the seeded "
            f"pair equal; chat {chat['usage']['completion_tokens']} tokens; ctx.infer "
            f"{infer_out['tokens']} tokens; overlong prompt 413 before headers; deadline "
            f"0.05 s: {how}; app_tpu_tokens_generated {received:.0f} = tokens received; "
            f"app_http_response {dict(seen)}")
        log(f"{label}: {n} streaming requests in {wall:.3f} s: {stats['tok_s']:.1f} generated "
            f"tok/s, TTFT p50 {stats['ttft_p50_ms']:.1f} ms (max {stats['ttft_max_ms']:.1f}), "
            f"ITL p50 {stats['itl_p50_ms']:.2f} ms (client clock); the direct engine in "
            f"phase_serve: {base_stats['tok_s']:.1f} tok/s, TTFT p50 "
            f"{base_stats['ttft_p50_ms']:.1f} ms, ITL p50 {base_stats['itl_p50_ms']:.2f} ms")
        log(f"{label}: on the engine's clock: the {n} submits arrived over "
            f"{stats['arrival_spread_ms']:.1f} ms, engine TTFT p50 (submit to first token) "
            f"{stats['engine_ttft_p50_ms']:.1f} ms, engine ITL p50 "
            f"{stats['engine_itl_p50_ms']:.2f} ms; {steps_line(steps)}")
        asyncio.run_coroutine_threadsafe(app.stop(), loop).result(timeout=300)
        stopped = True
        if any(s is not None for s in eng._slots) or eng._prefilling or eng.state != "DOWN":
            fail(f"{label}: after App.stop a slot is still held or the engine is "
                 f"{eng.state}")
        return {"counts": counts, "stats": stats}
    finally:
        if not stopped:
            asyncio.run_coroutine_threadsafe(app.stop(), loop).result(timeout=300)
        loop.call_soon_threadsafe(loop.stop)
        loop_thread.join(timeout=30)
        loop.close()


def _busy_ms(events) -> tuple[float, int]:
    """Union of the GPU kernel intervals (ms) and the number of kernels."""
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in events
        if str(getattr(e, "device_type", "")).endswith("CUDA")
    )
    busy_us, cur_s, cur_e = 0.0, None, None
    for a, b in spans:
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    return busy_us / 1e3, len(spans)


def _profile_step(torch, name: str, fn) -> dict:
    """Host wall time of ``fn`` (ending in a synchronize), then one traced
    run: device busy time, idle share of the traced wall time, GPU kernels,
    the top kernels by device time and the port's own kernels' time. Where
    torch.profiler traces no GPU kernel, the device busy time is that of
    one call queued behind a spin kernel (``queued_ms``; the kernels'
    names are then not seen), or not measured where ``fn`` waits for the
    device itself."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    for _ in range(2 if DEVICE_TIMER["by"] == "torch.profiler" else 0):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3
        busy_ms, n_kernels = _busy_ms(prof.events())
        if n_kernels:
            averages = prof.key_averages()
            top = sorted(
                ((a.self_device_time_total, a.key, a.count) for a in averages
                 if a.self_device_time_total > 0),
                reverse=True,
            )
            ours = {}
            for a in averages:
                m = re.search(r"flash_\w+_kernel<[^>]*>", a.key)
                if m and a.self_device_time_total > 0:
                    ours[m.group(0)] = {"ms": a.self_device_time_total / 1e3,
                                        "count": a.count}
            return {
                "step": name, "wall_ms": wall_ms, "traced_wall_ms": traced_ms,
                "device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / traced_ms,
                "gpu_kernels": n_kernels, "device_time_by": DEVICE_TIMER["by"],
                "top_kernels_ms": [
                    {"kernel": k[:90], "ms": us / 1e3, "count": c} for us, k, c in top[:8]
                ],
                "port_kernels_ms": ours,
            }
    _profiler_traces_nothing()
    busy_ms = queued_ms(torch, fn, runs=1)
    return {
        "step": name, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "idle_share": None if busy_ms is None else 1.0 - busy_ms / wall_ms,
        "device_time_by": DEVICE_TIMER["by"] if busy_ms is not None else
        "not measured: no GPU kernel in the torch.profiler trace, and the step waits "
        "for the device itself",
    }


def phase_profile(torch, dev, cfg, params, *, S: int = 8, max_len: int = 2048,
                  context: int = 256, model: str = "", sampler: bool = False,
                  graph: bool = False) -> None:
    """Where the time goes in one 8-step decode window over S slots at
    ``context`` tokens each, and in one [S, 256] prefill chunk starting at
    ``context``, through the engine's own programs (greedy, the sampler's
    flags off). Each slot's first 256 positions hold a prompt; the rest up
    to ``context`` stay zero (the time depends on the lengths, not on the
    values). With ``sampler``, the window again with every sampler flag
    on (top_k 50, top_p, penalties, top_logprobs 5) and every slot using
    every option (temperature 0.8, top_p 0.9, both penalties, 300
    logit_bias entries, 5 alternatives), and the sampler's own device time
    per window (its 8 steps on [S, vocab] logits): every option with the
    flags on, a greedy batch of neutral options with the flags on, and
    greedy with the flags off. With ``graph``, the window again as the
    engine runs it on the card: one replay of its CUDA graph (the capture
    time and the graph pool's bytes printed)."""
    from gofr_tpu_torch.models.transformer import rope_tables
    from gofr_tpu_torch.ops.kv_cache import KVCache
    from gofr_tpu_torch.serving.programs import (
        SamplerFlags,
        SlotPlanes,
        decode_window,
        prefill_chunk_step,
        sample,
    )

    P, c, k = S, 256, 8
    off = SamplerFlags()
    gen = torch.Generator(device=dev).manual_seed(0)
    cache = KVCache.create(cfg.n_layers, S, max_len, cfg.n_kv_heads, cfg.head_dim,
                           dtype=cfg.dtype, device=dev)
    rope = rope_tables(cfg, max_len, dev)
    planes = SlotPlanes.create(S, dev)
    i32 = dict(dtype=torch.int32, device=dev)
    slots = torch.arange(S, **i32)
    lens = torch.full((P,), c, **i32)
    ones = torch.ones((P,), dtype=torch.bool, device=dev)

    def chunk(start: int) -> None:
        toks = torch.randint(0, cfg.vocab_size, (P, c), generator=gen, device=dev)
        prefill_chunk_step(params, cache, cfg, rope, planes, off, toks, slots,
                           torch.full((P,), start, **i32), lens, ones, ones,
                           torch.ones((P,), device=dev), ones, torch.ones((P,), device=dev),
                           2, sampling=False)

    chunk(0)  # every slot holds a 256-token prompt
    planes.active.fill_(True)
    lengths0 = torch.full_like(cache.lengths, context)

    def window() -> None:
        cache.lengths.copy_(lengths0)  # the same context every repetition
        decode_window(params, cache, cfg, rope, planes, off, k, 2, sampling=False)

    tag = f"_{model}_ctx{context}" if model else ""
    from gofr_tpu_torch.ops.cuda import flash_decode as fd

    window_rows = cfg.sliding_window if 0 < cfg.sliding_window < max_len else 0
    q = torch.empty((S, cfg.n_heads, cfg.head_dim), dtype=cfg.dtype, device=dev)
    log(f"profile decode_window_k8{tag}: flash_decode launches with a cluster of "
        f"{fd.launch_cluster_size(q, cache.k[0], None, window_rows)} blocks per (slot, kv "
        f"head) ({S} x {cfg.n_kv_heads} pairs)")
    steps = [(f"decode_window_k8{tag}", window),
             (f"prefill_chunk_{P}x{c}{tag}", lambda: chunk(context))]
    if graph:
        from gofr_tpu_torch.serving.programs import Captured

        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved0 = torch.cuda.memory_reserved()
        captured = Captured(window, torch.cuda.graph_pool_handle())
        torch.cuda.empty_cache()
        log(f"profile decode_window_k8{tag}_graph_replay: captured in "
            f"{captured.capture_s:.3f} s (after one eager warm-up window), graph memory pool "
            f"{torch.cuda.memory_reserved() - reserved0} bytes reserved, "
            f"{captured.launches} launches a replay")
        steps.insert(1, (f"decode_window_k8{tag}_graph_replay", captured.replay))
    if sampler:
        on = SamplerFlags(top_k=50, top_p=True, penalties=True, top_logprobs=5)
        full = SlotPlanes.create(S, dev, cfg.vocab_size, on)
        full.tokens.copy_(planes.tokens)
        full.active.fill_(True)
        full.temps.fill_(0.8)
        full.greedy.fill_(False)
        full.topps.fill_(0.9)
        full.fpen.fill_(1.5)
        full.ppen.fill_(0.5)
        full.seeds.copy_(torch.arange(S, device=dev))
        full.bidx.copy_(torch.stack([  # 300 distinct ids a slot
            torch.randperm(cfg.vocab_size, generator=gen, device=dev)[:full.bidx.shape[1]]
            for _ in range(S)]))
        full.bval.copy_(torch.rand(full.bval.shape, generator=gen, device=dev) - 0.5)

        def window_on() -> None:
            cache.lengths.copy_(lengths0)
            decode_window(params, cache, cfg, rope, full, on, k, 2, sampling=True,
                          use_bias=True)

        steps.insert(1, (f"decode_window_k8{tag}_every_sampler_option", window_on))
        logits = torch.randn((S, cfg.vocab_size), generator=gen, device=dev)
        inc = torch.ones((S, 1), **i32)

        def sampler_on() -> None:
            for _ in range(k):
                nxt = sample(logits, full.seeds, full.nsteps, full.temps, full.greedy,
                             full.topps, 2, on, sampling=True, bias=(full.bidx, full.bval),
                             pen=(full.pcounts, full.fpen, full.ppen))[0]
                full.pcounts.scatter_add_(1, nxt[:, None], inc)

        def sampler_on_neutral() -> None:
            # Flags on over a greedy batch with every option neutral: the
            # penalties (zero) and the top-logprobs run all the same.
            for _ in range(k):
                nxt = sample(logits, neutral.seeds, neutral.nsteps, neutral.temps,
                             neutral.greedy, neutral.topps, 2, on, sampling=False,
                             pen=(neutral.pcounts, neutral.fpen, neutral.ppen))[0]
                neutral.pcounts.scatter_add_(1, nxt[:, None], inc)

        def sampler_off() -> None:
            for _ in range(k):
                sample(logits, planes.seeds, planes.nsteps, planes.temps, planes.greedy,
                       planes.topps, 2, off, sampling=False)

        neutral = SlotPlanes.create(S, dev, cfg.vocab_size, on)
        # The sampler syncs with the host in places (the nucleus), so where
        # the profiler traces nothing its time may not be measurable.
        on_ms, off_ms, neutral_ms = (device_ms(torch, fn, required=False) for fn in (
            sampler_on, sampler_off, sampler_on_neutral))
        log("profile sampler: " + json.dumps({
            "what": f"the sampler's device time per decode window ({k} steps, {S} slots, "
                    f"vocab {cfg.vocab_size})",
            "every_option_flags_on_ms": on_ms, "greedy_flags_off_ms": off_ms,
            "greedy_neutral_flags_on_ms": neutral_ms,
            "device_time_by": DEVICE_TIMER["by"] if None not in (on_ms, off_ms, neutral_ms)
            else DEVICE_TIMER["by"] + "; null: not measured (no trace, and the calls "
                 "do not queue behind a spin kernel)"}))
    for name, fn in steps:
        log("profile: " + json.dumps(_profile_step(torch, name, fn)))
    del cache
    torch.cuda.empty_cache()


def phase_train(torch, dev) -> dict:
    """llama-1b (22 layers, full width) through make_train_step on one
    fixed [4, 2048] batch. Returns the kernels' launch counts over the
    phase and the trained masters."""
    from gofr_tpu_torch.models.registry import get_model
    from gofr_tpu_torch.ops.attention import FlashAttentionFn
    from gofr_tpu_torch.ops.cuda import flash_attention as fa
    from gofr_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from gofr_tpu_torch.parallel.sharding import loss_and_grads, make_train_step

    cfg = get_model("llama-1b").config
    L, b, s = cfg.n_layers, 4, 2048
    # One layer's attention at the step's shape: the kernel forward, and
    # forward plus the dense-recompute backward.
    gen = torch.Generator(device=dev).manual_seed(12)
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    qkvg = [torch.randn(shape, generator=gen, device=dev).to(cfg.dtype).requires_grad_(True)
            for shape in ((b, s, H, hd), (b, s, KV, hd), (b, s, KV, hd), (b, s, H, hd))]
    fwd_ms = time_ms(torch, lambda: FlashAttentionFn.apply(*qkvg[:3], True, None), runs=10)
    both_ms = time_ms(torch, lambda: torch.autograd.grad(
        FlashAttentionFn.apply(*qkvg[:3], True, None), qkvg[:3], qkvg[3]), runs=10)
    del qkvg
    log(f"train: one layer's attention (b={b}, s={s}): kernel forward {fwd_ms:.3f} ms, "
        f"dense-recompute backward {both_ms - fwd_ms:.3f} ms; x{L} layers "
        f"{L * fwd_ms:.1f} + {L * (both_ms - fwd_ms):.1f} ms per step")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    init_state, train_step, _ = make_train_step(cfg, device=dev)
    params, opt_state = init_state(0)
    gen.manual_seed(11)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.values())
    n_matmul = sum(params[k].numel() for k in ("wqkv", "wo", "w_gate_up", "w_down", "lm_head"))
    log(f"train: llama-1b f32 masters + AdamW state on the card in "
        f"{time.perf_counter() - t0:.1f} s ({n_params / 1e9:.3f} B parameters, "
        f"{n_matmul / 1e9:.3f} B in matmuls)")

    reset_launch_counts()
    loss_k, grads_k = loss_and_grads(params, tokens, cfg)
    if fa.launches != L:
        fail(f"train: {fa.launches} flash_attention launches in one forward, not {L}")
    # The plain path keeps one layer's dense [b, H, s, s] scores alive at a
    # time (remat), as the kernel path's backward does.
    loss_p, grads_p = loss_and_grads(params, tokens, cfg, remat=True, dense_attn=True)
    dloss = abs(loss_k.item() - loss_p.item())
    grad_rel = {k: ((grads_k[k] - grads_p[k]).norm() / grads_p[k].norm()).item() for k in grads_p}
    worst = max(grad_rel, key=grad_rel.get)
    log(f"train: step-1 loss kernel {loss_k.item():.6f} vs plain {loss_p.item():.6f}: "
        f"|dloss| {dloss:.4g} (limit {TRAIN_DLOSS_TOL}); per-tensor ||dgrad||/||grad|| "
        f"max {grad_rel[worst]:.4g} on {worst} (limit {TRAIN_GRAD_REL_TOL}): "
        + json.dumps({k: round(v, 6) for k, v in grad_rel.items()}))
    if not (torch.isfinite(loss_k) and all(torch.isfinite(g).all() for g in grads_k.values())):
        fail("train: non-finite step-1 loss or gradients")
    if dloss > TRAIN_DLOSS_TOL or grad_rel[worst] > TRAIN_GRAD_REL_TOL:
        fail("train: kernel path and plain path disagree beyond the limits")
    del grads_k, grads_p

    losses, secs = [], []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, params, opt_state = train_step(params, opt_state, tokens)
        losses.append(loss.item())
        secs.append(time.perf_counter() - t0)
    if fa.launches != 7 * L:
        fail(f"train: {fa.launches} flash_attention launches over 7 forwards, not {7 * L}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"train: losses {losses} are not finite and falling")
    _, remat_step, _ = make_train_step(cfg, remat=True, device=dev)
    before = fa.launches
    remat_step(params, opt_state, tokens)
    torch.cuda.synchronize()
    if fa.launches - before != 2 * L:
        fail(f"train: a remat step launched flash_attention {fa.launches - before} times, "
             f"not {2 * L}")
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    step_s = statistics.median(secs[1:])
    attn_flops = 4 * b * cfg.n_heads * cfg.head_dim * s * (s + 1) // 2
    mfu = (6 * n_matmul * b * s + 3 * L * attn_flops) / (step_s * BF16_FLOPS)
    log(f"train: losses over 6 steps {[round(x, 5) for x in losses]}; step time median of "
        f"steps 2-6 {step_s * 1e3:.1f} ms (all {[round(x * 1e3, 1) for x in secs]}), "
        f"{b * s / step_s:.0f} tokens/s, peak memory {peak / 2**30:.2f} GiB, "
        f"train_mfu {mfu:.4f}; launch counts over the phase {counts}")
    log("profile: " + json.dumps(_profile_step(
        torch, "train_step_llama1b_4x2048", lambda: train_step(params, opt_state, tokens))))
    return {"counts": counts, "cfg": cfg, "params": params}


def phase_prefill_padded(torch, dev, cfg, params) -> None:
    """transformer_prefill on a right-padded llama-1b batch (lengths 2048,
    700, 1): logits through the kernel's lengths variant vs the plain
    path, on separate caches."""
    from gofr_tpu_torch.models.transformer import transformer_prefill
    from gofr_tpu_torch.ops.cuda import flash_attention as fa
    from gofr_tpu_torch.ops.kv_cache import KVCache

    b, s = 3, 2048
    gen = torch.Generator(device=dev).manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev)
    lens = torch.tensor([2048, 700, 1], dtype=torch.int32, device=dev)
    slots = torch.arange(b, dtype=torch.int32, device=dev)
    logits = []
    for dense in (False, True):
        cache = KVCache.create(cfg.n_layers, b, s, cfg.n_kv_heads, cfg.head_dim,
                               dtype=cfg.dtype, device=dev)
        before = fa.launches
        logits.append(transformer_prefill(params, tokens, lens, cache, slots, cfg,
                                          dense_attn=dense))
        if fa.launches - before != (0 if dense else cfg.n_layers):
            fail(f"prefill: {fa.launches - before} flash_attention launches "
                 f"(dense={dense})")
        del cache
    a, p = logits
    if not (torch.isfinite(a).all() and torch.isfinite(p).all()):
        fail("prefill: non-finite logits")
    d = (a - p).abs().max().item()
    agree = (a.argmax(-1) == p.argmax(-1)).float().mean().item()
    log(f"prefill (transformer_prefill, lengths [2048, 700, 1]): max|dlogits| kernel vs "
        f"plain = {d:.4g} (limit {PREFILL_DLOGITS_TOL}; logit range "
        f"{a.min().item():.3g}..{a.max().item():.3g}), top-1 agreement {agree:.3f}")
    if d > PREFILL_DLOGITS_TOL or agree != 1.0:
        fail("prefill: kernel path and plain path disagree")


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available: this script drives the port on a GPU")
    try:
        from gofr_tpu_torch.models.registry import get_model
        from gofr_tpu_torch.models.transformer import init_params
        from gofr_tpu_torch.ops.cuda import _build
    except ImportError as exc:
        fail(f"gofr_tpu_torch is not importable ({exc}); run from the repo root")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # Full f32 matmuls in the plain versions (no TF32).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {name}")
    _install_sync_hook()
    check_sync_counter(torch, dev)

    t_start = time.perf_counter()
    t0 = time.perf_counter()
    _build.lib(verbose=True)
    log(f"build: kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    # Registers at entry (setmaxnreg then moves the producer's to the
    # consumers), spills and stack of the two wgmma kernels.
    for res in kernel_resources(_build.ptxas_log):
        if res["kernel"] in ("flash_attention_kernel", "flash_cache_attention_kernel",
                             "flash_decode_kernel"):
            log("ptxas: " + json.dumps({k: v for k, v in res.items() if k != "mangled"}))
    phase_sm90_primitives(torch, dev)
    log("flash_decode cluster rule: C = the largest of 1, 2, 4 and 8 whose grid of "
        "slots x kv heads clusters of C blocks the card runs in one wave (the CUDA "
        "occupancy calculator's max active clusters) and that leaves no rank without a key "
        "tile of the longest visible range (the capacity, or the window)")
    with torch.inference_mode():
        kstats = phase_kernels(torch, dev)
        decode_cluster_sweep(torch, dev)
        variants = phase_kernel_variants(torch, dev)
        kstats["flash_attention"] = phase_flash_attention(torch, dev)
        window = phase_window_kernels(torch, dev)
        f32_errs, f32_times = phase_f32_kernels(torch, dev)
    tiny_counts = phase_tiny_models(torch, dev)
    phase_attention_grad(torch, dev)
    phase_window_grad(torch, dev)
    with torch.inference_mode():
        cfg = get_model("llama-3-8b").config
        t0 = time.perf_counter()
        params = init_params(cfg, seed=0, device=dev)
        torch.cuda.synchronize()
        log(f"params: llama-3-8b random bf16 weights on the card in "
            f"{time.perf_counter() - t0:.1f} s "
            f"({sum(p.numel() for p in params.values()) / 1e9:.2f} B parameters)")
        forward_counts = phase_forward(torch, dev, cfg, params)
    counts, base, base_stats = phase_serve(torch, dev, params)
    pool_kv = dict(kv_block=32, kv_quant="int8", kv_pool_blocks=161)
    pool_counts, pool_base, pool_stats = phase_serve(torch, dev, params, **pool_kv)
    options = {"bf16 slot cache": phase_serve_options(torch, dev, params, base, base_stats),
               "int8 pool": phase_serve_options(torch, dev, params, pool_base, pool_stats,
                                                **pool_kv)}
    # The App over HTTP, with its own seed-0 weights beside these; freed
    # (App.stop, then the engine dropped) before the profiles.
    http_counts = phase_http(torch, dev, base, base_stats)["counts"]
    gc.collect()
    torch.cuda.empty_cache()
    bf16_tok, int8_tok = (cfg.n_layers * kv_bytes(1, cfg.n_kv_heads, cfg.head_dim, quant)
                          for quant in (False, True))
    log(f"serve: KV cache bytes a token: {bf16_tok} bf16, {int8_tok} int8 with scales; "
        f"bf16 slot cache (8 x 2048 tokens) {8 * 2048 * bf16_tok}, int8 slot cache "
        f"{8 * 2048 * int8_tok}, int8 pool (161 blocks of 32) {161 * 32 * int8_tok}")
    decode_loop = phase_decode_loop(torch, dev, cfg, params, base, base_stats)
    with torch.inference_mode():
        phase_profile(torch, dev, cfg, params, sampler=True, graph=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    mcfg = get_model("mistral-7b").config
    with torch.inference_mode():
        t0 = time.perf_counter()
        mparams = init_params(mcfg, seed=0, device=dev)
        torch.cuda.synchronize()
        log(f"params: mistral-7b random bf16 weights on the card in "
            f"{time.perf_counter() - t0:.1f} s "
            f"({sum(p.numel() for p in mparams.values()) / 1e9:.2f} B parameters), "
            f"sliding window {mcfg.sliding_window}")
        mforward_counts = phase_mistral_forward(torch, dev, mcfg, mparams)
    mserve = dict(model="mistral-7b", n_slots=4, max_len=8192, lengths=MISTRAL_PROMPTS,
                  sampled=False, solo=2)
    mcounts, mbase, mstats = phase_serve(torch, dev, mparams, **mserve)
    # Multi-chunk prefill: the 6 prompts (~25 chunks of 256 the longest)
    # at prefill depth 4 against the run above (depth 1).
    mdeep_counts, mdeep, mdeep_stats = phase_serve(torch, dev, mparams, **mserve,
                                                   prefill_depth=4)
    mprompts = [np.random.default_rng(0).integers(0, mcfg.vocab_size, n).tolist()
                for n in MISTRAL_PROMPTS]
    for i, (a, b) in enumerate(zip(mbase, mdeep)):
        diff = first_difference(torch, mcfg, mparams, mprompts[i], a, b)
        if diff is not None:
            log(f"serve mistral-7b prefill depth 4: request {i} leaves depth 1's stream: {diff}")
            if diff["margin"] >= NEAR_TIE:
                fail(f"serve mistral-7b prefill depth 4: request {i} differs from depth 1 at "
                     f"a top-2 margin {diff['margin']:.4g}: a state hazard")
    log("serve mistral-7b prefill depth 1 -> 4: prefill dispatches "
        f"{mstats['prefill_dispatches']} -> {mdeep_stats['prefill_dispatches']}, TTFT p50 "
        f"{mstats['ttft_p50_ms']:.1f} -> {mdeep_stats['ttft_p50_ms']:.1f} ms, tok/s "
        f"{mstats['tok_s']:.1f} -> {mdeep_stats['tok_s']:.1f}")
    mpool_kv = dict(kv_block=32, kv_quant="int8", kv_pool_blocks=641)
    mpool_counts = phase_serve(torch, dev, mparams, **mserve, **mpool_kv)[0]
    bf16_tok, int8_tok = (mcfg.n_layers * kv_bytes(1, mcfg.n_kv_heads, mcfg.head_dim, quant)
                          for quant in (False, True))
    log(f"serve mistral-7b: KV cache bytes a token: {bf16_tok} bf16, {int8_tok} int8 with "
        f"scales; bf16 slot cache (4 x 8192 tokens) {4 * 8192 * bf16_tok}, int8 pool (641 "
        f"blocks of 32) {641 * 32 * int8_tok}")
    with torch.inference_mode():
        mfull = phase_mistral_full_sequence(torch, dev, mcfg, mparams)
        phase_profile(torch, dev, mcfg, mparams, S=4, max_len=8192, context=6000,
                      model="mistral-7b")
    del mparams
    gc.collect()
    torch.cuda.empty_cache()

    train = phase_train(torch, dev)
    counts["flash_attention"] = train["counts"]["flash_attention"]
    compute = {k: p.to(train["cfg"].dtype) for k, p in train.pop("params").items()}
    phase_prefill_padded(torch, dev, train["cfg"], compute)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    log(f"device: {name}")
    log(smi.stdout.strip().splitlines()[0])
    replaces = {
        "flash_decode": "gofr_tpu/ops/pallas/flash_decode.py:185",
        "flash_cache_attention": "gofr_tpu/ops/pallas/flash_prefill.py:146",
        "flash_attention": "gofr_tpu/ops/pallas/flash_attention.py:154",
    }
    sources = {
        "flash_decode": "gofr_tpu_torch/csrc/flash_decode.cu",
        "flash_cache_attention": "gofr_tpu_torch/csrc/flash_prefill.cu",
        "flash_attention": "gofr_tpu_torch/csrc/flash_attention.cu",
    }
    # The serving kernels' cases: the slot cache's (the phase_kernels
    # numbers, launches from the bf16 serve run), then each variant with
    # its launches from the int8-pool serve run (paged+int8) or from that
    # variant's forward run.
    for k in ("flash_decode", "flash_cache_attention"):
        first = {key: kstats[k][key] for key in (
            "max_abs_err", "max_row_rel_err", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "shape", "cluster", "device_ms", "device_ms_by", "queued_event_ms",
            "library_device_ms") if key in kstats[k]}
        cases = [dict(case="bf16 slot cache", launches=counts[k], launches_from="serve", **first)]
        for case in variants[k]:
            if case["case"] == "paged+int8 B=32":
                case.update(launches=pool_counts[k], launches_from="serve " + json.dumps(pool_kv))
            else:
                case.update(launches=forward_counts[case["case"]][k], launches_from="forward")
            cases.append(case)
        kstats[k]["cases"] = cases
    # The windowed cases (mistral-7b): launches from its serve runs (bf16
    # slot cache, int8 pool of 32), its forward runs (pool of 32, int8
    # slot cache) and its two full-sequence entry points.
    for k in ("flash_decode", "flash_cache_attention"):
        for case in window[k]:
            variant = case["case"].split(" ", 2)[2]
            if variant == "bf16 slot cache":
                case.update(launches=mcounts[k], launches_from="serve mistral-7b")
            elif variant == "paged+int8 B=32":
                case.update(launches=mpool_counts[k],
                            launches_from="serve mistral-7b " + json.dumps(mpool_kv))
            else:
                case.update(launches=mforward_counts[variant][k],
                            launches_from="mistral-7b forward")
            kstats[k]["cases"].append(case)
    for case, entry in zip(window["flash_attention"],
                           ("transformer_forward", "transformer_prefill")):
        case.update(launches=mfull[entry], launches_from=f"mistral-7b {entry} [., 8192]")
        kstats["flash_attention"]["cases"].append(case)
    for k in replaces:
        kstats[k]["max_abs_err"] = max(c["max_abs_err"] for c in kstats[k]["cases"])
        kstats[k]["max_row_rel_err"] = max(c["max_row_rel_err"] for c in kstats[k]["cases"])
    kernels = [
        {
            "name": k, "route": "cuda", "source": sources[k], "replaces": replaces[k],
            "launches": counts[k], "max_abs_err": kstats[k]["max_abs_err"],
            "ms": kstats[k]["ms"], "plain_ms": kstats[k]["plain_ms"],
            "bound_ms": kstats[k]["bound_ms"], "bound_by": kstats[k]["bound_by"],
            "library_ms": kstats[k]["library_ms"],
            "max_row_rel_err": kstats[k]["max_row_rel_err"], "shape": kstats[k]["shape"],
            "cases": kstats[k]["cases"],
        }
        for k in replaces
    ]
    for k in replaces:
        kernels_f32 = {"max_abs_err": f32_errs[k], **f32_times[k],
                       "launches_llama_tiny_f32": tiny_counts["llama-tiny-f32"][k],
                       "launches_llama_tiny": tiny_counts["llama-tiny"][k]}
        next(x for x in kernels if x["name"] == k)["f32_and_hd32"] = kernels_f32
    # The mixed-option serves (sampler and lifecycle) and the App over HTTP.
    for k in ("flash_decode", "flash_cache_attention"):
        entry = next(x for x in kernels if x["name"] == k)
        entry["launches_serve_options"] = {case: o["counts"][k] for case, o in options.items()}
        entry["launches_http"] = http_counts[k]
        entry["launches_decode_loop"] = {label: st["counts"][k] for label, st in
                                         decode_loop["settings"].items()}
        entry["launches_mistral_prefill_depth_4"] = mdeep_counts[k]
    log(f"chip_smoke: wall time {time.perf_counter() - t_start:.1f} s, the build included")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
