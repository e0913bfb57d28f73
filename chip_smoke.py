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
4b'. config 4, offline batch inference over pub/sub: the App from config
   (the same seed-0 weights) with PUBSUB_BACKEND=INPROC, sqlite, the
   port's MiniRedis and TRACE_EXPORTER=zipkin to a local collector,
   migrate and add_rest_handlers; a subscriber on two topics runs 8 of
   phase_serve's greedy prompts through ctx.infer and answers in SQL,
   Redis and infer-responses, each equal to phase_serve's stream; the
   /debug/* routes during a second wave (a /debug/tpu-trace holding
   replayed flash_decode launches); the same prompts over MQTT at QoS 1;
   a new_cmd child on llama-tiny against a parent engine; messages/s,
   latency p50/p99 and tok/s beside the batch-1 bound;
4b''. gRPC and service to service, on the port's own HTTP/2, HPACK and
   protobuf wire code: config 5, the App from config (the same seed-0
   weights, GRPC_PORT=0) with the typed and the JSON inference services;
   phase_serve's 10 prompts as concurrent GenerateStream RPCs over one
   connection (greedy: 8 equal to phase_serve's streams, the repeated
   prompt's two equal to each other), a unary Generate equal to its
   stream, a JSON Generate, Health, a cancelled stream and a 0.5 s
   deadline that expires mid-decode (each freeing its slot); tok/s, TTFT
   p50 and ITL p50 over
   gRPC beside phase_serve's and phase_http's; a gateway App whose
   add_http_service client forwards 3 prompts to /v1/completions, equal
   to the direct answers under one zipkin trace id; config 3, BERT-base
   behind the batcher, 64 concurrent Embed RPCs against the engine's own
   vectors, beside two planted faults the limit must catch;
   flan-t5-small's GenerateStream against its one-shot ids;
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
4d. exact-verify speculative decoding (G = 2 drafts a step by n-gram
   lookup, verified through the plain decode step once per candidate
   position): the captured spec window against the eager one on copies
   of one state, every static variant (tokens and counts identical,
   logprobs within 1e-3, flash_decode launched k·(G+1)·layers times a
   window, counted through the replay); the mega spec window (m = 4)
   against plain spec windows, windows_run by the delivered-count exit,
   an EOS case ending early; phase_serve's 10 prompts at G = 2 on the bf16
   slot cache and the int8 pool, and 4 repeated-text prompts, each stream
   equal to the G = 0 stream (a greedy difference passes only at a top-2
   margin below 1e-2), with tok/s, TTFT p50, ITL p50, tokens a live step,
   windows, launches, pool peak and stream syncs beside G = 0's; a profile
   of one replayed spec window; and (in 5a) Mistral-7B's 6 requests at
   G = 2 against G = 0;
4e. the prefix cache: the serving kernels on block tables in which every
   slot aliases the same 32 physical blocks (decode at 1,056 to 1,424
   tokens; prefill chunks from done = 1,024 and a row at 1,023), bf16 and
   int8, against their plain versions and bit for bit against the
   contiguous kernel; paged_copy_block bit for bit on 32-layer bf16 and
   int8 pools; then a shared 1,024-token system prompt, 10 suffixes of 32
   to 400 tokens (2 seeded sampled) and the system prompt alone, through
   a bf16 pool of 513 x 32 with auto_prefix off and on (primed), an int8
   pool of 161 x 32 under a 64-block cap (eviction runs; against an int8
   pool of 513 off), the bf16 slot cache with the explicit prefix pool
   (prefix_slots 2, register_prefix_sync) against none, and the primed
   pool at G = 2 and at prefill depth 3: every warm stream equal to its
   cold one (a greedy difference only at a near-tie), lookups and hit
   tokens as the traffic implies, 0 stream syncs, the block invariant
   after idle; tok/s, TTFT p50, ITL p50, prefill dispatches and rows, peak
   and cached blocks and evictions, off and on;
4f. quantizes Llama-3-8B's bf16 weights on the card to int8 and int4
   (ops/quant.py): one layer of every quantized leaf bit for bit against
   the CPU's quantization of the same bf16 slice; transformer_forward of
   each quantized model through the kernels against its plain attention
   path; phase_serve's traffic on each, beside the bf16 serve;
4g. TPU_CHECKPOINT: writes those bf16 weights as an HF directory (its own
   safetensors writer, shards of at most 5 GB, under a temporary directory
   outside the repo; fails with less than twice the bytes free on its
   disk) and serves it through InferenceEngine.from_config, every leaf bit
   for bit, then with TPU_QUANT=int8 (every leaf equal to the on-card
   quantization, greedy streams equal the in-memory int8 engine's); a
   save_checkpoint / restore_checkpoint round trip of the int8 tree bit for
   bit; the write, load and restore rates;
4h. device services on Llama-3-8B (after multi-LoRA): the native BPE core
   built; 4,000 byte-level merges learned over the repo's Markdown and
   written as the core's hex files and a Llama-3-shaped tokenizer.json;
   native against Python encode (ids equal, MB/s on the card's host); a
   mixed wave of 16 text prompts from 4 threads through an engine built
   by from_config with TPU_TOKENIZER, a bf16 pool with auto_prefix and
   TPU_PREFIX_EVICT_HBM_FRAC, twice (the second past mark_steady_state:
   no recompile, greedy streams equal); the HBM ledger beside
   torch.cuda.memory_allocated(), the headroom, the derived watermark and
   the free blocks kept; the captures per program; a 429 hbm_headroom; the
   profiler repair: a 200 ms profiler_capture while the engine replays its
   decode windows (the start and stop handed to the scheduler thread) must
   trace their flash_decode launches inside traced graph launches and end
   within 5 s of its window, under a 120 s watchdog; a 200 ms capture's
   kernels beside eager forwards; a TPU_LOCKCHECK=1 child (4 layers,
   0 violations) and a child reusing TPU_COMPILE_CACHE_DIR's BPE core;
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
5b. serves Mixtral-8x7B (8 experts, top 2, its depth cut to MOE_LAYERS
   of 32, after Mistral-7B is freed) with int8 weights made on the card a
   layer at a time from a seed (peak memory over the init printed):
   phase_forward and
   the full-sequence entry points through the kernels against the plain
   path (where a router near-tie sends a token to other experts on the two
   sides, the plain side takes the kernel side's experts: RoutePin, which
   also bounds the router logits' difference on the other tokens), the
   router at full width against a stable-sort reference (and with two
   experts tied on every token), and phase_serve's traffic on the bf16 slot
   cache and an int8 pool of 161 x 32;
6. trains llama-1b (22 layers, full width, f32 master weights and AdamW,
   bf16 compute, random weights from a seed) through make_train_step on a
   fixed [4, 2048] batch: step-1 loss and gradients through the kernel
   against the plain path, 6 steps with finite and falling loss, one
   remat step, flash_attention launched exactly once per layer per
   forward; prints step time, tokens/s, peak memory and train_mfu, and
   profiles one training step;
7. checks transformer_prefill (right-padded llama-1b batch, the kernel's
   lengths variant) against the plain path;
7a. trains the other decoder families and MoE through make_train_step at
   full width, depth cut to fit f32 masters, AdamW and gradients
   (FAMILY_TRAIN: gemma-7b, qwen2-7b and pythia-6.9b at 4 layers on
   [1, 2048], gpt2 whole on [8, 1024], mixtral-8x7b at 2 layers on
   [1, 2048]): step-1 loss and gradients through the kernel against the
   plain path, 6 steps with finite and falling losses, flash_attention
   once a layer a forward, step time, tokens/s, train_mfu and peak memory;
   and 3 make_lora_train_step steps on gpt2;
7b. serves the encoder and vision families behind the dynamic batcher:
   ResNet-50 at static batch 1 against the host CPU, 64 concurrent
   requests through the batcher and over HTTP (TPU_MODEL=resnet-50,
   ctx.infer); BERT-base as TPU_EMBED_MODEL beside llama-1b, 64
   concurrent /v1/embeddings of 8 to 500 tokens, each vector against
   bert_embed on its flush's batch; ViT-B/16 at [8, 224, 224, 3], kernel
   against dense attention, 12 flash_attention launches a forward, 64
   requests;
7c. serves the seq2seq family: Unigram, SentencePiece BPE (byte
   fallback) and WordPiece tokenizer.json files learned from the repo's
   Markdown (encode MB/s over ~1 MB, the byte-fallback round trip);
   flan-t5-small at full width behind the App with enable_api_key_auth
   and the Unigram TPU_TOKENIZER: 64 concurrent requests of 8 to 400
   tokens (one without the key: 401), each answer against t5_generate on
   its flush's padded batch, a stream against its one-shot ids, BERT-base's
   /v1/embeddings through the WordPiece TPU_EMBED_TOKENIZER; the f32 twin
   on the card against the host CPU (bucket ids, decoder logits); int8 and
   int4 through TPU_QUANT; load_hf_t5 at flan-t5-large's widths
   (T5_LARGE_LAYERS deep) in bf16 and int8 (load rate, peak memory, a [8, 128] generate);
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
import dataclasses
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


# The serving kernels' cache variants: (label, int8, pool block or 0).
KV_VARIANTS = [("paged B=32", False, 32), ("paged B=128", False, 128),
               ("int8", True, 0), ("paged+int8 B=32", True, 32)]
# The rows of a prefill chunk held at serving shapes (slot, start, valid
# tokens): starts 0/256/1024/..., one short row, the last row a padding
# duplicate of row 0.
PREFILL_ROWS = [(0, 0, 256), (1, 256, 256), (2, 1024, 256), (3, 512, 100),
                (4, 1536, 256), (5, 0, 37), (6, 1792, 200), (0, 0, 256)]
DECODE_LENGTHS = [0, 1, 100, 257, 1000, 1536, 700, 2047]


def _bound(bytes_: float, flops: float) -> tuple:
    return (max(bytes_ / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3,
            "bytes" if bytes_ / HBM_BYTES_PER_S >= flops / BF16_FLOPS else "operations")


def _cache_kw(cache: list, table) -> dict:
    out = dict(k_cache=cache[0], v_cache=cache[1])
    if len(cache) == 4:
        out.update(k_scale=cache[2], v_scale=cache[3])
    if table is not None:
        out["block_table"] = table
    return out


def _f32(d: dict) -> dict:
    """Floating tensors (bf16 caches) in f32; int8 values and tables kept."""
    return {k: (t.float() if t.is_floating_point() else t) for k, t in d.items()}


def _logical_caches(torch, rnd, S, KV, max_len, hd, quant) -> list:
    from gofr_tpu_torch.ops.kv_cache import quantize_kv

    k, v = rnd(S, KV, max_len, hd), rnd(S, KV, max_len, hd)
    if not quant:
        return [k, v]
    (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
    return [k, v, ks, vs]


def decode_variant_cases(torch, dev, gen, H: int, KV: int, hd: int, variants: list,
                         prefix: str = "", lengths: list = DECODE_LENGTHS,
                         max_len: int = 2048) -> list:
    """flash_decode on each of ``variants`` ((label, int8, pool block)) at
    S = len(lengths) slots of H query and KV kv heads: the split
    convention (the main path) and the written one against the f32 plain
    version, each paged case bit for bit the slot cache's kernel on the
    same logical keys; kernel, plain and bound times and the device-time
    extras. A "bf16 slot cache" variant also times SDPA (the written
    convention, valid-prefix mask); no PyTorch call attends through a
    table or int8, so the others' ``library_ms`` is null."""
    from gofr_tpu_torch.ops.cuda import flash_decode as fd
    from gofr_tpu_torch.ops.kv_cache import fake_quantize_kv

    sdpa = torch.nn.functional.scaled_dot_product_attention

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    S = len(lengths)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    q, kn, vn = rnd(S, H, hd), rnd(S, KV, hd), rnd(S, KV, hd)
    logical = {quant: _logical_caches(torch, rnd, S, KV, max_len, hd, quant)
               for quant in sorted({v[1] for v in variants})}
    out = []
    for label, quant, B in variants:
        knq, vnq = kn, vn
        if quant:  # the decode step attends its new token fake-quantized
            knq, vnq = fake_quantize_kv(kn), fake_quantize_kv(vn)
        cache, table = logical[quant], None
        if B:
            cache, table = make_pool(torch, gen, cache, lengths, B)
        args = _cache_kw(cache, table)
        name = f"flash_decode {prefix}{label}"
        got = fd.flash_decode(q, lengths=lens, k_new=knq, v_new=vnq, **args)
        err, rel = check_close(torch, name + " (split)", got, fd.flash_decode_plain(
            q.float(), lengths=lens, k_new=knq.float(), v_new=vnq.float(), **_f32(args)))
        got_w = fd.flash_decode(q, lengths=lens, **args)
        err_w, rel_w = check_close(torch, name + " (written)", got_w, fd.flash_decode_plain(
            q.float(), lengths=lens, **_f32(args)))
        if B:  # the slot cache's kernel on the same logical keys
            flat = fd.flash_decode(q, lengths=lens, k_new=knq, v_new=vnq,
                                   **_cache_kw(logical[quant], None))
            d = (got.float() - flat.float()).abs().max().item()
            d_w = (got_w.float() - fd.flash_decode(q, lengths=lens,
                                                   **_cache_kw(logical[quant], None))
                   .float()).abs().max().item()
            log(f"{name}: max|paged - contiguous| {d} (split), {d_w} (written); "
                f"limit {PAGED_VS_CONTIGUOUS_TOL}")
            if max(d, d_w) > PAGED_VS_CONTIGUOUS_TOL:
                fail(f"{name}: the pool's result differs from the slot cache's")
        ms = time_ms(torch, lambda: fd.flash_decode(q, lengths=lens, k_new=knq, v_new=vnq, **args))
        plain_ms = time_ms(torch, lambda: fd.flash_decode_plain(
            q, lengths=lens, k_new=knq, v_new=vnq, **args))
        library = lib_ms = None
        if not (B or quant):
            mask = (torch.arange(max_len, device=dev)[None, :] < lens[:, None])[:, None, None, :]

            def library(mask=mask):
                return sdpa(q[:, :, None, :], cache[0], cache[1], attn_mask=mask,
                            enable_gqa=True)

            lib_ms = time_ms(torch, library)
        tok = sum(lengths)
        bytes_ = (2 * S * H * hd * 2 + kv_bytes(tok, KV, hd, quant) + 2 * S * KV * hd * 2
                  + S * 4 + (4 * sum(-(-n // B) for n in lengths) if B else 0))
        bound_ms, bound_by = _bound(bytes_, 4 * (tok + S) * H * hd)
        extras = decode_extras(
            torch, fd, name + " (split)",
            lambda: fd.flash_decode(q, lengths=lens, k_new=knq, v_new=vnq, **args), q,
            args["k_cache"], table, 0, library=library)
        out.append(dict(
            case=prefix + label, max_abs_err=max(err, err_w), max_row_rel_err=max(rel, rel_w),
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
            shape=f"S={S} H={H} KV={KV} hd={hd} max_len={max_len} lengths={lengths}"
                  + (f" block={B}" if B else "") + (" int8" if quant else ""), **extras,
        ))
        log(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
            + ("" if lib_ms is None else f", sdpa {lib_ms:.4f} ms")
            + f", bound {bound_ms:.4f} ms ({bound_by}, {bytes_} bytes)")
        del cache, table, args
    return out


def prefill_variant_cases(torch, dev, gen, H: int, KV: int, hd: int, variants: list,
                          prefix: str = "", rows: list = PREFILL_ROWS, c: int = 256,
                          S: int = 8, max_len: int = 2048) -> list:
    """flash_cache_attention on each of ``variants`` at a [len(rows), c]
    chunk of H query and KV kv heads: against the f32 plain version, each
    paged case bit for bit the slot cache's kernel; kernel (events and
    device time), plain and bound times. A "bf16 slot cache" variant also times SDPA on the
    equivalent dense problem (each row's slot gathered beforehand, a
    causal-at-global-position mask)."""
    from gofr_tpu_torch.ops.cuda import flash_prefill as fp

    sdpa = torch.nn.functional.scaled_dot_product_attention

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    i32 = dict(dtype=torch.int32, device=dev)
    P = len(rows)
    q = rnd(P, c, H, hd)
    q[P - 1] = q[0]
    slots = torch.tensor([r[0] for r in rows], **i32)
    starts = torch.tensor([r[1] for r in rows], **i32)
    lns = torch.tensor([r[2] for r in rows], **i32)
    keys = [max([s0 + n for sl, s0, n in rows if sl == r] or [0]) for r in range(S)]
    logical = {quant: _logical_caches(torch, rnd, S, KV, max_len, hd, quant)
               for quant in sorted({v[1] for v in variants})}
    uniq = sorted(set(rows))
    flops = sum(4 * H * hd * sum(s0 + tt + 1 for tt in range(n)) for _, s0, n in uniq)
    out = []
    for label, quant, B in variants:
        cache, table = logical[quant], None
        if B:
            cache, table = make_pool(torch, gen, cache, keys, B)
        args = _cache_kw(cache, table)
        name = f"flash_cache_attention {prefix}{label}"
        got = fp.flash_cache_attention(q, slots=slots, starts=starts, lens=lns, **args)
        err, rel = check_close(torch, name, got, fp.flash_cache_attention_plain(
            q.float(), slots=slots, starts=starts, lens=lns, **_f32(args)))
        if B:
            flat = fp.flash_cache_attention(q, slots=slots, starts=starts, lens=lns,
                                            **_cache_kw(logical[quant], None))
            d = (got.float() - flat.float()).abs().max().item()
            log(f"{name}: max|paged - contiguous| {d}; limit {PAGED_VS_CONTIGUOUS_TOL}")
            if d > PAGED_VS_CONTIGUOUS_TOL:
                fail(f"{name}: the pool's result differs from the slot cache's")

        def kernel(args=args):
            return fp.flash_cache_attention(q, slots=slots, starts=starts, lens=lns, **args)

        ms, dev_ms = time_ms(torch, kernel), device_ms(torch, kernel)
        plain_ms = time_ms(torch, lambda: fp.flash_cache_attention_plain(
            q, slots=slots, starts=starts, lens=lns, **args), runs=20)
        lib_ms = None
        if not (B or quant):
            ck, cv = cache[0][slots.long()], cache[1][slots.long()]
            t = torch.arange(c, device=dev)
            pos = starts.long()[:, None] + t[None, :]
            dmask = (torch.arange(max_len, device=dev)[None, None, :] <= pos[:, :, None]) \
                & (t[None, :] < lns.long()[:, None])[:, :, None]
            qt = q.transpose(1, 2)
            lib_ms = time_ms(torch, lambda: sdpa(qt, ck, cv, attn_mask=dmask[:, None],
                                                 enable_gqa=True))
            del ck, cv, dmask
        bytes_ = (2 * P * c * H * hd * 2 + sum(kv_bytes(s0 + n, KV, hd, quant) for _, s0, n in uniq)
                  + (4 * sum(-(-n // B) for n in keys) if B else 0))
        bound_ms, bound_by = _bound(bytes_, flops)
        out.append(dict(
            case=prefix + label, max_abs_err=err, max_row_rel_err=rel, ms=ms, device_ms=dev_ms,
            device_ms_by=DEVICE_TIMER["by"], plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by, tflops=flops / ms / 1e9,
            shape=f"P={P} c={c} H={H} KV={KV} hd={hd} max_len={max_len} rows={rows}"
                  + (f" block={B}" if B else "") + (" int8" if quant else ""),
        ))
        log(f"{name}: kernel {ms:.4f} ms (device {dev_ms:.4f}), plain {plain_ms:.4f} ms"
            + ("" if lib_ms is None else f", sdpa {lib_ms:.4f} ms")
            + f", bound {bound_ms:.4f} ms ({bound_by}, {flops / ms / 1e9:.1f} TFLOP/s achieved)")
        del cache, table, args
    return out


def phase_kernel_variants(torch, dev) -> dict:
    """The serving kernels' paged (B=32, B=128), int8 and paged+int8 (B=32)
    variants at the llama-3-8b serving shapes of ``phase_kernels``: each
    against its plain version run in f32, each paged case against the
    contiguous kernel on the same logical keys (must be bit-equal);
    kernel, plain and bound times. No single PyTorch call computes paged
    or int8-scaled attention, so ``library_ms`` is null."""
    gen = torch.Generator(device=dev).manual_seed(2024)
    H, KV, hd = 32, 8, 128
    return {"flash_decode": decode_variant_cases(torch, dev, gen, H, KV, hd, KV_VARIANTS),
            "flash_cache_attention": prefill_variant_cases(torch, dev, gen, H, KV, hd,
                                                           KV_VARIANTS)}


# The new families' head shapes (model, H, KV, hd): Qwen2-7B's 7 query
# heads a KV head, Gemma's head dim 256 (7B: MHA; 2B: MQA, a group of 8).
FAMILY_HEADS = [("qwen2-7b", 28, 4, 128), ("gemma-7b", 16, 16, 256), ("gemma-2b", 8, 1, 256)]


# flash_attention at hd 256: label, b, s, H, KV, hd, lengths, window (all
# causal).
FAMILY_FA_CASES = [
    ("gemma-7b transformer_prefill", 4, 2048, 16, 16, 256, [2048, 1500, 257, 0], 0),
    ("gemma-2b transformer_prefill", 3, 2048, 8, 1, 256, [2048, 700, 1], 0),
    ("gemma-7b window 1024", 1, 4096, 16, 16, 256, None, 1024),
]


def phase_family_kernels(torch, dev) -> dict:
    """The three kernels at the other families' shapes (FAMILY_HEADS):
    flash_decode (ratio 7, hd 256) and flash_cache_attention (7 chunk rows
    a token; hd 256 on 64-key tiles) at the llama serving geometry (8
    slots, max_len 2048, a chunk of 8 x 256) on the bf16 slot cache, pools
    of 32 and 128, int8 and paged+int8; flash_attention at hd 256:
    Gemma-7B's transformer_prefill shape (causal, lengths with an empty
    row), Gemma-2B's (MQA, a head group of 8) and a causal window (which
    the Pallas kernel takes at any head dim, though Gemma has none).
    Each against its f32 plain version per row, with kernel, plain, SDPA
    and bound times."""
    from gofr_tpu_torch.ops.cuda import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(1313)
    variants = [("bf16 slot cache", False, 0), *KV_VARIANTS]
    out = {"flash_decode": [], "flash_cache_attention": [], "flash_attention": []}
    for model, H, KV, hd in FAMILY_HEADS:
        out["flash_decode"] += decode_variant_cases(torch, dev, gen, H, KV, hd, variants,
                                                    prefix=f"{model} ")
        out["flash_cache_attention"] += prefill_variant_cases(torch, dev, gen, H, KV, hd,
                                                              variants, prefix=f"{model} ")
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    for label, b, s, H, KV, hd, lengths, window in FAMILY_FA_CASES:
        q, k, v = rnd(b, s, H, hd), rnd(b, s, KV, hd), rnd(b, s, KV, hd)
        lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32, device=dev)
        name = f"flash_attention ({label})"
        err, rel = check_close(torch, name, fa.flash_attention(q, k, v, lens, window=window),
                               plain_attention_rows(torch, fa, q, k, v, lens, window))
        ms = time_ms(torch, lambda: fa.flash_attention(q, k, v, lens, window=window))
        plain_ms = time_ms(torch, lambda: plain_attention_rows(torch, fa, q, k, v, lens, window),
                           runs=5)
        vis = fa.visible_keys(b, s, s, causal=True, lengths=lens, window=window, device=dev)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        gqa = dict(enable_gqa=True) if KV != H else {}
        mask = vis[:, None]
        lib_ms = time_ms(torch, lambda: sdpa(qt, kt, vt, attn_mask=mask, **gqa))
        pairs = int(vis.sum().item()) * (b // vis.shape[0])
        keys = sum(lengths) if lengths else b * s
        flops = 4 * H * hd * pairs
        bytes_ = 2 * b * s * H * hd * 2 + 2 * keys * KV * hd * 2 + (4 * b if lengths else 0)
        bound_ms, bound_by = _bound(bytes_, flops)
        out["flash_attention"].append(dict(
            case=label, max_abs_err=err, max_row_rel_err=rel, ms=ms, plain_ms=plain_ms,
            library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by, tflops=flops / ms / 1e9,
            library_tflops=flops / lib_ms / 1e9,
            shape=f"b={b} s={s} H={H} KV={KV} hd={hd} causal lengths={lengths} window={window}"))
        log(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa (mask) {lib_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms (flops {flops}, {flops / ms / 1e9:.1f} TFLOP/s achieved, "
            f"sdpa {flops / lib_ms / 1e9:.1f})")
        del q, k, v, vis, mask
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
    int8, window; and hd 256) and flash_attention (causal GQA, lengths,
    window, non-causal; and hd 256), each against its f32 plain version per row at
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
    # The f32 tiled kernels at hd 256 (Gemma's head dim; a block's tiles
    # pass the 48 KB a launch gets without asking): the chunk on the slot
    # cache and causal GQA full-sequence attention.
    qc2 = rnd(len(rows), 40, 4, 256)
    args2 = dict(slots=slots, starts=starts, lens=lns, k_cache=rnd(S, 2, max_len, 256),
                 v_cache=rnd(S, 2, max_len, 256))
    name = "flash_cache_attention f32 hd 256 (slot cache)"
    errs["flash_cache_attention"] = max(errs["flash_cache_attention"], once(
        fp, name, lambda: fp.flash_cache_attention(qc2, **args2),
        fp.flash_cache_attention_plain(qc2, **args2)))
    pairs2 = sum(s0 + t + 1 for _, s0, n in rows for t in range(n))
    # The library call: SDPA in f32 over each row's slot cache (gathered
    # beforehand), a boolean mask of the chunk's causal-at-offset rule
    # (query t of a row sees keys 0..start+t; a padded query sees key 0).
    c2, L2 = qc2.shape[1], args2["k_cache"].shape[2]
    t_ = torch.arange(c2, device=dev)[:, None]
    key = torch.arange(L2, device=dev)[None, :]
    mask2 = torch.stack([torch.where(t_ < n, key <= s0 + t_, key == 0)
                         for _, s0, n in rows])[:, None]
    sl = slots.long()
    kg, vg = args2["k_cache"][sl], args2["v_cache"][sl]
    qt2 = qc2.transpose(1, 2)
    times["flash_cache_attention"]["hd256"] = timed(
        name, lambda: fp.flash_cache_attention(qc2, **args2),
        lambda: fp.flash_cache_attention_plain(qc2, **args2),
        2 * qc2.numel() * 4 + 4 * 2 * 2 * 256 * sum(s0 + n for _, s0, n in rows),
        4 * pairs2 * 4 * 256,
        library=lambda: sdpa(qt2, kg, vg, attn_mask=mask2, enable_gqa=True))
    lib2 = sdpa(qt2, kg, vg, attn_mask=mask2, enable_gqa=True).transpose(1, 2)
    want2 = fp.flash_cache_attention_plain(qc2, **args2)
    d_lib = max((float((lib2[r, :n] - want2[r, :n]).abs().max()) for r, (_, _, n) in
                 enumerate(rows) if n), default=0.0)
    log(f"{name}: the library call against the plain version on the chunk's rows: "
        f"max|d| {d_lib:.3g}")
    if d_lib > 1e-3:
        fail(f"{name}: the library call does not compute the chunk's function ({d_lib:.3g})")
    qa2, ka2, va2 = rnd(b, s_, 4, 256), rnd(b, s_, 2, 256), rnd(b, s_, 2, 256)
    name = f"flash_attention f32 hd 256 (b={b}, s={s_}, H=4, KV=2, causal)"
    errs["flash_attention"] = max(errs["flash_attention"], once(
        fa, name, lambda: fa.flash_attention(qa2, ka2, va2),
        fa.flash_attention_plain(qa2, ka2, va2)))
    times["flash_attention"]["hd256"] = timed(
        name, lambda: fa.flash_attention(qa2, ka2, va2),
        lambda: fa.flash_attention_plain(qa2, ka2, va2),
        4 * (2 * qa2.numel() + 2 * ka2.numel()), 4 * 4 * 256 * pairs,
        library=sdpa_causal(qa2, ka2, va2))
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


# The two sides of a Mixtral kernels-vs-plain check compute the router's
# logits from hidden states that differ by the attention paths' bf16
# rounding. ROUTER_LOGIT_TOL holds that difference on the tokens routed
# alike: on an NVIDIA H100 80GB HBM3 at 700 W it read up to 0.086 (four
# checks, 0.0625-0.086). Where a token's own gap between its k-th and
# (k+1)-th router logit is under ROUTER_NEAR_TIE, the two sides may route
# it to different experts (an expert swap is a step in the function, not
# a small difference); the flipped tokens' gaps read up to 0.076 there
# (829 to 2,282 flipped tokens a check). Each limit is about twice its
# reading.
ROUTER_LOGIT_TOL = 0.15
ROUTER_NEAR_TIE = 0.15


class RoutePin:
    """Makes a checked run take the experts a recorded run took, where the
    two differ only at a router near-tie. ``record()``: each MoE routing
    call (``transformer.route``) keeps its router logits and experts.
    ``replay(label, rows)``: each call routes as the port does, then takes
    the recorded call's experts (``rows`` of it) for every token whose own
    top-k differs; such a flip fails the run unless the token's own gap
    between its k-th and (k+1)-th router logit is under ROUTER_NEAR_TIE,
    and so does a token routed alike whose router logits differ from the
    recorded ones by more than ROUTER_LOGIT_TOL. The routing weights
    stay the run's own probabilities over the taken experts. ``off()``
    ends either mode; ``close()`` restores ``route``."""

    def __init__(self, torch):
        from gofr_tpu_torch.models import transformer

        self.torch, self.mod, self.route = torch, transformer, transformer.route
        self.mode, self.calls, self.pos = "", [], 0
        transformer.route = self._route

    def record(self) -> None:
        self.mode, self.calls = "record", []

    def replay(self, label: str, rows=None) -> None:
        self.mode, self.pos, self.rows, self.label = "replay", 0, rows, label
        self.flips, self.worst_gap, self.noise = 0, 0.0, 0.0

    def off(self) -> None:
        if self.mode == "replay":
            log(f"router pin ({self.label}): {self.pos} routing calls, {self.flips} tokens "
                f"routed to other experts than the recorded run, at own k-th gaps up to "
                f"{self.worst_gap:.4g} (limit {ROUTER_NEAR_TIE}); router logits of the "
                f"tokens routed alike differ by up to {self.noise:.4g} (limit "
                f"{ROUTER_LOGIT_TOL})")
        self.mode = ""

    def close(self) -> None:
        self.off()
        self.mod.route = self.route

    def _route(self, x, router, k):
        torch = self.torch
        weights, idx = self.route(x, router, k)
        if not self.mode:
            return weights, idx
        logits = (x @ router).float()
        if self.mode == "record":
            self.calls.append((logits, idx))
            return weights, idx
        want_logits, want = self.calls[self.pos]
        self.pos += 1
        if self.rows is not None:
            want_logits, want = want_logits[self.rows], want[self.rows]
        same = (idx.sort(-1).values == want.sort(-1).values).all(-1)
        if bool(same.any()):
            noise = (logits - want_logits)[same].abs().max().item()
            self.noise = max(self.noise, noise)
            if noise > ROUTER_LOGIT_TOL:
                fail(f"router pin ({self.label}): router logits of tokens routed alike "
                     f"differ by {noise:.4g} > {ROUTER_LOGIT_TOL} from the recorded run")
        if bool(same.all()):
            return weights, idx
        top = logits.sort(-1, descending=True).values
        gap = (top[:, k - 1] - top[:, k])[~same]
        self.flips += int((~same).sum())
        self.worst_gap = max(self.worst_gap, gap.max().item())
        if gap.max().item() >= ROUTER_NEAR_TIE:
            fail(f"router pin ({self.label}): a token took other experts than the recorded "
                 f"run at a k-th gap of {gap.max().item():.4g} >= {ROUTER_NEAR_TIE}")
        idx = torch.where(same[:, None], idx, want)
        p = torch.softmax(logits, dim=-1).gather(-1, idx)
        return torch.zeros_like(weights).scatter_(-1, idx, p / p.sum(-1, keepdim=True)), idx


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


def phase_forward(torch, dev, cfg, params, *, model: str = "", near_ties: bool = False) -> dict:
    """One prefill chunk and two decode steps, each run on its own cache:
    the bf16 slot cache through the kernels and through the plain path
    (dense_attn=True); pools of 32 and 128 (shuffled tables) through the
    kernels, against the slot cache's kernel run; int8 caches, slot and
    pool of 32, through the kernels against the int8 pool's plain path.
    ``near_ties`` lets a bf16 row's top-1 differ within the limit (as the
    int8 check always does). Returns the kernels' launch counts over each
    variant's run."""
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

    counts = {}

    def counted(key: str, *args) -> list:
        reset_launch_counts()
        logits = run(*args)
        counts[key] = launch_counts()
        return logits

    def compare(label, *args, **kw):
        return compare_logits(f"{model} {label}" if model else label, *args, **kw)

    # MoE: the plain runs take the kernel runs' experts where the two
    # differ only at a router near-tie (RoutePin).
    pin = RoutePin(torch) if cfg.is_moe else None

    def pinned(label: str, kernel_run, *plain_args) -> tuple:
        if pin is None:
            return kernel_run(), run(*plain_args)
        pin.record()
        got = kernel_run()
        pin.replay(f"{model} {label}")
        want = run(*plain_args)
        pin.off()
        return got, want

    try:
        flat, plain = pinned("kernels vs plain",
                             lambda: counted("contiguous", "", 0, False), "", 0, True)
        compare("kernels vs plain", flat, plain, FORWARD_DLOGITS_TOL, near_ties=near_ties)
        for B in (32, 128):
            compare(f"pool of {B} vs slot cache (kernels)",
                    counted(f"paged B={B}", "", B, False), flat, FORWARD_PAGED_TOL)
        # int8 values make more near-ties between the top two logits than
        # the bf16 check above has met so far; one flipped on an H100 at a
        # gap of under 0.1.
        int8_paged, plain = pinned("int8 pool of 32, kernels vs plain",
                                   lambda: counted("paged+int8 B=32", "int8", 32, False),
                                   "int8", 32, True)
        compare("int8 pool of 32, kernels vs plain", int8_paged, plain,
                FORWARD_DLOGITS_TOL, near_ties=True)
    finally:
        if pin is not None:
            pin.close()
    compare("int8 slot cache vs int8 pool of 32 (kernels)", counted("int8", "int8", 0, False),
            int8_paged, FORWARD_PAGED_TOL)
    for name, a, b in zip(("prefill", "decode1", "decode2"), int8_paged, flat):
        log(f"forward {name}{' ' + model if model else ''}: int8 cache vs bf16 cache "
            f"(kernels), the quantization's effect: max|dlogits| "
            f"{(a - b).abs().max().item():.4g}, top-1 agreement "
            f"{(a.argmax(-1) == b.argmax(-1)).float().mean().item():.3f} (no limit)")
    log(f"forward{' ' + model if model else ''}: launch counts per run {json.dumps(counts)}")
    return counts


def _full_sequence_runs(torch, dev, model: str, cfg, params, tokens, lens, slots,
                        plain: bool, out: dict, logits: list, pin):
    """phase_full_sequence's runs: transformer_prefill through the kernel
    (recorded by ``pin``), with ``plain`` through the plain path (replayed),
    then transformer_forward on row 0 (replayed on row 0's tokens). Fills
    ``out`` with the launches and ``logits`` with the prefills'; returns
    the forward's logits at the last position."""
    from gofr_tpu_torch.models.transformer import transformer_forward, transformer_prefill
    from gofr_tpu_torch.ops.cuda import flash_attention as fa
    from gofr_tpu_torch.ops.kv_cache import KVCache

    b, s = tokens.shape
    for dense in (False, True) if plain else (False,):
        if pin is not None:
            pin.record() if not dense else pin.replay(f"{model} transformer_prefill plain")
        cache = KVCache.create(cfg.n_layers, b, s, cfg.n_kv_heads, cfg.head_dim,
                               dtype=cfg.dtype, device=dev)
        before = fa.launches
        t0 = time.perf_counter()
        logits.append(transformer_prefill(params, tokens, lens, cache, slots, cfg,
                                          dense_attn=dense))
        torch.cuda.synchronize()
        if not dense:
            out["transformer_prefill"] = fa.launches - before
            log(f"{model} transformer_prefill [{b}, {s}] (lengths {lens.tolist()}): "
                f"{time.perf_counter() - t0:.3f} s, {out['transformer_prefill']} "
                "flash_attention launches")
        if pin is not None:
            pin.off()
        del cache
    if pin is not None:
        pin.replay(f"{model} transformer_forward", rows=slice(0, s))
    before = fa.launches
    t0 = time.perf_counter()
    full = transformer_forward(params, tokens[:1], cfg)[0, -1:]
    torch.cuda.synchronize()
    out["transformer_forward"] = fa.launches - before
    log(f"{model} transformer_forward [1, {s}]: {time.perf_counter() - t0:.3f} s, "
        f"{out['transformer_forward']} flash_attention launches")
    if pin is not None:
        pin.off()
    return full


def phase_full_sequence(torch, dev, model: str, cfg, params, lengths=(2048, 700, 1), *,
                        plain: bool = True, seed: int = 29) -> dict:
    """A model's two full-sequence entry points: transformer_prefill on a
    right-padded batch of ``lengths`` (the longest first; flash_attention's
    lengths variant, with the model's window if it has one) and the eval
    forward transformer_forward on its row 0, held against the prefill's
    row 0 at its last position; with ``plain``, the prefill also against
    the plain path on its own cache. Finite logits, one flash_attention
    launch a layer each, the same top-1 (or a near-tie within the limit).
    Returns the launches. An MoE model's plain prefill and forward take
    the kernel prefill's experts where they differ at a router near-tie
    (``RoutePin``)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    b, s = len(lengths), lengths[0]
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    slots = torch.arange(b, dtype=torch.int32, device=dev)
    out, logits = {}, []
    # MoE: the plain prefill and the forward take the kernel prefill's
    # experts where they differ only at a router near-tie (the forward's
    # GEMMs run at another batch shape).
    pin = RoutePin(torch) if cfg.is_moe else None
    try:
        full = _full_sequence_runs(torch, dev, model, cfg, params, tokens, lens, slots,
                                   plain, out, logits, pin)
    finally:
        if pin is not None:
            pin.close()
    if not all(torch.isfinite(t).all() for t in logits + [full]):
        fail(f"{model} full-sequence entry points: non-finite logits")
    for key, n in out.items():
        if n != cfg.n_layers:
            fail(f"{model} {key}: {n} flash_attention launches, not {cfg.n_layers}")
    # The prefill's row 0 is the forward's row at its last position (the
    # same kernel arithmetic; the GEMMs run at other batch shapes).
    kern = logits[0]
    checks = [("transformer_prefill kernels vs plain", kern, logits[-1])] if plain else []
    checks.append((f"transformer_forward vs transformer_prefill at position {s - 1}", full,
                   kern[:1]))
    for label, a, want in checks:
        d = (a - want).abs().max().item()
        pick = a.argmax(-1)
        gap = (want.max(-1).values - want.gather(-1, pick[:, None])[:, 0]).max().item()
        log(f"{model} {label}: max|dlogits| {d:.4g} (limit {FORWARD_DLOGITS_TOL}; logit "
            f"range {want.min().item():.3g}..{want.max().item():.3g}), top-1 gap {gap:.4g}")
        if d > FORWARD_DLOGITS_TOL or gap > FORWARD_DLOGITS_TOL:
            fail(f"{model} {label}: the kernel path disagrees")
    del full, logits, kern
    torch.cuda.empty_cache()
    return out


# The other dense families served on the card, one at a time (model,
# serve an int8 pool too, run the full-sequence entry points, max_len):
# Gemma-7B and Qwen2-7B as Llama-3-8B, the others one bf16 serve each.
FAMILY_SERVES = [("gemma-7b", True, True, 2048), ("qwen2-7b", True, True, 2048),
                 ("pythia-6.9b", False, False, 2048), ("gemma-2b", False, True, 2048),
                 ("gpt2", False, False, 1024)]


def phase_family(torch, dev, model: str, *, pool: bool, full_sequence: bool,
                 max_len: int) -> dict:
    """One of the other dense families at full width and depth, random
    bf16 weights from seed 0: the forward check of ``phase_forward`` (with
    near-ties: random logits over vocabularies of 50-256 k tokens put the
    top two within the bf16 noise more often than Llama's did), then
    phase_serve's 10 prompts on the bf16 slot cache and, with ``pool``, an
    int8 pool of 161 x 32; with ``full_sequence``, ``phase_full_sequence``.
    Frees the weights. Returns each run's launch counts and stats."""
    from gofr_tpu_torch.models.registry import get_model
    from gofr_tpu_torch.models.transformer import init_params

    cfg = get_model(model).config
    with torch.inference_mode():
        t0 = time.perf_counter()
        params = init_params(cfg, seed=0, device=dev)
        torch.cuda.synchronize()
        log(f"params: {model} random bf16 weights on the card in "
            f"{time.perf_counter() - t0:.1f} s "
            f"({sum(p.numel() for p in params.values()) / 1e9:.2f} B parameters, "
            f"{sum(p.numel() * p.element_size() for p in params.values())} bytes); "
            f"heads {cfg.n_heads}/{cfg.n_kv_heads}, hd {cfg.head_dim}")
        out = {"forward": phase_forward(torch, dev, cfg, params, model=model, near_ties=True)}
    counts, _, stats = phase_serve(torch, dev, params, model=model, max_len=max_len)
    out["serve"] = dict(stats, counts=counts)
    if pool:
        pool_kv = dict(kv_block=32, kv_quant="int8", kv_pool_blocks=161)
        pool_counts, _, pool_stats = phase_serve(torch, dev, params, model=model,
                                                 max_len=max_len, **pool_kv)
        out["pool"] = dict(pool_stats, counts=pool_counts, kv=pool_kv)
    if full_sequence:
        with torch.inference_mode():
            out["full"] = phase_full_sequence(torch, dev, model, cfg, params)
    bf16_tok, int8_tok = (cfg.n_layers * kv_bytes(1, cfg.n_kv_heads, cfg.head_dim, quant)
                          for quant in (False, True))
    log(f"serve {model}: KV cache bytes a token: {bf16_tok} bf16, {int8_tok} int8 with scales")
    log(f"serve {model}: " + json.dumps({run: {k: st[k] for k in (
        "tok_s", "ttft_p50_ms", "itl_p50_ms", "windows", "prefill_dispatches", "syncs")}
        for run, st in out.items() if run in ("serve", "pool")}))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


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


def watch_steps(eng) -> dict:
    """From now on, the rows of each prefill dispatch the engine makes (the
    slots mid-prefill when it starts, at most prefill_batch: how admission
    spread the requests over the scheduler's passes) and the host wall
    time of each decode window from its dispatch to its tokens emitted
    (ms; with pipeline_depth windows queued before it), and on a
    speculative engine the tokens its live steps produced and their
    number (``spec``: [tokens, live steps]). Stop with
    ``unwatch_steps(eng)``."""
    seen = {"rows": [], "window_ms": [], "spec": [0, 0]}
    prefill, process = eng._prefill_step, eng._process_window
    G = eng.spec_tokens

    def counted_prefill():
        if eng._prefilling:
            seen["rows"].append(min(len(eng._prefilling), eng.prefill_batch))
        return prefill()

    def timed_window(win):
        process(win)
        seen["window_ms"].append((time.time() - win.t0) * 1e3)
        if G:
            steps = eng.window_k * (int(win.wrun) if win.wrun is not None else 1)
            counts = win.host[2 * G + 2, :steps]
            seen["spec"][0] += int(counts.sum())
            seen["spec"][1] += int((counts > 0).sum())

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


def serve_prompts(vocab: int, lengths: tuple = LLAMA_PROMPTS, sampled: bool = True) -> list:
    """phase_serve's prompts: token ids from numpy's generator at seed 0,
    the last one (with ``sampled``) a copy of the one before it."""
    import numpy as np

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, m).tolist() for m in lengths]
    if sampled:
        prompts[-1] = prompts[-2]
    return prompts


def phase_serve(torch, dev, params, *, model: str = "llama-3-8b", n_slots: int = 8,
                max_len: int = 2048, lengths: tuple = LLAMA_PROMPTS, sampled: bool = True,
                solo: int = 4, tag: str = "", eng=None, **kv) -> dict:
    """Concurrent requests (more than the slots) through the port's engine,
    32 new tokens each, on the slot cache or on the cache ``kv`` asks for
    (``kv_block``, ``kv_pool_blocks``, ``kv_quant``; and the decode loop's
    ``pipeline_depth``, ``mega_windows``, ``prefill_depth``): greedy, except
    (with ``sampled``) the last two, one seeded sampled prompt submitted
    twice; prompt ``solo`` rerun alone must repeat its batched stream; the
    run may make no stream synchronization. Returns the
    kernels' launch counts over the concurrent run (graph replays counted),
    each request's token ids and the run's tok/s, TTFT p50, ITL p50,
    decode windows, mega dispatches, prefill dispatches and stream syncs.
    ``eng``: serve on this engine (built by the caller, e.g. from config)
    instead of one made here; ``tag`` names the weights in the log."""
    import numpy as np

    from gofr_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from gofr_tpu_torch.serving.engine import InferenceEngine

    if eng is None:
        eng = InferenceEngine(
            model, n_slots=n_slots, max_len=max_len, window_k=8, prefill_chunk=256,
            prefill_batch=8, params=params, seed=0, device=dev, **kv,
        )
    label = (f"serve {model}{' ' + tag if tag else ''} "
             f"{json.dumps(kv) if kv else '(bf16 slot cache)'}")
    n = len(lengths)
    try:
        prompts = serve_prompts(eng.cfg.vocab_size, lengths, sampled)
        kws = [dict(max_new_tokens=32)] * n
        if sampled:  # the seeded sampled request, submitted twice
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
        if eng._graphs is not None:
            stats["capture_s"] = sum(eng._graphs.capture_s.values())
        if eng.spec_tokens:
            tokens, steps = seen["spec"]
            stats["tokens_per_step"] = tokens / max(steps, 1)
            log(f"{label}: speculative steps produced {tokens} tokens in {steps} live "
                f"steps: {stats['tokens_per_step']:.3f} a step")
        if kv.get("kv_block"):
            stats["pool_peak_blocks"] = eng.kv_blocks_peak
        log(f"{label}: {n} requests (prompts {list(lengths)}, 32 new tokens each) in "
            f"{wall:.3f} s: {stats['tok_s']:.1f} generated tok/s, TTFT p50 "
            f"{stats['ttft_p50_ms']:.1f} ms (max {stats['ttft_max_ms']:.1f}), "
            f"inter-token latency p50 {stats['itl_p50_ms']:.2f} ms; "
            f"{eng.prefill_steps} prefill dispatches, {eng.decode_windows} decode windows "
            "(warm-up included)")
        log(f"{label}: first tokens {[r.token_ids[:4] for r in results]}")
        log(f"{label}: KV cache {eng.cache.hbm_bytes()} bytes on the card; weights "
            f"{eng.quant or str(eng.cfg.dtype).split('.')[-1]}, param_bytes() "
            f"{eng.param_bytes()}")
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


def first_difference(torch, cfg, params, prompt: list, want: list, got: list,
                     aid: int = 0) -> dict | None:
    """Where a greedy stream ``got`` leaves ``want`` (None if it does not):
    the step, the two tokens and the top-2 logit margin there, from the
    plain forward over the prompt and the common prefix (a near-tie below
    NEAR_TIE is accepted as reduction order, anything else is a state
    hazard); ``aid``: the forward runs under that LoRA adapter slot of
    ``params``."""
    from gofr_tpu_torch.models.transformer import transformer_forward

    step = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b), None)
    if step is None:
        return None if len(want) == len(got) else {"step": min(len(want), len(got)),
                                                   "margin": float("inf")}
    dev = params["embed"].device
    ids = torch.tensor([prompt + want[:step]], device=dev)
    aids = torch.tensor([aid], device=dev) if aid else None
    logits = transformer_forward(params, ids, cfg, aids=aids)[0, -1].float()
    top = torch.topk(logits, 2).values
    return {"step": step, "want": want[step], "got": got[step],
            "margin": float(top[0] - top[1])}


# A greedy stream may leave another only at a top-2 logit margin below this.
NEAR_TIE = 1e-2


def decode_state(torch, dev, cfg, S: int, L: int, history_len: int = 1) -> tuple:
    """A slot cache of S x L tokens and sampler planes (flags off; a
    history plane of ``history_len`` columns), all zero."""
    from gofr_tpu_torch.ops.kv_cache import KVCache
    from gofr_tpu_torch.serving import programs as pg

    cache = KVCache.create(cfg.n_layers, S, L, cfg.n_kv_heads, cfg.head_dim, dtype=cfg.dtype,
                           device=dev)
    return cache, pg.SlotPlanes.create(S, dev, cfg.vocab_size, pg.SamplerFlags(),
                                       history_len=history_len)


def copy_decode_state(dst: tuple, src: tuple, kv: bool = True) -> None:
    """Copy ``src``'s lengths and planes into ``dst``, and its K/V unless
    ``kv`` is False (a window then reruns from the same lengths, tokens,
    counters and history over other cache contents)."""
    dst[0].lengths.copy_(src[0].lengths)
    if kv:
        dst[0].k.copy_(src[0].k)
        dst[0].v.copy_(src[0].v)
    for f in ("tokens", "nsteps", "seeds", "temps", "greedy", "active", "topps", "fpen",
              "ppen", "pcounts", "bidx", "bval", "history"):
        getattr(dst[1], f).copy_(getattr(src[1], f))


def capture_decode_graphs(torch, planes, **fns) -> tuple:
    """``DecodeGraphs(**fns)`` while every slot of ``planes`` is inactive,
    as the engine captures before its first request: (the graphs, seconds
    with the warm-ups, graph pool bytes reserved)."""
    from gofr_tpu_torch.serving import programs as pg

    planes.active.fill_(False)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    graphs = pg.DecodeGraphs(**fns)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    torch.cuda.empty_cache()
    return graphs, seconds, torch.cuda.memory_reserved() - reserved0


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
    from gofr_tpu_torch.serving import programs as pg

    S, L, k, m, c = 8, 2048, 8, 4, 256
    flags = pg.SamplerFlags()
    rope = rope_tables(cfg, L, dev)
    with torch.inference_mode():
        def win(st, sampling, use_bias):
            return pg.decode_window(params, st[0], cfg, rope, st[1], flags, k, 2,
                                    sampling=sampling, use_bias=use_bias)

        eager, graphed = (decode_state(torch, dev, cfg, S, L) for _ in range(2))
        graphs, capture_s, pool = capture_decode_graphs(
            torch, graphed[1], window_fn=lambda s, b: win(graphed, s, b))
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
        start = decode_state(torch, dev, cfg, S, L)
        copy_decode_state(start, eager)
        results = {}
        for v in pg.VARIANTS:
            copy_decode_state(eager, start)
            copy_decode_state(graphed, start)
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
        copy_decode_state(eager, start)
        plain = torch.cat([win(eager, False, False) for _ in range(m)], dim=1)
        streams = plain[0].long().t().tolist()  # [S][m·k]
        eos_slot, s6 = 6, streams[6]
        eos = s6[next((p for p in range(2 * k, 3 * k) if s6[p] not in s6[:p]), 2 * k)]
        mega = pg.MegaState.create(S, k, m, 0, dev)
        megas, mega_capture_s, mega_pool = capture_decode_graphs(torch, graphed[1], mega_fns=(
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
            copy_decode_state(graphed, start)
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


# Repeated text, the n-gram draft's best case: the reference's BENCH_PROMPTS
# (tests/test_spec_decoding.py) as byte ids.
SPEC_PROMPTS = tuple([ord(ch) for ch in ("abcdefgh"[i % 4:] + "abcdefgh" * 12)[:64]]
                     for i in range(4))


def check_streams(torch, cfg, params, label: str, prompts: list, want: list, got: list,
                  greedy: list, aids: list | None = None) -> None:
    """``got`` must equal ``want`` stream for stream: a greedy stream may
    leave it only at a top-2 logit margin below NEAR_TIE (reduction order,
    from the plain forward, under request i's LoRA adapter slot
    ``aids[i]``), a sampled one not at all. Logs how many streams were
    equal bit for bit."""
    for i, (a, b) in enumerate(zip(want, got)):
        if a == b:
            continue
        if not greedy[i]:
            fail(f"{label}: sampled request {i} differs from the baseline stream")
        diff = first_difference(torch, cfg, params, prompts[i], a, b,
                                aid=aids[i] if aids else 0)
        log(f"{label}: request {i} leaves the baseline stream: {diff}")
        if diff["margin"] >= NEAR_TIE:
            fail(f"{label}: request {i} differs from the baseline stream at a top-2 margin "
                 f"{diff['margin']:.4g} >= {NEAR_TIE}: a state hazard")
    same = sum(a == b for a, b in zip(want, got))
    log(f"{label}: {same} of {len(got)} streams equal to the baseline bit for bit")


def serve_repeated(torch, dev, params, G: int) -> tuple:
    """SPEC_PROMPTS (32 greedy tokens each) through an engine at G, all
    submitted at once: (streams, tokens a live step, launch counts)."""
    from gofr_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from gofr_tpu_torch.serving.engine import InferenceEngine

    eng = InferenceEngine("llama-3-8b", n_slots=8, max_len=2048, window_k=8, prefill_chunk=256,
                          prefill_batch=8, params=params, seed=0, device=dev, spec_tokens=G)
    try:
        eng.generate_sync([1, 2, 3], max_new_tokens=2, timeout=600)
        torch.cuda.synchronize()
        reset_launch_counts()
        seen = watch_steps(eng)
        reqs = [eng.submit_generate(list(p), max_new_tokens=32, stop_on_eos=False)
                for p in SPEC_PROMPTS]
        streams = [r.future.result(timeout=600).token_ids for r in reqs]
        unwatch_steps(eng)
        tokens, steps = seen["spec"]
        return streams, tokens / max(steps, 1) if G else 1.0, launch_counts()
    finally:
        eng.close()


def phase_spec(torch, dev, cfg, params, base: list, base_stats: dict, pool_base: list,
               pool_stats: dict, pool_kv: dict) -> dict:
    """Exact-verify speculative decoding at phase_serve's geometry
    (Llama-3-8B, 8 slots, max_len 2048, k = 8, G = 2): (1) the captured
    spec window against the eager one on copies of one state after a
    prefill of repeated text, every static variant (greedy / sampled x
    logit bias): tokens and counts identical, logprobs within 1e-3, the
    same lengths and history, flash_decode launched k·(G+1)·layers times a
    window, counted through the replay; the capture time and graph pool
    bytes; (2) the mega spec window (m = 4, a WHILE node) against plain
    spec windows, with windows_run equal to the reference's exit, where a
    window takes from each budget the tokens it delivered: two budget sets
    and one where slot 6 stops on an EOS id among the tokens its third
    window delivers; (3) phase_serve's 10 prompts at G = 2 on the bf16
    slot cache and on the int8 pool, held against the G = 0 streams of
    this run (phase_serve's), and SPEC_PROMPTS at G = 2 against G = 0,
    with tok/s, TTFT p50, ITL p50, tokens a live step, windows, launches,
    pool peak and stream syncs beside G = 0's; (4) a profile of one
    replayed spec window."""
    from gofr_tpu_torch.models.transformer import rope_tables
    from gofr_tpu_torch.ops.cuda import launch_counts, replayed, reset_launch_counts
    from gofr_tpu_torch.serving import programs as pg

    S, L, k, m, c, G = 8, 2048, 8, 4, 256, 2
    rows = pg.spec_rows(G)
    flags = pg.SamplerFlags()
    rope = rope_tables(cfg, L, dev)
    out: dict = {}
    with torch.inference_mode():
        def win(st, sampling, use_bias):
            return pg.spec_window(params, st[0], cfg, rope, st[1], flags, k, G, 2,
                                  sampling=sampling, use_bias=use_bias)

        eager, graphed = (decode_state(torch, dev, cfg, S, L, history_len=L) for _ in range(2))
        graphs, capture_s, pool = capture_decode_graphs(
            torch, graphed[1], window_fn=lambda s, b: win(graphed, s, b))
        log(f"spec: captured 4 spec-window variants (k={k}, G={G}) in {capture_s:.2f} s "
            "(warm-up included); capture alone by variant "
            + json.dumps({key: round(v, 3) for key, v in graphs.capture_s.items()})
            + f"; graph memory pool {pool} bytes reserved; launches a replayed window "
            + json.dumps({str(v): g.launches for v, g in graphs.windows.items()}))
        out.update(capture_s=capture_s, pool_bytes=pool,
                   capture_by_variant=dict(graphs.capture_s))

        # One prefill chunk of repeated text in every slot (rotated per
        # slot), so that the drafts find their bigrams.
        gen = torch.Generator(device=dev).manual_seed(0)
        i32 = dict(dtype=torch.int32, device=dev)
        ones = torch.ones((S,), dtype=torch.bool, device=dev)
        lens = torch.tensor((1, 17, 64, 100, 150, 200, 255, 256), **i32)
        motif = torch.randint(0, cfg.vocab_size, (16,), generator=gen, device=dev)
        toks = torch.stack([motif.roll(i).repeat(c // 16) for i in range(S)])
        planes = eager[1]
        planes.seeds.copy_(torch.arange(S, device=dev) * 7 + 1)
        planes.bidx[:, :3] = torch.randint(0, cfg.vocab_size, (S, 3), generator=gen, device=dev)
        planes.bval[:, :3] = 5.0
        sampled_rows = torch.arange(S, device=dev) % 2 == 1
        pg.prefill_chunk_step(params, eager[0], cfg, rope, planes, flags, toks,
                              torch.arange(S, **i32), torch.zeros((S,), **i32), lens, ones,
                              ones, torch.full((S,), 0.8, device=dev), ~sampled_rows,
                              torch.ones((S,), device=dev), 2, sampling=True, history=True)
        planes.active.fill_(True)
        planes.temps.fill_(0.8)
        planes.greedy.copy_(~sampled_rows)
        start = decode_state(torch, dev, cfg, S, L, history_len=L)
        copy_decode_state(start, eager)
        results = {}
        for v in pg.VARIANTS:
            copy_decode_state(eager, start)
            copy_decode_state(graphed, start)
            reset_launch_counts()
            e = win(eager, *v).clone()
            torch.cuda.synchronize()
            eager_counts = launch_counts()
            reset_launch_counts()
            g = graphs.window(*v).clone()
            torch.cuda.synchronize()
            graph_counts = launch_counts()
            counts = e[2 * G + 2]
            r = {"tokens_equal": bool(torch.equal(e[: G + 1], g[: G + 1])),
                 "counts_equal": bool(torch.equal(counts, g[2 * G + 2])),
                 "max_abs_dlogprob": float((e[G + 1: 2 * G + 2] - g[G + 1: 2 * G + 2])
                                           .abs().max()),
                 "bitwise": bool(torch.equal(e, g)),
                 "state_equal": bool(torch.equal(eager[0].lengths, graphed[0].lengths)
                                     and torch.equal(eager[1].history, graphed[1].history)
                                     and torch.equal(eager[1].nsteps, graphed[1].nsteps)),
                 "tokens_a_step": float(counts.mean()),
                 "launches_eager": eager_counts, "launches_graph": graph_counts}
            results[str(v)] = r
            if not (r["tokens_equal"] and r["counts_equal"] and r["state_equal"]) \
                    or r["max_abs_dlogprob"] > 1e-3:
                fail(f"spec: the captured spec window {v} differs from the eager one: {r}")
            if eager_counts != graph_counts or \
                    graph_counts["flash_decode"] != k * (G + 1) * cfg.n_layers:
                fail(f"spec: launches eager {eager_counts} vs replayed {graph_counts}, "
                     f"want k·(G+1)·layers = {k * (G + 1) * cfg.n_layers} flash_decode")
        log("spec: captured window vs eager, (sampling, use_bias): "
            + json.dumps({key: {x: y for x, y in r.items() if not x.startswith("launches")}
                          for key, r in results.items()})
            + f"; launches a window eager = replayed = {graph_counts}")
        out["graph_vs_eager"] = results
        out["launches_a_window"] = graph_counts

        # (4) One replayed spec window, profiled; each repetition starts
        # from the same lengths, tokens, counters and history.
        copy_decode_state(graphed, start)

        def replay():
            copy_decode_state(graphed, start, kv=False)
            graphs.window(False, False)

        prof = _profile_step(torch, "spec_window_k8_G2_graph_replay", replay)
        log("profile: " + json.dumps(prof))
        out["profile"] = prof
        del graphs

        # (2) m plain spec windows from the start, and the host's exit rule.
        copy_decode_state(eager, start)
        plain = torch.cat([win(eager, False, False) for _ in range(m)], dim=1)
        ptoks = plain[: G + 1].long().cpu()  # [G+1, m·k, S]
        pcounts = plain[2 * G + 2].long().cpu()  # [m·k, S]

        def delivered(w, i):
            """Slot i's tokens in plain window w, in order."""
            return [int(ptoks[j, t, i]) for t in range(w * k, (w + 1) * k)
                    for j in range(int(pcounts[t, i]))]

        eos_slot = 6
        seen6 = delivered(0, eos_slot) + delivered(1, eos_slot)
        eos = next((t for t in delivered(2, eos_slot) if t not in seen6),
                   delivered(2, eos_slot)[0])
        mega = pg.MegaState.create(S, k, m, 0, dev, spec_tokens=G)
        megas, mega_capture_s, mega_pool = capture_decode_graphs(torch, graphed[1], mega_fns=(
            lambda: pg.mega_begin(mega),
            lambda s, b: pg.mega_step(params, graphed[0], cfg, rope, graphed[1], flags, k,
                                      m, 2, eos, mega, sampling=s, use_bias=b,
                                      spec_tokens=G),
            mega.go))
        log(f"spec: captured 4 mega spec bodies in {mega_capture_s:.2f} s (warm-up "
            "included); capture alone by variant "
            + json.dumps({key: round(v, 3) for key, v in megas.capture_s.items()})
            + f"; graph memory pool {mega_pool} bytes reserved; EOS id {eos}")
        out.update(mega_capture_s=mega_capture_s, mega_pool_bytes=mega_pool)

        def exit_after(remaining, stop):
            """The reference's mega spec exit on the host: windows run while
            (w < m) & any(remaining > 0); a window takes from each budget
            the tokens it delivered, and zeroes it where the slot stops on
            an EOS among them."""
            rem, w = list(remaining), 0
            while w < m and any(x > 0 for x in rem):
                rem = [0 if stop[i] and eos in delivered(w, i)
                       else max(0, x - len(delivered(w, i))) for i, x in enumerate(rem)]
                w += 1
            return w

        no_stop = (False,) * S
        eos_stop = tuple(i == eos_slot for i in range(S))
        mega_runs = []
        for remaining, stop in (((0, 5, 9, 17, 3, 12, 30, 1), no_stop),
                                ((0, 40, 9, 70, 3, 1, 0, 2), no_stop),
                                ((0, 5, 9, 3, 3, 1, 200, 1), eos_stop)):
            want_w = exit_after(remaining, stop)
            plain_w = min(m, -(-max(remaining) // k))  # at k tokens a window
            if stop is eos_stop and want_w >= exit_after(remaining, no_stop):
                fail(f"spec: EOS id {eos} does not end slot {eos_slot}'s windows early")
            copy_decode_state(graphed, start)
            mega.remaining.copy_(torch.tensor(remaining, device=dev))
            mega.eos_stop.copy_(torch.tensor(stop, device=dev))
            reset_launch_counts()
            record = megas.mega(False, False)
            torch.cuda.synchronize()
            w = int(mega.w)
            replayed(record, w)
            got, want = mega.emitted[:, : w * k], plain[:, : want_w * k]
            equal = (w == want_w and torch.equal(got[: G + 1], want[: G + 1])
                     and torch.equal(got[2 * G + 2], want[2 * G + 2]))
            ok = (equal and float((got[G + 1: 2 * G + 2] - want[G + 1: 2 * G + 2])
                                  .abs().max()) <= 1e-3
                  and not mega.emitted[:, w * k:].any())
            run = {"remaining": list(remaining), "eos_stop": [i for i, x in enumerate(stop) if x],
                   "windows_run": w, "reference_exit": want_w, "at_k_a_window": plain_w,
                   "equal_to_plain": equal, "bitwise": w == want_w and bool(torch.equal(got, want)),
                   "launches": launch_counts()}
            mega_runs.append(run)
            log("spec: mega spec window (m=4): " + json.dumps(run))
            if not ok:
                fail("spec: the mega spec window's graph differs from plain spec windows")
            if launch_counts()["flash_decode"] != w * k * (G + 1) * cfg.n_layers:
                fail("spec: the mega spec window's launches are not its windows'")
        out["mega"] = mega_runs
        del megas, eager, graphed, start, mega, plain
        gc.collect()
        torch.cuda.empty_cache()

    # (3) The A/B serves: G = 2 against G = 0 (phase_serve's runs).
    rng = __import__("numpy").random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in LLAMA_PROMPTS]
    prompts[-1] = prompts[-2]
    greedy = [True] * (len(prompts) - 2) + [False, False]
    keys = ("tok_s", "ttft_p50_ms", "itl_p50_ms", "tokens_per_step", "windows",
            "prefill_dispatches", "syncs", "pool_peak_blocks", "counts")
    ab = {}
    for label, kv, want, want_stats in (("bf16 slot cache", {}, base, base_stats),
                                        ("int8 pool", pool_kv, pool_base, pool_stats)):
        counts, streams, stats = phase_serve(torch, dev, params, spec_tokens=G, **kv)
        check_streams(torch, cfg, params, f"spec serve {label}", prompts, want, streams, greedy)
        for name in ("flash_decode", "flash_cache_attention"):
            if counts[name] <= 0:
                fail(f"spec serve {label}: kernel {name} was not launched")
        ab[label] = {f"G={g}": {x: st.get(x) for x in keys}
                     for g, st in ((0, want_stats), (G, stats))}
        log(f"spec A/B {label}: " + json.dumps(ab[label]))
    rep = {}
    for g in (0, G):
        rep[g] = serve_repeated(torch, dev, params, g)
    check_streams(torch, cfg, params, "spec serve repeated text", list(SPEC_PROMPTS),
                  rep[0][0], rep[G][0], [True] * len(SPEC_PROMPTS))
    log(f"spec repeated text ({len(SPEC_PROMPTS)} prompts of 64 byte ids, 32 greedy tokens): "
        f"G={G} produced {rep[G][1]:.3f} tokens a live step; flash_decode launches "
        f"G=0 {rep[0][2]['flash_decode']}, G={G} {rep[G][2]['flash_decode']}")
    out.update(ab=ab, repeated_tokens_per_step=rep[G][1])
    return out


# -- the prefix cache (phase_prefix) ---------------------------------------

# A system prompt of 1,024 token ids shared by 10 requests with distinct
# suffixes (the last two seeded sampled), and an 11th that is the system
# prompt alone (a whole-prompt hit: the boundary block copied on write).
PREFIX_SYSTEM = 1024
PREFIX_SUFFIXES = (32, 75, 128, 190, 250, 300, 333, 380, 400, 364)


def prefix_traffic(vocab: int) -> tuple:
    """(system, prompts, kws, greedy flags, priming prompt) from seed 11."""
    import numpy as np

    rng = np.random.default_rng(11)
    system = rng.integers(0, vocab, PREFIX_SYSTEM).tolist()
    prompts = [system + rng.integers(0, vocab, n).tolist() for n in PREFIX_SUFFIXES]
    prompts.append(list(system))
    kws = [dict(max_new_tokens=32)] * len(prompts)
    kws[8:10] = [dict(max_new_tokens=32, temperature=0.8, seed=4242)] * 2
    greedy = [kw.get("temperature", 0.0) <= 0 for kw in kws]
    return system, prompts, kws, greedy, system + rng.integers(0, vocab, 64).tolist()


def pool_invariant(eng, label: str) -> None:
    """After idle: each pool block's refcount equals the slot tables and
    the radix index that hold it, and the free list holds exactly the
    blocks nothing holds."""
    refs: dict = {}
    held = [b for row in eng._slot_blocks for b in row]
    if eng._radix is not None:
        held += eng._radix.cached_block_ids()
    for b in held:
        refs[b] = refs.get(b, 0) + 1
    alloc = eng._allocator
    free = list(alloc.free_blocks)
    bad = [b for b in range(1, alloc.n_blocks)
           if alloc.refcount(b) != refs.get(b, 0) or ((b in free) != (refs.get(b, 0) == 0))]
    if bad or len(set(free)) != len(free):
        fail(f"{label}: the block invariant fails at blocks {bad[:8]} "
             f"(free list {len(free)} entries, {len(set(free))} distinct)")
    log(f"{label}: block invariant holds after idle: {len(free)} free, "
        f"{len(held)} references held ({eng.kv_pool_counts()[2]} blocks cached)")


def serve_prefix(torch, dev, params, label: str, traffic: tuple, *, prime: bool = False,
                 register: bool = False, **kv) -> dict:
    """``traffic``'s 11 requests at once through an engine at phase_serve's
    geometry (8 slots, max_len 2048, k 8, chunk 8 x 256, depth 2) with
    ``kv``; before them (off the record) the warm-up, with ``prime`` the
    priming request and with ``register`` ``register_prefix_sync(system)``.
    Returns the streams, the launch counts of the wave and its figures:
    tok/s, TTFT p50, ITL p50, prefill dispatches and rows, peak pool
    blocks, cached blocks, evictions, index lookups and hit tokens, pool
    loads, stream syncs. Every request must finish (32 tokens or EOS) and
    the run may make no stream sync; a pool's block invariant must hold
    after idle."""
    import numpy as np

    from gofr_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from gofr_tpu_torch.serving.engine import InferenceEngine

    system, prompts, kws, _, priming = traffic
    eng = InferenceEngine("llama-3-8b", n_slots=8, max_len=2048, window_k=8,
                          prefill_chunk=256, prefill_batch=8, params=params, seed=0,
                          device=dev, **kv)
    try:
        eng.generate_sync([1, 2, 3], max_new_tokens=2, timeout=600)
        if prime:
            eng.generate_sync(priming, max_new_tokens=2, timeout=600)
        if register:
            row = eng.register_prefix_sync(system, timeout=600)
            log(f"{label}: the system prompt registered in prefix pool row {row}")
        loads = [0]
        if eng._prefix_pool is not None:
            load = eng._prefix_pool.load
            eng._prefix_pool.load = lambda *a: (loads.__setitem__(0, loads[0] + 1), load(*a))
        torch.cuda.synchronize()
        radix = eng._radix
        before = (eng._prefix_lookups, eng._prefix_hit_tokens,
                  radix.evicted if radix is not None else 0, eng.prefill_steps)
        if kv.get("kv_block"):
            eng.kv_blocks_peak = 0
        reset_launch_counts()
        seen = watch_steps(eng)
        count_syncs(torch, True)
        t0 = time.perf_counter()
        reqs = [eng.submit_generate(p, **kw) for p, kw in zip(prompts, kws)]
        results = []
        for i, r in enumerate(reqs):
            try:
                results.append(r.future.result(timeout=600))
            except Exception as exc:  # a failed request fails the phase
                fail(f"{label}: request {i} failed: {exc!r}")
        wall = time.perf_counter() - t0
        syncs = count_syncs(torch, False)
        unwatch_steps(eng)
        counts = launch_counts()
        if syncs:
            fail(f"{label}: {syncs} stream synchronizations in the run; the first at\n"
                 + "\n".join(SYNCS["first"]))
        eos = eng.tokenizer.eos_id
        for i, res in enumerate(results):
            m = len(res.token_ids)
            if not (m == 32 or (res.finish_reason == "stop" and res.token_ids[-1] == eos)):
                fail(f"{label}: request {i} ended with {m} tokens ({res.finish_reason})")
            if not np.all(np.isfinite(res.token_logprobs)):
                fail(f"{label}: request {i} has non-finite logprobs")
        for name in ("flash_decode", "flash_cache_attention"):
            if counts[name] <= 0:
                fail(f"{label}: kernel {name} was not launched on the main path")
        stats = serve_stats(reqs, wall)
        stats.update(
            prefill_dispatches=eng.prefill_steps - before[3], prefill_rows=seen["rows"],
            lookups=eng._prefix_lookups - before[0], hit_tokens=eng._prefix_hit_tokens - before[1],
            evictions=(radix.evicted if radix is not None else 0) - before[2],
            pool_loads=loads[0], syncs=syncs, counts=counts)
        if kv.get("kv_block"):
            total, used, cached = eng.kv_pool_counts()
            stats.update(pool_blocks=total, peak_blocks=eng.kv_blocks_peak, cached_blocks=cached)
        log(f"{label}: 11 requests (system {PREFIX_SYSTEM} + suffixes "
            f"{list(PREFIX_SUFFIXES)}, the system alone; 32 new tokens) in {wall:.3f} s: "
            + json.dumps({k: v for k, v in stats.items() if k != "counts"}))
        log(f"{label}: launch counts {counts}")
        if kv.get("kv_block"):
            deadline = time.monotonic() + 30
            while (any(s is not None for s in eng._slots) or eng._prefilling
                   or eng._inflight) and time.monotonic() < deadline:
                time.sleep(0.01)
            pool_invariant(eng, label)
            if radix is None and eng.kv_pool_counts()[1] != 0:
                fail(f"{label}: blocks still held after every request retired")
        stats["streams"] = [r.token_ids for r in results]
        return stats
    finally:
        eng.close()
        gc.collect()
        torch.cuda.empty_cache()


def phase_prefix_kernels(torch, dev) -> dict:
    """The serving kernels where the prefix cache takes them, at the
    serving shapes (H 32, KV 8, hd 128, blocks of 32, max_len 2048): every
    slot's table aliases the same 32 physical blocks (the cached system
    prompt) before its own; flash_decode at lengths 1,056 to 1,424 (split
    and written), flash_cache_attention on chunks that start at done =
    1,024 and one row at 1,023 (a whole-prompt hit's last position); bf16
    and int8 pools, each against its plain version in f32 (row error /
    row rms under ROW_REL_TOL) and bit for bit against the contiguous
    kernel on the gathered rows. Then ``paged_copy_block`` on Llama-3-8B's
    32-layer pools, bf16 and int8: the destination is bit for bit the
    source, every other block unchanged; its time beside its byte bound."""
    from gofr_tpu_torch.ops.cuda import flash_decode as fd
    from gofr_tpu_torch.ops.cuda import flash_prefill as fp
    from gofr_tpu_torch.ops.kv_cache import (
        PagedKVCache,
        fake_quantize_kv,
        paged_copy_block,
        paged_view,
        quantize_kv,
    )

    gen = torch.Generator(device=dev).manual_seed(1024)
    H, KV, hd, B, max_len, S = 32, 8, 128, 32, 2048, 8
    shared = PREFIX_SYSTEM // B
    lengths = [PREFIX_SYSTEM + n for n in PREFIX_SUFFIXES[:S]]
    own = [-(-(n + 1) // B) - shared for n in lengths]
    n_blocks = 1 + shared + sum(own) + 8
    perm = (torch.randperm(n_blocks - 1, generator=gen, device=dev) + 1).tolist()
    table = torch.zeros((S, max_len // B), dtype=torch.int32)
    table[:, :shared] = torch.tensor(perm[:shared], dtype=torch.int32)
    i = shared
    for r in range(S):
        table[r, shared: shared + own[r]] = torch.tensor(perm[i: i + own[r]], dtype=torch.int32)
        i += own[r]
    table = table.to(dev)
    i32 = dict(dtype=torch.int32, device=dev)
    lens = torch.tensor(lengths, **i32)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def f32(d):
        return {k: (t.float() if t.dtype == torch.bfloat16 else t) for k, t in d.items()}

    out: dict = {"flash_decode": [], "flash_cache_attention": []}
    q, kn, vn = rnd(S, H, hd), rnd(S, KV, hd), rnd(S, KV, hd)
    rows = [(r, PREFIX_SYSTEM, min(256, PREFIX_SUFFIXES[r])) for r in range(S - 1)]
    rows.append((S - 1, PREFIX_SYSTEM - 1, 1))
    qp = rnd(len(rows), 256, H, hd)
    slots, starts, plens = (torch.tensor([r[j] for r in rows], **i32) for j in range(3))
    for quant in (False, True):
        k, v = rnd(n_blocks, KV, B, hd), rnd(n_blocks, KV, B, hd)
        pools = dict(k_cache=k, v_cache=v)
        knq, vnq = kn, vn
        if quant:
            (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
            pools = dict(k_cache=kq, v_cache=vq, k_scale=ks, v_scale=vs)
            knq, vnq = fake_quantize_kv(kn), fake_quantize_kv(vn)
        paged = dict(pools, block_table=table)
        flat_k, flat_v, flat_ks, flat_vs = paged_view(
            table, pools["k_cache"], pools["v_cache"], torch.arange(S, device=dev),
            pools.get("k_scale"), pools.get("v_scale"))
        flat = dict(k_cache=flat_k.contiguous(), v_cache=flat_v.contiguous())
        if quant:
            flat.update(k_scale=flat_ks.contiguous(), v_scale=flat_vs.contiguous())
        tag = "int8 pool" if quant else "bf16 pool"
        errs, rels = [], []
        for conv, new in (("split", dict(k_new=knq, v_new=vnq)), ("written", {})):
            name = f"prefix flash_decode {tag} ({conv}), 8 slots aliasing 32 blocks"
            got = fd.flash_decode(q, lengths=lens, **new, **paged)
            e, r = check_close(torch, name, got, fd.flash_decode_plain(
                q.float(), lengths=lens, **f32(new), **f32(paged)))
            d = (got.float() - fd.flash_decode(q, lengths=lens, **new, **flat).float()
                 ).abs().max().item()
            log(f"{name}: max|aliased pool - contiguous| {d}; limit {PAGED_VS_CONTIGUOUS_TOL}")
            if d > PAGED_VS_CONTIGUOUS_TOL:
                fail(f"{name}: the aliased pool's result differs from the contiguous one")
            errs.append(e)
            rels.append(r)
        out["flash_decode"].append(dict(case=f"prefix {tag}, aliased table", max_abs_err=max(errs),
                                        max_row_rel_err=max(rels), lengths=lengths))
        name = f"prefix flash_cache_attention {tag}, chunks from done = 1024 over aliased blocks"
        got = fp.flash_cache_attention(qp, slots=slots, starts=starts, lens=plens, **paged)
        e, r = check_close(torch, name, got, fp.flash_cache_attention_plain(
            qp.float(), slots=slots, starts=starts, lens=plens, **f32(paged)))
        d = (got.float() - fp.flash_cache_attention(
            qp, slots=slots, starts=starts, lens=plens, **flat).float()).abs().max().item()
        log(f"{name}: max|aliased pool - contiguous| {d}; limit {PAGED_VS_CONTIGUOUS_TOL}")
        if d > PAGED_VS_CONTIGUOUS_TOL:
            fail(f"{name}: the aliased pool's result differs from the contiguous one")
        out["flash_cache_attention"].append(dict(
            case=f"prefix {tag}, aliased table", max_abs_err=e, max_row_rel_err=r,
            rows=[list(x) for x in rows]))
        del pools, paged, flat, k, v
    # paged_copy_block at Llama-3-8B's 32 layers.
    out["paged_copy_block"] = []
    for quant in ("", "int8"):
        cache = PagedKVCache.create(32, 2, 64, KV, hd, quant=quant, block=B, n_blocks=6,
                                    device=dev)
        planes = [t for t in (cache.k, cache.v, cache.k_s, cache.v_s) if t is not None]
        for t in planes:
            if t.dtype == torch.int8:
                t.copy_(torch.randint(-127, 128, t.shape, generator=gen, device=dev))
            else:
                t.copy_(torch.randn(t.shape, generator=gen, device=dev))
        before = [t.clone() for t in planes]
        paged_copy_block(cache, 2, 5)
        torch.cuda.synchronize()
        for t, old in zip(planes, before):
            bits = (lambda x: x.view(torch.int16) if x.dtype == torch.bfloat16 else x)
            if not torch.equal(bits(t[:, 5]), bits(old[:, 2])):
                fail(f"paged_copy_block {quant or 'bf16'}: the copy is not the source bit for bit")
            keep = [b for b in range(6) if b != 5]
            if not torch.equal(bits(t[:, keep]), bits(old[:, keep])):
                fail(f"paged_copy_block {quant or 'bf16'}: a block other than the target changed")
        nbytes = 2 * cache.block_bytes()
        ms = time_ms(torch, lambda: paged_copy_block(cache, 2, 5))
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"prefix paged_copy_block {quant or 'bf16'} (32 layers, block of 32, K, V"
            f"{' and scales' if quant else ''}): bit for bit the source, other blocks "
            f"unchanged; {ms:.4f} ms ({cache.k.shape[0] * (4 if quant else 2)} copies), "
            f"bound {bound:.5f} ms ({nbytes} bytes read and written)")
        out["paged_copy_block"].append(dict(case=quant or "bf16", ms=ms, bound_ms=bound,
                                            bytes=nbytes))
        del cache, planes, before
    return out


def phase_prefix(torch, dev, cfg, params) -> dict:
    """The prefix cache at Llama-3-8B's full width and depth on
    phase_serve's geometry: phase_prefix_kernels, then ``prefix_traffic``
    through (a) a bf16 pool of 513 blocks of 32, ``auto_prefix`` off, then
    on (one priming request first); (b) an int8 pool of 513 off, then the
    int8 pool of 161 with ``auto_prefix`` and ``prefix_cache_blocks`` 64
    (a primed wave that would need about twice the pool unshared and
    retires more full prompt blocks than the cap: eviction must run, no
    request may fail); (c) the bf16 slot cache without, then with
    ``prefix_slots`` 2 and ``register_prefix_sync(system)``; (d) (a)'s warm
    run again at ``spec_tokens`` 2 and at ``prefill_depth`` 3. Every warm
    stream equals its cold counterpart or leaves it only at a greedy
    near-tie (check_streams); the index's lookups and hit tokens are what
    the traffic implies; 0 stream syncs; the block invariant after idle."""
    out: dict = {"kernels": phase_prefix_kernels(torch, dev)}
    gc.collect()
    torch.cuda.empty_cache()
    traffic = prefix_traffic(cfg.vocab_size)
    prompts, greedy = traffic[1], traffic[3]
    n = len(prompts)
    # Every request but the last hits the system prompt's 32 blocks; the
    # last is the system prompt alone, whose last position is recomputed.
    want_hit = (n - 1) * PREFIX_SYSTEM + PREFIX_SYSTEM - 1
    bf16_pool = dict(kv_block=32, kv_pool_blocks=513)
    runs = {
        "a off": dict(**bf16_pool),
        "a on": dict(**bf16_pool, auto_prefix=True, prime=True),
        "b off": dict(kv_block=32, kv_quant="int8", kv_pool_blocks=513),
        "b on": dict(kv_block=32, kv_quant="int8", kv_pool_blocks=161, auto_prefix=True,
                     prefix_cache_blocks=64, prime=True),
        "c off": {},
        "c on": dict(prefix_slots=2, register=True),
        "d spec 2": dict(**bf16_pool, auto_prefix=True, prime=True, spec_tokens=2),
        "d prefill depth 3": dict(**bf16_pool, auto_prefix=True, prime=True, prefill_depth=3),
    }
    cold = {"a on": "a off", "b on": "b off", "c on": "c off", "d spec 2": "a off",
            "d prefill depth 3": "a off"}
    stats: dict = {}
    for name, kv in runs.items():
        stats[name] = serve_prefix(torch, dev, params, f"prefix {name}", traffic, **kv)
        if name in cold:
            check_streams(torch, cfg, params, f"prefix {name} against {cold[name]}", prompts,
                          stats[cold[name]]["streams"], stats[name]["streams"], greedy)
    for name in ("a on", "b on", "d spec 2", "d prefill depth 3"):
        st = stats[name]
        if st["lookups"] < n or st["hit_tokens"] != want_hit:
            fail(f"prefix {name}: {st['lookups']} lookups and {st['hit_tokens']} hit tokens; "
                 f"the traffic implies at least {n} and exactly {want_hit}")
    if stats["b on"]["evictions"] <= 0:
        fail("prefix b on: the 64-block cap evicted nothing")
    if stats["c on"]["pool_loads"] != n:
        fail(f"prefix c on: {stats['c on']['pool_loads']} prefix-pool loads for {n} requests")
    for name in ("a off", "b off", "c off"):
        if stats[name]["hit_tokens"] or stats[name]["pool_loads"]:
            fail(f"prefix {name}: the cache is off but served a hit")
    keys = ("tok_s", "ttft_p50_ms", "itl_p50_ms", "prefill_dispatches", "peak_blocks",
            "cached_blocks", "evictions", "lookups", "hit_tokens", "pool_loads")
    for off, on in (("a off", "a on"), ("b off", "b on"), ("c off", "c on"),
                    ("a off", "d spec 2"), ("a off", "d prefill depth 3")):
        log(f"prefix {off} -> {on}: " + json.dumps(
            {k: [stats[off].get(k), stats[on].get(k)] for k in keys}))
    out["runs"] = {k: {x: y for x, y in st.items() if x != "streams"} for k, st in stats.items()}
    return out


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


def _http_json(port: int, method: str, path: str, body=None, headers: dict | None = None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request(method, path, body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json", **(headers or {})})
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


# -- the data plane: config 4, offline batch inference over pub/sub ----------

PUBSUB_TOPICS = ("infer-requests-a", "infer-requests-b")
# The phase ends the run after this long (a hang costs this, not the limit).
PUBSUB_WATCHDOG_S = 240.0
PUBSUB_TRACE_MS = 200
PUBSUB_CLI_CHILD = r'''
import json, sys
from gofr_tpu_torch import new_cmd

app = new_cmd(config_dir=sys.argv[1])


@app.sub_command("^generate")
def generate(ctx):
    res = ctx.infer_sync(ctx.param("prompt"), max_new_tokens=int(ctx.param("n")),
                         temperature=0.0)
    return {"text": res["text"], "tokens": res["tokens"], "device": str(ctx.tpu.device)}


code = app.run(sys.argv[2:])
app.container.tpu.close()
sys.exit(code)
'''
PUBSUB_CLI_ENV = {"TPU_MODEL": "llama-tiny", "TPU_KV_SLOTS": "2", "TPU_MAX_LEN": "256",
                  "LOG_LEVEL": "WARN"}
PUBSUB_CLI_PROMPT = "the card answers a command"


class _Collector(threading.Thread):
    """A local zipkin collector: every POSTed batch's spans."""

    def __init__(self) -> None:
        super().__init__(daemon=True)
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        spans = self.spans = []

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                spans.extend(json.loads(body))
                self.send_response(202)
                self.end_headers()

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_port}/api/v2/spans"

    def run(self) -> None:
        self.server.serve_forever()

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()


def _wave(label: str, app, broker, prompts: list, first_id: int, during=None) -> dict:
    """Publish one message a prompt (alternating the two request topics),
    collect every answer from ``infer-responses`` through ``broker`` (the
    test side's client), and time each from its publish to its answer.
    ``during(eng)`` runs on this thread while the answers come in."""
    eng = app.container.tpu
    submitted = []
    submit = eng.submit_generate

    def spy(*args, **kw):
        req = submit(*args, **kw)
        submitted.append(req)
        return req

    eng.submit_generate = spy
    sent, got = {}, {}
    done = threading.Event()

    def consume():
        while len(got) < len(prompts):
            msg = broker.subscribe("infer-responses", timeout=0.05)
            if msg is None:
                continue
            t = time.perf_counter()
            msg.commit()
            got[json.loads(msg.value)["id"]] = (t, msg.value)
        done.set()

    consumer = threading.Thread(target=consume, name="pubsub-consumer", daemon=True)
    consumer.start()
    t0 = time.perf_counter()
    for i, ids in enumerate(prompts):
        sent[first_id + i] = time.perf_counter()
        broker.publish(PUBSUB_TOPICS[i % 2], json.dumps({"id": first_id + i, "ids": ids}).encode())
    extra = during(eng) if during is not None else None
    if not done.wait(300):
        fail(f"{label}: {len(got)} of {len(prompts)} answers arrived")
    wall = time.perf_counter() - t0
    del eng.submit_generate
    lat = sorted(got[i][0] - sent[i] for i in sent)
    answers = {i: json.loads(got[i][1]) for i in sent}
    service = [r.token_times[-1] - r.enqueued_at for r in submitted]  # a message's engine time
    tokens = sum(len(r.token_ids) for r in submitted)
    return {"answers": answers, "raw": {i: got[i][1] for i in sent}, "wall": wall,
            "msg_s": len(prompts) / wall, "tok_s": tokens / wall,
            "lat_p50_ms": statistics.median(lat) * 1e3,
            "lat_p99_ms": lat[min(len(lat) - 1, math.ceil(0.99 * len(lat)) - 1)] * 1e3,
            "service_p50_ms": statistics.median(service) * 1e3,
            "service_mean_ms": statistics.fmean(service) * 1e3,
            "engine_ttft_p50_ms": statistics.median(r.ttft_s for r in submitted) * 1e3,
            "engine_itl_p50_ms": statistics.median(
                (r.token_times[-1] - r.token_times[0]) / (len(r.token_times) - 1)
                for r in submitted if len(r.token_times) > 1) * 1e3,
            "max_in_flight": max(sum(1 for s in submitted if s.enqueued_at <= r.enqueued_at
                                     < s.token_times[-1]) for r in submitted),
            "extra": extra}


def _commits(port: int) -> dict:
    status, raw = _http_json(port, "GET", "/metrics")
    return {t: float(v) for t, v in re.findall(
        r'^app_pubsub_subscribe_success_count\{topic="([^"]+)"\} (\S+)$', raw.decode(), re.M)}


def phase_pubsub(torch, dev, base: list, base_stats: dict, *, model: str = "llama-3-8b",
                 lengths: tuple = LLAMA_PROMPTS[:8], geometry: dict | None = None) -> dict:
    """Config 4, offline batch inference over pub/sub (``examples/
    using-subscriber``), at full width on the card: the port's App from
    config (TPU_MODEL and phase_serve's geometry: the same seed-0 weights;
    PUBSUB_BACKEND=INPROC, DB_DIALECT=sqlite on a temp file, REDIS_HOST
    and REDIS_PORT on the port's MiniRedis, TRACE_EXPORTER=zipkin to a
    local collector), with migrate (a ``results`` table) and
    add_rest_handlers. One async handler subscribed to two request topics
    (one message in flight a topic, the reference's rule) takes each
    message's token ids through ``await ctx.infer(ids, max_new_tokens=32,
    temperature=0.0)``, writes the text into ``results`` and a Redis key
    and publishes ``{"id", "text"}`` to ``infer-responses``. The engine's
    tokenizer decodes ids as ``<id>`` (IdTokenizer: the byte tokenizer
    drops every id over 255). Checks: phase_serve's 8 greedy prompts give
    texts equal to the decode of ``base`` (32 tokens each, or fewer ending
    in EOS), in the
    published answer, the SQL row over ``GET /results/{id}`` and the Redis
    value; each message committed once; flash_cache_attention and
    flash_decode launched; during a second wave ``/debug/tpu-trace?ms=200``
    (its trace holding flash_decode launches inside traced graph
    launches), ``/debug/threads`` (the scheduler's stack),
    ``/debug/engine``, ``/debug/capacity`` and ``/debug/flight`` (501);
    idle after it, /debug/capacity's hbm equal to ``hbm_ledger()`` and
    /debug/engine to ``health_check()``; the collector holding a zipkin
    span (path and status tags) for each HTTP request before App.stop
    returns; the same prompts over PUBSUB_BACKEND=MQTT (the port's broker
    on 127.0.0.1, QoS 1) equal to ``base``; a new_cmd child process on
    llama-tiny whose ctx.infer_sync text equals a parent engine's. Prints
    messages/s, publish-to-answer latency p50/p99 and generated tok/s
    beside phase_serve's and the batch-1 bound. A watchdog ends the run
    after PUBSUB_WATCHDOG_S."""
    import asyncio
    import dataclasses
    import os
    import shutil
    import tempfile

    from gofr_tpu_torch import App
    from gofr_tpu_torch.config import MockConfig
    from gofr_tpu_torch.datasource.pubsub import MQTTClient
    from gofr_tpu_torch.datasource.redis import MiniRedis
    from gofr_tpu_torch.migration import Migrate
    from gofr_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from gofr_tpu_torch.serving.engine import InferenceEngine
    from gofr_tpu_torch.serving.profiler_capture import get_capture
    from gofr_tpu_torch.testutil.mqtt_broker import InProcMQTTBroker

    label = f"pubsub {model}"

    def watchdog():
        print(f"chip_smoke: FAIL: {label}: the phase did not end within "
              f"{PUBSUB_WATCHDOG_S:.0f} s", file=sys.stderr, flush=True)
        os._exit(1)

    timer = threading.Timer(PUBSUB_WATCHDOG_S, watchdog)
    timer.daemon = True
    timer.start()
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-pubsub-")
    # The CLI child first: it reaches the card while the App is built.
    cli_env = dict(PUBSUB_CLI_ENV, TPU_DEVICE=str(dev))
    with open(os.path.join(tmp, ".env"), "w") as fp:
        fp.write("".join(f"{k}={v}\n" for k, v in cli_env.items()))
    child = subprocess.Popen(
        [sys.executable, "-c", PUBSUB_CLI_CHILD, tmp, "generate",
         f"-prompt={PUBSUB_CLI_PROMPT}", "-n=16"],
        cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    geometry = geometry or {"TPU_KV_SLOTS": "8", "TPU_MAX_LEN": "2048",
                            "TPU_DECODE_WINDOW": "8", "TPU_PREFILL_CHUNK": "256",
                            "TPU_PREFILL_BATCH": "8"}
    mini = MiniRedis().start()
    collector = _Collector()
    collector.start()
    mqtt_broker = driver = None
    stops = []
    try:
        t0 = time.perf_counter()
        app, loop, stop = _app_harness({
            "APP_NAME": "chip-smoke-pubsub", "TPU_MODEL": model, "TPU_DEVICE": str(dev),
            **geometry, "PUBSUB_BACKEND": "INPROC", "DB_DIALECT": "sqlite",
            "DB_NAME": os.path.join(tmp, "results.db"), "REDIS_HOST": "127.0.0.1",
            "REDIS_PORT": str(mini.port), "TRACE_EXPORTER": "zipkin",
            "TRACER_URL": collector.url})
        stops.append(stop)
        eng = app.container.tpu
        eng.tokenizer = IdTokenizer()
        log(f"{label}: App built from config in {time.perf_counter() - t0:.1f} s (engine on "
            f"{eng.device}; pub/sub {type(app.container.pubsub).__name__}, SQL "
            f"{app.container.sql.dialect()}, Redis {app.container.redis.host}:"
            f"{app.container.redis.port}, tracer exporter "
            f"{type(app._tracer._exporter).__name__})")
        if eng.device.type != dev.type:
            fail(f"{label}: the App's engine is on {eng.device}, not {dev}")
        app.migrate({1: Migrate(up=lambda ds: ds.sql.exec(
            "CREATE TABLE results (id INTEGER PRIMARY KEY, text TEXT)"))})

        @dataclasses.dataclass
        class Results:
            id: int = 0
            text: str = ""

        app.add_rest_handlers(Results)

        async def handle(ctx):
            payload = ctx.request.json()
            res = await ctx.infer(payload["ids"], max_new_tokens=32, temperature=0.0)
            if ctx.sql is not None:
                ctx.sql.exec("INSERT INTO results (id, text) VALUES (?, ?)",
                             payload["id"], res["text"])
                ctx.redis.set(f"result:{payload['id']}", res["text"])
            ctx.publish("infer-responses",
                        json.dumps({"id": payload["id"], "text": res["text"]}).encode())

        for topic in PUBSUB_TOPICS:
            app.subscribe(topic, handle)
        asyncio.run_coroutine_threadsafe(app.start(), loop).result(timeout=120)
        broker = app.container.pubsub
        prompts = serve_prompts(eng.cfg.vocab_size, lengths, sampled=False)
        want = {i: eng.tokenizer.decode(base[i]) for i in range(len(prompts))}
        eos = eng.tokenizer.eos_id
        if any(len(b) != 32 and b[-1] != eos for b in base[:len(prompts)]):
            fail(f"{label}: phase_serve's greedy streams are not 32 tokens or EOS-ended")
        # Warm-up, off the record: one message through the whole path.
        eng.generate_sync([1, 2, 3], max_new_tokens=2, timeout=600)
        torch.cuda.synchronize()

        reset_launch_counts()
        w1 = _wave(label, app, broker, prompts, 0)
        counts = launch_counts()
        for k in ("flash_decode", "flash_cache_attention"):
            if counts[k] <= 0:
                fail(f"{label}: kernel {k} was not launched in the pub/sub phase")
        for i, text in want.items():
            if w1["answers"][i] != {"id": i, "text": text}:
                fail(f"{label}: published answer {i} differs from the decode of phase_serve's "
                     f"stream: {w1['raw'][i][:120]!r}")
            status, raw = _http_json(app.http_port, "GET", f"/results/{i}")
            row = json.loads(raw).get("data")
            if status != 200 or row != {"id": i, "text": text}:
                fail(f"{label}: GET /results/{i} gave {status} {raw[:120]!r}")
            if app.container.redis.get(f"result:{i}") != text:
                fail(f"{label}: the Redis value of result:{i} differs")

        # A second wave of the same prompts, with the debug routes hit
        # while it runs.
        def debug_reads(eng):
            w0 = eng.decode_windows
            while eng.decode_windows < w0 + 2:
                time.sleep(0.002)
            out = {path: _http_json(app.metrics_port, "GET", path) for path in (
                "/debug/threads", "/debug/engine", "/debug/capacity", "/debug/flight")}
            t = time.perf_counter()
            status, raw = _http_json(app.metrics_port, "GET",
                                     f"/debug/tpu-trace?ms={PUBSUB_TRACE_MS}")
            out["trace"] = (status, json.loads(raw), time.perf_counter() - t,
                            get_capture().trace_file)
            return out

        w2 = _wave(label, app, broker, prompts, len(prompts), during=debug_reads)
        for i, text in want.items():
            if w2["answers"][len(prompts) + i]["text"] != text:
                fail(f"{label}: the second wave's answer {i} differs")
        reads = w2["extra"]
        status, body, took, trace_file = reads["trace"]
        if status != 200 or body.get("captured_ms") != PUBSUB_TRACE_MS or took > 30:
            fail(f"{label}: /debug/tpu-trace?ms={PUBSUB_TRACE_MS} gave {status} {body} "
                 f"in {took:.1f} s")
        with open(trace_file) as fp:
            events = json.load(fp).get("traceEvents", [])
        graph_launches = {e.get("args", {}).get("correlation") for e in events
                          if e.get("name", "").startswith("cudaGraphLaunch")}
        flash = [e for e in events if e.get("cat") == "kernel"
                 and "flash_decode" in e.get("name", "")]
        replayed = [e for e in flash if e.get("args", {}).get("correlation") in graph_launches]
        if not replayed:
            fail(f"{label}: the /debug/tpu-trace trace holds no flash_decode inside a traced "
                 f"graph launch ({len(events)} events, {len(flash)} flash_decode)")
        status, raw = reads["/debug/threads"]
        stack = raw.decode().split(f"Thread {eng._thread.name} (ident {eng._thread.ident}):")
        if status != 200 or len(stack) < 2 or 'File "' not in stack[1].split("\nThread ")[0]:
            fail(f"{label}: /debug/threads does not list the scheduler thread's stack")
        for path, key in (("/debug/engine", lambda r: r["details"]["model"]),
                          ("/debug/capacity", lambda r: r["model"])):
            status, raw = reads[path]
            if status != 200 or key(json.loads(raw)["tpu"]) != model:
                fail(f"{label}: {path} during the wave gave {status} {raw[:200]!r}")
        status, raw = reads["/debug/flight"]
        if status != 501 or "ROADMAP Queue 1 item 7" not in json.loads(raw)["error"]:
            fail(f"{label}: /debug/flight gave {status} {raw[:200]!r}, not 501")
        # Idle: the reports equal the engine's own.
        hbm = json.loads(_http_json(app.metrics_port, "GET", "/debug/capacity")[1])["tpu"]["hbm"]
        if hbm != json.loads(json.dumps(eng.hbm_ledger())):
            fail(f"{label}: /debug/capacity's hbm differs from hbm_ledger(): {hbm} vs "
                 f"{eng.hbm_ledger()}")
        health = json.loads(_http_json(app.metrics_port, "GET", "/debug/engine")[1])["tpu"]
        if health != json.loads(json.dumps(eng.health_check())):
            fail(f"{label}: /debug/engine differs from health_check()")
        commits = _commits(app.metrics_port)
        per_topic = {t: commits.get(t) for t in PUBSUB_TOPICS}
        if per_topic != {t: float(len(prompts)) for t in PUBSUB_TOPICS}:
            fail(f"{label}: messages committed per topic {per_topic}, expected "
                 f"{len(prompts)} each (two waves of {len(prompts)} over two topics)")
        http_paths = [f"/results/{i}" for i in range(len(prompts))]
        # MQTT: the same prompts through PUBSUB_BACKEND=MQTT, on the same
        # engine (handed from the INPROC App to an MQTT App).
        app.container.tpu = None
        stop()
        stops.remove(stop)
        spans = list(collector.spans)
        for path in http_paths:
            if not any(s["tags"].get("http.target") == path
                       and s["tags"].get("http.status_code") == "200" for s in spans):
                fail(f"{label}: the collector holds no span of GET {path} with its status "
                     f"before App.stop returned ({len(spans)} spans)")
        mqtt_broker = InProcMQTTBroker()
        mqtt_app, mloop, mstop = _app_harness({
            "APP_NAME": "chip-smoke-mqtt", "PUBSUB_BACKEND": "MQTT", "MQTT_HOST": "127.0.0.1",
            "MQTT_PORT": str(mqtt_broker.port), "MQTT_CLIENT_ID": "chip-smoke-app",
            "MQTT_QOS": "1"})
        stops.append(mstop)
        mqtt_app.container.tpu = eng
        for topic in PUBSUB_TOPICS:
            mqtt_app.subscribe(topic, handle)
        driver = MQTTClient(host="127.0.0.1", port=mqtt_broker.port, client_id="chip-smoke-driver")
        driver.subscribe("infer-responses", timeout=0.01)
        for topic in PUBSUB_TOPICS:  # subscribed before the first publish
            mqtt_app.container.pubsub.subscribe(topic, timeout=0.01)
        asyncio.run_coroutine_threadsafe(mqtt_app.start(), mloop).result(timeout=120)
        reset_launch_counts()
        w3 = _wave(label + " mqtt", mqtt_app, driver, prompts, 0)
        mqtt_counts = launch_counts()
        for i, text in want.items():
            if w3["answers"][i] != {"id": i, "text": text}:
                fail(f"{label}: the MQTT answer {i} differs from the decode of phase_serve's "
                     "stream")
        mcommits = _commits(mqtt_app.metrics_port)
        if {t: mcommits.get(t) for t in PUBSUB_TOPICS} != {
                t: float(len(prompts) // 2) for t in PUBSUB_TOPICS}:
            fail(f"{label}: MQTT messages committed per topic {mcommits}")
        mstop()
        stops.remove(mstop)

        # The CLI child against an engine built here from the same config.
        cli_out, cli_err = child.communicate(timeout=120)
        lines = [ln for ln in cli_out.splitlines() if ln.startswith("{")]
        if child.returncode != 0 or not lines:
            fail(f"{label}: the new_cmd child exited {child.returncode}: {cli_err[-2000:]}")
        cli = json.loads(lines[-1])
        ref = InferenceEngine.from_config(MockConfig(cli_env))
        try:
            want_cli = ref.generate_sync(PUBSUB_CLI_PROMPT, max_new_tokens=16,
                                         temperature=0.0, timeout=600)
        finally:
            ref.close()
        if (cli["text"], cli["tokens"]) != (want_cli.text, len(want_cli.token_ids)) or \
                not cli["device"].startswith(dev.type):
            fail(f"{label}: the new_cmd child's answer {cli} differs from the parent's "
                 f"{want_cli.text!r} ({len(want_cli.token_ids)} tokens)")
        # One message in flight a topic: a topic's messages run one after
        # another, so messages/s cannot pass n_topics / the mean engine time.
        bound = len(PUBSUB_TOPICS) / (w1["service_mean_ms"] / 1e3)
        stats = {k: w1[k] for k in ("msg_s", "tok_s", "lat_p50_ms", "lat_p99_ms",
                                    "service_p50_ms", "service_mean_ms", "engine_ttft_p50_ms",
                                    "engine_itl_p50_ms", "max_in_flight", "wall")}
        stats.update(bound_msg_s=bound,
                     mqtt={k: w3[k] for k in ("msg_s", "tok_s", "lat_p50_ms", "lat_p99_ms")},
                     trace_flash_decode_replayed=len(replayed), trace_s=took,
                     spans=len(spans), cli=cli, phase_s=time.perf_counter() - t_phase)
        log(f"{label}: launch counts over the INPROC wave: {counts}; over the MQTT wave: "
            f"{mqtt_counts}")
        log(f"{label}: every check passed: {len(prompts)} answers equal to the decode of "
            f"phase_serve's streams ({[len(b) for b in base[:len(prompts)]]} tokens) through "
            f"the publisher, SQL over GET "
            f"/results/{{id}} and Redis; commits {per_topic} over two waves; /debug/tpu-trace "
            f"?ms={PUBSUB_TRACE_MS} 200 in {took:.2f} s with {len(replayed)} flash_decode "
            f"inside traced graph launches; /debug/threads, /debug/engine, /debug/capacity "
            f"(hbm == hbm_ledger()), /debug/flight 501; {len(spans)} zipkin spans, one for "
            f"each GET /results/{{id}}; MQTT QoS 1 answers equal; the new_cmd child's text "
            f"equal to the parent's ({cli['tokens']} tokens on {cli['device']})")
        log(f"{label}: {len(prompts)} messages over {len(PUBSUB_TOPICS)} topics (one in flight "
            f"a topic; at most {w1['max_in_flight']} in the engine at once) in "
            f"{w1['wall']:.3f} s: {w1['msg_s']:.2f} messages/s, {w1['tok_s']:.1f} generated "
            f"tok/s, publish-to-answer latency p50 {w1['lat_p50_ms']:.1f} ms p99 "
            f"{w1['lat_p99_ms']:.1f} ms; engine TTFT p50 {w1['engine_ttft_p50_ms']:.1f} ms, "
            f"ITL p50 {w1['engine_itl_p50_ms']:.2f} ms, a message's engine time p50 "
            f"{w1['service_p50_ms']:.1f} ms (mean {w1['service_mean_ms']:.1f}); bound "
            f"n_topics / mean engine time = "
            f"{bound:.2f} messages/s; phase_serve (10 requests at once): "
            f"{base_stats['tok_s']:.1f} tok/s, TTFT p50 {base_stats['ttft_p50_ms']:.1f} ms, "
            f"ITL p50 {base_stats['itl_p50_ms']:.2f} ms")
        log(f"{label}: MQTT wave: {w3['msg_s']:.2f} messages/s, {w3['tok_s']:.1f} tok/s, "
            f"latency p50 {w3['lat_p50_ms']:.1f} ms p99 {w3['lat_p99_ms']:.1f} ms; "
            f"phase {stats['phase_s']:.1f} s")
        return {"counts": counts, "mqtt_counts": mqtt_counts, "stats": stats}
    finally:
        timer.cancel()
        for stop_fn in stops:
            stop_fn()
        if driver is not None:
            driver.close()
        if mqtt_broker is not None:
            mqtt_broker.close()
        if child.poll() is None:
            child.kill()
            child.wait()
        collector.close()
        mini.stop()
        shutil.rmtree(tmp, ignore_errors=True)


# -- gRPC (configs 5 and 3) and service to service -----------------------------

# The phase ends the run after this long (a hang in the HTTP/2 code costs
# this, not the run's limit). So the llama RPCs that must succeed carry no
# gRPC deadline: a deadline reaches the engine's admission control, which
# sheds a request whose projected queue wait (from the engine's first
# throughput samples) passes it.
GRPC_WATCHDOG_S = 240.0
# The deadline leg: a budget of tokens that one stream takes seconds to make
# on the card (~10 ms a token), under a deadline that passes mid-decode.
GRPC_DEADLINE_S = 0.5
GRPC_DEADLINE_BUDGET = 500
# A BERT-base vector over gRPC against the same engine's embed of the text
# alone (a batch of one, so another padded shape and another GEMM): max
# |d| on unit-norm bf16 vectors, whose elements are ~0.036 in size. The
# sound reading was 0.000942 on an H100 80GB HBM3 at 700 W; the phase
# prints two planted faults beside it (the pads of a flush unmasked,
# another row's vector) and fails unless the limit tells both apart.
# Against the vector the engine computed for the text in its own flush
# the check is exact.
GRPC_EMBED_ALONE_TOL = 3e-3
GRPC_GATEWAY_PROMPTS = 3
SEQ2SEQ_GRPC_PROMPTS = ("translate English to German: the card answers over gRPC",
                        "summarize: a stream of chunks", "q: why HTTP/2?")


def _stream_rpc(stub, pb, prompt: list, max_new: int, out: dict, key: int) -> None:
    """One typed GenerateStream: (arrival time, chunk) for every chunk, the
    submit time and any error, under ``out[key]``."""
    rec = out[key] = {"chunks": [], "error": None}
    try:
        rec["t_submit"] = time.perf_counter()
        for chunk in stub.GenerateStream(pb.GenerateRequest(
                prompt_ids=prompt, max_new_tokens=max_new, stop_on_eos=True)):
            rec["chunks"].append((time.perf_counter(), chunk))
    except Exception as exc:  # reported by the phase as a failed check
        rec["error"] = exc


def _slots_free(eng, label: str, what: str, timeout: float = 30.0) -> None:
    deadline = time.time() + timeout
    while any(s is not None for s in eng._slots) and time.time() < deadline:
        time.sleep(0.02)
    if any(s is not None for s in eng._slots):
        fail(f"{label}: {what}: a slot is still held {timeout:.0f} s later")


def phase_grpc(torch, dev, base: list, base_stats: dict, http_stats: dict, *,
               model: str = "llama-3-8b", lengths: tuple = LLAMA_PROMPTS,
               geometry: dict | None = None, bert: str = "bert-base",
               t5: str = "flan-t5-small") -> dict:
    """gRPC on the port's own wire code, at full width, and the service
    client, under a GRPC_WATCHDOG_S watchdog. Config 5: the App from config
    (TPU_MODEL and phase_serve's geometry: the same seed-0 weights;
    GRPC_PORT=0; TRACE_EXPORTER=zipkin to a local collector) with the typed
    and the JSON inference services registered as examples/grpc-server
    does, add_openai_routes, and the IdTokenizer (every id a piece). Over
    one connection of the port's channel, phase_serve's 10 prompts as
    concurrent typed GenerateStream RPCs (greedy, 32 tokens: phase_serve's
    8 greedy streams equal token for token, its repeated prompt's two
    streams equal to each other), with no stream synchronization; a typed
    Generate whose text equals the concatenated stream; a JSON Generate
    through InferenceClient equal to it; Health; a stream cancelled after
    its first chunk (its request cancelled, every slot free); a
    GRPC_DEADLINE_S deadline that expires mid-decode (admitted, tokens
    streamed, DEADLINE_EXCEEDED, every slot free); flash_decode and
    flash_cache_attention launched. A gateway App with add_http_service
    ("llm", RetryConfig, CircuitBreakerConfig) forwards 3 prompts through
    ctx.http_service("llm").post("/v1/completions"): each answer equal to
    the direct one, service:llm UP in the gateway's health, and the
    collector holding the gateway's, the client's and the upstream's
    spans under one trace id each. Config 3: BERT-base from config behind
    the batcher with the typed service, 64 concurrent Embed RPCs over one
    connection, each vector equal to the one the engine computed for its
    text in its flush and within GRPC_EMBED_ALONE_TOL of the engine's embed
    of the text alone. Seq2seq: flan-t5-small from config with the typed
    service, GenerateStream's ids (parsed from the IdTokenizer's pieces)
    equal to the one-shot program's. Prints tok/s, TTFT p50 and ITL p50
    over gRPC beside phase_serve's and phase_http's, and Embed req/s,
    p50/p99 and flush sizes."""
    import asyncio
    import os

    import numpy as np

    from gofr_tpu_torch.errors import ErrorDeadlineExceeded
    from gofr_tpu_torch.grpc import (
        InferenceClient,
        TypedInferenceServicer,
        add_inference_service,
        add_typed_inference_service,
        inference_pb2,
        insecure_channel,
    )
    from gofr_tpu_torch.grpc.inference import InferenceServicer
    from gofr_tpu_torch.grpc.inference_pb2_grpc import InferenceStub
    from gofr_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from gofr_tpu_torch.serving.batcher import pad_bucket
    from gofr_tpu_torch.serving.openai_compat import add_openai_routes
    from gofr_tpu_torch.serving.types import _PREFILL_BUCKETS
    from gofr_tpu_torch.service import CircuitBreakerConfig, RetryConfig

    label = f"grpc {model}"

    def watchdog():
        print(f"chip_smoke: FAIL: {label}: the phase did not end within "
              f"{GRPC_WATCHDOG_S:.0f} s", file=sys.stderr, flush=True)
        os._exit(1)

    timer = threading.Timer(GRPC_WATCHDOG_S, watchdog)
    timer.daemon = True
    timer.start()
    t_phase = time.perf_counter()
    pb = inference_pb2
    geometry = geometry or {"TPU_KV_SLOTS": "8", "TPU_MAX_LEN": "2048",
                            "TPU_DECODE_WINDOW": "8", "TPU_PREFILL_CHUNK": "256",
                            "TPU_PREFILL_BATCH": "8"}
    collector = _Collector()
    collector.start()
    stops = []
    out: dict = {}
    try:
        # -- config 5 ------------------------------------------------------------
        t0 = time.perf_counter()
        app, loop, stop = _app_harness({
            "APP_NAME": "chip-smoke-grpc", "TPU_MODEL": model, "TPU_DEVICE": str(dev),
            **geometry, "GRPC_PORT": "0", "TRACE_EXPORTER": "zipkin",
            "TRACER_URL": collector.url})
        stops.append(stop)
        eng = app.container.tpu
        eng.tokenizer = IdTokenizer()
        add_openai_routes(app)
        app.register_service(add_typed_inference_service, TypedInferenceServicer(eng))
        app.register_service(add_inference_service, InferenceServicer(eng))
        asyncio.run_coroutine_threadsafe(app.start(), loop).result(timeout=120)
        if eng.device.type != dev.type:
            fail(f"{label}: the App's engine is on {eng.device}, not {dev}")
        log(f"{label}: App built from config and started in {time.perf_counter() - t0:.1f} s; "
            f"gRPC on :{app.grpc_port}, HTTP on :{app.http_port}")
        addr = f"127.0.0.1:{app.grpc_port}"
        channel = insecure_channel(addr)
        stub = InferenceStub(channel)
        stub.Generate(pb.GenerateRequest(prompt_ids=[1, 2, 3], max_new_tokens=2))  # warm-up
        if dev.type == "cuda":
            torch.cuda.synchronize()
        prompts = serve_prompts(eng.cfg.vocab_size, lengths, sampled=True)
        n = len(prompts)
        submitted = []
        submit = eng.submit_generate

        def spy(*args, **kw):
            req = submit(*args, **kw)
            submitted.append(req)
            return req

        eng.submit_generate = spy
        steps = watch_steps(eng)
        reset_launch_counts()
        count_syncs(torch, True)
        recs: dict = {}
        threads = [threading.Thread(target=_stream_rpc, args=(stub, pb, p, 32, recs, i),
                                    daemon=True) for i, p in enumerate(prompts)]
        t_run = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t_run
        syncs = count_syncs(torch, False)
        unwatch_steps(eng)
        wave_counts = launch_counts()
        if len(app._grpc_server._conns) != 1:
            fail(f"{label}: the 10 streams came over {len(app._grpc_server._conns)} "
                 "connections, not one")
        streams, texts = [], []
        for i in range(n):
            rec = recs.get(i, {})
            if rec.get("error") is not None or not rec.get("chunks"):
                fail(f"{label}: stream {i}: {rec.get('error')!r}")
            chunks = [c for _, c in rec["chunks"]]
            if not chunks[-1].done or any(c.done for c in chunks[:-1]):
                fail(f"{label}: stream {i} did not end with one done chunk")
            streams.append([c.token for c in chunks[:-1]])
            texts.append("".join(c.text for c in chunks[:-1]))
            if chunks[-1].tokens != len(streams[-1]):
                fail(f"{label}: stream {i}: the final chunk counts {chunks[-1].tokens} tokens, "
                     f"{len(streams[-1])} came")
        for i in range(n - 2):
            if streams[i] != base[i]:
                fail(f"{label}: greedy stream {i} over gRPC differs from phase_serve's: "
                     f"{streams[i][:8]} vs {base[i][:8]}")
        if streams[n - 2] != streams[n - 1]:
            fail(f"{label}: the repeated prompt's two greedy streams differ")
        if syncs:
            fail(f"{label}: {syncs} stream synchronizations during the gRPC streams; the first "
                 "at\n" + "\n".join(SYNCS["first"]))
        arrivals = [[t for t, c in recs[i]["chunks"][:-1]] for i in range(n)]
        ttfts = sorted(a[0] - recs[i]["t_submit"] for i, a in enumerate(arrivals))
        itls = [(a[-1] - a[0]) / (len(a) - 1) for a in arrivals if len(a) > 1]
        stats = {"tok_s": sum(len(s) for s in streams) / wall,
                 "ttft_p50_ms": statistics.median(ttfts) * 1e3, "ttft_max_ms": ttfts[-1] * 1e3,
                 "itl_p50_ms": statistics.median(itls) * 1e3,
                 "engine_ttft_p50_ms": statistics.median(r.ttft_s for r in submitted) * 1e3,
                 "syncs": syncs}
        del eng.submit_generate
        # Unary: the text of prompt 0's stream; JSON through InferenceClient.
        unary = stub.Generate(pb.GenerateRequest(prompt_ids=prompts[0], max_new_tokens=32,
                                                 stop_on_eos=True))
        if unary.text != texts[0] or unary.tokens != len(streams[0]):
            fail(f"{label}: unary Generate {unary.text[:60]!r} ({unary.tokens} tokens) differs "
                 f"from the stream {texts[0][:60]!r} ({len(streams[0])})")
        client = InferenceClient(addr)
        try:
            js = client.generate(prompts[0], max_new_tokens=32)
        finally:
            client.close()
        if js["text"] != unary.text or js["tokens"] != unary.tokens:
            fail(f"{label}: the JSON Generate differs from the typed one: {js}")
        health = stub.Health(pb.HealthRequest(), timeout=60)
        if health.status != "UP":
            fail(f"{label}: Health {health.status}")
        # A cancelled stream: its request cancelled, every slot free.
        submitted.clear()
        eng.submit_generate = spy
        call = stub.GenerateStream(pb.GenerateRequest(prompt_ids=prompts[1], max_new_tokens=1500,
                                                      stop_on_eos=False))
        next(iter(call))
        del eng.submit_generate
        victim = submitted[0]
        call.cancel()
        deadline = time.time() + 30
        while not victim.future.done() and time.time() < deadline:
            time.sleep(0.02)
        if not victim.future.cancelled() or len(victim.token_ids) >= 1500:
            fail(f"{label}: the cancelled stream's request was not cancelled "
                 f"({len(victim.token_ids)} tokens)")
        _slots_free(eng, label, "after the cancel")
        # A deadline that expires mid-decode: the request admitted, a slot
        # held and tokens streamed, then DEADLINE_EXCEEDED and every slot
        # free. The engine's measured rate would project the whole budget
        # past the deadline and shed the request at admission, so the leg
        # sets an optimistic throughput prior (what TPU_EXPECTED_TPS sets).
        submitted.clear()
        eng.submit_generate = spy
        prior, eng._expected_tps = eng._expected_tps, 1e5
        dl_chunks = []
        try:
            for chunk in stub.GenerateStream(pb.GenerateRequest(
                    prompt_ids=prompts[6], max_new_tokens=GRPC_DEADLINE_BUDGET,
                    stop_on_eos=False), timeout=GRPC_DEADLINE_S):
                dl_chunks.append(chunk)
            fail(f"{label}: a {GRPC_DEADLINE_S} s deadline did not end the stream")
        except Exception as exc:  # noqa: BLE001 — the status is the check
            code = getattr(exc, "code", lambda: None)()
            if code is None or code.name != "DEADLINE_EXCEEDED":
                raise
        finally:
            eng._expected_tps = prior
            del eng.submit_generate
        if len(submitted) != 1:
            fail(f"{label}: the {GRPC_DEADLINE_S} s deadline's request was shed at admission")
        dl_req = submitted[0]
        deadline = time.time() + 30
        while not dl_req.future.done() and time.time() < deadline:
            time.sleep(0.02)
        if not dl_chunks or not 1 <= len(dl_req.token_ids) < GRPC_DEADLINE_BUDGET:
            fail(f"{label}: the {GRPC_DEADLINE_S} s deadline did not end the request mid-decode: "
                 f"{len(dl_chunks)} chunks streamed, {len(dl_req.token_ids)} of "
                 f"{GRPC_DEADLINE_BUDGET} tokens")
        if dl_req.future.cancelled():
            dl_end = "the handler cancelled it"
        elif isinstance(dl_req.future.exception(), ErrorDeadlineExceeded):
            dl_end = "the engine's deadline reaped it"
        else:
            fail(f"{label}: the deadline's request ended otherwise: {dl_req.future!r}")
        _slots_free(eng, label, "after the deadline")
        counts = launch_counts()
        for k in ("flash_decode", "flash_cache_attention"):
            if wave_counts[k] <= 0:
                fail(f"{label}: kernel {k} was not launched by the gRPC streams")
        channel.close()
        log(f"{label}: every check passed: {n - 2} greedy streams equal phase_serve's and the "
            f"repeated prompt's two equal, over one connection, {syncs} stream syncs; unary "
            f"text = the stream ({unary.tokens} tokens), JSON Generate = typed; Health "
            f"{health.status}; cancel after the first chunk: request cancelled after "
            f"{len(victim.token_ids)} tokens, slots free; {GRPC_DEADLINE_S} s deadline: "
            f"admitted, {len(dl_chunks)} chunks streamed and {len(dl_req.token_ids)} of "
            f"{GRPC_DEADLINE_BUDGET} tokens made, DEADLINE_EXCEEDED, {dl_end}, slots free")
        log(f"{label}: launch counts over the 10 streams {wave_counts}, over the config-5 legs "
            f"{counts}; {steps_line(steps)}")
        log(f"{label}: {n} GenerateStream RPCs in {wall:.3f} s: {stats['tok_s']:.1f} generated "
            f"tok/s, TTFT p50 {stats['ttft_p50_ms']:.1f} ms (max {stats['ttft_max_ms']:.1f}), "
            f"ITL p50 {stats['itl_p50_ms']:.2f} ms (client clock; engine TTFT p50 "
            f"{stats['engine_ttft_p50_ms']:.1f} ms); over HTTP (phase_http): "
            f"{http_stats['tok_s']:.1f} tok/s, TTFT p50 {http_stats['ttft_p50_ms']:.1f} ms, "
            f"ITL p50 {http_stats['itl_p50_ms']:.2f} ms; the direct engine (phase_serve): "
            f"{base_stats['tok_s']:.1f} tok/s, TTFT p50 {base_stats['ttft_p50_ms']:.1f} ms, "
            f"ITL p50 {base_stats['itl_p50_ms']:.2f} ms")
        out.update(counts=counts, wave_counts=wave_counts, stats=stats)

        # -- service to service: a gateway App in front of config 5's ----------
        gw, gloop, gstop = _app_harness({
            "APP_NAME": "chip-smoke-gateway", "TRACE_EXPORTER": "zipkin",
            "TRACER_URL": collector.url})
        stops.append(gstop)
        gw.add_http_service("llm", f"http://127.0.0.1:{app.http_port}",
                            RetryConfig(max_retries=2, backoff_s=0.05),
                            CircuitBreakerConfig(threshold=5, interval_s=10))

        @gw.post("/ask")
        def ask(ctx):
            body = ctx.request.json()
            resp = ctx.http_service("llm").post("/v1/completions", json={
                "prompt": body["prompt"], "max_tokens": 16, "temperature": 0})
            return {"status": resp.status_code, "text": resp.json()["choices"][0]["text"]}

        asyncio.run_coroutine_threadsafe(gw.start(), gloop).result(timeout=60)
        answers = []
        for p in prompts[:GRPC_GATEWAY_PROMPTS]:
            status, raw = _http_json(gw.http_port, "POST", "/ask", {"prompt": p})
            got = json.loads(raw)["data"] if status == 201 else {}
            status_d, raw_d = _http_json(app.http_port, "POST", "/v1/completions", {
                "prompt": p, "max_tokens": 16, "temperature": 0})
            direct = json.loads(raw_d)["choices"][0]["text"] if status_d == 200 else None
            if got.get("status") != 200 or got.get("text") != direct:
                fail(f"{label}: gateway answer {status} {raw[:120]!r} differs from the direct "
                     f"{status_d} {direct!r}")
            answers.append(got["text"])
        status, raw = _http_json(gw.http_port, "GET", "/.well-known/health")
        svc_health = json.loads(raw)["data"]["details"].get("service:llm", {})
        if svc_health.get("status") != "UP":
            fail(f"{label}: the gateway's health shows service:llm {svc_health}")
        deadline = time.time() + 20
        traces = []
        while time.time() < deadline:
            spans = list(collector.spans)
            gw_spans = [s for s in spans if s["name"].startswith("POST /ask")]
            traces = []
            for g in gw_spans:
                same = [s for s in spans if s["traceId"] == g["traceId"]]
                names = {s["localEndpoint"]["serviceName"]: s["name"] for s in same}
                if any(s["name"].startswith("http-service POST") for s in same) and any(
                        s["localEndpoint"]["serviceName"] == "chip-smoke-grpc"
                        and s["name"].startswith("POST /v1/completions") for s in same):
                    traces.append((g["traceId"], names))
            if len(traces) >= GRPC_GATEWAY_PROMPTS:
                break
            time.sleep(0.2)
        if len(traces) < GRPC_GATEWAY_PROMPTS:
            fail(f"{label}: the collector holds {len(traces)} of {GRPC_GATEWAY_PROMPTS} traces "
                 "with the gateway's, the client's and the upstream's spans under one id")
        gstop()
        stops.remove(gstop)
        log(f"{label}: gateway: {GRPC_GATEWAY_PROMPTS} prompts through ctx.http_service('llm')"
            f" equal to the direct answers; service:llm UP; one trace id each across "
            f"{sorted(traces[0][1].items())}")
        stop()
        stops.remove(stop)
        if any(s is not None for s in eng._slots) or eng.state != "DOWN":
            fail(f"{label}: after App.stop a slot is still held or the engine is {eng.state}")
        del eng, app, stop, submit
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        # -- config 3: BERT-base embeddings over gRPC unary ----------------------
        elabel = f"grpc {bert}"
        t0 = time.perf_counter()
        bapp, bloop, bstop = _app_harness({
            "APP_NAME": "chip-smoke-grpc-embed", "TPU_MODEL": bert, "TPU_DEVICE": str(dev),
            "TPU_MAX_BATCH": str(ENC_MAX_BATCH), "TPU_BATCH_WAIT_MS": str(ENC_WAIT_MS),
            "GRPC_PORT": "0"})
        stops.append(bstop)
        emb = bapp.container.tpu
        bapp.register_service(add_typed_inference_service, TypedInferenceServicer(emb))
        asyncio.run_coroutine_threadsafe(bapp.start(), bloop).result(timeout=120)
        log(f"{elabel}: App built from config and started in {time.perf_counter() - t0:.1f} s")
        bchannel = insecure_channel(f"127.0.0.1:{bapp.grpc_port}")
        bstub = InferenceStub(bchannel)
        rng = np.random.default_rng(3)
        words = np.array(list("abcdefghijklmnopqrstuvwxyz     "))
        etexts = ["".join(rng.choice(words, m)) for m in rng.integers(8, 501, ENC_REQUESTS)]
        bstub.Embed(pb.EmbedRequest(text=etexts[0]), timeout=120)  # warm
        flushes = _record_flushes(emb)
        res, lat, ewall = _fan_out(lambda t: np.asarray(
            bstub.Embed(pb.EmbedRequest(text=t), timeout=120).embedding, np.float32), etexts)
        flushes = list(flushes)  # the wave's, not the alone calls' below
        if len(bapp._grpc_server._conns) != 1:
            fail(f"{elabel}: the Embed RPCs came over {len(bapp._grpc_server._conns)} "
                 "connections, not one")
        own = {t: np.asarray(r, np.float32) for payloads, results in flushes
               for t, r in zip(payloads, results)}
        worst_alone = 0.0
        for text, vec in zip(etexts, res):
            if text not in own or not np.array_equal(vec, own[text]):
                fail(f"{elabel}: an Embed reply differs from the engine's vector for its text")
            alone = np.asarray(emb.embed_sync(text), np.float32)
            worst_alone = max(worst_alone, float(np.abs(vec - alone).max()))
        # Planted faults the limit must catch: each of the 8 shortest texts
        # padded to the wave's widest bucket with its pads unmasked, and
        # each reply against the next text's vector (a wrong row of a flush).
        width = min(pad_bucket(max(len(emb.tokenizer.encode(t)) for t in etexts),
                               _PREFILL_BUCKETS), emb.max_len)
        unmasked = float("inf")
        for text in sorted(etexts, key=len)[:8]:
            ids = emb.tokenizer.encode(text)[:width]
            row = torch.zeros((1, width), dtype=torch.int64)
            row[0, :len(ids)] = torch.tensor(ids)
            with torch.inference_mode():
                bad = emb._embed_step(emb.params, row.to(emb.device),
                                      torch.ones_like(row).to(emb.device)).float().cpu().numpy()[0]
            alone = np.asarray(emb.embed_sync(text), np.float32)
            unmasked = min(unmasked, float(np.abs(bad - alone).max()))
        wrong_row = min(float(np.abs(res[i] - res[(i + 1) % len(res)]).max())
                        for i in range(len(res)))
        out["embed"] = _serve_line(
            f"{elabel}, config 3, {ENC_REQUESTS} concurrent Embed RPCs over one connection "
            "(client clock)", lat, ewall, flushes,
            f"; each reply equal to its flush's vector bit for bit, max|d| {worst_alone:.3g} "
            f"from the text embedded alone (limit {GRPC_EMBED_ALONE_TOL}); planted faults, the "
            f"least max|d| of each: pads unmasked to {width} {unmasked:.3g}, another row's "
            f"vector {wrong_row:.3g}")
        out["embed"].update(alone_max_abs=worst_alone, fault_unmasked=unmasked,
                            fault_wrong_row=wrong_row)
        if worst_alone > GRPC_EMBED_ALONE_TOL:
            fail(f"{elabel}: an Embed reply is {worst_alone:.3g} from the text embedded alone")
        if min(unmasked, wrong_row) <= GRPC_EMBED_ALONE_TOL:
            fail(f"{elabel}: the limit {GRPC_EMBED_ALONE_TOL} does not tell a planted fault "
                 f"from a sound reply (unmasked pads {unmasked:.3g}, wrong row {wrong_row:.3g})")
        if max(len(p) for p, _ in flushes) < 2:
            fail(f"{elabel}: the batcher coalesced nothing")
        bchannel.close()
        bstop()
        stops.remove(bstop)
        del emb, bapp, bstop, flushes
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        # -- seq2seq over gRPC: the first surface on stream_seq2seq --------------
        slabel = f"grpc {t5}"
        tapp, tloop, tstop = _app_harness({
            "APP_NAME": "chip-smoke-grpc-t5", "TPU_MODEL": t5, "TPU_DEVICE": str(dev),
            "GRPC_PORT": "0"})
        stops.append(tstop)
        teng = tapp.container.tpu
        teng.tokenizer = IdTokenizer()
        tapp.register_service(add_typed_inference_service, TypedInferenceServicer(teng))
        asyncio.run_coroutine_threadsafe(tapp.start(), tloop).result(timeout=120)
        tchannel = insecure_channel(f"127.0.0.1:{tapp.grpc_port}")
        tstub = InferenceStub(tchannel)
        n_chunks = []
        for text in SEQ2SEQ_GRPC_PROMPTS:
            ids = list(text.encode())
            want = teng.seq2seq_sync(ids)
            chunks = list(tstub.GenerateStream(pb.GenerateRequest(prompt_ids=ids), timeout=120))
            got = [int(x) for x in re.findall(r"<(\d+)>", "".join(c.text for c in chunks[:-1]))]
            if got != want or chunks[-1].tokens != len(want) or not chunks[-1].done:
                fail(f"{slabel}: GenerateStream's ids {got[:8]} ({chunks[-1].tokens}) differ "
                     f"from the one-shot program's {want[:8]} ({len(want)})")
            n_chunks.append(len(chunks) - 1)
        tchannel.close()
        log(f"{slabel}: {len(SEQ2SEQ_GRPC_PROMPTS)} GenerateStream RPCs through "
            f"stream_seq2seq, each one's ids equal to the one-shot program's "
            f"({n_chunks} content chunks)")
        tstop()
        stops.remove(tstop)
        del teng, tapp, tstop
        gc.collect()
        log(f"{label}: phase took {time.perf_counter() - t_phase:.1f} s")
        return out
    finally:
        timer.cancel()
        for s in reversed(stops):
            s()
        collector.close()


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


# Shards of the HF checkpoint phase_loader writes (HF's own default).
SHARD_BYTES = 5 * 10**9
_SAFETENSORS_DTYPES = {"bfloat16": "BF16", "float16": "F16", "float32": "F32",
                       "float64": "F64", "int64": "I64", "int32": "I32", "int16": "I16",
                       "int8": "I8", "uint8": "U8", "bool": "BOOL"}


def write_safetensors(path: str, tensors: dict) -> int:
    """Write ``tensors`` (name → torch tensor, on any device) as one
    .safetensors file: an 8-byte little-endian header length, the JSON
    header (dtype, shape, data_offsets per tensor; padded with spaces to a
    multiple of 8 bytes), then each tensor's bytes in order. Returns the
    bytes written."""
    import struct

    import torch

    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _SAFETENSORS_DTYPES[str(t.dtype).split(".")[-1]],
                        "shape": list(t.shape), "data_offsets": [offset, offset + n]}
        offset += n
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for t in tensors.values():
            if t.numel():
                f.write(memoryview(t.detach().contiguous().cpu().reshape(-1)
                                   .view(torch.uint8).numpy()))
    return 8 + len(text) + offset


def hf_llama_tensors(params: dict, cfg):
    """The port's plain Llama-layout params as HF's LlamaForCausalLM names
    them, ``[out, in]``: (name, tensor) pairs, one layer at a time."""
    H, KV, hd, F = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    yield "model.embed_tokens.weight", params["embed"]
    for i in range(cfg.n_layers):
        pre = f"model.layers.{i}."
        q, k, v = params["wqkv"][i].split([H * hd, KV * hd, KV * hd], dim=-1)
        gate, up = params["w_gate_up"][i].split([F, F], dim=-1)
        yield pre + "input_layernorm.weight", params["attn_norm"][i]
        for name, w in (("self_attn.q_proj", q), ("self_attn.k_proj", k),
                        ("self_attn.v_proj", v), ("self_attn.o_proj", params["wo"][i]),
                        ("mlp.gate_proj", gate), ("mlp.up_proj", up),
                        ("mlp.down_proj", params["w_down"][i])):
            yield pre + name + ".weight", w.t()
        yield pre + "post_attention_layernorm.weight", params["mlp_norm"][i]
    yield "model.norm.weight", params["final_norm"]
    yield "lm_head.weight", params["lm_head"].t()


def write_hf_checkpoint(path: str, params: dict, cfg, shard_bytes: int = SHARD_BYTES) -> int:
    """An HF Llama checkpoint directory of ``params``: config.json,
    safetensors shards of at most ``shard_bytes`` (a tensor larger than
    that gets a shard of its own) written with ``write_safetensors``, and
    their index. Returns the bytes of the shards."""
    import os

    cfg_json = {"model_type": "llama", "architectures": ["LlamaForCausalLM"],
                "vocab_size": cfg.vocab_size, "hidden_size": cfg.d_model,
                "intermediate_size": cfg.d_ff, "num_hidden_layers": cfg.n_layers,
                "num_attention_heads": cfg.n_heads, "num_key_value_heads": cfg.n_kv_heads,
                "max_position_embeddings": cfg.max_len, "rope_theta": cfg.rope_theta,
                "rms_norm_eps": cfg.norm_eps, "tie_word_embeddings": False,
                "torch_dtype": str(cfg.dtype).split(".")[-1]}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg_json, f, indent=1)
    shards, cur, size = [], {}, 0
    for name, t in hf_llama_tensors(params, cfg):
        n = t.numel() * t.element_size()
        if cur and size + n > shard_bytes:
            shards.append(cur)
            cur, size = {}, 0
        cur[name] = t
        size += n
    shards.append(cur)
    total, weight_map = 0, {}
    for j, shard in enumerate(shards):
        fname = f"model-{j + 1:05d}-of-{len(shards):05d}.safetensors"
        total += write_safetensors(os.path.join(path, fname), shard)
        weight_map.update({name: fname for name in shard})
    # HF's index of a sharded checkpoint (transformers reads it; the
    # port's loader reads every *.safetensors).
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": sum(
            t.numel() * t.element_size() for shard in shards for t in shard.values())},
            "weight_map": weight_map}, f, indent=1)
    return total


def same_params(torch, got: dict, want: dict, label: str) -> None:
    """Every leaf of ``got`` equal to ``want``'s bit for bit (a Q8/Q4 in
    its ``q`` and ``s``), and the same leaves."""
    from gofr_tpu_torch.ops.quant import is_quantized

    if got.keys() != want.keys():
        fail(f"{label}: leaves {sorted(got)} against {sorted(want)}")
    for k, w in want.items():
        g = got[k]
        pairs = ((g.q, w.q), (g.s, w.s)) if is_quantized(w) else ((g, w),)
        if type(g) is not type(w) or not all(
                a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
                for a, b in pairs):
            fail(f"{label}: leaf {k} differs")


def phase_quant(torch, dev, cfg, params, base_stats: dict) -> dict:
    """Llama-3-8B's bf16 weights (live) quantized on the card to int8 and
    int4 by ``quantize_params``: one layer's slices of every quantized leaf
    (and 8,192 columns of lm_head) equal the CPU's ``quantize_array`` /
    ``quantize_array4`` of the same bf16 slices bit for bit;
    transformer_forward [1, 1024] of the quantized model through the
    kernels against its plain attention path (FORWARD_DLOGITS_TOL; a top-1
    may differ only at a near-tie), and the quantization's effect against
    the bf16 model (no limit); then phase_serve's traffic on the bf16 slot
    cache, flash_decode and flash_cache_attention launched, tok/s, TTFT p50
    and ITL p50 beside the bf16 serve's; the int8 model's decode window
    and prefill chunk profiled. Returns each mode's serve stats (counts,
    streams) and the int8 tree."""
    from gofr_tpu_torch.models.transformer import transformer_forward
    from gofr_tpu_torch.ops.quant import (
        QUANT_KEYS, quantize_array, quantize_array4, quantize_params, quantized_bytes)

    layer, cols = min(7, cfg.n_layers - 1), 8192
    gen = torch.Generator(device=dev).manual_seed(31)
    tokens = torch.randint(0, cfg.vocab_size, (1, 1024), generator=gen, device=dev)
    out = {}
    with torch.inference_mode():
        bf16_logits = transformer_forward(params, tokens, cfg)
        for mode, cpu_quant in (("int8", quantize_array), ("int4", quantize_array4)):
            t0 = time.perf_counter()
            q = quantize_params(params, mode)
            torch.cuda.synchronize()
            log(f"quant {mode}: llama-3-8b quantized on the card in "
                f"{time.perf_counter() - t0:.2f} s: {quantized_bytes(q)} bytes against "
                f"{quantized_bytes(params)} in bf16")
            for key in QUANT_KEYS:
                if key not in params:
                    continue
                w = params[key][layer] if key != "lm_head" else params[key][:, :cols]
                got = q[key][layer] if key != "lm_head" else q[key]
                want = cpu_quant(w.cpu())
                gq, gs = (got.q, got.s) if key != "lm_head" else (got.q[..., :cols],
                                                                  got.s[..., :cols])
                if not (torch.equal(gq.cpu(), want.q) and torch.equal(gs.cpu(), want.s)):
                    bad = (gs.cpu() != want.s).sum().item()
                    fail(f"quant {mode} {key}: the card's quantization differs from the "
                         f"CPU's on the same bf16 slice ({bad} scales differ)")
            log(f"quant {mode}: layer {layer} of {', '.join(k for k in QUANT_KEYS if k in q)} "
                f"(lm_head: its first {cols} columns) equal to the CPU's quantization bit "
                "for bit")
            logits = [transformer_forward(q, tokens, cfg, dense_attn=dense)
                      for dense in (False, True)]
            torch.cuda.synchronize()
            kern, plain = logits
            if not all(torch.isfinite(t).all() for t in logits):
                fail(f"quant {mode}: transformer_forward gives non-finite logits")
            d = (kern - plain).abs().max().item()
            pick = kern.argmax(-1)
            gap = (plain.max(-1).values - plain.gather(-1, pick[..., None])[..., 0]).max().item()
            log(f"quant {mode}: transformer_forward [1, 1024] kernels vs plain: max|dlogits| "
                f"{d:.4g} (limit {FORWARD_DLOGITS_TOL}), largest top-1 gap {gap:.4g}; "
                f"against the bf16 model (no limit): max|dlogits| "
                f"{(kern - bf16_logits).abs().max().item():.4g}, top-1 agreement "
                f"{(pick == bf16_logits.argmax(-1)).float().mean().item():.3f}")
            if d > FORWARD_DLOGITS_TOL or gap > FORWARD_DLOGITS_TOL:
                fail(f"quant {mode}: the kernel path disagrees with the plain path")
            del logits, kern, plain
            counts, streams, stats = phase_serve(torch, dev, q, tag=f"{mode} weights")
            out[mode] = dict(stats, counts=counts, streams=streams)
            if mode == "int8":
                out["int8_params"] = q
                phase_profile(torch, dev, cfg, q, model="llama-3-8b-int8", graph=True)
            del q
            gc.collect()
            torch.cuda.empty_cache()
    log("serve llama-3-8b bf16 / int8 / int4 weights (bf16 slot cache): " + json.dumps(
        {m: {x: st[x] for x in ("tok_s", "ttft_p50_ms", "itl_p50_ms")}
         for m, st in (("bf16", base_stats), ("int8", out["int8"]), ("int4", out["int4"]))}))
    return out


def phase_loader(torch, dev, cfg, params, q8: dict, q8_streams: list) -> dict:
    """TPU_CHECKPOINT on Llama-3-8B: its bf16 params written as an HF
    directory (config.json, safetensors shards of at most 5 GB, HF names,
    [out, in]) into a new temporary directory outside the repo (failing if
    the disk has less than twice the bytes free), then served through
    InferenceEngine.from_config: every leaf loaded equals the params bit for
    bit; with TPU_QUANT=int8 every leaf equals ``quantize_params`` of them
    (``q8``) and phase_serve's greedy streams equal the in-memory int8
    engine's (``q8_streams``; a difference only at a near-tie). Then the
    shards go and save_checkpoint / restore_checkpoint round-trips the int8
    tree bit for bit. Prints the bytes, write and load seconds and GB/s;
    the directory is removed. Returns the int8 serve's counts and timings."""
    import glob
    import os
    import shutil
    import tempfile

    from gofr_tpu_torch.config import MockConfig
    from gofr_tpu_torch.serving.checkpoint import restore_checkpoint, save_checkpoint
    from gofr_tpu_torch.serving.engine import InferenceEngine

    nbytes = sum(t.numel() * t.element_size() for _, t in hf_llama_tensors(params, cfg))
    d = tempfile.mkdtemp(prefix="chip_smoke_hf_")
    try:
        free = shutil.disk_usage(d).free
        log(f"loader: {nbytes} bytes of llama-3-8b bf16 tensors to write under {d}; "
            f"{free} bytes free on its disk")
        if free < 2 * nbytes:
            fail(f"loader: {free} bytes free under {d}, fewer than twice the {nbytes} bytes "
                 "the HF checkpoint takes")
        t0 = time.perf_counter()
        written = write_hf_checkpoint(d, params, cfg)
        t_write = time.perf_counter() - t0
        shards = sorted(glob.glob(os.path.join(d, "*.safetensors")))
        log(f"loader: wrote {written} bytes in {len(shards)} shards in {t_write:.1f} s "
            f"({written / t_write / 1e9:.2f} GB/s)")
        geometry = {"TPU_MODEL": "llama-3-8b", "TPU_DEVICE": str(dev), "TPU_KV_SLOTS": "8",
                    "TPU_MAX_LEN": "2048", "TPU_DECODE_WINDOW": "8",
                    "TPU_PREFILL_CHUNK": "256", "TPU_PREFILL_BATCH": "8",
                    "TPU_CHECKPOINT": d}
        out = {"bytes": written, "write_s": t_write}
        for quant, want in (("", params), ("int8", q8)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng = InferenceEngine.from_config(MockConfig(dict(geometry, TPU_QUANT=quant)))
            torch.cuda.synchronize()
            t_load = time.perf_counter() - t0
            label = f"loader from_config(TPU_CHECKPOINT{', TPU_QUANT=' + quant if quant else ''})"
            log(f"{label}: engine built in {t_load:.1f} s ({written / t_load / 1e9:.2f} GB/s "
                f"of checkpoint; page cache warm: the files were just written), weights "
                f"{eng.quant or 'bf16'}, param_bytes() {eng.param_bytes()}")
            same_params(torch, eng.params, want, label)
            log(f"{label}: every leaf equal to the {'quantize_params of the ' if quant else ''}"
                "in-memory params bit for bit")
            out[quant or "bf16"] = {"load_s": t_load, "gb_s": written / t_load / 1e9}
            if not quant:
                eng.close()
                del eng
                gc.collect()
                torch.cuda.empty_cache()
                continue
            counts, streams, stats = phase_serve(torch, dev, None, eng=eng,
                                                 tag="int8 from TPU_CHECKPOINT")
            check_streams(torch, cfg, q8, "loader int8 serve vs in-memory int8",
                          serve_prompts(cfg.vocab_size), q8_streams, streams,
                          [True] * (len(LLAMA_PROMPTS) - 2) + [False] * 2)
            out["int8"].update(stats, counts=counts)
            eng_params = eng.params
            del eng
        for f in shards:
            os.remove(f)
        path = os.path.join(d, "params-int8.pt")
        t0 = time.perf_counter()
        save_checkpoint(path, eng_params)
        t_save = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        restored = restore_checkpoint(path, like=eng_params)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        same_params(torch, restored, eng_params, "checkpoint int8 round trip")
        log(f"checkpoint: the int8 tree ({size} bytes) saved in {t_save:.1f} s and restored "
            f"onto the card in {t_restore:.1f} s ({size / t_restore / 1e9:.2f} GB/s, page "
            "cache warm), every leaf bit for bit")
        out["checkpoint"] = {"bytes": size, "save_s": t_save, "restore_s": t_restore}
        del restored, eng_params
    finally:
        shutil.rmtree(d, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return out


# Multi-LoRA: Llama-3-8B with 3 adapter slots of rank 16 on all
# seven targets; each delta about LORA_SCALE of its base product.
LORA_SLOTS, LORA_RANK, LORA_SCALE = 3, 16, 0.2
# The PEFT adapter: r 8, lora_alpha 16, this layer left out.
LORA_PEFT_R, LORA_PEFT_ALPHA, LORA_PEFT_SKIP = 8, 16.0, 5
# Adapter of request i: round robin over the base and the three adapters.
LORA_NAMES = ("", "peft", "r2", "r3")


def lora_factors(torch, cfg, seed: int, dev, rank: int = LORA_RANK,
                 scale: float = LORA_SCALE) -> dict:
    """``load_lora``'s raw dict over all seven targets, f32 on ``dev``: a ~
    N(0, 1/d_in) and b ~ N(0, scale^2/r), so for a unit-rms input ``x a``
    has unit entries and the delta ``(x a) b`` entries of about ``scale``
    (a base product's are about 1)."""
    from gofr_tpu_torch.models.transformer import LORA_TARGETS, lora_dims

    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for t in LORA_TARGETS:
        d_in, d_out = lora_dims(cfg, t)
        out[t] = (torch.randn((cfg.n_layers, d_in, rank), generator=gen, device=dev)
                  * d_in**-0.5,
                  torch.randn((cfg.n_layers, rank, d_out), generator=gen, device=dev)
                  * (scale / rank**0.5))
    return out


def write_peft_adapter(torch, path: str, cfg, seed: int, dev) -> int:
    """An HF PEFT adapter directory: adapter_config.json (r LORA_PEFT_R,
    lora_alpha LORA_PEFT_ALPHA, the seven modules) and one safetensors
    file (``write_safetensors``) of f32 ``lora_A`` [r, d_in] and ``lora_B``
    [d_out, r] under PEFT's names for every layer but LORA_PEFT_SKIP, sized
    as ``lora_factors``' once alpha / r is folded in. Returns its bytes."""
    import os

    from gofr_tpu_torch.serving.lora import _HF_MODULE, PEFT_TARGET_MAP

    r = LORA_PEFT_R
    fac = lora_factors(torch, cfg, seed, dev, rank=r,
                       scale=LORA_SCALE * r / LORA_PEFT_ALPHA)
    tensors = {}
    for t, (a, b) in fac.items():
        for i in range(cfg.n_layers):
            if i == LORA_PEFT_SKIP:
                continue
            pre = f"base_model.model.model.layers.{i}.{_HF_MODULE[t]}"
            tensors[pre + ".lora_A.weight"] = a[i].t().contiguous()
            tensors[pre + ".lora_B.weight"] = b[i].t().contiguous()
    with open(os.path.join(path, "adapter_config.json"), "w") as f:
        json.dump({"r": r, "lora_alpha": LORA_PEFT_ALPHA,
                   "target_modules": sorted(PEFT_TARGET_MAP)}, f)
    return write_safetensors(os.path.join(path, "adapter_model.safetensors"), tensors)


def serve_adapters(torch, eng, label: str, prompts: list, kws: list, names: list) -> dict:
    """Every request at once (request i on adapter ``names[i]``, "" the
    base) through a started engine, counted as phase_serve counts: the
    kernels' launches (reset just before), stream syncs (none allowed),
    each request finished (its budget or EOS) with finite logprobs, both
    serving kernels launched. Returns the streams, stats and counts."""
    import numpy as np

    from gofr_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    seen = watch_steps(eng)
    count_syncs(torch, True)
    t0 = time.perf_counter()
    reqs = [eng.submit_generate(p, adapter=nm, **kw) for p, kw, nm in zip(prompts, kws, names)]
    results = [r.future.result(timeout=600) for r in reqs]
    wall = time.perf_counter() - t0
    syncs = count_syncs(torch, False)
    unwatch_steps(eng)
    counts = launch_counts()
    if syncs:
        fail(f"{label}: {syncs} stream synchronizations in the run; the first at\n"
             + "\n".join(SYNCS["first"]))
    eos = eng.tokenizer.eos_id
    for i, (kw, res) in enumerate(zip(kws, results)):
        m = len(res.token_ids)
        if not (m == kw["max_new_tokens"] or res.token_ids[-1] == eos):
            fail(f"{label}: request {i} ended with {m} tokens ({res.finish_reason})")
        if not np.all(np.isfinite(res.token_logprobs)):
            fail(f"{label}: request {i} has non-finite logprobs")
    for name in ("flash_decode", "flash_cache_attention"):
        if counts[name] <= 0:
            fail(f"{label}: kernel {name} was not launched on the main path")
    stats = serve_stats(reqs, wall)
    stats.update(counts=counts, syncs=syncs)
    log(f"{label}: {len(reqs)} requests on adapters {list(names)} in {wall:.3f} s: "
        f"{stats['tok_s']:.1f} tok/s, TTFT p50 {stats['ttft_p50_ms']:.1f} ms, ITL p50 "
        f"{stats['itl_p50_ms']:.2f} ms, {syncs} stream syncs; {steps_line(seen)}; "
        f"launch counts {counts}")
    return {"streams": [r.token_ids for r in results], "stats": stats, "counts": counts}


def lora_kernels_vs_plain(torch, dev, cfg, params, aids_l: list) -> dict:
    """The three kernels with the adapter plane present, against the plain
    path on the same adapters: transformer_forward [4, 512] (rows on
    adapters ``aids_l``), then phase_forward's chunk (8 x 256, 7 live
    rows) and two decode steps on a bf16 slot cache with each slot on
    adapter ``aids_l[slot % 4]``, kernels vs dense_attn; FORWARD_DLOGITS_TOL
    with the near-tie rule. Returns each run's launch counts."""
    from gofr_tpu_torch.models.transformer import (
        decode_step, prefill_chunk, rope_tables, transformer_forward)
    from gofr_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from gofr_tpu_torch.ops.kv_cache import KVCache

    gen = torch.Generator(device=dev).manual_seed(17)
    counts = {}
    aids = torch.tensor(aids_l, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (4, 512), generator=gen, device=dev)
    reset_launch_counts()
    kern = transformer_forward(params, tokens, cfg, aids=aids)
    torch.cuda.synchronize()
    counts["transformer_forward [4, 512]"] = launch_counts()
    plain = transformer_forward(params, tokens, cfg, aids=aids, dense_attn=True)
    d = (kern - plain).abs().max().item()
    pick = kern.argmax(-1)
    gap = (plain.max(-1).values - plain.gather(-1, pick[..., None])[..., 0]).max().item()
    log(f"lora: transformer_forward [4, 512] on adapter slots {aids_l}, kernels vs plain: "
        f"max|dlogits| {d:.4g} (limit {FORWARD_DLOGITS_TOL}), largest top-1 gap {gap:.4g}")
    if not (torch.isfinite(kern).all() and d <= FORWARD_DLOGITS_TOL
            and gap <= FORWARD_DLOGITS_TOL):
        fail("lora: transformer_forward with adapters: kernels and plain path disagree")
    del kern, plain

    S, max_len, P, c = 8, 2048, 8, 256
    rope = rope_tables(cfg, max_len, dev)
    i32 = dict(dtype=torch.int32, device=dev)
    chunk = torch.randint(0, cfg.vocab_size, (P, c), generator=gen, device=dev)
    chunk[P - 1] = chunk[0]
    slots = torch.tensor([0, 1, 2, 3, 4, 5, 6, 0], **i32)
    starts = torch.zeros((P,), **i32)
    lens = torch.tensor([256, 256, 100, 1, 200, 256, 50, 256], **i32)
    active = torch.tensor([True] * 7 + [False], device=dev)
    plane = torch.tensor([aids_l[i % len(aids_l)] for i in range(S)], device=dev)
    steps = [torch.randint(0, cfg.vocab_size, (S,), generator=gen, device=dev)
             for _ in range(2)]

    def run(dense: bool) -> list:
        cache = KVCache.create(cfg.n_layers, S, max_len, cfg.n_kv_heads, cfg.head_dim,
                               dtype=cfg.dtype, device=dev)
        out = [prefill_chunk(params, chunk, cache, slots, starts, lens, cfg, rope=rope,
                             dense_attn=dense, aids=plane[slots.long()])[:7]]
        cache.lengths[:7] = lens[:7]
        for st in steps:
            out.append(decode_step(params, st, cache, active, cfg, rope=rope,
                                   dense_attn=dense, aids=plane)[:7])
        torch.cuda.synchronize()
        return out

    reset_launch_counts()
    got = run(False)
    counts["chunk and two decode steps"] = launch_counts()
    compare_logits("lora adapters, kernels vs plain", got, run(True), FORWARD_DLOGITS_TOL,
                   near_ties=True)
    for run_name, cnt in counts.items():
        want = ("flash_attention",) if run_name.startswith("transformer") else (
            "flash_cache_attention", "flash_decode")
        if any(cnt[k] <= 0 for k in want):
            fail(f"lora: {run_name} did not launch {want}: {cnt}")
    return counts


def phase_lora(torch, dev, cfg, params, base: list) -> dict:
    """Multi-LoRA on Llama-3-8B's bf16 ``params`` at phase_serve's geometry
    (8 slots, max_len 2048, chunk 8 x 256, k 8, depth 2, CUDA graphs),
    LORA_SLOTS slots of rank LORA_RANK on all seven targets. The engine is
    built by ``from_config`` (its seed-0 weights equal ``params`` bit for
    bit), with TPU_LORA_ADAPTERS loading a PEFT directory written here
    (r 8, alpha 16, layer LORA_PEFT_SKIP left out; its leaves must equal
    ``load_peft_adapter``'s in bf16, that layer zero) after the decode
    graphs were captured; two raw adapters follow (``lora_factors``).
    Checks, each failing the run:
    1. phase_serve's 10 requests on the base through the LoRA engine equal
       ``base`` (phase_serve's streams) bit for bit, or leave them only at
       a near-tie; slot 0's leaves are exactly 0.
    2. The 10 requests spread over base and the three adapters in one
       batch: each stream equals the request served alone on its adapter
       (near-tie rule); each adapter's greedy stream leaves the base's.
    3. The kernels with the adapter plane against the plain path
       (``lora_kernels_vs_plain``).
    4. An adapter loaded after the capture changes the replayed windows'
       tokens: each token within FORWARD_DLOGITS_TOL (kernels vs plain) of
       the top logit of the plain forward under the adapter, and some
       replayed token beyond it under the base; with the slot zeroed
       they are the base's again.
    5. A reload while requests on that adapter decode fails them with the
       reference's message and leaves the other streams as they were
       alone; on a bf16 pool with auto_prefix, a prompt cached under an
       adapter is dropped on unload (cached blocks before and after) and
       a fresh adapter in that slot does not hit it.
    6. The A/B: lora_slots = 0 (phase_serve, this call) against the LoRA
       engine on the base traffic and on the mixed batch: tok/s, TTFT
       p50, ITL p50, launches, capture time, the leaves' bytes.
    Returns the launch counts of each run."""
    import shutil
    import tempfile

    from gofr_tpu_torch.config import MockConfig
    from gofr_tpu_torch.models.transformer import LORA_TARGETS, transformer_forward
    from gofr_tpu_torch.serving.engine import InferenceEngine
    from gofr_tpu_torch.serving.lora import load_peft_adapter

    prompts = serve_prompts(cfg.vocab_size)
    n = len(prompts)
    kws = [dict(max_new_tokens=32)] * n
    kws[n - 2:] = [dict(max_new_tokens=32, temperature=0.8, seed=4242)] * 2
    greedy = [True] * (n - 2) + [False] * 2
    targets = ",".join(LORA_TARGETS)
    counts = {}

    # 6, side A: the same traffic with no adapter slots, in this call.
    off_counts, off_streams, off_stats = phase_serve(torch, dev, params,
                                                     tag="lora_slots=0 (the A/B's A)")
    counts["serve lora_slots=0"] = off_counts

    d = tempfile.mkdtemp(prefix="chip_smoke_peft_")
    try:
        nbytes = write_peft_adapter(torch, d, cfg, 1, dev)
        t0 = time.perf_counter()
        eng = InferenceEngine.from_config(MockConfig({
            "TPU_MODEL": "llama-3-8b", "TPU_DEVICE": str(dev), "TPU_KV_SLOTS": "8",
            "TPU_MAX_LEN": "2048", "TPU_DECODE_WINDOW": "8", "TPU_PREFILL_CHUNK": "256",
            "TPU_PREFILL_BATCH": "8", "TPU_LORA_SLOTS": str(LORA_SLOTS),
            "TPU_LORA_RANK": str(LORA_RANK), "TPU_LORA_TARGETS": targets,
            "TPU_LORA_ADAPTERS": f"peft={d}"}))
        torch.cuda.synchronize()
        t_boot = time.perf_counter() - t0
        peft = load_peft_adapter(d, cfg, LORA_RANK, LORA_TARGETS)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    label = "lora engine"
    try:
        if eng.lora_names() != ["peft"] or eng._graphs is None:
            fail(f"{label}: from_config loaded {eng.lora_names()}, graphs "
                 f"{'captured' if eng._graphs is not None else 'absent'}")
        same_params(torch, {k: v for k, v in eng.params.items() if "_lora_" not in k},
                    params, f"{label}: from_config's seed-0 weights")
        for t, (a, b) in peft.items():
            for got, want in ((eng.params[t + "_lora_a"][:, 1], a),
                              (eng.params[t + "_lora_b"][:, 1], b)):
                if not torch.equal(got, want.to(device=dev, dtype=cfg.dtype)):
                    fail(f"{label}: the PEFT adapter's {t} leaf differs from "
                         "load_peft_adapter's in bf16")
            if eng.params[t + "_lora_a"][LORA_PEFT_SKIP, 1].any():
                fail(f"{label}: layer {LORA_PEFT_SKIP}, left out by the adapter, is not zero")
        raws = {name: lora_factors(torch, cfg, seed, dev) for name, seed in (("r2", 2),
                                                                            ("r3", 3))}
        for name, lv in raws.items():
            eng.load_lora(name, lv)
        aid = {name: eng._lora_names[name] if name else 0 for name in LORA_NAMES}
        leaves = {k: v for k, v in eng.params.items() if "_lora_" in k}
        leaf_bytes = sum(v.numel() * v.element_size() for v in leaves.values())
        ptrs = {k: v.data_ptr() for k, v in leaves.items()}
        if any(v[:, 0].any() for v in leaves.values()):
            fail(f"{label}: adapter slot 0 (the base) is not exactly zero")
        capture_s = sum(eng._graphs.capture_s.values())
        log(f"{label}: from_config with TPU_LORA_ADAPTERS in {t_boot:.1f} s (seed-0 weights, "
            f"graph capture {capture_s:.2f} s, the PEFT directory's {nbytes} bytes), adapter "
            f"slots {aid}; the PEFT leaves equal load_peft_adapter's in bf16, layer "
            f"{LORA_PEFT_SKIP} zero; {len(leaves)} leaves of [L, {1 + LORA_SLOTS}, ., "
            f"{LORA_RANK}]: {leaf_bytes} bytes ({leaf_bytes / (1 + LORA_SLOTS) / 1e6:.1f} MB "
            "an adapter)")
        eng.generate_sync([1, 2, 3], max_new_tokens=2, timeout=600)  # warm-up

        # 1. Base rows unchanged.
        on_base = serve_adapters(torch, eng, f"{label} (1) all base", prompts, kws, [""] * n)
        check_streams(torch, cfg, params, f"{label} (1) base rows vs phase_serve", prompts,
                      base, on_base["streams"], greedy)
        counts["serve base on the LoRA engine"] = on_base["counts"]

        # 2. Batch isolation.
        names = [LORA_NAMES[i % len(LORA_NAMES)] for i in range(n)]
        mixed = serve_adapters(torch, eng, f"{label} (2) mixed", prompts, kws, names)
        counts["serve mixed"] = mixed["counts"]
        solo = [eng.generate_sync(p, adapter=nm, timeout=600, **kw).token_ids
                for p, kw, nm in zip(prompts, kws, names)]
        check_streams(torch, cfg, eng.params, f"{label} (2) mixed batch vs alone", prompts,
                      solo, mixed["streams"], greedy, [aid[nm] for nm in names])
        for i, nm in enumerate(names):
            if nm and greedy[i] and solo[i] == base[i]:
                fail(f"{label} (2): request {i} on adapter {nm} equals the base stream")
        log(f"{label} (2): every adapter's greedy stream leaves the base's, at steps "
            + json.dumps({i: next((j for j, (x, y) in enumerate(zip(solo[i], base[i]))
                                   if x != y), None)
                          for i, nm in enumerate(names) if nm and greedy[i]}))

        # 3. Kernels against plain with the adapter plane.
        with torch.inference_mode():
            counts.update(lora_kernels_vs_plain(torch, dev, cfg, eng.params,
                                                [aid[nm] for nm in LORA_NAMES]))

        # 4. Load after capture, then the slot zeroed.
        prompt, late = prompts[3], lora_factors(torch, cfg, 4, dev)
        eng.unload_lora("r3")
        slot = eng.load_lora("late", late)
        got = eng.generate_sync(prompt, adapter="late", max_new_tokens=32, timeout=600).token_ids
        if got == base[3]:
            fail(f"{label} (4): an adapter loaded after the capture left the replayed "
                 "windows' tokens as the base's")
        with torch.inference_mode():
            ids = torch.tensor([prompt + got[:-1]], device=dev)
            picked = torch.tensor(got, device=dev)[:, None]
            short = {}
            for who, a in (("adapter", slot), ("base", 0)):
                pos = transformer_forward(eng.params, ids, cfg, dense_attn=True,
                                          aids=torch.tensor([a], device=dev))[0, len(prompt) - 1:]
                short[who] = (pos.max(-1).values - pos.gather(-1, picked)[:, 0]).float()
        log(f"{label} (4): an adapter loaded into slot {slot} after the capture: the stream "
            f"leaves the base's at step "
            f"{next((j for j, (x, y) in enumerate(zip(got, base[3])) if x != y), None)}; each "
            "token's shortfall from the plain forward's top logit at its position (the first "
            "from the eager prefill, the rest from replayed windows): under the adapter "
            f"{int((short['adapter'] > 0).sum())} of {len(got)} tokens below the top, the "
            f"largest by {short['adapter'].max().item():.4g} (limit {FORWARD_DLOGITS_TOL}, "
            "kernels vs plain); under the base, the replayed tokens' largest "
            f"{short['base'][1:].max().item():.4g}")
        if short["adapter"].max().item() > FORWARD_DLOGITS_TOL:
            fail(f"{label} (4): a replayed token is not the adapter's greedy pick within the "
                 "kernels-vs-plain limit")
        if short["base"][1:].max().item() <= FORWARD_DLOGITS_TOL:
            fail(f"{label} (4): every replayed token is also the base's pick: the windows may "
                 "not read the adapter written after the capture")
        eng.unload_lora("late")
        zero = {t: (torch.zeros_like(a), torch.zeros_like(b)) for t, (a, b) in late.items()}
        eng.load_lora("late", zero)
        again = eng.generate_sync(prompt, adapter="late", max_new_tokens=32,
                                  timeout=600).token_ids
        check_streams(torch, cfg, params, f"{label} (4) the zeroed slot vs the base", [prompt],
                      [base[3]], [again], [True])
        eng.unload_lora("late")
        eng.load_lora("r3", raws["r3"])

        # 5. Reload while serving.
        long_kws = [dict(kw, max_new_tokens=400) if nm == "r2" else kw
                    for kw, nm in zip(kws, names)]
        reqs = [eng.submit_generate(p, adapter=nm, **kw)
                for p, kw, nm in zip(prompts, long_kws, names)]
        victims = [r for r, nm in zip(reqs, names) if nm == "r2"]
        deadline = time.monotonic() + 300
        while not all(len(r.token_ids) >= 2 for r in victims) and time.monotonic() < deadline:
            time.sleep(0.002)
        at = [len(r.token_ids) for r in victims]
        idx = eng.load_lora("r2", lora_factors(torch, cfg, 5, dev))
        want_msg = (f"LoRA adapter slot {idx} is being overwritten by a load of 'r2' while "
                    "this request was generating; resubmit")
        for i, (r, nm) in enumerate(zip(reqs, names)):
            if nm != "r2":
                continue
            try:
                r.future.result(timeout=600)
                fail(f"{label} (5): request {i} on the reloaded adapter finished")
            except RuntimeError as exc:
                if str(exc) != want_msg:
                    fail(f"{label} (5): request {i} failed with {exc!r}, not the reference's "
                         "message")
        others = [i for i, nm in enumerate(names) if nm != "r2"]
        check_streams(torch, cfg, eng.params, f"{label} (5) the other streams across a reload",
                      [prompts[i] for i in others], [solo[i] for i in others],
                      [reqs[i].future.result(timeout=600).token_ids for i in others],
                      [greedy[i] for i in others], [aid[names[i]] for i in others])
        deadline = time.monotonic() + 60
        while any(s is not None for s in eng._slots) and time.monotonic() < deadline:
            time.sleep(0.01)
        if any(s is not None for s in eng._slots):
            fail(f"{label} (5): slots still held after the reload's failed requests")
        log(f"{label} (5): reloading r2 (slot {idx}) while its {len(victims)} requests "
            f"decoded (at {at} tokens) failed them with the reference's message; the other "
            f"{len(others)} streams as alone; every slot free after")
        if {k: v.data_ptr() for k, v in leaves.items()} != ptrs:
            fail(f"{label}: an adapter leaf moved (the captured graphs read the old one)")
        out = {"off": off_stats, "base": on_base["stats"], "mixed": mixed["stats"],
               "capture_s": capture_s, "leaf_bytes": leaf_bytes}
    finally:
        eng.close()
        del eng
        gc.collect()
        torch.cuda.empty_cache()

    # 5b. The automatic prefix cache under an adapter, on a bf16 pool.
    system, _, _, _, _ = prefix_traffic(cfg.vocab_size)
    shared = system + system[:64]
    peng = InferenceEngine("llama-3-8b", n_slots=8, max_len=2048, window_k=8,
                           prefill_chunk=256, prefill_batch=8, params=params, seed=0,
                           device=dev, kv_block=32, kv_pool_blocks=161, auto_prefix=True,
                           lora_slots=LORA_SLOTS, lora_rank=LORA_RANK, lora_targets=targets)
    plabel = "lora prefix cache (bf16 pool 161 x 32, auto_prefix)"
    try:
        peng.load_lora("x", lora_factors(torch, cfg, 2, dev))

        def run(name: str) -> tuple:
            hits = peng._prefix_hit_tokens
            peng.generate_sync(shared, adapter=name, max_new_tokens=8, timeout=600)
            deadline = time.monotonic() + 30
            while any(s is not None for s in peng._slots) and time.monotonic() < deadline:
                time.sleep(0.01)
            return peng._prefix_hit_tokens - hits, peng.kv_pool_counts()[2]

        first, second = run("x"), run("x")
        peng.unload_lora("x")
        after = peng.kv_pool_counts()[2]
        if peng.load_lora("y", lora_factors(torch, cfg, 3, dev)) != 1:
            fail(f"{plabel}: the fresh adapter did not take the freed slot 1")
        fresh = run("y")
        log(f"{plabel}: a {len(shared)}-token prompt under adapter x: cached blocks "
            f"{first[1]}, a repeat hits {second[0]} tokens; unload x: cached blocks "
            f"{second[1]} -> {after}; a fresh adapter y in slot 1 hits {fresh[0]} tokens "
            f"(cached after {fresh[1]})")
        if first[1] != len(shared) // 32 or second[0] <= 0 or after != 0 or fresh[0] != 0:
            fail(f"{plabel}: the adapter's cached prefix was not dropped on unload or was hit "
                 "by a fresh adapter in its slot")
        pool_invariant(peng, plabel)
    finally:
        peng.close()
        del peng
        gc.collect()
        torch.cuda.empty_cache()

    keys = ("tok_s", "ttft_p50_ms", "itl_p50_ms")
    log("lora A/B (same call; llama-3-8b bf16 slot cache, phase_serve's 10 requests): "
        + json.dumps({
            "lora_slots=0": {**{k: out["off"][k] for k in keys},
                             "capture_s": out["off"].get("capture_s"),
                             "launches": out["off"]["counts"]},
            f"lora_slots={LORA_SLOTS}, all base": {**{k: out["base"][k] for k in keys},
                                                   "launches": out["base"]["counts"]},
            f"lora_slots={LORA_SLOTS}, mixed": {**{k: out["mixed"][k] for k in keys},
                                                "launches": out["mixed"]["counts"]},
            "lora capture_s": out["capture_s"], "lora leaf bytes": out["leaf_bytes"]}))
    out["counts"] = counts
    return out


def phase_lora_train(torch, dev) -> dict:
    """make_lora_train_step on llama-1b (22 layers, full width) on one
    fixed [4, 2048] batch, rank LORA_RANK on all seven targets, 6 steps
    each on the bf16 base and on that base quantized to int8: losses
    finite and falling, exactly 22 flash_attention launches a step (the
    backward is the dense recompute), step time (median of steps 2-6),
    tokens/s and peak memory; then the bf16 run's factors load into a
    llama-1b engine (CUDA graphs) and serve one request on the adapter.
    Returns the launch counts of each run."""
    import numpy as np

    from gofr_tpu_torch.models.registry import get_model
    from gofr_tpu_torch.models.transformer import LORA_TARGETS, init_params
    from gofr_tpu_torch.ops.cuda import flash_attention as fa
    from gofr_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from gofr_tpu_torch.ops.quant import quantize_params
    from gofr_tpu_torch.parallel.sharding import make_lora_train_step
    from gofr_tpu_torch.serving.engine import InferenceEngine

    cfg = get_model("llama-1b").config
    L, b, s = cfg.n_layers, 4, 2048
    with torch.no_grad():  # not inference mode: the base takes part in autograd
        base = init_params(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev)
    out, trained = {}, None
    for mode in ("bf16", "int8"):
        frozen = base if mode == "bf16" else quantize_params(base, "int8")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        init_state, step = make_lora_train_step(cfg, frozen, LORA_RANK, LORA_TARGETS,
                                                device=dev)
        lora, opt = init_state(0)
        reset_launch_counts()
        losses, secs = [], []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, lora, opt = step(lora, opt, tokens)
            losses.append(loss.item())
            secs.append(time.perf_counter() - t0)
        counts = launch_counts()
        label = f"lora train llama-1b [{b}, {s}] {mode} base"
        if fa.launches != 6 * L:
            fail(f"{label}: {fa.launches} flash_attention launches over 6 steps, not {6 * L}")
        if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
            fail(f"{label}: losses {losses} are not finite and falling")
        step_s = statistics.median(secs[1:])
        peak = torch.cuda.max_memory_allocated()
        n_train = sum(x.numel() for ab in lora.values() for x in ab)
        log(f"{label}: rank {LORA_RANK} on {len(LORA_TARGETS)} targets ({n_train} trained "
            f"parameters); losses {[round(x, 5) for x in losses]}; step time median of steps "
            f"2-6 {step_s * 1e3:.1f} ms (all {[round(x * 1e3, 1) for x in secs]}), "
            f"{b * s / step_s:.0f} tokens/s, peak memory {peak / 2**30:.2f} GiB; launch "
            f"counts {counts}")
        out[mode] = {"step_ms": step_s * 1e3, "tok_s": b * s / step_s,
                     "peak_gib": peak / 2**30, "losses": losses, "counts": counts}
        if mode == "bf16":
            trained = lora
        del frozen, init_state, step, lora, opt
    eng = InferenceEngine("llama-1b", n_slots=2, max_len=1024, window_k=8, prefill_chunk=256,
                          prefill_batch=2, params=base, seed=0, device=dev, lora_slots=1,
                          lora_rank=LORA_RANK, lora_targets=",".join(LORA_TARGETS))
    try:
        eng.load_lora("trained", trained)
        prompt = tokens[0, :64].tolist()
        res = eng.generate_sync(prompt, adapter="trained", max_new_tokens=16,
                                stop_on_eos=False, timeout=600)
        plain = eng.generate_sync(prompt, max_new_tokens=16, stop_on_eos=False, timeout=600)
        if len(res.token_ids) != 16 or not np.all(np.isfinite(res.token_logprobs)):
            fail("lora train: the trained adapter's request did not serve 16 finite tokens")
        log(f"lora train: the trained factors served on a llama-1b engine: {res.token_ids} "
            f"(the base: {plain.token_ids}); against the batch's next tokens "
            f"{tokens[0, 64:80].tolist()}")
    finally:
        eng.close()
    del base, trained
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_router(torch, dev, cfg, params) -> None:
    """Mixtral's routing at full width: 4,096 bf16 hidden states through
    layer 0's router, by ``transformer.route``, against a stable-sort
    reference on the host over the same probabilities (the experts must be
    equal, the weights within 1e-6); and again with expert 3's router
    column a copy of expert 1's, so that the two tie on every token: the
    lower index must win wherever they compete."""
    import numpy as np

    from gofr_tpu_torch.models.transformer import route

    gen = torch.Generator(device=dev).manual_seed(37)
    x = torch.randn((4096, cfg.d_model), generator=gen, device=dev).to(cfg.dtype)
    k = cfg.n_experts_active
    for label, router in (("layer 0", params["router"][0]),
                          ("experts 1 and 3 tied", params["router"][0].clone())):
        if "tied" in label:
            router[:, 3] = router[:, 1]
        weights, idx = route(x, router, k)
        probs = torch.softmax((x @ router).float(), dim=-1).cpu().numpy()
        want = np.argsort(-probs, axis=-1, kind="stable")[:, :k]
        top = np.take_along_axis(probs, want, -1)
        want_w = np.zeros_like(probs)
        np.put_along_axis(want_w, want, top / top.sum(-1, keepdims=True), -1)
        ties = int((np.sort(probs, -1)[:, ::-1][:, k - 1] == np.sort(probs, -1)[:, ::-1][:, k])
                   .sum())
        if not np.array_equal(idx.cpu().numpy(), want):
            fail(f"router ({label}): the chosen experts differ from the stable-sort "
                 "reference")
        err = float(np.abs(weights.cpu().numpy() - want_w).max())
        log(f"router ({label}): 4096 tokens, top-{k} of {cfg.n_experts} equal to the "
            f"stable-sort reference; weights max|d| {err:.3g}; {ties} tokens with a tie at "
            f"the k-th place")
        if err > 1e-6:
            fail(f"router ({label}): routing weights differ by {err}")
        if "tied" in label and ties == 0:
            fail("router: the tied case made no tie at the k-th place")


# phase_moe's depth: 8 of Mixtral-8x7B's 32 layers (the whole phase took
# ~112 s at 32 on an H100 80GB HBM3 at 700 W; width, experts and routing
# stay whole).
MOE_LAYERS = 8


def phase_moe(torch, dev) -> dict:
    """Mixtral-8x7B at full width (8 experts, top 2), its depth cut to
    MOE_LAYERS of 32 for the script's time (registered as
    ``mixtral-8x7b-<n>l``), with int8 weights made on the card a layer at
    a time from seed 0:
    peak memory after init and the bytes stored; phase_forward (near-ties
    allowed), phase_full_sequence (transformer_prefill [3, 2048] kernels vs
    plain, transformer_forward against it), the router at full width
    (phase_router), a profile of one decode window (eager and replayed) and
    one prefill chunk; phase_serve's traffic on the bf16 slot cache and on
    an int8 pool of 161 x 32, whose free count returns to full. Frees the
    weights; returns the launch counts and stats."""
    from gofr_tpu_torch.models.registry import get_model, register_model
    from gofr_tpu_torch.models.transformer import init_params
    from gofr_tpu_torch.ops.quant import quantized_bytes

    full = get_model("mixtral-8x7b")
    model = f"mixtral-8x7b-{MOE_LAYERS}l"
    register_model(dataclasses.replace(
        full, name=model, config=dataclasses.replace(full.config, n_layers=MOE_LAYERS)))
    cfg = get_model(model).config
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    with torch.inference_mode():
        t0 = time.perf_counter()
        params = init_params(cfg, seed=0, device=dev, quant="int8")
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        stored = quantized_bytes(params)
        peak = torch.cuda.max_memory_allocated() - before
        log(f"params: {model} random int8 weights made on the card a layer at a time in "
            f"{t_init:.1f} s: {stored} bytes stored; peak memory over the init {peak} "
            f"bytes ({(peak - stored) / 1e9:.3f} GB over the stored tree); heads "
            f"{cfg.n_heads}/{cfg.n_kv_heads}, hd {cfg.head_dim}, {cfg.n_experts} experts, "
            f"top {cfg.n_experts_active}")
        out = {"init_s": t_init, "param_bytes": stored, "peak_bytes": peak,
               "forward": phase_forward(torch, dev, cfg, params, model=model,
                                        near_ties=True),
               "full": phase_full_sequence(torch, dev, model, cfg, params)}
        phase_router(torch, dev, cfg, params)
        phase_profile(torch, dev, cfg, params, model=f"{model}-int8", graph=True)
    counts, _, stats = phase_serve(torch, dev, params, model=model, tag="int8 weights")
    out["serve"] = dict(stats, counts=counts)
    pool_kv = dict(kv_block=32, kv_quant="int8", kv_pool_blocks=161)
    pool_counts, _, pool_stats = phase_serve(torch, dev, params, model=model,
                                             tag="int8 weights", **pool_kv)
    out["pool"] = dict(pool_stats, counts=pool_counts, kv=pool_kv)
    bf16_tok = cfg.n_layers * kv_bytes(1, cfg.n_kv_heads, cfg.head_dim, False)
    log(f"serve {model}: KV cache bytes a token: {bf16_tok} bf16; " + json.dumps(
        {run: {k: st[k] for k in ("tok_s", "ttft_p50_ms", "itl_p50_ms", "windows",
                                   "prefill_dispatches", "syncs", "counts")}
         for run, st in out.items() if run in ("serve", "pool")}))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -- device services: tokenizers, HBM ledger, compile tracker, lockcheck,
# profiler capture, TPU_COMPILE_CACHE_DIR (phase_device_services) --------

DS_MERGES = 4000
DS_SPECIALS = ("<|begin_of_text|>", "<|end_of_text|>", "<|eot_id|>")
# Llama-3's pre-tokenizer pattern (its tokenizer.json's Split).
LLAMA3_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
                r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
DS_WATERMARK = 80  # the free-block watermark the HBM fraction is set to derive
DS_POOL_BLOCKS = 161
DS_RATE_BYTES = 48_000  # the text the Python cores' encode rate is timed on


def repo_markdown() -> str:
    """The repo's own Markdown (its root and docs/), in path order."""
    from pathlib import Path

    root = Path(__file__).resolve().parent
    paths = sorted(root.glob("*.md")) + sorted((root / "docs").rglob("*.md"))
    return "\n".join(p.read_text(encoding="utf-8", errors="replace") for p in paths)


def learn_merges(text: str, n: int) -> list:
    """``n`` byte-level BPE merges by greedy pair count over ``text`` split
    as Llama-3 splits it (``greedy_merges``)."""
    import re as _re

    from gofr_tpu_torch.serving.hf_tokenizer import translate_pattern

    freq = collections.Counter(_re.findall(translate_pattern(LLAMA3_SPLIT), text))
    return greedy_merges([[bytes([b]) for b in w.encode("utf-8")] for w in freq],
                         list(freq.values()), n)


def greedy_merges(words: list, counts: list, n: int) -> list:
    """``n`` BPE merges over ``words`` (symbol lists: bytes or str, a merge
    concatenates the pair) weighted by ``counts``: the most frequent
    adjacent pair (ties: the smallest pair) is merged in every word, counts
    updated incrementally."""
    import heapq

    pairs: collections.Counter = collections.Counter()
    where: dict = collections.defaultdict(set)
    for i, w in enumerate(words):
        for p in zip(w, w[1:]):
            pairs[p] += counts[i]
            where[p].add(i)
    heap = [(-c, p) for p, c in pairs.items()]
    heapq.heapify(heap)
    merges = []
    while heap and len(merges) < n:
        c, p = heapq.heappop(heap)
        if pairs.get(p, 0) != -c or c == 0:
            continue  # stale entry
        merges.append(p)
        new = p[0] + p[1]
        changed = set()
        for i in where.pop(p, ()):
            w, f = words[i], counts[i]
            for q in zip(w, w[1:]):
                pairs[q] -= f
                changed.add(q)
            out, j = [], 0
            while j < len(w):
                if j + 1 < len(w) and (w[j], w[j + 1]) == p:
                    out.append(new)
                    j += 2
                else:
                    out.append(w[j])
                    j += 1
            words[i] = out
            for q in zip(out, out[1:]):
                pairs[q] += f
                where[q].add(i)
                changed.add(q)
        pairs.pop(p, None)
        for q in changed:
            if pairs.get(q, 0) > 0:
                heapq.heappush(heap, (-pairs[q], q))
    return merges


def write_llama3_tokenizer(directory: str, merges: list) -> tuple:
    """A Llama-3-shaped tokenizer.json (Split + ByteLevel, ignore_merges, a
    BOS template, the specials as added tokens after the vocabulary) and a
    tokenizer_config.json over ``merges``, plus the same vocabulary and
    merges as the native core's hex files. Returns (the vocabulary's byte
    strings, the hex files' paths)."""
    import os

    from gofr_tpu_torch.serving.hf_tokenizer import bytes_to_unicode
    from gofr_tpu_torch.serving.native_tokenizer import write_bpe_files

    table = bytes_to_unicode()

    def s(b: bytes) -> str:
        return "".join(table[x] for x in b)

    vocab = [bytes([i]) for i in range(256)]
    seen = set(vocab)
    for a, b in merges:
        if a + b not in seen:
            seen.add(a + b)
            vocab.append(a + b)
    n = len(vocab)
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": n + i, "content": t, "single_word": False, "lstrip": False,
                          "rstrip": False, "normalized": False, "special": True}
                         for i, t in enumerate(DS_SPECIALS)],
        "normalizer": None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": LLAMA3_SPLIT}, "behavior": "Isolated",
             "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
             "use_regex": False}]},
        "post_processor": {"type": "TemplateProcessing",
                           "single": [{"SpecialToken": {"id": DS_SPECIALS[0], "type_id": 0}},
                                      {"Sequence": {"id": "A", "type_id": 0}}],
                           "pair": [],
                           "special_tokens": {DS_SPECIALS[0]: {"id": DS_SPECIALS[0],
                                                               "ids": [n],
                                                               "tokens": [DS_SPECIALS[0]]}}},
        "decoder": {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True,
                    "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": False, "byte_fallback": False, "ignore_merges": True,
                  "vocab": {s(v): i for i, v in enumerate(vocab)},
                  "merges": [f"{s(a)} {s(b)}" for a, b in merges]},
    }
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "tokenizer.json"), "w", encoding="utf-8") as fp:
        json.dump(spec, fp, ensure_ascii=False)
    with open(os.path.join(directory, "tokenizer_config.json"), "w") as fp:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast", "bos_token": DS_SPECIALS[0],
                   "eos_token": DS_SPECIALS[1], "pad_token": DS_SPECIALS[2]}, fp)
    hex_vocab = vocab + [t.encode() for t in DS_SPECIALS]
    return vocab, write_bpe_files(hex_vocab, merges, os.path.join(directory, "hex"))


def encode_rate(tok, lines: list) -> tuple:
    """(MB/s, ids) of encoding ``lines`` one by one with ``tok``."""
    t0 = time.perf_counter()
    ids = [tok.encode(line) for line in lines]
    dt = time.perf_counter() - t0
    return sum(len(x.encode()) for x in lines) / dt / 1e6, ids


DS_CHILD = r'''
import dataclasses, json, sys, threading, time
mode, tokdir, cache_dir, text_path, device, base = sys.argv[1:7]
from gofr_tpu_torch import build_cache
from gofr_tpu_torch.serving import native_tokenizer
from gofr_tpu_torch.serving.tokenizer import tokenizer_from_config
from gofr_tpu_torch.config import MockConfig
out = {"mode": mode}
if mode == "reuse":
    out["cache"] = build_cache.use_dir(cache_dir)
    t0 = time.perf_counter()
    tok = tokenizer_from_config(MockConfig({"TPU_TOKENIZER": tokdir}))
    out["tokenizer_s"] = time.perf_counter() - t0
    out["is_native"] = bool(getattr(tok, "is_native", False))
    out["bpe_build"] = dict(native_tokenizer.last_build)
    from gofr_tpu_torch.ops.cuda import _build
    t0 = time.perf_counter()
    out["kernel_library"] = str(_build.build())
    out["kernel_library_s"] = time.perf_counter() - t0
    print(json.dumps(out))
    sys.exit(0)
import numpy as np
import torch
from gofr_tpu_torch.analysis import lockcheck
from gofr_tpu_torch.models import registry
from gofr_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
from gofr_tpu_torch.serving.engine import InferenceEngine
assert lockcheck.enabled()
spec = registry.get_model(base)
registry.register_model(dataclasses.replace(
    spec, name="llama-3-8b-4l", config=dataclasses.replace(spec.config, n_layers=4)))
syncs = {}
note = lockcheck.note_device_sync
def counted(what):
    syncs[what] = syncs.get(what, 0) + 1
    note(what)
lockcheck.note_device_sync = counted
eng = InferenceEngine.from_config(MockConfig({
    "TPU_MODEL": "llama-3-8b-4l", "TPU_DEVICE": device, "TPU_KV_SLOTS": "8",
    "TPU_MAX_LEN": "2048", "TPU_DECODE_WINDOW": "8", "TPU_PREFILL_CHUNK": "256",
    "TPU_PREFILL_BATCH": "8", "TPU_KV_BLOCK": "32", "TPU_KV_POOL_BLOCKS": "257",
    "TPU_AUTO_PREFIX": "true", "TPU_TOKENIZER": tokdir, "TPU_COMPILE_CACHE_DIR": cache_dir}))
try:
    out["bpe_build"] = dict(native_tokenizer.last_build)
    out["is_native"] = bool(eng.tokenizer.is_native)
    locks = {"InferenceEngine._submit_lock": eng._submit_lock,
             "ClassPriorityQueue._lock": eng._pending._lock,
             "AggregateThroughput._lock": eng._tput._lock,
             "RadixPrefixIndex._lock": eng._radix._lock,
             "CompileTracker._lock": eng._compiles._lock}
    out["instrumented"] = {k: isinstance(v, lockcheck.InstrumentedLock) for k, v in locks.items()}
    text = open(text_path, encoding="utf-8").read()
    system = text[:1600]
    prompts = [system + text[2000 + 500 * i: 2000 + 500 * i + 150 * (i % 4 + 1)] for i in range(16)]
    eng.generate_sync("warm-up", max_new_tokens=2, timeout=600)
    reset_launch_counts()
    errors, results = [], {}
    def client(c):
        try:
            reqs = [(i, eng.submit_generate(prompts[i], max_new_tokens=16, stop_on_eos=False,
                                            temperature=0.7 if i % 4 == 3 else 0.0, seed=i))
                    for i in range(c, 16, 4)]
            for i, r in reqs:
                results[i] = r.future.result(timeout=600).token_ids
        except BaseException as exc:
            errors.append(repr(exc))
    threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    for t in threads: t.start()
    for t in threads: t.join(timeout=600)
    out["errors"] = errors
    out["requests"] = len(results)
    out["counts"] = launch_counts()
    eng.health_check()
    v = lockcheck.violations()
    out["violations"] = len(v)
    out["violation_kinds"] = sorted({x.kind for x in v})
    out["violation_messages"] = [x.message for x in v[:3]]
    out["edges"] = lockcheck.order_graph()["edges"]
    out["syncs"] = syncs
    out["compile_stats"] = eng.compile_stats()
finally:
    eng.close()
print(json.dumps(out))
'''


def run_ds_child(mode: str, tokdir: str, cache_dir: str, text_path: str, lockcheck: bool,
                 device: str = "cuda:0", base: str = "llama-3-8b") -> dict:
    """The device-services child process (``DS_CHILD``), from the repo root;
    its last line of output is its JSON result."""
    import os
    from pathlib import Path

    root = str(Path(__file__).resolve().parent)
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    env["TPU_LOCKCHECK"] = "1" if lockcheck else "0"
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", DS_CHILD, mode, tokdir, cache_dir, text_path,
                           device, base],
                          cwd=root, env=env, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        fail(f"device services: the {mode} child failed ({proc.returncode}):\n"
             + proc.stderr[-4000:])
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    out["wall_s"] = time.perf_counter() - t0
    return out


def ds_wave(eng, prompts: list, kws: list, clients: int = 4) -> tuple:
    """``prompts`` from ``clients`` threads, each submitting its share at
    once and then waiting; returns (the requests, their results) in
    prompt order."""
    reqs: list = [None] * len(prompts)
    results: list = [None] * len(prompts)
    errors: list = []

    def client(c: int) -> None:
        try:
            mine = [(i, eng.submit_generate(prompts[i], **kws[i]))
                    for i in range(c, len(prompts), clients)]
            for i, r in mine:
                reqs[i] = r
                results[i] = r.future.result(timeout=600)
        except BaseException as exc:  # surfaced below
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    if errors or any(r is None for r in results):
        fail(f"device services: a client failed: {errors[:2]}")
    return reqs, results


def phase_device_services(torch, dev, cfg, params) -> dict:
    """The device services on Llama-3-8B at full width (the seed-0 bf16
    weights, equal to ``params`` bit for bit), every check failing the run:
    1. builds the native BPE core; learns DS_MERGES byte-level merges by
       greedy pair count over the repo's Markdown; writes them as the
       core's hex files and as a Llama-3-shaped tokenizer.json; on the
       card's host: the hex tokenizer and the tokenizer.json reader native
       against Python (ids equal, encode MB/s), decode(encode) the text;
    2. serves a mixed wave (16 text prompts sharing a 1,600-character
       system prefix; greedy and seeded sampled; 32 new tokens) from 4
       client threads through an engine built by from_config with
       TPU_TOKENIZER, a bf16 pool of DS_POOL_BLOCKS x 32 with auto_prefix,
       and TPU_PREFIX_EVICT_HBM_FRAC set to derive a DS_WATERMARK-block
       watermark from the card's own budget; no stream sync; the kernels'
       launch counters over the wave;
    3. prints the HBM ledger (components, budget and source) beside
       torch.cuda.memory_allocated() and explains the gap (rope tables,
       the CUDA graphs' pool); the headroom; the derived watermark and the
       free blocks the sweep keeps; the captures per program and their
       seconds; then mark_steady_state and a second wave (prefix hits):
       steady_state_recompiles 0, greedy streams equal the first wave's
       (near-tie rule);
    4. raises admit_min_headroom above the measured headroom: a submit
       sheds 429 with reason hbm_headroom; then the profiler repair check
       (``profiler_under_replays``): a 200 ms capture while the engine
       replays decode windows traces their flash_decode launches;
    5. one profiler_capture of ~200 ms beside eager forwards (the engine
       closed): the trace's kernels;
    6. a child with TPU_LOCKCHECK=1 (the same widths, 4 layers, the same
       traffic from 4 threads): 0 violations, the locks instrumented; a
       second child on the same TPU_COMPILE_CACHE_DIR reuses the BPE core
       (and the kernel library) built there without compiling.
    Returns the launch counts and the numbers printed."""
    import os
    import shutil
    import tempfile

    from gofr_tpu_torch.config import MockConfig
    from gofr_tpu_torch.container import Container
    from gofr_tpu_torch.ops.cuda import _build, launch_counts, reset_launch_counts
    from gofr_tpu_torch.serving import native_tokenizer as nt
    from gofr_tpu_torch.serving.engine import InferenceEngine
    from gofr_tpu_torch.serving.hf_tokenizer import HFTokenizer
    from gofr_tpu_torch.serving.profiler_capture import get_capture
    from gofr_tpu_torch.serving.tokenizer import tokenizer_from_config

    label = "device services"
    out: dict = {"counts": {}}
    t_phase = time.perf_counter()
    so = nt.build_native()
    if so is None:
        fail(f"{label}: the native BPE core did not build (g++)")
    log(f"{label}: native BPE core {os.path.basename(so)} "
        f"({'compiled' if nt.last_build['compiled'] else 'reused'} in "
        f"{nt.last_build['seconds']:.2f} s)")
    text = repo_markdown()
    t0 = time.perf_counter()
    merges = learn_merges(text, DS_MERGES)
    log(f"{label}: learned {len(merges)} merges over {len(text.encode())} bytes of the "
        f"repo's Markdown in {time.perf_counter() - t0:.1f} s")
    if len(merges) != DS_MERGES:
        fail(f"{label}: only {len(merges)} merges learned")
    work = tempfile.mkdtemp(prefix="chip_smoke_tok_")
    try:
        tokdir = os.path.join(work, "llama3_shape")
        vocab, hex_files = write_llama3_tokenizer(tokdir, merges)
        text_path = os.path.join(work, "markdown.txt")
        with open(text_path, "w", encoding="utf-8") as fp:
            fp.write(text)
        hf = tokenizer_from_config(MockConfig({"TPU_TOKENIZER": tokdir}))
        if not isinstance(hf, HFTokenizer) or not hf.is_native:
            fail(f"{label}: TPU_TOKENIZER did not load natively ({type(hf).__name__})")
        hf_py = HFTokenizer(tokdir, prefer_native=False)
        hx, hx_py = nt.load_bpe(*hex_files), nt.load_bpe(*hex_files, prefer_native=False)
        if not hx.is_native:
            fail(f"{label}: the hex-file tokenizer is not native")
        lines, size = [], 0
        for line in text.split("\n"):
            if line and size < DS_RATE_BYTES:
                lines.append(line)
                size += len(line.encode())
        rates = {}
        for name, a, b in (("tokenizer.json", hf, hf_py), ("hex files", hx, hx_py)):
            ra, ia = encode_rate(a, lines)
            rb, ib = encode_rate(b, lines)
            if ia != ib:
                fail(f"{label}: {name}: native and Python ids differ")
            rates[name] = {"native_MB_s": ra, "python_MB_s": rb, "speedup": ra / rb}
        bad = [ln for ln in lines if hf.decode(hf.encode(ln)) != ln]
        if bad:
            fail(f"{label}: decode(encode(text)) differs on {len(bad)} lines: {bad[0]!r}")
        n_ids = sum(len(hf.encode(ln)) - 1 for ln in lines)
        log(f"{label}: encode over {size} bytes ({len(lines)} lines, "
            f"{size / max(n_ids, 1):.2f} bytes a token) on the card's host: "
            + json.dumps(rates))
        out["rates"] = rates

        # The watermark: TPU_PREFIX_EVICT_HBM_FRAC set so the ledger derives
        # DS_WATERMARK blocks from the card's own budget.
        # The engine's workspace is its cache lengths, block table and slot
        # planes, made here alike to size the ledger before the engine.
        from gofr_tpu_torch.serving.device_telemetry import tree_device_bytes
        from gofr_tpu_torch.serving.programs import SamplerFlags, SlotPlanes

        budget = torch.cuda.mem_get_info(dev)[1]
        bb = cfg.n_layers * kv_bytes(32, cfg.n_kv_heads, cfg.head_dim, False)
        workspace = tree_device_bytes([
            SlotPlanes.create(8, dev, cfg.vocab_size, SamplerFlags()),
            torch.zeros((8, 2048 // 32), dtype=torch.int32),
            torch.zeros((8,), dtype=torch.int32)])
        est = (sum(p.numel() * p.element_size() for p in params.values())
               + DS_POOL_BLOCKS * bb + workspace)
        frac = (budget - est + (DS_WATERMARK + 0.5) * bb) / budget
        metrics = Container.create(MockConfig({"APP_NAME": "chip-smoke"})).metrics
        captured = {}
        real_capture = InferenceEngine._capture_graphs

        def capture_graphs(self):  # the graphs' memory, measured around the captures
            m0 = torch.cuda.memory_allocated(dev)
            real_capture(self)
            captured["bytes"] = torch.cuda.memory_allocated(dev) - m0

        gc.collect()
        torch.cuda.empty_cache()
        m_before = torch.cuda.memory_allocated(dev)
        InferenceEngine._capture_graphs = capture_graphs
        try:
            eng = InferenceEngine.from_config(MockConfig({
                "TPU_MODEL": "llama-3-8b", "TPU_DEVICE": str(dev), "TPU_KV_SLOTS": "8",
                "TPU_MAX_LEN": "2048", "TPU_DECODE_WINDOW": "8", "TPU_PREFILL_CHUNK": "256",
                "TPU_PREFILL_BATCH": "8", "TPU_KV_BLOCK": "32",
                "TPU_KV_POOL_BLOCKS": str(DS_POOL_BLOCKS), "TPU_AUTO_PREFIX": "true",
                "TPU_TOKENIZER": tokdir, "TPU_PREFIX_EVICT_HBM_FRAC": repr(frac),
            }), metrics=metrics)
            eng.generate_sync("warm-up", max_new_tokens=2, timeout=600)
        finally:
            InferenceEngine._capture_graphs = real_capture
        try:
            torch.cuda.synchronize()
            m_engine = torch.cuda.memory_allocated(dev) - m_before
            if not isinstance(eng.tokenizer, HFTokenizer) or not eng.tokenizer.is_native:
                fail(f"{label}: the engine does not serve the native tokenizer.json reader")
            ledger = eng.hbm_ledger()
            comps = ledger["components"]
            rope = sum(t.numel() * t.element_size() for t in eng.rope)
            log(f"{label}: HBM ledger {json.dumps(ledger)}")
            gap = m_engine - ledger["per_device_bytes"]
            log(f"{label}: ledger per_device_bytes {ledger['per_device_bytes']} beside "
                f"torch.cuda.memory_allocated() {torch.cuda.memory_allocated(dev)} (this "
                f"engine's share {m_engine}; the rest is the script's own llama-3-8b "
                f"weights and earlier phases' tensors): gap {gap} bytes = the rope tables "
                f"{rope} + the CUDA graphs' pool {captured.get('bytes')} + "
                f"{gap - rope - captured.get('bytes', 0)} other (the graphs' static "
                "outputs and the warm-up's live blocks)")
            if comps["kv_pool"] != eng.cache.hbm_bytes() or comps["kv_pool"] != DS_POOL_BLOCKS * bb:
                fail(f"{label}: kv_pool {comps['kv_pool']} is not the pool's bytes")
            if comps["params"] != sum(p.numel() * p.element_size() for p in params.values()):
                fail(f"{label}: the ledger's params {comps['params']} are not the weights' bytes")
            if ledger["budget_source"] != "memory_stats" or ledger["budget_bytes"] != budget:
                fail(f"{label}: budget {ledger['budget_bytes']} ({ledger['budget_source']}), "
                     f"not the card's {budget}")
            wm = eng.effective_evict_watermark
            if wm != eng._ledger.derive_block_watermark(frac) or not (
                    DS_WATERMARK <= wm <= DS_WATERMARK + 1):
                fail(f"{label}: derived watermark {wm}, want {DS_WATERMARK} from frac {frac}")
            gauges = {i.name: i.collect() for i in metrics.instruments()}
            published = {dict(k)["component"]: v for k, v in gauges["app_tpu_hbm_bytes"].items()}
            if published != {k: float(v) for k, v in comps.items()}:
                fail(f"{label}: app_tpu_hbm_bytes {published} differs from the ledger")
            log(f"{label}: headroom {eng.hbm_headroom_ratio():.6f} over a "
                f"{ledger['budget_bytes']}-byte budget; TPU_PREFIX_EVICT_HBM_FRAC {frac:.6f} "
                f"derives a watermark of {wm} free blocks of {bb} bytes")
            stats = eng.compile_stats()
            log(f"{label}: captures per program (compiles, seconds): " + json.dumps(
                {p: [e["compiles"], e["seconds_total"]] for p, e in stats["programs"].items()}))
            if stats["total"] < 4:
                fail(f"{label}: {stats['total']} compiles counted, want the 4 window graphs")

            # The mixed wave, twice: cold, then (past the fence) warm.
            system = text[:1600]
            suffixes = [text[2000 + 700 * i: 2000 + 700 * i + 100 + 60 * (i % 8)]
                        for i in range(16)]
            prompts = [system + sfx if i % 4 != 1 else sfx for i, sfx in enumerate(suffixes)]
            kws = [dict(max_new_tokens=32, stop_on_eos=False,
                        temperature=0.8 if i % 4 == 3 else 0.0, seed=100 + i)
                   for i in range(16)]
            ids = [eng.tokenizer.encode(p) for p in prompts]
            greedy = [kw["temperature"] == 0.0 for kw in kws]
            waves = {}
            for wave in ("cold", "warm"):
                if wave == "warm":
                    eng.mark_steady_state()
                reset_launch_counts()
                lookups0, hits0 = eng._prefix_lookups, eng._prefix_hit_tokens
                count_syncs(torch, True)
                t0 = time.perf_counter()
                reqs, results = ds_wave(eng, prompts, kws)
                wall = time.perf_counter() - t0
                syncs = count_syncs(torch, False)
                counts = launch_counts()
                if syncs:
                    fail(f"{label}: {syncs} stream syncs in the {wave} wave; the first at\n"
                         + "\n".join(SYNCS["first"]))
                for name in ("flash_decode", "flash_cache_attention"):
                    if counts[name] <= 0:
                        fail(f"{label}: kernel {name} was not launched in the {wave} wave")
                for i, r in enumerate(results):
                    if len(r.token_ids) != 32 or not all(math.isfinite(x) for x in r.token_logprobs):
                        fail(f"{label}: {wave} request {i}: {len(r.token_ids)} tokens or "
                             "non-finite logprobs")
                    if r.prompt_tokens != len(ids[i]):
                        fail(f"{label}: {wave} request {i} prompt {r.prompt_tokens} tokens, "
                             f"the tokenizer gives {len(ids[i])}")
                time.sleep(0.2)  # idle passes run the watermark sweep
                pool_invariant(eng, f"{label} {wave} wave")
                total, used, cached = eng.kv_pool_counts()
                free = eng._allocator.n_free
                if free < min(wm, total):
                    fail(f"{label}: {free} free blocks after the {wave} wave, below the "
                         f"watermark {wm}")
                waves[wave] = {"results": results, "counts": counts, "wall_s": wall,
                               "free": free, "cached": cached, "evicted": eng._radix.evicted,
                               "hit_tokens": eng._prefix_hit_tokens - hits0,
                               "lookups": eng._prefix_lookups - lookups0,
                               "peak_blocks": eng.kv_blocks_peak, **serve_stats(reqs, wall)}
                log(f"{label}: {wave} wave of 16 requests from 4 threads in {wall:.3f} s "
                    f"({waves[wave]['tok_s']:.1f} tok/s, TTFT p50 "
                    f"{waves[wave]['ttft_p50_ms']:.1f} ms, ITL p50 "
                    f"{waves[wave]['itl_p50_ms']:.2f} ms): launches "
                    f"{counts}, prefix lookups {waves[wave]['lookups']} with "
                    f"{waves[wave]['hit_tokens']} hit tokens, {free} free blocks kept after "
                    f"the sweep (watermark {wm}), {cached} cached, {eng._radix.evicted} "
                    f"evicted so far, peak {eng.kv_blocks_peak} in use")
                out["counts"][f"serve llama-3-8b TPU_TOKENIZER {wave} wave"] = counts
            stats = eng.compile_stats()
            log(f"{label}: after mark_steady_state and the warm wave: "
                f"{stats['steady_state_recompiles']} steady-state recompiles, "
                f"{stats['total']} compiles in all")
            if stats["steady_state_recompiles"] != 0:
                fail(f"{label}: {stats['steady_state_recompiles']} steady-state recompiles")
            gi = [i for i in range(16) if greedy[i]]
            check_streams(torch, cfg, params, f"{label} greedy, warm vs cold",
                          [ids[i] for i in gi],
                          [waves["cold"]["results"][i].token_ids for i in gi],
                          [waves["warm"]["results"][i].token_ids for i in gi], [True] * len(gi))
            same = sum(waves["cold"]["results"][i].token_ids
                       == waves["warm"]["results"][i].token_ids
                       for i in range(16) if not greedy[i])
            log(f"{label}: seeded sampled, warm vs cold: {same} of {16 - len(gi)} streams "
                "equal (a prefix hit changes the chunking, so not required)")
            texts = [r.text for r in waves["cold"]["results"]]
            log(f"{label}: decoded texts' lengths {[len(t) for t in texts]} (ids past the "
                f"tokenizer's {hf.vocab_size} decode to nothing)")

            # Admission below the headroom floor.
            headroom = eng.hbm_headroom_ratio()
            eng.admit_min_headroom = headroom + 0.01
            from gofr_tpu_torch.errors import ErrorTooManyRequests

            try:
                eng.submit_generate("shed me", max_new_tokens=4)
                fail(f"{label}: a submit below the headroom floor was admitted")
            except ErrorTooManyRequests as exc:
                log(f"{label}: admit_min_headroom {eng.admit_min_headroom:.6f} above the "
                    f"headroom {headroom:.6f}: {exc.status_code} {exc} (Retry-After "
                    f"{exc.headers['Retry-After']}), shed counts {dict(eng.shed_counts)}")
                if exc.status_code != 429 or eng.shed_counts["hbm_headroom"] != 1:
                    fail(f"{label}: the shed is not a 429 hbm_headroom")
            eng.admit_min_headroom = 0.0

            # The profiler repair check: a capture while this engine
            # replays its decode windows.
            out["profiler_under_replays"] = profiler_under_replays(torch, eng, label)

            out["ledger"] = ledger
            out["compiles"] = stats
        finally:
            eng.close()

        # One profiler capture (its own thread, 200 ms) while this thread runs
        # eager forwards through the kernels, after the engine closed (no
        # scheduler to hand the start to). The trace must hold the
        # forwards' flash_attention launches; a trace with no kernel (the
        # profiler once traced none on an H100, PR 10) is taken once more.
        from gofr_tpu_torch.models.transformer import transformer_forward

        cap = get_capture(cooldown_s=0)
        ids = torch.tensor([hf.encode(text[:2400])[:512]], device=dev)
        for attempt in (1, 2):
            with torch.inference_mode():
                transformer_forward(params, ids, cfg)  # warm
                torch.cuda.synchronize()
                if not cap.trigger(200, reason="chip_smoke"):
                    fail(f"{label}: the profiler capture did not start: {cap.snapshot()}")
                forwards, deadline = 0, time.perf_counter() + 60
                while cap.busy and time.perf_counter() < deadline:
                    transformer_forward(params, ids, cfg)
                    torch.cuda.synchronize()
                    forwards += 1
            snap = cap.snapshot()
            if cap.busy or snap["last_error"] or not os.path.exists(cap.trace_file):
                fail(f"{label}: no profiler trace written within 60 s: {snap}")
            with open(cap.trace_file) as fp:
                events = json.load(fp).get("traceEvents", [])
            kernels = collections.Counter(e.get("name", "")[:60] for e in events
                                          if e.get("cat") == "kernel")
            flash = {k: v for k, v in kernels.items() if "flash" in k}
            if kernels or attempt == 2:
                break
            log(f"{label}: profiler capture {attempt} traced no kernel "
                f"({len(events)} events); taking it once more")
        if not any("flash_attention" in k for k in flash):
            fail(f"{label}: the profiler trace holds no flash_attention launch beside "
                 f"{forwards} eager forwards: {sum(kernels.values())} kernels, "
                 + json.dumps(kernels.most_common(8)))
        log(f"{label}: profiler_capture of 200 ms beside {forwards} eager forwards "
            f"[1, {ids.shape[1]}] wrote {cap.trace_file} "
            f"({os.path.getsize(cap.trace_file)} bytes, {len(events)} events, "
            f"{sum(kernels.values())} kernel launches): top kernels "
            + json.dumps(kernels.most_common(8)) + "; the port's kernels " + json.dumps(flash))
        out["trace_kernels"] = dict(kernels.most_common(8))
        out["trace_flash_kernels"] = flash

        # The children: lockcheck at 4 layers, then the build directory's
        # reuse across processes.
        cache_dir = os.path.join(work, "compile_cache")
        os.makedirs(cache_dir)
        lib = _build.build()
        shutil.copy(lib, os.path.join(cache_dir, os.path.basename(lib)))
        child = run_ds_child("lockcheck", tokdir, cache_dir, text_path, lockcheck=True,
                             device=str(dev))
        log(f"{label}: TPU_LOCKCHECK=1 child (llama-3-8b widths, 4 layers, 16 requests "
            f"from 4 threads, {child['wall_s']:.1f} s): {child['violations']} violations "
            f"{child['violation_kinds']}, locks instrumented {child['instrumented']}, "
            f"order edges {child['edges']}, device-sync seams {child['syncs']}, launches "
            f"{child['counts']}, BPE core {child['bpe_build']}, compiles "
            + json.dumps(child["compile_stats"]))
        if child["violations"] or child["errors"] or child["requests"] != 16:
            fail(f"{label}: the lockcheck child: {child}")
        if not all(child["instrumented"].values()) or "decode_window_fetch" not in child["syncs"]:
            fail(f"{label}: the lockcheck child did not watch the engine: {child}")
        for name in ("flash_decode", "flash_cache_attention"):
            if child["counts"][name] <= 0:
                fail(f"{label}: kernel {name} was not launched in the lockcheck child")
        reuse = run_ds_child("reuse", tokdir, cache_dir, text_path, lockcheck=False,
                             device=str(dev))
        log(f"{label}: TPU_COMPILE_CACHE_DIR child ({reuse['wall_s']:.1f} s): cache "
            f"{reuse['cache']}, BPE core {reuse['bpe_build']} (the lockcheck child "
            f"compiled it: {child['bpe_build']['compiled']}), kernel library "
            f"{os.path.basename(reuse['kernel_library'])} in {reuse['kernel_library_s']:.3f} s")
        real = os.path.realpath(cache_dir)
        if not (child["bpe_build"]["compiled"] and not reuse["bpe_build"]["compiled"]
                and reuse["bpe_build"]["path"].startswith(real)
                and reuse["kernel_library"].startswith(real) and reuse["is_native"]):
            fail(f"{label}: the build directory was not reused: {child['bpe_build']}, {reuse}")
        out["counts"]["lockcheck child llama-3-8b 4 layers"] = child["counts"]
        out["children"] = {"lockcheck": child, "reuse": reuse}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"phase_device_services done in {time.perf_counter() - t_phase:.1f} s")
    return out


# -- the encoder and vision families, family training, the profiler repair --

ENC_REQUESTS = 64
ENC_MAX_BATCH = 8
ENC_WAIT_MS = 5
# ResNet-50 on the card against the same forward on the card's host CPU
# (f32 after a bf16 stem on both; the bf16 stem may round a value one ulp
# apart, which the f32 net then carries): max |dlogits| within this share
# of the largest |logit|, and the same top-1 unless the top-2 gap on the
# host is under it. The same bound holds one image's logits served in a
# batch of 8 against the same image served alone (cuDNN picks another
# algorithm per batch size).
RESNET_DLOGITS_REL = 1e-2
# BERT-base through /v1/embeddings against bert_embed run directly on the
# flush's own padded batch: the same inputs through the same kernels.
EMBED_EQUAL_TOL = 1e-6
# A profiler capture of 200 ms under the serving engine must have written
# its trace this long after its window ends; the watchdog ends the run
# after PROFILER_WATCHDOG_S, so a hang costs that, not the run's limit.
PROFILER_END_S = 5.0
PROFILER_WATCHDOG_S = 120.0


def _forward_ms(torch, fn) -> float | None:
    """Device time of one model forward: ``device_ms`` over one call (a
    forward launches hundreds of kernels, and the queued fallback must fit
    them all behind its spin kernel); None (not measured) where neither
    way can time it."""
    return device_ms(torch, fn, runs=1, required=False)


def _ms(x: float | None) -> str:
    return "not measured" if x is None else f"{x:.3f} ms"


def _pcts(lat_s: list) -> tuple:
    lat = sorted(lat_s)
    return (statistics.median(lat) * 1e3,
            lat[min(len(lat) - 1, math.ceil(0.99 * len(lat)) - 1)] * 1e3)


def _record_flushes(eng) -> list:
    """Every flush the engine's batcher runs from now on: (payloads,
    results)."""
    flushes = []
    inner = eng._batcher._execute

    def recorded(payloads):
        out = inner(payloads)
        flushes.append((list(payloads), out))
        return out

    eng._batcher._execute = recorded
    return flushes


def _fan_out(fn, items: list) -> tuple[list, list, float]:
    """``fn(item)`` for every item at once, each from its own thread:
    (results in order, each call's latency in s, wall s)."""
    out, lat = [None] * len(items), [0.0] * len(items)
    errors = []
    start = threading.Barrier(len(items) + 1)

    def run(i):
        start.wait()
        t0 = time.perf_counter()
        try:
            out[i] = fn(items[i])
        except Exception as exc:  # reported below as a failed check
            errors.append(repr(exc))
        lat[i] = time.perf_counter() - t0

    threads = [threading.Thread(target=run, args=(i,), daemon=True) for i in range(len(items))]
    for t in threads:
        t.start()
    t0 = time.perf_counter()
    start.wait()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        fail(f"{len(errors)} of {len(items)} concurrent calls failed: {errors[:3]}")
    return out, lat, wall


def _flush_histogram(flushes: list) -> dict:
    return dict(sorted(collections.Counter(len(p) for p, _ in flushes).items()))


def _serve_line(label: str, lat: list, wall: float, flushes: list, extra: str = "") -> dict:
    p50, p99 = _pcts(lat)
    stats = {"requests": len(lat), "req_s": len(lat) / wall, "p50_ms": p50, "p99_ms": p99,
             "batch_sizes": _flush_histogram(flushes)}
    log(f"{label}: {len(lat)} requests in {wall:.3f} s: {stats['req_s']:.1f} req/s, latency "
        f"p50 {p50:.2f} ms, p99 {p99:.2f} ms; batch sizes {stats['batch_sizes']}" + extra)
    return stats


def _nested_to(torch, tree, device):
    if isinstance(tree, dict):
        return {k: _nested_to(torch, v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_nested_to(torch, v, device) for v in tree]
    return tree.to(device)


def _app_harness(config: dict):
    """The port's App from ``config`` on an event-loop thread: (app,
    loop, stop())."""
    import asyncio

    from gofr_tpu_torch import App
    from gofr_tpu_torch.config import MockConfig

    app = App(config=MockConfig({"APP_NAME": "chip-smoke", "HTTP_PORT": "0",
                                 "METRICS_PORT": "0", "LOG_LEVEL": "WARN", **config}))
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, name="enc-http-loop", daemon=True)
    thread.start()

    def stop():
        try:
            asyncio.run_coroutine_threadsafe(app.stop(), loop).result(timeout=120)
        finally:
            loop.call_soon_threadsafe(loop.stop)
            thread.join(timeout=10)

    return app, loop, stop


def _http_raw(port: int, path: str, body: bytes, ctype: str):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", path, body=body, headers={"Content-Type": ctype})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def phase_encoders(torch, dev) -> dict:
    """The encoder and vision families at full width on the card, each
    behind the port's dynamic batcher (random weights from seed 0):

    1. ResNet-50 (f32 after its bf16 stem, as the reference; TF32 off) at
       static batch 1 (BASELINE config 2: one request at a time), held
       against the same forward on the card's host CPU (RESNET_DLOGITS_REL,
       top-1); then ENC_REQUESTS concurrent classify requests through the
       batcher (max_batch 8, 5 ms), each held against its batch-1 logits;
       then the same over HTTP: the App from TPU_MODEL=resnet-50 and a
       route that calls ctx.infer on the [224, 224, 3] f32 image posted as
       raw bytes, each response against the engine's logits;
    2. BERT-base as TPU_EMBED_MODEL beside a chat model (TPU_MODEL=
       llama-1b): ENC_REQUESTS concurrent /v1/embeddings requests of 8 to
       500 tokens; batch sizes above 1 (coalescing); every vector equal
       (EMBED_EQUAL_TOL) to bert_embed run directly on its flush's padded
       batch; unit norm;
    3. ViT-B/16 at [8, 224, 224, 3]: the kernel path against the dense
       plain path (FORWARD_DLOGITS_TOL, top-1), flash_attention launched 12
       times a forward; ENC_REQUESTS concurrent requests, 12 launches a
       flush.
    Each prints requests/s, latency p50/p99, the batch sizes, the device
    time of a forward and the peak memory. Returns the numbers and the
    flash_attention launches."""
    import numpy as np

    from gofr_tpu_torch.models.bert import bert_embed
    from gofr_tpu_torch.models.resnet import resnet_forward
    from gofr_tpu_torch.models.vit import vit_forward
    from gofr_tpu_torch.ops.cuda import flash_attention as fa
    from gofr_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from gofr_tpu_torch.serving.batcher import pad_bucket
    from gofr_tpu_torch.serving.device_telemetry import tree_device_bytes
    from gofr_tpu_torch.serving.engine import InferenceEngine
    from gofr_tpu_torch.serving.types import _PREFILL_BUCKETS

    t_phase = time.perf_counter()
    out: dict = {}
    rng = np.random.default_rng(0)
    images = rng.standard_normal((16, 224, 224, 3)).astype(np.float32)
    batched = dict(max_batch=ENC_MAX_BATCH, max_wait_s=ENC_WAIT_MS / 1e3)

    # -- 1. ResNet-50 ------------------------------------------------------
    label = "encoders resnet-50"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = InferenceEngine("resnet-50", max_batch=1, max_wait_s=ENC_WAIT_MS / 1e3, device=dev)
    try:
        cfg, params = eng.cfg, eng.params
        n_params = tree_device_bytes(params) // 4  # every leaf f32
        eng.classify_sync(images[0])  # warm (cuDNN picks its algorithms)
        flushes = _record_flushes(eng)
        one, lat = [], []
        t0 = time.perf_counter()
        for img in images:
            t1 = time.perf_counter()
            one.append(eng.classify_sync(img))
            lat.append(time.perf_counter() - t1)
        wall = time.perf_counter() - t0
        x1 = torch.from_numpy(images[:1]).to(dev)
        x8 = torch.from_numpy(images[:8]).to(dev)
        with torch.inference_mode():
            ms1 = _forward_ms(torch, lambda: resnet_forward(params, x1, cfg))
            ms8 = _forward_ms(torch, lambda: resnet_forward(params, x8, cfg))
        out["resnet-50 batch 1"] = _serve_line(
            f"{label}, static batch 1", lat, wall, flushes,
            f"; device {_ms(ms1)} a [1, 224, 224, 3] forward, {_ms(ms8)} a [8, ...] "
            f"({n_params / 1e6:.2f} M parameters, f32 after the bf16 stem; device time by "
            f"{DEVICE_TIMER['by']})")
        out["resnet-50 batch 1"].update(device_ms_b1=ms1, device_ms_b8=ms8)
        host = _nested_to(torch, params, "cpu")
        with torch.inference_mode():
            want = resnet_forward(host, torch.from_numpy(images[:2]), cfg).numpy()
        got = np.stack(one[:2])
        d = float(np.abs(got - want).max())
        scale = float(np.abs(want).max())
        top2 = np.sort(want, axis=-1)[:, -2:]
        same = bool((got.argmax(-1) == want.argmax(-1)).all())
        log(f"{label}: the card against the host CPU on 2 images: max|dlogits| {d:.4g} "
            f"(limit {RESNET_DLOGITS_REL} x {scale:.4g}), top-1 equal {same} (top-2 gaps "
            f"{(top2[:, 1] - top2[:, 0]).round(4).tolist()})")
        if d > RESNET_DLOGITS_REL * scale or not (
                same or (top2[:, 1] - top2[:, 0]).min() < RESNET_DLOGITS_REL * scale):
            fail(f"{label}: the card's logits disagree with the host's")
        if not np.isfinite(np.stack(one)).all():
            fail(f"{label}: non-finite logits")
    finally:
        eng.close()
    eng = InferenceEngine("resnet-50", device=dev, params=params, **batched)
    try:
        eng.classify_sync(images[0])
        for n in (1, 2, 4, 8):  # warm every batch size cuDNN will see
            eng._classify_step(params, torch.from_numpy(images[:n]).to(dev))
        flushes = _record_flushes(eng)
        items = [images[i % 16] for i in range(ENC_REQUESTS)]
        res, lat, wall = _fan_out(eng.classify_sync, items)
        peak = torch.cuda.max_memory_allocated()
        worst = max(float(np.abs(r - one[i % 16]).max()) for i, r in enumerate(res))
        out["resnet-50 batcher"] = _serve_line(
            f"{label}, batcher (max_batch {ENC_MAX_BATCH}, {ENC_WAIT_MS} ms)", lat, wall, flushes,
            f"; against batch 1 max|dlogits| {worst:.4g}; peak memory "
            f"{peak / 2**30:.3f} GiB")
        if worst > RESNET_DLOGITS_REL * scale:
            fail(f"{label}: a batched request's logits differ from its batch-1 logits")
        if max(len(p) for p, _ in flushes) < 2:
            fail(f"{label}: the batcher coalesced nothing")
    finally:
        eng.close()
    app, loop, stop = _app_harness({"TPU_MODEL": "resnet-50", "TPU_DEVICE": str(dev),
                                    "TPU_MAX_BATCH": str(ENC_MAX_BATCH),
                                    "TPU_BATCH_WAIT_MS": str(ENC_WAIT_MS)})
    try:
        import asyncio

        @app.post("/classify")
        async def classify(ctx):
            img = np.frombuffer(ctx.request.raw.body, np.float32).reshape(224, 224, 3)
            return await ctx.infer(img)

        asyncio.run_coroutine_threadsafe(app.start(), loop).result(timeout=120)
        heng = app.container.tpu
        if heng.family != "vision" or heng.device != dev:
            fail(f"{label}: the App's engine is {heng.family} on {heng.device}")
        _http_raw(app.http_port, "/classify", images[0].tobytes(), "application/octet-stream")
        flushes = _record_flushes(heng)
        res, lat, wall = _fan_out(lambda img: _http_raw(
            app.http_port, "/classify", img.tobytes(), "application/octet-stream"), items)
        worst = 0.0
        for i, (status, raw) in enumerate(res):
            if status != 201:
                fail(f"{label}: HTTP {status}: {raw[:200]}")
            data = json.loads(raw)["data"]
            worst = max(worst, float(np.abs(np.asarray(data["logits"]) - one[i % 16]).max()))
            if data["class"] != int(np.argmax(data["logits"])):
                fail(f"{label}: the class is not the argmax of the logits")
        out["resnet-50 http"] = _serve_line(
            f"{label}, over HTTP (App, TPU_MODEL=resnet-50, ctx.infer; client clock)", lat,
            wall, flushes, f"; against batch 1 max|dlogits| {worst:.4g}")
        if worst > RESNET_DLOGITS_REL * scale:
            fail(f"{label}: an HTTP response's logits differ from the engine's")
    finally:
        stop()
    del params, host, app, stop, heng
    gc.collect()
    torch.cuda.empty_cache()

    # -- 2. BERT-base as TPU_EMBED_MODEL beside a chat model -------------------
    label = "encoders bert-base"
    torch.cuda.reset_peak_memory_stats()
    app, loop, stop = _app_harness({
        "TPU_MODEL": "llama-1b", "TPU_DEVICE": str(dev), "TPU_KV_SLOTS": "4",
        "TPU_MAX_LEN": "1024", "TPU_EMBED_MODEL": "bert-base",
        "TPU_MAX_BATCH": str(ENC_MAX_BATCH), "TPU_BATCH_WAIT_MS": str(ENC_WAIT_MS)})
    try:
        import asyncio

        from gofr_tpu_torch.serving.openai_compat import add_openai_routes

        add_openai_routes(app)
        asyncio.run_coroutine_threadsafe(app.start(), loop).result(timeout=120)
        emb = app.container.tpu_embed
        if emb is None or emb.family != "encoder" or emb.device != dev:
            fail(f"{label}: no encoder engine on {dev}")
        words = np.array(list("abcdefghijklmnopqrstuvwxyz     "))
        texts = ["".join(rng.choice(words, n - 1)) for n in rng.integers(8, 501, ENC_REQUESTS)]
        port = app.http_port
        _http_json(port, "POST", "/v1/embeddings", {"input": texts[0]})  # warm
        flushes = _record_flushes(emb)
        res, lat, wall = _fan_out(lambda t: _http_json(
            port, "POST", "/v1/embeddings", {"input": t}), texts)
        vectors = {}
        for text, (status, raw) in zip(texts, res):
            if status != 200:
                fail(f"{label}: /v1/embeddings {status}: {raw[:200]}")
            vectors[text] = np.asarray(json.loads(raw)["data"][0]["embedding"], np.float32)
    finally:
        stop()
    del app, stop  # the chat model's engine with it
    gc.collect()
    torch.cuda.empty_cache()
    # Held and timed with the App stopped: no engine thread beside the
    # profiler.
    worst, n_tok = 0.0, []
    with torch.inference_mode():
        for payloads, results in flushes:
            ids = [emb.tokenizer.encode(t)[: emb.max_len] for t in payloads]
            bucket = min(pad_bucket(max(len(e) for e in ids), _PREFILL_BUCKETS), emb.max_len)
            tokens = torch.zeros((len(ids), bucket), dtype=torch.long)
            mask = torch.zeros((len(ids), bucket), dtype=torch.long)
            for i, e in enumerate(ids):
                tokens[i, : len(e)] = torch.tensor(e)
                mask[i, : len(e)] = 1
                n_tok.append(len(e))
            direct = bert_embed(emb.params, tokens.to(dev), mask.to(dev), emb.cfg).cpu()
            for i, text in enumerate(payloads):
                worst = max(worst, float(np.abs(direct[i].numpy() - results[i]).max()),
                            float(np.abs(vectors[text] - results[i]).max()))
        x = torch.randint(0, emb.cfg.vocab_size, (ENC_MAX_BATCH, emb.max_len), device=dev)
        m = torch.ones_like(x)
        ms = _forward_ms(torch, lambda: bert_embed(emb.params, x, m, emb.cfg))
    norms = [float(np.linalg.norm(v)) for v in vectors.values()]
    peak = torch.cuda.max_memory_allocated()
    out["bert-base embeddings"] = _serve_line(
        f"{label}, TPU_EMBED_MODEL beside TPU_MODEL=llama-1b, /v1/embeddings (client clock)",
        lat, wall, flushes,
        f"; {min(n_tok)}-{max(n_tok)} tokens; each vector against bert_embed on its "
        f"flush's padded batch max|d| {worst:.3g} (limit {EMBED_EQUAL_TOL}); norms "
        f"{min(norms):.6f}-{max(norms):.6f}; device {_ms(ms)} a [8, {emb.max_len}] "
        f"bert_embed; peak "
        f"memory {peak / 2**30:.3f} GiB (llama-1b's engine included)")
    out["bert-base embeddings"]["device_ms_8xmax_len"] = ms
    if max(len(p) for p, _ in flushes) < 2:
        fail(f"{label}: the batcher coalesced nothing")
    if worst > EMBED_EQUAL_TOL or abs(min(norms) - 1) > 1e-4 or abs(max(norms) - 1) > 1e-4:
        fail(f"{label}: the served vectors differ from bert_embed on their batch")
    del emb, x, m
    gc.collect()
    torch.cuda.empty_cache()

    # -- 3. ViT-B/16 ------------------------------------------------------------
    label = "encoders vit-base"
    torch.cuda.reset_peak_memory_stats()
    eng = InferenceEngine("vit-base", device=dev, **batched)
    try:
        cfg, params = eng.cfg, eng.params
        x8 = torch.from_numpy(images[:8]).to(dev)
        with torch.inference_mode():
            reset_launch_counts()
            got = vit_forward(params, x8, cfg)
            per_forward = fa.launches
            want = vit_forward(params, x8, cfg, dense_attn=True)
            ms = _forward_ms(torch, lambda: vit_forward(params, x8, cfg))
            plain_ms = _forward_ms(torch, lambda: vit_forward(params, x8, cfg, dense_attn=True))
        d = (got - want).abs().max().item()
        top2 = want.sort(-1).values[:, -2:]
        same = bool((got.argmax(-1) == want.argmax(-1)).all())
        log(f"{label}: [8, 224, 224, 3] kernel path against the dense plain path: "
            f"max|dlogits| {d:.4g} (limit {FORWARD_DLOGITS_TOL}; logits "
            f"{want.min().item():.3g}..{want.max().item():.3g}), top-1 equal {same}; "
            f"flash_attention {per_forward} launches a forward; device {_ms(ms)} a forward "
            f"(dense attention {_ms(plain_ms)})")
        if per_forward != cfg.n_layers:
            fail(f"{label}: {per_forward} flash_attention launches a forward, not {cfg.n_layers}")
        if d > FORWARD_DLOGITS_TOL or not (same or (top2[:, 1] - top2[:, 0]).min().item()
                                           < FORWARD_DLOGITS_TOL):
            fail(f"{label}: the kernel path disagrees with the plain path")
        eng.classify_sync(images[0])
        for n in range(1, ENC_MAX_BATCH + 1):
            eng._classify_step(params, torch.from_numpy(images[:n]).to(dev))
        flushes = _record_flushes(eng)
        reset_launch_counts()
        items = [images[i % 16] for i in range(ENC_REQUESTS)]
        res, lat, wall = _fan_out(eng.classify_sync, items)
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        out["vit-base batcher"] = _serve_line(
            f"{label}, batcher (max_batch {ENC_MAX_BATCH}, {ENC_WAIT_MS} ms)", lat, wall, flushes,
            f"; flash_attention {counts['flash_attention']} launches over "
            f"{len(flushes)} flushes; device {_ms(ms)} a [8, ...] forward; peak memory "
            f"{peak / 2**30:.3f} GiB")
        out["vit-base batcher"].update(device_ms_b8=ms, plain_device_ms_b8=plain_ms)
        if counts["flash_attention"] != cfg.n_layers * len(flushes):
            fail(f"{label}: flash_attention launched {counts['flash_attention']} times over "
                 f"{len(flushes)} flushes, not {cfg.n_layers} a flush")
        if not all(np.isfinite(r).all() for r in res):
            fail(f"{label}: non-finite logits")
        out["flash_attention launches"] = {
            "vit-base [8, 224, 224, 3] forward": per_forward,
            f"vit-base serve, {ENC_REQUESTS} requests, {len(flushes)} flushes":
                counts["flash_attention"]}
    finally:
        eng.close()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase_encoders done in {time.perf_counter() - t_phase:.1f} s")
    return out


# Training cells: (model, layers kept, batch, sequence). Full width; depth
# cut where one card cannot hold f32 masters, gradients and AdamW state
# (16 bytes a parameter) and the step's activations.
FAMILY_TRAIN = [("gemma-7b", 4, 1, 2048), ("qwen2-7b", 4, 1, 2048),
                ("pythia-6.9b", 4, 1, 2048), ("gpt2", 12, 8, 1024),
                ("mixtral-8x7b", 2, 1, 2048)]
# What a training cell may plan to hold: 16 bytes a parameter, a bf16
# compute copy (2) and its gradients on the way to the masters (2).
TRAIN_BYTES_BUDGET = 70 * 2**30


def param_count(cfg) -> tuple[int, int]:
    """(all parameters, those in matmuls: every projection, the router,
    each expert and lm_head; the embedding lookup and the norms left out)
    of a decoder config, from its shapes."""
    D, H, KV, hd, Fd, L, V = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                              cfg.d_ff, cfg.n_layers, cfg.vocab_size)
    E = max(1, cfg.n_experts)
    ffn = (3 if cfg.ffn != "mlp" else 2) * D * Fd * E
    per_layer = D * (H + 2 * KV) * hd + H * hd * D + ffn + (D * cfg.n_experts)
    matmul = L * per_layer + D * V
    small = L * 2 * D + D  # norms
    if cfg.norm == "ln":
        small *= 2
    if cfg.attn_bias:
        small += L * (H + 2 * KV) * hd
    if cfg.proj_bias:
        small += L * (2 * D + Fd)
    pos = cfg.max_len * D if cfg.pos_emb == "learned" else 0
    return matmul + V * D + small + pos, matmul


def phase_family_train(torch, dev) -> dict:
    """make_train_step on every other decoder family and MoE at full width,
    each cell of FAMILY_TRAIN (depth cut to fit): the step-1 loss and
    gradients through the kernel path against the plain path (dense
    attention, remat; for MoE without remat, its routing pinned to the
    kernel side's at router near-ties) at TRAIN_DLOSS_TOL and
    TRAIN_GRAD_REL_TOL; 6 steps on one fixed batch with finite, falling
    losses; flash_attention launched once a layer a forward; step time,
    tokens/s, train_mfu and peak memory. Then 3 make_lora_train_step steps
    on gpt2 (every target, rank 16). Returns the launch counts by cell."""
    import dataclasses

    from gofr_tpu_torch.models.registry import get_model
    from gofr_tpu_torch.models.transformer import LORA_TARGETS, init_params
    from gofr_tpu_torch.ops.cuda import flash_attention as fa
    from gofr_tpu_torch.ops.cuda import reset_launch_counts
    from gofr_tpu_torch.parallel.sharding import (
        loss_and_grads,
        make_lora_train_step,
        make_train_step,
    )

    t_phase = time.perf_counter()
    out: dict = {"counts": {}, "cells": {}}
    for model, layers, b, s in FAMILY_TRAIN:
        full = get_model(model).config
        while True:
            cfg = dataclasses.replace(full, n_layers=layers)
            n_params, n_matmul = param_count(cfg)
            plan = 20 * n_params
            if plan <= TRAIN_BYTES_BUDGET or layers == 1:
                break
            layers -= 1
        label = f"family train {model} ({layers} of {full.n_layers} layers, [{b}, {s}])"
        log(f"{label}: {n_params / 1e9:.3f} B parameters ({n_matmul / 1e9:.3f} B in matmuls), "
            f"planned {plan / 2**30:.1f} GiB for masters, AdamW, gradients and the bf16 copy "
            f"(budget {TRAIN_BYTES_BUDGET / 2**30:.0f} GiB) before activations")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=dev).manual_seed(11)
        tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev)
        params = {k: p.float() for k, p in init_params(cfg, 0, dev).items()}
        if sum(p.numel() for p in params.values()) != n_params:
            fail(f"{label}: {sum(p.numel() for p in params.values())} parameters, "
                 f"planned {n_params}")
        pin = RoutePin(torch) if cfg.is_moe else None
        try:
            reset_launch_counts()
            if pin:
                pin.record()
            loss_k, grads_k = loss_and_grads(params, tokens, cfg)
            if fa.launches != layers:
                fail(f"{label}: {fa.launches} flash_attention launches in one forward, "
                     f"not {layers}")
            if pin:
                pin.replay(label)
            loss_p, grads_p = loss_and_grads(params, tokens, cfg, remat=not cfg.is_moe,
                                             dense_attn=True)
        finally:
            if pin:
                pin.close()
        dloss = abs(loss_k.item() - loss_p.item())
        grad_rel = {k: ((grads_k[k] - grads_p[k]).norm() / grads_p[k].norm()).item()
                    for k in grads_p}
        worst = max(grad_rel, key=grad_rel.get)
        log(f"{label}: step-1 loss kernel {loss_k.item():.6f} vs plain {loss_p.item():.6f}: "
            f"|dloss| {dloss:.4g} (limit {TRAIN_DLOSS_TOL}); per-tensor ||dgrad||/||grad|| "
            f"max {grad_rel[worst]:.4g} on {worst} (limit {TRAIN_GRAD_REL_TOL}): "
            + json.dumps({k: round(v, 6) for k, v in grad_rel.items()}))
        if not (torch.isfinite(loss_k) and all(torch.isfinite(g).all()
                                               for g in grads_k.values())):
            fail(f"{label}: non-finite step-1 loss or gradients")
        if dloss > TRAIN_DLOSS_TOL or grad_rel[worst] > TRAIN_GRAD_REL_TOL:
            fail(f"{label}: kernel path and plain path disagree beyond the limits")
        del grads_k, grads_p, loss_k, loss_p
        gc.collect()
        torch.cuda.empty_cache()
        _, train_step, optimizer = make_train_step(cfg, device=dev)
        opt_state = optimizer.init(params)
        reset_launch_counts()
        losses, secs = [], []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, params, opt_state = train_step(params, opt_state, tokens)
            losses.append(loss.item())
            secs.append(time.perf_counter() - t0)
        if fa.launches != 6 * layers:
            fail(f"{label}: {fa.launches} flash_attention launches over 6 steps, "
                 f"not {6 * layers}")
        if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
            fail(f"{label}: losses {losses} are not finite and falling")
        peak = torch.cuda.max_memory_allocated()
        step_s = statistics.median(secs[1:])
        attn_flops = 4 * b * cfg.n_heads * cfg.head_dim * s * (s + 1) // 2
        mfu = (6 * n_matmul * b * s + 3 * layers * attn_flops) / (step_s * BF16_FLOPS)
        cell = {"layers": layers, "of": full.n_layers, "batch": [b, s], "losses": losses,
                "step_ms": step_s * 1e3, "tokens_s": b * s / step_s, "train_mfu": mfu,
                "peak_bytes": peak, "flash_attention_launches": fa.launches,
                "dloss": dloss, "grad_rel_max": grad_rel[worst]}
        out["cells"][model] = cell
        out["counts"][f"make_train_step {model} {layers} layers [{b}, {s}], 6 steps"] = \
            fa.launches
        log(f"{label}: losses over 6 steps {[round(x, 5) for x in losses]}; step time median "
            f"of steps 2-6 {step_s * 1e3:.1f} ms (all {[round(x * 1e3, 1) for x in secs]}), "
            f"{b * s / step_s:.0f} tokens/s, peak memory {peak / 2**30:.2f} GiB, train_mfu "
            f"{mfu:.4f} (matmuls counted for every expert: the dense MoE computes them all); "
            f"flash_attention {fa.launches} launches over the 6 steps")
        del params, opt_state, loss
    gc.collect()
    torch.cuda.empty_cache()

    # One LoRA cell: gpt2, every target it has, rank 16, on its bf16 base.
    cfg = get_model("gpt2").config
    label = "family train gpt2 LoRA (rank 16, every target, [8, 1024])"
    torch.cuda.reset_peak_memory_stats()
    base = init_params(cfg, 0, dev)
    targets = tuple(t for t in LORA_TARGETS if t != "w_gate")
    init_lora_state, lora_step = make_lora_train_step(cfg, base, 16, targets, device=dev)
    lora, lora_opt = init_lora_state(0)
    gen = torch.Generator(device=dev).manual_seed(12)
    tokens = torch.randint(0, cfg.vocab_size, (8, 1024), generator=gen, device=dev)
    reset_launch_counts()
    losses, secs = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, lora, lora_opt = lora_step(lora, lora_opt, tokens)
        losses.append(loss.item())
        secs.append(time.perf_counter() - t0)
    if fa.launches != 3 * cfg.n_layers or not all(math.isfinite(x) for x in losses) \
            or not losses[-1] < losses[0]:
        fail(f"{label}: losses {losses}, {fa.launches} flash_attention launches")
    out["counts"]["make_lora_train_step gpt2 [8, 1024], 3 steps"] = fa.launches
    log(f"{label}: losses {[round(x, 5) for x in losses]}; step times "
        f"{[round(x * 1e3, 1) for x in secs]} ms, {8 * 1024 / statistics.median(secs):.0f} "
        f"tokens/s; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"flash_attention {fa.launches} launches")
    del base, lora, lora_opt
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase_family_train done in {time.perf_counter() - t_phase:.1f} s")
    return out


def profiler_under_replays(torch, eng, label: str) -> dict:
    """A 200 ms profiler_capture triggered from this thread while ``eng``
    (on the card) replays decode windows: 8 requests of 100 prompt tokens
    and 400 new ones keep every slot decoding, and the capture starts once
    4 windows have run. Its start and stop run on the scheduler thread
    between two passes. Fails unless the trace holds flash_decode launches
    of replayed windows (kernels whose correlation is a traced
    cudaGraphLaunch) and the capture's trace is written within
    PROFILER_END_S of its window; a watchdog ends the run after
    PROFILER_WATCHDOG_S. Returns the numbers printed."""
    import os

    from gofr_tpu_torch.ops.cuda import launch_counts
    from gofr_tpu_torch.serving.profiler_capture import get_capture

    def watchdog():
        print(f"chip_smoke: FAIL: {label}: the profiler capture under graph replays did not "
              f"end within {PROFILER_WATCHDOG_S:.0f} s", file=sys.stderr, flush=True)
        os._exit(1)

    timer = threading.Timer(PROFILER_WATCHDOG_S, watchdog)
    timer.daemon = True
    timer.start()
    try:
        cap = get_capture(cooldown_s=0)
        reqs = [eng.submit_generate(list(range(1 + i, 101 + i)), max_new_tokens=400,
                                    stop_on_eos=False) for i in range(8)]
        w0, deadline = eng.decode_windows, time.perf_counter() + 60
        while eng.decode_windows < w0 + 4 and time.perf_counter() < deadline:
            time.sleep(0.002)
        before, w1 = launch_counts(), eng.decode_windows
        t0 = time.perf_counter()
        if not cap.trigger(200, reason="chip_smoke under graph replays"):
            fail(f"{label}: the capture did not start: {cap.snapshot()}")
        while cap.busy:
            time.sleep(0.002)
        took = time.perf_counter() - t0
        w2, after = eng.decode_windows, launch_counts()
        snap = cap.snapshot()
        for r in reqs:
            r.future.result(timeout=300)
    finally:
        timer.cancel()
    if snap["last_error"] or not os.path.exists(cap.trace_file):
        fail(f"{label}: the capture under graph replays failed: {snap}")
    with open(cap.trace_file) as fp:
        events = json.load(fp).get("traceEvents", [])
    kernels = [e for e in events if e.get("cat") == "kernel"]
    launches = {e.get("args", {}).get("correlation") for e in events
                if e.get("name", "").startswith("cudaGraphLaunch")}
    flash = [e for e in kernels if "flash_decode" in e.get("name", "")]
    replayed = [e for e in flash if e.get("args", {}).get("correlation") in launches]
    res = {"capture_s": took, "windows": w2 - w1, "trace_events": len(events),
           "trace_kernels": len(kernels), "graph_launches": len(launches),
           "flash_decode": len(flash), "flash_decode_replayed": len(replayed),
           "flash_decode_counted": after["flash_decode"] - before["flash_decode"]}
    log(f"{label}: profiler_capture of 200 ms while the engine replays decode windows: "
        f"trigger to trace written {took:.3f} s (limit 0.2 + {PROFILER_END_S}); "
        f"{w2 - w1} windows ran meanwhile ({res['flash_decode_counted']} flash_decode "
        f"launches counted); the trace: {len(events)} events, {len(kernels)} kernels, "
        f"{len(launches)} cudaGraphLaunch, {len(flash)} flash_decode, {len(replayed)} of them "
        f"inside a traced graph launch")
    if not replayed or took > 0.2 + PROFILER_END_S:
        fail(f"{label}: the capture under graph replays traced no replayed flash_decode "
             f"or ended late: {res}")
    return res


# -- the seq2seq family (T5), its tokenizers and the auth enablers ------------

SEQ2SEQ_REQUESTS = 64
SEQ2SEQ_MAX_BATCH = 8
SEQ2SEQ_WAIT_MS = 5
SEQ2SEQ_TOKENS = (8, 400)  # the requests' input lengths under the Unigram file
SEQ2SEQ_KEY = "chip-smoke-api-key"
# The phase ends the run after this long (a hang costs this, not the limit).
SEQ2SEQ_WATCHDOG_S = 300.0
# flan-t5-small's f32 twin on the card (TF32 off) against the same weights
# on the host CPU, calibrated by the host's own f32 against a float64 run
# of the same weights: random weights leave T5's unscaled scores at std
# ~8 (d_kv 64), so the softmax is nearly one-hot and an f32 rounding
# moves whole attention rows through 8+8 layers. The card's max and rms
# decoder-logit differences from the host must stay within this multiple
# of the host's from float64.
T5_F32_VS_F64_FACTOR = 3.0
# google/flan-t5-large's config.json widths (about 0.78 B parameters).
T5_LARGE_CONFIG = {
    "model_type": "t5", "vocab_size": 32128, "d_model": 1024, "d_kv": 64, "num_heads": 16,
    "num_layers": 24, "num_decoder_layers": 24, "d_ff": 2816,
    "feed_forward_proj": "gated-gelu", "tie_word_embeddings": False,
    "relative_attention_num_buckets": 32, "relative_attention_max_distance": 128,
    "layer_norm_epsilon": 1e-6}
# load_hf_t5's leg writes and loads those widths at this depth (of 24 and
# 24) for the script's time.
T5_LARGE_LAYERS = 6
TOKENIZER_RATE_BYTES = 1_000_000
SEQ2SEQ_LEARN_CHARS = 300_000  # the Markdown the three vocabularies are learned from
SP = "▁"  # SentencePiece's word boundary


def _write_tokenizer(directory: str, spec: dict, config: dict) -> str:
    import os

    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "tokenizer.json"), "w", encoding="utf-8") as fp:
        json.dump({"version": "1.0", "truncation": None, "padding": None, **spec}, fp,
                  ensure_ascii=False)
    with open(os.path.join(directory, "tokenizer_config.json"), "w") as fp:
        json.dump(config, fp)
    return directory


def _added(tokens: list) -> list:
    return [{"id": i, "content": t, "single_word": False, "lstrip": False, "rstrip": False,
             "normalized": False, "special": True} for i, t in enumerate(tokens)]


def _template(pre: list, post: list, ids: dict) -> dict:
    seq = ([{"SpecialToken": {"id": t, "type_id": 0}} for t in pre]
           + [{"Sequence": {"id": "A", "type_id": 0}}]
           + [{"SpecialToken": {"id": t, "type_id": 0}} for t in post])
    return {"type": "TemplateProcessing", "single": seq, "pair": seq,
            "special_tokens": {t: {"id": t, "ids": [ids[t]], "tokens": [t]}
                               for t in pre + post}}


def write_unigram_tokenizer(directory: str, text: str, size: int = 8000) -> str:
    """A T5-shaped Unigram tokenizer.json over ``text``: <pad>, </s>, <unk>
    (ids 0-2), every character of the text and the most frequent
    substrings (up to 8 characters) of its ``▁``-prefixed words, each
    scored by the log of its share of the counts; WhitespaceSplit +
    Metaspace (always, split), the ``$A </s>`` template, the Metaspace
    decoder; class T5Tokenizer without sentinels."""
    words = collections.Counter(text.split())
    counts: collections.Counter = collections.Counter()
    for w, c in words.items():
        s = SP + w
        for i in range(len(s)):
            for j in range(i + 1, min(len(s), i + 8) + 1):
                counts[s[i:j]] += c
    chars = [p for p in counts if len(p) == 1]
    longer = sorted((p for p in counts if len(p) > 1), key=lambda p: (-counts[p], p))
    chosen = chars + longer[:max(0, size - len(chars))]
    total = sum(counts[p] for p in chosen)
    specials = ["<pad>", "</s>", "<unk>"]
    vocab = [[t, 0.0] for t in specials] + [[p, math.log(counts[p] / total)] for p in chosen]
    metaspace = {"type": "Metaspace", "replacement": SP, "prepend_scheme": "always",
                 "split": True}
    return _write_tokenizer(directory, {
        "added_tokens": _added(specials), "normalizer": None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [{"type": "WhitespaceSplit"},
                                                                metaspace]},
        "post_processor": _template([], ["</s>"], {"</s>": 1}), "decoder": metaspace,
        "model": {"type": "Unigram", "unk_id": 2, "vocab": vocab, "byte_fallback": False},
    }, {"tokenizer_class": "T5Tokenizer", "extra_ids": 0})


def write_sp_bpe_tokenizer(directory: str, text: str, n_merges: int = 2000) -> str:
    """A Llama-2-shaped SentencePiece BPE tokenizer.json over ``text``:
    <unk>, <s>, </s>, then <0x00>..<0xFF> (byte fallback), the text's
    characters and ``n_merges`` character merges learned over its
    ``▁``-prefixed words (``greedy_merges``); the Prepend/Replace
    normalizers, no pre-tokenizer, the Replace/ByteFallback/Fuse/Strip
    decoders, a BOS template; class LlamaTokenizerFast."""
    words = collections.Counter(SP + w for w in text.split())
    merges = greedy_merges([list(w) for w in words], list(words.values()), n_merges)
    specials = ["<unk>", "<s>", "</s>"]
    vocab = specials + [f"<0x{b:02X}>" for b in range(256)]
    seen = set(vocab)
    for tok in sorted({c for w in words for c in w}) + [a + b for a, b in merges]:
        if tok not in seen:
            seen.add(tok)
            vocab.append(tok)
    return _write_tokenizer(directory, {
        "added_tokens": _added(specials),
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Prepend", "prepend": SP},
            {"type": "Replace", "pattern": {"String": " "}, "content": SP}]},
        "pre_tokenizer": None,
        "post_processor": _template(["<s>"], [], {"<s>": 1}),
        "decoder": {"type": "Sequence", "decoders": [
            {"type": "Replace", "pattern": {"String": SP}, "content": " "},
            {"type": "ByteFallback"}, {"type": "Fuse"},
            {"type": "Strip", "content": " ", "start": 1, "stop": 0}]},
        "model": {"type": "BPE", "dropout": None, "unk_token": "<unk>",
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": True, "byte_fallback": True, "ignore_merges": False,
                  "vocab": {t: i for i, t in enumerate(vocab)},
                  "merges": [f"{a} {b}" for a, b in merges]},
    }, {"tokenizer_class": "LlamaTokenizerFast", "add_bos_token": True,
        "add_eos_token": False})


def write_wordpiece_tokenizer(directory: str, text: str, size: int = 12000) -> str:
    """A BERT-shaped WordPiece tokenizer.json over ``text``: [PAD], [UNK],
    [CLS], [SEP], [MASK], every character of the normalized text alone and
    ``##``-continued, then its most frequent words and word endings;
    BertNormalizer (lowercase), BertPreTokenizer, the ``[CLS] $A [SEP]``
    template, the WordPiece decoder; class BertTokenizer."""
    from gofr_tpu_torch.serving import hf_pipeline as hp

    norm = hp.bert_normalize(text, True, True, None, True)
    words = collections.Counter(p for p, _ in hp._bert_pre_tokenize((norm, True)))
    ends: collections.Counter = collections.Counter()
    for w, c in words.items():
        for i in range(1, len(w) - 1):
            ends["##" + w[i:]] += c
    chars = sorted({c for w in words for c in w})
    specials = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    vocab = specials + chars + ["##" + c for c in chars]
    seen = set(vocab)
    ranked = sorted(words, key=lambda w: (-words[w], w))[: size // 2] + sorted(
        ends, key=lambda e: (-ends[e], e))[: size // 2]
    for tok in ranked:
        if tok not in seen and len(vocab) < size:
            seen.add(tok)
            vocab.append(tok)
    return _write_tokenizer(directory, {
        "added_tokens": _added(specials),
        "normalizer": {"type": "BertNormalizer", "clean_text": True,
                       "handle_chinese_chars": True, "strip_accents": None, "lowercase": True},
        "pre_tokenizer": {"type": "BertPreTokenizer"},
        "post_processor": _template(["[CLS]"], ["[SEP]"], {"[CLS]": 2, "[SEP]": 3}),
        "decoder": {"type": "WordPiece", "prefix": "##", "cleanup": True},
        "model": {"type": "WordPiece", "unk_token": "[UNK]", "continuing_subword_prefix": "##",
                  "max_input_chars_per_word": 100, "vocab": {t: i for i, t in enumerate(vocab)}},
    }, {"tokenizer_class": "BertTokenizer", "do_lower_case": True})


def seq2seq_texts(tok, text: str, n: int, lengths: tuple, seed: int = 0) -> list:
    """``n`` distinct windows of ``text``'s words, each the shortest whose
    encoding under ``tok`` holds at least its drawn length of
    ``lengths`` (the EOS included)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    words = text.split()
    sizes = {}
    out, seen = [], set()
    while len(out) < n:
        want = int(rng.integers(lengths[0], lengths[1] + 1))
        i = int(rng.integers(0, len(words) - 2 * lengths[1]))
        got, j = 1, i
        while got < want:
            w = words[j]
            if w not in sizes:
                sizes[w] = len(tok.encode(w)) - 1
            got += sizes[w]
            j += 1
        s = " ".join(words[i:j])
        if s not in seen:
            seen.add(s)
            out.append(s)
    return out


def _timed(torch, fn) -> tuple:
    """(result, wall ms) of one call, the device drained before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def graph_replay_ms(torch, fn, replays: int = 3):
    """(device ms, result): ``fn`` captured whole as one CUDA graph (after
    an eager warm-up that fills the caches it reads) and replayed
    ``replays`` times, the median replay timed by CUDA events: the
    kernels back to back with no host launch between them, each node's
    own scheduling (~1 µs) included. A whole eager generate holds tens of
    thousands of kernels, which a torch.profiler trace takes 15-25 s to
    read back on the card's host; this takes a capture."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    result = out.clone()
    del graph
    return statistics.median(times), result


def _trim_eos(row: list, eos: int = 1) -> list:
    return row[: row.index(eos)] if eos in row else row


def phase_seq2seq(torch, dev) -> dict:
    """The seq2seq family (T5) on the card, its tokenizer.json kinds and
    the auth enablers, under a SEQ2SEQ_WATCHDOG_S watchdog:

    1. writes a Unigram (T5), a SentencePiece BPE with byte fallback
       (Llama-2's layout) and a WordPiece (BERT) tokenizer.json learned
       from the repo's Markdown; encode MB/s of each over about 1 MB of
       text on the host; decode(encode(x)) == x on the byte-fallback file;
    2. flan-t5-small at full width in bf16 (seed-0 weights) served by the
       port's App from config (TPU_MODEL=flan-t5-small, the Unigram file
       as TPU_TOKENIZER) behind enable_api_key_auth: SEQ2SEQ_REQUESTS
       concurrent requests of 8 to 400 tokens to a ctx.infer route with
       the key (requests/s, p50/p99, flush sizes, generated tokens/s), one
       without it (401), every answer equal to t5_generate run directly on
       its flush's padded batch, one request's stream equal to its
       one-shot ids; BERT-base beside it as TPU_EMBED_MODEL with the
       WordPiece file as TPU_EMBED_TOKENIZER answers /v1/embeddings once
       (against bert_embed on the same tokens); device ms of t5_generate
       at [8, bucket] and [1, bucket] beside its wall ms;
    3. flan-t5-small's f32 twin on the card against the host CPU: the
       relative-bias bucket ids equal, decoder logits within
       T5_F32_VS_F64_FACTOR times the host's own distance from a float64
       run of the same weights;
    4. TPU_QUANT=int8 and int4 at flan-t5-small: param_bytes, device ms a
       [8, bucket] generate, the share of ids equal to bf16's;
    5. load_hf_t5 at flan-t5-large's published widths, T5_LARGE_LAYERS
       deep: random bf16
       weights written with write_safetensors, loaded in bf16 and int8
       (load s, GB/s, peak memory, a leaf of each checked), device ms of
       a [8, 128] generate.
    T5 launches none of the three attention kernels. Returns the numbers
    printed."""
    import asyncio
    import dataclasses
    import os
    import shutil
    import tempfile

    import numpy as np

    from gofr_tpu_torch.config import MockConfig
    from gofr_tpu_torch.models.bert import bert_embed
    from gofr_tpu_torch.models.registry import get_model
    from gofr_tpu_torch.models.t5 import (
        _rel_bucket,
        bucket_ids,
        config_from_hf_t5,
        init_t5,
        load_hf_t5,
        t5_decode,
        t5_encode,
        t5_generate,
        t5_param_count,
    )
    from gofr_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from gofr_tpu_torch.ops.quant import quantize_array
    from gofr_tpu_torch.serving.batcher import pad_bucket
    from gofr_tpu_torch.serving.device_telemetry import tree_device_bytes
    from gofr_tpu_torch.serving.engine import InferenceEngine
    from gofr_tpu_torch.serving.hf_tokenizer import HFTokenizer
    from gofr_tpu_torch.serving.openai_compat import add_openai_routes
    from gofr_tpu_torch.serving.stream_text import stream_seq2seq
    from gofr_tpu_torch.serving.types import _PREFILL_BUCKETS

    def watchdog():
        print(f"chip_smoke: FAIL: phase_seq2seq did not end within {SEQ2SEQ_WATCHDOG_S:.0f} s",
              file=sys.stderr, flush=True)
        os._exit(1)

    timer = threading.Timer(SEQ2SEQ_WATCHDOG_S, watchdog)
    timer.daemon = True
    timer.start()
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_t5_")
    out: dict = {"step_s": {}}

    def step_done(name: str) -> None:
        out["step_s"][name] = time.perf_counter() - t_phase
    try:
        # -- 1. the tokenizer.json kinds --------------------------------------
        label = "seq2seq tokenizers"
        text = repo_markdown()
        t0 = time.perf_counter()
        learn = text[:SEQ2SEQ_LEARN_CHARS]
        uni = write_unigram_tokenizer(os.path.join(tmp, "unigram"), learn)
        bpe = write_sp_bpe_tokenizer(os.path.join(tmp, "sp_bpe"), learn)
        wp = write_wordpiece_tokenizer(os.path.join(tmp, "wordpiece"), learn)
        built_s = time.perf_counter() - t0
        lines = [ln for ln in text.split("\n") if ln.strip()]
        corpus, size = [], 0
        while size < TOKENIZER_RATE_BYTES:
            for ln in lines:
                corpus.append(ln)
                size += len(ln.encode())
                if size >= TOKENIZER_RATE_BYTES:
                    break
        rates = {}
        for kind, d in (("unigram", uni), ("sentencepiece bpe, byte_fallback", bpe),
                        ("wordpiece", wp)):
            tok = HFTokenizer(d)
            mbs, ids = encode_rate(tok, corpus)
            rates[kind] = {"mb_s": mbs, "tokens": sum(map(len, ids)), "vocab": tok.vocab_size}
        sp_tok = HFTokenizer(bpe)
        extra = ["emoji 🙂👍🏽 🚀 and ZWJ 👩‍💻", "日本語のテキスト 中文 한국어", "café naïve Ærø",
                 "  two leading, two trailing  ", "tabs\t\tand\nnewlines\n", ""]
        byte_ids = {sp_tok.vocab[f"<0x{b:02X}>"] for b in range(256)}
        bad, fallback = [], 0
        # Lines that write a special token or ▁ cannot come back: decode
        # skips the specials and reads ▁ as a space.
        lines = [x for x in lines if not any(t in x for t in ("<s>", "</s>", "<unk>", SP))]
        for x in lines + extra:
            ids = sp_tok.encode(x)
            fallback += sum(1 for i in ids if i in byte_ids)
            if sp_tok.decode(ids) != x:
                bad.append(x)
        out["tokenizers"] = {"rates": rates, "round_trip_lines": len(lines) + len(extra),
                             "byte_fallback_tokens": fallback, "built_s": built_s}
        log(f"{label}: written in {built_s:.1f} s; encode rates on the host over "
            f"{size / 1e6:.2f} MB ({len(corpus)} lines): " + "; ".join(
                f"{k} {v['mb_s']:.3f} MB/s ({v['tokens']} tokens, vocab {v['vocab']})"
                for k, v in rates.items())
            + f"; decode(encode(x)) == x on the byte-fallback file over {len(lines) + len(extra)} "
            f"lines: {len(bad)} differ ({fallback} <0xNN> pieces used)")
        if bad or not fallback:
            fail(f"{label}: the byte-fallback file does not round-trip: {bad[:3]}")
        step_done("tokenizers")

        # -- 2. flan-t5-small behind the App, the API key and the batcher ----
        label = "seq2seq flan-t5-small"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        app, loop, stop = _app_harness({
            "TPU_MODEL": "flan-t5-small", "TPU_DEVICE": str(dev), "TPU_TOKENIZER": uni,
            "TPU_MAX_BATCH": str(SEQ2SEQ_MAX_BATCH), "TPU_BATCH_WAIT_MS": str(SEQ2SEQ_WAIT_MS),
            "TPU_MAX_LEN": "512", "TPU_EMBED_MODEL": "bert-base", "TPU_EMBED_TOKENIZER": wp})
        key = {"X-API-KEY": SEQ2SEQ_KEY}
        try:
            app.enable_api_key_auth(SEQ2SEQ_KEY)
            add_openai_routes(app)

            @app.post("/t2t")
            async def t2t(ctx):
                return await ctx.infer(ctx.request.json()["input"])

            asyncio.run_coroutine_threadsafe(app.start(), loop).result(timeout=120)
            heng, emb = app.container.tpu, app.container.tpu_embed
            cfg = heng.cfg
            if (heng.family != "seq2seq" or heng.device != dev
                    or not isinstance(heng.tokenizer, HFTokenizer)
                    or not isinstance(emb.tokenizer, HFTokenizer)):
                fail(f"{label}: the App's engines are {heng.family} on {heng.device} with "
                     f"{type(heng.tokenizer).__name__}, embed {type(emb.tokenizer).__name__}")
            port = app.http_port
            texts = seq2seq_texts(heng.tokenizer, text, SEQ2SEQ_REQUESTS, SEQ2SEQ_TOKENS)
            n_tok = [len(heng.tokenizer.encode(t)) for t in texts]
            status, raw = _http_json(port, "POST", "/t2t", {"input": texts[0]}, key)  # warm
            if status != 201:
                fail(f"{label}: warm-up request {status}: {raw[:200]}")
            denied, denied_raw = _http_json(port, "POST", "/t2t", {"input": texts[0]})
            probe = _http_json(port, "GET", "/.well-known/alive")[0]
            if denied != 401 or json.loads(denied_raw) != {"error": {"message": "Unauthorized"}} \
                    or probe != 200:
                fail(f"{label}: without the key {denied} {denied_raw[:200]}, probe {probe}")
            flushes = _record_flushes(heng)
            res, lat, wall = _fan_out(lambda t: _http_json(
                port, "POST", "/t2t", {"input": t}, key), texts)
            answers = {}
            for t, (status, raw) in zip(texts, res):
                if status != 201:
                    fail(f"{label}: HTTP {status}: {raw[:200]}")
                data = json.loads(raw)["data"]
                answers[t] = data
                if set(data) != {"text", "token_ids"} or \
                        data["text"] != heng.tokenizer.decode(data["token_ids"]):
                    fail(f"{label}: a malformed answer {str(data)[:200]}")
            status, raw = _http_json(port, "POST", "/v1/embeddings",
                                     {"input": texts[1]}, key)
            if status != 200:
                fail(f"{label}: /v1/embeddings {status}: {raw[:200]}")
            vector = np.asarray(json.loads(raw)["data"][0]["embedding"], np.float32)
            stream_text = texts[2]
            chunks = list(heng.seq2seq_stream_blocking(stream_text))

            async def drain():
                return [e async for e in stream_seq2seq(heng, stream_text, heng.tokenizer)]

            events = asyncio.run(drain())
            solo = heng.seq2seq_sync(stream_text)
        finally:
            stop()
        step_done("serve over HTTP")
        peak = torch.cuda.max_memory_allocated()
        streamed = [t for c in chunks for t in c]
        if streamed != solo or events[-1]["tokens"] != len(solo) or \
                "".join(e["text"] for e in events[:-1]) != heng.tokenizer.decode(solo):
            fail(f"{label}: the stream ({len(streamed)} ids in {len(chunks)} chunks, done "
                 f"{events[-1]}) differs from the one-shot ids ({len(solo)})")
        # Every answer against t5_generate on its flush's padded batch, with
        # the App stopped (no engine thread beside the timers).
        worst_flush, buckets = 0, []
        params = heng.params
        with torch.inference_mode():
            for payloads, results in flushes:
                tokens, lengths = heng._seq2seq_rows(payloads)
                buckets.append(tokens.shape[1])
                direct = t5_generate(params, torch.from_numpy(tokens).to(dev),
                                     torch.from_numpy(lengths).to(dev), cfg,
                                     max_new=heng._seq2seq_max_new).cpu().tolist()
                for p, r, d in zip(payloads, results, direct):
                    if r != _trim_eos(d) or answers[p]["token_ids"] != r:
                        worst_flush += 1
            toks, lens = heng._seq2seq_rows([stream_text])
            one = t5_generate(params, torch.from_numpy(toks).to(dev),
                              torch.from_numpy(lens).to(dev), cfg,
                              max_new=heng._seq2seq_max_new).cpu().tolist()[0]
            ids = emb.tokenizer.encode(texts[1])[: emb.max_len]
            ebucket = min(pad_bucket(len(ids), _PREFILL_BUCKETS), emb.max_len)
            etoks = torch.zeros((1, ebucket), dtype=torch.long)
            emask = torch.zeros((1, ebucket), dtype=torch.long)
            etoks[0, : len(ids)] = torch.tensor(ids)
            emask[0, : len(ids)] = 1
            direct_vec = bert_embed(emb.params, etoks.to(dev), emask.to(dev),
                                    emb.cfg).cpu().numpy()[0]
        step_done("answers against t5_generate")
        bucket = max(buckets)
        big = [p for p, _ in flushes if len(p) == SEQ2SEQ_MAX_BATCH] or [texts[:8]]
        tok8, len8 = heng._seq2seq_rows(big[0])
        if tok8.shape[1] != bucket:
            tok8 = np.pad(tok8, ((0, 0), (0, bucket - tok8.shape[1])))
        tok8, len8 = torch.from_numpy(tok8).to(dev), torch.from_numpy(len8).to(dev)
        tok1, len1 = tok8[:1], len8[:1]
        max_new = heng._seq2seq_max_new
        gen = lambda t, n, p=params: t5_generate(p, t, n, cfg, max_new=max_new)  # noqa: E731
        with torch.inference_mode():
            reset_launch_counts()
            eager8, wall8 = _timed(torch, lambda: gen(tok8, len8))
            kernels = {k: v for k, v in launch_counts().items() if v}
            _, wall1 = _timed(torch, lambda: gen(tok1, len1))
            ms8, graph8 = graph_replay_ms(torch, lambda: gen(tok8, len8))
            ms1, _ = graph_replay_ms(torch, lambda: gen(tok1, len1))
        step_done("generate timings")
        generated = sum(len(a["token_ids"]) for a in answers.values())
        out["flan-t5-small http"] = _serve_line(
            f"{label}, App (TPU_MODEL=flan-t5-small, Unigram TPU_TOKENIZER, enable_api_key_auth,"
            f" ctx.infer; max_batch {SEQ2SEQ_MAX_BATCH}, {SEQ2SEQ_WAIT_MS} ms; client clock)",
            lat, wall, flushes,
            f"; {min(n_tok)}-{max(n_tok)} input tokens, {generated} generated "
            f"({generated / wall:.1f} tokens/s); without the key: {denied} "
            f"{denied_raw.decode()}; every answer against t5_generate on its flush's padded "
            f"batch: {worst_flush} differ; the stream of a {n_tok[2]}-token input: "
            f"{len(streamed)} ids in {len(chunks)} chunks, equal to its one-shot ids "
            f"{streamed == solo}; peak memory {peak / 2**30:.3f} GiB (BERT-base beside it)")
        out["flan-t5-small http"].update(
            generated_tokens=generated, tokens_s=generated / wall, bucket=bucket,
            device_ms_b8=ms8, device_ms_b1=ms1,
            wall_ms_b8=wall8, wall_ms_b1=wall1)
        log(f"{label}: t5_generate ({max_new} steps, the decoder over the whole "
            f"[b, 1 + {max_new}] buffer each step): [8, {bucket}] device {ms8:.3f} ms as one "
            f"CUDA graph replay, wall {wall8:.1f} ms eager (host share {1 - ms8 / wall8:.3f}); [1, {bucket}] device "
            f"{ms1:.3f} ms, wall {wall1:.1f} ms (host share {1 - ms1 / wall1:.3f}); the graph "
            f"replay's ids equal the eager call's {torch.equal(graph8, eager8)}; kernel "
            f"launches in a generate: {kernels or 'none'} (T5 runs no hand-written kernel)")
        if not torch.equal(graph8, eager8):
            fail(f"{label}: the captured generate gives other ids than the eager one")
        if worst_flush or _trim_eos(one) != solo:
            fail(f"{label}: {worst_flush} answers differ from t5_generate on their flush, "
                 f"or the one-shot ids of the stream's input differ")
        if max(len(p) for p, _ in flushes) < 2 or kernels:
            fail(f"{label}: the batcher coalesced nothing, or T5 launched {kernels}")
        d = float(np.abs(vector - direct_vec).max())
        log(f"{label}: /v1/embeddings from BERT-base with the WordPiece TPU_EMBED_TOKENIZER "
            f"({len(ids)} tokens): against bert_embed on the same ids max|d| {d:.3g} "
            f"(limit {EMBED_EQUAL_TOL}), norm {float(np.linalg.norm(vector)):.6f}")
        if d > EMBED_EQUAL_TOL:
            fail(f"{label}: the served embedding differs from bert_embed")
        bf16_params = params
        del app, stop, heng, emb
        gc.collect()
        torch.cuda.empty_cache()

        # -- 3. CUDA against the CPU (f32 twin) --------------------------------
        label = "seq2seq flan-t5-small f32"
        cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
        rng = np.random.default_rng(3)
        same_ids = {}
        for q, k, bi in ((bucket, bucket, True), (65, 65, False), (512, 512, True)):
            same_ids[f"{q}x{k} {'bidirectional' if bi else 'causal'}"] = bool(torch.equal(
                bucket_ids(q, k, bi, 32, 128, dev).cpu(),
                bucket_ids(q, k, bi, 32, 128, torch.device("cpu"))))
        rel = torch.arange(-1024, 1025)
        raw_same = {bi: bool(torch.equal(_rel_bucket(rel.to(dev), bi, 32, 128).cpu(),
                                         _rel_bucket(rel, bi, 32, 128))) for bi in (True, False)}
        with torch.inference_mode():
            p32 = init_t5(cfg32, 0, dev)
            host = _nested_to(torch, p32, "cpu")
            toks = torch.from_numpy(rng.integers(2, cfg.vocab_size, (2, 128)))
            lens = torch.tensor([128, 77])
            dec = torch.from_numpy(rng.integers(2, cfg.vocab_size, (2, 17)))
            dec[:, 0] = 0
            got = t5_decode(p32, dec.to(dev), t5_encode(p32, toks.to(dev), lens.to(dev), cfg32),
                            lens.to(dev), cfg32).cpu()
            want = t5_decode(host, dec, t5_encode(host, toks, lens, cfg32), lens, cfg32)
            cfg64 = dataclasses.replace(cfg, dtype=torch.float64)
            host64 = _nested_to(torch, host, torch.float64)
            wide = t5_decode(host64, dec, t5_encode(host64, toks, lens, cfg64), lens, cfg64)
        d_card, d_host = (got - want).double(), want.double() - wide
        dmax, drms = float(d_card.abs().max()), float(d_card.pow(2).mean().sqrt())
        hmax, hrms = float(d_host.abs().max()), float(d_host.pow(2).mean().sqrt())
        rms = float(want.pow(2).mean().sqrt())
        out["f32 cuda vs cpu"] = {"bucket_ids_equal": same_ids, "rel_bucket_on_device_equal":
                                  raw_same, "max_dlogits": dmax, "rms_dlogits": drms,
                                  "host_vs_f64_max": hmax, "host_vs_f64_rms": hrms,
                                  "logits_rms": rms}
        log(f"{label}: the card against the host CPU on the same weights: the model's bucket "
            f"ids (computed on the host, cached on the card) equal {same_ids}; _rel_bucket run "
            f"on the card over -1024..1024 equal to the CPU's {raw_same}; decoder logits "
            f"[2, 17, {cfg.vocab_size}] (rms {rms:.4g}) card against host max|d| {dmax:.4g}, "
            f"rms {drms:.4g}; host f32 against float64 max|d| {hmax:.4g}, rms {hrms:.4g} "
            f"(limit {T5_F32_VS_F64_FACTOR} x the host's)")
        if not all(same_ids.values()) or dmax > T5_F32_VS_F64_FACTOR * hmax \
                or drms > T5_F32_VS_F64_FACTOR * hrms:
            fail(f"{label}: the card's bucket ids or logits differ from the host's")
        del p32, host, host64
        step_done("f32 card against host")
        gc.collect()
        torch.cuda.empty_cache()

        # -- 4. int8 / int4 weights ---------------------------------------------
        label = "seq2seq flan-t5-small quantized"
        with torch.inference_mode():
            want = gen(tok8, len8, bf16_params).cpu()
        bf16_bytes = tree_device_bytes(bf16_params)
        out["quant"] = {"bf16": {"param_bytes": bf16_bytes, "device_ms_b8": ms8}}
        for mode in ("int8", "int4"):
            eng = InferenceEngine.from_config(MockConfig({
                "TPU_MODEL": "flan-t5-small", "TPU_QUANT": mode, "TPU_DEVICE": str(dev)}))
            try:
                with torch.inference_mode():
                    qms, got = graph_replay_ms(torch, lambda: gen(tok8, len8, eng.params))
                got = got.cpu()
                share = float((got == want).float().mean())
                rows = [_trim_eos(r) for r in got.tolist()]
                out["quant"][mode] = {"param_bytes": eng.param_bytes(), "device_ms_b8": qms,
                                      "ids_equal_share": share}
                log(f"{label} {mode}: TPU_QUANT through from_config: param_bytes "
                    f"{eng.param_bytes()} (bf16 {bf16_bytes}); device {qms:.3f} ms a [8, {bucket}]"
                    f" generate as a graph replay (bf16 {ms8:.3f}); share of ids equal to bf16's on the same "
                    f"batch {share:.3f}; answer lengths {[len(r) for r in rows]}")
                if eng.quant != mode or eng.param_bytes() >= bf16_bytes:
                    fail(f"{label} {mode}: the engine's weights are not {mode}")
            finally:
                eng.close()
        del bf16_params
        step_done("int8 and int4")
        gc.collect()
        torch.cuda.empty_cache()

        # -- 5. load_hf_t5 at flan-t5-large's widths -------------------------------
        label = (f"seq2seq load_hf_t5 flan-t5-large widths, {T5_LARGE_LAYERS}+"
                 f"{T5_LARGE_LAYERS} layers")
        ckpt = os.path.join(tmp, "flan-t5-large")
        os.makedirs(ckpt)
        with open(os.path.join(ckpt, "config.json"), "w") as fp:
            json.dump(dict(T5_LARGE_CONFIG, num_layers=T5_LARGE_LAYERS,
                           num_decoder_layers=T5_LARGE_LAYERS), fp)
        large = config_from_hf_t5(ckpt)
        n_params = t5_param_count(large)
        free = shutil.disk_usage(tmp).free
        if free < 4 * n_params:
            fail(f"{label}: {free} bytes free under {tmp}, need {4 * n_params}")
        t0 = time.perf_counter()
        tensors = hf_t5_tensors(torch, large, dev)
        if sum(t.numel() for t in tensors.values()) != n_params:
            fail(f"{label}: the checkpoint's tensors hold other than {n_params} parameters")
        nbytes = write_safetensors(os.path.join(ckpt, "model.safetensors"), tensors)
        write_s = time.perf_counter() - t0
        li, lj = large.n_layers // 2, large.n_layers - 1  # the layers checked after the load
        probe_q = tensors[f"encoder.block.{li}.layer.0.SelfAttention.q.weight"].t().contiguous()
        probe_wi = tensors[f"decoder.block.{lj}.layer.2.DenseReluDense.wi_1.weight"].t().contiguous()
        del tensors
        gc.collect()
        torch.cuda.empty_cache()
        log(f"{label}: {n_params / 1e9:.3f} B parameters, {nbytes / 1e9:.3f} GB of random bf16 "
            f"weights written in {write_s:.1f} s")
        out["loader"] = {"parameters": n_params, "bytes": nbytes, "write_s": write_s}
        gtok = torch.from_numpy(rng.integers(2, large.vocab_size, (8, 128))).to(dev)
        glen = torch.full((8,), 128, device=dev)
        for mode in ("", "int8"):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            lp = load_hf_t5(ckpt, None, quant=mode, device=dev)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            lpeak = torch.cuda.max_memory_allocated() - base
            q = lp["encoder"]["sa_wq"][li]
            wi = lp["decoder"]["w_up"][lj]
            if mode:
                wq = quantize_array(probe_q)
                ok = (torch.equal(q.q, wq.q) and torch.equal(q.s, wq.s)
                      and torch.equal(wi.q, quantize_array(probe_wi).q))
            else:
                ok = torch.equal(q, probe_q) and torch.equal(wi, probe_wi)
            with torch.inference_mode():
                lms, ids = graph_replay_ms(
                    torch, lambda: t5_generate(lp, gtok, glen, large, max_new=64))
            name = mode or "bf16"
            out["loader"][name] = {"load_s": load_s, "gb_s": nbytes / load_s / 1e9,
                                   "peak_bytes": lpeak, "device_ms_8x128": lms,
                                   "param_bytes": tree_device_bytes(lp)}
            log(f"{label} {name}: loaded in {load_s:.2f} s ({nbytes / load_s / 1e9:.2f} GB/s of "
                f"the file), peak {lpeak / 2**30:.3f} GiB over the load "
                f"({out['loader'][name]['param_bytes'] / 2**30:.3f} GiB of parameters); leaves "
                f"against the file{' quantized on the card' if mode else ''} equal {ok}; device "
                f"{lms:.3f} ms a [8, 128] generate of 64 steps (a graph replay); ids "
                f"{tuple(ids.shape)}")
            if not ok or ids.shape != (8, 64) or int(ids.min()) < 0:
                fail(f"{label} {name}: the loaded tree or its generate is wrong")
            del lp, q, wi
            gc.collect()
            torch.cuda.empty_cache()
            step_done(f"load_hf_t5 {name}")
    finally:
        timer.cancel()
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase_seq2seq done in {time.perf_counter() - t_phase:.1f} s; steps ended at "
        + json.dumps({k: round(v, 1) for k, v in out["step_s"].items()}))
    return out


def hf_t5_tensors(torch, cfg, dev) -> dict:
    """Random bf16 weights (std 0.02, norms one) of an HF T5 checkpoint of
    ``cfg``, under transformers' tensor names: [out, in] linears, the bias
    tables in block 0 of each stack, gated ``wi_0``/``wi_1``, an untied
    ``lm_head``."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    D, A, F, L = cfg.d_model, cfg.n_heads * cfg.d_kv, cfg.d_ff, cfg.n_layers

    def w(*shape):
        return (torch.randn(shape, generator=gen, device=dev) * 0.02).to(torch.bfloat16)

    def ones(n):
        return torch.ones(n, dtype=torch.bfloat16, device=dev)

    t = {"shared.weight": w(cfg.vocab_size, D)}
    for side in ("encoder", "decoder"):
        for i in range(L):
            b = f"{side}.block.{i}.layer."
            for j, kind in enumerate(["SelfAttention"] + (["EncDecAttention"]
                                                          if side == "decoder" else [])):
                for p in "qkv":
                    t[f"{b}{j}.{kind}.{p}.weight"] = w(A, D)
                t[f"{b}{j}.{kind}.o.weight"] = w(D, A)
                t[f"{b}{j}.layer_norm.weight"] = ones(D)
                if i == 0 and j == 0:
                    t[f"{b}0.SelfAttention.relative_attention_bias.weight"] = w(
                        cfg.rel_buckets, cfg.n_heads)
            f = 2 if side == "decoder" else 1
            t[f"{b}{f}.DenseReluDense.wi_0.weight"] = w(F, D)
            t[f"{b}{f}.DenseReluDense.wi_1.weight"] = w(F, D)
            t[f"{b}{f}.DenseReluDense.wo.weight"] = w(D, F)
            t[f"{b}{f}.layer_norm.weight"] = ones(D)
        t[f"{side}.final_layer_norm.weight"] = ones(D)
    t["lm_head.weight"] = w(cfg.vocab_size, D)
    return t


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

    def stamp(phase: str) -> None:
        log(f"chip_smoke: {phase} ended at {time.perf_counter() - t_start:.1f} s")

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
        family_kernels = phase_family_kernels(torch, dev)
    stamp("the kernel phases")
    tiny_counts = phase_tiny_models(torch, dev)
    phase_attention_grad(torch, dev)
    phase_window_grad(torch, dev)
    stamp("phase_window_grad")
    with torch.inference_mode():
        cfg = get_model("llama-3-8b").config
        t0 = time.perf_counter()
        params = init_params(cfg, seed=0, device=dev)
        torch.cuda.synchronize()
        log(f"params: llama-3-8b random bf16 weights on the card in "
            f"{time.perf_counter() - t0:.1f} s "
            f"({sum(p.numel() for p in params.values()) / 1e9:.2f} B parameters)")
        forward_counts = phase_forward(torch, dev, cfg, params)
    stamp("phase_forward")
    counts, base, base_stats = phase_serve(torch, dev, params)
    pool_kv = dict(kv_block=32, kv_quant="int8", kv_pool_blocks=161)
    pool_counts, pool_base, pool_stats = phase_serve(torch, dev, params, **pool_kv)
    options = {"bf16 slot cache": phase_serve_options(torch, dev, params, base, base_stats),
               "int8 pool": phase_serve_options(torch, dev, params, pool_base, pool_stats,
                                                **pool_kv)}
    # The App over HTTP, with its own seed-0 weights beside these; freed
    # (App.stop, then the engine dropped) before the profiles.
    http = phase_http(torch, dev, base, base_stats)
    http_counts = http["counts"]
    stamp("phase_http")
    # Config 4, offline batch inference over pub/sub, with the data plane
    # (SQL, Redis, the trace exporter, /debug/*, new_cmd) on the same App.
    pubsub = phase_pubsub(torch, dev, base, base_stats)
    stamp("phase_pubsub")
    # Configs 5 and 3 over gRPC, service to service, seq2seq over gRPC.
    grpc_run = phase_grpc(torch, dev, base, base_stats, http["stats"])
    stamp("phase_grpc")
    gc.collect()
    torch.cuda.empty_cache()
    bf16_tok, int8_tok = (cfg.n_layers * kv_bytes(1, cfg.n_kv_heads, cfg.head_dim, quant)
                          for quant in (False, True))
    log(f"serve: KV cache bytes a token: {bf16_tok} bf16, {int8_tok} int8 with scales; "
        f"bf16 slot cache (8 x 2048 tokens) {8 * 2048 * bf16_tok}, int8 slot cache "
        f"{8 * 2048 * int8_tok}, int8 pool (161 blocks of 32) {161 * 32 * int8_tok}")
    decode_loop = phase_decode_loop(torch, dev, cfg, params, base, base_stats)
    stamp("phase_decode_loop")
    spec = phase_spec(torch, dev, cfg, params, base, base_stats, pool_base, pool_stats, pool_kv)
    stamp("phase_spec")
    prefix = phase_prefix(torch, dev, cfg, params)
    stamp("phase_prefix")
    with torch.inference_mode():
        phase_profile(torch, dev, cfg, params, sampler=True, graph=True)
    # int8/int4 weights and TPU_CHECKPOINT, on these bf16 weights.
    quant = phase_quant(torch, dev, cfg, params, base_stats)
    stamp("phase_quant")
    loader = phase_loader(torch, dev, cfg, params, quant.pop("int8_params"),
                          quant["int8"]["streams"])
    stamp("phase_loader")
    # Multi-LoRA on these bf16 weights (its training part runs on
    # llama-1b after phase_train).
    lora = phase_lora(torch, dev, cfg, params, base)
    stamp("phase_lora")
    # Tokenizers and device services on the same seed-0 weights.
    device_services = phase_device_services(torch, dev, cfg, params)
    stamp("phase_device_services")
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
    # Speculative decoding past the window: G = 2 against depth 1's run.
    mspec_counts, mspec, mspec_stats = phase_serve(torch, dev, mparams, **mserve, spec_tokens=2)
    check_streams(torch, mcfg, mparams, "spec serve mistral-7b", mprompts, mbase, mspec,
                  [True] * len(mprompts))
    log("spec A/B mistral-7b bf16 slot cache: " + json.dumps(
        {f"G={g}": {x: st.get(x) for x in ("tok_s", "ttft_p50_ms", "itl_p50_ms",
                                           "tokens_per_step", "windows", "syncs", "counts")}
         for g, st in ((0, mstats), (2, mspec_stats))}))
    mpool_kv = dict(kv_block=32, kv_quant="int8", kv_pool_blocks=641)
    mpool_counts = phase_serve(torch, dev, mparams, **mserve, **mpool_kv)[0]
    bf16_tok, int8_tok = (mcfg.n_layers * kv_bytes(1, mcfg.n_kv_heads, mcfg.head_dim, quant)
                          for quant in (False, True))
    log(f"serve mistral-7b: KV cache bytes a token: {bf16_tok} bf16, {int8_tok} int8 with "
        f"scales; bf16 slot cache (4 x 8192 tokens) {4 * 8192 * bf16_tok}, int8 pool (641 "
        f"blocks of 32) {641 * 32 * int8_tok}")
    with torch.inference_mode():
        # No plain pass at 8192: a layer's f32 scores, [2, 32, 8192, 8192],
        # are 17 GB alone.
        mfull = phase_full_sequence(torch, dev, "mistral-7b", mcfg, mparams, (8192, 5000),
                                    plain=False, seed=23)
        phase_profile(torch, dev, mcfg, mparams, S=4, max_len=8192, context=6000,
                      model="mistral-7b")
    del mparams
    gc.collect()
    torch.cuda.empty_cache()

    stamp("mistral-7b")
    moe = phase_moe(torch, dev)
    stamp("phase_moe")

    families = {model: phase_family(torch, dev, model, pool=pool, full_sequence=full,
                                    max_len=max_len)
                for model, pool, full, max_len in FAMILY_SERVES}

    stamp("phase_family")
    train = phase_train(torch, dev)
    counts["flash_attention"] = train["counts"]["flash_attention"]
    compute = {k: p.to(train["cfg"].dtype) for k, p in train.pop("params").items()}
    phase_prefill_padded(torch, dev, train["cfg"], compute)
    del compute
    gc.collect()
    torch.cuda.empty_cache()
    lora_train = phase_lora_train(torch, dev)
    stamp("phase_lora_train")
    # The other decoder families and MoE through make_train_step, then the
    # encoder and vision families behind the dynamic batcher.
    family_train = phase_family_train(torch, dev)
    stamp("phase_family_train")
    encoders = phase_encoders(torch, dev)
    stamp("phase_encoders")
    # T5 behind the batcher, the tokenizer.json kinds and the auth
    # enablers: no attention kernel on this path (the kernels line is
    # unchanged).
    phase_seq2seq(torch, dev)
    stamp("phase_seq2seq")

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
    # The other families' cases (FAMILY_HEADS): launches from that
    # model's bf16 serve (bf16 slot cache), its int8-pool serve where it
    # has one (paged+int8 B=32), else its forward runs; flash_attention's
    # from the model's transformer_prefill [3, 2048] (the windowed case is
    # on no family's path: Gemma has no window).
    for k in ("flash_decode", "flash_cache_attention"):
        for case in family_kernels[k]:
            model, variant = case["case"].split(" ", 1)
            fam = families[model]
            if variant == "bf16 slot cache":
                case.update(launches=fam["serve"]["counts"][k], launches_from=f"serve {model}")
            elif variant == "paged+int8 B=32" and "pool" in fam:
                case.update(launches=fam["pool"]["counts"][k],
                            launches_from=f"serve {model} " + json.dumps(fam["pool"]["kv"]))
            else:
                case.update(launches=fam["forward"][variant][k],
                            launches_from=f"{model} forward")
            kstats[k]["cases"].append(case)
    for case in family_kernels["flash_attention"]:
        model = case["case"].split(" ", 1)[0]
        full = families[model].get("full") if "window" not in case["case"] else None
        case.update(launches=full["transformer_prefill"] if full else None,
                    launches_from=f"{model} transformer_prefill [3, 2048]" if full
                    else "not counted: on no served path (Gemma has no window)")
        kstats["flash_attention"]["cases"].append(case)
    for k in replaces:
        checks = kstats[k]["cases"] + prefix["kernels"].get(k, [])
        kstats[k]["max_abs_err"] = max(c["max_abs_err"] for c in checks)
        kstats[k]["max_row_rel_err"] = max(c["max_row_rel_err"] for c in checks)
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
        entry["launches_pubsub"] = {"INPROC wave": pubsub["counts"][k],
                                    "MQTT wave": pubsub["mqtt_counts"][k]}
        entry["launches_grpc"] = {"10 GenerateStream RPCs": grpc_run["wave_counts"][k],
                                  "config-5 legs": grpc_run["counts"][k]}
        entry["launches_decode_loop"] = {label: st["counts"][k] for label, st in
                                         decode_loop["settings"].items()}
        entry["launches_mistral_prefill_depth_4"] = mdeep_counts[k]
        entry["launches_spec"] = {
            "a replayed spec window (k=8, G=2)": spec["launches_a_window"].get(k, 0),
            **{f"serve {label} G=2": ab["G=2"]["counts"][k] for label, ab in spec["ab"].items()},
            "serve mistral-7b G=2": mspec_counts[k]}
        # The prefix cache's serves (launches over each wave) and the
        # kernel held on tables that alias shared blocks.
        entry["launches_prefix"] = {run: st["counts"][k] for run, st in prefix["runs"].items()}
        entry["prefix_aliased"] = prefix["kernels"][k]
    # The quantized weights' serves (phase_quant, phase_loader) and
    # Mixtral-8x7B's (phase_moe): its serves and forward check for the
    # serving kernels, its full-sequence entry points for flash_attention.
    for entry in kernels:
        k = entry["name"]
        if k == "flash_attention":
            entry["launches_moe"] = {f"mixtral-8x7b {e}": n for e, n in moe["full"].items()}
            continue
        entry["launches_quant"] = {
            "serve llama-3-8b int8 weights": quant["int8"]["counts"][k],
            "serve llama-3-8b int4 weights": quant["int4"]["counts"][k],
            "serve llama-3-8b int8 from TPU_CHECKPOINT": loader["int8"]["counts"][k]}
        entry["launches_moe"] = {
            "serve mixtral-8x7b int8 weights, bf16 slot cache": moe["serve"]["counts"][k],
            "serve mixtral-8x7b int8 weights, int8 pool": moe["pool"]["counts"][k],
            "mixtral-8x7b forward, bf16 slot cache": moe["forward"]["contiguous"][k]}
    # Multi-LoRA's runs: the serves and forward checks of phase_lora (the
    # serving kernels and flash_attention's forward with the adapter
    # plane), make_lora_train_step's steps (flash_attention).
    for entry in kernels:
        k = entry["name"]
        entry["launches_lora"] = {run: c[k] for run, c in lora["counts"].items() if c[k]}
        if k == "flash_attention":
            entry["launches_lora"].update({
                f"make_lora_train_step llama-1b [4, 2048], 6 steps, {mode} base":
                    lora_train[mode]["counts"][k] for mode in ("bf16", "int8")})
    # The device-services phase: its two waves through TPU_TOKENIZER and
    # the lockcheck child's (4 layers) wave.
    for entry in kernels:
        k = entry["name"]
        if k != "flash_attention":
            entry["launches_device_services"] = {
                run: c[k] for run, c in device_services["counts"].items()}
    # flash_attention over the family training cells and the encoder and
    # vision serves (ViT-B/16; row 3v of PERF.md is its serving shape).
    fa_entry = next(x for x in kernels if x["name"] == "flash_attention")
    fa_entry["launches_family_train"] = family_train["counts"]
    fa_entry["launches_encoders"] = encoders["flash_attention launches"]
    for case in fa_entry["cases"]:
        if case["case"] == "vit-b/16":
            case.update(launches=encoders["flash_attention launches"],
                        launches_from="phase_encoders: vit-base forward and serve")
    # Every kernel's launches over each family's runs.
    for entry in kernels:
        k = entry["name"]
        entry["launches_families"] = {}
        for model, fam in families.items():
            runs = {"forward, bf16 slot cache": fam["forward"]["contiguous"][k],
                    "serve bf16": fam["serve"]["counts"][k]}
            if "pool" in fam:
                runs["serve int8 pool"] = fam["pool"]["counts"][k]
            if "full" in fam and k == "flash_attention":
                runs.update(fam["full"])
            entry["launches_families"][model] = runs
    log(f"chip_smoke: wall time {time.perf_counter() - t_start:.1f} s, the build included")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
