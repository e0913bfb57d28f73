#!/usr/bin/env python3
"""Probe a 200 ms ``torch.profiler`` capture taken while an engine replays
CUDA graphs, on one CUDA card, four ways:

    python3 scripts/profiler_replay_probe.py [--model llama-3-8b] [--out FILE]

Each mode runs in a child process of its own (a fresh CUDA context, so the
profiler's CUDA tracer is first attached where the mode says), serving 8
requests of 100 prompt tokens and 400 new tokens through
``InferenceEngine`` (random weights from a seed, 8 slots, max_len 2048;
every decode window a CUDA graph replay), and takes the capture 1.5 s
into the wave:

* ``handoff+warm``: the engine as shipped — the profiler warmed before
  the graph capture (``profiler_capture.warm_up``) and the capture's
  start and stop handed to the scheduler thread (``trigger``);
* ``handoff``: the hand-off without the warm-up;
* ``warm``: the warm-up, and the start and stop on a thread of their own
  (``start_trace`` / ``stop_trace`` called directly);
* ``thread``: neither (the capture as it was before the hand-off).

A child prints one JSON line: the capture's wall time from trigger to
trace written, the trace's kernel launches, its ``flash_decode``
launches, the decode windows replayed during the capture, whether the
wave completed, and the card's name and power limit. A child that does
not end within ``--timeout`` seconds is killed and reported as hung. The
parent builds the kernel library once, first, so every child loads it,
and with ``--out`` writes the children's lines to that JSON file.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import threading
import time

MODES = ("handoff+warm", "handoff", "warm", "thread")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def child(mode: str, model: str) -> dict:
    import torch

    from gofr_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from gofr_tpu_torch.serving import profiler_capture
    from gofr_tpu_torch.serving.engine import InferenceEngine

    if "warm" not in mode:
        profiler_capture.warm_up = lambda device: None
    dev = torch.device("cuda", 0)
    cap = profiler_capture.get_capture(cooldown_s=0)
    eng = InferenceEngine(model, n_slots=8, max_len=2048, device=dev, seed=0)
    out: dict = {"mode": mode, "model": model}
    try:
        eng.generate_sync([1, 2, 3], max_new_tokens=4, timeout=300)  # the graphs are captured
        prompts = [[(7 * i + j) % 1000 + 1 for j in range(100)] for i in range(8)]
        reqs = [eng.submit_generate(p, max_new_tokens=400, stop_on_eos=False)
                for p in prompts]
        time.sleep(1.5)
        windows0 = eng.decode_windows
        reset_launch_counts()
        t0 = time.perf_counter()
        if mode.startswith("handoff"):
            if not cap.trigger(200, reason="probe"):
                raise RuntimeError(f"trigger refused: {cap.snapshot()}")
            while cap.busy and time.perf_counter() - t0 < 600:
                time.sleep(0.01)
        else:
            err: list = []

            def run() -> None:
                try:
                    cap.start_trace()
                    time.sleep(0.2)
                    cap.stop_trace()
                except Exception as exc:  # noqa: BLE001 — reported below
                    err.append(repr(exc))

            th = threading.Thread(target=run)
            th.start()
            th.join()
            if err:
                raise RuntimeError(err[0])
        out["capture_wall_s"] = time.perf_counter() - t0
        out["windows_during_capture"] = eng.decode_windows - windows0
        out["launches_during_capture"] = launch_counts()
        out["last_error"] = cap.snapshot()["last_error"]
        with open(cap.trace_file) as fp:
            events = json.load(fp).get("traceEvents", [])
        kernels = [e for e in events if e.get("cat") == "kernel"]
        names = collections.Counter(e.get("name", "")[:50] for e in kernels)
        out["trace_events"] = len(events)
        out["trace_kernels"] = len(kernels)
        out["trace_flash_decode"] = sum(v for k, v in names.items() if "flash_decode" in k)
        out["trace_top_kernels"] = names.most_common(5)
        graph_args = [e.get("args", {}) for e in kernels if "flash_decode" in e.get("name", "")]
        out["flash_decode_args_sample"] = graph_args[:1]
        out["trace_graph_launches"] = sum(
            1 for e in events if e.get("name", "") in ("cudaGraphLaunch", "cudaGraphLaunch_v10000"))
        if kernels:
            span_us = max(e["ts"] + e.get("dur", 0) for e in kernels) - min(e["ts"] for e in kernels)
            out["trace_kernel_span_ms"] = span_us / 1e3
        done = all(r.future.result(timeout=300) is not None for r in reqs)
        out["wave_completed"] = done
    finally:
        eng.close()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    out["card"] = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--child", default="")
    ap.add_argument("--model", default="llama-3-8b")
    ap.add_argument("--modes", default=",".join(MODES))
    ap.add_argument("--timeout", type=float, default=150.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child, args.model)), flush=True)
        return
    import torch

    if not torch.cuda.is_available():
        sys.exit("CUDA is not available: this probe runs on a card")
    from gofr_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    _build.lib()
    print(f"kernel library ready in {time.perf_counter() - t0:.1f} s", flush=True)
    results = []
    for mode in args.modes.split(","):
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, __file__, "--child", mode, "--model", args.model],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            stdout, stderr = proc.communicate(timeout=args.timeout)
            lines = [ln for ln in stdout.splitlines() if ln.startswith("{")]
            res = json.loads(lines[-1]) if lines else {
                "mode": mode, "rc": proc.returncode, "stderr": stderr[-2000:]}
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            res = {"mode": mode, "hung": True}
        res["child_wall_s"] = time.perf_counter() - t0
        print(json.dumps(res), flush=True)
        results.append(res)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fp:
            json.dump(results, fp, indent=1)


if __name__ == "__main__":
    main()
