"""Device-wide synchronizes against the port's CUDA graph captures, on a card.

    python scripts/torch_capture_race.py ops            # which calls on another
                                                        # thread invalidate a capture
    python scripts/torch_capture_race.py ROOT [ROOT...] # per tree, in turn

``ops`` captures 0.5 s of small kernels with ``capture_error_mode=
"thread_local"`` while a second thread repeats one call, in a fresh
process per call, and prints whether the capture survived.

With tree roots (a checkout of the repo each), every root runs three
times in alternation, each in a fresh process: build a llama-1b engine,
call ``torch.cuda.synchronize()`` in a loop for 4 s on the building thread
at once, then generate 8 tokens. It prints whether the engine's graphs
were captured when its constructor returned and whether it generated.
Set ``TPU_COMPILE_CACHE_DIR`` to share one kernel build across roots.
"""

import subprocess
import sys
import threading
import time

OPS = ("none", "synchronize", "mem_get_info", "legacy_kernel", "malloc", "empty_cache",
       "item", "current_stream_sync", "event_sync")


def op_case(case: str) -> None:
    import torch

    dev = torch.device("cuda")
    x = torch.ones(1 << 20, device=dev)
    torch.cuda.synchronize()
    done, started = threading.Event(), threading.Event()
    res = {"other_n": 0}

    def other():
        started.wait()
        held = None
        while not done.is_set():
            try:
                if case == "synchronize":
                    torch.cuda.synchronize()
                elif case == "mem_get_info":
                    torch.cuda.mem_get_info(dev)
                elif case == "legacy_kernel":
                    torch.ones(8, device=dev).add_(1)
                elif case == "malloc":
                    held = torch.empty((64 << 20) + res["other_n"] * 4096, device=dev,
                                       dtype=torch.uint8)
                elif case == "empty_cache":
                    held = torch.empty((8 << 20) + res["other_n"] * 4096, device=dev,
                                       dtype=torch.uint8)
                    held = None
                    torch.cuda.empty_cache()
                elif case == "item":
                    torch.ones(1, device=dev).sum().item()
                elif case == "current_stream_sync":
                    torch.cuda.current_stream().synchronize()
                elif case == "event_sync":
                    e = torch.cuda.Event()
                    e.record()
                    e.synchronize()
            except Exception as exc:  # noqa: BLE001 — reported, the capture is the result
                res.setdefault("other_error", repr(exc)[:100])
            res["other_n"] += 1
            time.sleep(0.001)
        del held

    t = threading.Thread(target=other)
    t.start()
    g = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(g, capture_error_mode="thread_local"):
            y = x
            started.set()
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < 0.5:
                y = y + 1
        res["capture"] = "ok"
    except Exception as exc:  # noqa: BLE001
        res["capture"] = "INVALIDATED " + repr(exc)[:100]
    done.set()
    t.join()
    print(f"{case}: {res}", flush=True)


def engine_case(root: str) -> None:
    sys.path.insert(0, root)
    import torch

    from gofr_tpu_torch.serving.engine import InferenceEngine

    t0 = time.perf_counter()
    eng = InferenceEngine("llama-1b", n_slots=4, max_len=512, window_k=8, prefill_chunk=128,
                          prefill_batch=4, seed=0, device=torch.device("cuda:0"))
    t_ctor = time.perf_counter() - t0
    captured = eng._graphs is not None
    n, err, t1 = 0, None, time.perf_counter()
    while time.perf_counter() - t1 < 4.0 and err is None:
        try:
            torch.cuda.synchronize()
            n += 1
        except Exception as exc:  # noqa: BLE001
            err = repr(exc)[:100]
    try:
        gen = f"ok, {len(eng.generate_sync([1, 2, 3], max_new_tokens=8, timeout=120).token_ids)}"
    except Exception as exc:  # noqa: BLE001
        gen = "FAILED " + repr(exc)[:120]
    print(f"{root}: constructor {t_ctor:.2f} s, graphs captured at its return: {captured}; "
          f"{n} synchronizes, error {err}; generate: {gen}", flush=True)
    eng.close()


def main() -> None:
    args = sys.argv[1:]
    if args[:1] == ["--one-op"]:
        return op_case(args[1])
    if args[:1] == ["--one-engine"]:
        return engine_case(args[1])
    if args == ["ops"]:
        runs = [["--one-op", c] for c in OPS]
    else:
        runs = [["--one-engine", r] for _ in range(3) for r in args]
    for run in runs:
        r = subprocess.run([sys.executable, __file__, *run], capture_output=True, text=True,
                           timeout=600)
        lines = r.stdout.strip().splitlines()
        print(lines[-1] if lines else f"{run}: exit {r.returncode} {r.stderr[-400:]}",
              flush=True)


if __name__ == "__main__":
    main()
