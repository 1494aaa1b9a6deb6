#!/usr/bin/env python3
"""Does a ``torch.profiler`` session that starts and stops while another
thread launches work on the card hang, and for which kind of launch?

    python3 scripts/torch_profiler_stop_probe.py [--kernels 10000] [--sessions 8]
                                                 [--timeout 60]

Each case runs in a child process. A worker thread launches on its own
stream at about a 32-layer decode's kernel rate (≈ 125 000 a second)
while the main thread runs ``--sessions`` profiler sessions (CPU + CUDA
activity, 0.3 s each, the trace discarded):

  eager         small elementwise kernels launched one by one
  graph         replays of one CUDA graph of ``--kernels`` small kernels
                (a 32-layer 8-step decode dispatch of the port is ≈ 10 000)
  graph_gated   as graph, with replays and the session's start and stop
                behind ``ops.launches.GRAPH_LAUNCH_GATE``, as the port runs
  k2_eager      the port's K2 (``flash_decode_attention``, built from
                ``quorum_tpu_torch/csrc``) at a 4-slot 8192-position bf16
                shape, 32 calls and 40 small kernels each time, eagerly
  k2_graph      one CUDA graph of 256 such K2 calls with 40 small kernels
                after each (a 32-layer 8-step decode's K2 count), replayed
                ungated

A session whose start or stop has not returned after ``--timeout`` seconds
dumps every thread's stack to stderr and ends the child: that case hung.
One JSON line per case (its outcome, each stop's seconds, the worker's
launches), the card's name and power limit first. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = ("eager", "graph", "graph_gated", "k2_eager", "k2_graph")


def child(case: str, n_kernels: int, sessions: int, timeout: float) -> None:
    import contextlib
    import faulthandler

    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, ROOT)
    from quorum_tpu_torch.ops.launches import GRAPH_LAUNCH_GATE

    gate = GRAPH_LAUNCH_GATE if case == "graph_gated" else contextlib.nullcontext()
    dev = torch.device("cuda", 0)
    stream = torch.cuda.Stream(dev)
    x = torch.ones(4096, device=dev)

    def small(n: int) -> None:
        for _ in range(n):
            x.mul_(1.0)

    body, n_body = (lambda: small(256)), 256
    if case.startswith("k2"):
        from quorum_tpu_torch.ops.flash_decode import flash_decode_attention

        gen = torch.Generator(device=dev).manual_seed(0)
        q = torch.randn(4, 32, 1, 128, device=dev, dtype=torch.bfloat16, generator=gen)
        kc = torch.randn(4, 8, 8192, 128, device=dev, dtype=torch.bfloat16, generator=gen)
        vc = torch.randn(4, 8, 8192, 128, device=dev, dtype=torch.bfloat16, generator=gen)
        lengths = torch.tensor([1, 100, 4096, 8191], device=dev, dtype=torch.int32)
        calls = 32 if case == "k2_eager" else 256

        def body() -> None:
            for _ in range(calls):
                flash_decode_attention(q, kc, vc, lengths)
                small(40)

        n_body = calls * 41
    graph = None
    if case in ("graph", "graph_gated", "k2_graph"):
        with torch.cuda.stream(stream):
            body() if case == "k2_graph" else small(3)  # warm before the capture
        stream.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            body() if case == "k2_graph" else small(n_kernels)
        n_body = n_body if case == "k2_graph" else n_kernels
    torch.cuda.synchronize()
    stop = threading.Event()
    launched = [0]

    def work() -> None:
        with torch.cuda.stream(stream):
            while not stop.is_set():
                if graph is None:
                    body()
                    launched[0] += n_body
                    stream.synchronize()
                    time.sleep(0.002)
                else:
                    with gate:
                        graph.replay()
                    launched[0] += n_body
                    stream.synchronize()
                    time.sleep(0.06)

    th = threading.Thread(target=work, daemon=True)
    th.start()
    time.sleep(0.5)
    stops = []
    for _ in range(sessions):
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        faulthandler.dump_traceback_later(timeout, exit=True)
        with gate:
            prof.start()
        time.sleep(0.3)
        t0 = time.perf_counter()
        with gate:
            prof.stop()
        stops.append(round(time.perf_counter() - t0, 4))
        faulthandler.cancel_dump_traceback_later()
        del prof
    stop.set()
    th.join()
    print(json.dumps({"case": case, "outcome": "returned", "stop_s": stops,
                      "kernels_launched": launched[0]}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", type=int, default=10000)
    ap.add_argument("--sessions", type=int, default=8)
    ap.add_argument("--timeout", type=float, default=60.0)
    ap.add_argument("--case", choices=CASES, help=argparse.SUPPRESS)  # the child's
    args = ap.parse_args(argv)
    if args.case:
        child(args.case, args.kernels, args.sessions, args.timeout)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({"card": smi.stdout.strip()}), flush=True)
    for case in CASES:
        t0 = time.perf_counter()
        try:
            p = subprocess.run([sys.executable, os.path.abspath(__file__), "--case", case,
                                "--kernels", str(args.kernels), "--sessions",
                                str(args.sessions), "--timeout", str(args.timeout)],
                               capture_output=True, text=True,
                               timeout=args.timeout * (args.sessions + 2) + 120)
        except subprocess.TimeoutExpired as e:
            p = subprocess.CompletedProcess(e.cmd, -9, e.stdout or "", "Timeout: killed")
            p.stdout = p.stdout.decode() if isinstance(p.stdout, bytes) else p.stdout
        lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
        if p.returncode == 0 and lines:
            print(lines[-1], flush=True)
        else:
            hung = "Timeout" in p.stderr or "most recent call first" in p.stderr
            print(json.dumps({"case": case, "outcome": "hung" if hung else "failed",
                              "rc": p.returncode, "seconds": round(time.perf_counter() - t0, 1),
                              "stderr_tail": p.stderr[-3000:]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
