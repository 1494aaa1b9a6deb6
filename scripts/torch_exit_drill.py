#!/usr/bin/env python3
"""The lost-rank drill over NCCL, run to the process's exit, several times.

    python3 scripts/torch_exit_drill.py [--runs 4] [--log-dir logs]

Needs two cards. Each run is a child process: a tp=2 engine on ``cuda:0`` /
``cuda:1`` (llama-tiny, float32) starts a greedy stream, its worker rank is
killed (SIGKILL) three tokens in, the stream must end with ``WorkerLost``, a
later submit must be refused and ``shutdown()`` must return; then the child
reports whether any group abort is still running and ends by returning from
``main``, as a program would. The child runs with ``NCCL_DEBUG=INFO`` and
``TORCH_CPP_LOG_LEVEL=INFO``; its output goes to ``<log-dir>/exit_drill_<i>.log``.
The parent prints one JSON line per run (the child's exit code, whether its
log holds "terminate called", a CUDA failure or an abort error, and
the child's own report) and a summary line; it exits 0 only when every child
did.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def child() -> int:
    import time

    from quorum_tpu_torch.engine.engine import EngineBreakerOpen, InferenceEngine
    from quorum_tpu_torch.models.model_config import resolve_spec
    from quorum_tpu_torch.ops.sampling import SamplerConfig
    from quorum_tpu_torch.parallel import MeshConfig, make_mesh

    spec = resolve_spec("llama-tiny", {"dtype": "float32", "head_dim": "64", "n_kv_heads": "4",
                                       "max_seq": "2048"})
    prompt = [(5 + 3 * i) % 500 for i in range(60)]
    mesh = make_mesh(MeshConfig(tp=2), ["cuda:0", "cuda:1"])
    eng = InferenceEngine(spec, mesh=mesh, n_slots=2)
    it = eng.generate_stream(prompt, max_new_tokens=1500, sampler=SamplerConfig(temperature=0.0))
    [next(it) for _ in range(3)]
    t0 = time.perf_counter()
    eng._ranks.kill(1)
    error = None
    try:
        for _ in it:
            pass
    except Exception as e:
        error = type(e).__name__
    end_s = time.perf_counter() - t0
    try:
        eng.submit([1, 2, 3], max_new_tokens=4)
        refused = False
    except EngineBreakerOpen:
        refused = True
    t1 = time.perf_counter()
    eng.shutdown()
    report = {"error": error, "stream_end_s": round(end_s, 3), "refused": refused,
              "shutdown_s": round(time.perf_counter() - t1, 3),
              "aborts_running": [t.name for t in threading.enumerate()
                                 if t.name.endswith(("-abort", "-shutdown")) and t.is_alive()]}
    print("DRILL " + json.dumps(report), flush=True)
    return 0 if error and refused and not report["aborts_running"] else 1


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--log-dir", default=os.path.join(ROOT, "logs"))
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child()
    os.makedirs(args.log_dir, exist_ok=True)
    env = dict(os.environ, NCCL_DEBUG="INFO", TORCH_CPP_LOG_LEVEL="INFO")
    codes = []
    for i in range(1, args.runs + 1):
        path = os.path.join(args.log_dir, f"exit_drill_{i}.log")
        with open(path, "w") as log:
            rc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child"],
                                stdout=log, stderr=subprocess.STDOUT, env=env,
                                timeout=240).returncode
        text = open(path, errors="replace").read()
        drill = [ln[6:] for ln in text.splitlines() if ln.startswith("DRILL ")]
        row = {"run": i, "rc": rc, "terminate": "terminate called" in text,
               "cuda_failure": "Cuda failure" in text,
               "abort_error": "waiting for future ProcessGroup abort" in text,
               "drill": json.loads(drill[0]) if drill else None}
        print(json.dumps(row), flush=True)
        codes.append(rc)
    print(json.dumps({"runs": args.runs, "exit_codes": codes,
                      "all_zero": all(c == 0 for c in codes)}), flush=True)
    return 0 if all(c == 0 for c in codes) else 1


if __name__ == "__main__":
    sys.exit(main())
