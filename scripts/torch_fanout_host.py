#!/usr/bin/env python3
"""Where a fan-out's decode time goes when several engines share one card:
each engine's decode rate, by how the streams are spread over engines.

    python3 scripts/torch_fanout_host.py [--layers 32] [--tokens 64] [--reps 2]

Builds three llama-3-8b engines of the PyTorch port (bf16, seeds 0, 1, 2,
4 slots × 8192, ``decode_chunk=8``: the ``fanout`` phase of
``chip_smoke.py``) and streams greedy requests of ``--tokens`` tokens from a
300-token prompt straight through the engines, without the app:

  alone             one request on one engine
  batched_3         three requests on one engine (three rows of one batch)
  engines_2         one request on each of two engines at once
  engines_3         one request on each of three engines at once
  engines_3_pydll   as engines_3, with both kernels' C entry points called
                    through ``ctypes.PyDLL``, which keeps the interpreter
                    lock during the launch instead of releasing it

Each engine runs its own scheduler thread in this one process. Then the
three engines are freed and the same three weight sets are stacked on ONE
engine (``members=3``, seeds 0, 1, 2 — the ``members`` phase of
``chip_smoke.py``; both deployments do not fit the card at once):

  stacked_3         one request on each member of the stacked engine
  stacked_1         one request on member 0 of the stacked engine alone

Per variant: every stream's decode rate (tokens after the first over the
first-to-last span), the wall time, and the decode steps the engines ran.
The variants of each deployment run ``--reps`` times in turns (1 2 … n n …
2 1). Then ``engines_3``, ``alone`` and ``stacked_3`` once more under
``torch.profiler``: the card's busy share of the wall time. One JSON line per
reading, the card's name and power limit first. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import gc
import json
import os
import statistics
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PLANS = {  # variant → requests per engine
    "alone": (1,),
    "batched_3": (3,),
    "engines_2": (1, 1),
    "engines_3": (1, 1, 1),
    "engines_3_pydll": (1, 1, 1),
}
STACKED_PLANS = {  # variant → the members of the stacked engine, one request each
    "stacked_3": (0, 1, 2),
    "stacked_1": (0,),
}


def bind_kernels(cuda_build, loader) -> None:
    """Load both kernel libraries with ``loader`` (ctypes.CDLL or PyDLL);
    the wrappers declare the argument types again on first use."""
    for name in cuda_build.KERNEL_SOURCES:
        cuda_build._libs[name] = loader(str(cuda_build.library_path(name)))


def run(targets, prompt, tokens, sampler) -> dict:
    """Submit one request per ``(engine, member)`` target, drain each in its
    own thread, and time each token's arrival."""
    engines = list({id(e): e for e, _ in targets}.values())
    m0 = [e.metrics()["decode_steps_total"] for e in engines]
    reqs = [(e, e.submit(prompt, max_new_tokens=tokens, sampler=sampler, member=m))
            for e, m in targets]
    stamps: list[list[float]] = [[] for _ in reqs]

    def drain(i, engine, req):
        for _ in engine.stream_results(req):
            stamps[i].append(time.perf_counter())

    t0 = time.perf_counter()
    threads = [threading.Thread(target=drain, args=(i, e, r)) for i, (e, r) in enumerate(reqs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if any(t.is_alive() for t in threads):
        raise RuntimeError("a stream did not finish within 600 s")
    wall = time.perf_counter() - t0
    if any(len(s) != tokens for s in stamps):
        raise RuntimeError(f"streams delivered {[len(s) for s in stamps]} tokens, not {tokens}")
    rates = [(len(s) - 1) / (s[-1] - s[0]) for s in stamps]
    return {"tok_per_s_per_stream": rates, "tok_per_s_total": len(reqs) * tokens / wall,
            "wall_s": wall,
            "decode_steps": [e.metrics()["decode_steps_total"] - a
                             for e, a in zip(engines, m0)]}


def busy_share(torch, fn) -> dict:
    """The card's busy share of ``fn``'s wall time, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_ms = 0.0
    for ev in prof.key_averages():
        dev = getattr(ev, "self_device_time_total", None)
        busy_ms += (ev.self_cuda_time_total if dev is None else dev) / 1e3
    return {**out, "profiled_wall_s": wall, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / (wall * 1e3)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_fanout_host: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from quorum_tpu_torch.engine.engine import get_engine, shutdown_all_engines
    from quorum_tpu_torch.models.model_config import resolve_spec
    from quorum_tpu_torch.ops import cuda_build
    from quorum_tpu_torch.ops.sampling import SamplerConfig

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "torch": torch.__version__, "layers": args.layers,
                      "tokens": args.tokens}), flush=True)
    cuda_build.build_all()
    spec = resolve_spec("llama-3-8b", {"n_layers": str(args.layers)})
    engines = [get_engine(spec, seed=s, n_slots=4, decode_chunk=8) for s in range(3)]
    prompt = list(range(3, 303))
    greedy = SamplerConfig(temperature=0.0)

    def targets(name):
        if name in STACKED_PLANS:
            return [(engines[0], m) for m in STACKED_PLANS[name]]
        return [(e, 0) for e, n in zip(engines, PLANS[name]) for _ in range(n)]

    def variant(name):
        pydll = name.endswith("_pydll")
        if pydll:
            bind_kernels(cuda_build, ctypes.PyDLL)
        try:
            return run(targets(name), prompt, args.tokens, greedy)
        finally:
            if pydll:
                bind_kernels(cuda_build, ctypes.CDLL)

    readings: dict[str, list[dict]] = {name: [] for name in (*PLANS, *STACKED_PLANS)}

    def sweep(plans, warm, profile):
        run(targets(warm), prompt, 8, greedy)  # warm every engine and kernel
        order = list(plans)
        for rep in range(args.reps):
            for name in (order if rep % 2 == 0 else order[::-1]):
                out = variant(name)
                readings[name].append(out)
                print(json.dumps({"variant": name, "rep": rep, **out}), flush=True)
        for name in profile:
            out = busy_share(torch, lambda name=name: variant(name))
            print(json.dumps({"profiled": name, **out, "card": smi}), flush=True)

    sweep(PLANS, "engines_3", ("engines_3", "alone"))
    shutdown_all_engines()
    gc.collect()
    torch.cuda.empty_cache()
    engines = [get_engine(spec, seed=0, n_slots=4, decode_chunk=8, members=3)]
    sweep(STACKED_PLANS, "stacked_3", ("stacked_3",))
    for name, outs in readings.items():
        rates = [r for o in outs for r in o["tok_per_s_per_stream"]]
        print(json.dumps({"summary": name, "tok_per_s_per_stream_min": min(rates),
                          "tok_per_s_per_stream_median": statistics.median(rates),
                          "tok_per_s_per_stream_max": max(rates),
                          "tok_per_s_total": [o["tok_per_s_total"] for o in outs],
                          "wall_s": [o["wall_s"] for o in outs], "card": smi}), flush=True)
    shutdown_all_engines()
    return 0


if __name__ == "__main__":
    sys.exit(main())
