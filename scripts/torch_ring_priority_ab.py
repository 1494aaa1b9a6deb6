#!/usr/bin/env python3
"""A live stream's decode gaps beside an embedding forward, with the decode
ring's CUDA stream at priority 0 against −1, in one process.

    python3 scripts/torch_ring_priority_ab.py [--reps 2] [--layers 32]
        [--budgets 16384,4096,2048]

Builds two llama-3-8b engines of the PyTorch port (bf16, seed 0, 4 slots,
``decode_chunk=8``): engine ``p0`` with ``RING_STREAM_PRIORITY = 0`` (both
of its streams at the default priority) and engine ``p-1`` with −1 (the
shipped setting; its forward stream stays at 0). Each trial streams one
greedy request of 512 tokens from a 300-token prompt and, once 16 tokens
have arrived, either sleeps 2 s (``alone``) or runs the ``chip_smoke.py``
surfaces phase's 64-input embedding request (ragged lengths 16–2 048,
seed 15) on the same engine's forward stream (``during``). Per trial: the
longest gap between token deliveries inside the window, the stream's
tokens/s inside it, and the window's wall ms (for ``during``, the
embedding request's). Trials run p0, p-1, p-1, p0, repeated ``--reps``
times. With ``--budgets``, the ``during`` trials run again on ``p-1`` at
each sub-batch budget (``embed.FORWARD_TOKENS``: smaller budgets mean
shorter forward kernels beside the decode), in the order given and then
reversed, ``--reps`` times; then ``during_json`` trials at the default
budget add the embeddings response's host work to the request (the
vectors as lists, then JSON), as the app does. One JSON line a trial,
the card's name and power limit first, a summary (medians) last. Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import random
import statistics
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def trial(eng, embed, prompt, inputs, during: bool, sampler) -> dict:
    """One live greedy stream; the longest delivery gap and the stream's
    tokens/s inside the window (2 s of sleep, or the embedding request)."""
    req = eng.submit(prompt, max_new_tokens=512, sampler=sampler)
    stamps: list[float] = []
    th = threading.Thread(target=lambda: stamps.extend(
        time.perf_counter() for _ in eng.stream_results(req)), daemon=True)
    th.start()
    while len(stamps) < 16:
        if not th.is_alive():
            raise RuntimeError("the live stream ended before 16 tokens")
        time.sleep(0.002)
    t0 = time.perf_counter()
    if during:
        embed(eng, inputs)
    else:
        time.sleep(2.0)
    t1 = time.perf_counter()
    th.join(timeout=600)
    if th.is_alive():
        raise RuntimeError("the live stream never finished")
    inside = [t for t in stamps if t0 <= t <= t1]
    gaps = [b - a for a, b in zip(stamps, stamps[1:]) if b >= t0 and a <= t1]
    return {"longest_gap_ms": max(gaps) * 1e3 if gaps else None,
            "tok_per_s": len(inside) / (t1 - t0), "window_ms": (t1 - t0) * 1e3}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--budgets", default="",
                    help="comma-separated FORWARD_TOKENS values to hold against each other")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_ring_priority_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from quorum_tpu_torch.engine import embed as embed_mod
    from quorum_tpu_torch.engine import engine as engine_mod
    from quorum_tpu_torch.engine.embed import embed_token_batch
    from quorum_tpu_torch.models.model_config import resolve_spec
    from quorum_tpu_torch.ops.sampling import SamplerConfig

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    emit(card=smi.strip().splitlines()[0] if smi.strip() else None,
         torch=torch.__version__, cuda=torch.version.cuda)
    spec = dataclasses.replace(resolve_spec("llama-3-8b", {}), n_layers=args.layers)
    engines = {}
    for prio in (0, -1):
        engine_mod.RING_STREAM_PRIORITY = prio
        engines[f"p{prio}"] = engine_mod.InferenceEngine(
            spec, device="cuda", seed=0, n_slots=4, decode_chunk=8)
    engine_mod.RING_STREAM_PRIORITY = -1
    rng = random.Random(15)
    lens = [16] + [rng.randint(16, 2048) for _ in range(62)] + [2048]
    inputs = [[rng.randrange(3, spec.vocab_size) for _ in range(n)] for n in lens]
    prompt = [random.Random(7).randrange(3, spec.vocab_size) for _ in range(300)]
    greedy = SamplerConfig(temperature=0.0)
    # Warm-up: each engine's decode graphs and one forward of every bucket.
    for eng in engines.values():
        list(eng.generate_stream(prompt, max_new_tokens=64, sampler=greedy))
        embed_token_batch(eng, inputs)
    torch.cuda.synchronize()
    rows = []
    for rep in range(args.reps):
        for name in ("p0", "p-1", "p-1", "p0"):
            for mode in ("alone", "during"):
                r = trial(engines[name], embed_token_batch, prompt, inputs, mode == "during",
                          greedy)
                row = {"rep": rep, "engine": name, "mode": mode, **r}
                rows.append(row)
                emit(**row)
    budgets = [int(b) for b in args.budgets.split(",") if b]
    default_budget = embed_mod.FORWARD_TOKENS
    for rep in range(args.reps if budgets else 0):
        for budget in budgets + budgets[::-1]:
            embed_mod.FORWARD_TOKENS = budget
            embed_token_batch(engines["p-1"], inputs)  # this budget's buckets, warm
            r = trial(engines["p-1"], embed_token_batch, prompt, inputs, True, greedy)
            row = {"rep": rep, "engine": "p-1", "mode": f"during_budget_{budget}", **r}
            rows.append(row)
            emit(**row)
    embed_mod.FORWARD_TOKENS = default_budget

    def embed_json(eng, token_lists):
        vecs = embed_token_batch(eng, token_lists)
        return json.dumps([{"object": "embedding", "index": i, "embedding": v}
                           for i, v in enumerate(vecs.tolist())])

    for rep in range(args.reps if budgets else 0):
        r = trial(engines["p-1"], embed_json, prompt, inputs, True, greedy)
        row = {"rep": rep, "engine": "p-1", "mode": "during_json", **r}
        rows.append(row)
        emit(**row)
    summary = {}
    for name, mode in sorted({(r["engine"], r["mode"]) for r in rows}):
        sel = [r for r in rows if r["engine"] == name and r["mode"] == mode]
        summary[f"{name}_{mode}"] = {
            k: statistics.median(r[k] for r in sel)
            for k in ("longest_gap_ms", "tok_per_s", "window_ms")}
    emit(summary=summary, layers=spec.n_layers, inputs=len(inputs), reps=args.reps)
    for eng in engines.values():
        eng.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
