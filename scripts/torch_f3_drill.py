#!/usr/bin/env python3
"""The F3 drill: many zero-drain admissions beside live decode on a
``dp=2&tp=2&zero_drain=1`` engine over NCCL, each rank on a card of its own.

    python3 scripts/torch_f3_drill.py [--admissions 50] [--layers 32]
                                      [--out logs/f3_drill.json]
    python3 scripts/torch_f3_drill.py --cpu      # rehearsal: gloo ranks, llama-tiny

A zero-drain mesh runs its staging segments on a stream of their own, whose
collectives go over process groups of their own (``parallel/comm.StreamMesh``),
while the ring's decode graphs run their collectives on the world, dp and tp
groups. NCCL does not promise that two communicators' kernels run at once
on a device; a scoring forward's all-reduce beside the ring's verify graphs
hung two H100s, which is why forwards park the ring. This drill asks
whether the staging collectives can hang the same way.

Llama-3-8b widths (random weights, bf16, seed 0, 4 slots × 8 192, the
default 512-token segments) on ``cuda:0`` … ``cuda:3``. Two live greedy
streams decode throughout (restarted as they end; every token's arrival
time kept); two threads submit ``--admissions`` prompts between 2 000 and
6 000 tokens (uniform, seeded) for 4 tokens each, so up to two admissions
stage at once beside the two live rows. An admission that does not finish
within ``--timeout`` seconds is a hang: every rank dumps its stacks
(``parallel/ranks.STACKS_ENV``, every 2 × ``--timeout`` seconds), the
drill writes what it saw, ends the workers and exits 1.
Otherwise it prints and writes one JSON object: the admissions completed,
their TTFT (median and largest), the live streams' longest gap between
tokens and their median, the gaps of tokens that arrived while an
admission staged, the engine's ``admission_overlap_total`` (registrations
onto a live ring) and the workers' collectives; exit 0.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import statistics
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def drill(args) -> dict:
    import torch

    from quorum_tpu_torch.engine.engine import InferenceEngine
    from quorum_tpu_torch.models.model_config import resolve_spec
    from quorum_tpu_torch.ops.sampling import SamplerConfig
    from quorum_tpu_torch.parallel import MeshConfig, make_mesh

    if args.cpu:
        spec = resolve_spec("llama-tiny", {"dtype": "float32", "max_seq": "1024"})
        cards, lo, hi = ["cpu"] * 4, 200, 600
    else:
        spec = resolve_spec("llama-3-8b", {"n_layers": str(args.layers)})
        cards, lo, hi = [f"cuda:{i}" for i in range(4)], 2000, 6000
        if torch.cuda.device_count() < 4:
            raise SystemExit(f"the drill needs four cards; this machine has "
                             f"{torch.cuda.device_count()}")
    greedy = SamplerConfig(temperature=0.0)
    gen = random.Random(args.seed)
    t0 = time.perf_counter()
    eng = InferenceEngine(spec, mesh=make_mesh(MeshConfig(dp=2, tp=2), cards, timeout_s=60.0),
                          n_slots=4, decode_chunk=8, seed=0, zero_drain=True)
    out = {"layers": spec.n_layers, "cards": cards, "backend": eng.mesh.backend,
           "decode": eng.health()["mesh"]["decode"], "build_s": round(time.perf_counter() - t0, 3),
           "admissions_wanted": args.admissions, "prompt_tokens": [lo, hi]}
    stop = threading.Event()
    arrivals: list[list[float]] = [[], []]
    errors: list[str] = []

    def live(i):
        prompt = [gen.randrange(spec.vocab_size) for _ in range(64)]
        while not stop.is_set():
            try:
                it = eng.generate_stream(prompt, max_new_tokens=spec.max_seq - 128,
                                         sampler=greedy)
                for _ in it:
                    arrivals[i].append(time.perf_counter())
                    if stop.is_set():
                        break
                it.close()
            except Exception as e:  # noqa: BLE001 - the drill's finding
                errors.append(f"live {i}: {type(e).__name__}: {e}"[:300])
                return

    lives = [threading.Thread(target=live, args=(i,), daemon=True) for i in range(2)]
    for t in lives:
        t.start()
    deadline = time.perf_counter() + 300
    while min(len(a) for a in arrivals) < 16 and time.perf_counter() < deadline and not errors:
        time.sleep(0.01)
    lengths = [gen.randint(lo, hi) for _ in range(args.admissions)]
    prompts = [[gen.randrange(spec.vocab_size) for _ in range(n)] for n in lengths]
    windows: list[tuple[float, float]] = []
    ttft: list[float] = []
    done = [0]
    lock = threading.Lock()
    m0 = eng.metrics()

    def admit(idx):
        for j in idx:
            t_sub = time.perf_counter()
            req = eng.submit(prompts[j], max_new_tokens=4, sampler=greedy)
            first = None
            try:
                for _ in eng.stream_results(req):
                    if first is None:
                        first = time.perf_counter()
            except Exception as e:  # noqa: BLE001 - the drill's finding
                errors.append(f"admission {j}: {type(e).__name__}: {e}"[:300])
                return
            with lock:
                windows.append((t_sub, first))
                ttft.append(first - t_sub)
                done[0] += 1

    t_start = time.perf_counter()
    workers = [threading.Thread(target=admit, args=(range(k, args.admissions, 2),), daemon=True)
               for k in range(2)]
    for t in workers:
        t.start()
    seen, last = 0, time.perf_counter()
    while any(t.is_alive() for t in workers):  # a hang: no admission done for --timeout s
        time.sleep(0.1)
        if done[0] != seen:
            seen, last = done[0], time.perf_counter()
        elif time.perf_counter() - last > args.timeout:
            break
    hung = any(t.is_alive() for t in workers)
    out.update(admissions_completed=done[0], hung=hung, errors=errors,
               drill_s=round(time.perf_counter() - t_start, 3))
    stop.set()
    for t in lives:
        t.join(30 if not hung else 1)
    m1 = eng.metrics()
    gaps = [b - a for arr in arrivals for a, b in zip(arr[16:], arr[17:])]
    beside = [b - a for arr in arrivals for a, b in zip(arr, arr[1:])
              if any(s < b and a < f for s, f in windows)]
    out.update(
        ttft_s_median=statistics.median(ttft) if ttft else None,
        ttft_s_max=max(ttft) if ttft else None,
        live_tokens=[len(a) for a in arrivals],
        live_gap_s_median=statistics.median(gaps) if gaps else None,
        live_gap_s_max=max(gaps) if gaps else None,
        live_gap_beside_admissions_s_max=max(beside) if beside else None,
        admission_overlap=m1["admission_overlap_total"] - m0["admission_overlap_total"],
        prefill_segments=m1["prefill_segments_total"] - m0["prefill_segments_total"])
    if hung:  # a hung rank's collective never returns: end the workers, no teardown
        for r in range(1, eng.mesh.size):
            eng._ranks.kill(r)
    else:
        out["worker_collectives"] = [r["collectives"] for r in eng.rank_reports()]
        eng.shutdown()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--admissions", type=int, default=50)
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--timeout", type=float, default=120.0,
                    help="seconds one admission may take before the drill calls it a hang")
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(ROOT, "logs", "f3_drill.json"))
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    os.environ.setdefault("QUORUM_RANK_STACKS_S", str(2 * args.timeout))
    out = drill(args)
    if not args.cpu:
        import subprocess

        out["measured_on"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip().splitlines()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    ok = not out["hung"] and not out["errors"] and out["admissions_completed"] == args.admissions
    if out["hung"]:
        os._exit(1)  # rank 0's own collective never returns: leave without a teardown
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
