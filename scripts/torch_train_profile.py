#!/usr/bin/env python3
"""Where one training step's device time goes, on the card.

    python3 scripts/torch_train_profile.py [--layers 32] [--tokens 2048] [--out FILE]

Builds llama-3-8b (bf16, seed 0; ``--layers`` cuts the depth) with the
default recipe, runs two steps of ``make_train_step`` to warm up (the
first step's allocator growth and library set-up), then one step under
``torch.profiler`` (CPU and CUDA activity), its forward + backward and its
optimizer update each inside a ``record_function`` range (the step's
``grads_hook`` closes the first and opens the second). Prints, and writes to ``FILE``
(default ``profiles/train_profile.json``) as one JSON object: the
step's wall ms and its two parts (host clock around synchronized work),
the device ms of every kernel by name (top 40) and summed by group of
names (GEMMs, copies, elementwise, reductions, other), with the card's
name and power limit. Then the plain attention alone at one layer's shapes
(``ops/attention.attention`` under the causal mask, inputs requiring
grad): device ms of its forward and of its forward and backward (CUDA
events, median of 5), and the step's share that is attention (32 layers ×
(one forward + one forward and backward): remat recomputes the forward).
Needs a card; it never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANGES = ("value_and_grad", "optimizer")


def _group(name: str) -> str:
    n = name.lower()
    if any(k in n for k in ("gemm", "cutlass", "xmma", "sm90_", "cublas", "nvjet")):
        return "gemm"
    if "memcpy" in n or "copy" in n:
        return "copy"
    if "reduce" in n or "softmax" in n or "norm" in n:
        return "reduction"
    if "elementwise" in n or "vectorized" in n or "unrolled" in n:
        return "elementwise"
    return "other"


def _attention_ms(torch, spec, t: int, layers: int, step_ms: float) -> dict:
    import statistics

    from quorum_tpu_torch.ops.attention import attention, causal_mask

    g = torch.Generator(device="cuda").manual_seed(1)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda",
                           dtype=torch.bfloat16).requires_grad_()

    q = rnd(1, spec.n_heads, t, spec.head_dim)
    k, v = rnd(1, spec.n_kv_heads, t, spec.head_dim), rnd(1, spec.n_kv_heads, t, spec.head_dim)
    mask = causal_mask(t, t, device="cuda")
    dout = torch.randn(1, spec.n_heads, t, spec.head_dim, device="cuda", dtype=torch.bfloat16)

    def timed(fn) -> float:
        fn()
        times = []
        for _ in range(5):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            torch.cuda.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)

    def fwd():
        with torch.enable_grad():
            attention(q, k, v, mask)

    def fwd_bwd():
        with torch.enable_grad():
            attention(q, k, v, mask).backward(dout)

    f, fb = timed(fwd), timed(fwd_bwd)
    per_step = layers * (f + fb)
    return {"forward_ms": round(f, 3), "forward_backward_ms": round(fb, 3),
            "per_step_ms": round(per_step, 3), "share_of_step": round(per_step / step_ms, 4)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=2048)
    ap.add_argument("--out", default=os.path.join(ROOT, "profiles", "train_profile.json"))
    a = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from quorum_tpu_torch.models.model_config import resolve_spec
    from quorum_tpu_torch.training import trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    spec = resolve_spec("llama-3-8b", {"n_layers": str(a.layers)})
    opt = trainer.make_optimizer()
    state = trainer.train_init(spec, device="cuda", seed=0, optimizer=opt)
    g = torch.Generator().manual_seed(0)
    tokens = torch.randint(1, spec.vocab_size, (1, a.tokens), generator=g).cuda()
    open_range = []
    marks = {}

    def hook(state, loss, grads):
        torch.cuda.synchronize()
        open_range.pop().__exit__(None, None, None)
        marks["grads"] = time.perf_counter()
        open_range.append(record_function(RANGES[1]))
        open_range[-1].__enter__()

    train_step = trainer.make_train_step(spec, device="cuda", optimizer=opt, grads_hook=hook)

    def step():
        nonlocal state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        open_range.append(record_function(RANGES[0]))
        open_range[-1].__enter__()
        state, loss = train_step(state, tokens)
        torch.cuda.synchronize()
        open_range.pop().__exit__(None, None, None)
        t2 = time.perf_counter()
        return float(loss), (marks["grads"] - t0) * 1e3, (t2 - marks["grads"]) * 1e3

    for _ in range(2):
        step()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        loss, fb_ms, opt_ms = step()
    rows, groups = [], {}
    for e in prof.key_averages():
        us = e.self_device_time_total
        if e.device_type.name != "CUDA" or not us or e.key in RANGES:
            continue  # the two ranges' own rows sum their kernels again
        rows.append((us, e.key, e.count))
        grp = _group(e.key)
        groups[grp] = groups.get(grp, 0.0) + us / 1e3
    rows.sort(reverse=True)
    total = sum(us for us, _, _ in rows) / 1e3
    ranges = {}
    for e in prof.key_averages():
        if e.key in RANGES:
            ranges[e.key] = round(getattr(e, "device_time_total", 0) / 1e3, 3)
    out = {"card": smi, "model": f"llama-3-8b L={a.layers}", "tokens": a.tokens, "loss": loss,
           "wall_ms": {"value_and_grad": round(fb_ms, 3), "optimizer": round(opt_ms, 3),
                       "step": round(fb_ms + opt_ms, 3)},
           "device_ms_total": round(total, 3),
           "device_ms_by_range": ranges,
           "device_ms_by_group": {k: round(v, 3) for k, v in sorted(groups.items())},
           "top_kernels": [{"name": k[:160], "ms": round(us / 1e3, 3), "calls": c}
                           for us, k, c in rows[:40]]}
    out["plain_attention"] = _attention_ms(torch, spec, a.tokens - 1, a.layers,
                                           fb_ms + opt_ms)
    os.makedirs(os.path.dirname(a.out), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
