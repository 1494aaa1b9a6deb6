#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (quorum_tpu_torch) on one GPU.

    python3 chip_smoke.py                  # the full check on the card
    python3 chip_smoke.py --cpu --tiny     # rehearsal: plain versions, llama-tiny, no GPU

Phases, each printing one JSON line; any failure exits nonzero before the
result line:

  1. device   the card's name and power limit (nvidia-smi);
  2. build    nvcc builds both kernels from csrc/ in parallel; ptxas's
              registers / shared memory / spills per kernel, and the count of
              HGMMA (wgmma) instructions in K1's library (must be > 0);
  3. kernels  K1 (prefill) and K2 (decode) against their plain versions on
              the card at llama-3-8b widths, f32 and bf16 (rows past a
              prompt's length must be exactly 0; K1 must take the route its
              wrapper names), with timings of the kernel, the plain version,
              one PyTorch library call (SDPA; for K1 both with the dense mask
              and with is_causal) and the least time the card could take
              (bound), plus K1 at the serve phase's three largest prompt
              buckets at their real lengths, and at B=3 ragged rows (one
              coalesced member admission) at the serve buckets;
  4. model    llama-3-8b widths at 2 layers: prefill + decode steps through
              the kernels against the same steps through the plain attention;
              then three stacked weight sets (members=3): the stacked prefill
              (K1 at B=3) and decode steps against each member alone, and the
              ensemble step against the mean of the members' logits;
  5. serve    the full 32-layer llama-3-8b (bf16, seed 0) behind the port's
              ASGI app with one cuda:// backend: 4 concurrent chat requests
              (streamed and not, greedy and sampled), launch counts of both
              kernels, first TTFT and decode-rate readings;
  6. fanout   three full 32-layer llama-3-8b members (bf16, seeds 0, 1, 2)
              behind one app, concatenate and aggregate (LLM1 aggregates):
              greedy requests one at a time on a 300-byte prompt (three
              different member texts, streamed texts equal to non-streamed
              ones, aggregates not degraded), then a concurrent burst of 4;
              launch counts of both kernels over the three engines, ticket
              counters at 0, peak memory;
  7. members  the same deployment on ONE stacked engine
              (cuda://llama-3-8b?members=3&member=i, the shipped
              config.yaml's shape): the fanout phase's requests at 300 and
              1200 bytes, one engine, K1 launches = 32 × admission
              dispatches, member texts compared with the fanout phase's;
              then a dedup leg on ?members=3&member_seeds=shared&
              quorum_dedup=1 (at least one dedup admission, exact token
              savings, TTFT with and without dedup on a ≈ 3 000-token
              prompt);
  8. kernels  one line listing both kernels (launches per phase, errors,
              timings, route, share of the bound);

Kernel, plain and library times (``ms``, ``plain_ms``, ``library_ms``) are
device time per call from one CUDA graph that replays the calls over enough
copies of the inputs to exceed the 50 MB L2 (as a layer finds its inputs
cold), so the host's launch cost is excluded. ``eager_ms`` is the kernel's
wrapper timed per call with CUDA events on the same inputs every call (warm
L2, the wrapper's host cost included): the method of the port's first
kernel timings. Then the card's name and power limit, and the result line
``{"ok": true, "device": {"platform": "gpu", ...}}`` last. It imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import asyncio
import gc
import json
import os
import statistics
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

# Peak rates of one H100 SXM (data sheet; dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # bf16 tensor cores; f32 FMA units

# Tolerances of kernel against plain version, per dtype: f32 differs only in
# summation order (online vs two-pass softmax); bf16 differs by where the
# probabilities are rounded (the plain version rounds P to bf16 before P.V,
# the kernel keeps f32 until the output) — a few bf16 ulps of O(1) outputs.
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# Model phase: full-width logits through 2 layers. f32 keeps the kernels'
# f32 error; bf16 adds bf16 rounding of attention outputs feeding two layers
# of bf16 matmuls and a bf16 unembed (logits are O(1); one bf16 ulp at 4 is
# 0.03).
MODEL_TOL = {"float32": 2e-3, "bfloat16": 0.25}
# Per-request deadline in the serve and fanout phases: the run fails, never hangs.
SERVE_TIMEOUT_S = 150


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# ---- timing ------------------------------------------------------------------

def make_timer(torch, cpu: bool):
    def median_ms(fn, iters: int = 25, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        if cpu:
            out = []
            for _ in range(iters):
                t0 = time.perf_counter()
                fn()
                out.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(out)
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)

    return median_ms


def make_graph_timer(torch, cpu: bool, median_ms):
    def graph_ms(calls, rounds: int = 4, reps: int = 5) -> float:
        """Median device ms per call: ``calls`` (one zero-argument callable
        per input copy) are captured ``rounds`` times into one CUDA graph,
        whose replays are timed with CUDA events."""
        if cpu:
            return median_ms(lambda: [c() for c in calls]) / len(calls)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for c in calls:
                c()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(rounds):
                for c in calls:
                    c()
        graph.replay()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            graph.replay()
            e.record()
            torch.cuda.synchronize()
            times.append(s.elapsed_time(e) / (rounds * len(calls)))
        del graph
        return statistics.median(times)

    return graph_ms


def _copies(nbytes: int) -> int:
    """Input copies to rotate through so one round exceeds the 50 MB L2."""
    return max(1, -(-60_000_000 // max(nbytes, 1)))


# ---- phases ------------------------------------------------------------------

def phase_device(torch, cpu: bool) -> dict:
    if cpu:
        info = {"name": "cpu", "power_limit": "n/a", "count": 0}
    else:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown, unknown"
        name, _, limit = line.partition(",")
        info = {"name": torch.cuda.get_device_name(0), "smi": line, "power_limit": limit.strip(),
                "count": torch.cuda.device_count(), "torch": torch.__version__,
                "cuda": torch.version.cuda}
    emit("device", **info)
    return info


def phase_build(cpu: bool) -> None:
    from quorum_tpu_torch.ops import cuda_build

    if cpu:
        emit("build", skipped="cpu rehearsal: no nvcc")
        return
    t0 = time.perf_counter()
    logs = cuda_build.build_all()
    seconds = time.perf_counter() - t0
    ptxas = {}
    for name, log in logs.items():
        entries, kernel = [], None
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                kernel = ln.split("'")[1]
            elif kernel and ("registers" in ln or "spill" in ln):
                entries.append(f"{kernel[-90:]}: {ln.strip()}")
        ptxas[name] = entries
    hgmma = cuda_build.sass_count("flash_prefill", "HGMMA")
    emit("build", seconds=round(seconds, 3), nvcc_flags=cuda_build.NVCC_FLAGS + cuda_build.LINK_FLAGS,
         hgmma_in_flash_prefill=hgmma, ptxas=ptxas)
    require(hgmma > 0, "libflash_prefill.so holds no HGMMA: the bf16 route is not on wgmma")


def _prefill_pairs(np, lengths, s, window):
    """Kept (query, key) pairs over the rows below each length — the rows
    whose output the function defines (rows past it are 0)."""
    rows = np.arange(s)[None, :]
    lens = np.asarray(lengths)[:, None]
    hi = np.where(rows < lens, rows, -1)
    lo = np.maximum(0, rows - window + 1) if window else np.zeros_like(rows)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def _bound(flops: float, nbytes: float, dtype: str = "bfloat16") -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def phase_kernels(torch, cpu: bool, tiny: bool, median_ms, graph_ms) -> dict:
    import numpy as np
    import torch.nn.functional as F

    from quorum_tpu_torch.ops.attention import decode_attention, prefill_attention
    from quorum_tpu_torch.ops.flash_attention import flash_prefill_attention, prefill_route
    from quorum_tpu_torch.ops.flash_decode import (decode_route, flash_decode_attention,
                                                   ticket_counters)

    dev = "cpu" if cpu else "cuda"
    h, kv, hd = (4, 2, 64) if tiny else (32, 8, 128)
    gen = torch.Generator(device="cpu").manual_seed(0)

    def rnd(*shape, dtype):
        return torch.randn(shape, generator=gen).to(device=dev, dtype=dtype)

    def sdpa(q, k, v, mask=None, causal=False):
        """One library call computing the same function (timed only, never
        used by the port)."""
        def call():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, is_causal=causal,
                                                  enable_gqa=True)
        try:
            call()
            return call
        except TypeError:  # older torch: no GQA flag — expand K/V once, outside the timing
            g = q.shape[1] // k.shape[1]
            ke, ve = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
            return lambda: F.scaled_dot_product_attention(q, ke, ve, attn_mask=mask,
                                                          is_causal=causal)

    results = {"flash_prefill": {"max_abs_err": 0.0}, "flash_decode": {"max_abs_err": 0.0}}

    # K1: prefill, B=2 ragged rows for the checks; rows past a length must be 0.
    cases = ([(64, None), (128, None), (100, None)] if tiny else
             [(512, None), (2048, None), (1000, None), (4096, 3017)])
    windows = (0, 32) if tiny else (0, 256)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        route = prefill_route(dtype, hd)
        for s, first_len in cases:
            for w in windows:
                q, k, v = rnd(2, h, s, hd, dtype=dtype), rnd(2, kv, s, hd, dtype=dtype), \
                    rnd(2, kv, s, hd, dtype=dtype)
                lens = [first_len or s, s - s // 3 - 5]
                lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
                by_route = dict(flash_prefill_attention.launches_by_route)
                got = flash_prefill_attention(q, k, v, lengths, window=w)
                ref = prefill_attention(q, k, v, lengths, window=w)
                if not cpu:
                    torch.cuda.synchronize()
                    require(flash_prefill_attention.launches_by_route[route]
                            == by_route[route] + 1, f"K1 {dname} did not take the {route} route")
                err = 0.0
                for b, n in enumerate(lens):
                    diff = (got[b, :, :n].float() - ref[b, :, :n].float()).abs().max().item()
                    err = max(err, diff)
                    if not cpu:
                        require(bool((got[b, :, n:] == 0).all()),
                                f"K1 {dname} S={s} W={w}: a row past length {n} is not 0")
                require(bool(torch.isfinite(got.float()).all()), f"K1 non-finite S={s} W={w}")
                emit("kernels", kernel="flash_prefill", dtype=dname, route=route, S=s, window=w,
                     lengths=lens, max_abs_err=err, tol=KERNEL_TOL[dname])
                require(err <= KERNEL_TOL[dname], f"K1 {dname} S={s} W={w}: err {err}")
                results["flash_prefill"]["max_abs_err"] = max(
                    results["flash_prefill"]["max_abs_err"], err)

    # K1 timing at the admission path's shape: B=1, a full 2048-token bucket, bf16.
    dtype = torch.bfloat16

    def k1_inputs(s, n, copies):
        sets = []
        for _ in range(copies):
            sets.append((rnd(1, h, s, hd, dtype=dtype), rnd(1, kv, s, hd, dtype=dtype),
                         rnd(1, kv, s, hd, dtype=dtype),
                         torch.tensor([n], dtype=torch.int32, device=dev)))
        return sets

    def k1_mask(s, n):
        ar = torch.arange(s, device=dev)
        return ((ar[None, :] <= ar[:, None]) & (ar[None, :] < n))[None, None]

    def k1_cost(s, n):
        """FLOPs and bytes the function needs: q/k/v rows below the length
        read, every output row written (rows past the length as zeros)."""
        flops = 4 * h * _prefill_pairs(np, [n], s, 0) * hd
        nbytes = 2 * (h * n * hd + 2 * kv * n * hd + h * s * hd) + 4
        return flops, nbytes

    s = 128 if tiny else 2048
    k1_bytes = k1_cost(s, s)[1]
    sets = k1_inputs(s, s, _copies(k1_bytes))
    q, k, v, lengths = sets[0]
    flops, nbytes = k1_cost(s, s)
    bound_ms, bound_by = _bound(flops, nbytes)
    ms = graph_ms([lambda a=a: flash_prefill_attention(*a) for a in sets])
    masked_ms = graph_ms([sdpa(a[0], a[1], a[2], k1_mask(s, s)) for a in sets])
    causal_ms = graph_ms([sdpa(a[0], a[1], a[2], causal=True) for a in sets])
    results["flash_prefill"].update(
        shape={"B": 1, "H": h, "K": kv, "S": s, "hd": hd, "dtype": "bfloat16", "window": 0},
        route=prefill_route(dtype, hd), ms=ms,
        eager_ms=median_ms(lambda: flash_prefill_attention(q, k, v, lengths)),
        plain_ms=graph_ms([lambda a=a: prefill_attention(*a) for a in sets]),
        library_ms=min(masked_ms, causal_ms), library_masked_ms=masked_ms,
        library_causal_ms=causal_ms, flops=flops, bytes=nbytes, bound_ms=bound_ms,
        bound_by=bound_by, pct_of_bound=100 * bound_ms / ms)
    del sets
    emit("kernels", kernel="flash_prefill", timing=results["flash_prefill"])

    # K1 at the serve phase's three largest buckets, at their real lengths:
    # the tiles past each length write zeros and do no attention work.
    buckets = [(128, 77)] if tiny else [(512, 317), (2048, 1217), (4096, 3017)]
    rows = []
    for s, n in buckets:
        flops, nbytes = k1_cost(s, n)
        sets = k1_inputs(s, n, _copies(nbytes))
        b_ms, b_by = _bound(flops, nbytes)
        t = graph_ms([lambda a=a: flash_prefill_attention(*a) for a in sets])
        rows.append({"S": s, "length": n, "ms": t, "bound_ms": b_ms, "bound_by": b_by,
                     "pct_of_bound": 100 * b_ms / t,
                     "library_masked_ms": graph_ms(
                         [sdpa(a[0], a[1], a[2], k1_mask(s, n)) for a in sets])})
        del sets
    results["flash_prefill"]["buckets"] = rows
    emit("kernels", kernel="flash_prefill", buckets=rows)

    # K1 at B=3 ragged rows: a member-coalesced admission of a members=3
    # engine (one row per member, each at its own length, one bucket).
    groups = [(128, (77, 128, 40))] if tiny else [(512, (317, 512, 200)),
                                                  (2048, (1217, 2048, 700)),
                                                  (4096, (3017, 4096, 2100))]
    rows = []
    for s, lens in groups:
        flops = 4 * h * _prefill_pairs(np, lens, s, 0) * hd
        nbytes = 2 * (h * sum(lens) * hd + 2 * kv * sum(lens) * hd + 3 * h * s * hd) + 12
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        sets = [(rnd(3, h, s, hd, dtype=dtype), rnd(3, kv, s, hd, dtype=dtype),
                 rnd(3, kv, s, hd, dtype=dtype), lengths) for _ in range(_copies(nbytes))]
        by_route = dict(flash_prefill_attention.launches_by_route)
        got = flash_prefill_attention(*sets[0])
        ref = prefill_attention(*sets[0])
        err = 0.0
        for b, n in enumerate(lens):
            err = max(err, (got[b, :, :n].float() - ref[b, :, :n].float()).abs().max().item())
            if not cpu:
                require(bool((got[b, :, n:] == 0).all()),
                        f"K1 B=3 S={s}: a row past length {n} is not 0")
        if not cpu:
            require(flash_prefill_attention.launches_by_route["wgmma"] == by_route["wgmma"] + 1,
                    "K1 B=3 did not take the wgmma route")
        require(err <= KERNEL_TOL["bfloat16"], f"K1 B=3 S={s}: err {err}")
        results["flash_prefill"]["max_abs_err"] = max(results["flash_prefill"]["max_abs_err"], err)
        b_ms, b_by = _bound(flops, nbytes)
        t = graph_ms([lambda a=a: flash_prefill_attention(*a) for a in sets])
        rows.append({"B": 3, "S": s, "lengths": list(lens), "max_abs_err": err,
                     "tol": KERNEL_TOL["bfloat16"], "ms": t, "bound_ms": b_ms, "bound_by": b_by,
                     "pct_of_bound": 100 * b_ms / t,
                     "library_masked_ms": graph_ms(
                         [sdpa(a[0], a[1], a[2], torch.stack([k1_mask(s, n)[0] for n in lens]))
                          for a in sets])})
        del sets
    results["flash_prefill"]["members_b3"] = rows
    emit("kernels", kernel="flash_prefill", members_b3=rows)

    # K2: decode over the slot cache, 4 slots with skewed lengths.
    t = 256 if tiny else 8192
    lens = [1, 100, 200, 255] if tiny else [1, 100, 4096, 8191]
    dwindows = (0, 64) if tiny else (0, 4096)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        for w in dwindows:
            q = rnd(4, h, 1, hd, dtype=dtype)
            kc, vc = rnd(4, kv, t, hd, dtype=dtype), rnd(4, kv, t, hd, dtype=dtype)
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            got = flash_decode_attention(q, kc, vc, lengths, window=w)
            ref = decode_attention(q, kc, vc, lengths, window=w)
            err = (got.float() - ref.float()).abs().max().item()
            require(bool(torch.isfinite(got.float()).all()), f"K2 non-finite W={w}")
            require(all(int(c.abs().sum()) == 0 for c in ticket_counters()),
                    "K2 ticket counters are not back at 0")
            emit("kernels", kernel="flash_decode", dtype=dname, T=t, window=w, lengths=lens,
                 max_abs_err=err, tol=KERNEL_TOL[dname])
            require(err <= KERNEL_TOL[dname], f"K2 {dname} W={w}: err {err}")
            results["flash_decode"]["max_abs_err"] = max(
                results["flash_decode"]["max_abs_err"], err)
    dtype = torch.bfloat16
    live = sum(lens)
    flops = 4 * h * live * hd
    nbytes = 2 * (live * kv * hd * 2 + 2 * 4 * h * hd) + 4 * 4
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    sets = [(rnd(4, h, 1, hd, dtype=dtype), rnd(4, kv, t, hd, dtype=dtype),
             rnd(4, kv, t, hd, dtype=dtype), lengths) for _ in range(_copies(nbytes))]
    q, kc, vc, _ = sets[0]
    dmask = (torch.arange(t, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
    bound_ms, bound_by = _bound(flops, nbytes)
    ms = graph_ms([lambda a=a: flash_decode_attention(*a) for a in sets])
    results["flash_decode"].update(
        shape={"B": 4, "H": h, "K": kv, "T": t, "hd": hd, "dtype": "bfloat16", "window": 0,
               "lengths": lens},
        route=decode_route(dtype), ms=ms,
        eager_ms=median_ms(lambda: flash_decode_attention(q, kc, vc, lengths)),
        plain_ms=graph_ms([lambda a=a: decode_attention(*a) for a in sets]),
        library_ms=graph_ms([sdpa(a[0], a[1], a[2], dmask) for a in sets]),
        flops=flops, bytes=nbytes, bound_ms=bound_ms, bound_by=bound_by,
        pct_of_bound=100 * bound_ms / ms)
    del sets
    if not cpu:
        require(all(int(c.abs().sum()) == 0 for c in ticket_counters()),
                "K2 ticket counters are not back at 0 after the timed graph replays")
    emit("kernels", kernel="flash_decode", timing=results["flash_decode"])
    return results


def phase_model(torch, cpu: bool, tiny: bool) -> None:
    from quorum_tpu_torch.models.init import init_params
    from quorum_tpu_torch.models.model_config import resolve_spec
    from quorum_tpu_torch.models.transformer import decode_step, init_cache, prefill

    dev = "cpu" if cpu else "cuda"
    n_prompt, bucket, steps = (40, 64, 4) if tiny else (300, 512, 4)
    gen = torch.Generator(device="cpu").manual_seed(1)
    for dtype in ("float32", "bfloat16"):
        spec = resolve_spec("llama-tiny" if tiny else "llama-3-8b",
                            {"n_layers": "2", "dtype": dtype})
        params = init_params(spec, seed=0, device=dev)
        tokens = torch.zeros((1, bucket), dtype=torch.long)
        tokens[0, :n_prompt] = torch.randint(3, spec.vocab_size, (n_prompt,), generator=gen)
        tokens = tokens.to(dev)
        feed = torch.randint(3, spec.vocab_size, (steps,), generator=gen).to(dev)
        lengths1 = torch.tensor([n_prompt], dtype=torch.int32, device=dev)
        errs = []
        outs = {}
        for plain in (False, True):
            ck, cv = init_cache(spec, 2, device=dev)
            logits, _, _ = prefill(params, spec, tokens, lengths1, ck, cv, slot=1,
                                   plain_attention=plain)
            seq = [logits]
            pos = torch.tensor([0, n_prompt], dtype=torch.int32, device=dev)
            for i in range(steps):
                tok = torch.stack([feed[i], feed[i]])
                # Row 0 is an inactive slot: masked write, finished state.
                logits, _, _ = decode_step(params, spec, tok, pos, ck, cv,
                                           write_mask=torch.tensor([False, True], device=dev),
                                           plain_attention=plain)
                seq.append(logits[1:])
                pos = pos + torch.tensor([0, 1], dtype=torch.int32, device=dev)
            outs[plain] = seq
        for a, b in zip(outs[False], outs[True]):
            require(bool(torch.isfinite(a).all()), "model: non-finite logits")
            require(a.shape == (1, spec.vocab_size), f"model: logits shape {tuple(a.shape)}")
            errs.append((a - b).abs().max().item())
        emit("model", dtype=dtype, layers=2, d_model=spec.d_model, prompt=n_prompt,
             decode_steps=steps, max_abs_logit_diff=max(errs), per_step=errs,
             tol=MODEL_TOL[dtype])
        require(max(errs) <= MODEL_TOL[dtype], f"model {dtype}: logits differ by {max(errs)}")
        del params
        _model_stacked(torch, spec, dev, gen, bucket, n_prompt, steps)


def _model_stacked(torch, spec, dev, gen, bucket: int, n_prompt: int, steps: int) -> None:
    """Three stacked weight sets (seeds 0, 1, 2): the stacked prefill (one
    row per member, ragged lengths, K1 at B=3) and decode steps over the
    3 × 2 rows against each member alone through its weight views; the
    ensemble prefill and steps against the mean of the members' logits."""
    from quorum_tpu_torch.models.init import init_params_stacked
    from quorum_tpu_torch.models.transformer import (decode_step, init_cache,
                                                     member_params, prefill)

    n_mem, s = 3, 2
    params = init_params_stacked(spec, [0, 1, 2], device=dev)
    lens = [n_prompt, n_prompt - n_prompt // 3, n_prompt // 2]
    tokens = torch.randint(3, spec.vocab_size, (n_mem, bucket), generator=gen).to(dev)
    feed = torch.randint(3, spec.vocab_size, (steps,), generator=gen).to(dev)
    live = torch.tensor([False, True], device=dev)  # slot 0 idle, slot 1 decoding

    def alone(m, row_tokens, n):
        """Member m's prefill + steps alone (prompt in slot 1 of 2)."""
        p = member_params(params, m)
        ck, cv = init_cache(spec, s, device=dev)
        logits, _, _ = prefill(p, spec, row_tokens[None], torch.tensor([n], dtype=torch.int32,
                                                                      device=dev), ck, cv, slot=1)
        seq, pos = [logits[0]], torch.tensor([0, n], dtype=torch.int32, device=dev)
        for i in range(steps):
            logits, _, _ = decode_step(p, spec, feed[i].repeat(s), pos, ck, cv, write_mask=live)
            seq.append(logits[1])
            pos = pos + live.to(torch.int32)
        return seq

    def stacked(row_tokens, row_lens, ensemble):
        ck, cv = init_cache(spec, n_mem * s, device=dev)
        logits, _, _ = prefill(params, spec, row_tokens, torch.tensor(
            row_lens, dtype=torch.int32, device=dev), ck, cv, rows=[m * s + 1 for m in range(n_mem)])
        rows = 1 if ensemble else n_mem
        seq = [logits.mean(0, keepdim=True) if ensemble else logits]
        pos = torch.tensor([0, row_lens[0]] if ensemble else
                           [x for n in row_lens for x in (0, n)], dtype=torch.int32, device=dev)
        mask = live.repeat(rows)
        for i in range(steps):
            logits, _, _ = decode_step(params, spec, feed[i].repeat(rows * s), pos, ck, cv,
                                       write_mask=mask, ensemble=n_mem if ensemble else 1)
            seq.append(logits[1::2])
            pos = pos + mask.to(torch.int32)
        return seq

    members = [alone(m, tokens[m], lens[m]) for m in range(n_mem)]
    got = stacked(tokens, lens, ensemble=False)
    errs = [max((got[j][m] - members[m][j]).abs().max().item() for m in range(n_mem))
            for j in range(steps + 1)]
    for x in got:
        require(bool(torch.isfinite(x).all()) and x.shape == (n_mem, spec.vocab_size),
                f"model members: logits {tuple(x.shape)} or non-finite")
    shared = [members[0]] + [alone(m, tokens[0], lens[0]) for m in range(1, n_mem)]
    ens = stacked(tokens[:1].repeat(n_mem, 1), [lens[0]] * n_mem, ensemble=True)
    ens_errs = [(ens[j][0] - sum(shared[m][j] for m in range(n_mem)) / n_mem).abs().max().item()
                for j in range(steps + 1)]
    tol = MODEL_TOL[spec.dtype]
    emit("model", dtype=spec.dtype, layers=2, members=n_mem, prompts=lens,
         decode_steps=steps, max_abs_logit_diff_members=max(errs), per_step_members=errs,
         max_abs_logit_diff_ensemble=max(ens_errs), per_step_ensemble=ens_errs, tol=tol)
    require(max(errs) <= tol, f"model members {spec.dtype}: logits differ by {max(errs)}")
    require(max(ens_errs) <= tol, f"model ensemble {spec.dtype}: logits differ by {max(ens_errs)}")


def _prompt(n_bytes: int, seed: int) -> str:
    import random

    words = ("the quorum of models answers every request with care while kernels on the "
             "card stream keys and values through shared memory tiles").split()
    rng = random.Random(seed)
    out = []
    while len(" ".join(out)) < n_bytes:
        out.append(rng.choice(words))
    return " ".join(out)[:n_bytes]


async def _call(app, body: dict) -> dict:
    """Drive the ASGI app directly (no HTTP client needed) and time the
    response's body messages."""
    raw = json.dumps(body).encode()
    sent = []
    t0 = time.perf_counter()
    done = False

    async def receive():
        nonlocal done
        if done:
            await asyncio.sleep(3600)
        done = True
        return {"type": "http.request", "body": raw, "more_body": False}

    async def send(message):
        sent.append((time.perf_counter() - t0, message))

    scope = {"type": "http", "method": "POST", "path": "/v1/chat/completions",
             "headers": [(b"authorization", b"Bearer smoke"),
                         (b"content-type", b"application/json")]}
    await app(scope, receive, send)
    status = sent[0][1]["status"]
    headers = {k.decode().lower(): v.decode() for k, v in sent[0][1]["headers"]}
    bodies = [(t, m.get("body", b"")) for t, m in sent[1:] if m.get("body")]
    return {"status": status, "headers": headers, "bodies": bodies,
            "data": b"".join(b for _, b in bodies), "t_end": time.perf_counter() - t0}


def _check_response(resp: dict, body: dict, tokenizer, max_tokens: int) -> dict:
    from quorum_tpu_torch import sse

    require(resp["status"] == 200, f"status {resp['status']}: {resp['data'][:300]!r}")
    n_prompt = len(tokenizer.encode(tokenizer.render_chat(body["messages"])))
    if not body.get("stream"):
        js = json.loads(resp["data"])
        usage = js["usage"]
        text = js["choices"][0]["message"]["content"]
        finish = js["choices"][0]["finish_reason"]
        out = {"text": text, "usage": usage, "finish": finish, "t_end": resp["t_end"]}
    else:
        events = list(sse.iter_data_events(resp["data"]))
        require(len(events) >= 3 and events[-1] == sse.DONE, "SSE must end with [DONE]")
        require(all(isinstance(e, dict) for e in events[:-1]), "SSE frames must be JSON")
        usage = next((e["usage"] for e in events[:-1] if e.get("usage")), None)
        require(usage is not None, "streamed usage chunk missing")
        text = "".join((e["choices"][0]["delta"].get("content") or "")
                       for e in events[:-1] if e.get("choices"))
        finish = next((e["choices"][0]["finish_reason"] for e in events[:-1]
                       if e.get("choices") and e["choices"][0].get("finish_reason")), None)
        require(finish in ("stop", "length"), f"finish_reason {finish!r}")
        content_t = [t for t, b in resp["bodies"] if b'"content":"' in b]
        out = {"text": text, "usage": usage, "finish": finish, "t_end": resp["t_end"],
               "ttft_s": content_t[0] if content_t else None,
               "t_last_s": content_t[-1] if content_t else None}
    require(usage["prompt_tokens"] == n_prompt,
            f"prompt_tokens {usage['prompt_tokens']} != {n_prompt}")
    require(1 <= usage["completion_tokens"] <= max_tokens, f"completion_tokens {usage}")
    require(usage["total_tokens"] == usage["prompt_tokens"] + usage["completion_tokens"],
            f"total_tokens {usage}")
    if finish == "length":
        require(usage["completion_tokens"] == max_tokens, f"length finish with {usage}")
    return out


def phase_serve(torch, cpu: bool, tiny: bool, device_info: dict, profile: bool) -> dict:
    from quorum_tpu_torch.config import Config
    from quorum_tpu_torch.engine.engine import shutdown_all_engines
    from quorum_tpu_torch.ops.flash_attention import flash_prefill_attention
    from quorum_tpu_torch.ops.flash_decode import flash_decode_attention
    from quorum_tpu_torch.server.app import create_app

    model = "llama-tiny" if tiny else "llama-3-8b"
    url = f"cuda://{model}?slots=4&decode_chunk=8" + ("&device=cpu" if cpu else "")
    cfg = Config(raw={"primary_backends": [{"name": "llama", "url": url}],
                      "settings": {"timeout": SERVE_TIMEOUT_S}})
    t0 = time.perf_counter()
    app = create_app(cfg)
    backend = app.state["registry"].backends[0]
    engine = backend.engine
    if not cpu:
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_layers = engine.spec.n_layers
    max_tokens = 16 if tiny else 32
    sizes = (12, 30, 50, 80) if tiny else (40, 300, 1200, 3000)

    def body(i, stream, sampled):
        b = {"model": model, "messages": [{"role": "user", "content": _prompt(sizes[i], i)}],
             "max_tokens": max_tokens, "stream": stream}
        b.update({"temperature": 0.8, "top_p": 0.9, "top_k": 50, "seed": i}
                 if sampled else {"temperature": 0})
        if stream:
            b["stream_options"] = {"include_usage": True}
        return b

    bodies = [body(0, False, False), body(1, True, False), body(2, False, True),
              body(3, True, True)]
    # Every launch counter to 0 just before the main path, read just after.
    flash_prefill_attention.launches = 0
    flash_prefill_attention.launches_by_route.update(wgmma=0, fma=0)
    flash_decode_attention.launches = 0
    m0 = engine.metrics()

    async def drive():
        t_start = time.perf_counter()
        first = await asyncio.gather(*[_call(app, b) for b in bodies])
        wall = time.perf_counter() - t_start
        again = await _call(app, {**bodies[0], "stream": True,
                                  "stream_options": {"include_usage": True}})
        return first, wall, again

    first, wall, again = asyncio.run(asyncio.wait_for(drive(), 2 * SERVE_TIMEOUT_S))
    m1 = engine.metrics()
    launches = {"flash_prefill": flash_prefill_attention.launches,
                "flash_decode": flash_decode_attention.launches}
    k1_routes = dict(flash_prefill_attention.launches_by_route)
    tok = backend.tokenizer
    checked = [_check_response(r, b, tok, max_tokens) for r, b in zip(first, bodies)]
    repeat = _check_response(again, {**bodies[0], "stream": True}, tok, max_tokens)
    require(repeat["text"] == checked[0]["text"],
            "greedy request: streamed text differs from the non-streamed text")
    admissions = m1["admissions_total"] - m0["admissions_total"]
    steps = m1["decode_steps_total"] - m0["decode_steps_total"]
    require(admissions == 5, f"expected 5 admissions, engine counted {admissions}")
    if not cpu:
        require(launches["flash_prefill"] == n_layers * admissions,
                f"K1 launches {launches['flash_prefill']} != {n_layers} x {admissions}")
        require(k1_routes["wgmma"] == n_layers * admissions,
                f"K1 launches on the wgmma route {k1_routes} != {n_layers} x {admissions}")
        require(launches["flash_decode"] == n_layers * steps,
                f"K2 launches {launches['flash_decode']} != {n_layers} x {steps}")
        require(launches["flash_prefill"] > 0 and launches["flash_decode"] > 0,
                "a kernel of the path was never launched")
    completion = sum(c["usage"]["completion_tokens"] for c in checked)
    streams = [c for c in checked + [repeat] if c.get("ttft_s") is not None]
    rates = [(c["usage"]["completion_tokens"] - 1) / (c["t_last_s"] - c["ttft_s"])
             for c in streams if c["t_last_s"] > c["ttft_s"]]
    card = f"{device_info['name']} ({device_info['power_limit']})"
    info = {
        "model": model, "layers": n_layers, "slots": engine.n_slots,
        "max_seq": engine.spec.max_seq, "dtype": engine.spec.dtype,
        "app_build_s": round(build_s, 3),
        "requests": [{"stream": b["stream"], "sampled": "seed" in b,
                      "prompt_tokens": c["usage"]["prompt_tokens"],
                      "completion_tokens": c["usage"]["completion_tokens"],
                      "finish": c["finish"], "seconds": round(c["t_end"], 4),
                      "ttft_s": c.get("ttft_s")} for b, c in zip(bodies, checked)],
        "greedy_stream_matches_complete": True,
        "admissions": admissions, "decode_steps": steps, "launches": launches,
        "k1_launches_by_route": k1_routes,
        "concurrent_wall_s": round(wall, 4),
        "concurrent_completion_tokens": completion,
        "ttft_s_first_reading": [c["ttft_s"] for c in streams],
        "decode_tok_per_s_per_stream_first_reading": rates,
        "measured_on": card,
        "peak_mem_gb": (None if cpu else round(torch.cuda.max_memory_allocated() / 1e9, 3)),
    }
    emit("serve", **info)
    if profile:
        async def one_round():
            return await asyncio.gather(*[_call(app, b) for b in bodies])

        phase_profile(torch, cpu, lambda: asyncio.run(
            asyncio.wait_for(one_round(), 2 * SERVE_TIMEOUT_S)), card, flash_decode_attention)
    shutdown_all_engines()
    return info


FANOUT_SEPARATOR = "\n-------------\n"


def _parallel_stream(resp: dict) -> dict:
    """A parallel SSE response: each member's joined deltas, the final
    text, and when (seconds from the request) the first member delta, each
    member's first and last delta, and the first final delta arrived."""
    from quorum_tpu_torch import sse

    require(resp["status"] == 200, f"status {resp['status']}: {resp['data'][:300]!r}")
    members: dict[int, str] = {}
    spans: dict[int, list[float]] = {}
    final, finish, t_member, t_final, done = "", None, None, None, False
    for t, body in resp["bodies"]:
        for e in sse.iter_data_events(body):
            if e == sse.DONE:
                done = True
                continue
            require(isinstance(e, dict) and e.get("model") == "parallel-proxy",
                    f"parallel stream frame {e!r}")
            ch = e["choices"][0]
            text = ch["delta"].get("content") or ""
            finish = ch.get("finish_reason") or finish
            if e["id"] == "chatcmpl-parallel-final":
                final += text
                t_final = t_final if t_final is not None or not text else t
            elif e["id"].startswith("chatcmpl-parallel-") and text:
                i = int(e["id"].rsplit("-", 1)[1])
                members[i] = members.get(i, "") + text
                spans[i] = [spans.get(i, [t])[0], t]
                t_member = t if t_member is None else t_member
            else:
                require(e["id"] == "chatcmpl-parallel" and not text, f"stray frame {e!r}")
    require(done and finish == "stop", f"stream ended with finish {finish!r}, [DONE] {done}")
    return {"members": members, "final": final, "ttft_member_s": t_member,
            "member_spans": spans, "ttft_final_s": t_final, "t_end": resp["t_end"]}


def _parallel_complete(resp: dict) -> dict:
    require(resp["status"] == 200, f"status {resp['status']}: {resp['data'][:300]!r}")
    js = json.loads(resp["data"])
    return {"text": js["choices"][0]["message"]["content"],
            "degraded": resp["headers"].get("x-quorum-aggregate-degraded"),
            "t_end": resp["t_end"]}


def _require_card_empty(torch, cpu: bool, what: str) -> None:
    """Before a phase builds its engines, the previous phase's must be gone
    (a stacked engine's leaves are 3× larger blocks than freed
    single-engine ones, so fragments would not do)."""
    gc.collect()
    if not cpu:
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        require(held < 1e9, f"{what}: {held / 1e9:.3f} GB still allocated before the build")


def _fanout_urls(model: str, extra: str, stacked: bool, knobs: str = "") -> list[str]:
    if stacked:
        return [f"cuda://{model}?members=3&member={i}{knobs}&slots=4&decode_chunk=8{extra}"
                for i in range(3)]
    return [f"cuda://{model}?seed={i}&slots=4&decode_chunk=8{extra}" for i in range(3)]


def phase_fanout(torch, cpu: bool, tiny: bool, device_info: dict, stacked: bool = False,
                 reference: dict | None = None) -> dict:
    """Three members behind one app; the aggregate strategy's aggregator is
    LLM1. ``fanout``: three engines, seeds 0, 1, 2 (engines are keyed by
    weight identity, so the three apps share them). ``members``
    (``stacked``): the same three weight sets on ONE engine,
    ``?members=3&member=i``; its member texts are compared with the fanout
    phase's (``reference``)."""
    from quorum_tpu_torch.config import Config
    from quorum_tpu_torch.engine.engine import shutdown_all_engines
    from quorum_tpu_torch.ops.flash_attention import flash_prefill_attention
    from quorum_tpu_torch.ops.flash_decode import flash_decode_attention, ticket_counters
    from quorum_tpu_torch.server.app import create_app

    phase = "members" if stacked else "fanout"
    model = "llama-tiny" if tiny else "llama-3-8b"
    # llama-tiny's 128-token window would cut the aggregation prompt.
    extra = "&max_seq=2048&device=cpu" if tiny else ""
    names = ("LLM1", "LLM2", "LLM3")
    urls = _fanout_urls(model, extra, stacked)

    def raw(strategy: str, stream_aggregate: bool = False) -> dict:
        return {"settings": {"timeout": SERVE_TIMEOUT_S},
                "primary_backends": [{"name": n, "url": u} for n, u in zip(names, urls)],
                "iterations": {"aggregation": {"strategy": strategy}},
                "strategy": {"concatenate": {"separator": FANOUT_SEPARATOR},
                             "aggregate": {"aggregator_backend": "LLM1",
                                           "stream_aggregate": stream_aggregate}}}

    _require_card_empty(torch, cpu, phase)
    if not cpu:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    concat_app = create_app(Config(raw=raw("concatenate")))
    reg = concat_app.state["registry"]
    agg_app = create_app(Config(raw=raw("aggregate")), registry=reg)
    live_app = create_app(Config(raw=raw("aggregate", stream_aggregate=True)), registry=reg)
    engines = list({id(b.engine): b.engine for b in reg.backends}.values())
    require(len(engines) == (1 if stacked else 3),
            f"{phase}: the three members must be {'one engine' if stacked else 'three engines'},"
            f" got {len(engines)}")
    if stacked:
        require([b.member for b in reg.backends] == [0, 1, 2], "members: member indices")

    def member_tokens() -> list[int]:
        if stacked:
            return engines[0].metrics()["member_tokens_total"]
        return [e.metrics()["tokens_total"] for e in engines]

    if not cpu:
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_layers = engines[0].spec.n_layers
    max_tokens = 16 if tiny else 32
    burst_sizes = (30, 80) if tiny else (300, 1200)
    # Three engines in one process are host-bound (PERF.md §5): the fanout
    # phase runs its one-at-a-time requests on the smaller prompt only, to
    # keep the script inside its time budget; the members phase runs both.
    sizes = burst_sizes if stacked else burst_sizes[:1]
    agg_sep = "\n\n---\n\n"  # the aggregate strategy's default intermediate_separator

    def body(n_bytes: int, seed: int, stream: bool = False) -> dict:
        return {"model": model, "max_tokens": max_tokens, "temperature": 0, "stream": stream,
                "messages": [{"role": "user", "content": _prompt(n_bytes, seed)}]}

    # Every launch counter to 0 just before the main path, read just after.
    flash_prefill_attention.launches = 0
    flash_prefill_attention.launches_by_route.update(wgmma=0, fma=0)
    flash_decode_attention.launches = 0
    m0 = [e.metrics() for e in engines]

    texts_by_size: dict[int, list[str]] = {}

    async def sequential(n_bytes: int, seed: int) -> dict:
        out: dict = {"prompt_bytes": n_bytes}
        tok0 = member_tokens()
        concat = _parallel_complete(await _call(concat_app, body(n_bytes, seed)))
        texts = concat["text"].split(FANOUT_SEPARATOR)
        require(len(texts) == 3 and all(texts), f"concatenate: {len(texts)} member texts")
        require(len(set(texts)) == 3, "concatenate: two members wrote the same text")
        texts_by_size[n_bytes] = texts
        tok1 = member_tokens()
        streamed = _parallel_stream(await _call(concat_app, body(n_bytes, seed, True)))
        tok2 = member_tokens()
        require([streamed["members"].get(i) for i in range(3)] == texts,
                "concatenate: streamed member texts differ from the non-streamed ones")
        require(streamed["final"] == concat["text"],
                "concatenate: the streamed final chunk differs from the non-streamed content")
        agg = _parallel_complete(await _call(agg_app, body(n_bytes, seed)))
        require(agg["degraded"] is None, f"aggregate degraded: {agg['degraded']}")
        require(agg["text"] and agg["text"] != agg_sep.join(t.strip() for t in texts),
                "aggregate: empty, or the separator-join of the members")
        agg_stream = _parallel_stream(await _call(agg_app, body(n_bytes, seed, True)))
        agg_live = _parallel_stream(await _call(live_app, body(n_bytes, seed, True)))
        # The streamed paths quote the members' texts as streamed, the
        # buffered one after strip(): the prompts agree when no member text
        # has surrounding whitespace (JAX package semantics, kept).
        same_prompt = all(t == t.strip() for t in texts)
        if same_prompt:
            require(agg_stream["final"] == agg["text"],
                    "aggregate: the streamed final text differs from the non-streamed one")
            # The live relay filters the aggregator's tokens without the
            # buffered path's strip().
            require(agg_live["final"].strip() == agg["text"],
                    "aggregate (stream_aggregate): text differs from the non-streamed one")
        out.update(
            member_completion_tokens=[b - a for a, b in zip(tok0, tok1)],
            member_texts=[repr(t)[:80] for t in texts],
            concat_s=concat["t_end"], concat_stream_s=streamed["t_end"],
            concat_stream_ttft_member_s=streamed["ttft_member_s"],
            # Each member's decode rate while all three stream at once:
            # tokens after its first delta over its first-to-last span.
            member_stream_tok_per_s=[
                (b - a - 1) / (sp[1] - sp[0]) if sp[1] > sp[0] else None
                for a, b, sp in zip(tok1, tok2, (streamed["member_spans"][i]
                                                 for i in range(3)))],
            aggregate_s=agg["t_end"], aggregate_text=repr(agg["text"])[:80],
            aggregate_stream_s=agg_stream["t_end"],
            aggregate_stream_ttft_final_s=agg_stream["ttft_final_s"],
            aggregate_live_s=agg_live["t_end"],
            aggregate_live_ttft_final_s=agg_live["ttft_final_s"],
            streamed_aggregate_checked=same_prompt,
            aggregate_live_exact=agg_live["final"] == agg["text"])
        return out

    async def burst() -> dict:
        reqs = [(concat_app, body(burst_sizes[0], 10)),
                (concat_app, body(burst_sizes[1], 11, True)),
                (agg_app, body(burst_sizes[1], 12)), (agg_app, body(burst_sizes[0], 13, True))]
        t_start = time.perf_counter()
        resps = await asyncio.gather(*[_call(app, b) for app, b in reqs])
        wall = time.perf_counter() - t_start
        concat, concat_s = _parallel_complete(resps[0]), _parallel_stream(resps[1])
        agg, agg_s = _parallel_complete(resps[2]), _parallel_stream(resps[3])
        require(len(concat["text"].split(FANOUT_SEPARATOR)) == 3 and len(concat_s["members"]) == 3,
                "burst: a concatenate lost a member")
        require(agg["degraded"] is None and agg["text"] and agg_s["final"],
                f"burst: aggregate degraded ({agg['degraded']}) or empty")
        return {"wall_s": wall, "ttft_first_member_delta_s": concat_s["ttft_member_s"],
                "ttft_aggregate_final_s": agg_s["ttft_final_s"],
                "request_s": [r["t_end"] for r in resps]}

    async def drive():
        runs = [await sequential(n, i) for i, n in enumerate(sizes)]
        return runs, await burst()

    runs, burst_info = asyncio.run(asyncio.wait_for(drive(), 8 * SERVE_TIMEOUT_S))
    if not cpu:
        torch.cuda.synchronize()
    m1 = [e.metrics() for e in engines]
    launches = {"flash_prefill": flash_prefill_attention.launches,
                "flash_decode": flash_decode_attention.launches}
    k1_routes = dict(flash_prefill_attention.launches_by_route)
    admissions = [b["admissions_total"] - a["admissions_total"] for a, b in zip(m0, m1)]
    dispatches = [b["admission_dispatches_total"] - a["admission_dispatches_total"]
                  for a, b in zip(m0, m1)]
    steps = [b["decode_steps_total"] - a["decode_steps_total"] for a, b in zip(m0, m1)]
    tickets_zero = all(int(c.abs().sum()) == 0 for c in ticket_counters())
    # Members: 3 per request (5 sequential per size, 4 in the burst); the
    # aggregator admits one more per aggregate request (3 per size, 2 in
    # the burst). The stacked engine admits them all.
    want_admissions = [len(sizes) * 8 + 6, len(sizes) * 5 + 4, len(sizes) * 5 + 4]
    if stacked:
        want_admissions = [sum(want_admissions)]
    require(admissions == want_admissions,
            f"admissions per engine {admissions}, expected {want_admissions}")
    require(tickets_zero, f"K2 ticket counters are not back at 0 after the {phase} phase")
    if not cpu:
        require(launches["flash_prefill"] == n_layers * sum(dispatches),
                f"K1 launches {launches['flash_prefill']} != {n_layers} x {sum(dispatches)} "
                "admission dispatches")
        require(k1_routes["wgmma"] == n_layers * sum(dispatches),
                f"K1 launches on the wgmma route {k1_routes} != {n_layers} x {sum(dispatches)}")
        require(launches["flash_decode"] == n_layers * sum(steps),
                f"K2 launches {launches['flash_decode']} != {n_layers} x {sum(steps)}")
        require(launches["flash_prefill"] > 0 and launches["flash_decode"] > 0,
                f"{phase}: a kernel of the path was never launched")
    total_mem = None if cpu else torch.cuda.get_device_properties(0).total_memory
    peak = None if cpu else torch.cuda.max_memory_allocated()
    if not cpu:
        require(peak < total_mem, f"peak memory {peak} is not below the card's {total_mem}")
    info = {"model": model, "layers": n_layers, "members": 3, "seeds": [0, 1, 2],
            "urls": urls, "engines": len(engines),
            "dtype": engines[0].spec.dtype, "slots_per_member": engines[0].n_slots,
            "app_build_s": round(build_s, 3), "max_tokens": max_tokens,
            "sequential": runs, "burst": burst_info,
            "admissions_per_engine": admissions, "admission_dispatches_per_engine": dispatches,
            "requests_per_admission_dispatch": sum(admissions) / max(1, sum(dispatches)),
            "decode_steps_per_engine": steps,
            "launches": launches, "k1_launches_by_route": k1_routes,
            "ticket_counters_zero": tickets_zero,
            "peak_mem_gb": None if cpu else round(peak / 1e9, 3),
            "card_mem_gb": None if cpu else round(total_mem / 1e9, 3),
            "measured_on": f"{device_info['name']} ({device_info['power_limit']})"}
    if reference is not None:
        ref = reference["texts_by_size"]
        info["member_texts_equal_to_fanout"] = {
            n: [a == b for a, b in zip(texts_by_size[n], ref[n])] for n in sizes if n in ref}
    emit(phase, **info)
    info["texts_by_size"] = texts_by_size
    shutdown_all_engines()
    return info


def phase_dedup(torch, cpu: bool, tiny: bool, device_info: dict) -> dict:
    """The dedup leg of the members phase: ``?members=3&member_seeds=shared
    &quorum_dedup=1`` (one weight set, three sampling streams). One streamed
    concatenate through the app, then fan-outs of a ≈ 3 000-token prompt
    straight to the engine: identical prompts (the dedup route: one
    prefill, K/V copied to the three rows) against prompts differing in
    their last token (one coalesced B=3 prefill), alternating. Requires at
    least one dedup admission and the exact token savings; reports the time
    to every member's first token both ways."""
    from quorum_tpu_torch.config import Config
    from quorum_tpu_torch.engine.engine import shutdown_all_engines
    from quorum_tpu_torch.ops.flash_attention import flash_prefill_attention
    from quorum_tpu_torch.ops.flash_decode import flash_decode_attention, ticket_counters
    from quorum_tpu_torch.ops.sampling import SamplerConfig
    from quorum_tpu_torch.server.app import create_app

    model = "llama-tiny" if tiny else "llama-3-8b"
    extra = "&max_seq=2048&device=cpu" if tiny else ""
    urls = _fanout_urls(model, extra, True, "&member_seeds=shared&quorum_dedup=1")
    _require_card_empty(torch, cpu, "members_dedup")
    if not cpu:
        torch.cuda.reset_peak_memory_stats()
    app = create_app(Config(raw={
        "settings": {"timeout": SERVE_TIMEOUT_S},
        "primary_backends": [{"name": f"LLM{i + 1}", "url": u} for i, u in enumerate(urls)],
        "iterations": {"aggregation": {"strategy": "concatenate"}},
        "strategy": {"concatenate": {"separator": FANOUT_SEPARATOR}}}))
    backends = app.state["registry"].backends
    engine = backends[0].engine
    require(all(b.engine is engine for b in backends) and engine.quorum_dedup,
            "members_dedup: the three members must be one dedup engine")
    tok, n_layers = backends[0].tokenizer, engine.spec.n_layers
    n_bytes = 80 if tiny else 3000
    greedy = SamplerConfig(temperature=0.0)
    prompt = tok.encode(tok.render_chat([{"role": "user", "content": _prompt(n_bytes, 40)}]))
    variants = {"dedup": [prompt] * 3,
                "stacked": [prompt[:-1] + [3 + m] for m in range(3)]}

    def fan(prompts) -> tuple[list[float], list[list[int]]]:
        """Submit one request per member back to back; seconds to each
        member's first token, and the streams."""
        t0 = time.perf_counter()
        reqs = [engine.submit(list(p), max_new_tokens=4, sampler=greedy, member=m)
                for m, p in enumerate(prompts)]
        its = [engine.stream_results(r) for r in reqs]
        firsts = [next(it) for it in its]
        ttft = time.perf_counter() - t0
        outs = [[f] + list(it) for f, it in zip(firsts, its)]
        return ttft, outs

    # Every launch counter to 0 just before the main path, read just after.
    flash_prefill_attention.launches = 0
    flash_prefill_attention.launches_by_route.update(wgmma=0, fma=0)
    flash_decode_attention.launches = 0
    m0 = engine.metrics()
    body = {"model": model, "max_tokens": 8, "temperature": 0, "stream": True,
            "messages": [{"role": "user", "content": _prompt(n_bytes, 41)}]}
    concat = _parallel_stream(asyncio.run(asyncio.wait_for(_call(app, body), SERVE_TIMEOUT_S)))
    require(len(concat["members"]) == 3, "members_dedup: a member of the concatenate is missing")
    readings: dict[str, list[float]] = {"dedup": [], "stacked": []}
    checked = []
    for rep in range(3):
        for name in (("dedup", "stacked") if rep % 2 == 0 else ("stacked", "dedup")):
            a = engine.metrics()
            ttft, outs = fan(variants[name])
            b = engine.metrics()
            n_dedup = b["quorum_dedup_prefills_total"] - a["quorum_dedup_prefills_total"]
            saved = b["quorum_dedup_tokens_total"] - a["quorum_dedup_tokens_total"]
            require(saved == n_dedup * 2 * len(prompt),
                    f"members_dedup: {saved} tokens saved by {n_dedup} dedup admissions")
            coalesced = b["admission_dispatches_total"] - a["admission_dispatches_total"] == 1
            if (name == "dedup" and n_dedup == 1) or (name == "stacked" and coalesced):
                readings[name].append(ttft)
            if name == "dedup":
                checked.append(outs[0] == outs[1] == outs[2])
    if not cpu:
        torch.cuda.synchronize()
    m1 = engine.metrics()
    launches = {"flash_prefill": flash_prefill_attention.launches,
                "flash_decode": flash_decode_attention.launches}
    dispatches = m1["admission_dispatches_total"] - m0["admission_dispatches_total"]
    steps = m1["decode_steps_total"] - m0["decode_steps_total"]
    prefills = m1["quorum_dedup_prefills_total"] - m0["quorum_dedup_prefills_total"]
    saved = m1["quorum_dedup_tokens_total"] - m0["quorum_dedup_tokens_total"]
    require(prefills >= 1, "members_dedup: no dedup admission was counted")
    require(all(int(c.abs().sum()) == 0 for c in ticket_counters()),
            "K2 ticket counters are not back at 0 after the dedup leg")
    if not cpu:
        require(launches["flash_prefill"] == n_layers * dispatches
                and flash_prefill_attention.launches_by_route["wgmma"] == n_layers * dispatches,
                f"K1 launches {launches['flash_prefill']} != {n_layers} x {dispatches} dispatches")
        require(launches["flash_decode"] == n_layers * steps,
                f"K2 launches {launches['flash_decode']} != {n_layers} x {steps}")
        require(launches["flash_prefill"] > 0 and launches["flash_decode"] > 0,
                "members_dedup: a kernel of the path was never launched")
    total_mem = None if cpu else torch.cuda.get_device_properties(0).total_memory
    peak = None if cpu else torch.cuda.max_memory_allocated()
    if not cpu:
        require(peak < total_mem, f"peak memory {peak} is not below the card's {total_mem}")
    info = {"model": model, "urls": urls, "prompt_tokens": len(prompt),
            "app_concat_stream_s": concat["t_end"],
            "app_concat_ttft_member_s": concat["ttft_member_s"],
            "dedup_prefills": prefills, "dedup_tokens_saved": saved,
            "admission_dispatches": dispatches, "decode_steps": steps,
            "ttft_all_members_s": readings,
            "dedup_members_equal": checked, "launches": launches,
            "peak_mem_gb": None if cpu else round(peak / 1e9, 3),
            "measured_on": f"{device_info['name']} ({device_info['power_limit']})"}
    emit("members_dedup", **info)
    shutdown_all_engines()
    return info


# Kernel-name fragments → where the serve time goes.
_KERNEL_GROUPS = (("K1 flash_prefill", ("prefill_wgmma_kernel", "flash_prefill_kernel")),
                  ("K2 flash_decode", ("flash_decode_mma_kernel", "flash_decode_kernel")),
                  ("matmul", ("gemm", "gemv", "cutlass", "xmma", "nvjet", "cublas", "splitk")),
                  ("sort (top-p/top-k)", ("sort", "radix", "scan")))


def phase_profile(torch, cpu: bool, run_requests, card: str, decode_fn) -> None:
    """The same 4 concurrent requests again under torch.profiler: device time
    by kernel group and the device's busy share of the wall time. K2 must
    show one kernel name, launched once per call."""
    if cpu:
        run_requests()  # rehearse the path; there is no device to trace
        emit("profile", skipped="cpu rehearsal: no device trace")
        return
    from torch.profiler import ProfilerActivity, profile

    decode_fn.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_requests()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups: dict[str, float] = {}
    kernels = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us <= 0:
            continue
        name = ev.key
        group = next((g for g, frags in _KERNEL_GROUPS
                      if any(f in name.lower() for f in frags)), "other")
        groups[group] = groups.get(group, 0.0) + dev_us / 1e3
        kernels.append((dev_us / 1e3, ev.count, name[:80]))
    busy_ms = sum(groups.values())
    k2 = [(n, name) for _, n, name in kernels if "flash_decode" in name]
    require(len(k2) == 1 and k2[0][0] == decode_fn.launches,
            f"K2 in the profile: {k2}, {decode_fn.launches} calls; want one kernel per call")
    kernels.sort(reverse=True)
    emit("profile", wall_ms=wall * 1e3, device_busy_ms=busy_ms,
         device_busy_share=busy_ms / (wall * 1e3) if wall > 0 else None,
         device_ms_by_group={g: round(v, 3) for g, v in sorted(groups.items())},
         k2_kernels=[{"count": n, "name": name} for n, name in k2],
         top_kernels=[{"ms": round(ms, 3), "count": n, "name": name}
                      for ms, n, name in kernels[:12]],
         measured_on=card)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="rehearsal on the CPU with the plain versions (never the default)")
    ap.add_argument("--tiny", action="store_true", help="llama-tiny shapes (rehearsal)")
    ap.add_argument("--phases", default="device,build,kernels,model,serve,fanout,members",
                    help="comma-separated subset of phases to run; add 'profile' to trace "
                         "a second round of the serve requests with torch.profiler")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))

    import torch

    if not args.cpu and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        import quorum_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable from {ROOT}: {e}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    median_ms = make_timer(torch, args.cpu)
    graph_ms = make_graph_timer(torch, args.cpu, median_ms)
    try:
        info = phase_device(torch, args.cpu)
        if "build" in phases:
            phase_build(args.cpu)
        kernels = phase_kernels(torch, args.cpu, args.tiny, median_ms, graph_ms) \
            if "kernels" in phases else None
        if "model" in phases:
            phase_model(torch, args.cpu, args.tiny)
        serve = (phase_serve(torch, args.cpu, args.tiny, info, "profile" in phases)
                 if "serve" in phases else None)
        fanout = phase_fanout(torch, args.cpu, args.tiny, info) if "fanout" in phases else None
        members = dedup = None
        if "members" in phases:
            members = phase_fanout(torch, args.cpu, args.tiny, info, stacked=True,
                                   reference=fanout)
            dedup = phase_dedup(torch, args.cpu, args.tiny, info)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    if kernels is not None:
        by_phase = {name: ph["launches"] for name, ph in (
            ("serve", serve), ("fanout", fanout), ("members", members),
            ("members_dedup", dedup)) if ph is not None}
        rows = []
        for name, src, replaces in (
                ("flash_prefill", "quorum_tpu_torch/csrc/flash_prefill.cu",
                 "quorum_tpu/ops/flash_attention.py:52"),
                ("flash_decode", "quorum_tpu_torch/csrc/flash_decode.cu",
                 "quorum_tpu/ops/flash_decode.py:53")):
            r = kernels[name]
            row = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                   "launches": sum(ph[name] for ph in by_phase.values()),
                   "launches_by_phase": {ph: n[name] for ph, n in by_phase.items()},
                   "max_abs_err": r["max_abs_err"],
                   "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                   "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                   "kernel_route": r["route"], "pct_of_bound": r["pct_of_bound"],
                   "eager_ms": r["eager_ms"], "ok": True}
            if name == "flash_prefill":
                row.update(library_masked_ms=r["library_masked_ms"],
                           library_causal_ms=r["library_causal_ms"])
            rows.append(row)
        print(json.dumps({"kernels": rows}), flush=True)
    if args.cpu:
        print("cpu rehearsal: no card", flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "cpu", "kind": "cpu",
                                                 "count": 0}}), flush=True)
        return 0
    print(info["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
