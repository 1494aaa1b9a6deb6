#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (quorum_tpu_torch) on one GPU.

    python3 chip_smoke.py                  # the full check on the card
    python3 chip_smoke.py --cpu --tiny     # rehearsal: plain versions, llama-tiny, no GPU

Phases, each printing one JSON line; any failure exits nonzero before the
result line:

  1. device   the card's name and power limit (nvidia-smi);
  2. build    nvcc builds the three kernels from csrc/ in parallel; ptxas's
              registers / shared memory / spills per kernel, and the count of
              HGMMA (wgmma) instructions in K1's library (must be > 0);
  3. kernels  K1 (prefill) and K2 (decode) against their plain versions on
              the card at llama-3-8b widths, f32 and bf16 (rows past a
              prompt's length must be exactly 0; K1 must take the route its
              wrapper names), with timings of the kernel, the plain version,
              one PyTorch library call (SDPA; for K1 both with the dense mask
              and with is_causal) and the least time the card could take
              (bound), plus K1 at the serve phase's three largest prompt
              buckets and the scheduler phase's 8192 bucket at their real
              lengths (checked too), and at B=3 ragged rows (one
              coalesced member admission) at the serve buckets; K1 and K2
              at the head counts one mesh rank gives them (tp=2: H=16/K=4,
              tp=4: H=8/K=2; K1 also at H=16 over 8 192 keys, Ulysses at
              sp=2; K2q8 at both cuts), each timed beside its plain
              version; K2q8 (int8
              cache) against its plain version at K2's shapes (f32 and bf16
              q, window 0 and 4096) and at 4 slots of 32 768 keys all live,
              each with its time, the plain version's, its bound and K2's
              time on the same lengths; the int8 weight
              products (torch._int_mm) at llama-3-8b widths and 1/4/12/32
              rows equal to the exact integer products, timed beside the
              bf16 products;
  4. model    llama-3-8b widths at 2 layers: prefill + decode steps through
              the kernels against the same steps through the plain attention;
              a 2048-token prompt as 4 segments against one K1 prefill;
              CUDA-graph replays of decode_chunk (8 steps) and decode_loop
              (4 chunks; one row finishing in chunk 1) against eager calls
              from the same state, greedy and with a sampled row whose noise
              is drawn ahead (tokens and valid counts equal, caches equal bit
              for bit, ticket counters at 0); the engine's own decode program
              in its logprob variant with penalties and biases, replayed
              against its eager call (tokens, counts, state and caches bit
              for bit, logprobs bit for bit in f32 and within 1e-3 in bf16);
              then three stacked weight sets (members=3): the stacked prefill
              (K1 at B=3) and decode steps against each member alone, and the
              ensemble step against the mean of the members' logits;
  5. serve    the full 32-layer llama-3-8b (bf16, seed 0) behind the port's
              ASGI app with one cuda:// backend: 4 concurrent chat requests
              (streamed and not, greedy and sampled; the two past 512 tokens
              prefill in segments), launch counts of both kernels (K1 = 32 ×
              single-shot admissions), first TTFT and decode-rate readings;
  5b. constrain  response_format on the serve phase's engine (reused, not
              built again): json_object (max_tokens 64; its text walks the
              grammar's DFA), a finite json_schema (parses, validates, stops)
              and a bounded regex (full match) through the app, streamed and
              not; two constrained rows beside two plain greedy rows (plain
              tokens unchanged); a wildcard grammar against the plain variant
              (same tokens, dispatches and overlaps); device ms per 8-step
              dispatch, 4 rows, tagged variant against plain, in turns; one
              constrained stream on a decode_loop=4 engine sharing the
              weights; compile seconds and states per grammar, the arena's
              bucket and bytes, the tagged key's first capture, masked
              tokens, K2 launches (> 0 inside constrained replays alone);
  5s. surfaces  embeddings, prompt scoring and /completions on the serve
              phase's engine (the cache-free forwards through K1, on the
              engine's forward stream): 64 ragged inputs and a 9 000-token
              one against the plain attention, a forward that ignores the
              lengths below the same threshold, 64 × 2 048 scoring (peak
              memory, device and host parts timed apart), a live stream's
              longest gap beside a forward; drain with park, the 503s, and
              each parked stream resumed from its journal equal to an
              unbroken twin; K1 = 32 × (forwards + admissions);
  5c. spec    speculative decoding (llama-3-8b, bf16, 4 slots), each leg
              against a spec_decode=0 twin on the same weights: prompt lookup
              (?spec_decode=4, 32 layers, through the app) on an
              aggregation-style prompt (128 greedy tokens, streamed and not)
              and 4 requests at once (2 greedy repetitive, 1 sampled, 1
              penalized), streams equal or their first divergence an audited
              near-tie of the card's own forward; verify turns, drafted and
              accepted tokens, device ms per verify turn at histories ≤ 2 048
              and ≈ 6 000 against the twin's 8-step chunk per token, each
              verify key's first capture, a profiler split of one verify
              replay and its plain attention timed alone; the fused draft
              loop (?spec_model=llama-3.2-1b) at decode_loop 1 and 4 (same
              tokens; ms per fused turn, acceptance); an oracle draft and an
              int8 target at 8 layers; a speculative_aggregation deployment
              (members=3, 8 layers) that boots and serves an aggregate; K1,
              K2 (target and draft layers) and K2q8 launches exact;
  6. scheduler the engine's default scheduler on the same model at 8 layers: the decode
              ring at depth 2 against 1 (tokens equal), a ≈ 6 000-token
              admission beside a live stream chunked and single-shot (the
              stream's longest gap, the long TTFT, ceil(n/512) segments), a
              two-turn chat through the app with and without prefix reuse
              (exact saved tokens), zero-drain staging against drain-based
              twins (also beside a 64-input forward) and the QoS preemption
              drill, one segment's time per history bucket;
 6b. decode_graphs  every decode dispatch as one CUDA-graph replay on the same
              model: 3 greedy streams × 128 tokens at decode_loop=1 and 4
              (tokens equal), per-stream tok/s, per dispatch its device ms and
              the host seconds until its tokens are read, captures with their
              seconds and the graphs' pool bytes, chunks a row entered against
              chunks dispatched; one eager 16-step decode_chunk against two
              replays of the 8-step graph from the same state (tokens equal);
 6c. knobs    the OpenAI request knobs and engine deadlines on the same model,
              one engine at decode_loop=1, then 4: logit_bias ±100, logprobs
              (+ top_logprobs=5) through the app, n=3 sampled twice with one
              seed, presence/frequency penalties, a 0.5 s timeout → 504
              beside an unchanged live stream, a queued request → 503, the
              deadline clamp at decode_loop=4; tok/s plain and with
              logprobs + penalties, device ms per dispatch of both program
              variants, the logprob keys' captures, deadline-to-504 times,
              and the adjustment pass alone at 4 rows (device ms by graph);
  7. fanout   three full 32-layer llama-3-8b members (bf16, seeds 0, 1, 2)
              behind one app, concatenate and aggregate (LLM1 aggregates):
              greedy requests one at a time on a 300-byte prompt (three
              different member texts, streamed texts equal to non-streamed
              ones, aggregates not degraded), then a concurrent burst of 4;
              launch counts of both kernels over the three engines, ticket
              counters at 0, peak memory;
  8. members  the same deployment on ONE stacked engine
              (cuda://llama-3-8b?members=3&member=i, the shipped
              config.yaml's shape): the fanout phase's requests at 300 and
              1200 bytes, one engine, K1 launches = 32 × single-shot
              dispatches, member texts compared with the fanout phase's;
              then a dedup leg on ?members=3&member_seeds=shared&
              quorum_dedup=1&prefill_chunk=0 (at least one dedup admission,
              exact token savings, TTFT with and without dedup on a
              ≈ 3 000-token prompt);
  9. checkpoint  llama-3-8b (2 layers) and mixtral-8x7b (1 layer, its 8
              experts at real shapes) at full width, bf16, written as HF
              checkpoints over two safetensors shards by this script's own
              writer into a temporary directory (removed at the end) and
              loaded through the app with cuda://…?ckpt=DIR: every leaf
              bit for bit, two greedy requests (one streamed) on the llama
              one whose tokens equal an engine built with params= the
              in-memory weights; bytes, write and load seconds, load GB/s,
              RSS around each load and the process's peak; the llama one
              loaded again with quant=int8 (quantized on the card as it
              loads), every leaf equal to the in-memory quantized tree's;
 10. moe      cuda://mixtral-8x7b?n_layers=16 (full width, bf16, seed 0, 4
              slots, the default scheduler) behind the app: the serve
              phase's 4 concurrent requests (grouped MoE in single-shot
              admissions and 512-token segments, dense MoE in graph-replayed
              decode), K1 = 16 × single-shot dispatches and K2 = 16 × (decode
              + warm-up steps) exactly, device ms per 8-step chunk against
              the weight-read bound, tok/s, captures, peak and free memory;
              then on layer 0 the grouped MoE against the dense oracle at
              cf = E/k on the 3017-token prompt, and the picks cf=2 drops;
 11. quant    cuda://…?quant=int8&kv_quant=int8 behind the app, the serve
              phase's 4 requests: llama-3-8b (32 layers) and then
              mixtral-8x7b at all 32 layers (46.7 GB of int8 weights, one
              card), K1 = layers × single-shot, K2q8 = layers × (decode +
              warm-up steps), K2 = 0, device ms per 8-step chunk against the
              int8 weight-read bound, init seconds, peak memory, the llama
              greedy texts' token agreement with the serve phase's bf16
              ones; an int8-cache decode chunk replayed from a graph equal
              to its eager call bit for bit; on mixtral a 64 × 2 048
              scoring request (one unsplit forward: its capacity can bind)
              beside the 4 requests, its peak over the footprint, and
              64 × 2 049 refused with a 400;
 11b. paged, observe  paged KV and the host store; serving surfaces and
              observability (each phase's docstring lists its legs);
 11c. router  the port's router in front of three llama-3-8b replicas (8
              layers, one engine each over one weight set, prefix_store=host)
              on loopback sockets: affinity, the router's first-byte cost, a
              prefix migration, quorum 2 and 3 (a member killed with and
              without a spare), a stream resumed after its replica dies, a
              drain of two live streams, the fleet timeline; K1 and K2
              launches exact over the three engines;
 11d. mesh    data-, tensor- and sequence-parallel serving (parallel/) on
              llama-3-8b at full width against the single-device engine on
              the same weights: (a) a one-rank NCCL mesh through the app
              (greedy tokens equal; the decode graphs capture the
              collectives); (b) tp=2, two ranks sharing the card over gloo
              (eager decode) through the app, greedy streams held by the
              top-20 log-probabilities, the worker fed rank 0's tokens,
              each rank half the weights; (c) sp=2 ring, then Ulysses, on
              an 8 191-token prompt (first token and top-20 held, the
              admission's seconds, each rank's peak memory); (d) a worker
              killed mid-stream (an error, the breaker open, no process
              left); (e) dp=2, two ranks sharing the card over gloo, 4
              chats through the app, greedy streams held, each rank's
              weight, cache and peak bytes, all-gathers and launches; (f)
              dp=2 × tp=2, four gloo ranks, 4 layers, greedy held; (g)
              dp=2 training, 4 layers, 3 steps on 2 × 2 048 tokens against
              the one-rank step (losses within one bf16 rounding), the
              state saved, restored onto one rank with every leaf equal and
              served one greedy chat; (h) with two or more cards only, tp=2
              and dp=2 over NCCL on cards of their own (graphs on every
              rank, greedy held, the shutdown timed) — one card prints that
              these need two; (i)–(k) checkpoints on meshes, mixtral tp=2
              and pp=2 staged decode; (l) with four cards, mixtral-8x7b as
              pp=4 and tp=4 over NCCL; (m) pp=2 training, two stages sharing
              the card over gloo, 2 layers, 3 steps on 2 × 1 024 tokens
              (2 microbatches) against the one-rank step (losses within one
              bf16 rounding, falling), ms a step, each stage's peak against
              the whole state; (n) disagg=1+1 with both groups on the card,
              8 layers: greedy streams held against the colocated engine,
              the handoffs' count and bytes (the prompts' K/V bytes),
              route direct, K1/K2 launches by group; with two cards, (o)
              cuda://…&disagg=1+1 across cuda:0 and cuda:1 at 32 layers: a
              live stream's longest gap beside a 6 000-token admission
              against the colocated zero-drain engine's, the admission's
              TTFT, the handoffs' bytes and GB/s; with four cards, (p) pp=4
              training over NCCL at 32 layers, 4 × 512 tokens in 4
              microbatches, against the one-card step, (q)
              disagg=2+2 with tp=2 in each group over NCCL, greedy held
              against the colocated tp=2 engine, and (s) tp=2 × dp=2 with
              quant=int8, kv_quant=int8 and members=2 at 32 layers against
              the one-card engine (greedy equal token for token, warm tok/s
              a card, K2q8's device ms inside rank 0's replays), then
              disagg=2+2 with tp=2, kv_quant=int8 and members=2 against
              the colocated tp=2 engine (equal); on one card (r) tp=2 over
              gloo with quant=int8, kv_quant=int8 and members=2 and
              ensemble=2 (2 layers each) against one-card twins, greedy
              equal token for token, and a json_schema chat through the
              app; (t)/(u) the memory knobs and (v)/(w) speculation and
              the forwards on dp/tp meshes (one card / four); (x) on one
              card at 2 layers: prompt lookup (ring, with int8 weights and
              KV) and an oracle draft (Ulysses) on sp=2 held against their
              plain streams, the int8 streams on sp=2 and int8 weights and
              KV on pp=2 held against one card, embeddings and scoring on
              sp=2 and pp=2 against one card; (y) on four cards at 32
              layers: sp=2 × tp=2 with int8 weights and KV (an 8 191-token
              admission and the first of a 4 × 8 192 scoring request held
              against one card, lookup verify turns at the 8 192 bucket,
              the scoring request beside a stream) and mixtral-8x7b as
              pp=4 with an int8 cache (ms a warm token, each stage's cache
              bytes, an 8 × 2 048 scoring request; the staged scoring held
              against one card at 4 layers); each new leg's seconds; K1,
              K2 and K2q8 launches on every rank;
 12. train    training (run last; the card's free memory printed first):
              (a) llama-3-8b, all 32 layers, bf16, seed 0, remat, three
              steps of the default recipe on one repeated 1 × 2 048 batch
              through make_train_step: the loss finite and falling, every
              leaf's step-1 gradient finite and nonzero (each layer's
              slice), forward_logits on the K1 path refusing the grad
              leaves; ms per step (median of steps 2–3; forward + backward
              and optimizer apart, split by the step's grads_hook),
              tokens/s, the share of the step's bound, peak memory; (b)
              llama-tiny in float32, three steps on the card against the
              CPU; (c) llama-3-8b widths at 2 layers: save after step 2,
              restore, step 3 equal to the uninterrupted one bit for bit
              (bytes, seconds, GB/s), accum_steps=2 against one step over
              both micro-batches (the updates' L2 difference a share of
              the step's, two planted faults failing the same bound),
              restore_params growing memory by the params alone, an engine
              on them serving 8 greedy tokens against the plain forward's
              argmax chain, its log-probabilities held against the
              forward's (K1 and K2 launches exact); the training steps
              launch no kernel;
 13. kernels  one line listing the three kernels (launches per phase,
              errors, timings, route, share of the bound, how the main path
              issues them: K1 eagerly, K2 and K2q8 inside decode-graph
              replays);

K2 launch counts are exact in every phase: layers × (decode steps + the one
eager warm-up step each engine runs before its first capture); a replay adds
the K2 calls its graph captured. K2q8 counts the same way on int8 caches.

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
import math
import os
import random
import statistics
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

# Peak rates of one H100 SXM (data sheet; dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12,  # bf16 tensor cores; f32 FMA units
              "int8": 1979e12}  # int8 tensor-core operations

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
# K2q8 is held to ops/flash_decode_q8.error_bound per output element,
# computed from the plain version's own probabilities: only a probability
# within 1e-5 of a rounding boundary may quantize one step apart (ps·|v8|
# each), plus 1e-5 of the output and, for bf16, one bf16 ulp of it.
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


def _k2_steps(m: dict) -> int:
    """Decode steps that launched K2 once per layer in an engine: its decode
    steps and its warm-up step before the first graph capture."""
    return m["decode_steps_total"] + m["decode_graph_warmup_steps_total"]


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

    # K1 at the serve phase's largest buckets and at the scheduler phase's
    # single-shot long prompt, at their real lengths: the tiles past each
    # length write zeros and do no attention work.
    buckets = ([(128, 77)] if tiny else
               [(512, 317), (2048, 1217), (4096, 3017), (8192, 6000)])
    rows = []
    for s, n in buckets:
        flops, nbytes = k1_cost(s, n)
        sets = k1_inputs(s, n, _copies(nbytes))
        got = flash_prefill_attention(*sets[0])
        err = (got[0, :, :n].float() - prefill_attention(*sets[0])[0, :, :n].float()
               ).abs().max().item()
        require(err <= KERNEL_TOL["bfloat16"], f"K1 S={s} length {n}: err {err}")
        require(cpu or bool((got[0, :, n:] == 0).all()), f"K1 S={s}: a row past {n} is not 0")
        results["flash_prefill"]["max_abs_err"] = max(results["flash_prefill"]["max_abs_err"], err)
        del got
        b_ms, b_by = _bound(flops, nbytes)
        t = graph_ms([lambda a=a: flash_prefill_attention(*a) for a in sets])
        rows.append({"S": s, "length": n, "max_abs_err": err, "ms": t, "bound_ms": b_ms,
                     "bound_by": b_by,
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
    results["flash_decode"]["draft_shape"] = _kernels_k2_draft(torch, cpu, tiny, rnd, graph_ms,
                                                                 sdpa)
    results["flash_decode"]["max_abs_err"] = max(results["flash_decode"]["max_abs_err"],
                                                 results["flash_decode"]["draft_shape"]
                                                 ["max_abs_err"])
    per_rank = _kernels_per_rank(torch, cpu, tiny, rnd, graph_ms, sdpa)
    for name in ("flash_prefill", "flash_decode"):
        results[name]["per_rank"] = per_rank[name]
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"],
                                           per_rank["max_abs_err"][name])
    results["flash_decode_q8"] = _kernels_q8(torch, cpu, tiny, rnd, median_ms, graph_ms,
                                             results["flash_decode"]["ms"])
    results["flash_decode_q8"]["per_rank"] = per_rank["flash_decode_q8"]
    results["flash_decode_q8"]["max_abs_err"] = max(results["flash_decode_q8"]["max_abs_err"],
                                                    per_rank["max_abs_err"]["flash_decode_q8"])
    _kernels_int_mm(torch, cpu, tiny, graph_ms)
    return results


def _kernels_k2_draft(torch, cpu: bool, tiny: bool, rnd, graph_ms, sdpa) -> dict:
    """K2 at the shapes the spec phase's draft model (llama-3.2-1b: H=32,
    K=8, hd=64, bf16) gives it inside every fused draft→verify graph: 4
    slots over the draft's cache of the target's max_seq (8192), lengths
    1/100/700/8191 (the fused leg's row is at ≈ 650–700), against the plain
    version; then its time, the plain version's, SDPA's and the bound."""
    from quorum_tpu_torch.ops.attention import decode_attention
    from quorum_tpu_torch.ops.flash_decode import flash_decode_attention, ticket_counters

    dev = "cpu" if cpu else "cuda"
    h, kv, hd = (4, 2, 64) if tiny else (32, 8, 64)
    t = 256 if tiny else 8192
    lens = [1, 100, 200, 255] if tiny else [1, 100, 700, 8191]
    dtype = torch.bfloat16
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    live = sum(lens)
    flops = 4 * h * live * hd
    nbytes = 2 * (live * kv * hd * 2 + 2 * 4 * h * hd) + 4 * 4
    sets = [(rnd(4, h, 1, hd, dtype=dtype), rnd(4, kv, t, hd, dtype=dtype),
             rnd(4, kv, t, hd, dtype=dtype), lengths) for _ in range(_copies(nbytes))]
    n0 = flash_decode_attention.launches
    got = flash_decode_attention(*sets[0])
    ref = decode_attention(*sets[0])
    err = (got.float() - ref.float()).abs().max().item()
    require(bool(torch.isfinite(got.float()).all()), "K2 draft shape: non-finite output")
    require(cpu or flash_decode_attention.launches == n0 + 1,
            "K2 draft shape: one call must count one launch")
    require(err <= KERNEL_TOL["bfloat16"], f"K2 draft shape (hd {hd}): err {err}")
    dmask = (torch.arange(t, device=dev)[None, :] < lengths[:, None])[:, None, None, :]

    bound_ms, bound_by = _bound(flops, nbytes)
    ms = graph_ms([lambda a=a: flash_decode_attention(*a) for a in sets])
    out = {"shape": {"B": 4, "H": h, "K": kv, "T": t, "hd": hd, "dtype": "bfloat16",
                     "window": 0, "lengths": lens},
           "max_abs_err": err, "tol": KERNEL_TOL["bfloat16"], "ms": ms,
           "plain_ms": graph_ms([lambda a=a: decode_attention(*a) for a in sets]),
           "library_ms": graph_ms([sdpa(a[0], a[1], a[2], dmask) for a in sets]),
           "bound_ms": bound_ms,
           "bound_by": bound_by, "pct_of_bound": 100 * bound_ms / ms}
    del sets
    require(cpu or all(int(c.abs().sum()) == 0 for c in ticket_counters()),
            "K2 ticket counters are not back at 0 after the draft-shape replays")
    emit("kernels", kernel="flash_decode", draft_shape=out)
    return out


def _kernels_per_rank(torch, cpu: bool, tiny: bool, rnd, graph_ms, sdpa) -> dict:
    """K1, K2 and K2q8 at the head counts one rank of a mesh gives them (the
    mesh phase's path): llama-3-8b's 32/8 heads cut by tp=2 (H=16, K=4) and
    tp=4 (H=8, K=2); K1 at a 2048-token admission and, for Ulysses at sp=2
    (H=16, K=4 over the whole prompt), at 8192; K2 over 4 slots × 8192 keys
    with lengths 1/100/4096/8191, and at a pipeline stage's row group of
    them at the whole model's heads (pp=2: the 4096/8191 rows; pp=4: the
    8191 row); K2q8 over the same 4 slots at tp=2 and tp=4
    (:func:`_kernels_q8_per_rank`). Each against its plain version, then its
    time, the plain version's, SDPA's (none for K2q8) and the bound."""
    import numpy as np

    from quorum_tpu_torch.ops.attention import decode_attention, prefill_attention
    from quorum_tpu_torch.ops.flash_attention import flash_prefill_attention
    from quorum_tpu_torch.ops.flash_decode import flash_decode_attention, ticket_counters

    dev = "cpu" if cpu else "cuda"
    hd = 64 if tiny else 128
    dtype = torch.bfloat16
    tol = KERNEL_TOL["bfloat16"]
    cuts = ([("tp2", 2, 1), ("tp4", 1, 1)] if tiny else [("tp2", 16, 4), ("tp4", 8, 2)])
    out = {"flash_prefill": [], "flash_decode": [], "max_abs_err": {"flash_prefill": 0.0,
                                                                     "flash_decode": 0.0}}
    k1_shapes = [(name, h, kv, 128 if tiny else 2048) for name, h, kv in cuts]
    k1_shapes.append(("sp2_ulysses", cuts[0][1], cuts[0][2], 128 if tiny else 8192))
    for name, h, kv, s in k1_shapes:
        n = s - 1 if name == "sp2_ulysses" else s
        flops = 4 * h * _prefill_pairs(np, [n], s, 0) * hd
        nbytes = 2 * (h * n * hd + 2 * kv * n * hd + h * s * hd) + 4
        lengths = torch.tensor([n], dtype=torch.int32, device=dev)
        sets = [(rnd(1, h, s, hd, dtype=dtype), rnd(1, kv, s, hd, dtype=dtype),
                 rnd(1, kv, s, hd, dtype=dtype), lengths) for _ in range(_copies(nbytes))]
        n0 = flash_prefill_attention.launches
        got = flash_prefill_attention(*sets[0])
        ref = prefill_attention(*sets[0])
        err = (got[0, :, :n].float() - ref[0, :, :n].float()).abs().max().item()
        del ref
        require(cpu or flash_prefill_attention.launches == n0 + 1,
                f"K1 {name}: one call must count one launch")
        require(cpu or bool((got[0, :, n:] == 0).all()), f"K1 {name}: a row past {n} is not 0")
        require(err <= tol, f"K1 per-rank {name} (H={h}, K={kv}, S={s}): err {err}")
        del got
        ar = torch.arange(s, device=dev)
        mask = ((ar[None, :] <= ar[:, None]) & (ar[None, :] < n))[None, None]
        b_ms, b_by = _bound(flops, nbytes)
        t = graph_ms([lambda a=a: flash_prefill_attention(*a) for a in sets])
        row = {"cut": name, "B": 1, "H": h, "K": kv, "S": s, "length": n, "hd": hd,
               "max_abs_err": err, "tol": tol, "ms": t,
               "plain_ms": graph_ms([lambda a=a: prefill_attention(*a) for a in sets]),
               "library_ms": graph_ms([sdpa(a[0], a[1], a[2], mask) for a in sets]),
               "bound_ms": b_ms, "bound_by": b_by, "pct_of_bound": 100 * b_ms / t}
        del sets, mask
        out["flash_prefill"].append(row)
        out["max_abs_err"]["flash_prefill"] = max(out["max_abs_err"]["flash_prefill"], err)
    t_keys = 256 if tiny else 8192
    all_lens = [1, 100, 200, 255] if tiny else [1, 100, 4096, 8191]
    # A pipeline stage's row group (pp=2: 2 of the 4 slots, the longer
    # group; pp=4: one slot) at the whole model's heads (pp cuts none).
    whole = (4, 2) if tiny else (32, 8)
    k2_cuts = [(name, h, kv, all_lens) for name, h, kv in cuts] + [
        ("pp2_group", *whole, all_lens[2:]), ("pp4_group", *whole, all_lens[3:])]
    for name, h, kv, lens in k2_cuts:
        rows = len(lens)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        live = sum(lens)
        flops = 4 * h * live * hd
        nbytes = 2 * (live * kv * hd * 2 + 2 * rows * h * hd) + 4 * rows
        sets = [(rnd(rows, h, 1, hd, dtype=dtype), rnd(rows, kv, t_keys, hd, dtype=dtype),
                 rnd(rows, kv, t_keys, hd, dtype=dtype), lengths)
                for _ in range(_copies(nbytes))]
        n0 = flash_decode_attention.launches
        got = flash_decode_attention(*sets[0])
        err = (got.float() - decode_attention(*sets[0]).float()).abs().max().item()
        require(cpu or flash_decode_attention.launches == n0 + 1,
                f"K2 {name}: one call must count one launch")
        require(bool(torch.isfinite(got.float()).all()), f"K2 {name}: non-finite output")
        require(err <= tol, f"K2 per-rank {name} (H={h}, K={kv}): err {err}")
        dmask = (torch.arange(t_keys, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
        b_ms, b_by = _bound(flops, nbytes)
        t = graph_ms([lambda a=a: flash_decode_attention(*a) for a in sets])
        out["flash_decode"].append({
            "cut": name, "B": rows, "H": h, "K": kv, "T": t_keys, "hd": hd, "lengths": lens,
            "max_abs_err": err, "tol": tol, "ms": t,
            "plain_ms": graph_ms([lambda a=a: decode_attention(*a) for a in sets]),
            "library_ms": graph_ms([sdpa(a[0], a[1], a[2], dmask) for a in sets]),
            "bound_ms": b_ms, "bound_by": b_by, "pct_of_bound": 100 * b_ms / t})
        del sets, got
        out["max_abs_err"]["flash_decode"] = max(out["max_abs_err"]["flash_decode"], err)
    require(cpu or all(int(c.abs().sum()) == 0 for c in ticket_counters()),
            "K2 ticket counters are not back at 0 after the per-rank replays")
    out["flash_decode_q8"] = _kernels_q8_per_rank(torch, cpu, k2_cuts, hd, t_keys, rnd,
                                                  graph_ms)
    out["max_abs_err"]["flash_decode_q8"] = max(r["max_abs_err"] for r in out["flash_decode_q8"])
    emit("kernels", per_rank=out)
    return out


def _kernels_q8_per_rank(torch, cpu: bool, cuts, hd: int, t_keys: int, rnd,
                         graph_ms) -> list[dict]:
    """K2q8 at the head counts a tp rank's int8 cache gives it (tp=2: H=16,
    K=4; tp=4: H=8, K=2) over the kernels line's 4 slots and lengths, and at
    a pipeline stage's row group at the whole heads (pp=2: the 4096/8191
    rows, pp=4: the 8191 row; an sp rank's cache holds the whole heads and
    rows, the kernels line's shape), bf16 q: every output element within
    ``error_bound`` of the plain version, one counted launch a call, then
    its time, the plain version's and the bound (the live int8 rows and
    their scales). ``cuts``: (name, H, K, lengths)."""
    from quorum_tpu_torch.ops.attention import decode_attention_q8, quantize_rows
    from quorum_tpu_torch.ops.flash_decode_q8 import (error_bound, flash_decode_q8_attention,
                                                      q8_cluster_size)

    dev = "cpu" if cpu else "cuda"
    rows = []
    for name, h, kv, lens in cuts:
        b = len(lens)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        live = sum(lens)

        def args():
            k8, ks = quantize_rows(rnd(b, kv, t_keys, hd, dtype=torch.float32), -1)
            v8, vs = quantize_rows(rnd(b, kv, t_keys, hd, dtype=torch.float32), -1)
            return (rnd(b, h, 1, hd, dtype=torch.bfloat16), k8, ks[..., 0].contiguous(), v8,
                    vs[..., 0].contiguous(), lengths)

        flops = 4 * h * live * hd
        nbytes = live * kv * (2 * hd + 2 * 4) + 2 * 2 * b * h * hd + 4 * b
        sets = [args() for _ in range(1 if cpu else _copies(nbytes))]
        n0 = flash_decode_q8_attention.launches
        got = flash_decode_q8_attention(*sets[0])
        require(cpu or flash_decode_q8_attention.launches == n0 + 1,
                f"K2q8 {name}: one call must count one launch")
        ref = decode_attention_q8(*sets[0]).float()
        diff = (got.float() - ref).abs()
        bound = error_bound(*sets[0])
        err = diff.max().item()
        require(bool(torch.isfinite(got.float()).all()), f"K2q8 {name}: non-finite output")
        require(bool((diff <= bound).all()),
                f"K2q8 per-rank {name} (H={h}, K={kv}): err {err} beyond error_bound")
        b_ms, b_by = _bound(flops, nbytes, "int8")
        t = graph_ms([lambda a=a: flash_decode_q8_attention(*a) for a in sets])
        rows.append({"cut": name, "B": b, "H": h, "K": kv, "T": t_keys, "hd": hd,
                     "lengths": list(lens), "cluster": q8_cluster_size(b, kv, t_keys),
                     "max_abs_err": err, "max_err_over_bound":
                         (diff / bound.clamp_min(1e-30)).max().item(), "ms": t,
                     "plain_ms": graph_ms([lambda a=a: decode_attention_q8(*a) for a in sets]),
                     "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
                     "pct_of_bound": 100 * b_ms / t})
        del sets, got, ref
    return rows


def _kernels_q8(torch, cpu: bool, tiny: bool, rnd, median_ms, graph_ms, k2_ms) -> dict:
    """K2q8 (int8-cache decode attention) against its plain version at K2's
    shapes: 4 slots, T=8192, lengths 1/100/4096/8191, window 0 and 4096,
    q in f32 and bf16 (the cache int8 with f32 per-token scales); then its
    time, the plain version's, the bound (the live int8 rows and their
    scales) and K2's time on the same lengths (bf16 cache); then the same
    at a long cache, 4 slots of T=32768 all live (bf16 q)."""
    from quorum_tpu_torch.ops.attention import (_int_dot, decode_attention_q8,
                                                q8_probabilities, quantize_rows)
    from quorum_tpu_torch.ops.flash_decode import flash_decode_attention
    from quorum_tpu_torch.ops.flash_decode_q8 import (error_bound, flash_decode_q8_attention,
                                                      occupancy, q8_cluster_size, q8_split_plan)

    dev = "cpu" if cpu else "cuda"
    h, kv, hd = (4, 2, 64) if tiny else (32, 8, 128)

    def cache(t):
        k8, ks = quantize_rows(rnd(4, kv, t, hd, dtype=torch.float32), -1)
        v8, vs = quantize_rows(rnd(4, kv, t, hd, dtype=torch.float32), -1)
        return k8, ks[..., 0].contiguous(), v8, vs[..., 0].contiguous()

    def faults(args, lengths, lens, t, w, ref, bound):
        """Outputs of two broken kernels, each of which the limit must
        reject: the longest row's first block's p·V sums zeroed, and the
        first key of its range dropped."""
        q, k8, ks, v8, vs = args
        _, p8, ps = q8_probabilities(q, k8, ks, vs, lengths, w)
        begin, end = q8_split_plan(lens[-1], t, q8_cluster_size(4, kv, t), w)[0]
        p8 = p8.clone()
        p8[-1, ..., begin:end] = 0
        zeroed = (_int_dot("bkgst,bktd->bkgsd", p8, v8) * ps).reshape(ref.shape)
        span = w or lens[-1]
        shifted = decode_attention_q8(q, k8, ks, v8, vs, lengths, window=span - 1).float()
        return {"block_zeroed": bool(((zeroed - ref).abs() > bound).any()),
                "first_key_dropped": bool(((shifted - ref).abs() > bound).any())}

    def check(out, dtype, t, lens, w):
        """One call against the plain version: every output element within
        error_bound, one counted launch, both faults caught."""
        dname = str(dtype).removeprefix("torch.")
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        q = rnd(4, h, 1, hd, dtype=dtype)
        k8, ks, v8, vs = cache(t)
        n0 = flash_decode_q8_attention.launches
        got = flash_decode_q8_attention(q, k8, ks, v8, vs, lengths, window=w)
        ref = decode_attention_q8(q, k8, ks, v8, vs, lengths, window=w).float()
        bound = error_bound(q, k8, ks, v8, vs, lengths, window=w)
        diff = (got.float() - ref).abs()
        err = diff.max().item()
        over = (diff / bound.clamp_min(1e-30)).max().item()
        caught = faults((q, k8, ks, v8, vs), lengths, lens, t, w, ref, bound)
        require(bool(torch.isfinite(got.float()).all()), f"K2q8 non-finite T={t} W={w}")
        require(cpu or flash_decode_q8_attention.launches == n0 + 1,
                "K2q8: one call must count one launch")
        emit("kernels", kernel="flash_decode_q8", dtype=dname, T=t, window=w, lengths=lens,
             max_abs_err=err, max_err_over_bound=over, max_bound=bound.max().item(),
             faults_caught=caught)
        require(bool((diff <= bound).all()), f"K2q8 {dname} T={t} W={w}: err {err} beyond "
                                             f"error_bound ({over} of it)")
        require(all(caught.values()), f"K2q8 {dname} T={t} W={w}: error_bound misses {caught}")
        out["max_abs_err"] = max(out["max_abs_err"], err)
        out["max_err_over_bound"] = max(out["max_err_over_bound"], over)

    def timing(t, lens) -> dict:
        """Time, eager time, the plain version's, the bound and K2 (bf16
        cache) on the same lengths, bf16 q."""
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        live = sum(lens)
        flops = 4 * h * live * hd  # int8 products and adds of q·K and p·V
        nbytes = live * kv * (2 * hd + 2 * 4) + 2 * 2 * 4 * h * hd + 4 * 4
        sets = [(rnd(4, h, 1, hd, dtype=torch.bfloat16), *cache(t), lengths)
                for _ in range(1 if cpu else _copies(nbytes))]
        bound_ms, bound_by = _bound(flops, nbytes, "int8")
        ms = graph_ms([lambda a=a: flash_decode_q8_attention(*a) for a in sets])
        a0 = sets[0]
        row = {"shape": {"B": 4, "H": h, "K": kv, "T": t, "hd": hd, "dtype": "bfloat16",
                         "cache": "int8", "window": 0, "lengths": lens},
               "cluster": q8_cluster_size(4, kv, t), "route": "mma-s8-cluster", "ms": ms,
               "eager_ms": median_ms(lambda: flash_decode_q8_attention(*a0)),
               "plain_ms": graph_ms([lambda a=a: decode_attention_q8(*a) for a in sets]),
               "library_ms": None,
               "library": "none: no single PyTorch call computes int8 attention",
               "flops": flops, "bytes": nbytes, "bound_ms": bound_ms, "bound_by": bound_by,
               "pct_of_bound": 100 * bound_ms / ms}
        if not cpu:
            row["occupancy"] = occupancy(hd, torch.bfloat16, row["cluster"])
        del sets
        return row

    out = {"max_abs_err": 0.0, "max_err_over_bound": 0.0}
    t = 256 if tiny else 8192
    lens = [1, 100, 200, 255] if tiny else [1, 100, 4096, 8191]
    for dtype in (torch.float32, torch.bfloat16):
        for w in ((0, 64) if tiny else (0, 4096)):
            check(out, dtype, t, lens, w)
    out.update(timing(t, lens), k2_ms_same_lengths_bf16=k2_ms)
    emit("kernels", kernel="flash_decode_q8", timing=out)

    # The long cache: 4 slots of 32 768 keys, all live (1 024 under --tiny).
    t = 1024 if tiny else 32768
    lens = [t] * 4
    check(out, torch.bfloat16, t, lens, 0)
    long_cache = timing(t, lens)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    k2_nbytes = 2 * (sum(lens) * kv * hd * 2 + 2 * 4 * h * hd) + 4 * 4
    sets = [(rnd(4, h, 1, hd, dtype=torch.bfloat16), rnd(4, kv, t, hd, dtype=torch.bfloat16),
             rnd(4, kv, t, hd, dtype=torch.bfloat16), lengths)
            for _ in range(1 if cpu else _copies(k2_nbytes))]
    long_cache["k2_ms_same_lengths_bf16"] = graph_ms(
        [lambda a=a: flash_decode_attention(*a) for a in sets])
    del sets
    out["long_cache"] = long_cache
    emit("kernels", kernel="flash_decode_q8", long_cache=long_cache)
    return out


def _kernels_int_mm(torch, cpu: bool, tiny: bool, graph_ms) -> None:
    """The int8 weight products (``models/quant.qeinsum``: ``torch._int_mm``
    on the card, no kernel of this repository) at llama-3-8b widths and 1,
    4, 12 and 32 rows: the integer product equal to the exact one (float64
    of the same int8 operands), and the whole w8a8 product's time (quantize
    x, int8 GEMM, rescale) beside the bf16 product of the same shape and the
    int8 weight-read bound."""
    from quorum_tpu_torch.models import quant as tq

    dev = "cpu" if cpu else "cuda"
    gen = torch.Generator(device="cpu").manual_seed(3)
    d, f, kvd, v = (64, 128, 32, 512) if tiny else (4096, 14336, 1024, 128256)
    rows_out = []
    for name, k, n in (("wq", d, d), ("wk", d, kvd), ("w_gate", d, f), ("w_down", f, d),
                       ("lm_head", d, v)):
        w = torch.randn(k, n, generator=gen).to(dev, torch.bfloat16)
        # Copies of the weight to rotate through (an L2's worth on the card).
        leaves = [tq.quantize_weight(w, -2) for _ in range(1 if cpu else _copies(k * n))]
        ws = [w] + [torch.randn(k, n, generator=gen).to(dev, torch.bfloat16)
                    for _ in range(0 if cpu else _copies(2 * k * n) - 1)]
        for m in (1, 4, 12, 32):
            x = torch.randn(m, k, generator=gen).to(dev, torch.bfloat16)
            x8, _ = tq.quantize_act(x, leaves[0])
            exact = (x8.double() @ leaves[0]["q8"].double().T).float()
            got = tq._int_mm(x8, leaves[0]["q8"])
            require(torch.equal(got, exact), f"qeinsum {name} rows={m}: the int8 product is "
                                             "not the exact integer product")
            row = {"product": name, "rows": m, "K": k, "N": n, "exact": True}
            if m in (4, 32) or tiny:
                b_ms, _ = _bound(2 * m * k * n, k * n + 4 * n + 2 * m * (k + n), "int8")
                row.update(ms=graph_ms([lambda lf=lf: tq.qeinsum("...d,df->...f", x, lf)
                                        for lf in leaves]),
                           bf16_ms=graph_ms([lambda wt=wt: torch.matmul(x, wt) for wt in ws]),
                           bound_ms=b_ms)
            rows_out.append(row)
        del leaves, ws
    emit("kernels", kernel="qeinsum_int_mm", note="torch._int_mm, not a kernel of this repo",
         rows=rows_out)


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
        _model_segments(torch, spec, params, dev, gen, tiny)
        _model_graphs(torch, spec, params, dev, gen, tiny)
        _model_knobs(torch, spec, params, dev, gen, tiny)
        del params
        _model_stacked(torch, spec, dev, gen, bucket, n_prompt, steps)


def _model_segments(torch, spec, params, dev, gen, tiny: bool) -> None:
    """Chunked prefill against single-shot: a 2048-token prompt (128 tiny)
    as 4 segments (``prefill_segment``, plain attention over the row's
    history) against one K1 prefill of the whole prompt. The cache rows and
    the last position's logits (the segment path takes them from a decode
    step on the last prompt token, as the engine's first decode step does)
    must agree within MODEL_TOL."""
    from quorum_tpu_torch.engine.engine import prefill_bucket
    from quorum_tpu_torch.models.transformer import (decode_step, init_cache, prefill,
                                                     prefill_segment)

    n, chunk = (128, 32) if tiny else (2048, 512)
    tokens = torch.randint(3, spec.vocab_size, (1, n), generator=gen).to(dev)
    ck1, cv1 = init_cache(spec, 1, device=dev)
    whole, _, _ = prefill(params, spec, tokens, torch.tensor([n], dtype=torch.int32, device=dev),
                          ck1, cv1, slot=0)
    ck2, cv2 = init_cache(spec, 1, device=dev)
    seg_ms = []
    for off in range(0, n, chunk):
        t0 = time.perf_counter()
        prefill_segment(params, spec, tokens[:, off:off + chunk], [off], ck2, cv2, rows=[0],
                        history=prefill_bucket(off + chunk, spec.max_seq))
        if dev != "cpu":
            torch.cuda.synchronize()
        seg_ms.append((time.perf_counter() - t0) * 1e3)
    cache_err = max((a[:, 0, :, :n].float() - b[:, 0, :, :n].float()).abs().max().item()
                    for a, b in ((ck1, ck2), (cv1, cv2)))
    last, _, _ = decode_step(params, spec, tokens[0, -1:], torch.tensor(
        [n - 1], dtype=torch.int32, device=dev), ck2, cv2)
    logit_err = (whole[0] - last[0]).abs().max().item()
    tol = MODEL_TOL[spec.dtype]
    emit("model", dtype=spec.dtype, layers=spec.n_layers, segments=n // chunk, prompt=n,
         max_abs_cache_diff=cache_err, max_abs_logit_diff_segments=logit_err,
         segment_wall_ms=seg_ms, tol=tol)
    require(bool(torch.isfinite(last).all()), "model segments: non-finite logits")
    require(cache_err <= tol, f"model segments {spec.dtype}: cache differs by {cache_err}")
    require(logit_err <= tol, f"model segments {spec.dtype}: logits differ by {logit_err}")


def _prefilled_rows(torch, spec, params, dev, gen, lens, bucket: int):
    """A cache of ``len(lens)`` rows with random prompts of ``lens`` tokens
    prefilled (a 0 leaves the row empty and dead), and the decode state an
    engine keeps for it: each row's first token (the prefill's argmax), its
    length, live flag and EOS (none)."""
    from quorum_tpu_torch.models.transformer import init_cache, prefill

    ck, cv = init_cache(spec, len(lens), device=dev)
    first = []
    for row, n in enumerate(lens):
        if not n:
            first.append(0)
            continue
        toks = torch.randint(3, spec.vocab_size, (1, bucket), generator=gen).to(dev)
        logits, _, _ = prefill(params, spec, toks, torch.tensor([n], dtype=torch.int32,
                                                                 device=dev), ck, cv, slot=row)
        first.append(int(logits.argmax()))
    state = {"token": torch.tensor(first, device=dev),
             "lengths": torch.tensor(lens, dtype=torch.int32, device=dev)}
    eos = torch.full((len(lens),), -1, dtype=torch.int32, device=dev)
    return ck, cv, state, eos


def _decode_fn(torch, spec, params, n_steps: int, n_chunks: int, eos, sampler):
    """``run(state, cache_k, cache_v)``: one engine-style decode dispatch —
    ``decode_chunk`` for one chunk, ``decode_loop`` for more — that updates
    ``state`` in place and returns ``[n_chunks, rows, n_steps + 1]`` (tokens,
    then valid counts), as the engine's graphs do."""
    from quorum_tpu_torch.models.transformer import decode_chunk, decode_loop

    def run(st, ck, cv):
        args = (st["token"], st["lengths"], st["live"], st["budget"], eos, ck, cv, sampler, 0)
        if n_chunks == 1:
            toks, _, n_valid, live, bud, _, _, lens, _, _ = decode_chunk(params, spec, n_steps,
                                                                         *args)
            toks, n_valid, tok = toks[None], n_valid[None], toks[:, -1]
        else:
            toks, n_valid, tok, live, bud, _, _, lens, _, _ = decode_loop(
                params, spec, n_steps, n_chunks, *args)
        for name, value in (("token", tok), ("live", live), ("budget", bud), ("lengths", lens)):
            st[name].copy_(value)
        return torch.cat([toks, n_valid[..., None].to(toks.dtype)], dim=-1)

    return run


def _replayer(torch, dev, cpu: bool):
    """``replay(key, program, warm_up)`` on a side stream of its own (an
    engine's way: ``engine/graphs.py``); on the CPU, an eager call."""
    if cpu:
        return (lambda key, program, warm_up: program()), None
    from quorum_tpu_torch.engine.graphs import DecodeGraphs

    stream = torch.cuda.Stream()
    graphs = DecodeGraphs(torch.device(dev, torch.cuda.current_device()), stream)

    def replay(key, program, warm_up):
        stream.wait_stream(torch.cuda.current_stream())  # the inputs were set there
        with torch.cuda.stream(stream):
            out = graphs.replay(key, program, warm_up)
        torch.cuda.current_stream().wait_stream(stream)
        return out

    return replay, graphs


def _model_graphs(torch, spec, params, dev, gen, tiny: bool) -> None:
    """Decode dispatches replayed from CUDA graphs against eager calls of the
    same functions from the same prefilled state (4 rows: three prompts, one
    dead row): ``decode_chunk`` of 8 steps, and ``decode_loop`` of 4 chunks
    of 8 (row 2 finishes in chunk 1, row 3 in chunk 3, row 0 in chunk 4),
    greedy; then ``decode_loop`` with row 3 sampled at top-p 0.9, its Gumbel
    noise drawn ahead into a static buffer for the graph and drawn step by
    step from an equally seeded generator for the eager call. Tokens, valid
    counts and the carried state must be equal and the caches equal bit for
    bit (the replay runs the same kernels in the same order); K2's ticket
    counters at 0."""
    from quorum_tpu_torch.ops.flash_decode import ticket_counters
    from quorum_tpu_torch.ops.sampling import gumbel_noise, sample_token_rows

    cpu = dev == "cpu"
    vocab, n_steps = spec.vocab_size, 8
    lens, bucket = ([40, 0, 20, 9], 64) if tiny else ([300, 0, 120, 41], 512)
    ck0, cv0, state0, eos = _prefilled_rows(torch, spec, params, dev, gen, lens, bucket)
    temp = torch.tensor([0.0, 0.0, 0.0, 0.8], device=dev)
    top_p = torch.tensor([1.0, 1.0, 1.0, 0.9], device=dev)
    top_k = torch.zeros(4, dtype=torch.int32, device=dev)
    # The graph's static state and caches; every case starts from state0.
    state = {k: v.clone() for k, v in state0.items()}
    state["budget"] = torch.zeros(4, dtype=torch.int32, device=dev)
    state["live"] = torch.zeros(4, dtype=torch.bool, device=dev)
    gk, gv = ck0.clone(), cv0.clone()
    ahead = torch.zeros((4 * n_steps, 4, vocab), dtype=torch.float32, device=dev)
    replay, graphs = _replayer(torch, dev, cpu)
    results = []
    for name, n_chunks, budget, sampled in (
            ("decode_chunk", 1, [20, 0, 5, 20], False),
            ("decode_loop", 4, [30, 0, 5, 20], False),
            ("decode_loop_sampled", 4, [30, 0, 5, 20], True)):
        budget = torch.tensor(budget, dtype=torch.int32, device=dev)
        eager_noise = torch.zeros((4, vocab), dtype=torch.float32, device=dev)
        g_eager = torch.Generator(device=dev).manual_seed(11)

        def eager_sample(logits, live, k, sampled=sampled):
            if sampled:  # one draw per step, as the engine drew before graphs
                gumbel_noise(vocab, g_eager, out=eager_noise[3])
            return sample_token_rows(logits, temp, top_p, top_k, eager_noise,
                                     restrict=sampled), k + 1, ()

        def graph_sample(logits, live, k, sampled=sampled):
            return sample_token_rows(logits, temp, top_p, top_k, ahead[k],
                                     restrict=sampled), k + 1, ()

        eager_state = {**{k: v.clone() for k, v in state0.items()},
                       "budget": budget.clone(), "live": budget > 0}
        ek, ev = ck0.clone(), cv0.clone()
        want = _decode_fn(torch, spec, params, n_steps, n_chunks, eos, eager_sample)(
            eager_state, ek, ev)
        for key in state0:
            state[key].copy_(state0[key])
        state["budget"].copy_(budget)
        state["live"].copy_(budget > 0)
        gk.copy_(ck0)
        gv.copy_(cv0)
        if sampled:  # the dispatch's draws, ahead, in step order
            g_ahead = torch.Generator(device=dev).manual_seed(11)
            for k in range(n_chunks * n_steps):
                gumbel_noise(vocab, g_ahead, out=ahead[k, 3])
        program = _decode_fn(torch, spec, params, n_steps, n_chunks, eos, graph_sample)
        got = replay((n_steps, n_chunks, sampled), lambda: program(state, gk, gv),
                     lambda: _decode_fn(torch, spec, params, 1, 1, eos, graph_sample)(
                         {k: v.clone() for k, v in state.items()}, gk.clone(), gv.clone()))
        if not cpu:
            torch.cuda.synchronize()
        same_state = all(torch.equal(state[k], eager_state[k]) for k in eager_state)
        same_cache = torch.equal(gk, ek) and torch.equal(gv, ev)
        n_valid = got[..., -1].tolist()
        results.append({"case": name, "n_chunks": n_chunks, "n_steps": n_steps,
                        "tokens_equal": got.tolist() == want.tolist(),
                        "state_equal": same_state, "caches_bit_equal": same_cache,
                        "n_valid_by_chunk": n_valid})
        require(got.tolist() == want.tolist() and same_state,
                f"model graphs {spec.dtype} {name}: replay differs from eager")
        require(same_cache, f"model graphs {spec.dtype} {name}: caches differ from eager")
        if n_chunks > 1:
            require(n_valid[0][2] == 5 and not any(n_valid[c][2] for c in range(1, n_chunks))
                    and n_valid[2][3] == 4 and n_valid[3][3] == 0 and n_valid[3][0] == 6,
                    f"model graphs {name}: rows did not finish where expected: {n_valid}")
    tickets_zero = all(int(c.abs().sum()) == 0 for c in ticket_counters())
    require(tickets_zero, "model graphs: K2 ticket counters are not back at 0")
    emit("model", dtype=spec.dtype, layers=spec.n_layers, graphs=results,
         captures=None if cpu else graphs.captures,
         capture_s=None if cpu else round(graphs.capture_seconds, 3),
         graph_pool_bytes=None if cpu else graphs.pool_bytes, ticket_counters_zero=tickets_zero)


def _model_knobs(torch, spec, params, dev, gen, tiny: bool) -> None:
    """The engine's own decode program with the knobs in it, replayed from
    its CUDA graph against an eager call from the same state: a 4-row
    engine (three prompts, one dead row), ``decode_loop`` of 4 chunks of 8
    steps in the logprob variant; row 0 greedy with presence and frequency
    penalties over prior counts and a -100 bias on its first token, row 2
    greedy with a +5 bias, row 3 sampled (temperature 0.8, noise drawn
    ahead) with penalties. Tokens, valid counts, the counts, the carried
    state and the caches must be equal bit for bit, the logprob records
    bit for bit in f32 and within 1e-3 in bf16."""
    import contextlib

    from quorum_tpu_torch.engine.engine import InferenceEngine
    from quorum_tpu_torch.models.transformer import prefill
    from quorum_tpu_torch.ops.sampling import gumbel_noise

    cpu = dev == "cpu"
    lens, bucket = ([40, 0, 20, 9], 64) if tiny else ([300, 0, 120, 41], 512)
    eng = InferenceEngine(spec, device=dev, params=params, n_slots=4, decode_chunk=8,
                          decode_loop=4)
    key = (8, 4, False, True)
    try:
        first = []
        for row, n in enumerate(lens):
            toks = torch.randint(3, spec.vocab_size, (1, bucket), generator=gen).to(dev)
            logits, _, _ = prefill(params, spec, toks, torch.tensor(
                [max(n, 1)], dtype=torch.int32, device=dev), eng._ck, eng._cv, slot=row)
            first.append(int(logits.argmax()))

        def fill(name, values, dtype):
            getattr(eng, name).copy_(torch.tensor(values, dtype=dtype))

        fill("_token", first, torch.long)
        fill("_lengths", lens, torch.int32)
        fill("_budget", [30, 0, 5, 20], torch.int32)
        fill("_live", [True, False, True, True], torch.bool)
        fill("_mask", [True, False, True, True], torch.bool)
        fill("_temp", [0.0, 0.0, 0.0, 0.8], torch.float32)
        fill("_pp", [0.5, 0.0, 0.0, 0.3], torch.float32)
        fill("_fp", [1.0, 0.0, 0.0, 0.4], torch.float32)
        prior = torch.randint(0, spec.vocab_size, (3, 64), generator=gen)
        for row, ids in zip((0, 2, 3), prior):
            eng._counts[row].index_add_(0, ids.to(dev), torch.ones(64, dtype=torch.int32,
                                                                   device=dev))
        eng._bias[0, first[0]] = -100.0
        eng._bias[2, prior[1, :8].to(dev)] = 5.0
        g = torch.Generator(device=dev).manual_seed(11)
        for k in range(32):
            gumbel_noise(spec.vocab_size, g, out=eng._noise_ring[k, 3])
        names = ("_token", "_lengths", "_live", "_budget", "_counts", "_ntok", "_ck", "_cv")
        start = {n: getattr(eng, n).clone() for n in names}
        ctx = contextlib.nullcontext() if cpu else torch.cuda.stream(eng._stream)
        with ctx:
            out, lp = (t.clone() for t in eng._decode_program(*key))
            eager = {n: getattr(eng, n).clone() for n in names}
            for n in names:
                getattr(eng, n).copy_(start[n])
            if cpu:
                got, got_lp = eng._decode_program(*key)
            else:
                got, got_lp = eng._graphs.replay(key, lambda: eng._decode_program(*key),
                                                 eng._warm_up)
        if not cpu:
            torch.cuda.synchronize()
        same = {n: torch.equal(getattr(eng, n), eager[n]) for n in names}
        lp_err = (got_lp - lp).abs().max().item()
        n_valid = got[..., -1].tolist()
        emit("model", dtype=spec.dtype, layers=spec.n_layers, knobs_graph={
            "key": list(key), "tokens_equal": torch.equal(got, out), "state_equal": same,
            "logprob_max_abs_diff": lp_err, "n_valid_by_chunk": n_valid,
            "captures": None if cpu else eng._graphs.captures})
        require(torch.equal(got, out), f"model knobs {spec.dtype}: replay tokens differ")
        require(all(same.values()), f"model knobs {spec.dtype}: replay state differs: {same}")
        require(lp_err <= (0.0 if spec.dtype == "float32" else 1e-3),
                f"model knobs {spec.dtype}: logprobs differ by {lp_err}")
        require(bool(torch.isfinite(lp[..., :21]).all()) and lp.shape == (4, 8, 4, 41),
                f"model knobs: logprob records {tuple(lp.shape)} or non-finite")
        require(first[0] not in out[:, 0, :8].flatten().tolist(),
                "model knobs: row 0 emitted its -100-biased token")
        require(sum(n_valid[c][0] for c in range(4)) == 30 and n_valid[0][2] == 5,
                f"model knobs: rows did not finish where expected: {n_valid}")
    finally:
        eng.shutdown()


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


async def _call(app, body: dict, headers: dict | None = None, method: str = "POST",
                path: str = "/v1/chat/completions", query: str = "",
                raw: bytes | None = None) -> dict:
    """Drive the ASGI app directly (no HTTP client needed) and time the
    response's body messages: a chat by default; ``headers`` are added to
    the request's, ``raw`` replaces the JSON body."""
    raw = json.dumps(body).encode() if raw is None else raw
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

    scope = {"type": "http", "method": method, "path": path, "query_string": query.encode(),
             "headers": [(b"authorization", b"Bearer smoke"),
                         (b"content-type", b"application/json")]
             + [(k.encode(), v.encode()) for k, v in (headers or {}).items()]}
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


def _serve_bodies(model: str, tiny: bool) -> list[dict]:
    """The serve phase's 4 concurrent requests (prompts of 57, 317, 1217
    and 3017 byte tokens with the chat template; greedy and non-streamed,
    greedy and streamed, sampled and non-streamed, sampled and streamed)."""
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

    return [body(0, False, False), body(1, True, False), body(2, False, True),
            body(3, True, True)]


def phase_serve(torch, cpu: bool, tiny: bool, device_info: dict, profile: bool,
                keep_engine: bool = False) -> dict:
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
    bodies = _serve_bodies(model, tiny)
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
    k2_steps = _k2_steps(m1) - _k2_steps(m0)
    single_shot = m1["admission_dispatches_total"] - m0["admission_dispatches_total"]
    segments = m1["prefill_segments_total"] - m0["prefill_segments_total"]
    require(admissions == 5, f"expected 5 admissions, engine counted {admissions}")
    # Prompts longer than the segment size prefill in segments (no kernel);
    # the rest single-shot, through K1 once per layer.
    chunk = engine.prefill_chunk
    lens = [c["usage"]["prompt_tokens"] for c in checked] + [repeat["usage"]["prompt_tokens"]]
    want_segments = sum(-(-n // chunk) for n in lens if chunk and n > chunk)
    require(segments == want_segments and single_shot == sum(
        1 for n in lens if not chunk or n <= chunk),
        f"{single_shot} single-shot admissions and {segments} segments for prompts of {lens}")
    if not cpu:
        require(launches["flash_prefill"] == n_layers * single_shot,
                f"K1 launches {launches['flash_prefill']} != {n_layers} x {single_shot}")
        require(k1_routes["wgmma"] == n_layers * single_shot,
                f"K1 launches on the wgmma route {k1_routes} != {n_layers} x {single_shot}")
        require(launches["flash_decode"] == n_layers * k2_steps,
                f"K2 launches {launches['flash_decode']} != {n_layers} x {k2_steps}")
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
        "admissions": admissions, "single_shot_admissions": single_shot,
        "prefill_segments": segments, "prefill_chunk": chunk,
        "decode_steps": steps, "graph_warmup_steps": k2_steps - steps,
        "decode_graph_captures": m1["decode_graph_captures_total"],
        "decode_graph_capture_s": m1["decode_graph_capture_seconds_total"],
        "decode_graph_replays": m1["decode_graph_replays_total"],
        "launches": launches,
        "k1_launches_by_route": k1_routes,
        "concurrent_wall_s": round(wall, 4),
        "concurrent_completion_tokens": completion,
        "ttft_s_first_reading": [c["ttft_s"] for c in streams],
        "decode_tok_per_s_per_stream_first_reading": rates,
        "measured_on": card,
        "peak_mem_gb": (None if cpu else round(torch.cuda.max_memory_allocated() / 1e9, 3)),
    }
    emit("serve", **info)
    # The greedy requests' texts, for the quant phase's agreement share.
    info["greedy_texts"] = [c["text"] for b, c in zip(bodies, checked) if "seed" not in b]
    if profile:
        async def one_round():
            return await asyncio.gather(*[_call(app, b) for b in bodies])

        phase_profile(torch, cpu, lambda: asyncio.run(
            asyncio.wait_for(one_round(), 2 * SERVE_TIMEOUT_S)), card, flash_decode_attention)
    if not keep_engine:  # else the constrain or surfaces phase serves on it, then frees it
        shutdown_all_engines()
    return info


# The constrain phase's grammars: a json_schema whose language is finite
# (boolean and enum fields: it must end in EOS within 64 tokens), a bounded
# regex, JSON mode, and a wildcard that masks nothing.
CONSTRAIN_SCHEMA = {"type": "object", "properties": {
    "ok": {"type": "boolean"},
    "dir": {"enum": ["N", "S", "E", "W"]},
    "unit": {"enum": ["m", "km", None]}}}
CONSTRAIN_FORMATS = {
    "json_object": {"type": "json_object"},
    "json_schema": {"type": "json_schema", "json_schema": {"schema": CONSTRAIN_SCHEMA}},
    "regex": {"type": "regex", "pattern": "[0-9]{3}-[0-9]{4}"},
    "wildcard": {"type": "regex", "pattern": "[\\x00-\\xff]*"},
}


def phase_constrain(torch, cpu: bool, tiny: bool, device_info: dict,
                    keep_engine: bool = False) -> dict:
    """Constrained decoding (``response_format``) on the serve phase's
    engine — the full 32-layer llama-3-8b, bf16, 4 slots, decode_chunk 8 —
    reused through ``get_engine``'s cache (built here when the serve phase
    did not run):

    - through the app, streamed and not: ``json_object`` with max_tokens 64
      (first: it sizes the arena's bucket; its text walks the grammar's DFA
      with no dead state, and parses when it stops), a finite
      ``json_schema`` (parses and validates, finish ``stop``) and the regex
      ``[0-9]{3}-[0-9]{4}`` (a full match);
    - through the engine: two constrained rows beside two plain greedy rows
      (the plain rows' tokens equal their run without the constrained
      rows); a wildcard grammar against the plain variant on one greedy
      prompt longer than a segment, so both admit chunked (tokens, dispatch
      and overlap counts equal: the mask adds no host sync); the device ms per 8-step dispatch of the tagged variant
      against the plain one, 4 rows each, in turns (plain, tagged, tagged,
      plain); one constrained stream on a ``decode_loop=4`` engine sharing
      the weights (its tokens equal the decode_loop=1 engine's).

    Reports each grammar's compile seconds and states, the arena's bucket
    and bytes, the tagged key's first capture seconds, masked tokens, K2's
    launches (= layers × decode and warm-up steps, and > 0 over a
    constrained request alone) and K1's (= layers × the plain requests'
    single-shot admissions)."""
    from quorum_tpu_torch.config import Config
    from quorum_tpu_torch.constrain import compile_response_format
    from quorum_tpu_torch.engine.engine import InferenceEngine, shutdown_all_engines
    from quorum_tpu_torch.ops.flash_attention import flash_prefill_attention
    from quorum_tpu_torch.ops.flash_decode import flash_decode_attention
    from quorum_tpu_torch.ops.sampling import SamplerConfig
    from quorum_tpu_torch.server.app import create_app

    model = "llama-tiny" if tiny else "llama-3-8b"
    url = f"cuda://{model}?slots=4&decode_chunk=8" + ("&device=cpu" if cpu else "")
    cfg = Config(raw={"primary_backends": [{"name": "llama", "url": url}],
                      "settings": {"timeout": SERVE_TIMEOUT_S}})
    app = create_app(cfg)
    backend = app.state["registry"].backends[0]
    eng, tok = backend.engine, backend.tokenizer
    reused = eng.n_requests > 0
    spec, vocab, eos = eng.spec, eng.spec.vocab_size, tok.eos_id
    greedy = SamplerConfig(temperature=0.0)
    card = f"{device_info['name']} ({device_info['power_limit']})"
    # Every launch counter to 0 just before the phase's requests, read after.
    flash_prefill_attention.launches = 0
    flash_prefill_attention.launches_by_route.update(wgmma=0, fma=0)
    flash_decode_attention.launches = 0
    m0 = eng.metrics()
    grammars, compile_info = {}, {}
    for name, rf in CONSTRAIN_FORMATS.items():
        t0 = time.perf_counter()
        grammars[name] = compile_response_format(rf, tok, vocab)
        compile_info[name] = {"compile_s": round(time.perf_counter() - t0, 4),
                              "states": grammars[name].n_states,
                              "table_mb": round(grammars[name].table_bytes / 1e6, 3)}

    def call(body):
        return asyncio.run(asyncio.wait_for(_call(app, body), SERVE_TIMEOUT_S))

    def request(name, stream, max_tokens, content):
        body = {"model": model, "messages": [{"role": "user", "content": content}],
                "max_tokens": max_tokens, "temperature": 0, "stream": stream,
                "response_format": CONSTRAIN_FORMATS[name]}
        if stream:
            body["stream_options"] = {"include_usage": True}
        return _check_response(call(body), body, tok, max_tokens)

    # (3) JSON mode first: its 362 states size the arena's bucket, which
    # the smaller grammars then fit.
    texts = {}
    for stream in (False, True):
        out = request("json_object", stream, 64, "Reply with a JSON object.")
        g = grammars["json_object"]
        end = g.advance_tokens(g.start, tok.encode(out["text"]))
        require(end >= 0, f"constrain: json_object text leaves the grammar: {out['text']!r}")
        if out["finish"] == "stop":
            require(bool(g.accept[end]) and isinstance(json.loads(out["text"]), dict),
                    f"constrain: json_object stopped on an incomplete text {out['text']!r}")
        texts["json_object", stream] = out
    m_first = eng.metrics()
    first_capture = {"captures": m_first["decode_graph_captures_total"]
                     - m0["decode_graph_captures_total"],
                     "capture_s": round(m_first["decode_graph_capture_seconds_total"]
                                        - m0["decode_graph_capture_seconds_total"], 4)}
    # (1) the finite json_schema, and K2 inside its constrained replays alone
    launches0, k2_0 = flash_decode_attention.launches, _k2_steps(eng.metrics())
    for stream in (False, True):
        out = request("json_schema", stream, 64, "Is it north?")
        require(out["finish"] == "stop", f"constrain: json_schema ended {out['finish']}")
        obj = json.loads(out["text"])
        require(list(obj) == ["ok", "dir", "unit"] and isinstance(obj["ok"], bool)
                and obj["dir"] in ("N", "S", "E", "W") and obj["unit"] in ("m", "km", None),
                f"constrain: json_schema output does not validate: {out['text']!r}")
        texts["json_schema", stream] = out
    k2_constrained = flash_decode_attention.launches - launches0
    k2_constrained_steps = _k2_steps(eng.metrics()) - k2_0
    if not cpu:
        require(k2_constrained == spec.n_layers * k2_constrained_steps and k2_constrained > 0,
                f"constrain: K2 launched {k2_constrained} times in constrained replays of "
                f"{k2_constrained_steps} steps")
    # (2) the bounded regex
    import re

    for stream in (False, True):
        out = request("regex", stream, 16, "Your number?")
        require(re.fullmatch("[0-9]{3}-[0-9]{4}", out["text"]) is not None
                and out["finish"] == "stop", f"constrain: regex output {out!r}")
        texts["regex", stream] = out
    for name in ("json_object", "json_schema", "regex"):
        if texts[name, False]["finish"] == texts[name, True]["finish"] == "stop":
            require(texts[name, False]["text"] == texts[name, True]["text"],
                    f"constrain: {name} streamed text differs from the non-streamed one")

    def submit(prompt, n, g=None, e=eng):
        return e.submit(tok.encode(prompt), max_new_tokens=n, sampler=greedy, eos_id=eos,
                        grammar=g)

    # (4) a mixed batch: the plain rows' tokens must not see the grammar rows
    plain_prompts = ["the quorum of models answers", "kernels on the card stream keys"]
    solo = [t for t, _ in _stream_all(eng, [submit(p, 48) for p in plain_prompts])]
    with eng._cond:  # admitted in one turn: co-batched from the first chunk
        reqs = ([submit(p, 48) for p in plain_prompts]
                + [submit("Is it north?", 64, grammars["json_schema"]),
                   submit("Your number?", 16, grammars["regex"])])
    mixed = [t for t, _ in _stream_all(eng, reqs)]
    require(mixed[:2] == solo, "constrain: plain rows changed beside constrained rows")
    for toks, name in zip(mixed[2:], ("json_schema", "regex")):
        g = grammars[name]
        require(toks[-1] == eos and g.accept[g.advance_tokens(g.start, toks[:-1])],
                f"constrain: mixed-batch {name} row did not complete its grammar")
    # (5) the wildcard masks nothing: the same tokens, the same dispatches.
    # A prompt longer than one segment admits chunked with or without a
    # grammar, so both streams sample their first token in a decode step
    # (a short plain prompt would take K1's single-shot prefill instead).
    # llama-tiny's segment is its whole window: the rehearsal takes a short one.
    wild_prompt = "wild card" if tiny else _prompt(eng.prefill_chunk + 88, 11)
    n = 32
    for g in (grammars["wildcard"], None):  # warm: both keys captured
        _stream_all(eng, [submit(wild_prompt, n, g)])
    legs = {}
    for name, g in (("wildcard", grammars["wildcard"]), ("plain", None)):
        a = eng.metrics()
        (toks, _), = _stream_all(eng, [submit(wild_prompt, n, g)])
        b = eng.metrics()
        legs[name] = {"tokens": toks,
                      "dispatches": b["decode_chunks_total"] - a["decode_chunks_total"],
                      "overlapped": b["overlapped_chunks_total"] - a["overlapped_chunks_total"]}
    require(legs["wildcard"]["tokens"] == legs["plain"]["tokens"],
            "constrain: the wildcard grammar changed the greedy tokens")
    require((legs["wildcard"]["dispatches"], legs["wildcard"]["overlapped"])
            == (legs["plain"]["dispatches"], legs["plain"]["overlapped"]),
            f"constrain: wildcard dispatches/overlaps {legs['wildcard']} differ from the "
            f"plain variant's {legs['plain']}")
    # The tagged variant's device time per 8-step dispatch against the plain
    # one: 4 rows each, in turns.
    prompts4 = [_prompt(200, 40 + i) for i in range(4)]
    dispatch = eng._dispatch_chunk
    timing = {"plain": [], "tagged": []}
    for name in ("plain", "tagged", "tagged", "plain"):
        recs = _timed_dispatches(torch, eng, cpu)
        g = grammars["wildcard"] if name == "tagged" else None
        _stream_all(eng, [submit(p, 64, g) for p in prompts4])
        eng._dispatch_chunk = dispatch
        ms = _device_ms(torch, cpu, recs)
        if ms:
            timing[name] += [t for (c, _), t in zip(recs, ms)
                             if c.n_chunks == 1 and c.n_steps == 8 and len(c.active) == 4][1:]
    med = {k: statistics.median(v) if v else None for k, v in timing.items()}
    # (6) one constrained stream on a decode_loop=4 engine over the same weights
    eng4 = InferenceEngine(spec, device=eng.device, params=eng.params, n_slots=4,
                           decode_chunk=8, decode_loop=4)
    try:
        (want, _), = _stream_all(eng, [submit("Is it north?", 64, grammars["json_schema"])])
        (got, _), = _stream_all(eng4, [submit("Is it north?", 64, grammars["json_schema"],
                                              e=eng4)])
        m4 = eng4.metrics()
    finally:
        eng4.shutdown()
    require(got == want, "constrain: decode_loop=4 changed the constrained tokens")
    m1 = eng.metrics()
    k2_steps = _k2_steps(m1) - _k2_steps(m0) + _k2_steps(m4)
    # Plain short prompts admit single-shot (K1); grammar ones in segments.
    single_shot = (m1["admission_dispatches_total"] - m0["admission_dispatches_total"]
                   + m4["admission_dispatches_total"])
    launches = {"flash_prefill": flash_prefill_attention.launches,
                "flash_decode": flash_decode_attention.launches}
    if not cpu:
        require(launches["flash_decode"] == spec.n_layers * k2_steps,
                f"K2 launches {launches['flash_decode']} != {spec.n_layers} x {k2_steps}")
        require(launches["flash_prefill"] == spec.n_layers * single_shot
                and flash_prefill_attention.launches_by_route["wgmma"] == launches["flash_prefill"],
                f"K1 launches {launches['flash_prefill']} "
                f"({dict(flash_prefill_attention.launches_by_route)}) != "
                f"{spec.n_layers} x {single_shot} on the wgmma route")
    bucket = eng._g_bucket
    info = {
        "model": model, "layers": spec.n_layers, "vocab": vocab, "dtype": spec.dtype,
        "engine_reused_from_serve": reused,
        "grammars": compile_info,
        "arena": {"states": eng._g_states, "bucket": bucket,
                  "bytes": bucket * vocab * 4 + bucket},
        "first_constrained_request": first_capture,
        "texts": {f"{name}{'_stream' if s else ''}": {"text": o["text"], "finish": o["finish"]}
                  for (name, s), o in texts.items()},
        "constrained_requests": m1["constrained_requests_total"]
        - m0["constrained_requests_total"] + m4["constrained_requests_total"],
        "masked_tokens": m1["constrain_masked_tokens_total"]
        - m0["constrain_masked_tokens_total"] + m4["constrain_masked_tokens_total"],
        "mixed_batch_plain_rows_equal": True,
        "wildcard_vs_plain": {k: {"dispatches": v["dispatches"], "overlapped": v["overlapped"]}
                              for k, v in legs.items()},
        "dispatch_device_ms_8_steps_4_rows": {
            "plain_median": med["plain"], "tagged_median": med["tagged"],
            "n": {k: len(v) for k, v in timing.items()},
            "tagged_minus_plain_per_step_ms": (None if not med["tagged"] else
                                               (med["tagged"] - med["plain"]) / 8),
            "tagged_over_plain": (None if not med["tagged"] else
                                  med["tagged"] / med["plain"] - 1)},
        "decode_loop_4": {"tokens_equal": True,
                          "dispatches": m4["decode_chunks_total"],
                          "captures": m4["decode_graph_captures_total"],
                          "capture_s": m4["decode_graph_capture_seconds_total"]},
        "k2_launches_in_constrained_requests": k2_constrained,
        "single_shot_admissions": single_shot,
        "prefill_segments": m1["prefill_segments_total"] - m0["prefill_segments_total"]
        + m4["prefill_segments_total"],
        "launches": launches,
        "measured_on": card,
        "peak_mem_gb": (None if cpu else round(torch.cuda.max_memory_allocated() / 1e9, 3)),
    }
    emit("constrain", **info)
    if not keep_engine:  # else the surfaces phase serves on it, then frees it
        shutdown_all_engines()
    return info


# Surfaces phase: the cosine the K1 forward's pooled vectors must reach
# against the plain attention's (bf16 rounds P before P·V in the plain
# version only; 32 layers compound it: 1 − cos read 3e-5 on an H100), and
# an input's vector alone against the same input in the batch (read 1.0);
# the same forward pooled over its whole padded bucket (lengths ignored)
# must fall below SURFACES_COSINE_PLAIN, or the check could not see such a
# fault. Then the bounds on the scores: per-token logprob differences of
# the same bf16 forward, mean and largest.
SURFACES_COSINE_PLAIN = 0.9995
SURFACES_COSINE_ALONE = 0.9999
SURFACES_LP_MEAN_TOL = 0.05
SURFACES_LP_MAX_TOL = 1.0
# Device memory a scoring request may add over the engine's footprint: one
# FORWARD_TOKENS sub-batch's activations and the two float32 tensors of one
# SCORE_CHUNK_TOKENS unembed chunk (logits, log-softmax), with room to spare.
SURFACES_SCORE_EXTRA_GB = 12.0


def _forward_flops(spec, b: int, t: int) -> float:
    """A cache-free forward's operations over b full rows of t tokens: the
    block stack's products (2 per weight per token) and causal attention
    (QKᵀ and PV, 4·H·hd per kept query/key pair)."""
    d, hd = spec.d_model, spec.head_dim
    per_layer = (d * spec.n_heads * hd * 2 + d * spec.n_kv_heads * hd * 2
                 + 3 * d * spec.d_ff)
    return b * (2.0 * spec.n_layers * per_layer * t
                + spec.n_layers * 4.0 * spec.n_heads * hd * t * (t + 1) / 2)


def _weight_bytes(eng) -> int:
    return sum(t.nbytes for t in _tensors(eng.params))


def _received(resp: dict, k: int | None = None) -> tuple[list[int], str, str | None, dict | None]:
    """A chat stream's (qt_tokens, text, finish_reason, error chunk) over its
    first ``k`` content chunks (all when None)."""
    from quorum_tpu_torch import sse

    events = [e for e in sse.iter_data_events(resp["data"]) if isinstance(e, dict)]
    err = next((e for e in events if e.get("id") == "error"), None)
    content = [e for e in events if e.get("choices") and e is not err
               and e["choices"][0]["delta"].get("content")]
    content = content if k is None else content[:k]
    finish = next((e["choices"][0]["finish_reason"] for e in events
                   if e.get("choices") and e["choices"][0].get("finish_reason")), None)
    return ([t for e in content for t in e.get("qt_tokens") or ()],
            "".join(e["choices"][0]["delta"]["content"] for e in content), finish, err)


def phase_surfaces(torch, cpu: bool, tiny: bool, device_info: dict) -> dict:
    """Embeddings, prompt scoring and ``/completions`` (the cache-free
    forwards through K1), then drain, park and stream resume, on the serve
    phase's engine (the full 32-layer llama-3-8b, bf16, 4 slots, reused
    through ``get_engine``'s cache; built here when the serve phase did not
    run) behind the app:

    (a) ``/v1/embeddings``: 64 inputs of ragged lengths 16–2 048 and one of
        9 000 tokens (its first 8 192 kept); each vector against the same
        forward with the plain attention on the card (cosine ≥
        SURFACES_COSINE_PLAIN, and a forward that ignores the lengths
        below it), unit norm, an input alone against the same input in the
        batch (≥ SURFACES_COSINE_ALONE), ``dimensions`` and base64; a live greedy stream's
        longest inter-token gap while the 64-input forward runs against the
        same stream alone; peak device memory;
    (b) scoring (``echo``, ``logprobs=5``, ``max_tokens=0``): 8 prompts of
        512–2 048 tokens against the plain attention's scores, the chosen
        token in the top-5 wherever it ranks; then 64 × 2 048, whose peak
        stays within SURFACES_SCORE_EXTRA_GB of the engine's footprint, and
        its device part (``score_token_batch``) and host part (the legacy
        logprobs objects and the JSON) timed apart;
    (c) ``/v1/completions``: greedy raw-prompt text equal to the engine's
        own stream of the same ids, the streamed legacy frames joined equal
        to it, ``echo`` with ``logprobs=2`` offsets aligned;
    (d) 4 live streams and a queued non-streamed request, then
        ``POST /admin/drain?park=1``: the streams end ``parked``, the
        queued request is a 503 with Retry-After; while draining a chat is
        a 503, ``/ready`` a 503, ``/health`` ``degraded``, ``GET
        /admin/drain`` reaches ``resident: 0``; device memory does not grow;
        ``/admin/undrain`` serves again;
    (e) each parked stream resumed from its ``qt_tokens`` journal (and
        ``resume_chars``): text equal to an unbroken twin's, greedy and
        seeded-sampled, ``replayed_tokens_total`` grown by the journals'
        sizes; a resume on a second engine (8 layers, seed 0, next to an
        identical one that served the first part); a forged journal ending
        in ``ReplayDivergence``'s error chunk; ``qt_tokens`` only when asked.

    K1 launches = layers × (forwards + single-shot admissions); K2 = layers
    × (decode + warm-up steps), over both engines. Then, off the counted
    path: ms per forward by (B, T) against its bound, and a scoring
    request's ms against its bound."""
    import base64
    import dataclasses
    import random
    import statistics as st
    import struct
    import threading

    from quorum_tpu_torch.config import Config
    from quorum_tpu_torch.engine import embed as embed_mod
    from quorum_tpu_torch.engine import score as score_mod
    from quorum_tpu_torch.engine.engine import InferenceEngine, shutdown_all_engines
    from quorum_tpu_torch.models.transformer import forward_hidden
    from quorum_tpu_torch.ops.flash_attention import flash_prefill_attention
    from quorum_tpu_torch.ops.flash_decode import flash_decode_attention
    from quorum_tpu_torch.ops.sampling import SamplerConfig
    from quorum_tpu_torch.server.app import create_app

    t_phase = time.perf_counter()
    model = "llama-tiny" if tiny else "llama-3-8b"
    url = f"cuda://{model}?slots=4&decode_chunk=8" + ("&device=cpu" if cpu else "")
    cfg = Config(raw={"primary_backends": [{"name": "llama", "url": url}],
                      "settings": {"timeout": SERVE_TIMEOUT_S}})
    app = create_app(cfg)
    backend = app.state["registry"].backends[0]
    eng, tok = backend.engine, backend.tokenizer
    spec, dev = eng.spec, eng.device
    reused = eng.n_requests > 0
    card = f"{device_info['name']} ({device_info['power_limit']})"
    max_seq, vocab, layers = spec.max_seq, spec.vocab_size, spec.n_layers
    rng = random.Random(15)

    def ids(n):
        return [rng.randrange(3, vocab) for _ in range(n)]

    def call(body, path="/v1/chat/completions", method="POST", query=""):
        return asyncio.run(asyncio.wait_for(
            _call(app, body, method=method, path=path, query=query,
                  raw=b"" if method == "GET" else None), SERVE_TIMEOUT_S))

    def sync():
        if not cpu:
            torch.cuda.synchronize()

    def mem():
        return 0 if cpu else torch.cuda.memory_allocated()

    def forwards(lens, busy=False):
        """Forwards of a request of ``lens``; ``busy``: beside live decode."""
        return len(embed_mod.row_groups(spec, lens, embed_mod.FORWARD_TOKENS_BUSY if busy
                                        else None))

    top_len = 128 if tiny else 2048
    long_len = 200 if tiny else 9000
    footprint = mem()
    # Every launch counter to 0 just before the phase's main path, read after.
    flash_prefill_attention.launches = 0
    flash_prefill_attention.launches_by_route.update(wgmma=0, fma=0)
    flash_decode_attention.launches = 0
    m0 = eng.metrics()
    n_fwd = 0

    # (a) embeddings: one live greedy stream alone, then beside the
    # 64-input request.
    lens64 = [16] + [rng.randint(16, top_len) for _ in range(62)] + [top_len]
    inputs = [ids(n) for n in lens64]
    long_input = ids(long_len)
    live_prompt = tok.encode(tok.render_chat([{"role": "user",
                                               "content": _prompt(30 if tiny else 300, 7)}]))
    greedy = SamplerConfig(temperature=0.0)

    def live_gaps(during=None):
        """The longest gap between a live greedy stream's token deliveries
        (chunk to chunk), alone or while ``during()`` runs."""
        req = eng.submit(live_prompt, max_new_tokens=48 if tiny else 512, sampler=greedy)
        stamps = []
        th = threading.Thread(target=lambda: stamps.extend(
            time.perf_counter() for _ in eng.stream_results(req)), daemon=True)
        th.start()
        while len(stamps) < 16:
            require(th.is_alive() or len(stamps) >= 16, "surfaces: the live stream ended early")
            time.sleep(0.002)
        t0 = time.perf_counter()
        out = during() if during is not None else time.sleep(0.5 if tiny else 2.0)
        t1 = time.perf_counter()
        th.join(timeout=2 * SERVE_TIMEOUT_S)
        require(not th.is_alive(), "surfaces: the live stream never finished")
        window = [b - a for a, b in zip(stamps, stamps[1:]) if b >= t0 and a <= t1]
        return out, (max(window) * 1e3 if window else None), (t1 - t0) * 1e3

    _, gap_alone_ms, _ = live_gaps()
    if not cpu:
        torch.cuda.reset_peak_memory_stats()
    resp64, gap_fwd_ms, fwd_wall_ms = live_gaps(
        lambda: call({"model": model, "input": inputs}, path="/v1/embeddings"))
    peak_embed = 0 if cpu else torch.cuda.max_memory_allocated()
    n_fwd += forwards(lens64, busy=True)  # beside the live stream
    require(resp64["status"] == 200, f"embeddings: {resp64['status']} {resp64['data'][:300]!r}")
    js64 = json.loads(resp64["data"])
    vecs = torch.tensor([d["embedding"] for d in js64["data"]])
    require(vecs.shape == (64, spec.d_model), f"embeddings: shape {tuple(vecs.shape)}")
    require(js64["usage"]["prompt_tokens"] == sum(lens64), f"embeddings usage {js64['usage']}")
    norms = torch.linalg.vector_norm(vecs, dim=-1)
    require(bool(((norms - 1).abs() < 1e-3).all()), f"embeddings: norms {norms.tolist()[:4]}")
    resp_long = call({"model": model, "input": [long_input]}, path="/v1/embeddings")
    n_fwd += 1
    js_long = json.loads(resp_long["data"])
    require(js_long["usage"]["prompt_tokens"] == max_seq,
            f"the {long_len}-token input keeps its first {max_seq}: {js_long['usage']}")
    i_alone = lens64.index(max(lens64[1:-1]))
    alone = json.loads(call({"model": model, "input": [inputs[i_alone]]},
                            path="/v1/embeddings")["data"])["data"][0]["embedding"]
    n_fwd += 1
    dims = 32 if tiny else 256
    cut = json.loads(call({"model": model, "input": [inputs[i_alone]], "dimensions": dims},
                          path="/v1/embeddings")["data"])["data"][0]["embedding"]
    b64 = json.loads(call({"model": model, "input": [inputs[i_alone]],
                           "encoding_format": "base64"}, path="/v1/embeddings")["data"])
    n_fwd += 2

    # (b) scoring: 8 prompts of 512-2048 tokens with the top-5, then 64 ×
    # 2 048.
    # Prompt 0 ends in the engine's own greedy continuation, where the
    # chosen token is the top-1: the top-5 containment check has positions.
    base = ids(top_len // 4)
    cont = list(eng.generate_stream(base, max_new_tokens=32, sampler=greedy))
    lens8 = [len(base) + len(cont)] + [rng.randint(top_len // 4, top_len)
                                       for _ in range(6)] + [top_len]
    prompts8 = [base + cont] + [ids(n) for n in lens8[1:]]
    r8 = call({"model": model, "prompt": prompts8, "echo": True, "logprobs": 5, "max_tokens": 0},
              path="/v1/completions")
    n_fwd += forwards(lens8)
    require(r8["status"] == 200, f"scoring: {r8['status']} {r8['data'][:300]!r}")
    choices8 = json.loads(r8["data"])["choices"]
    prompts64 = [ids(top_len) for _ in range(64)]
    if not cpu:
        sync()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r64 = call({"model": model, "prompt": prompts64, "echo": True, "logprobs": 1,
                "max_tokens": 0}, path="/v1/completions")
    score64_s = time.perf_counter() - t0
    peak_score = 0 if cpu else torch.cuda.max_memory_allocated()
    n_fwd += forwards([top_len] * 64)
    require(r64["status"] == 200, f"64 x {top_len} scoring: {r64['status']} {r64['data'][:300]!r}")
    lp64 = [c["logprobs"]["token_logprobs"] for c in json.loads(r64["data"])["choices"]]
    require(len(lp64) == 64 and all(len(x) == top_len and x[0] is None
                                    and all(v is not None and v <= 0 for v in x[1:])
                                    for x in lp64), "64-prompt scoring: malformed logprobs")

    # (c) /completions generation over raw prompt ids.
    gen_ids = ids(40)
    gen_body = {"model": model, "prompt": [gen_ids], "max_tokens": 24, "temperature": 0}
    flat = json.loads(call(gen_body, path="/v1/completions")["data"])
    own = list(eng.generate_stream(gen_ids, max_new_tokens=24, sampler=greedy,
                                   eos_id=tok.eos_id))
    if own and own[-1] == tok.eos_id:
        own = own[:-1]
    require(flat["choices"][0]["text"] == tok.decode(own),
            "completions: the raw-prompt text differs from the engine's own stream")
    streamed = call({**gen_body, "stream": True}, path="/v1/completions")
    from quorum_tpu_torch import sse

    frames = [e for e in sse.iter_data_events(streamed["data"]) if isinstance(e, dict)]
    require(all(f["object"] == "text_completion" for f in frames), "legacy frames")
    require("".join(f["choices"][0]["text"] for f in frames if f["choices"])
            == flat["choices"][0]["text"], "completions: streamed frames != the flat text")
    echo_prompt = "echo " + _prompt(60 if tiny else 200, 3)
    echo = json.loads(call({"model": model, "prompt": echo_prompt, "echo": True, "logprobs": 2,
                            "max_tokens": 8, "temperature": 0},
                           path="/v1/completions")["data"])["choices"][0]
    n_fwd += 1
    lpe = echo["logprobs"]
    n_echo = len(tok.encode(echo_prompt))
    # The echoed prompt's tokens index the text exactly (incremental
    # detokenizer); the generated ones' per-token texts only keep order.
    pos = 0
    for t, o in zip(lpe["tokens"][:n_echo], lpe["text_offset"][:n_echo]):
        require(o == pos and echo["text"][o:o + len(t)] == t,
                f"echo offsets drift at {o} (expected {pos})")
        pos += len(t)
    require(pos == len(echo_prompt) and echo["text"].startswith(echo_prompt)
            and n_echo < len(lpe["tokens"]) <= n_echo + 8 and lpe["text_offset"] == sorted(
                lpe["text_offset"]) and all(len(d) <= 2 for d in lpe["top_logprobs"][n_echo:]),
            "echo: offsets or logprobs misaligned")

    # (d) drain with park: 4 live streams and a queued non-streamed request.
    n_stream = 48 if tiny else 160

    def chat(i, stream=True, sampled=False, **extra):
        n_chars = (8 + 4 * i) if tiny else (60 + 40 * i)
        b = {"model": model, "messages": [{"role": "user", "content": _prompt(n_chars, 20 + i)}],
             "max_tokens": n_stream, "stream": stream, **extra}
        b.update({"temperature": 0.8, "top_p": 0.9, "seed": 100 + i} if sampled
                 else {"temperature": 0})
        return b

    bodies = [chat(i, sampled=i % 2 == 1, stream_token_ids=True) for i in range(4)]
    def call_all(bs):
        async def run():
            return await asyncio.gather(*[_call(app, b) for b in bs])

        return asyncio.run(asyncio.wait_for(run(), 2 * SERVE_TIMEOUT_S))

    twins = [_received(r) for r in call_all(bodies)]
    require(all(t[2] in ("stop", "length") and t[3] is None for t in twins), "twins unfinished")
    _quiet(eng)

    async def drain_leg():
        tasks = [asyncio.create_task(_call(app, b)) for b in bodies]
        t0 = time.perf_counter()
        while eng.metrics()["busy_slots"] < 4:
            require(time.perf_counter() - t0 < SERVE_TIMEOUT_S, "drain: 4 streams never ran")
            await asyncio.sleep(0.005)
        queued = asyncio.create_task(_call(app, chat(9, stream=False)))
        while eng.metrics()["pending"] < 1:
            await asyncio.sleep(0.002)
        t_first = eng.metrics()["tokens_total"]
        while eng.metrics()["tokens_total"] < t_first + 32:
            await asyncio.sleep(0.002)
        mem0 = mem()
        drained = await _call(app, {}, path="/admin/drain", query="park=1", raw=b"")
        during = {"chat": await _call(app, chat(8, stream=False)),
                  "ready": await _call(app, {}, method="GET", path="/v1/ready", raw=b""),
                  "health": await _call(app, {}, method="GET", path="/health", raw=b"")}
        streams = await asyncio.gather(*tasks)
        shed = await queued
        t0 = time.perf_counter()
        while True:
            status = json.loads((await _call(app, {}, method="GET", path="/v1/admin/drain",
                                             raw=b""))["data"])
            if status["resident"] == 0:
                break
            require(time.perf_counter() - t0 < SERVE_TIMEOUT_S, "drain: residents remain")
            await asyncio.sleep(0.01)
        mem1 = mem()
        undrained = await _call(app, {}, path="/admin/undrain", raw=b"")
        after = await _call(app, chat(8, stream=False, max_tokens=8))
        return drained, during, streams, shed, status, mem1 - mem0, undrained, after

    m_drain0 = eng.metrics()
    drained, during, streams, shed, status, mem_growth, undrained, after = asyncio.run(
        asyncio.wait_for(drain_leg(), 2 * SERVE_TIMEOUT_S))
    parked = [_received(r) for r in streams]
    require(drained["status"] == 200, f"drain: {drained['status']}")
    require(all(p[2] == "parked" and p[3] is None for p in parked),
            f"drain: finishes {[p[2] for p in parked]}")
    require(shed["status"] == 503 and shed["headers"].get("retry-after") == "1",
            f"a parked non-streamed request: {shed['status']} {shed['data'][:200]!r}")
    require(during["chat"]["status"] == 503 and during["chat"]["headers"].get("retry-after"),
            f"a chat while draining: {during['chat']['status']}")
    require(during["ready"]["status"] == 503, "/ready while draining")
    require(json.loads(during["health"]["data"])["status"] == "degraded", "/health while draining")
    require(mem_growth <= 0, f"drain: device memory grew by {mem_growth} B")
    require(undrained["status"] == 200 and after["status"] == 200, "undrain: not serving again")
    m_drain1 = eng.metrics()
    require(m_drain1["drain_parked_total"] - m_drain0["drain_parked_total"] == 5,
            "drain: parked count")

    # (e) resume each parked stream from its journal.
    r0 = eng.metrics()["replayed_tokens_total"]
    # The parked runs asked for qt_tokens; the resumes do not, and get none.
    resumed = call_all([{**{k: v for k, v in b.items() if k != "stream_token_ids"},
                         "resume_tokens": p[0], "resume_chars": len(p[1])}
                        for b, p in zip(bodies, parked)])
    journals = [len(p[0]) for p in parked]
    require(all(0 < n < n_stream for n in journals), f"journals {journals}")
    for i, (p, r, twin) in enumerate(zip(parked, resumed, twins)):
        rest = _received(r)
        require(rest[3] is None, f"resume {i}: {rest[3]}")
        require(rest[0] == [], f"resume {i}: qt_tokens without stream_token_ids")
        require(p[1] + rest[1] == twin[1], f"resume {i} ({'sampled' if i % 2 else 'greedy'}): "
                f"the joined text differs from the unbroken twin's")
    replayed = eng.metrics()["replayed_tokens_total"] - r0
    require(replayed == sum(journals), f"replayed {replayed} != journals {sum(journals)}")
    forged = list(parked[0][0])
    forged[len(forged) // 2] = (forged[len(forged) // 2] + 1) % vocab
    err = _received(call({**bodies[0], "resume_tokens": forged}))[3]
    require(err is not None and err.get("qt_error") == "resume_diverged"
            and "replay diverged at position" in err["choices"][0]["delta"]["content"],
            f"forged journal: {err}")
    # A sibling: two 8-layer engines of one seed; the first serves a
    # prefix, the second resumes it.
    sib_spec = dataclasses.replace(spec, n_layers=2 if tiny else 8)
    sib_a = InferenceEngine(sib_spec, device=dev, seed=0, n_slots=2, decode_chunk=8)
    sib_b = InferenceEngine(sib_spec, device=dev, seed=0, n_slots=2, decode_chunk=8)
    ms_a0, ms_b0 = sib_a.metrics(), sib_b.metrics()
    sampled = SamplerConfig(temperature=0.8, top_p=0.9)
    full = list(sib_a.generate_stream(live_prompt, max_new_tokens=64, sampler=sampled, seed=5))
    req = sib_b.submit(live_prompt, max_new_tokens=64, sampler=sampled, seed=5,
                       resume_tokens=full[:20])
    require(list(sib_b.stream_results(req)) == full[20:],
            "sibling resume: the continuation differs from the first engine's")
    ms_a1, ms_b1 = sib_a.metrics(), sib_b.metrics()
    launches = {"flash_prefill": flash_prefill_attention.launches,
                "flash_decode": flash_decode_attention.launches}
    k1_routes = dict(flash_prefill_attention.launches_by_route)
    m1 = eng.metrics()
    sib_layers = sib_spec.n_layers
    single = m1["admission_dispatches_total"] - m0["admission_dispatches_total"]
    sib_single = sum(b["admission_dispatches_total"] - a["admission_dispatches_total"]
                     for a, b in ((ms_a0, ms_a1), (ms_b0, ms_b1)))
    k2_steps = _k2_steps(m1) - _k2_steps(m0)
    sib_k2 = sum(_k2_steps(b) - _k2_steps(a) for a, b in ((ms_a0, ms_a1), (ms_b0, ms_b1)))
    want_k1 = layers * (n_fwd + single) + sib_layers * sib_single
    want_k2 = layers * k2_steps + sib_layers * sib_k2
    if not cpu:
        require(launches["flash_prefill"] == want_k1,
                f"K1 launches {launches['flash_prefill']} != {layers} x ({n_fwd} forwards + "
                f"{single} admissions) + {sib_layers} x {sib_single}")
        require(launches["flash_decode"] == want_k2,
                f"K2 launches {launches['flash_decode']} != {want_k2}")
    sib_a.shutdown()
    sib_b.shutdown()

    # Off the counted path: the same forwards with the plain attention.
    ref = embed_mod.embed_token_batch(eng, inputs, plain_attention=True)
    cos = (vecs * ref).sum(-1) / (torch.linalg.vector_norm(vecs, dim=-1)
                                  * torch.linalg.vector_norm(ref, dim=-1))
    ref_long = embed_mod.embed_token_batch(eng, [long_input], plain_attention=True)[0]
    cos_long = float((torch.tensor(js_long["data"][0]["embedding"]) * ref_long).sum())
    require(float(cos.min()) >= SURFACES_COSINE_PLAIN and cos_long >= SURFACES_COSINE_PLAIN,
            f"embeddings: cosine to the plain attention {float(cos.min())}, long {cos_long}")
    cos_alone = float((torch.tensor(alone) * vecs[i_alone]).sum())
    require(cos_alone >= SURFACES_COSINE_ALONE,
            f"embeddings: alone vs batched cosine {cos_alone}")
    # A known-wrong forward: each input pooled over its whole padded bucket.
    wrong = []
    with eng.forward_scope():
        for rows in embed_mod.row_groups(spec, lens64):
            toks, _ = embed_mod.padded_batch(spec, inputs, rows, dev)
            h = forward_hidden(eng.params, spec, toks).float().mean(dim=1)[: len(rows)]
            wrong += list(zip(rows, (h / torch.linalg.vector_norm(h, dim=-1,
                                                                  keepdim=True)).cpu()))
    wrong_t = torch.stack([v for _, v in sorted(wrong, key=lambda r: r[0])])
    cos_wrong = (wrong_t * ref).sum(-1)
    require(float(cos_wrong.min()) < SURFACES_COSINE_PLAIN,
            f"embeddings: a forward that ignores the lengths still reaches cosine "
            f"{float(cos_wrong.min())} >= {SURFACES_COSINE_PLAIN}")
    full_alone = torch.tensor(alone)
    want_cut = full_alone[:dims] / torch.linalg.vector_norm(full_alone[:dims])
    require(float((torch.tensor(cut) - want_cut).abs().max()) < 1e-5, f"dimensions={dims}")
    dec = struct.unpack(f"<{spec.d_model}f", base64.b64decode(b64["data"][0]["embedding"]))
    require(float((torch.tensor(dec) - full_alone).abs().max()) < 1e-5, "base64")
    ref8 = score_mod.score_token_batch(eng, prompts8, top_k=5, plain_attention=True)
    diffs = [abs(c["logprobs"]["token_logprobs"][j] - r["token_logprobs"][j])
             for c, r in zip(choices8, ref8) for j in range(1, len(r["token_logprobs"]))]
    diffs_t = torch.tensor(diffs)
    lp_mean, lp_max = float(diffs_t.mean()), float(diffs_t.max())
    require(lp_mean <= SURFACES_LP_MEAN_TOL and lp_max <= SURFACES_LP_MAX_TOL,
            f"scoring: |lp - plain| mean {lp_mean}, max {lp_max}")
    kern8 = score_mod.score_token_batch(eng, prompts8, top_k=5)
    ranked = contained = 0
    top_overlap = []
    for p, k, r in zip(prompts8, kern8, ref8):
        for j in range(1, len(p)):
            ids_k, lps_k = k["top"][j]
            top_overlap.append(len(set(ids_k) & set(r["top"][j][0])) / 5)
            if k["token_logprobs"][j] >= lps_k[-1]:
                ranked += 1
                contained += p[j] in ids_k
    require(contained == ranked and ranked >= len(cont) - 1,
            f"scoring: the chosen token missing from the top-5 at {ranked - contained} of "
            f"{ranked} positions where it ranks (the greedy continuation gives "
            f"{len(cont) - 1})")

    # The 64 × 2 048 scoring request apart: the device part (the forwards,
    # the unembed chunks, the fetch) and the host part (the legacy logprobs
    # objects, then the JSON).
    t0 = time.perf_counter()
    scores64 = score_mod.score_token_batch(eng, prompts64, top_k=1)
    t1 = time.perf_counter()
    rendered = [backend._legacy_logprobs(p, sc, None) for p, sc in zip(prompts64, scores64)]
    t2 = time.perf_counter()
    json.dumps(rendered)
    t3 = time.perf_counter()
    score_split = {"score_token_batch_s": round(t1 - t0, 4),
                   "legacy_logprobs_s": round(t2 - t1, 4), "json_s": round(t3 - t2, 4)}

    # Timings off the counted path: ms per forward at (B, T), and its bound.
    def time_forward(b, t):
        toks = torch.randint(3, vocab, (b, t), device=dev)
        lens = torch.full((b,), t, dtype=torch.int32, device=dev)
        with eng.forward_scope():
            forward_hidden(eng.params, spec, toks, lens)
            s = torch.cuda.current_stream() if not cpu else None
            reps = 3
            if cpu:
                t0 = time.perf_counter()
                for _ in range(reps):
                    forward_hidden(eng.params, spec, toks, lens)
                ms = (time.perf_counter() - t0) * 1e3 / reps
            else:
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record(s)
                for _ in range(reps):
                    forward_hidden(eng.params, spec, toks, lens)
                e1.record(s)
                e1.synchronize()
                ms = e0.elapsed_time(e1) / reps
        bound, by = _bound(_forward_flops(spec, b, t),
                           _weight_bytes(eng) + b * t * (8 + spec.d_model * 2))
        return {"B": b, "T": t, "ms": round(ms, 4), "tokens_per_s": round(b * t / ms * 1e3, 1),
                "bound_ms": round(bound, 4), "bound_by": by,
                "pct_of_bound": round(100 * bound / ms, 1)}

    buckets = ([(1, 128), (8, 128), (64, 16)] if tiny
               else [(1, 2048), (8, 2048), (64, 256), (1, 8192)])
    per_forward = [time_forward(b, t) for b, t in buckets]
    unembed_flops = 2.0 * spec.d_model * vocab * 64 * top_len
    score_bound, score_by = _bound(_forward_flops(spec, 64, top_len) + unembed_flops,
                                   _weight_bytes(eng) + 64 * top_len * (8 + 4 + 5 * 12))
    info = {
        "model": model, "layers": layers, "dtype": spec.dtype, "engine_reused_from_serve": reused,
        "forward_tokens": embed_mod.FORWARD_TOKENS,
        "forward_tokens_busy": embed_mod.FORWARD_TOKENS_BUSY,
        "score_chunk_tokens": score_mod.SCORE_CHUNK_TOKENS,
        "embeddings": {
            "inputs": 64, "lengths": [min(lens64), max(lens64)],
            "forwards": forwards(lens64, busy=True),
            "cosine_to_plain_min": float(cos.min()),
            "cosine_to_plain_median": float(cos.median()), "cosine_long_input": cos_long,
            "cosine_alone_vs_batched": cos_alone,
            "cosine_lengths_ignored_min": float(cos_wrong.min()),
            "cosine_lengths_ignored_median": float(cos_wrong.median()),
            "norm_max_err": float((norms - 1).abs().max()),
            "request_wall_ms": round(fwd_wall_ms, 3),
            "peak_gb_over_footprint": (None if cpu else round((peak_embed - footprint) / 1e9, 3)),
            "live_stream_longest_gap_ms": {"alone": gap_alone_ms, "during_forward": gap_fwd_ms}},
        "scoring": {
            "prompts_8": {"lengths": lens8, "lp_abs_diff_mean": lp_mean,
                          "lp_abs_diff_max": lp_max,
                          "top5_overlap_mean": st.mean(top_overlap),
                          "ranked_positions": ranked, "chosen_in_top5": contained},
            "prompts_64": {"tokens": 64 * top_len, "forwards": forwards([top_len] * 64),
                           "request_s": round(score64_s, 4), "split": score_split,
                           "bound_ms": round(score_bound, 3), "bound_by": score_by,
                           "peak_gb": None if cpu else round(peak_score / 1e9, 3),
                           "footprint_gb": None if cpu else round(footprint / 1e9, 3),
                           "one_whole_f32_tensor_gb": round(64 * top_len * vocab * 4 / 1e9, 2)}},
        "completions": {"greedy_equals_engine_stream": True, "streamed_equals_flat": True,
                        "echo_offsets_aligned": True},
        "drain": {"parked_streams": 4, "queued_503": True, "memory_growth_bytes": mem_growth,
                  "status_after": status, "journal_tokens": journals},
        "resume": {"replayed_tokens": replayed, "joined_equal_twins": True,
                   "sibling_equal": True, "forged_diverged": True},
        "forward_ms_by_bucket": per_forward,
        "n_forwards": n_fwd, "single_shot_admissions": single,
        "launches": launches, "k1_launches_by_route": k1_routes,
        "measured_on": card, "phase_s": round(time.perf_counter() - t_phase, 3),
    }
    if not cpu:
        require(peak_score - footprint < SURFACES_SCORE_EXTRA_GB * 1e9,
                f"64 x {top_len} scoring peaked {peak_score / 1e9:.2f} GB over a "
                f"{footprint / 1e9:.2f} GB footprint")
    emit("surfaces", **info)
    shutdown_all_engines()
    return info


def _stream_all(eng, reqs) -> list[tuple[list[int], list[float]]]:
    """Consume submitted requests on one thread each: every stream's tokens
    and the time each arrived. Fails (never hangs) after 2 × SERVE_TIMEOUT_S."""
    import threading

    out: list = [None] * len(reqs)

    def consume(i):
        toks, ts = [], []
        for t in eng.stream_results(reqs[i]):
            toks.append(t)
            ts.append(time.perf_counter())
        out[i] = (toks, ts)

    threads = [threading.Thread(target=consume, args=(i,), daemon=True) for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=2 * SERVE_TIMEOUT_S)
    require(not any(t.is_alive() for t in threads), "scheduler: a stream never finished")
    return out


def _long_beside_live(eng, live_prompt, long_prompt, greedy) -> dict:
    """A live greedy stream, then (once it has 16 tokens) a long prompt: the
    live stream's longest gap between tokens while the long request is in
    the engine, the long request's time to first token, and the engine's
    admission counters over the leg."""
    import threading

    live = eng.submit(live_prompt, max_new_tokens=1024, sampler=greedy)
    times: list[float] = []
    live_ids: list[int] = []
    stop = threading.Event()

    def consume_live():
        it = eng.stream_results(live)
        for t in it:
            times.append(time.perf_counter())
            live_ids.append(t)
            if stop.is_set():
                break
        it.close()  # the consumer leaves: the row is released at the next turn

    th = threading.Thread(target=consume_live, daemon=True)
    th.start()
    deadline = time.perf_counter() + SERVE_TIMEOUT_S
    while len(times) < 16 and time.perf_counter() < deadline:
        time.sleep(0.005)
    require(len(times) >= 16, "scheduler: the live stream did not start")
    m0 = eng.metrics()
    t_sub = time.perf_counter()
    got = _stream_all(eng, [eng.submit(long_prompt, max_new_tokens=4, sampler=greedy)])
    (toks, ts), = got
    t_done = ts[-1]
    n_done = len(times)
    while len(times) < n_done + eng.decode_chunk and time.perf_counter() < deadline:
        time.sleep(0.005)  # one more chunk of the live stream after the long one
    stop.set()
    th.join(timeout=SERVE_TIMEOUT_S)
    require(not th.is_alive(), "scheduler: the live stream did not stop")
    m1 = eng.metrics()
    gaps = [b - a for a, b in zip(times, times[1:]) if b > t_sub and a < t_done]
    return {"long_prompt_tokens": len(long_prompt), "long_tokens": len(toks),
            "long_ttft_s": ts[0] - t_sub, "long_wall_s": t_done - t_sub,
            "live_max_gap_s": max(gaps) if gaps else None,
            "live_tokens_during_long": sum(1 for t in times if t_sub < t <= t_done),
            "prefill_segments": m1["prefill_segments_total"] - m0["prefill_segments_total"],
            "single_shot_admissions": (m1["admission_dispatches_total"]
                                       - m0["admission_dispatches_total"]),
            "admission_stall_s": round(m1["admission_stall_seconds_total"]
                                       - m0["admission_stall_seconds_total"], 6),
            "admission_overlap": (m1["admission_overlap_total"]
                                  - m0["admission_overlap_total"]),
            "live_ids": live_ids, "long_ids": toks}


def _public(leg: dict) -> dict:
    """A leg's numbers without its token lists."""
    return {k: v for k, v in leg.items() if not k.endswith("_ids")}


def _staging_bytes(spec, rows: int, kv_quant: str | None) -> int:
    """The staging cache a zero-drain engine adds, reckoned from the spec:
    2 sides × layers × rows × kv_heads × max_seq × (head_dim × element
    size), or with int8 KV (head_dim × 1 B + one f32 scale)."""
    per_pos = spec.n_layers * rows * spec.n_kv_heads * spec.max_seq
    if kv_quant == "int8":
        return 2 * per_pos * (spec.head_dim + 4)
    return 2 * per_pos * spec.head_dim * (4 if spec.dtype == "float32" else 2)


def _launch_counts() -> dict:
    from quorum_tpu_torch.ops.flash_attention import flash_prefill_attention
    from quorum_tpu_torch.ops.flash_decode import flash_decode_attention
    from quorum_tpu_torch.ops.flash_decode_q8 import flash_decode_q8_attention

    return {"flash_prefill": flash_prefill_attention.launches,
            "flash_decode": flash_decode_attention.launches,
            "flash_decode_q8": flash_decode_q8_attention.launches}


def _require_exact_launches(cpu: bool, n_layers: int, what: str, c0: dict, c1: dict,
                            single_shot: int, k2_steps: int, q8: bool = False,
                            forwards: int = 0) -> dict:
    """The launches one leg's engine made between ``c0`` and ``c1`` (it was
    quiet at both): K1 once per layer per single-shot admission and per
    cache-free forward, K2 (or K2q8 on an int8 cache) once per layer per
    decode and warm-up step."""
    got = {k: c1[k] - c0[k] for k in c0}
    if not cpu:
        dec, other = ("flash_decode_q8", "flash_decode") if q8 else ("flash_decode",
                                                                     "flash_decode_q8")
        want = {"flash_prefill": n_layers * (single_shot + forwards),
                dec: n_layers * k2_steps, other: 0}
        require(got == want and k2_steps > 0, f"{what}: launches {got} != {want}")
    return got


def _staged_beside_forward(torch, cpu: bool, spec, eng, live_prompt, staged_prompt, inputs,
                           greedy, twin_live) -> dict:
    """On a zero-drain engine, beside one live greedy stream: a staged
    admission of ``staged_prompt`` alone, then the same admission submitted
    just after a 64-input embedding forward (``inputs``) has started on
    another thread. Each admission's TTFT and the live stream's longest gap
    while it was in the engine, the forward's wall and sub-batches. Its
    tokens equal the lone admission's, the live stream's equal
    ``twin_live`` and the vectors are unit norm (required)."""
    import threading

    from quorum_tpu_torch.engine import embed as embed_mod

    live = eng.submit(live_prompt, max_new_tokens=1024, sampler=greedy)
    times: list[float] = []
    live_ids: list[int] = []
    stop = threading.Event()

    def consume_live():
        it = eng.stream_results(live)
        for t in it:
            times.append(time.perf_counter())
            live_ids.append(t)
            if stop.is_set():
                break
        it.close()

    th = threading.Thread(target=consume_live, daemon=True)
    th.start()
    deadline = time.perf_counter() + SERVE_TIMEOUT_S
    while len(times) < 16 and time.perf_counter() < deadline:
        time.sleep(0.005)
    require(len(times) >= 16, "zero-drain beside a forward: the live stream did not start")

    def admit():
        t0 = time.perf_counter()
        (toks, ts), = _stream_all(eng, [eng.submit(staged_prompt, max_new_tokens=4,
                                                   sampler=greedy)])
        gaps = [b - a for a, b in zip(times, times[1:]) if b > t0 and a < ts[-1]]
        return toks, {"ttft_s": ts[0] - t0, "live_max_gap_s": max(gaps) if gaps else None}

    alone_ids, alone = admit()
    lens = [len(x) for x in inputs]
    groups = len(embed_mod.row_groups(spec, lens, embed_mod.FORWARD_TOKENS_BUSY))
    fwd: dict = {}
    started = threading.Event()

    def forward():
        started.set()
        t0 = time.perf_counter()
        fwd["vecs"] = embed_mod.embed_token_batch(eng, inputs)
        fwd["wall_s"] = time.perf_counter() - t0

    th_f = threading.Thread(target=forward, daemon=True)
    th_f.start()
    started.wait()
    beside_ids, beside = admit()
    th_f.join(timeout=SERVE_TIMEOUT_S)
    require(not th_f.is_alive() and "vecs" in fwd,
            "zero-drain beside a forward: the forward did not finish")
    n_done = len(times)
    while len(times) < n_done + eng.decode_chunk and time.perf_counter() < deadline:
        time.sleep(0.005)
    stop.set()
    th.join(timeout=SERVE_TIMEOUT_S)
    require(not th.is_alive(), "zero-drain beside a forward: the live stream did not stop")
    vecs = fwd["vecs"]
    norms = torch.linalg.vector_norm(vecs, dim=-1)
    require(tuple(vecs.shape) == (len(inputs), spec.d_model)
            and bool(torch.isfinite(vecs).all()) and bool(((norms - 1).abs() < 1e-3).all()),
            f"zero-drain beside a forward: vectors {tuple(vecs.shape)}, norms "
            f"{norms.tolist()[:4]}")
    require(beside_ids == alone_ids and len(alone_ids) == 4,
            "zero-drain beside a forward: the staged admission's tokens changed")
    n = min(len(live_ids), len(twin_live))
    require(n >= 16 and live_ids[:n] == twin_live[:n],
            "zero-drain beside a forward: the live stream differs from the twin's")
    return {"staged_prompt_tokens": len(staged_prompt), "forward_inputs": len(inputs),
            "forward_tokens": sum(lens), "forward_sub_batches": groups,
            "forward_wall_s": fwd["wall_s"], "alone": alone, "beside_forward": beside,
            "tokens_equal": True}


def _zero_drain_legs(torch, cpu: bool, spec, built, twin_leg: dict, main_bytes: int,
                     live_prompt, long_prompt, greedy, prompt) -> tuple[dict, object]:
    """Leg (d): leg (b) on zero_drain=1 engines against drain-based twins:
    at the defaults against leg (b)'s chunked run on the same prompts
    (``twin_leg``, the engine built with ``main_bytes``), then on the same
    engine a staged admission beside a 64-input forward
    (``_staged_beside_forward``); at decode_pipeline=4 × decode_loop=4
    (with ``decode_chunk=4``, the JAX package's pinned shape) against a
    fresh twin; then two streams on an int8-KV zero-drain engine against
    its twin. Returns the numbers (``forwards``: the forward's
    sub-batches, K1 calls per layer) and the default zero-drain engine,
    which leg (e) reuses."""
    out: dict = {}
    rows = 4  # the phase's slots
    keep = None
    deep = {"decode_pipeline": 4, "decode_loop": 4, "decode_chunk": 4}
    for name, knobs in (("default", {}), ("k4c4", deep)):
        t0 = time.perf_counter()
        legs = {} if knobs else {"twin": twin_leg}
        if knobs:
            twin, twin_bytes = built(**knobs)
        zeng, z_bytes = built(zero_drain=True, **knobs)
        for kind in (["twin"] if knobs else []) + ["zero_drain"]:
            eng = twin if kind == "twin" else zeng
            _quiet(eng)
            c0, m0 = _launch_counts(), eng.metrics()
            legs[kind] = _long_beside_live(eng, live_prompt, long_prompt, greedy)
            _quiet(eng)
            c1, m1 = _launch_counts(), eng.metrics()
            legs[kind]["launches"] = _require_exact_launches(
                cpu, spec.n_layers, f"zero-drain leg {name} {kind}", c0, c1,
                m1["admission_dispatches_total"] - m0["admission_dispatches_total"],
                _k2_steps(m1) - _k2_steps(m0))
            legs[kind]["capture_s"] = round(m1["decode_graph_capture_seconds_total"]
                                            - m0["decode_graph_capture_seconds_total"], 3)
        t, z = legs["twin"], legs["zero_drain"]
        n = min(len(t["live_ids"]), len(z["live_ids"]))
        require(z["long_ids"] == t["long_ids"] and n >= 16
                and z["live_ids"][:n] == t["live_ids"][:n],
                f"zero-drain leg {name}: tokens differ from the drain-based twin's")
        require(z["admission_stall_s"] == 0.0 and z["admission_overlap"] > 0,
                f"zero-drain leg {name}: stall {z['admission_stall_s']}, "
                f"overlap {z['admission_overlap']}")
        require(z["single_shot_admissions"] == 0 and z["launches"]["flash_prefill"] == 0,
                f"zero-drain leg {name}: a single-shot admission ran")
        require(z["prefill_segments"] == t["prefill_segments"],
                f"zero-drain leg {name}: segments differ from the twin's")
        reckoned = _staging_bytes(spec, rows, None)
        grown = z_bytes - (twin_bytes if knobs else main_bytes)
        if not cpu:
            require(abs(grown - reckoned) <= 0.01 * reckoned,
                    f"zero-drain leg {name}: device memory grew {grown} B beyond the twin's, "
                    f"the staging cache is reckoned at {reckoned} B")
        out[name] = {**{k: _public(v) for k, v in legs.items()}, "tokens_equal": True,
                     "staging_bytes_reckoned": reckoned,
                     "device_memory_grown_bytes": None if cpu else grown}
        if knobs:
            zeng.shutdown()
            twin.shutdown()
        else:
            keep = zeng
            # The forward runs on the engine's forward stream, the segments
            # on its staging stream: neither queues behind the other.
            inputs = [prompt(256) for _ in range(64)]
            c0, m0 = _launch_counts(), zeng.metrics()
            fwd = _staged_beside_forward(torch, cpu, spec, zeng, live_prompt,
                                         prompt(3 * zeng.prefill_chunk + 88), inputs, greedy,
                                         t["live_ids"])
            _quiet(zeng)
            c1, m1 = _launch_counts(), zeng.metrics()
            fwd["launches"] = _require_exact_launches(
                cpu, spec.n_layers, "zero-drain beside a forward", c0, c1,
                m1["admission_dispatches_total"] - m0["admission_dispatches_total"],
                _k2_steps(m1) - _k2_steps(m0), forwards=fwd["forward_sub_batches"])
            out["forwards"] = fwd["forward_sub_batches"]
            out[name]["beside_forward"] = fwd
        out[name]["seconds"] = round(time.perf_counter() - t0, 3)
    # int8 KV: two streams (prompts longer than a segment: both engines
    # admit them chunked) on a zero-drain engine and its twin.
    t0 = time.perf_counter()
    prompts = [prompt(len(live_prompt)), prompt(2 * len(live_prompt))]
    got = {}
    for kind, knobs in (("twin", {}), ("zero_drain", {"zero_drain": True})):
        eng, nbytes = built(kv_quant="int8", **knobs)
        c0 = _launch_counts()
        streams = _stream_all(eng, [eng.submit(p, max_new_tokens=32, sampler=greedy)
                                    for p in prompts])
        _quiet(eng)
        m = eng.metrics()
        got[kind] = {"tokens": [t for t, _ in streams], "bytes": nbytes,
                     "launches": _require_exact_launches(
                         cpu, spec.n_layers, f"zero-drain int8 {kind}", c0, _launch_counts(),
                         m["admission_dispatches_total"], _k2_steps(m), q8=True),
                     "stall_s": m["admission_stall_seconds_total"]}
        eng.shutdown()
    require(got["zero_drain"]["tokens"] == got["twin"]["tokens"]
            and all(len(t) == 32 for t in got["twin"]["tokens"]),
            "zero-drain int8: tokens differ from the drain-based twin's")
    require(got["zero_drain"]["stall_s"] == 0.0, "zero-drain int8: the ring clamped")
    reckoned = _staging_bytes(spec, rows, "int8")
    grown = got["zero_drain"]["bytes"] - got["twin"]["bytes"]
    if not cpu:
        require(abs(grown - reckoned) <= 0.01 * reckoned,
                f"zero-drain int8: memory grew {grown} B, reckoned {reckoned} B")
    out["int8"] = {"streams": len(prompts), "tokens_equal": True,
                   "k2q8_launches": got["zero_drain"]["launches"]["flash_decode_q8"],
                   "staging_bytes_reckoned": reckoned,
                   "device_memory_grown_bytes": None if cpu else grown,
                   "seconds": round(time.perf_counter() - t0, 3)}
    return out, keep


def _batch_streams(eng, prompts, samplers, n_tok: int) -> list:
    return [eng.submit(p, max_new_tokens=n_tok, sampler=s, seed=i, priority="batch")
            for i, (p, s) in enumerate(zip(prompts, samplers))]


def _qos_drill(eng, prompts, samplers, inter_prompt, n_tok: int, inter_tok: int) -> dict:
    """Leg (e)'s submission on a 4-slot engine: the four batch streams, and
    one interactive chat once every stream has 32 tokens. Returns the
    streams, the chat, its TTFT, the preempted streams and the engine's
    counters over it."""
    import threading

    _quiet(eng)
    m0 = eng.metrics()
    reqs = _batch_streams(eng, prompts, samplers, n_tok)
    out: list = [None] * len(reqs)

    def consume(i):
        out[i] = list(eng.stream_results(reqs[i]))

    threads = [threading.Thread(target=consume, args=(i,), daemon=True) for i in range(len(reqs))]
    for t in threads:
        t.start()
    deadline = time.perf_counter() + SERVE_TIMEOUT_S
    while min(r.emitted for r in reqs) < 32 and time.perf_counter() < deadline:
        time.sleep(0.002)
    require(min(r.emitted for r in reqs) >= 32, "qos drill: the batch streams did not start")
    require(max(r.emitted for r in reqs) < n_tok, "qos drill: a batch stream already ended")
    ttft, chat = _ttft(eng, inter_prompt, samplers[0], inter_tok, priority="interactive")
    for t in threads:
        t.join(timeout=2 * SERVE_TIMEOUT_S)
    require(not any(t.is_alive() for t in threads), "qos drill: a batch stream never finished")
    _quiet(eng)
    m1 = eng.metrics()
    return {"streams": out, "chat": chat, "chat_ttft_s": ttft,
            "victims": [i for i, r in enumerate(reqs) if r.n_preempts],
            "delta": {k: m1[k] - m0[k] for k in (
                "preemptions_total", "preempted_tokens_total", "replayed_tokens_total",
                "admission_dispatches_total", "prefill_segments_total")},
            "metrics": m1}


def _qos_legs(torch, cpu: bool, spec, built, prompt, n_tok: int, main, zeng) -> dict:
    """Leg (e): four batch streams (two greedy, two sampled) fill a 4-slot
    engine's rows; once each has 32 tokens an interactive chat arrives. On
    ``main`` with qos off (FIFO: the chat waits for a row; the streams are
    the dense twins), then with qos on, on a paged engine and on leg (d)'s
    zero-drain engine: exactly one stream is parked and resumes token for
    token. ``qos`` is host policy only, so the same engines turn it on."""
    from quorum_tpu_torch.ops.sampling import SamplerConfig

    # Sampled without a cutoff: one graph key for every row mix.
    samplers = [SamplerConfig(temperature=0.0)] * 2 + [SamplerConfig(temperature=0.9)] * 2
    prompts = [prompt(64) for _ in range(4)]
    inter = prompt(32)
    t0 = time.perf_counter()
    fifo = _qos_drill(main, prompts, samplers, inter, n_tok, 32)
    require(len(fifo["chat"]) == 32 and fifo["delta"]["preemptions_total"] == 0
            and not fifo["victims"], "qos=0: the chat or a preemption")
    out: dict = {"fifo_interactive_ttft_s": fifo["chat_ttft_s"]}
    paged, _ = built(qos=True, kv_pages=True)
    for name, eng in (("dense", main), ("paged", paged), ("zero_drain", zeng)):
        eng.qos = True
        c0 = _launch_counts()
        d0 = eng.metrics()
        if eng is main:
            twins = fifo["streams"]
        else:
            twins = [t for t, _ in _stream_all(eng, _batch_streams(eng, prompts, samplers,
                                                                   n_tok))]
        r = _qos_drill(eng, prompts, samplers, inter, n_tok, 32)
        m, d = r["metrics"], r["delta"]
        launches = _require_exact_launches(
            cpu, spec.n_layers, f"qos {name}", c0, _launch_counts(),
            m["admission_dispatches_total"] - d0["admission_dispatches_total"],
            _k2_steps(m) - _k2_steps(d0))
        require(d["preemptions_total"] == 1 and len(r["victims"]) == 1,
                f"qos {name}: {d['preemptions_total']} preemptions, victims {r['victims']}")
        require(r["streams"] == twins, f"qos {name}: a batch stream differs from its twin")
        require(len(r["chat"]) == 32, f"qos {name}: the interactive chat did not complete")
        require(d["replayed_tokens_total"] == d["preempted_tokens_total"] > 0,
                f"qos {name}: replayed {d['replayed_tokens_total']} != "
                f"preempted {d['preempted_tokens_total']}")
        if eng is paged:
            with eng._cond:
                claims = list(eng._page_claims)
            require(m["kv_pages_allocated"] + m["kv_pages_free"] == eng.kv_pool_pages
                    and not any(claims), f"qos paged: pages leaked ({m}, claims {claims})")
        if eng is zeng:
            require(d["admission_dispatches_total"] == 0, "qos zero_drain: a single-shot ran")
        else:
            # The 4 streams, the chat and the victim's re-admission.
            require(d["admission_dispatches_total"] == 6,
                    f"qos {name}: {d['admission_dispatches_total']} single-shot admissions "
                    "in the drill, want 6 (the victim's re-admission included)")
        out[name] = {"preemptions": d["preemptions_total"],
                     "preempted_tokens": d["preempted_tokens_total"],
                     "replayed_tokens": d["replayed_tokens_total"],
                     "victim": r["victims"][0], "streams_equal_twins": True,
                     "interactive_ttft_s": r["chat_ttft_s"],
                     "single_shot_admissions": d["admission_dispatches_total"],
                     "launches": launches}
    paged.shutdown()
    zeng.shutdown()
    out["seconds"] = round(time.perf_counter() - t0, 3)
    return out


def phase_scheduler(torch, cpu: bool, tiny: bool, device_info: dict) -> dict:
    """The JAX engine's default scheduler on llama-3-8b at full width, cut
    to 8 layers to keep the script inside its time (bf16, seed 0): engines
    built one after another over ONE weight set, each with its own 4-slot
    cache.

    (a) ring: three greedy streams of 128 tokens at decode_pipeline=2, then
        at 1 — tokens equal (required), per-stream tok/s, overlapped chunks,
        each stream's time to its first decode chunk's tokens;
    (b) a ≈ 6 000-token prompt admitted beside a live stream, at the default
        512-token segments and at prefill_chunk=0: the live stream's longest
        gap between tokens, the long request's TTFT, the segment count
        (= ceil(n / 512), required);
    (c) a two-turn chat through the app: turn 2 re-sends ≈ 2 500 tokens of
        turn 1; a prefix hit saving exactly the reuse rounded down to 512
        (required), TTFT with and without prefix_cache, text equality
        reported;
    (d) zero-drain staging: (b)'s long admission beside a live stream on
        zero_drain=1 engines against drain-based twins, at the defaults and
        at decode_pipeline=4 × decode_loop=4 — tokens equal, stall 0,
        overlap > 0, the device memory grown by exactly the reckoned
        staging cache, K1 0 and K2 exact (required); at the defaults a
        staged admission's TTFT and the live gap alone and beside a
        64-input embedding forward (tokens unchanged, K1 = layers × the
        forward's sub-batches); then two streams on an int8-KV zero-drain
        engine against its twin (K2q8);
    (e) QoS preemption: four batch streams fill a qos=1 engine, an
        interactive chat parks exactly one, which resumes token for token
        (required, on dense, paged and zero-drain engines, with K1 = layers ×
        single-shot admissions); the chat's TTFT against a qos=0 engine;
    plus the device time of one segment (every layer) at histories 512 to 8192
    (the plain attention inside it), and launch counts of the three kernels
    over the phase."""
    from quorum_tpu_torch.backends.cuda_backend import CudaBackend
    from quorum_tpu_torch.config import Config
    from quorum_tpu_torch.engine.engine import InferenceEngine, prefill_bucket
    from quorum_tpu_torch.models.init import init_params
    from quorum_tpu_torch.models.model_config import resolve_spec
    from quorum_tpu_torch.models.transformer import init_cache, prefill_segment
    from quorum_tpu_torch.ops.flash_attention import flash_prefill_attention
    from quorum_tpu_torch.ops.flash_decode import flash_decode_attention, ticket_counters
    from quorum_tpu_torch.ops.flash_decode_q8 import flash_decode_q8_attention
    from quorum_tpu_torch.ops.sampling import SamplerConfig
    from quorum_tpu_torch.server.app import create_app

    model = "llama-tiny" if tiny else "llama-3-8b"
    dev = "cpu" if cpu else "cuda"
    # llama-tiny's 128-token window cannot hold the long prompts.
    spec = resolve_spec(model, {"max_seq": "2048"} if tiny else {"n_layers": "8"})
    ring_n, long_n, chat_bytes = (32, 1500, 600) if tiny else (128, 6000, 2500)
    _require_card_empty(torch, cpu, "scheduler")
    if not cpu:
        torch.cuda.reset_peak_memory_stats()
    t_build = time.perf_counter()
    params = init_params(spec, 0, dev)
    gen = torch.Generator().manual_seed(7)
    greedy = SamplerConfig(temperature=0.0)

    def prompt(n):
        return torch.randint(3, spec.vocab_size, (n,), generator=gen).tolist()

    engines = []

    def engine(**knobs):
        eng = InferenceEngine(spec, device=dev, params=params, **knobs)
        engines.append(eng)
        return eng

    def built(**knobs):
        """An engine and the device bytes its construction allocated."""
        if not cpu:
            torch.cuda.synchronize()
        m0 = 0 if cpu else torch.cuda.memory_allocated()
        eng = engine(**knobs)
        if not cpu:
            torch.cuda.synchronize()
        return eng, (0 if cpu else torch.cuda.memory_allocated() - m0)

    main, main_bytes = built()  # the default knobs
    chunk = main.prefill_chunk
    require((main.decode_pipeline, main.prefix_cache) == (2, True) and chunk == min(512, spec.max_seq),
            f"default knobs: depth {main.decode_pipeline}, chunk {chunk}, reuse {main.prefix_cache}")
    if not cpu:
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t_build
    # Every launch counter to 0 just before the main path, read just after.
    flash_prefill_attention.launches = 0
    flash_prefill_attention.launches_by_route.update(wgmma=0, fma=0)
    flash_decode_attention.launches = 0
    flash_decode_q8_attention.launches = 0

    # (a) the ring, K=2 then K=1, on the same prompts
    ring_prompts = [prompt(300) for _ in range(3)]
    ring = {}
    for k, eng in ((2, main), (1, engine(decode_pipeline=1))):
        m0 = eng.metrics()
        t0 = time.perf_counter()
        out = _stream_all(eng, [eng.submit(p, max_new_tokens=ring_n, sampler=greedy)
                                for p in ring_prompts])
        wall = time.perf_counter() - t0
        m1 = eng.metrics()
        # Token 1 comes from the single-shot admission, token 2 from the
        # first decode chunk: at depth 2 the host issues a second chunk
        # before it reads the first.
        ring[k] = {"tokens": [t for t, _ in out], "wall_s": wall,
                   "first_chunk_s": [ts[1] - t0 for _, ts in out],
                   "tok_per_s_per_stream": [(len(t) - 1) / (ts[-1] - ts[0]) for t, ts in out],
                   "decode_chunks": m1["decode_chunks_total"] - m0["decode_chunks_total"],
                   "overlapped_chunks": (m1["overlapped_chunks_total"]
                                         - m0["overlapped_chunks_total"])}
        require(all(len(t) == ring_n for t in ring[k]["tokens"]),
                f"ring K={k}: a stream ended early")
    require(ring[2]["tokens"] == ring[1]["tokens"],
            "ring: greedy tokens at decode_pipeline=2 differ from decode_pipeline=1")
    require(ring[2]["overlapped_chunks"] > 0 and ring[1]["overlapped_chunks"] == 0,
            f"ring: overlapped chunks K=2 {ring[2]['overlapped_chunks']}, "
            f"K=1 {ring[1]['overlapped_chunks']}")
    engines[-1].shutdown()

    # (b) a long admission beside a live stream, chunked then single-shot
    # The live prompt is longer than a segment, so a zero-drain engine and
    # this drain-based one admit it alike (chunked): leg (d) compares them.
    long_prompt, live_prompt = prompt(long_n), prompt(chunk + 88)
    legs = {"chunked": _long_beside_live(main, live_prompt, long_prompt, greedy)}
    whole = engine(prefill_chunk=0)
    legs["single_shot"] = _long_beside_live(whole, prompt(300), long_prompt, greedy)
    whole.shutdown()
    require(legs["chunked"]["prefill_segments"] == -(-long_n // chunk),
            f"chunked leg: {legs['chunked']['prefill_segments']} segments for {long_n} tokens")
    require(legs["single_shot"]["prefill_segments"] == 0
            and legs["single_shot"]["single_shot_admissions"] == 1,
            f"single-shot leg: {legs['single_shot']}")
    require(legs["chunked"]["live_tokens_during_long"] > 0,
            "chunked leg: the live stream emitted nothing while the long prompt was admitted")

    # (c) a two-turn chat through the app, with and without prefix reuse
    cfg = Config(raw={"primary_backends": [{"name": "llama", "url": f"cuda://{model}"}],
                      "settings": {"timeout": SERVE_TIMEOUT_S}})
    backend = CudaBackend("llama", main, model_id=model)
    app = create_app(cfg, llama=backend)
    tok = backend.tokenizer

    def chat(the_app, messages):
        body = {"model": model, "messages": messages, "max_tokens": 32, "temperature": 0,
                "stream": True, "stream_options": {"include_usage": True}}
        return _check_response(asyncio.run(asyncio.wait_for(_call(the_app, body),
                                                            SERVE_TIMEOUT_S)), body, tok, 32)

    turn1 = [{"role": "user", "content": _prompt(chat_bytes, 50)}]
    first = chat(app, turn1)
    turn2 = turn1 + [{"role": "assistant", "content": first["text"]},
                     {"role": "user", "content": _prompt(200, 51)}]
    p1, p2 = (tok.encode(tok.render_chat(m)) for m in (turn1, turn2))
    lcp = next((i for i, (a, b) in enumerate(zip(p1, p2)) if a != b), min(len(p1), len(p2)))
    want_saved = min(lcp, len(p2) - 1) // chunk * chunk
    m0 = main.metrics()
    again = chat(app, turn2)
    m1 = main.metrics()
    hits = m1["prefix_hits_total"] - m0["prefix_hits_total"]
    saved = m1["prefix_tokens_saved_total"] - m0["prefix_tokens_saved_total"]
    require(hits == 1 and saved == want_saved,
            f"chat: {hits} prefix hits saving {saved} tokens, want 1 saving {want_saved}")
    cold = engine(prefix_cache=False)
    cold_reply = chat(create_app(cfg, llama=CudaBackend("llama", cold, model_id=model)), turn2)
    require(cold.metrics()["prefix_hits_total"] == 0, "chat: prefix_cache=False reused")
    chat_info = {"turn1_prompt_tokens": len(p1), "turn2_prompt_tokens": len(p2),
                 "shared_prefix_tokens": lcp, "prefix_tokens_saved": saved,
                 "turn1_ttft_s": first["ttft_s"], "turn2_ttft_s_reuse": again["ttft_s"],
                 "turn2_ttft_s_no_reuse": cold_reply["ttft_s"],
                 "turn2_text_equal": again["text"] == cold_reply["text"]}
    cold.shutdown()

    # (d) zero-drain staging, (e) QoS preemption, on the same weights; a
    # live prompt longer than a segment admits chunked on both twins.
    t_legs = time.perf_counter()
    zero_drain, zeng = _zero_drain_legs(torch, cpu, spec, built, legs["chunked"], main_bytes,
                                        live_prompt, long_prompt, greedy, prompt)
    t_qos = time.perf_counter()
    qos = _qos_legs(torch, cpu, spec, built, prompt, 96 if tiny else 256, main, zeng)
    t_legs_end = time.perf_counter()
    if not cpu:
        torch.cuda.synchronize()
    launches = _launch_counts()
    k1_routes = dict(flash_prefill_attention.launches_by_route)
    counted = [e.metrics() for e in engines]
    single_shot = sum(m["admission_dispatches_total"] for m in counted)
    steps = sum(m["decode_steps_total"] for m in counted)
    k2_steps = sum(_k2_steps(m) for e, m in zip(engines, counted) if not e.kv_quant)
    q8_steps = sum(_k2_steps(m) for e, m in zip(engines, counted) if e.kv_quant)
    segments = sum(m["prefill_segments_total"] for m in counted)
    require(all(int(c.abs().sum()) == 0 for c in ticket_counters()),
            "K2 ticket counters are not back at 0 after the scheduler phase")
    if not cpu:
        n_layers = spec.n_layers
        k1_calls = single_shot + zero_drain["forwards"]
        require(launches["flash_prefill"] == n_layers * k1_calls
                and k1_routes["wgmma"] == n_layers * k1_calls,
                f"K1 launches {launches['flash_prefill']} ({k1_routes}) != {n_layers} x "
                f"({single_shot} single-shot dispatches + {zero_drain['forwards']} forwards)")
        require(launches["flash_decode"] == n_layers * k2_steps,
                f"K2 launches {launches['flash_decode']} != {n_layers} x {k2_steps}")
        require(launches["flash_decode_q8"] == n_layers * q8_steps,
                f"K2q8 launches {launches['flash_decode_q8']} != {n_layers} x {q8_steps}")
        require(launches["flash_prefill"] > 0 and launches["flash_decode"] > 0
                and launches["flash_decode_q8"] > 0,
                "scheduler: a kernel of the path was never launched")
    peak = None if cpu else torch.cuda.max_memory_allocated()

    # One segment through every layer at each history bucket, on a scratch cache row
    # (its time is the plain attention's case for a segment kernel).
    seg_ms = {}
    ck, cv = init_cache(spec, 1, device=dev)
    seg_tokens = torch.tensor([prompt(chunk)], device=dev)
    for history in sorted({min(h, spec.max_seq) for h in (512, 2048, 4096, 8192)}):
        off = history - chunk

        def one(off=off, history=history):
            prefill_segment(params, spec, seg_tokens, [off], ck, cv, rows=[0], history=history)

        seg_ms[history] = make_timer(torch, cpu)(one, iters=3, warmup=1)
    del ck, cv
    seg_peak = None if cpu else torch.cuda.max_memory_allocated()
    for e in engines:
        e.shutdown()
    del params, engines, main, backend, app
    info = {"model": model, "layers": spec.n_layers, "dtype": spec.dtype, "slots": 4,
            "build_s": round(build_s, 3), "prefill_chunk": chunk,
            "ring": {k: {key: v for key, v in r.items() if key != "tokens"}
                     for k, r in ring.items()},
            "ring_tokens_equal": True,
            "long_admission": {k: _public(v) for k, v in legs.items()}, "chat": chat_info,
            "zero_drain": zero_drain, "qos": qos,
            "leg_d_s": round(t_qos - t_legs, 3), "leg_e_s": round(t_legs_end - t_qos, 3),
            "single_shot_dispatches": single_shot, "prefill_segments": segments,
            "decode_steps": steps, "graph_warmup_steps": k2_steps + q8_steps - steps,
            "launches": launches, "k1_launches_by_route": k1_routes,
            "segment_ms_by_history": seg_ms,
            "peak_mem_gb": None if cpu else round(peak / 1e9, 3),
            "peak_mem_gb_with_segment_timing": None if cpu else round(seg_peak / 1e9, 3),
            "measured_on": f"{device_info['name']} ({device_info['power_limit']})"}
    emit("scheduler", **info)
    return info


def phase_decode_graphs(torch, cpu: bool, tiny: bool, device_info: dict) -> dict:
    """Every decode dispatch as one CUDA-graph replay, on the full 32-layer
    llama-3-8b (bf16, seed 0; one weight set, engines built one after
    another, 4 slots each, the default ring depth 2):

    (a) 3 greedy streams × 128 tokens from 300-token prompts at decode_loop=1
        and at decode_loop=4, each run twice on its engine (the first run
        captures the graphs, the second is steady): tokens equal (required);
        per-stream tok/s;
        per dispatch its device ms (CUDA events on the engine's stream around
        it: mask copy, noise draws, replay, copy to the host) and the host
        seconds from its issue until its tokens are read; captures, their
        seconds and the graphs' pool bytes; chunks a row entered
        (``decode_loop_chunks_total``) against chunks dispatched; K2
        launches = 32 × (decode + warm-up steps), required;
    (b) one eager 32-layer ``decode_chunk`` of 16 steps against two replays
        of the 8-step graph from the same prefilled state (3 rows of 300,
        1 200 and 41 tokens, one dead): tokens equal (required), the wall of
        each."""
    from quorum_tpu_torch.engine.engine import InferenceEngine, prefill_bucket
    from quorum_tpu_torch.models.init import init_params
    from quorum_tpu_torch.models.model_config import resolve_spec
    from quorum_tpu_torch.ops.flash_attention import flash_prefill_attention
    from quorum_tpu_torch.ops.flash_decode import flash_decode_attention, ticket_counters
    from quorum_tpu_torch.ops.sampling import SamplerConfig

    model = "llama-tiny" if tiny else "llama-3-8b"
    dev = "cpu" if cpu else "cuda"
    spec = resolve_spec(model, {"max_seq": "2048"} if tiny else {})
    n_tokens = 32 if tiny else 128
    _require_card_empty(torch, cpu, "decode_graphs")
    if not cpu:
        torch.cuda.reset_peak_memory_stats()
    params = init_params(spec, 0, dev)
    gen = torch.Generator().manual_seed(9)
    greedy = SamplerConfig(temperature=0.0)
    prompts = [torch.randint(3, spec.vocab_size, (300,), generator=gen).tolist()
               for _ in range(3)]
    card = f"{device_info['name']} ({device_info['power_limit']})"
    flash_prefill_attention.launches = 0
    flash_prefill_attention.launches_by_route.update(wgmma=0, fma=0)
    flash_decode_attention.launches = 0

    legs, tokens, k2_steps = {}, {}, 0
    for loop in (1, 4):
        eng = InferenceEngine(spec, device=dev, params=params, decode_loop=loop)
        dispatched = []
        dispatch, emit_chunk = eng._dispatch_chunk, eng._emit_chunk

        def timed_dispatch(active, dispatch=dispatch, dispatched=dispatched):
            marks = None
            if not cpu:
                marks = (torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True))
                marks[0].record()
            t0 = time.perf_counter()
            c = dispatch(active)
            if marks:
                marks[1].record()
            dispatched.append([c, marks, t0, None])
            return c

        def timed_emit(c, emit_chunk=emit_chunk, dispatched=dispatched):
            c.wait()
            for rec in dispatched:
                if rec[0] is c:
                    rec[3] = time.perf_counter()
            return emit_chunk(c)

        eng._dispatch_chunk, eng._emit_chunk = timed_dispatch, timed_emit
        # The same streams twice: the first run captures the engine's graphs
        # (the JAX engine compiles at first use too), the second is steady.
        for run in ("first", "steady"):
            dispatched.clear()
            m0 = eng.metrics()
            t0 = time.perf_counter()
            out = _stream_all(eng, [eng.submit(p, max_new_tokens=n_tokens, sampler=greedy)
                                    for p in prompts])
            wall = time.perf_counter() - t0
            if not cpu:
                torch.cuda.synchronize()
            m1 = eng.metrics()
            tokens[loop, run] = [t for t, _ in out]
            require(all(len(t) == n_tokens for t in tokens[loop, run]),
                    f"decode_graphs loop={loop}: a stream ended early")
            k2_steps += _k2_steps(m1) - _k2_steps(m0)
            steps = m1["decode_steps_total"] - m0["decode_steps_total"]
            leg = legs[f"loop_{loop}_{run}"] = {
                "wall_s": wall,
                "tok_per_s_per_stream": [(len(t) - 1) / (ts[-1] - ts[0]) for t, ts in out],
                "dispatches": m1["decode_chunks_total"] - m0["decode_chunks_total"],
                "chunks_dispatched": steps // eng.decode_chunk,
                "chunks_entered": (m1["decode_loop_chunks_total"]
                                   - m0["decode_loop_chunks_total"]),
                "decode_steps": steps,
                "chunks_per_dispatch": [c.n_chunks for c, *_ in dispatched],
                "dispatch_device_ms": [a.elapsed_time(b) for _, (a, b), *_ in dispatched]
                if not cpu else None,
                "dispatch_to_tokens_read_s": [t1 - t0 for _, _, t0, t1 in dispatched
                                              if t1 is not None],
                "captures": m1["decode_graph_captures_total"] - m0["decode_graph_captures_total"],
                "capture_s": round(m1["decode_graph_capture_seconds_total"]
                                   - m0["decode_graph_capture_seconds_total"], 6),
                "replays": m1["decode_graph_replays_total"] - m0["decode_graph_replays_total"],
                "graph_pool_bytes": m1["decode_graph_pool_bytes"],
                "warmup_steps": (m1["decode_graph_warmup_steps_total"]
                                 - m0["decode_graph_warmup_steps_total"]),
                "overlapped": m1["overlapped_chunks_total"] - m0["overlapped_chunks_total"]}
            if not cpu:
                require(leg["replays"] == leg["dispatches"],
                        f"decode_graphs loop={loop}: {leg['replays']} replays for "
                        f"{leg['dispatches']} dispatches")
        eng.shutdown()
    require(len({tuple(map(tuple, t)) for t in tokens.values()}) == 1,
            "decode_graphs: tokens differ between decode_loop=1 and 4 or between runs")
    require(legs["loop_4_steady"]["dispatches"] < legs["loop_1_steady"]["dispatches"],
            f"decode_graphs: decode_loop=4 took {legs['loop_4_steady']['dispatches']} "
            f"dispatches, decode_loop=1 {legs['loop_1_steady']['dispatches']}")
    launches = {"flash_prefill": flash_prefill_attention.launches,
                "flash_decode": flash_decode_attention.launches}
    if not cpu:
        require(launches["flash_decode"] == spec.n_layers * k2_steps,
                f"K2 launches {launches['flash_decode']} != {spec.n_layers} x {k2_steps}")
        require(launches["flash_prefill"] > 0 and launches["flash_decode"] > 0,
                "decode_graphs: a kernel of the path was never launched")
    tickets_zero = all(int(c.abs().sum()) == 0 for c in ticket_counters())
    require(tickets_zero, "K2 ticket counters are not back at 0 after the decode_graphs phase")

    # (b) eager 16 steps against two replays of the 8-step graph
    lens = [300, 1200, 0, 41]
    ck, cv, state, eos = _prefilled_rows(torch, spec, params, dev, gen, lens,
                                         prefill_bucket(max(lens), spec.max_seq))
    state["budget"] = torch.tensor([64, 64, 0, 64], dtype=torch.int32, device=dev)
    state["live"] = state["budget"] > 0

    def argmax_sample(logits, live, k):
        return torch.argmax(logits, dim=-1), k + 1, ()

    eager_state = {k: v.clone() for k, v in state.items()}
    ek, ev = ck.clone(), cv.clone()
    t0 = time.perf_counter()
    want = _decode_fn(torch, spec, params, 16, 1, eos, argmax_sample)(eager_state, ek, ev)
    if not cpu:
        torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    del ek, ev
    replay, graphs = _replayer(torch, dev, cpu)
    program = _decode_fn(torch, spec, params, 8, 1, eos, argmax_sample)
    warm = _decode_fn(torch, spec, params, 1, 1, eos, argmax_sample)
    got, replay_s = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        got.append(replay((8, 1), lambda: program(state, ck, cv),
                          lambda: warm({k: v.clone() for k, v in state.items()}, ck.clone(),
                                       cv.clone())).clone())
        if not cpu:
            torch.cuda.synchronize()
        replay_s.append(time.perf_counter() - t0)
    got_tokens = torch.cat([g[0, :, :8] for g in got], dim=1)
    live_rows = [i for i, n in enumerate(lens) if n]
    equal = got_tokens[live_rows].tolist() == want[0, live_rows, :16].tolist()
    require(equal, "decode_graphs: two 8-step replays differ from one eager 16-step chunk")
    peak = None if cpu else torch.cuda.max_memory_allocated()
    del params, ck, cv, state, eager_state
    info = {"model": model, "layers": spec.n_layers, "dtype": spec.dtype, "slots": 4,
            "tokens_per_stream": n_tokens, "legs": legs, "tokens_equal": True,
            "launches": launches, "graph_warmup_steps": sum(
                leg["warmup_steps"] for leg in legs.values()),
            "ticket_counters_zero": tickets_zero,
            "eager_vs_replay": {"steps": 16, "eager_s": eager_s,
                                "replay_s_first_with_capture": replay_s[0],
                                "replay_s_second": replay_s[1],
                                "capture_s": None if cpu else graphs.capture_seconds,
                                "tokens_equal": equal},
            "peak_mem_gb": None if cpu else round(peak / 1e9, 3), "measured_on": card}
    emit("decode_graphs", **info)
    return info


def _timed_dispatches(torch, eng, cpu: bool) -> list:
    """Wrap ``eng._dispatch_chunk`` so each dispatch records CUDA events on
    the engine's stream around it (the decode_graphs phase's method); returns
    the list the records go to: [chunk, (start, end) events or None]."""
    dispatched = []
    dispatch = eng._dispatch_chunk

    def timed(active):
        marks = None
        if not cpu:
            marks = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            marks[0].record()
        c = dispatch(active)
        if marks:
            marks[1].record()
        dispatched.append([c, marks])
        return c

    eng._dispatch_chunk = timed
    return dispatched


def _device_ms(torch, cpu: bool, recs) -> list[float] | None:
    if cpu:
        return None
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for _, (a, b) in recs]


def phase_knobs(torch, cpu: bool, tiny: bool, device_info: dict, graph_ms) -> dict:
    """The OpenAI request knobs and engine deadlines on the full 32-layer
    llama-3-8b (bf16, seed 0: the weight set the scheduler and decode_graphs
    phases use), one 4-slot engine at decode_loop=1, then one at 4, each
    behind the app with one cuda:// backend. On each engine:

    - through the engine's ``submit``: greedy with ``logit_bias {t: +100}``
      emits only t for 32 tokens; ``{t: -100}`` on the unbiased stream's
      first token never emits it; one stream's tok/s plain and with
      logprobs + penalties (second runs: the first captures);
    - through the app: greedy ``logprobs`` + ``top_logprobs=5`` (every
      entry's logprob equals its top_logprobs[0] within 1e-3, is <= 0, and
      its list is sorted); ``n=3`` sampled twice with one seed (the same
      three texts twice, three different texts); a 0.5 s ``timeout`` on a
      request for 2048 tokens, twice (cold: a clamped dispatch may capture
      its key first; warm, once the 1- and 2-chunk keys are captured: →
      504 within 0.5 + 0.3 s; both times reported) while a greedy stream
      started beside it once it is in the engine keeps its solo run's
      tokens; a request
      queued behind four busy slots past its 0.3 s timeout → 503 (the time
      to the 503 reported: it includes the dispatches in flight when it
      arrived);
    - device ms per dispatch (CUDA events on the engine's stream) of 3
      greedy streams with no knob set and with logprobs + penalties; the
      captures of the logprob keys and their seconds; clamped dispatches
      (``deadline_clamps_total``, > 0 required at decode_loop=4).

    Then the adjustment pass alone on [4, V] f32 logits (bias + penalties +
    sampling + the counts scatter, and with the logprob record), device ms
    by CUDA graph. K1 and K2 launches over the phase are exact."""
    import threading

    from quorum_tpu_torch.backends.cuda_backend import CudaBackend
    from quorum_tpu_torch.config import Config
    from quorum_tpu_torch.engine.engine import InferenceEngine
    from quorum_tpu_torch.models.init import init_params
    from quorum_tpu_torch.models.model_config import resolve_spec
    from quorum_tpu_torch.ops.flash_attention import flash_prefill_attention
    from quorum_tpu_torch.ops.flash_decode import flash_decode_attention, ticket_counters
    from quorum_tpu_torch.ops.sampling import (SamplerConfig, adjust_logits, sample_token_rows,
                                               token_logprobs)
    from quorum_tpu_torch.server.app import create_app

    model = "llama-tiny" if tiny else "llama-3-8b"
    dev = "cpu" if cpu else "cuda"
    spec = resolve_spec(model, {"max_seq": "2048"} if tiny else {})
    n_tok, long_budget = 32, (1024 if tiny else 2048)
    card = f"{device_info['name']} ({device_info['power_limit']})"
    _require_card_empty(torch, cpu, "knobs")
    params = init_params(spec, 0, dev)
    gen = torch.Generator().manual_seed(13)
    greedy = SamplerConfig(temperature=0.0)

    def prompt(n):
        return torch.randint(3, spec.vocab_size, (n,), generator=gen).tolist()

    def bias(tok, val):
        row = torch.zeros(spec.vocab_size)
        row[tok] = val
        return row

    def run(eng, p, n=n_tok, **knobs):
        (toks, ts), = _stream_all(eng, [eng.submit(p, max_new_tokens=n, sampler=greedy,
                                                   **knobs)])
        return toks, (len(toks) - 1) / (ts[-1] - ts[0]) if len(toks) > 1 else None

    cfg = Config(raw={"primary_backends": [{"name": "knobs", "url": f"cuda://{model}"}],
                      "settings": {"timeout": SERVE_TIMEOUT_S}})
    msgs = [{"role": "user", "content": _prompt(300, 70)}]
    flash_prefill_attention.launches = 0
    flash_prefill_attention.launches_by_route.update(wgmma=0, fma=0)
    flash_decode_attention.launches = 0
    legs, counted = {}, []
    for loop in (1, 4):
        eng = InferenceEngine(spec, device=dev, params=params, decode_loop=loop)
        app = create_app(cfg, knobs=CudaBackend("knobs", eng, model_id=model))
        leg = legs[f"decode_loop_{loop}"] = {}
        p = prompt(300)
        # (a) tok/s plain and with logprobs + penalties; the first run of
        # each captures its keys.
        m0 = eng.metrics()
        plain, _ = run(eng, p)
        m1 = eng.metrics()
        lp_knobs = dict(logprobs=5, presence_penalty=0.5, frequency_penalty=0.5)
        run(eng, p, **lp_knobs)
        m2 = eng.metrics()
        leg["capture_s_plain_keys"] = round(m1["decode_graph_capture_seconds_total"]
                                            - m0["decode_graph_capture_seconds_total"], 6)
        leg["captures_lp_keys"] = (m2["decode_graph_captures_total"]
                                   - m1["decode_graph_captures_total"])
        leg["capture_s_lp_keys"] = round(m2["decode_graph_capture_seconds_total"]
                                         - m1["decode_graph_capture_seconds_total"], 6)
        again, leg["tok_per_s_plain"] = run(eng, p)
        _, leg["tok_per_s_logprobs_penalties"] = run(eng, p, **lp_knobs)
        require(again == plain, f"knobs loop={loop}: a greedy stream changed between runs")
        # (b) logit_bias, through the engine's submit
        t = 3 + (plain[0] + spec.vocab_size // 2) % (spec.vocab_size - 3)  # not plain[0]
        forced, _ = run(eng, p, logit_bias=bias(t, 100.0))
        require(forced == [t] * n_tok, f"knobs loop={loop}: +100 bias on {t} gave {forced[:8]}")
        banned, _ = run(eng, p, logit_bias=bias(plain[0], -100.0))
        require(plain[0] not in banned and len(banned) == n_tok,
                f"knobs loop={loop}: -100 bias on {plain[0]} still emitted it")
        # (c) logprobs through the app
        body = {"model": model, "messages": msgs, "max_tokens": n_tok, "temperature": 0,
                "logprobs": True, "top_logprobs": 5}
        resp = asyncio.run(asyncio.wait_for(_call(app, body), SERVE_TIMEOUT_S))
        require(resp["status"] == 200, f"knobs logprobs: {resp['status']} {resp['data'][:300]!r}")
        entries = json.loads(resp["data"])["choices"][0]["logprobs"]["content"]
        lp_err = max(abs(e["logprob"] - e["top_logprobs"][0]["logprob"]) for e in entries)
        require(len(entries) >= 1 and lp_err <= 1e-3
                and all(e["logprob"] <= 0 and len(e["top_logprobs"]) == 5 for e in entries)
                and all(all(a["logprob"] >= b["logprob"] for a, b in
                            zip(e["top_logprobs"], e["top_logprobs"][1:])) for e in entries),
                f"knobs loop={loop}: logprob entries inconsistent (max err {lp_err})")
        leg["logprob_entries"], leg["logprob_top1_max_err"] = len(entries), lp_err
        # (d) n=3 sampled, twice with one seed
        body = {"model": model, "messages": msgs, "max_tokens": n_tok, "temperature": 0.9,
                "seed": 17, "n": 3}
        texts = []
        for _ in range(2):
            resp = asyncio.run(asyncio.wait_for(_call(app, body), SERVE_TIMEOUT_S))
            require(resp["status"] == 200, f"knobs n=3: {resp['status']}")
            js = json.loads(resp["data"])
            texts.append([c["message"]["content"] for c in js["choices"]])
            require(js["usage"]["completion_tokens"] == 3 * n_tok, f"knobs n=3: {js['usage']}")
        require(texts[0] == texts[1] and len(set(texts[0])) == 3,
                f"knobs loop={loop}: n=3 texts repeat {texts[0] == texts[1]}, "
                f"distinct {len(set(texts[0]))}")
        # (e) a 0.5 s timeout on a request for 2048 tokens; a live stream
        # starts beside it once it is in the engine (a request that arrives
        # behind two dispatches of C chunks in flight waits for them before
        # its admission: the queue-shed leg below reads that wait). Twice:
        # cold, where a clamped dispatch may capture its key first (the
        # engine's deadline watch answers the 504 during the capture), then
        # warm, after 9- and 17-token requests have captured the 1- and
        # 2-chunk keys a clamped dispatch can take (no capture: asserted).
        # Both 504s are the engine's, within 0.3 s of the deadline.
        side = prompt(200)
        solo, _ = run(eng, side, n=64)
        deaths = eng.metrics()["deadline_exceeded_total"]
        for run_name in ("cold", "warm"):
            if run_name == "warm":
                for n in (9, 17):  # remaining budgets of 1 and 2 chunks
                    run(eng, p, n=n)
            m_r0, box = eng.metrics(), {}

            def timed(box=box):
                body = {"model": model, "messages": msgs, "max_tokens": long_budget,
                        "timeout": 0.5}
                t0 = time.perf_counter()
                box["resp"] = asyncio.run(asyncio.wait_for(_call(app, body),
                                                           SERVE_TIMEOUT_S))
                box["waited"] = time.perf_counter() - t0

            recs = _timed_dispatches(torch, eng, cpu)
            th = threading.Thread(target=timed, daemon=True)
            t_start = time.perf_counter()
            th.start()
            while (eng.metrics()["requests_total"] == m_r0["requests_total"]
                   and th.is_alive()):
                time.sleep(0.001)
            live_toks, _ = run(eng, side, n=64)
            th.join(timeout=2 * SERVE_TIMEOUT_S)
            del eng._dispatch_chunk  # back to the class's method
            require(not th.is_alive(), "knobs timeout: the timed request never returned")
            resp, waited = box["resp"], box["waited"]
            m_r1 = eng.metrics()
            # Each dispatch of the run: its chunks and when it was issued.
            # The 504 is the engine's, also while a first capture holds the
            # scheduler (its deadline watch answers it).
            message = json.loads(resp["data"] or b"{}").get("error", {}).get("message", "")
            leg[f"timeout_{run_name}"] = {
                "engine_deadline": "deadline exceeded during" in message,
                "status": resp["status"], "after_s": waited, "deadline_to_504_s": waited - 0.5,
                "captures": (m_r1["decode_graph_captures_total"]
                             - m_r0["decode_graph_captures_total"]),
                "clamped_dispatches": (m_r1["deadline_clamps_total"]
                                       - m_r0["deadline_clamps_total"]),
                "dispatches": [(c.n_chunks, round(c.t0 - t_start, 4)) for c, _ in recs]}
            emit("knobs", decode_loop=loop, timeout_run=run_name, **leg[f"timeout_{run_name}"])
            require(resp["status"] == 504, f"knobs timeout: status {resp['status']} "
                    f"{resp['data'][:200]!r}")
            require(live_toks == solo, f"knobs loop={loop}: the live stream changed beside "
                    "the timed-out request")
            require(waited <= 0.5 + 0.3, f"knobs loop={loop}: the {run_name} 504 came "
                    f"{waited:.3f} s after a 0.5 s timeout")
        require(leg["timeout_warm"]["captures"] == 0, f"knobs loop={loop}: the warm timeout "
                "run captured a graph")
        # (f) a request queued behind four busy slots past its deadline → 503
        blockers = [eng.submit(prompt(64), max_new_tokens=long_budget, sampler=greedy)
                    for _ in range(eng.n_slots)]
        body = {"model": model, "messages": msgs, "max_tokens": 8, "timeout": 0.3}
        t0 = time.perf_counter()
        resp = asyncio.run(asyncio.wait_for(_call(app, body), SERVE_TIMEOUT_S))
        leg["queue_shed_after_s"] = time.perf_counter() - t0
        for b in blockers:
            b.cancel.set()
        require(resp["status"] == 503 and resp["headers"].get("retry-after"),
                f"knobs queue shed: status {resp['status']} {resp['headers']}")
        while eng.metrics()["busy_slots"]:
            time.sleep(0.01)
        # (g) device ms per dispatch: 3 greedy streams, no knob, then with
        # logprobs + penalties
        prompts3 = [prompt(300) for _ in range(3)]
        for name, knobs in (("plain", {}), ("logprobs_penalties", lp_knobs)):
            recs = _timed_dispatches(torch, eng, cpu)
            _stream_all(eng, [eng.submit(q, max_new_tokens=64, sampler=greedy, **knobs)
                              for q in prompts3])
            ms = _device_ms(torch, cpu, recs)
            leg[f"dispatch_device_ms_{name}"] = ms
            leg[f"chunks_per_dispatch_{name}"] = [c.n_chunks for c, _ in recs]
            del eng._dispatch_chunk  # back to the class's method
        m = eng.metrics()
        leg["deadline_exceeded_total"] = m["deadline_exceeded_total"]
        leg["deadline_clamps_total"] = m["deadline_clamps_total"]
        leg["replays"], leg["dispatches"] = m["decode_graph_replays_total"], \
            m["decode_chunks_total"]
        require(m["deadline_exceeded_total"] == deaths + 3,
                f"knobs loop={loop}: deadline_exceeded_total {m['deadline_exceeded_total']}")
        if not cpu:
            require(m["decode_graph_replays_total"] == m["decode_chunks_total"],
                    f"knobs loop={loop}: {m['decode_graph_replays_total']} replays for "
                    f"{m['decode_chunks_total']} dispatches")
        if loop > 1:
            require(m["deadline_clamps_total"] > 0, "knobs: no dispatch was deadline-clamped "
                    "at decode_loop=4")
        counted.append(m)
        eng.shutdown()
        del app
    if not cpu:
        torch.cuda.synchronize()
    launches = {"flash_prefill": flash_prefill_attention.launches,
                "flash_decode": flash_decode_attention.launches}
    single_shot = sum(m["admission_dispatches_total"] for m in counted)
    k2_steps = sum(_k2_steps(m) for m in counted)
    require(all(int(c.abs().sum()) == 0 for c in ticket_counters()),
            "K2 ticket counters are not back at 0 after the knobs phase")
    if not cpu:
        require(launches["flash_prefill"] == spec.n_layers * single_shot,
                f"K1 launches {launches['flash_prefill']} != {spec.n_layers} x {single_shot}")
        require(launches["flash_decode"] == spec.n_layers * k2_steps,
                f"K2 launches {launches['flash_decode']} != {spec.n_layers} x {k2_steps}")
    del params
    # The adjustment pass alone at the decode batch (4 rows, full vocabulary).
    rows, vocab = 4, spec.vocab_size
    g = torch.Generator().manual_seed(3)
    logits = torch.randn((rows, vocab), generator=g).to(dev)
    bias_t = torch.zeros((rows, vocab), device=dev)
    counts = torch.randint(0, 3, (rows, vocab), generator=g, dtype=torch.int32).to(dev)
    pp = torch.full((rows,), 0.5, device=dev)
    temp, topp = torch.zeros(rows, device=dev), torch.ones(rows, device=dev)
    topk, noise = torch.zeros(rows, dtype=torch.int32, device=dev), torch.zeros_like(logits)
    live = torch.ones(rows, dtype=torch.bool, device=dev)

    def adjust(lp: bool):
        adj = adjust_logits(logits, bias_t, counts, pp, pp)
        nxt = sample_token_rows(adj, temp, topp, topk, noise, restrict=False)
        out = counts.scatter_add(1, nxt[:, None], live[:, None].to(counts.dtype))
        return token_logprobs(adj, nxt) if lp else out

    def plain_sample():
        return sample_token_rows(logits, temp, topp, topk, noise, restrict=False)

    pass_ms = {"sample_only_ms": graph_ms([plain_sample]),
               "adjust_sample_scatter_ms": graph_ms([lambda: adjust(False)]),
               "adjust_sample_scatter_logprobs_ms": graph_ms([lambda: adjust(True)])}
    info = {"model": model, "layers": spec.n_layers, "dtype": spec.dtype, "slots": 4,
            "legs": legs, "launches": launches, "single_shot_dispatches": single_shot,
            "k2_steps": k2_steps, "adjust_pass_rows_4": pass_ms, "measured_on": card}
    emit("knobs", **info)
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
    single-engine ones, so fragments would not do). cuBLAS keeps a
    workspace per (handle, stream) — every engine thread and every side
    stream of a timing adds one — which is the library's, not a leftover
    of the phase: they are released first."""
    gc.collect()
    if not cpu:
        clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
        if clear is not None:
            clear()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        if held >= 1e9:
            live = sorted(((o.numel() * o.element_size(), tuple(o.shape), str(o.dtype))
                           for o in gc.get_objects()
                           if isinstance(o, torch.Tensor) and o.is_cuda), reverse=True)
            require(False, f"{what}: {held / 1e9:.3f} GB still allocated before the build; "
                           f"largest live tensors {live[:6]}")


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
    # K1 runs once per layer per single-shot dispatch (a coalesced member
    # group is one); prompts past the segment size prefill in segments.
    dispatches = [b["admission_dispatches_total"] - a["admission_dispatches_total"]
                  for a, b in zip(m0, m1)]
    segments = [b["prefill_segments_total"] - a["prefill_segments_total"] for a, b in zip(m0, m1)]
    steps = [b["decode_steps_total"] - a["decode_steps_total"] for a, b in zip(m0, m1)]
    k2_steps = sum(_k2_steps(b) - _k2_steps(a) for a, b in zip(m0, m1))
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
                "single-shot admission dispatches")
        require(k1_routes["wgmma"] == n_layers * sum(dispatches),
                f"K1 launches on the wgmma route {k1_routes} != {n_layers} x {sum(dispatches)}")
        require(launches["flash_decode"] == n_layers * k2_steps,
                f"K2 launches {launches['flash_decode']} != {n_layers} x {k2_steps}")
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
            "admissions_per_engine": admissions,
            "single_shot_dispatches_per_engine": dispatches,
            "prefill_segments_per_engine": segments,
            "prefix_tokens_saved_per_engine": [
                b["prefix_tokens_saved_total"] - a["prefix_tokens_saved_total"]
                for a, b in zip(m0, m1)],
            "decode_steps_per_engine": steps, "graph_warmup_steps": k2_steps - sum(steps),
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
    # Dedup is a single-shot route (as in the JAX engine): with the default
    # 512-token segments the ≈ 3 000-token prompt would go chunked per
    # member and never dedup, so this leg turns chunking off.
    urls = _fanout_urls(model, extra, True,
                        "&member_seeds=shared&quorum_dedup=1&prefill_chunk=0")
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
    k2_steps = _k2_steps(m1) - _k2_steps(m0)
    prefills = m1["quorum_dedup_prefills_total"] - m0["quorum_dedup_prefills_total"]
    saved = m1["quorum_dedup_tokens_total"] - m0["quorum_dedup_tokens_total"]
    require(prefills >= 1, "members_dedup: no dedup admission was counted")
    require(all(int(c.abs().sum()) == 0 for c in ticket_counters()),
            "K2 ticket counters are not back at 0 after the dedup leg")
    if not cpu:
        require(launches["flash_prefill"] == n_layers * dispatches
                and flash_prefill_attention.launches_by_route["wgmma"] == n_layers * dispatches,
                f"K1 launches {launches['flash_prefill']} != {n_layers} x {dispatches} dispatches")
        require(launches["flash_decode"] == n_layers * k2_steps,
                f"K2 launches {launches['flash_decode']} != {n_layers} x {k2_steps}")
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
            "graph_warmup_steps": k2_steps - steps,
            "ttft_all_members_s": readings,
            "dedup_members_equal": checked, "launches": launches,
            "peak_mem_gb": None if cpu else round(peak / 1e9, 3),
            "measured_on": f"{device_info['name']} ({device_info['power_limit']})"}
    emit("members_dedup", **info)
    shutdown_all_engines()
    return info


# ---- real checkpoints and MoE ------------------------------------------------

# HF tensor names of a llama-family layer ← the port's leaves (transposed
# where HF stores nn.Linear's [out, in]).
_HF_LAYER = (("input_layernorm.weight", "attn_norm_w", False),
             ("self_attn.q_proj.weight", "wq", True), ("self_attn.k_proj.weight", "wk", True),
             ("self_attn.v_proj.weight", "wv", True), ("self_attn.o_proj.weight", "wo", True),
             ("post_attention_layernorm.weight", "mlp_norm_w", False))
_HF_DENSE = (("mlp.gate_proj.weight", "w_gate"), ("mlp.up_proj.weight", "w_up"),
             ("mlp.down_proj.weight", "w_down"))
_HF_EXPERT = (("w1.weight", "moe_w_gate"), ("w3.weight", "moe_w_up"), ("w2.weight", "moe_w_down"))


def _hf_tensors(spec, params):
    """(HF name, tensor view) of a llama-family tree in checkpoint order
    (transposed views where HF stores nn.Linear's [out, in]; no copies)."""
    b = params["blocks"]
    yield "model.embed_tokens.weight", params["tok_emb"]
    for i in range(spec.n_layers):
        pre = f"model.layers.{i}."
        for name, leaf, t in _HF_LAYER:
            yield pre + name, b[leaf][i].T if t else b[leaf][i]
        if spec.is_moe:
            yield pre + "block_sparse_moe.gate.weight", b["router"][i].T
            for e in range(spec.n_experts):
                for name, leaf in _HF_EXPERT:
                    yield f"{pre}block_sparse_moe.experts.{e}.{name}", b[leaf][i, e].T
        else:
            for name, leaf in _HF_DENSE:
                yield pre + name, b[leaf][i].T
    yield "model.norm.weight", params["final_norm_w"]
    yield "lm_head.weight", params["lm_head"].T


def _write_hf_checkpoint(torch, path: str, spec, params, model_type: str,
                         n_shards: int = 2) -> int:
    """The tree as an HF checkpoint directory: ``config.json``, the tensors
    split by bytes over ``n_shards`` ``*.safetensors`` files (8-byte
    little-endian header length, JSON header, raw little-endian bytes) and
    their index (each shard by ``models/hf_loader.write_safetensors``).
    Returns the bytes written."""
    from quorum_tpu_torch.models.hf_loader import HostStage, write_safetensors

    cfg = {"model_type": model_type, "vocab_size": spec.vocab_size,
           "hidden_size": spec.d_model, "intermediate_size": spec.d_ff,
           "num_hidden_layers": spec.n_layers, "num_attention_heads": spec.n_heads,
           "num_key_value_heads": spec.n_kv_heads, "head_dim": spec.head_dim,
           "max_position_embeddings": spec.max_seq, "rope_theta": spec.rope_theta, "rms_norm_eps": spec.norm_eps,
           "tie_word_embeddings": spec.tied_lm_head, "torch_dtype": spec.dtype}
    if spec.is_moe:
        cfg.update(num_local_experts=spec.n_experts, num_experts_per_tok=spec.experts_per_token)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg, f)
    tensors = list(_hf_tensors(spec, params))
    total = sum(t.numel() * t.element_size() for _, t in tensors)
    shards, acc = [[] for _ in range(n_shards)], 0
    for name, t in tensors:
        shards[min(n_shards - 1, acc * n_shards // total)].append((name, t))
        acc += t.numel() * t.element_size()
    shards = [sh for sh in shards if sh]
    files = [f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors" for i in range(len(shards))]
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": {name: fname for fname, sh in zip(files, shards)
                                  for name, _ in sh}}, f)
    stage = HostStage()
    return sum(write_safetensors(os.path.join(path, fname), dict(shard), stage=stage)
               for fname, shard in zip(files, shards))


def _rss_gb() -> tuple[float | None, float | None]:
    """(current RSS, peak RSS since the last reset) of this process, GB."""
    cur = peak = None
    try:
        with open("/proc/self/status") as f:
            for ln in f:
                if ln.startswith("VmRSS:"):
                    cur = int(ln.split()[1]) * 1024 / 1e9
                elif ln.startswith("VmHWM:"):
                    peak = int(ln.split()[1]) * 1024 / 1e9
    except OSError:
        pass
    return cur, peak


class _RssSampler:
    """The process's RSS sampled every few ms on a thread while the block
    runs: the peak over a window (VmHWM cannot be reset everywhere)."""

    def __init__(self, period_s: float = 0.002):
        import threading

        self.period_s, self.peak_gb = period_s, 0.0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        while not self._stop.is_set():
            cur, _ = _rss_gb()
            self.peak_gb = max(self.peak_gb, cur or 0.0)
            self._stop.wait(self.period_s)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def _maxrss_gb() -> float:
    """Peak RSS of this process since it started, GB."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


def phase_checkpoint(torch, cpu: bool, tiny: bool, device_info: dict) -> dict:
    """Real checkpoints through ``cuda://…?ckpt=DIR``: llama-3-8b at full
    width and 2 layers, and mixtral-8x7b at full width and 1 layer (its 8
    experts stacked at real shapes), each built by ``init_params`` (bf16,
    seed 0), written as an HF checkpoint over two safetensors shards into a
    temporary directory, and loaded through the port's app with a
    ``ckpt=`` URL. Every loaded leaf must equal the written one bit for
    bit. On the llama checkpoint two greedy requests (one streamed) go
    through the app; their texts and the engine's token ids must equal an
    engine built with ``params=`` the in-memory weights. Prints bytes
    written, seconds to write and to load (the app's build: load + engine),
    load GB/s, and the process's RSS (peak since start, and peak over each
    load). The directory is removed at the end."""
    import shutil
    import tempfile

    from quorum_tpu_torch.config import Config
    from quorum_tpu_torch.engine.engine import InferenceEngine, shutdown_all_engines
    from quorum_tpu_torch.models.init import init_params
    from quorum_tpu_torch.models.model_config import resolve_spec
    from quorum_tpu_torch.ops.flash_attention import flash_prefill_attention
    from quorum_tpu_torch.ops.flash_decode import flash_decode_attention
    from quorum_tpu_torch.server.app import create_app

    dev = "cpu" if cpu else "cuda"
    _require_card_empty(torch, cpu, "checkpoint")
    if not cpu:
        torch.cuda.reset_peak_memory_stats()
    cases = ((("llama-tiny", "mixtral-tiny"), (2, 1)) if tiny
             else (("llama-3-8b", "mixtral-8x7b"), (2, 1)))
    root = tempfile.mkdtemp(prefix="quorum_ckpt_")
    card = f"{device_info['name']} ({device_info['power_limit']})"
    max_tokens = 16
    out = {"measured_on": card, "tmpdir_free_gb": round(shutil.disk_usage(root).free / 1e9, 3)}
    flash_prefill_attention.launches = 0
    flash_prefill_attention.launches_by_route.update(wgmma=0, fma=0)
    flash_decode_attention.launches = 0
    k2_steps = single_shot = 0
    try:
        for model, n_layers in zip(*cases):
            ref = None
            spec = resolve_spec(model, {"n_layers": str(n_layers)})
            # Short temporary space cuts the depth (reported), never the phase.
            while _llama_family_bytes(spec) > 0.9 * shutil.disk_usage(root).free:
                require(spec.n_layers > 1, f"checkpoint: one layer of {model} does not fit "
                                           "the temporary directory")
                spec = resolve_spec(model, {"n_layers": str(spec.n_layers - 1)})
            params = init_params(spec, 0, dev)
            path = os.path.join(root, model)
            os.makedirs(path)
            t0 = time.perf_counter()
            written = _write_hf_checkpoint(torch, path, spec, params,
                                           "mixtral" if spec.is_moe else "llama")
            write_s = time.perf_counter() - t0
            url = f"cuda://{model}?ckpt={path}" + ("&device=cpu" if cpu else "")
            cfg = Config(raw={"primary_backends": [{"name": "ckpt", "url": url}],
                              "settings": {"timeout": SERVE_TIMEOUT_S}})
            rss_before, _ = _rss_gb()
            with _RssSampler() as sampled:
                t0 = time.perf_counter()
                app = create_app(cfg)
                if not cpu:
                    torch.cuda.synchronize()
                load_s = time.perf_counter() - t0
            rss_now, _ = _rss_gb()
            backend = app.state["registry"].backends[0]
            eng = backend.engine
            require(eng.spec == spec, f"{model}: the checkpoint's spec {eng.spec} != {spec}")
            loaded, want = list(_hf_params(eng.params)), list(_hf_params(params))
            require(len(loaded) == len(want) and all(
                a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
                for a, b in zip(loaded, want)), f"{model}: a loaded leaf differs from the written one")
            row = {"model": model, "layers": spec.n_layers,
                   "depth_cut_for_tmp_space": spec.n_layers < n_layers,
                   "files": sorted(os.listdir(path)),
                   "bytes_written": written, "write_s": round(write_s, 3),
                   "load_s": round(load_s, 3), "load_gb_per_s": round(written / load_s / 1e9, 3),
                   "leaves_equal": len(loaded), "rss_gb_before_load": rss_before,
                   "rss_gb_after_load": rss_now, "rss_peak_gb_over_load": sampled.peak_gb}
            if not spec.is_moe:
                m0 = eng.metrics()
                ref = InferenceEngine(spec, device=dev, params=params)
                try:
                    row.update(_ckpt_requests(torch, app, backend, ref, model, max_tokens,
                                              (20, 60) if tiny else (120, 700)))
                    mr = ref.metrics()
                finally:
                    ref.shutdown()
                m1 = eng.metrics()
                k2_steps += spec.n_layers * (_k2_steps(m1) - _k2_steps(m0) + _k2_steps(mr))
                single_shot += spec.n_layers * (
                    m1["admission_dispatches_total"] - m0["admission_dispatches_total"]
                    + mr["admission_dispatches_total"])
                row["quant_int8_reload"] = _ckpt_quant_reload(torch, cpu, model, path, params)
            out[model] = row
            del app, backend, eng, params, loaded, want, ref
            shutdown_all_engines()
            _require_card_empty(torch, cpu, f"checkpoint after {model}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = {"flash_prefill": flash_prefill_attention.launches,
                "flash_decode": flash_decode_attention.launches}
    if not cpu:
        require(launches["flash_prefill"] == single_shot > 0,
                f"checkpoint: K1 launches {launches['flash_prefill']} != {single_shot}")
        require(launches["flash_decode"] == k2_steps > 0,
                f"checkpoint: K2 launches {launches['flash_decode']} != {k2_steps}")
    out.update(launches=launches, tmpdir_removed=not os.path.exists(root),
               peak_rss_gb_process=_maxrss_gb(),
               peak_mem_gb=None if cpu else round(torch.cuda.max_memory_allocated() / 1e9, 3))
    emit("checkpoint", **out)
    return out


def _ckpt_quant_reload(torch, cpu: bool, model: str, path: str, params) -> dict:
    """The checkpoint again through the app with ``quant=int8`` (quantized
    on the card tensor by tensor as it loads): every leaf must equal the
    in-memory quantized engine's (``quantize_params`` of the written bf16
    weights) bit for bit."""
    from quorum_tpu_torch.config import Config
    from quorum_tpu_torch.engine.engine import shutdown_all_engines
    from quorum_tpu_torch.models.quant import quantize_params, quantized_param_bytes
    from quorum_tpu_torch.server.app import create_app

    url = f"cuda://{model}?ckpt={path}&quant=int8" + ("&device=cpu" if cpu else "")
    cfg = Config(raw={"primary_backends": [{"name": "ckpt_q8", "url": url}],
                      "settings": {"timeout": SERVE_TIMEOUT_S}})
    t0 = time.perf_counter()
    app = create_app(cfg)
    if not cpu:
        torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    eng = app.state["registry"].backends[0].engine
    want = quantize_params(params)
    got_leaves, want_leaves = list(_tensors(eng.params)), list(_tensors(want))
    require(len(got_leaves) == len(want_leaves) and all(
        a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
        for a, b in zip(got_leaves, want_leaves)),
        f"{model}: a quant=int8 leaf of the checkpoint differs from the in-memory engine's")
    out = {"load_s": round(load_s, 3), "leaves_equal": len(got_leaves),
           "weights_gb": round(quantized_param_bytes(eng.params) / 1e9, 3)}
    del app, eng, want, got_leaves, want_leaves
    shutdown_all_engines()
    return out


def _tensors(tree):
    """Every tensor of a (possibly quantized) tree, in key order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _tensors(v)
        elif v is not None:
            yield v


def _llama_family_bytes(spec) -> int:
    """Bytes of a llama-family (or mixtral) checkpoint of ``spec``."""
    d, f, e = spec.d_model, spec.d_ff, spec.n_experts
    h, k = spec.n_heads * spec.head_dim, spec.n_kv_heads * spec.head_dim
    mlp = d * e + 3 * e * d * f if spec.is_moe else 3 * d * f
    layer = 2 * d + 2 * d * h + 2 * d * k + mlp
    top = spec.vocab_size * d * (1 if spec.tied_lm_head else 2) + d
    return (spec.n_layers * layer + top) * {"float32": 4}.get(spec.dtype, 2)


def _hf_params(params):
    """Every tensor leaf of a tree, top level then blocks, in key order."""
    for k in sorted(params):
        if k != "blocks" and params[k] is not None:
            yield params[k]
    for k in sorted(params["blocks"]):
        if params["blocks"][k] is not None:
            yield params["blocks"][k]


def _ckpt_requests(torch, app, backend, ref, model: str, max_tokens: int,
                   sizes: tuple[int, int]) -> dict:
    """Two greedy requests (one streamed) through the app on the checkpoint;
    texts equal the in-memory engine's decoded tokens, and the checkpoint
    engine's token ids equal the in-memory engine's."""
    from quorum_tpu_torch.ops.sampling import SamplerConfig

    tok = backend.tokenizer
    greedy = SamplerConfig(temperature=0.0)
    bodies = [{"model": model, "messages": [{"role": "user", "content": _prompt(n, i)}],
               "max_tokens": max_tokens, "temperature": 0, "stream": stream}
              for i, (n, stream) in enumerate(zip(sizes, (False, True)))]
    for b in bodies:
        if b["stream"]:
            b["stream_options"] = {"include_usage": True}

    async def drive():
        return await asyncio.gather(*[_call(app, b) for b in bodies])

    resps = asyncio.run(asyncio.wait_for(drive(), 2 * SERVE_TIMEOUT_S))
    checked = [_check_response(r, b, tok, max_tokens) for r, b in zip(resps, bodies)]
    texts = []
    for b, c in zip(bodies, checked):
        ids = tok.encode(tok.render_chat(b["messages"]))
        want = ref.generate(ids, max_new_tokens=max_tokens, sampler=greedy,
                            eos_id=tok.eos_id).token_ids
        got = backend.engine.generate(ids, max_new_tokens=max_tokens, sampler=greedy,
                                      eos_id=tok.eos_id).token_ids
        require(got == want, f"checkpoint engine tokens {got} != in-memory engine's {want}")
        require(c["text"] == tok.decode(want), "app text differs from the in-memory engine's")
        require(c["usage"]["completion_tokens"] == len(want), f"usage {c['usage']}")
        texts.append(c["text"])
    return {"requests": [{"stream": b["stream"], "prompt_tokens": c["usage"]["prompt_tokens"],
                          "completion_tokens": c["usage"]["completion_tokens"],
                          "seconds": round(c["t_end"], 4)} for b, c in zip(bodies, checked)],
            "tokens_equal_in_memory_engine": True}


# Grouped MoE against the dense oracle in bf16 (no drop at cf = E/k): the
# same expert products, combined in another order and rounded once to bf16.
MOE_TOL = 2e-2


def phase_moe(torch, cpu: bool, tiny: bool, device_info: dict, profile: bool) -> dict:
    """Mixtral-8x7b at full width and 16 layers (``cuda://mixtral-8x7b?
    n_layers=16``: random init, seed 0, bf16, 4 slots, the default
    scheduler) behind the port's app: 4 concurrent chat requests of 57,
    317, 1217 and 3017 prompt tokens (2 streamed, 2 greedy, 2 sampled; 32
    completion tokens each): the short two admit single-shot (grouped MoE +
    K1), the long two in 512-token segments (grouped MoE in
    ``prefill_segment``); decode runs the dense MoE inside graph replays
    (K2). K1 = 16 × single-shot dispatches and K2 = 16 × (decode + warm-up
    steps), required. Then, on layer 0 and the 3017-token prompt's normed
    embeddings: the grouped MoE against the dense oracle at
    ``moe_capacity_factor=4`` (= E/k, no drop) within ``MOE_TOL``, and the
    picks the default cf=2 drops over the whole prompt and over its
    512-token segments. Prints tok/s per stream, device ms per 8-step
    chunk against the weight-read bound, peak memory, the free memory at
    the start, captures and their seconds. With ``profile``, the 4
    requests again under torch.profiler (graphs captured by then)."""
    import dataclasses

    from quorum_tpu_torch.config import Config
    from quorum_tpu_torch.engine.engine import shutdown_all_engines
    from quorum_tpu_torch.models import transformer as tt
    from quorum_tpu_torch.ops.flash_attention import flash_prefill_attention
    from quorum_tpu_torch.ops.flash_decode import flash_decode_attention, ticket_counters
    from quorum_tpu_torch.server.app import create_app

    _require_card_empty(torch, cpu, "moe")
    free_gb = None if cpu else torch.cuda.mem_get_info()[0] / 1e9
    if not cpu:
        torch.cuda.reset_peak_memory_stats()
    model = "mixtral-tiny" if tiny else "mixtral-8x7b"
    url = f"cuda://{model}?seed=0" + ("&device=cpu" if cpu else "&n_layers=16")
    cfg = Config(raw={"primary_backends": [{"name": "moe", "url": url}],
                      "settings": {"timeout": SERVE_TIMEOUT_S}})
    t0 = time.perf_counter()
    app = create_app(cfg)
    backend = app.state["registry"].backends[0]
    eng = backend.engine
    if not cpu:
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    spec, tok = eng.spec, backend.tokenizer
    require(spec.is_moe and eng.n_slots == 4, f"moe: {spec}")
    sizes = (20, 30, 50, 80) if tiny else (57, 317, 1217, 3017)
    max_tokens = 16 if tiny else 32
    overhead = len(tok.encode(tok.render_chat([{"role": "user", "content": ""}])))

    def body(i, stream, sampled):
        b = {"model": model, "max_tokens": max_tokens, "stream": stream,
             "messages": [{"role": "user", "content": _prompt(sizes[i] - overhead, 10 + i)}]}
        b.update({"temperature": 0.8, "top_p": 0.9, "seed": i} if sampled
                 else {"temperature": 0})
        if stream:
            b["stream_options"] = {"include_usage": True}
        return b

    bodies = [body(0, False, False), body(1, True, False), body(2, False, True),
              body(3, True, True)]
    lens = [len(tok.encode(tok.render_chat(b["messages"]))) for b in bodies]
    require(lens == list(sizes), f"moe prompts are {lens} tokens, want {sizes}")
    recs = _timed_dispatches(torch, eng, cpu)
    flash_prefill_attention.launches = 0
    flash_prefill_attention.launches_by_route.update(wgmma=0, fma=0)
    flash_decode_attention.launches = 0
    m0 = eng.metrics()

    async def drive():
        return await asyncio.gather(*[_call(app, b) for b in bodies])

    t0 = time.perf_counter()
    resps = asyncio.run(asyncio.wait_for(drive(), 2 * SERVE_TIMEOUT_S))
    wall = time.perf_counter() - t0
    m1 = eng.metrics()
    launches = {"flash_prefill": flash_prefill_attention.launches,
                "flash_decode": flash_decode_attention.launches}
    k1_routes = dict(flash_prefill_attention.launches_by_route)
    checked = [_check_response(r, b, tok, max_tokens) for r, b in zip(resps, bodies)]
    single_shot = m1["admission_dispatches_total"] - m0["admission_dispatches_total"]
    segments = m1["prefill_segments_total"] - m0["prefill_segments_total"]
    steps = m1["decode_steps_total"] - m0["decode_steps_total"]
    k2_steps = _k2_steps(m1) - _k2_steps(m0)
    chunk = eng.prefill_chunk
    require(single_shot == sum(1 for n in lens if not chunk or n <= chunk)
            and segments == sum(-(-n // chunk) for n in lens if chunk and n > chunk),
            f"moe: {single_shot} single-shot admissions and {segments} segments for {lens}")
    if not cpu:
        require(launches["flash_prefill"] == spec.n_layers * single_shot
                and k1_routes["wgmma"] == launches["flash_prefill"] > 0,
                f"moe: K1 launches {launches} ({k1_routes}) != {spec.n_layers} x {single_shot}")
        require(launches["flash_decode"] == spec.n_layers * k2_steps > 0,
                f"moe: K2 launches {launches['flash_decode']} != {spec.n_layers} x {k2_steps}")
        require(all(int(c.abs().sum()) == 0 for c in ticket_counters()),
                "K2 ticket counters are not back at 0 after the moe phase")
    dev_ms = _device_ms(torch, cpu, recs)
    chunk_ms = None if dev_ms is None else [
        round(ms / c.n_chunks, 3) for (c, _), ms in zip(recs, dev_ms)
        if c.n_steps == eng.decode_chunk]
    blocks_bytes = sum(t.numel() * t.element_size() for k, t in eng.params["blocks"].items()
                       if t is not None)
    head_bytes = eng.params["lm_head"].numel() * eng.params["lm_head"].element_size()
    bound_step_ms = (blocks_bytes + head_bytes) / HBM_BYTES_PER_S * 1e3
    streams = [c for c in checked if c.get("ttft_s") is not None]
    rates = [(c["usage"]["completion_tokens"] - 1) / (c["t_last_s"] - c["ttft_s"])
             for c in streams if c["t_last_s"] > c["ttft_s"]]

    # One full-width layer: grouped vs the dense oracle (no drop), drops at cf=2.
    ids = torch.tensor([tok.encode(tok.render_chat(bodies[3]["messages"]))], device=eng.device)
    block = {k: (None if v is None else v[0]) for k, v in eng.params["blocks"].items()}
    with torch.no_grad():
        x = tt._embed(eng.params, spec, ids, torch.arange(ids.shape[1], device=eng.device))
        x = tt._norm(x, block["mlp_norm_w"], None, spec)
        no_drop = dataclasses.replace(spec, moe_capacity_factor=spec.n_experts
                                      / spec.experts_per_token)
        dense = tt._moe_mlp_dense(x, block, spec).float()
        grouped = tt._moe_mlp_grouped(x, block, no_drop).float()
        err = float((grouped - dense).abs().max())
        _, idx = tt._moe_router(x, block, spec)

        def dropped(part) -> int:
            load = torch.bincount(part.reshape(-1), minlength=spec.n_experts)
            return int((load - tt.moe_capacity(spec, part.shape[0])).clamp(min=0).sum())

        flat = idx[0]
        drops_whole = dropped(flat)
        drops_segments = sum(dropped(flat[i:i + chunk]) for i in range(0, flat.shape[0], chunk))
    require(err <= MOE_TOL and float(dense.abs().max()) > 1e-3,
            f"moe: grouped vs dense max abs err {err} > {MOE_TOL}")
    info = {
        "model": model, "layers": spec.n_layers, "slots": eng.n_slots,
        "max_seq": spec.max_seq, "dtype": spec.dtype, "free_mem_gb_at_start": free_gb,
        "app_build_s": round(build_s, 3),
        "weights_gb": round((blocks_bytes + head_bytes) / 1e9, 3),
        "requests": [{"stream": b["stream"], "sampled": "seed" in b,
                      "prompt_tokens": c["usage"]["prompt_tokens"],
                      "completion_tokens": c["usage"]["completion_tokens"],
                      "finish": c["finish"], "seconds": round(c["t_end"], 4),
                      "ttft_s": c.get("ttft_s")} for b, c in zip(bodies, checked)],
        "concurrent_wall_s": round(wall, 4),
        "single_shot_admissions": single_shot, "prefill_segments": segments,
        "decode_steps": steps, "graph_warmup_steps": k2_steps - steps,
        "decode_tok_per_s_per_stream": rates,
        "device_ms_per_8_step_chunk": chunk_ms,
        # 4 rows decoding: each stream gets one token per step
        "decode_tok_per_s_per_stream_from_median_chunk": (
            None if not chunk_ms else round(eng.decode_chunk * 1e3 / statistics.median(chunk_ms),
                                            3)),
        "bound_ms_per_step_weight_read": round(bound_step_ms, 3),
        "decode_graph_captures": m1["decode_graph_captures_total"],
        "decode_graph_capture_s": m1["decode_graph_capture_seconds_total"],
        "launches": launches, "k1_launches_by_route": k1_routes,
        "grouped_vs_dense_max_abs_err_cf4": err, "grouped_vs_dense_tol": MOE_TOL,
        "dropped_picks_cf2_whole_prompt": drops_whole,
        "dropped_picks_cf2_per_512_segments": drops_segments,
        "picks_on_prompt": int(flat.numel()),
        "peak_mem_gb": None if cpu else round(torch.cuda.max_memory_allocated() / 1e9, 3),
        "measured_on": f"{device_info['name']} ({device_info['power_limit']})",
    }
    emit("moe", **info)
    if profile:
        phase_profile(torch, cpu, lambda: asyncio.run(asyncio.wait_for(
            drive(), 2 * SERVE_TIMEOUT_S)), info["measured_on"], flash_decode_attention,
            of="moe")
    del app, backend, eng, block, x, dense, grouped
    shutdown_all_engines()
    return info


def phase_quant(torch, cpu: bool, tiny: bool, device_info: dict, serve: dict | None,
                profile: bool = False) -> dict:
    """int8 weights and the int8 KV cache behind the app (``cuda://…?
    quant=int8&kv_quant=int8``: random init, seed 0, 4 slots × the model's
    window, the default scheduler), the serve phase's 4 requests:
    (a) llama-3-8b at full width and 32 layers; (b) mixtral-8x7b at full
    width and all 32 layers. Each leg requires K1 = layers × single-shot
    dispatches, K2q8 = layers × (decode + warm-up steps) and K2 = 0
    exactly, and prints the app's build seconds (the quantized init), the
    device ms per 8-step chunk against the int8 weight-read bound, tok/s
    and peak memory. The llama leg also gives its greedy texts' token
    agreement with the serve phase's bf16 engine as a share (int8 rounds
    differently; equality is not the contract); the mixtral leg then a
    64 × 2 048 scoring request beside its 4 requests (``_moe_scoring``);
    and (c) an 8-step
    ``decode_chunk`` over an int8 cache on its weights replayed from a CUDA
    graph against the eager call: tokens, state and both caches bit for
    bit, K2q8 exact. With ``profile``, each leg's 4 requests again under
    torch.profiler."""
    from quorum_tpu_torch.engine.engine import shutdown_all_engines

    out = {}
    legs = ("llama-tiny", "mixtral-tiny") if tiny else ("llama-3-8b", "mixtral-8x7b")
    for model in legs:
        _require_card_empty(torch, cpu, f"quant {model}")
        out[model] = _quant_leg(torch, cpu, tiny, device_info, model,
                                serve if model == legs[0] else None, profile)
        shutdown_all_engines()
    _require_card_empty(torch, cpu, "quant end")
    out["launches"] = {k: sum(out[m]["launches"][k] for m in legs)
                       for k in out[legs[0]]["launches"]}
    return out


# Device memory the mixtral leg's 64 × 2 048 scoring request may add over
# the engine's footprint, its 4 live streams included: one unsplit
# 131 072-token forward (the capacity can bind) with its expert buffers in
# MOE_SLOT_ROWS slices — 4.3 GB of per-pick float32 outputs, the residual
# stream, its norms and the attention's operands.
MOE_SCORE_EXTRA_GB = 20.0


def _moe_scoring(torch, cpu: bool, tiny: bool, app, eng, model: str, bodies: list[dict],
                 tok, max_tokens: int) -> dict:
    """The largest scoring request the API takes (64 prompts of 2 048
    tokens, ``echo``, ``logprobs=1``, ``max_tokens=0``) on an MoE engine
    whose expert capacity can bind (never split: one 131 072-token
    forward), beside the serve phase's 4 requests as live traffic: it
    completes with every logprob finite and ≤ 0 and adds at most
    MOE_SCORE_EXTRA_GB over the footprint, K1 = layers × (1 forward +
    single-shot admissions), and the 4 requests finish whole; 64 × 2 049
    (a 4 096 bucket) is a 400 naming ``MOE_FORWARD_TOKENS``."""
    from quorum_tpu_torch.engine import embed as embed_mod
    from quorum_tpu_torch.ops.flash_attention import flash_prefill_attention

    spec = eng.spec
    require(tiny or not embed_mod.moe_split_exact(spec),
            f"{model}: expected an expert capacity that can bind")
    n_tok = 100 if tiny else 2048
    rng = random.Random(8)

    def prompts(n):
        return [[rng.randrange(3, spec.vocab_size) for _ in range(n)] for _ in range(64)]

    score_body = {"model": model, "prompt": prompts(n_tok), "echo": True, "logprobs": 1,
                  "max_tokens": 0}
    footprint = 0 if cpu else torch.cuda.memory_allocated()
    if not cpu:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    flash_prefill_attention.launches = 0
    m0 = eng.metrics()

    async def drive():
        async def timed(b, path):
            t0 = time.perf_counter()
            r = await _call(app, b, path=path)
            return r, time.perf_counter() - t0

        return await asyncio.gather(
            timed(score_body, "/v1/completions"),
            *[timed(b, "/v1/chat/completions") for b in bodies])

    (scored, score_s), *live = asyncio.run(asyncio.wait_for(drive(), 2 * SERVE_TIMEOUT_S))
    peak = 0 if cpu else torch.cuda.max_memory_allocated()
    m1 = eng.metrics()
    k1 = flash_prefill_attention.launches
    require(scored["status"] == 200,
            f"{model} 64 x {n_tok} scoring: {scored['status']} {scored['data'][:300]!r}")
    lps = [c["logprobs"]["token_logprobs"] for c in json.loads(scored["data"])["choices"]]
    require(len(lps) == 64 and all(len(x) == n_tok and x[0] is None and all(
        v is not None and math.isfinite(v) and v <= 0 for v in x[1:]) for x in lps),
            f"{model} 64 x {n_tok} scoring: malformed logprobs")
    checked = [_check_response(r, b, tok, max_tokens) for (r, _), b in zip(live, bodies)]
    single = m1["admission_dispatches_total"] - m0["admission_dispatches_total"]
    if not cpu:
        require(k1 == spec.n_layers * (1 + single),
                f"{model} scoring: K1 launches {k1} != {spec.n_layers} x (1 + {single})")
        require(peak - footprint < MOE_SCORE_EXTRA_GB * 1e9,
                f"{model} 64 x {n_tok} scoring peaked {(peak - footprint) / 1e9:.2f} GB over "
                f"a {footprint / 1e9:.2f} GB footprint")
    refused = None
    if not tiny:
        over = asyncio.run(asyncio.wait_for(_call(app, {**score_body, "prompt": prompts(
            n_tok + 1)}, path="/v1/completions"), SERVE_TIMEOUT_S))
        refused = json.loads(over["data"]).get("error", {}).get("message", "")
        require(over["status"] == 400 and f"{embed_mod.MOE_FORWARD_TOKENS}-token forward"
                in refused, f"{model} 64 x {n_tok + 1}: {over['status']} {refused!r}")
    return {"prompts": 64, "tokens_each": n_tok, "request_s": round(score_s, 4),
            "forward_tokens_limit": embed_mod.MOE_FORWARD_TOKENS,
            "footprint_gb": None if cpu else round(footprint / 1e9, 3),
            "peak_gb_over_footprint": None if cpu else round((peak - footprint) / 1e9, 3),
            "extra_limit_gb": MOE_SCORE_EXTRA_GB, "k1_launches": k1,
            "live_requests": [{"stream": b["stream"], "finish": c["finish"],
                               "completion_tokens": c["usage"]["completion_tokens"],
                               "seconds": round(t, 4)}
                              for b, c, (_, t) in zip(bodies, checked, live)],
            "over_limit_refused": refused}


def _token_agreement(tok, got: str, want: str) -> dict:
    a, b = tok.encode(got), tok.encode(want)
    same = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
    return {"tokens": max(len(a), len(b)), "leading_equal": same,
            "share_equal": sum(x == y for x, y in zip(a, b)) / max(len(a), len(b), 1)}


def _quant_leg(torch, cpu: bool, tiny: bool, device_info: dict, model: str,
               serve: dict | None, profile: bool) -> dict:
    from quorum_tpu_torch.config import Config
    from quorum_tpu_torch.models.quant import is_quantized, quantized_param_bytes
    from quorum_tpu_torch.ops.flash_attention import flash_prefill_attention
    from quorum_tpu_torch.ops.flash_decode import flash_decode_attention
    from quorum_tpu_torch.ops.flash_decode_q8 import flash_decode_q8_attention
    from quorum_tpu_torch.server.app import create_app

    free_gb = None if cpu else torch.cuda.mem_get_info()[0] / 1e9
    if not cpu:
        torch.cuda.reset_peak_memory_stats()
    url = (f"cuda://{model}?seed=0&slots=4&decode_chunk=8&quant=int8&kv_quant=int8"
           + ("&device=cpu" if cpu else ""))
    cfg = Config(raw={"primary_backends": [{"name": "quant", "url": url}],
                      "settings": {"timeout": SERVE_TIMEOUT_S}})
    t0 = time.perf_counter()
    app = create_app(cfg)
    backend = app.state["registry"].backends[0]
    eng = backend.engine
    if not cpu:
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    spec, tok = eng.spec, backend.tokenizer
    require(is_quantized(eng.params["blocks"]["wq"]) and isinstance(eng._ck, tuple)
            and eng._ck[0].dtype == torch.int8, f"quant {model}: not an int8 engine")
    max_tokens = 16 if tiny else 32
    bodies = _serve_bodies(model, tiny)
    recs = _timed_dispatches(torch, eng, cpu)
    # Every launch counter to 0 just before the main path, read just after.
    flash_prefill_attention.launches = 0
    flash_prefill_attention.launches_by_route.update(wgmma=0, fma=0)
    flash_decode_attention.launches = 0
    flash_decode_q8_attention.launches = 0
    m0 = eng.metrics()

    async def drive():
        return await asyncio.gather(*[_call(app, b) for b in bodies])

    t0 = time.perf_counter()
    resps = asyncio.run(asyncio.wait_for(drive(), 2 * SERVE_TIMEOUT_S))
    wall = time.perf_counter() - t0
    m1 = eng.metrics()
    launches = {"flash_prefill": flash_prefill_attention.launches,
                "flash_decode": flash_decode_attention.launches,
                "flash_decode_q8": flash_decode_q8_attention.launches}
    k1_routes = dict(flash_prefill_attention.launches_by_route)
    checked = [_check_response(r, b, tok, max_tokens) for r, b in zip(resps, bodies)]
    single_shot = m1["admission_dispatches_total"] - m0["admission_dispatches_total"]
    segments = m1["prefill_segments_total"] - m0["prefill_segments_total"]
    steps = m1["decode_steps_total"] - m0["decode_steps_total"]
    q8_steps = _k2_steps(m1) - _k2_steps(m0)
    chunk = eng.prefill_chunk
    lens = [c["usage"]["prompt_tokens"] for c in checked]
    require(single_shot == sum(1 for n in lens if not chunk or n <= chunk)
            and segments == sum(-(-n // chunk) for n in lens if chunk and n > chunk),
            f"quant {model}: {single_shot} single-shot admissions and {segments} segments "
            f"for {lens}")
    if not cpu:
        require(launches["flash_prefill"] == spec.n_layers * single_shot
                and k1_routes["wgmma"] == launches["flash_prefill"] > 0,
                f"quant {model}: K1 launches {launches} ({k1_routes}) != "
                f"{spec.n_layers} x {single_shot}")
        require(launches["flash_decode_q8"] == spec.n_layers * q8_steps > 0,
                f"quant {model}: K2q8 launches {launches['flash_decode_q8']} != "
                f"{spec.n_layers} x {q8_steps}")
        require(launches["flash_decode"] == 0, f"quant {model}: K2 ran on an int8 cache")
    dev_ms = _device_ms(torch, cpu, recs)
    chunk_ms = None if dev_ms is None else [
        round(ms / c.n_chunks, 3) for (c, _), ms in zip(recs, dev_ms)
        if c.n_steps == eng.decode_chunk]
    head = eng.params["lm_head"] if eng.params["lm_head"] is not None else eng.params["tok_emb"]
    read_bytes = quantized_param_bytes({"blocks": eng.params["blocks"], "head": head})
    streams = [c for c in checked if c.get("ttft_s") is not None]
    info = {
        "model": model, "layers": spec.n_layers, "slots": eng.n_slots,
        "max_seq": spec.max_seq, "dtype": spec.dtype, "quant": eng.quant,
        "kv_quant": eng.kv_quant, "free_mem_gb_at_start": free_gb,
        "app_build_s_quantized_init": round(build_s, 3),
        "weights_gb": round(quantized_param_bytes(eng.params) / 1e9, 3),
        "weights_gb_read_per_step": round(read_bytes / 1e9, 3),
        "cache_gb": round(sum(t.numel() * t.element_size() for t in (*eng._ck, *eng._cv)) / 1e9,
                          3),
        "requests": [{"stream": b["stream"], "sampled": "seed" in b,
                      "prompt_tokens": c["usage"]["prompt_tokens"],
                      "completion_tokens": c["usage"]["completion_tokens"],
                      "finish": c["finish"], "seconds": round(c["t_end"], 4),
                      "ttft_s": c.get("ttft_s")} for b, c in zip(bodies, checked)],
        "concurrent_wall_s": round(wall, 4),
        "single_shot_admissions": single_shot, "prefill_segments": segments,
        "decode_steps": steps, "graph_warmup_steps": q8_steps - steps,
        "decode_tok_per_s_per_stream": [
            (c["usage"]["completion_tokens"] - 1) / (c["t_last_s"] - c["ttft_s"])
            for c in streams if c["t_last_s"] > c["ttft_s"]],
        "device_ms_per_8_step_chunk": chunk_ms,
        "decode_tok_per_s_per_stream_from_median_chunk": (
            None if not chunk_ms else round(eng.decode_chunk * 1e3 / statistics.median(chunk_ms),
                                            3)),
        "bound_ms_per_step_weight_read": round(read_bytes / HBM_BYTES_PER_S * 1e3, 3),
        "decode_graph_captures": m1["decode_graph_captures_total"],
        "decode_graph_capture_s": m1["decode_graph_capture_seconds_total"],
        "launches": launches, "k1_launches_by_route": k1_routes,
        "peak_mem_gb": None if cpu else round(torch.cuda.max_memory_allocated() / 1e9, 3),
        "measured_on": f"{device_info['name']} ({device_info['power_limit']})",
    }
    if serve is not None:
        texts = [c["text"] for b, c in zip(bodies, checked) if "seed" not in b]
        info["greedy_agreement_with_bf16"] = [
            _token_agreement(tok, got, want) for got, want in zip(texts, serve["greedy_texts"])]
    if model.startswith("llama"):
        gen = torch.Generator(device="cpu").manual_seed(7)
        info["replay"] = _quant_replay(torch, spec, eng.params, eng.device, gen, tiny)
    else:
        info["scoring_64"] = _moe_scoring(torch, cpu, tiny, app, eng, model, bodies, tok,
                                          max_tokens)
    emit("quant", **info)
    if profile:
        phase_profile(torch, cpu, lambda: asyncio.run(asyncio.wait_for(
            drive(), 2 * SERVE_TIMEOUT_S)), info["measured_on"], flash_decode_q8_attention,
            of=f"quant {model}", decode_kernels=("q8_decode_cluster_kernel",))
    return info


def _quant_replay(torch, spec, params, dev, gen, tiny: bool) -> dict:
    """An 8-step greedy ``decode_chunk`` over a 4-row int8 cache (three
    prefilled rows, one dead) replayed from a CUDA graph against the eager
    call from the same state: tokens, state and both int8 sides bit for
    bit; K2q8 = layers × (1 warm-up step + 8 replayed steps)."""
    from quorum_tpu_torch.models import transformer as tt
    from quorum_tpu_torch.ops.flash_decode_q8 import flash_decode_q8_attention

    cpu = torch.device(dev).type == "cpu"
    lens, bucket = ([40, 0, 20, 9], 64) if tiny else ([300, 0, 120, 41], 512)
    ck, cv = tt.init_cache(spec, 4, device=dev, kv_quant="int8")
    first = []
    for row, n in enumerate(lens):
        if not n:
            first.append(0)
            continue
        toks = torch.randint(3, spec.vocab_size, (1, bucket), generator=gen).to(dev)
        logits, _, _ = tt.prefill(params, spec, toks, torch.tensor(
            [n], dtype=torch.int32, device=dev), ck, cv, slot=row)
        first.append(int(logits.argmax()))
    state = {"token": torch.tensor(first, device=dev),
             "lengths": torch.tensor(lens, dtype=torch.int32, device=dev),
             "budget": torch.tensor([20, 0, 5, 20], dtype=torch.int32, device=dev)}
    state["live"] = state["budget"] > 0
    eos = torch.full((4,), -1, dtype=torch.int32, device=dev)

    def greedy(logits, live, k):
        return torch.argmax(logits, dim=-1), k + 1, ()

    def clone(side):
        return tuple(t.clone() for t in side)

    eager_state = {k: v.clone() for k, v in state.items()}
    ek, ev = clone(ck), clone(cv)
    want = _decode_fn(torch, spec, params, 8, 1, eos, greedy)(eager_state, ek, ev)
    replay, graphs = _replayer(torch, "cpu" if cpu else "cuda", cpu)
    n0 = flash_decode_q8_attention.launches
    program = _decode_fn(torch, spec, params, 8, 1, eos, greedy)
    got = replay((8, 1, False), lambda: program(state, ck, cv),
                 lambda: _decode_fn(torch, spec, params, 1, 1, eos, greedy)(
                     {k: v.clone() for k, v in state.items()}, clone(ck), clone(cv)))
    if not cpu:
        torch.cuda.synchronize()
    launched = flash_decode_q8_attention.launches - n0
    same_state = all(torch.equal(state[k], eager_state[k]) for k in state)
    same_cache = all(torch.equal(a, b) for a, b in zip(ck + cv, ek + ev))
    require(got.tolist() == want.tolist() and same_state,
            "quant replay: tokens or state differ from the eager call")
    require(same_cache, "quant replay: the int8 caches differ from the eager call's")
    require(cpu or launched == spec.n_layers * 9,
            f"quant replay: K2q8 launches {launched} != {spec.n_layers} x 9")
    return {"tokens_equal": True, "state_equal": True, "caches_bit_equal": True,
            "k2q8_launches": launched, "n_valid": got[..., -1].tolist(),
            "capture_s": None if cpu else round(graphs.capture_seconds, 3)}


# Kernel-name fragments → where the serve time goes.
# Greedy near-tie audit tolerance on the card's own forward: bf16 logits of
# two programs (a T-token verify, a T = 1 step through K2) differ by a few
# bf16 ulps of O(1) logits after 32 layers (the model phase's MODEL_TOL).
SPEC_TIE_TOL = {"float32": 2e-3, "bfloat16": 0.25}


def _spec_audit(torch, eng, prompt: list[int], a: list[int], b: list[int], *,
                temperature: float = 0.0, top_p: float = 1.0, seed: int = 0,
                pp: float = 0.0, fp: float = 0.0, bias=None) -> dict:
    """Two streams of one request (plain ``a``, speculative ``b``): equal, or
    their first divergence is a near-tie of the card's own cache-free
    forward at that position (the JAX package's ``_assert_same_or_tie_flip``):
    both tokens' scores within SPEC_TIE_TOL of the best, where the score is
    the adjusted logit (the request's bias, penalties from the tokens
    generated before it) over the temperature plus, for a sampled request, the
    request's own draw for that token index, among the tokens top-p keeps
    (its cutoff loosened by the tolerance). Fails otherwise."""
    from quorum_tpu_torch.models.transformer import forward_logits
    from quorum_tpu_torch.ops.sampling import gumbel_noise

    if a == b:
        return {"equal": True}
    i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    require(i is not None, f"spec: streams differ in length only ({len(a)} vs {len(b)})")
    tol = SPEC_TIE_TOL[eng.spec.dtype]
    seq = torch.tensor([list(prompt) + a[:i]], device=eng.device)
    with torch.no_grad():
        lg = forward_logits(eng.params, eng.spec, seq, plain_attention=True)[0, -1].float()
    counts = torch.zeros_like(lg)
    for t in a[:i]:
        counts[t] += 1
    adj = lg - fp * counts - pp * (counts > 0).float()
    if bias is not None:
        adj = adj + bias.to(adj.device)
    if temperature > 0.0:
        scaled = adj / temperature
        gen = torch.Generator(device=eng.device).manual_seed(seed)
        for _ in range(i + 1):
            noise = gumbel_noise(lg.shape[0], gen)
        probs = torch.softmax(scaled, dim=-1)
        order = torch.argsort(scaled, descending=True)
        cum = torch.cumsum(probs[order], dim=0)
        n_keep = int(((cum - probs[order]) < top_p).sum())
        cutoff = float(scaled[order[n_keep - 1]]) - tol / temperature
        score = torch.where(scaled >= cutoff, scaled + noise, torch.full_like(scaled, -1e30))
        tol = tol / temperature
    else:
        score = adj
    top = float(score.max())
    gaps = (top - float(score[a[i]]), top - float(score[b[i]]))
    require(max(gaps) < tol, f"spec: divergence at token {i} is not a near-tie: score gaps "
                             f"{gaps} to the best (tolerance {tol})")
    return {"equal": False, "first_divergence": i, "score_gaps": gaps}


def _recorded_submits(eng) -> list:
    """Wrap ``eng.submit`` so every request it queues is kept: its handle
    carries the prompt, the sampler, the knobs and the delivered tokens
    (``hist``). ``del eng.submit`` unwraps it."""
    reqs = []
    submit = eng.submit

    def recorded(*a, **k):
        r = submit(*a, **k)
        if r is not None:
            reqs.append(r)
        return r

    eng.submit = recorded
    return reqs


def _audit_requests(torch, eng, a_reqs: list, b_reqs: list) -> list[dict]:
    """``_spec_audit`` of each request of ``b_reqs`` (speculative engine
    ``eng``) against the request of ``a_reqs`` (its plain twin) with the
    same prompt, on the request's own sampler, seed, penalties and bias."""
    out = []
    for b in b_reqs:
        a = [r for r in a_reqs if r.prompt_ids == b.prompt_ids]
        require(len(a) == 1, f"spec: {len(a)} twin requests for one prompt")
        n = len(b.prompt_ids)
        out.append(_spec_audit(torch, eng, b.prompt_ids, a[0].hist[n:], b.hist[n:],
                               temperature=b.sampler.temperature, top_p=b.sampler.top_p,
                               seed=b.seed, pp=b.pp, fp=b.fp, bias=b.bias_row))
    return out


def phase_spec(torch, cpu: bool, tiny: bool, device_info: dict, graph_ms) -> dict:
    """Speculative decoding on ``cuda://`` engines (llama-3-8b at full width,
    bf16, 4 slots, decode_chunk 8, random weights of seed 0, byte prompts),
    each leg against a ``spec_decode=0`` twin engine on the same weights:

    (a) prompt lookup, ``?spec_decode=4``, 32 layers, behind the app: an
        aggregation-style prompt (three ≈ 400-byte member answers quoted,
        then the instruction: ≈ 1 300 tokens) greedy for 128 tokens, not
        streamed and streamed; then 4 at once (2 greedy repetitive prompts,
        1 sampled at temperature 0.8 / top-p 0.9, 1 greedy with
        presence_penalty 0.6) for 64 tokens. Greedy streams equal the
        twin's or diverge at an audited near-tie (``_spec_audit``); the
        sampled and penalty streams are checked the same way and reported
        as exact or not, through the app (each request's token ids) and
        co-batched. Verify turns, drafted, accepted, tokens per turn,
        overlapped turns; device ms per verify turn (CUDA events, medians)
        at a history ≤ 2 048 (1 and 4 rows) and ≈ 6 000 (1 row), against
        the twin's 8-step chunk per token; each verify key's first capture;
        a torch.profiler split of one verify replay (matmul kernels, the
        rest) beside the plain verify attention of the turn timed alone
        (32 layers by CUDA graph).
    (b) the fused draft loop, ``?spec_model=llama-3.2-1b`` (16 layers, hd
        64; random weights: acceptance near 0 is expected), at decode_loop
        1 and 4 (same tokens): ms per fused dispatch and per turn, and
        acceptance.
    (c) an oracle draft at 8 layers (the target's own spec and seed, by
        ``get_engine(..., draft_spec=, draft_seed=)``): streams equal the
        twin's (audited), accepted tokens per turn; then
        ``quant=int8&kv_quant=int8`` at 8 layers with ``spec_decode=4``
        against its twin.
    (d) ``speculative_aggregation: true``: the shipped three-member
        deployment (``members=3``) at 8 layers with ``spec_decode=4``
        boots and serves one aggregate request.

    Launch counts are exact: K1 = layers × single-shot admissions; K2 =
    the target's layers × (decode + warm-up steps) plus the draft's layers ×
    its decode steps (``spec_draft_steps_total``: the extension steps
    captured in each fused graph × its replays, masked turns included, and
    the eager warm-up turns); K2q8 likewise on the int8 engine."""
    from quorum_tpu_torch.backends.cuda_backend import CudaBackend
    from quorum_tpu_torch.config import Config
    from quorum_tpu_torch.engine.engine import (InferenceEngine, get_engine,
                                                shutdown_all_engines)
    from quorum_tpu_torch.models import transformer as tf
    from quorum_tpu_torch.models.model_config import resolve_spec
    from quorum_tpu_torch.ops.flash_attention import flash_prefill_attention
    from quorum_tpu_torch.ops.flash_decode import flash_decode_attention
    from quorum_tpu_torch.ops.flash_decode_q8 import flash_decode_q8_attention
    from quorum_tpu_torch.ops.sampling import SamplerConfig
    from quorum_tpu_torch.server.app import create_app

    model = "llama-tiny" if tiny else "llama-3-8b"
    draft_model = "llama-tiny" if tiny else "llama-3.2-1b"
    extra = "&max_seq=2048&device=cpu" if tiny else ("&device=cpu" if cpu else "")
    card = f"{device_info['name']} ({device_info['power_limit']})"
    greedy = SamplerConfig(temperature=0.0)
    _require_card_empty(torch, cpu, "spec")
    if not cpu:
        torch.cuda.reset_peak_memory_stats()
    # Every launch counter to 0 just before the phase's main path, read after.
    flash_prefill_attention.launches = 0
    flash_prefill_attention.launches_by_route.update(wgmma=0, fma=0)
    flash_decode_attention.launches = 0
    flash_decode_q8_attention.launches = 0
    finals: list[tuple] = []  # (engine, its metrics at the end, draft layers)

    def finish(eng):
        rt = eng._draft_rt
        finals.append((eng, eng.metrics(), rt.spec.n_layers if rt is not None else 0))

    def raw_for(url):
        return {"primary_backends": [{"name": "llama", "url": url}],
                "settings": {"timeout": SERVE_TIMEOUT_S}}

    def call(app, body):
        return asyncio.run(asyncio.wait_for(_call(app, body), SERVE_TIMEOUT_S))

    def body(content, max_tokens, stream=False, **knobs):
        b = {"model": model, "messages": [{"role": "user", "content": content}],
             "max_tokens": max_tokens, "stream": stream, "temperature": 0, **knobs}
        if stream:
            b["stream_options"] = {"include_usage": True}
        return b

    def timed_spec(eng):
        """CUDA events around each spec dispatch of ``eng``: [chunk, marks]."""
        recs = []
        dispatch = eng._dispatch_spec

        def timed(*a, **k):
            marks = None
            if not cpu:
                marks = (torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True))
                marks[0].record()
            c = dispatch(*a, **k)
            if marks:
                marks[1].record()
            recs.append([c, marks])
            return c

        eng._dispatch_spec = timed
        return recs

    def med(xs):
        return statistics.median(xs) if xs else None

    def bias_row(b):
        if not b:
            return None
        row = torch.zeros(vocab)
        for t, v in b.items():
            row[int(t)] = float(v)
        return row

    def spec_counts(m0, m1, one_row=False):
        keys = ("spec_turns_total", "spec_draft_tokens_total", "spec_accepted_total",
                "spec_overlapped_total")
        d = {k: m1[k] - m0[k] for k in keys}
        turns, drafted = d["spec_turns_total"], d["spec_draft_tokens_total"]
        # Per turn over every row it carried; a drafting row emits 1 +
        # its accepted drafts per turn (g + 1 at most).
        d["accepted_per_turn"] = d["spec_accepted_total"] / turns if turns else None
        d["acceptance"] = d["spec_accepted_total"] / drafted if drafted else None
        if one_row and turns:  # one row: the tokens each turn emitted
            d["tokens_per_turn"] = (d["spec_accepted_total"] + turns) / turns
        return d

    # ---- (a) prompt lookup, 32 layers -------------------------------------
    t_a = time.perf_counter()
    url = f"cuda://{model}?slots=4&decode_chunk=8&spec_decode=4{extra}"
    app = create_app(Config(raw=raw_for(url)))
    backend = app.state["registry"].backends[0]
    eng, tok = backend.engine, backend.tokenizer
    spec, vocab = eng.spec, eng.spec.vocab_size
    twin = InferenceEngine(spec, device=eng.device, params=eng.params, n_slots=4, decode_chunk=8)
    twin_app = create_app(Config(raw=raw_for(url)),
                          llama=CudaBackend("llama", twin, model=model, model_id=model))
    sep = "\n\n---\n\n"
    answer_bytes = 40 if tiny else 400
    agg_content = ("You have received the following responses regarding the user's query:\n"
                   + sep.join(_prompt(answer_bytes, 60 + i) for i in range(3))
                   + "\nSynthesize these responses into a single, comprehensive answer.")
    n_agg = 16 if tiny else 128
    m0 = eng.metrics()
    recs = timed_spec(eng)
    out_a = {}
    for stream in (False, True):
        out_a[stream] = _check_response(call(app, body(agg_content, n_agg, stream)),
                                        body(agg_content, n_agg, stream), tok, n_agg)
    require(out_a[False]["text"] == out_a[True]["text"],
            "spec: the streamed aggregation text differs from the non-streamed one")
    twin_agg = _check_response(call(twin_app, body(agg_content, n_agg)), body(agg_content, n_agg),
                               tok, n_agg)
    agg_ids = tok.encode(tok.render_chat([{"role": "user", "content": agg_content}]))
    audits = {}
    if twin_agg["text"] != out_a[False]["text"]:
        (a_ids, _), = _stream_all(twin, [twin.submit(agg_ids, max_new_tokens=n_agg,
                                                     sampler=greedy)])
        (b_ids, _), = _stream_all(eng, [eng.submit(agg_ids, max_new_tokens=n_agg,
                                                   sampler=greedy)])
        audits["aggregation"] = _spec_audit(torch, eng, agg_ids, a_ids, b_ids)
    else:
        audits["aggregation"] = {"equal": True}
    m_agg = eng.metrics()
    agg_turns = list(recs)
    # 4 at once: 2 greedy repetitive, 1 sampled, 1 penalized. Random weights
    # do not repeat text by themselves: the repetitive rows' logit_bias
    # (+100 on the prompt's own tokens) makes their continuation periodic,
    # so prompt lookup finds drafts.
    n4 = 48 if tiny else 64
    rep = ["ab ab ab ab " * (4 if tiny else 12), "the quorum answers " * (4 if tiny else 12)]

    def forced(text):
        return {str(t): 100 for t in sorted(set(tok.encode(text)))}

    bias = [forced("a"), forced("quorm ")]
    bodies4 = [body(rep[0], n4, logit_bias=bias[0]), body(rep[1], n4, logit_bias=bias[1]),
               body(_prompt(120 if tiny else 300, 71), n4, temperature=0.8, top_p=0.9, seed=7),
               body(_prompt(120 if tiny else 300, 72), n4, presence_penalty=0.6)]

    async def four(the_app):
        return await asyncio.gather(*[_call(the_app, b) for b in bodies4])

    twin_recs = _timed_dispatches(torch, twin, cpu)
    twin_subs, subs = _recorded_submits(twin), _recorded_submits(eng)
    want4 = [_check_response(r, b, tok, n4) for r, b in zip(
        asyncio.run(asyncio.wait_for(four(twin_app), 2 * SERVE_TIMEOUT_S)), bodies4)]
    n_before = len(recs)
    got4 = [_check_response(r, b, tok, n4) for r, b in zip(
        asyncio.run(asyncio.wait_for(four(app), 2 * SERVE_TIMEOUT_S)), bodies4)]
    four_turns = recs[n_before:]
    del twin.submit, eng.submit
    m_four = eng.metrics()
    names4 = ("greedy_repetitive_0", "greedy_repetitive_1", "sampled", "presence_penalty")
    app_exact4 = {name: w["text"] == g["text"] for name, w, g in zip(names4, want4, got4)}
    # Through the app each request was admitted as it arrived: its token ids
    # against the twin's, equal or the first divergence audited.
    require(len(subs) == len(twin_subs) == len(bodies4),
            f"spec: {len(subs)} and {len(twin_subs)} requests reached the engines")
    audits["through_app"] = _audit_requests(torch, eng, twin_subs, subs)
    # The same 4 co-batched on each engine (admitted in one turn), token ids
    # compared row by row: equal, or the first divergence audited.
    kws4 = []
    for b in bodies4:
        kws4.append((tok.encode(tok.render_chat(b["messages"])), dict(
            max_new_tokens=n4, seed=b.get("seed", 0),
            sampler=SamplerConfig(temperature=b["temperature"], top_p=b.get("top_p", 1.0)),
            presence_penalty=b.get("presence_penalty", 0.0),
            logit_bias=bias_row(b.get("logit_bias")))))

    def cobatched(e):
        with e._cond:
            reqs = [e.submit(ids, **kw) for ids, kw in kws4]
        return [t for t, _ in _stream_all(e, reqs)]

    want_ids, got_ids = cobatched(twin), cobatched(eng)
    exact4 = {}
    for name, b, (ids, kw), a_ids, b_ids in zip(names4, bodies4, kws4, want_ids, got_ids):
        exact4[name] = a_ids == b_ids
        audits[name] = _spec_audit(torch, eng, ids, a_ids, b_ids,
                                   temperature=b["temperature"], top_p=b.get("top_p", 1.0),
                                   seed=b.get("seed", 0), pp=b.get("presence_penalty", 0.0),
                                   bias=kw["logit_bias"])
    m_cob = eng.metrics()
    # history ≈ 6 000: one repetitive long prompt, greedy (chunked admission)
    long_content = "ab ab ab ab ab ab the long record " * (6 if tiny else 180)
    n_long = 48 if tiny else 64
    long_ids = tok.encode(tok.render_chat([{"role": "user", "content": long_content}]))
    long_kw = dict(max_new_tokens=n_long, sampler=greedy, logit_bias=bias_row(bias[0]))
    n_before = len(recs)
    (long_b, _), = _stream_all(eng, [eng.submit(long_ids, **long_kw)])
    (long_a, _), = _stream_all(twin, [twin.submit(long_ids, **long_kw)])
    audits["long"] = _spec_audit(torch, eng, long_ids, long_a, long_b,
                                 bias=long_kw["logit_bias"])
    long_turns = recs[n_before:]
    del eng._dispatch_spec
    m_a = eng.metrics()
    ms_all = _device_ms(torch, cpu, recs)

    def turn_ms(rows, sel):
        if ms_all is None:
            return None
        chosen = {id(r[0]) for r in sel}
        picked = [t for (c, _), t in zip(recs, ms_all)
                  if id(c) in chosen and len(c.active) == rows]
        return {"median_ms": med(picked[1:] or picked), "n": len(picked)}

    twin_ms = _device_ms(torch, cpu, twin_recs)
    del twin._dispatch_chunk
    plain_per_token = None
    if twin_ms:
        per = [t / 8 for (c, _), t in zip(twin_recs, twin_ms)
               if c.n_steps == 8 and c.n_chunks == 1 and len(c.active) == 4]
        plain_per_token = {"median_ms_per_token_4_rows": med(per[1:] or per), "n": len(per)}
    # Each greedy verify key's replay with no row active (the same kernels
    # as a turn: every row's forward runs, its writes masked), timed and
    # profiled, beside the turn's plain attention alone at its history
    # bucket: 32 layers of [4 rows, 5 queries] over [0, history).
    split = {}
    keys = sorted(k for k in (eng._graphs._graphs if eng._graphs else ())
                  if k[0] == "verify" and not k[2] and not k[3])
    if keys:
        from torch.profiler import ProfilerActivity, profile

        with eng._cond:
            require(not eng._inflight and not any(eng._slots), "spec: engine busy")
        mask = eng._mask.clone()
        eng._mask.zero_()
    for key in keys:
        hist = key[4]

        def replay(key=key, hist=hist):
            with torch.cuda.stream(eng._stream):
                eng._graphs.replay(key, lambda: eng._verify_program(4, False, False, False,
                                                                    hist), eng._warm_up)

        replay()
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        times = []
        for _ in range(5):
            with torch.cuda.stream(eng._stream):
                ev[0].record()
            replay()
            with torch.cuda.stream(eng._stream):
                ev[1].record()
            torch.cuda.synchronize()
            times.append(ev[0].elapsed_time(ev[1]))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            replay()
            torch.cuda.synchronize()
        groups: dict[str, float] = {}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", 0) or 0
            if us > 0:
                g = ("matmul" if any(f in e.key.lower() for f in _KERNEL_GROUPS[3][1])
                     else "other")
                groups[g] = groups.get(g, 0.0) + us / 1e3
        q = torch.randn((4, spec.n_heads, 5, spec.head_dim), dtype=getattr(torch, spec.dtype),
                        device=eng.device)
        pos = torch.arange(5, device=eng.device)[None, :] + torch.tensor(
            [hist // 2, hist - 8, hist // 4, hist - 40], device=eng.device)[:, None]
        ki = torch.arange(hist, device=eng.device)[None, None, :]
        vmask = (ki <= pos[:, :, None])[:, None, None]
        layer_ms = graph_ms([(lambda l=l: tf.attention(
            q, eng._ck[l][:, :, :hist], eng._cv[l][:, :, :hist], vmask))
            for l in range(spec.n_layers)])
        turn = statistics.median(times)
        split[str(key)] = {
            "replay_ms_no_row_active": turn,
            "profiler_ms_by_group": {k: round(v, 4) for k, v in groups.items()},
            "plain_verify_attention_ms": layer_ms * spec.n_layers,
            "attention_share_of_turn": layer_ms * spec.n_layers / turn if turn else None}
    if keys:
        eng._mask.copy_(mask)
    verify_captures = {str(k): round(v, 4) for k, v in (
        eng._graphs.capture_seconds_by_key.items() if eng._graphs else ())
        if k[0] in ("verify", "dfa_verify")}
    leg_a = {
        "aggregation_prompt_tokens": len(agg_ids),
        "aggregation": {"completion_tokens": out_a[False]["usage"]["completion_tokens"],
                        "seconds": round(out_a[False]["t_end"], 4),
                        "twin_seconds": round(twin_agg["t_end"], 4),
                        **spec_counts(m0, m_agg, one_row=True)},
        "four_at_once": {"exact_through_app": app_exact4, "exact_cobatched_ids": exact4,
                         **spec_counts(m_agg, m_four),
                         "seconds": [round(g["t_end"], 4) for g in got4],
                         "twin_seconds": [round(w["t_end"], 4) for w in want4]},
        "long": {"prompt_tokens": len(long_ids), **spec_counts(m_cob, m_a, one_row=True)},
        "audits": audits,
        "verify_turn_device_ms": {
            "history_le_2048_1_row": turn_ms(1, agg_turns),
            "history_le_2048_4_rows": turn_ms(4, four_turns),
            "history_6000_1_row": turn_ms(1, long_turns)},
        "twin_plain_chunk": plain_per_token,
        "verify_first_capture_s": verify_captures,
        "verify_split": split,
        "noise_ring_bytes": eng._noise_ring.numel() * 4,
        "seconds": round(time.perf_counter() - t_a, 3),
    }
    emit("spec", leg="prompt_lookup", model=model, layers=spec.n_layers, **leg_a,
         measured_on=card)
    require(m_a["spec_turns_total"] > 0 and m_a["spec_accepted_total"] > 0,
            "spec: prompt lookup never drafted an accepted token")
    finish(eng)
    finish(twin)
    del app, twin_app, backend
    eng.shutdown()
    twin.shutdown()
    shutdown_all_engines()
    del eng, twin
    _require_card_empty(torch, cpu, "spec (b)")

    # ---- (b) the fused draft loop, full width -----------------------------
    t_b = time.perf_counter()
    url_b = f"cuda://{model}?slots=4&decode_chunk=8&spec_model={draft_model}{extra}"
    app_b = create_app(Config(raw=raw_for(url_b)))
    eng_b = app_b.state["registry"].backends[0].engine
    rt = eng_b._draft_rt
    eng_b4 = InferenceEngine(eng_b.spec, device=eng_b.device, params=eng_b.params, n_slots=4,
                             decode_chunk=8, decode_loop=4, spec_decode=4, draft_spec=rt.spec,
                             draft_params=rt.params)
    content_b = _prompt(200 if tiny else 600, 81)
    ids_b = tok.encode(tok.render_chat([{"role": "user", "content": content_b}]))
    fused = {}
    toks_b = {}
    for name, e in (("decode_loop_1", eng_b), ("decode_loop_4", eng_b4)):
        m_b0 = e.metrics()
        recs_b = timed_spec(e)
        if name == "decode_loop_1":
            out_b = _check_response(call(app_b, body(content_b, n4)), body(content_b, n4), tok, n4)
        (toks_b[name], _), = _stream_all(e, [e.submit(ids_b, max_new_tokens=n4, sampler=greedy)])
        del e._dispatch_spec
        m_b1 = e.metrics()
        ms_b = _device_ms(torch, cpu, recs_b)
        turns = sum(c.n_chunks for c, _ in recs_b)
        # Per dispatched turn (masked turns of a C-turn graph included); a
        # row's first dispatch also carries its eager draft resync, which
        # the median leaves out.
        per_turn = [t / c.n_chunks for (c, _), t in zip(recs_b, ms_b or [])]
        fused[name] = {**spec_counts(m_b0, m_b1),
                       "dispatches": len(recs_b), "turns_dispatched": turns,
                       "ms_per_turn_median": med(per_turn[1:] or per_turn),
                       "dispatch_ms_max": max(ms_b) if ms_b else None,
                       "first_capture_s": {str(k): round(v, 4) for k, v in (
                           e._graphs.capture_seconds_by_key.items() if e._graphs else ())
                           if k[0] == "spec_loop"}}
    require(toks_b["decode_loop_1"] == toks_b["decode_loop_4"],
            "spec: the fused loop's tokens differ between decode_loop 1 and 4")
    emit("spec", leg="fused_draft", model=model, draft=draft_model,
         draft_layers=rt.spec.n_layers, draft_head_dim=rt.spec.head_dim,
         app_completion_tokens=out_b["usage"]["completion_tokens"], fused=fused,
         acceptance_note="random weights: the draft and the target agree by chance only",
         seconds=round(time.perf_counter() - t_b, 3), measured_on=card)
    require(all(f["spec_turns_total"] > 0 for f in fused.values()),
            "spec: the fused draft loop ran no turn")
    finish(eng_b)
    finish(eng_b4)
    del app_b
    eng_b4.shutdown()
    shutdown_all_engines()
    del eng_b, eng_b4, rt
    _require_card_empty(torch, cpu, "spec (c)")

    # ---- (c) an oracle draft and an int8 target, 8 layers -----------------
    t_c = time.perf_counter()
    spec8 = resolve_spec(model, {"n_layers": "2" if tiny else "8",
                                 **({"max_seq": "2048"} if tiny else {})})
    dev = "cpu" if cpu else None
    eng_c = get_engine(spec8, device=dev, seed=0, n_slots=4, decode_chunk=8, spec_decode=4,
                       draft_spec=spec8, draft_seed=0)
    twin_c = InferenceEngine(spec8, device=eng_c.device, params=eng_c.params, n_slots=4,
                             decode_chunk=8)
    prompts_c = [agg_ids, tok.encode(_prompt(300, 91)), tok.encode(rep[1])]
    want_c = _stream_all(twin_c, [twin_c.submit(p, max_new_tokens=n4, sampler=greedy)
                                  for p in prompts_c])
    mc0 = eng_c.metrics()
    got_c = _stream_all(eng_c, [eng_c.submit(p, max_new_tokens=n4, sampler=greedy)
                                for p in prompts_c])
    mc1 = eng_c.metrics()
    audit_c = [_spec_audit(torch, eng_c, p, w, g)
               for p, (w, _), (g, _) in zip(prompts_c, want_c, got_c)]
    oracle = spec_counts(mc0, mc1)
    require(oracle["spec_turns_total"] > 0
            and oracle["spec_accepted_total"] >= 0.5 * 4 * oracle["spec_turns_total"],
            f"spec: the oracle draft accepted too little: {oracle}")
    finish(eng_c)
    finish(twin_c)
    twin_c.shutdown()
    shutdown_all_engines()
    del eng_c, twin_c
    q8 = get_engine(spec8, device=dev, seed=0, n_slots=4, decode_chunk=8, spec_decode=4,
                    quant="int8", kv_quant="int8")
    q8_twin = InferenceEngine(spec8, device=q8.device, params=q8.params, n_slots=4,
                              decode_chunk=8, quant="int8", kv_quant="int8")
    q8_prompts = [tok.encode(rep[0]), tok.encode(rep[1])]
    want_q = _stream_all(q8_twin, [q8_twin.submit(p, max_new_tokens=n4, sampler=greedy)
                                   for p in q8_prompts])
    got_q = _stream_all(q8, [q8.submit(p, max_new_tokens=n4, sampler=greedy)
                             for p in q8_prompts])
    audit_q = [_spec_audit(torch, q8, p, w, g)
               for p, (w, _), (g, _) in zip(q8_prompts, want_q, got_q)]
    mq = q8.metrics()
    emit("spec", leg="oracle_and_int8", layers=spec8.n_layers, oracle=oracle,
         oracle_audits=audit_c, int8={"audits": audit_q, **spec_counts(
             {k: 0 for k in mq}, mq)},
         seconds=round(time.perf_counter() - t_c, 3), measured_on=card)
    require(mq["spec_turns_total"] > 0, "spec: the int8 target never verified")
    finish(q8)
    finish(q8_twin)
    q8_twin.shutdown()
    shutdown_all_engines()
    del q8, q8_twin
    _require_card_empty(torch, cpu, "spec (d)")

    # ---- (d) speculative_aggregation: true --------------------------------
    t_d = time.perf_counter()
    layers_d = "&n_layers=2" if tiny else "&n_layers=8"
    urls = _fanout_urls(model, extra, True, knobs=f"{layers_d}&spec_decode=4")
    raw_d = {"settings": {"timeout": SERVE_TIMEOUT_S},
             "primary_backends": [{"name": f"LLM{i + 1}", "url": u, "model": model}
                                  for i, u in enumerate(urls)],
             "iterations": {"aggregation": {"strategy": "aggregate"}},
             "strategy": {"aggregate": {"aggregator_backend": "LLM1",
                                        "speculative_aggregation": True}}}
    agg_app = create_app(Config(raw=raw_d))
    eng_d = agg_app.state["registry"].backends[0].engine
    md0 = eng_d.metrics()
    agg = _parallel_complete(call(agg_app, {"model": model, "max_tokens": 32, "temperature": 0,
                                            "messages": [{"role": "user",
                                                          "content": _prompt(300, 5)}]}))
    require(agg["degraded"] is None and agg["text"], f"spec: aggregate degraded {agg}")
    md1 = eng_d.metrics()
    emit("spec", leg="speculative_aggregation", layers=eng_d.spec.n_layers,
         members=eng_d.members, aggregate_s=round(agg["t_end"], 4),
         engine_spec=spec_counts(md0, md1), seconds=round(time.perf_counter() - t_d, 3),
         measured_on=card)
    finish(eng_d)
    del agg_app
    shutdown_all_engines()
    del eng_d

    # ---- launch counts over the phase ---------------------------------------
    k1 = sum(e.spec.n_layers * m["admission_dispatches_total"] for e, m, _ in finals)
    k2 = sum(e.spec.n_layers * _k2_steps(m) + dl * m["spec_draft_steps_total"]
             for e, m, dl in finals if not e.kv_quant)
    k2q8 = sum(e.spec.n_layers * _k2_steps(m) for e, m, _ in finals if e.kv_quant)
    launches = {"flash_prefill": flash_prefill_attention.launches,
                "flash_decode": flash_decode_attention.launches,
                "flash_decode_q8": flash_decode_q8_attention.launches}
    if not cpu:
        require(launches == {"flash_prefill": k1, "flash_decode": k2, "flash_decode_q8": k2q8},
                f"spec: launches {launches} != expected K1 {k1}, K2 {k2}, K2q8 {k2q8}")
    draft_steps = sum(m["spec_draft_steps_total"] for _, m, _ in finals)
    info = {"launches": launches, "draft_decode_steps": draft_steps,
            "peak_mem_gb": (None if cpu else round(torch.cuda.max_memory_allocated() / 1e9, 3)),
            "measured_on": card}
    emit("spec", leg="launches", **info)
    return info


_KERNEL_GROUPS = (("K1 flash_prefill", ("prefill_wgmma_kernel", "flash_prefill_kernel")),
                  ("K2 flash_decode", ("flash_decode_mma_kernel", "flash_decode_kernel")),
                  ("K2q8 flash_decode_q8", ("q8_decode_cluster_kernel",)),
                  ("matmul", ("gemm", "gemv", "cutlass", "xmma", "nvjet", "cublas", "splitk")),
                  ("sort (top-p/top-k)", ("sort", "radix", "scan")))


def _paged_gather_bytes(spec, history: int) -> int:
    """Leg (b)'s prediction, written before the first chip run: the paged
    program gathers each layer's window of both sides, reading and writing
    4 rows × history × kv heads × head_dim × 2 B per side, every layer a
    step."""
    return 2 * 2 * 4 * history * spec.n_kv_heads * spec.head_dim * 2 * spec.n_layers


def _paged_streams(eng, prompts, n_tok: int, sampler, **knobs) -> list:
    """Submit ``prompts`` at once and stream them: each request's handle
    (prompt, delivered tokens) after its stream ends."""
    reqs = [eng.submit(p, max_new_tokens=n_tok, sampler=sampler, seed=i, **knobs)
            for i, p in enumerate(prompts)]
    _stream_all(eng, reqs)
    return reqs


def _paged_equal(torch, name: str, dense, paged, a_reqs, b_reqs) -> dict:
    """Each paged stream equals its dense twin's, or their first divergence
    is an audited near-tie of the card's own cache-free forward."""
    audits = []
    for a, b in zip(a_reqs, b_reqs):
        n = len(a.prompt_ids)
        audits.append(_spec_audit(torch, paged, a.prompt_ids, a.hist[n:], b.hist[n:],
                                  temperature=b.sampler.temperature, top_p=b.sampler.top_p,
                                  seed=b.seed))
    return {"leg": name, "streams": len(a_reqs),
            "tokens": [len(b.hist) - len(b.prompt_ids) for b in b_reqs],
            "equal": [x["equal"] for x in audits],
            "near_ties": [x for x in audits if not x["equal"]],
            "paged_keys": sorted({str(k) for k in paged.dispatched_keys})[:8]}


def _paged_dispatch_ms(torch, cpu: bool, eng, prompts, n_tok: int, greedy, hist) -> dict:
    """Device ms of the engine's 8-step dispatches over all 4 rows (a
    paged engine's at history bucket ``hist`` only), from CUDA events
    around each replay on the engine's stream."""
    recs = _timed_dispatches(torch, eng, cpu)
    _paged_streams(eng, prompts, n_tok, greedy)
    del eng._dispatch_chunk
    ms = _device_ms(torch, cpu, recs)
    keep = [i for i, (c, _) in enumerate(recs)
            if len(c.active) == 4 and c.n_steps == 8 and c.n_chunks == 1]
    keys = sorted({str(k) for k in eng.dispatched_keys if k[0] == "paged"})
    if ms is None:
        return {"dispatches": len(keep), "ms": None, "keys": keys}
    vals = sorted(ms[i] for i in keep)
    require(vals, f"paged: no 4-row 8-step dispatch at history {hist}")
    return {"dispatches": len(vals), "median_ms": statistics.median(vals),
            "min_ms": vals[0], "keys": keys}


def _ttft(eng, prompt, sampler, n_tok: int = 4, **knobs) -> tuple[float, list[int]]:
    t0 = time.perf_counter()
    it = eng.generate_stream(prompt, max_new_tokens=n_tok, sampler=sampler, **knobs)
    first = next(it)
    t1 = time.perf_counter()
    return t1 - t0, [first] + list(it)


def phase_paged(torch, cpu: bool, tiny: bool, device_info: dict) -> dict:
    """Paged KV (``kv_pages=1``) and the host prefix store
    (``prefix_store=host``) on llama-3-8b at full width, cut to 8 layers to
    keep the script inside its time (bf16, random weights of seed 0,
    max_seq 8192, 4 slots, the default scheduler; the
    default page is the 512-token segment and the default pool the dense
    rectangle's 64 pages):

    (a) equality: the serve phase's four prompts (57–3017 tokens, greedy,
        32 tokens) through a dense engine and a paged one, then with
        kv_quant=int8 (K2q8 on the gathered windows), with spec_decode=4 on
        a repetitive prompt (verify turns over paged rows) and one
        json_object request: streams equal, or the first divergence an
        audited near-tie (``_spec_audit``);
    (b) the gather's cost: device ms of an 8-step, 4-row dispatch, paged
        against dense, at history buckets 2 048 and 8 192;
    (c) aliasing: a two-turn chat (≈ 1 600-token turn 1) on the paged
        engine: alias hits, COW copies (0 at 512-token pages, 1 at 1 024),
        turn 2's TTFT against a cold admission of the same prompt;
    (d) capacity: llama-3.1-8b (8 layers) at max_seq 131 072, kv_pages=1,
        32 slots, a 256-page pool (4.3 GB): 32 concurrent streams of 300–3 000-token
        prompts × 32 tokens, all served; peak pages, peak memory,
        aggregate tok/s, beside the dense rectangle's computed size;
    (e) the store: prefix_store=host on a dense and a paged engine; a
        ≈ 4 000-token prompt, every slot churned, the prompt again:
        restored tokens, restore seconds and GB/s, snapshot bytes, TTFT
        against a cold admission, streams equal to the cold stream;

    with the launch counts of K1, K2 and K2q8 over the phase, exact."""
    from quorum_tpu_torch.constrain import compile_response_format
    from quorum_tpu_torch.engine.engine import InferenceEngine
    from quorum_tpu_torch.engine.tokenizer import ByteTokenizer
    from quorum_tpu_torch.models.init import init_params
    from quorum_tpu_torch.models.model_config import resolve_spec
    from quorum_tpu_torch.ops.flash_attention import flash_prefill_attention
    from quorum_tpu_torch.ops.flash_decode import flash_decode_attention
    from quorum_tpu_torch.ops.flash_decode_q8 import flash_decode_q8_attention
    from quorum_tpu_torch.ops.sampling import SamplerConfig

    model = "llama-tiny" if tiny else "llama-3-8b"
    dev = "cpu" if cpu else "cuda"
    spec = resolve_spec(model, {"max_seq": "2048"} if tiny else {"n_layers": "8"})
    n_tok = 16 if tiny else 32
    _require_card_empty(torch, cpu, "paged")
    if not cpu:
        torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    params = init_params(spec, 0, dev)
    tok = ByteTokenizer(spec.vocab_size)
    greedy = SamplerConfig(temperature=0.0)
    gen = torch.Generator().manual_seed(13)

    def rand(n):
        return torch.randint(3, spec.vocab_size, (n,), generator=gen).tolist()

    prompts = [tok.encode(tok.render_chat(b["messages"])) for b in _serve_bodies(model, tiny)]
    engines: list = []
    by_kind = {"bf16": [], "int8": []}

    def engine(spec_=spec, **kw):
        eng = InferenceEngine(spec_, device=dev, params=params, n_slots=kw.pop("n_slots", 4), **kw)
        engines.append(eng)
        by_kind["int8" if kw.get("kv_quant") else "bf16"].append(eng)
        return eng

    def done(*engs):
        for e in engs:
            e._final_metrics = e.metrics()
            e.shutdown()

    # Every launch counter to 0 just before the main path, read just after.
    flash_prefill_attention.launches = 0
    flash_decode_attention.launches = 0
    flash_decode_q8_attention.launches = 0

    # (a) equality, bf16 then int8, spec and constrained
    legs = []
    dense, paged = engine(), engine(kv_pages=True)
    require(paged.kv_page_size == min(512, spec.max_seq)
            and paged.kv_pool_pages == 4 * spec.max_seq // paged.kv_page_size,
            f"paged defaults: page {paged.kv_page_size}, pool {paged.kv_pool_pages}")
    legs.append(_paged_equal(torch, "bf16", dense, paged,
                             _paged_streams(dense, prompts, n_tok, greedy),
                             _paged_streams(paged, prompts, n_tok, greedy)))
    g = compile_response_format({"type": "json_object"}, tok, spec.vocab_size)
    cprompt = [prompts[2]]
    legs.append(_paged_equal(
        torch, "constrained", dense, paged,
        _paged_streams(dense, cprompt, 48, greedy, eos_id=tok.eos_id, grammar=g),
        _paged_streams(paged, cprompt, 48, greedy, eos_id=tok.eos_id, grammar=g)))
    require(any(k[0] == "paged" and "dfa" in k for k in paged.dispatched_keys),
            "paged: the constrained request never ran the paged dfa program")
    q_dense, q_paged = engine(kv_quant="int8"), engine(kv_quant="int8", kv_pages=True)
    legs.append(_paged_equal(torch, "int8", q_dense, q_paged,
                             _paged_streams(q_dense, prompts, n_tok, greedy),
                             _paged_streams(q_paged, prompts, n_tok, greedy)))
    done(q_dense, q_paged)
    s_dense, s_paged = engine(spec_decode=4), engine(spec_decode=4, kv_pages=True)
    rep = tok.encode(tok.render_chat([{"role": "user", "content": (
        "Summarize: " + _prompt(120 if tiny else 400, 7) + " ") * 4}]))
    legs.append(_paged_equal(torch, "spec_decode=4", s_dense, s_paged,
                             _paged_streams(s_dense, [rep], 64, greedy),
                             _paged_streams(s_paged, [rep], 64, greedy)))
    spec_turns = s_paged.metrics()["spec_turns_total"]
    require(spec_turns > 0 and any(k[0] == "paged" and k[1] == "verify"
                                   for k in s_paged.dispatched_keys),
            f"paged: no verify turn over paged rows ({spec_turns})")
    done(s_dense, s_paged)
    for leg in legs:
        emit("paged_equal", **leg)

    # (b) the gather's cost: 8-step dispatches of 4 rows at two buckets
    gather = {}
    for hist in ((256, 1024) if tiny else (2048, 8192)):
        n_p = hist - hist // 8 - 48  # planned + 8 stays inside the bucket for 48 tokens
        rows = [rand(n_p - 16 * i) for i in range(4)]
        gather[hist] = {"dense": _paged_dispatch_ms(torch, cpu, dense, rows, 48, greedy, hist),
                        "paged": _paged_dispatch_ms(torch, cpu, paged, rows, 48, greedy, hist)}
        g_ = gather[hist]
        if not cpu:
            g_["paged_minus_dense_ms_per_step"] = (
                g_["paged"]["median_ms"] - g_["dense"]["median_ms"]) / 8
            g_["paged_minus_dense_min_ms_per_step"] = (
                g_["paged"]["min_ms"] - g_["dense"]["min_ms"]) / 8
            g_["gather_bytes_per_step"] = _paged_gather_bytes(spec, hist)
            g_["predicted_ms_per_step"] = g_["gather_bytes_per_step"] / HBM_BYTES_PER_S * 1e3
        emit("paged_gather", history=hist, **g_)

    # (c) aliasing: a two-turn chat, 512-token pages then 1 024
    alias = {}
    turn1 = rand(1600)
    for ps in (None, 1024):
        eng = paged if ps is None else engine(kv_pages=True, kv_page_size=ps)
        m0 = eng.metrics()
        reply = eng.generate(turn1, max_new_tokens=n_tok, sampler=greedy).token_ids
        turn2 = turn1 + reply + rand(40)
        m1 = eng.metrics()
        ttft_reuse, toks_reuse = _ttft(eng, turn2, greedy)
        m2 = eng.metrics()
        eng.prefix_cache = False
        ttft_cold, toks_cold = _ttft(eng, turn2, greedy)
        eng.prefix_cache = True
        a = {"page_size": eng.kv_page_size, "turn1_tokens": len(turn1),
             "turn2_tokens": len(turn2),
             "alias_hits": m2["kv_page_alias_hits_total"] - m1["kv_page_alias_hits_total"],
             "cow_copies": m2["kv_page_cow_copies_total"] - m1["kv_page_cow_copies_total"],
             "reused_tokens": m2["prefix_tokens_saved_total"] - m1["prefix_tokens_saved_total"],
             "turn2_ttft_s_reuse": ttft_reuse, "turn2_ttft_s_cold": ttft_cold,
             "turn2_equal_cold": toks_reuse == toks_cold,
             "turn1_alias_hits": m1["kv_page_alias_hits_total"] - m0["kv_page_alias_hits_total"]}
        want_cow = 1 if a["reused_tokens"] % eng.kv_page_size else 0
        require(a["alias_hits"] >= 1 and a["cow_copies"] == want_cow,
                f"paged aliasing at {eng.kv_page_size}-token pages: {a}")
        alias[eng.kv_page_size] = a
        emit("paged_alias", **a)
        if ps is not None:
            done(eng)

    # (e) the store, dense then paged, against the dense engine as cold
    store = {}
    long_p = rand(1200 if tiny else 4000)
    dense.prefix_cache = False
    cold_ttft, cold_toks = _ttft(dense, long_p, greedy, n_tok)
    for kv_pages in (False, True):
        eng = engine(kv_pages=kv_pages, prefix_store="host")
        first = eng.generate(long_p, max_new_tokens=n_tok, sampler=greedy).token_ids
        eng.drain_prefix_store()
        snap_prompt = eng.metrics()["prefix_store_snapshot_bytes_total"]
        _paged_streams(eng, [rand(600) for _ in range(4)], 8, greedy)
        eng.drain_prefix_store()
        m0 = eng.metrics()
        ttft, toks = _ttft(eng, long_p, greedy, n_tok)
        m1 = eng.metrics()
        restored = m1["prefix_store_restored_tokens_total"] - m0["prefix_store_restored_tokens_total"]
        r_s = m1["prefix_store_restore_seconds_total"] - m0["prefix_store_restore_seconds_total"]
        r_b = m1["prefix_store_restore_bytes_total"] - m0["prefix_store_restore_bytes_total"]
        st = {"kv_pages": kv_pages, "prompt_tokens": len(long_p),
              "hits": m1["prefix_store_hits_total"] - m0["prefix_store_hits_total"],
              "restored_tokens": restored, "restore_s": r_s, "restore_bytes": r_b,
              "restore_gb_per_s": (r_b / r_s / 1e9) if r_s else None,
              "snapshot_bytes_prompt": snap_prompt,
              "snapshot_bytes": m1["prefix_store_snapshot_bytes_total"],
              "store_bytes": m1["prefix_store_bytes"], "store_entries": m1["prefix_store_entries"],
              "ttft_s_restore": ttft, "ttft_s_cold": cold_ttft,
              "stream_equal_cold": toks == cold_toks, "first_equal_cold": first == cold_toks}
        require(st["hits"] == 1 and restored >= len(long_p) - 2 * eng.prefill_chunk,
                f"store leg: {st}")
        require(toks == cold_toks, f"store leg: restored stream differs from the cold one ({st})")
        store["paged" if kv_pages else "dense"] = st
        emit("paged_store", **st)
        done(eng)
    done(dense, paged)

    # (d) capacity: llama-3.1-8b at its 131 072-token window from a page pool
    cap_seq = 8192 if tiny else 131072
    spec31 = resolve_spec("llama-tiny" if tiny else "llama-3.1-8b",
                          {"max_seq": str(cap_seq), "n_layers": str(spec.n_layers)})
    require(all(getattr(spec31, f) == getattr(spec, f) for f in
                ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab_size")),
            "capacity leg: llama-3.1-8b's shapes differ from the weights built")
    big = engine(spec31, n_slots=32, kv_pages=True, kv_pool_pages=256)
    pool_bytes = (256 * big.kv_page_size * spec.n_layers * spec.n_kv_heads * spec.head_dim
                  * 2 * 2)
    rect = lambda slots: slots * cap_seq * spec.n_layers * spec.n_kv_heads * spec.head_dim * 4  # noqa: E731
    lens = [30 + 9 * i for i in range(32)] if tiny else [300 + 87 * i for i in range(32)]
    peak_pages = [0]
    stop = [False]

    def watch():
        while not stop[0]:
            peak_pages[0] = max(peak_pages[0], big.metrics()["kv_pages_allocated"])
            time.sleep(0.01)

    import threading

    th = threading.Thread(target=watch, daemon=True)
    th.start()
    t0 = time.perf_counter()
    reqs = _paged_streams(big, [rand(n) for n in lens], n_tok, greedy)
    wall = time.perf_counter() - t0
    stop[0] = True
    th.join()
    served = [len(r.hist) - len(r.prompt_ids) for r in reqs]
    require(all(n == n_tok for n in served), f"capacity leg: streams ended early {served}")
    cap = {"model": "llama-tiny" if tiny else "llama-3.1-8b",
           "max_seq": cap_seq, "slots": 32, "page_size": big.kv_page_size,
           "pool_pages": 256, "pool_gb": pool_bytes / 1e9, "streams": 32,
           "prompt_tokens": [lens[0], lens[-1]], "tokens_each": n_tok,
           "peak_pages_allocated": peak_pages[0], "wall_s": wall,
           "aggregate_tok_per_s": sum(served) / wall,
           "peak_mem_gb": None if cpu else torch.cuda.max_memory_allocated() / 1e9,
           "dense_rectangle_gb_4_slots": rect(4) / 1e9,
           "dense_rectangle_gb_32_slots": rect(32) / 1e9}
    emit("paged_capacity", **cap)
    done(big)
    if not cpu:
        torch.cuda.synchronize()
    launches = {"flash_prefill": flash_prefill_attention.launches,
                "flash_decode": flash_decode_attention.launches,
                "flash_decode_q8": flash_decode_q8_attention.launches}
    single = sum(e._final_metrics["admission_dispatches_total"] for e in engines)
    k2 = sum(_k2_steps(e._final_metrics) for e in by_kind["bf16"])
    k2q8 = sum(_k2_steps(e._final_metrics) for e in by_kind["int8"])
    if not cpu:
        want = {"flash_prefill": spec.n_layers * single, "flash_decode": spec.n_layers * k2,
                "flash_decode_q8": spec.n_layers * k2q8}
        require(launches == want, f"paged launches {launches} != {want}")
        require(all(n > 0 for n in launches.values()),
                f"paged: a kernel of the path was never launched ({launches})")
    del params, engines, dense, paged, big
    info = {"model": model, "layers": spec.n_layers, "dtype": spec.dtype, "slots": 4,
            "equal_legs": [(x["leg"], all(x["equal"])) for x in legs],
            "gather": gather, "alias": alias, "store": store, "capacity": cap,
            "launches": launches, "seconds": time.perf_counter() - t_phase,
            "measured_on": f"{device_info['name']} ({device_info['power_limit']})"}
    emit("paged", **{k: v for k, v in info.items() if k not in ("gather", "alias", "store",
                                                                "capacity")})
    return info


def phase_profile(torch, cpu: bool, run_requests, card: str, decode_fn,
                  of: str = "serve", decode_kernels: tuple = ("flash_decode",)) -> None:
    """The same 4 concurrent requests again under torch.profiler: device time
    by kernel group and the device's busy share of the wall time. The decode
    attention must show one kernel per name in ``decode_kernels`` (K2 and
    K2q8: one each), each launched once per counted call. Matrix
    products on int8 operands are their own group."""
    if cpu:
        run_requests()  # rehearse the path; there is no device to trace
        emit("profile", of=of, skipped="cpu rehearsal: no device trace")
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
        if group == "matmul" and any(f in name.lower() for f in ("s8", "i8", "int8", "imma")):
            group = "matmul int8"
        groups[group] = groups.get(group, 0.0) + dev_us / 1e3
        kernels.append((dev_us / 1e3, ev.count, name[:80]))
    busy_ms = sum(groups.values())
    k2 = [(n, name) for _, n, name in kernels if any(f in name for f in decode_kernels)]
    require(len(k2) == len(decode_kernels) and all(n == decode_fn.launches for n, _ in k2),
            f"decode attention in the profile: {k2}, {decode_fn.launches} calls; want "
            f"{len(decode_kernels)} kernel(s), each once per call")
    kernels.sort(reverse=True)
    emit("profile", of=of, wall_ms=wall * 1e3, device_busy_ms=busy_ms,
         device_busy_share=busy_ms / (wall * 1e3) if wall > 0 else None,
         device_ms_by_group={g: round(v, 3) for g, v in sorted(groups.items())},
         k2_kernels=[{"count": n, "name": name} for n, name in k2],
         top_kernels=[{"ms": round(ms, 3), "count": n, "name": name}
                      for ms, n, name in kernels[:12]],
         measured_on=card)


# K1's and K2's kernel names as a profiler trace shows them.
_K1_NAMES = _KERNEL_GROUPS[0][1]
_K2_NAMES = _KERNEL_GROUPS[1][1]


def _engine_bytes(eng) -> int:
    """Device bytes of an engine's weights and KV cache."""
    def leaves(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                yield from leaves(v)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                yield from leaves(v)
        elif hasattr(tree, "nbytes"):
            yield tree

    return sum(t.nbytes for t in leaves([eng.params, eng._ck, eng._cv]))


def _counts(text: str, family: str, labels: str = "") -> float:
    import re

    m = re.search(rf"^{family}_count{re.escape(labels)} (\S+)$", text, re.M)
    return float(m.group(1)) if m else 0.0


def _quiet(eng) -> None:
    """Wait until ``eng`` holds no request and no dispatch (its scheduler
    thread then waits on its condition)."""
    t0 = time.perf_counter()
    while True:
        m = eng.metrics()
        if not (m["busy_slots"] or m["admitting"] or m["pending"] or m["inflight_chunks"]):
            break
        require(time.perf_counter() - t0 < SERVE_TIMEOUT_S, "the engine never went idle")
        time.sleep(0.01)
    time.sleep(0.1)


def _scrape(torch, cpu: bool, app, path: str = "/metrics") -> tuple[dict, float]:
    """One GET of ``path`` timed on the host; on the card under
    ``set_sync_debug_mode("error")``, so a device sync in it raises (the
    engines must be idle: the mode holds for every thread)."""
    for b in app.state["registry"].backends:
        _quiet(b.engine)
    if not cpu:
        torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        resp = asyncio.run(_call(app, {}, method="GET", path=path, raw=b""))
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        if not cpu:
            torch.cuda.set_sync_debug_mode("default")
    require(resp["status"] == 200, f"GET {path}: {resp['status']} {resp['data'][:200]!r}")
    return resp, ms


def _trace_kernels(profile_dir: str) -> dict:
    """Kernel events of a /debug/profile Chrome trace: K1's and K2's, and
    all kernels."""
    import collections

    with open(os.path.join(profile_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {"kernel_events": len(kernels),
            "k1": sum(1 for n in kernels if any(f in n for f in _K1_NAMES)),
            "k2": sum(1 for n in kernels if any(f in n for f in _K2_NAMES)),
            "categories": dict(collections.Counter(str(e.get("cat")) for e in events))}


def phase_observe(torch, cpu: bool, tiny: bool, device_info: dict) -> dict:
    """Serving surfaces and observability (the app's /ready, /metrics,
    /debug/* routes, the flight recorder, CUDA-event device time, the
    failure breaker, fault sites with verify containment, hot reload):

    (a) serving under observation, full width (llama-3-8b, 32 layers, bf16,
        4 slots, decode_chunk 8): the serve phase's 4 chats through the app,
        each with its own ``traceparent`` — every trace found by its request
        id with that trace id and the engine's spans; /metrics' histogram
        counts up by the requests served; /metrics, /health and
        /debug/telemetry scraped under ``set_sync_debug_mode("error")``
        (a device sync raises) and timed on the host; 4 greedy rows × 64
        tokens with the recorder on, off, off, on (streams equal; device and
        host ms per 8-step 4-row dispatch); each such dispatch's CUDA-event
        time (``quorum_tpu_dispatch_device_seconds{family="plain"}``)
        against replays of the same captured graph timed alone;
        ``POST /debug/profile?seconds=1`` during a live stream with an
        admission inside the window: the trace names K2 and K1, and a second
        POST meanwhile gets 409;
    (b) faults and the breaker (8 layers): ``engine.decode`` armed three
        times opens the breaker, /ready is a 503 with Retry-After, a chat
        sheds with 503; after the cool-down (set to 1 s here) a probe admits
        and the breaker closes; device memory does not grow;
    (c) verify containment (8 layers, ``spec_decode=4``, an oracle draft):
        ``engine.verify`` armed once fails the turn's 2 rows alone, and the
        queued request's stream equals its fault-free twin's;
    (d) hot reload (8 layers): a config edit drops one of two engines, and
        ``memory_allocated`` falls by at least its weights and cache;
    (e) prefix chunks (8 layers, ``prefix_store=host``): GET from one
        engine's app, PUT into another's, the same ≈ 4 000-token prompt
        there: restored tokens, TTFT against cold, streams equal;

    with K1 and K2 launches over the phase exact."""
    import tempfile
    import uuid

    from quorum_tpu_torch import faults
    from quorum_tpu_torch.backends.cuda_backend import CudaBackend
    from quorum_tpu_torch.config import Config, load_config
    from quorum_tpu_torch.engine.engine import _ENGINES, InferenceEngine, shutdown_all_engines
    from quorum_tpu_torch.models.init import init_params
    from quorum_tpu_torch.models.model_config import resolve_spec
    from quorum_tpu_torch.ops.flash_attention import flash_prefill_attention
    from quorum_tpu_torch.ops.flash_decode import flash_decode_attention
    from quorum_tpu_torch.ops.sampling import SamplerConfig
    from quorum_tpu_torch.server.app import create_app
    from quorum_tpu_torch.telemetry.metrics import validate_exposition
    from quorum_tpu_torch.telemetry.recorder import RECORDER

    model = "llama-tiny" if tiny else "llama-3-8b"
    dev = "cpu" if cpu else "cuda"
    dev_q = "&device=cpu" if cpu else ""
    card = f"{device_info['name']} ({device_info['power_limit']})"
    _require_card_empty(torch, cpu, "observe")
    t_phase = time.perf_counter()
    greedy = SamplerConfig(temperature=0.0)
    gen = torch.Generator().manual_seed(14)
    ledger: list = []  # (layers, metrics at the start, engine) of every engine of the phase

    def track(eng):
        ledger.append((eng.spec.n_layers, eng.metrics(), eng))
        return eng

    def rand(vocab, n):
        return torch.randint(3, vocab, (n,), generator=gen).tolist()

    def run(coro, timeout=2 * SERVE_TIMEOUT_S):
        return asyncio.run(asyncio.wait_for(coro, timeout))

    # Every launch counter to 0 just before the main path, read at the end.
    flash_prefill_attention.launches = 0
    flash_decode_attention.launches = 0

    # (a) serving under observation
    url = f"cuda://{model}?slots=4&decode_chunk=8{dev_q}"
    app = create_app(Config(raw={"primary_backends": [{"name": "llama", "url": url}],
                                 "settings": {"timeout": SERVE_TIMEOUT_S}}))
    backend = app.state["registry"].backends[0]
    eng = track(backend.engine)
    bodies = _serve_bodies(model, tiny)
    trace_ids = [uuid.uuid4().hex for _ in bodies]
    before, _ = _scrape(torch, cpu, app)
    RECORDER.reset()
    async def traced():
        return await asyncio.gather(*[
            _call(app, b, headers={"traceparent": f"00-{tid}-{uuid.uuid4().hex[:16]}-01"})
            for b, tid in zip(bodies, trace_ids)])

    resps = run(traced())
    max_tokens = 16 if tiny else 32
    for r, b in zip(resps, bodies):
        _check_response(r, b, backend.tokenizer, max_tokens)
    traces = []
    for r, b, tid in zip(resps, bodies, trace_ids):
        rid = r["headers"]["x-request-id"]
        require(r["headers"]["traceparent"].split("-")[1] == tid,
                f"traceparent not echoed: {r['headers'].get('traceparent')}")
        t = json.loads(run(_call(app, {}, method="GET", path=f"/debug/traces/{rid}",
                                 raw=b""))["data"])
        names = [s["name"] for s in t["spans"]]
        want = {"queue-wait", "prefill", "decode"} | ({"sse-flush"} if b["stream"] else
                                                       {"fanout", "backend-generate"})
        require(t["trace_id"] == tid and t["status"] == 200 and want <= set(names),
                f"trace {rid}: trace id {t.get('trace_id')} (sent {tid}), spans {names}")
        traces.append({"stream": b["stream"], "spans": len(names), "ttft_ms": t["ttft_ms"],
                       "duration_ms": t["duration_ms"]})
    after, _ = _scrape(torch, cpu, app)
    text, text0 = after["data"].decode(), before["data"].decode()
    problems = validate_exposition(text)
    require(not problems, f"/metrics does not validate: {problems[:5]}")
    deltas = {fam: _counts(text, fam, lab) - _counts(text0, fam, lab) for fam, lab in (
        ("quorum_tpu_request_duration_seconds", '{status="2xx"}'),
        ("quorum_tpu_queue_wait_seconds", ""), ("quorum_tpu_ttft_seconds", ""))}
    require(deltas == {"quorum_tpu_request_duration_seconds": 4,
                       "quorum_tpu_queue_wait_seconds": 4, "quorum_tpu_ttft_seconds": 2},
            f"/metrics histogram counts after 4 requests (2 streamed): {deltas}")
    scrape_ms = {path: statistics.median(_scrape(torch, cpu, app, path)[1] for _ in range(7))
                 for path in ("/metrics", "/health", "/debug/telemetry")}
    emit("observe_serve", requests=len(bodies), traces=traces, histogram_deltas=deltas,
         scrape_host_ms=scrape_ms, scrape_synced_device=False, metrics_bytes=len(text),
         measured_on=card)

    # 4 greedy rows × 64 tokens: the recorder on, off, off, on.
    vocab = eng.spec.vocab_size
    four = [rand(vocab, 40 if tiny else 200) for _ in range(4)]
    rounds = {}
    dispatch = eng._dispatch_chunk

    def timed(active):
        marks = None
        if not cpu:
            marks = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            marks[0].record()
        t0 = time.perf_counter()
        c = dispatch(active)
        host = time.perf_counter() - t0
        if marks:
            marks[1].record()
        recs.append((c, marks, host))
        return c

    eng._dispatch_chunk = timed
    try:
        for i, enabled in enumerate((True, False, False, True)):
            RECORDER.enabled = enabled
            recs: list = []
            with eng._cond:  # one admission turn for the 4 rows
                reqs = [eng.submit(p, max_new_tokens=64, sampler=greedy) for p in four]
            toks = [t for t, _ in _stream_all(eng, reqs)]
            if not cpu:
                torch.cuda.synchronize()
            keep = [(m, h) for c, m, h in recs
                    if len(c.active) == 4 and c.n_steps == 8 and c.n_chunks == 1]
            require(keep, "observe: no 4-row 8-step dispatch")
            rounds[i] = {"recorder": enabled, "tokens": toks,
                         "device_ms": None if cpu else statistics.median(
                             a.elapsed_time(b) for (a, b), _ in keep),
                         "host_ms": statistics.median(h for _, h in keep) * 1e3,
                         "dispatches": len(keep)}
    finally:
        RECORDER.enabled = True
        del eng._dispatch_chunk
    require(all(r["tokens"] == rounds[0]["tokens"] for r in rounds.values()),
            "observe: streams differ with the recorder on and off")
    on = [r for r in rounds.values() if r["recorder"]]
    off = [r for r in rounds.values() if not r["recorder"]]

    def med(rs, k):
        vals = [r[k] for r in rs if r[k] is not None]
        return statistics.median(vals) if vals else None

    recorder_leg = {"device_ms_on": med(on, "device_ms"), "device_ms_off": med(off, "device_ms"),
                    "host_ms_on": med(on, "host_ms"), "host_ms_off": med(off, "host_ms"),
                    "by_round": [{k: v for k, v in r.items() if k != "tokens"}
                                 for r in rounds.values()]}
    if not cpu:
        recorder_leg["device_on_over_off"] = (recorder_leg["device_ms_on"]
                                              / recorder_leg["device_ms_off"])
    # Each plain 4-row 8-step dispatch's CUDA-event time, from the recorder's
    # reap events, against replays of the same graph timed alone.
    events = [e for e in RECORDER.snapshot() if e.get("engine") == eng._tag]
    plain8 = {e["seq"] for e in events if e["kind"] == "dispatch" and e["family"] == "plain"
              and e["steps"] == 8 and e["chunks"] == 1 and len(e["rids"]) == 4}
    event_ms = sorted(e["device_s"] * 1e3 for e in events
                      if e["kind"] == "reap" and e["seq"] in plain8)
    require(event_ms, "observe: no plain 8-step 4-row reap on the recorder")
    family = {"event_ms_median": statistics.median(event_ms), "event_ms_min": event_ms[0],
              "samples": len(event_ms), "latency_model": eng.latency.snapshot()}
    if not cpu:
        key = (8, 1, False, False)
        require(key in eng._graphs, f"observe: no captured graph for {key}")
        graph = eng._graphs._graphs[key][0]
        pairs = []
        with torch.cuda.stream(eng._stream):  # the engine is idle: its rows are dead
            for _ in range(12):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                graph.replay()
                b.record()
                pairs.append((a, b))
        torch.cuda.synchronize()
        family["graph_timer_ms"] = statistics.median(a.elapsed_time(b) for a, b in pairs)
        family["event_over_graph_timer"] = family["event_ms_median"] / family["graph_timer_ms"]
    emit("observe_device_time", recorder=recorder_leg, plain_8_step_4_rows=family,
         measured_on=card)

    # /debug/profile during a live stream, an admission inside the window.
    # EOS banned: the stream runs its whole length, through the window.
    long_body = {"model": model, "stream": True, "max_tokens": 64 if tiny else 320,
                 "temperature": 0, "logit_bias": {str(backend.tokenizer.eos_id): -100},
                 "messages": [{"role": "user", "content": _prompt(60, 7)}]}
    short_body = {"model": model, "max_tokens": 8, "temperature": 0,
                  "messages": [{"role": "user", "content": _prompt(50, 8)}]}
    seconds = 0.5 if cpu else 1.0

    async def profiled():
        chunks0 = eng.metrics()["decode_chunks_total"]
        live = asyncio.create_task(_call(app, long_body))
        while eng.metrics()["decode_chunks_total"] < chunks0 + 3:  # the stream decodes
            await asyncio.sleep(0.01)
        first = asyncio.create_task(_call(app, {}, path="/debug/profile", raw=b"",
                                          query=f"seconds={seconds}"))
        await asyncio.sleep(0.3)
        second = await _call(app, {}, path="/debug/profile", raw=b"", query="seconds=1")
        await asyncio.sleep(0.2)
        short = await _call(app, short_body)
        return await first, second, short, await live

    t_leg = time.perf_counter()
    first, second, short, live = run(profiled())
    leg_s = time.perf_counter() - t_leg
    require(first["status"] == 200, f"/debug/profile: {first['status']} {first['data'][:300]!r}")
    require(second["status"] == 409 and second["headers"].get("retry-after") == "5"
            and json.loads(second["data"])["error"]["type"] == "conflict_error",
            f"a second /debug/profile must be a 409: {second['status']} {second['data'][:200]!r}")
    require(short["status"] == 200 and live["status"] == 200, "profiled requests failed")
    prof_dir = json.loads(first["data"])["profile_dir"]
    profile = {"seconds": seconds, "second_post": second["status"], "leg_s": leg_s}
    if not cpu:
        t_parse = time.perf_counter()
        profile.update(_trace_kernels(prof_dir))
        profile["trace_mb"] = os.path.getsize(os.path.join(prof_dir, "trace.json")) / 1e6
        profile["parse_s"] = time.perf_counter() - t_parse
        require(profile["k2"] > 0 and profile["k1"] > 0,
                f"the profile must name K2 and K1 (an admission landed in it): {profile}")
    emit("observe_profile", **profile, measured_on=card)
    final = [(n, m0, e.metrics()) for n, m0, e in ledger]
    ledger.clear()
    del app, backend, eng
    shutdown_all_engines()
    _require_card_empty(torch, cpu, "observe (8 layers)")

    # (b)–(e) at 8 layers (llama-tiny keeps its 2)
    spec8 = resolve_spec(model, {"max_seq": "2048"} if tiny else {"n_layers": "8"})
    params8 = init_params(spec8, 0, dev)
    vocab = spec8.vocab_size

    def engine(**kw):
        return track(InferenceEngine(spec8, device=dev, params=params8,
                                     n_slots=kw.pop("n_slots", 4), **kw))

    def app_of(eng):
        return create_app(Config(raw={"primary_backends": [{"name": "llama", "url": url}],
                                      "settings": {"timeout": SERVE_TIMEOUT_S}}),
                          llama=CudaBackend("llama", eng, model=model, model_id=model))

    def mem() -> int:
        if cpu:
            return 0
        gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    chat = {"model": model, "max_tokens": 8, "temperature": 0,
            "messages": [{"role": "user", "content": _prompt(40, 9)}]}

    # (b) faults and the breaker
    eng = engine()
    app = app_of(eng)
    require(run(_call(app, chat))["status"] == 200, "observe breaker: the warm-up chat failed")
    mem0 = mem()
    eng.breaker.cooldown = 1.0
    failed = []
    for _ in range(3):
        faults.arm("engine.decode", times=1)
        failed.append(run(_call(app, chat))["status"])
    faults.disarm()
    ready = run(_call(app, {}, method="GET", path="/ready", raw=b""))
    shed = run(_call(app, chat))
    state_open = eng.breaker.state
    time.sleep(1.1)
    probe = run(_call(app, chat))
    ready2 = run(_call(app, {}, method="GET", path="/ready", raw=b""))
    grown = mem() - mem0
    breaker = {"failed_statuses": failed, "state_after_faults": state_open,
               "ready_status": ready["status"], "ready_retry_after": ready["headers"].get(
                   "retry-after"), "shed_status": shed["status"],
               "shed_retry_after": shed["headers"].get("retry-after"),
               "probe_status": probe["status"], "state_after_probe": eng.breaker.state,
               "ready_after_probe": ready2["status"], "rebuilds": eng.n_rebuilds,
               "device_bytes_grown": grown}
    require(failed == [500] * 3 and state_open == "open" and ready["status"] == 503
            and ready["headers"].get("retry-after") and shed["status"] == 503
            and shed["headers"].get("retry-after") and probe["status"] == 200
            and eng.breaker.state == "closed" and ready2["status"] == 200
            and grown <= 1 << 20, f"observe breaker: {breaker}")
    emit("observe_breaker", **breaker, measured_on=card)
    final += [(n, m0, e.metrics()) for n, m0, e in ledger]
    ledger.clear()
    eng.shutdown()
    del eng, app

    # (c) verify containment on a spec_decode=4 engine
    eng = engine(n_slots=2, spec_decode=4)
    eng._draft = lambda req, g: [1] * g  # every row drafts: a verify turn first
    survivor = rand(vocab, 120)
    twin = eng.generate(survivor, max_new_tokens=24, sampler=greedy).token_ids
    m0 = eng.metrics()
    faults.arm("engine.verify", times=1)
    with eng._cond:  # two victims admitted in one turn, the survivor queued
        victims = [eng.submit(rand(vocab, 100 + i), max_new_tokens=24, sampler=greedy)
                   for i in range(2)]
        late = eng.submit(survivor, max_new_tokens=24, sampler=greedy)
    errors = []
    for v in victims:
        try:
            list(eng.stream_results(v))
        except faults.FaultInjected as e:
            errors.append(type(e).__name__)
    got = list(eng.stream_results(late))
    faults.disarm()
    m1 = eng.metrics()
    contain = {"victims_failed": errors, "survivor_equals_twin": got == twin[:len(got)]
               and len(got) == len(twin),
               "failures": m1["failures_total"] - m0["failures_total"],
               "rebuilds": m1["rebuilds_total"] - m0["rebuilds_total"],
               "spec_turns": m1["spec_turns_total"] - m0["spec_turns_total"]}
    require(errors == ["FaultInjected"] * 2 and contain["survivor_equals_twin"]
            and contain["failures"] == 2 and contain["rebuilds"] == 0
            and contain["spec_turns"] > 0, f"observe verify containment: {contain}")
    emit("observe_containment", **contain, measured_on=card)
    final += [(n, m0, e.metrics()) for n, m0, e in ledger]
    ledger.clear()
    eng.shutdown()
    del eng

    # (d) hot reload: an edit drops one of two engines
    import yaml

    work = tempfile.mkdtemp(prefix="observe-")
    cfg_path = os.path.join(work, "config.yaml")

    def write(seeds):
        with open(cfg_path, "w") as f:
            yaml.safe_dump({"settings": {"timeout": SERVE_TIMEOUT_S}, "primary_backends": [
                {"name": f"b{s}", "model": model,
                 "url": f"cuda://{model}?n_layers={spec8.n_layers}&seed={s}&slots=4{dev_q}"}
                for s in seeds]}, f)
        st = os.stat(cfg_path)
        os.utime(cfg_path, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))

    write((1, 2))
    app = create_app(load_config(cfg_path), watch_config=True)
    dropped = app.state["registry"].get("b2").engine
    for e in (app.state["registry"].get("b1").engine, dropped):
        track(e)
    require(run(_call(app, chat))["status"] == 200, "observe reload: the first chat failed")
    final += [(n, m0, e.metrics()) for n, m0, e in ledger]  # their counts end here
    ledger.clear()
    drop_bytes, pool = _engine_bytes(dropped), dropped.metrics()["decode_graph_pool_bytes"]
    mem0 = mem()
    write((1,))
    time.sleep(0.6)  # the watcher stats the file at most every 0.5 s
    models = json.loads(run(_call(app, {}, method="GET", path="/v1/models", raw=b""))["data"])
    freed = mem0 - mem()
    reload = {"backends_after": [m["owned_by"] for m in models["data"]],
              "dropped_weights_and_cache_bytes": drop_bytes, "dropped_graph_pool_bytes": pool,
              "freed_bytes": freed, "evicted": not any(e is dropped for e in _ENGINES.values()),
              "dropped_params_released": dropped.params is None}
    require(reload["backends_after"] == ["b1"] and reload["evicted"]
            and reload["dropped_params_released"] and (cpu or freed >= drop_bytes),
            f"observe reload: {reload}")
    emit("observe_reload", **reload, measured_on=card)
    del app, dropped
    shutdown_all_engines()

    # (e) prefix chunks: export from one engine's app, import into another's
    e1, e2 = engine(prefix_store="host"), engine(prefix_store="host")
    app1, app2 = app_of(e1), app_of(e2)
    long_p = rand(vocab, 1200 if tiny else 4000)
    n_tok = 16
    for e in (e1, e2):  # first captures and segment shapes, off the timed admissions
        e.generate(rand(vocab, 1100 if tiny else 3900), max_new_tokens=n_tok, sampler=greedy)
    cold_ttft, cold = _ttft(e1, long_p, greedy, n_tok)
    e1.drain_prefix_store()
    exported = run(_call(app1, {}, method="GET", path="/debug/prefix/chunks", raw=b""))
    require(exported["status"] == 200, f"prefix export: {exported['status']}")
    imported = run(_call(app2, {}, method="PUT", path="/debug/prefix/chunks",
                         raw=exported["data"]))
    require(imported["status"] == 200, f"prefix import: {imported['data'][:300]!r}")
    stats = json.loads(imported["data"])
    hits0, m_restore = e2.prefix_store_hits, e2.metrics()
    warm_ttft, warm = _ttft(e2, long_p, greedy, n_tok)
    m_restored = e2.metrics()
    chunks = {"blob_bytes": len(exported["data"]), "import": stats,
              "restored_tokens": (m_restored["prefix_store_restored_tokens_total"]
                                  - m_restore["prefix_store_restored_tokens_total"]),
              "restore_s": (m_restored["prefix_store_restore_seconds_total"]
                            - m_restore["prefix_store_restore_seconds_total"]),
              "store_hits": e2.prefix_store_hits - hits0, "ttft_s_restored": warm_ttft,
              "ttft_s_cold": cold_ttft, "streams_equal": warm == cold}
    require(chunks["store_hits"] == 1 and chunks["streams_equal"]
            and stats["tokens_imported"] > 0, f"observe prefix chunks: {chunks}")
    emit("observe_prefix_chunks", **chunks, measured_on=card)
    final += [(n, m0, e.metrics()) for n, m0, e in ledger]
    ledger.clear()
    for e in (e1, e2):  # built here, not through get_engine: not in its registry
        e.shutdown()
    del e1, e2, app1, app2
    shutdown_all_engines()

    if not cpu:
        torch.cuda.synchronize()
    launches = {"flash_prefill": flash_prefill_attention.launches,
                "flash_decode": flash_decode_attention.launches}
    want = {"flash_prefill": sum(n * (m1["admission_dispatches_total"]
                                      - m0["admission_dispatches_total"]) for n, m0, m1 in final),
            "flash_decode": sum(n * (_k2_steps(m1) - _k2_steps(m0)) for n, m0, m1 in final)}
    if not cpu:
        require(launches == want, f"observe launches {launches} != {want}")
        require(all(v > 0 for v in launches.values()),
                f"observe: a kernel of the path was never launched ({launches})")
    info = {"model": model, "layers": [32 if not tiny else 2, spec8.n_layers],
            "launches": launches, "seconds": time.perf_counter() - t_phase,
            "recorder": {k: v for k, v in recorder_leg.items() if k != "by_round"},
            "plain_dispatch": {k: v for k, v in family.items() if k != "latency_model"},
            "scrape_host_ms": scrape_ms, "profile": profile, "breaker": breaker,
            "containment": contain, "reload": reload,
            "prefix_chunks": {k: v for k, v in chunks.items() if k != "import"},
            "measured_on": card}
    emit("observe", **info)
    return info


class KillSwitch:
    """One replica's app behind a switch that makes it die in place (the
    process stays up): once dead, every response ``send`` raises
    ``ConnectionResetError``, so the port's socket server drops the
    connection mid-response (the router's client reads an incomplete
    stream, as from a killed process), the app closes the stream (its
    backend cancels the engine request) and the listener closes. With
    ``watch`` set it records the token ids (``qt_tokens``) of every stream it
    sends, and ``die_after_tokens`` kills it once one stream carried that
    many. The port's router tests use it too (tests import this file)."""

    def __init__(self, app, host: str = "127.0.0.1"):
        self.app = app
        self.host = host
        self.server = None
        self.port = 0
        self.dead = False
        self.watch = False
        self.die_after_tokens: int | None = None
        self.streams: list[list[int]] = []

    async def start(self) -> str:
        from quorum_tpu_torch.server.serve import start_server

        self.server = await start_server(self, self.host, self.port)
        self.port = self.server.sockets[0].getsockname()[1]
        return f"http://{self.host}:{self.port}"

    async def revive(self) -> None:
        """Back from the dead on the same port (the router's URL)."""
        self.dead, self.die_after_tokens = False, None
        await self.start()

    def _die(self) -> None:
        self.dead = True
        if self.server is not None:
            self.server.close()

    async def __call__(self, scope, receive, send):
        if self.dead:
            raise ConnectionResetError("replica killed")
        ids: list[int] | None = None
        if self.watch and scope.get("path", "").endswith("/chat/completions"):
            ids = []
            self.streams.append(ids)

        async def guarded(message):
            if self.dead:
                raise ConnectionResetError("replica killed")
            if ids is not None and message["type"] == "http.response.body":
                for line in (message.get("body") or b"").split(b"\n"):
                    if line.startswith(b"data: {"):
                        ids.extend(json.loads(line[6:]).get("qt_tokens") or [])
            await send(message)
            if (self.die_after_tokens is not None and ids is not None
                    and len(ids) >= self.die_after_tokens):
                self._die()

        await self.app(scope, receive, guarded)


async def _sse(client, url: str, body: dict) -> dict:
    """One streamed chat: status, headers, parsed events, each frame's
    arrival time, TTFT (first content frame)."""
    t0 = time.perf_counter()
    frames, times = [], []
    async with client.stream("POST", url, json=body) as resp:
        status, headers = resp.status_code, dict(resp.headers)
        buf = b""
        async for chunk in resp.aiter_bytes():
            t = time.perf_counter() - t0
            buf += chunk
            while b"\n\n" in buf:
                frame, buf = buf.split(b"\n\n", 1)
                for line in frame.split(b"\n"):
                    if line.startswith(b"data: "):
                        frames.append(line[6:])
                        times.append(t)
    require(status == 200, f"stream {url}: status {status} {b''.join(frames)[:300]!r}")
    require(frames and frames[-1] == b"[DONE]", f"stream {url}: no [DONE]")
    events = [json.loads(f) for f in frames[:-1]]
    content_t = [t for t, e in zip(times, events)
                 if any((c.get("delta") or {}).get("content") for c in e.get("choices") or [])]
    return {"headers": headers, "events": events, "times": times[:-1],
            "content_times": content_t, "ttft_s": content_t[0] if content_t else None,
            "text": "".join((c.get("delta") or {}).get("content") or ""
                            for e in events for c in e.get("choices") or []),
            "t_end": time.perf_counter() - t0}


async def _chat_json(client, url: str, body: dict) -> dict:
    r = await client.post(url, json=body)
    require(r.status_code == 200, f"chat {url}: {r.status_code} {r.text[:300]}")
    return {"headers": dict(r.headers), "body": r.json(),
            "text": r.json()["choices"][0]["message"]["content"]}


def phase_router(torch, cpu: bool, tiny: bool, device_info: dict) -> dict:
    """The router tier in front of three ``cuda://`` replicas: the port's app
    over its own ``InferenceEngine`` each (llama-3-8b at full width, cut to
    8 layers to keep the script inside its time, bf16, 4
    slots × 8 192 positions, ``prefix_store=host``, one weight set, seed 0),
    every replica and the router served by the port's socket server
    (httpx + h11, real loopback sockets). A replica dies in place through
    ``KillSwitch``. Legs, each checked:

    (a) affinity: 4 conversations × 3 turns (prompts 200–1 500 bytes):
        later turns on their first turn's replica, hit and miss counters;
        turn 2's prefix hit and TTFT against turn 1's; the router's own
        first-byte cost (TTFT through it minus straight to the same
        replica, median of 8, order alternated);
    (d) migration after (a): ``POST /router/migrate`` from a conversation's
        replica to another (chains, bytes, seconds, GB/s); its next turn on
        the target is a store hit equal to a cold twin on the third;
    (e) quorum 2 and 3, streamed and not (members equal each member's
        direct answer, outcome full); quorum 2 with a member killed
        mid-stream (resumed on the spare, full); quorum 3 with one killed
        (degraded, stream_broken, still served);
    (b) a 256-token stream whose replica dies after 64 tokens: resumed on
        the next candidate, text and token ids equal to a cold twin's, the
        resume counted once, the dead engine with no busy slot; the gap;
    (c) drain of a replica holding 2 live streams: both parked and resumed
        elsewhere, texts equal to their cold twins';
    (f) the fleet timeline: the router plus one process per replica; a
        routed request's router event and its replica's admission and
        dispatch events joined on its trace id, aligned;

    K1 = layers × single-shot admissions and K2 = layers × (decode +
    warm-up steps) over the three engines exactly, K2q8 = 0, K2's ticket
    counters at 0; peak memory; the phase's seconds."""
    import httpx

    from quorum_tpu_torch import observability as obs
    from quorum_tpu_torch.backends.cuda_backend import CudaBackend
    from quorum_tpu_torch.config import Config
    from quorum_tpu_torch.engine.engine import InferenceEngine, shutdown_all_engines
    from quorum_tpu_torch.engine.tokenizer import ByteTokenizer, render_chat
    from quorum_tpu_torch.models.init import init_params
    from quorum_tpu_torch.models.model_config import resolve_spec
    from quorum_tpu_torch.ops.flash_attention import flash_prefill_attention
    from quorum_tpu_torch.ops.flash_decode import flash_decode_attention, ticket_counters
    from quorum_tpu_torch.ops.flash_decode_q8 import flash_decode_q8_attention
    from quorum_tpu_torch.router import affinity
    from quorum_tpu_torch.router.app import RouterConfig, create_router_app
    from quorum_tpu_torch.server.app import create_app
    from quorum_tpu_torch.server.serve import start_server

    model = "llama-tiny" if tiny else "llama-3-8b"
    dev = "cpu" if cpu else "cuda"
    card = f"{device_info['name']} ({device_info['power_limit']})"
    names = ("r0", "r1", "r2")
    sep = "\n\n---\n\n"  # RouterConfig.quorum_separator's default
    emit("router_transport", transport="sockets: httpx client, h11 server (the port's "
         "server/serve.py), loopback", httpx=httpx.__version__)
    _require_card_empty(torch, cpu, "router")
    t_phase = time.perf_counter()
    if not cpu:
        torch.cuda.reset_peak_memory_stats()
    spec = resolve_spec(model, {"max_seq": "2048"} if tiny else {"n_layers": "8"})
    params = init_params(spec, 0, dev)
    engines = [InferenceEngine(spec, device=dev, params=params, n_slots=4,
                               prefix_store="host") for _ in names]
    build_s = time.perf_counter() - t_phase
    tag = {e._tag: n for e, n in zip(engines, names)}
    by_name = dict(zip(names, engines))
    app_cfg = Config(raw={"primary_backends": [{"name": "L", "url": f"x://{model}"}],
                          "settings": {"timeout": SERVE_TIMEOUT_S}})
    switches = {n: KillSwitch(create_app(app_cfg, watch_config=False,
                                          L=CudaBackend(n, e, model=model, model_id=model)))
                for n, e in by_name.items()}
    auth = {"Authorization": "Bearer smoke"}
    tok = ByteTokenizer(spec.vocab_size)

    def body(msgs, max_tokens: int, **kw) -> dict:
        return {"model": model, "messages": msgs, "max_tokens": max_tokens,
                "temperature": 0, **kw}

    def user(n_bytes: int, seed: int) -> list[dict]:
        return [{"role": "user", "content": _prompt(n_bytes, seed)}]

    def counters() -> dict:
        return {name: dict(getattr(obs, name)._series) for name in (
            "ROUTER_AFFINITY_HITS", "ROUTER_AFFINITY_MISSES", "ROUTER_STREAM_RESUMES",
            "ROUTER_MIGRATED_BYTES", "ROUTER_MIGRATED_CHAINS", "QUORUM_REQUESTS",
            "QUORUM_DEGRADED", "ROUTER_FAILOVERS")}

    def moved(c0: dict) -> dict:
        out = {}
        for name, series in counters().items():
            d = {"|".join(f"{k}={v}" for k, v in key) or "total": val - c0[name].get(key, 0.0)
                 for key, val in series.items() if val != c0[name].get(key, 0.0)}
            if d:
                out[name] = d
        return out

    class Router:
        """The port's router over the three replicas, on its own socket."""

        def __init__(self, urls, **kw):
            self.cfg = RouterConfig(replicas=list(zip(names, urls)), timeout=SERVE_TIMEOUT_S,
                                    **{"ready_interval": 0.0, **kw})
            self.app = create_router_app(self.cfg)
            self.mgr = self.app.state["replica_set"]

        async def __aenter__(self):
            self.server = await start_server(self.app, "127.0.0.1", 0)
            self.url = f"http://127.0.0.1:{self.server.sockets[0].getsockname()[1]}"
            return self

        async def __aexit__(self, *exc):
            await self.mgr.aclose()
            self.server.close()

        def order(self, msgs) -> list[str]:
            key = affinity.conversation_key({"messages": msgs}, self.cfg.affinity_chunk)
            return self.mgr.ring.candidates(key)

    async def quiet(name: str) -> int:
        """Wait until the engine of ``name`` holds no busy slot; return it."""
        eng = by_name[name]
        deadline = time.perf_counter() + 60
        while eng.metrics()["busy_slots"] and time.perf_counter() < deadline:
            await asyncio.sleep(0.05)
        return eng.metrics()["busy_slots"]

    # Every launch counter to 0 just before the main path, read just after.
    flash_prefill_attention.launches = 0
    flash_prefill_attention.launches_by_route.update(wgmma=0, fma=0)
    flash_decode_attention.launches = 0
    flash_decode_q8_attention.launches = 0
    m0 = [e.metrics() for e in engines]
    c_phase = counters()

    async def main() -> dict:
        urls = [await switches[n].start() for n in names]
        rep = {n: u for n, u in zip(names, urls)}
        out: dict = {"leg_s": {}}
        t_leg = time.perf_counter()

        def lap(name: str) -> None:
            nonlocal t_leg
            now = time.perf_counter()
            out["leg_s"][name] = now - t_leg
            t_leg = now

        async with httpx.AsyncClient(timeout=SERVE_TIMEOUT_S, headers=auth) as client:
            # (a) affinity
            async with Router(urls) as rt:
                chat = f"{rt.url}/v1/chat/completions"
                c0 = counters()
                convs = [user(n, 100 + i) for i, n in enumerate((200, 600, 1000, 1500))]
                homes: dict[int, str] = {}
                turns = []
                for turn in range(3):
                    for i, msgs in enumerate(convs):
                        home = homes.get(i)
                        mb = by_name[home].metrics() if home else None
                        r = await _sse(client, chat, body(msgs, 24, stream=True))
                        got = r["headers"]["x-routed-to"]
                        homes.setdefault(i, got)
                        require(got == homes[i], f"router affinity: conversation {i} turn "
                                                 f"{turn} went to {got}, not {homes[i]}")
                        require(got == rt.order(msgs)[0], f"router affinity: {got} is not "
                                                          "the conversation's ring primary")
                        row = {"conversation": i, "turn": turn + 1, "replica": got,
                               "prompt_tokens": len(tok.encode(render_chat(msgs))),
                               "ttft_s": r["ttft_s"]}
                        if mb is not None:
                            ma = by_name[got].metrics()
                            row["reuse_tokens"] = (
                                ma["prefix_tokens_saved_total"] - mb["prefix_tokens_saved_total"]
                                + ma["prefix_store_restored_tokens_total"]
                                - mb["prefix_store_restored_tokens_total"])
                        turns.append(row)
                        convs[i] = msgs + [
                            {"role": "assistant", "content": r["text"]},
                            {"role": "user", "content": _prompt(60, 200 + 10 * i + turn)}]
                aff = moved(c0)
                require(aff.get("ROUTER_AFFINITY_HITS") == {"total": 12.0}
                        and "ROUTER_AFFINITY_MISSES" not in aff,
                        f"router affinity counters {aff} (12 hits, 0 misses)")
                turn2 = [t for t in turns if t["turn"] == 2]
                # reuse is aligned to the 512-token segment: a prompt past one
                # segment must reuse at least one
                long_t2 = [t for t in turn2 if t["prompt_tokens"] > engines[0].prefill_chunk]
                require(long_t2 and all(t["reuse_tokens"] > 0 for t in long_t2),
                        f"router affinity: turn 2 past a segment without a prefix hit {turn2}")
                ttft1 = {t["conversation"]: t["ttft_s"] for t in turns if t["turn"] == 1}
                out["affinity"] = {
                    "homes": homes, "counters": aff,
                    "turns": turns,
                    "turn2_vs_turn1_ttft_s": {t["conversation"]: [t["ttft_s"],
                                                                  ttft1[t["conversation"]]]
                                              for t in turn2}}
                # the router's own first-byte cost
                diffs, pairs = [], []
                for i in range(8):
                    msgs = user(300, 300 + i)
                    b = body(msgs, 2, stream=True)
                    home = rt.order(msgs)[0]
                    legs = [("router", chat), ("direct", f"{rep[home]}/v1/chat/completions")]
                    if i % 2:
                        legs.reverse()
                    got = {}
                    for kind, url in legs:
                        r = await _sse(client, url, b)
                        got[kind] = r["ttft_s"]
                        if kind == "router":
                            require(r["headers"]["x-routed-to"] == home, "first-byte: placement")
                        b = body(user(300, 300 + i), 2, stream=True)
                    diffs.append(got["router"] - got["direct"])
                    pairs.append(got)
                out["first_byte"] = {"router_minus_direct_ttft_s_median": statistics.median(diffs),
                                     "pairs": pairs, "prompt_bytes": 300}
                lap("affinity")

                # (d) migration: the 1 500-byte conversation's replica to another
                src = homes[3]
                dst, third = [n for n in rt.order(convs[3]) if n != src]
                by_name[src].drain_prefix_store()
                c0 = counters()
                t0 = time.perf_counter()
                mig = await client.post(f"{rt.url}/router/migrate?from={src}&to={dst}")
                mig_s = time.perf_counter() - t0
                require(mig.status_code == 200, f"migrate: {mig.status_code} {mig.text[:300]}")
                mig_moved = moved(c0)
                nbytes = mig_moved.get("ROUTER_MIGRATED_BYTES", {}).get("total", 0.0)
                require(mig.json()["migrated_chains"] >= 1 and nbytes > 0,
                        f"migrate moved nothing: {mig.json()}")
                nxt = convs[3] + []
                hits0 = by_name[dst].prefix_store_hits
                warm = await _chat_json(client, f"{rep[dst]}/v1/chat/completions",
                                        body(nxt, 16))
                cold = await _chat_json(client, f"{rep[third]}/v1/chat/completions",
                                        body(nxt, 16))
                out["migration"] = {
                    "from": src, "to": dst, "cold_twin_on": third,
                    "chains": mig.json()["migrated_chains"], "bytes": nbytes,
                    "seconds": mig_s, "gb_per_s": nbytes / mig_s / 1e9,
                    "store_hit_on_target": by_name[dst].prefix_store_hits - hits0,
                    "text_equals_cold_twin": warm["text"] == cold["text"]}
                require(out["migration"]["store_hit_on_target"] == 1
                        and out["migration"]["text_equals_cold_twin"],
                        f"migration: {out['migration']}")
                lap("migration")

            # (e) quorum
            async with Router(urls) as rt:
                chat = f"{rt.url}/v1/chat/completions"
                qrows = []
                for m in (2, 3):
                    for stream in (False, True):
                        msgs = user(400, 500 + 2 * m + stream)
                        b = body(msgs, 48, quorum=m, stream=stream)
                        c0 = counters()
                        if stream:
                            r = await _sse(client, chat, b)
                            members = [
                                "".join((c.get("delta") or {}).get("content") or ""
                                        for e in r["events"]
                                        if e.get("id") == f"chatcmpl-parallel-{i}"
                                        for c in e.get("choices") or [])
                                for i in range(m)]
                            final = [e for e in r["events"]
                                     if e.get("id") == "chatcmpl-parallel-final"]
                            combined = final[0]["choices"][0]["delta"]["content"]
                            hdr = r["headers"]
                        else:
                            r = await _chat_json(client, chat, b)
                            combined, hdr = r["text"], r["headers"]
                            members = combined.split(sep)
                        assigned = hdr["x-quorum-replicas"].split(",")
                        direct = [(await _chat_json(client, f"{rep[n]}/v1/chat/completions",
                                                    body(msgs, 48)))["text"] for n in assigned]
                        q = moved(c0)
                        row = {"quorum": m, "stream": stream, "replicas": assigned,
                               "outcome": q.get("QUORUM_REQUESTS"),
                               "members_equal_direct": members == direct,
                               "combined_is_join": combined == sep.join(direct)}
                        qrows.append(row)
                        require(len(set(assigned)) == m and row["members_equal_direct"]
                                and row["combined_is_join"]
                                and q.get("QUORUM_REQUESTS") == {"outcome=full": 1.0}
                                and "QUORUM_DEGRADED" not in q, f"quorum: {row} {q}")
                # quorum 2, a member killed mid-stream: resumed on the spare
                kills = []
                for m, spare in ((2, True), (3, False)):
                    msgs = user(400, 600 + m)
                    order = rt.order(msgs)
                    victim = order[0]
                    twin = (await _chat_json(client, f"{rep[order[-1]]}/v1/chat/completions",
                                             body(msgs, 64)))["text"] if spare else None
                    switches[victim].watch = True
                    switches[victim].die_after_tokens = 16
                    c0 = counters()
                    r = await _sse(client, chat, body(msgs, 64, quorum=m, stream=True))
                    q = moved(c0)
                    busy = await quiet(victim)
                    switches[victim].watch = False
                    await switches[victim].revive()
                    final = [e for e in r["events"] if e.get("id") == "chatcmpl-parallel-final"]
                    errors = [e for e in r["events"] if e.get("id") == "error"]
                    pieces = final[0]["choices"][0]["delta"]["content"].split(sep) if final else []
                    row = {"quorum": m, "victim": victim, "spare": spare,
                           "counters": q, "dead_engine_busy_slots": busy,
                           "pieces": len(pieces), "errors": len(errors)}
                    kills.append(row)
                    if spare:
                        require(q.get("QUORUM_REQUESTS") == {"outcome=full": 1.0}
                                and "QUORUM_DEGRADED" not in q and pieces == [twin] * 2
                                and not errors and busy == 0,
                                f"quorum 2 with a member killed: {row}")
                    else:
                        require(q.get("QUORUM_REQUESTS") == {"outcome=degraded": 1.0}
                                and q.get("QUORUM_DEGRADED") == {"reason=stream_broken": 1.0}
                                and len(pieces) == 3 and not errors and busy == 0,
                                f"quorum 3 with a member killed: {row}")
                out["quorum"] = {"requests": qrows, "kills": kills}
                lap("quorum")

            # (b) mid-stream resume: a cold home, a cold resume target, a
            # cold twin on the third replica (all three on one path)
            async with Router(urls) as rt:
                chat = f"{rt.url}/v1/chat/completions"
                msgs = user(300, 700)
                home, target, other = rt.order(msgs)
                for n in names:
                    switches[n].watch, switches[n].streams = True, []
                twin = await _sse(client, f"{rep[other]}/v1/chat/completions",
                                  body(msgs, 256, stream=True, stream_token_ids=True))
                twin_ids = switches[other].streams[-1]
                switches[home].die_after_tokens = 64
                c0 = counters()
                r = await _sse(client, chat, body(msgs, 256, stream=True))
                q = moved(c0)
                busy = await quiet(home)
                got_ids = switches[home].streams[-1] + switches[target].streams[-1]
                for n in names:
                    switches[n].watch = False
                await switches[home].revive()
                gaps = [b - a for a, b in zip(r["content_times"], r["content_times"][1:])]
                ids = sorted({e["id"] for e in r["events"] if e.get("id")})
                out["resume"] = {
                    "home": home, "resumed_on": target, "twin_on": other,
                    "delivered_before_death": len(switches[home].streams[-1]),
                    "tokens": len(got_ids), "text_equal": r["text"] == twin["text"],
                    "ids_equal": got_ids == twin_ids, "chunk_ids": ids,
                    "errors": sum(e.get("id") == "error" for e in r["events"]),
                    "counters": q, "dead_engine_busy_slots": busy,
                    "max_gap_s": max(gaps), "median_gap_s": statistics.median(gaps),
                    "routed_to": r["headers"]["x-routed-to"]}
                require(out["resume"]["text_equal"] and out["resume"]["ids_equal"]
                        and out["resume"]["errors"] == 0 and len(twin_ids) == 256
                        and q.get("ROUTER_STREAM_RESUMES") == {"outcome=resumed": 1.0}
                        and busy == 0 and len(ids) <= 2, f"resume: {out['resume']}")
                lap("resume")

            # (c) drain a replica holding 2 live streams
            # load_factor 4: bounded load would spill the second stream
            # (cap = ceil(1.25 x 2 / 3) = 1 per replica)
            async with Router(urls, ready_interval=0.25, load_factor=4.0) as rt:
                chat = f"{rt.url}/v1/chat/completions"
                cands = {}
                seed = 800
                while len(cands) < 2:
                    msgs = user(300, seed)
                    seed += 1
                    order = rt.order(msgs)
                    if order[0] == "r0":
                        cands[len(cands)] = (msgs, order)
                drained = "r0"
                twins = []
                for msgs, order in cands.values():
                    target = [n for n in order if n != drained][0]
                    twin_on = [n for n in names if n not in (drained, target)][0]
                    twins.append((await _sse(client, f"{rep[twin_on]}/v1/chat/completions",
                                             body(msgs, 128, stream=True)))["text"])
                c0 = counters()
                sw = switches[drained]
                sw.watch, sw.streams = True, []
                if cpu:  # llama-tiny on the CPU would finish before the drain lands
                    slow = by_name[drained]._dispatch_chunk
                    by_name[drained]._dispatch_chunk = \
                        lambda active: (time.sleep(0.01), slow(active))[1]
                live = [asyncio.ensure_future(_sse(client, chat, body(msgs, 128, stream=True)))
                        for msgs, _ in cands.values()]
                deadline = time.perf_counter() + 60
                while len(sw.streams) < 2 or min(len(ids) for ids in sw.streams) < 16:
                    require(time.perf_counter() < deadline,
                            f"drain: the streams never started ({sw.streams})")
                    await asyncio.sleep(0.01)
                t0 = time.perf_counter()
                report = (await client.post(f"{rt.url}/router/drain?replica={drained}")).json()
                drain_s = time.perf_counter() - t0
                streams = [await s for s in live]
                q = moved(c0)
                sw.watch = False
                if cpu:
                    del by_name[drained]._dispatch_chunk
                await client.post(f"{rep[drained]}/admin/undrain")
                out["drain"] = {"replica": drained, "report": report, "seconds": drain_s,
                                "load_factor": rt.cfg.load_factor,
                                "texts_equal": [s["text"] == t for s, t in zip(streams, twins)],
                                "errors": sum(e.get("id") == "error" for s in streams
                                              for e in s["events"]),
                                "counters": q}
                require(report.get("drained") is True and all(out["drain"]["texts_equal"])
                        and out["drain"]["errors"] == 0
                        and q.get("ROUTER_STREAM_RESUMES") == {"outcome=resumed": 2.0},
                        f"drain: {out['drain']}")
                lap("drain")

            # (f) the fleet timeline
            async with Router(urls) as rt:
                chat = f"{rt.url}/v1/chat/completions"
                polls0 = sum(v["count"] for v in obs.TELEMETRY_POLL_SECONDS.snapshot().values())
                await rt.mgr.poll_once()
                polls = sum(v["count"] for v in
                            obs.TELEMETRY_POLL_SECONDS.snapshot().values()) - polls0
                t0 = time.perf_counter()
                r = await _chat_json(client, chat, body(user(200, 900), 8))
                t1 = time.perf_counter()
                rid, served = r["headers"]["x-request-id"], r["headers"]["x-routed-to"]
                tl = (await client.get(f"{rt.url}/debug/fleet/timeline")).json()
                procs = sorted({e["process"] for e in tl["events"]})
                route = [e for e in tl["events"] if e.get("rid") == rid
                         and e["process"] == "router" and e["kind"] == "router-route"]
                mine = [e for e in tl["events"] if e["process"] == served
                        and tag.get(e.get("engine")) == served
                        and (e.get("rid") == rid or rid in (e.get("rids") or []))]
                kinds = sorted({e["kind"] for e in mine})
                # every event of the trace, shifted onto the router's clock,
                # lies inside the client's request window (same clock here)
                stamps = [e["t"] - t0 for e in route + mine]
                out["fleet"] = {"processes": procs, "replicas": [
                    {k: v for k, v in row.items() if k != "events"} for row in tl["replicas"]],
                    "events": len(tl["events"]), "trace_kinds": kinds,
                    "trace_event_span_s": [min(stamps), max(stamps)] if stamps else None,
                    "request_wall_s": t1 - t0, "telemetry_polls": polls}
                require(procs == ["r0", "r1", "r2", "router"] and route
                        and {"admit", "dispatch"} <= set(kinds) and polls == 3
                        and all(-0.005 <= s <= t1 - t0 + 0.005 for s in stamps),
                        f"fleet timeline: {out['fleet']}")
                lap("fleet")
        return out

    legs = asyncio.run(asyncio.wait_for(main(), 16 * SERVE_TIMEOUT_S))
    if not cpu:
        torch.cuda.synchronize()
    m1 = [e.metrics() for e in engines]
    launches = {"flash_prefill": flash_prefill_attention.launches,
                "flash_decode": flash_decode_attention.launches,
                "flash_decode_q8": flash_decode_q8_attention.launches}
    single_shot = sum(b["admission_dispatches_total"] - a["admission_dispatches_total"]
                      for a, b in zip(m0, m1))
    k2_steps = sum(_k2_steps(b) - _k2_steps(a) for a, b in zip(m0, m1))
    k1_routes = dict(flash_prefill_attention.launches_by_route)
    tickets_zero = all(int(c.abs().sum()) == 0 for c in ticket_counters())
    if not cpu:
        want = {"flash_prefill": spec.n_layers * single_shot,
                "flash_decode": spec.n_layers * k2_steps, "flash_decode_q8": 0}
        require(launches == want, f"router launches {launches} != {want}")
        require(k1_routes["wgmma"] == launches["flash_prefill"],
                f"router: K1 off the wgmma route {k1_routes}")
        require(launches["flash_prefill"] > 0 and launches["flash_decode"] > 0,
                "router: a kernel of the path was never launched")
    require(tickets_zero, "router: K2 ticket counters are not back at 0")
    peak = None if cpu else torch.cuda.max_memory_allocated()
    info = {"model": model, "layers": spec.n_layers, "replicas": len(engines),
            "slots_per_replica": engines[0].n_slots, "max_seq": spec.max_seq,
            "build_s": build_s, **legs,
            "single_shot_admissions": single_shot, "k2_steps": k2_steps,
            "launches": launches, "k1_launches_by_route": k1_routes,
            "ticket_counters_zero": tickets_zero, "counters": moved(c_phase),
            "peak_mem_gb": None if cpu else peak / 1e9,
            "seconds": time.perf_counter() - t_phase, "measured_on": card}
    emit("router", **info)
    for e in engines:  # built here, not through get_engine: not in its registry
        e.shutdown()
    del switches, engines, by_name, params
    shutdown_all_engines()
    _require_card_empty(torch, cpu, "after the router phase")
    return info


# ---- train (training on one card) -----------------------------------------

TRAIN_TOKENS = 2048
TRAIN_STEPS = 3
# Leg (b), the card's float32 steps against the CPU's: losses within 1e-5
# relative; params within 1e-5 of each leaf's scale plus 5 % of the steps'
# learning rate (Adam's m / (sqrt(v) + eps) on an element whose gradient is
# near eps, 1e-8, is decided by rounding).
TRAIN_PARITY_REL = 1e-5
TRAIN_ADAM_SLACK = 0.05
# Leg (c), accumulation of two micro-batches against one step over both, bf16
# params: the two updates' difference as a share of the big step's, in the
# L2 norm over every element (‖Δacc − Δbig‖ / ‖Δbig‖). A fault that applies
# no update reads 1; one that applies a single micro-batch's about 1 too.
TRAIN_ACCUM_REL = 0.2
# Leg (c), served greedy tokens against the argmax chain of the plain-attention
# forward, the engine's log-probabilities of its top TRAIN_SERVE_TOP ids a
# step held against the forward's (see _serve_check).
TRAIN_SERVE_TOKENS = 8
TRAIN_SERVE_TOP = 20

def _sync(torch, cpu: bool) -> None:
    if not cpu:
        torch.cuda.synchronize()


def _train_tokens(torch, vocab: int, batch: int, n: int, seed: int, dev):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(1, vocab, (batch, n), generator=g).to(dev)


def _tree_to(torch, tree, dev):
    """A training state's tree on ``dev``: every tensor of rank ≥ 1 moved
    (the counts and the step stay 0-d on the host)."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.to(dev, copy=True) if tree.dim() else tree.clone()
    if isinstance(tree, dict):
        return {k: _tree_to(torch, v, dev) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_tree_to(torch, v, dev) for v in tree))
    return tuple(_tree_to(torch, v, dev) for v in tree)


def _tree_bytes(tree) -> int:
    from quorum_tpu_torch.training.checkpoint import _named

    return sum(t.numel() * t.element_size() for _, t in _named(tree))


def _train_bound(spec, params, batch: int, t: int) -> dict:
    """The least time one step could take on the card: the products of the
    forward, the backward (twice the forward) and remat's recomputed forward,
    8·N·tokens for N non-embedding parameters (the lm head included), and
    full plain attention (no causal skip: QKᵀ and PV, 4·T²·d a layer a
    forward, four forwards' worth) at the bf16 peak; plus AdamW's traffic
    (read p, g, m, v; write p, m, v) at the memory rate."""
    from quorum_tpu_torch.training.optim import tree_leaves

    leaves = tree_leaves(params)
    n_all = sum(x.numel() for x in leaves)
    n = n_all - params["tok_emb"].numel()
    d = spec.n_heads * spec.head_dim
    flops = 8 * n * batch * t + 16 * spec.n_layers * batch * t * t * d
    adam_bytes = 7 * sum(x.numel() * x.element_size() for x in leaves)
    ops_s, bytes_s = flops / PEAK_FLOPS[spec.dtype], adam_bytes / HBM_BYTES_PER_S
    return {"flops": flops, "non_embedding_params": n, "adamw_bytes": adam_bytes,
            "ops_bound_s": ops_s, "adamw_bound_s": bytes_s, "bound_s": ops_s + bytes_s}


def _train_full(torch, cpu: bool, spec, dev, n_tokens: int) -> dict:
    """Leg (a): ``TRAIN_STEPS`` steps of the default recipe (remat) on one
    repeated batch of 1 × ``n_tokens`` seeded tokens, each through
    ``make_train_step``, its forward + backward and its optimizer update
    timed apart by its ``grads_hook``. The loss is finite and falls at every
    step; every leaf's step-1 gradient (every layer's slice of a block leaf)
    is finite and nonzero; ``forward_logits`` on its kernel path refuses the
    grad leaves. The checks run in step 1's hook and are left out of its
    time."""
    from quorum_tpu_torch.models import transformer
    from quorum_tpu_torch.training import trainer
    from quorum_tpu_torch.training.optim import tree_leaves

    marks = {}
    grad_report = {}

    def hook(state, loss, grads):
        _sync(torch, cpu)
        marks["grads"] = time.perf_counter()
        if not grad_report:
            grad_report.update(_check_grads(torch, grads))
            leaves = trainer._grad_leaves(state.params, grads)
            try:
                transformer.forward_logits(leaves, spec, tokens[:, :16])
                refused = None
            except RuntimeError as e:
                refused = str(e)
            require(refused is not None and "plain_attention=True" in refused,
                    f"train (a): forward_logits on the kernel path did not refuse grad: {refused}")
            del leaves
            _sync(torch, cpu)
        marks["update"] = time.perf_counter()

    opt = trainer.make_optimizer()
    step = trainer.make_train_step(spec, device=dev, optimizer=opt, grads_hook=hook)
    if not cpu:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = trainer.train_init(spec, device=dev, seed=0, optimizer=opt)
    _sync(torch, cpu)
    init_s = time.perf_counter() - t0
    tokens = _train_tokens(torch, spec.vocab_size, 1, n_tokens, 0, dev)
    losses, fwd_bwd_s, opt_s, step_s = [], [], [], []
    for _ in range(TRAIN_STEPS):
        _sync(torch, cpu)
        t0 = time.perf_counter()
        state, loss = step(state, tokens)
        _sync(torch, cpu)
        t1 = time.perf_counter()
        losses.append(float(loss))
        fwd_bwd_s.append(marks["grads"] - t0)
        opt_s.append(t1 - marks["update"])
        step_s.append((t1 - t0) - (marks["update"] - marks["grads"]))
    params = state.params
    require(all(math.isfinite(x) for x in losses), f"train (a): losses {losses}")
    require(all(b < a for a, b in zip(losses, losses[1:])), f"train (a): loss did not fall: {losses}")
    ms = statistics.median(step_s[1:]) * 1e3
    bound = _train_bound(spec, params, 1, n_tokens - 1)
    state_bytes = 4 * _tree_bytes(params)  # params, gradients, mu, nu
    out = {"model": f"{spec.family} d={spec.d_model} L={spec.n_layers} V={spec.vocab_size}",
           "dtype": spec.dtype, "tokens_per_step": n_tokens, "remat": True,
           "init_s": round(init_s, 3), "losses": losses,
           "step_ms": [round(s * 1e3, 2) for s in step_s],
           "fwd_bwd_ms": [round(s * 1e3, 2) for s in fwd_bwd_s],
           "optimizer_ms": [round(s * 1e3, 2) for s in opt_s],
           "ms_per_step": round(ms, 2), "tokens_per_s": round(n_tokens / ms * 1e3, 1),
           "bound_ms": round(bound["bound_s"] * 1e3, 2),
           "ops_bound_ms": round(bound["ops_bound_s"] * 1e3, 2),
           "adamw_bound_ms": round(bound["adamw_bound_s"] * 1e3, 2),
           "pct_of_bound": round(100 * bound["bound_s"] * 1e3 / ms, 1),
           "flops_per_step": bound["flops"], "non_embedding_params": bound["non_embedding_params"],
           "state_gb": round(state_bytes / 1e9, 3), "grads": grad_report,
           "kernel_path_refused": True,
           "leaves": len(tree_leaves(params))}
    if not cpu:
        out.update(peak_gb=round(torch.cuda.max_memory_allocated() / 1e9, 3),
                   reserved_peak_gb=round(torch.cuda.max_memory_reserved() / 1e9, 3))
    return out


def _check_grads(torch, grads) -> dict:
    """Every leaf's gradient finite and nonzero, each layer's slice of a
    block leaf on its own (norms in f32, one slice at a time)."""
    norms, names = [], []
    for name, g in grads.items():
        if name == "blocks" or g is None:
            continue
        norms.append(torch.linalg.vector_norm(g.float()))
        names.append(name)
    for name, g in grads["blocks"].items():
        if g is None:
            continue
        for l in range(g.shape[0]):
            norms.append(torch.linalg.vector_norm(g[l].float()))
            names.append(f"blocks.{name}[{l}]")
    vals = torch.stack(norms).cpu().tolist()
    bad = [(n, v) for n, v in zip(names, vals) if not (math.isfinite(v) and v > 0)]
    require(not bad, f"train (a): gradients not finite and nonzero: {bad[:8]}")
    return {"slices_checked": len(vals), "min_norm": min(vals), "max_norm": max(vals)}


def _train_parity(torch, cpu: bool, dev) -> dict:
    """Leg (b): llama-tiny in float32, the same three steps (default recipe,
    remat) on the card and on the CPU from the same state."""
    from quorum_tpu_torch.models.model_config import resolve_spec
    from quorum_tpu_torch.training import trainer
    from quorum_tpu_torch.training.checkpoint import _named

    spec = resolve_spec("llama-tiny", {"dtype": "float32", "max_seq": "64"})
    host = trainer.train_init(spec, device="cpu", seed=0)
    card = _tree_to(torch, host, dev)
    tokens = _train_tokens(torch, spec.vocab_size, 2, 48, 1, "cpu")
    tokens[1, -9:] = 0  # right padding on one row
    steps = {d: trainer.make_train_step(spec, device=d) for d in ("cpu", dev)}
    worst_loss = 0.0
    for _ in range(TRAIN_STEPS):
        host, lh = steps["cpu"](host, tokens)
        card, lc = steps[dev](card, tokens)
        rel = abs(float(lc) - float(lh)) / abs(float(lh))
        require(rel <= TRAIN_PARITY_REL, f"train (b): loss {float(lc)} on the card, "
                                         f"{float(lh)} on the CPU")
        worst_loss = max(worst_loss, rel)
    slack = TRAIN_ADAM_SLACK * 3e-4 * TRAIN_STEPS
    worst = 0.0
    for (name, a), (_, b) in zip(_named(card.params), _named(host.params)):
        scale = float(b.abs().max())
        err = float((a.cpu() - b).abs().max())
        require(err <= TRAIN_PARITY_REL * scale + slack,
                f"train (b): {name} differs by {err} (scale {scale})")
        worst = max(worst, err / scale)
    return {"model": "llama-tiny", "dtype": "float32", "steps": TRAIN_STEPS,
            "loss_max_rel_err": worst_loss, "params_max_rel_err": worst,
            "tolerance": f"{TRAIN_PARITY_REL} relative (+{TRAIN_ADAM_SLACK} lr a step)"}


def _train_checkpoint(torch, cpu: bool, spec, dev, n_tokens: int, root: str) -> dict:
    """Leg (c) at ``spec`` (llama-3-8b widths, 2 layers, bf16): save after
    step 2, restore, step 3 equal to the uninterrupted step 3 bit for bit;
    accumulation over two equal micro-batches against one step over both;
    ``restore_params`` growing device memory by the params alone; an
    engine on the restored params serving greedy tokens checked against the
    argmax chain of the plain-attention forward, its K1 and K2 launches
    exact."""
    from quorum_tpu_torch.engine.engine import InferenceEngine
    from quorum_tpu_torch.models.transformer import forward_logits
    from quorum_tpu_torch.ops.sampling import SamplerConfig
    from quorum_tpu_torch.training import checkpoint as ckpt
    from quorum_tpu_torch.training import trainer

    out = {"model": f"{spec.family} d={spec.d_model} L={spec.n_layers}", "dtype": spec.dtype}
    tokens = _train_tokens(torch, spec.vocab_size, 1, n_tokens, 2, dev)
    step = trainer.make_train_step(spec, device=dev)
    state = trainer.train_init(spec, device=dev, seed=0)
    for _ in range(2):
        state, _ = step(state, tokens)
    path = os.path.join(root, "ckpt")
    _sync(torch, cpu)
    t0 = time.perf_counter()
    nbytes = ckpt.save_checkpoint(path, state)
    save_s = time.perf_counter() - t0
    state, loss3 = step(state, tokens)
    t0 = time.perf_counter()
    restored = ckpt.restore_checkpoint(path, spec, device=dev)
    _sync(torch, cpu)
    restore_s = time.perf_counter() - t0
    restored, loss3r = step(restored, tokens)
    a, b = list(ckpt._named(restored)), list(ckpt._named(state))
    require([n for n, _ in a] == [n for n, _ in b] and all(
        x.dtype == y.dtype and torch.equal(x, y) for (_, x), (_, y) in zip(a, b))
        and torch.equal(loss3, loss3r), "train (c): the resumed step 3 differs from the "
                                        "uninterrupted one")
    out.update(checkpoint_bytes=nbytes, save_s=round(save_s, 3), restore_s=round(restore_s, 3),
               save_gb_per_s=round(nbytes / save_s / 1e9, 3),
               restore_gb_per_s=round(nbytes / restore_s / 1e9, 3),
               resume_bit_for_bit=True, leaves_compared=len(a), loss3=float(loss3))
    del state, restored, a, b

    # accumulation: two micro-batches of equal real-token counts (no pads)
    out.update(_train_accumulation(torch, spec, dev, n_tokens))
    gc.collect()

    # restore_params: the params' bytes, nothing more
    _sync(torch, cpu)
    before = None if cpu else torch.cuda.memory_allocated()
    if not cpu:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = ckpt.restore_params(path, spec, device=dev)
    _sync(torch, cpu)
    out["restore_params_s"] = round(time.perf_counter() - t0, 3)
    pbytes = _tree_bytes(params)
    if not cpu:
        grown = torch.cuda.memory_allocated() - before
        peak = torch.cuda.max_memory_allocated() - before
        n_leaves = len(list(ckpt._named(params)))
        require(pbytes <= grown <= pbytes + 512 * n_leaves and peak <= grown + 512,
                f"train (c): restore_params grew device memory by {grown} B (peak {peak}) "
                f"for {pbytes} B of params")
        out.update(restore_params_grown_bytes=grown, restore_params_peak_bytes=peak)
    out["params_bytes"] = pbytes

    # serve from the restored params
    prompt = _train_tokens(torch, spec.vocab_size, 1, 40, 4, "cpu")[0].tolist()
    eng = InferenceEngine(spec, device=dev, params=params)
    try:
        c0 = _launch_counts()
        req = eng.submit(prompt, max_new_tokens=TRAIN_SERVE_TOKENS,
                         sampler=SamplerConfig(temperature=0.0), logprobs=TRAIN_SERVE_TOP)
        got = list(eng.stream_results(req))
        m = eng.metrics()
        c1 = _launch_counts()
    finally:
        eng.shutdown()
    launches = _require_exact_launches(cpu, spec.n_layers, "train (c) serve", c0, c1,
                                       m["admission_dispatches_total"], _k2_steps(m))
    require(len(got) == TRAIN_SERVE_TOKENS and len(req.lp) == TRAIN_SERVE_TOKENS,
            f"train (c): served {len(got)} tokens, {len(req.lp)} logprob records")
    with torch.no_grad():
        seq = torch.tensor([prompt + got], device=dev)
        logits = forward_logits(params, spec, seq, plain_attention=True)[0, len(prompt) - 1:-1]
        plain = torch.log_softmax(logits.float(), -1).cpu()
    out.update(_serve_check(torch, got, req.lp, plain), serve_launches=launches)
    return out


def _serve_check(torch, got: list[int], records, plain) -> dict:
    """The served greedy tokens against the argmax chain of the plain
    forward's log-probabilities ``plain`` [n, V] over the served sequence.
    The engine's own log-probabilities (``records``: its top
    ``TRAIN_SERVE_TOP`` ids and values a step) are held against the plain
    ones at the same ids: the largest difference, δ, must stay within the
    model tolerance. A served token may differ from the plain argmax ``a``
    only where the engine recorded ``a`` too and the plain gap between them
    is within twice the difference measured at those two ids at that step
    (each path's values within it of the other's: a near-tie that
    rounding decides), never by a fixed tolerance over the vocabulary."""
    deltas, ties, gaps = [], [], []
    argmax = plain.argmax(-1).tolist()
    for i, (tok, (tok_lp, ids, lps)) in enumerate(zip(got, records)):
        ids = [int(x) for x in ids]
        lps = torch.tensor([float(x) for x in lps])
        require(float(tok_lp) == float(lps[0]), f"train (c): step {i} served {tok} at "
                                                f"{tok_lp}, below the engine's top {lps[0]}")
        diff = (lps - plain[i, ids]).abs()
        tok_diff = abs(float(tok_lp) - float(plain[i, tok]))
        deltas.append(max(float(diff.max()), tok_diff))
        a = argmax[i]
        if tok == a:
            continue
        require(a in ids, f"train (c): step {i}: the plain argmax {a} is not among the "
                          f"engine's top {len(ids)} ids {ids}")
        step_delta = max(float(diff[ids.index(a)]), tok_diff)
        gap = float(plain[i, a] - plain[i, tok])
        require(gap <= 2 * step_delta, f"train (c): step {i} served {tok} (plain gap {gap}) "
                                       f"over {a}; the paths differ by {step_delta} there")
        ties.append(i)
        gaps.append(gap)
    delta = max(deltas)
    require(delta <= MODEL_TOL["bfloat16"],
            f"train (c): the engine's log-probabilities differ from the plain forward's by "
            f"{delta} (> {MODEL_TOL['bfloat16']})")
    return {"served": got, "argmax_chain": argmax, "near_ties": ties, "near_tie_gaps": gaps,
            "serve_logprob_max_diff": delta, "serve_logprob_diff_by_step": deltas,
            "serve_ids_compared": sum(len(r[1]) + 1 for r in records)}


def _train_accumulation(torch, spec, dev, n_tokens: int) -> dict:
    """``accum_steps=2`` over two micro-batches of equal real-token counts
    against one step over both (grad_clip 1.0, the default rate), both from
    the seed's params. The moves of the two from the start are compared as
    a whole: ``‖Δacc − Δbig‖ / ‖Δbig‖`` within ``TRAIN_ACCUM_REL`` (Adam's
    first update is about ±lr whatever the gradient's size, so a sign that
    rounding decides moves an element by 2·lr: an element-wise tolerance
    would have to pass anything). Two planted faults must fail the same
    bound, showing it can: no update applied (the params left at the
    start), and the update of one micro-batch alone (a plain step on the
    second)."""
    from quorum_tpu_torch.training import trainer
    from quorum_tpu_torch.training.checkpoint import _named

    both = _train_tokens(torch, spec.vocab_size, 2, n_tokens // 2 + 1, 3, dev)

    def run(accum: int, batches):
        opt = trainer.make_optimizer(grad_clip=1.0, accum_steps=accum)
        st = trainer.train_init(spec, device=dev, seed=0, optimizer=opt)
        step = trainer.make_train_step(spec, device=dev, optimizer=opt)
        for b in batches:
            st, _ = step(st, b)
        return dict(_named(st.params))

    base = dict(_named(trainer.train_init(spec, device=dev, seed=0).params))
    big = run(1, [both])
    big_sq = sum(float((big[n].float() - base[n].float()).square().sum()) for n in base)

    def rel(params) -> float:
        sq = sum(float((params[n].float() - big[n].float()).square().sum()) for n in base)
        return math.sqrt(sq / big_sq)

    opt = trainer.make_optimizer(grad_clip=1.0, accum_steps=2)
    acc = trainer.train_init(spec, device=dev, seed=0, optimizer=opt)
    acc_step = trainer.make_train_step(spec, device=dev, optimizer=opt)
    acc, _ = acc_step(acc, both[:1])
    require(all(torch.equal(t, base[n]) for n, t in _named(acc.params)),
            "train (c): the first micro-step moved the params")
    acc, _ = acc_step(acc, both[1:])
    got = rel(dict(_named(acc.params)))
    del acc
    faults = {"no_update": rel(base), "one_micro_batch": rel(run(1, [both[1:]]))}
    require(got <= TRAIN_ACCUM_REL, f"train (c): the accumulated update differs from the big "
                                    f"step's by {got} of its size (> {TRAIN_ACCUM_REL})")
    require(all(v > TRAIN_ACCUM_REL for v in faults.values()),
            f"train (c): a planted fault passes the accumulation bound: {faults}")
    return {"accum_rel_diff": got, "accum_tolerance": TRAIN_ACCUM_REL,
            "accum_planted_faults_rel": faults,
            "big_step_move_norm": math.sqrt(big_sq),
            "big_step_max_move": max(float((big[n].float() - base[n].float()).abs().max())
                                     for n in base)}


# Leg bounds of the mesh phase: a multi-rank engine's log-probabilities
# against the single-device engine's, where the tp all-reduce (or sp's
# block-wise prefill) sums the same bf16 products in another order.
MESH_LP_TOL = 0.25
# Seconds a killed worker's stream may take to end with an error (the
# groups' timeout bounds it; gloo sees the peer's socket close at once).
MESH_GROUP_TIMEOUT_S = 60.0


def _lp_stream(eng, ids: list[int], n: int, timeout: float = 2 * SERVE_TIMEOUT_S,
               sampler=None, seed: int = 0, logprobs: int = 20, bias=None):
    """One greedy (or ``sampler``'s, at ``seed``) request on the engine's
    API with the top-20 log-probabilities of every step (``logprobs=-1``:
    none, so a speculative engine drafts for it; ``bias``: a ``[V]`` logit
    bias): (tokens, records, seconds)."""
    import threading

    from quorum_tpu_torch.ops.sampling import SamplerConfig

    t0 = time.perf_counter()
    req = eng.submit(ids, max_new_tokens=n, sampler=sampler or SamplerConfig(temperature=0.0),
                     logprobs=logprobs, seed=seed, logit_bias=bias)
    out: list = []
    th = threading.Thread(target=lambda: out.extend(eng.stream_results(req)), daemon=True)
    th.start()
    th.join(timeout)
    require(not th.is_alive(), "mesh: a stream never finished")
    return out, list(req.lp), time.perf_counter() - t0


def _hold_lp(what: str, ref, got, forced: bool = False) -> dict:
    """Stream ``got`` (tokens, top-20 records) held against ``ref`` step by
    step: δ is the largest difference of the two log-probabilities at the
    ids both list (and at each served token); a token may differ only where
    the other's is in the reference's top-20 and the reference's gap
    between the two is within 2δ of that step (a near-tie the summation
    order decides). Two engines' streams part at a differing token and are
    not compared past it; ``forced``: ``ref`` scored ``got``'s own tokens
    (``_rescore_lp``), so every step is held."""
    deltas, ties = [], []
    for i, (rt, gt, (r_lp, r_ids, r_lps), (g_lp, g_ids, g_lps)) in enumerate(
            zip(ref[0], got[0], ref[1], got[1])):
        rmap = dict(zip((int(x) for x in r_ids), (float(x) for x in r_lps)))
        gmap = dict(zip((int(x) for x in g_ids), (float(x) for x in g_lps)))
        shared = set(rmap) & set(gmap)
        require(shared, f"{what}: step {i}: no id in both top-20 lists")
        step = max(abs(rmap[j] - gmap[j]) for j in shared)
        deltas.append(step)
        if rt != gt:
            require(gt in rmap, f"{what}: step {i} served {gt}, not in the reference top-20")
            gap = rmap[rt] - rmap[gt]
            require(gap <= 2 * step, f"{what}: step {i} served {gt} over {rt} "
                                     f"(reference gap {gap}, δ {step})")
            ties.append({"step": i, "gap": gap, "delta": step})
            if not forced:
                break
    require(len(deltas) == len(got[0]) or ties, f"{what}: {len(deltas)} of {len(got[0])} "
                                                "steps compared")
    delta = max(deltas)
    require(delta <= MESH_LP_TOL, f"{what}: log-probabilities differ by {delta} "
                                  f"(> {MESH_LP_TOL})")
    return {"steps_compared": len(deltas), "logprob_max_diff": delta, "near_ties": ties,
            "equal": list(ref[0]) == list(got[0])}


def _rescore_lp(torch, spec, params, prompt: list[int], tokens: list[int]):
    """The single-device model's greedy token and top-20 log-probabilities
    at each step of a stream that served ``tokens`` after ``prompt``,
    scored on the stream's own tokens (one cache-free forward over the
    prompt and the tokens but the last): (tokens, records) in
    ``_lp_stream``'s form."""
    from quorum_tpu_torch.models.transformer import forward_hidden, unembed

    dev = params["tok_emb"].device
    ids = torch.tensor([prompt + tokens[:-1]], device=dev)
    with torch.inference_mode():
        h = forward_hidden(params, spec, ids)[:, len(prompt) - 1:]
        lp = torch.log_softmax(unembed(params, spec, h).float(), dim=-1)[0]
        top = lp.topk(20, dim=-1)
    vals, idx = top.values.cpu(), top.indices.cpu()
    return ([int(i[0]) for i in idx],
            [(float(v[0]), i.tolist(), v.tolist()) for v, i in zip(vals, idx)])


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _mesh_chats(app, bodies, backend, max_tokens: int):
    async def drive():
        return await asyncio.gather(*[_call(app, b) for b in bodies])

    resps = asyncio.run(asyncio.wait_for(drive(), 2 * SERVE_TIMEOUT_S))
    return [_check_response(r, b, backend.tokenizer, max_tokens) for r, b in zip(resps, bodies)]


def _graph_collectives(eng) -> dict:
    """Collectives captured in the engine's decode graphs, by kind, summed
    over its graphs (each replay launches them again)."""
    from quorum_tpu_torch.parallel import COLLECTIVES

    out = {k: 0 for k in COLLECTIVES}
    for _, _, counts in (eng._graphs._graphs.values() if eng._graphs else ()):
        for fn, n in counts.items():
            if getattr(fn, "name", None) in out:
                out[fn.name] += n
    return out


def phase_mesh(torch, cpu: bool, tiny: bool, device_info: dict,
               cards_only: bool = False) -> dict:
    """Data-, tensor- and sequence-parallel serving (``parallel/``; a mesh engine is
    rank 0 here, the other ranks are spawned processes) on llama-3-8b at
    full width (32 layers, bf16, seed 0, 4 slots × 8192), against the
    single-device engine on the same weights. One card, so: (a) a one-rank
    NCCL mesh, whose decode graphs capture the collectives: 4 chats through
    the app, greedy tokens equal to the single-device engine's; (b) tp=2
    with two ranks sharing the card over gloo (host-staged collectives,
    eager decode): 2 chats through the app, greedy streams held by the
    top-20 log-probabilities (to where they part at a near-tie, then whole
    against the single-device model scored on the mesh's own tokens),
    every worker fed rank 0's tokens, each
    rank's weights half and cache 2.15 GB; (c) sp=2 ring, then Ulysses, on
    one 8192-token prompt: the first token and its top-20 held the same
    way, the admission's seconds and each rank's peak memory; (d) a worker
    of (b)'s engine killed mid-stream: the stream ends with an error inside
    the groups' timeout, the breaker opens, no process is left; (e)–(h):
    ``_mesh_dp2``, ``_mesh_dp2_tp2``, ``_mesh_dp2_train``,
    ``_mesh_nccl_cards``; (i)–(l): ``_mesh_ckpt``, ``_mesh_pp2``,
    ``_mesh_cards_moe``; (m) and (p): ``_mesh_pp_train`` (pp=2 over gloo on
    one card, pp=4 over NCCL on four); (n), (o) and (q): ``_mesh_disagg_card``,
    ``_mesh_disagg_cards`` and ``_mesh_disagg_tp_cards`` (disagg=1+1 on one
    card, then across two; 2+2 with tp=2 on four); (r) and (s):
    ``_mesh_int8_members`` (int8 weights and KV, members, an ensemble and a
    grammar on tp=2 sharing the card) and ``_mesh_int8_cards`` (int8
    members on dp=2 × tp=2 and on disagg=2+2 with tp=2 over NCCL on four);
    (t) and (u): ``_mesh_memory_knobs`` (kv_pages, prefix_store and
    zero_drain on tp=2 and dp=2 × tp=2 sharing the card) and
    ``_mesh_memory_cards`` (the three at once on dp=2 × tp=2, then kv_pages
    and prefix_store on disagg=2+2 with tp=2, over NCCL on four); (v) and
    (w): ``_mesh_spec_forwards`` (prompt lookup, an oracle draft,
    embeddings and scoring on tp=2 and dp=2 × tp=2 sharing the card) and
    ``_mesh_spec_cards`` (prompt lookup, a draft model on rank 0, dp=2 ×
    tp=2, disagg=2+2 with tp=2 and scoring beside a stream, over NCCL on
    four); (x) and (y): ``_mesh_sp_pp_knobs`` (speculation, int8 and the
    forwards on sp=2, int8 and the forwards on pp=2, ranks sharing the
    card) and ``_mesh_sp_pp_cards`` (int8 and speculation on sp=2 × tp=2
    with a scoring request beside a stream, mixtral pp=4 with an int8
    cache, over NCCL on four). K1, K2 and K2q8 launches are counted on
    every rank (workers report theirs), and K1 and K2 by group on the
    disaggregated engines."""
    from quorum_tpu_torch.backends.cuda_backend import CudaBackend
    from quorum_tpu_torch.config import Config
    from quorum_tpu_torch.engine.engine import EngineBreakerOpen, InferenceEngine
    from quorum_tpu_torch.models.init import init_params
    from quorum_tpu_torch.models.model_config import resolve_spec
    from quorum_tpu_torch.ops.flash_attention import flash_prefill_attention
    from quorum_tpu_torch.ops.flash_decode import flash_decode_attention
    from quorum_tpu_torch.ops.flash_decode_q8 import flash_decode_q8_attention
    from quorum_tpu_torch.ops.sampling import SamplerConfig
    from quorum_tpu_torch.parallel import (MeshConfig, collective_counts, make_mesh,
                                           single_device_mesh)
    from quorum_tpu_torch.server.app import create_app

    _require_card_empty(torch, cpu, "mesh")
    t_phase = time.perf_counter()
    model = "llama-tiny" if tiny else "llama-3-8b"
    spec = resolve_spec(model, {"head_dim": "64", "dtype": "bfloat16"} if tiny else {})
    dev = "cpu" if cpu else "cuda:0"
    two = ["cpu"] * 2 if cpu else ["cuda:0", "cuda:0"]
    knobs = dict(n_slots=4, decode_chunk=8, seed=0)
    card = f"{device_info['name']} ({device_info['power_limit']})"
    n_tok = 16 if tiny else 32
    bodies = _serve_bodies(model, tiny)
    gen = random.Random(11)
    long_ids = [gen.randrange(spec.vocab_size) for _ in range(spec.max_seq - 1)]
    launches = {"flash_prefill": 0, "flash_decode": 0, "flash_decode_q8": 0}
    counters = {"flash_prefill": flash_prefill_attention, "flash_decode": flash_decode_attention,
                "flash_decode_q8": flash_decode_q8_attention}

    def zero():
        for fn in counters.values():
            fn.launches = 0

    def add(reports=()):
        for name, fn in counters.items():
            launches[name] += fn.launches + sum(r["launches"].get(name, 0) for r in reports)

    def peak_reset():
        if not cpu:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

    def peak():
        return None if cpu else torch.cuda.max_memory_allocated()

    def app_for(name, eng):
        backend = CudaBackend(name, eng, model=model, model_id=model)
        raw = {"primary_backends": [{"name": name, "url": f"x://{model}", "model": model}],
               "settings": {"timeout": SERVE_TIMEOUT_S}}
        return create_app(Config(raw=raw), **{name: backend}), backend

    out = {"model": model, "layers": spec.n_layers, "slots": 4, "max_seq": spec.max_seq,
           "dtype": spec.dtype, "measured_on": card}

    # The single-device engine: the reference streams, then freed.
    t0 = time.perf_counter()
    ref_eng = InferenceEngine(spec, device=dev, **knobs)
    tok = CudaBackend("ref", ref_eng, model=model, model_id=model).tokenizer
    prompts = [tok.encode(tok.render_chat(b["messages"])) for b in bodies[:2]]
    full_bytes = _tree_bytes(ref_eng.params)
    ref = [_lp_stream(ref_eng, p, n_tok) for p in prompts]
    ref_sampled = [_lp_stream(ref_eng, p, n_tok, sampler=SamplerConfig(temperature=0.8,
                                                                        top_p=0.9), seed=7)
                   for p in prompts]
    peak_reset()
    ref_long = _lp_stream(ref_eng, long_ids, 1)
    out["single"] = {"build_and_streams_s": round(time.perf_counter() - t0, 3),
                     "weight_bytes": full_bytes, "long_admission_s": round(ref_long[2], 4),
                     "long_peak_bytes": peak()}
    ref_eng.shutdown()
    del ref_eng
    _require_card_empty(torch, cpu, "mesh (a)")

    leg_s = {}
    # One card: (a)–(g), (i)–(k), (m), (n), (r), (t), (v) and (x); --mesh-
    # cards-only runs the legs over cards of their own alone ((h), (l), (o),
    # (p), (q), (s), (u), (w), (y)), against the same reference.
    if not cards_only:
        # (a) A one-rank NCCL mesh (gloo on the CPU rehearsal).
        zero()
        c0 = collective_counts()
        t0 = time.perf_counter()
        eng = InferenceEngine(spec, mesh=single_device_mesh(dev), **knobs)
        build_s = time.perf_counter() - t0
        app, backend = app_for("mesh1", eng)
        chats = _mesh_chats(app, bodies, backend, n_tok)
        got = [_lp_stream(eng, p, n_tok) for p in prompts]
        m = eng.metrics()
        c1 = collective_counts()
        add()
        require(all(g[0] == r[0] for g, r in zip(got, ref)),
                "mesh (a): a one-rank mesh's greedy tokens differ from the single-device engine's")
        in_graphs = _graph_collectives(eng)
        if not cpu:
            require(eng.mesh.backend == "nccl" and eng._graphs is not None,
                    "mesh (a): a one-rank NCCL mesh must decode from graphs")
            require(m["decode_graph_captures_total"] > 0 and in_graphs["all_reduce"] > 0
                    and in_graphs["broadcast"] > 0,
                    f"mesh (a): the decode graphs captured no collectives ({in_graphs})")
            require(flash_prefill_attention.launches == spec.n_layers * m["admission_dispatches_total"]
                    and flash_decode_attention.launches == spec.n_layers * _k2_steps(m),
                    f"mesh (a): K1/K2 launches {flash_prefill_attention.launches}/"
                    f"{flash_decode_attention.launches} for {m['admission_dispatches_total']} "
                    f"admissions and {_k2_steps(m)} decode steps")
        out["a_nccl_one_rank"] = {
            "backend": eng.mesh.backend, "build_s": round(build_s, 3),
            "chats": [{"stream": b["stream"], "finish": c["finish"],
                       "completion_tokens": c["usage"]["completion_tokens"],
                       "seconds": round(c["t_end"], 4)} for b, c in zip(bodies, chats)],
            "greedy_equal": True, "captures": m["decode_graph_captures_total"],
            "replays": m["decode_graph_replays_total"],
            "collectives_in_graphs": in_graphs,
            "collectives_issued": {k: c1[k] - c0[k] for k in c1},
            "k1_launches": flash_prefill_attention.launches,
            "k2_launches": flash_decode_attention.launches}
        emit("mesh", leg="a", **out["a_nccl_one_rank"])
        eng.shutdown()
        del eng, app, backend
        _require_card_empty(torch, cpu, "mesh (b)")

        # (b) tp=2: two ranks sharing the card over gloo.
        zero()
        t0 = time.perf_counter()
        eng = InferenceEngine(spec, mesh=make_mesh(MeshConfig(tp=2), two, backend="gloo",
                                                   timeout_s=MESH_GROUP_TIMEOUT_S), **knobs)
        build_s = time.perf_counter() - t0
        app, backend = app_for("tp2", eng)
        # Two of the chats (greedy streamed, sampled not) and half the tokens:
        # each eager step here costs 0.2–0.4 s of host-staged collectives.
        b_tok = n_tok // 2
        chats = _mesh_chats(app, [{**b, "max_tokens": b_tok} for b in bodies[1:3]], backend,
                            b_tok)
        got = []
        for i, p in enumerate(prompts):
            eng.rank_reports()  # clears what earlier requests fed
            got.append(_lp_stream(eng, p, b_tok))
            reports = eng.rank_reports()
            # The stream's row fed every token rank 0 served but the last
            # (after the last prompt token when the admission was chunked).
            fed = [f for f in reports[0]["fed"] if f]
            require(len(fed) == 1 and fed[0][len(fed[0]) - len(got[i][0]) + 1:] == got[i][0][:-1],
                    f"mesh (b): the worker rank did not feed rank 0's tokens of stream {i}")
        held = [_hold_lp(f"mesh (b) stream {i}", (r[0][:b_tok], r[1][:b_tok]), g)
                for i, (r, g) in enumerate(zip(ref, got))]
        w_bytes = [_tree_bytes(eng.params), reports[0]["weight_bytes"]]
        c_bytes = [sum(t.numel() * t.element_size() for t in (eng._ck, eng._cv)),
                   reports[0]["cache_bytes"]]
        want_cache = 2 * spec.n_layers * 4 * (spec.n_kv_heads // 2) * spec.max_seq * spec.head_dim * 2
        require(w_bytes[0] == w_bytes[1] and abs(w_bytes[0] - full_bytes / 2) <= 0.001 * full_bytes,
                f"mesh (b): rank weight bytes {w_bytes}, not half of {full_bytes}")
        require(c_bytes == [want_cache] * 2, f"mesh (b): rank cache bytes {c_bytes} != {want_cache}")
        step_ms = [1e3 * g[2] / len(g[0]) for g in got]
        out["b_tp2_gloo"] = {
            "backend": eng.mesh.backend, "decode": eng.health()["mesh"]["decode"],
            "build_s": round(build_s, 3),
            "chats": [{"stream": b["stream"], "finish": c["finish"],
                       "completion_tokens": c["usage"]["completion_tokens"],
                       "seconds": round(c["t_end"], 4)} for b, c in zip(bodies[1:3], chats)],
            "held": held, "worker_fed_rank0_tokens": True,
            "weight_bytes_per_rank": w_bytes, "single_weight_bytes": full_bytes,
            "cache_bytes_per_rank": c_bytes,
            "eager_ms_per_token_one_stream": step_ms,
            "eager_note": "two ranks sharing one card over host-staged gloo, eager decode: "
                          "not a tp=2 deployment's step time",
            "worker_collectives": reports[0]["collectives"]}
        emit("mesh", leg="b", **out["b_tp2_gloo"])

        # (d) Worker rank 1 killed mid-stream.
        import threading

        pids = eng.worker_pids()
        req = eng.submit(prompts[0], max_new_tokens=200 if not tiny else 100,
                         sampler=SamplerConfig(temperature=0.0))
        seen, ended = [], {}

        def consume():
            try:
                for t in eng.stream_results(req):
                    seen.append(t)
            except Exception as e:  # noqa: BLE001 - the leg's finding
                ended["error"] = f"{type(e).__name__}: {e}"[:300]
            ended["t"] = time.perf_counter()

        th = threading.Thread(target=consume, daemon=True)
        th.start()
        deadline = time.monotonic() + SERVE_TIMEOUT_S
        while len(seen) < 16 and th.is_alive() and time.monotonic() < deadline:
            time.sleep(0.01)
        t_kill = time.perf_counter()
        eng._ranks.kill(1)
        th.join(MESH_GROUP_TIMEOUT_S + 30)
        require(not th.is_alive(), "mesh (d): the stream did not end after its worker died")
        require("error" in ended, f"mesh (d): the stream ended without an error after "
                                  f"{len(seen)} tokens")
        end_s = ended["t"] - t_kill
        require(end_s <= MESH_GROUP_TIMEOUT_S, f"mesh (d): the stream took {end_s} s to fail")
        require(eng.breaker.state == "open", "mesh (d): the breaker did not open")
        try:
            eng.submit([1, 2, 3], max_new_tokens=4)
            refused = False
        except EngineBreakerOpen:
            refused = True
        require(refused, "mesh (d): a submit after the loss was not refused")
        resp = asyncio.run(_call(app, bodies[0]))
        require(resp["status"] == 503, f"mesh (d): status {resp['status']} after the loss")
        reports_b = reports
        eng.shutdown()
        alive = []
        for pid in pids:
            try:
                os.kill(pid, 0)
                alive.append(pid)
            except ProcessLookupError:
                pass
        require(not alive and not eng.worker_pids(), f"mesh (d): processes left: {alive}")
        add(reports_b)
        out["d_worker_killed"] = {"tokens_before_error": len(seen), "error": ended["error"],
                                  "seconds_to_error": round(end_s, 4), "breaker": "open",
                                  "status_after": 503, "processes_left": 0}
        emit("mesh", leg="d", **out["d_worker_killed"])
        del eng, app, backend
        _require_card_empty(torch, cpu, "mesh (b) re-scored")

        # (b) again: each tp=2 stream held whole against the single-device
        # model scored on the stream's own tokens (past a near-tie the two
        # engines' streams part; the scoring follows the mesh's).
        t0 = time.perf_counter()
        params = init_params(spec, 0, dev)
        rescored = [_hold_lp(f"mesh (b) stream {i} re-scored",
                             _rescore_lp(torch, spec, params, p, g[0]), g, forced=True)
                    for i, (p, g) in enumerate(zip(prompts, got))]
        out["b_tp2_gloo"]["held_rescored"] = rescored
        emit("mesh", leg="b_rescored", held_rescored=rescored,
             seconds=round(time.perf_counter() - t0, 3))
        del params
        _require_card_empty(torch, cpu, "mesh (c)")

        # (c) sp=2 on one 8192-token prompt: the ring, then Ulysses.
        for impl in ("ring", "ulysses"):
            zero()
            t0 = time.perf_counter()
            eng = InferenceEngine(spec, mesh=make_mesh(MeshConfig(sp=2), two, backend="gloo",
                                                       timeout_s=MESH_GROUP_TIMEOUT_S),
                                  sp_impl=impl, **knobs)
            build_s = time.perf_counter() - t0
            eng.rank_reports(reset_peak=True)
            peak_reset()
            got_long = _lp_stream(eng, long_ids, 1)
            rank0_peak = peak()
            reports = eng.rank_reports()
            add(reports)
            held = _hold_lp(f"mesh (c) {impl}", ref_long, got_long)
            row = {"build_s": round(build_s, 3), "prompt_tokens": len(long_ids),
                   "admission_s": round(got_long[2], 4), "first_token": got_long[0][0],
                   "single_first_token": ref_long[0][0], **held,
                   "peak_bytes_per_rank": [rank0_peak, reports[0]["peak_bytes"]],
                   "single_peak_bytes": out["single"]["long_peak_bytes"],
                   "worker_k1_launches": reports[0]["launches"]["flash_prefill"],
                   "worker_collectives": reports[0]["collectives"]}
            if impl == "ring":
                s_loc = (spec.max_seq) // 2
                row["ring_hop_scores_bytes"] = 4 * spec.n_heads * s_loc * s_loc
            if not cpu and impl == "ulysses":
                require(reports[0]["launches"]["flash_prefill"] == spec.n_layers,
                        f"mesh (c): Ulysses launched K1 {reports[0]['launches']['flash_prefill']} "
                        f"times on rank 1, not once per layer")
            out[f"c_sp2_{impl}"] = row
            emit("mesh", leg=f"c_{impl}", **row)
            eng.shutdown()
            del eng
            _require_card_empty(torch, cpu, f"mesh (c) {impl}")
        t0 = time.perf_counter()
        out["e_dp2_gloo"] = _mesh_dp2(torch, cpu, spec, two, knobs, prompts, ref, bodies, app_for,
                                      zero, add, full_bytes)
        leg_s["e"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["f_dp2_tp2_gloo"] = _mesh_dp2_tp2(torch, cpu, tiny, model, ["cpu"] * 4 if cpu
                                              else ["cuda:0"] * 4, knobs, prompts, zero, add)
        leg_s["f"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["g_dp2_train"] = _mesh_dp2_train(torch, cpu, tiny, model, two, app_for, zero, add)
        leg_s["g"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ckpt_legs = _mesh_ckpt(torch, cpu, tiny, two, knobs, app_for, zero, add)
        out["i_ckpt_tp2_dp2"], out["j_ckpt_moe_tp2"] = ckpt_legs["i"], ckpt_legs["j"]
        leg_s["ij"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["k_pp2_gloo"] = _mesh_pp2(torch, cpu, spec, two, knobs, prompts, ref, ref_sampled,
                                      bodies, app_for, zero, add)
        leg_s["k"] = time.perf_counter() - t0
    n_cards = 0 if cpu else torch.cuda.device_count()
    if n_cards >= 2:
        t0 = time.perf_counter()
        out["h_nccl_cards"] = _mesh_nccl_cards(torch, spec, knobs, prompts, ref, zero, add)
        leg_s["h"] = time.perf_counter() - t0
    else:
        print(f"mesh: the NCCL legs over cards of their own (dp=2, tp=2) need two cards; "
              f"this machine has {n_cards}", flush=True)
    if n_cards >= 4:
        t0 = time.perf_counter()
        out["l_moe_cards"] = _mesh_cards_moe(torch, zero, add)
        leg_s["l"] = time.perf_counter() - t0
    else:
        print(f"mesh: leg (l), mixtral-8x7b at 32 layers as pp=4 and tp=4 over NCCL, needs "
              f"four cards; this machine has {n_cards}", flush=True)
    by_group = {"prefill": {"flash_prefill": 0, "flash_decode": 0},
                "decode": {"flash_prefill": 0, "flash_decode": 0}}

    def count_groups(leg):
        for g, n in leg["launches_by_group"].items():
            for k, v in n.items():
                by_group[g][k] += v

    if not cards_only:
        # (m) pp=2 training, two stages sharing the card over gloo; (n)
        # disagg with both one-rank groups on the card.
        t0 = time.perf_counter()
        out["m_pp2_train_gloo"] = _mesh_pp_train(
            torch, cpu, tiny, model, two, "m", 2, 2, 64 if tiny else TRAIN_TOKENS // 2, "gloo")
        leg_s["m"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["n_disagg_one_card"] = _mesh_disagg_card(torch, cpu, tiny, model, knobs, n_tok,
                                                     zero, add)
        count_groups(out["n_disagg_one_card"])
        leg_s["n"] = time.perf_counter() - t0
        # (r) int8 weights and KV, members, an ensemble and a grammar on tp=2
        # (two ranks sharing the card over gloo).
        t0 = time.perf_counter()
        out["r_int8_members_gloo"] = _mesh_int8_members(torch, cpu, tiny, model, two, app_for,
                                                        zero, add)
        leg_s["r"] = time.perf_counter() - t0
        # (t) paged KV, the host prefix store and zero-drain staging on tp=2
        # and dp=2 × tp=2 (ranks sharing the card over gloo).
        t0 = time.perf_counter()
        out["t_memory_knobs_gloo"] = _mesh_memory_knobs(torch, cpu, tiny, model, two, zero,
                                                        add)
        leg_s["t"] = time.perf_counter() - t0
        # (v) speculation (prompt lookup, an oracle draft), embeddings and
        # scoring on tp=2 and dp=2 × tp=2 (ranks sharing the card over gloo).
        t0 = time.perf_counter()
        out["v_spec_forwards_gloo"] = _mesh_spec_forwards(torch, cpu, tiny, model, two, zero,
                                                          add)
        leg_s["v"] = time.perf_counter() - t0
        # (x) speculation, int8 and the forwards on sp=2, int8 and the
        # forwards on pp=2 (ranks sharing the card over gloo).
        t0 = time.perf_counter()
        out["x_sp_pp_knobs_gloo"] = _mesh_sp_pp_knobs(torch, cpu, tiny, model, two, zero, add)
        leg_s["x"] = time.perf_counter() - t0
    if n_cards >= 2:
        t0 = time.perf_counter()
        out["o_disagg_cards"] = _mesh_disagg_cards(torch, cpu, model, zero, add)
        count_groups(out["o_disagg_cards"]["disagg_1p1"])
        leg_s["o"] = time.perf_counter() - t0
    else:
        print(f"mesh: leg (o), disagg=1+1 across two cards, needs two cards; this machine has "
              f"{n_cards}", flush=True)
    if n_cards >= 4:
        t0 = time.perf_counter()
        out["p_pp4_train_nccl"] = _mesh_pp_train(
            torch, cpu, tiny, model, [f"cuda:{i}" for i in range(4)], "p", 32, 4,
            TRAIN_TOKENS // 4, None)
        leg_s["p"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["q_disagg_tp2_cards"] = _mesh_disagg_tp_cards(torch, spec, knobs, prompts, zero,
                                                          add)
        count_groups(out["q_disagg_tp2_cards"])
        leg_s["q"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["s_int8_members_cards"] = _mesh_int8_cards(torch, cpu, model, card, zero, add)
        leg_s["s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["u_memory_knobs_cards"] = _mesh_memory_cards(torch, cpu, model, card, zero, add)
        leg_s["u"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["w_spec_cards"] = _mesh_spec_cards(torch, cpu, model, card, zero, add)
        leg_s["w"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["y_sp_pp_cards"] = _mesh_sp_pp_cards(
            torch, cpu, model, card, zero, add,
            l_row=out.get("l_moe_cards", {}).get("pp4_bfloat16"))
        leg_s["y"] = time.perf_counter() - t0
    else:
        print(f"mesh: legs (p), (q), (s), (u), (w) and (y), pp=4 training, disagg=2+2 with "
              f"tp=2, int8 members, the memory knobs and speculation on dp=2 × tp=2, int8 and "
              f"speculation on sp=2 × tp=2 and pp=4 over NCCL at 32 layers, need four cards; "
              f"this machine has {n_cards}", flush=True)
    out["disagg_launches_by_group"] = by_group
    out["new_leg_s"] = {k: round(v, 3) for k, v in leg_s.items()}
    emit("mesh", new_leg_s=out["new_leg_s"])
    out["launches"] = launches
    if not cpu:
        require(launches["flash_prefill"] > 0 and launches["flash_decode"] > 0
                and (launches["flash_decode_q8"] > 0 or (cards_only and n_cards < 4)),
                f"mesh: a kernel of the path was never launched ({launches})")
    out["seconds"] = round(time.perf_counter() - t_phase, 3)
    emit("mesh", launches=launches, seconds=out["seconds"], measured_on=card)
    return out


def _rank_row(eng, reports, collectives0, n_tokens: int, seconds: float) -> dict:
    """Per-rank bytes, launches and collectives of a mesh engine (rank 0
    here, the workers' from their reports)."""
    from quorum_tpu_torch.ops.flash_attention import flash_prefill_attention
    from quorum_tpu_torch.ops.flash_decode import flash_decode_attention
    from quorum_tpu_torch.parallel import collective_counts

    c1 = collective_counts()
    import torch

    dev = eng.device
    rank0 = {"rank": 0, "weight_bytes": _tree_bytes(eng.params),
             "cache_bytes": _cache_bytes(eng),
             "peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0,
             "launches": {"flash_prefill": flash_prefill_attention.launches,
                          "flash_decode": flash_decode_attention.launches},
             "collectives": {k: c1[k] - collectives0[k] for k in c1}}
    rows = [rank0] + [{k: r[k] for k in ("rank", "weight_bytes", "cache_bytes", "peak_bytes",
                                         "launches", "collectives")} for r in reports]
    return {"per_rank": rows, "ms_per_token_one_stream": round(1e3 * seconds / n_tokens, 3)}


def _mesh_dp2(torch, cpu, spec, two, knobs, prompts, ref, bodies, app_for, zero, add,
              full_bytes) -> dict:
    """Leg (e): dp=2 at full width, two ranks sharing the card over gloo,
    each holding the whole weights and 2 of the 4 slots: 4 chats through
    the app (greedy and sampled, 16 tokens), then each greedy stream held
    against the single-device engine's by its top-20 log-probabilities
    (``_hold_lp``; re-scored on the stream's own tokens where a near-tie
    parts them), every worker feeding its own rows."""
    from quorum_tpu_torch.engine.engine import InferenceEngine
    from quorum_tpu_torch.models.init import init_params
    from quorum_tpu_torch.parallel import MeshConfig, collective_counts, make_mesh

    n = 16
    zero()
    c0 = collective_counts()
    t0 = time.perf_counter()
    eng = InferenceEngine(spec, mesh=make_mesh(MeshConfig(dp=2), two, backend="gloo",
                                                timeout_s=MESH_GROUP_TIMEOUT_S), **knobs)
    build_s = time.perf_counter() - t0
    require(eng.health()["mesh"]["slot_rows"] == "sharded", "mesh (e): dp=2 did not cut the slots")
    app, backend = app_for("dp2", eng)
    eng.rank_reports(reset_peak=True)
    if not cpu:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    chats = _mesh_chats(app, [{**b, "max_tokens": n} for b in bodies], backend, n)
    chats_s = time.perf_counter() - t0
    got = [_lp_stream(eng, p, n) for p in prompts]
    reports = eng.rank_reports()
    held = [_hold_lp(f"mesh (e) stream {i}", (r[0][:n], r[1][:n]), g)
            for i, (r, g) in enumerate(zip(ref, got))]
    row = _rank_row(eng, reports, c0, sum(len(g[0]) for g in got), sum(g[2] for g in got))
    want_cache = 2 * spec.n_layers * 2 * spec.n_kv_heads * spec.max_seq * spec.head_dim * \
        torch.empty((), dtype=getattr(torch, spec.dtype)).element_size()
    for r in row["per_rank"]:
        require(r["weight_bytes"] == full_bytes, f"mesh (e): rank {r['rank']} holds "
                                                 f"{r['weight_bytes']} weight bytes, not {full_bytes}")
        require(r["cache_bytes"] == want_cache, f"mesh (e): rank {r['rank']} cache "
                                                f"{r['cache_bytes']} != {want_cache}")
    fed = reports[0]["fed"]
    require(not fed[0] and not fed[1] and any(fed[2:]) or not any(fed),
            f"mesh (e): the worker fed rows outside its dp block: {[len(f) for f in fed]}")
    if not cpu:
        require(all(r["launches"]["flash_prefill"] > 0 or r["rank"] == 0
                    for r in row["per_rank"]) and
                all(r["launches"]["flash_decode"] > 0 for r in row["per_rank"]),
                f"mesh (e): a rank launched no kernel: {[r['launches'] for r in row['per_rank']]}")
    add(reports)
    out = {"backend": eng.mesh.backend, "decode": eng.health()["mesh"]["decode"],
           "build_s": round(build_s, 3), "chats_s": round(chats_s, 3),
           "chats": [{"stream": b["stream"], "temperature": b.get("temperature"),
                      "finish": c["finish"], "completion_tokens": c["usage"]["completion_tokens"]}
                     for b, c in zip(bodies, chats)],
           "held": held, **row,
           "gathers_issued": [r["collectives"]["all_gather"] for r in row["per_rank"]],
           "eager_note": "two dp ranks sharing one card over host-staged gloo, eager decode"}
    eng.shutdown()
    del eng, app, backend
    _require_card_empty(torch, cpu, "mesh (e)")
    if not all(h["equal"] for h in held):  # a near-tie parted them: hold each whole
        params = init_params(spec, 0, "cpu" if cpu else "cuda:0")
        out["held_rescored"] = [
            _hold_lp(f"mesh (e) stream {i} re-scored", _rescore_lp(torch, spec, params, p, g[0]),
                     g, forced=True) for i, (p, g) in enumerate(zip(prompts, got))]
        del params
        _require_card_empty(torch, cpu, "mesh (e) re-scored")
    emit("mesh", leg="e", **out)
    return out


def _mesh_dp2_tp2(torch, cpu, tiny, model, four, knobs, prompts, zero, add) -> dict:
    """Leg (f): dp=2 × tp=2, four gloo ranks sharing the card, at the
    model's widths and 4 layers (1.9 GB of weights a rank at llama-3-8b):
    the greedy streams held against the single-device engine's at the same
    depth."""
    from quorum_tpu_torch.engine.engine import InferenceEngine
    from quorum_tpu_torch.models.model_config import resolve_spec
    from quorum_tpu_torch.parallel import MeshConfig, collective_counts, make_mesh

    n = 16
    spec = resolve_spec(model, {"head_dim": "64", "dtype": "bfloat16", "n_kv_heads": "4"}
                         if tiny else {"n_layers": "4"})
    ref_eng = InferenceEngine(spec, device="cpu" if cpu else "cuda:0", **knobs)
    ref = [_lp_stream(ref_eng, p, n) for p in prompts]
    ref_eng.shutdown()
    del ref_eng
    _require_card_empty(torch, cpu, "mesh (f) reference")
    zero()
    c0 = collective_counts()
    t0 = time.perf_counter()
    eng = InferenceEngine(spec, mesh=make_mesh(MeshConfig(dp=2, tp=2), four, backend="gloo",
                                                timeout_s=MESH_GROUP_TIMEOUT_S), **knobs)
    build_s = time.perf_counter() - t0
    got = [_lp_stream(eng, p, n) for p in prompts]
    reports = eng.rank_reports()
    held = [_hold_lp(f"mesh (f) stream {i}", r, g) for i, (r, g) in enumerate(zip(ref, got))]
    require(all(h["equal"] or h["near_ties"] for h in held), f"mesh (f): {held}")
    row = _rank_row(eng, reports, c0, sum(len(g[0]) for g in got), sum(g[2] for g in got))
    add(reports)
    out = {"layers": spec.n_layers, "build_s": round(build_s, 3), "held": held, **row,
           "gathers_issued": [r["collectives"]["all_gather"] for r in row["per_rank"]]}
    eng.shutdown()
    del eng
    _require_card_empty(torch, cpu, "mesh (f)")
    emit("mesh", leg="f", **out)
    return out


# Leg (g): the dp=2 step's losses against the one-rank step's on the same
# two rows, relative: one bfloat16 rounding (2^-8; the ranks' one-row
# GEMMs and the one rank's two-row ones round differently).
TRAIN_DP_LOSS_REL = 2.0 ** -8


def _mesh_dp2_train(torch, cpu, tiny, model, two, app_for, zero, add) -> dict:
    """Leg (g): dp=2 training, two ranks sharing the card over gloo, at the
    model's widths and 1 layer (the gradient all-reduce over gloo, most of
    it the embedding's and the head's, is most of the leg): 2 steps on 2 ×
    2048 tokens (one row a rank) against the one-rank step on the same
    2-row batch (losses within
    ``TRAIN_DP_LOSS_REL``); the dp state saved, restored onto one rank with
    every leaf equal (``tree_digest``), and one greedy chat served from it
    through the app (K1 and K2 launch)."""
    import shutil
    import tempfile

    import numpy as np

    from quorum_tpu_torch.engine.engine import InferenceEngine
    from quorum_tpu_torch.models.model_config import resolve_spec
    from quorum_tpu_torch.parallel import MeshConfig, RankGroup, make_mesh
    from quorum_tpu_torch.training import checkpoint, trainer

    spec = resolve_spec(model, {"head_dim": "64", "dtype": "bfloat16"} if tiny
                         else {"n_layers": "1"})
    n_tokens = 64 if tiny else TRAIN_TOKENS
    steps = 2  # each a gloo all-reduce of ≈ 5 GB of f32 gradients
    dev = "cpu" if cpu else "cuda:0"
    tokens = np.random.default_rng(7).integers(1, spec.vocab_size, (2, n_tokens))
    # One rank on the whole batch.
    t0 = time.perf_counter()
    opt = trainer.make_optimizer()
    state = trainer.train_init(spec, device=dev, seed=0, optimizer=opt)
    step = trainer.make_train_step(spec, device=dev, optimizer=opt)
    want = []
    for _ in range(steps):
        state, loss = step(state, tokens)
        want.append(float(loss))
    one_s = time.perf_counter() - t0
    del state, step
    gc.collect()
    _require_card_empty(torch, cpu, "mesh (g) one rank")
    # dp=2: rank 0 here, rank 1 spawned; each takes its row.
    root = tempfile.mkdtemp(prefix="quorum_dp_train_")
    path = os.path.join(root, "ckpt")
    try:
        t0 = time.perf_counter()
        grp = RankGroup(make_mesh(MeshConfig(dp=2), two, backend="gloo",
                                  timeout_s=MESH_GROUP_TIMEOUT_S))
        grp.start()
        try:
            start_s = time.perf_counter() - t0
            runs = grp.run("quorum_tpu_torch.training.trainer:train_steps",
                           [(spec, tokens)] * 2,
                           [dict(seed=0, steps=steps, save=path, digest=True)] * 2)
        finally:
            grp.stop()
        dp_s = time.perf_counter() - t0
        gc.collect()
        _require_card_empty(torch, cpu, "mesh (g) dp=2")
        got = runs[0]["losses"]
        require(runs[1]["losses"] == got, f"mesh (g): the ranks' losses differ: "
                                          f"{got} / {runs[1]['losses']}")
        rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
        require(max(rel) <= TRAIN_DP_LOSS_REL,
                f"mesh (g): dp=2 losses {got} vs one rank {want} (relative {rel})")
        require(runs[0]["digest"] == runs[1]["digest"], "mesh (g): the dp replicas differ")
        # Restored onto one rank: every leaf as saved.
        t0 = time.perf_counter()
        restored = checkpoint.restore_checkpoint(path, spec, device=dev, optimizer=opt)
        restore_s = time.perf_counter() - t0
        require(int(restored.step) == steps, f"mesh (g): restored step {restored.step}")
        require({"params": checkpoint.tree_digest(restored.params),
                 "opt_state": checkpoint.tree_digest(restored.opt_state)} == runs[0]["digest"],
                "mesh (g): the restored leaves differ from the dp=2 state's")
        params = restored.params
        del restored
        gc.collect()
        # One greedy chat from the restored weights, through the app.
        zero()
        eng = InferenceEngine(spec, device=dev, params=params, n_slots=2, seed=0)
        app, backend = app_for("dp_ckpt", eng)
        body = {"model": model, "messages": [{"role": "user", "content": "Say hello."}],
                "max_tokens": 8, "temperature": 0.0, "stream": False}
        (chat,) = _mesh_chats(app, [body], backend, 8)
        from quorum_tpu_torch.ops.flash_attention import flash_prefill_attention
        from quorum_tpu_torch.ops.flash_decode import flash_decode_attention

        k1, k2 = flash_prefill_attention.launches, flash_decode_attention.launches
        if not cpu:
            require(k1 > 0 and k2 > 0, f"mesh (g): the served chat launched K1 {k1}, K2 {k2}")
        add()
        eng.shutdown()
        del eng, app, backend, params
        gc.collect()
        _require_card_empty(torch, cpu, "mesh (g)")
        saved = runs[0]["saved_bytes"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out = {"layers": spec.n_layers, "tokens_per_rank_step": n_tokens, "steps": steps,
           "losses_dp2": got, "losses_one_rank": want, "loss_rel_diff": rel,
           "one_rank_s": round(one_s, 3), "group_start_s": round(start_s, 3),
           "dp2_s": round(dp_s, 3),
           "ms_per_step": [round(1e3 * x, 2) for x in runs[0]["step_s"]],
           "grad_allreduce_s": round(runs[0]["grad_allreduce_s"], 3),
           "grad_allreduce_bytes": runs[0]["grad_allreduce_bytes"],
           "peak_bytes_per_rank": [r["peak_bytes"] for r in runs],
           "saved_bytes": saved, "restore_s": round(restore_s, 3), "leaves_equal": True,
           "served_chat": {"finish": chat["finish"],
                           "completion_tokens": chat["usage"]["completion_tokens"],
                           "k1_launches": k1, "k2_launches": k2}}
    emit("mesh", leg="g", **out)
    return out


def _mesh_nccl_cards(torch, spec, knobs, prompts, ref, zero, add) -> dict:
    """Leg (h), on a machine with two or more cards only: dp=2 and tp=2 over
    NCCL, each rank on a card of its own, decoding from graphs on every
    rank: the greedy streams held against the single-device engine's, one
    stream again once its key is captured (its ms a token, admission
    included), then the shutdown timed."""
    from quorum_tpu_torch.engine.engine import InferenceEngine
    from quorum_tpu_torch.parallel import MeshConfig, collective_counts, make_mesh

    n = 16
    out = {}
    for name, axes in (("tp2", dict(tp=2)), ("dp2", dict(dp=2))):
        zero()
        c0 = collective_counts()
        t0 = time.perf_counter()
        eng = InferenceEngine(spec, mesh=make_mesh(MeshConfig(**axes), ["cuda:0", "cuda:1"],
                                                    timeout_s=MESH_GROUP_TIMEOUT_S), **knobs)
        build_s = time.perf_counter() - t0
        require(eng.mesh.backend == "nccl" and eng.health()["mesh"]["decode"] == "graphs",
                f"mesh (h) {name}: not NCCL with graphs")
        got = [_lp_stream(eng, p, n) for p in prompts]
        # Once the key is captured: a stream's decode from graph replays.
        warm = _lp_stream(eng, prompts[0], n)
        require(warm[0] == got[0][0], f"mesh (h) {name}: a second stream differs")
        reports = eng.rank_reports()
        held = [_hold_lp(f"mesh (h) {name} stream {i}", (r[0][:n], r[1][:n]), g)
                for i, (r, g) in enumerate(zip(ref, got))]
        require(all(h["equal"] or h["near_ties"] for h in held), f"mesh (h) {name}: {held}")
        row = _rank_row(eng, reports, c0, sum(len(g[0]) for g in got), sum(g[2] for g in got))
        require(all(r["launches"]["flash_decode"] > 0 for r in row["per_rank"]),
                f"mesh (h) {name}: a rank launched no K2")
        add(reports)
        pids = eng.worker_pids()
        t0 = time.perf_counter()
        eng.shutdown()
        shutdown_s = time.perf_counter() - t0
        left = [p for p in pids if os.path.exists(f"/proc/{p}")]
        require(not left and shutdown_s < 15.0,
                f"mesh (h) {name}: shutdown took {shutdown_s:.1f} s, processes left {left}")
        out[name] = {"build_s": round(build_s, 3), "held": held, **row,
                     "ms_per_token_warm_stream": round(1e3 * warm[2] / len(warm[0]), 3),
                     "captures": eng.metrics()["decode_graph_captures_total"],
                     "shutdown_s": round(shutdown_s, 3)}
        del eng
        _require_card_empty(torch, False, f"mesh (h) {name}")
        emit("mesh", leg=f"h_{name}", **out[name])
    return out


def _hold_sampled(torch, what: str, spec, params_of, prompt, ref, got, seed: int,
                  temperature: float, top_p: float) -> dict:
    """A sampled stream ``got`` against ``ref`` (the same seed, so the same
    Gumbel noise: the request's generator draws one row a token, in token
    order). Equal, or parted at step K only at a near-tie: the
    single-device model (``params_of()``) scores the shared prefix, the
    noise of token K is drawn again from the seed, and the score gap
    (log-probability / T + noise, top-p applied) between the two tokens
    served there must be within 2 (δ + ε) / T, δ the two streams'
    log-probability difference at step K (shared top-20 ids), ε the
    re-scoring's own against the reference's record."""
    from quorum_tpu_torch.models.transformer import forward_hidden, unembed
    from quorum_tpu_torch.ops.sampling import _apply_cutoffs, gumbel_noise

    def diff(a, b):
        amap = dict(zip((int(x) for x in a[1]), (float(x) for x in a[2])))
        bmap = dict(zip((int(x) for x in b[1]), (float(x) for x in b[2])))
        shared = set(amap) & set(bmap)
        return max((abs(amap[j] - bmap[j]) for j in shared), default=0.0)

    parted = next((i for i, (a, b) in enumerate(zip(ref[0], got[0])) if a != b), None)
    steps = len(got[0]) if parted is None else parted + 1
    deltas = [diff(r, g) for r, g in zip(ref[1][:steps], got[1][:steps])]
    require(max(deltas) <= MESH_LP_TOL, f"{what}: log-probabilities differ by {max(deltas)}")
    if parted is None:
        require(len(got[0]) == len(ref[0]), f"{what}: {len(got[0])} tokens, the reference "
                                            f"{len(ref[0])}")
        return {"equal": True, "logprob_max_diff": max(deltas)}
    params = params_of()
    dev = params["tok_emb"].device
    with torch.inference_mode():
        ids = torch.tensor([list(prompt) + list(got[0][:parted])], device=dev)
        lp = torch.log_softmax(unembed(params, spec, forward_hidden(params, spec, ids)[:, -1])
                               .float(), dim=-1)[0]
        gen = torch.Generator(device=dev).manual_seed(seed)
        for _ in range(parted + 1):
            noise = gumbel_noise(spec.vocab_size, gen)
        scaled = _apply_cutoffs((lp / temperature)[None], torch.tensor([top_p], device=dev),
                                torch.tensor([0], device=dev))[0]
        score = scaled + noise
        rt, gt = ref[0][parted], got[0][parted]
        gap = float(score[rt] - score[gt])
        r_rec = ref[1][parted]
        eps = max(abs(float(lp[int(j)]) - float(v)) for j, v in zip(r_rec[1], r_rec[2]))
    delta = deltas[parted]
    require(gap == gap and gap <= 2 * (delta + eps) / temperature,
            f"{what}: step {parted} served {gt} over {rt}: score gap {gap} > "
            f"2 (δ {delta} + ε {eps}) / T")
    return {"equal": False, "parted_at": parted, "score_gap": gap, "delta": delta,
            "rescore_eps": eps, "logprob_max_diff": max(deltas)}


def _rank_digests(torch, params, mesh, spec) -> list[dict]:
    """``training/checkpoint.tree_digest`` of every rank's cut of the whole
    tree ``params`` (``models/convert.shard_params``), rank 0 first."""
    from quorum_tpu_torch.models.convert import shard_params
    from quorum_tpu_torch.training.checkpoint import tree_digest

    out = []
    for r in range(mesh.size):
        cut = shard_params(params, mesh, r, spec)
        out.append(tree_digest(cut))
        del cut
    return out


def _mesh_ckpt(torch, cpu, tiny, two, knobs, app_for, zero, add) -> dict:
    """Legs (i) and (j): local HF checkpoints on multi-rank engines, ranks
    sharing the card over gloo. (i) llama-3-8b at full width and 2 layers,
    written by ``_write_hf_checkpoint`` and served through
    ``get_engine_from_ckpt(mesh=)`` at tp=2 and at dp=2; (j) mixtral-8x7b at
    full width and 1 layer at tp=2 (4 of its 8 experts a rank), in float32:
    in bf16 the tp sums' rounding moves the residual enough to flip a
    near-tied expert pick, after which the streams part by more than any
    token near-tie (seen on the H100: a token outside the reference's
    top-20 at step 7). On each
    engine: no weights shipped (every worker's set-up names the checkpoint,
    no shard); every rank's leaves equal the matching cut of the written
    tree bit for bit (rank 0's by ``torch.equal``, each worker's by its
    ``tree_digest``); each rank's weight bytes its cut's; one chat through
    the app; each greedy stream held against the single-device engine's on
    the written tree (``_hold_lp``)."""
    import shutil
    import tempfile

    from quorum_tpu_torch.engine.engine import (InferenceEngine, get_engine_from_ckpt,
                                                release_engine)
    from quorum_tpu_torch.models.convert import shard_params
    from quorum_tpu_torch.models.init import init_params
    from quorum_tpu_torch.models.model_config import resolve_spec
    from quorum_tpu_torch.parallel import MeshConfig, collective_counts, make_mesh

    dev = "cpu" if cpu else "cuda:0"
    n = 16
    out = {}
    root = tempfile.mkdtemp(prefix="quorum_mesh_ckpt_")
    cases = (("i", "llama-tiny" if tiny else "llama-3-8b", "llama",
              {"head_dim": "64", "n_layers": "4"} if tiny else {"n_layers": "2"},
              (("tp2", dict(tp=2)), ("dp2", dict(dp=2)))),
             ("j", "mixtral-tiny" if tiny else "mixtral-8x7b", "mixtral",
              {"head_dim": "64", "n_layers": "1", "dtype": "float32"} if tiny
              else {"n_layers": "1", "dtype": "float32"},
              (("tp2", dict(tp=2)),)))
    try:
        for leg, model, model_type, opts, meshes in cases:
            t_leg = time.perf_counter()
            spec = resolve_spec(model, opts)
            params = init_params(spec, 0, dev)
            path = os.path.join(root, model)
            os.makedirs(path)
            t0 = time.perf_counter()
            written = _write_hf_checkpoint(torch, path, spec, params, model_type)
            write_s = time.perf_counter() - t0
            ref_eng = InferenceEngine(spec, device=dev, params=params, n_slots=4, decode_chunk=8)
            tok = _backend_tokenizer(ref_eng, model)
            bodies = _serve_bodies(model, tiny)
            prompts = [tok.encode(tok.render_chat(b["messages"])) for b in bodies[:2]]
            ref = [_lp_stream(ref_eng, p, n) for p in prompts]
            ref_eng.shutdown()
            del ref_eng
            digests = None
            rows = {}
            for name, axes in meshes:
                zero()
                c0 = collective_counts()
                mesh = make_mesh(MeshConfig(**axes), two, backend="gloo",
                                 timeout_s=MESH_GROUP_TIMEOUT_S)
                t0 = time.perf_counter()
                eng = get_engine_from_ckpt(path, dtype=spec.dtype, mesh=mesh, n_slots=4,
                                           decode_chunk=8)
                load_s = time.perf_counter() - t0
                setup = eng._ranks._setup(1)[1]
                require(setup["shard"] is None and setup["ckpt"][0] == os.path.realpath(path),
                        f"mesh ({leg}) {name}: rank 0 ships weights to its workers")
                mine = shard_params(params, mesh, 0, spec)
                got0, want0 = list(_hf_params(eng.params)), list(_hf_params(mine))
                require(len(got0) == len(want0) and all(
                    a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
                    for a, b in zip(got0, want0)),
                    f"mesh ({leg}) {name}: a rank-0 leaf differs from its cut of the written tree")
                del got0, want0, mine
                digests = _rank_digests(torch, params, mesh, spec)
                reports = eng.rank_reports(digest=True)
                for r, rep in enumerate(reports, start=1):
                    require(rep["digest"] == digests[r],
                            f"mesh ({leg}) {name}: rank {r}'s leaves differ from its cut")
                cut_bytes = [_tree_bytes(shard_params(params, mesh, r, spec))
                             for r in range(mesh.size)]
                have = [_tree_bytes(eng.params)] + [rep["weight_bytes"] for rep in reports]
                require(have == cut_bytes, f"mesh ({leg}) {name}: weight bytes {have}, the "
                                           f"cuts {cut_bytes}")
                if spec.is_moe:
                    per = eng.params["blocks"]["moe_w_up"].shape[1]
                    require(per == spec.n_experts // 2,
                            f"mesh ({leg}) {name}: rank 0 holds {per} experts")
                app, backend = app_for(f"{leg}_{name}", eng)
                (chat,) = _mesh_chats(app, [{**bodies[0], "max_tokens": 8}], backend, 8)
                got = [_lp_stream(eng, p, n) for p in prompts]
                held = [_hold_lp(f"mesh ({leg}) {name} stream {i}", r, g)
                        for i, (r, g) in enumerate(zip(ref, got))]
                reports = eng.rank_reports()
                row = _rank_row(eng, reports, c0, sum(len(g[0]) for g in got),
                                sum(g[2] for g in got))
                if not cpu:  # every tp rank admits; under dp the slot's owner does
                    k1 = [r["launches"]["flash_prefill"] > 0 for r in row["per_rank"]]
                    require((all(k1) if "tp" in axes else any(k1)) and all(
                        r["launches"]["flash_decode"] > 0 for r in row["per_rank"]),
                            f"mesh ({leg}) {name}: a rank launched no kernel: "
                            f"{[r['launches'] for r in row['per_rank']]}")
                add(reports)
                rows[name] = {"load_s": round(load_s, 3), "weight_bytes_per_rank": have,
                              "leaves_equal_cut": True, "shipped_weights": False,
                              "chat": {"finish": chat["finish"],
                                       "completion_tokens": chat["usage"]["completion_tokens"]},
                              "held": held, **row}
                release_engine(eng)
                del eng, app, backend
            out[leg] = {"model": model, "layers": spec.n_layers, "bytes_written": written,
                        "write_s": round(write_s, 3), **rows,
                        "seconds": round(time.perf_counter() - t_leg, 3)}
            emit("mesh", leg=leg, **out[leg])
            del params
            shutil.rmtree(path, ignore_errors=True)
            _require_card_empty(torch, cpu, f"mesh ({leg})")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def _backend_tokenizer(eng, model):
    """The tokenizer a ``cuda://`` backend over ``eng`` serves with."""
    from quorum_tpu_torch.backends.cuda_backend import CudaBackend

    return CudaBackend("tok", eng, model=model, model_id=model).tokenizer


def _stage_occupancy_seen(eng, prompt, n) -> dict:
    """The staged engine's ``decode_stage_occupancy`` gauge read while one
    stream decodes: the largest value each stage's series showed."""
    import threading

    from quorum_tpu_torch import observability as obs

    seen: dict[str, float] = {}
    th = threading.Thread(target=lambda: _lp_stream(eng, prompt, n), daemon=True)
    th.start()
    while th.is_alive():
        for ln in obs.DECODE_STAGE_OCCUPANCY.expose():
            if ln.startswith("quorum_tpu_decode_stage_occupancy{"):
                stage = ln.split('stage="')[1].split('"')[0]
                seen[stage] = max(seen.get(stage, 0.0), float(ln.rsplit(" ", 1)[1]))
        time.sleep(0.002)
    th.join()
    return seen


def _mesh_pp2(torch, cpu, spec, two, knobs, prompts, ref, ref_sampled, bodies, app_for,
              zero, add) -> dict:
    """Leg (k): pp=2 at full depth (32 layers of llama-3-8b, 16 a stage),
    two stages sharing the card over gloo (host-staged hops, eager decode):
    each stage holds its 16 layers' weights and cache; one chat through the
    app; the greedy and the sampled streams held against the single-device
    engine's (a sampled one to where it parts at a near-tie of the
    sampled scores, ``_hold_sampled``); ``decode_stage_occupancy`` seen
    non-zero on a stage while a stream decodes; K1 and K2 launched on both stages, K2 once per layer
    per group step (each stage L × decode steps), K1 once per stage layer
    per admission; ms a token of one stream."""
    from quorum_tpu_torch.engine.engine import InferenceEngine
    from quorum_tpu_torch.models.init import init_params
    from quorum_tpu_torch.ops.sampling import SamplerConfig
    from quorum_tpu_torch.parallel import MeshConfig, collective_counts, make_mesh

    n = len(ref[0][0])
    zero()
    c0 = collective_counts()
    t0 = time.perf_counter()
    eng = InferenceEngine(spec, mesh=make_mesh(MeshConfig(pp=2), two, backend="gloo",
                                                timeout_s=MESH_GROUP_TIMEOUT_S), **knobs)
    build_s = time.perf_counter() - t0
    half = spec.n_layers // 2
    require(eng.decode_pp == 2 and eng._ck.shape[0] == half
            and eng.params["blocks"]["wq"].shape[0] == half,
            "mesh (k): stage 0 does not hold half the layers")
    app, backend = app_for("pp2", eng)
    (chat,) = _mesh_chats(app, [{**bodies[0], "max_tokens": 8}], backend, 8)
    m0 = eng.metrics()
    got = [_lp_stream(eng, p, n) for p in prompts]
    sampled = [_lp_stream(eng, p, n, sampler=SamplerConfig(temperature=0.8, top_p=0.9), seed=7)
               for p in prompts]
    occupancy = _stage_occupancy_seen(eng, prompts[0], 8)
    m1 = eng.metrics()
    reports = eng.rank_reports()
    held = [_hold_lp(f"mesh (k) stream {i}", r, g) for i, (r, g) in enumerate(zip(ref, got))]
    require(any(v > 0 for v in occupancy.values()) and set(occupancy) >= {"0", "1"},
            f"mesh (k): decode_stage_occupancy not live: {occupancy}")
    row = _rank_row(eng, reports, c0, sum(len(g[0]) for g in got), sum(g[2] for g in got))
    steps = m1["decode_steps_total"]
    admissions = m1["admission_dispatches_total"]
    k1 = [r["launches"]["flash_prefill"] for r in row["per_rank"]]
    k2 = [r["launches"]["flash_decode"] for r in row["per_rank"]]
    if not cpu:
        require(k1 == [half * admissions] * 2 and k2 == [spec.n_layers * steps] * 2,
                f"mesh (k): K1/K2 by stage {k1}/{k2} for {admissions} admissions and "
                f"{steps} decode steps")
    cache = [r["cache_bytes"] for r in row["per_rank"]]
    require(cache[0] == cache[1] and row["per_rank"][1]["weight_bytes"]
            < row["per_rank"][0]["weight_bytes"],
            f"mesh (k): stage bytes {[r['weight_bytes'] for r in row['per_rank']]}, cache {cache}")
    add(reports)
    health = eng.health()["mesh"]["decode"]
    eng.shutdown()
    del eng, app, backend
    _require_card_empty(torch, cpu, "mesh (k)")
    model = []  # the single-device model, built only to re-score a parted stream

    def params_of():
        if not model:
            model.append(init_params(spec, 0, "cpu" if cpu else "cuda:0"))
        return model[0]

    held_s = [_hold_sampled(torch, f"mesh (k) sampled stream {i}", spec, params_of, p, r, g, 7,
                            0.8, 0.9)
              for i, (p, r, g) in enumerate(zip(prompts, ref_sampled, sampled))]
    del model
    _require_card_empty(torch, cpu, "mesh (k) re-scored")
    out = {"layers": spec.n_layers, "layers_per_stage": half, "build_s": round(build_s, 3),
           "decode": health, "decode_pp": m1["decode_pp"],
           "chat": {"finish": chat["finish"],
                    "completion_tokens": chat["usage"]["completion_tokens"]},
           "held": held, "held_sampled": held_s, "occupancy_max_by_stage": occupancy,
           "k1_by_stage": k1, "k2_by_stage": k2, "decode_steps": steps,
           "decode_steps_streams": m1["decode_steps_total"] - m0["decode_steps_total"],
           "admissions": admissions, **row,
           "eager_note": "two stages sharing one card over host-staged gloo, eager decode: "
                         "not a pp=2 deployment's step time"}
    emit("mesh", leg="k", **out)
    return out


def _lp_compare(ref, got) -> dict:
    """Two greedy streams side by side, without a verdict: the steps they
    agree on, the first step they part at, and the largest top-20
    log-probability difference to there."""
    parted, deltas = None, []
    for i, (rt, gt, (_, r_ids, r_lps), (_, g_ids, g_lps)) in enumerate(
            zip(ref[0], got[0], ref[1], got[1])):
        rmap = dict(zip((int(x) for x in r_ids), (float(x) for x in r_lps)))
        gmap = dict(zip((int(x) for x in g_ids), (float(x) for x in g_lps)))
        deltas.append(max((abs(rmap[j] - gmap[j]) for j in set(rmap) & set(gmap)),
                          default=float("inf")))
        if rt != gt:
            parted = i
            break
    return {"steps_compared": len(deltas), "parted_at": parted,
            "logprob_max_diff": max(deltas), "equal": list(ref[0]) == list(got[0])}


def _mesh_cards_moe(torch, zero, add) -> dict:
    """Leg (l), four cards or more: mixtral-8x7b at all 32 layers, seed 0,
    no single card holding it, served as pp=4 over NCCL (staged graphs,
    stage s on ``cuda:s``) and as tp=4 (2 of 8 experts a rank): in bf16
    (≈ 93 GB) and again in float32 (≈ 187 GB). Each rank's weight bytes
    within its share, its peak memory, K1 and K2 launched on every rank; a
    first greedy stream (its first capture inside) and a second, warm one
    timed apart; both engines admit single-shot (pp=4 does; an MoE
    prompt's expert capacity is sized by the admitted batch). The two
    engines' greedy streams are held against each other (``_hold_lp``) in
    float32; in bf16 they are set side by side
    (``_lp_compare``) and not held, because there either engine's rounding
    can flip a near-tied expert pick in one of 32 layers, which moves the
    log-probabilities by more than any token near-tie (leg (j) in bf16
    parted outside the top-20 for that reason)."""
    from quorum_tpu_torch.engine.engine import InferenceEngine
    from quorum_tpu_torch.models.model_config import resolve_spec
    from quorum_tpu_torch.parallel import MeshConfig, collective_counts, make_mesh

    gen = random.Random(23)
    n = 24
    out = {}
    for dtype in ("bfloat16", "float32"):
        spec = resolve_spec("mixtral-8x7b", {"dtype": dtype})
        prompts = [[gen.randrange(spec.vocab_size) for _ in range(k)] for k in (200, 900)]
        streams = {}
        for name, axes in (("pp4", dict(pp=4)), ("tp4", dict(tp=4))):
            zero()
            c0 = collective_counts()
            t0 = time.perf_counter()
            # Both admit single-shot (pp does; prefill_chunk=0 for tp): an MoE
            # prompt's expert capacity is sized by the admitted batch, so a
            # chunked admission drops other picks than a whole one.
            eng = InferenceEngine(spec, mesh=make_mesh(MeshConfig(**axes),
                                                        [f"cuda:{i}" for i in range(4)],
                                                        timeout_s=MESH_GROUP_TIMEOUT_S),
                                  n_slots=4, decode_chunk=8, seed=0, prefill_chunk=0)
            build_s = time.perf_counter() - t0
            what = f"mesh (l) {dtype} {name}"
            require(eng.mesh.backend == "nccl" and eng.health()["mesh"]["decode"] == "graphs",
                    f"{what}: not NCCL with graphs")
            eng.rank_reports(reset_peak=True)
            torch.cuda.reset_peak_memory_stats()
            first = [_lp_stream(eng, p, n) for p in prompts]
            warm = _lp_stream(eng, prompts[0], n)
            require(warm[0] == first[0][0], f"{what}: the warm stream differs")
            reports = eng.rank_reports()
            row = _rank_row(eng, reports, c0, sum(len(g[0]) for g in first),
                            sum(g[2] for g in first))
            total = sum(r["weight_bytes"] for r in row["per_rank"])
            model_bytes = total_model_bytes(spec)
            for r in row["per_rank"]:
                require(r["weight_bytes"] <= 0.27 * model_bytes,
                        f"{what}: rank {r['rank']} holds {r['weight_bytes']} bytes")
                require(r["launches"]["flash_decode"] > 0 and r["launches"]["flash_prefill"] > 0,
                        f"{what}: rank {r['rank']} launched no K1 or K2")
            streams[name] = first
            add(reports)
            m = eng.metrics()
            pids = eng.worker_pids()
            t0 = time.perf_counter()
            eng.shutdown()
            shutdown_s = time.perf_counter() - t0
            left = [p for p in pids if os.path.exists(f"/proc/{p}")]
            require(not left, f"{what}: processes left {left}")
            row = {"build_s": round(build_s, 3), "model_bytes": model_bytes,
                   "weight_bytes_all_ranks": total,
                   "layers_per_rank": spec.n_layers // axes.get("pp", 1), **row,
                   "first_stream_s": round(first[0][2], 3),
                   "ms_per_token_first_stream": round(1e3 * first[0][2] / len(first[0][0]), 3),
                   "ms_per_token_warm_stream": round(1e3 * warm[2] / len(warm[0]), 3),
                   "captures": m["decode_graph_captures_total"],
                   "capture_s": m["decode_graph_capture_seconds_total"],
                   "shutdown_s": round(shutdown_s, 3)}
            out[f"{name}_{dtype}"] = row
            del eng
            _require_card_empty(torch, False, what)
            emit("mesh", leg=f"l_{name}_{dtype}", **row)
        pairs = list(enumerate(zip(streams["pp4"], streams["tp4"])))
        if dtype == "float32":
            out["held_tp4_against_pp4"] = [_hold_lp(f"mesh (l) float32 stream {i}", r, g)
                                           for i, (r, g) in pairs]
        else:
            out["bfloat16_side_by_side"] = [_lp_compare(r, g) for _, (r, g) in pairs]
    emit("mesh", leg="l_held", held=out["held_tp4_against_pp4"],
         bfloat16_side_by_side=out["bfloat16_side_by_side"])
    return out


def _kv_token_bytes(torch, spec) -> int:
    """K and V bytes of one token over every layer and kv head."""
    size = torch.empty((), dtype=getattr(torch, spec.dtype)).element_size()
    return 2 * spec.n_layers * spec.n_kv_heads * spec.head_dim * size


def _pp_train_tokens(np, vocab: int, rows: int, n_tokens: int):
    return np.random.default_rng(7).integers(1, vocab, (rows, n_tokens))


def _mesh_pp_train(torch, cpu, tiny, model, devices, label: str, n_layers: int, rows: int,
                   n_tokens: int, backend: str | None) -> dict:
    """Legs (m) and (p): pipelined training (``parallel/pipeline.py``'s GPipe
    step) at the model's widths and ``n_layers`` layers, bf16, remat,
    ``rows`` rows of ``n_tokens`` tokens in ``rows`` microbatches (one row
    each), one stage a device of ``devices``: ``TRAIN_STEPS`` steps against
    the one-rank step on the same seed and batch (losses within
    ``TRAIN_DP_LOSS_REL``), each step's ms, each stage's peak memory
    against the one-rank state's bytes and peak, the bubble's share by
    schedule. The training forward attends through the plain attention:
    no kernel launches (K1 has no backward)."""
    import numpy as np

    from quorum_tpu_torch.models.model_config import resolve_spec
    from quorum_tpu_torch.ops.flash_attention import flash_prefill_attention
    from quorum_tpu_torch.ops.flash_decode import flash_decode_attention
    from quorum_tpu_torch.parallel import MeshConfig, RankGroup, make_mesh
    from quorum_tpu_torch.training import trainer

    pp = len(devices)
    spec = resolve_spec(model, {"head_dim": "64", "dtype": "bfloat16", "n_layers": str(n_layers)}
                         if tiny else {"n_layers": str(n_layers)})
    dev = "cpu" if cpu else "cuda:0"
    tokens = _pp_train_tokens(np, spec.vocab_size, rows, n_tokens)
    k0 = (flash_prefill_attention.launches, flash_decode_attention.launches)
    # One rank on the whole batch.
    if not cpu:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    opt = trainer.make_optimizer()
    state = trainer.train_init(spec, device=dev, seed=0, optimizer=opt)
    state_bytes = _tree_bytes(state.params) + sum(
        t.numel() * t.element_size() for t in _state_tensors(state.opt_state))
    step = trainer.make_train_step(spec, device=dev, optimizer=opt)
    want, one_ms = [], []
    for _ in range(TRAIN_STEPS):
        t1 = time.perf_counter()
        state, loss = step(state, tokens)
        want.append(float(loss))
        one_ms.append(1e3 * (time.perf_counter() - t1))
    one_s = time.perf_counter() - t0
    one_peak = None if cpu else torch.cuda.max_memory_allocated()
    del state, step
    gc.collect()
    _require_card_empty(torch, cpu, f"mesh ({label}) one rank")
    t0 = time.perf_counter()
    grp = RankGroup(make_mesh(MeshConfig(pp=pp), devices, backend=backend,
                              timeout_s=MESH_GROUP_TIMEOUT_S))
    grp.start()
    try:
        start_s = time.perf_counter() - t0
        if not cpu:
            torch.cuda.reset_peak_memory_stats()
        runs = grp.run("quorum_tpu_torch.training.trainer:train_steps",
                       [(spec, tokens)] * pp,
                       [dict(seed=0, steps=TRAIN_STEPS, n_micro=rows)] * pp)
    finally:
        grp.stop()
    pp_s = time.perf_counter() - t0
    gc.collect()
    _require_card_empty(torch, cpu, f"mesh ({label}) pp={pp}")
    got = runs[0]["losses"]
    require(all(r["losses"] == got for r in runs),
            f"mesh ({label}): the stages' losses differ: {[r['losses'] for r in runs]}")
    rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    require(max(rel) <= TRAIN_DP_LOSS_REL,
            f"mesh ({label}): pp={pp} losses {got} vs one rank {want} (relative {rel})")
    require(got[-1] < got[0], f"mesh ({label}): the loss did not fall: {got}")
    k1 = flash_prefill_attention.launches - k0[0]
    k2 = flash_decode_attention.launches - k0[1]
    require(k1 == 0 and k2 == 0, f"mesh ({label}): training launched K1 {k1}, K2 {k2}")
    out = {"pp": pp, "backend": grp.mesh.backend, "devices": [str(d) for d in devices],
           "layers": spec.n_layers, "rows": rows, "tokens_per_row": n_tokens,
           "n_micro": rows, "steps": TRAIN_STEPS, "losses_pp": got, "losses_one_rank": want,
           "loss_rel_diff": rel, "ms_per_step": [round(1e3 * x, 2) for x in runs[0]["step_s"]],
           "one_rank_ms_per_step": [round(x, 2) for x in one_ms],
           "one_rank_s": round(one_s, 3), "group_start_s": round(start_s, 3),
           "pp_s": round(pp_s, 3), "peak_bytes_per_stage": [r["peak_bytes"] for r in runs],
           "one_rank_state_bytes": state_bytes, "one_rank_peak_bytes": one_peak,
           "bubble_share_by_schedule": round((pp - 1) / (rows + pp - 1), 4),
           "k1_launches": k1, "k2_launches": k2}
    emit("mesh", leg=label, **out)
    return out


def _state_tensors(tree):
    """The tensors of an optimizer state (NamedTuples, tuples, dicts)."""
    if tree is None:
        return []
    if hasattr(tree, "numel"):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _state_tensors(v)]
    return [t for v in tree for t in _state_tensors(v)]


def _mesh_disagg_card(torch, cpu, tiny, model, knobs, n_tok: int, zero, add) -> dict:
    """Leg (n): disaggregated serving with both one-rank groups on one card
    (the explicit API: ``prefill_mesh`` on ``cuda:0`` beside a decode
    device ``cuda:0``; SMs shared, so a correctness leg), llama-3-8b widths
    at 8 layers: three greedy streams (one segment, three, five) held
    against the colocated engine's (``_hold_lp``); every admission staged
    and handed off, the handoff bytes equal to the prompts' K/V bytes
    (32 KiB a token at 8 layers), route ``direct``; K2 launched by the
    decode group once per layer per decode step, K1 by the prefill group
    not at all (segments attend through the plain attention)."""
    from quorum_tpu_torch.engine.engine import InferenceEngine
    from quorum_tpu_torch.models.model_config import resolve_spec
    from quorum_tpu_torch.ops.flash_attention import flash_prefill_attention
    from quorum_tpu_torch.ops.flash_decode import flash_decode_attention
    from quorum_tpu_torch.parallel import make_mesh

    spec = resolve_spec(model, {"head_dim": "64", "dtype": "bfloat16"} if tiny
                         else {"n_layers": "8"})
    dev = "cpu" if cpu else "cuda:0"
    chunk = 16 if tiny else 512
    gen = random.Random(23)
    prompts = [[gen.randrange(1, spec.vocab_size) for _ in range(n)]
               for n in ((9, 40, 70) if tiny else (57, 1217, 2300))]
    kw = dict(knobs, prefill_chunk=chunk)
    t0 = time.perf_counter()
    col = InferenceEngine(spec, device=dev, **kw)
    ref = [_lp_stream(col, p, n_tok) for p in prompts]
    col_s = time.perf_counter() - t0
    col.shutdown()
    del col
    _require_card_empty(torch, cpu, "mesh (n) colocated")
    zero()
    t0 = time.perf_counter()
    eng = InferenceEngine(spec, device=dev, prefill_mesh=make_mesh(devices=[dev]), **kw)
    build_s = time.perf_counter() - t0
    got = [_lp_stream(eng, p, n_tok) for p in prompts]
    m = eng.metrics()
    k1, k2 = flash_prefill_attention.launches, flash_decode_attention.launches
    held = [_hold_lp(f"mesh (n) stream {i}", r, g) for i, (r, g) in enumerate(zip(ref, got))]
    per_token = _kv_token_bytes(torch, spec)
    want_bytes = per_token * sum(len(p) for p in prompts)
    require(m["kv_handoff_bytes_total"] == want_bytes,
            f"mesh (n): handoff bytes {m['kv_handoff_bytes_total']} != {want_bytes}")
    require(m["kv_handoffs_total"] == sum(-(-len(p) // eng.prefill_chunk) for p in prompts)
            and m["admission_dispatches_total"] == 0,
            f"mesh (n): {m['kv_handoffs_total']} handoffs, "
            f"{m['admission_dispatches_total']} single-shot admissions")
    if not cpu:
        require(k2 == spec.n_layers * _k2_steps(m) and k1 == 0,
                f"mesh (n): K1/K2 launches {k1}/{k2} for {_k2_steps(m)} decode steps")
    health = eng.health()
    require(health["prefill_scheduler_alive"] and health["disagg"]["route"] == "direct",
            f"mesh (n): health {health['disagg']}")
    add()
    eng.shutdown()
    del eng
    _require_card_empty(torch, cpu, "mesh (n)")
    out = {"layers": spec.n_layers, "prompt_tokens": [len(p) for p in prompts],
           "prefill_chunk": chunk, "colocated_s": round(col_s, 3), "build_s": round(build_s, 3),
           "held": held, "kv_handoffs": m["kv_handoffs_total"],
           "kv_handoff_bytes": m["kv_handoff_bytes_total"], "kv_bytes_per_token": per_token,
           "kv_handoff_s": m["kv_handoff_seconds_total"], "route": "direct",
           "launches_by_group": {"prefill": {"flash_prefill": k1, "flash_decode": 0},
                                 "decode": {"flash_prefill": 0, "flash_decode": k2}},
           "note": "both groups on one card (SMs shared): a correctness leg"}
    emit("mesh", leg="n", **out)
    return out


def _mesh_disagg_cards(torch, cpu, model, zero, add, n_long: int = 6000) -> dict:
    """Leg (o), two cards or more: ``cuda://llama-3-8b?disagg=1+1`` through
    the backend (prefill group ``cuda:0``, decode group ``cuda:1``) at all
    32 layers, against the colocated zero-drain engine on ``cuda:1``: a
    live greedy stream's longest gap while a 6 000-token admission runs, the
    admission's time to first token, the handoffs' route, bytes and GB/s
    (device time of the copies), and the live stream's tokens held equal
    against the colocated engine's while no admission ran beside it
    (``_hold_lp``: greedy, same prompt)."""
    from quorum_tpu_torch.backends.cuda_backend import CudaBackend
    from quorum_tpu_torch.config import BackendSpec
    from quorum_tpu_torch.engine.engine import release_engine
    from quorum_tpu_torch.ops.flash_attention import flash_prefill_attention
    from quorum_tpu_torch.ops.flash_decode import flash_decode_attention
    from quorum_tpu_torch.ops.sampling import SamplerConfig

    greedy = SamplerConfig(temperature=0.0)
    gen = random.Random(17)
    vocab = 500 if cpu else 128000
    live = [gen.randrange(1, vocab) for _ in range(30 if cpu else 300)]
    long_p = [gen.randrange(1, vocab) for _ in range(n_long)]
    out = {}
    extra = "&device=cpu&prefill_chunk=16&dtype=float32" if cpu else ""
    for label, tail in (("colocated_zero_drain",
                         "&zero_drain=1" + (extra if cpu else "&device=cuda:1")),
                        ("disagg_1p1", "&disagg=1+1" + extra)):
        zero()
        t0 = time.perf_counter()
        b = CudaBackend.from_spec(BackendSpec(
            name=label, url=f"cuda://{model}?slots=4&decode_chunk=8&seed=0{tail}", model=model))
        eng = b.engine
        build_s = time.perf_counter() - t0
        solo = _lp_stream(eng, live, 32)
        leg = _long_beside_live(eng, live, long_p, greedy)
        m = eng.metrics()
        k1, k2 = flash_prefill_attention.launches, flash_decode_attention.launches
        row = {"build_s": round(build_s, 3), **_public(leg), "solo": solo,
               "live_prefix_equal_solo": leg["live_ids"][:32] == solo[0],
               "k1_launches": k1, "k2_launches": k2,
               "decode_steps": _k2_steps(m)}
        if label == "disagg_1p1":
            h = eng.health()["disagg"]
            require(cpu or (h["prefill_devices"] == ["cuda:0"] and h["decode_devices"]
                            == ["cuda:1"]) and h["route"] == "direct", f"mesh (o): groups {h}")
            per_token = _kv_token_bytes(torch, eng.spec)
            moved = m["kv_handoff_bytes_total"]
            require(moved == per_token * (2 * len(live) + len(long_p)),
                    f"mesh (o): handoff bytes {moved}")
            require(cpu or (k2 == eng.spec.n_layers * _k2_steps(m) and k1 == 0),
                    f"mesh (o): K1/K2 launches {k1}/{k2}")
            row.update(groups=h, kv_handoffs=m["kv_handoffs_total"], kv_handoff_bytes=moved,
                       peer_access=None if cpu else torch.cuda.can_device_access_peer(0, 1),
                       kv_handoff_s=m["kv_handoff_seconds_total"],
                       kv_handoff_gb_per_s=round(moved / m["kv_handoff_seconds_total"] / 1e9, 3)
                       if m["kv_handoff_seconds_total"] else None,
                       launches_by_group={"prefill": {"flash_prefill": k1, "flash_decode": 0},
                                          "decode": {"flash_prefill": 0, "flash_decode": k2}})
        add()
        release_engine(eng)
        del eng, b
        gc.collect()
        out[label] = row
        emit("mesh", leg=f"o_{label}", **{k: v for k, v in row.items() if k != "solo"})
    out["held"] = _hold_lp("mesh (o) disagg against colocated",
                           out["colocated_zero_drain"].pop("solo")[:2],
                           out["disagg_1p1"].pop("solo")[:2])
    emit("mesh", leg="o_held", **out["held"])
    return out


def _mesh_disagg_tp_cards(torch, spec, knobs, prompts, zero, add, cards=None) -> dict:
    """Leg (q), four cards: disagg=2+2 with tp=2 in each group over NCCL at
    all 32 layers (prefill ``cuda:0-1``, decode ``cuda:2-3``; the pieces
    gathered over the prefill group's tp, one copy between the first
    ranks, broadcast over the decode group's), against the colocated tp=2
    engine on ``cuda:0-1``: greedy streams held (``_hold_lp``), the
    handoffs' route ``direct``, bytes (the prompts' K/V bytes) and
    seconds; K2 on both decode ranks once per layer per decode step, K1 on
    no prefill rank (segments attend through the plain attention)."""
    from quorum_tpu_torch.engine.engine import InferenceEngine
    from quorum_tpu_torch.ops.flash_attention import flash_prefill_attention
    from quorum_tpu_torch.ops.flash_decode import flash_decode_attention
    from quorum_tpu_torch.parallel import MeshConfig, make_mesh
    from quorum_tpu_torch.parallel.mesh import disagg_meshes

    cpu = cards is not None and cards[0] == "cpu"  # a rehearsal's CPU ranks
    cards = cards or [f"cuda:{i}" for i in range(4)]
    n = 32
    t0 = time.perf_counter()
    col = InferenceEngine(spec, mesh=make_mesh(MeshConfig(tp=2), cards[:2],
                                               timeout_s=MESH_GROUP_TIMEOUT_S), **knobs)
    ref = [_lp_stream(col, p, n) for p in prompts]
    col_s = time.perf_counter() - t0
    col.shutdown()
    del col
    _require_card_empty(torch, cpu, "mesh (q) colocated")
    zero()
    t0 = time.perf_counter()
    pm, dm = disagg_meshes(2, 2, cards, tp=2)
    eng = InferenceEngine(spec, mesh=dm, prefill_mesh=pm, **knobs)
    build_s = time.perf_counter() - t0
    got = [_lp_stream(eng, p, n) for p in prompts]
    m = eng.metrics()
    reports, preports = eng.rank_reports(), eng.prefill_rank_reports()
    k1 = [flash_prefill_attention.launches] + [r["launches"]["flash_prefill"] for r in preports]
    k2 = [flash_decode_attention.launches] + [r["launches"]["flash_decode"] for r in reports]
    held = [_hold_lp(f"mesh (q) stream {i}", r, g) for i, (r, g) in enumerate(zip(ref, got))]
    per_token = _kv_token_bytes(torch, spec)
    want_bytes = per_token * sum(len(p) for p in prompts)
    h = eng.health()
    require(h["disagg"]["route"] == ("host-bounce" if cpu else "direct")
            and h["disagg"]["prefill_workers_alive"]
            and h["mesh"]["workers_alive"], f"mesh (q): health {h['disagg']}, {h['mesh']}")
    require(m["kv_handoff_bytes_total"] == want_bytes,
            f"mesh (q): handoff bytes {m['kv_handoff_bytes_total']} != {want_bytes}")
    require(k1 == [0, 0] and (cpu or k2 == [spec.n_layers * _k2_steps(m)] * 2),
            f"mesh (q): K1 by prefill rank {k1}, K2 by decode rank {k2}, "
            f"{_k2_steps(m)} decode steps")
    add(reports + preports)
    eng.shutdown()
    del eng
    _require_card_empty(torch, cpu, "mesh (q)")
    out = {"layers": spec.n_layers, "groups": "2+2", "tp": 2, "colocated_s": round(col_s, 3),
           "build_s": round(build_s, 3), "held": held, "route": h["disagg"]["route"],
           "kv_handoffs": m["kv_handoffs_total"], "kv_handoff_bytes": m["kv_handoff_bytes_total"],
           "kv_handoff_s": m["kv_handoff_seconds_total"],
           "ms_per_token": [round(1e3 * g[2] / len(g[0]), 2) for g in got],
           "launches_by_group": {"prefill": {"flash_prefill": sum(k1), "flash_decode": 0},
                                 "decode": {"flash_prefill": 0, "flash_decode": sum(k2)}},
           "k1_by_prefill_rank": k1, "k2_by_decode_rank": k2}
    emit("mesh", leg="q", **out)
    return out


def _greedy_streams(eng, jobs, n: int) -> tuple[list[list[int]], float]:
    """Greedy streams of ``jobs`` ((prompt, member) pairs), submitted at
    once; each bounded by a deadline (a stream that never finishes fails
    the leg instead of hanging it). Returns the tokens and the seconds."""
    from quorum_tpu_torch.ops.sampling import SamplerConfig

    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=n, sampler=SamplerConfig(temperature=0.0), member=m,
                       deadline=time.monotonic() + 2 * SERVE_TIMEOUT_S) for p, m in jobs]
    got = [list(eng.stream_results(r)) for r in reqs]
    return got, time.perf_counter() - t0


def _cache_bytes(eng) -> int:
    """Rank 0's decode cache bytes (an int8 side counts its values and
    scales)."""
    sides = [t for side in (eng._ck, eng._cv)
             for t in (side if isinstance(side, tuple) else (side,))]
    return sum(t.numel() * t.element_size() for t in sides)


def _k2q8_replay_ms(torch, eng, jobs, n: int) -> dict:
    """K2q8's device time inside rank 0's decode replays: ``jobs`` streamed
    once more under torch.profiler (its start and stop holding the graph
    launch gate, as the app's profile route does), the K2q8 kernel's device
    time over its calls. Best effort: a trace without device time says so."""
    from torch.profiler import ProfilerActivity, profile

    from quorum_tpu_torch.ops import launches
    from quorum_tpu_torch.ops.flash_decode_q8 import flash_decode_q8_attention

    prof = profile(activities=[ProfilerActivity.CUDA])
    with launches.GRAPH_LAUNCH_GATE:
        prof.__enter__()
    n0 = flash_decode_q8_attention.launches
    try:
        _greedy_streams(eng, jobs, n)
        torch.cuda.synchronize()
    finally:
        with launches.GRAPH_LAUNCH_GATE:
            prof.__exit__(None, None, None)
    calls = flash_decode_q8_attention.launches - n0
    us = count = 0
    for ev in prof.key_averages():
        if "q8_decode_cluster_kernel" in ev.key:
            us += getattr(ev, "self_device_time_total", 0) or getattr(
                ev, "self_cuda_time_total", 0)
            count += ev.count
    if not count:
        return {"k2q8_replay_ms": None, "note": "not measured: the trace shows no K2q8 kernel",
                "counted_calls": calls}
    return {"k2q8_replay_ms": us / 1e3 / count, "traced_kernels": count, "counted_calls": calls}


def _mesh_int8_members(torch, cpu, tiny, model, two, app_for, zero, add) -> dict:
    """Leg (r), one card: tp=2 over gloo (two ranks sharing the card, eager
    decode) at llama-3-8b widths. (1) ``quant=int8&kv_quant=int8&members=2``
    at 2 layers against a one-card twin with the same knobs, 2 slots: each
    member's greedy stream equal token for token (a row-parallel int8
    product sums its int32 accumulators over tp: exact; 2 slots × 2 members
    keep K2q8's cluster plan the twin's), K2q8 launched on each rank once
    per layer per decode step and K2 on none; then one finite
    ``response_format`` json_schema chat through the app on the same
    engine, its content parsed and validated. (2) ``ensemble=2`` (int8
    weights, bf16 cache: K2) at 2 layers, 4 slots, against its twin."""
    from quorum_tpu_torch.engine.engine import InferenceEngine
    from quorum_tpu_torch.models.model_config import resolve_spec
    from quorum_tpu_torch.ops.flash_decode import flash_decode_attention
    from quorum_tpu_torch.ops.flash_decode_q8 import flash_decode_q8_attention
    from quorum_tpu_torch.parallel import MeshConfig, make_mesh

    dev = "cpu" if cpu else "cuda:0"
    opts = {"head_dim": "64", "dtype": "bfloat16"} if tiny else {}
    n_tok = 16
    gen = random.Random(23)

    def spec_of(layers):
        return resolve_spec(model, {**opts, "n_layers": str(layers)})

    def tp2():
        return make_mesh(MeshConfig(tp=2), two, backend="gloo", timeout_s=MESH_GROUP_TIMEOUT_S)

    fns = {"flash_decode": flash_decode_attention, "flash_decode_q8": flash_decode_q8_attention}

    def launched(reports, since):
        return {name: [fn.launches - since[name]] + [r["launches"][name] for r in reports]
                for name, fn in fns.items()}

    out = {}
    parts = (("members_int8", 2, dict(n_slots=2, quant="int8", kv_quant="int8", members=2),
              lambda p: [(p[0], 0), (p[1], 1)]),
             ("ensemble", 2, dict(n_slots=4, quant="int8", ensemble=2),
              lambda p: [(p[0], 0), (p[1], 0)]))
    # Every part's twin and tp=2 engine built at once (a gloo engine's build
    # is most of its worker processes' start).
    t0 = time.perf_counter()
    built = iter(_build_concurrently([
        (lambda spec=spec_of(layers), knobs=knobs, mesh=mesh:
         InferenceEngine(spec, **({"mesh": tp2()} if mesh else {"device": dev}), decode_chunk=8,
                         seed=0, **knobs))
        for _, layers, knobs, _ in parts for mesh in (False, True)]))
    build_s = time.perf_counter() - t0
    for part, layers, knobs, jobs_of in parts:
        spec = spec_of(layers)
        prompts = [[gen.randrange(spec.vocab_size) for _ in range(k)] for k in (57, 300)]
        knobs = dict(knobs, decode_chunk=8, seed=0)
        twin, eng = next(built), next(built)
        t0 = time.perf_counter()
        want, _ = _greedy_streams(twin, jobs_of(prompts), n_tok)
        twin_s = time.perf_counter() - t0
        twin.shutdown()
        del twin
        zero()
        since = {name: fn.launches for name, fn in fns.items()}
        got, secs = _greedy_streams(eng, jobs_of(prompts), n_tok)
        row = {"layers": layers, **{k: v for k, v in knobs.items() if k != "seed"},
               "twin_s": round(twin_s, 3), "build_s": round(build_s, 3),
               "streams_s": round(secs, 4), "tokens": sum(len(g) for g in got),
               "greedy_equal": got == want}
        require(got == want, f"mesh (r) {part}: the tp=2 engine's greedy streams {got} differ "
                             f"from its one-card twin's {want}")
        if part == "members_int8":
            app, backend = app_for("int8_tp2", eng)
            body = {"model": model, "messages": [{"role": "user", "content": "Is it north?"}],
                    "max_tokens": 64, "temperature": 0,
                    "response_format": CONSTRAIN_FORMATS["json_schema"]}
            resp = asyncio.run(asyncio.wait_for(_call(app, body), 2 * SERVE_TIMEOUT_S))
            chat = _check_response(resp, body, backend.tokenizer, 64)
            obj = json.loads(chat["text"])
            require(chat["finish"] == "stop" and list(obj) == ["ok", "dir", "unit"]
                    and isinstance(obj["ok"], bool) and obj["dir"] in ("N", "S", "E", "W")
                    and obj["unit"] in ("m", "km", None),
                    f"mesh (r): the json_schema chat does not validate: {chat['text']!r}")
            row["json_schema_chat"] = {"text": chat["text"], "finish": chat["finish"],
                                       "seconds": round(chat["t_end"], 4)}
            del app, backend
        m = eng.metrics()
        reports = eng.rank_reports()
        counts = launched(reports, since)
        steps = _k2_steps(m)
        kernel, other = (("flash_decode_q8", "flash_decode") if part == "members_int8"
                         else ("flash_decode", "flash_decode_q8"))
        require(cpu or (counts[kernel] == [spec.n_layers * steps] * 2 and steps > 0
                        and counts[other] == [0, 0]),
                f"mesh (r) {part}: launches by rank {counts} for {steps} decode steps")
        row.update(decode_steps=steps, launches_by_rank=counts,
                   weight_bytes_per_rank=[_tree_bytes(eng.params), reports[0]["weight_bytes"]],
                   cache_bytes_per_rank=[_cache_bytes(eng), reports[0]["cache_bytes"]],
                   worker_collectives=reports[0]["collectives"])
        add(reports)
        eng.shutdown()
        del eng
        out[part] = row
        emit("mesh", leg=f"r_{part}", **row)
    _require_card_empty(torch, cpu, "mesh (r)")
    return out


def _mesh_int8_cards(torch, cpu, model, card: str, zero, add, cards=None) -> dict:
    """Leg (s), four cards, NCCL at llama-3-8b's 32 layers. (1)
    ``tp=2&dp=2&quant=int8&kv_quant=int8&members=2`` (2 slots) against the
    one-card engine with the same knobs: each member's greedy stream equal
    token for token; warm tok/s a card (4 streams of 128 tokens, every row,
    after the key is captured); K2q8's device ms inside rank 0's replays
    (``_k2q8_replay_ms``); K2q8 launched on every rank. (2)
    ``disagg=2+2&tp=2&kv_quant=int8&members=2`` (prompts past one 512-token
    segment: both engines admit chunked) against the colocated tp=2 engine
    with the same knobs: live handoffs, each member's greedy stream equal."""
    from quorum_tpu_torch.engine.engine import InferenceEngine
    from quorum_tpu_torch.models.model_config import resolve_spec
    from quorum_tpu_torch.ops.flash_decode_q8 import flash_decode_q8_attention
    from quorum_tpu_torch.parallel import MeshConfig, make_mesh
    from quorum_tpu_torch.parallel.mesh import disagg_meshes

    cards = cards or [f"cuda:{i}" for i in range(4)]
    spec = resolve_spec(model, {"head_dim": "64", "dtype": "bfloat16"} if cpu else {})
    gen = random.Random(29)
    n = 32
    out = {"layers": spec.n_layers, "measured_on": card}

    knobs = dict(n_slots=2, decode_chunk=8, seed=0, quant="int8", kv_quant="int8", members=2)
    prompts = [[gen.randrange(spec.vocab_size) for _ in range(k)] for k in (57, 300)]
    jobs = [(prompts[0], 0), (prompts[1], 1)]
    t0 = time.perf_counter()
    one = InferenceEngine(spec, device=cards[0], **knobs)
    want, _ = _greedy_streams(one, jobs, n)
    one_s = time.perf_counter() - t0
    one.shutdown()
    del one
    _require_card_empty(torch, cpu, "mesh (s) one card")
    zero()
    t0 = time.perf_counter()
    eng = InferenceEngine(spec, mesh=make_mesh(MeshConfig(tp=2, dp=2), cards,
                                               timeout_s=MESH_GROUP_TIMEOUT_S), **knobs)
    build_s = time.perf_counter() - t0
    require(cpu or (eng.mesh.backend == "nccl" and eng.health()["mesh"]["decode"] == "graphs"),
            "mesh (s): not NCCL with graphs")
    got, _ = _greedy_streams(eng, jobs, n)
    require(got == want, f"mesh (s): the dp=2 × tp=2 int8 members engine's greedy streams "
                         f"{got} differ from the one-card engine's {want}")
    every = [(p, m) for m in range(2) for p in prompts]  # every row of the 2 slots × 2 members
    warm, secs = _greedy_streams(eng, every, 128)
    n_warm = sum(len(w) for w in warm)
    replay = (_k2q8_replay_ms(torch, eng, jobs, 16) if not cpu
              else {"k2q8_replay_ms": None, "note": "not measured: CPU rehearsal"})
    m = eng.metrics()
    reports = eng.rank_reports()
    k2q8 = [flash_decode_q8_attention.launches] + [r["launches"]["flash_decode_q8"]
                                                   for r in reports]
    require(cpu or all(k > 0 for k in k2q8), f"mesh (s): K2q8 launches by rank {k2q8}")
    out["dp2_tp2"] = {
        "knobs": {k: v for k, v in knobs.items() if k != "seed"},
        "one_card_s": round(one_s, 3), "build_s": round(build_s, 3), "greedy_equal": True,
        "warm_streams": len(every), "warm_tokens": n_warm, "warm_s": round(secs, 4),
        "warm_tok_s_per_card": n_warm / secs / len(cards), **replay,
        "captures": m["decode_graph_captures_total"], "k2q8_launches_by_rank": k2q8,
        "weight_bytes_per_rank": [_tree_bytes(eng.params)] + [r["weight_bytes"]
                                                              for r in reports],
        "cache_bytes_per_rank": [_cache_bytes(eng)] + [r["cache_bytes"] for r in reports]}
    add(reports)
    eng.shutdown()
    del eng
    _require_card_empty(torch, cpu, "mesh (s) dp2 tp2")
    emit("mesh", leg="s_dp2_tp2", **out["dp2_tp2"])

    knobs = dict(n_slots=2, decode_chunk=8, seed=0, kv_quant="int8", members=2)
    prompts = [[gen.randrange(spec.vocab_size) for _ in range(k)] for k in (600, 1100)]
    jobs = [(prompts[0], 0), (prompts[1], 1), (prompts[1], 0)]
    t0 = time.perf_counter()
    col = InferenceEngine(spec, mesh=make_mesh(MeshConfig(tp=2), cards[:2],
                                               timeout_s=MESH_GROUP_TIMEOUT_S), **knobs)
    want, _ = _greedy_streams(col, jobs, n)
    col_s = time.perf_counter() - t0
    col.shutdown()
    del col
    _require_card_empty(torch, cpu, "mesh (s) colocated")
    zero()
    t0 = time.perf_counter()
    pm, dm = disagg_meshes(2, 2, cards, tp=2)
    eng = InferenceEngine(spec, mesh=dm, prefill_mesh=pm, **knobs)
    build_s = time.perf_counter() - t0
    got, secs = _greedy_streams(eng, jobs, n)
    m = eng.metrics()
    reports, preports = eng.rank_reports(), eng.prefill_rank_reports()
    require(got == want, f"mesh (s): disagg=2+2 tp=2 streams {got} differ from the colocated "
                         f"tp=2 engine's {want}")
    require(m["kv_handoffs_total"] > 0, "mesh (s): the disagg engine made no handoff")
    k2q8 = [flash_decode_q8_attention.launches] + [r["launches"]["flash_decode_q8"]
                                                   for r in reports]
    require(cpu or all(k > 0 for k in k2q8), f"mesh (s): disagg K2q8 launches {k2q8}")
    out["disagg_2p2_tp2"] = {
        "knobs": {k: v for k, v in knobs.items() if k != "seed"},
        "colocated_s": round(col_s, 3), "build_s": round(build_s, 3),
        "streams_s": round(secs, 4), "greedy_equal": True,
        "route": eng.health()["disagg"]["route"], "kv_handoffs": m["kv_handoffs_total"],
        "kv_handoff_bytes": m["kv_handoff_bytes_total"],
        "kv_handoff_s": m["kv_handoff_seconds_total"], "k2q8_by_decode_rank": k2q8}
    add(reports + preports)
    eng.shutdown()
    del eng
    _require_card_empty(torch, cpu, "mesh (s) disagg")
    emit("mesh", leg="s_disagg", **out["disagg_2p2_tp2"])
    return out


def _memory_launches(fns, reports, since) -> dict:
    """K1, K2 and K2q8 launches by rank since ``since`` (rank 0's counters;
    the workers' from their reports, every one of them new with the
    engine)."""
    return {name: [fn.launches - since[name]] + [r["launches"][name] for r in reports]
            for name, fn in fns.items()}


def _no_page_leak(what: str, eng) -> dict:
    """At rest: no live chain, and every allocated page held by a retained
    chain (a slot group's reuse donor)."""
    _quiet(eng)
    a = eng._page_alloc
    held = {p for chain in a.retained.values() for p in chain}
    require(not a.chains and a.allocated_pages == len(held)
            and a.allocated_pages + a.free_pages == eng.kv_pool_pages,
            f"{what}: pages leaked (allocated {a.allocated_pages}, free {a.free_pages}, "
            f"retained {len(held)}, live chains {len(a.chains)})")
    return {"kv_pages_allocated": a.allocated_pages, "kv_pages_free": a.free_pages,
            "kv_pool_pages": eng.kv_pool_pages}


def _churn(eng, first, conv, other, n: int) -> tuple[list, list[int]]:
    """``first`` fills slot 0, ``conv`` lands in slot 1 (dp group 1 on a
    2-slot dp=2 engine) and ``other`` takes slot 1 from it (the shorter
    resident loses a tie of no reuse); then ``conv``'s follow-up, which a
    store engine restores. Every stream with its top-20 log-probabilities,
    and the follow-up."""
    out = []
    for p in (first, conv, other):
        out.append(_lp_stream(eng, p, n))
        if eng.prefix_store is not None:
            eng.drain_prefix_store()
    follow = conv + out[1][0] + [17, 19]
    out.append(_lp_stream(eng, follow, n))
    return out, follow


def _build_concurrently(makers: list) -> list:
    """Each engine ``makers`` builds, built at once on a thread of its own:
    a mesh engine's worker processes then start beside the others' rather
    than after them. On a failure every engine built is shut down and the
    first error raised."""
    import threading

    built, errors = [None] * len(makers), []

    def build(i):
        try:
            built[i] = makers[i]()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    threads = [threading.Thread(target=build, args=(i,), daemon=True)
               for i in range(len(makers))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        for eng in built:
            if eng is not None:
                eng.shutdown()
        raise errors[0]
    return built


def _mesh_memory_knobs(torch, cpu, tiny, model, two, zero, add) -> dict:
    """Leg (t), one card: paged KV, the host prefix store and zero-drain
    staging on meshes whose ranks share the card over gloo, at llama-3-8b
    widths, 2 layers, bf16. (1) ``tp=2&kv_pages=1`` and (2)
    ``tp=2&zero_drain=1``, 4 slots, against the same mesh's dense,
    drain-based engine: greedy streams equal token for token (prompts past
    one 512-token segment: every engine admits them chunked), a staged
    register beside a live stream counted in ``admission_overlap_total``;
    (3) ``dp=2&tp=2&kv_pages=1&prefix_store=host``, 2 slots: a conversation
    churned out of its slot (in dp group 1) and followed up restores and
    equals the dense mesh engine's cold prefill; then a prefix exported
    from it imports into a one-card engine and restores there, held against
    that engine's cold stream. Every mesh stream is also held against the
    one-card engine (``_hold_lp``: equal, or parted at a near-tie). K2 is
    launched on each rank once per layer per decode step; no page leaks."""
    from quorum_tpu_torch.engine.engine import InferenceEngine
    from quorum_tpu_torch.models.model_config import resolve_spec
    from quorum_tpu_torch.ops.flash_attention import flash_prefill_attention
    from quorum_tpu_torch.ops.flash_decode import flash_decode_attention
    from quorum_tpu_torch.ops.flash_decode_q8 import flash_decode_q8_attention
    from quorum_tpu_torch.parallel import MeshConfig, make_mesh

    dev = "cpu" if cpu else "cuda:0"
    spec = resolve_spec(model, {**({"head_dim": "64", "dtype": "bfloat16"} if tiny else {}),
                                "n_layers": "2"})
    chunk = 16 if tiny else 512
    sizes = (20, 40, 30, 50, 9) if tiny else (600, 1100, 700, 1300, 57)
    n_tok = 8
    gen = random.Random(31)
    p0, p1, conv, first, short = ([gen.randrange(spec.vocab_size) for _ in range(k)]
                                  for k in sizes)
    other = [gen.randrange(spec.vocab_size) for _ in range(len(conv))]
    conv2 = [gen.randrange(spec.vocab_size) for _ in range(len(conv))]
    fns = {"flash_prefill": flash_prefill_attention, "flash_decode": flash_decode_attention,
           "flash_decode_q8": flash_decode_q8_attention}
    base = dict(decode_chunk=8, seed=0, prefill_chunk=chunk)

    def mesh(**axes):
        cfg = MeshConfig(**axes)
        return make_mesh(cfg, two[:1] * cfg.n_devices, backend="gloo",
                         timeout_s=MESH_GROUP_TIMEOUT_S)

    def checked(what, eng, since):
        m = eng.metrics()
        reports = eng.rank_reports()
        counts = _memory_launches(fns, reports, since)
        steps, shots = _k2_steps(m), m["admission_dispatches_total"]
        require(cpu or (counts["flash_decode"] == [spec.n_layers * steps] * eng.mesh.size
                        and steps > 0),
                f"mesh (t) {what}: K2 launches by rank {counts['flash_decode']} for {steps} "
                f"decode steps")
        require(cpu or eng.mesh.shape["dp"] > 1
                or counts["flash_prefill"] == [spec.n_layers * shots] * eng.mesh.size,
                f"mesh (t) {what}: K1 launches by rank {counts['flash_prefill']} for {shots} "
                f"single-shot admissions")
        add(reports)
        return m, reports, counts, steps

    out = {"layers": spec.n_layers, "prefill_chunk": chunk}
    t0 = time.perf_counter()
    one, dense, *knobbed = _build_concurrently([
        lambda: InferenceEngine(spec, device=dev, n_slots=4, **base),
        lambda: InferenceEngine(spec, mesh=mesh(tp=2), n_slots=4, **base),
        lambda: InferenceEngine(spec, mesh=mesh(tp=2), n_slots=4, kv_pages=True, **base),
        lambda: InferenceEngine(spec, mesh=mesh(tp=2), n_slots=4, zero_drain=True, **base)])
    out["tp2_build_s"] = round(time.perf_counter() - t0, 3)
    # The short prompt admits single-shot (K1 at a rank's heads, its K/V
    # written through the pages); zero-drain stages every admission, so it
    # streams the chunked ones only.
    ref = [_lp_stream(one, p, n_tok) for p in (short, p0, p1)]

    # (1), (2): tp=2 with kv_pages, then zero_drain, against tp=2 dense.
    t0 = time.perf_counter()
    want = [_lp_stream(dense, p, n_tok) for p in (short, p0, p1)]
    with dense._cond:  # a live stream, then a three-segment admission beside it
        live_reqs = [dense.submit(p0, max_new_tokens=48), dense.submit(p1, max_new_tokens=8)]
    want_live = [list(dense.stream_results(r)) for r in live_reqs]
    out["tp2_dense_s"] = round(time.perf_counter() - t0, 3)
    dense.shutdown()
    del dense
    for part, eng, first_prompt in (("tp2_kv_pages", knobbed[0], 0),
                                    ("tp2_zero_drain", knobbed[1], 1)):
        zero()
        since = {name: fn.launches for name, fn in fns.items()}
        t0 = time.perf_counter()
        got = [_lp_stream(eng, p, n_tok) for p in (short, p0, p1)[first_prompt:]]
        require([g[0] for g in got] == [w[0] for w in want[first_prompt:]],
                 f"mesh (t) {part}: greedy streams differ from the dense drain-based tp=2 "
                 f"engine's")
        with eng._cond:
            reqs = [eng.submit(p0, max_new_tokens=48), eng.submit(p1, max_new_tokens=8)]
        got_live = [list(eng.stream_results(r)) for r in reqs]
        require(got_live == want_live, f"mesh (t) {part}: the live pair's streams differ")
        held = [_hold_lp(f"mesh (t) {part} stream {i}", r, g)
                for i, (r, g) in enumerate(zip(ref[first_prompt:], got))]
        m, reports, counts, steps = checked(part, eng, since)
        row = {"streams_s": round(time.perf_counter() - t0, 3), "greedy_equal": True,
               "single_shot_admissions": m["admission_dispatches_total"],
               "held_one_card": held, "decode_steps": steps, "launches_by_rank": counts,
               "cache_bytes_per_rank": [r["cache_bytes"] for r in reports],
               "pool_bytes_per_rank": [r["pool_bytes"] for r in reports],
               "staging_bytes_per_rank": [r["staging_bytes"] for r in reports]}
        if eng.kv_pages:
            row.update(_no_page_leak(f"mesh (t) {part}", eng))
        else:
            require(m["admission_overlap_total"] > 0 and m["admission_dispatches_total"] == 0,
                    f"mesh (t) {part}: overlap {m['admission_overlap_total']}, single-shot "
                    f"{m['admission_dispatches_total']}")
            row.update(admission_overlap=m["admission_overlap_total"],
                       admission_stall_s=m["admission_stall_seconds_total"])
        out[part] = row
        emit("mesh", leg=f"t_{part}", **row)
        eng.shutdown()
    del knobbed, eng

    # (3) dp=2 × tp=2 with kv_pages and the store: the churn restore; the
    # one-card engine the exported prefix imports into.
    t0 = time.perf_counter()
    dense, eng, imp = _build_concurrently([
        lambda: InferenceEngine(spec, mesh=mesh(dp=2, tp=2), n_slots=2, **base),
        lambda: InferenceEngine(spec, mesh=mesh(dp=2, tp=2), n_slots=2, kv_pages=True,
                                prefix_store="host", **base),
        lambda: InferenceEngine(spec, device=dev, n_slots=4, prefix_store="host", **base)])
    out["dp2_tp2_build_s"] = round(time.perf_counter() - t0, 3)
    t0 = time.perf_counter()
    want, follow = _churn(dense, first, conv, other, n_tok)
    dense_s = time.perf_counter() - t0
    dense.shutdown()
    del dense
    zero()
    since = {name: fn.launches for name, fn in fns.items()}
    t0 = time.perf_counter()
    restored = []
    into = eng._restore_into
    eng._restore_into = lambda req, slot, *a, **k: (restored.append(slot), into(req, slot, *a,
                                                                                 **k))[1]
    got, _ = _churn(eng, first, conv, other, n_tok)
    del eng._restore_into
    require([g[0] for g in got] == [w[0] for w in want],
            "mesh (t) dp2_tp2: the store engine's streams differ from the dense mesh's")
    require(restored == [1], f"mesh (t) dp2_tp2: restores into slots {restored}, not dp group "
                             f"1's slot 1")
    # A prefix exported from the mesh, to import into a one-card engine.
    out_conv2 = _lp_stream(eng, conv2, n_tok)
    eng.drain_prefix_store()
    blob = eng.export_prefix_chunks()
    m, reports, counts, steps = checked("dp2_tp2", eng, since)
    require(m["prefix_store_hits_total"] >= 1, "mesh (t) dp2_tp2: no store hit")
    ref_churn = [_lp_stream(one, p, n_tok) for p in (first, conv, other)] + [
        _lp_stream(one, follow, n_tok)]
    held = [_hold_lp(f"mesh (t) dp2_tp2 stream {i}", r, g)
            for i, (r, g) in enumerate(zip(ref_churn, got))]
    row = {"dense_streams_s": round(dense_s, 3),
           "streams_s": round(time.perf_counter() - t0, 3),
           "greedy_equal": True, "restored_slots": restored, "held_one_card": held,
           "prefix_store_hits": m["prefix_store_hits_total"],
           "restored_tokens": m["prefix_store_restored_tokens_total"],
           "restore_s": m["prefix_store_restore_seconds_total"],
           "restore_bytes": m["prefix_store_restore_bytes_total"],
           "snapshot_bytes": m["prefix_store_snapshot_bytes_total"],
           "decode_steps": steps, "launches_by_rank": counts,
           **_no_page_leak("mesh (t) dp2_tp2", eng),
           "pool_bytes_per_rank": [r["pool_bytes"] for r in reports]}
    eng.shutdown()
    del eng
    follow2 = conv2 + out_conv2[0] + [17, 19]
    cold = _lp_stream(one, follow2, n_tok)
    one.shutdown()
    del one
    got_imp = imp.import_prefix_chunks(blob)
    restored_imp = _lp_stream(imp, follow2, n_tok)
    require(got_imp["chains_imported"] >= 1 and imp.prefix_store_hits == 1,
            f"mesh (t): the imported prefix did not restore ({got_imp}, "
            f"hits {imp.prefix_store_hits})")
    row["export_import"] = {"blob_bytes": len(blob), **got_imp,
                            "held_cold": _hold_lp("mesh (t) imported prefix", cold, restored_imp)}
    imp.shutdown()
    del imp
    _require_card_empty(torch, cpu, "mesh (t)")
    out["dp2_tp2_kv_pages_store"] = row
    emit("mesh", leg="t_dp2_tp2", **row)
    return out


def _mesh_memory_cards(torch, cpu, model, card: str, zero, add, cards=None) -> dict:
    """Leg (u), four cards, NCCL at llama-3-8b's 32 layers, bf16. (1)
    ``tp=2&dp=2&kv_pages=1&prefix_store=host&zero_drain=1`` (4 slots)
    against the same mesh's engine without the three knobs, both alive:
    four greedy streams equal token for token (every prompt past one
    512-token segment); a 2 100-token conversation churned out of its slot
    by four others, then followed up, restores (2 048 tokens) and equals
    the dense engine's cold prefill; a live stream's longest gap beside a
    6 000-token admission on each engine, twice (the paged engine's first
    reaches a new history bucket, whose graphs are captured then); device
    ms per 8-step dispatch
    over all 4 rows, paged against dense; restore seconds and GB/s,
    snapshot bytes, each rank's pool, staging and peak bytes; K2 on each
    rank once per layer per decode and warm-up step. (2)
    ``disagg=2+2&tp=2&kv_pages=1&prefix_store=host`` (1 slot): the same
    churn restore (into the prefill group's staging rows) equals the
    colocated tp=2 engine's stream."""
    from quorum_tpu_torch.cache.kv_transfer import kv_bytes
    from quorum_tpu_torch.engine.engine import InferenceEngine
    from quorum_tpu_torch.models.model_config import resolve_spec
    from quorum_tpu_torch.ops.flash_attention import flash_prefill_attention
    from quorum_tpu_torch.ops.flash_decode import flash_decode_attention
    from quorum_tpu_torch.ops.flash_decode_q8 import flash_decode_q8_attention
    from quorum_tpu_torch.ops.sampling import SamplerConfig
    from quorum_tpu_torch.parallel import MeshConfig, make_mesh
    from quorum_tpu_torch.parallel.mesh import disagg_meshes

    cards = cards or [f"cuda:{i}" for i in range(4)]
    spec = resolve_spec(model, {"head_dim": "64", "dtype": "bfloat16"} if cpu else {})
    gen = random.Random(37)
    chunk = 16 if cpu else 512
    sizes = (20, 40, 24, 30) if cpu else (600, 1100, 700, 900)
    n_conv, n_long, n_live = (50, 90, 20) if cpu else (2100, 6000, 300)
    n = 32
    greedy = SamplerConfig(temperature=0.0)
    prompts = [[gen.randrange(spec.vocab_size) for _ in range(k)] for k in sizes]
    conv = [gen.randrange(spec.vocab_size) for _ in range(n_conv)]
    churners = [[gen.randrange(spec.vocab_size) for _ in range(k)] for k in sizes]
    long_prompts = [[gen.randrange(spec.vocab_size) for _ in range(n_long)] for _ in range(2)]
    live_prompt = [gen.randrange(spec.vocab_size) for _ in range(n_live)]
    fns = {"flash_prefill": flash_prefill_attention, "flash_decode": flash_decode_attention,
           "flash_decode_q8": flash_decode_q8_attention}
    base = dict(decode_chunk=8, seed=0, prefill_chunk=chunk)
    out = {"layers": spec.n_layers, "measured_on": card}

    def mesh(cfg, devs):
        return make_mesh(cfg, devs, timeout_s=MESH_GROUP_TIMEOUT_S)

    def run(eng):
        streams, _ = _greedy_streams(eng, [(p, 0) for p in prompts], n)
        c, _ = _greedy_streams(eng, [(conv, 0)], n)
        eng.drain_prefix_store()
        _greedy_streams(eng, [(p, 0) for p in churners], n)  # every slot taken
        eng.drain_prefix_store()
        follow = conv + c[0] + [17, 19]
        f, _ = _greedy_streams(eng, [(follow, 0)], n)
        return streams, c, f

    zero()
    since = {name: fn.launches for name, fn in fns.items()}
    t0 = time.perf_counter()
    dense = InferenceEngine(spec, mesh=mesh(MeshConfig(tp=2, dp=2), cards), n_slots=4, **base)
    dense_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = InferenceEngine(spec, mesh=mesh(MeshConfig(tp=2, dp=2), cards), n_slots=4,
                          kv_pages=True, prefix_store="host", zero_drain=True, **base)
    build_s = time.perf_counter() - t0
    require(cpu or (eng.mesh.backend == "nccl" and eng.health()["mesh"]["decode"] == "graphs"),
            "mesh (u): not NCCL with graphs")
    want = run(dense)
    eng.rank_reports(reset_peak=True)
    got = run(eng)
    require(got[0] == want[0] and got[1] == want[1],
            f"mesh (u): the knob engine's streams differ from the dense drain-based mesh's")
    require(got[2] == want[2], "mesh (u): the restored follow-up differs from the dense "
                               "engine's cold prefill")
    m = eng.metrics()
    require(m["prefix_store_hits_total"] >= 1 and m["prefix_store_restored_tokens_total"] > 0,
            f"mesh (u): no restore ({m['prefix_store_hits_total']} hits)")
    restore = {"hits": m["prefix_store_hits_total"],
               "tokens": m["prefix_store_restored_tokens_total"],
               "seconds": m["prefix_store_restore_seconds_total"],
               "bytes": m["prefix_store_restore_bytes_total"]}
    restore["gb_per_s"] = (restore["bytes"] / restore["seconds"] / 1e9
                           if restore["seconds"] else None)
    # Twice on each engine, each time a prompt neither has seen (no
    # restore, no reuse): the paged engine's first long admission reaches
    # the 8 192-position history bucket, whose decode graph every rank
    # captures then; the second finds it captured.
    gaps = {"note": "not measured: CPU rehearsal (the live stream outgrows max_seq)"}
    if not cpu:
        gaps = {name: [_public(_long_beside_live(e, live_prompt, lp, greedy))
                       for lp in long_prompts]
                for name, e in (("zero_drain", eng), ("drain_based", dense))}
        require(all(g["admission_overlap"] >= 1 for g in gaps["zero_drain"]),
                "mesh (u): a 6 000-token admission did not register beside the live stream")
    disp = {}
    for name, e in (("paged", eng), ("dense", dense)):
        disp[name] = _paged_dispatch_ms(torch, cpu, e, prompts, 2 * n, greedy, "any")
    m = eng.metrics()
    reports = eng.rank_reports()
    counts = _memory_launches(fns, reports, since)
    steps, steps_dense = _k2_steps(m), _k2_steps(dense.metrics())
    require(cpu or all(k == spec.n_layers * steps for k in counts["flash_decode"][1:]),
            f"mesh (u): K2 launches by worker {counts['flash_decode'][1:]} for {steps} decode "
            f"and warm-up steps")
    require(cpu or counts["flash_decode"][0] == spec.n_layers * (steps + steps_dense),
            f"mesh (u): rank 0's K2 launches {counts['flash_decode'][0]} for {steps} + "
            f"{steps_dense} steps of its two engines")
    out["dp2_tp2"] = {
        "dense_build_s": round(dense_s, 3), "build_s": round(build_s, 3),
        "greedy_equal": True, "follow_equal_cold": True, "restore": restore,
        "snapshot_bytes": m["prefix_store_snapshot_bytes_total"],
        "gap_beside_long": gaps, "dispatch_ms_8_steps": disp,
        "decode_steps": steps, "k2_launches_by_rank": counts["flash_decode"],
        **_no_page_leak("mesh (u)", eng),
        "pool_bytes_per_rank": [kv_bytes(eng._ck, eng._cv)] + [r["pool_bytes"]
                                                                for r in reports],
        "staging_bytes_per_rank": [kv_bytes(eng._sck, eng._scv)] + [r["staging_bytes"]
                                                                    for r in reports],
        "peak_bytes_per_rank": [None if cpu else torch.cuda.max_memory_allocated(cards[0])]
        + [r["peak_bytes"] for r in reports]}
    add(reports + dense.rank_reports())
    eng.shutdown()
    dense.shutdown()
    del eng, dense
    _require_card_empty(torch, cpu, "mesh (u) dp2 tp2")
    emit("mesh", leg="u_dp2_tp2", **out["dp2_tp2"])

    # (2) disagg=2+2 with tp=2: kv_pages on the decode group, the store
    # restoring into the prefill group's staging, against colocated tp=2.
    one = dict(base, n_slots=1)

    def churn_one(e):
        c, _ = _greedy_streams(e, [(conv, 0)], n)
        if e.prefix_store is not None:
            e.drain_prefix_store()
        _greedy_streams(e, [(churners[0], 0)], n)
        if e.prefix_store is not None:
            e.drain_prefix_store()
        f, _ = _greedy_streams(e, [(conv + c[0] + [17, 19], 0)], n)
        return c, f

    t0 = time.perf_counter()
    col = InferenceEngine(spec, mesh=mesh(MeshConfig(tp=2), cards[:2]), **one)
    want = churn_one(col)
    col_s = time.perf_counter() - t0
    col.shutdown()
    del col
    _require_card_empty(torch, cpu, "mesh (u) colocated")
    t0 = time.perf_counter()
    pm, dm = disagg_meshes(2, 2, cards, tp=2)
    eng = InferenceEngine(spec, mesh=dm, prefill_mesh=pm, kv_pages=True, prefix_store="host",
                          **one)
    got = churn_one(eng)
    m = eng.metrics()
    require(got == want, "mesh (u): disagg=2+2 tp=2's churn restore differs from the "
                         "colocated tp=2 engine's")
    require(m["prefix_store_hits_total"] >= 1 and m["kv_handoffs_total"] > 0,
            f"mesh (u): disagg hits {m['prefix_store_hits_total']}, handoffs "
            f"{m['kv_handoffs_total']}")
    reports, preports = eng.rank_reports(), eng.prefill_rank_reports()
    out["disagg_2p2_tp2"] = {
        "colocated_s": round(col_s, 3), "build_and_streams_s": round(time.perf_counter() - t0, 3),
        "greedy_equal": True, "prefix_store_hits": m["prefix_store_hits_total"],
        "restore_s": m["prefix_store_restore_seconds_total"],
        "restore_bytes": m["prefix_store_restore_bytes_total"],
        "kv_handoffs": m["kv_handoffs_total"], "route": eng.health()["disagg"]["route"],
        **_no_page_leak("mesh (u) disagg", eng)}
    add(reports + preports)
    eng.shutdown()
    del eng
    _require_card_empty(torch, cpu, "mesh (u) disagg")
    emit("mesh", leg="u_disagg", **out["disagg_2p2_tp2"])
    return out


# Legs (v) and (w): a forward on a mesh against one card's — each
# embedding's cosine, the scoring log-probabilities' mean and largest
# difference — within the surfaces phase's K1-against-plain bounds (tp sums
# the same bf16 products in another order, K1 runs at each rank's heads).
MESH_FORWARD_COSINE = SURFACES_COSINE_PLAIN
MESH_FORWARD_LP_MEAN = SURFACES_LP_MEAN_TOL
MESH_FORWARD_LP_MAX = SURFACES_LP_MAX_TOL


def _hold_spec(what: str, plain, got: list[int], tol: float) -> dict:
    """A speculated greedy stream ``got`` against the same engine's plain
    stream of the same request (``_lp_stream``: tokens and top-20 records;
    a logprobs request drafts nothing): equal, or parted where the served
    token is in the plain step's top-20 within ``tol`` of the plain token's
    log-probability (a near-tie the verify turn's plain attention and K2
    decide apart: ``SPEC_TIE_TOL``, the spec phase's audit bound); not
    compared past it."""
    want = list(plain[0])
    if got == want:
        return {"equal": True, "tokens": len(got)}
    i = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b), None)
    require(i is not None, f"{what}: streams differ in length only ({len(want)} vs {len(got)})")
    _, ids, lps = plain[1][i]
    lp = dict(zip((int(x) for x in ids), (float(x) for x in lps)))
    require(got[i] in lp, f"{what}: step {i} served {got[i]}, not in the plain step's top-20")
    gap = lp[want[i]] - lp[got[i]]
    require(gap <= tol, f"{what}: step {i} served {got[i]} over {want[i]} (log-probability "
                        f"gap {gap} > {tol})")
    return {"equal": False, "tokens": len(got), "first_divergence": i, "gap": gap}


def _alphabet_prompt(gen, vocab: int, n: int, k: int = 4) -> list[int]:
    """``n`` tokens drawn from an alphabet of ``k`` random ids: every 2-gram
    of the alphabet recurs in it (``_alphabet_bias`` keeps a stream on it)."""
    alpha = [gen.randrange(vocab) for _ in range(k)]
    return [gen.choice(alpha) for _ in range(n)]


def _alphabet_bias(torch, vocab: int, prompt: list[int]) -> "torch.Tensor":
    """A ``[V]`` logit bias of +``ALPHABET_BIAS`` on the tokens of
    ``prompt`` (an ``_alphabet_prompt``'s few): a random-weight model's
    greedy stream then picks among them, its own logits deciding which, so
    every turn finds its last 2-gram in the history and prompt lookup
    drafts (biased rows draft); whether a draft is accepted is the model's."""
    row = torch.zeros(vocab)
    row[sorted(set(prompt))] = ALPHABET_BIAS
    return row


# The logit bias that keeps a random-weight model's greedy stream on a
# prompt's alphabet (``_alphabet_bias``): above any logit gap of theirs.
ALPHABET_BIAS = 30.0


def _spec_rows(what: str, eng, prompts, n: int, tol: float, bias=None) -> tuple[list, dict]:
    """Each prompt's plain stream (logprobs: no verify turn runs for it,
    checked), then its speculated stream, held by ``_hold_spec``, each with
    ``bias(prompt)``'s logit bias when given; the spec counters the
    speculated streams moved, acceptance and tokens per turn (one row at a
    time)."""
    keys = ("spec_turns_total", "spec_draft_tokens_total", "spec_accepted_total")
    rows, moved = [], {k: 0 for k in keys}
    for i, p in enumerate(prompts):
        b = None if bias is None else bias(p)
        m0 = eng.metrics()
        plain = _lp_stream(eng, p, n, bias=b)
        m1 = eng.metrics()
        require(m1["spec_turns_total"] == m0["spec_turns_total"],
                f"{what} prompt {i}: the plain twin ran verify turns")
        got = _lp_stream(eng, p, n, logprobs=-1, bias=b)
        m2 = eng.metrics()
        for k in keys:
            moved[k] += m2[k] - m1[k]
        rows.append({"prompt_tokens": len(p), "plain_s": round(plain[2], 4),
                     "spec_s": round(got[2], 4), **_hold_spec(f"{what} prompt {i}", plain,
                                                              got[0], tol)})
    turns, drafted = moved["spec_turns_total"], moved["spec_draft_tokens_total"]
    require(turns > 0 and drafted > 0, f"{what}: no verify turn drafted ({moved})")
    moved["acceptance"] = moved["spec_accepted_total"] / drafted
    moved["tokens_per_turn"] = (moved["spec_accepted_total"] + turns) / turns
    return rows, moved


def _spec_launches(what: str, cpu: bool, layers: int, eng, c0: dict, c1: dict, reports,
                   draft_layers: int = 0, k1_exact: bool = True) -> dict:
    """K1, K2 and K2q8 launches of a fresh speculative mesh engine, by rank
    (rank 0's between ``c0`` and ``c1``, the workers' from their reports):
    K2 on every rank once per layer per decode and warm-up step (the verify
    turns run plain attention), rank 0 adding the draft's layers per draft
    step; with ``k1_exact`` K1 on every rank once per layer per single-shot
    admission."""
    m = eng.metrics()
    got = {k: [c1[k] - c0[k]] + [r["launches"][k] for r in reports] for k in c0}
    if not cpu:
        steps = layers * _k2_steps(m)
        want_k2 = [steps + draft_layers * m["spec_draft_steps_total"]] + [steps] * len(reports)
        require(got["flash_decode"] == want_k2 and steps > 0,
                f"{what}: K2 launches by rank {got['flash_decode']} != {want_k2}")
        require(not any(got["flash_decode_q8"]), f"{what}: K2q8 launched on a bf16 cache")
        if k1_exact:
            want_k1 = [layers * m["admission_dispatches_total"]] * (1 + len(reports))
            require(got["flash_prefill"] == want_k1,
                    f"{what}: K1 launches by rank {got['flash_prefill']} != {want_k1}")
    return got


def _spec_forwards_spec(model: str, tiny: bool):
    from quorum_tpu_torch.models.model_config import resolve_spec

    return resolve_spec(model, {**({"head_dim": "64", "dtype": "bfloat16"} if tiny else {}),
                                "n_layers": "2"})


def _spec_forwards_makers(cpu, tiny, model, two) -> list:
    """Leg (v)'s engines: the one-card engine, ``tp=2&spec_decode=4``, tp=2
    with the oracle draft and ``dp=2&tp=2&spec_decode=4`` (gloo, sharing
    the card), 2 layers, 4 slots."""
    from quorum_tpu_torch.engine.engine import InferenceEngine
    from quorum_tpu_torch.parallel import MeshConfig, make_mesh

    dev = "cpu" if cpu else "cuda:0"
    spec = _spec_forwards_spec(model, tiny)
    base = dict(n_slots=4, decode_chunk=8, seed=0)

    def mesh(**axes):
        cfg = MeshConfig(**axes)
        return make_mesh(cfg, two[:1] * cfg.n_devices, backend="gloo",
                         timeout_s=MESH_GROUP_TIMEOUT_S)

    return [lambda: InferenceEngine(spec, device=dev, **base),
            lambda: InferenceEngine(spec, mesh=mesh(tp=2), spec_decode=4, **base),
            lambda: InferenceEngine(spec, mesh=mesh(tp=2), spec_decode=4, draft_spec=spec,
                                    draft_seed=0, **base),
            lambda: InferenceEngine(spec, mesh=mesh(dp=2, tp=2), spec_decode=4, **base)]


def _mesh_spec_forwards(torch, cpu, tiny, model, two, zero, add) -> dict:
    """Leg (v), one card: speculation, embeddings and scoring on meshes
    whose ranks share the card over gloo (eager decode), at llama-3-8b
    widths, 2 layers, bf16, 4 slots: (1) ``tp=2&spec_decode=4``, (2)
    ``tp=2`` with an oracle draft (the target's own spec and seed:
    ``draft_spec=``, ``draft_seed=``; the draft whole on rank 0), (3)
    ``dp=2&tp=2&spec_decode=4``. Each serves two prompts over a 4-token
    alphabet (one single-shot, one past a 512-token segment; lookup streams
    kept on the alphabet by ``_alphabet_bias``) greedy, speculated, held
    against the same engine's plain stream of the same request
    (``_hold_spec``); the spec counters (verify turns that drafted; the
    oracle accepts); K2 on every rank once per layer per decode step, rank
    0 adding the draft's layers per draft step (``_spec_launches``). (4) One
    embeddings batch and one scoring request on (1)'s engine against the
    one-card engine's: each vector's cosine and the log-probabilities'
    mean and largest difference within ``MESH_FORWARD_*``; K1 once per
    layer per forward sub-batch on both ranks. The four engines are built
    at once (``_spec_forwards_makers``)."""
    from quorum_tpu_torch.engine import embed as embed_mod
    from quorum_tpu_torch.engine import score as score_mod

    spec = _spec_forwards_spec(model, tiny)
    tol = SPEC_TIE_TOL[spec.dtype]
    n_tok = 24
    gen = random.Random(41)

    prompts = [_alphabet_prompt(gen, spec.vocab_size, n) for n in ((24, 100) if tiny
                                                                  else (64, 640))]
    lens_in = (5, 20, 60, 100) if tiny else (5, 60, 300, 700)
    inputs = [[gen.randrange(spec.vocab_size) for _ in range(k)] for k in lens_in]
    scored = [[gen.randrange(spec.vocab_size) for _ in range(k)]
              for k in ((10, 60) if tiny else (40, 500))]
    def bias(p):
        return _alphabet_bias(torch, spec.vocab_size, p)

    out = {"layers": spec.n_layers, "dtype": spec.dtype, "tie_tol": tol, "tokens": n_tok,
           "lookup_bias": ALPHABET_BIAS}
    zero()
    t0 = time.perf_counter()
    one, tp, dr, dp = _build_concurrently(_spec_forwards_makers(cpu, tiny, model, two))
    out["build_s"] = round(time.perf_counter() - t0, 3)
    reports_all = []
    try:
        for part, eng, draft_layers in (("tp2_lookup", tp, 0), ("tp2_draft", dr, spec.n_layers),
                                        ("dp2_tp2_lookup", dp, 0)):
            t0 = time.perf_counter()
            c0 = _launch_counts()
            rows, moved = _spec_rows(f"mesh (v) {part}", eng, prompts, n_tok, tol,
                                     None if draft_layers else bias)
            c1 = _launch_counts()
            reports = eng.rank_reports()
            m = eng.metrics()
            if draft_layers:
                require(moved["spec_accepted_total"] > 0 and m["spec_draft_steps_total"] > 0,
                        f"mesh (v) {part}: the oracle draft accepted nothing ({moved})")
            launches = _spec_launches(f"mesh (v) {part}", cpu, spec.n_layers, eng, c0, c1,
                                      reports, draft_layers, k1_exact=eng.mesh.shape["dp"] == 1)
            out[part] = {"streams": rows, **moved, "launches_by_rank": launches,
                         "decode_steps": _k2_steps(m),
                         "draft_steps": m["spec_draft_steps_total"],
                         "verify_keys": sorted({str(k) for k in eng.dispatched_keys
                                                if not isinstance(k[0], int)}),
                         "seconds": round(time.perf_counter() - t0, 3)}
            emit("mesh", leg=f"v_{part}", **out[part])
            if eng is not tp:
                reports_all += reports
                eng.shutdown()
        # (4) The forwards on (1)'s engine, then the one-card engine's.
        fw = _forwards_held("mesh (v) forwards", tp, one, inputs, scored, embed_mod,
                            score_mod)
        require(cpu or fw["k1_by_rank"] == [spec.n_layers * fw["forwards"]] * 2,
                f"mesh (v) forwards: K1 launches by rank {fw['k1_by_rank']} for "
                f"{fw['forwards']} forwards")
        out["tp2_forwards"] = {
            **fw, "bounds": {"cosine": MESH_FORWARD_COSINE, "lp_max": MESH_FORWARD_LP_MAX,
                             "lp_mean": MESH_FORWARD_LP_MEAN}}
        emit("mesh", leg="v_tp2_forwards", **out["tp2_forwards"])
        reports_all += tp.rank_reports()
    finally:
        for eng in (one, tp, dr, dp):
            eng.shutdown()
    add(reports_all)
    del one, tp, dr, dp
    _require_card_empty(torch, cpu, "mesh (v)")
    return out


def _mesh_spec_cards(torch, cpu, model, card: str, zero, add, cards=None) -> dict:
    """Leg (w), four cards, NCCL at llama-3-8b's 32 layers, bf16, 4 slots,
    every rank decoding from graphs: (1) ``tp=2&spec_decode=4``, (2)
    ``tp=2&spec_model=llama-3.2-1b`` (the draft whole on rank 0; random
    weights, so acceptance near 0 is expected), (3)
    ``dp=2&tp=2&spec_decode=4``, (4) ``disagg=2+2&tp=2&spec_decode=4``, one
    at a time: a 1 500-token prompt over a 4-token alphabet (history bucket
    2 048; lookup streams kept on it by ``_alphabet_bias``) greedy for 64
    tokens, speculated, held against the same engine's plain
    stream (``_hold_spec``); device ms per verify turn and per plain
    8-step dispatch (each replay's CUDA events, ``_observe_device_time``),
    tokens per turn and acceptance; K2 on every rank once per layer per
    decode and warm-up step, rank 0 adding the draft's layers per draft
    step (``_spec_launches``). (5) On (1)'s engine an 8 × 2 048 scoring
    request while a speculated stream decodes: the stream's longest gap
    beside the forward against its longest before it, the forward's
    seconds, K1 once per layer per sub-batch on both ranks, and its first
    prompt's log-probabilities against the engine's plain-attention
    scoring of that prompt within ``MESH_FORWARD_*``."""
    import threading

    from quorum_tpu_torch.engine import embed as embed_mod
    from quorum_tpu_torch.engine import score as score_mod
    from quorum_tpu_torch.engine.engine import InferenceEngine
    from quorum_tpu_torch.models.model_config import resolve_spec
    from quorum_tpu_torch.ops.sampling import SamplerConfig
    from quorum_tpu_torch.parallel import MeshConfig, make_mesh
    from quorum_tpu_torch.parallel.mesh import disagg_meshes

    cards = cards or [f"cuda:{i}" for i in range(4)]
    spec = resolve_spec(model, {"head_dim": "64", "dtype": "bfloat16"} if cpu else {})
    draft = resolve_spec("llama-tiny" if cpu else "llama-3.2-1b",
                         {**({"head_dim": "64", "dtype": "bfloat16"} if cpu else {}),
                          "max_seq": str(spec.max_seq), "vocab_size": str(spec.vocab_size),
                          "sliding_window": str(spec.sliding_window)})
    tol = SPEC_TIE_TOL[spec.dtype]
    gen = random.Random(43)
    prompt = _alphabet_prompt(gen, spec.vocab_size, 72 if cpu else 1500)
    n_tok = 16 if cpu else 64
    n_rows, row_len = (4, 64) if cpu else (8, 2048)
    scored = [[gen.randrange(spec.vocab_size) for _ in range(row_len)] for _ in range(n_rows)]
    base = dict(n_slots=4, decode_chunk=8, seed=0, spec_decode=4)

    def bias(p):
        return _alphabet_bias(torch, spec.vocab_size, p)

    def mesh(axes, devs):
        return make_mesh(MeshConfig(**axes), devs, timeout_s=MESH_GROUP_TIMEOUT_S)

    def disagg():
        pm, dm = disagg_meshes(2, 2, cards, tp=2)
        return InferenceEngine(spec, mesh=dm, prefill_mesh=pm, **base)

    makers = (
        ("tp2_lookup", 0, lambda: InferenceEngine(spec, mesh=mesh(dict(tp=2), cards[:2]),
                                                  **base)),
        ("tp2_draft", draft.n_layers,
         lambda: InferenceEngine(spec, mesh=mesh(dict(tp=2), cards[:2]), draft_spec=draft,
                                 draft_seed=0, **base)),
        ("dp2_tp2_lookup", 0, lambda: InferenceEngine(spec, mesh=mesh(dict(dp=2, tp=2), cards),
                                                      **base)),
        ("disagg_2p2_tp2_lookup", 0, disagg))
    out = {"layers": spec.n_layers, "draft_layers": draft.n_layers, "prompt_tokens": len(prompt),
           "tokens": n_tok, "tie_tol": tol, "measured_on": card}
    for part, draft_layers, make in makers:
        zero()
        t0 = time.perf_counter()
        eng = make()
        build_s = time.perf_counter() - t0
        times: list[tuple[str, float]] = []
        observe = eng._observe_device_time

        def timed(family, seconds, observe=observe):
            times.append((family, seconds))
            observe(family, seconds)

        eng._observe_device_time = timed
        try:
            t0 = time.perf_counter()
            c0 = _launch_counts()
            rows, moved = _spec_rows(f"mesh (w) {part}", eng, [prompt], n_tok, tol,
                                     None if draft_layers else bias)
            c1 = _launch_counts()
            reports = eng.rank_reports()
            m = eng.metrics()
            launches = _spec_launches(f"mesh (w) {part}", cpu, spec.n_layers, eng, c0, c1,
                                      reports, draft_layers,
                                      k1_exact=not eng.disagg and eng.mesh.shape["dp"] == 1)
            fams: dict[str, list[float]] = {}
            for fam, s in times:
                fams.setdefault(fam, []).append(1e3 * s)
            spec_fam = "spec_loop" if draft_layers else "verify"
            require(cpu or fams.get(spec_fam), f"mesh (w) {part}: no {spec_fam} replay timed")
            if not cpu:
                require(m["decode_graph_captures_total"] > 0,
                        f"mesh (w) {part}: the engine captured no graph")
            row = {"build_s": round(build_s, 3), "streams": rows, **moved,
                   "ms_per_verify_turn": (statistics.median(fams[spec_fam])
                                          if fams.get(spec_fam) else None),
                   "verify_turns_timed": len(fams.get(spec_fam, [])),
                   "ms_per_plain_dispatch": (statistics.median(fams["plain"])
                                             if fams.get("plain") else None),
                   "plain_steps_per_dispatch": eng.decode_chunk,
                   "decode_steps": _k2_steps(m), "draft_steps": m["spec_draft_steps_total"],
                   "captures": m["decode_graph_captures_total"],
                   "launches_by_rank": launches}
            if eng.disagg:
                row["kv_handoffs"] = m["kv_handoffs_total"]
                row["prefill_launches_by_rank"] = [
                    r["launches"] for r in eng.prefill_rank_reports()]
            if part == "tp2_lookup":
                row["beside_scoring"] = _scoring_beside_stream(
                    torch, cpu, eng, spec, prompt, scored, c1, reports, embed_mod, score_mod,
                    SamplerConfig, threading)
            row["seconds"] = round(time.perf_counter() - t0, 3)
            out[part] = row
            emit("mesh", leg=f"w_{part}", **row)
            add(eng.rank_reports() + (eng.prefill_rank_reports() if eng.disagg else []))
        finally:
            eng.shutdown()
        del eng
        _require_card_empty(torch, cpu, f"mesh (w) {part}")
    return out


def _scoring_beside_stream(torch, cpu, eng, spec, prompt, scored, c1, reports, embed_mod,
                           score_mod, SamplerConfig, threading, k1_layers=None,
                           ref_row=None, ref_spread=None, what="mesh (w)") -> dict:
    """Leg (w) (5): a speculated greedy stream on ``eng``, then (once it has
    48 tokens) the scoring request of ``scored``: the stream's longest gap
    between tokens while the forward runs against its longest between its
    16th token and the forward (past its first dispatches' captures), the
    forward's seconds and sub-batches, K1 once per layer per sub-batch on
    every rank (``k1_layers`` times a sub-batch where that differs: 0 on a
    ring sp mesh, whose hops are plain block attention), and the first
    row's log-probabilities within ``MESH_FORWARD_*`` of ``ref_row`` (its
    scoring on one card), or where None of the engine's plain-attention
    scoring of it. ``ref_spread`` (mean, largest): how far the one card's
    own scoring of the row moves between K1 and the plain attention; an
    int8 forward passes that reordering of its bf16 sums through the
    activation quantizer's rounding, so the mesh, another reordering, is
    held within twice it where that is wider than ``MESH_FORWARD_*`` (each
    side that far from one value)."""
    live = eng.submit(prompt, max_new_tokens=512, sampler=SamplerConfig(temperature=0.0))
    times: list[float] = []
    stop = threading.Event()

    def consume():
        it = eng.stream_results(live)
        for _ in it:
            times.append(time.perf_counter())
            if stop.is_set():
                break
        it.close()

    th = threading.Thread(target=consume, daemon=True)
    th.start()
    deadline = time.perf_counter() + SERVE_TIMEOUT_S
    while len(times) < 48 and time.perf_counter() < deadline:
        time.sleep(0.005)
    require(len(times) >= 48, f"{what}: the live stream did not start")
    groups = len(embed_mod.row_groups(spec, [len(t) for t in scored],
                                      embed_mod.forward_budget(eng)))
    k0, r0 = _launch_counts()["flash_prefill"], eng.rank_reports()
    t_sub = time.perf_counter()
    got = score_mod.score_token_batch(eng, scored, top_k=1)
    t_done = time.perf_counter()
    k1 = [_launch_counts()["flash_prefill"] - k0] + [
        b["launches"]["flash_prefill"] - a["launches"]["flash_prefill"]
        for a, b in zip(r0, eng.rank_reports())]
    n_done = len(times)
    while len(times) < n_done + 8 and th.is_alive() and time.perf_counter() < deadline:
        time.sleep(0.005)
    stop.set()
    th.join(timeout=SERVE_TIMEOUT_S)
    require(not th.is_alive(), f"{what}: the live stream did not stop")
    k1_layers = spec.n_layers if k1_layers is None else k1_layers
    require(cpu or k1 == [k1_layers * groups] * len(k1),
            f"{what}: K1 launches by rank {k1} for {groups} scoring sub-batches")
    before = [b - a for a, b in zip(times[16:], times[17:]) if b <= t_sub]
    beside = [b - a for a, b in zip(times, times[1:]) if b > t_sub and a < t_done]
    against = "plain" if ref_row is None else "one_card"
    ref = ref_row or score_mod.score_token_batch(eng, scored[:1], top_k=1,
                                                 plain_attention=True)[0]
    diffs = [abs(a - b) for a, b in zip(got[0]["token_logprobs"][1:],
                                        ref["token_logprobs"][1:])]
    lp_max, lp_mean = max(diffs), sum(diffs) / len(diffs)
    spread_mean, spread_max = ref_spread or (0.0, 0.0)
    bound_mean = max(MESH_FORWARD_LP_MEAN, 2 * spread_mean)
    bound_max = max(MESH_FORWARD_LP_MAX, 2 * spread_max)
    require(lp_max <= bound_max and lp_mean <= bound_mean,
            f"{what}: scoring log-probabilities differ from the {against} scoring's by "
            f"{lp_max} (mean {lp_mean}; bounds {bound_max}, {bound_mean})")
    return {"rows": len(scored), "row_tokens": len(scored[0]), "sub_batches": groups,
            "forward_s": round(t_done - t_sub, 4), "k1_by_rank": k1,
            "live_max_gap_before_s": max(before) if before else None,
            "live_max_gap_beside_s": max(beside) if beside else None,
            "live_tokens_beside": sum(1 for t in times if t_sub < t <= t_done),
            f"logprob_max_diff_{against}": lp_max, f"logprob_mean_diff_{against}": lp_mean,
            "bounds": {"lp_max": bound_max, "lp_mean": bound_mean}}


def _rank_launches(c0: dict, c1: dict, r0, r1) -> dict:
    """Each kernel's launches by rank between two quiet points: rank 0's
    from the wrappers' counters (``c0``, ``c1``), the workers' from their
    reports before and after (``r0``, ``r1``)."""
    return {k: [c1[k] - c0[k]] + [b["launches"][k] - a["launches"][k] for a, b in zip(r0, r1)]
            for k in c0}


def _forwards_held(what: str, eng, ref, inputs, scored, embed_mod, score_mod) -> dict:
    """One embeddings batch and one scoring request on ``eng`` against the
    same on ``ref`` (one card): each vector's cosine and the
    log-probabilities' mean and largest difference within
    ``MESH_FORWARD_*``; the sub-batches both ran, and K1's launches by rank
    over ``eng``'s forwards alone (``k1_by_rank``, before ``ref`` runs)."""
    c0, r0 = _launch_counts(), eng.rank_reports()
    t0 = time.perf_counter()
    emb = embed_mod.embed_token_batch(eng, inputs)
    sc = score_mod.score_token_batch(eng, scored, top_k=1)
    seconds = time.perf_counter() - t0
    k1 = _rank_launches(c0, _launch_counts(), r0, eng.rank_reports())["flash_prefill"]
    emb1 = embed_mod.embed_token_batch(ref, inputs)
    sc1 = score_mod.score_token_batch(ref, scored, top_k=1)
    cos = (emb * emb1).sum(dim=-1)
    diffs = [abs(a - b) for g, w in zip(sc, sc1)
             for a, b in zip(g["token_logprobs"][1:], w["token_logprobs"][1:])]
    lp_max, lp_mean = max(diffs), sum(diffs) / len(diffs)
    require(float(cos.min()) >= MESH_FORWARD_COSINE,
            f"{what}: embedding cosines {cos.tolist()} < {MESH_FORWARD_COSINE}")
    require(lp_max <= MESH_FORWARD_LP_MAX and lp_mean <= MESH_FORWARD_LP_MEAN,
            f"{what}: scoring log-probabilities differ by {lp_max} (mean {lp_mean}; bounds "
            f"{MESH_FORWARD_LP_MAX}, {MESH_FORWARD_LP_MEAN})")
    spec = eng.spec
    n_fw = (len(embed_mod.row_groups(spec, [max(len(t), 1) for t in inputs]))
            + len(embed_mod.row_groups(spec, [len(t) for t in scored])))
    return {"inputs": [len(t) for t in inputs], "scored": [len(t) for t in scored],
            "forwards": n_fw, "k1_by_rank": k1, "seconds": round(seconds, 3),
            "cosine_min": float(cos.min()), "logprob_max_diff": lp_max,
            "logprob_mean_diff": lp_mean}


def _sp_pp_knobs_makers(cpu, tiny, model, two) -> dict:
    """Leg (x)'s engines at llama-3-8b widths and 2 layers, 4 slots: the
    one-card references (bf16, int8 weights and KV), and on ranks sharing
    the card over gloo ``sp=2&spec_decode=4`` with int8 weights and KV
    (ring), ``sp=2&sp_impl=ulysses`` with the oracle draft and ``pp=2`` with
    int8 weights and KV."""
    from quorum_tpu_torch.engine.engine import InferenceEngine
    from quorum_tpu_torch.parallel import MeshConfig, make_mesh

    dev = "cpu" if cpu else "cuda:0"
    spec = _spec_forwards_spec(model, tiny)
    base = dict(n_slots=4, decode_chunk=8, seed=0)
    q8 = dict(quant="int8", kv_quant="int8")

    def mesh(**axes):
        cfg = MeshConfig(**axes)
        return make_mesh(cfg, two[:1] * cfg.n_devices, backend="gloo",
                         timeout_s=MESH_GROUP_TIMEOUT_S)

    return {
        "one": lambda: InferenceEngine(spec, device=dev, **base),
        "one_int8": lambda: InferenceEngine(spec, device=dev, **base, **q8),
        "sp_lookup_int8": lambda: InferenceEngine(spec, mesh=mesh(sp=2), spec_decode=4,
                                                  **base, **q8),
        "sp_draft": lambda: InferenceEngine(spec, mesh=mesh(sp=2), sp_impl="ulysses",
                                            spec_decode=4, draft_spec=spec, draft_seed=0,
                                            **base),
        "pp_int8": lambda: InferenceEngine(spec, mesh=mesh(pp=2), **base, **q8),
    }


def _hold_int8(torch, what: str, eng, ref, refs, prompts, n_tok: int, r1) -> dict:
    """An int8 mesh engine (``quant`` and ``kv_quant``) against the one-card
    int8 engine ``ref``: greedy streams of ``prompts`` held against
    ``refs`` (``_hold_lp``), rank 0's layers, head and cache int8, and each
    rank's cache its share of the one card's (the whole of it under sp,
    whose ranks keep every position; half a stage's under pp=2)."""
    from quorum_tpu_torch.models.quant import is_quantized

    got = [_lp_stream(eng, p, n_tok) for p in prompts]
    held = [_hold_lp(f"{what} stream {i}", r, g) for i, (r, g) in enumerate(zip(refs, got))]
    require(isinstance(eng._ck, tuple) and eng._ck[0].dtype == torch.int8,
            f"{what}: rank 0's cache is not int8")
    require(is_quantized(eng.params["blocks"]["wq"]) and is_quantized(eng.params["lm_head"]),
            f"{what}: rank 0's layers or head are not int8")
    cache = [_cache_bytes(eng)] + [r["cache_bytes"] for r in r1]
    ref_cache = _cache_bytes(ref)
    require(cache == [ref_cache // eng.decode_pp] * 2,
            f"{what}: cache bytes by rank {cache}, one card {ref_cache}")
    return {"held": held, "cache_bytes_by_rank": cache, "one_card_cache_bytes": ref_cache,
            "weight_bytes_by_rank": [_tree_bytes(eng.params)] + [r["weight_bytes"] for r in r1]}


def _mesh_sp_pp_knobs(torch, cpu, tiny, model, two, zero, add) -> dict:
    """Leg (x), one card: speculation, int8 and the forwards on sequence-
    parallel engines, int8 and the forwards on pipeline-staged ones, ranks
    sharing the card over gloo (eager decode), llama-3-8b widths at 2
    layers, bf16, 4 slots, every engine built at once. sp=2: (1) prompt
    lookup on the ring with int8 weights and KV and (2) the oracle draft
    (the target's own spec and seed, whole on rank 0) on Ulysses, each
    speculated stream held against the same engine's plain stream of the
    same request (``_hold_spec``; two prompts over a 4-token alphabet, 64
    and 640 tokens, both split over sp), with the spec counters; (1)'s
    plain greedy streams held against the one-card int8 engine's (top-20
    δ, near-ties named, ``_hold_lp``); an embeddings batch and a scoring
    request on each against the one-card engine of its weights within
    ``MESH_FORWARD_*``. pp=2: (3) int8 weights and KV, its greedy streams
    and forwards held against the one-card int8 engine, stage 0 holding
    the int8 head and half the cache. Launches by rank: K2 (K2q8 on an int8
    cache) once per layer per decode and warm-up step on every sp rank
    (rank 0 adding the draft's layers per draft step) and on every pp
    stage (a stage's L/pp layers × pp group steps a step), K1 once per
    layer per single-shot admission and per forward sub-batch on every
    Ulysses rank (the draft's ingest launches none) and once per stage
    layer on every pp stage, none on the ring (its hops are plain block
    attention)."""
    from quorum_tpu_torch.engine import embed as embed_mod
    from quorum_tpu_torch.engine import score as score_mod

    spec = _spec_forwards_spec(model, tiny)
    L = spec.n_layers
    tol = SPEC_TIE_TOL[spec.dtype]
    n_tok = 24
    gen = random.Random(47)
    prompts = [_alphabet_prompt(gen, spec.vocab_size, n) for n in ((24, 100) if tiny
                                                                  else (64, 640))]
    lens_in = (5, 20, 60, 100) if tiny else (5, 60, 300, 700)
    inputs = [[gen.randrange(spec.vocab_size) for _ in range(k)] for k in lens_in]
    scored = [[gen.randrange(spec.vocab_size) for _ in range(k)]
              for k in ((10, 60) if tiny else (40, 500))]
    plain_prompts = [[gen.randrange(spec.vocab_size) for _ in range(k)]
                     for k in ((12, 40) if tiny else (100, 600))]

    def bias(p):
        return _alphabet_bias(torch, spec.vocab_size, p)

    makers = _sp_pp_knobs_makers(cpu, tiny, model, two)
    out = {"layers": L, "dtype": spec.dtype, "tie_tol": tol, "tokens": n_tok}
    zero()
    built: dict = {}
    reports_all = []
    try:
        t0 = time.perf_counter()
        built.update(zip(makers, _build_concurrently(list(makers.values()))))
        out["build_s"] = round(time.perf_counter() - t0, 3)
        one_int8 = built["one_int8"]
        refs = [_lp_stream(one_int8, p, n_tok) for p in plain_prompts]
        for part, impl, draft_layers, ref_name in (("sp_lookup_int8", "ring", 0, "one_int8"),
                                                   ("sp_draft", "ulysses", L, "one")):
            eng = built[part]
            what = f"mesh (x) {part}"
            require(eng.mesh.shape["sp"] == 2 and eng.sp_impl == impl, f"{what}: not sp=2 {impl}")
            t0 = time.perf_counter()
            c0, r0 = _launch_counts(), eng.rank_reports()
            rows, moved = _spec_rows(what, eng, prompts, n_tok, tol,
                                     None if draft_layers else bias)
            int8 = (_hold_int8(torch, what, eng, one_int8, refs, plain_prompts, n_tok, r0)
                    if eng.quant else {})
            c1, r1 = _launch_counts(), eng.rank_reports()
            m = eng.metrics()
            if draft_layers:
                require(moved["spec_accepted_total"] > 0 and m["spec_draft_steps_total"] > 0,
                        f"{what}: the oracle draft accepted nothing ({moved})")
            launches = _rank_launches(c0, c1, r0, r1)
            if not cpu:
                steps = L * _k2_steps(m)
                k2, other = (("flash_decode_q8", "flash_decode") if eng.kv_quant
                             else ("flash_decode", "flash_decode_q8"))
                want_k2 = [steps + draft_layers * m["spec_draft_steps_total"], steps]
                require(launches[k2] == want_k2 and steps > 0,
                        f"{what}: {k2} by rank {launches[k2]} != {want_k2}")
                require(not any(launches[other]), f"{what}: {other} launched ({launches})")
                adm = m["admission_dispatches_total"]
                # the draft's ingest launches no K1 (leg (v) holds the same)
                want_k1 = [0, 0] if impl == "ring" else [L * adm, L * adm]
                require(launches["flash_prefill"] == want_k1,
                        f"{what}: K1 by rank {launches['flash_prefill']} != {want_k1}")
            fw = _forwards_held(f"{what} forwards", eng, built[ref_name], inputs, scored,
                                embed_mod, score_mod)
            want = [0, 0] if impl == "ring" else [L * fw["forwards"]] * 2
            require(cpu or fw["k1_by_rank"] == want,
                    f"{what} forwards: K1 by rank {fw['k1_by_rank']} != {want}")
            out[part] = {"sp_impl": impl, "streams": rows, **moved, **int8,
                         "launches_by_rank": launches, "decode_steps": _k2_steps(m),
                         "draft_steps": m["spec_draft_steps_total"], "forwards": fw,
                         "seconds": round(time.perf_counter() - t0, 3)}
            emit("mesh", leg=f"x_{part}", **out[part])
            reports_all += eng.rank_reports()
            eng.shutdown()
            built.pop(part)
        eng, what = built["pp_int8"], "mesh (x) pp_int8"
        pp = eng.decode_pp
        t0 = time.perf_counter()
        c0, r0 = _launch_counts(), eng.rank_reports()
        row = _hold_int8(torch, what, eng, one_int8, refs, plain_prompts, n_tok, r0)
        c1, r1 = _launch_counts(), eng.rank_reports()
        m = eng.metrics()
        launches = _rank_launches(c0, c1, r0, r1)
        if not cpu:
            want_q8 = [L * _k2_steps(m)] * 2
            want_k1 = [L // pp * m["admission_dispatches_total"]] * 2
            require(launches["flash_decode_q8"] == want_q8,
                    f"{what}: K2q8 by stage {launches['flash_decode_q8']} != {want_q8}")
            require(not any(launches["flash_decode"]), f"{what}: K2 on an int8 cache")
            require(launches["flash_prefill"] == want_k1,
                    f"{what}: K1 by stage {launches['flash_prefill']} != {want_k1}")
        fw = _forwards_held(f"{what} forwards", eng, one_int8, inputs, scored, embed_mod,
                            score_mod)
        require(cpu or fw["k1_by_rank"] == [L // pp * fw["forwards"]] * 2,
                f"{what} forwards: K1 by stage {fw['k1_by_rank']} for "
                f"{fw['forwards']} sub-batches")
        row.update(launches_by_rank=launches, decode_steps=_k2_steps(m), forwards=fw,
                   seconds=round(time.perf_counter() - t0, 3))
        out["pp_int8"] = row
        emit("mesh", leg="x_pp_int8", **row)
        reports_all += eng.rank_reports()
    finally:
        for eng in built.values():
            eng.shutdown()
    add(reports_all)
    built.clear()
    _require_card_empty(torch, cpu, "mesh (x)")
    return out


def _mesh_sp_pp_cards(torch, cpu, model, card: str, zero, add, cards=None,
                      l_row=None) -> dict:
    """Leg (y), four cards, NCCL (every rank decoding from graphs): (1)
    ``sp=2&tp=2&quant=int8&kv_quant=int8&spec_decode=4`` (the ring) at
    llama-3-8b's 32 layers, 4 slots: an 8 191-token admission, its seconds
    and its first token and top-20 held against the one-card int8
    engine's (built first on the first card, which also scores the first
    row of (3), then freed); (2) on the same engine a prompt-lookup stream
    over a 4-token alphabet (a ≈ 6 000-token prompt: history bucket 8 192)
    held against the engine's plain stream (``_hold_spec``), with the
    device ms a verify turn and a plain dispatch (each replay's CUDA
    events); (3) a 4 × 8 192 scoring request beside a live stream
    (``_scoring_beside_stream``: its seconds, the stream's longest gap, the
    first row held against the one-card engine's within ``MESH_FORWARD_*``,
    or twice the one card's own K1-against-plain spread of that row where
    wider: int8 activations round that reordering); K2q8 once per layer per decode and warm-up step on
    every rank, no K2 and (the ring's hops are plain block attention) no
    K1. (4) ``pp=4&kv_quant=int8`` of mixtral-8x7b at its 32 layers (no
    card holds it; bf16 weights, stage s on card s): a first and a warm
    greedy stream, ms a warm token beside leg (l)'s bf16 pp=4 (``l_row``),
    each stage's weight and cache bytes, K2q8 once per layer per step on
    every stage and K1 once per stage layer per admission; then an 8 × 2 048
    scoring request: its seconds and K1 once per stage layer per
    sub-batch. No card holds the 32 layers to score them whole, so (5) the
    staged forward is held at 4 layers: the same request on mixtral-8x7b
    at 4 layers as pp=4 (a layer a stage) against one card, every row's
    log-probabilities within ``MESH_FORWARD_*``."""
    import threading

    from quorum_tpu_torch.engine import embed as embed_mod
    from quorum_tpu_torch.engine import score as score_mod
    from quorum_tpu_torch.engine.engine import InferenceEngine
    from quorum_tpu_torch.models.model_config import resolve_spec
    from quorum_tpu_torch.ops.sampling import SamplerConfig
    from quorum_tpu_torch.parallel import MeshConfig, make_mesh

    cards = cards or [f"cuda:{i}" for i in range(4)]
    tiny = {"head_dim": "64", "dtype": "bfloat16"} if cpu else {}
    spec = resolve_spec(model, tiny)
    L = spec.n_layers
    tol = SPEC_TIE_TOL[spec.dtype]
    gen = random.Random(53)
    long_ids = [gen.randrange(spec.vocab_size) for _ in range(spec.max_seq - 1)]
    prompt = _alphabet_prompt(gen, spec.vocab_size, 72 if cpu else 6000)
    n_tok = 16 if cpu else 64
    n_rows = 4
    scored = [[gen.randrange(spec.vocab_size) for _ in range(spec.max_seq)]
              for _ in range(n_rows)]
    base = dict(n_slots=4, decode_chunk=8, seed=0, quant="int8", kv_quant="int8")
    out = {"layers": L, "prompt_tokens": len(long_ids), "lookup_prompt_tokens": len(prompt),
           "tokens": n_tok, "measured_on": card}

    # (1) The one-card int8 reference of the long admission.
    t0 = time.perf_counter()
    ref = InferenceEngine(spec, device=cards[0], **base)
    try:
        ref_long = _lp_stream(ref, long_ids, 1)
        ref_row = score_mod.score_token_batch(ref, scored[:1], top_k=1)[0]
        ref_plain = score_mod.score_token_batch(ref, scored[:1], top_k=1,
                                                plain_attention=True)[0]
    finally:
        ref.shutdown()
    spread = [abs(a - b) for a, b in zip(ref_row["token_logprobs"][1:],
                                         ref_plain["token_logprobs"][1:])]
    ref_spread = (sum(spread) / len(spread), max(spread))
    del ref
    _require_card_empty(torch, cpu, "mesh (y) sp=2 × tp=2")
    out["one_card_admission_s"] = round(ref_long[2], 4)
    out["one_card_scoring_k1_vs_plain"] = {"mean": ref_spread[0], "max": ref_spread[1]}
    out["one_card_s"] = round(time.perf_counter() - t0, 3)

    zero()
    t0 = time.perf_counter()
    eng = InferenceEngine(spec, mesh=make_mesh(MeshConfig(sp=2, tp=2), cards,
                                               timeout_s=MESH_GROUP_TIMEOUT_S),
                          spec_decode=4, **base)
    build_s = time.perf_counter() - t0
    times: list[tuple[str, float]] = []
    observe = eng._observe_device_time

    def timed(family, seconds):
        times.append((family, seconds))
        observe(family, seconds)

    eng._observe_device_time = timed
    try:
        what = "mesh (y) sp2_tp2_int8"
        require(cpu or (eng.mesh.backend == "nccl"
                        and eng.health()["mesh"]["decode"] == "graphs"),
                f"{what}: not NCCL with graphs")
        c0, r0 = _launch_counts(), eng.rank_reports(reset_peak=True)
        got_long = _lp_stream(eng, long_ids, 1)
        held_long = _hold_lp(f"{what} admission", ref_long, got_long)
        rows, moved = _spec_rows(what, eng, [prompt], n_tok, tol,
                                 lambda p: _alphabet_bias(torch, spec.vocab_size, p))
        c1, r1 = _launch_counts(), eng.rank_reports()
        m = eng.metrics()
        launches = _rank_launches(c0, c1, r0, r1)
        if not cpu:
            want_q8 = [L * _k2_steps(m)] * 4
            require(launches["flash_decode_q8"] == want_q8,
                    f"{what}: K2q8 by rank {launches['flash_decode_q8']} != {want_q8}")
            require(not any(launches["flash_decode"]) and not any(launches["flash_prefill"]),
                    f"{what}: K2 or K1 launched ({launches})")
        fams: dict[str, list[float]] = {}
        for fam, s in times:
            fams.setdefault(fam, []).append(1e3 * s)
        require(cpu or fams.get("verify"), f"{what}: no verify replay timed")
        beside = _scoring_beside_stream(torch, cpu, eng, spec, prompt, scored, c1, r1,
                                        embed_mod, score_mod, SamplerConfig, threading,
                                        k1_layers=0, ref_row=ref_row, ref_spread=ref_spread,
                                        what="mesh (y) sp2_tp2_int8 scoring")
        reports = eng.rank_reports()
        out["sp2_tp2_int8"] = {
            "build_s": round(build_s, 3), "admission_s": round(got_long[2], 4),
            "first_token": got_long[0][0], "one_card_first_token": ref_long[0][0],
            **held_long, "streams": rows, **moved,
            "ms_per_verify_turn": (statistics.median(fams["verify"])
                                   if fams.get("verify") else None),
            "verify_turns_timed": len(fams.get("verify", [])),
            "history_bucket": max((k[-1] for k in eng.dispatched_keys
                                   if k[0] == "verify"), default=None),
            "ms_per_plain_dispatch": (statistics.median(fams["plain"])
                                      if fams.get("plain") else None),
            "decode_steps": _k2_steps(m), "captures": m["decode_graph_captures_total"],
            "launches_by_rank": launches, "beside_scoring": beside,
            "peak_bytes_by_rank": [None if cpu else torch.cuda.max_memory_allocated(cards[0])]
            + [r["peak_bytes"] for r in reports],
            "cache_bytes_by_rank": [_cache_bytes(eng)] + [r["cache_bytes"] for r in reports]}
        emit("mesh", leg="y_sp2_tp2_int8", **out["sp2_tp2_int8"])
        add(reports)
    finally:
        eng.shutdown()
    del eng
    _require_card_empty(torch, cpu, "mesh (y) pp=4")

    # (4) mixtral-8x7b as pp=4 with an int8 cache.
    mname = "mixtral-tiny" if cpu else "mixtral-8x7b"
    mspec = resolve_spec(mname, {"dtype": "bfloat16", "n_layers": "4"} if cpu else {})
    ML = mspec.n_layers
    prompts = [[gen.randrange(mspec.vocab_size) for _ in range(k)]
               for k in ((20, 60) if cpu else (200, 900))]
    m_rows, m_len = (4, 32) if cpu else (8, 2048)
    m_scored = [[gen.randrange(mspec.vocab_size) for _ in range(m_len)] for _ in range(m_rows)]
    zero()
    t0 = time.perf_counter()
    eng = InferenceEngine(mspec, mesh=make_mesh(MeshConfig(pp=4), cards,
                                                timeout_s=MESH_GROUP_TIMEOUT_S),
                          n_slots=4, decode_chunk=8, seed=0, kv_quant="int8")
    build_s = time.perf_counter() - t0
    try:
        what = "mesh (y) pp4_kv8"
        n = 8 if cpu else 24
        c0, r0 = _launch_counts(), eng.rank_reports(reset_peak=True)
        first = [_lp_stream(eng, p, n) for p in prompts]
        warm = _lp_stream(eng, prompts[0], n)
        require(warm[0] == first[0][0], f"{what}: the warm stream differs")
        c1, r1 = _launch_counts(), eng.rank_reports()
        m = eng.metrics()
        launches = _rank_launches(c0, c1, r0, r1)
        if not cpu:
            want_q8 = [ML * _k2_steps(m)] * 4
            want_k1 = [ML // 4 * m["admission_dispatches_total"]] * 4
            require(launches["flash_decode_q8"] == want_q8,
                    f"{what}: K2q8 by stage {launches['flash_decode_q8']} != {want_q8}")
            require(launches["flash_prefill"] == want_k1 and not any(launches["flash_decode"]),
                    f"{what}: K1/K2 by stage {launches['flash_prefill']}/"
                    f"{launches['flash_decode']} (K1 wanted {want_k1})")
        cache = [_cache_bytes(eng)] + [r["cache_bytes"] for r in r1]
        require(len(set(cache)) == 1 and isinstance(eng._ck, tuple),
                f"{what}: stage cache bytes {cache}")
        groups = len(embed_mod.row_groups(mspec, [len(t) for t in m_scored]))
        t1 = time.perf_counter()
        got = score_mod.score_token_batch(eng, m_scored, top_k=1)
        score_s = time.perf_counter() - t1
        c2, r2 = _launch_counts(), eng.rank_reports()
        k1 = _rank_launches(c1, c2, r1, r2)["flash_prefill"]
        require(cpu or k1 == [ML // 4 * groups] * 4,
                f"{what}: scoring K1 by stage {k1} for {groups} sub-batches")
        lps = [x for g in got for x in g["token_logprobs"][1:]]
        require(len(got) == m_rows and all(math.isfinite(x) and x <= 0 for x in lps),
                f"{what}: scoring returned non-finite or positive log-probabilities")
        warm_ms = 1e3 * warm[2] / len(warm[0])
        l_ms = (l_row or {}).get("ms_per_token_warm_stream")
        row = {"build_s": round(build_s, 3), "layers_per_stage": ML // 4,
               "ms_per_token_first_stream": round(1e3 * first[0][2] / len(first[0][0]), 3),
               "ms_per_token_warm_stream": round(warm_ms, 3),
               "l_bf16_pp4_ms_per_token_warm": l_ms,
               "cache_bytes_by_stage": cache,
               "weight_bytes_by_stage": [_tree_bytes(eng.params)]
               + [r["weight_bytes"] for r in r2],
               "peak_bytes_by_stage": [None if cpu else torch.cuda.max_memory_allocated(cards[0])]
               + [r["peak_bytes"] for r in r2],
               "launches_by_stage": launches, "decode_steps": _k2_steps(m),
               "scoring": {"rows": m_rows, "row_tokens": m_len, "sub_batches": groups,
                           "seconds": round(score_s, 4), "k1_by_stage": k1}}
        out["pp4_kv8_mixtral"] = row
        emit("mesh", leg="y_pp4_kv8", **row)
        add(r2)
    finally:
        eng.shutdown()
    del eng
    _require_card_empty(torch, cpu, "mesh (y) pp=4 at 4 layers")

    # (5) The staged scoring at 4 layers (a layer a stage) against one card.
    sspec = resolve_spec(mname, {"dtype": "bfloat16", "n_layers": "4"})
    knobs4 = dict(n_slots=4, decode_chunk=8, seed=0, kv_quant="int8")
    t0 = time.perf_counter()
    ref = InferenceEngine(sspec, device=cards[0], **knobs4)
    try:
        want = score_mod.score_token_batch(ref, m_scored, top_k=1)
    finally:
        ref.shutdown()
    del ref
    _require_card_empty(torch, cpu, "mesh (y) pp=4 at 4 layers, one card")
    zero()
    eng = InferenceEngine(sspec, mesh=make_mesh(MeshConfig(pp=4), cards,
                                                timeout_s=MESH_GROUP_TIMEOUT_S), **knobs4)
    try:
        what = "mesh (y) pp4 at 4 layers"
        r0 = eng.rank_reports()
        c0 = _launch_counts()
        got = score_mod.score_token_batch(eng, m_scored, top_k=1)
        k1 = _rank_launches(c0, _launch_counts(), r0, eng.rank_reports())["flash_prefill"]
        require(cpu or k1 == [groups] * 4,
                f"{what}: scoring K1 by stage {k1} for {groups} sub-batches")
        diffs = [abs(a - b) for g, w in zip(got, want)
                 for a, b in zip(g["token_logprobs"][1:], w["token_logprobs"][1:])]
        lp_max, lp_mean = max(diffs), sum(diffs) / len(diffs)
        require(lp_max <= MESH_FORWARD_LP_MAX and lp_mean <= MESH_FORWARD_LP_MEAN,
                f"{what}: scoring log-probabilities differ from one card's by {lp_max} "
                f"(mean {lp_mean})")
        row = {"layers": sspec.n_layers, "rows": m_rows, "row_tokens": m_len,
               "k1_by_stage": k1, "logprob_max_diff_one_card": lp_max,
               "logprob_mean_diff_one_card": lp_mean,
               "seconds": round(time.perf_counter() - t0, 3)}
        out["pp4_scoring_4_layers"] = row
        emit("mesh", leg="y_pp4_scoring_4_layers", **row)
        add(eng.rank_reports())
    finally:
        eng.shutdown()
    del eng
    _require_card_empty(torch, cpu, "mesh (y)")
    return out


def total_model_bytes(spec) -> int:
    """The whole model's weight bytes (``init_params`` on the meta device)."""
    from quorum_tpu_torch.models.init import init_params

    return _tree_bytes(init_params(spec, device="meta"))


def phase_train(torch, cpu: bool, tiny: bool, device_info: dict) -> dict:
    """Training on the card (run last): (a) llama-3-8b at all 32 layers,
    bf16, 3 steps on 1 × 2 048 tokens; (b) llama-tiny float32, card against
    CPU; (c) llama-3-8b widths at 2 layers: checkpoint resume, accumulation,
    serve from the checkpoint. The training steps launch no kernel (plain attention): the phase's K1 and K2 launches are
    leg (c)'s engine's alone."""
    import shutil
    import tempfile

    from quorum_tpu_torch.models.model_config import resolve_spec
    from quorum_tpu_torch.ops.flash_attention import flash_prefill_attention
    from quorum_tpu_torch.ops.flash_decode import flash_decode_attention
    from quorum_tpu_torch.ops.flash_decode_q8 import flash_decode_q8_attention

    dev = "cpu" if cpu else "cuda"
    _require_card_empty(torch, cpu, "train")
    t_phase = time.perf_counter()
    out = {"measured_on": f"{device_info['name']} ({device_info['power_limit']})"}
    if not cpu:
        free, total = torch.cuda.mem_get_info()
        out.update(free_gb_at_start=round(free / 1e9, 3), total_gb=round(total / 1e9, 3))
    for w in (flash_prefill_attention, flash_decode_attention, flash_decode_q8_attention):
        w.launches = 0
    flash_prefill_attention.launches_by_route.update(wgmma=0, fma=0)
    model = "llama-tiny" if tiny else "llama-3-8b"
    n_tokens = 64 if tiny else TRAIN_TOKENS
    timings = {}
    t0 = time.perf_counter()
    out["a"] = _train_full(torch, cpu, resolve_spec(model, {}), dev, n_tokens)
    timings["a"] = time.perf_counter() - t0
    gc.collect()
    _require_card_empty(torch, cpu, "train after (a)")
    t0 = time.perf_counter()
    out["b"] = _train_parity(torch, cpu, dev)
    timings["b"] = time.perf_counter() - t0
    require(_launch_counts() == {"flash_prefill": 0, "flash_decode": 0, "flash_decode_q8": 0},
            f"train: the training steps launched kernels: {_launch_counts()}")
    root = tempfile.mkdtemp(prefix="quorum_train_")
    t0 = time.perf_counter()
    try:
        out["c"] = _train_checkpoint(torch, cpu, resolve_spec(model, {"n_layers": "2"}), dev,
                                     n_tokens, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    timings["c"] = time.perf_counter() - t0
    gc.collect()
    _require_card_empty(torch, cpu, "train after (c)")
    launches = _launch_counts()
    out.update(launches=launches, leg_s={k: round(v, 3) for k, v in timings.items()},
               phase_s=round(time.perf_counter() - t_phase, 3), tmpdir_removed=not os.path.exists(root))
    emit("train", **out)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="rehearsal on the CPU with the plain versions (never the default)")
    ap.add_argument("--tiny", action="store_true", help="llama-tiny shapes (rehearsal)")
    ap.add_argument("--phases",
                    default="device,build,kernels,model,serve,constrain,surfaces,spec,scheduler,"
                            "decode_graphs,knobs,fanout,members,checkpoint,moe,quant,paged,"
                            "observe,router,mesh,train",
                    help="comma-separated subset of phases to run; add 'profile' to trace "
                         "a second round of the serve requests with torch.profiler")
    ap.add_argument("--mesh-cards-only", action="store_true",
                    help="the mesh phase's legs over cards of their own alone "
                         "(h, l, o, p, q, s, u, w, y)")
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
    t_start = time.perf_counter()
    try:
        info = phase_device(torch, args.cpu)
        if "build" in phases:
            phase_build(args.cpu)
        kernels = phase_kernels(torch, args.cpu, args.tiny, median_ms, graph_ms) \
            if "kernels" in phases else None
        if "model" in phases:
            phase_model(torch, args.cpu, args.tiny)
        serve = (phase_serve(torch, args.cpu, args.tiny, info, "profile" in phases,
                             keep_engine=bool({"constrain", "surfaces"} & phases))
                 if "serve" in phases else None)
        constrain = (phase_constrain(torch, args.cpu, args.tiny, info,
                                     keep_engine="surfaces" in phases)
                     if "constrain" in phases else None)
        surfaces = (phase_surfaces(torch, args.cpu, args.tiny, info)
                    if "surfaces" in phases else None)
        spec = (phase_spec(torch, args.cpu, args.tiny, info, graph_ms)
                if "spec" in phases else None)
        scheduler = (phase_scheduler(torch, args.cpu, args.tiny, info)
                     if "scheduler" in phases else None)
        graphs = (phase_decode_graphs(torch, args.cpu, args.tiny, info)
                  if "decode_graphs" in phases else None)
        knobs = (phase_knobs(torch, args.cpu, args.tiny, info, graph_ms)
                 if "knobs" in phases else None)
        fanout = phase_fanout(torch, args.cpu, args.tiny, info) if "fanout" in phases else None
        members = dedup = None
        if "members" in phases:
            members = phase_fanout(torch, args.cpu, args.tiny, info, stacked=True,
                                   reference=fanout)
            dedup = phase_dedup(torch, args.cpu, args.tiny, info)
        ckpt = (phase_checkpoint(torch, args.cpu, args.tiny, info)
                if "checkpoint" in phases else None)
        moe = (phase_moe(torch, args.cpu, args.tiny, info, "profile" in phases)
               if "moe" in phases else None)
        quant = (phase_quant(torch, args.cpu, args.tiny, info, serve, "profile" in phases)
                 if "quant" in phases else None)
        paged = phase_paged(torch, args.cpu, args.tiny, info) if "paged" in phases else None
        observe = (phase_observe(torch, args.cpu, args.tiny, info)
                   if "observe" in phases else None)
        router = (phase_router(torch, args.cpu, args.tiny, info)
                  if "router" in phases else None)
        mesh = (phase_mesh(torch, args.cpu, args.tiny, info, args.mesh_cards_only)
                if "mesh" in phases else None)
        train = phase_train(torch, args.cpu, args.tiny, info) if "train" in phases else None
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    emit("run", phases=sorted(phases), seconds=round(time.perf_counter() - t_start, 3))
    if kernels is not None:
        by_phase = {name: ph["launches"] for name, ph in (
            ("serve", serve), ("constrain", constrain), ("surfaces", surfaces), ("spec", spec),
            ("scheduler", scheduler),
            ("decode_graphs", graphs), ("knobs", knobs), ("fanout", fanout), ("members", members), ("members_dedup", dedup),
            ("checkpoint", ckpt), ("moe", moe), ("quant", quant), ("paged", paged),
            ("observe", observe), ("router", router), ("mesh", mesh), ("train", train))
            if ph is not None}
        rows = []
        for name, src, replaces in (
                ("flash_prefill", "quorum_tpu_torch/csrc/flash_prefill.cu",
                 "quorum_tpu/ops/flash_attention.py:52"),
                ("flash_decode", "quorum_tpu_torch/csrc/flash_decode.cu",
                 "quorum_tpu/ops/flash_decode.py:53"),
                ("flash_decode_q8", "quorum_tpu_torch/csrc/flash_decode_q8.cu",
                 "quorum_tpu/ops/attention.py:119 (decode_attention_q8; XLA, no Pallas "
                 "counterpart)")):
            r = kernels[name]
            row = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                   "launches": sum(ph.get(name, 0) for ph in by_phase.values()),
                   "launches_by_phase": {ph: n.get(name, 0) for ph, n in by_phase.items()},
                   "max_abs_err": r["max_abs_err"],
                   "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                   "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                   "kernel_route": r["route"], "pct_of_bound": r["pct_of_bound"],
                   "eager_ms": r["eager_ms"], "ok": True,
                   # How the main path issues it: K1 eagerly, from admissions
                   # and the embedding and scoring forwards; K2 and K2q8 from
                   # inside every decode dispatch's graph replay.
                   "issue": ("eager (admission; embedding and scoring forwards)"
                             if name == "flash_prefill" else "graph")}
            if name == "flash_prefill":
                row.update(library_masked_ms=r["library_masked_ms"],
                           library_causal_ms=r["library_causal_ms"], per_rank=r["per_rank"])
            if name == "flash_decode":
                row.update(draft_shape=r["draft_shape"], per_rank=r["per_rank"])
            if mesh is not None and name in ("flash_prefill", "flash_decode"):
                # The disaggregated legs' launches, by group (prefill, decode).
                row["launches_by_group"] = {
                    g: n[name] for g, n in mesh["disagg_launches_by_group"].items()}
            if name == "flash_decode_q8":
                row.update(k2_ms_same_lengths_bf16=r["k2_ms_same_lengths_bf16"],
                           long_cache=r["long_cache"], per_rank=r["per_rank"])
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
