"""Observability: the registered metric families, request tracing and the
device profiler — the port's copy of the JAX package's ``observability.py``,
with the same family names, so one dashboard reads both packages.

  - ``METRICS``: the Prometheus families the port feeds (request, TTFT,
    inter-token, queue-wait, prefill and decode-chunk latencies; the paged-KV,
    prefix-store, constrained-decoding and speculation counters; deadlines,
    backend retries, trace propagation, per-family device time, SLO
    accounting and the flight recorder's self-accounting), exposed on
    ``/metrics``. Families of the JAX package's router, disaggregated,
    pipeline-parallel and QoS paths are not registered here: the port has
    none of those paths yet.
  - :class:`RequestTrace`: one per request (id in ``X-Request-Id``), appended
    to by the server, the strategies, the backends and the engine's scheduler
    thread (queue-wait → prefill → decode → aggregate → sse-flush), plus
    wire-level TTFT and flush timings.
  - :class:`TraceStore` (``TRACES``): the in-flight traces and a bounded ring
    of completed ones, served from ``GET /debug/traces``.

Device profiling: with ``QUORUM_TPU_PROFILE_DIR`` set, :func:`maybe_profile`
runs a request under ``torch.profiler`` (CPU and, where there is a card, CUDA
activity) and writes its Chrome trace to ``<dir>/<request id>/trace.json``;
:func:`profile_process` is the on-demand form behind ``POST
/debug/profile?seconds=N``. The profiler is process-global: both share one
single-flight lock, a loser runs untraced (``PROFILE_SKIPPED``) or gets a 409.
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Iterator

from quorum_tpu_torch.ops.launches import GRAPH_LAUNCH_GATE
from quorum_tpu_torch.telemetry.metrics import (  # noqa: F401  (re-exports)
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    validate_exposition,
)
from quorum_tpu_torch.telemetry.recorder import RECORDER

logger = logging.getLogger(__name__)

METRICS = MetricsRegistry()

# Serving latencies, in seconds.
REQUEST_DURATION = METRICS.histogram(
    "quorum_tpu_request_duration_seconds",
    "End-to-end request wall time (headers in to last byte out).")
TTFT = METRICS.histogram(
    "quorum_tpu_ttft_seconds",
    "Time to first content byte on the SSE wire.")
INTER_TOKEN = METRICS.histogram(
    "quorum_tpu_inter_token_seconds",
    "Gap between consecutive content flushes on the SSE wire.",
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
             0.25, 0.5, 1.0, 2.5, 5.0))
QUEUE_WAIT = METRICS.histogram(
    "quorum_tpu_queue_wait_seconds",
    "Engine admission-queue wait (submit to slot claim).")
PREFILL = METRICS.histogram(
    "quorum_tpu_prefill_seconds",
    "Prompt prefill wall time (admission start to cache-complete; chunked "
    "admissions include interleaved decode turns).")
DECODE_CHUNK = METRICS.histogram(
    "quorum_tpu_decode_chunk_seconds",
    "One blocking decode-chunk reap (fetch + delivery) of the scheduler "
    "loop; pipelined chunks' in-flight wait is excluded.",
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
             1.0, 2.5, 5.0, 10.0))

# Pipeline-staged engines (pp > 1): active rows per row group.
DECODE_STAGE_OCCUPANCY = METRICS.gauge(
    "quorum_tpu_decode_stage_occupancy",
    "Active decode rows per pipeline-staged row group (pp>1 engines: "
    "group g's rows are stage g's microbatch slot in the staged ring — "
    "docs/scaling.md). Bare sample stays 0 on unstaged engines; "
    "last-writer-wins across engines sharing the process.")

# The decode ring: dispatches in flight now, and the chunks one dispatch
# (decode_loop=C) produced tokens for.
PIPELINE_DEPTH = METRICS.gauge(
    "quorum_tpu_decode_pipeline_inflight",
    "Decode chunks currently in flight on the device (dispatch ring depth).")
DECODE_LOOP_CHUNKS = METRICS.histogram(
    "quorum_tpu_decode_loop_chunks",
    "Decode chunk segments covered by one device dispatch (decode_loop "
    "megachunk fusion; per-chunk n_valid counts the segments that "
    "produced tokens).",
    buckets=(1, 2, 4, 8, 16, 32, 64))

# Paged KV (kv_pages=1): pool occupancy, page aliasing and copy-on-write.
KV_PAGES_ALLOCATED = METRICS.gauge(
    "quorum_tpu_kv_pages_allocated",
    "KV pool pages currently referenced by a live or retained chain "
    "(kv_pages=1 engines; 0/absent on dense layouts). Last-writer-wins "
    "across engines sharing the process, like the other engine gauges.")
KV_PAGES_FREE = METRICS.gauge(
    "quorum_tpu_kv_pages_free",
    "KV pool pages on the free list (kv_pages=1 engines). "
    "free + allocated == kv_pool_pages.")
KV_PAGE_ALIAS_HITS = METRICS.counter(
    "quorum_tpu_kv_page_alias_hits_total",
    "Tier-0 prefix hits served by page ALIASING under kv_pages=1: the "
    "admission installed refcounted references to the donor's pages "
    "instead of copying KV bytes (kv_handoff_bytes stays 0 for these).")
KV_PAGE_COW_COPIES = METRICS.counter(
    "quorum_tpu_kv_page_cow_copies_total",
    "Copy-on-write boundary-page copies under kv_pages=1: a reused "
    "prefix ended mid-page, so the partially-shared page was copied "
    "(one page) before the new tenant's suffix writes. Full pages "
    "alias by reference and never pay this.")

# Wall time the decode ring spent clamped to depth 1 for an admission, and
# (zero_drain=1) staged admissions that registered onto a live ring.
ADMISSION_STALL_SECONDS = METRICS.counter(
    "quorum_tpu_admission_stall_seconds_total",
    "Wall time the decode dispatch ring spent clamped to depth 1 for an "
    "admission (the drain-based coupling). Structurally 0 under "
    "zero_drain=1, where admission pressure never clamps the ring.")
# Disaggregated prefill/decode serving (cuda://…&disagg=P+D): admission
# prefill runs on its own device group and a completed segment's KV hands
# off into the claimed decode-group slot (cache/kv_transfer.py). The JAX
# package's families, in its words.
KV_HANDOFF_BYTES = METRICS.counter(
    "quorum_tpu_kv_handoff_bytes_total",
    "KV cache bytes handed off between device groups (prefill-group "
    "staging -> decode-group slot), labelled route= direct (same-layout "
    "device->device put), reshard (either side partitioned: per-group tp= "
    "or an sp-sharded staging cache, re-laid-out on the fly), host-bounce "
    "(the explicit d2h+h2d fallback), or resident (zero-drain same-mesh "
    "injection: 0 bytes cross any boundary).")
KV_HANDOFF_SECONDS = METRICS.histogram(
    "quorum_tpu_kv_handoff_seconds",
    "One chunk-granular KV handoff between device groups (slice dispatch "
    "to landed-on-target), blocking on the prefill scheduler thread; "
    "route= labels as on quorum_tpu_kv_handoff_bytes_total.",
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
             0.25, 0.5, 1.0, 2.5, 5.0))
PREFILL_GROUP_ACTIVE = METRICS.gauge(
    "quorum_tpu_prefill_group_active",
    "In-flight chunked admissions occupying the prefill device group "
    "right now (last-writer-wins across engines sharing the process).")
DECODE_GROUP_ACTIVE = METRICS.gauge(
    "quorum_tpu_decode_group_active",
    "Busy decode-group slots right now (last-writer-wins across engines "
    "sharing the process).")
ADMISSION_OVERLAP = METRICS.counter(
    "quorum_tpu_admission_overlap_total",
    "Staged-injection admissions that registered onto a live ring "
    "(in-flight dispatches or active resident rows the admission never "
    "drained or clamped). Structurally 0 on drain-based engines, whose "
    "admissions never ride the injection queue.")

# The QoS scheduler (qos=1, sched/): mid-decode preemptions by victim class,
# the delivered tokens they parked (regenerated on resume), and the pending
# queue's depth per priority class (refreshed each scheduler turn).
PREEMPTIONS = METRICS.counter(
    "quorum_tpu_preemptions_total",
    "Mid-decode preemptions by victim class (class=batch|background): a "
    "lower-class row parked at a scheduler turn so a higher-class "
    "admission could take its slot (qos=1 engines only).")
PREEMPTED_TOKENS = METRICS.counter(
    "quorum_tpu_preempted_tokens_total",
    "Generated tokens parked at preemption — already delivered to their "
    "consumers, regenerated token-for-token on resume (the replay the "
    "engine checks against the delivered stream).")
SCHED_QUEUE_DEPTH = METRICS.gauge(
    "quorum_tpu_sched_queue_depth",
    "Pending admissions by priority class "
    "(class=interactive|batch|background).")

# The host prefix store (prefix_store=host).
PREFIX_STORE_HITS = METRICS.counter(
    "quorum_tpu_prefix_store_hits_total",
    "Admissions whose prompt prefix was restored from the host prefix "
    "store (the store's match beat the slot-resident LCP).")
PREFIX_STORE_RESTORED_TOKENS = METRICS.counter(
    "quorum_tpu_prefix_store_restored_tokens_total",
    "Prompt tokens restored host->device instead of being re-prefilled.")
PREFIX_STORE_EVICTIONS = METRICS.counter(
    "quorum_tpu_prefix_store_evictions_total",
    "KV chunks evicted from the host prefix store (byte-budget LRU).")
PREFIX_STORE_BYTES = METRICS.gauge(
    "quorum_tpu_prefix_store_bytes",
    "Bytes of KV prefix data held in the host store right now "
    "(last-writer-wins across engines sharing the process).")
PREFIX_STORE_RESTORE = METRICS.histogram(
    "quorum_tpu_prefix_store_restore_seconds",
    "Host->device restore of a matched KV prefix into a claimed slot "
    "(transfer + cache write, blocking on the scheduler thread).",
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
             1.0, 2.5, 5.0, 10.0))

# Constrained decoding (constrain/ and the engine's grammar arena).
CONSTRAINED_REQUESTS = METRICS.counter(
    "quorum_tpu_constrained_requests_total",
    "Requests served under a response_format grammar (json_object / "
    "json_schema / regex).")
CONSTRAIN_MASKED_TOKENS = METRICS.counter(
    "quorum_tpu_constrain_masked_tokens_total",
    "Vocabulary entries masked to -inf by the on-device grammar DFA, "
    "summed over every decode step of every constrained row.")
CONSTRAIN_CACHE_HITS = METRICS.counter(
    "quorum_tpu_constrain_cache_hits_total",
    "Grammar compilations served from the (grammar, tokenizer) cache.")
CONSTRAIN_CACHE_MISSES = METRICS.counter(
    "quorum_tpu_constrain_cache_misses_total",
    "Grammar compilations that had to run (cache miss).")
CONSTRAIN_COMPILE = METRICS.histogram(
    "quorum_tpu_constrain_compile_seconds",
    "Grammar -> token-DFA compile time (regex/schema lowering, byte-DFA "
    "construction, token lifting) on a cache miss.",
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
             1.0, 2.5, 5.0, 10.0))

# Speculative decoding: turns, draft and accepted tokens, acceptance per turn.
SPEC_TURNS = METRICS.counter(
    "quorum_tpu_spec_turns_total",
    "Speculative verify turns executed (one per verify dispatch; a fused "
    "draft-model dispatch counts each executed turn of its on-device "
    "scan).")
SPEC_DRAFT_TOKENS = METRICS.counter(
    "quorum_tpu_spec_draft_tokens_total",
    "Real (non-sentinel) draft tokens proposed to verify turns, summed "
    "over rows — prompt-lookup continuations or draft-model tokens.")
SPEC_ACCEPTED_TOKENS = METRICS.counter(
    "quorum_tpu_spec_accepted_tokens_total",
    "Draft tokens accepted by verification and delivered to a consumer "
    "(the turn's own first sampled token is the model's step, not a "
    "draft — it never counts).")
SPEC_ACCEPTANCE = METRICS.histogram(
    "quorum_tpu_spec_accepted_per_turn",
    "Accepted draft tokens per row per executed verify turn (0 = only "
    "the model's own token emitted; the bucket spread IS the acceptance "
    "profile speculation's tok/s win depends on).",
    buckets=(0.0, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0))

# Deadlines and HTTP backend retries.
DEADLINE_EXCEEDED = METRICS.counter(
    "quorum_tpu_deadline_exceeded_total",
    "Requests that ran past their deadline, by stage: queue = shed before "
    "admission (503 + Retry-After), prefill/decode = cancelled after "
    "admission (504), backend = an HTTP/device hop outlived its wait.")
BACKEND_RETRIES = METRICS.counter(
    "quorum_tpu_backend_retries_total",
    "HTTP backend attempts retried after a connect error or 5xx "
    "(opt-in per-backend retries= config knob), by backend.")

# The router tier (router/): placement, failover, prefix migration and
# stream resume. Process-wide like every family: a replica reads them at 0.
ROUTER_REQUESTS = METRICS.counter(
    "quorum_tpu_router_requests_total",
    "Requests the router placed, by replica and outcome (ok = a 2xx/4xx "
    "relay, failover = this replica failed pre-stream and the request "
    "moved on, error = the relayed terminal failure).")
ROUTER_AFFINITY_HITS = METRICS.counter(
    "quorum_tpu_router_affinity_hits_total",
    "Requests served by the replica their conversation key hashes to "
    "(the bounded-load consistent-hash primary) — where the KV prefix "
    "from earlier turns lives.")
ROUTER_AFFINITY_MISSES = METRICS.counter(
    "quorum_tpu_router_affinity_misses_total",
    "Requests served AWAY from their affinity primary: bounded-load "
    "spill, failover, the primary out of the ring, or policy=random.")
ROUTER_FAILOVERS = METRICS.counter(
    "quorum_tpu_router_failovers_total",
    "Pre-first-byte upstream failures that moved a request to the next "
    "ring candidate, by the replica that failed.")
ROUTER_MIGRATED_BYTES = METRICS.counter(
    "quorum_tpu_router_migrated_bytes_total",
    "Serialized KV prefix-chunk bytes moved between replicas by the "
    "router's rotation migration (GET/PUT /debug/prefix/chunks).")
ROUTER_MIGRATED_CHAINS = METRICS.counter(
    "quorum_tpu_router_migrated_chains_total",
    "Prefix chunk chains moved between replicas by rotation migration.")
ROUTER_STREAM_RESUMES = METRICS.counter(
    "quorum_tpu_router_stream_resumes_total",
    "Mid-stream resume outcomes (docs/robustness.md 'Zero-loss streams'): "
    "resumed = the journaled stream spliced onto a sibling replica "
    "token-exactly; divergence = the sibling's replay byte-check failed "
    "and the stream degraded to the error-chunk contract; failed = a "
    "resume attempt died pre-commit and the next candidate was tried; "
    "exhausted = no candidate/deadline remained; unresumable = the "
    "journal could not cover the stream (no token-id metadata, bound "
    "overflow, or the finish chunk already relayed).")

# Stacked members' shared-prefix dedup, and the aggregation hop's fallbacks.
QUORUM_DEDUP_TOKENS = METRICS.counter(
    "quorum_tpu_quorum_dedup_tokens_total",
    "Prefill tokens NOT recomputed by shared-prefix member dedup "
    "(quorum_dedup=1 on a members=M engine): a member-complete admission "
    "group with identical prompts prefills ONCE and broadcasts into the "
    "[M, ...] stacked cache, saving (M-1) x n_prompt tokens per group.")
# Cross-cell quorum (quorum/): members dropped, and outcomes per request.
QUORUM_DEGRADED = METRICS.counter(
    "quorum_tpu_quorum_degraded_total",
    "Quorum members dropped mid-request while the quorum was SERVED from "
    "the survivors (never failed), by reason: member_failed = a member "
    "leg died pre-first-byte on every candidate; stream_broken = a "
    "member's live stream died and token-exact resume was exhausted; "
    "resume_diverged = the replay guard refused the member's resume; "
    "no_content = a member completed empty.")
QUORUM_REQUESTS = METRICS.counter(
    "quorum_tpu_quorum_requests_total",
    "Router-tier quorum fan-outs (the quorum= body knob), by outcome: "
    "full = every member contributed, degraded = served from a strict "
    "subset of members, failed = no member produced content.")
AGGREGATE_DEGRADED = METRICS.counter(
    "quorum_tpu_aggregate_degraded_total",
    "Aggregate-strategy combines that fell back to the separator-join of "
    "the member outputs instead of a real LLM aggregation, by reason: "
    "no_aggregator = none configured, no_credentials = the aggregator "
    "required auth no header provided, error = the aggregator call "
    "failed or returned non-2xx, empty = it returned no content. The "
    "first underlying error rides the X-Quorum-Aggregate-Error response "
    "header.")

# The router's view of its replicas: SLO burn per replica and class (from
# their /debug/telemetry), burn demotions, and one telemetry pull's time.
ROUTER_REPLICA_BURN = METRICS.gauge(
    "quorum_tpu_router_replica_burn",
    "Last absorbed SLO burn rate per replica and class (the router's "
    "/ready poller pulls each replica's GET /debug/telemetry; stale "
    "telemetry keeps the last reading but stops driving demotion).")
ROUTER_BURN_DEMOTIONS = METRICS.counter(
    "quorum_tpu_router_burn_demotions_total",
    "Placements in which a replica was demoted to the candidate tail "
    "because its interactive-class burn rate exceeded the router's "
    "threshold (per-request reorder like bounded-load spill — membership "
    "untouched, fail-open when telemetry is stale).")
TELEMETRY_POLL_SECONDS = METRICS.histogram(
    "quorum_tpu_telemetry_poll_seconds",
    "One replica telemetry pull (GET /debug/telemetry inside the router's "
    "/ready poll sweep), request to parsed snapshot.",
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
             0.25, 0.5, 1.0, 2.5, 5.0))
# Trace propagation, per-family device time (on the card: a decode graph
# replay's CUDA-event time, read at reap), SLO accounting.
TRACE_PROPAGATED = METRICS.counter(
    "quorum_tpu_trace_propagated_total",
    "Requests stamped with a W3C trace-id, by source: client = an "
    "incoming traceparent was honored, server = this tier minted "
    "one (none arrived), engine = an engine-direct submission self-minted "
    "its flight-recorder correlation id.")
DISPATCH_DEVICE_SECONDS = METRICS.histogram(
    "quorum_tpu_dispatch_device_seconds",
    "Per-dispatch device time by program family (decode-ring families: a "
    "graph replay's CUDA-event time on the card, dispatch to payload-ready "
    "on the CPU; admission-path families: dispatch wall at the call "
    "site).",
    buckets=(0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
             0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0))
SLO_GOOD = METRICS.counter(
    "quorum_tpu_slo_good_total",
    "Requests that met the stage's objective for their SLO class "
    "(class=interactive|batch, stage=ttft|inter_token|deadline).")
SLO_BREACHED = METRICS.counter(
    "quorum_tpu_slo_breached_total",
    "Requests that breached the stage's objective for their SLO class "
    "(class=interactive|batch, stage=ttft|inter_token|deadline).")

# The flight recorder's ring depth (refreshed on /metrics scrapes) and the
# events its bounded ring overwrote; profiles skipped while the profiler
# was busy.
FLIGHT_RECORDER_EVENTS = METRICS.gauge(
    "quorum_tpu_flight_recorder_events",
    "Events currently held in the engine flight recorder's bounded ring "
    "(GET /debug/engine/timeline; QUORUM_TPU_FLIGHT_EVENTS caps it).")
FLIGHT_RECORDER_DROPPED = METRICS.counter(
    "quorum_tpu_flight_recorder_dropped_total",
    "Flight-recorder events overwritten by the bounded ring (the oldest "
    "event falls off when a new one lands on a full ring).")
PROFILE_SKIPPED = METRICS.counter(
    "quorum_tpu_profile_skipped_total",
    "Requests that ran unprofiled because the process-global torch "
    "profiler was busy with another trace (QUORUM_TPU_PROFILE_DIR "
    "per-request tracing, or a POST /debug/profile in flight).")

# The bounded ring's overwrite hook (the recorder imports nothing from this
# module: the wiring lives on this side).
RECORDER.on_drop = FLIGHT_RECORDER_DROPPED.inc


# ---- request-scoped tracing ------------------------------------------------

# Span budget per trace: a pathological 100k-token generation must not grow
# an unbounded span list; past the cap only the drop counter advances.
MAX_SPANS = 512
# Wire flush-timing budget per trace (ttft + the first N inter-token gaps).
MAX_TOKEN_TIMES = 2048


class Span:
    """One timed phase inside a request. ``start``/``end`` are seconds
    relative to the trace's origin; ``meta`` carries small tags (backend,
    bucket, occupancy...)."""

    __slots__ = ("name", "start", "end", "meta")

    def __init__(self, name: str, start: float, end: float | None = None,
                 meta: dict | None = None):
        self.name = name
        self.start = start
        self.end = end
        self.meta = meta or {}

    def to_dict(self) -> dict:
        out = {
            "name": self.name,
            "start_s": round(self.start, 6),
            "end_s": None if self.end is None else round(self.end, 6),
            "duration_ms": (None if self.end is None
                            else round((self.end - self.start) * 1000, 3)),
        }
        if self.meta:
            out["meta"] = self.meta
        return out


class RequestTrace:
    """Span recorder for ONE request, appended to from any thread.

    The server creates it per request; the engine scheduler, strategies, and
    the SSE wire wrapper record into it through :func:`current_trace` /
    direct references. ``phases`` (name → accumulated seconds), ``total``
    and ``log()`` summarize it."""

    def __init__(self, request_id: str, mode: str = "",
                 trace_id: str = "", span_id: str = ""):
        self.request_id = request_id
        # W3C trace-context identity (telemetry/tracecontext.py): the
        # 32-hex trace-id names this request across tiers and is the
        # flight-recorder rid; the 16-hex span-id names THIS server hop.
        # Empty on untraced callers (engine-direct submissions, non-chat
        # endpoints): the engine then mints its own.
        self.trace_id = trace_id
        self.span_id = span_id
        self._t0 = time.perf_counter()
        self.started_at = time.time()
        self._lock = threading.Lock()
        self.spans: list[Span] = []
        self.dropped_spans = 0
        self.meta: dict = {"mode": mode} if mode else {}
        self.ttft: float | None = None
        self.token_times: list[float] = []  # wire flush times, rel. seconds
        self.n_tokens = 0        # content flushes, NOT capped like the list
        # Worst gap between consecutive content flushes, tracked UNCAPPED
        # (the token_times list stops at MAX_TOKEN_TIMES — a stall past
        # the cap must still be visible to the SLO inter_token scorer).
        self.max_token_gap: float | None = None
        self._last_token_t: float | None = None
        self.n_flushes = 0
        self.status: int | None = None
        self.duration: float | None = None  # set by finish()

    # -- clocks --------------------------------------------------------------

    def now(self) -> float:
        """Seconds since this trace began (the span timebase)."""
        return time.perf_counter() - self._t0

    def rel(self, perf_t: float) -> float:
        """A ``time.perf_counter()`` stamp → this trace's timebase."""
        return perf_t - self._t0

    # -- spans ---------------------------------------------------------------

    def add_span(self, name: str, start: float, end: float | None = None,
                 **meta: Any) -> Span:
        """Record a span with trace-relative times (see :meth:`rel`).

        Completed traces are immutable: a timed-out request's still-running
        device loop keeps calling in for minutes after the trace was
        published to /debug/traces — those late spans are counted in
        ``dropped_spans``, never appended (the returned detached span keeps
        callers' ``span.end = ...`` stamping harmless)."""
        span = Span(name, start, end, meta or None)
        with self._lock:
            if self.duration is not None or len(self.spans) >= MAX_SPANS:
                self.dropped_spans += 1
            else:
                self.spans.append(span)
        return span

    def add_span_abs(self, name: str, start_perf: float, end_perf: float,
                     **meta: Any) -> Span:
        """Record a span from two ``time.perf_counter()`` stamps."""
        return self.add_span(name, self.rel(start_perf), self.rel(end_perf),
                             **meta)

    @contextlib.contextmanager
    def span(self, name: str, **meta: Any) -> Iterator[Span]:
        s = self.add_span(name, self.now(), **meta)
        try:
            yield s
        finally:
            s.end = self.now()

    # -- wire timing ---------------------------------------------------------

    def mark_flush(self, content: "bool | int") -> None:
        """One SSE write hit the wire; ``content`` counts the token-bearing
        frames it carried (role chunks and [DONE] don't set TTFT; a
        coalesced write ships several content frames in one flush — bools
        are accepted for the uncoalesced single-frame case)."""
        t = self.now()
        count = int(content)
        with self._lock:
            if self.duration is not None:
                return  # completed traces are immutable (see add_span)
            self.n_flushes += 1
            if count <= 0:
                return
            if self.ttft is None:
                self.ttft = t
                TTFT.observe(t)
            else:
                # Gap from the LAST content flush, tracked independently of
                # the capped token_times list — past the cap each gap must
                # still measure one flush, not the distance back to entry
                # MAX_TOKEN_TIMES. One observation per FLUSH: frames inside
                # a coalesced write arrived together, a zero gap per extra
                # frame would fake wire latency the client never saw.
                gap = t - self._last_token_t
                INTER_TOKEN.observe(gap)
                if self.max_token_gap is None or gap > self.max_token_gap:
                    self.max_token_gap = gap
            self._last_token_t = t
            self.n_tokens += count
            # All of a coalesced flush's tokens hit the wire at t.
            for _ in range(count):
                if len(self.token_times) >= MAX_TOKEN_TIMES:
                    break
                self.token_times.append(t)

    # -- lifecycle -----------------------------------------------------------

    def finish(self, status: int | None = None) -> None:
        """Close the trace: stamp status + total duration, observe the
        request-duration histogram, close any still-open spans (a client
        disconnect can abandon one mid-phase). Idempotent."""
        with self._lock:
            if self.duration is not None:
                return
            self.duration = self.now()
            if status is not None:
                self.status = status
            for s in self.spans:
                if s.end is None:
                    s.end = self.duration
        # Status-class label: a flood of fast-failing 4xxs must not read as
        # serving latency collapsing on a dashboard's unlabeled p50.
        klass = (f"{self.status // 100}xx" if self.status is not None
                 else "unknown")
        REQUEST_DURATION.observe(self.duration, status=klass)

    # -- serialization -------------------------------------------------------

    def to_dict(self) -> dict:
        with self._lock:
            spans = sorted(self.spans, key=lambda s: s.start)
            out = {
                "request_id": self.request_id,
                "started_at": self.started_at,
                "in_flight": self.duration is None,
                "status": self.status,
                "duration_ms": (None if self.duration is None
                                else round(self.duration * 1000, 3)),
                "ttft_ms": (None if self.ttft is None
                            else round(self.ttft * 1000, 3)),
                "tokens": self.n_tokens,
                "sse_flushes": self.n_flushes,
                "token_times_ms": [round(t * 1000, 3)
                                   for t in self.token_times],
                "spans": [s.to_dict() for s in spans],
                "dropped_spans": self.dropped_spans,
            }
            if self.trace_id:
                out["trace_id"] = self.trace_id
                out["span_id"] = self.span_id
            if self.meta:
                out["meta"] = dict(self.meta)
        return out

    def summary(self) -> dict:
        """The /debug/traces list row: the scalar fields only — built
        directly, NOT via to_dict(), so listing a full ring never
        materializes (and discards) thousands of span/timing dicts under
        live traces' locks."""
        with self._lock:
            return {
                "request_id": self.request_id,
                "started_at": self.started_at,
                "in_flight": self.duration is None,
                "status": self.status,
                "duration_ms": (None if self.duration is None
                                else round(self.duration * 1000, 3)),
                "ttft_ms": (None if self.ttft is None
                            else round(self.ttft * 1000, 3)),
                "tokens": self.n_tokens,
                "sse_flushes": self.n_flushes,
                "dropped_spans": self.dropped_spans,
                **({"trace_id": self.trace_id} if self.trace_id else {}),
                **({"meta": dict(self.meta)} if self.meta else {}),
            }

    @property
    def phases(self) -> dict[str, float]:
        """Accumulated seconds per span name (closed spans only)."""
        with self._lock:
            out: dict[str, float] = {}
            for s in self.spans:
                if s.end is not None:
                    out[s.name] = out.get(s.name, 0.0) + (s.end - s.start)
        return out

    @property
    def total(self) -> float:
        return self.duration if self.duration is not None else self.now()

    def log(self, mode: str, **extra: Any) -> None:
        """One structured summary line per request."""
        detail = " ".join(f"{k}={v}" for k, v in extra.items())
        phases = " ".join(f"{k}={v * 1000:.1f}ms"
                          for k, v in self.phases.items())
        wire = ""
        if self.ttft is not None:
            wire = f"ttft={self.ttft * 1000:.1f}ms tokens={self.n_tokens}"
        logger.info(
            "request %s mode=%s total=%.1fms %s %s %s",
            self.request_id, mode, self.total * 1000, phases, wire, detail,
        )


class TraceStore:
    """In-flight traces plus a bounded ring of completed ones."""

    def __init__(self, capacity: int | None = None):
        if capacity is None:
            capacity = int(os.environ.get("QUORUM_TPU_TRACE_CAPACITY", "256"))
        self.capacity = max(1, capacity)
        self._lock = threading.Lock()
        self._inflight: dict[str, RequestTrace] = {}
        self._completed: deque[RequestTrace] = deque(maxlen=self.capacity)

    def start(self, trace: RequestTrace) -> RequestTrace:
        with self._lock:
            self._inflight[trace.request_id] = trace
        return trace

    def complete(self, trace: RequestTrace) -> None:
        with self._lock:
            self._inflight.pop(trace.request_id, None)
            self._completed.append(trace)

    def get(self, request_id: str) -> RequestTrace | None:
        with self._lock:
            t = self._inflight.get(request_id)
            if t is not None:
                return t
            for t in self._completed:
                if t.request_id == request_id:
                    return t
        return None

    def snapshot(self, limit: int | None = None) -> dict:
        """Summaries of every in-flight trace plus completed ones newest
        first — the whole ring by default (it is already bounded by
        ``capacity``); ``limit`` trims the listing further."""
        with self._lock:
            inflight = list(self._inflight.values())
            completed = list(self._completed)
        completed.reverse()  # newest first
        rows = inflight + completed
        if limit is not None:
            rows = rows[:limit]
        return {
            "capacity": self.capacity,
            "in_flight": len(inflight),
            "completed": len(completed),
            "traces": [t.summary() for t in rows],
        }


TRACES = TraceStore()

_current_trace: contextvars.ContextVar[RequestTrace | None] = \
    contextvars.ContextVar("quorum_tpu_trace", default=None)


def current_trace() -> RequestTrace | None:
    """The trace of the request this task/thread is serving, if any."""
    return _current_trace.get()


@contextlib.contextmanager
def use_trace(trace: RequestTrace | None) -> Iterator[RequestTrace | None]:
    """Bind ``trace`` as the current trace for this context (None is a
    no-op bind, so callers can pass through an optional trace)."""
    token = _current_trace.set(trace)
    try:
        yield trace
    finally:
        _current_trace.reset(token)


@contextlib.contextmanager
def trace_span(trace: RequestTrace | None, name: str, **meta: Any):
    """``trace.span(...)`` tolerant of ``trace is None``."""
    if trace is None:
        yield None
        return
    with trace.span(name, **meta) as s:
        yield s


def finish_request_trace(trace: RequestTrace, status: int | None = None,
                         mode: str = "") -> None:
    """Request teardown: close the trace, move it to the completed ring,
    score its SLO class (when the server tagged one — telemetry/slo.py),
    and emit the one structured per-request summary line."""
    trace.finish(status=status)
    TRACES.complete(trace)
    if trace.meta.get("slo"):
        from quorum_tpu_torch.telemetry.slo import SLO

        try:
            SLO.score_trace(trace)
        except Exception:
            logger.exception("SLO scoring failed for %s", trace.request_id)
    trace.log(mode or trace.meta.get("mode", ""), status=trace.status)


_profile_lock = threading.Lock()
_profiler_ready = False


@contextlib.contextmanager
def _session() -> Iterator[Any]:
    """A ``torch.profiler`` session over the CPU and, where there is a card,
    CUDA activity (every kernel the device runs, graph replays included),
    started and stopped behind :data:`GRAPH_LAUNCH_GATE`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    with GRAPH_LAUNCH_GATE:
        prof.start()
    try:
        yield prof
    finally:
        with GRAPH_LAUNCH_GATE:
            prof.stop()


def prepare_profiler() -> None:
    """Run one empty profiler session on the calling thread, once per
    process. Kineto initializes its client on the thread that imported
    torch: a process whose first session starts on another thread records
    no device activity in it. The server calls this on its event loop's
    thread (the main thread) before it profiles off it."""
    global _profiler_ready
    if _profiler_ready or not _profile_lock.acquire(blocking=False):
        return
    try:
        with _session():
            pass
        _profiler_ready = True
    finally:
        _profile_lock.release()


@contextlib.contextmanager
def maybe_profile(request_id: str):
    """A ``torch.profiler`` trace of this request when QUORUM_TPU_PROFILE_DIR
    is set (the Chrome trace lands in ``<dir>/<request id>/trace.json``); a
    no-op otherwise. The profiler is process-global and cannot nest: while
    another trace runs, this request proceeds untraced, counted in
    ``quorum_tpu_profile_skipped_total`` and recorded as a
    ``profile-skipped`` flight-recorder event."""
    profile_dir = os.environ.get("QUORUM_TPU_PROFILE_DIR", "")
    if not profile_dir:
        yield
        return
    if not _profile_lock.acquire(blocking=False):
        logger.debug("profiler busy — request %s runs untraced", request_id)
        PROFILE_SKIPPED.inc()
        RECORDER.record("profile-skipped", rid=request_id, loop="server")
        yield
        return
    try:
        out = os.path.join(profile_dir, request_id)
        with _session() as prof:
            yield
        os.makedirs(out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out, "trace.json"))
    finally:
        _profile_lock.release()


class ProfilerBusy(RuntimeError):
    """The process-global profiler is already tracing (surface as 409)."""


def profile_process(seconds: float, profile_dir: str | None = None) -> str:
    """On-demand whole-process profile (``POST /debug/profile``): run
    ``torch.profiler`` (CPU, and CUDA where there is a card: every kernel the
    device runs, graph replays included) for ``seconds``, blocking the
    calling thread (the route runs it in a worker thread), and write the
    Chrome trace to ``<dir>/trace.json``. Returns the directory.

    Single-flight behind :func:`maybe_profile`'s lock, raising
    :class:`ProfilerBusy` instead of queueing: a profile of "the next N
    seconds, later" is not the profile the operator asked for."""
    if not _profile_lock.acquire(blocking=False):
        PROFILE_SKIPPED.inc()
        RECORDER.record("profile-skipped", rid="on-demand", loop="server")
        raise ProfilerBusy("profiler busy with another trace")
    try:
        base = (profile_dir or os.environ.get("QUORUM_TPU_PROFILE_DIR", "")
                or os.path.join("profiles", "ondemand"))
        out = os.path.join(base, time.strftime("%Y%m%d-%H%M%S"))
        RECORDER.record("profile-start", rid="on-demand", loop="server",
                        seconds=seconds, dir=out)
        with _session() as prof:
            time.sleep(max(0.0, float(seconds)))
        os.makedirs(out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out, "trace.json"))
        return out
    finally:
        _profile_lock.release()
