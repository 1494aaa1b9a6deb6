"""The OpenAI-compatible application.

  POST /chat/completions, /v1/chat/completions   streamed (SSE) or not
  POST /embeddings, /v1/embeddings               one backend's vectors
  POST /completions, /v1/completions             legacy completions and scoring
  GET  /health, /v1/health                       engine liveness (200/503)
  GET  /ready, /v1/ready                         would new work be admitted?
  GET  /models, /v1/models                       configured model ids
  GET  /metrics, /v1/metrics                     Prometheus text exposition
  GET  /debug/traces[/{request_id}]              request span timelines
  GET  /debug/engine/timeline[?format=perfetto]  the engine flight recorder
  GET  /debug/telemetry                          compact host-side snapshot
  POST /debug/profile?seconds=N                  torch.profiler, whole process
  GET/PUT /debug/prefix/chunks                   prefix-store export/import
  POST /admin/drain[?park=1], GET /admin/drain   begin a drain, its progress
  POST /admin/undrain                            reopen admissions

(each also under ``/v1``). The status codes, error types and body keys are
the JAX package's server's.

Request handling follows the JAX package's server: a missing Authorization
header falls back to ``$OPENAI_API_KEY``, else 401; malformed knobs are one
400; ``quorum`` > 1 is a 400 (fanning out across replicas is a router's
job); no backend is a 500 ``configuration_error``; no model in the request
and none on any target backend is a 400.

Modes. **Parallel** (a strategy config and more than one backend): the
request fans out to every backend (in the aggregate strategy, to
``source_backends``) and the answers are combined by concatenation or by the
aggregator's second hop (``strategies/``), streamed or not. **Otherwise**, a
non-streamed request still calls every backend at once and returns the
first success verbatim; a streamed one is served by the first backend alone.
When every backend fails with a client error, a 503 or a 504, the first
error is relayed as is; any other all-failed case is one 500.

``/embeddings`` and ``/completions`` never fan out: one embedding space (or
one scoring model) per response. The target is the backend whose
configured model is the request's; with no model in the request, the first
backend that serves the route; a requested model no such backend is pinned
to falls to a blank-model relay, else a 404 ``model_not_found``. Streamed
``/completions`` (one prompt, no echo or logprobs) runs on the backend's
chat stream over the raw prompt ids and is sent as legacy
``text_completion`` frames.

Drain: ``POST /admin/drain`` shuts every engine's admissions (new work gets
a retryable 503, ``/health`` turns ``degraded`` and ``/ready`` 503) and lets
residents finish; ``?park=1`` also parks them — a stream ends
``finish_reason: "parked"`` for a router to resume elsewhere, a
non-streamed request gets a 503. ``POST /admin/undrain`` reopens.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import os
import time
import uuid
from typing import Any, AsyncIterator

from quorum_tpu_torch import oai, sse
from quorum_tpu_torch.backends.base import BackendError
from quorum_tpu_torch.backends.registry import BackendRegistry, build_registry
from quorum_tpu_torch.config import Config, load_config
from quorum_tpu_torch.observability import (FLIGHT_RECORDER_EVENTS, METRICS, TRACE_PROPAGATED,
                                            TRACES, ProfilerBusy, RequestTrace,
                                            finish_request_trace, maybe_profile,
                                            prepare_profiler, profile_process, use_trace)
from quorum_tpu_torch.server.asgi import App, JSONResponse, Request, Response, StreamingResponse
from quorum_tpu_torch.server.reload import ConfigWatcher, Runtime
from quorum_tpu_torch.telemetry import slo as slo_mod
from quorum_tpu_torch.telemetry import tracecontext
from quorum_tpu_torch.telemetry.recorder import RECORDER
from quorum_tpu_torch.strategies.combine import combine_outcomes, degraded_headers
from quorum_tpu_torch.strategies.fanout import fanout_complete
from quorum_tpu_torch.strategies.streaming import StreamPlan, parallel_stream

logger = logging.getLogger(__name__)

_PASSTHROUGH_SKIP = {"content-length", "content-type", "transfer-encoding",
                     "content-encoding", "connection"}


def _error(message: str, type_: str, status: int, headers=None) -> JSONResponse:
    return JSONResponse({"error": {"message": message, "type": type_}}, status_code=status,
                        headers=headers)


def _auth_error() -> JSONResponse:
    return _error("Authorization header is required and OPENAI_API_KEY environment variable "
                  "is not set", "auth_error", 401)


def _resolve_headers(request_headers: dict[str, str]) -> dict[str, str] | None:
    """Forward headers minus host; normalize/inject Authorization. Returns
    None when no credential is available (→ 401)."""
    headers = {k: v for k, v in request_headers.items() if k.lower() != "host"}
    lower_to_orig = {k.lower(): k for k in headers}
    if "authorization" not in lower_to_orig:
        api_key = os.environ.get("OPENAI_API_KEY", "")
        if not api_key:
            return None
        headers["Authorization"] = f"Bearer {api_key}"
    elif "Authorization" not in headers:
        headers["Authorization"] = headers.pop(lower_to_orig["authorization"])
    if "content-type" not in lower_to_orig:
        headers["Content-Type"] = "application/json"
    return headers


class _SSECoalescer:
    """MoreChunk runs buffered into one flush: ``add`` returns the bytes to
    write now (b"" while buffering); ``drain`` whatever is still buffered,
    before an error frame or ``[DONE]``."""

    def __init__(self) -> None:
        self._buf: list[bytes] = []

    def add(self, chunk: dict[str, Any], frame: bytes | None) -> bytes:
        if frame is not None:
            self._buf.append(frame)
        if not oai.has_more(chunk) and self._buf:
            return self.drain()
        return b""

    def drain(self) -> bytes:
        out = b"".join(self._buf)
        self._buf.clear()
        return out


def _relay_backend_error(e: BackendError) -> Response:
    """Typed client errors keep their body verbatim; everything else
    normalizes to proxy_error. Response headers (Retry-After) ride along."""
    err = e.body.get("error")
    if isinstance(err, dict) and err.get("type") not in (None, "proxy_error"):
        return JSONResponse(e.body, status_code=e.status_code, headers=e.headers)
    msg = err.get("message", str(e)) if isinstance(err, dict) else str(e)
    return _error(f"Backend failed: {msg}", "proxy_error", e.status_code, e.headers)


async def _stream_with_role(first_chunk: dict[str, Any] | None,
                            rest: AsyncIterator[dict[str, Any]],
                            model: str) -> AsyncIterator[bytes]:
    """Single-backend SSE: a synthetic role chunk first, the backend's own
    role-only chunk skipped, MoreChunk runs joined into one flush, an error
    chunk on mid-stream failure, and ``data: [DONE]`` always last."""
    yield sse.encode_event(oai.chunk(id="chatcmpl-role", model=model,
                                     delta={"role": "assistant"}))
    co = _SSECoalescer()
    try:
        if first_chunk is not None:
            delta = (first_chunk.get("choices") or [{}])[0].get("delta") or {}
            if not (delta.get("role") and not delta.get("content")):
                if out := co.add(first_chunk, sse.encode_event(first_chunk)):
                    yield out
        async for chunk in rest:
            if out := co.add(chunk, sse.encode_event(chunk)):
                yield out
    except BackendError as e:
        if out := co.drain():
            yield out
        yield sse.encode_event(oai.error_chunk(f"Backend failed: {e}", model=model,
                                               code=e.code))
    if out := co.drain():
        yield out
    yield sse.encode_done()


async def _completions_stream(first_chunk: dict[str, Any] | None,
                              rest: AsyncIterator[dict[str, Any]],
                              model: str) -> AsyncIterator[bytes]:
    """Chat chunks as legacy ``text_completion`` SSE frames (``choices[].text``,
    no role or delta), an error frame on a failure mid-stream, ``[DONE]``
    last."""
    cid = f"cmpl-{uuid.uuid4().hex[:24]}"
    created = int(time.time())

    def frame(choices: list, **extra) -> bytes:
        return sse.encode_event({"id": cid, "object": "text_completion", "created": created,
                                 "model": model, "choices": choices, **extra})

    def encode(chunk: dict[str, Any]) -> bytes | None:
        choice = (chunk.get("choices") or [{}])[0]
        content = (choice.get("delta") or {}).get("content")
        finish = choice.get("finish_reason")
        if content or finish:
            return frame([{"index": 0, "text": content or "", "logprobs": None,
                           "finish_reason": finish}])
        if chunk.get("usage") is not None and not chunk.get("choices"):
            return frame([], usage=chunk["usage"])
        return None  # a role-only chunk has no legacy form

    co = _SSECoalescer()
    try:
        if first_chunk is not None:
            if out := co.add(first_chunk, encode(first_chunk)):
                yield out
        async for chunk in rest:
            if out := co.add(chunk, encode(chunk)):
                yield out
    except BackendError as e:
        if out := co.drain():
            yield out
        yield frame([{"index": 0, "text": f"Backend failed: {e}", "logprobs": None,
                      "finish_reason": "error"}])
    if out := co.drain():
        yield out
    yield sse.encode_done()


async def _single_stream(backend, body: dict[str, Any], headers: dict[str, str],
                         timeout: float) -> Response:
    """One backend's stream as the response; a failure before its first
    chunk is a JSON error, not a 200 stream."""
    model = body.get("model") or backend.model or "unknown"
    stream = backend.stream(body, headers, timeout)
    try:
        first_chunk = await stream.__anext__()
    except StopAsyncIteration:
        first_chunk = None
    except BackendError as e:
        return _relay_backend_error(e)
    return StreamingResponse(_stream_with_role(first_chunk, stream, model))


def _relayable(o) -> bool:
    """A failure whose status means something to the client: a 4xx, an
    overload (503) or a deadline (504)."""
    return o.error is not None and (400 <= o.error.status_code < 500
                                    or o.error.status_code in (503, 504))


def _validate_speculative_aggregation(cfg: Config, reg: BackendRegistry) -> None:
    """Boot-time check of ``speculative_aggregation: true`` (the JAX
    package's): spec_decode is an engine knob, not a per-request lever, so
    the opt-in is an assertion — the aggregator must be a local ``cuda://``
    backend whose engine runs speculation (``spec_decode=G``; the
    aggregation prompt quotes the members' answers, which is what prompt
    lookup drafts the aggregate from). Failing at boot beats aggregating
    unaccelerated."""
    if cfg.strategy_name != "aggregate" or not cfg.aggregate.speculative_aggregation:
        return
    p = cfg.aggregate
    agg = reg.get(p.aggregator_backend) if p.aggregator_backend else None
    if agg is None:
        raise ValueError("speculative_aggregation: true requires an aggregator_backend "
                         f"(got {p.aggregator_backend!r})")
    engine = getattr(agg, "engine", None)
    if engine is None:
        raise ValueError(
            f"speculative_aggregation: true requires a cuda:// aggregator (backend "
            f"{agg.name!r} is {type(agg).__name__}; an HTTP upstream's speculation "
            "cannot be asserted from here)")
    if int(getattr(engine, "spec_decode", 0) or 0) <= 0:
        raise ValueError(
            f"speculative_aggregation: true but aggregator {agg.name!r} runs no "
            "speculation (spec_decode=0). Add spec_decode=G (e.g. spec_decode=4) to its "
            "cuda:// URL — the aggregation prompt quotes the members' outputs, which is "
            "what prompt-lookup speculation drafts from.")


# Engine metrics exposed as gauges (the rest are counters); the JAX server's
# list, plus the port's graph pool bytes.
_ENGINE_GAUGES = frozenset({
    "slots", "members", "busy_slots", "admitting", "pending", "queue_limit",
    "decode_pipeline", "decode_loop", "inflight_chunks", "prefix_store_bytes",
    "prefix_store_entries", "breaker_state", "kv_pages", "kv_page_size",
    "kv_pages_allocated", "kv_pages_free", "decode_graph_pool_bytes", "draining", "qos",
    "zero_drain"})


def _distinct_engines(reg: BackendRegistry):
    """(backend name, engine) per DISTINCT engine: backends sharing an
    engine (``members=M&member=i``) count it once, and HTTP relays hold no
    local state."""
    seen: set[int] = set()
    for backend in reg.backends:
        engine = getattr(backend, "engine", None)
        if engine is None or id(engine) in seen:
            continue
        seen.add(id(engine))
        yield backend.name, engine


def _engine_health(reg: BackendRegistry) -> tuple[str, list[dict]]:
    """One check row per distinct engine. ``unhealthy``: a serving thread
    (scheduler, prefill scheduler, prefix-store snapshot worker) is dead,
    and only a restart recovers. ``degraded``: the breaker is not closed, the queue is full or
    the engine is draining — alive but shedding — or
    (``QUORUM_TPU_SLO_READY_BURN``) an SLO class burns past its
    threshold."""
    checks = []
    for name, engine in _distinct_engines(reg):
        row = engine.health()
        row["backend"] = name
        checks.append(row)
    status = "healthy"
    for row in checks:
        if (not row["scheduler_alive"] or not row.get("prefill_scheduler_alive", True)
                or not row["snapshot_worker_alive"]):
            return "unhealthy", checks
        if (row["breaker"] != "closed" or row["pending"] >= row["queue_limit"]
                or row.get("draining")):
            status = "degraded"
    if status == "healthy" and checks and slo_mod.burning_class() is not None:
        status = "degraded"
    return status, checks


def _metrics_lines(reg: BackendRegistry) -> list[str]:
    """The engines' ``quorum_tpu_engine_*`` families: one snapshot per
    distinct engine, each family's TYPE line once with its samples grouped.
    A per-member list is one sample per member."""
    snapshots = [(name, engine.metrics()) for name, engine in _distinct_engines(reg)]
    lines: list[str] = []
    if not snapshots:
        return lines
    for key in snapshots[0][1]:
        lines.append(f"# TYPE quorum_tpu_engine_{key} "
                     f"{'gauge' if key in _ENGINE_GAUGES else 'counter'}")
        for name, m in snapshots:
            val = m[key]
            if isinstance(val, list):
                lines.extend(f'quorum_tpu_engine_{key}{{backend="{name}",member="{i}"}} {v}'
                             for i, v in enumerate(val))
            else:
                lines.append(f'quorum_tpu_engine_{key}{{backend="{name}"}} {val}')
    return lines


def create_app(config: Config | None = None, registry: BackendRegistry | None = None,
               watch_config: bool | None = None, **backend_overrides) -> App:
    """Build the ASGI application. Tests inject backends via
    ``backend_overrides`` (name → backend) or a ready ``registry``. Raises
    ValueError for a config the app must refuse at boot.

    ``watch_config`` (default: ``QUORUM_TPU_CONFIG_WATCH=1``) turns on hot
    reload of a file-backed config (``server/reload.py``): each request
    checks the file (rate-limited) and an edit swaps in a rebuilt registry
    that keeps every untouched backend and releases the dropped engines."""
    cfg = config if config is not None else load_config()
    reg = registry if registry is not None else build_registry(cfg, **backend_overrides)
    _validate_speculative_aggregation(cfg, reg)
    rt = Runtime(cfg, reg)
    if watch_config is None:
        watch_config = os.environ.get("QUORUM_TPU_CONFIG_WATCH", "") == "1"
    watcher = (ConfigWatcher(cfg.source_path, rt, backend_overrides)
               if watch_config and cfg.source_path is not None and registry is None else None)
    app = App()
    app.state["runtime"] = rt
    app.state["config"] = cfg
    app.state["registry"] = reg
    started = time.monotonic()

    async def current() -> tuple[Config, BackendRegistry]:
        """The live (config, registry) pair, after a reload when watching."""
        if watcher is not None:
            await watcher.poll()
            app.state["config"], app.state["registry"] = rt.cfg, rt.reg
        return rt.cfg, rt.reg

    @app.route("GET", "/health", "/v1/health")
    async def health(request: Request) -> Response:
        """``healthy`` / ``degraded`` (200: the process serves, perhaps
        shedding) / ``unhealthy`` (503: rotate it out). With no engine the
        body is the bare ``{"status": "healthy"}``."""
        _, reg = await current()
        status, checks = _engine_health(reg)
        body: dict[str, Any] = {"status": status}
        if checks:
            body["checks"] = checks
            body["slo"] = slo_mod.SLO.snapshot()
        if status == "unhealthy":
            return JSONResponse(body, status_code=503, headers={"Retry-After": "5"})
        return JSONResponse(body)

    @app.route("GET", "/ready", "/v1/ready")
    async def ready(request: Request) -> Response:
        """200 only while new work would be admitted: a dead serving thread,
        a breaker not closed or a full queue is a 503 with Retry-After."""
        _, reg = await current()
        status, checks = _engine_health(reg)
        if status == "healthy":
            return JSONResponse({"status": "ready"})
        return JSONResponse({"status": "unready", "reason": status,
                             **({"checks": checks} if checks else {})},
                            status_code=503, headers={"Retry-After": "5"})

    @app.route("GET", "/models", "/v1/models")
    async def models(request: Request) -> Response:
        _, reg = await current()
        owners: dict[str, list[str]] = {}
        for b in reg.backends:
            mid = getattr(b, "model", "") or getattr(b, "model_id", "")
            if mid:
                owners.setdefault(mid, []).append(b.name)
        data = [{"id": mid, "object": "model", "created": 0, "owned_by": ",".join(names)}
                for mid, names in sorted(owners.items())]
        return JSONResponse({"object": "list", "data": data})

    @app.route("GET", "/metrics", "/v1/metrics")
    async def metrics(request: Request) -> Response:
        """Prometheus text: uptime, each distinct engine's counters and
        gauges, then the registered families. Host counters only: a scrape
        never syncs the device."""
        _, reg = await current()
        lines = ["# TYPE quorum_tpu_uptime_seconds gauge",
                 f"quorum_tpu_uptime_seconds {time.monotonic() - started:.3f}"]
        lines.extend(_metrics_lines(reg))
        FLIGHT_RECORDER_EVENTS.set(RECORDER.depth())
        lines.extend(METRICS.expose())
        return Response(("\n".join(lines) + "\n").encode(),
                        media_type="text/plain; version=0.0.4")

    @app.route("GET", "/debug/traces", "/v1/debug/traces")
    async def debug_traces(request: Request) -> Response:
        """The in-flight traces and the ring of completed ones (summaries)."""
        return JSONResponse(TRACES.snapshot())

    @app.route("GET", "/debug/traces/{request_id}", "/v1/debug/traces/{request_id}")
    async def debug_trace_one(request: Request) -> Response:
        trace = TRACES.get(request.path_params["request_id"])
        if trace is None:
            return _error("trace not found (expired from the ring buffer, or the id was "
                          "never traced)", "invalid_request_error", 404)
        return JSONResponse(trace.to_dict())

    @app.route("GET", "/debug/engine/timeline", "/v1/debug/engine/timeline")
    async def debug_timeline(request: Request) -> Response:
        """The flight recorder's ring; ``?format=perfetto`` is Chrome
        trace-event JSON (open it in ui.perfetto.dev). The JSON form adds
        each engine's per-family device-time statistics and the SLO
        snapshot."""
        _, reg = await current()
        fmt = request.query_params.get("format", "json")
        if fmt in ("perfetto", "trace", "chrome"):
            return JSONResponse({"displayTimeUnit": "ms",
                                 "traceEvents": RECORDER.to_trace_events()})
        if fmt != "json":
            return _error(f"unknown format {fmt!r} (json or perfetto)",
                          "invalid_request_error", 400)
        return JSONResponse({
            "clock": "perf_counter",
            "capacity": RECORDER.capacity,
            "recorded_total": RECORDER.total(),
            "events": RECORDER.snapshot(),
            "device_time": {name: engine.latency.snapshot()
                            for name, engine in _distinct_engines(reg)},
            "slo": slo_mod.SLO.snapshot(),
        })

    @app.route("GET", "/debug/telemetry", "/v1/debug/telemetry")
    async def debug_telemetry(request: Request) -> Response:
        """A compact host-side snapshot (no device sync): SLO burn, queue
        depth, breaker states, per-family latency, prefix-store bytes, the
        QoS block per distinct engine (``qos``, the cost model's EWMAs and
        shed counters, the pending queue by class) and a sample of this
        process's ``perf_counter`` clock."""
        _, reg = await current()
        status, checks = _engine_health(reg)
        store_bytes = 0
        sched = {}
        for name, engine in _distinct_engines(reg):
            if engine.prefix_store is not None:
                store_bytes += int(engine.prefix_store.bytes_held or 0)
            entry = dict(engine.cost_model.snapshot())
            entry["qos"] = bool(engine.qos)
            with engine._cond:
                entry["queue_depths"] = engine._policy.queue_depths(engine._pending)
            sched[name] = entry
        return JSONResponse({
            "clock": time.perf_counter(),
            "time": time.time(),
            "status": status,
            "slo": slo_mod.SLO.snapshot(),
            "queue_depth": sum(int(row.get("pending", 0) or 0) for row in checks),
            "breaker": {row["backend"]: row.get("breaker", "closed") for row in checks},
            "latency": {name: engine.latency.snapshot()
                        for name, engine in _distinct_engines(reg)},
            "prefix_store_bytes": store_bytes,
            "sched": sched,
        })

    @app.route("POST", "/debug/profile", "/v1/debug/profile")
    async def debug_profile(request: Request) -> Response:
        """A whole-process ``torch.profiler`` trace of the next N seconds
        (``?seconds=N``, default 1, in (0, 60]); returns the directory of
        its Chrome trace (``trace.json``). Single-flight: a second request
        meanwhile gets a 409 ``conflict_error``."""
        raw = request.query_params.get("seconds", "1")
        try:
            seconds = float(raw)
        except ValueError:
            seconds = -1.0
        if not 0.0 < seconds <= 60.0:
            return _error(f"'seconds' must be a number in (0, 60], got {raw!r}",
                          "invalid_request_error", 400)
        prepare_profiler()  # here, on the loop's thread: see its docstring
        try:
            out_dir = await asyncio.to_thread(profile_process, seconds)
        except ProfilerBusy:
            return _error("profiler busy: another profile (on-demand or per-request) is in "
                          "flight", "conflict_error", 409, headers={"Retry-After": "5"})
        except Exception as e:
            return _error(f"profiling failed: {e}", "proxy_error", 500)
        return JSONResponse({"profile_dir": out_dir, "seconds": seconds})

    def _store_engine(reg: BackendRegistry, name: str | None):
        """The engine whose host prefix store the chunk routes serve:
        ``?backend=`` by name, else the first with a store."""
        rows = [(n, e) for n, e in _distinct_engines(reg)
                if e.prefix_store is not None and (not name or n == name)]
        return rows[0] if rows else (None, None)

    def _no_store() -> JSONResponse:
        return _error("no engine with a host prefix store (prefix_store=host) is configured",
                      "invalid_request_error", 404)

    @app.route("GET", "/debug/prefix/chunks", "/v1/debug/prefix/chunks")
    async def prefix_chunks_export(request: Request) -> Response:
        """The store's restorable chunk chains in the migration wire format
        (``cache/prefix_wire.py``); ``?max_bytes=`` bounds the export."""
        _, reg = await current()
        name, engine = _store_engine(reg, request.query_params.get("backend"))
        if engine is None:
            return _no_store()
        raw_max = request.query_params.get("max_bytes")
        max_bytes = None
        if raw_max is not None:
            # A caller who asked for a bound gets one: a bad value is a 400,
            # never a silent full export.
            try:
                max_bytes = int(raw_max)
            except ValueError:
                max_bytes = -1
            if max_bytes < 1:
                return _error(f"'max_bytes' must be a positive integer, got {raw_max!r}",
                              "invalid_request_error", 400)
        blob = await asyncio.to_thread(engine.export_prefix_chunks, max_bytes)
        return Response(blob, media_type="application/octet-stream",
                        headers={"X-Prefix-Chunk-Tokens": str(engine.prefix_store.chunk_tokens),
                                 "X-Prefix-Backend": name})

    @app.route("PUT", "/debug/prefix/chunks", "/v1/debug/prefix/chunks")
    async def prefix_chunks_import(request: Request) -> Response:
        """Seed the store from a peer's export, validated against this
        engine's cache layout: a mismatched blob is a 400."""
        _, reg = await current()
        name, engine = _store_engine(reg, request.query_params.get("backend"))
        if engine is None:
            return _no_store()
        blob = await request.body()
        try:
            stats = await asyncio.to_thread(engine.import_prefix_chunks, blob)
        except ValueError as e:
            return _error(f"prefix-chunk import rejected: {e}", "invalid_request_error", 400)
        stats["backend"] = name
        return JSONResponse(stats)

    @app.route("POST", "/admin/drain", "/v1/admin/drain")
    async def admin_drain(request: Request) -> Response:
        """Begin a graceful drain of every distinct engine: new work sheds
        with a retryable 503 and ``/ready`` answers 503, residents finish;
        ``?park=1`` parks them instead (streams end ``"parked"``, a
        non-streamed request gets a 503). Idempotent; per-engine status."""
        _, reg = await current()
        park = request.query_params.get("park", "0") not in ("0", "", None)
        rows = []
        for name, engine in _distinct_engines(reg):
            row = await asyncio.to_thread(engine.drain, park)
            row["backend"] = name
            rows.append(row)
        if not rows:
            return _error("no engine-backed backend to drain", "invalid_request_error", 404)
        return JSONResponse({"draining": True, "engines": rows})

    @app.route("GET", "/admin/drain", "/v1/admin/drain")
    async def admin_drain_status(request: Request) -> Response:
        """Drain progress: ``resident`` sums every engine's attached
        streams (active, admitting, queued); 0 means the process holds no
        client state."""
        _, reg = await current()
        rows = []
        for name, engine in _distinct_engines(reg):
            row = engine.drain_status()
            row["backend"] = name
            rows.append(row)
        return JSONResponse({"draining": any(r["draining"] for r in rows),
                             "resident": sum(r["resident"] for r in rows), "engines": rows})

    @app.route("POST", "/admin/undrain", "/v1/admin/undrain")
    async def admin_undrain(request: Request) -> Response:
        """Reopen admissions after a drain; idempotent."""
        _, reg = await current()
        rows = []
        for name, engine in _distinct_engines(reg):
            row = engine.undrain()
            row["backend"] = name
            rows.append(row)
        return JSONResponse({"draining": False, "engines": rows})

    @app.route("POST", "/chat/completions", "/v1/chat/completions")
    async def chat_completions(request: Request) -> Response:
        return await _traced(request, _chat_impl)

    @app.route("POST", "/embeddings", "/v1/embeddings")
    async def embeddings(request: Request) -> Response:
        return await _traced(request, _embeddings_impl)

    @app.route("POST", "/completions", "/v1/completions")
    async def completions(request: Request) -> Response:
        return await _traced(request, _completions_impl)

    async def _traced(request: Request, impl) -> Response:
        """Request id, trace and profiler scope around a POST route's
        ``impl(request, trace)``. The trace id comes from a valid W3C
        ``traceparent`` (the header, else the body knob), or this server
        mints one; the response echoes ``X-Request-Id`` and
        ``traceparent``. A stream's scope closes when its iterator ends,
        after the device work the ASGI server drives."""
        rid = f"req-{uuid.uuid4().hex[:16]}"
        parsed = tracecontext.parse_traceparent(request.headers.get("traceparent"))
        if parsed is None:
            with contextlib.suppress(Exception):
                raw = await request.json()
                if isinstance(raw, dict):
                    parsed = tracecontext.parse_traceparent(raw.get("traceparent"))
        if parsed is not None:
            trace_id = parsed[0]
            TRACE_PROPAGATED.inc(source="client")
        else:
            trace_id = tracecontext.new_trace_id()
            TRACE_PROPAGATED.inc(source="server")
        span_id = tracecontext.new_span_id()
        trace = TRACES.start(RequestTrace(rid, trace_id=trace_id, span_id=span_id))
        scope = contextlib.ExitStack()
        scope.enter_context(maybe_profile(rid))
        try:
            with use_trace(trace):
                response = await impl(request, trace)
        except (asyncio.CancelledError, GeneratorExit):
            scope.close()
            finish_request_trace(trace, status=499)  # the client went away
            raise
        except BaseException:
            scope.close()
            finish_request_trace(trace, status=500)
            raise
        response.headers.setdefault("X-Request-Id", rid)
        response.headers.setdefault("traceparent",
                                    tracecontext.format_traceparent(trace_id, span_id))
        if isinstance(response, StreamingResponse):
            response.iterator = _finish_scope_after(
                sse.instrument_stream(response.iterator, trace), scope, trace,
                response.status_code)
        else:
            scope.close()
            finish_request_trace(trace, status=response.status_code, mode="complete")
        return response

    async def _finish_scope_after(iterator: AsyncIterator[bytes], scope: contextlib.ExitStack,
                                  trace: RequestTrace, status: int) -> AsyncIterator[bytes]:
        try:
            async for chunk in iterator:
                yield chunk
        except (GeneratorExit, asyncio.CancelledError):
            status = 499
            raise
        finally:
            scope.close()
            finish_request_trace(trace, status=status, mode="stream")

    async def _chat_impl(request: Request, trace: RequestTrace) -> Response:
        cfg, reg = await current()
        try:
            body = await request.json()
            if not isinstance(body, dict):
                raise ValueError("request body must be a JSON object")
        except ValueError as e:
            return _error(f"Invalid JSON body: {e}", "invalid_request_error", 400)
        # The /completions raw-prompt plan field, never accepted from the
        # wire: it would bypass the chat template.
        body.pop("_raw_prompt_ids", None)
        headers = _resolve_headers(request.headers)
        if headers is None:
            return _auth_error()
        invalid = oai.validate_request_body(body)
        if invalid is not None:
            return _error(invalid, "invalid_request_error", 400)
        if len(reg) == 0:
            return _error("No valid backends configured", "configuration_error", 500)
        body.pop("traceparent", None)  # a carrier only, never forwarded
        if (body.pop("quorum", None) or 1) > 1:
            return _error("'quorum' requires the router tier: this server is a single cell "
                          "and cannot fan out across replicas", "invalid_request_error", 400)
        is_streaming = bool(body.get("stream", False))
        is_parallel = cfg.parallel_enabled(len(reg))
        # The request's budget bounds the whole chain: the aggregation hop
        # gets what the fan-out left of it.
        timeout = float(body.pop("timeout", None) or cfg.timeout)
        deadline = time.monotonic() + timeout
        trace.meta["slo"] = slo_mod.classify(timeout)
        # The aggregate strategy fans out to source_backends only; the model
        # check looks at the actual targets.
        if is_parallel and cfg.strategy_name == "aggregate":
            targets = reg.select(cfg.aggregate.source_backends)
            if not targets:
                return _error("source_backends matches no configured backend",
                              "configuration_error", 500)
        else:
            targets = reg.backends
        if "model" not in body and not any(b.model for b in targets):
            return _error("Model must be specified when config.yaml model is blank",
                          "invalid_request_error", 400)
        trace.meta["mode"] = (("parallel-" if is_parallel else "single-")
                              + ("stream" if is_streaming else "complete"))
        trace.meta["backends"] = [b.name for b in targets]

        if is_streaming:
            if is_parallel:
                plan = StreamPlan.from_config(cfg, reg, body)
                return StreamingResponse(parallel_stream(plan, body, headers, timeout,
                                                         trace=trace))
            return await _single_stream(targets[0], body, headers, timeout)

        with trace.span("fanout", backends=len(targets)):
            outcomes = await fanout_complete(targets, body, headers, timeout)
        successes = [o for o in outcomes if o.ok]
        if not successes:
            if all(_relayable(o) for o in outcomes):
                first_err = outcomes[0].error
                return JSONResponse(first_err.body, status_code=first_err.status_code,
                                    headers=first_err.headers)
            return _error(f"All backends failed. First error: {outcomes[0].error_message}",
                          "proxy_error", 500)
        if is_parallel:
            with trace.span("aggregate", strategy=cfg.strategy_name):
                combined, agg_outcome = await combine_outcomes(
                    cfg, reg, outcomes, body, headers,
                    aggregator_timeout=max(0.001, deadline - time.monotonic()))
            return JSONResponse(combined, headers=degraded_headers(agg_outcome))
        result = successes[0].result
        resp_headers = {k: v for k, v in result.headers.items()
                        if k.lower() not in _PASSTHROUGH_SKIP}
        return JSONResponse(result.body, status_code=result.status_code, headers=resp_headers)

    async def _single_backend_request(request: Request, capability: str, what: str):
        """The no-fan-out routes' preamble: parse and authorize, drop the
        internal ``_raw_prompt_ids``, and pick the one target — the backend
        whose configured model is the request's; with no model in the
        request, the first backend with ``capability``; a requested model
        none of them is pinned to falls to a blank-model one (only an
        http(s):// relay is blank: it forwards the name upstream), else a
        404 ``model_not_found``. Returns ``(cfg, body, headers, target)`` or
        an error response."""
        cfg, reg = await current()
        try:
            body = await request.json()
            if not isinstance(body, dict):
                raise ValueError("request body must be a JSON object")
        except ValueError as e:
            return _error(f"Invalid JSON body: {e}", "invalid_request_error", 400)
        body.pop("_raw_prompt_ids", None)
        body.pop("traceparent", None)  # a carrier only, never forwarded
        headers = _resolve_headers(request.headers)
        if headers is None:
            return _auth_error()
        candidates = [b for b in reg.backends if hasattr(b, capability)]
        if not candidates:
            return _error(f"No backend supports {what}", "configuration_error", 500)
        req_model = body.get("model")
        target = next((b for b in candidates if req_model and b.model == req_model), None)
        if target is None and req_model:
            target = next((b for b in candidates if not b.model), None)
            if target is None:
                return JSONResponse({"error": {
                    "message": f"The model '{req_model}' does not exist or is not served "
                               f"by any backend with {what} support",
                    "type": "invalid_request_error", "param": "model",
                    "code": "model_not_found"}}, status_code=404)
        return cfg, body, headers, target or candidates[0]

    async def _embeddings_impl(request: Request, trace: RequestTrace) -> Response:
        got = await _single_backend_request(request, "embed", "embeddings")
        if isinstance(got, Response):
            return got
        cfg, body, headers, target = got
        trace.meta["mode"], trace.meta["backends"] = "embeddings", [target.name]
        try:
            result = await target.embed(body, headers, cfg.timeout)
        except BackendError as e:
            return _relay_backend_error(e)
        return JSONResponse(result.body, status_code=result.status_code)

    async def _completions_impl(request: Request, trace: RequestTrace) -> Response:
        got = await _single_backend_request(request, "text_complete", "/completions")
        if isinstance(got, Response):
            return got
        cfg, body, headers, target = got
        stream = bool(body.get("stream"))
        trace.meta["mode"] = "completions-" + ("stream" if stream else "complete")
        trace.meta["backends"] = [target.name]
        if stream:
            if not hasattr(target, "plan_text_stream"):
                return _error("streaming /completions is only served by cuda:// backends",
                              "invalid_request_error", 400)
            try:
                sbody, model = target.plan_text_stream(body)
            except BackendError as e:
                return _relay_backend_error(e)
            chunks = target.stream(sbody, headers, cfg.timeout)
            try:
                first_chunk = await chunks.__anext__()
            except StopAsyncIteration:
                first_chunk = None
            except BackendError as e:
                return _relay_backend_error(e)
            return StreamingResponse(_completions_stream(first_chunk, chunks, model))
        try:
            result = await target.text_complete(body, headers, cfg.timeout)
        except BackendError as e:
            return _relay_backend_error(e)
        return JSONResponse(result.body, status_code=result.status_code)

    return app
