"""The OpenAI-compatible application.

  POST /chat/completions, /v1/chat/completions   streamed (SSE) or not
  GET  /health, /v1/health                       engine liveness
  GET  /models, /v1/models                       configured model ids

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
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, AsyncIterator

from quorum_tpu_torch import oai, sse
from quorum_tpu_torch.backends.base import BackendError
from quorum_tpu_torch.backends.registry import BackendRegistry, build_registry
from quorum_tpu_torch.config import Config, load_config
from quorum_tpu_torch.server.asgi import App, JSONResponse, Request, Response, StreamingResponse
from quorum_tpu_torch.strategies.combine import combine_outcomes, degraded_headers
from quorum_tpu_torch.strategies.fanout import fanout_complete
from quorum_tpu_torch.strategies.streaming import StreamPlan, parallel_stream

logger = logging.getLogger(__name__)

_PASSTHROUGH_SKIP = {"content-length", "content-type", "transfer-encoding",
                     "content-encoding", "connection"}


def _error(message: str, type_: str, status: int, headers=None) -> JSONResponse:
    return JSONResponse({"error": {"message": message, "type": type_}}, status_code=status,
                        headers=headers)


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
    buf: list[bytes] = []

    def add(chunk) -> bytes:
        buf.append(sse.encode_event(chunk))
        if oai.has_more(chunk):
            return b""
        out = b"".join(buf)
        buf.clear()
        return out

    try:
        if first_chunk is not None:
            delta = (first_chunk.get("choices") or [{}])[0].get("delta") or {}
            if not (delta.get("role") and not delta.get("content")):
                if out := add(first_chunk):
                    yield out
        async for chunk in rest:
            if out := add(chunk):
                yield out
    except BackendError as e:
        if buf:
            yield b"".join(buf)
            buf.clear()
        yield sse.encode_event(oai.error_chunk(f"Backend failed: {e}", model=model))
    if buf:
        yield b"".join(buf)
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


def create_app(config: Config | None = None, registry: BackendRegistry | None = None,
               **backend_overrides) -> App:
    """Build the ASGI application. Tests inject backends via
    ``backend_overrides`` (name → backend) or a ready ``registry``. Raises
    ValueError for a config the app must refuse at boot."""
    cfg = config if config is not None else load_config()
    reg = registry if registry is not None else build_registry(cfg, **backend_overrides)
    _validate_speculative_aggregation(cfg, reg)
    app = App()
    app.state["config"] = cfg
    app.state["registry"] = reg

    @app.route("GET", "/health", "/v1/health")
    async def health(request: Request) -> Response:
        checks = []
        for b in reg.backends:
            engine = getattr(b, "engine", None)
            if engine is not None:
                checks.append({"backend": b.name, **engine.health()})
        alive = all(c["scheduler_alive"] for c in checks)
        status = "healthy" if alive else "unhealthy"
        body: dict[str, Any] = {"status": status}
        if checks:
            body["checks"] = checks
        return JSONResponse(body, status_code=200 if alive else 503)

    @app.route("GET", "/models", "/v1/models")
    async def models(request: Request) -> Response:
        owners: dict[str, list[str]] = {}
        for b in reg.backends:
            mid = getattr(b, "model", "") or getattr(b, "model_id", "")
            if mid:
                owners.setdefault(mid, []).append(b.name)
        data = [{"id": mid, "object": "model", "created": 0, "owned_by": ",".join(names)}
                for mid, names in sorted(owners.items())]
        return JSONResponse({"object": "list", "data": data})

    @app.route("POST", "/chat/completions", "/v1/chat/completions")
    async def chat_completions(request: Request) -> Response:
        try:
            body = await request.json()
            if not isinstance(body, dict):
                raise ValueError("request body must be a JSON object")
        except ValueError as e:
            return _error(f"Invalid JSON body: {e}", "invalid_request_error", 400)
        headers = _resolve_headers(request.headers)
        if headers is None:
            return _error("Authorization header is required and OPENAI_API_KEY "
                          "environment variable is not set", "auth_error", 401)
        invalid = oai.validate_request_body(body)
        if invalid is not None:
            return _error(invalid, "invalid_request_error", 400)
        if len(reg) == 0:
            return _error("No valid backends configured", "configuration_error", 500)
        if (body.pop("quorum", None) or 1) > 1:
            return _error("'quorum' requires the router tier: this server is a single cell "
                          "and cannot fan out across replicas", "invalid_request_error", 400)
        is_streaming = bool(body.get("stream", False))
        is_parallel = cfg.parallel_enabled(len(reg))
        # The request's budget bounds the whole chain: the aggregation hop
        # gets what the fan-out left of it.
        timeout = float(body.pop("timeout", None) or cfg.timeout)
        deadline = time.monotonic() + timeout
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

        if is_streaming:
            if is_parallel:
                plan = StreamPlan.from_config(cfg, reg, body)
                return StreamingResponse(parallel_stream(plan, body, headers, timeout))
            return await _single_stream(targets[0], body, headers, timeout)

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
            combined, agg_outcome = await combine_outcomes(
                cfg, reg, outcomes, body, headers,
                aggregator_timeout=max(0.001, deadline - time.monotonic()))
            return JSONResponse(combined, headers=degraded_headers(agg_outcome))
        result = successes[0].result
        resp_headers = {k: v for k, v in result.headers.items()
                        if k.lower() not in _PASSTHROUGH_SKIP}
        return JSONResponse(result.body, status_code=result.status_code, headers=resp_headers)

    return app
