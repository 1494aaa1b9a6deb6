"""Minimal ASGI toolkit: Request, Response types and a method+path router —
exactly what the API needs (JSON bodies, JSON responses, SSE streaming).
The app is a standard ASGI3 callable: it runs under the bundled h11 server
(server/serve.py), any ASGI server, or a test calling it directly."""

from __future__ import annotations

import json
import logging
import uuid
from typing import Any, AsyncIterator, Awaitable, Callable

logger = logging.getLogger(__name__)


class Request:
    def __init__(self, scope: dict[str, Any], receive: Callable):
        self.scope = scope
        self._receive = receive
        self._body: bytes | None = None
        # Filled by the router for routes registered with a trailing
        # ``/{param}`` segment (``/debug/traces/{request_id}``).
        self.path_params: dict[str, str] = {}

    @property
    def method(self) -> str:
        return self.scope["method"].upper()

    @property
    def path(self) -> str:
        return self.scope["path"]

    @property
    def query_params(self) -> dict[str, str]:
        """Decoded query-string parameters (the last value wins); routes
        match on ``path`` alone, so ``?seconds=5`` knobs read from here."""
        from urllib.parse import parse_qsl

        raw = self.scope.get("query_string", b"") or b""
        return dict(parse_qsl(raw.decode("latin-1"), keep_blank_values=True))

    @property
    def headers(self) -> dict[str, str]:
        return {k.decode("latin-1"): v.decode("latin-1")
                for k, v in self.scope.get("headers", [])}

    async def body(self) -> bytes:
        if self._body is None:
            chunks = []
            while True:
                message = await self._receive()
                chunks.append(message.get("body", b""))
                if not message.get("more_body"):
                    break
            self._body = b"".join(chunks)
        return self._body

    async def json(self) -> Any:
        return json.loads(await self.body())


class Response:
    media_type = "application/octet-stream"

    def __init__(self, content: bytes | str = b"", status_code: int = 200,
                 headers: dict[str, str] | None = None, media_type: str | None = None):
        self.body = content.encode() if isinstance(content, str) else content
        self.status_code = status_code
        self.headers = dict(headers or {})
        if media_type is not None:
            self.media_type = media_type

    def _header_list(self, extra: dict[str, str]) -> list[tuple[bytes, bytes]]:
        merged = {**extra, **self.headers}
        merged.setdefault("content-type", self.media_type)
        return [(k.encode("latin-1"), v.encode("latin-1")) for k, v in merged.items()]

    async def __call__(self, scope, receive, send) -> None:
        await send({"type": "http.response.start", "status": self.status_code,
                    "headers": self._header_list({"content-length": str(len(self.body))})})
        await send({"type": "http.response.body", "body": self.body})


class JSONResponse(Response):
    media_type = "application/json"

    def __init__(self, content: Any, status_code: int = 200,
                 headers: dict[str, str] | None = None):
        super().__init__(json.dumps(content), status_code, headers)


class StreamingResponse(Response):
    """Streams an async byte iterator; used for SSE (``text/event-stream``)."""

    media_type = "text/event-stream"

    def __init__(self, iterator: AsyncIterator[bytes], status_code: int = 200,
                 headers: dict[str, str] | None = None):
        super().__init__(b"", status_code, headers)
        self.iterator = iterator

    async def __call__(self, scope, receive, send) -> None:
        await send({"type": "http.response.start", "status": self.status_code,
                    "headers": self._header_list({"cache-control": "no-cache"})})
        try:
            async for chunk in self.iterator:
                if chunk:
                    await send({"type": "http.response.body", "body": chunk,
                                "more_body": True})
        finally:
            # A client disconnect surfaces as send() raising: close the
            # iterator now so its finally blocks (backend cancellation) run.
            aclose = getattr(self.iterator, "aclose", None)
            if aclose is not None:
                try:
                    await aclose()
                except Exception:
                    logger.debug("stream iterator close failed", exc_info=True)
            try:
                await send({"type": "http.response.body", "body": b""})
            except Exception:
                logger.debug("peer gone before the end of the stream", exc_info=True)


Handler = Callable[[Request], Awaitable[Response]]


class App:
    """Method+path router implementing the ASGI3 interface."""

    def __init__(self) -> None:
        self._routes: dict[tuple[str, str], Handler] = {}
        # (method, prefix, param name, handler) of ``.../{param}`` routes:
        # matched when the exact table misses and the rest of the path after
        # the prefix is one non-empty segment.
        self._param_routes: list[tuple[str, str, str, Handler]] = []
        self.state: dict[str, Any] = {}

    def route(self, method: str, *paths: str) -> Callable[[Handler], Handler]:
        def register(handler: Handler) -> Handler:
            for p in paths:
                if p.endswith("}") and "/{" in p:
                    prefix, _, param = p.rpartition("/")
                    self._param_routes.append((method.upper(), prefix + "/", param[1:-1],
                                               handler))
                else:
                    self._routes[(method.upper(), p)] = handler
            return handler

        return register

    @staticmethod
    def _tail_segment(path: str, prefix: str) -> str | None:
        """The one non-empty segment after ``prefix``, or None: the single
        matching rule of dispatch and of the 405-versus-404 decision."""
        if not path.startswith(prefix):
            return None
        rest = path[len(prefix):]
        return rest if rest and "/" not in rest else None

    def _match_param_route(self, request: Request) -> Handler | None:
        for method, prefix, param, handler in self._param_routes:
            if method != request.method:
                continue
            rest = self._tail_segment(request.path, prefix)
            if rest is not None:
                request.path_params[param] = rest
                return handler
        return None

    async def __call__(self, scope, receive, send) -> None:
        if scope["type"] == "lifespan":
            while True:
                message = await receive()
                if message["type"] == "lifespan.startup":
                    await send({"type": "lifespan.startup.complete"})
                elif message["type"] == "lifespan.shutdown":
                    await send({"type": "lifespan.shutdown.complete"})
                    return
        if scope["type"] != "http":
            return
        request = Request(scope, receive)
        handler = (self._routes.get((request.method, request.path))
                   or self._match_param_route(request))
        if handler is None:
            # A path known under another method is a 405, a param route's
            # included (POST /debug/traces/abc, like POST /metrics).
            known = (request.path in {p for (_, p) in self._routes}
                     or any(self._tail_segment(request.path, prefix) is not None
                            for (_, prefix, _, _) in self._param_routes))
            response: Response = JSONResponse(
                {"error": {"message": "Method not allowed" if known else "Not found",
                           "type": "invalid_request_error"}},
                status_code=405 if known else 404)
        else:
            try:
                response = await handler(request)
            except Exception as e:  # last-resort normalization
                logger.exception("Unhandled error in %s %s", request.method, request.path)
                response = JSONResponse(
                    {"error": {"message": f"Error processing request: {e}",
                               "type": "proxy_error"}}, status_code=500)
        response.headers.setdefault("X-Request-Id", f"req-{uuid.uuid4().hex[:16]}")
        await response(scope, receive, send)
