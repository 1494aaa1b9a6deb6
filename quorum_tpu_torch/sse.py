"""Server-Sent Events wire format: each event is one ``data: <json>`` line
and a blank line; a stream ends with ``data: [DONE]``. The server encodes
events; the HTTP relay parses an upstream's byte stream with
:class:`SSEParser`."""

from __future__ import annotations

import json
from typing import Any, AsyncIterator, Iterator

DONE = "[DONE]"


def encode_event(payload: dict[str, Any] | str) -> bytes:
    """Encode one SSE ``data:`` event (JSON dict or raw sentinel string)."""
    if isinstance(payload, str):
        return f"data: {payload}\n\n".encode()
    return f"data: {json.dumps(payload, separators=(',', ':'))}\n\n".encode()


def encode_done() -> bytes:
    return encode_event(DONE)


async def instrument_stream(iterator: AsyncIterator[bytes], trace) -> AsyncIterator[bytes]:
    """Pass SSE bytes through, marking every flush on the request's trace
    (``RequestTrace.mark_flush``): TTFT and inter-token gaps measured at the
    last point before the ASGI send, detokenization and JSON encoding
    included. A flush counts its content-bearing ``data:`` frames (a
    coalesced write carries several; role chunks and ``[DONE]`` carry none),
    and an ``sse-flush`` span covers the first to the last write."""
    if trace is None:
        async for chunk in iterator:
            yield chunk
        return
    span = None
    try:
        async for chunk in iterator:
            if span is None:
                span = trace.add_span("sse-flush", trace.now())
            # Every frame is encode_event's compact JSON, so a non-empty
            # content delta serializes with text after '"content":"'.
            n_content = sum(1 for frame in chunk.split(b"\n\n")
                            if (b'"content":' in frame and b'"content":""' not in frame
                                and b'"content":null' not in frame))
            trace.mark_flush(n_content)
            yield chunk
    finally:
        if span is not None:
            span.end = trace.now()


class SSEParser:
    """Incremental parser: feed raw bytes, get the decoded ``data:``
    payloads back. Events may be split at any byte; ``\n\n`` and
    ``\r\n\r\n`` both end one. JSON payloads come back as dicts,
    ``[DONE]`` and non-JSON data as strings."""

    def __init__(self) -> None:
        self._buf = b""

    def feed(self, chunk: bytes) -> Iterator[dict[str, Any] | str]:
        self._buf += chunk
        while True:
            idx_n = self._buf.find(b"\n\n")
            idx_r = self._buf.find(b"\r\n\r\n")
            if idx_n == -1 and idx_r == -1:
                return
            if idx_r != -1 and (idx_n == -1 or idx_r < idx_n):
                raw, self._buf = self._buf[:idx_r], self._buf[idx_r + 4:]
            else:
                raw, self._buf = self._buf[:idx_n], self._buf[idx_n + 2:]
            payload = self._parse_event(raw)
            if payload is not None:
                yield payload

    def flush(self) -> Iterator[dict[str, Any] | str]:
        """Parse a trailing event that no blank line ended."""
        if self._buf.strip():
            payload = self._parse_event(self._buf)
            if payload is not None:
                yield payload
        self._buf = b""

    @staticmethod
    def _parse_event(raw: bytes) -> dict[str, Any] | str | None:
        lines = [ln.strip()[5:].strip() for ln in raw.splitlines()
                 if ln.strip().startswith(b"data:")]
        if not lines:
            return None
        data = b"\n".join(lines).decode("utf-8", errors="replace")
        if data == DONE:
            return DONE
        try:
            return json.loads(data)
        except json.JSONDecodeError:
            return data


def iter_data_events(body: bytes) -> Iterator[dict[str, Any] | str]:
    """Parse a complete SSE body: JSON payloads as dicts, ``[DONE]`` and
    non-JSON data as strings."""
    parser = SSEParser()
    yield from parser.feed(body)
    yield from parser.flush()
