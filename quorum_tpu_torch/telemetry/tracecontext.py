"""W3C trace-context helpers: one trace-id names a request across tiers.

A caller (a router, a client) may send a ``traceparent`` header
(https://www.w3.org/TR/trace-context/: version ``00``, a 32-hex trace-id, a
16-hex span-id for the sending hop, a 2-hex flags byte). The server threads
the trace-id through its :class:`~quorum_tpu_torch.observability.RequestTrace`
and uses it as the flight-recorder ``rid``, and the engine's dispatch and
reap events inherit it through the trace, so request spans and the engine's
device timeline join on one id. Pure stdlib.
"""

from __future__ import annotations

import re
import uuid

# traceparent: version "00" only (the one defined version); trace-id and
# span-id must be non-zero per spec.
_TRACEPARENT_RE = re.compile(
    r"^00-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")


def new_trace_id() -> str:
    """A fresh 32-hex trace-id (uuid4 randomness; never all-zero)."""
    return uuid.uuid4().hex


def new_span_id() -> str:
    """A fresh 16-hex span-id for one hop."""
    return uuid.uuid4().hex[:16]


def format_traceparent(trace_id: str, span_id: str,
                       flags: str = "01") -> str:
    """The wire form: ``00-<trace-id>-<span-id>-<flags>``."""
    return f"00-{trace_id}-{span_id}-{flags}"


def parse_traceparent(value: str | None) -> tuple[str, str] | None:
    """``(trace_id, span_id)`` from a traceparent header, or None when the
    value is absent or malformed (unknown versions and zero ids are
    rejected — a caller falls back to minting, never to trusting junk)."""
    if not value or not isinstance(value, str):
        return None
    m = _TRACEPARENT_RE.match(value.strip().lower())
    if m is None:
        return None
    trace_id, span_id = m.group(1), m.group(2)
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id


def child_traceparent(trace_id: str) -> tuple[str, str]:
    """``(span_id, header)`` for a new hop inside ``trace_id`` — same
    trace, fresh span (what the router stamps per replica attempt)."""
    span_id = new_span_id()
    return span_id, format_traceparent(trace_id, span_id)
