"""The backend protocol and the error and result types its implementations
share.

The configured backend model overrides the request model; with neither the
call fails 400. Failures surface as :class:`BackendError` carrying an
OpenAI-style error body.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Protocol, runtime_checkable

from quorum_tpu_torch import oai


class BackendError(Exception):
    """A backend call failed: the normalized error body plus any response
    headers the relay must keep (``Retry-After`` on 503s). ``code`` is an
    optional machine-readable failure class (``"resume_diverged"``) that a
    stream's error chunk carries as ``qt_error``."""

    def __init__(self, message: str, *, status_code: int = 500, body: dict | None = None,
                 headers: dict[str, str] | None = None, code: str | None = None):
        super().__init__(message)
        self.status_code = status_code
        self.body = body or oai.error_body(message, code=status_code)
        self.headers = dict(headers or {})
        self.code = code


@dataclass
class CompletionResult:
    """Result of a non-streaming backend call."""

    backend_name: str
    status_code: int
    body: dict[str, Any]
    headers: dict[str, str] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return 200 <= self.status_code < 300 and "error" not in self.body

    @property
    def content(self) -> str:
        return oai.extract_content(self.body)

    @property
    def usage(self) -> dict[str, Any] | None:
        u = self.body.get("usage")
        return u if isinstance(u, dict) else None


def prepare_body(body: dict[str, Any], backend_model: str) -> dict[str, Any]:
    """A shallow copy of ``body`` with the effective model set; 400 when
    neither the backend config nor the request names one."""
    out = dict(body)
    if backend_model:
        out["model"] = backend_model
    elif not out.get("model"):
        msg = "No model specified in config.yaml or request"
        raise BackendError(msg, status_code=400,
                           body=oai.error_body(msg, type_="invalid_request_error", code=400))
    return out


@runtime_checkable
class Backend(Protocol):
    """One upstream model: an in-process engine or a remote HTTP service."""

    name: str
    model: str  # configured override ("" = honor the request's model)

    async def complete(self, body: dict[str, Any], headers: dict[str, str],
                       timeout: float) -> CompletionResult:
        """Non-streaming chat completion."""
        ...

    def stream(self, body: dict[str, Any], headers: dict[str, str],
               timeout: float) -> AsyncIterator[dict[str, Any]]:
        """Streaming chat completion: yields OpenAI chunk dicts. ``[DONE]``
        is not yielded (the end is the iterator's end); failures raise
        :class:`BackendError`, possibly mid-stream."""
        ...

    async def aclose(self) -> None:
        ...
