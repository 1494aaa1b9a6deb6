"""Parallel fan-out of one request to N backends (non-streaming). A failed
backend becomes an error outcome, never an exception, so a partial failure
serves the survivors."""

from __future__ import annotations

import asyncio
from dataclasses import dataclass
from typing import Any

from quorum_tpu_torch.backends.base import Backend, BackendError, CompletionResult
from quorum_tpu_torch.observability import current_trace, trace_span, use_trace


@dataclass
class BackendOutcome:
    backend: Backend
    result: CompletionResult | None = None
    error: BackendError | None = None

    @property
    def ok(self) -> bool:
        return self.result is not None and self.result.ok

    @property
    def content(self) -> str:
        return self.result.content if self.result else ""

    @property
    def usage(self) -> dict[str, Any] | None:
        return self.result.usage if self.result else None

    @property
    def error_message(self) -> str:
        """The message of the error body, of the error or of the result."""
        for body in ((self.error.body if self.error is not None else None),
                     (self.result.body if self.result is not None else None)):
            if body is None:
                continue
            err = body.get("error")
            if isinstance(err, dict):
                return err.get("message", "Unknown error")
            return str(body)
        return "Unknown error"


async def _call_one(backend: Backend, body: dict[str, Any], headers: dict[str, str],
                    timeout: float, trace=None) -> BackendOutcome:
    try:
        # gather() runs each call as its own task: the request trace is
        # bound again so a cuda:// backend's engine spans attach to it.
        with use_trace(trace), trace_span(trace, "fanout-call", backend=backend.name) as span:
            result = await backend.complete(body, headers, timeout)
            if span is not None:
                span.meta["status"] = result.status_code
        return BackendOutcome(backend=backend, result=result)
    except BackendError as e:
        return BackendOutcome(backend=backend, error=e)
    except Exception as e:  # any other failure is one backend's error outcome
        return BackendOutcome(backend=backend, error=BackendError(str(e)))


async def fanout_complete(backends: list[Backend], body: dict[str, Any],
                          headers: dict[str, str], timeout: float) -> list[BackendOutcome]:
    """Call every backend concurrently; outcomes in backend order."""
    trace = current_trace()
    return list(await asyncio.gather(*[_call_one(b, body, headers, timeout, trace)
                                       for b in backends]))
