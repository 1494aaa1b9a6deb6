"""HttpBackend: an OpenAI-compatible upstream behind the backend protocol —
the port's copy of the JAX package's relay.

One pooled ``httpx.AsyncClient`` per backend; streams are relayed as the
upstream's bytes arrive (``SSEParser``). Error contract: a transport failure
is a :class:`BackendError` with a 500 ``proxy_error`` body; a non-2xx upstream
status passes its status and parsed body through; a successful body is tagged
with the backend's name. ``embed`` and ``text_complete`` relay
``/embeddings`` and legacy ``/completions`` the same way (not streamed).

Retries (``retries: N`` on the backend's config entry, default 0): up to N
extra attempts on connect errors and upstream 5xx, with capped exponential
backoff and jitter, never past the request's deadline, never inside the
upstream's own ``Retry-After``. A stream retries only before its first byte:
once a 2xx event stream is open nothing is retried, since tokens may already
be on the client's wire.

``httpx`` is imported with this module, which the registry imports only for
an ``http(s)://`` backend.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import logging
import random
import time
from typing import Any, AsyncIterator

import httpx

from quorum_tpu_torch import faults, oai, sse
from quorum_tpu_torch.observability import BACKEND_RETRIES
from quorum_tpu_torch.backends.base import BackendError, CompletionResult, prepare_body

logger = logging.getLogger(__name__)

# Hop-by-hop or recomputed headers, never forwarded upstream.
_SKIP_HEADERS = {"host", "content-length", "transfer-encoding", "connection"}

# Attempt k sleeps min(CAP, BASE · 2^k) times a jitter factor in [0.5, 1.5).
RETRY_BASE_S = 0.05
RETRY_CAP_S = 2.0
# Failures where the request never reached the upstream, so a second attempt
# cannot duplicate its work (a read failure mid-body is not retried); an
# injected fault at the request sites stands for one.
_RETRYABLE_EXC = (httpx.ConnectError, httpx.ConnectTimeout, faults.FaultInjected)


def _clean_headers(headers: dict[str, str]) -> dict[str, str]:
    return {k: v for k, v in headers.items() if k.lower() not in _SKIP_HEADERS}


def _retry_after_s(resp: httpx.Response) -> float:
    """The upstream's ``Retry-After`` in seconds, in either form (delay
    seconds or an HTTP date); 0.0 when absent, malformed or past."""
    raw = resp.headers.get("Retry-After", "")
    if not raw:
        return 0.0
    try:
        return max(0.0, float(raw))
    except ValueError:
        pass
    from datetime import timezone
    from email.utils import parsedate_to_datetime

    try:
        dt = parsedate_to_datetime(raw)
    except (TypeError, ValueError):
        return 0.0
    if dt is None:
        return 0.0
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    return max(0.0, dt.timestamp() - time.time())


class HttpBackend:
    requires_auth = True  # a remote upstream needs a credential for the aggregation hop

    def __init__(self, name: str, url: str, model: str = "",
                 client: httpx.AsyncClient | None = None, retries: int = 0):
        self.name = name
        self.url = url.rstrip("/")
        self.model = model
        self.retries = max(0, int(retries))
        self._client = client or httpx.AsyncClient()

    @property
    def _endpoint(self) -> str:
        return f"{self.url}/chat/completions"

    async def _backoff(self, attempt: int, deadline: float, floor: float = 0.0) -> bool:
        """Sleep before retry ``attempt + 1``; False when the retry count or
        the deadline is spent and the failure must surface instead. Each
        retry counts into ``quorum_tpu_backend_retries_total{backend=}``."""
        if attempt >= self.retries:
            return False
        delay = min(RETRY_CAP_S, RETRY_BASE_S * (2 ** attempt))
        delay = max(delay * (0.5 + random.random()), floor)
        if time.monotonic() + delay >= deadline:
            return False
        BACKEND_RETRIES.inc(backend=self.name)
        await asyncio.sleep(delay)
        return True

    async def complete(self, body: dict[str, Any], headers: dict[str, str],
                       timeout: float) -> CompletionResult:
        req_body = prepare_body(body, self.model)
        req_body["stream"] = False
        return await self._post_json(self._endpoint, req_body, headers, timeout)

    async def embed(self, body: dict[str, Any], headers: dict[str, str],
                    timeout: float) -> CompletionResult:
        """Relay ``/embeddings`` upstream, with :meth:`complete`'s model
        precedence, retries and error normalization."""
        return await self._post_json(f"{self.url}/embeddings", prepare_body(body, self.model),
                                     headers, timeout)

    async def text_complete(self, body: dict[str, Any], headers: dict[str, str],
                            timeout: float) -> CompletionResult:
        """Relay legacy ``/completions`` upstream, not streamed."""
        req_body = prepare_body(body, self.model)
        req_body["stream"] = False
        return await self._post_json(f"{self.url}/completions", req_body, headers, timeout)

    async def _post_json(self, url: str, req_body: dict[str, Any], headers: dict[str, str],
                         timeout: float) -> CompletionResult:
        """POST a JSON body (retrying as the class docstring says) and return
        the upstream's status and body, tagged with the backend's name."""
        deadline = time.monotonic() + timeout
        attempt = 0
        while True:
            try:
                faults.fire("http.request")
                resp = await self._client.post(
                    url, json=req_body, headers=_clean_headers(headers),
                    timeout=max(0.001, deadline - time.monotonic()))
            except Exception as e:
                if isinstance(e, _RETRYABLE_EXC) and await self._backoff(attempt, deadline):
                    attempt += 1
                    continue
                logger.warning("Backend %s transport failure: %s", self.name, e)
                raise BackendError(f"Backend {self.name} error: {e}", status_code=500) from e
            if resp.status_code >= 500 and await self._backoff(
                    attempt, deadline, floor=_retry_after_s(resp)):
                attempt += 1
                continue
            break
        try:
            parsed = resp.json()
        except ValueError:  # json.JSONDecodeError included
            parsed = oai.error_body(f"Invalid JSON from backend {self.name}",
                                    code=resp.status_code or 500)
        if isinstance(parsed, dict):
            parsed.setdefault("backend", self.name)
        else:
            parsed = oai.error_body(f"Non-object JSON from backend {self.name}", code=500)
        return CompletionResult(backend_name=self.name, status_code=resp.status_code,
                                body=parsed, headers=dict(resp.headers))

    async def stream(self, body: dict[str, Any], headers: dict[str, str],
                     timeout: float) -> AsyncIterator[dict[str, Any]]:
        """Relay the upstream's SSE events as dicts; retries stop at the
        first relayed byte."""
        req_body = prepare_body(body, self.model)
        req_body["stream"] = True
        deadline = time.monotonic() + timeout
        attempt = 0
        while True:  # attempts before the first byte only
            cm = None
            try:
                faults.fire("http.stream")
                cm = self._client.stream("POST", self._endpoint, json=req_body,
                                         headers=_clean_headers(headers),
                                         timeout=max(0.001, deadline - time.monotonic()))
                resp = await cm.__aenter__()
            except Exception as e:
                if cm is not None:
                    with contextlib.suppress(Exception):
                        await cm.__aexit__(None, None, None)
                if isinstance(e, _RETRYABLE_EXC) and await self._backoff(attempt, deadline):
                    attempt += 1
                    continue
                logger.warning("Backend %s stream failure: %s", self.name, e)
                raise BackendError(f"Backend {self.name} error: {e}", status_code=500) from e
            if not 200 <= resp.status_code < 300:
                raw = await resp.aread()
                retry_floor = _retry_after_s(resp)
                retry_after = resp.headers.get("Retry-After")
                await cm.__aexit__(None, None, None)
                if resp.status_code >= 500 and await self._backoff(attempt, deadline,
                                                                   floor=retry_floor):
                    attempt += 1
                    continue
                try:
                    err = json.loads(raw)
                except ValueError:
                    err = oai.error_body(raw.decode("utf-8", "replace")
                                         or f"HTTP {resp.status_code}", code=resp.status_code)
                raise BackendError(
                    f"Backend {self.name} HTTP {resp.status_code}",
                    status_code=resp.status_code, body=err,
                    headers={"Retry-After": retry_after} if retry_after is not None else None)
            break  # a 2xx stream is open: nothing past here is retried
        parser = sse.SSEParser()
        try:
            async for raw_chunk in resp.aiter_bytes():
                for event in parser.feed(raw_chunk):
                    if event == sse.DONE:
                        return
                    if isinstance(event, dict):  # non-JSON data lines are skipped
                        yield event
            for event in parser.flush():
                if isinstance(event, dict):
                    yield event
            # A compliant stream ends with [DONE]; a clean EOF without it is
            # an upstream that died after its last frame.
            raise BackendError(f"Backend {self.name} stream ended without [DONE]",
                               status_code=500)
        except BackendError:
            raise
        except Exception as e:
            logger.warning("Backend %s stream failure: %s", self.name, e)
            raise BackendError(f"Backend {self.name} error: {e}", status_code=500) from e
        finally:
            with contextlib.suppress(Exception):
                await cm.__aexit__(None, None, None)

    async def aclose(self) -> None:
        await self._client.aclose()
