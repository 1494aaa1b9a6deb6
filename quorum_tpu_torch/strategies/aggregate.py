"""The aggregation hop: label and join the members' answers, build the
synthesis prompt, and call the aggregator backend with sanitized headers
(Authorization and Content-Type only, ``$OPENAI_API_KEY`` as the fallback
credential). Any failure degrades to the separator-join of the answers, and
the outcome says so (``degraded_reason``, ``error``): the server turns it into
``X-Quorum-Aggregate-Degraded`` / ``X-Quorum-Aggregate-Error`` headers.

The prompt template takes ``{intermediate_results}``,
``{{intermediate_results}}`` or the older ``{responses}`` placeholder; with
none, the answers are appended so they are never dropped.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Any, AsyncIterator, Sequence

from quorum_tpu_torch import oai
from quorum_tpu_torch.backends.base import Backend
from quorum_tpu_torch.config import AggregateParams
from quorum_tpu_torch.observability import AGGREGATE_DEGRADED, current_trace, trace_span
from quorum_tpu_torch.telemetry.recorder import RECORDER

aggregation_logger = logging.getLogger("aggregation")

_PLACEHOLDERS = ("{{intermediate_results}}", "{intermediate_results}", "{responses}")


@dataclass
class AggregateOutcome:
    """One combine's text and how it was made: ``degraded_reason`` is None
    for a real aggregation, else one of no_aggregator / no_credentials /
    error / empty, with the first underlying failure in ``error``."""

    content: str
    degraded_reason: str | None = None
    error: str | None = None

    @property
    def degraded(self) -> bool:
        return self.degraded_reason is not None


def build_aggregation_prompt(labeled_sources: Sequence[tuple[str, str]],
                             params: AggregateParams, user_query: str) -> str:
    """The synthesis prompt from (backend name, answer) pairs."""
    formatted = [params.source_label_format.format(backend_name=name) + text
                 if params.include_source_names else text
                 for name, text in labeled_sources]
    intermediate_results = params.intermediate_separator.join(formatted)
    prompt = params.query_format.format(query=user_query) if params.include_original_query else ""
    template = params.prompt_template
    for ph in _PLACEHOLDERS:
        if ph in template:
            template = template.replace(ph, intermediate_results)
            break
    else:
        template = template + "\n\n" + intermediate_results
    return prompt + template


def clean_aggregator_headers(headers: dict[str, str] | None) -> dict[str, str] | None:
    """Authorization (any case, else ``$OPENAI_API_KEY``) and Content-Type
    only; None when there is no credential at all."""
    auth = next((v for k, v in (headers or {}).items() if k.lower() == "authorization"), "")
    if not auth:
        api_key = os.environ.get("OPENAI_API_KEY", "")
        auth = f"Bearer {api_key}" if api_key else ""
    if not auth:
        return None
    return {"Authorization": auth, "Content-Type": "application/json"}


def aggregation_body(prompt: str, aggregator: Backend,
                     params: AggregateParams) -> dict[str, Any]:
    """The hop's request body: the prompt as one user message, and
    ``aggregator_priority`` as the ``priority`` knob (the aggregate is the
    client's answer; engines without QoS classes ignore it)."""
    body: dict[str, Any] = {"model": aggregator.model or "",
                            "messages": [{"role": "user", "content": prompt}],
                            "stream": False}
    if params.aggregator_priority:
        body["priority"] = params.aggregator_priority
    return body


def _hop_headers(aggregator: Backend, headers: dict[str, str] | None) -> dict[str, str] | None:
    """The hop's headers, or None when a remote aggregator has no credential
    (a local one needs none)."""
    clean = clean_aggregator_headers(headers)
    if clean is None and not getattr(aggregator, "requires_auth", True):
        clean = {"Content-Type": "application/json"}
    return clean


def _degrade(reason: str, fallback: str, error: str | None = None) -> AggregateOutcome:
    """Count and record the fallback: ``quorum_tpu_aggregate_degraded_total``
    and an ``aggregate-degraded`` flight-recorder event."""
    AGGREGATE_DEGRADED.inc(reason=reason)
    RECORDER.record("aggregate-degraded", reason=reason,
                    **({"error": error[:200]} if error else {}))
    aggregation_logger.error("aggregation degraded (%s): %s", reason, error or "")
    return AggregateOutcome(fallback, degraded_reason=reason, error=error)


async def aggregate_with_status(labeled_sources: Sequence[tuple[str, str]],
                                aggregator: Backend | None, params: AggregateParams,
                                user_query: str, headers: dict[str, str] | None,
                                timeout: float = 60.0) -> AggregateOutcome:
    """Synthesize the answers through the aggregator (non-streaming); any
    failure degrades to ``intermediate_separator.join(answers)``."""
    fallback = params.intermediate_separator.join(t for _, t in labeled_sources)
    if aggregator is None:
        return _degrade("no_aggregator", fallback)
    prompt = build_aggregation_prompt(labeled_sources, params, user_query)
    aggregation_logger.info("Prompt for aggregator: %s", prompt)
    clean_headers = _hop_headers(aggregator, headers)
    if clean_headers is None:
        return _degrade("no_credentials", fallback)
    try:
        # The synthesis hop often dominates an aggregate request's latency:
        # its span names the aggregator.
        with trace_span(current_trace(), "aggregator-call", backend=aggregator.name):
            result = await aggregator.complete(aggregation_body(prompt, aggregator, params),
                                               clean_headers, timeout)
    except Exception as e:
        return _degrade("error", fallback, error=str(e)[:500])
    if not result.ok:
        err = result.body.get("error") if isinstance(result.body, dict) else None
        msg = err.get("message") if isinstance(err, dict) else None
        return _degrade("error", fallback, error=str(msg or result.body)[:500])
    if not result.content:
        return _degrade("empty", fallback)
    aggregation_logger.info("Aggregator response: %s", result.content)
    return AggregateOutcome(result.content)


async def stream_aggregate_deltas(labeled_sources: Sequence[tuple[str, str]],
                                  aggregator: Backend | None, params: AggregateParams,
                                  user_query: str, headers: dict[str, str] | None,
                                  timeout: float = 60.0) -> AsyncIterator[str | AggregateOutcome]:
    """The live aggregation hop (``stream_aggregate: true``): the
    aggregator's text deltas as they decode, then one :class:`AggregateOutcome`
    whose content is the joined stream. A failure before the first delta
    yields the separator-join as one delta; after deltas were sent they
    cannot be unsent, so the stream ends and the outcome says why."""
    fallback = params.intermediate_separator.join(t for _, t in labeled_sources)
    if aggregator is None:
        yield fallback
        yield _degrade("no_aggregator", fallback)
        return
    prompt = build_aggregation_prompt(labeled_sources, params, user_query)
    aggregation_logger.info("Prompt for aggregator: %s", prompt)
    clean_headers = _hop_headers(aggregator, headers)
    if clean_headers is None:
        yield fallback
        yield _degrade("no_credentials", fallback)
        return
    body = aggregation_body(prompt, aggregator, params)
    body["stream"] = True
    sent: list[str] = []
    try:
        with trace_span(current_trace(), "aggregator-call", backend=aggregator.name,
                        streamed=1):
            async for chunk in aggregator.stream(body, clean_headers, timeout):
                text = oai.extract_delta_content(chunk)
                if text:
                    sent.append(text)
                    yield text
    except Exception as e:
        if not sent:
            yield fallback
        yield _degrade("error", "".join(sent) or fallback, error=str(e)[:500])
        return
    if not sent:
        yield fallback
        yield _degrade("empty", fallback)
        return
    aggregation_logger.info("Aggregator response: %s", "".join(sent))
    yield AggregateOutcome("".join(sent))
