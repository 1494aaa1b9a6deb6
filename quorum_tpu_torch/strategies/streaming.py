"""Parallel streaming: N backend streams → one SSE stream. Each member
stream runs as its own task feeding one merge queue, so members' deltas
interleave live.

SSE contract: a role chunk (id ``chatcmpl-parallel``, model
``parallel-proxy``); member i's deltas under ``chatcmpl-parallel-{i}``
(unless ``suppress_individual_responses``); the combined text under
``chatcmpl-parallel-final`` with finish_reason "stop" — or, with
``stream_aggregate``, the aggregator's deltas under that id as they decode
and a closing empty chunk with "stop"; an error chunk (id "error",
"Error: All backends failed to provide content") when no member produced
text; then ``data: [DONE]``.

In the aggregate strategy only ``source_backends`` are fanned out to, member
text is filtered live per ``strip_intermediate_thinking`` and the
aggregator's per ``hide_aggregator_thinking``; in the concatenate strategy
the final join is stripped per ``hide_final_think``.
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass
from typing import Any, AsyncIterator

from quorum_tpu_torch import oai, sse
from quorum_tpu_torch.backends.base import Backend
from quorum_tpu_torch.backends.registry import BackendRegistry
from quorum_tpu_torch.config import AggregateParams, Config
from quorum_tpu_torch.filtering import ThinkingTagFilter, strip_thinking_tags
from quorum_tpu_torch.observability import trace_span, use_trace
from quorum_tpu_torch.strategies.aggregate import (AggregateOutcome, aggregate_with_status,
                                                   stream_aggregate_deltas)

logger = logging.getLogger(__name__)
aggregation_logger = logging.getLogger("aggregation")

PROXY_MODEL_NAME = "parallel-proxy"

_DONE = object()


@dataclass
class StreamPlan:
    """Fan-out parameters resolved from the config and the request body."""

    backends: list[Backend]
    strategy_name: str
    separator: str
    hide_intermediate: bool
    hide_final: bool
    thinking_tags: list[str]
    skip_final: bool
    suppress_individual: bool
    aggregator: Backend | None
    aggregate_params: AggregateParams | None
    user_query: str

    @classmethod
    def from_config(cls, cfg: Config, registry: BackendRegistry,
                    body: dict[str, Any]) -> "StreamPlan":
        strategy = cfg.strategy_name
        user_query = oai.first_user_message(body)
        if strategy == "aggregate":
            p = cfg.aggregate
            suppress = bool(body.get("suppress_individual_responses",
                                     p.suppress_individual_responses))
            return cls(backends=registry.select(p.source_backends), strategy_name=strategy,
                       separator=p.intermediate_separator,
                       hide_intermediate=p.strip_intermediate_thinking,
                       hide_final=p.hide_aggregator_thinking, thinking_tags=p.thinking_tags,
                       skip_final=False, suppress_individual=suppress,
                       aggregator=(registry.get(p.aggregator_backend)
                                   if p.aggregator_backend else None),
                       aggregate_params=p, user_query=user_query)
        p = cfg.concatenate
        return cls(backends=registry.backends, strategy_name=strategy, separator=p.separator,
                   hide_intermediate=p.hide_intermediate_think, hide_final=p.hide_final_think,
                   thinking_tags=p.thinking_tags, skip_final=p.skip_final_aggregation,
                   suppress_individual=bool(body.get("suppress_individual_responses", False)),
                   aggregator=None, aggregate_params=None, user_query=user_query)


async def _pump(index: int, backend: Backend, body: dict[str, Any], headers: dict[str, str],
                timeout: float, queue: asyncio.Queue, trace=None) -> None:
    """Drive one member stream, putting (index, text) and at the end
    (index, _DONE) into the merge queue; a failure ends the member. The
    request trace is bound again in this task: a ``cuda://`` member submits
    to its engine at the stream's first ``__anext__``, here, after the
    handler returned, and its engine spans must still attach."""
    try:
        with use_trace(trace), trace_span(trace, "fanout-stream", backend=backend.name,
                                          index=index):
            async for chunk in backend.stream(body, headers, timeout):
                text = oai.extract_delta_content(chunk)
                if text:
                    await queue.put((index, text))
    except Exception as e:
        logger.warning("Backend %s (%d) stream failed: %s", backend.name, index, e)
    finally:
        await queue.put((index, _DONE))


def _final_delta(text: str) -> bytes:
    return sse.encode_event(oai.content_chunk(text, model=PROXY_MODEL_NAME,
                                              id=oai.PARALLEL_FINAL_ID))


async def _live_aggregate(plan: StreamPlan, labeled: list[tuple[str, str]],
                          headers: dict[str, str], timeout: float) -> AsyncIterator[bytes]:
    """``stream_aggregate``: the aggregator's deltas under the final id as
    they decode, then an empty chunk with finish_reason "stop"."""
    final_filter = ThinkingTagFilter(plan.thinking_tags)
    async for item in stream_aggregate_deltas(labeled, plan.aggregator, plan.aggregate_params,
                                              plan.user_query, headers, timeout):
        if isinstance(item, AggregateOutcome):
            break
        text = final_filter.feed(item) if plan.hide_final else item
        if text:
            yield _final_delta(text)
    if plan.hide_final and (tail := final_filter.flush()):
        yield _final_delta(tail)
    yield sse.encode_event(oai.chunk(id=oai.PARALLEL_FINAL_ID, model=PROXY_MODEL_NAME,
                                     delta={}, finish_reason="stop"))


async def parallel_stream(plan: StreamPlan, body: dict[str, Any], headers: dict[str, str],
                          timeout: float, aggregator_timeout: float | None = None,
                          trace=None) -> AsyncIterator[bytes]:
    """Merge N member streams into one OpenAI-compatible SSE byte stream;
    ``trace`` gets the members' ``fanout-stream`` spans and the final
    hop's ``aggregate`` span."""
    yield sse.encode_event(oai.role_chunk(PROXY_MODEL_NAME))
    n = len(plan.backends)
    filters = [ThinkingTagFilter(plan.thinking_tags) for _ in range(n)]
    collected = ["" for _ in range(n)]
    queue: asyncio.Queue = asyncio.Queue()
    tasks = [asyncio.create_task(_pump(i, b, body, headers, timeout, queue, trace))
             for i, b in enumerate(plan.backends)]
    try:
        finished = 0
        while finished < n:
            index, item = await queue.get()
            if item is _DONE:
                finished += 1
                text = filters[index].flush() if plan.hide_intermediate else ""
            else:
                text = filters[index].feed(item) if plan.hide_intermediate else item
            if not text:
                continue
            collected[index] += text
            if not plan.suppress_individual:
                yield sse.encode_event(oai.content_chunk(text, model=PROXY_MODEL_NAME,
                                                         backend_index=index))
    finally:
        for t in tasks:
            t.cancel()

    if not plan.skip_final:
        # Aggregate: member text was already filtered live; concatenate:
        # the final join is stripped per hide_final_think.
        if plan.strategy_name == "aggregate":
            labeled = [(plan.backends[i].name, text) for i, text in enumerate(collected) if text]
        else:
            labeled = [(plan.backends[i].name,
                        strip_thinking_tags(text, plan.thinking_tags, hide=plan.hide_final))
                       for i, text in enumerate(collected) if text]
        if not labeled:
            yield sse.encode_event(oai.error_chunk(
                "Error: All backends failed to provide content", model=PROXY_MODEL_NAME))
        elif (plan.strategy_name == "aggregate" and plan.aggregator is not None
              and plan.aggregate_params):
            hop_timeout = aggregator_timeout or timeout
            # Bound again: this body runs under the ASGI server, outside the
            # handler's context, and the hop's own spans must attach.
            if plan.aggregate_params.stream_aggregate:
                with use_trace(trace), trace_span(trace, "aggregate",
                                                  strategy=plan.strategy_name,
                                                  aggregator=plan.aggregator.name, streamed=1):
                    async for frame in _live_aggregate(plan, labeled, headers, hop_timeout):
                        yield frame
            else:
                with use_trace(trace), trace_span(trace, "aggregate",
                                                  strategy=plan.strategy_name,
                                                  aggregator=plan.aggregator.name):
                    outcome = await aggregate_with_status(labeled, plan.aggregator,
                                                          plan.aggregate_params,
                                                          plan.user_query, headers, hop_timeout)
                combined = outcome.content
                if plan.hide_final:
                    combined = strip_thinking_tags(combined, plan.thinking_tags, hide=True)
                yield sse.encode_event(oai.final_chunk(combined, model=PROXY_MODEL_NAME))
        else:
            with trace_span(trace, "aggregate", strategy=plan.strategy_name):
                combined = plan.separator.join(text for _, text in labeled)
            aggregation_logger.info("Final aggregated streaming content: %s", combined)
            yield sse.encode_event(oai.final_chunk(combined, model=PROXY_MODEL_NAME))
    yield sse.encode_done()
