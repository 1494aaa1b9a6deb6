"""OpenAI chat-completion object builders and request validation — the
subset of the JAX package's ``oai`` module that the port serves.

Parallel-mode stream ids: ``chatcmpl-parallel`` (role chunk),
``chatcmpl-parallel-{i}`` (member i's deltas), ``chatcmpl-parallel-final``
(the combined text, finish_reason "stop"); a failed stream ends with an
error chunk (id "error", finish_reason "error").
"""

from __future__ import annotations

import math
import time
import uuid
from typing import Any

OBJECT_CHUNK = "chat.completion.chunk"
OBJECT_COMPLETION = "chat.completion"
PARALLEL_ID = "chatcmpl-parallel"
PARALLEL_FINAL_ID = "chatcmpl-parallel-final"
MAX_QUORUM = 8


class MoreChunk(dict):
    """A stream chunk known to be immediately followed by another ready one:
    the SSE writer joins such runs into one socket flush. Serializes like a
    plain dict."""


def more(chunk: dict) -> "MoreChunk":
    return MoreChunk(chunk)


def has_more(chunk: Any) -> bool:
    return isinstance(chunk, MoreChunk)


def now() -> int:
    return int(time.time())


def new_request_id() -> str:
    return f"chatcmpl-{uuid.uuid4().hex[:24]}"


def chunk(*, id: str, model: str, delta: dict[str, Any], finish_reason: str | None = None,
          created: int | None = None, index: int = 0) -> dict[str, Any]:
    return {
        "id": id,
        "object": OBJECT_CHUNK,
        "created": created if created is not None else now(),
        "model": model,
        "choices": [{"index": index, "delta": delta, "finish_reason": finish_reason}],
    }


def role_chunk(model: str, id: str = PARALLEL_ID) -> dict[str, Any]:
    return chunk(id=id, model=model, delta={"role": "assistant"})


def content_chunk(content: str, *, model: str, backend_index: int | None = None,
                  id: str | None = None) -> dict[str, Any]:
    if id is None:
        id = PARALLEL_ID if backend_index is None else f"{PARALLEL_ID}-{backend_index}"
    return chunk(id=id, model=model, delta={"content": content})


def final_chunk(content: str, *, model: str) -> dict[str, Any]:
    return chunk(id=PARALLEL_FINAL_ID, model=model, delta={"content": content},
                 finish_reason="stop")


def error_chunk(message: str, *, model: str) -> dict[str, Any]:
    """Failure chunk of a stream: id "error", finish_reason "error"."""
    return chunk(id="error", model=model, delta={"content": message}, finish_reason="error")


def empty_usage() -> dict[str, int]:
    return {"prompt_tokens": 0, "completion_tokens": 0, "total_tokens": 0}


def sum_usage(usages: list[dict[str, Any] | None]) -> dict[str, int]:
    """Token usage summed across backends."""
    total = empty_usage()
    for u in usages:
        if not u:
            continue
        for k in total:
            total[k] += int(u.get(k, 0) or 0)
    return total


def completion(*, content: str, model: str, id: str | None = None,
               created: int | None = None, usage: dict[str, Any] | None = None,
               finish_reason: str = "stop") -> dict[str, Any]:
    return {
        "id": id or new_request_id(),
        "object": OBJECT_COMPLETION,
        "created": created if created is not None else now(),
        "model": model,
        "choices": [{"index": 0, "message": {"role": "assistant", "content": content},
                     "finish_reason": finish_reason}],
        "usage": usage or empty_usage(),
    }


def error_body(message: str, type_: str = "proxy_error", code: int = 500) -> dict[str, Any]:
    return {"error": {"message": message, "type": type_, "code": code}}


def extract_content(response: dict[str, Any]) -> str:
    """``choices[0].message.content``, or "" when the shape is not there."""
    try:
        return response["choices"][0]["message"]["content"] or ""
    except (KeyError, IndexError, TypeError, AttributeError):
        return ""


def extract_delta_content(chunk_: dict[str, Any]) -> str:
    try:
        return chunk_["choices"][0]["delta"].get("content") or ""
    except (KeyError, IndexError, TypeError, AttributeError):
        return ""


def first_user_message(body: dict[str, Any]) -> str:
    """The query the aggregation prompt quotes: the first user message with
    usable content."""
    for m in body.get("messages") or []:
        if isinstance(m, dict) and m.get("role") == "user":
            content = m.get("content")
            if isinstance(content, (str, list)):
                return flatten_content(content)
    return ""


def flatten_content(content: Any) -> str:
    """OpenAI message content → plain text (str or content-part array)."""
    if isinstance(content, str):
        return content
    if isinstance(content, list):
        return "".join(p.get("text", "") for p in content
                       if isinstance(p, dict) and p.get("type") == "text")
    return ""


def validate_request_body(body: dict[str, Any]) -> str | None:
    """Request-level sanity of the knobs: an error message for a 400, or
    None when the body is acceptable. Backends keep their own checks."""
    for key in ("temperature", "top_p", "seed", "max_tokens", "max_completion_tokens",
                "presence_penalty", "frequency_penalty"):
        val = body.get(key)
        if val is None:
            continue
        if isinstance(val, bool):
            return f"Invalid value for {key!r}: {val!r}"
        try:
            num = float(val)
            if not math.isfinite(num):
                raise ValueError
        except (TypeError, ValueError):
            return f"Invalid value for {key!r}: {val!r}"
        if key in ("max_tokens", "max_completion_tokens") and num < 1:
            return f"Invalid value for {key!r}: must be >= 1"
        if key in ("presence_penalty", "frequency_penalty") and not -2.0 <= num <= 2.0:
            return f"Invalid value for {key!r}: {val!r} (must be in [-2, 2])"
    top_k = body.get("top_k")
    if top_k is not None and (not isinstance(top_k, int) or isinstance(top_k, bool)
                              or top_k < 0):
        return f"Invalid value for 'top_k': {top_k!r} (a non-negative integer)"
    n = body.get("n")
    if n is not None and (not isinstance(n, int) or isinstance(n, bool) or n < 1):
        return f"Invalid value for 'n': {n!r} (must be a positive integer)"
    lp = body.get("logprobs")
    if lp is not None and not isinstance(lp, bool):
        return f"Invalid value for 'logprobs': {lp!r}"
    top_lp = body.get("top_logprobs")
    if top_lp is not None and (not isinstance(top_lp, int) or isinstance(top_lp, bool)
                               or not 0 <= top_lp <= 20):
        return f"Invalid value for 'top_logprobs': {top_lp!r} (must be an integer in [0, 20])"
    bias = body.get("logit_bias")
    if bias is not None:
        if not isinstance(bias, dict):
            return f"Invalid value for 'logit_bias': {bias!r}"
        for k, v in bias.items():
            try:
                int(k)
                fv = float(v)
            except (TypeError, ValueError):
                return f"Invalid logit_bias entry: {k!r}: {v!r}"
            if not -100.0 <= fv <= 100.0:
                return f"logit_bias value {fv} outside [-100, 100]"
    stop = body.get("stop")
    if stop is not None and not isinstance(stop, (str, list)):
        return f"Invalid value for 'stop': {stop!r}"
    # Structured output: shape-level checks before fan-out, so a malformed
    # response_format is ONE 400, not N backend failures. Grammar
    # compilation (and its 422) stays in the backend, which owns the
    # tokenizer.
    rf = body.get("response_format")
    if rf is not None:
        if not isinstance(rf, dict) or not isinstance(rf.get("type"), str):
            return (f"Invalid value for 'response_format': {rf!r} (an "
                    "object with a string 'type')")
        rft = rf["type"]
        if rft not in ("text", "json_object", "json_schema", "regex"):
            return (f"Invalid response_format type {rft!r} (text, "
                    "json_object, json_schema, or regex)")
        if rft == "json_schema":
            js = rf.get("json_schema")
            if not isinstance(js, dict) or not isinstance(
                    js.get("schema"), (dict, bool)):
                return ("response_format type 'json_schema' requires "
                        "json_schema.schema (an object)")
        if rft == "regex":
            if not isinstance(rf.get("pattern"), str) or not rf["pattern"]:
                return ("response_format type 'regex' requires a non-empty "
                        "'pattern' string")
    t = body.get("timeout")
    if t is not None:
        if isinstance(t, bool) or not isinstance(t, (int, float)):
            return f"Invalid value for 'timeout': {t!r} (seconds, a number)"
        if not math.isfinite(float(t)) or float(t) <= 0:
            return f"Invalid value for 'timeout': {t!r} (must be > 0)"
    prio = body.get("priority")
    if prio is not None and prio not in ("interactive", "batch", "background"):
        return f"Invalid value for 'priority': {prio!r} (interactive, batch, or background)"
    # 'tenant' names a weighted-fair accounting bucket: inert without qos=1.
    tenant = body.get("tenant")
    if tenant is not None and (
            not isinstance(tenant, str) or not tenant or len(tenant) > 64):
        return (f"Invalid value for 'tenant': {tenant!r} (a non-empty "
                "string of at most 64 characters)")
    # Stream-resume knobs: checked here with the JAX package's words, so a
    # malformed body gets the same 400 from both packages. A well-formed
    # resume is the backend's to serve or refuse.
    rt = body.get("resume_tokens")
    if rt is not None:
        if not isinstance(rt, list) or not rt or not all(
                isinstance(t, int) and not isinstance(t, bool) and t >= 0
                for t in rt):
            return ("Invalid value for 'resume_tokens': must be a "
                    "non-empty array of non-negative token ids")
        if body.get("logprobs"):
            return ("'resume_tokens' cannot be combined with 'logprobs' "
                    "(replayed tokens carry no logprob records)")
        if body.get("n") not in (None, 1):
            return "'resume_tokens' requires n=1"
        if not body.get("stream"):
            return "'resume_tokens' requires stream=true"
    rc = body.get("resume_chars")
    if rc is not None:
        if isinstance(rc, bool) or not isinstance(rc, int) or rc < 0:
            return (f"Invalid value for 'resume_chars': {rc!r} (a "
                    "non-negative integer)")
        if rt is None:
            return "'resume_chars' requires 'resume_tokens'"
    sti = body.get("stream_token_ids")
    if sti is not None and not isinstance(sti, bool):
        return f"Invalid value for 'stream_token_ids': {sti!r}"
    if sti and body.get("n") not in (None, 1):
        return "'stream_token_ids' requires n=1"
    q = body.get("quorum")
    if q is not None and (isinstance(q, bool) or not isinstance(q, int)
                          or not 1 <= q <= MAX_QUORUM):
        return f"Invalid value for 'quorum': {q!r} (an integer in [1, {MAX_QUORUM}])"
    if "messages" in body and not isinstance(body["messages"], list):
        return "Invalid value for 'messages': must be an array"
    # A W3C traceparent as a body knob, for clients that cannot set headers:
    # consumed by the server, never forwarded; a malformed value is a 400,
    # not a silently minted trace-id.
    tp = body.get("traceparent")
    if tp is not None:
        from quorum_tpu_torch.telemetry import tracecontext

        if not isinstance(tp, str) or tracecontext.parse_traceparent(tp) is None:
            return (f"Invalid value for 'traceparent': {tp!r} (W3C "
                    "trace-context: 00-<32 hex>-<16 hex>-<2 hex flags>)")
    return None
