"""CudaBackend: an in-process PyTorch model behind the backend protocol — the
port's counterpart of the JAX package's ``TpuBackend``.

Requests are templated and tokenized, run through the engine's prefill and
decode kernels on the card, and detokenized back into OpenAI-shaped
responses; streaming is incremental (tokens leave the device once per decode
chunk).

URL grammar:  ``cuda://<model-id>?<spec overrides>&<engine options>``
  spec overrides   any ModelSpec field (n_layers=2, dtype=float32, ...)
  slots=           concurrent decode rows (default 4)
  decode_chunk=    decode steps per scheduler turn (default 8)
  seed=            weight-init seed
  device=          torch device (default cuda; cpu runs the plain versions)
  queue=           admission queue capacity (default 128; × members)
  max_tokens=      default completion budget (default 64)
  members=M        stacked fan-out (default 1 = off): backends whose URLs
  member=i         agree on ``members=M`` (and the base seed/spec) share ONE
                   engine holding M weight sets (seed..seed+M-1) stacked
                   on the card; ``member=i`` selects which weight set
                   serves THIS backend. Each member keeps its own slots and
                   sampler state and produces its own stream (unlike
                   ``ensemble``), but every decode chunk — and coalesced
                   same-bucket admissions — advance ALL members in one
                   dispatch: an N-model quorum pays N× the compute, not N×
                   the per-step host work
  member_seeds=    ``distinct`` (default) seeds member i with seed+i;
                   ``shared`` stacks M copies of the SAME weights (all
                   members seed identically) — the diversity then comes
                   from per-member sampling streams, and the shared
                   weights are what make ``quorum_dedup=1`` sound
  quorum_dedup=1   shared-prefix member dedup: when a full member group
                   admits the same prompt, prefill it ONCE on member 0's
                   weights and copy the K/V into all M cache rows —
                   prefill work drops ~M×. Requires ``member_seeds=shared``
                   (distinct weights produce distinct K/V); counted by the
                   engine's ``quorum_dedup_tokens``
  ensemble=M       logit-ensemble decoding (default 1 = off): M weight sets
                   (seed..seed+M-1) decode ONE shared stream — every step
                   averages the M members' next-token logits in f32 before
                   sampling

Request knobs: messages, max_tokens / max_completion_tokens, temperature,
top_p, top_k, seed, stop, stream (+ stream_options.include_usage). Knobs the
port does not serve yet (n > 1, logprobs, penalties, logit_bias,
response_format, tools) are a 400, never silently ignored.
"""

from __future__ import annotations

import asyncio
import logging
import math
import threading
from typing import Any, AsyncIterator

from quorum_tpu_torch import oai
from quorum_tpu_torch.backends.base import BackendError, CompletionResult, prepare_body
from quorum_tpu_torch.config import BackendSpec
from quorum_tpu_torch.engine.engine import (
    DEFAULT_DECODE_CHUNK,
    DEFAULT_MAX_PENDING,
    DEFAULT_SLOTS,
    GenerationResult,
    QueueFullError,
    get_engine,
)
from quorum_tpu_torch.engine.tokenizer import get_tokenizer
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.ops.sampling import SamplerConfig

logger = logging.getLogger(__name__)


def _invalid_request(message: str) -> BackendError:
    return BackendError(message, status_code=400,
                        body=oai.error_body(message, type_="invalid_request_error", code=400))


def _overloaded(name: str, why: str) -> BackendError:
    msg = f"Backend {name} is overloaded: {why}; retry later"
    return BackendError(msg, status_code=503,
                        body=oai.error_body(msg, type_="overloaded_error", code=503),
                        headers={"Retry-After": "1"})


def _timeout_error(name: str, timeout: float) -> BackendError:
    msg = f"Backend {name} timed out after {timeout}s"
    return BackendError(msg, status_code=504,
                        body=oai.error_body(msg, type_="timeout_error", code=504),
                        headers={"Retry-After": "1"})


def _parse_bool_opt(name: str, raw: str) -> bool:
    """Strict boolean URL option: a typo must not silently mean 'enabled'."""
    val = str(raw).lower()
    if val in ("1", "true", "yes"):
        return True
    if val in ("0", "false", "no"):
        return False
    raise ValueError(f"invalid {name}={raw!r} (use 0/1, true/false, yes/no)")


def _request_number(body: dict[str, Any], key: str, default: float) -> float:
    """Client-controlled numeric knob → float, or a 400 on junk."""
    val = body.get(key)
    if val is None:
        return default
    try:
        out = float(val)
        if not math.isfinite(out):
            raise ValueError("must be finite")
    except (TypeError, ValueError):
        raise _invalid_request(f"Invalid value for {key!r}: {val!r}") from None
    return out


def _request_sampler(body: dict[str, Any]) -> SamplerConfig:
    """OpenAI knobs → the on-device sampler (2-decimal quantization of
    temperature and top_p, as the JAX backend does)."""
    top_k = body.get("top_k")
    if top_k is None:
        top_k = 0
    if not isinstance(top_k, int) or isinstance(top_k, bool) or top_k < 0:
        raise _invalid_request(f"Invalid value for 'top_k': {top_k!r}")
    return SamplerConfig(temperature=round(_request_number(body, "temperature", 1.0), 2),
                         top_p=round(_request_number(body, "top_p", 1.0), 2), top_k=top_k)


def _stop_list(body: dict[str, Any]) -> list[str]:
    stop = body.get("stop")
    if stop is None:
        return []
    if isinstance(stop, str):
        return [stop]
    if isinstance(stop, list):
        return [s for s in stop if isinstance(s, str)]
    raise _invalid_request(f"Invalid value for 'stop': {stop!r}")


class _StopMatcher:
    """Incremental stop-string scanner: withholds text that could be the
    start of a stop sequence across delta boundaries."""

    def __init__(self, stops: list[str]):
        self.stops = [s for s in stops if s]
        self._tail = ""
        self.hit = False
        self._max = max((len(s) for s in self.stops), default=0)

    def feed(self, text: str) -> str:
        if not self.stops:
            return text
        if self.hit:
            return ""
        buf = self._tail + text
        first = min((i for i in (buf.find(s) for s in self.stops) if i >= 0), default=-1)
        if first >= 0:
            self.hit = True
            self._tail = ""
            return buf[:first]
        keep = 0
        for k in range(min(self._max - 1, len(buf)), 0, -1):
            if any(s.startswith(buf[-k:]) for s in self.stops):
                keep = k
                break
        self._tail = buf[len(buf) - keep:] if keep else ""
        return buf[: len(buf) - keep] if keep else buf

    def flush(self) -> str:
        out, self._tail = self._tail, ""
        return "" if self.hit else out


class CudaBackend:
    """One local model (engine + tokenizer) serving chat completions."""

    requires_auth = False  # local model: no upstream credential needed
    # Request fields the port does not serve yet: a 400, never a silent ignore.
    _UNSUPPORTED = ("tools", "tool_choice", "functions", "function_call", "logit_bias",
                    "logprobs", "top_logprobs")

    def __init__(self, name: str, engine, *, model: str = "", model_id: str = "",
                 default_max_tokens: int = 64, decode_chunk: int | None = None,
                 member: int = 0):
        self.name = name
        self.engine = engine
        # Stacked-members engine: which of the engine's weight sets serves
        # this backend's requests (0 on ordinary engines).
        self.member = member
        self.model_id = model_id or "cuda-model"
        self.model = model or self.model_id
        self.default_max_tokens = default_max_tokens
        self.decode_chunk = decode_chunk  # None → engine default
        self.tokenizer = get_tokenizer(engine.spec.vocab_size)

    @classmethod
    def from_spec(cls, bspec: BackendSpec) -> "CudaBackend":
        opts = bspec.options
        spec = resolve_spec(bspec.model_id, opts)
        members = int(opts.get("members", 1))
        member = int(opts.get("member", 0))
        if not 0 <= member < max(1, members):
            raise ValueError(f"member={member} out of range for members={members}")
        engine = get_engine(
            spec, device=opts.get("device"), seed=int(opts.get("seed", 0)),
            n_slots=int(opts.get("slots", DEFAULT_SLOTS)),
            decode_chunk=int(opts.get("decode_chunk", DEFAULT_DECODE_CHUNK)),
            max_pending=int(opts.get("queue", DEFAULT_MAX_PENDING)),
            members=members, member_seeds=opts.get("member_seeds", "distinct"),
            quorum_dedup=_parse_bool_opt("quorum_dedup", opts.get("quorum_dedup", "0")),
            ensemble=int(opts.get("ensemble", 1)))
        return cls(bspec.name, engine, model=bspec.model, model_id=bspec.model_id,
                   default_max_tokens=int(opts.get("max_tokens", 64)),
                   decode_chunk=int(opts["decode_chunk"]) if "decode_chunk" in opts else None,
                   member=member)

    # ---- request plumbing -------------------------------------------------

    def _plan(self, body: dict[str, Any]) -> dict[str, Any]:
        effective = prepare_body(body, self.model)
        for key in self._UNSUPPORTED:
            if body.get(key):
                raise _invalid_request(f"{key!r} is not supported by cuda:// backends yet")
        if body.get("n") not in (None, 1):
            raise _invalid_request("'n' > 1 is not supported by cuda:// backends yet")
        rf = body.get("response_format")
        if rf is not None and (not isinstance(rf, dict) or rf.get("type") not in (None, "text")):
            raise _invalid_request("'response_format' is not supported by cuda:// backends yet")
        for key in ("presence_penalty", "frequency_penalty"):
            if _request_number(body, key, 0.0) != 0.0:
                raise _invalid_request(f"{key!r} is not supported by cuda:// backends yet")
        key = ("max_completion_tokens" if body.get("max_completion_tokens") is not None
               else "max_tokens")
        max_new = _request_number(body, key, float(self.default_max_tokens))
        if max_new < 1:
            raise _invalid_request(f"Invalid value for {key!r}: must be >= 1")
        prompt = self.tokenizer.render_chat(body.get("messages") or [])
        return {
            "model": effective["model"],
            "prompt_ids": self.tokenizer.encode(prompt),
            "max_new": int(max_new),
            "sampler": _request_sampler(body),
            "seed": int(_request_number(body, "seed", 0.0)),
            "stops": _stop_list(body),
        }

    def _usage(self, n_prompt: int, n_completion: int) -> dict[str, int]:
        return {"prompt_tokens": n_prompt, "completion_tokens": n_completion,
                "total_tokens": n_prompt + n_completion}

    def _submit(self, plan: dict[str, Any], cancel: threading.Event):
        try:
            return self.engine.submit(
                plan["prompt_ids"], max_new_tokens=plan["max_new"], sampler=plan["sampler"],
                seed=plan["seed"], eos_id=self.tokenizer.eos_id, cancel=cancel,
                decode_chunk=self.decode_chunk, member=self.member)
        except QueueFullError as e:
            raise _overloaded(self.name, str(e)) from None

    def _drain(self, plan: dict[str, Any], req, on_text) -> tuple[GenerationResult, int]:
        """Consume one request's tokens, passing each piece of visible text
        to ``on_text``; returns (result, completion tokens)."""
        result = GenerationResult()
        detok = self.tokenizer.detokenizer()
        matcher = _StopMatcher(plan["stops"])
        for t in self.engine.stream_results(req):
            if t == self.tokenizer.eos_id:
                result.finish_reason = "stop"
                break
            result.token_ids.append(t)
            text = matcher.feed(detok.feed(t))
            if text:
                on_text(text)
            if matcher.hit:  # stop string matched: abort decoding now
                result.finish_reason = "stop"
                break
        tail = matcher.feed(detok.flush()) + matcher.flush()
        if tail:
            on_text(tail)
        if matcher.hit:
            result.finish_reason = "stop"
        return result, len(result.token_ids)

    # ---- backend protocol -------------------------------------------------

    async def complete(self, body: dict[str, Any], headers: dict[str, str],
                       timeout: float) -> CompletionResult:
        plan = self._plan(body)
        cancel = threading.Event()
        req = self._submit(plan, cancel)
        pieces: list[str] = []

        def run():
            return self._drain(plan, req, pieces.append)

        task = asyncio.ensure_future(asyncio.to_thread(run))
        try:
            result, n_completion = await asyncio.wait_for(asyncio.shield(task), timeout)
        except asyncio.TimeoutError:
            cancel.set()
            raise _timeout_error(self.name, timeout) from None
        except BackendError:
            raise
        except Exception as e:
            cancel.set()
            logger.exception("cuda backend %s failed", self.name)
            raise BackendError(f"Backend {self.name} failed: {e}") from e
        except BaseException:  # client disconnect / cancellation: free the slot
            cancel.set()
            raise
        resp = oai.completion(content="".join(pieces), model=plan["model"],
                              usage=self._usage(len(plan["prompt_ids"]), n_completion),
                              finish_reason=result.finish_reason)
        resp["backend"] = self.name
        return CompletionResult(backend_name=self.name, status_code=200, body=resp)

    async def stream(self, body: dict[str, Any], headers: dict[str, str],
                     timeout: float) -> AsyncIterator[dict[str, Any]]:
        plan = self._plan(body)
        model = plan["model"]
        chunk_id = oai.new_request_id()
        loop = asyncio.get_running_loop()
        events: asyncio.Queue = asyncio.Queue()
        cancel = threading.Event()
        # Submit BEFORE the first yield: a full queue is a 503 response, not
        # an error chunk inside an already-started 200 stream.
        req = self._submit(plan, cancel)

        def produce():
            try:
                result, n = self._drain(plan, req, lambda text: loop.call_soon_threadsafe(
                    events.put_nowait, ("text", text)))
                loop.call_soon_threadsafe(events.put_nowait, ("end", (result.finish_reason, n)))
            except Exception as e:  # surfaced on the consumer side
                loop.call_soon_threadsafe(events.put_nowait, ("err", e))

        producer = loop.run_in_executor(None, produce)
        deadline = loop.time() + timeout
        n_completion = 0
        try:
            yield oai.chunk(id=chunk_id, model=model, delta={"role": "assistant"})
            ended = False
            while not ended:
                # Drain in batches: one decode chunk delivers its tokens
                # within microseconds of each other; all but the batch's last
                # event are marked MoreChunk so the SSE writer flushes once.
                batch = [await asyncio.wait_for(events.get(), max(0.0, deadline - loop.time()))]
                while not events.empty():
                    batch.append(events.get_nowait())
                for pos, (kind, val) in enumerate(batch):
                    more = pos < len(batch) - 1
                    if kind == "text":
                        out = oai.chunk(id=chunk_id, model=model, delta={"content": val})
                    elif kind == "end":
                        finish, n_completion = val
                        out = oai.chunk(id=chunk_id, model=model, delta={},
                                        finish_reason=finish)
                        ended = True
                    else:
                        raise BackendError(f"Backend {self.name} failed: {val}") from val
                    yield oai.more(out) if more else out
        except asyncio.TimeoutError:
            cancel.set()
            raise _timeout_error(self.name, timeout) from None
        except BaseException:  # client disconnect: free the slot within one chunk
            cancel.set()
            raise
        await producer
        if (body.get("stream_options") or {}).get("include_usage"):
            usage_chunk = oai.chunk(id=chunk_id, model=model, delta={})
            usage_chunk["choices"] = []
            usage_chunk["usage"] = self._usage(len(plan["prompt_ids"]), n_completion)
            yield usage_chunk

    async def aclose(self) -> None:
        return None

