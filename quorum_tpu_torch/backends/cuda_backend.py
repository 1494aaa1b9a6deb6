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
  decode_pipeline= decode-chunk ring depth (default 2): the scheduler keeps
                   up to K decode chunks in flight on the card and blocks
                   only on the oldest, hiding the host's read, detokenize
                   and emit of one chunk behind the next chunk's device
                   time. 1 = synchronous. Tokens are the same at any depth:
                   EOS and budget finishes are detected on the device.
                   Structural: applies when this backend constructs the
                   engine; backends sharing an engine share its depth
  decode_loop=C    megachunk decode (default 1): one dispatch covers up to C
                   decode chunks back to back on the card (in [1, 64],
                   floored to a power of two; clamped per dispatch to 1
                   under admission pressure and to the power-of-two cover
                   of the longest remaining budget). Tokens are the same at
                   any C. Structural like decode_pipeline
  prefill_chunk=   chunked-prefill segment size (default 512, rounded down
                   to a power of two dividing max_seq; 0 = off): prompts
                   longer than this prefill one segment per scheduler turn,
                   with decode chunks in between, so a long admission
                   cannot stall active streams. Structural like
                   decode_pipeline
  prefix_cache=0   disable automatic prefix reuse (default on): a request
                   whose prompt prefix is already resident in a free slot's
                   KV cache admits into that slot and prefills only the
                   suffix — multi-turn histories re-prefill nothing. Needs
                   chunked prefill. A prefix_cache=0 from any backend
                   sharing the engine turns reuse off on it
  seed=            weight-init seed (with ckpt=: an offset of every
                   request's sampling seed; the weights are the checkpoint's)
  device=          torch device (default cuda; cpu runs the plain versions)
  ckpt=DIR         real weights from a local HuggingFace checkpoint
                   directory (config.json + *.safetensors or
                   pytorch_model*.bin; models/hf_loader.py): gpt2, llama,
                   mistral, qwen2, gemma or mixtral. The spec comes from
                   its config.json (dtype= still applies; any other spec
                   override is refused), its tokenizer serves when it
                   ships tokenizer.json / tokenizer_config.json /
                   vocab.json and transformers can load it (else bytes),
                   and the engine's EOS is that tokenizer's. Backends on
                   one checkpoint share its engine; members=, ensemble=,
                   member_seeds= and quorum_dedup= are refused
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
  quant=int8       weight-only int8 with per-channel scales
                   (models/quant.py): every weight product runs int8 × int8
                   → int32 on the card, halving the weight bytes a decode
                   step reads and the weights' memory (mixtral-8x7b: 46.7
                   GB, one H100). With ckpt=, quantized on the card as the
                   checkpoint loads
  kv_quant=int8    int8 KV cache (per-token scales; decode attention reads
                   it natively through K2q8): half the cache memory (at 8B
                   an 8k window drops 1.07 → 0.54 GB per slot) and half the
                   cache bytes a long decode step reads. Composes with
                   quant=; quorum_dedup=1 refuses it
  spec_decode=G    speculative decoding (default 0 = off, at most 16): a
                   verify turn scores up to G draft tokens per row in one
                   multi-token forward, so an accepted run advances G+1
                   tokens for one read of the weights. Drafts come from
                   prompt lookup (the request's own earlier 2-grams; an
                   aggregation prompt quotes the members' answers) unless a
                   draft model is named. Per row: penalties and logprobs
                   rows ride at draft length 0, biased and response_format
                   rows draft (constrained ones through the dfa-verify
                   variant). Verify turns enter the decode_pipeline ring.
                   Greedy or sampled, the tokens equal spec_decode=0's: a
                   draft token is accepted only when it equals the token
                   the model samples there, each token with its own noise
                   draw. Structural (part of the engine key)
  spec_model=<id>  draft-model speculation: the named preset (random init,
  spec_seed=       seeded by spec_seed=, default 0; the target's vocab,
                   window and sliding window) proposes the G-token drafts;
                   its own cache tracks each row, and draft and verify run
                   fused in one graph of up to decode_loop=C turns. Implies
                   spec_decode=4 when spec_decode= is absent (an explicit
                   0 beside a draft is refused); refused beside ckpt= and
                   beside spec_ckpt=
  spec_ckpt=<dir>  draft-model speculation from a local HF checkpoint (same
                   vocabulary as the target; window raised to the
                   target's; the target's dtype). Works with ckpt= and
                   random-init targets; implies spec_decode=4 when unset
  kv_pages=0|1     paged KV slot memory (default 0): the dense
                   [n_slots, max_seq] cache rectangle becomes a page pool
                   + per-row page table — rows hold pages proportional to
                   their actual length, and tier-0 prefix reuse becomes
                   refcounted page aliasing (copy-on-write boundary page).
                   Admission reserves a row's full span up front: pool
                   exhaustion sheds at admission (503 + Retry-After) when
                   the span can never fit, and queues when it fits later,
                   never mid-stream. Decode attention (K2, K2q8) runs on
                   the page-gathered window of each dispatch's history
                   bucket. Structural (part of the engine key); composes
                   with kv_quant=int8, members=M, quorum_dedup=1,
                   response_format and prompt-lookup spec_decode; refused
                   with ensemble>1 and draft-model speculation
  kv_page_size=    tokens per KV page (default: prefill_chunk, else
                   min(64, max_seq)); power of two dividing max_seq
  kv_pool_pages=   physical pages in the pool (default: n_slots × max_seq
                   / page_size, the dense rectangle's worth; set lower to
                   oversubscribe slots)
  prefix_store=host  host-RAM prefix store (default off): released slots'
                   KV prefixes are copied device→host into a
                   chunk-granular trie (byte-budget LRU), and an admission
                   whose store match beats the slot-resident reuse
                   restores the prefix host→device and prefills only the
                   tail. Holds the cache's native representation
                   (kv_quant=int8 halves host bytes). Applies when this
                   backend constructs the engine; refused with members=N
                   and ensemble=, and needs chunked prefill
  prefix_store_bytes=  host byte budget for the store (default 1g); a
                   plain byte count or a k/m/g binary suffix (512m)
  prefix_store_chunk=  store granularity in tokens (default: the
                   engine's prefill_chunk)
  qos=0|1          QoS scheduler (default 0 = FIFO): weighted-fair
                   admission across priority classes (interactive / batch /
                   background — the 'priority' body knob, else derived from
                   the deadline headroom; 'tenant' weights a request within
                   its class), earliest deadline headroom first within a
                   class, the predictive infeasible-deadline shed (503 +
                   Retry-After from the queue evidence), and mid-decode
                   preemption: an interactive admission with no free row
                   parks a lower-class resident row at a scheduler turn,
                   which later resumes token for token behind the replay
                   guard. Not structural: outside the engine key, and an
                   explicit qos=1 from any backend turns it on for the
                   shared engine
  zero_drain=0|1   zero-drain staging (default 0): every admission prefills
                   chunked into a staging cache (the decode cache's dense
                   layout, its bytes again: 2 × layers × slots × kv_heads ×
                   max_seq × head_dim × element size) on a second stream,
                   and its rows are written into the claimed decode row at
                   a turn boundary — the decode_pipeline × decode_loop ring
                   never clamps for an admission
                   (admission_stall_seconds_total stays 0). Tokens equal the
                   drain-based engine's. Tier-0 prefix reuse is off (the
                   host prefix store restores into the staging row).
                   Structural (part of the engine key); requires chunked
                   prefill
  tp=N, sp=N       a multi-rank engine (``parallel/``): tp × sp ranks, rank
  sp_impl=         0 in this process and the others spawned, with
                   device=cpu on the CPU over gloo. On cards (rank r on
                   ``cuda:r``) it is refused for now: fewer cards than ranks
                   is an error naming both counts, and NCCL meshes of
                   several ranks hang (ROADMAP queue 3), so ``make_mesh``
                   refuses them. tp cuts heads, MLP hidden and vocab (Megatron);
                   sp > 1 admits every prompt single-shot, sequence-parallel
                   by ring attention (sp_impl=ring, the default) or Ulysses
                   (sp_impl=ulysses; windowed specs need it). MoE specs,
                   members, ensemble, quant, kv_quant, speculation,
                   kv_pages, prefix_store, zero_drain, ckpt=,
                   response_format, embeddings and scoring are refused on it
                   (not yet on a multi-rank engine)

Any other option is a ValueError naming it, before an engine is built —
including the ``tpu://`` options the port does not serve yet
(``dp=``, ``pp=``, ``disagg=``): a typo or an unported knob never builds an
engine that silently ignores it; ``quant=`` and ``kv_quant=`` values are
checked there too (``int8`` or empty).

On the card every decode dispatch of a one-card or NCCL engine is one
CUDA-graph replay; there is no option that turns graphs (or the kernels)
off. (A mesh whose ranks share a card runs over gloo and decodes eagerly:
only ``parallel.make_mesh(..., backend="gloo")`` builds one.)

Request knobs, as ``tpu://`` serves them: messages, max_tokens /
max_completion_tokens, temperature, top_p, seed, stop, stream (+
stream_options.include_usage), ``n`` (1–8 choices, choice i sampling with
seed + i·7919, usage summed over them), ``logprobs`` + ``top_logprobs``
(0–20; entries aligned with the emitted content under stop strings),
``presence_penalty`` / ``frequency_penalty`` (−2 to 2) and ``logit_bias``
(token id → −100 to 100); the penalties and the bias act inside the decode
program on the card. ``response_format`` ``json_object``, ``json_schema``
and ``regex`` compile (once per grammar and tokenizer, on the request's
thread) to a token DFA that masks every sampled token inside the decode
graphs: a malformed grammar is a 400, one no token sequence can satisfy
a 422 ``grammar_error``, and a full grammar arena a 503. The request's
timeout is the engine's deadline: shed while queued → 503 with
Retry-After, missed after admission → 504; the asyncio wait only backstops
it ``DEADLINE_SLACK_S`` later. ``top_k`` is ignored, as ``tpu://`` ignores
it. ``tools`` is a 400, never silently ignored.

Stream resume, as ``tpu://`` serves it: a streamed request with
``resume_tokens`` (the ids a client already received; n = 1, no logprobs,
no longer than the budget) regenerates them behind the engine's replay
guard and streams only what follows, rendered through a fresh detokenizer
and stop matcher fed the journal first; ``resume_chars`` must equal the
journal's rendered length, and a stop string inside the journal is a
divergence (the error chunk's ``qt_error`` is ``resume_diverged``).
``stream_token_ids: true`` ships each chunk's token ids as ``qt_tokens``.
A request a draining engine parks ends ``finish_reason: "parked"`` when
streamed and is a retryable 503 when not.

Besides chat: ``embed`` (``/embeddings``: mean-pooled final-norm hidden
states, ``engine/embed.py``) and ``text_complete`` (legacy
``/completions``: raw-prompt generation through the chat plan, and the
``echo`` + ``logprobs`` scoring mode, ``engine/score.py``), with the
``tpu://`` backend's grammar, limits and messages. Their forwards pass a
per-engine gate of ``SCORE_GATE_SLOTS``; a saturated gate is a 503.
"""

from __future__ import annotations

import asyncio
import base64
import dataclasses
import logging
import math
import os
import struct
import threading
import time
import uuid
from typing import Any, AsyncIterator

import torch

from quorum_tpu_torch import oai
from quorum_tpu_torch import observability as obs
from quorum_tpu_torch.backends.base import BackendError, CompletionResult, prepare_body
from quorum_tpu_torch.config import BackendSpec
from quorum_tpu_torch.engine.engine import (
    CKPT_MEMBERS_ERROR,
    DEFAULT_DECODE_CHUNK,
    DEFAULT_DECODE_LOOP,
    DEFAULT_DECODE_PIPELINE,
    DEFAULT_MAX_PENDING,
    DEFAULT_PREFILL_CHUNK,
    DEFAULT_SLOTS,
    DeadlineExceeded,
    EngineBreakerOpen,
    GenerationResult,
    GrammarArenaFull,
    QueueFullError,
    ReplayDivergence,
    check_quant_knobs,
    get_engine,
    get_engine_from_ckpt,
    resolve_decode_loop,
)
from quorum_tpu_torch.engine.tokenizer import get_tokenizer
from quorum_tpu_torch.models.model_config import ModelSpec, resolve_spec
from quorum_tpu_torch.ops.sampling import SamplerConfig

logger = logging.getLogger(__name__)

# URL options a cuda:// backend serves, besides the ModelSpec fields.
_OPTIONS = frozenset({
    "slots", "decode_chunk", "decode_pipeline", "decode_loop", "prefill_chunk",
    "prefix_cache", "seed", "device", "queue", "max_tokens", "members", "member",
    "member_seeds", "quorum_dedup", "ensemble", "ckpt", "quant", "kv_quant",
    "spec_decode", "spec_model", "spec_ckpt", "spec_seed", "kv_pages", "kv_page_size",
    "kv_pool_pages", "prefix_store", "prefix_store_bytes", "prefix_store_chunk", "qos",
    "zero_drain", "tp", "sp", "sp_impl"})
_SPEC_FIELDS = frozenset(f.name for f in dataclasses.fields(ModelSpec))
# Options of the JAX package's tpu:// backend (TpuBackend.from_spec) that
# the port does not serve yet.
_NOT_YET = frozenset({"disagg", "dp", "pp"})


def _check_options(opts: dict[str, str]) -> None:
    """Refuse every URL option outside the port's known set, naming it."""
    for key in opts:
        if key in _OPTIONS or key in _SPEC_FIELDS:
            continue
        if key == "flash_decode":
            raise ValueError(
                "cuda:// does not serve the flash_decode= option, and will not: "
                "decode attention always runs its kernel on the card (the plain "
                "version only on the CPU), and no option turns a kernel off")
        if key in _NOT_YET:
            raise ValueError(f"cuda:// does not serve the {key}= option yet "
                             "(the tpu:// backend does)")
        raise ValueError(f"unknown cuda:// option {key}=")


def _url_mesh(opts: dict[str, str]):
    """``tp=``/``sp=`` (``sp_impl=``) → a ``parallel/mesh.Mesh``, or None
    for one rank. With ``device=cpu`` the ranks run on the CPU over gloo.
    On cards they would take ``cuda:0..N−1`` over NCCL: fewer cards than
    ranks is an error naming both counts, and ``make_mesh`` refuses an
    NCCL mesh of several ranks (an open fault)."""
    from quorum_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    tp, sp = int(opts.get("tp", 1)), int(opts.get("sp", 1))
    if tp < 1 or sp < 1:
        raise ValueError(f"invalid tp={tp} sp={sp} (each must be >= 1)")
    n = tp * sp
    if n == 1:
        return None
    dev = torch.device(opts.get("device") or "cuda")
    if dev.type == "cpu":
        return make_mesh(MeshConfig(tp=tp, sp=sp), ["cpu"] * n)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise ValueError(
            f"tp={tp} x sp={sp} needs {n} CUDA devices (one per rank), this machine has "
            f"{have}")
    return make_mesh(MeshConfig(tp=tp, sp=sp), [f"cuda:{i}" for i in range(n)])


def _check_ckpt_options(opts: dict[str, str], members: int, member_seeds: str,
                        quorum_dedup: bool) -> None:
    """A ``ckpt=`` URL takes its ModelSpec from the checkpoint's
    ``config.json`` and holds one weight set: spec overrides other than
    ``dtype=`` and the stacked-member knobs are refused, naming them (the
    tpu:// backend ignores the overrides)."""
    for key in opts:
        if key in _SPEC_FIELDS and key != "dtype":
            raise ValueError(
                f"cuda:// ckpt= backends take the model spec from the checkpoint's "
                f"config.json: the {key}= override does not apply (dtype= does)")
    if members > 1:
        raise ValueError(f"members=N does not apply to ckpt= backends "
                         f"({CKPT_MEMBERS_ERROR}; use seed= for sampling diversity)")
    if member_seeds != "distinct" or quorum_dedup:
        raise ValueError(
            "member_seeds=/quorum_dedup= do not apply to ckpt= "
            "backends: they configure the stacked members=N init, "
            "and members=N does not apply to ckpt= (one loaded "
            "weight set; use seed= for sampling diversity)")


def _check_spec_options(ckpt: str, spec_model: str, spec_ckpt: str) -> None:
    """The tpu:// backend's refusals of the draft knobs, word for word,
    before any weights load."""
    if spec_model and ckpt:
        raise ValueError(
            "spec_model= (a random-init draft) would draft for real "
            "ckpt= weights with ~0 acceptance — pure overhead; point "
            "spec_ckpt= at a small same-tokenizer checkpoint instead")
    if spec_model and spec_ckpt:
        raise ValueError("spec_model= and spec_ckpt= are mutually "
                         "exclusive draft sources")
    if spec_ckpt and not os.path.exists(os.path.join(spec_ckpt, "config.json")):
        raise ValueError(
            f"spec_ckpt={spec_ckpt!r} is not a checkpoint dir "
            "(no config.json)")


class _DrainParked(RuntimeError):
    """A draining engine parked this request mid-generation. A stream
    finishes ``"parked"`` (a router resumes it from its journal); a
    non-streamed request has no journal, so its partial text becomes a
    retryable 503, never a truncated 200."""


def _reject_mixed(items: list, field: str) -> None:
    """The OpenAI schemas take a list of strings OR a list of token arrays,
    never a mix."""
    if (any(isinstance(x, str) for x in items)
            and any(isinstance(x, list) for x in items)):
        raise _invalid_request(f"'{field}' must not mix strings and token arrays")


def _top_dict(pairs) -> dict[str, float]:
    """Legacy ``top_logprobs`` dict keyed by token TEXT; distinct ids can
    decode to the same text, and the first (highest) logprob wins."""
    out: dict[str, float] = {}
    for text, lp in pairs:
        if text not in out:
            out[text] = float(lp)
    return out


def _token_ids_ok(x: Any, vocab: int) -> bool:
    """A non-empty list of in-vocabulary int ids (bools are not ids)."""
    return isinstance(x, list) and bool(x) and all(
        isinstance(t, int) and not isinstance(t, bool) and 0 <= t < vocab for t in x)


def _invalid_request(message: str) -> BackendError:
    return BackendError(message, status_code=400,
                        body=oai.error_body(message, type_="invalid_request_error", code=400))


def _overloaded(name: str, why: str, retry_after: float = 1.0) -> BackendError:
    msg = f"Backend {name} is overloaded: {why}; retry later"
    return BackendError(msg, status_code=503,
                        body=oai.error_body(msg, type_="overloaded_error", code=503),
                        headers={"Retry-After": str(max(1, math.ceil(retry_after)))})


def _breaker_open(name: str, e: EngineBreakerOpen) -> BackendError:
    """503 + Retry-After while the engine's failure breaker rejects new
    admissions (repeated failed scheduler turns)."""
    return _overloaded(name, f"engine circuit breaker is open ({e})", retry_after=e.retry_after)


def _grammar_unsatisfiable(name: str, e: Exception) -> BackendError:
    """422 grammar_error: the grammar compiled but admits no completion
    under this backend's tokenizer (the request was well-formed; the
    grammar and tokenizer pair cannot be served)."""
    msg = f"Backend {name} cannot satisfy response_format: {e}"
    return BackendError(msg, status_code=422,
                        body=oai.error_body(msg, type_="grammar_error", code=422))


def _deadline_error(name: str, e: DeadlineExceeded) -> BackendError:
    """An engine deadline miss on the HTTP contract: shed from the queue
    (never served) → 503 + Retry-After, safe to retry elsewhere; cancelled
    after admission → 504, the work is lost."""
    if e.stage == "queue":
        return _overloaded(name, "request deadline expired before admission (shed)")
    msg = f"Backend {name} deadline exceeded during {e.stage}; partial work discarded"
    return BackendError(msg, status_code=504,
                        body=oai.error_body(msg, type_="timeout_error", code=504),
                        headers={"Retry-After": "1"})


def _timeout_error(name: str, timeout: float) -> BackendError:
    """The asyncio-side wait outlived the backend timeout (the backstop
    behind the engine's deadline): a 504, counted as a backend-stage
    deadline miss."""
    obs.DEADLINE_EXCEEDED.inc(stage="backend")
    msg = f"Backend {name} timed out after {timeout}s"
    return BackendError(msg, status_code=504,
                        body=oai.error_body(msg, type_="timeout_error", code=504),
                        headers={"Retry-After": "1"})


def _parse_bytes_opt(name: str, raw: str) -> int:
    """Byte-count URL option: a plain integer or a k/m/g binary suffix
    (``prefix_store_bytes=512m``), as ``tpu://`` parses it."""
    val = str(raw).strip().lower()
    mult = 1
    if val and val[-1] in "kmg":
        mult = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30}[val[-1]]
        val = val[:-1]
    try:
        out = int(val) * mult
    except ValueError:
        raise ValueError(
            f"invalid {name}={raw!r} (an integer byte count, optionally "
            "with a k/m/g suffix)") from None
    if out < 1:
        raise ValueError(f"invalid {name}={raw!r} (must be positive)")
    return out


def _store_knobs(opts: dict[str, str], members: int) -> dict:
    """The ``prefix_store*`` options as engine knobs, with ``tpu://``'s
    checks and words."""
    store = str(opts.get("prefix_store", "")).strip().lower()
    if store in ("", "0", "none", "off"):
        store = ""
    elif store != "host":
        raise ValueError(
            f"invalid prefix_store={opts.get('prefix_store')!r} "
            "(host, or none/0/off to disable)")
    if not store:
        if "prefix_store_bytes" in opts or "prefix_store_chunk" in opts:
            raise ValueError(
                "prefix_store_bytes=/prefix_store_chunk= have no effect "
                "without prefix_store=host — a silently ignored sizing "
                "knob hides a misconfiguration")
        return {}
    if members > 1:
        raise ValueError(
            "prefix_store=host does not compose with members=N "
            "(the stacked cache carries a member axis the "
            "snapshot/restore programs do not address) — run "
            "separate engines or drop prefix_store")
    knobs = {"prefix_store": store,
             "prefix_store_chunk": int(opts.get("prefix_store_chunk", 0))}
    if "prefix_store_bytes" in opts:
        knobs["prefix_store_bytes"] = _parse_bytes_opt("prefix_store_bytes",
                                                       opts["prefix_store_bytes"])
    return knobs


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
    """OpenAI knobs → the on-device sampler: temperature and top_p with
    2-decimal quantization, as the JAX backend does. ``top_k`` is not an
    OpenAI knob and the JAX backend ignores it; so does this one."""
    return SamplerConfig(temperature=round(_request_number(body, "temperature", 1.0), 2),
                         top_p=round(_request_number(body, "top_p", 1.0), 2))


def _stop_list(body: dict[str, Any]) -> list[str]:
    stop = body.get("stop")
    if stop is None:
        return []
    if isinstance(stop, str):
        return [stop]
    if isinstance(stop, list):
        return [s for s in stop if isinstance(s, str)]
    raise _invalid_request(f"Invalid value for 'stop': {stop!r}")


def _set_all(events: list[threading.Event]) -> None:
    for e in events:
        e.set()


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
    # Request fields a local model cannot honor: a 400, never a silent ignore.
    _UNSUPPORTED = ("tools", "tool_choice", "functions", "function_call")
    MAX_N = 8
    # Distinct sampling streams per choice when n > 1: choice i samples with
    # the request's seed + i·CHOICE_SEED_STRIDE.
    CHOICE_SEED_STRIDE = 7919
    # Slack the asyncio-side wait keeps beyond the engine-enforced deadline:
    # the scheduler's sweep is the enforcement (within one decode dispatch);
    # the wait only backstops a wedged scheduler.
    DEADLINE_SLACK_S = 2.0

    def __init__(self, name: str, engine, *, model: str = "", model_id: str = "",
                 default_max_tokens: int = 64, decode_chunk: int | None = None,
                 member: int = 0, tokenizer_path: str | None = None, rng_offset: int = 0):
        self.name = name
        self.engine = engine
        # Stacked-members engine: which of the engine's weight sets serves
        # this backend's requests (0 on ordinary engines).
        self.member = member
        self.model_id = model_id or "cuda-model"
        self.model = model or self.model_id
        self.default_max_tokens = default_max_tokens
        self.decode_chunk = decode_chunk  # None → engine default
        # ckpt= backends sharing one checkpoint's weights differ by seed=,
        # which offsets every request's sampling seed.
        self.rng_offset = rng_offset
        self.tokenizer = get_tokenizer(engine.spec.vocab_size, tokenizer_path)

    @classmethod
    def from_spec(cls, bspec: BackendSpec) -> "CudaBackend":
        opts = bspec.options
        _check_options(opts)
        members = int(opts.get("members", 1))
        member = int(opts.get("member", 0))
        if not 0 <= member < max(1, members):
            raise ValueError(f"member={member} out of range for members={members}")
        knobs = dict(
            device=opts.get("device"),
            n_slots=int(opts.get("slots", DEFAULT_SLOTS)),
            decode_chunk=int(opts.get("decode_chunk", DEFAULT_DECODE_CHUNK)),
            decode_pipeline=int(opts.get("decode_pipeline", DEFAULT_DECODE_PIPELINE)),
            decode_loop=resolve_decode_loop(int(opts.get("decode_loop", DEFAULT_DECODE_LOOP))),
            prefill_chunk=int(opts.get("prefill_chunk", DEFAULT_PREFILL_CHUNK)),
            prefix_cache=_parse_bool_opt("prefix_cache", opts.get("prefix_cache", "1")),
            max_pending=int(opts.get("queue", DEFAULT_MAX_PENDING)),
            ensemble=int(opts.get("ensemble", 1)),
            kv_pages=_parse_bool_opt("kv_pages", opts.get("kv_pages", "0")),
            kv_page_size=int(opts.get("kv_page_size", 0)),
            kv_pool_pages=int(opts.get("kv_pool_pages", 0)),
            qos=_parse_bool_opt("qos", opts.get("qos", "0")),
            zero_drain=_parse_bool_opt("zero_drain", opts.get("zero_drain", "0")))
        knobs.update(_store_knobs(opts, members))
        knobs["quant"], knobs["kv_quant"] = check_quant_knobs(opts.get("quant") or None,
                                                              opts.get("kv_quant") or None)
        member_seeds = opts.get("member_seeds", "distinct")
        quorum_dedup = _parse_bool_opt("quorum_dedup", opts.get("quorum_dedup", "0"))
        tokenizer_path, rng_offset = None, 0
        ckpt = opts.get("ckpt", "")
        spec_model, spec_ckpt = opts.get("spec_model", ""), opts.get("spec_ckpt", "")
        _check_spec_options(ckpt, spec_model, spec_ckpt)
        # A draft implies speculation: g = 4 unless spec_decode= says
        # otherwise (an explicit 0 beside a draft is the engine's refusal).
        knobs["spec_decode"] = int(opts.get(
            "spec_decode", "4" if (spec_model or spec_ckpt) else "0"))
        if spec_ckpt:
            knobs["draft_ckpt"] = spec_ckpt
        if ckpt:
            _check_ckpt_options(opts, members, member_seeds, quorum_dedup)
            if _url_mesh(opts) is not None:
                raise ValueError("ckpt= with tp=/sp=: a checkpoint's weights are not yet on "
                                 "a multi-rank engine")
            engine = get_engine_from_ckpt(ckpt, dtype=opts.get("dtype"), **knobs)
            # The checkpoint's tokenizer when it ships one (bytes when it
            # cannot load, e.g. without transformers).
            if any(os.path.exists(os.path.join(ckpt, f))
                   for f in ("tokenizer.json", "tokenizer_config.json", "vocab.json")):
                tokenizer_path = ckpt
            rng_offset = int(opts.get("seed", 0))
        else:
            spec = resolve_spec(bspec.model_id, opts)
            if spec_model:
                # The draft runs the target's vocabulary and window: drafted
                # ids must be the target's, the draft cache must reach every
                # target position, and its attention span is the target's.
                knobs["draft_spec"] = resolve_spec(spec_model, {
                    "max_seq": str(spec.max_seq), "vocab_size": str(spec.vocab_size),
                    "sliding_window": str(spec.sliding_window)})
                knobs["draft_seed"] = int(opts.get("spec_seed", 0))
            mesh = _url_mesh(opts)
            if mesh is not None:
                knobs["device"] = None
            engine = get_engine(
                spec, seed=int(opts.get("seed", 0)),
                members=members, member_seeds=member_seeds, quorum_dedup=quorum_dedup,
                mesh=mesh, sp_impl=opts.get("sp_impl", "ring"), **knobs)
        return cls(bspec.name, engine, model=bspec.model, model_id=bspec.model_id,
                   default_max_tokens=int(opts.get("max_tokens", 64)),
                   decode_chunk=int(opts["decode_chunk"]) if "decode_chunk" in opts else None,
                   member=member, tokenizer_path=tokenizer_path, rng_offset=rng_offset)

    # ---- the embedding and scoring gate ----------------------------------

    def _acquire_score_slot(self) -> None:
        """Admit one embedding or scoring forward or raise a 503: the gate
        (``engine.score_gate``) is the engine's, shared by every backend on
        it, and bounds the device work these forwards add beside decode."""
        if not self.engine.score_gate.acquire(blocking=False):
            raise _overloaded(self.name, "scoring/embedding gate saturated")

    def _release_score_slot(self) -> None:
        self.engine.score_gate.release()

    async def _shielded_to_thread(self, fn, timeout: float):
        """Run ``fn`` on a thread the event loop cannot cancel: it runs
        exactly once even when the wait times out or the client goes (its
        own ``finally`` always runs). Raises asyncio.TimeoutError on expiry
        while the device work continues."""
        task = asyncio.create_task(asyncio.to_thread(fn))
        task.add_done_callback(lambda t: t.cancelled() or t.exception())
        return await asyncio.wait_for(asyncio.shield(task), timeout=timeout)

    async def _gated_to_thread(self, fn, timeout: float):
        """A gated forward: take a slot (503 when saturated), run ``fn``
        shielded, and free the slot when the DEVICE work ends, not when the
        client's wait does."""
        self._acquire_score_slot()

        def gated():
            try:
                return fn()
            finally:
                self._release_score_slot()

        # No await between the acquire and the task's creation: no
        # cancellation point can leak the slot.
        return await self._shielded_to_thread(gated, timeout)

    # ---- request plumbing -------------------------------------------------

    def _plan(self, body: dict[str, Any]) -> dict[str, Any]:
        effective = prepare_body(body, self.model)
        for key in self._UNSUPPORTED:
            if body.get(key):
                raise _invalid_request(f"{key!r} is not supported by cuda:// backends")
        grammar = self._plan_grammar(body.get("response_format"))
        # Explicit JSON null means "unset" for every optional knob.
        n = body.get("n")
        if n is None:
            n = 1
        if not isinstance(n, int) or isinstance(n, bool) or not 1 <= n <= self.MAX_N:
            raise _invalid_request(
                f"Invalid value for 'n': {n!r} (must be an integer in [1, {self.MAX_N}])")
        want_lp = body.get("logprobs")
        if want_lp is None:
            want_lp = False
        if not isinstance(want_lp, bool):
            raise _invalid_request(f"Invalid value for 'logprobs': {want_lp!r}")
        top_lp = body.get("top_logprobs")
        if top_lp is None:
            top_lp = 0
        if not isinstance(top_lp, int) or isinstance(top_lp, bool) or not 0 <= top_lp <= 20:
            raise _invalid_request(
                f"Invalid value for 'top_logprobs': {top_lp!r} (must be an integer in [0, 20])")
        if top_lp and not want_lp:
            raise _invalid_request("'top_logprobs' requires 'logprobs' to be true")
        pp = _request_number(body, "presence_penalty", 0.0)
        fp = _request_number(body, "frequency_penalty", 0.0)
        for key, val in (("presence_penalty", pp), ("frequency_penalty", fp)):
            if not -2.0 <= val <= 2.0:
                raise _invalid_request(f"Invalid value for {key!r}: {val!r} (must be in [-2, 2])")
        key = ("max_completion_tokens" if body.get("max_completion_tokens") is not None
               else "max_tokens")
        max_new = _request_number(body, key, float(self.default_max_tokens))
        if max_new < 1:
            raise _invalid_request(f"Invalid value for {key!r}: must be >= 1")
        vocab = self.engine.spec.vocab_size
        # The legacy /completions path sets raw prompt ids (no template); the
        # app strips the field from the wire.
        raw_ids = body.get("_raw_prompt_ids")
        if raw_ids is not None:
            if not _token_ids_ok(raw_ids, vocab):
                raise _invalid_request(
                    "prompt token ids must be a non-empty list of in-vocab integers")
            ids = list(raw_ids)
        else:
            ids = self.tokenizer.encode(self.tokenizer.render_chat(body.get("messages") or []))
        # Stream resume: the edge checked the shapes (oai.validate_request_body);
        # the vocabulary and the budget are checked here.
        rt = body.get("resume_tokens")
        if rt is not None:
            if not _token_ids_ok(rt, vocab):
                raise _invalid_request(
                    "'resume_tokens' must be a non-empty list of in-vocab token ids")
            if n != 1:
                raise _invalid_request("'resume_tokens' requires n=1")
            if want_lp:
                raise _invalid_request("'resume_tokens' cannot be combined with 'logprobs'")
            if len(rt) > int(max_new):
                raise _invalid_request(
                    f"'resume_tokens' ({len(rt)} ids) exceeds the completion budget "
                    f"({int(max_new)})")
        rc = body.get("resume_chars")
        return {
            "model": effective["model"],
            "prompt_ids": ids,
            "max_new": int(max_new),
            "sampler": _request_sampler(body),
            "seed": int(_request_number(body, "seed", 0.0)) + self.rng_offset,
            "stops": _stop_list(body),
            "n": n,
            "logprobs": top_lp if want_lp else -1,
            "presence_penalty": pp,
            "frequency_penalty": fp,
            "logit_bias": self._bias_row(body.get("logit_bias")),
            "grammar": grammar,
            # QoS knobs (checked at the edge and by engine.submit); inert
            # unless the engine runs qos=1.
            "priority": body.get("priority"),
            "tenant": body.get("tenant"),
            "resume_tokens": list(rt) if rt else None,
            "resume_chars": int(rc) if rc is not None else None,
            # Ship each chunk's token ids (``qt_tokens``) for a resume journal.
            "stream_token_ids": bool(body.get("stream_token_ids")),
        }

    def _plan_grammar(self, rf: Any):
        """``response_format`` → a compiled token-DFA grammar (None for
        text), as ``tpu://`` plans it: compiled once per (grammar,
        tokenizer), malformed or unsupported grammars a 400, a grammar no
        token sequence can satisfy under this tokenizer a 422."""
        if rf is None:
            return None
        if not isinstance(rf, dict):
            raise _invalid_request(f"Invalid value for 'response_format': {rf!r}")
        if rf.get("type") in (None, "text"):
            return None
        from quorum_tpu_torch.constrain import (GrammarError, GrammarUnsatisfiable,
                                                compile_response_format)

        if getattr(self.engine, "mesh", None) is not None:
            raise _invalid_request(
                "response_format constrained decoding is not yet on a multi-rank engine "
                "(tp=/sp= backends)")

        if self.engine.prefill_chunk <= 0:
            raise _invalid_request(
                "response_format constrained decoding requires chunked "
                "prefill (prefill_chunk >= 16), which this backend's "
                "engine disables (prefill_chunk=0)")
        try:
            grammar = compile_response_format(rf, self.tokenizer, self.engine.spec.vocab_size)
        except GrammarUnsatisfiable as e:
            raise _grammar_unsatisfiable(self.name, e) from None
        except GrammarError as e:
            raise _invalid_request(f"Invalid 'response_format': {e}") from None
        obs.CONSTRAINED_REQUESTS.inc()
        return grammar

    def _bias_row(self, logit_bias: Any) -> torch.Tensor | None:
        """OpenAI ``logit_bias`` ({token id: -100..100}) → a dense ``[V]``
        f32 row on the host (None when empty)."""
        if not logit_bias:
            return None
        if not isinstance(logit_bias, dict):
            raise _invalid_request(f"Invalid value for 'logit_bias': {logit_bias!r}")
        vocab = self.engine.spec.vocab_size
        row = torch.zeros((vocab,), dtype=torch.float32)
        for tok, bias in logit_bias.items():
            try:
                idx, val = int(tok), float(bias)
            except (TypeError, ValueError):
                raise _invalid_request(f"Invalid logit_bias entry: {tok!r}: {bias!r}") from None
            if not 0 <= idx < vocab:
                raise _invalid_request(
                    f"logit_bias token id {idx} outside vocabulary [0, {vocab})")
            if not -100.0 <= val <= 100.0:
                raise _invalid_request(f"logit_bias value {val} outside [-100, 100]")
            row[idx] = val
        return row

    def _usage(self, n_prompt: int, n_completion: int) -> dict[str, int]:
        return {"prompt_tokens": n_prompt, "completion_tokens": n_completion,
                "total_tokens": n_prompt + n_completion}

    def _submit_choice(self, plan: dict[str, Any], idx: int, cancel: threading.Event,
                       deadline: float | None):
        return self.engine.submit(
            plan["prompt_ids"], max_new_tokens=plan["max_new"], sampler=plan["sampler"],
            seed=plan["seed"] + idx * self.CHOICE_SEED_STRIDE, eos_id=self.tokenizer.eos_id,
            cancel=cancel, decode_chunk=self.decode_chunk, member=self.member,
            presence_penalty=plan["presence_penalty"],
            frequency_penalty=plan["frequency_penalty"], logit_bias=plan["logit_bias"],
            logprobs=plan["logprobs"], deadline=deadline, grammar=plan["grammar"],
            priority=plan.get("priority"), tenant=plan.get("tenant"),
            # n == 1 whenever a journal is set: only choice 0 carries one.
            resume_tokens=plan.get("resume_tokens") if idx == 0 else None)

    def _submit_all(self, plans: list[dict[str, Any]], cancels: list[threading.Event],
                    deadline: float) -> list:
        """Submit every choice (one plan with n choices, or one choice per
        plan) with the engine deadline ``deadline``; a full queue, a
        draining engine, an open failure breaker or an expired deadline is
        a 503 before any response starts, an engine ``ValueError`` (a
        resume journal past the budget) a 400 (choices already queued are
        cancelled)."""
        pairs = ([(plans[0], i) for i in range(plans[0]["n"])] if len(plans) == 1
                 else [(p, 0) for p in plans])
        try:
            return [self._submit_choice(p, i, c, deadline) for (p, i), c in zip(pairs, cancels)]
        except QueueFullError as e:
            _set_all(cancels)
            raise _overloaded(self.name, str(e) or "admission queue full",
                              retry_after=getattr(e, "retry_after", 1.0)) from None
        except EngineBreakerOpen as e:
            _set_all(cancels)
            raise _breaker_open(self.name, e) from None
        except DeadlineExceeded as e:
            _set_all(cancels)
            raise _deadline_error(self.name, e) from None
        except ValueError as e:
            _set_all(cancels)
            raise _invalid_request(str(e)) from None

    def _lp_entry(self, tid: int, record, top_n: int) -> dict[str, Any]:
        """One OpenAI ``logprobs.content[]`` element from an engine record
        (non-finite values never reach the JSON)."""
        def tok_obj(t, lp):
            text = self.tokenizer.decode([int(t)])
            lp = float(lp)
            return {"token": text, "logprob": lp if math.isfinite(lp) else -9999.0,
                    "bytes": list(text.encode("utf-8"))}

        lp, top_ids, top_lps = record
        entry = tok_obj(tid, lp)
        entry["top_logprobs"] = [tok_obj(t, v) for t, v in zip(top_ids[:top_n], top_lps[:top_n])
                                 if math.isfinite(float(v))]
        return entry

    @staticmethod
    def _take_aligned(pending: list, n_chars: int) -> list:
        """Pop the pending logprob entries covering ``n_chars`` of emitted
        text: an entry ships exactly when its token's text ships (one
        straddling the boundary ships with the text holding its first
        character; entries of text the stop matcher swallows never ship)."""
        out, used = [], 0
        while pending and used < n_chars:
            e = pending.pop(0)
            out.append(e)
            used += len(e["token"])
        return out

    def _drain(self, plan: dict[str, Any], req, on_text,
               resume: list[int] | None = None) -> GenerationResult:
        """Consume one choice's tokens, passing each piece of visible text,
        its logprob entries (None without ``logprobs``) and the token ids
        consumed since the last piece to ``on_text(text, entries, ids)``.
        Without a stop hit, entries the text did not cover (a split UTF-8
        character decodes longer alone than in context) ship last with
        empty text. ``resume``: the journal of a resumed stream, fed to the
        detokenizer and the stop matcher first so the continuation renders
        exactly where the delivered text stopped (a stop string inside it,
        or a rendered length other than ``resume_chars``, is a
        :class:`ReplayDivergence`). A parked request finishes ``"parked"``
        with its detokenizer tail held back: the resumed stream renders it."""
        result = GenerationResult()
        detok = self.tokenizer.detokenizer()
        matcher = _StopMatcher(plan["stops"])
        want_lp, top_n = plan["logprobs"] >= 0, max(0, plan["logprobs"])
        pending: list = []
        ids: list[int] = []

        def emit(text: str) -> None:
            taken, ids[:] = list(ids), []
            on_text(text, self._take_aligned(pending, len(text)) if want_lp else None, taken)

        if resume:
            prefix = "".join(matcher.feed(detok.feed(t)) for t in resume)
            want = plan["resume_chars"]
            if matcher.hit or (want is not None and len(prefix) != want):
                why = ", stop string inside the journal" if matcher.hit else ""
                raise ReplayDivergence(len(resume), message=(
                    "resume replay diverged before admission: journal renders "
                    f"{len(prefix)} chars (client received {want}{why})"))
        for i, t in enumerate(self.engine.stream_results(req)):
            if t == self.tokenizer.eos_id:
                result.finish_reason = "stop"
                break
            result.token_ids.append(t)
            ids.append(t)
            if want_lp and i < len(req.lp):
                pending.append(self._lp_entry(t, req.lp[i], top_n))
            text = matcher.feed(detok.feed(t))
            if text:
                emit(text)
            if matcher.hit:  # stop string matched: abort decoding now
                break
        if getattr(req, "parked", False):
            result.finish_reason = "parked"
            return result
        tail = matcher.feed(detok.flush()) + matcher.flush()
        if tail:
            emit(tail)
        if matcher.hit:
            result.finish_reason = "stop"
        elif pending:
            on_text("", pending, [])
        return result

    def _consume(self, plan: dict[str, Any], req) -> tuple:
        """One non-streamed choice: (result, text, logprob entries or
        None). A parked request raises :class:`_DrainParked`."""
        pieces: list[str] = []
        entries: list = []

        def on_text(text, lp, _ids):
            pieces.append(text)
            entries.extend(lp or ())

        result = self._drain(plan, req, on_text)
        if result.finish_reason == "parked":
            raise _DrainParked("request parked by a draining engine before completion")
        return result, "".join(pieces), entries if plan["logprobs"] >= 0 else None

    # ---- backend protocol -------------------------------------------------

    async def _generate(self, plans: list[dict[str, Any]], timeout: float,
                        deadline: float) -> list:
        """Submit ``plans`` (one plan's n choices, or one choice per plan)
        and wait, on a thread the event loop cannot cancel, for each
        choice's ``(result, text, logprobs)`` until ``deadline`` plus
        ``DEADLINE_SLACK_S``. The engine's failures become the backend's
        errors (``timeout`` is the request's budget, for their words), and
        every exit but success frees the choices' slots."""
        n = plans[0]["n"] if len(plans) == 1 else len(plans)
        # One cancel event PER choice: stream_results sets its request's
        # event when that choice finishes, which must not end its siblings.
        cancels = [threading.Event() for _ in range(n)]
        reqs = self._submit_all(plans, cancels, deadline)

        def run():
            return [self._consume(plans[i if len(plans) > 1 else 0], r)
                    for i, r in enumerate(reqs)]

        try:
            # A span over the whole generation (submit to the last token
            # drained): the engine's queue-wait, prefill and decode spans
            # nest inside it on /debug/traces.
            with obs.trace_span(obs.current_trace(), "backend-generate", backend=self.name,
                                choices=n,
                                prompt_tokens=sum(len(p["prompt_ids"]) for p in plans)):
                return await self._shielded_to_thread(
                    run, max(0.0, deadline - time.monotonic()) + self.DEADLINE_SLACK_S)
        except asyncio.TimeoutError:
            _set_all(cancels)
            raise _timeout_error(self.name, timeout) from None
        except DeadlineExceeded as e:
            _set_all(cancels)
            raise _deadline_error(self.name, e) from None
        except GrammarArenaFull as e:
            _set_all(cancels)
            raise _overloaded(self.name, str(e)) from None
        except _DrainParked:
            # No journal without a stream: the router re-places the request.
            _set_all(cancels)
            raise _overloaded(self.name, "replica is draining (request parked)") from None
        except BackendError:
            raise
        except Exception as e:
            _set_all(cancels)
            logger.exception("cuda backend %s failed", self.name)
            raise BackendError(f"Backend {self.name} failed: {e}") from e
        except BaseException:  # client disconnect / cancellation: free the slots
            _set_all(cancels)
            raise

    async def complete(self, body: dict[str, Any], headers: dict[str, str],
                       timeout: float) -> CompletionResult:
        plan = self._plan(body)
        outs = await self._generate([plan], timeout, time.monotonic() + timeout)
        resp = oai.completion(
            content=outs[0][1], model=plan["model"],
            usage=self._usage(len(plan["prompt_ids"]),
                              sum(r.completion_tokens for r, _, _ in outs)),
            finish_reason=outs[0][0].finish_reason)
        choices = []
        for i, (result, text, lp) in enumerate(outs):
            choice = {"index": i, "message": {"role": "assistant", "content": text},
                      "finish_reason": result.finish_reason}
            if lp is not None:
                choice["logprobs"] = {"content": lp, "refusal": None}
            choices.append(choice)
        resp["choices"] = choices
        resp["backend"] = self.name
        return CompletionResult(backend_name=self.name, status_code=200, body=resp)

    async def stream(self, body: dict[str, Any], headers: dict[str, str],
                     timeout: float) -> AsyncIterator[dict[str, Any]]:
        plan = self._plan(body)
        model, n = plan["model"], plan["n"]
        chunk_id = oai.new_request_id()
        loop = asyncio.get_running_loop()
        events: asyncio.Queue = asyncio.Queue()
        counts, finishes = [0] * n, ["length"] * n
        cancels = [threading.Event() for _ in range(n)]
        # Submit BEFORE the first yield: a full queue or an expired deadline
        # is a 503 response, not an error chunk inside a started 200 stream.
        reqs = self._submit_all([plan], cancels, time.monotonic() + timeout)

        def put(*event):
            loop.call_soon_threadsafe(events.put_nowait, event)

        def produce(idx: int, req):
            """Drain one choice; events are (kind, choice index, payload)."""
            try:
                result = self._drain(
                    plan, req, lambda text, lp, ids: put("text", idx, (text, lp, ids)),
                    resume=plan["resume_tokens"] if idx == 0 else None)
                counts[idx], finishes[idx] = result.completion_tokens, result.finish_reason
                put("end", idx, None)
            except Exception as e:  # surfaced on the consumer side
                put("err", idx, e)

        producers = [loop.run_in_executor(None, produce, i, r) for i, r in enumerate(reqs)]
        # The engine's sweep enforces the deadline; this wait backstops it.
        deadline = loop.time() + timeout + self.DEADLINE_SLACK_S
        ended = 0
        try:
            for i in range(n):
                yield oai.chunk(id=chunk_id, model=model, delta={"role": "assistant"}, index=i)
            while ended < n:
                # Drain in batches: one decode chunk delivers its tokens
                # within microseconds of each other; all but the batch's last
                # event are marked MoreChunk so the SSE writer flushes once.
                batch = [await asyncio.wait_for(events.get(), max(0.0, deadline - loop.time()))]
                while not events.empty():
                    batch.append(events.get_nowait())
                for pos, (kind, idx, val) in enumerate(batch):
                    more = pos < len(batch) - 1
                    if kind == "text":
                        text, lp, ids = val
                        out = oai.chunk(id=chunk_id, model=model, delta={"content": text},
                                        index=idx)
                        if lp is not None:
                            out["choices"][0]["logprobs"] = {"content": lp, "refusal": None}
                        if plan["stream_token_ids"] and ids:
                            # The ids whose text this chunk carries: a
                            # resume journal's entries.
                            out["qt_tokens"] = ids
                    elif kind == "end":
                        ended += 1
                        out = oai.chunk(id=chunk_id, model=model, delta={},
                                        finish_reason=finishes[idx], index=idx)
                    elif isinstance(val, DeadlineExceeded):
                        raise _deadline_error(self.name, val) from val
                    elif isinstance(val, GrammarArenaFull):
                        raise _overloaded(self.name, str(val)) from val
                    elif isinstance(val, ReplayDivergence):
                        # A resume that must not be retried: the code, not
                        # the message, says so.
                        raise BackendError(f"Backend {self.name} failed: {val}",
                                           code="resume_diverged") from val
                    else:
                        raise BackendError(f"Backend {self.name} failed: {val}") from val
                    yield oai.more(out) if more else out
        except asyncio.TimeoutError:
            _set_all(cancels)
            raise _timeout_error(self.name, timeout) from None
        except BaseException:  # client disconnect: free the slots within one chunk
            _set_all(cancels)
            raise
        for p in producers:
            await p
        if (body.get("stream_options") or {}).get("include_usage"):
            usage_chunk = oai.chunk(id=chunk_id, model=model, delta={})
            usage_chunk["choices"] = []
            usage_chunk["usage"] = self._usage(len(plan["prompt_ids"]), sum(counts))
            yield usage_chunk

    # ---- embeddings and legacy completions --------------------------------

    async def embed(self, body: dict[str, Any], headers: dict[str, str],
                    timeout: float) -> CompletionResult:
        """OpenAI ``/embeddings`` from the engine's resident weights.

        ``input``: a string, a list of strings, one token-id list, or a
        list of them; mixed lists, empty input, out-of-vocab ids, more than
        64 items, an ``encoding_format`` other than float/base64 and
        ``dimensions`` outside 1..d_model are 400s. Vectors are mean-pooled
        final-norm hidden states, L2-normalised; ``dimensions`` truncates
        then renormalises; an input past ``max_seq`` keeps its head."""
        from quorum_tpu_torch.engine.embed import (MAX_BATCH, embed_token_batch,
                                                   forward_tokens_error)

        effective = prepare_body(body, self.model)  # 400 when no model anywhere
        if getattr(self.engine, "mesh", None) is not None:
            raise _invalid_request("embeddings are not yet on a multi-rank engine "
                                   "(tp=/sp= backends)")
        token_lists = [self.tokenizer.encode(x) if isinstance(x, str) else x
                       for x in self._token_inputs(body.get("input"), "input", MAX_BATCH)]
        spec = self.engine.spec
        fmt = body.get("encoding_format", "float")
        if fmt not in ("float", "base64"):
            raise _invalid_request("'encoding_format' must be 'float' or 'base64'")
        dims = body.get("dimensions", spec.d_model)
        if not isinstance(dims, int) or isinstance(dims, bool) or not 1 <= dims <= spec.d_model:
            raise _invalid_request(f"'dimensions' must be an integer in 1..{spec.d_model}")
        refused = forward_tokens_error(
            spec, [max(min(len(t), spec.max_seq), 1) for t in token_lists])
        if refused:
            raise _invalid_request(refused)

        def run():
            return embed_token_batch(self.engine, token_lists, member=self.member)

        try:
            vectors = await self._gated_to_thread(run, timeout)
        except asyncio.TimeoutError:
            raise _timeout_error(self.name, timeout) from None
        except BackendError:
            raise
        except Exception as e:
            logger.exception("cuda backend %s embeddings failed", self.name)
            raise BackendError(f"Backend {self.name} failed: {e}") from e
        if dims < spec.d_model:
            vectors = vectors[:, :dims]
            vectors = vectors / torch.linalg.vector_norm(
                vectors, dim=-1, keepdim=True).clamp(min=1e-9)
        data = []
        for i, v in enumerate(vectors.tolist()):
            emb: Any = (base64.b64encode(struct.pack(f"<{len(v)}f", *v)).decode("ascii")
                        if fmt == "base64" else v)
            data.append({"object": "embedding", "index": i, "embedding": emb})
        n_tokens = sum(min(len(t), spec.max_seq) for t in token_lists)
        resp = {"object": "list", "data": data,
                "model": effective.get("model") or self.model,
                "usage": {"prompt_tokens": n_tokens, "total_tokens": n_tokens},
                "backend": self.name}
        return CompletionResult(backend_name=self.name, status_code=200, body=resp)

    def _token_inputs(self, raw: Any, field: str, limit: int | None = None) -> list:
        """The OpenAI ``input`` / ``prompt`` grammar — a string, a list of
        strings, one token-id list or a list of them, never a mix — as a
        list of strings and in-vocabulary id lists; anything else, or more
        than ``limit`` items, is a 400."""
        if isinstance(raw, str):
            if not raw:
                raise _invalid_request(f"'{field}' must not be an empty string")
            items: list[Any] = [raw]
        elif isinstance(raw, list) and raw and all(
                isinstance(x, int) and not isinstance(x, bool) for x in raw):
            items = [raw]  # one pre-tokenized input
        elif isinstance(raw, list) and raw:
            items = raw
            _reject_mixed(items, field)
        else:
            raise _invalid_request(
                f"'{field}' must be a non-empty string, list of strings, or token array(s)")
        if limit is not None and len(items) > limit:
            raise _invalid_request(f"at most {limit} inputs per embeddings request")
        vocab = self.engine.spec.vocab_size
        for x in items:
            if not ((isinstance(x, str) and x) or _token_ids_ok(x, vocab)):
                raise _invalid_request(
                    f"each '{field}' item must be a string or a non-empty list of in-vocab "
                    "token ids")
        return items

    def _parse_prompts(self, raw: Any) -> list[tuple[str, list[int]]]:
        """The /completions ``prompt`` → [(text, token ids)]; a pre-tokenized
        prompt's text comes from the tokenizer, so ``echo`` always has
        something to echo."""
        return [(x, self.tokenizer.encode(x)) if isinstance(x, str)
                else (self.tokenizer.decode(x), list(x))
                for x in self._token_inputs(raw, "prompt")]

    @staticmethod
    def _validate_completions_common(body: dict[str, Any]) -> None:
        """/completions rules of both the flat and the streamed path;
        ``best_of=1`` and ``n=1`` are the OpenAI defaults (no-ops)."""
        if body.get("n") not in (None, 1):
            raise _invalid_request(
                "'n' > 1 is not supported on /completions — send a list of prompts instead")
        if body.get("best_of") not in (None, 1):
            raise _invalid_request("'best_of' is not supported by cuda:// backends")
        if body.get("suffix"):
            raise _invalid_request("'suffix' is not supported by cuda:// backends")

    def plan_text_stream(self, body: dict[str, Any]) -> tuple[dict[str, Any], str]:
        """Validate a streamed /completions request and build the chat body
        its stream runs on: ``(stream body, model)``. One prompt, no
        ``echo``/``logprobs`` (the legacy wire has no streamed form of
        them), and the legacy default of 16 tokens."""
        effective = prepare_body(body, self.model)
        self._validate_completions_common(body)
        # logprobs=false is the serialized default, not a request for them.
        if body.get("echo") or body.get("logprobs") not in (None, False):
            raise _invalid_request(
                "'echo'/'logprobs' are not supported with 'stream' on /completions")
        prompts = self._parse_prompts(body.get("prompt"))
        if len(prompts) != 1:
            raise _invalid_request("streaming /completions takes exactly one prompt")
        sbody = {k: v for k, v in body.items()
                 if k not in ("prompt", "echo", "logprobs", "stream", "n", "best_of", "suffix")}
        if "max_tokens" not in sbody and "max_completion_tokens" not in sbody:
            sbody["max_tokens"] = 16
        sbody["_raw_prompt_ids"] = prompts[0][1]
        return sbody, effective["model"]

    @staticmethod
    def _parse_completions_logprobs(body: dict[str, Any]) -> int | None:
        lp = body.get("logprobs")
        if lp is None or lp is False:
            return None
        if lp is True:  # chat-style boolean: the chosen token only
            return 0
        if not isinstance(lp, int) or isinstance(lp, bool) or not 0 <= lp <= 5:
            raise _invalid_request(
                f"Invalid value for 'logprobs': {lp!r} (must be an integer in [0, 5])")
        return lp

    async def text_complete(self, body: dict[str, Any], headers: dict[str, str],
                            timeout: float) -> CompletionResult:
        """Legacy OpenAI ``/completions``: raw-prompt generation and
        teacher-forced scoring from the same resident weights.

        ``echo=true`` with ``logprobs=k`` returns every PROMPT token's
        logprob (the first ``null``) from one forward (``engine/score.py``);
        ``max_tokens=0`` is allowed only in that mode. Generation runs the
        chat plan over the raw prompt ids (no template). At most 8 prompts
        when generating (one slot each), 64 when only scoring; one deadline
        covers both phases."""
        from quorum_tpu_torch.engine.embed import MAX_BATCH, forward_tokens_error
        from quorum_tpu_torch.engine.score import score_token_batch

        effective = prepare_body(body, self.model)
        self._validate_completions_common(body)
        prompts = self._parse_prompts(body.get("prompt"))
        echo = bool(body.get("echo", False))
        lp = self._parse_completions_logprobs(body)
        mt = body.get("max_tokens")
        if mt is None:
            mt = 16  # the OpenAI default for /completions
        if not isinstance(mt, int) or isinstance(mt, bool) or mt < 0:
            raise _invalid_request(f"Invalid value for 'max_tokens': {mt!r} (integer >= 0)")
        scoring = echo and lp is not None
        if scoring and getattr(self.engine, "mesh", None) is not None:
            raise _invalid_request("prompt scoring (echo with logprobs) is not yet on a "
                                   "multi-rank engine (tp=/sp= backends)")
        if mt == 0 and not scoring:
            raise _invalid_request(
                "'max_tokens': 0 requires 'echo': true with 'logprobs' set (the pure "
                "scoring mode)")
        max_seq = self.engine.spec.max_seq
        if scoring:
            too_long = max(len(ids) for _, ids in prompts)
            if too_long > max_seq:
                raise _invalid_request(
                    f"prompt of {too_long} tokens exceeds max_seq={max_seq} — a truncated "
                    "prompt cannot be scored faithfully")
            if len(prompts) > MAX_BATCH:
                raise _invalid_request(f"at most {MAX_BATCH} prompts per scoring request")
            refused = forward_tokens_error(self.engine.spec, [len(ids) for _, ids in prompts])
            if refused:
                raise _invalid_request(refused)
        if mt >= 1 and len(prompts) > self.MAX_N:
            raise _invalid_request(f"at most {self.MAX_N} prompts per generation request")
        # One deadline for both phases: scoring then generating must not
        # take twice the timeout.
        deadline = time.monotonic() + timeout

        scores = None
        if scoring:
            def run_score():
                return score_token_batch(self.engine, [ids for _, ids in prompts],
                                         member=self.member, top_k=lp)

            try:
                scores = await self._gated_to_thread(
                    run_score, max(0.0, deadline - time.monotonic()))
            except asyncio.TimeoutError:
                raise _timeout_error(self.name, timeout) from None
            except BackendError:
                raise
            except Exception as e:
                logger.exception("cuda backend %s scoring failed", self.name)
                raise BackendError(f"Backend {self.name} failed: {e}") from e

        outs: list = []
        if mt >= 1:
            plan_body = {k: v for k, v in body.items()
                         if k not in ("prompt", "echo", "logprobs", "stream", "max_tokens",
                                      "max_completion_tokens")}
            plan_body["max_tokens"] = mt
            if lp is not None:
                plan_body["logprobs"] = True
                plan_body["top_logprobs"] = lp
            plans = [self._plan({**plan_body, "_raw_prompt_ids": ids}) for _, ids in prompts]
            outs = await self._generate(plans, timeout, deadline)

        choices = []
        total_completion = 0
        for i, (text, ids) in enumerate(prompts):
            gen_text, finish, lp_content = "", "length", None
            if outs:
                result, gen_text, lp_content = outs[i]
                finish = result.finish_reason
                total_completion += result.completion_tokens
            choice: dict[str, Any] = {"index": i,
                                      "text": (text + gen_text) if echo else gen_text,
                                      "finish_reason": finish}
            choice["logprobs"] = (None if lp is None else
                                  self._legacy_logprobs(ids, scores[i] if echo else None,
                                                        lp_content))
            choices.append(choice)
        resp = {"id": f"cmpl-{uuid.uuid4().hex[:24]}", "object": "text_completion",
                "created": oai.now(), "model": effective["model"], "choices": choices,
                "usage": self._usage(sum(len(ids) for _, ids in prompts), total_completion),
                "backend": self.name}
        return CompletionResult(backend_name=self.name, status_code=200, body=resp)

    def _legacy_logprobs(self, ids: list[int], score: dict | None,
                         lp_content: list | None) -> dict[str, Any]:
        """The legacy ``logprobs`` object of one choice: the echoed prompt's
        tokens (``score``, from the scoring forward), then the generated
        ones (``lp_content``). Echoed token texts come from the incremental
        detokenizer, which emits whole characters only, so every
        ``text_offset`` indexes the returned text even where byte tokens
        split a multi-byte character."""
        tokens: list[str] = []
        token_lps: list = []
        tops: list = []
        offsets: list[int] = []
        pos = 0
        if score is not None:
            top = score.get("top")
            detok = self.tokenizer.detokenizer()
            for j, tid in enumerate(ids):
                ttext = detok.feed(int(tid))
                if j == len(ids) - 1:
                    ttext += detok.flush()
                tokens.append(ttext)
                offsets.append(pos)
                pos += len(ttext)
                token_lps.append(score["token_logprobs"][j])
                if j == 0:
                    tops.append(None)  # no prefix: nothing to rank
                elif top is not None:
                    t_ids, t_lps = top[j]
                    tops.append(_top_dict((self.tokenizer.decode([int(t)]), float(v))
                                          for t, v in zip(t_ids, t_lps)))
                else:
                    tops.append({})
        for e in lp_content or ():
            tokens.append(e["token"])
            offsets.append(pos)
            pos += len(e["token"])
            token_lps.append(e["logprob"])
            tops.append(_top_dict((t["token"], t["logprob"]) for t in e.get("top_logprobs", [])))
        return {"tokens": tokens, "token_logprobs": token_lps, "top_logprobs": tops,
                "text_offset": offsets}

    async def aclose(self) -> None:
        return None

