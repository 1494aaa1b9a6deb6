"""Structured output and the stream-resume fields through the ASGI app, on
``tpu://`` (the JAX package's app and backend) and ``cuda://`` (the
port's), llama-tiny on the CPU.

- The edge checks of ``response_format``, ``tenant``, ``resume_tokens``,
  ``resume_chars`` and ``stream_token_ids``: one 400 with the same body
  from both apps.
- A grammar the backend cannot compile: the same 400; one no token can
  satisfy (vocab 20 cannot spell ``{``): the same 422 ``grammar_error``;
  a full grammar arena: the same 503 with Retry-After.
- A finite json_schema, streamed and not: the same parsed content on
  both, finish_reason ``stop``; logprobs under a grammar that allows fewer
  tokens than ``top_logprobs`` stay finite (``json.dumps(allow_nan=False)``).
- The resume bodies of ROADMAP queue 3 (llama-tiny, seed 1, "hi", 8
  greedy tokens, ``resume_tokens`` [266, 442, 448]; the port's engine on
  the JAX engine's bf16 weights): ``cuda://`` streams what ``tpu://``
  streams — the continuation only, never the prefix again, with the same
  ``qt_tokens``. ``stream_token_ids: false`` and a ``tenant`` are served
  exactly as without them.
"""

import json
import math

import jax
import numpy as np
import pytest
import torch

from quorum_tpu.backends.tpu_backend import TpuBackend
from quorum_tpu.config import BackendSpec as JaxBackendSpec
from quorum_tpu.config import Config as JaxConfig
from quorum_tpu.engine import engine as jem
from quorum_tpu.engine.engine import InferenceEngine as JaxEngine
from quorum_tpu.models.init import init_params as jax_init_params
from quorum_tpu.models.model_config import resolve_spec as jax_resolve_spec
from quorum_tpu.server.app import create_app as jax_create_app
from quorum_tpu_torch import sse
from quorum_tpu_torch.backends.cuda_backend import CudaBackend
from quorum_tpu_torch.config import BackendSpec, Config
from quorum_tpu_torch.engine import engine as tem
from quorum_tpu_torch.engine.engine import InferenceEngine
from quorum_tpu_torch.models.convert import params_from_numpy
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.server.app import create_app

OPTS = {"dtype": "float32"}
SCHEMA = {"type": "object", "properties": {
    "ok": {"type": "boolean"},
    "dir": {"enum": ["N", "S", "E", "W"]}}}
JSON_SCHEMA = {"type": "json_schema", "json_schema": {"schema": SCHEMA}}
BODY = {"model": "m", "messages": [{"role": "user", "content": "go"}], "max_tokens": 32,
        "temperature": 0}
RESUME = {"model": "m", "messages": [{"role": "user", "content": "hi"}], "max_tokens": 8,
          "temperature": 0, "stream": True}
RESUME_TOKENS = [266, 442, 448]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _raw(url):
    return {"primary_backends": [{"name": "llama", "url": url, "model": "m"}],
            "settings": {"timeout": 120}}


def _apps(jax_backend, port_backend):
    return (jax_create_app(JaxConfig(raw=_raw("tpu://llama-tiny")), llama=jax_backend),
            create_app(Config(raw=_raw("cuda://llama-tiny?device=cpu")), llama=port_backend))


@pytest.fixture(scope="module")
def apps():
    """Both apps over one float32 weight set (JAX's init, seed 4)."""
    jspec = jax_resolve_spec("llama-tiny", OPTS)
    jparams = jax.tree.map(np.asarray, jax_init_params(jspec, seed=4))
    jeng = JaxEngine(jspec, params=jparams, decode_chunk=4)
    teng = InferenceEngine(resolve_spec("llama-tiny", OPTS), device="cpu", decode_chunk=4,
                           params=params_from_numpy(jparams, device="cpu"))
    yield _apps(TpuBackend("llama", jeng, model="m"),
                CudaBackend("llama", teng, model="m", model_id="llama-tiny"))
    jeng.shutdown()
    teng.shutdown()


async def call(app, body):
    """(status, headers, body bytes) of one POST /v1/chat/completions."""
    raw = json.dumps(body).encode()
    sent = []

    async def receive():
        return {"type": "http.request", "body": raw, "more_body": False}

    async def send(message):
        sent.append(message)

    await app({"type": "http", "method": "POST", "path": "/v1/chat/completions",
               "headers": [(b"authorization", b"Bearer t")]}, receive, send)
    hdrs = {k.decode().lower(): v.decode() for k, v in sent[0]["headers"]}
    return sent[0]["status"], hdrs, b"".join(m.get("body", b"") for m in sent[1:])


def _events(data: bytes) -> list[dict]:
    return [e for e in sse.iter_data_events(data) if isinstance(e, dict)]


def _content(status, data: bytes, stream: bool) -> tuple[str, str | None]:
    """(content, finish_reason) of a 200 response, streamed or not."""
    assert status == 200, data[:300]
    if not stream:
        choice = json.loads(data)["choices"][0]
        return choice["message"]["content"], choice["finish_reason"]
    events = [e for e in _events(data) if e.get("choices")]
    text = "".join(e["choices"][0]["delta"].get("content") or "" for e in events)
    finish = next((e["choices"][0]["finish_reason"] for e in events
                   if e["choices"][0].get("finish_reason")), None)
    return text, finish


async def _both(apps, body):
    return [await call(app, body) for app in apps]


# ---- edge checks: one 400, the same body --------------------------------------

EDGE_400 = {
    "rf_not_object": {"response_format": "json"},
    "rf_no_type": {"response_format": {"json_schema": {}}},
    "rf_unknown_type": {"response_format": {"type": "xml"}},
    "rf_schema_missing": {"response_format": {"type": "json_schema"}},
    "rf_schema_not_object": {"response_format": {"type": "json_schema",
                                                 "json_schema": {"schema": 3}}},
    "rf_regex_no_pattern": {"response_format": {"type": "regex"}},
    "rf_regex_empty": {"response_format": {"type": "regex", "pattern": ""}},
    "tenant_empty": {"tenant": ""},
    "tenant_too_long": {"tenant": "t" * 65},
    "tenant_not_string": {"tenant": 7},
    "resume_junk": {"stream": True, "resume_tokens": "abc"},
    "resume_empty": {"stream": True, "resume_tokens": []},
    "resume_negative": {"stream": True, "resume_tokens": [3, -1]},
    "resume_bools": {"stream": True, "resume_tokens": [True]},
    "resume_without_stream": {"resume_tokens": RESUME_TOKENS},
    "resume_with_logprobs": {"stream": True, "resume_tokens": RESUME_TOKENS,
                             "logprobs": True},
    "resume_with_n": {"stream": True, "resume_tokens": RESUME_TOKENS, "n": 2},
    "resume_chars_alone": {"stream": True, "resume_chars": 4},
    "resume_chars_negative": {"stream": True, "resume_tokens": RESUME_TOKENS,
                              "resume_chars": -1},
    "resume_chars_bool": {"stream": True, "resume_tokens": RESUME_TOKENS,
                          "resume_chars": True},
    "stream_token_ids_yes": {"stream": True, "stream_token_ids": "yes"},
    "stream_token_ids_with_n": {"stream": True, "stream_token_ids": True, "n": 2},
}


@pytest.mark.parametrize("case", list(EDGE_400))
async def test_edge_400s_match_the_jax_app(apps, case):
    (js, _, jb), (ts, _, tb) = await _both(apps, {**BODY, **EDGE_400[case]})
    assert js == ts == 400
    assert json.loads(tb) == json.loads(jb)
    assert json.loads(tb)["error"]["type"] == "invalid_request_error"


@pytest.mark.parametrize("rf", [
    {"type": "regex", "pattern": "a(?=b)"},
    {"type": "json_schema", "json_schema": {"schema": {"$ref": "#/x"}}},
    {"type": "json_schema", "json_schema": {"schema": {"type": "integer", "minimum": 0}}},
], ids=["lookahead", "ref", "minimum"])
async def test_uncompilable_grammar_is_the_same_400(apps, rf):
    (js, _, jb), (ts, _, tb) = await _both(apps, {**BODY, "response_format": rf})
    assert js == ts == 400
    assert json.loads(tb) == json.loads(jb)
    assert json.loads(tb)["error"]["message"].startswith("Invalid 'response_format': ")


async def test_unsatisfiable_grammar_is_the_same_422():
    """vocab 20 leaves 17 byte slots: '{' has no producing token."""
    jb = TpuBackend.from_spec(JaxBackendSpec(
        name="llama", url="tpu://llama-tiny?vocab_size=20&seed=1", model="m"))
    tb = CudaBackend.from_spec(BackendSpec(
        name="llama", url="cuda://llama-tiny?vocab_size=20&seed=1&device=cpu", model="m"))
    try:
        got = await _both(_apps(jb, tb), {**BODY, "response_format": JSON_SCHEMA})
    finally:
        jb.engine.shutdown()
        tb.engine.shutdown()
    (js, _, jbody), (ts, _, tbody) = got
    assert js == ts == 422
    assert json.loads(tbody) == json.loads(jbody)
    assert json.loads(tbody)["error"]["type"] == "grammar_error"


async def test_full_arena_is_the_same_503(monkeypatch):
    """A grammar past CONSTRAIN_ARENA_MAX fails alone, retryably."""
    monkeypatch.setattr(jem, "CONSTRAIN_ARENA_MAX", 8)
    monkeypatch.setattr(tem, "CONSTRAIN_ARENA_MAX", 8)
    jspec = jax_resolve_spec("llama-tiny", OPTS)
    jeng = JaxEngine(jspec, seed=2, decode_chunk=4)
    teng = InferenceEngine(resolve_spec("llama-tiny", OPTS), device="cpu", seed=2,
                           decode_chunk=4)
    try:
        apps = _apps(TpuBackend("llama", jeng, model="m"),
                     CudaBackend("llama", teng, model="m", model_id="llama-tiny"))
        (js, jh, jb), (ts, th, tb) = await _both(apps, {**BODY, "response_format": JSON_SCHEMA})
        assert teng.metrics()["constrained_requests_total"] == 0
    finally:
        jeng.shutdown()
        teng.shutdown()
    assert js == ts == 503
    assert json.loads(tb) == json.loads(jb)
    assert "grammar arena at capacity" in json.loads(tb)["error"]["message"]
    assert th.get("retry-after") == jh.get("retry-after") == "1"


# ---- served grammars ------------------------------------------------------------

@pytest.mark.parametrize("stream", [False, True], ids=["complete", "stream"])
async def test_json_schema_content_and_stop_match(apps, stream):
    body = {**BODY, "response_format": JSON_SCHEMA, "stream": stream}
    (js, _, jb), (ts, _, tb) = await _both(apps, body)
    want, got = _content(js, jb, stream), _content(ts, tb, stream)
    assert got == want
    obj = json.loads(got[0])
    assert isinstance(obj["ok"], bool) and obj["dir"] in "NSEW"
    assert got[1] == "stop"  # grammar completion forced EOS


async def test_json_object_and_regex_match(apps):
    for rf in ({"type": "json_object"}, {"type": "regex", "pattern": "[0-9]{3}-[0-9]{4}"}):
        (js, _, jb), (ts, _, tb) = await _both(apps, {**BODY, "response_format": rf})
        assert _content(ts, tb, False) == _content(js, jb, False)


@pytest.mark.parametrize("temperature", [0.0, 0.7])
async def test_constrained_logprobs_are_json_safe(apps, temperature):
    """'yes|no' allows fewer tokens than top_logprobs=5: the masked
    alternatives never reach the wire as -Infinity."""
    body = {**BODY, "max_tokens": 8, "temperature": temperature, "seed": 3,
            "logprobs": True, "top_logprobs": 5,
            "response_format": {"type": "regex", "pattern": "yes|no"}}
    (js, _, jb), (ts, _, tb) = await _both(apps, body)
    resp = json.loads(tb)
    json.dumps(resp, allow_nan=False)
    choice = resp["choices"][0]
    assert choice["message"]["content"] in ("yes", "no")
    entries = choice["logprobs"]["content"]
    assert entries and all(math.isfinite(e["logprob"]) for e in entries)
    assert all(math.isfinite(t["logprob"]) and len(e["top_logprobs"]) <= 5
               for e in entries for t in e["top_logprobs"])
    if temperature == 0.0:
        assert choice["message"]["content"] == json.loads(jb)["choices"][0]["message"]["content"]


# ---- the stream-resume fields ---------------------------------------------------

@pytest.fixture(scope="module")
def resume_apps():
    """ROADMAP queue 3's probe: llama-tiny, seed 1, the default dtype (bf16);
    the port's engine holds the JAX engine's weights."""
    jb = TpuBackend.from_spec(JaxBackendSpec(name="llama", url="tpu://llama-tiny?seed=1",
                                             model="m"))
    params = params_from_numpy(jax.tree.map(np.asarray, jb.engine.params), device="cpu",
                               dtype=torch.bfloat16)
    teng = InferenceEngine(resolve_spec("llama-tiny", {}), device="cpu", params=params)
    yield _apps(jb, CudaBackend("llama", teng, model="m", model_id="llama-tiny"))
    jb.engine.shutdown()
    teng.shutdown()


@pytest.mark.parametrize("field,extra", [
    ("resume_tokens", {"resume_tokens": RESUME_TOKENS, "stream_token_ids": True}),
    ("resume_tokens", {"resume_tokens": RESUME_TOKENS, "resume_chars": 3,
                       "stream_token_ids": True}),
    ("stream_token_ids", {"stream_token_ids": True}),
], ids=["resume_tokens", "resume_chars", "stream_token_ids"])
async def test_resume_bodies_are_refused_by_name_on_cuda(resume_apps, field, extra):
    """Named for the refusal ``cuda://`` answered before it served stream
    resume: the bodies now stream on ``cuda://`` exactly as on ``tpu://``."""
    (js, _, jb), (ts, _, tb) = await _both(resume_apps, {**RESUME, **extra})
    assert js == ts == 200
    want, got = ([e for e in _events(b) if e.get("choices")] for b in (jb, tb))
    ids = [t for e in got for t in e.get("qt_tokens") or ()]
    assert ids == [t for e in want for t in e.get("qt_tokens") or ()]
    assert [(e["choices"][0]["delta"], e["choices"][0]["finish_reason"]) for e in got] == [
        (e["choices"][0]["delta"], e["choices"][0]["finish_reason"]) for e in want]
    assert not any(e.get("id") == "error" for e in _events(tb))
    if "resume_tokens" in extra:
        # Only the continuation: 8 tokens less the 3 already delivered.
        assert len(ids) == RESUME["max_tokens"] - len(RESUME_TOKENS)
        assert ids[:len(RESUME_TOKENS)] != RESUME_TOKENS
    else:
        assert ids[:len(RESUME_TOKENS)] == RESUME_TOKENS
        assert len(ids) == RESUME["max_tokens"]


@pytest.mark.parametrize("extra", [{"stream_token_ids": False}, {"tenant": "acme"}],
                         ids=["stream_token_ids_false", "tenant"])
async def test_inert_fields_are_served_as_without_them(resume_apps, extra):
    _, port = resume_apps
    plain = _content(*(await call(port, RESUME))[::2], True)
    status, _, data = await call(port, {**RESUME, **extra})
    assert _content(status, data, True) == plain
    assert not any("qt_tokens" in e for e in _events(data))
