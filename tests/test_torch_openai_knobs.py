"""The OpenAI request-knob contract on cuda:// backends: the scenarios of
tests/test_openai_knobs.py against ``cuda://llama-tiny?seed=1&device=cpu``,
plus one body held against the JAX package's ``tpu://`` backend on the same
weights.

Every knob has an accept test (it changes or structures the output as
documented) and a reject test (out-of-range or unsupported values are a 400,
not a silent ignore or a 500). ``tools`` and a malformed or unsupported
``response_format`` are a 400 on cuda:// (the grammars it serves are
tests/test_torch_structured_output_api.py's).
"""

import asyncio
import json
import time

import jax
import numpy as np
import pytest
import torch

from quorum_tpu.backends.tpu_backend import TpuBackend
from quorum_tpu.engine.engine import InferenceEngine as JaxEngine
from quorum_tpu.models.init import init_params as jax_init_params
from quorum_tpu.models.model_config import resolve_spec as jax_resolve_spec
from quorum_tpu_torch.backends.base import BackendError
from quorum_tpu_torch.backends.cuda_backend import CudaBackend
from quorum_tpu_torch.backends.fake import FakeBackend
from quorum_tpu_torch.config import BackendSpec, Config
from quorum_tpu_torch.engine.engine import InferenceEngine
from quorum_tpu_torch.models.convert import params_from_numpy
from quorum_tpu_torch.models.model_config import MODEL_PRESETS, resolve_spec
from quorum_tpu_torch.server.app import create_app

BASE = {"model": "m", "messages": [{"role": "user", "content": "hi"}], "max_tokens": 5}
LP_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def backend():
    return CudaBackend.from_spec(BackendSpec(
        name="knobs", url="cuda://llama-tiny?seed=1&device=cpu", model="m"))


def run(coro):
    return asyncio.run(coro)


# ---- n ---------------------------------------------------------------------------

def test_n_returns_distinct_choices(backend):
    body = {**BASE, "n": 3, "temperature": 0.9, "seed": 4}
    res = run(backend.complete(body, {}, 60))
    choices = res.body["choices"]
    assert [c["index"] for c in choices] == [0, 1, 2]
    texts = {c["message"]["content"] for c in choices}
    assert len(texts) >= 2  # distinct sampling streams per choice
    assert res.body["usage"]["completion_tokens"] == 15  # summed across choices


def test_n_streaming_tags_choice_indices(backend):
    async def go():
        idxs, finishes = set(), []
        async for ch in backend.stream({**BASE, "n": 2, "stream": True,
                                        "stream_options": {"include_usage": True}}, {}, 60):
            if not ch.get("choices"):
                usage = ch["usage"]
            for c in ch.get("choices") or []:
                idxs.add(c["index"])
                if c.get("finish_reason"):
                    finishes.append(c["index"])
        return idxs, finishes, usage

    idxs, finishes, usage = run(go())
    assert idxs == {0, 1}
    assert sorted(finishes) == [0, 1]  # one finish chunk per choice
    assert usage["completion_tokens"] == 10  # summed across choices


@pytest.mark.parametrize("bad", [0, 9, -1, "3", 2.5, True])
def test_n_rejects_bad_values(backend, bad):
    with pytest.raises(BackendError) as e:
        run(backend.complete({**BASE, "n": bad}, {}, 60))
    assert e.value.status_code == 400
    assert "'n'" in e.value.body["error"]["message"]


# ---- logprobs --------------------------------------------------------------------

def test_logprobs_structure_and_consistency(backend):
    body = {**BASE, "logprobs": True, "top_logprobs": 2, "temperature": 0.0}
    res = run(backend.complete(body, {}, 60))
    choice = res.body["choices"][0]
    content = choice["logprobs"]["content"]
    assert len(content) == 5  # one entry per generated token
    for entry in content:
        assert set(entry) == {"token", "logprob", "bytes", "top_logprobs"}
        assert entry["logprob"] <= 0.0
        assert len(entry["top_logprobs"]) == 2
        assert isinstance(entry["bytes"], list)
    # greedy sampling: the sampled token IS the top-1 alternative
    e0 = content[0]
    assert e0["token"] == e0["top_logprobs"][0]["token"]
    assert e0["logprob"] == pytest.approx(e0["top_logprobs"][0]["logprob"])


def test_logprobs_absent_by_default(backend):
    res = run(backend.complete(dict(BASE), {}, 60))
    assert "logprobs" not in res.body["choices"][0]


@pytest.mark.parametrize("bad", [
    {"logprobs": "yes"},
    {"logprobs": True, "top_logprobs": 21},
    {"logprobs": True, "top_logprobs": -1},
    {"top_logprobs": 5},  # requires logprobs: true
])
def test_logprobs_rejects_bad_values(backend, bad):
    with pytest.raises(BackendError) as e:
        run(backend.complete({**BASE, **bad}, {}, 60))
    assert e.value.status_code == 400


def test_logprobs_align_with_content_under_stop(backend):
    """logprobs.content tracks EMITTED content: tokens swallowed by the
    stop matcher (the stop string itself) get no entries."""
    probe = run(backend.complete(
        {**BASE, "max_tokens": 8, "temperature": 0.0, "logprobs": True}, {}, 60))
    entries = probe.body["choices"][0]["logprobs"]["content"]
    assert len(entries) == 8
    stop_tok = entries[3]["token"]
    if not stop_tok:
        pytest.skip("3rd token has empty text (detokenizer buffering)")

    res = run(backend.complete(
        {**BASE, "max_tokens": 8, "temperature": 0.0, "logprobs": True,
         "stop": [stop_tok]}, {}, 60))
    choice = res.body["choices"][0]
    content = choice["message"]["content"]
    lp = choice["logprobs"]["content"]
    assert stop_tok not in content  # stop string excluded from content
    assert "".join(e["token"] for e in lp) == content


def test_streaming_logprobs_align_with_streamed_content(backend):
    """Streamed logprob entries ride inside content chunks and, joined,
    reproduce exactly the streamed content."""
    probe = run(backend.complete(
        {**BASE, "max_tokens": 8, "temperature": 0.0, "logprobs": True}, {}, 60))
    stop_tok = probe.body["choices"][0]["logprobs"]["content"][3]["token"]
    if not stop_tok:
        pytest.skip("3rd token has empty text")

    async def go():
        text, toks = [], []
        async for ch in backend.stream(
            {**BASE, "max_tokens": 8, "temperature": 0.0, "logprobs": True,
             "stop": [stop_tok], "stream": True}, {}, 60):
            for c in ch.get("choices") or []:
                delta = c.get("delta") or {}
                if delta.get("content"):
                    text.append(delta["content"])
                for e in ((c.get("logprobs") or {}).get("content") or []):
                    toks.append(e["token"])
        return "".join(text), "".join(toks)

    streamed, lp_joined = run(go())
    assert stop_tok not in streamed
    assert lp_joined == streamed


# ---- penalties -------------------------------------------------------------------

def test_frequency_penalty_discourages_repeats(backend):
    base = {**BASE, "max_tokens": 12, "temperature": 0.0, "seed": 0}
    plain = run(backend.complete(base, {}, 60))
    pen = run(backend.complete({**base, "frequency_penalty": 2.0}, {}, 60))
    t_plain = plain.body["choices"][0]["message"]["content"]
    t_pen = pen.body["choices"][0]["message"]["content"]
    assert t_plain != t_pen  # the knob visibly acts on the distribution


@pytest.mark.parametrize("knob", ["presence_penalty", "frequency_penalty"])
@pytest.mark.parametrize("bad", [2.5, -2.5, "x"])
def test_penalties_reject_out_of_range(backend, knob, bad):
    with pytest.raises(BackendError) as e:
        run(backend.complete({**BASE, knob: bad}, {}, 60))
    assert e.value.status_code == 400


# ---- logit_bias ------------------------------------------------------------------

def test_logit_bias_forces_token(backend):
    # +100 bias on one token makes greedy sampling emit it every step
    body = {**BASE, "max_tokens": 3, "temperature": 0.0, "logit_bias": {"42": 100}}
    res = run(backend.complete(body, {}, 60))
    text = res.body["choices"][0]["message"]["content"]
    assert text == backend.tokenizer.decode([42, 42, 42])


@pytest.mark.parametrize("bad", [
    {"999999": 1},        # out-of-vocab id
    {"5": 500},           # bias outside [-100, 100]
    {"x": 1},             # non-integer id
    "notadict",
])
def test_logit_bias_rejects_bad_values(backend, bad):
    with pytest.raises(BackendError) as e:
        run(backend.complete({**BASE, "logit_bias": bad}, {}, 60))
    assert e.value.status_code == 400


# ---- unsupported fields → documented 400 -----------------------------------------

@pytest.mark.parametrize("field,value", [
    ("tools", [{"type": "function", "function": {"name": "f"}}]),
    ("tool_choice", "auto"),
    ("functions", [{"name": "f"}]),
    ("function_call", "auto"),
    # A malformed or unsupported response_format is a 400 (the well-formed
    # grammars are served: tests/test_torch_structured_output_api.py).
    ("response_format", {"type": "json_schema", "json_schema": {}}),
    ("response_format", {"type": "json_schema", "json_schema": {"schema": {"$ref": "#/x"}}}),
    ("response_format", {"type": "regex", "pattern": "a(?=b)"}),
    ("response_format", {"type": "xml"}),
])
def test_unsupported_fields_rejected(backend, field, value):
    with pytest.raises(BackendError) as e:
        run(backend.complete({**BASE, field: value}, {}, 60))
    assert e.value.status_code == 400
    assert e.value.body["error"]["type"] == "invalid_request_error"


def test_response_format_text_accepted(backend):
    res = run(backend.complete({**BASE, "response_format": {"type": "text"}}, {}, 60))
    assert res.status_code == 200


@pytest.mark.parametrize("field", ["user", "store", "metadata", "service_tier"])
def test_metadata_fields_accepted_and_ignored(backend, field):
    res = run(backend.complete({**BASE, field: "anything"}, {}, 60))
    assert res.status_code == 200


# ---- n>1 isolation: one choice finishing must not truncate siblings --------------

class _MultiScriptEngine:
    """Stub engine where each submitted choice gets its own token script,
    replayed with the real engine's contract: stream_results sets the
    request's cancel event in its finally (slot release)."""

    def __init__(self, scripts):
        self.spec = MODEL_PRESETS["llama-tiny"]
        self.scripts = list(scripts)
        self._i = 0

    def submit(self, prompt_ids, *, cancel=None, **kw):
        script = self.scripts[self._i]
        self._i += 1
        return (script, cancel)

    def stream_results(self, req):
        script, cancel = req
        try:
            for t in script:
                if cancel is not None and cancel.is_set():
                    return
                time.sleep(0.005)
                yield t
        finally:
            if cancel is not None:
                cancel.set()


def test_one_choice_finishing_does_not_truncate_siblings():
    """Choice 0 hits EOS after 1 token; choice 1 must still produce its full
    8 tokens (per-choice cancel events)."""
    b = CudaBackend.from_spec(BackendSpec(
        name="iso", url="cuda://llama-tiny?seed=3&device=cpu", model="m"))
    eos = b.tokenizer.eos_id
    b.engine = _MultiScriptEngine([[7, eos], [11] * 8])
    res = run(b.complete({**BASE, "n": 2, "max_tokens": 8}, {}, 60))
    choices = res.body["choices"]
    assert choices[0]["finish_reason"] == "stop"
    assert choices[1]["finish_reason"] == "length"
    assert choices[1]["message"]["content"] == b.tokenizer.decode([11] * 8)


# ---- proxy-level validation (app layer) ------------------------------------------

def _two_fake_config():
    return {
        "settings": {"timeout": 30},
        "primary_backends": [
            {"name": "A", "url": "http://a.test", "model": "m"},
            {"name": "B", "url": "http://b.test", "model": "m"},
        ],
        "iterations": {"aggregation": {"strategy": "concatenate"}},
        "strategy": {"concatenate": {"separator": "+"},
                     "aggregate": {"source_backends": "all", "aggregator_backend": ""}},
    }


async def _post(app, body):
    raw = json.dumps(body).encode()
    sent = []

    async def receive():
        return {"type": "http.request", "body": raw, "more_body": False}

    async def send(message):
        sent.append(message)

    await app({"type": "http", "method": "POST", "path": "/v1/chat/completions",
               "headers": [(b"authorization", b"Bearer x")]}, receive, send)
    return sent[0]["status"], json.loads(b"".join(m.get("body", b"") for m in sent[1:]))


@pytest.mark.parametrize("bad", [
    {"n": 0}, {"n": "x"}, {"logprobs": "yes"}, {"top_logprobs": 21},
    {"presence_penalty": 5}, {"frequency_penalty": -3},
    {"logit_bias": {"x": 1}}, {"logit_bias": {"5": 500}},
])
async def test_malformed_knobs_rejected_before_fanout(bad):
    """Malformed knob values are ONE 400 before fan-out — no backend sees
    the request."""
    fakes = dict(A=FakeBackend("A", text="a"), B=FakeBackend("B", text="b"))
    app = create_app(Config(raw=_two_fake_config()), **fakes)
    status, body = await _post(
        app, {"model": "m", "messages": [{"role": "user", "content": "q"}], **bad})
    assert status == 400, body
    assert body["error"]["type"] == "invalid_request_error"
    assert fakes["A"].calls == [] and fakes["B"].calls == []


# ---- the same body through tpu:// and cuda:// on one set of weights ---------------

@pytest.fixture(scope="module")
def twins():
    opts = {"dtype": "float32"}
    jspec = jax_resolve_spec("llama-tiny", opts)
    jparams = jax.tree.map(np.asarray, jax_init_params(jspec, seed=13))
    jeng = JaxEngine(jspec, params=jparams)
    teng = InferenceEngine(resolve_spec("llama-tiny", opts), device="cpu",
                           params=params_from_numpy(jparams, device="cpu"))
    yield TpuBackend("m", jeng), CudaBackend("m", teng, model_id="llama-tiny")
    jeng.shutdown()
    teng.shutdown()


@pytest.mark.parametrize("knobs", [
    {"logprobs": True, "top_logprobs": 3},
    {"logprobs": True, "top_logprobs": 2, "frequency_penalty": 1.2, "presence_penalty": 0.4,
     "logit_bias": {"101": 4.0, "32": -100}},
], ids=["logprobs", "penalties_bias"])
@pytest.mark.parametrize("stream", [False, True])
async def test_knob_body_matches_tpu_backend(twins, knobs, stream):
    """Greedy: the content, finish reasons and logprob entries of a
    two-choice body equal the tpu:// backend's (values within 1e-4)."""
    jb, tb = twins
    body = {**BASE, "max_tokens": 10, "temperature": 0.0, "n": 2, **knobs}

    async def collect(b):
        if not stream:
            return [(c["message"]["content"], c["finish_reason"], c["logprobs"]["content"])
                    for c in (await b.complete(dict(body), {}, 60)).body["choices"]]
        out = [["", None, []], ["", None, []]]
        async for ch in b.stream({**body, "stream": True}, {}, 60):
            for c in ch.get("choices") or []:
                o = out[c["index"]]
                o[0] += (c.get("delta") or {}).get("content") or ""
                o[1] = c.get("finish_reason") or o[1]
                o[2] += ((c.get("logprobs") or {}).get("content") or [])
        return [tuple(o) for o in out]

    want, got = await collect(jb), await collect(tb)
    for (wt, wf, wl), (gt, gf, gl) in zip(want, got):
        assert (gt, gf) == (wt, wf) and gt
        assert [e["token"] for e in gl] == [e["token"] for e in wl]
        for we, ge in zip(wl, gl):
            assert abs(we["logprob"] - ge["logprob"]) <= LP_TOL
            assert [a["token"] for a in ge["top_logprobs"]] == \
                [a["token"] for a in we["top_logprobs"]]
            np.testing.assert_allclose([a["logprob"] for a in ge["top_logprobs"]],
                                       [a["logprob"] for a in we["top_logprobs"]],
                                       atol=LP_TOL, rtol=0)
