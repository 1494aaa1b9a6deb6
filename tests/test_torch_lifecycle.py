"""Drain, park and stream resume on ``cuda://`` engines (the CPU: plain
versions), llama-tiny float32, against the JAX package on the same weights.

- Drain with park, at ring depth 1 and 4: queued requests end parked at
  once, active rows at the next scheduler turn; ``drain_status``, the
  ``draining`` / ``drain_parked_total`` counters, the submit gate
  (``QueueFullError``, ``retry_after`` 1 s) and ``undrain`` as the JAX
  engine's in the same scenario.
- Greedy streams resumed through the app with ``resume_tokens`` (and
  ``resume_chars``, ``stream_token_ids``): the same continuation text and
  ``qt_tokens`` as the JAX app's, the same ``replayed_tokens_total``
  growth, on the same engine and on a sibling engine.
- Sampled resumes equal the port's own unbroken run, also where the
  resume's admission or dispatches take another path than the first
  delivery's: ring depth 4 with ``decode_loop=4``, prompt-lookup and
  draft-model speculation, paged KV, a prefix-reused chunked admission.
- A forged journal ends in ``ReplayDivergence``'s error chunk
  (``qt_error: resume_diverged``) and a ``resume_chars`` mismatch in the
  pre-admission divergence, both in the JAX app's words.
- A parked non-streamed request is a retryable 503 (the JAX package's
  ``test_drain_park_non_streaming_is_retryable_503``); a parked stream ends
  ``finish_reason: "parked"``.
- ``/admin/drain[?park=1]``, ``GET /admin/drain``, ``/admin/undrain``,
  ``/health`` (``degraded``) and ``/ready`` (503) while draining: the JAX
  app's statuses and bodies; no engine to drain is the same 404.
"""

import asyncio
import json
import threading
import time
import types

import httpx
import jax
import numpy as np
import pytest
import torch

from quorum_tpu.backends.fake import FakeBackend as JaxFake
from quorum_tpu.backends.tpu_backend import TpuBackend
from quorum_tpu.config import Config as JaxConfig
from quorum_tpu.engine.engine import InferenceEngine as JaxEngine
from quorum_tpu.engine.engine import QueueFullError as JaxQueueFull
from quorum_tpu.models.init import init_params as jax_init_params
from quorum_tpu.models.model_config import resolve_spec as jax_resolve_spec
from quorum_tpu.ops.sampling import SamplerConfig as JaxSampler
from quorum_tpu.server.app import create_app as jax_create_app
from quorum_tpu_torch import sse
from quorum_tpu_torch.backends.base import BackendError
from quorum_tpu_torch.backends.cuda_backend import CudaBackend
from quorum_tpu_torch.backends.fake import FakeBackend
from quorum_tpu_torch.config import Config
from quorum_tpu_torch.engine.engine import InferenceEngine, QueueFullError, ReplayDivergence
from quorum_tpu_torch.models.convert import params_from_numpy
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.ops.sampling import SamplerConfig
from quorum_tpu_torch.server.app import create_app

OPTS = {"dtype": "float32", "max_seq": "256"}
AUTH = {"Authorization": "Bearer t"}
CHAT = {"model": "m", "messages": [{"role": "user", "content": "resume me"}],
        "max_tokens": 12, "temperature": 0, "stream": True}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def weights():
    jspec = jax_resolve_spec("llama-tiny", OPTS)
    jparams = jax.tree.map(np.asarray, jax_init_params(jspec, seed=4))
    return jspec, jparams


def _port(weights, **knobs):
    return InferenceEngine(resolve_spec("llama-tiny", OPTS), device="cpu",
                           params=params_from_numpy(weights[1], device="cpu"), **knobs)


def _raw(model="m"):
    return {"settings": {"timeout": 120},
            "primary_backends": [{"name": "L", "url": "x://llama-tiny", "model": model}]}


@pytest.fixture(scope="module")
def apps(weights):
    """(JAX app, port app, port sibling app) on one weight set; engines
    with 2 slots and 4-step chunks."""
    jspec, jparams = weights
    jeng = JaxEngine(jspec, params=jparams, n_slots=2, decode_chunk=4)
    teng, sib = _port(weights, n_slots=2, decode_chunk=4), _port(weights, n_slots=2,
                                                                 decode_chunk=4)
    yield (jax_create_app(JaxConfig(raw=_raw()), L=TpuBackend("L", jeng, model="m")),
           create_app(Config(raw=_raw()), L=CudaBackend("L", teng, model="m",
                                                        model_id="llama-tiny")),
           create_app(Config(raw=_raw()), L=CudaBackend("L", sib, model="m",
                                                        model_id="llama-tiny")))
    for e in (jeng, teng, sib):
        e.shutdown()


async def call(app, body=None, method="POST", path="/v1/chat/completions"):
    async with httpx.AsyncClient(transport=httpx.ASGITransport(app=app),
                                 base_url="http://t") as client:
        return await client.request(method, path, json=body, headers=AUTH)


def _stream(resp):
    """(joined text, qt_tokens, finish_reason, error chunk or None)."""
    events = [e for e in sse.iter_data_events(resp.content) if isinstance(e, dict)]
    err = next((e for e in events if e.get("id") == "error"), None)
    events = [e for e in events if e.get("choices") and e is not err]
    text = "".join(e["choices"][0]["delta"].get("content") or "" for e in events)
    ids = [t for e in events for t in e.get("qt_tokens") or ()]
    finish = next((e["choices"][0]["finish_reason"] for e in events
                   if e["choices"][0].get("finish_reason")), None)
    return text, ids, finish, err


def _engine(app):
    return app.state["registry"].backends[0].engine


# ---- drain and park against the JAX engine ---------------------------------------

def _consume(eng, req, out):
    try:
        out.extend(eng.stream_results(req))
    except Exception as e:  # noqa: BLE001 - recorded for the assertion
        out.append(e)


@pytest.mark.parametrize("depth", [1, 4])
def test_drain_park_matches_jax(weights, depth):
    """2 slots, 4 requests: 2 active (each past its first tokens) and 2
    queued when the drain with park starts."""
    jspec, jparams = weights
    jeng = JaxEngine(jspec, params=jparams, n_slots=2, decode_chunk=4, decode_pipeline=depth)
    teng = _port(weights, n_slots=2, decode_chunk=4, decode_pipeline=depth)
    try:
        seen = []
        for eng, sampler, full in ((jeng, JaxSampler(temperature=0.0), JaxQueueFull),
                                   (teng, SamplerConfig(temperature=0.0), QueueFullError)):
            reqs = [eng.submit([5 + i, 6, 7, 8], max_new_tokens=200, sampler=sampler)
                    for i in range(4)]
            outs = [[] for _ in reqs]
            threads = [threading.Thread(target=_consume, args=(eng, r, o))
                       for r, o in zip(reqs, outs)]
            for t in threads:
                t.start()
            deadline = time.monotonic() + 60
            while not (len(outs[0]) >= 2 and len(outs[1]) >= 2) and time.monotonic() < deadline:
                time.sleep(0.005)
            first = eng.drain(park=True)
            for t in threads:
                t.join(timeout=60)
            status = eng.drain_status()
            with pytest.raises(full) as ei:
                eng.submit([1, 2, 3], max_new_tokens=4, sampler=sampler)
            m = eng.metrics()
            seen.append({
                "first": {k: first[k] for k in ("draining", "park", "parked_total")},
                "status": status, "parked": [r.parked for r in reqs],
                "queued_empty": [len(o) == 0 for o in outs[2:]],
                "error": (str(ei.value), getattr(ei.value, "retry_after", None)),
                "metrics": (m["draining"], m["drain_parked_total"]),
                "health": eng.health()["draining"],
                "undrain": eng.undrain(),
                "serves_again": len(list(eng.generate_stream([1, 2, 3], max_new_tokens=3,
                                                             sampler=sampler)))})
        assert seen[1] == seen[0]
        assert seen[1]["first"] == {"draining": True, "park": True, "parked_total": 2}
        assert seen[1]["status"] == {"draining": True, "park": True, "resident": 0,
                                     "parked_total": 4}
        assert seen[1]["parked"] == [True] * 4 and seen[1]["error"] == ("engine draining", 1.0)
    finally:
        jeng.shutdown()
        teng.shutdown()


def test_drain_without_park_lets_residents_finish(weights):
    eng = _port(weights, n_slots=2, decode_chunk=4)
    try:
        reqs = [eng.submit([5 + i, 6, 7], max_new_tokens=10) for i in range(3)]
        eng.drain()
        outs = [list(eng.stream_results(r)) for r in reqs]
        assert [len(o) for o in outs] == [10, 10, 10] and not any(r.parked for r in reqs)
        assert eng.drain_status() == {"draining": True, "park": False, "resident": 0,
                                      "parked_total": 0}
    finally:
        eng.shutdown()


# ---- stream resume through the apps --------------------------------------------

def _received(resp, k):
    """The journal a client holds after the first ``k`` content chunks of
    a ``stream_token_ids`` stream: (their ids, the length of their text)."""
    events = [e for e in sse.iter_data_events(resp.content)
              if isinstance(e, dict) and e.get("qt_tokens")]
    return ([t for e in events[:k] for t in e["qt_tokens"]],
            sum(len(e["choices"][0]["delta"]["content"]) for e in events[:k]))


async def test_resumed_greedy_streams_match_jax(apps):
    japp, app, sib = apps
    resp = await call(app, {**CHAT, "stream_token_ids": True})
    whole, jwhole = _stream(resp), _stream(await call(japp, {**CHAT, "stream_token_ids": True}))
    assert whole == jwhole and len(whole[1]) == CHAT["max_tokens"]
    journal, n_chars = _received(resp, 3)
    assert 0 < len(journal) < CHAT["max_tokens"]
    body = {**CHAT, "stream_token_ids": True, "resume_tokens": journal,
            "resume_chars": n_chars}
    before = [_engine(a).metrics()["replayed_tokens_total"] for a in (japp, app, sib)]
    got = [_stream(await call(a, body)) for a in (japp, app, sib)]
    after = [_engine(a).metrics()["replayed_tokens_total"] for a in (japp, app, sib)]
    assert got[0][3] is None and got[1] == got[0] == got[2]
    assert got[1][1] == whole[1][len(journal):]  # only the continuation's ids
    assert got[1][0] == whole[0][n_chars:]
    assert [b - a for a, b in zip(before, after)] == [len(journal)] * 3
    # qt_tokens only when asked for
    plain = _stream(await call(app, {**CHAT, "resume_tokens": journal}))
    assert plain[1] == [] and plain[0] == got[1][0]


async def test_forged_journal_and_chars_mismatch_in_jax_words(apps):
    japp, app, _ = apps
    ids = _stream(await call(app, {**CHAT, "stream_token_ids": True}))[1]
    forged = list(ids[:6])
    forged[2] = (forged[2] + 1) % 512
    for body, words in (({**CHAT, "resume_tokens": forged}, "replay diverged at position 2"),
                        ({**CHAT, "resume_tokens": ids[:4], "resume_chars": 99},
                         "resume replay diverged before admission: journal renders")):
        (_, _, _, err), (_, _, _, jerr) = [_stream(await call(a, body)) for a in (app, japp)]
        assert err is not None and jerr is not None
        assert err["qt_error"] == jerr["qt_error"] == "resume_diverged"
        assert err["choices"][0]["delta"]["content"] == jerr["choices"][0]["delta"]["content"]
        assert words in err["choices"][0]["delta"]["content"]
        assert err["choices"][0]["finish_reason"] == "error"


async def test_resume_400s_match_jax(apps):
    """The budget check (the backend's, in JAX's words) and the engine's
    journal check past a clamped budget."""
    japp, app, _ = apps
    for body in ({**CHAT, "resume_tokens": [300] * 13},
                 {**CHAT, "resume_tokens": [600]}):
        resp, jresp = await call(app, body), await call(japp, body)
        assert resp.status_code == jresp.status_code == 400
        assert resp.json() == jresp.json()


@pytest.mark.parametrize("knobs", [
    {"decode_pipeline": 4, "decode_loop": 4},
    {"spec_decode": 4},
    {"spec_decode": 4, "decode_loop": 2, "draft": True},
    {"kv_pages": True, "kv_page_size": 16},
    {"prefill_chunk": 16},
], ids=["ring4_loop4", "prompt_lookup", "draft_fused", "paged", "prefix_reuse"])
def test_sampled_resume_equals_unbroken_run(weights, knobs):
    """The unbroken run on a plain engine; the resume on an engine whose
    dispatches or admission take another path (prefix_reuse: the same
    engine again, its slot holding the prompt)."""
    knobs = dict(knobs)
    if knobs.pop("draft", False):
        knobs.update(draft_spec=resolve_spec("llama-tiny", OPTS), draft_seed=9)
    sampler = SamplerConfig(temperature=0.8, top_p=0.9)
    prompt = [(i * 7) % 200 + 3 for i in range(40)]
    base = _port(weights, n_slots=2, decode_chunk=4)
    other = base if "prefill_chunk" in knobs else _port(weights, n_slots=2, decode_chunk=4,
                                                         **knobs)
    try:
        if other is base:
            base.prefill_chunk = knobs["prefill_chunk"]
        full = list(base.generate_stream(prompt, max_new_tokens=24, sampler=sampler, seed=17))
        m0 = other.metrics()
        req = other.submit(prompt, max_new_tokens=24, sampler=sampler, seed=17,
                           resume_tokens=full[:9])
        rest = list(other.stream_results(req))
        m1 = other.metrics()
    finally:
        base.shutdown()
        if other is not base:
            other.shutdown()
    assert rest == full[9:]
    assert m1["replayed_tokens_total"] - m0["replayed_tokens_total"] == 9
    assert m1["tokens_total"] - m0["tokens_total"] == len(full) - 9
    if other is base:
        assert m1["prefix_tokens_saved_total"] > m0["prefix_tokens_saved_total"]


def test_engine_journal_checks_and_divergence(weights):
    eng = _port(weights, n_slots=1, decode_chunk=4)
    try:
        with pytest.raises(ValueError, match="out-of-vocabulary"):
            eng.submit([1, 2], max_new_tokens=4, resume_tokens=[512])
        with pytest.raises(ValueError, match=r"longer \(5\) than the generation budget \(4\)"):
            eng.submit([1, 2], max_new_tokens=4, resume_tokens=[3] * 5)
        full = list(eng.generate_stream([1, 2, 3], max_new_tokens=6))
        whole = eng.submit([1, 2, 3], max_new_tokens=6, resume_tokens=full)
        assert list(eng.stream_results(whole)) == []  # the journal covered the budget
        bad = eng.submit([1, 2, 3], max_new_tokens=6,
                         resume_tokens=full[:2] + [(full[2] + 1) % 512])
        with pytest.raises(ReplayDivergence, match="replay diverged at position 2"):
            list(eng.stream_results(bad))
    finally:
        eng.shutdown()


# ---- parking through the backend and the app -----------------------------------

class _ParkingEngine:
    """A few tokens, then ``req.parked`` set before the stream ends."""

    def __init__(self, spec, tokens):
        self.spec, self.tokens = spec, list(tokens)

    def submit(self, prompt_ids, *, cancel=None, **kw):
        return types.SimpleNamespace(parked=False, lp=[], cancel=cancel)

    def stream_results(self, req):
        yield from self.tokens
        req.parked = True


async def test_drain_park_non_streaming_is_retryable_503(weights):
    """No journal without a stream: the partial text is a retryable 503
    overload, never a truncated 200."""
    teng = _port(weights, n_slots=1)
    try:
        b = CudaBackend("park", teng, model="m", model_id="llama-tiny")
        b.engine = _ParkingEngine(teng.spec, [7, 8, 9])
        body = {"model": "m", "messages": [{"role": "user", "content": "x"}], "max_tokens": 8}
        with pytest.raises(BackendError) as ei:
            await b.complete(body, {}, 60)
        jb = TpuBackend("park", JaxEngine(weights[0], params=weights[1], n_slots=1), model="m")
        jeng, jb.engine = jb.engine, _ParkingEngine(weights[0], [7, 8, 9])
        try:
            with pytest.raises(Exception) as jei:
                await jb.complete(body, {}, 60)
        finally:
            jeng.shutdown()
    finally:
        teng.shutdown()
    e, je = ei.value, jei.value
    assert e.status_code == je.status_code == 503
    assert e.body == je.body and e.body["error"]["type"] == "overloaded_error"
    assert "draining" in str(e) and e.headers == je.headers == {"Retry-After": "1"}


async def test_admin_drain_routes_match_jax(apps):
    japp, app, _ = apps
    chat = {**CHAT, "stream": False, "max_tokens": 2}
    got = {}
    for name, a in (("jax", japp), ("port", app)):
        rows = {}
        rows["drain"] = await call(a, method="POST", path="/admin/drain?park=1")
        rows["status"] = await call(a, method="GET", path="/v1/admin/drain")
        rows["health"] = await call(a, method="GET", path="/health")
        rows["ready"] = await call(a, method="GET", path="/v1/ready")
        rows["chat"] = await call(a, chat)
        rows["undrain"] = await call(a, method="POST", path="/v1/admin/undrain")
        rows["ready_after"] = await call(a, method="GET", path="/ready")
        rows["chat_after"] = await call(a, chat)
        got[name] = rows
    j, t = got["jax"], got["port"]
    assert {k: r.status_code for k, r in t.items()} == {k: r.status_code for k, r in j.items()}
    assert t["drain"].status_code == 200 and t["ready"].status_code == 503
    assert t["chat"].status_code == 503 and t["chat"].headers["retry-after"] == "1"
    assert t["chat"].json() == j["chat"].json()
    for key in ("drain", "status", "undrain"):
        strip = [{k: v for k, v in row.items()} for row in t[key].json()["engines"]]
        jstrip = [{k: v for k, v in row.items()} for row in j[key].json()["engines"]]
        assert strip == jstrip, key
        assert t[key].json().keys() == j[key].json().keys()
    assert t["status"].json()["resident"] == 0
    assert t["health"].json()["status"] == j["health"].json()["status"] == "degraded"
    assert t["health"].json()["checks"][0]["draining"] is True
    assert t["ready"].json()["reason"] == j["ready"].json()["reason"] == "degraded"
    # no engine to drain: the same 404
    raw = {"settings": {"timeout": 60},
           "primary_backends": [{"name": "F", "url": "http://fake.example", "model": "m"}]}
    resp = await call(create_app(Config(raw=raw), F=FakeBackend("F", model="m")),
                      method="POST", path="/admin/drain")
    jresp = await call(jax_create_app(JaxConfig(raw=raw), F=JaxFake("F", model="m")),
                       method="POST", path="/admin/drain")
    assert resp.status_code == jresp.status_code == 404 and resp.json() == jresp.json()


async def test_parked_stream_finishes_parked_and_metrics(apps):
    """A stream mid-generation when the drain with park lands: finish
    ``parked``, then [DONE]; /metrics carries the lifecycle families."""
    _, app, _ = apps
    eng = _engine(app)
    orig = eng._dispatch_chunk

    def slow(active):
        time.sleep(0.02)
        return orig(active)

    eng._dispatch_chunk = slow
    try:
        t0 = eng.metrics()["tokens_total"]
        task = asyncio.create_task(call(app, {**CHAT, "max_tokens": 120,
                                              "stream_token_ids": True}))
        deadline = time.monotonic() + 60
        while eng.metrics()["tokens_total"] < t0 + 8 and time.monotonic() < deadline:
            await asyncio.sleep(0.005)
        await call(app, method="POST", path="/admin/drain?park=1")
        resp = await task
    finally:
        eng._dispatch_chunk = orig
        await call(app, method="POST", path="/admin/undrain")
    text, ids, finish, err = _stream(resp)
    assert err is None and finish == "parked" and 0 < len(ids) < 120
    assert resp.text.rstrip().endswith("data: [DONE]")
    metrics = (await call(app, method="GET", path="/metrics")).text
    assert '# TYPE quorum_tpu_engine_draining gauge' in metrics
    assert 'quorum_tpu_engine_draining{backend="L"} 0' in metrics
    assert "# TYPE quorum_tpu_engine_drain_parked_total counter" in metrics
    assert "# TYPE quorum_tpu_engine_replayed_tokens_total counter" in metrics
    # the parked stream resumes on the same engine from its journal
    body = {**CHAT, "max_tokens": 120, "resume_tokens": ids, "resume_chars": len(text)}
    rest = _stream(await call(app, body))
    whole = _stream(await call(app, {**CHAT, "max_tokens": 120}))
    assert text + rest[0] == whole[0]
    json.dumps(rest)
