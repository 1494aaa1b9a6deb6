"""Request tracing on the port's server against the JAX package's: the
same requests through both apps on the same weights (llama-tiny, float32,
greedy) give the same span names — the engine's spans in the same order,
the server's and strategies' in the same order — with TTFT and wire timings
set; the trace routes answer as JAX's do (listing, detail, 404, 405 on a
param route, both prefixes); W3C ``traceparent`` is honored from the header
or the body and echoed; and the trace store, span cap, token-time cap and
coalesced decode spans bound a trace as JAX's do. CPU."""

import collections

import httpx
import jax
import numpy as np
import pytest
import torch

from quorum_tpu import observability as jax_obs
from quorum_tpu.backends.tpu_backend import TpuBackend
from quorum_tpu.config import Config as JaxConfig
from quorum_tpu.engine.engine import InferenceEngine as JaxEngine
from quorum_tpu.models.init import init_params as jax_init_params
from quorum_tpu.models.model_config import resolve_spec as jax_resolve_spec
from quorum_tpu.server.app import create_app as jax_create_app
from quorum_tpu_torch import observability as obs
from quorum_tpu_torch.backends.cuda_backend import CudaBackend
from quorum_tpu_torch.config import Config
from quorum_tpu_torch.engine.engine import InferenceEngine
from quorum_tpu_torch.models.convert import params_from_numpy
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.ops.sampling import SamplerConfig
from quorum_tpu_torch.server.app import create_app
from quorum_tpu_torch.telemetry.recorder import RECORDER

AUTH = {"Authorization": "Bearer x"}
OPTS = {"dtype": "float32"}
ENGINE_SPANS = {"queue-wait", "prefill", "prefix-restore", "decode", "spec-verify",
                "deadline-exceeded", "engine-failure"}
TRACEPARENT = "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01"


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def pairs():
    """Two backends on two seeds, each as a JAX engine and a port engine on
    the same (converted) weights."""
    jspec = jax_resolve_spec("llama-tiny", OPTS)
    out = []
    for seed in (1, 2):
        jparams = jax.tree.map(np.asarray, jax_init_params(jspec, seed=seed))
        out.append((JaxEngine(jspec, params=jparams, n_slots=2),
                    InferenceEngine(resolve_spec("llama-tiny", OPTS), device="cpu", n_slots=2,
                                    params=params_from_numpy(jparams, device="cpu"))))
    yield out
    for je, te in out:
        je.shutdown()
        te.shutdown()


def _raw(n: int, scheme: str) -> dict:
    raw = {"settings": {"timeout": 60},
           "primary_backends": [{"name": f"LLM{i + 1}", "url": f"{scheme}://llama-tiny",
                                 "model": "llama-tiny"} for i in range(n)]}
    if n > 1:
        raw["iterations"] = {"aggregation": {"strategy": "concatenate"}}
        raw["strategy"] = {"concatenate": {"separator": "\n---\n"},
                           "aggregate": {"source_backends": "all", "aggregator_backend": ""}}
    return raw


def _apps(pairs, n: int):
    jb = {f"LLM{i + 1}": TpuBackend(f"LLM{i + 1}", pairs[i][0]) for i in range(n)}
    tb = {f"LLM{i + 1}": CudaBackend(f"LLM{i + 1}", pairs[i][1], model_id="llama-tiny")
          for i in range(n)}
    return (create_app(Config(raw=_raw(n, "cuda")), **tb),
            jax_create_app(JaxConfig(raw=_raw(n, "tpu")), **jb))


def _client(app):
    return httpx.AsyncClient(transport=httpx.ASGITransport(app=app), base_url="http://t")


async def _traced(app, body, headers=AUTH) -> tuple[httpx.Response, dict]:
    async with _client(app) as client:
        resp = await client.post("/v1/chat/completions", json=body, headers=headers)
        got = await client.get(f"/debug/traces/{resp.headers['x-request-id']}")
    assert got.status_code == 200, got.text
    return resp, got.json()


def _layers(trace) -> tuple[list, list, collections.Counter]:
    names = [s["name"] for s in trace["spans"]]
    return ([n for n in names if n in ENGINE_SPANS], [n for n in names if n not in ENGINE_SPANS],
            collections.Counter(names))


BODY = {"model": "llama-tiny", "max_tokens": 6, "temperature": 0,
        "messages": [{"role": "user", "content": "hi"}]}


@pytest.mark.parametrize("n,stream", [(1, False), (1, True), (2, False), (2, True)],
                         ids=["single", "single-stream", "parallel", "parallel-stream"])
async def test_span_names_and_order_equal_jax(pairs, n, stream):
    """The port's trace of a request has JAX's span names: the engine's
    spans (one engine: in the same order) and the server/strategy spans in
    the same order. Spans of two threads interleave by timing, so the
    layers are compared each in its own order, and all names as a
    multiset."""
    app, japp = _apps(pairs, n)
    body = {**BODY, "stream": stream}
    resp, trace = await _traced(app, body)
    jresp, jtrace = await _traced(japp, body)
    assert resp.status_code == jresp.status_code == 200
    engine, server, names = _layers(trace)
    jengine, jserver, jnames = _layers(jtrace)
    assert names == jnames, (trace["spans"], jtrace["spans"])
    assert server == jserver
    if n == 1:
        assert engine == jengine
    assert names["queue-wait"] == names["prefill"] == n and names["decode"] >= n
    assert trace["status"] == 200 and trace["in_flight"] is False
    assert set(trace) == set(jtrace)
    starts = [s["start_s"] for s in trace["spans"]]
    assert starts == sorted(starts)
    assert all(s["end_s"] is not None and s["end_s"] >= s["start_s"] for s in trace["spans"])
    decode = next(s for s in trace["spans"] if s["name"] == "decode")
    assert decode["meta"]["steps"] >= 1 and decode["meta"]["occupancy"] >= 1
    if stream:
        assert trace["ttft_ms"] is not None and trace["tokens"] >= 1
        assert trace["token_times_ms"][0] == trace["ttft_ms"]
        assert trace["tokens"] == jtrace["tokens"]
    if n == 2:
        assert {s["meta"]["backend"] for s in trace["spans"]
                if s["name"].startswith("fanout-")} == {"LLM1", "LLM2"}


async def test_trace_listing_detail_and_miss_equal_jax(pairs):
    app, japp = _apps(pairs, 2)
    for a in (app, japp):
        async with _client(a) as client:
            resp = await client.post("/chat/completions", json=BODY, headers=AUTH)
            rid = resp.headers["x-request-id"]
            listing = (await client.get("/debug/traces")).json()
            rows = {t["request_id"]: t for t in listing["traces"]}
            assert set(listing) == {"capacity", "in_flight", "completed", "traces"}
            assert rid in rows and "spans" not in rows[rid] and rows[rid]["status"] == 200
            assert rows[rid]["trace_id"] and rows[rid]["meta"]["mode"] == "parallel-complete"
            detail = (await client.get(f"/v1/debug/traces/{rid}")).json()
            assert {"fanout", "aggregate", "queue-wait", "prefill"} <= {
                s["name"] for s in detail["spans"]}
            missing = await client.get("/debug/traces/req-does-not-exist")
            assert missing.status_code == 404
            assert missing.json()["error"]["type"] == "invalid_request_error"
            for method, path in (("POST", "/debug/traces/req-x"),
                                 ("PUT", "/v1/debug/traces/req-x"), ("POST", "/metrics"),
                                 ("POST", "/debug/telemetry")):
                assert (await client.request(method, path, json={})).status_code == 405
            assert (await client.get("/debug/traces/a/b")).status_code == 404


async def test_traceparent_header_is_honored_and_echoed(pairs):
    app, japp = _apps(pairs, 1)
    client_src = obs.TRACE_PROPAGATED.value_of(source="client")
    RECORDER.reset()
    for a in (app, japp):
        resp, trace = await _traced(a, BODY, headers={**AUTH, "traceparent": TRACEPARENT})
        assert resp.status_code == 200
        assert trace["trace_id"] == TRACEPARENT.split("-")[1]
        echoed = resp.headers["traceparent"].split("-")
        assert echoed[1] == TRACEPARENT.split("-")[1] and echoed[2] != TRACEPARENT.split("-")[2]
        assert resp.headers["x-request-id"].startswith("req-")
    assert obs.TRACE_PROPAGATED.value_of(source="client") == client_src + 1
    # The engine's events carry the trace id as their correlation key.
    assert any(e.get("rid") == TRACEPARENT.split("-")[1] and e["kind"] == "admit"
               for e in RECORDER.snapshot())


async def test_traceparent_body_knob_and_bad_value_equal_jax(pairs):
    app, japp = _apps(pairs, 1)
    resp, trace = await _traced(app, {**BODY, "traceparent": TRACEPARENT})
    assert resp.status_code == 200 and trace["trace_id"] == TRACEPARENT.split("-")[1]
    bad = {**BODY, "traceparent": "00-zz-nope-01"}
    async with _client(app) as c, _client(japp) as jc:
        r, jr = (await c.post("/v1/chat/completions", json=bad, headers=AUTH),
                 await jc.post("/v1/chat/completions", json=bad, headers=AUTH))
    assert r.status_code == jr.status_code == 400
    assert r.json() == jr.json()
    minted = obs.TRACE_PROPAGATED.value_of(source="server")
    await _traced(app, BODY)
    assert obs.TRACE_PROPAGATED.value_of(source="server") == minted + 1


def _store_snapshot(mod):
    store = mod.TraceStore(capacity=4)
    for i in range(10):
        t = mod.RequestTrace(f"req-{i}")
        store.start(t)
        t.finish(status=200)
        store.complete(t)
    snap = store.snapshot()
    return ([t["request_id"] for t in snap["traces"]], snap["completed"],
            store.get("req-0") is None, store.get("req-9") is not None)


def test_trace_store_ring_bound_equals_jax():
    assert _store_snapshot(obs) == _store_snapshot(jax_obs) == (
        ["req-9", "req-8", "req-7", "req-6"], 4, True, True)


def _capped(mod):
    t = mod.RequestTrace("req-cap")
    for _ in range(mod.MAX_SPANS + 25):
        t.add_span("decode", 0.0, 0.001)
    for _ in range(mod.MAX_TOKEN_TIMES + 10):
        t.mark_flush(True)
    t.finish(status=200)
    late = t.add_span("late", 1.0, 2.0)  # a completed trace is immutable
    d = t.to_dict()
    return (len(d["spans"]), d["dropped_spans"], len(d["token_times_ms"]), d["tokens"],
            d["sse_flushes"], late.name)


def test_span_and_token_time_caps_equal_jax():
    got = _capped(obs)
    assert got == _capped(jax_obs)
    assert got[:4] == (obs.MAX_SPANS, 26, obs.MAX_TOKEN_TIMES, obs.MAX_TOKEN_TIMES + 10)


def test_long_generation_coalesces_decode_spans():
    """Past TURN_SPAN_CAP decode turns a request's last decode span
    extends (steps summed, turns counted): the span budget stays for the
    spans at the end of a stream."""
    eng = InferenceEngine(resolve_spec("llama-tiny", {"max_seq": "1024"}), device="cpu",
                          decode_chunk=2, n_slots=1)
    try:
        trace = obs.RequestTrace("req-long")
        with obs.use_trace(trace):
            req = eng.submit([5, 6, 7], max_new_tokens=200,
                             sampler=SamplerConfig(temperature=0.0))
        assert len(list(eng.stream_results(req))) == 200
        decode = [s for s in trace.spans if s.name == "decode"]
        assert 1 <= len(decode) <= eng.TURN_SPAN_CAP
        assert sum(s.meta.get("steps", 0) for s in decode) >= 199
        if len(decode) == eng.TURN_SPAN_CAP:
            assert decode[-1].meta.get("coalesced_turns", 0) >= 1
        assert [s.name for s in trace.spans][:2] == ["queue-wait", "prefill"]
    finally:
        eng.shutdown()


@pytest.mark.parametrize("path", ["/debug/traces", "/v1/debug/traces"])
async def test_debug_traces_served_on_both_prefixes(pairs, path):
    app, _ = _apps(pairs, 1)
    async with _client(app) as client:
        resp = await client.get(path)
    assert resp.status_code == 200
    assert set(resp.json()) == {"capacity", "in_flight", "completed", "traces"}


async def test_every_response_carries_a_request_id(pairs):
    app, _ = _apps(pairs, 1)
    async with _client(app) as client:
        for method, path in (("GET", "/health"), ("GET", "/nope"), ("GET", "/metrics")):
            assert (await client.request(method, path)).headers["x-request-id"].startswith(
                "req-")
        bad = await client.post("/v1/chat/completions", content=b"{not json", headers=AUTH)
        assert bad.status_code == 400 and bad.headers["x-request-id"].startswith("req-")
        assert "traceparent" in bad.headers


@pytest.mark.parametrize("value", [TRACEPARENT, TRACEPARENT.upper(), f" {TRACEPARENT} ", None, "",
                                   "01-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
                                   "00-" + "0" * 32 + "-00f067aa0ba902b7-01",
                                   "00-4bf92f3577b34da6a3ce929d0e0e4736-" + "0" * 16 + "-01",
                                   "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7", 7])
def test_traceparent_parse_format_child_equal_jax(value):
    from quorum_tpu.telemetry import tracecontext as jax_tc
    from quorum_tpu_torch.telemetry import tracecontext as tc

    got = tc.parse_traceparent(value)
    assert got == jax_tc.parse_traceparent(value)
    if got is not None:
        trace_id, span_id = got
        assert tc.format_traceparent(trace_id, span_id) == jax_tc.format_traceparent(trace_id,
                                                                                     span_id)
        child_span, header = tc.child_traceparent(trace_id)
        assert tc.parse_traceparent(header) == (trace_id, child_span) != got
        assert jax_tc.parse_traceparent(header) == (trace_id, child_span)
    assert len(tc.new_trace_id()) == 32 and len(tc.new_span_id()) == 16
