"""The port's fan-out strategies (quorum_tpu_torch.strategies) and the app's
parallel modes against the JAX package's.

Units: ``build_aggregation_prompt``, ``sum_usage``, ``degraded_headers`` and
``StreamPlan`` from the same config dicts give the same results. App level:
each scenario scripts the same ``FakeBackend``s (each package's own class)
and sends the same request through the port's app and the JAX package's;
the responses must be equal after normalization — ``created`` and random
ids dropped, and member deltas (``chatcmpl-parallel-{i}``) compared per
member, since members interleave in any order. What each backend was sent
(bodies, streamed or not) must be equal too.
"""

import json
import re

import pytest

from quorum_tpu import oai as jax_oai
from quorum_tpu.backends.base import BackendError as JaxBackendError
from quorum_tpu.backends.fake import FakeBackend as JaxFake
from quorum_tpu.backends.registry import BackendRegistry as JaxRegistry
from quorum_tpu.config import Config as JaxConfig
from quorum_tpu.server.app import create_app as jax_create_app
from quorum_tpu.strategies.aggregate import AggregateOutcome as JaxOutcome
from quorum_tpu.strategies.aggregate import build_aggregation_prompt as jax_prompt
from quorum_tpu.strategies.combine import degraded_headers as jax_degraded_headers
from quorum_tpu.strategies.streaming import StreamPlan as JaxStreamPlan
from quorum_tpu_torch import oai, sse
from quorum_tpu_torch.backends.base import BackendError
from quorum_tpu_torch.backends.fake import FakeBackend
from quorum_tpu_torch.backends.registry import BackendRegistry
from quorum_tpu_torch.config import Config
from quorum_tpu_torch.server.app import create_app
from quorum_tpu_torch.strategies.aggregate import AggregateOutcome, build_aggregation_prompt
from quorum_tpu_torch.strategies.combine import degraded_headers
from quorum_tpu_torch.strategies.streaming import StreamPlan

NAMES = ["LLM1", "LLM2", "LLM3"]
BODY = {"model": "m", "messages": [{"role": "system", "content": "sys"},
                                   {"role": "user", "content": "What is a quorum?"},
                                   {"role": "user", "content": "second"}]}
AGG_BLOCKS = [
    {},
    {"include_source_names": True, "intermediate_separator": "\n==\n",
     "prompt_template": "Sources:\n{{intermediate_results}}\nDone."},
    {"include_original_query": False, "prompt_template": "Legacy {responses} template"},
    {"prompt_template": "No placeholder at all", "query_format": "Q={query}|",
     "source_label_format": "[{backend_name}] "},
]


def _config(strategy="concatenate", concatenate=None, aggregate=None, n=3, parallel=True):
    raw = {"settings": {"timeout": 10},
           "primary_backends": [{"name": name, "url": f"http://{name.lower()}.test/v1",
                                 "model": f"model-{i}"} for i, name in enumerate(NAMES[:n])]}
    if parallel:
        raw["iterations"] = {"aggregation": {"strategy": strategy}}
        raw["strategy"] = {"concatenate": {"separator": "\n---\n", **(concatenate or {})},
                           "aggregate": {"aggregator_backend": "LLM1", **(aggregate or {})}}
    return raw


# ---- units -------------------------------------------------------------------

@pytest.mark.parametrize("block", AGG_BLOCKS)
@pytest.mark.parametrize("query", ["What is a quorum?", "", "ünïcode {braces}"])
def test_build_aggregation_prompt_matches_jax(block, query):
    sources = [("LLM1", "first answer"), ("LLM2", ""), ("LLM3", "third\nanswer")]
    raw = _config("aggregate", aggregate=block)
    assert (build_aggregation_prompt(sources, Config(raw=raw).aggregate, query)
            == jax_prompt(sources, JaxConfig(raw=raw).aggregate, query))


@pytest.mark.parametrize("usages", [
    [], [None], [{"prompt_tokens": 3, "completion_tokens": 4, "total_tokens": 7}, None,
                 {"prompt_tokens": "2", "completion_tokens": None, "total_tokens": 2.0}],
    [{"completion_tokens": 5}, {"prompt_tokens": 1, "extra": 9}],
])
def test_sum_usage_matches_jax(usages):
    assert oai.sum_usage(usages) == jax_oai.sum_usage(usages)


@pytest.mark.parametrize("reason,error", [
    (None, None), ("no_aggregator", None), ("error", "upstream  said\n\tno"),
    ("empty", ""), ("error", "ünïcode → " + "x" * 400),
])
def test_degraded_headers_match_jax(reason, error):
    assert (degraded_headers(AggregateOutcome("c", reason, error))
            == jax_degraded_headers(JaxOutcome("c", reason, error)))
    assert degraded_headers(None) == jax_degraded_headers(None) == {}


@pytest.mark.parametrize("strategy,concatenate,aggregate,body_extra", [
    ("concatenate", {}, {}, {}),
    ("concatenate", {"hide_intermediate_think": False, "hide_final_think": True,
                     "skip_final_aggregation": True, "thinking_tags": ["x"]}, {},
     {"suppress_individual_responses": True}),
    ("aggregate", {}, {"source_backends": ["LLM3", "nope", "LLM2"]}, {}),
    ("aggregate", {}, {"source_backends": "LLM2", "suppress_individual_responses": True,
                       "strip_intermediate_thinking": False}, {}),
    ("aggregate", {}, {"suppress_individual_responses": True, "aggregator_backend": "nope"},
     {"suppress_individual_responses": False}),
])
def test_stream_plan_matches_jax(strategy, concatenate, aggregate, body_extra):
    raw = _config(strategy, concatenate, aggregate)
    body = {**BODY, **body_extra}
    port = StreamPlan.from_config(Config(raw=raw),
                                  BackendRegistry([FakeBackend(n) for n in NAMES]), body)
    ref = JaxStreamPlan.from_config(JaxConfig(raw=raw),
                                    JaxRegistry([JaxFake(n) for n in NAMES]), body)
    fields = ("strategy_name", "separator", "hide_intermediate", "hide_final", "thinking_tags",
              "skip_final", "suppress_individual", "user_query")
    assert {f: getattr(port, f) for f in fields} == {f: getattr(ref, f) for f in fields}
    assert [b.name for b in port.backends] == [b.name for b in ref.backends]
    assert (port.aggregator and port.aggregator.name) == (ref.aggregator and ref.aggregator.name)
    assert (port.aggregate_params is None) == (ref.aggregate_params is None)


# ---- the app, scripted -------------------------------------------------------

async def _call(app, body, headers=((b"authorization", b"Bearer t"),)):
    raw = json.dumps(body).encode()
    sent = []

    async def receive():
        return {"type": "http.request", "body": raw, "more_body": False}

    async def send(message):
        sent.append(message)

    await app({"type": "http", "method": "POST", "path": "/v1/chat/completions",
               "headers": list(headers)}, receive, send)
    hdrs = {k.decode().lower(): v.decode() for k, v in sent[0]["headers"]}
    return sent[0]["status"], hdrs, b"".join(m.get("body", b"") for m in sent[1:])


_RANDOM_ID = re.compile(r"chatcmpl-[0-9a-f]{24}")
_KEPT_HEADERS = ("content-type", "retry-after", "x-quorum-aggregate-degraded",
                 "x-quorum-aggregate-error")


def _scrub(obj):
    if isinstance(obj, dict):
        return {k: _scrub(v) for k, v in obj.items() if k != "created"}
    if isinstance(obj, list):
        return [_scrub(v) for v in obj]
    if isinstance(obj, str):
        # The JAX message names its router's module; the port has no router.
        return _RANDOM_ID.sub("chatcmpl-ID", obj).replace(
            " (python -m quorum_tpu.router)", "")
    return obj


def _normalize(status, headers, data):
    out = {"status": status, "headers": {k: headers.get(k) for k in _KEPT_HEADERS}}
    if headers.get("content-type") == "text/event-stream":
        events = [_scrub(e) for e in sse.iter_data_events(data)]
        members: dict[str, list] = {}
        rest = []
        for e in events:
            cid = e.get("id", "") if isinstance(e, dict) else ""
            if re.fullmatch(r"chatcmpl-parallel-\d+", cid):
                members.setdefault(cid, []).append(e)
            else:
                rest.append(e)
        out.update(events=rest, members=members)
    else:
        out["json"] = _scrub(json.loads(data))
    return out


def _fakes(fake_cls, error_cls, scripts):
    out = {}
    for name, script in scripts.items():
        kw = dict(script)
        if "fail" in kw:
            status, type_, msg, hdrs = kw.pop("fail")
            kw["fail_with"] = error_cls(msg, status_code=status,
                                        body={"error": {"message": msg, "type": type_,
                                                        "code": status}}, headers=hdrs)
        out[name] = fake_cls(name, model=kw.pop("model", f"model-{NAMES.index(name)}"), **kw)
    return out


def _calls(fakes):
    return {name: [(_scrub(c.body), c.streaming) for c in f.calls] for name, f in fakes.items()}


OK = {name: {"text": f"answer {i} from {name}"} for i, name in enumerate(NAMES)}
FAIL500 = {"fail": (500, "proxy_error", "upstream exploded", None)}
FAIL503 = {"fail": (503, "overloaded_error", "busy", {"Retry-After": "3"})}
FAIL400 = {"fail": (400, "invalid_request_error", "bad knob", None)}
THINK = {"LLM1": {"chunks": ["<thi", "nk>hidden</think>", "shown one"]},
         "LLM2": {"text": "<think>x</think> shown two "}, "LLM3": {"text": "three"}}
STREAM = {"stream": True}

SCENARIOS = {
    # name: (config, scripts, body extra, request headers)
    "concat": (_config(), OK, {}, None),
    "concat_stream": (_config(), OK, STREAM, None),
    "concat_partial_failure": (_config(), {**OK, "LLM2": FAIL500}, {}, None),
    "concat_partial_failure_stream": (_config(), {**OK, "LLM2": FAIL500}, STREAM, None),
    "concat_all_failed": (_config(), dict.fromkeys(NAMES, FAIL500), {}, None),
    "concat_all_failed_stream": (_config(), dict.fromkeys(NAMES, FAIL500), STREAM, None),
    "relay_503": (_config(), dict.fromkeys(NAMES, FAIL503), {}, None),
    "relay_400_mixed_503": (_config(), {"LLM1": FAIL400, "LLM2": FAIL503, "LLM3": FAIL400},
                            {}, None),
    "mixed_400_500": (_config(), {"LLM1": FAIL400, "LLM2": FAIL500, "LLM3": FAIL400}, {},
                      None),
    "mid_stream_failure": (_config(), {**OK, "LLM3": {"text": "abcdefgh",
                                                       "fail_mid_stream": 2}}, STREAM, None),
    "thinking_concat": (_config(concatenate={"thinking_tags": ["think"]}), THINK, {}, None),
    "thinking_concat_stream": (_config(concatenate={"thinking_tags": ["think"],
                                                    "hide_final_think": True}),
                               THINK, STREAM, None),
    "skip_final_stream": (_config(concatenate={"skip_final_aggregation": True}), OK, STREAM,
                          None),
    "suppress_per_request": (_config(), OK, {**STREAM, "suppress_individual_responses": True},
                             None),
    "aggregate": (_config("aggregate"), {**OK, "LLM1": {"text": "the synthesis"}}, {}, None),
    "aggregate_stream": (_config("aggregate"), {**OK, "LLM1": {"text": "the synthesis"}},
                         STREAM, None),
    "aggregate_stream_live": (_config("aggregate", aggregate={"stream_aggregate": True}),
                              {**OK, "LLM1": {"text": "<think>no</think>the synthesis"}},
                              STREAM, None),
    "aggregate_suppress_config": (_config("aggregate", aggregate={
        "suppress_individual_responses": True}), OK, STREAM, None),
    "aggregate_suppress_overridden": (_config("aggregate", aggregate={
        "suppress_individual_responses": True}), OK,
        {**STREAM, "suppress_individual_responses": False}, None),
    "aggregate_degraded_error": (_config("aggregate", aggregate={
        "source_backends": ["LLM2", "LLM3"]}), {**OK, "LLM1": FAIL500}, {}, None),
    "aggregate_degraded_stream_live": (_config("aggregate", aggregate={
        "source_backends": ["LLM2", "LLM3"], "stream_aggregate": True}),
        {**OK, "LLM1": FAIL500}, STREAM, None),
    "aggregate_no_aggregator": (_config("aggregate", aggregate={"aggregator_backend": ""}),
                                OK, {}, None),
    "aggregate_no_credentials": (_config("aggregate"), OK, {},
                                 ((b"x-api-key", b"none"),)),
    "source_backends": (_config("aggregate", aggregate={"source_backends": ["LLM3", "LLM2"],
                                                        "include_source_names": True}),
                        OK, {}, None),
    "source_backends_none": (_config("aggregate", aggregate={"source_backends": ["nope"]}),
                             OK, {}, None),
    "quorum_2": (_config(), OK, {"quorum": 2}, None),
    "quorum_1": (_config(), OK, {"quorum": 1}, None),
    "no_model": (_config(), {name: {"model": ""} for name in NAMES},
                 {"model": None}, None),
    "no_auth": (_config(), OK, {}, ()),
    "single_mode_first_success": (_config(parallel=False), {**OK, "LLM1": FAIL500}, {}, None),
    "single_mode_stream": (_config(parallel=False), OK, STREAM, None),
    "single_mode_stream_fails_first": (_config(parallel=False), {**OK, "LLM1": FAIL503},
                                       STREAM, None),
    "single_mode_mid_stream": (_config(parallel=False),
                               {**OK, "LLM1": {"text": "abcdefgh", "fail_mid_stream": 1}},
                               STREAM, None),
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
async def test_app_matches_jax_app(scenario, monkeypatch):
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    raw, scripts, extra, req_headers = SCENARIOS[scenario]
    body = {k: v for k, v in {**BODY, **extra}.items() if v is not None}
    headers = ((b"authorization", b"Bearer t"),) if req_headers is None else req_headers
    scripts = {name: scripts.get(name, {}) for name in NAMES}
    port_fakes = _fakes(FakeBackend, BackendError, scripts)
    jax_fakes = _fakes(JaxFake, JaxBackendError, scripts)
    got = _normalize(*await _call(create_app(Config(raw=raw), **port_fakes), body, headers))
    want = _normalize(*await _call(jax_create_app(JaxConfig(raw=raw), **jax_fakes), body,
                                   headers))
    assert got == want
    assert _calls(port_fakes) == _calls(jax_fakes)


def test_speculative_aggregation_is_refused_at_boot():
    """An aggregator that is missing, has no engine (an HTTP upstream, a
    fake) or whose engine runs no speculation is refused at boot, with the
    JAX package's messages (its local scheme in place of tpu://)."""
    for aggregator in ("LLM1", "nope"):
        raw = _config("aggregate", aggregate={"speculative_aggregation": True,
                                              "aggregator_backend": aggregator})
        with pytest.raises(ValueError) as port:
            create_app(Config(raw=raw), **_fakes(FakeBackend, BackendError,
                                                 dict.fromkeys(NAMES, {})))
        with pytest.raises(ValueError) as ref:
            jax_create_app(JaxConfig(raw=raw), **_fakes(JaxFake, JaxBackendError,
                                                        dict.fromkeys(NAMES, {})))
        assert str(port.value) == str(ref.value).replace("tpu://", "cuda://")

    class EngineBackend(FakeBackend):
        engine = object()  # a local model whose engine runs no speculation

    raw = _config("aggregate", aggregate={"speculative_aggregation": True})
    with pytest.raises(ValueError, match=r"runs no speculation \(spec_decode=0\)"):
        create_app(Config(raw=raw), **{name: EngineBackend(name) for name in NAMES})


def test_speculative_aggregation_boots_with_a_spec_engine():
    """An aggregator whose engine runs speculation (spec_decode=4) boots, in
    the port as in the JAX package; a real cuda://…?spec_decode=4
    aggregator boots too."""
    import types

    from quorum_tpu_torch.backends.cuda_backend import CudaBackend
    from quorum_tpu_torch.config import BackendSpec
    from quorum_tpu_torch.engine.engine import shutdown_all_engines

    raw = _config("aggregate", aggregate={"speculative_aggregation": True})
    spec_engine = types.SimpleNamespace(spec_decode=4)

    class PortSpec(FakeBackend):
        engine = spec_engine

    class JaxSpec(JaxFake):
        engine = spec_engine

    assert create_app(Config(raw=raw), **{n: PortSpec(n) for n in NAMES}) is not None
    assert jax_create_app(JaxConfig(raw=raw), **{n: JaxSpec(n) for n in NAMES}) is not None
    try:
        agg = CudaBackend.from_spec(BackendSpec(
            name="LLM1", url="cuda://llama-tiny?device=cpu&dtype=float32&n_layers=1"
                             "&spec_decode=4", model="m"))
        assert agg.engine.spec_decode == 4
        assert create_app(Config(raw=raw), LLM1=agg, **{n: FakeBackend(n) for n in NAMES[1:]})
    finally:
        shutdown_all_engines()
