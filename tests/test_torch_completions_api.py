"""Legacy OpenAI ``/completions`` through the port's app on ``cuda://``
backends (the CPU: plain versions), llama-tiny float32: the JAX package's
``tests/test_completions.py``, function for function, plus the route's
trace and its mid-stream error frame.

- Raw-prompt generation: the wire shape (the JAX app's keys), greedy text
  equal to the JAX app's on the same weights, determinism, ``echo``,
  pre-tokenized prompts, logprobs aligned with the text.
- The scoring mode (``echo`` + ``logprobs``, ``max_tokens=0``): token
  logprobs within 1e-4 of the JAX app's, batch independence, top-k
  containment, offsets through the incremental detokenizer (multi-byte
  UTF-8).
- Streaming: legacy ``text_completion`` frames joined equal the
  non-streamed text; serialized defaults accepted; a failure after the
  first frame is an error frame, then ``[DONE]``.
- Every 400, the 404 ``model_not_found``, the 401 and the 500: the same
  status and body from both apps on the same request (the JAX app names
  its own scheme, ``tpu://``, where the port's says ``cuda://``).
"""

import json

import httpx
import jax
import numpy as np
import pytest
import torch

from quorum_tpu.backends.fake import FakeBackend as JaxFake
from quorum_tpu.backends.http_backend import HttpBackend as JaxHttp
from quorum_tpu.backends.tpu_backend import TpuBackend
from quorum_tpu.config import Config as JaxConfig
from quorum_tpu.engine.engine import InferenceEngine as JaxEngine
from quorum_tpu.models.init import init_params as jax_init_params
from quorum_tpu.models.model_config import resolve_spec as jax_resolve_spec
from quorum_tpu.server.app import create_app as jax_create_app
from quorum_tpu_torch.backends.cuda_backend import CudaBackend
from quorum_tpu_torch.backends.fake import FakeBackend
from quorum_tpu_torch.backends.http_backend import HttpBackend
from quorum_tpu_torch.config import Config
from quorum_tpu_torch.engine.engine import InferenceEngine
from quorum_tpu_torch.engine.score import score_token_batch
from quorum_tpu_torch.models.convert import params_from_numpy
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.observability import TRACES
from quorum_tpu_torch.server.app import create_app

OPTS = {"dtype": "float32", "max_seq": "256"}
AUTH = {"Authorization": "Bearer t"}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _raw(model: str = "tiny"):
    return {"settings": {"timeout": 300},
            "primary_backends": [{"name": "C1", "url": "x://llama-tiny", "model": model}]}


@pytest.fixture(scope="module")
def apps():
    """(JAX app, port app) over one float32 weight set (seed 1), 4 slots,
    decode chunk 8."""
    jspec = jax_resolve_spec("llama-tiny", OPTS)
    jparams = jax.tree.map(np.asarray, jax_init_params(jspec, seed=1))
    jeng = JaxEngine(jspec, params=jparams, n_slots=4, decode_chunk=8)
    teng = InferenceEngine(resolve_spec("llama-tiny", OPTS), device="cpu", n_slots=4,
                           decode_chunk=8, params=params_from_numpy(jparams, device="cpu"))
    yield (jax_create_app(JaxConfig(raw=_raw()), C1=TpuBackend("C1", jeng, model="tiny")),
           create_app(Config(raw=_raw()), C1=CudaBackend("C1", teng, model="tiny",
                                                          model_id="llama-tiny")))
    jeng.shutdown()
    teng.shutdown()


async def post(app, body, headers=AUTH, path="/v1/completions"):
    async with httpx.AsyncClient(transport=httpx.ASGITransport(app=app),
                                 base_url="http://t") as client:
        return await client.post(path, json=body, headers=headers)


def _same_error(resp, jresp):
    """Equal status and body; the JAX app names ``tpu://`` where the port
    names ``cuda://``."""
    assert resp.status_code == jresp.status_code, (resp.text, jresp.text)
    assert resp.json() == json.loads(jresp.text.replace("tpu://", "cuda://"))


def _frames(text):
    lines = [ln for ln in text.splitlines() if ln.startswith("data: ")]
    assert lines[-1] == "data: [DONE]"
    return [json.loads(ln[len("data: "):]) for ln in lines[:-1]]


async def test_generation_wire_shape_and_determinism(apps):
    japp, app = apps
    body = {"model": "tiny", "prompt": "once upon a time", "max_tokens": 8,
            "temperature": 0.0, "seed": 3}
    r1, jr = await post(app, body), await post(japp, body)
    assert r1.status_code == jr.status_code == 200, r1.text
    got, want = r1.json(), jr.json()
    assert got.keys() == want.keys() and got["choices"][0].keys() == want["choices"][0].keys()
    assert got["object"] == "text_completion" and got["id"].startswith("cmpl-")
    assert got["backend"] == "C1" and got["model"] == "tiny"
    (choice,) = got["choices"]
    assert choice["index"] == 0 and choice["logprobs"] is None
    assert choice["text"] and choice["finish_reason"] in ("stop", "length")
    assert choice["text"] == want["choices"][0]["text"]
    assert got["usage"] == want["usage"]
    assert got["usage"]["completion_tokens"] >= 1
    assert got["usage"]["prompt_tokens"] == len("once upon a time")  # one id per byte
    assert (await post(app, body)).json()["choices"][0]["text"] == choice["text"]


async def test_echo_prepends_prompt(apps):
    _, app = apps
    got = (await post(app, {"prompt": "echo base", "echo": True, "max_tokens": 4,
                            "temperature": 0.0})).json()
    assert got["choices"][0]["text"].startswith("echo base")
    assert len(got["choices"][0]["text"]) > len("echo base")


async def test_scoring_mode_shape_and_batch_independence(apps):
    """One logprob per prompt token (the first null), equal to the JAX
    app's, the same alone, again and co-batched beside a longer prompt."""
    japp, app = apps
    body = {"prompt": "anchor scoring text", "echo": True, "logprobs": 0, "max_tokens": 0}
    alone, jalone = (await post(app, body)).json(), (await post(japp, body)).json()
    (choice,) = alone["choices"]
    lp = choice["logprobs"]
    n_tok = alone["usage"]["prompt_tokens"]
    assert alone["usage"]["completion_tokens"] == 0
    assert len(lp["tokens"]) == len(lp["token_logprobs"]) == n_tok
    assert lp["token_logprobs"][0] is None
    assert all(isinstance(x, float) and x <= 0.0 for x in lp["token_logprobs"][1:])
    assert choice["text"] == "anchor scoring text"
    assert lp["text_offset"][0] == 0 and lp["text_offset"] == sorted(lp["text_offset"])
    jlp = jalone["choices"][0]["logprobs"]
    assert lp["tokens"] == jlp["tokens"] and lp["text_offset"] == jlp["text_offset"]
    np.testing.assert_allclose(lp["token_logprobs"][1:], jlp["token_logprobs"][1:], atol=1e-4)
    again = (await post(app, body)).json()
    batched = (await post(app, {
        "prompt": ["anchor scoring text", "a considerably longer companion prompt " * 4],
        "echo": True, "logprobs": 0, "max_tokens": 0})).json()
    a = lp["token_logprobs"][1:]
    np.testing.assert_array_equal(a, again["choices"][0]["logprobs"]["token_logprobs"][1:])
    np.testing.assert_allclose(a, batched["choices"][0]["logprobs"]["token_logprobs"][1:],
                               atol=2e-4)
    assert [ch["index"] for ch in batched["choices"]] == [0, 1]


async def test_scoring_topk_contains_chosen_when_ranked(apps):
    _, app = apps
    got = (await post(app, {"prompt": "ranking probe", "echo": True, "logprobs": 3,
                            "max_tokens": 0})).json()
    lp = got["choices"][0]["logprobs"]
    assert lp["top_logprobs"][0] is None
    for actual, top in zip(lp["token_logprobs"][1:], lp["top_logprobs"][1:]):
        # <= 3: distinct ids can decode to the same text, one entry per text
        assert 1 <= len(top) <= 3
        assert actual <= max(top.values()) + 1e-5


async def test_generation_logprobs_align_with_text(apps):
    _, app = apps
    got = (await post(app, {"prompt": "align me", "logprobs": 2, "max_tokens": 6,
                            "temperature": 0.0})).json()
    lp = got["choices"][0]["logprobs"]
    assert len(lp["tokens"]) == got["usage"]["completion_tokens"]
    assert len(lp["tokens"]) == len(lp["token_logprobs"]) == len(lp["top_logprobs"]) == len(
        lp["text_offset"])
    assert all(1 <= len(t) <= 2 for t in lp["top_logprobs"])
    assert lp["text_offset"][0] == 0 and lp["text_offset"] == sorted(lp["text_offset"])


def test_moe_scoring_batch_composition_independent():
    """cf = 1.5 < E/k keeps drops live: a row's scores must not depend on
    an earlier row's pads (``lengths`` keeps them out of capacity). On the
    JAX test's weights (JAX's init, seed 0): capacity is sized by the
    padded batch, so with other weights an expert can overflow in the
    smaller batch alone and not in the larger one — in both packages."""
    opts = {"max_seq": "128", "moe_capacity_factor": "1.5", "dtype": "float32"}
    jparams = jax.tree.map(np.asarray, jax_init_params(jax_resolve_spec("mixtral-tiny", opts),
                                                       seed=0))
    eng = InferenceEngine(resolve_spec("mixtral-tiny", opts), device="cpu", decode_chunk=4,
                          n_slots=1, params=params_from_numpy(jparams, device="cpu"))
    try:
        short = [(i % 97) + 3 for i in range(20)]
        long = [(i % 89) + 5 for i in range(120)]
        alone = score_token_batch(eng, [long])[0]["token_logprobs"][1:]
        batched = score_token_batch(eng, [short, long])[1]["token_logprobs"][1:]
    finally:
        eng.shutdown()
    np.testing.assert_allclose(alone, batched, atol=2e-4)


async def test_pretokenized_prompt(apps):
    _, app = apps
    got = (await post(app, {"prompt": [[5, 6, 7, 8]], "max_tokens": 4,
                            "temperature": 0.0})).json()
    assert got["usage"]["prompt_tokens"] == 4
    assert got["choices"][0]["text"]


async def test_streaming_legacy_wire(apps):
    _, app = apps
    resp = await post(app, {"prompt": "stream me", "max_tokens": 6, "temperature": 0.0,
                            "stream": True})
    assert resp.status_code == 200
    assert resp.headers.get("x-request-id")
    frames = _frames(resp.text)
    assert frames and all(f["object"] == "text_completion" for f in frames)
    text = "".join(f["choices"][0]["text"] for f in frames if f["choices"])
    assert text
    finishes = [f["choices"][0]["finish_reason"] for f in frames if f["choices"]]
    assert finishes[-1] in ("stop", "length")
    assert all("delta" not in (f["choices"] or [{}])[0] for f in frames)
    flat = (await post(app, {"prompt": "stream me", "max_tokens": 6,
                             "temperature": 0.0})).json()
    assert text == flat["choices"][0]["text"]


@pytest.mark.parametrize("body,fragment", [
    ({"prompt": "x", "n": 2}, "'n' > 1"),
    ({"prompt": "x", "max_tokens": 0}, "scoring"),
    ({"prompt": "x", "logprobs": 6}, "logprobs"),
    ({"prompt": "x", "best_of": 2}, "best_of"),
    ({"prompt": "x", "suffix": "y"}, "suffix"),
    ({"prompt": ""}, "prompt"),
    ({"prompt": []}, "prompt"),
    ({"prompt": ["text", [5, 6]]}, "must not mix"),
    ({"prompt": "x " * 500, "echo": True, "logprobs": 0, "max_tokens": 0}, "max_seq"),
    ({"prompt": ["a", "b"], "stream": True}, "exactly one prompt"),
    ({"prompt": "x", "stream": True, "logprobs": 1}, "stream"),
    ({"prompt": "x", "stream": True, "n": 2}, "'n' > 1"),
    ({"prompt": "x", "stream": True, "best_of": 3}, "best_of"),
])
async def test_invalid_requests_400(apps, body, fragment):
    japp, app = apps
    resp = await post(app, {"model": "tiny", **body})
    _same_error(resp, await post(japp, {"model": "tiny", **body}))
    assert resp.status_code == 400
    err = resp.json()["error"]
    assert err["type"] == "invalid_request_error" and fragment in err["message"]


async def test_stream_accepts_serialized_defaults_and_config_model(apps):
    _, app = apps
    resp = await post(app, {"prompt": "defaults", "max_tokens": 3, "temperature": 0.0,
                            "stream": True, "logprobs": False, "best_of": 1, "n": 1})
    assert resp.status_code == 200, resp.text
    frames = _frames(resp.text)
    assert frames and all(f["model"] == "tiny" for f in frames)
    flat = (await post(app, {"prompt": "defaults", "max_tokens": 3,
                             "temperature": 0.0})).json()
    assert flat["model"] == "tiny"


async def test_unknown_model_is_404_not_silent_fallback(apps):
    japp, app = apps
    body = {"model": "something-else", "prompt": "x", "max_tokens": 2}
    resp = await post(app, body)
    _same_error(resp, await post(japp, body))
    assert resp.status_code == 404
    err = resp.json()["error"]
    assert err["code"] == "model_not_found" and err["param"] == "model"
    assert "something-else" in err["message"]
    ok = await post(app, {"model": "tiny", "prompt": "x", "max_tokens": 2,
                          "temperature": 0.0})
    assert ok.status_code == 200, ok.text


async def test_best_of_one_is_a_noop(apps):
    _, app = apps
    resp = await post(app, {"prompt": "defaults", "best_of": 1, "n": 1, "max_tokens": 2,
                            "temperature": 0.0})
    assert resp.status_code == 200, resp.text


async def test_raw_prompt_ids_not_injectable_from_wire(apps):
    """``_raw_prompt_ids`` is the plan's own: a chat body carrying it is
    templated as without it."""
    _, app = apps
    body = {"model": "tiny", "max_tokens": 4, "temperature": 0.0,
            "messages": [{"role": "user", "content": "legit"}]}
    clean = await post(app, body, path="/v1/chat/completions")
    injected = await post(app, {**body, "_raw_prompt_ids": [5, 6]},
                          path="/v1/chat/completions")
    assert clean.status_code == injected.status_code == 200
    assert (clean.json()["choices"][0]["message"]["content"]
            == injected.json()["choices"][0]["message"]["content"])
    assert injected.json()["usage"]["prompt_tokens"] > 2


async def test_no_capable_backend_500_and_auth(monkeypatch):
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    raw = {"settings": {"timeout": 60},
           "primary_backends": [{"name": "F", "url": "http://fake.example", "model": "m"}]}
    app = create_app(Config(raw=raw), F=FakeBackend("F", model="m"))
    japp = jax_create_app(JaxConfig(raw=raw), F=JaxFake("F", model="m"))
    resp = await post(app, {"prompt": "x"})
    _same_error(resp, await post(japp, {"prompt": "x"}))
    assert resp.status_code == 500 and resp.json()["error"]["type"] == "configuration_error"
    noauth = await post(app, {"prompt": "x"}, headers={})
    _same_error(noauth, await post(japp, {"prompt": "x"}, headers={}))
    assert noauth.status_code == 401


async def test_http_backend_relays_completions():
    seen = {}

    def handler(request):
        seen["path"] = request.url.path
        seen["body"] = json.loads(request.content)
        return httpx.Response(200, json={
            "object": "text_completion", "id": "cmpl-up",
            "choices": [{"index": 0, "text": "hi", "logprobs": None, "finish_reason": "stop"}],
            "model": "cfg-model",
            "usage": {"prompt_tokens": 1, "completion_tokens": 1, "total_tokens": 2}})

    def relay(cls):
        return cls("H", "http://up.example/v1", model="cfg-model",
                   client=httpx.AsyncClient(transport=httpx.MockTransport(handler)))

    be = relay(HttpBackend)
    res = await be.text_complete({"model": "req", "prompt": "x"},
                                 {"Authorization": "Bearer k"}, 30)
    assert res.ok and res.body["backend"] == "H"
    assert seen["path"] == "/v1/completions"
    assert seen["body"]["model"] == "cfg-model" and seen["body"]["stream"] is False
    # A relay does not stream /completions: the same 400 from both apps.
    raw = {"settings": {"timeout": 60},
           "primary_backends": [{"name": "H", "url": "http://up.example/v1",
                                 "model": "cfg-model"}]}
    body = {"prompt": "x", "stream": True}
    resp = await post(create_app(Config(raw=raw), H=be), body)
    _same_error(resp, await post(jax_create_app(JaxConfig(raw=raw), H=relay(JaxHttp)), body))
    assert resp.status_code == 400
    await be.aclose()


async def test_echo_logprobs_offsets_multibyte_utf8(apps):
    """Echoed token texts and offsets track the prompt string where byte
    tokens split a multi-byte UTF-8 character."""
    _, app = apps
    prompt = "café au läit"
    resp = await post(app, {"model": "tiny", "prompt": prompt, "echo": True, "logprobs": 0,
                             "max_tokens": 0})
    assert resp.status_code == 200, resp.text
    choice = resp.json()["choices"][0]
    assert choice["text"] == prompt
    lp = choice["logprobs"]
    toks, offs = lp["tokens"], lp["text_offset"]
    assert len(toks) == len(offs) == len(lp["token_logprobs"])
    assert "".join(toks) == prompt
    pos = 0
    for t, o in zip(toks, offs):
        assert o == pos and prompt[o:o + len(t)] == t
        pos += len(t)


async def test_completions_routes_are_traced(apps):
    """/completions and /embeddings ride the chat route's request wrapper:
    an X-Request-Id and a finished trace with the route's mode."""
    _, app = apps
    for path, body, mode in (
            ("/v1/completions", {"prompt": "trace me", "max_tokens": 2,
                                 "temperature": 0.0}, "completions-complete"),
            ("/v1/embeddings", {"input": "trace me"}, "embeddings")):
        resp = await post(app, body, path=path)
        assert resp.status_code == 200, resp.text
        trace = TRACES.get(resp.headers["x-request-id"])
        assert trace is not None and trace.meta["mode"] == mode
        assert resp.headers.get("traceparent")


async def test_streaming_failure_is_an_error_frame_then_done():
    """A backend failure after the first frame: one legacy error frame
    (finish_reason "error"), then [DONE]."""
    class Failing(FakeBackend):
        async def text_complete(self, body, headers, timeout):
            raise AssertionError("not streamed")

        def plan_text_stream(self, body):
            return dict(body), "m"

    raw = {"settings": {"timeout": 60},
           "primary_backends": [{"name": "F", "url": "http://fake.example", "model": "m"}]}
    fake = Failing("F", model="m", chunks=["ab", "cd", "ef"], fail_mid_stream=2)
    resp = await post(create_app(Config(raw=raw), F=fake), {"prompt": "x", "stream": True})
    assert resp.status_code == 200
    frames = _frames(resp.text)
    assert "".join(f["choices"][0]["text"] for f in frames[:-1]) == "abcd"
    assert frames[-1]["choices"][0]["finish_reason"] == "error"
    assert frames[-1]["choices"][0]["text"] == "Backend failed: Backend F died mid-stream"
