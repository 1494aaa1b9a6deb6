"""OpenAI ``/embeddings`` through the port's app on ``cuda://`` backends (the
CPU: plain versions), llama-tiny float32: the JAX package's
``tests/test_embeddings.py``, function for function.

- Wire shape, unit norm, and the vector within 1e-4 of the JAX app's on
  the same weights.
- Padding independence (alone, again, and co-batched beside a longer input
  in other buckets), pre-tokenized inputs, ``dimensions`` (truncate, then
  renormalise), base64, a stacked engine's member, routing by model.
- Every 400, the 401, the no-capable-backend 500 and the saturated-gate
  503: the same status and body from both apps on the same request.
- The http(s):// relay, and a ``cuda://`` backend whose config omits
  ``model`` serving under its model id (never blank).
"""

import asyncio
import base64
import threading

import httpx
import jax
import numpy as np
import pytest
import torch

from quorum_tpu.backends.fake import FakeBackend as JaxFake
from quorum_tpu.backends.tpu_backend import TpuBackend
from quorum_tpu.config import Config as JaxConfig
from quorum_tpu.engine import embed as jax_embed_mod
from quorum_tpu.engine.engine import InferenceEngine as JaxEngine
from quorum_tpu.models.init import init_params as jax_init_params
from quorum_tpu.models.model_config import resolve_spec as jax_resolve_spec
from quorum_tpu.server.app import create_app as jax_create_app
from quorum_tpu_torch.backends.cuda_backend import CudaBackend
from quorum_tpu_torch.backends.fake import FakeBackend
from quorum_tpu_torch.backends.http_backend import HttpBackend
from quorum_tpu_torch.backends.registry import build_registry
from quorum_tpu_torch.config import Config
from quorum_tpu_torch.engine import embed as embed_mod
from quorum_tpu_torch.engine.engine import InferenceEngine, shutdown_all_engines
from quorum_tpu_torch.engine.tokenizer import ByteTokenizer
from quorum_tpu_torch.models.convert import params_from_numpy
from quorum_tpu_torch.models.model_config import resolve_spec
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
            "primary_backends": [{"name": "E1", "url": "x://llama-tiny", "model": model}]}


@pytest.fixture(scope="module")
def backends():
    """(JAX backend, port backend) over one float32 weight set (seed 1)."""
    jspec = jax_resolve_spec("llama-tiny", OPTS)
    jparams = jax.tree.map(np.asarray, jax_init_params(jspec, seed=1))
    jeng = JaxEngine(jspec, params=jparams, n_slots=2)
    teng = InferenceEngine(resolve_spec("llama-tiny", OPTS), device="cpu", n_slots=2,
                           params=params_from_numpy(jparams, device="cpu"))
    yield (TpuBackend("E1", jeng, model="tiny", model_id="llama-tiny"),
           CudaBackend("E1", teng, model="tiny", model_id="llama-tiny"))
    jeng.shutdown()
    teng.shutdown()


@pytest.fixture(scope="module")
def apps(backends):
    jb, tb = backends
    return (jax_create_app(JaxConfig(raw=_raw()), E1=jb),
            create_app(Config(raw=_raw()), E1=tb))


async def post(app, body, headers=AUTH, path="/v1/embeddings"):
    async with httpx.AsyncClient(transport=httpx.ASGITransport(app=app),
                                 base_url="http://t") as client:
        return await client.post(path, json=body, headers=headers)


def _vec(resp, i=0):
    return np.asarray(resp.json()["data"][i]["embedding"], np.float32)


async def test_wire_shape_and_unit_norm(apps):
    japp, app = apps
    body = {"model": "tiny", "input": "hello embeddings"}
    resp, jresp = await post(app, body), await post(japp, body)
    assert resp.status_code == jresp.status_code == 200, resp.text
    got, want = resp.json(), jresp.json()
    assert got.keys() == want.keys()
    assert got["object"] == "list" and got["model"] == "tiny" and got["backend"] == "E1"
    assert resp.headers.get("x-request-id")
    (item,) = got["data"]
    assert item.keys() == want["data"][0].keys()
    assert item["object"] == "embedding" and item["index"] == 0
    v = _vec(resp)
    assert v.shape == (64,)  # llama-tiny d_model
    assert abs(float(np.linalg.norm(v)) - 1.0) < 1e-3
    np.testing.assert_allclose(v, _vec(jresp), atol=1e-4)
    assert got["usage"] == want["usage"]
    assert got["usage"]["prompt_tokens"] == got["usage"]["total_tokens"] > 0


async def test_padding_independence_and_determinism(apps):
    """The same text embeds identically alone, co-batched beside a much
    longer input (other batch and seq buckets), and across calls."""
    _, app = apps
    alone = await post(app, {"input": "anchor text"})
    again = await post(app, {"input": "anchor text"})
    batched = await post(app, {"input": ["anchor text", "a much longer companion input " * 6,
                                         "third"]})
    a, b, c = _vec(alone), _vec(again), _vec(batched)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(a, c, atol=2e-5)
    assert [d["index"] for d in batched.json()["data"]] == [0, 1, 2]
    assert float(np.dot(a, _vec(batched, 1))) < 0.999  # distinct texts, distinct directions


async def test_pretokenized_matches_text(apps):
    _, app = apps
    text = await post(app, {"input": "same bytes"})
    ids = ByteTokenizer(512).encode("same bytes")
    toks = await post(app, {"input": [ids]})
    np.testing.assert_array_equal(_vec(text), _vec(toks))
    assert toks.json()["usage"]["prompt_tokens"] == len(ids)


async def test_dimensions_truncates_then_renormalizes(apps):
    _, app = apps
    f = _vec(await post(app, {"input": "matryoshka"}))
    c = _vec(await post(app, {"input": "matryoshka", "dimensions": 16}))
    assert c.shape == (16,)
    np.testing.assert_allclose(c, f[:16] / np.linalg.norm(f[:16]), atol=1e-5)


async def test_base64_encoding_round_trips(apps):
    _, app = apps
    flt = await post(app, {"input": "encode me"})
    b64 = await post(app, {"input": "encode me", "encoding_format": "base64"})
    decoded = np.frombuffer(base64.b64decode(b64.json()["data"][0]["embedding"]), dtype="<f4")
    np.testing.assert_allclose(decoded, _vec(flt), atol=1e-6)


async def test_member_selection_matches_seed_engine():
    """member=1 of a stacked members=2 engine embeds with the weights of a
    plain seed=1 engine (the stacked init's member i is seed + i's)."""
    def raw(url):
        return {"settings": {"timeout": 300},
                "primary_backends": [{"name": "E1", "url": url, "model": "tiny"}]}

    try:
        stacked = create_app(Config(raw=raw(
            "cuda://llama-tiny?seed=0&members=2&member=1&max_seq=256&slots=2&device=cpu"
            "&dtype=float32")))
        plain = create_app(Config(raw=raw(
            "cuda://llama-tiny?seed=1&max_seq=256&slots=2&device=cpu&dtype=float32")))
        sv = _vec(await post(stacked, {"input": "member check"}))
        pv = _vec(await post(plain, {"input": "member check"}))
    finally:
        shutdown_all_engines()
    np.testing.assert_allclose(sv, pv, atol=2e-5)


async def test_model_routing_picks_matching_backend(backends):
    _, tb = backends
    other = CudaBackend("B", tb.engine, model="model-b", model_id="llama-tiny")
    raw = {"settings": {"timeout": 300}, "primary_backends": [
        {"name": "A", "url": "x://a", "model": "model-a"},
        {"name": "B", "url": "x://b", "model": "model-b"}]}
    app = create_app(Config(raw=raw), A=CudaBackend("A", tb.engine, model="model-a",
                                                    model_id="llama-tiny"), B=other)
    got = (await post(app, {"model": "model-b", "input": "route me"})).json()
    assert got["backend"] == "B" and got["model"] == "model-b"
    assert (await post(app, {"input": "route me"})).json()["backend"] == "A"


@pytest.mark.parametrize("body,fragment", [
    ({"input": []}, "input"),
    ({"input": ""}, "input"),
    ({"input": ["ok", 5]}, "each 'input' item"),
    ({"input": ["ok", [5, 6]]}, "must not mix"),
    ({"input": [[999999]]}, "in-vocab"),
    ({"input": "x", "encoding_format": "binary"}, "encoding_format"),
    ({"input": "x", "dimensions": 0}, "dimensions"),
    ({"input": "x", "dimensions": 4096}, "dimensions"),
    ({"input": ["x"] * 65}, "at most 64"),
])
async def test_invalid_requests_400(apps, body, fragment):
    japp, app = apps
    resp, jresp = (await post(app, {"model": "tiny", **body}),
                   await post(japp, {"model": "tiny", **body}))
    assert resp.status_code == jresp.status_code == 400, resp.text
    assert resp.json() == jresp.json()
    err = resp.json()["error"]
    assert err["type"] == "invalid_request_error" and fragment in err["message"]


async def test_auth_required(apps, monkeypatch):
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    japp, app = apps
    resp, jresp = await post(app, {"input": "x"}, {}), await post(japp, {"input": "x"}, {})
    assert resp.status_code == jresp.status_code == 401
    assert resp.json() == jresp.json()
    assert resp.json()["error"]["type"] == "auth_error"


async def test_http_backend_relays_embeddings():
    """http(s):// backends relay /embeddings upstream with chat's model
    precedence and backend tagging."""
    import json

    seen = {}

    def handler(request):
        seen["path"] = request.url.path
        seen["body"] = json.loads(request.content)
        return httpx.Response(200, json={
            "object": "list", "data": [{"object": "embedding", "index": 0,
                                        "embedding": [0.6, 0.8]}],
            "model": "cfg-model", "usage": {"prompt_tokens": 2, "total_tokens": 2}})

    be = HttpBackend("H", "http://up.example/v1", model="cfg-model",
                     client=httpx.AsyncClient(transport=httpx.MockTransport(handler)))
    res = await be.embed({"model": "req-model", "input": "x"}, {"Authorization": "Bearer k"}, 30)
    assert res.ok and res.body["backend"] == "H"
    assert seen["path"] == "/v1/embeddings"
    assert seen["body"]["model"] == "cfg-model"  # the config overrides the request
    await be.aclose()


async def test_no_capable_backend_500():
    raw = {"settings": {"timeout": 60},
           "primary_backends": [{"name": "F", "url": "http://fake.example", "model": "m"}]}
    resp = await post(create_app(Config(raw=raw), F=FakeBackend("F", model="m")), {"input": "x"})
    jresp = await post(jax_create_app(JaxConfig(raw=raw), F=JaxFake("F", model="m")),
                       {"input": "x"})
    assert resp.status_code == jresp.status_code == 500
    assert resp.json() == jresp.json()
    assert resp.json()["error"]["type"] == "configuration_error"


async def test_scoring_admission_gate_503(apps, monkeypatch):
    """With SCORE_GATE_SLOTS forwards on the device, the next request is a
    503 overloaded_error (the JAX app's body, with Retry-After), and the
    slots free when the forwards end."""
    release = threading.Event()

    def blocked_embed(engine, token_lists, member=0):
        release.wait(timeout=30)
        return torch.ones((len(token_lists), 64))

    def jax_blocked(engine, token_lists, member=0):
        release.wait(timeout=30)
        return np.ones((len(token_lists), 64), np.float32)

    monkeypatch.setattr(embed_mod, "embed_token_batch", blocked_embed)
    monkeypatch.setattr(jax_embed_mod, "embed_token_batch", jax_blocked)
    bodies = {}
    for name, app in zip(("jax", "port"), apps):
        release.clear()
        tasks = [asyncio.create_task(post(app, {"input": "x"})) for _ in range(3)]
        await asyncio.sleep(0.5)  # all three reach the gate while two forwards block
        release.set()
        got = await asyncio.gather(*tasks)
        assert sorted(r.status_code for r in got) == [200, 200, 503], name
        shed = next(r for r in got if r.status_code == 503)
        assert shed.json()["error"]["type"] == "overloaded_error"
        assert shed.headers.get("retry-after") == "1"
        bodies[name] = shed.json()
        ok = await post(app, {"input": "y"})  # the slots are free again
        assert ok.status_code == 200, ok.text
    assert bodies["port"] == bodies["jax"]


def test_cuda_backend_model_never_blank():
    """The no-fan-out routes fall to a blank-model backend only because an
    http(s):// relay is the only kind that can be blank: a cuda:// backend
    whose config omits ``model`` serves under its model id."""
    raw = {"settings": {"timeout": 30}, "primary_backends": [
        {"name": "A", "url": "cuda://llama-tiny?seed=1&max_seq=64&slots=1&device=cpu"}]}
    reg = build_registry(Config(raw=raw))
    b = reg.backends[0]
    try:
        assert b.model == b.model_id == "llama-tiny"
    finally:
        shutdown_all_engines()
