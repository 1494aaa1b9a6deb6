"""Embeddings and scoring on multi-rank engines (rank 0 here, the other
ranks spawned, gloo groups), llama-tiny in float32 on the JAX package's
weights:

- ``embed_token_batch`` on tp=2 and dp=2 × tp=2 within 1e-5 of the JAX
  mesh engine's (the JAX package's embed function on its engine);
- ``score_token_batch``: every prompt token's logprob and the top-k within
  1e-4 of JAX's, the top-k ids equal; split into sub-batches and unembed
  chunks (module budgets made small) it equals the unsplit call;
- a stacked tp=2 engine's ``member=`` picks that member's cut on every
  rank: member 1's vectors equal the JAX members engine's member 1;
- forwards co-served with a live stream on a tp=2 engine (process groups
  of their own; each sub-batch parks the ring at a turn boundary) leave
  the stream equal to its twin's, and the stream ends;
- ``/v1/embeddings`` and the scoring route answer on a ``tp=2`` backend as
  on one card (sp and pp serve them too: ``tests/test_torch_sp_knobs.py``,
  ``tests/test_torch_pp_knobs.py``).
"""

import asyncio
import threading

import httpx
import jax
import numpy as np
import pytest
import torch

from quorum_tpu.engine import embed as jax_embed
from quorum_tpu.engine import score as jax_score
from quorum_tpu.engine.engine import InferenceEngine as JaxEngine
from quorum_tpu.models.init import init_params as jax_init_params
from quorum_tpu.models.model_config import resolve_spec as jax_resolve_spec
from quorum_tpu.parallel import MeshConfig as JaxMeshConfig
from quorum_tpu.parallel import make_mesh as jax_make_mesh
from quorum_tpu_torch.backends.cuda_backend import CudaBackend
from quorum_tpu_torch.config import Config
from quorum_tpu_torch.engine import embed as embed_mod
from quorum_tpu_torch.engine import score as score_mod
from quorum_tpu_torch.engine.engine import InferenceEngine
from quorum_tpu_torch.models.convert import params_from_numpy, stacked_params_from_numpy
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.ops.sampling import SamplerConfig
from quorum_tpu_torch.parallel import MeshConfig, make_mesh
from quorum_tpu_torch.server.app import create_app

OPTS = {"dtype": "float32"}
SPEC = resolve_spec("llama-tiny", OPTS)
GREEDY = SamplerConfig(temperature=0.0)
LAYOUTS = {"tp2": dict(tp=2), "dp2tp2": dict(dp=2, tp=2)}
INPUTS = [[1, 2, 3], [(5 + 3 * i) % 500 for i in range(40)], [7] * 20, []]
PROMPTS = [[3, 4, 5, 6, 7], [(10 + 7 * i) % 500 for i in range(50)], [9, 8, 9, 8]]
TOP_K = 3
EMBED_TOL = 1e-5
SCORE_TOL = 1e-4
AUTH = {"Authorization": "Bearer t"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def weights():
    jspec = jax_resolve_spec("llama-tiny", OPTS)
    return jspec, jax.tree.map(np.asarray, jax_init_params(jspec, seed=1))


def _mesh(**axes):
    cfg = MeshConfig(**axes)
    return make_mesh(cfg, ["cpu"] * cfg.n_devices, timeout_s=30.0)


def _jax_mesh(**axes):
    cfg = JaxMeshConfig(**axes)
    return jax_make_mesh(cfg, jax.devices()[:cfg.n_devices])


@pytest.fixture(scope="module")
def engines(weights):
    """The port's tp=2 and dp=2 × tp=2 engines and a one-rank twin."""
    params = params_from_numpy(weights[1], "cpu")
    made = {}
    try:
        for name, axes in LAYOUTS.items():
            made[name] = InferenceEngine(SPEC, mesh=_mesh(**axes), params=params, n_slots=2,
                                         decode_chunk=4)
        made["one"] = InferenceEngine(SPEC, device="cpu", params=params, n_slots=2,
                                      decode_chunk=4)
        yield made
    finally:
        for eng in made.values():
            eng.shutdown()


@pytest.fixture(scope="module")
def jax_refs(weights):
    """The JAX mesh engines' embeddings and scores of INPUTS / PROMPTS."""
    jspec, jparams = weights
    out = {}
    for name, axes in LAYOUTS.items():
        jeng = JaxEngine(jspec, _jax_mesh(**axes), params=jparams, n_slots=2)
        try:
            out[name] = (np.asarray(jax_embed.embed_token_batch(jeng, INPUTS)),
                         jax_score.score_token_batch(jeng, PROMPTS, top_k=TOP_K))
        finally:
            jeng.shutdown()
    return out


def _close_scores(got, want, tol=SCORE_TOL):
    for g, w in zip(got, want, strict=True):
        assert g["token_logprobs"][0] is None and w["token_logprobs"][0] is None
        np.testing.assert_allclose(g["token_logprobs"][1:], w["token_logprobs"][1:], atol=tol,
                                   rtol=0)
        for (gi, gl), (wi, wl) in zip(g["top"][1:], w["top"][1:], strict=True):
            assert list(gi) == list(wi)
            np.testing.assert_allclose(gl, wl, atol=tol, rtol=0)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_embeddings_equal_the_jax_mesh_engine(engines, jax_refs, layout):
    got = embed_mod.embed_token_batch(engines[layout], INPUTS).numpy()
    assert np.abs(got - jax_refs[layout][0]).max() <= EMBED_TOL


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_scoring_equals_the_jax_mesh_engine(engines, jax_refs, layout):
    got = score_mod.score_token_batch(engines[layout], PROMPTS, top_k=TOP_K)
    _close_scores(got, jax_refs[layout][1])


def test_sub_batches_and_chunks_equal_the_unsplit_call(engines, monkeypatch):
    eng = engines["tp2"]
    emb = embed_mod.embed_token_batch(eng, INPUTS)
    sc = score_mod.score_token_batch(eng, PROMPTS, top_k=TOP_K)
    monkeypatch.setattr(embed_mod, "FORWARD_TOKENS", 64)
    monkeypatch.setattr(score_mod, "SCORE_CHUNK_TOKENS", 16)
    assert len(embed_mod.row_groups(SPEC, [max(len(t), 1) for t in INPUTS])) > 1
    assert torch.allclose(embed_mod.embed_token_batch(eng, INPUTS), emb, atol=1e-6, rtol=0)
    _close_scores(score_mod.score_token_batch(eng, PROMPTS, top_k=TOP_K), sc, tol=1e-5)


def test_stacked_engine_forwards_its_member(weights):
    jspec = weights[0]
    jeng = JaxEngine(jspec, _jax_mesh(tp=2), seed=0, members=2, n_slots=2)
    try:
        want = [np.asarray(jax_embed.embed_token_batch(jeng, INPUTS[:2], member=m))
                for m in range(2)]
        params = stacked_params_from_numpy(jax.tree.map(np.asarray, jeng.params), device="cpu")
    finally:
        jeng.shutdown()
    eng = InferenceEngine(SPEC, mesh=_mesh(tp=2), params=params, members=2, n_slots=2)
    try:
        got = [embed_mod.embed_token_batch(eng, INPUTS[:2], member=m).numpy() for m in range(2)]
    finally:
        eng.shutdown()
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= EMBED_TOL
    assert np.abs(got[0] - got[1]).max() > 1e-3  # two weight sets


def test_forwards_beside_a_live_stream_leave_it_unchanged(engines):
    eng = engines["tp2"]
    prompt = [(3 + 11 * i) % 500 for i in range(12)]
    twin = eng.generate(prompt, max_new_tokens=48, sampler=GREEDY).token_ids
    before = engines["one"].generate(prompt, max_new_tokens=48, sampler=GREEDY).token_ids
    assert twin == before
    out: dict = {}

    def stream():
        out["tokens"] = eng.generate(prompt, max_new_tokens=48, sampler=GREEDY).token_ids

    t = threading.Thread(target=stream)
    t.start()
    n = 0
    while t.is_alive() or n < 2:
        embed_mod.embed_token_batch(eng, INPUTS)
        score_mod.score_token_batch(eng, PROMPTS[:1], top_k=1)
        n += 1
    t.join(timeout=120)
    assert not t.is_alive()
    assert out["tokens"] == twin
    assert eng.health()["mesh"]["workers_alive"]


def _raw():
    return {"settings": {"timeout": 300},
            "primary_backends": [{"name": "E1", "url": "x://llama-tiny", "model": "tiny"}]}


async def _post(app, path, body):
    async with httpx.AsyncClient(transport=httpx.ASGITransport(app=app),
                                 base_url="http://t") as client:
        return await client.post(path, json=body, headers=AUTH)


def test_api_answers_on_a_tp2_backend_as_on_one_card(engines):
    def app(eng):
        return create_app(Config(raw=_raw()), E1=CudaBackend("E1", eng, model="tiny",
                                                             model_id="llama-tiny"))

    out = []
    for eng in (engines["tp2"], engines["one"]):
        a = app(eng)
        emb = asyncio.run(_post(a, "/v1/embeddings", {"model": "tiny", "input": ["ab", "c d"]}))
        sc = asyncio.run(_post(a, "/v1/completions", {"model": "tiny", "prompt": "hello there",
                                                      "echo": True, "logprobs": 2,
                                                      "max_tokens": 0}))
        assert emb.status_code == 200 and sc.status_code == 200, (emb.text, sc.text)
        out.append((np.array([d["embedding"] for d in emb.json()["data"]]),
                    sc.json()["choices"][0]["logprobs"]))
    (e_mesh, lp_mesh), (e_one, lp_one) = out
    assert np.abs(e_mesh - e_one).max() <= EMBED_TOL
    assert lp_mesh["tokens"] == lp_one["tokens"]
    np.testing.assert_allclose(lp_mesh["token_logprobs"][1:], lp_one["token_logprobs"][1:],
                               atol=SCORE_TOL, rtol=0)
