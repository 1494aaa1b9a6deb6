"""Speculation, int8 weights and KV, embeddings and scoring on sequence-
parallel engines (``cuda://…?sp=2[&tp=2][&sp_impl=ulysses]&device=cpu``:
rank 0 here, the other ranks spawned, gloo groups), llama-tiny in float32
on the JAX package's weights, against the JAX sp engine of the same layout
(the CPU's fake devices) and the port's one-rank engine:

- prompt lookup (``spec_decode=4``) on sp=2 ring, sp=2 Ulysses and sp=2 ×
  tp=2 (there with ``kv_quant=int8``): greedy streams equal the JAX sp
  engine's token for token, with equal ``spec_turns_total``,
  ``spec_draft_tokens_total`` and ``spec_accepted_total`` (ring depth 1);
  a verify turn runs at each rank's heads, replicated over sp (the cache's
  position axis is whole on every sp rank);
- the oracle draft (the target's own weights, ``draft_spec=``) on sp=2:
  equal streams and counters; the draft runs on rank 0 alone, so no worker
  launches a draft step;
- ``quant=int8&kv_quant=int8`` (ring) and ``kv_quant=int8`` (Ulysses) on
  sp=2: greedy streams equal the JAX sp engine's; each sp rank's int8
  leaves are tp's cut of the whole quantized tree (whole over sp), bit for
  bit (the worker's by its leaves' exact digests). The int8 rounding effect (a
  value within 1.27e-3 of a rounding half-integer may land one int8 step
  apart between the packages) is allowed by ``_assert_int8_streams``: a
  stream may part from JAX's only where the port's one-rank int8 engine
  parts the same way. It does not arise at these weights and prompts;
- embeddings and scoring on sp=2 ring, Ulysses and sp=2 × tp=2, and with
  int8 weights on the ring (a forward runs its T/sp sequence block, the
  blocks' hidden states all-gathered over sp): every vector's cosine with
  the JAX sp engine's is at least 1 − 1e-5 and every prompt token's
  logprob and top-k within 1e-4, the top-k ids equal (the JAX forward runs
  replicated over sp, so the two differ by float rounding, not bit for
  bit);
- sampled streams equal the port's one-rank engine's with the same knobs
  (the port draws its own noise), and every layout's forwards (int8 and
  the draft engine's too) the one-rank twin's within the same tolerances;
- ``cuda://llama-tiny?sp=2&spec_decode=4&device=cpu`` answers a streamed
  chat through the app, and ``/metrics`` counts its verify turns.

The prompts are 52 and 60 tokens (bucket 64): sp splits every admission
and every forward into two sequence blocks. One engine of each layout is
built per module and torn down before the next (module-scoped fixture).
"""

import asyncio
import json

import httpx
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quorum_tpu.engine import embed as jax_embed
from quorum_tpu.engine import score as jax_score
from quorum_tpu.engine.engine import InferenceEngine as JaxEngine
from quorum_tpu.models.init import init_params as jax_init_params
from quorum_tpu.models.model_config import resolve_spec as jax_resolve_spec
from quorum_tpu.ops.sampling import SamplerConfig as JaxSampler
from quorum_tpu.parallel import MeshConfig as JaxMeshConfig
from quorum_tpu.parallel import make_mesh as jax_make_mesh
from quorum_tpu_torch.config import Config
from quorum_tpu_torch.engine import embed as embed_mod
from quorum_tpu_torch.engine import score as score_mod
from quorum_tpu_torch.engine.engine import InferenceEngine, shutdown_all_engines
from quorum_tpu_torch.models import quant as tq
from quorum_tpu_torch.models.convert import params_from_numpy, shard_params
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.ops.sampling import SamplerConfig
from quorum_tpu_torch.parallel import MeshConfig, make_mesh
from quorum_tpu_torch.server.app import create_app
from quorum_tpu_torch.training.checkpoint import tree_digest

OPTS = {"dtype": "float32"}
SPEC = resolve_spec("llama-tiny", OPTS)
GREEDY = SamplerConfig(temperature=0.0)
SAMPLED = SamplerConfig(temperature=0.8, top_p=0.9)
KW = dict(decode_chunk=4, n_slots=2, decode_pipeline=1, decode_loop=1)
# Recurring 2-grams (prompt lookup drafts from them), 52 and 60 tokens.
PROMPTS = [[9, 8] * 26, [9, 8, 40, 41] * 15]
N_TOK = 24
COUNTERS = ("spec_turns_total", "spec_draft_tokens_total", "spec_accepted_total")
INPUTS = [[(5 + 3 * i) % 500 for i in range(60)], [7] * 40, [1, 2, 3]]
SCORED = [[(10 + 7 * i) % 500 for i in range(50)], [9, 8] * 20]
TOP_K = 3
COS_TOL = 1e-5
SCORE_TOL = 1e-4

# name: (mesh axes, sp_impl, engine knobs, whether the case also runs forwards)
CASES = {
    "ring_lookup": (dict(sp=2), "ring", dict(spec_decode=4), True),
    "ulysses_lookup": (dict(sp=2), "ulysses", dict(spec_decode=4), True),
    "sp2tp2_lookup_kv8": (dict(sp=2, tp=2), "ring", dict(spec_decode=4, kv_quant="int8"), True),
    "ring_draft": (dict(sp=2), "ring", dict(spec_decode=4, draft=True, decode_loop=4), False),
    "ring_int8": (dict(sp=2), "ring", dict(quant="int8", kv_quant="int8"), True),
    "ulysses_kv8": (dict(sp=2), "ulysses", dict(kv_quant="int8"), False),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def weights():
    jspec = jax_resolve_spec("llama-tiny", OPTS)
    return jspec, jax.tree.map(np.asarray, jax_init_params(jspec, seed=0))


def _mesh(**axes):
    cfg = MeshConfig(**axes)
    return make_mesh(cfg, ["cpu"] * cfg.n_devices, timeout_s=30.0)


def _jax_mesh(**axes):
    cfg = JaxMeshConfig(**axes)
    return jax_make_mesh(cfg, jax.devices()[:cfg.n_devices])


def _knobs(knobs, jspec, spec, jparams, params):
    """The engine knobs of a case for JAX and for the port (a draft case's
    oracle draft is the target itself)."""
    knobs = dict(knobs)
    if not knobs.pop("draft", False):
        return {**KW, **knobs}, {**KW, **knobs}
    jax_kw = dict(KW, **knobs, draft_spec=jspec, draft_params=jparams, transfer_guard="allow")
    return jax_kw, dict(KW, **knobs, draft_spec=spec, draft_params=params)


def _jax_case(jspec, jparams, axes, impl, jax_kw, forwards):
    if "quant" in jax_kw:  # the JAX engine quantizes given params in place
        jparams = jax.tree.map(jnp.asarray, jparams)
    jeng = JaxEngine(jspec, _jax_mesh(**axes), params=jparams, sp_impl=impl, **jax_kw)
    try:
        streams = [jeng.generate(p, max_new_tokens=N_TOK, sampler=JaxSampler(temperature=0.0))
                   .token_ids for p in PROMPTS]
        m = jeng.metrics()
        fwd = None
        if forwards:
            fwd = (np.asarray(jax_embed.embed_token_batch(jeng, INPUTS)),
                   jax_score.score_token_batch(jeng, SCORED, top_k=TOP_K))
    finally:
        jeng.shutdown()
    return streams, {k: m.get(k, 0) for k in COUNTERS}, fwd


@pytest.fixture(scope="module", params=list(CASES))
def case(request, weights):
    """One layout's port engine and one-rank twin, and the JAX sp engine's
    streams, counters and (forward cases) embeddings and scores."""
    jspec, jparams = weights
    axes, impl, knobs, forwards = CASES[request.param]
    params = params_from_numpy(jparams, "cpu")
    jax_kw, kw = _knobs(knobs, jspec, SPEC, jparams, params)
    want = _jax_case(jspec, jparams, axes, impl, jax_kw, forwards)
    eng = InferenceEngine(SPEC, mesh=_mesh(**axes), params=params, sp_impl=impl, **kw)
    one = InferenceEngine(SPEC, device="cpu", params=params, **kw)
    try:
        yield request.param, eng, one, want
    finally:
        eng.shutdown()
        one.shutdown()


def _port_run(eng, sampler=GREEDY):
    before = {k: eng.metrics()[k] for k in COUNTERS}
    got = [eng.generate(p, max_new_tokens=N_TOK, sampler=sampler, seed=5).token_ids
           for p in PROMPTS]
    m = eng.metrics()
    return got, {k: m[k] - before[k] for k in COUNTERS}


def _assert_int8_streams(got, want, one):
    """The int8 rounding allowance: where an int8 stream parts from JAX's,
    the port's one-rank int8 engine must part at the same token the same
    way (the packages' f32 rounding at a half-integer, not the mesh)."""
    for g, w, o in zip(got, want, one, strict=True):
        if g != w:
            assert g == o, "the sp engine parts from JAX where one rank does not"


def test_greedy_streams_equal_the_jax_sp_engine(case, weights):
    name, eng, one, (want, counters, _) = case
    assert eng.prefill_chunk == 0 and eng.mesh.shape["sp"] == 2
    launches = [r["launches"] for r in eng.rank_reports()]
    draft_steps = eng.metrics()["spec_draft_steps_total"]
    got, got_counters = _port_run(eng)
    if "int8" in name or "kv8" in name:
        _assert_int8_streams(got, want, _port_run(one)[0])
    assert got == want, name
    if eng.spec_decode:
        assert got_counters == counters, name
        assert counters["spec_accepted_total"] > 0
        family = "spec_loop" if eng._draft_rt is not None else "verify"
        assert any(k[0] == family for k in eng.dispatched_keys)
    reports = eng.rank_reports()
    for rep in reports:  # every worker fed the verify turns: one broadcast a turn
        assert rep["collectives"]["broadcast"] >= got_counters["spec_turns_total"]
    if eng._draft_rt is not None:
        # the draft is rank 0's alone: the workers' launches are their own
        # steps' (none on the CPU) and they hold no draft weights
        assert eng.metrics()["spec_draft_steps_total"] > draft_steps
        assert [r["launches"] for r in reports] == launches
    if eng.kv_quant:
        k8, ks = eng._ck
        assert k8.dtype == torch.int8 and ks.dtype == torch.float32
        assert k8.shape[2] == SPEC.n_kv_heads // eng.mesh.shape["tp"]
    if eng.quant:
        # each sp rank holds tp's cut of the whole quantized tree (whole
        # over sp), bit for bit: rank 0's leaves, the worker's by digest
        whole = tq.quantize_params(params_from_numpy(weights[1], "cpu"))
        assert tq.is_quantized(eng.params["blocks"]["wq"])
        assert tree_digest(eng.params) == tree_digest(shard_params(whole, eng.mesh, 0, SPEC))
        (rep,) = eng.rank_reports(digest=True)
        assert rep["digest"] == tree_digest(shard_params(whole, eng.mesh, 1, SPEC))


def test_sampled_streams_equal_the_one_rank_engine(case):
    name, eng, one, _ = case
    assert _port_run(eng, SAMPLED)[0] == _port_run(one, SAMPLED)[0], name


def _close_scores(got, want, tol=SCORE_TOL):
    for g, w in zip(got, want, strict=True):
        assert g["token_logprobs"][0] is None and w["token_logprobs"][0] is None
        np.testing.assert_allclose(g["token_logprobs"][1:], w["token_logprobs"][1:], atol=tol,
                                   rtol=0)
        for (gi, gl), (wi, wl) in zip(g["top"][1:], w["top"][1:], strict=True):
            assert list(gi) == list(wi)
            np.testing.assert_allclose(gl, wl, atol=tol, rtol=0)


def _close_vectors(got, want):
    cos = (got * want).sum(axis=-1)
    assert cos.min() >= 1 - COS_TOL and np.abs(got - want).max() <= COS_TOL


def test_forwards_equal_the_jax_sp_engine_and_one_rank(case, monkeypatch):
    """The forward cases (int8 weights too) against the JAX sp engine of
    the same knobs; every layout (the draft engine too) against the port's
    one-rank twin."""
    name, eng, one, (_, _, fwd) = case
    emb = embed_mod.embed_token_batch(eng, INPUTS).numpy()
    sc = score_mod.score_token_batch(eng, SCORED, top_k=TOP_K)
    if fwd is not None:
        _close_vectors(emb, fwd[0])
        _close_scores(sc, fwd[1])
    _close_vectors(emb, embed_mod.embed_token_batch(one, INPUTS).numpy())
    _close_scores(sc, score_mod.score_token_batch(one, SCORED, top_k=TOP_K))
    # the forward's sp collectives ran on the workers: an all-gather of the
    # hidden states and each layer's ring passes or all-to-alls of the
    # sequence blocks
    coll = eng.rank_reports()[0]["collectives"]
    assert coll["all_gather"] > 0
    assert coll["all_to_all" if eng.sp_impl == "ulysses" else "ring_pass"] > 0
    if name == "ring_lookup":
        # sub-batches and unembed chunks equal the unsplit call
        monkeypatch.setattr(embed_mod, "FORWARD_TOKENS", 64)
        monkeypatch.setattr(score_mod, "SCORE_CHUNK_TOKENS", 16)
        assert len(embed_mod.row_groups(SPEC, [max(len(t), 1) for t in INPUTS])) > 1
        assert np.abs(embed_mod.embed_token_batch(eng, INPUTS).numpy() - emb).max() <= 1e-6
        _close_scores(score_mod.score_token_batch(eng, SCORED, top_k=TOP_K), sc, tol=1e-5)


async def _stream(app, body):
    async with httpx.AsyncClient(transport=httpx.ASGITransport(app=app),
                                 base_url="http://t") as client:
        async with client.stream("POST", "/v1/chat/completions", json=body,
                                 headers={"Authorization": "Bearer t"}) as r:
            lines = [ln async for ln in r.aiter_lines()]
        return r.status_code, lines, (await client.get("/metrics")).text


def test_sp_spec_url_streams_a_chat_through_the_app():
    url = ("cuda://llama-tiny?sp=2&spec_decode=4&device=cpu&dtype=float32&seed=4&slots=2"
           "&decode_chunk=4")
    raw = {"settings": {"timeout": 60},
           "primary_backends": [{"name": "L", "url": url, "model": "m"}]}
    app = create_app(Config(raw=raw))
    eng = app.state["registry"].backends[0].engine
    try:
        assert eng.mesh.shape["sp"] == 2 and eng.spec_decode == 4
        body = {"model": "m", "stream": True, "max_tokens": 24, "temperature": 0.0,
                "messages": [{"role": "user", "content": "abab " * 12}]}
        status, lines, metrics = asyncio.run(_stream(app, body))
        assert status == 200
        chunks = [json.loads(ln[6:]) for ln in lines
                  if ln.startswith("data: ") and ln != "data: [DONE]"]
        assert "data: [DONE]" in lines
        text = "".join(c["choices"][0]["delta"].get("content") or "" for c in chunks
                       if c.get("choices"))
        assert text
        assert eng.metrics()["spec_turns_total"] > 0
        assert "quorum_tpu_spec_turns_total" in metrics
        assert eng.health()["mesh"]["workers_alive"]
    finally:
        shutdown_all_engines()
