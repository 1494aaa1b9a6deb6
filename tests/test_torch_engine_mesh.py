"""Multi-rank engines on the CPU (``cuda://…?tp=N&sp=N&sp_impl=…&device=cpu``:
rank 0 here, the other ranks spawned, gloo groups) against the JAX engine
and the port's single-rank engine, llama-tiny (4 heads, 2 kv heads) and
gpt2-tiny in float32, the JAX package's weights:

- greedy tokens equal the JAX engine's at tp=2, tp=4 (each rank keeps the
  kv head its query head reads), sp=2 ring, sp=2 Ulysses and tp=2 × sp=2,
  single-shot and (tp=2) chunked admissions with tier-0 reuse;
- sampled tokens equal the port's single-rank engine's for the same seeds
  (the JAX package's tests/test_engine_mesh.py discipline);
- every worker fed rank 0's tokens (the broadcast of each step's inputs);
- gpt2-tiny's output and down-projection biases are added once, after the
  all-reduce (random biases: added on both ranks the tokens differ);
- the refused compositions are named; ``cuda://llama-tiny?tp=2&device=cpu``
  answers through the app; a killed worker ends its stream with an error
  and every later request is a 503, not a hang; no process is left after
  shutdown; a spawned rank imports neither jax nor quorum_tpu.

One group of ranks per engine configuration (module-scoped, torn down
before the next); every spawn and join is bounded (``parallel/ranks``).
"""

import asyncio
import os
import time

import httpx
import jax
import numpy as np
import pytest
import torch

from quorum_tpu.engine.engine import InferenceEngine as JaxEngine
from quorum_tpu.models.init import init_params as jax_init_params
from quorum_tpu.models.model_config import resolve_spec as jax_resolve_spec
from quorum_tpu.ops.sampling import SamplerConfig as JaxSampler
from quorum_tpu_torch import sse
from quorum_tpu_torch.config import Config
from quorum_tpu_torch.engine.engine import (EngineBreakerOpen, InferenceEngine,
                                            shutdown_all_engines)
from quorum_tpu_torch.models.convert import params_from_numpy
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.ops.sampling import SamplerConfig
from quorum_tpu_torch.parallel import MeshConfig, make_mesh
from quorum_tpu_torch.server.app import create_app

OPTS = {"dtype": "float32"}
GREEDY = SamplerConfig(temperature=0.0)
SAMPLED = SamplerConfig(temperature=0.8, top_p=0.9)
SHORT = [5, 6, 7]
LONG = [(5 + 3 * i) % 500 for i in range(60)]  # bucket 64: sp=2 splits it
N_TOK = 10
AUTH = {"Authorization": "Bearer t"}



@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread in this process too: the ranks share the host."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)

def _mesh(**axes):
    cfg = MeshConfig(**axes)
    return make_mesh(cfg, ["cpu"] * cfg.n_devices, timeout_s=30.0)


def _jax_weights(model, seed, biases=False):
    jspec = jax_resolve_spec(model, OPTS)
    params = jax.tree.map(np.asarray, jax_init_params(jspec, seed=seed))
    if biases:  # gpt2's zero-initialized biases, made to matter
        rng = np.random.default_rng(seed)
        for k in ("bq", "bk", "bv", "bo", "b_up", "b_down"):
            params["blocks"][k] = rng.normal(0, 0.5, params["blocks"][k].shape).astype(np.float32)
    return jspec, params


def _jax_greedy(jspec, params, prompts):
    jeng = JaxEngine(jspec, params=params, decode_chunk=4, n_slots=2)
    try:
        return [jeng.generate(p, max_new_tokens=N_TOK, sampler=JaxSampler(temperature=0.0))
                .token_ids for p in prompts]
    finally:
        jeng.shutdown()


@pytest.fixture(scope="module")
def llama():
    """The JAX weights, the JAX engine's greedy tokens and the port's
    single-rank sampled tokens (seed 7) for SHORT and LONG."""
    jspec, params = _jax_weights("llama-tiny", 3)
    greedy = _jax_greedy(jspec, params, [SHORT, LONG])
    one = InferenceEngine(resolve_spec("llama-tiny", OPTS), device="cpu", decode_chunk=4,
                          n_slots=2, params=params_from_numpy(params, device="cpu"))
    try:
        sampled = [one.generate(p, max_new_tokens=N_TOK, sampler=SAMPLED, seed=7).token_ids
                   for p in (SHORT, LONG)]
    finally:
        one.shutdown()
    return params, greedy, sampled


CONFIGS = {
    # name: (mesh axes, sp_impl, engine knobs)
    "tp2_chunked": (dict(tp=2), "ring", dict(prefill_chunk=16)),
    "tp4": (dict(tp=4), "ring", {}),
    "sp2_ring": (dict(sp=2), "ring", {}),
    "sp2_ulysses": (dict(sp=2), "ulysses", {}),
    "tp2_sp2": (dict(sp=2, tp=2), "ring", {}),
}


@pytest.fixture(scope="module", params=list(CONFIGS))
def mesh_engine(request, llama):
    axes, impl, knobs = CONFIGS[request.param]
    eng = InferenceEngine(resolve_spec("llama-tiny", OPTS), mesh=_mesh(**axes), sp_impl=impl,
                          decode_chunk=4, n_slots=2,
                          params=params_from_numpy(llama[0], device="cpu"), **knobs)
    yield request.param, eng
    pids = eng.worker_pids()
    eng.shutdown()
    assert eng.worker_pids() == []
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def test_greedy_equals_the_jax_engine(mesh_engine, llama):
    name, eng = mesh_engine
    got = [eng.generate(p, max_new_tokens=N_TOK, sampler=GREEDY).token_ids
           for p in (SHORT, LONG)]
    assert got == llama[1], name
    m = eng.metrics()
    if name == "tp2_chunked":
        assert m["prefill_segments_total"] > 0
        # the same prompt again: a prefix reused from the row, then equal
        again = eng.generate(LONG, max_new_tokens=N_TOK, sampler=GREEDY).token_ids
        assert again == llama[1][1] and eng.metrics()["prefix_tokens_saved_total"] > 0
    if name.startswith("sp"):
        assert eng.prefill_chunk == 0 and m["prefill_segments_total"] == 0


def test_sampled_equals_the_single_rank_engine(mesh_engine, llama):
    name, eng = mesh_engine
    got = [eng.generate(p, max_new_tokens=N_TOK, sampler=SAMPLED, seed=7).token_ids
           for p in (SHORT, LONG)]
    assert got == llama[2], name


def test_every_rank_fed_rank_zeros_tokens(mesh_engine):
    name, eng = mesh_engine
    eng.rank_reports()  # clears what earlier tests fed
    toks = eng.generate(LONG, max_new_tokens=N_TOK, sampler=GREEDY).token_ids
    reports = eng.rank_reports()
    assert len(reports) == eng.mesh.size - 1
    for rep in reports:
        fed = [f for f in rep["fed"] if f]
        assert len(fed) == 1, (name, rep["rank"])
        # a live row feeds its last token (single-shot: the first sampled
        # one; chunked: the last prompt token) and every token but the last
        assert fed[0][-(N_TOK - 1):] == toks[:-1], (name, rep["rank"])
    assert all(r["fed"] == reports[0]["fed"] for r in reports)
    if name.startswith("tp"):
        assert reports[0]["collectives"]["all_reduce"] > 0
    health = eng.health()["mesh"]
    assert health["workers_alive"] and health["decode"] == "eager"


def test_gpt2_biases_are_added_once():
    jspec, params = _jax_weights("gpt2-tiny", 2, biases=True)
    want = _jax_greedy(jspec, params, [SHORT, LONG])
    eng = InferenceEngine(resolve_spec("gpt2-tiny", OPTS), mesh=_mesh(tp=2), decode_chunk=4,
                          n_slots=2, params=params_from_numpy(params, device="cpu"))
    try:
        got = [eng.generate(p, max_new_tokens=N_TOK, sampler=GREEDY).token_ids
               for p in (SHORT, LONG)]
    finally:
        eng.shutdown()
    assert got == want


@pytest.mark.parametrize("knobs,match", [
    (dict(quant="int8"), "quant: not yet on a multi-rank engine"),
    (dict(kv_quant="int8"), "kv_quant: not yet on a multi-rank engine"),
    (dict(members=2), "members: not yet on a multi-rank engine"),
    (dict(spec_decode=4), "speculative decoding: not yet on a multi-rank engine"),
    (dict(kv_pages=True), "kv_pages: not yet on a multi-rank engine"),
    (dict(zero_drain=True), "zero_drain: not yet on a multi-rank engine"),
    (dict(prefix_store="host"), "prefix_store: not yet on a multi-rank engine"),
])
def test_refused_compositions_are_named(knobs, match):
    with pytest.raises(ValueError, match=match):
        InferenceEngine(resolve_spec("llama-tiny", OPTS), mesh=_mesh(tp=2), **knobs)


@pytest.mark.parametrize("model,axes,impl,knobs,match", [
    ("mixtral-tiny", dict(tp=2), "ring", {}, "MoE specs: not yet on a multi-rank engine"),
    ("llama-tiny", dict(sp=2), "bogus", {}, "unknown sp_impl"),
    ("llama-tiny", dict(sp=8), "ulysses", {}, "head counts"),
    ("mistral-tiny", dict(sp=2), "ring", {}, "ulysses"),
    ("llama-tiny", dict(sp=2), "ring", dict(members=2), "members does not compose with sp>1"),
    ("llama-tiny", dict(sp=2), "ring", dict(kv_pages=True),
     "kv_pages=1 does not compose with sp>1"),
    ("llama-tiny", dict(tp=4), "ring", {"n_heads": "6", "n_kv_heads": "3"}, "does not divide"),
])
def test_refused_mesh_specs_in_jax_words(model, axes, impl, knobs, match):
    spec_opts = {k: v for k, v in knobs.items() if isinstance(v, str)}
    engine_knobs = {k: v for k, v in knobs.items() if not isinstance(v, str)}
    try:
        spec = resolve_spec(model, {**OPTS, **spec_opts})
    except KeyError:
        spec = resolve_spec("llama-tiny", {**OPTS, "sliding_window": "16"})
    with pytest.raises(ValueError, match=match):
        InferenceEngine(spec, mesh=_mesh(**axes), sp_impl=impl, **engine_knobs)


async def _call(app, body):
    async with httpx.AsyncClient(transport=httpx.ASGITransport(app=app),
                                 base_url="http://t") as client:
        return await client.post("/v1/chat/completions", json=body, headers=AUTH)


def test_tp_url_serves_through_the_app_and_a_killed_worker_is_a_503():
    url = "cuda://llama-tiny?tp=2&device=cpu&dtype=float32&seed=4&slots=2&decode_chunk=4"
    raw = {"settings": {"timeout": 60},
           "primary_backends": [{"name": "L", "url": url, "model": "m"}]}
    app = create_app(Config(raw=raw))
    eng = app.state["registry"].backends[0].engine
    try:
        assert eng.mesh.size == 2 and eng.mesh.backend == "gloo"
        # a spawned rank imports neither jax nor the JAX package
        mods = eng._ranks.run("quorum_tpu_torch.parallel.ranks:imported",
                              [(["jax", "quorum_tpu"],)] * 2)
        assert mods[1] == []
        body = {"model": "m", "messages": [{"role": "user", "content": "hello"}],
                "max_tokens": 8, "temperature": 0.0}
        ok = asyncio.run(_call(app, body))
        assert ok.status_code == 200, ok.text
        assert ok.json()["usage"]["completion_tokens"] >= 1
        one = InferenceEngine(resolve_spec("llama-tiny", OPTS), device="cpu", seed=4,
                              decode_chunk=4, n_slots=2)
        try:
            prompt = [9, 8, 7, 6]
            assert (eng.generate(prompt, max_new_tokens=N_TOK, sampler=GREEDY).token_ids
                    == one.generate(prompt, max_new_tokens=N_TOK, sampler=GREEDY).token_ids)
        finally:
            one.shutdown()
        # A worker killed mid-stream: the stream ends with an error, fast.
        it = eng.generate_stream(LONG, max_new_tokens=100, sampler=GREEDY)
        got = [next(it) for _ in range(3)]
        eng._ranks.kill(1)
        t0 = time.monotonic()
        with pytest.raises(Exception):
            for tok in it:
                got.append(tok)
        assert time.monotonic() - t0 < 30.0
        assert eng.breaker.state == "open"
        with pytest.raises(EngineBreakerOpen):
            eng.submit([1, 2, 3], max_new_tokens=4)
        resp = asyncio.run(_call(app, body))
        assert resp.status_code == 503, resp.text
        assert not eng.health()["mesh"]["workers_alive"]
        stream = asyncio.run(_call(app, {**body, "stream": True}))
        assert stream.status_code == 503 or any(
            isinstance(e, dict) and e.get("id") == "error"
            for e in sse.iter_data_events(stream.content))
    finally:
        pids = [p.pid for p in eng._ranks.procs]
        shutdown_all_engines()
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
