"""Pipeline-staged engines (``cuda://…?pp=K``, ``InferenceEngine(mesh=pp)``)
on gloo CPU stages against the JAX package's single-device engine and the
port's one-rank engine, llama-tiny in float32 on the JAX package's weights
(the :263 contract of ``tests/test_pp_decode.py``, whose own staged engine
cannot run on jax 0.9.0):

- greedy streams equal the JAX engine's token for token, sampled ones the
  port's one-rank engine's (the same token-indexed noise), through single
  chunks and ``decode_loop`` megachunks; every dispatch key is ``"pp"``
  -tagged (families ``pp_plain`` / ``pp_loop``), the one-rank engine's never;
- ``quorum_tpu_decode_stage_occupancy{stage=}`` carries one series per row
  group and ``decode_pp`` is on ``metrics()`` and ``/health``;
- each stage holds its layers' weights and cache only, and launches its
  layers' attention per group step;
- the pp refusals read as the JAX engine's (``test_engine_pp_rejections``)
  and its URL backend's (``test_url_pp_rejections``), on both sides;
- ``cuda://llama-tiny?pp=2&device=cpu`` answers through the app.
"""

import asyncio
from concurrent.futures import ThreadPoolExecutor

import httpx
import jax
import numpy as np
import pytest
import torch

from quorum_tpu import observability as jax_obs
from quorum_tpu.backends.tpu_backend import TpuBackend
from quorum_tpu.config import BackendSpec as JaxBackendSpec
from quorum_tpu.engine.engine import InferenceEngine as JaxEngine
from quorum_tpu.models.init import init_params as jax_init_params
from quorum_tpu.models.model_config import resolve_spec as jax_resolve_spec
from quorum_tpu.ops.sampling import SamplerConfig as JaxSampler
from quorum_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from quorum_tpu.parallel.mesh import make_mesh as jax_make_mesh
from quorum_tpu_torch import observability as obs
from quorum_tpu_torch.backends.cuda_backend import CudaBackend
from quorum_tpu_torch.config import BackendSpec, Config
from quorum_tpu_torch.engine.engine import InferenceEngine, program_family, shutdown_all_engines
from quorum_tpu_torch.models.convert import params_from_numpy
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.ops.sampling import SamplerConfig
from quorum_tpu_torch.parallel import MeshConfig, make_mesh
from quorum_tpu_torch.server.app import create_app

OPTS = {"dtype": "float32", "n_layers": "4"}
GREEDY = SamplerConfig(temperature=0.0)
SAMPLED = SamplerConfig(temperature=0.8, top_p=0.9)
PROMPTS = [[3, 4, 5], [7, 8, 9, 10, 11], [(5 + 3 * i) % 500 for i in range(40)]]
KW = dict(decode_chunk=4, n_slots=4, decode_loop=2)
N_TOK = 12


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def engines():
    jspec = jax_resolve_spec("llama-tiny", OPTS)
    params = jax.tree.map(np.asarray, jax_init_params(jspec, seed=9500))
    jeng = JaxEngine(jspec, params=params, decode_chunk=4, n_slots=2)
    try:
        want = [jeng.generate(p, max_new_tokens=N_TOK, sampler=JaxSampler(temperature=0.0))
                .token_ids for p in PROMPTS]
    finally:
        jeng.shutdown()
    spec = resolve_spec("llama-tiny", OPTS)
    one = InferenceEngine(spec, device="cpu", params=params_from_numpy(params, device="cpu"),
                          **KW)
    pp = InferenceEngine(spec, mesh=make_mesh(MeshConfig(pp=2), ["cpu"] * 2, timeout_s=30.0),
                         params=params_from_numpy(params, device="cpu"), **KW)
    yield want, one, pp
    one.shutdown()
    pp.shutdown()


def test_greedy_equals_the_jax_engine_and_sampled_the_one_rank_engine(engines):
    want, one, pp = engines
    assert pp.decode_pp == 2 and pp.prefill_chunk == 0
    for prompt, w in zip(PROMPTS, want):
        assert pp.generate(prompt, max_new_tokens=N_TOK, sampler=GREEDY).token_ids == w
    for seed, prompt in enumerate(PROMPTS):
        a = one.generate(prompt, max_new_tokens=N_TOK, sampler=SAMPLED, seed=seed).token_ids
        b = pp.generate(prompt, max_new_tokens=N_TOK, sampler=SAMPLED, seed=seed).token_ids
        assert a == b, seed
    # Concurrent streams share the dispatches (both row groups live).
    with ThreadPoolExecutor(len(PROMPTS)) as pool:
        got = list(pool.map(lambda p: pp.generate(p, max_new_tokens=N_TOK,
                                                  sampler=GREEDY).token_ids, PROMPTS))
    assert got == want


def test_keys_families_occupancy_and_health(engines):
    _, one, pp = engines
    pp.generate(PROMPTS[0], max_new_tokens=N_TOK, sampler=GREEDY)
    fams = {program_family(k) for k in pp.dispatched_keys}
    assert fams and fams <= {"pp_plain", "pp_loop"}, fams
    assert all(k[0] == "pp" for k in pp.dispatched_keys)
    assert not any(program_family(k).startswith("pp") for k in one.dispatched_keys)
    lines = obs.DECODE_STAGE_OCCUPANCY.expose()
    assert any('stage="0"' in ln for ln in lines), lines
    assert any('stage="1"' in ln for ln in lines), lines
    # The same family, name and type as the JAX package's.
    assert lines[:2] == jax_obs.DECODE_STAGE_OCCUPANCY.expose()[:2]
    assert pp.metrics()["decode_pp"] == 2 and one.metrics()["decode_pp"] == 1
    assert pp.health()["mesh"]["decode_pp"] == 2


def test_each_stage_holds_its_layers_and_launches_per_group_step(engines):
    _, one, pp = engines
    half = pp.spec.n_layers // 2
    assert pp._ck.shape[0] == half and pp.params["blocks"]["wq"].shape[0] == half
    pp.rank_reports()  # drop what earlier tests fed
    pp.generate(PROMPTS[1], max_new_tokens=N_TOK, sampler=GREEDY)
    (rep,) = pp.rank_reports()
    full = sum(t.numel() * t.element_size() for t in _leaves(one.params))
    stage0 = sum(t.numel() * t.element_size() for t in _leaves(pp.params))
    blocks = sum(t.numel() * t.element_size() for t in _leaves(one.params["blocks"]))
    assert rep["weight_bytes"] == blocks // 2  # stage 1: its layers and nothing else
    assert stage0 + rep["weight_bytes"] == full
    assert rep["cache_bytes"] * 2 == sum(t.numel() * t.element_size() for t in (one._ck, one._cv))
    assert rep["collectives"]["p2p"] > 0 and rep["fed"] == [[], [], [], []]


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        elif v is not None:
            yield v


ENGINE_CASES = [
    (dict(pp=2), {"n_layers": "3"}, {}, "does not divide n_layers"),
    (dict(pp=2), {}, dict(n_slots=3), "does not divide slots"),
    (dict(pp=2), {}, dict(zero_drain=True, prefill_chunk=16), "zero_drain"),
    (dict(pp=2), {}, dict(members=2), "members/ensemble"),
    (dict(pp=2), {}, dict(ensemble=2), "members/ensemble"),
    (dict(pp=2), {}, dict(spec_decode=4), "spec_decode"),
    (dict(pp=2, sp=2), {}, {}, "sp>1"),
    (dict(pp=2, tp=2), {}, {}, "tp=1/dp=1 within each stage"),
    (dict(pp=2, dp=2), {}, {}, "tp=1/dp=1 within each stage"),
]


@pytest.mark.parametrize("axes,spec_opts,knobs,match", ENGINE_CASES)
def test_engine_pp_refusals_read_as_jax(axes, spec_opts, knobs, match):
    """``test_engine_pp_rejections``' matrix: both engines refuse at
    construction, and the port's text is the JAX engine's."""
    n = MeshConfig(**axes).n_devices
    with pytest.raises(ValueError, match=match) as jax_err:
        JaxEngine(jax_resolve_spec("llama-tiny", spec_opts),
                  jax_make_mesh(JaxMeshConfig(**axes), jax.devices()[:n]), **knobs)
    with pytest.raises(ValueError, match=match) as port_err:
        InferenceEngine(resolve_spec("llama-tiny", spec_opts),
                        mesh=make_mesh(MeshConfig(**axes), ["cpu"] * n), **knobs)
    assert str(port_err.value) == str(jax_err.value)


URL_CASES = [
    ("pp=2&zero_drain=1", "zero_drain"),
    ("n_layers=3&pp=2", "does not divide n_layers"),
    ("pp=2&sp=2", "sp>1"),
    ("pp=2&tp=2", "tp=1/dp=1 within each stage"),
    ("pp=2&dp=2", "tp=1/dp=1 within each stage"),
    ("pp=2&spec_decode=4", "spec_decode"),
]


@pytest.mark.parametrize("query,match", URL_CASES)
def test_url_pp_refusals_read_as_jax(query, match):
    """``test_url_pp_rejections``' URLs (disagg= stays refused by name on
    ``cuda://``): the same refusal from both backends."""
    with pytest.raises(ValueError, match=match) as jax_err:
        TpuBackend.from_spec(JaxBackendSpec(name="t", url=f"tpu://llama-tiny?{query}",
                                            model="m"))
    with pytest.raises(ValueError, match=match) as port_err:
        CudaBackend.from_spec(BackendSpec(name="t", url=f"cuda://llama-tiny?{query}&device=cpu",
                                          model="m"))
    assert str(port_err.value) == str(jax_err.value)
    shutdown_all_engines()


async def _call(app, body):
    async with httpx.AsyncClient(transport=httpx.ASGITransport(app=app),
                                 base_url="http://t") as client:
        return (await client.post("/v1/chat/completions", json=body,
                                  headers={"Authorization": "Bearer t"}),
                await client.get("/metrics"))


def test_pp_url_serves_through_the_app():
    url = ("cuda://llama-tiny?pp=2&device=cpu&dtype=float32&n_layers=4&seed=4&slots=2"
           "&decode_chunk=4")
    raw = {"settings": {"timeout": 60},
           "primary_backends": [{"name": "L", "url": url, "model": "m"}]}
    app = create_app(Config(raw=raw))
    eng = app.state["registry"].backends[0].engine
    try:
        assert eng.decode_pp == 2 and eng.mesh.backend == "gloo"
        mods = eng._ranks.run("quorum_tpu_torch.parallel.ranks:imported",
                              [(["jax", "quorum_tpu"],)] * 2)
        assert mods[1] == []  # a spawned stage imports neither
        body = {"model": "m", "messages": [{"role": "user", "content": "hello"}],
                "max_tokens": 8, "temperature": 0.0}
        resp, metrics = asyncio.run(_call(app, body))
        assert resp.status_code == 200, resp.text
        assert resp.json()["usage"]["completion_tokens"] >= 1
        assert "quorum_tpu_engine_decode_pp" in metrics.text
        assert "quorum_tpu_decode_stage_occupancy" in metrics.text
    finally:
        shutdown_all_engines()
