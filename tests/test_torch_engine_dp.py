"""Data-parallel engines on the CPU (``dp=``: rank 0 here, the other ranks
spawned, gloo groups) against the port's single-rank engine and the JAX
package's single-device engine, llama-tiny in float32 on the JAX package's
weights: the port of ``tests/test_engine_mesh.py``'s dp cases.

- dp=2 and dp=2 × tp=2 engines (4 slots: each dp group holds 2) give the
  single engine's greedy and sampled tokens, token for token, for four
  requests with their own seeds, and the JAX engine's greedy tokens (JAX's
  own tests pin that engine to its dp mesh); chunked admissions with
  tier-0 reuse run on the group owning the slot;
- concurrent requests co-batch on the dp engine and still equal the serial
  results;
- ``n_slots=3`` on dp=2 (dp does not divide the slots: every group holds
  and computes every row, the JAX package's replicated slot axis) is still
  correct;
- every worker fed the tokens of its own dp group's rows and no other;
- ``cuda://llama-tiny?dp=2&tp=2&device=cpu`` answers complete and streamed
  with the single backend's text;
- the KV cache's spec (``parallel/sharding.kv_cache_spec``) is the JAX
  package's ``kv_cache_sharding`` spec, and ``slot_rows`` cuts the slots
  as it shards them.
"""

import asyncio
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from quorum_tpu.engine.engine import InferenceEngine as JaxEngine
from quorum_tpu.models.init import init_params as jax_init_params
from quorum_tpu.models.model_config import resolve_spec as jax_resolve_spec
from quorum_tpu.ops.sampling import SamplerConfig as JaxSampler
from quorum_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from quorum_tpu.parallel.mesh import make_mesh as jax_make_mesh
from quorum_tpu.parallel.sharding import kv_cache_sharding
from quorum_tpu_torch.backends.cuda_backend import CudaBackend
from quorum_tpu_torch.config import BackendSpec
from quorum_tpu_torch.engine.engine import InferenceEngine, shutdown_all_engines
from quorum_tpu_torch.models.convert import params_from_numpy
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.ops.sampling import SamplerConfig
from quorum_tpu_torch.parallel import MeshConfig, kv_cache_spec, make_mesh, slot_rows

OPTS = {"dtype": "float32"}
SPEC = resolve_spec("llama-tiny", OPTS)
GREEDY = SamplerConfig(temperature=0.0)
JOBS = [(seed, [3 + seed, 4, 5 + seed]) for seed in range(4)]
LONG = [(5 + 3 * i) % 500 for i in range(40)]
N_TOK = 8


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread in this process too: the ranks share the host."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _sampled(eng, seed, prompt):
    return eng.generate(prompt, max_new_tokens=N_TOK,
                        sampler=SamplerConfig(temperature=0.8, top_p=0.9), seed=seed).token_ids


@pytest.fixture(scope="module")
def ref():
    """The JAX weights, the JAX engine's greedy tokens for LONG and the
    port's single-rank engine's greedy and sampled tokens."""
    jspec = jax_resolve_spec("llama-tiny", OPTS)
    params = jax.tree.map(np.asarray, jax_init_params(jspec, seed=3))
    jeng = JaxEngine(jspec, params=params, decode_chunk=4, n_slots=4)
    try:
        jax_greedy = jeng.generate(LONG, max_new_tokens=N_TOK,
                                   sampler=JaxSampler(temperature=0.0)).token_ids
    finally:
        jeng.shutdown()
    one = InferenceEngine(SPEC, device="cpu", decode_chunk=4, n_slots=4,
                          params=params_from_numpy(params, device="cpu"))
    try:
        greedy = one.generate(LONG, max_new_tokens=N_TOK, sampler=GREEDY).token_ids
        sampled = [_sampled(one, s, p) for s, p in JOBS]
    finally:
        one.shutdown()
    return params, jax_greedy, greedy, sampled


CONFIGS = {
    # name: (mesh axes, n_slots, engine knobs)
    "dp2": (dict(dp=2), 4, {}),
    "dp2_tp2": (dict(dp=2, tp=2), 4, {}),
    "dp2_chunked": (dict(dp=2), 4, dict(prefill_chunk=16)),
    "dp2_slots3": (dict(dp=2, tp=2), 3, {}),
}


@pytest.fixture(scope="module", params=list(CONFIGS))
def dp_engine(request, ref):
    axes, slots, knobs = CONFIGS[request.param]
    cfg = MeshConfig(**axes)
    eng = InferenceEngine(SPEC, mesh=make_mesh(cfg, ["cpu"] * cfg.n_devices, timeout_s=30.0),
                          decode_chunk=4, n_slots=slots,
                          params=params_from_numpy(ref[0], device="cpu"), **knobs)
    yield request.param, eng
    pids = eng.worker_pids()
    eng.shutdown()
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def test_greedy_equals_the_single_and_the_jax_engine(dp_engine, ref):
    name, eng = dp_engine
    got = eng.generate(LONG, max_new_tokens=N_TOK, sampler=GREEDY).token_ids
    assert got == ref[2] == ref[1], name
    mesh = eng.health()["mesh"]
    assert mesh["dp"] == 2
    assert mesh["slot_rows"] == ("replicated" if name == "dp2_slots3" else "sharded")
    if name == "dp2_chunked":
        assert eng.metrics()["prefill_segments_total"] > 0
        again = eng.generate(LONG, max_new_tokens=N_TOK, sampler=GREEDY).token_ids
        assert again == ref[2] and eng.metrics()["prefix_tokens_saved_total"] > 0


def test_sampled_equals_the_single_engine(dp_engine, ref):
    name, eng = dp_engine
    assert [_sampled(eng, s, p) for s, p in JOBS] == ref[3], name


def test_concurrent_requests_co_batch(dp_engine, ref):
    name, eng = dp_engine
    with ThreadPoolExecutor(max_workers=4) as ex:
        got = list(ex.map(lambda job: _sampled(eng, *job), JOBS))
    assert got == ref[3], name


def test_each_worker_fed_its_own_rows(dp_engine):
    name, eng = dp_engine
    eng.rank_reports()  # clears what earlier tests fed
    with ThreadPoolExecutor(max_workers=4) as ex:
        list(ex.map(lambda job: _sampled(eng, *job), JOBS))
    lo, hi = (0, eng.n_slots) if name == "dp2_slots3" else (0, eng.n_slots // 2)
    for rep in eng.rank_reports():
        dp = eng.mesh.coords(rep["rank"])["dp"]
        own = range(lo, hi) if name == "dp2_slots3" else range(dp * hi, (dp + 1) * hi)
        assert all(not toks for row, toks in enumerate(rep["fed"]) if row not in own)
        assert any(rep["fed"][row] for row in own)


def _backend(url: str) -> CudaBackend:
    return CudaBackend.from_spec(BackendSpec(name="m", url=url, model="m"))


def test_dp_tp_url_text_equals_the_single_backend():
    body = {"model": "m", "messages": [{"role": "user", "content": "hello"}],
            "max_tokens": 8, "temperature": 0.7, "seed": 11}

    async def run(backend):
        res = await backend.complete(dict(body), {}, timeout=120)
        chunks = []
        async for c in backend.stream(dict(body) | {"stream": True}, {}, timeout=120):
            for ch in c.get("choices") or []:
                chunks.append((ch.get("delta") or {}).get("content") or "")
        return res.body["choices"][0]["message"]["content"], "".join(chunks)

    base = "cuda://llama-tiny?device=cpu&dtype=float32&seed=3&slots=4&decode_chunk=4"
    try:
        mesh_b = _backend(base + "&dp=2&tp=2")
        assert mesh_b.engine.mesh.shape == {"dp": 2, "pp": 1, "sp": 1, "tp": 2}
        text_m, stream_m = asyncio.run(run(mesh_b))
        text_1, stream_1 = asyncio.run(run(_backend(base)))
    finally:
        shutdown_all_engines()
    assert text_m == text_1 and stream_m == stream_1
    assert text_m


@pytest.mark.parametrize("n_kv,tp,dp,batch", [(8, 4, 2, 4), (2, 4, 2, 4), (8, 4, 2, 3),
                                              (4, 2, 4, 8), (4, 1, 8, 6)])
def test_kv_cache_spec_is_the_jax_sharding(n_kv, tp, dp, batch):
    jmesh = jax_make_mesh(JaxMeshConfig(dp=dp, tp=tp))
    assert kv_cache_spec(n_kv, tp, dp, batch) == tuple(
        kv_cache_sharding(jmesh, n_kv, batch).spec)
    rows = [slot_rows(batch, dp, d) for d in range(dp)]
    if batch % dp:
        assert rows == [(0, batch)] * dp
    else:
        per = batch // dp
        assert rows == [(d * per, (d + 1) * per) for d in range(dp)]
