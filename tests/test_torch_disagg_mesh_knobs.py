"""Disaggregated engines whose groups are cut by tp (``cuda://…&disagg=2+2&
tp=2&device=cpu``: each group's rank 0 here, its other rank spawned, gloo
groups) with the knobs a colocated tp engine serves, llama-tiny (4 kv
heads) in float32, against the colocated tp=2 engine with the same knobs:

- ``members=2``: each member's greedy and sampled stream, on the JAX
  colocated tp=2 members engine's weights read back (the JAX package's
  ``test_disagg_tp_members_pin`` set-up); the greedy ones equal JAX's;
  the handed-off pieces carry the member axis (each member's own rows);
- ``kv_quant=int8``: the pieces carry int8 values and their scales
  (K values, K scales, V values, V scales), gathered over the prefill
  group's tp and broadcast over the decode group's;
- ``quant=int8``: both groups build their weights from the rank cuts of
  the whole quantized tree;
- a ``response_format`` json_object request through the app (the JAX
  package's ``test_disagg_tp_constrained_pin`` set-up, on the JAX
  colocated tp=2 backend's weights): the same content as the colocated
  port engine's and the JAX backend's.

Every comparison is exact: tokens in float32 on the CPU.
"""

import asyncio

import jax
import numpy as np
import pytest
import torch

from quorum_tpu.backends.tpu_backend import TpuBackend
from quorum_tpu.config import BackendSpec as JaxBackendSpec
from quorum_tpu.engine.engine import InferenceEngine as JaxEngine
from quorum_tpu.models.model_config import resolve_spec as jax_resolve_spec
from quorum_tpu.ops.sampling import SamplerConfig as JaxSampler
from quorum_tpu.parallel import MeshConfig as JaxMeshConfig
from quorum_tpu.parallel import make_mesh as jax_make_mesh
from quorum_tpu_torch.backends.cuda_backend import CudaBackend
from quorum_tpu_torch.engine.engine import InferenceEngine
from quorum_tpu_torch.models.convert import params_from_numpy, stacked_params_from_numpy
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.ops.sampling import SamplerConfig
from quorum_tpu_torch.parallel import MeshConfig, make_mesh
from quorum_tpu_torch.parallel import mesh as pmesh

OPTS = {"dtype": "float32", "n_kv_heads": "4"}
GREEDY = SamplerConfig(temperature=0.0)
SAMPLED = SamplerConfig(temperature=0.8, top_p=0.9)
KW = dict(decode_chunk=4, n_slots=2, decode_pipeline=4, decode_loop=4, prefill_chunk=16)
PROMPTS = [[3, 4, 5], [(5 + 3 * i) % 500 for i in range(40)]]
N_TOK = 6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _engines(spec, **knobs):
    """(disagg=2+2 with tp=2 in each group, the colocated tp=2 engine)."""
    pm, dm = pmesh.disagg_meshes(2, 2, ["cpu"] * 4)
    d = InferenceEngine(spec, mesh=dm, prefill_mesh=pm, **KW, **knobs)
    try:
        c = InferenceEngine(spec, mesh=make_mesh(MeshConfig(tp=2), ["cpu"] * 2, timeout_s=30.0),
                            **KW, **knobs)
    except BaseException:
        d.shutdown()
        raise
    return d, c


def _streams(eng, members=1):
    return [list(eng.stream_results(eng.submit(p, max_new_tokens=N_TOK, sampler=s, seed=9,
                                               member=m)))
            for m in range(members) for p in PROMPTS for s in (GREEDY, SAMPLED)]


@pytest.mark.parametrize("knob", ["members", "kv_quant", "quant"])
def test_disagg_tp_groups_equal_the_colocated_tp2_engine(knob):
    spec = resolve_spec("llama-tiny", OPTS)
    knobs, want_jax, members = {"members": dict(members=2), "kv_quant": dict(kv_quant="int8"),
                                "quant": dict(quant="int8")}[knob], None, 1
    if knob == "members":
        members = 2
        jspec = jax_resolve_spec("llama-tiny", OPTS)
        jeng = JaxEngine(jspec, jax_make_mesh(JaxMeshConfig(tp=2), jax.devices()[:2]), seed=0,
                         members=2, **KW)
        try:
            want_jax = [jeng.generate(p, max_new_tokens=N_TOK, sampler=JaxSampler(
                temperature=0.0), member=m).token_ids for m in range(2) for p in PROMPTS]
            knobs["params"] = stacked_params_from_numpy(jax.tree.map(np.asarray, jeng.params),
                                                        device="cpu")
        finally:
            jeng.shutdown()
    else:
        knobs["seed"] = 9300
    d, c = _engines(spec, **knobs)
    try:
        got = _streams(d, members)
        assert got == _streams(c, members)
        if want_jax is not None:
            assert got[::2] == want_jax  # the greedy streams
        assert d.n_kv_handoffs > 0 and d.health()["disagg"]["prefill_workers_alive"]
        side = d._sck
        if knob == "kv_quant":
            assert isinstance(side, tuple) and side[0].dtype == torch.int8
            assert d.prefill_rank_reports()[0]["cache_bytes"] == sum(
                t.numel() * t.element_size() for t in (*d._sck, *d._scv))
        if knob == "members":
            assert side.shape[1] == 2 * 2  # each member's row of each slot
    finally:
        d.shutdown()
        c.shutdown()


def test_disagg_tp_json_object_equals_colocated_and_jax():
    """The JAX pin's set-up: 24 greedy tokens of a json_object chat."""
    body = {"model": "m", "max_tokens": 24, "temperature": 0.0, "seed": 3,
            "messages": [{"role": "user", "content": "json please"}],
            "response_format": {"type": "json_object"}}
    opts = ("n_kv_heads=4&seed=9350&decode_pipeline=4&decode_loop=4&prefill_chunk=16"
            "&decode_chunk=4&slots=2&dtype=float32")
    jb = TpuBackend.from_spec(JaxBackendSpec(name="t", url=f"tpu://llama-tiny?{opts}&tp=2",
                                             model="m"))

    async def run(b):
        res = await b.complete(dict(body), {}, timeout=300)
        assert res.status_code == 200, res.body
        return res.body["choices"][0]["message"]["content"]

    try:
        want = asyncio.run(run(jb))
        params = params_from_numpy(jax.tree.map(np.asarray, jb.engine.params), device="cpu")
    finally:
        jb.engine.shutdown()
    d, c = _engines(resolve_spec("llama-tiny", OPTS), params=params)
    try:
        got = [asyncio.run(run(CudaBackend("t", e, model="m", model_id="llama-tiny")))
               for e in (d, c)]
        assert got == [want, want]
        assert d.metrics()["constrained_requests_total"] == 1 and d.n_kv_handoffs > 0
    finally:
        d.shutdown()
        c.shutdown()
