"""Speculative decoding on multi-rank engines (rank 0 here, the other ranks
spawned, gloo groups), llama-tiny in float32 on the JAX package's weights:

- prompt lookup (``spec_decode=4``) on tp=2 and dp=2 × tp=2, and an oracle
  draft model (the target's own weights, ``draft_spec=``) on tp=2: the
  greedy streams equal the JAX mesh engine's of the same layout token for
  token, with equal ``spec_turns_total``, ``spec_draft_tokens_total`` and
  ``spec_accepted_total`` (ring depth 1, so no verify turn rides on a
  stale view whose timing could differ);
- ``disagg=2+2&tp=2&spec_decode=4``: the same against the JAX disagg
  engine (the verify turns run on the decode group);
- sampled streams equal the port's one-rank spec engine's (the port draws
  its own noise), for prompt lookup on both layouts and the draft on tp=2;
- the draft runs on rank 0 alone: the workers' verify plans feed the
  turns, and no worker launches a draft step;
- the refusals kept: a draft model beside disagg, kv_pages or members,
  and speculation beside pp, in the JAX engine's words (sp serves
  speculation: ``tests/test_torch_sp_knobs.py``).

Every comparison is exact: tokens in float32 on the CPU.
"""

import jax
import numpy as np
import pytest
import torch

from quorum_tpu.engine.engine import InferenceEngine as JaxEngine
from quorum_tpu.models.init import init_params as jax_init_params
from quorum_tpu.models.model_config import resolve_spec as jax_resolve_spec
from quorum_tpu.ops.sampling import SamplerConfig as JaxSampler
from quorum_tpu.parallel import MeshConfig as JaxMeshConfig
from quorum_tpu.parallel import make_mesh as jax_make_mesh
from quorum_tpu.parallel.mesh import disagg_meshes as jax_disagg_meshes
from quorum_tpu_torch.engine.engine import InferenceEngine
from quorum_tpu_torch.models.convert import params_from_numpy
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.ops.sampling import SamplerConfig
from quorum_tpu_torch.parallel import MeshConfig, make_mesh
from quorum_tpu_torch.parallel import mesh as pmesh

OPTS = {"dtype": "float32"}
SPEC = resolve_spec("llama-tiny", OPTS)
GREEDY = SamplerConfig(temperature=0.0)
SAMPLED = SamplerConfig(temperature=0.8, top_p=0.9)
KW = dict(decode_chunk=4, n_slots=2, decode_pipeline=1, decode_loop=1, spec_decode=4)
PROMPTS = [[9, 8, 9, 8, 9, 8, 9, 8], [9, 8, 9, 8, 9, 8, 9, 8, 40, 41, 9, 8]]
N_TOK = 32
COUNTERS = ("spec_turns_total", "spec_draft_tokens_total", "spec_accepted_total")
LAYOUTS = {"tp2": dict(tp=2), "dp2tp2": dict(dp=2, tp=2)}


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


def _jax_run(jeng):
    try:
        got = [jeng.generate(p, max_new_tokens=N_TOK, sampler=JaxSampler(temperature=0.0)
                             ).token_ids for p in PROMPTS]
        m = jeng.metrics()
    finally:
        jeng.shutdown()
    return got, {k: m[k] for k in COUNTERS}


def _port_run(eng, sampler=GREEDY):
    got = [eng.generate(p, max_new_tokens=N_TOK, sampler=sampler, seed=5).token_ids
           for p in PROMPTS]
    m = eng.metrics()
    return got, {k: m[k] for k in COUNTERS}


@pytest.fixture(scope="module")
def port_engines(weights):
    """The port's spec engines of each case, built once: tp=2 and dp=2 ×
    tp=2 prompt lookup, tp=2 with the oracle draft, and their one-rank
    twins for the sampled streams."""
    params = params_from_numpy(weights[1], "cpu")
    draft = dict(draft_spec=SPEC, draft_params=params, decode_loop=4)
    made = {}
    try:
        for name, axes in LAYOUTS.items():
            made[name] = InferenceEngine(SPEC, mesh=_mesh(**axes), params=params, **KW)
        made["draft"] = InferenceEngine(SPEC, mesh=_mesh(tp=2), params=params,
                                        **{**KW, **draft})
        made["one"] = InferenceEngine(SPEC, device="cpu", params=params, **KW)
        made["one_draft"] = InferenceEngine(SPEC, device="cpu", params=params,
                                            **{**KW, **draft})
        yield made
    finally:
        for eng in made.values():
            eng.shutdown()


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_greedy_lookup_equals_the_jax_mesh_engine(weights, port_engines, layout):
    jspec, jparams = weights
    want = _jax_run(JaxEngine(jspec, _jax_mesh(**LAYOUTS[layout]), params=jparams, **KW))
    eng = port_engines[layout]
    got = _port_run(eng)
    assert got == want
    assert got[1]["spec_accepted_total"] > 0
    assert any(k[0] == "verify" for k in eng.dispatched_keys)
    # every worker fed the verify turns: its collectives count one
    # broadcast per turn beside the decode steps'
    for rep in eng.rank_reports():
        assert rep["collectives"]["broadcast"] >= got[1]["spec_turns_total"]


def test_greedy_oracle_draft_equals_the_jax_mesh_engine(weights, port_engines):
    jspec, jparams = weights
    # The JAX draft runtime lives off the mesh: its chain crosses to the
    # mesh's devices each dispatch, which the suite's transfer guard (a
    # sentinel for the JAX decode loop) would refuse.
    want = _jax_run(JaxEngine(jspec, _jax_mesh(tp=2), params=jparams, draft_spec=jspec,
                              draft_params=jparams, transfer_guard="allow",
                              **{**KW, "decode_loop": 4}))
    eng = port_engines["draft"]
    before = [r["launches"] for r in eng.rank_reports()]
    got = _port_run(eng)
    assert got == want
    assert got[1]["spec_accepted_total"] >= got[1]["spec_turns_total"]
    assert any(k[0] == "spec_loop" for k in eng.dispatched_keys)
    assert eng.metrics()["spec_draft_steps_total"] > 0
    # the draft is rank 0's alone: the worker ran no draft step (its K2
    # count stays what its own decode steps give: 0 on the CPU)
    assert [r["launches"] for r in eng.rank_reports()] == before


@pytest.mark.parametrize("case", ["tp2", "dp2tp2", "draft"])
def test_sampled_streams_equal_the_one_rank_spec_engine(port_engines, case):
    one = port_engines["one_draft" if case == "draft" else "one"]
    assert _port_run(port_engines[case], SAMPLED)[0] == _port_run(one, SAMPLED)[0]


def test_disagg_tp_groups_lookup_equals_the_jax_disagg_engine(weights):
    jspec, jparams = weights
    kw = {**KW, "prefill_chunk": 16}
    jpm, jdm = jax_disagg_meshes(2, 2, jax.devices()[:4], tp=2)
    want = _jax_run(JaxEngine(jspec, jdm, prefill_mesh=jpm, params=jparams, **kw))
    pm, dm = pmesh.disagg_meshes(2, 2, ["cpu"] * 4)
    eng = InferenceEngine(SPEC, mesh=dm, prefill_mesh=pm,
                          params=params_from_numpy(jparams, "cpu"), **kw)
    try:
        got = _port_run(eng)
        assert eng.n_kv_handoffs > 0
    finally:
        eng.shutdown()
    assert got == want
    assert got[1]["spec_accepted_total"] > 0


@pytest.mark.parametrize("axes,knobs,match", [
    (dict(pp=2), dict(spec_decode=4), "pp>1 does not compose with spec_decode/spec_model"),
    (dict(tp=2), dict(spec_decode=4, draft_spec=SPEC, kv_pages=True),
     "kv_pages=1 does not compose with a draft model"),
    (dict(tp=2), dict(spec_decode=4, draft_spec=SPEC, members=2),
     "draft-model decoding .* does not compose with members/ensemble engines"),
    ("disagg", dict(spec_decode=4, draft_spec=SPEC, prefill_chunk=16),
     "draft-model speculation .* does not compose with disagg"),
], ids=["pp", "draft-kv_pages", "draft-members", "draft-disagg"])
def test_refusals_kept(axes, knobs, match):
    with pytest.raises(ValueError, match=match):
        if axes == "disagg":
            pm, dm = pmesh.disagg_meshes(2, 2, ["cpu"] * 4)
            InferenceEngine(SPEC, mesh=dm, prefill_mesh=pm, **knobs)
        else:
            InferenceEngine(SPEC, mesh=_mesh(**axes), **knobs)
