"""Stacked members, ensembles, quorum dedup and grammars on multi-rank
engines (``cuda://…?tp=N&dp=N&members=M|ensemble=M&device=cpu``: rank 0
here, the other ranks spawned, gloo groups), llama-tiny in float32, against
the JAX engine on the CPU's fake devices and the port's one-rank engine:

- ``members=2`` on dp=2 × tp=2 (the JAX package's
  ``test_stacked_members_on_mesh_match_single_device`` set-up, on the JAX
  mesh engine's weights read back): each member's greedy stream equals the
  JAX mesh engine's, each member's sampled stream the port's one-rank
  members engine's (the port draws its own sampling noise), alone and
  admitted together; every worker fed rank 0's tokens;
- ``ensemble=2`` on tp=2: the greedy streams of JAX's ensemble engine on
  the same mesh;
- ``quorum_dedup=1&member_seeds=shared`` on dp=2 × tp=2: a full group's
  one prefill copied into every member's row on every rank; streams and
  dedup counters equal the one-rank engine's;
- a ``response_format`` JSON-schema request on tp=2 gives the one-rank
  engine's and the JAX tp=2 engine's constrained stream, through the
  engine and through the app; rank 0 alone holds the grammar state;
- ``cuda://llama-tiny?tp=2&quant=int8&kv_quant=int8&members=2`` serves each
  member's chat through the app, as ``tpu://`` does.

Every comparison is exact: tokens in float32 on the CPU.
"""

import asyncio
import json

import jax
import numpy as np
import pytest
import torch

from quorum_tpu.constrain import compile_response_format as jax_compile
from quorum_tpu.engine.engine import InferenceEngine as JaxEngine
from quorum_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from quorum_tpu.models.init import init_params as jax_init_params
from quorum_tpu.models.model_config import resolve_spec as jax_resolve_spec
from quorum_tpu.ops.sampling import SamplerConfig as JaxSampler
from quorum_tpu.parallel import MeshConfig as JaxMeshConfig
from quorum_tpu.parallel import make_mesh as jax_make_mesh
from quorum_tpu_torch.backends.cuda_backend import CudaBackend
from quorum_tpu_torch.config import BackendSpec, Config
from quorum_tpu_torch.constrain import compile_response_format
from quorum_tpu_torch.engine.engine import InferenceEngine, shutdown_all_engines
from quorum_tpu_torch.engine.tokenizer import ByteTokenizer
from quorum_tpu_torch.models.convert import params_from_numpy, stacked_params_from_numpy
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.ops.sampling import SamplerConfig
from quorum_tpu_torch.parallel import MeshConfig, make_mesh
from quorum_tpu_torch.server.app import create_app

OPTS = {"dtype": "float32"}
GREEDY = SamplerConfig(temperature=0.0)
SAMPLED = SamplerConfig(temperature=0.8, top_p=0.9)
GREEDY_J = JaxSampler(temperature=0.0)
PROMPT = [3, 4, 5]
LONG = [(7 + 5 * i) % 500 for i in range(30)]
N_TOK = 8
SCHEMA = {"type": "object", "properties": {
    "ok": {"type": "boolean"},
    "dir": {"enum": ["N", "S", "E", "W"]}}}
JSON_SCHEMA = {"type": "json_schema", "json_schema": {"schema": SCHEMA}}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _mesh(**axes):
    cfg = MeshConfig(**axes)
    return make_mesh(cfg, ["cpu"] * cfg.n_devices, timeout_s=30.0)


def _jax_mesh(**axes):
    cfg = JaxMeshConfig(**axes)
    return jax_make_mesh(cfg, jax.devices()[:cfg.n_devices])


def _stream(eng, prompt, sampler=GREEDY, seed=7, member=0, **kw):
    return list(eng.stream_results(eng.submit(prompt, max_new_tokens=N_TOK, sampler=sampler,
                                              seed=seed, member=member, **kw)))


def _together(eng, prompts, sampler, members):
    """One request per member, submitted under the engine's lock so they
    admit as one member-coalesced group."""
    with eng._cond:
        reqs = [eng.submit(p, max_new_tokens=N_TOK, sampler=sampler, seed=7 + m, member=m)
                for m, p in zip(range(members), prompts)]
    return [list(eng.stream_results(r)) for r in reqs]


def test_members_on_dp2_tp2_equal_jax_and_one_rank():
    jspec, spec = jax_resolve_spec("llama-tiny", OPTS), resolve_spec("llama-tiny", OPTS)
    kw = dict(members=2, decode_chunk=4, n_slots=2)
    jeng = JaxEngine(jspec, _jax_mesh(dp=2, tp=2), seed=0, **kw)
    try:
        want = [jeng.generate(PROMPT, max_new_tokens=N_TOK, sampler=GREEDY_J,
                              member=m).token_ids for m in range(2)]
        params = stacked_params_from_numpy(jax.tree.map(np.asarray, jeng.params), device="cpu")
    finally:
        jeng.shutdown()
    one = InferenceEngine(spec, device="cpu", params=params, **kw)
    eng = InferenceEngine(spec, mesh=_mesh(dp=2, tp=2), params=params, **kw)
    try:
        assert [_stream(eng, PROMPT, member=m) for m in range(2)] == want
        assert [_stream(one, PROMPT, member=m) for m in range(2)] == want
        eng.rank_reports()  # clears what the greedy streams fed
        got = [_stream(eng, p, SAMPLED, member=m) for m, p in enumerate((PROMPT, LONG))]
        assert got == [_stream(one, p, SAMPLED, member=m)
                       for m, p in enumerate((PROMPT, LONG))]
        # The workers fed rank 0's tokens into the rows of their dp group's
        # slots (member m's slot s at row m·2 + s): the ranks of the group
        # holding the streams' slot both members' rows, the others none.
        fed = [[(row, f) for row, f in enumerate(rep["fed"]) if f] for rep in eng.rank_reports()]
        assert sorted(len(f) for f in fed) == [0, 2, 2]
        assert all(f[-(N_TOK - 1):] == got[row // 2][:N_TOK - 1] for fr in fed for row, f in fr)
        assert _together(eng, (PROMPT, LONG), SAMPLED, 2) == _together(one, (PROMPT, LONG),
                                                                      SAMPLED, 2)
    finally:
        one.shutdown()
        eng.shutdown()


def test_ensemble_on_tp2_equals_jax():
    jspec, spec = jax_resolve_spec("llama-tiny", OPTS), resolve_spec("llama-tiny", OPTS)
    kw = dict(ensemble=2, decode_chunk=4, n_slots=2)
    jeng = JaxEngine(jspec, _jax_mesh(tp=2), seed=2, **kw)
    try:
        want = [jeng.generate(p, max_new_tokens=N_TOK, sampler=GREEDY_J).token_ids
                for p in (PROMPT, LONG)]
        params = stacked_params_from_numpy(jax.tree.map(np.asarray, jeng.params), device="cpu")
    finally:
        jeng.shutdown()
    eng = InferenceEngine(spec, mesh=_mesh(tp=2), params=params, **kw)
    try:
        assert [_stream(eng, p) for p in (PROMPT, LONG)] == want
        assert eng._ck.shape[1] == 2 * 2  # every weight set's row of each slot
    finally:
        eng.shutdown()


def test_quorum_dedup_on_dp2_tp2_equals_one_rank():
    spec = resolve_spec("llama-tiny", OPTS)
    kw = dict(members=2, member_seeds="shared", quorum_dedup=True, decode_chunk=4, n_slots=2,
              seed=11)
    one = InferenceEngine(spec, device="cpu", **kw)
    eng = InferenceEngine(spec, mesh=_mesh(dp=2, tp=2), **kw)
    try:
        for _ in range(3):  # coalescing is timing-dependent: until a dedup admission
            got = _together(eng, (LONG, LONG), SAMPLED, 2)
            if eng.metrics()["quorum_dedup_prefills_total"]:
                break
        while not one.metrics()["quorum_dedup_prefills_total"]:
            want = _together(one, (LONG, LONG), SAMPLED, 2)
        assert got == want and got[0] != got[1]  # one K/V, two sampling streams
        m, m1 = eng.metrics(), one.metrics()
        assert m["quorum_dedup_prefills_total"] >= 1
        assert (m["quorum_dedup_tokens_total"] // m["quorum_dedup_prefills_total"]
                == m1["quorum_dedup_tokens_total"] // m1["quorum_dedup_prefills_total"]
                == len(LONG))
    finally:
        one.shutdown()
        eng.shutdown()


async def _post(app, body):
    raw = json.dumps(body).encode()
    sent = []

    async def receive():
        return {"type": "http.request", "body": raw, "more_body": False}

    async def send(message):
        sent.append(message)

    await app({"type": "http", "method": "POST", "path": "/v1/chat/completions",
               "headers": [(b"authorization", b"Bearer t")]}, receive, send)
    return sent[0]["status"], json.loads(b"".join(m.get("body", b"") for m in sent[1:]))


def test_json_schema_on_tp2_equals_one_rank_and_jax():
    jspec, spec = jax_resolve_spec("llama-tiny", OPTS), resolve_spec("llama-tiny", OPTS)
    tok = ByteTokenizer(spec.vocab_size)
    jparams = jax.tree.map(np.asarray, jax_init_params(jspec, seed=4))
    jeng = JaxEngine(jspec, _jax_mesh(tp=2), params=jparams, decode_chunk=4)
    try:
        g = jax_compile(JSON_SCHEMA, JaxByteTokenizer(spec.vocab_size), spec.vocab_size)
        want = list(jeng.stream_results(jeng.submit(
            tok.encode("go"), max_new_tokens=32, sampler=GREEDY_J, eos_id=tok.eos_id,
            grammar=g)))
    finally:
        jeng.shutdown()
    params = params_from_numpy(jparams, device="cpu")
    one = InferenceEngine(spec, device="cpu", params=params, decode_chunk=4)
    eng = InferenceEngine(spec, mesh=_mesh(tp=2), params=params, decode_chunk=4)
    try:
        g = compile_response_format(JSON_SCHEMA, tok, spec.vocab_size)
        got = [list(e.stream_results(e.submit(tok.encode("go"), max_new_tokens=32,
                                              sampler=GREEDY, eos_id=tok.eos_id, grammar=g)))
               for e in (eng, one)]
        assert got == [want, want] and want[-1] == tok.eos_id
        assert eng.metrics()["constrained_requests_total"] == 1
        raw = {"primary_backends": [{"name": "llama", "url": "cuda://llama-tiny?tp=2",
                                     "model": "m"}], "settings": {"timeout": 120}}
        body = {"model": "m", "messages": [{"role": "user", "content": "go"}],
                "max_tokens": 32, "temperature": 0, "response_format": JSON_SCHEMA}
        contents = []
        for e in (eng, one):
            app = create_app(Config(raw=raw), llama=CudaBackend("llama", e, model="m",
                                                                model_id="llama-tiny"))
            status, out = asyncio.run(_post(app, body))
            assert status == 200, out
            contents.append(out["choices"][0]["message"]["content"])
        assert contents[0] == contents[1]
        assert set(json.loads(contents[0])) <= {"ok", "dir"}
        assert eng.metrics()["constrained_requests_total"] == 2
    finally:
        one.shutdown()
        eng.shutdown()


def test_int8_members_url_serves_through_the_app():
    url = ("cuda://llama-tiny?tp=2&quant=int8&kv_quant=int8&members=2&device=cpu"
           "&dtype=float32&slots=2&decode_chunk=4")
    try:
        backends = {f"m{m}": CudaBackend.from_spec(BackendSpec(name=f"m{m}",
                                                               url=f"{url}&member={m}",
                                                               model="m"))
                    for m in range(2)}
        eng = backends["m0"].engine
        assert backends["m1"].engine is eng and eng.members == 2
        assert eng.quant == eng.kv_quant == "int8" and eng.mesh.shape["tp"] == 2
        raw = {"primary_backends": [{"name": name, "url": url, "model": "m"}
                                    for name in backends], "settings": {"timeout": 120}}
        body = {"model": "m", "messages": [{"role": "user", "content": "hi"}],
                "max_tokens": 6, "temperature": 0}
        for name, backend in backends.items():
            app = create_app(Config(raw={**raw, "primary_backends": [raw["primary_backends"][0]
                                                                    | {"name": name}]}),
                             **{name: backend})
            status, out = asyncio.run(_post(app, body))
            assert status == 200, out
            assert out["usage"]["completion_tokens"] >= 1
        assert eng.metrics()["admissions_total"] == 2
    finally:
        shutdown_all_engines()
