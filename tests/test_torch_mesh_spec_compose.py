"""Prompt-lookup speculation (``spec_decode=4``) composed with the knobs a
tp engine serves, on tp=2 (rank 0 here, rank 1 spawned, gloo groups),
llama-tiny in float32, each against the JAX tp=2 engine with the same
knobs on the same weights, at ring depth 1:

- ``quant=int8`` and ``kv_quant=int8``: the greedy streams and the three
  spec counters equal JAX's;
- a grammar (``json_schema``) request with the same oracle drafts on both
  sides: its tokens, the verify turns (``dfa_verify``), the accepted drafts
  and the masked-entry count equal JAX's (rank 0 alone holds the arena and
  filters the drafts);
- stacked members (``members=2``, the JAX engine's weights read back): each
  member's greedy stream and the counters equal JAX's;
- the host prefix store (``prefix_store=host``): a conversation's follow-up
  restores from the store and streams JAX's tokens, with JAX's counters;
- zero-drain staging (``zero_drain=1``): the streams and counters equal
  JAX's;
- paged KV (``kv_pages=1``) on tp=2 and dp=2 × tp=2: greedy and sampled
  streams and the counters equal the port's one-rank paged spec engine's
  (its paged verify keys on every rank).

Every comparison is exact: tokens in float32 on the CPU.
"""

import jax
import jax.numpy as jnp
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
from quorum_tpu_torch.constrain import compile_response_format
from quorum_tpu_torch.engine.engine import InferenceEngine
from quorum_tpu_torch.engine.tokenizer import ByteTokenizer
from quorum_tpu_torch.models.convert import params_from_numpy, stacked_params_from_numpy
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.ops.sampling import SamplerConfig
from quorum_tpu_torch.parallel import MeshConfig, make_mesh

OPTS = {"dtype": "float32"}
SPEC = resolve_spec("llama-tiny", OPTS)
TOK = ByteTokenizer(SPEC.vocab_size)
GREEDY = SamplerConfig(temperature=0.0)
KW = dict(decode_chunk=4, n_slots=2, decode_pipeline=1, decode_loop=1, spec_decode=4)
PROMPTS = [[9, 8, 9, 8, 9, 8, 9, 8], [5, 6, 7, 5, 6, 7, 5, 6]]
COUNTERS = ("spec_turns_total", "spec_draft_tokens_total", "spec_accepted_total")
RF = {"type": "json_schema", "json_schema": {"schema": {
    "type": "object", "properties": {"ok": {"type": "boolean"}, "n": {"type": "integer"}}}}}


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


def _jax_tp2():
    return jax_make_mesh(JaxMeshConfig(tp=2), jax.devices()[:2])


def _tp2(spec=SPEC, **kw):
    return InferenceEngine(spec, mesh=make_mesh(MeshConfig(tp=2), ["cpu"] * 2, timeout_s=30.0),
                           **kw)


def _counters(eng, extra=()):
    m = eng.metrics()
    return {k: m[k] for k in (*COUNTERS, *extra)}


def _greedy(eng, prompts, n=24, member=0):
    sampler = JaxSampler(temperature=0.0) if isinstance(eng, JaxEngine) else GREEDY
    return [eng.generate(p, max_new_tokens=n, sampler=sampler, member=member).token_ids
            for p in prompts]


def _both(jeng, make_port, run, extra=()):
    """``run`` on the JAX engine, then on the port's, each shut down after."""
    try:
        want = run(jeng), _counters(jeng, extra)
    finally:
        jeng.shutdown()
    eng = make_port()
    try:
        got = run(eng), _counters(eng, extra)
    finally:
        eng.shutdown()
    return got, want


def test_int8_weights_and_kv(weights):
    jspec, jparams = weights
    knobs = dict(KW, quant="int8", kv_quant="int8")
    got, want = _both(JaxEngine(jspec, _jax_tp2(), params=jax.tree.map(jnp.asarray, jparams),
                                **knobs),
                      lambda: _tp2(params=params_from_numpy(jparams, "cpu"), **knobs),
                      lambda e: _greedy(e, PROMPTS))
    assert got == want
    assert got[1]["spec_accepted_total"] > 0


def _oracle(eng, ref):
    """Prompt lookup replaced by the reference continuation."""
    body = [t for t in ref if t != TOK.eos_id]
    eng._draft = lambda req, g: (body[req.emitted:req.emitted + g]
                                 if req.emitted + g <= len(body) else None)


def test_grammar_with_oracle_drafts(weights):
    jspec, jparams = weights
    params = params_from_numpy(jparams, "cpu")
    plain = InferenceEngine(SPEC, device="cpu", params=params, decode_chunk=4)
    try:
        req = plain.submit(TOK.encode("go"), max_new_tokens=32, sampler=GREEDY, eos_id=TOK.eos_id,
                           grammar=compile_response_format(RF, TOK, SPEC.vocab_size))
        ref = list(plain.stream_results(req))
    finally:
        plain.shutdown()
    extra = ("constrain_masked_tokens_total",)

    def jax_run(e):
        _oracle(e, ref)
        g = jax_compile(RF, JaxByteTokenizer(SPEC.vocab_size), SPEC.vocab_size)
        return list(e.stream_results(e.submit(TOK.encode("go"), max_new_tokens=32,
                                              sampler=JaxSampler(temperature=0.0),
                                              eos_id=TOK.eos_id, grammar=g)))

    def port_run(e):
        _oracle(e, ref)
        g = compile_response_format(RF, TOK, SPEC.vocab_size)
        out = list(e.stream_results(e.submit(TOK.encode("go"), max_new_tokens=32,
                                             sampler=GREEDY, eos_id=TOK.eos_id, grammar=g)))
        assert any(k[0] == "dfa_verify" for k in e.dispatched_keys)
        return out

    jeng = JaxEngine(jspec, _jax_tp2(), params=jparams, **KW)
    try:
        want = jax_run(jeng), _counters(jeng, extra)
    finally:
        jeng.shutdown()
    eng = _tp2(params=params, **KW)
    try:
        got = port_run(eng), _counters(eng, extra)
    finally:
        eng.shutdown()
    assert got == want
    assert got[0] == ref
    assert got[1]["spec_accepted_total"] > 0 and got[1]["constrain_masked_tokens_total"] > 0


def test_members(weights):
    jspec = weights[0]
    knobs = dict(KW, members=2)
    jeng = JaxEngine(jspec, _jax_tp2(), seed=0, **knobs)
    params = stacked_params_from_numpy(jax.tree.map(np.asarray, jeng.params), device="cpu")

    def run(e):
        return [_greedy(e, PROMPTS, member=m) for m in range(2)]

    got, want = _both(jeng, lambda: _tp2(params=params, **knobs), run)
    assert got == want
    assert got[0][0] != got[0][1]  # two weight sets
    assert got[1]["spec_accepted_total"] > 0


def test_prefix_store(weights):
    jspec, jparams = weights
    knobs = dict(KW, prefill_chunk=16, n_slots=1, prefix_store="host", prefix_store_chunk=16)
    conv = [9, 8, 9, 8, 9, 8, 9, 8] * 4 + [9]
    other = [(3 + 7 * i) % 500 for i in range(40)]
    extra = ("prefix_store_hits_total", "prefix_store_restored_tokens_total")

    def run(e):
        first = _greedy(e, [conv], 12)[0]
        e.drain_prefix_store()
        _greedy(e, [other], 4)  # takes the one slot: the follow-up restores
        e.drain_prefix_store()
        return first, _greedy(e, [conv + first + [9, 8]], 16)[0]

    got, want = _both(JaxEngine(jspec, _jax_tp2(), params=jparams, **knobs),
                      lambda: _tp2(params=params_from_numpy(jparams, "cpu"), **knobs), run,
                      extra)
    assert got == want
    assert got[1]["prefix_store_hits_total"] >= 1 and got[1]["spec_accepted_total"] > 0


def test_zero_drain(weights):
    jspec, jparams = weights
    knobs = dict(KW, prefill_chunk=16, zero_drain=True)
    got, want = _both(JaxEngine(jspec, _jax_tp2(), params=jparams, **knobs),
                      lambda: _tp2(params=params_from_numpy(jparams, "cpu"), **knobs),
                      lambda e: _greedy(e, PROMPTS + [[(5 + 3 * i) % 500 for i in range(40)]]))
    assert got == want
    assert got[1]["spec_accepted_total"] > 0


@pytest.mark.parametrize("axes", [dict(tp=2), dict(dp=2, tp=2)], ids=["tp2", "dp2tp2"])
def test_paged_equals_the_one_rank_paged_spec_engine(weights, axes):
    params = params_from_numpy(weights[1], "cpu")
    knobs = dict(KW, prefill_chunk=16, kv_pages=True)
    sampled = SamplerConfig(temperature=0.8, top_p=0.9)

    def run(e):
        return [e.generate(p, max_new_tokens=24, sampler=s, seed=5).token_ids
                for p in PROMPTS for s in (GREEDY, sampled)]

    one = InferenceEngine(SPEC, device="cpu", params=params, **knobs)
    try:
        want = run(one), _counters(one)
    finally:
        one.shutdown()
    cfg = MeshConfig(**axes)
    eng = InferenceEngine(SPEC, mesh=make_mesh(cfg, ["cpu"] * cfg.n_devices, timeout_s=30.0),
                          params=params, **knobs)
    try:
        got = run(eng), _counters(eng)
        assert any(k[:2] == ("paged", "verify") for k in eng.dispatched_keys)
    finally:
        eng.shutdown()
    assert got == want
    assert got[1]["spec_accepted_total"] > 0
