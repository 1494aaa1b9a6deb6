"""Speculation that composes, on the port's engine: grammar-aware drafts,
per-row gating and ring-resident verify turns — the CPU counterparts of the
JAX package's tests/test_spec_compose.py (slow there).

- A constrained request on a spec engine verifies through the
  ``"dfa_verify"`` program (each position masked by its draft-prefix DFA
  state) and streams exactly the non-speculative engine's tokens at
  ``decode_pipeline=4``, ``decode_loop=4``, greedy and sampled, with drafts
  really accepted (oracle drafts).
- A clean, a penalized and a constrained row co-batched on one spec engine
  stream what they stream on the plain engine.
- The optimistic cursor skips exactly the bonus token per pipelined turn.
- Verify turns keep the ring full: a period-1 ``logit_bias`` stream keeps
  the in-flight depth at K−1 or more for most of its turns.
- A spec engine whose traffic never drafts dispatches only the plain keys.
- Member-stacked (``members=3``) and ``ensemble=3`` spec engines stream
  the plain stacked engine's tokens.
- On the same weights and constrained greedy inputs with the same oracle
  drafts, the port's tokens, verify turns and masked-entry count equal the
  JAX spec engine's.
llama-tiny, float32.
"""

import threading

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
from quorum_tpu_torch.constrain import compile_response_format
from quorum_tpu_torch.engine.engine import InferenceEngine, _Request
from quorum_tpu_torch.engine.tokenizer import ByteTokenizer
from quorum_tpu_torch.models.convert import params_from_numpy
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.ops.sampling import SamplerConfig

OPTS = {"dtype": "float32"}
TINY = resolve_spec("llama-tiny", OPTS)
TOK = ByteTokenizer(TINY.vocab_size)
GREEDY = SamplerConfig(temperature=0.0)
SCHEMA = {"type": "object", "properties": {"ok": {"type": "boolean"},
                                           "n": {"type": "integer"}}}
RF = {"type": "json_schema", "json_schema": {"schema": SCHEMA}}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def engines():
    made = []

    def make(**kw):
        eng = InferenceEngine(TINY, device="cpu", **kw)
        made.append(eng)
        return eng

    yield make
    for e in made:
        e.shutdown()


def _grammar():
    return compile_response_format(RF, TOK, TINY.vocab_size)


def _run_constrained(eng, grammar, *, temp, seed, max_new=48):
    req = eng.submit(TOK.encode("go"), max_new_tokens=max_new,
                     sampler=SamplerConfig(temperature=temp), seed=seed, eos_id=TOK.eos_id,
                     grammar=grammar)
    return list(eng.stream_results(req))


def _oracle(eng, ref):
    """Prompt lookup replaced by the reference continuation."""
    body = [t for t in ref if t != TOK.eos_id]
    eng._draft = lambda req, g: (body[req.emitted:req.emitted + g]
                                 if req.emitted + g <= len(body) else None)


def _concurrently(fns):
    out = [None] * len(fns)

    def run(i):
        out[i] = fns[i]()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    return out


def test_constrained_spec_pin_at_k4_c4_greedy_and_sampled(engines):
    plain = engines(decode_chunk=4, decode_pipeline=4, decode_loop=4)
    spec = engines(decode_chunk=4, decode_pipeline=4, decode_loop=4, spec_decode=4)
    g = _grammar()
    for temp, seed in ((0.0, 3), (0.8, 11)):
        want = _run_constrained(plain, g, temp=temp, seed=seed)
        _oracle(spec, want)
        acc0 = spec.n_spec_accepted
        got = _run_constrained(spec, g, temp=temp, seed=seed)
        assert got == want, f"temp={temp}: constrained spec stream diverged"
        assert spec.n_spec_accepted > acc0, f"temp={temp}: no draft accepted"
    assert any(k[0] == "dfa_verify" for k in spec.dispatched_keys), spec.dispatched_keys


def test_mixed_clean_penalized_constrained_batch(engines):
    grammar = _grammar()
    sampler = SamplerConfig(temperature=0.8, top_p=0.9)

    def jobs(eng):
        def clean():
            return eng.generate([7, 7, 7, 7, 7, 7], max_new_tokens=20, sampler=GREEDY).token_ids

        def penalized():
            req = eng.submit([5, 6, 7, 5, 6, 7], max_new_tokens=20, sampler=sampler, seed=3,
                             frequency_penalty=1.5)
            return list(eng.stream_results(req))

        def constrained():
            return _run_constrained(eng, grammar, temp=0.8, seed=9, max_new=20)

        return _concurrently([clean, penalized, constrained])

    want = jobs(engines(decode_chunk=4, decode_pipeline=4, n_slots=3))
    spec = engines(decode_chunk=4, decode_pipeline=4, n_slots=3, spec_decode=4)
    clean_ref = want[0]
    real_draft = InferenceEngine._draft

    def draft(req, g):  # the oracle for the clean row only
        if req.hist[:6] == [7] * 6 and req.pp == 0.0 and req.fp == 0.0 and req.grammar is None:
            return (clean_ref[req.emitted:req.emitted + g]
                    if req.emitted + g <= len(clean_ref) else None)
        return real_draft(req, g)

    spec._draft = draft
    got = jobs(spec)
    m = spec.metrics()
    assert got == want, "mixed batch diverged from the non-speculative runs"
    assert m["spec_turns_total"] > 0 and m["spec_accepted_total"] > 0


def test_pipelined_cursor_alignment_beyond_period_1():
    """The cursor skips exactly ONE undrafted position (the bonus token) per
    pipelined turn: on a period-6 source every pipelined draft continues
    the periodic text."""
    eng = InferenceEngine.__new__(InferenceEngine)  # only _form_draft
    req = _Request([1, 2, 3, 4, 5, 6, 1, 2], 64, GREEDY, 0, None, threading.Event(), None)
    assert eng._form_draft(req, 4) == [3, 4, 5, 6]
    assert req.spec_state is not None
    req.n_inflight = 1
    assert eng._form_draft(req, 4) == [2, 3, 4, 5]
    assert eng._form_draft(req, 4) == [1, 2, 3, 4]
    assert eng._form_draft(req, 4) == [6, 1, 2, 3]


def test_ring_stays_full_through_spec_traffic(engines):
    k = 4
    eng = engines(decode_chunk=4, decode_pipeline=k, n_slots=2, spec_decode=4)
    depths = []
    orig = InferenceEngine._reap_oldest

    def probe(self):
        depths.append(len(self._inflight))
        return orig(self)

    eng._reap_oldest = probe.__get__(eng)
    bias = np.zeros((TINY.vocab_size,), np.float32)
    bias[7] = 1e9  # greedy emits 7 forever: a period-1 stream, drafts every turn

    def run():
        req = eng.submit([7, 7, 7, 7], max_new_tokens=64, sampler=GREEDY, logit_bias=bias)
        return list(eng.stream_results(req))

    run()
    depths.clear()
    t0, o0 = eng.n_spec_turns, eng.n_spec_overlapped
    out = run()
    assert out == [7] * 64
    turns, overlapped = eng.n_spec_turns - t0, eng.n_spec_overlapped - o0
    assert turns > 4
    assert overlapped >= turns // 2, (depths, turns, overlapped)
    assert max(depths) >= k, depths
    steady = depths[:-k] if len(depths) > k else depths
    assert sum(1 for d in steady if d >= k - 1) / max(1, len(steady)) >= 0.5, depths


def test_spec_engine_without_drafts_dispatches_only_plain_keys(engines):
    eng = engines(decode_chunk=4, decode_pipeline=2, spec_decode=4)
    eng.generate(list(range(7, 27)), max_new_tokens=8, sampler=GREEDY)  # no 2-gram recurs
    assert eng.dispatched_keys and all(isinstance(k[0], int) for k in eng.dispatched_keys), \
        eng.dispatched_keys
    assert eng.metrics()["spec_turns_total"] == 0
    eng.generate([9, 8, 9, 8, 9, 8, 9, 8], max_new_tokens=16, sampler=GREEDY)
    families = {k[0] if isinstance(k[0], str) else "plain" for k in eng.dispatched_keys}
    assert families <= {"plain", "verify"} and "verify" in families, families


def test_masked_counts_equal_jax():
    """Same weights, the same constrained greedy request and the same oracle
    drafts at ring depth 1: the port's and the JAX spec engine's tokens,
    verify turns and masked-entry counts are equal."""
    jspec = jax_resolve_spec("llama-tiny", OPTS)
    jparams = jax.tree.map(np.asarray, jax_init_params(jspec, seed=4))
    teng = InferenceEngine(TINY, device="cpu", params=params_from_numpy(jparams, device="cpu"),
                           decode_chunk=4, decode_pipeline=1, decode_loop=1, spec_decode=4)
    jeng = JaxEngine(jspec, params=jparams, decode_chunk=4, decode_pipeline=1, decode_loop=1,
                     spec_decode=4)
    try:
        plain = InferenceEngine(TINY, device="cpu",
                                params=params_from_numpy(jparams, device="cpu"), decode_chunk=4)
        ref = _run_constrained(plain, _grammar(), temp=0.0, seed=0, max_new=32)
        plain.shutdown()
        _oracle(teng, ref)
        _oracle(jeng, ref)
        got = _run_constrained(teng, _grammar(), temp=0.0, seed=0, max_new=32)
        jg = jax_compile(RF, JaxByteTokenizer(TINY.vocab_size), TINY.vocab_size)
        req = jeng.submit(TOK.encode("go"), max_new_tokens=32,
                          sampler=JaxSampler(temperature=0.0), seed=0, eos_id=TOK.eos_id,
                          grammar=jg)
        want = list(jeng.stream_results(req))
        tm, jm = teng.metrics(), jeng.metrics()
    finally:
        teng.shutdown()
        jeng.shutdown()
    assert got == want == ref
    keys = ("spec_turns_total", "spec_accepted_total", "constrain_masked_tokens_total")
    assert {k: tm[k] for k in keys} == {k: jm[k] for k in keys}
    assert tm["spec_accepted_total"] > 0 and tm["constrain_masked_tokens_total"] > 0


@pytest.mark.parametrize("knob", [{"members": 3}, {"ensemble": 3}], ids=["members", "ensemble"])
def test_stacked_spec_engines_equal_plain(engines, knob):
    """Verify turns over member-stacked rows (one ``decode_multi`` of every
    member's drafts, JAX's ``_stacked_rows_call``) and over an ensemble (the
    members' mean logits, ``_member_call``): the streams of co-batched
    greedy and sampled requests equal the plain stacked engine's."""
    members = knob.get("members", 1)
    jobs = [([9, 8, 9, 8, 9, 8, 9, 8], 0, GREEDY, 0),
            ([5, 6, 7, 5, 6, 7], min(1, members - 1), SamplerConfig(temperature=0.8, top_p=0.9), 3),
            ([7, 7, 7, 7], members - 1, GREEDY, 0)]

    def run(eng):
        return _concurrently([lambda j=j: eng.generate(j[0], max_new_tokens=20, sampler=j[2],
                                                       seed=j[3], member=j[1]).token_ids
                              for j in jobs])

    want = run(engines(decode_chunk=4, **knob))
    spec = engines(decode_chunk=4, spec_decode=4, **knob)
    assert run(spec) == want
    assert spec.metrics()["spec_turns_total"] > 0
