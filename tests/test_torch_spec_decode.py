"""Speculative decoding on the port's engine (``spec_decode=G``, prompt-lookup
drafts and the verify turn): the CPU counterparts of the JAX package's
tests/test_spec_decode.py, which runs in its slow tier.

The invariant: a draft token is accepted only when it equals the token the
model itself samples there, each token reading its own draw of the row's
noise, so a spec engine's tokens are the plain engine's at any temperature.
Greedy streams must equal the plain port engine's up to an audited argmax
near-tie (the T-token forward sums in another order than the T = 1 step;
the audit checks that both tokens sit within 0.05 of the true maximum
logit of a cache-free forward). Sampled, penalized and logprob streams
must be exactly equal. The drafting index and ``_draft`` must equal the
JAX engine's on the same histories, and on a greedy repetitive prompt the
port's tokens and (at ring depth 1) its spec counters must equal the JAX
spec engine's on the same weights. A chunk hint deeper than the noise ring
grows it without changing a sampled stream. llama-tiny, float32.
"""

import threading

import jax
import numpy as np
import pytest
import torch

from quorum_tpu.engine.engine import InferenceEngine as JaxEngine
from quorum_tpu.engine.engine import _Request as JaxRequest
from quorum_tpu.models.init import init_params as jax_init_params
from quorum_tpu.models.model_config import resolve_spec as jax_resolve_spec
from quorum_tpu.ops.sampling import SamplerConfig as JaxSampler
from quorum_tpu_torch.engine.engine import InferenceEngine, _Request
from quorum_tpu_torch.models.convert import params_from_numpy
from quorum_tpu_torch.models.init import init_params
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.models.transformer import forward_logits
from quorum_tpu_torch.ops.sampling import SamplerConfig

OPTS = {"dtype": "float32"}
TINY = resolve_spec("llama-tiny", OPTS)
WIDE = resolve_spec("llama-tiny", {**OPTS, "n_kv_heads": "4", "max_seq": "256"})
GREEDY = SamplerConfig(temperature=0.0)
SAMPLED = SamplerConfig(temperature=0.8, top_p=0.9)
TIE_TOL = 0.05


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def engines():
    made = []

    def make(spec=TINY, **kw):
        eng = InferenceEngine(spec, device="cpu", **kw)
        made.append(eng)
        return eng

    yield make
    for e in made:
        e.shutdown()


def assert_same_or_tie_flip(spec, prompt, a, b, seed=0, params=None):
    """Equal token for token, or the first divergence is an argmax near-tie
    of a cache-free forward (both tokens within TIE_TOL of the max logit);
    the streams legitimately differ after it."""
    if a == b:
        return
    i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    assert i is not None, f"lengths differ: {len(a)} vs {len(b)}"
    params = params if params is not None else init_params(spec, seed, "cpu")
    seq = torch.tensor([list(prompt) + a[:i]])
    logits = forward_logits(params, spec, seq)[0, -1]
    top = float(logits.max())
    assert top - float(logits[a[i]]) < TIE_TOL and top - float(logits[b[i]]) < TIE_TOL, (
        f"divergence at {i} is not a near-tie: max={top:.4f}, "
        f"plain[{a[i]}]={float(logits[a[i]]):.4f}, spec[{b[i]}]={float(logits[b[i]]):.4f}")


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


PROMPTS = [[5, 6, 7], [9, 8, 9, 8, 9, 8, 9, 8], [(3 + 7 * i) % 500 for i in range(40)]]


def test_speculative_matches_plain_greedy(engines):
    plain = engines(decode_chunk=4, n_slots=2)
    spec = engines(decode_chunk=4, n_slots=2, spec_decode=4)
    assert spec.spec_decode == 4
    for p in PROMPTS:
        a = plain.generate(p, max_new_tokens=16, sampler=GREEDY).token_ids
        b = spec.generate(p, max_new_tokens=16, sampler=GREEDY).token_ids
        assert len(b) == 16
        assert_same_or_tie_flip(TINY, p, a, b)
    m = spec.metrics()
    assert m["spec_turns_total"] > 0 and m["spec_accepted_total"] > 0


def _histories():
    rng = np.random.default_rng(0)
    yield [1, 2, 3, 9, 1, 2, 3], [9, 1, 2, 3, 4]
    yield [1, 2, 3, 4, 5, 6], [9, 1, 2, 3, 4, 5]
    for _ in range(4):
        base = rng.integers(3, 12, size=10).tolist()  # a small alphabet repeats
        yield base, rng.integers(3, 12, size=24).tolist()


def _jax_emit(req, tok):
    req.emitted += 1
    req.hist.append(tok)
    if len(req.hist) >= 3:
        req.ngram[(req.hist[-3], req.hist[-2])] = len(req.hist) - 2


@pytest.mark.parametrize("g", [2, 4])
def test_draft_and_ngram_index_equal_jax(g):
    """Prompt lookup on the same histories: the lagged index, ``_draft``
    and the pipelined ``_form_draft`` cursor give JAX's answers token by
    token as a stream grows."""
    port = InferenceEngine.__new__(InferenceEngine)  # only the host drafting path
    port.n_tokens, port.n_member_tokens, port.n_cancelled = 0, [0], 0
    jeng = JaxEngine.__new__(JaxEngine)
    for prompt, stream in _histories():
        treq = _Request(list(prompt), 64, GREEDY, 0, None, threading.Event(), None)
        jreq = JaxRequest(list(prompt), 64, JaxSampler(temperature=0.0), 0, None, None, None)
        assert treq.ngram == jreq.ngram
        assert InferenceEngine._draft(treq, g) == JaxEngine._draft(jreq, g)
        for tok in stream:
            port._emit(treq, tok)
            _jax_emit(jreq, tok)
            assert treq.ngram == jreq.ngram
            assert InferenceEngine._draft(treq, g) == JaxEngine._draft(jreq, g)
        # the optimistic cursor, fresh then pipelined
        treq.n_inflight = jreq.n_inflight = 0
        got = [port._form_draft(treq, g)]
        want = [jeng._form_draft(jreq, g)]
        treq.n_inflight = jreq.n_inflight = 1
        got += [port._form_draft(treq, g) for _ in range(3)]
        want += [jeng._form_draft(jreq, g) for _ in range(3)]
        assert got == want
        assert treq.spec_state == jreq.spec_state


def test_verification_accepts_oracle_drafts(engines):
    """Drafts that ARE the model's continuation are accepted: 12 tokens in
    at most 4 verify turns at g = 4 (each turn advances 1 + accepted)."""
    plain = engines(decode_chunk=1, n_slots=1)
    ref = plain.generate([5, 6, 7], max_new_tokens=24, sampler=GREEDY).token_ids
    eng = engines(decode_chunk=1, n_slots=1, spec_decode=4)
    eng._draft = lambda req, g: (ref[req.emitted:req.emitted + g]
                                 if req.emitted + g <= len(ref) else None)
    calls = {"n": 0}
    real = eng._dispatch_spec

    def counting(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    eng._dispatch_spec = counting
    out = eng.generate([5, 6, 7], max_new_tokens=12, sampler=GREEDY).token_ids
    assert out == ref[:12]
    assert 0 < calls["n"] <= 4, calls
    m = eng.metrics()
    assert m["spec_accepted_total"] >= 8 and m["spec_turns_total"] == calls["n"]


@pytest.mark.parametrize("pipeline", [1, 2])
def test_sampled_requests_exactly_equal_plain(engines, pipeline):
    """Seeds 0, 7 and 23 on a repetitive prompt: the spec engine's sampled
    streams are the spec_decode=0 engine's, token for token, at ring depth
    1 and 2 (token-indexed noise: a verify turn that emits e tokens moves
    the row's noise cursor by e)."""
    prompt = [3, 4, 5, 3, 4, 5, 3, 4]
    plain = engines(WIDE, decode_chunk=4, n_slots=2, decode_pipeline=pipeline)
    refs = [plain.generate(prompt, max_new_tokens=16, sampler=SAMPLED, seed=sd).token_ids
            for sd in (0, 7, 23)]
    spec = engines(WIDE, decode_chunk=4, n_slots=2, decode_pipeline=pipeline, spec_decode=4)
    outs = [spec.generate(prompt, max_new_tokens=16, sampler=SAMPLED, seed=sd).token_ids
            for sd in (0, 7, 23)]
    assert outs == refs
    # (prompt lookup rarely drafts on a random model's sampled text: the
    # oracle test below pins sampled streams through accepted drafts)


@pytest.mark.parametrize("pipeline", [1, 2])
def test_sampled_stream_with_accepted_drafts_equals_plain(engines, pipeline):
    """Oracle drafts for a SAMPLED request (the plain engine's own stream):
    turns accept several tokens, and the stream stays exactly the plain
    one — the noise of token n is draw n whatever the turn emitted."""
    plain = engines(WIDE, decode_chunk=4, n_slots=2, decode_pipeline=pipeline)
    ref = plain.generate([5, 6, 7, 8], max_new_tokens=24, sampler=SAMPLED, seed=11).token_ids
    spec = engines(WIDE, decode_chunk=4, n_slots=2, decode_pipeline=pipeline, spec_decode=4)
    spec._draft = lambda req, g: (ref[req.emitted:req.emitted + g]
                                  if req.emitted + g <= len(ref) else None)
    got = spec.generate([5, 6, 7, 8], max_new_tokens=24, sampler=SAMPLED, seed=11).token_ids
    assert got == ref
    m = spec.metrics()
    assert m["spec_accepted_total"] >= 8, m


def test_mixed_greedy_and_sampled_cobatch_matches(engines):
    jobs = [([3, 4, 5, 3, 4, 5], GREEDY, 1),
            ([9, 10, 11, 9, 10], SamplerConfig(temperature=0.9, top_p=0.8), 5)]
    plain = engines(WIDE, decode_chunk=4, n_slots=2)
    refs = [plain.generate(p, max_new_tokens=10, sampler=s, seed=sd).token_ids
            for p, s, sd in jobs]
    spec = engines(WIDE, decode_chunk=4, n_slots=2, spec_decode=4)
    outs = _concurrently([lambda j=j: spec.generate(j[0], max_new_tokens=10, sampler=j[1],
                                                    seed=j[2]).token_ids for j in jobs])
    for (p, _, _), a, b in zip(jobs, refs, outs):
        assert_same_or_tie_flip(WIDE, p, a, b)
    assert outs[1] == refs[1]  # the sampled row exactly


def test_penalty_rows_ride_at_draft_length_zero(engines):
    """A penalized sampled row beside a drafting greedy row: both stream
    exactly what they stream on the plain engine; the penalized row rode
    spec turns (one token each) without a draft."""
    def run(eng):
        def penalized():
            req = eng.submit([5, 6, 7, 5, 6, 7], max_new_tokens=12, sampler=SAMPLED, seed=3,
                             frequency_penalty=1.5, presence_penalty=0.5)
            return list(eng.stream_results(req))

        def clean():
            return eng.generate([9, 8, 9, 8, 9, 8, 9, 8], max_new_tokens=24,
                                sampler=GREEDY).token_ids

        return _concurrently([penalized, clean])

    want = run(engines(decode_chunk=4, n_slots=2))
    spec = engines(decode_chunk=4, n_slots=2, spec_decode=4)
    req = _Request([5, 6, 7], 4, SAMPLED, 0, None, threading.Event(), None, pp=0.5)
    assert not req.spec_draft_ok
    got = run(spec)
    assert got[0] == want[0]
    assert_same_or_tie_flip(TINY, [9, 8, 9, 8, 9, 8, 9, 8], want[1], got[1])
    assert spec.metrics()["spec_turns_total"] > 0


def test_logprobs_row_rides_with_correct_records(engines):
    """A logprobs row (draft length 0) beside a drafting row: one record
    per token, equal to the plain engine's within 2e-3, tokens exact."""
    def run(eng, side=None):
        req = eng.submit([7, 7, 7, 7, 7], max_new_tokens=12, sampler=GREEDY, logprobs=3)
        fns = [lambda: list(eng.stream_results(req))] + ([side] if side else [])
        toks = _concurrently(fns)[0]
        return toks, req.lp

    want_t, want_lp = run(engines(decode_chunk=4, n_slots=2))
    spec = engines(decode_chunk=4, n_slots=2, spec_decode=4)
    got_t, got_lp = run(spec, side=lambda: spec.generate(
        [9, 8, 9, 8, 9, 8, 9, 8], max_new_tokens=24, sampler=GREEDY))
    assert got_t == want_t
    assert len(got_lp) == len(got_t)
    np.testing.assert_allclose([r[0] for r in got_lp], [r[0] for r in want_lp], atol=2e-3)
    assert [r[1][:3] for r in got_lp] == [r[1][:3] for r in want_lp]


def test_generation_near_the_context_limit_is_safe(engines):
    """A verify turn near max_seq writes past the window only through the
    cap-safe path: the stream fills the window exactly, as the plain one."""
    import dataclasses

    small = dataclasses.replace(TINY, max_seq=32)
    prompt = [(5 + i) % 500 for i in range(24)]
    spec = engines(small, decode_chunk=2, n_slots=1, spec_decode=4)
    out = spec.generate(prompt, max_new_tokens=64, sampler=GREEDY).token_ids
    ref = engines(small, decode_chunk=2, n_slots=1).generate(
        prompt, max_new_tokens=64, sampler=GREEDY).token_ids
    assert len(out) == len(ref) == 32 - 24
    assert_same_or_tie_flip(small, prompt, ref, out)
    # a periodic stream runs verify turns right up to the cap
    per = [7, 8] * 12
    ref = engines(small, decode_chunk=2, n_slots=1).generate(
        per, max_new_tokens=64, sampler=GREEDY).token_ids
    out = spec.generate(per, max_new_tokens=64, sampler=GREEDY).token_ids
    assert len(out) == 8
    assert_same_or_tie_flip(small, per, ref, out)


def test_greedy_repetitive_prompt_equals_jax_spec_engine():
    """Same weights, same greedy repetitive prompt, ring depth 1: the port's
    spec engine streams the JAX spec engine's tokens, with the same verify
    turns, accepted and drafted tokens."""
    jspec = jax_resolve_spec("llama-tiny", OPTS)
    jparams = jax.tree.map(np.asarray, jax_init_params(jspec, seed=5))
    tparams = params_from_numpy(jparams, device="cpu")
    prompt = [9, 8, 9, 8, 9, 8, 9, 8, 40, 41, 9, 8]
    jeng = JaxEngine(jspec, params=jparams, decode_chunk=4, decode_pipeline=1, decode_loop=1,
                     n_slots=2, spec_decode=4)
    teng = InferenceEngine(TINY, device="cpu", params=tparams, decode_chunk=4,
                           decode_pipeline=1, decode_loop=1, n_slots=2, spec_decode=4)
    try:
        want = jeng.generate(prompt, max_new_tokens=24,
                             sampler=JaxSampler(temperature=0.0)).token_ids
        got = teng.generate(prompt, max_new_tokens=24, sampler=GREEDY).token_ids
        jm, tm = jeng.metrics(), teng.metrics()
    finally:
        jeng.shutdown()
        teng.shutdown()
    assert_same_or_tie_flip(TINY, prompt, want, got, params=tparams)
    if got == want:
        keys = ("spec_turns_total", "spec_accepted_total", "spec_draft_tokens_total")
        assert {k: tm[k] for k in keys} == {k: jm[k] for k in keys}
    assert tm["spec_turns_total"] > 0


@pytest.mark.parametrize("loop", [1, 4])
def test_noise_ring_depth_follows_what_the_host_knows(engines, loop):
    """A plain engine knows each live row's token counter exactly, so its
    ring holds one dispatch's draws; a spec engine only bounds it, so its
    ring holds the ring depth's."""
    plain = engines(decode_chunk=4, decode_loop=loop, decode_pipeline=2)
    spec = engines(decode_chunk=4, decode_loop=loop, decode_pipeline=2, spec_decode=4)
    assert plain._noise_ring.shape[0] == 4 * loop
    assert spec._noise_ring.shape[0] == 2 * max(4 * loop, 5)
    req = plain.submit([5, 6, 7], max_new_tokens=13, sampler=SAMPLED, seed=3)
    got = list(plain.stream_results(req))
    assert got == engines(decode_chunk=4, decode_loop=loop, decode_pipeline=1).generate(
        [5, 6, 7], max_new_tokens=13, sampler=SAMPLED, seed=3).token_ids


def test_chunk_hint_past_the_noise_ring_keeps_the_sampled_stream(engines):
    """A chunk hint deeper than the ring was sized for grows the ring; the
    draws not yet read move to their new slots, so the sampled stream is
    still the one an engine sized for it streams."""
    spec = engines(decode_chunk=2, spec_decode=4)
    assert spec._noise_ring.shape[0] == 2 * 5
    want = engines(decode_chunk=8).generate([5, 6, 7], max_new_tokens=30, sampler=SAMPLED,
                                            seed=3).token_ids
    req = spec.submit([5, 6, 7], max_new_tokens=30, sampler=SAMPLED, seed=3, decode_chunk=16)
    assert list(spec.stream_results(req)) == want
    assert spec._noise_ring.shape[0] >= 32
