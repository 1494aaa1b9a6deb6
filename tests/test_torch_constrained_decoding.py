"""Constrained decoding on the port's engine against the JAX engine's
(tests/test_constrained_decoding.py), on llama-tiny in float32 on the CPU.

- Greedy constrained streams (json_schema, regex, json_object) equal the
  JAX engine's token for token on the same weights, at decode_pipeline 1
  and 4 and at decode_loop=4, submitted one by one and all at once, and
  on members=3 and ensemble=3 engines (JAX's stacked weights read back);
  ``constrained_requests_total`` and ``constrain_masked_tokens_total``
  equal JAX's on the same run.
- The port against itself: a grammar the plain stream already satisfies
  masks nothing (tokens equal at temperature 0 and 0.9, ring depth 1 and
  4); a wildcard grammar's dispatch and overlap counts equal the plain
  variant's (the mask adds no host sync); a mixed batch constrains only
  its grammar rows; a released constrained row serves a plain request
  unmasked; the arena keeps a grammar's offset, grows in place inside a
  bucket and moves (dropping nothing but its tables) past one; a full
  arena fails one request while a co-batched stream finishes; an arena
  reset returns every row to FREE; unconstrained dispatches use the plain
  4-tuple keys only; submit's preconditions.
"""

import json
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
from quorum_tpu_torch.engine import engine as em
from quorum_tpu_torch.engine.engine import GrammarArenaFull, InferenceEngine
from quorum_tpu_torch.engine.tokenizer import ByteTokenizer
from quorum_tpu_torch.models.convert import params_from_numpy, stacked_params_from_numpy
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.ops.sampling import SamplerConfig

OPTS = {"dtype": "float32"}
SPEC = resolve_spec("llama-tiny", OPTS)
TOK = ByteTokenizer(SPEC.vocab_size)
EOS = TOK.eos_id
GREEDY = SamplerConfig(temperature=0.0)
MAX_NEW = 32
# A finite language (boolean and enum fields only): every stream ends in EOS
# within MAX_NEW tokens.
SCHEMA = {"type": "object", "properties": {
    "ok": {"type": "boolean"},
    "dir": {"enum": ["N", "S", "E", "W"]}}}
FORMATS = [
    {"type": "json_schema", "json_schema": {"schema": SCHEMA}},
    {"type": "regex", "pattern": "[0-9]{3}-[0-9]{4}"},
    {"type": "json_object"},
]
PROMPTS = ["go", "call me", "json please"]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def shut():
    engines = []
    yield engines.append
    for e in engines:
        e.shutdown()


def grammar(rf):
    return compile_response_format(rf, TOK, SPEC.vocab_size)


def jax_grammar(rf):
    return jax_compile(rf, JaxByteTokenizer(SPEC.vocab_size), SPEC.vocab_size)


def run(eng, g, prompt="go", *, max_new=MAX_NEW, sampler=GREEDY, seed=3, **kw):
    req = eng.submit(TOK.encode(prompt), max_new_tokens=max_new, sampler=sampler, seed=seed,
                     eos_id=EOS, grammar=g, **kw)
    return list(eng.stream_results(req))


def text(toks):
    return TOK.decode([t for t in toks if t != EOS])


def concurrently(fns):
    out = [None] * len(fns)

    def go(i):
        out[i] = fns[i]()

    threads = [threading.Thread(target=go, args=(i,)) for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    return out


def _metrics(m):
    return {k: m[k] for k in ("constrained_requests_total", "constrain_masked_tokens_total")}


@pytest.fixture(scope="module")
def weights():
    jspec = jax_resolve_spec("llama-tiny", OPTS)
    return jspec, jax.tree.map(np.asarray, jax_init_params(jspec, seed=4))


@pytest.fixture(scope="module")
def jax_streams(weights):
    """The JAX engine's greedy constrained streams, one request at a time,
    and its two constrained metrics after them."""
    jspec, jparams = weights
    jeng = JaxEngine(jspec, params=jparams, decode_chunk=4)
    try:
        streams = []
        for rf, prompt in zip(FORMATS, PROMPTS):
            req = jeng.submit(TOK.encode(prompt), max_new_tokens=MAX_NEW,
                              sampler=JaxSampler(temperature=0.0), eos_id=EOS,
                              grammar=jax_grammar(rf))
            streams.append(list(jeng.stream_results(req)))
        return streams, _metrics(jeng.metrics())
    finally:
        jeng.shutdown()


def test_jax_reference_is_grammar_valid(jax_streams):
    streams, _ = jax_streams
    obj = json.loads(text(streams[0]))
    assert isinstance(obj["ok"], bool) and obj["dir"] in "NSEW"
    assert streams[0][-1] == EOS  # the grammar's sink forced EOS
    assert len(text(streams[1])) == 8 and text(streams[1])[3] == "-"


@pytest.mark.parametrize("knobs", [{"decode_pipeline": 1}, {"decode_pipeline": 4},
                                   {"decode_loop": 4}], ids=str)
def test_greedy_streams_equal_the_jax_engine(knobs, weights, jax_streams, shut):
    _, jparams = weights
    want, want_metrics = jax_streams
    eng = InferenceEngine(SPEC, device="cpu", params=params_from_numpy(jparams, device="cpu"),
                          decode_chunk=4, **knobs)
    shut(eng)
    got = [run(eng, grammar(rf), p) for rf, p in zip(FORMATS, PROMPTS)]
    assert got == want
    assert _metrics(eng.metrics()) == want_metrics
    together = concurrently([(lambda rf=rf, p=p: run(eng, grammar(rf), p))
                             for rf, p in zip(FORMATS, PROMPTS)])
    assert together == want
    m = eng.metrics()
    assert m["constrained_requests_total"] == 6 and m["overrun_tokens_total"] == 0


@pytest.mark.parametrize("knob", ["members", "ensemble"])
def test_stacked_engines_equal_the_jax_engine(knob, shut):
    """members=3: each member's own grammar and DFA state; ensemble=3: one
    stream per slot over the members' mean logits, the state the slot's."""
    jspec = jax_resolve_spec("llama-tiny", OPTS)
    jeng = JaxEngine(jspec, seed=5, decode_chunk=4, n_slots=2, **{knob: 3})
    try:
        want = []
        for m, (rf, prompt) in enumerate(zip(FORMATS, PROMPTS)):
            req = jeng.submit(TOK.encode(prompt), max_new_tokens=MAX_NEW,
                              sampler=JaxSampler(temperature=0.0), eos_id=EOS,
                              grammar=jax_grammar(rf), member=m if knob == "members" else 0)
            want.append(list(jeng.stream_results(req)))
        want_metrics = _metrics(jeng.metrics())
        params = stacked_params_from_numpy(jax.tree.map(np.asarray, jeng.params), device="cpu")
    finally:
        jeng.shutdown()
    eng = InferenceEngine(SPEC, device="cpu", params=params, decode_chunk=4, n_slots=2,
                          **{knob: 3})
    shut(eng)
    if knob == "members":
        got = concurrently([(lambda m=m, rf=rf, p=p: run(eng, grammar(rf), p, member=m))
                            for m, (rf, p) in enumerate(zip(FORMATS, PROMPTS))])
    else:
        got = [run(eng, grammar(rf), p) for rf, p in zip(FORMATS, PROMPTS)]
    assert got == want
    assert _metrics(eng.metrics()) == want_metrics


# ---- the port against itself ---------------------------------------------------

@pytest.fixture(scope="module")
def engines():
    e1 = InferenceEngine(SPEC, device="cpu", decode_chunk=4, decode_pipeline=1)
    e4 = InferenceEngine(SPEC, device="cpu", decode_chunk=4, decode_pipeline=4)
    yield e1, e4
    e1.shutdown()
    e4.shutdown()


@pytest.mark.parametrize("temp,seed", [(0.0, 3), (0.9, 7)])
def test_noop_masking_is_token_identical(engines, temp, seed):
    """A grammar accepting exactly the plain stream's bytes, then anything:
    masking a token that would be sampled anyway changes nothing."""
    e1, e4 = engines
    sampler = SamplerConfig(temperature=temp)
    base = run(e1, None, max_new=24, sampler=sampler, seed=seed)
    assert EOS not in base
    pattern = "".join("\\x%02x" % b for t in base for b in TOK.token_byte(t))
    g = grammar({"type": "regex", "pattern": pattern + "[\\x00-\\xff]*"})
    for eng in (e1, e4):
        assert run(eng, g, max_new=24, sampler=sampler, seed=seed) == base


def test_wildcard_grammar_adds_no_host_sync(engines):
    """The constrained variant with nothing to mask against the plain one,
    same seed and budget, on a depth-4 ring: identical streams, dispatch
    counts and overlapped (dispatched-ahead) counts."""
    _, e4 = engines
    wild = grammar({"type": "regex", "pattern": "[\\x00-\\xff]*"})
    sampler = SamplerConfig(temperature=0.8)
    run(e4, wild, max_new=32, sampler=sampler, seed=12)
    run(e4, None, max_new=32, sampler=sampler, seed=12)
    c0, o0 = e4.n_decode_chunks, e4.n_overlapped
    con = run(e4, wild, max_new=32, sampler=sampler, seed=13)
    c1, o1 = e4.n_decode_chunks, e4.n_overlapped
    plain = run(e4, None, max_new=32, sampler=sampler, seed=13)
    c2, o2 = e4.n_decode_chunks, e4.n_overlapped
    assert con == plain
    assert (c1 - c0, o1 - o0) == (c2 - c1, o2 - o1)
    assert o1 - o0 > 0  # the ring really ran ahead under the grammar


def test_mixed_batch_constrains_only_grammar_rows(shut):
    eng = InferenceEngine(SPEC, device="cpu", decode_chunk=4, decode_pipeline=1)
    shut(eng)
    solo = eng.generate(TOK.encode("solo"), max_new_tokens=24, sampler=GREEDY).token_ids
    with eng._cond:  # both admitted in one turn: co-batched from the first chunk
        r_con = eng.submit(TOK.encode("go"), max_new_tokens=64,
                           sampler=SamplerConfig(temperature=0.8), seed=5, eos_id=EOS,
                           grammar=grammar(FORMATS[0]))
        r_un = eng.submit(TOK.encode("solo"), max_new_tokens=24, sampler=GREEDY)
    con, un = concurrently([lambda: list(eng.stream_results(r_con)),
                            lambda: list(eng.stream_results(r_un))])
    assert un == solo
    assert json.loads(text(con))["dir"] in "NSEW"


def test_released_constrained_row_serves_a_plain_request_unmasked(shut):
    eng = InferenceEngine(SPEC, device="cpu", n_slots=1, decode_chunk=4)
    shut(eng)
    plain = eng.generate(TOK.encode("hello"), max_new_tokens=16, sampler=GREEDY).token_ids
    out = run(eng, grammar({"type": "regex", "pattern": "yes|no"}), "q", max_new=8)
    assert text(out) in ("yes", "no")
    assert int(eng._dfa[0]) > 0  # the finished row still holds its grammar state
    again = eng.generate(TOK.encode("hello"), max_new_tokens=16, sampler=GREEDY).token_ids
    assert again == plain
    assert int(eng._dfa[0]) == 0


def test_arena_keeps_offsets_and_moves_only_past_a_bucket(shut):
    eng = InferenceEngine(SPEC, device="cpu", decode_chunk=4)
    shut(eng)
    g1 = grammar(FORMATS[0])
    run(eng, g1, seed=1)
    states1, bucket1, off1 = eng._g_states, eng._g_bucket, dict(eng._g_offsets)
    assert states1 == 1 + g1.n_states and bucket1 >= states1
    table = eng._g_trans
    run(eng, g1, seed=2)
    assert (eng._g_states, eng._g_bucket, eng._g_offsets) == (states1, bucket1, off1)
    # A grammar that fits the bucket is written in place.
    small = grammar({"type": "regex", "pattern": "yes|no"})
    assert eng._g_states + small.n_states <= bucket1
    assert text(run(eng, small, "q", max_new=8)) in ("yes", "no")
    assert eng._g_trans is table and eng._g_bucket == bucket1
    assert eng._g_offsets[small.key] == states1
    # One past the bucket moves the tables; earlier offsets and rows stay.
    big = grammar(FORMATS[2])
    run(eng, big, "json please", max_new=16)
    assert eng._g_bucket > bucket1 and eng._g_trans is not table
    assert eng._g_offsets[g1.key] == off1[g1.key]
    assert torch.equal(eng._g_trans[:bucket1], torch.cat(
        [table[:states1 + small.n_states], eng._g_trans[states1 + small.n_states:bucket1]]))
    assert bool(eng._g_accept[0]) and int(eng._g_trans[0].abs().sum()) == 0  # FREE
    json.loads(text(run(eng, g1, seed=4)))


def test_full_arena_fails_one_request_while_a_cobatched_stream_finishes(shut, monkeypatch):
    eng = InferenceEngine(SPEC, device="cpu", decode_chunk=4, decode_pipeline=1)
    shut(eng)
    monkeypatch.setattr(em, "CONSTRAIN_ARENA_MAX", 8)
    small = grammar({"type": "regex", "pattern": "ab"})
    assert small.n_states <= 7
    live = eng.submit(TOK.encode("long"), max_new_tokens=48, sampler=GREEDY)
    stream = eng.stream_results(live)
    first = next(stream)  # decoding before the doomed request
    with pytest.raises(GrammarArenaFull, match="grammar arena at capacity"):
        run(eng, grammar(FORMATS[0]), "x", max_new=8)
    rest = list(stream)
    assert len([first] + rest) == 48
    assert text(run(eng, small, "x", max_new=8)) == "ab"
    assert len(eng.generate(TOK.encode("y"), max_new_tokens=4, sampler=GREEDY).token_ids) == 4


def test_arena_reset_returns_every_row_to_free(shut, monkeypatch):
    monkeypatch.setattr(em, "CONSTRAIN_ARENA_KEEP", 4)
    eng = InferenceEngine(SPEC, device="cpu", decode_chunk=4)
    fresh = InferenceEngine(SPEC, device="cpu", decode_chunk=4)
    shut(eng)
    shut(fresh)
    run(eng, grammar(FORMATS[0]))
    assert eng._g_states > 4 and int(eng._dfa.abs().sum()) > 0
    # A turn with no grammar request anywhere (here: a plain one) resets.
    plain = run(eng, None, max_new=8)
    assert eng._g_trans is None and eng._g_states == 1 and eng._g_bucket == 0
    assert int(eng._dfa.abs().sum()) == 0
    small = grammar({"type": "regex", "pattern": "yes|no"})
    got = run(eng, small, "q", max_new=8)
    assert eng._g_offsets == {small.key: 1} and eng._g_states == 1 + small.n_states
    assert got == run(fresh, small, "q", max_new=8)
    assert plain == run(fresh, None, max_new=8)


def test_unconstrained_dispatches_keep_the_plain_keys(shut):
    eng = InferenceEngine(SPEC, device="cpu", decode_chunk=4, decode_loop=4)
    shut(eng)
    keys = []
    key_of = eng._dispatch_key

    def record(active):
        keys.append(key_of(active))
        return keys[-1]

    eng._dispatch_key = record
    eng.generate(TOK.encode("hi"), max_new_tokens=8, sampler=GREEDY)
    assert keys and all(len(k) == 4 and isinstance(k[0], int) for k in keys)
    n = len(keys)
    run(eng, grammar(FORMATS[0]))
    assert keys[n:] and all(k[0] == "dfa" and k[-1] == eng._g_bucket for k in keys[n:])
    n = len(keys)
    eng.generate(TOK.encode("hi"), max_new_tokens=8, sampler=GREEDY)
    assert keys[n:] and all(len(k) == 4 and isinstance(k[0], int) for k in keys[n:])


def test_state_tensors_are_updated_in_place(shut):
    eng = InferenceEngine(SPEC, device="cpu", decode_chunk=4, decode_pipeline=2)
    shut(eng)
    ptr = eng._dfa.data_ptr()
    run(eng, grammar(FORMATS[0]))
    run(eng, None, max_new=8)
    assert eng._dfa.data_ptr() == ptr


def test_submit_preconditions(shut):
    eng = InferenceEngine(SPEC, device="cpu", decode_chunk=4, prefill_chunk=0)
    shut(eng)
    g = grammar(FORMATS[1])
    with pytest.raises(ValueError, match="chunked prefill"):
        eng.submit(TOK.encode("x"), max_new_tokens=8, eos_id=EOS, grammar=g)
    with pytest.raises(ValueError, match="EOS"):
        eng.submit(TOK.encode("x"), max_new_tokens=8, grammar=g)
    chunked = InferenceEngine(SPEC, device="cpu", decode_chunk=4)
    shut(chunked)
    other = compile_response_format(FORMATS[1], ByteTokenizer(300), 300)
    with pytest.raises(ValueError, match="does not match the model vocab 512"):
        chunked.submit(TOK.encode("x"), max_new_tokens=8, eos_id=EOS, grammar=other)
