"""Stacked ``members=M`` engines of the port against the JAX package's.

Contract (the JAX engine's ``members=M``): member i of a stacked engine
produces token for token the stream a single engine with seed ``base+i``
produces; coalesced admission and the batched member forward change only how
many dispatches a quorum costs, never the content.

- The stacked forward (``prefill`` / ``decode_step`` on member-stacked
  params, cache rows ``m·S + s``) against ``jax.vmap`` of the JAX functions
  on the same converted weights: logits within 1e-4, written cache rows
  too, and a gated-off member's rows untouched.
- The port's stacked init is bit-identical per member to its single init.
- Engines: port members = port seeded singles (own init), and port members =
  the JAX ``members=3`` engine (JAX's weights read back and converted),
  greedy, exactly; the JAX engine runs single-shot admission
  (``prefill_chunk=0``, no prefix cache) like the port.
- The scenarios of tests/test_members.py on the port, and the shipped
  three-member concatenate on ``cuda://…?members=3&member=i`` against the
  JAX app on ``tpu://…?members=3&member=i``.

llama-tiny, float32 (tolerance 1e-4 on logits; tokens exact).
"""

import asyncio
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quorum_tpu.config import Config as JaxConfig
from quorum_tpu.engine.engine import InferenceEngine as JaxEngine
from quorum_tpu.models import transformer as jtf
from quorum_tpu.models.init import init_params as jax_init_params
from quorum_tpu.models.model_config import resolve_spec as jax_resolve_spec
from quorum_tpu.ops.sampling import SamplerConfig as JaxSampler
from quorum_tpu.server.app import create_app as jax_create_app
from quorum_tpu_torch import sse
from quorum_tpu_torch.backends.cuda_backend import CudaBackend
from quorum_tpu_torch.config import BackendSpec, Config
from quorum_tpu_torch.engine.engine import InferenceEngine, shutdown_all_engines
from quorum_tpu_torch.models.convert import (params_from_numpy, stack_params,
                                             stacked_params_from_numpy)
from quorum_tpu_torch.models.init import init_params, init_params_stacked
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.models.transformer import decode_step, member_params, prefill
from quorum_tpu_torch.ops.sampling import SamplerConfig
from quorum_tpu_torch.server.app import create_app

M = 3
OPTS = {"dtype": "float32"}
GREEDY, GREEDY_J = SamplerConfig(temperature=0.0), JaxSampler(temperature=0.0)
SAMPLED = SamplerConfig(temperature=0.8, top_p=0.9)
TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def spec():
    return resolve_spec("llama-tiny", OPTS)


@pytest.fixture
def shut():
    """Engines a test builds; shut down after it."""
    engines = []
    yield engines.append
    for e in engines:
        e.shutdown()


def _tree_equal(a, b):
    for k, x in a.items():
        if k == "blocks":
            _tree_equal(x, b["blocks"])
        elif x is None:
            assert b[k] is None, k
        else:
            assert torch.equal(x, b[k]), k


def _gen(eng, member, seed, prompt, n=8, sampler=SAMPLED):
    return eng.generate(prompt, max_new_tokens=n, sampler=sampler, seed=seed,
                        member=member).token_ids


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


# ---- params ------------------------------------------------------------------

@pytest.mark.parametrize("model", ["llama-tiny", "gpt2-tiny", "gemma-tiny"])
def test_stacked_init_is_bit_identical_per_member(model):
    spec = resolve_spec(model, OPTS)
    stacked = init_params_stacked(spec, [4, 9, 4], device="cpu")
    assert stacked["blocks"]["wq"].shape[:2] == (spec.n_layers, 3)
    assert stacked["tok_emb"].shape[0] == 3
    for m, seed in enumerate([4, 9, 4]):
        _tree_equal(init_params(spec, seed, device="cpu"), member_params(stacked, m))
    # a member's single-model view is a view, not a copy
    view = member_params(stacked, 1)["blocks"]["wq"]
    assert view.data_ptr() == stacked["blocks"]["wq"][0, 1].data_ptr()


def test_converters_agree(spec):
    jspec = jax_resolve_spec("llama-tiny", OPTS)
    trees = [jax.tree.map(np.asarray, jax_init_params(jspec, seed=s)) for s in (1, 2, 3)]
    jstacked = jax.tree.map(lambda *xs: np.stack(xs), *trees)
    got = stacked_params_from_numpy(jstacked, device="cpu")
    _tree_equal(stack_params([params_from_numpy(t, device="cpu") for t in trees]), got)
    assert got["blocks"]["wq"].is_contiguous()
    _tree_equal(params_from_numpy(trees[2], device="cpu"), member_params(got, 2))


# ---- stacked forward against jax.vmap ------------------------------------------

@pytest.fixture(scope="module")
def stacked_weights():
    jspec = jax_resolve_spec("llama-tiny", OPTS)
    trees = [jax.tree.map(np.asarray, jax_init_params(jspec, seed=s)) for s in (21, 22, 23)]
    jstacked = jax.tree.map(lambda *xs: np.stack(xs), *trees)
    return jspec, jstacked, stacked_params_from_numpy(jstacked, device="cpu")


def _port_cache_by_member(cache, s):
    """[L, M·S, K, T, hd] → [M, L, S, K, T, hd] (the JAX vmapped layout)."""
    return cache.view(cache.shape[0], M, s, *cache.shape[2:]).transpose(0, 1).numpy()


def test_stacked_prefill_matches_jax_vmap(spec, stacked_weights):
    jspec, jparams, tparams = stacked_weights
    s, slot, bucket = 2, 1, 32
    rng = np.random.default_rng(0)
    tokens = rng.integers(3, spec.vocab_size, size=(M, bucket)).astype(np.int32)
    lengths = np.array([32, 11, 5], np.int32)
    gate = np.array([True, False, True])
    # Member 1's rows hold earlier content that the gated-off write must keep.
    ck0 = rng.standard_normal((M, spec.n_layers, s, spec.n_kv_heads, spec.max_seq,
                               spec.head_dim)).astype(np.float32)
    cv0 = rng.standard_normal(ck0.shape).astype(np.float32)

    def one(p, tok, lens, k, v, g):
        return jtf.prefill(p, jspec, tok[None], lens[None], k, v, slot=jnp.int32(slot),
                           write_gate=g)

    jlogits, jck, jcv = jax.vmap(one)(jparams, tokens, lengths, ck0, cv0, gate)

    def port_layout(c):
        return torch.from_numpy(c).transpose(0, 1).reshape(
            spec.n_layers, M * s, *c.shape[3:]).contiguous()

    ck, cv = port_layout(ck0), port_layout(cv0)
    logits, _, _ = prefill(tparams, spec, torch.from_numpy(tokens).long(),
                           torch.from_numpy(lengths), ck, cv,
                           rows=[m * s + slot if gate[m] else None for m in range(M)])
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits)[:, 0], atol=TOL, rtol=0)
    got_k, got_v = _port_cache_by_member(ck, s), _port_cache_by_member(cv, s)
    for m in (0, 2):  # written rows, below each member's length
        n = lengths[m]
        np.testing.assert_allclose(got_k[m, :, slot, :, :n], np.asarray(jck)[m, :, slot, :, :n],
                                   atol=TOL, rtol=0)
        np.testing.assert_allclose(got_v[m, :, slot, :, :n], np.asarray(jcv)[m, :, slot, :, :n],
                                   atol=TOL, rtol=0)
    # write gate: member 1's rows, and every other slot, are exactly as before
    assert np.array_equal(got_k[1], ck0[1]) and np.array_equal(got_v[1], cv0[1])
    assert np.array_equal(got_k[:, :, 0], ck0[:, :, 0])


def test_stacked_decode_step_matches_jax_vmap(spec, stacked_weights):
    jspec, jparams, tparams = stacked_weights
    s = 2
    rng = np.random.default_rng(1)
    ck0 = rng.standard_normal((M, spec.n_layers, s, spec.n_kv_heads, spec.max_seq,
                               spec.head_dim)).astype(np.float32)
    cv0 = rng.standard_normal(ck0.shape).astype(np.float32)
    tok = rng.integers(3, spec.vocab_size, size=(M, s)).astype(np.int32)
    pos = np.array([[7, 40], [0, 100], [63, 2]], np.int32)
    wm = np.array([[True, True], [True, False], [False, True]])

    def one(p, t, ps, k, v, w):
        return jtf.decode_step(p, jspec, t, ps, k, v, write_mask=w)

    jlogits, jck, jcv = jax.vmap(one)(jparams, tok, pos, ck0, cv0, wm)
    ck = torch.from_numpy(ck0).transpose(0, 1).reshape(spec.n_layers, M * s,
                                                       *ck0.shape[3:]).contiguous()
    cv = torch.from_numpy(cv0).transpose(0, 1).reshape(ck.shape).contiguous()
    logits, _, _ = decode_step(tparams, spec, torch.from_numpy(tok.reshape(-1)).long(),
                               torch.from_numpy(pos.reshape(-1)), ck, cv,
                               write_mask=torch.from_numpy(wm.reshape(-1)))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits).reshape(M * s, -1),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(_port_cache_by_member(ck, s), np.asarray(jck), atol=TOL, rtol=0)
    np.testing.assert_allclose(_port_cache_by_member(cv, s), np.asarray(jcv), atol=TOL, rtol=0)


# ---- engines -----------------------------------------------------------------

def test_members_match_single_engines(spec, shut):
    """Member i of a stacked engine (the port's own init, seed 0) equals a
    single engine with seed i, greedy and sampled."""
    stacked = InferenceEngine(spec, device="cpu", seed=0, members=M, decode_chunk=4, n_slots=2)
    shut(stacked)
    singles = [InferenceEngine(spec, device="cpu", seed=i, decode_chunk=4, n_slots=2)
               for i in range(M)]
    for e in singles:
        shut(e)
    prompt = [3, 4, 5]
    for smp in (GREEDY, SAMPLED):
        want = [_gen(singles[i], 0, 7, prompt, sampler=smp) for i in range(M)]
        got = [_gen(stacked, i, 7, prompt, sampler=smp) for i in range(M)]
        assert got == want
        assert len({tuple(w) for w in want}) > 1, "distinct weights should diverge"


def test_members_match_the_jax_members_engine(spec, shut):
    """JAX ``members=3`` engine → its weights read back and converted → the
    port's ``members=3`` engine: every member's greedy stream is equal,
    alone and with the three submitted at once (a coalesced admission)."""
    jspec = jax_resolve_spec("llama-tiny", OPTS)
    jeng = JaxEngine(jspec, seed=5, members=M, decode_chunk=4, n_slots=2, prefill_chunk=0,
                     prefix_cache=False)
    try:
        params = stacked_params_from_numpy(jax.tree.map(np.asarray, jeng.params), device="cpu")
        teng = InferenceEngine(spec, device="cpu", members=M, params=params, decode_chunk=4,
                               n_slots=2)
        shut(teng)
        prompts = [[5, 9, 33, 7, 81], list(range(40, 71)), [100, 3, 3, 200, 17]]
        want = [jeng.generate(p, max_new_tokens=10, sampler=GREEDY_J, member=m).token_ids
                for m, p in enumerate(prompts)]
        got = [_gen(teng, m, 0, p, n=10, sampler=GREEDY) for m, p in enumerate(prompts)]
        assert got == want
        d0 = teng.metrics()["admission_dispatches_total"]
        together = _concurrently([(lambda m=m, p=p: _gen(teng, m, 0, p, n=10, sampler=GREEDY))
                                  for m, p in enumerate(prompts)])
        assert together == want
        assert teng.metrics()["admission_dispatches_total"] - d0 <= M
    finally:
        jeng.shutdown()


def test_members_concurrent_matches_serial(spec, shut):
    eng = InferenceEngine(spec, device="cpu", seed=0, members=M, decode_chunk=4, n_slots=2)
    shut(eng)
    jobs = [(m, 11 + m, [5, 6, 7 + m]) for m in range(M)]
    serial = [_gen(eng, *j) for j in jobs]
    concurrent = _concurrently([(lambda j=j: _gen(eng, *j)) for j in jobs])
    assert concurrent == serial
    m = eng.metrics()
    assert m["slots"] == M * 2 and m["members"] == M and m["queue_limit"] == 128 * M


def test_member_isolation_mid_generation(spec, shut):
    """Admitting member 1 into the same slot index while member 0 is
    mid-generation must not disturb member 0's stream."""
    eng = InferenceEngine(spec, device="cpu", seed=0, members=2, decode_chunk=2, n_slots=2)
    shut(eng)
    solo = _gen(eng, 0, 3, [9, 8, 7], n=12)
    it = eng.generate_stream([9, 8, 7], max_new_tokens=12, sampler=SAMPLED, seed=3, member=0)
    head = [next(it) for _ in range(2)]
    other = _gen(eng, 1, 4, [1, 2], n=6)
    tail = list(it)
    assert head + tail == solo
    assert len(other) == 6


def test_more_requests_than_slots_per_member(spec, shut):
    eng = InferenceEngine(spec, device="cpu", seed=0, members=2, decode_chunk=4, n_slots=1)
    shut(eng)
    alone = [_gen(eng, i % 2, i, [5, 6], n=5) for i in range(4)]
    results = _concurrently([(lambda i=i: _gen(eng, i % 2, i, [5, 6], n=5)) for i in range(4)])
    assert results == alone and all(len(r) == 5 for r in results)


def test_member_sampler_state_isolation(spec, shut):
    """Per-member sampler state does not leak across a coalesced admission:
    member 0 greedy with top-k 1 beside member 1 sampled leaves member 1's
    stream as it is with no sibling."""
    eng = InferenceEngine(spec, device="cpu", seed=0, members=2, decode_chunk=4, n_slots=1)
    shut(eng)
    baseline = _gen(eng, 1, 3, [4, 5, 6], n=5)
    pinned = SamplerConfig(temperature=0.3, top_k=1)
    got0, got1 = _concurrently([lambda: _gen(eng, 0, 3, [4, 5, 6], n=5, sampler=pinned),
                                lambda: _gen(eng, 1, 3, [4, 5, 6], n=5)])
    assert got1 == baseline, "sibling's sampler leaked into member 1"
    assert got0 == _gen(eng, 0, 3, [4, 5, 6], n=5, sampler=GREEDY)


def test_member_out_of_range_and_exclusions(spec, shut):
    eng = InferenceEngine(spec, device="cpu", seed=0, members=2, n_slots=1)
    shut(eng)
    with pytest.raises(ValueError, match="member 5 out of range for a 2-member engine"):
        eng.submit([1, 2], max_new_tokens=2, member=5)
    with pytest.raises(ValueError, match="mutually exclusive"):
        InferenceEngine(spec, device="cpu", members=2, ensemble=2)
    with pytest.raises(ValueError, match="3-member stacked tree"):
        InferenceEngine(spec, device="cpu", members=3, params=init_params(spec, 0, "cpu"))


# ---- backends and the app ----------------------------------------------------

def _backend(url, name="B"):
    return CudaBackend.from_spec(BackendSpec(name=name, url=url, model="llama-tiny"))


def test_backend_urls_share_one_engine():
    base = "cuda://llama-tiny?slots=2&device=cpu&seed=301"
    backends = [_backend(f"{base}&members={M}&member={i}", f"LLM{i}") for i in range(M)]
    eng = backends[0].engine
    try:
        assert len({id(b.engine) for b in backends}) == 1
        assert [b.member for b in backends] == list(range(M))
        assert eng.members == M and eng.metrics()["slots"] == 2 * M
        single = _backend(base)
        assert single.engine is not eng, "?seed=301 must not share the stacked engine"
        assert _backend(f"{base}&members={M}&member_seeds=shared").engine is not eng
        with pytest.raises(ValueError, match=f"member={M} out of range for members={M}"):
            _backend(f"{base}&members={M}&member={M}")
        with pytest.raises(ValueError, match="member=1 out of range for members=1"):
            _backend(f"{base}&member=1")
    finally:
        shutdown_all_engines()


def test_stacked_backends_equal_separate_seeded_backends():
    body = {"model": "m", "messages": [{"role": "user", "content": "hello quorum"}],
            "max_tokens": 6, "temperature": 0.8, "seed": 2}

    def complete(b):
        return asyncio.run(b.complete(dict(body), {}, timeout=60)).body[
            "choices"][0]["message"]["content"]

    try:
        stacked = [_backend(f"cuda://llama-tiny?members={M}&member={i}&slots=2&device=cpu")
                   for i in range(M)]
        singles = [_backend(f"cuda://llama-tiny?seed={i}&slots=2&device=cpu") for i in range(M)]
        assert [complete(b) for b in stacked] == [complete(b) for b in singles]
    finally:
        shutdown_all_engines()


async def _post(app, body):
    raw = json.dumps(body).encode()
    sent = []

    async def receive():
        return {"type": "http.request", "body": raw, "more_body": False}

    async def send(message):
        sent.append(message)

    await app({"type": "http", "method": "POST", "path": "/v1/chat/completions",
               "headers": [(b"authorization", b"Bearer t")]}, receive, send)
    assert sent[0]["status"] == 200, sent
    return b"".join(m.get("body", b"") for m in sent[1:])


async def test_shipped_deployment_concatenate_equals_the_jax_app():
    """config.yaml's three-member concatenate: ``cuda://llama-tiny?
    members=3&member=i`` (one port engine, the JAX engine's weights loaded
    into it) against ``tpu://llama-tiny?members=3&member=i``; greedy, the
    final content and each streamed member text equal exactly."""

    def raw(scheme, extra):
        return {"settings": {"timeout": 120},
                "primary_backends": [
                    {"name": f"LLM{i + 1}",
                     "url": f"{scheme}://llama-tiny?members=3&member={i}&dtype=float32"
                            f"&slots=2{extra}"} for i in range(3)],
                "iterations": {"aggregation": {"strategy": "concatenate"}},
                "strategy": {"concatenate": {"separator": "\n-------------\n"}}}

    ref = jax_create_app(JaxConfig(raw=raw("tpu", "&prefill_chunk=0&prefix_cache=0")))
    port = create_app(Config(raw=raw("cuda", "&device=cpu")))
    jengines = {id(b.engine): b.engine for b in ref.state["registry"].backends}
    tengines = {id(b.engine): b.engine for b in port.state["registry"].backends}
    assert len(jengines) == len(tengines) == 1
    (jeng,), (teng,) = jengines.values(), tengines.values()
    teng.params = stacked_params_from_numpy(jax.tree.map(np.asarray, jeng.params), device="cpu")
    body = {"model": "llama-tiny", "max_tokens": 12, "temperature": 0,
            "messages": [{"role": "user", "content": "Name three quorum rules."}]}
    try:
        for stream in (False, True):
            got, want = (await _post(port, {**body, "stream": stream}),
                         await _post(ref, {**body, "stream": stream}))
            if not stream:
                got_text = json.loads(got)["choices"][0]["message"]["content"]
                assert got_text == json.loads(want)["choices"][0]["message"]["content"]
                assert len(set(got_text.split("\n-------------\n"))) == 3
                continue

            def texts(data):
                out = {}
                for e in sse.iter_data_events(data):
                    if isinstance(e, dict) and e.get("choices"):
                        delta = e["choices"][0]["delta"].get("content") or ""
                        out[e["id"]] = out.get(e["id"], "") + delta
                return out

            assert texts(got) == texts(want)
    finally:
        jeng.shutdown()
        shutdown_all_engines()
