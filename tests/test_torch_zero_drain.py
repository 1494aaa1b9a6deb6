"""Zero-drain staging (``zero_drain=1``) on ``cuda://`` engines (the CPU:
plain versions), after the JAX package's ``tests/test_zero_drain.py``.

- Validation of the engine knob and the URL option in the JAX package's
  words; a drain-based engine has no staging state and admits short
  prompts single-shot.
- Greedy and sampled streams, short and multi-segment, equal the
  drain-based port engine's (ring depth 4, ``decode_loop=4``), and the
  greedy ones equal the JAX engine's; every admission is staged (no
  single-shot dispatch), the ring never clamps
  (``admission_stall_seconds_total`` 0, ``_admission_pressure`` False),
  and a staged admission that registers beside a live stream counts in
  ``admission_overlap_total``.
- A failed segment dooms only its own request: the bystander's stream is
  unchanged and nothing is rebuilt. A staged admission beside an
  embedding forward keeps its stream, and the forward its vectors. The drain-based engine's stall
  accounting still counts where it applies.
- One case each for members, constrained decoding (through the backend),
  prompt-lookup speculation, a host prefix-store restore into the staging
  row, paged KV (no page leaked) and ``kv_quant=int8``, each against the
  drain-based port engine.

llama-tiny, float32."""

import asyncio
import threading

import jax
import numpy as np
import pytest
import torch

from quorum_tpu.backends.tpu_backend import TpuBackend
from quorum_tpu.config import BackendSpec as JaxBackendSpec
from quorum_tpu.engine.engine import InferenceEngine as JaxEngine
from quorum_tpu.models.init import init_params as jax_init_params
from quorum_tpu.models.model_config import resolve_spec as jax_resolve_spec
from quorum_tpu.ops.sampling import SamplerConfig as JaxSampler
from quorum_tpu_torch import faults
from quorum_tpu_torch.backends.cuda_backend import CudaBackend
from quorum_tpu_torch.config import BackendSpec
from quorum_tpu_torch.engine.engine import InferenceEngine
from quorum_tpu_torch.models.convert import params_from_numpy
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.ops.sampling import SamplerConfig

OPTS = {"dtype": "float32"}
SAMPLED = SamplerConfig(temperature=0.8, top_p=0.9)
GREEDY = SamplerConfig(temperature=0.0)
DEEP = dict(decode_chunk=4, n_slots=2, decode_pipeline=4, decode_loop=4, prefill_chunk=16)
LONG = [(3 + 5 * i) % 500 for i in range(40)]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def weights():
    jspec = jax_resolve_spec("llama-tiny", OPTS)
    return jspec, jax.tree.map(np.asarray, jax_init_params(jspec, seed=11300))


def _port(weights, **knobs):
    return InferenceEngine(resolve_spec("llama-tiny", OPTS), device="cpu",
                           params=params_from_numpy(weights[1], device="cpu"), **knobs)


def _gen(eng, prompt, seed=0, n=12, sampler=SAMPLED, **kw):
    return eng.generate(prompt, max_new_tokens=n, sampler=sampler, seed=seed, **kw).token_ids


def _streams(eng, prompts, n=12, sampler=GREEDY, **kw):
    """Submit every prompt at once (admitted in one turn), then read all."""
    with eng._cond:
        reqs = [eng.submit(p, max_new_tokens=n, sampler=sampler, seed=i, **kw)
                for i, p in enumerate(prompts)]
    return [list(eng.stream_results(r)) for r in reqs]


@pytest.fixture(scope="module")
def pair(weights):
    """A drain-based and a zero-drain port engine at ring depth 4 ×
    ``decode_loop=4``, and the JAX drain-based engine, on one weight set."""
    eng_c = _port(weights, **DEEP)
    eng_z = _port(weights, zero_drain=True, **DEEP)
    jeng = JaxEngine(weights[0], params=weights[1], **DEEP)
    yield eng_c, eng_z, jeng
    for e in (eng_c, eng_z, jeng):
        e.shutdown()


# ---- validation --------------------------------------------------------------


def test_zero_drain_engine_validation_in_jax_words(weights):
    with pytest.raises(ValueError, match="chunked prefill") as got:
        _port(weights, prefill_chunk=0, zero_drain=True)
    with pytest.raises(ValueError) as want:
        JaxEngine(weights[0], prefill_chunk=0, zero_drain=True)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="zero_drain") as got:
        InferenceEngine(resolve_spec("llama-tiny", OPTS), device="cpu", members=2,
                        member_seeds="shared", quorum_dedup=True, zero_drain=True)
    assert "does not compose with disagg/zero_drain" in str(got.value)


def _build(url: str):
    return CudaBackend.from_spec(BackendSpec(name="t", url=url, model="m"))


def _build_jax(url: str):
    return TpuBackend.from_spec(JaxBackendSpec(name="t", url=url, model="m"))


@pytest.mark.parametrize("tail", ["zero_drain=1&prefill_chunk=0", "zero_drain=maybe"],
                         ids=["no-chunking", "not-a-bool"])
def test_zero_drain_url_refusals_in_tpu_words(tail):
    with pytest.raises(ValueError) as got:
        _build(f"cuda://llama-tiny?device=cpu&{tail}")
    with pytest.raises(ValueError) as want:
        _build_jax(f"tpu://llama-tiny?{tail}")
    assert str(got.value) == str(want.value)


def test_zero_drain_beside_disagg_is_refused_by_name():
    with pytest.raises(ValueError, match="does not serve the disagg= option yet"):
        _build("cuda://llama-tiny?device=cpu&zero_drain=1&disagg=1+1")


def test_zero_drain_url_builds_a_staging_engine():
    b = _build("cuda://llama-tiny?device=cpu&dtype=float32&seed=11301&zero_drain=yes"
               "&prefill_chunk=16&slots=1")
    eng = b.engine
    try:
        assert eng.zero_drain and eng.staged and not eng.prefix_cache
        assert eng._sck is not None and eng._sck.shape == eng._ck.shape
        assert eng.metrics()["zero_drain"] == 1
        h = eng.health()
        assert h["scheduler_alive"] and h["prefill_scheduler_alive"]
    finally:
        from quorum_tpu_torch.engine.engine import release_engine

        release_engine(eng)


# ---- the streams -------------------------------------------------------------


def test_drain_based_engine_has_no_staging(pair):
    eng_c, _, _ = pair
    d0 = eng_c.n_admission_dispatches
    _gen(eng_c, [3, 4, 5], seed=1)
    assert not eng_c.zero_drain and not eng_c.staged and eng_c._sck is None
    assert eng_c.n_admission_dispatches == d0 + 1  # single-shot
    m = eng_c.metrics()
    assert (m["zero_drain"], m["admission_overlap_total"]) == (0, 0)


@pytest.mark.parametrize("leg", [([3, 4, 5], GREEDY, 0), ([7, 8, 9], SAMPLED, 11),
                                 (LONG, SAMPLED, 3), (LONG, GREEDY, 4)],
                         ids=["short-greedy", "short-sampled", "long-sampled", "long-greedy"])
def test_zero_drain_streams_equal_drain_based_and_jax(pair, leg):
    eng_c, eng_z, jeng = pair
    prompt, sampler, seed = leg
    d0, s0 = eng_z.n_admission_dispatches, eng_z.n_prefill_segments
    got = _gen(eng_z, prompt, seed=seed, sampler=sampler)
    assert got == _gen(eng_c, prompt, seed=seed, sampler=sampler)
    if sampler.greedy:
        assert got == jeng.generate(prompt, max_new_tokens=12, seed=seed,
                                    sampler=JaxSampler(temperature=0.0)).token_ids
    assert eng_z.n_admission_dispatches == d0  # never a single-shot admission
    assert eng_z.n_prefill_segments - s0 == -(-len(prompt) // 16)
    m = eng_z.metrics()
    assert m["admission_stall_seconds_total"] == 0.0
    with eng_z._cond:
        assert eng_z._admission_pressure() is False


def test_concurrent_streams_equal_drain_based(pair):
    eng_c, eng_z, _ = pair
    prompts = [[9, 8, 7], LONG, [5, 6, 7, 8, 9] * 5]
    assert _streams(eng_z, prompts, n=30) == _streams(eng_c, prompts, n=30)
    assert _streams(eng_z, prompts, n=20, sampler=SAMPLED) == _streams(
        eng_c, prompts, n=20, sampler=SAMPLED)
    assert eng_z.admission_stall_s == 0.0


@pytest.fixture(scope="module")
def smoke(weights):
    """A drain-based and a zero-drain engine at ring depth 2."""
    kw = dict(decode_chunk=4, n_slots=2, decode_pipeline=2, prefill_chunk=16)
    eng_c, eng_z = _port(weights, **kw), _port(weights, zero_drain=True, **kw)
    yield eng_c, eng_z
    eng_c.shutdown()
    eng_z.shutdown()


def test_zero_drain_injection_overlaps_live_ring(smoke):
    """A short stream registers at once; a three-segment one registers two
    turns later while the first decodes: ``admission_overlap_total``
    grows, the stall counter stays 0."""
    eng_c, eng_z = smoke
    over0 = eng_z.n_admission_overlap
    got = _streams(eng_z, [[9, 8, 7], LONG], n=40)
    assert got == _streams(eng_c, [[9, 8, 7], LONG], n=40)
    assert [len(t) for t in got] == [40, 40]
    assert eng_z.n_admission_overlap > over0
    assert eng_z.admission_stall_s == 0.0 and eng_c.n_admission_overlap == 0


def test_zero_drain_segment_fault_dooms_only_its_request(smoke):
    eng_c, eng_z = smoke
    base = _gen(eng_z, [3, 4, 5], seed=1, n=8)
    assert base == _gen(eng_c, [3, 4, 5], seed=1, n=8)
    rebuilds0, failures0 = eng_z.n_rebuilds, eng_z.n_failures
    faults.arm("engine.prefill_segment", times=1)
    try:
        with eng_z._cond:  # both admitted in one turn; the first segment is bad's
            bad = eng_z.submit([5, 6, 7], max_new_tokens=8, sampler=SAMPLED, seed=2)
            bystander = eng_z.submit([3, 4, 5], max_new_tokens=8, sampler=SAMPLED, seed=1)
        with pytest.raises(faults.FaultInjected):
            list(eng_z.stream_results(bad))
        assert list(eng_z.stream_results(bystander)) == base
    finally:
        faults.disarm()
    assert _gen(eng_z, [3, 4, 5], seed=1, n=8) == base
    assert eng_z.n_rebuilds == rebuilds0 and eng_z.n_failures == failures0 + 1
    assert eng_z.health()["scheduler_alive"]
    with eng_z._cond:
        assert not eng_z._admitting and not eng_z._claimed and not eng_z._handoffs


def test_zero_drain_admission_beside_an_embedding_forward(smoke):
    """An embedding forward on the caller's thread while a staged
    admission is in flight: the stream equals the drain-based engine's,
    and the vectors equal the forward's alone."""
    from quorum_tpu_torch.engine import embed as embed_mod

    eng_c, eng_z = smoke
    inputs = [LONG[: 8 + 4 * i] for i in range(8)]
    alone = embed_mod.embed_token_batch(eng_z, inputs)
    want = _gen(eng_c, LONG, seed=3, n=16)
    req = eng_z.submit(LONG, max_new_tokens=16, sampler=SAMPLED, seed=3)
    vecs = embed_mod.embed_token_batch(eng_z, inputs)
    assert list(eng_z.stream_results(req)) == want
    torch.testing.assert_close(vecs, alone, rtol=0, atol=1e-6)
    assert eng_z.admission_stall_s == 0.0


def test_drain_based_engine_accumulates_admission_stall(weights):
    """The coupling zero-drain retires still counts where it applies: a
    chunked admission beside a live stream clamps the ring."""
    eng = _port(weights, decode_chunk=4, n_slots=2, decode_pipeline=4, decode_loop=4,
                prefill_chunk=16)
    try:
        churn = [(11 + 5 * i) % 500 for i in range(48)]
        with eng._cond:
            stream = eng.submit([9, 8, 7], max_new_tokens=256, sampler=GREEDY)
            pre = eng.submit(churn, max_new_tokens=2, sampler=GREEDY)
        list(eng.stream_results(stream))
        list(eng.stream_results(pre))
        assert eng.admission_stall_s > 0.0
        assert eng.metrics()["admission_stall_seconds_total"] > 0.0
        assert eng.n_admission_overlap == 0
    finally:
        eng.shutdown()


# ---- one case per composition -----------------------------------------------


def _twins(weights, **knobs):
    return _port(weights, **knobs), _port(weights, zero_drain=True, **knobs)


def test_zero_drain_members_equal_drain_based(weights):
    spec = resolve_spec("llama-tiny", OPTS)
    kw = dict(members=2, seed=5, decode_chunk=4, n_slots=2, decode_pipeline=4, decode_loop=4,
              prefill_chunk=16)
    eng_c = InferenceEngine(spec, device="cpu", **kw)
    eng_z = InferenceEngine(spec, device="cpu", zero_drain=True, **kw)
    try:
        def run(eng):
            with eng._cond:
                reqs = [eng.submit(p, max_new_tokens=10, sampler=SAMPLED, seed=9, member=m)
                        for m in (0, 1) for p in ([3, 4, 5], LONG)]
            return [list(eng.stream_results(r)) for r in reqs]
        assert run(eng_z) == run(eng_c)
        assert eng_z.n_admission_dispatches == 0
    finally:
        eng_c.shutdown()
        eng_z.shutdown()


def test_zero_drain_constrained_equals_drain_based():
    """response_format JSON through the backend: the grammar is placed at
    register time, and the stream equals the drain-based engine's."""
    opts = ("dtype=float32&seed=11330&decode_pipeline=4&decode_loop=4&prefill_chunk=16"
            "&decode_chunk=4&slots=2")
    b_z = _build(f"cuda://llama-tiny?device=cpu&{opts}&zero_drain=1")
    b_c = _build(f"cuda://llama-tiny?device=cpu&{opts}")
    body = {"model": "m", "max_tokens": 24, "temperature": 0.0, "seed": 3,
            "messages": [{"role": "user", "content": "json please"}],
            "response_format": {"type": "json_object"}}

    async def run(b):
        res = await b.complete(dict(body), {}, timeout=300)
        return res.body["choices"][0]["message"]["content"]

    from quorum_tpu_torch.engine.engine import release_engine

    try:
        assert asyncio.run(run(b_z)) == asyncio.run(run(b_c))
        assert b_z.engine.n_constrained >= 1 and b_z.engine is not b_c.engine
    finally:
        release_engine(b_z.engine)
        release_engine(b_c.engine)


def test_zero_drain_spec_decode_equals_drain_based(weights):
    eng_c, eng_z = _twins(weights, decode_chunk=4, n_slots=2, decode_pipeline=4,
                          prefill_chunk=16, spec_decode=4)
    try:
        bias = np.zeros((eng_c.spec.vocab_size,), np.float32)
        bias[7] = 1e9

        def run(eng):
            req = eng.submit([7, 7, 7, 7], max_new_tokens=16, sampler=GREEDY, logit_bias=bias)
            return list(eng.stream_results(req))

        assert run(eng_z) == run(eng_c)
        assert eng_z.n_spec_turns > 0 and eng_z.admission_stall_s == 0.0
    finally:
        eng_c.shutdown()
        eng_z.shutdown()


def test_zero_drain_prefix_restore_into_staging(weights):
    """A churned-out conversation's follow-up restores from the host store
    into the STAGING row, prefills only the tail there, and injects the
    whole prefix: equal to a cold drain-based prefill."""
    eng_z = _port(weights, zero_drain=True, decode_chunk=4, n_slots=1, prefill_chunk=16,
                  prefix_store="host", prefix_store_chunk=16)
    eng_c = _port(weights, decode_chunk=4, n_slots=1, prefill_chunk=16)
    try:
        conv = [(3 + 5 * i) % 500 for i in range(33)]
        other = [(9 + 7 * i) % 500 for i in range(33)]
        out1 = _gen(eng_z, conv, seed=4, n=6)
        eng_z.drain_prefix_store()
        _gen(eng_z, other, seed=5, n=6)  # churn the single slot
        eng_z.drain_prefix_store()
        follow = conv + out1 + [17, 19]
        s0 = eng_z.n_prefill_segments
        assert _gen(eng_z, follow, seed=6, n=6) == _gen(eng_c, follow, seed=6, n=6)
        assert eng_z.prefix_store_hits >= 1 and eng_z.prefix_store_tokens_restored > 0
        assert eng_z.n_prefill_segments - s0 < -(-len(follow) // 16)
    finally:
        eng_z.shutdown()
        eng_c.shutdown()


def test_zero_drain_paged_equals_drain_based_and_leaks_no_page(weights):
    eng_c, eng_z = _twins(weights, decode_chunk=4, n_slots=2, decode_pipeline=4,
                          decode_loop=4, prefill_chunk=16, kv_pages=True, kv_page_size=16)
    try:
        prompts = [[9, 8, 7], LONG, [5, 6, 7, 8, 9] * 5]
        assert _streams(eng_z, prompts, n=20, sampler=SAMPLED) == _streams(
            eng_c, prompts, n=20, sampler=SAMPLED)
        m = eng_z.metrics()
        assert m["kv_pages_allocated"] + m["kv_pages_free"] == eng_z.kv_pool_pages
        with eng_z._cond:
            assert all(c == 0 for c in eng_z._page_claims)
    finally:
        eng_c.shutdown()
        eng_z.shutdown()


def test_zero_drain_int8_kv_equals_drain_based(weights):
    """int8 KV: the staging cache carries (q8, scale) sides and the pieces
    move them as stored."""
    eng_c, eng_z = _twins(weights, decode_chunk=4, n_slots=2, decode_pipeline=2,
                          prefill_chunk=16, kv_quant="int8")
    try:
        assert isinstance(eng_z._sck, tuple)
        prompts = [LONG, [(7 + 3 * i) % 500 for i in range(20)]]
        assert _streams(eng_z, prompts, n=16) == _streams(eng_c, prompts, n=16)
    finally:
        eng_c.shutdown()
        eng_z.shutdown()


def test_zero_drain_cancel_mid_staging_drops_its_pieces(weights):
    """A request cancelled while staged: its queued pieces are dropped, the
    row is free for the next request, and that request's stream is its
    solo run's."""
    eng = _port(weights, zero_drain=True, decode_chunk=4, n_slots=1, prefill_chunk=16)
    try:
        want = _gen(eng, [3, 4, 5], seed=1, n=8)
        cancel = threading.Event()
        stage = eng._stage_piece

        def staged(adm):  # the consumer leaves once the first piece is queued
            stage(adm)
            if adm.req.cancel is cancel:
                cancel.set()

        eng._stage_piece = staged
        with eng._cond:
            doomed = eng.submit(LONG, max_new_tokens=8, sampler=GREEDY, cancel=cancel)
            nxt = eng.submit([3, 4, 5], max_new_tokens=8, sampler=SAMPLED, seed=1)
        assert list(eng.stream_results(doomed)) == []
        assert list(eng.stream_results(nxt)) == want
        # The solo run's segment, one of LONG's, then nxt's (counted once nxt
        # has ended: its admission may run before doomed's stream returns).
        assert eng.n_prefill_segments == 1 + 1 + 1
        with eng._cond:
            assert not eng._handoffs and not eng._admitting
    finally:
        eng.shutdown()
