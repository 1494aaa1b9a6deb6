"""The port's decode ring (``decode_pipeline`` = K chunks in flight) against
its own K=1 and the JAX engine (the scenarios of tests/test_decode_pipeline.py).

K > 1 must be token for token K=1 in every finish mode: finishes are
detected on the device, so an EOS or a budget end inside a chunk costs no
overrun, and a host-side finish (cancel, stop string) only turns the
in-flight tail into overrun. On the CPU every chunk completes at dispatch,
but the ring's bookkeeping — dispatching ahead, planned lengths, the
admission clamp, reaping in order — runs as on the card.
llama-tiny, float32.
"""

import asyncio

import jax
import numpy as np
import pytest
import torch

from quorum_tpu.engine.engine import InferenceEngine as JaxEngine
from quorum_tpu.models.init import init_params as jax_init_params
from quorum_tpu.models.model_config import resolve_spec as jax_resolve_spec
from quorum_tpu.ops.sampling import SamplerConfig as JaxSampler
from quorum_tpu_torch.backends.cuda_backend import CudaBackend
from quorum_tpu_torch.config import BackendSpec
from quorum_tpu_torch.engine.engine import InferenceEngine, shutdown_all_engines
from quorum_tpu_torch.models.convert import params_from_numpy
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.ops.sampling import SamplerConfig

OPTS = {"dtype": "float32"}
SPEC = resolve_spec("llama-tiny", OPTS)
GREEDY = SamplerConfig(temperature=0.0)
SAMPLED = SamplerConfig(temperature=0.9, top_p=0.95)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def ring():
    """``ring(k, **kw)``: an engine at depth k on the seed-0 weights."""
    made = []

    def make(k, **kw):
        eng = InferenceEngine(SPEC, device="cpu", decode_chunk=4, decode_pipeline=k, **kw)
        made.append(eng)
        return eng

    yield make
    for e in made:
        e.shutdown()


@pytest.mark.parametrize("sampler", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
def test_depths_1_2_4_token_for_token(ring, sampler):
    engines = [ring(k) for k in (1, 2, 4)]
    for seed in (7, 42):
        got = [e.generate([5, 6, 7], max_new_tokens=32, sampler=sampler, seed=seed).token_ids
               for e in engines]
        assert got[1] == got[0] and got[2] == got[0], f"seed {seed} diverged"
        assert len(got[0]) == 32
    assert [e.metrics()["overrun_tokens_total"] for e in engines] == [0, 0, 0]
    assert [e.metrics()["decode_pipeline"] for e in engines] == [1, 2, 4]


def test_greedy_matches_the_jax_engine_at_depth_2(ring):
    jspec = jax_resolve_spec("llama-tiny", OPTS)
    jparams = jax.tree.map(np.asarray, jax_init_params(jspec, seed=4))
    jeng = JaxEngine(jspec, params=jparams, decode_chunk=4)
    try:
        assert jeng.decode_pipeline == 2
        want = [jeng.generate(p, max_new_tokens=20, sampler=JaxSampler(temperature=0.0))
                .token_ids for p in ([5, 6, 7], [9, 8, 1, 2])]
    finally:
        jeng.shutdown()
    eng = ring(2, params=params_from_numpy(jparams, device="cpu"))
    assert [eng.generate(p, max_new_tokens=20, sampler=GREEDY).token_ids
            for p in ([5, 6, 7], [9, 8, 1, 2])] == want


def test_eos_mid_chunk_token_for_token(ring):
    """EOS inside chunk 3 with further chunks in flight: the row stops on
    the device — same output, no overrun."""
    e1, e4 = ring(1), ring(4)
    probe = e1.generate([9, 8], max_new_tokens=32, sampler=GREEDY).token_ids
    eos = next(t for i, t in enumerate(probe) if i >= 9 and t not in probe[:i])
    a = e1.generate([9, 8], max_new_tokens=32, sampler=GREEDY, eos_id=eos)
    b = e4.generate([9, 8], max_new_tokens=32, sampler=GREEDY, eos_id=eos)
    assert a.token_ids == b.token_ids
    assert a.finish_reason == b.finish_reason == "stop"
    assert e4.n_overrun == 0


def test_cancel_does_not_corrupt_later_requests(ring):
    """Abandoning a stream with chunks in flight leaves the engine producing
    exactly the K=1 stream for the next request; the in-flight tail of the
    abandoned row is overrun, not output."""
    e1, e4 = ring(1), ring(4)
    it = e4.generate_stream([5, 6, 7], max_new_tokens=40, sampler=GREEDY)
    got = [tok for _, tok in zip(range(5), it)]
    it.close()  # the consumer leaves: cancel fires, the slot drains
    assert got == e1.generate([5, 6, 7], max_new_tokens=5, sampler=GREEDY).token_ids
    after1 = e1.generate([3, 4], max_new_tokens=16, sampler=GREEDY).token_ids
    after4 = e4.generate([3, 4], max_new_tokens=16, sampler=GREEDY).token_ids
    assert after4 == after1


def test_stop_sequence_parity_via_backend():
    """A host-side stop-string hit masks the row out of chunks not yet
    dispatched; the delivered text equals K=1's exactly."""
    base = {"model": "m", "messages": [{"role": "user", "content": "hi"}],
            "max_tokens": 24, "temperature": 0.0}

    def complete(k, body):
        b = CudaBackend.from_spec(BackendSpec(
            name=f"p{k}", model="m", url=f"cuda://llama-tiny?seed=5&device=cpu"
                                         f"&decode_pipeline={k}&decode_chunk=4"))
        assert b.engine.decode_pipeline == k
        return asyncio.run(b.complete(body, {}, 60)).body["choices"][0]

    # An engine another test left with these weights would come back on its
    # own ring depth: start from none.
    shutdown_all_engines()
    try:
        text = complete(1, base)["message"]["content"]
        stop = text[3:5] if len(text) >= 5 else text[-1]
        c1 = complete(1, {**base, "stop": [stop]})
        # decode_pipeline applies at construction: the same weights rebuilt
        # on a depth-4 ring need the depth-1 engine gone first.
        shutdown_all_engines()
        c4 = complete(4, {**base, "stop": [stop]})
    finally:
        shutdown_all_engines()
    assert c4["message"]["content"] == c1["message"]["content"]
    assert c4["finish_reason"] == c1["finish_reason"]


def test_admission_pressure_clamps_the_ring(ring):
    """While a chunked admission is in progress (or a pending request has
    a free row) no chunk is dispatched ahead; the clamped time is counted,
    and every stream is still its K=1 self."""
    e1 = ring(1, n_slots=2, prefill_chunk=16)
    e4 = ring(4, n_slots=2, prefill_chunk=16)
    seen = []
    dispatch = e4._dispatch_chunk

    def spy(active):
        seen.append((len(e4._inflight), len(e4._admitting)))
        return dispatch(active)

    e4._dispatch_chunk = spy
    long_prompt = [(3 + 11 * i) % 500 for i in range(100)]
    jobs = [([5, 6, 7], 60), (long_prompt, 12), ([3, 4, 5], 12), ([11, 12], 12)]

    def run_all(eng):
        # All queued before the first admission: a live stream, then a
        # chunked admission beside it, then two that wait for a free row.
        with eng._cond:
            reqs = [eng.submit(p, max_new_tokens=n, sampler=GREEDY) for p, n in jobs]
        return [list(eng.stream_results(r)) for r in reqs]

    assert run_all(e4) == run_all(e1)
    assert any(adm for _, adm in seen), "no chunk ran beside the chunked admission"
    assert all(depth == 0 for depth, adm in seen if adm), "the ring ran ahead of an admission"
    assert any(depth > 0 for depth, _ in seen), "the ring never ran ahead"
    assert e4.metrics()["admission_stall_seconds_total"] > 0
    assert e1.metrics()["admission_stall_seconds_total"] == 0


def test_dispatch_accounting_counters(ring):
    """K=2 dispatches ahead of the read (overlapped chunks), K=1 never does;
    a budget finish costs no overrun; nothing is in flight at rest."""
    e1, e2 = ring(1), ring(2)
    e1.generate([5, 6, 7], max_new_tokens=40, sampler=GREEDY)
    e2.generate([5, 6, 7], max_new_tokens=40, sampler=GREEDY)
    m1, m2 = e1.metrics(), e2.metrics()
    assert m1["overlapped_chunks_total"] == 0
    assert m2["overlapped_chunks_total"] > 0
    assert m1["decode_chunks_total"] - m1["overlapped_chunks_total"] > \
        m2["decode_chunks_total"] - m2["overlapped_chunks_total"]
    assert m2["overrun_tokens_total"] == 0
    assert m1["inflight_chunks"] == m2["inflight_chunks"] == 0
    assert (m1["decode_pipeline"], m2["decode_pipeline"]) == (1, 2)


def test_engine_defaults_are_the_jax_defaults():
    """An engine built with no knobs runs the JAX engine's defaults: depth
    2, 512-token segments aligned down to a power of two dividing max_seq
    (0 = off, as JAX aligns them), reuse on."""
    eng = InferenceEngine(SPEC, device="cpu")
    try:
        assert (eng.decode_pipeline, eng.prefill_chunk, eng.prefix_cache) == (2, 128, True)
        long_ctx = InferenceEngine(resolve_spec("llama-tiny", {**OPTS, "max_seq": "2048"}),
                                   device="cpu", n_slots=1)
        assert long_ctx.prefill_chunk == 512
        long_ctx.shutdown()
        jspec = jax_resolve_spec("llama-tiny", OPTS)
        jparams = jax.tree.map(np.asarray, jax_init_params(jspec, seed=0))
        for chunk in (0, 10, 16, 100, 512):
            jeng = JaxEngine(jspec, params=jparams, prefill_chunk=chunk, n_slots=1)
            teng = InferenceEngine(SPEC, device="cpu", prefill_chunk=chunk, n_slots=1)
            assert teng.prefill_chunk == jeng.prefill_chunk, chunk
            jeng.shutdown()
            teng.shutdown()
    finally:
        eng.shutdown()
