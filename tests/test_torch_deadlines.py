"""Engine-enforced deadlines of the port (the JAX engine's ``_sweep_deadlines``,
``_expire`` and the deadline clamp of ``_effective_loop``), and their HTTP
mapping on cuda:// backends.

- A deadline already past sheds at submit (``DeadlineExceeded("queue")``,
  counted).
- A request still queued past its deadline is shed by the scheduler's sweep
  (stage ``queue``); the backend answers it with a 503 and Retry-After.
- A deadline that passes during decode cancels the row (stage ``decode``):
  the backend answers a 504 well before its asyncio backstop, the slot is
  released and ``deadline_exceeded_total`` counts every miss.
- ``_effective_loop``'s deadline clamp: the two cases of
  tests/test_decode_loop.py::TestEffectiveLoopClamp that use deadlines, the
  port's additions (chunks in flight come off the slack; a clamped
  dispatch prefers a captured key), and a ``decode_loop=8`` engine whose
  dispatches the clamp shortens.

The decode is slowed by wrapping the engine's ``_dispatch_chunk`` (the port
has no fault-injection hook); llama-tiny on the CPU.
"""

import asyncio
import time

import pytest
import torch

from quorum_tpu_torch.backends.base import BackendError
from quorum_tpu_torch.backends.cuda_backend import CudaBackend
from quorum_tpu_torch.engine.engine import DeadlineExceeded, InferenceEngine
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.ops.sampling import SamplerConfig

SPEC = resolve_spec("llama-tiny", {})
GREEDY = SamplerConfig(temperature=0.0)
BASE = {"model": "m", "messages": [{"role": "user", "content": "hi"}]}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _slow(eng, delay=0.02):
    """Every decode dispatch takes ``delay`` seconds longer per chunk it
    covers, as a slower device would (the time counts from the dispatch, so
    the engine's per-chunk latency estimate sees it)."""
    dispatch = eng._dispatch_chunk

    def slow(active):
        c = dispatch(active)
        time.sleep(delay * c.n_chunks)
        return c

    eng._dispatch_chunk = slow


@pytest.fixture
def eng():
    e = InferenceEngine(SPEC, device="cpu", n_slots=1, decode_chunk=4)
    yield e
    e.shutdown()


def test_expired_deadline_sheds_at_submit(eng):
    with pytest.raises(DeadlineExceeded) as ei:
        eng.submit([1, 2], max_new_tokens=4, sampler=GREEDY, deadline=time.monotonic() - 1.0)
    assert ei.value.stage == "queue"
    m = eng.metrics()
    assert m["deadline_exceeded_total"] == 1 and m["requests_total"] == 0


def test_deadline_queue_shed_and_decode_cancel(eng):
    """The JAX test of the same name: a request queued behind a slow
    blocker is shed (stage queue); an admitted one whose deadline passes
    mid-decode is cancelled (stage decode) and its slot frees."""
    baseline = list(eng.generate_stream([5, 5], max_new_tokens=3, sampler=GREEDY))
    _slow(eng)
    blocker = eng.submit([1, 2, 3], max_new_tokens=100, sampler=GREEDY)
    late = eng.submit([9, 9], max_new_tokens=4, sampler=GREEDY,
                      deadline=time.monotonic() + 0.15)
    with pytest.raises(DeadlineExceeded) as ei:
        list(eng.stream_results(late))
    assert ei.value.stage == "queue"
    blocker.cancel.set()
    slow = eng.submit([4, 5, 6], max_new_tokens=100, sampler=GREEDY,
                      deadline=time.monotonic() + 0.2)
    got = []
    with pytest.raises(DeadlineExceeded) as ei:
        for t in eng.stream_results(slow):
            got.append(t)
    assert ei.value.stage == "decode"
    assert 0 < len(got) < 100
    assert list(eng.generate_stream([5, 5], max_new_tokens=3, sampler=GREEDY)) == baseline
    m = eng.metrics()
    assert m["deadline_exceeded_total"] == 2
    assert m["busy_slots"] == 0 and m["pending"] == 0


def test_deadline_during_chunked_admission_is_stage_prefill():
    """A row still prefilling in segments when its deadline passes is
    cancelled with stage prefill and its row released."""
    e = InferenceEngine(SPEC, device="cpu", n_slots=1, decode_chunk=4, prefill_chunk=16)
    segments = e._run_segments

    def slow_segments(*a, **k):
        time.sleep(0.05)
        return segments(*a, **k)

    e._run_segments = slow_segments
    try:
        req = e.submit([(3 + 7 * i) % 500 for i in range(100)], max_new_tokens=4,
                       sampler=GREEDY, deadline=time.monotonic() + 0.1)
        with pytest.raises(DeadlineExceeded) as ei:
            list(e.stream_results(req))
        assert ei.value.stage == "prefill"
        assert len(list(e.generate_stream([5, 5], max_new_tokens=3, sampler=GREEDY))) == 3
        m = e.metrics()
        assert m["deadline_exceeded_total"] == 1 and m["admitting"] == 0
    finally:
        e.shutdown()


# ---- the HTTP mapping ------------------------------------------------------------

@pytest.fixture
def backend():
    # An engine of its own (not the shared one a cuda:// URL gets): the
    # test slows it down and shuts it down.
    b = CudaBackend("dl", InferenceEngine(SPEC, device="cpu", seed=7, n_slots=1,
                                          decode_chunk=4), model_id="llama-tiny")
    _slow(b.engine, 0.03)
    yield b
    b.engine.shutdown()


@pytest.mark.parametrize("stream", [False, True])
def test_backend_maps_queue_shed_to_503_and_decode_miss_to_504(backend, stream):
    eng = backend.engine

    async def call(body, timeout):
        if not stream:
            return await backend.complete(body, {}, timeout)
        return [c async for c in backend.stream({**body, "stream": True}, {}, timeout)]

    blocker = eng.submit([1, 2, 3], max_new_tokens=100, sampler=GREEDY)
    with pytest.raises(BackendError) as ei:
        asyncio.run(call({**BASE, "max_tokens": 4}, 0.2))
    assert ei.value.status_code == 503
    assert ei.value.headers.get("Retry-After") == "1"
    assert ei.value.body["error"]["type"] == "overloaded_error"
    blocker.cancel.set()
    t0 = time.monotonic()
    with pytest.raises(BackendError) as ei:
        asyncio.run(call({**BASE, "max_tokens": 100}, 0.3))
    waited = time.monotonic() - t0
    assert ei.value.status_code == 504
    assert ei.value.body["error"]["type"] == "timeout_error"
    assert "during decode" in ei.value.body["error"]["message"]
    assert waited < 0.3 + backend.DEADLINE_SLACK_S / 2  # the engine answered, not the backstop
    deadline = time.monotonic() + 10
    while eng.metrics()["busy_slots"] and time.monotonic() < deadline:
        time.sleep(0.01)
    m = eng.metrics()
    assert m["busy_slots"] == 0 and m["deadline_exceeded_total"] == 2


def test_backend_n_choices_share_one_deadline(backend):
    """Every choice of an n > 1 request carries the request's deadline."""
    seen = []
    submit = backend.engine.submit

    def spy(*a, **k):
        seen.append(k["deadline"])
        return submit(*a, **k)

    backend.engine.submit = spy
    res = asyncio.run(backend.complete({**BASE, "max_tokens": 2, "n": 3}, {}, 30))
    assert len(res.body["choices"]) == 3
    assert len(seen) == 3 and len(set(seen)) == 1
    assert 0 < seen[0] - time.monotonic() <= 30


# ---- the deadline clamp of _effective_loop --------------------------------------

class _Row:
    """The slice of _Request the clamp and the graph key read."""

    chunk_hint, sampler, want_lp, grammar = None, GREEDY, -1, None

    def __init__(self, budget=100, emitted=0, deadline=None):
        self.budget = budget
        self.emitted = emitted
        self.deadline = deadline


class TestEffectiveLoopClamp:
    @pytest.fixture()
    def eng(self):
        e = InferenceEngine(SPEC, device="cpu", decode_chunk=4, decode_pipeline=1,
                            decode_loop=8)
        yield e
        e.shutdown()

    def test_queued_request_deadline_clamps_too(self, eng, monkeypatch):
        """A queued request with no free slot exerts no admission
        pressure, but its deadline sweep runs only between dispatches —
        its deadline must clamp C exactly like an active row's."""
        class _Pending:
            deadline = time.monotonic() + 0.25
        eng._chunk_ewma_s = 0.1
        monkeypatch.setattr(eng, "_admission_pressure", lambda: False)
        with eng._cond:
            eng._pending.append(_Pending())
        try:
            active = [(0, _Row(budget=100))]  # no deadline of its own
            assert eng._effective_loop(active, 4, 0) <= 2
        finally:
            with eng._cond:
                eng._pending.clear()

    def test_deadline_clamps_the_dispatch_length(self, eng):
        eng._chunk_ewma_s = 0.1  # 100 ms per chunk, estimated
        tight = time.monotonic() + 0.25  # fits 2 chunks, not 8
        active = [(0, _Row(budget=100, deadline=tight))]
        assert eng._effective_loop(active, 4, 0) <= 2
        # an already-blown deadline degrades to single-chunk dispatch
        late = [(0, _Row(budget=100, deadline=time.monotonic() - 1))]
        assert eng._effective_loop(late, 4, 0) == 1
        # no latency estimate yet → no clamp (first dispatch measures)
        eng._chunk_ewma_s = 0.0
        assert eng._effective_loop(active, 4, 0) == 8

    def test_clamped_dispatch_prefers_a_captured_key(self, eng):
        """On the card a key's first capture costs seconds: a dispatch the
        deadline clamps takes the largest smaller chunk count already
        captured; an unclamped one keeps its count."""
        eng._chunk_ewma_s = 0.1
        tight = [(0, _Row(budget=100, deadline=time.monotonic() + 0.25))]  # clamps 8 → 2
        free = [(0, _Row(budget=100))]
        with eng._cond:  # a set of keys stands in for the card's graphs
            try:
                eng._graphs = {(4, 1, False, False)}
                assert eng._dispatch_key(tight) == (4, 1, False, False)
                assert eng._dispatch_key(free) == (4, 8, False, False)
                eng._graphs = {(4, 1, False, False), (4, 2, False, False)}
                assert eng._dispatch_key(tight) == (4, 2, False, False)
                eng._graphs = set()  # nothing captured: the clamp's own count
                assert eng._dispatch_key(tight) == (4, 2, False, False)
            finally:
                eng._graphs = None

    def test_chunks_in_flight_count_against_the_slack(self, eng):
        """The port's addition to the JAX clamp: a dispatch issued behind
        chunks already in flight starts after them, so their estimated time
        comes off the slack."""
        class _InFlight:
            n_chunks = 4
        eng._chunk_ewma_s = 0.1
        active = [(0, _Row(budget=100, deadline=time.monotonic() + 0.55))]
        assert eng._effective_loop(active, 4, 0) == 4  # 4 × 0.1 s fits in 0.55 s
        with eng._cond:  # the (idle) scheduler cannot look at the fake meanwhile
            eng._inflight.append(_InFlight())
            try:
                assert eng._effective_loop(active, 4, 0) == 1  # 0.15 s left after them
            finally:
                eng._inflight.clear()


def test_deadline_clamp_shortens_real_dispatches():
    """A decode_loop=8 engine with a measured chunk latency: a request whose
    deadline is a few chunks away is dispatched in shorter megachunks
    (``deadline_clamps_total``), misses in stage decode, and what it got
    before the miss is a prefix of its stream without a deadline."""
    e = InferenceEngine(SPEC, device="cpu", n_slots=1, decode_chunk=4, decode_loop=8)
    _slow(e, 0.03)
    try:
        full = list(e.generate_stream([8, 9, 10], max_new_tokens=100, sampler=GREEDY))
        assert e._chunk_ewma_s > 0
        assert e.metrics()["deadline_clamps_total"] == 0
        req = e.submit([8, 9, 10], max_new_tokens=100, sampler=GREEDY,
                       deadline=time.monotonic() + 0.25)
        got = []
        with pytest.raises(DeadlineExceeded) as ei:
            for t in e.stream_results(req):
                got.append(t)
        assert ei.value.stage == "decode"
        assert got == full[:len(got)] and len(got) < len(full)
        m = e.metrics()
        assert m["deadline_clamps_total"] > 0 and m["deadline_exceeded_total"] == 1
    finally:
        e.shutdown()
