"""Fault-contained serving on the port: the fault registry and the failure
breaker against the JAX package's copies, truthful /health and /ready over
``cuda://`` engines, the robustness metric families, and the engine's
containment scenarios — a queued request survives another's dispatch
failure, an admission failure spares the others, a breaker storm opens and a
probe recovers, a failed verify turn dooms only its rows (with
``failures_total`` equal to the JAX engine's in the same scenario) — plus
the prefix-chunk routes and the HTTP retry counter. CPU, llama-tiny,
float32."""

import asyncio
import threading
import time

import httpx
import jax
import numpy as np
import pytest
import torch

from quorum_tpu import breaker as jax_breaker
from quorum_tpu import faults as jax_faults
from quorum_tpu.config import Config as JaxConfig
from quorum_tpu.engine.engine import InferenceEngine as JaxEngine
from quorum_tpu.models.init import init_params as jax_init_params
from quorum_tpu.models.model_config import resolve_spec as jax_resolve_spec
from quorum_tpu.ops.sampling import SamplerConfig as JaxSampler
from quorum_tpu.server.app import create_app as jax_create_app
from quorum_tpu_torch import breaker, faults
from quorum_tpu_torch.backends.http_backend import HttpBackend
from quorum_tpu_torch.config import Config
from quorum_tpu_torch.backends.cuda_backend import CudaBackend
from quorum_tpu_torch.engine import engine as engine_mod
from quorum_tpu_torch.engine.engine import (DeadlineExceeded, EngineBreakerOpen, InferenceEngine,
                                            shutdown_all_engines)
from quorum_tpu_torch.models.convert import params_from_numpy
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.observability import BACKEND_RETRIES
from quorum_tpu_torch.ops.sampling import SamplerConfig
from quorum_tpu_torch.server.app import create_app

AUTH = {"Authorization": "Bearer t"}
OPTS = {"dtype": "float32"}
TINY = resolve_spec("llama-tiny", OPTS)
GREEDY = SamplerConfig(temperature=0.0)


@pytest.fixture(autouse=True)
def _clean_state():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
    faults.disarm()  # no test may leak an armed site into the next
    jax_faults.disarm()


@pytest.fixture(autouse=True, scope="module")
def _release_port_engines():
    yield
    shutdown_all_engines()


def _client(app):
    return httpx.AsyncClient(transport=httpx.ASGITransport(app=app), base_url="http://t")


def _engine(**kw):
    kw.setdefault("decode_chunk", 4)
    kw.setdefault("n_slots", 2)
    return InferenceEngine(TINY, device="cpu", **kw)


def _greedy(eng, prompt, n=6, **kw):
    return eng.generate(prompt, max_new_tokens=n, sampler=GREEDY, **kw)


# ---- the fault registry and the breaker, against the JAX package's ---------


def test_faults_arm_fire_autodisarm():
    faults.reset_counts()
    assert faults.fire is faults._noop  # disarmed = the literal no-op binding
    faults.arm("engine.decode", times=2)
    assert faults.armed("engine.decode")
    for _ in range(2):
        with pytest.raises(faults.FaultInjected) as ei:
            faults.fire("engine.decode")
        assert ei.value.site == "engine.decode"
    faults.fire("engine.decode")  # auto-disarmed after `times` fires
    assert not faults.armed()
    assert faults.fire is faults._noop
    assert faults.fired("engine.decode") == 2


@pytest.mark.parametrize("site", ["engine.nonexistent", "engine.kv_handoff",
                                  "router.resume"])
def test_faults_reject_unknown_and_deferred_sites(site):
    """A site the port does not fire is refused like a typo; the JAX
    package has the deferred two."""
    with pytest.raises(ValueError):
        faults.arm(site)
    assert (site in jax_faults.SITES) == (site != "engine.nonexistent")
    with pytest.raises(ValueError):
        faults.arm("engine.decode", times=0)


def test_fault_sites_are_the_jax_package_sites_the_port_fires():
    assert set(faults.SITES) == set(jax_faults.SITES) - {"engine.kv_handoff", "router.resume"}


def test_faults_delay_mode_sleeps_instead_of_raising():
    faults.arm("engine.decode", times=1, delay=0.05)
    t0 = time.perf_counter()
    faults.fire("engine.decode")  # must NOT raise
    assert time.perf_counter() - t0 >= 0.04
    assert not faults.armed()


def test_faults_custom_exception():
    faults.arm("http.request", exc=lambda site: RuntimeError(site))
    with pytest.raises(RuntimeError):
        faults.fire("http.request")


# Each script: (threshold, window, cooldown) and a list of (op, now) steps.
BREAKER_SCRIPTS = {
    "opens_and_probes": ((2, 10.0, 1.0), [
        ("allow", 0.0), ("fail", 0.0), ("allow", 0.1), ("fail", 0.2), ("allow", 0.5),
        ("retry_after", 0.5), ("allow", 1.5), ("allow", 1.6), ("allow", 2.6),
        ("success", None), ("allow", 2.7)]),
    "half_open_failure_reopens": ((1, 10.0, 1.0), [
        ("fail", 0.0), ("allow", 1.5), ("fail", 1.6), ("allow", 1.7),
        ("retry_after", 1.7)]),
    "window_prunes_stale": ((2, 1.0, 1.0), [("fail", 0.0), ("fail", 5.0), ("allow", 5.1)]),
}


def _run_breaker(cls, params, steps):
    b = cls(*params)
    out = []
    for op, now in steps:
        if op == "allow":
            out.append(("allow", b.allow(now=now)))
        elif op == "fail":
            b.record_failure(now=now)
        elif op == "success":
            b.record_success()
        else:
            out.append(("retry_after", round(b.retry_after(now=now), 9)))
        out.append((b.state, b.state_code))
    return out


@pytest.mark.parametrize("name", sorted(BREAKER_SCRIPTS))
def test_breaker_state_machine_equals_jax(name):
    params, steps = BREAKER_SCRIPTS[name]
    got = _run_breaker(breaker.Breaker, params, steps)
    assert got == _run_breaker(jax_breaker.Breaker, params, steps)
    assert (breaker.BREAKER_THRESHOLD, breaker.BREAKER_WINDOW_S, breaker.BREAKER_COOLDOWN_S) == (
        3, 30.0, 5.0)


# ---- /health, /ready and /metrics over cuda:// engines ---------------------


def _cuda_config(seed: int, extra: str = ""):
    return {"settings": {"timeout": 30},
            "primary_backends": [{"name": "T", "url": f"cuda://llama-tiny?device=cpu&seed="
                                                      f"{9200 + seed}&slots=2{extra}",
                                  "model": "t"}]}


async def test_health_truthful_and_ready():
    app = create_app(Config(raw=_cuda_config(0)))
    async with _client(app) as client:
        r = await client.get("/health")
        body = r.json()
        assert r.status_code == 200 and body["status"] == "healthy"
        row, = body["checks"]
        assert row["scheduler_alive"] and row["snapshot_worker_alive"]
        assert row["breaker"] == "closed" and row["backend"] == "T"
        assert set(body["slo"]) == {"interactive", "batch"}
        assert (await client.get("/ready")).json() == {"status": "ready"}
        engine = app.state["registry"].get("T").engine
        for _ in range(3):
            engine.breaker.record_failure()
        assert engine.breaker.state == "open"
        assert (await client.get("/health")).json()["status"] == "degraded"
        ready = await client.get("/ready")
        assert ready.status_code == 503 and ready.json()["reason"] == "degraded"
        assert ready.headers["retry-after"] == "5"
        engine.breaker.record_success()
        assert (await client.get("/health")).json()["status"] == "healthy"


async def test_health_unhealthy_when_scheduler_dead():
    app = create_app(Config(raw=_cuda_config(1)))
    async with _client(app) as client:
        app.state["registry"].get("T").engine.shutdown()
        r = await client.get("/health")
        assert r.status_code == 503 and r.json()["status"] == "unhealthy"
        assert r.headers["retry-after"] == "5"
        assert (await client.get("/ready")).status_code == 503


async def test_health_unhealthy_when_snapshot_worker_dead():
    app = create_app(Config(raw=_cuda_config(2, "&prefill_chunk=16&prefix_store=host")))
    async with _client(app) as client:
        engine = app.state["registry"].get("T").engine
        assert (await client.get("/health")).json()["checks"][0]["snapshot_worker_alive"]
        engine._snap_queue.put(None)  # the worker's stop sentinel
        engine._snap_thread.join(timeout=10)
        r = await client.get("/health")
        assert r.status_code == 503 and r.json()["status"] == "unhealthy"
        assert r.json()["checks"][0]["snapshot_worker_alive"] is False


def _members_config(scheme: str, extra: str) -> dict:
    return {"settings": {"timeout": 30},
            "primary_backends": [{"name": f"m{i}", "model": "t",
                                  "url": f"{scheme}://llama-tiny?members=3&member={i}&seed=77"
                                         f"&slots=1{extra}"} for i in range(3)]}


async def test_health_counts_a_shared_engine_once_as_jax_does():
    """Three ``member=i`` backends over one ``members=3`` engine: one check
    row, as the JAX server gives (it reported the engine three times)."""
    app = create_app(Config(raw=_members_config("cuda", "&device=cpu")))
    japp = jax_create_app(JaxConfig(raw=_members_config("tpu", "")))
    async with _client(app) as client, _client(japp) as jclient:
        body, jbody = (await client.get("/health")).json(), (await jclient.get("/health")).json()
        text = (await client.get("/metrics")).text
    assert len(body["checks"]) == len(jbody["checks"]) == 1
    assert body["checks"][0]["backend"] == jbody["checks"][0]["backend"] == "m0"
    assert 'quorum_tpu_engine_slots{backend="m0"} 3' in text
    assert 'backend="m1"' not in text and 'backend="m2"' not in text
    for m in range(3):
        assert f'quorum_tpu_engine_member_tokens_total{{backend="m0",member="{m}"}} 0' in text


async def test_metrics_expose_robustness_families():
    app = create_app(Config(raw=_cuda_config(3)))
    async with _client(app) as client:
        text = (await client.get("/metrics")).text
    assert "# TYPE quorum_tpu_engine_rebuilds_total counter" in text
    assert "# TYPE quorum_tpu_engine_deadline_exceeded_total counter" in text
    assert "# TYPE quorum_tpu_engine_breaker_state gauge" in text
    assert 'quorum_tpu_engine_breaker_state{backend="T"} 0' in text
    assert "# TYPE quorum_tpu_deadline_exceeded_total counter" in text
    assert "# TYPE quorum_tpu_backend_retries_total counter" in text


async def test_breaker_open_sheds_submits_with_503_and_retry_after():
    app = create_app(Config(raw=_cuda_config(4)))
    async with _client(app) as client:
        engine = app.state["registry"].get("T").engine
        for _ in range(3):
            engine.breaker.record_failure()
        body = {"model": "t", "max_tokens": 2, "messages": [{"role": "user", "content": "x"}]}
        r = await client.post("/v1/chat/completions", json=body, headers=AUTH)
        rs = await client.post("/v1/chat/completions", json={**body, "stream": True},
                               headers=AUTH)
    for resp in (r, rs):
        assert resp.status_code == 503
        assert resp.json()["error"]["type"] == "overloaded_error"
        assert "circuit breaker" in resp.json()["error"]["message"]
        assert int(resp.headers["retry-after"]) >= 1


# ---- engine containment (the JAX package's slow-tier scenarios) ------------


def test_queued_request_survives_anothers_dispatch_failure():
    """A decode-dispatch failure dooms the admitted request; a pending one,
    never dispatched, stays queued and completes with the tokens of an
    undisturbed run."""
    eng = _engine(n_slots=1)
    try:
        baseline = _greedy(eng, [7, 8, 9], n=6).token_ids
        faults.arm("engine.decode", times=1)
        victim = eng.submit([3, 4, 5], max_new_tokens=8, sampler=GREEDY)
        survivor = eng.submit([7, 8, 9], max_new_tokens=6, sampler=GREEDY)
        with pytest.raises(faults.FaultInjected):
            list(eng.stream_results(victim))
        assert list(eng.stream_results(survivor)) == baseline
        assert eng.n_rebuilds == 1
        assert eng.metrics()["failures_total"] == 1
    finally:
        eng.shutdown()


def test_admission_failure_spares_active_and_pending():
    """A request's own admission dispatch failing dooms it alone: no
    rebuild, the breaker stays closed, and the engine keeps serving."""
    eng = _engine(n_slots=2)
    try:
        baseline = _greedy(eng, [5, 6], n=5).token_ids
        faults.arm("engine.admit", times=1)
        with pytest.raises(faults.FaultInjected):
            _greedy(eng, [1, 2, 3], n=4)
        assert eng.n_rebuilds == 0
        assert _greedy(eng, [5, 6], n=5).token_ids == baseline
        assert eng.breaker.state == "closed"
    finally:
        eng.shutdown()


def test_segment_failure_dooms_that_admission_only():
    eng = _engine(n_slots=2, prefill_chunk=16)
    try:
        long_prompt = list(range(3, 40))
        baseline = _greedy(eng, [5, 6], n=5).token_ids
        faults.arm("engine.prefill_segment", times=1)
        with pytest.raises(faults.FaultInjected):
            _greedy(eng, long_prompt, n=4)
        assert eng.n_rebuilds == 0 and eng.breaker.state == "closed"
        assert _greedy(eng, [5, 6], n=5).token_ids == baseline
    finally:
        eng.shutdown()


def test_deadline_queue_shed_and_decode_cancel():
    eng = _engine(n_slots=1)
    try:
        _greedy(eng, [1, 2], n=4)
        faults.arm("engine.decode", times=100000, delay=0.02)  # a slow device
        blocker = eng.submit([1, 2, 3], max_new_tokens=64, sampler=GREEDY)
        late = eng.submit([9, 9], max_new_tokens=4, sampler=GREEDY,
                          deadline=time.monotonic() + 0.15)
        with pytest.raises(DeadlineExceeded) as ei:
            list(eng.stream_results(late))
        assert ei.value.stage == "queue"
        blocker.cancel.set()
        slow = eng.submit([4, 5, 6], max_new_tokens=64, sampler=GREEDY,
                          deadline=time.monotonic() + 0.2)
        with pytest.raises(DeadlineExceeded) as ei:
            list(eng.stream_results(slow))
        assert ei.value.stage in ("prefill", "decode")
        faults.disarm()
        assert len(_greedy(eng, [5, 5], n=3).token_ids) == 3  # the slot was released
        assert eng.n_deadline_exceeded == 2
    finally:
        faults.disarm()
        eng.shutdown()


def test_deadlines_answered_while_a_capture_holds_the_scheduler():
    """A first graph capture holds the scheduler thread for seconds at full
    depth on the card; the engine's deadline watch answers the deadlines
    that pass meanwhile. Here a dispatch holds the scheduler for 1 s inside
    that watch: the active row past its deadline gets its DeadlineExceeded
    (decode) and the queued one its shed (queue) on time, not after the
    hold; the live row beside them streams as alone; nothing counts as
    cancelled, and the released row serves again."""
    eng = _engine(n_slots=2)
    try:
        live_prompt = [3, 4, 5]
        alone = _greedy(eng, live_prompt, n=12).token_ids
        real = eng._dispatch_chunk
        held = []

        def dispatch(active):
            if not held:
                held.append(True)
                with eng._deadline_watch():
                    time.sleep(1.0)  # stands for a first capture
            return real(active)

        eng._dispatch_chunk = dispatch
        t0 = time.monotonic()
        with eng._cond:  # both rows admit in one turn; the third queues
            live = eng.submit(live_prompt, max_new_tokens=12, sampler=GREEDY)
            active = eng.submit([6, 7], max_new_tokens=64, sampler=GREEDY,
                                deadline=t0 + 0.2)
            queued = eng.submit([8, 9], max_new_tokens=4, sampler=GREEDY,
                                deadline=t0 + 0.3)
        stages = []
        for r in (active, queued):
            with pytest.raises(DeadlineExceeded) as ei:
                list(eng.stream_results(r))
            stages.append((ei.value.stage, time.monotonic() - t0))
        assert [st for st, _ in stages] == ["decode", "queue"]
        assert all(waited < 0.7 for _, waited in stages), stages
        assert list(eng.stream_results(live)) == alone
        del eng._dispatch_chunk
        m = eng.metrics()
        assert m["deadline_exceeded_total"] == 2 and m["cancellations_total"] == 0
        assert len(_greedy(eng, [6, 7], n=4).token_ids) == 4
        assert eng.metrics()["busy_slots"] == 0
    finally:
        eng.shutdown()


def test_member_group_coalesces_when_its_submits_interleave(monkeypatch):
    """A stacked engine's member group whose submits arrive apart (threads
    losing the interpreter lock to the scheduler in between) still admits
    as one dispatch: the scheduler waits up to ``MEMBER_GROUP_WAIT_S``
    after the oldest head for the other members' heads. The window is
    widened here so the gaps between submits stay well inside it on a
    loaded machine. Every stream equals its member's alone."""
    monkeypatch.setattr(engine_mod, "MEMBER_GROUP_WAIT_S", 0.3)
    eng = InferenceEngine(TINY, device="cpu", members=3, seed=0, decode_chunk=4, n_slots=2)
    try:
        prompts = [[5, 9, 33, 7], [40, 41, 42], [100, 3, 3, 200]]
        alone = [list(eng.stream_results(eng.submit(p, max_new_tokens=6, sampler=GREEDY,
                                                    member=m)))
                 for m, p in enumerate(prompts)]
        for _ in range(3):
            d0 = eng.metrics()["admission_dispatches_total"]
            reqs = []
            for m, p in enumerate(prompts):
                if m:
                    time.sleep(0.03)  # the scheduler runs meanwhile
                reqs.append(eng.submit(p, max_new_tokens=6, sampler=GREEDY, member=m))
            assert [list(eng.stream_results(r)) for r in reqs] == alone
            assert eng.metrics()["admission_dispatches_total"] - d0 == 1
    finally:
        eng.shutdown()


def test_breaker_storm_opens_and_probe_recovers():
    eng = _engine()
    try:
        eng.breaker.threshold = 2
        eng.breaker.cooldown = 0.3
        baseline = _greedy(eng, [3, 4, 5], n=6).token_ids
        for _ in range(2):
            faults.arm("engine.decode", times=1)
            with pytest.raises(faults.FaultInjected):
                _greedy(eng, [6, 7], n=8)
            faults.disarm()
        assert eng.breaker.state == "open"
        with pytest.raises(EngineBreakerOpen):
            eng.submit([1, 1], max_new_tokens=2, sampler=GREEDY)
        time.sleep(0.35)
        assert _greedy(eng, [3, 4, 5], n=6).token_ids == baseline  # the probe
        assert eng.breaker.state == "closed"
    finally:
        eng.shutdown()


def _oracle(req, g):
    return [1] * g  # every row drafts: its first dispatch is a verify turn


def _containment(eng, sampler, n_slots: int, inject):
    """Fail the first verify turn (``inject()`` arms the failure): ``n_slots``
    rows admitted together are in it; one more request waits in the queue.
    Returns (the errors of the turn's rows, the survivor's stream, its
    fault-free twin's)."""
    survivor = [7, 8, 9, 10]
    twin = list(eng.stream_results(eng.submit(survivor, max_new_tokens=10, sampler=sampler)))
    inject()
    with eng._cond:  # admit the victims in one scheduler turn, the survivor after
        victims = [eng.submit([3 + i, 4, 5], max_new_tokens=8, sampler=sampler)
                   for i in range(n_slots)]
        late = eng.submit(survivor, max_new_tokens=10, sampler=sampler)
    errors = []
    for v in victims:
        try:
            list(eng.stream_results(v))
        except Exception as e:  # noqa: BLE001 - the injected fault
            errors.append(type(e).__name__)
    return errors, list(eng.stream_results(late)), twin


@pytest.mark.parametrize("n_slots", [1, 2])
def test_verify_failure_dooms_only_its_turn_like_jax(n_slots):
    """A failed verify turn on a ``spec_decode=4`` engine fails exactly the
    turn's rows — no rebuild, the queued request serves its fault-free
    twin's stream — and ``failures_total`` equals the JAX engine's in the
    same scenario."""
    jspec = jax_resolve_spec("llama-tiny", OPTS)
    jparams = jax.tree.map(np.asarray, jax_init_params(jspec, seed=5))
    kw = dict(decode_chunk=4, decode_pipeline=1, decode_loop=1, n_slots=n_slots, spec_decode=4)
    jeng = JaxEngine(jspec, params=jparams, **kw)
    teng = InferenceEngine(TINY, device="cpu", params=params_from_numpy(jparams, device="cpu"),
                           **kw)
    jeng._draft = teng._draft = _oracle
    try:
        jerr, jgot, jtwin = _containment(jeng, JaxSampler(temperature=0.0), n_slots,
                                         lambda: jax_faults.arm("engine.verify", times=1))
        terr, tgot, ttwin = _containment(teng, GREEDY, n_slots,
                                         lambda: faults.arm("engine.verify", times=1))
        jm, tm = jeng.metrics(), teng.metrics()
    finally:
        jeng.shutdown()
        teng.shutdown()
    assert terr == jerr == ["FaultInjected"] * n_slots
    assert tgot == ttwin and jgot == jtwin
    assert tm["failures_total"] == jm["failures_total"] == n_slots
    assert tm["rebuilds_total"] == jm["rebuilds_total"] == 0
    assert tm["spec_turns_total"] > 0


def _raise_once(obj, name: str, after: bool = False):
    """Make ``obj.name`` raise RuntimeError once: on entry, or ``after`` the
    real call returned; later calls are the real one."""
    real = getattr(obj, name)

    def broken(*a, **kw):
        setattr(obj, name, real)
        if after:
            real(*a, **kw)
        raise RuntimeError(f"host error in {name}")

    setattr(obj, name, broken)


@pytest.mark.parametrize("n_slots", [1, 2])
def test_verify_host_error_at_dispatch_start_is_contained_like_jax(n_slots):
    """A host-side error at the start of a speculative dispatch (not an
    injected fault) dooms only the turn's rows, as on the JAX engine, which
    contains any failure of its ``_dispatch_spec`` that left the device
    state intact: the same errors, ``failures_total`` and survivor."""
    jspec = jax_resolve_spec("llama-tiny", OPTS)
    jparams = jax.tree.map(np.asarray, jax_init_params(jspec, seed=5))
    kw = dict(decode_chunk=4, decode_pipeline=1, decode_loop=1, n_slots=n_slots, spec_decode=4)
    jeng = JaxEngine(jspec, params=jparams, **kw)
    teng = InferenceEngine(TINY, device="cpu", params=params_from_numpy(jparams, device="cpu"),
                           **kw)
    jeng._draft = teng._draft = _oracle
    try:
        jerr, jgot, jtwin = _containment(jeng, JaxSampler(temperature=0.0), n_slots,
                                         lambda: _raise_once(jeng, "_dispatch_spec"))
        terr, tgot, ttwin = _containment(teng, GREEDY, n_slots,
                                         lambda: _raise_once(teng, "_dispatch_spec"))
        jm, tm = jeng.metrics(), teng.metrics()
    finally:
        jeng.shutdown()
        teng.shutdown()
    assert terr == jerr == ["RuntimeError"] * n_slots
    assert tgot == ttwin and jgot == jtwin
    assert tm["failures_total"] == jm["failures_total"] == n_slots
    assert tm["rebuilds_total"] == jm["rebuilds_total"] == 0


def test_verify_error_after_the_dispatch_inputs_is_contained():
    """An error once the dispatch has written its inputs (the mask, the
    drafts) but before its program was issued is still contained: those
    inputs are rewritten by every dispatch, so the engine keeps serving
    without a rebuild."""
    eng = _engine(n_slots=1, spec_decode=4, decode_pipeline=1)
    eng._draft = _oracle
    try:
        baseline = _greedy(eng, [7, 8, 9, 10], n=6).token_ids
        _raise_once(eng, "_draw_noise")
        with pytest.raises(RuntimeError):
            _greedy(eng, [3, 4, 5], n=6)
        assert eng.n_rebuilds == 0 and eng.metrics()["failures_total"] == 1
        assert _greedy(eng, [7, 8, 9, 10], n=6).token_ids == baseline
    finally:
        eng.shutdown()


def test_verify_failure_after_enqueue_escalates_to_fail_all():
    """A failure inside the dispatch once its program ran on the engine's
    state (here: raised after the verify turn itself) is the scheduler
    turn's: every active row fails and the engine counts a rebuild."""
    eng = _engine(n_slots=1, spec_decode=4, decode_pipeline=1)
    eng._draft = _oracle
    try:
        _raise_once(eng, "_issue", after=True)
        with pytest.raises(RuntimeError):
            _greedy(eng, [3, 4, 5], n=6)
        assert eng.n_rebuilds == 1
        assert [k[0] for k in eng.dispatched_keys] == ["verify"]  # the failed turn's
        assert len(_greedy(eng, [3, 4, 5], n=6).token_ids) == 6
    finally:
        eng.shutdown()


def test_snapshot_fault_loses_one_snapshot_not_the_worker():
    eng = _engine(n_slots=1, prefill_chunk=16, prefix_store="host")
    try:
        prompt = list(range(3, 40))
        faults.arm("engine.snapshot", times=1)
        _greedy(eng, prompt, n=4)
        eng.drain_prefix_store()
        assert faults.fired("engine.snapshot") >= 1
        assert eng.prefix_store.n_entries == 0
        _greedy(eng, [9] + prompt, n=4)  # another prompt: a second snapshot
        eng.drain_prefix_store()
        assert eng.prefix_store.n_entries > 0
        assert eng.health()["snapshot_worker_alive"]
    finally:
        eng.shutdown()


# ---- the HTTP backend's fault sites and retry counter ----------------------


def _ok_backend(retries: int):
    def handler(req: httpx.Request) -> httpx.Response:
        if b'"stream":true' in req.content.replace(b" ", b""):
            return httpx.Response(200, content=b'data: {"choices":[{"delta":{"content":"ok"}}]}'
                                               b'\n\ndata: [DONE]\n\n',
                                  headers={"content-type": "text/event-stream"})
        return httpx.Response(200, json={
            "choices": [{"message": {"role": "assistant", "content": "ok"}}]})

    return HttpBackend("flaky", "http://u.test/v1", "m", retries=retries,
                       client=httpx.AsyncClient(transport=httpx.MockTransport(handler)))


@pytest.mark.parametrize("site", ["http.request", "http.stream"])
async def test_http_fault_sites_retry_and_count(site):
    hb = _ok_backend(retries=2)
    before = BACKEND_RETRIES.value_of(backend="flaky")
    faults.arm(site, times=1)
    body = {"messages": [{"role": "user", "content": "x"}]}
    if site == "http.request":
        res = await hb.complete(body, {}, 10.0)
        assert res.status_code == 200
    else:
        chunks = [c async for c in hb.stream(body, {}, 10.0)]
        assert any(c.get("choices") for c in chunks)
    assert faults.fired(site) >= 1
    assert BACKEND_RETRIES.value_of(backend="flaky") == before + 1


async def test_http_fault_without_retries_surfaces():
    hb = _ok_backend(retries=0)
    faults.arm("http.request", times=1)
    with pytest.raises(Exception):
        await hb.complete({"messages": [{"role": "user", "content": "x"}]}, {}, 10.0)


# ---- prefix-chunk export and import ----------------------------------------


def _store_app(seed: int, store: bool = True):
    extra = "&prefill_chunk=16&prefix_store=host" if store else ""
    return create_app(Config(raw=_cuda_config(seed, extra + "&max_seq=256")))


async def test_prefix_chunks_404_without_a_store():
    jax_app = jax_create_app(JaxConfig(raw={"primary_backends": [
        {"name": "T", "url": "tpu://llama-tiny?seed=3&slots=1", "model": "t"}]}))
    async with _client(_store_app(10, store=False)) as client, _client(jax_app) as jclient:
        for method in ("GET", "PUT"):
            r = await client.request(method, "/debug/prefix/chunks", content=b"x")
            jr = await jclient.request(method, "/debug/prefix/chunks", content=b"x")
            assert r.status_code == jr.status_code == 404
            assert r.json()["error"]["type"] == jr.json()["error"]["type"]
            assert r.json()["error"]["message"] == jr.json()["error"]["message"]


@pytest.mark.parametrize("raw", ["0", "-3", "lots"])
async def test_prefix_chunks_bad_max_bytes_is_400(raw):
    async with _client(_store_app(11)) as client:
        r = await client.get("/debug/prefix/chunks", params={"max_bytes": raw})
    assert r.status_code == 400
    assert r.json()["error"]["type"] == "invalid_request_error"


async def test_prefix_chunks_round_trip_restores():
    """Export from one ``prefix_store=host`` engine, import into another
    (a mismatched blob is a 400), and the importer's admission restores the
    prefix with the stream of a cold prefill."""
    src = _store_app(12)
    src_eng = src.state["registry"].get("T").engine
    # A second engine on the same weights, behind its own app.
    dst_eng = InferenceEngine(src_eng.spec, device="cpu", params=src_eng.params, n_slots=1,
                              prefill_chunk=16, prefix_store="host")
    dst = create_app(Config(raw=_cuda_config(12)),
                     T=CudaBackend("T", dst_eng, model="t", model_id="llama-tiny"))
    prompt = list(range(3, 60))
    try:
        cold = _greedy(src_eng, prompt, n=5).token_ids
        src_eng.drain_prefix_store()
        async with _client(src) as s, _client(dst) as d:
            exp = await s.get("/debug/prefix/chunks")
            assert exp.status_code == 200 and exp.headers["x-prefix-chunk-tokens"] == "16"
            bad = await d.put("/debug/prefix/chunks", content=exp.content[:-7])
            assert bad.status_code == 400
            assert bad.json()["error"]["type"] == "invalid_request_error"
            imp = await d.put("/debug/prefix/chunks", content=exp.content)
            assert imp.status_code == 200, imp.text
            stats = imp.json()
            assert stats["backend"] == "T" and stats["tokens_imported"] >= 48
            assert set(stats) == {"chains", "chains_imported", "tokens_imported", "store_bytes",
                                  "store_entries", "backend"}
        hits = dst_eng.prefix_store_hits
        assert _greedy(dst_eng, prompt, n=5).token_ids == cold
        assert dst_eng.prefix_store_hits == hits + 1
    finally:
        dst_eng.shutdown()


async def test_client_disconnect_mid_sse_frees_slot():
    """A consumer leaving mid-stream cancels its engine request within a
    decode chunk: the slot frees and cancellations_total counts it."""
    app = create_app(Config(raw=_cuda_config(13, "&max_seq=1024")))
    backend = app.state["registry"].get("T")
    engine = backend.engine
    body = {"model": "t", "stream": True, "max_tokens": 512,
            "logit_bias": {str(backend.tokenizer.eos_id): -100},
            "messages": [{"role": "user", "content": "go"}]}
    before = engine.n_cancelled
    agen = backend.stream(body, AUTH, 30.0)
    got = await agen.__anext__()
    assert got["choices"][0]["delta"].get("role") == "assistant"
    while engine.metrics()["busy_slots"] == 0:
        await asyncio.sleep(0.01)
    await agen.aclose()
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        m = engine.metrics()
        if m["busy_slots"] == 0 and m["admitting"] == 0 and m["cancellations_total"] > before:
            break
        await asyncio.sleep(0.02)
    m = engine.metrics()
    assert m["busy_slots"] == 0 and m["cancellations_total"] > before


def test_breaker_gate_is_thread_safe_under_concurrent_submits():
    """Submitters on many threads race the breaker: while it is open every
    submit sheds with EngineBreakerOpen; after the cool-down a probe admits,
    and every submit either sheds or streams its whole budget, none hangs."""
    import sys

    eng = _engine(n_slots=2)
    eng.breaker.threshold, eng.breaker.cooldown = 1, 0.5
    results, lock = [], threading.Lock()

    def worker(tag):
        try:
            req = eng.submit([3, 2], max_new_tokens=2, sampler=GREEDY)
            out = (tag, "ok", len(list(eng.stream_results(req))))
        except EngineBreakerOpen:
            out = (tag, "shed", 0)
        with lock:
            results.append(out)

    def wave(tag, n):
        threads = [threading.Thread(target=worker, args=(tag,)) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        eng.breaker.record_failure()  # open for 0.5 s
        wave("open", 8)
        time.sleep(0.6)
        wave("after", 8)
    finally:
        sys.setswitchinterval(old)
        eng.shutdown()
    assert len(results) == 16
    assert all(kind == "shed" for tag, kind, _ in results if tag == "open")
    assert all(kind == "shed" or n == 2 for _, kind, n in results)
    assert any(tag == "after" and kind == "ok" for tag, kind, _ in results)
