"""The port's telemetry package against the JAX package's: the flight
recorder (ring bound, drops, dumps, the Perfetto export), the per-family
latency model, SLO classification, scoring and burn, and the program-family
names of dispatch keys — each fed the same inputs in both packages — then
the engine and app integration on ``cuda://…?device=cpu``: family-tagged
dispatch and reap events, every dispatched family in
``quorum_tpu_dispatch_device_seconds``, streams unchanged with the recorder
off, ``/debug/engine/timeline``, ``/debug/telemetry``, ``/debug/profile``
and the SLO block of ``/health``. CPU, llama-tiny."""

import json
import os
import time

import httpx
import pytest
import torch

from quorum_tpu import observability as jax_obs
from quorum_tpu.analysis import budget as jax_budget
from quorum_tpu.config import Config as JaxConfig
from quorum_tpu.server.app import create_app as jax_create_app
from quorum_tpu.telemetry import slo as jax_slo
from quorum_tpu.telemetry.latency import LatencyModel as JaxLatencyModel
from quorum_tpu.telemetry.recorder import FlightRecorder as JaxFlightRecorder
from quorum_tpu_torch import faults
from quorum_tpu_torch import observability as obs
from quorum_tpu_torch.config import Config
from quorum_tpu_torch.engine.engine import (DeadlineExceeded, InferenceEngine, program_family,
                                            shutdown_all_engines)
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.ops.sampling import SamplerConfig
from quorum_tpu_torch.server.app import create_app
from quorum_tpu_torch.telemetry import slo
from quorum_tpu_torch.telemetry.latency import LatencyModel
from quorum_tpu_torch.telemetry.recorder import RECORDER, FlightRecorder

AUTH = {"Authorization": "Bearer x"}
TINY = resolve_spec("llama-tiny", {"dtype": "float32"})
GREEDY = SamplerConfig(temperature=0.0)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True, scope="module")
def _release_port_engines():
    yield
    shutdown_all_engines()


def _client(app):
    return httpx.AsyncClient(transport=httpx.ASGITransport(app=app), base_url="http://t")


# ---- the recorder, against the JAX package's -------------------------------


def _feed(rec, t0: float) -> None:
    """The same events, at explicit stamps, into either package's recorder."""
    rec.record("dispatch", engine="e1", loop="decode", t=t0, seq=1, family="loop", depth=0,
               rids=["r1"])
    rec.record("dispatch", engine="e1", loop="decode", t=t0 + 0.01, seq=2, family="loop",
               depth=1, rids=["r1", "r2"])
    rec.record("reap", engine="e1", loop="decode", t=t0 + 0.3, seq=1, family="loop", depth=0,
               t_issue=t0, t_ready=t0 + 0.25, rids=["r1"])
    rec.record("reap", engine="e1", loop="decode", t=t0 + 0.5, seq=2, family="loop", depth=1,
               t_issue=t0 + 0.01, t_ready=t0 + 0.45, rids=["r1", "r2"])
    rec.record("admit", rid="r1", engine="e1", loop="decode", t=t0 + 0.6, queue_wait_s=0.1)
    rec.record("deadline", rid="r2", engine="e2", loop="decode", t=t0 + 0.7, stage="decode")
    rec.record("aggregate-degraded", t=t0 + 0.8, reason="empty")


def test_recorder_ring_bound_and_drops_equal_jax():
    out = []
    for cls in (FlightRecorder, JaxFlightRecorder):
        dropped = []
        rec = cls(capacity=32, enabled=True)
        rec.on_drop = lambda dropped=dropped: dropped.append(1)
        for i in range(100):
            rec.record("tick", rid=f"r{i}", t=float(i), n=i)
        out.append((rec.depth(), rec.total(), len(dropped), rec.snapshot()))
    assert out[0] == out[1]
    depth, total, n_dropped, events = out[0]
    assert (depth, total, n_dropped) == (32, 100, 68)
    assert events[0]["n"] == 68 and events[-1]["n"] == 99


def test_recorder_perfetto_export_equals_jax():
    t0 = 1234.5
    port, ref = FlightRecorder(capacity=64, enabled=True), JaxFlightRecorder(capacity=64,
                                                                             enabled=True)
    _feed(port, t0)
    _feed(ref, t0)
    assert port.snapshot() == ref.snapshot()
    te = port.to_trace_events()
    assert te == ref.to_trace_events()
    xs = [e for e in te if e["ph"] == "X"]
    assert [x["name"] for x in xs] == ["loop", "loop"]
    assert abs(xs[0]["dur"] - 0.25e6) < 1e3 and xs[0]["args"]["rids"] == ["r1"]
    assert {e["args"]["name"] for e in te if e["name"] == "process_name"} == {
        "e1", "e2", "server"}


@pytest.mark.parametrize("env,capacity,enabled", [
    ({}, 4096, True), ({"QUORUM_TPU_FLIGHT_EVENTS": "100"}, 100, True),
    ({"QUORUM_TPU_FLIGHT_EVENTS": "3"}, 16, True), ({"QUORUM_TPU_FLIGHT_RECORDER": "0"}, 4096,
                                                    False)])
def test_recorder_environment_equals_jax(monkeypatch, env, capacity, enabled):
    monkeypatch.delenv("QUORUM_TPU_FLIGHT_EVENTS", raising=False)
    monkeypatch.delenv("QUORUM_TPU_FLIGHT_RECORDER", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for cls in (FlightRecorder, JaxFlightRecorder):
        rec = cls()
        assert (rec.capacity, rec.enabled) == (capacity, enabled)


def test_recorder_disabled_records_nothing():
    rec = FlightRecorder(capacity=32, enabled=False)
    rec.record("tick")
    assert rec.depth() == 0 and rec.total() == 0
    assert rec.dump("test") is None


def test_recorder_dump_writes_parseable_artifact(tmp_path, monkeypatch):
    monkeypatch.setenv("QUORUM_TPU_FLIGHT_DUMP_INTERVAL", "0.2")
    rec = FlightRecorder(capacity=32, enabled=True)
    rec.record("containment", rid="r1", engine="e1",
               error="FaultInjected: injected fault at 'engine.verify'")
    path = rec.dump("containment", log_dir=str(tmp_path))
    assert path is not None and os.path.exists(path)
    body = json.loads(open(path).read())
    assert body["reason"] == "containment" and body["clock"] == "perf_counter"
    assert any("engine.verify" in json.dumps(e) for e in body["events"])
    assert rec.dump("containment", log_dir=str(tmp_path)) is None  # rate-limited
    assert rec.dump("fail-all", log_dir=str(tmp_path)) is not None


def test_recorder_overhead_under_per_dispatch_budget():
    """One record() must cost far below a dispatch (budget 200 µs per
    event on a loaded CPU core; typically a few µs)."""
    rec = FlightRecorder(capacity=4096, enabled=True)
    n = 5000
    t0 = time.perf_counter()
    for i in range(n):
        rec.record("dispatch", engine="e", loop="decode", seq=i, family="loop", depth=i % 4,
                   rids=["r1", "r2"])
    per_event = (time.perf_counter() - t0) / n
    assert per_event < 200e-6, f"record() cost {per_event * 1e6:.1f} us/event"


# ---- the latency model and SLO accounting, against the JAX package's -------


SAMPLES = [("loop", v) for v in (0.1, 0.2, 0.3, 0.4)] + [("plain", 0.05)] + [
    ("verify", 0.001 * i) for i in range(1, 600)] + [("plain", -1.0)]


@pytest.mark.parametrize("alpha", [0.3, 0.5])
def test_latency_model_snapshot_equals_jax(alpha):
    port, ref = LatencyModel(alpha=alpha), JaxLatencyModel(alpha=alpha)
    for fam, v in SAMPLES:
        port.observe(fam, v)
        ref.observe(fam, v)
    assert port.snapshot() == ref.snapshot()
    assert port.families() == ref.families() == ["loop", "plain", "verify"]
    assert port.ewma("loop") == ref.ewma("loop") and port.ewma("missing") == 0.0
    assert port.snapshot()["verify"]["count"] == 599  # the reservoir holds 512


@pytest.mark.parametrize("timeout", [None, 0.5, 5.0, 30.0, 30.5, 600.0])
def test_slo_classification_equals_jax(monkeypatch, timeout):
    monkeypatch.setenv("QUORUM_TPU_SLO_INTERACTIVE_S", "30")
    assert slo.classify(timeout) == jax_slo.classify(timeout)
    for cls in ("interactive", "batch"):
        assert slo.targets(cls) == jax_slo.targets(cls)


# (class, ttft, worst gap, status, a deadline-exceeded span?)
SCORED = [("interactive", 0.2, 0.05, 200, False), ("interactive", 2.0, 0.5, 504, False),
          ("batch", 1.0, None, 200, False), ("batch", None, None, 503, True),
          ("interactive", None, None, 503, False), ("interactive", 0.1, 0.01, 499, False),
          (None, 0.1, None, 200, False)]


def _score(obs_mod, tracker, rows):
    for i, (cls, ttft, gap, status, shed) in enumerate(rows):
        t = obs_mod.RequestTrace(f"req-{i}")
        if cls is not None:
            t.meta["slo"] = cls
        t.ttft, t.max_token_gap, t.status = ttft, gap, status
        if shed:
            t.add_span("deadline-exceeded", 0.0, 0.0, stage="queue")
        tracker.score_trace(t)
    return tracker.snapshot()


def test_slo_scoring_and_burn_equal_jax(monkeypatch):
    monkeypatch.setenv("QUORUM_TPU_SLO_TTFT_INTERACTIVE_S", "0.5")
    monkeypatch.setenv("QUORUM_TPU_SLO_GAP_INTERACTIVE_S", "0.1")
    good0, breach0 = obs.SLO_GOOD.value, obs.SLO_BREACHED.value
    snap = _score(obs, slo.SloTracker(), SCORED)
    assert snap == _score(jax_obs, jax_slo.SloTracker(), SCORED)
    st = snap["interactive"]["stages"]
    assert st["ttft"] == {"good": 2, "breached": 1}
    assert st["deadline"] == {"good": 1, "breached": 1}
    assert snap["batch"]["stages"]["deadline"] == {"good": 1, "breached": 1}
    assert (obs.SLO_GOOD.value - good0, obs.SLO_BREACHED.value - breach0) == (7, 4)


@pytest.mark.parametrize("raw,want", [(None, None), ("0.5", 0.5), ("junk", None), ("1.5", None),
                                      ("0", None), ("1", 1.0)])
def test_slo_ready_burn_threshold_equals_jax(monkeypatch, raw, want):
    monkeypatch.delenv("QUORUM_TPU_SLO_READY_BURN", raising=False)
    if raw is not None:
        monkeypatch.setenv("QUORUM_TPU_SLO_READY_BURN", raw)
    assert slo.ready_burn_threshold() == jax_slo.ready_burn_threshold() == want


def test_burning_class_flips_with_a_fresh_tracker(monkeypatch):
    monkeypatch.setenv("QUORUM_TPU_SLO_READY_BURN", "0.5")
    tracker = slo.SloTracker()
    monkeypatch.setattr(slo, "SLO", tracker)
    assert slo.burning_class() is None
    for _ in range(4):
        tracker.record("interactive", "ttft", False)
    assert slo.burning_class() == "interactive"
    tracker.reset()
    assert slo.burning_class() is None


# (the port's graph key, the JAX engine's decode-cache key of the same program)
KEY_PAIRS = [
    ((8, 1, False, False), (8, False, 64)),
    ((8, 4, False, True), ("loop", 4, 8, True, 64)),
    (("dfa", 8, 1, True, False, 16), ("dfa", 8, False, 64, 16)),
    (("dfa", 8, 2, False, False, 16), ("loop", 2, "dfa", 8, False, 64, 16)),
    (("verify", 4, False, False, 64), ("verify", 4, False, 64)),
    (("dfa_verify", 4, False, False, 64, 16), ("dfa_verify", 4, False, 64, 16)),
    (("spec_loop", 2, 4, False, False, 64), ("spec_loop", 2, 4, False, 64)),
    (("spec_loop", 2, 4, False, False, 64, "dfa", 16), ("spec_loop_dfa", 2, 4, False, 64, 16)),
    (("paged", 8, 1, False, False, 64), ("paged", 8, False, 64)),
    (("paged", 8, 4, False, False, 64), ("paged", "loop", 4, 8, False, 64)),
    (("paged", "dfa", 8, 1, False, False, 16, 64), ("paged", "dfa", 8, False, 64, 16)),
    (("paged", "verify", 4, False, False, 64), ("paged", "verify", 4, False, 64)),
]


@pytest.mark.parametrize("port_key,jax_key", KEY_PAIRS, ids=[str(p[1]) for p in KEY_PAIRS])
def test_program_family_names_equal_jax(port_key, jax_key):
    assert program_family(port_key) == jax_budget.classify_decode_key(jax_key)


# ---- the engine's events and device time ------------------------------------


def test_megachunk_run_records_family_tagged_overlapped_dispatches():
    """decode_pipeline=4 · decode_loop=4: dispatch and reap events tagged
    with the ``loop`` family, some issued at ring depth > 0, rendered as X
    slices; the engine's latency model saw the family."""
    eng = InferenceEngine(TINY, device="cpu", decode_chunk=4, decode_pipeline=4, decode_loop=4)
    try:
        eng.generate([5, 6, 7], max_new_tokens=32, sampler=GREEDY)
        RECORDER.reset()
        assert len(eng.generate([5, 6, 7], max_new_tokens=32, sampler=GREEDY).token_ids) == 32
        mine = [e for e in RECORDER.snapshot() if e.get("engine") == eng._tag]
        reaps = [e for e in mine if e["kind"] == "reap"]
        assert reaps and all(e["family"] == "loop" for e in reaps), mine
        assert all(e["t_ready"] >= e["t_issue"] for e in reaps)
        assert {e["seq"] for e in reaps} <= {e["seq"] for e in mine if e["kind"] == "dispatch"}
        assert any(e["depth"] > 0 for e in reaps) or eng.n_overlapped > 0
        assert any(e["kind"] == "admit" for e in mine)
        assert any(e.get("ph") == "X" and e["name"] == "loop"
                   for e in RECORDER.to_trace_events())
        assert eng.latency.ewma("loop") > 0.0
    finally:
        eng.shutdown()


def test_every_dispatched_family_appears_in_device_seconds():
    eng = InferenceEngine(TINY, device="cpu", decode_chunk=4, decode_pipeline=2, spec_decode=4)
    try:
        bias = torch.zeros(TINY.vocab_size)
        bias[7] = 1e9  # a periodic stream: prompt lookup drafts
        req = eng.submit([7, 7, 7, 7], max_new_tokens=16, sampler=GREEDY, logit_bias=bias)
        assert len(list(eng.stream_results(req))) == 16
        assert eng.n_spec_turns > 0
        dispatched = {program_family(k) for k in eng.dispatched_keys}
        assert "verify" in dispatched
        observed = {dict(k).get("family") for k in obs.DISPATCH_DEVICE_SECONDS.snapshot()}
        assert dispatched <= observed and "single_shot" in observed
        assert set(eng.latency.families()) >= dispatched | {"single_shot"}
    finally:
        eng.shutdown()


def test_recorder_on_vs_off_streams_identical():
    def run(enabled):
        old = RECORDER.enabled
        RECORDER.enabled = enabled
        try:
            eng = InferenceEngine(TINY, device="cpu", decode_chunk=4, decode_pipeline=4,
                                  decode_loop=4, seed=11)
            try:
                greedy = eng.generate([3, 4, 5], max_new_tokens=24, sampler=GREEDY).token_ids
                sampled = eng.generate([3, 4, 5], max_new_tokens=24,
                                       sampler=SamplerConfig(temperature=0.9),
                                       seed=7).token_ids
            finally:
                eng.shutdown()
            return greedy, sampled, RECORDER.total()
        finally:
            RECORDER.enabled = old

    RECORDER.reset()
    on = run(True)
    RECORDER.reset()
    off = run(False)
    assert on[:2] == off[:2]
    assert on[2] > 0 and off[2] == 0


# ---- the routes, against the JAX package's app -------------------------------


def _configs(seed: int):
    port = {"settings": {"timeout": 60}, "primary_backends": [
        {"name": "T", "url": f"cuda://llama-tiny?device=cpu&seed={seed}&slots=2", "model": "t"}]}
    ref = {"settings": {"timeout": 60}, "primary_backends": [
        {"name": "T", "url": f"tpu://llama-tiny?seed={seed}&slots=2", "model": "t"}]}
    return create_app(Config(raw=port)), jax_create_app(JaxConfig(raw=ref))


async def test_timeline_and_telemetry_routes_equal_jax():
    app, japp = _configs(3)
    body = {"model": "t", "max_tokens": 4, "messages": [{"role": "user", "content": "hi"}]}
    async with _client(app) as client, _client(japp) as jclient:
        got = {}
        for name, c in (("port", client), ("jax", jclient)):
            assert (await c.post("/chat/completions", json=body, headers=AUTH)).status_code == 200
            tl = (await c.get("/debug/engine/timeline")).json()
            perf = (await c.get("/v1/debug/engine/timeline?format=perfetto")).json()
            bad = await c.get("/debug/engine/timeline?format=nope")
            tel = (await c.get("/debug/telemetry")).json()
            got[name] = (tl, perf, bad, tel)
    (tl, perf, bad, tel), (jtl, jperf, jbad, jtel) = got["port"], got["jax"]
    assert set(tl) == set(jtl) and tl["clock"] == "perf_counter"
    assert any(e["kind"] == "reap" and e["engine"].startswith("engine-") for e in tl["events"])
    assert tl["device_time"]["T"]["single_shot"]["count"] >= 1
    assert "plain" in tl["device_time"]["T"]
    assert set(tl["slo"]) == set(jtl["slo"]) == {"interactive", "batch"}
    assert set(perf) == set(jperf) and any(e.get("ph") == "X" for e in perf["traceEvents"])
    assert bad.status_code == jbad.status_code == 400
    assert bad.json()["error"]["type"] == jbad.json()["error"]["type"]
    assert set(tel) == set(jtel)
    assert tel["breaker"] == jtel["breaker"] == {"T": "closed"}
    assert tel["sched"] == {} and tel["status"] == jtel["status"] == "healthy"
    assert tel["queue_depth"] == jtel["queue_depth"] == 0
    assert set(tel["latency"]["T"]) >= {"single_shot", "plain"}


@pytest.mark.parametrize("query", ["seconds=oops", "seconds=0", "seconds=61", "seconds=-1"])
async def test_profile_route_rejects_bad_seconds_like_jax(query):
    app, japp = _configs(4)
    async with _client(app) as client, _client(japp) as jclient:
        r = await client.post(f"/debug/profile?{query}")
        jr = await jclient.post(f"/debug/profile?{query}")
    assert r.status_code == jr.status_code == 400
    assert r.json() == jr.json()


async def test_profile_route_single_flight_409_like_jax():
    app, japp = _configs(5)
    async with _client(app) as client, _client(japp) as jclient:
        skipped0, jskipped0 = obs.PROFILE_SKIPPED.value, jax_obs.PROFILE_SKIPPED.value
        assert obs._profile_lock.acquire(blocking=False)
        assert jax_obs._profile_lock.acquire(blocking=False)
        try:
            busy = await client.post("/debug/profile?seconds=0.01")
            jbusy = await jclient.post("/debug/profile?seconds=0.01")
        finally:
            obs._profile_lock.release()
            jax_obs._profile_lock.release()
    assert busy.status_code == jbusy.status_code == 409
    assert busy.json() == jbusy.json()
    assert busy.headers["retry-after"] == jbusy.headers["retry-after"] == "5"
    assert obs.PROFILE_SKIPPED.value == skipped0 + 1
    assert jax_obs.PROFILE_SKIPPED.value == jskipped0 + 1


async def test_profile_route_writes_a_chrome_trace(tmp_path, monkeypatch):
    monkeypatch.setenv("QUORUM_TPU_PROFILE_DIR", str(tmp_path))
    app, _ = _configs(6)
    async with _client(app) as client:
        r = await client.post("/debug/profile?seconds=0.05")
    assert r.status_code == 200 and set(r.json()) == {"profile_dir", "seconds"}
    trace = json.loads(open(os.path.join(r.json()["profile_dir"], "trace.json")).read())
    assert "traceEvents" in trace


def test_maybe_profile_traces_a_request_and_skips_visibly(monkeypatch, tmp_path):
    monkeypatch.setenv("QUORUM_TPU_PROFILE_DIR", str(tmp_path))
    with obs.maybe_profile("req-traced"):
        torch.ones(4) @ torch.ones(4)
    assert os.path.exists(tmp_path / "req-traced" / "trace.json")
    RECORDER.reset()
    skipped0 = obs.PROFILE_SKIPPED.value
    assert obs._profile_lock.acquire(blocking=False)
    try:
        with obs.maybe_profile("req-skip-test"):
            pass
    finally:
        obs._profile_lock.release()
    assert obs.PROFILE_SKIPPED.value == skipped0 + 1
    assert any(e["kind"] == "profile-skipped" and e.get("rid") == "req-skip-test"
               for e in RECORDER.snapshot())


async def test_health_slo_block_and_served_request_scored():
    app, _ = _configs(7)
    async with _client(app) as client:
        assert set((await client.get("/health")).json()["slo"]) == {"interactive", "batch"}
        good0 = obs.SLO_GOOD.value_of(**{"class": "interactive", "stage": "deadline"})
        r = await client.post("/chat/completions", headers=AUTH, json={
            "model": "t", "max_tokens": 4, "timeout": 20,
            "messages": [{"role": "user", "content": "hi"}]})
        assert r.status_code == 200
    assert obs.SLO_GOOD.value_of(**{"class": "interactive", "stage": "deadline"}) == good0 + 1


async def test_burning_class_degrades_health_and_sheds_ready(monkeypatch):
    app, _ = _configs(8)
    monkeypatch.setenv("QUORUM_TPU_SLO_READY_BURN", "0.5")
    tracker = slo.SloTracker()
    monkeypatch.setattr(slo, "SLO", tracker)
    for _ in range(4):
        tracker.record("interactive", "ttft", False)
    async with _client(app) as client:
        assert (await client.get("/health")).json()["status"] == "degraded"
        r = await client.get("/ready")
        assert r.status_code == 503 and r.json()["reason"] == "degraded"


def test_chunked_admission_records_segment_register_and_deadline_events():
    """One request id joins a chunked admission's segment, register,
    dispatch and reap events; a deadline miss records its stage."""
    eng = InferenceEngine(TINY, device="cpu", decode_chunk=4, prefill_chunk=16, n_slots=1)
    try:
        RECORDER.reset()
        req = eng.submit(list(range(3, 40)), max_new_tokens=4, sampler=GREEDY)
        assert len(list(eng.stream_results(req))) == 4
        mine = [e for e in RECORDER.snapshot() if e.get("engine") == eng._tag]
        kinds = [e["kind"] for e in mine if e.get("rid") == req.rid or req.rid in e.get("rids", ())]
        assert kinds[:1] == ["admit"] and kinds.count("segment") == 3
        assert kinds.index("register") > kinds.index("segment") and "reap" in kinds
        faults.arm("engine.decode", times=100000, delay=0.02)  # a slow device
        blocker = eng.submit([1, 2, 3], max_new_tokens=64, sampler=GREEDY)
        late = eng.submit([5, 6], max_new_tokens=4, sampler=GREEDY,
                          deadline=time.monotonic() + 0.1)
        with pytest.raises(DeadlineExceeded):
            list(eng.stream_results(late))
        blocker.cancel.set()
        assert any(e["kind"] == "deadline" and e["rid"] == late.rid and e["stage"] == "queue"
                   for e in RECORDER.snapshot())
    finally:
        faults.disarm()
        eng.shutdown()
