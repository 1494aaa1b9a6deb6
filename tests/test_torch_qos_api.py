"""The QoS knobs and the shed point through the port's app, against the
JAX app (``cuda://`` engines on the CPU: plain versions).

- ``priority`` and ``tenant``: the same 400 bodies for malformed values,
  and the same knobs (and resolved dispatch class) reaching
  ``engine.submit`` for well-formed ones.
- The 503s of the shed point: a full admission queue and a request span
  past the page pool answer byte for byte as the ``tpu://`` backend's,
  ``Retry-After`` included (the cost model's text and hint).
- ``/debug/telemetry``'s ``sched`` block, key for key; ``/health`` reads
  ``prefill_scheduler_alive`` as the JAX app does; the ``/metrics`` TYPE
  lines of the families this slice serves are the JAX app's.

llama-tiny, float32 on the port's side."""

import asyncio
import re
import threading

import httpx
import pytest
import torch

from quorum_tpu.backends.tpu_backend import TpuBackend
from quorum_tpu.config import BackendSpec as JaxBackendSpec
from quorum_tpu.config import Config as JaxConfig
from quorum_tpu.engine.engine import shutdown_all_engines as jax_shutdown_all
from quorum_tpu.ops.sampling import SamplerConfig as JaxSampler
from quorum_tpu.server.app import create_app as jax_create_app
from quorum_tpu_torch.backends.cuda_backend import CudaBackend
from quorum_tpu_torch.config import BackendSpec, Config
from quorum_tpu_torch.engine.engine import shutdown_all_engines
from quorum_tpu_torch.ops.sampling import SamplerConfig
from quorum_tpu_torch.server.app import create_app

AUTH = {"Authorization": "Bearer x"}
CHAT = {"model": "m", "messages": [{"role": "user", "content": "hi"}], "max_tokens": 1,
        "temperature": 0}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module", autouse=True)
def _release_engines():
    yield
    shutdown_all_engines()
    jax_shutdown_all()


def _apps(opts: str, seed: int):
    """(port app, JAX app, port engine, JAX engine): one backend ``L`` each,
    on ``opts``."""
    raw = {"settings": {"timeout": 60},
           "primary_backends": [{"name": "L", "url": "x://llama-tiny", "model": "m"}]}
    b = CudaBackend.from_spec(BackendSpec(
        name="L", url=f"cuda://llama-tiny?device=cpu&dtype=float32&seed={seed}&{opts}",
        model="m"))
    jb = TpuBackend.from_spec(JaxBackendSpec(name="L", url=f"tpu://llama-tiny?seed={seed}&{opts}",
                                             model="m"))
    return (create_app(Config(raw=raw), L=b), jax_create_app(JaxConfig(raw=raw), L=jb),
            b.engine, jb.engine)


async def _post(app, body, path="/v1/chat/completions"):
    async with httpx.AsyncClient(transport=httpx.ASGITransport(app=app),
                                 base_url="http://t") as c:
        return await asyncio.wait_for(c.post(path, json=body, headers=AUTH), 60)


async def _get(app, path):
    async with httpx.AsyncClient(transport=httpx.ASGITransport(app=app),
                                 base_url="http://t") as c:
        return await asyncio.wait_for(c.get(path, headers=AUTH), 60)


@pytest.fixture(scope="module")
def qos_apps():
    return _apps("qos=1&slots=1&queue=1", 16001)


@pytest.mark.parametrize("field,value", [
    ("priority", "urgent"), ("priority", 3), ("priority", True), ("priority", ""),
    ("tenant", ""), ("tenant", "x" * 65), ("tenant", 7), ("tenant", ["t"])])
async def test_malformed_priority_and_tenant_are_the_same_400(qos_apps, field, value):
    app, japp, _, _ = qos_apps
    got, want = await _post(app, {**CHAT, field: value}), await _post(japp, {**CHAT, field: value})
    assert got.status_code == want.status_code == 400
    assert got.json() == want.json()
    assert field in got.json()["error"]["message"]


def _spy_submits(engine, sink: list):
    orig = engine.submit

    def submit(*a, **k):
        req = orig(*a, **k)
        sink.append((k.get("priority"), k.get("tenant"), getattr(req, "sched_class", None)))
        return req

    engine.submit = submit
    return orig


@pytest.mark.parametrize("extra,want", [
    ({"priority": "background", "tenant": "acme"}, ("background", "acme", "background")),
    ({"priority": "interactive"}, ("interactive", None, "interactive")),
    ({"tenant": "t1"}, (None, "t1", "batch")),
    ({"timeout": 5}, (None, None, "interactive")),
], ids=["background-tenant", "interactive", "tenant-only", "derived-from-deadline"])
async def test_priority_and_tenant_reach_the_engine_like_jax(qos_apps, extra, want):
    app, japp, eng, jeng = qos_apps
    seen: dict = {}
    for name, a, e in (("port", app, eng), ("jax", japp, jeng)):
        sink: list = []
        orig = _spy_submits(e, sink)
        try:
            r = await _post(a, {**CHAT, **extra})
        finally:
            e.submit = orig
        assert r.status_code == 200, r.text
        seen[name] = sink
    assert seen["port"] == seen["jax"] == [want]


async def test_debug_telemetry_sched_block_matches_jax(qos_apps):
    app, japp, _, _ = qos_apps
    tel, jtel = (await _get(app, "/debug/telemetry")).json(), \
        (await _get(japp, "/debug/telemetry")).json()
    assert set(tel["sched"]) == set(jtel["sched"]) == {"L"}
    entry, jentry = tel["sched"]["L"], jtel["sched"]["L"]
    assert set(entry) == set(jentry)
    assert entry["qos"] is jentry["qos"] is True
    assert entry["queue_depths"] == jentry["queue_depths"] == {
        "interactive": 0, "batch": 0, "background": 0}
    assert entry["predictive_sheds"] == jentry["predictive_sheds"] == 0


async def test_queue_full_503_is_byte_equal_to_tpu(qos_apps):
    """``queue=1``: with the scheduler held, one queued request fills the
    queue and the next chat is the cost model's 503 on both backends."""
    app, japp, eng, jeng = qos_apps
    answers = []
    for a, eng, sampler in ((app, eng, SamplerConfig(temperature=0.0)),
                            (japp, jeng, JaxSampler(temperature=0.0))):
        cancel = threading.Event()
        with eng._cond:
            held = eng.submit([5, 6, 7], max_new_tokens=2, sampler=sampler, cancel=cancel)
            r = await _post(a, CHAT)
            cancel.set()
        list(eng.stream_results(held))
        answers.append(r)
    got, want = answers
    assert got.status_code == want.status_code == 503
    assert got.content == want.content
    assert got.headers["retry-after"] == want.headers["retry-after"] == "1"
    assert "engine admission queue full (1 waiting)" in got.json()["error"]["message"]


async def test_pool_span_503_is_byte_equal_to_tpu():
    app, japp, _, _ = _apps("kv_pages=1&kv_page_size=16&kv_pool_pages=2&slots=1", 16002)
    body = {**CHAT, "max_tokens": 100}
    got, want = await _post(app, body), await _post(japp, body)
    assert got.status_code == want.status_code == 503
    assert got.content == want.content
    assert got.headers["retry-after"] == want.headers["retry-after"] == "1"
    assert "exceeds the kv page pool (2 pages)" in got.json()["error"]["message"]


async def test_health_reads_prefill_scheduler_alive_like_jax(qos_apps):
    app, japp, eng, jeng = qos_apps
    ok, jok = (await _get(app, "/health")).json(), (await _get(japp, "/health")).json()
    assert ok["status"] == jok["status"] == "healthy"
    assert eng.health()["prefill_scheduler_alive"] is jeng.health()["prefill_scheduler_alive"]
    statuses = []
    for a, eng in ((app, eng), (japp, jeng)):
        health = eng.health
        eng.health = lambda h=health: {**h(), "prefill_scheduler_alive": False}
        try:
            r = await _get(a, "/health")
        finally:
            eng.health = health
        statuses.append((r.status_code, r.json()["status"]))
    assert statuses[0] == statuses[1] == (503, "unhealthy")


def _types(text: str) -> dict[str, str]:
    return dict(re.findall(r"^# TYPE (\S+) (\S+)$", text, re.M))


async def test_metrics_type_lines_of_the_served_families(qos_apps):
    app, japp, _, _ = qos_apps
    types = _types((await _get(app, "/metrics")).text)
    jtypes = _types((await _get(japp, "/metrics")).text)
    served = {f"quorum_tpu_engine_{k}" for k in (
        "qos", "preemptions_total", "preempted_tokens_total", "predictive_sheds_total",
        "zero_drain", "admission_overlap_total")} | {
        f"quorum_tpu_{k}" for k in (
            "sched_queue_depth", "preemptions_total", "preempted_tokens_total",
            "admission_overlap_total")}
    assert {k: types.get(k) for k in served} == {k: jtypes.get(k) for k in served}
    assert types["quorum_tpu_engine_qos"] == types["quorum_tpu_engine_zero_drain"] == "gauge"
    assert types["quorum_tpu_sched_queue_depth"] == "gauge"
    assert types["quorum_tpu_preemptions_total"] == "counter"
