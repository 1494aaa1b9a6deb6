"""The port's ``/metrics`` against the JAX package's: the two
``MetricsRegistry`` copies expose the same Prometheus text for the same
observations and the two validators agree; the port's app over a
``cuda://`` engine exposes the JAX app's ``# TYPE`` lines apart from the
families named below (the port's own engine counters, and the JAX
package's families of paths the port does not have yet); the latency
histograms count the requests served; and engines on the same weights count
the same after the same requests. CPU, llama-tiny, float32."""

import re

import httpx
import jax
import numpy as np
import pytest
import torch

from quorum_tpu import observability as jax_obs
from quorum_tpu.backends.tpu_backend import TpuBackend
from quorum_tpu.config import Config as JaxConfig
from quorum_tpu.engine.engine import InferenceEngine as JaxEngine
from quorum_tpu.models.init import init_params as jax_init_params
from quorum_tpu.models.model_config import resolve_spec as jax_resolve_spec
from quorum_tpu.server.app import create_app as jax_create_app
from quorum_tpu.telemetry import metrics as jax_metrics
from quorum_tpu_torch import observability as obs
from quorum_tpu_torch.backends.cuda_backend import CudaBackend
from quorum_tpu_torch.config import Config
from quorum_tpu_torch.engine.engine import InferenceEngine
from quorum_tpu_torch.models.convert import params_from_numpy
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.server.app import create_app
from quorum_tpu_torch.telemetry import metrics

AUTH = {"Authorization": "Bearer x"}
OPTS = {"dtype": "float32"}

# Engine counters the port has and the JAX engine does not: the graph
# counters (captures, replays, pool bytes, warm-up steps) and the counters
# earlier slices of the port added.
PORT_ONLY = {f"quorum_tpu_engine_{k}" for k in (
    "decode_graph_captures_total", "decode_graph_capture_seconds_total",
    "decode_graph_replays_total", "decode_graph_pool_bytes", "decode_graph_warmup_steps_total",
    "admission_dispatches_total", "admissions_total", "deadline_clamps_total",
    "decode_steps_total", "member_tokens_total", "prefill_chunk", "prefill_segments_total",
    "prefix_store_restore_bytes_total", "prefix_store_restore_seconds_total",
    "prefix_store_snapshot_bytes_total", "quorum_dedup_prefills_total",
    "quorum_dedup_tokens_total", "spec_draft_steps_total")}
# The JAX package's families of paths the port does not serve yet: the
# compile budget's recompile counter (XLA's; the port compiles no programs,
# its graph captures are counted by its own families). Disaggregated
# serving's and pipeline-staged decode's families are served.
DEFERRED = {"quorum_tpu_recompiles_total"}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def pair():
    jspec = jax_resolve_spec("llama-tiny", OPTS)
    jparams = jax.tree.map(np.asarray, jax_init_params(jspec, seed=9107))
    jeng = JaxEngine(jspec, params=jparams, n_slots=2)
    teng = InferenceEngine(resolve_spec("llama-tiny", OPTS), device="cpu", n_slots=2,
                           params=params_from_numpy(jparams, device="cpu"))
    yield jeng, teng
    jeng.shutdown()
    teng.shutdown()


def _apps(pair):
    jeng, teng = pair
    raw = {"settings": {"timeout": 60}, "primary_backends": [
        {"name": "LLM1", "url": "x://llama-tiny", "model": "llama-tiny"}]}
    return (create_app(Config(raw=raw), LLM1=CudaBackend("LLM1", teng, model_id="llama-tiny")),
            jax_create_app(JaxConfig(raw=raw), LLM1=TpuBackend("LLM1", jeng)))


def _client(app):
    return httpx.AsyncClient(transport=httpx.ASGITransport(app=app), base_url="http://t")


def _types(text: str) -> dict[str, str]:
    return dict(re.findall(r"^# TYPE (\S+) (\S+)$", text, re.M))


# ---- the registries and the validator, against the JAX package's -----------


def _feed(mod):
    reg = mod.MetricsRegistry()
    h = reg.histogram("demo_seconds", "a demo")
    hb = reg.histogram("demo_steps", "steps", buckets=(1, 2, 4, 8))
    c = reg.counter("demo_total", "a counter")
    g = reg.gauge("demo_depth", "a gauge")
    reg.counter("demo_untouched_total", "never incremented")
    for i, v in enumerate((0.0004, 0.003, 0.3, 7.0, 500.0, 0.05)):
        h.observe(v, status="2xx" if i % 2 else "5xx")
        h.observe(v * 2)
        hb.observe(i)
    c.inc(3, stage="queue")
    c.inc(2.5, backend='we"ird\\name\nx')
    c.inc()
    g.set(4, stage="1")
    g.set(-2.5)
    return "\n".join(reg.expose()) + "\n", h.snapshot(), c.value, c.value_of(stage="queue")


def test_registry_exposition_equals_jax():
    got = _feed(metrics)
    assert got == _feed(jax_metrics)
    assert metrics.validate_exposition(got[0]) == []


VALIDATOR_CASES = [
    "# TYPE a histogram\na_bucket{le=\"0.1\"} 1\na_bucket{le=\"+Inf\"} 2\na_sum 1\na_count 2\n",
    "# TYPE t counter\nt seven\nt{unclosed=\"x\" 1\n# TYPE t counter\n",
    "# TYPE h histogram\nh_bucket{le=\"0.1\"} 5\nh_bucket{le=\"1.0\"} 3\n"
    "h_bucket{le=\"+Inf\"} 6\nh_sum 1\nh_count 7\n# TYPE g histogram\ng_bucket{le=\"0.5\"} 2\n"
    "g_sum 0.5\ng_count 2\n",
    "x 1\n# TYPE x gauge\n# TYPE y wibble\ny{a=\"1\",b=\"q,r\"} 2\n",
    "# TYPE h histogram\nh_bucket 1\nh_count 1\n",
]


@pytest.mark.parametrize("text", VALIDATOR_CASES)
def test_validator_equals_jax(text):
    assert metrics.validate_exposition(text) == jax_metrics.validate_exposition(text)


def test_registered_families_are_jax_families_less_the_deferred():
    port = _types("\n".join(obs.METRICS.expose()))
    ref = _types("\n".join(jax_obs.METRICS.expose()))
    assert set(port) == set(ref) - DEFERRED
    assert all(port[k] == ref[k] for k in port)


# ---- /metrics over a cuda:// engine, against the JAX app's -------------------


async def test_metrics_type_lines_equal_jax_but_the_named(pair):
    app, japp = _apps(pair)
    async with _client(app) as c, _client(japp) as jc:
        text, jtext = (await c.get("/metrics")).text, (await jc.get("/metrics")).text
    types, jtypes = _types(text), _types(jtext)
    assert set(types) - set(jtypes) == PORT_ONLY
    assert set(jtypes) - set(types) == DEFERRED & set(jtypes)
    assert {k: v for k, v in types.items() if k in jtypes} == {
        k: v for k, v in jtypes.items() if k in types}
    assert metrics.validate_exposition(text) == []
    assert 'quorum_tpu_engine_slots{backend="LLM1"} 2' in text
    assert 'quorum_tpu_engine_members{backend="LLM1"} 1' in text
    assert "# TYPE quorum_tpu_engine_decode_graph_pool_bytes gauge" in text


def _count(text: str, family: str, labels: str = "") -> float:
    m = re.search(rf"^{family}_count{labels} (\S+)$", text, re.M)
    return float(m.group(1)) if m else 0.0


async def test_histogram_counts_follow_the_requests(pair):
    app, _ = _apps(pair)
    body = {"model": "llama-tiny", "max_tokens": 5, "temperature": 0,
            "messages": [{"role": "user", "content": "hi"}]}
    async with _client(app) as client:
        before = (await client.get("/metrics")).text
        for stream in (False, True, True):
            resp = await client.post("/v1/chat/completions", json={**body, "stream": stream},
                                     headers=AUTH)
            assert resp.status_code == 200
        after = (await client.get("/v1/metrics")).text
    assert metrics.validate_exposition(after) == []
    ok = '{status="2xx"}'
    assert _count(after, "quorum_tpu_request_duration_seconds", ok) == _count(
        before, "quorum_tpu_request_duration_seconds", ok) + 3
    for fam, n in (("quorum_tpu_queue_wait_seconds", 3), ("quorum_tpu_prefill_seconds", 3),
                   ("quorum_tpu_ttft_seconds", 2)):
        assert _count(after, fam) == _count(before, fam) + n, fam
    assert _count(after, "quorum_tpu_decode_chunk_seconds") > _count(
        before, "quorum_tpu_decode_chunk_seconds")
    assert 'quorum_tpu_engine_busy_slots{backend="LLM1"} 0' in after
    assert re.search(r'^quorum_tpu_dispatch_device_seconds_count\{family="plain"\} \S+$',
                     after, re.M)


COUNTERS = ("requests_total", "tokens_total", "failures_total", "cancellations_total",
            "rebuilds_total", "deadline_exceeded_total", "prefix_hits_total",
            "prefix_tokens_saved_total", "spec_turns_total", "busy_slots", "pending",
            "breaker_state", "slots", "members", "queue_limit", "admitting")


def test_engine_counters_equal_jax_after_the_same_requests(pair):
    jeng, teng = pair
    from quorum_tpu.ops.sampling import SamplerConfig as JaxSampler
    from quorum_tpu_torch.ops.sampling import SamplerConfig

    j0, t0 = jeng.metrics(), teng.metrics()
    for prompt, n in (([5, 6, 7], 6), ([9, 9, 1, 2], 3), ([5, 6, 7], 8)):
        want = jeng.generate(prompt, max_new_tokens=n, sampler=JaxSampler(temperature=0.0))
        got = teng.generate(prompt, max_new_tokens=n, sampler=SamplerConfig(temperature=0.0))
        assert got.token_ids == want.token_ids
    j1, t1 = jeng.metrics(), teng.metrics()
    for k in COUNTERS:
        assert t1[k] - t0[k] == j1[k] - j0[k], k
    assert t1["requests_total"] - t0["requests_total"] == 3
