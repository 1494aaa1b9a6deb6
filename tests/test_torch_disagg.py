"""Disaggregated prefill/decode serving (``prefill_mesh=``,
``cuda://…&disagg=P+D``) on the CPU (plain versions; both groups' devices
are the CPU), after the JAX package's ``tests/test_disagg.py``:

- ``parse_disagg``, ``group_mesh_configs`` and ``disagg_meshes`` refuse in
  the JAX package's words, and so do the engine's checks and the URL
  option (``tpu://``'s words); what the port does not serve yet beside
  ``disagg=`` (``sp=`` in the prefill group, ``pp=`` in the decode
  group) is refused by name; the handoff's route follows the groups'
  layout (``direct``, ``reshard``, ``host-bounce`` over gloo);
- ``disagg=1+1`` greedy tokens, short and multi-segment, equal the JAX
  1+1 disaggregated engine's and the JAX colocated engine's token for
  token (llama-tiny, ``n_kv_heads=4``, float32); sampled streams equal the
  port's colocated engine's; every admission is staged and handed off,
  the handoff bytes are the prompts' K/V bytes, its route is ``direct``;
- an armed ``engine.kv_handoff`` dooms only its own request: the
  bystander's stream is the fault-free one, nothing is rebuilt and both
  loops stay alive;
- the colocated engine keeps one loop, no prefill-group state and its
  program families;
- members, constrained decoding, prompt-lookup speculation, a host
  prefix-store restore, paged KV and ``kv_quant``/``quant`` int8 compose
  with one-rank groups, each equal to the colocated port engine;
- ``disagg=2+2`` with tp=2 in each group and ``disagg=1+2`` (gloo CPU
  ranks) stream what the colocated tp=2 engine streams, greedy and
  sampled;
- ``cuda://…&disagg=1+1`` serves through the app: ``/metrics`` carries
  the disagg and handoff families, ``/health`` both loops and groups.
"""

import asyncio

import httpx
import jax
import numpy as np
import pytest
import torch

from quorum_tpu import faults as jax_faults
from quorum_tpu.backends.tpu_backend import TpuBackend
from quorum_tpu.config import BackendSpec as JaxBackendSpec
from quorum_tpu.engine.engine import InferenceEngine as JaxEngine
from quorum_tpu.models.model_config import resolve_spec as jax_resolve_spec
from quorum_tpu.ops.sampling import SamplerConfig as JaxSampler
from quorum_tpu.parallel import mesh as jmesh
from quorum_tpu_torch import faults
from quorum_tpu_torch.backends.cuda_backend import CudaBackend
from quorum_tpu_torch.config import BackendSpec, Config
from quorum_tpu_torch.engine.engine import InferenceEngine, program_family, release_engine
from quorum_tpu_torch.models.convert import params_from_numpy
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.ops.sampling import SamplerConfig
from quorum_tpu_torch.parallel import mesh as pmesh
from quorum_tpu_torch.server.app import create_app

OPTS = {"n_kv_heads": "4", "dtype": "float32"}
SPEC = resolve_spec("llama-tiny", OPTS)
SAMPLED = SamplerConfig(temperature=0.8, top_p=0.9)
GREEDY = SamplerConfig(temperature=0.0)
KW = dict(decode_chunk=4, n_slots=2, decode_pipeline=2, prefill_chunk=16)
LONG = [(3 + 5 * i) % 500 for i in range(40)]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _groups():
    return pmesh.disagg_meshes(1, 1, ["cpu", "cpu"])


def _gen(eng, prompt, seed=0, n=8, sampler=SAMPLED, **kw):
    return eng.generate(prompt, max_new_tokens=n, sampler=sampler, seed=seed, **kw).token_ids


def _kv_bytes(n_tokens: int) -> int:
    return 2 * SPEC.n_layers * SPEC.n_kv_heads * n_tokens * SPEC.head_dim * 4


@pytest.fixture(scope="module")
def engines():
    """The JAX colocated and 1+1 disaggregated engines (seed 9300, the JAX
    test's), and the port's colocated and 1+1 engines on their weights."""
    jspec = jax_resolve_spec("llama-tiny", OPTS)
    jpm, jdm = jmesh.disagg_meshes(1, 1)
    jc = JaxEngine(jspec, seed=9300, **KW)
    jd = JaxEngine(jspec, jdm, prefill_mesh=jpm, seed=9300, **KW)
    params = jax.tree.map(np.asarray, jc.params)
    pm, _ = _groups()
    tc = InferenceEngine(SPEC, device="cpu", params=params_from_numpy(params, device="cpu"), **KW)
    td = InferenceEngine(SPEC, device="cpu", params=params_from_numpy(params, device="cpu"),
                         prefill_mesh=pm, **KW)
    yield jc, jd, tc, td
    for e in (jc, jd, tc, td):
        e.shutdown()


# ---- the mesh helpers, the engine's checks and the URL option ----------------


@pytest.mark.parametrize("raw", ["4+4", "1+7", "2 2", "", "4", "4x4", "0+4", "4+0", "-1+2",
                                 "a+b"])
def test_parse_disagg_reads_as_jax(raw):
    try:
        want = jmesh.parse_disagg(raw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            pmesh.parse_disagg(raw)
        assert str(got.value) == str(e)
    else:
        assert pmesh.parse_disagg(raw) == want


@pytest.mark.parametrize("args,kw", [
    ((2, 2), dict(tp=2)), ((4, 4), {}), ((4, 2), dict(sp=2)), ((2, 4), dict(pp=2)),
    ((1, 1), dict(tp=2)), ((3, 2), dict(sp=2)), ((2, 3), dict(pp=2)), ((2, 4), dict(pp=2, tp=2)),
    ((1, 1), dict(sp=0)), ((2, 2), dict(tp=0)),
], ids=lambda v: str(v))
def test_group_mesh_configs_read_as_jax(args, kw):
    try:
        want = jmesh.group_mesh_configs(*args, **kw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            pmesh.group_mesh_configs(*args, **kw)
        assert str(got.value) == str(e)
    else:
        got = pmesh.group_mesh_configs(*args, **kw)
        assert [(c.dp, c.pp, c.sp, c.tp) for c in got] == [(c.dp, c.pp, c.sp, c.tp)
                                                            for c in want]


def test_disagg_meshes_split_the_devices_in_order():
    pm, dm = pmesh.disagg_meshes(1, 2, ["cpu"] * 4)
    assert pm.size == 1 and dm.size == 2 and dm.cfg.tp == 2
    with pytest.raises(ValueError) as got:
        pmesh.disagg_meshes(9, 9, ["cpu"] * 8)
    with pytest.raises(ValueError) as want:
        jmesh.disagg_meshes(9, 9)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [dict(prefill_chunk=0), dict(zero_drain=True),
                                dict(draft_spec="draft")], ids=["chunking", "zero_drain", "draft"])
def test_engine_checks_read_as_jax(kw):
    jspec = jax_resolve_spec("llama-tiny", OPTS)
    jpm, jdm = jmesh.disagg_meshes(1, 1)
    jkw = dict(kw)
    if "draft_spec" in kw:
        jkw["draft_spec"], jkw["spec_decode"] = jspec, 4
        kw = dict(draft_spec=SPEC, spec_decode=4)
    with pytest.raises(ValueError) as want:
        JaxEngine(jspec, jdm, prefill_mesh=jpm, **jkw)
    with pytest.raises(ValueError) as got:
        InferenceEngine(SPEC, device="cpu", prefill_mesh=_groups()[0], **kw)
    assert str(got.value) == str(want.value)


def _build(url: str):
    return CudaBackend.from_spec(BackendSpec(name="t", url=url, model="m"))


@pytest.mark.parametrize("tail", ["disagg=4x4", "disagg=1+1&tp=2", "disagg=1+1&dp=2",
                                  "disagg=1+1&prefill_chunk=0", "disagg=1+1&zero_drain=1",
                                  "disagg=1+1&spec_model=llama-tiny"])
def test_url_refusals_read_as_tpu(tail):
    with pytest.raises(ValueError) as want:
        TpuBackend.from_spec(JaxBackendSpec(name="t", url=f"tpu://llama-tiny?{tail}", model="m"))
    with pytest.raises(ValueError) as got:
        _build(f"cuda://llama-tiny?device=cpu&{tail}")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("tail", ["disagg=2+2&sp=2&tp=1", "disagg=1+2&pp=2"])
def test_not_yet_served_beside_disagg_is_refused_by_name(tail):
    with pytest.raises(ValueError, match="does not serve the disagg= option yet"):
        _build(f"cuda://llama-tiny?device=cpu&{tail}")


def test_handoff_route_follows_the_layout():
    """One-rank groups copy ``direct``; groups of several ranks over NCCL
    are ``direct`` where both cut the kv heads alike and ``reshard`` where
    not (disagg=1+2); over gloo (the CPU, ranks sharing a card) the pieces
    go through the host: ``host-bounce``."""
    from quorum_tpu_torch.cache.kv_transfer import handoff_route

    def card_mesh(tp, first):
        return pmesh.Mesh(pmesh.MeshConfig(tp=tp),
                          tuple(torch.device("cuda", first + i) for i in range(tp)), "nccl")

    assert handoff_route(card_mesh(1, 0), None) == "direct"
    assert handoff_route(card_mesh(2, 0), card_mesh(2, 2)) == "direct"
    assert handoff_route(card_mesh(1, 0), card_mesh(2, 1)) == "reshard"
    assert handoff_route(card_mesh(2, 0), None) == "reshard"
    pm, dm = pmesh.disagg_meshes(1, 2, ["cpu"] * 3)
    assert handoff_route(pm, dm) == "host-bounce"


# ---- one-rank groups against the JAX engines -------------------------------------


def test_greedy_equals_jax_disagg_and_colocated(engines):
    jc, jd, tc, td = engines
    for prompt in ([3, 4, 5], LONG):
        want = jd.generate(prompt, max_new_tokens=8, sampler=JaxSampler(temperature=0.0),
                           seed=0).token_ids
        assert want == jc.generate(prompt, max_new_tokens=8,
                                   sampler=JaxSampler(temperature=0.0), seed=0).token_ids
        assert _gen(td, prompt, sampler=GREEDY) == want
        assert _gen(tc, prompt, sampler=GREEDY) == want


def test_sampled_equals_colocated_with_live_handoffs(engines):
    _, _, tc, td = engines
    n0, b0 = td.n_kv_handoffs, td.kv_handoff_bytes
    legs = [([7, 8, 9], 11), (LONG, 3), ([5, 6, 7, 8] * 9, 4)]
    for prompt, seed in legs:
        assert _gen(td, prompt, seed=seed) == _gen(tc, prompt, seed=seed)
    # every prompt staged and handed off, segment by segment: its K/V bytes
    assert td.kv_handoff_bytes - b0 == sum(_kv_bytes(len(p)) for p, _ in legs)
    assert td.n_kv_handoffs - n0 == sum(-(-len(p) // 16) for p, _ in legs)
    assert td.kv_handoff_s > 0.0 and td.n_admission_dispatches == 0
    m, h = td.metrics(), td.health()
    assert m["disagg"] == 1 and m["prefill_group_devices"] == m["decode_group_devices"] == 1
    assert m["kv_handoffs_total"] == td.n_kv_handoffs
    assert h["scheduler_alive"] and h["prefill_scheduler_alive"]
    assert h["disagg"]["route"] == "direct"


def test_concurrent_streams_equal_colocated(engines):
    _, _, tc, td = engines

    def run(eng):
        with eng._cond:
            reqs = [eng.submit(p, max_new_tokens=12, sampler=SAMPLED, seed=i)
                    for i, p in enumerate(([3, 4, 5], LONG, [9, 8, 7, 6] * 6))]
        return [list(eng.stream_results(r)) for r in reqs]

    assert run(td) == run(tc)


def test_kv_handoff_fault_dooms_only_its_request(engines):
    _, _, tc, td = engines
    base = _gen(td, [3, 4, 5], seed=1)
    assert base == _gen(tc, [3, 4, 5], seed=1)
    rebuilds = td.n_rebuilds
    faults.arm("engine.kv_handoff", times=1)
    try:
        bad = td.submit([5, 6, 7], max_new_tokens=8, sampler=SAMPLED, seed=2)
        bystander = td.submit([3, 4, 5], max_new_tokens=8, sampler=SAMPLED, seed=1)
        with pytest.raises(faults.FaultInjected):
            list(td.stream_results(bad))
        assert list(td.stream_results(bystander)) == base
    finally:
        faults.disarm()
    assert _gen(td, [3, 4, 5], seed=1) == base
    assert td.n_rebuilds == rebuilds
    assert td.health()["prefill_scheduler_alive"]
    assert "engine.kv_handoff" in jax_faults.SITES


def test_colocated_engine_keeps_one_loop_and_its_families(engines):
    _, _, tc, td = engines
    _gen(tc, [3, 4, 5], seed=1)
    assert not tc.disagg and tc._prefill_thread is None and tc._prefill_params is None
    assert tc.n_kv_handoffs == 0 and tc.kv_handoff_bytes == 0
    assert tc.metrics()["disagg"] == 0 and tc.health()["disagg"] is None
    assert {program_family(k) for k in tc.dispatched_keys} == {"plain"}
    # the decode group runs the colocated engine's programs, under its keys
    assert {program_family(k) for k in td.dispatched_keys} == {"plain"}
    assert td.dispatched_keys <= tc.dispatched_keys | td.dispatched_keys
    assert all(len(k) == len(next(iter(tc.dispatched_keys))) for k in td.dispatched_keys)


# ---- groups of several ranks ------------------------------------------------------


@pytest.fixture(scope="module")
def colocated_tp2():
    """The colocated tp=2 engine's streams (seed 9300, two gloo CPU ranks)
    on three prompts, greedy and sampled, all admitted chunked."""
    eng = InferenceEngine(SPEC, mesh=pmesh.make_mesh(pmesh.MeshConfig(tp=2), ["cpu"] * 2),
                          seed=9300, **KW)
    try:
        yield [_gen(eng, p, seed=1, sampler=s) for p, s in _TP_LEGS]
    finally:
        eng.shutdown()


_TP_LEGS = [([3, 4, 5] * 7, GREEDY), (LONG, GREEDY), (LONG, SAMPLED), ([9, 8, 7, 6] * 6, SAMPLED)]


@pytest.mark.parametrize("groups", [(2, 2), (1, 2)], ids=["2+2_tp2", "1+2"])
def test_tp_groups_equal_the_colocated_tp2_engine(colocated_tp2, groups):
    """disagg=2+2 (tp=2 in each group) and disagg=1+2 (the prefill group
    whole, the decode group tp=2): the pieces gathered over the prefill
    group's tp, moved, broadcast over the decode group's and each rank's
    heads written; streams equal to the colocated tp=2 engine's, the
    handoff bytes the prompts' K/V bytes, every worker alive."""
    n_p, n_d = groups
    pm, dm = pmesh.disagg_meshes(n_p, n_d, ["cpu"] * (n_p + n_d))
    eng = InferenceEngine(SPEC, mesh=dm, prefill_mesh=pm, seed=9300, **KW)
    try:
        assert [_gen(eng, p, seed=1, sampler=s) for p, s in _TP_LEGS] == colocated_tp2
        assert eng.kv_handoff_bytes == sum(_kv_bytes(len(p)) for p, _ in _TP_LEGS)
        h = eng.health()
        assert h["disagg"]["route"] == "host-bounce" and h["disagg"]["prefill_workers_alive"]
        assert h["mesh"]["workers_alive"] and h["prefill_scheduler_alive"]
        if n_p > 1:
            assert eng.prefill_rank_reports()[0]["cache_bytes"] > 0
    finally:
        eng.shutdown()


# ---- what composes with one-rank groups ------------------------------------------


def _twins(**kw):
    spec = resolve_spec("llama-tiny", OPTS)
    return (InferenceEngine(spec, device="cpu", seed=22, **kw),
            InferenceEngine(spec, device="cpu", seed=22, prefill_mesh=_groups()[0], **kw))


@pytest.mark.parametrize("knobs", [
    dict(members=2), dict(kv_pages=True, kv_page_size=16), dict(kv_quant="int8"),
    dict(quant="int8"), dict(spec_decode=4)], ids=["members", "paged", "kv_int8", "int8",
                                                   "prompt_lookup"])
def test_compositions_equal_colocated(knobs):
    eng_c, eng_d = _twins(**KW, **knobs)
    try:
        def run(eng):
            with eng._cond:
                reqs = [eng.submit(p, max_new_tokens=10, sampler=SAMPLED, seed=9, member=m)
                        for m in range(eng.members) for p in ([7, 7, 7, 7], LONG)]
            return [list(eng.stream_results(r)) for r in reqs]

        assert run(eng_d) == run(eng_c)
        assert eng_d.n_kv_handoffs > 0
        if knobs.get("kv_pages"):
            m = eng_d.metrics()
            assert m["kv_pages_allocated"] + m["kv_pages_free"] == eng_d.kv_pool_pages
    finally:
        eng_c.shutdown()
        eng_d.shutdown()


def test_prefix_restore_into_the_prefill_groups_staging():
    eng_c, eng_d = _twins(decode_chunk=4, n_slots=1, prefill_chunk=16, prefix_store="host",
                          prefix_store_chunk=16)
    try:
        conv = [(3 + 5 * i) % 500 for i in range(33)]
        other = [(9 + 7 * i) % 500 for i in range(33)]
        out1 = _gen(eng_d, conv, seed=4, n=6)
        eng_d.drain_prefix_store()
        _gen(eng_d, other, seed=5, n=6)
        eng_d.drain_prefix_store()
        follow = conv + out1 + [17, 19]
        assert _gen(eng_d, follow, seed=6, n=6) == _gen(eng_c, follow, seed=6, n=6)
        assert eng_d.prefix_store_hits >= 1
    finally:
        eng_c.shutdown()
        eng_d.shutdown()


def test_constrained_through_the_backend_equals_colocated():
    opts = "dtype=float32&seed=11330&prefill_chunk=16&decode_chunk=4&slots=2"
    b_d = _build(f"cuda://llama-tiny?device=cpu&{opts}&disagg=1+1")
    b_c = _build(f"cuda://llama-tiny?device=cpu&{opts}")
    body = {"model": "m", "max_tokens": 24, "temperature": 0.0, "seed": 3,
            "messages": [{"role": "user", "content": "json please"}],
            "response_format": {"type": "json_object"}}

    async def run(b):
        res = await b.complete(dict(body), {}, timeout=300)
        return res.body["choices"][0]["message"]["content"]

    try:
        assert asyncio.run(run(b_d)) == asyncio.run(run(b_c))
        assert b_d.engine.disagg and b_d.engine.n_constrained >= 1
    finally:
        release_engine(b_d.engine)
        release_engine(b_c.engine)


# ---- through the app ---------------------------------------------------------------


def test_disagg_url_serves_through_the_app():
    url = "cuda://llama-tiny?device=cpu&dtype=float32&seed=3&disagg=1+1&prefill_chunk=16&slots=2"
    raw = {"settings": {"timeout": 60},
           "primary_backends": [{"name": "LLM1", "url": url, "model": "m"}]}
    app = create_app(Config(raw=raw))

    async def go():
        async with httpx.AsyncClient(transport=httpx.ASGITransport(app=app),
                                     base_url="http://t") as c:
            auth = {"Authorization": "Bearer x"}
            r = await c.post("/v1/chat/completions", headers=auth, json={
                "model": "m", "max_tokens": 6, "messages": [{"role": "user", "content": "hi"}]})
            return r, await c.get("/metrics"), await c.get("/health")

    r, metrics, health = asyncio.run(go())
    try:
        assert r.status_code == 200, r.text
        text = metrics.text
        for family in ("quorum_tpu_engine_disagg", "quorum_tpu_engine_prefill_group_devices",
                       "quorum_tpu_engine_decode_group_devices",
                       "quorum_tpu_engine_prefill_group_active",
                       "quorum_tpu_engine_decode_group_active",
                       "quorum_tpu_engine_kv_handoffs_total",
                       "quorum_tpu_engine_kv_handoff_bytes_total",
                       "quorum_tpu_engine_kv_handoff_seconds_total",
                       "quorum_tpu_kv_handoff_bytes_total", "quorum_tpu_kv_handoff_seconds",
                       "quorum_tpu_prefill_group_active", "quorum_tpu_decode_group_active"):
            assert f"# TYPE {family} " in text, family
        assert 'quorum_tpu_engine_disagg{backend="LLM1"} 1' in text
        assert 'quorum_tpu_kv_handoff_bytes_total{route="direct"}' in text
        rows = health.json()["checks"]
        assert rows[0]["prefill_scheduler_alive"] and rows[0]["scheduler_alive"]
        assert rows[0]["disagg"]["prefill_devices"] == ["cpu"]
    finally:
        from quorum_tpu_torch.engine.engine import shutdown_all_engines

        shutdown_all_engines()
