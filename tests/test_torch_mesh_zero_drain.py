"""Zero-drain staging (``zero_drain=1``) on multi-rank engines (rank 0 here,
the other ranks spawned, gloo groups), llama-tiny in float32:

- on tp=2 and dp=2 × tp=2 (ring depth 2, four-step chunks: a stream
  spans many scheduler turns) the greedy streams equal the drain-based
  mesh engine's and the JAX mesh zero-drain engine's on the same weights;
  concurrent streams (greedy and sampled) equal the drain-based mesh
  engine's, and a staged admission registered
  beside a live stream counts in ``admission_overlap_total``; every rank
  holds a dense staging cache of its rows at its kv heads, and every
  admission is staged (no single-shot dispatch);
- a failed segment dooms only its own request, on every rank: the
  bystander's stream is unchanged and the next request is served;
- a cancel between a segment and its injection drops the staged pieces on
  every rank, and the row serves its next tenant;
- composed with ``kv_pages`` and the host prefix store on dp=2 × tp=2: a
  churned conversation restores into the staging row, its pieces inject
  through the pages, and its follow-up equals the cold prefill; no page
  leaks.

Every comparison is exact: tokens in float32 on the CPU.
"""

import time

import jax
import numpy as np
import pytest
import torch

from quorum_tpu.engine.engine import InferenceEngine as JaxEngine
from quorum_tpu.models.init import init_params as jax_init_params
from quorum_tpu.models.model_config import resolve_spec as jax_resolve_spec
from quorum_tpu.ops.sampling import SamplerConfig as JaxSampler
from quorum_tpu.parallel import MeshConfig as JaxMeshConfig
from quorum_tpu.parallel import make_mesh as jax_make_mesh
from quorum_tpu_torch import faults
from quorum_tpu_torch.engine.engine import InferenceEngine
from quorum_tpu_torch.models.convert import params_from_numpy
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.ops.sampling import SamplerConfig
from quorum_tpu_torch.parallel import MeshConfig, make_mesh

OPTS = {"dtype": "float32"}
SPEC = resolve_spec("llama-tiny", OPTS)
GREEDY = SamplerConfig(temperature=0.0)
SAMPLED = SamplerConfig(temperature=0.8, top_p=0.9)
RING = dict(decode_chunk=4, n_slots=2, decode_pipeline=2, prefill_chunk=16)
LONG = [(3 + 5 * i) % 500 for i in range(40)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def weights():
    jspec = jax_resolve_spec("llama-tiny", OPTS)
    return jspec, jax.tree.map(np.asarray, jax_init_params(jspec, seed=11300))


def _mesh(**axes):
    cfg = MeshConfig(**axes)
    return make_mesh(cfg, ["cpu"] * cfg.n_devices, timeout_s=30.0)


def _port(weights, axes, **knobs):
    return InferenceEngine(SPEC, mesh=_mesh(**axes), params=params_from_numpy(weights[1], "cpu"),
                           **knobs)


def _gen(eng, prompt, n=12, sampler=GREEDY, seed=0):
    return eng.generate(prompt, max_new_tokens=n, sampler=sampler, seed=seed).token_ids


def _streams(eng, prompts, n=12, sampler=GREEDY):
    """Submit every prompt at once (admitted in one turn), then read all."""
    with eng._cond:
        reqs = [eng.submit(p, max_new_tokens=n, sampler=sampler, seed=i)
                for i, p in enumerate(prompts)]
    return [list(eng.stream_results(r)) for r in reqs]


def _quiet(eng):
    """Wait until the engine holds no request (a finished stream's row is
    released just after its end reaches the caller)."""
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        m = eng.metrics()
        if not (m["busy_slots"] or m["admitting"] or m["pending"] or m["inflight_chunks"]):
            return
        time.sleep(0.01)
    raise AssertionError("the engine never went idle")


@pytest.fixture(scope="module")
def tp2(weights):
    """A drain-based and a zero-drain tp=2 engine."""
    eng_c = _port(weights, dict(tp=2), **RING)
    eng_z = _port(weights, dict(tp=2), zero_drain=True, **RING)
    yield eng_c, eng_z
    eng_c.shutdown()
    eng_z.shutdown()


@pytest.mark.parametrize("axes", [dict(tp=2), dict(dp=2, tp=2)], ids=["tp2", "dp2tp2"])
def test_streams_equal_drain_based_and_jax_mesh(weights, axes):
    jspec, jparams = weights
    prompts = [[3, 4, 5], LONG]
    ref = JaxEngine(jspec, jax_make_mesh(JaxMeshConfig(**axes),
                                         jax.devices()[:2 * axes.get("dp", 1)]),
                    params=jparams, zero_drain=True, **RING)
    try:
        want = [ref.generate(p, max_new_tokens=12, sampler=JaxSampler(temperature=0.0)).token_ids
                for p in prompts]
    finally:
        ref.shutdown()
    eng_c = _port(weights, axes, **RING)
    eng_z = _port(weights, axes, zero_drain=True, **RING)
    try:
        got = [_gen(eng_z, p) for p in prompts]
        assert got == want == [_gen(eng_c, p) for p in prompts]
        over0 = eng_z.n_admission_overlap
        both = [[9, 8, 7], LONG]
        assert _streams(eng_z, both, n=40) == _streams(eng_c, both, n=40)
        assert _streams(eng_z, both, n=20, sampler=SAMPLED) == _streams(eng_c, both, n=20,
                                                                         sampler=SAMPLED)
        m = eng_z.metrics()
        assert m["admission_overlap_total"] > over0 and m["zero_drain"] == 1
        assert eng_z.n_admission_dispatches == 0 and eng_z.admission_stall_s == 0.0
        rows = 2 // axes.get("dp", 1)
        staging = 2 * SPEC.n_layers * rows * 1 * SPEC.max_seq * SPEC.head_dim * 4
        for rep in eng_z.rank_reports():
            assert rep["staging_bytes"] == staging and rep["staged_pieces"] == 0
    finally:
        eng_c.shutdown()
        eng_z.shutdown()


def test_segment_fault_dooms_only_its_request(tp2):
    eng_c, eng_z = tp2
    base = _gen(eng_z, [3, 4, 5], n=8, sampler=SAMPLED, seed=1)
    assert base == _gen(eng_c, [3, 4, 5], n=8, sampler=SAMPLED, seed=1)
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
    assert _gen(eng_z, LONG, n=8) == _gen(eng_c, LONG, n=8)
    assert eng_z.n_rebuilds == rebuilds0 and eng_z.n_failures == failures0 + 1
    assert eng_z.health()["mesh"]["workers_alive"]
    assert all(rep["staged_pieces"] == 0 for rep in eng_z.rank_reports())


def test_cancel_between_segment_and_injection_drops_pieces(tp2):
    """The cancel sweep lands while the victim's first piece waits for its
    injection (on the card, behind its segment's event): the piece is
    dropped on every rank, and the row serves the next request."""
    eng_c, eng_z = tp2
    victim = {}
    drain = eng_z._drain_handoffs

    def cancel_then_drain():
        for kind, adm, *_ in list(eng_z._handoffs):
            if kind == "kv" and adm.req is victim.get("req") and not adm.dead:
                adm.req.cancel.set()
                eng_z.n_cancelled += 1
                adm.req.out.put(("end", None))
                eng_z._release_admission(adm)
        drain()

    eng_z._drain_handoffs = cancel_then_drain
    try:
        with eng_z._cond:
            victim["req"] = eng_z.submit(LONG, max_new_tokens=8, sampler=GREEDY)
        assert list(eng_z.stream_results(victim["req"])) == []
    finally:
        del eng_z._drain_handoffs
    assert all(rep["staged_pieces"] == 0 for rep in eng_z.rank_reports())
    assert _streams(eng_z, [LONG, [9, 8, 7]], n=10) == _streams(eng_c, [LONG, [9, 8, 7]], n=10)


def test_composed_with_kv_pages_and_restore_on_dp2_tp2(weights):
    kw = dict(decode_chunk=4, n_slots=2, prefill_chunk=16)
    eng = _port(weights, dict(dp=2, tp=2), zero_drain=True, kv_pages=True, prefix_store="host",
                prefix_store_chunk=16, **kw)
    dense = _port(weights, dict(dp=2, tp=2), **kw)
    try:
        first = [(11 + 3 * i) % 500 for i in range(60)]
        conv = [(3 + 5 * i) % 500 for i in range(33)]
        other = [(9 + 7 * i) % 500 for i in range(33)]
        outs = []
        for p in (first, conv, other):
            outs.append(_gen(eng, p, n=6))
            eng.drain_prefix_store()
        assert outs == [_gen(dense, p, n=6) for p in (first, conv, other)]
        follow = conv + outs[1] + [17, 19]
        assert _gen(eng, follow, n=6) == _gen(dense, follow, n=6)
        m = eng.metrics()
        assert m["prefix_store_hits_total"] >= 1 and m["admission_overlap_total"] >= 0
        _quiet(eng)
        a = eng._page_alloc
        assert not a.chains and a.allocated_pages + a.free_pages == eng.kv_pool_pages
        assert all(rep["staged_pieces"] == 0 for rep in eng.rank_reports())
    finally:
        eng.shutdown()
        dense.shutdown()
