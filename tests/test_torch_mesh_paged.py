"""Paged KV (``kv_pages=1``) on multi-rank engines (rank 0 here, the other
ranks spawned, gloo groups), llama-tiny in float32:

- on tp=2 and dp=2 × tp=2 the greedy streams equal the JAX mesh paged
  engine's on the same weights (the JAX package's engine on the CPU's fake
  devices), through a tier-0 hit that aliases whole pages (tp=2) and one
  that ends mid-page and copies the boundary page (dp=2 × tp=2, 32-token
  pages): the alias, COW, allocated and free counters equal JAX's;
- sampled streams equal the port's one-rank paged engine's (the port draws
  its own sampling noise);
- eight concurrent streams against an eight-page pool on four slots queue
  for pages and drain, each equal to its one-rank twin's; no page leaks (at
  rest every allocated page belongs to a retained chain) and each rank's
  pool holds the bytes of its cut: every page, its own kv heads;
- where the JAX engine refuses paging, the store or zero-drain on a mesh
  (pp, sp), the port refuses them in its words;
- ``cuda://…?dp=2&tp=2&kv_pages=1&prefix_store=host&zero_drain=1`` builds
  through ``get_engine`` and serves the dense drain-based mesh's stream.

Every comparison is exact: tokens in float32 on the CPU.
"""

import threading
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
from quorum_tpu_torch.engine.engine import InferenceEngine
from quorum_tpu_torch.models.convert import params_from_numpy
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.ops.sampling import SamplerConfig
from quorum_tpu_torch.parallel import MeshConfig, make_mesh

OPTS = {"dtype": "float32"}
SPEC = resolve_spec("llama-tiny", OPTS)
GREEDY = SamplerConfig(temperature=0.0)
SAMPLED = SamplerConfig(temperature=0.9, top_p=0.9)
COUNTERS = ("kv_page_alias_hits_total", "kv_page_cow_copies_total", "kv_pages_allocated",
            "kv_pages_free", "prefix_hits_total")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def weights():
    jspec = jax_resolve_spec("llama-tiny", OPTS)
    return jspec, jax.tree.map(np.asarray, jax_init_params(jspec, seed=0))


def _mesh(**axes):
    cfg = MeshConfig(**axes)
    return make_mesh(cfg, ["cpu"] * cfg.n_devices, timeout_s=30.0)


def _jax_mesh(**axes):
    cfg = JaxMeshConfig(**axes)
    return jax_make_mesh(cfg, jax.devices()[:cfg.n_devices])


def _gen(eng, prompt, n=6, sampler=GREEDY, seed=0):
    return eng.generate(prompt, max_new_tokens=n, sampler=sampler, seed=seed).token_ids


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


def _no_leak(eng):
    """At rest: no live chain, and every allocated page is held by a
    retained chain (the slot groups' reuse donors)."""
    _quiet(eng)
    a = eng._page_alloc
    held = {p for chain in a.retained.values() for p in chain}
    assert not a.chains and a.allocated_pages == len(held)
    assert a.allocated_pages + a.free_pages == eng.kv_pool_pages


@pytest.mark.parametrize("axes,case", [(dict(tp=2), "aligned"), (dict(dp=2, tp=2), "mid_page")],
                         ids=["tp2-aligned", "dp2tp2-mid_page"])
def test_paged_mesh_equals_jax_mesh_paged(weights, axes, case):
    jspec, jparams = weights
    kw = dict(n_slots=2, prefill_chunk=16, decode_chunk=4, kv_pages=True)
    if case == "aligned":
        turns = [list(range(3, 51)), list(range(3, 51)) + [77], [5, 6, 7]]
    else:
        kw["kv_page_size"] = 32
        pre = list(range(3, 23))
        turns = [pre, pre[:17] + [88, 89, 90], pre + [99]]
    ref = JaxEngine(jspec, _jax_mesh(**axes), params=jparams, **kw)
    try:
        want = [ref.generate(p, max_new_tokens=6, sampler=JaxSampler(temperature=0.0)).token_ids
                for p in turns]
        mj = ref.metrics()
    finally:
        ref.shutdown()
    eng = InferenceEngine(SPEC, mesh=_mesh(**axes), params=params_from_numpy(jparams, "cpu"),
                          **kw)
    try:
        assert [_gen(eng, p) for p in turns] == want
        mp = eng.metrics()
        assert {k: mp[k] for k in COUNTERS} == {k: mj[k] for k in COUNTERS}
        if case == "aligned":
            assert mp["kv_page_alias_hits_total"] >= 1 and mp["kv_page_cow_copies_total"] == 0
        else:  # turns 2 and 3 each reuse 16 tokens of a 32-token page
            assert mp["kv_page_cow_copies_total"] == 2
        _no_leak(eng)
    finally:
        eng.shutdown()


def test_sampled_streams_equal_one_rank_paged(weights):
    params = params_from_numpy(weights[1], "cpu")
    kw = dict(n_slots=2, prefill_chunk=16, decode_chunk=4, kv_pages=True)
    one = InferenceEngine(SPEC, device="cpu", params=params, **kw)
    eng = InferenceEngine(SPEC, mesh=_mesh(tp=2), params=params, **kw)
    try:
        prompts = [[9, 8, 7], list(range(3, 41)), list(range(3, 41)) + [60, 61]]
        got = [_gen(eng, p, 10, SAMPLED, seed=i) for i, p in enumerate(prompts)]
        assert got == [_gen(one, p, 10, SAMPLED, seed=i) for i, p in enumerate(prompts)]
        assert eng.metrics()["kv_page_alias_hits_total"] == one.metrics()[
            "kv_page_alias_hits_total"] >= 1
        _no_leak(eng)
    finally:
        one.shutdown()
        eng.shutdown()


def test_transient_exhaustion_queues_and_drains_on_dp2_tp2(weights):
    params = params_from_numpy(weights[1], "cpu")
    kw = dict(n_slots=4, prefill_chunk=16, decode_chunk=4, kv_pages=True, kv_pool_pages=8)
    one = InferenceEngine(SPEC, device="cpu", params=params, **kw)
    eng = InferenceEngine(SPEC, mesh=_mesh(dp=2, tp=2), params=params, **kw)
    try:
        outs = {id(one): {}, id(eng): {}}

        def run(e, i):
            p = [3 + i, 4 + i, 5 + i] + list(range(6, 6 + 2 * i))
            outs[id(e)][i] = _gen(e, p, 10, SAMPLED, seed=i)

        ths = [threading.Thread(target=run, args=(e, i)) for e in (eng, one) for i in range(8)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=120)
        assert len(outs[id(eng)]) == 8 and outs[id(eng)] == outs[id(one)]
        assert eng.metrics()["kv_pages_allocated"] <= 8
        _no_leak(eng)
        # Each rank's cut: both sides' pools of every page (8 data pages,
        # the sink and the trash page) at its one kv head, and the table of
        # its dp group's 2 rows.
        s = SPEC
        pool = 2 * s.n_layers * (8 + 2) * 1 * 16 * s.head_dim * 4
        table = 2 * (s.max_seq // 16) * 4
        for rep in eng.rank_reports():
            assert rep["pool_bytes"] == rep["cache_bytes"] == pool + table
            assert rep["staging_bytes"] == 0
    finally:
        one.shutdown()
        eng.shutdown()


@pytest.mark.parametrize("axes,knobs", [
    (dict(pp=2), dict(kv_pages=True)), (dict(sp=2), dict(kv_pages=True)),
    (dict(sp=2), dict(prefix_store="host")), (dict(pp=2), dict(zero_drain=True)),
    (dict(sp=2), dict(zero_drain=True))],
    ids=["kv_pages-pp2", "kv_pages-sp2", "prefix_store-sp2", "zero_drain-pp2", "zero_drain-sp2"])
def test_mesh_refusals_in_jax_words(weights, axes, knobs):
    """Where the JAX engine refuses the three knobs on a mesh, the port
    refuses them in its words (the JAX engine turns chunked prefill off on
    sp before its zero-drain check)."""
    with pytest.raises(ValueError) as want:
        JaxEngine(weights[0], _jax_mesh(**axes), **knobs)
    with pytest.raises(ValueError) as got:
        InferenceEngine(SPEC, mesh=_mesh(**axes), **knobs)
    assert str(got.value) == str(want.value)


def test_mesh_url_serves_the_three_knobs():
    """``cuda://…?dp=2&tp=2&kv_pages=1&prefix_store=host&zero_drain=1``
    through ``get_engine`` serves a chat's stream equal to the dense
    drain-based mesh engine's."""
    from quorum_tpu_torch.backends.cuda_backend import CudaBackend
    from quorum_tpu_torch.config import BackendSpec
    from quorum_tpu_torch.engine.engine import release_engine

    opts = "device=cpu&dtype=float32&seed=3&slots=2&prefill_chunk=16&dp=2&tp=2"
    built = [CudaBackend.from_spec(BackendSpec(name="t", url=f"cuda://llama-tiny?{u}", model="m"))
             for u in (f"{opts}&kv_pages=1&prefix_store=host&zero_drain=1", opts)]
    try:
        eng, dense = (b.engine for b in built)
        assert eng.kv_pages and eng.prefix_store is not None and eng.zero_drain
        assert eng.mesh.shape["dp"] == 2 and eng.mesh.shape["tp"] == 2
        prompt = list(range(3, 41))
        assert _gen(eng, prompt, 8) == _gen(dense, prompt, 8)
    finally:
        for b in built:
            release_engine(b.engine)
