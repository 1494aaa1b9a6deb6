"""The host prefix store and paged KV on disaggregated engines whose groups
are cut by tp (``disagg=2+2&tp=2``: each group's rank 0 here, its other
rank spawned, gloo groups), llama-tiny with 4 kv heads in float32:

- ``prefix_store=host`` (the JAX package's
  ``test_disagg_tp_prefix_restore_pin`` set-up, greedy): snapshots are
  taken from the decode group (gathered over its tp), the churned
  conversation's follow-up restores into the prefill group's staging rows
  (broadcast over its tp), rides the tail prefill and the handoff, and
  equals the JAX disaggregated engine's stream on the same weights and
  the colocated tp=2 engine's cold prefill;
- ``kv_pages=1`` on the decode group (through the ``cuda://`` URL): every
  injected piece is written through each decode rank's pages; greedy and
  sampled streams equal the colocated tp=2 engine's, and no page leaks.

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
from quorum_tpu.parallel.mesh import disagg_meshes as jax_disagg_meshes
from quorum_tpu_torch.backends.cuda_backend import CudaBackend
from quorum_tpu_torch.config import BackendSpec
from quorum_tpu_torch.engine.engine import InferenceEngine, release_engine
from quorum_tpu_torch.models.convert import params_from_numpy
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.ops.sampling import SamplerConfig
from quorum_tpu_torch.parallel import MeshConfig, make_mesh
from quorum_tpu_torch.parallel import mesh as pmesh

OPTS = {"dtype": "float32", "n_kv_heads": "4"}
GREEDY = SamplerConfig(temperature=0.0)
SAMPLED = SamplerConfig(temperature=0.8, top_p=0.9)
STORE = dict(decode_chunk=4, n_slots=1, prefill_chunk=16, prefix_store="host",
             prefix_store_chunk=16)
CONV = [(3 + 5 * i) % 500 for i in range(33)]
OTHER = [(9 + 7 * i) % 500 for i in range(33)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _gen(eng, prompt, n=6, sampler=GREEDY, seed=0):
    if isinstance(eng, JaxEngine):
        sampler = JaxSampler(temperature=0.0)
    return eng.generate(prompt, max_new_tokens=n, sampler=sampler, seed=seed).token_ids


def _churn(eng):
    out = _gen(eng, CONV)
    eng.drain_prefix_store()
    _gen(eng, OTHER)  # churn the single slot
    eng.drain_prefix_store()
    follow = CONV + out + [17, 19]
    return follow, _gen(eng, follow)


def test_disagg_tp_prefix_restore_equals_jax_and_colocated():
    jspec = jax_resolve_spec("llama-tiny", OPTS)
    jparams = jax.tree.map(np.asarray, jax_init_params(jspec, seed=9360))
    pm, dm = jax_disagg_meshes(2, 2, jax.devices()[:4], tp=2)
    ref = JaxEngine(jspec, dm, prefill_mesh=pm, params=jparams, **STORE)
    try:
        follow, want = _churn(ref)
        assert ref.prefix_store_hits >= 1
    finally:
        ref.shutdown()
    spec = resolve_spec("llama-tiny", OPTS)
    params = params_from_numpy(jparams, "cpu")
    ppm, pdm = pmesh.disagg_meshes(2, 2, ["cpu"] * 4)
    eng = InferenceEngine(spec, mesh=pdm, prefill_mesh=ppm, params=params, **STORE)
    colo = InferenceEngine(spec, mesh=make_mesh(MeshConfig(tp=2), ["cpu"] * 2, timeout_s=30.0),
                           params=params, decode_chunk=4, n_slots=1, prefill_chunk=16)
    try:
        got_follow, got = _churn(eng)
        assert got_follow == follow and got == want
        assert got == _gen(colo, follow)
        assert eng.prefix_store_hits >= 1 and eng.prefix_store_tokens_restored > 0
        assert eng.n_kv_handoffs > 0
        assert eng.metrics()["prefix_store_snapshot_bytes_total"] > 0
    finally:
        eng.shutdown()
        colo.shutdown()


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


def _build(url: str):
    return CudaBackend.from_spec(BackendSpec(name="t", url=url, model="m"))


def test_disagg_tp_kv_pages_on_the_decode_group_equals_colocated():
    opts = ("device=cpu&dtype=float32&n_kv_heads=4&seed=9361&decode_chunk=4&slots=2"
            "&prefill_chunk=16&decode_pipeline=4&decode_loop=4")
    b_d = _build(f"cuda://llama-tiny?{opts}&disagg=2+2&tp=2&kv_pages=1")
    b_c = _build(f"cuda://llama-tiny?{opts}&tp=2")
    try:
        eng, colo = b_d.engine, b_c.engine
        assert eng.kv_pages and eng.disagg and eng._ranks is not None
        prompts = [[3, 4, 5], [(5 + 3 * i) % 500 for i in range(40)]]
        for sampler in (GREEDY, SAMPLED):
            for p in prompts:
                assert _gen(eng, p, 10, sampler, 9) == _gen(colo, p, 10, sampler, 9)
        _quiet(eng)
        a = eng._page_alloc
        assert not a.chains and a.allocated_pages + a.free_pages == eng.kv_pool_pages
        assert eng.n_kv_handoffs > 0
        assert all(rep["pool_bytes"] > 0 for rep in eng.rank_reports())
    finally:
        release_engine(b_d.engine)
        release_engine(b_c.engine)
