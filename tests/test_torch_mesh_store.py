"""The host prefix store (``prefix_store=host``) on multi-rank engines (rank
0 here, the other ranks spawned, gloo groups), llama-tiny in float32:

- a churn restore (the JAX package's ``test_disagg_prefix_restore_pin``
  traffic, colocated): a conversation's slot is taken by another, and its
  follow-up restores the stored prefix and prefills only the tail. On tp=2
  and on dp=2 × tp=2, where the conversation's row lies in dp group 1 (the
  snapshot is gathered there and sent over dp to rank 0; the restore goes
  back the same way), every greedy stream equals the JAX mesh store
  engine's and the follow-up equals its cold prefill; the store's
  counters equal the port's one-rank store engine's on the same traffic;
- the store stays whole-head on rank 0, in the one-card engine's wire
  format: a blob exported by a tp=2 engine imports into a one-rank engine
  and restores there, and the other way round, each giving the cold
  stream; both blobs parse with the port's ``prefix_wire``.

Every comparison is exact: tokens in float32 on the CPU.
"""

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
from quorum_tpu_torch.cache import prefix_wire
from quorum_tpu_torch.engine.engine import InferenceEngine
from quorum_tpu_torch.models.convert import params_from_numpy
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.ops.sampling import SamplerConfig
from quorum_tpu_torch.parallel import MeshConfig, make_mesh

OPTS = {"dtype": "float32"}
SPEC = resolve_spec("llama-tiny", OPTS)
GREEDY = SamplerConfig(temperature=0.0)
KW = dict(decode_chunk=4, n_slots=2, prefill_chunk=16, prefix_store="host",
          prefix_store_chunk=16)
FIRST = [(11 + 3 * i) % 500 for i in range(60)]  # holds slot 0 (dp group 0)
CONV = [(3 + 5 * i) % 500 for i in range(33)]
OTHER = [(9 + 7 * i) % 500 for i in range(33)]
STORE = ("prefix_store_hits_total", "prefix_store_restored_tokens_total",
         "prefix_store_restore_bytes_total", "prefix_store_snapshot_bytes_total",
         "prefix_store_entries", "prefix_store_bytes", "prefix_store_snapshots_dropped_total")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def weights():
    jspec = jax_resolve_spec("llama-tiny", OPTS)
    return jspec, jax.tree.map(np.asarray, jax_init_params(jspec, seed=9360))


def _mesh(**axes):
    cfg = MeshConfig(**axes)
    return make_mesh(cfg, ["cpu"] * cfg.n_devices, timeout_s=30.0)


def _gen(eng, prompt, n=6):
    sampler = JaxSampler(temperature=0.0) if isinstance(eng, JaxEngine) else GREEDY
    return eng.generate(prompt, max_new_tokens=n, sampler=sampler).token_ids


def _churn(eng):
    """FIRST fills slot 0; CONV lands in slot 1 (the shorter resident loses
    a tie of no reuse), OTHER takes slot 1 from it; CONV's follow-up then
    restores into slot 1. Returns every stream and the follow-up."""
    out = []
    for p in (FIRST, CONV, OTHER):
        out.append(_gen(eng, p))
        eng.drain_prefix_store()
    follow = CONV + out[1] + [17, 19]
    out.append(_gen(eng, follow))
    return out, follow


@pytest.mark.parametrize("axes", [dict(tp=2), dict(dp=2, tp=2)], ids=["tp2", "dp2tp2"])
def test_churn_restore_equals_jax_and_cold(weights, axes):
    jspec, jparams = weights
    ref = JaxEngine(jspec, jax_make_mesh(JaxMeshConfig(**axes),
                                         jax.devices()[:2 * axes.get("dp", 1)]),
                    params=jparams, **KW)
    try:
        want, follow = _churn(ref)
        assert ref.prefix_store_hits >= 1
    finally:
        ref.shutdown()
    params = params_from_numpy(jparams, "cpu")
    eng = InferenceEngine(SPEC, mesh=_mesh(**axes), params=params, **KW)
    one = InferenceEngine(SPEC, device="cpu", params=params, **KW)
    cold = InferenceEngine(SPEC, device="cpu", params=params, decode_chunk=4, n_slots=1,
                           prefill_chunk=16)
    restored = []
    into = eng._restore_into
    eng._restore_into = lambda req, slot, *a, **k: (restored.append(slot), into(req, slot, *a,
                                                                                 **k))[1]
    try:
        got, _ = _churn(eng)
        assert got == want
        assert got[-1] == _gen(cold, follow)
        assert restored == [1]  # dp group 1's row on dp=2
        m = eng.metrics()
        assert m["prefix_store_hits_total"] >= 1 and m["prefix_store_restored_tokens_total"] > 0
        assert _churn(one)[0] == want
        mo = one.metrics()
        assert {k: m[k] for k in STORE} == {k: mo[k] for k in STORE}
    finally:
        for e in (eng, one, cold):
            e.shutdown()


def test_export_import_both_directions_between_tp2_and_one_rank(weights):
    params = params_from_numpy(weights[1], "cpu")
    tp = InferenceEngine(SPEC, mesh=_mesh(tp=2), params=params, **KW)
    one = InferenceEngine(SPEC, device="cpu", params=params, **KW)
    cold = InferenceEngine(SPEC, device="cpu", params=params, decode_chunk=4, n_slots=1,
                           prefill_chunk=16)
    try:
        for src, dst, conv in ((tp, one, CONV), (one, tp, OTHER)):
            out = _gen(src, conv)
            src.drain_prefix_store()
            blob = src.export_prefix_chunks()
            chunk_tokens, chains = prefix_wire.parse(blob)
            assert chunk_tokens == 16 and chains and chains[0].tokens[:32] == conv[:32]
            got = dst.import_prefix_chunks(blob)
            assert got["chains_imported"] >= 1 and got["tokens_imported"] >= 32
            follow = conv + out + [17, 19]
            hits = dst.prefix_store_hits
            assert _gen(dst, follow) == _gen(cold, follow)
            assert dst.prefix_store_hits == hits + 1
    finally:
        for e in (tp, one, cold):
            e.shutdown()
