"""Paged KV slot memory on the port's engine (``kv_pages=1``): the scenarios
of tests/test_paged_kv.py on ``device="cpu"``.

- Token identity: the paged engine streams exactly what the dense engine
  streams, greedy and sampled, with an EOS cut, a deep ring with
  prompt-lookup speculation (decode_pipeline=4 × decode_loop=4,
  spec_decode=4), a constrained request, members=3, quorum_dedup and
  kv_quant=int8. Paging changes where K/V live, never a token.
- Aliasing: a tier-0 hit installs page references (the alias counter
  ticks, the shared span is held once) and a reuse ending mid-page copies
  exactly the boundary page; both counters, and the greedy streams, equal
  the JAX paged engine's on the same weights and inputs.
- The shed: a span that can never fit the pool is a ``QueueFullError``
  naming the page pool at submit; transient exhaustion queues; a slot's
  own retained donor never wedges its re-admission; rows released while
  dispatches are in flight (ring depth 4, cancellations) never disturb
  the rows that re-claim their pages.
- The refusals say what the JAX engine says.

llama-tiny (max_seq 128), float32, ``prefill_chunk=16`` so short prompts
exercise segments, reuse and pages.
"""

import threading

import jax
import numpy as np
import pytest
import torch

from quorum_tpu.engine.engine import InferenceEngine as JaxEngine
from quorum_tpu.models.init import init_params as jax_init_params
from quorum_tpu.models.model_config import resolve_spec as jax_resolve_spec
from quorum_tpu.ops.sampling import SamplerConfig as JaxSampler
from quorum_tpu_torch.constrain import compile_response_format
from quorum_tpu_torch.engine.engine import InferenceEngine, QueueFullError
from quorum_tpu_torch.engine.tokenizer import ByteTokenizer
from quorum_tpu_torch.models.convert import params_from_numpy
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.ops.sampling import SamplerConfig

OPTS = {"dtype": "float32", "max_seq": "128"}
SPEC = resolve_spec("llama-tiny", OPTS)
GREEDY = SamplerConfig(temperature=0.0)
SAMPLED = SamplerConfig(temperature=0.9, top_p=0.9)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _gen(eng, p, n, sampler=GREEDY, seed=0, member=0):
    return list(eng.generate_stream(p, max_new_tokens=n, sampler=sampler, seed=seed,
                                    member=member))


def _pair(**kw):
    kw = {"prefill_chunk": 16, **kw}
    return (InferenceEngine(SPEC, device="cpu", seed=0, **kw),
            InferenceEngine(SPEC, device="cpu", seed=0, kv_pages=True, **kw))


PROMPTS = ([5, 6, 7, 8, 9], [11, 12, 13], list(range(3, 40)), [7, 8, 9, 10] * 8)


@pytest.mark.parametrize("kw", [
    {"n_slots": 4},
    {"n_slots": 3, "decode_pipeline": 4, "decode_loop": 4, "spec_decode": 4},
    {"n_slots": 2, "kv_quant": "int8"},
], ids=["base", "deep-ring-spec", "int8"])
def test_paged_streams_equal_dense(kw):
    dense, paged = _pair(**kw)
    try:
        for sampler in (GREEDY, SAMPLED):
            for p in PROMPTS:
                assert _gen(dense, p, 16, sampler, seed=7) == _gen(paged, p, 16, sampler, seed=7)
        ref = _gen(dense, [5, 6, 7], 8)
        a = dense.generate([5, 6, 7], max_new_tokens=8, sampler=GREEDY, eos_id=ref[1])
        b = paged.generate([5, 6, 7], max_new_tokens=8, sampler=GREEDY, eos_id=ref[1])
        assert a.token_ids == b.token_ids and b.finish_reason == a.finish_reason == "stop"
        m = paged.metrics()
        assert m["kv_pages"] == 1 and m["kv_page_size"] == 16
        assert m["kv_pages_allocated"] + m["kv_pages_free"] == paged.kv_pool_pages
        assert all(k[0] == "paged" for k in paged.dispatched_keys)
        assert not any(k[0] == "paged" for k in dense.dispatched_keys)
        if kw.get("spec_decode"):
            assert m["spec_turns_total"] >= 1
            assert m["spec_turns_total"] == dense.metrics()["spec_turns_total"]
    finally:
        dense.shutdown()
        paged.shutdown()


def test_paged_constrained_equals_dense():
    tok = ByteTokenizer(SPEC.vocab_size)
    schema = {"type": "object", "properties": {"ok": {"type": "boolean"}}}
    g = compile_response_format({"type": "json_schema", "json_schema": {"schema": schema}},
                                tok, SPEC.vocab_size)
    dense, paged = _pair(n_slots=2)
    try:
        outs = []
        for eng in (dense, paged):
            req = eng.submit(tok.encode("go"), max_new_tokens=48,
                             sampler=SamplerConfig(temperature=0.8), seed=3,
                             eos_id=tok.eos_id, grammar=g)
            outs.append(list(eng.stream_results(req)))
        assert outs[0] == outs[1]
        assert any(k[0] == "paged" and "dfa" in k for k in paged.dispatched_keys)
    finally:
        dense.shutdown()
        paged.shutdown()


@pytest.mark.parametrize("kw", [
    {"members": 3}, {"members": 3, "member_seeds": "shared", "quorum_dedup": True},
], ids=["members", "dedup"])
def test_paged_members_equal_dense(kw):
    dense, paged = _pair(n_slots=2, **kw)
    try:
        for member in range(3):
            for p in ([5, 6, 7, 9], list(range(3, 40))):
                assert _gen(dense, p, 8, member=member) == _gen(paged, p, 8, member=member)
        # a coalesced group (held under the lock so all three admit together)
        outs = {}
        for eng in (dense, paged):
            with eng._cond:
                reqs = [eng.submit([9, 8, 7, 6], max_new_tokens=6, sampler=GREEDY, member=m)
                        for m in range(3)]
            outs[id(eng)] = [list(eng.stream_results(r)) for r in reqs]
        assert outs[id(dense)] == outs[id(paged)]
        if kw.get("quorum_dedup"):
            assert paged.quorum_dedup_prefills >= 1
    finally:
        dense.shutdown()
        paged.shutdown()


@pytest.fixture(scope="module")
def jax_weights():
    jspec = jax_resolve_spec("llama-tiny", {"max_seq": "128", "dtype": "float32"})
    return jspec, jax.tree.map(np.asarray, jax_init_params(jspec, seed=0))


@pytest.mark.parametrize("case", ["aligned", "mid_page"])
def test_alias_and_cow_counters_equal_jax(case, jax_weights):
    """test_tier0_hit_aliases_pages_with_zero_kv_bytes and
    test_mid_page_reuse_copies_exactly_the_boundary_page on both paged
    engines: the same streams, alias hits, COW copies and pages held."""
    jspec, jparams = jax_weights
    kw = {"n_slots": 2, "prefill_chunk": 16, "kv_pages": True}
    if case == "mid_page":
        kw["kv_page_size"] = 32
    port = InferenceEngine(SPEC, device="cpu", params=params_from_numpy(jparams, device="cpu"),
                           **kw)
    ref = JaxEngine(jspec, params=jparams, **kw)
    jgreedy = JaxSampler(temperature=0.0)
    try:
        if case == "aligned":
            turns = [list(range(3, 51)), list(range(3, 51)) + [77]]
        else:
            pre = list(range(3, 23))
            turns = [pre, pre[:17] + [88, 89, 90], pre + [99]]
        for p in turns:
            got = port.generate(p, max_new_tokens=6, sampler=GREEDY).token_ids
            want = ref.generate(p, max_new_tokens=6, sampler=jgreedy).token_ids
            assert got == want
        mp, mj = port.metrics(), ref.metrics()
        for name in ("kv_page_alias_hits_total", "kv_page_cow_copies_total",
                     "kv_pages_allocated", "kv_pages_free", "prefix_hits_total"):
            assert mp[name] == mj[name], name
        if case == "aligned":
            assert mp["kv_page_alias_hits_total"] >= 1 and mp["kv_page_cow_copies_total"] == 0
        else:  # turns 2 and 3 each reuse 16 tokens of a 32-token page
            assert mp["kv_page_cow_copies_total"] == 2
    finally:
        ref.shutdown()
        port.shutdown()


def test_impossible_span_sheds_and_the_engine_keeps_serving():
    eng = InferenceEngine(SPEC, device="cpu", seed=0, n_slots=4, prefill_chunk=16,
                          kv_pages=True, kv_pool_pages=2)
    try:
        with pytest.raises(QueueFullError,
                           match=r"request span of 6 pages exceeds the kv page pool \(2 pages\)"):
            _gen(eng, list(range(3, 60)), 30)
        assert len(_gen(eng, [5, 6, 7], 8)) == 8
    finally:
        eng.shutdown()


def test_transient_exhaustion_queues_and_drains():
    """8 concurrent streams against an 8-page pool on 4 slots: admissions
    wait for releases, and every stream equals its dense twin."""
    paged = InferenceEngine(SPEC, device="cpu", seed=0, n_slots=4, prefill_chunk=16,
                            kv_pages=True, kv_pool_pages=8)
    dense = InferenceEngine(SPEC, device="cpu", seed=0, n_slots=4, prefill_chunk=16)
    try:
        outs = {id(paged): {}, id(dense): {}}

        def run(eng, i):
            p = [3 + i, 4 + i, 5 + i] + list(range(6, 6 + 2 * i))
            outs[id(eng)][i] = _gen(eng, p, 10, SAMPLED, seed=i)

        ths = [threading.Thread(target=run, args=(e, i)) for e in (paged, dense)
               for i in range(8)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=120)
        assert len(outs[id(paged)]) == 8 and outs[id(paged)] == outs[id(dense)]
        assert paged.metrics()["kv_pages_allocated"] <= 8
    finally:
        paged.shutdown()
        dense.shutdown()


def test_self_donor_reclaim_unwedges_own_slot():
    eng = InferenceEngine(SPEC, device="cpu", seed=0, n_slots=1, kv_pages=True,
                          kv_page_size=16, decode_chunk=4)
    try:
        prompt = list(range(3, 33))
        first = _gen(eng, prompt, 48)  # 30 + 48 + 1 positions: 5 of the 8 pages
        done = {}
        th = threading.Thread(target=lambda: done.setdefault("out", _gen(eng, prompt, 48)),
                              daemon=True)
        th.start()
        th.join(60)
        assert not th.is_alive(), "re-admission wedged on its own donor"
        assert done["out"] == first
    finally:
        eng.shutdown()


def test_released_rows_in_a_deep_ring_leave_new_tenants_exact():
    """Ring depth 4: streams cancelled mid-flight release their pages while
    dispatches that still carry them are queued; the requests admitted onto
    those pages stream exactly what the dense engine streams."""
    dense, paged = _pair(n_slots=2, decode_pipeline=4, decode_chunk=2, kv_pool_pages=10)
    try:
        for eng in (dense, paged):
            got = []
            for i in range(3):
                it = eng.generate_stream(list(range(3 + i, 30 + i)), max_new_tokens=40,
                                         sampler=GREEDY)
                got.append([next(it) for _ in range(3)])
                it.close()  # cancel with chunks in flight
                got.append(_gen(eng, [40 + i] * 3 + list(range(50, 60)), 12, SAMPLED, seed=i))
            eng._outs = got
        assert dense._outs == paged._outs
        assert paged.metrics()["cancellations_total"] >= 3
    finally:
        dense.shutdown()
        paged.shutdown()


def _refusal(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_refusals_in_jax_words(jax_weights):
    jspec, _ = jax_weights
    draft = resolve_spec("llama-tiny", {"max_seq": "128", "n_layers": "1"})
    jdraft = jax_resolve_spec("llama-tiny", {"max_seq": "128", "n_layers": "1"})
    for kw, jkw in (({"ensemble": 2}, {"ensemble": 2}),
                    ({"draft_spec": draft, "spec_decode": 4},
                     {"draft_spec": jdraft, "spec_decode": 4}),
                    ({"kv_page_size": 24}, {"kv_page_size": 24}),
                    ({"kv_page_size": 256}, {"kv_page_size": 256})):
        got = _refusal(lambda: InferenceEngine(SPEC, device="cpu", kv_pages=True, **kw))
        assert got == _refusal(lambda: JaxEngine(jspec, kv_pages=True, **jkw)), kw
