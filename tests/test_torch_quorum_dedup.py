"""Shared-prefix quorum dedup (``quorum_dedup=1``) of the port against the
JAX package's (the dedup legs of tests/test_quorum.py).

A full member group carrying one prompt on shared weights
(``member_seeds=shared``) prefills it once on member 0's weights and copies
the K/V into every member's cache row. Tokens must be identical with dedup
on and off, greedy and sampled; every dedup admission saves exactly
``(M−1)·len(prompt)`` prefill tokens; lone members and mixed prompts fall
back and stay token-exact. Whether a fan-out coalesces into one admission is
timing-dependent (as in JAX), so the tests loop until a dedup admission is
counted and assert the tokens on every attempt. The JAX engines run
single-shot admission (``prefill_chunk=0``, no prefix cache), the port's
only route. llama-tiny, float32; tokens exact.
"""

import jax
import numpy as np
import pytest
import torch

from quorum_tpu.engine.engine import InferenceEngine as JaxEngine
from quorum_tpu.models.model_config import resolve_spec as jax_resolve_spec
from quorum_tpu.ops.sampling import SamplerConfig as JaxSampler
from quorum_tpu_torch.backends.cuda_backend import CudaBackend
from quorum_tpu_torch.config import BackendSpec
from quorum_tpu_torch.engine.engine import InferenceEngine, get_engine, shutdown_all_engines
from quorum_tpu_torch.models.convert import stacked_params_from_numpy
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.ops.sampling import SamplerConfig

M = 3
OPTS = {"dtype": "float32"}
PROMPT = [3, 4, 5, 6, 40, 41]
GREEDY = SamplerConfig(temperature=0.0)
SAMPLED = SamplerConfig(temperature=0.8, top_p=0.9)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def spec():
    return resolve_spec("llama-tiny", OPTS)


@pytest.fixture(scope="module")
def pair(spec):
    """(reference engine without dedup, dedup engine) on the same shared
    weights."""
    kw = dict(device="cpu", seed=0, members=M, decode_chunk=4, n_slots=2,
              member_seeds="shared")
    ref = InferenceEngine(spec, **kw)
    dd = InferenceEngine(spec, quorum_dedup=True, **kw)
    yield ref, dd
    ref.shutdown()
    dd.shutdown()


def _fan(eng, prompt, sampler, n=8, seed=5):
    """One request per member, submitted back to back (the fan-out shape),
    each with its own seed so sampled members diverge."""
    reqs = [eng.submit(list(prompt), max_new_tokens=n, sampler=sampler, seed=seed + m,
                       member=m) for m in range(eng.members)]
    return [list(eng.stream_results(r)) for r in reqs]


def _fan_until_dedup(eng, want, prompt, sampler, attempts=20):
    for _ in range(attempts):
        before = eng.quorum_dedup_prefills
        assert _fan(eng, prompt, sampler) == want
        if eng.quorum_dedup_prefills > before:
            return
    raise AssertionError(f"no coalesced dedup admission in {attempts} fan-outs")


@pytest.mark.parametrize("sampler", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
def test_dedup_token_identity_and_savings(pair, sampler):
    ref, dd = pair
    want = _fan(ref, PROMPT, sampler)
    # shared weights: greedy members are one stream; sampled ones diverge
    assert len({tuple(w) for w in want}) == (1 if sampler is GREEDY else M)
    _fan_until_dedup(dd, want, PROMPT, sampler)
    assert dd.quorum_dedup_prefills >= 1
    assert dd.quorum_dedup_tokens == dd.quorum_dedup_prefills * (M - 1) * len(PROMPT)
    m = dd.metrics()
    assert m["quorum_dedup_tokens_total"] == dd.quorum_dedup_tokens
    assert m["quorum_dedup_prefills_total"] == dd.quorum_dedup_prefills
    assert ref.quorum_dedup_prefills == 0  # knob off → never taken


def test_lone_member_and_mixed_prompts_fall_back(pair):
    ref, dd = pair
    before = dd.quorum_dedup_prefills
    one = dd.generate(PROMPT, max_new_tokens=8, sampler=GREEDY, seed=8, member=1).token_ids
    assert one == ref.generate(PROMPT, max_new_tokens=8, sampler=GREEDY, seed=8,
                               member=1).token_ids
    assert dd.quorum_dedup_prefills == before
    prompts = [PROMPT, [9, 8, 7], PROMPT]

    def mixed(eng):
        reqs = [eng.submit(list(p), max_new_tokens=8, sampler=SAMPLED, seed=7, member=i)
                for i, p in enumerate(prompts)]
        return [list(eng.stream_results(r)) for r in reqs]

    assert mixed(dd) == mixed(ref)
    assert dd.quorum_dedup_prefills == before


def test_dedup_matches_the_jax_dedup_engine(spec):
    """The JAX dedup engine's weights read back into the port's dedup
    engine: the greedy fan-out is token for token JAX's, on every attempt
    (dedup or fallback)."""
    jspec = jax_resolve_spec("llama-tiny", OPTS)
    jeng = JaxEngine(jspec, seed=3, members=M, decode_chunk=4, n_slots=2, prefill_chunk=0,
                     prefix_cache=False, member_seeds="shared", quorum_dedup=True)
    teng = None
    try:
        greedy_j = JaxSampler(temperature=0.0)
        want = [list(jeng.stream_results(r)) for r in [
            jeng.submit(list(PROMPT), max_new_tokens=8, sampler=greedy_j, member=m)
            for m in range(M)]]
        params = stacked_params_from_numpy(jax.tree.map(np.asarray, jeng.params), device="cpu")
        teng = InferenceEngine(spec, device="cpu", members=M, params=params, decode_chunk=4,
                               n_slots=2, member_seeds="shared", quorum_dedup=True)
        _fan_until_dedup(teng, want, PROMPT, GREEDY)
    finally:
        jeng.shutdown()
        if teng is not None:
            teng.shutdown()


@pytest.mark.parametrize("kwargs", [
    dict(members=2, member_seeds="same"),
    dict(ensemble=2, member_seeds="shared"),
    dict(quorum_dedup=True),
    dict(members=2, quorum_dedup=True),
    dict(members=2, ensemble=2),
], ids=["unknown-seeds", "shared-ensemble", "dedup-alone", "dedup-distinct", "members-ensemble"])
def test_config_rejections_carry_the_jax_messages(spec, kwargs):
    jspec = jax_resolve_spec("llama-tiny", OPTS)
    with pytest.raises(ValueError) as jerr:
        JaxEngine(jspec, **kwargs)
    with pytest.raises(ValueError) as terr:
        InferenceEngine(spec, device="cpu", **kwargs)
    assert str(terr.value) == str(jerr.value)


def test_engine_url_and_cache_key(spec):
    """cuda:// plumbing of member_seeds= and quorum_dedup=; the engine key
    keeps distinct, shared and dedup stacks apart."""
    try:
        b = CudaBackend.from_spec(BackendSpec(
            name="Q0", model="m",
            url="cuda://llama-tiny?members=2&member=0&member_seeds=shared"
                "&quorum_dedup=1&slots=1&max_seq=64&device=cpu"))
        assert b.engine.member_seeds == "shared" and b.engine.quorum_dedup is True
        with pytest.raises(ValueError, match="invalid quorum_dedup='maybe'"):
            CudaBackend.from_spec(BackendSpec(
                name="Q1", model="m",
                url="cuda://llama-tiny?members=2&member_seeds=shared&quorum_dedup=maybe"
                    "&device=cpu"))
        small = resolve_spec("llama-tiny", {"max_seq": "64"})
        shared = get_engine(small, device="cpu", seed=401, members=2, n_slots=1,
                            member_seeds="shared")
        distinct = get_engine(small, device="cpu", seed=401, members=2, n_slots=1)
        dedup = get_engine(small, device="cpu", seed=401, members=2, n_slots=1,
                           member_seeds="shared", quorum_dedup=True)
        assert len({id(shared), id(distinct), id(dedup)}) == 3
        assert get_engine(small, device="cpu", seed=401, members=2, n_slots=1,
                          member_seeds="shared", quorum_dedup=True) is dedup
        # member_seeds is weight identity only on a stacked engine
        assert get_engine(small, device="cpu", seed=401, member_seeds="shared") is \
            get_engine(small, device="cpu", seed=401)
    finally:
        shutdown_all_engines()
