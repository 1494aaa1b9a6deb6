"""The port's megachunk decode (``decode_loop=C``) against the JAX package's.

- ``transformer.decode_loop`` against JAX ``transformer.decode_loop`` on the
  same weights (JAX ``init_params`` → numpy → torch), inputs and Gumbel
  noise: per-chunk tokens and valid counts, the carried token, lengths,
  budgets and caches. Rows that all finish in chunk 1 (the later chunks are
  zeros: JAX's skipped chunks) and a budget shorter than one chunk.
- Engines at ``decode_loop=4, decode_chunk=4``: greedy streams equal the
  JAX engine's at the same knobs for ``members=1``, ``members=3`` and
  ``ensemble=3``; sampled, seeded streams equal the port's own
  ``decode_loop=1``.
- The scheduler side: ``_effective_loop``'s clamps (the cases of
  tests/test_decode_loop.py::TestEffectiveLoopClamp but the deadline ones,
  which tests/test_torch_deadlines.py runs), the knob's range check and
  power-of-two floor, ``decode_loop_chunks_total`` counting only chunks
  that a row entered, and the static-state invariant the card's graphs
  rely on: per-row state tensors are updated in place, never rebound.

llama-tiny, float32: tokens and counts exact; lengths and budgets exact;
caches within 1e-4 (XLA and PyTorch sum in different orders).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quorum_tpu.engine.engine import InferenceEngine as JaxEngine
from quorum_tpu.models import transformer as jtf
from quorum_tpu.models.init import init_params as jax_init_params
from quorum_tpu.models.model_config import resolve_spec as jax_resolve_spec
from quorum_tpu.ops.sampling import SamplerConfig as JaxSampler
from quorum_tpu_torch.engine.engine import MAX_DECODE_LOOP, InferenceEngine
from quorum_tpu_torch.models import transformer as ttf
from quorum_tpu_torch.models.convert import params_from_numpy, stacked_params_from_numpy
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.ops.sampling import SamplerConfig

TOL = 1e-4
OPTS = {"dtype": "float32"}
SPEC = resolve_spec("llama-tiny", OPTS)
GREEDY, GREEDY_J = SamplerConfig(temperature=0.0), JaxSampler(temperature=0.0)
SAMPLED = SamplerConfig(temperature=0.9, top_p=0.95)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def shut():
    """Engines a test builds; shut down after it."""
    engines = []
    yield engines.append
    for e in engines:
        e.shutdown()


# ---- transformer.decode_loop against JAX -------------------------------------

@pytest.fixture(scope="module")
def prefilled():
    """Weights and a 3-slot cache on both sides: prompts prefilled into
    slots 0 and 2, slot 1 empty (its rows stay dead)."""
    jspec = jax_resolve_spec("llama-tiny", OPTS)
    jparams = jax_init_params(jspec, seed=3)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(0)
    jck, jcv = jtf.init_cache(jspec, 3)
    tck, tcv = ttf.init_cache(SPEC, 3)
    first, lens = {}, {0: 13, 2: 9}
    for slot, n in lens.items():
        toks = rng.integers(3, SPEC.vocab_size, size=(1, 16)).astype(np.int32)
        nn = np.array([n], np.int32)
        jl, jck, jcv = jtf.prefill(jparams, jspec, jnp.asarray(toks), jnp.asarray(nn), jck, jcv,
                                   slot=jnp.int32(slot))
        _, tck, tcv = ttf.prefill(tparams, SPEC, torch.from_numpy(toks).long(),
                                  torch.from_numpy(nn), tck, tcv, slot=slot)
        first[slot] = int(np.argmax(np.asarray(jl)[0]))
    token = np.array([first[0], 0, first[2]], np.int32)
    lengths = np.array([lens[0], 0, lens[2]], np.int32)
    return jspec, jparams, tparams, jck, jcv, tck, tcv, token, lengths


def _run_both(prefilled, n_steps, n_chunks, budget, eos, noise):
    jspec, jparams, tparams, jck, jcv, tck, tcv, token, lengths = prefilled
    live = budget > 0
    noise_j, noise_t = jnp.asarray(noise), torch.from_numpy(noise)

    def jax_sample(logits, live, k):
        return jnp.argmax(logits + noise_j[k], axis=-1).astype(jnp.int32), k + 1, ()

    def torch_sample(logits, live, k):
        return torch.argmax(logits + noise_t[k], dim=-1), k + 1, ()

    j = jtf.decode_loop(jparams, jspec, n_steps, n_chunks, jnp.asarray(token),
                        jnp.asarray(lengths), jnp.asarray(live), jnp.asarray(budget),
                        jnp.asarray(eos), jck, jcv, jax_sample, jnp.int32(0), flash="")
    t = ttf.decode_loop(tparams, SPEC, n_steps, n_chunks, torch.from_numpy(token).long(),
                        torch.from_numpy(lengths), torch.from_numpy(live),
                        torch.from_numpy(budget), torch.from_numpy(eos), tck.clone(),
                        tcv.clone(), torch_sample, 0)
    return j, t


def _assert_same(j, t):
    jtoks, jn, jtok, jlive, jbud, jck, jcv, jlens = j[:8]
    ttoks, tn, ttok, tlive, tbud, tck, tcv, tlens = t[:8]
    assert ttoks.tolist() == np.asarray(jtoks).tolist()
    assert tn.tolist() == np.asarray(jn).tolist()
    assert ttok.tolist() == np.asarray(jtok).tolist()
    assert tlive.tolist() == np.asarray(jlive).tolist()
    assert tbud.tolist() == np.asarray(jbud).tolist()
    assert tlens.tolist() == np.asarray(jlens).tolist()
    np.testing.assert_allclose(tck.numpy(), np.asarray(jck), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tcv.numpy(), np.asarray(jcv), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("budget,n_chunks", [
    ([13, 0, 6], 4),   # row 0 runs into chunk 4, row 2 stops inside chunk 2
    ([3, 0, 4], 4),    # every row finishes in chunk 1: chunks 2-4 are skipped
    ([2, 0, 1], 2),    # budgets shorter than one chunk
], ids=["mixed", "all_finish_in_chunk_1", "budget_under_one_chunk"])
def test_decode_loop_matches_jax(prefilled, budget, n_chunks):
    n_steps = 4
    noise = np.random.default_rng(1).gumbel(
        size=(n_steps * n_chunks, 3, SPEC.vocab_size)).astype(np.float32)
    budget = np.array(budget, np.int32)
    j, t = _run_both(prefilled, n_steps, n_chunks, budget, np.full(3, -1, np.int32), noise)
    _assert_same(j, t)
    n_valid = t[1].tolist()
    assert [sum(c) for c in zip(*n_valid)] == budget.tolist()  # budgets end on device
    if budget.max() <= n_steps:
        assert all(not any(c) for c in n_valid[1:]), "later chunks must be skipped"
        assert not t[0][1:].any(), "a skipped chunk's tokens are zeros"


def test_decode_loop_eos_mid_loop_matches_jax(prefilled):
    """Row 0's EOS (the token it samples at step 7, or that token's first
    occurrence) ends it on device; the chunks after that carry only row 2."""
    n_steps, n_chunks = 4, 4
    noise = np.random.default_rng(2).gumbel(
        size=(n_steps * n_chunks, 3, SPEC.vocab_size)).astype(np.float32)
    budget = np.array([16, 0, 14], np.int32)
    free, _ = _run_both(prefilled, n_steps, n_chunks, budget, np.full(3, -1, np.int32), noise)
    row0 = np.asarray(free[0])[:, 0].reshape(-1).tolist()
    pos = row0.index(row0[6])  # the first time row 0 samples that token
    eos = np.array([row0[pos], -1, -1], np.int32)
    j, t = _run_both(prefilled, n_steps, n_chunks, budget, eos, noise)
    _assert_same(j, t)
    assert sum(t[1][:, 0].tolist()) == pos + 1  # the EOS token itself is delivered


# ---- engines at decode_loop=4 against the JAX engine -------------------------

def _concurrently(fns):
    out = [None] * len(fns)

    def run(i):
        out[i] = fns[i]()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    return out


PROMPTS = [[5, 6, 7], list(range(40, 71)), [100, 3, 3, 200, 17]]
BUDGETS = [13, 20, 7]  # budgets that end mid-megachunk and inside a chunk


def test_single_engine_matches_the_jax_engine_at_decode_loop_4(shut):
    jspec = jax_resolve_spec("llama-tiny", OPTS)
    jparams = jax.tree.map(np.asarray, jax_init_params(jspec, seed=4))
    jeng = JaxEngine(jspec, params=jparams, decode_chunk=4, decode_loop=4)
    try:
        want = [jeng.generate(p, max_new_tokens=n, sampler=GREEDY_J).token_ids
                for p, n in zip(PROMPTS, BUDGETS)]
    finally:
        jeng.shutdown()
    teng = InferenceEngine(SPEC, device="cpu", params=params_from_numpy(jparams, device="cpu"),
                           decode_chunk=4, decode_loop=4)
    shut(teng)
    got = [teng.generate(p, max_new_tokens=n, sampler=GREEDY).token_ids
           for p, n in zip(PROMPTS, BUDGETS)]
    assert got == want and [len(g) for g in got] == BUDGETS
    together = _concurrently([(lambda p=p, n=n: teng.generate(
        p, max_new_tokens=n, sampler=GREEDY).token_ids) for p, n in zip(PROMPTS, BUDGETS)])
    assert together == want
    m = teng.metrics()
    assert m["decode_loop"] == 4 and m["overrun_tokens_total"] == 0


@pytest.mark.parametrize("knob", ["members", "ensemble"])
def test_stacked_engines_match_the_jax_engine_at_decode_loop_4(knob, shut):
    """``members=3``: every member's greedy stream; ``ensemble=3``: the
    one consensus stream. JAX's weights are read back and converted."""
    jspec = jax_resolve_spec("llama-tiny", OPTS)
    jeng = JaxEngine(jspec, seed=5, decode_chunk=4, n_slots=2, decode_loop=4, **{knob: 3})
    try:
        if knob == "members":
            want = [jeng.generate(p, max_new_tokens=n, sampler=GREEDY_J, member=m).token_ids
                    for m, (p, n) in enumerate(zip(PROMPTS, BUDGETS))]
        else:
            want = [jeng.generate(p, max_new_tokens=n, sampler=GREEDY_J).token_ids
                    for p, n in zip(PROMPTS, BUDGETS)]
        params = stacked_params_from_numpy(jax.tree.map(np.asarray, jeng.params), device="cpu")
    finally:
        jeng.shutdown()
    teng = InferenceEngine(SPEC, device="cpu", params=params, decode_chunk=4, n_slots=2,
                           decode_loop=4, **{knob: 3})
    shut(teng)
    if knob == "members":
        got = _concurrently([(lambda m=m, p=p, n=n: teng.generate(
            p, max_new_tokens=n, sampler=GREEDY, member=m).token_ids)
            for m, (p, n) in enumerate(zip(PROMPTS, BUDGETS))])
    else:
        got = [teng.generate(p, max_new_tokens=n, sampler=GREEDY).token_ids
               for p, n in zip(PROMPTS, BUDGETS)]
    assert got == want


@pytest.mark.parametrize("depth", [1, 2])
def test_decode_loop_4_equals_decode_loop_1_sampled(depth, shut):
    """Seeded sampling: the dispatch draws its noise ahead, one draw per step
    per sampling row in step order, so token j still takes draw j."""
    e1 = InferenceEngine(SPEC, device="cpu", decode_chunk=4, decode_pipeline=depth,
                         decode_loop=1)
    e4 = InferenceEngine(SPEC, device="cpu", decode_chunk=4, decode_pipeline=depth,
                         decode_loop=4)
    shut(e1)
    shut(e4)
    for seed in (7, 42):
        a = [e1.generate(p, max_new_tokens=n, sampler=SAMPLED, seed=seed).token_ids
             for p, n in zip(PROMPTS, BUDGETS)]
        b = _concurrently([(lambda p=p, n=n: e4.generate(
            p, max_new_tokens=n, sampler=SAMPLED, seed=seed).token_ids)
            for p, n in zip(PROMPTS, BUDGETS)])
        assert a == b, f"seed {seed} diverged"
    assert e4.metrics()["overrun_tokens_total"] == 0


# ---- the scheduler side ------------------------------------------------------

class _Row:
    """The slice of _Request the clamp reads."""

    def __init__(self, budget=100, emitted=0, deadline=None):
        self.budget = budget
        self.emitted = emitted
        self.deadline = deadline


class TestEffectiveLoopClamp:
    @pytest.fixture()
    def eng(self):
        e = InferenceEngine(SPEC, device="cpu", decode_chunk=4, decode_pipeline=1,
                            decode_loop=8)
        yield e
        e.shutdown()

    def test_full_fusion_when_unpressured(self, eng):
        assert eng._effective_loop([(0, _Row(budget=100))], 4, 0) == 8

    def test_budget_clamps_to_pow2_cover(self, eng):
        # 10 tokens left at chunk 4 → 3 chunks → pow2 cover 4, not 8
        active = [(0, _Row(budget=10))]
        assert eng._effective_loop(active, 4, 0) == 4
        # tokens already in flight count against the remaining budget
        assert eng._effective_loop(active, 4, 8) == 1
        # the longest remaining row sets the cover
        assert eng._effective_loop(active + [(1, _Row(budget=30, emitted=10))], 4, 0) == 8

    def test_admission_pressure_disables_fusion(self, eng):
        active = [(0, _Row(budget=100))]
        # Holding the (reentrant) lock keeps the request pending: a free row
        # could take it, so it presses.
        with eng._cond:
            req = eng.submit([1, 2, 3], max_new_tokens=4, sampler=GREEDY)
            assert eng._admission_pressure()
            assert eng._effective_loop(active, 4, 0) == 1
        assert len(list(eng.stream_results(req))) == 4

    def test_one_chunk_engines_never_fuse(self):
        e = InferenceEngine(SPEC, device="cpu", decode_chunk=4)
        try:
            assert e.decode_loop == 1
            assert e._effective_loop([(0, _Row(budget=100))], 4, 0) == 1
        finally:
            e.shutdown()


@pytest.mark.parametrize("value", [0, -1, MAX_DECODE_LOOP + 1, 9999])
def test_decode_loop_range_validated(value):
    with pytest.raises(ValueError, match="decode_loop"):
        InferenceEngine(SPEC, device="cpu", decode_loop=value)


@pytest.mark.parametrize("value,runs", [(1, 1), (2, 2), (6, 4), (63, 32), (64, 64)])
def test_decode_loop_floored_to_power_of_two(value, runs):
    e = InferenceEngine(SPEC, device="cpu", decode_loop=value)
    try:
        assert e.decode_loop == runs and e.metrics()["decode_loop"] == runs
    finally:
        e.shutdown()


def test_loop_chunks_count_only_chunks_a_row_entered(shut):
    """13 tokens at chunk 4: the admission samples token 1, the 12 left need
    3 chunks, the pow2 cover dispatches 4 — one dispatch, 16 steps, and the
    4th chunk no row entered is not counted. decode_loop=1 counts its 3
    chunks one dispatch each."""
    e1 = InferenceEngine(SPEC, device="cpu", decode_chunk=4, decode_loop=1)
    e4 = InferenceEngine(SPEC, device="cpu", decode_chunk=4, decode_loop=4)
    shut(e1)
    shut(e4)
    a = e1.generate([5, 6, 7], max_new_tokens=13, sampler=GREEDY).token_ids
    b = e4.generate([5, 6, 7], max_new_tokens=13, sampler=GREEDY).token_ids
    assert a == b and len(b) == 13
    m1, m4 = e1.metrics(), e4.metrics()
    assert (m4["decode_chunks_total"], m4["decode_steps_total"]) == (1, 16)
    assert m4["decode_loop_chunks_total"] == m1["decode_loop_chunks_total"] == 3
    assert m1["decode_chunks_total"] == 3
    assert m4["overrun_tokens_total"] == 0
    # A 64-token request: 16 chunks either way, a quarter of the dispatches.
    e1.generate([9, 8], max_new_tokens=65, sampler=GREEDY)
    e4.generate([9, 8], max_new_tokens=65, sampler=GREEDY)
    m1b, m4b = e1.metrics(), e4.metrics()
    assert m4b["decode_loop_chunks_total"] - 3 == m1b["decode_loop_chunks_total"] - 3 == 16
    assert m4b["decode_chunks_total"] - 1 <= (m1b["decode_chunks_total"] - 3) // 3


def test_eos_inside_a_megachunk_skips_the_rest(shut):
    """An EOS in fused chunk 3 ends the row on device: identical output to
    decode_loop=1, no overrun, and the chunk after it is not counted."""
    e1 = InferenceEngine(SPEC, device="cpu", decode_chunk=4, decode_loop=1)
    e4 = InferenceEngine(SPEC, device="cpu", decode_chunk=4, decode_loop=4)
    shut(e1)
    shut(e4)
    probe = e1.generate([9, 8], max_new_tokens=17, sampler=GREEDY).token_ids
    pos = probe.index(probe[10])  # the first time the stream samples that token
    a = e1.generate([9, 8], max_new_tokens=17, sampler=GREEDY, eos_id=probe[pos])
    b = e4.generate([9, 8], max_new_tokens=17, sampler=GREEDY, eos_id=probe[pos])
    assert a.token_ids == b.token_ids == probe[:pos]
    assert a.finish_reason == b.finish_reason == "stop"
    m4 = e4.metrics()
    assert m4["overrun_tokens_total"] == 0
    # tokens 2..pos+1 come from decode steps: ceil(pos / 4) chunks entered
    assert m4["decode_loop_chunks_total"] == -(-pos // 4)


def test_state_tensors_are_updated_in_place(shut):
    """A graph reads the addresses it was captured with: after many chunks
    at depth 2 with fused dispatches, admissions and segments, with the
    OpenAI knobs set (bias, penalties, logprobs), the engine's per-row state
    and dispatch inputs are the same tensors."""
    eng = InferenceEngine(SPEC, device="cpu", decode_chunk=4, decode_pipeline=2,
                          decode_loop=4, prefill_chunk=16)
    shut(eng)
    names = ("_token", "_lengths", "_live", "_budget", "_eos", "_temp", "_topp", "_topk",
             "_mask", "_noise_ring", "_ntok", "_ck", "_cv", "_pp", "_fp", "_counts", "_bias")
    before = {n: (getattr(eng, n), getattr(eng, n).data_ptr()) for n in names}
    long_prompt = [(3 + 11 * i) % 500 for i in range(40)]
    bias = torch.zeros(SPEC.vocab_size)
    bias[[5, 9]] = 3.0
    _concurrently([
        lambda: eng.generate([5, 6, 7], max_new_tokens=30, sampler=GREEDY),
        lambda: list(eng.generate_stream(long_prompt, max_new_tokens=12, sampler=SAMPLED,
                                         seed=3, logit_bias=bias, logprobs=2)),
        lambda: list(eng.generate_stream([3, 4], max_new_tokens=9, sampler=SAMPLED, seed=1,
                                         presence_penalty=0.5, frequency_penalty=1.0))])
    m = eng.metrics()
    assert m["decode_chunks_total"] >= 3 and m["prefill_segments_total"] > 0
    assert m["overlapped_chunks_total"] > 0 and m["decode_loop_chunks_total"] > \
        m["decode_chunks_total"]
    for n, (t, ptr) in before.items():
        assert getattr(eng, n) is t and t.data_ptr() == ptr, n
