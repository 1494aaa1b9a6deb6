"""Mixtral-style MoE layers of the port against the JAX package's, on
mixtral-tiny (E=4, k=2) in float32 with the same weights (the JAX init
read back with numpy and converted with params_from_numpy).

- ``_moe_mlp_grouped`` and ``_moe_mlp_dense`` equal JAX's within 1e-5, at
  the preset's capacity factor (2 = E/k: no pick drops) and at 0.5, where
  the same picks drop in both (the tokens the drops change are the same,
  and there are some);
- the right-padding mask keeps pad tokens out of expert capacity as JAX's
  does (and it matters: without it later rows lose picks);
- ties between router logits pick the lower expert index, as
  ``lax.top_k`` does;
- ``forward_logits``, ``prefill`` and ``decode_step`` equal JAX's within
  1e-4;
- greedy streams of a mixtral-tiny engine equal the JAX engine's token for
  token at its default knobs, at ``prefill_chunk=16`` (segments through
  the grouped MoE, first token from the dense decode) and at
  ``decode_loop=4``; each stream's argmax margins are checked first, so a
  mismatch is never a near tie (ROADMAP queue 3);
- the engine's state tensors keep their addresses (decode graphs replay
  them) and stacked MoE engines are refused by name.

The replay of an MoE decode chunk on a card is
tests/test_torch_moe_gpu.py.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quorum_tpu.engine.engine import InferenceEngine as JaxEngine
from quorum_tpu.models import transformer as jt
from quorum_tpu.models.init import init_params as jax_init_params
from quorum_tpu.models.model_config import resolve_spec as jax_resolve_spec
from quorum_tpu.ops.sampling import SamplerConfig as JaxSampler
from quorum_tpu_torch.engine.engine import InferenceEngine
from quorum_tpu_torch.models import transformer as tt
from quorum_tpu_torch.models.convert import params_from_numpy
from quorum_tpu_torch.models.init import init_params
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.ops.sampling import SamplerConfig

OPTS = {"dtype": "float32"}
GREEDY_J, GREEDY_T = JaxSampler(temperature=0.0), SamplerConfig(temperature=0.0)
PROMPTS = [[5, 9, 33, 7, 81], list(range(40, 71)), [100, 3, 3, 200, 17, 17, 250, 4, 9]]
BUDGETS = [13, 5, 21]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _specs(cf=None):
    jspec, tspec = jax_resolve_spec("mixtral-tiny", OPTS), resolve_spec("mixtral-tiny", OPTS)
    if cf is not None:
        jspec = dataclasses.replace(jspec, moe_capacity_factor=cf)
        tspec = dataclasses.replace(tspec, moe_capacity_factor=cf)
    return jspec, tspec


@pytest.fixture(scope="module")
def weights():
    jspec, _ = _specs()
    jparams = jax.tree.map(np.asarray, jax_init_params(jspec, seed=5))
    return jparams, params_from_numpy(jparams, device="cpu")


def _layer0(jparams, tparams):
    jb = {k: (None if v is None else v[0]) for k, v in jparams["blocks"].items()}
    tb = {k: (None if v is None else v[0]) for k, v in tparams["blocks"].items()}
    return jb, tb


def _x(b, t, seed):
    return np.random.default_rng(seed).standard_normal((b, t, 64)).astype(np.float32)


def _both(fn, x, jb, tb, jspec, tspec, mask=None):
    kw_j = {} if mask is None else {"token_mask": jnp.asarray(mask)}
    kw_t = {} if mask is None else {"token_mask": torch.from_numpy(mask)}
    want = np.asarray(getattr(jt, fn)(jnp.asarray(x), jb, jspec, **kw_j))
    got = getattr(tt, fn)(torch.from_numpy(x), tb, tspec, **kw_t).numpy()
    return want, got


def test_moe_leaves_have_the_jax_shapes(weights):
    jparams, _ = weights
    _, tspec = _specs()
    ours = init_params(tspec, 0, "cpu")
    assert set(ours["blocks"]) == set(jparams["blocks"])
    for k, v in jparams["blocks"].items():
        assert (v is None) == (ours["blocks"][k] is None), k
        if v is not None:
            assert tuple(ours["blocks"][k].shape) == v.shape, k
    assert tuple(ours["blocks"]["moe_w_down"].shape) == (2, 4, 128, 64)


@pytest.mark.parametrize("cf", [2.0, 0.5], ids=["no_drop", "cf0.5"])
@pytest.mark.parametrize("fn", ["_moe_mlp_dense", "_moe_mlp_grouped"])
def test_moe_mlp_matches_jax(weights, fn, cf):
    jspec, tspec = _specs(cf)
    jb, tb = _layer0(*weights)
    want, got = _both(fn, _x(2, 24, 1), jb, tb, jspec, tspec)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.abs(want).max() > 1e-3


def test_capacity_drops_the_same_picks_as_jax(weights):
    """At cf=0.5 (capacity 12 of 48 tokens' 96 picks over 4 experts) the
    tokens whose output the drops change are the same in both, and there
    are some; at cf=2 grouped equals the dense oracle."""
    jb, tb = _layer0(*weights)
    x = _x(2, 24, 2)
    assert tt.moe_capacity(_specs(0.5)[1], 48) == 12
    changed = []
    for fw in ("jax", "port"):
        jspec, tspec = _specs(0.5)
        dense = _both("_moe_mlp_dense", x, jb, tb, jspec, tspec)
        grouped = _both("_moe_mlp_grouped", x, jb, tb, jspec, tspec)
        i = 0 if fw == "jax" else 1
        changed.append(np.abs(grouped[i] - dense[i]).max(-1) > 1e-5)
    assert (changed[0] == changed[1]).all()
    assert 0 < changed[1].sum() < changed[1].size
    jspec, tspec = _specs()
    dense = _both("_moe_mlp_dense", x, jb, tb, jspec, tspec)[1]
    grouped = _both("_moe_mlp_grouped", x, jb, tb, jspec, tspec)[1]
    np.testing.assert_allclose(grouped, dense, atol=1e-5, rtol=0)


def test_padding_mask_keeps_pads_out_of_capacity(weights):
    jb, tb = _layer0(*weights)
    jspec, tspec = _specs(0.5)
    x = _x(2, 24, 3)
    mask = np.arange(24)[None, :] < np.array([9, 24])[:, None]
    want, got = _both("_moe_mlp_grouped", x, jb, tb, jspec, tspec, mask=mask)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    unmasked = tt._moe_mlp_grouped(torch.from_numpy(x), tb, tspec).numpy()
    # row 0's 15 pad tokens would take capacity from row 1's real tokens
    assert np.abs(unmasked[1] - got[1]).max() > 1e-3


def test_router_ties_pick_the_lower_expert(weights):
    jb, tb = _layer0(*weights)
    jspec, tspec = _specs()
    tb = {**tb, "router": torch.zeros_like(tb["router"])}
    jb = {**jb, "router": np.zeros_like(jb["router"])}
    x = _x(1, 5, 4)
    probs, idx = tt._moe_router(torch.from_numpy(x), tb, tspec)
    jprobs, jidx = jt._moe_router(jnp.asarray(x), jb, jspec)
    assert idx.tolist() == np.asarray(jidx).tolist() == [[[0, 1]] * 5]
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), atol=0)


def test_forward_logits_matches_jax(weights):
    jparams, tparams = weights
    jspec, tspec = _specs()
    toks = np.random.default_rng(6).integers(3, 500, (2, 20))
    lengths = np.array([20, 13])
    want = np.asarray(jt.forward_logits(jparams, jspec, jnp.asarray(toks),
                                        lengths=jnp.asarray(lengths)))
    got = tt.forward_logits(tparams, tspec, torch.from_numpy(toks),
                            lengths=torch.from_numpy(lengths)).numpy()
    # The K1 route (its plain version here) leaves positions at or past a
    # row's length unspecified (the kernel writes 0s there); every position
    # below it equals JAX's. The plain attention equals JAX's everywhere.
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(got[b, :n], want[b, :n], atol=1e-4, rtol=0)
    plain = tt.forward_logits(tparams, tspec, torch.from_numpy(toks),
                              lengths=torch.from_numpy(lengths), plain_attention=True).numpy()
    np.testing.assert_allclose(plain, want, atol=1e-4, rtol=0)


def test_prefill_and_decode_step_match_jax(weights):
    jparams, tparams = weights
    jspec, tspec = _specs()
    toks = np.random.default_rng(7).integers(3, 500, (2, 16))
    lengths = np.array([16, 11], dtype=np.int32)
    jk, jv = jt.init_cache(jspec, 2)
    tk, tv = tt.init_cache(tspec, 2, device="cpu")
    want, jk, jv = jt.prefill(jparams, jspec, jnp.asarray(toks), jnp.asarray(lengths), jk, jv)
    got, _, _ = tt.prefill(tparams, tspec, torch.from_numpy(toks), torch.from_numpy(lengths),
                           tk, tv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    nxt = np.asarray(want).argmax(-1)
    want, _, _ = jt.decode_step(jparams, jspec, jnp.asarray(nxt), jnp.asarray(lengths), jk, jv)
    got, _, _ = tt.decode_step(tparams, tspec, torch.from_numpy(nxt),
                               torch.from_numpy(lengths), tk, tv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def _min_margin(jparams, jspec, prompt, generated) -> float:
    """Smallest top-1 − top-2 gap of the JAX logits over the generated
    positions (the cache-free forward of the whole sequence)."""
    seq = jnp.asarray([prompt + generated[:-1]])
    logits = np.asarray(jt.forward_logits(jparams, jspec, seq))[0, len(prompt) - 1:]
    top2 = np.sort(logits, axis=-1)[:, -2:]
    return float((top2[:, 1] - top2[:, 0]).min())


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


@pytest.mark.parametrize("knobs", [{}, {"prefill_chunk": 16}, {"decode_loop": 4}],
                         ids=["defaults", "prefill_chunk16", "decode_loop4"])
def test_greedy_engine_streams_match_jax(weights, knobs):
    jparams, tparams = weights
    jspec, tspec = _specs()
    jeng = JaxEngine(jspec, params=jparams, **knobs)
    teng = InferenceEngine(tspec, device="cpu", params=tparams, **knobs)
    try:
        want = _concurrently([
            (lambda p=p, n=n: jeng.generate(p, max_new_tokens=n, sampler=GREEDY_J).token_ids)
            for p, n in zip(PROMPTS, BUDGETS)])
        for p, w in zip(PROMPTS, want):
            assert _min_margin(jparams, jspec, p, w) > 1e-4, "a near tie: pick another prompt"
        got = _concurrently([
            (lambda p=p, n=n: teng.generate(p, max_new_tokens=n, sampler=GREEDY_T).token_ids)
            for p, n in zip(PROMPTS, BUDGETS)])
        assert got == want
        m = teng.metrics()
        if knobs.get("prefill_chunk") == 16:
            assert m["prefill_segments_total"] >= 2  # the 31-token prompt
    finally:
        jeng.shutdown()
        teng.shutdown()


def test_moe_state_tensors_are_updated_in_place(weights):
    _, tparams = weights
    _, tspec = _specs()
    eng = InferenceEngine(tspec, device="cpu", params=tparams, decode_chunk=4,
                          decode_pipeline=2, decode_loop=4, prefill_chunk=16)
    try:
        names = ("_token", "_lengths", "_live", "_budget", "_eos", "_temp", "_topp", "_topk",
                 "_mask", "_noise_ring", "_ntok", "_ck", "_cv", "_pp", "_fp", "_counts", "_bias")
        before = {n: (getattr(eng, n), getattr(eng, n).data_ptr()) for n in names}
        long_prompt = [(3 + 11 * i) % 500 for i in range(40)]
        _concurrently([
            lambda: eng.generate([5, 6, 7], max_new_tokens=30, sampler=GREEDY_T),
            lambda: eng.generate(long_prompt, max_new_tokens=12,
                                 sampler=SamplerConfig(temperature=0.8), seed=3)])
        m = eng.metrics()
        assert m["prefill_segments_total"] > 0 and m["decode_chunks_total"] >= 3
        for n, (t, ptr) in before.items():
            assert getattr(eng, n) is t and t.data_ptr() == ptr, n
    finally:
        eng.shutdown()


@pytest.mark.parametrize("knob", ["members", "ensemble"])
def test_stacked_moe_engines_are_refused(knob):
    _, tspec = _specs()
    with pytest.raises(ValueError, match=rf"{knob}=2 does not compose with an MoE spec"):
        InferenceEngine(tspec, device="cpu", **{knob: 2})
