"""The port's ``decode_multi`` (the T-token speculative-verify forward)
against the JAX package's, on the same weights and the same cache contents.

JAX's ``init_params`` makes float32 weights (converted with
``params_from_numpy``); both caches start from the same random numpy
contents, so the reads over the history matter. Logits and both cache
sides agree within 1e-4 absolute (float32; XLA and PyTorch sum in different
orders); int8 cache values may differ by one int8 step only where JAX's and
the port's f32 inputs straddle a rounding boundary (the cache's scales
agree within 1e-4 relative). Covers T ∈ {1, 3, 5}; llama (GQA + RoPE),
gemma, gpt2 (learned positions), mixtral (dense MoE), a sliding window;
the int8 cache; a row whose span crosses ``max_seq`` under
``clamp_writes`` (no valid entry changes); member-stacked params (three
weight sets, member-major rows) and ``ensemble=3`` (mean logits); and T = 1
against the port's own ``decode_step``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quorum_tpu.models import transformer as jtf
from quorum_tpu.models.init import init_params as jax_init_params
from quorum_tpu.models.model_config import resolve_spec as jax_resolve_spec
from quorum_tpu_torch.models import transformer as ttf
from quorum_tpu_torch.models.convert import params_from_numpy, stack_params
from quorum_tpu_torch.models.model_config import resolve_spec

TOL = 1e-4
FAMILIES = [
    ("llama-tiny", {}),
    ("gemma-tiny", {}),
    ("gpt2-tiny", {}),
    ("mixtral-tiny", {}),
    ("llama-tiny", {"sliding_window": "8"}),
]
FAMILY_IDS = ["llama", "gemma", "gpt2", "mixtral", "llama-window"]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _models(name, extra, seed=3):
    opts = {"dtype": "float32", **extra}
    jspec, tspec = jax_resolve_spec(name, opts), resolve_spec(name, opts)
    jparams = jax_init_params(jspec, seed=seed)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jspec, jparams, tspec, tparams


def _cache(spec, rows, seed, q8=False):
    """Random cache contents for both packages: numpy arrays of one side."""
    rng = np.random.default_rng(seed)
    shape = (spec.n_layers, rows, spec.n_kv_heads, spec.max_seq, spec.head_dim)
    if q8:
        return (rng.integers(-127, 128, size=shape).astype(np.int8),
                rng.uniform(0.001, 0.02, size=shape[:-1]).astype(np.float32))
    return rng.standard_normal(shape).astype(np.float32)


def _jax_side(side):
    return tuple(jnp.asarray(a) for a in side) if isinstance(side, tuple) else jnp.asarray(side)


def _torch_side(side):
    return (tuple(torch.from_numpy(a.copy()) for a in side) if isinstance(side, tuple)
            else torch.from_numpy(side.copy()))


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL, rtol=TOL,
                               err_msg=what)


def _close_side(got, want, what):
    if isinstance(got, tuple):
        q8_t, s_t = (np.asarray(a) for a in got)
        q8_j, s_j = (np.asarray(a) for a in want)
        diff = np.abs(q8_t.astype(np.int32) - q8_j.astype(np.int32))
        assert diff.max() <= 1, f"{what}: int8 values differ by {diff.max()}"
        assert (diff > 0).mean() < 1e-3, f"{what}: {(diff > 0).sum()} int8 flips"
        np.testing.assert_allclose(s_t, s_j, rtol=TOL, atol=1e-7, err_msg=f"{what} scales")
        return
    _close(got, want, what)


def _run_both(jspec, jparams, tspec, tparams, tokens, lengths, wmask, ck, cv,
              clamp=False, history=None):
    jl, jck, jcv = jtf.decode_multi(
        jparams, jspec, jnp.asarray(tokens), jnp.asarray(lengths), _jax_side(ck),
        _jax_side(cv), write_mask=jnp.asarray(wmask), history=history, clamp_writes=clamp)
    tl, tck, tcv = ttf.decode_multi(
        tparams, tspec, torch.from_numpy(tokens).long(), torch.from_numpy(lengths),
        _torch_side(ck), _torch_side(cv), write_mask=torch.from_numpy(wmask),
        history=history, clamp_writes=clamp)
    return (jl, jck, jcv), (tl, tck, tcv)


@pytest.mark.parametrize("t", [1, 3, 5])
@pytest.mark.parametrize("name,extra", FAMILIES, ids=FAMILY_IDS)
def test_decode_multi_matches_jax(name, extra, t):
    jspec, jparams, tspec, tparams = _models(name, extra)
    rows = 3
    rng = np.random.default_rng(t)
    tokens = rng.integers(3, tspec.vocab_size, size=(rows, t)).astype(np.int32)
    lengths = np.array([5, 40, 17], np.int32)
    wmask = np.array([True, True, False])
    ck, cv = _cache(tspec, rows, 1), _cache(tspec, rows, 2)
    (jl, jck, jcv), (tl, tck, tcv) = _run_both(jspec, jparams, tspec, tparams, tokens,
                                                lengths, wmask, ck, cv, history=64)
    assert tl.shape == (rows, t, tspec.vocab_size) and tl.dtype == torch.float32
    _close(tl.numpy(), jl, "logits")
    _close(tck.numpy(), jck, "cache_k")
    _close(tcv.numpy(), jcv, "cache_v")
    # the masked row wrote nothing
    np.testing.assert_array_equal(tck[:, 2].numpy(), ck[:, 2])


def test_decode_multi_int8_cache_matches_jax():
    jspec, jparams, tspec, tparams = _models("llama-tiny", {})
    rows, t = 3, 5
    tokens = np.random.default_rng(0).integers(3, 512, size=(rows, t)).astype(np.int32)
    lengths = np.array([9, 60, 33], np.int32)
    wmask = np.array([True, False, True])
    ck, cv = _cache(tspec, rows, 1, q8=True), _cache(tspec, rows, 2, q8=True)
    (jl, jck, jcv), (tl, tck, tcv) = _run_both(jspec, jparams, tspec, tparams, tokens,
                                                lengths, wmask, ck, cv)
    _close(tl.numpy(), jl, "logits")
    _close_side(tck, jck, "cache_k")
    _close_side(tcv, jcv, "cache_v")


@pytest.mark.parametrize("name", ["llama-tiny", "gpt2-tiny"])
def test_clamp_writes_drop_exactly_the_positions_past_max_seq(name):
    """A row at max_seq − 2 verifying 5 positions writes 2 and drops 3; the
    cache below its start is untouched (JAX's roll trick, position for
    position); gpt2's learned positions clamp their gather."""
    jspec, jparams, tspec, tparams = _models(name, {})
    rows, t, m = 2, 5, tspec.max_seq
    tokens = np.random.default_rng(4).integers(3, 512, size=(rows, t)).astype(np.int32)
    lengths = np.array([m - 2, 10], np.int32)
    wmask = np.array([True, True])
    ck, cv = _cache(tspec, rows, 1), _cache(tspec, rows, 2)
    (jl, jck, jcv), (tl, tck, tcv) = _run_both(jspec, jparams, tspec, tparams, tokens,
                                                lengths, wmask, ck, cv, clamp=True)
    _close(tl.numpy(), jl, "logits")
    _close(tck.numpy(), jck, "cache_k")
    _close(tcv.numpy(), jcv, "cache_v")
    # valid entries below the span are exactly as they were
    np.testing.assert_array_equal(tck[:, 0, :, :m - 2].numpy(), ck[:, 0, :, :m - 2])
    np.testing.assert_array_equal(tcv[:, 0, :, :m - 2].numpy(), cv[:, 0, :, :m - 2])
    assert not np.array_equal(tck[:, 0, :, m - 2:].numpy(), ck[:, 0, :, m - 2:])


def test_members_stacked_rows_match_jax_per_member():
    """Member-stacked params: row m·S + s is member m's row s (JAX's
    ``_stacked_rows_call``: a member vmap over folded rows)."""
    members, s, t = 3, 2, 3
    models = [_models("llama-tiny", {}, seed=10 + m) for m in range(members)]
    jspec, tspec = models[0][0], models[0][2]
    stacked = stack_params([mdl[3] for mdl in models])
    rng = np.random.default_rng(5)
    tokens = rng.integers(3, 512, size=(members * s, t)).astype(np.int32)
    lengths = rng.integers(0, 60, size=(members * s,)).astype(np.int32)
    wmask = np.array([True, False, True, True, True, False])
    ck, cv = _cache(tspec, members * s, 1), _cache(tspec, members * s, 2)
    tl, tck, tcv = ttf.decode_multi(
        stacked, tspec, torch.from_numpy(tokens).long(), torch.from_numpy(lengths),
        _torch_side(ck), _torch_side(cv), write_mask=torch.from_numpy(wmask), clamp_writes=True)
    for m, (jspec, jparams, _, _) in enumerate(models):
        r = slice(m * s, (m + 1) * s)
        jl, jck, jcv = jtf.decode_multi(
            jparams, jspec, jnp.asarray(tokens[r]), jnp.asarray(lengths[r]),
            jnp.asarray(ck[:, r]), jnp.asarray(cv[:, r]), write_mask=jnp.asarray(wmask[r]),
            clamp_writes=True)
        _close(tl[r].numpy(), jl, f"member {m} logits")
        _close(tck[:, r].numpy(), jck, f"member {m} cache_k")
        _close(tcv[:, r].numpy(), jcv, f"member {m} cache_v")


def test_ensemble_mean_logits_match_jax():
    """``ensemble=3``: every row through the three weight sets (cache rows
    e·B + b) and the mean of their f32 logits (JAX's ``_member_call``)."""
    ens, b, t = 3, 2, 4
    models = [_models("llama-tiny", {}, seed=20 + e) for e in range(ens)]
    tspec = models[0][2]
    stacked = stack_params([mdl[3] for mdl in models])
    rng = np.random.default_rng(6)
    tokens = rng.integers(3, 512, size=(b, t)).astype(np.int32)
    lengths = np.array([3, 50], np.int32)
    wmask = np.array([True, True])
    ck, cv = _cache(tspec, ens * b, 1), _cache(tspec, ens * b, 2)
    tl, tck, tcv = ttf.decode_multi(
        stacked, tspec, torch.from_numpy(tokens).long(), torch.from_numpy(lengths),
        _torch_side(ck), _torch_side(cv), write_mask=torch.from_numpy(wmask),
        clamp_writes=True, ensemble=ens)
    want = []
    for e, (jspec, jparams, _, _) in enumerate(models):
        r = slice(e * b, (e + 1) * b)
        jl, jck, jcv = jtf.decode_multi(
            jparams, jspec, jnp.asarray(tokens), jnp.asarray(lengths), jnp.asarray(ck[:, r]),
            jnp.asarray(cv[:, r]), write_mask=jnp.asarray(wmask), clamp_writes=True)
        want.append(np.asarray(jl))
        _close(tck[:, r].numpy(), jck, f"weight set {e} cache_k")
        _close(tcv[:, r].numpy(), jcv, f"weight set {e} cache_v")
    _close(tl.numpy(), np.mean(want, axis=0), "mean logits")


@pytest.mark.parametrize("name", ["llama-tiny", "mixtral-tiny", "gpt2-tiny"])
def test_t1_equals_decode_step(name):
    """T = 1 is the port's own decode step: same logits, same caches."""
    _, _, tspec, tparams = _models(name, {})
    rows = 3
    token = torch.tensor([7, 300, 41])
    lengths = torch.tensor([0, 12, 90], dtype=torch.int32)
    wmask = torch.tensor([True, False, True])
    ck, cv = _cache(tspec, rows, 1), _cache(tspec, rows, 2)
    sl, sck, scv = ttf.decode_step(tparams, tspec, token, lengths, _torch_side(ck),
                                   _torch_side(cv), write_mask=wmask)
    ml, mck, mcv = ttf.decode_multi(tparams, tspec, token[:, None], lengths, _torch_side(ck),
                                    _torch_side(cv), write_mask=wmask)
    _close(ml[:, 0].numpy(), sl.numpy(), "logits")
    np.testing.assert_array_equal(mck.numpy(), sck.numpy())
    np.testing.assert_array_equal(mcv.numpy(), scv.numpy())
