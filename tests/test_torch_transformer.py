"""The port's dense transformer against the JAX package's, on the same weights.

JAX's ``init_params`` makes the weights (float32 presets, so tolerances test
the algorithm, not bf16 rounding); ``params_from_numpy`` converts them.
Prefill logits and the written KV cache, ``decode_chunk`` outputs (tokens,
per-row valid counts, live/budget finish state, lengths, caches) and
``forward_logits`` must agree within 1e-4 absolute (float32, with summation
orders that differ between XLA and PyTorch); greedy tokens must be equal.
Covers the llama (GQA + RoPE), gpt2 (learned positions, LayerNorm, biases,
tied head), gemma ((1 + w) RMSNorm, GeGLU, scaled embeddings) families and a
sliding-window llama.
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
from quorum_tpu_torch.models.convert import params_from_numpy
from quorum_tpu_torch.models.model_config import resolve_spec

TOL = 1e-4
PRESETS = [
    ("llama-tiny", {}),
    ("gpt2-tiny", {}),
    ("gemma-tiny", {}),
    ("llama-tiny", {"sliding_window": "8"}),
]
IDS = ["llama", "gpt2", "gemma", "llama-window"]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _models(name, extra):
    opts = {"dtype": "float32", **extra}
    jspec, tspec = jax_resolve_spec(name, opts), resolve_spec(name, opts)
    jparams = jax_init_params(jspec, seed=3)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jspec, jparams, tspec, tparams


def _tokens(vocab, b, t, seed=0):
    return np.random.default_rng(seed).integers(3, vocab, size=(b, t)).astype(np.int32)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL, rtol=TOL,
                               err_msg=what)


@pytest.mark.parametrize("name,extra", PRESETS, ids=IDS)
def test_prefill_logits_and_cache_match_jax(name, extra):
    jspec, jparams, tspec, tparams = _models(name, extra)
    toks = _tokens(tspec.vocab_size, 1, 32)
    lens = np.array([27], np.int32)
    # slot mode: batch-1 prompt into row 1 of a 3-row slot cache
    jck, jcv = jtf.init_cache(jspec, 3)
    jl, jck, jcv = jtf.prefill(jparams, jspec, jnp.asarray(toks), jnp.asarray(lens), jck, jcv,
                               slot=jnp.int32(1))
    tck, tcv = ttf.init_cache(tspec, 3)
    tl, tck, tcv = ttf.prefill(tparams, tspec, torch.from_numpy(toks).long(),
                               torch.from_numpy(lens), tck, tcv, slot=1)
    _close(tl.numpy(), jl, "prefill logits")
    _close(tck.numpy(), jck, "prefill cache_k")
    _close(tcv.numpy(), jcv, "prefill cache_v")


@pytest.mark.parametrize("name,extra", PRESETS, ids=IDS)
def test_decode_chunk_matches_jax(name, extra):
    """Rows admitted into slots 0 and 2, slot 1 dead (its masked writes must
    not touch the cache); row 2's budget ends mid-chunk; a second pass puts
    row 0's second token as its EOS to finish it mid-chunk on device."""
    jspec, jparams, tspec, tparams = _models(name, extra)
    prompts = {0: _tokens(tspec.vocab_size, 1, 16, seed=1),
               2: _tokens(tspec.vocab_size, 1, 16, seed=2)}
    lens = {0: 13, 2: 9}
    jck, jcv = jtf.init_cache(jspec, 3)
    tck, tcv = ttf.init_cache(tspec, 3)
    first = {}
    for slot, toks in prompts.items():
        n = np.array([lens[slot]], np.int32)
        jl, jck, jcv = jtf.prefill(jparams, jspec, jnp.asarray(toks), jnp.asarray(n), jck, jcv,
                                   slot=jnp.int32(slot))
        _, tck, tcv = ttf.prefill(tparams, tspec, torch.from_numpy(toks).long(),
                                  torch.from_numpy(n), tck, tcv, slot=slot)
        first[slot] = int(np.argmax(np.asarray(jl)[0]))

    def jax_greedy(logits, live, carry):
        return jnp.argmax(logits, axis=-1).astype(jnp.int32), carry, ()

    def torch_greedy(logits, live, carry):
        return torch.argmax(logits, dim=-1), carry, ()

    token = np.array([first[0], 0, first[2]], np.int32)
    lengths = np.array([lens[0], 0, lens[2]], np.int32)
    live = np.array([True, False, True])
    budget = np.array([6, 0, 3], np.int32)
    eos_runs = [np.array([-1, -1, -1], np.int32)]
    for eos in eos_runs:
        j = jtf.decode_chunk(jparams, jspec, 5, jnp.asarray(token), jnp.asarray(lengths),
                             jnp.asarray(live), jnp.asarray(budget), jnp.asarray(eos),
                             jck, jcv, jax_greedy, (), flash="")
        t = ttf.decode_chunk(tparams, tspec, 5, torch.from_numpy(token).long(),
                             torch.from_numpy(lengths), torch.from_numpy(live),
                             torch.from_numpy(budget), torch.from_numpy(eos),
                             tck.clone(), tcv.clone(), torch_greedy, ())
        jtoks, jvalid, jn, jlive, jbud, jck2, jcv2, jlens = j[:8]
        ttoks, tvalid, tn, tlive, tbud, tck2, tcv2, tlens = t[:8]
        live_rows = [0, 2]
        assert ttoks.numpy()[live_rows].tolist() == np.asarray(jtoks)[live_rows].tolist()
        assert tvalid.numpy().tolist() == np.asarray(jvalid).tolist()
        assert tn.numpy().tolist() == np.asarray(jn).tolist()
        assert tlive.numpy().tolist() == np.asarray(jlive).tolist()
        assert tbud.numpy().tolist() == np.asarray(jbud).tolist()
        assert tlens.numpy().tolist() == np.asarray(jlens).tolist()
        _close(tck2.numpy(), jck2, "decode cache_k")
        _close(tcv2.numpy(), jcv2, "decode cache_v")
        if len(eos_runs) == 1:
            eos_runs.append(np.array([int(np.asarray(jtoks)[0, 1]), -1, -1], np.int32))
    assert np.asarray(jn).tolist()[0] <= 2  # the EOS run really finished row 0 mid-chunk


@pytest.mark.parametrize("name,extra", PRESETS, ids=IDS)
def test_forward_logits_match_jax(name, extra):
    jspec, jparams, tspec, tparams = _models(name, extra)
    toks = _tokens(tspec.vocab_size, 2, 20, seed=4)
    want = jtf.forward_logits(jparams, jspec, jnp.asarray(toks))
    got = ttf.forward_logits(tparams, tspec, torch.from_numpy(toks).long())
    _close(got.numpy(), want, "forward_logits")


def test_prefill_then_decode_equals_forward_logits():
    """Cache consistency inside the port: the logits of a prefill followed by
    decode steps equal the cache-free forward at the same positions."""
    _, _, tspec, tparams = _models("llama-tiny", {})
    toks = torch.from_numpy(_tokens(tspec.vocab_size, 1, 12, seed=5)).long()
    full = ttf.forward_logits(tparams, tspec, toks)
    ck, cv = ttf.init_cache(tspec, 1)
    logits, ck, cv = ttf.prefill(tparams, tspec, toks[:, :8], torch.tensor([8], dtype=torch.int32),
                                 ck, cv)
    _close(logits.numpy(), full[:, 7].numpy(), "prefill vs forward")
    for p in range(8, 12):
        logits, ck, cv = ttf.decode_step(tparams, tspec, toks[:, p],
                                         torch.tensor([p], dtype=torch.int32), ck, cv)
        _close(logits.numpy(), full[:, p].numpy(), f"decode step {p} vs forward")


def test_quantized_leaves_are_refused():
    """Where the JAX package quantizes no leaf (norms, biases, the router)."""
    with pytest.raises(ValueError, match="int8"):
        params_from_numpy({"final_norm_w": {"q8": np.zeros((2, 2), np.int8),
                                            "qs": np.ones(2)}, "blocks": {}}, device="cpu")
