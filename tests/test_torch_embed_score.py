"""The cache-free forwards, embeddings and prompt scoring of the port against
the JAX package's, on the same float32 weights (JAX's ``init_params``,
converted), for llama-tiny, gpt2-tiny, gemma-tiny and mixtral-tiny.

- ``forward_hidden`` and ``forward_logits(lengths=…)``: every position
  below a row's length within 1e-4 of JAX's (the K1 route — its plain
  version here — leaves the positions past a length unspecified), and with
  ``plain_attention=True`` every position;
- ``embed_token_batch`` on a ragged batch with an empty input and one
  longer than ``max_seq`` (its head is kept): within 1e-4;
- ``score_token_batch`` with ``top_k=3``: logprobs within 1e-4, top-k ids
  equal;
- a ``members=3`` engine's member 1 against JAX's member 1;
- position chunks of the unembed and whole-row sub-batches (a small
  ``SCORE_CHUNK_TOKENS`` / ``FORWARD_TOKENS``) against the unchunked call:
  within 1e-5, and a busy engine's smaller budget (``FORWARD_TOKENS_BUSY``)
  against an idle one's;
- MoE: scoring a prompt alone equals scoring it beside a shorter one
  (pads take no expert capacity), and a spec whose capacity can bind is
  never split into sub-batches; the grouped MoE run in capacity slices (a
  small ``MOE_SLOT_ROWS``) equals the whole buffer, plain and int8; such a
  spec's request past ``MOE_FORWARD_TOKENS`` is refused (a 400 at the API).

The JAX functions read only ``spec``, ``members``, ``ensemble`` and
``params`` of an engine, so they run on a stand-in (no JAX engine, no
decode compile).
"""

import asyncio
import types

import httpx
import jax
import numpy as np
import pytest
import torch

from quorum_tpu.engine import embed as jembed
from quorum_tpu.engine import score as jscore
from quorum_tpu.models import transformer as jtf
from quorum_tpu.models.init import init_params as jax_init_params
from quorum_tpu.models.model_config import resolve_spec as jax_resolve_spec
from quorum_tpu_torch.backends.cuda_backend import CudaBackend
from quorum_tpu_torch.config import Config
from quorum_tpu_torch.engine import embed as tembed
from quorum_tpu_torch.engine import score as tscore
from quorum_tpu_torch.engine.engine import InferenceEngine
from quorum_tpu_torch.models import transformer as ttf
from quorum_tpu_torch.models.convert import params_from_numpy, stacked_params_from_numpy
from quorum_tpu_torch.models.init import init_params
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.models.quant import quantize_params
from quorum_tpu_torch.server.app import create_app

TOL = 1e-4
PRESETS = ["llama-tiny", "gpt2-tiny", "gemma-tiny", "mixtral-tiny"]
OPTS = {"dtype": "float32", "max_seq": "64"}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_engine(jspec, jparams, members=1):
    return types.SimpleNamespace(spec=jspec, params=jparams, members=members, ensemble=1)


@pytest.fixture(scope="module")
def models():
    """name → (JAX stand-in engine, port engine) on one weight set."""
    out = {}
    for name in PRESETS:
        jspec = jax_resolve_spec(name, OPTS)
        jparams = jax.tree.map(np.asarray, jax_init_params(jspec, seed=7))
        teng = InferenceEngine(resolve_spec(name, OPTS), device="cpu", n_slots=1,
                               params=params_from_numpy(jparams, device="cpu"))
        out[name] = (_jax_engine(jspec, jparams), teng)
    yield out
    for _, teng in out.values():
        teng.shutdown()


def _ragged(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, vocab, size=n).tolist() for n in lens]


@pytest.mark.parametrize("name", PRESETS)
def test_forward_hidden_and_logits_match_jax(models, name):
    jeng, teng = models[name]
    toks = np.random.default_rng(1).integers(3, 500, size=(3, 24)).astype(np.int32)
    lens = np.array([24, 9, 17], np.int32)
    t_toks, t_lens = torch.from_numpy(toks).long(), torch.from_numpy(lens)
    for jfn, tfn in ((jtf.forward_hidden, ttf.forward_hidden),
                     (jtf.forward_logits, ttf.forward_logits)):
        want = np.asarray(jfn(jeng.params, jeng.spec, toks, lengths=lens))
        got = tfn(teng.params, teng.spec, t_toks, t_lens).numpy()
        for b, n in enumerate(lens):
            np.testing.assert_allclose(got[b, :n], want[b, :n], atol=TOL, rtol=TOL,
                                       err_msg=f"{tfn.__name__} row {b}")
        plain = tfn(teng.params, teng.spec, t_toks, t_lens, plain_attention=True).numpy()
        np.testing.assert_allclose(plain, want, atol=TOL, rtol=TOL, err_msg=tfn.__name__)


@pytest.mark.parametrize("name", PRESETS)
def test_embed_matches_jax(models, name):
    jeng, teng = models[name]
    # an empty input (one pad-id token) and one past max_seq=64 (head kept)
    lists = _ragged(teng.spec.vocab_size, [5, 30, 0, 70, 12], seed=2)
    want = np.asarray(jembed.embed_token_batch(jeng, lists))
    got = tembed.embed_token_batch(teng, lists)
    assert got.shape == (5, teng.spec.d_model) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(torch.linalg.vector_norm(got, dim=-1).numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("name", PRESETS)
def test_score_matches_jax(models, name):
    jeng, teng = models[name]
    lists = _ragged(teng.spec.vocab_size, [7, 40, 1, 23], seed=3)
    want = jscore.score_token_batch(jeng, lists, top_k=3)
    got = tscore.score_token_batch(teng, lists, top_k=3)
    _same_scores(got, want, TOL)
    plain = tscore.score_token_batch(teng, lists)
    assert all("top" not in e for e in plain)
    _same_scores(plain, [{"token_logprobs": w["token_logprobs"]} for w in want], TOL)


def _same_scores(got, want, tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["token_logprobs"][0] is None and len(g["token_logprobs"]) == len(
            w["token_logprobs"])
        np.testing.assert_allclose(g["token_logprobs"][1:], w["token_logprobs"][1:],
                                   atol=tol, rtol=tol)
        if "top" in w:
            assert g["top"][0] is None and len(g["top"]) == len(w["top"])
            for (gi, gl), (wi, wl) in zip(g["top"][1:], w["top"][1:]):
                assert gi == list(wi)
                np.testing.assert_allclose(gl, wl, atol=tol, rtol=tol)


def test_members_select_their_weight_set():
    jspec = jax_resolve_spec("llama-tiny", OPTS)
    trees = [jax.tree.map(np.asarray, jax_init_params(jspec, seed=s)) for s in (11, 12, 13)]
    jstacked = jax.tree.map(lambda *xs: np.stack(xs), *trees)
    teng = InferenceEngine(resolve_spec("llama-tiny", OPTS), device="cpu", n_slots=1,
                           members=3, params=stacked_params_from_numpy(jstacked, device="cpu"))
    try:
        jeng = _jax_engine(jspec, jstacked, members=3)
        lists = _ragged(512, [6, 19], seed=4)
        got = tembed.embed_token_batch(teng, lists, member=1)
        np.testing.assert_allclose(got.numpy(), np.asarray(
            jembed.embed_token_batch(jeng, lists, member=1)), atol=TOL, rtol=TOL)
        single = _jax_engine(jspec, trees[1])
        np.testing.assert_allclose(got.numpy(), np.asarray(
            jembed.embed_token_batch(single, lists)), atol=TOL, rtol=TOL)
        _same_scores(tscore.score_token_batch(teng, lists, member=2, top_k=2),
                     jscore.score_token_batch(jeng, lists, member=2, top_k=2), TOL)
    finally:
        teng.shutdown()


@pytest.mark.parametrize("name", ["llama-tiny", "mixtral-tiny"])
def test_chunks_and_sub_batches_equal_the_unchunked_call(models, name, monkeypatch):
    """mixtral-tiny's capacity cannot bind (cf·k = 4 = E): it splits too."""
    _, teng = models[name]
    lists = _ragged(teng.spec.vocab_size, [9, 33, 64, 2, 17, 40], seed=5)
    emb, scores = (tembed.embed_token_batch(teng, lists),
                   tscore.score_token_batch(teng, lists, top_k=2))
    monkeypatch.setattr(tembed, "FORWARD_TOKENS", 64)
    monkeypatch.setattr(tscore, "SCORE_CHUNK_TOKENS", 8)
    # by descending length, each group within 64 padded tokens
    assert tembed.row_groups(teng.spec, [len(t) for t in lists]) == [[2], [5], [1], [4, 0], [3]]
    np.testing.assert_allclose(tembed.embed_token_batch(teng, lists).numpy(), emb.numpy(),
                               atol=1e-5, rtol=1e-5)
    _same_scores(tscore.score_token_batch(teng, lists, top_k=2), scores, 1e-5)


def test_a_busy_engine_runs_smaller_sub_batches(models, monkeypatch):
    """While a slot holds a request the forwards take ``FORWARD_TOKENS_BUSY``
    (here 64: five sub-batches in place of one), with the same vectors and
    scores as the idle engine's one forward."""
    _, teng = models["llama-tiny"]
    lists = _ragged(teng.spec.vocab_size, [9, 33, 64, 2, 17, 40], seed=5)
    assert not teng.busy() and tembed.forward_budget(teng) == tembed.FORWARD_TOKENS
    emb, scores = (tembed.embed_token_batch(teng, lists),
                   tscore.score_token_batch(teng, lists, top_k=2))
    monkeypatch.setattr(tembed, "FORWARD_TOKENS_BUSY", 64)
    monkeypatch.setattr(teng, "busy", lambda: True)
    calls = []
    for mod in (tembed, tscore):
        real = mod.forward_hidden
        monkeypatch.setattr(mod, "forward_hidden",
                            lambda *a, real=real, **kw: calls.append(1) or real(*a, **kw))
    got_emb = tembed.embed_token_batch(teng, lists)
    got_scores = tscore.score_token_batch(teng, lists, top_k=2)
    assert len(calls) == 2 * 5
    np.testing.assert_allclose(got_emb.numpy(), emb.numpy(), atol=1e-5, rtol=1e-5)
    _same_scores(got_scores, scores, 1e-5)


def test_moe_scoring_is_batch_composition_independent(monkeypatch):
    """cf = 1.5 < E/k: drops are live. A prompt scored beside a shorter one
    (whose pads sit before its tokens in the flattened stream) equals it
    alone, and equals JAX; the sub-batch budget never splits such a spec."""
    opts = {"dtype": "float32", "max_seq": "128", "moe_capacity_factor": "1.5"}
    jspec = jax_resolve_spec("mixtral-tiny", opts)
    jparams = jax.tree.map(np.asarray, jax_init_params(jspec, seed=8))
    teng = InferenceEngine(resolve_spec("mixtral-tiny", opts), device="cpu", n_slots=1,
                           params=params_from_numpy(jparams, device="cpu"))
    try:
        short = [(i % 97) + 3 for i in range(20)]
        long = [(i % 89) + 5 for i in range(120)]
        alone = tscore.score_token_batch(teng, [long])[0]["token_logprobs"][1:]
        batched = tscore.score_token_batch(teng, [short, long])[1]["token_logprobs"][1:]
        np.testing.assert_allclose(alone, batched, atol=2e-4)
        want = jscore.score_token_batch(_jax_engine(jspec, jparams), [short, long])
        np.testing.assert_allclose(batched, want[1]["token_logprobs"][1:], atol=TOL, rtol=TOL)
        assert not tembed.moe_split_exact(teng.spec)
        monkeypatch.setattr(tembed, "FORWARD_TOKENS", 16)
        assert tembed.row_groups(teng.spec, [20, 120]) == [[0, 1]]
        got = tscore.score_token_batch(teng, [short, long])[1]["token_logprobs"][1:]
        np.testing.assert_allclose(got, batched, atol=1e-6)
    finally:
        teng.shutdown()


@pytest.mark.parametrize("cf,quant", [("1.5", False), ("4.0", False), ("1.5", True)])
def test_moe_expert_slices_equal_the_whole_buffer(monkeypatch, cf, quant):
    """Capacity slices of 7 rows per expert against the whole buffer, with
    drops live (cf 1.5) or none (cf 4 = E/k), pad tokens masked, plain and
    int8 experts: a buffer row's output depends on that row alone."""
    spec = resolve_spec("mixtral-tiny", {"dtype": "float32", "moe_capacity_factor": cf})
    params = init_params(spec, seed=3, device="cpu")
    if quant:
        params = quantize_params(params)
    block = ttf._layer(params["blocks"], 0)
    x = torch.randn(3, 40, spec.d_model, generator=torch.Generator().manual_seed(4))
    mask = torch.arange(40)[None, :] < torch.tensor([40, 13, 29])[:, None]
    whole = ttf._moe_mlp_grouped(x, block, spec, token_mask=mask)
    e, cap = spec.n_experts, ttf.moe_capacity(spec, x.shape[0] * x.shape[1])
    assert e * cap > 7 * e
    monkeypatch.setattr(ttf, "MOE_SLOT_ROWS", 7 * e)
    sliced = ttf._moe_mlp_grouped(x, block, spec, token_mask=mask)
    np.testing.assert_allclose(sliced.numpy(), whole.numpy(), atol=1e-6, rtol=1e-6)
    assert float(whole.abs().max()) > 1e-3


def test_moe_request_past_the_forward_limit_is_refused(monkeypatch):
    """cf = 1.5 < E/k: the forward is never split, so inputs padding past
    ``MOE_FORWARD_TOKENS`` are refused — a ValueError from the forwards, a
    400 naming the limit from /embeddings and from scoring — and those
    within it serve; a spec whose capacity cannot bind splits instead."""
    opts = {"dtype": "float32", "max_seq": "128", "moe_capacity_factor": "1.5"}
    spec = resolve_spec("mixtral-tiny", opts)
    teng = InferenceEngine(spec, device="cpu", n_slots=1,
                           params=init_params(spec, seed=2, device="cpu"))
    monkeypatch.setattr(tembed, "MOE_FORWARD_TOKENS", 128)
    over, within = _ragged(spec.vocab_size, [40] * 3, seed=6), _ragged(spec.vocab_size,
                                                                      [40] * 2, seed=6)
    raw = {"settings": {"timeout": 300},
           "primary_backends": [{"name": "M", "url": "x://mixtral-tiny", "model": "moe"}]}
    app = create_app(Config(raw=raw), M=CudaBackend("M", teng, model="moe",
                                                    model_id="mixtral-tiny"))

    async def post(path, body):
        async with httpx.AsyncClient(transport=httpx.ASGITransport(app=app),
                                     base_url="http://t") as client:
            return await client.post(path, json={"model": "moe", **body},
                                     headers={"Authorization": "Bearer t"})

    try:
        with pytest.raises(ValueError, match="4 x 64 = 256 tokens, over this model's 128"):
            tscore.score_token_batch(teng, over)
        for path, body in (("/v1/embeddings", {"input": over}),
                           ("/v1/completions", {"prompt": over, "echo": True, "logprobs": 1,
                                                "max_tokens": 0})):
            r = asyncio.run(post(path, body))
            assert r.status_code == 400, r.text
            assert r.json()["error"]["type"] == "invalid_request_error"
            assert "over this model's 128-token forward" in r.json()["error"]["message"]
        r = asyncio.run(post("/v1/embeddings", {"input": within}))
        assert r.status_code == 200 and len(r.json()["data"]) == 2
    finally:
        teng.shutdown()
    no_drop = resolve_spec("mixtral-tiny", {**opts, "moe_capacity_factor": "2.0"})
    assert tembed.forward_tokens_error(no_drop, [40] * 3) is None
