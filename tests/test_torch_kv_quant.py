"""The port's int8 KV cache (``kv_quant=int8``) against the JAX package's.

- ``quantize_rows`` and the plain ``decode_attention_q8`` (the plain
  version of kernel K2q8) against the JAX functions on the same numpy
  inputs: int8 values equal, scales within 1e-7 relative, attention within
  1e-5 (windows and a length-1 row included).
- ``prefill``, ``prefill_segment``, ``decode_chunk`` and ``decode_loop`` with
  an int8 cache on ``params_from_numpy`` of JAX's weights (float32 and
  int8 weights): logits within 1e-4, the scales within 1e-5 relative, and
  the int8 caches equal except where the port's own f32 input sat at a
  rounding boundary (``_same_cache``, ``QuantSpy``).
- Greedy engine streams token for token against the JAX engine with
  ``kv_quant=int8`` (alone and with ``quant=int8``; stacked members and
  ensembles; segments and megachunks), JAX's chunked-prefill and prefix
  reuse scenario (reuse exact), the dedup refusal, and the URL.

A stream mismatch counts as a fault only after a near tie of the JAX
logits is ruled out (``_min_margin``).
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
from quorum_tpu.models.quant import quantize_params as jax_quantize_params
from quorum_tpu.ops.attention import decode_attention_q8 as jax_decode_attention_q8
from quorum_tpu.ops.attention import quantize_rows as jax_quantize_rows
from quorum_tpu.ops.sampling import SamplerConfig as JaxSampler
from quorum_tpu_torch.backends.cuda_backend import CudaBackend
from quorum_tpu_torch.config import BackendSpec
from quorum_tpu_torch.engine import engine as engine_mod
from quorum_tpu_torch.engine.engine import InferenceEngine, shutdown_all_engines
from quorum_tpu_torch.models import quant as tq
from quorum_tpu_torch.models import transformer as ttf
from quorum_tpu_torch.models.convert import params_from_numpy, stacked_params_from_numpy
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.ops import attention as tattn
from quorum_tpu_torch.ops.attention import NEG_INF, decode_attention_q8, quantize_rows
from quorum_tpu_torch.ops.flash_decode_q8 import error_bound, flash_decode_q8_attention
from quorum_tpu_torch.ops.sampling import SamplerConfig

OPTS = {"dtype": "float32"}
GREEDY, GREEDY_J = SamplerConfig(temperature=0.0), JaxSampler(temperature=0.0)
TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _models(name, extra=None, quant=False, seed=3):
    opts = {**OPTS, **(extra or {})}
    jspec, tspec = jax_resolve_spec(name, opts), resolve_spec(name, opts)
    jparams = jax_init_params(jspec, seed=seed)
    if quant:
        jparams = jax_quantize_params(jparams)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jspec, jparams, tspec, tparams


# The f32 values the two frameworks quantize agree within this share of
# their row's largest magnitude (the scales, amax/127, agree within it), so
# as multiples of the scale they lie within 127·BOUNDARY of each other.
BOUNDARY = 1e-5


def at_boundary(u: torch.Tensor) -> torch.Tensor:
    """Entries of x/s within 127·BOUNDARY of a half-integer: the only
    values the two frameworks may round one int8 step apart."""
    return (u - torch.floor(u) - 0.5).abs() <= 127 * BOUNDARY


class QuantSpy:
    """Every ``quantize_rows`` call the port makes along the last axis while
    installed: activations (``models/quant.py``), cache writes
    (``models/transformer.py``, ``where="transformer"``) and
    ``decode_attention_q8``'s q and probabilities (``ops/attention.py``).
    Each call keeps its leading shape, its int8 rows, its scales and its
    x/s rows."""

    def __init__(self, monkeypatch):
        self.calls = []
        for mod in (tq, ttf, tattn):
            monkeypatch.setattr(mod, "quantize_rows",
                                self._spy(mod.__name__.rsplit(".", 1)[-1], mod.quantize_rows))

    def _spy(self, where, fn):
        def quantize_rows(x, axis=-1):
            q8, s = fn(x, axis)
            if axis in (-1, x.dim() - 1):
                n = x.shape[-1]
                u = x.detach().float().reshape(-1, n) / s.reshape(-1, 1)
                self.calls.append({"where": where, "lead": tuple(x.shape[:-1]),
                                   "q8": q8.reshape(-1, n), "s": s.reshape(-1), "u": u})
            return q8, s
        return quantize_rows

    def written(self) -> dict:
        """(scale bytes, int8 row bytes) → boundary entries of that row, for
        every row the port's cache writes quantized."""
        out = {}
        for c in self.calls:
            if c["where"] == "transformer":
                s, q8, edge = c["s"].numpy(), c["q8"].numpy(), at_boundary(c["u"]).numpy()
                for i in range(len(s)):
                    out[(s[i].tobytes(), q8[i].tobytes())] = edge[i]
        return out


@pytest.fixture
def spy(monkeypatch):
    return QuantSpy(monkeypatch)


def _same_cache(tside, jside, what, spy):
    """Scales within 1e-5 relative and int8 values equal, except that an
    entry whose f32 input sat at a rounding boundary in the port's own
    quantization (``spy``) may land one step from JAX's: the two
    frameworks sum in different orders, so their inputs agree only within
    BOUNDARY of the row's amax. Any other difference fails, naming it."""
    t8, ts = tside
    j8, js = (np.asarray(x) for x in jside)
    assert t8.dtype == torch.int8 and ts.dtype == torch.float32, what
    np.testing.assert_allclose(ts.numpy(), js, rtol=1e-5, atol=0, err_msg=f"{what} scales")
    diff = np.abs(t8.numpy().astype(np.int32) - j8.astype(np.int32))
    assert diff.max() <= 1, f"{what}: an int8 value differs by {diff.max()} steps"
    if not diff.any():
        return
    written, t8n, tsn = spy.written(), t8.numpy(), ts.numpy()
    for idx in map(tuple, np.argwhere(diff)):
        edge = written.get((tsn[idx[:-1]].tobytes(), t8n[idx[:-1]].tobytes()))
        assert edge is not None, f"{what}: {idx} differs; no recorded write made its row"
        assert edge[idx[-1]], f"{what}: {idx} differs one step away from a rounding boundary"


# ---- ops ---------------------------------------------------------------------

@pytest.mark.parametrize("shape,axis", [((3, 4, 9, 16), -1), ((5, 33), -1), ((2, 4, 7), -2)])
def test_quantize_rows_matches_jax(shape, axis):
    x = _np(1, *shape) * 3.0
    x[0] = 0.0  # an all-zero row takes the 1e-30 floor
    j8, js = jax_quantize_rows(jnp.asarray(x), axis=axis)
    t8, ts = quantize_rows(torch.from_numpy(x), axis=axis)
    assert t8.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(t8.numpy(), np.asarray(j8))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7, atol=0)


def _q8_inputs(b, h, kv, t, hd, seed=0):
    q = _np(seed, b, h, 1, hd)
    k8, ks = jax_quantize_rows(jnp.asarray(_np(seed + 1, b, kv, t, hd)), axis=-1)
    v8, vs = jax_quantize_rows(jnp.asarray(_np(seed + 2, b, kv, t, hd) * 2), axis=-1)
    return q, np.array(k8), np.array(ks)[..., 0], np.array(v8), np.array(vs)[..., 0]


@pytest.mark.parametrize("lens,window", [([1, 37, 64, 100], 0), ([1, 37, 64, 100], 16),
                                         ([5, 128, 90, 1], 64)],
                         ids=["full", "window16", "window64"])
def test_decode_attention_q8_matches_jax(lens, window):
    q, k8, ks, v8, vs = _q8_inputs(4, 4, 2, 128, 16)
    lengths = np.array(lens, np.int32)
    want = jax_decode_attention_q8(jnp.asarray(q), jnp.asarray(k8), jnp.asarray(ks),
                                     jnp.asarray(v8), jnp.asarray(vs), jnp.asarray(lengths),
                                     window=window)
    args = [torch.from_numpy(x) for x in (q, k8, ks, v8, vs, lengths)]
    got = decode_attention_q8(*args, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    # the wrapper takes the plain version for CPU tensors and counts nothing
    n = flash_decode_q8_attention.launches
    assert torch.equal(flash_decode_q8_attention(*args, window=window), got)
    assert flash_decode_q8_attention.launches == n


def test_quantize_rows_rounds_half_to_even():
    """Ties round to even, as ``jnp.round``: amax 127 makes the scale 1,
    so the row's values are its own x/s."""
    x = np.array([[127.0, 2.5, -3.5, 0.5, 1.5, -0.5, 126.5]], np.float32)
    t8, ts = quantize_rows(torch.from_numpy(x))
    assert float(ts) == 1.0
    assert t8.tolist() == [[127, 2, -4, 0, 2, 0, 126]]
    assert t8.numpy().tolist() == np.asarray(jax_quantize_rows(jnp.asarray(x))[0]).tolist()


def _merged_splits(q, k8, ks, v8, vs, lengths, window, chunk):
    """``decode_attention_q8`` in the kernel's order: per-split (max, Σexp,
    max exp·vs) partials merged in f32, then p = exp(l − m)/Σ quantized by
    the merged amax — the same function, other rounding."""
    b, h, _, d = q.shape
    n_kv, t = k8.shape[1], k8.shape[2]
    q8, qs = quantize_rows(q.reshape(b, n_kv, h // n_kv, 1, d), axis=-1)
    logits = torch.einsum("bkgsd,bktd->bkgst", q8.double(), k8.double()).float()
    logits = (logits * qs * ks[:, :, None, None, :]) * (d ** -0.5)
    ki = torch.arange(t)[None, :]
    valid = (ki < lengths[:, None]) & ((ki >= lengths[:, None] - window) if window else True)
    valid = valid[:, None, None, None, :]
    logits = torch.where(valid, logits, torch.full_like(logits, NEG_INF))
    vsg = vs[:, :, None, None, :]
    m = torch.full(logits.shape[:-1] + (1,), NEG_INF)
    tot, top = torch.zeros_like(m), torch.zeros_like(m)
    for c0 in range(0, t, chunk):
        lc, ok = logits[..., c0:c0 + chunk], valid[..., c0:c0 + chunk]
        mc = lc.amax(-1, keepdim=True)
        ec = torch.where(ok, torch.exp(lc - mc), 0.0)
        mm = torch.maximum(m, mc)
        c1, c2 = torch.exp(m - mm), torch.exp(mc - mm)
        tot = tot * c1 + ec.sum(-1, keepdim=True) * c2
        top = torch.maximum(top * c1, (ec * vsg[..., c0:c0 + chunk]).amax(-1, keepdim=True) * c2)
        m = mm
    pv = torch.where(valid, torch.exp(logits - m) / tot, 0.0) * vsg
    ps = torch.clamp_min(top / tot, 1e-30) / 127.0
    p8 = torch.clamp(torch.round(pv / ps), -127, 127)
    out = torch.einsum("bkgst,bktd->bkgsd", p8.double(), v8.double()).float() * ps
    return out.reshape(b, h, 1, d).to(q.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2q8_error_bound_admits_the_kernels_order_and_catches_dropped_keys(dtype):
    """``error_bound`` (the limit chip_smoke.py and the card tests hold K2q8
    to) admits the same function computed in the kernel's order, and
    rejects a kernel that drops its first split or the key at the window's
    start."""
    q, k8, ks, v8, vs = (torch.from_numpy(x) for x in _q8_inputs(4, 8, 2, 1024, 64, seed=3))
    q = q.to(dtype)
    lengths = torch.tensor([1, 100, 700, 1023])
    for window in (0, 512):
        bound = error_bound(q, k8, ks, v8, vs, lengths, window)
        ref = decode_attention_q8(q, k8, ks, v8, vs, lengths, window).float()
        for chunk in (64, 128, 320):
            got = _merged_splits(q, k8, ks, v8, vs, lengths, window, chunk).float()
            assert bool(((got - ref).abs() <= bound).all()), (window, chunk)
        # the first 64-key split of the longest range dropped; its first key dropped
        span = window or 1023
        for drop in (64, 1):
            bad = decode_attention_q8(q, k8, ks, v8, vs, lengths, span - drop).float()
            assert bool(((bad - ref).abs() > bound).any()), (window, drop)


def test_init_cache_int8_sides():
    spec = resolve_spec("llama-tiny", OPTS)
    ck, cv = ttf.init_cache(spec, 3, kv_quant="int8")
    jck, _ = jtf.init_cache(jax_resolve_spec("llama-tiny", OPTS), 3, kv_quant="int8")
    for side in (ck, cv):
        assert isinstance(side, tuple) and side[0].dtype == torch.int8
        assert side[1].dtype == torch.float32
        assert tuple(side[0].shape) == tuple(jck[0].shape)
        assert tuple(side[1].shape) == tuple(jck[1].shape)


# ---- the forward -------------------------------------------------------------

PRESETS = [("llama-tiny", {}), ("gpt2-tiny", {}), ("gemma-tiny", {}),
           ("mixtral-tiny", {}), ("llama-tiny", {"sliding_window": "8"})]
IDS = ["llama", "gpt2", "gemma", "mixtral", "llama-window"]


def _greedy_fns():
    def jax_greedy(logits, live, carry):
        return jnp.argmax(logits, axis=-1).astype(jnp.int32), carry, ()

    def torch_greedy(logits, live, carry):
        return torch.argmax(logits, dim=-1), carry, ()

    return jax_greedy, torch_greedy


@pytest.mark.parametrize("quant", [False, True], ids=["bf16w", "int8w"])
@pytest.mark.parametrize("name,extra", PRESETS, ids=IDS)
def test_prefill_and_decode_chunk_with_int8_cache_match_jax(name, extra, quant, spy):
    """Rows prefilled into slots 0 and 2 (slot 1 dead: its masked writes
    must not touch the cache), then a 5-step chunk in which row 2's budget
    ends: logits, tokens, finish state and the int8 caches."""
    jspec, jparams, tspec, tparams = _models(name, extra, quant)
    jck, jcv = jtf.init_cache(jspec, 3, kv_quant="int8")
    tck, tcv = ttf.init_cache(tspec, 3, kv_quant="int8")
    first, lens = {}, {0: 13, 2: 9}
    for slot, seed in ((0, 1), (2, 2)):
        toks = np.random.default_rng(seed).integers(3, tspec.vocab_size, (1, 16)).astype(np.int32)
        n = np.array([lens[slot]], np.int32)
        jl, jck, jcv = jtf.prefill(jparams, jspec, jnp.asarray(toks), jnp.asarray(n), jck, jcv,
                                   slot=jnp.int32(slot))
        tl, tck, tcv = ttf.prefill(tparams, tspec, torch.from_numpy(toks).long(),
                                   torch.from_numpy(n), tck, tcv, slot=slot)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
        first[slot] = int(np.argmax(np.asarray(jl)[0]))
    _same_cache(tck, jck, "prefill cache_k", spy)
    _same_cache(tcv, jcv, "prefill cache_v", spy)
    jg, tg = _greedy_fns()
    token = np.array([first[0], 0, first[2]], np.int32)
    lengths = np.array([lens[0], 0, lens[2]], np.int32)
    live = np.array([True, False, True])
    budget = np.array([6, 0, 3], np.int32)
    eos = np.array([-1, -1, -1], np.int32)
    j = jtf.decode_chunk(jparams, jspec, 5, jnp.asarray(token), jnp.asarray(lengths),
                         jnp.asarray(live), jnp.asarray(budget), jnp.asarray(eos),
                         jck, jcv, jg, (), flash="")
    t = ttf.decode_chunk(tparams, tspec, 5, torch.from_numpy(token).long(),
                         torch.from_numpy(lengths), torch.from_numpy(live),
                         torch.from_numpy(budget), torch.from_numpy(eos), tck, tcv, tg, ())
    assert t[0].numpy()[[0, 2]].tolist() == np.asarray(j[0])[[0, 2]].tolist()
    for i in (1, 2, 3, 4, 7):
        assert t[i].numpy().tolist() == np.asarray(j[i]).tolist(), i
    _same_cache(t[5], j[5], "decode cache_k", spy)
    _same_cache(t[6], j[6], "decode cache_v", spy)


@pytest.mark.parametrize("name,quant", [("llama-tiny", False), ("llama-tiny", True),
                                        ("gpt2-tiny", True), ("gemma-tiny", True),
                                        ("mixtral-tiny", True)],
                         ids=["llama-bf16w", "llama-int8w", "gpt2-int8w", "gemma-int8w",
                              "mixtral-int8w"])
def test_decode_loop_with_int8_cache_matches_jax(name, quant, spy):
    jspec, jparams, tspec, tparams = _models(name, None, quant)
    jck, jcv = jtf.init_cache(jspec, 2, kv_quant="int8")
    tck, tcv = ttf.init_cache(tspec, 2, kv_quant="int8")
    toks = np.random.default_rng(5).integers(3, tspec.vocab_size, (2, 16)).astype(np.int32)
    n = np.array([16, 7], np.int32)
    jl, jck, jcv = jtf.prefill(jparams, jspec, jnp.asarray(toks), jnp.asarray(n), jck, jcv)
    _, tck, tcv = ttf.prefill(tparams, tspec, torch.from_numpy(toks).long(),
                              torch.from_numpy(n), tck, tcv)
    jg, tg = _greedy_fns()
    token = np.argmax(np.asarray(jl), -1).astype(np.int32)
    live, budget, eos = np.array([True, True]), np.array([11, 3], np.int32), \
        np.array([-1, -1], np.int32)
    j = jtf.decode_loop(jparams, jspec, 4, 4, jnp.asarray(token), jnp.asarray(n),
                        jnp.asarray(live), jnp.asarray(budget), jnp.asarray(eos), jck, jcv,
                        jg, (), flash="")
    t = ttf.decode_loop(tparams, tspec, 4, 4, torch.from_numpy(token).long(),
                        torch.from_numpy(n), torch.from_numpy(live), torch.from_numpy(budget),
                        torch.from_numpy(eos), tck, tcv, tg, ())
    jv = np.asarray(j[1])
    assert t[1].numpy().tolist() == jv.tolist()
    jt_, tt_ = np.asarray(j[0]), t[0].numpy()
    for c in range(4):
        for r in range(2):
            k = jv[c, r]
            assert tt_[c, r, :k].tolist() == jt_[c, r, :k].tolist(), (c, r)
    assert t[7].numpy().tolist() == np.asarray(j[7]).tolist()
    _same_cache(t[5], j[5], "loop cache_k", spy)
    _same_cache(t[6], j[6], "loop cache_v", spy)


def test_prefill_segment_with_int8_cache_matches_jax(spy):
    """A 40-token prompt as a 32-token single-shot prefix plus an 8-token
    segment at offset 32 (dequantized history): the row and the next
    decode step's logits."""
    jspec, jparams, tspec, tparams = _models("llama-tiny")
    toks = np.random.default_rng(7).integers(3, tspec.vocab_size, (1, 40)).astype(np.int32)
    jck, jcv = jtf.init_cache(jspec, 2, kv_quant="int8")
    tck, tcv = ttf.init_cache(tspec, 2, kv_quant="int8")
    head = np.array([32], np.int32)
    _, jck, jcv = jtf.prefill(jparams, jspec, jnp.asarray(toks[:, :32]), jnp.asarray(head),
                              jck, jcv, slot=jnp.int32(1))
    ttf.prefill(tparams, tspec, torch.from_numpy(toks[:, :32]).long(), torch.from_numpy(head),
                tck, tcv, slot=1)
    seg = toks[:, 32:40]
    jck, jcv = jtf.prefill_segment(jparams, jspec, jnp.asarray(seg), jnp.int32(32),
                                   jnp.int32(8), jck, jcv, jnp.int32(1), history=64)
    ttf.prefill_segment(tparams, tspec, torch.from_numpy(seg).long(), [32], tck, tcv, [1],
                        history=64, n_valid=[8])
    _same_cache(tck, jck, "segment cache_k", spy)
    _same_cache(tcv, jcv, "segment cache_v", spy)
    tok, pos = np.array([0, int(toks[0, 39])], np.int32), np.array([0, 39], np.int32)
    wm = np.array([False, True])
    jl, _, _ = jtf.decode_step(jparams, jspec, jnp.asarray(tok), jnp.asarray(pos), jck, jcv,
                               write_mask=jnp.asarray(wm))
    tl, _, _ = ttf.decode_step(tparams, tspec, torch.from_numpy(tok).long(),
                               torch.from_numpy(pos), tck, tcv, write_mask=torch.from_numpy(wm))
    np.testing.assert_allclose(tl.numpy()[1], np.asarray(jl)[1], atol=TOL, rtol=TOL)


# ---- engines -----------------------------------------------------------------

def _min_margin(jparams, jspec, prompt, generated) -> float:
    """Smallest top-1 − top-2 gap of the JAX logits over the generated
    positions (the cache-free forward of the whole sequence)."""
    seq = jnp.asarray([prompt + generated[:-1]])
    logits = np.asarray(jtf.forward_logits(jparams, jspec, seq))[0, len(prompt) - 1:]
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


PROMPTS = [[5, 9, 33, 7, 81], list(range(40, 71)), [100, 3, 3, 200, 17, 4, 4]]
BUDGETS = [12, 9, 14]


@pytest.mark.parametrize("knobs", [
    {"kv_quant": "int8"},
    {"kv_quant": "int8", "quant": "int8"},
    {"kv_quant": "int8", "prefill_chunk": 16},
    {"kv_quant": "int8", "quant": "int8", "prefill_chunk": 0, "decode_loop": 4},
], ids=["kv", "kv+w", "kv-chunk16", "kv+w-single-loop4"])
@pytest.mark.parametrize("name", ["llama-tiny", "mixtral-tiny"])
def test_greedy_engine_streams_match_jax(name, knobs):
    jspec, jparams, tspec, tparams = _models(name, seed=4)
    ref = jax_quantize_params(jparams) if knobs.get("quant") else jparams
    # the JAX engine quantizes params= in place (its inputs are donated): a copy
    jeng = JaxEngine(jspec, params=jax.tree.map(jnp.copy, jparams), **knobs)
    teng = InferenceEngine(tspec, device="cpu", params=tparams, **knobs)
    try:
        want = _concurrently([
            (lambda p=p, n=n: jeng.generate(p, max_new_tokens=n, sampler=GREEDY_J).token_ids)
            for p, n in zip(PROMPTS, BUDGETS)])
        for p, w in zip(PROMPTS, want):
            assert _min_margin(ref, jspec, p, w) > 1e-4, "a near tie: pick another prompt"
        got = _concurrently([
            (lambda p=p, n=n: teng.generate(p, max_new_tokens=n, sampler=GREEDY).token_ids)
            for p, n in zip(PROMPTS, BUDGETS)])
        assert got == want
        assert isinstance(teng._ck, tuple) and teng._ck[0].dtype == torch.int8
        if knobs.get("prefill_chunk") == 16:
            assert teng.metrics()["prefill_segments_total"] >= 2  # the 31-token prompt
    finally:
        jeng.shutdown()
        teng.shutdown()


@pytest.mark.parametrize("stack", ["members", "ensemble"])
def test_stacked_int8_engines_match_jax(stack):
    """The JAX ``members=3`` / ``ensemble=3`` engine with both knobs → its
    quantized weights read back and converted → the port's engine: greedy
    streams equal."""
    jspec, tspec = jax_resolve_spec("llama-tiny", OPTS), resolve_spec("llama-tiny", OPTS)
    knobs = {stack: 3, "quant": "int8", "kv_quant": "int8", "decode_chunk": 4, "n_slots": 2}
    jeng = JaxEngine(jspec, seed=5, **knobs)
    try:
        params = stacked_params_from_numpy(jax.tree.map(np.asarray, jeng.params), device="cpu")
        assert params["blocks"]["wq"]["q8"].dtype == torch.int8
        teng = InferenceEngine(tspec, device="cpu", params=params, **knobs)
        try:
            if stack == "members":
                want = [jeng.generate(p, max_new_tokens=10, sampler=GREEDY_J,
                                      member=m).token_ids for m, p in enumerate(PROMPTS)]
                got = [teng.generate(p, max_new_tokens=10, sampler=GREEDY,
                                     member=m).token_ids for m, p in enumerate(PROMPTS)]
            else:
                want = [jeng.generate(p, max_new_tokens=10, sampler=GREEDY_J).token_ids
                        for p in PROMPTS]
                got = [teng.generate(p, max_new_tokens=10, sampler=GREEDY).token_ids
                       for p in PROMPTS]
            assert got == want
        finally:
            teng.shutdown()
    finally:
        jeng.shutdown()


def test_int8_cache_tensors_are_updated_in_place():
    """A decode graph keeps the addresses it captured: every admission
    route and dispatch writes the int8 cache's values and scales in place."""
    spec = resolve_spec("llama-tiny", OPTS)
    eng = InferenceEngine(spec, device="cpu", seed=1, quant="int8", kv_quant="int8",
                          decode_chunk=4, decode_loop=4, prefill_chunk=16)
    try:
        before = [(t, t.data_ptr()) for t in (*eng._ck, *eng._cv)]
        long_prompt = [(3 + 11 * i) % 500 for i in range(40)]
        _concurrently([
            lambda: eng.generate([5, 6, 7], max_new_tokens=20, sampler=GREEDY),
            lambda: eng.generate(long_prompt, max_new_tokens=9,
                                 sampler=SamplerConfig(temperature=0.8), seed=3)])
        m = eng.metrics()
        assert m["prefill_segments_total"] > 0 and m["admission_dispatches_total"] > 0
        after = (*eng._ck, *eng._cv)
        assert all(t is a and a.data_ptr() == p for (t, p), a in zip(before, after))
        assert int(eng._ck[0].abs().sum()) > 0 and float(eng._cv[1].sum()) > 0
    finally:
        eng.shutdown()


def test_kv_quant_chunked_prefill_and_prefix_reuse_exact():
    """JAX's scenario: long prompts ride chunked prefill into an int8 cache,
    and a warm request reusing resident int8 rows equals the cold engine's
    stream (identical stored bytes → identical reads)."""
    spec = resolve_spec("llama-tiny", {"max_seq": "128"})
    kw0 = dict(device="cpu", seed=2, decode_chunk=4, n_slots=1, prefill_chunk=16,
               kv_quant="int8")
    cold = InferenceEngine(spec, prefix_cache=False, **kw0)
    warm = InferenceEngine(spec, **kw0)
    try:
        prompt = [(7 + 3 * i) % 500 for i in range(50)]
        follow = prompt + [9, 8, 7]
        kw = dict(max_new_tokens=6, sampler=SamplerConfig(temperature=0.7), seed=4)
        want_first = cold.generate(prompt, **kw).token_ids
        want_follow = cold.generate(follow, **kw).token_ids
        assert warm.generate(prompt, **kw).token_ids == want_first
        assert warm.generate(follow, **kw).token_ids == want_follow
        assert warm.prefix_hits >= 1
    finally:
        cold.shutdown()
        warm.shutdown()


def test_quorum_dedup_refuses_kv_quant_with_the_jax_message():
    spec = resolve_spec("llama-tiny", OPTS)
    kw = dict(members=2, member_seeds="shared", quorum_dedup=True, kv_quant="int8")
    with pytest.raises(ValueError) as jerr:
        JaxEngine(jax_resolve_spec("llama-tiny", OPTS), **kw)
    with pytest.raises(ValueError) as terr:
        InferenceEngine(spec, device="cpu", **kw)
    assert str(terr.value) == str(jerr.value)
    assert "kv_quant=int8" in str(terr.value)


@pytest.mark.parametrize("value", ["int4", "fp8"])
def test_unknown_kv_quant_is_refused_with_the_jax_message(value):
    with pytest.raises(ValueError) as jerr:
        JaxEngine(jax_resolve_spec("llama-tiny", OPTS), kv_quant=value)
    with pytest.raises(ValueError) as terr:
        InferenceEngine(resolve_spec("llama-tiny", OPTS), device="cpu", kv_quant=value)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="unsupported kv_quant mode"):
        CudaBackend.from_spec(_spec(
            f"cuda://llama-tiny?device=cpu&kv_quant={value}"))


def _spec(url: str) -> BackendSpec:
    return BackendSpec(name="m", url=url, model="m")


def test_kv_quant_url_builds_its_own_engine():
    """``kv_quant`` is structural: the same model with and without it are
    two engines; two backends with it share one."""
    base = "cuda://llama-tiny?device=cpu&n_layers=1&slots=1"
    shutdown_all_engines()  # engines an earlier file on this worker left cached
    try:
        plain = CudaBackend.from_spec(_spec(base))
        q1 = CudaBackend.from_spec(_spec(base + "&kv_quant=int8"))
        q2 = CudaBackend.from_spec(_spec(base + "&kv_quant=int8&max_tokens=3"))
        assert q1.engine is q2.engine and q1.engine is not plain.engine
        assert q1.engine.kv_quant == "int8" and plain.engine.kv_quant is None
        assert isinstance(q1.engine._ck, tuple)
        assert len(engine_mod._ENGINES) == 2
        with pytest.raises(ValueError, match="kv_quant=int8"):
            CudaBackend.from_spec(_spec(
                base + "&members=2&member_seeds=shared&quorum_dedup=1&kv_quant=int8"))
    finally:
        shutdown_all_engines()
