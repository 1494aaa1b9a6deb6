"""The port's int8 weights (``quant=int8``, ``models/quant.py``) against the
JAX package's ``models/quant.py``.

- ``quantize_leaf`` for every ``QUANT_REDUCE_AXIS`` entry: int8 equal,
  scales within 1e-7 relative; the port's layout (contraction axis last,
  N padded to a multiple of 8) maps back to JAX's leaf exactly; ``dq``.
- Each ``qeinsum`` form against JAX's ``qeinsum`` (its CPU branch, the f32
  GEMM of the integer products) within 1e-5 relative, and a plain leaf
  against the plain product.
- ``init_params(quant="int8")`` (single and member-stacked) is
  ``quantize_params`` of the bf16 init bit for bit.
- ``forward_logits``, ``prefill`` and ``decode_chunk`` on
  ``params_from_numpy(quantize_params(init_params(...)))`` against JAX's
  within 1e-4 (llama, gpt2 with its tied head and learned positions,
  gemma, mixtral); ``stacked_params_from_numpy`` of a quantized stacked
  tree.
- Greedy engine streams against the JAX engine with ``quant=int8``
  (single, ``members=3``; single-shot and 16-token segments, decode_loop
  1 and 4), ruling out near ties first.
- A tiny HF checkpoint loaded with ``quant=int8`` equals the in-memory
  quantized tree; the URL, engine keys and the ``quant=int4`` refusal.

float32 models: tolerances test the algorithm, not bf16 rounding. One
effect is no fault: the f32 values an activation quantizer reads come out
of XLA's and PyTorch's sums in different orders, so a value at a rounding
boundary can land one int8 step apart, and the logits downstream of that
row move by up to a few 1e-2. The test records both sides' activation
quantizations (``QuantSpy``, ``JaxActs``) and pairs them call by call
(``_flip_reach``): every int8 entry that differs must differ by one step
and, unless an earlier flip already reaches its position, sit at a
rounding boundary on both sides. ``_close`` lets only the positions those
flips reach (their own and the later ones of their row) move beyond 1e-4.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quorum_tpu.engine.engine import InferenceEngine as JaxEngine
from quorum_tpu.models import quant as jq
from quorum_tpu.models import transformer as jtf
from quorum_tpu.models.init import init_params as jax_init_params
from quorum_tpu.models.model_config import resolve_spec as jax_resolve_spec
from quorum_tpu.ops.sampling import SamplerConfig as JaxSampler
from quorum_tpu_torch.backends import cuda_backend
from quorum_tpu_torch.backends.cuda_backend import CudaBackend
from quorum_tpu_torch.config import BackendSpec
from quorum_tpu_torch.engine import engine as engine_mod
from quorum_tpu_torch.engine.engine import InferenceEngine, shutdown_all_engines
from quorum_tpu_torch.models import quant as tq
from quorum_tpu_torch.models import transformer as ttf
from quorum_tpu_torch.models.convert import params_from_numpy, stacked_params_from_numpy
from quorum_tpu_torch.models.init import init_params, init_params_stacked
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.ops.sampling import SamplerConfig
from tests.test_torch_kv_quant import BOUNDARY, QuantSpy

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


@pytest.fixture
def spy(monkeypatch):
    return QuantSpy(monkeypatch)


def _close(got, want, what, reach):
    """Within 1e-4 at every position (all axes but the last) except where
    ``reach`` is set (:func:`_reach`); there an activation's one-step
    rounding difference may move values by up to 0.1."""
    err = np.abs(np.asarray(got) - np.asarray(want)).max(axis=-1)
    off = err > TOL * (1 + np.abs(np.asarray(want)).max(axis=-1))
    stray = np.argwhere(off & ~reach)
    assert not len(stray) and err.max() <= 0.1, \
        f"{what}: positions {stray[:5].tolist()} off with no boundary upstream, " \
        f"largest errors {np.sort(err.ravel())[-3:]}"


class JaxActs:
    """JAX's activation quantizations in call order: the x/s and int8 rows
    of every distinct x its ``qeinsum`` quantizes (q/k/v and gate/up share
    one x, which the port quantizes once). Values are concrete only
    outside jit: run the JAX side under ``jax.disable_jit()``."""

    def __init__(self, monkeypatch):
        self.calls = []
        orig = jtf.qeinsum

        def qeinsum(eq, x, leaf):
            if jq.is_quantized(leaf) and not (self.calls and self.calls[-1][0] is x):
                xf = x.astype(jnp.float32)
                xs = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True), 1e-30) / 127.0
                u = xf / xs
                x8 = jnp.clip(jnp.round(u), -127, 127).astype(jnp.int8)
                self.calls.append((x, np.asarray(u), np.asarray(x8)))
            return orig(eq, x, leaf)

        monkeypatch.setattr(jtf, "qeinsum", qeinsum)

    def clear(self):
        self.calls.clear()


@pytest.fixture
def jacts(monkeypatch):
    return JaxActs(monkeypatch)


def _flip_reach(spy, jacts, grids):
    """Pairs the port's activation quantizations with JAX's, call by call,
    and returns ``grids`` ({leading shape: positions already reached})
    updated with what their flips reach: rows of a (B, T) activation are
    position t of sequence b, and a flip there reaches t and the later
    positions of b; rows of a (B,) or (B, 1) one are one position per
    sequence. An int8 entry may differ by one step only, and a flip at a
    position no earlier call's flip reaches must sit at a rounding
    boundary: both sides' x/s within 127·BOUNDARY of the half-integer
    between their two values. A flip in an activation whose rows are no
    positions (an expert buffer) fails."""
    port = [c for c in spy.calls if c["where"] == "quant"]
    assert len(port) == len(jacts.calls), (len(port), len(jacts.calls))
    out = {k: v.copy() for k, v in grids.items()}
    for c, (_, ju, j8) in zip(port, jacts.calls):
        p8, pu = c["q8"].numpy().astype(np.int32), c["u"].numpy()
        j8, ju = j8.reshape(p8.shape).astype(np.int32), ju.reshape(pu.shape)
        d = np.abs(p8 - j8)
        assert d.max() <= 1, f"an activation {c['lead']} quantized {d.max()} steps apart"
        if not d.any():
            continue
        lead = c["lead"][:1] if c["lead"][1:] == (1,) else c["lead"]
        assert lead in out, f"a flip in activation rows {c['lead']}, which are no positions"
        half = (p8 + j8) / 2
        edge = (d == 0) | ((np.abs(pu - half) <= 127 * BOUNDARY)
                           & (np.abs(ju - half) <= 127 * BOUNDARY))
        flip = d.any(-1).reshape(lead)
        stray = np.argwhere(flip & ~edge.all(-1).reshape(lead) & ~out[lead])
        assert not len(stray), f"activation {c['lead']}: rows {stray[:5].tolist()} flipped " \
                               "away from a rounding boundary"
        out[lead] |= np.maximum.accumulate(flip, axis=-1) if len(lead) == 2 else flip
    return out


def _quantize_jax(w, axis):
    leaf = jq.quantize_leaf(jnp.asarray(w), axis)
    return {k: np.array(v) for k, v in leaf.items()}


def _port_leaf(jleaf, axis):
    return tq.port_layout({k: torch.from_numpy(v) for k, v in jleaf.items()}, axis)


# ---- leaves and products -----------------------------------------------------

SHAPES = {"wq": (2, 64, 64), "wk": (2, 64, 32), "wv": (2, 64, 32), "wo": (2, 64, 64),
          "w_gate": (2, 64, 128), "w_up": (2, 64, 128), "w_down": (2, 128, 64),
          "moe_w_gate": (2, 4, 64, 128), "moe_w_up": (2, 4, 64, 128),
          "moe_w_down": (2, 4, 128, 64), "lm_head": (64, 509), "tok_emb": (509, 64)}


@pytest.mark.parametrize("name", sorted(tq.QUANT_REDUCE_AXIS))
def test_quantize_leaf_matches_jax(name):
    assert tq.QUANT_REDUCE_AXIS == jq.QUANT_REDUCE_AXIS
    axis = tq.QUANT_REDUCE_AXIS[name]
    w = _np(hash(name) % 1000, *SHAPES[name])
    w[..., 0, :] = 0.0  # all-zero channels take the 1e-30 floor
    want = _quantize_jax(w, axis)
    got = tq.quantize_leaf(torch.from_numpy(w), axis)
    assert got["q8"].dtype == torch.int8 and got["qs"].dtype == torch.float32
    assert np.array_equal(got["q8"].numpy(), want["q8"])
    np.testing.assert_allclose(got["qs"].numpy(), want["qs"], rtol=1e-7, atol=0)
    port = tq.quantize_weight(torch.from_numpy(w), axis)
    assert port["q8"].shape[-2] % 8 == 0 and port["q8"].is_contiguous()
    back = tq.jax_layout(port, axis)
    assert np.array_equal(back["q8"].numpy(), want["q8"])
    assert np.array_equal(back["qs"].numpy(), got["qs"].numpy())
    np.testing.assert_allclose(tq.dq(port, torch.float32, axis).numpy(),
                               np.asarray(jq.dq(jq.quantize_leaf(jnp.asarray(w), axis),
                                                jnp.float32)), rtol=1e-7, atol=0)


def test_padded_rows_are_zero_and_unread():
    """gpt2's 50 257-token vocabulary is no multiple of 8: the port's leaf
    pads q8's rows with zeros, keeps qs at the true N, and a product
    returns exactly N columns."""
    w = _np(3, 509, 64)
    leaf = tq.quantize_weight(torch.from_numpy(w), -1)
    assert tuple(leaf["q8"].shape) == (512, 64) and tuple(leaf["qs"].shape) == (509, 1)
    assert int(leaf["q8"][509:].abs().sum()) == 0
    x = torch.from_numpy(_np(4, 3, 64))
    assert tuple(tq.qeinsum("...d,df->...f", x, leaf).shape) == (3, 509)


# (JAX's form as the id, the port's form, JAX's einsum, x, leaf, w): the tied
# unembed x @ tok_emb.T is the port's x @ w on the [V, D] quantized table
# (a plain table is passed transposed, as ``_unembed`` does).
FORMS = [
    ("...d,df->...f", "...d,df->...f", "btd,df->btf", (2, 5, 64), "w_up", (64, 96)),
    ("mnd,mdf->mnf", "mnd,mdf->mnf", "ecd,edf->ecf", (3, 5, 64), "moe_w_gate", (3, 64, 40)),
    ("nd,edf->enf", "nd,edf->enf", "btd,edf->ebtf", (6, 64), "moe_w_up", (4, 64, 48)),
    ("...d,vd->...v", "...d,df->...f", "...d,vd->...v", (2, 3, 64), "tok_emb", (509, 64)),
]


@pytest.mark.parametrize("form,eq,jeq,xshape,name,wshape", FORMS, ids=[f[0] for f in FORMS])
def test_qeinsum_forms_match_jax(form, eq, jeq, xshape, name, wshape):
    x, w = _np(10, *xshape), _np(11, *wshape)
    axis = tq.QUANT_REDUCE_AXIS[name]
    jx = jnp.asarray(x[None] if eq == "nd,edf->enf" else x)
    want = np.asarray(jq.qeinsum(jeq, jx, jq.quantize_leaf(jnp.asarray(w), axis)))
    if eq == "nd,edf->enf":
        want = want[:, 0]
    got = tq.qeinsum(eq, torch.from_numpy(x), _port_leaf(_quantize_jax(w, axis), axis))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # a pre-quantized x gives the same product; a plain leaf the plain one
    xq = tq.quantize_act(torch.from_numpy(x), _port_leaf(_quantize_jax(w, axis), axis))
    assert torch.equal(tq.qeinsum(eq, torch.from_numpy(x),
                                  _port_leaf(_quantize_jax(w, axis), axis), xq), got)
    plain = np.asarray(jnp.einsum(jeq, jx, jnp.asarray(w)))
    plain = plain[:, 0] if eq == "nd,edf->enf" else plain
    tw = torch.from_numpy(w.T.copy() if form != eq else w)
    np.testing.assert_allclose(tq.qeinsum(eq, torch.from_numpy(x), tw).numpy(),
                               plain, rtol=1e-5, atol=1e-5)


# ---- params ------------------------------------------------------------------

def _tree_equal(a, b, path=""):
    assert set(a) == set(b), path
    for k, x in a.items():
        y = b[k]
        if isinstance(x, dict):
            _tree_equal(x, y, f"{path}/{k}")
        elif x is None:
            assert y is None, f"{path}/{k}"
        else:
            assert x.dtype == y.dtype and torch.equal(x, y), f"{path}/{k}"


@pytest.mark.parametrize("model", ["llama-tiny", "gpt2-tiny", "gemma-tiny", "mixtral-tiny"])
def test_quantized_init_is_quantize_params_of_the_bf16_init(model):
    spec = resolve_spec(model, {})
    _tree_equal(init_params(spec, 7, device="cpu", quant="int8"),
                tq.quantize_params(init_params(spec, 7, device="cpu")))
    if not spec.is_moe:
        _tree_equal(init_params_stacked(spec, [1, 2, 1], device="cpu", quant="int8"),
                    tq.quantize_params(init_params_stacked(spec, [1, 2, 1], device="cpu")))
    q = init_params(spec, 7, device="cpu", quant="int8")
    assert tq.quantized_param_bytes(q) < 0.6 * tq.quantized_param_bytes(
        init_params(spec, 7, device="cpu"))
    assert not tq.is_quantized(q["blocks"].get("router", q["blocks"]["attn_norm_w"]))


def test_converted_quantized_trees_match_the_ports_quantizer():
    """``params_from_numpy`` of JAX's quantized tree equals the port's
    ``quantize_params`` of the converted f32 tree, single and stacked."""
    jspec = jax_resolve_spec("llama-tiny", OPTS)
    jp = jax_init_params(jspec, seed=2)
    f32 = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    _tree_equal(params_from_numpy(jax.tree.map(np.asarray, jq.quantize_params(jp)),
                                  device="cpu"), tq.quantize_params(f32))
    trees = [jax.tree.map(np.asarray, jax_init_params(jspec, seed=s)) for s in (1, 2, 3)]
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *trees)
    got = stacked_params_from_numpy(jax.tree.map(np.asarray, jq.quantize_params(
        jax.tree.map(jnp.asarray, stacked))), device="cpu")
    want = tq.quantize_params(stacked_params_from_numpy(stacked, device="cpu"))
    _tree_equal(got, want)
    assert got["blocks"]["wq"]["q8"].is_contiguous()
    with pytest.raises(ValueError, match="int8"):
        params_from_numpy({"final_norm_w": {"q8": np.zeros(4, np.int8), "qs": np.ones(1)},
                           "blocks": {}}, device="cpu")


PRESETS = [("llama-tiny", {}), ("gpt2-tiny", {}), ("gemma-tiny", {}), ("mixtral-tiny", {})]
IDS = ["llama", "gpt2", "gemma", "mixtral"]


def _models(name, extra=None, seed=3):
    opts = {**OPTS, **(extra or {})}
    jspec, tspec = jax_resolve_spec(name, opts), resolve_spec(name, opts)
    jparams = jq.quantize_params(jax_init_params(jspec, seed=seed))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jspec, jparams, tspec, tparams


@pytest.mark.parametrize("name,extra", PRESETS, ids=IDS)
def test_quantized_forward_prefill_and_decode_match_jax(name, extra, spy, jacts):
    jspec, jparams, tspec, tparams = _models(name, extra)
    toks = np.random.default_rng(4).integers(3, tspec.vocab_size, (2, 20)).astype(np.int32)
    bt = np.zeros((2, 20), bool)
    with jax.disable_jit():
        want = jtf.forward_logits(jparams, jspec, jnp.asarray(toks))
    got = ttf.forward_logits(tparams, tspec, torch.from_numpy(toks).long())
    _close(got.numpy(), want, "forward_logits", _flip_reach(spy, jacts, {(2, 20): bt})[(2, 20)])
    # prefill into a bf16 (here f32) cache, then a 4-step greedy chunk
    lens = np.array([20, 11], np.int32)
    jck, jcv = jtf.init_cache(jspec, 2)
    tck, tcv = ttf.init_cache(tspec, 2)
    spy.calls.clear()
    jacts.clear()
    with jax.disable_jit():
        jl, jck, jcv = jtf.prefill(jparams, jspec, jnp.asarray(toks), jnp.asarray(lens),
                                   jck, jcv)
    tl, tck, tcv = ttf.prefill(tparams, tspec, torch.from_numpy(toks).long(),
                               torch.from_numpy(lens), tck, tcv)
    pre = _flip_reach(spy, jacts, {(2, 20): bt, (2,): np.zeros(2, bool)})
    last = pre[(2, 20)][[0, 1], lens - 1]
    _close(tl.numpy(), jl, "prefill logits", last | pre[(2,)])
    n_seq = tck.shape[3]
    reach = np.concatenate([pre[(2, 20)], np.repeat(pre[(2, 20)][:, -1:], n_seq - 20, axis=1)],
                           axis=1)
    _close(tck.numpy(), jck, "prefill cache_k",
           np.broadcast_to(reach[None, :, None, :], tck.shape[:-1]))

    def jg(logits, live, carry):
        return jnp.argmax(logits, axis=-1).astype(jnp.int32), carry, ()

    def tg(logits, live, carry):
        return torch.argmax(logits, dim=-1), carry, ()

    token = np.argmax(np.asarray(jl), -1).astype(np.int32)
    live, budget, eos = np.array([True, True]), np.array([4, 4], np.int32), \
        np.array([-1, -1], np.int32)
    spy.calls.clear()
    jacts.clear()
    with jax.disable_jit():
        j = jtf.decode_chunk(jparams, jspec, 4, jnp.asarray(token), jnp.asarray(lens),
                             jnp.asarray(live), jnp.asarray(budget), jnp.asarray(eos), jck, jcv,
                             jg, (), flash="")
    t = ttf.decode_chunk(tparams, tspec, 4, torch.from_numpy(token).long(),
                         torch.from_numpy(lens), torch.from_numpy(live),
                         torch.from_numpy(budget), torch.from_numpy(eos), tck, tcv, tg, ())
    assert t[0].numpy().tolist() == np.asarray(j[0]).tolist()
    # a decode flip in sequence b reaches its positions from lens[b] on
    dec = _flip_reach(spy, jacts, {(2,): last})[(2,)]
    reach |= dec[:, None] & (np.arange(n_seq)[None, :] >= lens[:, None])
    _close(t[5].numpy(), j[5], "decode cache_k",
           np.broadcast_to(reach[None, :, None, :], tck.shape[:-1]))


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


@pytest.mark.parametrize("knobs", [{}, {"prefill_chunk": 16, "decode_loop": 4}],
                         ids=["defaults", "chunk16-loop4"])
def test_greedy_quant_engine_streams_match_jax(knobs):
    """JAX's engine gets the f32 weights and ``quant=int8`` (it quantizes
    them); the port's gets the same f32 weights and quantizes them itself."""
    jspec, tspec = jax_resolve_spec("llama-tiny", OPTS), resolve_spec("llama-tiny", OPTS)
    jparams = jax_init_params(jspec, seed=4)
    ref = jq.quantize_params(jparams)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    jeng = JaxEngine(jspec, params=jax.tree.map(jnp.copy, jparams), quant="int8", **knobs)
    teng = InferenceEngine(tspec, device="cpu", params=tparams, quant="int8", **knobs)
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
        assert tq.is_quantized(teng.params["blocks"]["wq"])
        if knobs:
            assert teng.metrics()["prefill_segments_total"] >= 2  # the 31-token prompt
    finally:
        jeng.shutdown()
        teng.shutdown()


def test_members_quant_engine_matches_jax():
    """JAX ``members=3&quant=int8`` (single-shot admission) → its quantized
    weights read back → the port's ``members=3`` engine: every member's
    greedy stream equal, alone and admitted together."""
    jspec, tspec = jax_resolve_spec("llama-tiny", OPTS), resolve_spec("llama-tiny", OPTS)
    knobs = dict(members=3, quant="int8", decode_chunk=4, n_slots=2, prefill_chunk=0)
    jeng = JaxEngine(jspec, seed=5, **knobs)
    try:
        params = stacked_params_from_numpy(jax.tree.map(np.asarray, jeng.params), device="cpu")
        teng = InferenceEngine(tspec, device="cpu", params=params, **knobs)
        try:
            want = [jeng.generate(p, max_new_tokens=10, sampler=GREEDY_J, member=m).token_ids
                    for m, p in enumerate(PROMPTS)]
            got = _concurrently([
                (lambda m=m, p=p: teng.generate(p, max_new_tokens=10, sampler=GREEDY,
                                                member=m).token_ids)
                for m, p in enumerate(PROMPTS)])
            assert got == want
        finally:
            teng.shutdown()
    finally:
        jeng.shutdown()


def _spec(url: str) -> BackendSpec:
    return BackendSpec(name="m", url=url, model="m")


@pytest.mark.parametrize("value", ["int4", "fp8"])
def test_unknown_quant_is_refused_with_the_jax_message(value, monkeypatch):
    with pytest.raises(ValueError) as jerr:
        JaxEngine(jax_resolve_spec("llama-tiny", OPTS), quant=value)
    with pytest.raises(ValueError) as terr:
        InferenceEngine(resolve_spec("llama-tiny", OPTS), device="cpu", quant=value)
    assert str(terr.value) == str(jerr.value) == f"unsupported quant mode {value!r} (int8 or none)"

    def refuse(*a, **k):
        raise AssertionError("an engine was built for a refused URL")

    monkeypatch.setattr(cuda_backend, "get_engine", refuse)
    with pytest.raises(ValueError, match="unsupported quant mode"):
        CudaBackend.from_spec(_spec(f"cuda://llama-tiny?device=cpu&quant={value}"))


def test_quant_urls_key_their_own_engines():
    """``quant`` is weight identity: with and without it are two engines;
    two backends with it share one. Both knobs are served options now."""
    assert not {"quant", "kv_quant"} & cuda_backend._NOT_YET
    base = "cuda://llama-tiny?device=cpu&n_layers=1&slots=1"
    shutdown_all_engines()  # engines an earlier file on this worker left cached
    try:
        plain = CudaBackend.from_spec(_spec(base))
        q1 = CudaBackend.from_spec(_spec(base + "&quant=int8"))
        q2 = CudaBackend.from_spec(_spec(base + "&quant=int8&max_tokens=3"))
        both = CudaBackend.from_spec(_spec(base + "&quant=int8&kv_quant=int8"))
        assert q1.engine is q2.engine and q1.engine is not plain.engine
        assert both.engine not in (q1.engine, plain.engine)
        assert (q1.engine.quant, plain.engine.quant, both.engine.kv_quant) == ("int8", None,
                                                                               "int8")
        assert tq.is_quantized(q1.engine.params["tok_emb"])
        assert len(engine_mod._ENGINES) == 3
    finally:
        shutdown_all_engines()


def test_ckpt_quant_load_equals_the_in_memory_quantized_tree(tmp_path):
    """A tiny HF checkpoint (llama, untied head; gpt2, tied head with fused
    q/k/v) loaded with ``quant=int8`` — quantized tensor by tensor as it
    fills — equals ``quantize_params`` of its f32 load bit for bit, and a
    ``ckpt=…&quant=int8&kv_quant=int8`` backend serves."""
    transformers = pytest.importorskip("transformers")
    from quorum_tpu_torch.models.hf_loader import load_hf_checkpoint

    torch.manual_seed(0)
    small = dict(vocab_size=509, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                 num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64)
    models = {
        "llama": transformers.LlamaForCausalLM(transformers.LlamaConfig(
            **small, tie_word_embeddings=False)),
        "gpt2": transformers.GPT2LMHeadModel(transformers.GPT2Config(
            vocab_size=509, n_positions=64, n_embd=32, n_layer=2, n_head=4)),
    }
    for family, model in models.items():
        path = tmp_path / family
        model.save_pretrained(path, safe_serialization=True)
        _, f32 = load_hf_checkpoint(path, dtype="float32", device="cpu")
        spec, q = load_hf_checkpoint(path, dtype="float32", device="cpu", quant="int8")
        _tree_equal(q, tq.quantize_params(f32), family)
        assert tq.is_quantized(q["tok_emb"]) and q["tok_emb"]["q8"].shape[0] == 512
    try:
        b = CudaBackend.from_spec(_spec(
            f"cuda://tiny?ckpt={tmp_path / 'llama'}&device=cpu&dtype=float32"
            "&quant=int8&kv_quant=int8"))
        assert tq.is_quantized(b.engine.params["blocks"]["wq"])
        out = b.engine.generate([3, 4, 5], max_new_tokens=4, sampler=GREEDY)
        assert len(out.token_ids) == 4
    finally:
        shutdown_all_engines()
