"""Draft-model speculative decoding on the port's engine (``draft_spec``,
``spec_model=``, ``spec_ckpt=``; engine ``_DraftRuntime`` and the fused
draft→verify program): the CPU counterparts of the JAX package's
tests/test_draft_model.py (slow there).

A small model proposes each verify turn's draft; a token is accepted only
when it equals the target's own, so the content never depends on the
draft. Pinned here: an oracle draft (the target's own spec and seed)
reproduces the plain engine's greedy stream and accepts most drafts; a
useless draft (another seed) changes nothing; co-batched drafted requests
equal serial ones; the construction guards and the URL knobs (the target's
window reaches the draft; ``ckpt=`` + ``spec_model=`` refused); a
``spec_ckpt=`` checkpoint (written with ``transformers``' ``save_pretrained``
as the loader tests write one) drafts exactly, as an oracle and with other
weights; a draft row resynced near the window cap keeps its cache; an
explicit ``spec_decode=0`` beside a draft is refused; a draft over an int8
target is exact; a constrained request through the fused loop (greedy and
sampled) streams the plain engine's tokens with its masked-entry count. Greedy streams compare exactly here: the oracle's ingest
runs the verify's own width, and at float32 no near-tie flips on these
prompts. llama-tiny, float32.
"""

import asyncio

import pytest
import torch

from quorum_tpu_torch.backends.cuda_backend import CudaBackend
from quorum_tpu_torch.config import BackendSpec
from quorum_tpu_torch.engine.engine import InferenceEngine, _DraftRuntime, shutdown_all_engines
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.ops.sampling import SamplerConfig

GREEDY = SamplerConfig(temperature=0.0)
OPTS = {"dtype": "float32", "n_kv_heads": "4", "max_seq": "256"}
SPEC = resolve_spec("llama-tiny", OPTS)
PROMPT = [3, 4, 5, 6, 7, 8]
BASE = "cuda://llama-tiny?device=cpu&dtype=float32&n_kv_heads=4&max_seq=256"


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def engines():
    made = []

    def make(spec=SPEC, **kw):
        eng = InferenceEngine(spec, device="cpu", **kw)
        made.append(eng)
        return eng

    yield make
    for e in made:
        e.shutdown()


def _serve(engine, n=24, prompt=PROMPT):
    return engine.generate(prompt, max_new_tokens=n, sampler=GREEDY, seed=7).token_ids


@pytest.mark.parametrize("loop", [1, 4])
def test_oracle_draft_matches_and_accelerates(engines, loop):
    ref = _serve(engines(decode_chunk=4, n_slots=2))
    drafted = engines(decode_chunk=4, n_slots=2, decode_loop=loop, spec_decode=4,
                      draft_spec=SPEC, draft_seed=0)
    assert _serve(drafted) == ref
    m = drafted.metrics()
    assert 0 < m["spec_turns_total"] < 24
    assert m["spec_accepted_total"] >= 2 * m["spec_turns_total"], m
    assert any(k[0] == "spec_loop" for k in drafted.dispatched_keys)


def test_useless_draft_is_harmless(engines):
    ref = _serve(engines(decode_chunk=4, n_slots=2), n=12)
    drafted = engines(decode_chunk=4, n_slots=2, spec_decode=4, draft_spec=SPEC, draft_seed=99)
    assert _serve(drafted, n=12) == ref


def test_cobatched_drafted_requests_match_serial(engines):
    from concurrent.futures import ThreadPoolExecutor

    prompts = [PROMPT, [9, 10, 11], list(range(3, 40))]
    base = engines(decode_chunk=4, n_slots=3)
    ref = [_serve(base, n=10, prompt=p) for p in prompts]
    drafted = engines(decode_chunk=4, n_slots=3, spec_decode=4, draft_spec=SPEC, draft_seed=0)
    with ThreadPoolExecutor(max_workers=3) as ex:
        got = list(ex.map(lambda p: _serve(drafted, n=10, prompt=p), prompts))
    assert got == ref


def test_guards_fail_at_construction():
    small_window = resolve_spec("llama-tiny", dict(OPTS, max_seq="128"))
    other_vocab = resolve_spec("gpt2-tiny", {"max_seq": "256", "vocab_size": "1024"})
    with pytest.raises(ValueError, match="draft model max_seq 128 < target max_seq 256"):
        InferenceEngine(SPEC, device="cpu", spec_decode=4, draft_spec=small_window)
    with pytest.raises(ValueError, match="draft model vocab 1024 != target vocab 512"):
        InferenceEngine(SPEC, device="cpu", spec_decode=4, draft_spec=other_vocab)
    for knob in ({"members": 2}, {"ensemble": 2}):
        with pytest.raises(ValueError, match="does not compose with members/ensemble"):
            InferenceEngine(SPEC, device="cpu", spec_decode=4, draft_spec=SPEC, **knob)


def _complete(be, n=8):
    body = {"model": "m", "temperature": 0.0, "max_tokens": n,
            "messages": [{"role": "user", "content": "hello there, hello there"}]}
    result = asyncio.run(be.complete(body, {}, 60.0))
    assert result.ok, result.body
    return result


def test_backend_url_knob_and_target_window():
    try:
        be = CudaBackend.from_spec(BackendSpec(
            name="D", url=f"{BASE}&sliding_window=64&slots=2&spec_model=llama-tiny"
                          "&spec_seed=0&max_tokens=8", model="m"))
        eng = be.engine
        assert eng.spec_decode == 4  # implied by the draft
        draft, target = eng._draft_rt.spec, eng.spec
        assert draft.sliding_window == target.sliding_window == 64
        assert (draft.max_seq, draft.vocab_size) == (target.max_seq, target.vocab_size)
        assert draft.n_kv_heads == 2  # the preset's own shape otherwise
        result = _complete(be)
        assert result.usage["completion_tokens"] >= 1
        assert eng.metrics()["spec_turns_total"] > 0
        # an explicit spec_decode=G wins over the implied 4; the knobs key engines
        other = CudaBackend.from_spec(BackendSpec(
            name="E", url=f"{BASE}&slots=2&spec_model=llama-tiny&spec_decode=2", model="m"))
        assert other.engine.spec_decode == 2 and other.engine is not eng
    finally:
        shutdown_all_engines()


def test_ckpt_plus_spec_model_rejected():
    with pytest.raises(ValueError, match="spec_model= \\(a random-init draft\\)"):
        CudaBackend.from_spec(BackendSpec(
            name="X", url="cuda://llama-tiny?device=cpu&ckpt=/nonexistent&spec_model=llama-tiny",
            model="m"))


def test_near_window_cap_resync_does_not_corrupt_draft_cache():
    """Pad writes of the advance bites never run past max_seq: a row near
    the cap co-batched with a fresh long prompt keeps its synced positions,
    so its drafts equal a clean runtime's."""
    class R:  # draft_all reads .hist and object identity only
        def __init__(self, hist):
            self.hist = list(hist)

    a = R([(i % 97) + 3 for i in range(245)])
    rt = _DraftRuntime(SPEC, SPEC, rows=2, device="cpu", seed=0)
    rt.draft_all([(0, a)], g=4)
    a.hist.extend([5, 6, 7, 8, 9, 10])  # at 251 = cap − g − 1
    b = R([(i % 89) + 3 for i in range(120)])
    drafts = rt.draft_all([(0, a), (1, b)], g=4)
    clean = _DraftRuntime(SPEC, SPEC, rows=2, device="cpu", seed=0)
    assert drafts[0] == clean.draft_all([(0, a)], g=4)[0]
    # the fused path's resync near the cap: the bites stop at max_seq
    rt.ensure_chain(4)
    near = R([(i % 53) + 3 for i in range(255)])
    rt.resync(1, near, 4)
    assert rt.synced[1] == 254 and int(rt.chain[1, 0]) == near.hist[-1]
    assert int(rt.chain_n[1]) == 1


def test_explicit_spec_decode_zero_with_draft_rejected():
    with pytest.raises(ValueError, match="a draft model requires spec_decode > 0"):
        InferenceEngine(SPEC, device="cpu", spec_decode=0, draft_spec=SPEC)


def _tiny_llama_ckpt(dirpath, seed):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(seed)
    cfg = transformers.LlamaConfig(
        vocab_size=512, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
        rope_theta=10000.0, tie_word_embeddings=False)
    transformers.LlamaForCausalLM(cfg).eval().save_pretrained(dirpath, safe_serialization=True)
    return str(dirpath)


def test_spec_ckpt_oracle_and_other_weights(tmp_path):
    target = _tiny_llama_ckpt(tmp_path / "target", seed=0)
    other = _tiny_llama_ckpt(tmp_path / "other", seed=1)

    def text(url):
        be = CudaBackend.from_spec(BackendSpec(name="C", url=url, model="m"))
        return _complete(be, n=12).content, be.engine

    try:
        base = f"cuda://x?device=cpu&dtype=float32&ckpt={target}&slots=2&max_tokens=12"
        plain, _ = text(base)
        oracle, eng = text(f"{base}&spec_ckpt={target}")
        assert oracle == plain
        m = eng.metrics()
        assert m["spec_turns_total"] > 0
        assert m["spec_accepted_total"] >= 2 * m["spec_turns_total"], m
        assert eng._draft_rt.spec.dtype == "float32"  # the target's dtype
        different, _ = text(f"{base}&spec_ckpt={other}")
        assert different == plain
        # a random-init target takes a checkpoint draft too
        tiny = "cuda://llama-tiny?device=cpu&dtype=float32&max_seq=256&slots=1&max_tokens=6"
        random_plain, _ = text(tiny)
        random_drafted, eng2 = text(f"{tiny}&spec_ckpt={target}")
        assert random_drafted == random_plain and eng2.spec_decode == 4
    finally:
        shutdown_all_engines()


def test_draft_over_int8_target_is_exact(engines):
    ref = _serve(engines(decode_chunk=4, n_slots=2, quant="int8", kv_quant="int8"), n=12)
    drafted = engines(decode_chunk=4, n_slots=2, quant="int8", kv_quant="int8", spec_decode=4,
                      draft_spec=SPEC, draft_seed=0)
    assert _serve(drafted, n=12) == ref
    assert drafted.metrics()["spec_turns_total"] > 0


@pytest.mark.parametrize("temp,seed", [(0.0, 3), (0.8, 11)], ids=["greedy", "sampled"])
def test_fused_loop_constrained_equals_plain(engines, temp, seed):
    """A constrained request on a fused engine (decode_loop=4, an oracle
    draft): the ``("spec_loop", …, "dfa", bucket)`` program masks each
    draft pick and each verified position by its draft-prefix grammar
    state; the stream and the masked-entry count equal the plain
    engine's."""
    from quorum_tpu_torch.constrain import compile_response_format
    from quorum_tpu_torch.engine.tokenizer import ByteTokenizer

    tok = ByteTokenizer(SPEC.vocab_size)
    schema = {"type": "object", "properties": {"ok": {"type": "boolean"},
                                               "n": {"type": "integer"}}}
    grammar = compile_response_format({"type": "json_schema", "json_schema": {"schema": schema}},
                                      tok, SPEC.vocab_size)

    def run(eng):
        req = eng.submit(tok.encode("go"), max_new_tokens=48, sampler=SamplerConfig(
            temperature=temp), seed=seed, eos_id=tok.eos_id, grammar=grammar)
        return list(eng.stream_results(req)), eng.metrics()["constrain_masked_tokens_total"]

    plain = engines(decode_chunk=4, decode_loop=4)
    fused = engines(decode_chunk=4, decode_loop=4, spec_decode=4, draft_spec=SPEC, draft_seed=0)
    assert run(fused) == run(plain)
    assert fused.metrics()["spec_accepted_total"] > 0
    assert any(k[0] == "spec_loop" and "dfa" in k for k in fused.dispatched_keys)
