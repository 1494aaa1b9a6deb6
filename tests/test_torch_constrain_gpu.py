"""Constrained decoding inside the decode graphs on the card: every test
here is marked ``gpu`` and skips without a card.

Run on a machine with a card:
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_constrain_gpu.py

- The constrained decode program (masked sampling, DFA advance, masked
  counts; a sampled row and a plain row beside two grammar rows) replayed
  from its CUDA graph equals its eager call from the same state bit for
  bit: tokens, valid and masked counts, DFA states, counts and caches.
- A grammar placed inside the arena's bucket is written in place and read
  by the next replay of the already captured key; one that crosses the
  bucket moves the tables and the next dispatch captures anew on them.
- After an arena reset, a key of the old bucket is captured anew on the
  new tables rather than replayed on the freed ones.
Each stream is held to the same request on a fresh engine, and must walk
its grammar without a dead state.

llama-tiny widened to head_dim 64 (a head size K2 takes).
"""

import pytest
import torch

from quorum_tpu_torch.constrain import compile_response_format
from quorum_tpu_torch.engine.tokenizer import ByteTokenizer
from quorum_tpu_torch.models.init import init_params
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.models.transformer import prefill
from quorum_tpu_torch.ops.sampling import SamplerConfig, gumbel_noise

GREEDY = SamplerConfig(temperature=0.0)


@pytest.fixture
def cuda_device():
    """The card (decided here, never at import: the CPU suite collects this file)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: decode graphs and K2 have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _spec(dtype="float32"):
    return resolve_spec("llama-tiny", {"dtype": dtype, "head_dim": "64", "max_seq": "256"})


def _grammar(spec, rf):
    return compile_response_format(rf, ByteTokenizer(spec.vocab_size), spec.vocab_size)


def _engine(spec, dev, **kw):
    from quorum_tpu_torch.engine.engine import InferenceEngine

    return InferenceEngine(spec, device=dev, seed=1, decode_chunk=4, **kw)


def _run(eng, g, prompt, max_new=24):
    req = eng.submit(prompt, max_new_tokens=max_new, sampler=GREEDY, eos_id=2, grammar=g)
    return list(eng.stream_results(req))


def _walks(g, toks):
    body = [t for t in toks if t != 2]
    end = g.advance_tokens(g.start, body)
    return end >= 0 and (toks[-1] != 2 or bool(g.accept[end]))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_constrained_program_replay_equals_eager(cuda_device, dtype):
    spec = _spec(dtype)
    params = init_params(spec, 0, cuda_device)
    eng = _engine(spec, cuda_device, params=params, n_slots=4, decode_loop=4)
    gen = torch.Generator().manual_seed(5)
    try:
        g_json = _grammar(spec, {"type": "json_object"})
        g_re = _grammar(spec, {"type": "regex", "pattern": "[0-9]{3}-[0-9]{4}"})
        with torch.cuda.stream(eng._stream):
            starts = [eng._ensure_grammar(g_json), eng._ensure_grammar(g_re)]
        lens, first = [17, 30, 40, 5], []
        for row, n in enumerate(lens):
            toks = torch.randint(3, spec.vocab_size, (1, 64), generator=gen).to(cuda_device)
            logits, _, _ = prefill(params, spec, toks, torch.tensor(
                [n], dtype=torch.int32, device=cuda_device), eng._ck, eng._cv, slot=row)
            first.append(int(logits.argmax()))
        eng._token.copy_(torch.tensor(first))
        eng._lengths.copy_(torch.tensor(lens, dtype=torch.int32))
        eng._budget.copy_(torch.tensor([9, 16, 16, 12], dtype=torch.int32))
        eng._live.fill_(True)
        eng._mask.fill_(True)
        eng._eos.fill_(2)
        eng._temp.copy_(torch.tensor([0.0, 0.0, 0.8, 0.0]))
        eng._dfa.copy_(torch.tensor([starts[0], starts[1], starts[0], 0], dtype=torch.int32))
        g = torch.Generator(device=cuda_device).manual_seed(3)
        for k in range(16):
            gumbel_noise(spec.vocab_size, g, out=eng._noise_ring[k, 2])
        key = ("dfa", 4, 4, False, False, eng._g_bucket)
        program = (4, 4, False, False, True)
        names = ("_token", "_lengths", "_live", "_budget", "_counts", "_ntok", "_dfa", "_ck", "_cv")
        start = {n: getattr(eng, n).clone() for n in names}
        with torch.cuda.stream(eng._stream):
            want = eng._decode_program(*program)[0].clone()
            eager = {n: getattr(eng, n).clone() for n in names}
            for n in names:
                getattr(eng, n).copy_(start[n])
            got = eng._graphs.replay(key, lambda: eng._decode_program(*program),
                                     eng._warm_up)[0]
        torch.cuda.synchronize()
        assert got.shape == (4, 4, 4 + 2)
        assert torch.equal(got, want)
        assert all(torch.equal(getattr(eng, n), eager[n]) for n in names)
        masked = got[..., -1]
        assert int(masked[:, 3].sum()) == 0 and int(masked[:, :3].sum()) > 0  # FREE row
        for row, gr in ((0, g_json), (1, g_re), (2, g_json)):  # each row obeys its grammar
            n = int(got[:, row, 4].sum())
            toks = got[:, row, :4].flatten()[:n].tolist()
            assert _walks(gr, toks), (row, toks)
    finally:
        eng.shutdown()


@pytest.mark.gpu
def test_a_grammar_placed_between_replays_is_read(cuda_device):
    spec = _spec()
    eng = _engine(spec, cuda_device, decode_pipeline=2)
    try:
        small = _grammar(spec, {"type": "regex", "pattern": "[0-9]{3}"})  # FREE + 4: bucket 8
        inside = _grammar(spec, {"type": "regex", "pattern": "ab"})  # 3 more: still 8
        past = _grammar(spec, {"type": "json_object"})
        _run(eng, small, [5, 6, 7])
        bucket, table = eng._g_bucket, eng._g_trans.data_ptr()
        assert eng._g_states + inside.n_states <= bucket
        captures = eng.metrics()["decode_graph_captures_total"]
        got_inside = _run(eng, inside, [5, 6, 7])
        # Written in place: the same tables, the captured key replayed.
        assert (eng._g_bucket, eng._g_trans.data_ptr()) == (bucket, table)
        assert eng.metrics()["decode_graph_captures_total"] == captures
        got_past = _run(eng, past, [9, 9], max_new=32)
        assert eng._g_bucket > bucket  # moved: its keys captured anew
        again = _run(eng, inside, [5, 6, 7])
    finally:
        eng.shutdown()
    for g, toks, got_ in ((inside, [5, 6, 7], got_inside), (past, [9, 9], got_past)):
        fresh = _engine(spec, cuda_device)
        try:
            want = _run(fresh, g, toks, max_new=32 if g is past else 24)
        finally:
            fresh.shutdown()
        assert got_ == want and _walks(g, got_)
    assert again == got_inside


@pytest.mark.gpu
def test_a_reset_arena_is_never_replayed_stale(cuda_device, monkeypatch):
    from quorum_tpu_torch.engine import engine as em

    monkeypatch.setattr(em, "CONSTRAIN_ARENA_KEEP", 4)
    spec = _spec()
    eng = _engine(spec, cuda_device)
    try:
        first = _grammar(spec, {"type": "regex", "pattern": "[0-9]{3}"})
        second = _grammar(spec, {"type": "regex", "pattern": "[x-z]{3}"})
        _run(eng, first, [4, 4])
        bucket = eng._g_bucket
        eng.generate([8, 8], max_new_tokens=8, sampler=GREEDY)  # a turn with no grammar: reset
        assert eng._g_trans is None
        captures = eng.metrics()["decode_graph_captures_total"]
        got = _run(eng, second, [4, 4])
        assert eng._g_bucket == bucket  # the old bucket's key again ...
        assert eng.metrics()["decode_graph_captures_total"] > captures  # ... captured anew
    finally:
        eng.shutdown()
    fresh = _engine(spec, cuda_device)
    try:
        assert got == _run(fresh, second, [4, 4])
    finally:
        fresh.shutdown()
    assert _walks(second, got) and got[-1] == 2
