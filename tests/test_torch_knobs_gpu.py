"""The OpenAI knobs inside the decode graphs on the card: every test here is
marked ``gpu`` and skips without a card.

Run on a machine with a card:
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_knobs_gpu.py

- The engine's decode program in its logprob variant, with penalties over
  prior counts, biases and a sampled row, replayed from its CUDA graph
  against an eager call from the same state (bf16 and f32): tokens, valid
  counts, counts, state and caches bit for bit; logprob records bit for bit
  in f32, within 1e-3 in bf16.
- An engine on the card serves a +100 bias, penalties and logprobs with
  every dispatch a replay (the logprob key captured beside the plain one),
  K2's launch count exact, and greedy logprob records whose sampled
  logprob is their top alternative's.

llama-tiny widened to head_dim 64 (a head size K2 takes).
"""

import pytest
import torch

from quorum_tpu_torch.models.init import init_params
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.models.transformer import prefill
from quorum_tpu_torch.ops import flash_decode as fd
from quorum_tpu_torch.ops.sampling import SamplerConfig, gumbel_noise

GREEDY = SamplerConfig(temperature=0.0)


@pytest.fixture
def cuda_device():
    """The card (decided here, never at import: the CPU suite collects this file)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: decode graphs and K2 have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _spec(dtype):
    return resolve_spec("llama-tiny", {"dtype": dtype, "head_dim": "64", "max_seq": "256"})


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_logprob_program_replay_equals_eager(cuda_device, dtype):
    from quorum_tpu_torch.engine.engine import InferenceEngine

    spec = _spec(dtype)
    params = init_params(spec, 0, cuda_device)
    eng = InferenceEngine(spec, device=cuda_device, params=params, n_slots=4, decode_chunk=4,
                          decode_loop=4)
    gen = torch.Generator().manual_seed(5)
    key = (4, 4, False, True)
    try:
        lens, first = [17, 1, 40, 5], []
        for row, n in enumerate(lens):
            toks = torch.randint(3, spec.vocab_size, (1, 64), generator=gen).to(cuda_device)
            logits, _, _ = prefill(params, spec, toks, torch.tensor(
                [n], dtype=torch.int32, device=cuda_device), eng._ck, eng._cv, slot=row)
            first.append(int(logits.argmax()))
        eng._token.copy_(torch.tensor(first))
        eng._lengths.copy_(torch.tensor(lens, dtype=torch.int32))
        eng._budget.copy_(torch.tensor([3, 0, 11, 16], dtype=torch.int32))
        eng._live.copy_(eng._budget > 0)
        eng._mask.copy_(eng._budget > 0)
        eng._temp.copy_(torch.tensor([0.0, 0.0, 0.0, 0.8]))
        eng._pp.copy_(torch.tensor([0.5, 0.0, 0.2, 0.3]))
        eng._fp.copy_(torch.tensor([1.0, 0.0, 0.7, 0.4]))
        eng._counts.copy_(torch.randint(0, 3, eng._counts.shape, generator=gen,
                                        dtype=torch.int32))
        eng._bias[0, first[0]] = -100.0
        eng._bias[2, :32] = 4.0
        g = torch.Generator(device=cuda_device).manual_seed(3)
        for k in range(16):
            gumbel_noise(spec.vocab_size, g, out=eng._noise_ring[k, 3])
        names = ("_token", "_lengths", "_live", "_budget", "_counts", "_ntok", "_ck", "_cv")
        start = {n: getattr(eng, n).clone() for n in names}
        launches = fd.flash_decode_attention.launches
        with torch.cuda.stream(eng._stream):
            want, want_lp = (t.clone() for t in eng._decode_program(*key))
            eager = {n: getattr(eng, n).clone() for n in names}
            for n in names:
                getattr(eng, n).copy_(start[n])
            got, got_lp = eng._graphs.replay(key, lambda: eng._decode_program(*key),
                                             eng._warm_up)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert all(torch.equal(getattr(eng, n), eager[n]) for n in names)
        assert (got_lp - want_lp).abs().max().item() <= (0.0 if dtype == "float32" else 1e-3)
        assert got_lp.shape == (4, 4, 4, 41)
        # eager 16 steps + the warm-up step + the replay's 16 captured steps
        assert fd.flash_decode_attention.launches - launches == spec.n_layers * 33
        assert first[0] not in got[:, 0, :got[0, 0, -1]].flatten().tolist()
        assert int(got[..., -1][:, 0].sum()) == 3 and int(got[..., -1][:, 2].sum()) == 11
        assert all(int(c.abs().sum()) == 0 for c in fd.ticket_counters())
    finally:
        eng.shutdown()


@pytest.mark.gpu
@pytest.mark.parametrize("loop", [1, 4])
def test_engine_serves_knobs_in_replays(cuda_device, loop):
    from quorum_tpu_torch.engine.engine import InferenceEngine

    spec = _spec("float32")
    eng = InferenceEngine(spec, device=cuda_device, seed=1, decode_chunk=4, decode_loop=loop)
    try:
        launches = fd.flash_decode_attention.launches
        bias = torch.zeros(spec.vocab_size)
        bias[77] = 100.0
        forced = list(eng.generate_stream([5, 6, 7], max_new_tokens=20, sampler=GREEDY,
                                          logit_bias=bias))
        assert forced == [77] * 20
        plain = list(eng.generate_stream([9, 8, 7, 6], max_new_tokens=40, sampler=GREEDY))
        pen = list(eng.generate_stream([9, 8, 7, 6], max_new_tokens=40, sampler=GREEDY,
                                       frequency_penalty=2.0, presence_penalty=1.0))
        assert pen != plain
        req = eng.submit([9, 8, 7, 6], max_new_tokens=40, sampler=GREEDY, logprobs=3)
        got = list(eng.stream_results(req))
        assert got == plain and len(req.lp) == len(got)
        for lp, ids, lps in req.lp:
            assert lp <= 0 and abs(lp - lps[0]) <= 1e-5 and len(ids) == 20
            assert lps == sorted(lps, reverse=True)
        torch.cuda.synchronize()
        m = eng.metrics()
        assert m["decode_graph_replays_total"] == m["decode_chunks_total"]
        assert m["decode_graph_captures_total"] >= 2  # plain and logprob keys
        steps = m["decode_steps_total"] + m["decode_graph_warmup_steps_total"]
        assert fd.flash_decode_attention.launches - launches == spec.n_layers * steps
    finally:
        eng.shutdown()
