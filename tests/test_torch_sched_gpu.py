"""The QoS preemption drill and zero-drain staging on the card: every test
here is marked ``gpu`` and skips without a card.

Run on a machine with a card:
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_sched_gpu.py

At 2 layers of llama-3-8b widths (bf16, max_seq 1024):

- The preemption drill on a 1-slot ``qos=1`` engine (dense, paged,
  zero-drain): a batch stream held mid-decode, an interactive request
  parks it, and its resumed stream equals its solo run token for token,
  greedy and sampled; ``replayed_tokens_total == preempted_tokens_total``.
- One zero-drain stream, a prompt longer than a segment beside a live
  stream: both streams equal the drain-based twin's (both admit chunked),
  K1 never launches, and the ring never clamps.
- Segments run on the zero-drain engine's own staging stream, neither the
  ring's nor the forward stream: a staged admission beside an embedding
  forward keeps its tokens, and the forward its vectors.
"""

import dataclasses
import threading

import pytest
import torch

from quorum_tpu_torch.engine.engine import InferenceEngine
from quorum_tpu_torch.models.init import init_params
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.ops import flash_attention
from quorum_tpu_torch.ops.sampling import SamplerConfig

pytestmark = pytest.mark.gpu

GREEDY = SamplerConfig(temperature=0.0)
SAMPLED = SamplerConfig(temperature=0.9, top_p=0.9)


@pytest.fixture
def cuda_device():
    """The card (decided here, never at import: the CPU suite collects this file)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 and K2 have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture
def model(cuda_device):
    spec = dataclasses.replace(resolve_spec("llama-3-8b", {}), n_layers=2, max_seq=1024)
    return spec, init_params(spec, 0, cuda_device), cuda_device


def _gate(eng, watch: list, n: int = 16):
    """Hold the scheduler at its first decode dispatch once every request
    in ``watch`` has ``n`` tokens, until ``go`` is set."""
    reached, go = threading.Event(), threading.Event()
    orig = eng._dispatch_chunk

    def dispatch(active):
        if not go.is_set() and watch and all(r.emitted >= n for r in watch):
            reached.set()
            go.wait(60)
        return orig(active)

    eng._dispatch_chunk = dispatch
    return reached, go


@pytest.mark.parametrize("knobs", [{}, {"kv_pages": True, "kv_page_size": 64},
                                   {"zero_drain": True, "prefill_chunk": 64}],
                         ids=["dense", "paged", "zero_drain"])
@pytest.mark.parametrize("sampler", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
def test_preempted_stream_resumes_token_for_token(model, knobs, sampler):
    spec, params, dev = model
    eng = InferenceEngine(spec, device=dev, params=params, n_slots=1, decode_chunk=4, qos=True,
                          **knobs)
    prompt = torch.randint(3, spec.vocab_size, (90,), generator=torch.Generator().manual_seed(3))
    prompt = prompt.tolist()
    try:
        solo = list(eng.stream_results(eng.submit(prompt, max_new_tokens=96, sampler=sampler,
                                                  seed=5)))
        watch: list = []
        reached, go = _gate(eng, watch)
        got: list = []
        try:
            victim = eng.submit(prompt, max_new_tokens=96, sampler=sampler, seed=5,
                                priority="batch")
            watch.append(victim)
            th = threading.Thread(target=lambda: got.extend(eng.stream_results(victim)),
                                  daemon=True)
            th.start()
            assert reached.wait(120)
            bene = eng.submit([41, 43, 47], max_new_tokens=8, sampler=sampler, seed=9,
                              priority="interactive")
            go.set()
            assert len(list(eng.stream_results(bene))) == 8
            th.join(120)
        finally:
            go.set()
            del eng._dispatch_chunk
        assert not th.is_alive() and victim.n_preempts == 1
        assert got == solo
        m = eng.metrics()
        assert m["preemptions_total"] == 1
        assert m["replayed_tokens_total"] == m["preempted_tokens_total"] >= 16
        if eng.kv_pages:
            assert m["kv_pages_allocated"] + m["kv_pages_free"] == eng.kv_pool_pages
    finally:
        eng.shutdown()


def test_zero_drain_stream_beside_a_live_stream(model):
    spec, params, dev = model
    gen = torch.Generator().manual_seed(4)
    live_p = torch.randint(3, spec.vocab_size, (100,), generator=gen).tolist()
    long_p = torch.randint(3, spec.vocab_size, (600,), generator=gen).tolist()
    out = {}
    for name, knobs in (("twin", {}), ("zero_drain", {"zero_drain": True})):
        eng = InferenceEngine(spec, device=dev, params=params, n_slots=2, decode_chunk=4,
                              decode_pipeline=4, decode_loop=4, prefill_chunk=64, **knobs)
        try:
            k1 = flash_attention.flash_prefill_attention.launches
            live = eng.submit(live_p, max_new_tokens=900, sampler=GREEDY)
            it = eng.stream_results(live)
            head = [next(it) for _ in range(8)]
            long = eng.submit(long_p, max_new_tokens=16, sampler=GREEDY)
            out[name] = (head + list(it), list(eng.stream_results(long)))
            m = eng.metrics()
            out[name + "_k1"] = flash_attention.flash_prefill_attention.launches - k1
            out[name + "_m"] = m
        finally:
            eng.shutdown()
    assert out["zero_drain"] == out["twin"]
    assert out["zero_drain_k1"] == 0 and out["twin_k1"] == 0  # both admit chunked
    z = out["zero_drain_m"]
    assert z["admission_stall_seconds_total"] == 0.0 and z["admission_overlap_total"] >= 1
    assert z["prefill_segments_total"] == -(-100 // 64) + -(-600 // 64)


def test_zero_drain_stages_on_its_own_stream_beside_a_forward(model, monkeypatch):
    import quorum_tpu_torch.engine.engine as engine_mod
    from quorum_tpu_torch.engine import embed as embed_mod

    spec, params, dev = model
    gen = torch.Generator().manual_seed(5)
    long_p = torch.randint(3, spec.vocab_size, (300,), generator=gen).tolist()
    inputs = [torch.randint(3, spec.vocab_size, (200,), generator=gen).tolist()
              for _ in range(16)]
    eng = InferenceEngine(spec, device=dev, params=params, n_slots=2, prefill_chunk=64,
                          zero_drain=True)
    streams = []
    real = engine_mod.prefill_segment

    def spy(*args, **kw):
        streams.append(torch.cuda.current_stream(dev))
        return real(*args, **kw)

    try:
        alone = list(eng.stream_results(eng.submit(long_p, max_new_tokens=16,
                                                   sampler=GREEDY)))
        vecs_alone = embed_mod.embed_token_batch(eng, inputs)
        monkeypatch.setattr(engine_mod, "prefill_segment", spy)
        req = eng.submit(long_p, max_new_tokens=16, sampler=GREEDY)
        vecs = embed_mod.embed_token_batch(eng, inputs)
        got = list(eng.stream_results(req))
        assert eng._stage_stream is not None
        assert eng._stage_stream != eng._stream and eng._stage_stream != eng._fwd_stream
        assert streams and all(s == eng._stage_stream for s in streams)
        stall = eng.metrics()["admission_stall_seconds_total"]
    finally:
        eng.shutdown()
    assert got == alone and stall == 0.0
    assert torch.equal(vecs, vecs_alone)  # one sub-batch either way: 16 x 256 padded
