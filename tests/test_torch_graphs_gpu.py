"""Decode dispatches as CUDA-graph replays on the card (``engine/graphs.py``):
every test here is marked ``gpu`` and skips without a card.

Run on a machine with a card:
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_graphs_gpu.py

- A replay of ``decode_chunk`` (8 steps) and of ``decode_loop`` (3 chunks,
  one row finishing in chunk 1, one in chunk 3, one dead) against eager
  calls of the same function from the same state, in bf16 and f32: tokens,
  valid counts and the carried state equal, caches equal bit for bit (the
  replay runs the same kernels in the same order), ticket counters at 0.
- K2 launches are exact: the warm-up's eager step, then the captured calls
  once per replay.
- Three engines on three threads capture and replay at once: each one's
  streams equal its own streams run alone, tickets read 0, and K2's count
  is the sum of the engines' decode and warm-up steps times the layers.
- A chunk hint longer than the static noise buffer grows it, drops the
  graphs and captures again in a new pool, with the tokens unchanged.

llama-tiny widened to head_dim 64 (a head size K2 takes).
"""

import threading

import pytest
import torch

from quorum_tpu_torch.engine.graphs import DecodeGraphs
from quorum_tpu_torch.models.init import init_params
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.models.transformer import decode_chunk, decode_loop, init_cache, prefill
from quorum_tpu_torch.ops import flash_decode as fd
from quorum_tpu_torch.ops.sampling import SamplerConfig


@pytest.fixture
def cuda_device():
    """The card (decided here, never at import: the CPU suite collects this file)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: decode graphs and K2 have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _spec(dtype):
    return resolve_spec("llama-tiny", {"dtype": dtype, "head_dim": "64", "max_seq": "256"})


def _prefilled(spec, dev):
    """Four cache rows: prompts in rows 0, 2, 3; row 1 dead."""
    gen = torch.Generator().manual_seed(5)
    params = init_params(spec, 0, dev)
    ck, cv = init_cache(spec, 4, device=dev)
    lens = [17, 0, 40, 5]
    first = []
    for row, n in enumerate(lens):
        if not n:
            first.append(0)
            continue
        toks = torch.randint(3, spec.vocab_size, (1, 64), generator=gen).to(dev)
        logits, _, _ = prefill(params, spec, toks, torch.tensor([n], dtype=torch.int32,
                                                                 device=dev), ck, cv, slot=row)
        first.append(int(logits.argmax()))
    state = {"token": torch.tensor(first, device=dev),
             "lengths": torch.tensor(lens, dtype=torch.int32, device=dev),
             "budget": torch.tensor([3, 0, 11, 30], dtype=torch.int32, device=dev)}
    state["live"] = state["budget"] > 0
    return params, ck, cv, state


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("n_steps,n_chunks", [(8, 1), (4, 3)], ids=["chunk", "loop"])
def test_replay_equals_eager(cuda_device, dtype, n_steps, n_chunks):
    spec = _spec(dtype)
    params, ck, cv, state = _prefilled(spec, cuda_device)
    eos = torch.full((4,), -1, dtype=torch.int32, device=cuda_device)
    noise = -torch.log(-torch.log(torch.rand(
        (n_steps * n_chunks, 4, spec.vocab_size), generator=torch.Generator().manual_seed(1))))
    noise = noise.to(cuda_device)

    def sample(logits, live, k):
        return torch.argmax(logits + noise[k], dim=-1), k + 1, ()

    def run(st, k_cache, v_cache):
        args = (st["token"], st["lengths"], st["live"], st["budget"], eos, k_cache, v_cache,
                sample, 0)
        if n_chunks == 1:
            toks, _, n_valid, live, bud, _, _, lens, _, _ = decode_chunk(params, spec, n_steps,
                                                                         *args)
            toks, n_valid, tok = toks[None], n_valid[None], toks[:, -1]
        else:
            toks, n_valid, tok, live, bud, _, _, lens, _, _ = decode_loop(
                params, spec, n_steps, n_chunks, *args)
        for name, value in (("token", tok), ("live", live), ("budget", bud), ("lengths", lens)):
            st[name].copy_(value)
        return torch.cat([toks, n_valid[..., None].to(toks.dtype)], dim=-1)

    eager_state = {k: v.clone() for k, v in state.items()}
    eager_k, eager_v = ck.clone(), cv.clone()
    want = run(eager_state, eager_k, eager_v)

    stream = torch.cuda.Stream(cuda_device)
    stream.wait_stream(torch.cuda.current_stream(cuda_device))
    graphs = DecodeGraphs(cuda_device, stream)
    launches = fd.flash_decode_attention.launches
    with torch.cuda.stream(stream):
        got = graphs.replay((n_steps, n_chunks), lambda: run(state, ck, cv),
                            lambda: run({k: v.clone() for k, v in state.items()},
                                        ck.clone(), cv.clone()))
    torch.cuda.synchronize()
    n_layers = spec.n_layers
    assert fd.flash_decode_attention.launches - launches == n_layers * n_steps * n_chunks * 2
    assert got.tolist() == want.tolist()
    assert all(torch.equal(state[k], eager_state[k]) for k in state)
    assert torch.equal(ck, eager_k) and torch.equal(cv, eager_v)
    n_valid = got[..., -1]
    if n_chunks > 1:
        assert n_valid[0].tolist() == [3, 0, 4, 4] and n_valid[-1].tolist() == [0, 0, 3, 4]
    assert all(int(c.abs().sum()) == 0 for c in fd.ticket_counters())
    assert graphs.captures == 1 and graphs.replays == 1 and graphs.pool_bytes > 0


@pytest.mark.gpu
def test_engine_launch_counts_are_exact_across_replays(cuda_device):
    """K2 = layers × (decode steps + the warm-up step): every decode step of
    every replay, counted once, on an engine at decode_loop=4 whose tokens
    equal decode_loop=1's, greedy and sampled."""
    from quorum_tpu_torch.engine.engine import InferenceEngine

    spec = _spec("float32")
    params = init_params(spec, 0, cuda_device)
    torch.cuda.synchronize()
    engines = [InferenceEngine(spec, device=cuda_device, params=params, decode_chunk=4,
                               decode_loop=c) for c in (1, 4)]
    try:
        launches = fd.flash_decode_attention.launches
        for smp in (SamplerConfig(temperature=0.0), SamplerConfig(temperature=0.9, top_p=0.9)):
            got = [[e.generate(p, max_new_tokens=n, sampler=smp, seed=3).token_ids
                    for p, n in (([5, 6, 7], 40), ([9, 8], 13))] for e in engines]
            assert got[0] == got[1]
        torch.cuda.synchronize()
        ms = [e.metrics() for e in engines]
        steps = sum(m["decode_steps_total"] + m["decode_graph_warmup_steps_total"] for m in ms)
        assert fd.flash_decode_attention.launches - launches == spec.n_layers * steps
        assert all(m["decode_graph_replays_total"] == m["decode_chunks_total"] for m in ms)
        assert all(m["decode_graph_captures_total"] >= 2 for m in ms)  # greedy, top-p
        assert ms[1]["decode_chunks_total"] < ms[0]["decode_chunks_total"]
        assert ms[1]["decode_loop_chunks_total"] == ms[0]["decode_loop_chunks_total"]
        assert all(int(c.abs().sum()) == 0 for c in fd.ticket_counters())
    finally:
        for e in engines:
            e.shutdown()


@pytest.mark.gpu
def test_three_engines_capture_concurrently(cuda_device):
    from quorum_tpu_torch.engine.engine import InferenceEngine

    spec = _spec("bfloat16")
    engines = [InferenceEngine(spec, device=cuda_device, seed=i, decode_chunk=4, decode_loop=2)
               for i in range(3)]
    greedy = SamplerConfig(temperature=0.0)
    try:
        launches = fd.flash_decode_attention.launches
        out = [None] * 3
        go = threading.Barrier(3)

        def run(i):
            go.wait()
            out[i] = [engines[i].generate(p, max_new_tokens=24, sampler=greedy).token_ids
                      for p in ([5, 6, 7], [9, 8, 1])]

        threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        alone = [[e.generate(p, max_new_tokens=24, sampler=greedy).token_ids
                  for p in ([5, 6, 7], [9, 8, 1])] for e in engines]
        assert out == alone
        torch.cuda.synchronize()
        ms = [e.metrics() for e in engines]
        assert all(m["decode_graph_captures_total"] >= 1 and m["failures_total"] == 0
                   for m in ms)
        steps = sum(m["decode_steps_total"] + m["decode_graph_warmup_steps_total"] for m in ms)
        assert fd.flash_decode_attention.launches - launches == spec.n_layers * steps
        assert all(int(c.abs().sum()) == 0 for c in fd.ticket_counters())
    finally:
        for e in engines:
            e.shutdown()


@pytest.mark.gpu
def test_noise_buffer_growth_recaptures(cuda_device):
    """A request whose chunk hint needs more steps than the static noise
    buffer holds grows the buffer, drops every graph and captures again in
    a new pool: its tokens equal those of an engine sized for it."""
    from quorum_tpu_torch.engine.engine import InferenceEngine

    spec = _spec("float32")
    params = init_params(spec, 0, cuda_device)
    torch.cuda.synchronize()
    small = InferenceEngine(spec, device=cuda_device, params=params, decode_chunk=4)
    big = InferenceEngine(spec, device=cuda_device, params=params, decode_chunk=8)
    smp = SamplerConfig(temperature=0.9, top_p=0.9)
    try:
        want = big.generate([5, 6, 7], max_new_tokens=20, sampler=smp, seed=3).token_ids
        small.generate([5, 6, 7], max_new_tokens=9, sampler=smp, seed=3)  # captures 4-step keys
        req = small.submit([5, 6, 7], max_new_tokens=20, sampler=smp, seed=3, decode_chunk=8)
        assert list(small.stream_results(req)) == want
        assert small._noise_ring.shape[0] == 8
        m = small.metrics()
        assert m["failures_total"] == 0 and m["decode_graph_captures_total"] >= 2
    finally:
        small.shutdown()
        big.shutdown()
