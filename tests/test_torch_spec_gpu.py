"""Speculative dispatches as CUDA-graph replays on the card: every test here
is marked ``gpu`` and skips without a card.

Run on a machine with a card:
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_spec_gpu.py

- A verify turn's replay equals the eager verify program from the same
  state (tokens, emitted counts, the carried state and the caches bit for
  bit), a sampled row reading its token-indexed draws.
- A fused ``spec_loop`` replay (two draft→verify turns, an oracle draft)
  equals its eager call, the draft cache and the chain carry included; the
  K2 launches its graph captured are the draft's layers × its g−1
  extension steps × the turns, and each replay adds them.
- Token-indexed noise: a sampled request streams the same tokens on a
  spec engine at ring depth 1 and 2 as on the plain engine (float32).

llama-tiny widened to head_dim 64 (a head size K2 takes).
"""

import pytest
import torch

from quorum_tpu_torch.models.init import init_params
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.models.transformer import prefill
from quorum_tpu_torch.ops import flash_decode as fd
from quorum_tpu_torch.ops.sampling import SamplerConfig, gumbel_noise

G = 4


@pytest.fixture
def cuda_device():
    """The card (decided here, never at import: the CPU suite collects this file)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the decode graphs and K2 have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _spec(dtype):
    return resolve_spec("llama-tiny", {"dtype": dtype, "head_dim": "64", "max_seq": "256"})


def _engine(spec, dev, **kw):
    from quorum_tpu_torch.engine.engine import InferenceEngine

    return InferenceEngine(spec, device=dev, params=init_params(spec, 0, dev), n_slots=4,
                           decode_chunk=4, spec_decode=G, **kw)


def _set_rows(eng, dev, caches=None):
    """Rows 0, 2, 3 prefilled (row 3 sampled, its first draws in the ring),
    row 1 dead; the draft rows (``caches``: the draft's params, spec, ck, cv)
    prefilled with the same prompts."""
    spec = eng.spec
    gen = torch.Generator().manual_seed(5)
    lens, first = [17, 1, 40, 5], []
    for row, n in enumerate(lens):
        toks = torch.randint(3, spec.vocab_size, (1, 64), generator=gen).to(dev)
        n_t = torch.tensor([n], dtype=torch.int32, device=dev)
        logits, _, _ = prefill(eng.params, spec, toks, n_t, eng._ck, eng._cv, slot=row)
        if caches is not None:
            dparams, dspec, dck, dcv = caches
            prefill(dparams, dspec, toks, n_t, dck, dcv, slot=row)
        first.append(int(logits.argmax()))
    eng._token.copy_(torch.tensor(first))
    eng._lengths.copy_(torch.tensor(lens, dtype=torch.int32))
    eng._budget.copy_(torch.tensor([9, 0, 16, 12], dtype=torch.int32))
    eng._live.copy_(eng._budget > 0)
    eng._mask.copy_(eng._budget > 0)
    eng._eos.fill_(2)
    eng._temp.copy_(torch.tensor([0.0, 0.0, 0.0, 0.8]))
    g = torch.Generator(device=dev).manual_seed(3)
    for k in range(eng._noise_ring.shape[0]):  # draws 0 .. R−1 of row 3
        gumbel_noise(spec.vocab_size, g, out=eng._noise_ring[k, 3])
    return first


NAMES = ("_token", "_lengths", "_live", "_budget", "_counts", "_ntok", "_ck", "_cv")


def _replay_vs_eager(eng, key, program, extra=()):
    """Run ``program`` eagerly, restore the state, replay its graph: both
    outputs and the state after each."""
    names = NAMES + tuple(extra)
    get = {n: (lambda n=n: getattr(eng, n) if isinstance(n, str) else n()) for n in names}
    start = {n: get[n]().clone() for n in names}
    with torch.cuda.stream(eng._stream):
        want = [t.clone() if t is not None else None for t in program()]
        eager = {n: get[n]().clone() for n in names}
        for n in names:
            get[n]().copy_(start[n])
        got = eng._graphs.replay(key, program, eng._warm_up)
    torch.cuda.synchronize()
    return want, got, eager, {n: get[n]() for n in names}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_verify_replay_equals_eager(cuda_device, dtype):
    spec = _spec(dtype)
    eng = _engine(spec, cuda_device)
    try:
        first = _set_rows(eng, cuda_device)
        drafts = torch.randint(3, spec.vocab_size, (4, G))
        drafts[2, :2] = torch.tensor([first[2], first[2]])
        drafts[0] = -1
        eng._draft_buf.copy_(drafts)
        key = ("verify", G, False, False, 64)

        def program():
            return eng._verify_program(G, False, False, False, 64)

        (want, _), (got, _), eager, after = _replay_vs_eager(eng, key, program)
        assert got.shape == (1, 4, G + 2)
        assert torch.equal(got, want)
        assert all(torch.equal(after[n], eager[n]) for n in NAMES)
        e = got[0, :, -1].tolist()
        assert e[1] == 0 and all(1 <= x <= G + 1 for x in (e[0], e[2], e[3]))
        assert int(eng._ntok[3]) == e[3]
    finally:
        eng.shutdown()


@pytest.mark.gpu
def test_fused_spec_loop_replay_equals_eager_and_counts_k2(cuda_device):
    spec = _spec("float32")
    eng = _engine(spec, cuda_device, decode_loop=2, draft_spec=spec, draft_seed=0)
    rt = eng._draft_rt
    try:
        rt.ensure_chain(G)
        first = _set_rows(eng, cuda_device, caches=(rt.params, rt.spec, rt.ck, rt.cv))
        rt.chain[:, 0] = torch.tensor(first)
        rt.chain_n.fill_(1)
        eng._spec_ok.copy_(torch.tensor([True, False, True, True]))
        key = ("spec_loop", 2, G, False, False, 128)

        def program():
            return eng._spec_loop_program(2, G, False, False, False, 128)

        extra = (lambda: rt.ck, lambda: rt.cv, lambda: rt.chain, lambda: rt.chain_n)
        before = fd.flash_decode_attention.launches
        (want, _), (got, _), eager, after = _replay_vs_eager(eng, key, program, extra)
        assert got.shape == (2, 4, G + 2)
        assert torch.equal(got, want)
        assert all(torch.equal(after[n], eager[n]) for n in after)
        captured = eng._graphs._graphs[key][2]
        per_replay = rt.spec.n_layers * (G - 1) * 2
        assert captured.get(fd.flash_decode_attention) == per_replay
        # eager call + the target's warm-up step + one replay
        assert fd.flash_decode_attention.launches - before == (
            per_replay + spec.n_layers + per_replay)
        # the oracle's drafts are accepted on the greedy drafting rows
        assert int(got[:, 2, -1].sum()) > 2
    finally:
        eng.shutdown()


@pytest.mark.gpu
def test_token_indexed_noise_same_sampled_stream_at_depth_1_and_2(cuda_device):
    from quorum_tpu_torch.engine.engine import InferenceEngine

    spec = _spec("float32")
    params = init_params(spec, 0, cuda_device)
    smp = SamplerConfig(temperature=0.8, top_p=0.9)
    prompt = [5, 6, 7, 8]
    # A plain engine's ring holds one dispatch's draws: at depth 2 the next
    # dispatch's top-up overwrites slots the one in flight reads, after it
    # in stream order.
    refs = []
    for depth in (1, 2):
        plain = InferenceEngine(spec, device=cuda_device, params=params, decode_chunk=4,
                                decode_pipeline=depth)
        try:
            assert plain._noise_ring.shape[0] == 4
            refs.append(plain.generate(prompt, max_new_tokens=32, sampler=smp,
                                       seed=11).token_ids)
        finally:
            plain.shutdown()
    ref = refs[0]
    assert refs[1] == ref
    for depth in (1, 2):
        eng = InferenceEngine(spec, device=cuda_device, params=params, decode_chunk=4,
                              decode_pipeline=depth, spec_decode=G)
        eng._draft = lambda req, g: (ref[req.emitted:req.emitted + g]
                                     if req.emitted + g <= len(ref) else None)
        try:
            got = eng.generate(prompt, max_new_tokens=32, sampler=smp, seed=11).token_ids
            m = eng.metrics()
        finally:
            eng.shutdown()
        assert got == ref, f"depth {depth}"
        assert m["spec_accepted_total"] > 8 and m["failures_total"] == 0
        assert m["decode_graph_replays_total"] >= m["spec_turns_total"]
