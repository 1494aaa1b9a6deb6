"""int8 weights and the int8 KV cache on the card: every test here is marked
``gpu`` and skips without one (imports nothing of JAX, so it runs where JAX
is absent).

Run on a machine with a card:
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_quant_gpu.py

- K2q8 (``csrc/flash_decode_q8.cu``) against its plain version, bf16 and
  f32 queries, with and without a window (1, a few hundred, the whole
  cache), a length-1 and a zero-length row among long ones, a 32 768-key
  cache all live, one row in a 131 072-key cache (its logits spill past
  the shared budget), G = 8 over one kv head at hd 256 and G = 1 at hd 64;
  one launch counted per call, a repeat bit-equal. Every output element within
  ``ops/flash_decode_q8.error_bound`` of the plain version's: the kernel
  merges the softmax over its splits in another order than the plain
  version's one pass, so only a probability within 1e-5 of a rounding
  boundary may quantize one step apart (ps·|v8| each); plus 1e-5 of the
  output and, for bf16, one bf16 ulp.
- K2q8's query quantization at a rounding tie: its scale is the plain
  version's on the card (amax · fl(1/127)), bit for bit.
- K2q8 called from two streams at once, each call more clusters than the
  card holds: both finish (a wait between blocks outside a cluster could
  deadlock there) and equal the same calls made one at a time.
- ``qeinsum`` through ``torch._int_mm`` against the plain f32
  formulation of the same integer products, every form the transformer
  uses, at 1 to 40 rows (rows below 17 are padded): equal up to f32
  rounding of the rescale.
- A decode chunk of an int8-weight, int8-cache model (llama-tiny widened
  to head_dim 64) replayed from a CUDA graph equals its eager call bit for
  bit, with K2q8's launches exact (warm-up + captured calls).
- A quantized mixtral-tiny engine with ``kv_quant=int8`` serves through
  graph replays: greedy tokens equal at ``decode_loop`` 1 and 4, K2q8 =
  layers × (decode steps + warm-up steps), K2 never launched.
"""

import pytest
import torch

from quorum_tpu_torch.engine.graphs import DecodeGraphs
from quorum_tpu_torch.models import quant as tq
from quorum_tpu_torch.models.init import init_params
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.models.transformer import decode_chunk, init_cache, prefill
from quorum_tpu_torch.ops import flash_decode as fd
from quorum_tpu_torch.ops import flash_decode_q8 as fq
from quorum_tpu_torch.ops.attention import decode_attention_q8, quantize_rows
from quorum_tpu_torch.ops.flash_decode_q8 import error_bound, flash_decode_q8_attention
from quorum_tpu_torch.ops.sampling import SamplerConfig

@pytest.fixture
def cuda_device():
    """The card (decided here, never at import: the CPU suite collects this file)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K2q8 and torch._int_mm have no CPU mode here")
    return torch.device("cuda", torch.cuda.current_device())


def _q8_cache(b, kv, t, hd, dev, seed):
    gen = torch.Generator().manual_seed(seed)
    k8, ks = quantize_rows(torch.randn(b, kv, t, hd, generator=gen), -1)
    v8, vs = quantize_rows(torch.randn(b, kv, t, hd, generator=gen) * 2, -1)
    return [x.to(dev).contiguous() for x in (k8, ks[..., 0], v8, vs[..., 0])]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd,h,kv,t,lens,window", [
    (128, 32, 8, 2048, [1, 100, 1500, 2047], 0), (128, 32, 8, 2048, [1, 100, 1500, 2047], 512),
    (64, 4, 2, 256, [3, 256, 77, 1], 0), (256, 8, 8, 512, [300, 5], 64),
    (128, 32, 8, 32768, [32768] * 4, 0), (128, 32, 8, 131072, [131072], 0),
    (256, 8, 1, 4096, [4096, 1000, 17], 0), (64, 4, 4, 1024, [1024, 63, 64, 65], 0),
    (128, 32, 8, 2048, [0, 5, 0, 2047], 0), (128, 32, 8, 2048, [1, 100, 1500, 2047], 1),
    (128, 32, 8, 2048, [0, 64, 1500, 2048], 2048)],
    ids=["llama3", "llama3-window", "hd64", "hd256-window", "long-32k", "b1-131k",
         "mqa-g8-hd256", "hd64-g1", "zero-length", "window-1", "window-T"])
def test_k2q8_matches_plain(cuda_device, dtype, hd, h, kv, t, lens, window):
    b = len(lens)
    q = torch.randn(b, h, 1, hd, generator=torch.Generator().manual_seed(1)).to(cuda_device,
                                                                                  dtype)
    k8, ks, v8, vs = _q8_cache(b, kv, t, hd, cuda_device, 2)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    n = flash_decode_q8_attention.launches
    got = flash_decode_q8_attention(q, k8, ks, v8, vs, lengths, window=window)
    torch.cuda.synchronize()
    assert flash_decode_q8_attention.launches == n + 1
    want = decode_attention_q8(q, k8, ks, v8, vs, lengths, window=window)
    assert got.dtype == dtype and bool(torch.isfinite(got.float()).all())
    # A row with no live key writes zeros (the plain version's softmax over
    # an empty range is a uniform mean of the masked cache instead; the
    # engine never reads such a row). Every other row is held to the limit.
    live = lengths > 0
    err = (got.float() - want.float()).abs()[live]
    bound = error_bound(q, k8, ks, v8, vs, lengths, window=window)[live]
    assert bool((err <= bound).all()), (err.max().item(), (err - bound).max().item())
    assert not bool(got[~live].float().abs().any())
    # the same inputs again: the kernel is deterministic
    assert torch.equal(flash_decode_q8_attention(q, k8, ks, v8, vs, lengths, window=window), got)
    assert flash_decode_q8_attention.launches == n + 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k2q8_query_scale_is_the_plain_versions_on_the_card(cuda_device, dtype):
    """Every query head holds an element at a rounding tie of its int8
    quantization: amax 2.734375 and 1.3671875, which is 63.5000038 of the
    scale amax · fl(1/127) that PyTorch computes on the card (its division
    by a scalar multiplies by the reciprocal) but 63.4999981 of a true
    amax / 127. The kernel must quantize q as the plain version does there,
    or the whole head's logits move."""
    b, h, kv, t, hd = 4, 32, 8, 2048, 128
    q = torch.randn(b, h, 1, hd, generator=torch.Generator().manual_seed(4)).clamp(-2.5, 2.5)
    q[..., 0], q[..., 1] = 2.734375, 1.3671875
    q = q.to(cuda_device, dtype)
    k8, ks, v8, vs = _q8_cache(b, kv, t, hd, cuda_device, 5)
    lengths = torch.tensor([2048, 1500, 700, 33], dtype=torch.int32, device=cuda_device)
    got = flash_decode_q8_attention(q, k8, ks, v8, vs, lengths)
    want = decode_attention_q8(q, k8, ks, v8, vs, lengths)
    err = (got.float() - want.float()).abs()
    bound = error_bound(q, k8, ks, v8, vs, lengths)
    assert bool((err <= bound).all()), (err.max().item(), (err - bound).max().item())


@pytest.mark.gpu
def test_k2q8_two_streams_oversubscribed(cuda_device):
    """Two streams call K2q8 at once, each call 96 clusters of 8 blocks
    (768 blocks, more than the card holds at once, 528 at most): both
    finish and equal the same calls made one at a time."""
    b, h, kv, t, hd = 12, 32, 8, 4096, 128
    assert fq.q8_cluster_size(b, kv, t) * b * kv > 4 * fd.N_SMS
    gen = torch.Generator().manual_seed(9)
    calls = []
    for seed in (3, 4):
        q = torch.randn(b, h, 1, hd, generator=gen).to(cuda_device, torch.bfloat16)
        lens = torch.randint(1, t + 1, (b,), generator=gen).tolist()
        calls.append((q, *_q8_cache(b, kv, t, hd, cuda_device, seed),
                      torch.tensor(lens, dtype=torch.int32, device=cuda_device)))
    alone = [flash_decode_q8_attention(*a) for a in calls]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(cuda_device) for _ in calls]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(cuda_device))
    outs = [[], []]
    for _ in range(20):
        for i, (s, a) in enumerate(zip(streams, calls)):
            with torch.cuda.stream(s):
                outs[i].append(flash_decode_q8_attention(*a))
    torch.cuda.synchronize()
    for want, got in zip(alone, outs):
        assert all(torch.equal(g, want) for g in got)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_k2q8_clusters_fit_the_card(cuda_device, hd):
    """Both cluster sizes the host may choose fit the card with the
    kernel's shared memory, which leaves room for two blocks on an SM."""
    for cluster in fq.CLUSTER_SIZES:
        occ = fq.occupancy(hd, torch.bfloat16, cluster)
        assert occ["max_active_clusters"] >= 1, occ
        assert occ["smem_bytes"] <= 113 * 1024, occ


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 4, 12, 17, 40])
@pytest.mark.parametrize("eq,xshape,wshape,axis", [
    ("...d,df->...f", (None, 512), (512, 1024), -2),
    ("mnd,mdf->mnf", (3, None, 256), (3, 256, 512), -2),
    ("nd,edf->enf", (None, 256), (4, 256, 384), -2),
    ("...d,df->...f", (None, 256), (1001, 256), -1)], ids=["x@w", "stacked", "experts", "tied"])
def test_int_mm_qeinsum_matches_plain(cuda_device, rows, eq, xshape, wshape, axis):
    gen = torch.Generator().manual_seed(rows)
    x = torch.randn(*[rows if s is None else s for s in xshape], generator=gen)
    leaf = tq.quantize_weight(torch.randn(*wshape, generator=gen), axis)
    want = tq.qeinsum(eq, x, leaf)  # CPU: the f32 formulation, exact at K ≤ 1040
    got = tq.qeinsum(eq, x.to(cuda_device), {k: v.to(cuda_device) for k, v in leaf.items()})
    assert got.dtype == torch.float32 and got.shape == want.shape
    torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-6)


def _spec(model, dtype="bfloat16"):
    return resolve_spec(model, {"dtype": dtype, "head_dim": "64", "max_seq": "256"})


@pytest.mark.gpu
def test_q8_decode_chunk_replay_equals_eager(cuda_device):
    spec = _spec("llama-tiny")
    params = init_params(spec, 0, cuda_device, quant="int8")
    ck, cv = init_cache(spec, 4, device=cuda_device, kv_quant="int8")
    gen = torch.Generator().manual_seed(5)
    first = []
    for row, n in enumerate((17, 3, 40, 5)):
        toks = torch.randint(3, spec.vocab_size, (1, 64), generator=gen).to(cuda_device)
        logits, _, _ = prefill(params, spec, toks, torch.tensor([n], dtype=torch.int32,
                                                                 device=cuda_device), ck, cv,
                               slot=row)
        first.append(int(logits.argmax()))
    state = {"token": torch.tensor(first, device=cuda_device),
             "lengths": torch.tensor([17, 3, 40, 5], dtype=torch.int32, device=cuda_device),
             "budget": torch.tensor([3, 0, 11, 30], dtype=torch.int32, device=cuda_device)}
    state["live"] = state["budget"] > 0
    eos = torch.full((4,), -1, dtype=torch.int32, device=cuda_device)

    def run(st, k_cache, v_cache):
        toks, _, n_valid, live, bud, _, _, lens, _, _ = decode_chunk(
            params, spec, 8, st["token"], st["lengths"], st["live"], st["budget"], eos,
            k_cache, v_cache, lambda lg, lv, c: (torch.argmax(lg, dim=-1), c, ()), 0)
        for name, value in (("token", toks[:, -1]), ("live", live), ("budget", bud),
                            ("lengths", lens)):
            st[name].copy_(value)
        return torch.cat([toks, n_valid[:, None].to(toks.dtype)], dim=-1)

    def clone(side):
        return tuple(t.clone() for t in side)

    eager_state = {k: v.clone() for k, v in state.items()}
    eager_k, eager_v = clone(ck), clone(cv)
    want = run(eager_state, eager_k, eager_v)
    stream = torch.cuda.Stream(cuda_device)
    stream.wait_stream(torch.cuda.current_stream(cuda_device))
    graphs = DecodeGraphs(cuda_device, stream)
    q8_launches = flash_decode_q8_attention.launches
    k2_launches = fd.flash_decode_attention.launches
    with torch.cuda.stream(stream):
        got = graphs.replay((8, 1), lambda: run(state, ck, cv),
                            lambda: run({k: v.clone() for k, v in state.items()},
                                        clone(ck), clone(cv)))
    torch.cuda.synchronize()
    # the warm-up call and the captured calls, once per layer and step
    assert flash_decode_q8_attention.launches - q8_launches == spec.n_layers * 8 * 2
    assert fd.flash_decode_attention.launches == k2_launches
    assert got.tolist() == want.tolist()
    assert all(torch.equal(state[k], eager_state[k]) for k in state)
    assert all(torch.equal(a, b) for a, b in zip(ck + cv, eager_k + eager_v))


@pytest.mark.gpu
def test_quantized_mixtral_engine_replays_its_graphs(cuda_device):
    from quorum_tpu_torch.engine.engine import InferenceEngine

    spec = _spec("mixtral-tiny")
    prompts = [[5, 9, 33, 7, 81], list(range(40, 71)), [100, 3, 3, 200, 17]]
    outs = []
    for loop in (1, 4):
        eng = InferenceEngine(spec, device=cuda_device, seed=0, quant="int8", kv_quant="int8",
                              decode_loop=loop, prefill_chunk=16)
        try:
            q8_launches = flash_decode_q8_attention.launches
            k2_launches = fd.flash_decode_attention.launches
            outs.append([eng.generate(p, max_new_tokens=20,
                                      sampler=SamplerConfig(temperature=0.0)).token_ids
                         for p in prompts])
            m = eng.metrics()
            steps = m["decode_steps_total"] + m["decode_graph_warmup_steps_total"]
            assert flash_decode_q8_attention.launches - q8_launches == spec.n_layers * steps > 0
            assert fd.flash_decode_attention.launches == k2_launches
            assert m["decode_graph_captures_total"] >= 1
            assert tq.is_quantized(eng.params["blocks"]["moe_w_gate"])
        finally:
            eng.shutdown()
    assert outs[0] == outs[1] and all(len(o) == 20 for o in outs[0])
