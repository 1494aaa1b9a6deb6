"""Paged KV on the card: every test here is marked ``gpu`` and skips without
a card.

Run on a machine with a card:
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_paged_gpu.py

- K2 and K2q8 on a page-gathered window (``page_read`` of a shuffled pool)
  equal the same kernel on the dense cache holding the same rows, bit for
  bit: the gather hands the kernel the same contiguous bytes.
- A paged engine's decode replays stream exactly what the dense engine's
  stream, bf16 and int8 KV, greedy and sampled, at ring depth 2 with rows
  cancelled while dispatches are in flight; its launch counts follow the
  dense rule (layers × (decode steps + warm-up steps)), with one warm-up
  per history bucket.
- The host prefix store restores on the card: a churned conversation's
  follow-up streams what a cold prefill streams, dense and paged.

llama-tiny widened to head_dim 64 (a head size K2 takes).
"""

import pytest
import torch

from quorum_tpu_torch.cache.paging import PagedKV, page_read
from quorum_tpu_torch.models.init import init_params
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.ops.sampling import SamplerConfig

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    """The card (decided here, never at import: the CPU suite collects this file)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K2, K2q8 and the decode graphs have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _spec(dtype="bfloat16", max_seq="512"):
    return resolve_spec("llama-tiny", {"dtype": dtype, "head_dim": "64", "max_seq": max_seq})


@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("hist", [64, 256, 512])
def test_kernels_on_gathered_window_equal_dense(cuda_device, q8, hist):
    from quorum_tpu_torch.ops.attention import quantize_rows
    from quorum_tpu_torch.ops.flash_decode import flash_decode_attention
    from quorum_tpu_torch.ops.flash_decode_q8 import flash_decode_q8_attention

    dev, b, h, kv, hd, ps = cuda_device, 4, 8, 2, 64, 32
    gen = torch.Generator(device=dev).manual_seed(0)
    dense_k = torch.randn((b, kv, hist, hd), generator=gen, device=dev).bfloat16()
    dense_v = torch.randn((b, kv, hist, hd), generator=gen, device=dev).bfloat16()
    q = torch.randn((b, h, 1, hd), generator=gen, device=dev).bfloat16()
    lengths = torch.tensor([hist, 1, hist // 2 + 3, 17], dtype=torch.int32, device=dev)
    hp = hist // ps
    perm = torch.randperm(b * hp, device=dev) + 1
    table = torch.zeros((b, 512 // ps), dtype=torch.int32, device=dev)
    table[:, :hp] = perm.view(b, hp).int()

    def pool_of(x):  # [B, K, hist, hd] → pages at the table's ids, sink 0, trash last
        pool = torch.zeros((b * hp + 2, kv, ps, *x.shape[3:]), dtype=x.dtype, device=dev)
        pages = x.reshape(b, kv, hp, ps, *x.shape[3:]).transpose(1, 2)
        pool[table[:, :hp].long()] = pages
        return pool

    if q8:
        k8, ks = quantize_rows(dense_k, -1)
        v8, vs = quantize_rows(dense_v, -1)
        ks, vs = ks[..., 0], vs[..., 0]
        pk = PagedKV((pool_of(k8), pool_of(ks)), table)
        pv = PagedKV((pool_of(v8), pool_of(vs)), table)
        (gk8, gks), (gv8, gvs) = page_read(pk, hist), page_read(pv, hist)
        want = flash_decode_q8_attention(q, k8, ks, v8, vs, lengths)
        got = flash_decode_q8_attention(q, gk8, gks, gv8, gvs, lengths)
    else:
        gk = page_read(PagedKV(pool_of(dense_k), table), hist)
        gv = page_read(PagedKV(pool_of(dense_v), table), hist)
        assert torch.equal(gk, dense_k) and torch.equal(gv, dense_v)
        want = flash_decode_attention(q, dense_k, dense_v, lengths)
        got = flash_decode_attention(q, gk, gv, lengths)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _gen(eng, p, n, sampler, seed=0):
    return list(eng.generate_stream(p, max_new_tokens=n, sampler=sampler, seed=seed))


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_paged_engine_streams_equal_dense_on_card(cuda_device, kv_quant):
    from quorum_tpu_torch.engine.engine import InferenceEngine
    from quorum_tpu_torch.ops.flash_decode import flash_decode_attention
    from quorum_tpu_torch.ops.flash_decode_q8 import flash_decode_q8_attention

    spec = _spec()
    params = init_params(spec, 0, cuda_device)
    kw = dict(device=cuda_device, params=params, n_slots=3, prefill_chunk=64,
              decode_chunk=4, kv_quant=kv_quant)
    dense = InferenceEngine(spec, **kw)
    paged = InferenceEngine(spec, kv_pages=True, kv_page_size=32, **kw)
    kernel = flash_decode_q8_attention if kv_quant else flash_decode_attention
    gen = torch.Generator().manual_seed(1)
    prompts = [torch.randint(3, spec.vocab_size, (n,), generator=gen).tolist()
               for n in (5, 70, 200, 33)]
    greedy, sampled = SamplerConfig(temperature=0.0), SamplerConfig(temperature=0.9)
    try:
        outs = {}
        for eng in (dense, paged):
            kernel.launches = 0
            got = []
            for i, p in enumerate(prompts):
                it = eng.generate_stream(p, max_new_tokens=60, sampler=greedy)
                got.append([next(it) for _ in range(5)])
                it.close()  # cancelled with dispatches in flight
                got.append(_gen(eng, p[::-1], 24, sampled if i % 2 else greedy, seed=i))
            torch.cuda.synchronize()
            m = eng.metrics()
            steps = m["decode_steps_total"] + m["decode_graph_warmup_steps_total"]
            assert kernel.launches == spec.n_layers * steps
            outs[eng] = got
        assert outs[dense] == outs[paged]
        assert all(k[0] == "paged" for k in paged.dispatched_keys)
        assert paged.metrics()["decode_graph_warmup_steps_total"] == \
            len({k[-1] for k in paged.dispatched_keys})
    finally:
        dense.shutdown()
        paged.shutdown()


@pytest.mark.parametrize("kv_pages", [False, True])
def test_prefix_store_restores_on_card(cuda_device, kv_pages):
    from quorum_tpu_torch.engine.engine import InferenceEngine

    spec = _spec()
    params = init_params(spec, 0, cuda_device)
    kw = dict(device=cuda_device, params=params, n_slots=1, prefill_chunk=64, decode_chunk=4)
    eng = InferenceEngine(spec, prefix_store="host", kv_pages=kv_pages, **kw)
    cold = InferenceEngine(spec, prefix_cache=False, **kw)
    greedy = SamplerConfig(temperature=0.0)
    gen = torch.Generator().manual_seed(2)
    conv = torch.randint(3, spec.vocab_size, (300,), generator=gen).tolist()
    try:
        gen1 = _gen(eng, conv, 8, greedy)
        eng.drain_prefix_store()
        _gen(eng, conv[::-1], 8, greedy)  # reclaims the only slot
        eng.drain_prefix_store()
        turn2 = conv + gen1 + [7, 8, 9]
        assert _gen(eng, turn2, 16, greedy) == _gen(cold, turn2, 16, greedy)
        m = eng.metrics()
        assert m["prefix_store_hits_total"] == 1
        assert m["prefix_store_restored_tokens_total"] == 256
    finally:
        eng.shutdown()
        cold.shutdown()
