"""The cache-free forwards on the card: every test here is marked ``gpu`` and
skips without a card.

Run on a machine with a card:
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_surfaces_gpu.py

- ``forward_hidden`` and ``forward_logits`` at 2 layers of llama-3-8b
  widths launch K1 once per layer and equal the plain attention's forward
  at every position below each row's length: float32 within 2e-3 (the K1
  fma route; summation order only), bf16 within 0.25 (bf16 rounding of P
  in the plain version only, through two layers of bf16 products).
- Embeddings and scores computed on the engine's forward stream while a
  live greedy stream decodes: K1 launches on that stream (never the decode
  ring's), the vectors and logprobs equal the same calls on an idle
  engine, and the live stream's tokens equal its run alone.
- One mixtral-8x7b layer's grouped MoE (full width, bf16) over 16 384
  tokens, its expert buffers in ``MOE_SLOT_ROWS`` slices, against the
  whole buffer: within one bf16 ulp of the largest output, and its peak
  memory below the whole buffer's.
"""

import dataclasses
import threading
import time

import pytest
import torch

from quorum_tpu_torch.engine import embed as embed_mod
from quorum_tpu_torch.engine import score as score_mod
from quorum_tpu_torch.engine.engine import InferenceEngine
from quorum_tpu_torch.models import transformer as tf
from quorum_tpu_torch.models.init import init_params
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.models.transformer import forward_hidden, forward_logits
from quorum_tpu_torch.ops import flash_attention
from quorum_tpu_torch.ops.sampling import SamplerConfig

pytestmark = pytest.mark.gpu

TOL = {"float32": 2e-3, "bfloat16": 0.25}


@pytest.fixture
def cuda_device():
    """The card (decided here, never at import: the CPU suite collects this file)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forwards_run_k1_and_match_the_plain_attention(cuda_device, dtype):
    spec = dataclasses.replace(resolve_spec("llama-3-8b", {"dtype": dtype}), n_layers=2,
                               max_seq=1024)
    params = init_params(spec, 0, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    toks = torch.randint(3, spec.vocab_size, (3, 640), device=cuda_device, generator=gen)
    lens = torch.tensor([640, 17, 333], dtype=torch.int32, device=cuda_device)
    with torch.no_grad():
        for fn in (forward_hidden, forward_logits):
            before = flash_attention.flash_prefill_attention.launches
            got = fn(params, spec, toks, lens).float()
            assert flash_attention.flash_prefill_attention.launches - before == spec.n_layers
            want = fn(params, spec, toks, lens, plain_attention=True).float()
            torch.cuda.synchronize()
            for b, n in enumerate(lens.tolist()):
                err = float((got[b, :n] - want[b, :n]).abs().max())
                assert err <= TOL[dtype], (fn.__name__, b, err)


def test_forwards_share_the_card_with_live_decode(cuda_device):
    spec = dataclasses.replace(resolve_spec("llama-tiny", {}), head_dim=64, n_heads=4,
                               n_kv_heads=2, d_model=256, max_seq=512)
    eng = InferenceEngine(spec, device=cuda_device, seed=3, n_slots=2, decode_chunk=4)
    try:
        lists = [[(i * 13 + j) % 500 + 3 for j in range(n)] for i, n in enumerate((300, 40, 7))]
        emb = embed_mod.embed_token_batch(eng, lists)
        scores = score_mod.score_token_batch(eng, lists, top_k=3)
        greedy = SamplerConfig(temperature=0.0)
        alone = list(eng.generate_stream([5, 6, 7, 8], max_new_tokens=200, sampler=greedy))
        streams = []
        real = flash_attention.flash_prefill_attention

        def spy(q, *args, **kw):
            streams.append(torch.cuda.current_stream(q.device))
            return real(q, *args, **kw)

        out: list = []
        req = eng.submit([5, 6, 7, 8], max_new_tokens=200, sampler=greedy)
        th = threading.Thread(target=lambda: out.extend(eng.stream_results(req)))
        th.start()
        while not out:
            time.sleep(0.001)
        import quorum_tpu_torch.models.transformer as tf

        tf.flash_prefill_attention = spy
        try:
            emb2 = embed_mod.embed_token_batch(eng, lists)
            scores2 = score_mod.score_token_batch(eng, lists, top_k=3)
        finally:
            tf.flash_prefill_attention = real
        th.join(timeout=120)
        assert out == alone
        assert streams and all(s == eng._fwd_stream for s in streams)
        assert all(s != eng._stream for s in streams)
        assert torch.equal(emb2, emb)
        assert [s["token_logprobs"] for s in scores2] == [s["token_logprobs"] for s in scores]
        assert [s["top"] for s in scores2] == [s["top"] for s in scores]
    finally:
        eng.shutdown()


def test_moe_expert_slices_on_the_card(cuda_device, monkeypatch):
    spec = dataclasses.replace(resolve_spec("mixtral-8x7b", {}), n_layers=1)
    block = tf._layer(init_params(spec, 0, cuda_device)["blocks"], 0)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn(8, 2048, spec.d_model, device=cuda_device, generator=gen,
                    dtype=torch.bfloat16)
    mask = torch.arange(2048, device=cuda_device)[None, :] < torch.tensor(
        [2048, 100, 1500, 2048, 7, 2048, 900, 2048], device=cuda_device)[:, None]
    peaks = {}
    outs = {}
    with torch.no_grad():
        for name, rows in (("whole", 1 << 30), ("sliced", tf.MOE_SLOT_ROWS)):
            monkeypatch.setattr(tf, "MOE_SLOT_ROWS", rows)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            outs[name] = tf._moe_mlp_grouped(x, block, spec, token_mask=mask).float()
            torch.cuda.synchronize()
            peaks[name] = torch.cuda.max_memory_allocated() - base
    top = float(outs["whole"].abs().max())
    assert top > 1e-3
    assert float((outs["sliced"] - outs["whole"]).abs().max()) <= 2 ** -7 * top
    assert peaks["sliced"] < peaks["whole"], peaks
