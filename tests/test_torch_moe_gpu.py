"""An MoE decode chunk as a CUDA-graph replay on the card: marked ``gpu``,
skips without one (imports nothing of JAX, so it runs where JAX is absent).

Run on a machine with a card:
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_moe_gpu.py

mixtral-tiny widened to head_dim 64 (a head size K2 takes), bf16: an
8-step ``decode_chunk`` (dense MoE + K2 in every layer) captured and
replayed equals the eager call from the same state — tokens, valid counts,
state and caches bit for bit — and K2's launches count the warm-up call
and the replay's captured calls exactly.
"""

import pytest
import torch

from quorum_tpu_torch.models import transformer as tt
from quorum_tpu_torch.models.init import init_params
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.ops import flash_decode as fd


@pytest.mark.gpu
def test_moe_decode_chunk_replay_equals_eager():
    """An 8-step MoE decode chunk captured into a CUDA graph and replayed
    equals the eager call from the same state: tokens, state, caches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: decode graphs and K2 have no CPU mode")
    from quorum_tpu_torch.engine.graphs import DecodeGraphs

    dev = torch.device("cuda", torch.cuda.current_device())
    spec = resolve_spec("mixtral-tiny", {"dtype": "bfloat16", "head_dim": "64",
                                         "max_seq": "256"})
    params = init_params(spec, 0, dev)
    ck, cv = tt.init_cache(spec, 4, device=dev)
    gen = torch.Generator().manual_seed(5)
    first = []
    for row, n in enumerate((17, 3, 40, 5)):
        toks = torch.randint(3, spec.vocab_size, (1, 64), generator=gen).to(dev)
        logits, _, _ = tt.prefill(params, spec, toks, torch.tensor([n], dtype=torch.int32,
                                                                    device=dev), ck, cv, slot=row)
        first.append(int(logits.argmax()))
    state = {"token": torch.tensor(first, device=dev),
             "lengths": torch.tensor([17, 3, 40, 5], dtype=torch.int32, device=dev),
             "budget": torch.tensor([3, 0, 11, 30], dtype=torch.int32, device=dev)}
    state["live"] = state["budget"] > 0
    eos = torch.full((4,), -1, dtype=torch.int32, device=dev)

    def run(st, k_cache, v_cache):
        toks, _, n_valid, live, bud, _, _, lens, _, _ = tt.decode_chunk(
            params, spec, 8, st["token"], st["lengths"], st["live"], st["budget"], eos,
            k_cache, v_cache, lambda lg, lv, c: (torch.argmax(lg, dim=-1), c, ()), 0)
        for name, value in (("token", toks[:, -1]), ("live", live), ("budget", bud),
                            ("lengths", lens)):
            st[name].copy_(value)
        return torch.cat([toks, n_valid[:, None].to(toks.dtype)], dim=-1)

    eager_state = {k: v.clone() for k, v in state.items()}
    eager_k, eager_v = ck.clone(), cv.clone()
    want = run(eager_state, eager_k, eager_v)
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    graphs = DecodeGraphs(dev, stream)
    launches = fd.flash_decode_attention.launches
    with torch.cuda.stream(stream):
        got = graphs.replay((8, 1), lambda: run(state, ck, cv),
                            lambda: run({k: v.clone() for k, v in state.items()},
                                        ck.clone(), cv.clone()))
    torch.cuda.synchronize()
    # the warm-up call and the captured calls, once per layer and step
    assert fd.flash_decode_attention.launches - launches == spec.n_layers * 8 * 2
    assert got.tolist() == want.tolist()
    assert all(torch.equal(state[k], eager_state[k]) for k in state)
    assert torch.equal(ck, eager_k) and torch.equal(cv, eager_v)
