"""Multi-rank engines on one card (``parallel/``): every test here is
marked ``gpu`` and skips without a card.

Run on a machine with a card:
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_mesh_gpu.py

llama-tiny widened to head_dim 64 (a head size K1 and K2 take), float32,
4 kv heads, seed 0:
- a one-rank NCCL mesh decodes from CUDA graphs that captured its
  collectives, with the single-device engine's greedy tokens;
- two NCCL ranks on one card are refused, naming backend="gloo";
- tp=2, sp=2 ring and sp=2 Ulysses with two ranks sharing the card over
  gloo (eager decode) give the single-device engine's greedy tokens, each
  rank launches K1 (Ulysses, tp) and K2, and the worker fed rank 0's tokens.

Ranks on cards of their own over NCCL are not served yet: on a four-card
machine such an engine hung (ROADMAP queue 3), so ``make_mesh`` refuses an
NCCL mesh of several ranks (tests/test_torch_mesh.py checks the refusal;
scripts/torch_mesh_probe.py reproduces the fault).
"""

import pytest
import torch

from quorum_tpu_torch.engine.engine import InferenceEngine
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.ops.flash_decode import flash_decode_attention
from quorum_tpu_torch.ops.sampling import SamplerConfig
from quorum_tpu_torch.parallel import (COLLECTIVES, MeshConfig, make_mesh,
                                       single_device_mesh)

pytestmark = pytest.mark.gpu

SPEC = resolve_spec("llama-tiny", {"dtype": "float32", "head_dim": "64", "n_kv_heads": "4"})
PROMPT = [(5 + 3 * i) % 500 for i in range(60)]
GREEDY = SamplerConfig(temperature=0.0)
N = 16


@pytest.fixture(scope="module")
def card():
    """The card (decided here, never at import: the CPU suite collects this file)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the mesh's kernels and NCCL have no CPU mode")
    return "cuda:0"


@pytest.fixture(scope="module")
def want(card):
    eng = InferenceEngine(SPEC, device=card, n_slots=2)
    try:
        return eng.generate(PROMPT, max_new_tokens=N, sampler=GREEDY).token_ids
    finally:
        eng.shutdown()


def test_one_rank_nccl_mesh_captures_its_collectives(card, want):
    eng = InferenceEngine(SPEC, mesh=single_device_mesh(card), n_slots=2)
    try:
        assert eng.mesh.backend == "nccl" and eng.health()["mesh"]["decode"] == "graphs"
        k2 = flash_decode_attention.launches
        assert eng.generate(PROMPT, max_new_tokens=N, sampler=GREEDY).token_ids == want
        m = eng.metrics()
        assert m["decode_graph_captures_total"] >= 1 and m["decode_graph_replays_total"] >= 1
        assert flash_decode_attention.launches - k2 == SPEC.n_layers * (
            m["decode_steps_total"] + m["decode_graph_warmup_steps_total"])
        captured = {}
        for _, _, counts in eng._graphs._graphs.values():
            for fn, n in counts.items():
                if fn in COLLECTIVES.values():
                    captured[fn.name] = captured.get(fn.name, 0) + n
        # each captured step: 2 all-reduces a layer and the step's broadcast
        assert captured["all_reduce"] > 0 and captured["broadcast"] > 0
        assert captured["all_reduce"] == 2 * SPEC.n_layers * captured["broadcast"]
    finally:
        eng.shutdown()


def test_two_nccl_ranks_on_one_card_are_refused(card):
    with pytest.raises(ValueError, match='backend="gloo"'):
        make_mesh(MeshConfig(tp=2), [card, card])


@pytest.mark.parametrize("axes,impl", [(dict(tp=2), "ring"), (dict(sp=2), "ring"),
                                       (dict(sp=2), "ulysses")])
def test_two_ranks_sharing_the_card_over_gloo(card, want, axes, impl):
    mesh = make_mesh(MeshConfig(**axes), [card, card], backend="gloo")
    eng = InferenceEngine(SPEC, mesh=mesh, sp_impl=impl, n_slots=2)
    try:
        assert eng.health()["mesh"]["decode"] == "eager (gloo)"
        got = eng.generate(PROMPT, max_new_tokens=N, sampler=GREEDY).token_ids
        (rep,) = eng.rank_reports()
        assert got == want
        fed = [f for f in rep["fed"] if f]
        assert len(fed) == 1 and fed[0][-(N - 1):] == got[:-1]
        assert rep["launches"]["flash_decode"] > 0
        if impl == "ulysses" or "tp" in axes:
            assert rep["launches"]["flash_prefill"] == SPEC.n_layers
    finally:
        eng.shutdown()

