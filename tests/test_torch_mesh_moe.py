"""MoE specs on multi-rank engines: mixtral-tiny (4 experts, top-2) with its
experts cut over tp, as the JAX package cuts them (``sharding.py``'s
``experts`` → tp; ``tests/test_engine_mesh.py:85-92`` serves it on dp=2 ×
tp=4), on gloo CPU ranks in float32 on the JAX package's weights:

- tp=2 (2 experts a rank), tp=4 (one), dp=2 × tp=2 and tp=3 (4 experts do
  not divide over 3: every expert on every rank, the router's picks the
  same, no expert sum over tp) give the JAX single-device engine's greedy
  tokens on a short prompt (decode's dense experts) and a long one (the
  admission's grouped expert buffers), and the port's one-rank engine's
  sampled tokens;
- each rank holds E/tp experts' weights and the whole router.
"""

import jax
import numpy as np
import pytest
import torch

from quorum_tpu.engine.engine import InferenceEngine as JaxEngine
from quorum_tpu.models.init import init_params as jax_init_params
from quorum_tpu.models.model_config import resolve_spec as jax_resolve_spec
from quorum_tpu.ops.sampling import SamplerConfig as JaxSampler
from quorum_tpu_torch.engine.engine import InferenceEngine
from quorum_tpu_torch.models.convert import params_from_numpy
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.ops.sampling import SamplerConfig
from quorum_tpu_torch.parallel import MeshConfig, make_mesh

OPTS = {"dtype": "float32"}
GREEDY = SamplerConfig(temperature=0.0)
SAMPLED = SamplerConfig(temperature=0.8, top_p=0.9)
PROMPTS = [[5, 6, 7], [(11 + 7 * i) % 500 for i in range(48)]]
N_TOK = 10
KW = dict(decode_chunk=4, n_slots=2)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def mixtral():
    jspec = jax_resolve_spec("mixtral-tiny", OPTS)
    params = jax.tree.map(np.asarray, jax_init_params(jspec, seed=17))
    jeng = JaxEngine(jspec, params=params, **KW)
    try:
        want = [jeng.generate(p, max_new_tokens=N_TOK, sampler=JaxSampler(temperature=0.0))
                .token_ids for p in PROMPTS]
    finally:
        jeng.shutdown()
    one = InferenceEngine(resolve_spec("mixtral-tiny", OPTS), device="cpu",
                          params=params_from_numpy(params, device="cpu"), **KW)
    try:
        sampled = [one.generate(p, max_new_tokens=N_TOK, sampler=SAMPLED, seed=3).token_ids
                   for p in PROMPTS]
    finally:
        one.shutdown()
    return params, want, sampled


@pytest.mark.parametrize("axes", [dict(tp=2), dict(tp=4), dict(dp=2, tp=2), dict(tp=3)],
                         ids=["tp2", "tp4", "dp2_tp2", "tp3"])
def test_moe_on_a_mesh_equals_the_jax_engine(mixtral, axes):
    params, want, sampled = mixtral
    spec = resolve_spec("mixtral-tiny", OPTS)
    cfg = MeshConfig(**axes)
    eng = InferenceEngine(spec, mesh=make_mesh(cfg, ["cpu"] * cfg.n_devices, timeout_s=30.0),
                          params=params_from_numpy(params, device="cpu"), **KW)
    try:
        assert [eng.generate(p, max_new_tokens=N_TOK, sampler=GREEDY).token_ids
                for p in PROMPTS] == want
        assert [eng.generate(p, max_new_tokens=N_TOK, sampler=SAMPLED, seed=3).token_ids
                for p in PROMPTS] == sampled
        tp = cfg.tp
        per = spec.n_experts // tp if spec.n_experts % tp == 0 else spec.n_experts
        b = eng.params["blocks"]
        assert b["moe_w_gate"].shape[1] == per and b["moe_w_down"].shape[1] == per
        assert tuple(b["router"].shape) == (spec.n_layers, spec.d_model, spec.n_experts)
        expert = 3 * spec.d_model * spec.d_ff * 4  # gate, up, down; f32
        dense = eng.rank_reports()
        assert len({r["weight_bytes"] for r in dense} | {sum(
            t.numel() * t.element_size() for t in _leaves(eng.params))}) == 1
        assert sum(t.numel() * t.element_size() for t in _leaves(
            {k: v for k, v in b.items() if k.startswith("moe_")})) == spec.n_layers * per * expert
    finally:
        eng.shutdown()


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        elif v is not None:
            yield v
