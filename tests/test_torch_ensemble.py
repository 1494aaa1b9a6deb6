"""Logit-ensemble decoding (``ensemble=M``) of the port against the JAX
package's (tests/test_ensemble.py).

M weight sets decode ONE stream: every model call runs the M members and
averages their logits in f32 before sampling. The port's greedy stream must
equal a manual rollout that averages the members' cache-free
``forward_logits`` at every step, and the JAX ``ensemble=3`` engine's greedy
stream on the same weights (read back from the JAX engine and converted).
llama-tiny, float32; logits within 1e-4, tokens exact.
"""

import jax
import numpy as np
import pytest
import torch

from quorum_tpu.engine.engine import InferenceEngine as JaxEngine
from quorum_tpu.models.model_config import resolve_spec as jax_resolve_spec
from quorum_tpu.ops.sampling import SamplerConfig as JaxSampler
from quorum_tpu_torch.backends.cuda_backend import CudaBackend
from quorum_tpu_torch.config import BackendSpec
from quorum_tpu_torch.engine.engine import InferenceEngine, shutdown_all_engines
from quorum_tpu_torch.models.convert import stacked_params_from_numpy
from quorum_tpu_torch.models.init import init_params_stacked
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.models.transformer import (decode_step, forward_logits, init_cache,
                                                 member_params)
from quorum_tpu_torch.ops.sampling import SamplerConfig

OPTS = {"dtype": "float32", "max_seq": "64"}
GREEDY = SamplerConfig(temperature=0.0)
TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def spec():
    return resolve_spec("llama-tiny", OPTS)


def _manual_rollout(spec, params, n_members, prompt, n_new):
    """Full-context forward per member, logits averaged, argmax."""
    seq, out = list(prompt), []
    for _ in range(n_new):
        tokens = torch.tensor([seq])
        avg = sum(forward_logits(member_params(params, m), spec, tokens)[0, -1]
                  for m in range(n_members)) / n_members
        out.append(int(avg.argmax()))
        seq.append(out[-1])
    return out


def test_ensemble_step_is_the_mean_of_the_members(spec):
    params = init_params_stacked(spec, [0, 1, 2], device="cpu")
    s = 2
    ck, cv = init_cache(spec, 3 * s, device="cpu")
    gen = torch.Generator().manual_seed(0)
    ck.normal_(generator=gen)
    cv.normal_(generator=gen)
    tok, pos = torch.tensor([17, 301]), torch.tensor([5, 30], dtype=torch.int32)
    got, _, _ = decode_step(params, spec, tok, pos, ck.clone(), cv.clone(), ensemble=3)
    parts = []
    for m in range(3):
        rows = slice(m * s, (m + 1) * s)
        lg, _, _ = decode_step(member_params(params, m), spec, tok, pos,
                               ck[:, rows].clone(), cv[:, rows].clone())
        parts.append(lg)
    torch.testing.assert_close(got, sum(parts) / 3, atol=TOL, rtol=0)


def test_ensemble_matches_manual_logit_average(spec):
    eng = InferenceEngine(spec, device="cpu", decode_chunk=4, ensemble=2, seed=0)
    try:
        prompt = [3, 5, 7, 11]
        got = eng.generate(prompt, max_new_tokens=6, sampler=GREEDY).token_ids
        assert got == _manual_rollout(spec, eng.params, 2, prompt, 6)
    finally:
        eng.shutdown()


def test_ensemble_matches_the_jax_ensemble_engine(spec):
    jspec = jax_resolve_spec("llama-tiny", OPTS)
    jeng = JaxEngine(jspec, seed=7, ensemble=3, decode_chunk=4, n_slots=2, prefill_chunk=0,
                     prefix_cache=False)
    teng = None
    try:
        greedy_j = JaxSampler(temperature=0.0)
        prompts = [[2, 4, 6, 8, 10], list(range(30, 50))]
        want = [jeng.generate(p, max_new_tokens=10, sampler=greedy_j).token_ids for p in prompts]
        params = stacked_params_from_numpy(jax.tree.map(np.asarray, jeng.params), device="cpu")
        teng = InferenceEngine(spec, device="cpu", ensemble=3, params=params, decode_chunk=4,
                               n_slots=2)
        got = [teng.generate(p, max_new_tokens=10, sampler=GREEDY).token_ids for p in prompts]
        assert got == want
        assert got[0] == _manual_rollout(spec, params, 3, prompts[0], 10)
    finally:
        jeng.shutdown()
        if teng is not None:
            teng.shutdown()


def test_ensemble_differs_from_single_member(spec):
    ens = InferenceEngine(spec, device="cpu", decode_chunk=4, ensemble=2, seed=10)
    solo = InferenceEngine(spec, device="cpu", decode_chunk=4, seed=10)
    try:
        prompt = [2, 4, 6, 8, 10]
        assert (ens.generate(prompt, max_new_tokens=12, sampler=GREEDY).token_ids
                != solo.generate(prompt, max_new_tokens=12, sampler=GREEDY).token_ids)
        assert ens.metrics()["slots"] == 4 and ens.metrics()["members"] == 1
    finally:
        ens.shutdown()
        solo.shutdown()


def test_ensemble_url_knob_and_rejections(spec):
    try:
        b = CudaBackend.from_spec(BackendSpec(
            name="E", model="m", url="cuda://llama-tiny?ensemble=2&slots=1&device=cpu"))
        assert b.engine.ensemble == 2
        plain = CudaBackend.from_spec(BackendSpec(
            name="P", model="m", url="cuda://llama-tiny?slots=1&device=cpu"))
        assert plain.engine is not b.engine and plain.engine.ensemble == 1
        with pytest.raises(ValueError, match="mutually exclusive"):
            CudaBackend.from_spec(BackendSpec(
                name="X", model="m", url="cuda://llama-tiny?ensemble=2&members=2&device=cpu"))
        with pytest.raises(ValueError, match="member_seeds=shared does not compose"):
            InferenceEngine(spec, device="cpu", ensemble=2, member_seeds="shared")
    finally:
        shutdown_all_engines()
