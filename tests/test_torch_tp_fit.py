"""Tensor-parallel sizes that do not divide the model's dims, served and
trained as the JAX package does (its ``_fit_spec`` leaves a dim the mesh
does not divide whole; ``replicate_kv_heads`` replicates kv heads tp does
not divide), on gloo CPU ranks in float32 on the JAX package's weights:

- llama-tiny with 12 heads over 3 kv heads on tp=2 (query-head groups cut
  unevenly: the kv projections whole on every rank, each rank's cache the
  kv heads its own query heads read) and with its 4 heads on tp=3 (heads,
  MLP hidden and vocab whole on every rank, no collective summing them)
  give the JAX single-device engine's greedy tokens and the port's
  one-rank engine's sampled tokens;
- on those meshes, and on tp=4 over 2 kv heads (each kv head held by two
  ranks), each rank's backward gives the cut of the one-device gradients
  (the partial gradients of whole or shared kv projections summed over the
  ranks holding them), two clipped steps the one-device losses and norm
  (the tolerances of ``tests/test_torch_train_mesh.py``), and a checkpoint
  saved from the mesh holds the ranks' params put back together.
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
from quorum_tpu_torch.models.convert import params_from_numpy, shard_params
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.ops.sampling import SamplerConfig
from quorum_tpu_torch.parallel import MeshConfig, RankGroup, make_mesh
from quorum_tpu_torch.parallel.ranks import to_host
from quorum_tpu_torch.training import checkpoint, optim, trainer

GREEDY = SamplerConfig(temperature=0.0)
SAMPLED = SamplerConfig(temperature=0.8, top_p=0.9)
PROMPTS = [[5, 6, 7], [(5 + 3 * i) % 500 for i in range(40)]]
N_TOK = 10
TOL = 1e-5
TRAIN_STEPS = "quorum_tpu_torch.training.trainer:train_steps"
CASES = {
    "12h3kv_tp2": ({"dtype": "float32", "n_heads": "12", "n_kv_heads": "3"}, 2),
    "4h_tp3": ({"dtype": "float32"}, 3),
    "2kv_tp4": ({"dtype": "float32"}, 4),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _weights(opts):
    jspec = jax_resolve_spec("llama-tiny", opts)
    return jspec, jax.tree.map(np.asarray, jax_init_params(jspec, seed=13))


@pytest.mark.parametrize("case", ["12h3kv_tp2", "4h_tp3"])
def test_serves_the_jax_engines_tokens(case):
    opts, tp = CASES[case]
    jspec, params = _weights(opts)
    jeng = JaxEngine(jspec, params=params, decode_chunk=4, n_slots=2)
    try:
        want = [jeng.generate(p, max_new_tokens=N_TOK, sampler=JaxSampler(temperature=0.0))
                .token_ids for p in PROMPTS]
    finally:
        jeng.shutdown()
    spec = resolve_spec("llama-tiny", opts)
    kw = dict(decode_chunk=4, n_slots=2)
    one = InferenceEngine(spec, device="cpu", params=params_from_numpy(params, device="cpu"), **kw)
    eng = InferenceEngine(spec, mesh=make_mesh(MeshConfig(tp=tp), ["cpu"] * tp, timeout_s=30.0),
                          params=params_from_numpy(params, device="cpu"), **kw)
    try:
        assert [eng.generate(p, max_new_tokens=N_TOK, sampler=GREEDY).token_ids
                for p in PROMPTS] == want
        for seed, p in enumerate(PROMPTS):
            assert (eng.generate(p, max_new_tokens=N_TOK, sampler=SAMPLED, seed=seed).token_ids
                    == one.generate(p, max_new_tokens=N_TOK, sampler=SAMPLED,
                                    seed=seed).token_ids)
        if case == "12h3kv_tp2":  # each rank's cache: the kv heads its heads read
            assert eng._ck.shape[2] == 3
        else:  # every head on every rank, and no sum over tp of whole products
            assert eng._ck.shape[2] == spec.n_kv_heads
            assert eng.rank_reports()[0]["collectives"]["all_reduce"] == 0
    finally:
        one.shutdown()
        eng.shutdown()


def _tokens(vocab):
    tok = np.random.default_rng(5).integers(1, vocab, (4, 17))
    tok[0, 9:] = 0
    tok[1, 4:] = 0
    return tok


def _one_device(spec, params_np, tokens, opt):
    optimizer = trainer.make_optimizer(**opt)
    params = params_from_numpy(params_np, device="cpu", dtype="float32")
    state = trainer.TrainState(params, optimizer.init(params), torch.zeros((), dtype=torch.int32))
    loss, grads = trainer.value_and_grad(params, spec, torch.as_tensor(tokens))
    norm = float(optim.global_norm(grads))
    grads = to_host(grads)
    step = trainer.make_train_step(spec, device="cpu", optimizer=optimizer)
    losses = []
    for _ in range(2):
        state, step_loss = step(state, tokens)
        losses.append(float(step_loss))
    return float(loss), grads, norm, losses


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        elif v is not None:
            yield prefix + k, np.asarray(v)


def _cut(tree_np, mesh, r, spec) -> dict:
    return dict(_flat(to_host(shard_params(params_from_numpy(tree_np, device="cpu"), mesh, r,
                                           spec))))


@pytest.mark.parametrize("case", list(CASES))
def test_training_step_equals_the_one_device_step(case, tmp_path):
    """Each rank's loss and gradients (a backward on its cut) equal the
    one-device backward's cut of them (f32 sums in another order: within
    1e-5 of each leaf's scale); two clipped AdamW steps give the one-device
    losses and norm; a checkpoint saved from the mesh holds the ranks'
    params put back together, each leaf exactly."""
    opts, tp = CASES[case]
    _, params_np = _weights(opts)
    spec = resolve_spec("llama-tiny", opts)
    tokens = _tokens(spec.vocab_size)
    opt = dict(lr=1e-3, grad_clip=1.0)
    loss, grads, norm, want = _one_device(spec, params_np, tokens, opt)
    mesh = make_mesh(MeshConfig(tp=tp), ["cpu"] * tp, timeout_s=60.0)
    grp = RankGroup(mesh)
    grp.start()
    try:
        backward = grp.run("quorum_tpu_torch.training.trainer:value_and_grad",
                           [(to_host(shard_params(params_from_numpy(params_np, device="cpu"),
                                                  mesh, r, spec)), spec, tokens)
                            for r in range(tp)])
        save = str(tmp_path / "ck")
        outs = grp.run(TRAIN_STEPS, [(spec, tokens)] * tp,
                       [dict(params=params_np, steps=2, opt=opt, return_params=True,
                             save=save)] * tp)
    finally:
        grp.stop()
    for r, (rank_loss, rank_grads) in enumerate(backward):
        np.testing.assert_allclose(float(rank_loss), loss, rtol=TOL)
        mine, got = _cut(grads, mesh, r, spec), dict(_flat(rank_grads))
        assert sorted(got) == sorted(mine)
        for name, w in mine.items():
            scale = max(float(np.max(np.abs(w))), 1e-30)
            assert float(np.max(np.abs(got[name] - w))) <= TOL * scale, (r, name)
    for o in outs:
        assert o["losses"] == outs[0]["losses"]
        np.testing.assert_allclose(o["grad_norms"][0], norm, rtol=TOL)
    np.testing.assert_allclose(outs[0]["losses"], want, rtol=TOL)
    restored = to_host(checkpoint.restore_params(save, spec, device="cpu"))
    for r, o in enumerate(outs):
        mine, got = _cut(restored, mesh, r, spec), dict(_flat(o["params"]))
        for name, w in mine.items():
            assert np.array_equal(got[name], w), (r, name)
