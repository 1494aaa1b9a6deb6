"""The pipelined train step (``parallel/pipeline.py``'s training half,
``make_train_step(mesh=)`` on a mesh with pp > 1) on gloo CPU ranks (rank 0
here, the others spawned by ``parallel/ranks.RankGroup`` and driven
through ``trainer.train_steps``), against the JAX package's ``pp_loss_fn``
on its virtual CPU devices and the port's one-device step, on the JAX
package's float32 weights of llama-tiny at 4 layers:

- the pp=2 loss equals JAX's ``pp_loss_fn`` within 1e-4 relative, and the
  one-device loss;
- every leaf's pp=2 gradient equals its stage's cut of the one-device
  gradient (within 1e-5 of the leaf's scale), and the stages hold no leaf
  of another stage;
- one AdamW step with clipping that binds (the norm summed over the
  stages) equals the one-device clipped step;
- dp=2 × pp=2 lowers the loss over 5 steps (JAX's
  ``test_pp_train_step_decreases_loss``) on a batch whose dp ranks count
  different real tokens, its first loss the one-device step's;
- a mesh with tp or sp beside pp, or pp not dividing the layers, is
  refused in JAX's words;
- a checkpoint written on pp=2 restores onto one device bit for bit (the
  layers at their global indices), and one written there restores onto
  pp=2 bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quorum_tpu.models.init import init_params as jax_init_params
from quorum_tpu.models.model_config import resolve_spec as jax_resolve_spec
from quorum_tpu.parallel import MeshConfig as JaxMeshConfig
from quorum_tpu.parallel import make_mesh as jax_make_mesh
from quorum_tpu.parallel import pipeline as jpipeline
from quorum_tpu_torch.models.convert import params_from_numpy, shard_params
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.parallel import MeshConfig, RankGroup, make_mesh, pipeline
from quorum_tpu_torch.parallel.ranks import to_host
from quorum_tpu_torch.training import checkpoint, optim, trainer

OPTS = {"dtype": "float32", "max_seq": "64", "n_kv_heads": "4", "n_layers": "4"}
SPEC = resolve_spec("llama-tiny", OPTS)
TOL = 1e-4  # losses against JAX, relative (f32)
GRAD_TOL = 1e-5  # gradients, of each leaf's scale
PARAM_TOL = 2e-5  # params after a step, of each leaf's scale (test_torch_train_mesh's)
OPT = dict(lr=1e-3)
DRIVER = "quorum_tpu_torch.training.trainer:train_steps"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def weights():
    jspec = jax_resolve_spec("llama-tiny", OPTS)
    return jspec, jax.tree.map(np.asarray, jax_init_params(jspec, seed=2))


def _tokens() -> np.ndarray:
    """4 rows × 17 tokens; rows 0-1 (dp rank 0) keep 9 and 4 real tokens,
    rows 2-3 (dp rank 1) 17 and 13."""
    tok = np.random.default_rng(7).integers(1, SPEC.vocab_size, (4, 17))
    for row, keep in ((0, 9), (1, 4), (3, 13)):
        tok[row, keep:] = 0
    return tok


@pytest.fixture(scope="module")
def groups():
    made: dict = {}

    def get(**axes):
        key = tuple(sorted(axes.items()))
        if key not in made:
            cfg = MeshConfig(**axes)
            grp = RankGroup(make_mesh(cfg, ["cpu"] * cfg.n_devices, timeout_s=60.0))
            grp.start()
            made[key] = grp
        return made[key]

    yield get
    for grp in made.values():
        grp.stop()


def _run(grp, tokens, **kw):
    return grp.run(DRIVER, [(SPEC, tokens)] * grp.size, [kw] * grp.size)


def _walk(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _walk(v, name)
        elif v is not None:
            yield name, np.asarray(v)


def _stage_cut(grp, rank: int, tree) -> dict:
    """``tree`` (one device's, as torch) cut to rank ``rank``'s stage."""
    return dict(_walk(to_host(shard_params(tree, grp.mesh, rank, SPEC))))


def _assert_close(got: dict, want: dict, tol: float):
    assert set(got) == set(want)
    for name, w in want.items():
        scale = max(float(np.max(np.abs(w))), 1e-30)
        err = float(np.max(np.abs(got[name] - w)))
        assert err <= tol * scale, (name, err, scale)


def _one_device(params_np, tokens, steps, opt):
    optimizer = trainer.make_optimizer(**opt)
    params = params_from_numpy(params_np, device="cpu", dtype="float32")
    state = trainer.TrainState(params, optimizer.init(params), torch.zeros((), dtype=torch.int32))
    step = trainer.make_train_step(SPEC, device="cpu", optimizer=optimizer)
    losses = []
    for _ in range(steps):
        state, loss = step(state, tokens)
        losses.append(float(loss))
    return state, losses


def test_pp2_loss_equals_jax_pp_loss_fn(groups, weights):
    jspec, params_np = weights
    tokens = _tokens()
    jmesh = jax_make_mesh(JaxMeshConfig(pp=2), jax.devices()[:2])
    staged = jpipeline.shard_pytree_pp(jmesh, jax.tree.map(jnp.asarray, params_np))
    jloss = float(jpipeline.pp_loss_fn(staged, jspec, jnp.asarray(tokens, jnp.int32), jmesh, 2,
                                       remat=False))
    grp = groups(pp=2)
    params = params_from_numpy(params_np, device="cpu", dtype="float32")
    cuts = [to_host(shard_params(params, grp.mesh, r, SPEC)) for r in range(grp.size)]
    got = grp.run("quorum_tpu_torch.parallel.pipeline:pp_loss_fn",
                  [(cuts[r], SPEC, tokens) for r in range(grp.size)],
                  [dict(n_micro=2)] * grp.size)
    assert float(got[0]) == float(got[1])  # every stage returns the loss
    np.testing.assert_allclose(float(got[0]), jloss, rtol=TOL)
    one = float(trainer.loss_fn(params, SPEC, torch.as_tensor(tokens), remat=False))
    np.testing.assert_allclose(float(got[0]), one, rtol=TOL)


def test_pp2_gradients_are_the_cut_of_the_one_device_gradient(groups, weights):
    _, params_np = weights
    tokens = _tokens()
    params = params_from_numpy(params_np, device="cpu", dtype="float32")
    loss, grads = trainer.value_and_grad(params, SPEC, torch.as_tensor(tokens))
    grp = groups(pp=2)
    outs = _run(grp, tokens, params=params_np, steps=1, opt=OPT, return_grads=True)
    for r, o in enumerate(outs):
        np.testing.assert_allclose(o["losses"][0], float(loss), rtol=1e-5)
        got = dict(_walk(o["grads"]))
        _assert_close(got, _stage_cut(grp, r, grads), GRAD_TOL)
    assert "tok_emb" in dict(_walk(outs[0]["grads"]))
    assert not any(n in dict(_walk(outs[1]["grads"]))
                   for n in ("tok_emb", "lm_head", "final_norm_w"))


def test_pp2_clipped_adamw_step_equals_the_one_device_step(groups, weights):
    _, params_np = weights
    tokens = _tokens()
    opt = dict(lr=1e-3, grad_clip=1.0)
    params = params_from_numpy(params_np, device="cpu", dtype="float32")
    _, grads = trainer.value_and_grad(params, SPEC, torch.as_tensor(tokens))
    norm = float(optim.global_norm(grads))
    assert norm > 1.5 * opt["grad_clip"]  # the clip binds
    grp = groups(pp=2)
    outs = _run(grp, tokens, params=params_np, steps=1, opt=opt, return_params=True)
    for o in outs:  # every stage scales by the whole tree's norm
        np.testing.assert_allclose(o["grad_norms"][0], norm, rtol=1e-5)
    state, want = _one_device(params_np, tokens, 1, opt)
    np.testing.assert_allclose(outs[0]["losses"], want, rtol=1e-5)
    for r, o in enumerate(outs):
        _assert_close(dict(_walk(o["params"])), _stage_cut(grp, r, state.params), PARAM_TOL)


def test_dp2_pp2_lowers_the_loss(groups, weights):
    _, params_np = weights
    tokens = _tokens()
    grp = groups(dp=2, pp=2)
    outs = _run(grp, tokens, params=params_np, steps=5, opt=OPT)
    losses = outs[0]["losses"]
    for o in outs:
        assert o["losses"] == losses
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    _, want = _one_device(params_np, tokens, 1, OPT)
    np.testing.assert_allclose(losses[0], want[0], rtol=1e-5)
    assert outs[0]["grad_allreduce_bytes"] > 0


@pytest.mark.parametrize("cfg", [dict(pp=2, tp=2), dict(pp=2, sp=2), dict(pp=3)],
                         ids=["tp", "sp", "pp3"])
def test_refusals_read_as_jax(weights, cfg):
    jspec, params_np = weights
    n = MeshConfig(**cfg).n_devices
    jmesh = jax_make_mesh(JaxMeshConfig(**cfg), jax.devices()[:n])
    with pytest.raises(ValueError) as want:
        jpipeline.pipeline_forward_logits(jax.tree.map(jnp.asarray, params_np), jspec,
                                          jnp.ones((2, 8), jnp.int32), jmesh, n_micro=2)
    layout = make_mesh(MeshConfig(**cfg), ["cpu"] * n)
    for build in (pipeline.make_pp_train_step, pipeline.pp_train_init):
        with pytest.raises(ValueError) as got:
            build(SPEC, layout)
        assert str(got.value) == str(want.value)
    assert ("dp only" if "tp" in cfg or "sp" in cfg else "divide") in str(want.value)


def test_checkpoint_pp2_to_one_device_and_back_bit_for_bit(groups, weights, tmp_path):
    _, params_np = weights
    tokens = _tokens()
    grp = groups(pp=2)
    path = str(tmp_path / "pp")
    saved = _run(grp, tokens, params=params_np, steps=1, opt=OPT, save=path,
                 return_params=True, digest=True)
    assert saved[0]["saved_bytes"] > 0 and saved[1]["saved_bytes"] == 0
    optimizer = trainer.make_optimizer(**OPT)
    one = checkpoint.restore_checkpoint(path, SPEC, device="cpu", optimizer=optimizer)
    assert int(one.step) == 1
    for r, o in enumerate(saved):  # each stage's leaves at their global indices
        for name, leaf in _stage_cut(grp, r, one.params).items():
            np.testing.assert_array_equal(leaf, dict(_walk(o["params"]))[name])
    back = str(tmp_path / "one")
    checkpoint.save_checkpoint(back, one)
    restored = _run(grp, None, resume=back, steps=0, opt=OPT, digest=True)
    for o, s in zip(restored, saved):  # every stage's params and moments, bit for bit
        assert o["digest"] == s["digest"]


def test_a_lost_stage_ends_the_step_with_worker_lost(weights):
    """A stage killed mid-run: rank 0's step fails on the lost peer and
    ``RankGroup.run`` raises ``WorkerLost``, within the groups' timeout."""
    import threading
    import time

    from quorum_tpu_torch.parallel import WorkerLost

    _, params_np = weights
    grp = RankGroup(make_mesh(MeshConfig(pp=2), ["cpu"] * 2, timeout_s=30.0))
    grp.start()
    try:
        killer = threading.Timer(1.0, grp.kill, args=(1,))
        killer.start()
        t0 = time.monotonic()
        with pytest.raises(WorkerLost):
            _run(grp, _tokens(), params=params_np, steps=10_000, opt=OPT)
        assert time.monotonic() - t0 < 30.0
    finally:
        grp.stop()
