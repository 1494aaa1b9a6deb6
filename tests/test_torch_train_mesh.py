"""The mesh forms of the port's training (``training/``, ``mesh=``) on gloo
CPU ranks (rank 0 here, the others spawned by ``parallel/ranks.RankGroup``
and driven through ``trainer.train_steps``), against the port's one-device
step and the JAX package's ``loss_fn``, on the JAX package's float32
weights of llama-tiny (4 kv heads, so tp=4 cuts whole heads):

- dp=2, tp=2 and dp=2 × tp=2 steps on a batch whose rows carry unequal
  padding (so the dp ranks' real-token counts differ) give the one-device
  step's losses (within 1e-5 relative) and, gathered, its params (each leaf
  within 2e-5 of its scale, its largest |value|: AdamW's m/√v turns the
  f32 rounding of other summation orders into up to 1 % of a step on
  near-zero gradients); every rank reports the
  same loss, and the first equals JAX's ``loss_fn`` within 1e-5 relative;
- clipping on tp=2 (a norm well above the bound) gives the one-device
  clipped step's params;
- a checkpoint saved at dp=2 × tp=2 restores onto one device and onto tp=4
  with leaves equal to the saved state's (exactly), and each then takes a
  step with the same loss (1e-5 relative): the counterpart of JAX's
  ``test_restore_onto_different_mesh_shape``;
- a model served on a tp=2 engine from a tp=2 checkpoint gives the
  single-device engine's greedy tokens, and the checkpoint's logits equal
  the state's;
- a JAX TrainState resumes onto a tp=2 mesh (``train_state_from_numpy(
  mesh=)``): each rank's leaves are its cut of the one-device conversion.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quorum_tpu.models.init import init_params as jax_init_params
from quorum_tpu.models.model_config import resolve_spec as jax_resolve_spec
from quorum_tpu.training import trainer as jtrainer
from quorum_tpu_torch.engine.engine import InferenceEngine
from quorum_tpu_torch.models.convert import params_from_numpy, shard_params
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.models.transformer import forward_logits
from quorum_tpu_torch.ops.sampling import SamplerConfig
from quorum_tpu_torch.parallel import MeshConfig, RankGroup, make_mesh
from quorum_tpu_torch.parallel.ranks import to_host
from quorum_tpu_torch.training import checkpoint, optim, trainer

OPTS = {"dtype": "float32", "max_seq": "64", "n_kv_heads": "4"}
SPEC = resolve_spec("llama-tiny", OPTS)
TOL = 1e-5  # losses, relative
PARAM_TOL = 2e-5  # params after a step, of each leaf's scale
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
    return jspec, jax.tree.map(np.asarray, jax_init_params(jspec, seed=1))


def _tokens() -> np.ndarray:
    """4 rows × 17 tokens; rows 0-1 (dp rank 0) keep 9 and 4 real tokens,
    rows 2-3 (dp rank 1) 17 and 13: the ranks' target counts differ."""
    tok = np.random.default_rng(5).integers(1, SPEC.vocab_size, (4, 17))
    for row, keep in ((0, 9), (1, 4), (3, 13)):
        tok[row, keep:] = 0
    return tok


@pytest.fixture(scope="module")
def groups():
    """One group of gloo CPU ranks per mesh shape, spawned on first use."""
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


def _gather(grp, shards: list) -> dict:
    """The whole tree from every rank's shard: the cut of each leaf is
    along the dim where it differs from the one-device leaf, in tp order
    (dp group 0's ranks)."""
    ranks = [r for r in range(grp.size) if grp.mesh.coords(r)["dp"] == 0]
    whole_shapes = {k: tuple(v.shape) for k, v in _walk(
        to_host(trainer.init_params(SPEC, device="cpu")))}
    out = {}
    for name, _ in _walk(shards[0]):
        parts = [dict(_walk(shards[r]))[name] for r in ranks]
        want = whole_shapes[name]
        if parts[0].shape == want:
            out[name] = parts[0]
        else:
            dim = next(d for d, (a, b) in enumerate(zip(parts[0].shape, want)) if a != b)
            out[name] = np.concatenate(parts, axis=dim)
    return out


def _walk(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _walk(v, name)
        elif v is not None:
            yield name, np.asarray(v)


def _assert_leaves_close(got: dict, want_tree, tol=PARAM_TOL):
    want = dict(_walk(to_host(want_tree)))
    assert set(got) == set(want)
    for name, w in want.items():
        scale = max(float(np.max(np.abs(w))), 1e-30)
        err = float(np.max(np.abs(got[name] - w)))
        assert err <= tol * scale, (name, err, scale)


@pytest.mark.parametrize("axes", [dict(dp=2), dict(tp=2), dict(dp=2, tp=2)],
                         ids=["dp2", "tp2", "dp2_tp2"])
def test_mesh_step_equals_the_one_device_step(groups, weights, axes):
    jspec, params_np = weights
    tokens = _tokens()
    grp = groups(**axes)
    outs = _run(grp, tokens, params=params_np, steps=2, opt=OPT, return_params=True)
    state, want = _one_device(params_np, tokens, 2, OPT)
    for o in outs:  # every rank holds the global loss
        assert o["losses"] == outs[0]["losses"]
    np.testing.assert_allclose(outs[0]["losses"], want, rtol=TOL)
    jloss = float(jtrainer.loss_fn(jax.tree.map(jnp.asarray, params_np), jspec,
                                   jnp.asarray(tokens, jnp.int32)))
    np.testing.assert_allclose(outs[0]["losses"][0], jloss, rtol=TOL)
    _assert_leaves_close(_gather(grp, [o["params"] for o in outs]), state.params)
    if axes.get("dp", 1) > 1:
        assert outs[0]["grad_allreduce_bytes"] > 0


def test_clipping_under_tp_equals_the_unsharded_clipping(groups, weights):
    _, params_np = weights
    tokens = _tokens()
    opt = dict(lr=1e-3, grad_clip=1.0)
    params = params_from_numpy(params_np, device="cpu", dtype="float32")
    _, grads = trainer.value_and_grad(params, SPEC, torch.as_tensor(tokens))
    norm = float(optim.global_norm(grads))
    assert norm > 1.5 * opt["grad_clip"]  # the clip acts
    grp = groups(tp=2)
    outs = _run(grp, tokens, params=params_np, steps=2, opt=opt, return_params=True)
    # the tp ranks' norm is the whole tree's: cut leaves summed over tp,
    # replicated ones counted once
    for o in outs:
        np.testing.assert_allclose(o["grad_norms"][0], norm, rtol=TOL)
    state, want = _one_device(params_np, tokens, 2, opt)
    np.testing.assert_allclose(outs[0]["losses"], want, rtol=TOL)
    _assert_leaves_close(_gather(grp, [o["params"] for o in outs]), state.params)


def test_checkpoint_from_dp2_tp2_restores_onto_tp4_and_one_device(groups, weights, tmp_path):
    _, params_np = weights
    tokens = _tokens()
    path = str(tmp_path / "ckpt")
    src = groups(dp=2, tp=2)
    saved = _run(src, tokens, params=params_np, steps=1, opt=OPT, save=path,
                 return_params=True)
    assert saved[0]["saved_bytes"] > 0 and all(o["saved_bytes"] == 0 for o in saved[1:])
    whole = _gather(src, [o["params"] for o in saved])
    # onto one device: the leaves as saved, then a step
    optimizer = trainer.make_optimizer(**OPT)
    one = checkpoint.restore_checkpoint(path, SPEC, device="cpu", optimizer=optimizer)
    assert int(one.step) == 1
    for name, leaf in _walk(to_host(one.params)):
        np.testing.assert_array_equal(leaf, whole[name])
    _, next_one = trainer.make_train_step(SPEC, device="cpu", optimizer=optimizer)(one, tokens)
    # onto tp=4: each rank's leaves are its cut of the saved ones, then a step
    dst = groups(tp=4)
    restored = _run(dst, None, resume=path, steps=0, opt=OPT, return_params=True)
    for r, o in enumerate(restored):
        want = to_host(shard_params(params_from_numpy(_nest(whole), device="cpu"), dst.mesh, r,
                                    SPEC))
        for name, leaf in _walk(o["params"]):
            np.testing.assert_array_equal(leaf, dict(_walk(want))[name])
    stepped = _run(dst, tokens, resume=path, steps=1, opt=OPT)
    np.testing.assert_allclose(stepped[0]["losses"][0], float(next_one), rtol=TOL)


def _nest(flat: dict) -> dict:
    """``{"blocks.wq": x, "tok_emb": y}`` → the params tree (absent leaves
    None, as the one-device tree has them)."""
    tree = to_host(trainer.init_params(SPEC, device="cpu"))
    out = {k: (None if v is None else flat[k]) for k, v in tree.items() if k != "blocks"}
    out["blocks"] = {k: (None if v is None else flat[f"blocks.{k}"])
                     for k, v in tree["blocks"].items()}
    return out


def test_served_from_a_tp2_checkpoint(groups, weights, tmp_path):
    _, params_np = weights
    tokens = _tokens()
    path = str(tmp_path / "ckpt")
    grp = groups(tp=2)
    outs = _run(grp, tokens, params=params_np, steps=1, opt=OPT, save=path,
                return_params=True)
    state = _nest(_gather(grp, [o["params"] for o in outs]))
    served = checkpoint.restore_params(path, SPEC, device="cpu")
    for name, leaf in _walk(to_host(served)):
        np.testing.assert_array_equal(leaf, dict(_walk(state))[name])
    toks = torch.as_tensor([[5, 6, 7, 8]])
    with torch.no_grad():
        a = forward_logits(params_from_numpy(state, device="cpu"), SPEC, toks,
                           plain_attention=True)
        b = forward_logits(served, SPEC, toks, plain_attention=True)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    greedy = SamplerConfig(temperature=0.0)
    single = InferenceEngine(SPEC, device="cpu", params=served, n_slots=2, decode_chunk=4)
    mesh_eng = InferenceEngine(SPEC, mesh=make_mesh(MeshConfig(tp=2), ["cpu"] * 2),
                               params=served, n_slots=2, decode_chunk=4)
    try:
        want = single.generate([5, 6, 7], max_new_tokens=6, sampler=greedy).token_ids
        assert len(want) == 6
        assert mesh_eng.generate([5, 6, 7], max_new_tokens=6, sampler=greedy).token_ids == want
    finally:
        single.shutdown()
        mesh_eng.shutdown()


def test_jax_state_resumes_onto_a_tp2_mesh(weights):
    """``train_state_from_numpy(mesh=)``: a JAX TrainState (after a step of
    JAX's trainer) becomes each tp rank's cut of the port's state, leaf for
    leaf the cut of the one-device conversion (optimizer moments too)."""
    from types import SimpleNamespace

    from quorum_tpu.parallel import MeshConfig as JaxMeshConfig
    from quorum_tpu.parallel import make_mesh as jax_make_mesh
    from quorum_tpu_torch.models.convert import train_state_from_numpy
    from quorum_tpu_torch.parallel.sharding import rank_cut

    jspec, _ = weights
    jmesh = jax_make_mesh(JaxMeshConfig())
    jstate = jtrainer.train_init(jspec, jmesh, seed=4)
    jstate, _ = jtrainer.make_train_step(jspec, jmesh)(jstate, _tokens())
    host = jax.tree.map(np.asarray, jstate)
    whole = train_state_from_numpy(*host, device="cpu")
    layout = make_mesh(MeshConfig(tp=2), ["cpu"] * 2)
    for r in range(2):
        rank = SimpleNamespace(mesh=layout, rank=r, device=torch.device("cpu"))
        mine = train_state_from_numpy(*host, mesh=rank, spec=SPEC)
        cut = rank_cut(SPEC, layout, r)
        assert int(mine.step) == int(whole.step) == 1
        for got, want in ((mine.params, whole.params), (mine.opt_state[0].mu,
                                                          whole.opt_state[0].mu)):
            for name, leaf in _walk(to_host(got)):
                full = dict(_walk(to_host(want)))[name]
                np.testing.assert_array_equal(
                    leaf, cut(name.split(".")[-1], torch.as_tensor(full)).numpy())
