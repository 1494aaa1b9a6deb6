"""The port's training (``quorum_tpu_torch/training/``) against the JAX
package's, on the same float32 weights (JAX's ``init_params`` or
``train_init``, converted), on the CPU.

- ``loss_fn`` and every leaf's gradient against ``jax.value_and_grad``
  of JAX's ``loss_fn`` on llama-tiny, gpt2-tiny, gemma-tiny and
  mixtral-tiny, on rows with right padding: the loss within 1e-5
  relative, each leaf within 1e-5 of its largest |gradient| (at least
  1e-2 of the tree's: a vanishing gradient is noise on both sides);
- ``remat=True`` gradients equal ``remat=False`` ones bit for bit;
- the optimizer (``training/optim.py``) against optax on one sequence of
  gradients, for the recipe at a constant rate, with a warmup alone, with a
  warmup and cosine decay, with clipping, and accumulating 2 and 3
  micro-batches: the rate at every count within 1e-6 relative, the params
  after every update within 1e-6 of their scale and the state's leaves
  (values within 1e-5 of their scale, dtypes equal; bf16 moments at bf16);
- three train steps against JAX's ``make_train_step`` (losses within 1e-5
  relative, params within 1e-5 of their scale);
- a JAX TrainState mid-window (accumulation, clipping, a schedule) carried
  across by ``train_state_from_numpy`` and stepped once in the port,
  against JAX's next step;
- ``make_train_step``'s ``grads_hook`` sees the step's gradients before
  the update and changes nothing;
- the kernel wrappers refuse grad-requiring inputs under grad mode (and
  only then), and the kernel path of ``forward_logits`` with them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from quorum_tpu.models.init import init_params as jax_init_params
from quorum_tpu.models.model_config import resolve_spec as jax_resolve_spec
from quorum_tpu.parallel import MeshConfig, make_mesh
from quorum_tpu.training import trainer as jtrainer
from quorum_tpu_torch.models import transformer as ttf
from quorum_tpu_torch.models.convert import params_from_numpy, train_state_from_numpy
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.ops.flash_attention import flash_prefill_attention
from quorum_tpu_torch.ops.flash_decode import flash_decode_attention
from quorum_tpu_torch.ops.flash_decode_q8 import flash_decode_q8_attention
from quorum_tpu_torch.training import optim, trainer

PRESETS = ["llama-tiny", "gpt2-tiny", "gemma-tiny", "mixtral-tiny"]
OPTS = {"dtype": "float32", "max_seq": "64"}
GRAD_TOL = 1e-5    # of a leaf's largest |gradient|; the loss relative
# A leaf whose gradient vanishes (the key bias: softmax ignores a shift of
# a row) is rounding noise on both sides: its scale is at least this share
# of the tree's largest |gradient|.
VANISH = 1e-2
OPT_TOL = 1e-6     # of a leaf's scale, params after an update
STATE_TOL = 1e-5   # of a leaf's scale, optimizer state
STEP_TOL = 1e-5    # train steps: loss relative, params of their scale


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tokens(seed: int, vocab: int, batch: int = 3, seqlen: int = 12) -> np.ndarray:
    """Seeded ids in [1, vocab) with right padding (0): 4 pads on row 1, 7
    on row 2."""
    rng = np.random.RandomState(seed)
    tok = rng.randint(1, vocab, size=(batch, seqlen)).astype(np.int32)
    for row, n in ((1, 4), (2, 7)):
        if row < batch:
            tok[row, -n:] = 0
    return tok


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got: torch.Tensor, want, tol: float, what: str, floor: float = 1e-30) -> None:
    want = np.asarray(want)
    got_np = got.detach().float().numpy()
    scale = max(float(np.abs(want.astype(np.float32)).max()) if want.size else 0.0, floor)
    err = float(np.abs(got_np - want.astype(np.float32)).max()) if want.size else 0.0
    assert err <= tol * scale, f"{what}: max |Δ| {err:.3g} > {tol} × {scale:.3g}"


def _pair(jtree, ttree, check, path: str = "") -> None:
    """Walk a JAX tree and the port's together (dicts, NamedTuples by type
    name and fields, tuples, None), calling ``check(port, jax, path)`` on
    every leaf pair."""
    if jtree is None:
        assert ttree is None, path
        return
    if isinstance(jtree, dict):
        assert isinstance(ttree, dict) and set(ttree) == set(jtree), path
        for k in jtree:
            _pair(jtree[k], ttree[k], check, f"{path}.{k}")
        return
    if hasattr(jtree, "_fields"):
        assert type(ttree).__name__ == type(jtree).__name__, path
        assert ttree._fields == jtree._fields, path
        for f in jtree._fields:
            _pair(getattr(jtree, f), getattr(ttree, f), check, f"{path}.{f}")
        return
    if isinstance(jtree, tuple):
        assert isinstance(ttree, tuple) and len(ttree) == len(jtree), path
        for i, (a, b) in enumerate(zip(jtree, ttree)):
            _pair(a, b, check, f"{path}.{i}")
        return
    check(ttree, jtree, path)


def _state_check(tol: float):
    def check(t, j, path):
        j = np.asarray(j)
        assert str(t.dtype).replace("torch.", "") == j.dtype.name, (path, t.dtype, j.dtype)
        assert tuple(t.shape) == j.shape, path
        if j.dtype.kind in "iu":
            assert int(t) == int(j), path
        else:
            _close(t, j, tol, path)
    return check


# ---- loss and gradients ----------------------------------------------------


@pytest.mark.parametrize("name", PRESETS)
def test_loss_and_grads_match_jax(name):
    jspec = jax_resolve_spec(name, OPTS)
    spec = resolve_spec(name, OPTS)
    jparams = _np(jax_init_params(jspec, seed=3))
    tokens = _tokens(1, spec.vocab_size)
    jloss, jgrads = jax.jit(lambda p, t: jax.value_and_grad(jtrainer.loss_fn)(
        p, jspec, t, True))(jparams, jnp.asarray(tokens))
    loss, grads = trainer.value_and_grad(params_from_numpy(jparams, device="cpu"), spec,
                                         torch.as_tensor(tokens), remat=True)
    assert abs(float(loss) - float(jloss)) <= GRAD_TOL * abs(float(jloss))
    floor = VANISH * max(float(np.abs(g).max()) for g in jax.tree.leaves(_np(jgrads)))
    _pair(_np(jgrads), grads,
          lambda t, j, path: _close(t, j, GRAD_TOL, f"{name} grad{path}", floor))


@pytest.mark.parametrize("name", ["llama-tiny", "mixtral-tiny"])
def test_remat_grads_equal_plain_grads(name):
    spec = resolve_spec(name, OPTS)
    params = params_from_numpy(_np(jax_init_params(jax_resolve_spec(name, OPTS), seed=4)),
                               device="cpu")
    tokens = torch.as_tensor(_tokens(2, spec.vocab_size))
    l1, g1 = trainer.value_and_grad(params, spec, tokens, remat=True)
    l0, g0 = trainer.value_and_grad(params, spec, tokens, remat=False)
    assert torch.equal(l1, l0)
    for a, b in zip(optim.tree_leaves(g1), optim.tree_leaves(g0)):
        assert torch.equal(a, b)


# ---- the optimizer against optax ------------------------------------------

RECIPES = {
    "constant": {},
    "warmup": {"warmup_steps": 3},
    "warmup_cosine": {"warmup_steps": 2, "total_steps": 6},
    "clip": {"grad_clip": 0.5},
    "accum2": {"accum_steps": 2, "grad_clip": 2.0},
    "accum3": {"accum_steps": 3, "warmup_steps": 1, "total_steps": 5},
}


def _small_tree(rng, dtype):
    def arr(*shape):
        return rng.standard_normal(shape).astype(np.float32).astype(dtype)
    return {"tok_emb": arr(16, 8), "pos_emb": None, "final_norm_w": arr(8),
            "blocks": {"wq": arr(2, 8, 8), "bq": None, "w_up": arr(2, 8, 12)}}


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_optimizer_matches_optax(recipe):
    kw = RECIPES[recipe]
    rng = np.random.default_rng(5)
    jparams = _small_tree(rng, np.float32)
    jopt = jtrainer.make_optimizer(lr=1e-2, **kw)
    opt = trainer.make_optimizer(lr=1e-2, **kw)
    tparams = params_from_numpy(jparams, device="cpu")
    jstate, tstate = jopt.init(jparams), opt.init(tparams)
    _pair(jstate, tstate, _state_check(0.0), "init")
    jupdate = jax.jit(jopt.update)
    for i in range(7):
        scale = 3.0 if i % 2 else 0.05  # clipping triggers on odd steps only
        g = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * scale).astype(p.dtype),
                         jparams)
        upd, jstate = jupdate(g, jstate, jparams)
        jparams = _np(optax.apply_updates(jparams, upd))
        tstate = opt.update(params_from_numpy(g, device="cpu"), tstate, tparams)
        _pair(jparams, tparams, lambda t, j, path: _close(t, j, OPT_TOL, f"step {i}{path}"))
        _pair(_np(jstate), tstate, _state_check(STATE_TOL), f"state {i}")


def test_schedules_match_optax_at_every_count():
    cases = [
        (optax.warmup_cosine_decay_schedule(0.0, 3e-4, 10, 100),
         optim.warmup_cosine_decay_schedule(0.0, 3e-4, 10, 100)),
        (optax.warmup_cosine_decay_schedule(0.0, 1e-3, 0, 7),
         optim.warmup_cosine_decay_schedule(0.0, 1e-3, 0, 7)),
        (optax.linear_schedule(0.0, 3e-4, 5), optim.linear_schedule(0.0, 3e-4, 5)),
    ]
    for jsched, sched in cases:
        for c in range(0, 110):
            want = float(jsched(jnp.asarray(c, jnp.int32)))
            assert abs(sched(c) - want) <= 1e-6 * max(abs(want), 1e-12), (c, sched(c), want)
    assert optim.warmup_cosine_decay_schedule(0.0, 3e-4, 10, 100)(0) == 0.0
    with pytest.raises(ValueError, match="warmup_steps"):
        trainer.make_optimizer(warmup_steps=100, total_steps=50)


def test_bf16_moments_stay_bf16():
    rng = np.random.default_rng(6)
    jparams = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), _small_tree(rng, np.float32))
    jopt = jtrainer.make_optimizer(grad_clip=1.0)
    opt = trainer.make_optimizer(grad_clip=1.0)
    tparams = params_from_numpy(_np(jparams), device="cpu", dtype="bfloat16")
    jstate, tstate = jopt.init(jparams), opt.init(tparams)
    jupdate = jax.jit(jopt.update)
    for _ in range(2):
        g = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape), p.dtype), jparams)
        upd, jstate = jupdate(g, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        tstate = opt.update(params_from_numpy(_np(g), device="cpu", dtype="bfloat16"), tstate,
                            tparams)
    # bf16 rounding differs between XLA and torch: dtypes exact, values to
    # a few bf16 ulps of their scale.
    _pair(_np(jstate), tstate, _state_check(2 ** -6), "bf16 state")
    assert tstate[1][0].mu["tok_emb"].dtype == torch.bfloat16
    assert tstate[1][0].nu["blocks"]["wq"].dtype == torch.bfloat16


# ---- train steps against JAX ----------------------------------------------


def _jax_run(jspec, opt, n_steps: int, seed: int = 0):
    mesh = make_mesh(MeshConfig(), jax.devices()[:1])
    state = jtrainer.train_init(jspec, mesh, seed=seed, optimizer=opt)
    step = jtrainer.make_train_step(jspec, mesh, optimizer=opt)
    states, losses = [_np(state)], []
    for i in range(n_steps):
        state, loss = step(state, _tokens(10 + i, jspec.vocab_size, batch=2, seqlen=16))
        states.append(_np(state))
        losses.append(float(loss))
    return states, losses


def test_three_train_steps_match_jax():
    jspec = jax_resolve_spec("llama-tiny", OPTS)
    spec = resolve_spec("llama-tiny", OPTS)
    states, losses = _jax_run(jspec, jtrainer.make_optimizer(), 3)
    state = train_state_from_numpy(*states[0], device="cpu")
    step = trainer.make_train_step(spec, device="cpu")
    for i in range(3):
        state, loss = step(state, _tokens(10 + i, spec.vocab_size, batch=2, seqlen=16))
        assert abs(float(loss) - losses[i]) <= STEP_TOL * abs(losses[i]), i
        assert int(state.step) == i + 1
        _pair(states[i + 1].params, state.params,
              lambda t, j, path: _close(t, j, STEP_TOL, f"step {i} params{path}"))


def test_jax_state_resumes_in_the_port():
    """Mid-window (accumulation), with clipping and a warmup-cosine
    schedule: the carried state's next step equals JAX's."""
    kw = {"accum_steps": 2, "grad_clip": 1.0, "warmup_steps": 1, "total_steps": 8}
    jspec = jax_resolve_spec("llama-tiny", OPTS)
    spec = resolve_spec("llama-tiny", OPTS)
    states, losses = _jax_run(jspec, jtrainer.make_optimizer(**kw), 4)
    state = train_state_from_numpy(*states[3], device="cpu")
    assert state.opt_state[1].acc_grads["tok_emb"].dtype == torch.float32
    _pair(states[3].opt_state, state.opt_state, _state_check(0.0), "carried")
    step = trainer.make_train_step(spec, device="cpu", optimizer=trainer.make_optimizer(**kw))
    state, loss = step(state, _tokens(13, spec.vocab_size, batch=2, seqlen=16))
    assert abs(float(loss) - losses[3]) <= STEP_TOL * abs(losses[3])
    _pair(states[4].params, state.params,
          lambda t, j, path: _close(t, j, STEP_TOL, f"resumed params{path}"))
    _pair(states[4].opt_state, state.opt_state, _state_check(STEP_TOL), "resumed state")


def test_grads_hook_sees_the_step_gradients_before_the_update():
    """``make_train_step(grads_hook=)`` runs between the backward and the
    update, with the state still at its params and the gradients
    ``value_and_grad`` gives; the step's result is unchanged by it."""
    spec = resolve_spec("llama-tiny", OPTS)
    tokens = torch.as_tensor(_tokens(4, spec.vocab_size, batch=2, seqlen=16))
    seen = []

    def hook(state, loss, grads):
        want_loss, want = trainer.value_and_grad(state.params, spec, tokens)
        assert torch.equal(loss, want_loss)
        assert all(torch.equal(a, b) for a, b in zip(optim.tree_leaves(grads),
                                                       optim.tree_leaves(want)))
        seen.append(int(state.step))

    hooked = trainer.make_train_step(spec, device="cpu", grads_hook=hook)
    plain = trainer.make_train_step(spec, device="cpu")
    a = trainer.train_init(spec, device="cpu", seed=0)
    b = trainer.train_init(spec, device="cpu", seed=0)
    for _ in range(2):
        a, la = hooked(a, tokens)
        b, lb = plain(b, tokens)
        assert torch.equal(la, lb)
    assert seen == [0, 1]
    assert all(torch.equal(x, y) for x, y in zip(optim.tree_leaves(a.params),
                                                 optim.tree_leaves(b.params)))


# ---- the kernel wrappers refuse autograd ----------------------------------


def _attn_inputs(grad: bool):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 4, 8, 64, generator=g, requires_grad=grad)
    k = torch.randn(1, 2, 8, 64, generator=g, requires_grad=grad)
    v = torch.randn(1, 2, 8, 64, generator=g, requires_grad=grad)
    return q, k, v


def test_kernel_wrappers_refuse_autograd():
    lens = torch.tensor([8], dtype=torch.int32)
    q, k, v = _attn_inputs(grad=True)
    with pytest.raises(RuntimeError, match="flash_prefill_attention has no backward"):
        flash_prefill_attention(q, k, v, lens)
    with pytest.raises(RuntimeError, match="flash_decode_attention has no backward"):
        flash_decode_attention(q[:, :, :1], k, v, lens)
    k8 = torch.zeros(1, 2, 8, 64, dtype=torch.int8)
    ks = torch.ones(1, 2, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="flash_decode_q8_attention has no backward"):
        flash_decode_q8_attention(q[:, :, :1], k8, ks, k8, ks, lens)
    with torch.no_grad():  # the serving paths run here
        out = flash_prefill_attention(q, k, v, lens)
        flash_decode_attention(q[:, :, :1], k, v, lens)
        flash_decode_q8_attention(q[:, :, :1], k8, ks, k8, ks, lens)
    assert out.grad_fn is None
    q0, k0, v0 = _attn_inputs(grad=False)
    flash_prefill_attention(q0, k0, v0, lens)  # grad mode, nothing requires grad


def test_forward_logits_kernel_path_refuses_grad():
    spec = resolve_spec("llama-tiny", OPTS)
    params = params_from_numpy(_np(jax_init_params(jax_resolve_spec("llama-tiny", OPTS),
                                                   seed=1)), device="cpu")
    grads = optim.tree_map(torch.zeros_like, params)
    leaves = trainer._grad_leaves(params, grads)
    tokens = torch.as_tensor(_tokens(3, spec.vocab_size))
    with pytest.raises(RuntimeError, match="plain_attention=True"):
        ttf.forward_logits(leaves, spec, tokens)
    out = ttf.forward_logits(leaves, spec, tokens, plain_attention=True, remat=True)
    assert out.requires_grad
