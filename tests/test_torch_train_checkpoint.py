"""Training checkpoints of the port (``quorum_tpu_torch/training/
checkpoint.py``) on the CPU, and serving from one against the JAX package.

- a bf16 TrainState mid-accumulation-window (f32 accumulator, f32-promoted
  moments, a schedule count) saved and restored: every leaf bit for bit
  with its dtype, and two more steps from the restored state equal to two
  steps of the original bit for bit (losses and params);
- saving over an older checkpoint replaces it;
- ``restore_params`` with ``opt_state/`` deleted: the params bit for bit;
- a restore against another recipe's tree is refused;
- serve from a checkpoint: the same two float32 steps in both packages from
  JAX's ``train_init`` (carried across with ``train_state_from_numpy``),
  each saved and its params restored by its own package; the restored
  params within 1e-5 of their scale (plus 5 % of the steps' learning
  rate), and greedy tokens of an engine on
  them equal to the JAX engine's on JAX's restored params.
"""

import shutil

import jax
import numpy as np
import pytest
import torch

from quorum_tpu.engine.engine import InferenceEngine as JaxEngine
from quorum_tpu.models.model_config import resolve_spec as jax_resolve_spec
from quorum_tpu.ops.sampling import SamplerConfig as JaxSamplerConfig
from quorum_tpu.parallel import MeshConfig, make_mesh
from quorum_tpu.training import checkpoint as jckpt
from quorum_tpu.training import trainer as jtrainer
from quorum_tpu_torch.engine.engine import InferenceEngine
from quorum_tpu_torch.models.convert import train_state_from_numpy
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.ops.sampling import SamplerConfig
from quorum_tpu_torch.training import checkpoint, trainer

# The two packages' params after two steps: within 1e-5 of a leaf's scale,
# plus a share of the steps' learning rate — Adam's m / (sqrt(v) + eps) on an
# element whose gradient is near eps (1e-8) is decided by rounding.
PARAM_TOL = 1e-5
ADAM_SLACK = 0.05
LR = 3e-4  # the default recipe's
PROMPT = [5, 6, 7, 8]
N_TOKENS = 8


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tokens(seed: int, vocab: int, batch: int = 2, seqlen: int = 16) -> np.ndarray:
    rng = np.random.RandomState(seed)
    tok = rng.randint(1, vocab, size=(batch, seqlen)).astype(np.int32)
    tok[1, -5:] = 0
    return tok


def _flat(state) -> list[tuple[str, torch.Tensor]]:
    return list(checkpoint._named(state))


def _assert_bitwise(a, b) -> None:
    fa, fb = _flat(a), _flat(b)
    assert [n for n, _ in fa] == [n for n, _ in fb]
    for (name, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert torch.equal(x, y), name


RECIPE = {"accum_steps": 2, "grad_clip": 1.0, "warmup_steps": 1, "total_steps": 10}


def _bf16_run(n_steps: int):
    spec = resolve_spec("llama-tiny", {"max_seq": "64"})  # bf16, the preset's dtype
    opt = trainer.make_optimizer(**RECIPE)
    state = trainer.train_init(spec, device="cpu", seed=1, optimizer=opt)
    step = trainer.make_train_step(spec, device="cpu", optimizer=opt)
    for i in range(n_steps):
        state, _ = step(state, _tokens(i, spec.vocab_size))
    return spec, opt, state, step


def test_round_trip_and_resume_bit_for_bit(tmp_path):
    spec, opt, state, step = _bf16_run(3)  # mid-window: the accumulator holds a micro-batch
    assert state.params["tok_emb"].dtype == torch.bfloat16
    inner = state.opt_state[1].inner_opt_state[1][0]
    assert state.opt_state[1].acc_grads["tok_emb"].dtype == torch.float32
    assert inner.mu["tok_emb"].dtype == torch.float32  # promoted, as optax promotes
    path = tmp_path / "ckpt"
    nbytes = checkpoint.save_checkpoint(str(path), state)
    assert nbytes == sum((path / i / f"{i}.safetensors").stat().st_size for i in checkpoint.ITEMS)
    restored = checkpoint.restore_checkpoint(str(path), spec, device="cpu", optimizer=opt)
    assert int(restored.step) == 3
    _assert_bitwise(restored, state)

    # the checkpoint owns its bytes: stepping the original leaves it alone
    ref, ref_losses = state, []
    for i in range(3, 5):
        ref, loss = step(ref, _tokens(i, spec.vocab_size))
        ref_losses.append(loss)
    res, res_losses = restored, []
    for i in range(3, 5):
        res, loss = step(res, _tokens(i, spec.vocab_size))
        res_losses.append(loss)
    assert all(torch.equal(a, b) for a, b in zip(ref_losses, res_losses))
    _assert_bitwise(res, ref)

    # save over the older checkpoint: it is replaced, nothing else is left
    checkpoint.save_checkpoint(str(path), ref)
    again = checkpoint.restore_checkpoint(str(path), spec, device="cpu", optimizer=opt)
    assert int(again.step) == 5
    _assert_bitwise(again, ref)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ckpt"]

    # restore_params never opens opt_state/
    shutil.rmtree(path / "opt_state")
    params = checkpoint.restore_params(str(path), spec, device="cpu")
    _assert_bitwise(params, ref.params)
    with pytest.raises(FileNotFoundError):
        checkpoint.restore_checkpoint(str(path), spec, device="cpu", optimizer=opt)


def test_restore_refuses_another_recipe(tmp_path):
    spec = resolve_spec("llama-tiny", {"max_seq": "64", "dtype": "float32"})
    state = trainer.train_init(spec, device="cpu", seed=0)
    checkpoint.save_checkpoint(str(tmp_path / "c"), state)
    with pytest.raises(ValueError, match="do not match"):
        checkpoint.restore_checkpoint(str(tmp_path / "c"), spec, device="cpu",
                                      optimizer=trainer.make_optimizer(accum_steps=2))
    other = resolve_spec("llama-tiny", {"max_seq": "64", "dtype": "float32", "d_ff": "64"})
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore_params(str(tmp_path / "c"), other, device="cpu")


def test_serve_from_checkpoint_matches_jax(tmp_path):
    opts = {"dtype": "float32", "max_seq": "64"}
    jspec = jax_resolve_spec("llama-tiny", opts)
    spec = resolve_spec("llama-tiny", opts)
    mesh = make_mesh(MeshConfig(), jax.devices()[:1])
    jstate = jtrainer.train_init(jspec, mesh, seed=2)
    state = train_state_from_numpy(*jax.tree.map(np.asarray, jstate), device="cpu")
    jstep = jtrainer.make_train_step(jspec, mesh)
    step = trainer.make_train_step(spec, device="cpu")
    for i in range(2):
        jstate, _ = jstep(jstate, _tokens(20 + i, spec.vocab_size))
        state, _ = step(state, _tokens(20 + i, spec.vocab_size))
    jckpt.save_checkpoint(str(tmp_path / "jax"), jstate)
    checkpoint.save_checkpoint(str(tmp_path / "port"), state)
    jparams = jax.tree.map(np.asarray, jckpt.restore_params(str(tmp_path / "jax"), jspec, mesh))
    params = checkpoint.restore_params(str(tmp_path / "port"), spec, device="cpu")
    want_params = dict(checkpoint._named(jax.tree.map(lambda x: torch.tensor(np.array(x)),
                                                      jparams)))
    got_params = dict(checkpoint._named(params))
    assert set(got_params) == set(want_params)
    for name, t in got_params.items():
        j = want_params[name]
        tol = PARAM_TOL * float(j.abs().max()) + ADAM_SLACK * LR * 2
        assert float((t - j).abs().max()) <= tol, name

    jeng = JaxEngine(jspec, mesh, params=jparams, n_slots=1, decode_chunk=4)
    eng = InferenceEngine(spec, device="cpu", params=params, n_slots=1, decode_chunk=4)
    try:
        want = jeng.generate(PROMPT, max_new_tokens=N_TOKENS,
                             sampler=JaxSamplerConfig(temperature=0.0)).token_ids
        got = eng.generate(PROMPT, max_new_tokens=N_TOKENS,
                           sampler=SamplerConfig(temperature=0.0)).token_ids
    finally:
        jeng.shutdown()
        eng.shutdown()
    assert len(got) == N_TOKENS
    assert got == want
