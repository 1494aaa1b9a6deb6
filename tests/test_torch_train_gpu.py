"""Training on the card: every test here is marked ``gpu`` and skips without
a card. They run the legs of ``chip_smoke.py``'s ``train`` phase, smaller:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_train_gpu.py

- leg (b): llama-tiny in float32, three steps on the card against the CPU
  (losses within 1e-5 relative, params within 1e-5 of their scale plus 5 %
  of the steps' learning rate);
- leg (a) at 2 layers of llama-3-8b widths (bf16, 1 × 512 tokens): the
  loss finite and falling, every leaf's step-1 gradient finite and nonzero,
  the kernel path refusing grad, and no kernel launched by training;
- leg (c) at 2 layers (1 × 512 tokens): resume bit for bit, accumulation
  against one step over both micro-batches (the updates' L2 difference
  within ``chip_smoke.TRAIN_ACCUM_REL`` of the step's, the two planted
  faults above it), ``restore_params`` memory, serving from the restored
  params with exact K1 and K2 launches, the engine's log-probabilities
  within the bf16 model tolerance of the plain forward's.
"""

import math
import tempfile

import pytest
import torch

import chip_smoke
from quorum_tpu_torch.models.model_config import resolve_spec

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    """The card (decided here, never at import: the CPU suite collects this file)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


def test_card_steps_match_cpu(cuda_device):
    out = chip_smoke._train_parity(torch, False, cuda_device)
    assert out["loss_max_rel_err"] <= chip_smoke.TRAIN_PARITY_REL


def test_full_leg_at_two_layers(cuda_device):
    before = chip_smoke._launch_counts()
    out = chip_smoke._train_full(torch, False, resolve_spec("llama-3-8b", {"n_layers": "2"}),
                                 cuda_device, 512)
    assert chip_smoke._launch_counts() == before  # training launches no kernel
    assert all(math.isfinite(x) for x in out["losses"])
    assert out["losses"][0] > out["losses"][1] > out["losses"][2]
    assert out["grads"]["slices_checked"] == 3 + 2 * 9
    assert out["kernel_path_refused"]


def test_checkpoint_leg_at_two_layers(cuda_device):
    with tempfile.TemporaryDirectory() as root:
        out = chip_smoke._train_checkpoint(torch, False,
                                           resolve_spec("llama-3-8b", {"n_layers": "2"}),
                                           cuda_device, 512, root)
    assert out["resume_bit_for_bit"]
    assert out["serve_launches"]["flash_prefill"] > 0
    assert out["serve_launches"]["flash_decode"] > 0
    assert out["restore_params_grown_bytes"] >= out["params_bytes"]
    assert out["accum_rel_diff"] <= chip_smoke.TRAIN_ACCUM_REL
    assert min(out["accum_planted_faults_rel"].values()) > chip_smoke.TRAIN_ACCUM_REL
    assert out["serve_logprob_max_diff"] <= chip_smoke.MODEL_TOL["bfloat16"]
