"""quorum_tpu_torch: the PyTorch + CUDA port of ``quorum_tpu``, for NVIDIA Hopper.

The JAX package (``quorum_tpu``) stays the reference; this package serves the
same OpenAI-compatible chat surface from an in-process model on a CUDA
device. The path is ``cuda://`` backend → continuous-batching engine →
transformer (dense and MoE layers; random weights from a seed or a local
HF checkpoint) → two hand-written sm_90a attention kernels
(``ops/flash_attention.py`` for prefill, ``ops/flash_decode.py`` for
decode), built from ``csrc/`` with nvcc at first use.

Entry points run on ``device="cuda"`` unless the caller asks for
``device="cpu"`` explicitly (the tests do); with no GPU they raise instead of
carrying on on the CPU. This package never imports ``jax`` or anything of
``quorum_tpu``.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless told otherwise.

    Raises when CUDA is asked for (explicitly or by default) and absent —
    a serving path never silently degrades to the CPU's plain versions."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' explicitly to run "
                "the plain PyTorch versions on the CPU")
        if dev.index is None:  # pin the card, so worker threads can select it
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
