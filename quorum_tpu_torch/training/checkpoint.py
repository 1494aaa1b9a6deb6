"""Training checkpoint save/resume and serve-from-checkpoint: the port of the
JAX package's ``training/checkpoint.py``, in a format of the port's own
(orbax is not on the card's machine).

A checkpoint is a directory of three items, as orbax's composite writes
them: ``params/``, ``opt_state/`` and ``step/``, each one
``<item>.safetensors`` file (``models/hf_loader.write_safetensors``; read
back with its ``SafetensorsFile``). A tensor's name is its path in the tree:
dict keys, NamedTuple field names and tuple indices joined by dots
(``blocks.wq``, ``0.mu.tok_emb``, ``1.inner_opt_state.0.count``); absent
(None) leaves are not written.

- Save writes into a temporary directory beside ``path`` and renames it into
  place, replacing an older checkpoint there (orbax's ``force=True``); a
  failed save leaves the older one as it was.
- Restore builds the target tree with no memory (``init_params(spec,
  device="meta")``, the optimizer's ``init`` over it: orbax's abstract
  target), checks every tensor's name and shape against it, allocates each
  leaf on the device and fills it through one page-locked buffer, leaf by
  leaf: the host holds one 64 MB piece at a time, never the tree. The
  params keep the spec's dtype; the optimizer's leaves keep the dtype they
  were saved in (accumulation promotes bf16 moments to f32, as optax does);
  the counts and the step stay 0-d int32 tensors on the host.
- ``restore_params`` reads the params item alone and never opens
  ``opt_state/``: serving a checkpoint needs the weights' memory only. Its
  tree feeds ``InferenceEngine(spec, device=..., params=...)``.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from pathlib import Path
from typing import Any

import torch

from quorum_tpu_torch import resolve_device
from quorum_tpu_torch.models.hf_loader import HostStage, SafetensorsFile, write_safetensors
from quorum_tpu_torch.models.init import init_params
from quorum_tpu_torch.models.model_config import ModelSpec
from quorum_tpu_torch.training.optim import Optimizer
from quorum_tpu_torch.training.trainer import TrainState, make_optimizer

ITEMS = ("params", "opt_state", "step")


def _named(tree: Any, prefix: str = ""):
    """``(name, tensor)`` for every tensor of a state tree, in its order."""
    if tree is None:
        return
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
        return
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, tuple):
        items = enumerate(tree)
    else:
        raise TypeError(f"{prefix or 'tree'}: cannot save a {type(tree).__name__}")
    for key, sub in items:
        yield from _named(sub, f"{prefix}.{key}" if prefix else str(key))


def _item_file(path: Path, item: str) -> Path:
    return path / item / f"{item}.safetensors"


def save_checkpoint(path: str, state: TrainState) -> int:
    """Write the full TrainState to ``path`` (a directory; an older
    checkpoint there is replaced). Returns the bytes written."""
    path = Path(os.path.abspath(path))
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix=f".{path.name}-", dir=path.parent))
    stage = HostStage()
    written = 0
    try:
        for item, tree in zip(ITEMS, (state.params, state.opt_state, {"step": state.step})):
            (tmp / item).mkdir()
            written += write_safetensors(_item_file(tmp, item), dict(_named(tree)), stage=stage)
        old = None
        if path.exists():
            old = Path(tempfile.mkdtemp(prefix=f".{path.name}-old-", dir=path.parent))
            os.replace(path, old / path.name)
        os.replace(tmp, path)
        if old is not None:
            shutil.rmtree(old)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return written


def _restore_item(path: Path, item: str, target: Any, device: torch.device,
                  stage: HostStage, exact_dtype: bool) -> Any:
    """The ``item`` tree of the checkpoint at ``path``, shaped like
    ``target`` (meta tensors; 0-d leaves restored on the host)."""
    sf = SafetensorsFile(_item_file(path, item))
    try:
        want = dict(_named(target))
        if set(sf.keys()) != set(want):
            missing, extra = sorted(set(want) - set(sf.keys())), sorted(set(sf.keys()) - set(want))
            raise ValueError(f"{sf.path}: tensors do not match the target tree "
                             f"(missing {missing[:4]}, unexpected {extra[:4]})")
        filled: dict[str, torch.Tensor] = {}
        for name, t in want.items():
            src = sf.get(name)
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"{sf.path}: {name} has shape {tuple(src.shape)}, the target "
                                 f"{tuple(t.shape)}")
            if src.dtype != t.dtype and (exact_dtype or src.dtype != torch.float32):
                raise ValueError(f"{sf.path}: {name} is {src.dtype}, the target {t.dtype}")
            out = torch.empty(src.shape, dtype=src.dtype,
                              device=device if t.dim() else torch.device("cpu"))
            stage.fill(out, src)
            sf.release(name)
            filled[name] = out
    finally:
        sf.close()
    return _rebuild(target, filled)


def _rebuild(target: Any, filled: dict, prefix: str = "") -> Any:
    if target is None:
        return None
    if isinstance(target, torch.Tensor):
        return filled[prefix]

    def sub(key, t):
        return _rebuild(t, filled, f"{prefix}.{key}" if prefix else str(key))

    if isinstance(target, dict):
        return {k: sub(k, v) for k, v in target.items()}
    if hasattr(target, "_fields"):
        return type(target)(*(sub(f, v) for f, v in zip(target._fields, target)))
    return tuple(sub(i, v) for i, v in enumerate(target))


def restore_checkpoint(path: str, spec: ModelSpec, *, device="cuda",
                       optimizer: Optimizer | None = None) -> TrainState:
    """The full TrainState saved at ``path``, on ``device``; ``optimizer``
    (the recipe the state was trained with; the default recipe when None)
    gives the optimizer state's tree."""
    opt = optimizer or make_optimizer()
    dev = resolve_device(device)
    path = Path(os.path.abspath(path))
    meta = init_params(spec, device="meta")
    stage = HostStage()
    params = _restore_item(path, "params", meta, dev, stage, exact_dtype=True)
    opt_state = _restore_item(path, "opt_state", opt.init(meta), dev, stage, exact_dtype=False)
    step = _restore_item(path, "step", {"step": torch.zeros((), dtype=torch.int32)}, dev, stage,
                         exact_dtype=True)["step"]
    return TrainState(params, opt_state, step)


def restore_params(path: str, spec: ModelSpec, *, device="cuda") -> dict:
    """Only the params item of a training checkpoint, on ``device`` (for
    serving: ``InferenceEngine(spec, device=..., params=restore_params(...))``);
    the optimizer's item is never opened."""
    return _restore_item(Path(os.path.abspath(path)), "params", init_params(spec, device="meta"),
                         resolve_device(device), HostStage(), exact_dtype=True)
