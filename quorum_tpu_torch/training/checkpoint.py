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
- Meshes: a checkpoint always holds whole leaves, so one written from any
  mesh restores onto any other or onto one device. Saving a rank's cut of a
  state (``mesh=``, ``spec=``; every rank of the mesh calls it) gathers each
  cut leaf whole in dp group 0 — over tp, or on a pp mesh each layer leaf
  over the stages, in stage order, so every layer sits at its global index
  — and rank 0 (stage 0, which holds the embedding, the final norm and the
  head) writes; restoring onto a mesh (``mesh=``) fills each leaf on the
  rank's device and keeps only the rank's cut (``parallel/sharding.
  rank_cut``, by leaf name): a pipeline stage reads only its own layers'
  rows of each layer leaf, and no row of a leaf it does not hold.
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


@torch.no_grad()
def tree_digest(tree: Any) -> dict[str, int]:
    """Tensor name → an exact fingerprint of its bytes: the sum of its
    16-bit words weighted by their position (mod 65 521, plus 1), in int64
    on the tensor's device, piece by piece. Equal trees give equal digests;
    a changed, missing or moved element changes its leaf's (a restore held
    against the state it came from without moving either to the host)."""
    out = {}
    for name, t in _named(tree):
        words = t.detach().contiguous().view(-1).view(torch.int16)
        total = 0
        for i in range(0, words.numel(), 1 << 24):
            w = words[i:i + (1 << 24)].long()
            pos = torch.arange(i, i + w.numel(), device=w.device) % 65521 + 1
            total += int((w * pos).sum())
        out[name] = total
    return out


def _item_file(path: Path, item: str) -> Path:
    return path / item / f"{item}.safetensors"


def _whole_shapes(spec: ModelSpec) -> dict[str, tuple]:
    """Leaf name → the whole leaf's shape (leaf names are unique in a
    params tree, top level and blocks)."""
    out: dict[str, tuple] = {}
    for name, t in _named(init_params(spec, device="meta")):
        out[name.split(".")[-1]] = tuple(t.shape)
    return out


def _gathered(state: TrainState, mesh, spec: ModelSpec) -> TrainState:
    """``state`` (a tp rank's cut, or a pipeline stage's) with every cut
    leaf all-gathered whole over tp (over pp on a pp mesh, whose tp is 1),
    along the dimension its cut took (kv heads that several ranks hold
    taken once, from the first of them)."""
    from quorum_tpu_torch.parallel.sharding import kv_sharers

    whole = _whole_shapes(spec)
    group = mesh.pp if mesh.pp_size > 1 else mesh.tp
    firsts = sorted({kv_sharers(spec.n_heads, spec.n_kv_heads, mesh.tp_size, r)[0]
                     for r in range(mesh.tp_size)})

    def walk(tree: Any, prefix: str = "") -> Any:
        if tree is None:
            return None
        if isinstance(tree, torch.Tensor):
            want = whole.get(prefix.split(".")[-1])
            if want is None or tree.dim() == 0 or tuple(tree.shape) == want:
                return tree
            dim = next(d for d, (a, b) in enumerate(zip(tree.shape, want)) if a != b)
            out = group.all_gather(tree.contiguous(), dim=dim)
            if out.shape[dim] > want[dim]:  # kv heads several ranks share: each once
                parts = out.chunk(mesh.tp_size, dim=dim)
                out = torch.cat([parts[r] for r in firsts], dim=dim)
            return out

        def sub(key, t):
            return walk(t, f"{prefix}.{key}" if prefix else str(key))

        if isinstance(tree, dict):
            return {k: sub(k, v) for k, v in tree.items()}
        if hasattr(tree, "_fields"):
            return type(tree)(*(sub(f, v) for f, v in zip(tree._fields, tree)))
        return tuple(sub(i, v) for i, v in enumerate(tree))

    return TrainState(walk(state.params), walk(state.opt_state), state.step)


def save_checkpoint(path: str, state: TrainState, *, mesh=None,
                    spec: ModelSpec | None = None) -> int:
    """Write the full TrainState to ``path`` (a directory; an older
    checkpoint there is replaced). Returns the bytes written. With ``mesh``
    (a ``RankMesh``; ``state`` the rank's cut, ``spec`` its model) every
    rank calls this: dp group 0 gathers the cut leaves whole over tp and
    rank 0 writes them (other ranks return 0)."""
    if mesh is not None:
        if spec is None:
            raise ValueError("saving a mesh's state needs its spec (the whole leaves' shapes)")
        if mesh.dp_rank != 0:
            return 0
        state = _gathered(state, mesh, spec)
        if mesh.rank != 0:
            return 0
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
                  stage: HostStage, exact_dtype: bool, cut=None) -> Any:
    """The ``item`` tree of the checkpoint at ``path``, shaped like
    ``target`` (meta tensors; 0-d leaves restored on the host); ``cut(name,
    x)`` keeps a rank's cut of each filled leaf (by its leaf name)."""
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
            leaf = name.split(".")[-1]
            layers = None
            if cut is not None and t.dim():
                if not cut.keeps(leaf):  # a later stage: no embedding, norm or head
                    sf.release(name)
                    filled[name] = None
                    continue
                layers = cut.stage_rows(leaf, src.shape[0])
            if layers is not None:  # read only this stage's layers
                src = src.narrow(0, layers[0], layers[1] - layers[0])
            out = torch.empty(src.shape, dtype=src.dtype,
                              device=device if t.dim() else torch.device("cpu"))
            stage.fill(out, src)
            sf.release(name)
            if cut is not None and out.dim():
                out = cut(leaf, out, layers_cut=layers is not None).contiguous()
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


def _rank_cut(spec: ModelSpec, mesh):
    if mesh is None:
        return None
    from quorum_tpu_torch.parallel.sharding import rank_cut

    return rank_cut(spec, mesh, mesh.rank)


def restore_checkpoint(path: str, spec: ModelSpec, *, device="cuda",
                       optimizer: Optimizer | None = None, mesh=None) -> TrainState:
    """The full TrainState saved at ``path``, on ``device``; ``optimizer``
    (the recipe the state was trained with; the default recipe when None)
    gives the optimizer state's tree. With ``mesh`` (a ``RankMesh``) the
    state is the rank's cut of it, on the rank's device."""
    opt = optimizer or make_optimizer()
    dev = resolve_device(device) if mesh is None else mesh.device
    cut = _rank_cut(spec, mesh)
    path = Path(os.path.abspath(path))
    meta = init_params(spec, device="meta")
    stage = HostStage()
    params = _restore_item(path, "params", meta, dev, stage, exact_dtype=True, cut=cut)
    opt_state = _restore_item(path, "opt_state", opt.init(meta), dev, stage, exact_dtype=False,
                              cut=cut)
    step = _restore_item(path, "step", {"step": torch.zeros((), dtype=torch.int32)}, dev, stage,
                         exact_dtype=True)["step"]
    return TrainState(params, opt_state, step)


def restore_params(path: str, spec: ModelSpec, *, device="cuda", mesh=None) -> dict:
    """Only the params item of a training checkpoint, on ``device`` (for
    serving: ``InferenceEngine(spec, device=..., params=restore_params(...))``,
    or with a mesh engine's whole tree, which it cuts for each rank); the
    optimizer's item is never opened. With ``mesh`` (a ``RankMesh``) the
    rank's cut, on its device."""
    dev = resolve_device(device) if mesh is None else mesh.device
    return _restore_item(Path(os.path.abspath(path)), "params", init_params(spec, device="meta"),
                         dev, HostStage(), exact_dtype=True, cut=_rank_cut(spec, mesh))
