"""Convert a parameter tree of numpy arrays (the JAX package's pytree, read
back with ``numpy.asarray`` leaf by leaf) into the port's params.

The tree keeps its layout: the same leaf names (an MoE tree's ``router``
and ``moe_w_*`` leaves too), ``None`` for absent leaves, per-layer weights
stacked ``[L, …]`` under ``"blocks"``. A quantized ``{"q8", "qs"}`` leaf
(the JAX package's ``quantize_params``) stays int8 and float32 whatever
``dtype`` says, in the port's layout (``models/quant.py``: contraction axis
last, the same permutation on ``q8`` and ``qs``), so a JAX
``quantize_params(init_params(spec))`` tree computes the same thing in the
port; a quantized leaf where the JAX package quantizes none is refused.
Member-stacked trees (``members=M`` / ``ensemble=M`` engines) go through
:func:`stacked_params_from_numpy`; a JAX TrainState (params, optax state,
step) through :func:`train_state_from_numpy`.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from quorum_tpu_torch import resolve_device
from quorum_tpu_torch.models.quant import (QUANT_REDUCE_AXIS, cut_quantized, jax_layout,
                                           port_layout, quantize_cut)


def _leaf(x, device, dtype, name: str = ""):
    if isinstance(x, Mapping):
        if "q8" not in x:
            raise ValueError(f"unexpected nested mapping leaf with keys {sorted(x)}")
        if name not in QUANT_REDUCE_AXIS:
            raise ValueError(f"a quantized int8 {{q8, qs}} leaf at {name!r}: the JAX "
                             f"package quantizes only {sorted(QUANT_REDUCE_AXIS)}")
        leaf = {"q8": _leaf(x["q8"], device, torch.int8),
                "qs": _leaf(x["qs"], device, torch.float32)}
        return port_layout(leaf, QUANT_REDUCE_AXIS[name])
    arr = np.asarray(x)
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)  # ml_dtypes bfloat16 → a dtype torch reads
    t = torch.from_numpy(np.array(arr, order="C"))  # a writable copy torch may own
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_numpy(tree: Mapping, device=None, dtype=None) -> dict:
    """Numpy tree → torch tensors on ``device`` (``None`` means cuda), cast to
    ``dtype`` when given (else each leaf keeps its own float dtype)."""
    dev = resolve_device(device)
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    out = {}
    for name, x in tree.items():
        if name == "blocks":
            out[name] = {k: (None if b is None else _leaf(b, dev, dt, k)) for k, b in x.items()}
        else:
            out[name] = None if x is None else _leaf(x, dev, dt, name)
    return out


def stacked_params_from_numpy(tree: Mapping, device=None, dtype=None) -> dict:
    """The JAX engine's member-stacked tree (every leaf ``[M, …]``, block
    leaves ``[M, L, …]``) → the port's stacked layout: top-level leaves
    ``[M, …]``, block leaves ``[L, M, …]`` (permuted once, contiguous)."""
    out = params_from_numpy(tree, device=device, dtype=dtype)
    out["blocks"] = {k: _map(b, lambda t: t.transpose(0, 1).contiguous())
                     for k, b in out["blocks"].items()}
    return out


def _map(leaf, fn):
    """``fn`` on a leaf's tensor, or on each tensor of a quantized leaf."""
    if leaf is None:
        return None
    if isinstance(leaf, Mapping):
        return {k: fn(t) for k, t in leaf.items()}
    return fn(leaf)


def stack_params(trees: list[dict]) -> dict:
    """M port trees → one stacked tree in the port's layout (top-level
    leaves stacked on a new axis 0, block leaves on axis 1)."""
    def stack(leaves, axis):
        if leaves[0] is None:
            return None
        if isinstance(leaves[0], Mapping):
            return {k: torch.stack([x[k] for x in leaves], axis) for k in leaves[0]}
        return torch.stack(leaves, axis)

    first = trees[0]
    out = {name: stack([t[name] for t in trees], 0) for name in first if name != "blocks"}
    out["blocks"] = {k: stack([t["blocks"][k] for t in trees], 1) for k in first["blocks"]}
    return out


def shard_params(params: Mapping, mesh, rank: int, spec, quant: str | None = None) -> dict:
    """Rank ``rank``'s shard of a full tree (``params_from_numpy`` of the
    JAX package's parameters, ``init_params`` or ``init_params_stacked``)
    on ``mesh`` (a ``parallel/mesh.Mesh`` or ``RankMesh``): each leaf cut
    by ``parallel/sharding``'s rules for ``spec`` (heads, experts, MLP
    hidden and vocab over tp; each rank's kv heads those its query heads
    read; layers over pp, a later stage holding no embedding, final norm or
    head; replicated over dp, so a dp rank receives its cut and nothing
    less), as contiguous tensors on the leaves' device. A member-stacked
    tree is cut member by member (the member axis is never cut). A
    quantized leaf is cut with its scales (``models/quant.cut_quantized``);
    with ``quant="int8"`` a plain leaf the JAX package quantizes is
    quantized whole, then cut: each channel's scale is its amax over the
    whole contraction axis, as ``quantize_params`` of the whole tree gives
    it."""
    from quorum_tpu_torch.parallel.sharding import rank_cut

    cut = rank_cut(spec, mesh, rank)
    emb = params["tok_emb"]
    stacked = (emb["qs"] if isinstance(emb, Mapping) else emb).dim() == 3

    def one(name, x):
        axis = QUANT_REDUCE_AXIS.get(name)
        if isinstance(x, Mapping):
            return cut_quantized(jax_layout(x, axis), axis, lambda t: cut(name, t))
        if quant and axis is not None:
            return quantize_cut(x, axis, lambda t: cut(name, t))
        return cut(name, x).contiguous()

    def leaf(name, x, block: bool):
        if x is None or not cut.keeps(name):
            return None
        if not stacked:
            return one(name, x)
        at = 1 if block else 0  # the member axis: after the layer axis in a block leaf
        parts = [one(name, _map(x, lambda t: t.select(at, m)))
                 for m in range((x["qs"] if isinstance(x, Mapping) else x).shape[at])]
        if isinstance(parts[0], Mapping):
            return {k: torch.stack([p[k] for p in parts], at) for k in parts[0]}
        return torch.stack(parts, at)

    out = {k: leaf(k, v, False) for k, v in params.items() if k != "blocks"}
    out["blocks"] = {k: leaf(k, v, True) for k, v in params["blocks"].items()}
    return out


def _as_tensor(x, device) -> torch.Tensor:
    """A numpy leaf as a tensor of its own dtype (bfloat16 kept bfloat16):
    0-d leaves (counts, the step) on the host, the rest on ``device``."""
    arr = np.asarray(x)
    bf16 = arr.dtype.name == "bfloat16"
    t = torch.from_numpy(np.array(arr.astype(np.float32) if bf16 else arr, order="C"))
    if bf16:
        t = t.to(torch.bfloat16)  # exact: every bfloat16 is a float32
    return t if t.dim() == 0 else t.to(device)


def _state_from_numpy(x, device, cut=None, name: str = ""):
    from quorum_tpu_torch.training.optim import STATE_TYPES

    if x is None:
        return None
    if isinstance(x, Mapping):
        return {k: _state_from_numpy(v, device, cut, k) for k, v in x.items()}
    if hasattr(x, "_fields"):
        cls = STATE_TYPES.get(type(x).__name__)
        if cls is None or cls._fields != x._fields:
            raise ValueError(f"optimizer state {type(x).__name__}{x._fields} has no "
                             f"counterpart in the port ({sorted(STATE_TYPES)})")
        return cls(*(_state_from_numpy(v, device, cut, f) for f, v in zip(x._fields, x)))
    if isinstance(x, (tuple, list)):
        return tuple(_state_from_numpy(v, device, cut) for v in x)
    t = _as_tensor(x, device)
    return t if cut is None or t.dim() == 0 else cut(name, t).contiguous()


def train_state_from_numpy(params: Mapping, opt_state, step, device=None, *, mesh=None,
                           spec=None):
    """A JAX TrainState, every leaf read back as numpy (``jax.tree.map(
    numpy.asarray, state)``: optax's NamedTuples kept), as the port's
    ``training.TrainState`` on ``device`` (``None`` means cuda): each leaf
    keeps its dtype (bf16 params and moments stay bf16), optax's state
    NamedTuples become the port's of the same name (``training/optim.py``),
    the counts and the step 0-d int32 tensors on the host. A JAX run resumes
    in the port from it. With ``mesh`` (a ``RankMesh``) and ``spec``: the
    rank's tp cut of the state on the rank's device (each leaf cut by its
    name, ``parallel/sharding.rank_cut``), to resume on a mesh."""
    from quorum_tpu_torch.training.trainer import TrainState

    cut = None
    if mesh is not None:
        from quorum_tpu_torch.parallel.sharding import rank_cut

        if spec is None:
            raise ValueError("a state resumed onto a mesh needs its spec")
        dev, cut = mesh.device, rank_cut(spec, mesh, mesh.rank)
    else:
        dev = resolve_device(device)
    tparams = _state_from_numpy(dict(params), dev, cut)
    return TrainState(tparams, _state_from_numpy(opt_state, dev, cut),
                      torch.tensor(int(np.asarray(step)), dtype=torch.int32))
