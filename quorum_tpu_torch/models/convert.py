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
:func:`stacked_params_from_numpy`.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from quorum_tpu_torch import resolve_device
from quorum_tpu_torch.models.quant import QUANT_REDUCE_AXIS, port_layout


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
