"""Convert a parameter tree of numpy arrays (the JAX package's pytree, read
back with ``numpy.asarray`` leaf by leaf) into the port's params.

The tree keeps its layout: the same leaf names (an MoE tree's ``router``
and ``moe_w_*`` leaves too), ``None`` for absent leaves, per-layer weights
stacked ``[L, …]`` under ``"blocks"``. Quantized
``{"q8", "qs"}`` leaves are refused: int8 serving is not ported yet.
Member-stacked trees (``members=M`` / ``ensemble=M`` engines) go through
:func:`stacked_params_from_numpy`.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from quorum_tpu_torch import resolve_device


def _leaf(x, device, dtype):
    if isinstance(x, Mapping):
        if "q8" in x:
            raise ValueError(
                "quantized {q8, qs} leaves are not supported by the port yet "
                "(int8 serving is a later slice); convert an unquantized tree")
        raise ValueError(f"unexpected nested mapping leaf with keys {sorted(x)}")
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
            out[name] = {k: (None if b is None else _leaf(b, dev, dt)) for k, b in x.items()}
        else:
            out[name] = None if x is None else _leaf(x, dev, dt)
    return out


def stacked_params_from_numpy(tree: Mapping, device=None, dtype=None) -> dict:
    """The JAX engine's member-stacked tree (every leaf ``[M, …]``, block
    leaves ``[M, L, …]``) → the port's stacked layout: top-level leaves
    ``[M, …]``, block leaves ``[L, M, …]`` (permuted once, contiguous)."""
    out = params_from_numpy(tree, device=device, dtype=dtype)
    out["blocks"] = {k: (None if b is None else b.transpose(0, 1).contiguous())
                     for k, b in out["blocks"].items()}
    return out


def stack_params(trees: list[dict]) -> dict:
    """M port trees → one stacked tree in the port's layout (top-level
    leaves stacked on a new axis 0, block leaves on axis 1)."""
    first = trees[0]
    out = {name: (None if x is None else torch.stack([t[name] for t in trees]))
           for name, x in first.items() if name != "blocks"}
    out["blocks"] = {k: (None if b is None else torch.stack([t["blocks"][k] for t in trees], 1))
                     for k, b in first["blocks"].items()}
    return out
