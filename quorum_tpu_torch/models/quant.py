"""Weight-only int8 quantization for serving (``cuda://…?quant=int8``): the
JAX package's ``models/quant.py`` on torch tensors.

Decode reads every weight once a step, so its time is bounded by the bytes
of the weights: int8 halves them against bf16, and halves what the weights
hold on the card (mixtral-8x7b: 93.4 GB in bf16, 46.7 GB in int8, which fits
one 80 GB H100).

The formulation is the JAX package's: symmetric per-output-channel weight
scales (amax/127 over the contraction axis, a 1e-30 floor), and every
product is dynamic w8a8 — the activation is quantized per row over its
contraction axis, the product runs int8 × int8 → int32, and the result is
rescaled by the outer product of the row and channel scales, in float32.
The weight is never dequantized into the product. On the card the integer
product is ``torch._int_mm`` (cuBLASLt's int8 GEMM); on a CPU tensor it is
the same integer product as a float32 GEMM, as the JAX package's CPU branch
computes it (exact while the sums stay below 2^24, which the tests' widths
do).

The port's leaf layout. A quantized leaf is the JAX package's dict
``{"q8": int8, "qs": float32}``, stored contraction-axis last: for a weight
``w [..., K, N]`` (reduced over K, ``QUANT_REDUCE_AXIS`` −2) ``q8`` is
``[..., N, K]`` and ``qs`` ``[..., N, 1]`` — JAX's leaf with its last two
axes swapped, the K-major operand an int8 GEMM on Hopper reads (``x @
q8.T`` is a view, no copy per call). ``tok_emb [V, D]`` (reduced over D,
axis −1) is already in that layout, so the tied unembed ``x @ tok_emb.T``
is the same product with per-vocab scales. ``q8``'s N axis is zero-padded
to a multiple of 8 (cuBLASLt's int8 GEMM needs it; real gpt2's vocabulary
is 50 257); ``qs`` keeps the true N, which is how a product knows how many
output columns are real. Member-stacked and layer-stacked leading axes are
kept as they are.

What is quantized: ``wq wk wv wo w_gate w_up w_down moe_w_gate moe_w_up
moe_w_down lm_head tok_emb``. What is not: norms, biases, the MoE router
(routing decides which experts run), ``pos_emb``.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import torch
import torch.nn.functional as F

from quorum_tpu_torch.ops.attention import quantize_rows

# Leaf name → the axis of the JAX package's layout that one output channel
# reduces over (the contraction axis of the consuming product).
QUANT_REDUCE_AXIS: dict[str, int] = {
    "wq": -2, "wk": -2, "wv": -2, "wo": -2,
    "w_gate": -2, "w_up": -2, "w_down": -2,
    "moe_w_gate": -2, "moe_w_up": -2, "moe_w_down": -2,
    "lm_head": -2,   # [D, V]: per-vocab-column scale
    "tok_emb": -1,   # [V, D]: per-row scale, exact for the gather and the tied unembed
}
# cuBLASLt's int8 GEMM: N and K multiples of 8, more than 16 rows.
_ALIGN = 8
_MIN_ROWS = 32


def is_quantized(leaf: Any) -> bool:
    return isinstance(leaf, Mapping) and "q8" in leaf


def quantize_leaf(w: torch.Tensor, axis: int) -> dict[str, torch.Tensor]:
    """Symmetric per-channel int8 in the JAX package's layout: ``q8`` the
    shape of ``w``, ``qs = max|w| / 127`` over ``axis`` (kept at size 1)."""
    q8, qs = quantize_rows(w, axis=axis)
    return {"q8": q8, "qs": qs}


def port_layout(leaf: Mapping, axis: int) -> dict[str, torch.Tensor]:
    """A JAX-layout quantized leaf (``quantize_leaf(w, axis)``) in the
    port's layout: contraction axis last (the last two axes of ``q8`` and
    ``qs`` swapped where ``axis`` is −2), ``q8``'s rows zero-padded to a
    multiple of 8."""
    q8, qs = leaf["q8"], leaf["qs"]
    if axis == -2:
        q8, qs = q8.transpose(-1, -2), qs.transpose(-1, -2)
    pad = -q8.shape[-2] % _ALIGN
    if pad:
        q8 = F.pad(q8, (0, 0, 0, pad))
    return {"q8": q8.contiguous(), "qs": qs.contiguous()}


def jax_layout(leaf: Mapping, axis: int) -> dict[str, torch.Tensor]:
    """The inverse of :func:`port_layout`: the JAX package's leaf (no row
    padding), for comparing trees."""
    q8, qs = leaf["q8"][..., :leaf["qs"].shape[-2], :], leaf["qs"]
    if axis == -2:
        q8, qs = q8.transpose(-1, -2), qs.transpose(-1, -2)
    return {"q8": q8, "qs": qs}


def leaf_shapes(shape: tuple, axis: int) -> dict[str, tuple]:
    """The port-layout shapes of ``q8`` and ``qs`` for a weight of
    ``shape`` (JAX layout) reduced over ``axis``."""
    *lead, a, b = shape
    n, k = (b, a) if axis == -2 else (a, b)
    return {"q8": (*lead, n + -n % _ALIGN, k), "qs": (*lead, n, 1)}


def quantize_weight(w: torch.Tensor, axis: int) -> dict[str, torch.Tensor]:
    """``w`` (JAX layout) → its quantized leaf in the port's layout."""
    return port_layout(quantize_leaf(w, axis), axis)


def dq(leaf: Any, dtype=torch.bfloat16, axis: int = -1):
    """Explicit dequantization in ``dtype`` (the JAX package multiplies in
    the target dtype, not in float32), in the JAX package's layout of a
    leaf reduced over ``axis`` (its ``QUANT_REDUCE_AXIS`` entry). For tests
    and small slices: a product never takes it."""
    if not is_quantized(leaf):
        return leaf
    j = jax_layout(leaf, axis)
    return j["q8"].to(dtype) * j["qs"].to(dtype)


def emb_rows(leaf: Any, index, dtype: torch.dtype) -> torch.Tensor:
    """Rows of an embedding table (``leaf[index]``, ``index`` a tensor or a
    tuple of index tensors) in ``dtype``; a quantized table gathers its int8
    rows and their scales and multiplies them in ``dtype`` (the JAX
    package's ``_emb_rows``)."""
    if is_quantized(leaf):
        return leaf["q8"][index].to(dtype) * leaf["qs"][index].to(dtype)
    return leaf[index].to(dtype)


def _int_mm(x8: torch.Tensor, q8: torch.Tensor) -> torch.Tensor:
    """``x8 [M, K] @ q8 [N, K]ᵀ`` as integers, read back as float32. On the
    card: ``torch._int_mm`` (int8 × int8 → int32) with the rows padded with
    zeros to more than 16; on the CPU: the float32 GEMM of the JAX package's
    CPU branch."""
    if x8.device.type == "cpu":
        return x8.float() @ q8.float().T
    if x8.shape[-1] % _ALIGN or q8.shape[0] % _ALIGN:
        raise ValueError(f"int8 product needs K and N multiples of {_ALIGN}: "
                         f"{tuple(x8.shape)} @ {tuple(q8.shape)}ᵀ")
    m = x8.shape[0]
    if m < _MIN_ROWS:
        x8 = F.pad(x8, (0, 0, 0, _MIN_ROWS - m))
    return torch._int_mm(x8, q8.T)[:m].float()


def _rescale(y: torch.Tensor, xs: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """``y [.., M, N_pad]`` → ``y[..., :N] * (xs [.., M, 1] * qs [.., N])``:
    JAX's ``y * einsum(eq, xs, qs)`` (the outer product of the scales first)."""
    n = qs.shape[-1]
    return y[..., :n] * (xs * qs.unsqueeze(-2))


def quantize_act(x: torch.Tensor, *leaves) -> tuple[torch.Tensor, torch.Tensor] | None:
    """x quantized per row over its last axis, ``(x8, xs)``, when one of
    ``leaves`` is quantized (else None): products that share x (q/k/v, gate
    and up) pass it to :func:`qeinsum` as ``xq`` and quantize x once."""
    return quantize_rows(x, axis=-1) if any(is_quantized(w) for w in leaves) else None


def qeinsum(eq: str, x: torch.Tensor, leaf: Any, xq=None) -> torch.Tensor:
    """``einsum(eq, x, w)`` read back as float32, where ``w`` may be a
    quantized leaf. The forms the transformer's products take:

    - ``"...d,df->...f"``: ``x @ w`` (w ``[D, F]``);
    - ``"mnd,mdf->mnf"``: per-group products, x ``[M, N, D]`` against a
      stacked w ``[M, D, F]`` (a member-stacked weight, one group per
      member; or the experts of a grouped MoE, one buffer per expert);
    - ``"nd,edf->enf"``: one x ``[N, D]`` against every expert's w
      ``[E, D, F]`` (the dense MoE).

    The tied unembed ``x @ tok_emb.T`` is the first form: a quantized
    ``tok_emb`` is stored ``[V, D]`` like every quantized leaf (``[N, K]``),
    so its per-row scales are the per-vocab output scales; a plain one is
    passed transposed.

    A plain leaf runs ``torch.matmul`` in x's dtype (f32 accumulation on
    the card, the output rounded to x's dtype, then read as float32). A
    quantized leaf quantizes x per row over its last axis once, runs the
    integer product (one ``_int_mm`` per group on the card), and rescales
    in float32; ``xq`` is x already quantized (:func:`quantize_act`)."""
    if not is_quantized(leaf):
        return torch.matmul(x, leaf).float()
    q8, qs = leaf["q8"], leaf["qs"][..., 0]
    x8, xs = xq if xq is not None else quantize_rows(x, axis=-1)
    if eq == "...d,df->...f":
        lead = x.shape[:-1]
        y = _int_mm(x8.reshape(-1, x.shape[-1]), q8)
        return _rescale(y, xs.reshape(-1, 1), qs).reshape(*lead, qs.shape[-1])
    if eq == "mnd,mdf->mnf":
        y = torch.stack([_int_mm(x8[g], q8[g]) for g in range(q8.shape[0])])
        return _rescale(y, xs, qs)
    if eq == "nd,edf->enf":
        e, f = q8.shape[0], q8.shape[1]
        y = _int_mm(x8, q8.reshape(e * f, -1))            # one product for every expert
        y = y.reshape(-1, e, f).transpose(0, 1)           # [E, N, F]
        return _rescale(y, xs[None], qs)
    raise ValueError(f"qeinsum: unsupported form {eq!r}")


def quantize_params(params: Mapping[str, Any]) -> dict[str, Any]:
    """Quantize every eligible leaf of a port param tree (layer-stacked or
    member-stacked) into the port's layout. A leaf that is already
    quantized passes through, as in the JAX package."""

    def walk(tree: Mapping[str, Any]) -> dict[str, Any]:
        out: dict[str, Any] = {}
        for k, v in tree.items():
            if isinstance(v, Mapping):
                out[k] = v if is_quantized(v) else walk(v)
            elif v is not None and k in QUANT_REDUCE_AXIS:
                out[k] = quantize_weight(v, QUANT_REDUCE_AXIS[k])
            else:
                out[k] = v
        return out

    return walk(dict(params))


def quantized_param_bytes(params: Mapping[str, Any]) -> int:
    """On-device bytes of a (possibly partly) quantized param tree."""
    total = 0
    for v in params.values():
        if isinstance(v, Mapping):
            total += quantized_param_bytes(v)
        elif v is not None:
            total += v.numel() * v.element_size()
    return total
