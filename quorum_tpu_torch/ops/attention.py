"""Causal attention with grouped-query (GQA) support — the plain PyTorch
versions of both attention kernels.

Layout: q [B, H, S, hd]; k/v [B, K, S_kv, hd] with H = K * G query groups.
GQA is a reshape of q to [B, K, G, S, hd] contracted against the shared K/V
heads (no repeated K/V copies). Softmax runs in float32 with the finite
``NEG_INF`` mask value, so masked rows stay NaN-free in bf16 and f32.

``prefill_attention`` is the plain version of kernel K1
(ops/flash_attention.py), ``decode_attention`` of kernel K2
(ops/flash_decode.py) and ``decode_attention_q8`` (the int8 KV cache's
decode step) of kernel K2q8 (ops/flash_decode_q8.py): each wrapper takes it
for CPU tensors, and the tests and ``chip_smoke.py`` hold the kernels
against it.
"""

from __future__ import annotations

import torch

NEG_INF = -2.0**30  # large-but-finite: keeps masked softmax NaN-free in bf16/f32


def refuse_autograd(name: str, *tensors: torch.Tensor) -> None:
    """Raise where a kernel wrapper would drop gradients: the kernels write
    their outputs through raw pointers, so an output has no ``grad_fn``.
    Checked on every device (a CPU test then catches a caller that would
    train a different model on the card), before the plain version runs."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward: its output would carry no gradient. Pass "
            "plain_attention=True where gradients are needed, or call it under "
            "torch.no_grad()")


def attention(
    q: torch.Tensor,  # [B, H, S, hd]
    k: torch.Tensor,  # [B, K, S_kv, hd]
    v: torch.Tensor,  # [B, K, S_kv, hd]
    mask: torch.Tensor | None = None,  # broadcastable to [B, 1, 1, S, S_kv], True=keep
) -> torch.Tensor:
    """Full attention over the given K/V. Returns [B, H, S, hd]. The
    scores are f32 products of q and k in their own dtype (JAX's
    ``preferred_element_type=float32``): on the card a 16-bit k is
    contracted as it is, never copied to f32."""
    b, h, s, d = q.shape
    n_kv = k.shape[1]
    qg = q.reshape(b, n_kv, h // n_kv, s, d)
    scale = d ** -0.5
    logits = _scores(qg, k) * scale
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.exp(logits - torch.amax(logits, dim=-1, keepdim=True))
    probs = probs / torch.sum(probs, dim=-1, keepdim=True)
    out = torch.einsum("bkgst,bktd->bkgsd", probs.to(v.dtype), v)
    return out.reshape(b, h, s, d)


def _scores(qg: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``einsum("bkgsd,bktd->bkgst")`` in f32: one batched product with an
    f32 output over 16-bit operands on the card (f32 accumulation, no
    rounding of the scores, no f32 copy of k), else in f32. That product
    (``bmm`` with ``out_dtype``) has no derivative, so a call that needs
    gradients takes the f32 einsum of f32 copies: the same contraction of
    the same values, differentiable."""
    needs_grad = torch.is_grad_enabled() and (qg.requires_grad or k.requires_grad)
    if (qg.is_cuda and not needs_grad and qg.dtype == k.dtype
            and qg.dtype in (torch.bfloat16, torch.float16)):
        b, n_kv, g, s, d = qg.shape
        t = k.shape[2]
        out = torch.bmm(qg.reshape(b * n_kv, g * s, d), k.reshape(b * n_kv, t, d).transpose(1, 2),
                        out_dtype=torch.float32)
        return out.reshape(b, n_kv, g, s, t)
    return torch.einsum("bkgsd,bktd->bkgst", qg.float(), k.float())


def causal_mask(s_q: int, s_kv: int, q_offset: int = 0, window: int = 0,
                device=None) -> torch.Tensor:
    """[1, 1, 1, s_q, s_kv] boolean causal mask; query i sits at absolute
    position q_offset + i. ``window`` > 0 adds sliding-window attention:
    key j is visible to the query at position p iff p-window < j <= p."""
    qi = torch.arange(s_q, device=device)[:, None] + q_offset
    ki = torch.arange(s_kv, device=device)[None, :]
    keep = ki <= qi
    if window > 0:
        keep = keep & (ki > qi - window)
    return keep[None, None, None]


def prefill_attention(q, k, v, lengths: torch.Tensor | None = None,
                      window: int = 0) -> torch.Tensor:
    """Causal self-attention over a [B, ·, S, hd] prompt block; ``lengths``
    ([B]) masks out right-padding, ``window`` > 0 adds the sliding window."""
    mask = causal_mask(q.shape[2], k.shape[2], window=window, device=q.device)
    if lengths is not None:
        ki = torch.arange(k.shape[2], device=q.device)
        valid = ki[None, :] < lengths.to(q.device)[:, None]  # [B, S_kv]
        mask = mask & valid[:, None, None, None, :]
    return attention(q, k, v, mask)


def decode_attention(
    q: torch.Tensor,        # [B, H, 1, hd]
    k_cache: torch.Tensor,  # [B, K, T, hd]
    v_cache: torch.Tensor,
    lengths: torch.Tensor,  # [B]: valid cache entries (incl. the current token)
    window: int = 0,
) -> torch.Tensor:
    """One decode step against the KV cache, masked by each row's length;
    ``window`` > 0 restricts a row to its last ``window`` positions."""
    ki = torch.arange(k_cache.shape[2], device=q.device)[None, :]
    lengths = lengths.to(q.device)[:, None]
    valid = ki < lengths  # [B, T]
    if window > 0:
        valid = valid & (ki >= lengths - window)
    return attention(q, k_cache, v_cache, valid[:, None, None, None, :])


def quantize_rows(x: torch.Tensor, axis: int = -1) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization along ``axis``: ``(q8, scale)`` with
    ``x ≈ q8 * scale`` (scale f32, keeping the reduced dim at size 1). The
    JAX package's formulation exactly: amax/127 with a 1e-30 floor for an
    all-zero row, round half to even (``torch.round`` as ``jnp.round``),
    clip to ±127. models/quant.py quantizes weights and activations the same
    way; the int8 KV cache's writes and its queries and probabilities use
    this one."""
    xf = x.float()
    amax = torch.amax(xf.abs(), dim=axis, keepdim=True)
    s = torch.clamp_min(amax, 1e-30) / 127.0
    return torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8), s


def _int_dot(eq: str, a8: torch.Tensor, b8: torch.Tensor) -> torch.Tensor:
    """``einsum(eq)`` of two int8 tensors as exact integers, read back as
    float32 (the JAX package's int32 result cast to f32). Computed in
    float64, exact for any sum below 2^53, since neither device multiplies
    integer tensors in a batched product."""
    return torch.einsum(eq, a8.double(), b8.double()).float()


def q8_probabilities(
    q: torch.Tensor,        # [B, H, 1, hd] bf16/f32
    k8: torch.Tensor,       # [B, K, T, hd] int8 cache
    k_scale: torch.Tensor,  # [B, K, T] f32
    v_scale: torch.Tensor,  # [B, K, T] f32
    lengths: torch.Tensor,  # [B]
    window: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The probabilities of :func:`decode_attention_q8` with V's scale
    folded in, ``pv`` [B, K, G, 1, T] f32, and their quantization over t:
    ``(pv, p8, ps)`` with ``pv ≈ p8 * ps``, one scale per (row, head)."""
    b, h, s, d = q.shape
    n_kv = k8.shape[1]
    qg = q.reshape(b, n_kv, h // n_kv, s, d)
    q8, qs = quantize_rows(qg, axis=-1)                      # qs [B, K, G, 1, 1]
    logits_i = _int_dot("bkgsd,bktd->bkgst", q8, k8)
    logits = (logits_i * qs * k_scale[:, :, None, None, :]) * (d ** -0.5)
    ki = torch.arange(k8.shape[2], device=q.device)[None, :]
    lengths = lengths.to(q.device)[:, None]
    valid = ki < lengths
    if window > 0:
        valid = valid & (ki >= lengths - window)
    logits = torch.where(valid[:, None, None, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    probs = torch.exp(logits - torch.amax(logits, dim=-1, keepdim=True))
    probs = probs / torch.sum(probs, dim=-1, keepdim=True)
    pv = probs * v_scale[:, :, None, None, :]                # fold v's scale in
    p8, ps = quantize_rows(pv, axis=-1)                      # ps [B, K, G, 1, 1]
    return pv, p8, ps


def decode_attention_q8(
    q: torch.Tensor,        # [B, H, 1, hd] bf16/f32
    k8: torch.Tensor,       # [B, K, T, hd] int8 cache
    k_scale: torch.Tensor,  # [B, K, T] f32: k ≈ k8 * k_scale[..., None]
    v8: torch.Tensor,       # [B, K, T, hd] int8 cache
    v_scale: torch.Tensor,  # [B, K, T] f32
    lengths: torch.Tensor,  # [B]: valid cache entries (incl. the current token)
    window: int = 0,
) -> torch.Tensor:
    """One decode step against an int8 KV cache, the JAX package's
    ``ops/attention.decode_attention_q8`` step for step: q (one row per
    head) and the probabilities (one row per query) are quantized amax/127;
    both contractions are integer products. K's per-token scale lands on
    its output position (logits · ks[t]); V's per-token scale is folded
    into the probabilities before they are quantized over t, with one scale
    for the row's whole range. Returns [B, H, 1, hd] in q's dtype."""
    b, h, s, d = q.shape
    _, p8, ps = q8_probabilities(q, k8, k_scale, v_scale, lengths, window)
    out = _int_dot("bkgst,bktd->bkgsd", p8, v8) * ps
    return out.reshape(b, h, s, d).to(q.dtype)
