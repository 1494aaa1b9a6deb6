"""Seeded random parameter initialization for any :class:`ModelSpec`.

Same leaf names, shapes and scaling as the JAX package's ``init_params``
(normal · fan_in^-0.5, identity norms, zero biases); the random bits come
from a ``torch.Generator`` and so differ from JAX's. Stacked ``[L, …]``
leaves are drawn one layer at a time, so a full 8B init never holds more
than one layer's float32 temporary beside the bf16 weights.

:func:`init_params_stacked` is the member-stacked init of the JAX package's
``init_params_ensemble_sharded``: M weight sets in one tree, top-level
leaves ``[M, …]`` and block leaves ``[L, M, …]`` (so one layer's slab of a
weight, ``blocks[k][l]``, is one contiguous ``[M, D, N]`` tensor). Member
``i`` is bit-identical to ``init_params(spec, seeds[i])``: each member draws
from its own generator, in the single init's order, straight into its slice.
"""

from __future__ import annotations

import torch

from quorum_tpu_torch import resolve_device
from quorum_tpu_torch.models.model_config import ModelSpec

Params = dict


def _init(spec: ModelSpec, seeds: list[int], stacked: bool, device, dtype) -> Params:
    spec.validate()
    dev = resolve_device(device)
    dt = getattr(torch, dtype or spec.dtype)
    gens = [torch.Generator(device=dev).manual_seed(int(s)) for s in seeds]
    lead = (len(seeds),) if stacked else ()

    def parts(out, layered):
        """(member generator, destination) pairs in each member's draw
        order: layer by layer for ``[L, …]`` leaves, else the whole leaf."""
        for l in range(out.shape[0]) if layered else (None,):
            for m, gen in enumerate(gens):
                dst = out if l is None else out[l]
                yield gen, (dst[m] if stacked else dst)

    def w(*shape, fan_in=None, layered=False):
        fan = fan_in if fan_in is not None else shape[-2] if len(shape) >= 2 else shape[-1]
        full_shape = (shape[0],) + lead + shape[1:] if layered else lead + shape
        out = torch.empty(full_shape, dtype=dt, device=dev)
        for gen, part in parts(out, layered):
            part.copy_(torch.randn(part.shape, generator=gen, dtype=torch.float32,
                                   device=dev) * fan ** -0.5)
        return out

    def full(shape, value, layered=False):
        full_shape = (shape[0],) + lead + shape[1:] if layered else lead + shape
        return torch.full(full_shape, value, dtype=dt, device=dev)

    L, D, V = spec.n_layers, spec.d_model, spec.vocab_size
    H = spec.n_heads * spec.head_dim
    K = spec.n_kv_heads * spec.head_dim
    F = spec.d_ff
    if spec.is_moe:
        raise NotImplementedError("MoE specs are not ported yet (dense models only)")
    # Stored norm weight such that the effective multiplier (norm_offset + w)
    # is identity: 1.0 for llama-style, 0.0 for gemma's (1 + w) convention.
    norm_one = 1.0 - spec.norm_offset
    ln = spec.norm == "layernorm"
    bias = spec.use_bias
    blocks = {
        "attn_norm_w": full((L, D), norm_one, layered=True),
        "attn_norm_b": full((L, D), 0.0, layered=True) if ln else None,
        "wq": w(L, D, H, layered=True),
        "wk": w(L, D, K, layered=True),
        "wv": w(L, D, K, layered=True),
        "wo": w(L, H, D, layered=True),
        "bq": full((L, H), 0.0, layered=True) if bias else None,
        "bk": full((L, K), 0.0, layered=True) if bias else None,
        "bv": full((L, K), 0.0, layered=True) if bias else None,
        "bo": full((L, D), 0.0, layered=True) if bias else None,
        "mlp_norm_w": full((L, D), norm_one, layered=True),
        "mlp_norm_b": full((L, D), 0.0, layered=True) if ln else None,
        "w_gate": w(L, D, F, layered=True) if spec.gated_mlp else None,
        "w_up": w(L, D, F, layered=True),
        "w_down": w(L, F, D, layered=True),
        "b_up": full((L, F), 0.0, layered=True) if bias else None,
        "b_down": full((L, D), 0.0, layered=True) if bias else None,
    }
    return {
        "tok_emb": w(V, D, fan_in=D),
        "pos_emb": w(spec.max_seq, D, fan_in=D) if spec.pos == "learned" else None,
        "final_norm_w": full((D,), norm_one),
        "final_norm_b": full((D,), 0.0) if ln else None,
        "lm_head": None if spec.tied_lm_head else w(D, V),
        "blocks": blocks,
    }


def init_params(spec: ModelSpec, seed: int = 0, device=None, dtype=None) -> Params:
    return _init(spec, [seed], False, device, dtype)


def init_params_stacked(spec: ModelSpec, seeds: list[int], device=None, dtype=None) -> Params:
    """M = ``len(seeds)`` weight sets stacked in one tree (top-level leaves
    ``[M, …]``, block leaves ``[L, M, …]``); member ``i`` equals
    ``init_params(spec, seeds[i])`` bit for bit. Never builds M trees and
    stacks them, which would need twice the weights' memory for a moment."""
    if not seeds:
        raise ValueError("init_params_stacked needs at least one seed")
    return _init(spec, list(seeds), True, device, dtype)
