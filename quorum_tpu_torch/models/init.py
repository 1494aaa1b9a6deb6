"""Seeded random parameter initialization for any :class:`ModelSpec`.

Same leaf names, shapes and scaling as the JAX package's ``init_params``
(normal · fan_in^-0.5, identity norms, zero biases; MoE specs carry
``router [L, D, E]``, ``moe_w_gate`` / ``moe_w_up [L, E, D, F]`` and
``moe_w_down [L, E, F, D]`` in place of the dense MLP); the random bits come
from a ``torch.Generator`` and so differ from JAX's. Stacked ``[L, …]``
leaves are drawn one layer at a time, so a full 8B init never holds more
than one layer's float32 temporary beside the bf16 weights.

:func:`init_params_stacked` is the member-stacked init of the JAX package's
``init_params_ensemble_sharded``: M weight sets in one tree, top-level
leaves ``[M, …]`` and block leaves ``[L, M, …]`` (so one layer's slab of a
weight, ``blocks[k][l]``, is one contiguous ``[M, D, N]`` tensor). Member
``i`` is bit-identical to ``init_params(spec, seeds[i])``: each member draws
from its own generator, in the single init's order, straight into its slice.

``quant="int8"`` (the JAX package's quantized inits) gives the tree
``models/quant.quantize_params`` would make of the bf16 init, bit for bit,
without ever holding a whole bf16 leaf: each layer slice of each member of
each weight is drawn, cast to the spec's dtype and quantized into its slice
of the int8 leaf before the next is drawn (mixtral-8x7b's ``moe_w_gate``
alone is 30 GB in bf16; a layer slice is 0.94 GB). Scales reduce over the
contraction axis, so a stacked tree's scales are each member's own.
"""

from __future__ import annotations

import torch

from quorum_tpu_torch import resolve_device
from quorum_tpu_torch.models.model_config import ModelSpec
from quorum_tpu_torch.models.quant import QUANT_REDUCE_AXIS, quantize_cut, quantize_weight

Params = dict


def check_quant(quant: str | None) -> str | None:
    """The JAX engine's ``quant`` check, word for word; None when off."""
    if quant not in (None, "", "int8"):
        raise ValueError(f"unsupported quant mode {quant!r} (int8 or none)")
    return quant or None


def _init(spec: ModelSpec, seeds: list[int], stacked: bool, device, dtype,
          quant: str | None = None, cut=None) -> Params:
    spec.validate()
    quant = check_quant(quant)
    dev = resolve_device(device)
    dt = getattr(torch, dtype or spec.dtype)
    # device="meta": the tree's shapes and dtypes with no memory and no draws
    # (a checkpoint's restore target).
    gens = [None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(int(s))
            for s in seeds]
    lead = (len(seeds),) if stacked else ()

    def parts(full_shape, layered):
        """(member generator, index of its part) in each member's draw
        order: layer by layer for ``[L, …]`` leaves, else the whole leaf."""
        for l in range(full_shape[0]) if layered else (None,):
            for m, gen in enumerate(gens):
                yield gen, (() if l is None else (l,)) + ((m,) if stacked else ())

    def w(*shape, fan_in=None, layered=False, name=""):
        fan = fan_in if fan_in is not None else shape[-2] if len(shape) >= 2 else shape[-1]
        full_shape = (shape[0],) + lead + shape[1:] if layered else lead + shape

        def draw(gen, part_shape):
            return torch.randn(part_shape, generator=gen, dtype=torch.float32,
                               device=dev) * fan ** -0.5

        if cut is not None:
            # A rank's shard: every part (one member's layer slice, or
            # leaf) drawn whole, in the init's order, and cut before the
            # next is drawn; a quantized leaf's part is quantized whole
            # first, so each channel's scale is its amax over the whole
            # contraction axis, and its q8 and scales are cut together
            # (``models/quant.quantize_cut``). A pipeline stage keeps its
            # own layers' parts (the others are drawn all the same, so the
            # generator reaches each part where the whole init does) and a
            # later stage skips the leaves it does not hold (all of them
            # drawn after every block leaf).
            if not cut.keeps(name):
                return None
            lo, hi = cut.layers if layered else (0, 1)
            kept_lead = ((hi - lo,) if layered else ()) + lead
            axis = QUANT_REDUCE_AXIS.get(name) if quant else None
            out = None
            for gen, idx in parts(full_shape, layered):
                piece = draw(gen, full_shape[len(idx):])
                if layered and not lo <= idx[0] < hi:
                    continue
                at = (idx[0] - lo,) + idx[1:] if layered else idx
                if axis is None:
                    piece = cut(name, piece, layered)
                    if out is None:
                        out = torch.empty(kept_lead + tuple(piece.shape), dtype=dt, device=dev)
                    out[at].copy_(piece)
                    continue
                q = quantize_cut(piece.to(dt), axis, lambda x: cut(name, x, layered))
                if out is None:
                    out = {k: torch.empty(kept_lead + tuple(v.shape), dtype=v.dtype, device=dev)
                           for k, v in q.items()}
                for k, v in q.items():
                    out[k][at].copy_(v)
            return out
        if not (quant and name in QUANT_REDUCE_AXIS):
            out = torch.empty(full_shape, dtype=dt, device=dev)
            for gen, idx in parts(full_shape, layered):
                out[idx].copy_(draw(gen, full_shape[len(idx):]))
            return out
        out = None
        for gen, idx in parts(full_shape, layered):
            q = quantize_weight(draw(gen, full_shape[len(idx):]).to(dt), QUANT_REDUCE_AXIS[name])
            if out is None:
                out = {k: torch.empty(full_shape[:len(idx)] + v.shape, dtype=v.dtype, device=dev)
                       for k, v in q.items()}
            for k, v in q.items():
                out[k][idx].copy_(v)
        return out

    def full(shape, value, layered=False, name=""):
        if cut is None:
            full_shape = (shape[0],) + lead + shape[1:] if layered else lead + shape
            return torch.full(full_shape, value, dtype=dt, device=dev)
        one = cut(name, torch.full(shape, value, dtype=dt, device=dev))
        if one is None:
            return None
        if not stacked:
            return one.contiguous()
        at = 1 if layered else 0  # the member axis, after the layer axis
        return one.unsqueeze(at).expand(*one.shape[:at], len(seeds),
                                        *one.shape[at:]).contiguous()

    L, D, V = spec.n_layers, spec.d_model, spec.vocab_size
    H = spec.n_heads * spec.head_dim
    K = spec.n_kv_heads * spec.head_dim
    F, E = spec.d_ff, spec.n_experts
    # Stored norm weight such that the effective multiplier (norm_offset + w)
    # is identity: 1.0 for llama-style, 0.0 for gemma's (1 + w) convention.
    norm_one = 1.0 - spec.norm_offset
    ln = spec.norm == "layernorm"
    bias = spec.use_bias
    blocks = {
        "attn_norm_w": full((L, D), norm_one, layered=True, name="attn_norm_w"),
        "attn_norm_b": full((L, D), 0.0, layered=True, name="attn_norm_b") if ln else None,
        "wq": w(L, D, H, layered=True, name="wq"),
        "wk": w(L, D, K, layered=True, name="wk"),
        "wv": w(L, D, K, layered=True, name="wv"),
        "wo": w(L, H, D, layered=True, name="wo"),
        "bq": full((L, H), 0.0, layered=True, name="bq") if bias else None,
        "bk": full((L, K), 0.0, layered=True, name="bk") if bias else None,
        "bv": full((L, K), 0.0, layered=True, name="bv") if bias else None,
        "bo": full((L, D), 0.0, layered=True, name="bo") if bias else None,
        "mlp_norm_w": full((L, D), norm_one, layered=True, name="mlp_norm_w"),
        "mlp_norm_b": full((L, D), 0.0, layered=True, name="mlp_norm_b") if ln else None,
    }
    if spec.is_moe:
        blocks.update(
            router=w(L, D, E, layered=True, name="router"),
            moe_w_gate=w(L, E, D, F, fan_in=D, layered=True, name="moe_w_gate"),
            moe_w_up=w(L, E, D, F, fan_in=D, layered=True, name="moe_w_up"),
            moe_w_down=w(L, E, F, D, fan_in=F, layered=True, name="moe_w_down"),
        )
    else:
        blocks.update(
            w_gate=w(L, D, F, layered=True, name="w_gate") if spec.gated_mlp else None,
            w_up=w(L, D, F, layered=True, name="w_up"),
            w_down=w(L, F, D, layered=True, name="w_down"),
            b_up=full((L, F), 0.0, layered=True, name="b_up") if bias else None,
            b_down=full((L, D), 0.0, layered=True, name="b_down") if bias else None,
        )
    return {
        "tok_emb": w(V, D, fan_in=D, name="tok_emb"),
        "pos_emb": w(spec.max_seq, D, fan_in=D, name="pos_emb") if spec.pos == "learned" else None,
        "final_norm_w": full((D,), norm_one, name="final_norm_w"),
        "final_norm_b": full((D,), 0.0, name="final_norm_b") if ln else None,
        "lm_head": None if spec.tied_lm_head else w(D, V, name="lm_head"),
        "blocks": blocks,
    }


def init_params(spec: ModelSpec, seed: int = 0, device=None, dtype=None,
                quant: str | None = None) -> Params:
    return _init(spec, [seed], False, device, dtype, quant)


def init_params_shard(spec: ModelSpec, seed: int, mesh, rank: int, device=None,
                      dtype=None, quant: str | None = None) -> Params:
    """Rank ``rank``'s shard of ``init_params(spec, seed, quant=quant)`` on
    ``mesh`` (a ``parallel/mesh.Mesh`` or ``RankMesh``), bit for bit its cut
    (``parallel/sharding.rank_cut``; a quantized leaf's cut is
    ``models/quant.cut_quantized`` of the whole leaf): each layer slice is
    drawn whole from the same generator in the same order, quantized whole
    with ``quant``, cut, and only the cut kept, so a rank holds its share of
    the weights plus one layer's float32 draw (a pipeline stage: its own
    layers, and only stage 0 the embedding, final norm and head)."""
    from quorum_tpu_torch.parallel.sharding import rank_cut

    return _init(spec, [seed], False, device, dtype, quant, cut=rank_cut(spec, mesh, rank))


def init_params_stacked_shard(spec: ModelSpec, seeds: list[int], mesh, rank: int,
                              device=None, dtype=None, quant: str | None = None) -> Params:
    """Rank ``rank``'s cut of ``init_params_stacked(spec, seeds,
    quant=quant)`` on ``mesh``: every member's weights cut as
    :func:`init_params_shard` cuts one (the member axis is never cut, the
    JAX package's ``lead_axes`` rule), in the stacked layout."""
    from quorum_tpu_torch.parallel.sharding import rank_cut

    if not seeds:
        raise ValueError("init_params_stacked_shard needs at least one seed")
    return _init(spec, list(seeds), True, device, dtype, quant, cut=rank_cut(spec, mesh, rank))


def init_params_stacked(spec: ModelSpec, seeds: list[int], device=None, dtype=None,
                        quant: str | None = None) -> Params:
    """M = ``len(seeds)`` weight sets stacked in one tree (top-level leaves
    ``[M, …]``, block leaves ``[L, M, …]``); member ``i`` equals
    ``init_params(spec, seeds[i])`` bit for bit. Never builds M trees and
    stacks them, which would need twice the weights' memory for a moment."""
    if not seeds:
        raise ValueError("init_params_stacked needs at least one seed")
    return _init(spec, list(seeds), True, device, dtype, quant)
