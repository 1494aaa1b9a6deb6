"""Logical-axis rules for model state, and how a rank's shard is cut: the
JAX package's ``parallel/sharding.py`` with the partition specs as tuples
of mesh-axis names (JAX's ``PartitionSpec`` entries) instead of
``PartitionSpec`` objects.

The JAX package names the logical axes of every leaf once
(:data:`PARAM_LOGICAL_AXES`), maps them to mesh axes in one table
(:data:`LOGICAL_RULES`) and lets GSPMD insert the collectives. The port
cuts each rank's shard wherever the same table's spec names ``tp``
(:func:`shard_leaf`, through ``models/convert.shard_params`` and
``models/init.init_params_shard``) and calls the collectives itself
(``parallel/comm.py``, ``models/transformer.py``): Megatron-style tensor
parallelism, heads, MLP hidden and vocab over ``tp``.

One rule differs: where ``n_kv_heads`` does not divide tp (2 kv heads on
tp=4), the JAX package replicates the kv heads (its ``kv_cache_sharding``
and ``replicate_kv_heads``) and shards the query heads' projections by the
flat head dimension; each port rank keeps the kv heads that its own query
heads read (:func:`rank_kv_heads`), so its K/V projections and its cache
hold exactly those.
"""

from __future__ import annotations

from typing import Any, Mapping

from quorum_tpu_torch.parallel.mesh import AXIS_DP, AXIS_PP, AXIS_SP, AXIS_TP

# Logical axis name → mesh axis (None = replicated): the JAX package's table.
LOGICAL_RULES: dict[str, str | None] = {
    "batch": AXIS_DP,
    "seq": None,           # sequence is replicated except under ring attention
    "seq_shard": AXIS_SP,  # ring attention: sequence blocks over the sp axis
    "model": None,         # d_model stays replicated (activations all-reduced)
    "heads": AXIS_TP,
    "kv_heads": AXIS_TP,
    "head_dim": None,
    "ff": AXIS_TP,         # MLP hidden
    "experts": AXIS_TP,    # expert parallelism shares the tp axis
    "vocab": AXIS_TP,
    "layers": AXIS_PP,     # scanned-layer leading dim: stages over pp
    "pos": None,
}

# Logical axes of every parameter leaf (the JAX package's table; the port's
# trees have the same leaf names and layouts).
PARAM_LOGICAL_AXES: dict[str, tuple[str | None, ...]] = {
    "tok_emb": ("vocab", "model"),
    "pos_emb": ("pos", "model"),
    "lm_head": ("model", "vocab"),
    "final_norm_w": ("model",),
    "final_norm_b": ("model",),
    "attn_norm_w": ("layers", "model"),
    "attn_norm_b": ("layers", "model"),
    "wq": ("layers", "model", "heads"),
    "wk": ("layers", "model", "kv_heads"),
    "wv": ("layers", "model", "kv_heads"),
    "wo": ("layers", "heads", "model"),
    "bq": ("layers", "heads"),
    "bk": ("layers", "kv_heads"),
    "bv": ("layers", "kv_heads"),
    "bo": ("layers", "model"),
    "mlp_norm_w": ("layers", "model"),
    "mlp_norm_b": ("layers", "model"),
    "w_gate": ("layers", "model", "ff"),
    "w_up": ("layers", "model", "ff"),
    "w_down": ("layers", "ff", "model"),
    "b_up": ("layers", "ff"),
    "b_down": ("layers", "model"),
    "router": ("layers", "model", "experts"),
    "moe_w_gate": ("layers", "experts", "model", None),
    "moe_w_up": ("layers", "experts", "model", None),
    "moe_w_down": ("layers", "experts", None, "model"),
}

# KV cache: [layers, batch, kv_heads, max_seq, head_dim]
KV_CACHE_AXES: tuple[str | None, ...] = ("layers", "batch", "kv_heads", "seq", "head_dim")


def logical_to_spec(axes: tuple[str | None, ...]) -> tuple[str | None, ...]:
    """``("layers", "model", "ff")`` → ``("pp", None, "tp")``."""
    return tuple(LOGICAL_RULES.get(a) if a else None for a in axes)


def param_partition_specs(params: Mapping[str, Any], lead_axes: int = 0, *,
                          replicate_kv_heads: bool = False) -> dict[str, Any]:
    """The spec of every leaf of a parameter tree (same nesting; an absent
    leaf stays None, an unknown leaf is replicated, ``()``), as the JAX
    package's ``param_partition_specs`` gives them. ``lead_axes`` prepends
    replicated dims (member-stacked trees); ``replicate_kv_heads`` drops
    the kv-head axis (the JAX package's GQA rule)."""

    def spec_for(name: str) -> tuple:
        axes = PARAM_LOGICAL_AXES.get(name)
        if axes is None:
            return ()
        if replicate_kv_heads and "kv_heads" in axes:
            axes = tuple(None if a == "kv_heads" else a for a in axes)
        return (None,) * lead_axes + logical_to_spec(axes)

    def walk(tree: Mapping[str, Any]) -> dict[str, Any]:
        out: dict[str, Any] = {}
        for k, v in tree.items():
            if isinstance(v, Mapping):
                out[k] = ({"q8": spec_for(k), "qs": spec_for(k)} if "q8" in v else walk(v))
            else:
                out[k] = None if v is None else spec_for(k)
        return out

    return walk(params)


def rank_heads(n_heads: int, tp: int, tp_rank: int) -> tuple[int, int]:
    """Query heads ``[lo, hi)`` of tp rank ``tp_rank``: contiguous, H/tp
    each."""
    if n_heads % tp:
        raise ValueError(f"tp={tp} does not divide n_heads={n_heads}: each rank holds "
                         "whole query heads")
    per = n_heads // tp
    return tp_rank * per, (tp_rank + 1) * per


def rank_kv_heads(n_heads: int, n_kv_heads: int, tp: int, tp_rank: int) -> tuple[int, int]:
    """KV heads ``[lo, hi)`` that tp rank ``tp_rank``'s query heads read
    (query head i reads kv head i // G, G = H/K): K/tp of them when tp
    divides K, else the one or few groups its heads fall in (two ranks may
    then hold the same kv head). Refused where a rank's heads would cut
    groups unevenly (its local GQA grouping must stay i // G')."""
    lo, hi = rank_heads(n_heads, tp, tp_rank)
    g = n_heads // n_kv_heads
    per = hi - lo
    if per % g and g % per:
        raise ValueError(
            f"tp={tp} cuts the query-head groups of n_heads={n_heads}, "
            f"n_kv_heads={n_kv_heads} unevenly ({per} heads per rank, {g} per kv head)")
    return lo // g, (hi - 1) // g + 1


def _cut(x, dim: int, lo: int, hi: int):
    return x.narrow(dim, lo, hi - lo)


def rank_cut(spec, mesh, rank: int):
    """``cut(name, x, layer_part=False)``: rank ``rank``'s view of leaf
    ``name`` of ``spec``'s tree on ``mesh`` (a ``Mesh`` or ``RankMesh``)."""
    layout = mesh.mesh if hasattr(mesh, "mesh") else mesh
    tp, tp_rank = layout.shape[AXIS_TP], layout.coords(rank)[AXIS_TP]

    def cut(name: str, x, layer_part: bool = False):
        return shard_leaf(name, x, tp=tp, tp_rank=tp_rank, n_heads=spec.n_heads,
                          n_kv_heads=spec.n_kv_heads, head_dim=spec.head_dim,
                          vocab_size=spec.vocab_size, layer_part=layer_part)

    return cut


def shard_leaf(name: str, x, *, tp: int, tp_rank: int, n_heads: int, n_kv_heads: int,
               head_dim: int, vocab_size: int, layer_part: bool = False):
    """Tp rank ``tp_rank``'s cut of leaf ``name`` (a view), along every dim
    that :func:`logical_to_spec` maps to ``tp``: by whole heads (query
    heads, or the kv heads the rank reads), or by MLP-hidden or vocab
    blocks. A vocab or hidden dim tp does not divide is replicated (the JAX
    package's ``_fit_spec``). ``layer_part``: ``x`` is one layer's slice of
    a ``[L, …]`` leaf."""
    axes = PARAM_LOGICAL_AXES.get(name)
    if axes is None or x is None:
        return x
    if layer_part and axes[0] == "layers":
        axes = axes[1:]
    for dim, (axis, mesh_axis) in enumerate(zip(axes, logical_to_spec(axes))):
        if mesh_axis != AXIS_TP:
            continue
        if axis == "experts":
            raise ValueError(f"MoE leaf {name!r}: MoE specs are not yet on a multi-rank engine")
        if axis == "heads":
            lo, hi = rank_heads(n_heads, tp, tp_rank)
            x = _cut(x, dim, lo * head_dim, hi * head_dim)
        elif axis == "kv_heads":
            lo, hi = rank_kv_heads(n_heads, n_kv_heads, tp, tp_rank)
            x = _cut(x, dim, lo * head_dim, hi * head_dim)
        else:
            n = x.shape[dim]
            if axis == "vocab" and n != vocab_size:
                raise ValueError(f"{name} has {n} vocab rows, the spec {vocab_size}")
            if n % tp == 0:
                per = n // tp
                x = _cut(x, dim, tp_rank * per, (tp_rank + 1) * per)
    return x
