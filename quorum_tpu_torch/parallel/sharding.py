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

The KV cache's slot (batch) axis is cut over dp as the JAX package's
``kv_cache_sharding`` cuts it (:func:`kv_cache_spec`, :func:`slot_rows`):
each dp group of ranks holds a contiguous block of the slot rows, or every
row when dp does not divide their count. The weights are replicated over dp
(each dp rank holds its tp cut).

A dim tp does not divide is whole on every rank, as the JAX package's
``_fit_spec`` leaves it, at the granularity the port cuts: whole query
heads (every head on every rank when tp does not divide H), whole experts
(E/tp each; every expert when tp does not divide E; the router replicated),
MLP-hidden and vocab blocks. Where tp does not divide ``n_kv_heads`` the
JAX package replicates the kv heads (its ``kv_cache_sharding`` and
``replicate_kv_heads``); each port rank's cache keeps the kv heads that its
own query heads read (:func:`rank_kv_index`): its K/V projections are cut
to them where the query-head groups cut evenly, and whole (replicated, as
JAX's) where they do not, the rank then selecting its heads after the
projection (:func:`kv_select`).

Pipeline stages (pp) cut the layer axis (:func:`stage_layers`): stage s
holds layers ``[s·L/pp, (s+1)·L/pp)`` of every ``[L, …]`` leaf and of the
KV cache, and only stage 0 holds the embedding, the final norm and the
head (:class:`RankCut`).
"""

from __future__ import annotations

import math
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


def kv_cache_spec(n_kv_heads: int, tp: int, dp: int = 1,
                  batch: int | None = None) -> tuple[str | None, ...]:
    """The KV cache's spec ``[layers, batch, kv_heads, max_seq, head_dim]``
    as the JAX package's ``kv_cache_sharding`` gives it: kv heads over tp
    unless tp does not divide them (then replicated there, and each port
    rank keeps the heads its query heads read, :func:`rank_kv_heads`), the
    slot axis over dp unless dp does not divide ``batch``."""
    axes = list(KV_CACHE_AXES)
    if n_kv_heads % tp != 0:
        axes[2] = None
    if batch is not None and batch % dp != 0:
        axes[1] = None
    return logical_to_spec(tuple(axes))


def int8_kv_cache_specs(n_kv_heads: int, tp: int, dp: int = 1, batch: int | None = None,
                        members: int = 1) -> tuple[tuple, tuple]:
    """The specs of an int8 cache side's ``(values, scales)`` as the JAX
    engine shards them: the values as :func:`kv_cache_spec`, the scales the
    same without the head_dim axis; a member-stacked cache (``members`` >
    1, the JAX layout ``[M, L, S, …]``) prepends a replicated member axis.
    Each port rank's cache is its cut of both (its kv heads, its dp
    group's slots), rows of every member flat (``m·S + s``)."""
    values = kv_cache_spec(n_kv_heads, tp, dp, batch)
    lead = (None,) if members > 1 else ()
    return lead + values, lead + values[:4]


def paged_kv_spec(n_kv_heads: int, tp: int) -> tuple[str | None, ...]:
    """The page pool's spec ``[layers, pages, kv_heads, page_size,
    head_dim]`` as the JAX package's ``paged_kv_sharding`` gives it: the
    page axis never cut (a row's chain scatters over the whole pool), kv
    heads over tp with :func:`kv_cache_spec`'s rule, the layer axis over
    pp. A rank of a dp/tp engine holds its cut ``[L, pages, K_rank, page,
    hd]``: every page, the kv heads :func:`rank_kv_index` gives it (its
    query heads' entries, where tp does not divide K too). Neither the pool
    nor the page ids are cut over dp: one host allocator on rank 0 hands
    out every page, and a page is only ever read by the dp group whose row
    wrote it; each rank's page table holds its own dp group's rows."""
    axes: list = ["layers", None, "kv_heads", None, None]
    if n_kv_heads % tp != 0:
        axes[2] = None
    return logical_to_spec(tuple(axes))


def slot_rows(n_slots: int, dp: int, dp_rank: int) -> tuple[int, int]:
    """Slot rows ``[lo, hi)`` that dp rank ``dp_rank``'s cache holds:
    ``n_slots / dp`` contiguous rows, or all of them when dp does not
    divide ``n_slots`` (:func:`kv_cache_spec`'s replicated slot axis:
    every dp group then computes every row)."""
    if dp <= 1 or n_slots % dp:
        return 0, n_slots
    per = n_slots // dp
    return dp_rank * per, (dp_rank + 1) * per


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
    each; every head on every rank where tp does not divide H (the JAX
    package's ``_fit_spec`` replicates a dim the mesh does not divide; the
    port cuts only whole heads)."""
    if n_heads % tp:
        return 0, n_heads
    per = n_heads // tp
    return tp_rank * per, (tp_rank + 1) * per


def kv_cut_evenly(n_heads: int, n_kv_heads: int, tp: int) -> bool:
    """Whether every tp rank's query heads fall in whole kv groups, or
    within one (its heads per rank a multiple or a divisor of the group
    size H/K): its K/V projections and its cache are then cut to the
    contiguous kv heads it reads (:func:`rank_kv_heads`; where tp does not
    divide K, two ranks hold the same head). Otherwise the K/V projections
    are whole on every rank (the JAX package's ``replicate_kv_heads``) and
    each rank selects the kv heads its own query heads read after the
    projection (:func:`kv_select`); in training each rank's gradient of
    them is then partial and summed over tp."""
    lo, hi = rank_heads(n_heads, tp, 0)
    per, g = hi - lo, n_heads // n_kv_heads
    return per % g == 0 or g % per == 0


def rank_kv_index(n_heads: int, n_kv_heads: int, tp: int, tp_rank: int) -> list[int]:
    """The kv heads tp rank ``tp_rank``'s cache holds, in the order its
    query heads read them: its local query head j reads entry ``j // G'``
    (G' its heads per entry), so the attention kernels' GQA-by-index
    grouping holds on every rank. Query head i reads kv head ``i // G``
    (G = H/K). Where the groups cut evenly the entries are the contiguous
    kv heads the rank reads (K/tp of them when tp divides K; two ranks may
    hold the same one); otherwise G' = gcd(heads per rank, G), and a kv
    head may stand in several entries."""
    lo, hi = rank_heads(n_heads, tp, tp_rank)
    g = n_heads // n_kv_heads
    if kv_cut_evenly(n_heads, n_kv_heads, tp):
        return list(range(lo // g, (hi - 1) // g + 1))
    step = math.gcd(hi - lo, g)
    return [(lo + j) // g for j in range(0, hi - lo, step)]


def rank_kv_heads(n_heads: int, n_kv_heads: int, tp: int, tp_rank: int) -> tuple[int, int]:
    """KV heads ``[lo, hi)`` that tp rank ``tp_rank``'s K/V projections
    are cut to: where the groups cut evenly, those its query heads read
    (K/tp of them when tp divides K; else the one or few groups its heads
    fall in, two ranks then holding the same head), every kv head where
    they do not (:func:`kv_cut_evenly`)."""
    if not kv_cut_evenly(n_heads, n_kv_heads, tp):
        return 0, n_kv_heads
    idx = rank_kv_index(n_heads, n_kv_heads, tp, tp_rank)
    return idx[0], idx[-1] + 1


def kv_select(n_heads: int, n_kv_heads: int, tp: int, tp_rank: int) -> list[int] | None:
    """The entries a rank takes from its whole K/V projections' heads
    (:func:`rank_kv_index`), or None where the projections are already cut
    to them."""
    if tp <= 1 or kv_cut_evenly(n_heads, n_kv_heads, tp):
        return None
    return rank_kv_index(n_heads, n_kv_heads, tp, tp_rank)


def kv_sharers(n_heads: int, n_kv_heads: int, tp: int, tp_rank: int) -> list[int]:
    """The tp ranks whose K/V projections are cut to the same kv heads as
    ``tp_rank``'s (itself included, in rank order): more than one where the
    groups cut evenly but tp does not divide K. Training sums those ranks'
    gradients of the shared cut, and the first of them counts it in the
    global norm."""
    if n_heads % tp or not kv_cut_evenly(n_heads, n_kv_heads, tp):
        return [tp_rank]  # whole on every rank: each computes the whole gradient
    mine = rank_kv_heads(n_heads, n_kv_heads, tp, tp_rank)
    return [r for r in range(tp) if rank_kv_heads(n_heads, n_kv_heads, tp, r) == mine]


def rank_experts(n_experts: int, tp: int, tp_rank: int) -> tuple[int, int]:
    """Experts ``[lo, hi)`` of tp rank ``tp_rank``: E/tp whole experts each
    (expert parallelism shares the tp axis, the JAX package's rule), or
    every expert on every rank where tp does not divide E."""
    if n_experts % tp:
        return 0, n_experts
    per = n_experts // tp
    return tp_rank * per, (tp_rank + 1) * per


def stage_layers(n_layers: int, pp: int, pp_rank: int) -> tuple[int, int]:
    """Layers ``[lo, hi)`` of pipeline stage ``pp_rank``: L/pp contiguous
    layers each (the JAX package's ``P(pp)`` over the layer axis)."""
    if n_layers % pp:
        raise ValueError(f"pp={pp} does not divide n_layers={n_layers}: stages hold equal "
                         "contiguous layer shards — pick a dividing pp or pad the model")
    per = n_layers // pp
    return pp_rank * per, (pp_rank + 1) * per


def _cut(x, dim: int, lo: int, hi: int):
    return x.narrow(dim, lo, hi - lo)


class RankCut:
    """``cut(name, x, layer_part=False)``: one rank's view of leaf ``name``
    (:func:`shard_leaf`), or None for a leaf the rank does not hold (a
    later pipeline stage holds no embedding, final norm or head). ``layers``
    is the rank's stage's ``[lo, hi)`` of the layer axis (all layers
    without pp): a ``[L, …]`` leaf is cut to it, a ``layer_part`` slice of
    a layer outside it is the caller's to skip."""

    def __init__(self, spec, tp: int, tp_rank: int, pp: int = 1, pp_rank: int = 0):
        self.spec, self.tp, self.tp_rank = spec, tp, tp_rank
        self.pp_rank = pp_rank
        self.layers = stage_layers(spec.n_layers, pp, pp_rank)
        self.experts = rank_experts(spec.n_experts, tp, tp_rank) if spec.n_experts else (0, 0)

    def keeps(self, name: str) -> bool:
        """Whether the rank holds leaf ``name`` at all."""
        axes = PARAM_LOGICAL_AXES.get(name)
        return self.pp_rank == 0 or (axes is not None and axes[0] == "layers")

    def stage_rows(self, name: str, n: int) -> tuple[int, int] | None:
        """The rows ``[lo, hi)`` of an ``n``-layer leaf ``name`` this rank's
        stage holds, or None where it holds the whole leaf (no pp, or not a
        layer leaf)."""
        axes = PARAM_LOGICAL_AXES.get(name)
        if axes is None or axes[0] != "layers" or self.layers == (0, n):
            return None
        return self.layers

    def __call__(self, name: str, x, layer_part: bool = False, layers_cut: bool = False):
        """``layers_cut``: ``x`` is already the stage's rows of the leaf
        (:meth:`stage_rows`)."""
        if x is None or not self.keeps(name):
            return None
        axes = PARAM_LOGICAL_AXES.get(name)
        if axes is not None and axes[0] == "layers" and not (layer_part or layers_cut):
            lo, hi = self.layers
            if (lo, hi) != (0, x.shape[0]):
                x = _cut(x, 0, lo, hi)
        s = self.spec
        return shard_leaf(name, x, tp=self.tp, tp_rank=self.tp_rank, n_heads=s.n_heads,
                          n_kv_heads=s.n_kv_heads, head_dim=s.head_dim,
                          vocab_size=s.vocab_size, layer_part=layer_part,
                          n_experts=s.n_experts)


def rank_cut(spec, mesh, rank: int) -> RankCut:
    """Rank ``rank``'s :class:`RankCut` of ``spec``'s tree on ``mesh`` (a
    ``Mesh`` or ``RankMesh``): its tp cut and its pipeline stage's
    layers."""
    layout = mesh.mesh if hasattr(mesh, "mesh") else mesh
    c = layout.coords(rank)
    return RankCut(spec, layout.shape[AXIS_TP], c[AXIS_TP], layout.shape[AXIS_PP], c[AXIS_PP])


def shard_leaf(name: str, x, *, tp: int, tp_rank: int, n_heads: int, n_kv_heads: int,
               head_dim: int, vocab_size: int, layer_part: bool = False, n_experts: int = 0):
    """Tp rank ``tp_rank``'s cut of leaf ``name`` (a view), along every dim
    that :func:`logical_to_spec` maps to ``tp``: by whole heads (query
    heads, or the kv heads the rank reads), whole experts, or MLP-hidden
    or vocab blocks. A dim tp does not divide is whole on every rank (the
    JAX package's ``_fit_spec``): query heads when tp does not divide H,
    kv heads when the groups cut unevenly (:func:`kv_cut_evenly`), experts
    when tp does not divide E; the product that would have summed its
    partial outputs then skips its collective (``models/transformer``).
    ``layer_part``: ``x`` is one layer's slice of a ``[L, …]`` leaf."""
    axes = PARAM_LOGICAL_AXES.get(name)
    if axes is None or x is None or tp <= 1:
        return x
    if layer_part and axes[0] == "layers":
        axes = axes[1:]
    for dim, (axis, mesh_axis) in enumerate(zip(axes, logical_to_spec(axes))):
        if mesh_axis != AXIS_TP:
            continue
        if axis == "heads":
            lo, hi = rank_heads(n_heads, tp, tp_rank)
            x = _cut(x, dim, lo * head_dim, hi * head_dim)
        elif axis == "kv_heads":
            lo, hi = rank_kv_heads(n_heads, n_kv_heads, tp, tp_rank)
            x = _cut(x, dim, lo * head_dim, hi * head_dim)
        elif axis == "experts":
            if name == "router":
                continue  # replicated: every rank routes every token alike
            lo, hi = rank_experts(n_experts or x.shape[dim], tp, tp_rank)
            x = _cut(x, dim, lo, hi)
        else:
            n = x.shape[dim]
            if axis == "vocab" and n != vocab_size:
                raise ValueError(f"{name} has {n} vocab rows, the spec {vocab_size}")
            if n % tp == 0:
                per = n // tp
                x = _cut(x, dim, tp_rank * per, (tp_rank + 1) * per)
    return x
