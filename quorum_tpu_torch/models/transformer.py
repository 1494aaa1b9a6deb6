"""Decoder-only transformer forward on torch tensors: the JAX package's
models/transformer.py, dense and Mixtral-style MoE layers.

Layouts match the JAX package at every public function so tests compare
like with like: params are a dict with per-layer weights stacked
``[L, …]`` under ``"blocks"``; q [B, H, T, hd], k/v [B, K, T, hd]; the KV
cache is ``[L, S, K, max_seq, hd]`` per side.

Member-stacked params (``models/init.py`` ``init_params_stacked``: M weight
sets, top-level leaves ``[M, …]``, block leaves ``[L, M, …]``) run through
the same functions — the explicit batched form of the JAX engine's member
vmaps (``_member_call`` / ``_stacked_rows_call``). The batch rows are then
member-major: row ``m·B + b`` is member m's row b (B rows per member), and
the cache rows follow the JAX flat-row convention, ``m·S + s`` = member m's
slot s. Every projection is one batched GEMM ``[M, rows, D] × [M, D, N]``,
norm weights and biases broadcast per member, the embedding gathers
``tok_emb[m, token]``; a stacked step issues as many ops as a single-model
step, and attention runs once per layer over all rows. A leaf's rank tells
stacked from single (``_mm``, ``_per_member``).

The KV cache is updated IN PLACE — the JAX package donates the cache
buffers to its jitted programs instead; functions still return the cache
tensors so call sites read the same.

Attention goes through the hand-written kernels: prefill and the cache-free
forwards (``forward_hidden``, ``forward_logits``: embeddings and prompt
scoring) through K1 (ops/flash_attention.py), decode through K2
(ops/flash_decode.py), or K2q8
(ops/flash_decode_q8.py) over an int8 cache. Each takes its plain version
for CPU tensors. ``prefill_segment`` (chunked
prefill over a cache row's history) runs the plain ``attention`` on every
device, as the JAX package runs XLA's plain attention there.
``plain_attention=True`` calls the plain versions directly on any device —
for holding the kernels against them on the card, and for training
(``training/trainer.py``: the kernels have no backward and refuse inputs
that require grad); the engine never sets it.

Matrix products accumulate in float32 where the JAX code asked for
``preferred_element_type=float32``; in bf16 on the card cuBLAS accumulates
in float32 and rounds the output to bf16. The MoE router is the exception:
its logits decide which experts run, so they are computed in float32 from
the bf16 operands (exact products, f32 sums) and never rounded to bf16.

int8 (the JAX package's ``quant=int8`` and ``kv_quant=int8``): every
weight product goes through ``models/quant.qeinsum``, which takes a plain
leaf or a quantized ``{q8, qs}`` leaf (the router stays plain); embedding
rows of a quantized table are gathered in int8 and multiplied by their
scales in the model dtype. A cache side is either a tensor ``[L, B, K,
max_seq, hd]`` or, with ``kv_quant="int8"``, a tuple ``(q8, scale)`` of
``[L, B, K, max_seq, hd]`` int8 and ``[L, B, K, max_seq]`` float32, value
≈ q8 · scale per token per head (``init_cache``). Every write quantizes
what it writes; prefill attends over the fresh K/V as the JAX package's
does, a segment dequantizes its row's bounded history, and decode reads
the int8 cache natively (K2q8).

On a mesh (``mesh=``, a ``parallel/comm.RankMesh``; params and cache this
rank's shard, ``models/convert.shard_params``), the functions add what
GSPMD adds in the JAX package: the row-parallel output and down
projections' partial sums all-reduced over tp (their biases added once,
after), an MoE layer's experts' partial outputs (each rank runs its E/tp
experts on every token, routed alike on every rank) likewise, the
vocab-cut embedding gathered by an all-reduce and the vocab-cut logits
all-gathered; head counts come from the projections' widths. A leaf tp
does not divide is whole on every rank and its product's sum is skipped
(:func:`_tp_cut`); K/V projections whole over unevenly cut query-head
groups give each rank its own kv heads by selection (:func:`_kv_select`).
A quantized row-parallel product (:func:`_row_mm`) quantizes its input
with the whole row's amax (a max all-reduce over tp) and sums its int32
accumulators over tp before one rescale, so it equals the one-rank product
bit for bit; a rank's int8 cache holds its own kv heads. Member-stacked
params on a mesh are each rank's cut of every weight set, the vocab-cut
tables gathered per member. The layer loops run the layers the blocks hold (:func:`n_layers`): a
pipeline stage's share (``parallel/pipeline.py``). A
decode step takes rank 0's token, positions and write mask by one
broadcast (``RankMesh.sync_step``: rank 0 samples, every rank feeds the
same token; a worker runs :func:`follow_decode_step`), a verify turn
(:func:`decode_multi`) its anchor, drafts, positions and write mask by
another (``RankMesh.sync_multi``; a worker runs
:func:`follow_decode_multi`). With sp > 1,
:func:`prefill` and :func:`forward_logits_sp` run each rank's sequence block
through ring attention or Ulysses (``parallel/``). The collectives are
called whatever the group's size, so a one-rank NCCL mesh's graphs capture
them (a one-rank gloo group skips them, ``parallel/comm``).

On a mesh with dp > 1 whose dp divides the slot rows (the rank's cache then
holds its dp group's block of each weight set's slots, ``RankMesh.hold_slots``:
member m's slot s at local row m·(S/dp) + s − lo), a decode step runs
each group's own rows through the layers and all-gathers the hidden states
over dp before the final norm and the unembed, so every rank — rank 0,
which samples, among them — has every row's logits (a verify turn alike). A single-shot admission
runs on the group that owns its slot, whose last hidden state is then
broadcast over dp; a prefill segment runs on the owning group alone (it
returns nothing). Where dp does not divide the slot rows every group holds
and computes every row, and nothing crosses dp.

Training differentiates through the mesh forward (:func:`forward_logits`
with ``mesh=``): the column-parallel products' inputs enter through
``parallel/comm.tp_enter`` (their gradient summed over tp), so every tp
rank ends with the whole gradient of each replicated leaf and its own
block of each cut one.

MoE layers (``spec.n_experts > 0``) follow the JAX package: a prompt
(T > 1) runs the grouped path (:func:`_moe_mlp_grouped`: fixed-capacity
expert buffers, overflow picks dropped, pad tokens kept out of capacity),
a decode step (T == 1) the dense path (:func:`_moe_mlp_dense`: every
expert on every row, static shapes, so it captures into the decode
graphs). The expert products are batched matmuls, outside any kernel, as
in the JAX package. Member-stacked params carry no MoE leaves (stacked
engines refuse MoE specs). On a tp rank the experts are its E/tp.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from quorum_tpu_torch.cache.paging import (kv_is_paged, page_read, page_read_row, page_write,
                                           window_index, write_slots)
from quorum_tpu_torch.models.model_config import ModelSpec
from quorum_tpu_torch.models.quant import emb_rows, is_quantized, qeinsum, quantize_act
from quorum_tpu_torch.ops.attention import (attention, causal_mask, decode_attention,
                                            decode_attention_q8, prefill_attention, quantize_rows)
from quorum_tpu_torch.ops.flash_attention import flash_prefill_attention
from quorum_tpu_torch.ops.flash_decode import flash_decode_attention
from quorum_tpu_torch.ops.flash_decode_q8 import flash_decode_q8_attention
from quorum_tpu_torch.ops.norms import layernorm, rmsnorm
from quorum_tpu_torch.ops.rotary import apply_rope, rope_cos_sin_for
from quorum_tpu_torch.parallel.comm import tp_enter

Params = dict

_ROPE_TABLES: dict = {}
_CONSTS: dict = {}


def _made(tensors, device):
    """A cached tensor made on a card is read on other streams (one per
    engine) and inside graph captures: wait here until its kernels ran."""
    if torch.device(device).type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    return tensors


def _rope(spec: ModelSpec, device) -> tuple[torch.Tensor, torch.Tensor]:
    key = (spec, str(device))
    tabs = _ROPE_TABLES.get(key)
    if tabs is None:
        tabs = _ROPE_TABLES[key] = _made(rope_cos_sin_for(spec, device), device)
    return tabs


def _const(value: float, dtype: torch.dtype, device) -> torch.Tensor:
    """A scalar of ``dtype`` on ``device``, made once: a fresh
    ``torch.tensor`` would be a host-to-device copy, which a graph capture
    refuses."""
    key = (value, dtype, str(device))
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = _made(torch.tensor(value, dtype=dtype, device=device), device)
    return t


def _dtype(spec: ModelSpec) -> torch.dtype:
    return getattr(torch, spec.dtype)


def _sub(v, idx):
    """``v[idx]`` of a plain or quantized leaf (both of its tensors); None
    stays None."""
    if v is None:
        return None
    if is_quantized(v):
        return {k: t[idx] for k, t in v.items()}
    return v[idx]


def _w(leaf) -> torch.Tensor:
    """A weight's tensor (a quantized leaf's ``q8``), for its leading axes:
    three of them in a member-stacked weight."""
    return leaf["q8"] if is_quantized(leaf) else leaf


def _layer(blocks: Params, l: int) -> Params:
    return {k: _sub(v, l) for k, v in blocks.items()}


def n_layers(blocks: Params) -> int:
    """The layers a ``blocks`` tree holds: the spec's, or a pipeline
    stage's share of them."""
    return blocks["attn_norm_w"].shape[0]


def member_params(params: Params, m: int) -> Params:
    """Member ``m``'s single-model view of a member-stacked tree: views,
    never copies (each layer's slab ``blocks[k][l, m]`` is contiguous)."""
    out = {k: _sub(v, m) for k, v in params.items() if k != "blocks"}
    out["blocks"] = {k: _sub(v, (slice(None), m)) for k, v in params["blocks"].items()}
    return out


_MEMBER_ROWS: dict = {}


def _member_rows(n_members: int, n_rows: int, device) -> torch.Tensor:
    """[n_rows] member index of each member-major batch row (cached)."""
    key = (n_members, n_rows, str(device))
    idx = _MEMBER_ROWS.get(key)
    if idx is None:
        idx = _MEMBER_ROWS[key] = _made(
            torch.arange(n_rows, device=device) // (n_rows // n_members), device)
    return idx


def _mm(x: torch.Tensor, w, xq=None, tp=None) -> torch.Tensor:
    """x @ w read back as float32 (the JAX einsums' f32 output), through
    ``qeinsum``: w plain or quantized, ``xq`` x already quantized, ``tp`` a
    quantized row-parallel product's group (:func:`_row_mm`). A
    member-stacked w [M, D, N] takes x's member-major rows as M groups: one
    batched GEMM [M, rows, D] × [M, D, N] (one int8 GEMM per member)."""
    if _w(w).dim() == 3:
        m = _w(w).shape[0]
        if xq is not None:
            xq = tuple(t.reshape(m, -1, t.shape[-1]) for t in xq)
        out = qeinsum("mnd,mdf->mnf", x.reshape(m, -1, x.shape[-1]), w, xq, tp)
        return out.reshape(*x.shape[:-1], out.shape[-1])
    return qeinsum("...d,df->...f", x, w, xq, tp)


def _per_member(x: torch.Tensor, v: torch.Tensor, op):
    """``op(x, v)`` for a vector over x's last axis; a member-stacked v
    [M, N] applies to x's member-major row groups."""
    if v.dim() == 1:
        return op(x, v)
    return op(x.reshape(v.shape[0], -1, x.shape[-1]), v[:, None]).reshape(x.shape)


def _add(x, v):
    return _per_member(x, v, torch.add)


def _norm(x, w, b, spec: ModelSpec):
    if spec.norm == "rmsnorm":
        # gemma stores norm weights as w with the model applying (1 + w).
        if spec.norm_offset:
            w = w + _const(spec.norm_offset, w.dtype, w.device)
        return _per_member(x, w, lambda xs, ws: rmsnorm(xs, ws, spec.norm_eps))
    y = _per_member(x, w, lambda xs, ws: layernorm(xs, ws, None, spec.norm_eps))
    return y if b is None else _add(y, b)


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _row_mm(x: torch.Tensor, w, mesh) -> torch.Tensor:
    """A row-parallel product (the output and down projections: x's last
    axis and w's contraction axis this rank's piece of an axis tp cuts),
    summed over tp. A plain leaf's f32 partial products are all-reduced
    (:func:`_tp_sum`); a quantized one quantizes x with the whole row's
    amax and sums the int32 accumulators before one rescale
    (``models/quant.qeinsum`` with ``tp``): the one-rank product bit for
    bit."""
    if mesh is None or not is_quantized(w):
        return _tp_sum(_mm(x, w), mesh)
    return _mm(x, w, tp=mesh.tp)


def _tp_sum(out: torch.Tensor, mesh) -> torch.Tensor:
    """A row-parallel product's partial sums over the tp ranks (f32, in
    place): the all-reduce GSPMD puts after the JAX package's down and
    output projections. Called on every mesh, whatever tp is, so a
    one-rank group's decode graphs capture it too; a caller whose leaf is
    whole on every rank (:func:`_tp_cut`) passes no mesh."""
    return out if mesh is None else mesh.tp.all_reduce(out)


def _in_width(w) -> int:
    """A weight's contraction width (a quantized leaf keeps it last)."""
    return w["q8"].shape[-1] if is_quantized(w) else w.shape[-2]


def _tp_cut(mesh, width: int, whole: int):
    """``mesh`` where this rank's share of a tp-cut product is a part
    (``width`` < ``whole``, or one rank), else None: a leaf tp does not
    divide is whole on every rank (``parallel/sharding``), its output is
    already the sum, and neither its collective nor its input's gradient
    sum (``tp_enter``) may run."""
    if mesh is None or (width == whole and mesh.tp_size > 1):
        return None
    return mesh


def _dense_mlp(x, block, spec: ModelSpec, mesh=None):
    if spec.gated_mlp:
        xq = quantize_act(x, block["w_gate"], block["w_up"])
        gate = _mm(x, block["w_gate"], xq)
        up = _mm(x, block["w_up"], xq)
        # swiglu (llama/mistral) gates with SiLU; geglu (gemma) with tanh GELU.
        gated = F.silu(gate) if spec.act == "swiglu" else _gelu(gate)
        h = (gated * up).to(x.dtype)
    else:
        up = _mm(x, block["w_up"])
        if block.get("b_up") is not None:
            up = _add(up, block["b_up"])
        h = _gelu(up).to(x.dtype)
    out = _row_mm(h, block["w_down"], mesh)
    if block.get("b_down") is not None:  # once, after the reduction
        out = _add(out, block["b_down"])
    return out.to(x.dtype)


def _moe_router(x, block, spec: ModelSpec):
    """Top-k routing (Mixtral: softmax over the k selected logits). Returns
    (top_probs [B, T, k] f32, top_idx [B, T, k] int64).

    Logits are f32 (JAX: ``preferred_element_type=float32``). Ties pick
    the lower expert index first, as ``lax.top_k`` does: a stable
    descending sort keeps equal logits in index order (``torch.topk``
    leaves their order unspecified)."""
    logits = torch.matmul(x.float(), block["router"].float())
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    k = spec.experts_per_token
    return torch.softmax(vals[..., :k], dim=-1), idx[..., :k]


def _expert_ffn(xe, block, dtype):
    """SwiGLU experts as batched products: xe [E, N, D] (one buffer per
    expert) or [N, D] (every expert on every row) against the stacked
    [E, D, F] / [E, F, D] weights → [E, N, D] f32. Gate and up share one
    quantization of xe."""
    form = "mnd,mdf->mnf" if xe.dim() == 3 else "nd,edf->enf"
    xq = quantize_act(xe, block["moe_w_gate"], block["moe_w_up"])
    gate = qeinsum(form, xe, block["moe_w_gate"], xq)
    up = qeinsum(form, xe, block["moe_w_up"], xq)
    h = (F.silu(gate) * up).to(dtype)
    return qeinsum("mnd,mdf->mnf", h, block["moe_w_down"])


def _expert_range(block, spec: ModelSpec, mesh) -> tuple[int, int]:
    """The experts ``[lo, hi)`` this rank's expert leaves hold: E/tp on a
    tp rank (``parallel/sharding.rank_experts``), else all of them."""
    n = _w(block["moe_w_down"]).shape[0]
    if mesh is None or n == spec.n_experts:
        return 0, spec.n_experts
    return mesh.tp_rank * n, (mesh.tp_rank + 1) * n


def _moe_mlp_dense(x, block, spec: ModelSpec, mesh=None):
    """Top-k MoE computed densely: every expert runs on every token and the
    combine weight (zero outside the top-k) reproduces sparse routing. The
    decode path and the oracle: at T == 1 every expert's weights are read
    anyway. Static shapes, no host read: it runs inside decode graphs. On
    a tp rank holding experts ``[lo, hi)`` those run, and the partial
    outputs are summed over tp in f32 before the cast."""
    b, t, d = x.shape
    lo, hi = _expert_range(block, spec, mesh)
    top_probs, top_idx = _moe_router(x, block, spec)
    experts = torch.arange(lo, hi, device=x.device)
    one_hot = (top_idx[..., None] == experts).to(top_probs.dtype)
    combine = torch.einsum("btk,btke->bte", top_probs, one_hot).reshape(b * t, -1)
    expert_out = _expert_ffn(x.reshape(b * t, d), block, x.dtype)      # [E, N, D]
    out = torch.einsum("ne,end->nd", combine, expert_out)
    if hi - lo < spec.n_experts:
        out = _tp_sum(out, mesh)
    return out.reshape(b, t, d).to(x.dtype)


# Expert-buffer rows (E × capacity) whose products one grouped MoE launch
# runs; more run in slices of the capacity axis. At mixtral-8x7b widths a
# slice's float32 gate and up products are 16 384 × 14 336 × 4 B = 0.94 GB
# each.
MOE_SLOT_ROWS = 16384


def moe_capacity(spec: ModelSpec, n: int) -> int:
    """Rows of each expert's buffer for ``n`` tokens: the JAX package's
    ``min(n, ceil(int(cf·k·n) / E))`` (``int`` truncates first)."""
    e, k = spec.n_experts, spec.experts_per_token
    return min(n, max(1, -(-int(spec.moe_capacity_factor * k * n) // e)))


def _moe_mlp_grouped(x, block, spec: ModelSpec, token_mask=None, mesh=None):
    """Sparse top-k MoE with static per-expert capacity (GShard style), the
    JAX package's ``_moe_mlp_grouped`` step for step.

    Picks are ranked within their expert in token-major, k-minor order (a
    cumsum over the picks); a pick whose rank reaches the capacity drops
    (it contributes nothing). ``token_mask`` [B, T] (False = right
    padding) routes a pad token's picks to expert index E, so they take no
    capacity. Each expert runs its buffer ``[C, D]`` in one batched
    product; unfilled buffer rows gather a clamped row and are zeroed. No
    host read: the dispatch is a scatter into a flat buffer whose last
    entry takes every pick that does not land. On a tp rank holding experts
    ``[lo, hi)`` the routing, capacities and drops are the whole layer's
    (every rank routes every token alike); only its experts' buffers run,
    and the partial outputs are summed over tp in f32 before the cast.

    Buffers of more than ``MOE_SLOT_ROWS`` rows in all (E × C: a long
    cache-free forward) run in slices of the capacity axis, each slice's
    outputs copied straight to its picks, so no ``[E, C, F]`` product is
    held whole. The routing, the drops and every product are those of the
    whole buffer: a buffer row's output depends on that row alone."""
    b, t, d = x.shape
    n = b * t
    e, k = spec.n_experts, spec.experts_per_token
    cap = moe_capacity(spec, n)
    p = n * k
    dev = x.device
    e_lo, e_hi = _expert_range(block, spec, mesh)

    top_probs, top_idx = _moe_router(x, block, spec)
    xf = x.reshape(n, d)
    e_p = top_idx.reshape(p)
    prob_p = top_probs.reshape(p)
    if token_mask is not None:
        pick_valid = token_mask.reshape(n).repeat_interleave(k)
        e_p = torch.where(pick_valid, e_p, torch.full_like(e_p, e))
        prob_p = prob_p * pick_valid.to(prob_p.dtype)
    one_hot = (e_p[:, None] == torch.arange(e, device=dev)).to(torch.int32)  # [P, E]; E → 0s
    ranks = torch.cumsum(one_hot, dim=0) - 1
    c_p = ranks.gather(1, e_p.clamp(max=e - 1)[:, None])[:, 0]
    lands = (e_p < e) & (c_p < cap)
    flat = torch.where(lands, e_p * cap + c_p, torch.full_like(e_p, e * cap))
    pick_buf = torch.full((e * cap + 1,), p, dtype=torch.long, device=dev)
    pick_buf.scatter_(0, flat, torch.arange(p, device=dev))
    pick_buf = pick_buf[:e * cap].reshape(e, cap)[e_lo:e_hi]
    mine = (e_p >= e_lo) & (e_p < e_hi)
    weight_p = prob_p * ((c_p < cap) & mine).to(prob_p.dtype)

    def expert_rows(picks):
        """The FFN of buffer rows holding ``picks`` [E, s] (p: empty)."""
        tok = torch.where(picks < p, picks // k, torch.full_like(picks, n))
        expert_in = xf[tok.clamp(max=n - 1)] * (tok < n).to(xf.dtype)[..., None]
        return _expert_ffn(expert_in, block, x.dtype)                   # [E, s, D]

    e_own = e_hi - e_lo
    if e_own * cap <= MOE_SLOT_ROWS:
        expert_out = expert_rows(pick_buf)
        out_p = expert_out[(e_p - e_lo).clamp(0, e_own - 1), c_p.clamp(max=cap - 1)]
        out_p = out_p * weight_p[:, None]
    else:
        # Row p takes the empty slots' outputs and is dropped.
        out_p = torch.zeros((p + 1, d), dtype=torch.float32, device=dev)
        step = max(1, MOE_SLOT_ROWS // e_own)
        for c0 in range(0, cap, step):
            picks = pick_buf[:, c0:c0 + step]
            y = expert_rows(picks) * weight_p[picks.clamp(max=p - 1)][..., None]
            out_p.index_copy_(0, picks.reshape(-1), y.reshape(-1, d))
        out_p = out_p[:p]
    out = out_p.reshape(n, k, d).sum(dim=1)
    if e_own < e:
        out = _tp_sum(out, mesh)
    return out.reshape(b, t, d).to(x.dtype)


def _moe_mlp(x, block, spec: ModelSpec, token_mask=None, mesh=None):
    # T == 1 is decode: dense reads every expert either way and keeps
    # generation exact against the oracle.
    if x.shape[1] == 1:
        return _moe_mlp_dense(x, block, spec, mesh)
    return _moe_mlp_grouped(x, block, spec, token_mask=token_mask, mesh=mesh)


def _mlp(x, block, spec: ModelSpec, token_mask=None, dense_moe: bool = False, mesh=None):
    if spec.is_moe:
        if dense_moe:
            return _moe_mlp_dense(x, block, spec, mesh)
        return _moe_mlp(x, block, spec, token_mask=token_mask, mesh=mesh)
    return _dense_mlp(x, block, spec, mesh)


def _mlp_mesh(block, spec: ModelSpec, mesh):
    """The mesh the MLP's tp collectives run on (None where its leaves are
    whole on every rank, :func:`_tp_cut`)."""
    if spec.is_moe:
        return _tp_cut(mesh, _w(block["moe_w_down"]).shape[0], spec.n_experts)
    return _tp_cut(mesh, _in_width(block["w_down"]), spec.d_ff)


_KV_SELECT: dict = {}


def _kv_select(spec: ModelSpec, mesh, device):
    """The kv-head entries this tp rank takes from whole K/V projections
    (``parallel/sharding.kv_select``: query-head groups that tp cuts
    unevenly), as a cached index tensor; None where its projections are
    already cut to its heads."""
    if mesh is None or mesh.tp_size == 1:
        return None
    from quorum_tpu_torch.parallel.sharding import kv_select

    sel = kv_select(spec.n_heads, spec.n_kv_heads, mesh.tp_size, mesh.tp_rank)
    if sel is None:
        return None
    key = (tuple(sel), str(device))
    idx = _KV_SELECT.get(key)
    if idx is None:
        idx = _KV_SELECT[key] = _made(torch.tensor(sel, device=device), device)
    return idx


class _SharedGrad(torch.autograd.Function):
    """A kv cut several tp ranks hold (``parallel/sharding.kv_sharers``):
    the identity forward; backward, the gradients of every rank holding
    the same heads summed (each has only its own query heads' part)."""

    @staticmethod
    def forward(ctx, w, group, sharers):
        ctx.group, ctx.sharers = group, sharers
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        every = ctx.group.all_gather(g.contiguous()[None], dim=0)
        return every[list(ctx.sharers)].sum(dim=0), None, None


def _kv_weights(block, spec: ModelSpec, mesh, selecting: bool):
    """The K/V projections (and biases) as this rank's products take them:
    where the rank's gradient of them is partial — whole projections it
    selects from, or a cut other ranks hold too — they enter so that the
    gradient is summed over the ranks holding them (``tp_enter`` over tp,
    or :class:`_SharedGrad` over the sharers). Themselves otherwise, and
    whenever nothing is differentiated."""
    names = ("wk", "wv", "bk", "bv")
    leaves = [block.get(n) for n in names]
    w = leaves[0]
    if mesh is None or mesh.tp_size == 1 or not (
            isinstance(w, torch.Tensor) and w.requires_grad and torch.is_grad_enabled()):
        return leaves
    if selecting:
        return [None if t is None else tp_enter(t, mesh) for t in leaves]
    from quorum_tpu_torch.parallel.sharding import kv_sharers

    sharers = kv_sharers(spec.n_heads, spec.n_kv_heads, mesh.tp_size, mesh.tp_rank)
    if len(sharers) == 1:
        return leaves
    return [None if t is None else _SharedGrad.apply(t, mesh.tp, tuple(sharers))
            for t in leaves]


def _qkv(x, block, spec: ModelSpec, mesh=None):
    """Project to contiguous q [B,H,T,hd], k/v [B,K,T,hd]; H and K are the
    projections' widths over head_dim (a tp rank's share of the heads). A
    tp rank whose K/V projections are whole takes its cache's kv heads
    from them (:func:`_kv_select`). In training a K/V weight whose rank
    gradient is partial has it summed over the ranks holding it
    (:func:`_kv_weights`)."""
    b, t, _ = x.shape
    sel = _kv_select(spec, mesh, x.device)
    wk, wv, bk, bv = _kv_weights(block, spec, mesh, sel is not None)
    xq = quantize_act(x, block["wq"], wk, wv)
    q, k, v = _mm(x, block["wq"], xq), _mm(x, wk, xq), _mm(x, wv, xq)
    if block.get("bq") is not None:
        q, k, v = _add(q, block["bq"]), _add(k, bk), _add(v, bv)

    def heads(y, n):
        return y.to(x.dtype).reshape(b, t, n, spec.head_dim).transpose(1, 2).contiguous()

    hd = spec.head_dim
    q, k, v = heads(q, q.shape[-1] // hd), heads(k, k.shape[-1] // hd), heads(v, v.shape[-1] // hd)
    if sel is not None:
        k, v = k.index_select(1, sel), v.index_select(1, sel)
    return q, k, v


def _attn_out(attn, block, x_dtype, mesh=None):
    b, h, t, d = attn.shape
    out = _row_mm(attn.transpose(1, 2).reshape(b, t, h * d), block["wo"], mesh)
    if block.get("bo") is not None:  # once, after the reduction
        out = _add(out, block["bo"])
    return out.to(x_dtype)


def _scale_emb(x, spec: ModelSpec):
    if spec.emb_scale != 1.0:  # gemma scales embeddings by sqrt(d_model)
        x = x * _const(spec.emb_scale, x.dtype, x.device)
    return x


def _emb_lookup(emb, tokens, spec: ModelSpec, mesh, members=None):
    """Embedding rows of ``tokens`` (``members``: each token's member index
    into a member-stacked table); a vocab-cut table (a tp rank's block of
    rows, fewer than the vocabulary) gives its own tokens' rows and zeros
    for the rest, summed over the tp ranks (exact: one nonzero term)."""
    rows = (emb["qs"] if is_quantized(emb) else emb).shape[-2]  # q8's rows are padded

    def at(t):
        return t if members is None else (members, t)

    if mesh is None or rows == spec.vocab_size:
        return emb_rows(emb, at(tokens), _dtype(spec))
    local = tokens - mesh.tp_rank * rows
    inside = (local >= 0) & (local < rows)
    x = emb_rows(emb, at(local.clamp(0, rows - 1)), _dtype(spec))
    return mesh.tp.all_reduce(torch.where(inside[..., None], x, torch.zeros_like(x)))


def _embed(params, spec: ModelSpec, tokens, positions, mesh=None):
    """tokens [B, T] → [B, T, D] at ``positions`` ([T] shared, or [B, T]
    per row); with member-stacked tables row b reads its member's table
    (``tok_emb[m, token]``); on a mesh the table may be a tp rank's vocab
    block (:func:`_emb_lookup`)."""
    emb, pos_emb = params["tok_emb"], params.get("pos_emb")
    per_row = positions if positions.dim() == 2 else positions[None, :]
    if _w(emb).dim() == 3:
        mi = _member_rows(_w(emb).shape[0], tokens.shape[0], tokens.device)[:, None]
        x = _emb_lookup(emb, tokens, spec, mesh, mi)
        pos = pos_emb[mi, per_row] if spec.pos == "learned" else None
    else:
        x = _emb_lookup(emb, tokens, spec, mesh)
        pos = pos_emb[per_row] if spec.pos == "learned" else None
    x = _scale_emb(x, spec)
    return x if pos is None else x + pos.to(x.dtype)


def unembed(params, spec: ModelSpec, x, mesh=None):
    """Hidden states [..., D] → logits [..., V] f32 (the lm head, or the
    tied embedding table). A tp rank's vocab-cut head gives its block of
    the logits, all-gathered over the tp ranks into the whole vocabulary
    (gemma's tied head reads the same cut table)."""
    w = params.get("lm_head")
    if mesh is not None and x.requires_grad and torch.is_grad_enabled():
        n = w.shape[-1] if w is not None else params["tok_emb"].shape[0]
        if n != spec.vocab_size:  # a vocab-cut head: its input's gradient is partial
            x = tp_enter(x, mesh)
    if w is not None:
        logits = _mm(x, w)
    else:
        # tied head: contract against the embedding table's rows directly; a
        # quantized table is stored [.., V, D] like every quantized leaf, its
        # per-row scales the per-vocab output scales.
        emb = params["tok_emb"]
        logits = _mm(x, emb if is_quantized(emb) else emb.transpose(-1, -2))
    if mesh is not None and logits.shape[-1] != spec.vocab_size:
        logits = mesh.tp.all_gather(logits, dim=-1)
    return logits


def _final_norm(params, spec: ModelSpec, x):
    return _norm(x, params["final_norm_w"], params.get("final_norm_b"), spec)


def _block(x, block, spec, q_k_v_to_attn, token_mask=None, dense_moe: bool = False,
           mesh=None):
    """One transformer block around an attention callable; ``token_mask``
    [B, T] keeps right-padding out of MoE expert capacity; ``dense_moe``
    runs MoE layers densely whatever T is. On a mesh (a tp rank's shard)
    the output and down projections' partial sums (the experts' on an MoE
    layer) are all-reduced over the tp ranks, except where the leaves are
    whole on every rank (:func:`_tp_cut`); norms, RoPE and the residual
    stay replicated."""
    attn_mesh = _tp_cut(mesh, _in_width(block["wo"]), spec.n_heads * spec.head_dim)
    h = tp_enter(_norm(x, block["attn_norm_w"], block.get("attn_norm_b"), spec), attn_mesh)
    q, k, v = _qkv(h, block, spec, mesh)
    attn, k, v = q_k_v_to_attn(q, k, v)
    x = x + _attn_out(attn, block, x.dtype, attn_mesh)
    mlp_mesh = _mlp_mesh(block, spec, mesh)
    h2 = tp_enter(_norm(x, block["mlp_norm_w"], block.get("mlp_norm_b"), spec), mlp_mesh)
    return x + _mlp(h2, block, spec, token_mask=token_mask, dense_moe=dense_moe, mesh=mlp_mesh)


def kv_is_q8(cache) -> bool:
    """True when a cache side is the int8 ``(q8, scale)`` pair, dense or a
    paged pool's."""
    if kv_is_paged(cache):
        return cache.is_q8
    return isinstance(cache, tuple)


def _kv_quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., T, hd] → (int8 [..., T, hd], f32 scale [..., T]): per token per
    head, the JAX package's ``_kv_quantize``."""
    q8, s = quantize_rows(x, axis=-1)
    return q8, s[..., 0]


def _kv_dequant(q8: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q8.float() * scale[..., None]).to(dtype)


def _kv_layer(cache, l: int):
    """Layer ``l`` of a cache side: a tensor, the ``(q8, scale)`` pair, or a
    paged side's layer view."""
    if kv_is_paged(cache):
        return cache.layer(l)
    return (cache[0][l], cache[1][l]) if kv_is_q8(cache) else cache[l]


def _kv_put(side, index, value: torch.Tensor, heads_last: bool = False) -> None:
    """``side[index] = value`` in place for one layer's cache side, value
    ``[..., K, T, hd]`` (``heads_last``: the indexed region is ``[..., T, K,
    hd]``, as a segment's advanced index lays it out). An int8 side stores
    the quantized value and its scales."""
    if not kv_is_q8(side):
        side[index] = (value.transpose(-3, -2) if heads_last else value).to(side.dtype)
        return
    q8, s = _kv_quantize(value)
    if heads_last:
        q8, s = q8.transpose(-3, -2), s.transpose(-2, -1)
    side[0][index] = q8
    side[1][index] = s


def prefill(
    params: Params,
    spec: ModelSpec,
    tokens: torch.Tensor,   # [B, T] right-padded
    lengths: torch.Tensor,  # [B] int32 true prompt lengths
    cache_k: torch.Tensor,  # [L, B, K, max_seq, hd]; [L, S, K, max_seq, hd] with slot/rows
    cache_v: torch.Tensor,
    slot: int | None = None,
    plain_attention: bool = False,
    rows: list[int | None] | None = None,
    mesh=None,
    sp_impl: str = "ring",
):
    """Process the full prompt; returns (last-token logits [B, V] f32,
    cache_k, cache_v). K/V of every prompt position is written into the
    cache in place — at cache row ``slot`` (batch-1 tokens) for the
    continuous-batching admission path, at ``rows[b]`` for batch row b when
    ``rows`` is given (an entry of ``None`` writes nothing: the JAX
    ``write_gate``, so a member-coalesced admission never touches absent
    members' rows), else at rows ``[0, B)``. With member-stacked params,
    batch row m is member m's prompt (one per member) and attention runs as
    one K1 launch per layer over the M rows, each at its own length.

    ``mesh`` (a ``parallel/comm.RankMesh``; params and cache this rank's
    shard) adds the tp collectives and, with sp > 1, the JAX package's
    sequence-parallel admission: each sp rank runs its block of T/sp
    positions (when sp divides T; else every rank runs the whole prompt)
    and attention is ring attention or, ``sp_impl="ulysses"``, Ulysses
    (``parallel/``). The K/V written to the cache is the whole prompt's,
    on every sp rank (all-gathered over sp), as the JAX package keeps the
    cache's position axis replicated: decode does not depend on sp. A
    windowed spec refuses the ring, in JAX's words. Where the mesh's dp
    cuts the slot rows, ``slot`` is the global slot: the dp group owning it
    prefills, and the last hidden state is broadcast over dp from there
    before the unembed (a non-owning group computes nothing else)."""
    b, t = tokens.shape
    dev = tokens.device
    owner = None
    if mesh is not None and mesh.splits_slots and (slot is not None or rows is not None):
        # Every row of one admission is one slot's (a stacked engine's
        # member rows m·S + s): the dp group holding slot s runs it.
        owner = _slot_owner(mesh, slot if rows is None else next(r for r in rows if r is not None))
        if owner != mesh.dp_rank:
            last = mesh.dp.broadcast(
                torch.zeros((b, spec.d_model), dtype=_dtype(spec), device=dev), owner)
            return unembed(params, spec, last, mesh), cache_k, cache_v
        if rows is None:
            slot = _local_row(mesh, slot)
        else:
            rows = [None if r is None else _local_row(mesh, r) for r in rows]
    n_sp = _sp_blocks(mesh, t, spec, sp_impl)
    lo, s_loc = (mesh.sp_rank * (t // n_sp), t // n_sp) if n_sp > 1 else (0, t)
    positions = torch.arange(lo, lo + s_loc, device=dev)
    x = _embed(params, spec, tokens[:, lo:lo + s_loc], positions, mesh)
    cos, sin = _rope(spec, dev)
    src = slice(None)
    if rows is None:
        dst = slice(slot, slot + 1) if slot is not None else slice(0, b)
    else:
        keep = [i for i, r in enumerate(rows) if r is not None]
        dst = host_to_device([rows[i] for i in keep], torch.long, dev)
        if len(keep) < b:
            src = host_to_device(keep, torch.long, dev)
    if kv_is_paged(cache_k):
        # The page slots of the rows' positions 0..T, for every layer and side.
        prow = (dst if isinstance(dst, torch.Tensor)
                else torch.arange(dst.start, dst.stop, device=dev))
        wslots = write_slots(cache_k.layer(0), prow, positions[None, :].expand(prow.shape[0], t))
    attn_fn = prefill_attention if plain_attention else flash_prefill_attention
    blocks = params["blocks"]
    moe_mask = (torch.arange(t, device=dev)[None, :] < lengths[:, None]) if spec.is_moe else None

    for l in range(n_layers(blocks)):
        def attend(q, k, v, l=l):
            if spec.pos == "rope":
                q = apply_rope(q, cos, sin, positions)
                k = apply_rope(k, cos, sin, positions)
            kw, vw = k, v
            if n_sp > 1:  # every sp rank writes the whole prompt's K/V
                kw, vw = mesh.sp.all_gather(k, dim=2), mesh.sp.all_gather(v, dim=2)
            # in place (JAX: donated buffer); an int8 cache stores k, v quantized
            if kv_is_paged(cache_k):
                page_write(_kv_layer(cache_k, l), kw[src], slots=wslots)
                page_write(_kv_layer(cache_v, l), vw[src], slots=wslots)
            else:
                _kv_put(_kv_layer(cache_k, l), (dst, slice(None), slice(None, t)), kw[src])
                _kv_put(_kv_layer(cache_v, l), (dst, slice(None), slice(None, t)), vw[src])
            if n_sp > 1:
                return _sp_attention(q, k, v, lengths, mesh, spec, sp_impl), k, v
            return attn_fn(q, k, v, lengths, window=spec.sliding_window), k, v

        x = _block(x, _layer(blocks, l), spec, attend, token_mask=moe_mask, mesh=mesh)
    x = _final_norm(params, spec, x)
    # Only the last real token's logits matter for generation; gather per row.
    last = _last_rows(x, lengths, lo, mesh if n_sp > 1 else None)
    if owner is not None:
        last = mesh.dp.broadcast(last.contiguous(), owner)
    return unembed(params, spec, last, mesh), cache_k, cache_v


def _slot_owner(mesh, row: int) -> int:
    """The dp rank whose cache holds flat cache row ``row`` (member m's slot
    s is row m·S + s; each dp group holds a block of the S slots for every
    member, ``RankMesh.hold_slots``)."""
    lo, hi, n = mesh.slots
    return (row % n) // (hi - lo)


def _local_row(mesh, row: int) -> int:
    """Flat cache row ``row`` in this dp group's cache: member m's slot s at
    ``m·(hi − lo) + s − lo``."""
    lo, hi, n = mesh.slots
    return (row // n) * (hi - lo) + row % n - lo


def _sp_blocks(mesh, t: int, spec: ModelSpec, sp_impl: str) -> int:
    """The sequence blocks a prompt of ``t`` positions runs in: the mesh's
    sp when it divides ``t``, else 1 (a short admission bucket runs whole
    on every rank, as the JAX ring falls back to the dense path). Checks
    ``sp_impl`` and the ring's refusal of windowed specs (the JAX
    package's words)."""
    if mesh is None or mesh.sp_size == 1:
        return 1
    if sp_impl not in ("ring", "ulysses"):
        raise ValueError(f"unknown sp_impl {sp_impl!r} (ring or ulysses)")
    if spec.sliding_window > 0 and sp_impl == "ring":
        raise ValueError(
            "sliding_window specs cannot use ring-attention admission "
            "(sp>1): the ring computes full causal attention and would "
            "silently widen the receptive field (use sp_impl=ulysses — "
            "each device sees the full sequence, windows apply unchanged)")
    return mesh.sp_size if t % mesh.sp_size == 0 else 1


def _sp_attention(q, k, v, lengths, mesh, spec: ModelSpec, sp_impl: str,
                  plain_attention: bool = False):
    """This sp rank's block of sequence-parallel attention (Ulysses' local
    attention K1, or with ``plain_attention`` its plain version; the ring's
    hops are plain block attention either way)."""
    from quorum_tpu_torch.parallel.ring_attention import ring_prefill_attention
    from quorum_tpu_torch.parallel.ulysses import ulysses_prefill_attention

    if sp_impl == "ulysses":
        return ulysses_prefill_attention(q, k, v, lengths, mesh, window=spec.sliding_window,
                                         plain=plain_attention)
    return ring_prefill_attention(q, k, v, lengths, mesh)


def _last_rows(x, lengths, lo: int, sp_mesh=None):
    """Each row's hidden state at its last prompt position ``lengths − 1``;
    with ``sp_mesh`` x is this rank's block from position ``lo``, and the
    rank holding the position gives it (a sum over sp with zeros from the
    others: exact)."""
    b, s = x.shape[0], x.shape[1]
    idx = lengths.to(x.device).long() - 1 - lo
    rows = torch.arange(b, device=x.device)
    if sp_mesh is None:
        return x[rows, idx]
    inside = (idx >= 0) & (idx < s)
    last = x[rows, idx.clamp(0, s - 1)]
    return sp_mesh.sp.all_reduce(torch.where(inside[:, None], last, torch.zeros_like(last)))


def host_to_device(values, dtype: torch.dtype, device,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """A host list as a tensor on ``device`` without a stream sync: on the
    card it goes through pinned memory with a non-blocking copy (a pageable
    copy would wait for every chunk the scheduler has in flight). With
    ``out``, the values land in that tensor instead of a new one."""
    device = torch.device(device)
    host = torch.tensor(values, dtype=dtype, pin_memory=device.type == "cuda")
    if out is not None:
        return out.copy_(host, non_blocking=True)
    return host.to(device, non_blocking=True)


def prefill_segment(
    params: Params,
    spec: ModelSpec,
    tokens: torch.Tensor,         # [B, T] one segment per row, right-padded
    offsets: list[int],           # [B] absolute position of tokens[b, 0]
    cache_k: torch.Tensor,        # [L, S, K, max_seq, hd] slot-batched cache
    cache_v: torch.Tensor,
    rows: list[int | None],       # [B] cache row of batch row b; None writes nothing
    history: int,                 # attend over cache[:history] of the row
    n_valid: list[int] | None = None,  # [B] real tokens per row (MoE capacity)
    mesh=None,
):
    """Chunked prefill: positions ``[offsets[b], offsets[b] + T)`` of cache
    row ``rows[b]``. Each segment's K/V is written into the row in place,
    then its queries attend over the row's history ``[0, history)`` — the
    K/V earlier segments (or a reused prefix) left there plus its own —
    with a causal mask on absolute positions (and the sliding window).
    Returns ``(cache_k, cache_v)`` only: the engine samples the first token
    with a decode step on the last prompt token, which recomputes that
    position's logits against the finished row.

    Call forms, as the JAX engine's segment programs: one model and one row
    (``B = 1``); member-stacked params with batch row m member m's admission,
    each at its own offset, absent members ``None`` (their row computes and
    writes nothing — the explicit form of ``_seg_fn_members``' write gate);
    an ensemble's one prompt repeated into every weight set's row.

    Attention here is the plain ``ops/attention.attention`` (the JAX package
    runs XLA's plain attention here too, outside any Pallas kernel); its f32
    scores ``[B, K, G, T, history]`` live for one layer. Padded tail
    positions write K/V past the prompt, which every later read masks and
    decoding overwrites. ``offset + T`` must not cross ``max_seq`` (the
    engine keeps offsets multiples of a chunk that divides it).
    ``n_valid[b]`` (default: all T) keeps row b's padded tail out of MoE
    expert capacity (JAX: ``arange(T) < n_valid``). ``mesh``: a tp rank's
    shard, with the tp collectives (segments never run sequence-parallel:
    sp > 1 turns chunked prefill off); where its dp cuts the slot rows,
    ``rows`` are global and only the owning group's rows run here."""
    if mesh is not None and mesh.splits_slots:
        mine = [i for i, r in enumerate(rows)
                if r is not None and _slot_owner(mesh, r) == mesh.dp_rank]
        if not mine:
            return cache_k, cache_v
        if len(mine) < len(rows):
            tokens = tokens[host_to_device(mine, torch.long, tokens.device)]
            offsets = [offsets[i] for i in mine]
            n_valid = None if n_valid is None else [n_valid[i] for i in mine]
        rows = [_local_row(mesh, rows[i]) for i in mine]
    b, t = tokens.shape
    dev = tokens.device
    hist = min(history, spec.max_seq)
    positions = (host_to_device(offsets, torch.long, dev)[:, None]
                 + torch.arange(t, device=dev)[None, :])          # [B, T]
    x = _embed(params, spec, tokens, positions, mesh)
    cos, sin = _rope(spec, dev)
    keep = [i for i, r in enumerate(rows) if r is not None]
    read = host_to_device([r if r is not None else 0 for r in rows], torch.long, dev)
    dst = host_to_device([rows[i] for i in keep], torch.long, dev)[:, None]
    src = slice(None) if len(keep) == b else host_to_device(keep, torch.long, dev)
    wpos = positions[src]
    ki = torch.arange(hist, device=dev)[None, None, :]
    visible = ki <= positions[:, :, None]
    if spec.sliding_window > 0:
        visible = visible & (ki > positions[:, :, None] - spec.sliding_window)
    mask = visible[:, None, None]                                  # [B, 1, 1, T, hist]
    moe_mask = None
    if spec.is_moe and n_valid is not None:
        moe_mask = (torch.arange(t, device=dev)[None, :]
                    < host_to_device(n_valid, torch.long, dev)[:, None])
    blocks = params["blocks"]
    ridx = None
    if kv_is_paged(cache_k):
        # Page slots and window blocks, the same for every layer and side.
        first = cache_k.layer(0)
        wslots = write_slots(first, dst[:, 0], wpos, wpos < spec.max_seq)
        ridx = window_index(first.table[read], hist, first.page_size, first.n_kv)

    for l in range(n_layers(blocks)):
        def attend(q, k, v, l=l):
            if spec.pos == "rope":
                q = apply_rope(q, cos, sin, positions)
                k = apply_rope(k, cos, sin, positions)
            # cache[l][row, :, pos] ← [n, T, K, hd], in place
            ck, cv = _kv_layer(cache_k, l), _kv_layer(cache_v, l)
            if ridx is not None:
                page_write(ck, k[src], slots=wslots)
                page_write(cv, v[src], slots=wslots)
            else:
                _kv_put(ck, (dst, slice(None), wpos), k[src], heads_last=True)
                _kv_put(cv, (dst, slice(None), wpos), v[src], heads_last=True)
            return attention(q, _seg_read(ck, read, hist, q.dtype, ridx),
                             _seg_read(cv, read, hist, q.dtype, ridx), mask), k, v

        x = _block(x, _layer(blocks, l), spec, attend, token_mask=moe_mask, mesh=mesh)
    return cache_k, cache_v


def _seg_read(side, read: torch.Tensor, hist: int, dtype, index=None) -> torch.Tensor:
    """Rows ``read`` of one layer's cache side over ``[0, hist)`` in
    ``dtype``; an int8 side dequantizes the bounded window (the JAX
    package's ``seg_read``); a paged side gathers it through the table
    (``index``: the rows' ``window_index``)."""
    if kv_is_paged(side):
        return page_read_row(side, read, hist, dtype, index)
    if kv_is_q8(side):
        return _kv_dequant(side[0][read, :, :hist], side[1][read, :, :hist], dtype)
    return side[read, :, :hist].to(dtype)


def decode_token_embed(params: Params, spec: ModelSpec, token, lengths, mesh=None):
    """Embed one decode step's tokens: ``[B] → [B, 1, D]`` (scaled, plus the
    learned position embedding at each row's position when the spec uses
    one; member-stacked tables: row b reads its member's table)."""
    emb, pos_emb = params["tok_emb"], params.get("pos_emb")
    if _w(emb).dim() == 3:
        mi = _member_rows(_w(emb).shape[0], token.shape[0], token.device)
        x = _emb_lookup(emb, token, spec, mesh, mi)
        pos = pos_emb[mi, lengths] if spec.pos == "learned" else None
    else:
        x = _emb_lookup(emb, token, spec, mesh)
        pos = pos_emb[lengths] if spec.pos == "learned" else None
    x = _scale_emb(x[:, None, :], spec)
    return x if pos is None else x + pos[:, None, :].to(x.dtype)


def decode_step_blocks(
    blocks,
    spec: ModelSpec,
    x: torch.Tensor,        # [B, 1, D] embedded hidden states
    lengths: torch.Tensor,  # [B] current token's position per row
    cache_k: torch.Tensor,  # [L, B, K, max_seq, hd]
    cache_v: torch.Tensor,
    write_mask: torch.Tensor | None = None,  # [B] bool: rows allowed to write
    plain_attention: bool = False,
    history: int | None = None,
    mesh=None,
):
    """The layer loop of :func:`decode_step` on pre-embedded hidden states:
    per-row RoPE at ``lengths``, per-row K/V write at ``lengths`` (rows with
    ``write_mask`` False write back what the cache already held — an
    inactive slot must not clobber a freshly admitted row), attention over
    each row's ``lengths + 1`` live entries. Returns ``(x, cache_k,
    cache_v)`` with ``x`` still pre-final-norm. MoE layers run dense.

    A paged cache (``cache/paging.py``) writes through its page table and
    hands attention the gathered window of each row's first ``history``
    positions (the whole window by default), which K2 or K2q8 read as they
    read a dense cache; a dense cache ignores ``history`` (K2 reads each
    row's exact length)."""
    b = x.shape[0]
    cos, sin = _rope(spec, x.device)
    rows = torch.arange(b, device=x.device)
    pos = lengths.long()
    allow = (torch.ones((b,), dtype=torch.bool, device=x.device)
             if write_mask is None else write_mask)
    live_len = (lengths + 1).to(torch.int32)
    q8 = kv_is_q8(cache_k)
    if q8:
        attn_fn = decode_attention_q8 if plain_attention else flash_decode_q8_attention
    else:
        attn_fn = decode_attention if plain_attention else flash_decode_attention

    def put(cache, value):
        old = cache[rows, :, pos]
        keep = allow.reshape(-1, *([1] * (old.dim() - 1)))
        cache[rows, :, pos] = torch.where(keep, value.to(cache.dtype), old)

    def write(side, value):
        # value [B, K, 1, hd] lands at each row's own position, in place.
        if kv_is_q8(side):
            v8, s = _kv_quantize(value)
            put(side[0], v8[:, :, 0])
            put(side[1], s[:, :, 0])
        else:
            put(side, value[:, :, 0])

    paged = kv_is_paged(cache_k)
    if paged:
        # Page slots of this step's writes and the window's blocks: the
        # same for every layer and both sides, built once a step.
        first = cache_k.layer(0)
        hist = min(history or spec.max_seq, spec.max_seq)
        wslots = write_slots(first, rows, pos[:, None], (allow & (pos < spec.max_seq))[:, None])
        ridx = window_index(first.table, hist, first.page_size, first.n_kv)

    for l in range(n_layers(blocks)):
        def attend(q, k, v, l=l):
            if spec.pos == "rope":
                q = apply_rope(q, cos, sin, pos[:, None])
                k = apply_rope(k, cos, sin, pos[:, None])
            ck, cv = _kv_layer(cache_k, l), _kv_layer(cache_v, l)
            if paged:
                page_write(ck, k, slots=wslots)
                page_write(cv, v, slots=wslots)
                ck, cv = page_read(ck, hist, ridx), page_read(cv, hist, ridx)
            else:
                write(ck, k)
                write(cv, v)
            sides = (*ck, *cv) if q8 else (ck, cv)
            return attn_fn(q, *sides, live_len, window=spec.sliding_window), k, v

        x = _block(x, _layer(blocks, l), spec, attend, mesh=mesh)
    return x, cache_k, cache_v


def decode_step(
    params: Params,
    spec: ModelSpec,
    token: torch.Tensor,    # [B] current token ids
    lengths: torch.Tensor,  # [B] tokens already in the cache (current token's position)
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    write_mask: torch.Tensor | None = None,
    plain_attention: bool = False,
    ensemble: int = 1,
    history: int | None = None,
    mesh=None,
):
    """One autoregressive step. Returns (logits [B, V] f32, cache_k, cache_v).

    ``ensemble`` = E > 1 (member-stacked params, cache rows ``e·B + b``):
    every row runs through all E weight sets and the E members' logits are
    averaged in f32 — the JAX engine's ``_member_call(mean=True)``.

    ``mesh``: this rank's shard of a mesh. The step's ``token``, ``lengths``
    and ``write_mask`` are rank 0's on every rank (one broadcast,
    ``RankMesh.sync_step``: rank 0 samples, the others follow), so every
    rank feeds the same token; the logits are all-gathered over tp. Where
    the mesh's dp cuts the slot rows, each dp group runs its own rows and
    the hidden states are all-gathered over dp: the logits are every
    row's."""
    if mesh is not None:
        token, lengths, write_mask = mesh.sync_step(token, lengths, write_mask)
    if ensemble > 1:
        token, lengths = token.repeat(ensemble), lengths.repeat(ensemble)
        write_mask = None if write_mask is None else write_mask.repeat(ensemble)
    logits = _step_forward(params, spec, token, lengths, cache_k, cache_v, write_mask,
                           plain_attention, history, mesh)
    if ensemble > 1:
        logits = logits.view(ensemble, -1, logits.shape[-1]).mean(0)
    return logits, cache_k, cache_v


def _step_forward(params, spec, token, lengths, cache_k, cache_v, write_mask,
                  plain_attention=False, history=None, mesh=None):
    split = mesh is not None and mesh.splits_slots
    if split:
        # This dp group's rows: its block of the S slots of every weight
        # set's rows (m·S + s); the others' hidden states come by all-gather.
        lo, hi, n = mesh.slots
        stack = token.shape[0] // n

        def own(v):
            return v.reshape(stack, n)[:, lo:hi].reshape(-1)

        token, lengths = own(token), own(lengths)
        write_mask = None if write_mask is None else own(write_mask)
    x = decode_token_embed(params, spec, token, lengths, mesh)
    x, cache_k, cache_v = decode_step_blocks(
        params["blocks"], spec, x, lengths, cache_k, cache_v,
        write_mask=write_mask, plain_attention=plain_attention, history=history, mesh=mesh)
    if split:
        x = mesh.dp.all_gather(x.reshape(stack, hi - lo, *x.shape[1:]), dim=1)
        x = x.reshape(stack * n, *x.shape[2:])
    x = _final_norm(params, spec, x)
    return unembed(params, spec, x[:, 0, :], mesh)


def follow_decode_step(params: Params, spec: ModelSpec, token: torch.Tensor,
                       lengths: torch.Tensor, write_mask: torch.Tensor, cache_k, cache_v, mesh,
                       ensemble: int = 1, history: int | None = None):
    """A worker rank's decode step: rank 0's inputs from the broadcast
    (``token``, ``lengths`` and ``write_mask`` give only their shapes and
    dtypes), then the step's forward on this rank's shard (``ensemble``:
    every row through each weight set, as :func:`decode_step` runs it;
    ``history``: a paged cache's window, rank 0's), collective for
    collective the one rank 0's :func:`decode_step` runs. Returns the token
    and write mask it fed."""
    token, lengths, write_mask = mesh.sync_step(token, lengths, write_mask)
    tok, lens, wm = token, lengths, write_mask
    if ensemble > 1:
        tok, lens, wm = tok.repeat(ensemble), lens.repeat(ensemble), wm.repeat(ensemble)
    _step_forward(params, spec, tok, lens, cache_k, cache_v, wm, history=history, mesh=mesh)
    return token, write_mask


def broadcast_member_rows(cache_k, cache_v, n_members: int, slot: int, n: int,
                          mesh=None) -> None:
    """Member 0's positions ``[0, n)`` of slot ``slot`` copied into every
    member's row of that slot, in place (a ``quorum_dedup`` admission: one
    prefill on shared weights gives every member's K/V). On a mesh each
    rank copies its own kv heads, and only the dp group holding the slot
    copies: no collective."""
    if mesh is not None and mesh.splits_slots:
        if _slot_owner(mesh, slot) != mesh.dp_rank:
            return
        slot = _local_row(mesh, slot)
    for cache in (cache_k, cache_v):
        by_member = cache.view(cache.shape[0], n_members, -1, *cache.shape[2:])
        by_member[:, 1:, slot, :, :n].copy_(
            by_member[:, :1, slot, :, :n].expand(-1, n_members - 1, -1, -1, -1))


def decode_chunk(
    params: Params,
    spec: ModelSpec,
    n_steps: int,
    token: torch.Tensor,    # [B] current token ids
    lengths: torch.Tensor,  # [B] tokens already in the cache per row
    live: torch.Tensor,     # [B] bool: rows decoding in this chunk
    budget: torch.Tensor,   # [B] int32: tokens each row may still produce
    eos: torch.Tensor,      # [B] int32: per-row EOS id (-1 = none)
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    sample_fn,
    sample_carry,
    plain_attention: bool = False,
    ensemble: int = 1,
    history: int | None = None,
    mesh=None,
):
    """``n_steps`` decode steps with on-device finish accounting.

    After a row samples its EOS or its ``budget`` reaches zero its ``live``
    flag drops: it stops sampling (its token freezes), stops writing cache
    and stops advancing ``lengths`` — with no host read inside the chunk.
    ``sample_fn(logits_f32 [B, V], live [B], carry) -> (next [B], carry,
    aux)`` supplies sampling; ``aux`` tuples are stacked over steps.

    Member-stacked params run all M·S rows in one step (the JAX engine's
    members branch); ``ensemble``, ``history`` (a paged cache's window) and
    ``mesh`` are passed to :func:`decode_step`.

    Returns ``(tokens [B, n_steps], valid [B, n_steps] bool, n_valid [B],
    live, budget, cache_k, cache_v, lengths, sample_carry, aux)``."""
    tok, lens, lv, bud = token, lengths, live, budget
    toks, valids, auxs = [], [], []
    for _ in range(n_steps):
        pos = torch.where(lv, lens, torch.zeros_like(lens))
        logits, cache_k, cache_v = decode_step(params, spec, tok, pos, cache_k, cache_v,
                                               write_mask=lv, plain_attention=plain_attention,
                                               ensemble=ensemble, history=history, mesh=mesh)
        nxt, sample_carry, aux = sample_fn(logits.float(), lv, sample_carry)
        nxt = torch.where(lv, nxt.to(tok.dtype), tok)
        lens = lens + lv.to(lens.dtype)
        bud = bud - lv.to(bud.dtype)
        # The row's own finish check, applied AFTER this step's token (the
        # EOS token itself is valid and delivered): next step it is dead.
        fin = lv & ((nxt == eos) | (bud <= 0))
        toks.append(nxt)
        valids.append(lv)
        auxs.append(tuple(aux))
        tok, lv = nxt, lv & ~fin
    tokens = torch.stack(toks, dim=1)
    valid = torch.stack(valids, dim=1)
    n_valid = valid.to(torch.int32).sum(dim=1)
    aux = tuple(torch.stack(col) for col in zip(*auxs)) if auxs and auxs[0] else ()
    return (tokens, valid, n_valid, lv, bud, cache_k, cache_v, lens, sample_carry, aux)


def decode_multi(
    params: Params,
    spec: ModelSpec,
    tokens: torch.Tensor,   # [B, T] current token + T-1 proposed continuations
    lengths: torch.Tensor,  # [B] position of tokens[:, 0] per row
    cache_k,
    cache_v,
    write_mask: torch.Tensor | None = None,  # [B] bool: rows allowed to write
    history: int | None = None,
    clamp_writes: bool = False,
    ensemble: int = 1,
    mesh=None,
):
    """T-token decode: logits for positions ``lengths .. lengths+T-1`` of
    each row in ONE forward (the JAX package's ``decode_multi``, the
    speculative-verification step). Returns ``(logits [B, T, V] f32,
    cache_k, cache_v)``; T = 1 is :func:`decode_step`.

    K/V of all T positions is written into each row in place, as
    :func:`decode_step_blocks` writes one (rows with ``write_mask`` False
    write back what the cache held). Rejected positions land past the
    row's advanced length, where every later read masks them and
    generation overwrites them. ``clamp_writes`` makes a row whose span
    runs past ``max_seq`` drop exactly the out-of-range positions: the
    window start moves back by the overflow and the values roll right by
    the same amount, the slots below it writing the old contents back —
    never a valid entry overwritten. Without it the start clamps back and
    the values do not roll (JAX's ``dynamic_update_slice``). Positions
    past the tables (RoPE, learned embeddings) gather the last entry, as
    JAX's clamped gathers do; their logits are never accepted.

    Attention is the plain :func:`ops.attention.attention` over each row's
    ``[0, history)`` (the whole window by default) with a per-row causal
    mask and sliding window: JAX runs XLA's plain attention here too. It
    contracts the cache in its own dtype into f32 scores, so the window is
    never copied to f32; an int8 side is dequantized over the window, as
    JAX's does. MoE layers run dense, never grouped: verify logits must
    match the T = 1 path. A paged cache writes through its page table
    (positions past ``max_seq`` drop, ``clamp_writes`` or not) and reads
    the gathered window. Member-stacked params run member-major rows as
    :func:`decode_chunk` does; ``ensemble`` = E > 1 runs every row through
    the E weight sets (cache rows ``e·B + b``) and averages their logits.

    ``mesh``: this rank's shard of a mesh, as :func:`decode_step` takes it —
    a verify turn at the rank's heads. The turn's ``tokens``, ``lengths``
    and ``write_mask`` are rank 0's on every rank (one broadcast,
    ``RankMesh.sync_multi``); q/k/v and the output projection are the
    rank's tp cut with their all-reduce (``kv_select`` where query-head
    groups cut unevenly), the MLP the rank's cut (its experts), the writes
    the one-card function's into the rank's cache at its kv heads; where
    dp cuts the slot rows each dp group runs its own rows and the hidden
    states are all-gathered over dp before the vocab-cut head, whose
    logits are all-gathered over tp: every row's, on every rank."""
    if mesh is not None:
        tokens, lengths, write_mask = mesh.sync_multi(tokens, lengths, write_mask)
    return _multi_forward(params, spec, tokens, lengths, cache_k, cache_v, write_mask, history,
                          clamp_writes, ensemble, mesh)


def follow_decode_multi(params: Params, spec: ModelSpec, tokens: torch.Tensor,
                        lengths: torch.Tensor, write_mask: torch.Tensor, cache_k, cache_v, mesh,
                        history: int | None = None, ensemble: int = 1) -> None:
    """A worker rank's verify turn: rank 0's inputs from the broadcast
    (``tokens``, ``lengths`` and ``write_mask`` give only their shapes and
    dtypes), then the turn's forward on this rank's shard, collective for
    collective the one rank 0's :func:`decode_multi` runs (the writes
    clamped at ``max_seq`` as rank 0's verify turns clamp them)."""
    tokens, lengths, write_mask = mesh.sync_multi(tokens, lengths, write_mask)
    _multi_forward(params, spec, tokens, lengths, cache_k, cache_v, write_mask, history, True,
                   ensemble, mesh)


def _multi_forward(params, spec, tokens, lengths, cache_k, cache_v, write_mask, history,
                   clamp_writes, ensemble, mesh):
    if ensemble > 1:
        tokens, lengths = tokens.repeat(ensemble, 1), lengths.repeat(ensemble)
        write_mask = None if write_mask is None else write_mask.repeat(ensemble)
    split = mesh is not None and mesh.splits_slots
    if split:
        # This dp group's rows (as :func:`_step_forward` takes them).
        lo, hi, n = mesh.slots
        stack = tokens.shape[0] // n

        def own(v):
            return v.reshape(stack, n, *v.shape[1:])[:, lo:hi].reshape(-1, *v.shape[1:])

        tokens, lengths = own(tokens), own(lengths)
        write_mask = None if write_mask is None else own(write_mask)
    b, t = tokens.shape
    dev = tokens.device
    max_seq = spec.max_seq
    hist = max_seq if history is None else min(history, max_seq)
    j = torch.arange(t, device=dev)
    pos = lengths.long()[:, None] + j[None, :]                      # [B, T]
    pos_in = pos.clamp(max=max_seq - 1)
    x = _embed(params, spec, tokens, pos_in, mesh)
    cos, sin = _rope(spec, dev)
    allow = (torch.ones((b,), dtype=torch.bool, device=dev)
             if write_mask is None else write_mask)
    # The write window per row: start moved back by the overflow past max_seq.
    delta = (lengths.long() + t - max_seq).clamp(min=0)             # [B]
    wpos = (lengths.long() - delta)[:, None] + j[None, :]           # [B, T], in range
    rows = torch.arange(b, device=dev)[:, None]
    if clamp_writes:
        src = (j[None, :] - delta[:, None]).clamp(min=0)            # slot → value index
        keep = (j[None, :] >= delta[:, None]) & allow[:, None]      # [B, T]
    else:
        src, keep = None, allow[:, None].expand(b, t)

    def put(cache, value):
        # value [B, K, T, ...] → cache[row, :, wpos] laid out [B, T, K, ...]
        value = value.transpose(1, 2)
        if src is not None:
            idx = src.reshape(b, t, *([1] * (value.dim() - 2))).expand_as(value)
            value = value.gather(1, idx)
        old = cache[rows, :, wpos]
        mask = keep.reshape(b, t, *([1] * (value.dim() - 2)))
        cache[rows, :, wpos] = torch.where(mask, value.to(cache.dtype), old)

    ridx = None
    if kv_is_paged(cache_k):
        # Out-of-window positions drop exactly (no roll to work around);
        # slots and window blocks built once for every layer and side.
        first = cache_k.layer(0)
        wslots = write_slots(first, torch.arange(b, device=dev), pos,
                             allow[:, None] & (pos < max_seq))
        ridx = window_index(first.table, hist, first.page_size, first.n_kv)

    def write(side, value):
        if kv_is_paged(side):
            page_write(side, value, slots=wslots)
        elif kv_is_q8(side):
            v8, s = _kv_quantize(value)
            put(side[0], v8)
            put(side[1], s)
        else:
            put(side, value)

    def read(side, dtype):
        if kv_is_paged(side):
            r = page_read(side, hist, ridx)
            return _kv_dequant(r[0], r[1], dtype) if side.is_q8 else r
        if kv_is_q8(side):
            return _kv_dequant(side[0][:, :, :hist], side[1][:, :, :hist], dtype)
        return side[:, :, :hist]

    ki = torch.arange(hist, device=dev)[None, None, :]
    visible = ki <= pos[:, :, None]
    if spec.sliding_window > 0:
        visible = visible & (ki > pos[:, :, None] - spec.sliding_window)
    mask = visible[:, None, None]                                   # [B, 1, 1, T, hist]

    for l in range(spec.n_layers):
        def attend(q, k, v, l=l):
            if spec.pos == "rope":
                q = apply_rope(q, cos, sin, pos_in)
                k = apply_rope(k, cos, sin, pos_in)
            ck, cv = _kv_layer(cache_k, l), _kv_layer(cache_v, l)
            write(ck, k)
            write(cv, v)
            return attention(q, read(ck, q.dtype), read(cv, q.dtype), mask), k, v

        x = _block(x, _layer(params["blocks"], l), spec, attend, dense_moe=True, mesh=mesh)
    if split:
        x = mesh.dp.all_gather(x.reshape(stack, hi - lo, *x.shape[1:]), dim=1)
        x = x.reshape(stack * n, *x.shape[2:])
    logits = unembed(params, spec, _final_norm(params, spec, x), mesh)
    if ensemble > 1:
        logits = logits.view(ensemble, -1, *logits.shape[1:]).mean(0)
    return logits, cache_k, cache_v


def decode_loop(
    params: Params,
    spec: ModelSpec,
    n_steps: int,
    n_chunks: int,
    token: torch.Tensor,    # [B] current token ids
    lengths: torch.Tensor,  # [B] tokens already in the cache per row
    live: torch.Tensor,     # [B] bool: rows decoding in this dispatch
    budget: torch.Tensor,   # [B] int32: tokens each row may still produce
    eos: torch.Tensor,      # [B] int32: per-row EOS id (-1 = none)
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    sample_fn,
    sample_carry,
    plain_attention: bool = False,
    ensemble: int = 1,
    history: int | None = None,
    mesh=None,
):
    """Megachunk decode: ``n_chunks`` :func:`decode_chunk` bodies back to
    back in one dispatch (the JAX package's ``decode_loop``; the engine
    captures it into one CUDA graph on the card), chaining each chunk's
    finish state, lengths and last token into the next.

    A chunk that no row enters live is JAX's ``skip_chunk``: its tokens and
    valid counts are zeros and the carry passes through unchanged. Here it
    still runs, with every cache write masked — a forward over rows that
    are all dead leaves tokens, lengths, budgets and caches as they were —
    and its outputs are selected to zeros on the device, so no step reads
    ``live`` back to the host. ``n_chunks == 1`` is not special-cased: the
    engine calls :func:`decode_chunk` itself for one chunk.

    Returns ``(toks [n_chunks, B, n_steps], n_valid [n_chunks, B], token
    [B], live, budget, cache_k, cache_v, lengths, sample_carry, aux)``;
    every ``aux`` leaf gains a leading ``n_chunks`` axis."""
    tok, lens, lv, bud = token, lengths, live, budget
    toks_all, valid_all, auxs = [], [], []
    for _ in range(n_chunks):
        entered = lv.any()
        (toks, _valid, n_valid, lv, bud, cache_k, cache_v, lens, sample_carry,
         aux) = decode_chunk(params, spec, n_steps, tok, lens, lv, bud, eos, cache_k, cache_v,
                             sample_fn, sample_carry, plain_attention=plain_attention,
                             ensemble=ensemble, history=history, mesh=mesh)
        # toks[:, -1] IS the carried token (dead rows freeze theirs).
        tok = toks[:, -1]
        toks_all.append(torch.where(entered, toks, torch.zeros_like(toks)))
        valid_all.append(n_valid)  # 0 for every row of a chunk no row entered
        auxs.append(tuple(torch.where(entered, a, torch.zeros_like(a)) for a in aux))
    aux = tuple(torch.stack(col) for col in zip(*auxs)) if auxs and auxs[0] else ()
    return (torch.stack(toks_all), torch.stack(valid_all), tok, lv, bud, cache_k, cache_v, lens,
            sample_carry, aux)


def forward_hidden(params: Params, spec: ModelSpec, tokens: torch.Tensor,
                   lengths: torch.Tensor | None = None,
                   plain_attention: bool = False, remat: bool = False,
                   mesh=None, sp_impl: str = "ring") -> torch.Tensor:
    """Final-norm hidden states [B, T, D] with no KV cache: the embeddings
    forward, :func:`forward_logits` without the unembed.

    Attention is K1 (``flash_prefill_attention`` at each row's ``lengths``,
    T for every row when None), the kernel admissions run; a CPU tensor
    takes its plain version. Positions at or past a row's length come out
    of K1 as 0 and differ from the plain masked attention's, which attends
    them: callers read only the positions below each length, and causal
    attention keeps every such position independent of the padding behind
    it. ``plain_attention=True`` runs the plain masked attention on any
    device (the ground truth the kernel path is held against on the card).
    Right-padded MoE batches pass ``lengths``: pad tokens then take no
    expert capacity.

    Gradients: the kernel path refuses grad-requiring inputs under grad
    mode (K1 has no backward); training runs ``plain_attention=True``, the
    JAX package's XLA attention. ``remat=True`` runs each layer under
    ``torch.utils.checkpoint`` (non-reentrant), the JAX package's
    ``jax.checkpoint`` per scanned layer: a layer's activations are
    recomputed in the backward instead of kept. ``mesh`` (a
    ``parallel/comm.RankMesh``, params this rank's tp shard): the tp
    collectives, differentiable (the module docstring's training note).
    With pp > 1 (stage 0 of a pipeline-staged mesh: params its stage's
    cut) the forward runs stage by stage
    (``parallel/pipeline.staged_forward_hidden``; the later stages run
    ``follow_staged_forward``). With sp > 1 (``sp_impl``: ring or Ulysses)
    and sp dividing T (``_sp_blocks``, as an admission splits) each rank
    runs its T/sp block of positions through every layer, attention over
    the whole sequence by the ring or Ulysses over ``mesh.sp``, and the
    blocks' hidden states are all-gathered over sp: every sp rank returns
    the whole sequence's. The JAX forward runs replicated over sp instead,
    so the two agree within float rounding, not bit for bit."""
    if mesh is not None and mesh.pp_size > 1:
        from quorum_tpu_torch.parallel.pipeline import staged_forward_hidden

        return staged_forward_hidden(params, spec, tokens, lengths, mesh, plain_attention)
    b, t = tokens.shape
    dev = tokens.device
    n_sp = _sp_blocks(mesh, t, spec, sp_impl) if mesh is not None else 1
    lo, s_loc = (mesh.sp_rank * (t // n_sp), t // n_sp) if n_sp > 1 else (0, t)
    positions = torch.arange(lo, lo + s_loc, device=dev)
    lens = (torch.full((b,), t, dtype=torch.int32, device=dev) if lengths is None
            else lengths.to(device=dev, dtype=torch.int32))
    moe_mask = (None if lengths is None or not spec.is_moe
                else positions[None, :] < lens[:, None])
    x = _embed(params, spec, tokens[:, lo:lo + s_loc], positions, mesh)
    cos, sin = _rope(spec, dev)
    mask = (causal_mask(t, t, window=spec.sliding_window, device=dev)
            if plain_attention and n_sp == 1 else None)

    def attend(q, k, v):
        if spec.pos == "rope":
            q = apply_rope(q, cos, sin, positions)
            k = apply_rope(k, cos, sin, positions)
        if n_sp > 1:
            return _sp_attention(q, k, v, lens, mesh, spec, sp_impl, plain_attention), k, v
        if plain_attention:
            return attention(q, k, v, mask), k, v
        return flash_prefill_attention(q, k, v, lens, window=spec.sliding_window), k, v

    def layer(x, block):
        return _block(x, block, spec, attend, token_mask=moe_mask, mesh=mesh)

    for l in range(spec.n_layers):
        block = _layer(params["blocks"], l)
        if remat:
            x = torch.utils.checkpoint.checkpoint(layer, x, block, use_reentrant=False)
        else:
            x = layer(x, block)
    x = _final_norm(params, spec, x)
    return mesh.sp.all_gather(x, dim=1) if n_sp > 1 else x


def forward_logits(params: Params, spec: ModelSpec, tokens: torch.Tensor,
                   lengths: torch.Tensor | None = None,
                   plain_attention: bool = False, remat: bool = False,
                   mesh=None) -> torch.Tensor:
    """Full-sequence logits [B, T, V] f32 with no KV cache (the eval and
    training forward, and the cache-free ground truth for prefill/decode
    consistency): :func:`forward_hidden` and the unembed, with its
    ``lengths``, ``plain_attention``, ``remat`` and ``mesh`` (on a mesh the
    logits are the whole vocabulary's, all-gathered over tp)."""
    return unembed(params, spec, forward_hidden(params, spec, tokens, lengths,
                                                 plain_attention=plain_attention, remat=remat,
                                                 mesh=mesh), mesh)


def forward_logits_sp(params: Params, spec: ModelSpec, tokens: torch.Tensor,
                      lengths: torch.Tensor, mesh, sp_impl: str = "ring") -> torch.Tensor:
    """Sequence-parallel full-sequence logits [B, T, V] f32 (the JAX
    package's ``forward_logits_sp``): this rank runs its sp block of the T
    positions (T divisible by the mesh's sp) through every layer, with
    ring attention or Ulysses over sp and the tp collectives; the blocks'
    logits are all-gathered over sp, so every rank returns the whole
    sequence's. Windowed specs refuse the ring, in JAX's words. ``params``
    are this rank's shard (``models/convert.shard_params``)."""
    if spec.sliding_window > 0 and sp_impl != "ulysses":
        raise ValueError(
            "sliding_window specs cannot use ring attention (sp>1): the "
            "ring computes full causal attention and would silently widen "
            "the model's receptive field (sp_impl=ulysses supports windows)")
    if sp_impl not in ("ring", "ulysses"):
        raise ValueError(f"unknown sp_impl {sp_impl!r} (ring or ulysses)")
    b, t = tokens.shape
    if t % mesh.sp_size:
        raise ValueError(f"forward_logits_sp needs T divisible by sp: T={t}, sp={mesh.sp_size}")
    s_loc = t // mesh.sp_size
    lo = mesh.sp_rank * s_loc
    dev = tokens.device
    positions = torch.arange(lo, lo + s_loc, device=dev)
    x = _embed(params, spec, tokens[:, lo:lo + s_loc], positions, mesh)
    cos, sin = _rope(spec, dev)

    def attend(q, k, v):
        if spec.pos == "rope":
            q = apply_rope(q, cos, sin, positions)
            k = apply_rope(k, cos, sin, positions)
        return _sp_attention(q, k, v, lengths, mesh, spec, sp_impl), k, v

    for l in range(spec.n_layers):
        x = _block(x, _layer(params["blocks"], l), spec, attend, mesh=mesh)
    logits = unembed(params, spec, _final_norm(params, spec, x), mesh)
    return mesh.sp.all_gather(logits, dim=1)


def init_cache(spec: ModelSpec, batch: int, dtype=None, device=None,
               kv_quant: str | None = None, n_kv_heads: int | None = None,
               layers: int | None = None):
    """Preallocated KV cache: ``[L, B, K, max_seq, hd]`` × 2, zeroed. At
    llama-3-8b widths with an 8192 window that is 1.07 GB per slot in bf16.
    ``kv_quant="int8"``: each side is ``(int8 values, f32 per-token
    scales [L, B, K, max_seq])``, 0.54 GB per slot there. ``n_kv_heads``
    overrides K (a tp rank's kv heads), ``layers`` L (a pipeline stage's)."""
    shape = (layers or spec.n_layers, batch, n_kv_heads or spec.n_kv_heads, spec.max_seq,
             spec.head_dim)
    if kv_quant == "int8":
        def side():
            return (torch.zeros(shape, dtype=torch.int8, device=device),
                    torch.zeros(shape[:-1], dtype=torch.float32, device=device))
        return side(), side()
    dt = getattr(torch, dtype) if isinstance(dtype, str) else (dtype or _dtype(spec))
    return (torch.zeros(shape, dtype=dt, device=device),
            torch.zeros(shape, dtype=dt, device=device))
