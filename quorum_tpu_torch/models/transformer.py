"""Decoder-only transformer forward on torch tensors: the dense half of the
JAX package's models/transformer.py.

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

Attention goes through the two hand-written kernels: prefill through K1
(ops/flash_attention.py), decode through K2 (ops/flash_decode.py). Each
takes its plain version for CPU tensors. ``plain_attention=True`` calls the
plain versions directly on any device — only for holding the kernels
against them on the card; the engine never sets it.

Matrix products accumulate in float32 where the JAX code asked for
``preferred_element_type=float32``; in bf16 on the card cuBLAS accumulates
in float32 and rounds the output to bf16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from quorum_tpu_torch.models.model_config import ModelSpec
from quorum_tpu_torch.ops.attention import attention, causal_mask, decode_attention, prefill_attention
from quorum_tpu_torch.ops.flash_attention import flash_prefill_attention
from quorum_tpu_torch.ops.flash_decode import flash_decode_attention
from quorum_tpu_torch.ops.norms import layernorm, rmsnorm
from quorum_tpu_torch.ops.rotary import apply_rope, rope_cos_sin_for

Params = dict

_ROPE_TABLES: dict = {}


def _rope(spec: ModelSpec, device) -> tuple[torch.Tensor, torch.Tensor]:
    key = (spec, str(device))
    tabs = _ROPE_TABLES.get(key)
    if tabs is None:
        tabs = _ROPE_TABLES[key] = rope_cos_sin_for(spec, device)
    return tabs


def _dtype(spec: ModelSpec) -> torch.dtype:
    return getattr(torch, spec.dtype)


def _layer(blocks: Params, l: int) -> Params:
    return {k: (None if v is None else v[l]) for k, v in blocks.items()}


def member_params(params: Params, m: int) -> Params:
    """Member ``m``'s single-model view of a member-stacked tree: views,
    never copies (each layer's slab ``blocks[k][l, m]`` is contiguous)."""
    out = {k: (None if v is None else v[m]) for k, v in params.items() if k != "blocks"}
    out["blocks"] = {k: (None if v is None else v[:, m]) for k, v in params["blocks"].items()}
    return out


_MEMBER_ROWS: dict = {}


def _member_rows(n_members: int, n_rows: int, device) -> torch.Tensor:
    """[n_rows] member index of each member-major batch row (cached)."""
    key = (n_members, n_rows, str(device))
    idx = _MEMBER_ROWS.get(key)
    if idx is None:
        idx = _MEMBER_ROWS[key] = torch.arange(n_rows, device=device) // (n_rows // n_members)
    return idx


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w read back as float32 (the JAX einsums' f32 output). A
    member-stacked w [M, D, N] takes x's member-major rows as M groups: one
    batched GEMM [M, rows, D] × [M, D, N]."""
    if w.dim() == 3:
        out = torch.matmul(x.reshape(w.shape[0], -1, x.shape[-1]), w)
        return out.reshape(*x.shape[:-1], w.shape[-1]).float()
    return torch.matmul(x, w).float()


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
            w = w + torch.tensor(spec.norm_offset, dtype=w.dtype, device=w.device)
        return _per_member(x, w, lambda xs, ws: rmsnorm(xs, ws, spec.norm_eps))
    y = _per_member(x, w, lambda xs, ws: layernorm(xs, ws, None, spec.norm_eps))
    return y if b is None else _add(y, b)


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _dense_mlp(x, block, spec: ModelSpec):
    if spec.gated_mlp:
        gate = _mm(x, block["w_gate"])
        up = _mm(x, block["w_up"])
        # swiglu (llama/mistral) gates with SiLU; geglu (gemma) with tanh GELU.
        gated = F.silu(gate) if spec.act == "swiglu" else _gelu(gate)
        h = (gated * up).to(x.dtype)
    else:
        up = _mm(x, block["w_up"])
        if block.get("b_up") is not None:
            up = _add(up, block["b_up"])
        h = _gelu(up).to(x.dtype)
    out = _mm(h, block["w_down"])
    if block.get("b_down") is not None:
        out = _add(out, block["b_down"])
    return out.to(x.dtype)


def _qkv(x, block, spec: ModelSpec):
    """Project to contiguous q [B,H,T,hd], k/v [B,K,T,hd]."""
    b, t, _ = x.shape
    q, k, v = _mm(x, block["wq"]), _mm(x, block["wk"]), _mm(x, block["wv"])
    if block.get("bq") is not None:
        q, k, v = _add(q, block["bq"]), _add(k, block["bk"]), _add(v, block["bv"])

    def heads(y, n):
        return y.to(x.dtype).reshape(b, t, n, spec.head_dim).transpose(1, 2).contiguous()

    return heads(q, spec.n_heads), heads(k, spec.n_kv_heads), heads(v, spec.n_kv_heads)


def _attn_out(attn, block, x_dtype):
    b, h, t, d = attn.shape
    out = _mm(attn.transpose(1, 2).reshape(b, t, h * d), block["wo"])
    if block.get("bo") is not None:
        out = _add(out, block["bo"])
    return out.to(x_dtype)


def _scale_emb(x, spec: ModelSpec):
    if spec.emb_scale != 1.0:  # gemma scales embeddings by sqrt(d_model)
        x = x * torch.tensor(spec.emb_scale, dtype=x.dtype, device=x.device)
    return x


def _embed(params, spec: ModelSpec, tokens, positions):
    """tokens [B, T] → [B, T, D]; with member-stacked tables row b reads
    its member's table (``tok_emb[m, token]``)."""
    emb, pos_emb = params["tok_emb"], params.get("pos_emb")
    if emb.dim() == 3:
        mi = _member_rows(emb.shape[0], tokens.shape[0], tokens.device)[:, None]
        x = emb[mi, tokens]
        pos = pos_emb[mi, positions[None, :]] if spec.pos == "learned" else None
    else:
        x = emb[tokens]
        pos = pos_emb[positions][None] if spec.pos == "learned" else None
    x = _scale_emb(x.to(_dtype(spec)), spec)
    return x if pos is None else x + pos.to(x.dtype)


def _unembed(params, spec: ModelSpec, x):
    w = params.get("lm_head")
    if w is not None:
        return _mm(x, w)
    # tied head: contract against the embedding table's rows directly
    return _mm(x, params["tok_emb"].transpose(-1, -2))


def _final_norm(params, spec: ModelSpec, x):
    return _norm(x, params["final_norm_w"], params.get("final_norm_b"), spec)


def _block(x, block, spec, q_k_v_to_attn):
    """One transformer block around an attention callable."""
    h = _norm(x, block["attn_norm_w"], block.get("attn_norm_b"), spec)
    q, k, v = _qkv(h, block, spec)
    attn, k, v = q_k_v_to_attn(q, k, v)
    x = x + _attn_out(attn, block, x.dtype)
    h2 = _norm(x, block["mlp_norm_w"], block.get("mlp_norm_b"), spec)
    return x + _dense_mlp(h2, block, spec)


def _dense_only(spec: ModelSpec) -> None:
    if spec.is_moe:
        raise NotImplementedError("MoE specs are not ported yet (dense models only)")


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
):
    """Process the full prompt; returns (last-token logits [B, V] f32,
    cache_k, cache_v). K/V of every prompt position is written into the
    cache in place — at cache row ``slot`` (batch-1 tokens) for the
    continuous-batching admission path, at ``rows[b]`` for batch row b when
    ``rows`` is given (an entry of ``None`` writes nothing: the JAX
    ``write_gate``, so a member-coalesced admission never touches absent
    members' rows), else at rows ``[0, B)``. With member-stacked params,
    batch row m is member m's prompt (one per member) and attention runs as
    one K1 launch per layer over the M rows, each at its own length."""
    _dense_only(spec)
    b, t = tokens.shape
    dev = tokens.device
    positions = torch.arange(t, device=dev)
    x = _embed(params, spec, tokens, positions)
    cos, sin = _rope(spec, dev)
    src = slice(None)
    if rows is None:
        dst = slice(slot, slot + 1) if slot is not None else slice(0, b)
    else:
        keep = [i for i, r in enumerate(rows) if r is not None]
        dst = torch.tensor([rows[i] for i in keep], dtype=torch.long, device=dev)
        if len(keep) < b:
            src = torch.tensor(keep, dtype=torch.long, device=dev)
    attn_fn = prefill_attention if plain_attention else flash_prefill_attention
    blocks = params["blocks"]

    for l in range(spec.n_layers):
        def attend(q, k, v, l=l):
            if spec.pos == "rope":
                q = apply_rope(q, cos, sin, positions)
                k = apply_rope(k, cos, sin, positions)
            cache_k[l, dst, :, :t] = k[src]  # in place (JAX: donated buffer)
            cache_v[l, dst, :, :t] = v[src]
            return attn_fn(q, k, v, lengths, window=spec.sliding_window), k, v

        x = _block(x, _layer(blocks, l), spec, attend)
    x = _final_norm(params, spec, x)
    # Only the last real token's logits matter for generation; gather per row.
    last = x[torch.arange(b, device=x.device), lengths.long() - 1]
    return _unembed(params, spec, last), cache_k, cache_v


def decode_token_embed(params: Params, spec: ModelSpec, token, lengths):
    """Embed one decode step's tokens: ``[B] → [B, 1, D]`` (scaled, plus the
    learned position embedding at each row's position when the spec uses
    one; member-stacked tables: row b reads its member's table)."""
    emb, pos_emb = params["tok_emb"], params.get("pos_emb")
    if emb.dim() == 3:
        mi = _member_rows(emb.shape[0], token.shape[0], token.device)
        x, pos = emb[mi, token], (pos_emb[mi, lengths] if spec.pos == "learned" else None)
    else:
        x, pos = emb[token], (pos_emb[lengths] if spec.pos == "learned" else None)
    x = _scale_emb(x.to(_dtype(spec))[:, None, :], spec)
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
):
    """The layer loop of :func:`decode_step` on pre-embedded hidden states:
    per-row RoPE at ``lengths``, per-row K/V write at ``lengths`` (rows with
    ``write_mask`` False write back what the cache already held — an
    inactive slot must not clobber a freshly admitted row), attention over
    each row's ``lengths + 1`` live entries. Returns ``(x, cache_k,
    cache_v)`` with ``x`` still pre-final-norm."""
    _dense_only(spec)
    b = x.shape[0]
    cos, sin = _rope(spec, x.device)
    rows = torch.arange(b, device=x.device)
    pos = lengths.long()
    allow = (torch.ones((b,), dtype=torch.bool, device=x.device)
             if write_mask is None else write_mask)
    live_len = (lengths + 1).to(torch.int32)
    attn_fn = decode_attention if plain_attention else flash_decode_attention

    def write(cache, value):
        # value [B, K, 1, hd] lands at each row's own position, in place.
        old = cache[rows, :, pos]                    # [B, K, hd]
        cache[rows, :, pos] = torch.where(allow[:, None, None], value[:, :, 0].to(cache.dtype), old)

    for l in range(spec.n_layers):
        def attend(q, k, v, l=l):
            if spec.pos == "rope":
                q = apply_rope(q, cos, sin, pos[:, None])
                k = apply_rope(k, cos, sin, pos[:, None])
            write(cache_k[l], k)
            write(cache_v[l], v)
            return attn_fn(q, cache_k[l], cache_v[l], live_len,
                           window=spec.sliding_window), k, v

        x = _block(x, _layer(blocks, l), spec, attend)
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
):
    """One autoregressive step. Returns (logits [B, V] f32, cache_k, cache_v).

    ``ensemble`` = E > 1 (member-stacked params, cache rows ``e·B + b``):
    every row runs through all E weight sets and the E members' logits are
    averaged in f32 — the JAX engine's ``_member_call(mean=True)``."""
    if ensemble > 1:
        token, lengths = token.repeat(ensemble), lengths.repeat(ensemble)
        write_mask = None if write_mask is None else write_mask.repeat(ensemble)
    x = decode_token_embed(params, spec, token, lengths)
    x, cache_k, cache_v = decode_step_blocks(
        params["blocks"], spec, x, lengths, cache_k, cache_v,
        write_mask=write_mask, plain_attention=plain_attention)
    x = _final_norm(params, spec, x)
    logits = _unembed(params, spec, x[:, 0, :])
    if ensemble > 1:
        logits = logits.view(ensemble, -1, logits.shape[-1]).mean(0)
    return logits, cache_k, cache_v


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
):
    """``n_steps`` decode steps with on-device finish accounting.

    After a row samples its EOS or its ``budget`` reaches zero its ``live``
    flag drops: it stops sampling (its token freezes), stops writing cache
    and stops advancing ``lengths`` — with no host read inside the chunk.
    ``sample_fn(logits_f32 [B, V], live [B], carry) -> (next [B], carry,
    aux)`` supplies sampling; ``aux`` tuples are stacked over steps.

    Member-stacked params run all M·S rows in one step (the JAX engine's
    members branch); ``ensemble`` is passed to :func:`decode_step`.

    Returns ``(tokens [B, n_steps], valid [B, n_steps] bool, n_valid [B],
    live, budget, cache_k, cache_v, lengths, sample_carry, aux)``."""
    tok, lens, lv, bud = token, lengths, live, budget
    toks, valids, auxs = [], [], []
    for _ in range(n_steps):
        pos = torch.where(lv, lens, torch.zeros_like(lens))
        logits, cache_k, cache_v = decode_step(params, spec, tok, pos, cache_k, cache_v,
                                               write_mask=lv, plain_attention=plain_attention,
                                               ensemble=ensemble)
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


def forward_logits(params: Params, spec: ModelSpec, tokens: torch.Tensor) -> torch.Tensor:
    """Full-sequence logits [B, T, V] f32 with no KV cache (the eval forward
    and the cache-free ground truth for prefill/decode consistency)."""
    _dense_only(spec)
    b, t = tokens.shape
    positions = torch.arange(t, device=tokens.device)
    x = _embed(params, spec, tokens, positions)
    cos, sin = _rope(spec, tokens.device)
    mask = causal_mask(t, t, window=spec.sliding_window, device=tokens.device)

    def attend(q, k, v):
        if spec.pos == "rope":
            q = apply_rope(q, cos, sin, positions)
            k = apply_rope(k, cos, sin, positions)
        return attention(q, k, v, mask), k, v

    for l in range(spec.n_layers):
        x = _block(x, _layer(params["blocks"], l), spec, attend)
    return _unembed(params, spec, _final_norm(params, spec, x))


def init_cache(spec: ModelSpec, batch: int, dtype=None, device=None):
    """Preallocated KV cache: ``[L, B, K, max_seq, hd]`` × 2, zeroed. At
    llama-3-8b widths with an 8192 window that is 1.07 GB per slot in bf16."""
    dt = getattr(torch, dtype) if isinstance(dtype, str) else (dtype or _dtype(spec))
    shape = (spec.n_layers, batch, spec.n_kv_heads, spec.max_seq, spec.head_dim)
    return (torch.zeros(shape, dtype=dt, device=device),
            torch.zeros(shape, dtype=dt, device=device))
