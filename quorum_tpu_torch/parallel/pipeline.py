"""Pipeline-staged serving over the mesh's ``pp`` stages: the serving half
of the JAX package's ``parallel/pipeline.py`` (``_row_groups``,
``staged_decode_chunk``, ``staged_decode_loop``), over the port's ranks.

Stage s is one rank. It holds layers ``[s·L/pp, (s+1)·L/pp)`` of every
``[L, …]`` leaf and those layers' KV cache ``[L/pp, S, K, max_seq, hd]``
(``parallel/sharding.stage_layers``). The embedding, the final norm, the
head and sampling stay on stage 0, which is rank 0, the engine's own rank,
as the JAX program keeps them outside its ``shard_map``.

Decode. The slot batch splits into pp row groups of S/pp rows, the
pipeline's microbatches (:func:`row_groups`). At tick t stage s runs its
layers on row group ``(t − s) mod pp`` for that group's token
``(t − s) // pp``, then hands the hidden state ``[S/pp, 1, d]`` on to stage
s+1 and the last stage back to stage 0 (:meth:`Group.shift`, one
point-to-point hop; the positions and write mask ride in the same message,
:func:`_pack`). Stage 0 samples a group's token from the last stage's hidden
state at the start of the next tick and embeds it at once. A chunk of
``n_steps`` tokens takes ``pp·n_steps + pp − 1`` ticks. The schedule is
static: every rank knows on the host which ticks it has work at, so the
fill and drain ticks run nothing and send nothing (the JAX program runs
them masked, to keep its scan one static shape); a dispatch is still one
plan and, on NCCL, one graph replay per rank.

The outputs keep ``decode_chunk``'s contract bit for bit: the finish
accounting (EOS, budget, ``n_valid``) per group as the unstaged chunk does
it per row, and ``sample_fn`` called at full width with the group's rows
live and its logits in place (zeros elsewhere), only the group's rows of
the carry and the aux kept — every row-indexed sampler state advances once
per token, as in ``decode_chunk``. :func:`staged_decode_loop` chains C
chunks as ``decode_loop`` does (a chunk no row enters runs with every write
masked and its outputs zeroed).

Admission. A single-shot prefill runs stage by stage: stage 0 embeds the
prompt and runs K1 over its layers, writing its cache slice, and hands
``[B, T, d]`` on; the last stage hands it back, and stage 0 takes the last
positions through the final norm and the head (:func:`staged_prefill`,
:func:`follow_staged_prefill`).

Kernels. Each stage launches K2 once per layer per group step over its own
layers at full heads (pp cuts no heads), L/pp × pp·n_steps = L·n_steps
launches a stage per chunk, and K1 once per layer in each admission.
"""

from __future__ import annotations

import torch

from quorum_tpu_torch.models.model_config import ModelSpec
from quorum_tpu_torch.models.transformer import (_block, _dtype, _embed, _final_norm, _kv_layer,
                                                 _kv_put, _last_rows, _layer, _rope,
                                                 decode_step_blocks, decode_token_embed,
                                                 n_layers, unembed)
from quorum_tpu_torch.ops.attention import prefill_attention
from quorum_tpu_torch.ops.flash_attention import flash_prefill_attention
from quorum_tpu_torch.ops.rotary import apply_rope


def row_groups(pp: int, batch: int) -> int:
    """The row groups of a ``batch``-row slot batch: pp of them (the JAX
    package's ``_row_groups``, in its words)."""
    if batch % pp:
        raise ValueError(
            f"staged decode needs the slot batch ({batch}) divisible by "
            f"pp={pp} (the row groups are the pipeline's microbatches)")
    return pp


# ---- the hop's message -----------------------------------------------------

_INT_VIEW = {torch.bfloat16: torch.int16, torch.float16: torch.int16,
             torch.float32: torch.int32}


def _pack(x: torch.Tensor, pos: torch.Tensor, allow: torch.Tensor) -> torch.Tensor:
    """One hop's message: hidden states ``x`` [n, 1, d] and, in two more
    columns of the same tensor (their bits an integer view of it), each
    row's position and write flag: ``[n, d + 2]`` in x's dtype."""
    n, _, d = x.shape
    buf = torch.empty((n, d + 2), dtype=x.dtype, device=x.device)
    buf[:, :d] = x[:, 0]
    ints = buf.view(_INT_VIEW[x.dtype])
    ints[:, d] = pos.to(ints.dtype)
    ints[:, d + 1] = allow.to(ints.dtype)
    return buf


def _unpack(buf: torch.Tensor):
    """``(x [n, 1, d], pos int32 [n], allow bool [n])`` of :func:`_pack`."""
    d = buf.shape[1] - 2
    ints = buf.view(_INT_VIEW[buf.dtype])
    return (buf[:, None, :d], ints[:, d].to(torch.int32), ints[:, d + 1] != 0)


def _message_like(spec: ModelSpec, rows: int, device) -> torch.Tensor:
    return torch.empty((rows, spec.d_model + 2), dtype=_dtype(spec), device=device)


def _check_positions(spec: ModelSpec) -> None:
    width = torch.iinfo(_INT_VIEW[_dtype(spec)]).max
    if spec.max_seq > width + 1:
        raise ValueError(f"max_seq={spec.max_seq} does not fit the staged hop's {spec.dtype} "
                         f"position column (at most {width + 1})")


# ---- admission -------------------------------------------------------------


def _stage_prefill(blocks, spec: ModelSpec, x: torch.Tensor, lengths: torch.Tensor,
                   cache_k, cache_v, slot: int, plain_attention: bool) -> torch.Tensor:
    """A stage's layers over prompt hidden states ``x`` [B, T, d], writing
    K/V of every position into cache row ``slot`` of its cache slice."""
    b, t, _ = x.shape
    dev = x.device
    positions = torch.arange(t, device=dev)
    cos, sin = _rope(spec, dev)
    attn_fn = prefill_attention if plain_attention else flash_prefill_attention
    moe_mask = (torch.arange(t, device=dev)[None, :] < lengths[:, None]) if spec.is_moe else None
    dst = slice(slot, slot + 1)
    for l in range(n_layers(blocks)):
        def attend(q, k, v, l=l):
            if spec.pos == "rope":
                q = apply_rope(q, cos, sin, positions)
                k = apply_rope(k, cos, sin, positions)
            _kv_put(_kv_layer(cache_k, l), (dst, slice(None), slice(None, t)), k)
            _kv_put(_kv_layer(cache_v, l), (dst, slice(None), slice(None, t)), v)
            return attn_fn(q, k, v, lengths, window=spec.sliding_window), k, v

        x = _block(x, _layer(blocks, l), spec, attend, token_mask=moe_mask)
    return x


def staged_prefill(params, spec: ModelSpec, tokens: torch.Tensor, lengths: torch.Tensor,
                   cache_k, cache_v, slot: int, mesh, plain_attention: bool = False):
    """Stage 0's single-shot admission of ``tokens`` [1, T] (right-padded,
    ``lengths`` [1]) into cache row ``slot``: embed, its layers, the hop to
    stage 1, the last stage's hidden states back, then the final norm and
    the head at the last prompt position. Returns (logits [1, V] f32,
    cache_k, cache_v), as ``transformer.prefill``."""
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = _embed(params, spec, tokens, positions)
    x = _stage_prefill(params["blocks"], spec, x, lengths, cache_k, cache_v, slot,
                       plain_attention)
    mesh.pp.shift(x.contiguous())
    x = mesh.pp.shift(like=x)
    last = _last_rows(_final_norm(params, spec, x), lengths, 0)
    return unembed(params, spec, last), cache_k, cache_v


def follow_staged_prefill(blocks, spec: ModelSpec, shape: tuple, lengths: torch.Tensor,
                          cache_k, cache_v, slot: int, mesh, plain_attention: bool = False):
    """A later stage's half of :func:`staged_prefill`: the previous stage's
    hidden states ``shape`` = [B, T, d] in, its layers, on to the next."""
    like = torch.empty(shape, dtype=_dtype(spec), device=lengths.device)
    x = mesh.pp.shift(like=like)
    x = _stage_prefill(blocks, spec, x, lengths, cache_k, cache_v, slot, plain_attention)
    mesh.pp.shift(x.contiguous())


# ---- decode ----------------------------------------------------------------


def _active(stage: int, t: int, pp: int, n_steps: int) -> bool:
    """Whether stage ``stage`` has a group step at tick ``t``."""
    return 0 <= t - stage < pp * n_steps


def _group_rows(rel: int, pp: int, sg: int) -> tuple[slice, int, int]:
    """(rows, group, token index) of the group step ``rel`` ticks in."""
    g = rel % pp
    return slice(g * sg, (g + 1) * sg), g, rel // pp


def staged_decode_chunk(params, spec: ModelSpec, mesh, n_steps: int, token, lengths, live,
                        budget, eos, cache_k, cache_v, sample_fn, sample_carry,
                        plain_attention: bool = False):
    """Stage 0's pipeline-staged decode chunk: ``transformer.decode_chunk``'s
    contract and outputs bit for bit (the module docstring), with
    ``cache_k``/``cache_v`` this stage's slice. Returns ``(tokens [B,
    n_steps], valid [B, n_steps], n_valid [B], live, budget, cache_k,
    cache_v, lengths, sample_carry, aux)``."""
    _check_positions(spec)
    pp = mesh.pp_size
    b = token.shape[0]
    sg = b // row_groups(pp, b)
    blocks = params["blocks"]
    tok, lens, lv, bud = token.clone(), lengths.clone(), live.clone(), budget.clone()
    toks = torch.zeros((b, n_steps), dtype=token.dtype, device=token.device)
    valid = torch.zeros((b, n_steps), dtype=torch.bool, device=token.device)
    aux_steps: list[list | None] = [None] * n_steps
    carry = sample_carry
    like = _message_like(spec, sg, token.device)

    def sample(buf, rel):
        nonlocal carry
        rows, _, k = _group_rows(rel, pp, sg)
        y = _unpack(buf)[0]
        logits = torch.zeros((b, spec.vocab_size), dtype=torch.float32, device=token.device)
        logits[rows] = unembed(params, spec, _final_norm(params, spec, y)[:, 0, :]).float()
        cur_live, cur_lens, cur_tok = lv[rows], lens[rows], tok[rows]
        lv_full = torch.zeros_like(lv)
        lv_full[rows] = cur_live
        nxt, new_carry, aux = sample_fn(logits, lv_full, carry)
        carry = tuple(_merge_rows(n, o, rows) for n, o in zip(new_carry, carry))
        nxt_g = torch.where(cur_live, nxt[rows].to(tok.dtype), cur_tok)
        bud_g = bud[rows] - cur_live.to(bud.dtype)
        fin = cur_live & ((nxt_g == eos[rows]) | (bud_g <= 0))
        toks[rows, k] = nxt_g
        valid[rows, k] = cur_live
        tok[rows] = nxt_g
        lens[rows] = cur_lens + cur_live.to(lens.dtype)
        bud[rows] = bud_g
        lv[rows] = cur_live & ~fin
        if aux_steps[k] is None:
            aux_steps[k] = [torch.zeros_like(a) for a in aux]
        for i, a in enumerate(aux):
            if a.dim() and a.shape[0] == b:
                aux_steps[k][i][rows] = a[rows]
            else:  # a per-step total: the groups' parts add up
                aux_steps[k][i] += a

    n_ticks = pp * n_steps + pp - 1
    for t in range(n_ticks):
        out = None
        if _active(0, t, pp, n_steps):
            rows, _, _ = _group_rows(t, pp, sg)
            cur_live = lv[rows]
            pos = torch.where(cur_live, lens[rows], torch.zeros_like(lens[rows]))
            x = decode_token_embed(params, spec, tok[rows], pos)
            x, _, _ = decode_step_blocks(blocks, spec, x, pos, cache_k[:, rows],
                                         cache_v[:, rows], write_mask=cur_live,
                                         plain_attention=plain_attention)
            out = _pack(x, pos, cur_live)
        back = _active(pp - 1, t, pp, n_steps)
        got = mesh.pp.shift(out, like if back else None)
        if back:
            sample(got, t - (pp - 1))
    n_valid = valid.to(torch.int32).sum(dim=1)
    aux = (tuple(torch.stack(col) for col in zip(*aux_steps))
           if aux_steps and aux_steps[0] else ())
    return (toks, valid, n_valid, lv, bud, cache_k, cache_v, lens, carry, aux)


def _merge_rows(new: torch.Tensor, old: torch.Tensor, rows: slice) -> torch.Tensor:
    out = old.clone()
    out[rows] = new[rows]
    return out


def staged_decode_loop(params, spec: ModelSpec, mesh, n_steps: int, n_chunks: int, token,
                       lengths, live, budget, eos, cache_k, cache_v, sample_fn, sample_carry,
                       plain_attention: bool = False):
    """``n_chunks`` staged chunks in one dispatch, ``transformer.decode_loop``'s
    contract and outputs: ``(toks [n_chunks, B, n_steps], n_valid [n_chunks,
    B], token [B], live, budget, cache_k, cache_v, lengths, sample_carry,
    aux)``, every aux leaf with a leading ``n_chunks`` axis."""
    tok, lens, lv, bud = token, lengths, live, budget
    toks_all, valid_all, auxs = [], [], []
    for _ in range(n_chunks):
        entered = lv.any()
        (toks, _valid, n_valid, lv, bud, cache_k, cache_v, lens, sample_carry,
         aux) = staged_decode_chunk(params, spec, mesh, n_steps, tok, lens, lv, bud, eos,
                                    cache_k, cache_v, sample_fn, sample_carry,
                                    plain_attention=plain_attention)
        tok = toks[:, -1]
        toks_all.append(torch.where(entered, toks, torch.zeros_like(toks)))
        valid_all.append(n_valid)
        auxs.append(tuple(torch.where(entered, a, torch.zeros_like(a)) for a in aux))
    aux = tuple(torch.stack(col) for col in zip(*auxs)) if auxs and auxs[0] else ()
    return (torch.stack(toks_all), torch.stack(valid_all), tok, lv, bud, cache_k, cache_v, lens,
            sample_carry, aux)


def follow_staged_decode(blocks, spec: ModelSpec, mesh, n_steps: int, n_chunks: int,
                         batch: int, cache_k, cache_v, plain_attention: bool = False) -> int:
    """A later stage's half of a staged dispatch of ``n_chunks`` chunks of
    ``n_steps`` steps over a ``batch``-row slot batch: at each tick where it
    has a group step, the previous stage's message in, its layers over the
    group's rows of its cache slice, the message on. Returns the group
    steps it ran."""
    pp, s = mesh.pp_size, mesh.pp_rank
    sg = batch // row_groups(pp, batch)
    like = _message_like(spec, sg, cache_k.device)
    ran = 0
    for _ in range(n_chunks):
        buf = None
        for t in range(pp * n_steps + pp - 1):
            out = None
            if _active(s, t, pp, n_steps):
                rows, _, _ = _group_rows(t - s, pp, sg)
                x, pos, allow = _unpack(buf)
                y, _, _ = decode_step_blocks(blocks, spec, x, pos, cache_k[:, rows],
                                             cache_v[:, rows], write_mask=allow,
                                             plain_attention=plain_attention)
                out = _pack(y, pos, allow)
                ran += 1
            buf = mesh.pp.shift(out, like if _active(s, t + 1, pp, n_steps) else None)
    return ran
