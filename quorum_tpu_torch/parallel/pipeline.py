"""Pipeline parallelism over the mesh's ``pp`` stages: the JAX package's
``parallel/pipeline.py`` over the port's ranks — staged serving
(``_row_groups``, ``staged_decode_chunk``, ``staged_decode_loop``) and,
at the end of this module, the GPipe train step (``pp_loss_fn``,
``pp_train_init``, ``make_pp_train_step``).

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

Forwards. An embedding or scoring forward runs the same route with no
cache written (:func:`staged_forward_hidden`, :func:`follow_staged_forward`):
stage 0 embeds, each stage runs its layers with K1, and the last stage's
hidden states come back to stage 0 for the final norm (its pooling or
unembed follow there). One sub-batch at a time fills the pipeline.

Kernels. Each stage launches K2 (K2q8 on an int8 cache: a side is then the
``(q8, scale)`` pair, each half sliced by row group alike, :func:`_rows_of`)
once per layer per group step over its own layers at full heads (pp cuts
no heads), L/pp × pp·n_steps = L·n_steps launches a stage per chunk, and K1
once per layer in each admission and each forward.
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint

from quorum_tpu_torch.models.model_config import ModelSpec
from quorum_tpu_torch.models.transformer import (_block, _dtype, _embed, _final_norm, _kv_layer,
                                                 _kv_put, _last_rows, _layer, _rope,
                                                 decode_step_blocks, decode_token_embed,
                                                 n_layers, unembed)
from quorum_tpu_torch.ops.attention import attention, causal_mask, prefill_attention
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
                   cache_k, cache_v, slot: int | None, plain_attention: bool) -> torch.Tensor:
    """A stage's layers over prompt hidden states ``x`` [B, T, d], writing
    K/V of every position into cache row ``slot`` of its cache slice (an
    int8 slice stores them quantized); a forward (``slot`` None) writes
    nothing."""
    b, t, _ = x.shape
    dev = x.device
    positions = torch.arange(t, device=dev)
    cos, sin = _rope(spec, dev)
    attn_fn = prefill_attention if plain_attention else flash_prefill_attention
    moe_mask = (torch.arange(t, device=dev)[None, :] < lengths[:, None]) if spec.is_moe else None
    dst = None if slot is None else slice(slot, slot + 1)
    for l in range(n_layers(blocks)):
        def attend(q, k, v, l=l):
            if spec.pos == "rope":
                q = apply_rope(q, cos, sin, positions)
                k = apply_rope(k, cos, sin, positions)
            if slot is not None:
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


# ---- forwards --------------------------------------------------------------


def staged_forward_hidden(params, spec: ModelSpec, tokens: torch.Tensor,
                          lengths: torch.Tensor, mesh,
                          plain_attention: bool = False) -> torch.Tensor:
    """Stage 0's cache-free forward (embeddings and scoring): embed
    ``tokens`` [B, T] (right-padded, ``lengths`` [B]), run its layers with K1,
    hand ``[B, T, d]`` on, take the last stage's hidden states back and
    apply the final norm: ``transformer.forward_hidden``'s output, stage by
    stage, with no cache written (one sub-batch fills the pipeline)."""
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = _embed(params, spec, tokens, positions)
    x = _stage_prefill(params["blocks"], spec, x, lengths, None, None, None, plain_attention)
    mesh.pp.shift(x.contiguous())
    x = mesh.pp.shift(like=x)
    return _final_norm(params, spec, x)


def follow_staged_forward(blocks, spec: ModelSpec, shape: tuple, lengths: torch.Tensor, mesh,
                          plain_attention: bool = False) -> None:
    """A later stage's half of :func:`staged_forward_hidden`: the previous
    stage's hidden states ``shape`` = [B, T, d] in, its layers (K1), on to
    the next stage."""
    like = torch.empty(shape, dtype=_dtype(spec), device=lengths.device)
    x = mesh.pp.shift(like=like)
    x = _stage_prefill(blocks, spec, x, lengths, None, None, None, plain_attention)
    mesh.pp.shift(x.contiguous())


# ---- decode ----------------------------------------------------------------


def _rows_of(cache, rows: slice):
    """Rows ``rows`` of a stage's cache side (a view): a tensor ``[L, S,
    …]``, or the int8 ``(q8, scale)`` pair, each cut alike."""
    if isinstance(cache, tuple):
        return tuple(c[:, rows] for c in cache)
    return cache[:, rows]


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
            x, _, _ = decode_step_blocks(blocks, spec, x, pos, _rows_of(cache_k, rows),
                                         _rows_of(cache_v, rows), write_mask=cur_live,
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
    like = _message_like(spec, sg, (cache_k[0] if isinstance(cache_k, tuple) else cache_k).device)
    ran = 0
    for _ in range(n_chunks):
        buf = None
        for t in range(pp * n_steps + pp - 1):
            out = None
            if _active(s, t, pp, n_steps):
                rows, _, _ = _group_rows(t - s, pp, sg)
                x, pos, allow = _unpack(buf)
                y, _, _ = decode_step_blocks(blocks, spec, x, pos, _rows_of(cache_k, rows),
                                             _rows_of(cache_v, rows), write_mask=allow,
                                             plain_attention=plain_attention)
                out = _pack(y, pos, allow)
                ran += 1
            buf = mesh.pp.shift(out, like if _active(s, t + 1, pp, n_steps) else None)
    return ran


# ---- training: the GPipe step (the JAX package's pp_loss_fn and
# make_pp_train_step) ---------------------------------------------------------


def _check_pp_mesh(mesh, spec: ModelSpec) -> int:
    """The pipelined step's mesh is dp × pp: tp or sp beside pp, or pp not
    dividing the layers, is refused in the JAX package's words. Returns
    pp."""
    shape = mesh.mesh.shape if hasattr(mesh, "mesh") else mesh.shape
    npp = shape["pp"]
    if shape["tp"] != 1 or shape["sp"] != 1:
        raise ValueError(
            "the pipelined path composes with dp only; build the mesh as "
            f"dp×pp (got tp={shape['tp']}, sp={shape['sp']})")
    if spec.n_layers % npp:
        raise ValueError(f"n_layers={spec.n_layers} must divide into pp={npp} stages")
    return npp


def _hop(mesh, out, like, reverse: bool = False):
    """The step's hop (:meth:`Group.shift`); on a one-stage mesh the stage
    hands its output to itself."""
    if mesh.pp_size == 1:
        return out if like is not None else None
    return mesh.pp.shift(out, like, reverse=reverse)


def _stage_blocks(blocks, spec: ModelSpec, x: torch.Tensor, n: int, remat: bool) -> torch.Tensor:
    """A stage's ``n`` layers over hidden states ``x`` [mb, T, d] with the
    plain causal attention (the training forward's: K1 has no backward),
    each layer under ``torch.utils.checkpoint`` with ``remat``."""
    t, dev = x.shape[1], x.device
    positions = torch.arange(t, device=dev)
    cos, sin = _rope(spec, dev)
    mask = causal_mask(t, t, window=spec.sliding_window, device=dev)

    def attend(q, k, v):
        if spec.pos == "rope":
            q = apply_rope(q, cos, sin, positions)
            k = apply_rope(k, cos, sin, positions)
        return attention(q, k, v, mask), k, v

    def layer(x, block):
        return _block(x, block, spec, attend)

    for l in range(n):
        block = _layer(blocks, l)
        if remat:
            x = torch.utils.checkpoint.checkpoint(layer, x, block, use_reentrant=False)
        else:
            x = layer(x, block)
    return x


def _nll_sum(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Sum of the next-token nll over non-pad targets (``trainer.loss_fn``'s
    numerator)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    return torch.sum(nll * (targets != 0).float())


def pp_value_and_grad(params, spec: ModelSpec, tokens: torch.Tensor, mesh, n_micro: int = 2,
                      remat: bool = True, comm: dict | None = None):
    """One rank's ``(loss, grads)`` of :func:`pp_loss_fn`: GPipe over
    ``n_micro`` microbatches of ``tokens`` [B, T] (this dp group's rows;
    every stage of the group is given them, stage 0 alone reads them).

    The schedule is explicit and the same on every rank. Forward, tick
    ``t`` of ``n_micro + pp − 1``: stage s runs its layers on microbatch
    ``t − s`` (stage 0 embeds it first) and every rank makes one hop
    (:meth:`Group.shift`): the stage's output on to the next stage, the
    last stage's back to stage 0, which at once runs the final norm, the
    head and the microbatch's loss and its backward down to the received
    hidden state. Backward, ticks in reverse: each rank first computes the
    gradient of what it received at forward tick ``t`` (stage 0: the
    head's, kept from the forward; a later stage: its layers' backward for
    that microbatch from the output gradient it received a tick before),
    then one reverse hop sends it to the stage it came from and receives
    the gradient of what this rank sent at ``t`` (stage 0 then runs its
    layers' and the embedding's backward for that microbatch). Every rank
    runs backward on its own graph only, from the gradients it receives.

    The loss is the sum of the microbatches' nll over the count of non-pad
    targets of the whole global batch (stage 0's count all-reduced over
    dp), as ``trainer.loss_fn(mesh=)`` divides it; it is summed over dp and
    then broadcast from stage 0, so every rank returns it. The gradients
    (a tree like ``params``: the stage's layers, and on stage 0 the
    embedding, the final norm and the head) are summed over dp in float32
    (``trainer.dp_sum_grads``; ``comm`` accumulates its seconds and
    bytes)."""
    from quorum_tpu_torch.training.optim import tree_map
    from quorum_tpu_torch.training.trainer import _grad_leaves, dp_sum_grads

    npp = _check_pp_mesh(mesh, spec)
    s = mesh.pp_rank
    b, t_len = tokens.shape
    if b % n_micro:
        raise ValueError(f"batch {b} must divide into {n_micro} microbatches")
    mb, t = b // n_micro, t_len - 1
    dev = tokens.device
    n = n_layers(params["blocks"])
    grads = tree_map(torch.zeros_like, params)
    leaves = _grad_leaves(params, grads)
    inp, targets = tokens[:, :-1], tokens[:, 1:]
    like = torch.empty((mb, t, spec.d_model), dtype=_dtype(spec), device=dev)
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    if s == 0:
        count = (targets != 0).float().sum()
        count = torch.clamp_min(mesh.dp.all_reduce(count.reshape(1).clone())[0], 1.0)
        positions = torch.arange(t, device=dev)

    def active(stage: int, tick: int) -> bool:
        return 0 <= tick - stage < n_micro

    def rows(m: int) -> slice:
        return slice(m * mb, (m + 1) * mb)

    ticks = n_micro + npp - 1
    received: dict[int, torch.Tensor] = {}  # microbatch -> the stage's input leaf (s > 0)
    outputs: dict[int, torch.Tensor] = {}   # microbatch -> the stage's output, in its graph
    heads: dict[int, torch.Tensor] = {}     # microbatch -> d loss / d last stage's output
    with torch.enable_grad():
        buf = None
        for tick in range(ticks):
            out = None
            if active(s, tick):
                m = tick - s
                if s == 0:
                    x = _embed(leaves, spec, inp[rows(m)], positions)
                else:
                    x = received[m] = buf.requires_grad_()
                outputs[m] = _stage_blocks(leaves["blocks"], spec, x, n, remat)
                out = outputs[m].detach().contiguous()
            got = _hop(mesh, out, like if active((s - 1) % npp, tick) else None)
            if s == 0 and got is not None:
                m = tick - (npp - 1)
                h = got.requires_grad_()
                part = _nll_sum(unembed(leaves, spec, _final_norm(leaves, spec, h)),
                                targets[rows(m)]) / count
                part.backward()
                heads[m] = h.grad
                loss += part.detach()
            else:
                buf = got
        pending: dict[int, torch.Tensor] = {}  # microbatch -> d loss / d this stage's output
        for tick in reversed(range(ticks)):
            back = None
            if s == 0:
                back = heads.pop(tick - (npp - 1), None)
            elif active(s, tick + 1):
                m = tick + 1 - s
                torch.autograd.backward(outputs.pop(m), pending.pop(m))
                back = received.pop(m).grad
            got = _hop(mesh, back, like if active(s, tick) else None, reverse=True)
            if got is not None:
                if s == 0:
                    torch.autograd.backward(outputs.pop(tick), got)
                else:
                    pending[tick - s] = got
    dp_sum_grads(grads, mesh, comm)
    if s == 0:
        loss = mesh.dp.all_reduce(loss.reshape(1).clone())[0]
    loss = mesh.pp.broadcast(loss.reshape(1).clone(), 0)[0]
    return loss, grads


def pp_loss_fn(params, spec: ModelSpec, tokens, mesh, n_micro: int, remat: bool = True):
    """Mean next-token cross-entropy through the pipeline (the same contract
    as ``trainer.loss_fn``): :func:`pp_value_and_grad`'s loss, which every
    rank of the mesh calls and returns."""
    return pp_value_and_grad(params, spec, torch.as_tensor(tokens), mesh, n_micro, remat)[0]


def pp_train_init(spec: ModelSpec, mesh, *, seed: int = 0, optimizer=None):
    """This rank's TrainState of a pp (× dp) mesh: its stage's cut of the
    seeded init (``models/init.init_params_shard``: its layers, and on
    stage 0 the embedding, the final norm and the head), the optimizer's
    zero state over it, step 0 (the JAX package's ``pp_train_init``)."""
    from quorum_tpu_torch.training.trainer import train_init

    _check_pp_mesh(mesh, spec)
    return train_init(spec, seed=seed, optimizer=optimizer, mesh=mesh)


def make_pp_train_step(spec: ModelSpec, mesh, *, n_micro: int = 2, optimizer=None,
                       remat: bool = True, grads_hook=None):
    """One pipelined AdamW step, ``step(state, tokens [B, T]) → (state,
    loss)`` (the JAX package's ``make_pp_train_step``): every rank of the
    mesh calls it in the same order with its dp group's rows;
    :func:`pp_value_and_grad`, then the optimizer's update where each
    stage's weights live (in place), clipping's norm summed over the
    stages (``training/optim.global_norm``). ``grads_hook(state, loss,
    grads)`` runs between the two; ``step.comm`` holds the dp all-reduce's
    seconds and bytes."""
    from quorum_tpu_torch.training.trainer import TrainState, make_optimizer, tp_cut_flags

    _check_pp_mesh(mesh, spec)
    opt = optimizer or make_optimizer()
    cut: list = []

    def step(state, tokens):
        tokens = torch.as_tensor(tokens).to(device=mesh.device, dtype=torch.long)
        loss, grads = pp_value_and_grad(state.params, spec, tokens, mesh, n_micro, remat,
                                        step.comm)
        if grads_hook is not None:
            grads_hook(state, loss, grads)
        if not cut:
            cut.append(tp_cut_flags(state.params, spec, mesh))
        opt_state = opt.update(grads, state.opt_state, state.params, mesh=mesh, cut=cut[0])
        return TrainState(state.params, opt_state, state.step + 1), loss

    step.comm = {"grad_allreduce_s": 0.0, "grad_allreduce_bytes": 0}
    return step
