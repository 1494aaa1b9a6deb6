"""Text embeddings from the serving engine's resident weights: the JAX
package's ``engine/embed.py``.

The same decoder weights that serve chat give the embeddings (no second
model, no second copy in device memory): ``forward_hidden`` runs the block
stack without the unembed, the final-norm hidden states are mean-pooled in
float32 over each input's valid positions, and the mean is L2-normalised
(floor 1e-9) — unit vectors, as the OpenAI contract has them.

A pure function of (weights, tokens, lengths): no slot, no KV cache, no
scheduler. Inputs pad to the JAX package's power-of-two buckets (rows up
to ``MAX_BATCH``, positions from 16 up to ``max_seq``); an input longer
than ``max_seq`` keeps its head, an empty one is one pad-id token. The
forward runs eagerly on the caller's thread: on the card on the engine's
forward stream (``engine.forward_scope``), through K1 for attention, and
the host waits only to fetch the pooled vectors. Stacked engines select
one weight set with ``member_params``; int8 engines run unchanged.

A request whose padded batch holds more than ``FORWARD_TOKENS`` tokens
(``FORWARD_TOKENS_BUSY`` while the engine decodes: :func:`forward_budget`)
runs as whole-row sub-batches (rows sorted by length, each sub-batch at
its own buckets), so one 64-input request at 2 048 tokens never holds
more than a budget's activations. A row's vector does not depend on its
sub-batch: attention is causal and per row, and pooling reads only the
row's valid positions. MoE layers are the exception to row independence —
a pick drops when its expert's buffer is full, and the buffer is shared
by every token of the forward — so an MoE spec whose capacity can bind
(``moe_capacity_factor · experts_per_token < n_experts``) is never split:
its rows see the drops of the unsplit call, as in the JAX package. Its
forward is bounded instead: the grouped MoE runs its expert buffers in
slices (``transformer.MOE_SLOT_ROWS``), and a request that pads to more
than ``MOE_FORWARD_TOKENS`` tokens is refused (:func:`forward_tokens_error`,
a 400 at the API). Where the capacity cannot bind (every expert's buffer
holds every token: no pick ever drops), the split is exact and applies.
"""

from __future__ import annotations

import torch

from quorum_tpu_torch.models.transformer import forward_hidden, member_params

# Requests above this many inputs are refused at the API layer; buckets stop
# here.
MAX_BATCH = 64
# Padded tokens (rows × positions) of one forward; a larger request runs as
# whole-row sub-batches. At llama-3-8b widths one forward's largest
# activation (the MLP's f32 gate and up products) is 16 384 × 14 336 × 4 B
# = 0.94 GB each.
FORWARD_TOKENS = 16384
# Padded tokens of one forward of an MoE spec whose capacity can bind (never
# split): 64 inputs of 2 048. At mixtral-8x7b widths its largest activation
# is the float32 output of every pick, 131 072 × 2 × 4 096 × 4 B = 4.3 GB.
MOE_FORWARD_TOKENS = 131072
# The budget while the engine holds live rows: shorter forward kernels keep
# the decode ring's kernels from waiting as long behind them. Beside a
# 64-input llama-3-8b forward on an H100 (700 W), a live stream's longest
# gap read 281 ms at 16 384, 226 at 4 096 and 192 at 2 048, for a forward
# 2.5 % and 11 % longer (scripts/torch_ring_priority_ab.py --budgets).
FORWARD_TOKENS_BUSY = 4096


def _batch_bucket(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, MAX_BATCH)


def _seq_bucket(n: int, max_seq: int) -> int:
    b = 16
    while b < n:
        b *= 2
    return min(b, max_seq)


def moe_split_exact(spec) -> bool:
    """True when no MoE pick can drop (each expert's buffer holds every
    token of a forward), so splitting a batch cannot change a row."""
    if not spec.is_moe:
        return True
    # capacity = min(n, ceil(int(cf·k·n) / E)) is n once cf·k >= E, and a
    # token picks k distinct experts: no expert ever gets more than n picks.
    return spec.moe_capacity_factor * spec.experts_per_token >= spec.n_experts


def forward_tokens_error(spec, lens: list[int]) -> str | None:
    """Why inputs of ``lens`` tokens cannot run as one request, or None:
    an MoE spec whose capacity can bind pads them to more than
    ``MOE_FORWARD_TOKENS`` tokens."""
    b, t = _batch_bucket(len(lens)), _seq_bucket(max(lens), spec.max_seq)
    if moe_split_exact(spec) or b * t <= MOE_FORWARD_TOKENS:
        return None
    return (f"{len(lens)} inputs pad to {b} x {t} = {b * t} tokens, over this model's "
            f"{MOE_FORWARD_TOKENS}-token forward (its expert capacity can drop picks, so "
            "a request is never split): send fewer or shorter inputs")


def forward_budget(engine) -> int:
    """The padded tokens a forward of ``engine`` may hold: the smaller
    ``FORWARD_TOKENS_BUSY`` while it decodes live rows (read once, as a
    request starts), else ``FORWARD_TOKENS``."""
    return FORWARD_TOKENS_BUSY if engine.busy() else FORWARD_TOKENS


def row_groups(spec, lens: list[int], budget: int | None = None) -> list[list[int]]:
    """Row indices of each forward: all rows at once when the padded batch
    fits ``budget`` (``FORWARD_TOKENS`` by default), or the spec's MoE
    capacity can bind, else rows by descending length, each group as many
    as fit the budget at the seq bucket of its longest row. A ValueError
    where :func:`forward_tokens_error` refuses ``lens``."""
    refused = forward_tokens_error(spec, lens)
    if refused:
        raise ValueError(refused)
    budget = FORWARD_TOKENS if budget is None else budget
    n = len(lens)
    t = _seq_bucket(max(lens), spec.max_seq)
    if _batch_bucket(n) * t <= budget or not moe_split_exact(spec):
        return [list(range(n))]
    order = sorted(range(n), key=lambda i: -lens[i])
    groups: list[list[int]] = []
    for i in order:
        g = groups[-1] if groups else None
        if g is not None and _batch_bucket(len(g) + 1) * _seq_bucket(
                lens[g[0]], spec.max_seq) <= budget:
            g.append(i)
        else:
            groups.append([i])
    return groups


def padded_batch(spec, token_lists: list[list[int]], rows: list[int], device,
                 min_len: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """(tokens [b_bucket, t_bucket] long, lengths [b_bucket] int32) on
    ``device`` for ``rows`` of ``token_lists``; pad rows have length 0 and
    a row's length is at least ``min_len``."""
    lens = [max(len(token_lists[i]), min_len) for i in rows]
    b, t = _batch_bucket(len(rows)), _seq_bucket(max(lens), spec.max_seq)
    tokens = torch.zeros((b, t), dtype=torch.long)
    lengths = torch.zeros((b,), dtype=torch.int32)
    for j, i in enumerate(rows):
        ids = token_lists[i]
        tokens[j, : len(ids)] = torch.as_tensor(ids, dtype=torch.long)
        lengths[j] = lens[j]
    return tokens.to(device), lengths.to(device)


def engine_params(engine, member: int):
    """The weight set a forward runs: member ``member`` of a stacked engine
    (views, no copy), the engine's params otherwise. A multi-rank engine's
    params are one rank's shard: refused."""
    if getattr(engine, "mesh", None) is not None:
        raise ValueError("embeddings and scoring: not yet on a multi-rank engine")
    if engine.members > 1 or engine.ensemble > 1:
        return member_params(engine.params, member)
    return engine.params


def embed_token_batch(engine, token_lists: list[list[int]], member: int = 0,
                      plain_attention: bool = False) -> torch.Tensor:
    """Unit-norm embeddings ``[n, d_model]`` float32 on the host for
    ``token_lists``; inputs longer than ``max_seq`` keep their FIRST
    ``max_seq`` tokens. ``plain_attention`` runs the plain masked attention
    in place of K1 (the ground truth K1 is held against on the card)."""
    spec = engine.spec
    if not token_lists:
        return torch.zeros((0, spec.d_model), dtype=torch.float32)
    if len(token_lists) > MAX_BATCH:
        raise ValueError(f"at most {MAX_BATCH} inputs per request")
    clipped = [list(t[: spec.max_seq]) for t in token_lists]
    params = engine_params(engine, member)
    out = torch.empty((len(clipped), spec.d_model), dtype=torch.float32)
    with engine.forward_scope():
        for rows in row_groups(spec, [max(len(t), 1) for t in clipped],
                               forward_budget(engine)):
            # An empty input is one pad-id token (id 0): length 1.
            tokens, lengths = padded_batch(spec, clipped, rows, engine.device, min_len=1)
            h = forward_hidden(params, spec, tokens, lengths,
                               plain_attention=plain_attention)  # [b, t, D]
            valid = (torch.arange(tokens.shape[1], device=tokens.device)[None, :]
                     < lengths[:, None]).to(torch.float32)
            pooled = (h.float() * valid[..., None]).sum(dim=1)
            pooled = pooled / lengths.clamp(min=1).to(torch.float32)[:, None]
            norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
            vecs = (pooled / norm.clamp(min=1e-9))[: len(rows)].cpu()
            out[torch.as_tensor(rows)] = vecs
    return out
