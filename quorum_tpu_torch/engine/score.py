"""Teacher-forced prompt scoring from the serving engine's resident weights:
the JAX package's ``engine/score.py``.

The legacy ``/completions`` surface with ``echo=true, logprobs=k`` returns
the log-probability of every PROMPT token under the model, the contract
eval harnesses use for perplexity and multiple-choice scoring. One causal
forward gives the next-token distribution at every position, so token j's
logprob is read from position j−1's row; the first token has no prefix and
is reported as ``None``.

Same integration as embeddings (``engine/embed.py``): a pure function of
(weights, tokens, lengths) run eagerly on the caller's thread, on the card
on the engine's forward stream with K1 for attention, in the same buckets
and the same whole-row sub-batches of at most ``FORWARD_TOKENS`` tokens
(``FORWARD_TOKENS_BUSY`` beside live decode; never for an MoE spec whose
capacity can bind, whose request is bounded by ``MOE_FORWARD_TOKENS``
instead; see there). Each row's result equals the unsplit call's.

The ``[B, T, V]`` float32 log-softmax is never held whole: the unembed, the
log-softmax, the gather of each next token's logprob and the top-k run over
chunks of at most ``SCORE_CHUNK_TOKENS`` (row, position) pairs of the final
hidden states, and only the gathered logprobs and the top-k leave the card.
At V = 128 256 a chunk's logits and log-softmax are 2 × 1.05 GB in f32,
where one 64 × 2 048 request's whole tensor would be 67 GB.

On a multi-rank engine (``engine/embed.py``'s section) the forward runs on
rank 0's dp group, with the ring parked, and each chunk's unembed on its
vocab-cut head, all-gathered over tp: every rank of rank 0's tp group
holds one chunk's whole ``[rows, chunk, V]`` logits at a time, as one card
does, and rank 0 alone takes the log-softmax, the gather and the top-k.
Under sp the final hidden states are all-gathered over sp (``[b, t, D]``,
at most ``FORWARD_TOKENS`` × D) and only the sp rank 0's tp group unembeds:
the chunked unembed, not the gather, bounds the memory at V = 128 256.
Under pp stage 0 holds the head and scores alone.
"""

from __future__ import annotations

import torch

from quorum_tpu_torch.engine.embed import (MAX_BATCH, engine_params, forward_budget,
                                           forward_member, padded_batch, row_groups)
from quorum_tpu_torch.models.transformer import forward_hidden, unembed

# (row, position) pairs of logits per unembed chunk.
SCORE_CHUNK_TOKENS = 2048


def score_token_batch(engine, token_lists: list[list[int]], member: int = 0,
                      top_k: int = 0, plain_attention: bool = False) -> list[dict]:
    """Per-prompt teacher-forced logprobs: one dict per prompt,
    ``{"token_logprobs": [None, f, ...], "top": [None, (ids, lps), ...]}``
    — ``top`` only when ``top_k`` > 0. Prompts longer than ``max_seq`` are
    the caller's to refuse (a truncated prompt would be mis-scored).
    ``plain_attention``: as :func:`embed.embed_token_batch`'s."""
    if not token_lists:
        return []
    if len(token_lists) > MAX_BATCH:
        raise ValueError(f"at most {MAX_BATCH} inputs per request")
    spec = engine.spec
    params = engine_params(engine, member)
    results: list[dict | None] = [None] * len(token_lists)
    with engine.forward_scope():
        for rows in row_groups(spec, [len(t) for t in token_lists], forward_budget(engine)):
            tokens, lengths = padded_batch(spec, token_lists, rows)
            b = tokens.shape[0]
            n_pred = max(len(token_lists[i]) for i in rows) - 1  # positions that predict
            step = max(1, SCORE_CHUNK_TOKENS // b)
            spans = [(p0, min(n_pred, p0 + step)) for p0 in range(0, n_pred, step)]
            with engine.forward_ranks(tokens, lengths, forward_member(engine, member), spans,
                                      plain_attention) as mesh:
                tokens, lengths = tokens.to(engine.device), lengths.to(engine.device)
                h = forward_hidden(params, spec, tokens, lengths,
                                   plain_attention=plain_attention, mesh=mesh,
                                   sp_impl=engine.sp_impl)  # [b, t, D]
                token_lp = torch.zeros((b, n_pred + 1), dtype=torch.float32, device=h.device)
                top_ix = top_lp = None
                if top_k:
                    top_ix = torch.zeros((b, n_pred + 1, top_k), dtype=torch.long,
                                         device=h.device)
                    top_lp = torch.zeros((b, n_pred + 1, top_k), dtype=torch.float32,
                                         device=h.device)
                for p0, p1 in spans:
                    # Position p's row predicts token p + 1.
                    lps = torch.log_softmax(unembed(params, spec, h[:, p0:p1], mesh).float(),
                                            dim=-1)
                    nxt = tokens[:, p0 + 1:p1 + 1]
                    token_lp[:, p0 + 1:p1 + 1] = lps.gather(-1, nxt[..., None])[..., 0]
                    if top_k:
                        vals, ids = torch.topk(lps, top_k, dim=-1)
                        top_lp[:, p0 + 1:p1 + 1] = vals
                        top_ix[:, p0 + 1:p1 + 1] = ids
                    del lps
            token_lp = token_lp.cpu()
            if top_k:
                top_ix, top_lp = top_ix.cpu(), top_lp.cpu()
            for j, i in enumerate(rows):
                n = len(token_lists[i])
                entry: dict = {"token_logprobs": [None] + token_lp[j, 1:n].tolist()}
                if top_k:
                    entry["top"] = [None] + [(top_ix[j, p].tolist(), top_lp[j, p].tolist())
                                             for p in range(1, n)]
                results[i] = entry
    return results
