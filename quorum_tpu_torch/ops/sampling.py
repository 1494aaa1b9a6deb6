"""On-device token sampling with per-row knobs: greedy, temperature, top-k,
top-p — the semantics of the JAX package's ``sample_token_rows`` — and the
OpenAI knobs around it: the logit adjustment (``logit_bias``, presence and
frequency penalties) that sampling reads, and the logprob record of each
sampled token.

The random part is an argument: ``gumbel`` [S, V] noise, and a row samples
``argmax(masked_logits + gumbel)`` — the Gumbel-max form of a categorical
draw, which is exactly how ``jax.random.categorical`` draws. The engine
takes the noise from a per-request ``torch.Generator`` on the device; the
tests hand both packages the same noise, so tokens match exactly.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

TOP_LOGPROBS = 20  # alternatives recorded per step (OpenAI's API maximum)


@dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 1.0
    top_k: int = 0        # 0 = disabled
    top_p: float = 1.0    # 1.0 = disabled

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0

    @property
    def restricts(self) -> bool:
        """True when a cutoff can remove tokens (the sort is then needed)."""
        return self.top_p < 1.0 or self.top_k > 0


def gumbel_noise(vocab: int, generator: torch.Generator, out: torch.Tensor | None = None,
                 device=None) -> torch.Tensor:
    """One row of standard Gumbel noise, ``-log(E)`` with ``E ~ Exp(1)``,
    drawn from ``generator`` (on the generator's device)."""
    if out is None:
        out = torch.empty((vocab,), dtype=torch.float32, device=device or generator.device)
    return out.exponential_(generator=generator).log_().neg_()


def _apply_cutoffs(scaled, top_p, top_k):
    vocab = scaled.shape[-1]
    # One descending sort serves both cutoffs (temperature > 0 keeps order).
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k = torch.where(top_k > 0, top_k, torch.full_like(top_k, vocab)).long()
    kth = torch.gather(sorted_desc, 1, torch.clamp(k - 1, 0, vocab - 1)[:, None])
    # top-p composes AFTER top-k: the cumulative mass is taken over the
    # top-k-filtered, renormalised distribution.
    col = torch.arange(vocab, device=scaled.device)[None, :]
    in_k = col < k[:, None]
    probs = torch.softmax(torch.where(in_k, sorted_desc,
                                      torch.full_like(sorted_desc, float("-inf"))), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_p[:, None]          # smallest prefix with mass >= top_p
    nkeep = keep.sum(dim=-1, keepdim=True)         # always >= 1
    cutoff_p = torch.gather(sorted_desc, 1, nkeep - 1)
    return torch.where(scaled < torch.maximum(kth, cutoff_p),
                       torch.full_like(scaled, float("-inf")), scaled)


def apply_token_mask(logits: torch.Tensor, allow: torch.Tensor) -> torch.Tensor:
    """Grammar masking: disallowed entries drop to −inf BEFORE the sampler,
    so temperature, top-k and top-p (all downstream of the mask) compose
    unchanged. −inf survives the Gumbel-argmax, so masking a token that
    would not have been sampled anyway is a strict no-op under greedy and
    pure temperature sampling; with top-k/top-p the cutoffs are taken over
    the masked distribution."""
    return torch.where(allow, logits, float("-inf"))


def sample_token_rows(
    logits: torch.Tensor,       # [S, V] float
    temperature: torch.Tensor,  # [S] float; <= 0 → greedy for that row
    top_p: torch.Tensor,        # [S] float; 1.0 → disabled
    top_k: torch.Tensor,        # [S] int; 0 → disabled
    gumbel: torch.Tensor,       # [S, V] standard Gumbel noise (ignored by greedy rows)
    restrict: bool | None = None,
) -> torch.Tensor:
    """Per-row sampling with per-row knobs; returns [S] int64 token ids.

    Row-independent: each row's output depends only on that row's logits,
    knobs and noise. ``restrict`` says whether any row sets top-k or top-p;
    when False the O(V log V) sort is skipped. ``None`` reads it from the
    knob tensors (a device→host sync on the card — the engine passes the
    value it already knows)."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits / torch.clamp(temperature.float(), min=1e-6)[:, None]
    if restrict is None:
        restrict = bool(((top_p < 1.0) | (top_k > 0)).any())
    if restrict:
        scaled = _apply_cutoffs(scaled, top_p.float(), top_k)
    sampled = torch.argmax(scaled + gumbel, dim=-1)
    return torch.where(temperature <= 0.0, greedy, sampled)


def adjust_logits(
    logits: torch.Tensor,  # [S, V] float
    bias: torch.Tensor,    # [S, V] f32 additive logit_bias per row
    counts: torch.Tensor,  # [S, V] int: tokens each row has generated so far
    pp: torch.Tensor,      # [S] f32 presence penalty
    fp: torch.Tensor,      # [S] f32 frequency penalty
) -> torch.Tensor:
    """The OpenAI knobs on f32 logits, per row: the bias adds; the frequency
    penalty subtracts ``fp × count`` and the presence penalty ``pp`` once a
    token has been generated at all. Sampling, and the logprobs, read the
    result (the JAX engine's ``adj``)."""
    counts = counts.to(torch.float32)
    return (logits.float() + bias - fp[:, None] * counts
            - pp[:, None] * (counts > 0).to(torch.float32))


def token_logprobs(adj: torch.Tensor, nxt: torch.Tensor, n_top: int = TOP_LOGPROBS):
    """``(s_lp [S], top_ix [S, n_top], top_lp [S, n_top])``: the sampled
    token's log-probability under ``adj`` and the ``n_top`` most likely
    alternatives, most likely first."""
    lp_all = torch.log_softmax(adj.float(), dim=-1)
    s_lp = torch.gather(lp_all, 1, nxt.long()[:, None])[:, 0]
    top_lp, top_ix = torch.topk(lp_all, min(n_top, adj.shape[-1]), dim=-1)
    return s_lp, top_ix, top_lp
