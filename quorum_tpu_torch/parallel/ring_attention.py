"""Ring attention: sequence-parallel causal attention over the mesh's ``sp``
ranks, the JAX package's ``parallel/ring_attention.py`` over
``torch.distributed``.

The sequence is cut into sp blocks, one per sp rank: no rank ever holds
full-length K/V inside the attention. Each rank attends its query block to
the K/V block it holds, then passes that block to the next rank of the ring
(``parallel/comm.Group.ring_pass``), sp − 1 times, and merges the partial
results with the online softmax of the JAX package's ``_ring_local``
(the same math as the flash kernels). Blocks entirely above the causal
diagonal still take their hop (every rank's pass must be collective);
their scores are masked out. GQA is grouped inside the ring: the blocks
that travel stay at kv-head width.

The JAX function takes the global view and ``shard_map`` cuts it; here each
rank calls with its own block (query block index = its sp rank) and the
heads its tp rank holds (``parallel/sharding.rank_heads`` /
``rank_kv_heads``). The per-hop block attention is plain torch ops in
float32, as XLA's is in the JAX package: its scores are ``[B, K, G, S/sp,
S/sp]`` f32 per hop (a kernel for it is ROADMAP's offset K1).
"""

from __future__ import annotations

import torch

from quorum_tpu_torch.ops.attention import NEG_INF


def ring_prefill_attention(
    q: torch.Tensor,        # [B, H, s, hd]: this rank's query block (s = S / sp)
    k: torch.Tensor,        # [B, K, s, hd]: this rank's key block
    v: torch.Tensor,
    lengths: torch.Tensor,  # [B] valid prompt lengths (of the whole sequence)
    mesh,                   # parallel/comm.RankMesh
) -> torch.Tensor:
    """Causal, length-masked GQA attention of this rank's query block over
    the whole sequence, the K/V blocks riding the sp ring. Returns this
    rank's block of the output, [B, H, s, hd] in q's dtype. Rows at or past
    a length are computed but mean nothing (no caller reads them)."""
    sp, idx = mesh.sp_size, mesh.sp_rank
    b, h, s, hd = q.shape
    n_kv = k.shape[1]
    g = h // n_kv
    dev = q.device
    qf = q.float().reshape(b, n_kv, g, s, hd) * hd ** -0.5
    steps = torch.arange(s, device=dev)
    rows = idx * s + steps                                            # [s]
    lens = lengths.to(device=dev, dtype=torch.long)
    m = torch.full((b, n_kv, g, s, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, n_kv, g, s, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, n_kv, g, s, hd), dtype=torch.float32, device=dev)
    k_cur, v_cur = k, v
    for i in range(sp):
        # The block held at hop i started on rank (idx − i) mod sp.
        cols = ((idx - i) % sp) * s + steps                           # [s]
        logits = torch.einsum("bkgsd,bktd->bkgst", qf, k_cur.float())
        keep = (cols[None, :] <= rows[:, None])[None] & (cols[None, None, :] < lens[:, None, None])
        logits.masked_fill_(~keep[:, None, None], NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        p = logits.sub_(m_new).exp_()                                 # in place: one score buffer
        corr = torch.exp(m - m_new)
        l = corr * l + p.sum(dim=-1, keepdim=True)
        acc = corr * acc + torch.einsum("bkgst,bktd->bkgsd", p, v_cur.float())
        m = m_new
        del logits, p
        if i < sp - 1:  # the last block's pass would only be thrown away
            k_cur, v_cur = mesh.sp.ring_pass([k_cur, v_cur])
    out = acc / l.clamp_min(1e-30)
    return out.reshape(b, h, s, hd).to(q.dtype)
