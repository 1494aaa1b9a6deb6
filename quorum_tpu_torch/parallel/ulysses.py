"""Ulysses sequence parallelism: all-to-all attention over the mesh's ``sp``
ranks, the JAX package's ``parallel/ulysses.py`` over ``torch.distributed``.

Where the ring keeps the sequence cut and passes K/V blocks rank to rank,
Ulysses re-cuts once per attention: one packed all-to-all turns each rank's
sequence block of every head into the whole sequence of its share of the
heads, attention runs locally over the full sequence, and one all-to-all
turns the output back. Two collectives per layer.

The local attention is kernel K1 (``ops/flash_attention.
flash_prefill_attention``) on a card: causal, length-masked and windowed,
the function the JAX package computes here with its plain
``prefill_attention``. K1 gives 0 at positions at or past a row's length;
no caller reads them. A CPU tensor takes K1's plain version.

Heads: destination rank d takes query heads ``[d·gq, (d+1)·gq)`` of this
rank's H/tp, and the kv heads those read. Where the rank's kv heads split
over sp, that is ``gk = K_local / sp`` each (the JAX packing); where they
are fewer than sp, each destination gets the one kv head its query heads
read (a kv head is sent to several ranks), so GQA models with few kv heads
still split over sp. Each rank sees the whole sequence, so windowed
(mistral) specs work unchanged; the ring refuses them.
"""

from __future__ import annotations

import torch

from quorum_tpu_torch.ops.attention import prefill_attention
from quorum_tpu_torch.ops.flash_attention import flash_prefill_attention
from quorum_tpu_torch.parallel.mesh import AXIS_SP, AXIS_TP
from quorum_tpu_torch.parallel.sharding import rank_kv_index


def _dest_kv(hq: int, hk: int, sp: int) -> list[tuple[int, int]] | None:
    """Per destination rank, the local kv heads ``[a, b)`` its query heads
    read; None when the heads cannot split evenly (query heads not
    divisible by sp, or groups cut unevenly)."""
    if hq % sp:
        return None
    gq, g = hq // sp, hq // hk
    if gq % g and g % gq:
        return None
    out = [((d * gq) // g, ((d + 1) * gq - 1) // g + 1) for d in range(sp)]
    return out if len({b - a for a, b in out}) == 1 else None


def ulysses_supported(h: int, n_kv: int, mesh, sp: str = AXIS_SP) -> bool:
    """Whether every rank's heads split over sp (checked at engine
    construction: a silent fallback would replicate full attention at
    exactly the lengths sp exists for). ``mesh`` is a ``Mesh`` or a
    ``RankMesh``."""
    shape = (mesh.mesh if hasattr(mesh, "mesh") else mesh).shape
    tp, n_sp = shape[AXIS_TP], shape[sp]
    if h % tp:
        return False
    return all(_dest_kv(h // tp, len(rank_kv_index(h, n_kv, tp, r)), n_sp) is not None
               for r in range(tp))


def ulysses_prefill_attention(
    q: torch.Tensor,        # [B, Hq, s, hd]: this rank's sequence block (s = S / sp)
    k: torch.Tensor,        # [B, Hk, s, hd]
    v: torch.Tensor,
    lengths: torch.Tensor,  # [B] valid prompt lengths
    mesh,                   # parallel/comm.RankMesh
    *,
    window: int = 0,
    plain: bool = False,
) -> torch.Tensor:
    """Causal, length-masked GQA attention with the sequence cut over sp,
    by head↔sequence all-to-alls. Returns this rank's block [B, Hq, s, hd].
    Raises where the heads do not split over sp. ``plain``: the local
    attention is K1's plain version on any device (a forward's ground
    truth on the card)."""
    n_sp = mesh.sp_size
    b, hq, s, hd = q.shape
    hk = k.shape[1]
    dest = _dest_kv(hq, hk, n_sp)
    if dest is None:
        raise ValueError(
            f"ulysses: {hq} query and {hk} kv heads per rank do not split over sp={n_sp}")
    gq, w = hq // n_sp, dest[0][1] - dest[0][0]
    packed = torch.stack([torch.cat([q[:, d * gq:(d + 1) * gq], k[:, a:e], v[:, a:e]], dim=1)
                          for d, (a, e) in enumerate(dest)])        # [sp, B, gq+2w, s, hd]
    got = mesh.sp.all_to_all(packed)                                # [sp(src), B, gq+2w, s, hd]
    full = got.permute(1, 2, 0, 3, 4).reshape(b, gq + 2 * w, n_sp * s, hd)
    qh, kh, vh = (full[:, :gq].contiguous(), full[:, gq:gq + w].contiguous(),
                  full[:, gq + w:].contiguous())
    attn = prefill_attention if plain else flash_prefill_attention
    out = attn(qh, kh, vh, lengths.to(q.device), window=window)
    back = out.reshape(b, gq, n_sp, s, hd).permute(2, 0, 1, 3, 4).contiguous()
    got = mesh.sp.all_to_all(back)                                  # [sp(src), B, gq, s, hd]
    return got.permute(1, 0, 2, 3, 4).reshape(b, hq, s, hd)
