"""Chunk-granular KV movement between the engine's cache and the host (the
JAX package's ``cache/kv_transfer.py``: ``slice_rows``, ``write_rows`` and
``fetch_to_host``; its device-to-device ``transfer`` serves disaggregated
serving, which the port does not have yet).

The wire layout is the one the prefix store holds and the migration format
ships: a cache side's positions ``[start, start+n)`` of one flat row as
``[L, K, n, hd]`` (an int8 side's scales ``[L, K, n]``). A cache is the
``(k_side, v_side)`` pair; a side is a dense tensor ``[L, rows, K, max_seq,
hd]``, the int8 pair ``(q8, scale)`` of such, or a paged ``PagedKV``.
Stacked engines address member m's slot s as the flat row ``m·S + s`` in
every layout, so no call takes a member argument. The leaves of a chunk, in
order: K's values (then its scales), V's values (then its scales).
"""

from __future__ import annotations

import torch

from quorum_tpu_torch.cache.paging import kv_is_paged, paged_slice_rows, paged_write_rows


def chunk_leaves(chunk) -> list[torch.Tensor]:
    """A chunk's leaves in wire order."""
    out: list[torch.Tensor] = []
    for side in chunk:
        out.extend(side if isinstance(side, tuple) else (side,))
    return out


def slice_rows(cache, row: int, start: int, n: int):
    """Positions ``[start, start+n)`` of flat row ``row`` of every side, in
    the wire layout: new tensors (never views), so a later write to the
    cache cannot change them."""
    def take(side):
        if kv_is_paged(side):
            return paged_slice_rows(side, row, start, n)
        if isinstance(side, tuple):
            return tuple(a[:, row, :, start:start + n].clone(memory_format=torch.contiguous_format)
                         for a in side)
        return side[:, row, :, start:start + n].clone(memory_format=torch.contiguous_format)

    return tuple(take(side) for side in cache)


def write_rows(cache, chunk, row: int, start: int):
    """Write a wire chunk into positions ``[start, start+n)`` of flat row
    ``row`` of every side, in place (a paged row's pages must be reserved).
    Returns ``cache``."""
    for side, h in zip(cache, chunk):
        if kv_is_paged(side):
            paged_write_rows(side, h, row, start)
            continue
        for a, x in zip(side if isinstance(side, tuple) else (side,),
                        h if isinstance(h, tuple) else (h,)):
            a[:, row, :, start:start + x.shape[2]] = x.to(a.dtype)
    return cache


def fetch_to_host(payload, out: list[torch.Tensor] | None = None) -> list[torch.Tensor]:
    """A chunk's leaves (a ``(k, v)`` chunk, or a list of its leaves) on the
    host, in order, in the cache's native representation: copies into
    ``out`` when given (pinned buffers; the copies are enqueued on the
    current stream, and the caller waits for them), else new host
    tensors."""
    leaves = chunk_leaves(payload) if isinstance(payload, tuple) else list(payload)
    if out is None:
        return [x.to("cpu", copy=True) for x in leaves]
    for dst, x in zip(out, leaves):
        dst.copy_(x, non_blocking=True)
    return out


def chunk_from_leaves(leaves: list[torch.Tensor], q8: bool):
    """Rebuild a chunk ``(k, v)`` from its leaves (the inverse of the leaf
    order above)."""
    if q8:
        return (leaves[0], leaves[1]), (leaves[2], leaves[3])
    return leaves[0], leaves[1]
