"""Chunk-granular KV movement between the engine's cache, the host and
another device group (the JAX package's ``cache/kv_transfer.py``:
``slice_rows``, ``write_rows``, ``fetch_to_host`` and the
device-to-device :func:`transfer` of disaggregated serving).

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

import time

import torch

from quorum_tpu_torch import observability as obs
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


# The routes a handoff between device groups takes, as the JAX package
# labels them: ``direct`` (same layout on both sides), ``reshard`` (the
# groups cut the kv heads differently) and ``host-bounce`` (through host
# memory). ``resident`` is zero-drain's, where nothing moves.
ROUTES = ("direct", "reshard", "host-bounce")


def handoff_route(prefill_mesh, decode_mesh) -> str:
    """The route of a disaggregated engine's handoffs, from the groups'
    layout alone, before the first one (the JAX package picks it per call
    and falls back through the host when a direct put is refused; the port
    never falls back). Two one-rank groups move each piece with one copy
    onto the decode device: ``direct``. Groups of several ranks move it
    through their first ranks (the prefill group's gathered over its tp,
    one copy, the decode group's broadcast over its tp): ``host-bounce``
    where a group runs over gloo (its collectives staged through the host:
    the CPU, or ranks sharing a card), else ``direct`` where both groups
    cut the kv heads alike and ``reshard`` where they do not."""
    meshes = [m for m in (prefill_mesh, decode_mesh) if m is not None and m.size > 1]
    if not meshes:
        return "direct"
    if any(m.backend == "gloo" for m in meshes):
        return "host-bounce"
    tp_d = 1 if decode_mesh is None else decode_mesh.shape["tp"]
    return "direct" if prefill_mesh.shape["tp"] == tp_d else "reshard"


def _head_order(spec, tp: int) -> list[int]:
    """For each kv head, its entry in the tp ranks' entries concatenated in
    rank order (``parallel/sharding.rank_kv_index``; the first where
    several ranks hold it)."""
    from quorum_tpu_torch.parallel.sharding import rank_kv_index

    order = [h for r in range(tp) for h in rank_kv_index(spec.n_heads, spec.n_kv_heads, tp, r)]
    return [order.index(h) for h in range(spec.n_kv_heads)]


def gather_heads(chunk, mesh, spec):
    """A wire chunk of one tp rank's kv-head entries → the chunk of every kv
    head, in order: each leaf all-gathered over the mesh's tp (every rank of
    it calls this) and each head taken once."""
    if mesh.tp_size == 1:
        return chunk
    idx = torch.tensor(_head_order(spec, mesh.tp_size), device=chunk_leaves(chunk)[0].device)
    return _map_chunk(chunk, lambda x: mesh.tp.all_gather(x.contiguous(), dim=1)
                      .index_select(1, idx))


def select_heads(chunk, mesh, spec):
    """A wire chunk of every kv head → this tp rank's entries
    (``rank_kv_index``: the heads its cache holds, in its order)."""
    from quorum_tpu_torch.parallel.sharding import rank_kv_index

    if mesh.tp_size == 1:
        return chunk
    mine = rank_kv_index(spec.n_heads, spec.n_kv_heads, mesh.tp_size, mesh.tp_rank)
    idx = torch.tensor(mine, device=chunk_leaves(chunk)[0].device)
    return _map_chunk(chunk, lambda x: x.index_select(1, idx))


# ---- a multi-rank engine's rows (dp/tp meshes) -------------------------------
#
# The host prefix store lives on rank 0 in whole-head chunks. A row's K/V
# lies on the ranks of the dp group(s) holding it, each rank its own kv
# heads. Every rank of the mesh calls these at the same point of rank 0's
# plan order, so their collectives pair up.


def holders(mesh, row: int) -> list[int]:
    """The dp ranks whose caches hold flat row ``row``: the one group whose
    block of the slots it is, or every group where dp does not divide the
    slots (``RankMesh.hold_slots``)."""
    lo, hi, n = mesh.slots
    if not mesh.splits_slots:
        return list(range(mesh.dp_size))
    return [(row % n) // (hi - lo)]


def local_row(mesh, row: int) -> int | None:
    """Flat row ``row`` in this rank's cache (member m's slot s at
    ``m·(hi − lo) + s − lo``), or None where its dp group does not hold it."""
    if mesh is None or not mesh.splits_slots:
        return row
    lo, hi, n = mesh.slots
    if not lo <= row % n < hi:
        return None
    return (row // n) * (hi - lo) + row % n - lo


def kv_bytes(*sides) -> int:
    """Device bytes of cache sides (dense tensors, int8 ``(q8, scale)``
    pairs or paged pools with their table, a shared table once; None
    counts 0)."""
    seen, n = set(), 0
    for side in sides:
        parts = (side.pool, side.table) if kv_is_paged(side) else (side,)
        for part in parts:
            for t in (part if isinstance(part, tuple) else (part,)):
                if t is not None and id(t) not in seen:
                    seen.add(id(t))
                    n += t.numel() * t.element_size()
    return n


def _whole_like(cache, spec, n: int):
    """An empty whole-head wire chunk of ``n`` positions shaped like a
    chunk of ``cache`` (a receiver's buffers)."""
    side = cache[0]
    vals = side.pool if kv_is_paged(side) else side
    q8 = isinstance(vals, tuple)
    like = vals[0] if q8 else vals
    shape = (like.shape[0], spec.n_kv_heads, n, spec.head_dim)

    def one():
        if q8:
            return (torch.empty(shape, dtype=torch.int8, device=like.device),
                    torch.empty(shape[:3], dtype=torch.float32, device=like.device))
        return torch.empty(shape, dtype=like.dtype, device=like.device)

    return one(), one()


def snapshot_rows(cache, row: int, start: int, n: int, mesh, spec):
    """Positions ``[start, start+n)`` of flat row ``row`` as the whole-head
    wire chunk on rank 0 (None on the other ranks): the holding group's
    ranks slice their entries and gather them over its tp
    (:func:`gather_heads`); a group other than rank 0's then broadcasts the
    chunk over dp from its first rank. Without a mesh, :func:`slice_rows`."""
    if mesh is None:
        return slice_rows(cache, row, start, n)
    src = holders(mesh, row)[0]
    chunk = None
    if mesh.dp_rank == src:
        chunk = gather_heads(slice_rows(cache, local_row(mesh, row), start, n), mesh, spec)
    if src != 0 and mesh.tp_rank == 0:
        if chunk is None:
            chunk = _whole_like(cache, spec, n)
        for leaf in chunk_leaves(chunk):
            mesh.dp.broadcast(leaf, src)
    return chunk if mesh.rank == 0 else None


def restore_rows(cache, chunk, row: int, start: int, n: int, mesh, spec) -> None:
    """A whole-head wire chunk (rank 0's; None on the other ranks) into
    positions ``[start, start+n)`` of flat row ``row`` on every rank whose
    group holds it: broadcast over dp from rank 0 where another group holds
    it, then over each holding group's tp, each rank writing its own entries
    (:func:`select_heads`; a paged row through its pages). Without a mesh,
    :func:`write_rows`."""
    if mesh is None:
        write_rows(cache, chunk, row, start)
        return
    hold = holders(mesh, row)
    if hold != [0] and mesh.tp_rank == 0:
        if chunk is None:
            chunk = _whole_like(cache, spec, n)
        for leaf in chunk_leaves(chunk):
            mesh.dp.broadcast(leaf, 0)
    if mesh.dp_rank not in hold:
        return
    if chunk is None:
        chunk = _whole_like(cache, spec, n)
    for leaf in chunk_leaves(chunk):
        mesh.tp.broadcast(leaf, 0)
    write_rows(cache, select_heads(chunk, mesh, spec), local_row(mesh, row), start)


def transfer(chunk, device, *, route: str = "direct", stream=None, after=None,
             record: bool = True):
    """Move a sliced chunk onto ``device`` (the decode group's) and wait
    until it lands: every leaf copied into a new tensor there (a real copy
    even when the source lies on that device already). On a card the
    copies run on ``stream`` (a stream of ``device``; its current one when
    None) after ``after`` (an event, e.g. the segment's that wrote the
    source; a cross-device wait where the groups differ), with no host
    staging; the seconds are the copies' own, between two CUDA events
    around them, and this thread blocks until the second has passed (a
    copy that fails raises here: the caller's fault path, never another
    route). Returns ``(moved, n_bytes, seconds, route)`` with ``moved`` in
    the chunk's structure; with ``record`` the bytes and seconds land on
    the route-labelled ``quorum_tpu_kv_handoff_{bytes_total,seconds}``."""
    device = torch.device(device)
    leaves = chunk_leaves(chunk)
    n_bytes = int(sum(x.numel() * x.element_size() for x in leaves))

    def copy(x):
        out = torch.empty(x.shape, dtype=x.dtype, device=device)
        out.copy_(x, non_blocking=device.type == "cuda")
        return out

    if device.type == "cuda":
        stream = stream or torch.cuda.current_stream(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.device(device), torch.cuda.stream(stream):
            if after is not None:
                stream.wait_event(after)
            start.record(stream)
            moved = _map_chunk(chunk, copy)
            end.record(stream)
        end.synchronize()
        seconds = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        moved = _map_chunk(chunk, copy)
        seconds = time.perf_counter() - t0
    if record:
        obs.KV_HANDOFF_BYTES.inc(n_bytes, route=route)
        obs.KV_HANDOFF_SECONDS.observe(seconds, route=route)
    return moved, n_bytes, seconds, route


def _map_chunk(chunk, fn):
    return tuple(tuple(fn(a) for a in side) if isinstance(side, tuple) else fn(side)
                 for side in chunk)
