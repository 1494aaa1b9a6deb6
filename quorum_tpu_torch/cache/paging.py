"""Paged KV slot memory on torch tensors: the JAX package's
``cache/paging.py`` behind the ``kv_pages=1`` engine knob.

The dense cache holds ``[L, rows, K, max_seq, hd]``: every row pays
``max_seq`` whatever it holds. The paged layout replaces the rectangle with

  - a **page pool** ``[L, P', K, page_size, hd]`` (int8 KV: the pair of
    ``int8 [L, P', K, ps, hd]`` values and ``f32 [L, P', K, ps]`` scales).
    Member m of a stacked engine owns pages ``m·(n_pages+1) + p`` for
    ``p`` in ``0..n_pages``, each member's physical page ``m·(n_pages+1)``
    a zero **sink**; the last physical page ``P'−1`` is the **trash**
    page, where every gated or dead write lands (the JAX package drops
    them out of bounds with scatter ``mode="drop"``, which torch's
    ``index_put_`` lacks). ``P' = members·(n_pages+1) + 1``. No op ever
    writes a sink, and no table entry ever names the trash page;
  - one **page table** ``[rows, max_pages]`` int32 shared by both sides
    and every layer: row r's physical pages, member offsets included.
    Unreserved entries name the row's sink, so a read of an unwritten tail
    gathers zeros that every attention length mask excludes. The table is
    written by the engine only, in place, at admission and release
    boundaries: device programs read it.

Reads materialize a dense window (:func:`page_read`: gather the
``ceil(hist/ps)`` pages of each row into ``[rows, K, hist, hd]``), so the
decode kernels K2 and K2q8 run unchanged on the gathered window. Writes
scatter through the table. Every op is a fixed-shape indexing op with no
host read, so it runs inside CUDA-graph capture. Positions and rows given
as Python ints (the wire ops' ``row`` and ``start``) index on the host.

Prefix reuse becomes page aliasing with copy-on-write of the boundary page
(:func:`paged_copy_page`); :class:`PageAllocator` is the host bookkeeper
(refcounts, free list, per-row chains, an LRU of retained chains), a copy
of the JAX package's.
"""

from __future__ import annotations

from collections import OrderedDict

import torch

from quorum_tpu_torch.ops.attention import quantize_rows


class PagedKV:
    """One side (K or V) of a paged KV cache: ``(pool, table)``. ``pool`` is
    ``[L, P', K, ps, hd]`` or the ``(int8, f32 scale)`` pair (per layer:
    without L), ``table`` is ``[rows, max_pages]`` int32."""

    __slots__ = ("pool", "table")

    def __init__(self, pool, table):
        self.pool = pool
        self.table = table

    @property
    def is_q8(self) -> bool:
        return isinstance(self.pool, tuple)

    @property
    def page_size(self) -> int:
        return (self.pool[0] if self.is_q8 else self.pool).shape[-2]

    def layer(self, l: int) -> "PagedKV":
        """Layer ``l``'s view: the pool's layer slice, the same table."""
        pool = (self.pool[0][l], self.pool[1][l]) if self.is_q8 else self.pool[l]
        return PagedKV(pool, self.table)

    def __repr__(self):  # pragma: no cover - debugging aid
        v = self.pool[0] if self.is_q8 else self.pool
        return (f"PagedKV(pool={tuple(v.shape)}{' q8' if self.is_q8 else ''}, "
                f"table={tuple(self.table.shape)})")


def kv_is_paged(cache) -> bool:
    """True when a cache side is the paged ``(pool, table)`` representation."""
    return isinstance(cache, PagedKV)


def validate_page_config(max_seq: int, page_size: int) -> None:
    """Refuse page sizes the layout cannot represent (the JAX package's
    checks and words): a power of two that divides ``max_seq``."""
    if page_size < 1 or (page_size & (page_size - 1)) != 0:
        raise ValueError(
            f"kv_page_size={page_size} must be a power of two (page offsets "
            "must align with the engine's pow2 chunk/history buckets)")
    if max_seq % page_size != 0:
        raise ValueError(
            f"kv_page_size={page_size} must divide max_seq={max_seq} "
            "(the page table maps every position to exactly one page)")


def init_paged_cache(spec, batch: int, n_pages: int, page_size: int, dtype=None,
                     kv_quant: str | None = None, members: int | None = None,
                     device=None):
    """Zero page pools and one sink-pointing table: ``(PagedKV_k,
    PagedKV_v)``, both sides sharing the table ``[members·batch, max_pages]``
    (member m's rows point at its own sink, page ``m·(n_pages+1)``)."""
    validate_page_config(spec.max_seq, page_size)
    m = members or 1
    mp = spec.max_seq // page_size
    # each member's sink and pages, then the trash page
    shape = (spec.n_layers, m * (n_pages + 1) + 1, spec.n_kv_heads, page_size, spec.head_dim)
    dt = getattr(torch, dtype) if isinstance(dtype, str) else (dtype or getattr(torch, spec.dtype))

    def side():
        if kv_quant == "int8":
            return (torch.zeros(shape, dtype=torch.int8, device=device),
                    torch.zeros(shape[:-1], dtype=torch.float32, device=device))
        return torch.zeros(shape, dtype=dt, device=device)

    stride = torch.arange(m, dtype=torch.int32, device=device) * (n_pages + 1)
    table = stride.repeat_interleave(batch)[:, None].expand(m * batch, mp).contiguous()
    return PagedKV(side(), table), PagedKV(side(), table)


# ---- device helpers on ONE layer: pool [P', K, ps, hd], table [rows, mp] ----


def _pool_parts(pool):
    return pool if isinstance(pool, tuple) else (pool, None)


def _quantize(x: torch.Tensor):
    q8, s = quantize_rows(x, axis=-1)
    return q8, s[..., 0]


def _dequant(q8: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q8.float() * scale[..., None]).to(dtype)


def _block_unit(nbytes: int) -> torch.dtype:
    """The widest integer type whose size divides a block of ``nbytes``."""
    return next(dt for dt in (torch.int64, torch.int32, torch.int16, torch.int8)
                if nbytes % dt.itemsize == 0)


def window_index(table: torch.Tensor, hist: int, page_size: int, n_kv: int) -> torch.Tensor:
    """The block rows a ``hist`` window of every row of ``table`` gathers:
    row ``(b, k, j)`` of the result names block ``(table[b, j], k)`` of a
    pool leaf viewed as ``[P'·K, ps(·hd)]``. The same for every layer and
    both sides, so a decode step builds it once."""
    hp = min(-(-hist // page_size), table.shape[-1])
    heads = torch.arange(n_kv, device=table.device)
    return (table[:, :hp].long()[:, None, :] * n_kv + heads[None, :, None]).reshape(-1)


def _gather(p: torch.Tensor, index: torch.Tensor, b: int, hist: int) -> torch.Tensor:
    """One pool leaf ``[P', K, ps(, hd)]``'s window ``[B, K, hist(, hd)]``
    in one copy: each (page, head) block of ``ps(·hd)`` elements is
    contiguous in the pool, so the leaf is viewed as rows of blocks in the
    widest integer type that tiles them, and one ``index_select`` lays the
    blocks ``index`` names (``window_index``) out in the window's layout."""
    k = p.shape[1]
    rows = p.reshape(p.shape[0] * k, -1)
    rows = rows.view(_block_unit(rows.shape[1] * p.element_size()))
    g = rows.index_select(0, index).view(p.dtype).reshape(b, k, -1, *p.shape[3:])
    return g[:, :, :hist].contiguous()


def _window(pkv: PagedKV, table: torch.Tensor, hist: int, index=None):
    vals, scales = _pool_parts(pkv.pool)
    if index is None:
        index = window_index(table, hist, vals.shape[-2], vals.shape[1])
    b = table.shape[0]
    if scales is not None:
        return _gather(vals, index, b, hist), _gather(scales, index, b, hist)
    return _gather(vals, index, b, hist)


def page_read(pkv: PagedKV, hist: int, index: torch.Tensor | None = None):
    """Every row's first ``hist`` positions as a dense ``[rows, K, hist,
    hd]`` window (or the ``(q8, scale)`` pair of windows for an int8 pool:
    decode keeps contracting in int8). ``hist`` is static (the engine's
    power-of-two history bucket); the gather reads ``ceil(hist/ps)`` pages
    per row; unreserved entries gather the zero sink. ``index``: the
    table's ``window_index``, when the caller has built it."""
    return _window(pkv, pkv.table, hist, index)


def page_read_row(pkv: PagedKV, slot, hist: int, dtype,
                  index: torch.Tensor | None = None) -> torch.Tensor:
    """Row ``slot``'s ``[1, K, hist, hd]`` history window in ``dtype`` (a
    ``[B]`` tensor of rows gives ``[B, K, hist, hd]``; ``index`` is their
    sub-table's ``window_index``): the chunked-prefill read. An int8 pool
    dequantizes the bounded window."""
    rows = slot if isinstance(slot, torch.Tensor) else torch.tensor([slot])
    r = _window(pkv, pkv.table[rows.to(pkv.table.device).long().reshape(-1)], hist, index)
    if isinstance(r, tuple):
        return _dequant(r[0], r[1], dtype)
    return r.to(dtype)


def write_slots(pkv: PagedKV, rows: torch.Tensor, pos: torch.Tensor,
                ok: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """``(physical page, offset)`` ``[B, T]`` of positions ``pos [B, T]``
    of table rows ``rows [B]``: the trash page where ``ok`` is False or the
    position is past the table. The same for every layer and both sides."""
    vals, _ = _pool_parts(pkv.pool)
    ps, mp, trash = vals.shape[-2], pkv.table.shape[-1], vals.shape[-4] - 1
    pos = pos.long()
    phys = pkv.table[rows.long()].gather(1, (pos // ps).clamp(0, mp - 1)).long()  # [B, T]
    keep = pos < mp * ps
    if ok is not None:
        keep = keep & ok
    return torch.where(keep, phys, torch.full_like(phys, trash)), pos % ps


def page_write(pkv: PagedKV, value: torch.Tensor, rows: torch.Tensor | None = None,
               pos: torch.Tensor | None = None, ok: torch.Tensor | None = None,
               slots: tuple | None = None) -> PagedKV:
    """``value [B, K, T, hd]`` at positions ``pos [B, T]`` of table rows
    ``rows [B]`` (or at ``slots``, ``write_slots``' result), in place.
    Entries with ``ok`` False and positions past the table land on the
    trash page (the JAX ops' ``mode="drop"``)."""
    vals, scales = _pool_parts(pkv.pool)
    phys, off = write_slots(pkv, rows, pos, ok) if slots is None else slots
    if scales is not None:
        q8, s = _quantize(value)
        vals[phys, :, off] = q8.transpose(1, 2)
        scales[phys, :, off] = s.transpose(1, 2).to(scales.dtype)
    else:
        vals[phys, :, off] = value.transpose(1, 2).to(vals.dtype)
    return pkv


def page_write_step(pkv: PagedKV, value, lengths, allow, max_seq: int) -> PagedKV:
    """Decode-step write: ``value [S, K, 1, hd]`` at each row's
    ``lengths``; masked-out rows and positions past ``max_seq`` drop."""
    rows = torch.arange(value.shape[0], device=value.device)
    pos = lengths.long()[:, None]
    return page_write(pkv, value, rows, pos, (allow & (lengths < max_seq))[:, None])


def page_write_multi(pkv: PagedKV, value, lengths, allow, max_seq: int) -> PagedKV:
    """T-token (speculative-verify) write: ``value [S, K, T, hd]`` at
    positions ``lengths[s] + t``; out-of-window positions drop exactly."""
    rows = torch.arange(value.shape[0], device=value.device)
    pos = lengths.long()[:, None] + torch.arange(value.shape[2], device=value.device)[None, :]
    return page_write(pkv, value, rows, pos, allow[:, None] & (pos < max_seq))


def page_write_seg(pkv: PagedKV, value, slot: int, offset: int, write_gate,
                   max_seq: int) -> PagedKV:
    """Chunked-prefill segment write: ``value [1, K, T, hd]`` at positions
    ``offset..offset+T`` of row ``slot`` (``write_gate`` False drops it)."""
    dev = value.device
    pos = offset + torch.arange(value.shape[2], device=dev)[None, :]
    ok = pos < max_seq
    if write_gate is not None:
        ok = ok & torch.as_tensor(write_gate, device=dev)
    return page_write(pkv, value, torch.tensor([slot], device=dev), pos, ok)


def page_write_prefill(pkv: PagedKV, value, cache_row: int, write_gate,
                       max_seq: int) -> PagedKV:
    """Whole-prompt write: ``value [B, K, T, hd]`` at positions ``0..T`` of
    rows ``cache_row..cache_row+B-1``."""
    b, _, t, _ = value.shape
    dev = value.device
    pos = torch.arange(t, device=dev)[None, :].expand(b, t)
    ok = pos < max_seq
    if write_gate is not None:
        ok = ok & torch.as_tensor(write_gate, device=dev)
    return page_write(pkv, value, torch.arange(cache_row, cache_row + b, device=dev), pos, ok)


# ---- wire-chunk ops on the full stack: pool [L, P', K, ps(, hd)] ----------
#
# The wire format is layout-free: [L, K, n, hd] values (scales [L, K, n])
# of one flat row. Prefix-store snapshots and restores ride these.


def paged_slice_rows(pkv: PagedKV, row: int, start: int, n: int):
    """Positions ``[start, start+n)`` of row ``row`` as the dense wire chunk
    ``[L, K, n, hd]`` (with ``[L, K, n]`` scales for an int8 pool)."""
    vals, scales = _pool_parts(pkv.pool)
    ps, mp = vals.shape[-2], pkv.table.shape[-1]
    p0 = start // ps
    ncov = -(-(start - p0 * ps + n) // ps)
    pages = pkv.table[row, p0:p0 + ncov].long()
    if pages.shape[0] < ncov:  # past the table: member 0's zero sink, as JAX pads
        pages = torch.cat([pages, pages.new_zeros(ncov - pages.shape[0])])

    def gath(p):
        g = p[:, pages].transpose(1, 2)                   # [L, K, ncov, ps(, hd)]
        g = g.reshape(g.shape[0], g.shape[1], -1, *g.shape[4:])
        return g[:, :, start - p0 * ps:start - p0 * ps + n].contiguous()

    if scales is not None:
        return gath(vals), gath(scales)
    return gath(vals)


def paged_write_rows(pkv: PagedKV, chunk, row: int, start: int) -> PagedKV:
    """A dense wire chunk ``[L, K, n, hd]`` (+ scales) into positions
    ``[start, start+n)`` of row ``row``, in place; the row's pages must be
    reserved. Positions past the table drop."""
    vals, scales = _pool_parts(pkv.pool)
    ps, mp, trash = vals.shape[-2], pkv.table.shape[-1], vals.shape[1] - 1
    cvals, cscales = chunk if isinstance(chunk, tuple) else (chunk, None)
    pos = start + torch.arange(cvals.shape[2], device=vals.device)
    phys = pkv.table[row].long()[(pos // ps).clamp(0, mp - 1)]
    phys = torch.where(pos < mp * ps, phys, torch.full_like(phys, trash))
    off = pos % ps
    vals[:, phys, :, off] = cvals.permute(2, 0, 1, 3).to(vals.dtype)
    if scales is not None:
        scales[:, phys, :, off] = cscales.permute(2, 0, 1).to(scales.dtype)
    return pkv


def paged_copy_page(pkv: PagedKV, dst: int, src: int, members: int = 1) -> PagedKV:
    """Copy page ``src`` onto page ``dst`` across all layers, in every
    member's pool copy: the copy-on-write behind prefix aliasing."""
    vals, _ = _pool_parts(pkv.pool)
    stride = (vals.shape[1] - 1) // members
    for p in (pkv.pool if pkv.is_q8 else (pkv.pool,)):
        for m in range(members):
            p[:, m * stride + dst].copy_(p[:, m * stride + src])
    return pkv


# ---- host-side bookkeeping ---------------------------------------------------


class PageAllocator:
    """Refcounted page bookkeeping, the host half of the paged layout (the
    JAX package's, line for line). Page ids are ``1..n_pages``; page 0 is
    the zero sink and is never handed out. The engine consults it at
    admission (reserve a row's full span), at release (retain the row's
    chain for prefix reuse, LRU-ordered) and on tier-0 hits (alias full
    pages by refcount, copy-on-write the partial boundary page)."""

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 1:
            raise ValueError(f"kv_pool_pages={n_pages} must be >= 1")
        validate_page_config(max(page_size, n_pages * page_size), page_size)
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.refs = [0] * (self.n_pages + 1)
        # pop() hands out low ids first: small tests stay deterministic
        self._free = list(range(self.n_pages, 0, -1))
        self.chains: dict[int, list[int]] = {}
        self.retained: "OrderedDict[int, list[int]]" = OrderedDict()

    def pages_for(self, n_tokens: int) -> int:
        """Pages covering ``n_tokens`` positions."""
        return max(0, -(-int(n_tokens) // self.page_size))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def allocated_pages(self) -> int:
        return self.n_pages - len(self._free)

    def _incref(self, pages):
        for p in pages:
            self.refs[p] += 1

    def _decref(self, pages):
        for p in pages:
            self.refs[p] -= 1
            if self.refs[p] == 0:
                self._free.append(p)
            elif self.refs[p] < 0:  # pragma: no cover - invariant guard
                raise AssertionError(f"page {p} refcount underflow")

    def is_shared(self, page: int) -> bool:
        return self.refs[page] > 1

    def alloc(self, n: int) -> list[int] | None:
        """Take ``n`` fresh pages (ref 1 each), or None when the free list
        is short (the caller reclaims retained chains and retries, or
        sheds)."""
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        self._incref(pages)
        return pages

    def free(self, pages: list[int]) -> None:
        """Drop one reference from each of ``pages``."""
        self._decref(pages)

    def assign(self, row: int, pages: list[int]) -> None:
        """Install ``pages`` as live row ``row``'s chain (refs already held)."""
        if row in self.chains:  # pragma: no cover - invariant guard
            raise AssertionError(f"row {row} already has a live chain")
        self.chains[row] = list(pages)

    def extend(self, row: int, pages: list[int]) -> None:
        """Append ``pages`` (refs held) to live row ``row``'s chain; the
        existing entries never move."""
        self.chains[row].extend(pages)

    def chain(self, row: int) -> list[int] | None:
        return self.chains.get(row)

    def release(self, row: int, keep_tokens: int = 0) -> None:
        """Row finished: retain the pages covering ``keep_tokens`` as a
        reusable chain (MRU end of the LRU), free the tail."""
        chain = self.chains.pop(row, None)
        if chain is None:
            return
        keep = min(self.pages_for(keep_tokens), len(chain))
        if chain[keep:]:
            self._decref(chain[keep:])
        old = self.retained.pop(row, None)
        if old is not None:
            self._decref(old)
        if keep:
            self.retained[row] = chain[:keep]

    def adopt(self, row: int) -> list[int] | None:
        """Take the row's retained chain back (refs move to the caller)."""
        return self.retained.pop(row, None)

    def retained_chain(self, row: int) -> list[int] | None:
        return self.retained.get(row)

    def retained_tokens_capacity(self, row: int) -> int:
        chain = self.retained.get(row)
        return 0 if chain is None else len(chain) * self.page_size

    def touch(self, row: int) -> None:
        """LRU refresh of a retained chain that just served as a donor."""
        if row in self.retained:
            self.retained.move_to_end(row)

    def share(self, pages: list[int]) -> list[int]:
        """Alias ``pages`` into another chain by reference (refcount bump)."""
        self._incref(pages)
        return list(pages)

    def drop_retained(self, row: int) -> bool:
        chain = self.retained.pop(row, None)
        if chain is None:
            return False
        self._decref(chain)
        return True

    def reclaimable_pages(self, protect=()) -> int:
        """Pages that would return to the free list if every retained chain
        outside ``protect`` were evicted (sole-reference pages only)."""
        n = 0
        for row, chain in self.retained.items():
            if row in protect:
                continue
            n += sum(1 for p in chain if self.refs[p] == 1)
        return n

    def evict_lru(self, protect=()) -> int | None:
        """Free the least-recently-retained chain not in ``protect``;
        returns the evicted row, or None when nothing is evictable."""
        for row in list(self.retained):
            if row in protect:
                continue
            self._decref(self.retained.pop(row))
            return row
        return None

    def reset(self) -> None:
        """Forget everything (engine cache reset)."""
        self.refs = [0] * (self.n_pages + 1)
        self._free = list(range(self.n_pages, 0, -1))
        self.chains.clear()
        self.retained.clear()
