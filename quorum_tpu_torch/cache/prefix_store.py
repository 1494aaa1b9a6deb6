"""Host-RAM prefix store: chunk-granular KV retention beyond the slots (a
copy of the JAX package's ``cache/prefix_store.py``, holding torch tensors).

The engine's tier-0 prefix reuse needs the conversation's slot to be free
and not yet overwritten. This store is the next tier: on slot release the
engine snapshots the slot's valid KV prefix device→host in fixed-size token
chunks; on admission, when the store's longest match beats the
slot-resident reuse, the matched prefix is restored host→device and only
the tail is prefilled.

Structure: a trie whose edges are ``chunk_tokens``-sized tuples of token
ids, so conversations sharing a history share storage. Each node owns the
KV payload for ONE chunk: a list of host tensors in the cache's native
representation (``kv_quant=int8`` halves host bytes as it halves device
bytes), each in the wire layout ``[L, K, chunk, hd]`` (scales ``[L, K,
chunk]``). Eviction is byte-budget LRU at chunk granularity, chain tails
first; evicting a chunk keeps the trie edge, so a later snapshot of the same
conversation re-validates the chain; longest-match stops at the first
missing payload (a truncated restore, never a wrong one).

Thread-safe: the scheduler thread matches while the snapshot worker
inserts.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import torch


# Default byte budget for a host prefix store (1 GiB). Sized for "a few
# hundred conversations of tiny-model history or a handful of 8B-scale
# ones": operators serving real traffic set prefix_store_bytes= from
# their host RAM headroom.
DEFAULT_PREFIX_STORE_BYTES = 1 << 30


class _Entry:
    """One stored chunk's payload: host tensors in the cache's native
    representation, in the engine's leaf order (K then V; each side's
    values, then its scales on an int8 cache)."""

    __slots__ = ("arrays", "nbytes")

    def __init__(self, arrays: list[torch.Tensor]):
        self.arrays = arrays
        self.nbytes = int(sum(a.nbytes for a in arrays))


class _Node:
    """Trie node: one chunk-edge deep. ``entry`` is None when this chunk's
    payload was evicted (the edge survives so a re-insert re-validates the
    chain)."""

    __slots__ = ("children", "entry", "parent", "edge")

    def __init__(self, parent: "_Node | None", edge: tuple | None):
        self.children: dict[tuple, _Node] = {}
        self.entry: _Entry | None = None
        self.parent = parent
        self.edge = edge


class PrefixStore:
    """Chunk-granular host KV prefix store with byte-budget LRU eviction.

    ``chunk_tokens`` is the retention granularity: only whole chunks are
    stored, matched, and evicted. ``max_bytes`` bounds the payload bytes
    held (trie bookkeeping is excluded — it is orders of magnitude smaller
    than the KV arrays it indexes).
    """

    def __init__(self, chunk_tokens: int, max_bytes: int):
        if chunk_tokens < 1:
            raise ValueError(
                f"prefix store chunk must be >= 1 token, got {chunk_tokens}")
        if max_bytes < 1:
            raise ValueError(
                f"prefix store byte budget must be positive, got {max_bytes}")
        self.chunk_tokens = int(chunk_tokens)
        self.max_bytes = int(max_bytes)
        self._lock = threading.RLock()
        self._root = _Node(None, None)
        # LRU over nodes WITH a live entry, oldest first; keyed by node id.
        self._lru: OrderedDict[int, _Node] = OrderedDict()
        self.bytes_held = 0
        self.n_inserts = 0
        self.n_evictions = 0

    # ---- queries ----------------------------------------------------------

    @property
    def n_entries(self) -> int:
        with self._lock:
            return len(self._lru)

    def _chunks(self, tokens) -> list[tuple]:
        c = self.chunk_tokens
        return [tuple(tokens[i: i + c])
                for i in range(0, len(tokens) - len(tokens) % c, c)]

    def covered(self, tokens) -> int:
        """Length (in tokens) of the longest stored chunk chain prefixing
        ``tokens`` — a peek that does NOT touch LRU order (the snapshot
        path uses it to decide what still needs storing; deciding must not
        make a chain look hot)."""
        with self._lock:
            node, n = self._root, 0
            for chunk in self._chunks(tokens):
                child = node.children.get(chunk)
                if child is None or child.entry is None:
                    break
                node = child
                n += self.chunk_tokens
            return n

    def _touch_chain(self, nodes: list[_Node]) -> None:
        """Refresh a chain's LRU recency LEAF-TO-ROOT (caller holds the
        lock): the root ends up newest, so the byte-budget eviction drops
        chain TAILS first. Root-first eviction would be pathological — a
        chain whose root chunk is gone matches nothing, yet its descendant
        chunks' bytes stay held and (being unmatchable) are never touched
        again, crowding out live conversations."""
        for node in reversed(nodes):
            self._lru.move_to_end(id(node))

    def longest_match(self, tokens) -> tuple[int, list[list[torch.Tensor]]]:
        """``(matched_tokens, per-chunk payloads)`` for the longest stored
        chain prefixing ``tokens``. Touches LRU for every matched chunk
        (a hit keeps the whole chain warm, tail evicting before root —
        see ``_touch_chain``)."""
        with self._lock:
            node, payloads, walked = self._root, [], []
            for chunk in self._chunks(tokens):
                child = node.children.get(chunk)
                if child is None or child.entry is None:
                    break
                node = child
                payloads.append(child.entry.arrays)
                walked.append(child)
            self._touch_chain(walked)
            return len(payloads) * self.chunk_tokens, payloads

    def export_chains(
        self, max_bytes: int | None = None,
    ) -> list[tuple[list[int], list[list[torch.Tensor]]]]:
        """Every maximal restorable chunk chain as ``(tokens, per-chunk
        payload lists)`` — the serialization feed for prefix migration
        (``cache/prefix_wire.py``).

        A chain ends at the first payload-less node on its path: chunks
        beyond an evicted ancestor are unmatchable (``longest_match`` stops
        there), so exporting them would ship bytes the importer could never
        restore. Branching conversations export one chain per branch — the
        shared prefix's payloads are referenced (not copied) by each, so
        the duplication costs only at serialization time. ``max_bytes``
        bounds the total payload bytes exported (whole chains, skipping
        chains that would breach it). Does NOT touch LRU order: exporting a
        departing replica's store must not make its chains look hot."""
        with self._lock:
            out: list[tuple[list[int], list[list[torch.Tensor]]]] = []
            budget = max_bytes if max_bytes is not None else float("inf")
            spent = 0
            stack: list[tuple[_Node, list[int], list]] = [
                (self._root, [], [])]
            while stack:
                node, toks, pay = stack.pop()
                extended = False
                for edge, child in node.children.items():
                    if child.entry is None:
                        continue
                    stack.append((child, toks + list(edge),
                                  pay + [child.entry.arrays]))
                    extended = True
                if extended or not pay:
                    continue
                nbytes = sum(a.nbytes for chunk in pay for a in chunk)
                if spent + nbytes > budget:
                    continue
                spent += nbytes
                out.append((toks, pay))
            return out

    def import_chain(self, tokens, chunk_payloads) -> int:
        """Seed a full chain from its root (the migration import half):
        ``chunk_payloads`` covers EVERY chunk of ``tokens``; chunks the
        store already holds are skipped (their resident payloads win — they
        came off this engine's own device). Returns the number of tokens
        newly covered (0 when fully covered already, or when the insert was
        refused)."""
        c = self.chunk_tokens
        n = len(tokens) - len(tokens) % c
        tokens = list(tokens[:n])
        if not tokens:
            return 0
        if len(chunk_payloads) < n // c:
            raise ValueError(
                f"{len(chunk_payloads)} payload chunks cannot cover the "
                f"{n // c} chunks of the token chain")
        with self._lock:
            have = self.covered(tokens)
            if have >= n:
                return 0
            ok = self.insert(tokens, have, chunk_payloads[have // c: n // c])
        return n - have if ok else 0

    # ---- mutation ---------------------------------------------------------

    def insert(self, tokens, offset: int,
               chunk_payloads: list[list[torch.Tensor]]) -> bool:
        """Store payloads for the chunks of ``tokens[offset:]``.

        ``offset`` must be chunk-aligned and the chain ``tokens[:offset]``
        must still be fully stored (the caller snapshotted only the missing
        suffix); if eviction broke the chain in between, the insert is
        refused — a gap would make longest-match claim coverage the store
        cannot restore. Returns True when stored."""
        c = self.chunk_tokens
        if offset % c:
            raise ValueError(
                f"insert offset {offset} is not chunk-aligned (chunk={c})")
        chunks = self._chunks(tokens)
        if offset // c + len(chunk_payloads) > len(chunks):
            raise ValueError(
                f"{len(chunk_payloads)} payload chunks at offset {offset} "
                f"exceed the {len(chunks)} chunks of the token prefix")
        with self._lock:
            node, walked = self._root, []
            for chunk in chunks[: offset // c]:
                child = node.children.get(chunk)
                if child is None or child.entry is None:
                    return False  # chain broken since covered() — refuse
                node = child
                walked.append(child)
            for chunk, arrays in zip(chunks[offset // c:], chunk_payloads):
                child = node.children.get(chunk)
                if child is None:
                    child = _Node(node, chunk)
                    node.children[chunk] = child
                if child.entry is None:
                    entry = _Entry(list(arrays))
                    child.entry = entry
                    self.bytes_held += entry.nbytes
                    self.n_inserts += 1
                    self._lru[id(child)] = child
                node = child
                walked.append(child)
            # The WHOLE chain — validated prefix included — is refreshed
            # leaf-to-root so the root ends newest and eviction under the
            # budget this insert may breach drops the chain's tail, not the
            # prefix chunks the new suffix depends on.
            self._touch_chain(walked)
            self._evict_to_budget()
        return True

    def _evict_to_budget(self) -> None:
        """Caller holds the lock. Drop least-recently-used chunk payloads
        until under budget; prune payload-less leaf nodes so the trie's own
        footprint stays bounded too."""
        while self.bytes_held > self.max_bytes and self._lru:
            _, node = self._lru.popitem(last=False)
            assert node.entry is not None
            self.bytes_held -= node.entry.nbytes
            node.entry = None
            self.n_evictions += 1
            while (node.parent is not None and node.entry is None
                   and not node.children):
                parent = node.parent
                parent.children.pop(node.edge, None)
                node = parent

    def clear(self) -> None:
        with self._lock:
            self._root = _Node(None, None)
            self._lru.clear()
            self.bytes_held = 0

    def stats(self) -> dict:
        with self._lock:
            return {
                "chunk_tokens": self.chunk_tokens,
                "max_bytes": self.max_bytes,
                "bytes_held": self.bytes_held,
                "entries": len(self._lru),
                "inserts_total": self.n_inserts,
                "evictions_total": self.n_evictions,
            }
