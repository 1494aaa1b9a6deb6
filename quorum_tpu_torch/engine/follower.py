"""A worker rank's half of a multi-rank engine (``parallel/ranks.py`` builds
it in each spawned rank): the rank's shard of the weights and of the KV
cache, and the device programs rank 0's plans name, run in the order they
arrive — collective for collective what rank 0's engine runs:

- ``prefill``: a single-shot admission's prefill into one cache row;
- ``segment``: one chunked-prefill segment call;
- ``decode``: one decode dispatch of ``n_steps × n_chunks`` steps, each
  step's token, positions and write mask broadcast by rank 0 (rank 0
  samples; every rank feeds the same token). Over NCCL on a card the
  dispatch is one replay of a CUDA graph per step count, as rank 0's is,
  and when rank 0's dispatch starts with its eager warm-up step (its first
  capture) the plan says so and this rank runs one eager step first:
  collective for collective the same sequence. Over gloo (host-staged
  collectives, which no graph captures) it runs eagerly;
- ``verify``: one speculative dispatch of ``n_turns`` verify turns at
  width g+1 (a prompt-lookup turn, or a fused draft→verify dispatch whose
  draft model runs on rank 0 alone): each turn's anchor, drafts, positions
  and write mask broadcast by rank 0, then ``decode_multi`` at the rank's
  heads. Over NCCL one replay of a graph per (width, turns, history), its
  warm-up turn mirrored as ``decode``'s is; the verify turns feed no
  ``fed`` entries (which tokens a turn accepts only rank 0 knows);
- ``forward``: an embedding or scoring forward sub-batch of rank 0's
  padded tokens and lengths — ``forward_hidden`` at the rank's heads (K1
  on the card) and, under sp, its sequence block over the ring or Ulysses
  (the blocks all-gathered), then on sp rank 0 the unembed of each scored
  span (its all-gather over tp); on a later
  pipeline stage its layers between the hops (``parallel/pipeline.
  follow_staged_forward``) — on a forward stream of its own over the
  forward groups (``parallel/comm.StreamMesh``), once the ring's and the
  staging stream's work has drained, and drained itself before the next
  plan: rank 0 parks its ring for it, so no collective of another
  communicator runs beside it. Ranks of rank 0's dp group only (a forward
  runs there whole);
- ``handoff`` (a disaggregated engine's prefill group, whose cache is the
  rank's cut of the staging cache): a staged row's positions sliced and
  all-gathered over tp, so rank 0 holds the piece of every kv head;
- ``inject`` (its decode group): the piece of every kv head broadcast
  from rank 0, the rank's entries written into its cache row;
- ``table`` / ``cow`` (``kv_pages``): rank 0's page table, whose rows of
  this rank's dp group it copies into its device table in place (its
  graphs read that address), and the copy-on-write page copies of a
  claim, into its pool (every page id, its own kv heads);
- ``snapshot`` / ``restore`` (the host prefix store on rank 0): a row's
  positions sliced and gathered over its group's tp (and sent over dp to
  rank 0's group), or a stored chunk broadcast from rank 0 and the rank's
  entries written into its row, its pages or (``stage``) its staging row
  (``cache/kv_transfer.snapshot_rows`` / ``restore_rows``);
- ``stage_inject`` / ``drop_pieces`` (``zero_drain``): a piece sliced from
  the staging row after a segment written into the decode row (or its
  pages) on the ring's stream, or dropped with its dead admission;
- ``report``: what this rank saw and holds — the tokens it fed per cache
  row (while the row was live) since the last report, its kernel launches
  and collectives, its weight, cache, page pool and staging bytes and peak
  device memory.

A zero-drain rank holds a dense staging cache for its dp group's rows at
its kv heads (dense under ``kv_pages`` too, as the JAX engine's) and runs
every segment into it on a staging stream of its own, whose collectives go
over the staging groups (``parallel/comm.StreamMesh``); each segment's
pieces are sliced there right after it, behind an event the ring's stream
waits on before their injection.

The rank's own rank 0 state (sampling, the scheduler's bookkeeping) does not
exist here: a worker keeps no per-request state. On a mesh whose dp cuts
the slot rows the rank's cache holds its dp group's rows
(``RankMesh.hold_slots``); the plans name global rows.

On a pipeline-staged mesh (pp > 1) the rank is a later stage: it holds its
layers and their cache slice only (int8 leaves and an int8 slice with
``quant`` and ``kv_quant``), a ``prefill`` plan runs its layers on the
hidden states the previous stage hands it (``parallel/pipeline``), a
``decode`` plan runs the staged schedule's half of this stage (one graph
replay of it over NCCL on a card; K2q8 on an int8 slice) and a
``forward`` plan its layers of the staged forward.

The weights: the rank's cut of ``init_params(spec, seed, quant=)`` (of
``init_params_stacked(spec, seeds, quant=)`` on a stacked engine), or a cut
rank 0 sent (``params=`` engines), or, on a checkpoint engine, its own cut
read from the checkpoint's mapped files (``models/hf_loader``); an int8
leaf's scales are the whole leaf's. The cache holds ``stack`` rows per slot
(members or ensemble weight sets, ``m·S + s``), int8 with ``kv_quant``.
"""

from __future__ import annotations

import contextlib

import torch

from quorum_tpu_torch.cache import kv_transfer
from quorum_tpu_torch.cache.paging import copy_member_pages, init_paged_cache, paged_copy_page
from quorum_tpu_torch.engine.graphs import DecodeGraphs
from quorum_tpu_torch.models.convert import params_from_numpy
from quorum_tpu_torch.models.init import init_params_shard, init_params_stacked_shard
from quorum_tpu_torch.models.transformer import (broadcast_member_rows, follow_decode_multi,
                                                 follow_decode_step, forward_hidden,
                                                 host_to_device, init_cache, member_params,
                                                 prefill, prefill_segment, unembed)
from quorum_tpu_torch.ops.flash_attention import flash_prefill_attention
from quorum_tpu_torch.ops.flash_decode import flash_decode_attention
from quorum_tpu_torch.ops.flash_decode_q8 import flash_decode_q8_attention
from quorum_tpu_torch.parallel.comm import collective_counts
from quorum_tpu_torch.parallel.pipeline import (follow_staged_decode, follow_staged_forward,
                                                follow_staged_prefill)
from quorum_tpu_torch.parallel.sharding import rank_kv_index, stage_layers


def _tensors(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _tensors(v)
        elif isinstance(v, tuple):  # an int8 cache side: (values, scales)
            yield from v
        elif v is not None:
            yield v


class Follower:
    """One worker rank of an engine on ``mesh`` (its ``RankMesh``): weights
    from ``seed`` (cut by ``init_params_shard``; ``seeds``, one per weight
    set, by ``init_params_stacked_shard``), the given ``shard`` (a host
    tree and its dtype) or its cut of the checkpoint ``ckpt`` (path,
    dtype), all quantized with ``quant``; a cache of its kv heads and its
    stage's layers for its dp group's share of ``rows`` slots, one row per
    slot of each of ``members`` / ``ensemble`` weight sets, int8 with
    ``kv_quant``; with ``kv_pages`` (pool pages, page size) that cache is
    the rank's cut of the page pool and its table, with ``zero_drain`` a
    dense staging cache beside it."""

    def __init__(self, mesh, *, spec, seed: int, rows: int, sp_impl: str = "ring",
                 shard=None, ckpt=None, quant: str | None = None,
                 kv_quant: str | None = None, seeds: list[int] | None = None,
                 members: int = 1, ensemble: int = 1,
                 kv_pages: tuple[int, int] | None = None, zero_drain: bool = False):
        self.mesh = mesh
        self.spec = spec
        self.sp_impl = sp_impl
        self.rows = rows
        self.members, self.ensemble = members, ensemble
        stack = max(members, ensemble)
        self.device = dev = mesh.device
        if ckpt is not None:
            from quorum_tpu_torch.models.hf_loader import load_hf_checkpoint

            self.params = load_hf_checkpoint(ckpt[0], dtype=ckpt[1], device=dev, quant=quant,
                                             mesh=mesh, rank=mesh.rank)[1]
        elif shard is not None:
            tree, dtype = shard
            self.params = params_from_numpy(tree, device=dev, dtype=dtype)
        elif stack > 1:
            self.params = init_params_stacked_shard(spec, seeds, mesh, mesh.rank, dev,
                                                    quant=quant)
        else:
            self.params = init_params_shard(spec, seed, mesh, mesh.rank, dev, quant=quant)
        n_kv = len(rank_kv_index(spec.n_heads, spec.n_kv_heads, mesh.tp_size, mesh.tp_rank))
        lo, hi = stage_layers(spec.n_layers, mesh.pp_size, mesh.pp_rank)
        self._own = mesh.hold_slots(rows)
        held = self._own[1] - self._own[0]
        self._table = None
        if kv_pages is not None:
            self._ck, self._cv = init_paged_cache(
                spec, held, kv_pages[0], kv_pages[1], kv_quant=kv_quant,
                members=members if members > 1 else None, device=dev, n_kv_heads=n_kv)
            self._table = self._ck.table
        else:
            self._ck, self._cv = init_cache(spec, stack * held, device=dev, kv_quant=kv_quant,
                                            n_kv_heads=n_kv, layers=hi - lo)
        self._sck = self._scv = None
        if zero_drain:
            self._sck, self._scv = init_cache(spec, stack * held, device=dev,
                                              kv_quant=kv_quant, n_kv_heads=n_kv)
        # Staged pieces waiting for their injection: (row, start) → (chunk,
        # the event behind its slice on the staging stream).
        self._pieces: dict[tuple[int, int], tuple] = {}
        n = members * rows  # the engine's sampled rows
        self._tok = torch.zeros((n,), dtype=torch.long, device=dev)
        self._pos = torch.zeros((n,), dtype=torch.int32, device=dev)
        self._wm = torch.zeros((n,), dtype=torch.bool, device=dev)
        self.fed: list[list[int]] = [[] for _ in range(n)]
        # A verify turn's inputs at width g+1 (the broadcast's shapes).
        self._multi: dict[int, torch.Tensor] = {}
        self._stream = self._graphs = self._stage_stream = self._fwd_stream = None
        if dev.type == "cuda":
            self._stream = torch.cuda.Stream(dev)
            self._stream.wait_stream(torch.cuda.current_stream(dev))
            self._fwd_stream = torch.cuda.Stream(dev)
            self._fwd_stream.wait_stream(torch.cuda.current_stream(dev))
            if zero_drain:
                self._stage_stream = torch.cuda.Stream(dev)
                self._stage_stream.wait_stream(torch.cuda.current_stream(dev))
            if mesh.graphs_ok:
                self._graphs = DecodeGraphs(dev, self._stream)

    @contextlib.contextmanager
    def _scope(self, stage: bool = False, fwd: bool = False):
        """No grad, on the ring's stream (``stage``: the staging stream,
        ``fwd``: the forward stream)."""
        stream = self._stage_stream if stage else self._fwd_stream if fwd else self._stream
        with torch.no_grad():
            if stream is None:
                yield
            else:
                with torch.cuda.stream(stream):
                    yield

    def prefill(self, prompts: list[list[int]], bucket: int, slot: int | None = None,
                rows: list[int | None] | None = None, member: int | None = None,
                dedup=False) -> None:
        """A single-shot admission's prefill: ``prompts`` into flat cache row
        ``slot``, or batch row b into ``rows[b]`` (a stacked engine's
        member-coalesced group, an ensemble's weight sets); ``member``: one
        member's admission through its weight views; ``dedup``: member 0's
        K/V then copied into every member's row of the slot (on a paged
        cache ``dedup`` lists the pages to copy into every member's pool
        copy)."""
        if self.mesh.pp_size > 1:
            with self._scope():
                lengths = host_to_device([max(1, len(prompts[0]))], torch.int32, self.device)
                follow_staged_prefill(self.params["blocks"], self.spec,
                                      (1, bucket, self.spec.d_model), lengths, self._ck,
                                      self._cv, slot, self.mesh)
            self.fed[slot] = []
            return
        params = self.params if member is None else member_params(self.params, member)
        with self._scope():
            tokens = host_to_device([p + [0] * (bucket - len(p)) for p in prompts], torch.long,
                                    self.device)
            lengths = host_to_device([max(1, len(p)) for p in prompts], torch.int32,
                                     self.device)
            prefill(params, self.spec, tokens, lengths, self._ck, self._cv, slot=slot,
                    rows=rows, mesh=self.mesh, sp_impl=self.sp_impl)
            if dedup and self._table is not None:
                copy_member_pages((self._ck, self._cv), dedup, self.members)
            elif dedup:
                broadcast_member_rows(self._ck, self._cv, self.members, slot,
                                      len(prompts[0]), self.mesh)
        if dedup:
            written = [m * self.rows + slot for m in range(self.members)]
        else:
            written = [slot] if rows is None else [r for r in rows if r is not None]
        for r in written:
            if r < len(self.fed):  # an ensemble's rows past the first weight set feed none
                self.fed[r] = []

    def segment(self, segs: list[list[int]], bucket: int, offsets: list[int],
                rows: list[int], history: int, n_valid: list[int],
                member: int | None = None, pieces=None) -> None:
        """One chunked-prefill segment call; on a zero-drain rank into the
        staging cache on the staging stream (over the staging groups), then
        the ``pieces`` rank 0 queues behind it — ``(row, start, n)`` of the
        staging rows — sliced there where this rank's group holds the row,
        behind one event."""
        params = self.params if member is None else member_params(self.params, member)
        staged = self._sck is not None
        cache = (self._sck, self._scv) if staged else (self._ck, self._cv)
        with self._scope(stage=staged):
            tokens = host_to_device([sg + [0] * (bucket - len(sg)) for sg in segs], torch.long,
                                    self.device)
            prefill_segment(params, self.spec, tokens, offsets, *cache, rows=rows,
                            history=history, n_valid=n_valid,
                            mesh=self.mesh.stage if staged else self.mesh)
            if pieces:
                self._slice_pieces(pieces)
        for r, off in zip(rows, offsets):
            if r is not None and off == 0 and r < len(self.fed):
                self.fed[r] = []

    def _slice_pieces(self, pieces) -> None:
        event = None
        if self._stage_stream is not None:
            event = torch.cuda.Event()
        for row, start, n in pieces:
            local = kv_transfer.local_row(self.mesh, row)
            if local is not None:
                chunk = kv_transfer.slice_rows((self._sck, self._scv), local, start, n)
                self._pieces[(row, start)] = (chunk, event)
        if event is not None:
            event.record()

    def stage_inject(self, row: int, start: int) -> None:
        """Write the piece of ``row`` staged from ``start`` into the decode
        row (its pages on a paged cache) on the ring's stream, after the
        piece's slice: a local copy, no collective."""
        piece = self._pieces.pop((row, start), None)
        if piece is None:
            return  # another dp group holds the row
        chunk, event = piece
        with self._scope():
            if event is not None:
                self._stream.wait_event(event)
            kv_transfer.write_rows((self._ck, self._cv), chunk,
                                   kv_transfer.local_row(self.mesh, row), start)
            if self._stream is not None:
                for leaf in kv_transfer.chunk_leaves(chunk):
                    leaf.record_stream(self._stream)

    def drop_pieces(self, keys=None) -> None:
        """Forget the staged pieces of a dead admission (``keys``, its
        ``(row, start)`` pairs), or every piece."""
        if keys is None:
            self._pieces.clear()
        for key in keys or ():
            self._pieces.pop(tuple(key), None)

    def table(self, full) -> None:
        """Rank 0's page table ``[rows, max_pages]`` (member offsets in):
        this rank's dp group's rows copied into the device table in place."""
        tab = torch.as_tensor(full, dtype=torch.int32)
        lo, hi = self._own
        tab = tab.view(-1, self.rows, tab.shape[-1])[:, lo:hi].reshape(-1, tab.shape[-1])
        with self._scope():
            host_to_device(tab.tolist(), torch.int32, self.device, out=self._table)

    def cow(self, pairs) -> None:
        """A claim's copy-on-write page copies (dst ← src, every member's
        pool copy): page ids are the host allocator's, every rank's pool
        holds them all."""
        with self._scope():
            for dst, src in pairs:
                paged_copy_page(self._ck, dst, src, members=self.members)
                paged_copy_page(self._cv, dst, src, members=self.members)

    def snapshot(self, row: int, start: int, n: int) -> None:
        with self._scope():
            kv_transfer.snapshot_rows((self._ck, self._cv), row, start, n, self.mesh, self.spec)

    def restore(self, row: int, start: int, n: int, stage: bool = False) -> None:
        """A stored chunk's positions into ``row``: the decode row, or with
        ``stage`` the staging row (a zero-drain rank's staging cache on its
        staging stream; a disaggregated prefill group's cache, which is its
        cut of the staging cache)."""
        staged = stage and self._sck is not None
        cache = (self._sck, self._scv) if staged else (self._ck, self._cv)
        with self._scope(stage=staged):
            kv_transfer.restore_rows(cache, None, row, start, n,
                                     self.mesh.stage if staged else self.mesh, self.spec)

    def handoff(self, row: int, start: int, n: int) -> None:
        with self._scope():
            chunk = kv_transfer.slice_rows((self._ck, self._cv), row, start, n)
            kv_transfer.gather_heads(chunk, self.mesh, self.spec)

    def inject(self, row: int, start: int, n: int) -> None:
        """A handed-off piece of every kv head broadcast from rank 0 over
        tp, this rank's entries written into its row (its pages)."""
        with self._scope():
            kv_transfer.restore_rows((self._ck, self._cv), None, row, start, n, self.mesh,
                                     self.spec)
        if row < len(self.fed):
            self.fed[row] = []

    def _program(self, n: int, history: int | None = None) -> torch.Tensor:
        """``n`` decode steps fed by rank 0 (``history``: a paged cache's
        window); returns ``[n, 2, rows]`` (each step's tokens and write
        mask)."""
        out = []
        for _ in range(n):
            tok, wm = follow_decode_step(self.params, self.spec, self._tok, self._pos, self._wm,
                                         self._ck, self._cv, self.mesh, self.ensemble,
                                         history=history)
            out.append(torch.stack([tok, wm.long()]))
        return torch.stack(out)

    def _staged(self, n_steps: int, n_chunks: int) -> None:
        follow_staged_decode(self.params["blocks"], self.spec, self.mesh, n_steps, n_chunks,
                             self.rows, self._ck, self._cv)

    def decode(self, n_steps: int, n_chunks: int, warm: bool = False,
               history: int | None = None) -> None:
        """One dispatch of ``n_steps × n_chunks`` steps; ``warm``: rank 0
        runs its eager warm-up step first, and so does this rank; a paged
        rank gathers rank 0's ``history`` window (its graphs keyed by it). A
        later pipeline stage runs its half of the staged schedule, which
        feeds it no tokens (``fed`` stays empty)."""
        if self.mesh.pp_size > 1:
            with self._scope():
                if warm:
                    self._staged(1, 1)
                if self._graphs is None:
                    self._staged(n_steps, n_chunks)
                else:
                    self._graphs.replay(("pp", n_steps, n_chunks),
                                        lambda: self._staged(n_steps, n_chunks), lambda: None)
            return
        n = n_steps * n_chunks
        key = (n,) if history is None else ("paged", n, history)
        with self._scope():
            if warm:
                self._program(1, history)
            if self._graphs is None:
                fed = self._program(n, history)
            else:
                fed = self._graphs.replay(key, lambda: self._program(n, history), lambda: None)
            fed = fed.cpu()
        lo, hi = self._own
        for step in fed:
            for row in torch.nonzero(step[1]).flatten().tolist():
                if lo <= row % self.rows < hi:
                    self.fed[row].append(int(step[0, row]))

    def _verify_turns(self, width: int, n_turns: int, history: int) -> None:
        """``n_turns`` verify turns at ``width`` fed by rank 0 (the
        inputs' shapes from fixed tensors, so a graph reads one address)."""
        tok = self._multi.get(width)
        if tok is None:
            tok = self._multi[width] = torch.zeros((self._tok.shape[0], width),
                                                   dtype=torch.long, device=self.device)
        for _ in range(n_turns):
            follow_decode_multi(self.params, self.spec, tok, self._pos, self._wm, self._ck,
                                self._cv, self.mesh, history=history, ensemble=self.ensemble)

    def verify(self, width: int, n_turns: int, warm: bool, history: int) -> None:
        """One speculative dispatch of ``n_turns`` verify turns of ``width``
        positions over rank 0's ``history`` bucket; ``warm``: rank 0 runs its
        key family's eager warm-up turn first, and so does this rank."""
        key = ("verify", width, n_turns, history)
        with self._scope():
            if warm:
                self._verify_turns(width, 1, history)
            if self._graphs is None:
                self._verify_turns(width, n_turns, history)
            else:
                self._graphs.replay(key, lambda: self._verify_turns(width, n_turns, history),
                                    lambda: None)

    def forward(self, tokens, lengths, member: int | None, spans, plain_attention: bool) -> None:
        """Rank 0's embedding or scoring forward sub-batch (``tokens [b, t]``
        and ``lengths [b]``, numpy), run on this rank's cut of the weights
        (``member``'s on a stacked engine) over the forward groups — the
        hidden states and, on sp rank 0, the unembed of each ``(p0, p1)``
        position span of ``spans`` (a scoring forward's chunks); a later
        pipeline stage runs its layers between the hops: the collectives
        rank 0's forward runs, in its order, with none of the ring's or the
        staging stream's beside them. Only rank 0's dp group runs
        forwards."""
        if self.mesh.dp_rank != 0:
            return
        for stream in (self._stream, self._stage_stream):
            if stream is not None:
                stream.synchronize()
        params = self.params if member is None else member_params(self.params, member)
        fm, spec = self.mesh.fwd, self.spec
        with self._scope(fwd=True):
            tok = torch.from_numpy(tokens).to(self.device)
            lens = torch.from_numpy(lengths).to(self.device)
            if self.mesh.pp_size > 1:
                follow_staged_forward(params["blocks"], spec, (*tok.shape, spec.d_model), lens,
                                      fm, plain_attention)
            else:
                h = forward_hidden(params, spec, tok, lens, plain_attention=plain_attention,
                                   mesh=fm, sp_impl=self.sp_impl)
                if self.mesh.sp_rank == 0:
                    for p0, p1 in spans:
                        unembed(params, spec, h[:, p0:p1], fm)
            if self._fwd_stream is not None:
                self._fwd_stream.synchronize()

    def report(self, reset_peak: bool = False, digest: bool = False) -> dict:
        """The rank's observations since the last report (fed tokens are
        handed over and cleared); with ``digest``, an exact fingerprint of
        each of its weight leaves (``training/checkpoint.tree_digest``: its
        cut held against a tree without moving either to the host)."""
        fed, self.fed = self.fed, [[] for _ in self.fed]
        dev = self.device
        out = {
            "rank": self.mesh.rank,
            "stage": self.mesh.pp_rank,
            "fed": fed,
            "launches": {"flash_prefill": flash_prefill_attention.launches,
                         "flash_decode": flash_decode_attention.launches,
                         "flash_decode_q8": flash_decode_q8_attention.launches},
            "collectives": collective_counts(),
            "weight_bytes": sum(t.numel() * t.element_size() for t in _tensors(self.params)),
            "cache_bytes": kv_transfer.kv_bytes(self._ck, self._cv),
            # The page pool's share of that (0 on a dense cache) and the
            # zero-drain staging cache's bytes.
            "pool_bytes": (kv_transfer.kv_bytes(self._ck, self._cv)
                           if self._table is not None else 0),
            "staging_bytes": kv_transfer.kv_bytes(self._sck, self._scv),
            "staged_pieces": len(self._pieces),
            "peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0,
        }
        if digest:
            from quorum_tpu_torch.training.checkpoint import tree_digest

            out["digest"] = tree_digest(self.params)
        if reset_peak and dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        return out

    def close(self) -> None:
        """Finish this rank's device work and destroy its graphs: the
        rank then leaves its groups (``parallel/ranks``), whose NCCL
        shutdown waits until no graph holds a collective of theirs."""
        if self._stream is not None:
            self._stream.synchronize()
        if self._graphs is not None:
            self._graphs.clear()
            torch.cuda.synchronize(self.device)
        for extra in (self._stage_stream, self._fwd_stream):
            if extra is not None:
                extra.synchronize()
        self._pieces.clear()
        self.params = self._ck = self._cv = self._sck = self._scv = self._table = None
