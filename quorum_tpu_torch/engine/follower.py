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
- ``handoff`` (a disaggregated engine's prefill group, whose cache is the
  rank's cut of the staging cache): a staged row's positions sliced and
  all-gathered over tp, so rank 0 holds the piece of every kv head;
- ``inject`` (its decode group): the piece of every kv head broadcast
  from rank 0, the rank's entries written into its cache row;
- ``report``: what this rank saw and holds — the tokens it fed per cache
  row (while the row was live) since the last report, its kernel launches
  and collectives, its weight and cache bytes and peak device memory.

The rank's own rank 0 state (sampling, the scheduler's bookkeeping) does not
exist here: a worker keeps no per-request state. On a mesh whose dp cuts
the slot rows the rank's cache holds its dp group's rows
(``RankMesh.hold_slots``); the plans name global rows.

On a pipeline-staged mesh (pp > 1) the rank is a later stage: it holds its
layers and their cache slice only, a ``prefill`` plan runs its layers on
the hidden states the previous stage hands it (``parallel/pipeline``), and
a ``decode`` plan runs the staged schedule's half of this stage (one graph
replay of it over NCCL on a card).

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
from quorum_tpu_torch.engine.graphs import DecodeGraphs
from quorum_tpu_torch.models.convert import params_from_numpy
from quorum_tpu_torch.models.init import init_params_shard, init_params_stacked_shard
from quorum_tpu_torch.models.transformer import (broadcast_member_rows, follow_decode_step,
                                                 host_to_device, init_cache, member_params,
                                                 prefill, prefill_segment)
from quorum_tpu_torch.ops.flash_attention import flash_prefill_attention
from quorum_tpu_torch.ops.flash_decode import flash_decode_attention
from quorum_tpu_torch.ops.flash_decode_q8 import flash_decode_q8_attention
from quorum_tpu_torch.parallel.comm import collective_counts
from quorum_tpu_torch.parallel.pipeline import follow_staged_decode, follow_staged_prefill
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
    ``kv_quant``."""

    def __init__(self, mesh, *, spec, seed: int, rows: int, sp_impl: str = "ring",
                 shard=None, ckpt=None, quant: str | None = None,
                 kv_quant: str | None = None, seeds: list[int] | None = None,
                 members: int = 1, ensemble: int = 1):
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
        self._ck, self._cv = init_cache(spec, stack * (self._own[1] - self._own[0]), device=dev,
                                        kv_quant=kv_quant, n_kv_heads=n_kv, layers=hi - lo)
        n = members * rows  # the engine's sampled rows
        self._tok = torch.zeros((n,), dtype=torch.long, device=dev)
        self._pos = torch.zeros((n,), dtype=torch.int32, device=dev)
        self._wm = torch.zeros((n,), dtype=torch.bool, device=dev)
        self.fed: list[list[int]] = [[] for _ in range(n)]
        self._stream = self._graphs = None
        if dev.type == "cuda":
            self._stream = torch.cuda.Stream(dev)
            self._stream.wait_stream(torch.cuda.current_stream(dev))
            if mesh.graphs_ok:
                self._graphs = DecodeGraphs(dev, self._stream)

    @contextlib.contextmanager
    def _scope(self):
        with torch.no_grad():
            if self._stream is None:
                yield
            else:
                with torch.cuda.stream(self._stream):
                    yield

    def prefill(self, prompts: list[list[int]], bucket: int, slot: int | None = None,
                rows: list[int | None] | None = None, member: int | None = None,
                dedup: bool = False) -> None:
        """A single-shot admission's prefill: ``prompts`` into flat cache row
        ``slot``, or batch row b into ``rows[b]`` (a stacked engine's
        member-coalesced group, an ensemble's weight sets); ``member``: one
        member's admission through its weight views; ``dedup``: member 0's
        K/V then copied into every member's row of the slot."""
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
            if dedup:
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
                member: int | None = None) -> None:
        params = self.params if member is None else member_params(self.params, member)
        with self._scope():
            tokens = host_to_device([sg + [0] * (bucket - len(sg)) for sg in segs], torch.long,
                                    self.device)
            prefill_segment(params, self.spec, tokens, offsets, self._ck, self._cv,
                            rows=rows, history=history, n_valid=n_valid, mesh=self.mesh)
        for r, off in zip(rows, offsets):
            if r is not None and off == 0 and r < len(self.fed):
                self.fed[r] = []

    def handoff(self, row: int, start: int, n: int) -> None:
        with self._scope():
            chunk = kv_transfer.slice_rows((self._ck, self._cv), row, start, n)
            kv_transfer.gather_heads(chunk, self.mesh, self.spec)

    def inject(self, row: int, start: int, n: int) -> None:
        s = self.spec
        q8 = isinstance(self._ck, tuple)
        # A side's leaves in wire order: values [L, K, n, hd], then (int8)
        # their scales [L, K, n].
        side = ([((s.n_layers, s.n_kv_heads, n, s.head_dim), torch.int8),
                 ((s.n_layers, s.n_kv_heads, n), torch.float32)] if q8 else
                [((s.n_layers, s.n_kv_heads, n, s.head_dim), self._ck.dtype)])
        with self._scope():
            leaves = [torch.empty(shape, dtype=dt, device=self.device)
                      for _ in range(2) for shape, dt in side]
            for leaf in leaves:
                self.mesh.tp.broadcast(leaf, 0)
            whole = kv_transfer.chunk_from_leaves(leaves, q8)
            kv_transfer.write_rows((self._ck, self._cv),
                                   kv_transfer.select_heads(whole, self.mesh, s), row, start)
        if row < len(self.fed):
            self.fed[row] = []

    def _program(self, n: int) -> torch.Tensor:
        """``n`` decode steps fed by rank 0; returns ``[n, 2, rows]`` (each
        step's tokens and write mask)."""
        out = []
        for _ in range(n):
            tok, wm = follow_decode_step(self.params, self.spec, self._tok, self._pos, self._wm,
                                         self._ck, self._cv, self.mesh, self.ensemble)
            out.append(torch.stack([tok, wm.long()]))
        return torch.stack(out)

    def _staged(self, n_steps: int, n_chunks: int) -> None:
        follow_staged_decode(self.params["blocks"], self.spec, self.mesh, n_steps, n_chunks,
                             self.rows, self._ck, self._cv)

    def decode(self, n_steps: int, n_chunks: int, warm: bool = False) -> None:
        """One dispatch of ``n_steps × n_chunks`` steps; ``warm``: rank 0
        runs its eager warm-up step first, and so does this rank. A later
        pipeline stage runs its half of the staged schedule, which feeds it
        no tokens (``fed`` stays empty)."""
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
        with self._scope():
            if warm:
                self._program(1)
            if self._graphs is None:
                fed = self._program(n)
            else:
                fed = self._graphs.replay((n,), lambda: self._program(n), lambda: None)
            fed = fed.cpu()
        lo, hi = self._own
        for step in fed:
            for row in torch.nonzero(step[1]).flatten().tolist():
                if lo <= row % self.rows < hi:
                    self.fed[row].append(int(step[0, row]))

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
            "cache_bytes": sum(t.numel() * t.element_size()
                               for t in _tensors({"k": self._ck, "v": self._cv})),
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
        self.params = self._ck = self._cv = None
