"""A worker rank's half of a multi-rank engine (``parallel/ranks.py`` builds
it in each spawned rank): the rank's shard of the weights and of the KV
cache, and the device programs rank 0's plans name, run in the order they
arrive — collective for collective what rank 0's engine runs:

- ``prefill``: a single-shot admission's prefill into one cache row;
- ``segment``: one chunked-prefill segment call;
- ``decode``: one decode dispatch of ``n_steps × n_chunks`` steps, each
  step's token, positions and write mask broadcast by rank 0 (rank 0
  samples; every rank feeds the same token), run eagerly: workers exist
  only on gloo meshes (``make_mesh`` refuses NCCL meshes of several
  ranks), whose host-staged collectives no graph can capture;
- ``report``: what this rank saw and holds — the tokens it fed per cache
  row (while the row was live) since the last report, its kernel launches
  and collectives, its weight and cache bytes and peak device memory.

The rank's own rank 0 state (sampling, the scheduler's bookkeeping) does not
exist here: a worker keeps no per-request state.
"""

from __future__ import annotations

import contextlib

import torch

from quorum_tpu_torch.models.convert import params_from_numpy
from quorum_tpu_torch.models.init import init_params_shard
from quorum_tpu_torch.models.transformer import (follow_decode_step, host_to_device,
                                                 init_cache, prefill, prefill_segment)
from quorum_tpu_torch.ops.flash_attention import flash_prefill_attention
from quorum_tpu_torch.ops.flash_decode import flash_decode_attention
from quorum_tpu_torch.parallel.comm import collective_counts
from quorum_tpu_torch.parallel.sharding import rank_kv_heads


def _tensors(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _tensors(v)
        elif v is not None:
            yield v


class Follower:
    """One worker rank of an engine on ``mesh`` (its ``RankMesh``): weights
    from ``seed`` (cut by ``init_params_shard``) or the given ``shard`` (a
    host tree and its dtype), a cache of ``rows`` rows of its kv heads."""

    def __init__(self, mesh, *, spec, seed: int, rows: int, sp_impl: str = "ring",
                 shard=None):
        self.mesh = mesh
        self.spec = spec
        self.sp_impl = sp_impl
        self.device = dev = mesh.device
        if shard is None:
            self.params = init_params_shard(spec, seed, mesh, mesh.rank, dev)
        else:
            tree, dtype = shard
            self.params = params_from_numpy(tree, device=dev, dtype=dtype)
        lo, hi = rank_kv_heads(spec.n_heads, spec.n_kv_heads, mesh.tp_size, mesh.tp_rank)
        self._ck, self._cv = init_cache(spec, rows, device=dev, n_kv_heads=hi - lo)
        self._tok = torch.zeros((rows,), dtype=torch.long, device=dev)
        self._pos = torch.zeros((rows,), dtype=torch.int32, device=dev)
        self._wm = torch.zeros((rows,), dtype=torch.bool, device=dev)
        self.fed: list[list[int]] = [[] for _ in range(rows)]
        self._stream = None
        if dev.type == "cuda":
            self._stream = torch.cuda.Stream(dev)
            self._stream.wait_stream(torch.cuda.current_stream(dev))

    @contextlib.contextmanager
    def _scope(self):
        with torch.no_grad():
            if self._stream is None:
                yield
            else:
                with torch.cuda.stream(self._stream):
                    yield

    def prefill(self, prompt: list[int], bucket: int, slot: int) -> None:
        with self._scope():
            tokens = host_to_device([prompt + [0] * (bucket - len(prompt))], torch.long,
                                    self.device)
            lengths = host_to_device([max(1, len(prompt))], torch.int32, self.device)
            prefill(self.params, self.spec, tokens, lengths, self._ck, self._cv, slot=slot,
                    mesh=self.mesh, sp_impl=self.sp_impl)
        self.fed[slot] = []

    def segment(self, segs: list[list[int]], bucket: int, offsets: list[int],
                rows: list[int], history: int, n_valid: list[int]) -> None:
        with self._scope():
            tokens = host_to_device([sg + [0] * (bucket - len(sg)) for sg in segs], torch.long,
                                    self.device)
            prefill_segment(self.params, self.spec, tokens, offsets, self._ck, self._cv,
                            rows=rows, history=history, n_valid=n_valid, mesh=self.mesh)
        for r, off in zip(rows, offsets):
            if r is not None and off == 0:
                self.fed[r] = []

    def _program(self, n: int) -> torch.Tensor:
        """``n`` decode steps fed by rank 0; returns ``[n, 2, rows]`` (each
        step's tokens and write mask)."""
        out = []
        for _ in range(n):
            tok, wm = follow_decode_step(self.params, self.spec, self._tok, self._pos, self._wm,
                                         self._ck, self._cv, self.mesh)
            out.append(torch.stack([tok, wm.long()]))
        return torch.stack(out)

    def decode(self, n_steps: int, n_chunks: int) -> None:
        with self._scope():
            fed = self._program(n_steps * n_chunks).cpu()
        for step in fed:
            for row in torch.nonzero(step[1]).flatten().tolist():
                self.fed[row].append(int(step[0, row]))

    def report(self, reset_peak: bool = False) -> dict:
        """The rank's observations since the last report (fed tokens are
        handed over and cleared)."""
        fed, self.fed = self.fed, [[] for _ in self.fed]
        dev = self.device
        out = {
            "rank": self.mesh.rank,
            "fed": fed,
            "launches": {"flash_prefill": flash_prefill_attention.launches,
                         "flash_decode": flash_decode_attention.launches},
            "collectives": collective_counts(),
            "weight_bytes": sum(t.numel() * t.element_size() for t in _tensors(self.params)),
            "cache_bytes": sum(t.numel() * t.element_size() for t in (self._ck, self._cv)),
            "peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0,
        }
        if reset_peak and dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        return out

    def close(self) -> None:
        if self._stream is not None:
            self._stream.synchronize()
        self.params = self._ck = self._cv = None
