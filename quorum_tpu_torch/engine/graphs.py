"""CUDA graphs of an engine's decode dispatches: the port's counterpart of
the JAX engine's compiled-program cache.

The JAX engine jits one program per decode key (``_decode_fn``) and issues
a decode chunk — or, with ``decode_loop=C``, C chunks — as one call of it.
The port's decode program is Python that issues ≈ 40 kernels per layer per
step. :class:`DecodeGraphs` captures it once per key into a
``torch.cuda.CUDAGraph`` and issues every later dispatch of that key as one
replay, so a dispatch costs the host one launch instead of thousands.

What the program must keep, which the engine's decode path does:

- It reads and writes fixed tensors: the engine's per-row state, the KV
  cache, the weights and the static dispatch inputs (the active mask and the
  noise drawn ahead), all updated in place. What it returns (a tensor, or a
  tuple of tensors and None) is the graph's static output: read it (or copy
  it, on the stream) after a replay and before the next one.
- Nothing in it reads a device value on the host, makes a tensor from host
  data or allocates pinned memory.
- Lazy state exists before the first capture: K2's (or K2q8's) scratch and ticket
  counters for the stream, the RoPE tables, cuBLAS's workspace. The first
  capture of each key family (the engine's plain decode keys, and each
  speculative program) runs that family's ``warm_up`` eagerly on the
  capture stream first.

An engine captures and replays on its own stream, so the kernel scratch its
graphs hold is its own. Captures run in ``thread_local`` mode (another
engine's scheduler thread may allocate pinned memory or wait on an event
meanwhile) under one lock for the process. All of an engine's graphs share
one memory pool: they replay one at a time, in stream order. K2 launches
and K2q8 launches made inside a capture are counted per graph and wrapper
and added to each wrapper's ``launches`` at every replay.

There is no eager path on the card and no switch: a capture that fails
raises, and the engine fails its requests.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

import torch

from quorum_tpu_torch.ops.launches import add_launches, captured_launches, capturing

_CAPTURE_LOCK = threading.Lock()


class DecodeGraphs:
    """One captured graph per program key on one engine's ``stream``."""

    def __init__(self, device: torch.device, stream: torch.cuda.Stream):
        self.device = device
        self.stream = stream
        self.pool = torch.cuda.graph_pool_handle()
        self._graphs: dict[tuple, tuple[torch.cuda.CUDAGraph, object, dict]] = {}
        self._warmed: set = set()  # key families whose warm-up has run
        self.captures = 0
        self.capture_seconds = 0.0
        self.capture_seconds_by_key: dict[tuple, float] = {}  # each key's last capture
        self.replays = 0
        self.pool_bytes = 0

    def __contains__(self, key: tuple) -> bool:
        return key in self._graphs

    def replay(self, key: tuple, program: Callable[[], object],
               warm_up: Callable[[], None], family: str | None = None):
        """Replay ``key``'s graph on the current stream (the engine's),
        capturing ``program`` first if this key has none; returns the
        graph's static output. ``warm_up`` runs once per ``family`` (None:
        the plain decode keys), before that family's first capture."""
        entry = self._graphs.get(key)
        if entry is None:
            if family not in self._warmed:
                warm_up()
                self._warmed.add(family)
            t0 = time.perf_counter()
            entry = self._graphs[key] = self._capture(program)
            self.capture_seconds_by_key[key] = time.perf_counter() - t0
        graph, out, launches = entry
        graph.replay()
        add_launches(launches)
        self.replays += 1
        return out

    def _capture(self, program):
        with _CAPTURE_LOCK:
            t0 = time.perf_counter()
            n0 = captured_launches()
            graph = torch.cuda.CUDAGraph()
            with capturing(), torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                                               capture_error_mode="thread_local"):
                out = program()
            self.captures += 1
            self.capture_seconds += time.perf_counter() - t0
            self.pool_bytes = sum(
                seg["total_size"] for seg in torch.cuda.memory_snapshot()
                if tuple(seg.get("segment_pool_id", ())) == tuple(self.pool))
            n1 = captured_launches()
            return graph, out, {fn: n - n0.get(fn, 0) for fn, n in n1.items()}

    def drop(self, which: Callable[[tuple], bool]) -> None:
        """Drop the graphs whose key ``which`` selects (the pool stays)."""
        for key in [k for k in self._graphs if which(k)]:
            del self._graphs[key]

    def clear(self) -> None:
        """Drop every graph. Their pool goes with the last one, so later
        captures start a new pool."""
        self._graphs.clear()
        self.pool = torch.cuda.graph_pool_handle()
        self.pool_bytes = 0
