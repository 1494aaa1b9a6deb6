"""Per-family device-time latency model.

Every reaped decode dispatch's time is attributed to its program family
(``plain``, ``loop``, ``verify``, ``dfa``, ``spec_loop``, …; the engine's
``program_family`` maps a graph key to one), and admission-path calls to
theirs (``single_shot``, ``seg``, ``register``, ``restore``). Each family
keeps an EWMA, running totals and a bounded sample reservoir for exact
p50/p99. On the card a decode dispatch's time is its graph replay's device
time, read from a pair of CUDA events at reap; on the CPU it is the host's
dispatch-to-ready stamp. The process-wide exposition is
``quorum_tpu_dispatch_device_seconds{family=...}`` (observability.py); this
object is the per-engine view served on ``GET /debug/engine/timeline``.
"""

from __future__ import annotations

import math
import threading
from collections import deque

# EWMA weight: the engine's CHUNK_EWMA_ALPHA, so the decode family's
# estimate tracks the deadline clamp's scalar.
EWMA_ALPHA = 0.3
# Bounded per-family reservoir for exact percentiles: big enough for a
# bench leg's full dispatch count, small enough to never matter.
MAX_SAMPLES = 512


class _Family:
    __slots__ = ("count", "total_s", "ewma_s", "samples")

    def __init__(self):
        self.count = 0
        self.total_s = 0.0
        self.ewma_s = 0.0
        self.samples: deque = deque(maxlen=MAX_SAMPLES)


class LatencyModel:
    """Thread-safe per-family dispatch-latency statistics (one per engine,
    observed from the decode loop's reap and the admission paths)."""

    def __init__(self, alpha: float = EWMA_ALPHA):
        self.alpha = float(alpha)
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}

    def observe(self, family: str, seconds: float) -> None:
        s = max(0.0, float(seconds))
        with self._lock:
            f = self._families.get(family)
            if f is None:
                f = _Family()
                self._families[family] = f
            f.count += 1
            f.total_s += s
            f.ewma_s = (s if f.count == 1
                        else (1 - self.alpha) * f.ewma_s + self.alpha * s)
            f.samples.append(s)

    def ewma(self, family: str) -> float:
        """The family's EWMA estimate in seconds (0.0 before any sample)."""
        with self._lock:
            f = self._families.get(family)
            return f.ewma_s if f is not None else 0.0

    def families(self) -> list[str]:
        with self._lock:
            return sorted(self._families)

    @staticmethod
    def _pct(samples: list[float], p: float) -> float:
        """Nearest-rank percentile over sorted ``samples`` (ceil(p% · n)'th
        value, 1-indexed) — int(p/100·n) would overshoot by one rank
        whenever p% · n lands on an integer."""
        if not samples:
            return 0.0
        idx = max(0, math.ceil(p / 100 * len(samples)) - 1)
        return samples[min(len(samples) - 1, idx)]

    def snapshot(self) -> dict[str, dict]:
        """{family: {count, total_s, ewma_ms, p50_ms, p99_ms}} — the
        JSON-able per-engine view (timeline endpoint, bench legs)."""
        with self._lock:
            items = [(name, f.count, f.total_s, f.ewma_s, sorted(f.samples))
                     for name, f in self._families.items()]
        out = {}
        for name, count, total_s, ewma_s, samples in items:
            out[name] = {
                "count": count,
                "total_s": round(total_s, 6),
                "ewma_ms": round(ewma_s * 1e3, 3),
                "p50_ms": round(self._pct(samples, 50) * 1e3, 3),
                "p99_ms": round(self._pct(samples, 99) * 1e3, 3),
            }
        return out
