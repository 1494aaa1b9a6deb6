"""SLO accounting: per-class latency objectives, counters, burn rate.

Requests classify by **deadline headroom** at admission into two classes: a
request whose declared budget (the ``timeout`` body knob, else the config
default) is at most ``QUORUM_TPU_SLO_INTERACTIVE_S`` (default 30 s) is
``interactive``; anything looser is ``batch``. The class is tagged on the
request trace (``meta.slo``) and scored once at teardown
(``observability.finish_request_trace``), one good/breached observation per
stage:

  ``ttft``        first content byte within the class's TTFT target
  ``inter_token`` worst wire flush gap within the inter-token target
  ``deadline``    the request finished inside its deadline (a 504, or a
                  queue-stage 503 shed, is a breach)

Counters ride ``quorum_tpu_slo_{good,breached}_total{class=,stage=}``, and a
sliding-window **burn rate** per class (breached / observed over the last
``QUORUM_TPU_SLO_WINDOW_S``, default 300 s) is exposed on ``/health`` and
``GET /debug/engine/timeline``. ``QUORUM_TPU_SLO_READY_BURN`` set to a
fraction (e.g. ``0.5``) makes ``/health`` report ``degraded`` and ``/ready``
shed while any class burns past it; off by default.

Objective targets (seconds, from the environment):

  QUORUM_TPU_SLO_TTFT_INTERACTIVE_S   (default 2.0)
  QUORUM_TPU_SLO_TTFT_BATCH_S         (default 30.0)
  QUORUM_TPU_SLO_GAP_INTERACTIVE_S    (default 0.5)
  QUORUM_TPU_SLO_GAP_BATCH_S          (default 5.0)
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

SLO_CLASSES = ("interactive", "batch")
SLO_STAGES = ("ttft", "inter_token", "deadline")


def _env_s(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def interactive_headroom_s() -> float:
    """The classification boundary: deadline headroom at or below this is
    interactive."""
    return _env_s("QUORUM_TPU_SLO_INTERACTIVE_S", 30.0)


def classify(timeout_s: float | None) -> str:
    """SLO class for a request with ``timeout_s`` of deadline headroom at
    submission (None = no deadline = batch)."""
    if timeout_s is None:
        return "batch"
    return ("interactive" if timeout_s <= interactive_headroom_s()
            else "batch")


def targets(cls: str) -> dict[str, float]:
    """{stage: target seconds} for one class (deadline has no scalar
    target — the request's own deadline is the target)."""
    if cls == "interactive":
        return {"ttft": _env_s("QUORUM_TPU_SLO_TTFT_INTERACTIVE_S", 2.0),
                "inter_token": _env_s("QUORUM_TPU_SLO_GAP_INTERACTIVE_S",
                                      0.5)}
    return {"ttft": _env_s("QUORUM_TPU_SLO_TTFT_BATCH_S", 30.0),
            "inter_token": _env_s("QUORUM_TPU_SLO_GAP_BATCH_S", 5.0)}


class SloTracker:
    """Thread-safe per-class good/breached accounting + sliding-window
    burn rate. Observations also tick the process-global
    ``quorum_tpu_slo_{good,breached}_total`` counter families."""

    WINDOW_EVENTS = 4096  # bound on the sliding window's memory

    def __init__(self):
        self._lock = threading.Lock()
        # (monotonic stamp, class, ok)
        self._window: deque = deque(maxlen=self.WINDOW_EVENTS)
        self._good: dict[tuple[str, str], int] = {}
        self._breached: dict[tuple[str, str], int] = {}

    def record(self, cls: str, stage: str, ok: bool) -> None:
        from quorum_tpu_torch import observability as obs

        key = (cls, stage)
        with self._lock:
            book = self._good if ok else self._breached
            book[key] = book.get(key, 0) + 1
            self._window.append((time.monotonic(), cls, bool(ok)))
        fam = obs.SLO_GOOD if ok else obs.SLO_BREACHED
        fam.inc(**{"class": cls, "stage": stage})

    def score_trace(self, trace) -> None:
        """Score one finished request trace (class from ``meta.slo``;
        untagged traces — engine-direct tests, non-chat endpoints — are
        not scored). Called from finish_request_trace, i.e. exactly once
        per request."""
        cls = (trace.meta or {}).get("slo")
        if cls not in SLO_CLASSES:
            return
        tgt = targets(cls)
        if trace.ttft is not None:
            self.record(cls, "ttft", trace.ttft <= tgt["ttft"])
            # Worst flush gap, tracked UNCAPPED on the trace (the
            # token_times list stops at its cap — a >2048-token stream's
            # late stall must still score as a breach).
            worst = getattr(trace, "max_token_gap", None)
            if worst is not None:
                self.record(cls, "inter_token", worst <= tgt["inter_token"])
        status = trace.status
        if status is not None and status != 499:
            # 504 = deadline ran out mid-serve; the queue-stage shed is a
            # 503 whose trace carries a deadline-exceeded marker (other
            # 503s — breaker, queue-full — are capacity, not a deadline
            # breach). 5xx without a deadline marker scores nothing: a
            # contained engine failure is a failure, not an SLO sample.
            shed = status == 503 and any(
                s.name == "deadline-exceeded" for s in trace.spans)
            if status == 504 or shed:
                self.record(cls, "deadline", False)
            elif status < 500:
                self.record(cls, "deadline", True)

    def burn_rate(self, cls: str, window_s: float | None = None) -> float:
        """breached / observed for ``cls`` over the last ``window_s``
        seconds (0.0 with no observations)."""
        if window_s is None:
            window_s = _env_s("QUORUM_TPU_SLO_WINDOW_S", 300.0)
        cutoff = time.monotonic() - window_s
        with self._lock:
            events = [(c, ok) for t, c, ok in self._window
                      if t >= cutoff and c == cls]
        if not events:
            return 0.0
        breached = sum(1 for _, ok in events if not ok)
        return breached / len(events)

    def snapshot(self) -> dict:
        """Per-class totals by stage plus the current burn rate — the
        /health ``slo`` block and the timeline export's ``slo`` section."""
        with self._lock:
            good = dict(self._good)
            breached = dict(self._breached)
        out = {}
        for cls in SLO_CLASSES:
            stages = {}
            for stage in SLO_STAGES:
                g = good.get((cls, stage), 0)
                b = breached.get((cls, stage), 0)
                if g or b:
                    stages[stage] = {"good": g, "breached": b}
            out[cls] = {
                "stages": stages,
                "burn_rate": round(self.burn_rate(cls), 4),
            }
        return out

    def reset(self) -> None:
        with self._lock:
            self._window.clear()
            self._good.clear()
            self._breached.clear()


SLO = SloTracker()


def ready_burn_threshold() -> float | None:
    """The opt-in /ready shedding threshold (None = disabled)."""
    raw = os.environ.get("QUORUM_TPU_SLO_READY_BURN", "").strip()
    if not raw:
        return None
    try:
        v = float(raw)
    except ValueError:
        return None
    return v if 0.0 < v <= 1.0 else None


def burning_class(window_s: float | None = None) -> str | None:
    """The first class whose burn rate exceeds the opt-in threshold, or
    None (also None when the knob is off)."""
    thr = ready_burn_threshold()
    if thr is None:
        return None
    for cls in SLO_CLASSES:
        if SLO.burn_rate(cls, window_s) > thr:
            return cls
    return None
