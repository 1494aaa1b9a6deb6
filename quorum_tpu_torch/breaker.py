"""Sliding-window circuit breaker of an engine: repeated failed scheduler
turns inside a window open it, admissions shed as fast 503s until a
cool-down probe proves the engine serves again. The JAX package's
``breaker.py``, with its defaults. Dependency-free.
"""

from __future__ import annotations

import threading
import time
from collections import deque

# Failure-breaker defaults: >= BREAKER_THRESHOLD failures inside
# BREAKER_WINDOW_S seconds open the breaker for BREAKER_COOLDOWN_S, after
# which ONE probe is let through per cooldown interval; a probe that
# succeeds closes the breaker, a failure while probing reopens it.
BREAKER_THRESHOLD = 3
BREAKER_WINDOW_S = 30.0
BREAKER_COOLDOWN_S = 5.0


class Breaker:
    """Sliding-window circuit breaker.

    In the engine, failed scheduler turns — not request failures — are the
    signal: a request rejected at validation costs nothing shared, but a
    poison-pill whose dispatch fails dooms every co-batched stream. A client
    retry loop on such a request would fail the shared engine again and
    again; the breaker turns that storm into fast 503s until a probe
    admission proves the engine serves again. Thread-safe (submitters and
    the scheduler thread both touch it)."""

    _CODES = {"closed": 0, "open": 1, "half_open": 2}

    def __init__(self, threshold: int = BREAKER_THRESHOLD,
                 window: float = BREAKER_WINDOW_S,
                 cooldown: float = BREAKER_COOLDOWN_S):
        self.threshold = max(1, int(threshold))
        self.window = float(window)
        self.cooldown = float(cooldown)
        self._lock = threading.Lock()
        self._failures: deque[float] = deque()
        self._open_until = 0.0
        self._last_probe = 0.0
        self.state = "closed"

    def record_failure(self, now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            self._failures.append(now)
            while self._failures and self._failures[0] < now - self.window:
                self._failures.popleft()
            if (self.state != "closed"
                    or len(self._failures) >= self.threshold):
                self.state = "open"
                self._open_until = now + self.cooldown

    def record_success(self) -> None:
        with self._lock:
            if self.state != "closed":
                self.state = "closed"
                self._failures.clear()

    def allow(self, now: float | None = None) -> bool:
        """May a new admission proceed right now? Open → no until the
        cooldown elapses; then half-open, letting one probe through per
        cooldown interval (a stamp, not a flag — a probe whose client
        vanished must not wedge the breaker half-open forever)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if self.state == "closed":
                return True
            if self.state == "open":
                if now < self._open_until:
                    return False
                self.state = "half_open"
            if now - self._last_probe < self.cooldown and self._last_probe:
                return False
            self._last_probe = now
            return True

    def retry_after(self, now: float | None = None) -> float:
        now = time.monotonic() if now is None else now
        with self._lock:
            return max(self._open_until - now, 0.0) or self.cooldown

    @property
    def state_code(self) -> int:
        """0 = closed, 1 = open, 2 = half-open (the breaker_state gauge)."""
        return self._CODES[self.state]
