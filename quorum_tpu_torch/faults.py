"""Fault-injection registry: named failure sites.

The serving path calls :func:`fire` at a handful of named sites. Disarmed —
the production state — the module-level ``fire`` binding IS ``_noop``, so a
site costs one attribute lookup and an empty call. :func:`arm` swaps the
binding to the checking implementation, and the last :func:`disarm` swaps it
back. Only tests and measurement scripts arm a site; nothing in the serving
configuration can.

Sites (arming a name not in :data:`SITES` is a ValueError, so a typo cannot
silently test nothing). Every engine site fires on the host before the
dispatch's first device work is enqueued:

  ``engine.admit``            single-shot admission prefill dispatch
  ``engine.prefill_segment``  one chunked-prefill segment dispatch
  ``engine.decode``           decode dispatch (one graph replay on the card)
  ``engine.verify``           speculative verify / fused draft→verify dispatch
  ``engine.snapshot``         prefix-store snapshot worker fetch/insert
  ``engine.preempt``          QoS preemption: parking one victim row
  ``http.request``            HTTP backend non-streaming request I/O
  ``http.stream``             HTTP backend streaming request I/O

The JAX package's other sites (``engine.kv_handoff``, ``router.resume``)
belong to paths the port does not have yet.
"""

from __future__ import annotations

import threading
import time

SITES = (
    "engine.admit",
    "engine.prefill_segment",
    "engine.decode",
    "engine.verify",
    "engine.snapshot",
    "engine.preempt",
    "http.request",
    "http.stream",
)


class FaultInjected(RuntimeError):
    """The exception an armed site raises: the marker for 'this failure was
    injected', distinguishable from real bugs a fault may shake loose."""

    def __init__(self, site: str):
        super().__init__(f"injected fault at {site!r}")
        self.site = site


_lock = threading.Lock()
# site -> {"times": remaining fires, "exc": factory or None}
_armed: dict[str, dict] = {}
# site -> total fires since the last counter reset (survives auto-disarm so
# a test can assert its fault actually triggered).
_fired: dict[str, int] = {}


def _noop(site: str) -> None:
    """The disarmed ``fire``: literally nothing."""


def _fire(site: str) -> None:
    with _lock:
        spec = _armed.get(site)
        if spec is None:
            return
        _fired[site] = _fired.get(site, 0) + 1
        spec["times"] -= 1
        if spec["times"] <= 0:
            del _armed[site]
            if not _armed:
                _rebind(_noop)
        exc = spec["exc"]
        delay = spec["delay"]
    if delay:
        # Latency injection: the site stalls instead of failing, a
        # deterministic "slow device" for exercising deadlines however
        # fast the host is.
        time.sleep(delay)
        return
    raise exc(site) if exc is not None else FaultInjected(site)


def _rebind(fn) -> None:
    global fire
    fire = fn


fire = _noop


def arm(site: str, *, times: int = 1, exc=None, delay: float = 0.0) -> None:
    """Arm ``site`` to misbehave on its next ``times`` fires (then
    auto-disarm). Default misbehavior is raising :class:`FaultInjected`;
    ``exc`` substitutes a callable ``exc(site) -> BaseException``; a
    nonzero ``delay`` makes the site SLEEP that many seconds instead of
    raising (latency injection — deterministic slowness for deadline
    tests)."""
    if site not in SITES:
        raise ValueError(f"unknown fault site {site!r} (one of {SITES})")
    if times < 1:
        raise ValueError(f"times must be >= 1, got {times}")
    with _lock:
        _armed[site] = {"times": int(times), "exc": exc,
                        "delay": float(delay)}
        _rebind(_fire)


def disarm(site: str | None = None) -> None:
    """Disarm one site (or all of them); idempotent."""
    with _lock:
        if site is None:
            _armed.clear()
        else:
            _armed.pop(site, None)
        if not _armed:
            _rebind(_noop)


def armed(site: str | None = None) -> bool:
    with _lock:
        return bool(_armed) if site is None else site in _armed


def fired(site: str) -> int:
    """How many times ``site`` has fired since the last :func:`reset_counts`."""
    with _lock:
        return _fired.get(site, 0)


def reset_counts() -> None:
    with _lock:
        _fired.clear()
