"""Priority classes and weighted-fair admission ordering (the JAX
package's ``sched/policy.py``).

Three dispatch classes:

- ``interactive`` — a human is waiting. Explicit ``priority`` body knob,
  or derived from the request's deadline headroom exactly like the SLO
  plane (telemetry/slo.py: timeout ≤ QUORUM_TPU_SLO_INTERACTIVE_S).
- ``batch`` — throughput work; the default for undeadlined / long-timeout
  requests.
- ``background`` — explicitly opt-in best-effort work, admitted only
  through its weighted-fair share and first in line for preemption.

The SLO plane keeps its two scoring classes (``SLO_CLASSES`` is pinned by
the burn-rate metrics and the router's TelemetryView); ``background`` maps
onto ``batch`` for SLO accounting via :func:`to_slo_class`.

Admission order is weighted-fair queueing across classes with
earliest-deadline-headroom-first inside a class: each class accrues
virtual time as its requests are admitted, inversely to its weight (and
to the request's per-tenant weight), and the next admission comes from
the backlogged class with the LEAST virtual time. A backlogged class with
weight w therefore receives at least w/Σw of admissions over any window —
the starvation bound — while within a class
the request closest to missing its deadline goes first (preempted victims
re-enter at the head of their class: their queue age is preserved and the
resume credit breaks ties ahead of fresh arrivals).
"""

from __future__ import annotations

import os

PRIORITY_CLASSES = ("interactive", "batch", "background")
_RANK = {c: i for i, c in enumerate(PRIORITY_CLASSES)}

# Admission shares when every class is backlogged (overridable via
# QUORUM_TPU_SCHED_WEIGHTS="interactive=4,batch=2,background=1").
DEFAULT_WEIGHTS = {"interactive": 4.0, "batch": 2.0, "background": 1.0}


def class_rank(cls: str) -> int:
    """0 = most urgent. Unknown strings rank as batch (defense in depth —
    the knob is validated at the HTTP edge and in engine.submit)."""
    return _RANK.get(cls, _RANK["batch"])


def to_slo_class(cls: str) -> str:
    """Map a dispatch class onto the SLO plane's two scoring classes
    (telemetry/slo.py SLO_CLASSES — pinned by the burn metrics)."""
    return "interactive" if cls == "interactive" else "batch"


def _env_weights(var: str, base: dict[str, float]) -> dict[str, float]:
    """Parse ``a=2,b=0.5`` weight overrides; malformed entries are a loud
    skip (serving must not crash on an env typo), non-positive clamped."""
    raw = os.environ.get(var, "")
    out = dict(base)
    for part in raw.split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        name, _, val = part.partition("=")
        try:
            w = float(val)
        except ValueError:
            continue
        if w > 0:
            out[name.strip()] = w
    return out


class SchedPolicy:
    """Admission-order policy. All mutating calls (:meth:`charge`) happen
    with the engine's scheduler lock held — the policy carries no lock of
    its own (same discipline as the engine's _paged_* helpers)."""

    def __init__(self, weights: dict[str, float] | None = None,
                 tenant_weights: dict[str, float] | None = None):
        self.weights = dict(weights) if weights else _env_weights(
            "QUORUM_TPU_SCHED_WEIGHTS", DEFAULT_WEIGHTS)
        for c in PRIORITY_CLASSES:
            self.weights.setdefault(c, DEFAULT_WEIGHTS[c])
        self.tenant_weights = dict(tenant_weights) if tenant_weights \
            else _env_weights("QUORUM_TPU_TENANT_WEIGHTS", {})
        # Per-class virtual time: admissions advance a class's clock by
        # cost/weight, and the least clock among backlogged classes is
        # served next (classic WFQ; idle classes are re-synced forward on
        # their next admission so a long-idle class cannot bank unbounded
        # credit and then monopolize the queue).
        self._vtime = {c: 0.0 for c in PRIORITY_CLASSES}
        # System virtual clock: the largest start tag served so far. A
        # class that went idle falls behind this floor; its next charge
        # clamps it back up, bounding banked credit to ~one admission.
        self._vfloor = 0.0

    # ---- classification ----------------------------------------------------

    def classify(self, priority: str | None, deadline: float | None,
                 now: float) -> str:
        """The request's dispatch class: the explicit ``priority`` knob
        wins; otherwise deadline headroom decides via the SLO plane's
        threshold (no deadline → batch; ``background`` is never derived)."""
        if priority in PRIORITY_CLASSES:
            return priority
        from quorum_tpu_torch.telemetry import slo

        timeout = None if deadline is None else max(0.0, deadline - now)
        return slo.classify(timeout)

    # ---- ordering ----------------------------------------------------------

    @staticmethod
    def _headroom(req, now: float) -> float:
        d = getattr(req, "deadline", None)
        return float("inf") if d is None else d - now

    def _key(self, req, now: float):
        """Within-class order: resumed victims first (preemption credit),
        then earliest deadline headroom, then queue age (FIFO).

        The clocks: a request's ``deadline`` is absolute ``time.monotonic()``
        and the engine passes ``now`` from the same clock, so the headroom
        is a difference within one clock; ``t_submit`` is a
        ``time.perf_counter()`` stamp and is only compared with other
        requests' ``t_submit``, never with ``now``."""
        return (0 if getattr(req, "n_preempts", 0) > 0 else 1,
                self._headroom(req, now), req.t_submit)

    def pick(self, pending: list, now: float) -> int:
        """Index of the next request to admit. Pure — call :meth:`charge`
        once the pick is actually popped (a pick that finds no free slot
        must not advance any class's clock)."""
        if len(pending) <= 1:
            return 0
        by_class: dict[str, list[int]] = {}
        for i, r in enumerate(pending):
            by_class.setdefault(
                getattr(r, "sched_class", "batch") or "batch", []).append(i)
        cls = min(by_class,
                  key=lambda c: (self._vtime.get(c, 0.0), class_rank(c)))
        return min(by_class[cls], key=lambda i: self._key(pending[i], now))

    def order(self, pending: list, now: float) -> list:
        """Full policy order of ``pending`` (stacked-members admission
        scans heads in this order). Repeatedly simulating WFQ picks over a
        snapshot of the clocks keeps the two entry points consistent."""
        if len(pending) <= 1:
            return list(pending)
        saved, saved_floor = dict(self._vtime), self._vfloor
        rest, out = list(pending), []
        try:
            while rest:
                i = self.pick(rest, now)
                req = rest.pop(i)
                out.append(req)
                self.charge(req)
        finally:
            self._vtime, self._vfloor = saved, saved_floor
        return out

    def charge(self, req, cost: float = 1.0) -> None:
        """Advance the admitted request's class clock by cost/weight
        (tenant weight scales the effective weight, so a heavy tenant's
        requests space out within their class). Caller holds the engine
        scheduler lock; also re-syncs an idle class's clock forward."""
        cls = getattr(req, "sched_class", "batch") or "batch"
        w = self.weights.get(cls, 1.0) * self.tenant_weights.get(
            getattr(req, "tenant", None) or "", 1.0)
        start = max(self._vtime.get(cls, 0.0), self._vfloor)
        self._vtime[cls] = start + cost / max(w, 1e-6)
        self._vfloor = max(self._vfloor, start)

    def queue_depths(self, pending: list) -> dict[str, int]:
        """Pending-queue depth per class (the sched_queue_depth gauge)."""
        out = {c: 0 for c in PRIORITY_CLASSES}
        for r in pending:
            cls = getattr(r, "sched_class", "batch") or "batch"
            out[cls] = out.get(cls, 0) + 1
        return out
