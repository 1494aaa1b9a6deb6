"""The engine's ONE shed-decision point (the JAX package's
``sched/cost.py``).

Every submit-time rejection and the per-turn deadline sweep route through
this model, so there is exactly one place that decides "refuse now" and
one Retry-After heuristic (the breaker, the queue-full check, the paged
pool-span check and the sweep share it). The capacity texts are the JAX
engine's byte for byte: the HTTP layer threads them into the 503 body.

Decisions, in evaluation order:

- ``deadline``   — already past its deadline at submit (or, with QoS on
  and warm evidence, provably unable to SURVIVE THE QUEUE: the predictive
  shed that turns a guaranteed minute-3 timeout into an immediate honest
  503 + Retry-After).
- ``breaker``    — the failure breaker is rejecting admissions.
- ``queue_full`` — the admission queue is at capacity.
- ``pool_span``  — (paged engines) the request's full page span exceeds
  the pool; no amount of waiting admits it.

The predictive shed is deliberately conservative: it needs QoS enabled, a
deadline, live queue pressure, warm EWMAs (≥ MIN_OBS observations of both
queue wait and service time), and the estimate to exceed the remaining
headroom by MARGIN×. Idle engines and cold starts never predictive-shed,
so FIFO-era behaviour is preserved bit for bit until there is evidence.
"""

from __future__ import annotations

from dataclasses import dataclass

# Predictive-shed gates: both EWMAs warm, estimate > MARGIN x remaining.
MIN_OBS = 5
MARGIN = 2.0
EWMA_ALPHA = 0.3


@dataclass
class ShedDecision:
    kind: str          # "deadline" | "breaker" | "queue_full" | "pool_span"
    retry_after: float  # seconds — the honest backoff hint (503 header)
    detail: str         # operator-facing reason (error message text)


class CostModel:
    """Shed decisions fed by queue depth, observed queue-wait / service
    EWMAs, and remaining deadline. Observation calls run on the engine's
    scheduler threads (single writer per field under the scheduler lock's
    turn order); reads are snapshots — exactness across a race is not
    needed, same contract as the engine's /metrics counters."""

    def __init__(self, latency=None):
        # Per-family device-time model (telemetry/latency.py) — kept for
        # operators reading estimates out of /debug/telemetry; the shed
        # gates below use the coarser whole-request EWMAs, which include
        # host turnaround and therefore bound the device model from above.
        self.latency = latency
        self.queue_wait_ewma = 0.0
        self.n_queue_obs = 0
        self.service_ewma = 0.0
        self.n_service_obs = 0
        self.n_predictive_sheds = 0

    # ---- observations ------------------------------------------------------

    def observe_queue_wait(self, seconds: float) -> None:
        self.n_queue_obs += 1
        self.queue_wait_ewma = seconds if self.n_queue_obs == 1 else (
            (1 - EWMA_ALPHA) * self.queue_wait_ewma + EWMA_ALPHA * seconds)

    def observe_service(self, seconds: float) -> None:
        """Whole-request wall time (admission to slot release)."""
        self.n_service_obs += 1
        self.service_ewma = seconds if self.n_service_obs == 1 else (
            (1 - EWMA_ALPHA) * self.service_ewma + EWMA_ALPHA * seconds)

    # ---- the decision points ----------------------------------------------

    def retry_hint(self) -> float:
        """The honest Retry-After for capacity sheds: the observed queue
        drain estimate when warm, else the 1-second floor the HTTP layer
        has always advertised."""
        if self.n_queue_obs >= MIN_OBS and self.queue_wait_ewma > 0:
            return max(1.0, self.queue_wait_ewma)
        return 1.0

    def presubmit(self, *, now: float, deadline: float | None,
                  breaker) -> ShedDecision | None:
        """Lock-free checks before the request touches the queue."""
        if deadline is not None and now >= deadline:
            return ShedDecision("deadline", self.retry_hint(),
                                "request deadline expired at submission")
        if breaker is not None and not breaker.allow(now):
            return ShedDecision("breaker", breaker.retry_after(now),
                                "engine circuit breaker is open")
        return None

    def queue_check(self, *, now: float, deadline: float | None,
                    n_pending: int, max_pending: int, qos: bool,
                    page_need: int = 0,
                    pool_pages: int = 0) -> ShedDecision | None:
        """Checks under the scheduler lock, against live queue state.
        Message text for the capacity kinds is kept verbatim from the
        pre-QoS engine — clients and tests key on it."""
        if n_pending >= max_pending:
            return ShedDecision(
                "queue_full", self.retry_hint(),
                f"engine admission queue full ({max_pending} waiting)")
        if pool_pages and page_need > pool_pages:
            return ShedDecision(
                "pool_span", self.retry_hint(),
                f"request span of {page_need} pages exceeds the kv page "
                f"pool ({pool_pages} pages)")
        if qos and deadline is not None and n_pending > 0:
            est = self.estimated_queue_wait(n_pending)
            if est is not None and est > MARGIN * max(0.0, deadline - now):
                self.n_predictive_sheds += 1
                return ShedDecision(
                    "deadline", max(1.0, est),
                    f"deadline infeasible under current load (estimated "
                    f"queue wait {est:.1f}s behind {n_pending} pending)")
        return None

    def estimated_queue_wait(self, n_pending: int) -> float | None:
        """Expected wait behind ``n_pending`` queued requests, or None
        while the evidence is cold. The head of the queue waits about one
        observed queue-wait; each request behind it adds a service time."""
        if self.n_queue_obs < MIN_OBS or self.n_service_obs < MIN_OBS:
            return None
        return self.queue_wait_ewma + max(0, n_pending - 1) \
            * self.service_ewma

    # ---- the sweep's predicate --------------------------------------------

    @staticmethod
    def expired(req, now: float) -> bool:
        """The per-turn deadline sweep's single expiry predicate."""
        return (req.deadline is not None and now > req.deadline
                and not req.cancel.is_set())

    def snapshot(self) -> dict:
        """/debug/telemetry block."""
        return {
            "queue_wait_ewma_s": round(self.queue_wait_ewma, 6),
            "service_ewma_s": round(self.service_ewma, 6),
            "queue_obs": self.n_queue_obs,
            "service_obs": self.n_service_obs,
            "predictive_sheds": self.n_predictive_sheds,
        }
