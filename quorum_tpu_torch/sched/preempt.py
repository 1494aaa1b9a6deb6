"""Mid-decode preemption: victim selection + budgets (the JAX package's
``sched/preempt.py``).

When a higher-class admission finds no free slot, the controller picks a
lower-class resident row to park. The ENGINE performs the parking at its
next scheduler turn (``InferenceEngine._sweep_preemptions``): the victim's slot
is released exactly like a finished stream — its K/V prefix stays
slot-resident (dense) or parked as retained page references (paged), and
with a host prefix store the prefix is additionally snapshotted — then
the victim re-enters the pending queue with resume credit. Re-admission
rides the ordinary admission machinery (single-shot, chunked register,
staged zero-drain injection), so no new device program exists for
preemption; the victim's already-delivered tokens are regenerated
deterministically (sampling noise is drawn per token index, so draw n is
the same on every path) and swallowed by the replay guard in ``_emit``,
compared with what the consumer already received.

Selection order: lowest class first, then cheapest replay (fewest
generated tokens), then most recent admission. Budgets prevent livelock:
a victim is preempted at most ``max_preempts`` times (then it becomes
ineligible and batch work degrades gracefully instead of starving), and
only one preemption may be outstanding per free-slot shortfall.
"""

from __future__ import annotations

import os

from quorum_tpu_torch.sched.policy import class_rank

DEFAULT_MAX_PREEMPTS = 2


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


class PreemptionController:
    """Pure host-side victim selection; owns no engine state. The engine
    calls :meth:`pick_victim` under its scheduler lock and performs the
    actual park/requeue itself."""

    def __init__(self, max_preempts: int | None = None):
        self.max_preempts = max_preempts if max_preempts is not None \
            else _env_int("QUORUM_TPU_SCHED_MAX_PREEMPTS",
                          DEFAULT_MAX_PREEMPTS)
        self.n_considered = 0

    def eligible(self, req) -> bool:
        """May this resident request be parked at a reap boundary?

        Logprobs streams are excluded (their per-token lp records were
        already delivered; replay would have to suppress re-records across
        every emit path — not worth the risk for an observability knob).
        Everything else replays exactly: penalties rebuild from history,
        constrained rows re-advance their DFA on device, speculative rows
        verify with the same per-token noise draws.
        """
        return (req is not None
                and not req.cancel.is_set()
                and not req.preempt_flag
                and req.want_lp < 0
                and req.n_preempts < self.max_preempts)

    def pick_victim(self, beneficiary, slots, lo: int, hi: int):
        """(row, victim) for ``beneficiary`` among ``slots[lo:hi]``, or
        None. Strictly lower class only — equal-class requests never
        preempt each other (that would just thrash the slot)."""
        self.n_considered += 1
        ben_rank = class_rank(beneficiary.sched_class)
        best = None
        for i in range(lo, hi):
            r = slots[i]
            if not self.eligible(r):
                continue
            rank = class_rank(r.sched_class)
            if rank <= ben_rank:
                continue
            # Lowest class first; cheapest replay next; newest last.
            key = (-rank, r.emitted, -r.t_submit)
            if best is None or key < best[0]:
                best = (key, i, r)
        if best is None:
            return None
        return best[1], best[2]
