"""QoS scheduling, the port's copy of the JAX package's ``sched/``:
priority classes and weighted-fair admission ordering (:mod:`policy`), the
engine's single shed-decision point (:mod:`cost`), and the mid-decode
preemption controller (:mod:`preempt`).

The subsystem is pure host-side policy: it reorders which pending request
the engine admits next, decides rejections at submit time, and chooses
preemption victims. It never adds a device program or a graph key: a
parked victim resumes through the engine's ordinary admission routes
(single-shot, chunked segments, staged zero-drain injection) and its
delivered tokens are regenerated behind the replay guard.
"""

from quorum_tpu_torch.sched.cost import CostModel, ShedDecision
from quorum_tpu_torch.sched.policy import (
    PRIORITY_CLASSES,
    SchedPolicy,
    class_rank,
    to_slo_class,
)
from quorum_tpu_torch.sched.preempt import PreemptionController

__all__ = [
    "CostModel",
    "PRIORITY_CLASSES",
    "PreemptionController",
    "SchedPolicy",
    "ShedDecision",
    "class_rank",
    "to_slo_class",
]
