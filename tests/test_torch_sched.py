"""The QoS scheduler on ``cuda://`` engines (the CPU: plain versions),
against the JAX package's.

- The pure modules: every case of the JAX package's own policy, cost-model
  and preemption-controller tests runs against ``quorum_tpu.sched`` and
  ``quorum_tpu_torch.sched`` on the same inputs, and the picks, orders,
  decisions, texts and snapshots are equal (and are the JAX test's
  expectations); random pending lists and slot tables from a numpy seed
  order, pick, charge and choose victims the same way.
- The engine: ``qos`` off admits FIFO and is inert; on, the weighted-fair
  pick admits an interactive request first; an unknown ``priority`` is
  refused in the JAX engine's words; the cost model's sheds (deadline,
  breaker, queue full) carry the JAX engine's exceptions and texts; a warm
  cost model sheds an infeasible deadline; ``qos`` stays out of the engine
  key and an opt-in wins.
- The preemption drill (the JAX package's, with the victim held
  mid-decode by a gate on the scheduler's next decode dispatch instead of
  a race) on dense,
  paged and zero-drain engines, greedy and sampled: exactly one
  preemption, the victim's stream equal to its solo run (greedy solo runs
  equal to the JAX engine's), ``replayed_tokens_total ==
  preempted_tokens_total`` and no page leaked; the members drill parks
  only the head's member; an ``engine.preempt`` fault dooms the victim
  alone.

llama-tiny, float32."""

import dataclasses
import threading
import time

import jax
import numpy as np
import pytest
import torch

from quorum_tpu import sched as jsched
from quorum_tpu.engine.engine import DeadlineExceeded as JaxDeadline
from quorum_tpu.engine.engine import EngineBreakerOpen as JaxBreakerOpen
from quorum_tpu.engine.engine import InferenceEngine as JaxEngine
from quorum_tpu.engine.engine import QueueFullError as JaxQueueFull
from quorum_tpu.models.init import init_params as jax_init_params
from quorum_tpu.models.model_config import resolve_spec as jax_resolve_spec
from quorum_tpu.ops.sampling import SamplerConfig as JaxSampler
from quorum_tpu.sched.cost import MARGIN as JAX_MARGIN
from quorum_tpu.sched.cost import MIN_OBS as JAX_MIN_OBS
from quorum_tpu.sched.policy import _env_weights as jax_env_weights
from quorum_tpu_torch import faults
from quorum_tpu_torch import sched as tsched
from quorum_tpu_torch.engine.engine import (DeadlineExceeded, EngineBreakerOpen,
                                            InferenceEngine, QueueFullError, get_engine,
                                            release_engine)
from quorum_tpu_torch.models.convert import params_from_numpy
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.ops.sampling import SamplerConfig
from quorum_tpu_torch.sched.cost import MARGIN, MIN_OBS
from quorum_tpu_torch.sched.policy import _env_weights

OPTS = {"dtype": "float32"}
GREEDY = SamplerConfig(temperature=0.0)
SAMPLED = SamplerConfig(temperature=0.9, top_p=0.9)
VICTIM = [11, 13, 17, 19, 23, 29]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class FakeReq:
    """The duck-typed subset of a request the policy layer reads."""

    def __init__(self, cls="batch", deadline=None, t_submit=0.0, n_preempts=0, tenant=None,
                 cancelled=False, want_lp=-1, emitted=0, preempt_flag=False):
        self.sched_class = cls
        self.deadline = deadline
        self.t_submit = t_submit
        self.n_preempts = n_preempts
        self.tenant = tenant
        self.cancel = threading.Event()
        if cancelled:
            self.cancel.set()
        self.want_lp = want_lp
        self.emitted = emitted
        self.preempt_flag = preempt_flag


def _both(fn):
    """``fn(module)`` for the JAX package's module and the port's: equal."""
    a, b = fn(jsched), fn(tsched)
    assert a == b, (a, b)
    return b


# ---- the policy --------------------------------------------------------------


def test_classify_explicit_knob_wins_background_never_derived():
    now = 100.0
    cases = [("background", now + 1), ("interactive", None), (None, now + 1.0),
             (None, now + 10_000.0), (None, None), (None, now + 0.5)]
    got = _both(lambda m: [m.SchedPolicy().classify(p, d, now) for p, d in cases])
    assert got == ["background", "interactive", "interactive", "batch", "batch",
                   "interactive"]


def test_class_rank_and_slo_mapping():
    names = ["interactive", "batch", "background", "no-such-class"]
    got = _both(lambda m: ([m.class_rank(c) for c in names],
                           [m.to_slo_class(c) for c in names[:3]], m.PRIORITY_CLASSES))
    assert got == ([0, 1, 2, 1], ["interactive", "batch", "batch"],
                   ("interactive", "batch", "background"))


def _classes(order):
    return [r.sched_class for r in order]


def test_wfq_backlogged_share_meets_floor():
    def run(m):
        p = m.SchedPolicy(weights={"interactive": 4, "batch": 2, "background": 1})
        pending = ([FakeReq("interactive", t_submit=i) for i in range(14)]
                   + [FakeReq("batch", t_submit=i) for i in range(14)]
                   + [FakeReq("background", t_submit=i) for i in range(14)])
        ordered = p.order(pending, now=0.0)
        return ([pending.index(r) for r in ordered], dict(p._vtime))
    idx, vtime = _both(run)
    first14 = [("interactive", "batch", "background")[i // 14] for i in idx[:14]]
    assert (first14.count("interactive"), first14.count("batch"),
            first14.count("background")) == (8, 4, 2)
    assert all(v == 0.0 for v in vtime.values())  # order() leaves the clocks


def test_within_class_headroom_then_fifo_then_resume_credit():
    def run(m):
        p = m.SchedPolicy()
        now = 50.0
        tight = FakeReq("batch", deadline=now + 1, t_submit=3.0)
        loose = FakeReq("batch", deadline=now + 100, t_submit=1.0)
        none_ = FakeReq("batch", deadline=None, t_submit=0.0)
        parked = FakeReq("batch", deadline=None, t_submit=9.0, n_preempts=1)
        a, b = FakeReq("batch", t_submit=1.0), FakeReq("batch", t_submit=2.0)
        return (p.pick([none_, loose, tight], now), p.pick([none_, loose, tight, parked], now),
                p.pick([b, a], now))
    assert _both(run) == (2, 3, 1)


def test_idle_class_cannot_bank_credit():
    def run(m):
        p = m.SchedPolicy(weights={"interactive": 1, "batch": 1, "background": 1})
        for _ in range(50):
            p.charge(FakeReq("batch"))
        pending = ([FakeReq("interactive", t_submit=i) for i in range(4)]
                   + [FakeReq("batch", t_submit=i) for i in range(4)])
        return _classes(p.order(pending, now=0.0))
    classes = _both(run)
    assert "batch" in classes[:3] and classes[:4] != ["interactive"] * 4


def test_tenant_weight_scales_within_class():
    def run(m):
        w = {"interactive": 1, "batch": 1, "background": 1}
        p = m.SchedPolicy(weights=w, tenant_weights={"heavy": 4.0})
        p.charge(FakeReq("batch", tenant="heavy"))
        q = m.SchedPolicy(weights=w, tenant_weights={"heavy": 4.0})
        q.charge(FakeReq("batch", tenant=None))
        return p._vtime["batch"], q._vtime["batch"]
    heavy, light = _both(run)
    assert heavy == pytest.approx(light / 4.0)


def test_env_weights_parse_and_clamp(monkeypatch):
    monkeypatch.setenv("X_W", "batch=5,junk,=3,background=-1,"
                              "interactive=not-a-number, spaced = 2 ")
    base = {"interactive": 4.0, "batch": 2.0, "background": 1.0}
    got = _env_weights("X_W", base)
    assert got == jax_env_weights("X_W", base)
    assert (got["batch"], got["background"], got["interactive"], got["spaced"]) == (
        5.0, 1.0, 4.0, 2.0)


def test_queue_depths_counts_by_class():
    pending = [FakeReq("interactive"), FakeReq("batch"), FakeReq("batch"),
               FakeReq("background")]
    got = _both(lambda m: (m.SchedPolicy().queue_depths(pending),
                           m.SchedPolicy().queue_depths([])))
    assert got == ({"interactive": 1, "batch": 2, "background": 1},
                   {c: 0 for c in tsched.PRIORITY_CLASSES})


def _random_pending(rng, n: int, now: float) -> list[FakeReq]:
    classes = ("interactive", "batch", "background")
    out = []
    for i in range(n):
        deadline = None if rng.random() < 0.4 else now + float(rng.integers(1, 200))
        out.append(FakeReq(classes[int(rng.integers(0, 3))], deadline=deadline,
                           t_submit=float(rng.permutation(1000)[0]) + i * 1e-3,
                           n_preempts=int(rng.random() < 0.2),
                           tenant=None if rng.random() < 0.5 else f"t{int(rng.integers(0, 3))}"))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_random_queues_order_pick_and_charge_like_jax(seed):
    """Random pending lists: the full policy order, the next pick after
    each real admission (charged) and the class clocks agree."""
    def run(m):
        rng = np.random.default_rng(seed)
        now = 1000.0
        pending = _random_pending(rng, int(rng.integers(2, 40)), now)
        p = m.SchedPolicy(tenant_weights={"t0": 2.0, "t1": 0.5})
        order = [pending.index(r) for r in p.order(pending, now)]
        rest, picks = list(pending), []
        while rest:
            i = p.pick(rest, now)
            picks.append(pending.index(rest[i]))
            p.charge(rest.pop(i))
        return order, picks, p._vtime, p._vfloor, p.queue_depths(pending)
    order, picks, *_ = _both(run)
    assert order == picks  # order() simulates the picks a real run makes


# ---- the cost model ----------------------------------------------------------


class FakeBreaker:
    def __init__(self, open_=False, ra=5.0):
        self._open, self._ra = open_, ra

    def allow(self, now):
        return not self._open

    def retry_after(self, now):
        return self._ra


def _decision(d):
    return None if d is None else (d.kind, d.retry_after, d.detail)


def test_presubmit_deadline_and_breaker():
    got = _both(lambda m: [_decision(m.CostModel().presubmit(**kw)) for kw in (
        dict(now=10.0, deadline=20.0, breaker=None),
        dict(now=10.0, deadline=10.0, breaker=None),
        dict(now=10.0, deadline=None, breaker=FakeBreaker(True, 7.5)))])
    assert got[0] is None
    assert got[1] == ("deadline", 1.0, "request deadline expired at submission")
    assert got[2] == ("breaker", 7.5, "engine circuit breaker is open")


def test_capacity_messages_byte_identical_to_jax():
    def run(m):
        cm = m.CostModel()
        return (_decision(cm.queue_check(now=0.0, deadline=None, n_pending=8, max_pending=8,
                                         qos=False)),
                _decision(cm.queue_check(now=0.0, deadline=None, n_pending=0, max_pending=8,
                                         qos=False, page_need=40, pool_pages=32)))
    full, span = _both(run)
    assert full == ("queue_full", 1.0, "engine admission queue full (8 waiting)")
    assert span == ("pool_span", 1.0,
                    "request span of 40 pages exceeds the kv page pool (32 pages)")


def test_predictive_shed_gates_cold_warm_and_off():
    assert (MIN_OBS, MARGIN) == (JAX_MIN_OBS, JAX_MARGIN) == (5, 2.0)

    def run(m):
        cm = m.CostModel()
        tight = dict(now=0.0, deadline=0.5, n_pending=4, max_pending=64)
        out = [_decision(cm.queue_check(qos=True, **tight))]  # cold: never
        for _ in range(m.cost.MIN_OBS):
            cm.observe_queue_wait(2.0)
            cm.observe_service(3.0)
        out.append(_decision(cm.queue_check(qos=True, **tight)))
        out.append(cm.n_predictive_sheds)
        out += [_decision(cm.queue_check(qos=False, **tight)),
                _decision(cm.queue_check(qos=True, now=0.0, deadline=None, n_pending=4,
                                         max_pending=64)),
                _decision(cm.queue_check(qos=True, now=0.0, deadline=0.5, n_pending=0,
                                         max_pending=64)),
                _decision(cm.queue_check(qos=True, now=0.0, deadline=100.0, n_pending=4,
                                         max_pending=64)),
                cm.snapshot()]
        return out
    got = _both(run)
    assert got[0] is None and got[3:7] == [None] * 4
    assert got[1][0] == "deadline" and got[1][1] == pytest.approx(11.0)
    assert got[1][2] == ("deadline infeasible under current load "
                         "(estimated queue wait 11.0s behind 4 pending)")
    assert got[2] == 1


def test_retry_hint_and_estimated_queue_wait():
    def run(m):
        cm, cm2, cm3 = m.CostModel(), m.CostModel(), m.CostModel()
        out = [cm.retry_hint(), cm3.estimated_queue_wait(3)]
        for _ in range(m.cost.MIN_OBS):
            cm.observe_queue_wait(4.0)
            cm2.observe_queue_wait(0.05)
            cm3.observe_queue_wait(1.0)
            cm3.observe_service(2.0)
        return out + [cm.retry_hint(), cm2.retry_hint(), cm3.estimated_queue_wait(1),
                      cm3.estimated_queue_wait(3), cm3.snapshot()]
    got = _both(run)
    assert got[:6] == [1.0, None, 4.0, 1.0, 1.0, 5.0]


def test_expired_predicate_and_snapshot():
    def run(m):
        r = FakeReq(deadline=5.0)
        out = [m.CostModel.expired(r, 6.0), m.CostModel.expired(r, 4.0)]
        r.cancel.set()
        out += [m.CostModel.expired(r, 6.0),
                m.CostModel.expired(FakeReq(deadline=None), 6.0), m.CostModel().snapshot()]
        return out
    got = _both(run)
    assert got[:4] == [True, False, False, False]
    assert set(got[4]) == {"queue_wait_ewma_s", "service_ewma_s", "queue_obs", "service_obs",
                           "predictive_sheds"}


# ---- the preemption controller -----------------------------------------------


def test_pick_victim_strictly_lower_class_only():
    def run(m):
        pc = m.PreemptionController()
        slots = [FakeReq("interactive"), FakeReq("batch", emitted=5)]
        return (pc.pick_victim(FakeReq("interactive"), slots, 0, 2)[0],
                pc.pick_victim(FakeReq("batch"), [FakeReq("batch")], 0, 1),
                pc.pick_victim(FakeReq("batch"), [FakeReq("background", emitted=1)], 0, 1)[0],
                pc.max_preempts)
    assert _both(run) == (1, None, 0, 2)


def test_pick_victim_order_lowest_class_fewest_tokens_youngest():
    def run(m):
        slots = [FakeReq("batch", emitted=0, t_submit=0.0),
                 FakeReq("background", emitted=40, t_submit=1.0),
                 FakeReq("background", emitted=2, t_submit=5.0)]
        return m.PreemptionController().pick_victim(FakeReq("interactive"), slots, 0, 3)[0]
    assert _both(run) == 2


def test_pick_victim_exclusions():
    def run(m):
        pc = m.PreemptionController(max_preempts=2)
        return [pc.pick_victim(FakeReq("interactive"), [bad], 0, 1) for bad in (
            FakeReq("batch", cancelled=True), FakeReq("batch", preempt_flag=True),
            FakeReq("batch", want_lp=0), FakeReq("batch", n_preempts=2), None)]
    assert _both(run) == [None] * 5


@pytest.mark.parametrize("seed", range(4))
def test_random_slot_tables_pick_the_same_victim(seed):
    def run(m):
        rng = np.random.default_rng(100 + seed)
        pc = m.PreemptionController()
        out = []
        for _ in range(30):
            slots = [None if rng.random() < 0.2 else FakeReq(
                ("interactive", "batch", "background")[int(rng.integers(0, 3))],
                t_submit=float(rng.random()), emitted=int(rng.integers(0, 50)),
                n_preempts=int(rng.integers(0, 3)), want_lp=int(rng.integers(-1, 1)))
                for _ in range(int(rng.integers(1, 9)))]
            head = FakeReq(("interactive", "batch")[int(rng.integers(0, 2))])
            picked = pc.pick_victim(head, slots, 0, len(slots))
            out.append(None if picked is None else picked[0])
        return out, pc.n_considered
    _both(run)


# ---- the engine --------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    jspec = jax_resolve_spec("llama-tiny", OPTS)
    return jspec, jax.tree.map(np.asarray, jax_init_params(jspec, seed=0))


def _port(weights, **knobs):
    return InferenceEngine(resolve_spec("llama-tiny", OPTS), device="cpu",
                           params=params_from_numpy(weights[1], device="cpu"), **knobs)


@pytest.fixture(scope="module")
def jax_engine(weights):
    """The JAX engine on the same weights, for the words of its refusals
    and its greedy solo runs (nothing it admits while ``_cond`` is held
    compiles)."""
    eng = JaxEngine(weights[0], params=weights[1], n_slots=1, decode_chunk=4, max_pending=1,
                    qos=True)
    yield eng
    eng.shutdown()


def _order_of_admission(eng, priorities: list[str]) -> list[int]:
    """Submit one short request per priority while the scheduler is held
    (all queued at once), then let it admit: the submit indices in the
    order they were admitted."""
    seen: list[int] = []
    orig = eng._note_admitted

    def note(req):
        seen.append(req.seed)
        orig(req)

    eng._note_admitted = note
    with eng._cond:
        reqs = [eng.submit([3 + i, 4, 5], max_new_tokens=2, sampler=GREEDY, seed=i, priority=p)
                for i, p in enumerate(priorities)]
    for r in reqs:
        assert len(list(eng.stream_results(r))) == 2
    eng._note_admitted = orig
    return seen


def test_qos_off_is_fifo_and_inert_and_on_admits_interactive_first(weights):
    prio = ["batch", "batch", "batch", "interactive", "batch"]
    off = _port(weights, n_slots=1, decode_chunk=4)
    on = _port(weights, n_slots=1, decode_chunk=4, qos=True)
    try:
        assert _order_of_admission(off, prio) == [0, 1, 2, 3, 4]
        m = off.metrics()
        assert (m["qos"], m["preemptions_total"], m["predictive_sheds_total"]) == (0, 0, 0)
        got = _order_of_admission(on, prio)
        assert got[0] == 3 and sorted(got) == [0, 1, 2, 3, 4]
        assert on.metrics()["qos"] == 1
    finally:
        off.shutdown()
        on.shutdown()


def test_unknown_priority_is_refused_in_jax_words(weights, jax_engine):
    eng = _port(weights, n_slots=1, qos=True)
    try:
        with pytest.raises(ValueError, match="priority") as got:
            eng.submit([3, 4, 5], max_new_tokens=4, sampler=GREEDY, priority="urgent")
        with pytest.raises(ValueError) as want:
            jax_engine.submit([3, 4, 5], max_new_tokens=4, sampler=JaxSampler(temperature=0.0),
                              priority="urgent")
        assert str(got.value) == str(want.value)
    finally:
        eng.shutdown()


def test_shed_mapping_deadline_breaker_queue_full_like_jax(weights, jax_engine):
    """The cost model's decisions as the engine's exceptions, with the
    JAX engine's texts: an expired deadline, a full queue (held full by
    holding the scheduler) and an open breaker."""
    eng = _port(weights, n_slots=1, max_pending=1, qos=True)
    jg = JaxSampler(temperature=0.0)
    try:
        with pytest.raises(DeadlineExceeded) as got:
            eng.submit([3, 4, 5], max_new_tokens=4, sampler=GREEDY,
                       deadline=time.monotonic() - 1.0)
        with pytest.raises(JaxDeadline) as want:
            jax_engine.submit([3, 4, 5], max_new_tokens=4, sampler=jg,
                              deadline=time.monotonic() - 1.0)
        assert (str(got.value), got.value.stage) == (str(want.value), want.value.stage)
        assert eng.metrics()["deadline_exceeded_total"] == 1
        texts = []
        for e, sampler, exc in ((eng, GREEDY, QueueFullError), (jax_engine, jg, JaxQueueFull)):
            cancel = threading.Event()
            with e._cond:
                held = e.submit([5, 6, 7], max_new_tokens=4, sampler=sampler, cancel=cancel)
                with pytest.raises(exc) as full:
                    e.submit([5, 6, 8], max_new_tokens=4, sampler=sampler)
                cancel.set()  # the queued one ends unadmitted
            list(e.stream_results(held))
            texts.append((str(full.value), full.value.retry_after))
        assert texts[0] == texts[1] == ("engine admission queue full (1 waiting)", 1.0)
        opened = []
        for e, sampler, exc in ((eng, GREEDY, EngineBreakerOpen),
                                (jax_engine, jg, JaxBreakerOpen)):
            now = time.monotonic()
            for _ in range(e.breaker.threshold):
                e.breaker.record_failure(now)
            with pytest.raises(exc) as shed:
                e.submit([3, 4], max_new_tokens=2, sampler=sampler)
            assert shed.value.retry_after > 0
            opened.append(str(shed.value).split(";")[0])
        assert opened[0] == opened[1] == "engine circuit breaker is open"
    finally:
        eng.shutdown()


def test_predictive_shed_end_to_end(weights):
    eng = _port(weights, n_slots=1, qos=True)
    try:
        for _ in range(MIN_OBS):
            eng.cost_model.observe_queue_wait(2.0)
            eng.cost_model.observe_service(3.0)
        cancel = threading.Event()
        with eng._cond:  # two requests queued, none admitted yet
            held = [eng.submit([5 + i, 6, 7], max_new_tokens=4, sampler=GREEDY, cancel=cancel)
                    for i in range(2)]
            with pytest.raises(DeadlineExceeded) as shed:
                eng.submit([9, 10, 11], max_new_tokens=4, sampler=GREEDY,
                           deadline=time.monotonic() + 0.5)
            cancel.set()
        assert shed.value.stage == "queue"
        assert eng.cost_model.n_predictive_sheds == 1
        assert eng.metrics()["predictive_sheds_total"] == 1
        for r in held:
            list(eng.stream_results(r))
        # The same hopeless deadline with qos off is admitted, not shed.
        eng.qos = False
        with eng._cond:
            r = eng.submit([5, 6, 7], max_new_tokens=2, sampler=GREEDY, cancel=cancel)
            r2 = eng.submit([9, 10, 11], max_new_tokens=2, sampler=GREEDY, cancel=cancel,
                            deadline=time.monotonic() + 0.5)
        for q in (r, r2):
            list(eng.stream_results(q))
        assert eng.cost_model.n_predictive_sheds == 1
    finally:
        eng.shutdown()


def test_qos_is_not_in_the_engine_key_and_an_opt_in_wins():
    spec = dataclasses.replace(resolve_spec("llama-tiny", OPTS), max_seq=96)
    off = get_engine(spec, device="cpu", seed=7, n_slots=1, qos=False)
    try:
        on = get_engine(spec, device="cpu", seed=7, n_slots=1, qos=True)
        assert on is off and off.qos is True
        assert get_engine(spec, device="cpu", seed=7, n_slots=1, qos=False).qos is True
        # zero_drain is structural: its own engine.
        zd = get_engine(spec, device="cpu", seed=7, n_slots=1, zero_drain=True)
        assert zd is not off and zd.zero_drain and not off.zero_drain
        release_engine(zd)
    finally:
        release_engine(off)


# ---- the preemption drill ----------------------------------------------------


def _drain(eng, req, sink):
    for t in eng.stream_results(req):
        sink.append(t)


def _gate(eng, watch: list, n: int = 8):
    """Hold the scheduler at its first decode dispatch once every request
    in ``watch`` has ``n`` tokens, until ``go`` is set: the drill's
    requests are then mid-decode whatever the machine's speed. Returns
    (reached, go); ``del eng._dispatch_chunk`` removes the gate."""
    reached, go = threading.Event(), threading.Event()
    orig = eng._dispatch_chunk

    def dispatch(active):
        if not go.is_set() and watch and all(r.emitted >= n for r in watch):
            reached.set()
            go.wait(60)
        return orig(active)

    eng._dispatch_chunk = dispatch
    return reached, go


def _preempt_drill(eng, sampler, seed=5, member=0, bystander=None):
    """The JAX package's drill: a batch stream is mid-decode when an
    interactive request arrives on an engine with no free row; the victim
    resumes and equals its solo run. Returns (solo, victim's stream)."""
    solo = list(eng.stream_results(eng.submit(list(VICTIM), max_new_tokens=40,
                                              sampler=sampler, seed=seed, member=member)))
    assert len(solo) == 40
    before = eng.n_preemptions
    watch: list = []
    reached, go = _gate(eng, watch)
    try:
        victim = eng.submit(list(VICTIM), max_new_tokens=40, sampler=sampler, seed=seed,
                            priority="batch", member=member)
        watch.append(victim)
        got: list = []
        th = threading.Thread(target=_drain, args=(eng, victim, got), daemon=True)
        th.start()
        assert reached.wait(60), "the victim never reached mid-decode"
        assert 8 <= victim.emitted < 40, victim.emitted
        bene = eng.submit([41, 43, 47], max_new_tokens=6, sampler=sampler, seed=9,
                          priority="interactive", member=member)
        go.set()
        bene_got = list(eng.stream_results(bene))
        th.join(120)
    finally:
        go.set()
        del eng._dispatch_chunk
    assert not th.is_alive(), "victim stream never completed"
    assert len(bene_got) == 6
    assert eng.n_preemptions == before + 1
    assert victim.n_preempts == 1
    return solo, got


@pytest.fixture(scope="module")
def drill_engines(weights):
    engines = {"dense": _port(weights, n_slots=1, decode_chunk=4, qos=True),
               "paged": _port(weights, n_slots=1, decode_chunk=4, qos=True, kv_pages=True,
                              kv_page_size=16),
               "zero_drain": _port(weights, n_slots=1, decode_chunk=4, qos=True,
                                   zero_drain=True, prefill_chunk=16)}
    yield engines
    for e in engines.values():
        e.shutdown()


@pytest.fixture(scope="module")
def jax_greedy_solo(weights):
    eng = JaxEngine(weights[0], params=weights[1], n_slots=1, decode_chunk=4)
    try:
        return eng.generate(list(VICTIM), max_new_tokens=40,
                            sampler=JaxSampler(temperature=0.0), seed=5).token_ids
    finally:
        eng.shutdown()


@pytest.mark.parametrize("kind", ["dense", "paged", "zero_drain"])
@pytest.mark.parametrize("sampler", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
def test_preempted_stream_token_exact(drill_engines, jax_greedy_solo, kind, sampler):
    eng = drill_engines[kind]
    solo, got = _preempt_drill(eng, sampler)
    assert got == solo, (len(got), len(solo))
    if sampler.greedy:
        assert solo == jax_greedy_solo
    m = eng.metrics()
    assert m["qos"] == 1 and m["preemptions_total"] >= 1
    assert m["preempted_tokens_total"] >= 8
    assert m["replayed_tokens_total"] == m["preempted_tokens_total"]
    if eng.kv_pages:
        assert m["kv_pages_allocated"] + m["kv_pages_free"] == eng.kv_pool_pages
        with eng._cond:
            assert all(c == 0 for c in eng._page_claims)
    if eng.zero_drain:
        assert m["admission_dispatches_total"] == 0 and m["admission_stall_seconds_total"] == 0


@pytest.mark.parametrize("sampler", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
def test_members_preemption_token_exact_and_member_local(weights, sampler):
    """An interactive arrival on member 0 parks member 0's batch resident
    only; the bystander on member 1 is never preempted and both streams
    equal their solo runs."""
    eng = InferenceEngine(resolve_spec("llama-tiny", OPTS), device="cpu", seed=0, n_slots=1,
                          decode_chunk=4, qos=True, members=2)
    by_ids = [31, 37, 41, 43]
    try:
        solo_b = list(eng.stream_results(eng.submit(list(by_ids), max_new_tokens=30,
                                                    sampler=sampler, seed=3, member=1)))
        got_b: list = []
        bystander = eng.submit(list(by_ids), max_new_tokens=30, sampler=sampler, seed=3,
                               priority="batch", member=1)
        th = threading.Thread(target=_drain, args=(eng, bystander, got_b), daemon=True)
        th.start()
        solo_v, got_v = _preempt_drill(eng, sampler, member=0)
        th.join(120)
        assert not th.is_alive()
        assert bystander.n_preempts == 0
        assert got_v == solo_v and got_b == solo_b
    finally:
        eng.shutdown()


def test_preempt_fault_dooms_only_the_victim(weights):
    """An ``engine.preempt`` fault mid-park: the victim's stream ends with
    the fault, the other batch stream and the interactive request finish
    as if nothing happened, nothing is rebuilt."""
    eng = _port(weights, n_slots=2, decode_chunk=4, qos=True)
    prompts = {"other": [31, 37, 41], "victim": list(VICTIM)}
    try:
        solo = {k: list(eng.stream_results(eng.submit(p, max_new_tokens=40, sampler=GREEDY)))
                for k, p in prompts.items()}
        watch: list = []
        reached, go = _gate(eng, watch)
        faults.arm("engine.preempt", times=1)
        try:
            other = eng.submit(prompts["other"], max_new_tokens=40, sampler=GREEDY,
                               priority="batch")
            victim = eng.submit(prompts["victim"], max_new_tokens=40, sampler=GREEDY,
                                priority="batch")
            watch += [other, victim]
            outs: dict = {}

            def run(name, req):
                try:
                    outs[name] = list(eng.stream_results(req))
                except faults.FaultInjected as e:
                    outs[name] = e

            ths = [threading.Thread(target=run, args=a, daemon=True)
                   for a in (("other", other), ("victim", victim))]
            for t in ths:
                t.start()
            assert reached.wait(60), "the batch streams never reached mid-decode"
            bene = eng.submit([41, 43, 47], max_new_tokens=6, sampler=GREEDY,
                              priority="interactive")
            go.set()
            assert len(list(eng.stream_results(bene))) == 6
            for t in ths:
                t.join(120)
        finally:
            go.set()
            del eng._dispatch_chunk
            faults.disarm()
        doomed = [k for k, v in outs.items() if isinstance(v, faults.FaultInjected)]
        assert len(doomed) == 1
        kept, = set(prompts) - set(doomed)
        assert outs[kept] == solo[kept]
        assert eng.n_preemptions == 0 and eng.n_rebuilds == 0
        assert eng.metrics()["failures_total"] == 1
        assert eng.health()["scheduler_alive"]
    finally:
        eng.shutdown()
