"""Engine flight recorder: an always-on, bounded ring of structured events.

A graph replay is one opaque dispatch to a request's trace. This ring is the
post-hoc answer: every engine records its scheduling decisions here as small
structured events (a dispatch issued and reaped per ring entry, tagged with
its program family; admissions, registrations, deadline expiries, breaker
and containment events), stamped with one monotonic clock
(``time.perf_counter``) and the request id.

  - **bounded**: a ``deque(maxlen=capacity)`` (default 4096 events,
    ``QUORUM_TPU_FLIGHT_EVENTS``); past the cap the oldest event is
    overwritten and an ``on_drop`` hook ticks (wired to
    ``quorum_tpu_flight_recorder_dropped_total`` by ``observability``).
  - **lock-cheap**: ``record`` takes one short lock, builds one small tuple
    and appends; no I/O, no device access. ``QUORUM_TPU_FLIGHT_RECORDER=0``
    turns it off (``record`` returns at once).
  - **exportable**: JSON (``snapshot``) and Chrome/Perfetto trace events
    (``to_trace_events``; open the file in ui.perfetto.dev), both served from
    ``GET /debug/engine/timeline``.
  - **post-mortem**: ``dump(reason)`` writes the ring to
    ``logs/flightrec-<reason>-<stamp>.json`` (``QUORUM_TPU_FLIGHT_DIR``),
    rate-limited per reason; the engine dumps on ``_fail_all``, verify
    containment and breaker-open.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque

logger = logging.getLogger(__name__)

# Dispatch/reap pairs become Perfetto "X" (complete) slices; everything else
# is an instant event on its loop's track.
_SPAN_KINDS = frozenset({"reap"})


class FlightRecorder:
    """Process-wide bounded ring of engine events (see module docstring)."""

    def __init__(self, capacity: int | None = None,
                 enabled: bool | None = None):
        if capacity is None:
            capacity = int(os.environ.get("QUORUM_TPU_FLIGHT_EVENTS", "4096"))
        self.capacity = max(16, int(capacity))
        if enabled is None:
            enabled = os.environ.get("QUORUM_TPU_FLIGHT_RECORDER", "1") != "0"
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        # (t, kind, rid, engine, loop, data-dict-or-None)
        self._ring: deque = deque(maxlen=self.capacity)
        self._n_recorded = 0
        # Hook ticked when a full ring overwrites its oldest event —
        # observability wires the dropped-events counter through it (the
        # recorder itself imports nothing from observability: no cycle).
        self.on_drop = None
        # reason -> last dump stamp (rate limit, see dump()).
        self._last_dump: dict[str, float] = {}
        self._dump_seq = 0

    # -- recording -----------------------------------------------------------

    def record(self, kind: str, rid: str = "", engine: str = "",
               loop: str = "", t: float | None = None, **data) -> None:
        """Append one event. ``t`` defaults to ``time.perf_counter()`` now —
        pass an explicit stamp to backdate (e.g. a dispatch's issue time).
        ``data`` values must be JSON-serializable scalars/lists."""
        if not self.enabled:
            return
        if t is None:
            t = time.perf_counter()
        ev = (t, kind, rid, engine, loop, data or None)
        with self._lock:
            if len(self._ring) >= self.capacity and self.on_drop is not None:
                try:
                    self.on_drop()
                except Exception:
                    pass
            self._ring.append(ev)
            self._n_recorded += 1

    def depth(self) -> int:
        with self._lock:
            return len(self._ring)

    def total(self) -> int:
        """Events recorded over the recorder's lifetime (>= depth)."""
        with self._lock:
            return self._n_recorded

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._n_recorded = 0
            self._last_dump.clear()

    # -- export --------------------------------------------------------------

    def snapshot(self, limit: int | None = None) -> list[dict]:
        """The ring as a list of event dicts, oldest first. ``t`` is
        seconds on the process-wide ``time.perf_counter`` clock — the same
        timebase every stamp in ``data`` (t_issue/t_ready) uses, so
        cross-loop ordering is exact."""
        with self._lock:
            events = list(self._ring)
        if limit is not None:
            events = events[-limit:]
        out = []
        for t, kind, rid, engine, loop, data in events:
            ev = {"t": round(t, 6), "kind": kind}
            if rid:
                ev["rid"] = rid
            if engine:
                ev["engine"] = engine
            if loop:
                ev["loop"] = loop
            if data:
                ev.update(data)
            out.append(ev)
        return out

    def to_trace_events(self) -> list[dict]:
        """Chrome trace-event export (open in ui.perfetto.dev or
        chrome://tracing). Layout: one Perfetto *process* per engine (plus
        one for engine-less events, e.g. server-side backstops); inside it,
        reaped dispatches render as complete ("X") slices on per-ring-depth
        threads — overlapped in-flight dispatches show as parallel bars,
        each tagged with its program family and request ids — and every
        other event is an instant ("i") on its loop's thread. Request-id
        correlation across the prefill/decode loops rides ``args.rid``."""
        with self._lock:
            events = list(self._ring)
        pids: dict[str, int] = {}
        tids: dict[tuple[int, str], int] = {}
        meta: list[dict] = []
        out: list[dict] = []

        def pid_of(engine: str) -> int:
            name = engine or "server"
            p = pids.get(name)
            if p is None:
                p = len(pids) + 1
                pids[name] = p
                meta.append({"ph": "M", "name": "process_name", "pid": p,
                             "tid": 0, "args": {"name": name}})
            return p

        def tid_of(pid: int, track: str) -> int:
            t = tids.get((pid, track))
            if t is None:
                t = sum(1 for (p, _) in tids if p == pid) + 1
                tids[(pid, track)] = t
                meta.append({"ph": "M", "name": "thread_name", "pid": pid,
                             "tid": t, "args": {"name": track}})
            return t

        for t, kind, rid, engine, loop, data in events:
            data = data or {}
            pid = pid_of(engine)
            args = {k: v for k, v in data.items()}
            if rid:
                args["rid"] = rid
            if kind in _SPAN_KINDS and "t_issue" in data:
                t_issue = float(data["t_issue"])
                t_ready = float(data.get("t_ready") or t)
                tid = tid_of(pid, "ring[%d]" % int(data.get("depth", 0)))
                out.append({
                    "ph": "X", "name": str(data.get("family") or kind),
                    "cat": "dispatch", "pid": pid, "tid": tid,
                    "ts": round(t_issue * 1e6, 3),
                    "dur": round(max(0.0, t_ready - t_issue) * 1e6, 3),
                    "args": args,
                })
                continue
            tid = tid_of(pid, loop or "events")
            out.append({
                "ph": "i", "s": "t", "name": kind, "cat": kind,
                "pid": pid, "tid": tid, "ts": round(t * 1e6, 3),
                "args": args,
            })
        return meta + out

    # -- post-mortem dumps ---------------------------------------------------

    def dump(self, reason: str, log_dir: str | None = None) -> str | None:
        """Write the ring to ``<dir>/flightrec-<reason>-<stamp>.json``;
        returns the path, or None when disabled/rate-limited/failed. Never
        raises — a failing dump must not take the scheduler turn with it.
        Rate-limited per reason (``QUORUM_TPU_FLIGHT_DUMP_INTERVAL``
        seconds, default 0.25) so a containment storm cannot turn into a
        disk-write storm; the ring is cumulative, so the newest artifact
        still holds the suppressed occurrences' events."""
        if not self.enabled:
            return None
        try:
            interval = float(os.environ.get(
                "QUORUM_TPU_FLIGHT_DUMP_INTERVAL", "0.25"))
        except ValueError:
            interval = 0.25
        now = time.monotonic()
        with self._lock:
            last = self._last_dump.get(reason)
            if last is not None and now - last < interval:
                return None
            self._last_dump[reason] = now
            self._dump_seq += 1
            seq = self._dump_seq
        try:
            out_dir = log_dir or os.environ.get("QUORUM_TPU_FLIGHT_DIR",
                                                "logs")
            os.makedirs(out_dir, exist_ok=True)
            stamp = time.strftime("%Y%m%d-%H%M%S")
            path = os.path.join(
                out_dir, f"flightrec-{reason}-{stamp}-{seq:04d}.json")
            body = {
                "reason": reason,
                "dumped_at": time.time(),
                "clock": "perf_counter",
                "events": self.snapshot(),
            }
            with open(path, "w") as f:
                json.dump(body, f)
            logger.warning("flight recorder dumped %d events to %s (%s)",
                           len(body["events"]), path, reason)
            return path
        except Exception:
            logger.exception("flight recorder dump failed (%s)", reason)
            return None


RECORDER = FlightRecorder()
