"""The port's rank runtime: rank 0 in the calling process, ranks 1..N−1 as
spawned worker processes, one per device of a ``parallel/mesh.Mesh``.

What GSPMD gives the JAX package for free — one program running on every
device of a mesh — the port builds here:

- **spawn**: each worker is a ``spawn``-method process (forking after CUDA
  has started is not allowed) whose entry point, :func:`worker_main`, lives
  in this package: a worker imports the port and torch, never a test
  module, JAX or the JAX package;
- **rendezvous**: a ``TCPStore`` at a free port on 127.0.0.1, hosted by
  rank 0; every rank then builds its groups over prefixes of it
  (``parallel/comm.join``);
- **the plan channel**: rank 0 runs the only scheduler. Before it issues a
  device program it sends every worker a small plan — the program, its key
  and the host inputs it uploads — over a pipe to each worker; a worker runs
  the same program on its shard, in the same order, so the collectives pair
  up. A worker's ``handler`` (built from a picklable ``setup`` in the worker,
  e.g. ``engine/follower.Follower``) runs the plans; ``run`` plans call a
  function of the port by name with the rank's mesh as ``mesh=`` (the
  tests' use). Rank 0 sends plans from several threads (the scheduler, a
  forward's caller, a report's), one whole message at a time;
- **lifecycle**: rank 0 checks that every worker is alive before each plan
  (:class:`WorkerLost` otherwise, with the worker's exit code and error),
  and a watcher thread sees a worker exit the moment it does: it records
  the loss and aborts rank 0's NCCL groups, so work waiting on the lost
  rank inside a replayed graph (which no collective timeout watches) ends
  at once; gloo collectives fail on the lost peer's connection, each group
  bounded by the mesh's timeout. :meth:`RankGroup.stop` gives every rank
  one teardown: each worker closes its handler and acknowledges the stop,
  and once every live worker has acknowledged, every rank leaves its
  groups at the same time (bounded, an abort past the bound), then rank 0
  joins the workers within a timeout and kills any left. No rank waits in
  NCCL for a peer that has already gone.

CPU workers run one intra-op thread each (``torch.set_num_threads(1)``):
N ranks share one host. Host inputs travel as Python lists and numpy arrays
(a ``run`` plan's arrays become torch tensors on the worker's device, and
its tensor results come back as numpy arrays).
"""

from __future__ import annotations

import datetime
import faulthandler
import importlib
import logging
import multiprocessing
import multiprocessing.connection
import os
import threading
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from quorum_tpu_torch.parallel.comm import RankMesh, join
from quorum_tpu_torch.parallel.mesh import Mesh

logger = logging.getLogger(__name__)

# A worker must report in within this long after its start (process start,
# imports, its handler's set-up), and stop within STOP_TIMEOUT_S of a stop.
SPAWN_TIMEOUT_S = 300.0
STOP_TIMEOUT_S = 30.0
# Seconds every rank gives its groups' orderly shutdown before it aborts them.
LEAVE_TIMEOUT_S = 10.0
# Seconds a failed ``run`` on rank 0 waits to see whether a worker's exit
# caused it (a dying peer fails the collective before its process is gone).
LOST_GRACE_S = 5.0
# A worker dumps its threads' stacks to stderr every this many seconds when
# set (a hang's diagnosis; scripts/torch_mesh_probe.py sets it).
STACKS_ENV = "QUORUM_RANK_STACKS_S"
# Only functions and handlers of the port may be named in a plan.
_PACKAGE = "quorum_tpu_torch."


class WorkerLost(RuntimeError):
    """A worker rank exited (or never reported in): the mesh cannot run."""


def _resolve(path: str):
    """``"quorum_tpu_torch.mod.sub:name"`` → the object."""
    mod, _, name = path.partition(":")
    if not mod.startswith(_PACKAGE):
        raise ValueError(f"{path!r} is not a function of the port")
    return getattr(importlib.import_module(mod), name)


def _to_rank(obj, device):
    """A plan's host inputs on a worker: numpy arrays become tensors on its
    device (lists, tuples and dicts are walked)."""
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(np.array(obj)).to(device)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_rank(x, device) for x in obj)
    if isinstance(obj, dict):
        return {k: _to_rank(v, device) for k, v in obj.items()}
    return obj


def to_host(obj):
    """Tensors as numpy arrays (16-bit floats widened to float32), walked
    through lists, tuples and dicts: what crosses a pipe."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        return (t.float() if t.dtype in (torch.bfloat16, torch.float16) else t).numpy()
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(x) for x in obj)
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    return obj


def _store(port: int, size: int, master: bool, timeout_s: float):
    return dist.TCPStore("127.0.0.1", port, size, master,
                         timeout=datetime.timedelta(seconds=timeout_s),
                         wait_for_workers=False)


def worker_main(rank: int, mesh: Mesh, port: int, conn, setup, staging: bool = False,
                forward: bool = False) -> None:
    """A worker rank's life: report in, join the mesh (with the staging
    stream's groups when ``staging``, the forward stream's with
    ``forward``), build its handler, then run plans until a stop or until
    rank 0's pipe closes. An error is sent to rank 0 and ends the process
    (rank 0 then sees it dead)."""
    rmesh = None
    stacks = float(os.environ.get(STACKS_ENV, "0") or 0)
    if stacks > 0:  # a hang's diagnosis: every rank's stacks every so often
        faulthandler.dump_traceback_later(stacks, repeat=True)
    try:
        dev = mesh.devices[rank]
        if dev.type == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(dev)
        conn.send(("hello", rank, os.getpid()))
        rmesh = join(mesh, rank, _store(port, mesh.size, False, mesh.timeout_s), staging,
                     forward)
        handler = None
        if setup is not None:
            path, kwargs = setup
            handler = _resolve(path)(rmesh, **kwargs)
        conn.send(("ready", rank))
        while True:
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                break  # rank 0 is gone
            op, args, reply = msg
            if op == "stop":
                close = getattr(handler, "close", None)
                if close is not None:
                    close()
                handler = None
                # Acknowledge, then leave the groups when rank 0 says every
                # rank has stopped (or its pipe closes, or the bound passes).
                conn.send(("stopped", rank))
                if conn.poll(STOP_TIMEOUT_S):
                    try:
                        conn.recv()
                    except (EOFError, OSError):
                        pass
                break
            if op == "run":
                fn = _resolve(args[0])
                out = fn(*_to_rank(args[1], dev), mesh=rmesh, **_to_rank(args[2], dev))
            else:
                out = getattr(handler, op)(*args)
            if reply:
                conn.send(("ok", to_host(out)))
        close = getattr(handler, "close", None)
        if close is not None:
            close()
    except BaseException:
        text = traceback.format_exc()
        try:
            conn.send(("err", text))
        except Exception:
            pass
        logger.error("rank %d failed:\n%s", rank, text)
        os._exit(1)
    finally:
        if rmesh is not None and not rmesh.shutdown(LEAVE_TIMEOUT_S):
            rmesh.wait_abort(mesh.timeout_s)


class RankGroup:
    """Rank 0 of a mesh in this process and the worker processes of the
    others. :meth:`spawn` starts the workers; :meth:`join` (after rank 0's
    own set-up, which overlaps the workers' start) joins the groups and
    waits until every worker's handler is built; :meth:`plan` sends a plan;
    :meth:`stop` ends them. ``setup(rank)`` gives worker ``rank``'s
    ``(path, kwargs)`` handler set-up (None: ``run`` plans only);
    ``staging``: every rank joins the staging stream's groups too (a
    zero-drain engine's), ``forward`` the forward stream's (an engine's
    embeddings and scoring; ``comm.StreamMesh``)."""

    def __init__(self, mesh: Mesh, setup=None, staging: bool = False, forward: bool = False):
        self.mesh = mesh
        self._setup = setup
        self.staging = staging
        self.forward = forward
        self._send_lock = threading.Lock()
        self.procs: list = []
        self._conns: list = []
        self.pids: dict[int, int] = {}
        self.rank_mesh: RankMesh | None = None
        self._store = None
        self._lost: WorkerLost | None = None
        self._errors: dict[int, str] = {}
        self._stopping = threading.Event()
        self._watcher: threading.Thread | None = None

    @property
    def size(self) -> int:
        return self.mesh.size

    def spawn(self) -> "RankGroup":
        self._store = _store(0, self.size, True, self.mesh.timeout_s)
        port = self._store.port
        ctx = multiprocessing.get_context("spawn")
        for r in range(1, self.size):
            parent, child = ctx.Pipe()
            setup = self._setup(r) if self._setup is not None else None
            p = ctx.Process(target=worker_main,
                            args=(r, self.mesh, port, child, setup, self.staging,
                                  self.forward),
                            name=f"quorum-rank-{r}", daemon=True)
            p.start()
            child.close()
            self.procs.append(p)
            self._conns.append(parent)
        return self

    def _expect(self, kind: str, timeout_s: float) -> None:
        """Wait for every worker's ``kind`` message, watching that each is
        alive; raises :class:`WorkerLost` past ``timeout_s``."""
        deadline = time.monotonic() + timeout_s
        for r, (p, c) in enumerate(zip(self.procs, self._conns), start=1):
            while True:
                if c.poll(0.05):
                    msg = c.recv()
                    if msg[0] == kind:
                        if kind == "hello":
                            self.pids[r] = msg[2]
                        break
                    if msg[0] == "err":
                        self._errors[r] = msg[1]
                        raise self._lose(f"rank {r} failed while starting:\n{msg[1]}")
                    continue
                if not p.is_alive():
                    raise self._lose(f"rank {r} exited with code {p.exitcode} while starting")
                if time.monotonic() > deadline:
                    raise self._lose(f"rank {r} did not report {kind!r} within {timeout_s:.0f} s")

    def join(self) -> RankMesh:
        """Join rank 0 to the mesh once every worker has started, then wait
        for every worker's handler."""
        self._expect("hello", SPAWN_TIMEOUT_S)
        self.rank_mesh = join(self.mesh, 0, self._store, self.staging, self.forward)
        self._expect("ready", SPAWN_TIMEOUT_S)
        if self.procs:
            self._watcher = threading.Thread(target=self._watch, name="quorum-rank-watch",
                                             daemon=True)
            self._watcher.start()
        return self.rank_mesh

    def _watch(self) -> None:
        """Until :meth:`stop`: the moment a worker exits, record the loss
        and abort rank 0's NCCL groups (the module docstring's lifecycle)."""
        sentinels = {p.sentinel: r for r, p in enumerate(self.procs, start=1)}
        while not self._stopping.is_set():
            gone = multiprocessing.connection.wait(list(sentinels), timeout=0.2)
            if not gone or self._stopping.is_set():
                continue
            r = sentinels[gone[0]]
            self._lose(f"rank {r} exited with code {self.procs[r - 1].exitcode}")
            logger.error("mesh rank %d exited; aborting rank 0's groups", r)
            if self.rank_mesh is not None:
                self.rank_mesh.abort()
            return

    def start(self) -> RankMesh:
        return self.spawn().join()

    def _lose(self, why: str) -> WorkerLost:
        if self._lost is None:
            self._lost = WorkerLost(why)
        return self._lost

    def check(self) -> None:
        """Raise :class:`WorkerLost` unless every worker is alive."""
        if self._lost is not None:
            raise self._lost
        for r, (p, c) in enumerate(zip(self.procs, self._conns), start=1):
            if not p.is_alive():
                err = ""
                try:
                    while c.poll(0):
                        msg = c.recv()
                        if msg[0] == "err":
                            err = "\n" + msg[1]
                except (EOFError, OSError):
                    pass
                raise self._lose(f"rank {r} exited with code {p.exitcode}{err}")

    @property
    def lost(self) -> WorkerLost | None:
        return self._lost

    def plan(self, op: str, *args, reply: bool = False):
        """Send plan ``op(*args)`` to every worker (after a liveness check);
        with ``reply``, wait for and return each worker's result, rank 1
        first."""
        self.check()
        with self._send_lock:
            for c in self._conns:
                try:
                    c.send((op, args, reply))
                except (BrokenPipeError, OSError) as e:
                    self.check()
                    raise self._lose(f"a worker's plan channel broke: {e}") from e
        return self.replies() if reply else None

    def replies(self) -> list:
        out = []
        deadline = time.monotonic() + self.mesh.timeout_s
        for r, (p, c) in enumerate(zip(self.procs, self._conns), start=1):
            while not c.poll(0.05):
                if not p.is_alive():
                    self.check()
                if time.monotonic() > deadline:
                    raise self._lose(f"rank {r} sent no reply within {self.mesh.timeout_s:.0f} s")
            kind, val = c.recv()
            if kind == "err":
                self._errors[r] = val
                raise self._lose(f"rank {r} failed:\n{val}")
            out.append(val)
        return out

    def run(self, path: str, per_rank_args, per_rank_kwargs=None) -> list:
        """Call port function ``path`` as ``fn(*args, mesh=rank_mesh, **kwargs)``
        on every rank with rank r's ``per_rank_args[r]`` (numpy arrays
        become tensors on r's device); returns every rank's result, rank 0
        first, tensors as numpy arrays. A worker lost meanwhile raises
        :class:`WorkerLost` (a training step over a lost stage ends so)."""
        kw = per_rank_kwargs or [{} for _ in range(self.size)]
        self.check()
        for r, c in enumerate(self._conns, start=1):
            c.send(("run", (path, per_rank_args[r], kw[r]), True))
        dev = self.mesh.devices[0]
        try:
            mine = _resolve(path)(*_to_rank(per_rank_args[0], dev), mesh=self.rank_mesh,
                                  **_to_rank(kw[0], dev))
        except Exception as e:
            # A collective that failed because a worker died (its peer's
            # connection closed, or its groups aborted by the watcher) is
            # that loss: WorkerLost, once the exit is seen.
            lost = self._await_loss(LOST_GRACE_S)
            if lost is not None:
                raise lost from e
            raise
        return [to_host(mine)] + self.replies()

    def _await_loss(self, timeout_s: float) -> WorkerLost | None:
        """A worker lost within ``timeout_s``: one that exited without
        sending an error of its own (a worker that failed on the plan, as
        rank 0 did, is not lost). None once every worker has exited with
        its error, or at the deadline."""
        deadline = time.monotonic() + timeout_s
        failed: set[int] = set()
        while True:
            for r, (p, c) in enumerate(zip(self.procs, self._conns), start=1):
                if r in failed or p.is_alive():
                    continue
                try:
                    while c.poll(0):
                        if c.recv()[0] == "err":
                            failed.add(r)
                except (EOFError, OSError):
                    pass
                if r not in failed:
                    return self._lose(f"rank {r} exited with code {p.exitcode}")
            if len(failed) == len(self.procs) or time.monotonic() >= deadline:
                return None
            time.sleep(0.05)

    def kill(self, rank: int) -> None:
        """Kill worker ``rank`` at once (SIGKILL): the drill of a lost rank."""
        self.procs[rank - 1].kill()

    def stop(self, timeout_s: float = STOP_TIMEOUT_S) -> None:
        """Stop every worker, every rank through one teardown: a stop plan
        to each live worker, which closes its handler and acknowledges
        (within ``timeout_s``); then every rank leaves its groups at once —
        an orderly shutdown when every worker acknowledged and none was
        lost, an abort otherwise —; then a join within the rest of
        ``timeout_s`` and a kill on expiry."""
        self._stopping.set()
        deadline = time.monotonic() + timeout_s
        asked = []
        for p, c in zip(self.procs, self._conns):
            if p.is_alive():
                try:
                    c.send(("stop", (), False))
                    asked.append((p, c))
                except (BrokenPipeError, OSError):
                    pass
        acked = []
        for p, c in asked:
            while time.monotonic() < deadline:
                try:
                    if c.poll(0.05):
                        if c.recv()[0] == "stopped":
                            acked.append(c)
                            break
                        continue
                except (EOFError, OSError):
                    break
                if not p.is_alive():
                    break
        for c in acked:
            try:
                c.send(("leave", (), False))
            except (BrokenPipeError, OSError):
                pass
        if self.rank_mesh is not None:
            everyone = len(acked) == len(self.procs) and self._lost is None
            if everyone or self.mesh.backend != "nccl":
                self.rank_mesh.shutdown(LEAVE_TIMEOUT_S)
            else:
                self.rank_mesh.abort()
            # Every group's abort is bounded by the mesh's timeout; the
            # process must not go on to its exit while one still runs.
            if not self.rank_mesh.wait_abort(self.mesh.timeout_s + LEAVE_TIMEOUT_S):
                logger.error("rank 0's group abort is still running after %.0f s",
                             self.mesh.timeout_s + LEAVE_TIMEOUT_S)
            self.rank_mesh = None
        for p in self.procs:
            p.join(max(0.0, deadline + LEAVE_TIMEOUT_S - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join(5.0)
        for c in self._conns:
            c.close()
        if self._watcher is not None:
            self._watcher.join(1.0)
        self._store = None

    def alive_pids(self) -> list[int]:
        return [p.pid for p in self.procs if p.is_alive()]


def imported(names, *, mesh=None) -> list[str]:
    """The modules this process has imported that are, or lie under, one of
    the top-level packages ``names`` (``["jax", "quorum_tpu"]``: what a
    rank must never import). A ``run`` plan's diagnostic."""
    import sys

    return sorted(m for m in sys.modules
                  if any(m == n or m.startswith(n + ".") for n in names))
