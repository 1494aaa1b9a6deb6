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
  tests' use);
- **lifecycle**: rank 0 checks that every worker is alive before each plan
  (:class:`WorkerLost` otherwise, with the worker's exit code and error);
  :meth:`RankGroup.stop` sends each a stop, joins it within a timeout and
  kills it on expiry. Each group has the mesh's timeout, so a collective
  whose peer died fails instead of hanging.

CPU workers run one intra-op thread each (``torch.set_num_threads(1)``):
N ranks share one host. Host inputs travel as Python lists and numpy arrays
(a ``run`` plan's arrays become torch tensors on the worker's device, and
its tensor results come back as numpy arrays).
"""

from __future__ import annotations

import datetime
import importlib
import logging
import multiprocessing
import os
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


def worker_main(rank: int, mesh: Mesh, port: int, conn, setup) -> None:
    """A worker rank's life: report in, join the mesh, build its handler,
    then run plans until a stop or until rank 0's pipe closes. An error
    is sent to rank 0 and ends the process (rank 0 then sees it dead)."""
    rmesh = None
    try:
        dev = mesh.devices[rank]
        if dev.type == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(dev)
        conn.send(("hello", rank, os.getpid()))
        rmesh = join(mesh, rank, _store(port, mesh.size, False, mesh.timeout_s))
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
        if rmesh is not None:
            rmesh.shutdown()


class RankGroup:
    """Rank 0 of a mesh in this process and the worker processes of the
    others. :meth:`spawn` starts the workers; :meth:`join` (after rank 0's
    own set-up, which overlaps the workers' start) joins the groups and
    waits until every worker's handler is built; :meth:`plan` sends a plan;
    :meth:`stop` ends them. ``setup(rank)`` gives worker ``rank``'s
    ``(path, kwargs)`` handler set-up (None: ``run`` plans only)."""

    def __init__(self, mesh: Mesh, setup=None):
        self.mesh = mesh
        self._setup = setup
        self.procs: list = []
        self._conns: list = []
        self.pids: dict[int, int] = {}
        self.rank_mesh: RankMesh | None = None
        self._store = None
        self._lost: WorkerLost | None = None
        self._errors: dict[int, str] = {}

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
            p = ctx.Process(target=worker_main, args=(r, self.mesh, port, child, setup),
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
        self.rank_mesh = join(self.mesh, 0, self._store)
        self._expect("ready", SPAWN_TIMEOUT_S)
        return self.rank_mesh

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
        first, tensors as numpy arrays."""
        kw = per_rank_kwargs or [{} for _ in range(self.size)]
        self.check()
        for r, c in enumerate(self._conns, start=1):
            c.send(("run", (path, per_rank_args[r], kw[r]), True))
        dev = self.mesh.devices[0]
        mine = _resolve(path)(*_to_rank(per_rank_args[0], dev), mesh=self.rank_mesh,
                              **_to_rank(kw[0], dev))
        return [to_host(mine)] + self.replies()

    def kill(self, rank: int) -> None:
        """Kill worker ``rank`` at once (SIGKILL): the drill of a lost rank."""
        self.procs[rank - 1].kill()

    def stop(self, timeout_s: float = STOP_TIMEOUT_S) -> None:
        """Stop every worker: a stop plan, a join within ``timeout_s``, a
        kill on expiry; then rank 0 leaves its groups."""
        for p, c in zip(self.procs, self._conns):
            if p.is_alive():
                try:
                    c.send(("stop", (), False))
                except (BrokenPipeError, OSError):
                    pass
        deadline = time.monotonic() + timeout_s
        for p in self.procs:
            p.join(max(0.0, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join(5.0)
        for c in self._conns:
            c.close()
        if self.rank_mesh is not None:
            self.rank_mesh.shutdown()
            self.rank_mesh = None
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
