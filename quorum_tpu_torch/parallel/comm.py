"""Collectives of the port's multi-rank runtime, over ``torch.distributed``
process groups: what GSPMD inserts for the JAX package (its
``parallel/sharding.py`` lets XLA place the all-reduces; its ring and
Ulysses run ``ppermute`` and ``all_to_all`` inside ``shard_map``).

A :class:`Group` is one rank's view of one axis subgroup (the mesh's dp,
pp, tp or sp ranks, or all of them): all-reduce (sum or max), all-gather along a
dimension, broadcast, all-to-all, the ring's pass to the next rank and the
pipeline's one-way hop (:meth:`Group.shift`). A
:class:`RankMesh` is the mesh as one rank sees it: the layout
(``parallel/mesh.Mesh``), the rank, its coordinates, its ``world``, ``dp``,
``pp``, ``tp`` and ``sp`` groups and, on an engine, the slot rows its KV cache
holds (:meth:`RankMesh.hold_slots`). :func:`join` builds one from a
rendezvous store.

A second stream of a rank (a zero-drain engine's staging stream, the
cache-free forwards' stream) runs its collectives over groups of its own
(:class:`StreamMesh`, :func:`join`'s ``staging`` and ``forward``): NCCL
kernels of one communicator on two concurrent streams may interleave
differently on different ranks and hang.

Training differentiates through the tp collectives (Megatron's f and g):
:func:`tp_enter` is the identity forward and sums the gradient over the
group backward, :meth:`Group.all_reduce` of a tensor that requires grad is
the sum forward and the identity backward, and an all-gather's backward
keeps the rank's own slice of the gradient. Every tp rank then computes
the whole loss and the whole gradient of each replicated leaf.

The groups are the c10d backends themselves (``ProcessGroupNCCL`` or
``ProcessGroupGloo``), made per mesh from a prefix of the mesh's own store,
never the process's default group: one serving process may hold several
meshes' rank 0. Every group has the mesh's timeout.

NCCL works on device tensors and its collectives record into CUDA graphs:
the engine's decode graphs capture them. Gloo works on host tensors, so a
CUDA tensor is staged through a host copy around each collective (a sum
widens 16-bit floats to float32, exactly; a move keeps their bits) — a host round trip no graph can capture,
so an engine over gloo on CUDA decodes eagerly. A gloo group of one rank
(tp on a dp-only mesh) skips its collectives: they are the identity. Each
call counts one collective of its kind (:data:`COLLECTIVES`), counted as
captured inside a capture and added per replay (``ops/launches.py``), as
the kernels' launches are.
"""

from __future__ import annotations

import datetime
import logging
import os
import threading

import torch
import torch.distributed as dist

from quorum_tpu_torch.ops import launches
from quorum_tpu_torch.parallel.mesh import AXIS_DP, AXIS_PP, AXIS_SP, AXIS_TP, Mesh

logger = logging.getLogger(__name__)


class _Counter:
    """A collective kind's call count, in the launch counters' form."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0

    def __repr__(self) -> str:
        return f"<collective {self.name}>"


COLLECTIVES = {name: _Counter(name) for name in
               ("all_reduce", "all_reduce_max", "all_gather", "broadcast", "all_to_all",
                "ring_pass", "p2p")}


def collective_counts() -> dict[str, int]:
    """Collectives this process issued (replays adding what they captured)."""
    return {name: c.launches for name, c in COLLECTIVES.items()}


def _timeout(seconds: float) -> datetime.timedelta:
    return datetime.timedelta(seconds=seconds)


def _gloo_device(hosts: int):
    """Loopback while the mesh's ranks share one host; across hosts the
    interface ``GLOO_SOCKET_IFNAME`` names, else the host name's."""
    if hosts <= 1:
        return dist.ProcessGroupGloo.create_device(hostname="127.0.0.1")
    ifname = os.environ.get("GLOO_SOCKET_IFNAME")
    if ifname:
        return dist.ProcessGroupGloo.create_device(interface=ifname.split(",")[0])
    return dist.ProcessGroupGloo.create_default_device()


def new_process_group(backend: str, store, rank: int, size: int, timeout_s: float,
                      hosts: int = 1):
    """A c10d backend over ``store`` (a prefix of the mesh's store)."""
    if backend == "gloo":
        opts = dist.ProcessGroupGloo._Options()
        opts._timeout = _timeout(timeout_s)
        opts._devices = [_gloo_device(hosts)]
        return dist.ProcessGroupGloo(store, rank, size, opts)
    opts = dist.ProcessGroupNCCL.Options()
    opts._timeout = _timeout(timeout_s)
    return dist.ProcessGroupNCCL(store, rank, size, opts)


class Group:
    """One rank's view of one subgroup: ``ranks`` (global, in group order),
    this rank's index ``rank`` in it, and the collectives."""

    def __init__(self, name: str, pg, ranks: list[int], global_rank: int, backend: str):
        self.name = name
        self.pg = pg
        self.ranks = list(ranks)
        self.size = len(ranks)
        self.rank = ranks.index(global_rank)
        self.backend = backend

    def __repr__(self) -> str:
        return f"Group({self.name}, ranks={self.ranks}, rank={self.rank}, {self.backend})"

    @property
    def alone(self) -> bool:
        """A gloo group of one rank: its collectives are the identity and
        are skipped (and not counted), where staging them would copy
        through the host for nothing. A one-rank NCCL group still issues
        them, so a one-rank mesh's graphs capture what a wider one's do."""
        return self.size == 1 and self.backend == "gloo"

    # ---- host staging (gloo on CUDA tensors) -------------------------------

    def _stage(self, x: torch.Tensor, reduce: bool = False) -> torch.Tensor:
        """The tensor the backend works on: ``x`` itself, or for gloo a host
        copy of a CUDA tensor. A sum takes 16-bit floats widened to float32
        (exact); a move sends their bits as they are (bfloat16 viewed as
        float16, which gloo moves)."""
        if self.backend != "gloo" or not x.is_cuda:
            return x.contiguous()
        h = x.detach().to("cpu")
        if h.dtype in (torch.bfloat16, torch.float16):
            return h.float() if reduce else h.view(torch.float16)
        return h

    @staticmethod
    def _back(h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """A staged result on ``like``'s device, in its dtype."""
        if h.dtype == torch.float16 and like.dtype == torch.bfloat16:
            h = h.view(torch.bfloat16)
        return h.to(device=like.device, dtype=like.dtype)

    # ---- collectives -------------------------------------------------------

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Sum (``op="sum"``) or take the elementwise max (``op="max"``: an
        int8 product's activation amax over a contraction axis tp cuts) of
        ``x`` over the group, in place; returns ``x``. A tensor that
        requires grad is summed into a new one instead (the identity
        backward: Megatron's g). The max counts as ``all_reduce_max``."""
        if self.alone:
            return x
        if op not in ("sum", "max"):
            raise ValueError(f"all_reduce op {op!r} (sum or max)")
        if op == "sum" and x.requires_grad and torch.is_grad_enabled():
            return _SumOut.apply(x, self)
        launches.count(COLLECTIVES["all_reduce" if op == "sum" else "all_reduce_max"])
        h = self._stage(x, reduce=True)
        opts = dist.AllreduceOptions()
        opts.reduceOp = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
        self.pg.allreduce([h], opts).wait()
        if h is not x:
            x.copy_(h)
        return x

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim``, in group order
        (differentiable: the gradient's own slice goes back)."""
        if self.alone:
            return x
        if x.requires_grad and torch.is_grad_enabled():
            return _GatherOut.apply(x, self, dim)
        launches.count(COLLECTIVES["all_gather"])
        h = self._stage(x)
        out = torch.empty((self.size * h.numel(),), dtype=h.dtype, device=h.device)
        self.pg._allgather_base(out, h.reshape(-1)).wait()
        out = self._back(out.view(self.size, *h.shape), x)
        return torch.cat(out.unbind(0), dim=dim)

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Group rank ``src``'s ``x`` into every rank's ``x``, in place."""
        if self.alone:
            return x
        launches.count(COLLECTIVES["broadcast"])
        h = self._stage(x)
        opts = dist.BroadcastOptions()
        opts.rootRank, opts.rootTensor = src, 0
        self.pg.broadcast([h], opts).wait()
        if h is not x:
            x.copy_(self._back(h, x))
        return x

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` [size·n, …]: chunk j (along dim 0) goes to group rank j;
        returns [size·n, …] whose chunk j came from group rank j."""
        if self.alone:
            return x
        launches.count(COLLECTIVES["all_to_all"])
        h = self._stage(x)
        out = torch.empty_like(h)
        self.pg.alltoall_base(out, h, [], [], dist.AllToAllOptions()).wait()
        return self._back(out, x)

    def ring_pass(self, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
        """Send each tensor to the next group rank and return the ones the
        previous rank sent (the JAX ring's ``ppermute`` by one). Even ranks
        send first and odd ranks receive first, so unbatched point-to-point
        calls pair up on every backend."""
        launches.count(COLLECTIVES["ring_pass"])
        if self.size == 1:
            return [t.clone() for t in tensors]
        nxt, prv = (self.rank + 1) % self.size, (self.rank - 1) % self.size
        sends = [self._stage(t) for t in tensors]
        recvs = [torch.empty_like(s) for s in sends]
        works = []
        for tag, (s, r) in enumerate(zip(sends, recvs)):
            pair = ((self.pg.send([s], nxt, tag), self.pg.recv([r], prv, tag))
                    if self.rank % 2 == 0 else
                    (self.pg.recv([r], prv, tag), self.pg.send([s], nxt, tag)))
            if self.backend == "gloo":
                works.extend(pair)
            else:
                for w in pair:
                    w.wait()
        for w in works:
            w.wait()
        return [self._back(r, t) for r, t in zip(recvs, tensors)]

    def shift(self, out: torch.Tensor | None = None,
              like: torch.Tensor | None = None,
              reverse: bool = False) -> torch.Tensor | None:
        """One hop along the group's ring: send ``out`` (if given) to the
        next group rank and receive, into a tensor shaped like ``like`` (if
        given), what the previous rank sent; returns the received tensor.
        The pipeline's stage-to-stage hand-off; ``reverse`` hops the other
        way (to the previous rank, from the next: the hop's adjoint, which
        carries a training step's gradients back a stage). Even ranks send
        first and odd ranks receive first, as :meth:`ring_pass` pairs them,
        so the hops of one tick never wait on each other in a cycle,
        whichever ranks take part. Each send and each receive counts one
        ``p2p``; on NCCL both are recorded into a capture like any
        collective."""
        nxt, prv = (self.rank + 1) % self.size, (self.rank - 1) % self.size
        if reverse:
            nxt, prv = prv, nxt
        got = None if like is None else torch.empty_like(self._stage(like))

        def send():
            launches.count(COLLECTIVES["p2p"])
            return self.pg.send([self._stage(out)], nxt, 0)

        def recv():
            launches.count(COLLECTIVES["p2p"])
            return self.pg.recv([got], prv, 0)

        steps = [send, recv] if self.rank % 2 == 0 else [recv, send]
        for step in steps:
            if (step is send and out is None) or (step is recv and like is None):
                continue
            step().wait()
        return None if like is None else self._back(got, like)


class _SumOut(torch.autograd.Function):
    """Megatron's g: the group's sum forward, the identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce(x.detach().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Enter(torch.autograd.Function):
    """Megatron's f: the identity forward, the group's sum backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(g.contiguous().clone()), None


class _GatherOut(torch.autograd.Function):
    """An all-gather along ``dim`` forward; backward, this rank's slice of
    the gradient (every rank holds the same whole gradient)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.rank, ctx.dim, ctx.n = group.rank, dim, x.shape[dim]
        return group.all_gather(x.detach(), dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None


def tp_enter(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` (replicated over tp) entering this rank's column-parallel
    products: itself, whose gradient is summed over tp backward. The
    identity where nothing is differentiated or there is no mesh."""
    if mesh is None or not (x.requires_grad and torch.is_grad_enabled()):
        return x
    return _Enter.apply(x, mesh.tp)


class RankMesh:
    """The mesh as rank ``rank`` sees it: the layout, this rank's
    coordinates and device, and its ``world``, ``dp``, ``pp``, ``tp`` and
    ``sp`` groups (a subgroup with the world's ranks shares the world's backend).
    ``slots``: ``(lo, hi, n)``, the slot rows ``[lo, hi)`` of ``n`` this
    rank's KV cache holds, once an engine set them (:meth:`hold_slots`).
    ``stage`` and ``fwd``: the staging stream's and the forward stream's
    views (:class:`StreamMesh`) where the mesh was joined with their
    groups, else None: the staging view's tp and dp groups, the forward
    view's tp group and, on sp and pp meshes, its sp and pp groups."""

    def __init__(self, mesh: Mesh, rank: int, groups: dict[str, Group]):
        self.mesh = mesh
        self.rank = rank
        self.coords = mesh.coords(rank)
        self.device = mesh.devices[rank]
        self.world = groups["world"]
        self.dp = groups[AXIS_DP]
        self.tp = groups[AXIS_TP]
        self.sp = groups[AXIS_SP]
        self.pp = groups[AXIS_PP]
        self.slots: tuple[int, int, int] | None = None
        self.stage: StreamMesh | None = None
        self.fwd: StreamMesh | None = None
        self._aborted = False
        self._abort_thread: threading.Thread | None = None

    def __repr__(self) -> str:
        return f"RankMesh(rank={self.rank}/{self.size}, {self.coords}, {self.mesh.backend})"

    @property
    def size(self) -> int:
        return self.mesh.size

    @property
    def backend(self) -> str:
        return self.mesh.backend

    @property
    def dp_rank(self) -> int:
        return self.coords[AXIS_DP]

    @property
    def dp_size(self) -> int:
        return self.mesh.shape[AXIS_DP]

    def hold_slots(self, n_slots: int) -> tuple[int, int]:
        """Record and return the slot rows ``[lo, hi)`` of ``n_slots`` this
        rank's cache holds: its dp group's block, or every row when dp
        does not divide ``n_slots`` (``parallel/sharding.slot_rows``)."""
        from quorum_tpu_torch.parallel.sharding import slot_rows

        lo, hi = slot_rows(n_slots, self.dp_size, self.dp_rank)
        self.slots = (lo, hi, n_slots)
        return lo, hi

    @property
    def splits_slots(self) -> bool:
        """Whether this rank's cache holds a block of the slot rows (dp
        divides them) rather than all of them."""
        return self.slots is not None and self.slots[1] - self.slots[0] < self.slots[2]

    @property
    def tp_rank(self) -> int:
        return self.coords[AXIS_TP]

    @property
    def tp_size(self) -> int:
        return self.mesh.shape[AXIS_TP]

    @property
    def pp_rank(self) -> int:
        """This rank's pipeline stage."""
        return self.coords[AXIS_PP]

    @property
    def pp_size(self) -> int:
        return self.mesh.shape[AXIS_PP]

    @property
    def sp_rank(self) -> int:
        return self.coords[AXIS_SP]

    @property
    def sp_size(self) -> int:
        return self.mesh.shape[AXIS_SP]

    @property
    def graphs_ok(self) -> bool:
        """Whether this rank's collectives can be captured in CUDA graphs:
        NCCL on a card, never gloo (host-staged)."""
        return self.backend == "nccl" and self.device.type == "cuda"

    def sync_step(self, token: torch.Tensor, lengths: torch.Tensor,
                  write_mask: torch.Tensor | None):
        """Rank 0's decode-step inputs on every rank: one broadcast of
        ``[token, lengths, write_mask]`` over the world. Rank 0 keeps its
        own tensors; the other ranks get the broadcast's (their arguments
        give the shapes and dtypes)."""
        wm = (torch.ones_like(token, dtype=torch.bool) if write_mask is None else write_mask)
        buf = torch.stack([token.long(), lengths.long(), wm.long()])
        self.world.broadcast(buf, 0)
        if self.rank == 0:
            return token, lengths, write_mask
        return buf[0].to(token.dtype), buf[1].to(lengths.dtype), buf[2].bool()

    def sync_multi(self, tokens: torch.Tensor, lengths: torch.Tensor,
                   write_mask: torch.Tensor | None):
        """:meth:`sync_step` for a verify turn: rank 0's ``tokens [B, T]``
        (the anchor and the drafts), positions and write mask on every
        rank, in one broadcast of ``[B, T + 2]`` over the world."""
        wm = (torch.ones_like(lengths, dtype=torch.bool) if write_mask is None else write_mask)
        buf = torch.cat([tokens.long(), lengths.long()[:, None], wm.long()[:, None]], dim=1)
        self.world.broadcast(buf, 0)
        if self.rank == 0:
            return tokens, lengths, write_mask
        t = tokens.shape[1]
        return buf[:, :t].to(tokens.dtype), buf[:, t].to(lengths.dtype), buf[:, t + 1].bool()

    def _pgs(self) -> list:
        seen, out = set(), []
        extra = [g for side in (self.stage, self.fwd) if side is not None
                 for g in (side.tp, side.dp, side.sp, side.pp) if g is not None]
        for g in (self.world, self.dp, self.tp, self.sp, self.pp, *extra):
            if id(g.pg) not in seen:
                seen.add(id(g.pg))
                out.append(g)
        return out

    def shutdown(self, timeout_s: float = 10.0) -> bool:
        """Leave the groups: an orderly shutdown of each, bounded by
        ``timeout_s`` in all, then an abort of what is left. Every rank of
        the mesh calls this at the same point (``RankGroup.stop``): an
        NCCL group's orderly shutdown completes its peers' outstanding
        work first. Returns whether every group shut down in order."""
        if self._aborted:
            return False
        t = self._on_each_group("shutdown")
        t.join(timeout_s)
        if not t.is_alive():
            return True
        logger.error("rank %d: the groups did not shut down within %.0f s; aborting them",
                     self.rank, timeout_s)
        self.abort()
        return False

    def _on_each_group(self, op: str) -> threading.Thread:
        """Start calling ``pg.<op>()`` on each group in a thread of its own;
        returns the thread, started."""
        groups = self._pgs()

        def run():
            for g in groups:
                try:
                    getattr(g.pg, op)()
                except Exception:
                    logger.warning("rank %d: %s of group %s failed", self.rank, op, g.name,
                                   exc_info=True)

        t = threading.Thread(target=run, name=f"rank{self.rank}-{op}", daemon=True)
        t.start()
        return t

    def abort(self, wait_s: float = 5.0) -> None:
        """Abort every NCCL group, with no peer: work that waits on a lost
        rank (a collective inside a replayed graph, which no timeout
        watches) ends, and the groups are unusable from then on. Once only,
        and the caller waits at most ``wait_s``: the abort raises each
        communicator's abort flag first, which ends the waiting kernels,
        and may then wait for the resources graphs still hold. Gloo groups
        need none: a lost peer's connection fails their collectives."""
        if self.backend != "nccl" or self._aborted:
            return
        self._aborted = True
        # The thread is recorded before the wait: a caller of wait_abort on
        # another thread meanwhile must find it (a process that ends while
        # an abort still runs dies in it: CUDA is torn down under it).
        self._abort_thread = self._on_each_group("abort")
        self._abort_thread.join(wait_s)

    def wait_abort(self, timeout_s: float) -> bool:
        """Wait up to ``timeout_s`` for an abort to finish (its communicators
        released once no graph holds their collectives); True when none
        runs. A process must not end while one does: each group's abort is
        bounded by the group's timeout, so a wait of that long suffices."""
        t = self._abort_thread
        if t is not None:
            t.join(timeout_s)
        return t is None or not t.is_alive()


class StreamMesh:
    """A rank's mesh as a second stream of its sees it: the
    :class:`RankMesh` with groups of its own. A zero-drain engine's staging
    segments (and a restore's broadcasts into a staging row) take a tp and
    a dp group (``RankMesh.stage``) and run beside the ring's decode graphs:
    NCCL kernels of ONE communicator on two concurrent streams may
    interleave differently on different ranks and hang, so each stream has
    its own communicators. The cache-free forwards (embeddings and
    scoring), which run on rank 0's dp group alone, take a tp group
    (``RankMesh.fwd``, whose ``dp`` is None: nothing of a forward crosses
    dp) and, where the mesh has them, an sp group (a forward's ring passes
    or all-to-alls over its sequence blocks) and a pp group (a staged
    forward's hops); they run with the ring parked
    (``engine.forward_ranks``: a forward's all-reduce beside the ring's on
    four H100s hung both ranks, two communicators or not). Everything else
    (the layout, the slot rows, the other groups) is the ring mesh's."""

    def __init__(self, ring: RankMesh, tp: Group, dp: Group | None, **axes: Group):
        self._ring = ring
        self.tp = tp
        self.dp = dp
        for name, g in axes.items():  # sp, pp: the ring's own where not given
            setattr(self, name, g)

    def __getattr__(self, name):
        return getattr(self._ring, name)

    def __repr__(self) -> str:
        return f"StreamMesh({self.tp.name}, {self._ring!r})"


def join(mesh: Mesh, rank: int, store, staging: bool = False,
         forward: bool = False) -> RankMesh:
    """Rank ``rank``'s view of ``mesh``: its world group and its dp, tp and
    sp subgroups over prefixes of ``store`` (every rank of the mesh calls
    this with the same store); with ``staging``, a second tp and dp group
    each for the staging stream, with ``forward`` a tp group (and an sp and
    a pp group where those axes are > 1) for the forward stream
    (:class:`StreamMesh`). NCCL groups run one collective at
    once: NCCL creates its communicator lazily, which a graph capture must
    not do."""
    size = mesh.size
    world_ranks = list(range(size))

    def group(name: str, ranks: list[int]) -> Group:
        pg = new_process_group(mesh.backend, dist.PrefixStore(f"{name}/{ranks[0]}", store),
                               ranks.index(rank), len(ranks), mesh.timeout_s, mesh.hosts)
        return Group(name, pg, ranks, rank, mesh.backend)

    groups = {"world": group("world", world_ranks)}
    for axis in (AXIS_DP, AXIS_PP, AXIS_TP, AXIS_SP):
        ranks = mesh.axis_ranks(rank, axis)
        if ranks == world_ranks:
            w = groups["world"]
            groups[axis] = Group(axis, w.pg, ranks, rank, mesh.backend)
        else:
            groups[axis] = group(axis, ranks)
    stage = fwd = None
    if staging:
        stage = {axis: group(f"stage-{axis}", mesh.axis_ranks(rank, axis))
                 for axis in (AXIS_TP, AXIS_DP)}
    if forward:
        fwd = {axis: group(f"fwd-{axis}", mesh.axis_ranks(rank, axis))
               for axis in (AXIS_TP, AXIS_SP, AXIS_PP)
               if axis == AXIS_TP or mesh.shape[axis] > 1}
    if mesh.backend == "nccl":
        dev = mesh.devices[rank]
        torch.cuda.set_device(dev)
        seen = set()
        for g in [*groups.values(), *(stage or {}).values(), *(fwd or {}).values()]:
            if id(g.pg) not in seen:
                seen.add(id(g.pg))
                g.pg.allreduce([torch.zeros(1, device=dev)]).wait()
        torch.cuda.synchronize(dev)
    out = RankMesh(mesh, rank, groups)
    if stage is not None:
        out.stage = StreamMesh(out, stage[AXIS_TP], stage[AXIS_DP])
    if fwd is not None:
        out.fwd = StreamMesh(out, fwd.pop(AXIS_TP), None, **fwd)
    return out
