"""Collectives of the port's multi-rank runtime, over ``torch.distributed``
process groups: what GSPMD inserts for the JAX package (its
``parallel/sharding.py`` lets XLA place the all-reduces; its ring and
Ulysses run ``ppermute`` and ``all_to_all`` inside ``shard_map``).

A :class:`Group` is one rank's view of one axis subgroup (the mesh's tp
ranks, its sp ranks, or all of them): all-reduce (sum), all-gather along a
dimension, broadcast, all-to-all and the ring's pass to the next rank. A
:class:`RankMesh` is the mesh as one rank sees it: the layout
(``parallel/mesh.Mesh``), the rank, its coordinates and its ``world``,
``tp`` and ``sp`` groups. :func:`join` builds one from a rendezvous store.

The groups are the c10d backends themselves (``ProcessGroupNCCL`` or
``ProcessGroupGloo``), made per mesh from a prefix of the mesh's own store,
never the process's default group: one serving process may hold several
meshes' rank 0. Every group has the mesh's timeout.

NCCL works on device tensors and its collectives record into CUDA graphs:
the engine's decode graphs capture them. Gloo works on host tensors, so a
CUDA tensor is staged through a host copy around each collective (a sum
widens 16-bit floats to float32, exactly; a move keeps their bits) — a host round trip no graph can capture,
so an engine over gloo on CUDA decodes eagerly. Each call counts one
collective of its kind (:data:`COLLECTIVES`), counted as captured inside a
capture and added per replay (``ops/launches.py``), as the kernels' launches
are.
"""

from __future__ import annotations

import datetime
import logging

import torch
import torch.distributed as dist

from quorum_tpu_torch.ops import launches
from quorum_tpu_torch.parallel.mesh import AXIS_SP, AXIS_TP, Mesh

logger = logging.getLogger(__name__)


class _Counter:
    """A collective kind's call count, in the launch counters' form."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0

    def __repr__(self) -> str:
        return f"<collective {self.name}>"


COLLECTIVES = {name: _Counter(name) for name in
               ("all_reduce", "all_gather", "broadcast", "all_to_all", "ring_pass")}


def collective_counts() -> dict[str, int]:
    """Collectives this process issued (replays adding what they captured)."""
    return {name: c.launches for name, c in COLLECTIVES.items()}


def _timeout(seconds: float) -> datetime.timedelta:
    return datetime.timedelta(seconds=seconds)


def new_process_group(backend: str, store, rank: int, size: int, timeout_s: float):
    """A c10d backend over ``store`` (a prefix of the mesh's store)."""
    if backend == "gloo":
        opts = dist.ProcessGroupGloo._Options()
        opts._timeout = _timeout(timeout_s)
        # Loopback: the ranks of a mesh share one host.
        opts._devices = [dist.ProcessGroupGloo.create_device(hostname="127.0.0.1")]
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

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the group, in place; returns ``x``."""
        launches.count(COLLECTIVES["all_reduce"])
        h = self._stage(x, reduce=True)
        self.pg.allreduce([h]).wait()
        if h is not x:
            x.copy_(h)
        return x

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim``, in group order."""
        launches.count(COLLECTIVES["all_gather"])
        h = self._stage(x)
        out = torch.empty((self.size * h.numel(),), dtype=h.dtype, device=h.device)
        self.pg._allgather_base(out, h.reshape(-1)).wait()
        out = self._back(out.view(self.size, *h.shape), x)
        return torch.cat(out.unbind(0), dim=dim)

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Group rank ``src``'s ``x`` into every rank's ``x``, in place."""
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


class RankMesh:
    """The mesh as rank ``rank`` sees it: the layout, this rank's
    coordinates and device, and its ``world``, ``tp`` and ``sp`` groups
    (a subgroup with the world's ranks shares the world's backend)."""

    def __init__(self, mesh: Mesh, rank: int, groups: dict[str, Group]):
        self.mesh = mesh
        self.rank = rank
        self.coords = mesh.coords(rank)
        self.device = mesh.devices[rank]
        self.world = groups["world"]
        self.tp = groups[AXIS_TP]
        self.sp = groups[AXIS_SP]

    def __repr__(self) -> str:
        return f"RankMesh(rank={self.rank}/{self.size}, {self.coords}, {self.mesh.backend})"

    @property
    def size(self) -> int:
        return self.mesh.size

    @property
    def backend(self) -> str:
        return self.mesh.backend

    @property
    def tp_rank(self) -> int:
        return self.coords[AXIS_TP]

    @property
    def tp_size(self) -> int:
        return self.mesh.shape[AXIS_TP]

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

    def shutdown(self) -> None:
        """Release the groups' resources, each rank on its own."""
        seen = set()
        for g in (self.world, self.tp, self.sp):
            if id(g.pg) in seen:
                continue
            seen.add(id(g.pg))
            try:
                g.pg.shutdown()
            except Exception:
                logger.warning("rank %d: releasing group %s failed", self.rank, g.name,
                               exc_info=True)


def join(mesh: Mesh, rank: int, store) -> RankMesh:
    """Rank ``rank``'s view of ``mesh``: its world group and its tp and sp
    subgroups over prefixes of ``store`` (every rank of the mesh calls this
    with the same store). NCCL groups run one collective at once: NCCL
    creates its communicator lazily, which a graph capture must not do."""
    size = mesh.size
    world_ranks = list(range(size))

    def group(name: str, ranks: list[int]) -> Group:
        pg = new_process_group(mesh.backend, dist.PrefixStore(f"{name}/{ranks[0]}", store),
                               ranks.index(rank), len(ranks), mesh.timeout_s)
        return Group(name, pg, ranks, rank, mesh.backend)

    groups = {"world": group("world", world_ranks)}
    for axis in (AXIS_TP, AXIS_SP):
        ranks = mesh.axis_ranks(rank, axis)
        if ranks == world_ranks:
            w = groups["world"]
            groups[axis] = Group(axis, w.pg, ranks, rank, mesh.backend)
        else:
            groups[axis] = group(axis, ranks)
    if mesh.backend == "nccl":
        dev = mesh.devices[rank]
        torch.cuda.set_device(dev)
        seen = set()
        for g in groups.values():
            if id(g.pg) not in seen:
                seen.add(id(g.pg))
                g.pg.allreduce([torch.zeros(1, device=dev)]).wait()
        torch.cuda.synchronize(dev)
    return RankMesh(mesh, rank, groups)
