"""Multi-process and multi-host runs: the port of the JAX package's
``parallel/distributed.py``.

The JAX package joins hosts with ``jax.distributed.initialize`` (its
``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``)
and lays a hybrid ICI/DCN mesh over every device of every host. A port
rank is one process on one device, so the port reads torchrun's standard
variables instead — ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE`` — and a host is a group of
``LOCAL_WORLD_SIZE`` consecutive ranks:

- :func:`initialize` opens the run's rendezvous store at
  ``MASTER_ADDR:MASTER_PORT`` (hosted by rank 0, or by torchrun's agent)
  and records this process's place; it is a no-op returning False for a
  single process;
- :func:`hybrid_mesh` lays a ``(dp, pp, sp, tp)`` mesh whose dp axis spans
  the hosts: ``cfg`` is one host's shape and ``dcn_dp`` multiplies dp
  across hosts. Ranks are laid out with tp innermost, so every tp, sp and pp
  neighbour stays on a host and only dp's once-a-step gradient all-reduce
  crosses between hosts. With one host it is ``make_mesh(cfg)``;
- :func:`join_mesh` joins this process to such a mesh (its
  ``parallel/comm.RankMesh``);
- :func:`local_data_shard` is this host's slice of a dp-sharded global
  batch, and :func:`assemble_global_batch` cuts a rank's dp rows out of its
  host's rows: every tp rank of a host feeds that host's rows.

Launch: ``torchrun --nnodes=H --nproc-per-node=N --rdzv-endpoint=ADDR:PORT
script.py`` on each host (or the variables set by hand), where the script
calls ``initialize()``, ``hybrid_mesh(MeshConfig(tp=…), dcn_dp=H)`` and
``join_mesh``, then ``training.trainer.train_init(spec, mesh=…)`` and
``make_train_step(spec, mesh=…)``. Across hosts gloo binds the interface
``GLOO_SOCKET_IFNAME`` names (the default interface otherwise).
"""

from __future__ import annotations

import datetime
import logging
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from quorum_tpu_torch.parallel.mesh import (DEFAULT_GROUP_TIMEOUT_S, Mesh, MeshConfig,
                                            make_mesh)

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class Runtime:
    """This process's place in a multi-process run, and the run's store."""

    rank: int
    world_size: int
    local_rank: int
    local_world_size: int
    store: object

    @property
    def hosts(self) -> int:
        return self.world_size // self.local_world_size

    @property
    def host(self) -> int:
        return self.rank // self.local_world_size


_RUNTIME: Runtime | None = None


def initialize(timeout_s: float = DEFAULT_GROUP_TIMEOUT_S) -> bool:
    """Join the multi-process run torchrun's variables describe; returns
    True when there is one (``WORLD_SIZE`` > 1). A single process (no
    variables, or a world of one) is a no-op returning False: the same
    program serves one device and many hosts."""
    global _RUNTIME
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    if _RUNTIME is not None:
        return True
    rank = int(os.environ["RANK"])
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    if world % local_world:
        raise ValueError(f"WORLD_SIZE={world} is not a whole number of hosts of "
                         f"LOCAL_WORLD_SIZE={local_world} ranks")
    addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
    port = int(os.environ["MASTER_PORT"])
    # Under torchrun the elastic agent already hosts the store there: every
    # rank joins it as a client.
    agent = os.environ.get("TORCHELASTIC_USE_AGENT_STORE") == "True"
    store = dist.TCPStore(addr, port, world, rank == 0 and not agent,
                          timeout=datetime.timedelta(seconds=timeout_s),
                          wait_for_workers=False)
    _RUNTIME = Runtime(rank, world, int(os.environ.get("LOCAL_RANK", str(rank % local_world))),
                       local_world, store)
    logger.info("joined the run: rank %d/%d, host %d/%d", rank, world, _RUNTIME.host,
                _RUNTIME.hosts)
    return True


def runtime() -> Runtime | None:
    """The run :func:`initialize` joined (None for a single process)."""
    return _RUNTIME


def process_count() -> int:
    """Hosts in the run (1 for a single process)."""
    return 1 if _RUNTIME is None else _RUNTIME.hosts


def process_index() -> int:
    """This process's host (0 for a single process)."""
    return 0 if _RUNTIME is None else _RUNTIME.host


def hybrid_mesh(cfg: MeshConfig, *, dcn_dp: int = 1, devices=None, backend: str | None = None,
                timeout_s: float = DEFAULT_GROUP_TIMEOUT_S) -> Mesh:
    """A ``(dcn_dp · cfg.dp, cfg.pp, cfg.sp, cfg.tp)`` mesh: ``cfg`` is one
    host's shape, over ``devices`` (one host's, one per local rank; default
    every CUDA device), and dp spans ``dcn_dp`` hosts. With one host this is
    ``make_mesh(cfg, devices)``. Across hosts the run must be initialized
    (:func:`initialize`) with ``LOCAL_WORLD_SIZE`` ranks of ``cfg`` on each
    host."""
    if dcn_dp <= 1:
        return make_mesh(cfg, devices, backend=backend, timeout_s=timeout_s)
    rt = _RUNTIME
    if rt is None:
        raise RuntimeError("hybrid_mesh(dcn_dp > 1) spans hosts: call initialize() in a "
                           "multi-process run first")
    if rt.hosts != dcn_dp or rt.local_world_size != cfg.n_devices:
        raise ValueError(
            f"dcn_dp={dcn_dp} hosts of {cfg.n_devices} ranks ({cfg}) do not match the run: "
            f"{rt.hosts} hosts of LOCAL_WORLD_SIZE={rt.local_world_size} ranks")
    host = make_mesh(cfg, devices, backend=backend, timeout_s=timeout_s)
    wide = MeshConfig(dp=dcn_dp * cfg.dp, sp=cfg.sp, tp=cfg.tp, pp=cfg.pp)
    return Mesh(wide, host.devices * dcn_dp, host.backend, host.timeout_s, hosts=dcn_dp)


def join_mesh(mesh: Mesh):
    """This process's ``parallel/comm.RankMesh`` of ``mesh`` in an
    initialized run (every process of the run calls it), over a prefix of
    the run's store."""
    from quorum_tpu_torch.parallel.comm import join

    rt = _RUNTIME
    if rt is None or rt.world_size != mesh.size:
        raise RuntimeError(f"join_mesh needs an initialized run of {mesh.size} processes "
                           f"(have {1 if rt is None else rt.world_size})")
    dev = mesh.devices[rt.rank]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return join(mesh, rt.rank, dist.PrefixStore("mesh", rt.store))


def local_data_shard(global_batch: int) -> tuple[int, int]:
    """``(start, size)`` of this host's rows of a dp-sharded global batch:
    each host feeds only its own rows."""
    n, i = process_count(), process_index()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} must divide over {n} processes")
    per = global_batch // n
    return i * per, per


def assemble_global_batch(local_tokens, mesh, global_batch: int) -> torch.Tensor:
    """This rank's dp rows of the global ``[global_batch, T]`` batch, as a
    long tensor on its device, from ``local_tokens``: its host's rows
    (:func:`local_data_shard`; the whole batch for one process). ``mesh``
    is the rank's ``RankMesh``; the dp rows of a rank lie within its host's
    rows (dp spans hosts outermost)."""
    dp, d = mesh.dp_size, mesh.dp_rank
    if global_batch % dp:
        raise ValueError(f"global batch {global_batch} must divide over dp={dp}")
    per = global_batch // dp
    start, size = local_data_shard(global_batch)
    lo, hi = d * per - start, (d + 1) * per - start
    if lo < 0 or hi > size:
        raise ValueError(f"rank {mesh.rank}'s dp rows [{d * per}, {(d + 1) * per}) are not "
                         f"among its host's rows [{start}, {start + size})")
    rows = np.asarray(local_tokens)[lo:hi] if not isinstance(local_tokens, torch.Tensor) \
        else local_tokens[lo:hi]
    return torch.as_tensor(rows).to(device=mesh.device, dtype=torch.long)
