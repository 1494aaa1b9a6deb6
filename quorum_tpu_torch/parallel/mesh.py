"""Mesh layout of the port's multi-rank runtime: the JAX package's
``parallel/mesh.py`` over ``torch.distributed`` ranks instead of a
``jax.sharding.Mesh``.

Axis conventions are the JAX package's:

  ``dp``  data parallel      — refused for now (the next slice);
  ``pp``  pipeline parallel  — refused for now;
  ``sp``  sequence parallel  — prompt blocks for ring attention or Ulysses;
  ``tp``  tensor parallel    — attention heads, MLP hidden, vocab shards.

One rank is one process on one device. Ranks are laid out ``(dp, pp, sp,
tp)`` with tp innermost, as the JAX package lays out devices: rank
``((dp_i·pp + pp_i)·sp + sp_i)·tp + tp_i``. A :class:`Mesh` is the layout
alone (its configuration, a device per rank, the collective backend and the
groups' timeout); the ranks join it through ``parallel/ranks.py`` and each
sees it as a ``parallel/comm.RankMesh``, which holds the axis subgroups.

The backend is NCCL for CUDA devices and gloo for the CPU. NCCL refuses two
ranks of one communicator on one card, so a mesh whose ranks share a card
must ask for ``backend="gloo"`` itself: gloo then stages every collective
through host copies, and nothing switches over silently. An NCCL mesh is
one rank for now: several NCCL ranks on cards of their own hung an engine
(ROADMAP queue 3), so :func:`make_mesh` refuses them, naming gloo.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from quorum_tpu_torch import resolve_device

AXIS_DP = "dp"
AXIS_PP = "pp"
AXIS_SP = "sp"
AXIS_TP = "tp"
MESH_AXES = (AXIS_DP, AXIS_PP, AXIS_SP, AXIS_TP)

# Seconds a collective (or a rank's rendezvous) may wait for its peers
# before it fails: a dead or wedged rank fails the engine, never hangs it.
DEFAULT_GROUP_TIMEOUT_S = 60.0


@dataclass(frozen=True)
class MeshConfig:
    """Requested mesh shape. Any axis left at 1 is effectively disabled."""

    dp: int = 1
    sp: int = 1
    tp: int = 1
    pp: int = 1

    @property
    def n_devices(self) -> int:
        return self.dp * self.pp * self.sp * self.tp


@dataclass(frozen=True)
class Mesh:
    """A ``(dp, pp, sp, tp)`` layout of ranks: ``devices[r]`` is rank r's
    device, ``backend`` the collectives' (``"nccl"`` or ``"gloo"``),
    ``timeout_s`` every group's timeout."""

    cfg: MeshConfig
    devices: tuple
    backend: str
    timeout_s: float = DEFAULT_GROUP_TIMEOUT_S

    @property
    def shape(self) -> dict[str, int]:
        c = self.cfg
        return {AXIS_DP: c.dp, AXIS_PP: c.pp, AXIS_SP: c.sp, AXIS_TP: c.tp}

    @property
    def size(self) -> int:
        return self.cfg.n_devices

    def coords(self, rank: int) -> dict[str, int]:
        """Rank → its index on each axis (tp innermost)."""
        out, rest = {}, rank
        for axis in reversed(MESH_AXES):
            n = self.shape[axis]
            out[axis] = rest % n
            rest //= n
        return {a: out[a] for a in MESH_AXES}

    def rank_of(self, coords: dict[str, int]) -> int:
        rank = 0
        for axis in MESH_AXES:
            rank = rank * self.shape[axis] + coords[axis]
        return rank

    def axis_ranks(self, rank: int, axis: str) -> list[int]:
        """The ranks of ``rank``'s subgroup along ``axis`` (the ranks that
        differ from it on that axis alone), in axis order."""
        c = self.coords(rank)
        return [self.rank_of({**c, axis: i}) for i in range(self.shape[axis])]


def _devices(devices) -> tuple:
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass devices=['cpu', ...] explicitly to "
                "run the ranks on the CPU")
        return tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
    out = [torch.device(d) for d in devices]
    if any(d.type == "cuda" for d in out):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        out = [torch.device("cuda", 0) if d.type == "cuda" and d.index is None else d
               for d in out]
        need = max(d.index for d in out if d.type == "cuda") + 1
        if need > have:
            raise RuntimeError(
                f"the mesh's devices {[str(d) for d in out]} need {need} CUDA devices, "
                f"this machine has {have}")
    return tuple(out)


def make_mesh(cfg: MeshConfig | None = None, devices=None, *, backend: str | None = None,
              timeout_s: float = DEFAULT_GROUP_TIMEOUT_S) -> Mesh:
    """Lay a ``(dp, pp, sp, tp)`` mesh over ``devices`` (default: every CUDA
    device; ``["cpu"] * n`` for CPU ranks), one rank per device entry, in
    order. ``backend`` defaults to NCCL on CUDA devices and gloo on the CPU;
    NCCL over ranks that share a card, or over more than one rank, raises,
    naming ``backend="gloo"``."""
    devs = _devices(devices)
    cfg = cfg or MeshConfig(tp=len(devs))
    if cfg.dp > 1 or cfg.pp > 1:
        axis = "dp" if cfg.dp > 1 else "pp"
        raise ValueError(
            f"{axis}={getattr(cfg, axis)} is not served on cuda:// meshes yet (tp and sp "
            "are; the tpu:// backend serves dp and pp)")
    if min(cfg.dp, cfg.pp, cfg.sp, cfg.tp) < 1:
        raise ValueError(f"invalid mesh {cfg} (every axis must be >= 1)")
    if cfg.n_devices > len(devs):
        raise ValueError(f"mesh {cfg} needs {cfg.n_devices} devices, have {len(devs)}")
    devs = devs[:cfg.n_devices]
    types = {d.type for d in devs}
    if len(types) > 1 or not types <= {"cpu", "cuda"}:
        raise ValueError(f"a mesh's ranks run on CUDA devices or on the CPU, got {devs}")
    kind = types.pop()
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown collective backend {backend!r} (nccl or gloo)")
    if backend == "nccl":
        if kind != "cuda":
            raise ValueError("backend='nccl' needs CUDA devices; CPU ranks run over gloo")
        if len(set(devs)) < len(devs):
            raise ValueError(
                f"NCCL refuses two ranks of one communicator on one card (devices "
                f"{[str(d) for d in devs]}): pass backend=\"gloo\" to share a card "
                "(host-staged collectives, eager decode)")
        if len(devs) > 1:
            raise ValueError(
                f"NCCL meshes of several ranks are not served yet (devices "
                f"{[str(d) for d in devs]}): an engine over NCCL ranks on cards of their "
                "own hangs (ROADMAP queue 3, an open fault). A one-rank NCCL mesh is "
                "served; pass backend=\"gloo\" for several ranks (host-staged "
                "collectives, eager decode)")
    if timeout_s <= 0:
        raise ValueError(f"timeout_s must be positive, got {timeout_s}")
    return Mesh(cfg, devs, backend, float(timeout_s))


def single_device_mesh(device=None, *, backend: str | None = None) -> Mesh:
    """A 1×1×1×1 mesh on one device: a one-rank group whose collectives
    the decode graphs capture like any other's."""
    return make_mesh(MeshConfig(), [resolve_device(device)], backend=backend)
