"""Mesh layout of the port's multi-rank runtime: the JAX package's
``parallel/mesh.py`` over ``torch.distributed`` ranks instead of a
``jax.sharding.Mesh``.

Axis conventions are the JAX package's:

  ``dp``  data parallel      — the KV cache's slot rows (each dp group of
                               ranks serves its own rows; training: each
                               dp group its own batch rows);
  ``pp``  pipeline parallel  — decode stages: stage s holds layers
                               [s·L/pp, (s+1)·L/pp) and their cache
                               (``parallel/pipeline.py``);
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
through host copies, and nothing switches over silently. Ranks on cards of
their own run over NCCL.

A mesh may span hosts (``parallel/distributed.hybrid_mesh``): ``hosts``
groups of consecutive ranks, one group per host, so dp — the outermost
axis — is the one that crosses them.
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
    hosts: int = 1

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
    NCCL over ranks that share a card raises, naming ``backend="gloo"``."""
    devs = _devices(devices)
    cfg = cfg or MeshConfig(tp=len(devs))
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
    if timeout_s <= 0:
        raise ValueError(f"timeout_s must be positive, got {timeout_s}")
    return Mesh(cfg, devs, backend, float(timeout_s))


def single_device_mesh(device=None, *, backend: str | None = None) -> Mesh:
    """A 1×1×1×1 mesh on one device: a one-rank group whose collectives
    the decode graphs capture like any other's."""
    return make_mesh(MeshConfig(), [resolve_device(device)], backend=backend)


def parse_disagg(raw: str) -> tuple[int, int]:
    """``"4+4"`` → ``(n_prefill, n_decode)`` (the JAX package's
    ``parse_disagg``, in its words). Strict: the knob is structural, so a
    typo fails at config time. URL query parsing decodes ``+`` to a space,
    so a bare space separator is accepted too."""
    import re

    m = re.fullmatch(r"(\d+)[+ ](\d+)", str(raw).strip())
    if not m:
        raise ValueError(
            f"invalid disagg={raw!r} (expected P+D device counts, e.g. 4+4)")
    n_p, n_d = int(m.group(1)), int(m.group(2))
    if n_p < 1 or n_d < 1:
        raise ValueError(
            f"invalid disagg={raw!r} (both device groups need >= 1 device)")
    return n_p, n_d


def group_mesh_configs(n_prefill: int, n_decode: int, *, tp: int | None = None, sp: int = 1,
                       pp: int = 1) -> tuple[MeshConfig, MeshConfig]:
    """Each group's mesh shape for ``disagg=P+D`` (the JAX package's
    ``group_mesh_configs``, its refusals in its words): ``tp`` cuts both
    groups (None: each group's whole size), ``sp`` the prefill group,
    ``pp`` stages the decode group."""
    if sp < 1 or pp < 1 or (tp is not None and tp < 1):
        raise ValueError(
            f"invalid sharding knobs tp={tp} sp={sp} pp={pp} beside "
            "disagg= (each must be >= 1)")
    tp_p = tp if tp is not None else n_prefill // sp
    tp_d = tp if tp is not None else n_decode // pp
    if tp_p < 1 or sp * tp_p != n_prefill:
        raise ValueError(
            f"prefill group of disagg={n_prefill}+{n_decode} does not "
            f"factor as sp={sp} x tp={tp_p} ({sp * max(tp_p, 0)} != "
            f"{n_prefill} devices) — pick tp/sp whose product is the "
            "prefill group size, or resize the group")
    if tp_d < 1 or pp * tp_d != n_decode:
        raise ValueError(
            f"decode group of disagg={n_prefill}+{n_decode} does not "
            f"factor as pp={pp} x tp={tp_d} ({pp * max(tp_d, 0)} != "
            f"{n_decode} devices) — pick tp/pp whose product is the "
            "decode group size, or resize the group")
    if pp > 1 and tp_d > 1:
        raise ValueError(
            f"pipeline-staged decode runs tp=1 within each stage "
            f"(pp={pp} with tp={tp_d} in the decode group): make pp the "
            "whole decode group, or drop one knob")
    return MeshConfig(sp=sp, tp=tp_p), MeshConfig(pp=pp, tp=tp_d)


def disagg_meshes(n_prefill: int, n_decode: int, devices=None, *, tp: int | None = None,
                  sp: int = 1, pp: int = 1) -> tuple[Mesh, Mesh]:
    """Two disjoint groups for disaggregated serving (the JAX package's
    ``disagg_meshes``): the first ``n_prefill`` of ``devices`` (default:
    every CUDA device; ``["cpu"] * n`` for CPU groups) become the prefill
    group's mesh, the next ``n_decode`` the decode group's, each shaped by
    :func:`group_mesh_configs`. The inter-group hop is the engine's KV
    handoff (``cache/kv_transfer.transfer``), never a collective spanning
    both."""
    devs = list(_devices(devices))
    need = n_prefill + n_decode
    if need > len(devs):
        raise ValueError(
            f"disagg={n_prefill}+{n_decode} needs {need} devices, have "
            f"{len(devs)}")
    pre_cfg, dec_cfg = group_mesh_configs(n_prefill, n_decode, tp=tp, sp=sp, pp=pp)
    return (make_mesh(pre_cfg, devs[:n_prefill]),
            make_mesh(dec_cfg, devs[n_prefill:need]))
