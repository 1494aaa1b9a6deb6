"""Tensor- and sequence-parallel serving over ``torch.distributed``: the
port's counterpart of the JAX package's ``parallel/`` (mesh, sharding rules,
ring attention, Ulysses), plus what GSPMD gives the JAX package and the port
must build — the collectives (``comm.py``) and the rank runtime
(``ranks.py``: spawned worker ranks, the plan channel, the lifecycle).

The JAX package's ``distributed.py`` (dp and the training mesh),
``pipeline.py`` (pp) and the disagg helpers of ``mesh.py`` are not ported
yet (ROADMAP queue 1).
"""

from quorum_tpu_torch.parallel.comm import (COLLECTIVES, Group, RankMesh, collective_counts,
                                            join)
from quorum_tpu_torch.parallel.mesh import (AXIS_DP, AXIS_PP, AXIS_SP, AXIS_TP,
                                            DEFAULT_GROUP_TIMEOUT_S, MESH_AXES, Mesh,
                                            MeshConfig, make_mesh, single_device_mesh)
from quorum_tpu_torch.parallel.ranks import RankGroup, WorkerLost
from quorum_tpu_torch.parallel.ring_attention import ring_prefill_attention
from quorum_tpu_torch.parallel.sharding import (KV_CACHE_AXES, LOGICAL_RULES,
                                                PARAM_LOGICAL_AXES, logical_to_spec,
                                                param_partition_specs, rank_heads,
                                                rank_kv_heads)
from quorum_tpu_torch.parallel.ulysses import ulysses_prefill_attention, ulysses_supported

__all__ = [
    "AXIS_DP", "AXIS_PP", "AXIS_SP", "AXIS_TP", "COLLECTIVES", "DEFAULT_GROUP_TIMEOUT_S",
    "Group", "KV_CACHE_AXES", "LOGICAL_RULES", "MESH_AXES", "Mesh", "MeshConfig",
    "PARAM_LOGICAL_AXES", "RankGroup", "RankMesh", "WorkerLost", "collective_counts",
    "join", "logical_to_spec", "make_mesh", "param_partition_specs", "rank_heads",
    "rank_kv_heads", "ring_prefill_attention", "single_device_mesh",
    "ulysses_prefill_attention", "ulysses_supported",
]
