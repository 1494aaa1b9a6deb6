"""Data-, tensor- and sequence-parallel serving and training over
``torch.distributed``: the port's counterpart of the JAX package's
``parallel/`` (mesh, sharding rules, ring attention, Ulysses, the
multi-host helpers of ``distributed.py``), plus what GSPMD gives the JAX
package and the port must build — the collectives (``comm.py``) and the
rank runtime (``ranks.py``: spawned worker ranks, the plan channel, the
lifecycle).

``pipeline.py`` is the JAX package's pipeline: staged decode and
admission over pp stages, and the GPipe train step; ``mesh.py`` also holds
the disaggregated groups' helpers (``parse_disagg``,
``group_mesh_configs``, ``disagg_meshes``).
"""

from quorum_tpu_torch.parallel.comm import (COLLECTIVES, Group, RankMesh, collective_counts,
                                            join, tp_enter)
from quorum_tpu_torch.parallel.mesh import (AXIS_DP, AXIS_PP, AXIS_SP, AXIS_TP,
                                            DEFAULT_GROUP_TIMEOUT_S, MESH_AXES, Mesh,
                                            MeshConfig, make_mesh, single_device_mesh)
from quorum_tpu_torch.parallel.ranks import RankGroup, WorkerLost
from quorum_tpu_torch.parallel.ring_attention import ring_prefill_attention
from quorum_tpu_torch.parallel.sharding import (KV_CACHE_AXES, LOGICAL_RULES,
                                                PARAM_LOGICAL_AXES, kv_cache_spec,
                                                kv_cut_evenly, kv_select, kv_sharers, logical_to_spec,
                                                param_partition_specs, rank_experts, rank_heads,
                                                rank_kv_heads, rank_kv_index, slot_rows,
                                                stage_layers)
from quorum_tpu_torch.parallel.ulysses import ulysses_prefill_attention, ulysses_supported

__all__ = [
    "AXIS_DP", "AXIS_PP", "AXIS_SP", "AXIS_TP", "COLLECTIVES", "DEFAULT_GROUP_TIMEOUT_S",
    "Group", "KV_CACHE_AXES", "LOGICAL_RULES", "MESH_AXES", "Mesh", "MeshConfig",
    "PARAM_LOGICAL_AXES", "RankGroup", "RankMesh", "WorkerLost", "collective_counts",
    "join", "kv_cache_spec", "kv_cut_evenly", "kv_select", "kv_sharers", "logical_to_spec", "make_mesh",
    "param_partition_specs", "rank_experts", "rank_heads", "rank_kv_heads", "rank_kv_index",
    "ring_prefill_attention", "single_device_mesh", "slot_rows", "stage_layers", "tp_enter", "ulysses_prefill_attention", "ulysses_supported",
]
