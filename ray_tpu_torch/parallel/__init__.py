"""Parallelism of the port: meshes (``DeviceMesh``), logical-axis sharding
rules (DTensor placements), the in-mesh collectives and ``shard_call``
(``local_map``, the counterpart of ``shard_map``), threaded ranks for
running a mesh in one process, and the pipeline schedules over pp
(``parallel.pipeline``: GPipe; ``parallel.pipeline_1f1b``: 1F1B).  Ring
attention is ``ops.ring_attention``.  The single-host gang
(``TpuGang``, ``form_gang``) and the elastic multi-host gang
(``MultiHostGang``, ``GangMember``, in-process members) are
``parallel.gang``; a member's world is ``parallel.distributed``."""

from ray_tpu_torch.parallel import collectives
from ray_tpu_torch.parallel.gang import (GangConfig, GangMember,
                                         GangMemberDied, MemberKilled,
                                         MultiHostGang, TpuGang,
                                         current_member, form_gang)
from ray_tpu_torch.parallel.mesh import (AXIS_ORDER, MeshSpec, batch_sharding,
                                         create_hybrid_mesh, create_mesh,
                                         data_axes, mesh_shape, replicated)
from ray_tpu_torch.parallel.sharding import (DEFAULT_LLM_RULES, constrain,
                                             infer_param_logical_axes, place,
                                             placements_for, sharding_for,
                                             spec_for, tree_shardings)
from ray_tpu_torch.parallel.threaded import RankError, run_ranks

__all__ = [
    "AXIS_ORDER", "MeshSpec", "create_mesh", "create_hybrid_mesh",
    "mesh_shape", "data_axes", "batch_sharding", "replicated",
    "DEFAULT_LLM_RULES", "spec_for", "placements_for", "sharding_for",
    "tree_shardings", "infer_param_logical_axes", "place", "constrain",
    "collectives", "RankError", "run_ranks", "GangConfig", "TpuGang",
    "form_gang", "GangMember", "GangMemberDied", "MemberKilled",
    "MultiHostGang", "current_member",
]
