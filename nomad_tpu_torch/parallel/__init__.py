"""The (evals, nodes) mesh and the sharded programs on it: the
counterpart of `nomad_tpu/parallel/` (`mesh.py`, `multichip.py`).

`mesh.py` holds `NodeMesh` with its two backends (`VirtualMesh`, E x D
shards in one process on one device; `DistMesh`, one shard per rank of
a `torch.distributed` group), `sharded_chained_plan` (kernel K12),
`sharded_score_and_select` (K11 a shard, then K6) and
`sharded_batch_plan` (K10 an eval row), and the multi-process world
(`dist_config`, `distributed_init`, `host_count`, `mesh_put`).  The JAX
package's
`node_sharding` and `eval_sharding` are `NamedSharding`s, which have no
counterpart here: a mesh places its inputs itself (`NodeMesh.shard`).
The node-sharded storm solve on a mesh (K14) is `ops/solve.py
storm_assignment_sharded`.
`multichip.py` is the sweep behind the bench's ``multichip`` block and
its ``multihost`` row; `pod.py` the pod head's operation stream and its
peer; `dist_smoke.py` the multi-process world's smoke.
"""
from .mesh import (
    DistConfig,
    DistMesh,
    NodeMesh,
    Sharded,
    VirtualMesh,
    dist_config,
    distributed_init,
    host_count,
    is_multihost,
    local_device_count,
    local_device_positions,
    make_mesh,
    mesh_axes,
    mesh_put,
    sharded_batch_plan,
    sharded_chained_plan,
    sharded_chained_plan_twin,
    sharded_score_and_select,
)

__all__ = [
    "DistConfig",
    "DistMesh",
    "NodeMesh",
    "Sharded",
    "VirtualMesh",
    "dist_config",
    "distributed_init",
    "host_count",
    "is_multihost",
    "local_device_count",
    "local_device_positions",
    "make_mesh",
    "mesh_axes",
    "mesh_put",
    "sharded_batch_plan",
    "sharded_chained_plan",
    "sharded_chained_plan_twin",
    "sharded_score_and_select",
]
