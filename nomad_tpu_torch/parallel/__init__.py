"""The node mesh and the node-sharded programs on it: the counterpart of
`nomad_tpu/parallel/` (`mesh.py`, `multichip.py`).

`mesh.py` holds `NodeMesh` with its two backends (`VirtualMesh`, D
shards in one process on one device; `DistMesh`, one shard per rank of
a `torch.distributed` group) and `sharded_chained_plan`, kernel K12.
The node-sharded storm solve on a mesh (K14) is `ops/solve.py
storm_assignment_sharded`.
`multichip.py` is the sweep behind the bench's ``multichip`` block.
"""
from .mesh import (
    DistMesh,
    NodeMesh,
    Sharded,
    VirtualMesh,
    make_mesh,
    mesh_axes,
    sharded_chained_plan,
    sharded_chained_plan_twin,
)

__all__ = [
    "DistMesh",
    "NodeMesh",
    "Sharded",
    "VirtualMesh",
    "make_mesh",
    "mesh_axes",
    "sharded_chained_plan",
    "sharded_chained_plan_twin",
]
