"""The (evals, nodes) mesh and the sharded programs on it: the node-sharded
chained planner (kernel K12), the node-sharded select (K11 a shard, then
K6) and the (evals, nodes)-sharded batch planner (K10 an eval shard).

The JAX package shards the cluster's node arena over an (evals, nodes)
device mesh (`nomad_tpu/parallel/mesh.py`): every O(nodes) quantity of a
pick (fit, fitness, anti-affinity, penalties, the usage scatter) is
computed on the device's own shard, and only the per-node score and
feasibility vectors plus O(devices) walk carries cross the mesh.  The
eval axis is data parallelism over independent evaluations: a program
that shards only over ``nodes`` runs replicated over it.

* `NodeMesh` holds E eval rows of D node shards; shard s of a C-row
  arena (C % D == 0) owns rows ``[s * C // D, (s + 1) * C // D)``.  Its
  node-axis collectives are the ones the sharded planners use: the tiled
  `all_gather`, `psum`, `pmax`, `pmin` and the `gather` of one record per
  shard; `gather_evals` stacks one record per eval row.  Every
  collective takes this process's tensors in `local_shards` (or
  `local_evals`) order and returns the replicated result.
* `VirtualMesh(D, device, n_evals=E)`: all E x D shards in one process
  on one device, the counterpart of the JAX tests' 8-device virtual CPU
  mesh.  Each collective is the exact in-process reduction, in ascending
  shard order.  A program that shards only over ``nodes`` computes the
  same on every eval row, so it runs the node axis once.
* `DistMesh(group, n_evals=E, shards_per_rank=L)`: L node shards per
  rank of a `torch.distributed` group of E x D / L ranks (gloo, whose
  collectives take CPU and CUDA tensors; or NCCL on the card).  With R =
  D / L ranks an eval row, rank r is eval row ``r // R`` and holds node
  shards ``(r % R) * L`` to ``(r % R) * L + L - 1``, the row-major
  ``reshape(evals, nodes)`` of the JAX mesh over its processes' devices;
  the node-axis collectives run over the subgroup of the rank's eval row
  (each rank sends its L records, the result stays in ascending shard
  order), `gather_evals` over that of its node column.  L is the JAX
  package's devices per process: its launcher's
  ``--xla_force_host_platform_device_count``.  NCCL puts no two ranks on
  one device; gloo does, so two processes can share one card.  The
  device resolves as every entry point's does (`resolve_device`): the
  card unless the caller asks for ``"cpu"``, whatever the backend.

`make_mesh` is the JAX `make_mesh` (`mesh.py:234`) without its CPU
fallback: the `DistMesh` of the process group with the axes the JAX one
resolves (`mesh_axes`: two eval rows when the count is even and at
least 4), and a mesh that cannot be built raises.  E x D shards in one
process are a `VirtualMesh`.

The multi-process world (JAX `mesh.py:56-232`): `dist_config` reads the
``NOMAD_TPU_DIST*`` knobs (``NOMAD_TPU_DIST=1``, ``_COORD`` host:port,
``_PROCS``, ``_ID``, namespaced by ``NOMAD_TPU_DIST_NS``) and raises on a
malformed one; `distributed_init` joins the gloo world they describe
(``tcp://`` at the coordinator), once, and never falls back to one
process.  ``NOMAD_TPU_SHARDS_PER_RANK`` (`shards_per_rank`) is L.
`host_count`, `is_multihost`, `local_device_positions` and
`local_device_count` describe a mesh's processes; `mesh_put` places a
host column as this process's shards, cutting its own rows on the host
and uploading only those, so no process ships another's slice.

`sharded_score_and_select` (JAX `mesh.py:278`) is one select on a node
mesh: K11 (`csrc/score_all.cu`) scores each shard's contiguous columns,
the mesh all-gathers the [C] scores and feasibility, and K6
(`csrc/walk_only.cu`) walks them, as the JAX program runs
`_limited_walk_argmax` replicated.  `sharded_batch_plan` (JAX
`mesh.py:793`) shards the eval batch over ``evals`` and every node
column over ``nodes``: each eval row all-gathers its columns over the
node axis and runs K10 (`csrc/batch_plan.cu`) over its own evals; the
rows are gathered over the eval axis, so every process gets all [E, P].

`sharded_chained_plan` (JAX `mesh.py:484`, its walk `_sharded_walk`
`:329`) is K12 (`csrc/sharded_chain.cu`).  One pick runs as stages per
shard, with the mesh's exchanges between them, where the JAX program's
collectives fall.  On a `DistMesh` (exchanges across processes) each
stage is a launch and each exchange a collective; on a `VirtualMesh`
the whole chain is one cooperative launch whose grid barriers take the
exchanges' place (the stages write straight into the gathered buffers):

  score     the pick's eviction (owner only), then every node of the
            shard scored and its feasibility; all_gather of both [C]
            vectors;
  walk_bad  the shard's slice of the eval's permutation: the "bad"
            count (feasible, score <= 0) and its value at the offset;
            gather;
  walk_nd   the first MAX_SKIP bad positions in walk order diverted;
            the non-diverted and diverted counts; gather;
  walk_fin  the emit order, the shard's best (score, emit order) and
            the walk position of the limit-th non-diverted node;
            gather;
  commit    the global winner (pmax of the score, pmin of the order,
            pmin of the position), the owner-only scatter of its ask,
            and its value-slot one-hot (psum);

then one `advance` per process moves the replicated state (offset,
dead flag, rows, pulls, spread carries).  Each eval starts with
`begin` (per process) and `prologue` (per shard: the eval's collision
column, its pre-deltas, and the one-hots of its evictions' value slots,
psum-reduced).  Every exchange is exact (gathers, int32 prefix sums,
f64 max and min, a psum of 0/1 one-hots), so the result depends on
neither the backend nor the order of the shards.

The usage carry follows the sharded program's order, not K3's: the
pick's eviction is added before it scores and its ask after the walk,
each into the carry as it happens.  Like `local_scatter`, an add whose
row is off the shard (or not applied) adds +0.0 at the clipped row, so
the carry is bit-equal to the JAX program's.  `return_carry` hands the
usage columns back as `Sharded` shard tensors; fed into the next
launch's ``used0_*`` the chain is bit-equal to one longer launch.

Scope, as the JAX program's: one task group, no ports or devices.  The
plain-torch twin (`sharded_chained_plan_twin`) runs the same stages on
the same mesh; K12 runs when the mesh is on the card, the twin when it
is on the CPU, and nothing falls back from one to the other.
"""
from __future__ import annotations

import math
import os
from datetime import timedelta
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device.core import DeviceFault, DeviceLike, resolve_device
from ..ops.batch import spread_contribution
from ..ops.score import INT32_MAX, INV_18, MAX_SKIP, NO_NODE, SKIP_THRESHOLD, _pow10, fma


class Sharded(NamedTuple):
    """A node-axis column split over a mesh: ``shards[i]`` is this
    process's shard ``mesh.local_shards[i]``, contiguous, C // D rows."""

    shards: Tuple[torch.Tensor, ...]


class NodeMesh:
    """E eval rows of D node shards; see the module docstring."""

    n_shards: int
    local_shards: Tuple[int, ...]
    n_evals: int = 1
    local_evals: Tuple[int, ...] = (0,)
    device: torch.device

    def shard_size(self, C: int) -> int:
        if C % self.n_shards != 0:
            raise ValueError(
                f"an arena of {C} rows does not split into {self.n_shards} "
                "equal shards (C % D != 0)")
        return C // self.n_shards

    def lo(self, shard: int, C: int) -> int:
        return shard * self.shard_size(C)

    # -- the collectives: `locals_` are this process's shard tensors ----

    def gather(self, locals_: Sequence[torch.Tensor],
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Stack one record per shard: [D, *record]."""
        raise NotImplementedError

    def all_gather(self, locals_: Sequence[torch.Tensor],
                   out: Optional[torch.Tensor] = None,
                   axis: int = 0) -> torch.Tensor:
        """The tiled all-gather over the node axis: the shards' slices
        concatenated along `axis` ([C // D] into [C]; [E, C // D] into
        [E, C] along axis 1)."""
        g = self.gather(locals_)
        if axis == 0:
            flat = g.reshape((-1,) + tuple(g.shape[2:]))
        else:
            flat = torch.cat(list(g.unbind(0)), dim=axis)
        if out is None:
            return flat
        return out.copy_(flat)

    def gather_evals(self, locals_: Sequence[torch.Tensor]) -> torch.Tensor:
        """Stack one record per eval row: [E, *record], from this
        process's records in `local_evals` order."""
        raise NotImplementedError

    def eval_rows(self, n: int) -> int:
        """The evals each eval row holds of a batch of `n`."""
        if n % self.n_evals != 0:
            raise ValueError(
                f"a batch of {n} evals does not split into {self.n_evals} "
                "equal eval rows (E % evals != 0)")
        return n // self.n_evals

    def psum(self, locals_, out=None) -> torch.Tensor:
        """Sum over the shards, added in ascending shard order."""
        g = self.gather(locals_)
        acc = g[0].clone() if out is None else out.copy_(g[0])
        for d in range(1, g.shape[0]):
            acc.add_(g[d])
        return acc

    def pmax(self, locals_, out=None) -> torch.Tensor:
        r = self.gather(locals_).amax(dim=0)
        return r if out is None else out.copy_(r)

    def pmin(self, locals_, out=None) -> torch.Tensor:
        r = self.gather(locals_).amin(dim=0)
        return r if out is None else out.copy_(r)

    # -- placement of node-axis columns ---------------------------------

    def shard(self, x, dtype: Optional[torch.dtype] = None,
              axis: int = 0) -> Sharded:
        """This process's shards of `x` (numpy, tensor or `Sharded` of
        this mesh, which passes through unchanged) along its node axis
        `axis` ([C] columns: 0; [E, C] rows: 1), each contiguous."""
        if isinstance(x, Sharded):
            if len(x.shards) != len(self.local_shards):
                raise ValueError("a Sharded column of another mesh")
            return x
        t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                            else x)
        size = self.shard_size(t.shape[axis])
        # this process's shards are contiguous: cut them where the column
        # lies, then move only those rows
        first, n = self.local_shards[0], len(self.local_shards)
        t = t.narrow(axis, first * size, n * size)
        if dtype is not None:
            t = t.to(dtype)
        t = t.to(self.device)
        return Sharded(tuple(t.narrow(axis, i * size, size).clone(
            memory_format=torch.contiguous_format) for i in range(n)))

    def unshard(self, x: Sharded) -> torch.Tensor:
        """The whole [C] column of a `Sharded` one (every process gets
        it)."""
        return self.all_gather(list(x.shards))


class VirtualMesh(NodeMesh):
    """E x D shards in this process on one device (the node axis held
    once: a node-axis program computes the same on every eval row)."""

    def __init__(self, n_shards: int, device: DeviceLike = None,
                 n_evals: int = 1) -> None:
        if int(n_shards) < 1 or int(n_evals) < 1:
            raise ValueError(f"a mesh needs at least one shard and one eval "
                             f"row, got {n_shards} and {n_evals}")
        self.n_shards = int(n_shards)
        self.local_shards = tuple(range(self.n_shards))
        self.n_evals = int(n_evals)
        self.local_evals = tuple(range(self.n_evals))
        self.device = resolve_device(device)

    def gather(self, locals_, out=None):
        if len(locals_) != self.n_shards:
            raise ValueError("one tensor per shard is needed")
        return torch.stack(list(locals_), out=out)

    def all_gather(self, locals_, out=None, axis: int = 0):
        if len(locals_) != self.n_shards:
            raise ValueError("one tensor per shard is needed")
        return torch.cat(list(locals_), dim=axis, out=out)

    def gather_evals(self, locals_):
        if len(locals_) != self.n_evals:
            raise ValueError("one tensor per eval row is needed")
        return torch.stack(list(locals_))


class DistMesh(NodeMesh):
    """L node shards per rank of a `torch.distributed` group of
    ``n_evals * n_shards / L`` ranks: with R = n_shards / L ranks an
    eval row, rank r is eval row r // R and holds node shards
    (r % R) * L to (r % R) * L + L - 1.  The group must be initialised
    and of exactly that size (other sizes raise).  With more than one
    eval row, every rank creates the rows' and the columns' subgroups,
    in the same order.  The device is the card unless `device` says
    ``"cpu"``, over gloo as over NCCL (an NCCL group must be on the
    card)."""

    def __init__(self, group=None, n_shards: Optional[int] = None,
                 device: DeviceLike = None, n_evals: int = 1,
                 shards_per_rank: int = 1) -> None:
        import torch.distributed as dist

        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError(
                "DistMesh needs an initialised torch.distributed group "
                "(init_process_group first)")
        world = dist.get_world_size(group)
        ev = int(n_evals)
        per = int(shards_per_rank)
        if per < 1:
            raise ValueError(f"a rank holds at least one shard, got {per}")
        if ev < 1 or world % ev != 0:
            raise ValueError(
                f"{ev} eval rows asked of a group of {world} ranks")
        row_ranks = world // ev
        n = row_ranks * per if n_shards is None else int(n_shards)
        if n != row_ranks * per:
            raise ValueError(
                f"{ev} x {n} (evals, nodes) shards asked of a group of "
                f"{world} ranks: a DistMesh holds {per} shard(s) per rank")
        self.group = group
        self.n_shards = n
        self.n_evals = ev
        self.shards_per_rank = per
        self.n_procs = world
        self.rank = dist.get_rank(group)
        col = self.rank % row_ranks
        self.local_shards = tuple(range(col * per, col * per + per))
        self.local_evals = (self.rank // row_ranks,)
        self.node_group = group
        self.eval_group = None
        if ev > 1:
            ranks = [r if group is None else dist.get_global_rank(group, r)
                     for r in range(world)]
            for row in range(ev):
                g = dist.new_group(ranks[row * row_ranks:(row + 1) * row_ranks])
                if row == self.local_evals[0]:
                    self.node_group = g
            for c in range(row_ranks):
                g = dist.new_group(ranks[c::row_ranks])
                if c == col:
                    self.eval_group = g
        backend = dist.get_backend(group)
        self.device = resolve_device(device)
        if backend == "nccl" and self.device.type != "cuda":
            raise ValueError("an NCCL group exchanges CUDA tensors")

    def gather(self, locals_, out=None):
        import torch.distributed as dist

        if len(locals_) != len(self.local_shards):
            raise ValueError(
                f"a DistMesh rank holds {len(self.local_shards)} shard(s): "
                "one tensor per local shard is needed")
        t = torch.stack([x.contiguous() for x in locals_])
        wire = t.view(torch.uint8) if t.dtype == torch.bool else t  # bytes
        parts = [torch.empty_like(wire)
                 for _ in range(self.n_shards // self.shards_per_rank)]
        dist.all_gather(parts, wire, group=self.node_group)
        g = torch.cat(parts)
        if t.dtype == torch.bool:
            g = g.view(torch.bool)
        return g if out is None else out.copy_(g)

    def gather_evals(self, locals_):
        import torch.distributed as dist

        if len(locals_) != 1:
            raise ValueError("a DistMesh rank holds one eval row")
        t = locals_[0].contiguous()
        if self.n_evals == 1:
            return t[None]
        parts = [torch.empty_like(t) for _ in range(self.n_evals)]
        dist.all_gather(parts, t, group=self.eval_group)
        return torch.stack(parts)


def mesh_axes(n_devices: int, eval_axis: Optional[int] = None) -> Tuple[int, int]:
    """The (evals, nodes) axes the JAX `make_mesh` gives `n_devices`
    devices: `eval_axis` rows, by default 2 when the count is even and at
    least 4 (the node axis is the long one), else 1."""
    n = int(n_devices)
    if eval_axis is None:
        eval_axis = 2 if (n % 2 == 0 and n >= 4) else 1
    if eval_axis < 1 or n % eval_axis != 0:
        raise ValueError(f"{n} devices do not split into {eval_axis} eval rows")
    return int(eval_axis), n // int(eval_axis)


def make_mesh(n_devices: Optional[int] = None,
              eval_axis: Optional[int] = None, *, group=None,
              device: DeviceLike = None, shards_per_rank: int = 1) -> DistMesh:
    """The (evals, nodes) mesh over the `torch.distributed` group's ranks
    (the default group unless `group`), `shards_per_rank` shards each;
    `n_devices` must equal the group's size times that (None: that
    product).  The axes resolve as the JAX `make_mesh`'s (`mesh_axes`):
    by default two eval rows for an even count of at least 4.  `device`
    resolves as every entry point's: the card unless ``"cpu"``.  There is
    no fallback: a missing group or one of another size raises.  E x D
    shards in one process are a `VirtualMesh`."""
    if n_devices is None:
        import torch.distributed as dist

        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError(
                "make_mesh needs an initialised torch.distributed group "
                "(init_process_group first)")
        n_devices = dist.get_world_size(group) * int(shards_per_rank)
    evals, nodes = mesh_axes(n_devices, eval_axis)
    return DistMesh(group, nodes, device=device, n_evals=evals,
                    shards_per_rank=shards_per_rank)


# ---------------------------------------------------------------------------
# the multi-process world: the NOMAD_TPU_DIST* knobs, its processes, and
# the placement of host columns as each process's own shards
# ---------------------------------------------------------------------------

# how long `distributed_init` waits for every member of the world
DIST_INIT_TIMEOUT_S = 300.0
# the knob of `shards_per_rank`: the node shards each rank holds
SHARDS_PER_RANK_ENV = "NOMAD_TPU_SHARDS_PER_RANK"


class DistConfig(NamedTuple):
    coordinator: str  # host:port of rank 0's store
    num_processes: int
    process_id: int


def _dist_knob(name: str, default: str) -> str:
    """One NOMAD_TPU_DIST* knob, namespaced: with NOMAD_TPU_DIST_NS set
    (say ``f1``), ``NOMAD_TPU_DIST_COORD_F1`` wins over
    ``NOMAD_TPU_DIST_COORD``, so one shared environment can describe
    several worlds and each process picks its own by the selector."""
    ns = os.environ.get("NOMAD_TPU_DIST_NS", "")
    if ns:
        val = os.environ.get(f"{name}_{ns.upper()}")
        if val is not None:
            return val
    return os.environ.get(name, default)


def dist_config() -> Optional[DistConfig]:
    """The NOMAD_TPU_DIST* knobs, or None when the multi-process world
    is not asked for (`NOMAD_TPU_DIST` != 1).  Asked for, a malformed
    process count or id raises instead of being coerced: a member that
    fell back to one process would leave its peers waiting in their
    first collective."""
    if os.environ.get("NOMAD_TPU_DIST") != "1":
        return None
    coord = _dist_knob("NOMAD_TPU_DIST_COORD", "127.0.0.1:8476")
    try:
        procs = int(_dist_knob("NOMAD_TPU_DIST_PROCS", "1"))
        pid = int(_dist_knob("NOMAD_TPU_DIST_ID", "0"))
    except ValueError as exc:
        raise ValueError(
            "NOMAD_TPU_DIST=1 but NOMAD_TPU_DIST_PROCS/NOMAD_TPU_DIST_ID "
            "are not integers: a member that fell back to one process "
            f"would leave its peers waiting in their first collective ({exc})"
        ) from exc
    if procs <= 1:
        # the documented off-switch: <= 1 keeps the world off
        return DistConfig(coord, 1, 0)
    if not 0 <= pid < procs:
        raise ValueError(
            f"NOMAD_TPU_DIST_ID={pid} out of range for "
            f"NOMAD_TPU_DIST_PROCS={procs}")
    return DistConfig(coord, procs, pid)


def distributed_init() -> bool:
    """Join the gloo world of the NOMAD_TPU_DIST* knobs
    (``init_process_group("gloo", init_method="tcp://<coordinator>")``),
    once.  Returns True when this process is a member of a world of
    several, False for one process (knobs unset, or
    NOMAD_TPU_DIST_PROCS <= 1), where nothing needs a coordinator.  A
    malformed knob, a coordinator that does not answer within
    DIST_INIT_TIMEOUT_S, or a group already made of another size or
    rank raises: nothing falls back to one process."""
    cfg = dist_config()
    if cfg is None or cfg.num_processes <= 1:
        return False
    import torch.distributed as dist

    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        if (world, rank) != (cfg.num_processes, cfg.process_id):
            raise ValueError(
                f"a torch.distributed group of {world} ranks (this rank "
                f"{rank}) exists, but NOMAD_TPU_DIST* describes "
                f"{cfg.num_processes} (this rank {cfg.process_id})")
        return True
    dist.init_process_group(
        "gloo", init_method=f"tcp://{cfg.coordinator}",
        world_size=cfg.num_processes, rank=cfg.process_id,
        timeout=timedelta(seconds=DIST_INIT_TIMEOUT_S))
    return True


def shards_per_rank() -> int:
    """NOMAD_TPU_SHARDS_PER_RANK (default 1): the node shards each rank
    of a worker's mesh holds, the JAX package's devices per process.
    A value that is not a positive integer raises."""
    raw = os.environ.get(SHARDS_PER_RANK_ENV, "1")
    try:
        per = int(raw)
    except ValueError:
        per = 0
    if per < 1:
        raise ValueError(
            f"NOMAD_TPU_SHARDS_PER_RANK={raw!r}: a rank holds at least "
            "one shard")
    return per


def host_count(mesh: NodeMesh) -> int:
    """Distinct processes holding shards of this mesh."""
    return int(getattr(mesh, "n_procs", 1))


def is_multihost(mesh: NodeMesh) -> bool:
    return host_count(mesh) > 1


def local_device_positions(mesh: NodeMesh) -> list:
    """Positions along the mesh's flattened (evals, nodes) order that
    this process holds: the rows of a per-shard staging stack it
    ships."""
    return [e * mesh.n_shards + s
            for e in mesh.local_evals for s in mesh.local_shards]


def local_device_count(mesh: NodeMesh) -> int:
    """This process's shards on the mesh: the divisor of every per-host
    traffic figure."""
    return len(local_device_positions(mesh))


def mesh_put(mesh: NodeMesh, arr,
             upload: Optional[Callable[[np.ndarray], torch.Tensor]] = None
             ) -> Sharded:
    """A host [C] column as this process's shards of `mesh`: its own
    rows are cut on the host and only those are uploaded (`upload`, a
    host array to a tensor of its own on the mesh's device; by default a
    copy), so no process ships another's slice and the column never
    crosses the mesh whole.  The shards are contiguous views of the one
    upload."""
    host = arr.numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)
    size = mesh.shard_size(host.shape[0])
    first, n = mesh.local_shards[0], len(mesh.local_shards)
    block = np.ascontiguousarray(host[first * size:(first + n) * size])
    t = (upload(block) if upload is not None
         else torch.from_numpy(block).to(mesh.device, copy=True))
    return Sharded(tuple(t.narrow(0, i * size, size) for i in range(n)))


# ---------------------------------------------------------------------------
# the node-sharded select (K11 a shard, K6) and the (evals, nodes)-sharded
# batch planner (K10 an eval row)
# ---------------------------------------------------------------------------


def _on_mesh(x, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    """numpy array, number or tensor as a `dtype` tensor on `dev`."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x.to(device=dev, dtype=dtype)


def _float_dtype(x) -> torch.dtype:
    dtype = (x.dtype if isinstance(x, torch.Tensor)
             else torch.as_tensor(np.asarray(x)[:0]).dtype)
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"node columns must be f32 or f64, got {dtype}")
    return dtype


def _walk_outputs(buf: torch.Tensor, dtype: torch.dtype):
    """K6's int64[4] result ([row, feasible count, pulls, bits of best])
    as 0-d tensors on the card, by views alone: (row i32, best, feasible
    count i32, pulls i32)."""
    words = buf.view(torch.int32)  # little-endian: the low word first
    bits = words[6:7] if dtype == torch.float32 else buf[3:4]
    return words[0], bits.view(dtype)[0], words[2], words[4]


def _select_runner(mesh: NodeMesh, spread_fit: bool, kernel: Optional[bool]):
    from ..ops import score as tscore

    node_fields = tuple(n for n in tscore._COLUMNS if n != "perm")
    kinds = {"feasible": torch.bool, "penalty": torch.bool,
             "collisions": torch.int32}

    def run(inp):
        if inp.policy is not None:
            raise ValueError(
                "sharded_score_and_select takes no policy terms (the JAX "
                "program's in_specs leave them out)")
        use_kernel = (mesh.device.type == "cuda") if kernel is None else kernel
        dev = mesh.device
        dtype = _float_dtype(inp.cpu_total)
        # node fields P('nodes'): this process's contiguous shards; perm
        # and the scalars replicated
        cols = {n: mesh.shard(_on_mesh(getattr(inp, n), kinds.get(n, dtype), dev))
                for n in node_fields}
        perm = _on_mesh(inp.perm, torch.int32, dev)
        size = mesh.shard_size(perm.shape[0])
        score = tscore.score_all_cuda if use_kernel else tscore.score_all_twin
        feas_l, final_l = [], []
        for i, s in enumerate(mesh.local_shards):
            # the shard's slice of perm only fills the field: no per-node
            # score reads it
            local = inp._replace(perm=perm.narrow(0, s * size, size),
                                 **{n: cols[n].shards[i] for n in node_fields})
            f, sc = score(local, spread_fit)
            feas_l.append(f)
            final_l.append(sc)
        final = mesh.all_gather(final_l)
        feasible = mesh.all_gather(feas_l)
        if use_kernel:
            # the JAX program returns the feasible count: K6 counts
            return _walk_outputs(tscore.walk_only_cuda(
                feasible, final, perm, inp.limit, inp.n_candidates,
                count=True), dtype)
        return tscore.limited_walk_argmax(feasible, final, perm, inp.limit,
                                          inp.n_candidates)

    return run


def sharded_score_and_select(mesh: NodeMesh, spread_fit: bool = False):
    """One select with the node arena sharded over the mesh's node axis,
    as the JAX `sharded_score_and_select`: returns ``run(inp:
    ScoreInputs) -> (row, best, feasible_count, pulls)``, 0-d tensors on
    the mesh's device, bit-identical to `score_and_select`.  The node
    columns (numpy or tensors, whole [C]) are cut into the mesh's shards;
    each shard is scored by K11 on the card (its twin on the CPU), the
    [C] scores and feasibility are all-gathered, and K6 (the twin
    `limited_walk_argmax`) walks them.  A `ScoreInputs` with policy
    terms raises ValueError."""
    return _select_runner(mesh, spread_fit, None)


def sharded_score_and_select_twin(mesh: NodeMesh, spread_fit: bool = False):
    """`sharded_score_and_select` with the plain-torch twins on any mesh
    (the card checks hold K11 + K6 against it)."""
    return _select_runner(mesh, spread_fit, False)


def _batch_runner(mesh: NodeMesh, n_candidates: int, n_picks: int,
                  spread_fit: bool, kernel: Optional[bool]):
    from ..ops import batch as tbatch

    kinds = {"feasible": torch.bool, "penalty": torch.bool,
             "base_collisions": torch.int32, "perm": torch.int32}

    def run(cpu_total, mem_total, disk_total, batch):
        use_kernel = (mesh.device.type == "cuda") if kernel is None else kernel
        dev = mesh.device
        dtype = _float_dtype(cpu_total)
        E = int(batch.perm.shape[0])
        rows_per = mesh.eval_rows(E)
        # node columns P('nodes'), gathered whole over the node axis
        cols = [mesh.all_gather(list(mesh.shard(_on_mesh(c, dtype, dev)).shards))
                for c in (cpu_total, mem_total, disk_total)]
        plan = tbatch.batch_plan_picks_cuda if use_kernel else tbatch.batch_plan_picks_twin
        rows = []
        for r in mesh.local_evals:
            lo, hi = r * rows_per, (r + 1) * rows_per
            fields = {}
            for name in tbatch.BatchInputs._fields:
                x = getattr(batch, name)[lo:hi]
                if name in tbatch._BATCHED_SCALARS:
                    fields[name] = x  # P('evals'): this row's evals
                else:
                    # P('evals', 'nodes'): the row's shards, all-gathered
                    # over the node axis
                    sh = mesh.shard(_on_mesh(x, kinds.get(name, dtype), dev), axis=1)
                    fields[name] = mesh.all_gather(list(sh.shards), axis=1)
            rows.append(plan(*cols, tbatch.BatchInputs(**fields), n_candidates,
                             n_picks, spread_fit))
        # out_specs P('evals'): every process gets the whole [E, P]
        return mesh.gather_evals(rows).reshape(E, int(n_picks))

    return run


def sharded_batch_plan(mesh: NodeMesh, n_candidates: int, n_picks: int,
                       spread_fit: bool = False):
    """The batched planner on an (evals, nodes) mesh, as the JAX
    `sharded_batch_plan`: returns ``run(cpu_total, mem_total, disk_total,
    batch: BatchInputs) -> rows i32[E, P]`` on the mesh's device, equal to
    `batch_plan_picks`.  Node columns are sharded over ``nodes``, the
    per-eval [E, C] fields over both axes and the per-eval scalars over
    ``evals`` (numpy or tensors, whole); each eval row all-gathers its
    columns over the node axis and plans its own evals with K10 on the
    card (its twin on the CPU); the rows are gathered over the eval axis.
    An E not divisible by the eval axis, or a C by the node axis,
    raises ValueError."""
    return _batch_runner(mesh, n_candidates, n_picks, spread_fit, None)


def sharded_batch_plan_twin(mesh: NodeMesh, n_candidates: int, n_picks: int,
                            spread_fit: bool = False):
    """`sharded_batch_plan` with K10's twin on any mesh (the card checks
    hold K10 against it)."""
    return _batch_runner(mesh, n_candidates, n_picks, spread_fit, False)


# ---------------------------------------------------------------------------
# the sharded chained planner: shared driver, stages as K12 or the twin
# ---------------------------------------------------------------------------

# flags of a walk position in a shard's permuted scratch
_FEAS, _BAD, _DIV = 1, 2, 4
_FIN = 5  # a walk_fin record: best, order key, position, limit-th wp, any


class _Shard:
    """One local shard's columns, per-eval slices, scratch and records."""

    def __init__(self, s: int, lo: int, size: int) -> None:
        self.s, self.lo, self.size = s, lo, size


class _Chain:
    """Every tensor of one launch, on the mesh's device; shard inputs
    hold contiguous per-shard copies, replicated ones one copy per
    process."""


def prepare_sharded_chain(mesh: NodeMesh, n_picks: int, args: tuple,
                          spread_fit: bool = False, with_spread: bool = False,
                          spread_even: bool = False) -> _Chain:
    """Every input of one chain (the runner's positional `args`) on the
    mesh's device, checked for shape: shard inputs as contiguous
    per-shard tensors, replicated ones once per process; with the state,
    gather buffers, records and scratch the stages use.  K12 and the
    twin both run on it (`sharded_chained_plan_cuda`,
    `sharded_chain_twin`); the usage carry starts from ``used0_*``
    and is left in each shard's ``use`` columns.

    The six node columns come whole ([C], numpy or tensors, cut into
    shards here) or as `Sharded` columns of this mesh: a sharded usage
    mirror, or a previous chunk's carry.  Sharded ones are read where
    they lie, on the mesh's device: the totals in place, the used
    columns copied there into the chain's own carry (the caller's
    ``used0`` stays untouched), nothing through the host."""
    (cpu_total, mem_total, disk_total, used0_cpu, used0_mem, used0_disk,
     feasible, perm, ask_cpu, ask_mem, ask_disk, desired_count, limits,
     wanted, n_candidates, distinct_hosts, coll0, affinity, deltas,
     pre) = args[:20]
    spread = args[20] if with_spread else None
    if with_spread and spread is None:
        raise ValueError("with_spread=True needs the SpreadInputs argument")
    dev = mesh.device

    def host(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return np.asarray(x)

    if isinstance(cpu_total, Sharded):
        dtype = cpu_total.shards[0].dtype
        C = int(cpu_total.shards[0].shape[0]) * mesh.n_shards
    else:
        tot0 = torch.as_tensor(host(cpu_total))
        dtype = tot0.dtype
        C = tot0.shape[0]
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"columns must be f32 or f64, got {dtype}")
    size = mesh.shard_size(C)
    P = int(n_picks)
    perm_h = host(perm).astype(np.int32)
    E = perm_h.shape[0]
    if perm_h.shape != (E, C):
        raise ValueError(f"perm must be [E, C] = [{E}, {C}]")

    c = _Chain()
    c.mesh, c.dtype, c.C, c.E, c.P, c.D, c.size = mesh, dtype, C, E, P, mesh.n_shards, size
    c.spread_fit, c.spread = bool(spread_fit), with_spread

    def rep(x, kind):
        a = host(x)
        if kind == "f":
            return torch.as_tensor(a.astype(np.float64)).to(dtype).to(dev)
        if kind == "i":
            return torch.as_tensor(a.astype(np.int32)).to(dev)
        return torch.as_tensor(a.astype(np.uint8)).to(dev)

    def per_eval(x, kind):
        t = rep(x, kind)
        if t.shape != (E,):
            raise ValueError(f"a per-eval input must be [E] = [{E}], got {tuple(t.shape)}")
        return t

    c.perm = rep(perm_h, "i")
    c.ask = tuple(per_eval(a, "f") for a in (ask_cpu, ask_mem, ask_disk))
    c.desired = per_eval(desired_count, "i")
    c.limit = per_eval(limits, "i")
    c.wanted = per_eval(wanted, "i")
    c.n_cand = per_eval(n_candidates, "i")
    nc_h = host(n_candidates).astype(np.int64)
    if E and (nc_h.min() < 1 or nc_h.max() > C):
        raise ValueError("n_candidates must lie in [1, C]")
    c.dh = per_eval(distinct_hosts, "b")
    d = deltas
    c.ev_rows = rep(d.evict_rows, "i")
    c.ev_vals = tuple(rep(v, "f") for v in (d.evict_cpu, d.evict_mem, d.evict_disk))
    c.ev_coll = rep(d.evict_coll, "i")
    c.pen_rows = rep(d.penalty_rows, "i")
    if c.ev_rows.shape != (E, P) or c.pen_rows.shape[:2] != (E, P):
        raise ValueError("step deltas must be [E, P] (penalty rows [E, P, K])")
    c.K = c.pen_rows.shape[2]
    c.pre_rows = rep(pre.rows, "i")
    c.pre_vals = tuple(rep(v, "f") for v in (pre.cpu, pre.mem, pre.disk))
    c.R = c.pre_rows.shape[1]

    c.S = c.V1 = 0
    if with_spread:
        c.sp_desired = rep(spread.desired, "f")
        c.sp_used0 = rep(spread.used0, "f")
        c.sp_prop0 = rep(spread.proposed0, "f")
        c.sp_clr0 = rep(spread.cleared0, "f")
        c.sp_weight = rep(spread.weight, "f")
        c.sp_active = rep(spread.active, "b")
        c.sp_even = (rep(spread.even, "b")
                     if spread_even and spread.even is not None else None)
        _E, c.S, c.V1 = c.sp_desired.shape
        codes_h = host(spread.codes).astype(np.int32)
        if codes_h.shape != (E, c.S, C):
            raise ValueError("spread codes must be [E, S, C]")

    feas_h = host(feasible).astype(np.uint8)
    coll_h = host(coll0).astype(np.int32)
    aff_h = host(affinity).astype(np.float64)
    tots = [_node_column(mesh, x, dtype, size, host)
            for x in (cpu_total, mem_total, disk_total)]
    used = [_node_column(mesh, u, dtype, size, host)
            for u in (used0_cpu, used0_mem, used0_disk)]
    i32 = torch.int32
    c.shards = []
    for i, s in enumerate(mesh.local_shards):
        lo = s * size
        sh = _Shard(s, lo, size)
        sl = slice(lo, lo + size)
        sh.tot = tuple(t.shards[i] for t in tots)
        # the usage carry: fresh tensors, the caller's used0 untouched
        sh.use = tuple(u.shards[i].clone() for u in used)
        sh.feas = torch.as_tensor(np.ascontiguousarray(feas_h[:, sl])).to(dev)
        sh.coll0 = torch.as_tensor(np.ascontiguousarray(coll_h[:, sl])).to(dev)
        sh.aff = torch.as_tensor(np.ascontiguousarray(aff_h[:, sl])).to(dtype).to(dev)
        sh.codes = (torch.as_tensor(np.ascontiguousarray(codes_h[:, :, sl])).to(dev)
                    if with_spread else None)
        sh.coll = torch.zeros(size, dtype=i32, device=dev)
        sh.final_l = torch.zeros(size, dtype=dtype, device=dev)
        sh.feas_l = torch.zeros(size, dtype=torch.uint8, device=dev)
        sh.s_p = torch.zeros(size, dtype=dtype, device=dev)
        sh.f_p = torch.zeros(size, dtype=torch.uint8, device=dev)
        sh.rec_bad = torch.zeros(2, dtype=i32, device=dev)
        sh.rec_nd = torch.zeros(4, dtype=i32, device=dev)
        sh.rec_fin = torch.zeros(_FIN, dtype=torch.float64, device=dev)
        sv = max(c.S * c.V1, 1)
        sh.oh_l = torch.zeros(sv, dtype=dtype, device=dev)
        sh.ev_oh_l = torch.zeros(max(P, 1) * sv, dtype=dtype, device=dev)
        c.shards.append(sh)
    sv = max(c.S * c.V1, 1)
    c.off = torch.zeros(1, dtype=i32, device=dev)
    c.dead = torch.zeros(1, dtype=torch.uint8, device=dev)
    c.prop = torch.zeros(sv, dtype=dtype, device=dev)
    c.clr = torch.zeros(sv, dtype=dtype, device=dev)
    c.oh = torch.zeros(sv, dtype=dtype, device=dev)
    c.ev_oh = torch.zeros(max(P, 1) * sv, dtype=dtype, device=dev)
    c.rows = torch.full((E, P), NO_NODE, dtype=i32, device=dev)
    c.pulls = torch.zeros((E, P), dtype=i32, device=dev)
    c.final_g = torch.zeros(C, dtype=dtype, device=dev)
    c.feas_g = torch.zeros(C, dtype=torch.uint8, device=dev)
    c.g_bad = torch.zeros((c.D, 2), dtype=i32, device=dev)
    c.g_nd = torch.zeros((c.D, 4), dtype=i32, device=dev)
    c.g_fin = torch.zeros((c.D, _FIN), dtype=torch.float64, device=dev)
    return c


def _node_column(mesh: NodeMesh, x, dtype: torch.dtype, size: int,
                 host) -> Sharded:
    """A node column of a chain as this process's shards on the mesh's
    device: a `Sharded` one as it lies (checked, never copied), a whole
    one cut into shards."""
    if isinstance(x, Sharded):
        x = mesh.shard(x)
        for t in x.shards:
            if (t.device != mesh.device or t.dtype != dtype
                    or tuple(t.shape) != (size,) or not t.is_contiguous()):
                raise ValueError(
                    f"a Sharded node column must hold contiguous {dtype}"
                    f"[{size}] shards on {mesh.device}")
        return x
    return mesh.shard(host(x).astype(np.float64), dtype)


def _drive(c: _Chain, stages) -> None:
    """The launch sequence of one chain: the same for K12 and its twin,
    the mesh's exchanges between the stages."""
    mesh = c.mesh
    shards = c.shards
    for e in range(c.E):
        stages.begin(c, e)
        for sh in shards:
            stages.prologue(c, sh, e)
        if c.spread:
            mesh.psum([sh.ev_oh_l for sh in shards], out=c.ev_oh)
        for k in range(c.P):
            for sh in shards:
                stages.score(c, sh, e, k)
            mesh.all_gather([sh.final_l for sh in shards], out=c.final_g)
            mesh.all_gather([sh.feas_l for sh in shards], out=c.feas_g)
            for sh in shards:
                stages.walk_bad(c, sh, e)
            mesh.gather([sh.rec_bad for sh in shards], out=c.g_bad)
            for sh in shards:
                stages.walk_nd(c, sh, e)
            mesh.gather([sh.rec_nd for sh in shards], out=c.g_nd)
            for sh in shards:
                stages.walk_fin(c, sh, e)
            mesh.gather([sh.rec_fin for sh in shards], out=c.g_fin)
            for sh in shards:
                stages.commit(c, sh, e, k)
            if c.spread:
                mesh.psum([sh.oh_l for sh in shards], out=c.oh)
            stages.advance(c, e, k)


def stage_launches(mesh: NodeMesh, n_evals: int, n_picks: int) -> int:
    """Kernel launches of one chain of K12 in this process: one
    cooperative launch on a `VirtualMesh`; on any other mesh (its
    exchanges cross processes) per eval begin + a prologue per local
    shard, per pick five stages per local shard and one advance."""
    if isinstance(mesh, VirtualMesh):
        return 1
    d = len(mesh.local_shards)
    return n_evals * (1 + d + n_picks * (5 * d + 1))


# -- the twin's stages ------------------------------------------------------


def _local_add(col: torch.Tensor, idx: int, delta, pred: bool) -> None:
    """`local_scatter` of the JAX program on one shard: `delta` added at
    local row `idx` when `pred` and the row is this shard's, else +0
    added at the clipped row."""
    size = col.shape[0]
    ok = pred and 0 <= idx < size
    safe = min(max(idx, 0), size - 1)
    d = torch.as_tensor(delta, dtype=col.dtype, device=col.device)
    col[safe] = col[safe] + (d if ok else torch.zeros_like(d))


def _reduce_fin(c: _Chain, e: int):
    """(row, any_emitted, pulls) of the pick from the gathered walk_fin
    and walk_nd records: pmax of the score, pmin of the order key among
    the shards holding it, pmin of their positions, pmax of `any`, pmin
    of the limit-th walk position."""
    g = c.g_fin.cpu().numpy()
    best = g[:, 0].max()
    keys = np.where(g[:, 0] == best, g[:, 1], float(INT32_MAX))
    gmin = keys.min()
    win_pos = int(g[keys == gmin, 2].min())
    any_e = bool(g[:, 4].max() > 0)
    lth = int(g[:, 3].min())
    nd_count = int(c.g_nd[:, 0].sum())
    lim = int(c.limit[e])
    nc = int(c.n_cand[e])
    pulls = lth + 1 if nd_count >= lim else nc
    row = int(c.perm[e, win_pos]) if any_e else NO_NODE
    return row, any_e, pulls


class _TwinStages:
    """The stages in plain torch, on the chain's tensors."""

    @staticmethod
    def begin(c: _Chain, e: int) -> None:
        c.off.zero_()
        c.dead.zero_()
        if c.spread:
            c.prop.copy_(c.sp_prop0[e].reshape(-1))
            c.clr.copy_(c.sp_clr0[e].reshape(-1))

    @staticmethod
    def prologue(c: _Chain, sh: _Shard, e: int) -> None:
        sh.coll.copy_(sh.coll0[e])
        for col, vals in zip(sh.use, c.pre_vals):
            for i in range(c.R):
                _local_add(col, int(c.pre_rows[e, i]) - sh.lo, vals[e, i], True)
        if c.spread:
            oh = sh.ev_oh_l.view(c.P, c.S, c.V1)
            oh.zero_()
            for k in range(c.P):
                idx = int(c.ev_rows[e, k]) - sh.lo
                if int(c.ev_rows[e, k]) >= 0 and 0 <= idx < sh.size:
                    slots = sh.codes[e, :, idx].long()
                    oh[k, torch.arange(c.S, device=oh.device), slots] = 1.0

    @staticmethod
    def _state(c: _Chain, e: int, k: int):
        active = k < int(c.wanted[e]) and not bool(c.dead[0])
        erow = int(c.ev_rows[e, k])
        return active, erow, active and erow >= 0

    @staticmethod
    def score(c: _Chain, sh: _Shard, e: int, k: int) -> None:
        dtype, dev = c.dtype, c.final_g.device
        active, erow, app = _TwinStages._state(c, e, k)
        idx = erow - sh.lo
        for col, vals in zip(sh.use, c.ev_vals):
            _local_add(col, idx, vals[e, k], app)
        _local_add(sh.coll, idx, c.ev_coll[e, k], app)
        rows_l = sh.lo + torch.arange(sh.size, device=dev, dtype=torch.int32)
        pen = (rows_l[:, None] == c.pen_rows[e, k][None, :]).any(dim=1)
        cpu_u, mem_u, disk_u = sh.use
        cpu_t, mem_t, disk_t = sh.tot
        one = torch.ones((), dtype=dtype, device=dev)
        zero = torch.zeros((), dtype=dtype, device=dev)
        cpu_after = cpu_u + c.ask[0][e]
        mem_after = mem_u + c.ask[1][e]
        disk_after = disk_u + c.ask[2][e]
        fit = (cpu_after <= cpu_t) & (mem_after <= mem_t) & (disk_after <= disk_t)
        feas = (sh.feas[e] != 0) & fit & ~(bool(c.dh[e]) & (sh.coll > 0))
        free_cpu = 1.0 - cpu_after / torch.where(cpu_t > 0, cpu_t, one)
        free_mem = 1.0 - mem_after / torch.where(mem_t > 0, mem_t, one)
        base = _pow10(free_cpu, dtype) + _pow10(free_mem, dtype)
        if c.spread_fit:
            fitness = torch.clamp(base - 2.0, 0.0, 18.0)
        else:
            fitness = torch.clamp(20.0 - base, 0.0, 18.0)
        count = torch.ones_like(fitness)
        has_coll = sh.coll > 0
        desired = c.desired[e].to(dtype)
        anti = torch.where(has_coll, -(sh.coll.to(dtype) + 1.0) / desired, zero)
        # fitness / 18 + anti as the compiled program fuses it (score.py)
        score_sum = fma(fitness, INV_18, anti)
        count = count + has_coll.to(dtype)
        score_sum = score_sum - pen.to(dtype)
        count = count + pen.to(dtype)
        aff = sh.aff[e]
        has_aff = aff != 0.0
        score_sum = score_sum + torch.where(has_aff, aff, zero)
        count = count + has_aff.to(dtype)
        if c.spread:
            S, V1 = c.S, c.V1
            clr = c.clr + (c.ev_oh.view(c.P, -1)[k] if app else torch.zeros_like(c.clr))
            codes = sh.codes[e].long()
            desired_node = torch.gather(c.sp_desired[e], 1, codes)
            total = spread_contribution(
                codes, desired_node, codes == (V1 - 1),
                torch.where(desired_node != 0, desired_node, one),
                c.sp_used0[e], c.prop.view(S, V1), clr.view(S, V1),
                c.sp_weight[e], c.sp_active[e] != 0,
                None if c.sp_even is None else c.sp_even[e] != 0)
            score_sum = score_sum + total
            count = count + (total != 0.0).to(dtype)
        sh.final_l.copy_(score_sum / count)
        sh.feas_l.copy_(feas.to(torch.uint8))

    @staticmethod
    def _walk_frame(c: _Chain, sh: _Shard, e: int):
        off = int(c.off[0])
        nc = int(c.n_cand[e])
        dev = sh.f_p.device
        pos = sh.lo + torch.arange(sh.size, device=dev, dtype=torch.int32)
        is_tail = pos >= nc
        in_wrap = pos < off
        own = (off - 1) // sh.size  # floor division, as jnp's on int32
        off_local = (off - 1) % sh.size
        return off, nc, pos, is_tail, in_wrap, own, off_local

    @staticmethod
    def _rot(cs_local, g, s, own, off, is_tail, in_wrap):
        """`rot` of `_sharded_walk` from a local inclusive count and the
        gathered (total, count at the offset) records."""
        tot = [int(x) for x in g[:, 0].tolist()]
        carry = sum(tot[:s])
        total = sum(tot)
        c_off = 0
        if off > 0:
            c_off = int(g[own, 1]) + sum(tot[:own])
        cs = cs_local + carry
        pre = torch.where(in_wrap, cs + (total - c_off), cs - c_off)
        return torch.where(is_tail, torch.full_like(cs, total), pre), total

    @staticmethod
    def _record(cs_local, sh, own, off_local):
        at = int(cs_local[off_local]) if own == sh.s else 0
        return [int(cs_local[-1]), at]

    @staticmethod
    def walk_bad(c: _Chain, sh: _Shard, e: int) -> None:
        off, nc, pos, is_tail, in_wrap, own, off_local = _TwinStages._walk_frame(c, sh, e)
        perm_l = c.perm[e, sh.lo:sh.lo + sh.size].long()
        s = c.final_g[perm_l]
        f = c.feas_g[perm_l] != 0
        bad = f & (s <= SKIP_THRESHOLD)
        sh.s_p.copy_(s)
        sh.f_p.copy_(f.to(torch.uint8) * _FEAS + bad.to(torch.uint8) * _BAD)
        cs = torch.cumsum(bad.to(torch.int32), 0, dtype=torch.int32)
        sh.rec_bad.copy_(torch.tensor(_TwinStages._record(cs, sh, own, off_local),
                                      dtype=torch.int32))

    @staticmethod
    def walk_nd(c: _Chain, sh: _Shard, e: int) -> None:
        off, nc, pos, is_tail, in_wrap, own, off_local = _TwinStages._walk_frame(c, sh, e)
        f = (sh.f_p & _FEAS) != 0
        bad = (sh.f_p & _BAD) != 0
        g = c.g_bad.cpu()
        cs = torch.cumsum(bad.to(torch.int32), 0, dtype=torch.int32)
        bad_rank, _ = _TwinStages._rot(cs, g, sh.s, own, off, is_tail, in_wrap)
        div = bad & (bad_rank <= MAX_SKIP)
        nd = f & ~div
        sh.f_p.copy_(sh.f_p | (div.to(torch.uint8) * _DIV))
        cs_nd = torch.cumsum(nd.to(torch.int32), 0, dtype=torch.int32)
        cs_div = torch.cumsum(div.to(torch.int32), 0, dtype=torch.int32)
        sh.rec_nd.copy_(torch.tensor(
            _TwinStages._record(cs_nd, sh, own, off_local)
            + _TwinStages._record(cs_div, sh, own, off_local), dtype=torch.int32))

    @staticmethod
    def walk_fin(c: _Chain, sh: _Shard, e: int) -> None:
        off, nc, pos, is_tail, in_wrap, own, off_local = _TwinStages._walk_frame(c, sh, e)
        f = (sh.f_p & _FEAS) != 0
        div = (sh.f_p & _DIV) != 0
        nd = f & ~div
        g = c.g_nd.cpu()
        nd_incl, nd_count = _TwinStages._rot(
            torch.cumsum(nd.to(torch.int32), 0, dtype=torch.int32), g[:, 0:2],
            sh.s, own, off, is_tail, in_wrap)
        div_incl, n_div = _TwinStages._rot(
            torch.cumsum(div.to(torch.int32), 0, dtype=torch.int32), g[:, 2:4],
            sh.s, own, off, is_tail, in_wrap)
        div_rank = div_incl - 1
        div_order = div_rank if not (n_div == 2 and nd_count > 0) else 1 - div_rank
        emit = torch.where(nd, nd_incl - 1, nd_count + div_order)
        lim = int(c.limit[e])
        emitted = f & (emit < lim)
        s = sh.s_p
        masked = torch.where(emitted, s, torch.full_like(s, -math.inf))
        best = masked.max()
        big = torch.full_like(emit, INT32_MAX)
        key = torch.where(emitted & (masked == best), emit, big)
        j = int(torch.argmin(key))
        wp = torch.where(is_tail, pos, torch.remainder(pos - off + nc, nc))
        lth = torch.where(nd & (nd_incl == lim), wp, big).min()
        sh.rec_fin.copy_(torch.tensor(
            [float(best), float(key[j]), float(sh.lo + j), float(lth),
             float(bool(emitted.any()))], dtype=torch.float64))

    @staticmethod
    def commit(c: _Chain, sh: _Shard, e: int, k: int) -> None:
        row, any_e, _pulls = _reduce_fin(c, e)
        active, _erow, _app = _TwinStages._state(c, e, k)
        ok = active and any_e
        r = row if ok else NO_NODE
        idx = r - sh.lo
        for col, ask in zip(sh.use, c.ask):
            _local_add(col, idx, ask[e], ok)
        _local_add(sh.coll, idx, 1, ok)
        if c.spread:
            oh = sh.oh_l.view(c.S, c.V1)
            oh.zero_()
            if ok and 0 <= idx < sh.size:
                slots = sh.codes[e, :, idx].long()
                oh[torch.arange(c.S, device=oh.device), slots] = 1.0

    @staticmethod
    def advance(c: _Chain, e: int, k: int) -> None:
        row, any_e, pulls = _reduce_fin(c, e)
        active, _erow, app = _TwinStages._state(c, e, k)
        ok = active and any_e
        c.rows[e, k] = row if ok else NO_NODE
        c.pulls[e, k] = pulls if active else 0
        if c.spread:
            ev = c.ev_oh.view(c.P, -1)[k]
            c.clr.copy_(c.clr + (ev if app else torch.zeros_like(ev)))
            c.prop.copy_(c.prop + c.oh)
        if active and not any_e:
            c.dead[0] = 1
        nc = int(c.n_cand[e])
        c.off[0] = (int(c.off[0]) + (pulls if active else 0)) % nc


def _runner(mesh: NodeMesh, n_picks: int, spread_fit: bool, with_spread: bool,
            spread_even: bool, return_carry: bool, kernel: Optional[bool]):
    def run(*args):
        use_kernel = (mesh.device.type == "cuda") if kernel is None else kernel
        c = prepare_sharded_chain(mesh, n_picks, args, spread_fit,
                                  with_spread, spread_even)
        if use_kernel:
            sharded_chained_plan_cuda(c)
        else:
            sharded_chain_twin(c)
        out = (c.rows, c.pulls)
        if return_carry:
            carry = tuple(Sharded(tuple(sh.use[i] for sh in c.shards))
                          for i in range(3))
            return out + (carry,)
        return out

    return run


def sharded_chained_plan(mesh: NodeMesh, n_picks: int,
                         spread_fit: bool = False, with_spread: bool = False,
                         spread_even: bool = False,
                         return_carry: bool = False):
    """The production chained planner with node-axis sharding, as the
    JAX `sharded_chained_plan`: returns ``run(cpu_total, mem_total,
    disk_total, used0_cpu, used0_mem, used0_disk, feasible[E, C],
    perm[E, C], ask_cpu[E], ask_mem[E], ask_disk[E], desired_count[E],
    limits[E], wanted[E], n_candidates[E], distinct_hosts[E],
    coll0[E, C], affinity[E, C], deltas, pre[, spread]) -> (rows[E, P],
    pulls[E, P][, (cpu, mem, disk) carry as Sharded])``.  Node columns
    are passed whole ([C], numpy or tensors); ``used0_*`` may also be
    `Sharded` columns of this mesh (the last chunk's carry).  K12 when
    the mesh is on the card, the twin when it is on the CPU; a failed
    K12 build or launch raises `DeviceFault`."""
    return _runner(mesh, n_picks, spread_fit, with_spread, spread_even,
                   return_carry, None)


def sharded_chained_plan_twin(mesh: NodeMesh, n_picks: int,
                              spread_fit: bool = False,
                              with_spread: bool = False,
                              spread_even: bool = False,
                              return_carry: bool = False):
    """`sharded_chained_plan` with the plain-torch stages on any mesh
    (the card checks hold K12 against it)."""
    return _runner(mesh, n_picks, spread_fit, with_spread, spread_even,
                   return_carry, False)


def sharded_chain_twin(c: _Chain) -> None:
    """The twin's stages over a prepared chain, on its mesh."""
    _drive(c, _TwinStages)


def sharded_chained_plan_cuda(c: _Chain, _max_blocks: int = 0) -> None:
    """K12 over a prepared chain on the current stream; nothing is
    synchronised.  The mesh's kind picks the launch: on a `VirtualMesh`
    (every shard in this process on one card) one cooperative launch
    runs the whole chain, its exchanges in device memory; on a
    `DistMesh` the stages are launched one by one with the mesh's
    collectives between them.  Either fills its argument blocks anew
    for each call, as the path prepares a chain a chunk.  Any failure,
    a cooperative launch the card cannot hold included, raises
    `DeviceFault`: nothing falls back to the other launch path or to the
    twin.  `launches` counts kernel launches, `chunks` the chains
    launched, `blocks` the last cooperative grid.  `_max_blocks` caps
    the cooperative grid (the card tests set it; 0: the occupancy
    API's)."""
    from ..ops import _cuda

    if c.mesh.device.type != "cuda":
        raise ValueError(f"K12 needs a mesh on the card, got {c.mesh.device}")
    try:
        if isinstance(c.mesh, VirtualMesh):
            coop = _cuda.ShardedChainCoop(c, _max_blocks)
            coop.launch()
            sharded_chained_plan_cuda.blocks = coop.blocks
            launched = 1
        else:
            stages = _cuda.ShardedChainStages(c)
            _drive(c, stages)
            launched = stages.launched
    except DeviceFault:
        raise
    except Exception as exc:  # a build, bind or launch failure
        raise DeviceFault(f"K12 sharded_chain failed: {exc}") from exc
    sharded_chained_plan_cuda.launches += launched
    sharded_chained_plan_cuda.chunks += 1


sharded_chained_plan_cuda.launches = 0
sharded_chained_plan_cuda.chunks = 0
sharded_chained_plan_cuda.blocks = 0
