"""K3's grid walk and K12's choice of launch, on the CPU.

* `grid_walk` is a plain model of how K3's grid chain
  (`csrc/chained_grid.cuh`) splits one pick's limited walk over B
  blocks of 1,024 threads: pass A's per-thread bad counts and block
  totals, pass B's diverted positions from the totals of the blocks
  before, pass C's emit order from the grid-wide prefix counts with each
  block's best (score, emit order, walk position) and limit-th walk
  position, and block 0's reduction of the blocks' records.  It is held
  exactly against the JAX `_walk` (`nomad_tpu/ops/batch.py:281`) with
  hypothesis, over B in {1, 2, 7, 132}: fewer candidates than blocks,
  limit 1 and beyond the candidates, ties, bad and diverted positions,
  every rotation offset.
* `sharded_chained_plan_cuda` picks its launch from the mesh's kind: one
  cooperative launch a chain on a `VirtualMesh` (its argument blocks
  filled anew for every call), the staged launches on a gloo
  `DistMesh`; `stage_launches` reports each.  A failed cooperative
  launch, or a mesh of more shards than its by-value table holds,
  raises `DeviceFault` with nothing run in its place.
  (The CUDA launchers are replaced by recording stand-ins that run the
  twin's stages, so the chain's answer is checked too.)
"""
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from nomad_tpu.ops import batch as jbatch
from nomad_tpu_torch.device.core import DeviceFault
from nomad_tpu_torch.ops import _cuda
from nomad_tpu_torch.ops.cases import sharded_chain_case
from nomad_tpu_torch.ops.score import INT32_MAX, MAX_SKIP
from nomad_tpu_torch.parallel import mesh as tmesh
from nomad_tpu_torch.parallel.mesh import (
    DistMesh,
    VirtualMesh,
    prepare_sharded_chain,
    sharded_chain_twin,
    sharded_chained_plan_cuda,
    stage_launches,
)
from nomad_tpu_torch.state.convert import sharded_case_args

THREADS = 1024  # nk::kThreads, the grid chain's block


def _better(s, ord_, bs, bord):
    return s > bs or (s == bs and ord_ < bord)


def _parts(lo, hi, threads):
    """Each thread's contiguous part [a, b) of the block's run [lo, hi)."""
    run = -(-(hi - lo) // threads)
    out = []
    for t in range(threads):
        a = min(lo + t * run, hi)
        out.append((a, min(a + run, hi)))
    return out


def grid_walk(s_w, f_w, limit: int, n_cand: int, n_blocks: int,
              threads: int = THREADS):
    """One pick's limited walk over walk positions [0, n_cand) (scores
    `s_w`, feasibility `f_w` in walk order) as the grid chain computes it
    on `n_blocks` blocks.  Returns (win_w, any_emitted, pulls)."""
    s_w = torch.as_tensor(s_w).tolist()
    f_w = [bool(x) for x in torch.as_tensor(f_w).tolist()]
    run_b = -(-n_cand // n_blocks)
    blocks = []
    for b in range(n_blocks):
        lo = min(b * run_b, n_cand)
        blocks.append(_parts(lo, min(lo + run_b, n_cand), threads))
    bad = [f and s <= 0.0 for s, f in zip(s_w, f_w)]

    # pass A: bad counts a thread, block totals
    a_cnt = [[sum(bad[lo:hi]) for lo, hi in parts] for parts in blocks]
    bad_tot = [sum(c) for c in a_cnt]

    # pass B: the first MAX_SKIP bad positions in walk order diverted
    div = [False] * n_cand
    bc = []
    for b, parts in enumerate(blocks):
        excl = 0
        counts = []
        for (lo, hi), c in zip(parts, a_cnt[b]):
            rank = sum(bad_tot[:b]) + excl
            excl += c
            nd = dv = 0
            for w in range(lo, hi):
                if bad[w]:
                    rank += 1
                    if rank <= MAX_SKIP:
                        div[w] = True
                nd += f_w[w] and not div[w]
                dv += div[w]
            counts.append((nd, dv))
        bc.append(counts)
    nd_tot = [sum(c[0] for c in counts) for counts in bc]
    div_tot = [sum(c[1] for c in counts) for counts in bc]

    # pass C: emit order from the grid-wide prefix counts; each block's
    # best (score, order, position) and limit-th walk position
    nd_count, n_div = sum(nd_tot), sum(div_tot)
    reverse = n_div == 2 and nd_count > 0
    records = []
    for b, parts in enumerate(blocks):
        nd_incl = sum(nd_tot[:b])
        div_incl = sum(div_tot[:b])
        best = (-float("inf"), INT32_MAX, -1)
        lth = INT32_MAX
        for (lo, hi), (nd, dv) in zip(parts, bc[b]):
            for w in range(lo, hi):
                if not f_w[w]:
                    continue
                if div[w]:
                    div_incl += 1
                    rank = div_incl - 1
                    ord_ = nd_count + (1 - rank if reverse else rank)
                else:
                    nd_incl += 1
                    ord_ = nd_incl - 1
                    if nd_incl == limit:
                        lth = min(lth, w)
                if ord_ < limit and _better(s_w[w], ord_, best[0], best[1]):
                    best = (s_w[w], ord_, w)
        records.append(best + (lth,))

    # block 0: the blocks' records reduced in block order
    win = (-float("inf"), INT32_MAX, -1)
    lth = INT32_MAX
    for s, ord_, w, blth in records:
        if _better(s, ord_, win[0], win[1]):
            win = (s, ord_, w)
        lth = min(lth, blth)
    any_emitted = win[1] != INT32_MAX
    pulls = lth + 1 if nd_count >= limit else n_cand
    return win[2], any_emitted, pulls


_jax_walk = jax.jit(jbatch._walk)


@st.composite
def walks(draw):
    n_cand = draw(st.sampled_from([1, 2, 5, 37, 37, 300, 300, 2500]))
    tail = draw(st.integers(0, 3))
    # mixed scores, or only bad ones (then the diverted nodes can win)
    values = draw(st.sampled_from([
        st.sampled_from([-1.0, -0.25, 0.0, 0.125, 0.5, 0.5, 0.75, 1.0]),
        st.sampled_from([-1.0, -0.25, 0.0])]))
    seed = draw(st.integers(0, 2**31 - 1))
    rng = np.random.default_rng(seed)
    scores = rng.choice(np.array([draw(values) for _ in range(8)]),
                        n_cand + tail)
    feasible = rng.random(n_cand + tail) < draw(st.sampled_from([0.1, 0.6, 1.0]))
    feasible[n_cand:] = False  # the padding past the candidates
    offset = draw(st.integers(0, n_cand - 1))
    # limits that end the walk in the first block, across several, past
    # the last good node and past the candidates
    limit = draw(st.sampled_from([1, 2, 3, 4, 14, max(1, n_cand // 3),
                                  max(1, n_cand // 2), n_cand, n_cand + 5]))
    return scores, feasible, offset, limit, n_cand


@pytest.mark.parametrize("n_blocks", [1, 2, 7, 132])
@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(case=walks())
def test_grid_walk_matches_jax_walk(n_blocks, case):
    scores, feasible, offset, limit, n_cand = case
    win, any_e, pulls = _jax_walk(jnp.asarray(scores), jnp.asarray(feasible),
                                  jnp.int32(offset), jnp.int32(limit),
                                  jnp.int32(n_cand))
    # walk position w is permuted position (w + offset) mod n_cand
    order = (np.arange(n_cand) + offset) % n_cand
    win_w, any_g, pulls_g = grid_walk(scores[order], feasible[order], limit,
                                      n_cand, n_blocks)
    assert any_g == bool(any_e)
    assert pulls_g == int(pulls)
    if any_g:
        assert (win_w + offset) % n_cand == int(win)


# -- K12: the launch follows the mesh's kind ---------------------------------

E, P, C, N_CAND = 3, 4, 64, 60


class _Coop:
    """Stands in for `_cuda.ShardedChainCoop`: records the chain and
    runs the twin's stages on it."""

    made = []

    def __init__(self, c, max_blocks=0):
        self.c, self.max_blocks, self.blocks = c, max_blocks, 0
        _Coop.made.append(self)

    def launch(self):
        sharded_chain_twin(self.c)
        self.blocks = self.max_blocks or 132


class _Stages(tmesh._TwinStages):
    """Stands in for `_cuda.ShardedChainStages`: the twin's stages,
    counted as the staged launcher counts its launches."""

    made = []

    def __init__(self, c):
        self.launched = 0
        _Stages.made.append(self)

    def _count(name):
        def stage(self, *args):
            self.launched += 1
            getattr(tmesh._TwinStages, name)(*args)
        return stage

    begin = _count("begin")
    prologue = _count("prologue")
    score = _count("score")
    walk_bad = _count("walk_bad")
    walk_nd = _count("walk_nd")
    walk_fin = _count("walk_fin")
    commit = _count("commit")
    advance = _count("advance")


def _chain(mesh):
    case = sharded_chain_case(77, C, N_CAND, "everything", E, P)
    return prepare_sharded_chain(mesh, P, sharded_case_args(case, "cpu"),
                                 with_spread=case["spread"] is not None,
                                 spread_even=case["spread_even"])


def _as_card(mesh):
    # the launchers are stand-ins: the chain stays on the CPU, the mesh
    # only claims the card, as the wrapper checks
    mesh.device = torch.device("cuda")
    return mesh


@pytest.fixture
def stand_ins(monkeypatch):
    _Coop.made.clear()
    _Stages.made.clear()
    monkeypatch.setattr(_cuda, "ShardedChainCoop", _Coop)
    monkeypatch.setattr(_cuda, "ShardedChainStages", _Stages)
    saved = (sharded_chained_plan_cuda.launches, sharded_chained_plan_cuda.chunks,
             sharded_chained_plan_cuda.blocks)
    yield
    (sharded_chained_plan_cuda.launches, sharded_chained_plan_cuda.chunks,
     sharded_chained_plan_cuda.blocks) = saved


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_virtual_mesh_chain_is_one_cooperative_launch(stand_ins, d):
    want = _chain(VirtualMesh(d, "cpu"))
    sharded_chain_twin(want)
    c = _chain(VirtualMesh(d, "cpu"))
    _as_card(c.mesh)
    launches, chunks = sharded_chained_plan_cuda.launches, sharded_chained_plan_cuda.chunks
    sharded_chained_plan_cuda(c)
    assert len(_Coop.made) == 1 and _Stages.made == []
    assert sharded_chained_plan_cuda.launches - launches == 1
    assert sharded_chained_plan_cuda.chunks - chunks == 1
    assert stage_launches(c.mesh, E, P) == 1
    assert torch.equal(c.rows, want.rows) and torch.equal(c.pulls, want.pulls)
    assert sharded_chained_plan_cuda.blocks == 132
    # the argument blocks are filled anew for every call, as the path
    # prepares a chain a chunk; the grid cap goes to that launch
    sharded_chained_plan_cuda(c)
    assert len(_Coop.made) == 2
    sharded_chained_plan_cuda(c, _max_blocks=3)
    assert len(_Coop.made) == 3 and _Coop.made[2].max_blocks == 3
    assert sharded_chained_plan_cuda.blocks == 3


def test_dist_mesh_chain_keeps_the_staged_launches(stand_ins, tmp_path):
    import torch.distributed as dist

    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/init",
                            world_size=1, rank=0)
    try:
        for per in (1, 2):
            want = _chain(VirtualMesh(per, "cpu"))
            sharded_chain_twin(want)
            mesh = DistMesh(device="cpu", shards_per_rank=per)
            c = _chain(mesh)
            _as_card(mesh)
            launches = sharded_chained_plan_cuda.launches
            sharded_chained_plan_cuda(c)
            assert _Coop.made == [] and len(_Stages.made) == 1
            staged = stage_launches(mesh, E, P)
            assert staged == E * (1 + per + P * (5 * per + 1))
            assert _Stages.made[0].launched == staged
            assert sharded_chained_plan_cuda.launches - launches == staged
            assert torch.equal(c.rows, want.rows)
            assert torch.equal(c.pulls, want.pulls)
            _Stages.made.clear()
    finally:
        dist.destroy_process_group()


def test_failed_cooperative_launch_raises_without_a_fallback(stand_ins,
                                                             monkeypatch):
    def refused(self):
        raise RuntimeError("nk_sharded_chain_coop launch failed: too many "
                           "blocks in cooperative launch (720)")

    monkeypatch.setattr(_Coop, "launch", refused)
    c = _chain(VirtualMesh(4, "cpu"))
    _as_card(c.mesh)
    launches, chunks = sharded_chained_plan_cuda.launches, sharded_chained_plan_cuda.chunks
    with pytest.raises(DeviceFault, match="cooperative"):
        sharded_chained_plan_cuda(c, _max_blocks=100_000)
    assert _Stages.made == []
    assert (sharded_chained_plan_cuda.launches, sharded_chained_plan_cuda.chunks) == (
        launches, chunks)
    # nothing ran: the chain's rows are still the empty ones
    assert bool((c.rows == -1).all()) and bool((c.pulls == 0).all())


def test_cooperative_chain_takes_at_most_coop_max_shards():
    # the shard table goes to the kernel by value: a mesh of more shards
    # than it holds raises before anything is built or launched
    d = _cuda.COOP_MAX_SHARDS + 1
    case = sharded_chain_case(78, 4 * d, 3 * d, "plain", E, P)
    c = prepare_sharded_chain(VirtualMesh(d, "cpu"), P,
                              sharded_case_args(case, "cpu"))
    _as_card(c.mesh)
    launches, chunks = sharded_chained_plan_cuda.launches, sharded_chained_plan_cuda.chunks
    with pytest.raises(DeviceFault, match=f"1 to {_cuda.COOP_MAX_SHARDS} shards"):
        sharded_chained_plan_cuda(c)
    assert (sharded_chained_plan_cuda.launches, sharded_chained_plan_cuda.chunks) == (
        launches, chunks)
    assert bool((c.rows == -1).all())
