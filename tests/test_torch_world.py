"""`chip_smoke.py`'s worlds: a store that `build_world` restores from the
recipe's dump (`chip_smoke.dump_tables` / `restore_tables`) equals one
built afresh: nodes, allocs, jobs (every field but the wall-clock
stamps, which differ between any two builds), every secondary index,
the modify-indexes, the node table's rows, columns and generations.
And a restore takes less host time than a build."""
import dataclasses
import time

import numpy as np
import pytest

import chip_smoke
from nomad_tpu_torch.server import Server
from nomad_tpu_torch.state.store import StateStore

N_NODES, N_ALLOCS = 300, 3000


# stamped from the wall clock at each upsert: two fresh builds differ
# there too, and a restored copy keeps the dumped build's stamps
WALL_CLOCK = ("submit_time", "create_time", "modify_time")


def _same_record(x, y) -> None:
    assert type(x) is type(y)
    for f in dataclasses.fields(x):
        if f.name in WALL_CLOCK:
            continue
        u, v = getattr(x, f.name), getattr(y, f.name)
        if dataclasses.is_dataclass(u):
            _same_record(u, v)
        else:
            assert u == v, f.name


def _fresh(classes: bool) -> StateStore:
    store = StateStore()
    chip_smoke._fill_world(store, N_NODES, N_ALLOCS, classes)
    return store


def _same_table(a, b) -> None:
    for name in ("capacity", "n_rows", "row_of", "node_ids", "_free_rows",
                 "generation", "topo_generation", "usage_generation",
                 "_usage_dirty", "_usage_log_gens", "_usage_log_rows",
                 "_row_fingerprints", "device_groups", "device_used",
                 "_device_sig_meta"):
        assert getattr(a, name) == getattr(b, name), name
    for name in ("active", "eligible", "cpu_total", "mem_total", "disk_total",
                 "cpu_used", "mem_used", "disk_used"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert a.device_sigs.values == b.device_sigs.values
    assert sorted(a.columns) == sorted(b.columns)
    for key, col in a.columns.items():
        other = b.columns[key]
        assert np.array_equal(col.codes, other.codes), key
        assert col.interner.values == other.interner.values, key


def _same_store(a: StateStore, b: StateStore) -> None:
    assert a.latest_index() == b.latest_index()
    assert dict(a._table_index) == dict(b._table_index)
    assert list(a.nodes) == list(b.nodes)
    assert list(a.allocs) == list(b.allocs)
    assert list(a.jobs) == list(b.jobs)
    for nid, node in a.nodes.items():
        _same_record(node, b.nodes[nid])
    for aid, alloc in a.allocs.items():
        _same_record(alloc, b.allocs[aid])
    for key, job in a.jobs.items():
        _same_record(job, b.jobs[key])
    for name in ("_allocs_by_node", "_allocs_by_job", "_allocs_by_eval",
                 "_evals_by_job", "_node_touch", "_ports_live",
                 "_ports_by_node"):
        assert dict(getattr(a, name)) == dict(getattr(b, name)), name
    assert a.readiness_generation() == b.readiness_generation()
    assert a.scheduler_config == b.scheduler_config
    _same_table(a.node_table, b.node_table)


@pytest.mark.parametrize("classes", (False, True))
def test_restored_world_equals_a_fresh_build(classes, monkeypatch):
    monkeypatch.setattr(chip_smoke, "WORLDS", {})
    fresh = _fresh(classes)
    for _ in range(2):  # the first call builds and dumps, both restore
        store = StateStore()
        chip_smoke.build_world(store, N_NODES, N_ALLOCS, classes)
        _same_store(store, fresh)
        assert store.node_table.epoch != fresh.node_table.epoch
    assert list(chip_smoke.WORLDS) == [(N_NODES, N_ALLOCS, classes)]
    # restored copies share no object: a write to one leaves the next
    nid = next(iter(store.nodes))
    store.nodes[nid].datacenter = "elsewhere"
    again = StateStore()
    chip_smoke.build_world(again, N_NODES, N_ALLOCS, classes)
    assert again.nodes[nid].datacenter != "elsewhere"


def test_restored_world_in_a_server_equals_a_build_into_it(monkeypatch):
    """Where the phases restore: into a just-constructed Server's store."""
    monkeypatch.setattr(chip_smoke, "WORLDS", {})
    built = Server(num_schedulers=1, device="cpu", heartbeat_ttl=1e9)
    chip_smoke._fill_world(built.store, N_NODES, N_ALLOCS, False)
    restored = Server(num_schedulers=1, device="cpu", heartbeat_ttl=1e9)
    chip_smoke.build_world(restored.store, N_NODES, N_ALLOCS)
    _same_store(restored.store, built.store)


def _tracked(fn) -> int:
    """Objects the cyclic collector tracks that `fn`'s result adds."""
    import gc

    gc.collect()
    before = len(gc.get_objects())
    kept = fn()
    gc.collect()
    n = len(gc.get_objects()) - before
    del kept
    return n


def test_restored_world_holds_as_many_tracked_objects():
    """A restore sets attributes as the constructors do (no extra
    `__dict__` objects), so full collections over a restored world
    walk about as many objects as over a built one."""
    blob = chip_smoke.dump_tables(_fresh(False))

    def restored():
        store = StateStore()
        chip_smoke.restore_tables(store, blob)
        return store

    fresh_n = _tracked(lambda: _fresh(False))
    restored_n = _tracked(restored)
    assert abs(restored_n - fresh_n) <= 0.05 * fresh_n, (restored_n, fresh_n)


def test_restore_needs_a_fresh_store(monkeypatch):
    monkeypatch.setattr(chip_smoke, "WORLDS", {})
    store = StateStore()
    chip_smoke.build_world(store, 20, 50)
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.build_world(store, 20, 50)


def test_restore_is_cheaper_than_a_build():
    """Both with the cyclic collector off, as `build_world` runs them."""
    import gc

    best_build = best_restore = float("inf")
    for _ in range(3):
        gc.collect()
        gc.disable()
        try:
            t0 = time.process_time()
            store = _fresh(False)
            best_build = min(best_build, time.process_time() - t0)
            blob = chip_smoke.dump_tables(store)
            t0 = time.process_time()
            chip_smoke.restore_tables(StateStore(), blob)
            best_restore = min(best_restore, time.process_time() - t0)
        finally:
            gc.enable()
    assert best_restore < best_build, (best_restore, best_build)
