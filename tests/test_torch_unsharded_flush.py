"""The unsharded usage mirror's delta flush and the supervisor's bound
canary probe, on the CPU.

The batch worker's mirror stores a delta's three usage columns from one
staging buffer with one launch of kernel K4 (`ops.batch.RowPatch` over
plain [C] columns, the one-shard case of K13).  Its staging through the
twin is held against `nomad_tpu.ops.batch.patch_rows` applied to each
column, as the JAX worker calls it, on seeded dirty sets, f64 and f32
under x64; its bytes against the JAX worker's count.  A CPU batched
`Server` makes one staging copy a delta flush and no per-column
`patch_rows` call, and its mirror equals a fresh upload.

The supervisor binds its canary probe (`ops.canary.CanaryProbe`) in
`prepare()` on a card only: on a CPU device the probe runs K8's twin and
nothing is bound.  The probe's own protocol (the sum reset before the
launch, one launch a probe, the host block freed only once no probe
uses it) runs here over a stand-in for the library's launch."""
import ctypes
import threading

import numpy as np
import pytest
import torch

import nomad_tpu.ops.batch as jbatch
from nomad_tpu_torch import mock
from nomad_tpu_torch.device import DeviceSupervisor
from nomad_tpu_torch.ops import _cuda
from nomad_tpu_torch.ops import batch as tbatch
from nomad_tpu_torch.ops import canary as tcanary
from nomad_tpu_torch.server import Server

C = 256
DIRTY = (0, 1, 8, 9, C // 8)
DTYPES = [torch.float64, torch.float32]


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int64 if a.dtype == np.float64 else np.int32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_dirty", DIRTY)
def test_flush_staging_matches_jax_patch_rows_per_column(n_dirty, dtype):
    """`RowPatch(None, cols).flush` on the CPU equals the JAX worker's
    flush: the indices padded with C to the pow2 bucket (floor 8), each
    column's values padded with 0, and `patch_rows` once a column; its
    byte count is the JAX worker's, ``idx_p.nbytes + 3 * vals.nbytes``."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    rng = np.random.default_rng(1500 + n_dirty)
    base = [rng.uniform(0.0, 1e4, C).astype(np_dtype) for _ in range(3)]
    rows = np.sort(rng.choice(C, n_dirty, replace=False)).astype(np.int32)
    vals = [rng.uniform(0.0, 1e4, n_dirty).astype(np_dtype) for _ in range(3)]
    cols = tuple(torch.from_numpy(b.copy()) for b in base)
    copies = tbatch.RowPatch.copies
    nbytes = tbatch.RowPatch(None, cols).flush(rows, tuple(vals), C)
    assert tbatch.RowPatch.copies - copies == 1
    width = tbatch.pow2_bucket(n_dirty, floor=8)
    idx_p = np.full(width, C, np.int32)
    idx_p[:n_dirty] = rows
    want_bytes = idx_p.nbytes
    for col, b, v in zip(cols, base, vals):
        vals_p = np.zeros(width, dtype=np_dtype)
        vals_p[:n_dirty] = v
        want_bytes += vals_p.nbytes
        want = np.asarray(jbatch.patch_rows(b, idx_p, vals_p))
        assert want.dtype == np_dtype
        assert np.array_equal(_bits(col.numpy()), _bits(want))
    assert nbytes == want_bytes


def test_bound_patch_over_plain_columns_checks_its_arguments():
    col = torch.zeros(16, dtype=torch.float64)
    patch = tbatch.RowPatch(None, (col, col.clone()))
    assert patch.kernel == "K4" and patch.cols[0] is col
    idx = torch.tensor([3, 16, -1, 5], dtype=torch.int32)
    vals = torch.tensor([[1.0, 2.0, 3.0, 4.0], [5.0, 6.0, 7.0, 8.0]],
                        dtype=torch.float64)
    got = patch(idx, vals)
    assert got == patch.cols
    # padding (C) and a negative row are dropped, as `mode="drop"` does
    assert got[0].tolist() == [0.0] * 3 + [1.0, 0.0, 4.0] + [0.0] * 10
    assert got[1][3] == 5.0 and got[1][5] == 8.0 and got[1].sum() == 13.0
    with pytest.raises(ValueError):
        patch(idx, vals[:1])
    with pytest.raises(TypeError):
        patch(idx.long(), vals)
    with pytest.raises(ValueError):
        tbatch.RowPatch(None, (col,), hostlocal=True)
    with pytest.raises(ValueError):
        tbatch.RowPatch(None, ())
    with pytest.raises(ValueError):
        tbatch.RowPatch(None, (col, torch.zeros(8, dtype=torch.float64)))


def _server():
    server = Server(num_schedulers=1, seed=5, batch_pipeline=True,
                    heartbeat_ttl=1e9, device="cpu")
    for i in range(64):
        node = mock.node(id=f"unsharded-node-{i}")
        node.node_resources.cpu = 4000 + 1000 * (i % 3)
        server.register_node(node)
    return server


def _used(table):
    return (table.cpu_used, table.mem_used, table.disk_used)


def test_server_flush_is_one_staging_copy_and_equals_a_fresh_upload(
        monkeypatch):
    """A CPU batched Server's delta flushes over a run of commits: one
    staging copy each and no per-column `patch_rows` call; afterwards,
    and after a replay of the delta over spoiled rows, the mirror equals
    a fresh upload of the host columns bit for bit."""
    calls = []
    for name in ("patch_rows", "patch_rows_cuda"):
        fn = getattr(tbatch, name)
        monkeypatch.setattr(tbatch, name, lambda *a, _fn=fn, _n=name: (
            calls.append(_n), _fn(*a))[1])
    server = _server()
    server.start()
    try:
        worker = server.workers[0]
        table = server.store.node_table
        worker._device_columns(table)
        cold = worker._usage_cache["gen"]
        flushes = tbatch.RowPatch.flushes
        copies = tbatch.RowPatch.copies
        for i in range(6):
            job = mock.job(id=f"unsharded-{i}")
            job.task_groups[0].count = 3
            server.register_job(job)
            assert server.drain_to_idle(60)
            worker._device_columns(table)
        run_flushes = tbatch.RowPatch.flushes - flushes
        assert run_flushes >= 6
        assert tbatch.RowPatch.copies - copies == run_flushes
        assert calls == []
        cache = worker._usage_cache
        for col, host in zip(cache["cols"][3:], _used(table)):
            assert np.array_equal(_bits(col.numpy()), _bits(host))
        # replay the whole delta since the cold sync over spoiled rows
        _gen, dirty = server.store.usage_delta_since(cold)
        assert 0 < len(dirty) <= 64
        for col in cache["cols"][3:]:
            col[torch.tensor(sorted(dirty))] = -1.0
        cache["gen"] = cold
        flushes, copies = tbatch.RowPatch.flushes, tbatch.RowPatch.copies
        width = tbatch.pow2_bucket(len(dirty), floor=8)
        cols = worker._device_columns(table)
        assert tbatch.RowPatch.flushes - flushes == 1
        assert tbatch.RowPatch.copies - copies == 1
        assert server.metrics.get_gauge("batch_worker.mirror_sync_bytes") == (
            width * 4 + 3 * width * 8)
        for col, host in zip(cols[3:], _used(table)):
            assert np.array_equal(_bits(col.numpy()), _bits(host))
    finally:
        server.stop()


def test_flush_is_rebound_after_a_full_resync_and_a_bulk_upload(monkeypatch):
    """The mirror's `RowPatch` is bound to the usage tensors of the latest
    full or bulk sync: a new node (a full resync) and a wide churn (a
    bulk upload) each rebind it to the new tensors, a delta keeps it and
    stores into them."""
    server = _server()
    try:
        worker = server.workers[0]
        table = server.store.node_table

        def bound():
            cache = worker._usage_cache
            patch = cache["patch"]
            assert all(a is b for a, b in zip(patch.cols, cache["cols"][3:]))
            assert len(patch.cols) == 3 and patch.kernel == "K4"
            return patch

        worker._device_columns(table)
        first = bound()
        worker._device_columns(table)  # nothing dirty
        assert bound() is first
        server.register_node(mock.node(id="unsharded-node-new"))
        worker._device_columns(table)  # a full resync
        full = bound()
        assert full is not first
        gen = worker._usage_cache["gen"]
        monkeypatch.setattr(server.store, "usage_delta_since",
                            lambda _g: (gen + 1, list(range(table.capacity))))
        worker._device_columns(table)  # a bulk upload
        bulk = bound()
        assert bulk is not full and bulk.cols[0] is not full.cols[0]
        table.cpu_used[5] += 250.0
        monkeypatch.setattr(server.store, "usage_delta_since",
                            lambda _g: (gen + 2, [0, 5]))
        flushes = tbatch.RowPatch.flushes
        cols = worker._device_columns(table)  # a delta
        assert bound() is bulk and tbatch.RowPatch.flushes - flushes == 1
        assert cols[3] is bulk.cols[0]
        assert cols[3][5].item() == table.cpu_used[5]
    finally:
        server.stop()


# -- the supervisor's canary probe --------------------------------------------


def test_probe_on_a_cpu_device_runs_the_twin_and_binds_nothing():
    sup = DeviceSupervisor(expected=True, device=torch.device("cpu"),
                           probe_interval_s=3600.0)
    before = tcanary.canary_cuda.launches
    sup.prepare()
    assert sup._canary_probe is None and sup._canary_stream is None
    assert sup._default_canary() == 16.0
    assert all(sup.probe_once() for _ in range(3))
    assert sup.canary_ok == 3 and tcanary.canary_cuda.launches == before
    assert sup._canary_probe is None
    sup.close()
    with pytest.raises(ValueError):
        tcanary.CanaryProbe("cpu")


class _FakeLaunch:
    """Stands in for `_cuda.CanaryLaunch`: the block is host memory of
    its own, and a call runs K8's arithmetic in its twin's order."""

    instances = []

    def __init__(self, n, threads, dtype, device, stream):
        ctype = ctypes.c_double if dtype == torch.float64 else ctypes.c_float
        self.np_dtype = np.float64 if dtype == torch.float64 else np.float32
        self.block = (ctype * (2 * n + 1))()
        self.host = ctypes.addressof(self.block)
        self.n, self.threads = n, threads
        self.seen = []  # the sum as each launch found it
        self.gate = None  # an Event a launch waits on, when set
        self.stores = True  # False: a launch that runs and stores nothing
        self.freed = False
        _FakeLaunch.instances.append(self)

    def __call__(self):
        assert not self.freed
        if self.gate is not None:
            self.gate.wait(10.0)
        a = np.frombuffer(self.block, dtype=self.np_dtype)
        self.seen.append(float(a[2 * self.n]))
        if not self.stores:
            return
        out, total = tcanary.canary_plain(torch.from_numpy(a[:self.n].copy()))
        a[self.n:2 * self.n] = out.numpy()
        a[2 * self.n] = total.item()

    def free(self):
        self.freed = True


class _FakeEvent:
    def record(self, stream=None):
        pass

    def synchronize(self):
        pass


@pytest.fixture
def fake_probe(monkeypatch):
    _FakeLaunch.instances.clear()
    monkeypatch.setattr(_cuda, "CanaryLaunch", _FakeLaunch)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    return _FakeLaunch.instances


@pytest.mark.parametrize("dtype", DTYPES)
def test_bound_probe_resets_the_sum_and_launches_once(fake_probe, dtype):
    """A probe sets the sum to NaN before its launch (so a launch that
    stores nothing fails the probe) and makes exactly one launch,
    counted on `canary_cuda.launches`; the block holds the inputs, the
    outputs and the sum, equal to the twin's."""
    probe = tcanary.CanaryProbe("cuda:0", dtype=dtype, stream=object())
    launch = fake_probe[0]
    before = tcanary.canary_cuda.launches
    assert [probe.probe() for _ in range(3)] == [16.0] * 3
    assert tcanary.canary_cuda.launches == before + 3
    assert len(launch.seen) == 3 and all(np.isnan(x) for x in launch.seen)
    assert np.array_equal(probe.out(), np.full(8, 2.0))
    a = np.random.default_rng(7).normal(size=1500)
    other = tcanary.CanaryProbe("cuda:0", values=a, dtype=dtype,
                                stream=object())
    total = other.probe()
    want_out, want_total = tcanary.canary_plain(torch.from_numpy(a).to(dtype))
    assert np.array_equal(_bits(other.out()), _bits(want_out.numpy()))
    assert np.array_equal(_bits(np.array([total], dtype=other.out().dtype)),
                          _bits(want_total.reshape(1).numpy()))
    # a launch that stores nothing reads as NaN, not as the last answer
    launch.stores = False
    assert np.isnan(probe.probe())
    probe.close()
    other.close()
    assert launch.freed



def test_bound_probe_is_freed_only_once_no_probe_uses_it(fake_probe):
    """`close` while a probe is parked in its launch (a wedged card)
    leaves the block to that probe, which frees it when it returns; a
    probe after `close` raises without touching the block."""
    probe = tcanary.CanaryProbe("cuda:0", stream=object())
    launch = fake_probe[0]
    launch.gate = threading.Event()
    answers = []
    parked = threading.Thread(target=lambda: answers.append(probe.probe()))
    parked.start()
    while not probe._users:
        threading.Event().wait(0.01)
    probe.close()
    assert not launch.freed
    with pytest.raises(RuntimeError):
        probe.probe()
    launch.gate.set()
    parked.join(10.0)
    assert answers == [16.0] and launch.freed
    probe.close()  # a second close is a no-op
