"""`chip_smoke.py`'s helper processes: each twin or reference run that a
check compares against is computed by exactly one helper, in the order
the phases ask for it; a helper saves each result under its key and
refuses to reach a kernel; a phase's wait names the helper that failed."""
import collections

import pytest
import torch

import chip_smoke
from nomad_tpu_torch.ops import _cuda


def _keys(name):
    return [key for key, _fn, _args in chip_smoke.helper_jobs(name)]


def test_every_result_has_one_helper():
    keys = [k for name in chip_smoke.HELPER_THREADS for k in _keys(name)]
    dup = [k for k, n in collections.Counter(keys).items() if n > 1]
    assert not dup
    twins = [key for key, _fn, _args in chip_smoke.twin_jobs()]
    assert sorted(_keys("twins-a") + _keys("twins-b")) == sorted(twins)
    # twins-a: the storm solves' twins (K5's, K14's)
    assert all(k.startswith(("k5-", "k14-")) for k in _keys("twins-a"))
    assert any(k.startswith("k14-") for k in _keys("twins-a"))


def test_card_twins_cover_both_dtypes_of_each_check():
    from nomad_tpu_torch.ops.cases import CHAIN_SCENARIOS, SHARDED_CHAIN_SCENARIOS

    card = _keys("card-twins")
    by_phase = collections.Counter(k.split("-")[1] for k in card)
    assert by_phase["k3"] == 2 * len(CHAIN_SCENARIOS) * len(chip_smoke.CHAIN_SHAPES)
    assert by_phase["k5"] == 2 * len(chip_smoke._k5_scenarios()) * len(
        chip_smoke.STORM_ROWS)
    assert by_phase["k9"] == 2 * len(chip_smoke.K9_SCENARIOS) * len(
        chip_smoke.BATCHED_SHAPES)
    assert by_phase["k9s"] == 2 * len(chip_smoke.K9_SHARED_SHAPES)
    assert by_phase["k10"] == 2 * len(chip_smoke.K10_CASES) * len(
        chip_smoke.BATCHED_SHAPES)
    assert by_phase["k12"] == len(SHARDED_CHAIN_SCENARIOS) * (
        len(chip_smoke.K12_COUNTS) + 1) + 2
    # K14: both row counts at every D (f64), f32 and weighted at D = 8
    assert by_phase["k14"] == 2 * len(chip_smoke.K14_COUNTS) + 2
    # the k3 twins come first: phase k3 is the first to ask
    assert card[0].startswith("card-k3-float64-")


def test_host_runs_in_the_order_the_phases_ask():
    assert _keys("host-a") == ["main-cpu", "main-oracle", "server-oracle",
                               "storm-cpu", "preempt-cpu", "preempt-oracle",
                               "bridge-cpu", "device-cpu"]
    assert _keys("host-b") == ["policy-cpu", "policy-oracle", "policy-storm-cpu",
                               "entry-dryrun-cpu", "multihost-cpu"]
    # the entry phase's batched plan: its one CPU twin, last of twins-b's
    assert _keys("twins-b")[-1] == "entry-k10"


def test_helper_main_saves_each_result(tmp_path, monkeypatch):
    monkeypatch.setattr(_cuda, "build_all", _cuda.build_all)
    monkeypatch.setattr(_cuda, "library", _cuda.library)
    monkeypatch.setattr(chip_smoke, "HELPER_THREADS", {"h": 1})
    monkeypatch.setattr(chip_smoke, "helper_jobs", lambda name: [
        ("double", lambda x: torch.arange(3) * x, (2,)),
        ("plain", lambda: {"a": [1, 2]}, ()),
    ])
    assert chip_smoke.helper_main("h", str(tmp_path)) == 0
    assert torch.equal(torch.load(tmp_path / "double.pt"), torch.tensor([0, 2, 4]))
    assert torch.load(tmp_path / "plain.pt", weights_only=False) == {"a": [1, 2]}
    assert float((tmp_path / "DONE").read_text()) >= 0.0
    assert not list(tmp_path.glob("*.tmp"))


def test_helper_main_refuses_a_kernel(tmp_path, monkeypatch):
    monkeypatch.setattr(_cuda, "build_all", _cuda.build_all)
    monkeypatch.setattr(_cuda, "library", _cuda.library)
    monkeypatch.setattr(chip_smoke, "HELPER_THREADS", {"h": 1})
    monkeypatch.setattr(chip_smoke, "helper_jobs", lambda name: [
        ("kernel", lambda: _cuda.library("score_select"), ()),
    ])
    with pytest.raises(chip_smoke.SmokeFailure, match="reached a kernel"):
        chip_smoke.helper_main("h", str(tmp_path))
    assert not (tmp_path / "DONE").exists()


class _Exited:
    returncode = 3

    def poll(self):
        return 3


def test_a_wait_names_the_helper_that_failed(tmp_path, monkeypatch):
    monkeypatch.setattr(chip_smoke, "HELPER_DIR", tmp_path)
    helper = chip_smoke.Helper("host-a")
    helper.dir.mkdir()
    (helper.dir / "log.txt").write_text("Traceback: boom\n")
    helper.proc = _Exited()
    with pytest.raises(chip_smoke.SmokeFailure, match="host-a exited 3.*boom"):
        helper.get("main-cpu")
    helpers = chip_smoke.Helpers()
    with pytest.raises(chip_smoke.SmokeFailure, match="no helper computes"):
        helpers.get("main-cpu")


def test_a_finished_result_is_read_after_its_helper_exits(tmp_path, monkeypatch):
    monkeypatch.setattr(chip_smoke, "HELPER_DIR", tmp_path)
    helper = chip_smoke.Helper("twins-a")
    helper.dir.mkdir()
    torch.save(torch.ones(2), helper.dir / "k5-x.pt")
    helper.proc = _Exited()
    assert torch.equal(helper.get("k5-x"), torch.ones(2))


def test_to_cpu_keeps_the_structure():
    Out = collections.namedtuple("Out", "rows carry")
    got = chip_smoke._to_cpu(Out(torch.ones(2), (torch.zeros(1), None)))
    assert type(got) is Out
    assert torch.equal(got.rows, torch.ones(2)) and got.carry[1] is None


class _Built(Exception):
    pass


def test_the_cpu_storm_runs_hold_their_lease_past_their_drain(monkeypatch):
    import nomad_tpu_torch.server as server_mod

    seen = []

    def fake_server(**kwargs):
        seen.append(kwargs)
        raise _Built

    monkeypatch.setattr(server_mod, "Server", fake_server)
    for device in ("cpu", None):
        with pytest.raises(_Built):
            chip_smoke.run_storm(device, True, "lease")
    assert seen[0]["nack_timeout"] > chip_smoke.STORM_DRAIN_S
    # the card's run keeps the broker's default lease
    assert "nack_timeout" not in seen[1]
