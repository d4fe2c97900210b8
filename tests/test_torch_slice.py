"""The port's ``slice`` validator component (``validator/main.py``)
against the JAX package's.

- ``COMPONENTS["slice"]`` is the reference's (same status file);
- the psum floor fires right after the all-reduce on more than one card
  (the twin of ``tests/test_validator.py``'s floor test, with the gang
  world and the all-reduce stubbed);
- ``validate_slice`` whole: a pod with two local "cards" (two gloo ranks
  on the CPU, ``local_devices`` patched to name two) starts two ranks
  and reports from local rank 0, through ``run_component``, which writes
  ``slice-ready``; and a pod with one card in the calling process (a
  world of one rank), with the reference's report keys.
"""

import contextlib
import types

import pytest
import torch
import torch.distributed as dist

from tpu_operator.validator import main as rv
from tpu_operator_torch.validator import main as tv
from tpu_operator_torch.validator import status as status_files


def test_slice_component_is_the_references():
    assert tv.COMPONENTS["slice"] == (tv.validate_slice, "slice-ready")
    assert tv.COMPONENTS["slice"][1] == rv.COMPONENTS["slice"][1]
    assert tv.COMPONENTS["smoke"] == (tv.validate_smoke, None)


def test_slice_fails_below_psum_floor(tmp_path, monkeypatch):
    """The real validate_slice with the gang world and the collective
    measurement stubbed to a degraded multi-card report: the floor check
    fires right after the all-reduce, before the heavyweight checks."""
    from tpu_operator_torch.workloads import allreduce, distributed, ringattention

    @contextlib.contextmanager
    def gang(**kwargs):
        yield types.SimpleNamespace(num_processes=2, process_id=0)

    def unreachable(**kwargs):
        raise AssertionError("the floor must fire before the ring check")

    monkeypatch.setattr(distributed, "gang_world", gang)
    monkeypatch.setattr(allreduce, "run_allreduce",
                        lambda **kw: {"devices": 8, "peak_busbw_gbps_per_chip": 12.5})
    monkeypatch.setattr(ringattention, "run_ring_attention_check", unreachable)
    ctx = tv.Context(validation_dir=str(tmp_path), device="cpu", min_psum_gbps_per_chip=40.0)
    with pytest.raises(RuntimeError, match="psum bus GB/s/chip.*below"):
        tv.validate_slice(ctx)
    with pytest.raises(RuntimeError, match="psum bus GB/s/chip.*below"):
        tv.run_component("slice", ctx, max_attempts=1)
    assert status_files.read_status("slice-ready", str(tmp_path)) is None


def test_no_floor_on_one_card(tmp_path, monkeypatch):
    """One card measures a local copy: the floor is not applied."""
    from tpu_operator_torch.workloads import allreduce

    monkeypatch.setattr(allreduce, "run_allreduce",
                        lambda **kw: {"devices": 1, "peak_busbw_gbps_per_chip": 0.5})
    ctx = tv.Context(validation_dir=str(tmp_path), device="cpu", min_psum_gbps_per_chip=40.0)
    report = tv.validate_slice(ctx)
    assert report["devices"] == 1 and report["collectives"]["ok"]
    assert not dist.is_initialized()  # the component leaves its world


def _held_to_the_bars(report, devices):
    assert report["ok"] and report["devices"] == devices and report["platform"] == "cpu"
    assert report["correctness_only"] == (devices == 1)
    assert [r["size_mb"] for r in report["results"]] == [1, 4, 16, 64]
    assert report["ring_attention"]["max_abs_err"] <= 2e-4
    assert report["ring_attention"]["seq_len"] == max(128, 32 * devices)
    assert report["ring_flash_attention"]["max_abs_err"] <= 2e-4
    assert report["pipeline"]["ok"] and report["pipeline"]["stages"] == devices
    assert report["flash_attention"]["max_abs_err"] <= 2e-2
    assert report["flash_attention"]["segment_max_abs_err"] <= 2e-2
    assert max(report["collectives"]["errors"].values()) <= 1e-5
    assert report["collectives"]["devices"] == devices


@pytest.fixture(scope="module")
def two_card_pod(tmp_path_factory):
    """run_component("slice") on a pod whose two local cards are CPU
    ranks, meeting at a free loopback port."""
    from tpu_operator_torch.workloads.multiproc import _free_port

    tmp = str(tmp_path_factory.mktemp("slice"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tv, "local_devices", lambda device: [torch.device("cpu")] * 2)
        mp.setenv("MEGASCALE_COORDINATOR_ADDRESS", f"127.0.0.1:{_free_port()}")
        report = tv.run_component("slice", tv.Context(validation_dir=tmp, device="cpu"),
                                  max_attempts=1)
    return report, status_files.read_status("slice-ready", tmp)


def test_two_card_pod_passes_at_the_references_bars(two_card_pod):
    report, written = two_card_pod
    _held_to_the_bars(report, 2)
    assert report["hosts"] == 1 and report["process_id"] == 0
    assert written == report


def test_one_card_pod_runs_in_this_process(tmp_path):
    report = tv.run_component("slice", tv.Context(validation_dir=str(tmp_path), device="cpu"),
                              max_attempts=1)
    _held_to_the_bars(report, 1)
    assert status_files.read_status("slice-ready", str(tmp_path)) == report
    assert not dist.is_initialized()
    # the reference's report keys, plus nothing of its own
    assert set(report) == {"devices", "platform", "results", "peak_busbw_gbps_per_chip",
                           "correctness_only", "ok", "hosts", "process_id", "ring_attention",
                           "pipeline", "flash_attention", "ring_flash_attention", "collectives"}
