"""The port's gang check (``workloads/multiproc.py``) against the JAX
package's launcher: its ``ValueError``s and ``_localize_gang_env`` on the
same inputs, and live runs on the CPU driven by the env the reference's
``SliceManagerAgent`` renders, as ``tests/test_workloads.py`` drives the
reference.

Each worker of the gang is one process per local card (here: gloo ranks
on the CPU), so a run of W workers of K ranks is a world of W·K ranks:
2 workers of 2 ranks from a one-slice gang env, and 2 slices of 2 hosts
of one rank each from the multi-slice envs (the DCN coordinator
rewritten to loopback). The runs are made once, in a module fixture. A
worker that dies at start stops the gang within the launcher's grace,
not at its deadline.
"""

import time

import pytest
import torch

from tpu_operator.workloads import multiproc as rm
from tpu_operator_torch.workloads import multiproc as tm


def _gang_envs(pools, multi_slice):
    """The gang ConfigMaps the reference's slice manager renders for
    ``pools`` of two v5e 2x4 hosts each."""
    from tpu_operator import consts
    from tpu_operator.agents.slice_manager_agent import SliceManagerAgent
    from tpu_operator.kube.fake import FakeClient
    from tpu_operator.kube.sim import make_tpu_node

    client = FakeClient()
    for pool in pools:
        for i in range(2):
            node = make_tpu_node(f"{pool}-{i}", "tpu-v5-lite-podslice", "2x4", nodepool=pool)
            node["metadata"]["labels"][consts.TPU_PRESENT_LABEL] = "true"
            client.create(node)
    kwargs = {"multi_slice": True, "coordinator_port": 8476} if multi_slice else {}
    names = SliceManagerAgent(client, "tpu-operator", **kwargs).reconcile_once()
    return [client.get("v1", "ConfigMap", f"{n}-gang", "tpu-operator")["data"] for n in names]


@pytest.fixture(scope="module")
def runs():
    (gang_env,) = _gang_envs(["pool-a"], multi_slice=False)
    slice_envs = _gang_envs(["pool-a", "pool-b"], multi_slice=True)
    return {
        "gang": tm.run_multiprocess_check(num_workers=int(gang_env["TPU_SLICE_HOSTS"]),
                                          devices_per_worker=2, gang_env=gang_env,
                                          timeout=120, device="cpu"),
        "slices": tm.run_multislice_check(num_slices=2, devices_per_worker=1,
                                          gang_envs=slice_envs, timeout=120, device="cpu"),
    }


def test_rendered_gang_env_drives_a_two_worker_world(runs):
    report = runs["gang"]
    assert report["ok"] and report["psum_ok"]
    assert report["num_workers"] == 2 and report["global_devices"] == 4
    assert report["ring_attention_max_err"] < 1e-4
    # every rank saw the same world, at rank process_id x 2 + local rank
    workers = report["workers"]
    assert {w["num_processes"] for w in workers} == {2}
    assert sorted((w["rank"], w["process_id"], w["local_rank"]) for w in workers) == [
        (0, 0, 0), (1, 0, 1), (2, 1, 0), (3, 1, 1)]
    assert {w["psum_got"] for w in workers} == {float((1 + 2) * 2)}
    assert all(w["platform"] == "cpu" and w["psum_chain_ms"] > 0 for w in workers)


def test_gang_telemetry_merges_one_report_per_host(runs):
    gang = runs["gang"]["gang_telemetry"]
    assert gang["hosts"] == 2
    assert set(gang["per_host_step_p50_s"]) == {"worker-0", "worker-1"}
    assert gang["straggler_ratio"] >= 1.0


def test_two_slice_world_from_rendered_gang_envs(runs):
    report = runs["slices"]
    assert report["ok"] and report["psum_ok"] and report["num_slices"] == 2
    # 2 slices x 2 hosts x 1 rank: the world spans every slice
    assert report["global_devices"] == 4 and report["num_workers"] == 4
    assert {w["num_processes"] for w in report["workers"]} == {4}
    assert {w["process_id"] for w in report["workers"]} == {0, 1, 2, 3}
    assert report["ring_attention_max_err"] < 1e-4


@pytest.mark.parametrize("env", [
    {"TPU_WORKER_HOSTNAMES": "a,b,c"},
    {"TPU_WORKER_HOSTNAMES": "a,b", "MEGASCALE_COORDINATOR_ADDRESS": "dcn:1"},
    {"TPU_WORKER_HOSTNAMES": "a", "MEGASCALE_COORDINATOR_ADDRESS": "dcn",
     "MEGASCALE_NUM_SLICES": "2"},
])
def test_localize_gang_env_matches_the_reference(env):
    assert tm._localize_gang_env(env, 4321) == rm._localize_gang_env(env, 4321)


_SLICE = {"TPU_WORKER_HOSTNAMES": "a", "MEGASCALE_COORDINATOR_ADDRESS": "c",
          "MEGASCALE_NUM_SLICES": "2"}
# name: (launcher, its arguments); every one raises before starting a process
BAD_LAUNCHES = {
    "host_count": ("run_multiprocess_check",
                   dict(num_workers=2, gang_env={"TPU_WORKER_HOSTNAMES": "a,b,c"})),
    "multislice_env": ("run_multiprocess_check",
                       dict(num_workers=1, gang_env=dict(_SLICE, MEGASCALE_SLICE_ID="0"))),
    "env_count": ("run_multislice_check", dict(num_slices=3, gang_envs=[
        dict(_SLICE, MEGASCALE_SLICE_ID="0"), dict(_SLICE, MEGASCALE_SLICE_ID="1")])),
    "uneven_slices": ("run_multislice_check", dict(num_slices=2, gang_envs=[
        dict(_SLICE, MEGASCALE_SLICE_ID="0"),
        dict(_SLICE, MEGASCALE_SLICE_ID="1", TPU_WORKER_HOSTNAMES="a,b")])),
    "declared_slices": ("run_multislice_check", dict(num_slices=2, gang_envs=[
        dict(_SLICE, MEGASCALE_SLICE_ID="0"),
        dict(_SLICE, MEGASCALE_SLICE_ID="1", MEGASCALE_NUM_SLICES="3")])),
    "duplicate_slice_ids": ("run_multislice_check", dict(num_slices=2, gang_envs=[
        dict(_SLICE, MEGASCALE_SLICE_ID="0"), dict(_SLICE, MEGASCALE_SLICE_ID="0")])),
}


@pytest.mark.parametrize("name", sorted(BAD_LAUNCHES))
def test_launcher_errors_match_the_reference(name):
    launcher, kwargs = BAD_LAUNCHES[name]
    with pytest.raises(ValueError) as want:
        getattr(rm, launcher)(**kwargs)
    with pytest.raises(ValueError) as got:
        getattr(tm, launcher)(device="cpu", **kwargs)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("launcher, kwargs", [
    ("run_multiprocess_check", dict(num_workers=2, devices_per_worker=1)),
    ("run_multislice_check", dict(num_slices=2, devices_per_worker=2)),
])
def test_cuda_needs_a_card_per_rank(monkeypatch, launcher, kwargs):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="CUDA devices, one each; have 1"):
        getattr(tm, launcher)(device="cuda", **kwargs)


def test_a_failed_worker_stops_the_gang_within_the_grace():
    """Worker 1 dies at start (a port that does not parse); worker 0 waits
    for it at the rendezvous and is stopped ``_GRACE_S`` later, long
    before the gang's deadline."""
    base = tm._localize_gang_env({"TPU_WORKER_HOSTNAMES": "a,b"}, tm._free_port())
    envs = [dict(base, TPU_WORKER_ID="0"),
            dict(base, TPU_WORKER_ID="1", TPU_COORDINATOR_PORT="not-a-port")]
    start = time.monotonic()
    with pytest.raises(RuntimeError) as failed:
        tm._launch_workers(envs, 1, timeout=300, dev=torch.device("cpu"))
    assert time.monotonic() - start < 60
    message = str(failed.value)
    assert "worker 1 local rank 0: rc=1" in message and "not-a-port" in message
    assert "worker 0 local rank 0: timeout" in message and "hint:" in message


def test_free_port_is_below_the_ephemeral_range():
    """A coordinator port from the ephemeral range could be taken by any
    connection in the seconds before its worker binds it."""
    with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
        low = int(f.read().split()[0])
    ports = {tm._free_port() for _ in range(16)}
    assert all(low // 2 <= p < low for p in ports) and len(ports) > 1
