"""The port's bring-up (``workloads/distributed.py``): the gang env
contract against the JAX package's ``config_from_env`` (the twins of its
``TestDistributed``), the gang world of hosts × local ranks (a host's
local ranks follow it; hosts that disagree on their count fail before
the world forms), and the local launcher ``spawn_world`` — results in
rank order, a rank's exception raised with its traceback, and a world
that does not finish failing within its deadline instead of hanging.
"""

import dataclasses
import time

import pytest
import torch
import torch.distributed as dist

from tpu_operator.workloads import distributed as jd
from tpu_operator_torch.workloads import distributed as td

ENVS = {
    "single_host": {},
    "multi_host_gang": {"TPU_WORKER_ID": "3", "TPU_WORKER_HOSTNAMES": "a,b,c,d"},
    "coordinator_override": {"TPU_WORKER_ID": "0", "TPU_WORKER_HOSTNAMES": "a,b",
                             "MEGASCALE_COORDINATOR_ADDRESS": "slice0-coord:9000"},
    "coordinator_without_port": {"TPU_WORKER_HOSTNAMES": "a,b",
                                 "MEGASCALE_COORDINATOR_ADDRESS": "[fd00::1]"},
    "world_spans_slices": {"TPU_WORKER_ID": "1", "TPU_WORKER_HOSTNAMES": "a,b",
                           "MEGASCALE_COORDINATOR_ADDRESS": "slice0-coord:9000",
                           "MEGASCALE_NUM_SLICES": "2", "MEGASCALE_SLICE_ID": "1"},
    "one_host_slices": {"TPU_WORKER_ID": "0", "TPU_WORKER_HOSTNAMES": "a",
                        "MEGASCALE_COORDINATOR_ADDRESS": "c:9", "MEGASCALE_NUM_SLICES": "2",
                        "MEGASCALE_SLICE_ID": "0"},
}
_SLICES = {"TPU_WORKER_ID": "0", "TPU_WORKER_HOSTNAMES": "a,b",
           "MEGASCALE_COORDINATOR_ADDRESS": "c:9", "MEGASCALE_NUM_SLICES": "2"}
BAD_ENVS = {
    "missing_slice_id": _SLICES,
    "slice_id_too_large": {**_SLICES, "MEGASCALE_SLICE_ID": "2"},
    "slice_id_negative": {**_SLICES, "MEGASCALE_SLICE_ID": "-1"},
    "missing_coordinator": {"TPU_WORKER_HOSTNAMES": "a,b", "MEGASCALE_NUM_SLICES": "2"},
}


@pytest.mark.parametrize("name", sorted(ENVS))
def test_config_matches_reference(name):
    want = jd.config_from_env(ENVS[name])
    got = td.config_from_env(ENVS[name])
    assert (got.coordinator_address, got.num_processes, got.process_id, got.needed) == (
        want.coordinator_address, want.num_processes, want.process_id, want.needed)


def test_multislice_world_spans_slices():
    cfg = td.config_from_env(ENVS["world_spans_slices"])
    assert (cfg.num_processes, cfg.process_id) == (4, 3) and cfg.needed
    solo = td.config_from_env(ENVS["one_host_slices"])
    assert solo.needed and (solo.num_processes, solo.process_id) == (2, 0)


@pytest.mark.parametrize("name", sorted(BAD_ENVS))
def test_fail_fast_errors_match_reference(name):
    with pytest.raises(ValueError) as want:
        jd.config_from_env(BAD_ENVS[name])
    with pytest.raises(ValueError) as got:
        td.config_from_env(BAD_ENVS[name])
    assert str(got.value) == str(want.value)


def test_initialize_single_host_is_a_no_op():
    cfg = td.initialize({}, device="cpu")
    assert not cfg.needed and not dist.is_initialized()


def test_initialize_fails_fast_before_joining():
    with pytest.raises(ValueError, match="MEGASCALE_SLICE_ID"):
        td.initialize(BAD_ENVS["missing_slice_id"], device="cpu")
    assert not dist.is_initialized()


def _report():
    return dist.get_rank(), dist.get_world_size(), dist.get_backend(), torch.get_num_threads()


def _fail_on_rank_one():
    if dist.get_rank() == 1:
        raise ArithmeticError("rank one gives up")
    dist.barrier()


def _hang_on_rank_one():
    if dist.get_rank() == 1:
        time.sleep(3600)  # never reaches the barrier
    dist.barrier()


def test_spawn_world_returns_results_in_rank_order():
    got = td.spawn_world(3, _report, device="cpu", timeout=120)
    assert got == [(r, 3, "gloo", 1) for r in range(3)]


def test_spawn_world_raises_a_rank_exception():
    with pytest.raises(RuntimeError, match="of 2 failed(.|\n)*--- rank 1 ---(.|\n)*ArithmeticError"):
        td.spawn_world(2, _fail_on_rank_one, device="cpu", timeout=120)


def test_spawn_world_deadline_stops_a_hung_world():
    start = time.monotonic()
    with pytest.raises((TimeoutError, RuntimeError)):
        td.spawn_world(2, _hang_on_rank_one, device="cpu", timeout=10)
    assert time.monotonic() - start < 40


# rank: (host, local rank, the host's local rank count): host 0 starts one
# rank, host 1 two, so the hosts disagree
MISMATCHED = {0: (0, 0, 1), 1: (1, 0, 2), 2: (1, 1, 2)}


def _host_with_local_ranks(rank, port):
    host, local_rank, local_size = MISMATCHED[rank]
    env = {"TPU_WORKER_HOSTNAMES": "127.0.0.1,127.0.0.1", "TPU_WORKER_ID": str(host)}
    try:
        td.initialize(env, coordinator_port=port, device="cpu", timeout=60,
                      local_rank=local_rank, local_size=local_size)
    except ValueError as e:
        return str(e)
    return None


def test_hosts_with_different_local_rank_counts_fail_before_the_world_forms():
    from tpu_operator_torch.workloads.multiproc import _free_port

    start = time.monotonic()
    got = td.spawn_ranks(3, _host_with_local_ranks, (_free_port(),), device="cpu", timeout=120)
    assert got == ["hosts start different numbers of local ranks (process id: local ranks) "
                   "{'0': 1, '1': 2}; every host must start the same number"] * 3
    assert time.monotonic() - start < 60


def test_gang_config_places_local_ranks_after_their_host():
    cfg = td.config_from_env(ENVS["multi_host_gang"])
    placed = [dataclasses.replace(cfg, local_rank=r, local_size=2) for r in range(2)]
    assert [(c.rank, c.world_size, c.needed) for c in placed] == [(6, 8, True), (7, 8, True)]
    with pytest.raises(ValueError, match=r"local rank 2 outside \[0, 2\)"):
        td.initialize({}, device="cpu", local_rank=2, local_size=2)


def test_spawn_world_needs_a_card_per_rank(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 2 CUDA devices"):
        td.spawn_world(2, _report)
