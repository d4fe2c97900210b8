"""The trainer's persistent world of ranks
(``tpu_operator_torch/workloads/distributed.RankPool``) on gloo CPU ranks:
the first function's results, a rank's state kept between calls,
collectives across calls, and every failure (a rank that raises, dies or
hangs, a first function that fails) stops the pool and raises within its
deadline.

No JAX here: the ranks import this module for its functions.
"""

import os
import time

import pytest
import torch
import torch.distributed as dist

from tpu_operator_torch.workloads.distributed import RankPool


_STATE = {}  # this rank's, in its own process


def _setup(base):
    _STATE["value"] = base + dist.get_rank()
    return _STATE["value"]


def _bad_setup():
    raise ValueError("setup refused")


def _add(amount):
    _STATE["value"] += amount
    t = torch.tensor([float(_STATE["value"])])
    dist.all_reduce(t)  # every rank's value, summed
    return _STATE["value"], float(t)


def _raise_on(rank):
    if dist.get_rank() == rank:
        raise ValueError(f"rank {rank} refused")
    return "ok"


def _exit_on(rank):
    if dist.get_rank() == rank:
        os._exit(3)
    return "ok"


def _sleep(seconds):
    time.sleep(seconds)


def test_state_and_collectives_persist_between_calls():
    pool = RankPool(2, _setup, (10,), device="cpu", timeout=60)
    try:
        assert pool.first == [10, 11]
        assert pool.call(_add, 1) == [(11, 23.0), (12, 23.0)]
        assert pool.call(_add, 2) == [(13, 27.0), (14, 27.0)]
    finally:
        pool.close()
    assert pool.closed
    with pytest.raises(RuntimeError, match="closed"):
        pool.call(_add, 1)
    pool.close()  # idempotent


@pytest.mark.parametrize("fn,match", [(_raise_on, "rank 1 refused"),
                                      (_exit_on, "exited with code 3")])
def test_a_failed_rank_stops_the_pool_and_raises(fn, match):
    pool = RankPool(2, _setup, (0,), device="cpu", timeout=60)
    start = time.monotonic()
    with pytest.raises(RuntimeError, match=match):
        pool.call(fn, 1)
    assert pool.closed
    assert time.monotonic() - start < 30


def test_a_call_past_the_deadline_stops_the_pool():
    pool = RankPool(2, _setup, (0,), device="cpu", timeout=60)
    pool.timeout = 3  # the start may take longer on a loaded machine; the call may not
    start = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish within 3"):
        pool.call(_sleep, 120)
    assert pool.closed
    assert time.monotonic() - start < 30


def test_a_failed_setup_raises():
    with pytest.raises(RuntimeError, match="setup refused"):
        RankPool(2, _bad_setup, device="cpu", timeout=60)
