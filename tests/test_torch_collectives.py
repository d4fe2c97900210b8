"""The port's all-reduce and collective-primitive checks
(``workloads/allreduce.py``, ``workloads/collectives.py``) on one 4-rank
gloo world, against the JAX package's on its virtual CPU devices.

The world runs the all-reduce over all 4 ranks and over a group of 2,
the collectives over the world and over the ``x`` axis of a (rep 2, x 2)
mesh, the ``ValueError`` for a size that does not divide, and the
collectives once per corrupted primitive (patched on every rank, for that
call only): the check must raise for every one, so it is not vacuous. The tests assert on what the ranks returned: the same report
keys as the reference, the nccl-tests busbw formula, errors within the
reference's bar of 1e-5, and the reference's error message.
"""

import ast
import contextlib
import functools

import pytest
import torch.distributed as dist

from tpu_operator_torch.workloads import allreduce as tar
from tpu_operator_torch.workloads import collectives as tco
from tpu_operator_torch.workloads import spmd
from tpu_operator_torch.workloads.distributed import spawn_world

# JAX and the JAX package are imported inside the reference-side
# functions: the ranks import this module to find their function.

N = 4


@contextlib.contextmanager
def _patched(owner, name, replacement):
    original = getattr(owner, name)
    setattr(owner, name, replacement(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def _reversed_gather(original):
    def gather(out, x, group=None):
        original(out, x, group=group)
        out.copy_(out.view(dist.get_world_size(group), -1).flip(0).reshape(-1))
    return gather


def _other_chunk(original):
    def scatter(out, x, group=None):
        full = x.clone()
        dist.all_reduce(full, group=group)
        me = dist.get_rank(group)
        n = dist.get_world_size(group)
        out.copy_(full.view(n, -1)[(me + 1) % n])
    return scatter


def _untransposed(original):
    def all_to_all(out, x, group=None):
        out.copy_(x)
    return all_to_all


def _two_hops(original):
    return lambda tensors, group, shift: original(tensors, group, 2 * shift)


def _nudged_sum(original):
    def all_reduce(x, op=dist.ReduceOp.SUM, group=None):
        original(x, op=op, group=group)
        if op == dist.ReduceOp.SUM and x.numel() > 1:
            x.add_(1e-3)
    return all_reduce


# case: (owner of the primitive, its name, the corrupted version)
CORRUPTIONS = {
    "psum": (dist, "all_reduce", _nudged_sum),
    "all_gather": (dist, "all_gather_into_tensor", _reversed_gather),
    "reduce_scatter": (dist, "reduce_scatter_tensor", _other_chunk),
    "all_to_all": (dist, "all_to_all_single", _untransposed),
    "ppermute": (spmd, "_shift", _two_hops),
}


def _world_checks():
    """One rank's results of every case (the tests assert on them)."""
    out = {"allreduce": tar.run_allreduce(sizes_mb=(1,), iters=2, device="cpu")}
    pair = dist.new_group([0, 1])  # every rank takes part in making it
    if dist.get_rank() < 2:
        out["allreduce_pair"] = tar.run_allreduce(sizes_mb=(1,), group=pair, iters=1,
                                                  device="cpu")
    out["collectives"] = tco.run_collectives_check(device="cpu")
    mesh = spmd.named_mesh(rep=2, x=2)
    out["collectives_x"] = tco.run_collectives_check(mesh, per_device=6, axis_name="x",
                                                     device="cpu")
    out["value_errors"] = []
    for per_device in (2047, 0):
        try:
            tco.run_collectives_check(per_device=per_device, device="cpu")
        except ValueError as e:
            out["value_errors"].append(str(e))
    out["corrupted"] = {}
    for case, (owner, name, corrupt) in CORRUPTIONS.items():
        with _patched(owner, name, corrupt):
            try:
                tco.run_collectives_check(device="cpu")
                out["corrupted"][case] = None
            except RuntimeError as e:
                out["corrupted"][case] = str(e)
    return out


@pytest.fixture(scope="module")
def world():
    return spawn_world(N, _world_checks, device="cpu", timeout=240)


@functools.lru_cache(maxsize=None)
def _reference_allreduce():
    import jax

    from tpu_operator.workloads.allreduce import run_allreduce

    return run_allreduce(sizes_mb=(1,), devices=jax.devices("cpu")[:N], iters=1)


@functools.lru_cache(maxsize=None)
def _reference_collectives(per_device):
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from tpu_operator.workloads.collectives import run_collectives_check

    mesh = Mesh(np.array(jax.devices("cpu")[:N]), ("x",))
    try:
        return run_collectives_check(mesh, per_device=per_device)
    except ValueError as e:
        return str(e)


def test_allreduce_report_matches_the_reference_keys(world):
    want = _reference_allreduce()
    for rank_out in world:
        got = rank_out["allreduce"]
        assert set(got) == set(want)
        assert set(got["results"][0]) == set(want["results"][0])
        assert (got["devices"], got["platform"], got["correctness_only"], got["ok"]) == (
            N, "cpu", False, True)


def test_allreduce_busbw_follows_nccl_tests(world):
    for rank_out in world:
        row = rank_out["allreduce"]["results"][0]
        assert row["busbw_gbps"] == pytest.approx(row["algbw_gbps"] * 2 * (N - 1) / N)
        assert row["algbw_gbps"] > 0
    # every rank reports the slowest rank's time
    assert len({r["allreduce"]["results"][0]["time_ms"] for r in world}) == 1


def test_allreduce_on_a_group_of_two(world):
    for rank, rank_out in enumerate(world):
        if rank < 2:
            got = rank_out["allreduce_pair"]
            assert got["devices"] == 2 and got["ok"] and not got["correctness_only"]
            row = got["results"][0]
            assert row["busbw_gbps"] == pytest.approx(row["algbw_gbps"])  # 2(n-1)/n = 1
        else:
            assert "allreduce_pair" not in rank_out


@pytest.mark.parametrize("key", ["collectives", "collectives_x"])
def test_collectives_are_exact(world, key):
    want = _reference_collectives(2048)
    for rank_out in world:
        got = rank_out[key]
        assert set(got) == set(want) and set(got["errors"]) == set(want["errors"])
        assert got["ok"] and max(got["errors"].values()) <= 1e-5
        assert got["devices"] == (N if key == "collectives" else 2)
    assert len({str(r[key]["errors"]) for r in world}) == 1


def test_collectives_reject_a_size_that_does_not_divide(world):
    want = [_reference_collectives(p) for p in (2047, 0)]
    assert all(isinstance(w, str) for w in want)
    for rank_out in world:
        assert rank_out["value_errors"] == want


@pytest.mark.parametrize("case", sorted(CORRUPTIONS))
def test_a_corrupted_primitive_fails_every_rank(world, case):
    for rank_out in world:
        message = rank_out["corrupted"][case]
        assert message is not None and "collective numerics mismatch" in message
        errors = ast.literal_eval(message.split(": ", 1)[1])  # the check's report
        assert errors[case] > 1e-5
        assert all(v <= 1e-5 for k, v in errors.items() if k != case)


def test_payloads_need_a_world():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        tar.run_allreduce(device="cpu")
    with pytest.raises(RuntimeError, match="no process group"):
        tco.run_collectives_check(device="cpu")
