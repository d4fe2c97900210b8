"""Collective-primitive exactness checks over a mesh axis (port of
``tpu_operator/workloads/collectives.py``).

The all-reduce (``allreduce.py``) proves the headline collective; real
workloads also lean on all-gather (tensor-parallel weight gathering),
reduce-scatter (ZeRO/FSDP gradient sharding), all-to-all (MoE dispatch)
and point-to-point ring hops. Each rank of the axis runs every primitive
on its shard and compares the result with a reference it computes
locally from the global table, which every rank builds from one seed:

========================  ===================================
reference (``lax``)       here (``torch.distributed``)
========================  ===================================
``psum``                  ``all_reduce``
``all_gather``            ``all_gather_into_tensor``
``psum_scatter``          ``reduce_scatter_tensor``
``all_to_all``            ``all_to_all_single``
``ppermute`` (one hop)    ``spmd.ring_shift`` (batched send/recv)
========================  ===================================

Each primitive's largest error is then all-reduced with MAX over the axis
(the reference's ``pmax``), so any rank's corruption fails every rank.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from tpu_operator_torch.device import DeviceLike, resolve_device
from tpu_operator_torch.workloads import spmd


def _check_errors(group, per_device: int, device: torch.device) -> dict:
    """Every rank's largest abs error per primitive, the same on every
    rank of ``group``."""
    n = dist.get_world_size(group)
    idx = dist.get_rank(group)
    table = torch.randn((8, per_device), generator=torch.Generator().manual_seed(0)).to(device)
    ids = torch.arange(n, device=device)
    # rank i's shard: a deterministic slice of the table
    every = table[ids % 8] * (1.0 + ids.float())[:, None]  # (n, per_device)
    mine = every[idx].clone()
    total = every.sum(dim=0)
    chunk = per_device // n

    errs = {}
    got = mine.clone()
    dist.all_reduce(got, group=group)
    errs["psum"] = (got - total).abs().max()
    # the full row stack in rank order
    got = torch.empty(n * per_device, device=device)
    dist.all_gather_into_tensor(got, mine, group=group)
    errs["all_gather"] = (got.view(n, per_device) - every).abs().max()
    # summed, then rank i keeps chunk i
    got = torch.empty(chunk, device=device)
    dist.reduce_scatter_tensor(got, mine, group=group)
    errs["reduce_scatter"] = (got - total[idx * chunk:(idx + 1) * chunk]).abs().max()
    # rank i sends chunk j to rank j; received chunk j is rank j's chunk i
    got = torch.empty(per_device, device=device)
    dist.all_to_all_single(got, mine, group=group)
    errs["all_to_all"] = (got.view(n, chunk) - every.view(n, n, chunk)[:, idx]).abs().max()
    # one ring hop: rank i's shard arrives at rank i + 1
    (got,) = spmd.ring_shift((mine,), group)
    errs["ppermute"] = (got - every[(idx - 1) % n]).abs().max()

    worst = torch.stack(list(errs.values()))
    dist.all_reduce(worst, op=dist.ReduceOp.MAX, group=group)
    return dict(zip(errs, worst.tolist()))


def run_collectives_check(
    mesh=None,
    per_device: int = 2048,
    axis_name: Optional[str] = None,
    device: DeviceLike = None,
) -> dict:
    """Validator payload: every collective primitive must be exact over
    ``mesh``'s ``axis_name`` (default: a 1-D ``x`` mesh over the world and
    its axis), the data on ``device``. ``per_device`` must divide by the
    axis' size (reduce-scatter chunking). Every rank calls it."""
    dev = resolve_device(device)
    if mesh is None:
        mesh = spmd.named_mesh(x=spmd.world_size())
    axis_name = axis_name or mesh.mesh_dim_names[0]
    n = spmd.axis_size(mesh, axis_name)
    if per_device <= 0 or per_device % n:
        raise ValueError(
            f"per_device ({per_device}) must be positive and divide by {n} devices"
        )
    report = _check_errors(mesh.get_group(axis_name), per_device, dev)
    worst = max(report.values())
    if not math.isfinite(worst) or worst > 1e-5:
        raise RuntimeError(f"collective numerics mismatch: {report}")
    return {"devices": n, "errors": report, "ok": True}
