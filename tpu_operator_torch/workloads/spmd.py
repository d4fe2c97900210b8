"""Meshes and differentiable collectives of the port's sharded paths: its
stand-in for ``shard_map`` (``tpu_operator/workloads/compat.py``).

A mesh is a ``torch.distributed`` ``DeviceMesh`` over the current world
with named axes (:func:`named_mesh`); :func:`mesh_axes`,
:func:`axis_size`, :func:`axis_index` and :func:`axes_group` read it, and
read a missing mesh (``None``) or axis as one rank.

Every rank runs the same program on its own shard (SPMD), and the
collectives below carry values between ranks inside autograd:

- :func:`copy_to` — identity forward, all-reduce-sum backward (Megatron's
  *f*): a replicated tensor entering a region whose result is partial
  over the group;
- :func:`reduce_from` — all-reduce-sum forward, identity backward
  (Megatron's *g*): partial results leaving such a region;
- :func:`ring_shift` — each rank sends to the next rank of the group and
  receives from the previous one; the backward shifts the gradients the
  other way round (``lax.ppermute`` and its transpose).

``torch.distributed.nn.functional.all_reduce`` is not *g*: its backward
sums the gradient over the group again, which multiplies every gradient
upstream of a replicated output by the group size.

A sum over several axes runs once, over the group of their product
(:func:`axes_group`). Groups of one rank are skipped, so on a one-rank
mesh the sharded path does the arithmetic of the one-device path and
runs no collective. Point-to-point operations take global ranks; the
ring's neighbours are looked up in the group.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

Group = Optional[dist.ProcessGroup]

# ---------------------------------------------------------------------- meshes


def world_size() -> int:
    """Ranks in the current world; raises when there is none."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call distributed.initialize or "
                           "distributed.spawn_world first")
    return dist.get_world_size()


def named_mesh(**axes: int):
    """DeviceMesh over the current world with named axes (in keyword
    order), on the world's device type (CUDA under NCCL, else the CPU);
    validates the factoring."""
    from torch.distributed.device_mesh import init_device_mesh

    world = world_size()
    if math.prod(axes.values()) != world:
        shape = "x".join(str(s) for s in axes.values())
        raise ValueError(f"mesh {shape} != {world} devices")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(axes.values()), mesh_dim_names=tuple(axes))


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} of a mesh, in its axis order."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def axis_size(mesh, axis: str) -> int:
    """Ranks along ``axis`` (1 off the mesh)."""
    return mesh_axes(mesh).get(axis, 1) if mesh is not None else 1


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 off the mesh)."""
    if mesh is None or axis not in mesh.mesh_dim_names:
        return 0
    return mesh.get_local_rank(axis)


# (id of the mesh, axes) -> (the mesh, its group): the mesh is kept so
# that its id cannot be reused while the entry stands
_GROUPS: Dict[Tuple[int, Tuple[str, ...]], tuple] = {}


def axes_group(mesh, *axes: str) -> Group:
    """This rank's process group over ``axes`` of ``mesh`` taken together
    (the ones the mesh has with more than one rank), so that one
    collective covers their product; None when that is a single rank.
    Several axes make a flattened sub-mesh, created once per mesh by
    every rank (its first call is collective)."""
    if mesh is None:
        return None
    names = tuple(a for a in mesh.mesh_dim_names if a in axes and axis_size(mesh, a) > 1)
    if not names:
        return None
    key = (id(mesh), names)
    if key not in _GROUPS:
        if len(names) == 1:
            group = mesh.get_group(names[0])
        else:
            group = mesh[names]._flatten("_".join(names)).get_group()
        _GROUPS[key] = (mesh, group)
    return _GROUPS[key][1]


# ----------------------------------------------------------------- collectives


def _live(group: Group) -> bool:
    return group is not None and dist.get_world_size(group) > 1


def all_reduce_sum(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Sum of ``x`` over ``group`` (a new tensor; not differentiable)."""
    out = x.detach().clone()
    if _live(group):
        dist.all_reduce(out, group=group)
    return out


def all_gather_cat(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """The group's shards of ``x`` in group-rank order, joined along ``dim``
    (not differentiable)."""
    if not _live(group):
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Megatron's *f* over ``group``: identity forward, gradient summed
    over the group in the backward."""
    return _CopyTo.apply(x, group) if _live(group) else x


def reduce_from(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Megatron's *g* over ``group``: summed forward, identity backward."""
    return _ReduceFrom.apply(x, group) if _live(group) else x


def _shift(tensors: Sequence[torch.Tensor], group: dist.ProcessGroup,
           shift: int) -> List[torch.Tensor]:
    """Send each tensor ``shift`` ranks on round the group and receive the
    ones sent here; every send and receive is posted in one batch (at two
    ranks the next and the previous rank are the same peer)."""
    n = dist.get_world_size(group)
    ranks = dist.get_process_group_ranks(group)
    me = dist.get_rank(group)
    dst, src = ranks[(me + shift) % n], ranks[(me - shift) % n]
    sends = [t.contiguous() for t in tensors]
    outs = [torch.empty_like(t) for t in sends]
    ops = []
    for t, o in zip(sends, outs):
        ops.append(dist.P2POp(dist.isend, t, dst, group))
        ops.append(dist.P2POp(dist.irecv, o, src, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(_shift(tensors, group, 1))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *_shift(grads, ctx.group, -1))


def ring_shift(tensors: Sequence[torch.Tensor], group: Group) -> List[torch.Tensor]:
    """Rank i's ``tensors`` arrive at rank i + 1 of ``group`` (cyclic);
    differentiable when any of them needs a gradient, with the gradients
    travelling back to rank i - 1. A one-rank ring returns its inputs.
    Every rank of the group must call it with tensors of the same shapes,
    in the same order."""
    tensors = list(tensors)
    if not _live(group):
        return tensors
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return list(_RingShift.apply(group, *tensors))
    return _shift(tensors, group, 1)
