"""Pipeline parallelism: the GPipe schedule over a ``pp`` mesh axis (port
of ``tpu_operator/workloads/pipeline.py``).

Each rank is one stage and runs its slice of the stacked per-stage
weights. M microbatches drain through S stages in M + S - 1 ticks, stage
s working on microbatch t - s at tick t; activations move stage to stage
with ``spmd.ring_shift``, whose backward sends the gradients back up the
pipeline, so the same code runs the forward and pipelined training. The
last stage's outputs leave replicated through ``spmd.reduce_from``.

Every rank builds the same autograd graph (each stage selects its input
with ``torch.where`` and keeps every tick's output, masked at the end):
the backward's point-to-point transfers then pair up on every rank.

On a card the pipelined SGD step is one CUDA graph replay per rank, its
transfers and sums captured inside it, as the reference runs it under
``jax.jit``; the CPU runs it op by op.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from tpu_operator_torch.workloads.spmd import (
    all_reduce_sum,
    axis_index,
    mesh_axes,
    named_mesh,
    reduce_from,
    ring_shift,
    world_size,
)


def make_pp_mesh(stages: Optional[int] = None):
    """1-D ``pp`` mesh over the world, one stage per rank."""
    world = world_size()
    stages = stages or world
    if stages != world:
        raise ValueError(f"pp mesh wants {stages} devices, have {world}")
    return named_mesh(pp=stages)


def pipeline_apply(stacked_params: Dict[str, torch.Tensor], microbatches: torch.Tensor,
                   stage_fn: Callable, mesh, axis: str = "pp") -> torch.Tensor:
    """Run ``stage_fn(stage_params, x)`` through all stages in pipeline.

    ``stacked_params``: tensors whose leading axis of size S stacks the
    per-stage weights (every rank passes the whole stack and uses its
    stage's slice). ``microbatches``: (M, ...) inputs consumed by stage
    0. Returns the (M, ...) outputs of stage S-1 on every rank."""
    group = mesh.get_group(axis)
    n_stages = mesh_axes(mesh)[axis]
    stage = axis_index(mesh, axis)
    n_micro = microbatches.shape[0]
    for leaf in stacked_params.values():
        if leaf.shape[0] != n_stages:
            raise ValueError(
                f"stacked param leading dim {leaf.shape[0]} != {n_stages} pipeline "
                "stages — stack exactly one slice per stage (a larger multiple "
                "would shard silently and drop layers)"
            )
    local = {k: v[stage] for k, v in stacked_params.items()}
    # made on the device: a host-to-device copy cannot be captured
    first = torch.full((), stage == 0, device=microbatches.device)
    buf = torch.zeros_like(microbatches[0])
    outs = []
    ticks = n_micro + n_stages - 1
    for t in range(ticks):
        # stage 0 ingests microbatch t (clamped: the extra ticks' results
        # never reach the collected outputs)
        x = torch.where(first, microbatches[min(t, n_micro - 1)], buf)
        y = stage_fn(local, x)
        if t >= n_stages - 1:  # stage S-1's result for microbatch t - (S-1)
            outs.append(y)
        if t < ticks - 1:
            (buf,) = ring_shift((y,), group)
    mask = 1.0 if stage == n_stages - 1 else 0.0
    return reduce_from(torch.stack(outs) * mask, group)


def _stage_fn(p, x):
    """One linear + gelu layer per stage."""
    return F.gelu(x @ p["w"] + p["b"], approximate="tanh")


def _loss_and_grads(params: Dict[str, torch.Tensor], x, target, mesh) -> tuple:
    """The pipelined mean squared error and its gradients; each rank's
    gradient holds only its stage's slice, so the stacks' gradients are
    summed over the stages."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    out = pipeline_apply(leaves, x, stage_fn=_stage_fn, mesh=mesh)
    loss = (out - target).square().mean()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    group = mesh.get_group("pp")
    return loss.detach(), [all_reduce_sum(g, group) for g in grads]


def _sgd_update(params: Dict[str, torch.Tensor], x, target, mesh,
                learning_rate: float) -> torch.Tensor:
    """One pipelined SGD step on ``params`` in place (the eager step's
    arithmetic); returns the loss before the update: the graph's body."""
    loss, grads = _loss_and_grads(params, x, target, mesh)
    with torch.no_grad():
        for p, g in zip(params.values(), grads):
            p.sub_(learning_rate * g)
    return loss


def _pipeline_losses(stacked: Dict[str, torch.Tensor], x, target, mesh, steps: int,
                     learning_rate: float) -> list:
    """``steps`` steps of SGD on the pipelined mean squared error from
    ``stacked``; the loss before each update. On the card each step is a
    replay of one graph over copies of ``stacked`` (``GraphedCall``: the
    first step eager, the second captured), its loss read after it."""
    if x.is_cuda:
        from tpu_operator_torch.kernels.graph import GraphedCall

        params = {k: v.clone() for k, v in stacked.items()}
        step = GraphedCall(functools.partial(_sgd_update, params, x, target, mesh,
                                             learning_rate))
        return [float(step()) for _ in range(steps)]
    losses = []
    params = stacked
    for _ in range(steps):
        loss, grads = _loss_and_grads(params, x, target, mesh)
        losses.append(float(loss))
        params = {k: p - learning_rate * g for (k, p), g in zip(params.items(), grads)}
    return losses


def run_pipeline_check(
    mesh=None,
    n_micro: int = 4,
    batch: int = 2,
    d_model: int = 64,
    steps: int = 3,
    learning_rate: float = 0.1,
) -> dict:
    """Validator payload: (a) the pipelined forward matches running the
    stages sequentially, (b) a pipelined SGD step trains (loss falls).
    Every rank of the mesh calls it and gets the same report."""
    mesh = mesh or make_pp_mesh()
    n_stages = mesh.mesh.shape[0]
    device = (torch.device("cuda", torch.cuda.current_device()) if mesh.device_type == "cuda"
              else torch.device("cpu"))
    gen = torch.Generator().manual_seed(0)
    stacked = {
        "w": torch.randn((n_stages, d_model, d_model), generator=gen) / math.sqrt(d_model),
        "b": torch.randn((n_stages, d_model), generator=gen) * 0.01,
    }
    stacked = {k: v.to(device) for k, v in stacked.items()}
    x, target = (torch.randn((n_micro, batch, d_model), generator=gen).to(device)
                 for _ in range(2))
    with torch.no_grad():
        pipelined = pipeline_apply(stacked, x, stage_fn=_stage_fn, mesh=mesh)
        sequential = x
        for s in range(n_stages):
            sequential = _stage_fn({k: v[s] for k, v in stacked.items()}, sequential)
    err = float((pipelined - sequential).abs().max())
    if not err < 1e-4:
        raise RuntimeError(f"pipeline forward diverges from sequential: {err}")
    losses = _pipeline_losses(stacked, x, target, mesh, steps, learning_rate)
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"non-finite pipeline loss: {losses}")
    if steps >= 2 and not losses[-1] < losses[0]:
        raise RuntimeError(f"pipelined training failed to converge: {losses}")
    return {
        "stages": n_stages,
        "microbatches": n_micro,
        "max_abs_err_vs_sequential": err,
        "losses": losses,
        "ok": True,
    }
