"""Entry points of the port, mirroring ``__graft_entry__``.

``entry()`` returns ``(fn, (params, x))`` with ``fn(params, x)`` the
flagship burn-in forward at the reference's widths. It runs on the card
unless ``device="cpu"`` is passed. ``params`` may carry the reference's
weights as a dict of numpy arrays; otherwise they are drawn from a fixed
seed (the same distributions, not the same bits as ``jax.random``).

``dryrun_multichip(n)`` runs three calls of the full sharded train step
on a world of n ranks (one per card, where the second call captures the
step's graph and the third replays it; ``device="cpu"`` for n gloo ranks
on the CPU), then the GPipe pipeline check over all n. From a shell:

    python -c "from tpu_operator_torch.entry import dryrun_multichip as d; d(8, device='cpu')"
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional

import numpy as np
import torch

from tpu_operator_torch.device import DeviceLike, resolve_device
from tpu_operator_torch.weights import burnin_params
from tpu_operator_torch.workloads.burnin import BurninConfig, forward, init_params

ENTRY_CONFIG = BurninConfig(d_model=256, n_heads=4, d_ff=1024, seq_len=128, batch=8, n_layers=2)


def entry(device: DeviceLike = None,
          params: Optional[Mapping[str, np.ndarray]] = None,
          use_flash_attention: bool = False):
    """(fn, example_args) — the forward step of the flagship model."""
    dev = resolve_device(device)
    cfg = dataclasses.replace(ENTRY_CONFIG, use_flash_attention=use_flash_attention)
    if params is None:
        weights = init_params(torch.Generator().manual_seed(0), cfg, dev)
    else:
        weights = burnin_params(params, cfg, dev)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((cfg.batch, cfg.seq_len, cfg.d_model), generator=gen).to(dev, cfg.tdtype)

    def fn(params, x):
        return forward(params, x, cfg)

    return fn, (weights, x)


def _dryrun_rank(n_devices: int, device: str) -> dict:
    """One rank of :func:`dryrun_multichip`."""
    from tpu_operator_torch.workloads.burnin import build_train_step, make_mesh, make_mesh_4d
    from tpu_operator_torch.workloads.pipeline import make_pp_mesh, run_pipeline_check
    from tpu_operator_torch.workloads.spmd import mesh_axes

    moe_experts = 0
    if n_devices % 8 == 0:
        # 4-D even at n=8 (the data axis is then 1): every mesh axis runs
        data_size, sp, model, ep = max(1, n_devices // 8), 2, 2, 2
        mesh = make_mesh_4d(data=data_size, sp=sp, model=model, ep=ep)
        sequence_parallel, moe_experts = True, 2 * ep
    else:
        mesh = make_mesh()  # the default (data, model) factorization
        data_size = mesh_axes(mesh)["data"]
        sp, sequence_parallel = 1, False
    cfg = BurninConfig(
        d_model=64,
        n_heads=4,
        d_ff=128,
        seq_len=16 * sp,
        batch=max(4, 2 * data_size),
        n_layers=1,
        sequence_parallel=sequence_parallel,
        moe_experts=moe_experts,
        # 3 documents over 2 sequence shards: both boundaries fall
        # mid-shard, so documents span ranks (ids circulate the ring)
        packed_segments=3 if sequence_parallel else 0,
        # grouped-query attention with kv heads sharded over 'model'
        kv_heads=2 if sequence_parallel else 0,
    )
    step, params, batch = build_train_step(cfg, device, mesh=mesh)
    losses = []
    for _ in range(3):  # on cards: eager, captured, replayed
        params, loss = step(params, batch)
        losses.append(float(loss))
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"non-finite loss in multichip dryrun: {losses}")
    pp = run_pipeline_check(mesh=make_pp_mesh(), n_micro=2, batch=2, d_model=32, steps=2)
    return {
        "mesh": mesh_axes(mesh),
        "loss": losses[0],
        "third_loss": losses[2],
        "pipeline": pp,
        "line": (f"dryrun_multichip: mesh={mesh_axes(mesh)}, loss={losses[0]:.5f}, "
                 f"third call's loss={losses[2]:.5f}, pp={pp['stages']} stages "
                 f"(err_vs_sequential={pp['max_abs_err_vs_sequential']:.2e})"),
    }


def dryrun_multichip(n_devices: int, device: DeviceLike = None) -> dict:
    """The full sharded train step over an n-rank mesh, three calls at
    tiny widths (the first call's loss and the third's are reported).
    Multiples of 8 get the 4-D (data, sp, model, ep) mesh — data
    x sequence parallel (the ring over 'sp', packed documents spanning
    ranks, GQA) x tensor x expert parallel (the MoE over 'ep'); other
    counts the default (data, model) mesh. Then the GPipe pipeline check
    over a 'pp' mesh of all n ranks. Rank 0's line is printed and its
    report returned.

    ``device=None`` means CUDA with one card per rank and raises when
    fewer than n cards are present; ``device="cpu"`` runs n gloo ranks."""
    from tpu_operator_torch.workloads.distributed import spawn_world

    dev = resolve_device(device)
    reports = spawn_world(n_devices, _dryrun_rank, (n_devices, dev.type), device=dev)
    print(reports[0]["line"], flush=True)
    return reports[0]
