"""All-reduce bandwidth validation (port of ``tpu_operator/workloads/allreduce.py``).

The slice validator's headline: an all-reduce over the ranks of the
current world (one rank per card, NCCL on the cards, gloo on the CPU),
reported in GB/s per card. Numerics are checked first: each rank adds its
row of ``arange(n·1024)``, and the sum must match numpy's.

Bus bandwidth follows nccl-tests: an n-way ring all-reduce moves
2(n-1)/n bytes per byte of payload per rank, so busbw = algbw·2(n-1)/n.
A one-rank world still calls ``all_reduce``: the one-rank call is what
builds and exercises the NCCL communicator, though its time measures a
local copy, not a link.

The timed chain is the reference's one compiled program of back-to-back
all-reduces: on the card, one CUDA graph replay with the NCCL calls
captured inside it (:func:`_chain_seconds`), so no host dispatch sits
between the collectives; the CPU runs it op by op (:func:`_loop_seconds`).
"""

from __future__ import annotations

import functools
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from tpu_operator_torch.device import DeviceLike, resolve_device
from tpu_operator_torch.workloads.spmd import world_size


def _barrier(device: torch.device, group=None) -> None:
    """Every rank of ``group`` reaches this point before any leaves it (a
    one-element all-reduce, waited for on the card)."""
    dist.all_reduce(torch.zeros(1, device=device), group=group)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# what the card's chains did, read by a caller that shows a chain ran as a
# replay: all-reduces issued while a chain was being captured, and chain
# replays timed
chain_counts = {"captured_all_reduces": 0, "timed_replays": 0}


def _chain(x: torch.Tensor, n: int, iters: int, group=None) -> torch.Tensor:
    """``iters`` all-reduces of ``x`` in place over ``group`` of ``n``
    ranks, each followed by ``div_(n)`` so the chain stays bounded;
    returns ``x``."""
    for _ in range(iters):
        dist.all_reduce(x, group=group)
        if x.is_cuda and torch.cuda.is_current_stream_capturing():
            chain_counts["captured_all_reduces"] += 1
        x.div_(n)
    return x


def _timed(run, device: torch.device) -> float:
    """Seconds of ``run()``: CUDA events on the card, the wall clock on the
    CPU (gloo returns when the reduction is done)."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        run()
        return time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def _loop_seconds(x: torch.Tensor, n: int, iters: int, group=None) -> float:
    """This rank's seconds for the chain (:func:`_chain` on ``x``) run op
    by op, each collective dispatched from the host; the ranks start
    together."""
    _barrier(x.device, group)
    return _timed(lambda: _chain(x, n, iters, group), x.device)


def _chain_seconds(x: torch.Tensor, n: int, iters: int, group=None) -> float:
    """This rank's seconds for ``iters`` back-to-back all-reduces of ``x``
    in place over ``group`` of ``n`` ranks (:func:`_chain`), the ranks
    starting together. On the card the chain is one CUDA graph over a
    static tensor (``kernels/graph.GraphedCall``: an eager warm-up that
    opens the communicator, the capture, a first replay), ``x`` is copied
    into that tensor before the timed window, and the window holds the one
    replay and no host dispatch; the graph does not outlive the call, so
    none outlives its communicator. The CPU times :func:`_loop_seconds`."""
    if not x.is_cuda:
        return _loop_seconds(x, n, iters, group)
    from tpu_operator_torch.kernels.graph import GraphedCall

    static = x.clone()
    chain = GraphedCall(functools.partial(_chain, static, n, iters, group))
    chain()  # the warm-up, eager
    chain()  # the capture and a first replay
    static.copy_(x)  # fresh data, before the window
    _barrier(x.device, group)
    seconds = _timed(chain, x.device)
    chain_counts["timed_replays"] += 1
    x.copy_(static)
    return seconds


def _slowest(seconds: float, device: torch.device, group=None) -> float:
    """The largest of every rank's ``seconds`` over ``group``."""
    t = torch.tensor([seconds], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return float(t)


def run_allreduce(
    sizes_mb: tuple = (1, 4, 16, 64),
    group: Optional[dist.ProcessGroup] = None,
    iters: int = 10,
    device: DeviceLike = None,
) -> dict:
    """All-reduce over the ranks of ``group`` (default: the world), each
    with its payload on ``device``; returns per-size timings (the slowest
    rank's) and the peak bus bandwidth in GB/s per card. Verifies numerics
    before timing. Every rank of the group calls it and gets the same
    report."""
    dev = resolve_device(device)
    world_size()  # raises without a process group
    n = dist.get_world_size(group)
    me = dist.get_rank(group)

    # correctness first (the validation part)
    k = 1024
    rows = np.arange(n * k, dtype=np.float32).reshape(n, k)
    got = torch.tensor(rows[me], device=dev)
    dist.all_reduce(got, group=group)
    if not np.allclose(got.cpu().numpy(), rows.sum(axis=0), rtol=1e-5):
        raise RuntimeError("allreduce numerics mismatch")

    results = []
    best_busbw = 0.0
    for size_mb in sizes_mb:
        per_chip = int(size_mb * 1024 * 1024 / 4)  # f32 elements per rank
        _chain_seconds(torch.ones(per_chip, device=dev), n, iters, group)  # warm-up
        x = torch.full((per_chip,), 1.5, device=dev)  # made BEFORE the timed chain
        dt = _slowest(_chain_seconds(x, n, iters, group), dev, group) / iters
        bytes_per_chip = per_chip * 4
        algbw = bytes_per_chip / dt / 1e9
        busbw = algbw * (2 * (n - 1) / n) if n > 1 else algbw
        best_busbw = max(best_busbw, busbw)
        results.append(
            {"size_mb": size_mb, "time_ms": dt * 1e3, "algbw_gbps": algbw, "busbw_gbps": busbw}
        )
    return {
        "devices": n,
        "platform": dev.type,
        "results": results,
        "peak_busbw_gbps_per_chip": best_busbw,
        # a one-rank "allreduce" is a local copy: it validates the
        # collective and measures launch latency, never an interconnect
        "correctness_only": n == 1,
        "ok": True,
    }
