"""Fabric probe: per-link bandwidth and per-axis collective latency (port
of ``tpu_operator/workloads/fabric.py``).

The ranks of the current world (one per card) are laid out on a block of
``shape`` in worker order (x fastest, the order the placement engine
gives worker ids), and the probe measures two things:

  - **per-edge bandwidth**: for every adjacent pair of the block (each
    axis's +1 neighbours, plus the wrap link on axes longer than 2 when
    asked), a timed ping-pong of the payload between exactly those two
    ranks (``send``/``recv``: NCCL peer-to-peer over NVLink on cards),
    every hop synchronised, while the other ranks wait at a barrier.
    Edges are keyed by block coordinate ("0-0-0|1-0-0") and translated to
    host names by :func:`gang_fabric_artifact`;
  - **per-axis all-reduce latency**: an all-reduce chain over each axis's
    groups alone (the lines of ranks along that axis), in µs per
    all-reduce.

A full all-reduce over every rank is checked first: a probe that cannot
add has no business timing. The pure functions (edges, keys, the
artifact, and copies of the torus helpers ``parse_topology``,
``parse_shape`` and ``worker_coords``) are the reference's.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from tpu_operator_torch.device import DeviceLike, resolve_device
from tpu_operator_torch.workloads.allreduce import _barrier, _chain_seconds
from tpu_operator_torch.workloads.spmd import world_size

Coord = Tuple[int, int, int]

AXIS_NAMES = ("x", "y", "z")


def parse_topology(topology: str) -> List[int]:
    """'4x4' -> [4, 4]; '2x2x2' -> [2, 2, 2]. Empty/invalid -> []. (Copy
    of ``tpu_operator/nodeinfo.py::parse_topology``.)"""
    if not topology:
        return []
    try:
        dims = [int(p) for p in topology.lower().split("x")]
    except ValueError:
        return []
    return dims if all(d > 0 for d in dims) else []


def parse_shape(shape: str) -> Optional[Coord]:
    """'4x4x4' -> (4, 4, 4); '2x4' -> (2, 4, 1); invalid/empty -> None.
    (Copy of ``tpu_operator/placement/torus.py::parse_shape``.)"""
    dims = parse_topology(shape)
    if not dims or len(dims) > 3:
        return None
    while len(dims) < 3:
        dims.append(1)
    return (dims[0], dims[1], dims[2])


def worker_coords(worker_id: int, dims: Coord) -> Coord:
    """Row-major (x fastest) coordinate of one worker in a host grid —
    the Cloud TPU VM worker-id enumeration order. (Copy of
    ``tpu_operator/placement/torus.py::worker_coords``.)"""
    x_dim, y_dim, _ = dims
    return (worker_id % x_dim, (worker_id // x_dim) % y_dim, worker_id // (x_dim * y_dim))


def _coord_str(coord: Sequence[int]) -> str:
    return "-".join(str(c) for c in coord)


def edge_key(a: str, b: str) -> str:
    """Canonical edge id: the two endpoint names sorted and joined by
    '|', so publisher and analyzer agree on the key regardless of which
    direction measured it."""
    return "|".join(sorted((a, b)))


def enumerate_block_edges(
    shape: Coord, wrap: bool = False
) -> List[Tuple[Coord, Coord, str, bool]]:
    """Every link of a block torus: (coord_a, coord_b, axis, is_wrap)
    for each axis's +1 neighbors, plus the wrap edge on axes longer than
    2 when ``wrap`` (on a 2-long axis the wrap link IS the interior
    link — counting it twice would invent a cable). Deterministic order:
    axis-major, then row-major origin."""
    edges: List[Tuple[Coord, Coord, str, bool]] = []
    for axis in range(3):
        dim = shape[axis]
        if dim < 2:
            continue
        for k in range(shape[2]):
            for j in range(shape[1]):
                for i in range(shape[0]):
                    at = (i, j, k)
                    if at[axis] < dim - 1:
                        to = list(at)
                        to[axis] += 1
                        edges.append((at, tuple(to), AXIS_NAMES[axis], False))
                    elif wrap and dim > 2:
                        to = list(at)
                        to[axis] = 0
                        edges.append((at, tuple(to), AXIS_NAMES[axis], True))
    return edges


def _rank_at(coord: Coord, dims: Coord) -> int:
    """The rank at a block coordinate: the inverse of ``worker_coords``."""
    return coord[0] + dims[0] * (coord[1] + dims[1] * coord[2])


def _block_mesh(dims: Coord, device_type: str):
    """A DeviceMesh over the world with axes x, y, z, rank r at
    ``worker_coords(r, dims)`` (every rank builds it: its groups are
    collective)."""
    from torch.distributed.device_mesh import DeviceMesh

    ranks = torch.arange(dims[0] * dims[1] * dims[2]).reshape(dims[2], dims[1], dims[0])
    return DeviceMesh(device_type, ranks.permute(2, 1, 0), mesh_dim_names=AXIS_NAMES)


def _time_pair_transfer(payload: torch.Tensor, peer: int, first: bool, iters: int) -> float:
    """Seconds per one-way transfer between this rank and ``peer``: a
    timed chain of round trips (there and back count as two transfers),
    each hop synchronised so the clock covers the wire, not the enqueue.
    ``first`` sends first; the peer calls it with ``first`` false."""
    sync = torch.cuda.synchronize if payload.is_cuda else (lambda: None)

    def round_trip():
        for sending in (first, not first):
            (dist.send if sending else dist.recv)(payload, peer)
            sync()

    round_trip()  # warm the path (the first hop may set up the pair's channel)
    t0 = time.perf_counter()
    for _ in range(iters):
        round_trip()
    return (time.perf_counter() - t0) / (2 * iters)


def run_fabric_probe(
    shape: str,
    wrap: bool = False,
    size_mb: float = 1.0,
    iters: int = 4,
    device: DeviceLike = None,
) -> dict:
    """Sweep the fabric of the world's ranks arranged as ``shape``
    ("2x2x1"; the world must have exactly that many ranks, each with its
    payload on ``device``). Returns the per-edge bandwidth map
    (block-coordinate keys), the per-axis all-reduce latency matrix, and
    a numerics check. Every rank calls it and gets the same report.

    ``wrap`` adds the wraparound edges on axes longer than 2 — only
    truthful where those links exist; leave it off otherwise, or the
    probe times a link that does not exist.
    """
    dev = resolve_device(device)
    dims = parse_shape(shape)
    if dims is None:
        raise ValueError(f"unparseable fabric shape {shape!r}")
    world = world_size()
    need = dims[0] * dims[1] * dims[2]
    if world < need:
        raise ValueError(f"shape {shape} needs {need} devices, have {world}")
    if world > need:
        raise ValueError(f"shape {shape} takes a world of exactly {need} ranks, have {world}")
    rank = dist.get_rank()
    mesh = _block_mesh(dims, dev.type)

    # numerics first: an all-reduce over every rank
    probe = torch.arange(need * 8, dtype=torch.float32).reshape(need, 8)
    got = probe[rank].to(dev, copy=True)
    dist.all_reduce(got)
    if not torch.allclose(got.cpu(), probe.sum(dim=0), rtol=1e-5):
        raise RuntimeError("fabric probe psum numerics mismatch")

    # per-edge point-to-point bandwidth, measured by the edge's first rank
    payload = torch.ones(int(size_mb * 1024 * 1024 / 4), device=dev)
    payload_bytes = payload.numel() * 4
    block_edges = enumerate_block_edges(dims, wrap=wrap)
    seconds = torch.zeros(len(block_edges), dtype=torch.float64, device=dev)
    for i, (at, to, _, _) in enumerate(block_edges):
        a, b = _rank_at(at, dims), _rank_at(to, dims)
        if rank in (a, b):
            dt = _time_pair_transfer(payload, b if rank == a else a, rank == a, iters)
            if rank == a:
                seconds[i] = dt
        _barrier(dev)
    dist.all_reduce(seconds, op=dist.ReduceOp.MAX)
    edges: Dict[str, dict] = {}
    for (at, to, axis, is_wrap), dt in zip(block_edges, seconds.tolist()):
        edges[edge_key(_coord_str(at), _coord_str(to))] = {
            "bw_gbps": round(payload_bytes / max(dt, 1e-9) / 1e9, 3),
            "axis": axis,
            "wrap": is_wrap,
        }

    # per-axis all-reduce latency matrix (the slowest line of each axis)
    axes = [(name, dims[i]) for i, name in enumerate(AXIS_NAMES) if dims[i] >= 2]
    latency = torch.zeros(len(axes), dtype=torch.float64, device=dev)
    for i, (name, n) in enumerate(axes):
        group = mesh.get_group(name)
        x = torch.ones(64, device=dev)
        _chain_seconds(x, n, iters, group)  # warm the exact chain
        latency[i] = _chain_seconds(x, n, iters, group) / iters * 1e6
    dist.all_reduce(latency, op=dist.ReduceOp.MAX)
    axis_allreduce_us = {name: round(us, 1) for (name, _), us in zip(axes, latency.tolist())}

    return {
        "shape": "x".join(str(d) for d in dims),
        "devices": need,
        "platform": dev.type,
        "wrap": wrap,
        "edges": edges,
        "axis_allreduce_us": axis_allreduce_us,
        "ok": True,
    }


def gang_fabric_artifact(probe: dict, hosts: Sequence[str]) -> dict:
    """Translate a probe report's block-coordinate edges into the gang
    artifact the slice manager publishes: host-name edge keys (the
    block's row-major worker order maps coordinate -> host exactly the
    way the placement engine wired worker ids), plus the summary fields
    the analyzer and must-gather read — median / worst edge. ``hosts``
    is the gang's node-name list in worker-id order."""
    dims = parse_shape(str(probe.get("shape") or ""))
    if dims is None:
        raise ValueError(f"probe carries unparseable shape {probe.get('shape')!r}")
    host_at = {
        _coord_str(worker_coords(i, dims)): name for i, name in enumerate(hosts)
    }
    edges: Dict[str, dict] = {}
    for key, meta in (probe.get("edges") or {}).items():
        a, _, b = key.partition("|")
        host_a, host_b = host_at.get(a), host_at.get(b)
        if host_a is None or host_b is None:
            continue  # probe shape larger than the gang: ignore the overhang
        edges[edge_key(host_a, host_b)] = dict(meta)
    ordered = sorted(edges.items(), key=lambda kv: kv[1].get("bw_gbps", 0.0))
    artifact = {
        "hosts": len(hosts),
        "members": list(hosts),
        "shape": probe.get("shape", ""),
        "edges": edges,
        "axis_allreduce_us": dict(probe.get("axis_allreduce_us") or {}),
    }
    if ordered:
        bws = sorted(v.get("bw_gbps", 0.0) for _, v in ordered)
        artifact["worst_edge"] = ordered[0][0]
        artifact["min_edge_gbps"] = round(bws[0], 3)
        artifact["median_edge_gbps"] = round(bws[len(bws) // 2], 3)
    return artifact
