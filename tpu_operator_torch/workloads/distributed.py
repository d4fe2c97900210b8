"""Multi-host bring-up and local process worlds (port of
``tpu_operator/workloads/distributed.py``).

The slice manager renders a gang's identity as environment variables
(``TPU_WORKER_ID``, ``TPU_WORKER_HOSTNAMES`` and, across slices,
``MEGASCALE_*``). :func:`config_from_env` turns them into the hosts'
world exactly as the reference does. A JAX process drives every chip of
its host; here one process drives one card, so a host starts one rank
per local card (torchrun's layout): :func:`initialize` joins rank
``process_id × local_size + local_rank`` of a world of ``num_processes ×
local_size`` ranks through a TCP store at the coordinator, NCCL on CUDA
(rank r of a host on card ``local_rank``) and gloo only when the caller
names the CPU. :func:`gang_world` does the same for the length of a
``with`` block, and builds a world of one rank where the gang is one
process on one card.

:func:`spawn_world` starts a world of ``n`` local processes (the ``spawn``
start method, one rendezvous file in a temporary directory) and returns
what each rank's function returned; :func:`spawn_ranks` starts the
processes and leaves joining a world to the function. Every world has a
deadline: the process group's collectives time out, and the launcher
kills every rank and raises when the world has not finished in time or a
rank failed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Mapping, Optional, Sequence

import torch
import torch.distributed as dist

from tpu_operator_torch.device import DeviceLike, resolve_device

DEFAULT_TIMEOUT_S = 300.0  # a world's deadline: start, work and collectives


@dataclasses.dataclass
class DistributedConfig:
    coordinator_address: Optional[str]
    num_processes: int
    process_id: int
    # this process's card among its host's (one rank per local card)
    local_rank: int = 0
    local_size: int = 1

    @property
    def rank(self) -> int:
        return self.process_id * self.local_size + self.local_rank

    @property
    def world_size(self) -> int:
        return self.num_processes * self.local_size

    @property
    def needed(self) -> bool:
        return self.world_size > 1


def config_from_env(env: Optional[Mapping[str, str]] = None,
                    coordinator_port: int = 8476) -> DistributedConfig:
    """Derive the distributed topology from GKE TPU env vars.

    - ``TPU_WORKER_ID``: this host's index within the slice (0-based)
    - ``TPU_WORKER_HOSTNAMES``: comma-separated host list; worker 0 is the
      coordinator
    - ``MEGASCALE_COORDINATOR_ADDRESS`` (multi-slice): overrides the
      coordinator
    - ``MEGASCALE_NUM_SLICES`` / ``MEGASCALE_SLICE_ID`` (multi-slice): the
      world spans every slice — the process count multiplies by the slice
      count and this host's process id offsets by its slice's block.
      Slices must be uniform (the same number of hostnames each).
    """
    env = env if env is not None else os.environ
    hostnames = [h for h in env.get("TPU_WORKER_HOSTNAMES", "").split(",") if h]
    worker_id = int(env.get("TPU_WORKER_ID", "0") or "0")
    per_slice = len(hostnames) if hostnames else 1
    num = per_slice
    process_id = worker_id
    num_slices = int(env.get("MEGASCALE_NUM_SLICES", "1") or "1")
    if num_slices > 1:
        if not env.get("MEGASCALE_COORDINATOR_ADDRESS"):
            # every slice would elect its own coordinator while claiming
            # the cross-slice world size: a silent deadlock at initialize
            raise ValueError(
                "MEGASCALE_NUM_SLICES > 1 requires MEGASCALE_COORDINATOR_ADDRESS"
            )
        slice_id_raw = (env.get("MEGASCALE_SLICE_ID") or "").strip()
        if not slice_id_raw:
            # every slice would take block 0: colliding process ids
            raise ValueError("MEGASCALE_NUM_SLICES > 1 requires MEGASCALE_SLICE_ID")
        slice_id = int(slice_id_raw)
        if not 0 <= slice_id < num_slices:
            raise ValueError(
                f"MEGASCALE_SLICE_ID {slice_id} outside [0, {num_slices})"
            )
        num = per_slice * num_slices
        process_id = slice_id * per_slice + worker_id
    coordinator = env.get("MEGASCALE_COORDINATOR_ADDRESS") or (
        f"{hostnames[0]}:{coordinator_port}" if hostnames else None
    )
    if coordinator and ":" not in coordinator.rsplit("]", 1)[-1]:
        coordinator = f"{coordinator}:{coordinator_port}"
    return DistributedConfig(
        coordinator_address=coordinator,
        num_processes=num,
        process_id=process_id,
    )


def _backend(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def initialize(env: Optional[Mapping[str, str]] = None, coordinator_port: int = 8476,
               backend: Optional[str] = None, device: DeviceLike = None,
               timeout: float = DEFAULT_TIMEOUT_S, local_rank: int = 0,
               local_size: int = 1) -> DistributedConfig:
    """Join the gang's process group as local rank ``local_rank`` of
    ``local_size`` on this host when the world has more than one rank; a
    single process on a single card is a no-op. Every host must start the
    same number of local ranks: a mismatch raises ``ValueError`` on every
    rank before the process group forms (it would deadlock there). The
    device is resolved first, so with no device and no CUDA this raises
    instead of joining a CPU world."""
    dev = resolve_device(device)
    if not 0 <= local_rank < local_size:
        raise ValueError(f"local rank {local_rank} outside [0, {local_size})")
    cfg = dataclasses.replace(config_from_env(env, coordinator_port), local_rank=local_rank,
                              local_size=local_size)
    if cfg.needed:
        _join(cfg, backend or _backend(dev), dev, timeout, coordinator_port)
    return cfg


def _join(cfg: DistributedConfig, backend: str, dev: torch.device, timeout: float,
          coordinator_port: int) -> None:
    """init_process_group over a TCP store at the coordinator (on a single
    host with no hostnames, the loopback at ``coordinator_port``; port 0
    picks a free one, which only a world of one rank can use)."""
    if dev.type == "cuda":
        torch.cuda.set_device(cfg.local_rank)
    host, _, port = (cfg.coordinator_address or f"127.0.0.1:{coordinator_port}").rpartition(":")
    span = datetime.timedelta(seconds=timeout)
    store = dist.TCPStore(host.strip("[]"), int(port), is_master=cfg.rank == 0, timeout=span,
                          wait_for_workers=False)
    sizes = dist.PrefixStore("local_size", store)
    if cfg.local_rank == 0:
        sizes.set(str(cfg.process_id), str(cfg.local_size))
    hosts = [str(p) for p in range(cfg.num_processes)]
    sizes.wait(hosts)
    declared = {p: int(sizes.get(p)) for p in hosts}
    sizes.add("read", 1)
    if set(declared.values()) != {cfg.local_size}:
        if cfg.rank == 0:
            # the store lives in this process: every rank reads before it goes
            end = time.monotonic() + timeout
            while sizes.add("read", 0) < sum(declared.values()) and time.monotonic() < end:
                time.sleep(0.05)
        raise ValueError(f"hosts start different numbers of local ranks (process id: local "
                         f"ranks) {declared}; every host must start the same number")
    dist.init_process_group(backend, store=store, rank=cfg.rank, world_size=cfg.world_size,
                            timeout=span)


@contextlib.contextmanager
def gang_world(coordinator_port: int = 8476, local_rank: int = 0, local_size: int = 1,
               device: DeviceLike = None):
    """The world of the gang this process's env describes, for the body
    of a ``with`` block (yields the :class:`DistributedConfig`):
    :func:`initialize`, or, where the gang is one process on one card, a
    world of this rank alone, so that its collectives still run (one rank
    still builds and calls an NCCL communicator). The process group is
    destroyed on the way out."""
    dev = resolve_device(device)
    cfg = initialize(coordinator_port=coordinator_port, device=dev, local_rank=local_rank,
                     local_size=local_size)
    if not cfg.needed:
        _join(cfg, _backend(dev), dev, DEFAULT_TIMEOUT_S, coordinator_port=0)
    try:
        yield cfg
    finally:
        dist.destroy_process_group()


def init_local_world(rank: int, world_size: int, store_path: str, device: DeviceLike = None,
                     timeout: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join a world of local processes that meet through the file
    ``store_path``; returns this rank's device (``cuda:<rank>`` on CUDA)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    dist.init_process_group(
        _backend(dev),
        init_method=f"file://{store_path}",
        rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout),
    )
    return dev


def _in_local_world(rank: int, world_size: int, store_path: str, device: str, timeout: float,
                    fn: Callable, args: Sequence) -> Any:
    init_local_world(rank, world_size, store_path, device, timeout)
    result = fn(*args)
    dist.destroy_process_group()
    return result


def _rank_main(rank: int, call_path: str, results) -> None:
    torch.set_num_threads(1)
    try:
        with open(call_path, "rb") as f:
            fn, args = pickle.load(f)  # written by spawn_ranks for this launch
        results.put((rank, True, fn(rank, *args)))
    except BaseException:  # reported to the launcher, which raises it
        results.put((rank, False, traceback.format_exc()))


def _failures(n: int, failed: dict, results, grace_s: float = 2.0) -> str:
    """Every failure the ranks report within ``grace_s`` of the first, in
    rank order: a rank's own error makes its peers' collectives fail too,
    and the first report to arrive need not be the cause."""
    end = time.monotonic() + grace_s
    while time.monotonic() < end:
        try:
            rank, ok, value = results.get(timeout=max(0.0, end - time.monotonic()))
        except queue.Empty:
            break
        if not ok:
            failed[rank] = value
    return f"ranks {sorted(failed)} of {n} failed:\n" + "\n".join(
        f"--- rank {r} ---\n{failed[r]}" for r in sorted(failed))


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(10)


def spawn_world(n: int, fn: Callable, args: Sequence = (), device: DeviceLike = None,
                timeout: float = DEFAULT_TIMEOUT_S) -> List[Any]:
    """Run ``fn(*args)`` on every rank of a new world of ``n`` local
    processes and return the results in rank order. ``fn`` must be
    importable by name (the ranks start from a fresh interpreter). On CUDA
    rank r takes card r and the world needs ``n`` cards; the CPU runs a
    gloo world. A rank's exception, a rank that dies, or a world that has
    not finished within ``timeout`` seconds stops every rank and raises."""
    dev = resolve_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        return spawn_ranks(n, _in_local_world, (n, os.path.join(tmp, "store"), dev.type, timeout,
                                                fn, tuple(args)), dev, timeout)


def spawn_ranks(n: int, fn: Callable, args: Sequence = (), device: DeviceLike = None,
                timeout: float = DEFAULT_TIMEOUT_S) -> List[Any]:
    """Run ``fn(rank, *args)`` in ``n`` local processes, rank 0 to n - 1,
    each of which joins its world itself (``initialize``, ``gang_world``),
    and return the results in rank order; needs ``n`` cards on CUDA. The
    deadline and the failure reports are :func:`spawn_world`'s."""
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"a world of {n} ranks needs {n} CUDA devices, "
                           f"have {torch.cuda.device_count()}")
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    deadline = time.monotonic() + timeout
    with tempfile.TemporaryDirectory() as tmp:
        # the call goes by file: a start's pipe holds 64 KiB, and a larger
        # payload would wait for each rank's interpreter to start in turn
        call = os.path.join(tmp, "call.pkl")
        with open(call, "wb") as f:
            pickle.dump((fn, tuple(args)), f)
        procs = [ctx.Process(target=_rank_main, daemon=True, args=(r, call, results))
                 for r in range(n)]
        try:
            for p in procs:
                p.start()
            got = {}
            while len(got) < n:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"a world of {n} ranks did not finish within {timeout} s "
                                       f"(ranks {sorted(set(range(n)) - set(got))} missing)")
                try:
                    rank, ok, value = results.get(timeout=min(1.0, left))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"rank {dead[0]} of {n} exited with code "
                                           f"{procs[dead[0]].exitcode} before reporting")
                    continue
                if not ok:
                    raise RuntimeError(_failures(n, {rank: value}, results))
                got[rank] = value
            for p in procs:
                p.join(30)
        finally:
            _stop(procs)
            results.close()
    return [got[r] for r in range(n)]
