"""Live multi-process gang check over real TCP (port of
``tpu_operator/workloads/multiproc.py``).

The slice manager renders the gang contract (``TPU_WORKER_HOSTNAMES``,
``TPU_WORKER_ID``, ``MEGASCALE_*``) into worker pods; this module proves
that contract end to end on one machine: it starts every worker of the
gang as processes of its own, hands each the env a gang worker pod would
see (loopback standing in for the headless Service's DNS names — the
launcher plays the resolver the Service plays in-cluster), brings the
gang up through ``workloads.distributed`` (a TCP store at the
coordinator, then ``init_process_group``), and runs cross-process
collectives over the whole world: an all-reduce and a sequence-parallel
ring-attention exactness check whose ring spans processes.

Where a JAX worker is one process driving all of its host's chips, a
worker here is one process per card (torchrun's layout): worker w's
local rank r is global rank ``w × devices_per_worker + r``. On CUDA each
worker sees its own block of the machine's cards (``CUDA_VISIBLE_DEVICES``)
and its ranks run NCCL; with ``device="cpu"`` they run gloo. Gloo runs
every collective here, so the reference's ``CpuCollectivesUnsupportedError``
has no counterpart.

Each worker process prints one line, ``MULTIPROC_RESULT:`` and its JSON
report; the launcher collects and summarises them.
"""

from __future__ import annotations

import json
import os
import random
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, Mapping, Optional

import torch

from tpu_operator_torch.device import DeviceLike, resolve_device

RESULT_PREFIX = "MULTIPROC_RESULT:"
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# what the launcher tells each worker process beside its gang env
LOCAL_RANK_ENV, LOCAL_SIZE_ENV, DEVICE_ENV = "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MULTIPROC_DEVICE"
_GRACE_S = 5.0  # how long the other workers get to report once one has failed


def step_telemetry(host: str, dev: torch.device, steps: int = 4, n: int = 32) -> tuple:
    """This host's step-time telemetry over local compute only: ``steps``
    timed steps of a chain of ``n`` products of a 256² f32 matrix (the
    reference's jitted ``local_chain``), each read back. On the card a
    step is one CUDA-graph replay (``kernels/graph.GraphedChain``: the
    first step warms and captures, as the reference's first compiles);
    the graph is freed before this returns, so before the gang's world is
    destroyed. Returns (the ``StepTimeReport``, the replays timed)."""
    from tpu_operator_torch.kernels.graph import GraphedChain
    from tpu_operator_torch.workloads.telemetry import StepTimeRecorder

    a = torch.ones((256, 256), device=dev)

    def local_chain(seed, n: int) -> torch.Tensor:  # no seed, as the reference has none
        acc = a
        for _ in range(n):
            acc = acc @ a / 256.0
        return acc.sum()

    recorder = StepTimeRecorder(host=host)
    with GraphedChain(local_chain, dev, "telemetry") as chain:
        before = chain.counts["replays"]
        for _ in range(steps):
            with recorder.step():
                float(chain(None, n))
        replays = chain.counts["replays"] - before
    return recorder.report(), replays


def _checks(cfg, dev: torch.device) -> dict:
    """The worker's checks inside the gang's world."""
    import numpy as np
    import torch.distributed as dist

    from tpu_operator_torch.workloads.allreduce import _chain_seconds, _slowest
    from tpu_operator_torch.workloads.ringattention import _ring_attention_local, dense_attention

    local = cfg.local_size
    total = dist.get_world_size()
    if total != cfg.num_processes * local:
        raise RuntimeError(
            f"global device count {total} != {cfg.num_processes} processes "
            f"x {local} local devices"
        )

    # --- all-reduce across processes -------------------------------------
    # each rank contributes its process id + 1; the sum must see every
    # process's contribution, which only a live cross-process collective can
    x = torch.tensor([float(cfg.process_id + 1)], device=dev)
    dist.all_reduce(x)
    got = float(x)
    want = float(sum((p + 1) * local for p in range(cfg.num_processes)))
    psum_ok = abs(got - want) < 1e-5

    # all-reduce latency: allreduce.py's chain, 8 back to back, one float
    # each (loopback TCP on the CPU): a liveness latency, not a bandwidth
    iters = 8
    chain_x = torch.full((1,), float(cfg.process_id + 1), device=dev)
    _chain_seconds(chain_x, total, iters)  # warm
    psum_chain_ms = _slowest(_chain_seconds(chain_x, total, iters), dev) / iters * 1e3

    # per-host step telemetry over LOCAL compute only: a step with a
    # cross-process collective completes for every host when the slowest
    # finishes, so a local matmul chain keeps each report the host's OWN
    # speed, which is what merge_gang_reports needs
    telemetry, replays = step_telemetry(f"worker-{cfg.process_id}", dev)

    # --- ring attention with the ring spanning processes -----------------
    b, s_local, h, d = 1, 8, 2, 8
    s_global = s_local * total
    rng = np.random.default_rng(0)  # same full tensors on every rank
    full = {
        k: rng.standard_normal((b, s_global, h, d)).astype(np.float32)
        for k in ("q", "k", "v")
    }
    rows = slice(cfg.rank * s_local, (cfg.rank + 1) * s_local)
    q, k, v = (torch.from_numpy(full[n][:, rows].copy()).to(dev) for n in ("q", "k", "v"))
    out = _ring_attention_local(q, k, v, group=dist.group.WORLD, causal=True)
    ref = dense_attention(*(torch.from_numpy(full[n]).to(dev) for n in ("q", "k", "v")),
                          causal=True)
    ring_err = float((out - ref[:, rows]).abs().max())

    return {
        "process_id": cfg.process_id,
        "local_rank": cfg.local_rank,
        "rank": cfg.rank,
        "num_processes": cfg.num_processes,
        "local_devices": local,
        "global_devices": total,
        "platform": dev.type,
        "coordinator": cfg.coordinator_address,
        "psum_got": got,
        "psum_want": want,
        "psum_ok": psum_ok,
        "psum_chain_ms": psum_chain_ms,
        "step_telemetry": telemetry.to_dict(),
        "step_telemetry_replays": replays,
        "ring_attention_max_err": ring_err,
        "ok": bool(psum_ok and ring_err < 1e-4),
    }


def _worker_checks() -> dict:
    """Runs inside each gang worker process: bring-up + collectives."""
    from tpu_operator_torch.workloads.distributed import gang_world

    dev = resolve_device(os.environ[DEVICE_ENV])
    coordinator_port = int(os.environ.get("TPU_COORDINATOR_PORT", "8476"))
    with gang_world(coordinator_port=coordinator_port,
                    local_rank=int(os.environ[LOCAL_RANK_ENV]),
                    local_size=int(os.environ[LOCAL_SIZE_ENV]), device=dev) as cfg:
        return _checks(cfg, dev)


def worker_main() -> None:
    torch.set_num_threads(1)
    print(RESULT_PREFIX + json.dumps(_worker_checks()), flush=True)


def _free_port() -> int:
    """A loopback port free now, for a coordinator that a worker binds
    seconds later. It is drawn below the kernel's ephemeral range: a port
    of that range may be taken meanwhile by any connection or ``bind(0)``
    on the machine (gloo's own listeners among them)."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            low = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        low = 32768  # Linux's default
    draw = random.SystemRandom()
    for _ in range(64):
        port = draw.randrange(low // 2, low)
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port
    raise RuntimeError(f"no free loopback port in [{low // 2}, {low})")


def _localize_gang_env(gang_env: Mapping[str, str], port: int) -> dict:
    """Rewrite a rendered gang env for loopback execution: hostnames and
    the DCN coordinator point at 127.0.0.1 (the launcher plays the
    resolver the headless Service plays in-cluster)."""
    env = dict(gang_env)
    hostnames = [h for h in env.get("TPU_WORKER_HOSTNAMES", "").split(",") if h]
    env["TPU_WORKER_HOSTNAMES"] = ",".join("127.0.0.1" for _ in hostnames)
    env["TPU_COORDINATOR_PORT"] = str(port)
    if "MEGASCALE_COORDINATOR_ADDRESS" in env:
        # the DCN coordinator override wins in config_from_env, so it
        # too must point at loopback
        env["MEGASCALE_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
    return env


def _check_cards(dev: torch.device, ranks: int) -> None:
    """On CUDA every rank needs a card of its own (two NCCL ranks cannot
    share one)."""
    if dev.type == "cuda" and torch.cuda.device_count() < ranks:
        raise RuntimeError(f"{ranks} ranks need {ranks} CUDA devices, one each; "
                           f"have {torch.cuda.device_count()}")


def _launch_workers(worker_envs, devices_per_worker: int, timeout: float,
                    dev: torch.device) -> List[dict]:
    """Start one process per (worker env, local rank), collect and validate
    the reports. One deadline covers the gang; once a process fails, the
    rest get ``_GRACE_S`` to finish before they are stopped (a peer of a
    failed rank waits in its collectives otherwise)."""
    cards = os.environ.get("CUDA_VISIBLE_DEVICES")
    cards = cards.split(",") if cards else [str(i) for i in range(torch.cuda.device_count())]
    names, procs = [], []
    with tempfile.TemporaryDirectory() as tmp:
        for w, worker_env in enumerate(worker_envs):
            for local_rank in range(devices_per_worker):
                env = dict(os.environ)
                env.update(worker_env)
                env.update({LOCAL_RANK_ENV: str(local_rank),
                            LOCAL_SIZE_ENV: str(devices_per_worker),
                            DEVICE_ENV: dev.type, "OMP_NUM_THREADS": "1"})
                if dev.type == "cuda":  # worker w's host holds its own cards
                    env["CUDA_VISIBLE_DEVICES"] = ",".join(
                        cards[w * devices_per_worker:(w + 1) * devices_per_worker])
                name = os.path.join(tmp, f"{w}-{local_rank}")
                names.append(f"worker {w} local rank {local_rank}")
                with open(name + ".out", "w") as out, open(name + ".err", "w") as err:
                    proc = subprocess.Popen(
                        [sys.executable, "-m", "tpu_operator_torch.workloads.multiproc"],
                        env=env, cwd=_REPO_ROOT, stdout=out, stderr=err, text=True)
                procs.append((proc, name))
        deadline = time.monotonic() + timeout
        timed_out = set()
        while True:
            codes = [p.poll() for p, _ in procs]  # every process, each pass
            if None not in codes:
                break
            now = time.monotonic()
            if any(code not in (None, 0) for code in codes):
                deadline = min(deadline, now + _GRACE_S)
            if now >= deadline:
                for i, (p, _) in enumerate(procs):
                    if p.poll() is None:
                        p.kill()
                        timed_out.add(i)
                break
            time.sleep(0.1)
        workers, failures = [], []
        for i, (proc, name) in enumerate(procs):
            proc.wait()
            with open(name + ".out") as f:
                out = f.read()
            with open(name + ".err") as f:
                err = f.read()
            report = next(
                (
                    json.loads(line[len(RESULT_PREFIX):])
                    for line in out.splitlines()
                    if line.startswith(RESULT_PREFIX)
                ),
                None,
            )
            if i in timed_out:
                failures.append(f"{names[i]}: timeout after {timeout}s\n{err[-2000:]}")
                continue
            if proc.returncode != 0 or report is None or not report.get("ok"):
                failures.append(
                    f"{names[i]}: rc={proc.returncode}, report={report}\n{err[-2000:]}"
                )
            workers.append(report)
    if failures:
        if any("timeout" in f for f in failures):
            # the overwhelmingly common cause: the rendezvous blocks until
            # EVERY rank in the derived world connects, so one missing
            # worker wedges the whole gang with no error anywhere — name
            # the failure mode instead of leaving a bare timeout
            failures.append(
                "hint: a timed-out gang usually means a worker in the derived "
                "world never started (missing pod, wrong TPU_WORKER_HOSTNAMES, "
                "or a MEGASCALE_* mismatch) — the rendezvous waits "
                "for all of them"
            )
        raise RuntimeError("multiprocess check failed:\n" + "\n".join(failures))
    return workers


def _summarize(workers, devices_per_worker: int) -> dict:
    summary = {
        "num_workers": len({w["process_id"] for w in workers}),
        "devices_per_worker": devices_per_worker,
        "global_devices": workers[0]["global_devices"],
        "psum_ok": all(w["psum_ok"] for w in workers),
        "psum_chain_ms": max(w["psum_chain_ms"] for w in workers),
        "ring_attention_max_err": max(w["ring_attention_max_err"] for w in workers),
        "workers": workers,
        "ok": True,
    }
    # the gang step-time artifact: each host's timing (its local rank 0's)
    # merged into gang median + straggler ratio (the shape the slice
    # manager publishes onto the gang ConfigMap)
    per_host = {
        w["step_telemetry"].get("host", f"worker-{w['process_id']}"): w["step_telemetry"]
        for w in workers
        if w["local_rank"] == 0 and w.get("step_telemetry")
    }
    if per_host:
        from tpu_operator_torch.workloads.telemetry import merge_gang_reports

        summary["gang_telemetry"] = merge_gang_reports(per_host)
    return summary


def run_multiprocess_check(
    num_workers: int = 2,
    devices_per_worker: int = 4,
    gang_env: Optional[Mapping[str, str]] = None,
    timeout: float = 300.0,
    device: DeviceLike = None,
) -> dict:
    """Start ``num_workers`` gang workers of ``devices_per_worker`` ranks
    each and collect their reports.

    ``gang_env``: the gang ConfigMap data as the slice manager rendered it
    (``slice_manager_agent._apply_gang_configmap``); hostnames are rewritten
    to loopback since the headless Service's DNS does not exist here. When
    omitted, a minimal contract-shaped env is synthesized.
    """
    dev = resolve_device(device)
    if gang_env is None:
        gang_env = {
            "TPU_WORKER_HOSTNAMES": ",".join("127.0.0.1" for _ in range(num_workers)),
        }
    hostnames = [h for h in gang_env["TPU_WORKER_HOSTNAMES"].split(",") if h]
    if len(hostnames) != num_workers:
        raise ValueError(
            f"gang env lists {len(hostnames)} workers, launcher asked for {num_workers}"
        )
    base = _localize_gang_env(gang_env, _free_port())
    # a multi-slice env derives a world larger than this launcher spawns
    # (config_from_env multiplies by MEGASCALE_NUM_SLICES): the gang
    # would wait for processes that never start — fail fast
    from tpu_operator_torch.workloads.distributed import config_from_env

    derived = config_from_env(dict(base, TPU_WORKER_ID="0"))
    if derived.num_processes != num_workers:
        raise ValueError(
            f"gang env derives a {derived.num_processes}-process world but the "
            f"launcher spawns {num_workers} — multi-slice envs need "
            "run_multislice_check"
        )
    _check_cards(dev, num_workers * devices_per_worker)
    worker_envs = [dict(base, TPU_WORKER_ID=str(i)) for i in range(num_workers)]
    workers = _launch_workers(worker_envs, devices_per_worker, timeout, dev)
    return _summarize(workers, devices_per_worker)


def run_multislice_check(
    num_slices: int = 2,
    hosts_per_slice: int = 1,
    devices_per_worker: int = 4,
    gang_envs: Optional[list] = None,
    timeout: float = 300.0,
    device: DeviceLike = None,
) -> dict:
    """ONE distributed job spanning slices over the DCN coordinator. Each
    worker receives its own slice's gang env (MEGASCALE_COORDINATOR_ADDRESS
    / NUM_SLICES / SLICE_ID plus the per-slice hostname list) and derives
    the global world from it (``distributed.config_from_env``); slice 0's
    worker 0 coordinates, exactly as the slice manager wires it in-cluster.

    ``gang_envs``: one rendered gang ConfigMap per slice (the slice
    manager's multi_slice output); synthesized when omitted.
    """
    dev = resolve_device(device)
    if gang_envs is None:
        hostnames = ",".join("127.0.0.1" for _ in range(hosts_per_slice))
        gang_envs = [
            {
                "TPU_WORKER_HOSTNAMES": hostnames,
                "MEGASCALE_COORDINATOR_ADDRESS": "127.0.0.1",
                "MEGASCALE_NUM_SLICES": str(num_slices),
                "MEGASCALE_SLICE_ID": str(i),
            }
            for i in range(num_slices)
        ]
    if len(gang_envs) != num_slices:
        raise ValueError(f"{len(gang_envs)} gang envs for {num_slices} slices")
    host_counts = {
        len([h for h in env.get("TPU_WORKER_HOSTNAMES", "").split(",") if h])
        for env in gang_envs
    }
    if len(host_counts) != 1:
        # heterogeneous slices compute inconsistent world sizes and
        # colliding process ids (config_from_env derives the world from
        # the LOCAL slice's host count) — deadlock at initialize
        raise ValueError(f"slices must be uniform; host counts differ: {host_counts}")
    declared = {env.get("MEGASCALE_NUM_SLICES") for env in gang_envs}
    if declared != {str(num_slices)}:
        raise ValueError(
            f"gang envs declare MEGASCALE_NUM_SLICES={declared}, launcher runs {num_slices}"
        )
    slice_ids = [env.get("MEGASCALE_SLICE_ID") for env in gang_envs]
    if len(set(slice_ids)) != num_slices:
        # duplicate ids derive colliding process ids: two workers claim
        # the same slot and initialize hangs waiting for the missing one
        raise ValueError(f"MEGASCALE_SLICE_ID values must be distinct: {slice_ids}")
    port = _free_port()
    worker_envs = []
    for slice_env in gang_envs:
        localized = _localize_gang_env(slice_env, port)
        n_hosts = len([h for h in localized["TPU_WORKER_HOSTNAMES"].split(",") if h])
        for worker_id in range(n_hosts):
            worker_envs.append(dict(localized, TPU_WORKER_ID=str(worker_id)))
    _check_cards(dev, len(worker_envs) * devices_per_worker)
    workers = _launch_workers(worker_envs, devices_per_worker, timeout, dev)
    report = _summarize(workers, devices_per_worker)
    report["num_slices"] = num_slices
    return report


if __name__ == "__main__":
    worker_main()
