"""tpu-validator's components on the card (port of
``tpu_operator/validator/main.py``).

    driver    the driver-validation analog (the reference's ``libtpu``): the
              install dir carries the driver library (``libcuda.so.1``) and
              the installer's ready marker; on a card the installed library
              must also answer: loaded in a process of its own, ``cuInit``
              succeeds and ``cuDeviceGetCount`` equals the card probe's
              count; writes ``driver-ready``;
    plugin    the device plugin advertises the card: polls the node's
              allocatable ``nvidia.com/gpu`` until it is positive; writes
              ``plugin-ready``;
    workload  schedules the workload pod (``workload_pod``: the smoke
              under a ``nvidia.com/gpu`` limit, through the scheduler) and
              waits for it to succeed; writes ``workload-ready``;
    smoke     the payload of the workload pod (the ``vectorAdd`` analog):
              the device smoke on every local card, then, with a
              ``minTflops`` floor configured, the bf16 matmul rate of every
              card, the slowest held to the floor;
    slice     the multi-host check: the gang's world from its env (one rank
              per local card), the all-reduce in GB/s per card (held to
              ``minPsumGbpsPerChip`` on more than one card), the ring
              attention, pipeline and flash checks and the collective
              primitives; writes ``slice-ready``.

The dispatch on ``COMPONENT``, the retry loop and the status files are
the reference's; the node-status exporter (the reference's ``metrics``) is
``validator/metrics.py``.

    COMPONENT=workload python -m tpu_operator_torch.validator.main

runs one component in a cluster (``NODE_NAME``, ``OPERATOR_NAMESPACE``,
``LIBTPU_INSTALL_DIR``, ``VALIDATOR_IMAGE``, ``EXPECTED_CHIPS`` and the
floors from the env).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import subprocess
import sys
import time
from typing import Dict, Optional

from tpu_operator_torch import consts
from tpu_operator_torch.device import DeviceLike, local_devices, resolve_device
from tpu_operator_torch.kube import is_api_error, new_object
from tpu_operator_torch.perf import floors_for
from tpu_operator_torch.validator import status as status_files

log = logging.getLogger(__name__)


@dataclasses.dataclass
class Context:
    # an apiserver client (the plugin and workload components need one)
    client: object = None
    node_name: str = ""
    namespace: str = consts.DEFAULT_OPERATOR_NAMESPACE
    validation_dir: str = status_files.VALIDATION_DIR
    install_dir: str = consts.LIBTPU_INSTALL_DIR
    validator_image: str = ""
    retry_interval: float = 5.0
    resource_poll_retries: int = 30
    pod_wait_retries: int = 60
    expected_chips: Optional[int] = None
    # performance floors (spec.validator.minTflops / minPsumGbpsPerChip):
    # below one, validation fails and the status file is withheld
    min_tflops: Optional[float] = None
    min_psum_gbps_per_chip: Optional[float] = None
    # where the payloads run: every CUDA device unless "cpu" is named
    device: DeviceLike = None

    @classmethod
    def from_env(cls, client=None) -> "Context":
        return cls(
            client=client,
            node_name=os.environ.get("NODE_NAME", ""),
            namespace=os.environ.get(consts.OPERATOR_NAMESPACE_ENV,
                                     consts.DEFAULT_OPERATOR_NAMESPACE),
            validation_dir=os.environ.get("VALIDATION_DIR", status_files.VALIDATION_DIR),
            install_dir=os.environ.get("LIBTPU_INSTALL_DIR", consts.LIBTPU_INSTALL_DIR),
            validator_image=os.environ.get("VALIDATOR_IMAGE", ""),
            expected_chips=int(os.environ["EXPECTED_CHIPS"]) if os.environ.get("EXPECTED_CHIPS") else None,
            # `is None`, not `or`: an explicit MIN_TFLOPS=0 means "floor
            # disabled" and must not fall through to the published table
            min_tflops=(
                _float_env("MIN_TFLOPS")
                if os.environ.get("MIN_TFLOPS", "").strip()
                else _floor_tflops_from_env()
            ),
            min_psum_gbps_per_chip=_float_env("MIN_PSUM_GBPS_PER_CHIP"),
        )


def _float_env(name: str) -> Optional[float]:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return None
    try:
        return float(raw)
    except ValueError:
        log.warning("invalid %s %r; floor disabled", name, raw)
        return None


def _floor_tflops_from_env() -> Optional[float]:
    """minTflops fallback: the operator-published per-generation floor
    table (PERF_FLOORS_JSON), keyed by this card's generation. None when
    unset, on an unrecognised card, or when the table has no entry for
    it: the floor never guesses."""
    blob = os.environ.get("PERF_FLOORS_JSON", "").strip()
    if not blob:
        return None
    from tpu_operator_torch.workloads.matmul_bench import chip_generation

    gen = chip_generation()
    if not gen:
        return None
    return floors_for(gen, blob).get("matmul_tflops")


def enforce_floor(what: str, measured: float, floor: Optional[float]) -> None:
    """Raise (→ retry loop → NotReady) when a measured rate is below its
    configured floor; no-op when no floor is set."""
    if floor is not None and measured < floor:
        raise RuntimeError(
            f"{what} {measured:.2f} below configured floor {floor:.2f}"
        )


# loads the library named by argv[1] and prints "<CUresult> <device count>"
_DRIVER_COUNT = (
    "import ctypes, sys\n"
    "lib = ctypes.CDLL(sys.argv[1])\n"
    "count = ctypes.c_int()\n"
    "rc = lib.cuInit(0) or lib.cuDeviceGetCount(ctypes.byref(count))\n"
    "print(rc, count.value)\n"
)


def driver_card_count(library: str) -> int:
    """The cards the driver library at ``library`` reports (``cuInit``, then
    ``cuDeviceGetCount``), asked in a process of its own: a second copy of
    the driver library in a process that already holds one is not loaded
    beside it. Every card of the node counts (``CUDA_VISIBLE_DEVICES`` is
    dropped). Raises when the driver does not answer."""
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    proc = subprocess.run([sys.executable, "-c", _DRIVER_COUNT, library], env=env,
                          capture_output=True, text=True, timeout=120)
    fields = proc.stdout.split()
    if proc.returncode != 0 or len(fields) != 2 or fields[0] != "0":
        raise RuntimeError(f"driver library {library} did not answer (exit {proc.returncode}, "
                           f"output {proc.stdout.strip()!r}): {proc.stderr[-1000:]}")
    return int(fields[1])


def validate_driver(ctx: Context) -> dict:
    """The driver is ready when the install dir carries the driver library
    and the installer's ready marker (the reference's ``validate_libtpu``).
    On a card (``ctx.device`` not the CPU) the installed library must also
    report as many cards as the card probe finds."""
    lib = os.path.join(ctx.install_dir, consts.DRIVER_LIBRARY)
    marker = os.path.join(ctx.install_dir, consts.LIBTPU_CTR_READY_FILE)
    if not os.path.exists(lib):
        raise RuntimeError(f"{consts.DRIVER_LIBRARY} not found at {lib}")
    if not os.path.exists(marker):
        raise RuntimeError(f"installer ready marker missing: {marker}")
    payload = {"library": lib, "size": os.path.getsize(lib)}
    if resolve_device(ctx.device).type == "cpu":
        return payload
    from tpu_operator_torch.native import gpuinfo

    cards = driver_card_count(lib)
    inventory = gpuinfo.probe()
    if cards != inventory["chip_count"]:
        raise RuntimeError(f"the driver reports {cards} card(s), the probe finds "
                           f"{inventory['chip_count']}")
    payload.update(cards=cards, driver_version=inventory["driver_version"])
    return payload


def validate_plugin(ctx: Context) -> dict:
    """The device plugin advertises the card: poll this node's allocatable
    for ``nvidia.com/gpu``."""
    if ctx.client is None or not ctx.node_name:
        raise RuntimeError("plugin validation requires a kube client and NODE_NAME")
    for _ in range(ctx.resource_poll_retries):
        node = ctx.client.get_or_none("v1", "Node", ctx.node_name)
        if node is not None:
            allocatable = node.get("status", {}).get("allocatable", {}) or {}
            chips = int(allocatable.get(consts.GPU_RESOURCE_NAME, "0") or "0")
            if chips > 0:
                return {"resource": consts.GPU_RESOURCE_NAME, "chips": chips}
        time.sleep(ctx.retry_interval)
    raise RuntimeError(
        f"{consts.GPU_RESOURCE_NAME} never became allocatable on {ctx.node_name}"
    )


def workload_pod(ctx: Context) -> dict:
    """The workload pod: the smoke (``workload_entry``) under a
    ``nvidia.com/gpu`` limit, restartPolicy Never."""
    return new_object(
        "v1",
        "Pod",
        f"tpu-workload-validation-{ctx.node_name or 'node'}",
        ctx.namespace,
        labels={"app": "tpu-workload-validation"},
        spec={
            "restartPolicy": "Never",
            # scheduled through the scheduler (hostname selector and the
            # card limit below), so the pod exercises the same resource
            # accounting plugin validation just proved
            "nodeSelector": (
                {"kubernetes.io/hostname": ctx.node_name} if ctx.node_name else None
            ),
            "tolerations": [
                {"key": consts.GPU_RESOURCE_NAME, "operator": "Exists", "effect": "NoSchedule"},
                # validation runs while the upgrade FSM still has the node
                # cordoned, so the pod must tolerate the cordon taint
                {
                    "key": "node.kubernetes.io/unschedulable",
                    "operator": "Exists",
                    "effect": "NoSchedule",
                },
            ],
            "containers": [
                {
                    "name": "tpu-smoke",
                    "image": ctx.validator_image or "tpu-operator-validator",
                    "command": ["python", "-m", "tpu_operator_torch.validator.workload_entry"],
                    "env": [
                        {"name": "COMPONENT", "value": "smoke"},
                        *(
                            [{"name": "EXPECTED_CHIPS", "value": str(ctx.expected_chips)}]
                            if ctx.expected_chips
                            else []
                        ),
                        *(
                            [{"name": "MIN_TFLOPS", "value": str(ctx.min_tflops)}]
                            if ctx.min_tflops is not None
                            else []
                        ),
                    ],
                    "resources": {
                        "limits": {consts.GPU_RESOURCE_NAME: str(ctx.expected_chips or 1)}
                    },
                }
            ],
        },
    )


def validate_workload(ctx: Context) -> dict:
    """Schedule the workload pod, wait for Succeeded (raise on Failed),
    and delete it whatever the outcome."""
    if ctx.client is None:
        raise RuntimeError("workload validation requires a kube client")
    pod = workload_pod(ctx)
    name, ns = pod["metadata"]["name"], ctx.namespace
    if ctx.client.get_or_none("v1", "Pod", name, ns) is not None:
        ctx.client.delete("v1", "Pod", name, ns)  # stale from a previous attempt
    ctx.client.create(pod)
    try:
        for _ in range(ctx.pod_wait_retries):
            live = ctx.client.get_or_none("v1", "Pod", name, ns)
            phase = (live or {}).get("status", {}).get("phase")
            if phase == "Succeeded":
                return {"pod": name, "phase": phase}
            if phase == "Failed":
                raise RuntimeError(f"workload pod {name} failed")
            time.sleep(ctx.retry_interval)
        raise RuntimeError(f"workload pod {name} did not succeed in time")
    finally:
        try:
            ctx.client.delete("v1", "Pod", name, ns)
        except Exception as e:  # noqa: BLE001 — matched by name, else re-raised
            if not is_api_error(e, "ApiError"):
                raise


def validate_smoke(ctx: Context) -> dict:
    """In-pod payload of the workload pod (the vectorAdd itself). With a
    minTflops floor configured, also measures the bf16 matmul rate on
    every local card and fails below the floor: a throttled or degraded
    card passes the correctness check but not this one."""
    from tpu_operator_torch.workloads import smoke

    report = smoke.run_smoke(expected_devices=ctx.expected_chips, device=ctx.device)
    if ctx.min_tflops is not None:
        from tpu_operator_torch.workloads.matmul_bench import matmul_tflops

        # measure EVERY local card and gate on the slowest: one throttled
        # card must not hide behind a healthy default device
        rates = {}
        for dev in local_devices(ctx.device):
            mm = matmul_tflops(size=4096, iters=8, device=dev)
            rates[str(dev)] = round(mm["tflops"], 2)
        report["matmul_bf16_tflops_per_chip"] = rates
        slowest = min(rates, key=rates.get)
        report["matmul_bf16_tflops"] = rates[slowest]
        enforce_floor(
            f"bf16 matmul TFLOP/s ({slowest})", rates[slowest], ctx.min_tflops
        )
    return report


def _validate_slice_rank(local_rank: int, ctx: Context, local_size: int) -> dict:
    """One rank's slice check in the gang's world (the reference's order
    and sizes)."""
    import torch.distributed as dist

    from tpu_operator_torch.workloads import (
        allreduce,
        collectives,
        distributed,
        flashattention,
        pipeline,
        ringattention,
    )

    with distributed.gang_world(local_rank=local_rank, local_size=local_size,
                                device=ctx.device) as gang:
        report = allreduce.run_allreduce(device=ctx.device)
        report["hosts"] = gang.num_processes
        report["process_id"] = gang.process_id
        if report.get("devices", 0) > 1:
            # the bandwidth floor only means something on a real
            # multi-card ring; one card measures a local copy, not a link
            enforce_floor(
                "psum bus GB/s/chip",
                report.get("peak_busbw_gbps_per_chip", 0.0),
                ctx.min_psum_gbps_per_chip,
            )
        n = dist.get_world_size()
        report["ring_attention"] = ringattention.run_ring_attention_check(
            seq_len=max(128, 32 * n)
        )
        report["pipeline"] = pipeline.run_pipeline_check()
        # the within-card half of the long-context story: the flash
        # kernels must agree with dense attention on this node's card
        report["flash_attention"] = flashattention.run_flash_attention_check(
            seq_len=256, block_q=128, block_k=128, device=ctx.device
        )
        # and the two levels composed: flash as the ring's local attention
        report["ring_flash_attention"] = ringattention.run_ring_attention_check(
            seq_len=max(128, 32 * n), local_impl="flash"
        )
        # the full collective-primitive set; max(n, ...) keeps the payload
        # nonzero on worlds wider than 2048
        report["collectives"] = collectives.run_collectives_check(
            per_device=max(n, (2048 // n) * n), device=ctx.device
        )
    return report


def validate_slice(ctx: Context) -> dict:
    """Multi-host check: every local card is one rank of the gang's world
    (``distributed.gang_world`` from the gang env), which runs the
    all-reduce (GB/s per card), the ring attention over the whole world,
    the pipeline over it, the flash check on each card, the flash ring
    and the collective primitives. One card runs in this process; K cards
    start K ranks, and local rank 0's report is the pod's."""
    from tpu_operator_torch.workloads.distributed import spawn_ranks

    local = len(local_devices(ctx.device))
    if local == 1:
        return _validate_slice_rank(0, ctx, 1)
    return spawn_ranks(local, _validate_slice_rank, (ctx, local), device=ctx.device)[0]


COMPONENTS: Dict[str, tuple] = {
    # name -> (fn, status file)
    "driver": (validate_driver, consts.DRIVER_READY_FILE),
    "plugin": (validate_plugin, consts.PLUGIN_READY_FILE),
    "workload": (validate_workload, consts.WORKLOAD_READY_FILE),
    "slice": (validate_slice, "slice-ready"),
    "smoke": (validate_smoke, None),
}


def run_component(
    name: str,
    ctx: Context,
    max_attempts: Optional[int] = None,
) -> dict:
    """Retry-forever loop: clear the stale status file, run the check
    every retry_interval until it passes, then write the status file
    other operands are blocked on."""
    fn, ready_file = COMPONENTS[name]
    if ready_file:
        status_files.clear_status(ready_file, ctx.validation_dir)
    attempt = 0
    while True:
        attempt += 1
        try:
            payload = fn(ctx)
            break
        except Exception as e:  # noqa: BLE001 — every failure retries, like the reference
            log.warning("validation %s attempt %d failed: %s", name, attempt, e)
            if max_attempts is not None and attempt >= max_attempts:
                raise
            time.sleep(ctx.retry_interval)
    if ready_file:
        status_files.write_status(ready_file, ctx.validation_dir, payload)
    return payload


def main() -> int:
    logging.basicConfig(level=logging.INFO)
    component = os.environ.get("COMPONENT", "")
    if component == "metrics":
        from tpu_operator_torch.validator.metrics import NodeMetrics

        NodeMetrics.from_env().run_forever()
        return 0
    if component not in COMPONENTS:
        log.error("unknown COMPONENT %r (valid: %s)", component, ", ".join(COMPONENTS))
        return 1
    client = None
    if os.environ.get("KUBERNETES_SERVICE_HOST"):
        # the plugin and workload components talk to the apiserver; inside
        # a pod the in-cluster config is always present
        from tpu_operator_torch.kube import Client

        client = Client.in_cluster()
    run_component(component, Context.from_env(client=client))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
