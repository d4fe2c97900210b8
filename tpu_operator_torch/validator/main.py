"""tpu-validator's in-pod components on the card (port of
``tpu_operator/validator/main.py``).

Two components are ported, the two that do accelerator work:

    smoke   the payload of the workload pod (the ``vectorAdd`` analog):
            the device smoke on every local card, then, with a
            ``minTflops`` floor configured, the bf16 matmul rate of every
            card, the slowest held to the floor;
    slice   the multi-host check: the gang's world from its env (one rank
            per local card), the all-reduce in GB/s per card (held to
            ``minPsumGbpsPerChip`` on more than one card), the ring
            attention, pipeline and flash checks and the collective
            primitives; writes ``slice-ready``.

The dispatch on ``COMPONENT``, the retry loop and the status files are
the reference's. Its other components (``libtpu``, ``plugin``,
``workload``) do no accelerator work.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Dict, Optional

from tpu_operator_torch.device import DeviceLike, local_devices
from tpu_operator_torch.validator import status as status_files

log = logging.getLogger(__name__)


@dataclasses.dataclass
class Context:
    node_name: str = ""
    validation_dir: str = status_files.VALIDATION_DIR
    retry_interval: float = 5.0
    expected_chips: Optional[int] = None
    # performance floors (spec.validator.minTflops / minPsumGbpsPerChip):
    # below one, validation fails and the status file is withheld
    min_tflops: Optional[float] = None
    min_psum_gbps_per_chip: Optional[float] = None
    # where the payloads run: every CUDA device unless "cpu" is named
    device: DeviceLike = None

    @classmethod
    def from_env(cls) -> "Context":
        return cls(
            node_name=os.environ.get("NODE_NAME", ""),
            validation_dir=os.environ.get("VALIDATION_DIR", status_files.VALIDATION_DIR),
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


def floors_for(generation: str, floors_blob: Optional[str]) -> Dict[str, float]:
    """The floor map for one generation from a floors.json blob; {} when
    the generation is absent or the blob is malformed. (Copy of
    ``tpu_operator/perf.py::floors_for`` without its built-in table: that
    table holds TPU generations only, and a card never takes their
    floors.)"""
    try:
        table = json.loads(floors_blob) if floors_blob else {}
    except (ValueError, TypeError):
        return {}
    entry = table.get(generation) if isinstance(table, dict) else None
    if not isinstance(entry, dict):
        return {}
    out: Dict[str, float] = {}
    for probe, value in entry.items():
        try:
            out[str(probe)] = float(value)
        except (TypeError, ValueError):
            continue
    return out


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
    "smoke": (validate_smoke, None),
    "slice": (validate_slice, "slice-ready"),
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
    if component not in COMPONENTS:
        log.error("unknown COMPONENT %r (valid: %s)", component, ", ".join(COMPONENTS))
        return 1
    run_component(component, Context.from_env())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
