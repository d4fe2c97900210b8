"""tpu-metrics-exporter on the card (port of
``tpu_operator/agents/metrics_exporter_agent.py``; the dcgm-exporter
analog).

One loop collects and serves. The series keep the reference's names, so
its dashboards and alerts read a card node unchanged:

    tpu_exporter_chips                visible cards
    tpu_exporter_hbm_used_bytes       per-card device memory in use
                                      (``torch.cuda.mem_get_info``: total
                                      less free, device-wide, the DCGM
                                      framebuffer-used reading, not this
                                      process's allocator)
    tpu_exporter_hbm_limit_bytes      per-card device memory
    tpu_exporter_hbm_bandwidth_gbps   the triad kernel's measured HBM rate
    tpu_exporter_ici_bandwidth_gbps   the all-reduce's bus rate per card
                                      over the node's cards (more than
                                      one card only)
    tpu_exporter_matmul_tflops        the measured bf16 matmul rate
    tpu_exporter_mxu_utilization_pct  that rate against the data-sheet
                                      peak of the card's generation

The probes are active: a burst borrows the card from any co-resident
tenant. ``TPU_EXPORTER_ACTIVE_PROBES`` decides:

    auto (default)  probe, and take a probe that fails to run as a card a
                    tenant holds: skip quietly
    on              probe, and count every failure as a collect error
    off             never probe (memory readings only)

and ``TPU_EXPORTER_PROBE_INTERVAL`` the seconds between bursts (600).

Grey-failure detection: the probes are held to this card's entry of the
perf floors (``consts.PERF_FLOORS_CONFIGMAP``, delivered as
``PERF_FLOORS_JSON`` and re-read from the ConfigMap before each burst),
with a rolling baseline per probe; after ``PERF_BREACH_SAMPLES``
consecutive samples below a floor the exporter sets
``tpu_exporter_perf_degraded{node,probe}`` and the node label
``tpu.google.com/perf=degraded``, which the health controller's repair
path and placement read. A sample at or above the floor clears both.

    python -m tpu_operator_torch.agents.metrics_exporter_agent [--port N]

serves on the node's cards (``METRICS_PORT``, default 8431).
"""

from __future__ import annotations

import collections
import logging
import os
import tempfile
import threading
import time
from typing import Dict, List, Optional

import prometheus_client
import torch

from tpu_operator_torch import consts
from tpu_operator_torch.device import DeviceLike, local_devices, resolve_device
from tpu_operator_torch.kube import is_api_error

log = logging.getLogger(__name__)

# rolling-baseline window per probe: enough history that the baseline
# gauge reflects the node's recent normal, small enough to stay O(1)
_BASELINE_WINDOW = 20


def _get_or_create(kind, name: str, doc: str, labelnames=(), registry=None):
    """Idempotent collector construction (copy of the reference's
    ``operator_metrics._get_or_create``): a second exporter on one
    registry reuses the series instead of tripping the duplicate
    registration error."""
    reg = registry or prometheus_client.REGISTRY
    try:
        return kind(name, doc, labelnames, registry=reg)
    except ValueError:
        # counters are indexed under the _total-stripped name; probe both
        existing = reg._names_to_collectors.get(name)
        if existing is None and name.endswith("_total"):
            existing = reg._names_to_collectors.get(name[: -len("_total")])
        if existing is None:
            raise
        return existing


def _ici_rank(rank: int, store_path: str, world: int, device: str) -> dict:
    """One rank of ``probe_ici``'s local world: the all-reduce at 16 MiB."""
    import torch.distributed as dist

    from tpu_operator_torch.workloads.allreduce import run_allreduce
    from tpu_operator_torch.workloads.distributed import init_local_world

    dev = init_local_world(rank, world, store_path, device)
    try:
        return run_allreduce(sizes_mb=(16,), iters=10, device=dev)
    finally:
        dist.destroy_process_group()


class MetricsExporterAgent:
    def __init__(
        self,
        node_name: str = "",
        port: int = 8431,
        interval: float = 30.0,
        bandwidth_probe_interval: float = 600.0,
        active_probes: str = "auto",
        registry: Optional[prometheus_client.CollectorRegistry] = None,
        client=None,
        floors: Optional[Dict[str, float]] = None,
        breach_samples: int = consts.PERF_BREACH_SAMPLES,
        namespace: str = consts.DEFAULT_OPERATOR_NAMESPACE,
        generation: str = "",
        device: DeviceLike = None,
        cpu_ranks: int = 1,
    ):
        if active_probes not in ("auto", "on", "off"):
            raise ValueError(f"active_probes must be auto/on/off, got {active_probes!r}")
        self.node_name = node_name or "unknown"
        self.port = port
        self.interval = interval
        self.bandwidth_probe_interval = bandwidth_probe_interval
        self.active_probes = active_probes
        self.registry = registry or prometheus_client.CollectorRegistry()
        # optional apiserver client: the perf label goes out through it;
        # without one the series still flip
        self.client = client
        # {probe: floor} for THIS node's generation; empty = detection
        # off. refresh_floors() re-reads the floors ConfigMap before each
        # burst, so a floor the operator tightens applies to the very next
        # comparison
        self.floors = dict(floors or {})
        self.namespace = namespace
        # the generation the floors are keyed by; empty disables hot-reload
        self.generation = generation
        # where the probes run: every CUDA card unless "cpu" is named;
        # the CPU counts `cpu_ranks` devices (the ranks probe_ici spawns)
        self.device = device
        self.cpu_ranks = cpu_ranks
        self.breach_samples = max(1, breach_samples)
        self._probe_history: Dict[str, collections.deque] = {}
        self._breach_counts: Dict[str, int] = {}
        self._degraded_probes: set = set()
        self._seen_chips: set = set()  # card ids with live per-card series
        self._perf_label_state: Optional[bool] = None  # last published
        reg = self.registry
        self.chips = _get_or_create(
            prometheus_client.Gauge, "tpu_exporter_chips", "Visible TPU chips",
            ["node"], registry=reg,
        )
        self.hbm_used = _get_or_create(
            prometheus_client.Gauge, "tpu_exporter_hbm_used_bytes",
            "HBM bytes in use", ["node", "chip"], registry=reg,
        )
        self.hbm_limit = _get_or_create(
            prometheus_client.Gauge, "tpu_exporter_hbm_limit_bytes",
            "HBM bytes capacity", ["node", "chip"], registry=reg,
        )
        self.hbm_bandwidth = _get_or_create(
            prometheus_client.Gauge, "tpu_exporter_hbm_bandwidth_gbps",
            "Measured triad HBM bandwidth", ["node"], registry=reg,
        )
        self.ici_bandwidth = _get_or_create(
            prometheus_client.Gauge, "tpu_exporter_ici_bandwidth_gbps",
            "Measured psum all-reduce bus bandwidth per chip (multi-chip hosts)",
            ["node"], registry=reg,
        )
        self.matmul_tflops = _get_or_create(
            prometheus_client.Gauge, "tpu_exporter_matmul_tflops",
            "Measured bf16 matmul throughput", ["node"], registry=reg,
        )
        self.mxu_utilization = _get_or_create(
            prometheus_client.Gauge, "tpu_exporter_mxu_utilization_pct",
            "Measured matmul throughput as % of the generation's MXU peak",
            ["node"], registry=reg,
        )
        self.collect_errors = _get_or_create(
            prometheus_client.Counter, "tpu_exporter_collect_errors_total",
            "Collection failures", ["node"], registry=reg,
        )
        self.perf_floor = _get_or_create(
            prometheus_client.Gauge, "tpu_exporter_perf_floor",
            "Per-generation perf floor this probe is held to",
            ["node", "probe"], registry=reg,
        )
        self.probe_baseline = _get_or_create(
            prometheus_client.Gauge, "tpu_exporter_probe_baseline",
            "Rolling median of recent probe samples (the node's normal)",
            ["node", "probe"], registry=reg,
        )
        self.perf_degraded = _get_or_create(
            prometheus_client.Gauge, "tpu_exporter_perf_degraded",
            "1 while the probe has sustained below its floor (N "
            "consecutive samples) — a grey failure, not a dead chip",
            ["node", "probe"], registry=reg,
        )
        self._stop = threading.Event()

    # -- collection -----------------------------------------------------------

    def _devices(self) -> List[torch.device]:
        """The cards the exporter covers: every CUDA device, or
        ``cpu_ranks`` CPU devices when the CPU is named."""
        devices = local_devices(self.device)
        if devices and devices[0].type == "cpu":
            return [torch.device("cpu")] * self.cpu_ranks
        return devices

    def collect_device_stats(self) -> None:
        """Card inventory and device memory in use, device-wide
        (``torch.cuda.mem_get_info``: the DCGM framebuffer-used reading)."""
        try:
            devices = self._devices()
        except Exception as e:  # noqa: BLE001 — no CUDA runtime -> no cards
            log.warning("metrics: CUDA runtime unavailable: %s", e)
            self.collect_errors.labels(self.node_name).inc()
            self.chips.labels(self.node_name).set(0)
            self._retire_stale_series(chips=0)
            self._retire_vanished_chips(set())
            return
        self.chips.labels(self.node_name).set(len(devices))
        self._retire_stale_series(chips=len(devices))
        present = set()
        for i, dev in enumerate(devices):
            chip = str(dev.index if dev.type == "cuda" else i)
            present.add(chip)
            if dev.type != "cuda":
                continue  # the CPU has no device memory to read
            free, total = torch.cuda.mem_get_info(dev)
            self.hbm_used.labels(self.node_name, chip).set(total - free)
            self.hbm_limit.labels(self.node_name, chip).set(total)
        self._retire_vanished_chips(present)

    # -- stale-series hygiene -------------------------------------------------

    def _retire_vanished_chips(self, present: set) -> None:
        """Per-card memory series of cards no longer visible go with the
        cards: a vanished card frozen at 95% would keep the near-capacity
        alert firing for hardware that no longer exists."""
        for chip in self._seen_chips - present:
            for gauge in (self.hbm_used, self.hbm_limit):
                try:
                    gauge.remove(self.node_name, chip)
                except KeyError:
                    pass
        self._seen_chips = set(present)

    def _remove_probe_series(self, probe: str) -> None:
        """Drop one probe's floor/baseline/degraded series and its
        detection state, without touching the node perf label (hardware
        going away is the health agent's verdict to make, and "the probe
        can no longer run" is not recovery evidence)."""
        for gauge in (self.perf_floor, self.probe_baseline, self.perf_degraded):
            try:
                gauge.remove(self.node_name, probe)
            except KeyError:
                pass
        self._probe_history.pop(probe, None)
        self._breach_counts.pop(probe, None)
        self._degraded_probes.discard(probe)

    def _retire_stale_series(self, chips: int) -> None:
        """A gauge that outlives its hardware keeps exporting the last
        value forever. One card or none retires the interconnect series
        (no link to measure); none retires every probe-derived series
        (nothing can probe)."""
        if chips > 1:
            return
        try:
            self.ici_bandwidth.remove(self.node_name)
        except KeyError:
            pass
        self._remove_probe_series("ici_gbps")
        if chips > 0:
            return
        for probe in set(self._probe_history) | set(self.floors):
            self._remove_probe_series(probe)
        for gauge in (self.hbm_bandwidth, self.matmul_tflops, self.mxu_utilization):
            try:
                gauge.remove(self.node_name)
            except KeyError:
                pass

    # -- grey-failure detection ----------------------------------------------

    def refresh_floors(self) -> bool:
        """Hot-reload the floor table from the live perf-floors ConfigMap
        (the env is frozen at pod start). Any failure keeps the current
        floors (stale but sane beats detection flapping on apiserver
        blips). Returns True when the table changed."""
        if self.client is None or not self.generation:
            return False
        from tpu_operator_torch.perf import floors_for

        try:
            cm = self.client.get_or_none(
                "v1", "ConfigMap", consts.PERF_FLOORS_CONFIGMAP, self.namespace
            )
        except Exception as e:  # noqa: BLE001 — matched by name, else re-raised
            if not is_api_error(e, "ApiError"):
                raise
            log.debug("metrics: floors ConfigMap read failed: %s", e)
            return False
        if cm is None:
            return False
        blob = (cm.get("data") or {}).get(consts.PERF_FLOORS_KEY, "")
        fresh = floors_for(self.generation, blob)
        if not fresh or fresh == self.floors:
            return False
        log.info("metrics: perf floors updated for %s: %s -> %s",
                 self.generation, self.floors, fresh)
        self.floors = fresh
        return True

    def observe_probe(self, probe: str, value: float) -> bool:
        """Feed one measured probe sample through the floor comparison:
        updates the rolling baseline, counts consecutive below-floor
        samples, flips ``tpu_exporter_perf_degraded{node,probe}`` on
        sustained breach, and (re)publishes the node perf label when the
        node-level verdict changes. Returns True while this probe is in
        sustained breach. A probe with no floor only feeds the baseline."""
        history = self._probe_history.setdefault(
            probe, collections.deque(maxlen=_BASELINE_WINDOW)
        )
        history.append(value)
        ordered = sorted(history)
        self.probe_baseline.labels(self.node_name, probe).set(ordered[len(ordered) // 2])
        floor = self.floors.get(probe)
        if floor is None:
            return False
        self.perf_floor.labels(self.node_name, probe).set(floor)
        if value < floor:
            self._breach_counts[probe] = self._breach_counts.get(probe, 0) + 1
        else:
            self._breach_counts[probe] = 0
        breached = self._breach_counts[probe] >= self.breach_samples
        self.perf_degraded.labels(self.node_name, probe).set(1 if breached else 0)
        if breached and probe not in self._degraded_probes:
            log.warning(
                "metrics: %s sustained below floor on %s (%.2f < %.2f for %d samples)",
                probe, self.node_name, value, floor, self.breach_samples,
            )
            self._degraded_probes.add(probe)
        elif not breached:
            self._degraded_probes.discard(probe)
        self._publish_perf_label()
        return breached

    def _recovery_evidence(self) -> bool:
        """Whether the sampled history affirms recovery: at least one
        floored probe observed, and every observed floored probe's latest
        sample at or above its floor. A restarted exporter's empty
        counters are not recovery."""
        sampled = [p for p in self.floors if p in self._probe_history]
        return bool(sampled) and all(self._breach_counts.get(p) == 0 for p in sampled)

    def _publish_perf_label(self) -> None:
        """Set or clear ``tpu.google.com/perf=degraded`` when the node-level
        verdict (any probe in sustained breach) changes: a labels-only merge
        patch; a failed write retries on the next sample. A clear also
        needs recovery evidence (above)."""
        degraded = bool(self._degraded_probes)
        if self.client is None or degraded == self._perf_label_state:
            return
        if not degraded and not self._recovery_evidence():
            return
        try:
            self.client.patch(
                "v1", "Node", self.node_name,
                {"metadata": {"labels": {
                    consts.TPU_PERF_LABEL: consts.PERF_DEGRADED if degraded else None
                }}},
            )
        except Exception as e:  # noqa: BLE001 — matched by name, else re-raised
            if not is_api_error(e, "ApiError"):
                raise
            log.warning("metrics: perf label publish failed: %s", e)
            return
        self._perf_label_state = degraded
        log.info("metrics: node %s perf label %s", self.node_name,
                 "degraded" if degraded else "cleared")

    def probe_bandwidth(self) -> None:
        """Active HBM probe: the triad kernel, chained and timed by the
        two-point slope (``hbm_bandwidth_probe(size_mb=64, iters=25)``)."""
        try:
            from tpu_operator_torch.workloads.kernels import hbm_bandwidth_probe

            report = hbm_bandwidth_probe(size_mb=64, iters=25, device=self.device)
            self.hbm_bandwidth.labels(self.node_name).set(report["bandwidth_gbps"])
            if not report.get("unstable_timing"):
                # an unstable slope is a lower bound, not a measurement
                self.observe_probe("triad_gbps", report["bandwidth_gbps"])
        except Exception as e:  # noqa: BLE001
            self._probe_failed("bandwidth", e)

    def probe_ici(self) -> None:
        """Active interconnect probe: the all-reduce at 16 MiB over every
        card of the node, one rank per card (``cpu_ranks`` gloo ranks on
        the CPU), rank 0's bus rate per card. One card has no link: the
        gauge stays absent rather than reporting a local copy."""
        try:
            devices = self._devices()
            if len(devices) < 2:
                return
            from tpu_operator_torch.workloads.distributed import spawn_ranks

            kind = devices[0].type
            with tempfile.TemporaryDirectory() as tmp:
                reports = spawn_ranks(
                    len(devices), _ici_rank,
                    (os.path.join(tmp, "store"), len(devices), kind), device=kind,
                )
            busbw = reports[0]["peak_busbw_gbps_per_chip"]
            self.ici_bandwidth.labels(self.node_name).set(busbw)
            self.observe_probe("ici_gbps", busbw)
        except Exception as e:  # noqa: BLE001
            self._probe_failed("ici", e)

    def probe_utilization(self) -> None:
        """Active compute probe: the bf16 matmul rate (and % of the
        generation's data-sheet peak when known), the DCGM-utilization
        analog."""
        try:
            from tpu_operator_torch.workloads.matmul_bench import (
                PEAK_TFLOPS,
                chip_generation,
                matmul_tflops,
            )

            on_card = resolve_device(self.device).type == "cuda"
            # the 8192/16 configuration matches the headline probe: shorter
            # chains under-resolve the per-step time
            report = matmul_tflops(size=8192 if on_card else 256,
                                   iters=16 if on_card else 2, device=self.device)
            self.matmul_tflops.labels(self.node_name).set(report["tflops"])
            if on_card and not report.get("unstable_timing"):
                self.observe_probe("matmul_tflops", report["tflops"])
            gen = chip_generation()
            if on_card and gen in PEAK_TFLOPS and not report.get("unstable_timing"):
                self.mxu_utilization.labels(self.node_name).set(
                    100.0 * report["tflops"] / PEAK_TFLOPS[gen]
                )
        except Exception as e:  # noqa: BLE001
            self._probe_failed("utilization", e)

    def _probe_failed(self, what: str, exc: Exception) -> None:
        """In ``auto`` mode a probe that cannot run means a tenant holds
        the card: skip quietly. ``on`` counts the failure."""
        if self.active_probes == "auto":
            log.info("metrics: %s probe skipped (card busy or unavailable): %s", what, exc)
            return
        log.warning("metrics: %s probe failed: %s", what, exc)
        self.collect_errors.labels(self.node_name).inc()

    # -- server ---------------------------------------------------------------

    def run_forever(self) -> None:
        prometheus_client.start_http_server(self.port, registry=self.registry)
        last_probe = 0.0
        while not self._stop.is_set():
            self.collect_device_stats()
            now = time.monotonic()
            if (
                self.active_probes != "off"
                and now - last_probe >= self.bandwidth_probe_interval
            ):
                self.refresh_floors()
                self.probe_bandwidth()
                self.probe_utilization()
                self.probe_ici()
                last_probe = now
            self._stop.wait(self.interval)

    def stop(self) -> None:
        self._stop.set()


def floors_from_env() -> Dict[str, float]:
    """This card's floor map from the ``PERF_FLOORS_JSON`` blob the
    perf-floors ConfigMap delivers, keyed by ``chip_generation()``; {}
    (detection off) for an unrecognised card or none."""
    from tpu_operator_torch.perf import floors_for
    from tpu_operator_torch.workloads.matmul_bench import chip_generation

    gen = chip_generation()
    if not gen:
        return {}
    return floors_for(gen, os.environ.get("PERF_FLOORS_JSON", ""))


def main() -> int:
    logging.basicConfig(level=logging.INFO)
    import argparse

    from tpu_operator_torch.kube import Client
    from tpu_operator_torch.workloads.matmul_bench import chip_generation

    p = argparse.ArgumentParser("tpu-metrics-exporter")
    p.add_argument("--port", type=int, default=None)
    args = p.parse_args()
    port = args.port
    if port is None:
        # a malformed METRICS_PORT must not crash-loop the exporter
        try:
            port = int(os.environ.get("METRICS_PORT", "8431").strip())
        except ValueError:
            log.warning("invalid METRICS_PORT %r; using 8431", os.environ.get("METRICS_PORT"))
            port = 8431
    active = os.environ.get("TPU_EXPORTER_ACTIVE_PROBES", "auto").strip().lower()
    if active not in ("auto", "on", "off"):
        log.warning("invalid TPU_EXPORTER_ACTIVE_PROBES %r; using auto", active)
        active = "auto"
    try:
        probe_interval = float(os.environ.get("TPU_EXPORTER_PROBE_INTERVAL", "600").strip())
    except ValueError:
        log.warning("invalid TPU_EXPORTER_PROBE_INTERVAL %r; using 600",
                    os.environ.get("TPU_EXPORTER_PROBE_INTERVAL"))
        probe_interval = 600.0
    try:
        breach_samples = int(os.environ.get("TPU_EXPORTER_BREACH_SAMPLES",
                                            str(consts.PERF_BREACH_SAMPLES)).strip())
    except ValueError:
        log.warning("invalid TPU_EXPORTER_BREACH_SAMPLES %r; using %d",
                    os.environ.get("TPU_EXPORTER_BREACH_SAMPLES"), consts.PERF_BREACH_SAMPLES)
        breach_samples = consts.PERF_BREACH_SAMPLES
    # the apiserver client only carries the perf label; a pod that cannot
    # build one still serves every series
    client = None
    try:
        client = Client.in_cluster()
    except Exception as e:  # noqa: BLE001
        log.warning("apiserver client unavailable (perf label off): %s", e)
    MetricsExporterAgent(
        node_name=os.environ.get("NODE_NAME", ""),
        port=port,
        bandwidth_probe_interval=probe_interval,
        active_probes=active,
        client=client,
        floors=floors_from_env(),
        breach_samples=breach_samples,
        namespace=os.environ.get(
            consts.OPERATOR_NAMESPACE_ENV, consts.DEFAULT_OPERATOR_NAMESPACE
        ),
        generation=chip_generation(),
    ).run_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
