"""The node-status exporter on a card node (port of
``tpu_operator/validator/metrics.py``).

A per-node Prometheus server that

1. watches the validation status files (every 30 s): one
   ``tpu_operator_node_component_ready`` series per component, and the slice
   check's results from ``slice-ready``;
2. counts the node's cards through the one card probe
   (``native/gpuinfo.probe``): ``tpu_operator_node_gpus``, where the
   reference reads its node's allocatable TPU chips
   (``tpu_operator_node_tpu_chips``);
3. re-runs the driver check every 60 s
   (``tpu_operator_node_driver_revalidations_total{result}``, the
   reference's ``..._libtpu_revalidations_total``): a pass rewrites
   ``driver-ready``, a failure clears it, so the barrier never outlives the
   driver.

The other series keep the reference's names.

    COMPONENT=metrics python -m tpu_operator_torch.validator.main

serves on ``METRICS_PORT`` (8000) with the validator's env.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Optional

import prometheus_client

from tpu_operator_torch import consts
from tpu_operator_torch.validator import status as status_files
from tpu_operator_torch.validator.main import Context, validate_driver

log = logging.getLogger(__name__)

WATCHED_COMPONENTS = (
    consts.DRIVER_READY_FILE,
    consts.PLUGIN_READY_FILE,
    consts.WORKLOAD_READY_FILE,
    "slice-ready",
)
# slice-ready payload field -> the gauge's attribute
_SLICE_ERRORS = (
    ("ring_attention", "max_abs_err", "slice_ring_attention_err"),
    ("flash_attention", "max_abs_err", "slice_flash_attention_err"),
    ("ring_flash_attention", "max_abs_err", "slice_ring_flash_err"),
    ("pipeline", "max_abs_err_vs_sequential", "slice_pipeline_err"),
)


class NodeMetrics:
    def __init__(
        self,
        ctx: Context,
        port: int = 8000,
        status_interval: float = 30.0,
        revalidate_interval: float = 60.0,
        registry: Optional[prometheus_client.CollectorRegistry] = None,
    ):
        self.ctx = ctx
        self.port = port
        self.status_interval = status_interval
        self.revalidate_interval = revalidate_interval
        self.registry = registry or prometheus_client.CollectorRegistry()

        def gauge(name, doc, labels=("node",)):
            return prometheus_client.Gauge(name, doc, list(labels), registry=self.registry)

        self.component_ready = gauge(
            "tpu_operator_node_component_ready",
            "1 when the component's validation status file is present", ("node", "component"))
        self.gpus = gauge("tpu_operator_node_gpus", "Cards the card probe finds on this node")
        self.driver_validations = prometheus_client.Counter(
            "tpu_operator_node_driver_revalidations_total",
            "Periodic driver re-validation attempts", ["node", "result"], registry=self.registry)
        self.slice_busbw = gauge(
            "tpu_operator_node_slice_allreduce_busbw_gbps",
            "Last slice-validation allreduce bus bandwidth (GB/s/card)")
        self.slice_ring_attention_err = gauge(
            "tpu_operator_node_slice_ring_attention_max_abs_err",
            "Ring-vs-dense attention exactness from the last slice validation")
        self.slice_flash_attention_err = gauge(
            "tpu_operator_node_slice_flash_attention_max_abs_err",
            "Flash-kernel-vs-dense attention exactness from the last slice validation")
        self.slice_ring_flash_err = gauge(
            "tpu_operator_node_slice_ring_flash_attention_max_abs_err",
            "Composed flash-in-ring attention exactness from the last slice validation")
        self.slice_pipeline_err = gauge(
            "tpu_operator_node_slice_pipeline_max_abs_err",
            "Pipelined-vs-sequential exactness from the last slice validation "
            "(failed checks never write the file — alert on component_ready)")
        self._node = ctx.node_name or "unknown"
        self._stop = threading.Event()

    @classmethod
    def from_env(cls) -> "NodeMetrics":
        return cls(Context.from_env(), port=int(os.environ.get("METRICS_PORT", "8000")))

    # -- collection passes ---------------------------------------------------

    def collect_status_files(self) -> None:
        for component in WATCHED_COMPONENTS:
            payload = status_files.read_status(component, self.ctx.validation_dir)
            self.component_ready.labels(self._node, component).set(0 if payload is None else 1)
            if component != "slice-ready" or not payload:
                continue
            busbw = payload.get("peak_busbw_gbps_per_chip")
            if busbw is not None:
                self.slice_busbw.labels(self._node).set(busbw)
            for section, key, attr in _SLICE_ERRORS:
                value = (payload.get(section) or {}).get(key)
                if value is not None:
                    getattr(self, attr).labels(self._node).set(value)

    def collect_device_count(self) -> None:
        """The card probe's count; a failed probe leaves the gauge as it was."""
        from tpu_operator_torch.native import gpuinfo

        try:
            self.gpus.labels(self._node).set(gpuinfo.probe()["chip_count"])
        except (OSError, RuntimeError) as e:
            log.warning("card probe failed: %s", e)

    def revalidate_driver(self) -> None:
        """Keep the driver check honest after node reboots and driver swaps."""
        try:
            payload = validate_driver(self.ctx)
            status_files.write_status(consts.DRIVER_READY_FILE, self.ctx.validation_dir, payload)
            self.driver_validations.labels(self._node, "success").inc()
        except Exception as e:  # noqa: BLE001 — any failure clears the barrier
            log.warning("driver revalidation failed: %s", e)
            status_files.clear_status(consts.DRIVER_READY_FILE, self.ctx.validation_dir)
            self.driver_validations.labels(self._node, "failure").inc()

    # -- server --------------------------------------------------------------

    def run_forever(self) -> None:
        prometheus_client.start_http_server(self.port, registry=self.registry)
        last_revalidate = 0.0
        while not self._stop.is_set():
            self.collect_status_files()
            self.collect_device_count()
            now = time.monotonic()
            if now - last_revalidate >= self.revalidate_interval:
                self.revalidate_driver()
                last_revalidate = now
            self._stop.wait(self.status_interval)

    def stop(self) -> None:
        self._stop.set()
