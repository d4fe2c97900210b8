"""Workload step-time telemetry (port of ``tpu_operator/workloads/telemetry.py``).

A copy of the recorder the serving engine and burn-in use: per-step wall
time with the first (warm-up) step split off, and p50/p99/max over the
executed steps. The caller forces its own result inside the step (a CUDA
launch returns before the device finishes; reading a value back to the
host waits for it). ``burnin_flops_per_step`` is the reference's FLOP
estimate of one burn-in train step, for the achieved-rate field.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional


def _percentile(sorted_values: List[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted sample."""
    if not sorted_values:
        return 0.0
    idx = min(len(sorted_values) - 1, max(0, int(round(q * (len(sorted_values) - 1)))))
    return sorted_values[idx]


@dataclasses.dataclass
class StepTimeReport:
    steps: int
    compile_s: float  # first (warm-up) call, separated from the steps
    step_p50_s: float
    step_p99_s: float
    step_max_s: float
    step_mean_s: float
    total_s: float
    tflops: Optional[float] = None  # achieved, when flops_per_step known
    host: str = ""

    def to_dict(self) -> dict:
        out = {
            "steps": self.steps,
            "compile_s": round(self.compile_s, 6),
            "step_p50_s": round(self.step_p50_s, 6),
            "step_p99_s": round(self.step_p99_s, 6),
            "step_max_s": round(self.step_max_s, 6),
            "step_mean_s": round(self.step_mean_s, 6),
            "total_s": round(self.total_s, 6),
        }
        if self.tflops is not None:
            out["tflops"] = round(self.tflops, 2)
        if self.host:
            out["host"] = self.host
        return out

    @classmethod
    def from_dict(cls, data: dict) -> "StepTimeReport":
        return cls(
            steps=int(data.get("steps", 0)),
            compile_s=float(data.get("compile_s", 0.0)),
            step_p50_s=float(data.get("step_p50_s", 0.0)),
            step_p99_s=float(data.get("step_p99_s", 0.0)),
            step_max_s=float(data.get("step_max_s", 0.0)),
            step_mean_s=float(data.get("step_mean_s", 0.0)),
            total_s=float(data.get("total_s", 0.0)),
            tflops=float(data["tflops"]) if data.get("tflops") is not None else None,
            host=str(data.get("host", "")),
        )


class StepTimeRecorder:
    """Records one stepped run. Either drive it explicitly::

        rec = StepTimeRecorder(flops_per_step=f)
        with rec.step():           # first step = warm-up + execute
            out = step(batch)

    or hand it the whole loop via :meth:`run`. The first recorded step
    is booked as warm-up time; percentiles cover only the executed steps.
    """

    def __init__(self, flops_per_step: Optional[float] = None, host: str = ""):
        self.flops_per_step = flops_per_step
        self.host = host
        self._durations: List[float] = []
        self._t0: Optional[float] = None

    class _StepCtx:
        def __init__(self, rec: "StepTimeRecorder"):
            self._rec = rec

        def __enter__(self):
            self._start = time.perf_counter()
            return self

        def __exit__(self, exc_type, exc, tb):
            if exc is None:
                self._rec._durations.append(time.perf_counter() - self._start)
            return False

    def step(self) -> "StepTimeRecorder._StepCtx":
        if self._t0 is None:
            self._t0 = time.perf_counter()
        return self._StepCtx(self)

    def run(self, step_fn: Callable[[], None], steps: int) -> StepTimeReport:
        """Time ``steps`` calls of ``step_fn`` (which must force its own
        result — an unforced asynchronous launch would time the enqueue)."""
        for _ in range(steps):
            with self.step():
                step_fn()
        return self.report()

    def report(self) -> StepTimeReport:
        if not self._durations:
            raise RuntimeError("no steps recorded")
        compile_s = self._durations[0]
        executed = self._durations[1:] or self._durations[:1]
        ordered = sorted(executed)
        mean = sum(executed) / len(executed)
        tflops = None
        if self.flops_per_step and mean > 0:
            tflops = self.flops_per_step / mean / 1e12
        return StepTimeReport(
            steps=len(self._durations),
            compile_s=compile_s,
            step_p50_s=_percentile(ordered, 0.50),
            step_p99_s=_percentile(ordered, 0.99),
            step_max_s=ordered[-1],
            step_mean_s=mean,
            total_s=sum(self._durations),
            tflops=tflops,
            host=self.host,
        )


def burnin_flops_per_step(cfg) -> float:
    """Approximate FLOPs of one burn-in train step: 6 x params x tokens
    (fwd 2, bwd 4 — the standard dense-transformer estimate), attention
    quadratic term included. Good to ~10%, which is all an achieved-rate
    gauge needs."""
    d, f, s, b = cfg.d_model, cfg.d_ff, cfg.seq_len, cfg.batch
    head = d // cfg.n_heads
    # qkv + proj + FFN; top-1 MoE routing runs ONE expert's FFN per
    # token, so the per-token compute matches the dense FFN's
    per_layer_params = d * cfg.qkv_width + d * d + 2 * d * f
    params = cfg.n_layers * per_layer_params
    tokens = b * s
    dense = 6.0 * params * tokens
    # attention scores + context: 2 x (2 b s^2 h d_head) fwd, x3 with
    # bwd — per QUERY head (every query head attends the full sequence;
    # GQA shrinks the KV projections above, not the attention math)
    attn = cfg.n_layers * 6.0 * 2.0 * b * s * s * cfg.n_heads * head
    return dense + attn


def merge_gang_reports(
    reports: Dict[str, dict],
    expected_hosts: Optional[List[str]] = None,
) -> dict:
    """Merge per-host step reports into the gang artifact the slice
    manager publishes. ``reports`` maps host name -> report dict
    (``StepTimeReport.to_dict`` shape). The straggler ratio is the
    slowest host's median step over the gang median of host medians —
    1.0 for a uniform gang (including the single-host gang, which has
    nobody to straggle behind), >1 when one host drags the collective
    (in a gang every host's step time is gated by the slowest member's,
    so the artifact keys off each host's OWN median, which the per-host
    recorders measured before the collectives coupled them, or which a
    post-mortem merge reads from their independent runs).

    Degenerate inputs are part of the contract: a report whose run
    recorded zero executed steps carries a 0.0 median and is excluded
    from the ratio (an unmeasured host must not read as infinitely
    fast), and when ``expected_hosts`` names the full gang, members
    that never reported are listed in ``missing_hosts`` — a silently
    absent report is itself a finding, not a smaller gang."""
    if not reports:
        raise ValueError("no per-host reports to merge")
    medians = {
        host: float(r.get("step_p50_s", 0.0))
        for host, r in reports.items()
        if float(r.get("step_p50_s", 0.0)) > 0.0
    }
    if not medians:
        # every report is empty: publish a shape-correct artifact that
        # cannot fake a ratio (nothing was measured)
        artifact = {
            "hosts": len(reports),
            "gang_step_p50_s": 0.0,
            "gang_step_max_s": 0.0,
            "straggler_ratio": 1.0,
            "slowest_host": "",
            "per_host_step_p50_s": {},
        }
        if expected_hosts is not None:
            artifact["missing_hosts"] = sorted(set(expected_hosts) - set(reports))
        return artifact
    ordered = sorted(medians.values())
    gang_median = _percentile(ordered, 0.50)
    slowest_host = max(medians, key=lambda h: medians[h])
    straggler_ratio = (
        medians[slowest_host] / gang_median if gang_median > 0 else 1.0
    )
    tflops = [
        float(r["tflops"]) for r in reports.values() if r.get("tflops") is not None
    ]
    artifact = {
        "hosts": len(reports),
        "gang_step_p50_s": round(gang_median, 6),
        "gang_step_max_s": round(ordered[-1], 6),
        "straggler_ratio": round(straggler_ratio, 3),
        "slowest_host": slowest_host,
        "per_host_step_p50_s": {h: round(m, 6) for h, m in sorted(medians.items())},
    }
    if tflops:
        artifact["gang_tflops"] = round(sum(tflops), 2)
    if expected_hosts is not None:
        missing = sorted(set(expected_hosts) - set(reports))
        if missing:
            artifact["missing_hosts"] = missing
    return artifact
