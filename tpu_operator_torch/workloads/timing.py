"""Two-point chain timing (port of ``tpu_operator/workloads/timing.py``).

Time the same chained program at two iteration counts as back-to-back
(lo, hi) pairs, take each pair's slope (t_hi - t_lo)/(hi - lo), and report
the MEDIAN of the per-pair slopes: the fixed per-call overhead (launch,
host work, the final read-back) cancels within a pair, and pairs that
straddle a change of regime land in the tails where the median rejects
them. Each timed call gets a distinct seed scalar, folded into its inputs.

:class:`TwoPointTiming` and :func:`two_point_min_timing` are
framework-free copies; :func:`attention_grad_chain` is the PyTorch
version of the fwd+bwd chain. On the card each chain is timed as one
CUDA-graph replay per call (``kernels/graph.GraphedChain``), the seed
then a 0-dim device tensor (:func:`seeded`).
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, List, Optional

import torch


@dataclasses.dataclass
class TwoPointTiming:
    lo: int
    hi: int
    # per-pair (t_lo, t_hi) samples, in measurement order
    pairs: List[tuple]
    # per-iteration seconds: median of per-pair slopes; None when the
    # median slope was non-positive (noise swamped the signal) and only
    # the inclusive bound is usable
    per_iter_s: Optional[float]

    @property
    def min_lo_s(self) -> float:
        return min(t for t, _ in self.pairs)

    @property
    def min_hi_s(self) -> float:
        return min(t for _, t in self.pairs)

    @property
    def overhead_s(self) -> Optional[float]:
        if self.per_iter_s is None:
            return None
        return statistics.median(t_lo for t_lo, _ in self.pairs) - self.per_iter_s * self.lo

    @property
    def inclusive_per_iter_s(self) -> float:
        """Overhead-inclusive lower-bound rate from the long chain."""
        return self.min_hi_s / self.hi

    def report_fields(self) -> dict:
        fields = {
            "iters": [self.lo, self.hi],
            "min_times_ms": [round(self.min_lo_s * 1e3, 2), round(self.min_hi_s * 1e3, 2)],
        }
        if self.per_iter_s is None:
            fields["unstable_timing"] = True
        else:
            fields["dispatch_overhead_ms_est"] = self.overhead_s * 1e3
        return fields


def seeded(z: torch.Tensor, s) -> torch.Tensor:
    """``z * s`` for a seed ``s`` that is a Python float or a 0-dim f32
    tensor on z's device (a graphed chain's), rounded alike: the product is
    taken in f32 and rounded once to z's dtype, as ``z * float`` is (on
    the card a bf16 tensor times an f32 tensor rounds the seed to bf16
    first: 1.3 acts as 1.296875)."""
    if isinstance(s, torch.Tensor):
        return (z.to(s.dtype) * s).to(z.dtype)
    return z * s


def attention_grad_steps(fn, q, k, v):
    """The steps of :func:`attention_grad_chain` without the read-back:
    ``steps(q, k, v, seed, n)`` returns the chain's final sum as a 0-dim
    f32 tensor (the body a graphed chain captures); the seed is a Python
    float or a 0-dim f32 tensor (:func:`seeded`)."""

    def steps(q, k, v, s, n):
        eps = 0.001
        a, kc, vc = seeded(q, s), k, v
        for _ in range(n):
            a, kc, vc = (x.detach().requires_grad_(True) for x in (a, kc, vc))
            loss = fn(a, kc, vc).float().sum()
            dq, dk, dv = torch.autograd.grad(loss, (a, kc, vc))
            a = a + dq.to(q.dtype) * eps
            kc = kc + dk.to(k.dtype) * eps
            vc = vc + dv.to(v.dtype) * eps
        return a.detach().float().sum()

    return steps


def attention_grad_chain(fn, q, k, v):
    """fwd+bwd timing chain for an attention ``fn(q, k, v)``: each step
    folds ALL THREE cotangents back into the next step's inputs, so the
    dK/dV work is on the chain's critical path and cannot be skipped (a
    dq-only chain measures less than fwd+bwd). Returns
    ``chain(q, k, v, seed_scalar, n)``, which runs ``n`` steps and reads the
    result back to the host (so a timed call includes the device's work)."""
    steps = attention_grad_steps(fn, q, k, v)

    def chain(q, k, v, s, n):
        return float(steps(q, k, v, s, n))

    return chain


def two_point_min_timing(
    run: Callable[[float, int], None], lo: int, hi: int, reps: int = 5
) -> TwoPointTiming:
    """``run(seed, n)`` must execute (and force) one chained program of
    ``n`` iterations with the seed folded into its inputs. Warms both
    programs, then times ``reps`` back-to-back (lo, hi) pairs."""
    if reps < 1:
        raise ValueError(f"reps must be >= 1, got {reps}")
    if not 0 < lo < hi:
        raise ValueError(f"need 0 < lo < hi, got {lo}, {hi}")
    seeds = iter(1.0 + 0.001 * k for k in range(2 * reps + 2))
    for n in (lo, hi):
        run(next(seeds), n)  # warm the exact programs
    pairs: List[tuple] = []
    for _ in range(reps):
        times = []
        for n in (lo, hi):
            t0 = time.perf_counter()
            run(next(seeds), n)
            times.append(time.perf_counter() - t0)
        pairs.append(tuple(times))
    # median over ALL slopes, negatives included: dropping only one tail
    # would bias the estimate upward and could leave a single
    # cross-regime outlier masquerading as a clean measurement
    slope = statistics.median((t_hi - t_lo) / (hi - lo) for t_lo, t_hi in pairs)
    return TwoPointTiming(
        lo=lo,
        hi=hi,
        pairs=pairs,
        per_iter_s=slope if slope > 0 else None,
    )
