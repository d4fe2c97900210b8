"""The HBM-bandwidth probe of the node self-test (port of
``tpu_operator/workloads/kernels.py``).

A streaming triad (``out = alpha * x + y``) through the hand-written
kernel ``kernels/triad.cu``, chained and timed by the two-point slope, so
the number reflects the bandwidth the card sustains rather than the host's
launch rate. The probe runs on the card unless ``device="cpu"`` is passed;
there the kernel's plain version runs and the number is not a device
bandwidth.
"""

from __future__ import annotations

import time

import torch

from tpu_operator_torch.device import DeviceLike, resolve_device
from tpu_operator_torch.kernels.graph import GraphedChain
from tpu_operator_torch.kernels.triad import triad_kernel
from tpu_operator_torch.workloads.timing import two_point_min_timing


def triad(
    x: torch.Tensor,
    y: torch.Tensor,
    alpha: float = 2.0,
    block_rows: int = 1024,
    inplace: bool = False,
) -> torch.Tensor:
    """``alpha * x + y`` over a (rows, cols) array; ``inplace=True`` writes
    it into ``x`` and returns ``x``. ``block_rows`` is the reference's row
    tile: the kernel does not tile by it, but ``rows`` must still be a
    multiple of it (up to ``rows``), as the reference requires."""
    rows, _ = x.shape
    block_rows = min(block_rows, rows)
    if rows % block_rows:
        raise ValueError(f"rows ({rows}) must be a multiple of block_rows ({block_rows})")
    return triad_kernel(x, y, alpha, x if inplace else torch.empty_like(x))


def hbm_bandwidth_probe(size_mb: int = 128, iters: int = 50, reps: int = 6,
                        device: DeviceLike = None) -> dict:
    """Measured triad bandwidth in GB/s (3 streams: 2 reads + 1 write).

    On the card the probe chains the in-place triad ``n`` times per call,
    one CUDA-graph replay per call (``kernels/graph.GraphedChain``: a
    length is captured at its first, untimed call), then a scalar read
    back that waits for it, and times two chain lengths (``iters`` and
    ``6*iters``) as back-to-back pairs; the median of the per-pair slopes
    cancels the fixed cost of a call (workloads/timing.py). The graphs are
    freed before the probe returns. With ``device="cpu"`` it times one
    eager chain once."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    n_elems = size_mb * 1024 * 1024 // 4
    cols = 1024 if on_card else 512
    block_rows = 512
    rows = max(block_rows, (n_elems // cols) // block_rows * block_rows)
    x = torch.ones((rows, cols), dtype=torch.float32, device=dev)
    y = torch.full((rows, cols), 2.0, dtype=torch.float32, device=dev)
    # correctness (the validation part) through the non-aliased kernel
    out = triad(x, y, 2.0, block_rows)
    if float(out[0, 0]) != 4.0:
        raise RuntimeError("triad numerics mismatch")
    del out

    inplace = on_card

    # The seed scalar ``s`` makes every timed call's inputs distinct; its
    # one z*s pass sits outside the chain, so it cancels in the slope.
    # alpha=0.5 keeps the iterate bounded (fixed point 2y) over any chain
    # length; the traffic does not depend on alpha. Reading two elements
    # back waits for every launch of the chain.
    def body(s, n: int) -> torch.Tensor:
        acc = x * s  # f32 times the seed, a float or an f32 scalar alike
        for _ in range(n):
            acc = triad(acc, y, 0.5, block_rows, inplace)
        return acc[0, 0] + acc[-1, -1]

    moved = 3 * rows * cols * 4  # bytes per chain iteration
    report = {
        "size_mb": rows * cols * 4 / 1024 / 1024,
        "platform": dev.type,
        "kernel": "triad_inplace" if inplace else "triad",
    }
    with GraphedChain(body, dev, "triad") as chain:
        if not on_card:
            # the plain version on the CPU: one cheap timing, not a device
            # bandwidth
            float(chain(1.0, iters))
            t0 = time.perf_counter()
            float(chain(1.001, iters))
            dt = (time.perf_counter() - t0) / iters
            report.update({"time_ms": dt * 1e3, "bandwidth_gbps": moved / dt / 1e9})
            return report
        timing = two_point_min_timing(lambda s, n: float(chain(s, n)), iters, 6 * iters, reps)
    report["inclusive_gbps"] = moved / timing.inclusive_per_iter_s / 1e9
    report.update(timing.report_fields())
    per_iter = timing.per_iter_s or timing.inclusive_per_iter_s
    report.update({"time_ms": per_iter * 1e3, "bandwidth_gbps": moved / per_iter / 1e9})
    return report
