"""Matmul rate probes: sustained bf16 TFLOP/s and int8 TOP/s (port of
``tpu_operator/workloads/matmul_bench.py``).

The headline per-card compute numbers for validation: a chain of large
matmuls, each step feeding the next, timed by the two-point slope
(workloads/timing.py), and compared against the card's data-sheet peak.
The products are ``torch.matmul`` (bf16) and ``torch._int_mm`` (int8).
On the card a chain of ``n`` products is one CUDA-graph replay per timed
call (``kernels/graph.GraphedChain``), the reference's one jitted program,
so no host dispatch sits between the products; the final read-back of a
scalar waits for the replay. The CPU runs the chain eagerly. Runs on the
card unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional

import torch

from tpu_operator_torch.device import DeviceLike, resolve_device
from tpu_operator_torch.kernels.graph import GraphedChain
from tpu_operator_torch.nodeinfo import device_generation
from tpu_operator_torch.workloads.serving import _int_matmul
from tpu_operator_torch.workloads.timing import seeded, two_point_min_timing

# Dense peaks per H100 variant (NVIDIA H100 Tensor Core GPU data sheet; its
# figures are with sparsity, halved here): bf16 TFLOP/s and int8 TOP/s.
PEAK_TFLOPS = {"h100-sxm": 989.5, "h100-nvl": 835.5, "h100-pcie": 756.5}
PEAK_INT8_TOPS = {"h100-sxm": 1979.0, "h100-nvl": 1670.5, "h100-pcie": 1513.0}


def chip_generation() -> str:
    """The card's generation key (``"h100-sxm"``, ``"h100-pcie"``,
    ``"h100-nvl"``) from the current CUDA device's name
    (``nodeinfo.device_generation``); ``""`` for an unrecognised card or
    no card: the floor never guesses."""
    if not torch.cuda.is_available():
        return ""
    return device_generation(torch.cuda.get_device_name())


def matmul_chain(z: torch.Tensor, y: torch.Tensor, s, n: int) -> torch.Tensor:
    """``(z * s) @ y @ y ...`` (``n`` products); the seed ``s`` is a Python
    float or a graphed chain's 0-dim f32 tensor (``timing.seeded``)."""
    out = seeded(z, s)
    for _ in range(n):
        out = out @ y
    return out


def matmul_chain_runner(size: int, device: DeviceLike = None,
                        fetched: Optional[List[float]] = None) -> Callable[[float, int], None]:
    """The bf16 matmul chain as a ``run(seed, n)`` runner for
    ``two_point_min_timing``: on the card one graph replay per call, its
    graphs freed with the runner. Appends each fetched scalar to
    ``fetched`` when given (the finiteness check)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((size, size), generator=gen, device=dev).to(torch.bfloat16)
    # scaled so the chain neither explodes nor vanishes
    y = (torch.randn((size, size), generator=gen, device=dev) / size ** 0.5).to(torch.bfloat16)

    chain = GraphedChain(lambda s, n: matmul_chain(x, y, s, n).float().sum(), dev, "matmul")

    def run(seed: float, n: int) -> None:
        # reduced to a scalar and read back: that is what waits for the chain
        value = float(chain(seed, n))
        if fetched is not None:
            fetched.append(value)

    return run


def matmul_tflops(size: int = 8192, iters: int = 16, reps: int = 5,
                  device: DeviceLike = None) -> dict:
    """z = z @ y chained ``iters`` and ``6*iters`` times; the per-step
    time is the median of per-pair slopes, so the fixed cost of a call
    (the seed pass, the read-back) cancels. 2·N³ FLOPs per step; a
    per-call seed scalar keeps every timed call's inputs distinct."""
    dev = resolve_device(device)
    fetched: List[float] = []
    timing = two_point_min_timing(matmul_chain_runner(size, dev, fetched), iters, 6 * iters, reps)
    if not all(math.isfinite(v) for v in fetched):
        raise RuntimeError(f"matmul chain produced non-finite values: {fetched}")
    flops = 2 * size**3
    report = {
        "size": size,
        "platform": dev.type,
        "inclusive_tflops": flops / timing.inclusive_per_iter_s / 1e12,
    }
    report.update(timing.report_fields())
    per_iter = timing.per_iter_s or timing.inclusive_per_iter_s
    report.update({"time_ms": per_iter * 1e3, "tflops": flops / per_iter / 1e12})
    return report


def int8_matmul_chain(z: torch.Tensor, y: torch.Tensor, s, n: int) -> torch.Tensor:
    """``z + int(s)``, then ``n`` steps of int8 x int8 -> int32, shifted
    right by 7 and cast back to int8 (wrapping), the requantization that
    keeps magnitudes in range for the next product. The seed is a Python
    float or a graphed chain's 0-dim f32 tensor, truncated alike."""
    out = z + (s.to(torch.int8) if isinstance(s, torch.Tensor) else int(s))
    for _ in range(n):
        out = (_int_matmul(out, y) >> 7).to(torch.int8)
    return out


def int8_chain_runner(size: int, device: DeviceLike = None) -> Callable[[float, int], None]:
    """The int8 chain as a ``run(seed, n)`` runner (like
    ``matmul_chain_runner``: one graph replay per call on the card)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randint(-4, 5, (size, size), generator=gen, device=dev, dtype=torch.int8)
    y = torch.randint(-4, 5, (size, size), generator=gen, device=dev, dtype=torch.int8)
    # column-major: torch._int_mm's fast layout for its second operand
    y = y.t().contiguous().t()

    chain = GraphedChain(lambda s, n: int8_matmul_chain(x, y, s, n).to(torch.int32).sum(),
                         dev, "int8")

    def run(seed: float, n: int) -> None:
        int(chain(seed, n))  # the read-back waits

    return run


def int8_matmul_tops(size: int = 8192, iters: int = 16, reps: int = 5,
                     device: DeviceLike = None) -> dict:
    """Quantized-inference throughput: chained int8 products accumulated
    in int32 (``torch._int_mm`` on the card), each requantized to int8 by
    an arithmetic shift (O(N²) beside the 2·N³ operations). Same chain
    and two-point timing as ``matmul_tflops``."""
    dev = resolve_device(device)
    timing = two_point_min_timing(int8_chain_runner(size, dev), iters, 6 * iters, reps)
    ops = 2 * size**3
    report = {
        "size": size,
        "platform": dev.type,
        "inclusive_tops": ops / timing.inclusive_per_iter_s / 1e12,
    }
    report.update(timing.report_fields())
    per_iter = timing.per_iter_s or timing.inclusive_per_iter_s
    report.update({"time_ms": per_iter * 1e3, "tops": ops / per_iter / 1e12})
    return report
