"""CUDA-graph capture and replay of the port's compiled paths: the
counterpart of the reference's ``jax.jit`` executables (the burn-in train
step with or without a mesh, the decode engine's decode and prefill, the
GPipe step, the all-reduce chain).

A :class:`GraphedCall` runs a function of tensors it holds (static inputs,
state updated in place) as one graph replay. The kernel wrappers count a
launch where they launch their kernel; under capture nothing runs, so the
launches a capture recorded are taken back from the counts and added again
at every replay, which launches them.
"""

from __future__ import annotations

import contextlib
import gc
from typing import Callable, Dict

import torch


def launch_counters() -> tuple:
    """Every kernel wrapper that counts its launches (``<wrapper>.launches``)."""
    from tpu_operator_torch.kernels import flash_bwd, flash_fwd, triad

    return (flash_fwd.flash_fwd_tri, flash_fwd.flash_fwd_rect, flash_bwd.flash_bwd_dq_tri,
            flash_bwd.flash_bwd_dkv_tri, flash_bwd.flash_bwd_dq_rect,
            flash_bwd.flash_bwd_dkv_rect, triad.triad_kernel)


@contextlib.contextmanager
def capture(graph: "torch.cuda.CUDAGraph"):
    """``torch.cuda.graph(graph)`` with the cycle collector held off:
    destroying any CUDA graph during a capture invalidates the capture, and
    the collector may free a dead reference cycle that holds one at any
    allocation."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph):
            yield
    finally:
        if enabled:
            gc.enable()


class GraphedCall:
    """``fn()``, a function of tensors it holds that returns one tensor, run
    on the card as a CUDA graph:

    - the first call runs ``fn`` eagerly on a side stream: the warm-up,
      which builds the kernels' libraries (``kernels/build.py``) and creates
      the library handles and workspaces a capture may not create. Its work
      is kept, as a jitted function's first call returns its result;
    - the second call captures ``fn`` (a capture runs nothing) and replays
      the graph; every later call replays it.

    A replay returns the tensor the capture produced, which the next replay
    rewrites. ``fn`` must neither sync the host nor branch on device values,
    and what it reads or writes in place must outlive the graph. A failed
    capture raises: nothing falls back to eager.

    ``fn`` may call NCCL collectives (on a mesh, one graph per rank): the
    warm-up, on a side stream as the capture's, opens every communicator
    they use, which a capture may not create, and every rank must issue
    the same collectives in the same order. A graph that holds them must
    be freed before its process group is destroyed. No capture mode is
    needed (the default, global, on torch 2.11 with NCCL 2.28)."""

    def __init__(self, fn: Callable[[], torch.Tensor]):
        self.fn = fn
        self.graph = None
        self.output = None
        self.held: Dict[Callable, int] = {}  # wrapper -> launches in one replay
        self._warm = False

    def __call__(self) -> torch.Tensor:
        if self.graph is None:
            if not self._warm:
                out = self._warm_up()
                self._warm = True
                return out
            self._capture()
        self.graph.replay()
        for wrapper, n in self.held.items():
            wrapper.launches += n
        return self.output

    def _warm_up(self) -> torch.Tensor:
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = self.fn()
        main.wait_stream(side)
        out.record_stream(main)  # the caller reads it on the main stream
        return out

    def _capture(self) -> None:
        before = {w: w.launches for w in launch_counters()}
        graph = torch.cuda.CUDAGraph()
        try:
            with capture(graph):
                output = self.fn()
        finally:
            recorded = {w: w.launches - n for w, n in before.items()}
            for wrapper, n in recorded.items():
                wrapper.launches -= n  # recorded, not launched
        self.graph, self.output = graph, output
        self.held = {w: n for w, n in recorded.items() if n}
