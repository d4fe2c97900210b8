"""CUDA-graph capture and replay of the port's compiled paths: the
counterpart of the reference's ``jax.jit`` executables (the burn-in train
step with or without a mesh, the decode engine's decode and prefill, the
GPipe step, the all-reduce chain, the timed chains of the self-test, the
benches and the sweep).

A :class:`GraphedCall` runs a function of tensors it holds (static inputs,
state updated in place) as one graph replay. A :class:`GraphedChain` runs
a timed chain of ``n`` steps as one replay per chain length, the seed
written into a device scalar before each. The kernel wrappers count a
launch where they launch their kernel; under capture nothing runs, so the
launches a capture recorded are taken back from the counts and added again
at every replay, which launches them.
"""

from __future__ import annotations

import contextlib
import gc
from typing import Callable, Dict, Optional, Tuple

import torch

# what the timed chains did, by chain name: lengths captured and replays,
# read by a caller that shows a chain was timed as replays
chain_counts: Dict[str, Dict[str, int]] = {}


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


def _side_stream_call(fn: Callable[[], torch.Tensor]) -> torch.Tensor:
    """``fn()`` run eagerly on a side stream (a warm-up: it builds the
    kernels' libraries and creates the library handles and workspaces a
    capture may not create), its result handed back to the main stream."""
    main = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(main)
    with torch.cuda.stream(side):
        out = fn()
    main.wait_stream(side)
    out.record_stream(main)  # the caller reads it on the main stream
    return out


def _counter(key) -> Tuple[Callable, str]:
    """(wrapper, attribute) of a count: a wrapper keys its ``launches``,
    (wrapper, "split_sums") a dK/dV wrapper's split sums."""
    return key if isinstance(key, tuple) else (key, "launches")


def _counts() -> Dict[object, int]:
    """Every count a capture takes back and a replay adds: each wrapper's
    launches, and the split sums of the dK/dV wrappers."""
    out = {}
    for w in launch_counters():
        out[w] = w.launches
        if hasattr(w, "split_sums"):
            out[(w, "split_sums")] = w.split_sums
    return out


def _add(key, n: int) -> None:
    wrapper, attr = _counter(key)
    setattr(wrapper, attr, getattr(wrapper, attr) + n)


def _captured(fn: Callable[[], torch.Tensor]) -> Tuple["torch.cuda.CUDAGraph", torch.Tensor,
                                                         Dict[object, int]]:
    """``fn`` captured into a new graph: (graph, the tensor it returns, the
    launches one replay makes by wrapper, and by (wrapper, "split_sums")
    the split sums). A capture runs nothing, so the launches it counted are
    taken back, also when it fails."""
    before = _counts()
    graph = torch.cuda.CUDAGraph()
    try:
        with capture(graph):
            output = fn()
    finally:
        recorded = {key: getattr(*_counter(key)) - n for key, n in before.items()}
        for key, n in recorded.items():
            _add(key, -n)  # recorded, not launched
    return graph, output, {key: n for key, n in recorded.items() if n}


def _replayed(graph, output: torch.Tensor, held: Dict[object, int]) -> torch.Tensor:
    graph.replay()
    for key, n in held.items():
        _add(key, n)
    return output


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
        self.held: Dict[object, int] = {}  # wrapper -> launches in one replay (_captured)
        self._warm = False

    def __call__(self) -> torch.Tensor:
        if self.graph is None:
            if not self._warm:
                out = _side_stream_call(self.fn)
                self._warm = True
                return out
            self.graph, self.output, self.held = _captured(self.fn)
        return _replayed(self.graph, self.output, self.held)


def replays_on(device: torch.device) -> bool:
    """Whether a :class:`GraphedChain` on ``device`` runs as graph replays:
    on the card; the CPU runs its chains eagerly."""
    return device.type == "cuda"


class GraphedChain:
    """A timed chain ``body(seed, n) -> scalar tensor`` (``n`` steps from
    inputs the seed folds into, reduced to a 0-dim tensor), run on the card
    as one CUDA graph per chain length ``n``, the reference's one jitted
    program per static ``n``. ``chain(seed, n)`` returns the scalar; the
    caller reads it back, outside the graph, and that read waits for the
    chain:

    - the first call at a length runs ``body`` eagerly on a side stream
      (the warm-up; its launches count once), then captures it (a capture
      runs nothing: its launches are taken back) and returns the warm-up's
      scalar. So no capture falls inside a later timed call;
    - every later call at that length writes the seed into the chain's
      device scalar in place (``fill_``, no host sync), replays the graph,
      adds the graph's launches to the counts and returns the captured
      scalar, which the next replay rewrites.

    ``body`` gets the seed as a 0-dim f32 tensor on the card, written
    before every replay (a Python float would be baked into the capture),
    and as the Python float itself where the chain runs eagerly (the CPU,
    :func:`replays_on`); a seed of None writes nothing (a chain with no
    seed). ``close()``, or leaving a ``with`` block, frees every graph and
    its memory pool; a probe frees its chain before it returns. A failed
    capture raises: nothing falls back to the eager loop. ``name`` keys
    :data:`chain_counts`."""

    def __init__(self, body: Callable[[object, int], torch.Tensor], device, name: str):
        self.body = body
        self.device = torch.device(device)
        self.graphed = replays_on(self.device)
        self.seed = torch.zeros((), dtype=torch.float32, device=self.device)
        self.graphs: Dict[int, tuple] = {}  # n -> (graph, scalar, launches a replay makes)
        self.counts = chain_counts.setdefault(name, {"captures": 0, "replays": 0})

    def __call__(self, seed: Optional[float], n: int) -> torch.Tensor:
        if not self.graphed:
            return self.body(seed, n)
        on_card = self.device.type == "cuda"
        with torch.cuda.device(self.device) if on_card else contextlib.nullcontext():
            if seed is not None:
                self.seed.fill_(seed)
            if n in self.graphs:
                out = _replayed(*self.graphs[n])
                self.counts["replays"] += 1
                return out
            out = _side_stream_call(lambda: self.body(self.seed, n))
            self.graphs[n] = _captured(lambda: self.body(self.seed, n))
            self.counts["captures"] += 1
            return out

    def close(self) -> None:
        self.graphs.clear()

    def __enter__(self) -> "GraphedChain":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
