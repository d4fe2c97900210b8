"""Per-generation kernel autotuning (port of ``tpu_operator/workloads/autotune.py``):
the sweep harness, its cache and publication vocabulary, and the
read-back side.

- :func:`sweep`: config grid -> one cheap probe timing each -> pruning of
  dominated configs -> two-point timing (``workloads/timing.py``) of the
  survivors -> records and a measured winner.
- Four kernel families (:func:`run_generation_sweep`), under the
  reference's family and shape-class keys. The flash families sweep the
  port's tile knob: ``block_m``, the q-tile height (64 or 128 rows) of the
  hand-written Hopper kernels' launch plans, forward and fwd+bwd. The
  reference's ``(block_q, block_k)`` have no counterpart on the card (the
  port's blocks only gate divisibility). The matmul and int8 families
  sweep a one-point grid, ``{"unroll": 1}``: the port's chains
  (``matmul_bench``) take no ``unroll`` — a captured chain is fully
  unrolled, and cuBLAS owns the tiling — so the families still publish a
  measured winner and rate for the floors, and ``tuned_matmul_unroll`` has
  no port.
- The cache vocabulary: entries are keyed by generation in the
  ``tpu-autotune-results`` ConfigMap and valid for one toolchain
  (:func:`runtime_fingerprint`), as the reference's.
- :func:`merge_winner_floors` folds CUDA-measured winners into a floors
  table that starts empty (the port has no scaled guesses to start from).
- Read-back: a flash caller that leaves its knobs unset asks
  :func:`tuned_flash_tile` (the winner's ``block_m``) and
  :func:`tuned_flash_blocks` (the reference's divisibility blocks) through
  ``TPU_AUTOTUNE_JSON``.

The sweep runs on the card unless ``device="cpu"`` is passed; the CPU
entry records ``platform="cpu"`` and never folds into floors.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from tpu_operator_torch import consts
from tpu_operator_torch.device import DeviceLike, resolve_device
from tpu_operator_torch.kernels.build import KERNEL_DIR, kernel_digest
from tpu_operator_torch.perf import FLOOR_FRACTION
from tpu_operator_torch.workloads.matmul_bench import chip_generation

# the kernel families one generation entry must cover to be complete
KERNEL_FAMILIES = ("flash_fwd", "flash_fwd_bwd", "matmul", "int8")

# probe-pass pruning: a config whose cheap inclusive timing is this much
# slower than the current best cannot win its full measurement and is
# recorded as pruned, with the probe-derived estimate
PRUNE_RATIO = 1.35

AUTOTUNE_ENV = "TPU_AUTOTUNE_JSON"
DEFAULT_FLASH_BLOCK_Q = 1024
DEFAULT_FLASH_BLOCK_K = 1024

# the flash tile-height grid: the two heights the bf16 plans launch
FLASH_TILE_GRID: Tuple[Dict[str, int], ...] = ({"block_m": 64}, {"block_m": 128})
# the matmul/int8 grid: one launch per product, captured whole on the card
MATMUL_GRID: Tuple[Dict[str, int], ...] = ({"unroll": 1},)
# the winner keys the winners blob keeps (the reference's, and the port's knob)
_CONFIG_KEYS = ("block_q", "block_k", "unroll", "block_m")



def runtime_fingerprint() -> str:
    """The kernel-toolchain version a sweep or a compile record is valid
    for: ``LIBTPU_VERSION`` when the installer set it (the control plane
    injects it and compares against the same value), else the torch and
    CUDA versions and a digest of every kernel source, header and the
    nvcc flags — a kernel change invalidates a record."""
    env = os.environ.get("LIBTPU_VERSION", "").strip()
    if env:
        return env
    sources = sorted(KERNEL_DIR.glob("*.cu"))
    return (f"torch-{torch.__version__}-cuda-{torch.version.cuda}"
            f"-kernels-{kernel_digest(sources)[:16]}")


# ---------------------------------------------------------------------------
# The generic sweep harness.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ConfigResult:
    """One measured (or pruned/errored) config of a sweep."""

    config: Dict[str, int]
    time_ms: Optional[float] = None
    rate: Optional[float] = None  # TFLOP/s (or TOP/s for int8)
    stable: bool = False
    pruned: bool = False
    error: str = ""

    def to_dict(self) -> dict:
        out: dict = dict(self.config)
        if self.error:
            out["error"] = self.error
            return out
        out["time_ms"] = round(self.time_ms, 3) if self.time_ms else self.time_ms
        out["rate"] = round(self.rate, 2) if self.rate else self.rate
        out["stable"] = self.stable
        if self.pruned:
            out["pruned"] = True
        return out


def sweep(
    make_runner: Callable[[Dict[str, int]], Callable[[float, int], None]],
    configs: Sequence[Dict[str, int]],
    flops_per_iter: float,
    iters: int = 8,
    reps: int = 4,
    prune_ratio: float = PRUNE_RATIO,
) -> Tuple[List[ConfigResult], Optional[ConfigResult]]:
    """Sweep a config grid in two passes. ``make_runner(config)`` builds a
    chained runner ``run(seed, n)`` that reads its result back to the host
    (so a timed call holds the device's work); an invalid config may raise
    and is recorded, never fatal. Pass 1 warms each runner and takes ONE
    inclusive timing of the short chain; pass 2 runs the two-point
    estimator only for configs within ``prune_ratio`` of the cheap best.
    Returns (records, winner); the winner is the best measured rate,
    preferring stable timings."""
    from tpu_operator_torch.workloads.timing import two_point_min_timing

    probed: List[Tuple[ConfigResult, Callable]] = []
    results: List[ConfigResult] = []
    seed = 0.5
    for config in configs:
        record = ConfigResult(config=dict(config))
        results.append(record)
        try:
            run = make_runner(config)
            run(seed, iters)  # build + warm
            seed += 0.001
            t0 = time.perf_counter()
            run(seed, iters)
            seed += 0.001
            probe_s = time.perf_counter() - t0
        except Exception as e:  # noqa: BLE001 — keep sweeping past it
            record.error = f"{type(e).__name__}: {e}"
            continue
        record.time_ms = probe_s / iters * 1e3
        record.rate = flops_per_iter / (probe_s / iters) / 1e12
        probed.append((record, run))
    if not probed:
        return results, None
    best_probe = min(r.time_ms for r, _ in probed)
    for record, run in probed:
        if record.time_ms > best_probe * prune_ratio:
            record.pruned = True  # dominated: keep the probe estimate
            continue
        timing = two_point_min_timing(run, iters, 4 * iters, reps)
        t = timing.per_iter_s or timing.inclusive_per_iter_s
        record.time_ms = t * 1e3
        record.rate = flops_per_iter / t / 1e12
        record.stable = timing.per_iter_s is not None
    measured = [r for r, _ in probed if not r.pruned]
    stable = [r for r in measured if r.stable]
    winner = max(stable or measured, key=lambda r: r.rate or 0.0)
    return results, winner


# ---------------------------------------------------------------------------
# Kernel-family sweeps.
# ---------------------------------------------------------------------------


def flash_shape_class(seq_len: int, heads: int, head_dim: int) -> str:
    return f"s{seq_len}_h{heads}_d{head_dim}"


def matmul_shape_class(size: int) -> str:
    return f"m{size}"


def _flash_runner(seq_len: int, heads: int, head_dim: int, fwd_bwd: bool,
                  device: DeviceLike = None):
    """Runner factory over ``flash_attention`` at (1, seq_len, heads,
    head_dim) bf16, causal: the forward chain (each output feeds the next
    call's q), or with ``fwd_bwd`` ``timing.attention_grad_steps``. Each
    run reads a scalar back, so its time holds the kernels'; on the card
    it is one graph replay (``kernels/graph.GraphedChain``), the graphs
    freed with the runner."""
    from tpu_operator_torch.kernels.flash_fwd import check_block_m
    from tpu_operator_torch.kernels.graph import GraphedChain
    from tpu_operator_torch.workloads.flashattention import flash_attention
    from tpu_operator_torch.workloads.timing import attention_grad_steps, seeded

    dev = resolve_device(device)
    shape = (1, seq_len, heads, head_dim)
    gen = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(shape, generator=gen).to(dev, torch.bfloat16) for _ in range(3))

    def make_runner(config):
        block_m = config["block_m"]
        check_block_m(q.dtype, block_m)

        def fn(a, kk, vv):
            return flash_attention(a, kk, vv, causal=True, block_m=block_m)

        if fwd_bwd:
            steps = attention_grad_steps(fn, q, k, v)
            chain = GraphedChain(lambda s, n: steps(q, k, v, s, n), dev, "sweep fwd+bwd")
        else:
            def forward(s, n):
                out = seeded(q, s)
                with torch.no_grad():
                    for _ in range(n):
                        out = fn(out, k, v).to(q.dtype)
                return out.float().sum()
            chain = GraphedChain(forward, dev, "sweep forward")

        def run(seed, n):
            float(chain(seed, n))  # the read-back waits for the chain
        return run

    # causal attention: 2 matmuls x 2·S²/2·D MACs per head (the backward
    # adds ~2.5x, but the sweep only RANKS configs: the forward count keeps
    # fwd and fwd+bwd rates on one scale)
    flops = 2 * 2 * heads * seq_len**2 * head_dim / 2
    return make_runner, flops


def sweep_flash(
    seq_len: int = 8192,
    heads: int = 8,
    head_dim: int = 128,
    configs: Optional[Sequence[Dict[str, int]]] = None,
    iters: int = 8,
    reps: int = 4,
    fwd_bwd: bool = False,
    prune_ratio: float = PRUNE_RATIO,
    device: DeviceLike = None,
) -> Tuple[List[ConfigResult], Optional[ConfigResult]]:
    """The flash tile-height sweep (``FLASH_TILE_GRID`` by default)."""
    make_runner, flops = _flash_runner(seq_len, heads, head_dim, fwd_bwd, device)
    return sweep(make_runner, list(configs or FLASH_TILE_GRID), flops, iters=iters,
                 reps=reps, prune_ratio=prune_ratio)


def sweep_matmul(
    size: int = 8192,
    iters: int = 8,
    reps: int = 4,
    int8: bool = False,
    prune_ratio: float = PRUNE_RATIO,
    device: DeviceLike = None,
) -> Tuple[List[ConfigResult], Optional[ConfigResult]]:
    """The matmul (or int8) chain at the bench shape over ``MATMUL_GRID``:
    one config, so the record is the measured rate of the chain the
    self-test runs."""
    from tpu_operator_torch.workloads.matmul_bench import (
        int8_chain_runner,
        matmul_chain_runner,
    )

    factory = int8_chain_runner if int8 else matmul_chain_runner
    return sweep(lambda config: factory(size, device), list(MATMUL_GRID), 2.0 * size**3,
                 iters=iters, reps=reps, prune_ratio=prune_ratio)


# per-profile sweep shapes: "cuda" is the reference's "tpu" grid (the 8k
# flash class the validator and burn-in payloads run, the 8192 matmul
# bench shape); "cpu-smoke" is the reference's small one
SWEEP_PROFILES = {
    "cuda": {
        "flash": {"seq_len": 8192, "heads": 8, "head_dim": 128, "iters": 8, "reps": 4},
        "matmul": {"size": 8192, "iters": 16, "reps": 5},
    },
    "cpu-smoke": {
        "flash": {"seq_len": 256, "heads": 1, "head_dim": 64, "iters": 1, "reps": 1},
        "matmul": {"size": 128, "iters": 2, "reps": 1},
    },
}


def run_generation_sweep(
    generation: str,
    libtpu_version: str = "",
    profile: Optional[str] = None,
    device: DeviceLike = None,
) -> dict:
    """All four kernel families, one entry dict ready for the
    ``tpu-autotune-results`` ConfigMap. The profile defaults by device
    ("cuda" on the card, "cpu-smoke" on the CPU); ``entry["platform"]``
    is the device type that ran it, so a CPU entry never folds into
    floors."""
    dev = resolve_device(device)
    platform = "cuda" if dev.type == "cuda" else "cpu"
    if profile is None:
        profile = "cuda" if platform == "cuda" else "cpu-smoke"
    shapes = SWEEP_PROFILES[profile]
    f, m = shapes["flash"], shapes["matmul"]
    fwd_class = flash_shape_class(f["seq_len"], f["heads"], f["head_dim"])
    mm_class = matmul_shape_class(m["size"])
    entry: dict = {
        "generation": generation,
        "libtpu_version": libtpu_version or runtime_fingerprint(),
        "platform": platform,
        "profile": profile,
        "results": {},
    }

    def pack(records, winner):
        return {
            "winner": winner.to_dict() if winner else None,
            "configs": [r.to_dict() for r in records],
        }

    for family, fwd_bwd in (("flash_fwd", False), ("flash_fwd_bwd", True)):
        records, winner = sweep_flash(
            seq_len=f["seq_len"], heads=f["heads"], head_dim=f["head_dim"],
            iters=f["iters"], reps=f["reps"], fwd_bwd=fwd_bwd, device=dev,
        )
        entry["results"][family] = {fwd_class: pack(records, winner)}
    for family, is_int8 in (("matmul", False), ("int8", True)):
        records, winner = sweep_matmul(
            size=m["size"], iters=m["iters"], reps=m["reps"], int8=is_int8, device=dev,
        )
        entry["results"][family] = {mm_class: pack(records, winner)}
    return entry


# ---------------------------------------------------------------------------
# Cache keying / entry validity.
# ---------------------------------------------------------------------------


def cached_entries(cm_data: Optional[dict]) -> Dict[str, dict]:
    """Every parseable per-generation sweep entry in a results-CM data
    map: {generation: entry} for each ``<gen>.json`` key (the winners blob
    excluded), half-written blobs skipped."""
    out: Dict[str, dict] = {}
    for key, blob in (cm_data or {}).items():
        if not key.endswith(".json") or key == consts.AUTOTUNE_WINNERS_KEY:
            continue
        parsed = parse_entry(blob)
        if parsed is not None:
            out[key[: -len(".json")]] = parsed
    return out


def entry_key(generation: str) -> str:
    """The ConfigMap data key one generation's entry lives under."""
    return f"{generation}.json"


def parse_entry(blob: Optional[str]) -> Optional[dict]:
    """A ``<generation>.json`` payload, or None when absent/malformed —
    a half-written entry reads as a cache miss, never a crash."""
    if not blob:
        return None
    try:
        entry = json.loads(blob)
    except ValueError:
        return None
    return entry if isinstance(entry, dict) else None


def entry_valid(
    entry: Optional[dict],
    libtpu_version: str,
    families: Sequence[str] = KERNEL_FAMILIES,
) -> bool:
    """Whether a cached entry satisfies the sweep-once contract for the
    CURRENT toolchain: every kernel family present with a winner per shape
    class, and the recorded version matching."""
    if not entry or entry.get("libtpu_version") != libtpu_version:
        return False
    results = entry.get("results")
    if not isinstance(results, dict):
        return False
    for family in families:
        classes = results.get(family)
        if not isinstance(classes, dict) or not classes:
            return False
        for packed in classes.values():
            if not isinstance(packed, dict) or not packed.get("winner"):
                return False
    return True


# ---------------------------------------------------------------------------
# Winners -> floors / winners blob (the publication side).
# ---------------------------------------------------------------------------


def _best_rate(entry: dict, family: str) -> Optional[float]:
    """Best winner rate across the family's shape classes."""
    best = None
    for packed in (entry.get("results", {}).get(family) or {}).values():
        winner = (packed or {}).get("winner") or {}
        rate = winner.get("rate")
        if isinstance(rate, (int, float)) and (best is None or rate > best):
            best = float(rate)
    return best


def merge_winner_floors(entries: Dict[str, dict]) -> Dict[str, Dict[str, float]]:
    """The floors table of the CUDA-measured winners: for every entry
    measured on a card, ``matmul_tflops`` and ``int8_tops`` at
    FLOOR_FRACTION of the sweep's measured roof. It starts empty: the port
    has no scaled default floors, and a CPU entry never folds."""
    floors: Dict[str, Dict[str, float]] = {}
    for gen, entry in entries.items():
        if not isinstance(entry, dict) or entry.get("platform") != "cuda":
            continue
        target = floors.setdefault(gen, {})
        matmul = _best_rate(entry, "matmul")
        if matmul:
            target["matmul_tflops"] = round(matmul * FLOOR_FRACTION, 1)
        int8 = _best_rate(entry, "int8")
        if int8:
            target["int8_tops"] = round(int8 * FLOOR_FRACTION, 1)
    return floors


def winners_blob(entries: Dict[str, dict]) -> dict:
    """The compact winners map workloads read through TPU_AUTOTUNE_JSON:
    {generation: {family: {shape_class: winning config}}} — configs only."""
    out: dict = {}
    for gen, entry in entries.items():
        if not isinstance(entry, dict):
            continue
        families: dict = {}
        for family, classes in (entry.get("results") or {}).items():
            picked = {}
            for shape_class, packed in (classes or {}).items():
                winner = (packed or {}).get("winner")
                if isinstance(winner, dict):
                    picked[shape_class] = {k: v for k, v in winner.items() if k in _CONFIG_KEYS}
            if picked:
                families[family] = picked
        if families:
            out[gen] = families
    return out


# ---------------------------------------------------------------------------
# Workload config resolution (the read-back side).
# ---------------------------------------------------------------------------

# memoized on the env string so every un-pinned flash call costs one env
# read and an identity compare
_blob_cache: Tuple[Optional[str], dict] = (None, {})


def _published_winners() -> dict:
    global _blob_cache
    raw = os.environ.get(AUTOTUNE_ENV) or None
    if raw == _blob_cache[0]:
        return _blob_cache[1]
    parsed: dict = {}
    if raw:
        try:
            loaded = json.loads(raw)
            if isinstance(loaded, dict):
                parsed = loaded
        except ValueError:
            parsed = {}  # malformed winners never break a workload
    _blob_cache = (raw, parsed)
    return parsed


# memoized on the env override so the hot path never asks the driver again
_gen_cache: Tuple[Optional[str], str] = (None, "")


def _local_generation() -> str:
    """``TPU_GENERATION`` when set, else the card's generation key from
    ``matmul_bench.chip_generation()`` ("" with no card or an unrecognised
    one), the key the floors and the winners share."""
    global _gen_cache
    env = os.environ.get("TPU_GENERATION", "")
    if env == _gen_cache[0]:
        return _gen_cache[1]
    gen = env or chip_generation()
    _gen_cache = (env, gen)
    return gen


def _nearest_class(classes: dict, prefix: str, want: int) -> Optional[dict]:
    """Exact shape class first, else the numerically nearest swept class."""
    best, best_dist = None, None
    for name, config in classes.items():
        if not isinstance(config, dict) or not name.startswith(prefix):
            continue
        try:
            lead = int(name[len(prefix):].split("_")[0])
        except ValueError:
            continue
        dist = abs(lead - want)
        if best_dist is None or dist < best_dist:
            best, best_dist = config, dist
    return best


def _flash_winner(seq_len: int, fwd_bwd: bool) -> Optional[dict]:
    families = _published_winners().get(_local_generation()) or {}
    family = "flash_fwd_bwd" if fwd_bwd else "flash_fwd"
    return _nearest_class(families.get(family) or {}, "s", seq_len)


def tuned_flash_blocks(
    seq_len: int,
    heads: int = 8,
    head_dim: int = 128,
    default: Tuple[int, int] = (DEFAULT_FLASH_BLOCK_Q, DEFAULT_FLASH_BLOCK_K),
    fwd_bwd: bool = False,
) -> Tuple[int, int]:
    """The (block_q, block_k) a flash caller should run: the published
    winner for this generation's nearest shape class, when its blocks
    divide the sequence; the default otherwise."""
    config = _flash_winner(seq_len, fwd_bwd)
    if config:
        try:
            bq, bk = int(config["block_q"]), int(config["block_k"])
        except (KeyError, TypeError, ValueError):
            return default
        if bq > 0 and bk > 0 and seq_len % min(bq, seq_len) == 0 and seq_len % min(bk, seq_len) == 0:
            return bq, bk
    return default


def tuned_flash_tile(seq_len: int, heads: int = 8, head_dim: int = 128,
                     fwd_bwd: bool = False) -> Optional[int]:
    """The q-tile height (``block_m``) a flash caller should run: the
    published winner's for this generation's nearest shape class, when it
    is one of the plans' heights; None otherwise (the plan chooses)."""
    config = _flash_winner(seq_len, fwd_bwd)
    block_m = (config or {}).get("block_m")
    if isinstance(block_m, bool) or block_m not in (64, 128):
        return None
    return int(block_m)
