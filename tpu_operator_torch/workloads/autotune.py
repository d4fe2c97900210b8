"""Read-back side of the autotune winners (port of the workload config
resolution in ``tpu_operator/workloads/autotune.py``).

The operator publishes per-generation sweep winners as JSON in
``TPU_AUTOTUNE_JSON``; a flash caller that leaves its blocks unset asks
:func:`tuned_flash_blocks`. In the port the blocks keep only their role in
the divisibility checks — the CUDA kernels choose their own tiles — but
the resolution is the same, so a caller sees the same errors.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

from tpu_operator_torch.workloads.matmul_bench import chip_generation

AUTOTUNE_ENV = "TPU_AUTOTUNE_JSON"
DEFAULT_FLASH_BLOCK_Q = 1024
DEFAULT_FLASH_BLOCK_K = 1024

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
    gen = _local_generation()
    families = _published_winners().get(gen) or {}
    family = "flash_fwd_bwd" if fwd_bwd else "flash_fwd"
    config = _nearest_class(families.get(family) or {}, "s", seq_len)
    if config:
        try:
            bq, bk = int(config["block_q"]), int(config["block_k"])
        except (KeyError, TypeError, ValueError):
            return default
        if bq > 0 and bk > 0 and seq_len % min(bq, seq_len) == 0 and seq_len % min(bk, seq_len) == 0:
            return bq, bk
    return default
