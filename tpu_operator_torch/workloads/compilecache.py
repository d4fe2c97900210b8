"""The fleet compile cache: compiled-kernel records and the warm-start
path (port of ``tpu_operator/workloads/compilecache.py``).

A fresh serving replica pays its first kernel builds before its first
token. On the card the port's executables are the shared libraries
``kernels/build.py`` compiles with ``nvcc``: :func:`bind_persistent_cache`
points that build directory at the node's compile cache, so a replica
whose libraries are already there loads them and runs no ``nvcc`` (the
counterpart of a JAX persistent-cache hit that skips lowering).

The ConfigMap vocabulary is the reference's, byte for byte: records are
content-addressed by (generation, topology, model descriptor hash,
toolchain version) in the ``tpu-compile-cache`` ConfigMap, one
``<generation>.json`` record map per generation, so either package's
store reads the other's records (given the same toolchain version). On
the CPU nothing is compiled: a hit replays the recorded cold cost at
``WARM_FRACTION``, as the reference does off TPU.

Client errors are matched by class name (``ApiError``, ``NotFound``,
``AlreadyExists``) through the MRO, as ``training.publish_configmap`` (the
store's one write path) does, so the reference's client and any client
with ``get_or_none``/``patch``/``create`` over dicts work.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import time
from typing import Dict, Optional, Tuple

import torch

from tpu_operator_torch import consts
from tpu_operator_torch.kernels import build
from tpu_operator_torch.kube import is_api_error
from tpu_operator_torch.workloads.autotune import runtime_fingerprint
from tpu_operator_torch.workloads.training import publish_configmap

# a hit still pays loading the libraries and the first launches, a tenth
# of the cold build it skips by the reference's estimate: the planning
# layer never prices a warm scale-up at zero
WARM_FRACTION = 0.1


def entry_key(generation: str) -> str:
    """The ConfigMap data key one generation's record map lives under."""
    return f"{generation}.json"


def record_key(topology: str, model_hash: str) -> str:
    """The content address of one compiled executable inside a generation
    entry: topology x model descriptor hash."""
    return f"{topology or 'any'}/{model_hash}"


def model_descriptor_hash(cfg=None) -> str:
    """A stable content hash of every ``ServingModelConfig`` field (a
    different ``max_seq`` or ``int8_mlp`` is a different executable);
    ``None`` hashes the default config. The port's config has the
    reference's fields and defaults, so both give the same hash."""
    from tpu_operator_torch.workloads.serving import ServingModelConfig

    fields = dataclasses.asdict(cfg or ServingModelConfig())
    blob = json.dumps(fields, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def parse_entry(blob: Optional[str]) -> Optional[dict]:
    """A ``<generation>.json`` payload, or None when absent/malformed — a
    half-written entry reads as a cache miss, never a crash."""
    if not blob:
        return None
    try:
        entry = json.loads(blob)
    except ValueError:
        return None
    return entry if isinstance(entry, dict) else None


def entry_valid(entry: Optional[dict], libtpu_version: str) -> bool:
    """Whether a cached entry is usable under the CURRENT toolchain: the
    recorded version matching and a non-empty record map."""
    if not entry or entry.get("libtpu_version") != libtpu_version:
        return False
    records = entry.get("records")
    return isinstance(records, dict) and bool(records)


def cache_record(
    entry: Optional[dict], topology: str, model_hash: str, libtpu_version: str
) -> Optional[dict]:
    """The compiled-executable record for one content address, or None."""
    if not entry_valid(entry, libtpu_version):
        return None
    record = (entry.get("records") or {}).get(record_key(topology, model_hash))
    return record if isinstance(record, dict) else None


def cached_entries(cm_data: Optional[dict]) -> Dict[str, dict]:
    """Every parseable per-generation entry in a compile-cache data map:
    {generation: entry} for each ``<gen>.json`` key (the handshake keys
    excluded), half-written blobs skipped."""
    skip = (consts.COMPILE_PREWARM_REQUEST_KEY, consts.COMPILE_PREWARM_ACK_KEY)
    out: Dict[str, dict] = {}
    for key, blob in (cm_data or {}).items():
        if not key.endswith(".json") or key in skip:
            continue
        parsed = parse_entry(blob)
        if parsed is not None:
            out[key[: -len(".json")]] = parsed
    return out


def parse_requests(blob: Optional[str]) -> Dict[str, dict]:
    """The prewarm request map ({request id: request}), {} on
    absent/malformed."""
    parsed = parse_entry(blob)
    requests = (parsed or {}).get("requests")
    if not isinstance(requests, dict):
        return {}
    return {k: v for k, v in requests.items() if isinstance(v, dict)}


def request_id(generation: str, topology: str, model_hash: str) -> str:
    return f"{generation}/{record_key(topology, model_hash)}"


def bind_persistent_cache(cache_dir: Optional[str] = None, device=None) -> bool:
    """On a card, point the kernel build directory at the node's compile
    cache (``cache_dir``, else ``TPU_COMPILE_CACHE_DIR``, else
    ``/var/cache/tpu-compile``), so a library built once per node loads in
    every later process without ``nvcc``. Returns True when bound; False
    on the CPU (``device`` given and not CUDA, or no CUDA at all) and when
    the directory cannot be bound — binding must never break serving, and
    the kernels then build in the default directory. Nothing falls back
    from a kernel to its plain version."""
    on_card = torch.device(device).type == "cuda" if device is not None else \
        torch.cuda.is_available()
    if not on_card:
        return False
    path = (
        cache_dir
        or os.environ.get(consts.COMPILE_CACHE_DIR_ENV, "").strip()
        or consts.COMPILE_CACHE_DIR_DEFAULT
    )
    try:
        build.bind_build_dir(path)
    except OSError:
        return False
    return True


# ---------------------------------------------------------------------------
# In-process hit/miss accounting. The sim kubelet builds replicas in
# threads, so the counters take a lock.
# ---------------------------------------------------------------------------

_stats_lock = threading.Lock()
_HITS: Dict[str, int] = {}
_MISSES: Dict[str, int] = {}
_DECISIONS: list = []  # last prewarm/warm-start decisions, bounded
_DECISIONS_LIMIT = 20


def _note(outcome: str, generation: str, detail: str) -> None:
    with _stats_lock:
        if outcome == "hit":
            _HITS[generation] = _HITS.get(generation, 0) + 1
        elif outcome == "miss":
            _MISSES[generation] = _MISSES.get(generation, 0) + 1
        _DECISIONS.append({"outcome": outcome, "generation": generation,
                           "detail": detail})
        del _DECISIONS[:-_DECISIONS_LIMIT]


def stats() -> dict:
    """A snapshot of this process's cache traffic: per-generation hit and
    miss counters and the last decisions."""
    with _stats_lock:
        return {
            "hits": dict(_HITS),
            "misses": dict(_MISSES),
            "decisions": list(_DECISIONS),
        }


def reset_stats() -> None:
    """Forget this process's counters."""
    with _stats_lock:
        _HITS.clear()
        _MISSES.clear()
        del _DECISIONS[:]


# ---------------------------------------------------------------------------
# The store: resolve / publish / ack against the shared ConfigMap.
# ---------------------------------------------------------------------------


class CompileCacheStore:
    """One namespace's view of the ``tpu-compile-cache`` ConfigMap: the
    worker-side read/resolve/publish path. All of this module's ConfigMap
    writes (record publication and prewarm acks) go through ``_merge``."""

    def __init__(self, client=None, namespace: str = "", libtpu_version: str = ""):
        self.client = client
        self.namespace = namespace
        self.libtpu_version = libtpu_version or runtime_fingerprint()

    # -- reads ------------------------------------------------------------

    def read_data(self) -> Optional[dict]:
        """The cache CM's data map; {} when the CM does not exist yet, None
        when the API is unreachable (an ``ApiError``) — callers gating on
        the cache must treat None as unknown, never as empty."""
        if self.client is None:
            return {}
        try:
            cm = self.client.get_or_none(
                "v1", "ConfigMap", consts.COMPILE_CACHE_CONFIGMAP, self.namespace
            )
        except Exception as e:  # noqa: BLE001 — matched by name, else re-raised
            if is_api_error(e, "ApiError"):
                return None
            raise
        return (cm or {}).get("data") or {}

    def resolve(self, generation: str, topology: str, model_hash: str) -> Optional[dict]:
        """The record for one content address, counting the hit or miss (an
        unreadable API counts as a miss: the worker just builds)."""
        data = self.read_data() or {}
        entry = parse_entry(data.get(entry_key(generation)))
        record = cache_record(entry, topology, model_hash, self.libtpu_version)
        _note("hit" if record else "miss", generation, record_key(topology, model_hash))
        return record

    # -- writes -------------------------------------------------------------

    def _merge(self, data: Dict[str, str]) -> None:
        """Merge-patch data keys into the cache CM, creating it on first use."""
        publish_configmap(self.client, consts.COMPILE_CACHE_CONFIGMAP, self.namespace, data)

    def publish(
        self,
        generation: str,
        topology: str,
        model_hash: str,
        seconds: float,
        source: str = "worker",
        serving: str = "",
        node: str = "",
    ) -> dict:
        """Record one measured compile: read-modify-write the generation's
        entry (records of other addresses kept while valid for this
        toolchain; an invalid entry is replaced wholesale — that is the
        invalidation)."""
        if self.client is None:
            raise RuntimeError("compile-cache publish requires a client")
        data = self.read_data() or {}
        entry = parse_entry(data.get(entry_key(generation)))
        if not entry_valid(entry, self.libtpu_version):
            entry = {
                "generation": generation,
                "libtpu_version": self.libtpu_version,
                "records": {},
            }
        record = {
            "seconds": round(max(0.0, float(seconds)), 4),
            "source": source,
            "serving": serving,
            "node": node,
        }
        entry["records"][record_key(topology, model_hash)] = record
        self._merge({entry_key(generation): json.dumps(entry, sort_keys=True)})
        return record

    def ack(self, rid: str, node: str, seconds: float, outcome: str) -> None:
        """Publish one prewarm ack (the agent's half of the handshake)."""
        data = self.read_data() or {}
        parsed = parse_entry(data.get(consts.COMPILE_PREWARM_ACK_KEY)) or {}
        acks = parsed.get("acks")
        if not isinstance(acks, dict):
            acks = {}
        acks[rid] = {
            "node": node,
            "seconds": round(max(0.0, float(seconds)), 4),
            "outcome": outcome,
        }
        self._merge({consts.COMPILE_PREWARM_ACK_KEY: json.dumps(
            {"acks": acks}, sort_keys=True)})

    # -- the worker warm-start path ---------------------------------------

    def warm_start(
        self,
        engine,
        generation: str,
        topology: str,
        serving: str = "",
        prompt_len: Optional[int] = None,
        node: str = "",
    ) -> Tuple[str, float]:
        """Run an engine's warm-up through the cache: resolve the record
        (counted), bind the kernel build directory to the compile cache on
        the engine's device when it is a card, run the warm-up, and on a
        miss publish the measured seconds so the next replica of this key
        starts warm. Returns (outcome, measured warm-up seconds); outcome
        is "hit", "miss" or "unkeyed" (no generation: cache skipped)."""
        cfg = engine.cfg
        if prompt_len is None:
            prompt_len = min(cfg.prefill_chunk, cfg.max_seq // 4)
        if not generation:
            t0 = time.perf_counter()
            engine.warmup(prompt_len)
            return "unkeyed", time.perf_counter() - t0
        model_hash = model_descriptor_hash(cfg)
        record = self.resolve(generation, topology, model_hash)
        bound = bind_persistent_cache(device=engine.device)
        t0 = time.perf_counter()
        engine.warmup(prompt_len)
        seconds = time.perf_counter() - t0
        if record is not None:
            if not bound:
                # the CPU has no executables to load: the hit replays the
                # recorded cold cost at the warm fraction
                recorded = record.get("seconds")
                if isinstance(recorded, (int, float)) and recorded > 0.0:
                    seconds = min(seconds, round(recorded * WARM_FRACTION, 4))
            return "hit", seconds
        if self.client is not None:
            try:
                self.publish(
                    generation, topology, model_hash, seconds,
                    source="worker", serving=serving, node=node,
                )
            except Exception as e:  # noqa: BLE001 — best-effort; the build happened
                if not is_api_error(e, "ApiError"):
                    raise
        return "miss", seconds
