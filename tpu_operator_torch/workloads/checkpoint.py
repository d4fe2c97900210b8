"""Checkpoint store: atomic epochs, a manifest, torn-blob fallback (a
copy of ``tpu_operator/workloads/checkpoint.py``; a store written by
either package reads back through the other).

The durability layer under the TPUJob resume guarantee ("no step lost
beyond the last checkpoint"). Layout of one store directory::

    epoch-000001.npz      # one immutable blob per checkpoint epoch
    epoch-000002.npz
    MANIFEST.json         # epoch index: file, step, sha256, meta

Write protocol (crash-safe at every cut point):

1. the blob is serialized to a uniquely-named temp file in the same
   directory and published by ``os.replace`` — a reader never sees a
   half-written blob under a published name;
2. only THEN is the manifest rewritten (same temp+rename protocol) to
   reference it. A crash between (1) and (2) leaves an orphan blob the
   manifest never names — the previous epoch stays the latest good one.

Read protocol (``latest_good``): walk the manifest newest-first and
return the first epoch whose blob exists, matches its recorded sha256,
and deserializes. A torn or corrupted blob (bit rot, a partial copy, a
crashed writer that somehow published) falls back to the previous
epoch instead of failing the resume. An unreadable manifest reads as an
empty store (epoch 0 — train from scratch) rather than a crash.

numpy only: the trainer (``workloads/training.py``) hands it float32
numpy arrays in the reference's global layout.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import logging
import os
import tempfile
import threading
import time
from typing import Dict, List, Optional

import numpy as np

log = logging.getLogger(__name__)

MANIFEST_NAME = "MANIFEST.json"


@dataclasses.dataclass(frozen=True)
class Checkpoint:
    """One resolved (verified-good) checkpoint."""

    epoch: int
    step: int
    arrays: Dict[str, np.ndarray]
    meta: dict


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _atomic_write(path: str, data: bytes) -> None:
    """Publish ``data`` under ``path`` via a same-directory temp file +
    ``os.replace``: readers see the old content or the new, never a
    prefix. Unique temp names keep concurrent writers (two gang hosts,
    a crashed process's leftover) from scribbling on each other."""
    directory = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(prefix=".tmp-", dir=directory)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class CheckpointStore:
    """Epoch-numbered checkpoint store over one directory.

    In-process writes serialize on a lock, so two concurrent ``save``
    calls produce two distinct epochs and a manifest that names both —
    never a half-written manifest. Cross-process safety rides the rename
    protocol alone: last manifest writer wins, and every published state
    is internally consistent.
    """

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()

    # -- paths ---------------------------------------------------------------

    def _manifest_path(self) -> str:
        return os.path.join(self.directory, MANIFEST_NAME)

    def _blob_name(self, epoch: int) -> str:
        return f"epoch-{epoch:06d}.npz"

    # -- manifest ------------------------------------------------------------

    def manifest(self) -> List[dict]:
        """Epoch entries, oldest first. Unreadable/malformed manifests
        read as empty — resume degrades to from-scratch, never a raise."""
        try:
            with open(self._manifest_path(), "rb") as f:
                raw = json.load(f)
        except (OSError, ValueError):
            return []
        entries = raw.get("epochs") if isinstance(raw, dict) else None
        if not isinstance(entries, list):
            return []
        good = []
        for entry in entries:
            if (
                isinstance(entry, dict)
                and isinstance(entry.get("epoch"), int)
                and isinstance(entry.get("file"), str)
            ):
                good.append(entry)
        return sorted(good, key=lambda e: e["epoch"])

    def _write_manifest(self, entries: List[dict]) -> None:
        payload = json.dumps({"epochs": entries}, sort_keys=True).encode()
        _atomic_write(self._manifest_path(), payload)

    # -- save/load -----------------------------------------------------------

    def save(self, step: int, arrays: Dict[str, np.ndarray], meta: Optional[dict] = None) -> int:
        """Persist one checkpoint; returns its epoch number. The blob is
        published before the manifest names it, so every observable
        manifest state points only at fully-written blobs."""
        buf = io.BytesIO()
        np.savez(buf, **{k: np.asarray(v) for k, v in arrays.items()})
        blob = buf.getvalue()
        with self._lock:
            entries = self.manifest()
            epoch = (entries[-1]["epoch"] + 1) if entries else 1
            name = self._blob_name(epoch)
            _atomic_write(os.path.join(self.directory, name), blob)
            entries.append({
                "epoch": epoch,
                "step": int(step),
                "file": name,
                "sha256": _sha256(blob),
                "time": time.time(),
                "meta": dict(meta or {}),
            })
            self._write_manifest(entries)
        return epoch

    def _load_entry(self, entry: dict) -> Optional[Checkpoint]:
        path = os.path.join(self.directory, entry["file"])
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except OSError:
            return None  # blob vanished: fall back
        if entry.get("sha256") and _sha256(blob) != entry["sha256"]:
            log.warning("checkpoint %s: checksum mismatch (torn blob); falling back",
                        entry["file"])
            return None
        try:
            with np.load(io.BytesIO(blob)) as npz:
                arrays = {k: npz[k] for k in npz.files}
        except (OSError, ValueError, KeyError, EOFError):
            log.warning("checkpoint %s: undeserializable; falling back", entry["file"])
            return None
        return Checkpoint(
            epoch=int(entry["epoch"]),
            step=int(entry.get("step", 0)),
            arrays=arrays,
            meta=dict(entry.get("meta") or {}),
        )

    def latest_good(self) -> Optional[Checkpoint]:
        """Newest checkpoint that verifies end to end; a torn/corrupt
        blob falls back to the previous epoch. None = empty store."""
        for entry in reversed(self.manifest()):
            ckpt = self._load_entry(entry)
            if ckpt is not None:
                return ckpt
        return None

    def load(self, epoch: int) -> Optional[Checkpoint]:
        for entry in self.manifest():
            if entry["epoch"] == epoch:
                return self._load_entry(entry)
        return None

    def latest_entry(self) -> Optional[dict]:
        """The newest manifest entry (verified or not) — what the
        bookkeeping surfaces without paying a blob read."""
        entries = self.manifest()
        return entries[-1] if entries else None

    def prune(self, keep: int = 3) -> int:
        """Drop all but the newest ``keep`` epochs (manifest first, then
        the orphaned blobs); returns how many were removed."""
        with self._lock:
            entries = self.manifest()
            if keep <= 0 or len(entries) <= keep:
                return 0
            dropped, kept = entries[:-keep], entries[-keep:]
            self._write_manifest(kept)
            for entry in dropped:
                try:
                    os.unlink(os.path.join(self.directory, entry["file"]))
                except OSError:
                    pass
            return len(dropped)
