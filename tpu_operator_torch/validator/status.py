"""Validation status files (copy of ``tpu_operator/validator/status.py``:
the barrier files other operands wait on)."""

from __future__ import annotations

import json
import os
import tempfile
from typing import Optional

VALIDATION_DIR = "/run/tpu/validations"

def status_path(name: str, validation_dir: Optional[str] = None) -> str:
    return os.path.join(validation_dir or VALIDATION_DIR, name)


def write_status(name: str, validation_dir: Optional[str] = None, payload: Optional[dict] = None) -> str:
    """Create/refresh a status file; payload (if any) is stored as JSON so
    downstream consumers (node metrics exporter) can read results."""
    path = status_path(name, validation_dir)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    # atomic: the files are barrier flags on a hostPath shared across
    # containers — a torn read must be impossible
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), prefix=f".{name}.")
    try:
        with os.fdopen(fd, "w") as f:
            if payload is not None:
                json.dump(payload, f)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except FileNotFoundError:
            pass
        raise
    return path


def clear_status(name: str, validation_dir: Optional[str] = None) -> None:
    """reference: deleteStatusFile — stale results must be removed before a
    re-check so consumers never trust an outdated barrier."""
    try:
        os.remove(status_path(name, validation_dir))
    except FileNotFoundError:
        pass


def read_status(name: str, validation_dir: Optional[str] = None) -> Optional[dict]:
    """None when the file is absent; {} when present but empty."""
    try:
        with open(status_path(name, validation_dir)) as f:
            content = f.read().strip()
            return json.loads(content) if content else {}
    except FileNotFoundError:
        return None
    except json.JSONDecodeError:
        return {}
