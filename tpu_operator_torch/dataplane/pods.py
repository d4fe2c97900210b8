"""The rendezvous predicate of the gang's worker pods (a copy of
``rendezvous_state`` in ``tpu_operator/dataplane/pods.py``)."""

from __future__ import annotations

from typing import Optional

from tpu_operator_torch import consts


def rendezvous_state(progress_data: Optional[dict], expected: int,
                     gang_hash: str) -> dict:
    """Evaluate the rendezvous handshake from the progress-CM data:
    which of the ``expected`` member indexes have published
    ``rendezvous.<i>`` = the CURRENT gang hash (a stale hash is a
    worker from a previous generation still draining)."""
    data = progress_data or {}
    checked_in = []
    stale = []
    for index in range(expected):
        value = data.get(f"{consts.JOB_RENDEZVOUS_PREFIX}{index}")
        if value == gang_hash:
            checked_in.append(index)
        elif value:
            stale.append(index)
    return {
        "expected": expected,
        "checked_in": checked_in,
        "stale": stale,
        "complete": len(checked_in) == expected and expected > 0,
    }
