"""Per-generation perf floors (the part of ``tpu_operator/perf.py`` the
card needs).

A floor is ``FLOOR_FRACTION`` of a roof measured on the card: the
autotune sweep's winners fold into the floors table
(``workloads/autotune.merge_winner_floors``), the operator publishes it
as the ``tpu-perf-floors`` ConfigMap, and the metrics exporter and the
validator hold their probes to this card's entry. There is no built-in
table: the reference's holds TPU generations only, and a card's floors
come only from its own sweep.
"""

from __future__ import annotations

import json
from typing import Dict, Optional

# a floor is this fraction of the measured roof (the reference's value)
FLOOR_FRACTION = 0.7


def floors_for(generation: str, floors_blob: Optional[str]) -> Dict[str, float]:
    """The floor map for one generation from a floors.json blob; {} when
    the generation is absent or the blob is malformed, and non-numeric
    probe values skipped (a half-written ConfigMap never crashes a
    reader)."""
    try:
        table = json.loads(floors_blob) if floors_blob else {}
    except (ValueError, TypeError):
        return {}
    entry = table.get(generation) if isinstance(table, dict) else None
    if not isinstance(entry, dict):
        return {}
    out: Dict[str, float] = {}
    for probe, value in entry.items():
        try:
            out[str(probe)] = float(value)
        except (TypeError, ValueError):
            continue
    return out
