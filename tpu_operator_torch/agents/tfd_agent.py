"""Feature discovery on a card node: the GFD labels (port of
``tpu_operator/agents/tfd_agent.py``).

Each pass probes the node's cards once through the one card probe
(``native/gpuinfo.probe``) and publishes GPU feature discovery's labels
from what it found (``nodeinfo.gfd_labels``): ``nvidia.com/gpu.product``
(the card's model, spaces as dashes), ``nvidia.com/gpu.count``,
``nvidia.com/gpu.memory`` and the ``nvidia.com/cuda.driver.*`` version parts
where the probe knows them. The port's ``node_generation`` and
``expected_cards`` read them.

The reference's rules hold: ``{}`` strips the node's card labels
(``nodeinfo.CARD_LABELS``: discovery's too, as the reference's strips its
``TFD_LABELS``), None
(indeterminate) changes nothing, and the probe runs once per pass. Where the
reference derives its labels from the platform's TPU labels, the port
derives them from the probe alone, so:

- a failed probe is indeterminate;
- a successful probe of no cards strips, except on a node whose platform
  labels its accelerator (GKE's ``cloud.google.com/gke-accelerator``):
  there the probe cannot see what the platform says is present, and nothing
  changes.

    python -m tpu_operator_torch.agents.tfd_agent

reads ``NODE_NAME`` and ``TFD_SLEEP_INTERVAL``.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional

from tpu_operator_torch import consts
from tpu_operator_torch.kube import is_api_error
from tpu_operator_torch.native import gpuinfo
from tpu_operator_torch.nodeinfo import CARD_LABELS, gfd_labels

log = logging.getLogger(__name__)


class TFDAgent:
    def __init__(self, client, node_name: str, interval: float = 60.0):
        self.client = client
        self.node_name = node_name
        self.interval = interval

    @staticmethod
    def _probe() -> Optional[dict]:
        """The card inventory; None when the probe failed."""
        try:
            return gpuinfo.probe()
        except (OSError, RuntimeError) as e:
            log.warning("tfd: card probe failed: %s", e)
            return None

    def discover(self, node: dict) -> Optional[dict]:
        """Labels to publish for ``node`` (``{}`` = strip ours, None =
        indeterminate, change nothing)."""
        inventory = self._probe()  # once per pass
        if inventory is None:
            return None
        if inventory["chip_count"] <= 0:
            labels = (node["metadata"].get("labels") or {})
            return None if labels.get(consts.GKE_GPU_ACCELERATOR_LABEL) else {}
        return gfd_labels(inventory)

    def apply_once(self) -> bool:
        """Update the node where discovery differs from its labels."""
        node = self.client.get_or_none("v1", "Node", self.node_name)
        if node is None:
            return False
        want = self.discover(node)
        if want is None:
            return False
        labels = node["metadata"].setdefault("labels", {})
        changed = False
        for key, value in want.items():
            if labels.get(key) != value:
                labels[key] = value
                changed = True
        if not want:
            for key in CARD_LABELS:
                if key in labels:
                    del labels[key]
                    changed = True
        if changed:
            try:
                self.client.update(node)
            except Exception as e:  # noqa: BLE001 — matched by name, else re-raised
                if not is_api_error(e, "Conflict"):
                    raise
                return False
        return changed

    def run_forever(self) -> None:
        while True:
            try:
                self.apply_once()
            except Exception as e:  # noqa: BLE001 — matched by name, else re-raised
                if not is_api_error(e, "ApiError"):
                    raise
                log.warning("tfd: %s", e)
            time.sleep(self.interval)


def main() -> int:
    logging.basicConfig(level=logging.INFO)
    from tpu_operator_torch.kube import Client

    node_name = os.environ.get("NODE_NAME", "")
    if not node_name:
        log.error("NODE_NAME required")
        return 1
    try:
        interval = float(os.environ.get("TFD_SLEEP_INTERVAL", "60").strip())
    except ValueError:
        log.warning("invalid TFD_SLEEP_INTERVAL %r; using 60s",
                    os.environ.get("TFD_SLEEP_INTERVAL"))
        interval = 60.0
    TFDAgent(Client.in_cluster(), node_name, interval=interval).run_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
