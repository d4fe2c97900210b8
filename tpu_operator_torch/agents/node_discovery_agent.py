"""Node discovery on a card node: the NFD bootstrap (port of
``tpu_operator/agents/node_discovery_agent.py``).

Its DaemonSet schedules on every Linux node, with no card gate, and breaks
the circle in which the gated operands schedule only on nodes already
known to have cards. Each pass probes the node's cards through the one card
probe (``native/gpuinfo.probe``) and, where it finds some, stamps Node Feature
Discovery's presence label for NVIDIA's PCI vendor id
(``feature.node.kubernetes.io/pci-10de.present``) and GFD's card count
(``nvidia.com/gpu.count``); ``nodeinfo.is_gpu_node`` then recognises the
node and feature discovery enriches it.

The reference's rules of stamping and stripping hold:

- a probe that sees no card publishes nothing;
- cards gone strip the agent's labels and feature discovery's
  (``nodeinfo.CARD_LABELS``);
- a probe that fails changes nothing: one bad tick must not tear down every
  gated operand on the node;
- on a node whose platform labels its accelerator (GKE's
  ``cloud.google.com/gke-accelerator``) only the probed count is published
  and nothing is stripped: the platform owns the node's identity.

The reference also reads the TPU VM's identity from its runtime's env
(``parse_vm_accelerator_type``, ``TPU_TOPOLOGY``, the worker's torus
coordinates from ``TPU_WORKER_ID``). A card node has no such contract,
and the cards' identity comes from the probe, so the port has no
counterpart: it stamps only what it probed.

    python -m tpu_operator_torch.agents.node_discovery_agent

reads ``NODE_NAME`` and ``DISCOVERY_SLEEP_INTERVAL``.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, Optional

from tpu_operator_torch import consts
from tpu_operator_torch.kube import is_api_error
from tpu_operator_torch.native import gpuinfo
from tpu_operator_torch.nodeinfo import CARD_LABELS

log = logging.getLogger(__name__)


class NodeDiscoveryAgent:
    """Probe the node's cards and publish the discovery labels on its Node."""

    def __init__(self, client, node_name: str, interval: float = 60.0):
        self.client = client
        self.node_name = node_name
        self.interval = interval

    @staticmethod
    def probe_chips() -> Optional[int]:
        """The node's card count; None when the probe itself failed. A
        successful probe of no cards justifies stripping labels, a failed
        one does not."""
        try:
            return gpuinfo.probe()["chip_count"]
        except (OSError, RuntimeError) as e:
            log.warning("node-discovery: card probe failed: %s", e)
            return None

    def discover(self) -> Optional[Dict[str, str]]:
        """Labels to publish: ``{}`` when a successful probe saw no card,
        None when the probe failed (indeterminate: change nothing)."""
        chips = self.probe_chips()
        if chips is None:
            return None
        if chips <= 0:
            return {}
        return {consts.NFD_PRESENT_LABEL: "true", consts.GFD_COUNT_LABEL: str(chips)}

    def apply_once(self) -> bool:
        """Stamp the labels that differ, or strip them when a successful
        probe found no card on a node the platform does not label; True
        when the node changed."""
        want = self.discover()
        if want is None:
            return False
        node = self.client.get_or_none("v1", "Node", self.node_name)
        if node is None:
            return False
        labels = node["metadata"].setdefault("labels", {})
        platform_owned = bool(labels.get(consts.GKE_GPU_ACCELERATOR_LABEL))
        changed = False
        if want:
            if platform_owned:
                want = {consts.GFD_COUNT_LABEL: want[consts.GFD_COUNT_LABEL]}
            for key, value in want.items():
                if labels.get(key) != value:
                    labels[key] = value
                    changed = True
        elif not platform_owned:
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
                return False  # the node moved under us; the next tick retries
        return changed

    def run_forever(self) -> None:
        while True:
            try:
                self.apply_once()
            except Exception as e:  # noqa: BLE001 — matched by name, else re-raised
                if not is_api_error(e, "ApiError"):
                    raise
                log.warning("node-discovery: %s", e)
            time.sleep(self.interval)


def main() -> int:
    logging.basicConfig(level=logging.INFO)
    from tpu_operator_torch.kube import Client

    node_name = os.environ.get("NODE_NAME", "")
    if not node_name:
        log.error("NODE_NAME required")
        return 1
    try:
        interval = float(os.environ.get("DISCOVERY_SLEEP_INTERVAL", "60").strip())
    except ValueError:
        log.warning("invalid DISCOVERY_SLEEP_INTERVAL %r; using 60s",
                    os.environ.get("DISCOVERY_SLEEP_INTERVAL"))
        interval = 60.0
    NodeDiscoveryAgent(Client.in_cluster(), node_name, interval=interval).run_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
