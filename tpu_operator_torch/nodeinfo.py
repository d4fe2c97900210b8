"""The node identity the port's agents read from a Node's labels.

Two label sets name a node's accelerator:

1. the reference's TPU label sets, the platform's
   (``cloud.google.com/gke-tpu-accelerator``) and the operator's node
   discovery (``tpu.google.com/accelerator-type``), through a copy of the
   generation part of ``tpu_operator/nodeinfo.py::tpu_info``. The key is
   the one the reference's controllers elect and fold under, so a port
   agent on a node they elected answers under the same generation;
2. NVIDIA's GPU feature discovery (GFD) labels, ``nvidia.com/gpu.product``
   (the CUDA device name with spaces as dashes) and
   ``nvidia.com/gpu.count``, through the one table of H100 variants that
   ``workloads/matmul_bench.chip_generation`` also reads.

The port's own discovery agents publish the second set: ``gfd_labels``
(the counterpart of the reference's ``tfd_labels``) from the card probe's
inventory, and Node Feature Discovery's ``pci-10de.present``, which with the
platform's accelerator label makes ``is_gpu_node`` (the counterpart of
``is_tpu_node``).

Pure Python: importing it touches no device.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

from tpu_operator_torch import consts

# generation -> substrings a CUDA device name (or a GFD product label)
# must all contain, lower case; the SXM part reports itself as "NVIDIA
# H100 80GB HBM3" (GFD: "NVIDIA-H100-80GB-HBM3")
DEVICE_NAME_GENERATIONS = (
    ("h100-nvl", ("h100", "nvl")),
    ("h100-pcie", ("h100", "pcie")),
    ("h100-sxm", ("h100", "sxm")),
    ("h100-sxm", ("h100", "hbm3")),
)

# copied from tpu_operator/nodeinfo.py::ACCELERATORS: accelerator type ->
# (generation, chips per host)
TPU_ACCELERATORS: Dict[str, tuple] = {
    "tpu-v4-podslice": ("v4", 4),
    "tpu-v5-lite-podslice": ("v5e", 4),
    "tpu-v5-lite-device": ("v5e", 8),
    "tpu-v5p-slice": ("v5p", 4),
    "tpu-v6e-slice": ("v6e", 4),
}


def device_generation(name: str) -> str:
    """The generation key of a CUDA device name or GFD product string
    (``"h100-sxm"``, ``"h100-pcie"``, ``"h100-nvl"``); ``""`` for a card
    the table does not know."""
    name = name.lower()
    for gen, needles in DEVICE_NAME_GENERATIONS:
        if all(needle in name for needle in needles):
            return gen
    return ""


def _labels(node: Optional[dict]) -> Dict[str, str]:
    return ((node or {}).get("metadata") or {}).get("labels") or {}


def _tpu_accelerator(labels: Dict[str, str]) -> tuple:
    """(accelerator type, topology) from the platform's labels, else from
    node discovery's; ("", "") when neither is set."""
    acc_type = labels.get(consts.GKE_TPU_ACCELERATOR_LABEL, "")
    if acc_type:
        return acc_type, labels.get(consts.GKE_TPU_TOPOLOGY_LABEL, "")
    return (labels.get(consts.TFD_ACCELERATOR_TYPE_LABEL, ""),
            labels.get(consts.TFD_TOPOLOGY_LABEL, ""))


def node_generation(node: Optional[dict]) -> str:
    """The node's generation key: the reference's TPU label sets first
    (``"unknown"`` for an accelerator type its catalog lacks, as
    ``tpu_info`` gives it), then GFD's product label (``"unknown"`` for a
    card the table does not know); ``""`` when neither label set is
    present."""
    labels = _labels(node)
    acc_type, _ = _tpu_accelerator(labels)
    if acc_type:
        return TPU_ACCELERATORS.get(acc_type, ("unknown", 0))[0]
    product = labels.get(consts.GFD_PRODUCT_LABEL, "")
    if product:
        return device_generation(product) or "unknown"
    return ""


def _int_label(labels: Dict[str, str], key: str) -> Optional[int]:
    try:
        return int(labels[key])
    except (KeyError, ValueError):
        return None


def expected_cards(node: Optional[dict]) -> Optional[int]:
    """How many accelerators the node should have: GFD's
    ``nvidia.com/gpu.count``, else the reference's chips-per-node label,
    else its catalog's chips per host for the node's TPU slice; None when
    no label set says (presence-only then)."""
    labels = _labels(node)
    for key in (consts.GFD_COUNT_LABEL, consts.TFD_CHIPS_PER_NODE_LABEL):
        count = _int_label(labels, key)
        if count is not None:
            return count
    acc_type, topology = _tpu_accelerator(labels)
    if not acc_type:
        return None
    per_host = TPU_ACCELERATORS.get(acc_type, ("", 4))[1]
    try:
        dims = [int(p) for p in topology.lower().split("x")] if topology else []
    except ValueError:
        dims = []
    in_slice = math.prod(dims) if dims and all(d > 0 for d in dims) else 0
    return min(in_slice, per_host) if in_slice else per_host


# every card label the port's discovery agents publish: each strips them
# all when a successful probe finds no card (the reference's TFD_LABELS)
CARD_LABELS = (consts.NFD_PRESENT_LABEL, *consts.GFD_LABELS)


def is_gpu_node(node: Optional[dict]) -> bool:
    """Whether the node has cards by its labels: Node Feature Discovery's
    ``pci-10de.present`` (the port's node discovery stamps it), or the
    platform's accelerator label naming an NVIDIA card (GKE's
    ``cloud.google.com/gke-accelerator: nvidia-...``)."""
    labels = _labels(node)
    return (labels.get(consts.NFD_PRESENT_LABEL) == "true"
            or labels.get(consts.GKE_GPU_ACCELERATOR_LABEL, "").startswith("nvidia-"))


def gfd_labels(inventory: dict) -> Dict[str, str]:
    """The labels feature discovery publishes from the card probe's
    inventory (``native/gpuinfo.probe``): GFD's product (the first named
    card's model, spaces as dashes), count, memory in MiB and driver
    version parts, each only where the probe knows it."""
    cards = inventory["cards"]
    labels = {consts.GFD_COUNT_LABEL: str(inventory["chip_count"])}
    model = next((c["model"] for c in cards if c.get("model")), "")
    if model:
        labels[consts.GFD_PRODUCT_LABEL] = model.replace(" ", "-")
    memory = next((c["memory_mib"] for c in cards if c.get("memory_mib")), 0)
    if memory:
        labels[consts.GFD_MEMORY_LABEL] = str(memory)
    parts = inventory["driver_version"].split(".")
    for key, part in zip((consts.GFD_DRIVER_MAJOR_LABEL, consts.GFD_DRIVER_MINOR_LABEL,
                          consts.GFD_DRIVER_REV_LABEL), parts if len(parts) > 1 else ()):
        labels[key] = part
    return labels
