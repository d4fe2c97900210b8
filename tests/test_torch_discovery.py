"""Node discovery and feature discovery on the card (``agents/node_discovery_agent.py``,
``agents/tfd_agent.py``) against the reference's (``tests/test_node_discovery.py``,
``tests/test_agents_cmd.py::TestTFDAgent``).

Both packages' agents run over the same simulated inventory
(``make_inventory``, which both probes read through their scan roots) on
their own copies of one node, and must take the same decisions: what
``apply_once`` returns, and whether they stamp, strip or leave the node.
The labels differ by design: the port stamps Node Feature Discovery's
``pci-10de.present`` and GFD's ``nvidia.com/*`` (the reference's
``tpu.google.com/*``), and the platform's label that owns a node's identity
is GKE's ``cloud.google.com/gke-accelerator`` (the reference's
``cloud.google.com/gke-tpu-accelerator``). Where the port differs in a
decision, a port-only test says why. Every comparison is exact.
"""

from __future__ import annotations

import pytest

import tests.test_torch_gpuinfo as inv
from tpu_operator import consts as ref_consts
from tpu_operator.agents.node_discovery_agent import NodeDiscoveryAgent as RefDiscovery
from tpu_operator.agents.tfd_agent import TFDAgent as RefTFD
from tpu_operator.kube.fake import FakeClient
from tpu_operator.kube.sim import make_bare_node, make_tpu_node
from tpu_operator_torch import consts
from tpu_operator_torch.agents import tfd_agent
from tpu_operator_torch.agents.node_discovery_agent import NodeDiscoveryAgent
from tpu_operator_torch.agents.tfd_agent import TFDAgent
from tpu_operator_torch.native import gpuinfo
from tpu_operator_torch.nodeinfo import CARD_LABELS, expected_cards, is_gpu_node, node_generation

NODE = "n0"
REF_LABELS = ref_consts.TFD_LABELS + (ref_consts.TORUS_COORDS_LABEL,)
PORT_LABELS = CARD_LABELS


def _roots(tmp_path, monkeypatch, minors):
    root = inv.make_inventory(tmp_path / "node", minors=minors)
    monkeypatch.setenv(gpuinfo.SCAN_ROOT_ENV, str(root))
    monkeypatch.setenv("TPUINFO_SCAN_ROOT", str(root))
    # the reference reads the TPU VM's env as identity: none on a card node
    for var in ("TPU_TOPOLOGY", "TPU_ACCELERATOR_TYPE", "TPU_WORKER_ID",
                "TPU_CHIPS_PER_HOST_BOUNDS"):
        monkeypatch.delenv(var, raising=False)
    return root


@pytest.fixture()
def cards(tmp_path, monkeypatch):
    return _roots(tmp_path, monkeypatch, range(4))


@pytest.fixture()
def empty(tmp_path, monkeypatch):
    return _roots(tmp_path, monkeypatch, [])


def ref_node(platform=False, labelled=False):
    if platform:
        node = make_tpu_node(NODE, "tpu-v5p-slice", "2x2x1")
    else:
        node = make_bare_node(NODE)
    if labelled:
        node["metadata"]["labels"].update({
            ref_consts.TFD_ACCELERATOR_TYPE_LABEL: "tpu-v5-lite-podslice",
            ref_consts.TFD_CHIPS_PER_NODE_LABEL: "4"})
    return node


def port_node(platform=False, labelled=False):
    node = make_bare_node(NODE)
    labels = node["metadata"]["labels"]
    if platform:
        labels[consts.GKE_GPU_ACCELERATOR_LABEL] = "nvidia-h100-80gb"
    if labelled:
        labels.update({consts.NFD_PRESENT_LABEL: "true", consts.GFD_COUNT_LABEL: "4",
                       consts.GFD_PRODUCT_LABEL: "NVIDIA-H100-80GB-HBM3"})
    return node


def run_both(ref_cls, port_cls, passes, platform=False, labelled=False, between=None):
    """Each package's agent over its own copy of the node: per pass,
    (apply_once, the agent's labels on the node). ``between`` runs before
    every pass after the first."""
    out = {}
    for pkg, cls, make, keys in (("reference", ref_cls, ref_node, REF_LABELS),
                                 ("port", port_cls, port_node, PORT_LABELS)):
        client = FakeClient()
        client.create(make(platform, labelled))
        agent = cls(client, NODE)
        got = []
        for i in range(passes):
            if i and between is not None:
                between(i)
            changed = agent.apply_once()
            labels = client.get("v1", "Node", NODE)["metadata"]["labels"]
            got.append((changed, {k: labels[k] for k in keys if k in labels}))
        out[pkg] = got
    return out["reference"], out["port"]


def decisions(run):
    """What a run decided, whatever the label names: changed, and whether
    any of the agent's labels are on the node."""
    return [(changed, bool(labels)) for changed, labels in run]


# --------------------------------------------------------------- node discovery


def test_probe_and_stamp(cards):
    ref, port = run_both(RefDiscovery, NodeDiscoveryAgent, 2)
    assert decisions(port) == decisions(ref) == [(True, True), (False, True)]
    assert ref[0][1][ref_consts.TFD_CHIPS_PER_NODE_LABEL] == "4"
    assert port[0][1] == {consts.NFD_PRESENT_LABEL: "true", consts.GFD_COUNT_LABEL: "4"}


def test_no_hardware_publishes_nothing(empty):
    ref, port = run_both(RefDiscovery, NodeDiscoveryAgent, 1)
    assert decisions(port) == decisions(ref) == [(False, False)]


def test_hardware_gone_strips_labels(empty):
    ref, port = run_both(RefDiscovery, NodeDiscoveryAgent, 1, labelled=True)
    assert decisions(port) == decisions(ref) == [(True, False)]


def test_probe_failure_never_strips(empty, monkeypatch):
    monkeypatch.setattr(RefDiscovery, "probe_chips", staticmethod(lambda: None))
    monkeypatch.setattr(NodeDiscoveryAgent, "probe_chips", staticmethod(lambda: None))
    ref, port = run_both(RefDiscovery, NodeDiscoveryAgent, 1, labelled=True)
    assert decisions(port) == decisions(ref) == [(False, True)]


def test_a_failed_probe_reads_as_indeterminate(tmp_path, monkeypatch):
    """Port only: the card probe raises on an unreadable device directory
    (the reference's probe cannot fail so); discovery reads None."""
    monkeypatch.setenv(gpuinfo.SCAN_ROOT_ENV, str(tmp_path / "absent"))
    assert NodeDiscoveryAgent.probe_chips() is None
    client = FakeClient()
    client.create(port_node(labelled=True))
    assert NodeDiscoveryAgent(client, NODE).apply_once() is False
    assert client.get("v1", "Node", NODE)["metadata"]["labels"][consts.NFD_PRESENT_LABEL] == "true"


def test_platform_node_gets_only_the_probed_count(cards):
    """The platform owns identity: only the directly probed count lands
    (the reference publishes no accelerator type there, the port no
    presence label)."""
    ref, port = run_both(RefDiscovery, NodeDiscoveryAgent, 2, platform=True)
    assert decisions(port) == decisions(ref) == [(True, True), (False, True)]
    assert ref[0][1] == {ref_consts.TFD_CHIPS_PER_NODE_LABEL: "4"}
    assert port[0][1] == {consts.GFD_COUNT_LABEL: "4"}


def test_platform_node_is_never_stripped(empty):
    ref, port = run_both(RefDiscovery, NodeDiscoveryAgent, 1, platform=True, labelled=True)
    assert decisions(port) == decisions(ref) == [(False, True)]


def test_cards_gone_then_back(cards):
    """Stamp, every card gone (strip), the cards back (stamp again); each
    package's run leaves the cards in place for the next."""

    def between(i):
        for minor in range(4):
            for name in (f"nvidia{minor}", f"accel{minor}"):
                if i == 1:
                    (cards / "dev" / name).unlink()
                else:
                    (cards / "dev" / name).touch()

    ref, port = run_both(RefDiscovery, NodeDiscoveryAgent, 3, between=between)
    assert decisions(port) == decisions(ref) == [(True, True), (True, False), (True, True)]


# ------------------------------------------------------------ feature discovery


def test_tfd_publishes_from_the_probe(cards):
    """Both publish on a labelled node; the reference derives from its
    discovery labels, the port from the probe."""
    ref, port = run_both(RefTFD, TFDAgent, 2, labelled=True)
    assert decisions(port) == decisions(ref) == [(True, True), (False, True)]
    assert port[0][1] == {
        consts.NFD_PRESENT_LABEL: "true", consts.GFD_COUNT_LABEL: "4",
        consts.GFD_PRODUCT_LABEL: "NVIDIA-H100-80GB-HBM3",
        consts.GFD_DRIVER_MAJOR_LABEL: "550", consts.GFD_DRIVER_MINOR_LABEL: "54",
        consts.GFD_DRIVER_REV_LABEL: "15"}


def test_tfd_removes_labels_when_the_cards_are_gone(empty):
    """No platform label and no card: both strip every card label,
    discovery's base labels included."""
    ref, port = run_both(RefTFD, TFDAgent, 1, labelled=True)
    assert decisions(port) == decisions(ref) == [(True, False)]


def test_tfd_probe_failure_changes_nothing(cards, monkeypatch):
    monkeypatch.setattr(RefTFD, "_probe_local_chips", staticmethod(lambda: None))
    monkeypatch.setattr(TFDAgent, "_probe", staticmethod(lambda: None))
    ref, port = run_both(RefTFD, TFDAgent, 1, labelled=True)
    assert decisions(port) == decisions(ref) == [(False, True)]


def test_tfd_probes_once_per_pass(cards, monkeypatch):
    calls = []
    real = gpuinfo.probe
    monkeypatch.setattr(tfd_agent.gpuinfo, "probe", lambda: calls.append(1) or real())
    client = FakeClient()
    client.create(port_node())
    assert TFDAgent(client, NODE).apply_once() is True
    assert calls == [1]


def test_tfd_leaves_a_platform_node_it_cannot_see(empty):
    """Port only: the reference publishes a TPU node's labels from the
    platform's labels even when its probe sees no chip; the port's labels
    come from the probe alone, so a platform-labelled node whose cards the
    probe cannot see is indeterminate and keeps its labels."""
    client = FakeClient()
    client.create(port_node(platform=True, labelled=True))
    assert TFDAgent(client, NODE).apply_once() is False
    labels = client.get("v1", "Node", NODE)["metadata"]["labels"]
    assert labels[consts.GFD_PRODUCT_LABEL] == "NVIDIA-H100-80GB-HBM3"


def test_missing_node_changes_nothing(cards):
    client = FakeClient()
    assert NodeDiscoveryAgent(client, NODE).apply_once() is False
    assert TFDAgent(client, NODE).apply_once() is False


# ---------------------------------------------- the port's readers of the labels


def test_node_identity_from_the_agents_own_labels(cards):
    """Discovery then feature discovery on an unlabelled node: the port's
    ``is_gpu_node``, ``node_generation`` and ``expected_cards`` read what its
    own agents published."""
    client = FakeClient()
    client.create(make_bare_node(NODE))
    assert not is_gpu_node(client.get("v1", "Node", NODE))
    assert NodeDiscoveryAgent(client, NODE).apply_once() is True
    node = client.get("v1", "Node", NODE)
    assert is_gpu_node(node) and expected_cards(node) == 4 and node_generation(node) == ""
    assert TFDAgent(client, NODE).apply_once() is True
    node = client.get("v1", "Node", NODE)
    assert node_generation(node) == "h100-sxm" and expected_cards(node) == 4
    # both again: nothing changes
    assert NodeDiscoveryAgent(client, NODE).apply_once() is False
    assert TFDAgent(client, NODE).apply_once() is False


@pytest.mark.parametrize("labels, want", [
    ({}, False), ({consts.NFD_PRESENT_LABEL: "true"}, True),
    ({consts.NFD_PRESENT_LABEL: "false"}, False),
    ({consts.GKE_GPU_ACCELERATOR_LABEL: "nvidia-h100-80gb"}, True),
    ({consts.GKE_GPU_ACCELERATOR_LABEL: "tpu-v5"}, False),
    ({consts.GFD_PRODUCT_LABEL: "NVIDIA-H100-80GB-HBM3"}, False),
])
def test_is_gpu_node(labels, want):
    node = make_bare_node(NODE, extra_labels=labels)
    assert is_gpu_node(node) is want
