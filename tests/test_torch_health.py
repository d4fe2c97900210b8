"""The health monitor on the card (``agents/health_monitor_agent.py``)
against the reference's.

Publication: both packages' agents, given the same card verdicts (their
``probe_chips`` replaced by one fake inventory), the same install marker
and plugin socket and the same Event recorder, must return the same and
publish the same label, per-card annotation, condition, Events and
verdicts file (the wall-clock stamps aside) over the reference's
``TestHealthMonitorAgent`` sequences. ``probe_chips`` itself reads
``/dev/nvidia<N>`` device nodes under a fake ``dev_root`` (the driver's
control nodes are not cards, nor are nodes the device cgroup refuses to
open), and the matmul burst runs the real chain on the CPU.
"""

from __future__ import annotations

import errno
import json
import os

import pytest

from tpu_operator import consts as ref_consts
from tpu_operator.agents.health_monitor_agent import HealthMonitorAgent as RefHealthAgent
from tpu_operator.kube.events import EventRecorder
from tpu_operator.kube.fake import FakeClient
from tpu_operator.kube.objects import new_object
from tpu_operator.kube.sim import make_tpu_node
from tpu_operator_torch import consts
from tpu_operator_torch.agents import health_monitor_agent as hma
from tpu_operator_torch.agents.health_monitor_agent import HealthMonitorAgent
from tpu_operator_torch.workloads import matmul_bench as tmb

NODE = "tpu-0"
HEALTHY, UNHEALTHY = "Healthy", "Unhealthy"


def surfaces(tmp_path, marker=True, socket=True):
    """An install dir with (or without) the ready marker and a socket dir
    with (or without) the plugin socket."""
    install, sockets = tmp_path / "install", tmp_path / "sockets"
    install.mkdir(exist_ok=True)
    sockets.mkdir(exist_ok=True)
    for path, present in ((install / consts.LIBTPU_CTR_READY_FILE, marker),
                          (sockets / hma.PLUGIN_SOCKET_NAME, socket)):
        if present:
            path.touch()
        elif path.exists():
            path.unlink()
    return str(install), str(sockets)


def published(store, health_dir):
    """What the agent published, its wall-clock stamps aside."""
    node = store.get("v1", "Node", NODE)
    annotations = dict(node["metadata"].get("annotations") or {})
    since = annotations.pop(consts.TPU_HEALTH_SINCE_ANNOTATION, None)
    conditions = [{k: v for k, v in c.items() if k != "lastTransitionTime"}
                  for c in node.get("status", {}).get("conditions", [])]
    events = sorted((e.get("type"), e.get("reason"), e.get("message"))
                    for e in store.list("v1", "Event"))
    path = os.path.join(health_dir, consts.HEALTH_VERDICTS_FILE)
    verdicts = None
    if os.path.exists(path):
        with open(path) as f:
            verdicts = json.load(f)
    return {"label": (node["metadata"].get("labels") or {}).get(consts.TPU_HEALTH_LABEL),
            "annotations": annotations, "since stamped": since is not None,
            "conditions": conditions, "events": events, "verdicts": verdicts}


def run_both(tmp_path, passes, node=None, expected_chips=None):
    """Each package's agent over its own copy of one node. ``passes`` is a
    list of (card verdicts or None for an indeterminate probe, marker
    present, socket present); each pass returns apply_once and what is
    published."""
    out = {}
    for pkg, cls in (("reference", RefHealthAgent), ("port", HealthMonitorAgent)):
        root = tmp_path / pkg
        root.mkdir()
        store = FakeClient()
        store.create(node or make_tpu_node(NODE, chips=4))
        health_dir = str(root / "health")
        recorder = EventRecorder(store, "", component="tpu-health-monitor")
        agent = cls(store, NODE, health_dir=health_dir, active_probes="off",
                    expected_chips=expected_chips, recorder=recorder)
        got = []
        for chips, marker, socket in passes:
            agent.install_dir, agent.socket_dir = surfaces(root, marker, socket)
            agent.probe_chips = lambda node=None, _chips=chips: (
                dict(_chips) if _chips is not None else None)
            got.append((agent.apply_once(), published(store, health_dir)))
        out[pkg] = got
    assert out["port"] == out["reference"]
    return out["port"]


def cards(n, missing=()):
    return {f"nvidia{i}": UNHEALTHY if i in missing else HEALTHY for i in range(n)}


PUBLICATION = {
    "a healthy node publishes everything; the steady state changes nothing": [
        (cards(4), True, True), (cards(4), True, True)],
    "a yanked card degrades with a per-card verdict": [
        (cards(4), True, True), (cards(4, missing=(2,)), True, True)],
    "recovery restores health with an event": [
        (cards(2), True, True), (cards(2, missing=(1,)), True, True), (cards(2), True, True)],
    "a missing install marker and plugin socket degrade": [(cards(2), False, False)],
    "an indeterminate probe changes nothing": [(cards(2), True, True), (None, True, True)],
    "a node born degraded gets an event": [(cards(4, missing=(0, 3)), True, True)],
    "no cards visible": [({}, True, True)],
}


@pytest.mark.parametrize("case", list(PUBLICATION))
def test_publication_equals_the_reference(tmp_path, case):
    got = run_both(tmp_path, PUBLICATION[case])
    changed, last = got[-1]
    first = got[0][1]
    if case.startswith("a healthy"):
        assert got[0][0] is True and changed is False
        assert first["label"] == consts.HEALTH_HEALTHY and first["events"] == []
        assert first["conditions"][0]["status"] == "True"
        assert first["verdicts"]["verdict"] == consts.HEALTH_HEALTHY
        assert json.loads(first["annotations"][consts.TPU_HEALTH_CHIPS_ANNOTATION]) == cards(4)
    if "yanked" in case:
        assert last["label"] == consts.HEALTH_DEGRADED
        assert "nvidia2" in last["conditions"][0]["message"]
        assert [e[1] for e in last["events"]] == ["TPUHealthDegraded"]
    if "recovery" in case:
        assert last["label"] == consts.HEALTH_HEALTHY
        assert sorted(e[1] for e in last["events"]) == ["TPUHealthDegraded", "TPUHealthRestored"]
    if "marker" in case:
        message = last["conditions"][0]["message"]
        assert "libtpu" in message and "socket" in message
    if "indeterminate" in case:
        assert changed is False and last == first


def test_the_keys_are_the_reference_keys():
    for name in ("TPU_HEALTH_LABEL", "HEALTH_HEALTHY", "HEALTH_DEGRADED",
                 "TPU_HEALTH_CHIPS_ANNOTATION", "TPU_HEALTH_SINCE_ANNOTATION",
                 "TPU_HEALTH_CONDITION", "HEALTH_DIR", "HEALTH_VERDICTS_FILE",
                 "LIBTPU_CTR_READY_FILE", "LIBTPU_INSTALL_DIR"):
        assert getattr(consts, name) == getattr(ref_consts, name), name
    from tpu_operator.agents.device_plugin_agent import PLUGIN_SOCKET_NAME

    assert hma.PLUGIN_SOCKET_NAME == PLUGIN_SOCKET_NAME


# ------------------------------------------------------------- probe_chips


def dev_root(tmp_path, names):
    root = tmp_path / "dev"
    root.mkdir()
    for name in names:
        (root / name).touch()
    return str(root)


@pytest.mark.parametrize("names, expected, want", [
    # the driver's control nodes are not cards
    (["nvidia0", "nvidia1", "nvidiactl", "nvidia-uvm", "nvidia-uvm-tools", "null"], 2,
     cards(2)),
    (["nvidia0", "nvidia1", "nvidiactl", "nvidia-uvm"], None, cards(2)),
    # a card short: named by the lowest absent index
    (["nvidia0", "nvidia1", "nvidiactl", "nvidia-uvm"], 3, cards(3, missing=(2,))),
    (["nvidia1", "nvidiactl"], 2, {"nvidia0": UNHEALTHY, "nvidia1": HEALTHY}),
    # a container sees the host's minors: two cards are two cards
    (["nvidia0", "nvidia5", "nvidiactl"], 2, {"nvidia0": HEALTHY, "nvidia5": HEALTHY}),
    (["nvidiactl", "nvidia-uvm"], 1, {"nvidia0": UNHEALTHY}),
    (["nvidiactl"], None, {}),
])
def test_probe_chips_reads_the_card_device_nodes(tmp_path, names, expected, want):
    agent = HealthMonitorAgent(None, NODE, dev_root=dev_root(tmp_path, names),
                               expected_chips=expected)
    assert agent.probe_chips() == want


@pytest.mark.parametrize("names, refused, expected, want", [
    # another container's card: its node shows but the device cgroup refuses it
    (["nvidia0", "nvidia7", "nvidiactl"], {"nvidia0": errno.EPERM}, 1, {"nvidia7": HEALTHY}),
    (["nvidia0", "nvidia7", "nvidiactl"], {"nvidia0": errno.EACCES}, None,
     {"nvidia7": HEALTHY}),
    # a foreign node hides no lost card: the shortfall takes an index with no node
    (["nvidia0", "nvidiactl"], {"nvidia0": errno.EPERM}, 1, {"nvidia1": UNHEALTHY}),
    (["nvidia0", "nvidia7"], {"nvidia0": errno.EPERM}, 2,
     {"nvidia7": HEALTHY, "nvidia1": UNHEALTHY}),
    # this container's card whose node fails to open otherwise has gone bad
    (["nvidia0", "nvidia7"], {"nvidia0": errno.EPERM, "nvidia7": errno.ENODEV}, 1,
     {"nvidia7": UNHEALTHY}),
])
def test_probe_chips_counts_only_the_nodes_it_may_open(tmp_path, monkeypatch, names, refused,
                                                       expected, want):
    root = dev_root(tmp_path, names)
    real_open = os.open

    def fake_open(path, flags, *args):
        err = refused.get(os.path.basename(path))
        if err is not None:
            raise OSError(err, os.strerror(err), path)
        return real_open(path, flags, *args)

    monkeypatch.setattr(os, "open", fake_open)
    agent = HealthMonitorAgent(None, NODE, dev_root=root, expected_chips=expected)
    assert agent.probe_chips() == want


def test_probe_chips_unreadable_root_is_indeterminate(tmp_path):
    agent = HealthMonitorAgent(None, NODE, dev_root=str(tmp_path / "absent"))
    assert agent.probe_chips() is None and agent.probe() is None


def test_expected_cards_from_the_gfd_count(tmp_path):
    store = FakeClient()
    store.create(new_object("v1", "Node", NODE, labels={
        consts.GFD_PRODUCT_LABEL: "NVIDIA-H100-80GB-HBM3", consts.GFD_COUNT_LABEL: "2"},
        status={"allocatable": {consts.GPU_RESOURCE_NAME: "8"}}))
    install, sockets = surfaces(tmp_path)
    agent = HealthMonitorAgent(store, NODE, install_dir=install, socket_dir=sockets,
                               health_dir=str(tmp_path / "health"), active_probes="off",
                               dev_root=dev_root(tmp_path, ["nvidia0", "nvidiactl"]))
    # the count label, not the (time-sliced) allocatable
    assert agent.expected_chips() == 2
    assert agent.apply_once() is True
    node = store.get("v1", "Node", NODE)
    assert node["metadata"]["labels"][consts.TPU_HEALTH_LABEL] == consts.HEALTH_DEGRADED
    assert json.loads(node["metadata"]["annotations"][consts.TPU_HEALTH_CHIPS_ANNOTATION]) == {
        "nvidia0": HEALTHY, "nvidia1": UNHEALTHY}


# ------------------------------------------------------------ the matmul burst


def test_matmul_burst_on_the_cpu(tmp_path):
    agent = HealthMonitorAgent(None, NODE, active_probes="on", device="cpu")
    assert agent.probe_matmul() is True


@pytest.mark.parametrize("mode, want", [("on", False), ("auto", None), ("off", None)])
def test_matmul_burst_gating(monkeypatch, mode, want):
    calls = []

    def boom(size, iters, device=None):
        calls.append((size, iters, device))
        raise RuntimeError("card busy")

    monkeypatch.setattr(tmb, "matmul_tflops", boom)
    agent = HealthMonitorAgent(None, NODE, active_probes=mode, device="cpu")
    assert agent.probe_matmul() is want
    assert calls == ([] if mode == "off" else [(256, 2, "cpu")])


def test_a_failed_burst_degrades_in_on_mode(tmp_path, monkeypatch):
    monkeypatch.setattr(tmb, "matmul_tflops", lambda size, iters, device=None: {"tflops": 0.0})
    install, sockets = surfaces(tmp_path)
    agent = HealthMonitorAgent(None, NODE, install_dir=install, socket_dir=sockets,
                               health_dir=str(tmp_path / "health"), active_probes="on",
                               dev_root=dev_root(tmp_path, ["nvidia0"]), device="cpu")
    report = agent.probe()
    assert report["verdict"] == consts.HEALTH_DEGRADED
    assert report["reasons"] == ["matmul sanity probe failed"]


def test_no_cuda_is_no_cpu_fallback(monkeypatch):
    """The burst runs on the card: without CUDA, ``on`` mode reads a
    failure instead of bursting the CPU."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    assert HealthMonitorAgent(None, NODE, active_probes="on").probe_matmul() is False


def test_active_probes_must_be_auto_on_or_off():
    with pytest.raises(ValueError, match="auto/on/off"):
        HealthMonitorAgent(None, NODE, active_probes="always")


def test_verdicts_file_is_written_without_a_client(tmp_path):
    install, sockets = surfaces(tmp_path)
    health = tmp_path / "health"
    agent = HealthMonitorAgent(None, NODE, install_dir=install, socket_dir=sockets,
                               health_dir=str(health), active_probes="off",
                               dev_root=dev_root(tmp_path, ["nvidia0"]))
    assert agent.apply_once() is False
    verdicts = json.loads((health / consts.HEALTH_VERDICTS_FILE).read_text())
    assert verdicts == {"verdict": consts.HEALTH_HEALTHY, "chips": {"nvidia0": HEALTHY},
                        "reasons": []}
    assert [p.name for p in health.iterdir()] == [consts.HEALTH_VERDICTS_FILE]
