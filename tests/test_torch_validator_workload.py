"""The validator's ``plugin`` and ``workload`` components on the card
against the reference's (``validator/main.py``).

``workload_pod`` is the reference's spec but for three keys: the limit
and the toleration name ``nvidia.com/gpu`` and the command runs the
port's ``workload_entry``. ``validate_workload`` and ``validate_plugin``
run over one fake cluster in both packages, a thread playing the kubelet
that moves the pod to its final phase, and must give the same result,
the same pod and the same cleanup.
"""

from __future__ import annotations

import copy
import json
import threading
import time

import pytest

from tpu_operator import consts as ref_consts
from tpu_operator.kube.fake import FakeClient
from tpu_operator.kube.objects import new_object
from tpu_operator.validator import main as ref_main
from tpu_operator_torch import consts
from tpu_operator_torch.validator import main as vmain
from tpu_operator_torch.validator import status as status_files
from tpu_operator_torch.validator import workload_entry

NS = "tpu-operator"
MAINS = {"reference": ref_main, "port": vmain}


def contexts(pkg, **fields):
    return MAINS[pkg].Context(**fields)


CONTEXTS = {
    "defaults": {},
    "named node": {"node_name": "h100-0", "namespace": "ops", "validator_image": "img:1"},
    "expected cards and a floor": {"node_name": "h100-0", "expected_chips": 8,
                                   "min_tflops": 470.0},
    "a zero floor": {"expected_chips": 1, "min_tflops": 0.0},
}


@pytest.mark.parametrize("case", list(CONTEXTS))
def test_workload_pod_is_the_reference_spec_for_a_card(case):
    want = ref_main.workload_pod(contexts("reference", **CONTEXTS[case]))
    got = vmain.workload_pod(contexts("port", **CONTEXTS[case]))
    # the three keys that name the card and the port
    container = want["spec"]["containers"][0]
    container["resources"]["limits"] = {
        consts.GPU_RESOURCE_NAME: container["resources"]["limits"].pop(
            ref_consts.TPU_RESOURCE_NAME)}
    assert want["spec"]["tolerations"][0]["key"] == ref_consts.TPU_RESOURCE_NAME
    want["spec"]["tolerations"][0]["key"] = consts.GPU_RESOURCE_NAME
    assert container["command"] == ["python", "-m", "tpu_operator.validator.workload_entry"]
    container["command"] = ["python", "-m", "tpu_operator_torch.validator.workload_entry"]
    assert got == want
    env = {e["name"]: e["value"] for e in got["spec"]["containers"][0]["env"]}
    assert env["COMPONENT"] == "smoke"
    assert got["spec"]["tolerations"][1]["key"] == "node.kubernetes.io/unschedulable"


class Kubelet(threading.Thread):
    """Moves the workload pod, once created, to ``phase`` (None: never); a
    stale pod of an earlier attempt it leaves alone."""

    def __init__(self, store, name, phase):
        super().__init__(daemon=True)
        self.store, self.name, self.phase = store, name, phase
        self.seen = None
        self.done = threading.Event()

    def run(self):
        deadline = time.monotonic() + 10
        while not self.done.is_set() and time.monotonic() < deadline:
            pod = self.store.get_or_none("v1", "Pod", self.name, NS)
            stale = "stale" in (pod or {}).get("metadata", {}).get("labels", {})
            if pod is not None and not stale and self.seen is None:
                self.seen = copy.deepcopy(pod)
                if self.phase:
                    self.store.patch_status("v1", "Pod", self.name,
                                            {"status": {"phase": self.phase}}, NS)
            time.sleep(0.005)


def run_workload(pkg, phase, stale=False, tmp_path=None):
    store = FakeClient()
    ctx = contexts(pkg, client=store, node_name="h100-0", namespace=NS, retry_interval=0.01,
                   pod_wait_retries=40, expected_chips=1,
                   validation_dir=str(tmp_path / pkg))
    name = MAINS[pkg].workload_pod(ctx)["metadata"]["name"]
    if stale:
        store.create(new_object("v1", "Pod", name, NS, labels={"stale": "1"},
                                status={"phase": "Failed"}))
    kubelet = Kubelet(store, name, phase)
    kubelet.start()
    try:
        outcome = MAINS[pkg].run_component("workload", ctx, max_attempts=1)
    except RuntimeError as e:
        outcome = f"RuntimeError: {e}"
    finally:
        kubelet.done.set()
        kubelet.join(10)
    ready = status_files.read_status(consts.WORKLOAD_READY_FILE, ctx.validation_dir)
    return {"outcome": outcome, "ready": ready,
            "left": store.get_or_none("v1", "Pod", name, NS),
            "scheduled": (kubelet.seen or {}).get("spec", {}).get("nodeSelector")}


@pytest.mark.parametrize("phase, stale", [("Succeeded", False), ("Failed", False),
                                          ("Succeeded", True), (None, False)])
def test_validate_workload_equals_the_reference(tmp_path, phase, stale):
    ref = run_workload("reference", phase, stale, tmp_path)
    got = run_workload("port", phase, stale, tmp_path)
    assert got == ref
    assert got["left"] is None  # the pod is deleted whatever the outcome
    assert got["scheduled"] == {"kubernetes.io/hostname": "h100-0"}
    if phase == "Succeeded":
        want = {"pod": "tpu-workload-validation-h100-0", "phase": "Succeeded"}
        assert got["outcome"] == want and got["ready"] == want
    else:
        assert got["outcome"].startswith("RuntimeError") and got["ready"] is None
        assert ("failed" if phase else "did not succeed in time") in got["outcome"]


def test_validate_workload_needs_a_client():
    with pytest.raises(RuntimeError, match="requires a kube client"):
        vmain.validate_workload(vmain.Context())


def _card_node(resource, count):
    return new_object("v1", "Node", "h100-0", status={"allocatable": {resource: count}})


@pytest.mark.parametrize("resource, count, want", [
    (consts.GPU_RESOURCE_NAME, "1", {"resource": "nvidia.com/gpu", "chips": 1}),
    (consts.GPU_RESOURCE_NAME, "8", {"resource": "nvidia.com/gpu", "chips": 8}),
    (consts.GPU_RESOURCE_NAME, "0", None),
    (ref_consts.TPU_RESOURCE_NAME, "4", None),  # a TPU's resource is not a card
])
def test_validate_plugin_polls_the_card_resource(tmp_path, resource, count, want):
    store = FakeClient()
    store.create(_card_node(resource, count))
    ctx = vmain.Context(client=store, node_name="h100-0", retry_interval=0.001,
                        resource_poll_retries=3, validation_dir=str(tmp_path))
    if want is None:
        with pytest.raises(RuntimeError, match="nvidia.com/gpu never became allocatable"):
            vmain.run_component("plugin", ctx, max_attempts=1)
        assert status_files.read_status(consts.PLUGIN_READY_FILE, str(tmp_path)) is None
        return
    assert vmain.run_component("plugin", ctx, max_attempts=1) == want
    assert status_files.read_status(consts.PLUGIN_READY_FILE, str(tmp_path)) == want
    # the reference's component on the same node and its own resource
    ref_store = FakeClient()
    ref_store.create(_card_node(ref_consts.TPU_RESOURCE_NAME, count))
    ref_ctx = ref_main.Context(client=ref_store, node_name="h100-0", retry_interval=0.001,
                               resource_poll_retries=3)
    assert ref_main.validate_plugin(ref_ctx) == dict(want, resource=ref_consts.TPU_RESOURCE_NAME)


def test_validate_plugin_needs_a_client_and_a_node():
    with pytest.raises(RuntimeError, match="requires a kube client and NODE_NAME"):
        vmain.validate_plugin(vmain.Context(client=FakeClient()))


def test_status_files_are_the_reference_names():
    for component in ("plugin", "workload"):
        assert vmain.COMPONENTS[component][1] == ref_main.COMPONENTS[component][1]
    assert (consts.PLUGIN_READY_FILE, consts.WORKLOAD_READY_FILE) == (
        ref_consts.PLUGIN_READY_FILE, ref_consts.WORKLOAD_READY_FILE)


def test_context_from_env(monkeypatch):
    monkeypatch.setenv("NODE_NAME", "h100-0")
    monkeypatch.setenv("OPERATOR_NAMESPACE", "ops")
    monkeypatch.setenv("VALIDATOR_IMAGE", "img:2")
    client = FakeClient()
    got = vmain.Context.from_env(client=client)
    want = ref_main.Context.from_env(client=client)
    for field in ("client", "node_name", "namespace", "validator_image",
                  "resource_poll_retries", "pod_wait_retries", "retry_interval"):
        assert getattr(got, field) == getattr(want, field), field


def test_main_builds_no_client_outside_a_cluster(monkeypatch):
    """Outside a pod there is no apiserver to build a client for: the
    workload component then fails (and retries), as the reference's."""
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    seen = []

    def fake_run(name, ctx, max_attempts=None):
        seen.append((name, ctx.client))
        return {}

    monkeypatch.setattr(vmain, "run_component", fake_run)
    monkeypatch.setenv("COMPONENT", "workload")
    assert vmain.main() == 0 and seen == [("workload", None)]


def test_main_builds_the_in_cluster_client(monkeypatch, tmp_path):
    from tpu_operator_torch import kube

    monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "10.0.0.1")
    monkeypatch.setattr(kube, "CA_PATH", None)
    seen = []
    monkeypatch.setattr(vmain, "run_component",
                        lambda name, ctx, max_attempts=None: seen.append(ctx.client) or {})
    monkeypatch.setenv("COMPONENT", "plugin")
    assert vmain.main() == 0
    assert isinstance(seen[0], kube.Client) and seen[0].base_url == "https://10.0.0.1:443"


def test_workload_entry_ignores_min_tflops_as_the_reference(capsys, monkeypatch):
    """The pod's MIN_TFLOPS is in its env, but neither package's entry
    reads it: a floor no machine passes still exits 0."""
    monkeypatch.delenv("EXPECTED_CHIPS", raising=False)
    monkeypatch.setenv("MIN_TFLOPS", "1e12")
    assert workload_entry.main(device="cpu") == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["ok"] is True
    from tpu_operator.validator import workload_entry as ref_entry

    assert ref_entry.main() == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["ok"] is True
