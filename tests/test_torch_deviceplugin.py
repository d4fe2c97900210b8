"""The device plugin on the card (``agents/device_plugin_agent.py``) against
the reference's (``tests/test_deviceplugin_webhook.py``'s device plugin
classes).

Both plugins see the same simulated inventory (``make_inventory``: four
cards as ``/dev/nvidia<i>`` for the port and ``/dev/accel<i>`` for the
reference) and the same stub kubelet. Where the port differs, it is the
card's counterpart and the test says so:

- device ids are the card nodes' names (``nvidia<i>`` for ``accel<i>``);
- the resource is ``nvidia.com/gpu`` (the reference's ``google.com/tpu``);
- ``Allocate`` injects ``/dev/nvidia<i>`` plus ``/dev/nvidiactl`` and
  ``/dev/nvidia-uvm``, and names the cards by UUID in
  ``CUDA_VISIBLE_DEVICES`` and ``NVIDIA_VISIBLE_DEVICES`` (the reference
  names chip indices in ``TPU_VISIBLE_CHIPS``), with ``LD_LIBRARY_PATH`` the
  install dir (the reference's ``TPU_LIBRARY_PATH``).

Inventories, health transitions and preferred allocations must be equal
under that renaming; nothing is floating-point, so every comparison is
exact. Every server is stopped and every socket lives under ``tmp_path``.
"""

from __future__ import annotations

import errno
import json
import os
import threading
import time

import grpc
import pytest

import tests.test_torch_gpuinfo as inv
from tpu_operator import consts as ref_consts
from tpu_operator.agents import device_plugin_agent as ref_dp
from tpu_operator.kube.fake import FakeClient
from tpu_operator.kube.objects import new_object
from tpu_operator.kube.sim import StubKubelet, make_tpu_node
from tpu_operator_torch import consts
from tpu_operator_torch.agents import device_plugin_agent as dp
from tpu_operator_torch.agents.dpapi import deviceplugin_pb2 as pb

REF_TO_PORT = {f"accel{i}": f"nvidia{i}" for i in range(16)}


def port_ids(ids):
    """The reference's device ids in the port's naming."""
    return [REF_TO_PORT[i.split("-rep")[0]] + (i[len(i.split("-rep")[0]):]) for i in ids]


def _scan(tmp_path, monkeypatch, minors):
    root = inv.make_inventory(tmp_path / "n", minors=minors)
    monkeypatch.setenv("GPUINFO_SCAN_ROOT", str(root))
    monkeypatch.setenv("TPUINFO_SCAN_ROOT", str(root))
    monkeypatch.delenv("TPU_CHIPS_PER_HOST_BOUNDS", raising=False)
    monkeypatch.delenv("HEALTH_VERDICTS_TTL", raising=False)
    return root


@pytest.fixture()
def node(tmp_path, monkeypatch):
    """Four cards."""
    return _scan(tmp_path, monkeypatch, range(4))


@pytest.fixture()
def bare(tmp_path, monkeypatch):
    """No card: the preferred-allocation cases' coordinates then come from
    their bounds alone, as in the reference's tests."""
    return _scan(tmp_path, monkeypatch, [])


def plugins(tmp_path, devices=4, **kwargs):
    """(reference plugin, port plugin) on their own socket dirs."""
    ref = ref_dp.TPUDevicePlugin(socket_dir=str(tmp_path / "r"),
                                 devices=[f"/dev/accel{i}" for i in range(devices)],
                                 health_dir=str(tmp_path / "health"), **kwargs)
    port = dp.GPUDevicePlugin(socket_dir=str(tmp_path / "p"), install_dir=str(tmp_path / "inst"),
                              health_dir=str(tmp_path / "health"), **kwargs)
    return ref, port


def dial(plugin):
    channel = grpc.insecure_channel(f"unix://{plugin.socket_path}")
    law = channel.unary_stream("/v1beta1.DevicePlugin/ListAndWatch",
                               request_serializer=lambda m: m.SerializeToString(),
                               response_deserializer=pb.ListAndWatchResponse.FromString)
    allocate = channel.unary_unary("/v1beta1.DevicePlugin/Allocate",
                                   request_serializer=lambda m: m.SerializeToString(),
                                   response_deserializer=pb.AllocateResponse.FromString)
    return channel, law, allocate


def listing(response):
    return [(d.ID, d.health) for d in response.devices]


def allocate_request(*ids):
    return pb.AllocateRequest(container_requests=[pb.ContainerAllocateRequest(devicesIDs=ids)])


# ---------------------------------------------------------- the gRPC round trip


def test_full_round_trip(node, tmp_path):
    ref, port = plugins(tmp_path)
    got = {}
    for name, plugin in (("reference", ref), ("port", port)):
        kubelet_sock = str(tmp_path / f"k-{name}.sock")
        assert len(kubelet_sock) < 100
        kubelet = StubKubelet(kubelet_sock)
        channel = None
        try:
            plugin.serve()
            plugin.register(kubelet_sock)
            assert kubelet.event.wait(5)
            channel, law, allocate = dial(plugin)
            first = next(law(pb.Empty()))
            ids = [d.ID for d in first.devices]
            resp = allocate(allocate_request(ids[0], ids[2]))
            got[name] = (kubelet.requests[0], first, resp.container_responses[0])
        finally:
            if channel is not None:
                channel.close()
            plugin.stop()
            kubelet.stop()
    (rreq, rfirst, rctr), (preq, pfirst, pctr) = got["reference"], got["port"]
    assert (preq.version, preq.endpoint) == (rreq.version, rreq.endpoint) == (
        dp.API_VERSION, consts.PLUGIN_SOCKET_NAME)
    assert rreq.resource_name == ref_consts.TPU_RESOURCE_NAME
    assert preq.resource_name == consts.GPU_RESOURCE_NAME == "nvidia.com/gpu"
    # the same inventory, renamed
    assert listing(pfirst) == [(i, h) for i, h in zip(port_ids([d.ID for d in rfirst.devices]),
                                                       [d.health for d in rfirst.devices])]
    assert listing(pfirst) == [(f"nvidia{i}", "Healthy") for i in range(4)]
    # Allocate: the card's counterpart of the reference's response
    assert [d.host_path for d in rctr.devices] == ["/dev/accel0", "/dev/accel2"]
    assert rctr.envs["TPU_VISIBLE_CHIPS"] == "0,2"
    assert [(d.host_path, d.container_path, d.permissions) for d in pctr.devices] == [
        (p, p, "rw") for p in ("/dev/nvidia0", "/dev/nvidia2", "/dev/nvidiactl",
                               "/dev/nvidia-uvm")]
    uuids = f"{inv.uuid_of(0)},{inv.uuid_of(2)}"
    assert dict(pctr.envs) == {"CUDA_VISIBLE_DEVICES": uuids, "NVIDIA_VISIBLE_DEVICES": uuids,
                               "LD_LIBRARY_PATH": port.install_dir}
    (mount,) = pctr.mounts
    assert (mount.host_path, mount.container_path, mount.read_only) == (
        port.install_dir, port.install_dir, True)


def test_inventory_change_republished(node, tmp_path):
    """The reference's case: a stream sees one card, then two. The port's
    inventory grows on the probe's root, the reference's by override."""
    for name in ("nvidia1", "nvidia2", "nvidia3", "accel1", "accel2", "accel3"):
        (node / "dev" / name).unlink()
    ref, port = plugins(tmp_path, devices=1)
    seen = {}
    for name, plugin in (("reference", ref), ("port", port)):
        channel = None
        try:
            plugin.serve()
            channel, law, _ = dial(plugin)
            stream = law(pb.Empty())
            first = next(stream)
            if plugin is ref:
                plugin._devices_override = ["/dev/accel0", "/dev/accel1"]
            else:
                (node / "dev" / "nvidia1").touch()
            plugin._publish(plugin.discover())
            seen[name] = [listing(first), listing(next(stream))]
        finally:
            if channel is not None:
                channel.close()
            plugin.stop()
    assert seen["port"] == [[(port_ids([i])[0], h) for i, h in step] for step in seen["reference"]]
    assert [len(step) for step in seen["port"]] == [1, 2]


def test_health_loop_re_registers_when_the_socket_vanishes(node, tmp_path):
    """A kubelet restart wipes the device-plugin directory: both plugins
    serve and register again on their next tick."""
    ref, port = plugins(tmp_path, health_check_interval=0.05)
    counts = {}
    for name, plugin in (("reference", ref), ("port", port)):
        kubelet_sock = str(tmp_path / f"k-{name}.sock")
        kubelet = StubKubelet(kubelet_sock)
        loop = threading.Thread(target=plugin.health_loop, args=(kubelet_sock,), daemon=True)
        try:
            plugin.serve()
            plugin.register(kubelet_sock)
            loop.start()
            os.remove(plugin.socket_path)
            deadline = time.monotonic() + 10
            while len(kubelet.requests) < 2 and time.monotonic() < deadline:
                time.sleep(0.02)
            counts[name] = (len(kubelet.requests) >= 2, os.path.exists(plugin.socket_path))
        finally:
            plugin.stop()
            loop.join(10)
            kubelet.stop()
        assert not loop.is_alive()
    assert counts["port"] == counts["reference"] == (True, True)


def test_allocate_refuses_a_card_it_cannot_name(node, tmp_path):
    _, port = plugins(tmp_path)
    for name in ("nvidia9",):
        with pytest.raises(RuntimeError, match="no card with a UUID"):
            port.Allocate(allocate_request(name), None)
    # a card the kernel module does not describe has no UUID to name it by
    (node / "dev" / "nvidia7").touch()
    with pytest.raises(RuntimeError, match=r"\['nvidia7'\]"):
        port.Allocate(allocate_request("nvidia0", "nvidia7"), None)
    try:
        port.serve()
        channel, _, allocate = dial(port)
        with pytest.raises(grpc.RpcError):
            allocate(allocate_request("nvidia7"))
        channel.close()
    finally:
        port.stop()


# ---------------------------------------------------------------- health


def write_verdicts(tmp_path, chips, age=0.0):
    health = tmp_path / "health"
    health.mkdir(exist_ok=True)
    path = health / consts.HEALTH_VERDICTS_FILE
    path.write_text(json.dumps({"verdict": "x", "chips": chips}))
    if age:
        stamp = time.time() - age
        os.utime(path, (stamp, stamp))
    return path


def test_health_transitions_equal_the_reference(node, tmp_path, monkeypatch):
    """Yank card 2, restore it, then let the health monitor's verdicts mark
    card 1 (fresh, stale, torn): both plugins publish the same maps."""
    ref, port = plugins(tmp_path)
    steps = []

    def tick(label):
        r, p = ref.health_tick(), port.health_tick()
        rmap = {REF_TO_PORT[k]: v for k, v in ref._last_health.items()}
        assert (p, port._last_health) == (r, rmap), label
        steps.append((label, p, dict(port._last_health)))

    tick("first")
    tick("steady")
    ref._devices_override = [f"/dev/accel{i}" for i in (0, 1, 3)]
    (node / "dev" / "nvidia2").unlink()
    tick("yanked")
    ref._devices_override = [f"/dev/accel{i}" for i in range(4)]
    (node / "dev" / "nvidia2").touch()
    tick("restored")
    path = write_verdicts(tmp_path, {"nvidia1": "Unhealthy", "accel1": "Unhealthy"})
    tick("verdict")
    path = write_verdicts(tmp_path, {"nvidia1": "Unhealthy", "accel1": "Unhealthy"},
                          age=ref_dp.TPUDevicePlugin.VERDICTS_TTL_SECONDS + 60)
    tick("stale verdict")
    path.write_text('{"chips": ')
    tick("torn verdict")
    path.write_text(json.dumps({"chips": ["nvidia1"]}))
    tick("malformed verdict")
    healthy = {f"nvidia{i}": "Healthy" for i in range(4)}
    assert steps == [
        ("first", True, healthy), ("steady", False, healthy),
        ("yanked", True, dict(healthy, nvidia2="Unhealthy")), ("restored", True, healthy),
        ("verdict", True, dict(healthy, nvidia1="Unhealthy")), ("stale verdict", True, healthy),
        ("torn verdict", False, healthy), ("malformed verdict", False, healthy)]


def test_a_card_whose_node_fails_is_unhealthy_and_a_failed_probe_keeps_the_map(
        node, tmp_path, monkeypatch):
    """Port only: the probe's failed cards (a node that fails to open for
    another reason than a refusal) read Unhealthy, another container's
    refused node is no device at all, and a failed probe changes nothing."""
    inv.refuse(monkeypatch, {"nvidia3": errno.ENODEV, "nvidia0": errno.EPERM})
    _, port = plugins(tmp_path)
    assert port.health_tick() is True
    assert port._last_health == {"nvidia1": "Healthy", "nvidia2": "Healthy",
                                 "nvidia3": "Unhealthy"}
    monkeypatch.setenv("GPUINFO_SCAN_ROOT", str(tmp_path / "absent"))
    assert port.health_tick() is False and port.current_health() == port._last_health


# --------------------------------------------------- config and replicas


def seed_configmap(client, namespace="tpu-operator"):
    client.create(new_object("v1", "ConfigMap", "plugin-config", namespace, data={
        "default": "replicas: 1\n", "time-shared": "replicas: 4\n", "broken": "{not yaml"}))


@pytest.mark.parametrize("label, default, configmap, want", [
    (None, "default", "plugin-config", {"replicas": 1}),
    ("time-shared", "default", "plugin-config", {"replicas": 4}),
    ("broken", "", "plugin-config", {}),
    ("missing", "default", "plugin-config", {}),
    (None, "", "plugin-config", {}),
    (None, "default", "absent", {}),
    (None, "default", "", {}),
])
def test_plugin_config_equals_the_reference(label, default, configmap, want):
    client = FakeClient()
    seed_configmap(client)
    extra = {ref_dp.PLUGIN_CONFIG_LABEL: label} if label else None
    client.create(make_tpu_node("n0", extra_labels=extra))
    got = dp.select_plugin_config(client, "n0", configmap, "tpu-operator", default=default)
    assert got == ref_dp.select_plugin_config(client, "n0", configmap, "tpu-operator",
                                              default=default) == want
    assert dp.PLUGIN_CONFIG_LABEL == ref_dp.PLUGIN_CONFIG_LABEL


def test_replicas_advertise_shared_cards(node, tmp_path):
    ref, port = plugins(tmp_path, devices=2, config={"replicas": 2})
    for name in ("nvidia2", "nvidia3"):
        (node / "dev" / name).unlink()
    rlist = ref._device_list(ref.discover())
    plist = port._device_list(port.discover())
    assert [d.ID for d in plist.devices] == port_ids([d.ID for d in rlist.devices]) == [
        "nvidia0-rep0", "nvidia0-rep1", "nvidia1-rep0", "nvidia1-rep1"]
    # two replicas of one card inject ONE card node and name one card
    ralloc = ref.Allocate(allocate_request("accel0-rep0", "accel0-rep1"), None)
    palloc = port.Allocate(allocate_request("nvidia0-rep0", "nvidia0-rep1"), None)
    rctr, pctr = ralloc.container_responses[0], palloc.container_responses[0]
    assert [d.host_path for d in rctr.devices] == ["/dev/accel0"]
    assert rctr.envs["TPU_VISIBLE_CHIPS"] == "0"
    assert [d.host_path for d in pctr.devices] == ["/dev/nvidia0", *dp.CONTROL_DEVICES]
    assert pctr.envs["CUDA_VISIBLE_DEVICES"] == inv.uuid_of(0)


# ------------------------------------------------------ preferred allocation


PREFERRED = {
    # the reference's TestPreferredAllocation, TestTorusPreferredAllocation
    # and TestPreferredAllocationContract requests: (bounds, available,
    # must include, size)
    "contiguous window": (None, [0, 3, 4, 5, 7], [], 3),
    "must include": (None, [0, 1, 2, 6, 7], [7], 2),
    "2x2 face beats an index line": ("4,4,1", list(range(6)), [], 4),
    "vertical adjacency": ("4,2,1", [0, 3, 4], [], 2),
    "fallback keeps the musts": (None, [0, 1, 6, 7], [0, 7], 2),
    "everything": (None, [2, 1, 0], [], 0),
    "musts only": (None, [], [5], 1),
    "too many musts": ("2,2,1", [0, 1, 2], [0, 1, 2], 2),
    "over the combination cap": (None, list(range(24)), [], 12),
}


@pytest.mark.parametrize("case", list(PREFERRED))
def test_preferred_allocation_equals_the_reference(bare, tmp_path, monkeypatch, case):
    bounds, available, must, size = PREFERRED[case]
    if bounds:
        monkeypatch.setenv("TPU_CHIPS_PER_HOST_BOUNDS", bounds)
    ref, port = plugins(tmp_path, devices=0)

    def ask(plugin, prefix):
        req = pb.PreferredAllocationRequest(container_requests=[
            pb.ContainerPreferredAllocationRequest(
                available_deviceIDs=[f"{prefix}{i}" for i in available],
                must_include_deviceIDs=[f"{prefix}{i}" for i in must], allocation_size=size)])
        return list(plugin.GetPreferredAllocation(req, None).container_responses[0].deviceIDs)

    want = ask(ref, "accel")
    assert ask(port, "nvidia") == port_ids(want)
    picks = sorted(int(i[len("accel"):]) for i in want)
    if case == "contiguous window":
        assert picks == [3, 4, 5]
    if case == "2x2 face beats an index line":
        assert picks == [0, 1, 4, 5]
    if case == "vertical adjacency":
        assert picks == [0, 4]
    if case in ("must include", "fallback keeps the musts"):
        assert set(must) <= set(picks)


def test_preferred_allocation_with_replicas(bare, tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_CHIPS_PER_HOST_BOUNDS", "2,2,1")
    ref, port = plugins(tmp_path, devices=0)

    def ask(plugin, ids, must):
        req = pb.PreferredAllocationRequest(container_requests=[
            pb.ContainerPreferredAllocationRequest(available_deviceIDs=ids,
                                                   must_include_deviceIDs=must,
                                                   allocation_size=2)])
        return list(plugin.GetPreferredAllocation(req, None).container_responses[0].deviceIDs)

    want = ask(ref, ["accel0-rep0", "accel1-rep0", "accel3-rep1"], ["accel3-rep1"])
    got = ask(port, ["nvidia0-rep0", "nvidia1-rep0", "nvidia3-rep1"], ["nvidia3-rep1"])
    assert got == port_ids(want) and sorted(got) == ["nvidia1-rep0", "nvidia3-rep1"]


def test_options_advertise_preferred_allocation(tmp_path):
    _, port = plugins(tmp_path)
    opts = port.GetDevicePluginOptions(pb.Empty(), None)
    assert opts.get_preferred_allocation_available is True and opts.pre_start_required is False
    assert port.PreStartContainer(pb.PreStartContainerRequest(), None) == \
        pb.PreStartContainerResponse()


def test_the_copied_messages_are_the_reference_messages():
    """The copy's serialized descriptor is byte-identical, so both modules
    share one registration (and one set of classes) in protobuf's pool."""
    from tpu_operator.agents.dpapi import deviceplugin_pb2 as ref_pb

    assert pb.DESCRIPTOR.serialized_pb == ref_pb.DESCRIPTOR.serialized_pb
    assert pb.AllocateResponse is ref_pb.AllocateResponse
