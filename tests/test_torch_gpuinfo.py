"""The card probe (``tpu_operator_torch/native/gpuinfo``) against its Python
scan and against the reference's ``tpu_operator/native/tpuinfo``.

A simulated inventory (``make_inventory``) lays out, under a scan root,
what a node shows: ``dev/nvidia<minor>`` card nodes with the driver's
control nodes, the kernel module's ``proc/driver/nvidia`` (version line and
one ``information`` file per card), and ``dev/accel<i>`` nodes for the same
number of cards, so the reference's probe sees the same inventory through
``TPUINFO_SCAN_ROOT``. The native scan must equal the Python scan exactly;
``chip_coords`` and ``fnv64`` must equal the reference's native and Python
results exactly. Nothing here is floating-point: every comparison is
equality.
"""

from __future__ import annotations

import errno
import json
import os
import subprocess
import sys

import pytest

from tpu_operator.native import tpuinfo
from tpu_operator.utils import fnv64a
from tpu_operator_torch import consts
from tpu_operator_torch.native import gpuinfo
from tpu_operator_torch.nodeinfo import gfd_labels

H100 = "NVIDIA H100 80GB HBM3"
DRIVER = "550.54.15"
VERSION_LINE = f"NVRM version: NVIDIA UNIX x86_64 Kernel Module  {DRIVER}  Tue Mar  5 22:23:10 UTC 2024"


def uuid_of(minor: int) -> str:
    return f"GPU-{minor:08x}-0000-4000-8000-{minor:012x}"


def bus_of(minor: int) -> str:
    return f"0000:{0x18 + minor:02x}:00.0"


def make_inventory(root, minors=range(4), listed=None, model=H100, version_line=VERSION_LINE,
                   accel=True):
    """A node's inventory under ``root``: card nodes for ``minors``, the
    driver's control nodes, the kernel module's version and one
    ``information`` file per minor of ``listed`` (default ``minors``), and,
    with ``accel``, the same number of ``accel<i>`` nodes for the reference."""
    minors = list(minors)
    dev = root / "dev"
    dev.mkdir(parents=True, exist_ok=True)
    for name in ("nvidiactl", "nvidia-uvm", "nvidia-uvm-tools", "nvidia-modeset", "null"):
        (dev / name).touch()
    for minor in minors:
        (dev / f"nvidia{minor}").touch()
    if accel:
        for i in range(len(minors)):
            (dev / f"accel{i}").touch()
    driver = root / "proc" / "driver" / "nvidia"
    (driver / "gpus").mkdir(parents=True, exist_ok=True)
    if version_line is not None:
        (driver / "version").write_text(version_line + "\nGCC version:  gcc version 12.3.0\n")
    for minor in (minors if listed is None else listed):
        bus = driver / "gpus" / bus_of(minor)
        bus.mkdir()
        (bus / "information").write_text(
            f"Model: \t\t {model}\nIRQ:   \t\t 97\nGPU UUID: \t {uuid_of(minor)}\n"
            f"Video BIOS: \t 96.00.99.00.01\nBus Type: \t PCIe\nDMA Size: \t 52 bits\n"
            f"DMA Mask: \t 0xfffffffffffff\nBus Location: \t {bus_of(minor)}\n"
            f"Device Minor: \t {minor}\nGPU Excluded:\t No\n")
    return root


@pytest.fixture()
def inventory(tmp_path, monkeypatch):
    """Four cards under a scan root both packages' probes read."""
    root = make_inventory(tmp_path / "node")
    monkeypatch.setenv(gpuinfo.SCAN_ROOT_ENV, str(root))
    monkeypatch.setenv("TPUINFO_SCAN_ROOT", str(root))
    monkeypatch.delenv("TPU_CHIPS_PER_HOST_BOUNDS", raising=False)
    return root


def refuse(monkeypatch, errors: dict):
    """``os.open`` of the named card nodes fails with the given errno."""
    real_open = os.open

    def fake_open(path, flags, *args):
        err = errors.get(os.path.basename(path))
        if err is not None:
            raise OSError(err, os.strerror(err), path)
        return real_open(path, flags, *args)

    monkeypatch.setattr(os, "open", fake_open)


# ------------------------------------------------------------ native vs Python


def _odd_inventories(root):
    """Inventories that stress the scan's parsing."""
    yield "four cards", make_inventory(root / "a")
    yield "host minors", make_inventory(root / "b", minors=[7, 0, 12])
    yield "listed but not visible", make_inventory(root / "c", minors=[3], listed=range(8))
    yield "no kernel view", make_inventory(root / "d", minors=[0, 1], listed=[], version_line=None)
    yield "no cards", make_inventory(root / "e", minors=[])
    odd = make_inventory(root / "f", minors=[1], version_line='NVRM "version" 1..2 x 9.9. 535.1')
    info = odd / "proc/driver/nvidia/gpus" / bus_of(1) / "information"
    info.write_text('Model:  quoted "name" \\ back\tslash\nDevice Minor: 1x\nGPU UUID:\nBus Location:\n'
                    'no colon here\n:\n')
    (odd / "proc/driver/nvidia/gpus/empty").mkdir()
    (odd / "dev" / "nvidia01").touch()
    (odd / "dev" / "nvidiaX").touch()
    yield "odd text", odd


def test_native_scan_equals_the_python_scan(tmp_path):
    assert gpuinfo.native() is not None, "g++ builds the native probe here"
    scans = {}
    for name, root in _odd_inventories(tmp_path):
        driver = f"{root}/proc/driver/nvidia"
        for dev in (f"{root}/dev/", f"{root}/dev"):
            scans[name] = gpuinfo.python_scan(dev, driver)
            assert gpuinfo.native_scan(dev, driver) == scans[name], name
    assert [n["minor"] for n in scans["host minors"]["nodes"]] == [0, 7, 12]
    assert scans["four cards"]["driver_version"] == DRIVER
    assert scans["four cards"]["gpus"][2] == {"bus_id": bus_of(2), "minor": 2, "model": H100,
                                             "uuid": uuid_of(2)}
    assert scans["odd text"]["driver_version"] == "535.1"
    assert [n["path"].rsplit("/", 1)[1] for n in scans["odd text"]["nodes"]] == [
        "nvidia01", "nvidia1"]
    assert scans["odd text"]["gpus"] == [
        {"bus_id": bus_of(1), "minor": -1, "model": 'quoted "name" \\ back\tslash', "uuid": ""},
        {"bus_id": "empty", "minor": -1, "model": "", "uuid": ""}]
    assert scans["no kernel view"]["driver_version"] == ""
    assert scans["no kernel view"]["gpus"] == [] and len(scans["no kernel view"]["nodes"]) == 2
    assert scans["no cards"]["nodes"] == []


def test_an_unreadable_device_directory_raises(tmp_path):
    for scan in (gpuinfo.native_scan, gpuinfo.python_scan):
        with pytest.raises(FileNotFoundError):
            scan(str(tmp_path / "absent"), str(tmp_path))
    with pytest.raises(OSError):
        gpuinfo.probe(str(tmp_path / "absent"))


# -------------------------------------------------------------------- probe


def test_probe_joins_the_card_nodes_and_the_kernel_view(inventory):
    report = gpuinfo.probe()
    assert report["source"] == "native"
    assert report["chip_count"] == 4 and report["driver_version"] == DRIVER
    assert report["devices"] == [f"{inventory}/dev/nvidia{i}" for i in range(4)]
    assert report["failed"] == report["refused"] == []
    assert report["cards"] == [
        {"device": f"{inventory}/dev/nvidia{i}", "minor": i, "model": H100, "uuid": uuid_of(i),
         "bus_id": bus_of(i), "memory_mib": 0} for i in range(4)]
    # the reference's probe sees the same four cards on the same root
    assert tpuinfo.probe()["chip_count"] == report["chip_count"]


def test_probe_joins_by_device_minor(tmp_path, monkeypatch):
    """The kernel module lists all eight cards of the host; the container
    may open only its own (minor 5), beside another container's node."""
    root = make_inventory(tmp_path, minors=[0, 5], listed=range(8))
    monkeypatch.setenv(gpuinfo.SCAN_ROOT_ENV, str(root))
    refuse(monkeypatch, {"nvidia0": errno.EPERM})
    report = gpuinfo.probe()
    assert report["chip_count"] == 1
    assert report["refused"] == [f"{root}/dev/nvidia0"]
    (card,) = report["cards"]
    assert (card["minor"], card["uuid"], card["bus_id"]) == (5, uuid_of(5), bus_of(5))


@pytest.mark.parametrize("nodes, errors, devices, failed, refused", [
    # another container's card: its node shows, the device cgroup refuses it
    ([0, 7], {"nvidia0": errno.EPERM}, [7], [], [0]),
    ([0, 7], {"nvidia0": errno.EACCES}, [7], [], [0]),
    # this container's card whose node fails otherwise has gone bad: a card
    ([0, 7], {"nvidia0": errno.EPERM, "nvidia7": errno.ENODEV}, [], [7], [0]),
    ([0, 1], {"nvidia1": errno.EIO}, [0], [1], []),
    ([3], {}, [3], [], []),
])
def test_probe_counts_only_the_nodes_it_may_open(tmp_path, monkeypatch, nodes, errors, devices,
                                                 failed, refused):
    root = make_inventory(tmp_path, minors=nodes)
    monkeypatch.setenv(gpuinfo.SCAN_ROOT_ENV, str(root))
    refuse(monkeypatch, errors)
    report = gpuinfo.probe()
    path = f"{root}/dev/nvidia{{}}".format
    assert report["devices"] == [path(m) for m in devices]
    assert report["failed"] == [path(m) for m in failed]
    assert report["refused"] == [path(m) for m in refused]
    assert report["chip_count"] == len(devices) + len(failed)
    assert [c["minor"] for c in report["cards"]] == sorted(devices + failed)


def test_nvml_fills_what_the_kernel_view_lacks(tmp_path, monkeypatch):
    """With no scan root, NVML's view (``driver_view``) joins by minor; the
    kernel module's view wins where both answer, and its driver version
    too."""
    make_inventory(tmp_path, minors=[0, 1], listed=[1])
    view = {"driver_version": "580.1.2", "cards": {
        0: {"model": "NVIDIA H100 PCIe", "uuid": uuid_of(9), "bus_id": "0000:99:00.0",
            "memory_mib": 81559},
        1: {"model": "other", "memory_mib": 81559}}}
    monkeypatch.setattr(gpuinfo, "driver_view", lambda: view)
    monkeypatch.delenv(gpuinfo.SCAN_ROOT_ENV, raising=False)
    report = gpuinfo.probe(str(tmp_path / "dev"))
    # the kernel module's directory is the host's (absent here): NVML's version
    assert report["driver_version"] == "580.1.2"
    assert report["cards"][0] == {"device": f"{tmp_path}/dev/nvidia0", "minor": 0,
                                  "model": "NVIDIA H100 PCIe", "uuid": uuid_of(9),
                                  "bus_id": "0000:99:00.0", "memory_mib": 81559}
    # a scan root names an inventory no driver describes: no NVML view
    monkeypatch.setenv(gpuinfo.SCAN_ROOT_ENV, str(tmp_path))
    report = gpuinfo.probe()
    assert report["driver_version"] == DRIVER
    assert report["cards"][0]["uuid"] == "" and report["cards"][0]["memory_mib"] == 0
    assert report["cards"][1]["model"] == H100 and report["cards"][1]["uuid"] == uuid_of(1)


FAKE_NVML = r"""
#include <cstdio>
#include <cstring>
struct Memory { unsigned long long total, free, used; };
struct Pci { char busIdLegacy[16]; unsigned int domain, bus, device, pciDeviceId,
             pciSubSystemId; char busId[32]; };
static const unsigned int kMinor[2] = {3, 7};
extern "C" {
int nvmlInit_v2() { return 0; }
int nvmlShutdown() { return 0; }
int nvmlSystemGetDriverVersion(char* buf, unsigned int n) {
  std::snprintf(buf, n, "580.159.03"); return 0; }
int nvmlDeviceGetCount_v2(unsigned int* n) { *n = 3; return 0; }
int nvmlDeviceGetHandleByIndex_v2(unsigned int i, void** h) {
  if (i > 1) return 3;  // a device NVML cannot open: skipped
  *h = (void*)(kMinor + i); return 0; }
int nvmlDeviceGetMinorNumber(void* h, unsigned int* m) { *m = *(unsigned int*)h; return 0; }
int nvmlDeviceGetName(void* h, char* buf, unsigned int n) {
  std::snprintf(buf, n, "NVIDIA H100 80GB HBM3"); return 0; }
int nvmlDeviceGetUUID(void* h, char* buf, unsigned int n) {
  std::snprintf(buf, n, "GPU-%08x-0000-4000-8000-%012x", *(unsigned int*)h, *(unsigned int*)h);
  return 0; }
int nvmlDeviceGetMemoryInfo(void* h, Memory* m) {
  m->total = 85520809984ULL; m->free = m->used = 0; return 0; }
int nvmlDeviceGetPciInfo_v3(void* h, Pci* p) {
  if (*(unsigned int*)h == 3) return 3;  // not supported, as on some machines
  std::memset(p, 0, sizeof *p);
  std::snprintf(p->busId, sizeof p->busId, "00000000:5D:00.0"); return 0; }
}
"""


def test_driver_view_reads_nvml(tmp_path, monkeypatch):
    """``driver_view`` against a stand-in NVML built with g++: the driver
    version, each card by its minor, a device NVML cannot open skipped, a
    bus id only where NVML gives PCI info (in the kernel module's form)."""
    src = tmp_path / "nvml.cc"
    src.write_text(FAKE_NVML)
    lib = tmp_path / "libnvidia-ml.so.1"
    subprocess.run(["g++", "-shared", "-fPIC", "-o", str(lib), str(src)], check=True, timeout=120)
    monkeypatch.setattr(gpuinfo, "NVML_LIBRARY", str(lib))
    card = {"model": H100, "memory_mib": 81559}
    assert gpuinfo.driver_view() == {"driver_version": "580.159.03", "cards": {
        3: dict(card, uuid=uuid_of(3)), 7: dict(card, uuid=uuid_of(7), bus_id="0000:5d:00.0")}}
    # the probe joins it to the card nodes by minor
    root = make_inventory(tmp_path / "node", minors=[3, 7], listed=[], version_line=None)
    monkeypatch.delenv(gpuinfo.SCAN_ROOT_ENV, raising=False)
    report = gpuinfo.probe(str(root / "dev"))
    assert report["driver_version"] == "580.159.03"
    assert [(c["minor"], c["uuid"], c["bus_id"]) for c in report["cards"]] == [
        (3, uuid_of(3), ""), (7, uuid_of(7), "0000:5d:00.0")]


def test_no_nvml_is_an_empty_view(monkeypatch, tmp_path):
    monkeypatch.setattr(gpuinfo, "NVML_LIBRARY", str(tmp_path / "absent.so"))
    assert gpuinfo.driver_view() == {"driver_version": "", "cards": {}}


def test_python_fallback_without_a_compiler(inventory, monkeypatch, tmp_path):
    want = gpuinfo.probe()
    monkeypatch.setattr(gpuinfo, "_lib", None)
    monkeypatch.setattr(gpuinfo, "_no_compiler", False)  # restored after the test
    monkeypatch.setattr(gpuinfo, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(gpuinfo.shutil, "which", lambda name: None)
    got = gpuinfo.probe()
    assert gpuinfo.native() is None and got["source"] == "python"
    assert dict(got, source="native") == want
    assert gpuinfo.chip_coords(4) == tpuinfo._python_chip_coords(4)
    assert gpuinfo.fnv64(b"abc") == fnv64a(b"abc")
    assert not (tmp_path / "build").exists()


def test_a_failing_compiler_raises(monkeypatch, tmp_path):
    bad = tmp_path / "gpuinfo.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(gpuinfo, "_lib", None)
    monkeypatch.setattr(gpuinfo, "_no_compiler", False)
    monkeypatch.setattr(gpuinfo, "SOURCE", bad)
    monkeypatch.setattr(gpuinfo, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="gpuinfo build failed"):
        gpuinfo.native()


def test_the_command_prints_the_report(inventory):
    out = subprocess.run([sys.executable, "-m", "tpu_operator_torch.native.gpuinfo"],
                         capture_output=True, text=True, timeout=60, check=True)
    assert json.loads(out.stdout)["chip_count"] == 4


# ---------------------------------------------------- chip_coords, fnv64, GFD


@pytest.mark.parametrize("bounds, count", [
    ("2,2,2", 0), ("4,4,1", 0), ("4,2,1", 3), (None, 4), (None, 8), (None, 2), (None, 1),
    (None, 3), (None, 0), ("4,4", 4), ("0,1,1", 2), ("2,2,2,2", 8), ("65,1,1", 1), ("x", 4),
    ("2,2,1x", 4),
])
def test_chip_coords_equal_the_reference(inventory, monkeypatch, bounds, count):
    if bounds is not None:
        monkeypatch.setenv("TPU_CHIPS_PER_HOST_BOUNDS", bounds)
    want = tpuinfo.chip_coords(count)
    assert want == tpuinfo._python_chip_coords(count or 4)
    assert gpuinfo.chip_coords(count) == want
    assert gpuinfo._python_chip_coords(count or 4) == want


@pytest.mark.parametrize("data", [b"", b"a", b"abc", bytes(range(256)) * 3,
                                  b"deviceplugin\x00\xff"])
def test_fnv64_equals_the_reference(data):
    assert gpuinfo.fnv64(data) == tpuinfo.fnv64(data) == fnv64a(data)
    assert gpuinfo.python_fnv64(data) == fnv64a(data)


def test_gfd_labels_from_the_probe(inventory):
    assert gfd_labels(gpuinfo.probe()) == {
        consts.GFD_PRODUCT_LABEL: "NVIDIA-H100-80GB-HBM3", consts.GFD_COUNT_LABEL: "4",
        consts.GFD_DRIVER_MAJOR_LABEL: "550", consts.GFD_DRIVER_MINOR_LABEL: "54",
        consts.GFD_DRIVER_REV_LABEL: "15"}
    card = {"model": "NVIDIA H100 PCIe", "memory_mib": 81559}
    assert gfd_labels({"chip_count": 2, "cards": [{"model": ""}, card],
                       "driver_version": "580.159"}) == {
        consts.GFD_PRODUCT_LABEL: "NVIDIA-H100-PCIe", consts.GFD_COUNT_LABEL: "2",
        consts.GFD_MEMORY_LABEL: "81559", consts.GFD_DRIVER_MAJOR_LABEL: "580",
        consts.GFD_DRIVER_MINOR_LABEL: "159"}
    assert gfd_labels({"chip_count": 1, "cards": [], "driver_version": ""}) == {
        consts.GFD_COUNT_LABEL: "1"}


# --------------------------------------------------- the health monitor reads it


def test_the_health_monitor_reads_the_probe(inventory, monkeypatch, tmp_path):
    from tpu_operator_torch.agents.health_monitor_agent import HealthMonitorAgent

    refuse(monkeypatch, {"nvidia3": errno.ENODEV})
    agent = HealthMonitorAgent(None, "n", expected_chips=6)
    assert agent.probe_chips() == {"nvidia0": "Healthy", "nvidia1": "Healthy",
                                   "nvidia2": "Healthy", "nvidia3": "Unhealthy",
                                   "nvidia4": "Unhealthy", "nvidia5": "Unhealthy"}
    monkeypatch.setenv(gpuinfo.SCAN_ROOT_ENV, str(tmp_path / "absent"))
    assert agent.probe_chips() is None
