"""The node's card probe (port of ``native/tpuinfo.cc`` and
``tpu_operator/native/tpuinfo.py``): the one inventory that node discovery,
feature discovery, the device plugin, the health monitor and the
node-status exporter read.

A card is a ``/dev/nvidia<N>`` device node (``N`` its device minor) that this
process may open. A container sees the card nodes of other containers too,
which its device cgroup refuses to open (EPERM or EACCES): those are
``refused``, not cards. A node that fails to open for another reason is a
card of this container gone bad: ``failed``, still a card. The driver's
other nodes (``nvidiactl``, ``nvidia-uvm``, ...) are not cards.

Each card's identity is joined by its device minor from two views:

- the kernel module's ``/proc/driver/nvidia``: ``version`` (the driver
  version) and ``gpus/<bus>/information`` (model, UUID, bus id, minor). It
  may list cards this process may not open;
- NVML (``libnvidia-ml.so.1``, through ctypes, as NVIDIA's own agents
  read it), only when no scan root is set (a scan root names an inventory
  no driver on this machine describes): the driver version and each
  card's minor, model, UUID, memory and, where NVML gives it, bus id. A
  container whose kernel module hides ``version`` and ``gpus/`` still has
  NVML. The kernel module's view wins where both answer.

The directory scan is native: ``gpuinfo.cc`` beside this file, built with
``g++`` at first use into ``_build/`` (ignored by git) and loaded through
ctypes. On a machine with no compiler a Python scan of the same paths gives
the same report; a compiler that fails raises.

``GPUINFO_SCAN_ROOT`` prefixes every scanned path (the reference's
``TPUINFO_SCAN_ROOT`` contract): a container that mounts the host at
``/host``, or a test that lays out an inventory in a scratch directory.

The reference's ``vfio_groups`` (chips passed through VFIO) has no
counterpart and is dropped: a card passed through to a VM shows no
``/dev/nvidia<N>`` here.

    python -m tpu_operator_torch.native.gpuinfo

prints the report as JSON.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

SCAN_ROOT_ENV = "GPUINFO_SCAN_ROOT"
NVML_LIBRARY = "libnvidia-ml.so.1"
SOURCE = Path(__file__).resolve().with_name("gpuinfo.cc")
BUILD_DIR = SOURCE.parent / "_build"
CXX_FLAGS = ("-O2", "-fPIC", "-Wall", "-Wextra", "-std=c++17", "-shared")

_CARD_NODE = re.compile(r"nvidia([0-9]{1,11})")
_VERSION_TOKEN = re.compile(r"[0-9]+(\.[0-9]+)+")
_SPACE = " \t\n\r\v\f"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_no_compiler = False


# -- the native library ------------------------------------------------------


def library_path() -> Path:
    """The built library, named by a hash of the source and the flags."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libgpuinfo-{digest[:16]}.so"


def native() -> Optional[ctypes.CDLL]:
    """The native probe, built on first use; None when the machine has no
    ``g++`` (the Python scan answers then). Raises when the compiler fails."""
    global _lib, _no_compiler
    with _lock:
        if _lib is not None or _no_compiler:
            return _lib
        path = library_path()
        if not path.is_file():
            cxx = shutil.which("g++")
            if cxx is None:
                _no_compiler = True
                return None
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".tmp{os.getpid()}")
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                                  capture_output=True, text=True, timeout=120)
            if proc.returncode != 0:
                raise RuntimeError(f"gpuinfo build failed (g++ exit {proc.returncode}):\n"
                                   f"{proc.stderr}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        lib.gpuinfo_scan.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
                                     ctypes.c_int]
        lib.gpuinfo_scan.restype = ctypes.c_int
        lib.gpuinfo_chip_coords.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
        lib.gpuinfo_chip_coords.restype = ctypes.c_int
        lib.gpuinfo_fnv64.argtypes = [ctypes.c_char_p, ctypes.c_ulonglong]
        lib.gpuinfo_fnv64.restype = ctypes.c_ulonglong
        _lib = lib
        return lib


def _call_json(fn, *args) -> Tuple[int, Optional[dict]]:
    """``fn(*args, buf, len)`` into a 64 KiB buffer: (its return code, the
    JSON it wrote, or None when the code is negative)."""
    buf = ctypes.create_string_buffer(64 * 1024)
    n = fn(*args, buf, len(buf))
    return n, (json.loads(buf.value.decode(errors="replace")) if n >= 0 else None)


# -- the directory scan --------------------------------------------------------


def scan_root() -> str:
    return os.environ.get(SCAN_ROOT_ENV, "").rstrip("/")


def scan_dirs(dev_dir: Optional[str] = None) -> Tuple[str, str]:
    """(device directory, the kernel module's directory) under the scan
    root; ``dev_dir`` overrides the first."""
    root = scan_root()
    dev = (dev_dir or f"{root}/dev").rstrip("/") or "/"
    return dev, f"{root}/proc/driver/nvidia"


def native_scan(dev_dir: str, driver_dir: str) -> dict:
    """The native scan of ``dev_dir`` and ``driver_dir`` (``gpuinfo_scan``).
    Raises ``RuntimeError`` when the library is unavailable and
    ``FileNotFoundError`` when ``dev_dir`` cannot be read."""
    lib = native()
    if lib is None:
        raise RuntimeError("the native gpuinfo probe is unavailable (no g++)")
    code, out = _call_json(lib.gpuinfo_scan, dev_dir.encode(), driver_dir.encode())
    if code == -2:
        raise FileNotFoundError(f"cannot read the device directory {dev_dir}")
    if out is None:
        raise RuntimeError(f"gpuinfo_scan failed ({code})")
    return out


def _read(path: str) -> Optional[str]:
    try:
        with open(path, "rb") as f:
            return f.read().decode(errors="replace")
    except OSError:
        return None


def _driver_version(text: Optional[str]) -> str:
    line = (text or "").split("\n", 1)[0]
    return next((t for t in re.split(f"[{_SPACE}]+", line) if _VERSION_TOKEN.fullmatch(t)), "")


def _information(gpus_dir: str, bus: str) -> dict:
    gpu = {"bus_id": bus, "minor": -1, "model": "", "uuid": ""}
    keys = {"Model": "model", "GPU UUID": "uuid", "Bus Location": "bus_id",
            "Device Minor": "minor"}
    for line in (_read(f"{gpus_dir}/{bus}/information") or "").split("\n"):
        key, colon, value = line.partition(":")
        field = keys.get(key.strip(_SPACE))
        value = value.strip(_SPACE)
        if not colon or field is None or (field == "bus_id" and not value):
            continue
        if field == "minor":
            value = int(value) if re.fullmatch(r"[0-9]{1,11}", value) else -1
        gpu[field] = value
    return gpu


def python_scan(dev_dir: str, driver_dir: str) -> dict:
    """The same scan in Python (the fallback with no compiler, and the
    native scan's check)."""
    nodes = [{"path": f"{dev_dir}/{name}", "minor": int(m.group(1))}
             for name in os.listdir(dev_dir) if (m := _CARD_NODE.fullmatch(name))]
    nodes.sort(key=lambda n: (n["minor"], n["path"]))
    gpus_dir = f"{driver_dir}/gpus"
    try:
        buses = sorted(os.listdir(gpus_dir))
    except OSError:
        buses = []
    return {"nodes": nodes, "driver_version": _driver_version(_read(f"{driver_dir}/version")),
            "gpus": [_information(gpus_dir, bus) for bus in buses]}


# -- the driver's libraries ----------------------------------------------------


class _NvmlMemory(ctypes.Structure):
    _fields_ = [("total", ctypes.c_ulonglong), ("free", ctypes.c_ulonglong),
                ("used", ctypes.c_ulonglong)]


class _NvmlPciInfo(ctypes.Structure):
    _fields_ = [("busIdLegacy", ctypes.c_char * 16), ("domain", ctypes.c_uint),
                ("bus", ctypes.c_uint), ("device", ctypes.c_uint),
                ("pciDeviceId", ctypes.c_uint), ("pciSubSystemId", ctypes.c_uint),
                ("busId", ctypes.c_char * 32)]


def driver_view() -> dict:
    """What NVML says: ``{"driver_version": str, "cards": {minor: {"model",
    "uuid", "memory_mib", "bus_id"}}}``, fields NVML does not give left
    out; empty without NVML."""
    out: Dict = {"driver_version": "", "cards": {}}
    try:
        nvml = ctypes.CDLL(NVML_LIBRARY)
    except OSError:
        return out
    if nvml.nvmlInit_v2() != 0:
        return out
    try:
        text = ctypes.create_string_buffer(96)
        if nvml.nvmlSystemGetDriverVersion(text, len(text)) == 0:
            out["driver_version"] = text.value.decode()
        count = ctypes.c_uint()
        nvml.nvmlDeviceGetCount_v2(ctypes.byref(count))
        for i in range(count.value):
            handle, minor = ctypes.c_void_p(), ctypes.c_uint()
            if (nvml.nvmlDeviceGetHandleByIndex_v2(i, ctypes.byref(handle)) != 0
                    or nvml.nvmlDeviceGetMinorNumber(handle, ctypes.byref(minor)) != 0):
                continue
            card = out["cards"][minor.value] = {}
            if nvml.nvmlDeviceGetName(handle, text, len(text)) == 0:
                card["model"] = text.value.decode(errors="replace")
            if nvml.nvmlDeviceGetUUID(handle, text, len(text)) == 0:
                card["uuid"] = text.value.decode(errors="replace")
            memory, pci = _NvmlMemory(), _NvmlPciInfo()
            if nvml.nvmlDeviceGetMemoryInfo(handle, ctypes.byref(memory)) == 0:
                card["memory_mib"] = memory.total >> 20
            if nvml.nvmlDeviceGetPciInfo_v3(handle, ctypes.byref(pci)) == 0:
                # "00000000:18:00.0" -> the kernel module's "0000:18:00.0"
                domain, _, rest = pci.busId.decode().partition(":")
                card["bus_id"] = f"{int(domain, 16):04x}:{rest.lower()}"
    finally:
        nvml.nvmlShutdown()
    return out


# -- the probe -----------------------------------------------------------------


def probe(dev_dir: Optional[str] = None) -> dict:
    """The node's card inventory::

        {"chip_count": N,           # this process's cards: devices + failed
         "devices": [path, ...],    # card nodes it may open
         "failed": [path, ...],     # card nodes of its own that fail to open
         "refused": [path, ...],    # other containers' card nodes
         "driver_version": "550.54.15",
         "cards": [{"device", "minor", "model", "uuid", "bus_id",
                    "memory_mib"}, ...],   # by minor; "" / 0 where unknown
         "source": "native" | "python"}

    ``dev_dir`` overrides the scanned device directory. Raises ``OSError``
    when the device directory cannot be read: the caller's probe failed
    (indeterminate), which is not an empty inventory."""
    dev, driver = scan_dirs(dev_dir)
    lib = native()
    scan = native_scan(dev, driver) if lib is not None else python_scan(dev, driver)
    devices, failed, refused = [], [], []
    for node in scan["nodes"]:
        try:
            os.close(os.open(node["path"], os.O_RDWR))
        except PermissionError:
            refused.append(node["path"])
        except OSError:
            failed.append(node["path"])
        else:
            devices.append(node["path"])
    drv = driver_view() if not scan_root() else {"driver_version": "", "cards": {}}
    kernel = {g["minor"]: g for g in scan["gpus"] if g["minor"] >= 0}
    cards = []
    for node in scan["nodes"]:
        if node["path"] in refused:
            continue
        card = {"device": node["path"], "minor": node["minor"], "model": "", "uuid": "",
                "bus_id": "", "memory_mib": 0}
        for view in (drv["cards"].get(node["minor"], {}), kernel.get(node["minor"], {})):
            card.update({k: v for k, v in view.items() if k in card and k != "minor" and v})
        cards.append(card)
    return {"chip_count": len(cards), "devices": devices, "failed": failed, "refused": refused,
            "driver_version": scan["driver_version"] or drv["driver_version"], "cards": cards,
            "source": "native" if lib is not None else "python"}


# -- chip coordinates and the content hash -------------------------------------


def _python_chip_coords(chip_count: int) -> dict:
    bounds = None
    env = os.environ.get("TPU_CHIPS_PER_HOST_BOUNDS", "")
    if env:
        try:
            bx, by, bz = (int(p) for p in env.split(","))
            if 0 < bx <= 64 and 0 < by <= 64 and 0 < bz <= 64 and bx * by * bz <= 4096:
                bounds = (bx, by, bz)
        except ValueError:
            pass
    if bounds is None:
        bounds = {8: (2, 4, 1), 4: (2, 2, 1), 2: (2, 1, 1)}.get(
            chip_count, (max(chip_count, 1), 1, 1))
    bx, by, bz = bounds
    return {"bounds": [bx, by, bz],
            "coords": [[i % bx, (i // bx) % by, i // (bx * by)] for i in range(bx * by * bz)]}


def chip_coords(chip_count: int = 0) -> dict:
    """Per-card (x,y,z) within this host's block, the reference's contract:
    bounds from ``TPU_CHIPS_PER_HOST_BOUNDS`` or by card count (``0``: the
    probe's, 0 when it fails), ``{"bounds": [x,y,z], "coords": [[x,y,z],
    ...]}`` indexed by the card's number, x fastest. An NVSwitch board joins
    every pair of its cards in one hop, so the coordinates only rank equal
    picks (the device plugin's preferred allocation reads them)."""
    if chip_count <= 0:
        try:
            chip_count = probe()["chip_count"]
        except OSError:
            chip_count = 0
    lib = native()
    out = _call_json(lib.gpuinfo_chip_coords, chip_count)[1] if lib is not None else None
    return out if out is not None else _python_chip_coords(chip_count)


def python_fnv64(data: bytes) -> int:
    h = 0xCBF29CE484222325
    for byte in data:
        h = ((h ^ byte) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def fnv64(data: bytes) -> int:
    """FNV-1a 64 (the reference's constants), native when built."""
    lib = native()
    return int(lib.gpuinfo_fnv64(data, len(data))) if lib is not None else python_fnv64(data)


if __name__ == "__main__":
    print(json.dumps(probe(), indent=1))
