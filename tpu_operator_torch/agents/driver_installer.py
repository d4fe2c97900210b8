"""The driver container's user-space half on a card node (port of
``tpu_operator/agents/libtpu_installer.py``).

The reference installs the TPU runtime library, which is all a TPU node's
driver container has to deliver. A card's kernel module comes with the
node; what workloads load is the driver's user-space library, so this
installer puts that onto the host path the device plugin mounts into
every allocated container:

  1. find the driver library (``libcuda.so.1``): an explicit source, the
     ``LIBCUDA_PATH`` env, else the file the dynamic loader resolves;
  2. copy it to ``<install-dir>/libcuda.so.1-<driver version>`` atomically
     and re-point the ``libcuda.so.1`` symlink (running pods never read a
     torn file);
  3. write the version file (the driver version from the card probe) and
     the installer's ready marker (``consts.LIBTPU_CTR_READY_FILE``, the
     reference's name, which the validator's driver check and the health
     monitor read);
  4. keep running and re-verify every minute (DaemonSet semantics).

A second run with the same library changes nothing.

    python -m tpu_operator_torch.agents.driver_installer [--oneshot]

reads ``LIBTPU_INSTALL_DIR`` (the reference's env, which the control plane
renders) and ``LIBCUDA_PATH``.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import logging
import os
import shutil
import tempfile
import time
from typing import Optional

from tpu_operator_torch import consts

log = logging.getLogger(__name__)

LIBRARY_ENV = "LIBCUDA_PATH"


class _DlInfo(ctypes.Structure):
    _fields_ = [("dli_fname", ctypes.c_char_p), ("dli_fbase", ctypes.c_void_p),
                ("dli_sname", ctypes.c_char_p), ("dli_saddr", ctypes.c_void_p)]


def loader_path(soname: str = consts.DRIVER_LIBRARY, symbol: str = "cuInit") -> Optional[str]:
    """The file the dynamic loader resolves ``soname`` to (``dladdr`` of one
    of its symbols); None when it cannot load it."""
    try:
        lib = ctypes.CDLL(soname)
        libc = ctypes.CDLL(None)
    except OSError:
        return None
    libc.dladdr.argtypes = [ctypes.c_void_p, ctypes.POINTER(_DlInfo)]
    libc.dladdr.restype = ctypes.c_int
    info = _DlInfo()
    if not libc.dladdr(ctypes.cast(getattr(lib, symbol), ctypes.c_void_p), ctypes.byref(info)):
        return None
    return info.dli_fname.decode() if info.dli_fname else None


def find_driver_library(source: Optional[str] = None) -> str:
    """The driver library to install: ``source``, else ``LIBCUDA_PATH``,
    else the loader's resolution of ``libcuda.so.1``."""
    candidates = [source, os.environ.get(LIBRARY_ENV)]
    for path in candidates:
        if path and os.path.exists(path):
            return path
    found = loader_path()
    if found and os.path.exists(found):
        return found
    raise FileNotFoundError(f"no {consts.DRIVER_LIBRARY} found (checked "
                            f"{[c for c in candidates if c]} and the loader)")


def file_digest(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def install(source: str, install_dir: str, version: str = "") -> dict:
    """Idempotent atomic install of ``source`` as the driver library;
    ``version`` defaults to the first 12 hex digits of its digest. Returns
    ``{"version", "digest", "path", "changed"}``."""
    os.makedirs(install_dir, exist_ok=True)
    digest = file_digest(source)
    version = version or digest[:12]
    name = consts.DRIVER_LIBRARY
    versioned = os.path.join(install_dir, f"{name}-{version}")
    link = os.path.join(install_dir, name)
    changed = False
    if not os.path.exists(versioned) or file_digest(versioned) != digest:
        fd, tmp = tempfile.mkstemp(dir=install_dir, prefix=f".{name}-")
        os.close(fd)
        shutil.copyfile(source, tmp)
        os.replace(tmp, versioned)
        changed = True
    # re-point the symlink atomically (or replace a plain file)
    tmp_link = os.path.join(install_dir, f".{name}.tmp")
    try:
        os.remove(tmp_link)
    except FileNotFoundError:
        pass
    os.symlink(os.path.basename(versioned), tmp_link)
    os.replace(tmp_link, link)
    with open(os.path.join(install_dir, "version"), "w") as f:
        f.write(version + "\n")
    with open(os.path.join(install_dir, consts.LIBTPU_CTR_READY_FILE), "w") as f:
        f.write(digest + "\n")
    log.info("%s %s installed at %s (changed=%s)", name, version, link, changed)
    return {"version": version, "digest": digest, "path": link, "changed": changed}


def driver_version() -> str:
    """The node's driver version from the card probe ("" when unknown)."""
    from tpu_operator_torch.native import gpuinfo

    try:
        return gpuinfo.probe()["driver_version"]
    except (OSError, RuntimeError) as e:
        log.warning("driver version unknown: %s", e)
        return ""


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser("driver-installer")
    p.add_argument("--install-dir",
                   default=os.environ.get("LIBTPU_INSTALL_DIR", consts.LIBTPU_INSTALL_DIR))
    p.add_argument("--source", default=None)
    p.add_argument("--version", default="", help="default: the probed driver version")
    p.add_argument("--oneshot", action="store_true", help="install and exit")
    args = p.parse_args(argv)

    def once() -> dict:
        return install(find_driver_library(args.source), args.install_dir,
                       args.version or driver_version())

    log.info("install report: %s", once())
    if args.oneshot:
        return 0
    # DaemonSet long-run: re-verify (self-heal a wiped host path)
    while True:
        time.sleep(60)
        try:
            once()
        except OSError as e:
            log.warning("re-verify failed: %s", e)


if __name__ == "__main__":
    raise SystemExit(main())
