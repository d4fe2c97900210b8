"""Build the port's CUDA kernels at first use.

Each ``<name>.cu`` beside this file compiles with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, which the
wrappers load with ``ctypes``. No PyTorch header is included, so a build
takes seconds, not minutes. Libraries go to ``_build/`` (ignored by git),
named by a hash of the source, every header (``*.cuh``) beside it and the
flags, so an unchanged source is never rebuilt and a changed header
rebuilds every library. Several sources build in parallel, one ``nvcc``
each.

A failed build or load raises; nothing falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

KERNEL_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNEL_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from ``CUDA_HOME``, the standard toolkit location, or PATH."""
    candidates = [
        Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc" if os.environ.get("CUDA_HOME") else None,
        Path("/usr/local/cuda/bin/nvcc"),
    ]
    for cand in candidates:
        if cand is not None and cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    """Where the library of ``<name>.cu`` lives: named by a hash of the
    source, each header in ``KERNEL_DIR`` (a source may include any) and
    the flags."""
    digest = hashlib.sha256((KERNEL_DIR / f"{name}.cu").read_bytes())
    for header in sorted(KERNEL_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, Tuple[Path, float]]:
    """Compile every named source whose library is missing, all at once.
    Returns name -> (library path, build seconds; 0.0 when reused). The
    compiler's report (registers, shared memory, spills) lands beside the
    library as ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: Dict[str, Tuple[Path, float]] = {}
    running = []
    for name in names:
        lib = library_path(name)
        if lib.is_file():
            out[name] = (lib, 0.0)
            continue
        tmp = lib.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(KERNEL_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, lib, tmp, proc, time.perf_counter()))
    failures = []
    for name, lib, tmp, proc, start in running:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - start
        lib.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)
        out[name] = (lib, seconds)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path, _ = build([name])[name]
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib
