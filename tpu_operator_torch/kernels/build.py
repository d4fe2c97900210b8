"""Build the port's CUDA kernels at first use.

Each ``<name>.cu`` beside this file compiles with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, which the
wrappers load with ``ctypes``. No PyTorch header is included, so a build
takes seconds, not minutes. A name in ``VARIANTS`` is a second library of
another source, compiled with extra defines: the fp16 flash kernels
(``flash_fwd_f16``, ``flash_bwd_f16``), which the wrappers build only at
their first fp16 call, so that bf16 and f32 callers never wait for them,
the head dim 512 flash kernels (``*_d512``: bf16, or fp16), those of head
dim 576 (``*_d576``) and the D-streaming kernels of every head dim above 576
(``*_wide``, which also hold f32's cluster kernels of both flash sources at
head dims 256 and above), each built only at the first call at its head dim.
Libraries go to ``_build/`` (ignored by git) or to the directory
:func:`bind_build_dir` names (the node's compile cache), named by a hash
of the source, every header (``*.cuh``) beside it, the flags and the
defines, so an unchanged source is never rebuilt and a changed header
rebuilds every library. Several libraries build in parallel, one ``nvcc``
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
from typing import Dict, Iterable, Optional, Tuple

KERNEL_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNEL_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

# library name -> (the source it compiles, its extra nvcc defines)
VARIANTS: Dict[str, Tuple[str, Tuple[str, ...]]] = {
    "flash_fwd_f16": ("flash_fwd", ("-DFLASH_ELEM_F16",)),
    "flash_bwd_f16": ("flash_bwd", ("-DFLASH_ELEM_F16",)),
    "flash_fwd_d512": ("flash_fwd", ("-DFLASH_HEAD_DIM_512",)),
    "flash_bwd_d512": ("flash_bwd", ("-DFLASH_HEAD_DIM_512",)),
    "flash_fwd_f16_d512": ("flash_fwd", ("-DFLASH_ELEM_F16", "-DFLASH_HEAD_DIM_512")),
    "flash_bwd_f16_d512": ("flash_bwd", ("-DFLASH_ELEM_F16", "-DFLASH_HEAD_DIM_512")),
    "flash_fwd_d576": ("flash_fwd", ("-DFLASH_HEAD_DIM_576",)),
    "flash_bwd_d576": ("flash_bwd", ("-DFLASH_HEAD_DIM_576",)),
    "flash_fwd_f16_d576": ("flash_fwd", ("-DFLASH_ELEM_F16", "-DFLASH_HEAD_DIM_576")),
    "flash_bwd_f16_d576": ("flash_bwd", ("-DFLASH_ELEM_F16", "-DFLASH_HEAD_DIM_576")),
    "flash_fwd_wide": ("flash_fwd", ("-DFLASH_HEAD_DIM_WIDE",)),
    "flash_bwd_wide": ("flash_bwd", ("-DFLASH_HEAD_DIM_WIDE",)),
    "flash_fwd_f16_wide": ("flash_fwd", ("-DFLASH_ELEM_F16", "-DFLASH_HEAD_DIM_WIDE")),
    "flash_bwd_f16_wide": ("flash_bwd", ("-DFLASH_ELEM_F16", "-DFLASH_HEAD_DIM_WIDE")),
}

_loaded: Dict[str, ctypes.CDLL] = {}
_bound_dir: Optional[Path] = None  # set by bind_build_dir


def build_dir() -> Path:
    """Where libraries are built and loaded from: the bound directory, else
    ``BUILD_DIR``."""
    return _bound_dir or BUILD_DIR


def bind_build_dir(path) -> Path:
    """Make later builds and loads use ``path`` (created if missing).
    Libraries already loaded stay loaded. Raises ``OSError`` when the
    directory cannot be created or written."""
    global _bound_dir
    target = Path(path)
    target.mkdir(parents=True, exist_ok=True)
    if not os.access(target, os.W_OK | os.X_OK):
        raise PermissionError(f"kernel build directory {target} is not writable")
    _bound_dir = target
    return target


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


def kernel_digest(sources: Iterable[Path], defines: Tuple[str, ...] = ()) -> str:
    """sha256 (hex) over the given CUDA sources, each header in
    ``KERNEL_DIR`` (a source may include any), the flags and the extra
    ``defines``: what a built library depends on."""
    digest = hashlib.sha256()
    for source in sources:
        digest.update(source.name.encode() + source.read_bytes())
    for header in sorted(KERNEL_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join((*NVCC_FLAGS, *defines)).encode())
    return digest.hexdigest()


def _recipe(name: str) -> Tuple[Path, Tuple[str, ...]]:
    """(the source, the extra defines) of library ``name``: its
    ``VARIANTS`` entry, else ``<name>.cu`` as it is."""
    source, defines = VARIANTS.get(name, (name, ()))
    return KERNEL_DIR / f"{source}.cu", defines


def library_path(name: str) -> Path:
    """Where library ``name`` lives: named by :func:`kernel_digest` of its
    source and defines."""
    source, defines = _recipe(name)
    digest = kernel_digest([source], defines)
    return build_dir() / f"lib{name}-{digest[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, Tuple[Path, float]]:
    """Compile every named library (a source, or a ``VARIANTS`` entry)
    that is missing, all at once.
    Returns name -> (library path, build seconds; 0.0 when reused). The
    compiler's report (registers, shared memory, spills) lands beside the
    library as ``<library>.log``."""
    build_dir().mkdir(parents=True, exist_ok=True)
    out: Dict[str, Tuple[Path, float]] = {}
    running = []
    for name in names:
        lib = library_path(name)
        if lib.is_file():
            out[name] = (lib, 0.0)
            continue
        tmp = lib.with_suffix(f".tmp{os.getpid()}")
        source, defines = _recipe(name)
        cmd = [nvcc_path(), *NVCC_FLAGS, *defines, "-o", str(tmp), str(source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, lib, tmp, proc, time.perf_counter()))
    failures = []
    for name, lib, tmp, proc, start in running:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - start
        lib.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)
        out[name] = (lib, seconds)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path, _ = build([name])[name]
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib
