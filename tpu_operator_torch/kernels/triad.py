"""Wrapper of the streaming-triad kernel (``triad.cu``) and its plain
PyTorch version: ``out = alpha * x + y``, rounded once (a fused
multiply-add), as the JAX package's ``_triad_kernel`` computes it.

The device of the tensors chooses the code: a CUDA tensor launches the
kernel (or raises), a CPU tensor runs :func:`triad_plain`. The wrapper
counts the kernel launches it makes in ``triad_kernel.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from tpu_operator_torch.kernels import build

_FMA_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def triad_plain(x: torch.Tensor, y: torch.Tensor, alpha: float,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``alpha * x + y`` rounded once to x's dtype, for any dtype; written
    into ``out`` when given (which may be ``x``).

    For f32, bf16 and f16 the sum is taken in float64: ``x * alpha`` is
    exact there (alpha first rounded to x's dtype, as JAX rounds a Python
    scalar), and the sum is rounded to odd (a TwoSum finds the error; an
    inexact result with an even last bit moves one step towards it), which
    makes the final rounding to x's dtype the correctly rounded fma. Wider
    or integer dtypes compute ``x * alpha + y`` in their own type."""
    if x.dtype in _FMA_DTYPES:
        p = x.double() * torch.tensor(alpha, dtype=x.dtype).item()
        yd = y.double()
        s = p + yd
        p_part = s - yd
        y_part = s - p_part
        e = (p - p_part) + (yd - y_part)
        even = (s.view(torch.int64) & 1) == 0
        nudged = torch.nextafter(s, torch.copysign(torch.full_like(s, torch.inf), e))
        result = torch.where((e != 0) & even & torch.isfinite(e), nudged, s).to(x.dtype)
    else:
        result = x * alpha + y
    if out is None:
        return result
    return out.copy_(result)


def _check(x: torch.Tensor, y: torch.Tensor, out: torch.Tensor) -> None:
    for name, t in (("x", x), ("y", y), ("out", out)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} must be a CUDA tensor on {x.device}, got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 for the kernel, got {t.dtype}")
        if t.shape != x.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, x has {tuple(x.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    # each element is read and written by one thread, so out may be an
    # input itself, but must not overlap one at an offset
    nbytes = 4 * x.numel()
    for name, t in (("x", x), ("y", y)):
        if 0 < abs(out.data_ptr() - t.data_ptr()) < nbytes:
            raise ValueError(f"out overlaps {name} at an offset")


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signature declared (built on first call)."""
    lib = build.load("triad")
    ptr = ctypes.c_void_p
    lib.triad.argtypes = [ptr, ptr, ptr, ctypes.c_longlong, ctypes.c_float, ctypes.c_int, ptr]
    lib.triad.restype = ctypes.c_int
    return lib


def triad_kernel(x: torch.Tensor, y: torch.Tensor, alpha: float,
                 out: torch.Tensor) -> torch.Tensor:
    """``out = alpha * x + y`` (out may be x): the port of ``_triad_kernel``.
    Returns ``out``."""
    if not x.is_cuda:
        return triad_plain(x, y, alpha, out)
    _check(x, y, out)
    index = x.device.index
    code = _lib().triad(x.data_ptr(), y.data_ptr(), out.data_ptr(), x.numel(), alpha, index,
                        torch.cuda.current_stream(index).cuda_stream)
    if code == -1:
        raise ValueError("triad_kernel: arguments not supported by the kernel")
    if code != 0:
        raise RuntimeError(f"triad_kernel: CUDA launch failed with error {code}")
    triad_kernel.launches += 1
    return out


triad_kernel.launches = 0
