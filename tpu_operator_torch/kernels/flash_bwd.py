"""Wrappers of the four flash-attention backward kernels (``flash_bwd.cu``)
and their plain PyTorch version.

Layout is the forward's (``flash_fwd.py``): q, O, dO and dQ are
(B·H, S, D), k, v, dK and dV (B·H_kv, S, D); lse (the forward's, natural
log) and delta = rowsum(dO ∘ O) are (B·H, S) float32. Gradients come back
in the inputs' dtype. The kernels take sq == sk only, as ``flash_attention``
does.

The device of the tensors chooses the code: a CUDA tensor launches the
kernel (or raises), a CPU tensor runs :func:`attention_bwd_plain`, which
computes all three gradients from ``out``; each wrapper returns its part.
Each wrapper counts the kernel launches it makes in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from tpu_operator_torch.kernels import build
from tpu_operator_torch.kernels.flash_fwd import (
    _DTYPES,
    LOG2E,
    _check,
    _check_seg,
    _raise_on,
    keep_mask,
    kv_row,
)


def _rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded through ``dtype`` and back to float32 (a no-op for f32)."""
    return x.to(dtype).float()


def attention_bwd_plain(qb, kb, vb, out, lse, dout, heads: int, kv_heads: int, causal: bool,
                        window: Optional[int] = None,
                        seg: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
    """Dense masked float32 FlashAttention-2 backward with the kernels'
    masking (:func:`keep_mask`) and rounding points: P is recomputed from
    lse with the reference's guards (masked pairs and rows with lse = -inf
    give 0), dS = P∘(dP − Δ)/√d with Δ = rowsum(dO∘O), P is rounded to dO's
    dtype before dV = Pᵀ·dO and dS to the input dtype before dQ = dS·K and
    dK = dSᵀ·Q. A GQA group's q heads sum into their kv head. Returns
    (dq, dk, dv) in the inputs' dtypes."""
    bh, s, d = qb.shape
    group = heads // kv_heads
    scale = 1.0 / math.sqrt(d)
    rows = kv_row(torch.arange(bh, device=qb.device), heads, kv_heads)
    q, do = qb.float(), dout.float()
    k, v = kb.float()[rows], vb.float()[rows]
    live = torch.isfinite(lse)[..., None]
    keep = keep_mask(bh, s, kb.shape[1], heads, causal, window=window, seg=seg,
                     device=qb.device) & live
    scores = torch.einsum("bqd,bkd->bqk", q, k) * scale
    p = torch.where(keep, torch.exp(scores - torch.where(live, lse[..., None], 0.0)), 0.0)
    delta = (do * out.float()).sum(-1, keepdim=True)
    dp = torch.einsum("bqd,bkd->bqk", do, v)
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bqk,bkd->bqd", _rounded(ds, kb.dtype), k)
    dk = torch.einsum("bqk,bqd->bkd", _rounded(ds, qb.dtype), q)
    dv = torch.einsum("bqk,bqd->bkd", _rounded(p, dout.dtype), do)

    def per_kv_head(x):  # q row b·H + h_kv·group + m belongs to kv row b·H_kv + h_kv
        return x.reshape(bh // heads * kv_heads, group, s, d).sum(1)

    return dq.to(qb.dtype), per_kv_head(dk).to(kb.dtype), per_kv_head(dv).to(vb.dtype)


def _check_bwd(qb, kb, vb, dout, lse, delta, heads: int, kv_heads: int, seg=None) -> None:
    _check(qb, kb, vb, heads, kv_heads)
    if kb.shape[1] != qb.shape[1]:
        raise ValueError(f"the backward kernels need sq == sk, got {qb.shape[1]} and {kb.shape[1]}")
    if not (dout.is_cuda and dout.is_contiguous()) or dout.shape != qb.shape or dout.dtype != qb.dtype:
        raise ValueError(f"dout must be a contiguous CUDA tensor like q {tuple(qb.shape)} "
                         f"{qb.dtype}, got {tuple(dout.shape)} {dout.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if not (t.is_cuda and t.is_contiguous()) or t.dtype != torch.float32 or t.shape != qb.shape[:2]:
            raise ValueError(f"{name} must be a contiguous float32 CUDA tensor of shape "
                             f"{tuple(qb.shape[:2])}, got {t.dtype} {tuple(t.shape)}")
    if seg is not None:
        _check_seg(seg, qb.shape[0] // heads, qb.shape[1], kb.shape[1])


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (built on first call)."""
    lib = build.load("flash_bwd")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tensors = [ptr] * 6  # q, k, v, dout, lse, delta
    shape = [i32] * 6    # dtype, rows, s, d, heads, kv_heads
    lib.flash_bwd_dq_tri.argtypes = tensors + [ptr] + shape + [f32, f32, ptr]
    lib.flash_bwd_dkv_tri.argtypes = tensors + [ptr, ptr] + shape + [f32, f32, ptr]
    lib.flash_bwd_dq_rect.argtypes = tensors + [ptr, ptr] + shape + [i32, i32, f32, f32, ptr]
    lib.flash_bwd_dkv_rect.argtypes = tensors + [ptr, ptr, ptr] + shape + [i32, i32, f32, f32, ptr]
    for fn in (lib.flash_bwd_dq_tri, lib.flash_bwd_dkv_tri, lib.flash_bwd_dq_rect,
               lib.flash_bwd_dkv_rect):
        fn.restype = i32
    return lib


def _launch(name: str, qb, kb, vb, dout, lse, delta, outputs, rows: int, heads: int,
            kv_heads: int, *extra) -> None:
    """Launch ``name`` on the current stream; ``extra`` sits between the
    shape arguments and the two scales (the rect kernels' causal/window)."""
    _, s, d = qb.shape
    with torch.cuda.device(qb.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(_lib(), name)(
            qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), *outputs, _DTYPES[qb.dtype], rows, s, d, heads, kv_heads,
            *extra, LOG2E / math.sqrt(d), 1.0 / math.sqrt(d), stream,
        )
    _raise_on(code, name)


def flash_bwd_dq_tri(qb, kb, vb, out, dout, lse, delta, heads: int, kv_heads: int):
    """Plain-causal dQ: the port of ``_flash_dq_tri_kernel``."""
    if not qb.is_cuda:
        return attention_bwd_plain(qb, kb, vb, out, lse, dout, heads, kv_heads, True)[0]
    _check_bwd(qb, kb, vb, dout, lse, delta, heads, kv_heads)
    dq = torch.empty_like(qb)
    _launch("flash_bwd_dq_tri", qb, kb, vb, dout, lse, delta, (dq.data_ptr(),),
            qb.shape[0], heads, kv_heads)
    flash_bwd_dq_tri.launches += 1
    return dq


def flash_bwd_dkv_tri(qb, kb, vb, out, dout, lse, delta, heads: int, kv_heads: int):
    """Plain-causal (dK, dV), a GQA group summed per kv head: the port of
    ``_flash_dkv_tri_kernel``."""
    if not qb.is_cuda:
        return attention_bwd_plain(qb, kb, vb, out, lse, dout, heads, kv_heads, True)[1:]
    _check_bwd(qb, kb, vb, dout, lse, delta, heads, kv_heads)
    dk, dv = torch.empty_like(kb), torch.empty_like(vb)
    _launch("flash_bwd_dkv_tri", qb, kb, vb, dout, lse, delta, (dk.data_ptr(), dv.data_ptr()),
            kb.shape[0], heads, kv_heads)
    flash_bwd_dkv_tri.launches += 1
    return dk, dv


def flash_bwd_dq_rect(qb, kb, vb, out, dout, lse, delta, heads: int, kv_heads: int,
                      causal: bool, window: Optional[int] = None,
                      seg: Optional[torch.Tensor] = None):
    """dQ for causal or full attention, a window, segment ids (B, S) int32:
    the port of ``_flash_dq_kernel``."""
    if not qb.is_cuda:
        return attention_bwd_plain(qb, kb, vb, out, lse, dout, heads, kv_heads, causal,
                                   window, seg)[0]
    _check_bwd(qb, kb, vb, dout, lse, delta, heads, kv_heads, seg)
    dq = torch.empty_like(qb)
    _launch("flash_bwd_dq_rect", qb, kb, vb, dout, lse, delta,
            (None if seg is None else seg.data_ptr(), dq.data_ptr()), qb.shape[0], heads,
            kv_heads, int(causal), 0 if window is None else int(window))
    flash_bwd_dq_rect.launches += 1
    return dq


def flash_bwd_dkv_rect(qb, kb, vb, out, dout, lse, delta, heads: int, kv_heads: int,
                       causal: bool, window: Optional[int] = None,
                       seg: Optional[torch.Tensor] = None):
    """(dK, dV) for causal or full attention, a window, segment ids, GQA:
    the port of ``_flash_dkv_kernel``."""
    if not qb.is_cuda:
        return attention_bwd_plain(qb, kb, vb, out, lse, dout, heads, kv_heads, causal,
                                   window, seg)[1:]
    _check_bwd(qb, kb, vb, dout, lse, delta, heads, kv_heads, seg)
    dk, dv = torch.empty_like(kb), torch.empty_like(vb)
    _launch("flash_bwd_dkv_rect", qb, kb, vb, dout, lse, delta,
            (None if seg is None else seg.data_ptr(), dk.data_ptr(), dv.data_ptr()),
            kb.shape[0], heads, kv_heads, int(causal), 0 if window is None else int(window))
    flash_bwd_dkv_rect.launches += 1
    return dk, dv


flash_bwd_dq_tri.launches = 0
flash_bwd_dkv_tri.launches = 0
flash_bwd_dq_rect.launches = 0
flash_bwd_dkv_rect.launches = 0
