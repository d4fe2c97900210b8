"""Flash attention (port of ``tpu_operator/workloads/flashattention.py``).

Same public functions, layout (B, S, H, D) and errors as the reference.
The attention itself runs in hand-written CUDA kernels for CUDA tensors
(``kernels/flash_fwd.cu``, ``kernels/flash_bwd.cu``), and in their plain
PyTorch versions for CPU tensors (``kernels/flash_fwd.py``,
``kernels/flash_bwd.py``):

- plain causal attention with sq == sk and no offsets, window or segments
  takes the triangle kernels: the forward ``_flash_fwd_tri_kernel`` and
  the backward pair ``_flash_dq_tri_kernel``/``_flash_dkv_tri_kernel``;
- everything else — full attention, a sliding window, segment ids,
  global ``q_start``/``k_start`` offsets, sq != sk — takes the general
  kernels (``_flash_fwd_kernel``, ``_flash_dq_kernel``,
  ``_flash_dkv_kernel``).

:func:`flash_attention` is differentiable: the forward saves (out, lse)
and the FlashAttention-2 backward recomputes P from lse. ``block_q``/
``block_k`` keep only their role in the divisibility checks. The port's
own tile knob is ``block_m``, the kernels' q-tile height (64 or 128 rows
in bf16 and fp16, 64 in f32), forward and backward alike: unset, it is
the published autotune winner's (``autotune.tuned_flash_tile``), else the
launch plans choose. The sweep times bf16 only; an fp16 call takes the
bf16 winner of its shape class, as the reference's dtype-blind
``tuned_flash_blocks`` does. The plain versions on the CPU have no tiles:
there the value is checked and changes nothing.

Head dims: the kernels take 16, 32, 64, 128, 256, 512 and 576
(``flash_fwd.NATIVE_HEAD_DIMS``; 576 is MLA's absorbed head: a 512-wide
latent and 64 rope columns) and every multiple of 64 above 576 (the
D-streaming kernels); any other head dim runs zero-padded to the next of
those (:func:`_collapse_heads` writes the collapsed copy it makes anyway
into a zero buffer that wide), with the true head dim's softmax scale
passed down; the output and the gradients leave as views of their first
D columns. Zero columns change neither q·k, nor lse, nor Δ =
rowsum(dO∘O), and the padded output columns are zero, so the result is
the unpadded one. The padded products are wasted work: 33% at 96 → 128,
14% at 112 → 128, 60% at 80 → 128 (native 80, 96 and 112 are ROADMAP.md
item 20), 33% at 384 → 512, 6% at 544 → 576, 1% at 700 → 704. Above 576
both forwards and both backward pairs run on the D-streaming kernels.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from tpu_operator_torch.kernels.flash_bwd import (
    flash_bwd_dkv_rect,
    flash_bwd_dkv_tri,
    flash_bwd_dq_rect,
    flash_bwd_dq_tri,
)
from tpu_operator_torch.kernels.flash_fwd import (
    _DTYPES,
    TMA_ALIGN,
    check_block_m,
    flash_fwd_rect,
    flash_fwd_tri,
    padded_head_dim,
    tile_heights,
)
from tpu_operator_torch.kernels.flash_fwd import kv_row as _kv_row  # noqa: F401  (reference name)


def _tma_aligned(x: torch.Tensor) -> torch.Tensor:
    """x itself when it starts on a TMA_ALIGN-byte boundary, else a copy
    in a fresh (aligned) allocation: the kernels read q, k, v and dO by TMA
    (f32 from 256 on by 16-byte cp.async), and a contiguous tensor may be a
    view at any offset."""
    return x if x.data_ptr() % TMA_ALIGN == 0 else x.clone()


def _collapse_heads(q, k, v, width: Optional[int] = None):
    """Validate the GQA head layout and collapse (B, S, H, D) tensors to
    contiguous (B·H, S, width) rows, the head zero-padded from D to
    ``width`` (default D) in the same copy; returns (qb, kb, vb, h, h_kv).
    A collapse that is already contiguous (one head at a native D) is the
    caller's own storage, copied when its base is not on TMA_ALIGN bytes."""
    b, _, h, d = q.shape
    h_kv = k.shape[2]
    if h % h_kv:
        raise ValueError(f"q heads ({h}) must be a multiple of kv heads ({h_kv})")
    if v.shape != k.shape:
        raise ValueError(f"k and v shapes must match: {tuple(k.shape)} vs {tuple(v.shape)}")
    width = d if width is None else width

    def bh(x):
        x = x.transpose(1, 2)
        if width != d:  # one copy either way: the pad's
            x = torch.nn.functional.pad(x, (0, width - d))
        return _tma_aligned(x.reshape(b * x.shape[1], x.shape[2], width).contiguous())

    return bh(q), bh(k), bh(v), h, h_kv


def _head_dims(d: int):
    """(the head dim the kernels run, the softmax scale): ``d`` padded to a
    native head dim, and None (the kernels' own 1/√d) unless it was."""
    width = padded_head_dim(d)
    return width, (None if width == d else 1.0 / math.sqrt(d))


def _causal_triangle_tables(nq: int, nk_total: int, block_q: int, block_k: int):
    """Row-major (q block, k block) walk of the causal lower triangle —
    the pairs the triangle kernel visits, one q block per CTA walking its
    k tiles up to the diagonal."""
    tab_qi, tab_kj = [], []
    for qi in range(nq):
        for kj in range(min(nk_total - 1, ((qi + 1) * block_q - 1) // block_k) + 1):
            tab_qi.append(qi)
            tab_kj.append(kj)
    return torch.tensor(tab_qi, dtype=torch.int32), torch.tensor(tab_kj, dtype=torch.int32)


def _flash_forward(qb, kb, vb, causal: bool, block_q: int, block_k: int,
                   q_start: int = 0, k_start: int = 0, heads: Optional[int] = None,
                   kv_heads: Optional[int] = None, window: Optional[int] = None,
                   seg=None, block_m: Optional[int] = None, sm_scale: Optional[float] = None):
    """(out (B·H, Sq, D), lse (B·H, Sq) natural log) over collapsed rows;
    ``seg`` is (B, S) int32. Chooses the triangle or the general kernel
    exactly as the reference does, at the tile height ``block_m``, with the
    softmax scale ``sm_scale`` (None: 1/√D)."""
    s = qb.shape[1]
    sk = kb.shape[1]
    if window is not None and not (q_start == 0 and k_start == 0):
        # the band walk uses local block indices; global offsets would
        # silently drop in-window keys outside the walked band
        raise ValueError("window does not compose with q_start/k_start offsets")
    heads = heads or 1
    kv_heads = kv_heads or heads
    plain_causal = (
        causal and window is None and seg is None and sk == s
        and q_start == 0 and k_start == 0
    )
    if plain_causal:
        return flash_fwd_tri(qb, kb, vb, heads, kv_heads, block_m, sm_scale=sm_scale)
    return flash_fwd_rect(qb, kb, vb, heads, kv_heads, causal, q_start, k_start, window, seg,
                          block_m, sm_scale=sm_scale)


def _flash_dq_triangle(qb, kb, vb, out, g, lse, delta, heads: int, kv_heads: int,
                       block_m: Optional[int] = None, sm_scale: Optional[float] = None):
    """dQ over the causal triangle (the port of ``_flash_dq_tri_kernel``)."""
    return flash_bwd_dq_tri(qb, kb, vb, out, g, lse, delta, heads, kv_heads, block_m,
                            sm_scale=sm_scale)


def _flash_dkv_triangle(qb, kb, vb, out, g, lse, delta, heads: int, kv_heads: int,
                        block_m: Optional[int] = None, sm_scale: Optional[float] = None):
    """(dK, dV) over the causal triangle, each k tile walking every GQA
    group member's q tiles from the diagonal down (the port of
    ``_flash_dkv_tri_kernel``)."""
    return flash_bwd_dkv_tri(qb, kb, vb, out, g, lse, delta, heads, kv_heads, block_m,
                             sm_scale=sm_scale)


def _flash_bwd_impl(qb, kb, vb, out, lse, g, causal: bool, heads: int, kv_heads: int,
                    window: Optional[int] = None, seg=None, block_m: Optional[int] = None,
                    sm_scale: Optional[float] = None):
    """(dq, dk, dv) over collapsed rows: the triangle pair for plain causal
    attention, the general pair otherwise — the reference's choice — at
    the tile height ``block_m`` and the softmax scale ``sm_scale``."""
    triangle = causal and window is None and seg is None and kb.shape[1] == qb.shape[1]
    # D_i = rowsum(dO ∘ O) in f32: plain tensor ops, as the reference
    # leaves it to XLA
    delta = (g.float() * out.float()).sum(-1)
    if triangle:
        dq = _flash_dq_triangle(qb, kb, vb, out, g, lse, delta, heads, kv_heads, block_m,
                                sm_scale=sm_scale)
        dk, dv = _flash_dkv_triangle(qb, kb, vb, out, g, lse, delta, heads, kv_heads, block_m,
                                     sm_scale=sm_scale)
        return dq, dk, dv
    dq = flash_bwd_dq_rect(qb, kb, vb, out, g, lse, delta, heads, kv_heads, causal, window, seg,
                           block_m, sm_scale=sm_scale)
    dk, dv = flash_bwd_dkv_rect(qb, kb, vb, out, g, lse, delta, heads, kv_heads, causal,
                                window, seg, block_m, sm_scale=sm_scale)
    return dq, dk, dv


class _FlashCore(torch.autograd.Function):
    """Forward through the forward kernels, saving (q, k, v, out, lse) and
    the segment ids; backward through the FlashAttention-2 dQ and dK/dV
    kernels, both at the tile height ``block_m`` and the softmax scale
    ``sm_scale`` (None: 1/√D). Segment ids and the static arguments get no
    gradient. A padded head's output cotangent comes zero-padded through
    the slice the caller takes."""

    @staticmethod
    def forward(ctx, qb, kb, vb, seg, causal, block_q, block_k, heads, kv_heads, window,
                block_m=None, sm_scale=None):
        out, lse = _flash_forward(qb, kb, vb, causal, block_q, block_k, heads=heads,
                                  kv_heads=kv_heads, window=window, seg=seg, block_m=block_m,
                                  sm_scale=sm_scale)
        ctx.save_for_backward(qb, kb, vb, out, lse, seg)
        ctx.static = (causal, heads, kv_heads, window, block_m, sm_scale)
        return out

    @staticmethod
    def backward(ctx, grad):
        qb, kb, vb, out, lse, seg = ctx.saved_tensors
        causal, heads, kv_heads, window, block_m, sm_scale = ctx.static
        dq, dk, dv = _flash_bwd_impl(qb, kb, vb, out, lse, _tma_aligned(grad.contiguous()),
                                     causal, heads, kv_heads, window, seg, block_m, sm_scale)
        return dq, dk, dv, None, None, None, None, None, None, None, None, None


def _resolve_block_m(block_m: Optional[int], dtype: torch.dtype, seq_len: int, heads: int,
                     head_dim: int, fwd_bwd: bool) -> Optional[int]:
    """An explicit ``block_m``, checked against ``dtype`` at ``head_dim``;
    unset, the published winner's for the shape class (the fwd+bwd family's
    when a gradient will flow; swept in bf16, and taken by fp16 too, whose
    plans are bf16's), when ``dtype``'s kernels take it at ``head_dim`` (D
    256, 512 and 576 have no 128-row plan); else None."""
    if block_m is not None:
        check_block_m(dtype, block_m, head_dim)
        return block_m
    from tpu_operator_torch.workloads.autotune import tuned_flash_tile

    tuned = tuned_flash_tile(seq_len, heads=heads, head_dim=head_dim, fwd_bwd=fwd_bwd)
    return tuned if dtype in _DTYPES and tuned in tile_heights(dtype, head_dim) else None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
    window: Optional[int] = None,
    segment_ids: Optional[torch.Tensor] = None,
    block_m: Optional[int] = None,
) -> torch.Tensor:
    """q: (B, S, H, D); k/v: (B, S, H_kv, D) with H_kv dividing H
    (grouped-query attention when H_kv < H). ``window`` keeps only the
    last ``window`` positions (causal only); ``segment_ids`` (B, S) int
    restricts attention to same-segment pairs. Unset blocks resolve
    through the published autotune winners (``tuned_flash_blocks``), an
    unset ``block_m`` through ``tuned_flash_tile``. Any head dim runs
    (zero-padded to the kernels' next one), forward and backward."""
    b, s, h, d = q.shape
    width, sm_scale = _head_dims(d)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    block_m = _resolve_block_m(block_m, q.dtype, s, h, d, fwd_bwd=grad)
    if block_q is None or block_k is None:
        from tpu_operator_torch.workloads.autotune import tuned_flash_blocks

        tuned_q, tuned_k = tuned_flash_blocks(s, heads=h, head_dim=d)
        block_q = block_q or tuned_q
        block_k = block_k or tuned_k
    block_q = min(block_q, s)
    block_k = min(block_k, s)
    if s % block_q or s % block_k:
        raise ValueError(f"seq_len {s} must divide by blocks ({block_q}, {block_k})")
    if window is not None and (not causal or window < 1):
        raise ValueError("window requires causal attention and window >= 1")
    if k.shape[1] != s:
        raise ValueError(f"k/v seq_len {k.shape[1]} must equal q's ({s})")
    qb, kb, vb, h, h_kv = _collapse_heads(q, k, v, width)
    seg = None
    if segment_ids is not None:
        if tuple(segment_ids.shape) != (b, s):
            raise ValueError(
                f"segment_ids must be (batch, seq) = {(b, s)}, got {tuple(segment_ids.shape)}"
            )
        if segment_ids.is_floating_point() or segment_ids.is_complex() or segment_ids.dtype == torch.bool:
            raise ValueError(f"segment_ids must be integral, got {segment_ids.dtype}")
        seg = segment_ids.to(torch.int32).contiguous()
    out = _FlashCore.apply(qb, kb, vb, seg, causal, block_q, block_k, h, h_kv, window, block_m,
                           sm_scale)
    return out[..., :d].reshape(b, h, s, d).transpose(1, 2)


def flash_attention_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    block_q: int = 256,
    block_k: int = 256,
    q_start: int = 0,
    k_start: int = 0,
    block_m: Optional[int] = None,
):
    """Forward-only variant returning ``(out, lse)`` with GLOBAL sequence
    offsets for the causal mask (the ring and chunked-prefill building
    block). q may be shorter than k/v. lse is (B, Sq, H), natural log;
    a row with no visible key gets out 0 and lse -inf. ``block_m`` as
    :func:`flash_attention`'s (the forward family's winner); head dims as
    :func:`flash_attention`'s."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    width, sm_scale = _head_dims(d)
    block_m = _resolve_block_m(block_m, q.dtype, sq, h, d, fwd_bwd=False)
    block_q = min(block_q, sq)
    block_k = min(block_k, sk)
    if sq % block_q or sk % block_k:
        raise ValueError(
            f"seq lens ({sq}, {sk}) must divide by blocks ({block_q}, {block_k})"
        )
    qb, kb, vb, h, h_kv = _collapse_heads(q, k, v, width)
    out, lse = _flash_forward(
        qb, kb, vb, causal, block_q, block_k, q_start, k_start, heads=h, kv_heads=h_kv,
        block_m=block_m, sm_scale=sm_scale,
    )
    out = out[..., :d].reshape(b, h, sq, d).transpose(1, 2)
    lse = lse.reshape(b, h, sq).transpose(1, 2)  # (B, S, H)
    return out, lse


def run_flash_attention_check(
    seq_len: int = 512,
    batch: int = 1,
    heads: int = 2,
    head_dim: int = 128,
    block_q: int = 128,
    block_k: int = 128,
    causal: bool = True,
    device=None,
) -> dict:
    """Validator payload: the kernel must match dense attention to bf16
    accumulation noise on the plain and the packed-sequence paths."""
    from tpu_operator_torch.device import resolve_device
    from tpu_operator_torch.workloads.ringattention import dense_attention

    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(0)
    shape = (batch, seq_len, heads, head_dim)
    q, k, v = (torch.randn(shape, generator=gen).to(dev, torch.bfloat16) for _ in range(3))
    got = flash_attention(q, k, v, causal=causal, block_q=block_q, block_k=block_k)
    want = dense_attention(q, k, v, causal=causal)
    err = float((got.float() - want.float()).abs().max())
    if not math.isfinite(err) or err > 2e-2:
        raise RuntimeError(f"flash attention diverges from dense: max_abs_err={err}")
    # packed sequences: two segments with the boundary mid-block
    cut = seq_len // 2 + seq_len // 8
    seg = (torch.arange(seq_len, device=dev) >= cut).to(torch.int32).expand(batch, seq_len)
    got_seg = flash_attention(
        q, k, v, causal=causal, block_q=block_q, block_k=block_k, segment_ids=seg
    )
    want_seg = dense_attention(q, k, v, causal=causal, segment_ids=seg)
    seg_err = float((got_seg.float() - want_seg.float()).abs().max())
    if not math.isfinite(seg_err) or seg_err > 2e-2:
        raise RuntimeError(
            f"packed-sequence flash diverges from dense: max_abs_err={seg_err}"
        )
    return {
        "seq_len": seq_len,
        "block_q": block_q,
        "block_k": block_k,
        "causal": causal,
        "max_abs_err": err,
        "segment_max_abs_err": seg_err,
        "ok": True,
    }


def _step_seconds(body, device, name: str, iters: int, reps: int) -> float:
    """Seconds a step of the chain ``body(seed, n)``: two-point timing over
    ``iters`` and ``4 * iters`` steps, one CUDA-graph replay per timed call
    on the card (``kernels/graph.GraphedChain``), freed when the timing
    ends."""
    from tpu_operator_torch.kernels.graph import GraphedChain
    from tpu_operator_torch.workloads.timing import two_point_min_timing

    with GraphedChain(body, device, name) as chain:
        timing = two_point_min_timing(lambda s, n: float(chain(s, n)), iters, 4 * iters, reps)
    return timing.per_iter_s or timing.inclusive_per_iter_s


def bench_forward_s(fn, q, k, v, iters: int = 8, reps: int = 4) -> float:
    """Seconds a forward of the attention ``fn(q, k, v)``, timed as the
    bench's chain: each output, cast to q's dtype, is the next call's q."""
    from tpu_operator_torch.workloads.timing import seeded

    def body(s, n):
        out = seeded(q, s)
        for _ in range(n):
            out = fn(out, k, v).to(q.dtype)
        return out.float().sum()

    return _step_seconds(body, q.device, "bench forward", iters, reps)


def bench_fwd_bwd_s(fn, q, k, v, iters: int = 8, reps: int = 4) -> float:
    """Seconds a fwd+bwd of the attention ``fn(q, k, v)``, timed as
    ``timing.attention_grad_chain``, which folds ALL cotangents back."""
    from tpu_operator_torch.workloads.timing import attention_grad_steps

    steps = attention_grad_steps(fn, q, k, v)
    return _step_seconds(lambda s, n: steps(q, k, v, s, n), q.device, "bench fwd+bwd", iters,
                         reps)


def flash_attention_bench(
    seq_len: int = 4096,
    heads: int = 8,
    head_dim: int = 128,
    iters: int = 8,
    reps: int = 4,
    window: Optional[int] = None,
    device=None,
) -> dict:
    """Flash kernels vs dense attention at long context: per-call time of
    the forward and of fwd+bwd for each (two-point timing), and achieved
    attention FLOP/s. Dense is skipped above 8k — its O(S²) scores stop
    fitting. Dense fwd+bwd is timed twice: plain autograd, and under
    ``torch.utils.checkpoint`` (recomputing the scores in the backward, the
    best dense alternative for training). ``window`` also times the banded
    sliding-window forward. On the card every chain is one CUDA-graph
    replay per timed call (:func:`bench_forward_s`, :func:`bench_fwd_bwd_s`)."""
    from torch.utils.checkpoint import checkpoint

    from tpu_operator_torch.device import resolve_device
    from tpu_operator_torch.workloads.ringattention import dense_attention

    dev = resolve_device(device)
    shape = (1, seq_len, heads, head_dim)
    gen = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(shape, generator=gen).to(dev, torch.bfloat16) for _ in range(3))

    def timed(fn):
        return bench_forward_s(fn, q, k, v, iters, reps)

    def timed_grad(fn):
        return bench_fwd_bwd_s(fn, q, k, v, iters, reps)

    flash_s = timed(lambda a, kk, vv: flash_attention(a, kk, vv, causal=True))
    flash_train_s = timed_grad(lambda a, kk, vv: flash_attention(a, kk, vv, causal=True))
    report = {
        "seq_len": seq_len,
        "heads": heads,
        "device": str(dev),
        # causal attention: 2 matmuls x 2·S²/2·D MACs per head
        "flash_time_ms": flash_s * 1e3,
        "flash_tflops": 2 * 2 * heads * seq_len**2 * head_dim / 2 / flash_s / 1e12,
        "flash_fwd_bwd_ms": flash_train_s * 1e3,
    }
    if window is not None:
        window_s = timed(
            lambda a, kk, vv: flash_attention(a, kk, vv, causal=True, window=window)
        )
        report["window"] = window
        report["flash_window_time_ms"] = window_s * 1e3
    if seq_len <= 8192:
        dense_s = timed(lambda a, kk, vv: dense_attention(a, kk, vv, causal=True))
        report["dense_time_ms"] = dense_s * 1e3
        report["speedup_vs_dense"] = dense_s / flash_s
        dense_train_s = timed_grad(lambda a, kk, vv: dense_attention(a, kk, vv, causal=True))
        report["dense_fwd_bwd_ms"] = dense_train_s * 1e3
        report["train_step_speedup_vs_dense"] = dense_train_s / flash_train_s
        remat_train_s = timed_grad(
            # dense attention draws no random numbers (nor does the
            # reference's jax.checkpoint), and a capture may not read the
            # RNG state
            lambda a, kk, vv: checkpoint(dense_attention, a, kk, vv, True, use_reentrant=False,
                                         preserve_rng_state=False)
        )
        report["dense_remat_fwd_bwd_ms"] = remat_train_s * 1e3
        report["train_step_speedup_vs_remat_dense"] = remat_train_s / flash_train_s
    return report
