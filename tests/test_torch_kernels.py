"""The port's hand-written CUDA kernels against their plain PyTorch
version, on the card. These tests need a CUDA device and skip without
one; the file imports no JAX, so on a machine with a card and no JAX it
runs on its own:

    python -m pytest tests/test_torch_kernels.py --noconftest -q

The triad rounds once in the kernel and in its plain version alike (a
fused multiply-add), so the two are compared bit for bit. The bf16
forward kernels and both backward pairs run on the tensor cores at one
and two warpgroups a CTA (64- and 128-row tiles), ragged lengths, GQA
groups and the burn-in and long-context shapes; the general kernels also
under full attention, window bands and segment ids (random, and whole
64-token documents, whose cross-document tiles take no products), and
the general forward at global offsets with sq != sk (a ring hop, a
chunked prefill, rows that see no key).

Gradients are compared in the working dtype: f32 within 1e-4 absolute,
bf16 within 2e-2 of the largest |gradient| of dq, dk and dv (bf16 keeps
8 bits, and P and dS are rounded to it before each product, in the
kernels and the plain version alike, so a rounding that falls the other
way moves a gradient by about one bf16 step of its operands).
"""

import math

import numpy as np
import pytest
import torch

from tpu_operator_torch.kernels import flash_bwd, flash_fwd, triad
from tpu_operator_torch.workloads.flashattention import _collapse_heads, flash_attention
from tpu_operator_torch.workloads.ringattention import dense_attention

F32_TOL = 1e-4
BF16_TOL = 2e-2
LSE_TOL = 1e-3
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _qkv(seed, b, sq, h, d, dtype, h_kv=None, sk=None):
    rng = np.random.default_rng(seed)
    shapes = ((b, sq, h, d), (b, sk or sq, h_kv or h, d), (b, sk or sq, h_kv or h, d))
    return _collapse_heads(*(torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                             .to("cuda", dtype) for s in shapes))


def _err(a, b):
    a, b = a.float(), b.float()
    assert torch.equal(torch.isneginf(a), torch.isneginf(b))
    inf = torch.isneginf(a)
    return float((torch.where(inf, 0.0, a) - torch.where(inf, 0.0, b)).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("d", flash_fwd.HEAD_DIMS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_triangle_kernel_matches_plain(cuda, d, dtype):
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for s, h, h_kv in ((100, 2, 2), (128, 4, 2), (1, 1, 1)):
        qb, kb, vb, h_, hk = _qkv(11, 2, s, h, d, DTYPES[dtype], h_kv=h_kv)
        before = flash_fwd.flash_fwd_tri.launches
        out, lse = flash_fwd.flash_fwd_tri(qb, kb, vb, h_, hk)
        want, want_lse = flash_fwd.attention_plain(qb, kb, vb, h_, hk, causal=True)
        torch.cuda.synchronize()
        assert flash_fwd.flash_fwd_tri.launches == before + 1
        assert out.dtype == qb.dtype and lse.dtype == torch.float32
        assert _err(want, out) <= tol and _err(want_lse, lse) <= LSE_TOL


# sequence lengths for the bf16 triangle on the tensor cores: one token,
# ragged last tiles, several tiles
TC_LENGTHS = (1, 100, 200, 1000)


def _tc_check(seed, b, s, h, d, h_kv):
    qb, kb, vb, h_, hk = _qkv(seed, b, s, h, d, torch.bfloat16, h_kv=h_kv)
    before = flash_fwd.flash_fwd_tri.launches
    out, lse = flash_fwd.flash_fwd_tri(qb, kb, vb, h_, hk)
    want, want_lse = flash_fwd.attention_plain(qb, kb, vb, h_, hk, causal=True)
    torch.cuda.synchronize()
    assert flash_fwd.flash_fwd_tri.launches == before + 1
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert _err(want, out) <= BF16_TOL and _err(want_lse, lse) <= LSE_TOL, (b, s, h, d, h_kv)
    return flash_fwd.tri_plan(torch.bfloat16, b * h, s, d,
                              torch.cuda.get_device_properties(0).multi_processor_count)


@pytest.mark.cuda
@pytest.mark.parametrize("d", flash_fwd.HEAD_DIMS)
@pytest.mark.parametrize("s", TC_LENGTHS)
def test_tensor_core_triangle_matches_plain(cuda, d, s):
    assert _tc_check(21, 2, s, 4, d, 2).block_m == 64
    # 256 (batch, head) rows: 128-row tiles in several waves of CTAs
    assert _tc_check(22, 16, s, 16, d, 4).block_m == 128


@pytest.mark.cuda
@pytest.mark.parametrize("h_kv", [4, 2])
def test_tensor_core_triangle_at_the_burnin_shape(cuda, h_kv):
    assert _tc_check(23, 8, 128, 4, 64, h_kv).block_m == 64  # GQA: the kv_heads=2 train config


@pytest.mark.cuda
def test_tensor_core_triangle_at_long_context(cuda):
    assert _tc_check(24, 1, 4096, 8, 128, 8).block_m == 128


@pytest.mark.cuda
def test_tensor_core_triangle_rejects_a_misaligned_base(cuda):
    qb, kb, vb, h, hk = _qkv(25, 1, 64, 2, 64, torch.bfloat16)
    for which in range(3):
        args = [qb, kb, vb]
        flat = torch.empty(args[which].numel() + 1, dtype=torch.bfloat16, device="cuda")
        args[which] = flat[1:].view(args[which].shape).copy_(args[which])  # 2 bytes off
        before = flash_fwd.flash_fwd_tri.launches
        with pytest.raises(ValueError, match="16-byte"):
            flash_fwd.flash_fwd_tri(*args, h, hk)
        assert flash_fwd.flash_fwd_tri.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("d", flash_fwd.HEAD_DIMS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_general_kernel_matches_plain(cuda, d, dtype):
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    seg = torch.tensor([[0] * 37 + [1] * 63, [0] * 70 + [1] * 30], dtype=torch.int32, device="cuda")
    cases = [
        dict(sq=100, sk=100, causal=False),
        dict(sq=100, sk=100, causal=True, window=33),
        dict(sq=100, sk=100, causal=True, seg=seg),
        dict(sq=100, sk=100, causal=False, seg=seg),
        dict(sq=100, sk=100, causal=True, window=7, seg=seg),
        dict(sq=8, sk=64, causal=True, q_start=16),
        dict(sq=8, sk=64, causal=True, q_start=56),
        dict(sq=24, sk=80, causal=True, k_start=10),
        dict(sq=70, sk=130, causal=True, q_start=60),
    ]
    for case in cases:
        qb, kb, vb, h, hk = _qkv(12, 2, case["sq"], 4, d, DTYPES[dtype], h_kv=2, sk=case["sk"])
        args = (case["causal"], case.get("q_start", 0), case.get("k_start", 0),
                case.get("window"), case.get("seg"))
        before = flash_fwd.flash_fwd_rect.launches
        out, lse = flash_fwd.flash_fwd_rect(qb, kb, vb, h, hk, *args)
        want, want_lse = flash_fwd.attention_plain(qb, kb, vb, h, hk, *args)
        torch.cuda.synchronize()
        assert flash_fwd.flash_fwd_rect.launches == before + 1
        assert _err(want, out) <= tol, case
        assert _err(want_lse, lse) <= LSE_TOL, case


@pytest.mark.cuda
def test_fully_masked_rows_are_zero_with_lse_minus_inf(cuda):
    qb, kb, vb, h, hk = _qkv(13, 1, 64, 2, 32, torch.bfloat16)
    out, lse = flash_fwd.flash_fwd_rect(qb, kb, vb, h, hk, True, k_start=40)
    torch.cuda.synchronize()
    assert torch.all(out[:, :40] == 0) and torch.all(torch.isneginf(lse[:, :40]))
    assert torch.all(torch.isfinite(lse[:, 40:]))


def _rect_fwd_check(seed, b, sq, h, d, h_kv, causal, q_start=0, k_start=0, window=None,
                    seg=None, sk=None, dtype=torch.bfloat16):
    """The general forward against attention_plain, one launch; returns
    the launch plan it ran with."""
    qb, kb, vb, h_, hk = _qkv(seed, b, sq, h, d, dtype, h_kv=h_kv, sk=sk)
    args = (causal, q_start, k_start, window, seg)
    before = flash_fwd.flash_fwd_rect.launches
    out, lse = flash_fwd.flash_fwd_rect(qb, kb, vb, h_, hk, *args)
    want, want_lse = flash_fwd.attention_plain(qb, kb, vb, h_, hk, *args)
    torch.cuda.synchronize()
    assert flash_fwd.flash_fwd_rect.launches == before + 1
    assert out.dtype == dtype and lse.dtype == torch.float32
    case = (b, sq, sk, h, d, h_kv, causal, q_start, k_start, window, seg is not None)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    assert _err(want, out) <= tol and _err(want_lse, lse) <= LSE_TOL, case
    return flash_fwd.rect_plan(dtype, b * h, sq, kb.shape[1], d, flash_fwd._sm_count(0), causal,
                               window, q_start, k_start)


@pytest.mark.cuda
@pytest.mark.parametrize("d", flash_fwd.HEAD_DIMS)
def test_tensor_core_general_kernel_matches_plain(cuda, monkeypatch, d):
    """bf16 on the tensor cores at both tile heights (a card of very many
    SMs takes 64-row tiles, one of a single SM 128), at the cases of
    test_general_kernel_matches_plain and the masks of the general pair,
    GQA groups of 1, 2 and 4."""
    ids = {s: {kind: _seg_ids(kind, 51, 2, s) for kind in (None, "random", "docs")}
           for s in (1, 100, 130, 300)}
    for block, sms in ((64, 10**9), (128, 1)):
        monkeypatch.setattr(flash_fwd, "_sm_count", lambda index, sms=sms: sms)
        for s in ids:
            for name, (causal, window, kind) in RECT_MASKS.items():
                for h_kv in (4, 2, 1):
                    plan = _rect_fwd_check(52, 2, s, 4, d, h_kv, causal, window=window,
                                           seg=ids[s][kind])
                    assert (plan.block_m, plan.swizzle) == (block, 2 * min(d, 64)), name
        for sq, sk, q_start, k_start in ((8, 64, 16, 0), (8, 64, 56, 0), (24, 80, 0, 10),
                                         (70, 130, 60, 0), (130, 100, 0, 0), (100, 300, 200, 0)):
            for causal in (True, False):
                _rect_fwd_check(53, 2, sq, 4, d, 2, causal, q_start, k_start, sk=sk)


@pytest.mark.cuda
@pytest.mark.parametrize("h_kv", [4, 2])
def test_tensor_core_general_kernel_at_the_packed_burnin_shape(cuda, h_kv):
    from tpu_operator_torch.workloads.burnin import _packed_ids

    seg = _packed_ids(8, 128, 2, "cuda")  # the packed train step: two 64-token documents
    assert _rect_fwd_check(54, 8, 128, 4, 64, h_kv, True, seg=seg).block_m == 64


@pytest.mark.cuda
def test_tensor_core_general_kernel_at_long_context(cuda):
    assert _rect_fwd_check(55, 1, 4096, 8, 128, 8, False).block_m == 128


@pytest.mark.cuda
@pytest.mark.parametrize("sq, sk, q_start, k_start", [
    (512, 512, 512, 0),      # a past ring hop: every key before every row, every tile fast
    (512, 512, 1024, 512),   # the same hop further along the ring
    (512, 512, 0, 512),      # a future hop: no row sees a key
    (128, 1024, 896, 0),     # a chunked prefill: the causal edge on the last key tile
    (100, 1000, 900, 0),     # a ragged chunk
])
def test_tensor_core_general_kernel_at_global_offsets(cuda, sq, sk, q_start, k_start):
    for h_kv in (4, 1):
        _rect_fwd_check(56, 1, sq, 4, 128, h_kv, True, q_start, k_start, sk=sk)


@pytest.mark.cuda
@pytest.mark.parametrize("k_start", [40, 100, 200])
def test_tensor_core_general_kernel_rows_that_see_no_key(cuda, monkeypatch, k_start):
    """Rows before k_start see no key: O = 0 and lse = -inf, whether their
    q tile walks no key tile at all (no TMA is issued) or walks tiles that
    only its later rows see."""
    for sms in (10**9, 1):
        monkeypatch.setattr(flash_fwd, "_sm_count", lambda index, sms=sms: sms)
        qb, kb, vb, h, hk = _qkv(57, 1, 200, 2, 64, torch.bfloat16)
        out, lse = flash_fwd.flash_fwd_rect(qb, kb, vb, h, hk, True, k_start=k_start)
        torch.cuda.synchronize()
        dead = min(k_start, 200)
        assert torch.all(out[:, :dead] == 0) and torch.all(torch.isneginf(lse[:, :dead]))
        assert torch.all(torch.isfinite(lse[:, dead:]))
        want, want_lse = flash_fwd.attention_plain(qb, kb, vb, h, hk, True, k_start=k_start)
        assert _err(want, out) <= BF16_TOL and _err(want_lse, lse) <= LSE_TOL


@pytest.mark.cuda
def test_tensor_core_general_kernel_rejects_a_misaligned_base(cuda):
    qb, kb, vb, h, hk = _qkv(58, 1, 64, 2, 64, torch.bfloat16, sk=128)
    for which in range(3):
        args = [qb, kb, vb]
        flat = torch.empty(args[which].numel() + 1, dtype=torch.bfloat16, device="cuda")
        args[which] = flat[1:].view(args[which].shape).copy_(args[which])  # 2 bytes off
        before = flash_fwd.flash_fwd_rect.launches
        with pytest.raises(ValueError, match="16-byte"):
            flash_fwd.flash_fwd_rect(*args, h, hk, True, q_start=64)
        assert flash_fwd.flash_fwd_rect.launches == before


@pytest.mark.cuda
def test_f32_general_kernel_stays_on_the_cuda_cores(cuda):
    for causal, window, q_start, sq, sk in ((False, None, 0, 100, 100), (True, 33, 0, 100, 100),
                                            (True, None, 16, 8, 64)):
        plan = _rect_fwd_check(59, 2, sq, 4, 64, 2, causal, q_start, window=window, sk=sk,
                               dtype=torch.float32)
        assert (plan.block_m, plan.threads, plan.swizzle) == (64, 256, 0)


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take(cuda):
    qb, kb, vb, h, hk = _qkv(14, 1, 16, 2, 8, torch.float32)
    with pytest.raises(ValueError):
        flash_fwd.flash_fwd_tri(qb, kb, vb, h, hk)          # head_dim 8
    qb, kb, vb, h, hk = _qkv(14, 1, 16, 2, 16, torch.float16)
    with pytest.raises(ValueError):
        flash_fwd.flash_fwd_rect(qb, kb, vb, h, hk, False)  # float16
    qb, kb, vb, h, hk = _qkv(14, 1, 16, 2, 16, torch.float32)
    with pytest.raises(ValueError):
        flash_fwd.flash_fwd_tri(qb, kb[:, :8].contiguous(), vb[:, :8].contiguous(), h, hk)


def _bwd_inputs(seed, b, s, h, d, dtype, h_kv, causal=True, window=None, seg=None, tri=False):
    """(qb, kb, vb, out, dout, lse, delta, h, h_kv): the forward kernel's
    out and lse on random inputs, and a random output cotangent."""
    qb, kb, vb, h, hk = _qkv(seed, b, s, h, d, dtype, h_kv=h_kv)
    rng = np.random.default_rng(seed + 1)
    dout = torch.from_numpy(rng.standard_normal(qb.shape).astype(np.float32)).to("cuda", dtype)
    if tri:
        out, lse = flash_fwd.flash_fwd_tri(qb, kb, vb, h, hk)
    else:
        out, lse = flash_fwd.flash_fwd_rect(qb, kb, vb, h, hk, causal, window=window, seg=seg)
    delta = (dout.float() * out.float()).sum(-1)
    return qb, kb, vb, out, dout, lse, delta, h, hk


def _check_grads(want, got, dtype, case):
    """f32: absolute error; bf16: error over the largest |gradient| of the
    three (one gradient may be exactly zero, e.g. dq with a single key)."""
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    scale = 1.0 if dtype == "float32" else max(float(w.float().abs().max()) for w in want)
    for name, w, g in zip(("dq", "dk", "dv"), want, got):
        assert g.dtype == w.dtype and g.shape == w.shape, (name, case)
        err = float((w.float() - g.float()).abs().max()) / scale
        assert err <= tol, (name, case, err)


@pytest.mark.cuda
@pytest.mark.parametrize("d", flash_fwd.HEAD_DIMS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_backward_triangle_kernels_match_plain(cuda, d, dtype):
    for s, h, h_kv in ((100, 2, 2), (128, 4, 2), (200, 4, 1), (1, 1, 1)):
        qb, kb, vb, out, dout, lse, delta, h_, hk = _bwd_inputs(
            15, 2, s, h, d, DTYPES[dtype], h_kv, tri=True)
        before = (flash_bwd.flash_bwd_dq_tri.launches, flash_bwd.flash_bwd_dkv_tri.launches)
        dq = flash_bwd.flash_bwd_dq_tri(qb, kb, vb, out, dout, lse, delta, h_, hk)
        dk, dv = flash_bwd.flash_bwd_dkv_tri(qb, kb, vb, out, dout, lse, delta, h_, hk)
        want = flash_bwd.attention_bwd_plain(qb, kb, vb, out, lse, dout, h_, hk, True)
        torch.cuda.synchronize()
        assert (flash_bwd.flash_bwd_dq_tri.launches,
                flash_bwd.flash_bwd_dkv_tri.launches) == (before[0] + 1, before[1] + 1)
        _check_grads(want, (dq, dk, dv), dtype, (s, h, h_kv))


def _tc_pair_check(seed, b, s, h, d, h_kv):
    """The bf16 triangle pair against attention_bwd_plain, one launch of
    each kernel; returns the (dq, dkv) launch plans it ran with."""
    qb, kb, vb, out, dout, lse, delta, h_, hk = _bwd_inputs(
        seed, b, s, h, d, torch.bfloat16, h_kv, tri=True)
    before = (flash_bwd.flash_bwd_dq_tri.launches, flash_bwd.flash_bwd_dkv_tri.launches)
    dq = flash_bwd.flash_bwd_dq_tri(qb, kb, vb, out, dout, lse, delta, h_, hk)
    dk, dv = flash_bwd.flash_bwd_dkv_tri(qb, kb, vb, out, dout, lse, delta, h_, hk)
    want = flash_bwd.attention_bwd_plain(qb, kb, vb, out, lse, dout, h_, hk, True)
    torch.cuda.synchronize()
    assert (flash_bwd.flash_bwd_dq_tri.launches,
            flash_bwd.flash_bwd_dkv_tri.launches) == (before[0] + 1, before[1] + 1)
    _check_grads(want, (dq, dk, dv), "bfloat16", (b, s, h, d, h_kv))
    return flash_bwd.tri_bwd_plan(torch.bfloat16, b * h, b * h_kv, s, d,
                                  torch.cuda.get_device_properties(0).multi_processor_count)


@pytest.mark.cuda
@pytest.mark.parametrize("d", flash_fwd.HEAD_DIMS)
@pytest.mark.parametrize("s", TC_LENGTHS)
def test_tensor_core_backward_pair_matches_plain(cuda, d, s):
    dq_plan, dkv_plan = _tc_pair_check(31, 2, s, 4, d, 2)
    assert (dq_plan.block, dkv_plan.block) == (64, 64)
    # 256 (batch, head) rows and as many kv rows: 128-row tiles in several waves
    dq_plan, dkv_plan = _tc_pair_check(32, 16, s, 16, d, 16)
    assert (dq_plan.block, dkv_plan.block) == (128, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("h_kv", [4, 2])  # GQA groups of 2 and 4 summed inside a dK/dV CTA
def test_tensor_core_backward_pair_sums_gqa_groups(cuda, h_kv):
    _tc_pair_check(33, 2, 200, 8, 64, h_kv)
    _tc_pair_check(34, 1, 1000, 8, 128, h_kv)


@pytest.mark.cuda
@pytest.mark.parametrize("h_kv", [4, 2])
def test_tensor_core_backward_pair_at_the_burnin_shape(cuda, h_kv):
    dq_plan, dkv_plan = _tc_pair_check(35, 8, 128, 4, 64, h_kv)  # the train step's shape
    assert (dq_plan.block, dkv_plan.block) == (64, 64)


@pytest.mark.cuda
def test_tensor_core_backward_pair_at_long_context(cuda):
    dq_plan, dkv_plan = _tc_pair_check(36, 1, 4096, 8, 128, 8)
    assert (dq_plan.block, dkv_plan.block) == (128, 128)


@pytest.mark.cuda
def test_tensor_core_backward_pair_rejects_a_misaligned_base(cuda):
    args = list(_bwd_inputs(37, 1, 64, 2, 64, torch.bfloat16, 2, tri=True))
    for which in (0, 1, 2, 4):  # q, k, v, dout
        moved = list(args)
        flat = torch.empty(args[which].numel() + 1, dtype=torch.bfloat16, device="cuda")
        moved[which] = flat[1:].view(args[which].shape).copy_(args[which])  # 2 bytes off
        for fn in (flash_bwd.flash_bwd_dq_tri, flash_bwd.flash_bwd_dkv_tri):
            before = fn.launches
            with pytest.raises(ValueError, match="16-byte"):
                fn(*moved)
            assert fn.launches == before


@pytest.mark.cuda
def test_flash_core_aligns_an_offset_cotangent(cuda):
    """_FlashCore's backward handed a dO that is a contiguous view 2 bytes
    off its allocation still runs both tensor-core kernels, with the right
    gradients."""
    from tpu_operator_torch.workloads.flashattention import _FlashCore

    qb, kb, vb, h, hk = _qkv(38, 2, 200, 4, 64, torch.bfloat16, h_kv=2)
    rng = np.random.default_rng(39)
    g = torch.from_numpy(rng.standard_normal(qb.shape).astype(np.float32)).to("cuda", qb.dtype)
    flat = torch.empty(g.numel() + 1, dtype=g.dtype, device="cuda")
    g_off = flat[1:].view(g.shape).copy_(g)
    assert g_off.is_contiguous() and g_off.data_ptr() % 16 == 2
    leaves = [x.clone().requires_grad_(True) for x in (qb, kb, vb)]
    before = (flash_bwd.flash_bwd_dq_tri.launches, flash_bwd.flash_bwd_dkv_tri.launches)
    out = _FlashCore.apply(*leaves, None, True, 200, 200, h, hk, None)
    got = torch.autograd.grad(out, leaves, g_off)
    torch.cuda.synchronize()
    assert (flash_bwd.flash_bwd_dq_tri.launches,
            flash_bwd.flash_bwd_dkv_tri.launches) == (before[0] + 1, before[1] + 1)
    _, lse = flash_fwd.flash_fwd_tri(qb, kb, vb, h, hk)
    want = flash_bwd.attention_bwd_plain(qb, kb, vb, out.detach(), lse, g, h, hk, True)
    _check_grads(want, got, "bfloat16", "offset cotangent")


@pytest.mark.cuda
@pytest.mark.parametrize("d", flash_fwd.HEAD_DIMS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_backward_general_kernels_match_plain(cuda, d, dtype):
    seg = torch.tensor([[0] * 37 + [1] * 93, [0] * 70 + [1] * 60], dtype=torch.int32, device="cuda")
    cases = [
        dict(causal=False),
        dict(causal=True),
        dict(causal=True, window=33),
        dict(causal=True, window=200),
        dict(causal=True, seg=seg),
        dict(causal=False, seg=seg),
        dict(causal=True, window=7, seg=seg),
    ]
    for case in cases:
        qb, kb, vb, out, dout, lse, delta, h, hk = _bwd_inputs(
            16, 2, 130, 4, d, DTYPES[dtype], 2, **case)
        args = (case["causal"], case.get("window"), case.get("seg"))
        before = (flash_bwd.flash_bwd_dq_rect.launches, flash_bwd.flash_bwd_dkv_rect.launches)
        dq = flash_bwd.flash_bwd_dq_rect(qb, kb, vb, out, dout, lse, delta, h, hk, *args)
        dk, dv = flash_bwd.flash_bwd_dkv_rect(qb, kb, vb, out, dout, lse, delta, h, hk, *args)
        want = flash_bwd.attention_bwd_plain(qb, kb, vb, out, lse, dout, h, hk, *args)
        torch.cuda.synchronize()
        assert (flash_bwd.flash_bwd_dq_rect.launches,
                flash_bwd.flash_bwd_dkv_rect.launches) == (before[0] + 1, before[1] + 1)
        _check_grads(want, (dq, dk, dv), dtype, {k: v for k, v in case.items() if k != "seg"})


# the general pair's masks: name -> (causal, window, segment ids: None,
# "random" ids 0-2 at every position, or "docs", 64-token documents whose
# tiles are uniform, so that tiles of two documents are dead)
RECT_MASKS = {
    "full": (False, None, None),
    "causal": (True, None, None),
    "window 7": (True, 7, None),
    "window 33": (True, 33, None),
    "window 200": (True, 200, None),
    "causal, random segments": (True, None, "random"),
    "full, random segments": (False, None, "random"),
    "causal, 64-token documents": (True, None, "docs"),
    "window 33, 64-token documents": (True, 33, "docs"),
    "full, 64-token documents": (False, None, "docs"),
}


def _seg_ids(kind, seed, b, s):
    if kind is None:
        return None
    if kind == "docs":
        ids = np.broadcast_to(np.arange(s) // 64, (b, s))
    else:
        ids = np.random.default_rng(seed).integers(0, 3, (b, s))
    return torch.from_numpy(np.ascontiguousarray(ids).astype(np.int32)).to("cuda")


def _rect_pair_check(seed, b, s, h, d, h_kv, causal, window, seg, dtype=torch.bfloat16):
    """The general pair against attention_bwd_plain, one launch of each
    kernel; returns the (dq, dkv) launch plans it ran with."""
    qb, kb, vb, out, dout, lse, delta, h_, hk = _bwd_inputs(
        seed, b, s, h, d, dtype, h_kv, causal=causal, window=window, seg=seg)
    args = (causal, window, seg)
    before = (flash_bwd.flash_bwd_dq_rect.launches, flash_bwd.flash_bwd_dkv_rect.launches)
    dq = flash_bwd.flash_bwd_dq_rect(qb, kb, vb, out, dout, lse, delta, h_, hk, *args)
    dk, dv = flash_bwd.flash_bwd_dkv_rect(qb, kb, vb, out, dout, lse, delta, h_, hk, *args)
    want = flash_bwd.attention_bwd_plain(qb, kb, vb, out, lse, dout, h_, hk, *args)
    torch.cuda.synchronize()
    assert (flash_bwd.flash_bwd_dq_rect.launches,
            flash_bwd.flash_bwd_dkv_rect.launches) == (before[0] + 1, before[1] + 1)
    _check_grads(want, (dq, dk, dv), "float32" if dtype == torch.float32 else "bfloat16",
                 (b, s, h, d, h_kv, causal, window, seg is not None))
    return flash_bwd.rect_bwd_plan(dtype, b * h, b * h_kv, s, d, flash_bwd._sm_count(0), causal,
                                   window)


@pytest.mark.cuda
@pytest.mark.parametrize("d", flash_fwd.HEAD_DIMS)
@pytest.mark.parametrize("s", (1, 100, 130, 1000))
def test_tensor_core_general_pair_matches_plain(cuda, monkeypatch, d, s):
    """bf16 on the tensor cores at both tile heights (a card of very many
    SMs takes 64-row tiles, one of a single SM 128), every mask, GQA groups
    of 1, 2 and 4."""
    for block, sms in ((64, 10**9), (128, 1)):
        monkeypatch.setattr(flash_bwd, "_sm_count", lambda index, sms=sms: sms)
        for name, (causal, window, kind) in RECT_MASKS.items():
            for h_kv in (4, 2, 1):
                plans = _rect_pair_check(41, 2, s, 4, d, h_kv, causal, window,
                                         _seg_ids(kind, 42, 2, s))
                assert [p.block for p in plans] == [block, block], name


@pytest.mark.cuda
@pytest.mark.parametrize("h_kv", [4, 2])
def test_tensor_core_general_pair_at_the_packed_burnin_shape(cuda, h_kv):
    from tpu_operator_torch.workloads.burnin import _packed_ids

    seg = _packed_ids(8, 128, 2, "cuda")  # the packed train step: two 64-token documents
    dq_plan, dkv_plan = _rect_pair_check(43, 8, 128, 4, 64, h_kv, True, None, seg)
    assert (dq_plan.block, dkv_plan.block) == (64, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("s", (100, 1000))
def test_f32_general_pair_stays_on_the_cuda_cores(cuda, s):
    for name, (causal, window, kind) in RECT_MASKS.items():
        plans = _rect_pair_check(44, 2, s, 4, 64, 2, causal, window, _seg_ids(kind, 45, 2, s),
                                 dtype=torch.float32)
        assert [(p.block, p.swizzle) for p in plans] == [(64, 0), (64, 0)], name


@pytest.mark.cuda
def test_tensor_core_general_pair_rejects_a_misaligned_base(cuda):
    seg = _seg_ids("docs", 0, 1, 128)
    args = list(_bwd_inputs(46, 1, 128, 2, 64, torch.bfloat16, 2, causal=True, seg=seg))
    for which in (0, 1, 2, 4):  # q, k, v, dout
        moved = list(args)
        flat = torch.empty(args[which].numel() + 1, dtype=torch.bfloat16, device="cuda")
        moved[which] = flat[1:].view(args[which].shape).copy_(args[which])  # 2 bytes off
        for fn in (flash_bwd.flash_bwd_dq_rect, flash_bwd.flash_bwd_dkv_rect):
            before = fn.launches
            with pytest.raises(ValueError, match="16-byte"):
                fn(*moved, True, None, seg)
            assert fn.launches == before


@pytest.mark.cuda
def test_flash_attention_gradients_match_dense(cuda):
    """autograd through flash_attention (forward and backward kernels)
    against autograd through dense attention, f32, as the reference's own
    gradient test does."""
    rng = np.random.default_rng(7)
    q, k, v, w = (torch.from_numpy(rng.standard_normal((1, 256, 2, 64)).astype(np.float32))
                  .to("cuda") for _ in range(4))
    grads = {}
    for name, attn in (("flash", flash_attention), ("dense", dense_attention)):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        (attn(*leaves, causal=True) * w).sum().backward()
        grads[name] = [x.grad for x in leaves]
    for got, want in zip(grads["flash"], grads["dense"]):
        assert float((got - want).abs().max()) <= F32_TOL


@pytest.mark.cuda
def test_backward_kernels_reject_what_they_do_not_take(cuda):
    qb, kb, vb, out, dout, lse, delta, h, hk = _bwd_inputs(17, 1, 16, 2, 16, torch.float32, 2)
    with pytest.raises(ValueError):  # lse in the wrong dtype
        flash_bwd.flash_bwd_dq_tri(qb, kb, vb, out, dout, lse.double(), delta, h, hk)
    with pytest.raises(ValueError):  # dout not like q
        flash_bwd.flash_bwd_dkv_tri(qb, kb, vb, out, dout[:, :8].contiguous(), lse, delta, h, hk)
    with pytest.raises(ValueError):  # sq != sk
        flash_bwd.flash_bwd_dq_rect(qb, kb[:, :8].contiguous(), vb[:, :8].contiguous(), out,
                                    dout, lse, delta, h, hk, False)
    with pytest.raises(ValueError):  # segment ids not int32
        flash_bwd.flash_bwd_dkv_rect(qb, kb, vb, out, dout, lse, delta, h, hk, True,
                                     seg=torch.zeros((1, 16), dtype=torch.int64, device="cuda"))


# name -> (shape, element offsets of x, y and out from their allocations):
# an offset shared by all three takes a scalar head, the float4 body and a
# scalar tail; offsets that differ take the scalar loop throughout
TRIAD_CASES = {
    "exporter (16384, 1024)": ((16384, 1024), (0, 0, 0)),
    "1000003, all offset by one": ((1_000_003,), (1, 1, 1)),
    "999999, x offset by one": ((999_999,), (1, 0, 0)),
    "7, all offset by three": ((7,), (3, 3, 3)),
    "4, all offset by three (no whole float4)": ((4,), (3, 3, 3)),
}


def _floats(seed, shape, offset):
    n = math.prod(shape)
    rng = np.random.default_rng(seed)
    flat = torch.from_numpy(rng.standard_normal(n + offset).astype(np.float32)).to("cuda")
    return flat[offset:].view(shape)


@pytest.mark.cuda
@pytest.mark.parametrize("inplace", [False, True])
@pytest.mark.parametrize("case", sorted(TRIAD_CASES))
def test_triad_kernel_matches_plain_bitwise(cuda, case, inplace):
    shape, offsets = TRIAD_CASES[case]
    x, y, out = (_floats(seed, shape, off) for seed, off in zip((21, 22, 23), offsets))
    want = triad.triad_plain(x, y, 0.3)
    if inplace:
        out = x
    before = triad.triad_kernel.launches
    got = triad.triad_kernel(x, y, 0.3, out)
    torch.cuda.synchronize()
    assert got is out and triad.triad_kernel.launches == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_triad_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.ones((64, 128), device="cuda")
    b = x.to(torch.bfloat16)
    flat = torch.ones(1000, device="cuda")
    for args in (
        (b, b, 2.0, b),                                                  # bfloat16
        (x.t(), x.t(), 2.0, torch.empty((128, 64), device="cuda")),       # not contiguous
        (x, x[:32], 2.0, x),                                             # shapes differ
        (flat[:999], torch.ones(999, device="cuda"), 2.0, flat[1:]),     # out overlaps x
        (x, x, 2.0, torch.empty((64, 128))),                             # out on the CPU
    ):
        with pytest.raises(ValueError):
            triad.triad_kernel(*args)


@pytest.mark.cuda
def test_probe_and_payloads_run_through_the_card(cuda):
    from tpu_operator_torch.workloads.kernels import hbm_bandwidth_probe
    from tpu_operator_torch.workloads.matmul_bench import int8_matmul_tops, matmul_tflops
    from tpu_operator_torch.workloads.smoke import run_smoke

    before = triad.triad_kernel.launches
    report = hbm_bandwidth_probe(size_mb=8, iters=4, reps=2)
    assert triad.triad_kernel.launches == before + 1 + 3 * (4 + 24)
    assert (report["platform"], report["kernel"]) == ("cuda", "triad_inplace")
    assert run_smoke(size=128)["ok"]
    assert matmul_tflops(size=1024, iters=2, reps=2)["platform"] == "cuda"
    assert int8_matmul_tops(size=1024, iters=2, reps=2)["platform"] == "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("m, k, n", [(64, 64, 64), (8, 40, 24)])
def test_int8_product_is_exact_with_either_layout(cuda, m, k, n):
    from tpu_operator_torch.workloads.serving import _int_matmul

    gen = torch.Generator(device="cuda").manual_seed(6)
    a = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=gen, device="cuda", dtype=torch.int8)
    want = a.cpu().to(torch.int32) @ b.cpu().to(torch.int32)
    for operand in (b, b.t().contiguous().t()):
        assert torch.equal(_int_matmul(a, operand).cpu(), want)


@pytest.fixture()
def one_rank_world(cuda, tmp_path):
    """A one-rank NCCL world on the card (the machine has one card)."""
    import torch.distributed as dist

    from tpu_operator_torch.workloads.distributed import init_local_world

    init_local_world(0, 1, str(tmp_path / "store"), "cuda")
    yield
    dist.destroy_process_group()


@pytest.mark.cuda
def test_one_rank_sharded_step_equals_the_no_mesh_step(one_rank_world):
    """The sharded code on a 1x1x1x1 mesh adds no arithmetic: the MoE +
    GQA + packed step (the general pair on the card) gives the no-mesh
    step's losses within 1e-6."""
    from tpu_operator_torch.workloads.burnin import BurninConfig, build_train_step, make_mesh_4d

    cfg = BurninConfig(d_model=64, n_heads=4, d_ff=128, seq_len=128, batch=2, n_layers=2,
                       use_flash_attention=True, moe_experts=4, kv_heads=2, packed_segments=2)
    mesh = make_mesh_4d(data=1, sp=1, model=1, ep=1)
    curves = []
    before = flash_fwd.flash_fwd_rect.launches
    for kwargs in (dict(), dict(mesh=mesh)):
        step, params, batch = build_train_step(cfg, "cuda", **kwargs)
        losses = []
        for _ in range(3):
            params, loss = step(params, batch)
            losses.append(float(loss))
        curves.append(losses)
    assert flash_fwd.flash_fwd_rect.launches == before + 2 * 2 * 3
    assert curves[1][-1] < curves[1][0]
    assert max(abs(a - b) / abs(b) for a, b in zip(curves[1], curves[0])) <= 1e-6, curves


@pytest.mark.cuda
@pytest.mark.parametrize("causal, kernel", [(True, "flash_fwd_tri"), (False, "flash_fwd_rect")])
def test_ring_flash_check_on_the_card(one_rank_world, causal, kernel):
    from tpu_operator_torch.workloads.ringattention import run_ring_attention_check

    before = getattr(flash_fwd, kernel).launches
    report = run_ring_attention_check(seq_len=256, causal=causal, local_impl="flash")
    assert report["ok"] and report["max_abs_err"] < 2e-4
    assert getattr(flash_fwd, kernel).launches == before + 1


@pytest.mark.cuda
def test_allreduce_on_a_one_rank_nccl_world(one_rank_world):
    """The one-rank all-reduce still calls NCCL (a local copy, so no rate
    is held to the link's peak)."""
    from tpu_operator_torch.workloads.allreduce import run_allreduce

    report = run_allreduce(sizes_mb=(1, 4), iters=4)
    assert report["ok"] and report["devices"] == 1 and report["platform"] == "cuda"
    assert report["correctness_only"]
    assert all(r["algbw_gbps"] == r["busbw_gbps"] > 0 for r in report["results"])


@pytest.mark.cuda
def test_collectives_and_fabric_on_a_one_rank_nccl_world(one_rank_world):
    from tpu_operator_torch.workloads.collectives import run_collectives_check
    from tpu_operator_torch.workloads.fabric import run_fabric_probe

    report = run_collectives_check()
    assert report["ok"] and report["devices"] == 1
    assert max(report["errors"].values()) <= 1e-5
    probe = run_fabric_probe("1x1x1")
    assert probe["ok"] and probe["edges"] == {} and probe["platform"] == "cuda"


TRIANGLE_KERNELS = (flash_fwd.flash_fwd_tri, flash_bwd.flash_bwd_dq_tri,
                    flash_bwd.flash_bwd_dkv_tri)
OTHER_KERNELS = (flash_fwd.flash_fwd_rect, flash_bwd.flash_bwd_dq_rect,
                 flash_bwd.flash_bwd_dkv_rect, triad.triad_kernel)
TRAINER_CONFIG = {"d_model": 64, "n_heads": 2, "d_ff": 128, "seq_len": 128, "batch": 2,
                  "n_layers": 2, "use_flash_attention": True}


def _launches():
    return [k.launches for k in TRIANGLE_KERNELS + OTHER_KERNELS]


def _assert_trainer_launches(before, steps):
    """Each triangle kernel once per layer (2) and executed step, no other."""
    torch.cuda.synchronize()
    got = [a - b for a, b in zip(_launches(), before)]
    assert got == [2 * steps] * len(TRIANGLE_KERNELS) + [0] * len(OTHER_KERNELS), got


@pytest.mark.cuda
def test_trainer_fault_and_resume_on_the_card(cuda, tmp_path):
    """The elastic trainer on the card (one rank, in process, no device
    named): an injected fault, a resume to the checkpoint, re-executed
    steps with the losses of their first run."""
    from tpu_operator_torch.workloads.checkpoint import CheckpointStore
    from tpu_operator_torch.workloads.training import (
        ResumableTrainer,
        TrainerError,
        trainer_config,
        verify_continuity,
    )

    trainer = ResumableTrainer(CheckpointStore(str(tmp_path)), trainer_config(TRAINER_CONFIG),
                               total_steps=8, checkpoint_every=3, fail_at_steps=(6,))
    before = _launches()
    assert trainer.resume(1).world == 1
    with pytest.raises(TrainerError, match="step 6"):
        trainer.run(8)
    assert (trainer.step, trainer.checkpoint_step) == (5, 3)
    assert trainer.resume(1).step == 3
    trainer.run(8)
    assert trainer.done
    _assert_trainer_launches(before, len(trainer.history))
    report = verify_continuity(trainer.history, trainer.checkpoints, 8)
    assert report["ok"] and report["rewinds"] == 1 and report["max_lost_steps"] == 2, report
    first = {h["step"]: h["loss"] for h in trainer.history[:5]}
    assert all(h["loss"] == first[h["step"]] for h in trainer.history[5:7])


@pytest.mark.cuda
def test_job_worker_on_the_card(cuda, tmp_path):
    """JobWorkerMain (no device named) under a stub apiserver client: one
    gang member on one card trains the job to complete."""
    from chip_smoke import _DictClient
    from tpu_operator_torch import consts
    from tpu_operator_torch.dataplane.worker import JobWorkerMain

    client = _DictClient()
    client.create({"apiVersion": "v1", "kind": "Node", "metadata": {"name": "n0"}})
    client.create({"apiVersion": consts.TPU_JOB_API_VERSION, "kind": consts.TPU_JOB_KIND,
                   "metadata": {"name": "job"},
                   "spec": {"workload": {"steps": 6, "config": TRAINER_CONFIG},
                            "checkpoint": {"everySteps": 3}}})
    client.create({"apiVersion": consts.TPU_SLICE_API_VERSION, "kind": consts.TPU_SLICE_KIND,
                   "metadata": {"name": "job" + consts.JOB_SLICE_SUFFIX},
                   "status": {"placement": {"phase": "Scheduled", "nodes": ["n0"]}}})
    main = JobWorkerMain(client, "ns", {consts.WORKER_ENV_JOB_NAME: "job",
                                        consts.WORKER_ENV_CHECKPOINT_DIR: str(tmp_path)})
    before = _launches()
    for _ in range(10):
        if main.step():
            break
    assert main.trainer.done and len(main.trainer.history) == 6
    _assert_trainer_launches(before, 6)
    data = client.get_or_none("v1", "ConfigMap", "job" + consts.JOB_PROGRESS_SUFFIX, "ns")["data"]
    assert data[consts.JOB_PROGRESS_STATUS] == consts.JOB_PROGRESS_COMPLETE
    assert data[consts.JOB_PROGRESS_STEP] == "6" and data[consts.JOB_PROGRESS_EPOCH] == "2"
