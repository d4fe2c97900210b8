"""The flash kernels in float16: launch plans, libraries and the plain
versions here, and on the card the fp16 instantiations of all six kernels
against their plain PyTorch versions. This file imports no JAX, so its card
tests run on a machine with a card and no JAX:

    python -m pytest tests/test_torch_float16_kernels.py --noconftest -q

fp16 runs bf16's tensor-core design with fp16 operands: the same tile
heights, plans, shared memory and swizzles (both are 16 bits), built into
libraries of their own (``build.VARIANTS``: the same sources compiled with
``-DFLASH_ELEM_F16``) at the first fp16 call. Card tolerances as
``tests/test_torch_kernels.py``'s bf16 ones (O 2e-2, lse 1e-3, gradients 2e-2
of the largest |gradient|); fp16 keeps 11 bits where bf16 keeps 8, so on
the same inputs its error must also stay below bf16's. Where the gradients
are fp16 subnormals (a cotangent scaled by 2^-22, the size of the burn-in
loss's gradient at Phi-3-mini's width), two results that round a sum
differently differ by whole steps of 2^-24, so there the bar is those steps.
"""

import math
import stat

import numpy as np
import pytest
import torch

from tpu_operator_torch.kernels import build, flash_bwd, flash_fwd
from tpu_operator_torch.workloads.flashattention import _collapse_heads, flash_attention

F16, BF16, F32 = torch.float16, torch.bfloat16, torch.float32
H100_SMS = 132
TOL, LSE_TOL = 2e-2, 1e-3
SUBNORMAL_STEP = 2.0 ** -24  # fp16's spacing below 2^-14


# ------------------------------------------------------------ here (no card)


def test_fp16_takes_bf16s_tile_heights():
    for d in range(1, 257):  # every head dim the kernels run, padded or native
        assert flash_fwd.tile_heights(F16, d) == flash_fwd.tile_heights(BF16, d), d


def test_fp16_is_a_tensor_core_dtype_with_its_own_code():
    assert flash_fwd.TENSOR_CORE_DTYPES == (BF16, F16)
    assert flash_fwd._DTYPES == {F32: 0, BF16: 1, F16: 2}
    assert flash_fwd.tile_heights(F16) == (64, 128)
    with pytest.raises(ValueError, match="head_dim"):
        flash_fwd.check_block_m(F16, 128, 256)


SHAPES = [(8, 128, 64), (32, 4096, 128), (256, 1000, 16), (1, 1, 32), (8, 8192, 256),
          (64, 300, 96)]


@pytest.mark.parametrize("bh, s, d", SHAPES)
@pytest.mark.parametrize("block_m", [None, 64, 128])
def test_fp16_plans_are_bf16s(bh, s, d, block_m):
    width = flash_fwd.padded_head_dim(d)
    if block_m not in flash_fwd.tile_heights(BF16, width) + (None,):
        return  # D 256 takes 64-row tiles only, in both dtypes
    for causal, window in ((True, None), (False, None), (True, 33)):
        assert flash_fwd.tri_plan(F16, bh, s, width, H100_SMS, block_m) == flash_fwd.tri_plan(
            BF16, bh, s, width, H100_SMS, block_m)
        assert flash_fwd.rect_plan(F16, bh, s, s, width, H100_SMS, causal, window, 0, 0,
                                   block_m) == flash_fwd.rect_plan(
            BF16, bh, s, s, width, H100_SMS, causal, window, 0, 0, block_m)
        assert flash_bwd.tri_bwd_plan(F16, bh, bh // 2 or 1, s, width, H100_SMS, block_m) == \
            flash_bwd.tri_bwd_plan(BF16, bh, bh // 2 or 1, s, width, H100_SMS, block_m)
        assert flash_bwd.rect_bwd_plan(F16, bh, bh, s, width, H100_SMS, causal, window,
                                       block_m) == flash_bwd.rect_bwd_plan(
            BF16, bh, bh, s, width, H100_SMS, causal, window, block_m)


def test_fp16_libraries_are_variants_of_the_flash_sources():
    # the fp16 libraries, and the head dim 512 and 576 ones and the
    # D-streaming ones above 576 (bf16 + f32, fp16) beside them
    assert build.VARIANTS == {
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
        "flash_bwd_f16_wide": ("flash_bwd", ("-DFLASH_ELEM_F16", "-DFLASH_HEAD_DIM_WIDE"))}
    for name in ("flash_fwd", "flash_bwd"):
        plain, f16 = build.library_path(name), build.library_path(f"{name}_f16")
        assert plain.name.startswith(f"lib{name}-") and f16.name.startswith(f"lib{name}_f16-")
        assert plain.name[-19:] != f16.name[-19:]  # the define is in the hash
        source = build.KERNEL_DIR / f"{name}.cu"
        assert f16.name == f"lib{name}_f16-" + build.kernel_digest(
            [source], ("-DFLASH_ELEM_F16",))[:16] + ".so"
        assert plain.name == f"lib{name}-" + build.kernel_digest([source])[:16] + ".so"


def test_each_dtype_loads_its_library(monkeypatch):
    loaded = []

    class Lib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(build, "load", lambda name: loaded.append(name) or Lib())
    flash_fwd._load.cache_clear()
    flash_bwd._load.cache_clear()
    try:
        for dtype in (F32, BF16, F16, F16, BF16):
            flash_fwd._lib(dtype, 64)
            flash_bwd._lib(dtype, 256)
        # one load per library, fp16's only for fp16 (the f32 forward at 64 in
        # the wide library's tile kernels, the f32 backward at 256 in its
        # cluster kernels)
        assert loaded == ["flash_fwd_wide", "flash_bwd_wide", "flash_fwd", "flash_bwd",
                          "flash_fwd_f16", "flash_bwd_f16"]
        for dtype in (F32, BF16, F16, BF16):
            flash_fwd._lib(dtype, 512)
            flash_bwd._lib(dtype, 512)
        # and head dim 512's libraries only at 512, 16-bit only (f32 both ways
        # in the wide libraries' cluster kernels, loaded already)
        assert loaded[6:] == ["flash_fwd_d512", "flash_bwd_d512", "flash_fwd_f16_d512",
                              "flash_bwd_f16_d512"]
    finally:
        flash_fwd._load.cache_clear()
        flash_bwd._load.cache_clear()


def test_a_failed_fp16_build_raises(tmp_path, monkeypatch):
    """nvcc failing on the fp16 variant raises and names it; the define is
    on its command line; no library is left behind."""
    args = tmp_path / "args"
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(f'#!/bin/sh\necho "$@" > {args}\necho "error: refused" >&2\nexit 1\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(build, "_bound_dir", None)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="(?s)flash_fwd_f16.*refused"):
        build.build(["flash_fwd_f16"])
    line = args.read_text().split()
    assert "-DFLASH_ELEM_F16" in line and line[-1].endswith("flash_fwd.cu")
    assert not list((tmp_path / "build").glob("*.so"))


def test_fp16_cpu_tensors_run_the_plain_versions():
    """On the CPU the wrappers take the plain versions, in fp16 as in bf16,
    and launch nothing."""
    rng = np.random.default_rng(3)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((2, 64, 32)).astype(np.float32)).to(F16)
                  for _ in range(4))
    before = (flash_fwd.flash_fwd_tri.launches, flash_bwd.flash_bwd_dkv_rect.launches)
    out, lse = flash_fwd.flash_fwd_tri(q, k, v, 2, 2, block_m=128)
    want, want_lse = flash_fwd.attention_plain(q, k, v, 2, 2, causal=True)
    assert out.dtype == F16 and torch.equal(out, want) and torch.equal(lse, want_lse)
    delta = (g.float() * out.float()).sum(-1)
    dk, dv = flash_bwd.flash_bwd_dkv_rect(q, k, v, out, g, lse, delta, 2, 2, False)
    assert dk.dtype == dv.dtype == F16
    assert (flash_fwd.flash_fwd_tri.launches, flash_bwd.flash_bwd_dkv_rect.launches) == before


def test_phase_2_and_3_cover_the_fp16_instantiations():
    """chip_smoke's build phase expects the bf16 counts in fp16 (16 + 2
    forward, 32 + 4 backward), labelled from the mangled ``__half``; phase
    3's fp16 rows reach all six kernels and plan as bf16 does."""
    import chip_smoke

    assert chip_smoke.FLOAT16_TENSOR_CORE_KERNELS == {
        "flash_fwd_f16": (chip_smoke.fwd_f16_label, 18),
        "flash_bwd_f16": (chip_smoke.bwd_f16_label, 36)}
    assert chip_smoke.PEAK_FLOPS[F16] == chip_smoke.PEAK_FLOPS[BF16] == 989e12
    half = "_ZN12_GLOBAL__N_120flash_fwd_tri_kernelI6__halfLi256ELi1EEEvNS_6ParamsE14CUtensorMap_st"
    assert chip_smoke.fwd_f16_label(half) == "d256_wg1" and chip_smoke.fwd_bf16_label(half) is None
    bwd = "_ZN12_GLOBAL__N_124flash_bwd_dkv_rect_kernelI6__halfLi64ELi2EEEvNS_6ParamsE"
    assert chip_smoke.bwd_f16_label(bwd) == "dkv_rect_d64_wg2"
    assert chip_smoke.tri_bwd_bf16_label(bwd) is None
    assert chip_smoke.bwd_f16_label(bwd.replace("6__half", "13__nv_bfloat16")) is None
    fwd, pairs = chip_smoke.FLOAT16_KERNEL_CASES, chip_smoke.FLOAT16_BWD_CASES
    assert {c["kernel"] for c in fwd} == {"flash_fwd_tri", "flash_fwd_rect"}
    assert {c["pair"] for c in pairs} == {"tri", "rect"}
    assert all(c["dtype"] == F16 for c in fwd + pairs)
    assert [c for c in pairs if c.get("dout_scale")] == [
        c for c in pairs if "subnormal" in c["label"]]
    shapes = {c["q"] for c in fwd}
    assert {(8, 128, 4, 64), (1, 4096, 8, 128), (1, 4096, 32, 96), (1, 8192, 8, 256)} <= shapes
    for case in fwd + pairs:
        b, s, h, d = case["q"]
        assert ("padded" in case["label"]) == (flash_fwd.padded_head_dim(d) != d)
        width = flash_fwd.padded_head_dim(d)
        assert flash_fwd.tri_plan(F16, b * h, s, width, H100_SMS) == flash_fwd.tri_plan(
            BF16, b * h, s, width, H100_SMS)
    case = dict(q=(1, 4096, 8, 128), dtype=F16)
    assert chip_smoke._bound(case, 1000, 128) == chip_smoke._bound(dict(case, dtype=BF16), 1000,
                                                                   128)


def test_phase_16_asks_for_float16_at_phi_3_minis_widths():
    import chip_smoke

    assert chip_smoke.PHI3_MINI_F16 == dict(chip_smoke.PHI3_MINI, dtype="float16")
    assert set(chip_smoke.FLOAT16_CONFIGS) == {"plain", "gqa", "packed", "moe"}


# --------------------------------------------------------------- on the card


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _qkv(seed, b, sq, h, d, h_kv, sk=None, dtype=F16):
    rng = np.random.default_rng(seed)
    shapes = ((b, sq, h, d), (b, sk or sq, h_kv, d), (b, sk or sq, h_kv, d))
    return _collapse_heads(*(torch.from_numpy(rng.standard_normal(x).astype(np.float32))
                             .to("cuda", dtype) for x in shapes))


def _err(a, b):
    a, b = a.float(), b.float()
    assert torch.equal(torch.isneginf(a), torch.isneginf(b))
    inf = torch.isneginf(a)
    return float((torch.where(inf, 0.0, a) - torch.where(inf, 0.0, b)).abs().max())


def _seg(b, s, cut):
    return (torch.arange(s, device="cuda") >= cut).to(torch.int32).expand(b, s).contiguous()


MASKS = {  # name: (triangle, causal, window, segment cut)
    "triangle": (True, True, None, None), "causal": (False, True, None, None),
    "full": (False, False, None, None), "window 33": (False, True, 33, None),
    "segments": (False, True, None, "third"), "full, segments": (False, False, None, "third"),
}


def _forward(qb, kb, vb, h, hk, mask, seg, block_m=None):
    tri, causal, window, _ = MASKS[mask]
    if tri:
        return flash_fwd.flash_fwd_tri(qb, kb, vb, h, hk, block_m)
    return flash_fwd.flash_fwd_rect(qb, kb, vb, h, hk, causal, window=window, seg=seg,
                                    block_m=block_m)


def _fwd_err(dtype, seed, b, s, h, d, h_kv, mask, block_m=None):
    qb, kb, vb, h_, hk = _qkv(seed, b, s, h, d, h_kv, dtype=dtype)
    _, causal, window, cut = MASKS[mask]
    seg = _seg(b, s, s // 3) if cut else None
    name = "flash_fwd_tri" if MASKS[mask][0] else "flash_fwd_rect"
    before = getattr(flash_fwd, name).launches
    out, lse = _forward(qb, kb, vb, h_, hk, mask, seg, block_m)
    want, want_lse = flash_fwd.attention_plain(qb, kb, vb, h_, hk, causal, window=window, seg=seg)
    torch.cuda.synchronize()
    assert getattr(flash_fwd, name).launches == before + 1
    assert out.dtype == dtype and lse.dtype == F32
    assert _err(want_lse, lse) <= LSE_TOL, (mask, s, d)
    return _err(want, out)


@pytest.mark.cuda
@pytest.mark.parametrize("d", flash_fwd.NATIVE_HEAD_DIMS)
@pytest.mark.parametrize("mask", sorted(MASKS))
def test_fp16_forward_kernels_match_plain(cuda, d, mask):
    heights = flash_fwd.tile_heights(F16, d)
    for s, h, h_kv in ((1, 1, 1), (100, 4, 2), (200, 4, 1)):
        for block_m in heights:
            assert _fwd_err(F16, s + d, 2, s, h, d, h_kv, mask, block_m) <= TOL, (s, block_m)
    # below bf16's error on the same draws
    assert _fwd_err(F16, 7, 2, 300, 4, d, 2, mask) < _fwd_err(BF16, 7, 2, 300, 4, d, 2, mask)


@pytest.mark.cuda
@pytest.mark.parametrize("sq, sk, q_start, k_start", [(128, 128, 512, 0), (128, 1024, 896, 0),
                                                      (64, 256, 0, 0), (100, 100, 0, 200)])
def test_fp16_general_forward_at_global_offsets(cuda, sq, sk, q_start, k_start):
    qb, kb, vb, h, hk = _qkv(sq + sk, 1, sq, 4, 128, 2, sk=sk)
    out, lse = flash_fwd.flash_fwd_rect(qb, kb, vb, h, hk, True, q_start, k_start)
    want, want_lse = flash_fwd.attention_plain(qb, kb, vb, h, hk, True, q_start, k_start)
    torch.cuda.synchronize()
    assert _err(want, out) <= TOL and _err(want_lse, lse) <= LSE_TOL


def _pair(qb, kb, vb, dout, h, hk, mask, seg):
    tri, causal, window, _ = MASKS[mask]
    out, lse = _forward(qb, kb, vb, h, hk, mask, seg)
    delta = (dout.float() * out.float()).sum(-1)
    if tri:
        dq = flash_bwd.flash_bwd_dq_tri(qb, kb, vb, out, dout, lse, delta, h, hk)
        dk, dv = flash_bwd.flash_bwd_dkv_tri(qb, kb, vb, out, dout, lse, delta, h, hk)
    else:
        dq = flash_bwd.flash_bwd_dq_rect(qb, kb, vb, out, dout, lse, delta, h, hk, causal,
                                         window, seg)
        dk, dv = flash_bwd.flash_bwd_dkv_rect(qb, kb, vb, out, dout, lse, delta, h, hk, causal,
                                              window, seg)
    want = flash_bwd.attention_bwd_plain(qb, kb, vb, out, lse, dout, h, hk, causal, window, seg)
    torch.cuda.synchronize()
    return want, (dq, dk, dv)


def _bwd_rel_err(dtype, seed, b, s, h, d, h_kv, mask, dout_scale=1.0):
    """(max error over the largest |gradient|, that largest |gradient|,
    the max error, max |q|, |k|) of a pair against its plain version."""
    qb, kb, vb, h_, hk = _qkv(seed, b, s, h, d, h_kv, dtype=dtype)
    rng = np.random.default_rng(seed + 1)
    dout = (torch.from_numpy(rng.standard_normal(qb.shape).astype(np.float32)).cuda()
            * dout_scale).to(dtype)
    seg = _seg(b, s, s // 3) if MASKS[mask][3] else None
    want, got = _pair(qb, kb, vb, dout, h_, hk, mask, seg)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype == dtype and g.shape == w.shape
    scale = max(float(w.float().abs().max()) for w in want)
    worst = max(_err(w, g) for w, g in zip(want, got))
    return worst / scale, scale, worst, max(float(x.float().abs().max()) for x in (qb, kb))


@pytest.mark.cuda
@pytest.mark.parametrize("d", flash_fwd.NATIVE_HEAD_DIMS)
@pytest.mark.parametrize("mask", sorted(MASKS))
def test_fp16_backward_pairs_match_plain(cuda, d, mask):
    for s, h, h_kv in ((1, 1, 1), (100, 4, 2), (200, 8, 2), (130, 16, 16)):
        assert _bwd_rel_err(F16, s + d, 2, s, h, d, h_kv, mask)[0] <= TOL, (s, h, h_kv)
    assert (_bwd_rel_err(F16, 9, 2, 300, 4, d, 2, mask)[0]
            < _bwd_rel_err(BF16, 9, 2, 300, 4, d, 2, mask)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("mask", ["triangle", "segments"])
def test_fp16_backward_pairs_on_a_subnormal_cotangent(cuda, mask):
    """dO scaled by 2^-22: subnormal fp16 operands on the tensor cores, dS
    rounding mostly to 0 in the kernels and the plain version alike."""
    rel, scale, worst, qk = _bwd_rel_err(F16, 41, 1, 1024, 8, 128, 8, mask, 2.0 ** -22)
    assert 0 < scale < 2.0 ** -14  # every gradient is an fp16 subnormal
    assert worst <= max(TOL * scale, SUBNORMAL_STEP * (1 + qk)), (rel, worst / SUBNORMAL_STEP)


@pytest.mark.cuda
def test_fp16_flash_attention_gradients_match_dense(cuda):
    """autograd through flash_attention in fp16 against autograd through f32
    dense attention from the same fp16 inputs: within fp16's rounding of P,
    dS and the outputs, below bf16's distance."""
    rng = np.random.default_rng(43)
    arrays = [rng.standard_normal((2, 256, 4, 64)).astype(np.float32) for _ in range(4)]

    def grads(dtype, dense):
        leaves = [torch.from_numpy(a).to("cuda", dtype) for a in arrays[:3]]
        if dense:
            leaves = [x.float() for x in leaves]
        leaves = [x.requires_grad_(True) for x in leaves]
        if dense:
            s = torch.einsum("bqhd,bkhd->bhqk", leaves[0], leaves[1]) / math.sqrt(64)
            s = s.masked_fill(~torch.ones(256, 256, dtype=torch.bool, device="cuda").tril(),
                              -math.inf)
            out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), leaves[2])
        else:
            out = flash_attention(*leaves, causal=True)
        w = torch.from_numpy(arrays[3]).cuda()
        return [out.float()] + [g.float() for g in torch.autograd.grad((out.float() * w).sum(),
                                                                       leaves)]

    dist = {}
    for dtype in (F16, BF16):
        got, want = grads(dtype, False), grads(dtype, True)
        dist[dtype] = max(float((g - w).abs().max()) / float(w.abs().max())
                          for g, w in zip(got, want))
    assert dist[F16] <= TOL and dist[F16] < dist[BF16], dist


@pytest.mark.cuda
def test_fp16_kernels_reject_a_misaligned_base(cuda):
    qb, kb, vb, h, hk = _qkv(45, 1, 64, 2, 64, 2)
    flat = torch.empty(qb.numel() + 1, dtype=F16, device="cuda")
    moved = flat[1:].view(qb.shape).copy_(qb)  # 2 bytes off
    for fn in (flash_fwd.flash_fwd_tri, flash_fwd.flash_fwd_rect):
        before = fn.launches
        with pytest.raises(ValueError, match="16-byte"):
            fn(moved, kb, vb, h, hk, *(() if fn is flash_fwd.flash_fwd_tri else (True,)))
        assert fn.launches == before


@pytest.mark.cuda
def test_each_library_refuses_the_other_dtypes(cuda):
    """The C entries: the fp16 library takes dtype code 2 only, the bf16 one
    0 and 1 only (-1 for the rest), so no call reaches a kernel of another
    dtype."""
    qb, kb, vb, h, hk = _qkv(47, 1, 64, 2, 64, 2)
    out = torch.empty_like(qb)
    lse = torch.empty(qb.shape[:2], dtype=F32, device="cuda")
    plan = flash_fwd.tri_plan(F16, 2, 64, 64, H100_SMS)
    stream = torch.cuda.current_stream().cuda_stream

    def call(lib, code):
        return lib.flash_fwd_tri(qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), out.data_ptr(),
                                 lse.data_ptr(), code, 2, 64, 64, h, hk, 0.18, plan.block_m,
                                 plan.smem_bytes, plan.swizzle, stream)

    f16, bf16 = flash_fwd._lib(F16, 64), flash_fwd._lib(BF16, 64)
    assert f16 is not bf16
    assert [call(f16, code) for code in (0, 1, 3)] == [-1, -1, -1]
    assert call(bf16, 2) == -1
    assert call(f16, 2) == 0
    torch.cuda.synchronize()
