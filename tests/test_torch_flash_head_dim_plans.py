"""Launch plans at every head dim the flash kernels take, the zero-padded
route's head dims, and the rows past 65,535 — and, on the card, the
kernels there against their plain versions. This file imports no JAX, so
its card tests run on a machine with a card and no JAX:

    python -m pytest tests/test_torch_flash_head_dim_plans.py --noconftest -q

Head dim 256 runs 64-row tiles only in bf16 (a 128-row plan's tiles pass
a block's 232,448 bytes of shared memory, or a thread's registers); its
dK/dV kernel has two consumer warpgroups per 64 keys, each on half the
head dim; the f32 backward pair takes 32-row tiles there. Head dim 512
runs 64-row tiles, a one-stage ring (32-row tiles in the backward pairs)
and two CTAs per tile on the grid's z, one per column half of the
outputs; the f32 forward takes 16-key tiles there and the f32 backward
16-row tiles. The CUDA-core
kernels put rows on the grid's y and split them into z slices of 65,535,
so any number of (batch·head) rows launches at once. Card tolerances as
``tests/test_torch_kernels.py``: O f32 1e-4, bf16 2e-2, lse 1e-3;
gradients f32 1e-4 absolute, bf16 2e-2 of the largest |gradient|.
"""

import collections
import math
import pathlib
import re

import numpy as np
import pytest
import torch

from tpu_operator_torch.kernels import flash_bwd, flash_fwd
from tpu_operator_torch.workloads import flashattention as tfa

BF16, F32 = torch.bfloat16, torch.float32
MAX_SMEM = 232_448  # bytes of shared memory a block may use on the H100
H100_SMS = 132
KERNELS = pathlib.Path(flash_fwd.__file__).parent
F32_TOL, BF16_TOL, LSE_TOL = 1e-4, 2e-2, 1e-3


def _all_plans(dtype, d, block_m, sms=H100_SMS, bh=16, s=1000):
    """Every kernel's plan at (dtype, d, block_m): both forwards and both
    pairs, as the wrappers build them."""
    return {
        "fwd tri": flash_fwd.tri_plan(dtype, bh, s, d, sms, block_m),
        "fwd rect": flash_fwd.rect_plan(dtype, bh, s, s, d, sms, True, None, 0, 0, block_m),
        **dict(zip(("dq tri", "dkv tri"),
                   flash_bwd.tri_bwd_plan(dtype, bh, bh // 2, s, d, sms, block_m))),
        **dict(zip(("dq rect", "dkv rect"),
                   flash_bwd.rect_bwd_plan(dtype, bh, bh // 2, s, d, sms, False, None, block_m))),
    }


ALLOWED = [(dtype, d, block_m) for dtype in (BF16, F32) for d in flash_fwd.NATIVE_HEAD_DIMS
           for block_m in flash_fwd.tile_heights(dtype, d)]


@pytest.mark.parametrize("dtype, d, block_m", ALLOWED)
def test_every_allowed_plan_fits_a_block(dtype, d, block_m):
    for name, plan in _all_plans(dtype, d, block_m).items():
        assert plan.smem_bytes <= MAX_SMEM, (name, plan)
        assert plan.threads <= 1024, (name, plan)


def test_the_heights_per_dtype_and_head_dim():
    assert flash_fwd.tile_heights(BF16, 256) == flash_fwd.tile_heights(BF16, 512) == (64,)
    assert all(flash_fwd.tile_heights(BF16, d) == (64, 128) for d in flash_fwd.HEAD_DIMS)
    assert all(flash_fwd.tile_heights(F32, d) == (64,) for d in flash_fwd.NATIVE_HEAD_DIMS)
    # a padded head dim answers as the one it pads to; no head dim: the union
    assert flash_fwd.tile_heights(BF16, 96) == (64, 128)
    assert flash_fwd.tile_heights(BF16, 200) == flash_fwd.tile_heights(BF16, 384) == (64,)
    assert flash_fwd.tile_heights(BF16) == (64, 128) and flash_fwd.tile_heights(F32) == (64,)


@pytest.mark.parametrize("d", [256, 129, 200])
def test_a_128_row_plan_at_head_dim_256_raises(d):
    with pytest.raises(ValueError, match="head_dim"):
        flash_fwd.check_block_m(BF16, 128, d)
    with pytest.raises(ValueError):
        flash_fwd.tri_plan(BF16, 8, 128, 256, H100_SMS, block_m=128)
    with pytest.raises(ValueError):
        flash_bwd.tri_bwd_plan(BF16, 8, 8, 128, 256, H100_SMS, block_m=128)
    q = torch.zeros((2, 8, 256), dtype=BF16)
    with pytest.raises(ValueError):  # the CPU path checks it too
        flash_fwd.flash_fwd_tri(q, q, q, 2, 2, block_m=128)


@pytest.mark.parametrize("sms", [1, H100_SMS, 10**9])
def test_the_one_wave_rule_never_picks_128_rows_at_256(sms):
    for name, plan in _all_plans(BF16, 256, None, sms=sms, bh=256, s=8192).items():
        assert getattr(plan, "block_m", getattr(plan, "block", None)) == 64, name


def test_an_autotuned_128_is_not_forced_on_head_dim_256(monkeypatch):
    from tpu_operator_torch.workloads import autotune

    monkeypatch.setattr(autotune, "tuned_flash_tile", lambda *a, **k: 128)
    assert tfa._resolve_block_m(None, BF16, 8192, 8, 256, True) is None
    assert tfa._resolve_block_m(None, BF16, 8192, 8, 96, True) == 128  # pads to 128
    assert tfa._resolve_block_m(None, F32, 8192, 8, 256, True) is None
    with pytest.raises(ValueError):
        tfa._resolve_block_m(128, BF16, 8192, 8, 256, True)


def test_plans_at_head_dim_256_by_hand():
    """The kernels' layouts at D 256 (flash_fwd.cu tc_smem_bytes, smem_bytes;
    flash_bwd.cu dq_tc_smem_bytes, dkv_tc_smem_bytes, dq_smem_bytes,
    dkv_smem_bytes)."""
    p = _all_plans(BF16, 256, None)
    # 1 KiB slack + tiles of 256 bf16 columns (512 bytes a row) + ids + 5 mbarriers
    assert p["fwd tri"].smem_bytes == 1024 + (64 + 4 * 64) * 512 + 40 == 164_904
    assert p["fwd rect"].smem_bytes == 1024 + (64 + 4 * 64) * 512 + 528 + 40 == 165_432
    assert p["dq tri"].smem_bytes == 1024 + (128 + 4 * 64) * 512 + 40 == 197_672
    assert p["dq rect"].smem_bytes == 197_672 + 528 == 198_200
    assert p["dkv tri"].smem_bytes == 197_672 + 1024 == 198_696  # + f32 lse and delta
    assert p["dkv rect"].smem_bytes == 198_696 + 528 == 199_224
    assert [p[k].threads for k in ("fwd tri", "fwd rect", "dq tri", "dkv tri")] == [
        160, 160, 160, 384]  # dK/dV: two consumer warpgroups and the producer's
    assert {p[k].swizzle for k in p} == {128}
    f = _all_plans(F32, 256, None, bh=6, s=130)
    assert f["fwd tri"].smem_bytes == 4 * ((64 + 128) * 257 + 64 * 65) + 256 == 214_272
    assert (f["dq tri"].block, f["dq tri"].grid) == (32, (5, 6))
    assert f["dq tri"].smem_bytes == 4 * (4 * 32 * 257 + 32 * 33) + 128 == 135_936
    assert (f["dkv tri"].block, f["dkv tri"].grid) == (32, (5, 3))
    assert f["dkv tri"].smem_bytes == 4 * (4 * 32 * 257 + 2 * 32 * 33 + 64) + 128 == 140_416


def test_plan_constants_match_the_cuda_sources():
    fwd, bwd = (KERNELS / "flash_fwd.cu").read_text(), (KERNELS / "flash_bwd.cu").read_text()
    header = (KERNELS / "hopper.cuh").read_text()
    assert ("__host__ __device__ constexpr int f32_tile(int d) { return d > 256 ? 16 : "
            "d > 128 ? 32 : 64; }") in bwd
    assert "constexpr int kv_split() { return D > 128 ? 2 : 1; }" in bwd
    assert [flash_bwd.f32_tile(d) for d in flash_fwd.NATIVE_HEAD_DIMS] == [64, 64, 64, 64, 32, 16]
    assert [flash_bwd.kv_split(d) for d in flash_fwd.NATIVE_HEAD_DIMS] == [1, 1, 1, 1, 2, 2]
    # every native head dim is dispatched in both libraries, both dtypes
    for src in (fwd, bwd):
        for d in flash_fwd.NATIVE_HEAD_DIMS:
            assert len(re.findall(rf"case {d}: return (?:dispatch_tc|launch)<", src)) == 2, d
    # the CUDA-core kernels' rows: y and z slices of 65,535, no row cap
    for src in (fwd, bwd):
        assert "constexpr int kMaxGridY = 65535;" in src and "blockIdx.z * kMaxGridY" in src
        assert "65535 &&" not in src and "<= 65535" not in src
    assert "m64n256k16" in header


@pytest.mark.parametrize("d, width", [(1, 16), (16, 16), (17, 32), (33, 64), (80, 128),
                                      (96, 128), (112, 128), (128, 128), (129, 256), (256, 256),
                                      (257, 512), (384, 512), (512, 512)])
def test_padded_head_dim(d, width):
    assert flash_fwd.padded_head_dim(d) == width
    # the share of the products a padded head wastes
    assert 0 <= 1 - d / width < 1


@pytest.mark.parametrize("d", [0, 513, 576, 1024, -1, True])
def test_head_dims_the_port_does_not_take_raise(d):
    with pytest.raises(ValueError, match="ROADMAP.md item 22"):
        flash_fwd.padded_head_dim(d)


def _z_slices(rows: int):
    """The (y, z) blocks of a CUDA-core kernel's grid for ``rows`` rows, as
    the kernels lay them out, and the rows they compute (past the last row:
    none)."""
    ys, zs = min(rows, 65535), -(-rows // 65535)
    return [z * 65535 + y for z in range(zs) for y in range(ys) if z * 65535 + y < rows]


@pytest.mark.parametrize("rows", [1, 65535, 65536, 65544, 3 * 65535 + 7])
def test_rows_past_65535_are_each_computed_once(rows):
    assert _z_slices(rows) == list(range(rows))
    # the plans keep the rows on the grid's y (f32) or x (bf16), uncapped
    assert flash_fwd.tri_plan(F32, rows, 16, 16, H100_SMS).grid == (1, rows)
    assert flash_fwd.tri_plan(BF16, rows, 16, 16, H100_SMS).grid == (rows, 1)
    dq, dkv = flash_bwd.tri_bwd_plan(F32, rows, rows, 16, 16, H100_SMS)
    assert dq.grid == dkv.grid == (1, rows)


def test_phase_2_counts_the_head_dim_256_instantiations():
    """chip_smoke's build phase expects one warpgroup's instantiation of
    each kernel at D 256 beside the 16 and 32 of D 16-128."""
    import chip_smoke

    assert chip_smoke.HEAD_DIM_256_INSTANTIATIONS == {"flash_fwd": 2, "flash_bwd": 4}
    labels = {chip_smoke.fwd_bf16_label(f"flash_fwd_{k}_kernelI13__nv_bfloat16Li256ELi1EE")
              for k in ("tri", "rect")}
    assert labels == {"d256_wg1", "rect_d256_wg1"}


def test_phase_3_head_dim_rows_plan_as_phase_15_runs_them():
    """chip_smoke's head-dim rows: bf16 at D 256 in 64-row tiles, the padded
    route at 128, every row's head dim up to 256, the six kernels covered."""
    import chip_smoke

    fwd, bwd = chip_smoke.HEAD_DIM_KERNEL_CASES, chip_smoke.HEAD_DIM_BWD_CASES
    assert {c["kernel"] for c in fwd} == {"flash_fwd_tri", "flash_fwd_rect"}
    assert {c["pair"] for c in bwd} == {"tri", "rect"}
    for case in fwd + bwd:
        b, s, h, d = case["q"]
        width = flash_fwd.padded_head_dim(d)
        assert width in (128, 256), case["label"]
        assert ("padded" in case["label"]) == (width != d)
        if case["dtype"] == BF16 and width == 256:
            plan = flash_fwd.tri_plan(BF16, b * h, s, width, H100_SMS)
            dq, dkv = flash_bwd.tri_bwd_plan(BF16, b * h, b * case.get("h_kv", h), s, width,
                                             H100_SMS)
            assert plan.block_m == dq.block == dkv.block == 64 and dkv.threads == 384
    assert {c["label"] for c in fwd if c.get("main")} >= {
        "gemma-2b bf16 (1,8192,8,256) h_kv 1", "phi-3-mini bf16 (1,4096,32,96) padded to 128"}


@pytest.mark.parametrize("d", [512, 257, 384])
def test_a_128_row_plan_at_head_dim_512_raises(d):
    with pytest.raises(ValueError, match="head_dim"):
        flash_fwd.check_block_m(BF16, 128, d)
    with pytest.raises(ValueError):
        flash_bwd.rect_bwd_plan(BF16, 8, 8, 128, 512, H100_SMS, True, None, block_m=128)
    q = torch.zeros((2, 8, 512), dtype=BF16)
    with pytest.raises(ValueError):  # the CPU path checks it too
        flash_fwd.flash_fwd_rect(q, q, q, 2, 2, True, block_m=128)


@pytest.mark.parametrize("sms", [1, H100_SMS, 10**9])
def test_the_one_wave_rule_never_picks_128_rows_at_512(sms):
    for name, plan in _all_plans(BF16, 512, None, sms=sms, bh=256, s=8192).items():
        assert getattr(plan, "block_m", getattr(plan, "block", None)) == 64, name


def test_an_autotuned_128_is_not_forced_on_head_dim_512(monkeypatch):
    from tpu_operator_torch.workloads import autotune

    monkeypatch.setattr(autotune, "tuned_flash_tile", lambda *a, **k: 128)
    for d in (512, 384, 257):
        for dtype in (BF16, torch.float16, F32):
            assert tfa._resolve_block_m(None, dtype, 8192, 8, d, True) is None, (dtype, d)
            assert tfa._resolve_block_m(None, dtype, 8192, 8, d, False) is None, (dtype, d)
    with pytest.raises(ValueError):
        tfa._resolve_block_m(128, BF16, 8192, 8, 512, True)


def test_plans_at_head_dim_512_by_hand():
    """The kernels' layouts at D 512 (flash_fwd.cu tc_smem_bytes, smem_bytes;
    flash_bwd.cu dq_tc_smem_bytes, dkv_tc_smem_bytes, dq_smem_bytes,
    dkv_smem_bytes): one ring stage, 32-row ring tiles in the backward
    pairs, two CTAs per tile."""
    p = _all_plans(BF16, 512, None)
    # 1 KiB slack + tiles of 512 bf16 columns (1 KiB a row) + ids + 3 mbarriers
    assert p["fwd tri"].smem_bytes == 1024 + (64 + 2 * 64) * 1024 + 24 == 197_656
    assert p["fwd rect"].smem_bytes == 197_656 + 66 * 4 == 197_920
    assert p["dq tri"].smem_bytes == 1024 + (128 + 2 * 32) * 1024 + 24 == 197_656
    assert p["dq rect"].smem_bytes == 197_656 + 34 * 4 == 197_792
    assert p["dkv tri"].smem_bytes == 197_656 + 2 * 32 * 4 == 197_912  # + f32 lse and delta
    assert p["dkv rect"].smem_bytes == 197_912 + 34 * 4 == 198_048
    assert max(plan.smem_bytes for plan in p.values()) <= MAX_SMEM
    assert [p[k].threads for k in ("fwd tri", "fwd rect", "dq tri", "dkv tri")] == [
        160, 160, 160, 384]  # dK/dV: two consumer warpgroups and the producer's
    assert {p[k].swizzle for k in p} == {128} and {p[k].col_split for k in p} == {2}
    assert [p[k].ring for k in ("dq tri", "dkv tri", "dq rect", "dkv rect")] == [32] * 4
    assert p["fwd tri"].grid == (16, 16) and p["dq tri"].grid == (16, 16)  # x, y; z = 2
    f = _all_plans(F32, 512, None, bh=6, s=130)
    assert f["fwd tri"].smem_bytes == 4 * ((64 + 32) * 513 + 64 * 17) + 64 == 201_408
    assert (f["fwd tri"].block_m, f["fwd tri"].col_split) == (64, 1)
    assert (f["dq tri"].block, f["dq tri"].grid) == (16, (9, 6))
    assert f["dq tri"].smem_bytes == 4 * (4 * 16 * 513 + 16 * 17) + 64 == 132_480
    assert (f["dkv tri"].block, f["dkv tri"].grid) == (16, (9, 3))
    assert f["dkv tri"].smem_bytes == 4 * (4 * 16 * 513 + 2 * 16 * 17 + 32) + 64 == 133_696
    # below 512 nothing of this changes
    for d in flash_fwd.NATIVE_HEAD_DIMS[:-1]:
        assert all(plan.col_split == 1 for plan in _all_plans(BF16, d, None).values()), d
        assert {plan.ring for k, plan in _all_plans(BF16, d, None).items() if "d" in k[:2]} == {64}


def test_plan_constants_at_512_match_the_cuda_sources():
    fwd, bwd = (KERNELS / "flash_fwd.cu").read_text(), (KERNELS / "flash_bwd.cu").read_text()
    header = (KERNELS / "hopper.cuh").read_text()
    for src in (fwd, bwd):
        assert "constexpr int stages() { return D > 256 ? 1 : kStages; }" in src
        assert "constexpr int col_split() { return D > 256 ? 2 : 1; }" in src
        # the D 512 library dispatches D 512 alone, the others 16-256
        assert src.count("#ifdef FLASH_HEAD_DIM_512") == 2
    assert "constexpr int ring_rows() { return D > 256 ? 32 : kTile; }" in bwd
    assert "constexpr int f32_keys(int d) { return d > 256 ? 16 : kBN; }" in fwd
    assert "m64n32k16" in header
    dims = flash_fwd.NATIVE_HEAD_DIMS
    assert [flash_fwd.ring_stages(d) for d in dims] == [2, 2, 2, 2, 2, 1]
    assert [flash_fwd.col_split(d) for d in dims] == [1, 1, 1, 1, 1, 2]
    assert [flash_fwd.f32_keys(d) for d in dims] == [64, 64, 64, 64, 64, 16]
    assert [flash_bwd.ring_rows(d) for d in dims] == [64, 64, 64, 64, 64, 32]
    assert flash_fwd.library_name("flash_fwd", BF16, 512) == "flash_fwd_d512"
    assert flash_fwd.library_name("flash_bwd", torch.float16, 512) == "flash_bwd_f16_d512"
    assert flash_fwd.library_name("flash_bwd", F32, 256) == "flash_bwd"


def _live(s, causal, window, q_rows, k_rows):
    """(q tile, key tile) pairs with some live (row, key) pair, from the
    plain versions' mask: q tiles of q_rows rows, key tiles of k_rows."""
    keep = flash_fwd.keep_mask(1, s, s, 1, causal, window=window)[0]
    return {(q, k) for q in range(-(-s // q_rows)) for k in range(-(-s // k_rows))
            if bool(keep[q * q_rows:(q + 1) * q_rows, k * k_rows:(k + 1) * k_rows].any())}


@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("s", [1, 31, 64, 100, 1000])
@pytest.mark.parametrize("causal, window", [(True, None), (False, None), (True, 33),
                                            (True, 128)])
def test_every_live_tile_pair_at_512_is_covered_once(causal, window, s, group):
    """The D 512 pairs' walks (64-row own tiles, 32-row ring tiles): every
    live pair once per column half, and no dead one."""
    tri = causal and window is None
    plans = (flash_bwd.tri_bwd_plan(BF16, 2 * group, 2, s, 512, H100_SMS) if tri else
             flash_bwd.rect_bwd_plan(BF16, 2 * group, 2, s, 512, H100_SMS, causal, window))
    dq, dkv = plans
    for plan, rows, members, (q_rows, k_rows) in ((dq, 2 * group, 1, (64, 32)),
                                                  (dkv, 2, group, (32, 64))):
        got = collections.Counter((plan.cta(x, y)[0], *v) for x in range(plan.grid[0])
                                  for y in range(plan.grid[1])
                                  for v in plan.visits(x, y, s, members))
        assert set(got.values()) == {1}
        live = _live(s, causal, plan.window, q_rows, k_rows)
        assert set(got) == {(row, m, q, k) for row in range(rows) for m in range(members)
                            for q, k in live}


def test_phase_2_counts_the_head_dim_512_instantiations():
    """chip_smoke's build phase expects the D 512 libraries to hold one
    warpgroup's instantiation of each kernel, bf16 and fp16, and no other."""
    import chip_smoke

    assert chip_smoke.HEAD_DIM_512_INSTANTIATIONS == {
        "flash_fwd_d512": 2, "flash_bwd_d512": 4, "flash_fwd_f16_d512": 2,
        "flash_bwd_f16_d512": 4}
    assert {chip_smoke.fwd_f16_label(f"flash_fwd_{k}_kernelI6__halfLi512ELi1EE")
            for k in ("tri", "rect")} == {"d512_wg1", "rect_d512_wg1"}
    assert chip_smoke.tri_bwd_bf16_label(
        "flash_bwd_dkv_rect_kernelI13__nv_bfloat16Li512ELi1EE") == "dkv_rect_d512_wg1"


def test_phase_3_head_dim_512_rows():
    """chip_smoke's D 512 rows: all six kernels in bf16 and fp16, f32 rows,
    DeepSeek-V4-Flash's (1,8192,8,512) with one kv head (plain, window 128,
    packed), ragged lengths, and the padded route at 384."""
    import chip_smoke

    fwd, bwd = chip_smoke.HEAD_DIM_512_KERNEL_CASES, chip_smoke.HEAD_DIM_512_BWD_CASES
    assert {c["kernel"] for c in fwd} == {"flash_fwd_tri", "flash_fwd_rect"}
    assert {c["pair"] for c in bwd} == {"tri", "rect"}
    for rows in (fwd, bwd):
        assert {c["dtype"] for c in rows} == {BF16, torch.float16, F32}
        assert {c["q"][1] for c in rows} >= {100, 1000, 8192}
        for case in rows:
            d = case["q"][3]
            assert flash_fwd.padded_head_dim(d) == 512, case["label"]
            assert ("padded" in case["label"]) == (d != 512)
        assert any(c["q"][3] == 384 for c in rows)
        assert any(c.get("window") == 128 and c["q"] == (1, 8192, 8, 512) for c in rows)
        for dtype in (BF16, torch.float16):
            assert any(c.get("packed") and c["dtype"] == dtype and c["q"] == (1, 8192, 8, 512)
                       for c in rows), dtype


# --------------------------------------------------------------- on the card


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _qkv(seed, b, s, h, h_kv, d, dtype):
    rng = np.random.default_rng(seed)
    shapes = ((b, s, h, d), (b, s, h_kv, d), (b, s, h_kv, d))
    return tfa._collapse_heads(*(torch.from_numpy(rng.standard_normal(x).astype(np.float32))
                                 .to("cuda", dtype) for x in shapes))


def _err(a, b):
    a, b = a.float(), b.float()
    assert torch.equal(torch.isneginf(a), torch.isneginf(b))
    inf = torch.isneginf(a)
    return float((torch.where(inf, 0.0, a) - torch.where(inf, 0.0, b)).abs().max())


MASKS = {"causal": (True, None, None), "full": (False, None, None),
         "window 33": (True, 33, None), "causal, segments": (True, None, "cut"),
         "full, segments": (False, None, "cut"), "window 7, segments": (True, 7, "cut")}


def _seg(kind, b, s):
    if kind is None:
        return None
    return (torch.arange(s, device="cuda") >= s // 3).to(torch.int32).expand(b, s).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("s, h, h_kv", [(1, 1, 1), (100, 4, 2), (200, 4, 1), (1000, 2, 2)])
def test_head_dim_256_kernels_match_plain(cuda, dtype, s, h, h_kv):
    """Both forward kernels and both backward pairs at D 256, every mask,
    GQA groups of 1, 2 and 4."""
    tol = F32_TOL if dtype == F32 else BF16_TOL
    qb, kb, vb, h_, hk = _qkv(s, 2, s, h, h_kv, 256, dtype)
    rng = np.random.default_rng(s + 1)
    dout = torch.from_numpy(rng.standard_normal(qb.shape).astype(np.float32)).to("cuda", dtype)
    for name, (causal, window, kind) in dict(MASKS, triangle=(True, None, None)).items():
        seg = _seg(kind, 2, s)
        tri = name == "triangle"
        if tri:
            out, lse = flash_fwd.flash_fwd_tri(qb, kb, vb, h_, hk)
        else:
            out, lse = flash_fwd.flash_fwd_rect(qb, kb, vb, h_, hk, causal, window=window, seg=seg)
        want, want_lse = flash_fwd.attention_plain(qb, kb, vb, h_, hk, causal, window=window,
                                                   seg=seg)
        torch.cuda.synchronize()
        assert _err(want, out) <= tol and _err(want_lse, lse) <= LSE_TOL, name
        delta = (dout.float() * out.float()).sum(-1)
        pair, extra = ("tri", ()) if tri else ("rect", (causal, window, seg))
        before = (getattr(flash_bwd, f"flash_bwd_dq_{pair}").launches,
                  getattr(flash_bwd, f"flash_bwd_dkv_{pair}").launches)
        dq = getattr(flash_bwd, f"flash_bwd_dq_{pair}")(qb, kb, vb, out, dout, lse, delta, h_, hk,
                                                        *extra)
        dk, dv = getattr(flash_bwd, f"flash_bwd_dkv_{pair}")(qb, kb, vb, out, dout, lse, delta,
                                                             h_, hk, *extra)
        want = flash_bwd.attention_bwd_plain(qb, kb, vb, out, lse, dout, h_, hk, causal, window,
                                             seg)
        torch.cuda.synchronize()
        assert (getattr(flash_bwd, f"flash_bwd_dq_{pair}").launches,
                getattr(flash_bwd, f"flash_bwd_dkv_{pair}").launches) == (before[0] + 1,
                                                                           before[1] + 1)
        scale = 1.0 if dtype == F32 else max(float(w.float().abs().max()) for w in want)
        for grad, w, g in zip(("dq", "dk", "dv"), want, (dq, dk, dv)):
            assert float((w.float() - g.float()).abs().max()) <= tol * scale, (name, grad)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, F32])
def test_rows_past_65535_launch_once(cuda, dtype):
    """65,544 (batch·head) rows: one launch of each kernel, every row right."""
    tol = F32_TOL if dtype == F32 else BF16_TOL
    qb, kb, vb, h, hk = _qkv(5, 8193, 16, 8, 8, 16, dtype)
    assert qb.shape[0] == 65_544
    for causal in (True, False):
        counts = [w.launches for w in (flash_fwd.flash_fwd_rect, flash_bwd.flash_bwd_dq_rect,
                                       flash_bwd.flash_bwd_dkv_rect)]
        out, lse = flash_fwd.flash_fwd_rect(qb, kb, vb, h, hk, causal)
        dout = torch.ones_like(qb)
        delta = (dout.float() * out.float()).sum(-1)
        dq = flash_bwd.flash_bwd_dq_rect(qb, kb, vb, out, dout, lse, delta, h, hk, causal)
        dk, dv = flash_bwd.flash_bwd_dkv_rect(qb, kb, vb, out, dout, lse, delta, h, hk, causal)
        want, want_lse = flash_fwd.attention_plain(qb, kb, vb, h, hk, causal)
        grads = flash_bwd.attention_bwd_plain(qb, kb, vb, out, lse, dout, h, hk, causal)
        torch.cuda.synchronize()
        assert [w.launches for w in (flash_fwd.flash_fwd_rect, flash_bwd.flash_bwd_dq_rect,
                                     flash_bwd.flash_bwd_dkv_rect)] == [c + 1 for c in counts]
        assert _err(want, out) <= tol and _err(want_lse, lse) <= LSE_TOL
        scale = 1.0 if dtype == F32 else max(float(w.float().abs().max()) for w in grads)
        for w, g in zip(grads, (dq, dk, dv)):
            assert float((w.float() - g.float()).abs().max()) <= tol * scale
    out, lse = flash_fwd.flash_fwd_tri(qb, kb, vb, h, hk)
    want, want_lse = flash_fwd.attention_plain(qb, kb, vb, h, hk, True)
    torch.cuda.synchronize()
    assert _err(want, out) <= tol and _err(want_lse, lse) <= LSE_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, F32])
def test_every_head_dim_up_to_256_runs_a_kernel(cuda, dtype):
    """flash_attention at each head dim 1-256 on CUDA tensors launches the
    triangle kernel once and matches dense attention; 257 raises."""
    from tpu_operator_torch.workloads.ringattention import dense_attention

    tol = F32_TOL if dtype == F32 else BF16_TOL
    gen = torch.Generator(device="cuda").manual_seed(3)
    for d in range(1, 257):
        q, k, v = (torch.randn((1, 32, 2, d), generator=gen, device="cuda").to(dtype)
                   for _ in range(3))
        before = flash_fwd.flash_fwd_tri.launches
        got = tfa.flash_attention(q, k, v, block_q=32, block_k=32)
        want = dense_attention(q.float(), k.float(), v.float(), causal=True)
        torch.cuda.synchronize()
        assert flash_fwd.flash_fwd_tri.launches == before + 1, d
        assert got.shape == q.shape and float((got.float() - want).abs().max()) <= tol, d
    q = torch.zeros((1, 32, 2, 513), device="cuda", dtype=dtype)
    with pytest.raises(ValueError, match="ROADMAP.md item 22"):
        tfa.flash_attention(q, q, q, block_q=32, block_k=32)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [80, 96, 112, 256])
def test_padded_and_wide_gradients_match_dense(cuda, d):
    """autograd through flash_attention against autograd through dense
    attention, f32, (1, 256, 2, d): the padded route (80, 96, 112) and the
    native 256, through the kernels (one launch of each of the pair)."""
    from tpu_operator_torch.workloads.ringattention import dense_attention

    rng = np.random.default_rng(d)
    q, k, v, w = (torch.from_numpy(rng.standard_normal((1, 256, 2, d)).astype(np.float32))
                  .to("cuda") for _ in range(4))
    grads = {}
    before = (flash_bwd.flash_bwd_dq_tri.launches, flash_bwd.flash_bwd_dkv_tri.launches)
    for name, attn in (("flash", tfa.flash_attention), ("dense", dense_attention)):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        grads[name] = torch.autograd.grad((attn(*leaves, causal=True) * w).sum(), leaves)
    torch.cuda.synchronize()
    assert (flash_bwd.flash_bwd_dq_tri.launches,
            flash_bwd.flash_bwd_dkv_tri.launches) == (before[0] + 1, before[1] + 1)
    for got, want in zip(grads["flash"], grads["dense"]):
        assert got.shape == want.shape and float((got - want).abs().max()) <= F32_TOL
    assert math.isfinite(float(grads["flash"][0].sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, torch.float16, F32])
@pytest.mark.parametrize("s, h, h_kv", [(1, 1, 1), (100, 4, 2), (200, 4, 1), (1000, 2, 2)])
def test_head_dim_512_kernels_match_plain(cuda, dtype, s, h, h_kv):
    """Both forward kernels and both backward pairs at D 512, every mask,
    GQA groups of 1, 2 and 4, ragged lengths: each column half of every
    output, and lse from half 0."""
    tol = F32_TOL if dtype == F32 else BF16_TOL
    qb, kb, vb, h_, hk = _qkv(s + 512, 2, s, h, h_kv, 512, dtype)
    rng = np.random.default_rng(s + 2)
    dout = torch.from_numpy(rng.standard_normal(qb.shape).astype(np.float32)).to("cuda", dtype)
    for name, (causal, window, kind) in dict(MASKS, triangle=(True, None, None)).items():
        seg = _seg(kind, 2, s)
        tri = name == "triangle"
        if tri:
            out, lse = flash_fwd.flash_fwd_tri(qb, kb, vb, h_, hk)
        else:
            out, lse = flash_fwd.flash_fwd_rect(qb, kb, vb, h_, hk, causal, window=window, seg=seg)
        want, want_lse = flash_fwd.attention_plain(qb, kb, vb, h_, hk, causal, window=window,
                                                   seg=seg)
        torch.cuda.synchronize()
        for half in (slice(0, 256), slice(256, 512)):
            assert _err(want[..., half], out[..., half]) <= tol, (name, half)
        assert _err(want_lse, lse) <= LSE_TOL, name
        delta = (dout.float() * out.float()).sum(-1)
        pair, extra = ("tri", ()) if tri else ("rect", (causal, window, seg))
        dq = getattr(flash_bwd, f"flash_bwd_dq_{pair}")(qb, kb, vb, out, dout, lse, delta, h_, hk,
                                                        *extra)
        dk, dv = getattr(flash_bwd, f"flash_bwd_dkv_{pair}")(qb, kb, vb, out, dout, lse, delta,
                                                             h_, hk, *extra)
        want = flash_bwd.attention_bwd_plain(qb, kb, vb, out, lse, dout, h_, hk, causal, window,
                                             seg)
        torch.cuda.synchronize()
        scale = 1.0 if dtype == F32 else max(float(w.float().abs().max()) for w in want)
        for grad, w, g in zip(("dq", "dk", "dv"), want, (dq, dk, dv)):
            for quarter in range(4):
                cols = slice(128 * quarter, 128 * (quarter + 1))
                assert float((w[..., cols].float() - g[..., cols].float()).abs().max()) <= \
                    tol * scale, (name, grad, quarter)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [257, 320, 384, 511, 512])
def test_head_dims_past_256_gradients_match_dense(cuda, d):
    """autograd through flash_attention against autograd through dense
    attention, f32, (1, 256, 2, d): the padded route to 512 (257-511) and
    the native 512, through the kernels (one launch of each of the pair),
    plain causal and under a window of 128 with two segments."""
    from tpu_operator_torch.workloads.ringattention import dense_attention

    rng = np.random.default_rng(d)
    q, k, v, w = (torch.from_numpy(rng.standard_normal((1, 256, 2, d)).astype(np.float32))
                  .to("cuda") for _ in range(4))
    seg = (torch.arange(256, device="cuda") >= 100).to(torch.int32)[None]
    for kwargs, pair in (({}, "tri"), ({"window": 128, "segment_ids": seg}, "rect")):
        grads = {}
        before = (getattr(flash_bwd, f"flash_bwd_dq_{pair}").launches,
                  getattr(flash_bwd, f"flash_bwd_dkv_{pair}").launches)
        for name, attn in (("flash", tfa.flash_attention), ("dense", dense_attention)):
            leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
            if name == "dense" and kwargs:
                group_out = _windowed_dense(*leaves, window=128, seg=seg)
            else:
                group_out = attn(*leaves, causal=True, **kwargs)
            grads[name] = torch.autograd.grad((group_out * w).sum(), leaves)
        torch.cuda.synchronize()
        assert (getattr(flash_bwd, f"flash_bwd_dq_{pair}").launches,
                getattr(flash_bwd, f"flash_bwd_dkv_{pair}").launches) == (before[0] + 1,
                                                                           before[1] + 1)
        for got, want in zip(grads["flash"], grads["dense"]):
            assert got.shape == want.shape and float((got - want).abs().max()) <= F32_TOL, pair


def _windowed_dense(q, k, v, window, seg):
    """Dense f32 softmax attention in (B, S, H, D) under the kernels' masks."""
    b, s, h, d = q.shape
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
    keep = flash_fwd.keep_mask(b * h, s, s, h, True, window=window, seg=seg, device=q.device)
    scores = scores.masked_fill(~keep.expand(b * h, s, s).reshape(b, h, s, s), -math.inf)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)
