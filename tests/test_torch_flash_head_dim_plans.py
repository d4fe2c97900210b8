"""Launch plans at every head dim the flash kernels take, the zero-padded
route's head dims, and the rows past 65,535 — and, on the card, the
kernels there against their plain versions. This file imports no JAX, so
its card tests run on a machine with a card and no JAX:

    python -m pytest tests/test_torch_flash_head_dim_plans.py --noconftest -q

Head dim 256 takes ``block_m`` 64 only in bf16: the backward pairs run
64-row tiles (a 128-row plan's tiles pass a block's 232,448 bytes of shared
memory, or a thread's registers), the forwards 128-row CTAs of two consumer
warpgroups and a producer warpgroup whatever ``block_m`` says; its dK/dV
kernel has two consumer warpgroups per 64 keys, each on half the head dim; f32 at 256 and above runs the slab-cluster kernels of the wide
library, forward and backward. Head dim 512
runs 64-row tiles, a one-stage ring (32-row tiles in the backward pairs)
and two CTAs per tile on the grid's z, one per column half of the
outputs. Head dim 576 (MLA's absorbed heads) runs the 512 design
with three CTAs per tile, one per 192-column third, and dK/dV's two
consumer warpgroups on two column boxes and one. The CUDA-core
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
    """No rule picks a height at 256: the backward pairs take 64 rows, the
    forwards' CTAs 128 (two consumer warpgroups), at any card size."""
    for name, plan in _all_plans(BF16, 256, None, sms=sms, bh=256, s=8192).items():
        want = 128 if name.startswith("fwd") else 64
        assert getattr(plan, "block_m", getattr(plan, "block", None)) == want, name


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
    # 1 KiB slack + tiles of 256 bf16 columns (512 bytes a row) + ids + mbarriers:
    # the forwards' 128-row Q tile, two stages of 64-key K and V tiles, the
    # staged ids (64 int32 a stage) and 9 mbarriers (K and V full and empty)
    assert p["fwd tri"].smem_bytes == 1024 + (128 + 4 * 64) * 512 + 72 == 197_704
    assert p["fwd rect"].smem_bytes == 1024 + (128 + 4 * 64) * 512 + 512 + 72 == 198_216
    assert p["dq tri"].smem_bytes == 1024 + (128 + 4 * 64) * 512 + 40 == 197_672
    assert p["dq rect"].smem_bytes == 197_672 + 528 == 198_200
    # + f32 lse and delta, and the consumers' exchange of P^T and dS^T (16 KiB)
    assert p["dkv tri"].smem_bytes == 197_672 + 1024 + 16_384 == 215_080
    assert p["dkv rect"].smem_bytes == 215_080 + 528 == 215_608
    assert [p[k].threads for k in ("fwd tri", "fwd rect", "dq tri", "dkv tri")] == [
        384, 384, 160, 384]  # forwards, dK/dV: two consumer warpgroups and the producer's
    assert {p[k].swizzle for k in p} == {128}
    f = _all_plans(F32, 256, None, bh=6, s=130)
    # the f32 forward's cluster kernels: Q slab, two stages of K and V slabs,
    # partial scores, P and the rows' statistics; two slab CTAs a cluster
    assert f["fwd tri"].smem_bytes == 4 * (64 * 128 + 2 * 2 * 64 * 128 + 2 * 64 * 64
                                           + 4 * 64) == 197_632
    assert (f["fwd tri"].col_split, f["fwd tri"].cluster, f["fwd tri"].grid) == (2, 2, (3, 6))
    # the f32 backward pair's cluster kernels: two resident slabs, two stages of
    # two streamed slabs, the exchange's two 64 x 64 tiles (dQ: its rows' lse
    # and delta too); two slab CTAs a cluster
    assert (f["dq tri"].block, f["dq tri"].grid, f["dq tri"].cluster) == (64, (3, 6), 2)
    assert f["dq tri"].smem_bytes == 4 * (2 * 64 * 128 + 2 * 2 * 64 * 128 + 2 * 64 * 64
                                          + 2 * 64) == 229_888
    assert (f["dkv tri"].block, f["dkv tri"].grid, f["dkv tri"].col_split) == (64, (3, 3), 2)
    assert f["dkv tri"].smem_bytes == 229_888 - 4 * 2 * 64 == 229_376


def test_plan_constants_match_the_cuda_sources():
    fwd, bwd = (KERNELS / "flash_fwd.cu").read_text(), (KERNELS / "flash_bwd.cu").read_text()
    header = (KERNELS / "hopper.cuh").read_text()
    # the whole-row f32 pair runs head dim 16 alone (f32_tile is gone): f32 from
    # 32 runs the wide library's tile kernels
    assert not re.search(r"\bf32_tile\(", bwd) and not hasattr(flash_bwd, "f32_tile")
    assert "f32 at head dims 256 and above: the cluster pair" not in bwd
    assert [bwd.count(f"__global__ void __launch_bounds__(kThreads, f32_tile_ctas(W, {dq}))")
            for dq in ("true", "false")] == [2, 2]
    assert "constexpr int kv_split() { return D > 128 ? 2 : 1; }" in bwd
    assert [flash_bwd.kv_split(d) for d in flash_fwd.NATIVE_HEAD_DIMS] == [1, 1, 1, 1, 2, 2, 2]
    # every native head dim is dispatched in both libraries in their 16-bit
    # type; f32 in the base forward library at 16 alone (from 32 on: the wide
    # library's tile and cluster kernels), the backward's f32 in the wide
    # library's at every head dim but 16
    for src in (fwd, bwd):
        for d in flash_fwd.NATIVE_HEAD_DIMS:
            assert len(re.findall(rf"case {d}: return (?:dispatch_tc|launch)<", src)) == 1, d
    assert "    if (d == 16) return launch<16, TRI>(p, bh, st);\n#endif\n    return kUnsupported;" \
        in fwd
    # the CUDA-core kernels' rows: y and z slices of 65,535, no row cap (the
    # backward's f32 kernels walk them tile-major, cluster_slot)
    for src in (fwd, bwd):
        assert "constexpr int kMaxGridY = 65535;" in src
        assert "65535 &&" not in src and "<= 65535" not in src
    assert "blockIdx.z * kMaxGridY" in fwd
    cluster = (KERNELS / "flash_cluster.cuh").read_text()  # cluster_slot, both sources' walk
    assert "(static_cast<long long>(blockIdx.z) * kMaxY +" in cluster
    assert "m64n256k16" in header


@pytest.mark.parametrize("d, width", [(1, 16), (16, 16), (17, 32), (33, 64), (80, 128),
                                      (96, 128), (112, 128), (128, 128), (129, 256), (256, 256),
                                      (257, 512), (384, 512), (512, 512), (513, 576),
                                      (544, 576), (575, 576), (576, 576)])
def test_padded_head_dim(d, width):
    assert flash_fwd.padded_head_dim(d) == width
    # the share of the products a padded head wastes
    assert 0 <= 1 - d / width < 1


@pytest.mark.parametrize("d", [0, 577, 640, 1024, -1, True])
def test_head_dims_the_port_does_not_take_raise(d):
    """0, -1 and a bool raise. The name is older than the D-streaming
    route: the cases 577, 640 and 1024 raised until ROADMAP.md item 23 was
    done, and now check the opposite: each pads to the next multiple of 64
    and takes the D-streaming kernels, on 64-row tiles only."""
    wide = {577: 640, 640: 640, 1024: 1024}
    if d in wide and not isinstance(d, bool):
        assert flash_fwd.padded_head_dim(d) == wide[d] and flash_fwd.is_wide(wide[d])
        assert flash_fwd.tile_heights(BF16, d) == flash_fwd.tile_heights(F32, d) == (64,)
        return
    with pytest.raises(ValueError, match="head_dim must be a positive int"):
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
    """chip_smoke's build phase expects one instantiation of each kernel at
    D 256 beside the 16 and 32 of D 16-128: the backward pairs' one
    warpgroup's, the forwards' two consumer warpgroups' (128-row CTAs)."""
    import chip_smoke

    assert chip_smoke.HEAD_DIM_256_INSTANTIATIONS == {"flash_fwd": 2, "flash_bwd": 4}
    labels = {chip_smoke.fwd_bf16_label(f"flash_fwd_{k}_kernelI13__nv_bfloat16Li256ELi2EE")
              for k in ("tri", "rect")}
    assert labels == set(chip_smoke.HEAD_DIM_256_FORWARDS) == {"d256_wg2", "rect_d256_wg2"}


def test_phase_3_head_dim_rows_plan_as_phase_15_runs_them():
    """chip_smoke's head-dim rows: bf16 at D 256 in 64-row tiles (the
    forwards' CTAs 128 rows), the padded route at 128, every row's head dim
    up to 256, the six kernels covered."""
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
            assert plan.block_m == 128 and dq.block == dkv.block == 64
            assert plan.threads == dkv.threads == 384
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
    assert f["fwd tri"].smem_bytes == f["fwd rect"].smem_bytes == 197_632
    assert (f["fwd tri"].block_m, f["fwd tri"].col_split, f["fwd tri"].cluster) == (64, 4, 4)
    # the f32 backward pair: four slab CTAs a tile in one cluster
    assert (f["dq tri"].block, f["dq tri"].grid, f["dq tri"].cluster) == (64, (3, 6), 4)
    assert f["dq tri"].smem_bytes == 229_888
    assert (f["dkv tri"].block, f["dkv tri"].grid, f["dkv tri"].col_split) == (64, (3, 3), 4)
    assert f["dkv tri"].smem_bytes == 229_376
    # below 512 nothing of this changes
    for d in (x for x in flash_fwd.NATIVE_HEAD_DIMS if x < 512):
        assert all(plan.col_split == 1 for plan in _all_plans(BF16, d, None).values()), d
        assert {plan.ring for k, plan in _all_plans(BF16, d, None).items() if "d" in k[:2]} == {64}


def test_plan_constants_at_512_match_the_cuda_sources():
    fwd, bwd = (KERNELS / "flash_fwd.cu").read_text(), (KERNELS / "flash_bwd.cu").read_text()
    header = (KERNELS / "hopper.cuh").read_text()
    for src in (fwd, bwd):
        assert "constexpr int stages() { return D > 256 ? 1 : kStages; }" in src
        assert "constexpr int col_split() { return D > 512 ? 3 : D > 256 ? 2 : 1; }" in src
    # the D 512 library dispatches D 512 alone, the others 16-256 (the forward's
    # f32 16-128, its cluster kernels from 256 on in the wide libraries; the
    # backward's f32 in the wide library at every head dim)
    assert bwd.count("#ifdef FLASH_HEAD_DIM_512") == 1 and fwd.count("#ifdef FLASH_HEAD_DIM_512") == 1
    assert "#if !defined(FLASH_HEAD_DIM_512) && !defined(FLASH_HEAD_DIM_576)" in fwd
    assert "#elif defined(FLASH_HEAD_DIM_576)\n      case 576: return dispatch_tc<576, K>" in bwd
    assert "constexpr int ring_rows() { return D > 256 ? 32 : kTile; }" in bwd
    assert "f32_keys" not in fwd
    assert "m64n32k16" in header
    dims = flash_fwd.NATIVE_HEAD_DIMS
    assert [flash_fwd.ring_stages(d) for d in dims] == [2, 2, 2, 2, 2, 1, 1]
    assert [flash_fwd.col_split(d) for d in dims] == [1, 1, 1, 1, 1, 2, 3]
    # the f32 forward's slab CTAs a q tile (one cluster) at 256, 512 and 576
    assert [flash_fwd.tri_plan(F32, 2, 100, d, H100_SMS).col_split for d in dims] == [
        1, 1, 1, 1, 2, 4, 5]
    assert [flash_bwd.ring_rows(d) for d in dims] == [64, 64, 64, 64, 64, 32, 32]
    assert flash_fwd.library_name("flash_fwd", BF16, 512) == "flash_fwd_d512"
    assert flash_fwd.library_name("flash_bwd", torch.float16, 512) == "flash_bwd_f16_d512"
    assert flash_fwd.library_name("flash_bwd", F32, 256) == "flash_bwd_wide"
    assert flash_fwd.library_name("flash_fwd", F32, 256) == "flash_fwd_wide"


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


@pytest.mark.parametrize("d", [576, 513, 544])
def test_a_128_row_plan_at_head_dim_576_raises(d):
    with pytest.raises(ValueError, match="head_dim"):
        flash_fwd.check_block_m(BF16, 128, d)
    with pytest.raises(ValueError):
        flash_fwd.tri_plan(torch.float16, 8, 128, 576, H100_SMS, block_m=128)
    with pytest.raises(ValueError):
        flash_bwd.tri_bwd_plan(BF16, 8, 8, 128, 576, H100_SMS, block_m=128)
    q = torch.zeros((2, 8, 576), dtype=BF16)
    with pytest.raises(ValueError):  # the CPU path checks it too
        flash_fwd.flash_fwd_tri(q, q, q, 2, 2, block_m=128)


@pytest.mark.parametrize("sms", [1, H100_SMS, 10**9])
def test_the_one_wave_rule_never_picks_128_rows_at_576(sms):
    for dtype in (BF16, torch.float16):
        for name, plan in _all_plans(dtype, 576, None, sms=sms, bh=256, s=8192).items():
            assert getattr(plan, "block_m", getattr(plan, "block", None)) == 64, name


def test_an_autotuned_128_is_not_forced_on_head_dim_576(monkeypatch):
    from tpu_operator_torch.workloads import autotune

    monkeypatch.setattr(autotune, "tuned_flash_tile", lambda *a, **k: 128)
    for d in (576, 544, 520, 513):
        for dtype in (BF16, torch.float16, F32):
            assert tfa._resolve_block_m(None, dtype, 8192, 8, d, True) is None, (dtype, d)
            assert tfa._resolve_block_m(None, dtype, 8192, 8, d, False) is None, (dtype, d)
    with pytest.raises(ValueError):
        tfa._resolve_block_m(128, torch.float16, 8192, 8, 576, True)


def test_plans_at_head_dim_576_by_hand():
    """The kernels' layouts at D 576 (flash_fwd.cu tc_smem_bytes, smem_bytes;
    flash_bwd.cu dq_tc_smem_bytes, dkv_tc_smem_bytes, dq_smem_bytes,
    dkv_smem_bytes), reckoned by hand: one ring stage, 32-row ring tiles in
    the backward pairs, three CTAs per tile, each of the four 16-bit
    layouts at most a block's 232,448 bytes."""
    row = 576 * 2  # bytes of a 16-bit row: nine 128-byte boxes
    assert row == 9 * 128
    for dtype in (BF16, torch.float16):
        p = _all_plans(dtype, 576, None)
        # 1 KiB slack + Q, K and V tiles of 64 rows + 3 mbarriers
        assert p["fwd tri"].smem_bytes == 1024 + 3 * 64 * row + 24 == 222_232
        assert p["fwd rect"].smem_bytes == 222_232 + 66 * 4 == 222_496  # + 64 key ids, min, max
        # Q and dO (own, 64 rows) + one 32-row stage of K and V
        assert p["dq tri"].smem_bytes == 1024 + (2 * 64 + 2 * 32) * row + 24 == 222_232
        assert p["dq rect"].smem_bytes == 222_232 + 34 * 4 == 222_368
        # K and V (own) + one 32-row stage of Q and dO with their f32 lse and delta
        assert p["dkv tri"].smem_bytes == 222_232 + 2 * 32 * 4 == 222_488
        assert p["dkv rect"].smem_bytes == 222_488 + 34 * 4 == 222_624
        assert max(plan.smem_bytes for plan in p.values()) <= MAX_SMEM
        assert [p[k].threads for k in ("fwd tri", "fwd rect", "dq tri", "dkv tri")] == [
            160, 160, 160, 384]
        assert {p[k].swizzle for k in p} == {128} and {p[k].col_split for k in p} == {3}
        assert [p[k].ring for k in ("dq tri", "dkv tri", "dq rect", "dkv rect")] == [32] * 4
    # 640 columns: Q, K and V tiles alone pass a block's shared memory
    assert 3 * 64 * 640 * 2 == 245_760 > MAX_SMEM
    f = _all_plans(F32, 576, None, bh=6, s=130)
    assert f["fwd tri"].smem_bytes == 197_632 <= MAX_SMEM
    # five 128-column slab CTAs a q tile in one cluster, the last from 448
    assert (f["fwd tri"].block_m, f["fwd tri"].col_split, f["fwd tri"].grid) == (64, 5, (3, 6))
    assert f["fwd tri"].cluster == 5
    # the f32 backward pair: five slab CTAs a tile in one cluster, as the forward
    assert (f["dq tri"].block, f["dq tri"].grid, f["dq tri"].cluster) == (64, (3, 6), 5)
    assert f["dq tri"].smem_bytes == 229_888
    assert (f["dkv tri"].block, f["dkv tri"].grid, f["dkv tri"].col_split) == (64, (3, 3), 5)
    assert f["dkv tri"].smem_bytes == 229_376


def _kv_columns(d: int):
    """The dK and dV columns each consumer warpgroup of a 16-bit dK/dV CTA's
    key slice owns, as flash_bwd.cu's dkv_tc_body splits them: the CTA's
    columns in whole 64-column boxes, ``kv_split`` ways, the first owning
    the most (DC)."""
    cols = d // flash_fwd.col_split(d)
    box = min(d, 64)
    split = flash_bwd.kv_split(d)
    first = -(-(cols // box) // split) * box
    return (first,) * (split - 1) + (cols - (split - 1) * first,)


def test_dkv_columns_are_whole_boxes():
    """dK/dV's consumer warpgroups own whole 64-column boxes of the CTA's
    columns: 128 and 64 of a 576-wide head's 192-column third (an MN-major
    operand cannot start inside a box), halves at 256 and 512; the products
    of each are as wide as the first's, and stay inside the CTA's columns."""
    for d in flash_fwd.NATIVE_HEAD_DIMS:
        cols = _kv_columns(d)
        assert len(cols) == flash_bwd.kv_split(d)
        assert sum(cols) == d // flash_fwd.col_split(d)
        assert all(c % min(d, 64) == 0 and c <= 256 for c in cols), d
        width = cols[0]  # every warpgroup's products (DC)
        starts = [min(sum(cols[:w]), sum(cols) - width) for w in range(len(cols))]
        assert all(0 <= a and a + width <= sum(cols) and a % min(d, 64) == 0 for a in starts)
    assert _kv_columns(576) == (128, 64)
    assert _kv_columns(512) == _kv_columns(256) == (128, 128)


def test_plan_constants_at_576_match_the_cuda_sources():
    fwd, bwd = (KERNELS / "flash_fwd.cu").read_text(), (KERNELS / "flash_bwd.cu").read_text()
    header = (KERNELS / "hopper.cuh").read_text()
    # the D 576 library dispatches D 576 alone (f32: none)
    assert bwd.count("#elif defined(FLASH_HEAD_DIM_576)") == 1
    assert fwd.count("#elif defined(FLASH_HEAD_DIM_576)") == 1
    for kind in ("dispatch_tc", "launch"):
        # f32 at 576: the wide libraries' cluster kernels
        for src in (fwd, bwd):
            assert len(re.findall(rf"case 576: return {kind}<", src)) == (kind == "dispatch_tc")
    # the CTA's columns in whole boxes, the first warpgroup owning the most;
    # every warpgroup's products DC wide (the last one's a box early at 576)
    assert "constexpr int DC = (DCTA / G::kCols + CS - 1) / CS * G::kCols;" in bwd
    assert "constexpr bool kOverlap = CS * DC > DCTA;" in bwd
    assert "const int first = kOverlap ? min(own, DCTA - DC) : own;" in bwd
    assert "m64n192k16" in header and "else if constexpr (N == 192) wgmma_rs_n192<T>" in header
    assert "9 at 576" in header
    from tpu_operator_torch.kernels import build

    for src in ("flash_fwd", "flash_bwd"):
        assert build.VARIANTS[f"{src}_d576"] == (src, ("-DFLASH_HEAD_DIM_576",))
        assert build.VARIANTS[f"{src}_f16_d576"] == (src, ("-DFLASH_ELEM_F16",
                                                           "-DFLASH_HEAD_DIM_576"))
        for dtype, name in ((BF16, f"{src}_d576"), (F32, f"{src}_wide"),
                            (torch.float16, f"{src}_f16_d576")):
            assert flash_fwd.library_name(src, dtype, 576) == name


@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("s", [1, 31, 64, 100, 1000])
@pytest.mark.parametrize("causal, window", [(True, None), (False, None), (True, 33),
                                            (True, 128)])
def test_every_live_tile_pair_at_576_is_covered_once_per_column_third(causal, window, s, group):
    """The D 576 pairs' walks (64-row own tiles, 32-row ring tiles) on the
    grid of three z slices: every live pair once in each column third, and
    no dead one; the forwards' grids likewise."""
    tri = causal and window is None
    plans = (flash_bwd.tri_bwd_plan(BF16, 2 * group, 2, s, 576, H100_SMS) if tri else
             flash_bwd.rect_bwd_plan(BF16, 2 * group, 2, s, 576, H100_SMS, causal, window))
    for plan, rows, members, (q_rows, k_rows) in ((plans[0], 2 * group, 1, (64, 32)),
                                                  (plans[1], 2, group, (32, 64))):
        assert plan.col_split == 3
        got = collections.Counter((z, plan.cta(x, y)[0], *v) for z in range(plan.col_split)
                                  for x in range(plan.grid[0]) for y in range(plan.grid[1])
                                  for v in plan.visits(x, y, s, members))
        assert set(got.values()) == {1}
        live = _live(s, causal, plan.window, q_rows, k_rows)
        assert set(got) == {(z, row, m, q, k) for z in range(3) for row in range(rows)
                            for m in range(members) for q, k in live}
    fwd = flash_fwd.rect_plan(BF16, 2, s, s, 576, H100_SMS, causal, window)
    assert fwd.col_split == 3 and fwd.grid == (2, -(-s // 64))
    seen = collections.Counter((z, *fwd.cta(x, y), k) for z in range(3)
                               for x in range(fwd.grid[0]) for y in range(fwd.grid[1])
                               for _, k, _ in fwd.visits(x, y))
    assert set(seen.values()) <= {1}
    assert set(seen) == {(z, row, q, k) for z in range(3) for row in range(2)
                         for q, k in _live(s, causal, fwd.window, 64, 64)}


def test_phase_2_counts_the_head_dim_576_instantiations():
    """chip_smoke's build phase expects the D 576 libraries to hold one
    warpgroup's instantiation of each kernel, bf16 and fp16, and no other."""
    import chip_smoke

    assert chip_smoke.HEAD_DIM_576_INSTANTIATIONS == {
        "flash_fwd_d576": 2, "flash_bwd_d576": 4, "flash_fwd_f16_d576": 2,
        "flash_bwd_f16_d576": 4}
    assert {chip_smoke.fwd_bf16_label(f"flash_fwd_{k}_kernelI13__nv_bfloat16Li576ELi1EE")
            for k in ("tri", "rect")} == {"d576_wg1", "rect_d576_wg1"}
    assert chip_smoke.bwd_f16_label(
        "flash_bwd_dkv_tri_kernelI6__halfLi576ELi1EE") == "dkv_d576_wg1"


def test_phase_3_head_dim_576_rows():
    """chip_smoke's D 576 rows: all six kernels in bf16 and fp16, f32 rows,
    sarvam-105b's (1,8192,8,576) with one kv head (plain, window 128,
    packed), full attention at (1,4096,8,576), serving's f32 chunk, ragged
    lengths at GQA 2, and the padded route at 544 and 520."""
    import chip_smoke

    fwd, bwd = chip_smoke.HEAD_DIM_576_KERNEL_CASES, chip_smoke.HEAD_DIM_576_BWD_CASES
    assert {c["kernel"] for c in fwd} == {"flash_fwd_tri", "flash_fwd_rect"}
    assert {c["pair"] for c in bwd} == {"tri", "rect"}
    for rows in (fwd, bwd):
        assert {c["dtype"] for c in rows} == {BF16, torch.float16, F32}
        assert {c["q"][1] for c in rows} >= {100, 1000, 4096, 8192}
        for case in rows:
            d = case["q"][3]
            assert flash_fwd.padded_head_dim(d) == 576, case["label"]
            assert ("padded" in case["label"]) == (d != 576)
        assert {c["q"][3] for c in rows} == {576, 544, 520}
        for dtype in (BF16, torch.float16):
            for extra in ({}, {"window": 128}, {"packed": 2}):
                assert any(c["dtype"] == dtype and c["q"] == (1, 8192, 8, 576)
                           and c.get("h_kv") == 1 and all(c.get(k) == v for k, v in extra.items())
                           for c in rows), (dtype, extra)
        assert any(c["q"] == (1, 4096, 8, 576) and c.get("causal") is False for c in rows)
        assert any(c["q"] == (2, 128, 4, 576) and c["dtype"] == F32 for c in rows)
        assert any(c["q"][:3] == (2, 100, 4) and c.get("h_kv") == 2 for c in rows)
        assert any(c["q"][:3] == (2, 1000, 4) and c.get("h_kv") == 2 for c in rows)
    assert any(c["q"] == (1, 8, 2, 576) and c.get("sk") == 64 and c["dtype"] == F32
               and c.get("main") for c in fwd)


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
    triangle kernel once and matches dense attention; so does 577, on the
    D-streaming kernel (padded to 640)."""
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
    q, k, v = (torch.randn((1, 32, 2, 577), generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    before = flash_fwd.flash_fwd_tri.launches
    got = tfa.flash_attention(q, k, v, block_q=32, block_k=32)
    want = dense_attention(q.float(), k.float(), v.float(), causal=True)
    torch.cuda.synchronize()
    assert flash_fwd.flash_fwd_tri.launches == before + 1
    assert got.shape == q.shape and float((got.float() - want).abs().max()) <= tol


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, torch.float16, F32])
@pytest.mark.parametrize("s, h, h_kv", [(1, 1, 1), (100, 4, 2), (200, 4, 1), (1000, 2, 2)])
def test_head_dim_576_kernels_match_plain(cuda, dtype, s, h, h_kv):
    """Both forward kernels and both backward pairs at D 576, every mask,
    GQA groups of 1, 2 and 4, ragged lengths: each column third of O, lse
    from third 0, and each 64-column box of every gradient (dK/dV's
    warpgroups own two boxes and one of each third)."""
    tol = F32_TOL if dtype == F32 else BF16_TOL
    qb, kb, vb, h_, hk = _qkv(s + 576, 2, s, h, h_kv, 576, dtype)
    rng = np.random.default_rng(s + 3)
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
        for third in range(3):
            cols = slice(192 * third, 192 * (third + 1))
            assert _err(want[..., cols], out[..., cols]) <= tol, (name, third)
        assert _err(want_lse, lse) <= LSE_TOL, name
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
            for box in range(9):
                cols = slice(64 * box, 64 * (box + 1))
                assert float((w[..., cols].float() - g[..., cols].float()).abs().max()) <= \
                    tol * scale, (name, grad, box)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [513, 520, 544, 575, 576])
def test_head_dims_past_512_gradients_match_dense(cuda, d):
    """autograd through flash_attention against autograd through dense
    attention, f32, (1, 256, 2, d): the padded route to 576 (513-575) and
    the native 576, through the kernels (one launch of each of the pair),
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
