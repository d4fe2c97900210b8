"""Launch plans of the D-streaming ("wide") flash kernels, which take every
head dim above 576 (a multiple of 64; others zero-padded to one), and, on
the card, those kernels against their plain versions. This file imports no
JAX, so its card tests run on a machine with a card and no JAX:

    python -m pytest tests/test_torch_flash_wide_plans.py --noconftest -q

Above 576 the reductions over the head dim stream in 64 x 64 boxes, and the
outputs split into column slabs, one CTA each on the grid's z: 256 columns
of O and of dQ, 128 of dK and dV (bf16 and fp16); 256 of O and 128 of the
gradients in f32. Both backward pairs are built there; the general pair
stages its ring tiles' segment ids and skips a tile whose documents cannot
meet its own tile's before the tile's chunks load. Card tolerances as
``tests/test_torch_kernels.py``: O f32 1e-4, 16-bit 2e-2, lse 1e-3;
gradients f32 1e-4 absolute, 16-bit 2e-2 of the largest |gradient|.
"""

import collections
import math
import pathlib
import re

import numpy as np
import pytest
import torch

from tpu_operator_torch.kernels import build, flash_bwd, flash_fwd
from tpu_operator_torch.workloads import flashattention as tfa

BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32
MAX_SMEM = 232_448  # bytes of shared memory a block may use on the H100
H100_SMS = 132
KERNELS = pathlib.Path(flash_fwd.__file__).parent
F32_TOL, HALF_TOL, LSE_TOL = 1e-4, 2e-2, 1e-3
WIDE_DIMS = [640, 704, 1024, 2048, 4096]


def _wide_plans(dtype, d, bh=16, bh_kv=8, s=1000):
    return {
        "fwd tri": flash_fwd.tri_plan(dtype, bh, s, d, H100_SMS),
        "fwd rect": flash_fwd.rect_plan(dtype, bh, s, s, d, H100_SMS, False),
        **dict(zip(("dq tri", "dkv tri"), flash_bwd.tri_bwd_plan(dtype, bh, bh_kv, s, d,
                                                                 H100_SMS))),
        **dict(zip(("dq rect", "dkv rect"), flash_bwd.rect_bwd_plan(dtype, bh, bh_kv, s, d,
                                                                    H100_SMS, True, 33))),
    }


@pytest.mark.parametrize("dtype", [BF16, F16, F32])
@pytest.mark.parametrize("d", WIDE_DIMS)
def test_every_wide_plan_fits_a_block(dtype, d):
    for name, plan in _wide_plans(dtype, d).items():
        assert plan.smem_bytes <= MAX_SMEM, (name, plan)
        assert plan.threads <= 1024 and plan.swizzle == (0 if dtype == F32 else 128), name
        assert getattr(plan, "block_m", getattr(plan, "block", None)) == 64, name


@pytest.mark.parametrize("dtype", [BF16, F16, F32])
@pytest.mark.parametrize("d", WIDE_DIMS)
def test_the_slab_count_is_the_head_dim_over_the_slab(dtype, d):
    for name, plan in _wide_plans(dtype, d).items():
        assert plan.slab in (128, 256) and plan.slab % 64 == 0, name
        assert plan.col_split == math.ceil(d / plan.slab), name
        # the last slab starts at d - slab: the slabs cover every column, and
        # each column is written by exactly one of them
        starts = [min(z * plan.slab, d - plan.slab) for z in range(plan.col_split)]
        owned = collections.Counter(c for z, s0 in enumerate(starts)
                                    for c in range(max(s0, z * plan.slab), s0 + plan.slab))
        assert set(owned) == set(range(d)) and set(owned.values()) == {1}, name
        # 16-bit: the backward's ring of 4 stages, the forward's K and V rings
        # of 2; f32: the 2-stage slab ring of the cluster kernels (forward and
        # backward)
        assert plan.stages == (4 if dtype != F32 and name[0] == "d" else 2), name


def test_wide_plans_by_hand():
    """The layouts of flash_fwd.cu's wide_smem_bytes / f32_wide_smem_bytes
    and flash_bwd.cu's wide16_smem_bytes / f32_wide_smem_bytes, reckoned by
    hand."""
    box = 64 * 64 * 2
    p = _wide_plans(BF16, 1024)
    # the forward in slab clusters: slack + the resident own Q slab (4 boxes) +
    # 2 stages of 4 K boxes + 2 stages of 4 V boxes + two 64 x 64 f32 partial
    # S buffers + two 16-bit P tiles with 64 (correction, sum) pairs each + 5
    # barriers; the general kernel the same (every warp reads the segment ids
    # itself)
    assert p["fwd tri"].smem_bytes == p["fwd rect"].smem_bytes == (
        1024 + 4 * box + 2 * 4 * box + 2 * 4 * box + 2 * 64 * 64 * 4 + 2 * (box + 64 * 8)
        + 5 * 8) == 215_080
    # the backward pair in slab clusters: slack + the resident own slab (dQ:
    # 4 Q and 4 dO boxes) + 4 stages of 4 streamed boxes + the exchange's two
    # 64 x 64 f32 tiles + 64 (lse, delta) and 2 x 64 ids + 5 barriers
    assert p["dq tri"].smem_bytes == (1024 + 8 * box + 4 * 4 * box + 2 * 64 * 64 * 4 + 64 * 16
                                      + 5 * 8) == 231_464
    # ... dK/dV: 2 K and 2 V boxes resident
    assert p["dkv tri"].smem_bytes == 231_464 - 4 * box == 198_696
    # the general pair the same (every warp reads the segment ids' range itself)
    assert p["dq rect"].smem_bytes == 231_464 and p["dkv rect"].smem_bytes == 198_696
    assert [p[k].threads for k in p] == [128, 128, 128, 128, 128, 128]
    assert [p[k].col_split for k in p] == [4, 4, 4, 8, 4, 8]
    assert [p[k].cluster for k in p] == [4, 4, 4, 8, 4, 8]
    assert (p["fwd tri"].stages, p["fwd tri"].slab) == (2, 256)
    assert p["fwd tri"].grid == (16, 16) and p["dq tri"].grid == (16, 16)
    assert p["dkv tri"].grid == (16, 8)
    assert p["dq rect"].grid == (16, 16) and p["dkv rect"].grid == (16, 8)
    f = _wide_plans(F32, 1024, bh=6, bh_kv=3, s=130)
    # f32 forward: the resident 64 x 128 Q slab, 2 stages of K and V slabs,
    # the partial scores and P (64 x 64 each), a float4 of statistics a row
    assert f["fwd tri"].smem_bytes == 4 * (64 * 128 + 2 * 2 * 64 * 128 + 2 * 64 * 64
                                           + 4 * 64) == 197_632
    assert f["fwd rect"].smem_bytes == 197_632
    # f32 backward: two resident 64 x 128 slabs, 2 stages of two streamed
    # slabs, the exchange's partial S and dP (then P and dS) 64 x 64 tiles,
    # and dQ's 64 rows' lse and delta; the general pair the same (every warp
    # reads the segment ids' range itself)
    assert f["dq tri"].smem_bytes == 4 * (2 * 64 * 128 + 2 * 2 * 64 * 128 + 2 * 64 * 64
                                          + 2 * 64) == 229_888
    assert f["dkv tri"].smem_bytes == 4 * (2 * 64 * 128 + 2 * 2 * 64 * 128 + 2 * 64 * 64) == 229_376
    assert f["dq rect"].smem_bytes == 229_888 and f["dkv rect"].smem_bytes == 229_376
    assert (f["fwd tri"].grid, f["fwd tri"].col_split, f["fwd tri"].cluster) == ((3, 6), 8, 8)
    assert (f["dq tri"].grid, f["dq tri"].col_split) == ((3, 6), 8)
    assert (f["dkv tri"].grid, f["dkv tri"].col_split) == ((3, 3), 8)
    assert (f["dq rect"].grid, f["dkv rect"].grid) == ((3, 6), (3, 3))
    assert {f[k].threads for k in f} == {256}
    # the eight slab CTAs of a tile are one cluster, forming S and dP once
    assert {(f[k].cluster, f[k].redundancy, f[k].stages) for k in f if k[0] == "d"} == {(8, 1, 2)}


def test_redundant_work_factors():
    """Every kernel's clusters form the score tiles once per cluster, in
    units of one slab's product: the forward (g n + n) / 2 n = (g + 1) / 2 of
    the ideal tensor-core work (S g times over the whole head, each CTA's P.V
    on its slab); dQ (2 g + n) / (n + 2) (S, dP and dQ: S and dP g times,
    each CTA's dQ on its slab), dK/dV (2 g + 2 n) / (2 n + 2) (S, dP, dV,
    dK); n the slab count, g the clusters a tile: the ideal up to 8 slabs
    (before the forward's clusters every forward slab CTA formed the whole
    S: (n + 1) / 2, 2.5 at 1024)."""
    def factors(d):
        p = _wide_plans(BF16, d)
        n_q, n_kv = p["dq tri"].col_split, p["dkv tri"].col_split
        g_f = p["fwd tri"].col_split // p["fwd tri"].cluster
        g_q, g_kv = p["dq tri"].redundancy, p["dkv tri"].redundancy
        return (g_f + 1) / 2, (2 * g_q + n_q) / (n_q + 2), (2 * g_kv + 2 * n_kv) / (2 * n_kv + 2)
    assert factors(640) == (1.0, 1.0, 1.0)
    assert factors(1024) == (1.0, 1.0, 1.0)
    assert factors(2048) == (1.0, 1.0, (2 * 2 + 32) / 34)
    assert factors(4096) == (1.5, (2 * 2 + 16) / 18, (2 * 4 + 64) / 66)


@pytest.mark.parametrize("s", [1, 63, 64, 100, 1000])
@pytest.mark.parametrize("group", [1, 4])
def test_the_wide_plans_visit_exactly_the_triangle(s, group):
    """Every live (q tile, key tile) pair of the causal triangle once per
    slab, no other, in the forward's grid and in both backward kernels'."""
    d = 704
    tiles = -(-s // 64)
    live = {(q, k) for q in range(tiles) for k in range(q + 1)}
    fwd = flash_fwd.tri_plan(BF16, 2 * group, s, d, H100_SMS)
    seen = collections.Counter(
        (z, *fwd.cta(x, y), k) for z in range(fwd.col_split) for x in range(fwd.grid[0])
        for y in range(fwd.grid[1]) for k in range(fwd.cta(x, y)[1] + 1))
    assert set(seen.values()) == {1}
    assert set(seen) == {(z, row, q, k) for z in range(fwd.col_split) for row in range(2 * group)
                         for q, k in live}
    dq, dkv = flash_bwd.tri_bwd_plan(BF16, 2 * group, 2, s, d, H100_SMS)
    for plan, rows, members in ((dq, 2 * group, 1), (dkv, 2, group)):
        got = collections.Counter((z, plan.cta(x, y)[0], *v) for z in range(plan.col_split)
                                  for x in range(plan.grid[0]) for y in range(plan.grid[1])
                                  for v in plan.visits(x, y, s, members))
        assert set(got.values()) == {1}
        assert set(got) == {(z, row, m, q, k) for z in range(plan.col_split)
                            for row in range(rows) for m in range(members) for q, k in live}
    rect = flash_fwd.rect_plan(BF16, 2, s, s, d, H100_SMS, True)
    walked = {(q, k) for x in range(rect.grid[0]) for y in range(rect.grid[1])
              for q, k, _ in rect.visits(x, y)}
    assert walked == live


def test_the_general_pair_raises_above_576():
    """The general pair's plans exist above 576 and carry their masks (a
    window as ``band`` reads it); only a 128-row tile height raises."""
    dq, dkv = flash_bwd.rect_bwd_plan(BF16, 8, 8, 128, 640, H100_SMS, True, 33)
    assert (dq.causal, dq.window, dkv.causal, dkv.window) == (True, 33, True, 33)
    assert dq.smem_bytes == flash_bwd.wide_bwd_plans(BF16, 8, 8, 128, 640, True, 33,
                                                     rect=True)[0].smem_bytes
    dq, dkv = flash_bwd.rect_bwd_plan(F32, 8, 8, 128, 1024, H100_SMS, False)
    assert (dq.causal, dq.window, dkv.slab, dkv.swizzle) == (False, None, 128, 0)
    dq, _ = flash_bwd.rect_bwd_plan(BF16, 8, 8, 128, 1024, H100_SMS, True, 128)
    assert dq.window is None  # a window of s or more keys is none
    with pytest.raises(ValueError, match="block_m"):  # 64-row tiles only
        flash_fwd.tri_plan(BF16, 8, 128, 640, H100_SMS, block_m=128)
    with pytest.raises(ValueError, match="block_m"):
        flash_bwd.tri_bwd_plan(BF16, 8, 8, 128, 1024, H100_SMS, block_m=128)
    with pytest.raises(ValueError, match="block_m"):
        flash_bwd.rect_bwd_plan(BF16, 8, 8, 128, 1024, H100_SMS, False, block_m=128)


def _docs(s, cuts):
    """Segment ids of s positions split at ``cuts``."""
    return [sum(i >= c for c in cuts) for i in range(s)]


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("s, causal, window, cuts", [
    (300, False, None, None), (300, True, 70, None), (300, True, None, (128, 200)),
    (300, False, None, (64, 200)), (1000, True, 100, (333, 640)), (63, False, None, (20,))])
def test_the_wide_general_plans_visit_exactly_the_live_pairs(dtype, group, s, causal, window,
                                                              cuts):
    """The general pair's walks above 576 (dq: heaviest first only under a
    plain causal mask): every (q tile, key tile) pair of the band whose
    tiles do not hold two different documents each whole is visited once per
    slab, and no other; those are every pair that holds a live (q, k) pair,
    and, with two documents, no more."""
    d, rows, kv_rows = 704, 2 * group, 2
    tiles = -(-s // 64)
    seg = None if cuts is None else torch.tensor(_docs(s, cuts), dtype=torch.int32)[None]

    def tile_pairs(keep):
        return {(q, k) for q in range(tiles) for k in range(tiles)
                if bool(keep[q * 64:(q + 1) * 64, k * 64:(k + 1) * 64].any())}

    ids = None if seg is None else seg[0].tolist()
    live = tile_pairs(flash_fwd.keep_mask(1, s, s, 1, causal, window=window, seg=seg)[0])
    band = tile_pairs(flash_fwd.keep_mask(1, s, s, 1, causal, window=window)[0])
    walked = {(q, k) for q, k in band if ids is None or not flash_bwd.apart(
        ids[q * 64:(q + 1) * 64], ids[k * 64:(k + 1) * 64])}
    assert live <= walked and (len(cuts or ()) > 1 or live == walked)
    dq, dkv = flash_bwd.rect_bwd_plan(dtype, rows, kv_rows, s, d, H100_SMS, causal, window)
    for plan, n_rows, members in ((dq, rows, 1), (dkv, kv_rows, group)):
        got = collections.Counter(
            (z, plan.cta(x, y)[0], *v) for z in range(plan.col_split)
            for x in range(plan.grid[0]) for y in range(plan.grid[1])
            for v in plan.visits(x, y, s, members, ids))
        assert set(got.values()) == {1}, plan.kernel
        assert set(got) == {(z, row, m, q, k) for z in range(plan.col_split)
                            for row in range(n_rows) for m in range(members)
                            for q, k in walked}, plan.kernel
    if tiles > 1:
        heaviest_first = dq.cta(0, 0)[1] == tiles - 1
        # f32 too since its clusters launch tile-major (cluster_slot)
        assert heaviest_first == (causal and flash_bwd.band(causal, window, s) is None)


def test_an_autotuned_128_is_not_forced_above_576(monkeypatch):
    from tpu_operator_torch.workloads import autotune

    monkeypatch.setattr(autotune, "tuned_flash_tile", lambda *a, **k: 128)
    for d in (577, 640, 700, 1024):
        for dtype in (BF16, F16, F32):
            assert tfa._resolve_block_m(None, dtype, 8192, 8, d, True) is None, (dtype, d)
    monkeypatch.setattr(autotune, "tuned_flash_tile", lambda *a, **k: 64)
    assert tfa._resolve_block_m(None, BF16, 8192, 8, 1024, False) == 64
    with pytest.raises(ValueError, match="block_m"):
        tfa._resolve_block_m(128, BF16, 8192, 8, 1024, True)


def test_wide_plan_constants_match_the_cuda_sources():
    fwd, bwd = (KERNELS / "flash_fwd.cu").read_text(), (KERNELS / "flash_bwd.cu").read_text()
    wide = (KERNELS / "flash_wide.cuh").read_text()
    assert "constexpr int kWideBox = 64;" in wide
    assert "__host__ __device__ constexpr bool wide_head_dim(int d) { return d > 576 && " \
           "d % kWideBox == 0; }" in wide
    assert f"constexpr int kWideSlab = {flash_fwd.WIDE_SLAB};" in fwd
    assert f"constexpr int kWideRing = {flash_fwd.WIDE_RING};" in fwd
    assert f"constexpr int kWideThreads = {flash_fwd.WIDE_THREADS};" in fwd
    assert "constexpr int kWidePartFloats = kRingRows * kRingRows;" in fwd
    assert flash_fwd.WIDE_PART_BYTES == 64 * 64 * 4
    assert ("return kSmemAlign + (1 + 2 * kWideRing) * (kWideSlab / kWideBox) * kWideBoxBytes +\n"
            "         2 * kWidePartFloats * 4 + 2 * (kWideBoxBytes + kRingRows * 8) + "
            "8 * (2 * kWideRing + 1);") in fwd
    assert f"constexpr int kWideDqSlab = {flash_bwd.WIDE_DQ_SLAB};" in bwd
    assert f"constexpr int kWideDkvSlab = {flash_bwd.WIDE_DKV_SLAB};" in bwd
    assert f"constexpr int kWideRing = {flash_bwd.WIDE_BWD_RING};" in bwd
    assert f"constexpr int kWideThreads = {flash_bwd.WIDE_THREADS};" in bwd
    assert ("constexpr int kWideXchBytes = 2 * kTile * kTile * 4;" in bwd
            and flash_bwd.WIDE_XCH_BYTES == 2 * 64 * 64 * 4)
    # the f32 cluster kernels' layout, shared by both sources (both at head
    # dims 256 and above)
    cluster = (KERNELS / "flash_cluster.cuh").read_text()
    for name, value in (("Tile", flash_fwd.F32_TILE), ("Chunk", flash_fwd.F32_CHUNK),
                        ("Slab", flash_fwd.F32_SLAB), ("Stages", flash_fwd.F32_STAGES),
                        ("Cluster", flash_fwd.F32_CLUSTER)):
        assert f"constexpr int kF32Wide{name} = {value};" in cluster, name
        assert f"constexpr int kF32Wide{name} =" not in fwd + bwd, name
    # the f32 kernels' geometry and columns, as f32_wide_geometry and
    # f32_wide_columns model them
    assert "g((n + kF32WideCluster - 1) / kF32WideCluster),\n        c((n + g - 1) / g) {}" in cluster
    assert "return c0 < cl0 ? c0 : c0 + (cl1 - cl0);" in cluster
    assert "cudaLaunchAttributeClusterDimension" in cluster and "cudaLaunchKernelEx" in cluster
    for src in (fwd, bwd):
        assert src.count('#include "flash_cluster.cuh"') == 1 and "launch_clusters(" in src
    # the general pair's entries reach the wide kernels: no refusal left
    for kernel in ("dq", "dkv"):
        for pair in ("tri", "rect"):
            assert f"flash_bwd_{kernel}_{pair}_wide_kernel<Elem16>;" in bwd
            assert f"flash_bwd_{kernel}_{pair}_wide_f32_kernel" in bwd
    assert "is_tri(K)) {\n    return kUnsupported" not in bwd
    # each source's wide build dispatches every dtype to the wide kernels alone
    for src in (fwd, bwd):
        assert src.count('#include "flash_wide.cuh"') == 1
        assert re.search(r"#ifdef FLASH_HEAD_DIM_WIDE\n  return dispatch_wide<", src)
    for src in ("flash_fwd", "flash_bwd"):
        assert build.VARIANTS[f"{src}_wide"] == (src, ("-DFLASH_HEAD_DIM_WIDE",))
        assert build.VARIANTS[f"{src}_f16_wide"] == (src, ("-DFLASH_ELEM_F16",
                                                           "-DFLASH_HEAD_DIM_WIDE"))
        for d in (640, 704, 1024, 4096):
            for dtype, name in ((BF16, f"{src}_wide"), (F32, f"{src}_wide"),
                                (F16, f"{src}_f16_wide")):
                assert flash_fwd.library_name(src, dtype, d) == name
        assert flash_fwd.library_name(src, BF16, 576) == f"{src}_d576"
        # f32 from 256 on: both sources' cluster kernels in the wide library
        for d in (256, 512, 576):
            assert flash_fwd.library_name(src, F32, d) == f"{src}_wide"


@pytest.mark.parametrize("d", list(range(640, 4097, 64)) + [577, 700, 1000, 1100, 2000])
def test_the_f32_pair_forms_each_score_once_per_cluster(d):
    """The f32 D-streaming pair at every head dim it takes (padded ones
    through their width): the CTAs of each cluster sum every column of the
    head dim into the partial S and dP exactly once, the tile's CTAs write
    every column of the gradients exactly once, the cluster divides the
    grid's x and stays within the portable 8, and S and dP are formed once
    per tile pair up to 8 slabs (d 1024), g = ceil(slabs / 8) times above."""
    width = flash_fwd.padded_head_dim(d)
    n, g, c = flash_fwd.f32_wide_geometry(width)
    written = collections.Counter()
    for plan in flash_bwd.wide_bwd_plans(F32, 8, 4, 300, width) + flash_bwd.wide_bwd_plans(
            F32, 8, 4, 300, width, True, 70, rect=True):
        assert (plan.cluster, plan.col_split, plan.redundancy) == (c, g * c, g)
        assert (plan.grid[0] * plan.col_split) % plan.cluster == 0 and 5 <= plan.cluster <= 8
        assert plan.redundancy == (1 if n <= 8 else math.ceil(n / 8))
        assert plan.smem_bytes <= MAX_SMEM
    for first in range(0, g * c, c):
        summed = collections.Counter()
        for z in range(first, first + c):
            own, cols = flash_fwd.f32_wide_columns(width, z)
            written.update(own)
            summed.update(cols)
            assert set(own) <= set(cols) and (z < n) == bool(own)
        assert set(summed) == set(range(width)) and set(summed.values()) == {1}, first
    assert set(written) == set(range(width)) and set(written.values()) == {1}


@pytest.mark.parametrize("d, width", [(577, 640), (640, 640), (641, 704), (700, 704),
                                      (1000, 1024), (1024, 1024), (2048, 2048)])
def test_padded_head_dims_above_576(d, width):
    assert flash_fwd.padded_head_dim(d) == width and flash_fwd.is_wide(width)
    assert tfa._head_dims(d) == (width, None if width == d else 1.0 / math.sqrt(d))


# --------------------------------------------------------------- on the card


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _qkv(seed, b, sq, sk, h, h_kv, d, dtype):
    """Collapsed q (b·h, sq, width), k and v (b·h_kv, sk, width), zero-padded
    from d to the kernels' width, and the softmax scale to pass."""
    rng = np.random.default_rng(seed)
    width = flash_fwd.padded_head_dim(d)

    def make(rows, s):
        x = torch.from_numpy(rng.standard_normal((rows, s, d)).astype(np.float32))
        return torch.nn.functional.pad(x, (0, width - d)).to("cuda", dtype).contiguous()

    scale = None if width == d else 1.0 / math.sqrt(d)
    return make(b * h, sq), make(b * h_kv, sk), make(b * h_kv, sk), scale


def _err(a, b):
    a, b = a.float(), b.float()
    assert torch.equal(torch.isneginf(a), torch.isneginf(b))
    inf = torch.isneginf(a)
    return float((torch.where(inf, 0.0, a) - torch.where(inf, 0.0, b)).abs().max())


def _tol(dtype):
    return F32_TOL if dtype == F32 else HALF_TOL


@pytest.mark.cuda
def test_the_wide_libraries_build_without_spills(cuda):
    """Each wide library's kernels: ptxas reports 0 spill bytes and no
    serialized wgmma or ignored setmaxnreg."""
    names = ["flash_fwd_wide", "flash_bwd_wide", "flash_fwd_f16_wide", "flash_bwd_f16_wide"]
    built = build.build(names)
    for name in names:
        log = built[name][0].with_suffix(".log").read_text()
        assert "Compiling entry function" in log, name
        assert not re.findall(r"[1-9]\d* bytes spill (stores|loads)", log), (name, log)
        assert "serialized" not in log and "setmaxnreg ignored" not in log, (name, log)


CARD_SHAPES = [  # (b, s, h, h_kv, d)
    (1, 200, 2, 1, 640), (2, 130, 4, 2, 1024), (1, 100, 2, 2, 700), (1, 64, 2, 1, 2048)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, F16, F32])
@pytest.mark.parametrize("b, s, h, h_kv, d", CARD_SHAPES)
def test_wide_triangle_kernels_match_plain(cuda, dtype, b, s, h, h_kv, d):
    """The triangle forward and the triangle pair above 576 against their
    plain versions, one launch each."""
    tol = _tol(dtype)
    qb, kb, vb, scale = _qkv(d, b, s, s, h, h_kv, d, dtype)
    before = [w.launches for w in (flash_fwd.flash_fwd_tri, flash_bwd.flash_bwd_dq_tri,
                                   flash_bwd.flash_bwd_dkv_tri)]
    out, lse = flash_fwd.flash_fwd_tri(qb, kb, vb, h, h_kv, sm_scale=scale)
    want, want_lse = flash_fwd.attention_plain(qb, kb, vb, h, h_kv, True, sm_scale=scale)
    torch.cuda.synchronize()
    assert _err(want, out) <= tol and _err(want_lse, lse) <= LSE_TOL
    rng = np.random.default_rng(d + 1)
    dout = torch.from_numpy(rng.standard_normal(qb.shape).astype(np.float32)).to("cuda", dtype)
    delta = (dout.float() * out.float()).sum(-1)
    dq = flash_bwd.flash_bwd_dq_tri(qb, kb, vb, out, dout, lse, delta, h, h_kv, sm_scale=scale)
    dk, dv = flash_bwd.flash_bwd_dkv_tri(qb, kb, vb, out, dout, lse, delta, h, h_kv,
                                         sm_scale=scale)
    grads = flash_bwd.attention_bwd_plain(qb, kb, vb, out, lse, dout, h, h_kv, True,
                                          sm_scale=scale)
    torch.cuda.synchronize()
    assert [w.launches for w in (flash_fwd.flash_fwd_tri, flash_bwd.flash_bwd_dq_tri,
                                 flash_bwd.flash_bwd_dkv_tri)] == [c + 1 for c in before]
    top = 1.0 if dtype == F32 else max(float(w.float().abs().max()) for w in grads)
    for name, w, g in zip(("dq", "dk", "dv"), grads, (dq, dk, dv)):
        assert float((w.float() - g.float()).abs().max()) <= tol * top, name


GENERAL_MASKS = {  # (sq, sk, causal, window, q_start, k_start, segments)
    "full": (130, 130, False, None, 0, 0, False),
    "window 33": (130, 130, True, 33, 0, 0, False),
    "causal, segments": (130, 130, True, None, 0, 0, True),
    "full, segments": (130, 130, False, None, 0, 0, True),
    "chunked prefill": (40, 200, True, None, 160, 0, False),
    "ring hop": (100, 100, True, None, 100, 0, False),
    "no key in reach": (64, 64, True, None, 0, 128, False),
    "serving decode": (1, 64, True, None, 63, 0, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, F16, F32])
@pytest.mark.parametrize("d", [640, 700, 1024])
def test_wide_general_forward_matches_plain(cuda, dtype, d):
    """The general forward above 576 under every mask, at offsets, sq != sk,
    GQA 2, against the plain version."""
    tol = _tol(dtype)
    for name, (sq, sk, causal, window, q0, k0, segments) in GENERAL_MASKS.items():
        qb, kb, vb, scale = _qkv(sq + sk, 2, sq, sk, 4, 2, d, dtype)
        seg = ((torch.arange(sk, device="cuda") >= sk // 3).to(torch.int32).expand(2, sk)
               .contiguous() if segments else None)
        before = flash_fwd.flash_fwd_rect.launches
        out, lse = flash_fwd.flash_fwd_rect(qb, kb, vb, 4, 2, causal, q0, k0, window, seg,
                                            sm_scale=scale)
        want, want_lse = flash_fwd.attention_plain(qb, kb, vb, 4, 2, causal, q0, k0, window,
                                                   seg, sm_scale=scale)
        torch.cuda.synchronize()
        assert flash_fwd.flash_fwd_rect.launches == before + 1
        assert _err(want, out) <= tol and _err(want_lse, lse) <= LSE_TOL, name


BWD_MASKS = {  # (causal, window, segment cuts or None)
    "full": (False, None, None),
    "window 33": (True, 33, None),
    "causal, segments": (True, None, (64, 150)),
    "full, segments": (False, None, (128,)),
    "window 40, segments": (True, 40, (37,)),
}
GENERAL_SHAPES = [  # (b, s, h, h_kv, d): 640, 1024, the padded 700 -> 704, ragged, 2048
    (1, 256, 2, 1, 640), (2, 130, 4, 2, 1024), (1, 200, 2, 2, 700), (2, 100, 4, 2, 640),
    (1, 128, 2, 1, 2048)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, F16, F32])
@pytest.mark.parametrize("b, s, h, h_kv, d", GENERAL_SHAPES)
def test_wide_general_pair_matches_plain(cuda, dtype, b, s, h, h_kv, d):
    """The general backward pair above 576 under every mask (full, a window,
    segment ids whose whole-document tiles the kernels skip, both), GQA,
    ragged lengths and a padded head, against attention_bwd_plain on the
    general forward's out and lse; one launch of each per mask."""
    tol = _tol(dtype)
    for name, (causal, window, cuts) in BWD_MASKS.items():
        qb, kb, vb, scale = _qkv(s + d, b, s, s, h, h_kv, d, dtype)
        seg = None if cuts is None else torch.tensor(
            _docs(s, cuts), dtype=torch.int32, device="cuda").expand(b, s).contiguous()
        out, lse = flash_fwd.flash_fwd_rect(qb, kb, vb, h, h_kv, causal, window=window, seg=seg,
                                            sm_scale=scale)
        rng = np.random.default_rng(s + 1)
        dout = torch.from_numpy(rng.standard_normal(qb.shape).astype(np.float32)).to("cuda", dtype)
        delta = (dout.float() * out.float()).sum(-1)
        before = [w.launches for w in (flash_bwd.flash_bwd_dq_rect, flash_bwd.flash_bwd_dkv_rect)]
        masks = (h, h_kv, causal, window, seg)
        dq = flash_bwd.flash_bwd_dq_rect(qb, kb, vb, out, dout, lse, delta, *masks,
                                         sm_scale=scale)
        dk, dv = flash_bwd.flash_bwd_dkv_rect(qb, kb, vb, out, dout, lse, delta, *masks,
                                              sm_scale=scale)
        grads = flash_bwd.attention_bwd_plain(qb, kb, vb, out, lse, dout, h, h_kv, causal,
                                              window, seg, sm_scale=scale)
        torch.cuda.synchronize()
        assert [w.launches for w in (flash_bwd.flash_bwd_dq_rect,
                                     flash_bwd.flash_bwd_dkv_rect)] == [c + 1 for c in before]
        top = 1.0 if dtype == F32 else max(float(w.float().abs().max()) for w in grads)
        for grad, w, g in zip(("dq", "dk", "dv"), grads, (dq, dk, dv)):
            assert float((w.float() - g.float()).abs().max()) <= tol * top, (name, grad)


@pytest.mark.cuda
@pytest.mark.parametrize("pair", ["tri", "rect"])
@pytest.mark.parametrize("d", [640, 1024, 2048])
def test_f32_wide_pair_is_deterministic(cuda, pair, d):
    """The f32 pair's clusters add their partial scores in a fixed order
    and no atomics: two runs on the same inputs give the same bits."""
    qb, kb, vb, _ = _qkv(d + 3, 2, 130, 130, 4, 2, d, F32)
    if pair == "tri":
        out, lse = flash_fwd.flash_fwd_tri(qb, kb, vb, 4, 2)
        masks = ()
    else:
        seg = torch.tensor(_docs(130, (50,)), dtype=torch.int32, device="cuda").expand(2, 130)
        masks = (True, 40, seg.contiguous())
        out, lse = flash_fwd.flash_fwd_rect(qb, kb, vb, 4, 2, True, window=40, seg=masks[2])
    dout = torch.randn(qb.shape, generator=torch.Generator(device="cuda").manual_seed(d),
                       device="cuda")
    delta = (dout * out).sum(-1)
    dq_fn = getattr(flash_bwd, f"flash_bwd_dq_{pair}")
    dkv_fn = getattr(flash_bwd, f"flash_bwd_dkv_{pair}")
    runs = [(dq_fn(qb, kb, vb, out, dout, lse, delta, 4, 2, *masks),
             *dkv_fn(qb, kb, vb, out, dout, lse, delta, 4, 2, *masks)) for _ in range(2)]
    torch.cuda.synchronize()
    for grad, a, b in zip(("dq", "dk", "dv"), *runs):
        assert torch.equal(a, b), grad


def _masked_dense(q, k, v, causal, window=None, seg=None):
    """Dense softmax attention (B, S, H, D) under the kernels' masks, f32."""
    b, s, h, d = q.shape
    group = h // k.shape[2]
    k, v = (x.repeat_interleave(group, dim=2) for x in (k, v))
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
    keep = flash_fwd.keep_mask(b * h, s, s, h, causal, window=window, seg=seg, device=q.device)
    scores = scores.masked_fill(~keep.expand(b * h, s, s).reshape(b, h, s, s), -math.inf)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, F32])
def test_flash_attention_above_576_against_dense(cuda, dtype):
    """flash_attention at 700 (padded to 704) and 1024 through the kernels:
    output and gradients against autograd through dense attention, plain
    causal through the triangle pair and under full attention, a window and
    segment ids through the general pair, each with its own launches."""
    tol = _tol(dtype)
    gen = torch.Generator(device="cuda").manual_seed(7)
    seg = (torch.arange(128, device="cuda") >= 48).to(torch.int32)[None]
    cases = {"triangle": {}, "full": {"causal": False}, "window 16": {"window": 16},
             "segments": {"segment_ids": seg}}
    for d in (700, 1024):
        q, k, v = (torch.randn((1, 128, 2, d), generator=gen, device="cuda").to(dtype)
                   .requires_grad_() for _ in range(3))
        for name, kwargs in cases.items():
            wrappers = ((flash_fwd.flash_fwd_tri, flash_bwd.flash_bwd_dq_tri,
                         flash_bwd.flash_bwd_dkv_tri) if name == "triangle" else
                        (flash_fwd.flash_fwd_rect, flash_bwd.flash_bwd_dq_rect,
                         flash_bwd.flash_bwd_dkv_rect))
            before = [w.launches for w in wrappers]
            got = tfa.flash_attention(q, k, v, block_q=64, block_k=64, **kwargs)
            want = _masked_dense(q.float(), k.float(), v.float(), kwargs.get("causal", True),
                                 kwargs.get("window"), kwargs.get("segment_ids"))
            g = torch.randn(got.shape, generator=gen, device="cuda").to(dtype)
            grads = torch.autograd.grad(got, (q, k, v), g)
            wants = torch.autograd.grad(want, (q, k, v), g.float())
            torch.cuda.synchronize()
            assert [w.launches for w in wrappers] == [c + 1 for c in before], (d, name)
            assert float((got.detach().float() - want).abs().max()) <= tol, (d, name)
            top = 1.0 if dtype == F32 else max(float(w.abs().max()) for w in wants)
            for grad, a, w in zip(("dq", "dk", "dv"), grads, wants):
                assert float((a.float() - w).abs().max()) <= tol * top, (d, name, grad)


def test_phase_2_counts_the_wide_instantiations():
    """chip_smoke's build phase expects each wide library to hold its 16-bit
    instantiation of both forwards and of both backward pairs, and no
    other."""
    import chip_smoke

    assert chip_smoke.WIDE_HEAD_INSTANTIATIONS == {
        "flash_fwd_wide": 2, "flash_bwd_wide": 4, "flash_fwd_f16_wide": 2,
        "flash_bwd_f16_wide": 4}
    prefix = "_ZN45_GLOBAL__N__febd979e_12_flash_fwd_cu_10a15fe6"
    assert chip_smoke.wide_label(f"{prefix}21flash_fwd_wide_kernelI13__nv_bfloat16Lb1EEEv6Params"
                                 ) == "wide_tri"
    assert chip_smoke.wide_f16_label(f"{prefix}21flash_fwd_wide_kernelI6__halfLb0EEEv6Params"
                                     ) == "wide_rect"
    assert chip_smoke.wide_label("flash_bwd_dkv_tri_wide_kernelI13__nv_bfloat16EEv6Params"
                                 ) == "dkv_wide"
    assert chip_smoke.wide_f16_label("flash_bwd_dq_tri_wide_kernelI6__halfEEv6Params") == "dq_wide"
    assert chip_smoke.wide_label("flash_bwd_dq_rect_wide_kernelI13__nv_bfloat16EEv6Params"
                                 ) == "dq_rect_wide"
    assert chip_smoke.wide_f16_label("flash_bwd_dkv_rect_wide_kernelI6__halfEEv6Params"
                                     ) == "dkv_rect_wide"
    assert chip_smoke.wide_label("flash_bwd_dkv_rect_wide_f32_kernelE6Paramsi") is None
    # the f32 kernels and the other dtype's instantiations are not counted
    assert chip_smoke.wide_label("flash_fwd_f32_cluster_kernelILb1ELi64EEv6Paramsi") is None
    assert chip_smoke.wide_label("flash_bwd_dq_tri_wide_kernelI6__halfEEv6Params") is None
    assert chip_smoke.wide_label("flash_fwd_tri_kernelI13__nv_bfloat16Li576ELi1EE") is None


def test_phase_3_wide_rows():
    """chip_smoke's rows above 576: phase 19's (1,8192,8,1024) with one kv
    head in bf16 and fp16, 640 and the padded 700 in bf16, f32 at 1024 and
    ragged 640 at GQA 2, for the forward and the triangle pair; the general
    forward at full attention and serving's chunk; the general pair at
    phase 19's packed documents (bf16, the main path's, and fp16), a window
    of 128, full attention, the padded 700 at GQA 2 with a window and
    segments, f32 at 1024 and ragged 640; one 2048 row."""
    import chip_smoke

    fwd, bwd = chip_smoke.WIDE_KERNEL_CASES, chip_smoke.WIDE_BWD_CASES
    tri = [c for c in bwd if c["pair"] == "tri"]
    rect = [c for c in bwd if c["pair"] == "rect"]
    assert {c["kernel"] for c in fwd} == {"flash_fwd_tri", "flash_fwd_rect"}
    assert {c["pair"] for c in bwd} == {"tri", "rect"}
    for dtype, main in ((BF16, True), (F16, False)):
        assert any(c["q"] == (1, 8192, 8, 1024) and c.get("h_kv") == 1 and c.get("packed") == 2
                   and c["dtype"] == dtype and bool(c.get("main")) == main for c in rect), dtype
    assert any(c["q"] == (1, 8192, 8, 1024) and c.get("window") == 128 and c["dtype"] == BF16
               for c in rect)
    assert any(c["q"] == (1, 4096, 8, 1024) and c.get("causal") is False and c["dtype"] == BF16
               for c in rect)
    assert any(c["q"] == (2, 1000, 4, 700) and c.get("h_kv") == 2 and c.get("window") == 33
               and c.get("cut") is not None and c["dtype"] == BF16 for c in rect)
    assert any(c["q"] == (2, 128, 4, 1024) and c.get("window") == 33 and c.get("cut") is not None
               and c["dtype"] == F32 for c in rect)
    assert any(c["q"] == (2, 100, 4, 640) and c.get("h_kv") == 2 and c.get("cut") is not None
               and c["dtype"] == F32 for c in rect)
    for case in rect:
        d = case["q"][3]
        assert flash_fwd.is_wide(flash_fwd.padded_head_dim(d)), case["label"]
        assert ("padded" in case["label"]) == (d % 64 != 0)
    for rows in (fwd, tri):
        for case in rows:
            d = case["q"][3]
            assert flash_fwd.is_wide(flash_fwd.padded_head_dim(d)), case["label"]
            assert ("padded" in case["label"]) == (d % 64 != 0)
        for dtype in (BF16, F16):
            assert any(c["dtype"] == dtype and c["q"] == (1, 8192, 8, 1024) and c.get("h_kv") == 1
                       for c in rows), dtype
        assert any(c["q"] == (1, 8192, 8, 640) and c["dtype"] == BF16 for c in rows)
        assert any(c["q"] == (1, 4096, 8, 700) and c["dtype"] == BF16 for c in rows)
        assert any(c["q"] == (2, 128, 4, 1024) and c["dtype"] == F32 for c in rows)
        assert any(c["q"] == (2, 100, 4, 640) and c.get("h_kv") == 2 and c["dtype"] == F32
                   for c in rows)
    assert any(c["q"] == (1, 4096, 8, 1024) and c.get("causal") is False for c in fwd)
    # the f32 pair at phase 19's head layout past launch-bound sizes, and
    # past 8 slabs (two clusters a tile)
    assert any(c["q"] == (1, 2048, 8, 1024) and c.get("h_kv") == 1 and c["dtype"] == F32
               for c in tri)
    assert any(c["q"] == (1, 128, 2, 2048) and c["dtype"] == F32 for c in tri)
    assert any(c["q"] == (1, 8, 2, 1024) and c.get("sk") == 64 and c["dtype"] == F32
               and c.get("main") for c in fwd)
    assert any(c["q"] == (1, 1024, 4, 2048) for c in fwd)
    assert chip_smoke.WIDE_HEAD_1024["d_model"] // chip_smoke.WIDE_HEAD_1024["n_heads"] == 1024
