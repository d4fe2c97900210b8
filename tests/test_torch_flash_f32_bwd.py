"""The f32 flash backward pair: at head dims 256, 512 and 576 the slab CTAs
of a tile in one thread-block cluster that add their partial S and dP
through distributed shared memory (``flash_bwd.cu``'s
``flash_bwd_{dq,dkv}_{tri,rect}_wide_f32_kernel``, ``kernels/flash_cluster.cuh``),
at 32-128 the same pair at one CTA a tile on a slab as wide as the head
(``flash_bwd_{dq,dkv}_{tri,rect}_tile_f32_kernel<W>``; 16 keeps the
whole-row pair, which that design did not beat there), and dK/dV's GQA walk
split in parts whose partial sums a second kernel adds
(``flash_bwd_dkv_split_sum_kernel``). On the CPU: both pairs' plans at these
head dims and at the padded widths that map there (slabs, clusters, tiles,
grids, shared memory, the library), the walks against the plain version's
mask (a window, segments, GQA, a split walk), the split rule
(``flash_bwd.gqa_split``) on stubbed resident-cluster counts, the constants
against the CUDA sources, and the plain version against the JAX package's
flash backward (the one test that imports JAX, inside it). The card tests
run on a machine with a card and no JAX:

    python -m pytest tests/test_torch_flash_f32_bwd.py --noconftest -q -m cuda

both pairs against ``attention_bwd_plain`` (1e-4 absolute, as
``tests/test_torch_kernels.py``), a split walk forced through a hand-made
plan, two runs bit for bit, a misaligned base refused, and the build's
registers and spills.
"""

import collections
import dataclasses
import math
import pathlib
import re

import numpy as np
import pytest
import torch

from tpu_operator_torch.kernels import build, flash_bwd, flash_fwd

F32 = torch.float32
MAX_SMEM = 232_448  # bytes of shared memory a block may use on the H100
H100_SMS = 132
KERNELS = pathlib.Path(flash_fwd.__file__).parent
F32_TOL, LSE_TOL = 1e-4, 1e-3
NATIVE = [256, 512, 576]
# the native widths and the padded ones that map there
HEAD_DIMS = NATIVE + [129, 200, 255, 257, 320, 384, 511, 513, 544, 575]
# (n, g, c): slabs, clusters a tile and CTAs a cluster
GEOMETRY = {256: (2, 1, 2), 512: (4, 1, 4), 576: (5, 1, 5)}
# 32-128: one CTA a tile on a slab of the head's width (16: the whole-row pair)
TILE_DIMS = [32, 64, 128]
# the widths of the tile pair and the padded ones that map there: (d, width, slab)
TILE_HEAD_DIMS = [(32, 32, 64), (64, 64, 64), (96, 128, 128), (128, 128, 128),
                  (17, 32, 64), (33, 64, 64), (80, 128, 128), (112, 128, 128)]
# the tile pair's shared memory: two resident tiles and two ring stages of two
# tiles of the slab's width, and the score tiles (dQ: dS^T; dK/dV: P^T and dS^T)
TILE_SMEM = {64: (114_688, 131_072), 128: (212_992, 229_376)}
# the widths the split, walk and card tests run at
SPLIT_DIMS = [64, 128] + NATIVE


def _pairs(d, bh=8, bh_kv=4, s=130, clusters=None):
    """Both pairs' (dq, dkv) plans at d as the wrappers build them: the
    triangle's and the general pair's under a window of 33."""
    return {"tri": flash_bwd.tri_bwd_plan(F32, bh, bh_kv, s, d, H100_SMS, clusters=clusters),
            "rect": flash_bwd.rect_bwd_plan(F32, bh, bh_kv, s, d, H100_SMS, True, 33,
                                            clusters=clusters)}


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_the_pair_plans_at_every_head_dim(d):
    """64-row tiles, 256 threads, no swizzle, 128-column slabs in two
    streamed stages, the slab CTAs of a tile in one cluster of 2, 4 or 5;
    grid (tiles, rows); the cluster kernels' shared memory; the wide
    library; no split without a resident-cluster count."""
    width = flash_fwd.padded_head_dim(d)
    n, g, c = GEOMETRY[width]
    assert flash_fwd.f32_wide_geometry(width) == (n, g, c)
    assert flash_fwd.library_name("flash_bwd", F32, width) == "flash_bwd_wide"
    for pair, (dq, dkv) in _pairs(width).items():
        for plan, rows in ((dq, 8), (dkv, 4)):
            assert (plan.block, plan.threads, plan.swizzle) == (64, 256, 0), pair
            assert (plan.col_split, plan.cluster, plan.slab, plan.stages) == (g * c, c, 128, 2)
            assert (plan.redundancy, plan.split, plan.grid) == (1, 1, (3, rows))
            assert plan.workspace(130, width) is None
            assert (plan.causal, plan.window) == ((True, None) if pair == "tri" else (True, 33))
        assert dq.smem_bytes == 4 * (2 * 64 * 128 + 2 * 2 * 64 * 128 + 2 * 64 * 64
                                     + 2 * 64) == 229_888 <= MAX_SMEM
        assert dkv.smem_bytes == 229_888 - 4 * 2 * 64 == 229_376


@pytest.mark.parametrize("d, width, slab", TILE_HEAD_DIMS + [(16, 16, 0), (1, 16, 0)])
def test_below_256_f32_keeps_the_whole_row_pair(d, width, slab):
    """f32 at 32-128 (and the heads padded there): a CTA holds a tile's
    whole rows of the head, as the cluster pair at c = 1 on one slab as wide
    as the head (64 columns at d 32 and 64, 128 at 128): 64-row tiles, 256
    threads, no swizzle, one CTA a tile (no cluster, no slab CTAs), two ring
    stages, grid (tiles, rows), the wide library; dK/dV's split from
    gqa_split at the card's resident CTAs. At 16 (and the heads padded
    there) the whole-row pair stays: one CTA of 64 rows a tile in the base
    library, no split. 16-bit at 256, 512 and 576 keeps its libraries."""
    assert flash_fwd.padded_head_dim(d) == width
    if width == flash_bwd.F32_WHOLE_ROW_D:
        dq, dkv = flash_bwd.tri_bwd_plan(F32, 8, 4, 130, width, H100_SMS, clusters=30)
        assert (dq.block, dq.cluster, dq.col_split, dkv.split) == (64, 1, 1, 1)
        assert (dq.slab, dkv.slab) == (0, 0)
        assert flash_fwd.library_name("flash_bwd", F32, width) == "flash_bwd"
        return
    assert flash_bwd.f32_tile_width(width) == slab
    assert flash_fwd.library_name("flash_bwd", F32, width) == "flash_bwd_wide"
    assert flash_fwd.library_name("flash_fwd", F32, width) == "flash_fwd_wide"  # its tile forward
    for pair, (dq, dkv) in _pairs(width, 8, 1, 2048, clusters=264).items():
        for plan, rows in ((dq, 8), (dkv, 1)):
            assert (plan.block, plan.threads, plan.swizzle, plan.ring) == (64, 256, 0, 64), pair
            assert (plan.col_split, plan.cluster, plan.slab, plan.stages) == (1, 1, slab, 2)
            assert plan.redundancy == 1
        assert dq.grid == (32, 8) and dq.split == 1
        assert dkv.split == flash_bwd.gqa_split(_split(dkv, 1), 2048, 8, 1, 264)
        assert dkv.grid == (32, dkv.split) and dkv.workspace(2048, width) == (
            None if dkv.split == 1 else (2, dkv.split, 1, 2048, width))
        assert (dq.smem_bytes, dkv.smem_bytes) == TILE_SMEM[slab]
        assert (dq.smem_bytes, dkv.smem_bytes) == (flash_bwd.f32_tile_smem(width, "dq"),
                                                   flash_bwd.f32_tile_smem(width, "dkv"))
    for d, name in ((256, "flash_bwd"), (512, "flash_bwd_d512"), (576, "flash_bwd_d576")):
        assert flash_fwd.library_name("flash_bwd", torch.bfloat16, d) == name
        assert flash_fwd.library_name("flash_bwd", torch.float16, d) == name.replace(
            "flash_bwd", "flash_bwd_f16")


@pytest.mark.parametrize("slab", [64, 128])
def test_the_tile_pair_shared_memory_by_hand(slab):
    """At a 64-column slab dQ holds 114,688 bytes (resident tiles 32 KiB,
    the ring 64 KiB, its dS^T tile 16 KiB), so two dQ CTAs and their 1 KiB
    reserves fit an SM's 228 KiB; dK/dV holds P^T and dS^T side by side,
    131,072 (one CTA an SM). At 128 dQ holds 212,992 and dK/dV 229,376."""
    f = 4 * 64 * slab
    scores = 4 * 64 * 64
    dq, dkv = TILE_SMEM[slab]
    assert dq == 2 * f + 2 * 2 * f + scores
    assert dkv == dq + scores
    if slab == 64:
        assert 2 * (dq + 1024) <= 228 * 1024 < 2 * (dkv + 1024)
    assert max(dq, dkv) <= MAX_SMEM


@pytest.mark.parametrize("c", [2, 4, 5])
def test_the_exchange_rows_at_each_cluster(c):
    """CTA r of a cluster of c sums rows [64 r / c, 64 (r + 1) / c) of the
    partial S and dP: every row once, at most 32 rows a CTA, so a row's 16
    float4s a thread take at most two passes of 256 threads."""
    rows = collections.Counter()
    for r in range(c):
        a0, a1 = 64 * r // c, 64 * (r + 1) // c
        rows.update(range(a0, a1))
        assert (a1 - a0) * 16 <= 2 * 256
    assert set(rows) == set(range(64)) and set(rows.values()) == {1}


def test_the_last_slab_at_576_overlaps():
    """At 576 the fifth slab starts at 448 and writes 512-575 only; every
    column is summed and written once in the tile's cluster."""
    written, summed = collections.Counter(), collections.Counter()
    for z in range(5):
        own, cols = flash_fwd.f32_wide_columns(576, z)
        written.update(own)
        summed.update(cols)
    assert flash_fwd.f32_wide_columns(576, 4)[0] == range(512, 576)
    assert set(written) == set(summed) == set(range(576))
    assert set(written.values()) == set(summed.values()) == {1}


# the split rule's predictions: (bh, bh_kv, s, d, resident dK/dV clusters)
# -> (the heaviest walk at split 1, ceil(P / R), split)
PREDICTED = {
    (8, 1, 2048, 512, 30): (256, 141, 2),
    (8, 1, 2048, 256, 66): (256, 64, 4),
    (8, 1, 2048, 1024, 15): (256, 282, 1),
    (8, 4, 100, 640, 22): (4, 2, 2),
    # up to 128 the resident CTAs: 132 SMs at one CTA each (d 128) or two (64)
    (8, 1, 2048, 128, 132): (256, 32, 8),
    (8, 1, 2048, 64, 264): (256, 16, 8),
    (32, 32, 128, 64, 264): (2, 1, 1),
    (8, 2, 1000, 128, 132): (64, 9, 4),
}


@pytest.mark.parametrize("key", sorted(PREDICTED))
def test_the_split_rule_on_stubbed_clusters(key):
    """The smallest divisor of the group that minimises max(H / sp, ceil(P
    / R)) in tile pairs: the (1,2048,8,{256,512}) rows with one kv head
    split in 4 and 2, (1,2048,8,1024) keeps 1 (P / R already passes H), the
    ragged (2,100,4,640) at GQA 2 splits in 2; the partials' workspace is
    (2, split, kv rows, s, d)."""
    bh, bh_kv, s, d, clusters = key
    heavy, floor, want = PREDICTED[key]
    group, tiles = bh // bh_kv, -(-s // 64)
    pairs = bh_kv * group * tiles * (tiles + 1) // 2
    assert (tiles * group, -(-pairs // clusters)) == (heavy, floor)
    _, dkv = flash_bwd.tri_bwd_plan(F32, bh, bh_kv, s, d, H100_SMS, clusters=clusters)
    assert dkv.split == want and group % dkv.split == 0
    assert dkv.grid == (tiles, bh_kv * want)
    assert dkv.workspace(s, d) == (None if want == 1 else (2, want, bh_kv, s, d))
    # no divisor does better, and a smaller one does worse
    pace = {sp: max(heavy // sp, floor) for sp in range(1, group + 1) if group % sp == 0}
    assert pace[want] == min(pace.values())
    assert all(pace[sp] > pace[want] for sp in pace if sp < want)


@pytest.mark.parametrize("clusters", [1, 15, 30, 66, 10_000])
@pytest.mark.parametrize("d", SPLIT_DIMS)
def test_the_split_divides_the_group_and_is_1_at_gqa_1(d, clusters):
    """At GQA 1 nothing splits; the split always divides the group, also
    under the general masks (the band's walk); dQ never splits."""
    for bh, bh_kv in ((8, 8), (8, 1), (12, 2), (6, 3)):
        for pair, (dq, dkv) in _pairs(d, bh, bh_kv, 2048, clusters).items():
            group = bh // bh_kv
            assert dq.split == 1 and group % dkv.split == 0, (pair, bh, bh_kv)
            if group == 1:
                assert dkv.split == 1
    # full attention: every key tile walks every q tile, so the pace is the
    # walk at any card size here, and the whole group splits
    _, dkv = flash_bwd.rect_bwd_plan(F32, 8, 1, 2048, d, H100_SMS, False, clusters=10_000)
    assert dkv.split == 8


def _docs(s, cuts):
    return [sum(i >= c for c in cuts) for i in range(s)]


def _split(plan, sp):
    """``plan`` (dK/dV) with its GQA walk in ``sp`` parts, as a plan built
    for a card that chose sp."""
    rows = plan.grid[1] // plan.split
    return dataclasses.replace(plan, grid=(plan.grid[0], rows * sp), split=sp)


@pytest.mark.parametrize("d", SPLIT_DIMS)
@pytest.mark.parametrize("group, split", [(1, 1), (2, 1), (2, 2), (4, 2), (4, 4)])
@pytest.mark.parametrize("s, causal, window, cuts", [
    (1, True, None, None), (63, True, None, None), (130, True, None, None),
    (130, False, None, None), (130, True, 33, (88,)), (300, True, 70, None),
    (300, True, None, (128, 200)), (300, False, None, (64, 200)), (100, True, 33, (37,))])
def test_the_walks_visit_exactly_the_live_pairs(d, group, split, s, causal, window, cuts):
    """Both kernels' walks at 64-576 (64-row tiles both sides; dQ in
    order, dK/dV over the members of its part): every (q tile, key tile)
    pair of the band whose tiles do not hold two different documents each
    whole is visited once per slab CTA and GQA member, and no other; those
    are every pair that holds a live (q, k) pair of the plain version's
    mask, and with at most one boundary no more. The triangle pair walks
    exactly the live pairs of the causal triangle."""
    rows, kv_rows = 2 * group, 2
    tiles = -(-s // 64)
    seg = None if cuts is None else torch.tensor(_docs(s, cuts), dtype=torch.int32)[None]
    ids = None if seg is None else seg[0].tolist()

    def tile_pairs(keep):
        return {(q, k) for q in range(tiles) for k in range(tiles)
                if bool(keep[q * 64:(q + 1) * 64, k * 64:(k + 1) * 64].any())}

    live = tile_pairs(flash_fwd.keep_mask(1, s, s, 1, causal, window=window, seg=seg)[0])
    band = tile_pairs(flash_fwd.keep_mask(1, s, s, 1, causal, window=window)[0])
    walked = {(q, k) for q, k in band if ids is None or not flash_bwd.apart(
        ids[q * 64:(q + 1) * 64], ids[k * 64:(k + 1) * 64])}
    assert live <= walked and (len(cuts or ()) > 1 or live == walked)
    plans = [flash_bwd.rect_bwd_plan(F32, rows, kv_rows, s, d, H100_SMS, causal, window)]
    if causal and window is None and cuts is None:
        plans.append(flash_bwd.tri_bwd_plan(F32, rows, kv_rows, s, d, H100_SMS))
    for dq, dkv in plans:
        for plan, n_rows, members in ((dq, rows, 1), (_split(dkv, split), kv_rows, group)):
            got = collections.Counter(
                (z, plan.cta(x, y)[0], *v) for z in range(plan.col_split)
                for x in range(plan.grid[0]) for y in range(plan.grid[1])
                for v in plan.visits(x, y, s, members, ids))
            assert set(got.values()) <= {1}, plan.kernel
            assert set(got) == {(z, row, m, q, k) for z in range(plan.col_split)
                                for row in range(n_rows) for m in range(members)
                                for q, k in walked}, plan.kernel


def test_a_split_part_walks_its_own_members():
    """A split dK/dV's grid holds split x kv rows: the launch's n-th cluster
    (block x + tiles·y) takes key tile n // rows of grid row n % rows
    (tile-major: every row's and part's key tile 0 first), and grid row r
    walks the members of part r // kv rows on kv row r % kv rows."""
    _, dkv = flash_bwd.tri_bwd_plan(F32, 8, 2, 130, 512, H100_SMS)
    plan = _split(dkv, 2)
    assert plan.grid == (3, 4) and plan.workspace(130, 512) == (2, 2, 2, 130, 512)
    order = sorted((x + 3 * y, x, y) for x in range(3) for y in range(4))
    assert [plan.cta(x, y)[1] for _, x, y in order] == [0] * 4 + [1] * 4 + [2] * 4
    seen = set()
    for n, x, y in order:
        row, tile = plan.cta(x, y)
        part = (n % 4) // 2
        assert (row, tile) == (n % 4 % 2, n // 4)
        assert {m for m, _, _ in plan.visits(x, y, 130, 4)} == {2 * part, 2 * part + 1}
        seen.add((part, row, tile))
    assert len(seen) == 12


def test_plan_constants_match_the_cuda_sources():
    """The cluster pair's head dims are the forward's (one helper in the
    shared header); the f32 pair at 16-128 is the tile kernels' (the
    whole-row f32 kernels, their layouts and dispatch are gone), with the
    plans' slab widths, shared memory and CTAs an SM; the dK/dV entries and
    kernels take the split and the partials, at every f32 head dim; the
    16-bit wide kernels keep their gate above 576."""
    bwd = (KERNELS / "flash_bwd.cu").read_text()
    fwd = (KERNELS / "flash_fwd.cu").read_text()
    cluster = (KERNELS / "flash_cluster.cuh").read_text()
    assert "__host__ __device__ constexpr bool f32_cluster_head_dim(int d) {\n  return d >= 256 " \
           "&& d % kF32WideChunk == 0;\n}" in cluster
    assert "f32_cluster_head_dim(int d)" not in fwd + bwd
    assert flash_fwd.F32_CLUSTER_MIN_D == 256
    assert "!f32_bwd_head_dim(d) ||" in bwd and "if (!f32_cluster_head_dim(d)) return " \
           "kUnsupported;" in bwd
    assert "bool f32_bwd_head_dim(int d) { return f32_tile_head_dim(d) || " \
           "f32_cluster_head_dim(d); }" in bwd
    assert "return d == 32 || d == 64 || d == 128;" in bwd
    assert flash_bwd.F32_TILE_HEAD_DIMS == (32, 64, 128) and flash_bwd.F32_WHOLE_ROW_D == 16
    assert "if (!wide_head_dim(d) || split != 1 || swizzle != WideGeo::kRowBytes" in bwd
    # the whole-row f32 pair at head dim 16 alone (the base bf16 library)
    assert bwd.count('static_assert(D == 16, "f32 at head dims 32 and above: flash_bwd_wide\'s '
                     'pair");') == 2
    assert "  if (d == 16) return launch<T, 16, K>(p, rows, stream);\n#endif\n  return kUnsupported;" \
        in bwd
    assert not re.search(r"case \d+: return launch<", bwd) and not re.search(r"\bf32_tile\(", bwd)
    assert not hasattr(flash_bwd, "f32_tile")
    # the tile pair's layout: slabs of 64 up to d 64 (two dQ CTAs an SM), 128 at 128
    assert "if (d <= 64) return launch_f32_tile<K, 64>(p, rows, d, smem, split, stream);" in bwd
    assert "if (d == 128) return launch_f32_tile<K, kF32WideSlab>(" in bwd
    assert ("constexpr int f32_tile_ctas(int w, bool dq) { return dq && w < kF32WideSlab ? 2 "
            ": 1; }") in bwd
    assert ("return 4 * ((2 + 2 * kF32WideStages) * kF32WideTile * W + (DQ ? 1 : 2) * "
            "kF32TileFloats);") in bwd
    assert [flash_bwd.f32_tile_width(d) for d in TILE_DIMS] == [64, 64, flash_fwd.F32_SLAB]
    # the split: the dK/dV kernels and entries, the sum in part order
    assert "bool split_takes(int dtype, int d) { return dtype == 0 && f32_bwd_head_dim(d); }" in bwd
    for pair in ("tri", "rect"):
        assert f"flash_bwd_dkv_{pair}_wide_f32_kernel(Params p, int d, int sp)" in bwd
        assert f"flash_bwd_dkv_{pair}_tile_f32_kernel(Params p, int d, int sp)" in bwd
        sig = bwd[bwd.index(f'extern "C" int flash_bwd_dkv_{pair}('):]
        assert "float* partials, int split" in sig[:sig.index("{")]
    assert "flash_bwd_dkv_split_sum_kernel(const float4* __restrict__ parts" in bwd
    assert "for (int j = 1; j < sp; ++j)" in bwd and "atomicAdd" not in bwd
    # the exchange: up to 32 rows a CTA at c = 2, two passes of 256 threads
    assert "float4 pv[2], dsv[2];" in bwd
    assert "const int m_end = (row / p.rows + 1) * (group / sp);" in bwd


def test_phase_2_and_3_cover_the_cluster_pair():
    """chip_smoke's build phase expects the backward cluster kernels, the
    tile kernels at both slab widths and the split's sum in flash_bwd_wide
    and no f32 kernel in the base, D 512 and 576 libraries; phase 3 has the
    f32 pair at 64, 128, 256, 512 and 576 under both masks, the
    (1,2048,8,{64,128,256,512}) triangle rows with one kv head, the ragged
    general pair at (2,1000,4,128) with GQA 2 and a cut inside a tile, and
    the entry() widths' (8,128,4,64) triangle."""
    import chip_smoke

    assert sorted(chip_smoke.F32_BWD_CLUSTER_KERNELS) == sorted(
        [f"flash_bwd_{k}_{p}_wide_f32_kernel" for k in ("dq", "dkv") for p in ("tri", "rect")]
        + ["flash_bwd_dkv_split_sum_kernel"])
    for name in chip_smoke.F32_BWD_CLUSTER_KERNELS:
        assert chip_smoke.f32_label(f"_ZN12_GLOBAL__N_1{len(name)}{name}E6Paramsii") == name
    assert len(chip_smoke.F32_BWD_TILE_KERNELS) == 8
    for kind in ("dq", "dkv"):
        for pair in ("tri", "rect"):
            for width in (64, 128):
                name = f"flash_bwd_{kind}_{pair}_tile_f32_kernel"
                mangled = f"_ZN12_GLOBAL__N_1{len(name)}{name}ILi{width}EEEv6Paramsi"
                label = chip_smoke.f32_label(mangled)
                assert label == f"{name}<{width}>" and label in chip_smoke.F32_BWD_TILE_KERNELS
                assert not chip_smoke.whole_row_f32(mangled)
    tile_rows = [c for c in chip_smoke.BWD_CASES if c["dtype"] == F32]
    for d in (64, 128):
        assert {c["pair"] for c in tile_rows if c["q"][3] == d} == {"tri", "rect"}, d
        assert any(c["q"] == (1, 2048, 8, d) and c.get("h_kv") == 1 and c["pair"] == "tri"
                   for c in tile_rows), d
    assert any(c["q"] == (2, 1000, 4, 128) and c.get("h_kv") == 2 and c["pair"] == "rect"
               and c.get("cut") % 64 for c in tile_rows)
    assert any(c["q"] == (8, 128, 4, 64) and c["pair"] == "tri" for c in tile_rows)
    assert chip_smoke.whole_row_f32("_ZN12_GLOBAL__N_123flash_bwd_dq_tri_kernelIfLi512EEEv6Params")
    assert not chip_smoke.whole_row_f32("flash_bwd_dq_tri_kernelI13__nv_bfloat16Li512ELi1EE")
    assert not chip_smoke.whole_row_f32("flash_bwd_dkv_tri_wide_f32_kernelE6Paramsii")
    rows = (chip_smoke.HEAD_DIM_BWD_CASES + chip_smoke.HEAD_DIM_512_BWD_CASES
            + chip_smoke.HEAD_DIM_576_BWD_CASES)
    f32 = [c for c in rows if c["dtype"] == F32]
    for d in NATIVE:
        assert {c["pair"] for c in f32 if c["q"][3] == d} == {"tri", "rect"}, d
    for d in (256, 512):
        assert any(c["q"] == (1, 2048, 8, d) and c.get("h_kv") == 1 and c["pair"] == "tri"
                   for c in f32), d


@pytest.mark.parametrize("b, s, h, h_kv, d, cut, block", [
    (1, 256, 8, 1, 128, None, 64), (2, 100, 4, 2, 64, 37, 50)])
def test_the_plain_backward_matches_the_jax_flash_backward(b, s, h, h_kv, d, cut, block):
    """attention_bwd_plain in f32, the version the pair is held to on the
    card, against the JAX package's flash backward (``jax.grad`` through its
    ``flash_attention``, whose Pallas kernels run in interpret mode on the
    CPU, as its own tests run them) on the same numpy inputs: dQ, dK and dV
    within 1e-4. The triangle at (1,256,8,128) with one kv head (the (1,2048,
    8,128) row's GQA group), and the causal masks with two documents, cut at
    37, at a ragged (2,100,4,64) with two kv heads."""
    import jax
    import jax.numpy as jnp

    from tpu_operator.workloads import flashattention as jfa

    rng = np.random.default_rng(d + s)
    q, k, v, w = (rng.standard_normal(shape).astype(np.float32)
                  for shape in ((b, s, h, d), (b, s, h_kv, d), (b, s, h_kv, d), (b, s, h, d)))
    seg = None if cut is None else np.repeat((np.arange(s) >= cut).astype(np.int32)[None], b, 0)

    def loss(q, k, v):
        out = jfa.flash_attention(q, k, v, causal=True, block_q=block, block_k=block,
                                  segment_ids=None if seg is None else jnp.asarray(seg))
        return jnp.sum(out.astype(jnp.float32) * w)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))

    def rows(x):  # (B, S, H, D) -> the kernels' (B·H, S, D)
        return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1, 3))).reshape(
            -1, s, d)

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        qb, kb, vb, dout = rows(q), rows(k), rows(v), rows(w)
        tseg = None if seg is None else torch.from_numpy(seg)
        out, lse = flash_fwd.attention_plain(qb, kb, vb, h, h_kv, causal=True, seg=tseg)
        got = flash_bwd.attention_bwd_plain(qb, kb, vb, out, lse, dout, h, h_kv, True, seg=tseg)
    finally:
        torch.set_num_threads(before)
    for grad, wj, g in zip(("dq", "dk", "dv"), want, got):
        wt = rows(np.asarray(wj))
        assert wt.shape == g.shape and g.dtype == F32, grad
        assert float((wt - g).abs().max()) <= F32_TOL, grad


def test_kernel_ab_times_every_f32_backward_row():
    """``scripts/kernel_ab.py --family bwd_f32`` (parent against change on
    one card) takes every f32 row of phase 3's backward tables, the rows up
    to head dim 128 among them, and times both kernels of each."""
    import importlib.util
    import inspect

    import chip_smoke

    spec = importlib.util.spec_from_file_location(
        "kernel_ab", pathlib.Path(chip_smoke.__file__).parent / "scripts" / "kernel_ab.py")
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    assert ab.FAMILIES["bwd_f32"][1:] == (("dq_ms", "dkv_ms"), "flash_bwd")
    body = inspect.getsource(ab._bwd_f32)
    tables = ("BWD_CASES", "HEAD_DIM_BWD_CASES", "HEAD_DIM_512_BWD_CASES",
              "HEAD_DIM_576_BWD_CASES", "WIDE_BWD_CASES")
    assert all(f"smoke.{name}" in body for name in tables)
    assert "padded_head_dim" not in body  # no width left out
    rows = [c for name in tables for c in getattr(chip_smoke, name) if c["dtype"] == F32]
    labels = [c["label"] for c in rows]
    assert len(labels) == len(set(labels))
    assert {flash_fwd.padded_head_dim(c["q"][3]) for c in rows} >= set(TILE_DIMS)


# --------------------------------------------------------------- on the card


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(seed, b, s, h, h_kv, d, masks=None):
    """f32 q, k, v (zero-padded from d to the kernels' width), the forward's
    out and lse through the kernels, dO and delta on the card, and the
    softmax scale to pass."""
    rng = np.random.default_rng(seed)
    width = flash_fwd.padded_head_dim(d)

    def make(rows):
        x = torch.from_numpy(rng.standard_normal((rows, s, d)).astype(np.float32))
        return torch.nn.functional.pad(x, (0, width - d)).to("cuda").contiguous()

    scale = None if width == d else 1.0 / math.sqrt(d)
    qb, kb, vb, dout = make(b * h), make(b * h_kv), make(b * h_kv), make(b * h)
    if masks is None:
        out, lse = flash_fwd.flash_fwd_tri(qb, kb, vb, h, h_kv, sm_scale=scale)
    else:
        out, lse = flash_fwd.flash_fwd_rect(qb, kb, vb, h, h_kv, masks[0], window=masks[1],
                                            seg=masks[2], sm_scale=scale)
    delta = (dout * out).sum(-1)
    return qb, kb, vb, out, dout, lse, delta, scale


def _masks(kind, b, s):
    """(causal, window, seg) of a general-pair case."""
    if kind == "full":
        return (False, None, None)
    seg = torch.tensor(_docs(s, (s // 3,)), dtype=torch.int32, device="cuda")
    return (True, 33, seg.expand(b, s).contiguous())


@pytest.mark.cuda
def test_the_cluster_pair_builds_without_spills(cuda):
    """flash_bwd_wide holds the four f32 cluster kernels, the eight tile
    kernels (four at each slab width) and the split's sum, each at most 255
    registers (dQ at a 64-column slab 128: two CTAs an SM) and 0 spill
    bytes, and each places a cluster at 256, 512 and 576 and its resident
    CTAs at 32-128 (two dQ CTAs an SM at 32 and 64); the D 512 and 576
    libraries hold no f32 kernel, the base one the whole-row pair at 16
    alone."""
    import chip_smoke

    built = build.build(["flash_bwd_wide", "flash_bwd", "flash_bwd_d512", "flash_bwd_d576"])
    report = chip_smoke.ptxas_by_function(
        built["flash_bwd_wide"][0].with_suffix(".log").read_text())
    found = {chip_smoke.f32_label(k): v for k, v in report.items() if chip_smoke.f32_label(k)}
    assert sorted(found) == sorted(chip_smoke.F32_BWD_CLUSTER_KERNELS
                                   + chip_smoke.F32_BWD_TILE_KERNELS), found
    for name, stats in found.items():
        assert stats["spill_stores"] == 0 and stats["spill_loads"] == 0, (name, stats)
        two = name.startswith("flash_bwd_dq_") and name.endswith("_tile_f32_kernel<64>")
        assert stats["registers"] <= (128 if two else 255), (name, stats)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for d in TILE_DIMS:
        for kernel in ("dq", "dkv"):
            for tri in (True, False):
                assert flash_bwd.f32_wide_active_clusters(d, kernel, tri) == sms * (
                    2 if d <= 64 and kernel == "dq" else 1), (d, kernel, tri)
    for name in ("flash_bwd", "flash_bwd_d512", "flash_bwd_d576"):
        kernels = chip_smoke.ptxas_by_function(built[name][0].with_suffix(".log").read_text())
        kept = [k for k in kernels if chip_smoke.whole_row_f32(k)]
        assert len(kept) == (4 if name == "flash_bwd" else 0), name
        assert all("IfLi16E" in k for k in kept), kept
    for d in NATIVE:
        for kernel in ("dq", "dkv"):
            for tri in (True, False):
                assert flash_bwd.f32_wide_active_clusters(d, kernel, tri) > 0, (d, kernel, tri)


CARD_ROWS = [(b, s, h, h_kv) for s in (1, 63, 100, 130) for b, h, h_kv in ((2, 2, 2), (1, 4, 1))]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16] + TILE_DIMS + [96] + NATIVE + [200, 544])
@pytest.mark.parametrize("b, s, h, h_kv", CARD_ROWS)
def test_the_pair_matches_plain(cuda, b, s, h, h_kv, d):
    """Both pairs, the triangle and the general masks (full attention; a
    window of 33 with a segment boundary), GQA 1 and 4, ragged lengths,
    padded heads: each kernel once through its wrapper, against
    attention_bwd_plain within 1e-4."""
    for kind in ("tri", "full", "window, segments"):
        masks = None if kind == "tri" else _masks(kind, b, s)
        qb, kb, vb, out, dout, lse, delta, scale = _inputs(d + s, b, s, h, h_kv, d, masks)
        pair = "tri" if masks is None else "rect"
        extra = () if masks is None else masks
        dq_fn = getattr(flash_bwd, f"flash_bwd_dq_{pair}")
        dkv_fn = getattr(flash_bwd, f"flash_bwd_dkv_{pair}")
        before = (dq_fn.launches, dkv_fn.launches)
        dq = dq_fn(qb, kb, vb, out, dout, lse, delta, h, h_kv, *extra, sm_scale=scale)
        dk, dv = dkv_fn(qb, kb, vb, out, dout, lse, delta, h, h_kv, *extra, sm_scale=scale)
        want = flash_bwd.attention_bwd_plain(
            qb, kb, vb, out, lse, dout, h, h_kv, masks is None or masks[0],
            None if masks is None else masks[1], None if masks is None else masks[2], scale)
        torch.cuda.synchronize()
        assert (dq_fn.launches, dkv_fn.launches) == (before[0] + 1, before[1] + 1)
        for grad, w, g in zip(("dq", "dk", "dv"), want, (dq, dk, dv)):
            assert float((w - g).abs().max()) <= F32_TOL, (kind, grad, d, s, h_kv)


@pytest.mark.cuda
@pytest.mark.parametrize("d", SPLIT_DIMS)
@pytest.mark.parametrize("pair", ["tri", "rect"])
def test_a_split_walk_matches_plain_and_repeats_its_bits(cuda, pair, d):
    """dK/dV at GQA 8 with its walk in 1, 2, 4 and 8 parts (hand-made plans
    through the library, ``chip_smoke.f32_dkv_at_split``): each within 1e-4
    of attention_bwd_plain, and two runs at each split give the same bits; a
    split that does not divide the group is refused."""
    import chip_smoke

    b, s, h, h_kv = 2, 130, 8, 1
    masks = None if pair == "tri" else _masks("window, segments", b, s)
    qb, kb, vb, out, dout, lse, delta, scale = _inputs(d + 7, b, s, h, h_kv, d, masks)
    extra = () if masks is None else masks
    want = flash_bwd.attention_bwd_plain(
        qb, kb, vb, out, lse, dout, h, h_kv, True, None if masks is None else masks[1],
        None if masks is None else masks[2], scale)
    for split in (1, 2, 4, 8):
        run, dk, dv = chip_smoke.f32_dkv_at_split(pair, split, qb, kb, vb, dout, lse, delta, h,
                                                  h_kv, extra, scale)
        run()
        first = (dk.clone(), dv.clone())
        torch.cuda.synchronize()
        for grad, w, g in zip(("dk", "dv"), want[1:], first):
            assert float((w - g).abs().max()) <= F32_TOL, (split, grad)
        run()
        torch.cuda.synchronize()
        assert torch.equal(first[0], dk) and torch.equal(first[1], dv), split
    run, _, _ = chip_smoke.f32_dkv_at_split(pair, 3, qb, kb, vb, dout, lse, delta, h, h_kv,
                                            extra, scale)
    with pytest.raises(RuntimeError, match="at split 3: error -1"):
        run()


@pytest.mark.cuda
@pytest.mark.parametrize("d", SPLIT_DIMS)
def test_two_runs_give_the_same_bits(cuda, d):
    """Both pairs through their wrappers (at the card's split) twice on the
    same inputs: the same bits."""
    for pair in ("tri", "rect"):
        masks = None if pair == "tri" else _masks("window, segments", 1, 1000)
        qb, kb, vb, out, dout, lse, delta, _ = _inputs(d, 1, 1000, 8, 1, d, masks)
        extra = () if masks is None else masks
        dq_fn = getattr(flash_bwd, f"flash_bwd_dq_{pair}")
        dkv_fn = getattr(flash_bwd, f"flash_bwd_dkv_{pair}")
        runs = [(dq_fn(qb, kb, vb, out, dout, lse, delta, 8, 1, *extra),
                 *dkv_fn(qb, kb, vb, out, dout, lse, delta, 8, 1, *extra)) for _ in range(2)]
        torch.cuda.synchronize()
        for grad, a, c in zip(("dq", "dk", "dv"), *runs):
            assert torch.equal(a, c), (pair, grad)


@pytest.mark.cuda
@pytest.mark.parametrize("d", SPLIT_DIMS)
def test_a_misaligned_base_is_refused(cuda, d):
    """The cluster kernels move 16 bytes at a time: a q, k, v or dO base 4
    bytes off raises ValueError naming it, and nothing launches."""
    args = list(_inputs(d, 1, 64, 2, 1, d))[:7]  # q, k, v, out, dout, lse, delta
    for which, name in ((0, "q"), (1, "k"), (2, "v"), (4, "dout")):
        moved = list(args)
        flat = torch.empty(args[which].numel() + 1, dtype=F32, device="cuda")
        moved[which] = flat[1:].view(args[which].shape).copy_(args[which])
        for fn in (flash_bwd.flash_bwd_dq_tri, flash_bwd.flash_bwd_dkv_tri):
            before = fn.launches
            with pytest.raises(ValueError, match=f"^{name} must start on a 16-byte"):
                fn(*moved, 2, 1)
            assert fn.launches == before
