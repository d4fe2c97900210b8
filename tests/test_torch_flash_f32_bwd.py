"""The f32 flash backward pair at head dims 256, 512 and 576: the slab CTAs
of a tile in one thread-block cluster that add their partial S and dP
through distributed shared memory (``flash_bwd.cu``'s
``flash_bwd_{dq,dkv}_{tri,rect}_wide_f32_kernel``, ``kernels/flash_cluster.cuh``),
and dK/dV's GQA walk split in parts whose partial sums a second kernel adds
(``flash_bwd_dkv_split_sum_kernel``). On the CPU: both pairs' plans at these
head dims and at the padded widths that map there (slabs, clusters, tiles,
grids, shared memory, the library), the walks against the plain version's
mask (a window, segments, GQA, a split walk), the split rule
(``flash_bwd.gqa_split``) on stubbed resident-cluster counts, and the
constants against the CUDA sources. This file imports no JAX, so its card
tests run on a machine with a card and no JAX:

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


def test_below_256_f32_keeps_the_whole_row_pair():
    """f32 at 16-128: one CTA of 64 rows a tile in the base library; 16-bit
    at 256, 512 and 576 keeps its libraries."""
    for d in (16, 32, 64, 128):
        dq, dkv = flash_bwd.tri_bwd_plan(F32, 8, 4, 130, d, H100_SMS, clusters=30)
        assert (dq.block, dq.cluster, dq.col_split, dkv.split) == (64, 1, 1, 1), d
        assert flash_fwd.library_name("flash_bwd", F32, d) == "flash_bwd"
    for d, name in ((256, "flash_bwd"), (512, "flash_bwd_d512"), (576, "flash_bwd_d576")):
        assert flash_fwd.library_name("flash_bwd", torch.bfloat16, d) == name
        assert flash_fwd.library_name("flash_bwd", torch.float16, d) == name.replace(
            "flash_bwd", "flash_bwd_f16")


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
@pytest.mark.parametrize("d", NATIVE)
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


@pytest.mark.parametrize("d", NATIVE)
@pytest.mark.parametrize("group, split", [(1, 1), (2, 1), (2, 2), (4, 2), (4, 4)])
@pytest.mark.parametrize("s, causal, window, cuts", [
    (1, True, None, None), (63, True, None, None), (130, True, None, None),
    (130, False, None, None), (130, True, 33, (88,)), (300, True, 70, None),
    (300, True, None, (128, 200)), (300, False, None, (64, 200)), (100, True, 33, (37,))])
def test_the_walks_visit_exactly_the_live_pairs(d, group, split, s, causal, window, cuts):
    """Both kernels' walks at 256-576 (64-row tiles both sides; dQ in
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
    shared header); the whole-row f32 pair runs 16-128 only; the dK/dV
    entries and kernels take the split and the partials; the 16-bit wide
    kernels keep their gate above 576."""
    bwd = (KERNELS / "flash_bwd.cu").read_text()
    fwd = (KERNELS / "flash_fwd.cu").read_text()
    cluster = (KERNELS / "flash_cluster.cuh").read_text()
    assert "__host__ __device__ constexpr bool f32_cluster_head_dim(int d) {\n  return d >= 256 " \
           "&& d % kF32WideChunk == 0;\n}" in cluster
    assert "f32_cluster_head_dim(int d)" not in fwd + bwd
    assert flash_fwd.F32_CLUSTER_MIN_D == 256
    assert "!f32_cluster_head_dim(d) ||" in bwd and "if (!f32_cluster_head_dim(d)) return " \
           "kUnsupported;" in bwd
    assert "if (!wide_head_dim(d) || split != 1 || swizzle != WideGeo::kRowBytes" in bwd
    # no whole-row f32 instantiation above 128, no f32_tile
    for d in (256, 512, 576):
        assert not re.search(rf"case {d}: return launch<", bwd), d
    assert "f32_tile" not in bwd and not hasattr(flash_bwd, "f32_tile")
    # the split: the dK/dV kernels and entries, the sum in part order
    for pair in ("tri", "rect"):
        assert f"flash_bwd_dkv_{pair}_wide_f32_kernel(Params p, int d, int sp)" in bwd
        sig = bwd[bwd.index(f'extern "C" int flash_bwd_dkv_{pair}('):]
        assert "float* partials, int split" in sig[:sig.index("{")]
    assert "flash_bwd_dkv_split_sum_kernel(const float4* __restrict__ parts" in bwd
    assert "for (int j = 1; j < sp; ++j)" in bwd and "atomicAdd" not in bwd
    # the exchange: up to 32 rows a CTA at c = 2, two passes of 256 threads
    assert "float4 pv[2], dsv[2];" in bwd
    assert "const int m_end = (row / p.rows + 1) * (group / sp);" in bwd


def test_phase_2_and_3_cover_the_cluster_pair():
    """chip_smoke's build phase expects the backward cluster kernels and the
    split's sum in flash_bwd_wide and no f32 kernel in the D 512 and 576
    libraries; phase 3 has the f32 pair at 256, 512 and 576 under both
    masks and the (1,2048,8,{256,512}) rows with one kv head."""
    import chip_smoke

    assert sorted(chip_smoke.F32_BWD_CLUSTER_KERNELS) == sorted(
        [f"flash_bwd_{k}_{p}_wide_f32_kernel" for k in ("dq", "dkv") for p in ("tri", "rect")]
        + ["flash_bwd_dkv_split_sum_kernel"])
    for name in chip_smoke.F32_BWD_CLUSTER_KERNELS:
        assert chip_smoke.f32_label(f"_ZN12_GLOBAL__N_1{len(name)}{name}E6Paramsii") == name
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
    """flash_bwd_wide holds the four f32 cluster kernels and the split's
    sum, each at most 255 registers and 0 spill bytes, and each places a
    cluster at 256, 512 and 576; the D 512 and 576 libraries hold no f32
    kernel."""
    import chip_smoke

    built = build.build(["flash_bwd_wide", "flash_bwd_d512", "flash_bwd_d576"])
    report = chip_smoke.ptxas_by_function(
        built["flash_bwd_wide"][0].with_suffix(".log").read_text())
    found = {chip_smoke.f32_label(k): v for k, v in report.items() if chip_smoke.f32_label(k)}
    assert sorted(found) == sorted(chip_smoke.F32_BWD_CLUSTER_KERNELS), found
    for name, stats in found.items():
        assert stats["spill_stores"] == 0 and stats["spill_loads"] == 0, (name, stats)
        assert stats["registers"] <= 255, (name, stats)
    for name in ("flash_bwd_d512", "flash_bwd_d576"):
        kernels = chip_smoke.ptxas_by_function(built[name][0].with_suffix(".log").read_text())
        assert not [k for k in kernels if chip_smoke.whole_row_f32(k)], name
    for d in NATIVE:
        for kernel in ("dq", "dkv"):
            for tri in (True, False):
                assert flash_bwd.f32_wide_active_clusters(d, kernel, tri) > 0, (d, kernel, tri)


CARD_ROWS = [(b, s, h, h_kv) for s in (1, 63, 100, 130) for b, h, h_kv in ((2, 2, 2), (1, 4, 1))]


@pytest.mark.cuda
@pytest.mark.parametrize("d", NATIVE + [200, 544])
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
@pytest.mark.parametrize("d", NATIVE)
@pytest.mark.parametrize("pair", ["tri", "rect"])
def test_a_split_walk_matches_plain_and_repeats_its_bits(cuda, pair, d):
    """dK/dV at GQA 4 with its walk in 1, 2 and 4 parts (hand-made plans
    through the library, ``chip_smoke.f32_dkv_at_split``): each within 1e-4
    of attention_bwd_plain, and two runs at split 1 and at split 2 give the
    same bits; a split that does not divide the group is refused."""
    import chip_smoke

    b, s, h, h_kv = 2, 130, 4, 1
    masks = None if pair == "tri" else _masks("window, segments", b, s)
    qb, kb, vb, out, dout, lse, delta, scale = _inputs(d + 7, b, s, h, h_kv, d, masks)
    extra = () if masks is None else masks
    want = flash_bwd.attention_bwd_plain(
        qb, kb, vb, out, lse, dout, h, h_kv, True, None if masks is None else masks[1],
        None if masks is None else masks[2], scale)
    for split in (1, 2, 4):
        run, dk, dv = chip_smoke.f32_dkv_at_split(pair, split, qb, kb, vb, dout, lse, delta, h,
                                                  h_kv, extra, scale)
        run()
        first = (dk.clone(), dv.clone())
        torch.cuda.synchronize()
        for grad, w, g in zip(("dk", "dv"), want[1:], first):
            assert float((w - g).abs().max()) <= F32_TOL, (split, grad)
        if split <= 2:
            run()
            torch.cuda.synchronize()
            assert torch.equal(first[0], dk) and torch.equal(first[1], dv), split
    run, _, _ = chip_smoke.f32_dkv_at_split(pair, 3, qb, kb, vb, dout, lse, delta, h, h_kv,
                                            extra, scale)
    with pytest.raises(RuntimeError, match="at split 3: error -1"):
        run()


@pytest.mark.cuda
@pytest.mark.parametrize("d", NATIVE)
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
@pytest.mark.parametrize("d", NATIVE)
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
