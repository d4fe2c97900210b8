"""The f32 flash forward pair at head dims 32, 64 and 128: the cluster
forward's design at one CTA a tile, the head whole in one slab of 32, 64 or
128 columns (``flash_fwd.cu``'s ``flash_fwd_{tri,rect}_tile_f32_kernel<W, BM>``,
``attend_tile``, in ``flash_fwd_wide``); head dim 16 keeps the whole-row
kernels of the base library (``flash_fwd.F32_WHOLE_ROW_D``). On the CPU:
the plan at these head dims and at the padded widths that map there (q tile
height, threads, grid, slab, stages, cluster, ``skips``, shared memory),
the library of each f32 width, the constants against the CUDA sources, the
walks against the plain version's mask, ``flash_attention_with_lse`` and
``flash_attention`` against the JAX package (the one test that imports JAX,
inside it), and the coverage of ``scripts/kernel_ab.py --family fwd_f32``
and of ``chip_smoke.py``'s phases 2 and 3. The card tests run on a machine
with a card and no JAX:

    python -m pytest tests/test_torch_flash_f32_fwd_tile.py --noconftest -q -m cuda

every instantiation (both masks, slab widths 64 and 128, 64- and 16-row q
tiles) against ``attention_plain`` (O 1e-4, lse 1e-3, as
``tests/test_torch_kernels.py``), two runs bit for bit, a misaligned base
refused by name (the cluster kernels' too), and the build's registers,
spills and resident CTAs.
"""

import importlib.util
import inspect
import math
import pathlib
import re

import numpy as np
import pytest
import torch

from tpu_operator_torch.kernels import build, flash_fwd
from tpu_operator_torch.workloads import flashattention as tfa

F32 = torch.float32
MAX_SMEM = 232_448  # bytes of shared memory a block may use on the H100
SM_SMEM = 233_472   # bytes of shared memory an SM holds for its blocks (1 KiB each reserved)
H100_SMS = 132
KERNELS = pathlib.Path(flash_fwd.__file__).parent
F32_TOL, LSE_TOL = 1e-4, 1e-3
TILE_DIMS = [32, 64, 128]
# (d, the width it runs at, its slab): the native widths and padded ones that map there
WIDTHS = [(32, 32, 32), (64, 64, 64), (128, 128, 128), (17, 32, 32), (20, 32, 32),
          (33, 64, 64), (48, 64, 64), (80, 128, 128), (100, 128, 128), (16, 16, 0), (1, 16, 0)]
SQS = [1, 8, 16, 17, 64, 100, 300]


def _smem(width, rows):
    """The tile forward's shared memory by hand: Q [rows][W], two stages of
    a K and a V tile [64][W], P [rows][68]."""
    return 4 * (rows * width + 2 * 2 * 64 * width + rows * 68)


@pytest.mark.parametrize("sq", [8, 16, 17, 130])
@pytest.mark.parametrize("d, width, slab", WIDTHS)
def test_the_plan_at_every_width(d, width, slab, sq):
    """32-128: 16-row q tiles for a call of at most 16 rows, else 64; 256
    threads; grid (q tiles, rows); one CTA a tile on one slab as wide as
    the head (32, 64 or 128 columns); two stages; no swizzle; the general
    kernel skips a key tile of another document; shared memory inside a
    block's, two CTAs an SM at a 32- or 64-column slab. 16: the whole-row
    kernel's fixed plan (64 rows, no slab, no skip)."""
    assert flash_fwd.padded_head_dim(d) == width
    tri = flash_fwd.tri_plan(F32, 6, sq, width, H100_SMS)
    rect = flash_fwd.rect_plan(F32, 6, sq, 64 + sq, width, H100_SMS, True, 33, 64, 0)
    if width == flash_fwd.F32_WHOLE_ROW_D:
        for plan in (tri, rect):
            assert (plan.block_m, plan.threads, plan.slab, plan.stages, plan.cluster) == (
                64, 256, 0, 0, 1)
            assert plan.smem_bytes == 4 * ((64 + 2 * 64) * 17 + 64 * 65) + 4 * 64
        assert not rect.skips
        return
    rows = 16 if sq <= 16 else 64
    for plan in (tri, rect):
        assert (plan.block_m, plan.threads, plan.swizzle) == (rows, 256, 0)
        assert (plan.col_split, plan.cluster, plan.slab, plan.stages) == (1, 1, slab, 2)
        assert plan.grid == (math.ceil(sq / rows), 6)
        assert plan.smem_bytes == _smem(slab, rows) == flash_fwd.f32_tile_fwd_smem(width, rows)
        assert plan.smem_bytes <= MAX_SMEM
        if slab < 128:
            assert 2 * (plan.smem_bytes + 1024) <= SM_SMEM
    assert rect.skips
    # block_m 64 is accepted and chooses nothing; no other height is taken
    assert flash_fwd.tri_plan(F32, 6, sq, width, H100_SMS, block_m=64) == tri
    with pytest.raises(ValueError, match="block_m"):
        flash_fwd.tri_plan(F32, 6, sq, width, H100_SMS, block_m=16)


def test_the_shared_memory_by_hand():
    """58,368 bytes at a 32-column slab, 99,328 at 64 (two CTAs an SM),
    181,248 at 128 (one); 39,168, 73,984 and 143,616 at 16-row q tiles."""
    for d, rows, want in ((32, 64, 58_368), (64, 64, 99_328), (128, 64, 181_248),
                          (32, 16, 39_168), (64, 16, 73_984), (128, 16, 143_616)):
        assert flash_fwd.f32_tile_fwd_smem(d, rows) == want, (d, rows)


@pytest.mark.parametrize("source", ["flash_fwd", "flash_bwd"])
@pytest.mark.parametrize("d", flash_fwd.NATIVE_HEAD_DIMS + (640, 1024))
def test_the_library_of_every_f32_width(source, d):
    """f32 from 32 on in the wide library of both sources (the tile kernels
    up to 128, the cluster kernels from 256); f32 at 16 in the base library,
    the whole-row kernels a serving replica builds cold; the 16-bit
    libraries as they were."""
    want = source if d == flash_fwd.F32_WHOLE_ROW_D else f"{source}_wide"
    assert flash_fwd.library_name(source, F32, d) == want
    bf16 = (f"{source}_wide" if d > 576 else f"{source}_d{d}" if d in (512, 576) else source)
    assert flash_fwd.library_name(source, torch.bfloat16, d) == bf16
    assert flash_fwd.library_name(source, torch.float16, d) == bf16.replace(
        source, f"{source}_f16")


def test_the_constants_match_the_cuda_sources():
    """The head dims, the slab rule, P's stride, shared memory and CTAs an SM
    as the plan states them; two barriers a key tile; the helpers that both
    sources' tile kernels use in the shared header alone; the whole-row f32
    kernels at head dim 16 alone."""
    fwd = (KERNELS / "flash_fwd.cu").read_text()
    bwd = (KERNELS / "flash_bwd.cu").read_text()
    cluster = (KERNELS / "flash_cluster.cuh").read_text()
    head = fwd[fwd.index("constexpr bool f32_tile_head_dim(int d)"):]
    dims = [int(x) for x in re.findall(r"d == (\d+)", head[:head.index(";")])]
    assert tuple(dims) == flash_fwd.F32_TILE_HEAD_DIMS == (32, 64, 128)
    assert flash_fwd.F32_WHOLE_ROW_D == 16 and flash_fwd.F32_TILE_P_STRIDE == 68
    assert "constexpr int kF32TilePStride = kF32WideTile + 4;" in fwd
    assert ("return 4 * (BM * W + kF32WideStages * 2 * kF32WideTile * W + BM * kF32TilePStride);"
            in fwd)
    assert "constexpr int f32_tile_ctas(int w) { return w < kF32WideSlab ? 2 : 1; }" in fwd
    assert [flash_fwd.f32_tile_fwd_width(d) for d in TILE_DIMS] == [32, 64, flash_fwd.F32_SLAB]
    for width in (32, 64):
        assert f"if (d <= {width}) {{\n    return block_m == kF32WideTile ? launch_f32_tile<TRI, " \
               f"{width}, kF32WideTile>" in fwd
    assert fwd.count("__global__ void __launch_bounds__(kF32Threads, f32_tile_ctas(W))") == 2
    assert "if (f32_tile_head_dim(d)) return dispatch_f32_tile<TRI>(" in fwd
    # two barriers a key tile, and one before the walk
    body = fwd[fwd.index("void attend_tile(const Params& p, int d)"):]
    body = body[:body.index("\n}\n")]
    assert body.count("__syncthreads();") == 3
    assert body.count("tile_scores<W, false, RM>(") == 1 and "id_range" in body
    # the tile helpers live once, in the header both sources include
    for helper in ("void load_head(", "void store_head(", "void tile_scores("):
        assert helper in cluster and helper not in fwd + bwd, helper
    # the whole-row f32 forward at 16 alone
    assert "if (d == 16) return launch<16, TRI>(p, bh, st);" in fwd
    assert not re.search(r"launch<(32|64|128), TRI>", fwd)


def _live_pairs(keep, rows, sq, sk):
    """(q tile, key tile) pairs holding a live (row, key) pair: q tiles of
    ``rows`` rows, key tiles of 64."""
    return {(q, k) for q in range(-(-sq // rows)) for k in range(-(-sk // 64))
            if bool(keep[q * rows:(q + 1) * rows, k * 64:(k + 1) * 64].any())}


@pytest.mark.parametrize("d", TILE_DIMS)
@pytest.mark.parametrize("s", SQS)
def test_the_triangle_walks_exactly_the_live_pairs(s, d):
    """Every q tile walks the key tiles from 0 to its last row's diagonal:
    every live tile pair of the causal triangle, no other; each (row, q
    tile) is one block, tile-major, the heaviest q tiles first (every row's
    before any lighter one)."""
    plan = flash_fwd.tri_plan(F32, 3, s, d, H100_SMS)
    rows = plan.block_m
    blocks = [plan.cta(x, y) for y in range(plan.grid[1]) for x in range(plan.grid[0])]
    assert sorted(blocks) == [(r, q) for r in range(3) for q in range(plan.grid[0])]
    live = _live_pairs(flash_fwd.keep_mask(1, s, s, 1, True)[0], rows, s, s)
    for _, q in blocks:
        keys = range(-(-min(s, (q + 1) * rows) // 64))  # the kernel's walk
        assert {(q, k) for k in keys} == {(qq, k) for qq, k in live if qq == q}, q
    assert plan.cta(0, 0)[1] == plan.grid[0] - 1  # the heaviest tile first
    assert [q for _, q in blocks] == sorted((q for _, q in blocks), reverse=True)


def _docs(s, cuts):
    return [sum(i >= c for c in cuts) for i in range(s)]


# (sq, sk, causal, window, q_start, k_start, segment cuts): each at sq in SQS
MASKS = {
    "full": (None, False, None, 0, 0, None),
    "window 33": (None, True, 33, 0, 0, None),
    "segments cut 37": (None, True, None, 0, 0, (37,)),
    "full, segments cut 88": (None, False, None, 0, 0, (88,)),
    "window 40, segments cut 70": (None, True, 40, 0, 0, (70,)),
    "chunked prefill, 200 keys": (200, True, None, 160, 0, None),
    "ring hop": (None, True, None, 300, 0, None),
    "window at offsets": (300, True, 70, 150, 20, None),
    "no key in reach": (None, True, None, 0, 400, None),
}


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq", SQS)
@pytest.mark.parametrize("name", sorted(MASKS))
def test_the_general_walks_cover_the_live_pairs(name, sq, d):
    """The general kernel's walk (the band by global position, less a key
    tile whose documents cannot meet the q tile's: ``loads``) covers every
    tile pair that holds a live (q, k) pair of the plain version's mask,
    for each kv head of a GQA group alike; with at most one segment
    boundary it walks no other; an empty walk where no key is in reach."""
    sk, causal, window, q_start, k_start, cuts = MASKS[name]
    sk = sq if sk is None or cuts else sk
    seg = None if cuts is None else torch.tensor(_docs(sk, cuts), dtype=torch.int32)
    heads, kv_heads = 4, 2
    plan = flash_fwd.rect_plan(F32, 2 * heads, sq, sk, d, H100_SMS, causal, window, q_start,
                               k_start)
    assert plan.block_m == flash_fwd.f32_rows(sq) and plan.skips
    blocks = {(x, y): plan.cta(x, y) for y in range(plan.grid[1]) for x in range(plan.grid[0])}
    assert sorted(blocks.values()) == [(r, q) for r in range(2 * heads)
                                       for q in range(plan.grid[0])]
    keep = flash_fwd.keep_mask(2 * heads, sq, sk, heads, causal, q_start, k_start, window,
                               None if seg is None else seg.expand(2, sk))
    for (x, y), (row, tile) in blocks.items():
        walked = {(tile, k) for _, k, _ in plan.visits(x, y, seg)}
        assert walked == {(tile, k) for k in plan.loads(tile, seg)}
        mask = keep[row if keep.shape[0] > 1 else 0]
        live = {p for p in _live_pairs(mask, plan.block_m, sq, sk) if p[0] == tile}
        assert live <= walked, (row, tile)
        if cuts is None or len(cuts) <= 1:
            assert walked == live, (row, tile)
        assert flash_fwd.kv_row(row, heads, kv_heads) == row // 2  # GQA: its kv row
    if name == "no key in reach":
        assert all(not plan.loads(q, seg) for _, q in blocks.values())
    if causal and not window and plan.grid[0] > 1:
        assert plan.cta(0, 0)[1] == plan.grid[0] - 1  # the heaviest tile first


@pytest.mark.parametrize("d", TILE_DIMS)
def test_flash_attention_matches_the_reference(d):
    """flash_attention_with_lse in f32 with a q_start (a chunked prefill: 32
    rows against 128 keys, and serving's 8-row chunk) and flash_attention
    under a window with a segment boundary and GQA, against the JAX package
    on the same numpy inputs (its Pallas kernels in interpret mode); on the
    CPU the port's wrappers run the plain version (the routing, the slicing,
    the scale and the lse are what this holds). O within 1e-4, lse 1e-3."""
    import jax.numpy as jnp

    from tpu_operator.workloads import flashattention as jfa

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for sq, sk, q_start in ((32, 128, 96), (8, 64, 16)):
            rng = np.random.default_rng(d + sq)
            arrays = [rng.standard_normal(shape).astype(np.float32)
                      for shape in ((1, sq, 2, d), (1, sk, 1, d), (1, sk, 1, d))]
            kwargs = dict(causal=True, block_q=64, block_k=64, q_start=q_start, k_start=0)
            want = jfa.flash_attention_with_lse(*(jnp.asarray(a) for a in arrays), **kwargs)
            got = tfa.flash_attention_with_lse(*(torch.from_numpy(a) for a in arrays), **kwargs)
            for w, g, tol in zip(want, got, (F32_TOL, LSE_TOL)):
                w = np.asarray(w)
                assert w.shape == tuple(g.shape) and g.dtype == F32
                assert np.array_equal(np.isneginf(w), np.isneginf(g.numpy()))
                fin = np.isfinite(w)
                assert float(np.max(np.abs(w[fin] - g.numpy()[fin]))) <= tol, (d, sq)
        s = 128
        rng = np.random.default_rng(d)
        q, k, v = (rng.standard_normal((1, s, h, d)).astype(np.float32) for h in (4, 2, 2))
        seg = (np.arange(s)[None] >= 70).astype(np.int32)
        kwargs = dict(causal=True, block_q=64, block_k=64, window=33)
        want = jfa.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                   segment_ids=jnp.asarray(seg), **kwargs)
        got = tfa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                  segment_ids=torch.from_numpy(seg), **kwargs)
        assert float(np.max(np.abs(np.asarray(want) - got.numpy()))) <= F32_TOL, d
    finally:
        torch.set_num_threads(before)


def _kernel_ab():
    import chip_smoke

    spec = importlib.util.spec_from_file_location(
        "kernel_ab", pathlib.Path(chip_smoke.__file__).parent / "scripts" / "kernel_ab.py")
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    return ab


def test_kernel_ab_times_every_f32_forward_row():
    """``scripts/kernel_ab.py --family fwd_f32`` (parent against change on
    one card) takes every f32 row of phase 3's forward tables, those up to
    head dim 128 among them, and times each."""
    import chip_smoke

    ab = _kernel_ab()
    assert ab.FAMILIES["fwd_f32"][1:] == (("ms",), "flash_fwd")
    body = inspect.getsource(ab._fwd_f32)
    tables = ("KERNEL_CASES", "HEAD_DIM_KERNEL_CASES", "HEAD_DIM_512_KERNEL_CASES",
              "HEAD_DIM_576_KERNEL_CASES", "WIDE_KERNEL_CASES", "F32_TILE_KERNEL_CASES")
    assert all(f"smoke.{name}" in body for name in tables)
    assert "padded_head_dim" not in body  # no width left out
    rows = [c for name in tables for c in getattr(chip_smoke, name) if c["dtype"] == F32]
    labels = [c["label"] for c in rows]
    assert len(labels) == len(set(labels))
    assert {flash_fwd.padded_head_dim(c["q"][3]) for c in rows} >= {16, 32, 64, 128, 256}


def test_phase_2_and_3_cover_the_tile_forward():
    """chip_smoke's build phase expects the twelve tile kernels in
    flash_fwd_wide beside the four cluster kernels (a 32- or 64-column
    slab's at most 128 registers) and the whole-row f32 forward at 16 alone in
    flash_fwd; phase 3 has the triangle at the entry() widths'
    (8,128,4,64), (2,128,4,{16,64,128}) and (1,2048,8,{64,128}) with one kv
    head, and the general kernel at the entry() widths packed, (2,128,4,64)
    full and with a window and a segment cut, the ragged (2,1000,4,128) with
    GQA 2 and serving's chunk at 64."""
    import chip_smoke

    assert len(chip_smoke.F32_FWD_TILE_KERNELS) == 12
    for pair in ("tri", "rect"):
        for width in (32, 64, 128):
            for rows in (64, 16):
                name = f"flash_fwd_{pair}_tile_f32_kernel"
                mangled = f"_ZN12_GLOBAL__N_1{len(name)}{name}ILi{width}ELi{rows}EEEv6Paramsi"
                label = chip_smoke.f32_label(mangled)
                assert label == f"{name}<{width}, {rows}>"
                assert label in chip_smoke.F32_FWD_TILE_KERNELS
                assert not chip_smoke.whole_row_f32(mangled)
    assert chip_smoke.whole_row_f32("_ZN12_GLOBAL__N_120flash_fwd_tri_kernelIfLi16EEEv6Params")
    source = inspect.getsource(chip_smoke.phase_build)
    assert "F32_CLUSTER_INSTANTIATIONS + F32_FWD_TILE_KERNELS" in source
    assert '{"flash_fwd": 2, "flash_bwd": 4}' in source
    assert all(c["dtype"] == F32 for c in chip_smoke.F32_TILE_KERNEL_CASES)
    rows = chip_smoke.F32_TILE_KERNEL_CASES + [c for c in chip_smoke.KERNEL_CASES
                                               if c["dtype"] == F32]
    # phase 3 runs them on a generator of their own, after every other forward row
    body = inspect.getsource(chip_smoke.phase_kernels)
    assert "+ F32_TILE_KERNEL_CASES):" in body
    assert "tile_gen if case in F32_TILE_KERNEL_CASES else gen" in body

    def has(kernel, q, **extra):
        return any(c["kernel"] == kernel and c["q"] == q
                   and all(c.get(k) == v for k, v in extra.items()) for c in rows)

    tri, rect = "flash_fwd_tri", "flash_fwd_rect"
    for q in ((8, 128, 4, 64), (2, 128, 4, 16), (2, 128, 4, 64), (2, 128, 4, 128)):
        assert has(tri, q), q
    for d in (64, 128):
        assert has(tri, (1, 2048, 8, d), h_kv=1), d
    assert has(rect, (8, 128, 4, 64), packed=2)
    assert has(rect, (2, 128, 4, 64), causal=False)
    assert has(rect, (2, 128, 4, 64), window=33, cut=88)
    assert has(rect, (2, 1000, 4, 128), h_kv=2, cut=333)
    assert has(rect, (1, 8, 2, 64), sk=64, q_start=16)


# --------------------------------------------------------------- on the card


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _qkv(seed, b, sq, sk, h, h_kv, d):
    """Collapsed f32 q (b·h, sq, width), k and v (b·h_kv, sk, width) on the
    card, zero-padded from d to the kernels' width, and the softmax scale to
    pass."""
    rng = np.random.default_rng(seed)
    width = flash_fwd.padded_head_dim(d)

    def make(rows, s):
        x = torch.from_numpy(rng.standard_normal((rows, s, d)).astype(np.float32))
        return torch.nn.functional.pad(x, (0, width - d)).to("cuda").contiguous()

    scale = None if width == d else 1.0 / math.sqrt(d)
    return make(b * h, sq), make(b * h_kv, sk), make(b * h_kv, sk), scale


def _err(a, b):
    assert torch.equal(torch.isneginf(a), torch.isneginf(b))
    inf = torch.isneginf(a)
    return float((torch.where(inf, 0.0, a) - torch.where(inf, 0.0, b)).abs().max())


@pytest.mark.cuda
def test_the_tile_kernels_build_without_spills(cuda):
    """flash_fwd_wide holds the twelve tile kernels, each at 0 spill bytes,
    at most 128 registers at a 32- or 64-column slab (at least two CTAs an
    SM) and 255 at 128 (one); flash_fwd holds the whole-row f32 kernels at
    16 alone; the card holds two CTAs an SM or more at 32 and 64 columns,
    one at 128."""
    import chip_smoke

    built = build.build(["flash_fwd_wide", "flash_fwd"])
    report = chip_smoke.ptxas_by_function(
        built["flash_fwd_wide"][0].with_suffix(".log").read_text())
    found = {chip_smoke.f32_label(k): v for k, v in report.items()
             if (chip_smoke.f32_label(k) or "").endswith(">") and "_tile_" in k}
    assert sorted(found) == sorted(chip_smoke.F32_FWD_TILE_KERNELS), found
    for name, stats in found.items():
        print(name, stats)
        assert stats["spill_stores"] == 0 and stats["spill_loads"] == 0, (name, stats)
        assert stats["registers"] <= (255 if "<128," in name else 128), (name, stats)
    kept = [k for k in chip_smoke.ptxas_by_function(
        built["flash_fwd"][0].with_suffix(".log").read_text()) if chip_smoke.whole_row_f32(k)]
    assert len(kept) == 2 and all("IfLi16E" in k for k in kept), kept
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for d in TILE_DIMS:
        for tri in (True, False):
            for rows in (64, 16):
                resident = flash_fwd.f32_active_clusters(d, tri, rows)
                print(d, tri, rows, "resident CTAs", resident)
                by_smem = SM_SMEM // (flash_fwd.f32_tile_fwd_smem(d, rows) + 1024)
                assert resident % sms == 0 and resident <= sms * by_smem, (d, tri, rows)
                assert resident >= sms * 2 if d <= 64 else resident == sms, (d, tri, rows)


TRI_SHAPES = [  # (b, s, h, h_kv): ragged lengths, 16-row tiles at s <= 16, GQA
    (2, 130, 4, 2), (1, 200, 2, 1), (1, 8, 2, 1), (2, 16, 2, 2), (1, 17, 4, 1), (1, 1, 2, 2),
    (2, 64, 4, 4), (1, 300, 8, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("d", TILE_DIMS + [20, 48, 100])
@pytest.mark.parametrize("b, s, h, h_kv", TRI_SHAPES)
def test_the_triangle_matches_plain(cuda, b, s, h, h_kv, d):
    """The triangle forward (64-row tiles, and 16-row at s <= 16; slabs of
    64 and 128 columns; padded heads) against attention_plain, one launch
    each."""
    qb, kb, vb, scale = _qkv(d + s, b, s, s, h, h_kv, d)
    before = flash_fwd.flash_fwd_tri.launches
    out, lse = flash_fwd.flash_fwd_tri(qb, kb, vb, h, h_kv, sm_scale=scale)
    want, want_lse = flash_fwd.attention_plain(qb, kb, vb, h, h_kv, True, sm_scale=scale)
    torch.cuda.synchronize()
    assert flash_fwd.flash_fwd_tri.launches == before + 1
    assert _err(want, out) <= F32_TOL and _err(want_lse, lse) <= LSE_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("d", TILE_DIMS + [48, 100])
@pytest.mark.parametrize("sq", SQS)
def test_the_general_kernel_matches_plain(cuda, sq, d):
    """The general forward under every mask of MASKS (full, windows,
    segments, offsets, sq != sk, rows that see no key), GQA 2, against
    attention_plain, one launch each."""
    for name, (sk, causal, window, q0, k0, cuts) in MASKS.items():
        sk = sq if sk is None or cuts else sk
        qb, kb, vb, scale = _qkv(sq + sk + d, 2, sq, sk, 4, 2, d)
        seg = None if cuts is None else torch.tensor(
            _docs(sk, cuts), dtype=torch.int32, device="cuda").expand(2, sk).contiguous()
        before = flash_fwd.flash_fwd_rect.launches
        out, lse = flash_fwd.flash_fwd_rect(qb, kb, vb, 4, 2, causal, q0, k0, window, seg,
                                            sm_scale=scale)
        want, want_lse = flash_fwd.attention_plain(qb, kb, vb, 4, 2, causal, q0, k0, window,
                                                   seg, sm_scale=scale)
        torch.cuda.synchronize()
        assert flash_fwd.flash_fwd_rect.launches == before + 1, name
        assert _err(want, out) <= F32_TOL and _err(want_lse, lse) <= LSE_TOL, (name, sq, d)


@pytest.mark.cuda
@pytest.mark.parametrize("d", TILE_DIMS)
def test_two_runs_give_the_same_bits(cuda, d):
    """No atomics, no order that changes: each instantiation twice on the
    same inputs gives the same bits."""
    for tri, s in ((True, 130), (True, 8), (False, 130), (False, 8)):
        qb, kb, vb, _ = _qkv(d + s, 2, s, s, 4, 2, d)
        seg = torch.tensor(_docs(s, (s // 3,)), dtype=torch.int32, device="cuda").expand(2, s)

        def run():
            if tri:
                return flash_fwd.flash_fwd_tri(qb, kb, vb, 4, 2)
            return flash_fwd.flash_fwd_rect(qb, kb, vb, 4, 2, True, window=40,
                                            seg=seg.contiguous())

        first, second = run(), run()
        torch.cuda.synchronize()
        for a, b in zip(first, second):
            assert torch.equal(a, b), (tri, s)


@pytest.mark.cuda
@pytest.mark.parametrize("d", TILE_DIMS + [256])
def test_a_misaligned_base_is_refused(cuda, d):
    """The tile and cluster kernels move 16 bytes at a time: a q, k or v
    base 4 bytes off raises ValueError naming it, in both wrappers, and
    nothing launches."""
    qb, kb, vb, _ = _qkv(d, 1, 64, 64, 2, 1, d)
    for which, name in ((0, "q"), (1, "k"), (2, "v")):
        args = [qb, kb, vb]
        flat = torch.empty(args[which].numel() + 1, dtype=F32, device="cuda")
        args[which] = flat[1:].view(args[which].shape).copy_(args[which])
        for fn, extra in ((flash_fwd.flash_fwd_tri, ()), (flash_fwd.flash_fwd_rect, (True,))):
            before = fn.launches
            with pytest.raises(ValueError, match=f"^{name} must start on a 16-byte"):
                fn(*args, 2, 1, *extra)
            assert fn.launches == before
