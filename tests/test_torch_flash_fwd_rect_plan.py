"""The general forward's launch plan and tile rule, on the CPU. No JAX
here.

The bf16 general forward (``flash_fwd_rect``) runs only on the card
(``tests/test_torch_kernels.py``); its plan (``rect_plan``) and the model
of what its CTAs do (``RectPlan.walk``, ``kind``, ``visits``) are plain
Python, so they are checked here: tile heights and CTA counts at the
shapes ``chip_smoke.py`` times, the walks of full attention, plain causal
and window bands at global offsets, sq != sk and ragged lengths covering
every live (64-row q slice, 64-key tile) pair exactly once, the fast /
masked / dead rule against ``keep_mask`` (a tile with keys past sk is
never fast), q tiles whose walk is empty, shared memory within Hopper's
232,448 bytes a block, the constants against the CUDA source, the f32
plan, the CPU path, and the phase-2 labels and phase-3 yardsticks of
``chip_smoke.py``.
"""

import collections
import re
from pathlib import Path

import pytest
import torch

import chip_smoke
from tpu_operator_torch.kernels import flash_fwd
from tpu_operator_torch.kernels.flash_fwd import attention_plain, keep_mask

CU_SOURCE = Path(flash_fwd.__file__).with_name("flash_fwd.cu")
HEADER = CU_SOURCE.with_name("hopper.cuh")
BF16, F32 = torch.bfloat16, torch.float32
H100_SMS = 132
MAX_SMEM = 232_448  # bytes of shared memory a block may use on Hopper
TILE = flash_fwd.RECT_TILE

# the bf16 rows of chip_smoke.KERNEL_CASES for the general kernel: label ->
# (q-tile height, CTAs)
TIMED = {
    "burnin packed bf16 (8,128,4,64) 2 segments": (64, 64),   # 32 rows x 2 tiles
    "validator packed bf16 (1,512,2,128) cut 320": (64, 16),  # 2 rows x 8 tiles
    "bf16 (1,512,4,128) full": (64, 32),                      # 4 rows x 8 tiles
    "bf16 (1,512,4,128) window 128": (64, 32),
    "bf16 (1,512,4,128) segments cut 288": (64, 32),
    "bf16 (1,512,4,128) gqa h_kv 2": (64, 32),
    "bf16 (1,512,4,128) fully masked rows (k_start 256)": (64, 32),
    "timing bf16 (1,4096,8,128) full": (128, 256),            # 8 rows x 32 tiles of 128
    "ring hop bf16 (1,512,4,128) q_start 512": (64, 32),
    "chunked prefill bf16 q(1,128,4,128) kv 1024 q_start 896": (64, 8),  # 4 rows x 2 tiles
    "slice flash check packed bf16 (1,256,2,128) cut 160": (64, 8),  # 2 rows x 4 tiles
}

# (causal, window) of the walks: full, plain causal, and window bands
MASKS = [(False, None), (True, None), (True, 1), (True, 33), (True, 128), (True, 200)]
# (sq, sk, q_start, k_start): square and ragged, serving's chunks, sq > sk,
# a ring hop, a future hop (no key in reach), chunked prefill, rows before
# k_start
SHAPES = [
    (1, 1, 0, 0), (64, 64, 0, 0), (100, 100, 0, 0), (130, 130, 0, 0), (8, 64, 16, 0),
    (8, 64, 56, 0), (24, 80, 0, 10), (70, 130, 60, 0), (130, 100, 0, 0), (100, 300, 200, 0),
    (200, 200, 0, 100), (512, 512, 512, 0), (512, 512, 0, 512), (128, 1024, 896, 0),
]


def _case(label):
    return next(c for c in chip_smoke.KERNEL_CASES if c["label"] == label)


def _plan(case, sms=H100_SMS):
    b, sq, h, d = case["q"]
    return flash_fwd.rect_plan(case["dtype"], b * h, sq, case.get("sk", sq), d, sms,
                               case["causal"], case.get("window"), case.get("q_start", 0),
                               case.get("k_start", 0))


def test_timed_shapes_are_the_bf16_general_cases():
    assert set(TIMED) == {c["label"] for c in chip_smoke.KERNEL_CASES
                          if c["kernel"] == "flash_fwd_rect" and c["dtype"] == BF16}


@pytest.mark.parametrize("label", sorted(TIMED))
def test_tile_height_and_cta_count_at_the_timed_shapes(label):
    case = _case(label)
    b, sq, h, _ = case["q"]
    plan = _plan(case)
    block, ctas = TIMED[label]
    assert plan.block_m == block
    assert plan.grid == (b * h, -(-sq // block))
    assert plan.grid[0] * plan.grid[1] == ctas
    assert plan.threads == 2 * block + 32  # a warpgroup per 64 rows + the producer warp


@pytest.mark.parametrize("causal, window", MASKS)
@pytest.mark.parametrize("sq, sk", [(1, 1), (1000, 64), (64, 1000), (4096, 4096)])
def test_tile_height_is_the_triangles_one_wave_rule(sq, sk, causal, window):
    for sms in (1, H100_SMS, 10**9):
        for rows in (1, 4, 33, 256):
            got = flash_fwd.rect_plan(BF16, rows, sq, sk, 64, sms, causal, window)
            tri = flash_fwd.tri_plan(BF16, rows, sq, 64, sms)
            assert (got.block_m, got.threads, got.grid, got.swizzle) == (
                tri.block_m, tri.threads, tri.grid, tri.swizzle)


def _live_tiles(sq, sk, causal, window, q_start, k_start, seg=None):
    """(64-row q slice, 64-key tile) pairs holding a live pair (q < sq,
    k < sk)."""
    keep = keep_mask(1, sq, sk, 1, causal, q_start, k_start, window,
                     None if seg is None else seg[None])[0]
    return {(q, k) for q in range(-(-sq // 64)) for k in range(-(-sk // TILE))
            if bool(keep[q * 64:(q + 1) * 64, k * TILE:(k + 1) * TILE].any())}


def _products(plan, seg=None):
    return collections.Counter((plan.cta(x, y)[0], q, k) for x in range(plan.grid[0])
                               for y in range(plan.grid[1]) for q, k, _ in plan.visits(x, y, seg))


@pytest.mark.parametrize("sms", [1, 10**9])  # forces 128- and 64-row tiles
@pytest.mark.parametrize("sq, sk, q_start, k_start", SHAPES)
@pytest.mark.parametrize("causal, window", MASKS)
def test_every_live_tile_pair_is_covered_once(causal, window, sq, sk, q_start, k_start, sms):
    """Without segment ids a warpgroup computes exactly the live tiles of
    its rows, each once: the walk reaches every key some row can see, and
    the dead rule drops every tile none of its rows can."""
    plan = flash_fwd.rect_plan(BF16, 2, sq, sk, 32, sms, causal, window, q_start, k_start)
    assert plan.block_m == (128 if sms == 1 else 64)
    got = _products(plan)
    assert set(got.values()) <= {1}
    live = _live_tiles(sq, sk, causal, window, q_start, k_start)
    assert set(got) == {(row, q, k) for row in range(2) for q, k in live}


def _ids(kind, s, seed=0):
    if kind == "docs":  # whole 64-token documents: every tile uniform
        return (torch.arange(s) // 64).to(torch.int32)
    if kind == "packed":  # two documents split mid-tile
        return (torch.arange(s) >= s * 3 // 5).to(torch.int32)
    return torch.randint(0, 3, (s,), generator=torch.Generator().manual_seed(seed),
                         dtype=torch.int32)


@pytest.mark.parametrize("ids", [None, "docs", "packed", "random"])
@pytest.mark.parametrize("s", [64, 100, 300])
@pytest.mark.parametrize("causal, window", MASKS)
def test_segment_ids_keep_every_live_tile(causal, window, s, ids):
    """Segment ids make more tiles dead, never a live one."""
    seg = None if ids is None else _ids(ids, s, seed=s)
    for sms in (1, 10**9):
        plan = flash_fwd.rect_plan(BF16, 1, s, s, 64, sms, causal, window)
        got = _products(plan, seg)
        assert set(got.values()) <= {1}
        live = {(0, q, k) for q, k in _live_tiles(s, s, causal, window, 0, 0, seg)}
        assert live <= set(got) <= set(_products(plan))


def _kinds(plan, seg=None):
    return {(q, k): plan.kind(q * 64, k * TILE, seg)
            for q in range(-(-plan.sq // 64)) for k in range(-(-plan.sk // TILE))}


@pytest.mark.parametrize("sq, sk, q_start, k_start", SHAPES)
@pytest.mark.parametrize("causal, window", MASKS)
def test_tile_rule_agrees_with_keep_mask_at_offsets(causal, window, sq, sk, q_start, k_start):
    """A fast tile has every pair of its real rows and keys live and no key
    past sk; a dead tile has no live pair; any other has some."""
    plan = flash_fwd.rect_plan(BF16, 1, sq, sk, 64, H100_SMS, causal, window, q_start, k_start)
    keep = keep_mask(1, sq, sk, 1, causal, q_start, k_start, window)[0]
    for (q, k), kind in _kinds(plan).items():
        block = keep[q * 64:(q + 1) * 64, k * TILE:(k + 1) * TILE]
        if kind == "fast":
            assert bool(block.all()) and (k + 1) * TILE <= sk, (q, k)
        else:
            assert bool(block.any()) == (kind == "masked"), (q, k, kind)


@pytest.mark.parametrize("ids", ["docs", "packed", "random"])
@pytest.mark.parametrize("s", [64, 100, 300])
@pytest.mark.parametrize("causal, window", MASKS)
def test_tile_rule_agrees_with_keep_mask_with_segment_ids(causal, window, s, ids):
    seg = _ids(ids, s, seed=s)
    plan = flash_fwd.rect_plan(BF16, 1, s, s, 64, H100_SMS, causal, window)
    keep = keep_mask(1, s, s, 1, causal, window=window, seg=seg[None])[0]
    kinds = collections.Counter()
    for (q, k), kind in _kinds(plan, seg).items():
        block = keep[q * 64:(q + 1) * 64, k * TILE:(k + 1) * TILE]
        kinds[kind] += 1
        if kind == "fast":
            assert bool(block.all()) and (k + 1) * TILE <= s, (q, k)
        if kind == "dead":
            assert not bool(block.any()), (q, k)
    if ids == "docs" and s >= 2 * 64:
        # whole documents: a tile of two documents is dead; without a causal
        # mask a tile of one is fast (under one, such a tile is a diagonal)
        assert kinds["dead"] > 0 and (causal or kinds["fast"] > 0)
    if ids == "random":
        assert kinds["fast"] == 0


@pytest.mark.parametrize("sk", [1, 63, 100, 130, 1000])
def test_a_tile_with_keys_past_sk_is_never_fast(sk):
    """A zero-filled key past sk would score 0, not -inf: its tile always
    takes the element mask, even where every real pair is live."""
    for causal, window in MASKS:
        for q_start in (0, 2000):
            plan = flash_fwd.rect_plan(BF16, 1, 64, sk, 64, H100_SMS, causal, window, q_start)
            last = (sk - 1) // TILE
            assert all(kind != "fast" for (_, k), kind in _kinds(plan).items() if k == last
                       ) == (sk % TILE != 0)


@pytest.mark.parametrize("sq, sk, q_start, k_start, empty", [
    (512, 512, 0, 512, {0, 1, 2, 3, 4, 5, 6, 7}),  # a future ring hop: no row sees a key
    (200, 200, 0, 100, {0}),                       # rows 0-63 lie before every key
    (8, 64, 0, 100, {0}),
    (512, 512, 512, 0, set()),
])
def test_a_q_tile_with_an_empty_walk(sq, sk, q_start, k_start, empty):
    """Its rows see no key: the kernel loads nothing for it and writes
    O = 0 and lse = -inf, which is what the plain version gives them."""
    plan = flash_fwd.rect_plan(BF16, 1, sq, sk, 64, 10**9, True, None, q_start, k_start)
    assert plan.block_m == 64
    got = {t for t in range(plan.grid[1]) if len(plan.walk(t)) == 0}
    assert got == empty
    keep = keep_mask(1, sq, sk, 1, True, q_start, k_start)[0]
    q = torch.randn((1, sq, 16)).to(BF16)
    k, v = (torch.randn((1, sk, 16)).to(BF16) for _ in range(2))
    out, lse = attention_plain(q, k, v, 1, 1, True, q_start, k_start)
    for t in empty:
        rows = slice(t * 64, (t + 1) * 64)
        assert not bool(keep[rows].any())
        assert torch.all(out[:, rows] == 0) and torch.all(torch.isneginf(lse[:, rows]))


def test_the_walks_of_the_main_path_shapes():
    """The packed train step (two 64-token documents) leaves one causal
    tile in three dead; a ring hop is fast throughout; a chunked prefill
    masks only its last key tile (the causal edge)."""
    seg = _ids("docs", 128)
    packed = flash_fwd.rect_plan(BF16, 32, 128, 128, 64, H100_SMS, True)
    assert _kinds(packed, seg) == {(0, 0): "masked", (0, 1): "dead", (1, 0): "dead",
                                   (1, 1): "masked"}
    assert sum(len(packed.visits(x, y, seg)) for x in range(32) for y in range(2)) == 2 * 32
    hop = _plan(_case("ring hop bf16 (1,512,4,128) q_start 512"))
    assert set(_kinds(hop).values()) == {"fast"}
    chunk = _plan(_case("chunked prefill bf16 q(1,128,4,128) kv 1024 q_start 896"))
    assert [len(chunk.walk(t)) for t in range(2)] == [15, 16]
    assert [kind for (q, k), kind in _kinds(chunk).items() if kind != "fast"] == [
        "masked", "dead", "masked"]  # rows 896-959: tile 14 masked, 15 dead; 960-1023: 15


@pytest.mark.parametrize("d", flash_fwd.HEAD_DIMS)
@pytest.mark.parametrize("sms", [1, 10**9])
def test_shared_memory_fits_a_block(d, sms):
    plan = flash_fwd.rect_plan(BF16, 4, 256, 300, d, sms, True)
    bm = plan.block_m
    # 1 KiB slack, Q tile, two stages of 64-key K and V, two stages of 64 int32
    # ids and their min and max, five mbarriers
    assert plan.smem_bytes == 1024 + (bm + 4 * 64) * d * 2 + 2 * (64 + 2) * 4 + 40
    assert plan.smem_bytes <= MAX_SMEM


def test_shared_memory_by_hand_at_the_widest_tiles():
    assert flash_fwd.rect_plan(BF16, 8, 4096, 4096, 128, H100_SMS, False).smem_bytes == 99_896
    assert flash_fwd.rect_plan(BF16, 4, 512, 512, 128, H100_SMS, False).smem_bytes == 83_512


@pytest.mark.parametrize("d", flash_fwd.HEAD_DIMS)
def test_f32_keeps_the_cuda_core_plan(d):
    for causal, window in MASKS:
        got = flash_fwd.rect_plan(F32, 6, 130, 300, d, H100_SMS, causal, window, 16, 3)
        tri = flash_fwd.tri_plan(F32, 6, 130, d, H100_SMS)
        assert (got.block_m, got.threads, got.grid, got.smem_bytes, got.swizzle) == (
            tri.block_m, tri.threads, tri.grid, tri.smem_bytes, tri.swizzle) == (
            64, 256, (3, 6), tri.smem_bytes, 0)
        # from d 32 the tile kernels walk tile-major (n = 2 + 3 * 5: row 5, rank
        # 2), a plain causal mask's last q tile first
        heaviest = d > flash_fwd.F32_WHOLE_ROW_D and causal and not window
        assert got.cta(2, 5) == (5, 0 if heaviest else 2)


def test_a_window_is_a_band_of_causal_attention_only():
    full = flash_fwd.rect_plan(BF16, 4, 300, 300, 64, H100_SMS, False, 9)
    assert full.window is None and full == flash_fwd.rect_plan(BF16, 4, 300, 300, 64, H100_SMS,
                                                               False)
    assert flash_fwd.rect_plan(BF16, 4, 300, 300, 64, H100_SMS, True, 0).window is None


def test_plan_constants_match_the_cuda_source():
    src, header = CU_SOURCE.read_text(), HEADER.read_text()
    assert int(re.search(r"constexpr int kStages = (\d+);", src).group(1)) == flash_fwd.TRI_STAGES
    assert int(re.search(r"constexpr int kRingRows = (\d+);", header).group(1)) == TILE
    assert re.search(r"constexpr int kSegBytes = kStages \* \(kRingRows \+ 2\) \* 4;", src)
    assert flash_fwd.SEG_BYTES == flash_fwd.TRI_STAGES * (TILE + 2) * 4
    # id staging: lane 0's TMA bytes and lanes 1-31's stores complete a stage
    assert "mbar_init(&full[st], segments ? 1 + 31 : 1);" in src
    # the entry drops a window without a causal mask, as rect_plan does
    assert "causal && window > 0 ? window : 0" in src
    # the general entry takes the plan, like the triangle's
    sig = src[src.index('extern "C" int flash_fwd_rect('):]
    sig = sig[:sig.index("{")]
    assert all(f"int {arg}" in sig for arg in ("block_m", "smem", "swizzle"))
    # the helpers both sources share live in the header, once
    for helper in ("warp_range", "id_range", "mma_rows_by_rows", "mma_frag_by_tile"):
        assert f" {helper}(" in header
        for source in (src, CU_SOURCE.with_name("flash_bwd.cu").read_text()):
            assert f"__device__ __forceinline__ int2 {helper}(" not in source
            assert f"void {helper}(" not in source


def test_cpu_tensors_never_touch_the_plan_or_the_library(monkeypatch):
    def refuse(*_, **__):
        raise AssertionError("the CPU path reached the plan or the library")

    monkeypatch.setattr(flash_fwd, "rect_plan", refuse)
    monkeypatch.setattr(flash_fwd, "_lib", refuse)
    gen = torch.Generator().manual_seed(6)
    q = torch.randn((4, 70, 16), generator=gen).to(BF16)
    k, v = (torch.randn((2, 90, 16), generator=gen).to(BF16) for _ in range(2))
    square = (torch.randn((2, 70, 16), generator=gen).to(BF16) for _ in range(2))
    seg = (torch.arange(70) >= 64).to(torch.int32).expand(1, 70).contiguous()
    before = flash_fwd.flash_fwd_rect.launches
    for args in ((k, v, False), (k, v, True, 30, 10)):
        got = flash_fwd.flash_fwd_rect(q, *args[:2], 4, 2, *args[2:])
        want = attention_plain(q, *args[:2], 4, 2, *args[2:])
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    ks, vs = square
    got = flash_fwd.flash_fwd_rect(q, ks, vs, 4, 2, True, window=9, seg=seg)
    want = attention_plain(q, ks, vs, 4, 2, True, window=9, seg=seg)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert flash_fwd.flash_fwd_rect.launches == before


SASS = """
		Function : _ZN12_GLOBAL__N_121flash_fwd_rect_kernelI13__nv_bfloat16Li128ELi2EEEvNS_6ParamsE14CUtensorMap_stS3_S3_
        /*0b60*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;
        /*0c60*/                   HGMMA.64x128x16.F32.BF16 R88, R24, gdesc[UR8].tnspB, R88 ;
		Function : _ZN12_GLOBAL__N_121flash_fwd_rect_kernelIfLi64EEEvNS_6ParamsE
        /*0010*/                   FFMA R4, R5, R6, R4 ;
		Function : _ZN12_GLOBAL__N_120flash_fwd_tri_kernelI13__nv_bfloat16Li16ELi1EEEvNS_6ParamsE14CUtensorMap_stS3_S3_
        /*0b60*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;
"""


def test_forward_labels_on_a_sass_excerpt():
    counts = chip_smoke.hgmma_counts(SASS)
    labels = {chip_smoke.fwd_bf16_label(name): n for name, n in counts.items()}
    assert labels == {"rect_d128_wg2": 2, None: 0, "d16_wg1": 1}
    # the triangle's own label reads only the triangle, as before
    assert {chip_smoke.tri_bf16_label(name) for name in counts} == {None, "d16_wg1"}


@pytest.mark.parametrize("label, masked", [
    ("bf16 (1,512,4,128) full", False),
    ("ring hop bf16 (1,512,4,128) q_start 512", False),  # every pair live: no mask
    ("chunked prefill bf16 q(1,128,4,128) kv 1024 q_start 896", True),
    ("bf16 (1,512,4,128) window 128", True),
])
def test_the_sdpa_yardstick_takes_a_mask_only_where_some_pair_is_masked(label, masked):
    kwargs = chip_smoke._sdpa_kwargs(_case(label), None, tri=False, device="cpu")
    assert ("attn_mask" in kwargs) == masked and not kwargs.get("is_causal", False)


def test_bound_counts_the_packed_segment_ids():
    case = _case("burnin packed bf16 (8,128,4,64) 2 segments")
    plain = dict(case, packed=0)
    live = 8 * 4 * 2 * 64 * 65 // 2
    with_ids, by = chip_smoke._bound(case, live, 64)
    without, _ = chip_smoke._bound(plain, live, 64)
    assert by == "bytes" and with_ids - without == pytest.approx(4 * 8 * 128 / 3.35e9)


# the tile-height knob: block_m forces the height the one-wave rule picks

KNOB_SHAPES = [(1, 1, 1, 0, 0), (8, 64, 64, 16, 0), (32, 128, 128, 0, 0),
               (4, 128, 1024, 896, 0), (8, 4096, 4096, 0, 0), (256, 130, 100, 0, 0)]


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("causal, window", [(False, None), (True, None), (True, 33)])
@pytest.mark.parametrize("bh, sq, sk, q_start, k_start", KNOB_SHAPES)
def test_unset_block_m_is_todays_plan(bh, sq, sk, q_start, k_start, causal, window, dtype):
    for sms in (1, H100_SMS, 10**9):
        args = (dtype, bh, sq, sk, 64, sms, causal, window, q_start, k_start)
        assert flash_fwd.rect_plan(*args, block_m=None) == flash_fwd.rect_plan(*args)


@pytest.mark.parametrize("block_m, picking_sms", [(64, 10**9), (128, 1)])
@pytest.mark.parametrize("causal, window", [(False, None), (True, None), (True, 33)])
@pytest.mark.parametrize("bh, sq, sk, q_start, k_start", KNOB_SHAPES)
def test_a_forced_height_is_the_plan_an_sm_count_picking_it_gives(bh, sq, sk, q_start, k_start,
                                                                  causal, window, block_m,
                                                                  picking_sms):
    want = flash_fwd.rect_plan(BF16, bh, sq, sk, 128, picking_sms, causal, window, q_start,
                               k_start)
    assert want.block_m == block_m
    for sms in (1, H100_SMS, 10**9):
        assert flash_fwd.rect_plan(BF16, bh, sq, sk, 128, sms, causal, window, q_start, k_start,
                                   block_m=block_m) == want


@pytest.mark.parametrize("dtype, block_m", [(F32, 128), (F32, 96), (BF16, 32), (BF16, 192)])
def test_a_height_no_kernel_takes_raises(dtype, block_m):
    with pytest.raises(ValueError):
        flash_fwd.rect_plan(dtype, 4, 64, 64, 64, H100_SMS, True, block_m=block_m)
    q = torch.zeros((2, 8, 16), dtype=dtype)
    with pytest.raises(ValueError):  # the CPU path checks it too
        flash_fwd.flash_fwd_rect(q, q, q, 2, 2, False, block_m=block_m)
