"""The general backward pair's launch plan and tile rule, on the CPU. No
JAX here.

The bf16 general pair (``flash_bwd_{dq,dkv}_rect``) runs only on the card
(``tests/test_torch_kernels.py``); its plan and the rule by which a
warpgroup treats a tile are plain Python, so they are checked here: tile
heights and CTA counts at the shapes ``chip_smoke.py`` times, the walks of
full attention, plain causal and window bands covering every live
(q tile, key tile) pair exactly once (dK/dV: once per GQA group member),
heaviest-first order under a plain causal mask only, shared memory within
Hopper's 232,448 bytes a block with the staged segment ids, the constants
against the CUDA source, and the fast / masked / dead rule of a tile
against ``keep_mask``.
"""

import collections
import re
from pathlib import Path

import pytest
import torch

import chip_smoke
from tpu_operator_torch.kernels import flash_bwd
from tpu_operator_torch.kernels.flash_fwd import attention_plain, keep_mask

CU_SOURCE = Path(flash_bwd.__file__).with_name("flash_bwd.cu")
BF16, F32 = torch.bfloat16, torch.float32
H100_SMS = 132
MAX_SMEM = 232_448  # bytes of shared memory a block may use on Hopper
TILE = flash_bwd.TILE

# the bf16 general rows of chip_smoke.BWD_CASES: label -> ((dq block, dq
# CTAs), (dkv block, dkv CTAs))
TIMED = {
    "burnin packed bf16 (8,128,4,64) 2 segments": ((64, 64), (64, 64)),  # 32 rows x 2 tiles
    "bf16 (8,128,4,64) segments cut 88": ((64, 64), (64, 64)),
    "bf16 (1,512,4,128) full": ((64, 32), (64, 32)),                      # 4 rows x 8 tiles
    "bf16 (1,512,4,128) window 128": ((64, 32), (64, 32)),
    "bf16 (1,512,4,128) gqa h_kv 2, window 128, segments cut 288": ((64, 32), (64, 16)),
    "timing bf16 (1,4096,8,128) full": ((128, 256), (128, 256)),         # 8 x 32 of 128
    "timing bf16 (1,4096,8,128) causal": ((128, 256), (128, 256)),
}

# (causal, window) of the walks: full, plain causal, and window bands
WALKS = [(False, None), (True, None), (True, 1), (True, 33), (True, 128), (True, 200)]


def _case(label):
    return next(c for c in chip_smoke.BWD_CASES if c["label"] == label)


def _plans(case, sms=H100_SMS):
    b, s, h, d = case["q"]
    return flash_bwd.rect_bwd_plan(case["dtype"], b * h, b * case.get("h_kv", h), s, d, sms,
                                   case.get("causal", True), case.get("window"))


def test_timed_shapes_are_the_bf16_general_cases():
    assert set(TIMED) == {c["label"] for c in chip_smoke.BWD_CASES
                          if c["pair"] == "rect" and c["dtype"] == BF16}


@pytest.mark.parametrize("label", sorted(TIMED))
def test_tile_heights_and_cta_counts_at_the_timed_shapes(label):
    case = _case(label)
    b, s, h, _ = case["q"]
    rows = {"dq": b * h, "dkv": b * case.get("h_kv", h)}
    for plan, (block, ctas) in zip(_plans(case), TIMED[label]):
        assert plan.block == block
        assert plan.grid == (rows[plan.kernel], -(-s // block))
        assert plan.grid[0] * plan.grid[1] == ctas
        assert plan.threads == 2 * block + (32 if plan.kernel == "dq" else 128)


@pytest.mark.parametrize("causal, window", WALKS)
@pytest.mark.parametrize("s", [1, 1000, 4096])
def test_tile_heights_are_the_triangle_pairs(s, causal, window):
    for sms in (1, H100_SMS, 10**9):
        for rows in (1, 4, 33, 256):
            got = flash_bwd.rect_bwd_plan(BF16, 2 * rows, rows, s, 64, sms, causal, window)
            tri = flash_bwd.tri_bwd_plan(BF16, 2 * rows, rows, s, 64, sms)
            for g, t in zip(got, tri):
                assert (g.block, g.threads, g.grid, g.swizzle) == (t.block, t.threads, t.grid,
                                                                  t.swizzle)


def _live_tiles(s, causal, window):
    """(q tile, key tile) pairs with a pair (q < s, k < s) inside the band."""
    keep = keep_mask(1, s, s, 1, causal, window=window)[0]
    tiles = -(-s // TILE)
    return {(q, k) for q in range(tiles) for k in range(tiles)
            if bool(keep[q * TILE:(q + 1) * TILE, k * TILE:(k + 1) * TILE].any())}


@pytest.mark.parametrize("sms", [1, 10**9])  # forces 128- and 64-row tiles
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("s", [1, 63, 64, 100, 130, 1000])
@pytest.mark.parametrize("causal, window", WALKS)
def test_every_live_tile_pair_is_covered_once(causal, window, s, group, sms):
    live = _live_tiles(s, causal, window)
    dq, dkv = flash_bwd.rect_bwd_plan(BF16, 2 * group, 2, s, 32, sms, causal, window)
    assert dq.block == dkv.block == (128 if sms == 1 else 64)
    got = collections.Counter((dq.cta(x, y)[0], *v) for x in range(dq.grid[0])
                              for y in range(dq.grid[1]) for v in dq.visits(x, y, s, 1))
    assert set(got.values()) == {1}
    assert set(got) == {(row, 0, q, k) for row in range(2 * group) for q, k in live}
    got = collections.Counter((dkv.cta(x, y)[0], *v) for x in range(dkv.grid[0])
                              for y in range(dkv.grid[1]) for v in dkv.visits(x, y, s, group))
    assert set(got.values()) == {1}
    assert set(got) == {(row, m, q, k) for row in range(2) for m in range(group) for q, k in live}


@pytest.mark.parametrize("sms", [1, 10**9])
@pytest.mark.parametrize("s", [200, 1000, 4096])
def test_only_plain_causal_launches_heaviest_first(s, sms):
    for causal, window in WALKS:
        for plan in flash_bwd.rect_bwd_plan(BF16, 3, 3, s, 64, sms, causal, window):
            gx, gy = plan.grid
            # CTAs start in linear order, x fastest
            order = [plan.cta(x, y)[1] for y in range(gy) for x in range(gx)]
            work = [len(plan.visits(x, y, s, group=2)) for y in range(gy) for x in range(gx)]
            if causal and flash_bwd.band(causal, window, s) is None:  # a window >= s is none
                assert work == sorted(work, reverse=True) and work[-1] < work[0]
            else:
                assert order == sorted(order)  # natural order: the work is about even


def test_a_window_of_s_or_more_is_no_band():
    assert flash_bwd.band(True, 100, 100) is None and flash_bwd.band(True, 99, 100) == 99
    assert flash_bwd.band(False, 7, 100) is None and flash_bwd.band(True, None, 100) is None
    wide = flash_bwd.rect_bwd_plan(BF16, 4, 4, 300, 64, H100_SMS, True, 300)
    assert wide == flash_bwd.rect_bwd_plan(BF16, 4, 4, 300, 64, H100_SMS, True)
    assert flash_bwd.rect_bwd_plan(BF16, 4, 4, 300, 64, H100_SMS, False, 9) == \
        flash_bwd.rect_bwd_plan(BF16, 4, 4, 300, 64, H100_SMS, False)


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("sms", [1, 10**9])
def test_shared_memory_fits_a_block(d, sms):
    tri = flash_bwd.tri_bwd_plan(BF16, 4, 4, 256, d, sms)
    rect = flash_bwd.rect_bwd_plan(BF16, 4, 4, 256, d, sms, True, 33)
    for t, r in zip(tri, rect):
        # the triangle's layout, then two stages of 64 int32 ids and their min and max
        assert r.smem_bytes == t.smem_bytes + 2 * (64 + 2) * 4 == t.smem_bytes + 528
        assert r.smem_bytes <= MAX_SMEM


def test_shared_memory_by_hand_at_the_widest_tiles():
    dq, dkv = flash_bwd.rect_bwd_plan(BF16, 8, 8, 4096, 128, H100_SMS, False)
    assert (dq.block, dq.smem_bytes, dkv.block, dkv.smem_bytes) == (128, 132_664, 128, 133_688)


@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_f32_keeps_the_cuda_core_plans(d):
    for causal, window in WALKS:
        got = flash_bwd.rect_bwd_plan(F32, 8, 4, 130, d, H100_SMS, causal, window)
        tri = flash_bwd.tri_bwd_plan(F32, 8, 4, 130, d, H100_SMS)
        assert [(p.block, p.threads, p.grid, p.smem_bytes, p.swizzle) for p in got] == \
            [(p.block, p.threads, p.grid, p.smem_bytes, p.swizzle) for p in tri]


def test_plan_constants_match_the_cuda_source():
    src = CU_SOURCE.read_text()
    stages = int(re.search(r"constexpr int kStages = (\d+);", src).group(1))
    assert re.search(r"constexpr int kSegBytes = kStages \* \(kTile \+ 2\) \* 4;", src)
    assert flash_bwd.SEG_BYTES == stages * (TILE + 2) * 4
    # the entries drop a window that is no band, as band() does
    assert "causal && window > 0 && window < s ? window : 0" in src
    # the rect entries take the plan, like the triangle's
    for name in ("flash_bwd_dq_rect", "flash_bwd_dkv_rect"):
        sig = src[src.index(f'extern "C" int {name}('):]
        assert "int block" in sig[:sig.index("{")] and "int swizzle" in sig[:sig.index("{")]


def test_cpu_tensors_never_touch_the_plan_or_the_library(monkeypatch):
    def refuse(*_):
        raise AssertionError("the CPU path reached the plan or the library")

    monkeypatch.setattr(flash_bwd, "rect_bwd_plan", refuse)
    monkeypatch.setattr(flash_bwd, "_lib", refuse)
    gen = torch.Generator().manual_seed(5)
    q = torch.randn((4, 70, 16), generator=gen).to(BF16)
    k, v = (torch.randn((2, 70, 16), generator=gen).to(BF16) for _ in range(2))
    dout = torch.randn(q.shape, generator=gen).to(BF16)
    seg = (torch.arange(70) >= 64).to(torch.int32).expand(1, 70).contiguous()
    for causal, window, ids in ((False, None, None), (True, 9, seg), (True, None, seg)):
        out, lse = attention_plain(q, k, v, 4, 2, causal, window=window, seg=ids)
        delta = (dout.float() * out.float()).sum(-1)
        before = (flash_bwd.flash_bwd_dq_rect.launches, flash_bwd.flash_bwd_dkv_rect.launches)
        dq = flash_bwd.flash_bwd_dq_rect(q, k, v, out, dout, lse, delta, 4, 2, causal, window, ids)
        dk, dv = flash_bwd.flash_bwd_dkv_rect(q, k, v, out, dout, lse, delta, 4, 2, causal,
                                              window, ids)
        assert (flash_bwd.flash_bwd_dq_rect.launches,
                flash_bwd.flash_bwd_dkv_rect.launches) == before
        want = flash_bwd.attention_bwd_plain(q, k, v, out, lse, dout, 4, 2, causal, window, ids)
        for w, g in zip(want, (dq, dk, dv)):
            assert torch.equal(w, g)


def rect_tile_kind(kernel, q0, k0, s, causal, window=None, seg=None):
    """How a consumer warpgroup of the bf16 general pair treats the 64 x 64
    tile of q rows from q0 and keys from k0 (the kernels' rule, after the
    reference's ``_dispatch_block``): "dead" — no live pair, no products;
    "fast" — every pair with both positions inside s is live, no element
    mask; "masked" — the element mask. ``seg`` is one batch row's (s,)
    segment ids. dq also masks a key tile that reaches past s (a
    zero-filled key scores exp2(-lse) there); dkv never writes keys past s,
    and rows past s have P = 0 from their lse in both kernels."""
    window = flash_bwd.band(causal, window, s)
    last = TILE - 1
    sees = q0 < s and k0 < s
    masked = kernel == "dq" and k0 + TILE > s
    if causal:
        sees = sees and k0 <= q0 + last
        masked = masked or q0 < k0 + last
    if window is not None:
        sees = sees and q0 - (k0 + last) < window
        masked = masked or q0 + last - k0 >= window
    if seg is not None:
        qs, ks = seg[q0:min(q0 + TILE, s)], seg[k0:min(k0 + TILE, s)]
        uniform = bool(qs.min() == qs.max()) and bool(ks.min() == ks.max())
        sees = sees and not (uniform and bool(qs[0] != ks[0]))
        masked = masked or not uniform
    return "dead" if not sees else "masked" if masked else "fast"


def _ids(kind, s, seed=0):
    if kind == "docs":  # whole 64-token documents: every tile uniform
        return (torch.arange(s) // TILE).to(torch.int32)
    if kind == "packed":  # two documents split mid-tile
        return (torch.arange(s) >= s * 3 // 5).to(torch.int32)
    return torch.randint(0, 3, (s,), generator=torch.Generator().manual_seed(seed),
                         dtype=torch.int32)


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
@pytest.mark.parametrize("ids", [None, "docs", "packed", "random"])
@pytest.mark.parametrize("s", [64, 100, 300])
@pytest.mark.parametrize("causal, window", WALKS)
def test_tile_rule_agrees_with_keep_mask(causal, window, s, ids, kernel):
    """A fast tile has every pair inside s live, a dead tile none; a dq
    fast tile also lies wholly inside s (a zero-filled key would score)."""
    seg = None if ids is None else _ids(ids, s, seed=s)
    keep = keep_mask(1, s, s, 1, causal, window=window,
                     seg=None if seg is None else seg[None])[0]
    tiles = -(-s // TILE)
    kinds = collections.Counter()
    for qt in range(tiles):
        for kt in range(tiles):
            q0, k0 = qt * TILE, kt * TILE
            kind = rect_tile_kind(kernel, q0, k0, s, causal, window, seg)
            block = keep[q0:q0 + TILE, k0:k0 + TILE]
            kinds[kind] += 1
            if kind == "fast":
                assert bool(block.all()), (qt, kt)
                assert kernel == "dkv" or k0 + TILE <= s
            if kind == "dead":
                assert not bool(block.any()), (qt, kt)
    if ids == "docs" and s >= 2 * TILE:
        # whole documents: a tile of two documents is dead; without a causal
        # mask a tile of one is fast (under one, such a tile is a diagonal)
        assert kinds["dead"] > 0 and (causal or kinds["fast"] > 0)
    if ids == "random":
        assert kinds["fast"] == 0


def test_packed_burnin_tiles():
    """The packed train step (two 64-token documents, 64-row tiles): under
    the causal mask one of the three causal tiles has no live pair."""
    seg = _ids("docs", 128)
    kinds = {(qt, kt): rect_tile_kind("dq", qt * 64, kt * 64, 128, True, None, seg)
             for qt in range(2) for kt in range(2)}
    assert kinds == {(0, 0): "masked", (0, 1): "dead", (1, 0): "dead", (1, 1): "masked"}
    dq, dkv = flash_bwd.rect_bwd_plan(BF16, 32, 32, 128, 64, H100_SMS, True)
    products = [v for p in (dq,) for x in range(p.grid[0]) for y in range(p.grid[1])
                for v in p.visits(x, y, 128, 1)]
    # the band walks 3 tiles per row; segment ids leave 2 of them with products
    assert len(products) == 3 * 32
    assert sum(kinds[(q, k)] != "dead" for _, q, k in products) == 2 * 32


SASS_RECT = """
		Function : _ZN12_GLOBAL__N_124flash_bwd_dq_rect_kernelI13__nv_bfloat16Li64ELi2EEEvNS_6ParamsE14CUtensorMap_stS3_S3_S3_
        /*0b60*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;
		Function : _ZN12_GLOBAL__N_125flash_bwd_dkv_rect_kernelIfLi64EEEvNS_6ParamsE
        /*0010*/                   FFMA R4, R5, R6, R4 ;
		Function : _ZN12_GLOBAL__N_124flash_bwd_dkv_tri_kernelI13__nv_bfloat16Li32ELi1EEEvNS_6ParamsE14CUtensorMap_stS3_S3_S3_
        /*0b60*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;
        /*0b70*/                   HGMMA.64x32x16.F32.BF16 R56, R24, gdesc[UR8].tnspB, R56 ;
"""


def test_hgmma_counter_on_a_general_excerpt():
    counts = chip_smoke.hgmma_counts(SASS_RECT)
    labels = {chip_smoke.tri_bwd_bf16_label(name): n for name, n in counts.items()}
    assert labels == {"dq_rect_d64_wg2": 1, None: 0, "dkv_d32_wg1": 2}


@pytest.mark.parametrize("label, causal", [
    ("bf16 (1,512,4,128) full", False), ("timing bf16 (1,4096,8,128) causal", True)])
def test_the_plain_yardsticks_take_no_mask(label, causal):
    """SDPA is timed without an explicit mask on full attention and on the
    triangle's work (a mask would pick a slower masked backend)."""
    kwargs = chip_smoke._sdpa_kwargs(_case(label), None, tri=False)
    assert "attn_mask" not in kwargs and kwargs.get("is_causal", False) == causal
