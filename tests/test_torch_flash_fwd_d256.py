"""The 16-bit forwards at head dim 256 (``flash_fwd.cu``'s ``rows_body``):
128-row CTAs of two consumer warpgroups and a producer warpgroup, both
warpgroups reading every 64-key K and V tile, and a general walk that never
copies a key tile whose one document is not the CTA's rows' one. No JAX
here, so the card cases run on a machine with a card and no JAX:

    python -m pytest tests/test_torch_flash_fwd_d256.py --noconftest -q

On the CPU: the plans (threads, grid, shared memory against the CUDA
source), ``block_m`` 64 choosing nothing, the triangle's two masked tiles
a q tile, and ``RectPlan.walk/kind/loads/visits`` with the skip: every
live (q, k) pair covered once and no dead tile copied, for unsorted ids,
ragged lengths, offsets and a window. On the card: both forwards in bf16
and fp16 against ``attention_plain`` (O 2e-2, lse 1e-3, phase 3's bars).
"""

import collections
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tpu_operator_torch.kernels import flash_fwd
from tpu_operator_torch.kernels.flash_fwd import attention_plain, keep_mask

CU_SOURCE = Path(flash_fwd.__file__).with_name("flash_fwd.cu")
BF16, F16 = torch.bfloat16, torch.float16
H100_SMS = 132
MAX_SMEM = 232_448  # bytes of shared memory a block may use on Hopper
TILE = flash_fwd.RECT_TILE
D = 256
O_TOL, LSE_TOL = 2e-2, 1e-3


def _smem(tri: bool) -> int:
    # alignment slack, the 128-row Q tile, two stages of 64-key K and V
    # tiles (512 bytes a row), the general kernel's staged ids, the barriers
    return 1024 + (128 + 2 * 2 * 64) * 512 + (0 if tri else 2 * 64 * 4) + 8 * (4 * 2 + 1)


@pytest.mark.parametrize("dtype", [BF16, F16])
@pytest.mark.parametrize("bh, s", [(1, 1), (8, 100), (8, 4096), (8, 8192), (3, 1000)])
def test_both_plans_by_hand(dtype, bh, s):
    tri = flash_fwd.tri_plan(dtype, bh, s, D, H100_SMS)
    rect = flash_fwd.rect_plan(dtype, bh, s, s, D, H100_SMS, False)
    for plan, smem in ((tri, _smem(True)), (rect, _smem(False))):
        assert (plan.block_m, plan.threads, plan.grid, plan.swizzle, plan.col_split) == (
            128, 384, (bh, -(-s // 128)), 128, 1)
        assert plan.smem_bytes == smem <= MAX_SMEM
    assert (tri.smem_bytes, rect.smem_bytes) == (197_704, 198_216)
    assert rect.skips and not flash_fwd.rect_plan(dtype, bh, s, s, 128, H100_SMS, False).skips


def test_plan_constants_match_the_cuda_source():
    src = CU_SOURCE.read_text()
    assert "constexpr int kRowsHeadDim = 256;" in src and flash_fwd.ROWS_HEAD_DIM == 256
    assert "constexpr int kRowsBM = 128;" in src and flash_fwd.ROWS_BM == 128
    assert "constexpr int kRowsThreads = 3 * 128;" in src and flash_fwd.ROWS_THREADS == 384
    assert "constexpr int kRowsStageBarriers = 4;" in src
    body = src[src.index("constexpr int rows_smem_bytes()"):]
    body = body[:body.index("}")]
    assert "(kRowsBM + 2 * kStages * kRingRows) * kRowsHeadDim * 2" in body
    assert "(TRI ? 0 : kStages * kRingRows * 4)" in body
    assert "8 * (kRowsStageBarriers * kStages + 1)" in body
    # setmaxnreg: the producer warpgroup's registers handed to the consumers
    regs = {k: int(v) for k, v in re.findall(r"constexpr int (kRows\w+Regs) = (\d+);", src)}
    assert 2 * 128 * regs["kRowsConsumerRegs"] + 128 * regs["kRowsProducerRegs"] <= 65_536
    assert "reg_dealloc<kRowsProducerRegs>()" in src and "reg_alloc<kRowsConsumerRegs>()" in src
    # the one D 256 launch: 128 rows a CTA; the 64-row one is gone
    assert "if (block_m != kRowsBM" in src
    assert "D 512 and 576: one warpgroup only" in src


@pytest.mark.parametrize("d", [256, 129, 200, 255])
def test_block_m_64_is_accepted_and_chooses_nothing(d):
    width = flash_fwd.padded_head_dim(d)
    assert width == D and flash_fwd.tile_heights(BF16, d) == (64,)
    for dtype in (BF16, F16):
        assert flash_fwd.tri_plan(dtype, 8, 8192, width, H100_SMS, block_m=64) == \
            flash_fwd.tri_plan(dtype, 8, 8192, width, H100_SMS)
        for sms in (1, H100_SMS, 10**9):
            assert flash_fwd.rect_plan(dtype, 8, 300, 300, width, sms, True, 33, 0, 0, 64) == \
                flash_fwd.rect_plan(dtype, 8, 300, 300, width, H100_SMS, True, 33)
        with pytest.raises(ValueError, match="head_dim"):
            flash_fwd.tri_plan(dtype, 8, 8192, width, H100_SMS, block_m=128)
    q = torch.zeros((2, 8, D), dtype=BF16)
    flash_fwd.flash_fwd_tri(q, q, q, 2, 2, block_m=64)  # the CPU checks it and runs the plain


@pytest.mark.parametrize("s", [64, 100, 128, 200, 1000, 8192])
def test_the_triangles_two_masked_tiles(s):
    """The triangle walks 64-key tiles up to its last row's diagonal, its q
    tiles heaviest first; a q tile's last two key tiles carry the causal
    mask: the first warpgroup's diagonal and the last tile (dead for it,
    so masked whole), and the second warpgroup's diagonal; every other tile
    is fast."""
    tri = flash_fwd.tri_plan(BF16, 1, s, D, H100_SMS)
    model = flash_fwd.rect_plan(BF16, 1, s, s, D, H100_SMS, True)  # the same body's rule
    walks = [len(model.walk(tri.cta(0, y)[1])) for y in range(tri.grid[1])]
    assert walks == sorted(walks, reverse=True)
    for y in range(tri.grid[1]):
        tile = tri.cta(0, y)[1]
        walk = list(model.walk(tile))
        assert walk == list(range(-(-min(s, 128 * tile + 128) // TILE)))
        kinds = {(q, k): kind for q, k, kind in model.visits(0, tile)}
        # both warpgroups multiply every tile (a slice past s too: its rows,
        # never written, see no key)
        assert set(kinds) == {(q, k) for q in (2 * tile, 2 * tile + 1) for k in walk}
        for (q, k), kind in kinds.items():
            assert (kind == "masked") == (k >= q or 64 * q >= s), (tile, q, k)
        assert {k for (q, k), kind in kinds.items() if kind == "masked" and 64 * q < s} == set(
            walk[-2:]) & {2 * tile, 2 * tile + 1}
        if 2 * tile + 1 in walk:  # the first warpgroup's dead tile, masked whole
            assert model.kind(128 * tile, 64 * (2 * tile + 1)) == "dead"


def _ids(kind, s, seed=0):
    if kind == "docs":  # whole 64-token documents
        return (torch.arange(s) // 64).to(torch.int32)
    if kind == "packed":  # two documents split mid-tile
        return (torch.arange(s) >= s * 3 // 5).to(torch.int32)
    if kind == "0,1,0":  # a document that comes back after another
        return torch.tensor([0, 1, 0], dtype=torch.int32)[torch.arange(s) * 3 // s]
    if kind == "2,0,1,0,2":
        return torch.tensor([2, 0, 1, 0, 2], dtype=torch.int32)[torch.arange(s) * 5 // s]
    return torch.randint(0, 3, (s,), generator=torch.Generator().manual_seed(seed),
                         dtype=torch.int32)


MASKS = [(False, None), (True, None), (True, 33), (True, 200)]
IDS = ["docs", "packed", "0,1,0", "2,0,1,0,2", "random"]


def _live(plan, seg):
    keep = keep_mask(1, plan.sq, plan.sk, 1, plan.causal, plan.q_start, plan.k_start,
                     plan.window, seg[None])[0]
    return keep


@pytest.mark.parametrize("ids", IDS)
@pytest.mark.parametrize("s, q_start, k_start", [(100, 0, 0), (300, 0, 0), (1000, 0, 0),
                                                 (1000, 64, 0), (700, 0, 90), (4100, 0, 0)])
@pytest.mark.parametrize("causal, window", MASKS)
def test_the_skip_covers_every_live_pair_once_and_loads_no_dead_tile(causal, window, s, q_start,
                                                                     k_start, ids):
    seg = _ids(ids, s, seed=s)
    plan = flash_fwd.rect_plan(BF16, 1, s, s, D, H100_SMS, causal, window, q_start, k_start)
    keep = _live(plan, seg)
    got = collections.Counter()
    for y in range(plan.grid[1]):
        q0 = y * 128
        loads = plan.loads(y, seg)
        walk = list(plan.walk(y))
        assert loads == [k for k in walk if k in loads]  # in the walk's order
        for k in walk:
            block = keep[q0:q0 + 128, k * TILE:(k + 1) * TILE]
            if k not in loads:  # skipped: one document each side, different ones
                assert not bool(block.any()), (y, k)
                rows, keys = seg[q0:min(q0 + 128, s)], seg[k * TILE:min(k * TILE + TILE, s)]
                assert len(set(rows.tolist())) == len(set(keys.tolist())) == 1
        for q, k, kind in plan.visits(0, y, seg):
            assert k in loads
            got[q, k] += 1
    assert set(got.values()) <= {1}
    live = {(q, k) for q in range(-(-s // 64)) for k in range(-(-s // TILE))
            if bool(keep[q * 64:(q + 1) * 64, k * TILE:(k + 1) * TILE].any())}
    assert live <= set(got)


def test_a_document_that_comes_back_is_never_skipped():
    """Ids 0, 1, 0 over 8192 positions: the third part's q tiles (document
    0) load the first part's key tiles and skip the second's, whose one
    document is 1; a q tile inside the second part loads only the key
    tiles that hold some of document 1."""
    s = 8192
    seg = _ids("0,1,0", s)
    plan = flash_fwd.rect_plan(BF16, 1, s, s, D, H100_SMS, True)
    docs = [set(seg[k * TILE:(k + 1) * TILE].tolist()) for k in range(s // TILE)]
    first = {k for k in range(len(docs) // 2) if docs[k] == {0}}
    second = {k for k, ids in enumerate(docs) if ids == {1}}
    third = set(plan.loads(plan.grid[1] - 1, seg))
    assert first and second and first <= third and not second & third
    middle = s // 2 // 128
    assert plan.loads(middle, seg) == [k for k in plan.walk(middle) if 1 in docs[k]]


@pytest.mark.parametrize("sq, sk, q_start, k_start", [(256, 256, 0, 200), (300, 300, 0, 256)])
def test_a_cta_whose_walk_is_empty(sq, sk, q_start, k_start):
    plan = flash_fwd.rect_plan(BF16, 1, sq, sk, D, H100_SMS, True, None, q_start, k_start)
    assert list(plan.walk(0)) == [] and plan.loads(0, _ids("packed", sk)) == []
    assert plan.visits(0, 0) == [] and plan.visits(0, 0, _ids("packed", sk)) == []


# the card: both forwards against attention_plain


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _err(a, b):
    a, b = a.float(), b.float()
    assert torch.equal(torch.isneginf(a), torch.isneginf(b))
    inf = torch.isneginf(a)
    return float((torch.where(inf, 0.0, a) - torch.where(inf, 0.0, b)).abs().max())


def _inputs(seed, b, sq, sk, h, h_kv, d, dtype):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to("cuda", dtype)
            for shape in ((b * h, sq, d), (b * h_kv, sk, d), (b * h_kv, sk, d))]


def _seg(kind, b, s):
    if kind is None:
        return None
    if kind == "cut":
        ids = (torch.arange(s) >= s // 3).to(torch.int32)
    else:
        ids = _ids(kind, s)
    return ids.to("cuda").expand(b, s).contiguous()


# (label, b, sq, sk, h, h_kv, triangle, causal, window, ids, q_start, k_start, width)
CASES = [
    ("triangle sq 200", 1, 200, 200, 2, 2, True, True, None, None, 0, 0, 256),
    ("triangle gqa 8 sq 1000", 2, 1000, 1000, 8, 1, True, True, None, None, 0, 0, 256),
    ("full sq 300", 2, 300, 300, 4, 2, False, False, None, None, 0, 0, 256),
    ("causal gqa 8 sq 1000", 1, 1000, 1000, 8, 1, False, True, None, None, 0, 0, 256),
    ("packed 0,1,0 causal", 2, 1000, 1000, 4, 1, False, True, None, "0,1,0", 0, 0, 256),
    ("packed 0,1,0 full", 1, 1000, 1000, 2, 2, False, False, None, "0,1,0", 0, 0, 256),
    ("packed 2,0,1,0,2 window 200", 1, 1300, 1300, 2, 1, False, True, 200, "2,0,1,0,2", 0, 0,
     256),
    ("empty walk (k_start 200)", 1, 256, 256, 2, 2, False, True, None, None, 0, 200, 256),
    ("window 33, segments", 2, 500, 500, 4, 2, False, True, 33, "cut", 0, 0, 256),
    ("chunked prefill q_start 896", 1, 128, 1024, 4, 4, False, True, None, None, 896, 0, 256),
    ("padded 192", 1, 700, 700, 4, 2, True, True, None, None, 0, 0, 192),
    ("padded 192 packed", 1, 700, 700, 4, 2, False, True, None, "packed", 0, 0, 192),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, F16])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_both_forwards_match_plain(cuda, dtype, case):
    label, b, sq, sk, h, h_kv, tri, causal, window, ids, q_start, k_start, width = case
    q, k, v = _inputs(sq + sk + h, b, sq, sk, h, h_kv, width, dtype)
    seg = _seg(ids, b, sk)
    scale = None if width == D else 1.0 / math.sqrt(width)
    qp, kp, vp = (F.pad(x, (0, D - width)) for x in (q, k, v))
    if tri:
        before = flash_fwd.flash_fwd_tri.launches
        out, lse = flash_fwd.flash_fwd_tri(qp, kp, vp, h, h_kv, sm_scale=scale)
        launches = flash_fwd.flash_fwd_tri.launches - before
    else:
        before = flash_fwd.flash_fwd_rect.launches
        out, lse = flash_fwd.flash_fwd_rect(qp, kp, vp, h, h_kv, causal, q_start, k_start, window,
                                            seg, sm_scale=scale)
        launches = flash_fwd.flash_fwd_rect.launches - before
    want, want_lse = attention_plain(q, k, v, h, h_kv, causal, q_start, k_start, window, seg)
    torch.cuda.synchronize()
    assert launches == 1
    assert _err(want, out[..., :width]) <= O_TOL, label
    assert bool((out[..., width:] == 0).all())  # the zero-padded columns of V
    assert _err(want_lse, lse) <= LSE_TOL, label
