"""The triangle backward pair's launch plan, its SASS check in
``chip_smoke.py``, the header-aware library hash and the cotangent's
alignment, on the CPU. No JAX here.

The kernels run only on the card (``tests/test_torch_kernels.py``); their
plan is plain Python, so its choices are checked here: tile heights and
CTA counts at the shapes ``chip_smoke.py`` times, the heaviest-first order
of CTAs, shared memory within Hopper's 232,448 bytes a block, and that the
(q tile, key tile) products the CTAs compute cover every live pair of the
causal triangle exactly once (dK/dV: once per GQA group member).
"""

import collections
import re
from pathlib import Path

import pytest
import torch

import chip_smoke
from tpu_operator_torch.kernels import build, flash_bwd
from tpu_operator_torch.workloads.flashattention import _tma_aligned

CU_SOURCE = Path(flash_bwd.__file__).with_name("flash_bwd.cu")
HEADER = Path(flash_bwd.__file__).with_name("hopper.cuh")
BF16, F32 = torch.bfloat16, torch.float32
H100_SMS = 132
MAX_SMEM = 232_448  # bytes of shared memory a block may use on Hopper
MAX_REGS = 65_536   # 32-bit registers of one SM

# the bf16 triangle rows of chip_smoke.BWD_CASES: label -> ((dq block,
# dq CTAs), (dkv block, dkv CTAs))
TIMED = {
    "burnin bf16 (8,128,4,64)": ((64, 64), (64, 64)),            # 32 rows x 2 tiles each
    "burnin gqa bf16 (8,128,4,64) h_kv 2": ((64, 64), (64, 32)),  # 16 kv rows
    "gqa bf16 (1,512,4,128) h_kv 2": ((64, 32), (64, 16)),       # 2 kv rows x 8 key tiles
    "ragged bf16 (2,1000,4,128)": ((64, 128), (64, 128)),         # 8 x 8 of 128 < one wave
    "timing bf16 (1,4096,8,128)": ((128, 256), (128, 256)),       # 8 x 32 of 128: two waves
    "autotune sweep bf16 (1,8192,8,128)": ((128, 512), (128, 512)),  # 8 x 64 of 128
}


def _case(label):
    return next(c for c in chip_smoke.BWD_CASES if c["label"] == label)


def _plans(case, sms=H100_SMS):
    b, s, h, d = case["q"]
    return flash_bwd.tri_bwd_plan(case["dtype"], b * h, b * case.get("h_kv", h), s, d, sms)


def test_timed_shapes_are_the_bf16_triangle_cases():
    assert set(TIMED) == {c["label"] for c in chip_smoke.BWD_CASES
                          if c["pair"] == "tri" and c["dtype"] == BF16}


@pytest.mark.parametrize("label", sorted(TIMED))
def test_tile_heights_and_cta_counts_at_the_timed_shapes(label):
    case = _case(label)
    b, s, h, _ = case["q"]
    rows = {"dq": b * h, "dkv": b * case.get("h_kv", h)}
    for plan, (block, ctas) in zip(_plans(case), TIMED[label]):
        assert plan.block == block
        assert plan.grid == (rows[plan.kernel], -(-s // block))
        assert plan.grid[0] * plan.grid[1] == ctas
        # a consumer warpgroup per 64 rows; a producer warp (dq) or warpgroup (dkv)
        assert plan.threads == 2 * block + (32 if plan.kernel == "dq" else 128)


@pytest.mark.parametrize("rows, s, block", [
    (132, 1, 128),    # exactly one wave of 128-row tiles
    (131, 1, 64),
    (8, 1000, 64),    # the ragged row: 8 x 8 tiles of 128 would not fill a wave
    (256, 1000, 128),
])
def test_tile_height_follows_one_wave_of_sms(rows, s, block):
    dq, dkv = flash_bwd.tri_bwd_plan(BF16, rows, rows, s, 64, H100_SMS)
    assert dq.block == dkv.block == block
    # the two kernels choose apart: dkv has fewer rows under GQA
    dq, dkv = flash_bwd.tri_bwd_plan(BF16, 4 * rows, rows, s, 64, H100_SMS)
    assert (dq.block, dkv.block) == (128 if 4 * rows * -(-s // 128) >= H100_SMS else 64, block)
    # a card with fewer SMs fills a wave sooner
    assert all(p.block == 128 for p in flash_bwd.tri_bwd_plan(BF16, rows, rows, s, 64, sms=1))


@pytest.mark.parametrize("sms", [1, 10**9])  # forces 128- and 64-row tiles
@pytest.mark.parametrize("s", [200, 1000, 4096])
def test_heaviest_tiles_launch_first(s, sms):
    for plan in flash_bwd.tri_bwd_plan(BF16, 3, 3, s, 64, sms):
        gx, gy = plan.grid
        # CTAs start in linear order, x fastest
        work = [len(plan.visits(x, y, s, group=2)) for y in range(gy) for x in range(gx)]
        assert work == sorted(work, reverse=True) and work[-1] < work[0]


@pytest.mark.parametrize("sms", [1, 10**9])
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("s", [1, 63, 64, 100, 200, 1000])
def test_every_live_tile_pair_is_covered_once(s, group, sms):
    tiles = -(-s // flash_bwd.TILE)
    live = {(q, k) for q in range(tiles) for k in range(q + 1)}  # some key <= some row
    dq, dkv = flash_bwd.tri_bwd_plan(BF16, 2 * group, 2, s, 32, sms)
    # dq: each (batch, head) row's live pairs once, no member
    got = collections.Counter((dq.cta(x, y)[0], *v) for x in range(dq.grid[0])
                              for y in range(dq.grid[1]) for v in dq.visits(x, y, s, 1))
    assert set(got.values()) == {1}
    assert set(got) == {(row, 0, q, k) for row in range(2 * group) for q, k in live}
    # dkv: each kv row's live pairs once per group member
    got = collections.Counter((dkv.cta(x, y)[0], *v) for x in range(dkv.grid[0])
                              for y in range(dkv.grid[1]) for v in dkv.visits(x, y, s, group))
    assert set(got.values()) == {1}
    assert set(got) == {(row, m, q, k) for row in range(2) for m in range(group) for q, k in live}


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("sms", [1, 10**9])
def test_shared_memory_fits_a_block(d, sms):
    dq, dkv = flash_bwd.tri_bwd_plan(BF16, 4, 4, 256, d, sms)
    for plan in (dq, dkv):
        bm = plan.block
        # 1 KiB alignment slack, the CTA's two own tiles, two stages of the
        # ring's two 64-row tiles (dkv: with 64 f32 lse and delta each), five mbarriers
        extra = 2 * 2 * 64 * 4 if plan.kernel == "dkv" else 0
        assert plan.smem_bytes == 1024 + (2 * bm + 4 * 64) * d * 2 + extra + 40
        assert plan.smem_bytes <= MAX_SMEM
        assert plan.swizzle == 2 * min(d, 64)


def test_shared_memory_by_hand_at_the_widest_tiles():
    dq, dkv = flash_bwd.tri_bwd_plan(BF16, 8, 8, 4096, 128, H100_SMS)
    assert (dq.block, dq.smem_bytes, dkv.block, dkv.smem_bytes) == (128, 132_136, 128, 133_160)
    dq, dkv = flash_bwd.tri_bwd_plan(BF16, 4, 2, 512, 128, H100_SMS)
    assert (dq.block, dq.smem_bytes, dkv.block, dkv.smem_bytes) == (64, 99_368, 64, 100_392)


# f32 on the CUDA cores. At d 16 the whole-row pair: tiles of 4 x 64 rows x
# (d + 1) floats, dS 64 x 65 (dkv: P too, and 64 lse and delta), 64 segment
# ids. From 32 one CTA a tile (the cluster pair at c = 1): six tiles of 64 rows
# of the slab (64 columns at d 32 and 64, 128 at 128: two resident, two ring
# stages of two) and the score tiles (dq: dS^T; dkv: P^T and dS^T)
@pytest.mark.parametrize("d, dq_smem, dkv_smem", [
    (16, 34_304, 51_456), (32, 114_688, 131_072), (64, 114_688, 131_072),
    (128, 212_992, 229_376),
])
def test_f32_keeps_the_cuda_core_plans(d, dq_smem, dkv_smem):
    dq, dkv = flash_bwd.tri_bwd_plan(F32, 8, 4, 130, d, H100_SMS)
    assert (dq.block, dq.threads, dq.swizzle, dq.grid, dq.smem_bytes) == (64, 256, 0, (3, 8), dq_smem)
    assert (dkv.block, dkv.threads, dkv.swizzle, dkv.grid, dkv.smem_bytes) == (
        64, 256, 0, (3, 4), dkv_smem)
    if d == 16:  # tiles on x, rows on y
        assert dq.cta(2, 5) == dkv.cta(2, 5) == (5, 2)
    else:
        # tile-major launch: block (x, y) is the launch's n = x + 3 y-th, tile n // rows
        # of row n % rows; dq's last q tile first
        assert dq.cta(2, 5) == (1, 0) and dkv.cta(2, 3) == (3, 2)
    assert dkv_smem <= MAX_SMEM


def test_plan_constants_match_the_cuda_source():
    src, header = CU_SOURCE.read_text(), HEADER.read_text()
    assert '#include "hopper.cuh"' in src
    assert int(re.search(r"constexpr int kStages = (\d+);", src).group(1)) == flash_bwd.TRI_BWD_STAGES
    assert int(re.search(r"constexpr int kTile = (\d+);", src).group(1)) == flash_bwd.TILE
    assert "constexpr int kSmemAlign = 1024;" in header
    producer = int(re.search(r"constexpr int kProducerRegs = (\d+);", src).group(1))
    consumer = int(re.search(r"constexpr int kConsumerRegs = (\d+);", src).group(1))
    # setmaxnreg at two consumer warpgroups: the SM's registers hold all three
    assert 2 * 128 * consumer + 128 * producer <= MAX_REGS
    assert producer % 8 == consumer % 8 == 0 and 24 <= producer < consumer <= 256


def test_cpu_tensors_never_touch_the_plan_or_the_library(monkeypatch):
    def refuse(*_):
        raise AssertionError("the CPU path reached the plan or the library")

    monkeypatch.setattr(flash_bwd, "tri_bwd_plan", refuse)
    monkeypatch.setattr(flash_bwd, "_lib", refuse)
    gen = torch.Generator().manual_seed(4)
    q = torch.randn((4, 5, 16), generator=gen).to(BF16)
    k, v = (torch.randn((2, 5, 16), generator=gen).to(BF16) for _ in range(2))
    dout = torch.randn(q.shape, generator=gen).to(BF16)
    from tpu_operator_torch.kernels.flash_fwd import attention_plain

    out, lse = attention_plain(q, k, v, 4, 2, causal=True)
    delta = (dout.float() * out.float()).sum(-1)
    before = (flash_bwd.flash_bwd_dq_tri.launches, flash_bwd.flash_bwd_dkv_tri.launches)
    dq = flash_bwd.flash_bwd_dq_tri(q, k, v, out, dout, lse, delta, 4, 2)
    dk, dv = flash_bwd.flash_bwd_dkv_tri(q, k, v, out, dout, lse, delta, 4, 2)
    assert (flash_bwd.flash_bwd_dq_tri.launches, flash_bwd.flash_bwd_dkv_tri.launches) == before
    want = flash_bwd.attention_bwd_plain(q, k, v, out, lse, dout, 4, 2, True)
    for w, g in zip(want, (dq, dk, dv)):
        assert torch.equal(w, g)


SASS = """
	code for sm_90a
		Function : _ZN45_GLOBAL__N__652cd588_12_flash_bwd_cu_2c9edabd23flash_bwd_dq_tri_kernelIfLi64EEEvNS_6ParamsE
        /*0010*/                   FFMA R4, R5, R6, R4 ;
		Function : _ZN45_GLOBAL__N__652cd588_12_flash_bwd_cu_2c9edabd24flash_bwd_dkv_tri_kernelI13__nv_bfloat16Li128ELi2EEEvNS_6ParamsE14CUtensorMap_stS3_S3_S3_
        /*0b60*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;
        /*0c60*/                   HGMMA.64x128x16.F32.BF16 R88, R24, gdesc[UR8].tnspB, R88 ;
		Function : _ZN45_GLOBAL__N__652cd588_12_flash_bwd_cu_2c9edabd23flash_bwd_dq_tri_kernelI13__nv_bfloat16Li16ELi1EEEvNS_6ParamsE14CUtensorMap_stS3_S3_S3_
        /*0b60*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;
		Function : _ZN45_GLOBAL__N__652cd588_12_flash_bwd_cu_2c9edabd25flash_bwd_dq_rect_kernelI13__nv_bfloat16Li64EEEvNS_6ParamsE
        /*0000*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
"""


def test_hgmma_counter_on_a_backward_excerpt():
    counts = chip_smoke.hgmma_counts(SASS)
    labels = {chip_smoke.tri_bwd_bf16_label(name): n for name, n in counts.items()}
    assert labels == {None: 0, "dkv_d128_wg2": 2, "dq_d16_wg1": 1}
    assert len(counts) == 4  # the f32 and general kernels are read and skipped


@pytest.mark.parametrize("mangled, label", [
    ("_ZN12_GLOBAL__N_123flash_bwd_dq_tri_kernelI13__nv_bfloat16Li64ELi2EEEvNS_6ParamsE", "dq_d64_wg2"),
    ("_ZN12_GLOBAL__N_124flash_bwd_dkv_tri_kernelI13__nv_bfloat16Li32ELi1EEEvNS_6ParamsE", "dkv_d32_wg1"),
    ("_ZN12_GLOBAL__N_123flash_bwd_dq_tri_kernelIfLi64EEEvNS_6ParamsE", None),       # f32
    ("_ZN12_GLOBAL__N_124flash_bwd_dkv_tri_kernelIfLi128EEEvNS_6ParamsE", None),
    ("_ZN12_GLOBAL__N_125flash_bwd_dkv_rect_kernelI13__nv_bfloat16Li64EEEvNS_6ParamsE", None),
    ("_ZN12_GLOBAL__N_120flash_fwd_tri_kernelI13__nv_bfloat16Li64ELi2EEEvNS_6ParamsE", None),
    # the general pair on the tensor cores, and its f32 kernels
    ("_ZN12_GLOBAL__N_124flash_bwd_dq_rect_kernelI13__nv_bfloat16Li128ELi1EEEvNS_6ParamsE",
     "dq_rect_d128_wg1"),
    ("_ZN12_GLOBAL__N_125flash_bwd_dkv_rect_kernelI13__nv_bfloat16Li16ELi2EEEvNS_6ParamsE",
     "dkv_rect_d16_wg2"),
    ("_ZN12_GLOBAL__N_124flash_bwd_dq_rect_kernelIfLi64EEEvNS_6ParamsE", None),
    ("_ZN12_GLOBAL__N_125flash_bwd_dkv_rect_kernelIfLi128EEEvNS_6ParamsE", None),
])
def test_tri_bwd_bf16_label_reads_only_the_bf16_backward_pair(mangled, label):
    assert chip_smoke.tri_bwd_bf16_label(mangled) == label


def test_every_library_is_checked_for_its_tensor_core_instantiations():
    # d 16/32/64/128 x 1/2 warpgroups x dq/dkv x the triangle and the general pair
    assert chip_smoke.TENSOR_CORE_KERNELS["flash_bwd"] == (chip_smoke.tri_bwd_bf16_label, 32)
    # d 16/32/64/128 x 1/2 warpgroups x the triangle and the general forward
    assert chip_smoke.TENSOR_CORE_KERNELS["flash_fwd"] == (chip_smoke.fwd_bf16_label, 16)


def test_library_path_changes_with_a_header(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "KERNEL_DIR", tmp_path)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    first = build.library_path("k")
    assert build.library_path("k") == first  # the same bytes, the same library
    (tmp_path / "h.cuh").write_text("// two\n")
    second = build.library_path("k")
    assert second != first and second.name.startswith("libk-")
    (tmp_path / "g.cuh").write_text("")  # a new header rebuilds too
    assert build.library_path("k") not in (first, second)


def test_the_shipped_header_is_hashed():
    assert HEADER.parent == build.KERNEL_DIR and HEADER in set(build.KERNEL_DIR.glob("*.cuh"))


def test_an_offset_cotangent_is_copied_to_an_aligned_base():
    flat = torch.arange(65, dtype=BF16)
    aligned = flat[:64].view(4, 16)
    assert _tma_aligned(aligned) is aligned
    off = flat[1:].view(4, 16)  # contiguous, 2 bytes off its allocation
    assert off.is_contiguous() and off.data_ptr() % 16 == 2
    fixed = _tma_aligned(off)
    assert fixed.data_ptr() % 16 == 0 and torch.equal(fixed, off)


@pytest.mark.parametrize("is_dq, ms", [
    (True, 6 * 128 * 67_125_248 / 989e9),   # 6·D FLOPs per live pair: S, dP, dQ
    (False, 8 * 128 * 67_125_248 / 989e9),  # 8·D: S, dP, dV, dK
])
def test_backward_bound_at_long_context(is_dq, ms):
    got_ms, by = chip_smoke._bwd_bound(_case("timing bf16 (1,4096,8,128)"), 67_125_248, 128, is_dq)
    assert by == "operations" and got_ms == pytest.approx(ms, rel=1e-12)
    assert round(got_ms, 5) == (0.05213 if is_dq else 0.06950)


# the tile-height knob: block_m forces both kernels' height

KNOB_SHAPES = [(1, 1, 1, 16), (32, 32, 128, 64), (32, 16, 128, 64), (4, 2, 512, 128),
               (8, 8, 4096, 128), (132, 66, 1, 64)]


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
@pytest.mark.parametrize("bh, bh_kv, s, d", KNOB_SHAPES)
def test_unset_block_m_is_todays_plan(bh, bh_kv, s, d, dtype):
    for sms in (1, 132, 10**9):
        assert flash_bwd.tri_bwd_plan(dtype, bh, bh_kv, s, d, sms, block_m=None) == \
            flash_bwd.tri_bwd_plan(dtype, bh, bh_kv, s, d, sms)


@pytest.mark.parametrize("block_m, picking_sms", [(64, 10**9), (128, 1)])
@pytest.mark.parametrize("bh, bh_kv, s, d", KNOB_SHAPES)
def test_a_forced_height_is_the_plan_an_sm_count_picking_it_gives(bh, bh_kv, s, d, block_m,
                                                                  picking_sms):
    want = flash_bwd.tri_bwd_plan(BF16, bh, bh_kv, s, d, picking_sms)
    assert [p.block for p in want] == [block_m, block_m]
    for sms in (1, 132, 10**9):
        assert flash_bwd.tri_bwd_plan(BF16, bh, bh_kv, s, d, sms, block_m=block_m) == want


@pytest.mark.parametrize("dtype, block_m", [(torch.float32, 128), (torch.float32, 16),
                                            (BF16, 32), (BF16, 100)])
def test_a_height_no_kernel_takes_raises(dtype, block_m):
    with pytest.raises(ValueError):
        flash_bwd.tri_bwd_plan(dtype, 4, 4, 128, 64, 132, block_m=block_m)
    q = torch.zeros((2, 8, 16), dtype=dtype)
    lse = torch.zeros((2, 8))
    with pytest.raises(ValueError):  # the CPU path checks it too
        flash_bwd.flash_bwd_dq_tri(q, q, q, q, q, lse, lse, 2, 2, block_m=block_m)
    with pytest.raises(ValueError):
        flash_bwd.flash_bwd_dkv_tri(q, q, q, q, q, lse, lse, 2, 2, block_m=block_m)
