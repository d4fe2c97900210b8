"""The triangle forward's launch plan and the card checks of
``chip_smoke.py``, on the CPU: what the kernel is launched with, the
SASS and ptxas parsers, and the roofline bound. No JAX here.

The kernel itself runs only on the card (``tests/test_torch_kernels.py``);
its plan is plain Python, so the choices it makes are checked here:
tile height from the grid size, the CTA count and the heaviest-first
order of q tiles, shared memory within Hopper's 232,448 bytes a block, and
the swizzle span that must match both the TMA box and the wgmma
descriptor.
"""

import math
import re
from pathlib import Path

import pytest
import torch

import chip_smoke
from tpu_operator_torch.kernels import flash_fwd

CU_SOURCE = Path(flash_fwd.__file__).with_name("flash_fwd.cu")
BF16, F32 = torch.bfloat16, torch.float32
H100_SMS = 132
MAX_SMEM = 232_448  # bytes of shared memory a block may use on Hopper

# (label, b, s, h, d): the three triangle shapes chip_smoke.py times
SHAPES = {
    "burnin": (8, 128, 4, 64),
    "validator": (1, 512, 2, 128),
    "long": (1, 4096, 8, 128),
}


def _plan(b, s, h, d):
    return flash_fwd.tri_plan(BF16, b * h, s, d, H100_SMS)


@pytest.mark.parametrize("label, block_m, ctas", [
    ("burnin", 64, 64),      # 32 rows x 2 tiles: under one wave, so 64-row tiles
    ("validator", 64, 16),   # 2 rows x 8 tiles: 128-row tiles would give only 8 CTAs
    ("long", 128, 256),      # 8 rows x 32 tiles of 128: two waves of 132 SMs
])
def test_tile_height_and_cta_count_at_the_timed_shapes(label, block_m, ctas):
    b, s, h, d = SHAPES[label]
    plan = _plan(b, s, h, d)
    assert plan.block_m == block_m
    assert plan.grid == (b * h, math.ceil(s / block_m))
    assert plan.grid[0] * plan.grid[1] == ctas
    assert plan.threads == 2 * block_m + 32  # a warpgroup per 64 rows + the producer warp


@pytest.mark.parametrize("bh, s, block_m", [
    (8, 1000, 64),    # the ragged timing row: 8 x 8 = 64 CTAs of 128 would not fill a wave
    (132, 1, 128),    # exactly one wave of 128-row tiles
    (131, 1, 64),
    (256, 1000, 128),
])
def test_tile_height_follows_one_wave_of_sms(bh, s, block_m):
    assert flash_fwd.tri_plan(BF16, bh, s, 64, H100_SMS).block_m == block_m
    # a card with fewer SMs fills a wave sooner
    assert flash_fwd.tri_plan(BF16, bh, s, 64, sms=1).block_m == 128


@pytest.mark.parametrize("label", sorted(SHAPES))
def test_q_tiles_launch_heaviest_first(label):
    b, s, h, d = SHAPES[label]
    plan = _plan(b, s, h, d)
    gx, gy = plan.grid
    # CTAs start in linear order (x fastest); the work of a q tile is its
    # number of k tiles, q_tile + 1
    work = [plan.cta(x, y)[1] + 1 for y in range(gy) for x in range(gx)]
    assert work == sorted(work, reverse=True)
    assert work[0] == gy and work[-1] == 1
    covered = {plan.cta(x, y) for y in range(gy) for x in range(gx)}
    assert covered == {(row, t) for row in range(b * h) for t in range(gy)}


@pytest.mark.parametrize("d", flash_fwd.HEAD_DIMS)
@pytest.mark.parametrize("sms", [1, 10**9])  # forces 128- and 64-row tiles
def test_shared_memory_fits_a_block(d, sms):
    plan = flash_fwd.tri_plan(BF16, 4, 256, d, sms=sms)
    bm = plan.block_m
    # 1 KiB alignment slack, Q tile, two stages of K and V, five mbarriers
    assert plan.smem_bytes == 1024 + (bm + 4 * bm) * d * 2 + 40
    assert plan.smem_bytes <= MAX_SMEM


def test_shared_memory_by_hand_at_the_widest_tile():
    assert flash_fwd.tri_plan(BF16, 8, 4096, 128, H100_SMS).smem_bytes == 164_904
    assert flash_fwd.tri_plan(BF16, 2, 512, 128, H100_SMS).smem_bytes == 82_984


@pytest.mark.parametrize("d, swizzle", [(16, 32), (32, 64), (64, 128), (128, 128)])
def test_swizzle_span_per_head_dim(d, swizzle):
    assert flash_fwd.tri_plan(BF16, 2, 64, d, H100_SMS).swizzle == swizzle


# f32 at d 16 (the whole-row kernel): tiles of (64 + 2 x 64) rows x (d + 1)
# floats, P 64 x 65, 64 segment ids, q tiles in natural order; from d 32 the
# tile kernels: Q [64][W], two stages of K and V [64][W], P 64 x 68 (W the
# head dim), tile-major, heaviest q tiles first
@pytest.mark.parametrize("d, smem, tile", [(16, 29952, 2), (32, 58368, 0), (64, 99328, 0),
                                           (128, 181248, 0)])
def test_f32_keeps_the_cuda_core_plan(d, smem, tile):
    plan = flash_fwd.tri_plan(F32, 6, 130, d, H100_SMS)
    assert (plan.block_m, plan.threads, plan.swizzle) == (64, 256, 0)
    assert plan.grid == (3, 6) and plan.cta(2, 5) == (5, tile)
    assert plan.smem_bytes == smem <= MAX_SMEM


def test_plan_constants_match_the_cuda_source():
    src = CU_SOURCE.read_text()
    assert int(re.search(r"constexpr int kStages = (\d+);", src).group(1)) == flash_fwd.TRI_STAGES
    assert '#include "hopper.cuh"' in src
    header = CU_SOURCE.with_name("hopper.cuh").read_text()  # the shared Hopper helpers
    assert "constexpr int kSmemAlign = 1024;" in header
    assert "kRowBytes = kCols * 2;  // 32, 64, 128: also the swizzle span" in header


def test_cpu_tensors_never_touch_the_plan_or_the_library():
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((2, 5, 16), generator=gen).to(BF16) for _ in range(3))
    before = flash_fwd.flash_fwd_tri.launches
    out, lse = flash_fwd.flash_fwd_tri(q, k, v, 2, 2)
    want, want_lse = flash_fwd.attention_plain(q, k, v, 2, 2, causal=True)
    assert flash_fwd.flash_fwd_tri.launches == before
    assert torch.equal(out, want) and torch.equal(lse, want_lse)


SASS = """
Fatbin elf code:
================
arch = sm_90a
code version = [1,7]
host = linux
compile_size = 64bit

	code for sm_90a
		Function : _ZN45_GLOBAL__N__febd979e_12_flash_fwd_cu_10a15fe620flash_fwd_tri_kernelIfLi64EEEvNS_6ParamsE
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                                             /* 0x00000a00ff017b82 */
        /*0010*/                   FFMA R4, R5, R6, R4 ;                                              /* 0x0000000605047223 */
		Function : _ZN45_GLOBAL__N__febd979e_12_flash_fwd_cu_10a15fe620flash_fwd_tri_kernelI13__nv_bfloat16Li128ELi2EEEvNS_6ParamsE14CUtensorMap_stS3_S3_
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0b60*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;               /* 0x01e00000041879f0 */
                                                                                                      /* 0x000fe2000c7018ff */
        /*0c60*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], R24 ;                    /* 0x01e00000041879f0 */
        /*4240*/                   HGMMA.64x128x16.F32.BF16 R88, R24, gdesc[UR4].tnspB, R88 ;         /* 0x41e0000418587df0 */
        /*4250*/                   WARPGROUP.DEPBAR.LE gsb0, 0x0 ;                                    /* 0x00000000000079ed */
		Function : _ZN45_GLOBAL__N__febd979e_12_flash_fwd_cu_10a15fe620flash_fwd_tri_kernelI13__nv_bfloat16Li16ELi1EEEvNS_6ParamsE14CUtensorMap_stS3_S3_
        /*0000*/                   LDC R1, c[0x0][0x28] ;                                             /* 0x00000a00ff017b82 */
		Function : _ZN45_GLOBAL__N__febd979e_12_flash_fwd_cu_10a15fe621flash_fwd_rect_kernelI13__nv_bfloat16Li64EEEvNS_6ParamsE
        /*0000*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;                              /* 0x0000000c0804723c */
"""


def test_hgmma_counter_on_a_cuobjdump_excerpt():
    counts = chip_smoke.hgmma_counts(SASS)
    labels = {chip_smoke.tri_bf16_label(name): n for name, n in counts.items()}
    assert labels == {None: 0, "d128_wg2": 3, "d16_wg1": 0}
    assert len(counts) == 4 and sum(counts.values()) == 3  # HMMA is not HGMMA


def test_tri_bf16_label_reads_only_the_bf16_triangle():
    assert chip_smoke.tri_bf16_label(
        "_ZN12_GLOBAL__N_120flash_fwd_tri_kernelI13__nv_bfloat16Li32ELi2EEEvNS_6ParamsE") == "d32_wg2"
    assert chip_smoke.tri_bf16_label("_ZN12_GLOBAL__N_120flash_fwd_tri_kernelIfLi32EEEvNS_6ParamsE") is None
    assert chip_smoke.tri_bf16_label(
        "_ZN12_GLOBAL__N_121flash_fwd_rect_kernelI13__nv_bfloat16Li32EEEvNS_6ParamsE") is None


PTXAS = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN3tri_bf16_128' for 'sm_90a'
ptxas info    : Function properties for _ZN3tri_bf16_128
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 165 registers, used 1 barriers
ptxas info    : Compile time = 225.453 ms
ptxas info    : Compiling entry function '_ZN4rect' for 'sm_90a'
ptxas info    : Function properties for _ZN4rect
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers
"""


def test_ptxas_report_per_function():
    assert chip_smoke.ptxas_by_function(PTXAS) == {
        "_ZN3tri_bf16_128": {"registers": 165, "spill_stores": 0, "spill_loads": 0},
        "_ZN4rect": {"registers": 255, "spill_stores": 12, "spill_loads": 16},
    }


def _live_pairs(b, s, h):
    return b * h * s * (s + 1) // 2


@pytest.mark.parametrize("label, ms, by", [
    # bytes: q, k, v read and O written in bf16 plus the f32 lse, over 3.35 TB/s
    ("burnin", 2 * 4 * 8 * 4 * 128 * 64 / 3.35e9 + 4 * 8 * 4 * 128 / 3.35e9, "bytes"),
    ("validator", 2 * 4 * 2 * 512 * 128 / 3.35e9 + 4 * 2 * 512 / 3.35e9, "bytes"),
    # operations: 4·D FLOPs per live (q, k) pair at 989 TFLOP/s
    ("long", 4 * 128 * _live_pairs(1, 4096, 8) / 989e9, "operations"),
])
def test_bound_at_the_triangle_shapes(label, ms, by):
    b, s, h, d = SHAPES[label]
    case = dict(kernel="flash_fwd_tri", q=(b, s, h, d), dtype=BF16)
    got_ms, got_by = chip_smoke._bound(case, _live_pairs(b, s, h), d)
    assert got_by == by
    assert got_ms == pytest.approx(ms, rel=1e-12)


def test_bound_by_hand_at_long_context():
    ms, by = chip_smoke._bound(dict(q=(1, 4096, 8, 128), dtype=BF16), 67_125_248, 128)
    assert (round(ms, 5), by) == (0.03475, "operations")
    ms, by = chip_smoke._bound(dict(q=(8, 128, 4, 64), dtype=BF16), 264_192, 64)
    assert (round(ms, 5), by) == (0.00063, "bytes")


# the tile-height knob: block_m forces the height a plan's one-wave rule picks

KNOB_SHAPES = [(1, 1, 16), (8, 128, 64), (32, 128, 64), (2, 512, 128), (131, 1, 64),
               (8, 4096, 128), (256, 1000, 32)]


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
@pytest.mark.parametrize("bh, s, d", KNOB_SHAPES)
def test_unset_block_m_is_todays_plan(bh, s, d, dtype):
    for sms in (1, H100_SMS, 10**9):
        assert flash_fwd.tri_plan(dtype, bh, s, d, sms, block_m=None) == \
            flash_fwd.tri_plan(dtype, bh, s, d, sms)


@pytest.mark.parametrize("block_m, picking_sms", [(64, 10**9), (128, 1)])
@pytest.mark.parametrize("bh, s, d", KNOB_SHAPES)
def test_a_forced_height_is_the_plan_an_sm_count_picking_it_gives(bh, s, d, block_m,
                                                                  picking_sms):
    want = flash_fwd.tri_plan(BF16, bh, s, d, picking_sms)
    assert want.block_m == block_m
    for sms in (1, H100_SMS, 10**9):
        assert flash_fwd.tri_plan(BF16, bh, s, d, sms, block_m=block_m) == want


@pytest.mark.parametrize("dtype, block_m", [(torch.float32, 128), (torch.float32, 32),
                                            (BF16, 32), (BF16, 96), (BF16, 256), (BF16, 0),
                                            (BF16, True), (BF16, 64.5)])
def test_a_height_no_kernel_takes_raises(dtype, block_m):
    with pytest.raises(ValueError):
        flash_fwd.tri_plan(dtype, 8, 128, 64, H100_SMS, block_m=block_m)
    q = torch.zeros((2, 8, 16), dtype=dtype)
    with pytest.raises(ValueError):  # the CPU path checks it too
        flash_fwd.flash_fwd_tri(q, q, q, 2, 2, block_m=block_m)


def test_f32_takes_64_as_its_fixed_plan():
    assert flash_fwd.tri_plan(torch.float32, 8, 128, 64, H100_SMS, block_m=64) == \
        flash_fwd.tri_plan(torch.float32, 8, 128, 64, H100_SMS)
