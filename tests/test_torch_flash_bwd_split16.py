"""The 16-bit dK/dV kernels up to head dim 256 (``flash_bwd.cu``'s
``dkv_tc_body``): the GQA walk split in parts whose f32 partials
``flash_bwd_dkv_split_sum_kernel<T>`` adds in part order, S^T and dP^T
formed once a tile at D 256 (each consumer warpgroup on half of a tile's
q rows, P^T and dS^T exchanged through shared memory), and packed tiles
whose documents cannot meet never loaded (every warp reduces a tile's ids
to their range). On the CPU: the split rule (``flash_bwd.gqa_split``) on
stubbed resident CTA counts, the split walks against the plain version's
mask, the tiles a CTA loads, the partials' workspace, the shared memory by
hand, the constants against the CUDA source, the aligned collapse of one
head, and ``chip_smoke``'s and ``scripts/kernel_ab.py``'s wiring. This file
imports no JAX, so its card tests run on a machine with a card and no JAX:

    python -m pytest tests/test_torch_flash_bwd_split16.py --noconftest -q -m cuda

each forced split of Gemma-2B-like shapes (bf16 and fp16, the triangle and
two documents) within 2e-2 of max |grad| of ``attention_bwd_plain``, two
runs at one split bit for bit, the wrappers' own split and the occupancy
query, and the build's registers and spills.
"""

import collections
import importlib.util
import math
import pathlib
import re

import numpy as np
import pytest
import torch

import chip_smoke
from tpu_operator_torch.kernels import flash_bwd, flash_fwd
from tpu_operator_torch.workloads.flashattention import _collapse_heads

BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32
H100_SMS = 132
MAX_SMEM = 232_448  # bytes of shared memory a block may use on the H100
TILE = flash_bwd.TILE
KERNELS = pathlib.Path(flash_fwd.__file__).parent
ROOT = KERNELS.parents[1]
BF16_TOL = 2e-2


def _plans(dtype, bh, bh_kv, s, d, resident, causal=True, window=None, rect=False,
           block_m=None):
    if rect:
        return flash_bwd.rect_bwd_plan(dtype, bh, bh_kv, s, d, H100_SMS, causal, window,
                                       block_m=block_m, clusters=resident)
    return flash_bwd.tri_bwd_plan(dtype, bh, bh_kv, s, d, H100_SMS, block_m, clusters=resident)


# phase 3's 16-bit rows the split reaches: (bh, bh_kv, s, d, rect) -> split
# with one dK/dV CTA an SM (132 resident)
SPLITS = {
    # Gemma-2B (1,8192,8,256) h_kv 1, plain causal and packed: the heaviest
    # walk 8 x 128 = 1024 steps, P / R = 66,048 / 132 = 501: sp 4
    (8, 1, 8192, 256, False): 4,
    (8, 1, 8192, 256, True): 4,
    # (1,4096,8,256) full attention: GQA 1
    (8, 8, 4096, 256, True): 1,
    # (1,512,4,128) GQA 2: 16 CTAs of 64 keys, the heaviest 2 x 8 steps
    (4, 2, 512, 128, False): 2,
    # the burn-in's GQA (8,128,4,64) h_kv 2
    (32, 16, 128, 64, False): 2,
    # (1,2048,8,256) h_kv 1: heaviest 256, P / R = 4224 / 132 = 32: sp 8
    (8, 1, 2048, 256, False): 8,
}


@pytest.mark.parametrize("key", sorted(SPLITS))
@pytest.mark.parametrize("dtype", [BF16, F16])
def test_the_16bit_split_rule_on_stubbed_ctas(key, dtype):
    """gqa_split at 132 resident CTAs: Gemma-2B's triangle and packed walks
    in 4 parts (the rule plans the mask's walk, never the ids), full
    attention at GQA 1 unsplit, (1,512,4,128) GQA 2 in 2; the grid's x holds
    split x kv rows; the partials are (2, split, kv rows, s, d) f32 (64 MiB
    at Gemma-2B); no resident count, no split; dQ never splits."""
    bh, bh_kv, s, d, rect = key
    dq, dkv = _plans(dtype, bh, bh_kv, s, d, H100_SMS, rect=rect)
    sp = SPLITS[key]
    tiles = -(-s // dkv.block)
    assert (dkv.split, dkv.grid, dq.split) == (sp, (bh_kv * sp, tiles), 1)
    assert (bh // bh_kv) % sp == 0
    assert dkv.workspace(s, d) == (None if sp == 1 else (2, sp, bh_kv, s, d))
    assert _plans(dtype, bh, bh_kv, s, d, None, rect=rect)[1].split == 1
    if key == (8, 1, 8192, 256, False):
        assert math.prod(dkv.workspace(s, d)) * 4 == 64 << 20


@pytest.mark.parametrize("d", [16, 64, 128, 256])
@pytest.mark.parametrize("resident", [1, 132, 264, 10**6])
def test_the_split_divides_the_group_and_is_1_at_gqa_1(d, resident):
    """Every mask and group: the split divides the group, is 1 at GQA 1,
    and a card that holds every step at once splits the whole group."""
    for group in (1, 2, 3, 4, 6, 8):
        for rect, causal, window in ((False, True, None), (True, False, None),
                                     (True, True, 33), (True, True, None)):
            _, dkv = _plans(BF16, 2 * group, 2, 1000, d, resident, causal, window, rect)
            assert group % dkv.split == 0 and (group > 1 or dkv.split == 1)
    _, dkv = _plans(BF16, 8, 1, 2048, d, 10**6)
    assert dkv.split == 8


def _docs(s, cuts):
    return [sum(i >= c for c in cuts) for i in range(s)]


@pytest.mark.parametrize("d, block", [(64, 64), (64, 128), (128, 128), (256, 64)])
@pytest.mark.parametrize("group, split", [(1, 1), (2, 2), (4, 2), (4, 4)])
@pytest.mark.parametrize("s, causal, window, cuts", [
    (1, True, None, None), (130, True, None, None), (130, False, None, None),
    (300, True, 70, None), (130, True, 33, (88,)), (300, True, None, (128, 200)),
    (300, False, None, (64, 200)), (1000, True, None, (320, 640))])
def test_the_split_walks_visit_every_live_pair_once(d, block, group, split, s, causal,
                                                    window, cuts):
    """A split 16-bit dK/dV's blocks over its parts visit every (member, q
    tile, 64-key slice) of the band whose tiles do not hold two different
    documents each whole, once, and no other; the tiles they load hold
    every visit and, with segment ids, none whose one document differs
    from all of the CTA's keys' one."""
    kv_rows = 2
    tiles = -(-s // TILE)
    seg = None if cuts is None else torch.tensor(_docs(s, cuts), dtype=torch.int32)[None]
    ids = None if seg is None else seg[0].tolist()
    rect = not (causal and window is None and cuts is None)
    _, dkv = _plans(BF16, group * kv_rows, kv_rows, s, d, None, causal, window, rect, block)
    plan = dkv.with_split(split)
    assert plan.grid == (kv_rows * split, -(-s // block)) and plan.block == block

    def tile_pairs(keep):
        return {(q, k) for q in range(tiles) for k in range(tiles)
                if bool(keep[q * TILE:(q + 1) * TILE, k * TILE:(k + 1) * TILE].any())}

    live = tile_pairs(flash_fwd.keep_mask(1, s, s, 1, causal, window=window, seg=seg)[0])
    band = tile_pairs(flash_fwd.keep_mask(1, s, s, 1, causal, window=window)[0])
    walked = {(q, k) for q, k in band if ids is None or not flash_bwd.apart(
        ids[q * TILE:(q + 1) * TILE], ids[k * TILE:(k + 1) * TILE])}
    assert live <= walked
    got = collections.Counter((plan.cta(x, y)[0], *v) for x in range(plan.grid[0])
                              for y in range(plan.grid[1])
                              for v in plan.visits(x, y, s, group, ids))
    assert set(got.values()) <= {1}
    assert set(got) == {(row, m, q, k) for row in range(kv_rows) for m in range(group)
                        for q, k in walked}
    for x in range(plan.grid[0]):
        for y in range(plan.grid[1]):
            loads = plan.loads(x, y, s, group, ids)
            assert len(set(loads)) == len(loads)
            assert {(m, q) for m, q, _ in plan.visits(x, y, s, group, ids)} <= set(loads)
            first = plan.cta(x, y)[1] * block
            keys = ids[first:min(s, first + block)] if ids else None
            for m, q in loads:
                assert keys is None or not flash_bwd.apart(ids[q * TILE:(q + 1) * TILE], keys)


def test_a_split_part_walks_its_own_members_heaviest_first():
    """The 16-bit grid's x holds part x kv rows + kv row and its y the key
    tiles, so in launch order (x fastest) every part's and row's key tile 0
    (the triangle's longest walks) starts first; block x walks the members
    of part x // kv rows."""
    _, dkv = _plans(BF16, 8, 2, 300, 128, None, block_m=64)
    plan = dkv.with_split(2)
    assert plan.grid == (4, 5)
    order = [(x, y) for y in range(plan.grid[1]) for x in range(plan.grid[0])]
    assert [plan.cta(x, y) for x, y in order[:4]] == [(0, 0), (1, 0), (0, 0), (1, 0)]
    work = [len(plan.visits(x, y, 300, 4)) for x, y in order]
    assert work == sorted(work, reverse=True)
    for x, y in order:
        part = x // 2
        assert {m for m, _, _ in plan.visits(x, y, 300, 4)} == {2 * part, 2 * part + 1}


def test_packed_gemma_never_loads_a_dead_tile():
    """Gemma-2B packed in two documents (8192 tokens, cut at 4096, 8
    members at sp 4): a key tile of the first document walks the whole
    triangle below it, of which the second document's 64 q tiles are dead;
    none of those loads, so the loads are the live steps: 33,280 of the
    66,048 the mask's walk holds."""
    s = 8192
    ids = _docs(s, (s // 2,))
    _, dkv = _plans(BF16, 8, 1, s, 256, H100_SMS, rect=True)
    assert dkv.split == 4
    walk = loads = 0
    for x in range(dkv.grid[0]):
        for y in range(dkv.grid[1]):
            first = dkv.cta(x, y)[1]
            walk += 2 * len(dkv.walk(first, s))
            loads += len(dkv.loads(x, y, s, 8, ids))
    assert (walk, loads) == (66_048, 33_280)


def test_shared_memory_at_256_by_hand_with_the_exchange():
    """At D 256 a dK/dV CTA holds, beside the parent's layout, 16 KiB for
    its warpgroups' P^T and dS^T halves: 2 warpgroups x 2 matrices x 64
    keys x 32 q rows x 2 bytes; both pairs fit a block. D <= 128 and every
    dQ keep their layouts."""
    assert flash_bwd.DKV_EXCHANGE_BYTES == 2 * 2 * 64 * 32 * 2 == 16_384
    for rect, want in ((False, 198_696 + 16_384), (True, 199_224 + 16_384)):
        dq, dkv = _plans(BF16, 8, 1, 8192, 256, None, rect=rect)
        assert dkv.smem_bytes == want <= MAX_SMEM
        assert dq.smem_bytes == (197_672 if not rect else 198_200)
    assert (215_080, 215_608) == (198_696 + 16_384, 199_224 + 16_384)
    for d in (16, 32, 64, 128):
        _, dkv = _plans(BF16, 8, 2, 4096, d, None)
        base = 1024 + (2 * dkv.block + 4 * 64) * d * 2 + 40 + 1024
        assert dkv.smem_bytes == base


def test_plan_constants_match_the_cuda_source():
    src = (KERNELS / "flash_bwd.cu").read_text()
    header = (KERNELS / "hopper.cuh").read_text()
    # the exchange: [warpgroup][P^T, dS^T][k16 step][thread] of 16 bytes
    assert "constexpr int kXchBytes = 2 * 2 * 2 * 128 * 16;" in src
    assert 2 * 2 * 2 * 128 * 16 == flash_bwd.DKV_EXCHANGE_BYTES
    assert "return kv_split<D>() > 1 && col_split<D>() == 1 ? kXchBytes : 0;" in src
    assert "constexpr int QH = kTile / CS;" in src
    assert "mma_rows_by_ring_rows<T, D, QH>(s, k_s, BN, kw * 64, qs, r0);" in src
    assert "static_assert(N == kRingRows || N == kRingRows / 2" in header
    # two named barriers a tile, of the consumer threads only
    assert "named_sync(kXchFree, NC * 128);" in src and "named_sync(kXchFull, NC * 128);" in src
    # the split: parts on the grid's x, partials summed by T's split sum
    assert "const int share = group / (gridDim.x / p.rows);" in src
    assert "const size_t row = blockIdx.x;" in src  # dK/dV's row, or the part's partials' row
    assert "kernel<<<dim3(rows * split, tiles, col_split<D>())" in src
    assert "flash_bwd_dkv_split_sum_kernel<SplitOut><<<" in src
    assert "bool split_takes(int dtype, int d) { return dtype == kElemCode && d <= 256; }" in src
    # the dead tiles: each warp's range of the tile's ids, producer and consumers alike
    assert "if (segments && (t * kTile >= k0 + BN || (t + 1) * kTile <= k0)) {" in src
    assert "if (dead(range_of(tile_ids(t)))) continue;" in src
    assert "if (segments && dead(qr)) continue;" in src
    assert "ranges" not in src[src.index("struct Params"):src.index("};", src.index("struct Params"))]
    # D 512 and 576 keep their body
    assert 'static_assert(col_split<D>() > 1, "D <= 256: dkv_tc_body");' in src
    assert src.count("dkv_slice_body<T, D, WG,") == 2


def test_one_head_at_an_unaligned_base_comes_back_aligned_and_equal():
    """A (1,128,1,256) q, k and v, each a view 4 bytes into its storage:
    the collapse (no copy for one head at a native width) copies them to
    aligned bases, equal to the views; an aligned one stays the caller's."""
    for dtype in (F32, BF16, F16):
        off = 4 // (torch.finfo(dtype).bits // 8)  # 4 bytes
        base = torch.randn(3, 128 * 256 + off).to(dtype)
        views = [base[i, off:].view(1, 128, 1, 256) for i in range(3)]
        assert all(v.data_ptr() % flash_fwd.TMA_ALIGN for v in views)
        qb, kb, vb, h, h_kv = _collapse_heads(*views)
        for got, view in zip((qb, kb, vb), views):
            assert got.data_ptr() % flash_fwd.TMA_ALIGN == 0 and got.shape == (1, 128, 256)
            assert torch.equal(got, view.reshape(1, 128, 256))
        aligned = torch.randn(1, 128, 1, 256).to(dtype)
        assert _collapse_heads(aligned, aligned, aligned)[0].data_ptr() == aligned.data_ptr()


def test_chip_smoke_checks_the_16bit_split_sums():
    """Phase 2 holds one split sum a base library, of its 16-bit type, to
    0 spills; the f32 label reads the f32 sum only."""
    assert chip_smoke.SPLIT_SUM_LIBRARIES == {"flash_bwd": "bf16", "flash_bwd_f16": "fp16"}
    name = "_ZN12_GLOBAL__N_130flash_bwd_dkv_split_sum_kernelI{}EEvPK6float4PT_S5_mi"
    for arg, label in (("13__nv_bfloat16", "bf16"), ("6__half", "fp16"), ("f", "f32")):
        assert chip_smoke.split_sum_label(name.format(arg)) == label
        assert chip_smoke.f32_label(name.format(arg)) == (
            "flash_bwd_dkv_split_sum_kernel" if label == "f32" else None)
    assert chip_smoke.split_sum_label("flash_bwd_dkv_tri_kernelI13__nv_bfloat16Li256ELi1EE") is None
    assert chip_smoke.f32_dkv_at_split is chip_smoke.dkv_at_split


def _kernel_ab():
    spec = importlib.util.spec_from_file_location("kernel_ab", ROOT / "scripts" / "kernel_ab.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_kernel_ab_has_the_16bit_backward_family():
    """``--family bwd_16`` times both kernels of every 16-bit backward row
    of phase 3 at head dims up to 256: the Gemma-2B rows among them."""
    ab = _kernel_ab()
    assert ab.FAMILIES["bwd_16"][1:] == (("dq_ms", "dkv_ms"), "flash_bwd")
    rows = [c for c in chip_smoke.BWD_CASES + chip_smoke.HEAD_DIM_BWD_CASES
            + chip_smoke.FLOAT16_BWD_CASES
            if c["dtype"] != F32 and flash_fwd.padded_head_dim(c["q"][3]) <= 256]
    labels = {c["label"] for c in rows}
    assert {"gemma-2b bf16 (1,8192,8,256) h_kv 1", "gemma-2b fp16 (1,8192,8,256) h_kv 1",
            "gemma-2b packed bf16 (1,8192,8,256) h_kv 1 2 segments",
            "gqa bf16 (1,512,4,128) h_kv 2"} <= labels
    assert len(rows) == len(labels)


# --------------------------------------------------------------- on the card


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(seed, s, h, h_kv, d, dtype, cuts=None):
    """q, k, v, the forward's out and lse through the kernels, dO, delta
    and the masks (the triangle's, or causal with segment ids)."""
    rng = np.random.default_rng(seed)

    def make(rows):
        x = rng.standard_normal((rows, s, d)).astype(np.float32)
        return torch.from_numpy(x).to("cuda", dtype)

    qb, kb, vb, dout = make(h), make(h_kv), make(h_kv), make(h)
    if cuts is None:
        out, lse = flash_fwd.flash_fwd_tri(qb, kb, vb, h, h_kv)
        extra = ()
    else:
        seg = torch.tensor(_docs(s, cuts), dtype=torch.int32, device="cuda")[None].contiguous()
        out, lse = flash_fwd.flash_fwd_rect(qb, kb, vb, h, h_kv, True, seg=seg)
        extra = (True, None, seg)
    delta = (dout.float() * out.float()).sum(-1)
    return qb, kb, vb, out, dout, lse, delta, extra


def _bar(want):
    return BF16_TOL * max(float(w.float().abs().max()) for w in want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, F16])
@pytest.mark.parametrize("pair, cuts", [("tri", None), ("rect", (1000,))])
@pytest.mark.parametrize("d", [128, 256])
def test_every_forced_split_matches_plain_and_repeats_its_bits(cuda, dtype, pair, cuts, d):
    """Gemma-2B-like dK/dV (8 q heads on one kv head, 2048 tokens; the
    triangle, and two documents cut off a tile boundary) with its walk in
    1, 2, 4 and 8 parts through the library: each within 2e-2 of max |grad|
    of attention_bwd_plain, and two runs at split 4 the same bits."""
    qb, kb, vb, out, dout, lse, delta, extra = _inputs(5, 2048, 8, 1, d, dtype, cuts)
    want = flash_bwd.attention_bwd_plain(qb, kb, vb, out, lse, dout, 8, 1, True,
                                         seg=extra[2] if extra else None)
    bar = _bar(want)
    for split in (1, 2, 4, 8):
        run, dk, dv = chip_smoke.dkv_at_split(pair, split, qb, kb, vb, dout, lse, delta, 8, 1,
                                              extra)
        run()
        torch.cuda.synchronize()
        got = (dk.clone(), dv.clone())
        for name, w, g in zip(("dk", "dv"), want[1:], got):
            assert g.dtype == dtype and float((w.float() - g.float()).abs().max()) <= bar, (
                split, name)
        if split == 4:
            run()
            torch.cuda.synchronize()
            assert torch.equal(got[0], dk) and torch.equal(got[1], dv)
    run, _, _ = chip_smoke.dkv_at_split(pair, 3, qb, kb, vb, dout, lse, delta, 8, 1, extra)
    with pytest.raises(RuntimeError, match="at split 3: error -1"):
        run()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, F16])
def test_the_wrappers_split_by_the_cards_resident_ctas(cuda, dtype):
    """One dK/dV CTA an SM at D 256 (215 KB of shared memory); the wrappers
    split (1,2048,8,256) h_kv 1 in 8 parts and (1,512,4,128) GQA 2 in 2, and
    both pairs hold the plain version, with segment ids at 128-key CTAs
    (two table entries a CTA) too."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    _, plan = flash_bwd.tri_bwd_plan(dtype, 8, 1, 2048, 256, sms)
    assert flash_bwd.dkv_resident_ctas(dtype, 256, True, plan) == sms
    for s, h, h_kv, d, cuts, block_m in ((2048, 8, 1, 256, None, None),
                                         (512, 4, 2, 128, None, None),
                                         (1000, 4, 2, 64, (100, 300, 700), 128)):
        qb, kb, vb, out, dout, lse, delta, extra = _inputs(9, s, h, h_kv, d, dtype, cuts)
        pair = "tri" if cuts is None else "rect"
        dkv_fn = getattr(flash_bwd, f"flash_bwd_dkv_{pair}")
        before = dkv_fn.launches
        dk, dv = dkv_fn(qb, kb, vb, out, dout, lse, delta, h, h_kv, *extra, block_m=block_m)
        dq = getattr(flash_bwd, f"flash_bwd_dq_{pair}")(qb, kb, vb, out, dout, lse, delta, h,
                                                        h_kv, *extra, block_m=block_m)
        want = flash_bwd.attention_bwd_plain(qb, kb, vb, out, lse, dout, h, h_kv, True,
                                             seg=extra[2] if extra else None)
        torch.cuda.synchronize()
        assert dkv_fn.launches == before + 1
        bar = _bar(want)
        for name, w, g in zip(("dq", "dk", "dv"), want, (dq, dk, dv)):
            assert float((w.float() - g.float()).abs().max()) <= bar, (s, d, name)


@pytest.mark.cuda
def test_the_changed_kernels_build_without_spills(cuda):
    """Both base libraries hold one split sum of their 16-bit type, and no
    dK/dV instantiation nor sum spills a register."""
    from tpu_operator_torch.kernels import build

    for lib, elem in chip_smoke.SPLIT_SUM_LIBRARIES.items():
        path, _ = build.build([lib])[lib]
        report = chip_smoke.ptxas_by_function(path.with_suffix(".log").read_text())
        sums = [k for k in report if chip_smoke.split_sum_label(k) == elem]
        dkv = [k for k in report
               if re.search(r"flash_bwd_dkv_(tri|rect)_kernelI(13__nv_bfloat16|6__half)", k)]
        assert len(sums) == 1 and len(dkv) == 18, (lib, sums, len(dkv))
        for k in sums + dkv:
            assert not report[k]["spill_stores"] and not report[k]["spill_loads"], (lib, k)
