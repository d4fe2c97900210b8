"""The bf16 and fp16 backward pair above head dim 576 in thread-block
clusters: its launch plan, the layout constants of ``flash_bwd.cu``, and
torch models of the design (the columns each slab CTA sums, the exchange's
rows and its 16-bit tiles laid over the f32 partials, the ring of streamed
items), and on the card the four kernels in both 16-bit types against
``attention_bwd_plain``. This file imports no JAX:

    python -m pytest tests/test_torch_flash_wide_bwd_cluster.py --noconftest

A tile's slab CTAs (256 columns of dQ, 128 of dK and dV) are one cluster
of up to 8; each sums a partial S and dP over its own columns, the cluster
adds the partials in rank order through distributed shared memory and forms
P and dS once, and each CTA runs its gradient products on its slab. Card
tolerance as ``tests/test_torch_kernels.py``: 2e-2 of the largest
|gradient|; two runs give the same bits.
"""

import collections
import math
import pathlib

import numpy as np
import pytest
import torch

from tpu_operator_torch.kernels import flash_bwd, flash_fwd

BF16, F16 = torch.bfloat16, torch.float16
MAX_SMEM = 232_448  # bytes of shared memory a block may use on the H100
H100_SMS = 132
KERNELS = pathlib.Path(flash_fwd.__file__).parent
HALF_TOL = 2e-2
DIMS = [640, 704, 1024, 2048, 4096]
BOX = 64


def _pair(dtype, d, rect=False, bh=16, bh_kv=8, s=1000):
    if rect:
        return flash_bwd.rect_bwd_plan(dtype, bh, bh_kv, s, d, H100_SMS, True, 33)
    return flash_bwd.tri_bwd_plan(dtype, bh, bh_kv, s, d, H100_SMS)


@pytest.mark.parametrize("dtype", [BF16, F16])
@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("rect", [False, True])
def test_the_16_bit_plan_is_the_slab_cluster(dtype, d, rect):
    """n = ceil(d / slab) slab CTAs a tile, 256 columns of dQ and 128 of dK
    and dV, in g = ceil(n / 8) clusters of c = ceil(n / g); one warpgroup a
    CTA; the shared memory fits a block; both masks alike."""
    dq, dkv = _pair(dtype, d, rect)
    for plan, slab in ((dq, 256), (dkv, 128)):
        n = math.ceil(d / slab)
        g = math.ceil(n / 8)
        c = math.ceil(n / g)
        assert (plan.slab, plan.cluster, plan.col_split, plan.redundancy) == (slab, c, g * c, g)
        assert (plan.threads, plan.swizzle, plan.block, plan.stages) == (128, 128, 64, 4)
        assert plan.smem_bytes <= MAX_SMEM and plan.grid == (16, 16 if plan is dq else 8)
    assert (dq.cluster, dkv.cluster) == {640: (3, 5), 704: (3, 6), 1024: (4, 8), 2048: (8, 8),
                                         4096: (8, 8)}[d]


def test_the_16_bit_plans_by_hand():
    """flash_bwd.cu's wide16_smem_bytes reckoned by hand: 1 KiB of slack, the
    resident own slab of two tensors (dQ 2 x 4 boxes, dK/dV 2 x 2), four
    stages of four 8 KiB boxes, the exchange's two 64 x 64 f32 tiles, 64
    (lse, delta) pairs and 64 ids of each side, five barriers."""
    box = 64 * 64 * 2
    dq, dkv = _pair(BF16, 1024)
    assert dq.smem_bytes == 1024 + 8 * box + 16 * box + 2 * 64 * 64 * 4 + 64 * 16 + 40 == 231_464
    assert dkv.smem_bytes == 1024 + 4 * box + 16 * box + 2 * 64 * 64 * 4 + 64 * 16 + 40 == 198_696
    assert _pair(F16, 1024, rect=True) == (
        flash_bwd.rect_bwd_plan(BF16, 16, 8, 1000, 1024, H100_SMS, True, 33))


@pytest.mark.parametrize("rect", [False, True])
def test_the_clusters_launch_the_longest_walks_first(rect):
    """Tile-major, as cluster_slot reads the grid: dK/dV's key tile 0 of
    every row first; dQ's last q tile first under a plain causal mask (the
    triangle), in order under a window."""
    dq, dkv = _pair(BF16, 1024, rect)
    tiles = dq.grid[0]
    firsts = [dkv.cta(x, y)[1] for y in range(dkv.grid[1]) for x in range(dkv.grid[0])]
    assert firsts[:dkv.grid[1]] == [0] * dkv.grid[1]
    first = [dq.cta(x, y)[1] for y in range(dq.grid[1]) for x in range(dq.grid[0])]
    assert first[:dq.grid[1]] == [tiles - 1 if not rect else 0] * dq.grid[1]
    walks = [len(dkv.walk(t, 1000)) for t in firsts]
    assert walks == sorted(walks, reverse=True)


def test_the_16_bit_constants_match_the_cuda_sources():
    bwd = (KERNELS / "flash_bwd.cu").read_text()
    assert f"constexpr int kWideDqSlab = {flash_bwd.WIDE_DQ_SLAB};" in bwd
    assert f"constexpr int kWideDkvSlab = {flash_bwd.WIDE_DKV_SLAB};" in bwd
    assert f"constexpr int kWideRing = {flash_bwd.WIDE_BWD_RING};" in bwd
    assert f"constexpr int kWideThreads = {flash_bwd.WIDE_THREADS};" in bwd
    assert "constexpr int kWideXchBytes = 2 * kTile * kTile * 4;" in bwd
    assert flash_bwd.WIDE_XCH_BYTES == 2 * 64 * 64 * 4
    assert ("kWideRing * 4 * kWideBoxBytes + kWideXchBytes + kTile * (8 + 2 * 4) +\n"
            "         8 * (kWideRing + 1);") in bwd
    # the old design is gone: no producer warp, no chunk streaming of whole
    # score tiles in every slab CTA
    for gone in ("stream_scores", "chunk_products", "kWideSlabStages", "kWideIdBytes",
                 "__launch_bounds__(128 + 32, 1)\n    flash_bwd_d"):
        assert gone not in bwd, gone
    for kernel in ("dq", "dkv"):
        for pair in ("tri", "rect"):
            assert (f"__global__ void __launch_bounds__(kWideThreads, 1)\n"
                    f"    flash_bwd_{kernel}_{pair}_wide_kernel(Params p, int d, TC_MAPS)") in bwd
    assert "launch_clusters(wide16_kernel<K>()," in bwd
    assert 'extern "C" int flash_bwd_wide16_clusters(int dq, int tri, int d)' in bwd
    cluster = (KERNELS / "flash_cluster.cuh").read_text()
    assert "template <int W>\nstruct SlabGeo {" in cluster
    assert "template <int W>\nstruct SlabCols {" in cluster


# ------------------------------------------------------------- torch models


def _cluster_columns(d, slab):
    """{cluster index: [(own columns, summed columns) of each CTA]}."""
    n, g, c = flash_fwd.f32_wide_geometry(d, slab)
    return {k: [flash_fwd.f32_wide_columns(d, z, slab) for z in range(k * c, (k + 1) * c)]
            for k in range(g)}


@pytest.mark.parametrize("d", [640, 704, 1024, 2048])
@pytest.mark.parametrize("slab", [128, 256])
def test_the_owned_chunks_partition_the_head(d, slab):
    """The 64-column chunks each cluster's CTAs sum partition [0, d / 64)
    (own columns, then foreign chunks), and the tile's CTAs write every
    column once."""
    written = collections.Counter()
    for ctas in _cluster_columns(d, slab).values():
        chunks = collections.Counter()
        for own, summed in ctas:
            written.update(own)
            assert len(summed) % BOX == 0 and all(col % BOX == 0 for col in summed[::BOX])
            chunks.update(summed[i] // BOX for i in range(0, len(summed), BOX))
        assert set(chunks) == set(range(d // BOX)) and set(chunks.values()) == {1}
    assert set(written) == set(range(d)) and set(written.values()) == {1}


@pytest.mark.parametrize("d", [640, 704, 1024, 2048])
@pytest.mark.parametrize("slab", [128, 256])
def test_partials_summed_in_rank_order_are_the_scores(d, slab):
    """The exchange's sum: each CTA's partial S over its summed columns,
    added in rank order in f32, is S over the whole head within f32
    rounding; the same order gives the same bits."""
    gen = torch.Generator().manual_seed(d + slab)
    q = torch.randn(64, d, generator=gen).bfloat16().float()
    k = torch.randn(64, d, generator=gen).bfloat16().float()
    whole = q.double() @ k.double().T
    for ctas in _cluster_columns(d, slab).values():
        total = torch.zeros(64, 64)
        for _, summed in ctas:
            cols = torch.tensor(summed, dtype=torch.long)
            total = total + q[:, cols] @ k[:, cols].T
        # the other clusters' columns: a tile with g clusters forms the
        # whole sum in each of them
        assert float((total.double() - whole).abs().max()) <= 1e-5 * float(whole.abs().max())


def _xs_at(a, f):
    """flash_bwd.cu's xs_at: the float offset of X[a][4 f .. 4 f + 3]."""
    return (f >> 3) * (64 * 32) + a * 32 + (((f & 7) ^ (a & 7)) << 2)


def _tile16_at(a, f):
    """flash_bwd.cu's tile16_at: the byte offset of a 16-bit tile's (a, 4 f)."""
    return a * 128 + (((f >> 1) ^ (a & 7)) << 4) + ((f & 1) << 3)


@pytest.mark.parametrize("c", [3, 4, 5, 6, 7, 8])
def test_a_rank_writes_its_16_bit_rows_over_f32_rows_only_it_reads(c):
    """The exchange's layout: the f32 tile's float4s and the 16-bit tile's
    8-byte groups each cover their tile once; rank r's rows of the 16-bit
    tile lie over bytes of the f32 tile that only rank r reads, so no rank
    overwrites a partial another still needs (one barrier of the CTA between
    a rank's reads and its stores is enough); every rank's share fits
    kWideXchItems float4s a thread."""
    f32_bytes = collections.Counter(4 * _xs_at(a, f) + b for a in range(64) for f in range(16)
                                    for b in range(16))
    assert set(f32_bytes) == set(range(64 * 64 * 4)) and set(f32_bytes.values()) == {1}
    t16 = collections.Counter(_tile16_at(a, f) + b for a in range(64) for f in range(16)
                              for b in range(8))
    assert set(t16) == set(range(64 * 64 * 2)) and set(t16.values()) == {1}
    # 128-byte swizzle: element (a, col) at row a, 16-byte chunk (col / 8) ^ (a & 7)
    for a in range(64):
        for col in range(0, 64, 4):
            assert _tile16_at(a, col // 4) == a * 128 + (((col // 8) ^ (a % 8)) * 16) + (col % 8) * 2
    reader = {}
    for r in range(c):
        for a in range(64 * r // c, 64 * (r + 1) // c):
            for f in range(16):
                for b in range(16):
                    reader[4 * _xs_at(a, f) + b] = r
            assert ((64 * (r + 1) // c) - (64 * r // c)) * 16 <= 3 * 128
    for r in range(c):
        for a in range(64 * r // c, 64 * (r + 1) // c):
            for f in range(16):
                for b in range(8):
                    assert reader[_tile16_at(a, f) + b] == r, (r, a, f)


def _items(d, slab, z):
    """flash_bwd.cu's WideItems of CTA z: (foreign items, main items)."""
    own, _ = flash_fwd.f32_wide_columns(d, z, slab)
    n, g, c = flash_fwd.f32_wide_geometry(d, slab)
    nf = (len(_cluster_columns(d, slab)[z // c][z % c][1]) - len(own)) // BOX
    if not own:
        return nf, 0
    g0 = min(z * slab, d - slab)
    b_own = (own.start - g0) // BOX
    return nf, slab // BOX // 2 - b_own // 2


@pytest.mark.parametrize("d", list(range(640, 4097, 64)))
def test_the_ring_never_waits_on_an_item_it_has_not_loaded(d):
    """The ring of four stages as the kernels drive it: warp 0 loads items
    in order, after each consumed item up to min(its index + 1, the step's
    first slab item) + 4; a step's slab items stay in use until the next
    step's first item is done. Every item is loaded before it is waited on,
    and no stage is loaded while its last item is in use."""
    ring = 4
    for slab in (128, 256):
        n, g, c = flash_fwd.f32_wide_geometry(d, slab)
        for z in range(g * c):
            nf, nm = _items(d, slab, z)
            ni = nf + nm
            assert ni >= 1 and nm <= 2
            steps = 5
            total = steps * ni
            loaded = min(ring, total)
            busy = set()
            for step in range(steps):
                start = step * ni
                for it in range(ni):
                    idx = start + it
                    assert idx < loaded, (d, slab, z, step, it)
                    if it == 0:
                        busy = set()  # the last step's gradient products are done
                    if it >= nf:
                        busy.add(idx)
                    limit = min(min(idx + 1, start + nf) + ring, total)
                    for new in range(loaded, limit):
                        # its stage's last item is done and not in use
                        assert new - ring not in busy and new - ring < idx + 1
                    loaded = max(loaded, limit)


# --------------------------------------------------------------- on the card


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _docs(s, cuts):
    return [sum(i >= c for c in cuts) for i in range(s)]


CARD_CASES = {  # (b, s, h, h_kv, d, masks): masks None for the triangle pair
    "(1,256,2,640)": (1, 256, 2, 2, 640, None),
    "(1,256,2,1024) h_kv 1": (1, 256, 2, 1, 1024, None),
    "(1,128,2,2048) two clusters": (1, 128, 2, 2, 2048, None),
    "(1,128,2,2304) dQ in two clusters, dK/dV in three": (1, 128, 2, 2, 2304, None),
    "(1,256,2,640) full": (1, 256, 2, 2, 640, (False, None, None)),
    "(1,128,2,2048) full, segments": (1, 128, 2, 2, 2048, (False, None, (50,))),
    "ragged (2,100,4,700) h_kv 2, window 33, segments": (2, 100, 4, 2, 700, (True, 33, (37,))),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, F16])
@pytest.mark.parametrize("name", list(CARD_CASES))
def test_the_cluster_pair_matches_plain(cuda, dtype, name):
    """Both kernels of the pair (the triangle's, or the general one's under
    its masks) against attention_bwd_plain within 2e-2 of the largest
    |gradient|, one launch each; two runs give the same bits."""
    b, s, h, h_kv, d, masks = CARD_CASES[name]
    width = flash_fwd.padded_head_dim(d)
    rng = np.random.default_rng(d + s)

    def make(rows):
        x = torch.from_numpy(rng.standard_normal((rows, s, d)).astype(np.float32))
        return torch.nn.functional.pad(x, (0, width - d)).to("cuda", dtype).contiguous()

    qb, kb, vb = make(b * h), make(b * h_kv), make(b * h_kv)
    scale = None if width == d else 1.0 / math.sqrt(d)
    if masks is None:
        out, lse = flash_fwd.flash_fwd_tri(qb, kb, vb, h, h_kv, sm_scale=scale)
        extra, pair = (), "tri"
        causal, window, seg = True, None, None
    else:
        causal, window, cuts = masks
        seg = None if cuts is None else torch.tensor(
            _docs(s, cuts), dtype=torch.int32, device="cuda").expand(b, s).contiguous()
        out, lse = flash_fwd.flash_fwd_rect(qb, kb, vb, h, h_kv, causal, window=window, seg=seg,
                                            sm_scale=scale)
        extra, pair = (causal, window, seg), "rect"
    dout = torch.nn.functional.pad(
        torch.from_numpy(rng.standard_normal((b * h, s, d)).astype(np.float32)),
        (0, width - d)).to("cuda", dtype).contiguous()
    delta = (dout.float() * out.float()).sum(-1)
    dq_fn = getattr(flash_bwd, f"flash_bwd_dq_{pair}")
    dkv_fn = getattr(flash_bwd, f"flash_bwd_dkv_{pair}")
    before = (dq_fn.launches, dkv_fn.launches)
    runs = [(dq_fn(qb, kb, vb, out, dout, lse, delta, h, h_kv, *extra, sm_scale=scale),
             *dkv_fn(qb, kb, vb, out, dout, lse, delta, h, h_kv, *extra, sm_scale=scale))
            for _ in range(2)]
    want = flash_bwd.attention_bwd_plain(qb, kb, vb, out, lse, dout, h, h_kv, causal, window,
                                         seg, sm_scale=scale)
    torch.cuda.synchronize()
    assert (dq_fn.launches, dkv_fn.launches) == (before[0] + 2, before[1] + 2)
    top = max(float(w.float().abs().max()) for w in want)
    for grad, w, got, again in zip(("dq", "dk", "dv"), want, *runs):
        assert torch.equal(got, again), (grad, "two runs differ")
        assert float((w.float() - got.float()).abs().max()) <= HALF_TOL * top, grad


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, F16])
def test_the_cluster_kernels_are_resident(cuda, dtype):
    """The card holds clusters of each kernel at every cluster size."""
    for d in (640, 704, 1024, 2048):
        for kernel in ("dq", "dkv"):
            for tri in (True, False):
                assert flash_bwd.wide16_active_clusters(dtype, d, kernel, tri) >= 1


# ------------------------------------------- phase 3's rows and its fp16 bar


def test_phase_3_adds_the_cluster_rows():
    """chip_smoke's 16-bit rows past 8 slabs (head dim 2048, two clusters a
    tile) and at phase 19's head dim with 8 kv heads, drawn from a generator
    of their own; the kernel_ab family that times every 16-bit row above
    576."""
    import importlib.util

    import chip_smoke

    rows = chip_smoke.WIDE_CLUSTER_BWD_CASES
    assert any(c["q"] == (1, 1024, 4, 2048) and c["pair"] == "tri" and c["dtype"] == BF16
               for c in rows)
    assert any(c["q"] == (1, 4096, 8, 1024) and c["pair"] == "tri" and "h_kv" not in c
               for c in rows)
    assert any(c["q"] == (1, 4096, 8, 1024) and c.get("causal") is False
               for c in chip_smoke.WIDE_BWD_CASES)
    assert chip_smoke.WIDE_CLUSTER_BWD_SEED not in (chip_smoke.F32_TILE_SEED,)
    assert not set(c["label"] for c in rows) & set(c["label"] for c in chip_smoke.WIDE_BWD_CASES)
    spec = importlib.util.spec_from_file_location(
        "kernel_ab", pathlib.Path(chip_smoke.__file__).parent / "scripts" / "kernel_ab.py")
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    assert ab.FAMILIES["bwd_wide"][1:] == (("dq_ms", "dkv_ms"), "flash_bwd")


def _kernel_like_bwd(q, k, v, out, lse, dout, through=None):
    """(dq, dk, dv) of the triangle, one kv head a q head, rounded as the
    card's kernels round them but summed in another order than
    attention_bwd_plain: S over 64-column chunks in f32, P = exp2(S log2(e)
    / sqrt(d) - lse log2(e)), P rounded to dO's dtype and dS to q's before
    the products. ``through``: P and dS rounded through that dtype first, the
    fault phase 3's fp16 bar is there to catch."""
    qf, kf, vf, dof = (x.float() for x in (q, k, v, dout))
    s_len, d = q.shape[1], q.shape[2]
    scores = sum(qf[..., c:c + 64] @ kf[..., c:c + 64].transpose(1, 2) for c in range(0, d, 64))
    log2e = math.log2(math.e)
    keep = torch.ones(s_len, s_len, dtype=torch.bool).tril()
    p = torch.where(keep, torch.exp2(scores * (log2e / math.sqrt(d)) - lse[..., None] * log2e),
                    0.0)
    delta = (dof * out.float()).sum(-1, keepdim=True)
    ds = p * (dof @ vf.transpose(1, 2) - delta) / math.sqrt(d)
    if through is not None:
        p, ds = p.to(through).float(), ds.to(through).float()
    p, ds = p.to(dout.dtype).float(), ds.to(q.dtype).float()
    return ((ds @ kf).to(q.dtype), (ds.transpose(1, 2) @ qf).to(q.dtype),
            (p.transpose(1, 2) @ dof).to(q.dtype))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("h, s, d", [(2, 256, 128), (2, 128, 64), (8, 128, 64)])
def test_the_fp16_bar_holds_a_right_path_and_fails_one_rounded_through_bf16(seed, h, s, d):
    """Phase 3's hold on an fp16 backward row (chip_smoke.fp16_below_bf16 on
    grid_steps), on the CPU with a stand-in for the kernels: an fp16 pair
    that rounds P and dS to fp16 errs below one step of bf16's grid over all
    elements; one that rounds them through bf16 first errs far above it.
    Against the bf16 twin's own error neither maxima (the old bar, which
    ties at one step) nor RMS errors tell the two apart reliably: both are a
    few one-step differences."""
    import chip_smoke

    rng = np.random.default_rng(seed)
    x = [torch.from_numpy(rng.standard_normal((h, s, d)).astype(np.float32)) for _ in range(4)]
    steps = {}
    for name, dtype, through in (("fp16", F16, None), ("bf16", BF16, None),
                                 ("fp16 through bf16", F16, BF16)):
        # the twin runs on the fp16 inputs rounded to bf16, as phase 3's does
        q, k, v, dout = (t.to(F16).to(dtype) for t in x)
        out, lse = flash_fwd.attention_plain(q, k, v, h, h, True)
        want = flash_bwd.attention_bwd_plain(q, k, v, out, lse, dout, h, h, True)
        steps[name] = chip_smoke.grid_steps(want, _kernel_like_bwd(q, k, v, out, lse, dout,
                                                                   through))
    assert chip_smoke.fp16_below_bf16(steps["fp16"]), steps
    assert steps["fp16"] * 16 < chip_smoke.FP16_STEPS_IN_A_BF16_STEP  # with room to spare
    assert not chip_smoke.fp16_below_bf16(steps["fp16 through bf16"]), steps
    assert steps["fp16 through bf16"] > 2 * chip_smoke.FP16_STEPS_IN_A_BF16_STEP


def test_grid_steps_counts_each_dtypes_own_steps():
    """One step at every element is 1; a step of bf16's grid is 8 of fp16's;
    a value below GRID_FLOOR of the largest counts the steps there; zero
    error is 0, and an all-zero gradient has a finite figure."""
    import chip_smoke

    w = torch.tensor([1.0, -3.0, 2.0 ** -7, 2.0 ** -9], dtype=F16)
    step = torch.tensor([2.0 ** -10, 2.0 ** -9, 2.0 ** -17, 2.0 ** -19])
    assert chip_smoke.grid_steps([w], [w]) == 0.0
    assert chip_smoke.grid_steps([w], [(w.float() + step).to(F16)]) == pytest.approx(1.0)
    assert chip_smoke.grid_steps([w], [(w.float() - 2 * step).to(F16)]) == pytest.approx(2.0)
    # 2^-20 and 0 lie below 3 x 2^-10: fp16's step there (binade 2^-9) is 2^-19
    tiny = torch.tensor([-3.0, 2.0 ** -20, 0.0], dtype=F16)
    moved = (tiny.float() + torch.tensor([0.0, 2.0 ** -19, 2.0 ** -19])).to(F16)
    assert chip_smoke.grid_steps([tiny], [moved]) == pytest.approx((2 / 3) ** 0.5)
    b = torch.tensor([1.0, 2.0], dtype=BF16)
    assert chip_smoke.grid_steps([b.to(F16)], [(b.float() * (1 + 2 ** -7)).to(F16)]) == \
        pytest.approx(8.0)
    zero = torch.zeros(4, dtype=BF16)
    assert math.isfinite(chip_smoke.grid_steps([zero], [zero + 1e-3]))
