"""The f32 flash forward pair at head dims 256 and above: the slab CTAs of a
q tile in one thread-block cluster that add their partial scores through
distributed shared memory (``flash_fwd.cu``'s ``flash_fwd_f32_cluster_kernel``,
``kernels/flash_cluster.cuh``). On the CPU: the launch plan at every head
dim the kernels take (slabs, clusters, q tile height, grid, shared memory),
its constants against the CUDA sources, the walks against the plain
version's mask, and ``flash_attention_with_lse`` against the JAX package.
On the card (marked ``cuda``; this file imports JAX only inside its CPU
parity test, so the card tests run where there is no JAX):

    python -m pytest tests/test_torch_flash_f32_fwd.py --noconftest -q -m cuda

every instantiation (the triangle and the general masks, 64- and 16-row q
tiles) against ``attention_plain`` (O 1e-4, lse 1e-3, as
``tests/test_torch_kernels.py``), two runs bit for bit, and a build of the
library with 0 spill bytes.
"""

import collections
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
H100_SMS = 132
KERNELS = pathlib.Path(flash_fwd.__file__).parent
F32_TOL, LSE_TOL = 1e-4, 1e-3
# every head dim the cluster kernels take: the native 256, 512 and 576, every
# multiple of 64 above 576, and padded ones (577 -> 640, 700 -> 704, 1000 -> 1024)
HEAD_DIMS = [256, 512, 576] + list(range(640, 4097, 64)) + [577, 700, 1000]
INSTANTIATIONS = [(tri, rows) for tri in (True, False) for rows in (64, 16)]


@pytest.mark.parametrize("sq", [8, 128])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_the_plan_at_every_head_dim(d, sq):
    """Slabs of 128 columns, one cluster of them up to 8 (d 1024), g =
    ceil(slabs / 8) clusters a tile above; 16-row q tiles for a call of at
    most 16 rows, else 64; grid (q tiles, rows), the slab CTAs on x; shared
    memory inside a block's, the same for both masks."""
    width = flash_fwd.padded_head_dim(d)
    n = math.ceil(width / 128)
    g = math.ceil(n / 8)
    c = math.ceil(n / g)
    rows = 16 if sq <= 16 else 64
    tri = flash_fwd.tri_plan(F32, 6, sq, width, H100_SMS)
    rect = flash_fwd.rect_plan(F32, 6, sq, 64 + sq, width, H100_SMS, True, 33, 64, 0)
    for plan in (tri, rect):
        assert (plan.block_m, plan.threads, plan.swizzle) == (rows, 256, 0)
        assert (plan.col_split, plan.cluster, plan.slab, plan.stages) == (g * c, c, 128, 2)
        assert plan.col_split // plan.cluster == g and 2 <= c <= 8 and g * c >= n
        assert plan.grid == (math.ceil(sq / rows), 6)
        assert plan.smem_bytes == 4 * (rows * 128 + 2 * 2 * 64 * 128 + 64 * 64 + rows * 64
                                       + 4 * rows) <= MAX_SMEM
    assert tri.smem_bytes == (197_632 if rows == 64 else 160_000)
    assert flash_fwd.library_name("flash_fwd", F32, width) == "flash_fwd_wide"
    assert flash_fwd.f32_wide_geometry(width) == (n, g, c)


def test_the_cluster_sizes_of_the_native_head_dims():
    """2 slab CTAs at 256, 4 at 512, 5 at 576 (the last slab from 448, its
    own columns 512-575), 8 at 1024, two clusters of 8 at 2048."""
    for d, want in ((256, (2, 1, 2)), (512, (4, 1, 4)), (576, (5, 1, 5)), (1024, (8, 1, 8)),
                    (1152, (9, 2, 5)), (2048, (16, 2, 8))):
        assert flash_fwd.f32_wide_geometry(d) == want, d
    own, summed = flash_fwd.f32_wide_columns(576, 4)
    assert own == range(512, 576) and summed == list(range(512, 576))
    # below 256 one CTA a q tile: attend's plan at 16 (the base library), the
    # tile kernels' at 32-128 (the wide library, one slab as wide as the head)
    for d in (16, 32, 64, 128):
        plan = flash_fwd.tri_plan(F32, 6, 130, d, H100_SMS)
        assert (plan.col_split, plan.cluster, plan.block_m) == (1, 1, 64), d
        assert plan.slab == (0 if d == 16 else d), d
        assert flash_fwd.library_name("flash_fwd", F32, d) == (
            "flash_fwd" if d == 16 else "flash_fwd_wide"), d


def test_block_m_stays_a_check_and_chooses_nothing():
    """f32 takes 64 as its only tile height; the cluster kernels' height is
    the plan's, from sq."""
    for sq in (1, 16, 17, 300):
        assert flash_fwd.tri_plan(F32, 2, sq, 512, H100_SMS, block_m=64) == \
            flash_fwd.tri_plan(F32, 2, sq, 512, H100_SMS)
    with pytest.raises(ValueError, match="block_m"):
        flash_fwd.tri_plan(F32, 2, 8, 512, H100_SMS, block_m=16)
    assert [flash_fwd.f32_rows(sq) for sq in (1, 8, 16, 17, 64)] == [16, 16, 16, 64, 64]


def test_plan_constants_match_the_cuda_sources():
    fwd = (KERNELS / "flash_fwd.cu").read_text()
    bwd = (KERNELS / "flash_bwd.cu").read_text()
    cluster = (KERNELS / "flash_cluster.cuh").read_text()
    assert "__host__ __device__ constexpr int f32_rows(int sq) { return sq <= 16 ? 16 : " \
           "kF32WideTile; }" in fwd
    # the cluster kernels' head dims, shared with the backward pair
    assert "return d >= 256 && d % kF32WideChunk == 0;" in cluster
    assert "constexpr bool f32_cluster_head_dim(int d)" not in fwd + bwd
    assert flash_fwd.F32_CLUSTER_MIN_D == 256 and flash_fwd.F32_SHORT_ROWS == 16
    # f32_cluster_smem_bytes<BM>, term by term as flash_fwd.f32_cluster_smem
    assert ("return 4 * (BM * kF32WideSlab + kF32WideStages * 2 * kF32WideTile * kF32WideSlab +\n"
            "              kF32WideTile * kF32WideTile + BM * kF32WideTile + 4 * BM);") in fwd
    for name, value in (("Tile", 64), ("Chunk", 64), ("Slab", 128), ("Stages", 2),
                        ("Cluster", 8)):
        assert f"constexpr int kF32Wide{name} = {value};" in cluster
        assert getattr(flash_fwd, f"F32_{name.upper()}") == value
    # one body for both masks and both heights, launched in clusters
    assert "template <bool TRI, int BM>\n__global__ void __launch_bounds__(kF32Threads, 1) " \
           "flash_fwd_f32_cluster_kernel(Params p, int d)" in fwd
    assert "launch_clusters(flash_fwd_f32_cluster_kernel<TRI, BM>," in fwd
    assert "launch_f32_cluster<TRI, kF32WideTile>" in fwd and "launch_f32_cluster<TRI, 16>" in fwd
    # the old f32 forwards are gone: no 16-key tiles, no 256-column slabs, and
    # attend takes f32 at 16 only
    for gone in ("f32_keys", "flash_fwd_wide_f32_kernel", "kF32WideSlab = 256"):
        assert gone not in fwd, gone
    assert ('static_assert(D == 16, "f32 at head dims 32 and above: flash_fwd_wide\'s tile and '
            'cluster kernels");') in fwd
    for d in (256, 512, 576):
        assert not re.search(rf"case {d}: return launch<", fwd), d
    assert not hasattr(flash_fwd, "f32_keys") and not hasattr(flash_fwd, "F32_WIDE_SLAB")
    # the shared helpers live once, in the header both sources include
    for helper in ("struct SlabGeo", "struct SlabCols", "void load_tile(",
                   "int active_clusters(", "int launch_clusters("):
        assert helper in cluster and helper not in fwd + bwd, helper


def _live_pairs(keep, rows, sq, sk):
    """(q tile, key tile) pairs holding a live (row, key) pair: q tiles of
    ``rows`` rows, key tiles of 64."""
    return {(q, k) for q in range(-(-sq // rows)) for k in range(-(-sk // 64))
            if bool(keep[q * rows:(q + 1) * rows, k * 64:(k + 1) * 64].any())}


def _cluster_walks(plan, walk):
    """{(row, q tile): the key tiles its CTAs walk}, checking that every CTA
    of a cluster (the grid's x in the kernel's order: tile x col_split + z)
    computes the same q tile and walks the same key tiles; ``walk(x, y)``:
    the key tiles block (x, y) walks."""
    walks = {}
    for y in range(plan.grid[1]):
        for cl in range(plan.grid[0] * plan.col_split // plan.cluster):
            seen = set()
            for bx in range(cl * plan.cluster, (cl + 1) * plan.cluster):
                x = bx // plan.col_split
                row, tile = plan.cta(x, y)
                seen.add((row, tile, tuple(walk(x, y))))
            assert len(seen) == 1, seen
            row, tile, keys = seen.pop()
            assert walks.setdefault((row, tile), keys) == keys
    return walks


@pytest.mark.parametrize("d", [256, 576, 1152])
@pytest.mark.parametrize("s", [1, 8, 16, 17, 64, 100, 300])
def test_the_triangle_walks_exactly_the_live_pairs(s, d):
    """Every q tile (heaviest first) walks the key tiles from 0 to its last
    row's diagonal, the same in each of its slab CTAs: every live tile pair
    of the causal triangle, no other."""
    plan = flash_fwd.tri_plan(F32, 3, s, d, H100_SMS)
    rows = plan.block_m
    # the kernel's walk: keys 0 to the q tile's last row
    walks = _cluster_walks(plan, lambda x, y: range(
        -(-min(s, (plan.cta(x, y)[1] + 1) * rows) // 64)))
    live = _live_pairs(flash_fwd.keep_mask(1, s, s, 1, True)[0], plan.block_m, s, s)
    assert set(walks) == {(row, q) for row in range(3) for q in range(plan.grid[0])}
    for (row, q), keys in walks.items():
        assert {(q, k) for k in keys} == {(qq, k) for qq, k in live if qq == q}, (row, q)
    if plan.grid[0] > 1:
        assert plan.cta(0, 0)[1] == plan.grid[0] - 1  # the heaviest tile first


def _docs(s, cuts):
    return [sum(i >= c for c in cuts) for i in range(s)]


GENERAL = {  # (sq, sk, causal, window, q_start, k_start, segment cuts)
    "full": (130, 130, False, None, 0, 0, None),
    "window 33": (130, 130, True, 33, 0, 0, None),
    "causal, segments": (300, 300, True, None, 0, 0, (128, 200)),
    "full, segments": (300, 300, False, None, 0, 0, (64, 200)),
    "window 40, one cut": (200, 200, True, 40, 0, 0, (37,)),
    "chunked prefill": (40, 200, True, None, 160, 0, None),
    "serving chunk": (8, 64, True, None, 16, 0, None),
    "serving decode": (1, 64, True, None, 63, 0, None),
    "ring hop": (100, 100, True, None, 100, 0, None),
    "window at offsets": (100, 300, True, 70, 150, 20, None),
    "no key in reach": (64, 64, True, None, 0, 128, None),
    "keys past the band": (16, 200, True, 5, 0, 150, None),
}


@pytest.mark.parametrize("d", [512, 1024])
@pytest.mark.parametrize("name", sorted(GENERAL))
def test_the_general_walks_cover_the_live_pairs(name, d):
    """The general kernel's walk (the band by global position, less a key
    tile whose documents cannot meet the q tile's), the same in each slab
    CTA of a q tile: every tile pair that holds a live (q, k) pair of the
    plain version's mask, and with at most one segment boundary no other; an
    empty walk where no key is in reach."""
    sq, sk, causal, window, q_start, k_start, cuts = GENERAL[name]
    seg = None if cuts is None else torch.tensor(_docs(sk, cuts), dtype=torch.int32)
    plan = flash_fwd.rect_plan(F32, 2, sq, sk, d, H100_SMS, causal, window, q_start, k_start)
    assert plan.block_m == (16 if sq <= 16 else 64)
    walks = _cluster_walks(plan, lambda x, y: [k for _, k, _ in plan.visits(x, y, seg)])
    keep = flash_fwd.keep_mask(1, sq, sk, 1, causal, q_start, k_start, window,
                               None if seg is None else seg[None])[0]
    live = _live_pairs(keep, plan.block_m, sq, sk)
    walked = {(q, k) for (_, q), keys in walks.items() for k in keys}
    assert live <= walked
    if cuts is None or len(cuts) <= 1:
        assert walked == live
    if name == "no key in reach":
        assert walked == set()


def test_flash_attention_with_lse_matches_the_reference_at_offsets():
    """flash_attention_with_lse in f32 at head dims 512 and 1024 with a
    q_start (a chunked prefill: 32 rows against 128 keys, and serving's
    8-row chunk), against the JAX package on the same numpy inputs; on the
    CPU the port's wrappers run the plain version (the routing, the slicing
    and the lse are what this holds)."""
    import jax.numpy as jnp

    from tpu_operator.workloads import flashattention as jfa

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for d in (512, 1024):
            for sq, sk, q_start in ((32, 128, 96), (8, 64, 16)):
                rng = np.random.default_rng(d + sq)
                arrays = [rng.standard_normal(shape).astype(np.float32)
                          for shape in ((1, sq, 2, d), (1, sk, 1, d), (1, sk, 1, d))]
                kwargs = dict(causal=True, block_q=64, block_k=64, q_start=q_start, k_start=0)
                want = jfa.flash_attention_with_lse(*(jnp.asarray(a) for a in arrays), **kwargs)
                got = tfa.flash_attention_with_lse(*(torch.from_numpy(a) for a in arrays),
                                                   **kwargs)
                for w, g in zip(want, got):
                    w = np.asarray(w)
                    assert w.shape == tuple(g.shape) and g.dtype == torch.float32
                    assert np.array_equal(np.isneginf(w), np.isneginf(g.numpy()))
                    fin = np.isfinite(w)
                    assert float(np.max(np.abs(w[fin] - g.numpy()[fin]))) <= F32_TOL, (d, sq)
    finally:
        torch.set_num_threads(before)


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
def test_the_cluster_kernels_build_without_spills(cuda):
    """The flash_fwd_wide library holds the four instantiations (the
    triangle and the general masks at 64- and 16-row q tiles), each with 0
    spill bytes; every one places a cluster at every slab count."""
    import chip_smoke

    lib, _ = build.build(["flash_fwd_wide"])["flash_fwd_wide"]
    report = chip_smoke.ptxas_by_function(lib.with_suffix(".log").read_text())
    found = {}
    for mangled, stats in report.items():
        hit = re.search(r"flash_fwd_f32_cluster_kernelILb([01])ELi(\d+)E", mangled)
        if hit:
            found[(hit.group(1) == "1", int(hit.group(2)))] = stats
    assert sorted(found) == sorted(INSTANTIATIONS), found
    for key, stats in found.items():
        assert stats["spill_stores"] == 0 and stats["spill_loads"] == 0, (key, stats)
        assert stats["registers"] <= 255, (key, stats)
    for d in (256, 512, 576, 1024, 2048):
        for tri, rows in INSTANTIATIONS:
            assert flash_fwd.f32_active_clusters(d, tri, rows) > 0, (d, tri, rows)


TRI_SHAPES = [  # (b, s, h, h_kv, d)
    (2, 130, 4, 2, 256), (1, 200, 2, 1, 512), (2, 100, 4, 2, 576), (1, 8, 2, 1, 576),
    (1, 64, 2, 2, 700), (2, 130, 4, 2, 1024), (1, 16, 2, 1, 1024), (1, 100, 2, 1, 2048)]


@pytest.mark.cuda
@pytest.mark.parametrize("b, s, h, h_kv, d", TRI_SHAPES)
def test_the_triangle_matches_plain(cuda, b, s, h, h_kv, d):
    """The triangle forward (64-row tiles, and 16-row at s <= 16) against
    attention_plain, one launch each, GQA, ragged lengths, a padded head."""
    qb, kb, vb, scale = _qkv(d + s, b, s, s, h, h_kv, d)
    before = flash_fwd.flash_fwd_tri.launches
    out, lse = flash_fwd.flash_fwd_tri(qb, kb, vb, h, h_kv, sm_scale=scale)
    want, want_lse = flash_fwd.attention_plain(qb, kb, vb, h, h_kv, True, sm_scale=scale)
    torch.cuda.synchronize()
    assert flash_fwd.flash_fwd_tri.launches == before + 1
    assert _err(want, out) <= F32_TOL and _err(want_lse, lse) <= LSE_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("d", [256, 512, 576, 700, 1024, 2048])
def test_the_general_kernel_matches_plain(cuda, d):
    """The general forward under every mask of GENERAL (full, windows,
    segments, offsets, sq != sk, serving's chunk and decode at 16-row tiles,
    rows that see no key), GQA 2, against attention_plain."""
    for name, (sq, sk, causal, window, q0, k0, cuts) in GENERAL.items():
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
        assert _err(want, out) <= F32_TOL and _err(want_lse, lse) <= LSE_TOL, (name, d)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [576, 1024, 2048])
def test_two_runs_give_the_same_bits(cuda, d):
    """The clusters add their partial scores in rank order and no atomics:
    each instantiation twice on the same inputs gives the same bits."""
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


def test_a_cluster_is_one_tile():
    """The CTAs of a cluster are consecutive on the grid's x and never
    straddle two q tiles: the cluster divides a tile's CTAs."""
    counts = collections.Counter()
    for d in HEAD_DIMS:
        plan = flash_fwd.tri_plan(F32, 1, 100, flash_fwd.padded_head_dim(d), H100_SMS)
        assert plan.col_split % plan.cluster == 0, d
        counts[plan.cluster] += 1
    assert set(counts) == {2, 4, 5, 6, 7, 8}
