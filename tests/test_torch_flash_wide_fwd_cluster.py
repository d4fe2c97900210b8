"""The bf16 and fp16 forward above head dim 576 in thread-block clusters: its
launch plan, the layout constants of ``flash_fwd.cu``, torch models of the
design (the columns each slab CTA sums, the rows each CTA owns in the
exchange, the partial and P buffers behind one cluster barrier a tile pair,
the K and V rings), the port's
``flash_attention`` above 576 against the JAX package on the CPU, and on
the card both kernels (the triangle and the general masks) in both 16-bit
types against ``attention_plain``. The module imports no JAX (its one
parity test imports it inside the test), so its card tests run on a
machine without it:

    python -m pytest tests/test_torch_flash_wide_fwd_cluster.py --noconftest

A q tile's slab CTAs (256 columns of O each) are one cluster of up to 8
(above 8 slabs g = ceil(n / 8) clusters a q tile, which also sum the
64-column chunks none of their CTAs owns). Each CTA keeps its own columns
of Q resident, streams its own columns of K and V and forms a partial S
over them; CTA r owns rows [64 r / c, 64 (r + 1) / c) of the tile pair, adds
every CTA's partial of them through distributed shared memory in rank
order, runs the online softmax there and hands P and the rows' statistics
to every CTA, which runs P.V on its slab. Card tolerances as
``tests/test_torch_kernels.py``: O 2e-2 of max |O|, lse 1e-3; two runs give
the same bits.
"""

import collections
import itertools
import math
import pathlib
import random

import numpy as np
import pytest
import torch

from tpu_operator_torch.kernels import flash_fwd

BF16, F16 = torch.bfloat16, torch.float16
MAX_SMEM = 232_448  # bytes of shared memory a block may use on the H100
H100_SMS = 132
KERNELS = pathlib.Path(flash_fwd.__file__).parent
HALF_TOL, LSE_TOL = 2e-2, 1e-3
DIMS = [640, 704, 1024, 2048, 4096]
BOX = 64
SLAB = flash_fwd.WIDE_SLAB


def _plan(dtype, d, rect=False, bh=16, s=1000):
    if rect:
        return flash_fwd.rect_plan(dtype, bh, s, s, d, H100_SMS, True, 33)
    return flash_fwd.tri_plan(dtype, bh, s, d, H100_SMS)


@pytest.mark.parametrize("dtype", [BF16, F16])
@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("rect", [False, True])
def test_the_forward_plan_is_the_slab_cluster(dtype, d, rect):
    """n = ceil(d / 256) slab CTAs a q tile in g = ceil(n / 8) clusters of c =
    ceil(n / g); one warpgroup a CTA, 64-row q tiles, two stages of each
    ring, the 128-byte swizzle; the shared memory fits a block; bf16 and
    fp16 alike, both masks alike."""
    plan = _plan(dtype, d, rect)
    n = math.ceil(d / SLAB)
    g = math.ceil(n / 8)
    c = math.ceil(n / g)
    assert (plan.slab, plan.cluster, plan.col_split) == (SLAB, c, g * c)
    assert (plan.block_m, plan.threads, plan.stages, plan.swizzle) == (64, 128, 2, 128)
    assert plan.smem_bytes <= MAX_SMEM and plan.grid == (16, 16)
    assert (c, g) == {640: (3, 1), 704: (3, 1), 1024: (4, 1), 2048: (8, 1), 4096: (8, 2)}[d]
    assert flash_fwd.wide_plan(BF16, 16, 1000, d) == flash_fwd.wide_plan(F16, 16, 1000, d)
    if rect:
        assert plan.skips  # a key tile of other documents is never copied


def test_the_forward_layout_by_hand():
    """flash_fwd.cu's wide_smem_bytes reckoned by hand: 1 KiB of slack, the
    resident own Q slab (4 boxes), two stages of 4 K boxes and two of 4 V
    boxes, two 64 x 64 f32 partial-S buffers, two 16-bit 64 x 64 P tiles
    with 64 (correction, running sum) pairs each, and five barriers: 215,080
    bytes, one CTA an SM. The P tiles start on a 1 KiB boundary (the
    128-byte swizzle's atom)."""
    box = 64 * 64 * 2
    want = (1024 + 4 * box + 2 * 4 * box + 2 * 4 * box + 2 * 64 * 64 * 4 + 2 * (box + 64 * 8)
            + 5 * 8)
    assert want == 215_080 and 2 * (want + 1024) > 233_472
    assert (4 * box + 2 * 4 * box + 2 * 4 * box + 2 * 64 * 64 * 4) % 1024 == 0
    for d in DIMS:
        assert _plan(BF16, d).smem_bytes == _plan(F16, d, rect=True).smem_bytes == want


def test_the_forward_constants_match_the_cuda_source():
    fwd = (KERNELS / "flash_fwd.cu").read_text()
    hopper = (KERNELS / "hopper.cuh").read_text()
    assert f"constexpr int kWideSlab = {flash_fwd.WIDE_SLAB};" in fwd
    assert f"constexpr int kWideRing = {flash_fwd.WIDE_RING};" in fwd
    assert f"constexpr int kWideThreads = {flash_fwd.WIDE_THREADS};" in fwd
    assert "constexpr int kWidePartFloats = kRingRows * kRingRows;" in fwd
    assert flash_fwd.WIDE_PART_BYTES == 64 * 64 * 4
    assert f"constexpr int kWideXchItems = {flash_fwd.WIDE_XCH_ITEMS};" in fwd
    assert ("template <typename T, bool TRI>\n__global__ void __launch_bounds__(kWideThreads, 1)\n"
            "    flash_fwd_wide_kernel(Params p, int d,") in fwd
    assert "launch_clusters(flash_fwd_wide_kernel<Elem16, TRI>," in fwd
    assert 'extern "C" int flash_fwd_wide16_clusters(int tri, int d)' in fwd
    # one barrier a tile pair, split (the walk's first arrive before the
    # loop); the joined one stays for its callers; P's stores fenced on the
    # reading side before wgmma reads them
    assert fwd.count("cluster_arrive();") == 2 and fwd.count("cluster_wait();") == 1
    assert fwd.count("fence_proxy_async_cta();") == 1
    assert "__device__ __forceinline__ void fence_proxy_async_cta()" in hopper
    for helper in ("cluster_sync", "cluster_arrive", "cluster_wait"):
        assert f"__device__ __forceinline__ void {helper}()" in hopper
    assert '"barrier.cluster.arrive.release.aligned;\\n" ::: "memory"' in hopper
    assert '"barrier.cluster.wait.acquire.aligned;\\n" ::: "memory"' in hopper
    # the whole-S design is gone: no producer warp, no Q box beside every K box
    for gone in ("kWideVStages", "qk_empty", "qk_full", "__launch_bounds__(128 + 32, 1)\n"
                 "    flash_fwd_wide_kernel"):
        assert gone not in fwd, gone


# ------------------------------------------------------------- torch models


def _columns(d):
    """{cluster: [(own columns, summed columns) of each CTA, in rank order]}."""
    _, g, c = flash_fwd.f32_wide_geometry(d, SLAB)
    return {k: [flash_fwd.f32_wide_columns(d, z, SLAB) for z in range(k * c, (k + 1) * c)]
            for k in range(g)}


def _items(d, z):
    """The kernel's items of CTA z a key tile: [(kind, first column)], the
    foreign chunks (a Q and a K box each), then the own K boxes of its slab
    from its first own box (box b at column g0 + 64 b)."""
    _, _, c = flash_fwd.f32_wide_geometry(d, SLAB)
    own, summed = flash_fwd.f32_wide_columns(d, z, SLAB)
    items = [("foreign", col) for col in summed[len(own)::BOX]]
    if own:
        g0 = min(z * SLAB, d - SLAB)
        b_own = (own.start - g0) // BOX
        items += [("own", g0 + b * BOX) for b in range(b_own, SLAB // BOX)]
    return items


@pytest.mark.parametrize("d", list(range(640, 4097, 64)))
def test_every_cta_sums_its_own_columns_and_the_cluster_each_column_once(d):
    """The K boxes a CTA loads are its own columns (the columns it writes of
    O) and, above 8 slabs, its foreign chunks: no CTA forms S over another
    CTA's columns; each cluster's CTAs sum every column of d once, and the
    tile's CTAs write every column once; every CTA has an item a key tile
    (the kernel's one barrier of the CTA a tile sits after an item)."""
    written = collections.Counter()
    n, _, _ = flash_fwd.f32_wide_geometry(d, SLAB)
    for ctas in _columns(d).values():
        summed = collections.Counter()
        for own, cols in ctas:
            written.update(own)
            summed.update(cols)
        assert set(summed) == set(range(d)) and set(summed.values()) == {1}
    assert set(written) == set(range(d)) and set(written.values()) == {1}
    for z in range(flash_fwd.wide_plan(BF16, 1, 64, d).col_split):
        own, cols = flash_fwd.f32_wide_columns(d, z, SLAB)
        items = _items(d, z)
        assert items, z
        loaded = [col for kind, c0 in items for col in range(c0, c0 + BOX)]
        assert sorted(loaded) == sorted(cols)
        assert [c0 for kind, c0 in items if kind == "own"] == list(own)[::BOX]
        assert (z < n) == bool(own)


def _owned_rows(c):
    """The exchange's rows of each rank of a cluster of c: [64 r / c, 64 (r +
    1) / c) (a0, a1 in flash_fwd.cu)."""
    return [range(64 * r // c, 64 * (r + 1) // c) for r in range(c)]


@pytest.mark.parametrize("d", [640, 704, 1024, 2048, 2304, 4096])
def test_the_owners_rows_summed_in_rank_order_are_the_scores(d):
    """Each CTA's partial S over its own columns and foreign chunks (f32
    products over 64-column boxes); each rank adds its own rows of every
    CTA's partial in rank order: the rows partition the tile, and together
    they are S over the whole head within f32 rounding. Every CTA then reads
    the same P (the owners'), and the same order gives the same bits."""
    gen = torch.Generator().manual_seed(d)
    q = torch.randn(64, d, generator=gen).bfloat16().float()
    k = torch.randn(64, d, generator=gen).bfloat16().float()
    whole = q.double() @ k.double().T
    for ctas in _columns(d).values():
        c = len(ctas)
        rows = _owned_rows(c)
        assert sorted(a for r in rows for a in r) == list(range(64))
        # every rank's share fits kWideXchItems float4s a thread
        assert max(len(r) for r in rows) * 16 <= flash_fwd.WIDE_XCH_ITEMS * 128
        partials = []
        for own, cols in ctas:
            part = torch.zeros(64, 64)
            for c0 in range(0, len(cols), BOX):
                box = torch.tensor(cols[c0:c0 + BOX], dtype=torch.long)
                part = part + q[:, box] @ k[:, box].T
            partials.append(part)

        def exchange():
            total = torch.empty(64, 64)
            for r in rows:  # rank r's rows, every partial in rank order
                acc = torch.zeros(len(r), 64)
                for part in partials:
                    acc = acc + part[r.start:r.stop]
                total[r.start:r.stop] = acc
            return total

        first, again = exchange(), exchange()
        assert torch.equal(first, again)
        assert float((first.double() - whole).abs().max()) <= 1e-5 * float(whole.abs().max())


def _tile16_at(a, f):
    """flash_wide.cuh's tile16_at: the byte offset of a 16-bit tile's (a, 4 f)."""
    return a * 128 + (((f >> 1) ^ (a & 7)) << 4) + ((f & 1) << 3)


def _part_at(a, f):
    """flash_fwd.cu's part_at: the float offset of X[a][4 f .. 4 f + 3]."""
    return a * 64 + ((f & 8) | ((f & 7) ^ (a & 7))) * 4


def test_the_exchange_layouts_cover_their_tiles_without_conflicts():
    """The f32 partial's float4s and the 16-bit P tile's 8-byte groups each
    cover their tile once (P in the 128-byte swizzle of a TMA box, as wgmma
    reads a K-major operand); a warp's stores of its accumulator (rows 16 w +
    lane / 4 and 8 more, columns 8 j + 2 (lane % 4)) and the 16 lanes that
    read one row of the partial each touch every bank group once."""
    f32 = collections.Counter(4 * _part_at(a, f) + b for a in range(64) for f in range(16)
                              for b in range(16))
    assert set(f32) == set(range(64 * 64 * 4)) and set(f32.values()) == {1}
    t16 = collections.Counter(_tile16_at(a, f) + b for a in range(64) for f in range(16)
                              for b in range(8))
    assert set(t16) == set(range(64 * 64 * 2)) and set(t16.values()) == {1}
    for a in range(64):  # a row's 16 float4s: two wavefronts of 8 bank groups
        groups = [_part_at(a, f) // 4 % 8 for f in range(16)]
        assert sorted(groups[:8]) == sorted(groups[8:]) == list(range(8))
    for w in range(4):
        for j in range(8):
            for h in range(2):  # one float2 store of the accumulator by a warp's 32 lanes
                words = [_part_at(16 * w + lane // 4 + 8 * h, 2 * j + (lane % 4) // 2)
                         + 2 * (lane % 4 % 2) for lane in range(32)]
                # 256 bytes over 16 bank pairs, each twice: the fewest wavefronts, two
                assert set(collections.Counter(wd // 2 % 16 for wd in words).values()) == {2}


def _exchange_schedule(c, steps, part_bufs, p_bufs, policy, seed=0):
    """Run c CTAs through ``steps`` tile pairs of the exchange in an order
    ``policy`` picks among the CTAs that may move, as the kernel does: the
    first partial written and an arrive; then per tile n a wait for every
    CTA's arrive of X(n), the owner's reads of its rows of every CTA's
    partial n (buffer n % ``part_bufs``), its P rows of tile n written into
    every CTA (buffer n % ``p_bufs``), partial n + 1 written, the P.V of tile
    n - 1 reading this CTA's P buffer, and an arrive of X(n + 1); after the
    last tile a wait and the last P.V, then the CTA leaves. Returns the
    faults: a read that finds another tile's partial or P rows, or a CTA
    that has left."""
    rng = random.Random(seed)
    program = [("wpart", 0), ("arrive",)]
    for n in range(steps + 1):
        program.append(("wait", n))
        if n < steps:
            program += [("rpart", n), ("wp", n)]
        if n + 1 < steps:
            program.append(("wpart", n + 1))
        if n > 0:
            program.append(("rp", n - 1))
        if n < steps:
            program.append(("arrive",))
    program.append(("exit",))
    arrived = [0] * c
    pc = [0] * c
    part = [[None] * part_bufs for _ in range(c)]
    ptile = [[[None] * c for _ in range(p_bufs)] for _ in range(c)]  # [cta][buffer][owner]
    exited = [False] * c
    faults = []
    while not all(exited):
        ready = [r for r in range(c) if not exited[r] and not (
            program[pc[r]][0] == "wait" and not all(a > program[pc[r]][1] for a in arrived))]
        r = {"low": min, "high": max}.get(policy, lambda xs: rng.choice(xs))(ready)
        op = program[pc[r]]
        if op[0] == "wpart":
            part[r][op[1] % part_bufs] = op[1]
        elif op[0] == "arrive":
            arrived[r] += 1
        elif op[0] == "rpart":
            for other in range(c):
                if exited[other] or part[other][op[1] % part_bufs] != op[1]:
                    faults.append(("partial", r, other, op[1]))
        elif op[0] == "wp":
            for other in range(c):
                if exited[other]:
                    faults.append(("P into a CTA that left", r, other, op[1]))
                ptile[other][op[1] % p_bufs][r] = op[1]
        elif op[0] == "rp":
            if any(x != op[1] for x in ptile[r][op[1] % p_bufs]):
                faults.append(("P", r, op[1]))
        elif op[0] == "exit":
            exited[r] = True
        pc[r] += 1
    return faults


@pytest.mark.parametrize("c", [2, 3, 4, 5, 8])
def test_two_partial_and_two_p_buffers_behind_one_barrier_suffice(c):
    """The exchange's schedule: with two partial buffers and two P tiles, one
    cluster barrier a tile pair and none after the walk, no CTA reads a
    partial or P rows that another has overwritten, or touches a CTA that
    has left, in any order of the CTAs (each one running ahead of the
    others, and seeded random orders). One partial buffer, or one P tile,
    fails."""
    policies = list(enumerate(["low", "high"] + ["random"] * 20))
    for (seed, policy), steps in itertools.product(policies, (1, 2, 5)):
        assert _exchange_schedule(c, steps, 2, 2, policy, seed) == [], (policy, seed, steps)
    assert any(_exchange_schedule(c, 5, 1, 2, policy, seed) for seed, policy in policies)
    assert any(_exchange_schedule(c, 5, 2, 1, policy, seed) for seed, policy in policies)


@pytest.mark.parametrize("d", list(range(640, 4097, 64)))
def test_the_rings_never_wait_on_a_load_not_issued(d):
    """The K ring of two stages and the V ring of two, as the kernel drives
    them: thread 0 loads the first two K items, and after each consumed
    item (every warp done: one barrier of the CTA) the item two on into its
    stage; the partial S runs a tile ahead of the exchange (tiles 0 and 1
    before the walk, tile n + 2 in step n); tile 0's V before the walk and
    tile n + 1's in step n after tile n + 2's items, into the stage whose
    P.V (tile n - 1's) ran earlier in step n. Every load is issued before it
    is waited on, and no stage is loaded while a reader still needs it."""
    ring = flash_fwd.WIDE_RING
    steps = 6
    for z in range(flash_fwd.wide_plan(BF16, 1, 64, d).col_split):
        ni = len(_items(d, z))
        assert ni >= 1
        total = steps * ni
        issued = min(ring, total)
        k_busy = {i % ring: i for i in range(issued)}
        idx = 0

        def s_items(tile):
            nonlocal idx, issued
            if tile >= steps:
                return
            for _ in range(ni):
                assert idx < issued, (d, z, tile, idx)
                assert k_busy.pop(idx % ring) == idx
                for new in range(issued, min(idx + 1 + ring, total)):
                    assert new % ring not in k_busy, (d, z, new)
                    k_busy[new % ring] = new
                    issued = new + 1
                idx += 1

        v_stage = {}  # stage -> the tile whose V it holds, and whether its P.V ran
        def load_v(tile):
            if tile >= steps:
                return
            old = v_stage.get(tile % ring)
            assert old is None or old[1], (d, z, tile)
            v_stage[tile % ring] = [tile, False]

        s_items(0)
        load_v(0)
        s_items(1)
        for n in range(steps + 1):
            if n > 0:  # P.V of tile n - 1
                assert v_stage[(n - 1) % ring][0] == n - 1
                v_stage[(n - 1) % ring][1] = True
            if n == steps:
                break
            s_items(n + 2)
            load_v(n + 1)
        assert idx == total


# ------------------------------------------------- the port against the JAX package


@pytest.mark.parametrize("d", [1024, 2304])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask", ["triangle", "window, segments, gqa", "offsets, sq != sk"])
def test_flash_attention_above_576_matches_the_jax_package(dtype, d, mask):
    """``flash_attention`` and ``flash_attention_with_lse`` at head dims the
    slab clusters take (4 CTAs at 1024; 2304: two clusters of 5, one CTA
    owning no column) against the JAX package on the same numpy inputs, its
    Pallas kernels in interpret mode; on the CPU the port runs the kernels'
    plain versions (the CUDA kernels are held to them below). f32 1e-4,
    bf16 2e-2 of max |out|."""
    import jax.numpy as jnp

    from tpu_operator.workloads import flashattention as jfa
    from tpu_operator_torch.workloads import flashattention as tfa

    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    rng = np.random.default_rng(d + len(mask))
    torch.set_num_threads(1)
    if mask == "offsets, sq != sk":
        shapes = ((1, 64, 2, d), (1, 192, 1, d), (1, 192, 1, d))
        arrays = [rng.standard_normal(shape).astype(np.float32) for shape in shapes]
        kwargs = dict(causal=True, block_q=64, block_k=64, q_start=96, k_start=0)
        want = jfa.flash_attention_with_lse(*(jnp.asarray(a, jd) for a in arrays), **kwargs)
        got = tfa.flash_attention_with_lse(*(torch.from_numpy(a).to(td) for a in arrays),
                                           **kwargs)
        pairs = [(np.asarray(jnp.asarray(w, jnp.float32)), g.float().numpy())
                 for w, g in zip(want, got)]
    else:
        h_kv, kwargs, seg = 2, dict(block_q=64, block_k=64), None
        if mask != "triangle":
            h_kv, kwargs = 1, dict(kwargs, window=40)
            seg = (np.arange(128)[None] >= 72).astype(np.int32)
        arrays = [rng.standard_normal((1, 128, h, d)).astype(np.float32)
                  for h in (2, h_kv, h_kv)]
        want = jfa.flash_attention(*(jnp.asarray(a, jd) for a in arrays),
                                   segment_ids=None if seg is None else jnp.asarray(seg),
                                   **kwargs)
        got = tfa.flash_attention(*(torch.from_numpy(a).to(td) for a in arrays),
                                  segment_ids=None if seg is None else torch.from_numpy(seg),
                                  **kwargs)
        assert got.dtype == td
        pairs = [(np.asarray(jnp.asarray(want, jnp.float32)), got.float().numpy())]
    for w, g in pairs:
        assert w.shape == g.shape
        assert np.array_equal(np.isneginf(w), np.isneginf(g))
        fin = np.isfinite(w)
        top = float(np.max(np.abs(w[fin])))
        bar = 1e-4 if dtype == "float32" else HALF_TOL * top
        assert float(np.max(np.abs(w[fin] - g[fin]))) <= bar, mask


# --------------------------------------------------------------- on the card


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _docs(s, cuts):
    return [sum(i >= c for c in cuts) for i in range(s)]


CARD_CASES = {  # (b, sq, sk, h, h_kv, d, masks): masks None for the triangle kernel
    "(1,256,2,640) h_kv 1": (1, 256, 256, 2, 1, 640, None),
    "(2,130,4,1024) h_kv 2": (2, 130, 130, 4, 2, 1024, None),
    "(1,128,2,2048) one cluster of 8": (1, 128, 128, 2, 2, 2048, None),
    "(1,128,2,2304) two clusters, one CTA owning none": (1, 128, 128, 2, 2, 2304, None),
    "(1,256,2,700) padded": (1, 256, 256, 2, 2, 700, None),
    "(1,256,2,640) full": (1, 256, 256, 2, 2, 640, dict(causal=False)),
    "(2,200,4,1024) h_kv 2, window 33": (2, 200, 200, 4, 2, 1024, dict(causal=True, window=33)),
    "(1,256,2,1024) packed segments": (1, 256, 256, 2, 1, 1024,
                                       dict(causal=True, cuts=(64, 150))),
    "(1,130,2,2304) full, segments": (1, 130, 130, 2, 2, 2304, dict(causal=False, cuts=(50,))),
    "(1,64,2,1024) q_start 100 against 200 keys": (1, 64, 200, 2, 1, 1024,
                                                   dict(causal=True, q_start=100)),
    "(1,100,2,704) fully masked rows (k_start 128)": (1, 100, 100, 2, 2, 704,
                                                      dict(causal=True, k_start=128)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, F16])
@pytest.mark.parametrize("name", list(CARD_CASES))
def test_the_cluster_forward_matches_plain(cuda, dtype, name):
    """Both kernels (the triangle's, or the general one's under its masks)
    against attention_plain: O within 2e-2 of max |O|, lse within 1e-3 (and
    -inf where a row sees no key), one launch each; two runs give the same
    bits."""
    b, sq, sk, h, h_kv, d, masks = CARD_CASES[name]
    width = flash_fwd.padded_head_dim(d)
    rng = np.random.default_rng(d + sq + sk)

    def make(rows, s):
        x = torch.from_numpy(rng.standard_normal((rows, s, d)).astype(np.float32))
        return torch.nn.functional.pad(x, (0, width - d)).to("cuda", dtype).contiguous()

    qb, kb, vb = make(b * h, sq), make(b * h_kv, sk), make(b * h_kv, sk)
    scale = None if width == d else 1.0 / math.sqrt(d)
    if masks is None:
        fn, args = flash_fwd.flash_fwd_tri, {}
        plain_args = dict(causal=True)
    else:
        cuts = masks.get("cuts")
        seg = None if cuts is None else torch.tensor(
            _docs(sk, cuts), dtype=torch.int32, device="cuda").expand(b, sk).contiguous()
        args = dict(causal=masks["causal"], q_start=masks.get("q_start", 0),
                    k_start=masks.get("k_start", 0), window=masks.get("window"), seg=seg)
        fn, plain_args = flash_fwd.flash_fwd_rect, args
    before = fn.launches
    runs = [fn(qb, kb, vb, h, h_kv, **args, sm_scale=scale) for _ in range(2)]
    want, want_lse = flash_fwd.attention_plain(qb, kb, vb, h, h_kv, **plain_args, sm_scale=scale)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    (out, lse), (again, again_lse) = runs
    assert torch.equal(out, again) and torch.equal(lse, again_lse), "two runs differ"
    assert torch.equal(torch.isneginf(lse), torch.isneginf(want_lse))
    fin = torch.isfinite(want_lse)
    if bool(fin.any()):
        assert float((lse[fin] - want_lse[fin]).abs().max()) <= LSE_TOL
    top = max(float(want.float().abs().max()), 1e-30)
    assert float((out.float() - want.float()).abs().max()) <= HALF_TOL * top
    if masks is not None and masks.get("k_start"):
        assert int(torch.isneginf(lse).sum()) > 0  # the case holds rows that see no key
        assert not bool(out[torch.isneginf(lse)].float().abs().max())  # and O = 0 there


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, F16])
def test_the_cluster_forwards_are_resident(cuda, dtype):
    """The card holds clusters of both kernels at every cluster size."""
    for d in (640, 704, 1024, 2048, 2304):
        for tri in (True, False):
            assert flash_fwd.wide_active_clusters(dtype, d, tri) >= 1


# ------------------------------------------------------------ phase 3's rows


def test_phase_3_times_the_packed_and_window_forwards_and_kernel_ab_has_the_family():
    """chip_smoke's general forward at phase 19's packed (1,8192,8,1024) h_kv
    1 in 2 documents and at window 128, from a generator of their own; the
    kernel_ab family that times both 16-bit forwards above 576."""
    import importlib.util

    import chip_smoke

    rows = chip_smoke.WIDE_CLUSTER_FWD_CASES
    assert any(c["q"] == (1, 8192, 8, 1024) and c.get("packed") == 2 and c["h_kv"] == 1
               and c["kernel"] == "flash_fwd_rect" and c["dtype"] == BF16 for c in rows)
    assert any(c["q"] == (1, 8192, 8, 1024) and c.get("window") == 128 and c["h_kv"] == 1
               and c["kernel"] == "flash_fwd_rect" for c in rows)
    assert chip_smoke.WIDE_CLUSTER_FWD_SEED not in (chip_smoke.WIDE_CLUSTER_BWD_SEED,
                                                     chip_smoke.F32_TILE_SEED)
    labels = {c["label"] for c in chip_smoke.WIDE_KERNEL_CASES}
    assert not {c["label"] for c in rows} & labels
    spec = importlib.util.spec_from_file_location(
        "kernel_ab", pathlib.Path(chip_smoke.__file__).parent / "scripts" / "kernel_ab.py")
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    assert ab.FAMILIES["fwd_wide"][1:] == (("ms",), "flash_fwd")
