"""Wrappers of the two flash-attention forward kernels (``flash_fwd.cu``)
and their plain PyTorch version.

Layout is the JAX package's collapsed one: q (B·H, Sq, D), k/v
(B·H_kv, Sk, D); outputs O (B·H, Sq, D) in q's dtype and the natural-log
logsumexp (B·H, Sq) in float32. A q row i reads kv row
``(i // H) * H_kv + (i % H) // (H // H_kv)`` (grouped-query attention).

The device of the tensors chooses the code: a CUDA tensor launches the
kernel (or raises), a CPU tensor runs :func:`attention_plain`. Each
wrapper counts the kernel launches it makes in ``<wrapper>.launches``.
In bf16 and fp16 both kernels run on the tensor cores (wgmma, TMA: q, k,
v and out need 16-byte-aligned bases) with the launch plans of
:func:`tri_plan` and :func:`rect_plan`, the same for both 16-bit types;
f32 runs on the CUDA cores. fp16 has a library of its own
(``build.VARIANTS``), built at the first fp16 call; so have head dims 512
(``flash_fwd_d512``, ``flash_fwd_f16_d512``) and 576 (``flash_fwd_d576``,
``flash_fwd_f16_d576``), each built at the first call there.

The kernels take the head dims ``NATIVE_HEAD_DIMS`` (16 to 576) and every
multiple of 64 above 576; a caller with another head dim zero-pads the head
to :func:`padded_head_dim` and passes the true head dim's softmax scale as
``sm_scale`` (``workloads/flashattention.py`` does both). At 256 the 16-bit
forwards run 128-row CTAs of two consumer warpgroups that share each K and
V tile (:func:`rows_smem`). At 512 two CTAs share each q tile, one on each
column half of O, at 576 (MLA's absorbed heads) three, one on each
column third (:func:`col_split`). Above 576 the D-streaming ("wide") kernels run (libraries ``flash_fwd_wide``,
``flash_fwd_f16_wide``, built at the first call there): the three 64-row
tiles of a 640-wide head alone would pass a block's shared memory, so
each CTA holds one 256-column slab of O and the slab CTAs of a q tile form
one thread-block cluster: each keeps its own columns of Q resident, streams
only its own columns of K and V, and the cluster adds the partial scores
over those columns through distributed shared memory, each CTA the rows it
owns, and hands P back to every CTA (:func:`wide_plan`); the head dim is a
runtime argument, so one build serves every width. f32 at head dims 256
and above runs in that library too (:func:`f32_cluster_plan`): the
128-column slab CTAs of a q tile form one thread-block cluster that adds
their partial scores through distributed shared memory; and f32 at 32, 64
and 128 (:func:`f32_tile_plan`): the same design at one CTA a tile, the
head whole in one slab. f32 at 16 keeps the first port's whole-row kernels
in ``flash_fwd`` (``F32_WHOLE_ROW_D``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import List, Optional, Sequence, Tuple

import torch

from tpu_operator_torch.kernels import build

# the kernels' dtypes and their codes in the C entries (f32 and bf16 in the
# library flash_fwd, fp16 in flash_fwd_f16)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the dtypes the tensor-core kernels take: 16 bits each, so one layout, one
# plan and one TMA alignment serve both
TENSOR_CORE_DTYPES = (torch.bfloat16, torch.float16)
# the head dims whose 16-bit kernels take both tile heights (64 and 128 rows)
HEAD_DIMS = (16, 32, 64, 128)
# every head dim the kernels take: D 256, 512 and 576 with the knob's 64
# rows only (their 128-row tiles would not fit a block's shared memory or a
# thread's registers; the D 256 forwards run 128-row CTAs of their own)
NATIVE_HEAD_DIMS = HEAD_DIMS + (256, 512, 576)
MAX_HEAD_DIM = NATIVE_HEAD_DIMS[-1]  # the widest head of the whole-row kernels
WIDE_BOX = 64  # above MAX_HEAD_DIM: columns of a streamed chunk (kWideBox in flash_wide.cuh)
LOG2E = 1.4426950408889634
TMA_ALIGN = 16  # bytes: base alignment a TMA tensor map needs


def padded_head_dim(d: int) -> int:
    """The head dim the kernels run a head of ``d`` columns at, zero-padded,
    which changes neither q·k, nor lse, nor rowsum(dO∘O): the smallest of
    ``NATIVE_HEAD_DIMS`` that holds ``d``, or above ``MAX_HEAD_DIM`` the
    next multiple of 64 (the wide kernels' chunk). Raises ``ValueError``
    for ``d`` < 1 and for a bool."""
    if isinstance(d, bool) or not d >= 1:
        raise ValueError(f"head_dim must be a positive int, got {d!r}")
    if d > MAX_HEAD_DIM:
        return -(-int(d) // WIDE_BOX) * WIDE_BOX
    return next(n for n in NATIVE_HEAD_DIMS if n >= d)


def is_wide(d: int) -> bool:
    """Whether head dim ``d`` (padded) runs on the D-streaming kernels."""
    return d > MAX_HEAD_DIM


def col_split(d: int) -> int:
    """CTAs that share each tile of a 16-bit kernel at head dim ``d``, one
    per column slice of its outputs, on the grid's z: 2 at d 512 (O, dQ,
    dK and dV for 64 rows would pass a thread's registers, and wgmma's N
    stops at 256), 3 at d 576 (halves of 288 columns would pass that N;
    thirds are 192 columns, three 64-column boxes), else 1 (col_split in
    flash_fwd.cu and flash_bwd.cu)."""
    return 3 if d > 512 else 2 if d > 256 else 1


def ring_stages(d: int) -> int:
    """Ring depth of the 16-bit kernels at head dim ``d``: ``TRI_STAGES``,
    or one stage at d 512 and 576, where the CTA's own tiles and a second
    stage would pass a block's shared memory (stages in flash_fwd.cu and
    flash_bwd.cu)."""
    return 1 if d > 256 else TRI_STAGES


def kv_row(i, heads: int, kv_heads: int):
    """Collapsed-row mapping for grouped-query attention: q row i (of
    B·heads) reads kv row (of B·kv_heads) — query heads share KV heads in
    groups of heads // kv_heads. The kernels compute the same map."""
    group = heads // kv_heads
    return (i // heads) * kv_heads + (i % heads) // group


def keep_mask(bh: int, sq: int, sk: int, heads: int, causal: bool,
              q_start: int = 0, k_start: int = 0, window: Optional[int] = None,
              seg: Optional[torch.Tensor] = None, device=None) -> torch.Tensor:
    """The (q, k) pairs the kernels attend, as a bool (1 or bh, sq, sk)
    mask: causal on global positions (``q_start + i >= k_start + j``),
    the window ``0 <= q - k < window`` (causal only), and segment ids
    ``seg`` (B, S) shared by a batch's heads."""
    keep = torch.ones((1, sq, sk), dtype=torch.bool, device=device)
    if causal:
        dist = (q_start + torch.arange(sq, device=device))[:, None] - (
            k_start + torch.arange(sk, device=device))[None, :]
        keep = (dist >= 0)[None]
        if window is not None:
            keep = keep & (dist < window)[None]
    if seg is not None:
        sb = seg[torch.arange(bh, device=device) // heads]  # (bh, S)
        keep = keep & (sb[:, :, None] == sb[:, None, :])
    return keep


def attention_plain(qb, kb, vb, heads: int, kv_heads: int, causal: bool,
                    q_start: int = 0, k_start: int = 0,
                    window: Optional[int] = None,
                    seg: Optional[torch.Tensor] = None,
                    sm_scale: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense masked float32 softmax attention with the kernels' masking
    (:func:`keep_mask`), GQA, and fully masked rows giving O = 0 and
    lse = -inf; scores scaled by ``sm_scale`` (default 1/√d). Returns (O in
    q's dtype, lse float32)."""
    bh, sq, d = qb.shape
    sk = kb.shape[1]
    kv = kv_row(torch.arange(bh, device=qb.device), heads, kv_heads)
    k = kb.float()[kv]
    v = vb.float()[kv]
    scale = 1.0 / math.sqrt(d) if sm_scale is None else sm_scale
    s = torch.einsum("bqd,bkd->bqk", qb.float(), k) * scale
    keep = keep_mask(bh, sq, sk, heads, causal, q_start, k_start, window, seg, qb.device)
    s = s.masked_fill(~keep, -math.inf)
    lse = torch.logsumexp(s, dim=-1)
    live = torch.isfinite(lse)[..., None]
    p = torch.where(live, torch.exp(s - torch.where(live, lse[..., None], 0.0)), 0.0)
    out = torch.einsum("bqk,bkd->bqd", p, v)
    return out.to(qb.dtype), lse


@dataclasses.dataclass(frozen=True)
class TriPlan:
    """Launch plan of the triangle kernel: ``block_m`` q rows per CTA and
    as many keys per k tile, ``threads`` per CTA, ``grid`` (x, y), dynamic
    shared memory in bytes, the TMA/wgmma swizzle span in bytes (0: the
    f32 CUDA-core kernels, which use no TMA), and ``col_split``, the
    grid's z (the f32 cluster kernels: a factor of the grid's x): the CTAs
    per q tile, each on a column slice of O (:func:`col_split`; the wide
    and cluster kernels' slabs). The wide and cluster kernels' plans also
    state ``slab``, the columns of O a CTA holds, and ``stages``, the depth
    of the ring the chunks of the head dim (f32: the slabs) stream through
    (0 and 0 at head dims up to 576), and the cluster kernels ``cluster``,
    the CTAs of a thread-block cluster that share each tile pair's scores
    (1 elsewhere)."""

    block_m: int
    threads: int
    grid: Tuple[int, int]
    smem_bytes: int
    swizzle: int
    col_split: int = 1
    slab: int = 0
    stages: int = 0
    cluster: int = 1

    def cta(self, x: int, y: int) -> Tuple[int, int]:
        """The (bh row, q tile) that block (x, y) computes, as the kernel
        maps it (the cluster kernels: each of the ``col_split`` CTAs of
        tile x; the f32 tile kernels and the 16-bit clusters above 576
        tile-major, :func:`tile_major`)."""
        if self.swizzle and self.slab:  # the 16-bit wide kernels' clusters, tile-major
            return tile_major(x, y, *self.grid, heaviest_first=True)
        if self.swizzle:
            return x, self.grid[1] - 1 - y  # heaviest q tiles first
        if self.cluster > 1:
            return y, self.grid[0] - 1 - x  # heaviest q tiles first
        if self.slab:
            return tile_major(x, y, *self.grid, heaviest_first=True)
        return y, x


def tile_major(x: int, y: int, tiles: int, rows: int,
               heaviest_first: bool) -> Tuple[int, int]:
    """The (row, tile) that block (x, y) of a grid (tiles, rows) walks when
    its CTAs run tile-major (``cluster_slot`` in flash_cluster.cuh, at one
    CTA a tile): the n-th block takes tile n // rows of row n % rows, the
    last tile first with ``heaviest_first`` (a plain causal mask's
    longest walk)."""
    n = x + tiles * y
    rank = n // rows
    return n % rows, (tiles - 1 - rank if heaviest_first else rank)


TRI_STAGES = 2  # K/V ring depth of the 16-bit kernel (kStages in flash_fwd.cu)
# D 256's 16-bit forwards (rows_body in flash_fwd.cu): 128-row CTAs of two
# consumer warpgroups and a producer warpgroup, 64-key K and V ring tiles
# under both masks
ROWS_HEAD_DIM = 256  # kRowsHeadDim
ROWS_BM = 128        # kRowsBM
ROWS_THREADS = 384   # kRowsThreads
# the q-tile heights (rows) a plan may take per (dtype, native head dim):
# bf16 and fp16 one or two consumer warpgroups, one only at D 256, 512 and
# 576 (at D 256 the backward pairs' height: the forwards' CTAs hold 128
# rows whatever the knob says, ROWS_BM); f32 its CUDA-core kernels' fixed
# 64 (the knob of the forward, which from D 32 on takes 16 rows for a call
# of at most 16, f32_rows; the f32 backward takes 64 rows at every head dim)
TILE_HEIGHTS = {
    **{(t, d): (64, 128) for t in TENSOR_CORE_DTYPES for d in HEAD_DIMS},
    **{(t, d): (64,) for t in TENSOR_CORE_DTYPES for d in (256, 512, 576)},
    **{(torch.float32, d): (64,) for d in NATIVE_HEAD_DIMS},
}


def tile_heights(dtype: torch.dtype, d: Optional[int] = None) -> Tuple[int, ...]:
    """The tile heights the kernels of ``dtype`` take at head dim ``d``
    (padded to a native one; above 576 the wide kernels' 64 rows only); with
    no ``d``, at any head dim. A dtype no kernel takes answers as bf16 does,
    so that its error is the dtype's."""
    if dtype not in _DTYPES:
        dtype = torch.bfloat16
    if d is None:
        return tuple(sorted({h for (t, _), hs in TILE_HEIGHTS.items() if t == dtype for h in hs}))
    width = padded_head_dim(d)
    return (64,) if is_wide(width) else TILE_HEIGHTS[dtype, width]


def check_block_m(dtype: torch.dtype, block_m: Optional[int], d: Optional[int] = None) -> None:
    """Raise ``ValueError`` unless ``block_m`` is None (the plan chooses) or
    a tile height the kernels of ``dtype`` take at head dim ``d``
    (:func:`tile_heights`; any head dim when ``d`` is None)."""
    allowed = tile_heights(dtype, d)
    if block_m is not None and (isinstance(block_m, bool) or block_m not in allowed):
        at = "" if d is None else f" at head_dim {d}"
        raise ValueError(f"block_m must be one of {allowed} for {dtype}{at}, got {block_m!r}")


def _tile_height(rows: int, s: int, sms: int, block_m: Optional[int],
                 heights: Tuple[int, ...]) -> int:
    """``block_m`` when forced, else 128 (when ``heights`` has it) once
    ``rows`` x 128-row tiles of s fill one wave of CTAs on ``sms`` streaming
    multiprocessors, else 64."""
    if block_m is not None:
        return int(block_m)
    return 128 if 128 in heights and rows * -(-s // 128) >= sms else 64


def tri_plan(dtype: torch.dtype, bh: int, s: int, d: int, sms: int,
             block_m: Optional[int] = None) -> TriPlan:
    """How ``flash_fwd_tri`` launches for (bh rows, s tokens, head dim d).

    bf16 and fp16 run the tensor-core kernel (one plan for both 16-bit
    types): q tiles of 128 rows (two consumer warpgroups) once they fill
    one wave of CTAs on the card's ``sms``
    streaming multiprocessors, else 64 rows (one warpgroup), so that small
    grids keep more CTAs — or the height ``block_m`` forces (64 or 128;
    threads, grid and shared memory follow from it); plus one producer warp; grid (bh, q tiles) with
    the q tiles walked heaviest first; shared memory for the Q tile and
    ``TRI_STAGES`` K and V tiles, 1 KiB of alignment slack and five
    mbarriers; the swizzle span of a row of one TMA box (32 B at d 16, 64 B
    at d 32, 128 B at d 64 and wider). At d 256 a CTA holds ``ROWS_BM``
    rows, two consumer warpgroups and a producer warpgroup
    (``ROWS_THREADS``), and walks 64-key K and V tiles; ``block_m`` 64 is
    accepted and chooses nothing; shared memory :func:`rows_smem`. At d
    512 and 576 the tile is 64 rows (``TILE_HEIGHTS``), the ring has one
    stage (:func:`ring_stages`) and two (512) or three (576) CTAs share each q
    tile, one per column slice of O (``col_split``, the grid's z). f32
    keeps the whole-row kernel's fixed plan at d 16 (``block_m`` 64 only;
    its grid's y runs over the bh rows, which the kernel splits into z
    slices of 65,535), the tile kernels' at 32, 64 and 128
    (:func:`f32_tile_plan`) and the cluster kernels' at 256 and above
    (:func:`f32_cluster_plan`); at those ``block_m`` 64 is accepted and
    chooses nothing. Any other ``block_m`` raises ``ValueError``. The
    kernel checks the plan against its own layout and refuses one that
    differs."""
    check_block_m(dtype, block_m, d)
    if dtype == torch.float32 and d in F32_TILE_HEAD_DIMS:
        return f32_tile_plan(bh, s, d)
    if dtype == torch.float32 and d >= F32_CLUSTER_MIN_D:
        return f32_cluster_plan(bh, s, d)
    if is_wide(d):
        return wide_plan(dtype, bh, s, d)
    if dtype == torch.float32:
        smem = 4 * ((64 + 2 * 64) * (d + 1) + 64 * 65) + 4 * 64
        return TriPlan(64, 256, (-(-s // 64), bh), smem, 0)
    if d == ROWS_HEAD_DIM:
        return TriPlan(ROWS_BM, ROWS_THREADS, (bh, -(-s // ROWS_BM)), rows_smem(True), 128)
    block = _tile_height(bh, s, sms, block_m, tile_heights(dtype, d))
    stages = ring_stages(d)
    smem = 1024 + (block + 2 * stages * block) * d * 2 + 8 * (2 * stages + 1)
    return TriPlan(block, 128 * (block // 64) + 32, (bh, -(-s // block)), smem, 2 * min(d, 64),
                   col_split(d))


def rows_smem(tri: bool) -> int:
    """Shared memory of a D 256 forward CTA (rows_smem_bytes in
    flash_fwd.cu): 1 KiB of alignment slack, the 128-row Q tile,
    ``TRI_STAGES`` 64-key K and V tiles, the general kernel's staged segment
    ids (64 int32 a stage) and nine mbarriers (K and V full and empty a
    stage, and Q's)."""
    return (1024 + (ROWS_BM + 2 * TRI_STAGES * RECT_TILE) * ROWS_HEAD_DIM * 2
            + (0 if tri else TRI_STAGES * RECT_TILE * 4) + 8 * (4 * TRI_STAGES + 1))


# the D-streaming forward's layout above MAX_HEAD_DIM (flash_fwd.cu, built
# with -DFLASH_HEAD_DIM_WIDE)
WIDE_SLAB = 256       # columns of O a 16-bit CTA holds: wgmma's widest N (kWideSlab)
WIDE_RING = 2         # stages of the K ring and of the V ring, a slab's boxes each (kWideRing)
WIDE_THREADS = 128    # one warpgroup a 16-bit CTA (kWideThreads)
WIDE_BOX_BYTES = WIDE_BOX * WIDE_BOX * 2  # a 64 x 64 box of 16-bit values (kWideBoxBytes)
WIDE_PART_BYTES = 64 * 64 * 4  # a partial S, 64 x 64 f32 (kWidePartFloats floats)
WIDE_XCH_ITEMS = 3  # float4s of the partials an owner thread sums (kWideXchItems)


def wide_slabs(d: int, width: int) -> int:
    """Column slabs of ``width`` over head dim ``d``: one CTA each on the
    grid's z; the last starts at d - width, so that every CTA runs the same
    product, and writes only the columns no earlier slab owns."""
    return -(-d // width)


def wide_plan(dtype: torch.dtype, bh: int, s: int, d: int) -> TriPlan:
    """How both 16-bit forwards launch at a head dim ``d`` above
    ``MAX_HEAD_DIM`` (a multiple of 64): q tiles of 64 rows, one warpgroup a
    CTA (``WIDE_THREADS``), and ``col_split`` CTAs a q tile, one per slab of
    ``slab`` (``WIDE_SLAB``) columns of O, in thread-block clusters of
    ``cluster`` (:func:`f32_wide_geometry` at that slab: 3 CTAs at 640 and
    704, 4 at 1024, 8 at 2048, above that g = ⌈n / 8⌉ clusters a q tile).
    A CTA keeps its own columns of the q tile's Q resident and streams only
    its own columns of K and V by TMA, in 64 x 64 boxes, through two rings
    of ``stages`` (``WIDE_RING``) slabs; above 8 slabs each cluster also
    sums the 64-column chunks none of its CTAs owns (a Q and a K box an
    item, :func:`f32_wide_columns`). Per key tile each CTA forms a partial S
    over its columns; CTA r of the cluster owns rows [64 r / c, 64 (r + 1) /
    c): it adds every CTA's partial of them through distributed shared
    memory in rank order, runs the online softmax there and stores P and
    the rows' statistics into every CTA, which runs P·V on its slab. S is
    formed once per cluster (a design in which every slab CTA formed the
    whole S did ``(slabs + 1) / 2`` times the ideal tensor-core work).
    Shared memory: 1 KiB of alignment slack, the resident Q slab, both
    rings, two 64 x 64 f32 partial buffers, two 16-bit P tiles with their
    rows' (correction, sum) and the barriers, the same for both masks (every
    warp reads the segment ids itself). Grid (q tiles, bh) with
    ``col_split`` CTAs a q tile on x, walked tile-major, the triangle's
    heaviest q tiles first (:meth:`TriPlan.cta`); the 128-byte swizzle.
    (f32 there: :func:`f32_cluster_plan`.)"""
    _, g, c = f32_wide_geometry(d, WIDE_SLAB)
    smem = (1024 + (1 + 2 * WIDE_RING) * (WIDE_SLAB // WIDE_BOX) * WIDE_BOX_BYTES
            + 2 * WIDE_PART_BYTES + 2 * (WIDE_BOX_BYTES + 64 * 8) + 8 * (2 * WIDE_RING + 1))
    return TriPlan(64, WIDE_THREADS, (-(-s // 64), bh), smem, 128, g * c, WIDE_SLAB, WIDE_RING,
                   c)


# the f32 cluster kernels' layout at head dims 256 and above (flash_cluster.cuh;
# both sources built with -DFLASH_HEAD_DIM_WIDE)
F32_CLUSTER_MIN_D = 256  # the least head dim of the f32 cluster kernels (f32_cluster_head_dim)
F32_TILE = 64        # q rows and keys of an f32 tile (kF32WideTile)
F32_CHUNK = 64       # columns of an f32 foreign chunk (kF32WideChunk)
F32_SLAB = 128       # columns of each output an f32 CTA holds (kF32WideSlab)
F32_STAGES = 2       # stages of the f32 streamed ring (kF32WideStages)
F32_CLUSTER = 8      # the most CTAs of an f32 cluster, the portable limit (kF32WideCluster)
F32_SHORT_ROWS = 16  # the q rows of an f32 forward CTA for a call of at most 16


def f32_wide_geometry(d: int, slab: int = F32_SLAB) -> Tuple[int, int, int]:
    """(n, g, c) of the f32 cluster kernels at head dim ``d``
    (flash_cluster.cuh's ``SlabGeo``): n slabs of ``slab`` columns
    (``F32_SLAB``; the 16-bit backward pair above 576 takes its own), the
    last starting at d - slab, in g clusters of c CTAs a tile (c at most
    ``F32_CLUSTER``: one cluster up to n = 8, d 1024 in f32); the grid holds
    g·c CTAs a tile, those past the n-th writing nothing. Each cluster forms
    a tile pair's scores once, so they are formed g times per tile pair."""
    n = wide_slabs(d, slab)
    g = -(-n // F32_CLUSTER)
    return n, g, -(-n // g)


def f32_wide_columns(d: int, z: int, slab: int = F32_SLAB) -> Tuple[range, List[int]]:
    """The columns CTA ``z`` of a tile writes (its slab's own: the write
    rule, none past the n-th slab) and the columns it sums into its partial
    scores (flash_cluster.cuh's ``SlabCols``): its own, and every c-th of
    the 64-column chunks its cluster writes none of, from its rank on; so
    the CTAs of one cluster sum each column of ``d`` once. ``slab`` as
    :func:`f32_wide_geometry`'s."""
    _, _, c = f32_wide_geometry(d, slab)
    rank = z % c
    own = range(min(z * slab, d), min(z * slab + slab, d))
    first = (z - rank) * slab
    cluster = range(first, min(first + c * slab, d))
    foreign = [c0 for c0 in range(0, d, F32_CHUNK) if c0 not in cluster]
    summed = list(own) + [col for c0 in foreign[rank::c] for col in range(c0, c0 + F32_CHUNK)]
    return own, summed


def f32_rows(sq: int) -> int:
    """The q rows of an f32 forward CTA at head dims 256 and above: 64, or
    ``F32_SHORT_ROWS`` for a call of at most 16 q rows (serving's prefill
    chunk, which would leave most of 64 rows dead); chosen from ``sq``, not
    a knob (f32_rows in flash_fwd.cu)."""
    return F32_SHORT_ROWS if sq <= F32_SHORT_ROWS else F32_TILE


def f32_cluster_smem(block_m: int) -> int:
    """Shared memory of an f32 forward cluster CTA of ``block_m`` q rows
    (f32_cluster_smem_bytes in flash_fwd.cu): its Q slab, two stages of the
    streamed K and V slabs, the partial scores (64 x 64), P (block_m x 64)
    and a float4 of row statistics a q row."""
    return 4 * (block_m * F32_SLAB + F32_STAGES * 2 * F32_TILE * F32_SLAB + F32_TILE * F32_TILE
                + block_m * F32_TILE + 4 * block_m)


def f32_cluster_plan(bh: int, sq: int, d: int) -> TriPlan:
    """How both f32 forwards launch at a head dim ``d`` of 256 and above
    (a multiple of 64): q tiles of :func:`f32_rows` rows, 256 threads a
    CTA, one CTA per ``F32_SLAB``-column slab of O, the ``col_split`` CTAs
    of a tile in thread-block clusters of ``cluster``
    (:func:`f32_wide_geometry`); grid (q tiles, bh rows), ``col_split``
    CTAs a q tile on x (the triangle's q tiles heaviest first), rows in z
    slices of 65,535. Each CTA sums a partial score tile over the columns
    it owns and the cluster adds them through distributed shared memory, so
    a tile pair's scores are formed once up to d 1024; ``stages`` of the
    streamed K and V slabs; shared memory :func:`f32_cluster_smem`."""
    rows = f32_rows(sq)
    _, g, c = f32_wide_geometry(d)
    return TriPlan(rows, 256, (-(-sq // rows), bh), f32_cluster_smem(rows), 0, g * c, F32_SLAB,
                   F32_STAGES, c)


# the f32 tile kernels at head dims 32, 64 and 128 (f32_tile_head_dim in
# flash_fwd.cu, flash_bwd.cu): one CTA a tile, the head whole in one slab; at
# 16 both sources keep the first port's whole-row kernels in the base
# libraries, which the tile designs did not beat there
F32_TILE_HEAD_DIMS = (32, 64, 128)
F32_WHOLE_ROW_D = 16
F32_TILE_P_STRIDE = F32_TILE + 4  # floats a row of the tile forward's P (kF32TilePStride)


def f32_tile_width(d: int) -> int:
    """The slab of the f32 tile kernels at head dim ``d`` of 32-128: the
    whole head in one CTA, 64 columns at d 32 and 64 (32 zero-filled past d
    inside the slab) and 128 at d 128."""
    return 64 if d <= 64 else F32_SLAB


def f32_tile_fwd_width(d: int) -> int:
    """The slab of the f32 tile forward at head dim ``d`` of 32-128: the
    whole head, 32 columns at d 32 (the backward's 64, :func:`f32_tile_width`:
    a 32-column O block would leave half its threads without columns of dQ,
    dK and dV to hold), 64 at 64, 128 at 128."""
    return 32 if d <= 32 else f32_tile_width(d)


def f32_tile_fwd_smem(d: int, block_m: int) -> int:
    """Shared memory of an f32 tile forward CTA of ``block_m`` q rows at
    head dim ``d`` of 32-128 (f32_tile_smem_bytes in flash_fwd.cu): its Q
    tile, two stages of a K and a V tile, and P (``block_m`` rows of
    ``F32_TILE_P_STRIDE``). Two or more CTAs share an SM at a 32- or
    64-column slab."""
    width = f32_tile_fwd_width(d)
    return 4 * (block_m * width + F32_STAGES * 2 * F32_TILE * width + block_m * F32_TILE_P_STRIDE)


def f32_tile_plan(bh: int, sq: int, d: int) -> TriPlan:
    """How both f32 forwards launch at head dim ``d`` of 32, 64 or 128: the
    cluster kernels' design at one CTA a tile (``col_split`` and
    ``cluster`` 1) on a slab as wide as the head (:func:`f32_tile_fwd_width`),
    q tiles of :func:`f32_rows` rows, 256 threads; grid (q tiles, bh rows),
    rows in z slices of 65,535, walked tile-major (:func:`tile_major`: the
    triangle's and a plain causal mask's heaviest q tiles first);
    ``stages`` of the streamed K and V tiles; shared memory
    :func:`f32_tile_fwd_smem`."""
    rows = f32_rows(sq)
    return TriPlan(rows, 256, (-(-sq // rows), bh), f32_tile_fwd_smem(d, rows), 0, 1,
                   f32_tile_fwd_width(d), F32_STAGES, 1)


def apart(a: Sequence[int], b: Sequence[int]) -> bool:
    """Whether two tiles' segment ids (each tile's positions inside s) are
    one document each, and different ones: the pair holds no live (q, k)
    pair, and the kernels skip it (``apart`` in flash_bwd.cu, the f32
    forward's walk in flash_fwd.cu)."""
    return len(set(a)) == 1 and len(set(b)) == 1 and set(a) != set(b)


RECT_TILE = 64  # keys of a ring tile of the 16-bit general kernel (kRingRows in hopper.cuh)
# the 16-bit general kernel's staged segment ids: per stage 64 int32 and their
# min and max (kSegBytes in flash_fwd.cu)
SEG_BYTES = TRI_STAGES * (RECT_TILE + 2) * 4


@dataclasses.dataclass(frozen=True)
class RectPlan:
    """Launch plan of the general kernel (fields as :class:`TriPlan`'s),
    with the masks its walk and its tile rule read: sq q rows at global
    offset ``q_start`` against sk keys at ``k_start``, ``causal``, and
    ``window`` (None: no band; a band of causal attention only); ``skips``:
    the CTA copies no key tile of another document than its rows' one
    (:meth:`loads`; the 16-bit kernel at D 256, the f32 tile and cluster
    kernels)."""

    block_m: int
    threads: int
    grid: Tuple[int, int]
    smem_bytes: int
    swizzle: int
    sq: int
    sk: int
    causal: bool
    window: Optional[int]
    q_start: int
    k_start: int
    col_split: int = 1
    slab: int = 0
    stages: int = 0
    cluster: int = 1
    skips: bool = False

    def cta(self, x: int, y: int) -> Tuple[int, int]:
        """The (bh row, q tile) that block (x, y) computes, as the kernel
        maps it: natural order, bh rows on x for the tensor-core kernel; the
        f32 tile kernels and the 16-bit clusters above 576 tile-major
        (:func:`tile_major`), a plain causal mask's last q tile first."""
        if self.swizzle and self.slab:
            return tile_major(x, y, *self.grid, heaviest_first=self.causal and not self.window)
        if self.swizzle:
            return x, y
        if self.slab and self.cluster == 1:
            return tile_major(x, y, *self.grid, heaviest_first=self.causal and not self.window)
        return y, x

    def loads(self, tile: int, seg: Optional[torch.Tensor] = None) -> List[int]:
        """The 64-key tiles the CTA of q tile ``tile`` copies, in order: its
        walk, less (``skips``: the 16-bit CTAs at D 256 and the f32 tile and
        cluster kernels) a tile whose keys hold one document and the CTA's q
        rows one other (:func:`apart`), which no warp copies or multiplies.
        ``seg`` is one batch row's ids."""
        walk = list(self.walk(tile))
        if not self.skips or seg is None:
            return walk
        ids = seg.tolist()
        rows = ids[tile * self.block_m:min((tile + 1) * self.block_m, self.sq)]
        return [k for k in walk
                if not apart(rows, ids[k * RECT_TILE:min((k + 1) * RECT_TILE, self.sk)])]

    def walk(self, tile: int) -> range:
        """The 64-key tiles the CTA of q tile ``tile`` walks: the keys some
        of its rows can see by global position — all of them, or up to its
        last row's diagonal, from its first row's window on. Empty when no
        key is in reach (the rows then get O = 0 and lse = -inf)."""
        q0 = tile * self.block_m
        q_end = min(self.sq, q0 + self.block_m)
        hi = (max(0, min(self.sk, self.q_start + q_end - self.k_start)) if self.causal
              else self.sk)
        lo = max(0, self.q_start + q0 - self.window + 1 - self.k_start) if self.window else 0
        return range(lo // RECT_TILE, -(-hi // RECT_TILE)) if lo < hi else range(0)

    def kind(self, w0: int, k0: int, seg: Optional[torch.Tensor] = None) -> str:
        """How the 16-bit kernel's warpgroup of the 64 q rows from ``w0``
        treats the 64-key tile from ``k0`` (both local), after the
        reference's ``_dispatch_block``: "dead" — no live pair (outside its
        rows' band, or both sides one document each and different ones), no
        products; "fast" — every pair of a row inside sq is live (inside the
        band, every key inside sk, one shared document), no element mask;
        "masked" — the element mask. ``seg`` is one batch row's (sk,)
        segment ids."""
        qg0 = self.q_start + w0
        qg1 = self.q_start + min(w0 + 63, self.sq - 1)
        kg0 = self.k_start + k0
        kg1 = self.k_start + min(k0 + RECT_TILE - 1, self.sk - 1)
        sees = w0 < self.sq
        masked = k0 + RECT_TILE > self.sk  # a zero-filled key past sk would score
        if self.causal:
            sees = sees and qg1 >= kg0
            masked = masked or qg0 < kg1
        if self.window:
            sees = sees and qg0 - kg1 < self.window
            masked = masked or qg1 - kg0 >= self.window
        if seg is not None and sees:
            qs = seg[w0:min(w0 + 64, self.sq)]
            ks = seg[k0:min(k0 + RECT_TILE, self.sk)]
            uniform = bool(qs.min() == qs.max()) and bool(ks.min() == ks.max())
            sees = sees and not (uniform and bool(qs[0] != ks[0]))
            masked = masked or not uniform
        return "dead" if not sees else "masked" if masked else "fast"

    def visits(self, x: int, y: int,
               seg: Optional[torch.Tensor] = None) -> List[Tuple[int, int, str]]:
        """(64-row q slice, 64-key tile, kind) of every product block (x,
        y) of the 16-bit kernel computes, in its order: over the tiles it
        copies (:meth:`loads`), each warpgroup's slice skips a dead tile (at
        D 256 it multiplies it, masked whole, so that every product lies on
        the warpgroup's one path). The f32 tile and cluster kernels
        (``slab`` without a swizzle): (q tile of ``block_m`` rows, 64-key
        tile, "masked") of every tile pair each of the tile's ``col_split``
        CTAs copies (:meth:`loads`), the same for all of them; every pair is
        masked per element."""
        tile = self.cta(x, y)[1]
        if self.slab and not self.swizzle:
            return [(tile, k, "masked") for k in self.loads(tile, seg)]
        slices = [tile * self.block_m // 64 + w for w in range(self.block_m // 64)]
        out = []
        for k in self.loads(tile, seg):
            for q in slices:
                kind = self.kind(q * 64, k * RECT_TILE, seg)
                if kind != "dead" or self.skips:
                    out.append((q, k, "masked" if kind == "dead" else kind))
        return out


def rect_plan(dtype: torch.dtype, bh: int, sq: int, sk: int, d: int, sms: int, causal: bool,
              window: Optional[int] = None, q_start: int = 0, k_start: int = 0,
              block_m: Optional[int] = None) -> RectPlan:
    """How ``flash_fwd_rect`` launches for bh rows of sq q rows against sk
    keys, head dim d, and the masks.

    bf16 and fp16 run the tensor-core kernel: the triangle's one-wave rule
    for the q-tile height (:func:`tri_plan`: 128 rows once the grid fills
    one wave of CTAs on the card's ``sms`` streaming multiprocessors, else
    64; or the height ``block_m`` forces, as there), one producer warp,
    grid (bh, q tiles) in natural order, K and V in 64-key
    ring tiles; shared memory for the Q tile, ``TRI_STAGES`` K and V ring
    tiles, their staged segment ids (whether or not the call has ids, as
    ``SEG_BYTES``), 1 KiB of alignment slack and five mbarriers; the
    triangle's swizzle, and at d 512 and 576 its one stage and column
    slices; at d 256 the triangle's 128-row CTAs (:func:`rows_smem`), which
    copy no key tile whose one document is not their rows' one (``skips``,
    :meth:`RectPlan.loads`); above 576 the triangle's slab clusters
    (:func:`wide_plan`), tile-major, a plain causal mask's last q tile first,
    which likewise copy no such tile (``skips``). f32
    keeps the CUDA-core kernels' plans, the triangle's (from d 32 its q
    tiles in natural order, and no key tile of another document copied:
    ``skips``). The kernel checks the plan against its own layout and
    refuses one that differs."""
    masks = (sq, sk, causal, window if causal and window else None, q_start, k_start)
    tri = tri_plan(dtype, bh, sq, d, sms, block_m)
    smem = tri.smem_bytes
    if dtype != torch.float32 and d == ROWS_HEAD_DIM:
        smem = rows_smem(False)
    elif dtype != torch.float32 and not is_wide(d):
        stages = ring_stages(d)
        smem = (1024 + (tri.block_m + 2 * stages * RECT_TILE) * d * 2
                + stages * (RECT_TILE + 2) * 4 + 8 * (2 * stages + 1))
    return RectPlan(tri.block_m, tri.threads, tri.grid, smem, tri.swizzle, *masks,
                    tri.col_split, tri.slab, tri.stages, tri.cluster,
                    skips=bool(tri.slab) or (dtype != torch.float32 and d == ROWS_HEAD_DIM))


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(qb, kb, vb, heads: int, kv_heads: int) -> None:
    """The kernels' inputs: contiguous CUDA (rows, seq, D) tensors of one
    dtype the kernels take, a native D shared by q, k and v, and as many
    rows as the heads give. Any number of rows launches at once."""
    for name, t in (("q", qb), ("k", kb), ("v", vb)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor for the kernel, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dim() != 3:
            raise ValueError(f"{name} must be (rows, seq, head_dim), got {tuple(t.shape)}")
    if qb.dtype not in _DTYPES or kb.dtype != qb.dtype or vb.dtype != qb.dtype:
        raise ValueError(f"q/k/v must share a dtype in {list(_DTYPES)}: "
                         f"{qb.dtype}, {kb.dtype}, {vb.dtype}")
    d = qb.shape[2]
    native = d in NATIVE_HEAD_DIMS or (is_wide(d) and d % WIDE_BOX == 0)
    if not native or kb.shape[2] != d or vb.shape != kb.shape:
        raise ValueError(f"head_dim must be one of {NATIVE_HEAD_DIMS} or a multiple of "
                         f"{WIDE_BOX} above {MAX_HEAD_DIM} (pad others with "
                         f"padded_head_dim) and match across q/k/v: "
                         f"{tuple(qb.shape)}, {tuple(kb.shape)}, {tuple(vb.shape)}")
    if heads % kv_heads or qb.shape[0] // heads * kv_heads != kb.shape[0]:
        raise ValueError(f"rows {qb.shape[0]} / {kb.shape[0]} do not fit heads {heads} / {kv_heads}")


def _check_tma_bases(**tensors) -> None:
    """Raise unless each named tensor starts on a TMA_ALIGN-byte boundary,
    as a TMA tensor map's base must, and the f32 tile and cluster kernels'
    16-byte cp.async copies (every f32 head dim but ``F32_WHOLE_ROW_D``)."""
    for name, t in tensors.items():
        if t.data_ptr() % TMA_ALIGN:
            raise ValueError(f"{name} must start on a {TMA_ALIGN}-byte boundary for the "
                             f"kernels' 16-byte copies (TMA, cp.async), got address "
                             f"{t.data_ptr():#x}")


def _check_seg(seg, batch: int, sq: int, sk: int) -> None:
    """Segment ids must be a contiguous int32 CUDA (batch, seq) tensor, and
    only come with sq == sk."""
    if sq != sk or seg.shape != (batch, sk) or seg.dtype != torch.int32:
        raise ValueError(f"segment ids must be int32 (batch, seq) with sq == sk, got "
                         f"{seg.dtype} {tuple(seg.shape)} for sq={sq}, sk={sk}")
    if not (seg.is_cuda and seg.is_contiguous()):
        raise ValueError("segment ids must be a contiguous CUDA tensor")


def library_name(source: str, dtype: torch.dtype, d: int) -> str:
    """The library of ``source``'s kernels (``flash_fwd`` or ``flash_bwd``)
    that holds ``dtype`` at head dim ``d``: ``<source>_f16`` for fp16, and
    ``_d512`` or ``_d576`` after either at d 512 or 576, ``_wide`` above 576
    (``build.VARIANTS``); f32 from d 32 on: ``<source>_wide`` (both
    sources' tile kernels at 32-128 and cluster kernels from 256); f32 at
    ``F32_WHOLE_ROW_D`` stays in the base library (the whole-row kernels),
    which a serving replica builds cold."""
    if dtype == torch.float32 and d > F32_WHOLE_ROW_D:
        return source + "_wide"
    return (source + ("_f16" if dtype == torch.float16 else "")
            + ("_wide" if is_wide(d) else f"_d{d}" if d in (512, 576) else ""))


def _lib(dtype: torch.dtype, d: int) -> ctypes.CDLL:
    """The library of ``dtype``'s kernels at head dim ``d`` with its C
    signatures declared (built on its first call):
    :func:`library_name`."""
    return _load(library_name("flash_fwd", dtype, d))


@functools.cache
def _load(name: str) -> ctypes.CDLL:
    lib = build.load(name)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_fwd_tri.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, f32,
                                  i32, i32, i32, ptr]
    lib.flash_fwd_tri.restype = i32
    lib.flash_fwd_rect.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32,
                                   i32, i32, i32, i32, i32, i32, f32, i32, i32, i32, ptr]
    lib.flash_fwd_rect.restype = i32
    return lib


def f32_active_clusters(d: int, tri: bool, block_m: int) -> int:
    """How many clusters of the f32 forward kernel (the triangle's with
    ``tri``, else the general one's) at head dim ``d`` and ``block_m`` q
    rows the current card holds at once: at 256 and above (a multiple of
    64) ``cudaOccupancyMaxActiveClusters`` at its plan's shared memory and
    cluster size; at 32, 64 and 128 (one CTA a tile, a cluster of one) its
    SMs times ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``. Raises
    where the query fails."""
    fn = _lib(torch.float32, d).flash_fwd_f32_clusters
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
    n = fn(int(tri), d, block_m)
    if n <= 0:
        raise RuntimeError(f"f32 forward at head dim {d}, {block_m} rows: cluster occupancy "
                           f"query returned {n}")
    return n


def wide_active_clusters(dtype: torch.dtype, d: int, tri: bool) -> int:
    """How many clusters of the bf16 or fp16 wide forward (the triangle's
    with ``tri``, else the general kernel's) at head dim ``d`` above 576 (a
    multiple of 64) the current card holds at once:
    ``cudaOccupancyMaxActiveClusters`` at its plan's shared memory and
    cluster size, asked once per card. Raises where the query fails."""
    fn = _lib(dtype, d).flash_fwd_wide16_clusters
    fn.argtypes, fn.restype = [ctypes.c_int] * 2, ctypes.c_int
    n = fn(int(tri), d)
    if n <= 0:
        raise RuntimeError(f"{dtype} wide forward at head dim {d}: cluster occupancy query "
                           f"returned {n}")
    return n


def _raise_on(code: int, name: str) -> None:
    if code == -1:
        raise ValueError(f"{name}: shape, dtype, plan or alignment not supported by the kernel")
    if code == -2:
        raise RuntimeError(f"{name}: no TMA tensor map (cuTensorMapEncodeTiled missing or refused)")
    if code == -3:
        raise RuntimeError(f"{name}: no thread-block cluster of the plan's size fits on the card "
                           "at the plan's shared memory")
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {code}")


def _qscale(d: int, sm_scale: Optional[float]) -> float:
    """The kernels' score scale: the softmax scale (default 1/√d) times
    log2(e), for their base-2 softmax."""
    return LOG2E * (1.0 / math.sqrt(d) if sm_scale is None else sm_scale)


def flash_fwd_tri(qb, kb, vb, heads: int, kv_heads: int, block_m: Optional[int] = None,
                  sm_scale: Optional[float] = None):
    """Plain-causal forward (sq == sk, no offsets, window or segments):
    the port of ``_flash_fwd_tri_kernel``. bf16 and fp16 run on the tensor
    cores (wgmma, TMA: q, k, v need 16-byte-aligned bases), f32 on the CUDA
    cores (from head dim 32 by 16-byte cp.async: 16-byte-aligned bases too;
    a misaligned one raises ``ValueError`` naming it); the launch follows :func:`tri_plan`, at the tile height
    ``block_m`` when given (checked on the CPU too, where it changes
    nothing). ``sm_scale`` is the softmax scale (default 1/√d; a padded
    head passes its true head dim's). fp16 runs bf16's design on fp16
    operands."""
    check_block_m(qb.dtype, block_m, qb.shape[-1])
    if not qb.is_cuda:
        return attention_plain(qb, kb, vb, heads, kv_heads, causal=True, sm_scale=sm_scale)
    _check(qb, kb, vb, heads, kv_heads)
    bh, s, d = qb.shape
    if kb.shape[1] != s:
        raise ValueError(f"the triangle kernel needs sq == sk, got {s} and {kb.shape[1]}")
    out = torch.empty_like(qb)
    lse = torch.empty((bh, s), dtype=torch.float32, device=qb.device)
    if qb.dtype in TENSOR_CORE_DTYPES or d > F32_WHOLE_ROW_D:
        _check_tma_bases(q=qb, k=kb, v=vb, out=out)
    plan = tri_plan(qb.dtype, bh, s, d, _sm_count(qb.device.index), block_m)
    with torch.cuda.device(qb.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _lib(qb.dtype, d).flash_fwd_tri(
            qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), out.data_ptr(), lse.data_ptr(),
            _DTYPES[qb.dtype], bh, s, d, heads, kv_heads, _qscale(d, sm_scale),
            plan.block_m, plan.smem_bytes, plan.swizzle, stream,
        )
    _raise_on(code, "flash_fwd_tri")
    flash_fwd_tri.launches += 1
    return out, lse


def flash_fwd_rect(qb, kb, vb, heads: int, kv_heads: int, causal: bool,
                   q_start: int = 0, k_start: int = 0,
                   window: Optional[int] = None, seg: Optional[torch.Tensor] = None,
                   block_m: Optional[int] = None, sm_scale: Optional[float] = None):
    """General forward — causal or full, window, segment ids (B, S) int32,
    global offsets, sq != sk: the port of ``_flash_fwd_kernel``. bf16 and
    fp16 run on the tensor cores (wgmma, TMA: q, k, v need 16-byte-aligned
    bases), f32 on the CUDA cores (16-byte-aligned bases from head dim 32,
    as :func:`flash_fwd_tri`'s); the launch follows :func:`rect_plan`, at the
    tile height ``block_m`` when given; ``sm_scale`` as
    :func:`flash_fwd_tri`'s."""
    check_block_m(qb.dtype, block_m, qb.shape[-1])
    if not qb.is_cuda:
        return attention_plain(qb, kb, vb, heads, kv_heads, causal, q_start, k_start,
                               window, seg, sm_scale)
    _check(qb, kb, vb, heads, kv_heads)
    bh, sq, d = qb.shape
    sk = kb.shape[1]
    if seg is not None:
        _check_seg(seg, bh // heads, sq, sk)
    out = torch.empty_like(qb)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=qb.device)
    if qb.dtype in TENSOR_CORE_DTYPES or d > F32_WHOLE_ROW_D:
        _check_tma_bases(q=qb, k=kb, v=vb, out=out)
    plan = rect_plan(qb.dtype, bh, sq, sk, d, _sm_count(qb.device.index), causal, window,
                     q_start, k_start, block_m)
    with torch.cuda.device(qb.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _lib(qb.dtype, d).flash_fwd_rect(
            qb.data_ptr(), kb.data_ptr(), vb.data_ptr(),
            None if seg is None else seg.data_ptr(), out.data_ptr(), lse.data_ptr(),
            _DTYPES[qb.dtype], bh, sq, sk, d, heads, kv_heads, int(causal),
            int(q_start), int(k_start), 0 if window is None else int(window),
            _qscale(d, sm_scale), plan.block_m, plan.smem_bytes, plan.swizzle, stream,
        )
    _raise_on(code, "flash_fwd_rect")
    flash_fwd_rect.launches += 1
    return out, lse


flash_fwd_tri.launches = 0
flash_fwd_rect.launches = 0
