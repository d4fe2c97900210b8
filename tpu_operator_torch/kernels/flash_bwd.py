"""Wrappers of the four flash-attention backward kernels (``flash_bwd.cu``)
and their plain PyTorch version.

Layout is the forward's (``flash_fwd.py``): q, O, dO and dQ are
(B·H, S, D), k, v, dK and dV (B·H_kv, S, D); lse (the forward's, natural
log) and delta = rowsum(dO ∘ O) are (B·H, S) float32. Gradients come back
in the inputs' dtype. The kernels take sq == sk only, as ``flash_attention``
does.

The device of the tensors chooses the code: a CUDA tensor launches the
kernel (or raises), a CPU tensor runs :func:`attention_bwd_plain`, which
computes all three gradients from ``out``; each wrapper returns its part.
Each wrapper counts the kernel launches it makes in ``<wrapper>.launches``,
and each dK/dV wrapper the second kernel a split GQA walk launches
(``flash_bwd_dkv_split_sum_kernel``) in ``<wrapper>.split_sums``.
In bf16 and fp16 both pairs run on the tensor cores (wgmma, TMA: q, k, v
and dO need 16-byte-aligned bases) with the launch plans of
:func:`tri_bwd_plan` and :func:`rect_bwd_plan`, the same for both 16-bit
types; f32 runs on the CUDA cores, in ``flash_bwd_wide`` (16-byte-aligned
bases too; :func:`wide_bwd_plans`) one CTA a tile at head dims 32-128 and
thread-block clusters of slab CTAs at 256 and above, and at 16 the
whole-row pair in the base library. fp16 has a library of its own
(``build.VARIANTS``), built at the first fp16 call; so have head dims 512
(``flash_bwd_d512``, ``flash_bwd_f16_d512``) and 576 (``flash_bwd_d576``,
``flash_bwd_f16_d576``), each built at the first call there. At 512 and
576 the ring's tiles are 32 rows (:func:`ring_rows`) in one stage, and two
(512) or three (576) CTAs share each own-side tile, one per column slice
of the gradients (``flash_fwd.col_split``). Above 576 both pairs run
D-streaming kernels (``flash_bwd_wide``, ``flash_bwd_f16_wide``;
:func:`wide_bwd_plans`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import List, Optional, Sequence, Tuple

import torch

from tpu_operator_torch.kernels import build
from tpu_operator_torch.kernels.flash_fwd import (
    _DTYPES,
    TENSOR_CORE_DTYPES,
    _check,
    _check_seg,
    _check_tma_bases,
    _qscale,
    col_split,
    library_name,
    ring_stages,
    _raise_on,
    _sm_count,
    _tile_height,
    F32_SLAB,
    F32_STAGES,
    F32_TILE_HEAD_DIMS,
    F32_WHOLE_ROW_D,
    WIDE_BOX_BYTES,
    apart,
    check_block_m,
    f32_tile_width,
    f32_wide_geometry,
    is_wide,
    keep_mask,
    kv_row,
    tile_heights,
    wide_slabs,
)

TILE = 64  # rows of a ring tile, keys of a dQ tile, q rows of a dK/dV tile (kTile)


def kv_split(d: int) -> int:
    """Consumer warpgroups of the 16-bit dK/dV kernel per 64 keys: 2 at d 256,
    512 and 576, each accumulating dK and dV for a share of the CTA's
    columns in whole 64-column boxes: halves at 256 and 512, two boxes and
    one of a 576-wide head's 192-column thirds (kv_split, DC in
    flash_bwd.cu), else 1."""
    return 2 if d > 128 else 1


def ring_rows(d: int) -> int:
    """Rows of the 16-bit pairs' ring tiles (dQ: keys, dK/dV: q rows):
    ``TILE``, or 32 at d 512 and 576, where a 64-row tile pair beside the
    CTA's own two tiles would pass a block's shared memory (ring_rows in
    flash_bwd.cu)."""
    return 32 if d > 256 else TILE



TRI_BWD_STAGES = 2  # ring depth of the 16-bit pairs (kStages in flash_bwd.cu)
# the 16-bit general pair's staged segment ids: per stage 64 int32 and their
# min and max (kSegBytes in flash_bwd.cu)
SEG_BYTES = TRI_BWD_STAGES * (TILE + 2) * 4
# the 16-bit dK/dV kernel at d 256: each of its two consumer warpgroups forms
# P^T and dS^T for 32 of a ring tile's 64 q rows and hands both, packed to
# 16 bits, to the other through shared memory (kXchBytes in flash_bwd.cu)
DKV_EXCHANGE_BYTES = 2 * 2 * TILE * (TILE // 2) * 2


def _rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded through ``dtype`` and back to float32 (a no-op for f32)."""
    return x.to(dtype).float()


def attention_bwd_plain(qb, kb, vb, out, lse, dout, heads: int, kv_heads: int, causal: bool,
                        window: Optional[int] = None,
                        seg: Optional[torch.Tensor] = None,
                        sm_scale: Optional[float] = None) -> Tuple[torch.Tensor, ...]:
    """Dense masked float32 FlashAttention-2 backward with the kernels'
    masking (:func:`keep_mask`) and rounding points: P is recomputed from
    lse with the reference's guards (masked pairs and rows with lse = -inf
    give 0), dS = P∘(dP − Δ)·c with Δ = rowsum(dO∘O) and c the softmax
    scale ``sm_scale`` (default 1/√d), P is rounded to dO's dtype before
    dV = Pᵀ·dO and dS to the input dtype before dQ = dS·K and dK = dSᵀ·Q. A
    GQA group's q heads sum into their kv head. Returns (dq, dk, dv) in the
    inputs' dtypes."""
    bh, s, d = qb.shape
    group = heads // kv_heads
    scale = 1.0 / math.sqrt(d) if sm_scale is None else sm_scale
    rows = kv_row(torch.arange(bh, device=qb.device), heads, kv_heads)
    q, do = qb.float(), dout.float()
    k, v = kb.float()[rows], vb.float()[rows]
    live = torch.isfinite(lse)[..., None]
    keep = keep_mask(bh, s, kb.shape[1], heads, causal, window=window, seg=seg,
                     device=qb.device) & live
    scores = torch.einsum("bqd,bkd->bqk", q, k) * scale
    p = torch.where(keep, torch.exp(scores - torch.where(live, lse[..., None], 0.0)), 0.0)
    delta = (do * out.float()).sum(-1, keepdim=True)
    dp = torch.einsum("bqd,bkd->bqk", do, v)
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bqk,bkd->bqd", _rounded(ds, kb.dtype), k)
    dk = torch.einsum("bqk,bqd->bkd", _rounded(ds, qb.dtype), q)
    dv = torch.einsum("bqk,bqd->bkd", _rounded(p, dout.dtype), do)

    def per_kv_head(x):  # q row b·H + h_kv·group + m belongs to kv row b·H_kv + h_kv
        return x.reshape(bh // heads * kv_heads, group, s, d).sum(1)

    return dq.to(qb.dtype), per_kv_head(dk).to(kb.dtype), per_kv_head(dv).to(vb.dtype)


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """Launch plan of one kernel of a backward pair: ``kernel`` is "dq" or
    "dkv"; a CTA owns ``block`` q rows (dq) or keys (dkv) of one (batch,
    head) or kv row, with ``threads`` per CTA, ``grid`` (x, y), dynamic
    shared memory in bytes and the TMA/wgmma swizzle span in bytes (0: the
    f32 CUDA-core kernels, which use no TMA). ``causal`` and ``window``
    (None: no band) are the masks the walk follows; the triangle pair's
    plan is causal with no window. ``ring`` is the rows of a tile of the
    other side (:func:`ring_rows`), ``col_split`` the grid's z: the CTAs
    per own-side tile, each on a column slice of the gradients. Above 576,
    and in f32 (:func:`wide_bwd_plans`), ``slab`` is the columns a CTA
    holds, ``stages`` the depth of the ring the other side (16-bit: in 64 x
    64 boxes; f32: in slabs) streams through and ``cluster`` the CTAs of a
    thread-block cluster on the grid's x, those that share one tile pair's
    S and dP (f32: 1 up to d 128); elsewhere ``slab`` and ``stages`` are 0,
    ``cluster`` 1.
    ``split`` (dkv in f32 and in bf16 and fp16 up to 256, else 1) is the
    parts of the GQA walk (:func:`gqa_split`): the grid's rows
    (f32: y; 16-bit: x) hold split x kv rows, part j walking members
    [j·group/split, (j+1)·group/split) into f32 partial sums
    (:meth:`workspace`) that a second kernel adds in part order."""

    kernel: str
    block: int
    threads: int
    grid: Tuple[int, int]
    smem_bytes: int
    swizzle: int
    causal: bool = True
    window: Optional[int] = None
    ring: int = TILE
    col_split: int = 1
    slab: int = 0
    stages: int = 0
    cluster: int = 1
    split: int = 1

    @property
    def _rows_axis(self) -> int:
        """The grid axis of the (batch, head) or kv rows: x for the 16-bit
        kernels up to d 576, y for the f32 ones and every slab kernel (the
        16-bit pair above 576 too)."""
        return 0 if self.swizzle and not self.slab else 1

    @property
    def redundancy(self) -> int:
        """How many times each tile pair's S and dP are formed: once per
        cluster of a tile's CTAs, which share them (every CTA on its own
        outside a cluster)."""
        return self.col_split // self.cluster

    def _slot(self, x: int, y: int) -> Tuple[int, int]:
        """The (grid row, tile) block (x, y) computes, as the kernel maps
        it: dq walks its q tiles heaviest (last) first under a plain causal
        mask and in order otherwise (every tile walks about as far), dkv its
        key tiles in order (under a causal mask the first keys see the most
        rows). 16-bit up to d 576: rows on x, tiles on y; f32 at d 16: tiles
        on x, rows on y; other f32 and 16-bit above 576 (a cluster of c CTAs
        a tile, one at f32 head dims up to 128): the launch's n-th cluster
        (n = x + tiles·y) takes tile rank n // rows of row n % rows,
        tile-major (flash_bwd.cu's cluster_slot)."""
        heaviest_last = self.kernel == "dq" and self.causal and self.window is None
        if self.swizzle and not self.slab:
            return (x, self.grid[1] - 1 - y) if heaviest_last else (x, y)
        if not self.slab:
            return y, x
        tiles, rows = self.grid
        rank, row = divmod(x + tiles * y, rows)
        return row, (tiles - 1 - rank if heaviest_last else rank)

    def cta(self, x: int, y: int) -> Tuple[int, int]:
        """The (row, tile) that block (x, y) computes (:meth:`_slot`); a
        split dkv's grid row is part x kv rows + kv row."""
        row, tile = self._slot(x, y)
        return (row if self.split == 1 else row % self._kv_rows()), tile

    def _kv_rows(self) -> int:
        return self.grid[self._rows_axis] // self.split

    def with_split(self, split: int) -> "BwdPlan":
        """This dkv plan with its GQA walk in ``split`` parts (the grid's
        rows times ``split``), as a card whose rule chose it plans."""
        grid = list(self.grid)
        grid[self._rows_axis] = self._kv_rows() * split
        return dataclasses.replace(self, grid=tuple(grid), split=split)

    def _part(self, x: int, y: int) -> int:
        """The walk part block (x, y) computes: 0 unless split."""
        return self._slot(x, y)[0] // self._kv_rows()

    def sees(self, q: int, k: int) -> bool:
        """Whether some key of key tile k is inside the masks' band for some
        row of q tile q (both tiles inside s): the own side's tiles are 64
        rows, the ring's ``ring``."""
        if not self.causal:
            return True
        q_rows, k_rows = (TILE, self.ring) if self.kernel == "dq" else (self.ring, TILE)
        q0, k0 = q * q_rows, k * k_rows
        return k0 <= q0 + q_rows - 1 and (
            self.window is None or q0 - (k0 + k_rows - 1) < self.window)

    def walk(self, first: int, s: int) -> range:
        """The ``ring``-row tiles of the ring's side (dq: keys, dkv: q rows)
        that the CTA whose own side starts at 64-row tile ``first`` walks."""
        ring = self.ring
        start = first * TILE
        if self.kernel == "dq":
            hi = min(s, start + self.block) if self.causal else s
            lo = max(0, start - self.window + 1) if self.window is not None else 0
            return range(lo // ring, -(-hi // ring))
        if self.window is None:
            return range(start // ring if self.causal else 0, -(-s // ring))
        end = min(s, min(start + self.block, s) - 1 + self.window)
        return range(start // ring, -(-end // ring))

    def visits(self, x: int, y: int, s: int, group: int,
               seg: Optional[Sequence[int]] = None) -> List[Tuple[int, int, int]]:
        """The (GQA member, q tile, key tile) products block (x, y) computes
        for s tokens, in the kernel's order (own-side tiles of 64 rows, the
        ring's of ``ring``): a 64-row (or 64-key) slice of the CTA skips a
        tile it cannot see (outside the band, or all its rows or keys past
        s), and with the segment ids ``seg`` (the s ids of the block's batch
        row) a tile whose positions inside s hold one document while its
        slice's hold another (:func:`apart`; the whole-row f32 pair at d 16
        computes such a tile, masked to zero). dq has one member, 0; a split
        dkv walks its part's group / ``split`` members. Each of
        ``col_split`` CTAs on the grid's z makes the same visits."""
        tiles = -(-s // TILE)
        first = self.cta(x, y)[1] * self.block // TILE
        slices = [t for t in range(first, first + self.block // TILE) if t < tiles]
        q_rows, k_rows = (TILE, self.ring) if self.kernel == "dq" else (self.ring, TILE)

        skips = seg is not None and (self.swizzle > 0 or self.slab > 0)

        def live(q: int, k: int) -> bool:
            return self.sees(q, k) and not (skips and apart(
                seg[q * q_rows:min(s, (q + 1) * q_rows)], seg[k * k_rows:min(s, (k + 1) * k_rows)]))

        out = []
        if self.kernel == "dq":
            for k in self.walk(first, s):
                out += [(0, q, k) for q in slices if live(q, k)]
            return out
        share = group // self.split
        part = self._part(x, y)
        for m in range(part * share, (part + 1) * share):
            for q in self.walk(first, s):
                out += [(m, q, k) for k in slices if live(q, k)]
        return out

    def loads(self, x: int, y: int, s: int, group: int,
              seg: Optional[Sequence[int]] = None) -> List[Tuple[int, int]]:
        """The (GQA member, q tile) ring tiles that 16-bit dkv block (x, y)
        loads for s tokens, in the kernel's order: its part's members'
        walks, less, with the segment ids ``seg`` (the s ids of the block's
        batch row), each q tile whose positions inside s hold one document
        while all of the CTA's keys hold another (:func:`apart`, which every
        warp of the kernel decides from the ids' range): such a tile gets no
        TMA, no ring stage and no barrier round trip. Every live (member, q tile) of
        :meth:`visits` is among them."""
        first = self.cta(x, y)[1] * self.block // TILE
        keys = seg[first * TILE:min(s, first * TILE + self.block)] if seg is not None else None
        share = group // self.split
        part = self._part(x, y)
        return [(m, q) for m in range(part * share, (part + 1) * share)
                for q in self.walk(first, s)
                if keys is None or not apart(seg[q * self.ring:min(s, (q + 1) * self.ring)], keys)]

    def workspace(self, s: int, d: int) -> Optional[Tuple[int, ...]]:
        """The f32 partials a split dkv writes, (2, split, kv rows, s, d):
        dK's parts, then dV's; None at split 1 (dK and dV written
        straight)."""
        if self.split == 1:
            return None
        return (2, self.split, self._kv_rows(), s, d)


def gqa_split(plan: BwdPlan, s: int, group: int, rows: int, clusters: int) -> int:
    """The parts the dK/dV walk over a GQA group splits in (the f32 cluster
    pair, and the 16-bit pair up to head dim 256): the smallest divisor sp
    of ``group`` that minimises max(H, ⌈P / R⌉) in tile pairs, H the
    heaviest CTA's (f32: cluster's) walk (the longest key tile's band of q
    tiles, times group / sp members), P the launch's tile pairs (``rows`` kv
    rows, every key tile's band, every member) and R the card's resident
    ``clusters`` (16-bit: CTAs, a cluster of one): a split that shortens the
    longest walk until the card's CTAs, not one walk, set the pace. 1 at GQA
    1, and where P / R already passes H. The rule reads the mask's walk and
    no device data (a plan is made inside CUDA-graph capture too), so under
    segment ids it plans the walk as if no tile were dead."""
    walks = [len(plan.walk(t, s)) for t in range(0, -(-s // TILE), plan.block // TILE)]
    heaviest = max(walks) * group
    floor = -(-rows * group * sum(walks) // clusters)
    paces = {sp: max(heaviest // sp, floor) for sp in range(1, group + 1) if group % sp == 0}
    return min(paces, key=lambda sp: (paces[sp], sp))


# the D-streaming pairs' layout above 576 (flash_bwd.cu, built with
# -DFLASH_HEAD_DIM_WIDE)
WIDE_DQ_SLAB = 256     # columns of dQ a 16-bit CTA holds (kWideDqSlab)
WIDE_DKV_SLAB = 128    # columns of dK and of dV a 16-bit CTA holds (kWideDkvSlab)
WIDE_BWD_RING = 4      # stages of the streamed ring, four boxes each (kWideRing)
WIDE_THREADS = 128     # one warpgroup a 16-bit CTA (kWideThreads)
# the exchange: a tile pair's partial S and dP, 64 x 64 f32 each, with the
# 16-bit P and dS over them (kWideXchBytes)
WIDE_XCH_BYTES = 2 * TILE * TILE * 4
# the f32 pair's tiles, slabs and clusters: flash_fwd.F32_* and f32_wide_geometry
# (flash_cluster.cuh)
# the f32 pair at head dims 32-128, one CTA a tile on a slab as wide as the
# head, and at 16 the base library's whole-row pair: flash_fwd.F32_TILE_HEAD_DIMS,
# F32_WHOLE_ROW_D and f32_tile_width, the forward's too


def f32_tile_smem(d: int, kernel: str) -> int:
    """Shared memory of the f32 ``kernel`` ("dq" or "dkv") at head dim ``d``
    up to 128 (flash_bwd.cu's f32_tile_smem_bytes): its two resident tiles
    of the slab's width (dQ: Q and dO; dK/dV: K and V), the ring's two
    stages of two (K and V; Q and dO), and the score tiles: dQ's dS^T
    (at a 64-column slab two dQ CTAs share an SM), dK/dV's P^T and dS^T."""
    scores = 1 if kernel == "dq" else 2
    return 4 * ((2 + 2 * F32_STAGES) * TILE * f32_tile_width(d) + scores * TILE * TILE)


def wide_bwd_plans(dtype: torch.dtype, bh: int, bh_kv: int, s: int, d: int,
                   causal: bool = True, window: Optional[int] = None,
                   rect: bool = False,
                   clusters: Optional[int] = None) -> Tuple[BwdPlan, BwdPlan]:
    """How either pair launches at a head dim ``d`` above 576, and in f32 at
    32, 64, 128 and from 256 on (a multiple of 64): (dq plan, dkv plan);
    the triangle
    pair's by default, or with
    ``rect`` the general pair's under ``causal`` and ``window`` (the band as
    :func:`band` reads it). Own-side tiles and ring tiles of 64 rows;
    ``col_split`` CTAs a tile, each on a slab of ``slab`` columns of the
    gradients, in thread-block clusters of ``cluster`` on the grid's x
    (:func:`f32_wide_geometry` at the slab's width), which add their partial
    S and dP through distributed shared memory, so each cluster forms a
    tile pair's scores once (``redundancy`` g: 1 up to 8 slabs). bf16 and
    fp16: slabs of 256 columns of dQ (3 CTAs a tile at 640 and 704, 4 at
    1024) and 128 of dK and dV (5, 6, 8); one warpgroup a CTA (``threads``
    128) that keeps its own columns of its own side resident (dQ: Q and dO;
    dK/dV: K and V) and streams the other side's own columns (dQ: K and V;
    dK/dV: Q and dO) by TMA through a ring of ``stages`` of four 64 x 64
    boxes; per tile pair the cluster's exchange forms P and dS once in
    shared memory, and each CTA runs its gradient products on wgmma with
    both operands there; the same shared memory for both masks (every warp
    reads the segment ids' range itself). Both pairs launch tile-major, the
    longest walks first (:meth:`BwdPlan.cta`). f32: the CUDA-core pair with 64-row
    tiles, ``F32_SLAB``-column slabs and the slab CTAs of a tile
    in thread-block clusters of ``cluster`` (:func:`f32_wide_geometry`),
    which add their partial S and dP through distributed shared memory:
    ``redundancy`` g, 1 up to d 1024 (c = 2 at 256, 4 at 512, 5 at 576);
    the clusters launch tile-major, the longest walks first
    (:meth:`BwdPlan.cta`). Per CTA: two resident slabs, the ``stages`` of
    the streamed ring (two slabs, or four 64-column chunks, each), the
    exchange's two 64 x 64 tiles, and dQ's rows' lse and delta; the same
    for both pairs (the ids are read by every warp). f32 at d 32-128: that
    pair at c = 1, one CTA a tile (``col_split``, ``cluster`` and
    ``redundancy`` 1), on a slab as wide as the head (:func:`f32_tile_width`)
    with no exchange, and shared memory :func:`f32_tile_smem`. dK/dV's GQA
    walk splits in :func:`gqa_split` parts given the card's resident dK/dV
    ``clusters`` (f32 at d 32-128: CTAs; None: no split)."""
    tiles = -(-s // TILE)
    masks = dict(causal=causal, window=window) if rect else {}
    if dtype == torch.float32:
        if d in F32_TILE_HEAD_DIMS:
            geometry = dict(col_split=1, slab=f32_tile_width(d), stages=F32_STAGES, cluster=1)
            smem = {kernel: f32_tile_smem(d, kernel) for kernel in ("dq", "dkv")}
        else:
            _, g, c = f32_wide_geometry(d)
            base = 2 * TILE * F32_SLAB + F32_STAGES * 2 * TILE * F32_SLAB + 2 * TILE * TILE
            geometry = dict(col_split=g * c, slab=F32_SLAB, stages=F32_STAGES, cluster=c)
            smem = {"dq": 4 * (base + 2 * TILE), "dkv": 4 * base}
        dq = BwdPlan("dq", TILE, 256, (tiles, bh), smem["dq"], 0, **geometry, **masks)
        dkv = BwdPlan("dkv", TILE, 256, (tiles, bh_kv), smem["dkv"], 0, **geometry, **masks)
        if clusters is not None:
            dkv = dkv.with_split(gqa_split(dkv, s, bh // bh_kv, bh_kv, clusters))
        return dq, dkv
    # 16-bit: the resident slab of the own side's two tensors, the ring, the
    # exchange, the tile's 64 (lse, delta) pairs and both sides' 64 segment
    # ids, the ring's barriers and the resident slab's
    fixed = (1024 + WIDE_BWD_RING * 4 * WIDE_BOX_BYTES + WIDE_XCH_BYTES + TILE * (8 + 2 * 4)
             + 8 * (WIDE_BWD_RING + 1))

    def plan(kernel: str, rows: int, slab: int) -> BwdPlan:
        _, g, c = f32_wide_geometry(d, slab)
        return BwdPlan(kernel, TILE, WIDE_THREADS, (tiles, rows),
                       fixed + 2 * (slab // TILE) * WIDE_BOX_BYTES, 128, col_split=g * c,
                       slab=slab, stages=WIDE_BWD_RING, cluster=c, **masks)

    return plan("dq", bh, WIDE_DQ_SLAB), plan("dkv", bh_kv, WIDE_DKV_SLAB)


def _bwd_plans(dtype: torch.dtype, bh: int, bh_kv: int, s: int, d: int, sms: int,
               causal: bool, window: Optional[int], rect: bool,
               block_m: Optional[int] = None,
               clusters: Optional[int] = None) -> Tuple[BwdPlan, BwdPlan]:
    """The (dq, dkv) plans of either pair; ``rect``: the general pair, which
    stages each ring tile's segment ids and their range; ``block_m`` forces
    both kernels' tile height (checked against ``dtype``). Above 576, and
    in f32 from 32 on, both pairs' plans are :func:`wide_bwd_plans`; f32 at
    16 keeps the whole-row pair's fixed plans (64-row tiles, one CTA a tile
    on the grid's x, rows on y, no split).
    ``clusters``: the card's resident dK/dV clusters (f32) or CTAs (bf16
    and fp16 up to d 256), which size dK/dV's GQA split (None: no split)."""
    check_block_m(dtype, block_m, d)
    if dtype == torch.float32 and d == F32_WHOLE_ROW_D:
        tiles = -(-s // TILE)
        dq = BwdPlan("dq", TILE, 256, (tiles, bh),
                     4 * (4 * TILE * (d + 1) + TILE * (TILE + 1)) + 4 * TILE, 0, causal, window)
        dkv = BwdPlan("dkv", TILE, 256, (tiles, bh_kv),
                      4 * (4 * TILE * (d + 1) + 2 * TILE * (TILE + 1) + 2 * TILE) + 4 * TILE, 0,
                      causal, window)
        return dq, dkv
    if is_wide(d) or dtype == torch.float32:
        return wide_bwd_plans(dtype, bh, bh_kv, s, d, causal, window, rect, clusters)

    stages, ring = ring_stages(d), ring_rows(d)
    ids = stages * (ring + 2) * 4 if rect else 0  # SEG_BYTES below d 512

    def plan(kernel: str, rows: int) -> BwdPlan:
        block = _tile_height(rows, s, sms, block_m, tile_heights(dtype, d))
        smem = (1024 + (2 * block + 2 * stages * ring) * d * 2 + ids
                + 8 * (2 * stages + 1))
        if kernel == "dkv":
            smem += 2 * stages * ring * 4
            if kv_split(d) > 1 and col_split(d) == 1:
                smem += DKV_EXCHANGE_BYTES
        # consumer warpgroups of 64 rows (dkv at d 256 and wider: two per 64
        # keys, kv_split), and the producer: one warp for dq, a whole warpgroup
        # for dkv (setmaxnreg hands its registers over)
        split = 1 if kernel == "dq" else kv_split(d)
        threads = 2 * block * split + (32 if kernel == "dq" else 128)
        return BwdPlan(kernel, block, threads, (rows, -(-s // block)), smem, 2 * min(d, 64),
                       causal, window, ring, col_split(d))

    dkv = plan("dkv", bh_kv)
    if clusters is not None and col_split(d) == 1:
        dkv = dkv.with_split(gqa_split(dkv, s, bh // bh_kv, bh_kv, clusters))
    return plan("dq", bh), dkv


def tri_bwd_plan(dtype: torch.dtype, bh: int, bh_kv: int, s: int, d: int,
                 sms: int, block_m: Optional[int] = None,
                 clusters: Optional[int] = None) -> Tuple[BwdPlan, BwdPlan]:
    """How ``flash_bwd_dq_tri`` and ``flash_bwd_dkv_tri`` launch for bh q
    rows, bh_kv kv rows, s tokens and head dim d: (dq plan, dkv plan).

    bf16 and fp16 run the tensor-core pair (one plan for both). A dq CTA
    owns 64 or 128 q rows (one or two consumer warpgroups) of one (batch,
    head) row and walks 64-key tiles; a dkv CTA owns 64 or 128 keys of one
    kv row and walks 64-row q tiles of every GQA member. Each takes 128
    once its grid fills one wave of CTAs on the card's ``sms`` streaming
    multiprocessors, else 64, so
    that small grids keep more CTAs — or both take the height ``block_m``
    forces (64 or 128; threads, grids and shared memory follow from it);
    plus a producer warp (dq) or
    warpgroup (dkv). Shared memory: its own side's two tiles (Q and dO, or
    K and V), ``TRI_BWD_STAGES`` pairs of the ring's 64-row tiles (dkv:
    with their f32 lse and delta), 1 KiB of alignment slack and five
    mbarriers. Swizzle: the span of a row of one TMA box (32 B at d 16,
    64 B at d 32, 128 B at d 64 and wider). At d 256, 512 and 576 both
    take 64-row tiles (``TILE_HEIGHTS``), and a dkv CTA has two consumer
    warpgroups, each on a share of its columns (:func:`kv_split`); at d
    512 and 576 the ring is one stage of 32-row
    tiles (:func:`ring_rows`) and two (512) or three (576) CTAs share each
    own-side tile, one per column slice (``col_split``, the grid's z). f32
    keeps the CUDA-core kernels' fixed plans (``block_m`` 64 only; 64-row
    tiles; rows on the grid's y, which the kernels split into z slices of
    65,535): up to d 128 one CTA a tile, at 256 and above the slab CTAs of
    a tile in one thread-block cluster (:func:`wide_bwd_plans`, dK/dV's GQA
    walk split by the card's resident ``clusters``); any other ``block_m``
    raises ``ValueError``. bf16 and fp16 up to d 256 split dK/dV's GQA walk
    likewise, given the card's resident dK/dV CTAs as ``clusters`` (the
    split's parts on the grid's x), and at d 256 a dK/dV CTA holds
    ``DKV_EXCHANGE_BYTES`` more for its warpgroups' exchange of P^T and
    dS^T. The kernels check the plan against their own layout and refuse
    one that differs."""
    return _bwd_plans(dtype, bh, bh_kv, s, d, sms, True, None, False, block_m, clusters)


def band(causal: bool, window: Optional[int], s: int) -> Optional[int]:
    """The window as the kernels read it: a band of causal attention only,
    and one of s or more keys is no band at all (None)."""
    return window if causal and window is not None and 0 < window < s else None


def rect_bwd_plan(dtype: torch.dtype, bh: int, bh_kv: int, s: int, d: int, sms: int,
                  causal: bool, window: Optional[int] = None,
                  block_m: Optional[int] = None,
                  clusters: Optional[int] = None) -> Tuple[BwdPlan, BwdPlan]:
    """How ``flash_bwd_dq_rect`` and ``flash_bwd_dkv_rect`` launch: the
    triangle pair's tile heights (or the one ``block_m`` forces), threads,
    grids and swizzle (:func:`tri_bwd_plan`), and shared memory for the ring tiles' segment
    ids besides (per stage the ring tile's int32 ids and their min and max
    id: ``SEG_BYTES`` below d 512), whether or not the call has ids. The
    walks follow the masks:
    full attention walks every tile, a window (:func:`band`) its band, plain
    causal the triangle; only plain-causal 16-bit dq launches heaviest
    first. ``clusters`` as :func:`tri_bwd_plan`'s."""
    return _bwd_plans(dtype, bh, bh_kv, s, d, sms, causal, band(causal, window, s), True,
                      block_m, clusters)


def _check_bwd(qb, kb, vb, dout, lse, delta, heads: int, kv_heads: int, seg=None) -> None:
    _check(qb, kb, vb, heads, kv_heads)
    if kb.shape[1] != qb.shape[1]:
        raise ValueError(f"the backward kernels need sq == sk, got {qb.shape[1]} and {kb.shape[1]}")
    if not (dout.is_cuda and dout.is_contiguous()) or dout.shape != qb.shape or dout.dtype != qb.dtype:
        raise ValueError(f"dout must be a contiguous CUDA tensor like q {tuple(qb.shape)} "
                         f"{qb.dtype}, got {tuple(dout.shape)} {dout.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if not (t.is_cuda and t.is_contiguous()) or t.dtype != torch.float32 or t.shape != qb.shape[:2]:
            raise ValueError(f"{name} must be a contiguous float32 CUDA tensor of shape "
                             f"{tuple(qb.shape[:2])}, got {t.dtype} {tuple(t.shape)}")
    if seg is not None:
        _check_seg(seg, qb.shape[0] // heads, qb.shape[1], kb.shape[1])


def _lib(dtype: torch.dtype, d: int) -> ctypes.CDLL:
    """The library of ``dtype``'s kernels at head dim ``d`` with its C
    signatures declared (built on its first call):
    ``flash_fwd.library_name``."""
    return _load(library_name("flash_bwd", dtype, d))


@functools.cache
def _load(name: str) -> ctypes.CDLL:
    lib = build.load(name)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tensors = [ptr] * 6  # q, k, v, dout, lse, delta
    shape = [i32] * 6    # dtype, rows, s, d, heads, kv_heads
    plan = [i32] * 3     # block, smem bytes, swizzle
    masks = [i32, i32]   # causal, window
    scales = [f32, f32]  # qscale, scale
    lib.flash_bwd_dq_tri.argtypes = tensors + [ptr] + shape + scales + plan + [ptr]
    split = [ptr, i32]   # dK/dV: the partials and the walk's parts
    lib.flash_bwd_dkv_tri.argtypes = tensors + [ptr, ptr] + shape + scales + plan + split + [ptr]
    lib.flash_bwd_dq_rect.argtypes = tensors + [ptr, ptr] + shape + masks + scales + plan + [ptr]
    lib.flash_bwd_dkv_rect.argtypes = (tensors + [ptr] * 3 + shape + masks + scales + plan + split
                                       + [ptr])
    for fn in (lib.flash_bwd_dq_tri, lib.flash_bwd_dkv_tri, lib.flash_bwd_dq_rect,
               lib.flash_bwd_dkv_rect):
        fn.restype = i32
    return lib


@functools.cache
def _ctas_per_sm(dtype: torch.dtype, d: int, tri: bool, block: int, smem: int,
                 device: int) -> int:
    fn = _lib(dtype, d).flash_bwd_dkv_ctas_per_sm
    fn.argtypes, fn.restype = [ctypes.c_int] * 4, ctypes.c_int
    with torch.cuda.device(device):
        n = fn(int(tri), d, block, smem)
    if n <= 0:
        raise RuntimeError(f"{dtype} dK/dV at head dim {d}, block {block}: occupancy query "
                           f"returned {n}")
    return n


def dkv_resident_ctas(dtype: torch.dtype, d: int, tri: bool, plan: BwdPlan,
                      device: int = 0) -> int:
    """How many CTAs of the 16-bit dK/dV kernel (the triangle pair's with
    ``tri``) at head dim ``d`` (up to 256) and ``plan``'s tile height and
    shared memory the card ``device`` holds at once: its SMs times
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` (shared memory,
    registers and threads). Raises where the query fails."""
    return _sm_count(device) * _ctas_per_sm(dtype, d, tri, plan.block, plan.smem_bytes, device)


def f32_wide_active_clusters(d: int, kernel: str, tri: bool) -> int:
    """How many clusters of the f32 ``kernel`` ("dq" or "dkv"; the triangle
    pair's with ``tri``, else the general pair's) at head dim ``d`` the
    current card holds at once: at 256 and above (a multiple of 64)
    ``cudaOccupancyMaxActiveClusters`` at its plan's shared memory and
    cluster size; at 32, 64 and 128 (one CTA a tile, a cluster of one)
    its SMs times ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``. Raises
    where the query fails."""
    fn = _lib(torch.float32, d).flash_bwd_f32_wide_clusters
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
    n = fn(int(kernel == "dq"), int(tri), d)
    if n <= 0:
        raise RuntimeError(f"f32 wide {kernel} at head dim {d}: cluster occupancy query "
                           f"returned {n}")
    return n


def wide16_active_clusters(dtype: torch.dtype, d: int, kernel: str, tri: bool) -> int:
    """How many clusters of the bf16 or fp16 ``kernel`` ("dq" or "dkv"; the
    triangle pair's with ``tri``) at head dim ``d`` above 576 (a multiple of
    64) the current card holds at once: ``cudaOccupancyMaxActiveClusters``
    at its plan's shared memory and cluster size. Raises where the query
    fails."""
    fn = _lib(dtype, d).flash_bwd_wide16_clusters
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
    n = fn(int(kernel == "dq"), int(tri), d)
    if n <= 0:
        raise RuntimeError(f"{dtype} wide {kernel} at head dim {d}: cluster occupancy query "
                           f"returned {n}")
    return n


def _launch(name: str, qb, kb, vb, dout, lse, delta, outputs, rows: int, heads: int,
            kv_heads: int, plan: BwdPlan, extra=(), sm_scale: Optional[float] = None) -> None:
    """Launch ``name`` with ``plan`` on the current stream; ``extra`` sits
    between the shape arguments and the two scales (the rect kernels'
    causal/window); ``sm_scale`` is the softmax scale (default 1/√d). dK/dV
    passes its plan's split and, above 1, fresh partials
    (:meth:`BwdPlan.workspace`), which the library adds into ``outputs``."""
    _, s, d = qb.shape
    scale = 1.0 / math.sqrt(d) if sm_scale is None else sm_scale
    split = ()
    if plan.kernel == "dkv":
        shape = plan.workspace(s, d)
        parts = None if shape is None else torch.empty(shape, dtype=torch.float32,
                                                       device=qb.device)
        split = (None if parts is None else parts.data_ptr(), plan.split)
    with torch.cuda.device(qb.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(_lib(qb.dtype, d), name)(
            qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), *outputs, _DTYPES[qb.dtype], rows, s, d, heads, kv_heads,
            *extra, _qscale(d, scale), scale, plan.block, plan.smem_bytes,
            plan.swizzle, *split, stream,
        )
    _raise_on(code, name)


def _plans(qb, kb, vb, dout, lse, delta, heads: int, kv_heads: int, rect=None,
           block_m: Optional[int] = None, dkv: bool = False):
    """Checks of a pair's inputs (16-byte bases, for TMA or the f32
    kernels' cp.async, but at f32's whole-row d 16) and its (dq, dkv)
    launch plans on this card at the tile height ``block_m`` (None: the
    plan's): the triangle pair's, or with
    ``rect`` = (causal, window, seg) the general pair's. ``dkv``: for a
    dK/dV launch, whose plan splits its GQA walk by the card's resident
    clusters (f32) or CTAs (16-bit up to d 256)."""
    _check_bwd(qb, kb, vb, dout, lse, delta, heads, kv_heads, None if rect is None else rect[2])
    bh, s, d = qb.shape
    f32_tiles = qb.dtype == torch.float32 and d != F32_WHOLE_ROW_D  # 16-byte cp.async copies
    tensor_cores = qb.dtype in TENSOR_CORE_DTYPES
    if tensor_cores or f32_tiles:
        _check_tma_bases(q=qb, k=kb, v=vb, dout=dout)
    sms = _sm_count(qb.device.index)

    def plans(clusters=None):
        if rect is None:
            return tri_bwd_plan(qb.dtype, bh, kb.shape[0], s, d, sms, block_m, clusters)
        return rect_bwd_plan(qb.dtype, bh, kb.shape[0], s, d, sms, rect[0], rect[1], block_m,
                             clusters)

    if dkv and f32_tiles:
        return plans(f32_wide_active_clusters(d, "dkv", rect is None))
    if dkv and tensor_cores and col_split(d) == 1 and not is_wide(d):
        # the split's R: the unsplit kernel's resident CTAs (a split changes
        # the grid, not the kernel)
        return plans(dkv_resident_ctas(qb.dtype, d, rect is None, plans()[1], qb.device.index))
    return plans()


def flash_bwd_dq_tri(qb, kb, vb, out, dout, lse, delta, heads: int, kv_heads: int,
                     block_m: Optional[int] = None, sm_scale: Optional[float] = None):
    """Plain-causal dQ: the port of ``_flash_dq_tri_kernel``. ``block_m``
    forces the tile height (checked on the CPU too, where it changes
    nothing); ``sm_scale`` is the softmax scale (default 1/√d; a padded
    head passes its true head dim's)."""
    check_block_m(qb.dtype, block_m, qb.shape[-1])
    if not qb.is_cuda:
        return attention_bwd_plain(qb, kb, vb, out, lse, dout, heads, kv_heads, True,
                                   sm_scale=sm_scale)[0]
    plan, _ = _plans(qb, kb, vb, dout, lse, delta, heads, kv_heads, block_m=block_m)
    dq = torch.empty_like(qb)
    _launch("flash_bwd_dq_tri", qb, kb, vb, dout, lse, delta, (dq.data_ptr(),),
            qb.shape[0], heads, kv_heads, plan, sm_scale=sm_scale)
    flash_bwd_dq_tri.launches += 1
    return dq


def flash_bwd_dkv_tri(qb, kb, vb, out, dout, lse, delta, heads: int, kv_heads: int,
                      block_m: Optional[int] = None, sm_scale: Optional[float] = None):
    """Plain-causal (dK, dV), a GQA group summed per kv head: the port of
    ``_flash_dkv_tri_kernel``; ``block_m`` and ``sm_scale`` as
    :func:`flash_bwd_dq_tri`'s."""
    check_block_m(qb.dtype, block_m, qb.shape[-1])
    if not qb.is_cuda:
        return attention_bwd_plain(qb, kb, vb, out, lse, dout, heads, kv_heads, True,
                                   sm_scale=sm_scale)[1:]
    _, plan = _plans(qb, kb, vb, dout, lse, delta, heads, kv_heads, block_m=block_m, dkv=True)
    dk, dv = torch.empty_like(kb), torch.empty_like(vb)
    _launch("flash_bwd_dkv_tri", qb, kb, vb, dout, lse, delta, (dk.data_ptr(), dv.data_ptr()),
            kb.shape[0], heads, kv_heads, plan, sm_scale=sm_scale)
    flash_bwd_dkv_tri.launches += 1
    flash_bwd_dkv_tri.split_sums += plan.split > 1
    return dk, dv


def flash_bwd_dq_rect(qb, kb, vb, out, dout, lse, delta, heads: int, kv_heads: int,
                      causal: bool, window: Optional[int] = None,
                      seg: Optional[torch.Tensor] = None, block_m: Optional[int] = None,
                      sm_scale: Optional[float] = None):
    """dQ for causal or full attention, a window, segment ids (B, S) int32:
    the port of ``_flash_dq_kernel``; ``block_m`` and ``sm_scale`` as
    :func:`flash_bwd_dq_tri`'s."""
    check_block_m(qb.dtype, block_m, qb.shape[-1])
    if not qb.is_cuda:
        return attention_bwd_plain(qb, kb, vb, out, lse, dout, heads, kv_heads, causal,
                                   window, seg, sm_scale)[0]
    plan, _ = _plans(qb, kb, vb, dout, lse, delta, heads, kv_heads, (causal, window, seg),
                     block_m)
    dq = torch.empty_like(qb)
    _launch("flash_bwd_dq_rect", qb, kb, vb, dout, lse, delta,
            (None if seg is None else seg.data_ptr(), dq.data_ptr()), qb.shape[0], heads,
            kv_heads, plan, (int(causal), 0 if window is None else int(window)), sm_scale)
    flash_bwd_dq_rect.launches += 1
    return dq


def flash_bwd_dkv_rect(qb, kb, vb, out, dout, lse, delta, heads: int, kv_heads: int,
                       causal: bool, window: Optional[int] = None,
                       seg: Optional[torch.Tensor] = None, block_m: Optional[int] = None,
                       sm_scale: Optional[float] = None):
    """(dK, dV) for causal or full attention, a window, segment ids, GQA:
    the port of ``_flash_dkv_kernel``; ``block_m`` and ``sm_scale`` as
    :func:`flash_bwd_dq_tri`'s."""
    check_block_m(qb.dtype, block_m, qb.shape[-1])
    if not qb.is_cuda:
        return attention_bwd_plain(qb, kb, vb, out, lse, dout, heads, kv_heads, causal,
                                   window, seg, sm_scale)[1:]
    _, plan = _plans(qb, kb, vb, dout, lse, delta, heads, kv_heads, (causal, window, seg),
                     block_m, dkv=True)
    dk, dv = torch.empty_like(kb), torch.empty_like(vb)
    _launch("flash_bwd_dkv_rect", qb, kb, vb, dout, lse, delta,
            (None if seg is None else seg.data_ptr(), dk.data_ptr(), dv.data_ptr()),
            kb.shape[0], heads, kv_heads, plan, (int(causal), 0 if window is None else int(window)),
            sm_scale)
    flash_bwd_dkv_rect.launches += 1
    flash_bwd_dkv_rect.split_sums += plan.split > 1
    return dk, dv


flash_bwd_dq_tri.launches = 0
flash_bwd_dkv_tri.launches = 0
flash_bwd_dq_rect.launches = 0
flash_bwd_dkv_rect.launches = 0
flash_bwd_dkv_tri.split_sums = 0
flash_bwd_dkv_rect.split_sums = 0
