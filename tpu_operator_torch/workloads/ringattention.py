"""Ring attention: sequence-parallel attention over a ring of ranks (port
of ``tpu_operator/workloads/ringattention.py``).

Each rank holds one chunk of the sequence of q, k and v. Every step it
attends its q chunk against the K/V chunk it currently holds, then passes
that chunk one rank on round the ring (``spmd.ring_shift``: point-to-point
to the next rank of the group, the gradients travelling back the other
way). An online softmax (running max and sum) keeps the result exact.

- :func:`_ring_attention_local` is differentiable, with grouped-query
  attention, packed-sequence segment ids (a copy of the k-side ids
  circulates with its K/V chunk, without a gradient) and a causal
  window, which also bands the ring (:func:`_ring_hops`);
- :func:`_ring_attention_local_flash` is forward-only: each step runs
  ``flash_attention_with_lse`` at the chunks' global offsets and merges
  the per-step (out, lse) pairs by logsumexp.

The functions take the rank's own chunks; a mesh axis (or a process
group) names the ring.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from tpu_operator_torch.workloads.spmd import all_gather_cat, named_mesh, ring_shift, world_size


def _block_attend(q, k, v, q_block_idx: int, kv_block_idx: int, s_local: int, causal: bool,
                  state, q_seg=None, k_seg=None, window: Optional[int] = None):
    """Accumulate attention of local q against one K/V block with the
    online-softmax recurrence; state = (acc, row_sum, row_max).
    ``q_seg``/``k_seg`` (B, Sq)/(B, Sk) restrict attention to same-segment
    pairs; ``window`` keeps only 0 <= q-k < window. The running max is a
    stabiliser and takes no gradient (the result does not depend on it)."""
    acc, row_sum, row_max = state
    scale = 1.0 / math.sqrt(q.shape[-1])
    b, sq, h, d = q.shape
    h_kv = k.shape[2]
    g = h // h_kv  # grouped-query attention: q heads pair with their KV head
    qg = q.reshape(b, sq, h_kv, g, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).reshape(b, h, sq, -1) * scale
    keep = None
    if causal:
        pos = torch.arange(s_local, device=q.device)
        q_pos = q_block_idx * s_local + pos[:, None]
        k_pos = kv_block_idx * s_local + pos[None, :]
        keep = q_pos >= k_pos
        if window is not None:
            keep &= q_pos - k_pos < window
        keep = keep[None, None]  # (1, 1, Sq, Sk)
    if q_seg is not None:
        same = (q_seg[:, :, None] == k_seg[:, None, :])[:, None]  # (B, 1, Sq, Sk)
        keep = same if keep is None else keep & same
    if keep is not None:
        scores = scores.masked_fill(~keep, -math.inf)
    new_max = torch.maximum(row_max, scores.detach().amax(dim=-1))  # (B, H, Sq)
    # fully-masked rows: exp(-inf - -inf) must give 0, not nan
    safe_max = torch.where(torch.isneginf(new_max), 0.0, new_max)
    correction = torch.exp(torch.where(torch.isneginf(row_max), -math.inf, row_max - safe_max))
    probs = torch.exp(scores - safe_max[..., None])
    new_sum = row_sum * correction + probs.sum(dim=-1)
    pg = probs.reshape(b, h_kv, g, sq, -1)
    blk_out = torch.einsum("bhgqk,bkhd->bqhgd", pg, v).reshape(b, sq, h, d)
    new_acc = acc * correction.transpose(1, 2)[..., None] + blk_out
    return new_acc, new_sum, new_max


def _ring_hops(n: int, s_local: int, window: Optional[int]) -> int:
    """Ring steps a causal window needs: K/V blocks more than
    ceil((window + s_local - 1) / s_local) hops behind never contribute.
    The full ring when unwindowed."""
    if window is None:
        return n
    return min(n, (window + s_local - 2) // s_local + 1)


def _ring_size(group):
    if group is None:
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def _ring_attention_local(q, k, v, seg=None, *, group, causal: bool,
                          window: Optional[int] = None):
    """The rank's body: q/k/v (B, S_local, H, D) chunks (k/v may have
    fewer heads); ``seg`` (B, S_local) packed-sequence ids of the chunk,
    serving the q side while a copy circulates with the K/V chunk;
    ``window`` (causal only) stops the rotation once the circulating chunk
    is older than every local row's window. The last chunk is not passed
    on."""
    n, my_idx = _ring_size(group)
    b, s_local, h, d = q.shape
    qf = q.float()
    acc = torch.zeros_like(qf)
    row_sum = torch.zeros((b, h, s_local), dtype=torch.float32, device=q.device)
    state = (acc, row_sum, torch.full_like(row_sum, -math.inf))
    k_blk, v_blk, k_seg = k, v, seg
    hops = _ring_hops(n, s_local, window)
    for t in range(hops):
        kv_idx = (my_idx - t) % n
        state = _block_attend(qf, k_blk.float(), v_blk.float(), my_idx, kv_idx, s_local, causal,
                              state, q_seg=seg, k_seg=k_seg, window=window)
        if t < hops - 1:
            k_blk, v_blk = ring_shift((k_blk, v_blk), group)
            if seg is not None:
                (k_seg,) = ring_shift((k_seg,), group)
    acc, row_sum, _ = state
    denom = torch.where(row_sum == 0.0, 1.0, row_sum)
    return (acc / denom.transpose(1, 2)[..., None]).to(q.dtype)


@torch.no_grad()
def _ring_attention_local_flash(q, k, v, *, group, causal: bool, block_q: int = 256,
                                block_k: int = 256):
    """The rank's body with the flash forward as each step's local
    attention (global offsets keep the causal mask right across ranks);
    per-step normalised (out, lse) pairs merge by logsumexp. Forward-only
    (the validator's exactness payload)."""
    from tpu_operator_torch.workloads.flashattention import flash_attention_with_lse

    n, my_idx = _ring_size(group)
    b, s_local, h, d = q.shape
    out = torch.zeros((b, s_local, h, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b, s_local, h), -math.inf, dtype=torch.float32, device=q.device)
    k_blk, v_blk = k, v
    for t in range(n):
        kv_idx = (my_idx - t) % n
        o_j, lse_j = flash_attention_with_lse(
            q, k_blk, v_blk, causal=causal, block_q=block_q, block_k=block_k,
            q_start=my_idx * s_local, k_start=kv_idx * s_local,
        )
        # o = (o_a·e^(lse_a−m) + o_b·e^(lse_b−m)) / (e^(lse_a−m) + e^(lse_b−m))
        m = torch.maximum(lse, lse_j)
        safe_m = torch.where(torch.isneginf(m), 0.0, m)
        w_old = torch.exp(torch.where(torch.isneginf(lse), -math.inf, lse - safe_m))
        w_new = torch.exp(torch.where(torch.isneginf(lse_j), -math.inf, lse_j - safe_m))
        denom = w_old + w_new
        safe_denom = torch.where(denom == 0.0, 1.0, denom)
        out = (out * w_old[..., None] + o_j.float() * w_new[..., None]) / safe_denom[..., None]
        lse = torch.where(denom > 0.0, safe_m + torch.log(safe_denom), -math.inf)
        if t < n - 1:
            k_blk, v_blk = ring_shift((k_blk, v_blk), group)
    return out.to(q.dtype)


_LOCAL_IMPLS = {"dense": _ring_attention_local, "flash": _ring_attention_local_flash}


def ring_attention(q, k, v, mesh, axis_name: str = "sp", causal: bool = True,
                   local_impl: str = "dense", segment_ids=None,
                   window: Optional[int] = None):
    """Sequence-parallel attention on the rank's chunks: q (B, S_local, H,
    D), k/v (B, S_local, H_kv, D), the ring over ``mesh``'s ``axis_name``
    (chunk i of the sequence on the axis' rank i); returns the rank's
    output chunk. ``local_impl="flash"`` runs the flash forward per step
    (forward-only). ``segment_ids`` (B, S_local) restricts attention to
    same-segment pairs across the ring; ``window`` (causal) bands it.
    Both need the dense body. Grouped-query attention circulates only the
    H_kv heads."""
    if q.shape[2] % k.shape[2]:
        raise ValueError(
            f"q heads ({q.shape[2]}) must be a multiple of kv heads ({k.shape[2]})"
        )
    if v.shape != k.shape:
        raise ValueError(f"k and v shapes must match: {tuple(k.shape)} vs {tuple(v.shape)}")
    local_kwargs = {}
    if segment_ids is not None or window is not None:
        if local_impl != "dense":
            raise ValueError(
                "segment_ids/window require local_impl='dense' (the flash lse "
                "entry point carries neither path)"
            )
    if window is not None:
        if not causal or window < 1:
            raise ValueError("window requires causal attention and window >= 1")
        local_kwargs["window"] = window
    if segment_ids is not None and tuple(segment_ids.shape) != tuple(q.shape[:2]):
        raise ValueError(
            f"segment_ids must be (batch, seq) = {tuple(q.shape[:2])}, "
            f"got {tuple(segment_ids.shape)}"
        )
    group = mesh.get_group(axis_name)
    if segment_ids is not None:
        return _ring_attention_local(q, k, v, segment_ids.to(torch.int32), group=group,
                                     causal=causal, **local_kwargs)
    return _LOCAL_IMPLS[local_impl](q, k, v, group=group, causal=causal, **local_kwargs)


def dense_attention(q, k, v, causal: bool = True, segment_ids=None):
    """Reference O(S^2) attention for correctness checks, (B, S, H, D)
    layout with equal q and kv heads. ``segment_ids`` (B, S) restricts
    attention to same-segment pairs (packed sequences); a position always
    attends itself, so no row is ever fully masked."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        s = q.shape[1]
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, -math.inf)
    if segment_ids is not None:
        same = segment_ids[:, :, None] == segment_ids[:, None, :]  # (B, Q, K)
        scores = scores.masked_fill(~same[:, None, :, :], -math.inf)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)


def _check_local(group, device, *, causal, s_local, batch, heads, head_dim, local_impl):
    """The rank's check: its q/k/v chunks from seeds of its ring index,
    the ring, and a dense reference of its q chunk against the gathered
    K/V; returns the largest error over the ring."""
    n, idx = _ring_size(group)
    shape = (batch, s_local, heads, head_dim)
    q, k, v = (torch.randn(shape, generator=torch.Generator().manual_seed(3 * idx + j)).to(device)
               for j in range(3))
    ring = _LOCAL_IMPLS[local_impl](q, k, v, group=group, causal=causal)
    kg = all_gather_cat(k, group, dim=1)  # (B, S, H, D)
    vg = all_gather_cat(v, group, dim=1)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, kg) / math.sqrt(head_dim)
    if causal:
        q_pos = idx * s_local + torch.arange(s_local, device=device)[:, None]
        k_pos = torch.arange(kg.shape[1], device=device)[None, :]
        scores = scores.masked_fill(~(q_pos >= k_pos), -math.inf)
    dense = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), vg)
    err = (ring - dense).abs().max().reshape(1)
    if n > 1:
        dist.all_reduce(err, op=dist.ReduceOp.MAX, group=group)
    return float(err)


def run_ring_attention_check(
    mesh=None,
    batch: int = 2,
    seq_len: int = 256,
    heads: int = 2,
    head_dim: int = 32,
    causal: bool = True,
    local_impl: str = "dense",
) -> dict:
    """Validator payload: exactness of the ring against dense attention,
    float32. The ring is ``mesh``'s first axis (default: a 1-D ``sp`` mesh
    over the world); data, both attentions and the error reduction all
    run on the ranks, on the mesh's device."""
    if mesh is None:
        mesh = named_mesh(sp=world_size())
    axis_name = mesh.mesh_dim_names[0]
    n = mesh.mesh.shape[0]
    if seq_len % n:
        raise ValueError(f"seq_len {seq_len} not divisible by {n} devices")
    device = (torch.device("cuda", torch.cuda.current_device()) if mesh.device_type == "cuda"
              else torch.device("cpu"))
    err = _check_local(mesh.get_group(axis_name), device, causal=causal, s_local=seq_len // n,
                       batch=batch, heads=heads, head_dim=head_dim, local_impl=local_impl)
    # both paths compute in full float32 (TF32 off, as PyTorch's default)
    tolerance = 2e-4
    if err > tolerance:
        raise RuntimeError(f"ring attention mismatch vs dense: max abs err {err}")
    return {
        "devices": n,
        "seq_len": seq_len,
        "seq_per_device": seq_len // n,
        "max_abs_err": err,
        "causal": causal,
        "ok": True,
    }
