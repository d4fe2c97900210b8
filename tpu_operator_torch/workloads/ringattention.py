"""Attention reference of the port (from ``tpu_operator/workloads/ringattention.py``).

Only the dense O(S^2) oracle is ported so far; the ring itself comes with
the sharded slice.
"""

from __future__ import annotations

import math

import torch


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
