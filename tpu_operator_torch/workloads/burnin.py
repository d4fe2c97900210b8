"""Slice burn-in transformer, forward (port of ``tpu_operator/workloads/burnin.py``).

The flagship workload: a small pre-norm transformer, float32 master
weights cast to the compute dtype at use. Attention runs either dense
(O(S^2), the reference's baseline) or through the flash kernels
(``use_flash_attention``), which on the card are the hand-written CUDA
forward kernels. One device, no mesh: the sharded train step, the ring
(``sequence_parallel``) and the mixture of experts come with later slices.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch
import torch.nn.functional as F

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class BurninConfig:
    d_model: int = 256
    n_heads: int = 4
    d_ff: int = 1024
    seq_len: int = 128
    batch: int = 16
    n_layers: int = 2
    dtype: str = "bfloat16"
    learning_rate: float = 0.05
    # >0: grouped-query attention with this many KV heads (0 = multi-head)
    kv_heads: int = 0
    # ring attention over a sequence-parallel mesh axis: not ported yet
    sequence_parallel: bool = False
    # attention through the flash kernels instead of the dense path
    use_flash_attention: bool = False
    # >0: the sequence is split into this many packed documents and
    # attention stays within each (segment ids of the flash path)
    packed_segments: int = 0
    # routed mixture of experts: not ported yet
    moe_experts: int = 0
    moe_capacity_factor: float = 1.25

    def __post_init__(self):
        if self.sequence_parallel:
            raise NotImplementedError("sequence_parallel (ring attention) is not ported yet")
        if self.moe_experts:
            raise NotImplementedError("moe_experts (mixture of experts) is not ported yet")

    @property
    def tdtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def resolved_kv_heads(self) -> int:
        return self.kv_heads or self.n_heads

    @property
    def qkv_width(self) -> int:
        """Fused projection width: q (d_model) + k + v (kv_heads*head_dim each)."""
        head_dim = self.d_model // self.n_heads
        return self.d_model + 2 * self.resolved_kv_heads * head_dim


def init_params(generator: torch.Generator, cfg: BurninConfig,
                device: torch.device) -> Dict[str, torch.Tensor]:
    """Seeded float32 weights with the reference's distributions (not its
    bits: ``jax.random`` and ``torch.Generator`` draw different numbers;
    parity runs load the reference's weights through ``weights.py``)."""

    def normal(*shape, scale):
        return (torch.randn(shape, generator=generator, device=generator.device) * scale).to(device)

    params = {}
    d, f = cfg.d_model, cfg.d_ff
    s = 1.0 / math.sqrt(d)
    for layer in range(cfg.n_layers):
        params[f"l{layer}/qkv"] = normal(d, cfg.qkv_width, scale=s)
        params[f"l{layer}/proj"] = normal(d, d, scale=s)
        params[f"l{layer}/w1"] = normal(d, f, scale=s)
        params[f"l{layer}/w2"] = normal(f, d, scale=1.0 / math.sqrt(f))
        params[f"l{layer}/ln_scale"] = torch.ones((d,), dtype=torch.float32, device=device)
    params["out_norm"] = torch.ones((d,), dtype=torch.float32, device=device)
    return params


def _rmsnorm(x, scale):
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x.float() * torch.rsqrt(var + 1e-6)).to(x.dtype) * scale.to(x.dtype)


def _dense_ctx(q, k, v, d_head):
    """(b, s, h, dh) causal attention, dense O(S^2) path. The scores are
    float32 (the reference divides the compute-dtype product by a float32
    scalar), masked with float32's lowest value."""
    s = q.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(d_head)
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
    attn = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", attn, v)


def _packed_ids(batch: int, s: int, packed: int, device) -> torch.Tensor:
    """Synthetic packed-document segment ids: the sequence split into
    ``packed`` equal documents."""
    ids = (torch.arange(s, device=device) * packed // s).to(torch.int32)
    return ids.expand(batch, s).contiguous()


def _flash_ctx(q, k, v, packed: int = 0):
    """Local attention through the flash kernels, with the reference's
    block heuristic (the blocks only gate divisibility in the port)."""
    from tpu_operator_torch.workloads.autotune import tuned_flash_blocks
    from tpu_operator_torch.workloads.flashattention import flash_attention

    s = q.shape[1]
    block = min(s, 256 if s % 256 == 0 else 128)
    block_q, block_k = tuned_flash_blocks(
        s, heads=q.shape[2], head_dim=q.shape[3], default=(block, block), fwd_bwd=True,
    )
    seg = _packed_ids(q.shape[0], s, packed, q.device) if packed else None
    return flash_attention(q, k, v, causal=True, block_q=block_q, block_k=block_k,
                           segment_ids=seg)


def _block(params, layer: int, x, cfg: BurninConfig):
    b, s, d = x.shape
    h = cfg.n_heads
    prefix = f"l{layer}/"
    w = {key: params[key].to(cfg.tdtype) for key in params if key.startswith(prefix)}
    y = _rmsnorm(x, params[f"{prefix}ln_scale"])
    h_kv = cfg.resolved_kv_heads
    dh = d // h
    qkv = y @ w[f"{prefix}qkv"]
    q, k, v = torch.split(qkv, [d, h_kv * dh, h_kv * dh], dim=-1)
    q = q.reshape(b, s, h, dh)
    k = k.reshape(b, s, h_kv, dh)
    v = v.reshape(b, s, h_kv, dh)
    if cfg.use_flash_attention:
        ctx = _flash_ctx(q, k, v, packed=cfg.packed_segments)
    else:
        if h_kv != h:  # the O(S^2) baseline just repeats KV
            k = k.repeat_interleave(h // h_kv, dim=2)
            v = v.repeat_interleave(h // h_kv, dim=2)
        ctx = _dense_ctx(q, k, v, dh)
    ctx = ctx.reshape(b, s, d)
    x = x + ctx @ w[f"{prefix}proj"]
    y = _rmsnorm(x, params[f"{prefix}ln_scale"])
    return x + F.gelu(y @ w[f"{prefix}w1"], approximate="tanh") @ w[f"{prefix}w2"]


def forward(params, x, cfg: BurninConfig):
    for layer in range(cfg.n_layers):
        x = _block(params, layer, x, cfg)
    return _rmsnorm(x, params["out_norm"])


def loss_fn(params, batch, cfg: BurninConfig):
    x, target = batch
    out = forward(params, x, cfg)
    return (out.float() - target.float()).square().mean()
