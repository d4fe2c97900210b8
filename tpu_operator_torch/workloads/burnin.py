"""Slice burn-in transformer and its train step (port of
``tpu_operator/workloads/burnin.py``).

The flagship workload: a small pre-norm transformer, float32 master
weights cast to the compute dtype at use, trained by plain SGD
(:func:`build_train_step`, :func:`run_burnin`). Attention runs either
dense (O(S^2), the reference's baseline) or through the flash kernels
(``use_flash_attention``), which on the card are the hand-written CUDA
forward and FlashAttention-2 backward kernels. One device, no mesh: the
sharded step, the ring (``sequence_parallel``) and the mixture of experts
come with later slices.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from tpu_operator_torch.device import DeviceLike, resolve_device
from tpu_operator_torch.weights import burnin_params

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


def build_train_step(cfg: Optional[BurninConfig] = None, device: DeviceLike = None,
                     params: Optional[Mapping[str, np.ndarray]] = None,
                     batch: Optional[Sequence[np.ndarray]] = None):
    """Returns (step, params, batch): the SGD train step on one device and
    ready-to-run inputs. ``step(params, batch)`` returns (new params, the
    loss before the update). ``params`` may be the reference's weights as
    numpy arrays and ``batch`` its (x, target) arrays; otherwise both come
    from fixed seeds (the reference's distributions, not its bits)."""
    cfg = cfg or BurninConfig()
    if cfg.kv_heads and cfg.n_heads % cfg.kv_heads:
        raise ValueError(
            f"n_heads ({cfg.n_heads}) must be a multiple of kv_heads ({cfg.kv_heads})"
        )
    if cfg.packed_segments and not cfg.use_flash_attention:
        raise ValueError(
            "packed_segments needs a segment-aware attention path — set "
            "use_flash_attention (within-chip kernel) or sequence_parallel "
            "(ids circulate the ring)"
        )
    if cfg.packed_segments and cfg.packed_segments > cfg.seq_len:
        raise ValueError(
            f"packed_segments ({cfg.packed_segments}) exceeds seq_len ({cfg.seq_len})"
        )
    dev = resolve_device(device)
    if params is None:
        weights = init_params(torch.Generator().manual_seed(0), cfg, dev)
    else:
        weights = burnin_params(params, cfg, dev)
    shape = (cfg.batch, cfg.seq_len, cfg.d_model)
    if batch is None:
        x, target = (torch.randn(shape, generator=torch.Generator().manual_seed(seed))
                     for seed in (1, 2))
    else:
        x, target = (torch.from_numpy(np.array(a, dtype=np.float32)) for a in batch)
        if x.shape != shape or target.shape != shape:
            raise ValueError(f"batch arrays must be {shape}, got {tuple(x.shape)}, "
                             f"{tuple(target.shape)}")
    data = (x.to(dev, cfg.tdtype), target.to(dev, cfg.tdtype))

    def step(params, batch):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = loss_fn(leaves, batch, cfg)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        new_params = {
            k: (p - cfg.learning_rate * g.to(p.dtype)).detach()
            for (k, p), g in zip(leaves.items(), grads)
        }
        return new_params, loss.detach()

    return step, weights, data


def run_burnin(steps: int = 3, cfg: Optional[BurninConfig] = None,
               record_telemetry: bool = False, telemetry_host: str = "",
               device: DeviceLike = None) -> dict:
    """Run a few train steps; the loss must be finite and decreasing.
    ``record_telemetry`` attaches a per-step timing report (warm-up vs
    steady split, jitter percentiles, achieved TFLOP/s)."""
    cfg = cfg or BurninConfig()
    dev = resolve_device(device)
    step, params, batch = build_train_step(cfg, dev)
    recorder = None
    if record_telemetry:
        from tpu_operator_torch.workloads.telemetry import (
            StepTimeRecorder,
            burnin_flops_per_step,
        )

        recorder = StepTimeRecorder(
            flops_per_step=burnin_flops_per_step(cfg), host=telemetry_host
        )
    losses = []
    for _ in range(steps):
        if recorder is not None:
            with recorder.step():
                params, loss = step(params, batch)
                loss = float(loss)  # force inside the timed region
        else:
            params, loss = step(params, batch)
            loss = float(loss)
        losses.append(loss)
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite loss during burn-in: {losses}")
    if steps >= 2 and not losses[-1] < losses[0]:
        raise RuntimeError(f"loss failed to decrease: {losses}")
    result = {"device": str(dev), "losses": losses, "ok": True}
    if recorder is not None:
        result["telemetry"] = recorder.report().to_dict()
    return result
