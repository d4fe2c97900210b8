"""Slice burn-in transformer and its train step (port of
``tpu_operator/workloads/burnin.py``).

The flagship workload: a small pre-norm transformer, float32 master
weights cast to the compute dtype at use, trained by plain SGD
(:func:`build_train_step`, :func:`run_burnin`). Attention runs dense
(O(S^2), the reference's baseline), through the flash kernels
(``use_flash_attention``: on the card the hand-written CUDA forward and
FlashAttention-2 backward kernels), or as ring attention over a
sequence-parallel mesh axis (``sequence_parallel``). ``moe_experts`` > 0
replaces the dense FFN with a top-1 routed mixture of experts.

On a card the step is one CUDA graph replay (``_GraphedStep``), as the
reference runs it under ``jax.jit``, and on the CPU the eager step. With
``mesh=None`` it runs on one device; on a mesh
(:func:`make_mesh`, :func:`make_mesh_3d`, :func:`make_mesh_4d`: a
``DeviceMesh`` over the current process group) every rank holds only its
shard and runs the same program on it:

- the batch's rows over ``data``; its sequence over ``sp`` when
  ``sequence_parallel`` (otherwise it is replicated there);
- the Megatron layout over ``model`` (:func:`param_shardings`): the
  rank's own q, k and v heads of ``qkv``, ``w1``'s columns, the rows of
  ``proj`` and ``w2``;
- experts over ``ep`` and each expert's FFN over ``model``;
- norms and the router replicated.

Replicated tensors enter a sharded region through ``spmd.copy_to`` and
partial results leave it through ``spmd.reduce_from``; after the
backward, gradients are summed over the ranks that hold other tokens
(``data``, and ``sp`` under ``sequence_parallel``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tpu_operator_torch.device import DeviceLike, resolve_device
from tpu_operator_torch.weights import burnin_params
from tpu_operator_torch.workloads.spmd import (
    all_gather_cat,
    all_reduce_sum,
    axes_group,
    axis_index,
    axis_size,
    copy_to,
    mesh_axes,
    named_mesh,
    reduce_from,
    world_size,
)

# the compute dtypes a config may name (the reference's jnp.dtype(dtype));
# weights stay float32 and are cast at use
_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


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
    # shard the sequence over an 'sp' mesh axis and attend with ring
    # attention (workloads/ringattention.py)
    sequence_parallel: bool = False
    # attention through the flash kernels instead of the dense path
    use_flash_attention: bool = False
    # >0: the sequence is split into this many packed documents and
    # attention stays within each (the flash path's segment ids, or ids
    # circulating the ring under sequence_parallel)
    packed_segments: int = 0
    # >0: a top-1 routed mixture of experts (GShard one-hot dispatch)
    # replaces the dense FFN, experts sharded over an 'ep' mesh axis
    moe_experts: int = 0
    moe_capacity_factor: float = 1.25

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


# --------------------------------------------------------------------- meshes


def make_mesh(data: Optional[int] = None, model: Optional[int] = None):
    """2-D (data, model) mesh over the world. Defaults to the largest
    model axis up to 4 that divides the world size."""
    n = world_size()
    if model is None:
        model = max(m for m in (1, 2, 4) if n % m == 0)
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    return named_mesh(data=data, model=model)


def make_mesh_3d(data: int = 2, sp: int = 2, model: int = 2):
    """3-D (data, sp, model) mesh: dp x sequence-parallel x tp."""
    return named_mesh(data=data, sp=sp, model=model)


def make_mesh_4d(data: int = 1, sp: int = 2, model: int = 2, ep: int = 2):
    """4-D (data, sp, model, ep) mesh: dp x sequence-parallel x tp x
    expert-parallel."""
    return named_mesh(data=data, sp=sp, model=model, ep=ep)


def param_shardings(cfg: BurninConfig) -> Dict[str, Tuple[Optional[str], ...]]:
    """Megatron-style tensor parallel layout, one mesh axis (or None) per
    dimension: column-parallel in, row-parallel out, so each block needs
    one sum over ``model`` on the output projection. The fused ``qkv``
    is split by heads: a rank holds its own q heads, then its own k
    heads, then its own v heads (:func:`shard_burnin_params`)."""
    specs = {}
    for layer in range(cfg.n_layers):
        specs[f"l{layer}/qkv"] = (None, "model")
        specs[f"l{layer}/proj"] = ("model", None)
        if cfg.moe_experts:
            specs[f"l{layer}/router"] = (None, None)
            specs[f"l{layer}/moe_w1"] = ("ep", None, "model")
            specs[f"l{layer}/moe_w2"] = ("ep", "model", None)
        else:
            specs[f"l{layer}/w1"] = (None, "model")
            specs[f"l{layer}/w2"] = ("model", None)
        specs[f"l{layer}/ln_scale"] = (None,)
    specs["out_norm"] = (None,)
    return specs


def _qkv_parts(cfg: BurninConfig) -> List[int]:
    """Widths of q, k and v in the fused ``qkv``."""
    kv = cfg.resolved_kv_heads * (cfg.d_model // cfg.n_heads)
    return [cfg.d_model, kv, kv]


def _shard(arr: np.ndarray, spec, mesh, name: str) -> np.ndarray:
    for dim, axis in enumerate(spec):
        size = axis_size(mesh, axis) if axis else 1
        if size == 1:
            continue
        if arr.shape[dim] % size:
            raise ValueError(f"{name}: dimension {dim} ({arr.shape[dim]}) does not divide "
                             f"over the '{axis}' axis ({size})")
        part = arr.shape[dim] // size
        start = axis_index(mesh, axis) * part
        arr = np.take(arr, range(start, start + part), axis=dim)
    return arr


def shard_burnin_params(arrays: Mapping[str, np.ndarray], cfg: BurninConfig, mesh,
                        device) -> Dict[str, torch.Tensor]:
    """This rank's shards of the burn-in weights (given in the reference's
    global layout) under :func:`param_shardings`: ``qkv`` becomes the
    rank's own q heads, then its k heads, then its v heads (with GQA the
    rank's q heads are the ones that use its kv heads)."""
    global_ = {k: v.numpy() for k, v in burnin_params(arrays, cfg, "cpu").items()}
    out = {}
    for name, spec in param_shardings(cfg).items():
        arr = global_[name]
        if name.endswith("/qkv"):
            parts = np.split(arr, np.cumsum(_qkv_parts(cfg))[:-1], axis=1)
            arr = np.concatenate([_shard(p, spec, mesh, name) for p in parts], axis=1)
        else:
            arr = _shard(arr, spec, mesh, name)
        out[name] = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return out


def _gather(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    for dim, axis in enumerate(spec):
        if axis:
            t = all_gather_cat(t, axes_group(mesh, axis), dim)
    return t


def gather_burnin_params(params: Mapping[str, torch.Tensor], cfg: BurninConfig,
                         mesh) -> Dict[str, np.ndarray]:
    """The inverse of :func:`shard_burnin_params`: every rank's shards
    gathered into the reference's global layout, as float32 numpy arrays
    (a collective: every rank of the mesh calls it)."""
    out = {}
    for name, spec in param_shardings(cfg).items():
        t = params[name].detach().float()
        if name.endswith("/qkv"):
            local = [w // axis_size(mesh, "model") for w in _qkv_parts(cfg)]
            t = torch.cat([_gather(p.contiguous(), spec, mesh)
                           for p in torch.split(t, local, dim=1)], dim=1)
        else:
            t = _gather(t.contiguous(), spec, mesh)
        out[name] = t.cpu().numpy()
    return out


# ---------------------------------------------------------------------- model


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
        if cfg.moe_experts:
            e = cfg.moe_experts
            params[f"l{layer}/router"] = normal(d, e, scale=s)
            params[f"l{layer}/moe_w1"] = normal(e, d, f, scale=s)
            params[f"l{layer}/moe_w2"] = normal(e, f, d, scale=1.0 / math.sqrt(f))
        else:
            params[f"l{layer}/w1"] = normal(d, f, scale=s)
            params[f"l{layer}/w2"] = normal(f, d, scale=1.0 / math.sqrt(f))
        params[f"l{layer}/ln_scale"] = torch.ones((d,), dtype=torch.float32, device=device)
    params["out_norm"] = torch.ones((d,), dtype=torch.float32, device=device)
    return params


def seeded_params(cfg: BurninConfig) -> Dict[str, np.ndarray]:
    """The default start of :func:`build_train_step`: :func:`init_params`
    from seed 0, as float32 numpy arrays in the global layout."""
    return {k: v.numpy() for k, v in
            init_params(torch.Generator().manual_seed(0), cfg, "cpu").items()}


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


def _ring_ctx(q, k, v, mesh, packed: int = 0):
    """Sequence-parallel attention on the rank's shard: its batch rows,
    its heads and its sequence chunk, with the ring over ``sp``. Packed
    ids are the global sequence's, cut to the chunk; a copy circulates
    with its K/V block, so documents may span ranks."""
    from tpu_operator_torch.workloads.ringattention import _ring_attention_local

    seg = None
    if packed:
        b, s_local = q.shape[:2]
        start = axis_index(mesh, "sp") * s_local
        seg = _packed_ids(b, s_local * axis_size(mesh, "sp"), packed, q.device)
        seg = seg[:, start:start + s_local].contiguous()
    return _ring_attention_local(q, k, v, seg, group=axes_group(mesh, "sp"), causal=True)


def _flash_ctx(q, k, v, packed: int = 0):
    """Local attention through the flash kernels on the rank's batch rows
    and heads, with the reference's block heuristic (the blocks only gate
    divisibility in the port)."""
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


def _token_axes(cfg: BurninConfig) -> Tuple[str, ...]:
    """The mesh axes whose ranks hold different tokens of the batch."""
    return ("data", "sp") if cfg.sequence_parallel else ("data",)


def _moe_route(expert_idx, b: int, s: int, cfg: BurninConfig, mesh=None):
    """(position, keep, cap) of the rank's (b·s) tokens in the reference's
    global order. Capacity counts the GLOBAL tokens in (batch, sequence)
    order, so tokens on other ``data``/``sp`` ranks decide who is
    dropped: the ranks' expert choices are gathered (data-major, in one
    collective), the global order rebuilt, and the rank keeps its own
    rows."""
    sp = axis_size(mesh, "sp") if cfg.sequence_parallel else 1
    idx = all_gather_cat(expert_idx.reshape(1, b, s), axes_group(mesh, *_token_axes(cfg)), dim=0)
    idx = idx.reshape(-1, sp, b, s).transpose(1, 2).reshape(-1, sp * s)
    e = cfg.moe_experts
    t = idx.numel()
    cap = max(1, int(cfg.moe_capacity_factor * t / e))
    onehot = (idx.reshape(t, 1) == torch.arange(e, device=idx.device)).long()
    position = ((onehot.cumsum(0) - 1) * onehot).sum(-1).reshape(idx.shape)
    row = axis_index(mesh, "data") * b
    col = axis_index(mesh, "sp") * s if cfg.sequence_parallel else 0
    position = position[row:row + b, col:col + s].reshape(-1)
    return position, position < cap, cap


def _moe_ffn(params, layer: int, y, cfg: BurninConfig, mesh=None):
    """Top-1 routed mixture of experts, GShard one-hot dispatch: a
    (tokens, experts, capacity) one-hot places each kept token in its
    expert's buffer, each expert runs its FFN, and the gate-weighted
    combine brings the outputs back. Each token meets exactly one
    nonzero term in the dispatch and the combine. Capacity-dropped
    tokens pass through on the residual path; the router's gradient
    flows through the gate value.

    On a mesh the tokens are replicated over ``ep``: each ``ep`` rank
    runs its own experts (their FFN split over ``model``) on the kept
    tokens it holds, and the combine is summed over ``model`` and ``ep``.
    The tokens and gate values enter that partial region through
    ``copy_to`` over both axes."""
    b, s, d = y.shape
    t = b * s
    e = cfg.moe_experts
    dt = cfg.tdtype
    tokens = y.reshape(t, d)
    logits = tokens.float() @ params[f"l{layer}/router"].float()
    gates = torch.softmax(logits, dim=-1)
    gate_val, expert_idx = gates.max(dim=-1)  # the first maximum, as argmax
    position, keep, cap = _moe_route(expert_idx, b, s, cfg, mesh)
    e_local = e // axis_size(mesh, "ep")
    first = axis_index(mesh, "ep") * e_local
    mine = expert_idx.reshape(t, 1) == torch.arange(first, first + e_local, device=y.device)
    slot = position.reshape(t, 1) == torch.arange(cap, device=y.device)
    dispatch = ((mine & keep.reshape(t, 1)).to(dt)[:, :, None]
                * slot.to(dt)[:, None, :])  # (t, e_local, cap)
    group = axes_group(mesh, "model", "ep")
    expert_in = torch.einsum("tec,td->ecd", dispatch, copy_to(tokens, group))
    w1 = params[f"l{layer}/moe_w1"].to(dt)
    w2 = params[f"l{layer}/moe_w2"].to(dt)
    hidden = F.gelu(torch.einsum("ecd,edf->ecf", expert_in, w1), approximate="tanh")
    expert_out = torch.einsum("ecf,efd->ecd", hidden, w2)
    combine = dispatch * copy_to(gate_val, group)[:, None, None].to(dt)
    out = reduce_from(torch.einsum("tec,ecd->td", combine, expert_out), group)
    return out.reshape(b, s, d)


def _block(params, layer: int, x, cfg: BurninConfig, mesh=None):
    b, s, _ = x.shape
    model = axis_size(mesh, "model")
    dh = cfg.d_model // cfg.n_heads
    h, h_kv = cfg.n_heads // model, cfg.resolved_kv_heads // model  # the rank's heads
    tp = axes_group(mesh, "model")
    prefix = f"l{layer}/"
    used = ("qkv", "proj") if cfg.moe_experts else ("qkv", "proj", "w1", "w2")
    w = {name: params[prefix + name].to(cfg.tdtype) for name in used}
    y = _rmsnorm(x, params[f"{prefix}ln_scale"])
    qkv = copy_to(y, tp) @ w["qkv"]
    q, k, v = torch.split(qkv, [h * dh, h_kv * dh, h_kv * dh], dim=-1)
    q = q.reshape(b, s, h, dh)
    k = k.reshape(b, s, h_kv, dh)
    v = v.reshape(b, s, h_kv, dh)
    if cfg.sequence_parallel:
        ctx = _ring_ctx(q, k, v, mesh, packed=cfg.packed_segments)
    elif cfg.use_flash_attention:
        ctx = _flash_ctx(q, k, v, packed=cfg.packed_segments)
    else:
        if h_kv != h:  # the O(S^2) baseline just repeats KV
            k = k.repeat_interleave(h // h_kv, dim=2)
            v = v.repeat_interleave(h // h_kv, dim=2)
        ctx = _dense_ctx(q, k, v, dh)
    ctx = ctx.reshape(b, s, h * dh)
    x = x + reduce_from(ctx @ w["proj"], tp)
    y = _rmsnorm(x, params[f"{prefix}ln_scale"])
    if cfg.moe_experts:
        return x + _moe_ffn(params, layer, y, cfg, mesh)
    hidden = F.gelu(copy_to(y, tp) @ w["w1"], approximate="tanh")
    return x + reduce_from(hidden @ w["w2"], tp)


def forward(params, x, cfg: BurninConfig, mesh=None):
    """The model on one device, or on the rank's shards of ``params`` and
    ``x`` when ``mesh`` is given (the output is the rank's shard)."""
    for layer in range(cfg.n_layers):
        x = _block(params, layer, x, cfg, mesh)
    return _rmsnorm(x, params["out_norm"])


def loss_fn(params, batch, cfg: BurninConfig, mesh=None):
    """Mean squared error over the whole batch. On a mesh, the rank's
    share: its squared errors over the global element count, whose sum
    over the token axes is the mean."""
    x, target = batch
    out = forward(params, x, cfg, mesh)
    sq = (out.float() - target.float()).square()
    if mesh is None:
        return sq.mean()
    return sq.sum() / (cfg.batch * cfg.seq_len * cfg.d_model)


# ----------------------------------------------------------------- train step


def _check_config(cfg: BurninConfig, mesh) -> None:
    """The reference's configuration errors, then the port's own for a
    mesh (the port shards heads, d_ff and experts over every path, where
    the reference's compiler may reshard)."""
    axes = mesh_axes(mesh) if mesh is not None else {}
    if cfg.kv_heads and cfg.n_heads % cfg.kv_heads:
        raise ValueError(
            f"n_heads ({cfg.n_heads}) must be a multiple of kv_heads ({cfg.kv_heads})"
        )
    if cfg.sequence_parallel and "sp" not in axes:
        raise ValueError("sequence_parallel needs an 'sp' mesh axis (make_mesh_3d)")
    if cfg.sequence_parallel and cfg.use_flash_attention:
        raise ValueError(
            "sequence_parallel and use_flash_attention are separate attention "
            "paths — enable one (ring spans chips, flash blocks within one)"
        )
    if cfg.use_flash_attention or cfg.sequence_parallel:
        path = "use_flash_attention" if cfg.use_flash_attention else "sequence_parallel"
        if cfg.batch % axes.get("data", 1):
            raise ValueError(
                f"{path}: batch ({cfg.batch}) must divide over "
                f"the 'data' axis ({axes.get('data', 1)})"
            )
        if cfg.n_heads % axes.get("model", 1):
            raise ValueError(
                f"{path}: n_heads ({cfg.n_heads}) must divide "
                f"over the 'model' axis ({axes.get('model', 1)})"
            )
        if cfg.resolved_kv_heads % axes.get("model", 1):
            raise ValueError(
                f"{path}: kv_heads ({cfg.resolved_kv_heads}) must "
                f"divide over the 'model' axis ({axes.get('model', 1)})"
            )
        if cfg.sequence_parallel and cfg.seq_len % axes.get("sp", 1):
            raise ValueError(
                f"sequence_parallel: seq_len ({cfg.seq_len}) must divide "
                f"over the 'sp' axis ({axes.get('sp', 1)})"
            )
    if cfg.packed_segments and not (cfg.use_flash_attention or cfg.sequence_parallel):
        raise ValueError(
            "packed_segments needs a segment-aware attention path — set "
            "use_flash_attention (within-chip kernel) or sequence_parallel "
            "(ids circulate the ring)"
        )
    if cfg.packed_segments and cfg.packed_segments > cfg.seq_len:
        raise ValueError(
            f"packed_segments ({cfg.packed_segments}) exceeds seq_len ({cfg.seq_len})"
        )
    if mesh is None:
        return
    if cfg.moe_experts and "ep" not in axes:
        raise ValueError("moe_experts needs an 'ep' mesh axis (make_mesh_4d)")
    if cfg.moe_experts and cfg.moe_experts % axes.get("ep", 1):
        raise ValueError(
            f"moe_experts ({cfg.moe_experts}) must divide evenly over the "
            f"'ep' axis ({axes.get('ep')})"
        )
    model = axes.get("model", 1)
    for name, value, axis, size in (
        ("batch", cfg.batch, "data", axes.get("data", 1)),
        ("n_heads", cfg.n_heads, "model", model),
        ("kv_heads", cfg.resolved_kv_heads, "model", model),
        ("d_ff", cfg.d_ff, "model", model),
    ):
        if value % size:
            raise ValueError(f"{name} ({value}) must divide over the '{axis}' axis ({size}): "
                             f"the port shards it on every path")


def _seeded_batch(cfg: BurninConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    shape = (cfg.batch, cfg.seq_len, cfg.d_model)
    return tuple(torch.randn(shape, generator=torch.Generator().manual_seed(seed))
                 for seed in (1, 2))


def _local_rows(x: torch.Tensor, cfg: BurninConfig, mesh) -> torch.Tensor:
    """The rank's block of a global (batch, seq, d) array."""
    b = cfg.batch // axis_size(mesh, "data")
    x = x[axis_index(mesh, "data") * b:][:b]
    if cfg.sequence_parallel:
        s = cfg.seq_len // axis_size(mesh, "sp")
        x = x[:, axis_index(mesh, "sp") * s:][:, :s]
    return x


def build_train_step(cfg: Optional[BurninConfig] = None, device: DeviceLike = None,
                     params: Optional[Mapping[str, np.ndarray]] = None,
                     batch: Optional[Sequence[np.ndarray]] = None, *, mesh=None):
    """Returns (step, params, batch): the SGD train step and ready-to-run
    inputs. ``step(params, batch)`` returns (new params, the loss before
    the update); on a card a CUDA graph replay (``_GraphedStep``),
    over a mesh too. ``params`` may be the reference's weights as numpy
    arrays and ``batch`` its (x, target) arrays, in the global layout;
    otherwise both come from fixed seeds (the reference's distributions,
    not its bits). On a ``mesh`` every rank builds the same global
    weights and batch, keeps its shards, and the returned params and
    batch are those shards; the loss is the global one on every rank."""
    cfg = cfg or BurninConfig()
    _check_config(cfg, mesh)
    dev = resolve_device(device)
    if mesh is not None and mesh.device_type != dev.type:
        raise ValueError(f"a {mesh.device_type} mesh cannot run on {dev}")
    if params is None:
        params = seeded_params(cfg)
    weights = (burnin_params(params, cfg, dev) if mesh is None
               else shard_burnin_params(params, cfg, mesh, dev))
    shape = (cfg.batch, cfg.seq_len, cfg.d_model)
    if batch is None:
        x, target = _seeded_batch(cfg)
    else:
        x, target = (torch.from_numpy(np.array(a, dtype=np.float32)) for a in batch)
        if x.shape != shape or target.shape != shape:
            raise ValueError(f"batch arrays must be {shape}, got {tuple(x.shape)}, "
                             f"{tuple(target.shape)}")
    if mesh is not None:
        x, target = (_local_rows(a, cfg, mesh) for a in (x, target))
    data = (x.to(dev, cfg.tdtype), target.to(dev, cfg.tdtype))

    def step(params, batch):
        loss, grads = _loss_and_grads(params, batch, cfg, mesh)
        new_params = {
            k: (p - cfg.learning_rate * g.reshape(p.shape).to(p.dtype)).detach()
            for (k, p), g in zip(params.items(), grads)
        }
        return new_params, loss

    if dev.type == "cuda":
        return _GraphedStep(step, cfg, weights, data, mesh), weights, data
    return step, weights, data


def _load(static, given) -> None:
    """Copy ``given`` into the static tensors, skipping those it already is."""
    for dst, src in zip(static, given):
        if src is not dst:
            dst.copy_(src)


def _loss_and_grads(params: Mapping[str, torch.Tensor], batch, cfg: BurninConfig,
                    mesh=None) -> tuple:
    """The loss and one gradient per parameter, in order. On a mesh both
    are summed over the ranks that hold other tokens, in one flat
    all-reduce, so every rank gets the global loss and gradients."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = loss_fn(leaves, batch, cfg, mesh)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    if mesh is not None:
        flat = torch.cat([g.float().reshape(-1) for g in grads] + [loss.detach().reshape(1)])
        flat = all_reduce_sum(flat, axes_group(mesh, *_token_axes(cfg)))
        loss = flat[-1]
        grads = torch.split(flat[:-1], [g.numel() for g in grads])
    return loss.detach(), grads


def _sgd_update(params: Dict[str, torch.Tensor], batch, cfg: BurninConfig,
                mesh=None) -> torch.Tensor:
    """One SGD step on ``params`` in place (``p -= lr * g``, the eager
    step's arithmetic); returns the loss before the update."""
    loss, grads = _loss_and_grads(params, batch, cfg, mesh)
    with torch.no_grad():
        for p, g in zip(params.values(), grads):
            p.sub_(cfg.learning_rate * g.reshape(p.shape).to(p.dtype))
    return loss


class _GraphedStep:
    """The train step on a card as one CUDA graph replay: the counterpart
    of the reference's ``jax.jit(step)``. Its call signature is the eager
    step's (``eager``, kept for comparison and timing). On a ``mesh`` each
    rank replays its own graph over its shards, with the step's NCCL
    collectives captured inside it in the same order on every rank.

    The graph reads static parameter and batch tensors and updates the
    parameters in place (``p -= lr * g``, the eager step's arithmetic), so
    a call copies ``params`` and ``batch`` in only where they are not those
    tensors: ``params, loss = step(params, batch)`` in a loop copies
    nothing. The returned params ARE the static tensors, which the next call
    rewrites, as a jitted step's donated buffers; to restore a checkpoint,
    ``copy_`` into them. The first call runs eagerly (``GraphedCall``'s
    warm-up), the second captures; the attention path and its tile height
    are fixed at the capture, as a trace fixes them."""

    def __init__(self, eager, cfg: BurninConfig, weights, batch, mesh=None):
        from tpu_operator_torch.kernels.graph import GraphedCall

        self.eager = eager
        self.params = {k: torch.empty_like(v) for k, v in weights.items()}
        self.batch = batch
        # the graph's function holds the tensors, not this step: a graph in
        # a reference cycle would be destroyed by the collector at any
        # moment, even during another capture, which that breaks
        self._call = GraphedCall(functools.partial(_sgd_update, self.params, batch, cfg,
                                                   mesh=mesh))

    def __call__(self, params, batch):
        _load(self.params.values(), (params[k] for k in self.params))
        _load(self.batch, batch)
        loss = self._call()
        return dict(self.params), loss.clone()  # the loss outlives the next replay


def run_burnin(steps: int = 3, cfg: Optional[BurninConfig] = None,
               record_telemetry: bool = False, telemetry_host: str = "",
               device: DeviceLike = None, mesh=None) -> dict:
    """Run a few train steps; the loss must be finite and decreasing.
    ``record_telemetry`` attaches a per-step timing report (warm-up vs
    steady split, jitter percentiles, achieved TFLOP/s). On a ``mesh``
    every rank runs this and gets the same losses."""
    cfg = cfg or BurninConfig()
    dev = resolve_device(device)
    step, params, batch = build_train_step(cfg, dev, mesh=mesh)
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
    if mesh is not None:
        result["mesh"] = mesh_axes(mesh)
    if recorder is not None:
        result["telemetry"] = recorder.report().to_dict()
    return result
