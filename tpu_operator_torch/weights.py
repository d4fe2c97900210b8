"""Load the JAX package's parameters into the port.

The reference's weights arrive as a dict of numpy arrays (the caller
converts its own arrays; the port never sees a JAX array) and come out as
tensors on the given device, same names, shapes and dtypes. Names and
shapes are checked against the configuration, so a dict made for another
model fails here and not deep inside a matmul.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _load(arrays: Mapping[str, np.ndarray], shapes: Dict[str, tuple],
          device) -> Dict[str, torch.Tensor]:
    if set(arrays) != set(shapes):
        raise ValueError(
            f"parameter names differ: missing {sorted(set(shapes) - set(arrays))}, "
            f"unexpected {sorted(set(arrays) - set(shapes))}"
        )
    out = {}
    for name, shape in shapes.items():
        arr = np.asarray(arrays[name])
        if arr.shape != shape:
            raise ValueError(f"{name}: shape {arr.shape}, expected {shape}")
        out[name] = torch.from_numpy(arr.copy()).to(device)
    return out


def _burnin_shapes(cfg) -> Dict[str, tuple]:
    d, f = cfg.d_model, cfg.d_ff
    shapes = {"out_norm": (d,)}
    for layer in range(cfg.n_layers):
        shapes.update({f"l{layer}/qkv": (d, cfg.qkv_width), f"l{layer}/proj": (d, d)})
        if cfg.moe_experts:
            e = cfg.moe_experts
            shapes.update({f"l{layer}/router": (d, e), f"l{layer}/moe_w1": (e, d, f),
                           f"l{layer}/moe_w2": (e, f, d)})
        else:
            shapes.update({f"l{layer}/w1": (d, f), f"l{layer}/w2": (f, d)})
        shapes[f"l{layer}/ln_scale"] = (d,)
    return shapes


def burnin_params(arrays: Mapping[str, np.ndarray], cfg, device) -> Dict[str, torch.Tensor]:
    """The burn-in dict (``l{i}/qkv``, ``proj``, ``w1``, ``w2`` or, with
    experts, ``router``, ``moe_w1``, ``moe_w2``; ``ln_scale``,
    ``out_norm``) for a ``workloads.burnin.BurninConfig``."""
    return _load(arrays, _burnin_shapes(cfg), device)


def serving_params(arrays: Mapping[str, np.ndarray], cfg, device) -> Dict[str, torch.Tensor]:
    """The serving dict (``embed``, ``wq``, ``wk``, ``wv``, ``wo`` and
    ``w1_q``/``w2_q``/``w1_s``/``w2_s`` or ``w1``/``w2``) for a
    ``workloads.serving.ServingModelConfig``; the int8 weights laid out as
    the engine builds them (``serving.int8_weight``: column-major)."""
    from tpu_operator_torch.workloads.serving import int8_weights

    d, hd, f = cfg.d_model, cfg.n_heads * cfg.head_dim, cfg.d_ff
    shapes = {
        "embed": (cfg.vocab, d), "wq": (d, hd), "wk": (d, hd), "wv": (d, hd), "wo": (hd, d),
    }
    if cfg.int8_mlp:
        shapes.update({"w1_q": (d, f), "w2_q": (f, d), "w1_s": (), "w2_s": ()})
    else:
        shapes.update({"w1": (d, f), "w2": (f, d)})
    return int8_weights(_load(arrays, shapes, device))
