"""Entry point of the port: the flagship burn-in forward, mirroring
``__graft_entry__.entry()`` at the same widths.

``entry()`` returns ``(fn, (params, x))`` with ``fn(params, x)`` the
forward pass. It runs on the card unless ``device="cpu"`` is passed.
``params`` may carry the reference's weights as a dict of numpy arrays;
otherwise they are drawn from a fixed seed (the same distributions, not
the same bits as ``jax.random``).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from tpu_operator_torch.device import DeviceLike, resolve_device
from tpu_operator_torch.weights import burnin_params
from tpu_operator_torch.workloads.burnin import BurninConfig, forward, init_params

ENTRY_CONFIG = BurninConfig(d_model=256, n_heads=4, d_ff=1024, seq_len=128, batch=8, n_layers=2)


def entry(device: DeviceLike = None,
          params: Optional[Mapping[str, np.ndarray]] = None,
          use_flash_attention: bool = False):
    """(fn, example_args) — the forward step of the flagship model."""
    dev = resolve_device(device)
    cfg = dataclasses.replace(ENTRY_CONFIG, use_flash_attention=use_flash_attention)
    if params is None:
        weights = init_params(torch.Generator().manual_seed(0), cfg, dev)
    else:
        weights = burnin_params(params, cfg, dev)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((cfg.batch, cfg.seq_len, cfg.d_model), generator=gen).to(dev, cfg.tdtype)

    def fn(params, x):
        return forward(params, x, cfg)

    return fn, (weights, x)
