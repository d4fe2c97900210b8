"""Device smoke test: the ``vectorAdd`` analog (port of
``tpu_operator/workloads/smoke.py``).

Asserts the expected device count is visible and runs a small matmul +
elementwise probe on every CUDA device, checking its numbers against
numpy. Runs on the card unless ``device="cpu"`` is passed, in which case
the CPU is the one device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tpu_operator_torch.device import DeviceLike, local_devices


def smoke_probe(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``tanh(x @ y) + x[:, :1]`` in full f32: the counterpart of the
    reference's matmul at ``Precision.HIGHEST``, so the numbers check is
    meaningful. TF32 is off for the call whatever the process-wide
    setting, which is restored."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.tanh(x @ y) + x[:, :1]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def run_smoke(expected_devices: Optional[int] = None, size: int = 256,
              device: DeviceLike = None) -> dict:
    """Returns a report dict; raises on failure (the validator turns an
    exception into a retry)."""
    devices = local_devices(device)
    count = len(devices)
    if expected_devices is not None and count < expected_devices:
        raise RuntimeError(f"expected >= {expected_devices} devices, found {count}")

    rng = np.random.default_rng(0)
    x = rng.standard_normal((size, size), dtype=np.float32)
    y = rng.standard_normal((size, size), dtype=np.float32)
    want = np.tanh(x @ y) + x[:, :1]
    results = []
    for d in devices:
        got = smoke_probe(torch.from_numpy(x).to(d), torch.from_numpy(y).to(d))
        if not np.allclose(got.cpu().numpy(), want, atol=2e-2):
            raise RuntimeError(f"numerics mismatch on {d}")
        results.append(str(d))
    return {
        "device_count": count,
        "platform": devices[0].type,
        "devices": results,
        "ok": True,
    }
