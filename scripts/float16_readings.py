#!/usr/bin/env python3
"""float16 readings of the port against the JAX package, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/float16_readings.py [--json PATH]

What ``tests/test_torch_float16.py`` holds to 2e-2, as numbers: the port's
``flash_attention`` output and gradients against the reference's (its
Pallas kernels in interpret mode) at (1,128,2,64) causal, fp16 and bf16;
the 3-step burn-in losses of both packages from the reference's params and
batch at d_model 64, 2 heads, seq 128, batch 2, one layer (dense, flash,
packed, MoE); the reference's rounding of q·log2(e)/√d to the input dtype
(its triangle forward, ``flashattention.py:750``; the port keeps the scale
in f32 after q·k), alone and against the output gap; and
the loss gradient a value of the output gets, 2·√loss/N with N =
batch·seq·d_model, at the test's, ``entry()``'s and Phi-3-mini's widths,
against fp16's smallest normal (2^-14) and subnormal (2^-24). CPU numbers
only: no time or rate of any device. Prints one JSON object.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tpu_operator.workloads import burnin as jb  # noqa: E402
from tpu_operator.workloads import flashattention as jfa  # noqa: E402
from tpu_operator_torch.kernels import flash_fwd  # noqa: E402
from tpu_operator_torch.workloads import burnin as tb  # noqa: E402
from tpu_operator_torch.workloads import flashattention as tfa  # noqa: E402

SMALL = dict(d_model=64, n_heads=2, d_ff=128, seq_len=128, batch=2, n_layers=1)
CONFIGS = {"dense": {}, "flash": {"use_flash_attention": True},
           "packed": {"use_flash_attention": True, "packed_segments": 2},
           "moe": {"use_flash_attention": True, "moe_experts": 4}}
WIDTHS = {"test (2,128,64)": 2 * 128 * 64, "entry() (8,128,256)": 8 * 128 * 256,
          "phi-3-mini (1,4096,3072)": 4096 * 3072}


def flash_gaps(dtype: str) -> dict:
    """The two packages' flash_attention at (1,128,2,64) causal: the
    output's and each gradient's largest gap over its largest |value|, the
    output's gap as a norm, and the f32 plain version with the reference's
    rounding of the scaled q against the port's and against the
    reference's output."""
    jd, td = {"float16": (jnp.float16, torch.float16), "bfloat16": (jnp.bfloat16,
                                                                    torch.bfloat16)}[dtype]
    rng = np.random.default_rng(0)
    q, k, v, w = (rng.standard_normal((1, 128, 2, 64)).astype(np.float32) for _ in range(4))
    kw = dict(causal=True, block_q=64, block_k=64)

    def jloss(a, b, c):
        return jnp.sum(jfa.flash_attention(a, b, c, **kw).astype(jnp.float32) * w)

    jargs = [jnp.asarray(a, jd) for a in (q, k, v)]
    want = [jfa.flash_attention(*jargs, **kw), *jax.grad(jloss, argnums=(0, 1, 2))(*jargs)]
    want = [np.asarray(jnp.asarray(x, jnp.float32)) for x in want]
    leaves = [torch.from_numpy(a).to(td).requires_grad_(True) for a in (q, k, v)]
    out = tfa.flash_attention(*leaves, **kw)
    got = [out, *torch.autograd.grad((out.float() * torch.from_numpy(w)).sum(), leaves)]
    gaps = {name: float(np.max(np.abs(x - y.detach().float().numpy())) / np.max(np.abs(x)))
            for name, x, y in zip(("out", "dq", "dk", "dv"), want, got)}
    # the reference's triangle rounds q·log2(e)/√d to the input dtype: the
    # plain version with that rounding (in f32, before the output's rounding)
    # against the port's, and each against the reference's output, as the
    # norm of the difference over the reference's norm
    qb, kb, vb, h, hk = tfa._collapse_heads(*(t.detach() for t in leaves))
    scaled = (qb.float() * (flash_fwd.LOG2E / 8.0)).to(td).float() / flash_fwd.LOG2E
    plain = {"port": flash_fwd.attention_plain(qb.float(), kb.float(), vb.float(), h, hk,
                                               True)[0],
             "rounded": flash_fwd.attention_plain(scaled, kb.float(), vb.float(), h, hk, True,
                                                  sm_scale=1.0)[0]}
    plain = {k: x.reshape(1, 2, 128, 64).transpose(1, 2).numpy() for k, x in plain.items()}
    port = got[0].detach().float().numpy()

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    gaps["out norm"] = rel(port, want[0])
    gaps["scale rounding alone (f32 plain versions)"] = rel(plain["rounded"], plain["port"])
    gaps["out norm, plain with the reference's rounding"] = rel(
        torch.from_numpy(plain["rounded"]).to(td).float().numpy(), want[0])
    return gaps


def burnin_gaps() -> dict:
    """Each config's 3 fp16 losses in both packages and the largest
    relative gap."""
    out = {}
    for name, over in CONFIGS.items():
        kw = dict(SMALL, dtype="float16", **over)
        cfg = jb.BurninConfig(**kw)
        devices = jax.devices("cpu")[:1]
        mesh = (jb.make_mesh_4d(devices, data=1, sp=1, model=1, ep=1) if cfg.moe_experts
                else jb.make_mesh(devices))
        jstep, jparams, jbatch = jb.build_train_step(mesh, cfg)
        params = {k: np.asarray(v) for k, v in jparams.items()}
        batch = tuple(np.asarray(a.astype(jnp.float32)) for a in jbatch)
        step, tparams, tbatch = tb.build_train_step(tb.BurninConfig(**kw), "cpu", params, batch)
        want, got = [], []
        for _ in range(3):
            jparams, loss = jstep(jparams, jbatch)
            want.append(float(loss))
            tparams, loss = step(tparams, tbatch)
            got.append(float(loss))
        out[name] = {"reference": want, "port": got,
                     "rel_gap": max(abs(a - b) / abs(a) for a, b in zip(want, got))}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", type=Path, default=None, help="also write the readings here")
    args = parser.parse_args(argv)
    torch.set_num_threads(4)
    result = {
        "device": "cpu",
        "flash_gaps": {dtype: flash_gaps(dtype) for dtype in ("float16", "bfloat16")},
        "burnin_fp16": burnin_gaps(),
        # the loss gradient of one output value at a loss of 2.0 (the
        # readings' ~1.99–2.04)
        "output_gradient": {name: {"value": 2 * math.sqrt(2.0) / n,
                                   "in_fp16_normal_min": 2 * math.sqrt(2.0) / n / 2.0 ** -14,
                                   "in_fp16_subnormal_steps": 2 * math.sqrt(2.0) / n / 2.0 ** -24}
                            for name, n in WIDTHS.items()},
    }
    if args.json is not None:
        args.json.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
