"""Burn-in training of the port (``workloads/burnin.build_train_step``,
``run_burnin``, ``telemetry.burnin_flops_per_step``) against the JAX
package on the CPU.

Both trainers start from the reference's own params and batch (JAX
``build_train_step`` on a one-device CPU mesh -> numpy -> the port) and
take 3 SGD steps; the JAX flash path runs its Pallas kernels in interpret
mode. Losses are compared relative to the reference's: f32 within 1e-5
(the same arithmetic in another order), bf16 within 2e-2 (the two
frameworks round activations and gradients to bf16 at different places,
and the port's attention scores stay f32 where the reference's triangle
kernels round q·log2e/√d to bf16).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_operator.workloads import burnin as jb
from tpu_operator.workloads import telemetry as jt
from tpu_operator_torch.workloads import burnin as tb
from tpu_operator_torch.workloads import telemetry as tt

SMALL = dict(d_model=64, n_heads=4, d_ff=128, seq_len=64, batch=2, n_layers=2)
TOLS = {"float32": 1e-5, "bfloat16": 2e-2}
CONFIGS = {
    "dense": dict(),
    "flash": dict(use_flash_attention=True),
    "flash_gqa": dict(use_flash_attention=True, kv_heads=2),
    "flash_packed": dict(use_flash_attention=True, packed_segments=2),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    these shapes are tiny."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cpu_mesh():
    return jb.make_mesh(jax.devices("cpu")[:1])


def _losses(dtype, steps=3, **over):
    """(reference losses, port losses) over ``steps`` SGD steps from the
    reference's params and batch, and the port's final params."""
    kw = dict(SMALL, dtype=dtype, **over)
    jstep, jparams, jbatch = jb.build_train_step(_cpu_mesh(), jb.BurninConfig(**kw))
    params = {k: np.asarray(v) for k, v in jparams.items()}
    batch = tuple(np.asarray(a.astype(jnp.float32)) for a in jbatch)
    want = []
    for _ in range(steps):
        jparams, loss = jstep(jparams, jbatch)
        want.append(float(loss))
    step, tparams, tbatch = tb.build_train_step(tb.BurninConfig(**kw), "cpu", params, batch)
    got = []
    for _ in range(steps):
        tparams, loss = step(tparams, tbatch)
        got.append(float(loss))
    return want, got, tparams


@pytest.mark.parametrize("dtype", sorted(TOLS))
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_losses_match_reference(config, dtype):
    want, got, params = _losses(dtype, **CONFIGS[config])
    assert all(np.isfinite(got)) and got[-1] < got[0]
    rel = max(abs(w - g) / abs(w) for w, g in zip(want, got))
    assert rel <= TOLS[dtype], (want, got)
    assert all(p.dtype == torch.float32 for p in params.values())  # f32 master weights


def _raises_like_reference(over):
    kw = dict(SMALL, **over)
    with pytest.raises(ValueError) as want:
        jb.build_train_step(_cpu_mesh(), jb.BurninConfig(**kw))
    with pytest.raises(ValueError) as got:
        tb.build_train_step(tb.BurninConfig(**kw), "cpu")
    return str(want.value), str(got.value)


@pytest.mark.parametrize("over", [
    dict(kv_heads=3),
    dict(packed_segments=2),
    dict(use_flash_attention=True, packed_segments=65),
], ids=["kv_heads_not_dividing", "packed_without_flash", "packed_beyond_seq_len"])
def test_value_errors_match_reference(over):
    want, got = _raises_like_reference(over)
    assert got == want


def test_batch_of_the_wrong_shape_is_rejected():
    x = np.zeros((2, 32, 64), np.float32)
    with pytest.raises(ValueError, match="batch arrays"):
        tb.build_train_step(tb.BurninConfig(**SMALL), "cpu", batch=(x, x))


def test_seeded_inputs_are_reproducible():
    cfg = tb.BurninConfig(**SMALL)
    _, p1, (x1, t1) = tb.build_train_step(cfg, "cpu")
    _, p2, (x2, t2) = tb.build_train_step(cfg, "cpu")
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
    assert torch.equal(x1, x2) and torch.equal(t1, t2) and not torch.equal(x1, t1)
    assert x1.shape == (2, 64, 64) and x1.dtype == torch.bfloat16


def test_run_burnin_trains_and_reports():
    cfg = tb.BurninConfig(**SMALL, use_flash_attention=True)
    result = tb.run_burnin(steps=3, cfg=cfg, record_telemetry=True, telemetry_host="node-a",
                           device="cpu")
    assert result["ok"] and result["device"] == "cpu" and "mesh" not in result
    losses = result["losses"]
    assert len(losses) == 3 and all(np.isfinite(losses)) and losses[-1] < losses[0]
    report = result["telemetry"]
    assert report["steps"] == 3 and report["host"] == "node-a" and "tflops" in report


def test_run_burnin_raises_like_reference_when_loss_does_not_fall():
    """Gradient ascent (a negative learning rate) must trip the same check."""
    kw = dict(SMALL, learning_rate=-0.5)
    with pytest.raises(RuntimeError, match="failed to decrease"):
        jb.run_burnin(_cpu_mesh(), steps=2, cfg=jb.BurninConfig(**kw))
    with pytest.raises(RuntimeError, match="failed to decrease"):
        tb.run_burnin(steps=2, cfg=tb.BurninConfig(**kw), device="cpu")


def test_run_burnin_needs_cuda_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tb.run_burnin(steps=1, cfg=tb.BurninConfig(**SMALL))


@pytest.mark.parametrize("over", [dict(), dict(kv_heads=2), dict(seq_len=128, n_layers=3)])
def test_flops_per_step_matches_reference(over):
    kw = dict(SMALL, **over)
    assert tt.burnin_flops_per_step(tb.BurninConfig(**kw)) == jt.burnin_flops_per_step(
        jb.BurninConfig(**kw))


def test_entry_widths_step_on_cpu_launches_nothing():
    """One train step at the flagship's widths with flash attention runs
    on the CPU through the plain versions: no kernel is launched."""
    from tpu_operator_torch.entry import ENTRY_CONFIG
    from tpu_operator_torch.kernels import flash_bwd, flash_fwd

    wrappers = [flash_fwd.flash_fwd_tri, flash_fwd.flash_fwd_rect, flash_bwd.flash_bwd_dq_tri,
                flash_bwd.flash_bwd_dkv_tri, flash_bwd.flash_bwd_dq_rect,
                flash_bwd.flash_bwd_dkv_rect]
    before = [w.launches for w in wrappers]
    cfg = dataclasses.replace(ENTRY_CONFIG, use_flash_attention=True, batch=2)
    step, params, batch = tb.build_train_step(cfg, "cpu")
    new_params, loss = step(params, batch)
    assert np.isfinite(float(loss)) and set(new_params) == set(params)
    assert any(not torch.equal(new_params[k], params[k]) for k in params)
    assert [w.launches for w in wrappers] == before
