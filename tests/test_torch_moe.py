"""The port's single-device mixture of experts (``workloads/burnin.py``
``_moe_ffn``, ``loss_fn`` and the train step with ``moe_experts``) against
the JAX package's, with no mesh: the reference's ``loss_fn(mesh=None)``
and its step on a 1x1x1x1 4-D mesh of one CPU device.

The reference's own weights and batch go through both. f32 within 1e-5
(of max |out| for the FFN, relative for losses), bf16 within 2e-2 (the
dispatch and combine are exact in bf16: each token meets one nonzero
term; the experts' matmuls round in another order). Capacity factors of
0.5 and 0.01 force dropped tokens, which ride the residual path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_operator.workloads import burnin as jb
from tpu_operator_torch.weights import burnin_params
from tpu_operator_torch.workloads import burnin as tb

SMALL = dict(d_model=64, n_heads=4, d_ff=128, seq_len=32, batch=2, n_layers=2, moe_experts=4)
TOLS = {"float32": 1e-5, "bfloat16": 2e-2}
CONFIGS = {
    "dense": dict(),
    "flash_gqa_packed": dict(use_flash_attention=True, kv_heads=2, packed_segments=2),
    "drops": dict(moe_capacity_factor=0.5),
    "capacity_one": dict(moe_capacity_factor=0.01),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfgs(dtype, **over):
    kw = dict(SMALL, dtype=dtype, **over)
    return jb.BurninConfig(**kw), tb.BurninConfig(**kw)


def _reference_params(jcfg, tcfg, seed=0):
    jparams = jb.init_params(jax.random.PRNGKey(seed), jcfg)
    return jparams, burnin_params({k: np.asarray(v) for k, v in jparams.items()}, tcfg, "cpu")


@pytest.mark.parametrize("dtype", sorted(TOLS))
@pytest.mark.parametrize("capacity", [1.25, 0.5, 0.01])
def test_moe_ffn_matches_reference(dtype, capacity):
    jcfg, tcfg = _cfgs(dtype, moe_capacity_factor=capacity)
    jparams, params = _reference_params(jcfg, tcfg)
    y = np.random.default_rng(5).standard_normal((2, 32, 64)).astype(np.float32)
    want = np.asarray(jb._moe_ffn(jparams, 1, jnp.asarray(y, jcfg.jdtype), jcfg).astype(jnp.float32))
    got = tb._moe_ffn(params, 1, torch.from_numpy(y).to(tcfg.tdtype), tcfg)
    assert got.dtype == tcfg.tdtype and got.shape == y.shape
    err = float(np.max(np.abs(want - got.float().numpy())))
    assert err <= TOLS[dtype] * float(np.max(np.abs(want)))
    if capacity < 1:  # dropped tokens get no expert output at all
        assert (np.abs(want).max(-1) == 0).any() and (got.float().abs().amax(-1) == 0).any()


@pytest.mark.parametrize("dtype", sorted(TOLS))
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_loss_matches_reference(config, dtype):
    jcfg, tcfg = _cfgs(dtype, **CONFIGS[config])
    jparams, params = _reference_params(jcfg, tcfg, seed=3)
    rng = np.random.default_rng(3)
    x, target = (rng.standard_normal((2, 32, 64)).astype(np.float32) for _ in range(2))
    want = float(jb.loss_fn(jparams, (jnp.asarray(x, jcfg.jdtype), jnp.asarray(target, jcfg.jdtype)),
                            jcfg))
    got = float(tb.loss_fn(params, (torch.from_numpy(x).to(tcfg.tdtype),
                                    torch.from_numpy(target).to(tcfg.tdtype)), tcfg))
    assert abs(got - want) <= TOLS[dtype] * abs(want)


@pytest.mark.parametrize("dtype", sorted(TOLS))
@pytest.mark.parametrize("config", ["dense", "flash_gqa_packed", "drops"])
def test_three_step_curve_matches_reference(config, dtype):
    """3 SGD steps from the reference's params and batch; the reference
    steps on its 1x1x1x1 4-D mesh (an 'ep' axis is its price for MoE)."""
    jcfg, tcfg = _cfgs(dtype, **CONFIGS[config])
    mesh = jb.make_mesh_4d(jax.devices("cpu")[:1], data=1, sp=1, model=1, ep=1)
    jstep, jparams, jbatch = jb.build_train_step(mesh, jcfg)
    params = {k: np.asarray(v) for k, v in jparams.items()}
    batch = tuple(np.asarray(a.astype(jnp.float32)) for a in jbatch)
    step, tparams, tbatch = tb.build_train_step(tcfg, "cpu", params, batch)
    want, got = [], []
    for _ in range(3):
        jparams, loss = jstep(jparams, jbatch)
        want.append(float(loss))
        tparams, loss = step(tparams, tbatch)
        got.append(float(loss))
    assert all(np.isfinite(got)) and got[-1] < got[0]
    rel = max(abs(w - g) / abs(w) for w, g in zip(want, got))
    assert rel <= TOLS[dtype], (want, got)
    if dtype == "float32":
        for name, value in jparams.items():
            want_p = np.asarray(value)
            err = float(np.max(np.abs(want_p - tparams[name].numpy())))
            assert err <= 1e-5 * float(np.max(np.abs(want_p))), name


def test_run_burnin_with_experts_trains():
    cfg = tb.BurninConfig(**dict(SMALL, use_flash_attention=True, moe_capacity_factor=0.01))
    result = tb.run_burnin(steps=2, cfg=cfg, device="cpu")
    assert result["ok"] and result["losses"][-1] < result["losses"][0]


def test_expert_names_and_shapes():
    kw = dict(SMALL, kv_heads=2)
    jcfg, tcfg = jb.BurninConfig(**kw), tb.BurninConfig(**kw)
    ref = jb.init_params(jax.random.PRNGKey(0), jcfg)
    params = tb.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    assert set(params) == set(ref)
    assert {"l0/router", "l0/moe_w1", "l0/moe_w2"} <= set(params) and "l0/w1" not in params
    for name, value in params.items():
        assert tuple(value.shape) == ref[name].shape and value.dtype == torch.float32
        assert abs(float(value.std()) - float(np.std(np.asarray(ref[name])))) < 0.1 * (
            float(np.std(np.asarray(ref[name]))) + 1e-3)
    arrays = {k: np.asarray(v) for k, v in ref.items()}
    loaded = burnin_params(arrays, tcfg, "cpu")
    assert all(np.array_equal(loaded[k].numpy(), arrays[k]) for k in arrays)
    with pytest.raises(ValueError, match="moe_w1"):
        burnin_params({**arrays, "l0/moe_w1": arrays["l0/moe_w1"][:2]}, tcfg, "cpu")
    with pytest.raises(ValueError, match="parameter names"):
        burnin_params(arrays, tb.BurninConfig(**dict(kw, moe_experts=0)), "cpu")
