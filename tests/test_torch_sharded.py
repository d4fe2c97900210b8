"""The port's sharded burn-in step (``workloads/burnin.py`` on a mesh)
against the JAX package's ``build_train_step(mesh, cfg)`` on the same
mesh shape.

The reference runs on the conftest's 8 virtual CPU devices; its params
and batch go to numpy and are sharded into the ranks of one 8-rank gloo
world (``distributed.spawn_world``), which runs every case of this file
and returns its results; the tests only assert on them. One step each,
float32: the loss within 1e-5 relative, every updated parameter
(gathered back to the reference's global layout) within 1e-5 of its
largest magnitude. The MoE case's routing (each token's expert and
whether it fits the capacity) must equal the reference's before any
loss is compared, so a near-tie shows as routing and not as a loss
error. One bfloat16 case is held to 2e-2, as ``test_torch_train.py``
holds the one-device step.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpu_operator_torch.workloads import burnin as tb
from tpu_operator_torch.workloads.distributed import spawn_world

# JAX and the JAX package are imported inside the reference-side
# functions: a world's ranks import this module to find their function,
# and JAX there nearly doubles the world's start (8 ranks: ~27 against
# ~50 CPU-seconds), load that starves the suite's wall-clock tests.

WORLD = 8
WORLD_TIMEOUT_S = 240
LOSS_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
PARAM_TOL = 1e-5
SMALL = dict(d_model=64, n_heads=4, d_ff=128, seq_len=32, batch=4, n_layers=2,
             dtype="float32")
CASES = {
    "dense_data2_model4": (("data", 2, "model", 4), dict()),
    "flash_gqa_packed_data2_model4": (("data", 2, "model", 4), dict(
        n_heads=8, kv_heads=4, use_flash_attention=True, packed_segments=2)),
    "ring_data2_sp2_model2": (("data", 2, "sp", 2, "model", 2), dict(sequence_parallel=True)),
    "moe_packed_gqa_drops_sp2_model2_ep2": (("data", 1, "sp", 2, "model", 2, "ep", 2), dict(
        sequence_parallel=True, moe_experts=4, packed_segments=3, kv_heads=2,
        moe_capacity_factor=0.5)),
    "dense_bf16_data2_model4": (("data", 2, "model", 4), dict(dtype="bfloat16")),
}
MOE_CASE = "moe_packed_gqa_drops_sp2_model2_ep2"
# run_burnin on a mesh: (mesh axes, config, steps) — the reference's
# sharded-step, sequence-parallel and expert-parallel convergence runs
RUNS = {
    "data2_model4": (dict(data=2, model=4), dict(), 4),
    "sp_data2_sp2_model2": (dict(data=2, sp=2, model=2), dict(sequence_parallel=True), 3),
    "moe_sp2_model2_ep2": (dict(data=1, sp=2, model=2, ep=2),
                           dict(sequence_parallel=True, moe_experts=4), 3),
    "moe_capacity_one": (dict(data=1, sp=2, model=2, ep=2),
                         dict(sequence_parallel=True, moe_experts=2, moe_capacity_factor=0.01), 2),
}
# configurations both frameworks must refuse on a mesh, with the same words
ERRORS = {
    "sp_without_sp_axis": (("data", 2, "model", 4), dict(sequence_parallel=True)),
    "moe_without_ep_axis": (("data", 4, "model", 2), dict(moe_experts=4)),
    "experts_not_dividing_ep": (("data", 1, "sp", 2, "model", 2, "ep", 2),
                                dict(moe_experts=3, sequence_parallel=True)),
    "seq_not_dividing_sp": (("data", 2, "sp", 2, "model", 2),
                            dict(sequence_parallel=True, seq_len=33)),
    "flash_batch_not_dividing_data": (("data", 4, "model", 2),
                                      dict(use_flash_attention=True, batch=2)),
    "ring_kv_heads_not_dividing_model": (("data", 2, "sp", 2, "model", 2),
                                         dict(sequence_parallel=True, kv_heads=1)),
    "ring_and_flash": (("data", 2, "sp", 2, "model", 2),
                       dict(sequence_parallel=True, use_flash_attention=True)),
}


def _axes(flat):
    return dict(zip(flat[::2], flat[1::2]))


def _jax_mesh(axes):
    import jax

    from tpu_operator.workloads import burnin as jb

    devices = jax.devices("cpu")[:WORLD]
    if "ep" in axes:
        return jb.make_mesh_4d(devices, **axes)
    if "sp" in axes:
        return jb.make_mesh_3d(devices, **axes)
    return jb.make_mesh(devices, **axes)


def _torch_mesh(axes):
    if "ep" in axes:
        return tb.make_mesh_4d(**axes)
    if "sp" in axes:
        return tb.make_mesh_3d(**axes)
    return tb.make_mesh(**axes)


def _reference_routing(arrays, x, over):
    """Each layer's (expert, kept) per token in global (batch, seq)
    order, from the reference's own pieces: its norms, packed ids, dense
    attention over repeated KV, and its _moe_ffn for the layer's output."""
    import jax
    import jax.numpy as jnp

    from tpu_operator.workloads import burnin as jb
    from tpu_operator.workloads.ringattention import dense_attention as jax_dense_attention

    cfg = jb.BurninConfig(**dict(SMALL, **over))
    params = {k: jnp.asarray(v) for k, v in arrays.items()}
    x = jnp.asarray(x)
    b, s, d = x.shape
    h, h_kv = cfg.n_heads, cfg.resolved_kv_heads
    dh = d // h
    ids = jb._packed_ids(b, s, cfg.packed_segments)
    flat = dataclasses.replace(cfg, sequence_parallel=False)
    out = []
    for layer in range(cfg.n_layers):
        ln = params[f"l{layer}/ln_scale"]
        y = jb._rmsnorm(x, ln)
        q, k, v = jnp.split(y @ params[f"l{layer}/qkv"], [d, d + h_kv * dh], axis=-1)
        rep = lambda a: jnp.repeat(a.reshape(b, s, h_kv, dh), h // h_kv, axis=2)  # noqa: E731
        ctx = jax_dense_attention(q.reshape(b, s, h, dh), rep(k), rep(v), causal=True,
                                  segment_ids=ids)
        x = x + ctx.reshape(b, s, d) @ params[f"l{layer}/proj"]
        y = jb._rmsnorm(x, ln)
        logits = y.reshape(b * s, d) @ params[f"l{layer}/router"]
        idx = jnp.argmax(jax.nn.softmax(logits, axis=-1), axis=-1)
        onehot = jax.nn.one_hot(idx, cfg.moe_experts, dtype=jnp.int32)
        position = jnp.sum((jnp.cumsum(onehot, axis=0) - 1) * onehot, axis=-1)
        cap = max(1, int(cfg.moe_capacity_factor * b * s / cfg.moe_experts))
        out.append((np.asarray(idx).reshape(b, s), np.asarray(position < cap).reshape(b, s)))
        x = x + jb._moe_ffn(params, layer, y, flat)
    return out


def _reference(axes, over):
    """(params, batch, stepped params, loss) of one reference step, numpy."""
    import jax.numpy as jnp

    from tpu_operator.workloads import burnin as jb

    cfg = jb.BurninConfig(**dict(SMALL, **over))
    step, params, batch = jb.build_train_step(_jax_mesh(axes), cfg)
    arrays = {k: np.asarray(v) for k, v in params.items()}
    batch_np = tuple(np.asarray(a.astype(jnp.float32)) for a in batch)
    new_params, loss = step(params, batch)
    return arrays, batch_np, {k: np.asarray(v) for k, v in new_params.items()}, float(loss)


def _reference_error(axes, over):
    from tpu_operator.workloads import burnin as jb

    with pytest.raises(ValueError) as err:
        jb.build_train_step(_jax_mesh(axes), jb.BurninConfig(**dict(SMALL, **over)))
    return str(err.value)


def _rank_cases(cases, errors):
    """Every case on one rank of the world (run by spawn_world)."""
    routing = []
    route = tb._moe_route

    def recording(expert_idx, b, s, cfg, mesh=None):
        position, keep, cap = route(expert_idx, b, s, cfg, mesh)
        routing.append((expert_idx.reshape(b, s).numpy(), keep.reshape(b, s).numpy()))
        return position, keep, cap

    tb._moe_route = recording
    rank = torch.distributed.get_rank()
    out = {"steps": {}, "errors": {}, "routing": {}}
    for name, (axes, over, arrays, batch) in cases.items():
        cfg = tb.BurninConfig(**dict(SMALL, **over))
        mesh = _torch_mesh(axes)
        routing.clear()
        step, params, data = tb.build_train_step(cfg, "cpu", arrays, batch, mesh=mesh)
        new_params, loss = step(params, data)
        gathered = tb.gather_burnin_params(new_params, cfg, mesh)
        coords = (mesh.get_local_rank("data"),
                  mesh.get_local_rank("sp") if "sp" in axes else 0)
        out["routing"][name] = (coords, list(routing))
        if rank == 0:
            out["steps"][name] = {"loss": float(loss), "params": gathered}
    for name, (axes, over) in errors.items():
        try:
            tb.build_train_step(tb.BurninConfig(**dict(SMALL, **over)), "cpu",
                                mesh=_torch_mesh(axes))
        except ValueError as err:
            out["errors"][name] = str(err)
    out["run_burnin"] = {name: tb.run_burnin(steps=steps, cfg=tb.BurninConfig(**dict(SMALL, **over)),
                                             device="cpu", mesh=_torch_mesh(axes))
                         for name, (axes, over, steps) in RUNS.items()}
    mesh = tb.make_mesh()
    out["default_mesh"] = tb.mesh_axes(mesh)
    out["mesh_4x2"] = tb.mesh_axes(tb.make_mesh(data=4, model=2))
    try:
        tb.make_mesh(data=3, model=3)
    except ValueError as err:
        out["mesh_3x3"] = str(err)
    cfg = tb.BurninConfig(n_layers=1)
    _, params, _ = tb.build_train_step(cfg, "cpu", mesh=mesh)
    out["qkv_shard"] = tuple(params["l0/qkv"].shape)
    cfg = tb.BurninConfig(moe_experts=4, sequence_parallel=True, n_layers=1, seq_len=32, batch=4)
    _, params, (x, _) = tb.build_train_step(cfg, "cpu", mesh=tb.make_mesh_4d())
    out["moe_w1_shard"] = tuple(params["l0/moe_w1"].shape)
    out["x_shard"] = tuple(x.shape)
    return out


@pytest.fixture(scope="module")
def world():
    """The reference's steps here, then every case in one 8-rank world."""
    refs = {name: (_axes(axes), over, *_reference(_axes(axes), over))
            for name, (axes, over) in CASES.items()}
    cases = {name: (axes, over, arrays, batch)
             for name, (axes, over, arrays, batch, _, _) in refs.items()}
    errors = {name: (_axes(axes), over) for name, (axes, over) in ERRORS.items()}
    ranks = spawn_world(WORLD, _rank_cases, (cases, errors), device="cpu",
                        timeout=WORLD_TIMEOUT_S)
    return {"refs": refs, "ranks": ranks}


@pytest.mark.parametrize("name", sorted(CASES))
def test_step_matches_reference(world, name):
    axes, over, arrays, batch, want_params, want_loss = world["refs"][name]
    got = world["ranks"][0]["steps"][name]
    dtype = dict(SMALL, **over)["dtype"]
    assert np.isfinite(got["loss"])
    assert abs(got["loss"] - want_loss) <= LOSS_TOL[dtype] * abs(want_loss), (got["loss"], want_loss)
    if dtype != "float32":
        return
    assert set(got["params"]) == set(want_params)
    for key, want in want_params.items():
        have = got["params"][key]
        assert have.shape == want.shape, key
        err = float(np.max(np.abs(have - want)))
        assert err <= PARAM_TOL * float(np.max(np.abs(want))), (key, err)


def test_moe_routing_matches_reference(world):
    axes, over, arrays, batch, _, _ = world["refs"][MOE_CASE]
    want = _reference_routing(arrays, batch[0], over)
    b = SMALL["batch"] // axes["data"]
    s = SMALL["seq_len"] // axes["sp"]
    for layer, (want_idx, want_keep) in enumerate(want):
        got_idx = np.full(want_idx.shape, -1)
        got_keep = np.zeros(want_keep.shape, bool)
        for rank in world["ranks"]:
            (di, si), routing = rank["routing"][MOE_CASE]
            idx, keep = routing[layer]
            got_idx[di * b:(di + 1) * b, si * s:(si + 1) * s] = idx
            got_keep[di * b:(di + 1) * b, si * s:(si + 1) * s] = keep
        np.testing.assert_array_equal(got_idx, want_idx)
        np.testing.assert_array_equal(got_keep, want_keep)
        assert not want_keep.all() and want_keep.any()  # the capacity really drops tokens


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_value_errors_match_reference(world, name):
    axes, over = ERRORS[name]
    want = _reference_error(_axes(axes), over)
    assert world["ranks"][0]["errors"][name] == want


@pytest.mark.parametrize("name", sorted(RUNS))
def test_run_burnin_on_a_mesh_converges(world, name):
    axes, _, steps = RUNS[name]
    reports = [rank["run_burnin"][name] for rank in world["ranks"]]
    first = reports[0]
    assert first["ok"] and first["mesh"] == axes and len(first["losses"]) == steps
    assert all(np.isfinite(first["losses"])) and first["losses"][-1] < first["losses"][0]
    assert all(r["losses"] == first["losses"] for r in reports)  # one loss, every rank


def test_mesh_factorization(world):
    got = world["ranks"][0]
    assert got["default_mesh"] == {"data": 2, "model": 4}
    assert got["mesh_4x2"] == {"data": 4, "model": 2}
    with pytest.raises(ValueError) as want:
        _jax_mesh({"data": 3, "model": 3})
    assert got["mesh_3x3"] == str(want.value)


def test_params_actually_sharded(world):
    """qkv column-parallel over 4 'model' ranks; 2 of 4 experts per 'ep'
    rank, each expert's d_ff halved over 'model'; the batch's rows over
    'data' and its sequence over 'sp'."""
    got = world["ranks"][0]
    cfg = tb.BurninConfig()
    assert got["qkv_shard"] == (cfg.d_model, 3 * cfg.d_model // 4)
    assert got["moe_w1_shard"] == (2, cfg.d_model, cfg.d_ff // 2)
    assert got["x_shard"] == (4, 16, cfg.d_model)
