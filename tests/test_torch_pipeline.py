"""The port's GPipe pipeline (``workloads/pipeline.py``) on a 4-rank gloo
world against the JAX package's: the twins of its
``TestPipelineParallel``.

One world runs every case and returns the results; the tests assert on
them. From the reference's own stage weights and batch (drawn by its
``run_pipeline_check``'s keys), the port's pipelined forward matches the
reference's within 1e-5 and its 3 pipelined SGD losses within 1e-5
relative (the gradients cross the ranks backwards through the ring);
``run_pipeline_check`` itself matches sequential within its 1e-4 bar;
the burn-in's transformer block pipelines over two stages.
"""


import numpy as np
import pytest
import torch
import torch.distributed as dist

from tpu_operator_torch.workloads import burnin as tb
from tpu_operator_torch.workloads import pipeline as tp
from tpu_operator_torch.workloads.distributed import spawn_world
from tpu_operator_torch.workloads.spmd import named_mesh

# JAX and the JAX package are imported inside the reference-side
# functions: a world's ranks import this module to find their function,
# and JAX there nearly doubles the world's start (8 ranks: ~27 against
# ~50 CPU-seconds), load that starves the suite's wall-clock tests.

STAGES, N_MICRO, BATCH, D_MODEL, STEPS, LR = 4, 4, 2, 64, 3, 0.1
BLOCK = dict(n_layers=1, d_model=64, n_heads=2, d_ff=128, seq_len=16, batch=2)


def _reference():
    """The reference check's own stage weights and batch (its keys), its
    pipelined forward and its losses."""
    import jax

    from tpu_operator.workloads import pipeline as jp

    mesh = jp.make_pp_mesh(jax.devices("cpu")[:STAGES], stages=STAGES)
    k_w, k_b, k_x, k_t = jax.random.split(jax.random.PRNGKey(0), 4)
    stacked = {
        "w": jax.random.normal(k_w, (STAGES, D_MODEL, D_MODEL)) / np.sqrt(D_MODEL),
        "b": jax.random.normal(k_b, (STAGES, D_MODEL)) * 0.01,
    }
    x = jax.random.normal(k_x, (N_MICRO, BATCH, D_MODEL))
    target = jax.random.normal(k_t, (N_MICRO, BATCH, D_MODEL))
    out = jp.pipeline_apply(stacked, x, stage_fn=lambda p, a: jax.nn.gelu(a @ p["w"] + p["b"]),
                            mesh=mesh)
    report = jp.run_pipeline_check(mesh=mesh, n_micro=N_MICRO, batch=BATCH, d_model=D_MODEL,
                                   steps=STEPS, learning_rate=LR)
    arrays = {k: np.asarray(v) for k, v in stacked.items()}
    return arrays, np.asarray(x), np.asarray(target), np.asarray(out), report["losses"]


def _block_pipeline(dtype):
    """(pipelined, sequential) of two burn-in blocks over a (rep, pp) mesh."""
    cfg = tb.BurninConfig(**BLOCK, dtype=dtype)
    mesh = named_mesh(rep=dist.get_world_size() // 2, pp=2)
    per_stage = [tb.init_params(torch.Generator().manual_seed(s), cfg, "cpu") for s in range(2)]
    stacked = {k: torch.stack([p[k] for p in per_stage]) for k in per_stage[0] if k.startswith("l0/")}
    mb = torch.randn((3, cfg.batch, cfg.seq_len, cfg.d_model),
                     generator=torch.Generator().manual_seed(9)).to(cfg.tdtype)
    with torch.no_grad():
        out = tp.pipeline_apply(stacked, mb, lambda p, x: tb._block(p, 0, x, cfg), mesh)
        want = mb
        for s in range(2):
            stage = {k: v[s] for k, v in stacked.items()}
            want = torch.stack([tb._block(stage, 0, x, cfg) for x in want])
    return out.float().numpy(), want.float().numpy()


def _rank_cases(arrays, x, target):
    mesh = tp.make_pp_mesh()
    stacked = {k: torch.from_numpy(v) for k, v in arrays.items()}
    x, target = torch.from_numpy(x), torch.from_numpy(target)
    out = {}
    with torch.no_grad():
        out["forward"] = tp.pipeline_apply(stacked, x, tp._stage_fn, mesh).numpy()
    out["losses"] = tp._pipeline_losses(stacked, x, target, mesh, STEPS, LR)
    out["check"] = tp.run_pipeline_check(mesh)
    out["blocks"] = {dtype: _block_pipeline(dtype) for dtype in ("float32", "bfloat16")}
    for name, call in (("stages", lambda: tp.make_pp_mesh(stages=3)),
                       ("stack", lambda: tp.pipeline_apply(
                           {k: v[:3] for k, v in stacked.items()}, x, tp._stage_fn, mesh))):
        try:
            call()
        except ValueError as err:
            out[name] = str(err)
    return out


@pytest.fixture(scope="module")
def world():
    arrays, x, target, want_out, want_losses = _reference()
    ranks = spawn_world(STAGES, _rank_cases, (arrays, x, target), device="cpu", timeout=240)
    return {"want_out": want_out, "want_losses": want_losses, "ranks": ranks}


def test_forward_matches_reference_on_every_rank(world):
    for rank in world["ranks"]:
        assert float(np.max(np.abs(rank["forward"] - world["want_out"]))) < 1e-5


def test_pipelined_training_matches_reference(world):
    want = world["want_losses"]
    for rank in world["ranks"]:
        got = rank["losses"]
        assert got[-1] < got[0]
        assert max(abs(g - w) / abs(w) for g, w in zip(got, want)) < 1e-5, (got, want)


def test_pipeline_matches_sequential_and_trains(world):
    for rank in world["ranks"]:
        report = rank["check"]
        assert report["ok"] and report["stages"] == STAGES
        assert report["max_abs_err_vs_sequential"] < 1e-4
        assert report["losses"][-1] < report["losses"][0]


@pytest.mark.parametrize("dtype, tol", [("float32", 1e-5), ("bfloat16", 0.15)])
def test_pipeline_of_transformer_blocks(world, dtype, tol):
    """The burn-in's block pipelines unchanged; bf16 allows the
    reference's few ulps of accumulation-order noise."""
    for rank in world["ranks"]:
        out, want = rank["blocks"][dtype]
        assert out.shape == want.shape == (3, BLOCK["batch"], BLOCK["seq_len"], BLOCK["d_model"])
        assert float(np.max(np.abs(out - want))) < tol


def test_rejections(world):
    got = world["ranks"][0]
    assert got["stages"] == "pp mesh wants 3 devices, have 4"
    assert "stacked param leading dim 3 != 4 pipeline stages" in got["stack"]
