"""The port's compiled executables over a mesh on the CPU: the sharded
burn-in step, the all-reduce chain and the GPipe step, which a card runs
as CUDA graph replays with the NCCL collectives captured inside them
(``kernels/graph.GraphedCall``), as the reference runs them under
``jax.jit``.

The CPU keeps the eager code. What a card replays is held here as far as
it can be without one, in one 4-rank gloo world (``distributed.spawn_world``)
that runs every case and returns its results; the tests only assert on
them:

- the graph's body of the sharded step (``burnin._sgd_update`` on a mesh:
  the SGD update in place on the rank's static shards after one flat sum
  of the gradients and the loss over the token axes) against the eager
  sharded step, bit for bit over 3 steps, with flash attention over
  (data 2, model 2), a mixture of experts over ``ep``, and the ring over
  ``sp`` with packed documents and GQA; the ring's 3 losses and updated
  params, f32, within 1e-5 of the reference's jitted sharded step;
- the chain's body (``allreduce._chain``) against numpy's iteration, over
  the world and over a 2-rank group;
- the GPipe step's body (``pipeline._sgd_update``) against
  ``_pipeline_losses``' eager steps, bit for bit;
- ``GraphedCall`` over a sharded step whose body runs every kind of
  collective the port has, under a stand-in for the CUDA graph API: one
  eager warm-up on the side stream that issues every collective the
  capture issues, on the same groups and peers in the same order, then
  one capture, then replays that issue none.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tpu_operator_torch.workloads import allreduce
from tpu_operator_torch.workloads import burnin as tb
from tpu_operator_torch.workloads import pipeline as tp
from tpu_operator_torch.workloads import spmd
from tpu_operator_torch.workloads.distributed import spawn_world

# JAX and the JAX package are imported inside the reference-side function:
# the world's ranks import this module to find their function, and JAX
# there nearly doubles a world's start.

WORLD = 4
WORLD_TIMEOUT_S = 240
STEPS = 3
REF_TOL = 1e-5
SMALL = dict(d_model=64, n_heads=4, d_ff=128, seq_len=32, batch=4, n_layers=2)
CONFIGS = {
    "flash_data2_model2": (dict(data=2, model=2), dict(use_flash_attention=True)),
    "moe_flash_model2_ep2": (dict(data=1, sp=1, model=2, ep=2),
                             dict(use_flash_attention=True, moe_experts=4)),
    "ring_packed_gqa_sp2_model2": (dict(data=1, sp=2, model=2),
                                   dict(sequence_parallel=True, packed_segments=3, kv_heads=2)),
}
DTYPES = ("float32", "bfloat16")
REF_CASE = "ring_packed_gqa_sp2_model2"
# a body with every collective kind: the ring's transfers over sp, the MoE
# routing's gather over the token axes, f and g over model, the flat sum
STANDIN_CASE = (dict(data=1, sp=2, model=2, ep=1), dict(
    sequence_parallel=True, moe_experts=2, packed_segments=3, kv_heads=2))
CHAIN_ITERS = 3
CHAIN_LEN = 1000
PIPE = dict(n_micro=4, batch=2, d_model=16, steps=3, learning_rate=0.1)


class FakeGraphAPI:
    """Stands in for ``torch.cuda``'s graph API on the CPU: streams that
    record whether work ran on the side stream, a capture that runs the
    function (a real one only records it) and a replay that runs nothing.
    ``phase`` names what is running: "warm-up" on the side stream,
    "capture", else None."""

    def __init__(self):
        self.side = 0
        self.captures = 0
        self.replays = 0
        self.phase = None

    def install(self, monkeypatch):
        api = self

        class Stream:
            def wait_stream(self, other):
                pass

        class Ctx:
            def __init__(self, phase):
                self.phase = phase

            def __enter__(self):
                api.phase = self.phase
                if self.phase == "warm-up":
                    api.side += 1
                else:
                    api.captures += 1

            def __exit__(self, *exc):
                api.phase = None
                return False

        class CUDAGraph:
            def replay(self):
                api.replays += 1

        monkeypatch.setattr(torch.cuda, "Stream", Stream)
        monkeypatch.setattr(torch.cuda, "current_stream", Stream)
        monkeypatch.setattr(torch.cuda, "stream", lambda s: Ctx("warm-up"))
        monkeypatch.setattr(torch.cuda, "CUDAGraph", CUDAGraph)
        monkeypatch.setattr(torch.cuda, "graph", lambda g: Ctx("capture"))


def _config(over: dict, dtype: str) -> tb.BurninConfig:
    return tb.BurninConfig(**dict(SMALL, dtype=dtype, **over))


def _chain_input(rank: int) -> np.ndarray:
    """Multiples of 1/8 below 8 in magnitude: every sum and every division
    by the group's size is exact in f32, in any order."""
    return np.random.default_rng(rank).integers(-64, 64, CHAIN_LEN).astype(np.float32) / 8


def _bodies(ref_inputs) -> dict:
    """Each config's graph body against its eager sharded step."""
    out = {}
    for name, (axes, over) in CONFIGS.items():
        for dtype in DTYPES:
            cfg = _config(over, dtype)
            mesh = spmd.named_mesh(**axes)
            from_ref = name == REF_CASE and dtype == "float32"
            eager, params, batch = tb.build_train_step(
                cfg, "cpu", *(ref_inputs if from_ref else ()), mesh=mesh)
            graphed = tb._GraphedStep(eager, cfg, params, batch, mesh)
            tb._load(graphed.params.values(), params.values())
            held = dict(graphed.params)  # the tensors a graph would read and write
            body = graphed._call.fn
            equal, losses = [], []
            for _ in range(STEPS):
                params, want = eager(params, batch)
                got = body()  # the function a card captures
                equal.append(torch.equal(got, want))
                losses.append(float(got))
            got = {"losses_equal": equal, "losses": losses,
                   "params_equal": all(torch.equal(graphed.params[k], params[k]) for k in params),
                   "in_place": all(graphed.params[k] is held[k] for k in held),
                   "is_the_graphs_body": (body.func is tb._sgd_update
                                          and body.args == (graphed.params, batch, cfg)
                                          and body.keywords["mesh"] is mesh)}
            if from_ref:
                gathered = tb.gather_burnin_params(graphed.params, cfg, mesh)  # collective
                if dist.get_rank() == 0:
                    got["params"] = gathered
            out[f"{name} {dtype}"] = got
    return out


def _chains() -> dict:
    rank = dist.get_rank()
    world = torch.from_numpy(_chain_input(rank))
    allreduce._chain(world, WORLD, CHAIN_ITERS)
    group = spmd.axes_group(spmd.named_mesh(data=2, model=2), "model")
    pair = torch.from_numpy(_chain_input(rank))
    allreduce._chain(pair, 2, CHAIN_ITERS, group)
    return {"world": world.numpy(), "model": pair.numpy(),
            "model_ranks": dist.get_process_group_ranks(group)}


def _pipelines() -> dict:
    mesh = tp.make_pp_mesh()
    d = PIPE["d_model"]
    gen = torch.Generator().manual_seed(0)
    stacked = {"w": torch.randn((WORLD, d, d), generator=gen) / d ** 0.5,
               "b": torch.randn((WORLD, d), generator=gen) * 0.01}
    x, target = (torch.randn((PIPE["n_micro"], PIPE["batch"], d), generator=gen)
                 for _ in range(2))
    lr, steps = PIPE["learning_rate"], PIPE["steps"]
    eager = tp._pipeline_losses(stacked, x, target, mesh, steps, lr)
    params = {k: v.clone() for k, v in stacked.items()}
    body = [float(tp._sgd_update(params, x, target, mesh, lr)) for _ in range(steps)]
    return {"eager": eager, "body": body}


def _standin() -> dict:
    """A sharded step through ``GraphedCall`` under the stand-in: the
    collectives each phase issued, as (phase, op, group ranks, peers)."""
    axes, over = STANDIN_CASE
    cfg = _config(over, "float32")
    mesh = spmd.named_mesh(**axes)
    eager, params, batch = tb.build_train_step(cfg, "cpu", mesh=mesh)
    step = tb._GraphedStep(eager, cfg, params, batch, mesh)
    api = FakeGraphAPI()
    issued = []

    def recording(op, real):
        def run(*args, **kwargs):
            if op == "batch_isend_irecv":
                ops = args[0]
                group, peers = ops[0].group, tuple(o.peer for o in ops)
            else:
                group, peers = kwargs.get("group"), ()
            ranks = tuple(dist.get_process_group_ranks(group or dist.group.WORLD))
            issued.append((api.phase, op, ranks, peers))
            return real(*args, **kwargs)
        return run

    with pytest.MonkeyPatch.context() as mp:
        api.install(mp)
        mp.setattr(torch.Tensor, "record_stream", lambda self, stream: None)
        for op in ("all_reduce", "all_gather", "batch_isend_irecv"):
            mp.setattr(dist, op, recording(op, getattr(dist, op)))
        for _ in range(4):
            params, _ = step(params, batch)
    return {"issued": issued, "side": api.side, "captures": api.captures,
            "replays": api.replays, "graph_made": step._call.graph is not None}


def _rank_cases(ref_inputs) -> dict:
    """Every case on one rank of the world (run by spawn_world)."""
    return {"bodies": _bodies(ref_inputs), "chains": _chains(), "pipelines": _pipelines(),
            "standin": _standin()}


def _reference():
    """The reference's jitted sharded step on 4 CPU devices, 3 steps from its
    params and batch: (params, batch, losses, stepped params) as numpy."""
    import jax
    import jax.numpy as jnp

    from tpu_operator.workloads import burnin as jb

    axes, over = CONFIGS[REF_CASE]
    cfg = jb.BurninConfig(**dict(SMALL, dtype="float32", **over))
    step, params, batch = jb.build_train_step(jb.make_mesh_3d(jax.devices("cpu")[:WORLD], **axes),
                                              cfg)
    arrays = {k: np.asarray(v) for k, v in params.items()}
    batch_np = tuple(np.asarray(a.astype(jnp.float32)) for a in batch)
    losses = []
    for _ in range(STEPS):
        params, loss = step(params, batch)
        losses.append(float(loss))
    return arrays, batch_np, losses, {k: np.asarray(v) for k, v in params.items()}


@pytest.fixture(scope="module")
def world():
    """The reference's steps here, then every case in one 4-rank world."""
    arrays, batch, losses, stepped = _reference()
    ranks = spawn_world(WORLD, _rank_cases, ((arrays, batch),), device="cpu",
                        timeout=WORLD_TIMEOUT_S)
    return {"ranks": ranks, "ref_losses": losses, "ref_params": stepped}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_mesh_graph_body_is_the_eager_sharded_step_bit_for_bit(world, config, dtype):
    """On every rank, the body a card captures gives the eager sharded
    step's losses and updated shards exactly, over 3 steps, updating the
    step's own tensors in place (a graph reads and writes only those)."""
    for rank in world["ranks"]:
        got = rank["bodies"][f"{config} {dtype}"]
        assert got["is_the_graphs_body"] and got["in_place"]
        assert got["losses_equal"] == [True] * STEPS and got["params_equal"], got
    losses = [r["bodies"][f"{config} {dtype}"]["losses"] for r in world["ranks"]]
    assert all(x == losses[0] for x in losses)  # one global loss, every rank
    assert all(np.isfinite(losses[0])) and losses[0][-1] < losses[0][0]


def test_mesh_graph_body_matches_the_reference_jitted_step(world):
    """The ring config's body, f32, from the reference's params and batch:
    3 losses within 1e-5 relative of the reference's jitted sharded step,
    and the updated params (gathered to the global layout) within 1e-5 of
    their largest magnitude."""
    got = world["ranks"][0]["bodies"][f"{REF_CASE} float32"]
    want = world["ref_losses"]
    assert max(abs(g - w) / abs(w) for g, w in zip(got["losses"], want)) <= REF_TOL, (got, want)
    assert set(got["params"]) == set(world["ref_params"])
    for key, ref in world["ref_params"].items():
        assert got["params"][key].shape == ref.shape, key
        err = float(np.max(np.abs(got["params"][key] - ref)))
        assert err <= REF_TOL * float(np.max(np.abs(ref))), (key, err)


def _numpy_chain(xs: list, iters: int) -> list:
    for _ in range(iters):
        total = np.sum(xs, axis=0, dtype=np.float32)
        xs = [total / np.float32(len(xs))] * len(xs)
    return xs


@pytest.mark.parametrize("over", ["world", "model"])
def test_chain_body_is_numpys_iteration(world, over):
    """``iters`` all-reduces each followed by a division by the group's size
    leave every rank's tensor at numpy's iteration of the same inputs."""
    ranks = world["ranks"]
    groups = ([list(range(WORLD))] if over == "world"
              else sorted({tuple(r["chains"]["model_ranks"]) for r in ranks}))
    assert len(groups) == (1 if over == "world" else 2)
    for members in groups:
        want = _numpy_chain([_chain_input(r) for r in members], CHAIN_ITERS)
        for r, expected in zip(members, want):
            np.testing.assert_array_equal(ranks[r]["chains"][over], expected)


def test_pipeline_body_is_the_eager_pipelined_step(world):
    """The GPipe step's body (the update in place) gives ``_pipeline_losses``'
    eager losses exactly on every stage, and the pipeline trains."""
    for rank in world["ranks"]:
        got = rank["pipelines"]
        assert got["body"] == got["eager"] and got["eager"][-1] < got["eager"][0], got


def test_graphed_call_warms_every_group_then_captures_once(world):
    """Under the stand-in, a sharded step through ``GraphedCall``: the
    warm-up on the side stream issues every collective the capture issues
    (all-reduces, the MoE routing's gather and the ring's batched transfers,
    on the same groups and peers, in the same order, so that every
    communicator exists before the capture), then one capture, then replays
    that issue nothing."""
    for rank in world["ranks"]:
        got = rank["standin"]
        assert (got["side"], got["captures"], got["replays"]) == (1, 1, 3)
        assert got["graph_made"]
        phases = [i[0] for i in got["issued"]]
        assert set(phases) == {"warm-up", "capture"}  # nothing outside them
        warm = [i[1:] for i in got["issued"] if i[0] == "warm-up"]
        captured = [i[1:] for i in got["issued"] if i[0] == "capture"]
        assert warm == captured
        assert {op for op, _, _ in warm} == {"all_reduce", "all_gather", "batch_isend_irecv"}
        assert phases == ["warm-up"] * len(warm) + ["capture"] * len(captured)
