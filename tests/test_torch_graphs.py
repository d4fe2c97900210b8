"""The port's compiled executables on the CPU: the burn-in train step and
the decode engine's decode and prefill, which a card runs as CUDA graph
replays (``kernels/graph.GraphedCall``) where the reference runs them
under ``jax.jit``.

The CPU keeps the eager code, which is what the reference is held to
here: the step factory's 3 losses from the reference's params and batch
(f32 within 1e-5 relative, bf16 within 2e-2, the bars of
``tests/test_torch_train.py``). What the card runs differently is held on
the CPU as far as it can be without a card: the graph's body (the SGD
update in place on static parameters) against the eager step bit for bit,
the engine's calls through static input tensors against the reference's
tokens, the prefill cache keyed by the reference's prefixes, a trainer
restore that writes into the step's tensors, and ``GraphedCall``'s launch
counts under a stand-in for the CUDA graph API.
"""

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_torch_graphs_mesh import FakeGraphAPI
from tpu_operator.workloads import burnin as jb
from tpu_operator.workloads import serving as js
from tpu_operator_torch.kernels import graph
from tpu_operator_torch.workloads import burnin as tb
from tpu_operator_torch.workloads import serving as ts
from tpu_operator_torch.workloads.checkpoint import CheckpointStore
from tpu_operator_torch.workloads.training import ResumableTrainer

SMALL = dict(d_model=64, n_heads=4, d_ff=128, seq_len=64, batch=2, n_layers=2)
TOLS = {"float32": 1e-5, "bfloat16": 2e-2}
CONFIGS = {
    "dense": dict(),
    "flash": dict(use_flash_attention=True),
    "flash_packed": dict(use_flash_attention=True, packed_segments=2),
    "moe_gqa": dict(moe_experts=4, kv_heads=2),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    these shapes are tiny."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _reference_state(kw):
    """The reference's step, params and batch for a config; the port's
    params and batch as numpy."""
    jstep, jparams, jbatch = jb.build_train_step(jb.make_mesh(jax.devices("cpu")[:1]),
                                                 jb.BurninConfig(**kw))
    arrays = {k: np.asarray(v) for k, v in jparams.items()}
    return jstep, jparams, jbatch, arrays, tuple(np.asarray(a.astype(jnp.float32)) for a in jbatch)


@pytest.mark.parametrize("dtype", sorted(TOLS))
def test_step_factory_on_the_cpu_is_the_eager_step(dtype):
    """On the CPU the factory returns the eager step (no graph), whose 3
    losses from the reference's params and batch are the reference's."""
    kw = dict(SMALL, dtype=dtype, use_flash_attention=True)
    jstep, jparams, jbatch, arrays, batch = _reference_state(kw)
    want = []
    for _ in range(3):
        jparams, loss = jstep(jparams, jbatch)
        want.append(float(loss))
    step, params, data = tb.build_train_step(tb.BurninConfig(**kw), "cpu", arrays, batch)
    assert not isinstance(step, tb._GraphedStep)
    got = []
    for _ in range(3):
        params, loss = step(params, data)
        got.append(float(loss))
    assert max(abs(w - g) / abs(w) for w, g in zip(want, got)) <= TOLS[dtype], (want, got)


@pytest.mark.parametrize("dtype", sorted(TOLS))
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_graph_body_is_the_eager_step_bit_for_bit(config, dtype):
    """The graph's body (``_sgd_update``: static parameters updated in
    place, the loss returned) run eagerly on the CPU gives the eager step's
    losses and parameters exactly, over 3 steps: the card replays this
    body. It holds the tensors, not the step (no reference cycle)."""
    cfg = tb.BurninConfig(**SMALL, dtype=dtype, **CONFIGS[config])
    eager, params, batch = tb.build_train_step(cfg, "cpu")
    graphed = tb._GraphedStep(eager, cfg, params, batch)
    tb._load(graphed.params.values(), params.values())
    for _ in range(3):
        params, want = eager(params, batch)
        got = tb._sgd_update(graphed.params, batch, cfg)
        assert torch.equal(got, want)
    assert all(torch.equal(graphed.params[k], params[k]) for k in params)
    assert graphed._call.fn.args == (graphed.params, batch, cfg)


def test_graphed_step_copies_only_foreign_inputs(monkeypatch):
    """A call copies params and batch into the static tensors only where
    they are not those tensors, and returns the static params; the
    returned loss is a copy the next call leaves alone."""
    cfg = tb.BurninConfig(**SMALL)
    eager, params, batch = tb.build_train_step(cfg, "cpu")
    step = tb._GraphedStep(eager, cfg, params, batch)
    step._call = lambda: step.params["out_norm"].sum()  # stands in for the graph
    copies = []
    monkeypatch.setattr(torch.Tensor, "copy_", lambda self, src: copies.append(1) or self)
    new, loss = step(params, batch)
    assert len(copies) == len(params)  # the batch is already the static one
    assert all(new[k] is step.params[k] for k in params)
    copies.clear()
    again, second = step(new, batch)
    assert copies == [] and second is not loss


def _trainer(tmp_path, **kw):
    return ResumableTrainer(CheckpointStore(str(tmp_path)),
                            tb.BurninConfig(**SMALL, dtype="float32"), device="cpu", **kw)


@pytest.mark.parametrize("fault, every, resumed_at", [(5, 2, 4), (2, 3, 0)],
                         ids=["from_a_checkpoint", "from_the_seeded_start"])
def test_trainer_restore_writes_into_the_step_tensors(tmp_path, fault, every, resumed_at):
    """A resume at world 1 restores into the parameter tensors the step
    already holds (same tensors, same storage), which a graph on a card
    reads, and the re-executed steps give their first run's losses."""
    trainer = _trainer(tmp_path, total_steps=6, checkpoint_every=every, fail_at_steps=(fault,))
    trainer.resume(1)
    with pytest.raises(Exception, match=f"step {fault}"):
        trainer.run(6)
    held = dict(trainer._params)
    ptrs = {k: t.data_ptr() for k, t in held.items()}
    step_fn = trainer._step_fn
    assert trainer.resume(1).step == resumed_at
    assert trainer._step_fn is step_fn
    assert all(trainer._params[k] is held[k] and held[k].data_ptr() == ptrs[k] for k in held)
    ckpt = trainer.store.latest_good()
    start = ckpt.arrays if ckpt is not None else tb.seeded_params(trainer.cfg)
    assert all(np.array_equal(held[k].numpy(), np.asarray(start[k])) for k in held)
    trainer.run(6)
    first = {}
    for h in trainer.history:
        assert first.setdefault(h["step"], h["loss"]) == h["loss"]
    assert trainer.done and len(first) == 6
    trainer.close()
    assert trainer._step_fn is None and not trainer.ready


def _run(engine, requests, prompt_len):
    engine.warmup(prompt_len)
    for r in requests:
        engine.submit(r)
    engine.run_until_drained()
    return {r.rid: list(r.output) for r in engine.completed}


def _tiny(mod, **over):
    return mod.ServingModelConfig(d_model=16, n_heads=2, head_dim=8, d_ff=32, vocab=64,
                                  page_tokens=4, max_pages=32, max_batch=4, max_seq=32,
                                  prefill_chunk=4, **over)


def _requests(mod, prompt_len):
    return mod.make_requests(6, seed=11, prompt_len=prompt_len, decode_min=3, decode_max=12,
                             vocab=64)


@pytest.mark.parametrize("prompt_len", [3, 10, 16])
def test_prefill_cache_keys_are_the_reference_prefixes(prompt_len):
    """One compiled prefill per prompt offset, keyed as the reference keys
    its jitted prefills, after the same warm-up and requests."""
    engines = [js.DecodeEngine(_tiny(js), seed=3),
               ts.DecodeEngine(_tiny(ts), seed=3, device="cpu")]
    for engine, mod in zip(engines, (js, ts)):
        _run(engine, _requests(mod, prompt_len), prompt_len)
    want, got = (sorted(e._prefill_fns) for e in engines)
    assert got == want == list(range(0, prompt_len, 4))


class _StaticInputsEngine(ts.DecodeEngine):
    """The card's calling convention on the CPU: every decode and prefill
    through static input tensors its arguments are copied into, the body
    run on them (eagerly: the CPU has no graphs)."""

    def _compiled(self, body, *inputs):
        return ts.over_static_inputs(body, inputs, self.device, lambda run: run)


@pytest.mark.parametrize("flash", [False, True], ids=["dense_prefill", "flash_prefill"])
def test_engine_over_static_inputs_gives_the_reference_tokens(flash):
    """The bodies the card's graphs replay, fed through static inputs
    (``valid`` a device tensor, the page table int32), answer the reference's
    greedy tokens."""
    over = dict(use_flash_prefill=flash)
    want = _run(js.DecodeEngine(_tiny(js, **over), seed=3), _requests(js, 10), 10)
    engine = _StaticInputsEngine(_tiny(ts, **over), seed=3, device="cpu")
    got = _run(engine, _requests(ts, 10), 10)
    assert got == want and all(got.values())
    assert sorted(engine._prefill_fns) == [0, 4, 8]


def test_graph_holders_are_freed_without_the_cycle_collector():
    """A graphed step and an engine that holds compiled steps are freed as
    soon as they are dropped: no reference cycle keeps them (with their
    graphs) for the collector, which may run during another capture, where
    destroying a graph invalidates that capture."""
    cfg = tb.BurninConfig(**SMALL)
    eager, params, batch = tb.build_train_step(cfg, "cpu")
    was = gc.isenabled()
    gc.disable()
    try:
        step = tb._GraphedStep(eager, cfg, params, batch)
        engine = _StaticInputsEngine(_tiny(ts), seed=0, device="cpu")
        engine.warmup(8)
        refs = [weakref.ref(step), weakref.ref(engine)]
        del step, engine
        assert [r() for r in refs] == [None, None]
    finally:
        if was:
            gc.enable()


def test_graphed_call_counts_the_launches_its_replays_make(monkeypatch):
    """The first call runs on a side stream and counts its launches; the
    capture's launches are taken back (a capture runs nothing); each replay
    adds the launches the graph holds; a capture that fails leaves the
    counts as they were and raises."""
    api = FakeGraphAPI()
    api.install(monkeypatch)

    def kernel():
        kernel.launches += 1
    kernel.launches = 0

    class Out:
        def record_stream(self, stream):
            pass

    def fn():
        kernel()
        kernel()
        return Out()

    monkeypatch.setattr(graph, "launch_counters", lambda: (kernel,))
    call = graph.GraphedCall(fn)
    first = call()
    assert api.side == 1 and kernel.launches == 2 and call.graph is None
    for n in range(2, 6):
        assert call() is call.output
        assert kernel.launches == 2 * n
    assert (api.captures, api.replays, call.held) == (1, 4, {kernel: 2})
    assert first is not call.output

    def broken():
        kernel()
        raise RuntimeError("operation not permitted when stream is capturing")

    failing = graph.GraphedCall(broken)
    failing._warm = True
    before = kernel.launches
    with pytest.raises(RuntimeError, match="capturing"):
        failing()
    assert kernel.launches == before and failing.graph is None


def test_launch_counters_are_the_smoke_kernels():
    """``GraphedCall`` counts replayed launches for every kernel the chip
    smoke reports."""
    assert [w.__name__ for w in graph.launch_counters()] == list(chip_smoke.KERNELS)


def test_cpu_engine_runs_its_bodies_directly():
    """On the CPU the compiled decode and prefill are the eager bodies."""
    engine = ts.DecodeEngine(_tiny(ts), seed=0, device="cpu")
    engine.warmup(4)
    assert engine._prefill_fns[0].func is ts._prefill_step
    assert engine._decode_fn.func is ts._decode_step
    assert engine._decode_fn.args == (engine._state,)
