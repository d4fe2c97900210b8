"""The timed chains as one CUDA-graph replay per timed call, on the CPU.

The reference times every rate it publishes as one jitted program over a
``fori_loop`` of ``n`` steps; on the card the port captures each chain
length once (``kernels/graph.GraphedChain``) and times replays. Here a
stand-in for the CUDA graph API (``tests/test_torch_graphs_mesh.py``'s
``FakeGraphAPI``: a capture runs the function, a replay runs nothing)
holds what a card does, and the CPU path is held to today's eager results:

- one capture per chain length, before ``two_point_min_timing``'s first
  clock reading, so none falls inside a timed pair, and each timed call
  is one seed write and one replay;
- the seed lives in one device scalar, written in place before every
  replay, and every timed call sees its own value;
- each call counts its ``n`` launches once (1226 for the exporter's
  ``hbm_bandwidth_probe(size_mb=64, iters=25)`` call pattern), in the
  sweep as eagerly;
- a failed capture raises and takes its launches back;
- every probe frees its graphs before it returns;
- on the CPU every chain runs eagerly and returns what the loops returned
  before the graphs;
- a tensor seed rounds as a Python float seed does;
- the int8 MLP's weights are column-major from ``_build_params`` and the
  loader, and the int8 MLP matches the reference's exactly.

Only the last test imports JAX (the reference's int8 MLP).
"""

import types
import weakref

import numpy as np
import pytest
import torch

from tests.test_torch_graphs_mesh import FakeGraphAPI
from tpu_operator_torch.kernels import graph
from tpu_operator_torch.workloads import autotune, kernels, matmul_bench, multiproc, serving
from tpu_operator_torch.workloads import flashattention as tfa
from tpu_operator_torch.workloads import timing as tt


class ChainAPI(FakeGraphAPI):
    """``FakeGraphAPI`` that also logs, in order, each capture, each replay
    with the value the seed scalar ``seed`` holds then (when given), and
    keeps a weak reference to every graph it made."""

    def __init__(self):
        super().__init__()
        self.log = []
        self.graphs = []
        self.seed = None

    def install(self, monkeypatch):
        super().install(monkeypatch)
        api, fake_graph = self, torch.cuda.CUDAGraph

        class CUDAGraph(fake_graph):
            def __init__(self):
                api.graphs.append(weakref.ref(self))

            def replay(self):
                super().replay()
                api.log.append(("replay", None if api.seed is None else float(api.seed)))

        graph_ctx = torch.cuda.graph

        def logged_graph(g):
            api.log.append(("capture",))
            return graph_ctx(g)

        monkeypatch.setattr(torch.cuda, "CUDAGraph", CUDAGraph)
        monkeypatch.setattr(torch.cuda, "graph", logged_graph)
        monkeypatch.setattr(torch.Tensor, "record_stream", lambda self, stream: None)
        monkeypatch.setattr(graph, "replays_on", lambda device: True)

    def alive(self) -> int:
        return sum(ref() is not None for ref in self.graphs)


@pytest.fixture()
def api(monkeypatch):
    api = ChainAPI()
    api.install(monkeypatch)
    return api


@pytest.fixture()
def kernel(monkeypatch):
    """A stand-in kernel wrapper that counts its launches, the only one the
    graph code counts."""
    def kernel():
        kernel.launches += 1
    kernel.launches = 0
    monkeypatch.setattr(graph, "launch_counters", lambda: (kernel,))
    return kernel


def _counting_chain(kernel, seen=None):
    """A chain of ``n`` stand-in launches whose scalar is the seed."""
    def body(s, n):
        if seen is not None:
            seen.append(s)
        for _ in range(n):
            kernel()
        return torch.as_tensor(s, dtype=torch.float32) * 1
    return body


def _clocked(monkeypatch, log):
    """Make ``two_point_min_timing``'s clock log each reading."""
    ticks = iter(range(10**6))

    def perf_counter():
        log.append(("clock",))
        return float(next(ticks))
    monkeypatch.setattr(tt, "time", types.SimpleNamespace(perf_counter=perf_counter))


def test_each_length_is_captured_once_outside_every_timed_pair(api, kernel, monkeypatch):
    """Two lengths, two captures, both before the first clock reading; every
    timed call between its two readings holds exactly one replay."""
    _clocked(monkeypatch, api.log)
    with graph.GraphedChain(_counting_chain(kernel), "cpu", "test") as chain:
        api.seed = chain.seed
        timing = tt.two_point_min_timing(lambda s, n: float(chain(s, n)), 3, 18, reps=4)
    assert len(timing.pairs) == 4 and api.captures == 2
    first_clock = api.log.index(("clock",))
    assert [e for e in api.log[:first_clock]] == [("capture",), ("capture",)]
    timed = api.log[first_clock:]
    assert all(e != ("capture",) for e in timed)
    windows = [timed[i + 1:i + 2] for i in range(0, len(timed), 3)]
    assert len(windows) == 8 and all(len(w) == 1 and w[0][0] == "replay" for w in windows)
    assert timed[2::3] == [("clock",)] * 8


def test_the_seed_is_written_in_place_before_every_replay(api, kernel):
    """The body sees one device scalar, the same tensor at warm-up and
    capture; each timed call's replay finds that call's seed in it, and no
    two timed calls see the same value."""
    seen = []
    with graph.GraphedChain(_counting_chain(kernel, seen), "cpu", "test") as chain:
        api.seed = chain.seed
        tt.two_point_min_timing(lambda s, n: float(chain(s, n)), 2, 12, reps=5)
        held = chain.seed
    assert len(seen) == 4 and all(s is held for s in seen)  # warm-up + capture, 2 lengths
    replayed = [e[1] for e in api.log if e[0] == "replay"]
    want = [np.float32(1.0 + 0.001 * k) for k in range(2, 12)]
    assert replayed == [float(w) for w in want]
    assert len(set(replayed)) == len(replayed)


@pytest.mark.parametrize("iters, launches", [(25, 1226), (50, 2451)],
                         ids=["exporter_probe", "default_probe"])
def test_each_call_counts_its_launches_once(api, kernel, iters, launches):
    """``hbm_bandwidth_probe``'s call pattern (one check launch, then
    ``two_point_min_timing`` over ``iters`` and ``6 * iters`` with 6 pairs):
    the warm-ups count, the captures do not, every replay does."""
    kernel()  # the probe's numerics check
    with graph.GraphedChain(_counting_chain(kernel), "cpu", "triad") as chain:
        tt.two_point_min_timing(lambda s, n: float(chain(s, n)), iters, 6 * iters, reps=6)
        held = {n: h for n, (_, _, h) in chain.graphs.items()}
    assert kernel.launches == launches
    assert held == {iters: {kernel: iters}, 6 * iters: {kernel: 6 * iters}}
    assert (api.side, api.captures, api.replays) == (2, 2, 12)


def test_a_sweep_counts_the_launches_it_counted_eagerly(kernel, monkeypatch):
    """The sweep's two passes launch as many kernels through replays as
    through the eager chains, and its pass 1 times one replay."""
    counts = {}
    for replays in (False, True):
        with monkeypatch.context() as mp:
            if replays:
                ChainAPI().install(mp)
            kernel.launches = 0

            def make_runner(config):
                chain = graph.GraphedChain(_counting_chain(kernel), "cpu", "sweep test")
                return lambda s, n: float(chain(s, n))

            records, winner = autotune.sweep(make_runner, [{"block_m": 64}, {"block_m": 128}],
                                             1e9, iters=2, reps=3, prune_ratio=1e9)
            assert winner is not None and not any(r.error for r in records)
            counts[replays] = kernel.launches
    assert counts[True] == counts[False] == 2 * (2 * 2 + (2 + 8) + 3 * (2 + 8))


def test_a_failed_capture_raises_and_takes_its_launches_back(api, kernel):
    """The warm-up's launches stand (they ran); the capture's are taken
    back; nothing is kept, and nothing falls back to the eager loop."""
    def body(s, n):
        for _ in range(n):
            kernel()
        if api.phase == "capture":
            raise RuntimeError("operation not permitted when stream is capturing")
        return torch.zeros(())

    chain = graph.GraphedChain(body, "cpu", "test")
    with pytest.raises(RuntimeError, match="capturing"):
        chain(1.0, 5)
    assert kernel.launches == 5 and chain.graphs == {} and api.replays == 0
    with pytest.raises(RuntimeError, match="capturing"):
        chain(1.0, 5)  # tried again, never run eagerly in its place
    assert kernel.launches == 10 and chain.graphs == {}


def _matmul(dev):
    return matmul_bench.matmul_tflops(size=16, iters=1, reps=2, device=dev)


def _int8(dev):
    return matmul_bench.int8_matmul_tops(size=16, iters=1, reps=2, device=dev)


def _bench(dev):
    return tfa.flash_attention_bench(seq_len=32, heads=2, head_dim=16, iters=1, reps=1,
                                     window=8, device=dev)


def _sweep_forward(dev):
    return autotune.sweep_flash(seq_len=32, heads=1, head_dim=16, iters=1, reps=1,
                                prune_ratio=1e9, device=dev)


def _sweep_fwd_bwd(dev):
    return autotune.sweep_flash(seq_len=32, heads=1, head_dim=16, iters=1, reps=1, fwd_bwd=True,
                                prune_ratio=1e9, device=dev)


def _telemetry(dev):
    return multiproc.step_telemetry("worker-0", torch.device(dev), n=4)


PROBES = {"matmul": (_matmul, 2), "int8": (_int8, 2), "bench": (_bench, 12),
          "sweep_forward": (_sweep_forward, 4), "sweep_fwd_bwd": (_sweep_fwd_bwd, 4),
          "telemetry": (_telemetry, 1)}


@pytest.mark.parametrize("probe", sorted(PROBES))
def test_every_probe_frees_its_graphs_before_it_returns(api, probe):
    """Each chain length captured once, and no graph alive once the probe
    returns (its runners and chains dropped, no collection needed)."""
    fn, captures = PROBES[probe]
    fn("cpu")
    assert api.captures == captures and len(api.graphs) == captures
    assert api.alive() == 0


def test_a_chain_is_freed_when_its_block_raises(api, kernel):
    """A probe's ``with`` block frees its chain's graphs also when the
    timing raises."""
    with pytest.raises(ZeroDivisionError):
        with graph.GraphedChain(_counting_chain(kernel), "cpu", "triad") as chain:
            float(chain(1.0, 3))
            float(chain(1.001, 3))
            1 / 0
    assert api.captures == 1 and api.replays == 1 and api.alive() == 0


def test_telemetry_steps_are_replays(api):
    """The gang's telemetry: the first step warms and captures (the
    reference's compile), the other three are replays."""
    report, replays = multiproc.step_telemetry("worker-3", torch.device("cpu"), n=4)
    assert (report.steps, report.host, replays, api.captures) == (4, "worker-3", 3, 1)


# ---------------------------------------------------------------------------
# the CPU path: eager, today's results
# ---------------------------------------------------------------------------


@pytest.fixture()
def no_capture(monkeypatch):
    def refuse(fn):
        raise AssertionError("the CPU captured a chain")
    monkeypatch.setattr(graph, "_captured", refuse)
    monkeypatch.setattr(graph, "_side_stream_call", refuse)


@pytest.mark.parametrize("probe", sorted(PROBES))
def test_cpu_probes_run_their_chains_eagerly(no_capture, probe):
    PROBES[probe][0]("cpu")


def test_cpu_hbm_probe_runs_eagerly(no_capture):
    report = kernels.hbm_bandwidth_probe(size_mb=1, iters=2, device="cpu")
    assert report["platform"] == "cpu" and report["bandwidth_gbps"] > 0


def _inputs(size, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((size, size), generator=gen).to(torch.bfloat16)
    y = (torch.randn((size, size), generator=gen) / size ** 0.5).to(torch.bfloat16)
    return x, y


def test_cpu_matmul_runner_fetches_todays_values():
    """The runner's fetched scalars are the eager loop's, seed by seed."""
    fetched = []
    run = matmul_bench.matmul_chain_runner(24, "cpu", fetched)
    gen = torch.Generator(device="cpu").manual_seed(0)
    x = torch.randn((24, 24), generator=gen).to(torch.bfloat16)
    y = (torch.randn((24, 24), generator=gen) / 24 ** 0.5).to(torch.bfloat16)
    want = []
    for seed, n in ((1.0, 2), (1.001, 5), (0.5, 3)):
        run(seed, n)
        out = x * seed
        for _ in range(n):
            out = out @ y
        want.append(float(out.float().sum()))
    assert fetched == want


def test_cpu_int8_runner_runs_todays_chain(monkeypatch):
    """The int8 runner's chain, seed by seed, is the eager loop's (the seed
    truncated by ``int``: 0 for 0.5, 1 for 1.001)."""
    seen = []
    real = matmul_bench.int8_matmul_chain

    def spy(z, y, s, n):
        out = real(z, y, s, n)
        seen.append((z, y, s, n, out))
        return out
    monkeypatch.setattr(matmul_bench, "int8_matmul_chain", spy)
    run = matmul_bench.int8_chain_runner(16, "cpu")
    run(0.5, 2)
    run(1.001, 3)
    assert [s for _, _, s, _, _ in seen] == [0.5, 1.001]
    for z, y, s, n, out in seen:
        want = z + int(s)
        for _ in range(n):
            want = ((want.to(torch.int32) @ y.to(torch.int32)) >> 7).to(torch.int8)
        assert torch.equal(out, want)


def test_cpu_grad_chain_returns_todays_sum():
    """``attention_grad_chain`` is the float of ``attention_grad_steps``,
    and both give the eager loop's sum."""
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((1, 8, 2, 4), generator=gen) for _ in range(3))
    fn = lambda a, kk, vv: torch.tanh(a * kk) * vv  # noqa: E731
    got = tt.attention_grad_chain(fn, q, k, v)(q, k, v, 1.25, 3)
    a, kc, vc = q * 1.25, k, v
    for _ in range(3):
        a, kc, vc = (t.detach().requires_grad_(True) for t in (a, kc, vc))
        dq, dk, dv = torch.autograd.grad(fn(a, kc, vc).float().sum(), (a, kc, vc))
        a, kc, vc = a + dq * 0.001, kc + dk * 0.001, vc + dv * 0.001
    assert got == float(a.detach().float().sum())
    assert torch.equal(tt.attention_grad_steps(fn, q, k, v)(q, k, v, 1.25, 3),
                       torch.tensor(got))


# ---------------------------------------------------------------------------
# the seed as a device scalar
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [1.0, 1.001, 1.005, 1.3, 0.5, 0.501])
def test_a_tensor_seed_rounds_as_a_float_seed(seed):
    """bf16 times the f32 scalar gives the bits of bf16 times the float
    (the product rounded once); f32 likewise; the int8 chain truncates
    both alike (``int(0.5)`` is 0, ``int(1.001)`` is 1)."""
    s = torch.tensor(seed, dtype=torch.float32)
    x, y = _inputs(16, seed=4)
    assert torch.equal(tt.seeded(x, s).view(torch.int16), (x * seed).view(torch.int16))
    xf = x.float()
    assert torch.equal(tt.seeded(xf, s), xf * seed)
    assert torch.equal(matmul_bench.matmul_chain(x, y, s, 3), matmul_bench.matmul_chain(x, y, seed, 3))
    zi = torch.randint(-4, 5, (16, 16), generator=torch.Generator().manual_seed(1),
                       dtype=torch.int8)
    assert torch.equal(matmul_bench.int8_matmul_chain(zi, zi, s, 2),
                       matmul_bench.int8_matmul_chain(zi, zi, seed, 2))


def test_grad_steps_take_a_tensor_seed_as_a_float_seed():
    gen = torch.Generator().manual_seed(8)
    q, k, v = (torch.randn((1, 8, 2, 4), generator=gen).to(torch.bfloat16) for _ in range(3))
    steps = tt.attention_grad_steps(lambda a, kk, vv: torch.tanh(a * kk) * vv, q, k, v)
    assert torch.equal(steps(q, k, v, torch.tensor(1.001), 2), steps(q, k, v, 1.001, 2))


# ---------------------------------------------------------------------------
# the int8 MLP's weights
# ---------------------------------------------------------------------------

INT8_CONFIGS = {
    "default_widths": dict(d_model=32, n_heads=2, head_dim=16, d_ff=64),
    "ragged_widths": dict(d_model=20, n_heads=2, head_dim=8, d_ff=36),
}


def _serving_cfg(mod, **over):
    base = dict(vocab=64, page_tokens=4, max_pages=32, max_batch=4, max_seq=32, prefill_chunk=4,
                int8_mlp=True)
    base.update(over)
    return mod.ServingModelConfig(**base)


@pytest.mark.parametrize("widths", sorted(INT8_CONFIGS))
def test_int8_weights_are_column_major_with_their_shape(widths):
    """``w1_q``/``w2_q`` from ``_build_params`` and from the loader: the
    logical (K, N), column-major over storage padded to multiples of 8
    (zeros there), the values of the row-major build; ``_int_mm``'s
    operand is a view of that storage, no copy."""
    from tpu_operator_torch.weights import serving_params

    cfg = _serving_cfg(serving, **INT8_CONFIGS[widths])
    built = serving._build_params(cfg, seed=5, device="cpu")
    loaded = serving_params({k: v.numpy() for k, v in built.items()}, cfg, "cpu")
    for params in (built, loaded):
        for name, (k, n) in (("w1_q", (cfg.d_model, cfg.d_ff)), ("w2_q", (cfg.d_ff, cfg.d_model))):
            w = params[name]
            kp, np_ = -(-k // 8) * 8, -(-n // 8) * 8
            assert w.shape == (k, n) and w.dtype == torch.int8 and w.stride() == (1, kp)
            op = serving._int_mm_operand(w, kp, np_)
            assert op.data_ptr() == w.data_ptr() and op.shape == (kp, np_)
            assert torch.equal(op[:k, :n], w) and not op[k:].any() and not op[:, n:].any()
    assert all(torch.equal(built[k], loaded[k]) for k in built)


@pytest.mark.parametrize("m", [1, 8, 40])
@pytest.mark.parametrize("widths", sorted(INT8_CONFIGS))
def test_padded_operands_give_the_exact_product(widths, m):
    """What ``_int_matmul`` hands ``torch._int_mm`` on the card (``a``
    padded, ``b`` an ``int8_weight``'s view) gives the exact product,
    computed here in int32 as ``_int_mm`` does."""
    k, n = INT8_CONFIGS[widths]["d_model"], INT8_CONFIGS[widths]["d_ff"]
    gen = torch.Generator().manual_seed(m)
    a = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8)
    w = torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8)
    mp, kp, np_ = max(32, -(-m // 8) * 8), -(-k // 8) * 8, -(-n // 8) * 8
    a_p = torch.nn.functional.pad(a, (0, kp - k, 0, mp - m))
    b_p = serving._int_mm_operand(serving.int8_weight(w), kp, np_)
    got = (a_p.to(torch.int32) @ b_p.to(torch.int32))[:m, :n]
    assert torch.equal(got, a.to(torch.int32) @ w.to(torch.int32))


@pytest.mark.parametrize("widths", sorted(INT8_CONFIGS))
def test_int8_mlp_matches_the_reference_exactly(widths):
    """The port's ``_int8_matmul`` over its column-major weights, both MLP
    products, against the reference's on the same activations and weights:
    the same bits."""
    from tpu_operator.workloads import serving as js

    over = INT8_CONFIGS[widths]
    jparams = js._build_params(_serving_cfg(js, **over), seed=9)
    tparams = serving._build_params(_serving_cfg(serving, **over), seed=9, device="cpu")
    x = np.random.default_rng(9).standard_normal((6, over["d_model"])).astype(np.float32)
    want = np.asarray(js._int8_matmul(x, jparams["w1_q"], jparams["w1_s"]))
    got = serving._int8_matmul(torch.from_numpy(x), tparams["w1_q"], tparams["w1_s"]).numpy()
    np.testing.assert_array_equal(got, want)
    hidden = np.maximum(want, 0.0)
    want = np.asarray(js._int8_matmul(hidden, jparams["w2_q"], jparams["w2_s"]))
    got = serving._int8_matmul(torch.from_numpy(hidden), tparams["w2_q"], tparams["w2_s"]).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(want).all() and np.abs(want).sum() > 0
