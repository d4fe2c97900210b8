"""Two-point timing and the fwd+bwd chain of the port
(``workloads/timing.py``) against the JAX package's
(``tpu_operator/workloads/timing.py``), and ``flash_attention_bench`` at a
CPU-sized shape.

The timing estimator is driven by a fake clock, so both modules see the
same samples and must draw the same conclusions.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_operator.workloads import timing as jt
from tpu_operator_torch.workloads import flashattention as tfa
from tpu_operator_torch.workloads import timing as tt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    these shapes are tiny."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class _FakeClock:
    """``time`` stand-in whose clock advances only inside ``run``: by a
    per-call overhead (cycling through ``overheads``) plus n · per_iter."""

    def __init__(self, per_iter, overheads):
        self.now, self.per_iter, self.overheads, self.calls = 0.0, per_iter, overheads, []

    def perf_counter(self):
        return self.now

    def run(self, seed, n):
        self.now += self.overheads[len(self.calls) % len(self.overheads)] + n * self.per_iter
        self.calls.append((seed, n))


def _both(monkeypatch, per_iter, overheads, lo=2, hi=8, reps=5):
    out = []
    for module in (jt, tt):
        clock = _FakeClock(per_iter, overheads)
        monkeypatch.setattr(module, "time", clock)
        out.append((module.two_point_min_timing(clock.run, lo, hi, reps), clock))
    return out


def test_slope_cancels_a_noisy_overhead_like_reference(monkeypatch):
    (want, _), (got, clock) = _both(monkeypatch, 0.001, [0.1, 0.14, 0.1, 0.1, 0.14, 0.1])
    assert got.pairs == want.pairs and got.per_iter_s == want.per_iter_s
    assert math.isclose(got.per_iter_s, 0.001, rel_tol=1e-9)
    assert got.overhead_s == want.overhead_s and got.report_fields() == want.report_fields()
    assert got.inclusive_per_iter_s == want.inclusive_per_iter_s
    seeds = [seed for seed, _ in clock.calls]
    assert len(seeds) == 2 * 5 + 2 and len(set(seeds)) == len(seeds)  # never a cached result
    assert [n for _, n in clock.calls[:2]] == [2, 8]  # both programs warmed first


def test_a_non_positive_slope_leaves_only_the_inclusive_bound(monkeypatch):
    # the long chain always lands in the fast regime: every slope is negative
    (want, _), (got, _) = _both(monkeypatch, 0.0001, [0.2, 0.1])
    assert got.per_iter_s is None and want.per_iter_s is None
    assert got.overhead_s is None
    assert got.report_fields() == want.report_fields() and got.report_fields()["unstable_timing"]


@pytest.mark.parametrize("lo,hi,reps", [(2, 8, 0), (0, 8, 3), (8, 8, 3), (9, 8, 3)])
def test_bad_arguments_raise_like_reference(lo, hi, reps):
    for module in (jt, tt):
        with pytest.raises(ValueError):
            module.two_point_min_timing(lambda seed, n: None, lo, hi, reps)


def _chain_inputs(seed=0, shape=(1, 8, 2, 4)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def test_grad_chain_matches_reference():
    """Same function in both frameworks, 3 chained fwd+bwd steps folding
    all three cotangents back: the same final sum."""
    q, k, v = _chain_inputs()
    jchain = jt.attention_grad_chain(lambda a, kk, vv: jnp.tanh(a * kk) * vv, q, k, v)
    want = float(jchain(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 1.25, n=3))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tchain = tt.attention_grad_chain(lambda a, kk, vv: torch.tanh(a * kk) * vv, tq, tk, tv)
    got = tchain(tq, tk, tv, 1.25, 3)
    assert math.isclose(got, want, rel_tol=1e-5)


def test_grad_chain_moves_k_and_v_not_only_q():
    """Each step's inputs carry the previous step's dK and dV, so the
    dK/dV work sits on the chain and cannot be skipped."""
    q, k, v = (torch.from_numpy(a) for a in _chain_inputs(1))
    seen = []

    def attn(a, kk, vv):
        seen.append((a.detach().clone(), kk.detach().clone(), vv.detach().clone()))
        return tfa.flash_attention(a, kk, vv, causal=True, block_q=8, block_k=8)

    tt.attention_grad_chain(attn, q, k, v)(q, k, v, 1.0, 3)
    assert len(seen) == 3
    for before, after in zip(seen, seen[1:]):
        assert all(not torch.equal(x, y) for x, y in zip(before, after))
    assert torch.equal(seen[0][1], k) and torch.equal(seen[0][2], v)


def test_flash_attention_bench_on_cpu():
    """The bench's report, at a CPU-sized shape: the reference's keys
    (flashattention.py:1430-1459) plus the device, every time positive."""
    report = tfa.flash_attention_bench(seq_len=32, heads=2, head_dim=16, iters=1, reps=1,
                                       window=8, device="cpu")
    want_keys = {
        "seq_len", "heads", "flash_time_ms", "flash_tflops", "flash_fwd_bwd_ms", "window",
        "flash_window_time_ms", "dense_time_ms", "speedup_vs_dense", "dense_fwd_bwd_ms",
        "train_step_speedup_vs_dense", "dense_remat_fwd_bwd_ms",
        "train_step_speedup_vs_remat_dense",
    }
    assert set(report) == want_keys | {"device"} and report["device"] == "cpu"
    assert all(report[k] > 0 and math.isfinite(report[k]) for k in want_keys - {"seq_len",
                                                                               "heads", "window"})
