"""The node self-test payloads of the port against the JAX package's, on
the CPU: the triad (``workloads/kernels.py``; the reference's Pallas
kernel in interpret mode), the HBM probe's report, the device smoke
(``workloads/smoke.py``), the bf16 and int8 matmul chains
(``workloads/matmul_bench.py``) and the validator's ``smoke`` component
(``validator/``).

Tolerances: the triad rounds once in both (a fused multiply-add), so it is
compared bit for bit; the smoke probe is full f32 in both, within 1e-5;
the bf16 chain within 2e-2 of its largest value (the frameworks round each
product to bf16 at their own places); the int8 chain is integer
arithmetic, compared exactly.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from tpu_operator.workloads import kernels as jk
from tpu_operator_torch import device as tdevice
from tpu_operator_torch.validator import main as vmain
from tpu_operator_torch.validator import status as status_files
from tpu_operator_torch.validator import workload_entry
from tpu_operator_torch.workloads import autotune as tautotune
from tpu_operator_torch.workloads import kernels as tk
from tpu_operator_torch.workloads import matmul_bench as tmb
from tpu_operator_torch.workloads import smoke as tsmoke


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    these shapes are small."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32).view(np.int32)


# ---------------------------------------------------------------------------
# triad and the HBM probe
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("block_rows", [256, 1024])
@pytest.mark.parametrize("inplace", [False, True])
@pytest.mark.parametrize("alpha", [2.0, 0.5, 0.3])
@pytest.mark.parametrize("shape", [(1024, 128), (512, 512)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_triad_matches_reference_bitwise(shape, alpha, inplace, block_rows):
    rng = np.random.default_rng(sum(shape) + int(alpha * 10))
    x = rng.standard_normal(shape, dtype=np.float32)
    y = rng.standard_normal(shape, dtype=np.float32)
    # a band of large exponent gaps, where a sum rounded twice would show
    y[:, :16] *= np.float32(3e5)
    want = jk.triad(jnp.asarray(x), jnp.asarray(y), alpha, block_rows, inplace)
    got = tk.triad(torch.from_numpy(x.copy()), torch.from_numpy(y), alpha, block_rows, inplace)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_triad_inplace_writes_x_and_plain_keeps_it():
    x = torch.ones((256, 128))
    y = torch.full((256, 128), 2.0)
    got = tk.triad(x, y, 0.5, 128, inplace=True)
    assert got.data_ptr() == x.data_ptr()
    assert torch.equal(x, torch.full_like(x, 2.5))
    fresh = tk.triad(x, y, 2.0, 128)
    assert fresh.data_ptr() != x.data_ptr()
    assert torch.equal(x, torch.full_like(x, 2.5)) and torch.equal(fresh, torch.full_like(x, 7.0))


def test_triad_rows_must_divide_into_blocks():
    x = np.ones((1000, 128), np.float32)
    with pytest.raises(ValueError, match="multiple of block_rows") as want:
        jk.triad(jnp.asarray(x), jnp.asarray(x), 2.0, 256)
    with pytest.raises(ValueError, match="multiple of block_rows") as got:
        tk.triad(torch.from_numpy(x), torch.from_numpy(x), 2.0, 256)
    assert str(got.value) == str(want.value)


def test_cpu_tensors_never_launch_the_kernel():
    from tpu_operator_torch.kernels.triad import triad_kernel

    before = triad_kernel.launches
    tk.triad(torch.ones((8, 128)), torch.ones((8, 128)), 2.0, 8, inplace=True)
    assert triad_kernel.launches == before


def test_hbm_probe_report_matches_reference_keys():
    want = jk.hbm_bandwidth_probe(size_mb=8, iters=2)
    got = tk.hbm_bandwidth_probe(size_mb=8, iters=2, device="cpu")
    assert set(got) == set(want)
    assert got["size_mb"] == want["size_mb"] == 8.0
    assert (got["platform"], got["kernel"]) == ("cpu", want["kernel"]) == ("cpu", "triad")
    assert got["bandwidth_gbps"] > 0 and got["time_ms"] > 0


# ---------------------------------------------------------------------------
# device smoke
# ---------------------------------------------------------------------------


def test_smoke_probe_matches_reference_expression():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((96, 96), dtype=np.float32)
    y = rng.standard_normal((96, 96), dtype=np.float32)
    want = jnp.tanh(jnp.matmul(x, y, precision=lax.Precision.HIGHEST)) + x[:, :1]
    got = tsmoke.smoke_probe(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_smoke_probe_restores_the_tf32_setting(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    tsmoke.smoke_probe(torch.ones((4, 4)), torch.ones((4, 4)))
    assert torch.backends.cuda.matmul.allow_tf32 is True


class TestSmoke:
    """Twins of ``tests/test_workloads.py::TestSmoke``: on the CPU the port
    sees one device (the reference's virtual mesh has eight)."""

    def test_passes(self):
        report = tsmoke.run_smoke(expected_devices=1, size=64, device="cpu")
        assert report == {"device_count": 1, "platform": "cpu", "devices": ["cpu"], "ok": True}

    def test_insufficient_devices(self):
        with pytest.raises(RuntimeError, match="expected >= 100"):
            tsmoke.run_smoke(expected_devices=100, device="cpu")


@pytest.mark.parametrize("device, count, want", [
    ("cpu", 0, ["cpu"]),
    (None, 3, ["cuda:0", "cuda:1", "cuda:2"]),
    ("cuda", 2, ["cuda:0", "cuda:1"]),
    ("cuda:1", 2, ["cuda:1"]),
])
def test_local_devices(monkeypatch, device, count, want):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: count > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    assert [str(d) for d in tdevice.local_devices(device)] == want


# ---------------------------------------------------------------------------
# matmul chains
# ---------------------------------------------------------------------------


def test_bf16_matmul_chain_matches_reference():
    rng = np.random.default_rng(11)
    size = 64
    x = rng.standard_normal((size, size), dtype=np.float32)
    y = rng.standard_normal((size, size), dtype=np.float32) / np.float32(size ** 0.5)
    jx, jy = jnp.asarray(x, jnp.bfloat16), jnp.asarray(y, jnp.bfloat16)
    want = np.asarray(lax.fori_loop(0, 3, lambda i, acc: acc @ jy, jx * 1.001), np.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    ty = torch.from_numpy(y).to(torch.bfloat16)
    got = tmb.matmul_chain(tx, ty, 1.001, 3).float().numpy()
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def test_int8_matmul_chain_matches_reference_exactly():
    rng = np.random.default_rng(12)
    size = 64
    x = rng.integers(-4, 5, (size, size)).astype(np.int8)
    y = rng.integers(-4, 5, (size, size)).astype(np.int8)
    dot = lambda a, b: lax.dot_general(  # noqa: E731
        a, b, (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32)

    def step(i, acc):
        return lax.shift_right_arithmetic(dot(acc, jnp.asarray(y)), 7).astype(jnp.int8)

    want = np.asarray(lax.fori_loop(0, 3, step, jnp.asarray(x) + jnp.int8(1.001)))
    got = tmb.int8_matmul_chain(torch.from_numpy(x), torch.from_numpy(y), 1.001, 3)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("probe, rate", [("matmul_tflops", "tflops"), ("int8_matmul_tops", "tops")])
def test_rate_probes_report_the_references_fields(probe, rate):
    from tpu_operator.workloads import matmul_bench as jmb

    want = getattr(jmb, probe)(size=64, iters=2, unroll=1, reps=2)
    got = getattr(tmb, probe)(size=64, iters=2, reps=2, device="cpu")
    noisy = {"unstable_timing", "dispatch_overhead_ms_est"}
    assert set(got) - noisy == set(want) - noisy
    assert got["platform"] == "cpu" and got["iters"] == [2, 12] and got[rate] > 0


@pytest.mark.parametrize("name, want", [
    ("NVIDIA H100 80GB HBM3", "h100-sxm"),
    ("NVIDIA H100 SXM5 80GB", "h100-sxm"),
    ("NVIDIA H100 PCIe", "h100-pcie"),
    ("NVIDIA H100 NVL", "h100-nvl"),
    ("NVIDIA A100-SXM4-80GB", ""),
    ("NVIDIA H200", ""),
    (None, ""),
])
def test_chip_generation(monkeypatch, name, want):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: name is not None)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: name)
    assert tmb.chip_generation() == want
    assert not want or (want in tmb.PEAK_TFLOPS and want in tmb.PEAK_INT8_TOPS)


def test_autotune_keys_on_the_chip_generation(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA H100 80GB HBM3")
    monkeypatch.delenv("TPU_GENERATION", raising=False)
    monkeypatch.setattr(tautotune, "_gen_cache", (None, ""))
    assert tautotune._local_generation() == "h100-sxm"
    monkeypatch.setenv("TPU_GENERATION", "h100-pcie")
    assert tautotune._local_generation() == "h100-pcie"


# ---------------------------------------------------------------------------
# the validator's smoke component (twins of tests/test_validator.py::TestPerfFloors)
# ---------------------------------------------------------------------------


@pytest.fixture
def ctx(tmp_path):
    return vmain.Context(node_name="gpu-0", validation_dir=str(tmp_path / "validations"),
                         retry_interval=0.01, device="cpu")


def _stub_probes(monkeypatch, tflops=None):
    monkeypatch.setattr(tsmoke, "run_smoke", lambda **kw: {"ok": True})
    if tflops is not None:
        monkeypatch.setattr(tmb, "matmul_tflops", lambda **kw: {"tflops": tflops})


class TestPerfFloors:
    def test_enforce_floor(self):
        vmain.enforce_floor("x", measured=100.0, floor=None)  # no floor: no-op
        vmain.enforce_floor("x", measured=100.0, floor=99.0)
        with pytest.raises(RuntimeError, match="below configured floor"):
            vmain.enforce_floor("x", measured=98.9, floor=99.0)

    @pytest.mark.parametrize("tflops, passes", [(50.0, False), (120.0, True), (150.0, True)])
    def test_smoke_against_tflops_floor(self, ctx, monkeypatch, tflops, passes):
        _stub_probes(monkeypatch, tflops)
        ctx.min_tflops = 120.0
        if not passes:
            with pytest.raises(RuntimeError, match="below configured floor"):
                vmain.validate_smoke(ctx)
            return
        report = vmain.validate_smoke(ctx)
        assert report["matmul_bf16_tflops"] == tflops
        assert report["matmul_bf16_tflops_per_chip"] == {"cpu": tflops}

    def test_slowest_device_gates(self, ctx, monkeypatch):
        rates = {"cuda:0": 400.0, "cuda:1": 90.0}
        _stub_probes(monkeypatch)
        monkeypatch.setattr(vmain, "local_devices",
                            lambda device: [torch.device(d) for d in rates])
        monkeypatch.setattr(tmb, "matmul_tflops", lambda device, **kw: {"tflops": rates[str(device)]})
        ctx.min_tflops = 100.0
        with pytest.raises(RuntimeError, match=r"\(cuda:1\) 90.00 below configured floor"):
            vmain.validate_smoke(ctx)

    def test_smoke_without_floor_skips_bench(self, ctx, monkeypatch):
        _stub_probes(monkeypatch)
        # matmul_tflops NOT patched: the no-floor path must not call it
        monkeypatch.setattr(tmb, "matmul_tflops", None)
        report = vmain.validate_smoke(ctx)
        assert "matmul_bf16_tflops" not in report

    def test_below_floor_withholds_status_file(self, ctx, monkeypatch):
        _stub_probes(monkeypatch, 1.0)
        ctx.min_tflops = 120.0
        monkeypatch.setitem(vmain.COMPONENTS, "smoke", (vmain.validate_smoke, "smoke-perf-ready"))
        with pytest.raises(RuntimeError):
            vmain.run_component("smoke", ctx, max_attempts=2)
        assert status_files.read_status("smoke-perf-ready", ctx.validation_dir) is None

    def test_passing_run_writes_status_file(self, ctx, monkeypatch):
        _stub_probes(monkeypatch, 150.0)
        ctx.min_tflops = 120.0
        monkeypatch.setitem(vmain.COMPONENTS, "smoke", (vmain.validate_smoke, "smoke-perf-ready"))
        payload = vmain.run_component("smoke", ctx, max_attempts=1)
        assert status_files.read_status("smoke-perf-ready", ctx.validation_dir) == payload

    def test_real_payloads_on_cpu(self, ctx, monkeypatch):
        """The real smoke and matmul chain on the CPU (the chain cut from
        the component's 4096 to 64), held to a floor any machine passes (the
        report rounds the rate to 0.01, so a slow CPU may read 0.0)."""
        real = tmb.matmul_tflops
        monkeypatch.setattr(tmb, "matmul_tflops", lambda size, iters, device: real(
            size=64, iters=2, reps=2, device=device))
        ctx.min_tflops = 0.0
        report = vmain.run_component("smoke", ctx, max_attempts=1)
        assert report["ok"] and report["matmul_bf16_tflops_per_chip"].keys() == {"cpu"}


@pytest.mark.parametrize("env, gen, want", [
    ({}, "h100-sxm", None),
    ({"MIN_TFLOPS": "0"}, "h100-sxm", 0.0),
    ({"MIN_TFLOPS": "250"}, "", 250.0),
    ({"MIN_TFLOPS": "fast"}, "h100-sxm", None),
    # the operator's table of TPU floors never gates a card
    ({"PERF_FLOORS_JSON": json.dumps({"v5e": {"matmul_tflops": 129.5}})}, "h100-sxm", None),
    ({"PERF_FLOORS_JSON": json.dumps({"h100-sxm": {"matmul_tflops": 600}})}, "h100-sxm", 600.0),
    ({"PERF_FLOORS_JSON": json.dumps({"h100-sxm": {"matmul_tflops": 600}})}, "", None),
    ({"PERF_FLOORS_JSON": "{not json"}, "h100-sxm", None),
])
def test_min_tflops_from_env(monkeypatch, env, gen, want):
    for name in ("MIN_TFLOPS", "PERF_FLOORS_JSON", "EXPECTED_CHIPS"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    monkeypatch.setattr(tmb, "chip_generation", lambda: gen)
    assert vmain.Context.from_env().min_tflops == want


def test_context_from_env(monkeypatch, tmp_path):
    monkeypatch.setenv("NODE_NAME", "gpu-3")
    monkeypatch.setenv("VALIDATION_DIR", str(tmp_path))
    monkeypatch.setenv("EXPECTED_CHIPS", "8")
    monkeypatch.setenv("MIN_PSUM_GBPS_PER_CHIP", "40")
    got = vmain.Context.from_env()
    assert (got.node_name, got.validation_dir, got.expected_chips, got.min_psum_gbps_per_chip) == (
        "gpu-3", str(tmp_path), 8, 40.0)


def test_workload_entry_prints_the_report(capsys, monkeypatch):
    monkeypatch.delenv("EXPECTED_CHIPS", raising=False)
    assert workload_entry.main(device="cpu") == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["ok"] is True and report["device_count"] == 1
    monkeypatch.setenv("EXPECTED_CHIPS", "2")
    with pytest.raises(RuntimeError, match="expected >= 2"):
        workload_entry.main(device="cpu")


def test_validator_main_rejects_unported_components(monkeypatch):
    for component in ("", "libtpu"):
        monkeypatch.setenv("COMPONENT", component)
        assert vmain.main() == 1
    assert sorted(vmain.COMPONENTS) == ["driver", "plugin", "slice", "smoke", "workload"]
    # the node-status exporter is ported: it serves (here: returns at once)
    from tpu_operator_torch.validator.metrics import NodeMetrics

    served = []
    monkeypatch.setattr(NodeMetrics, "run_forever", lambda self: served.append(self))
    monkeypatch.setenv("COMPONENT", "metrics")
    assert vmain.main() == 0 and len(served) == 1
