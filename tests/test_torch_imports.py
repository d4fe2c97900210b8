"""Import and no-fallback guards of the PyTorch/CUDA port.

- No file of ``tpu_operator_torch/`` or ``chip_smoke.py`` imports jax,
  jaxlib or the JAX package (an AST scan: the test process itself has
  jax loaded, so ``sys.modules`` proves nothing).
- Importing the port builds nothing and needs neither nvcc nor triton.
- Entry points given no device raise without CUDA instead of running on
  the CPU (the multichip dry run, the process-group bootstrap and the
  slice's payloads too), and ``chip_smoke.py`` fails without a card.
"""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "tpu_operator_torch"
FORBIDDEN_ROOTS = ("jax", "jaxlib")


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    root = module.split(".")[0]
    return root in FORBIDDEN_ROOTS or module == "tpu_operator" or module.startswith("tpu_operator.")


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            bad += [a.value for a in node.args[:1]
                    if isinstance(a, ast.Constant) and _forbidden(str(a.value))]
    assert not bad, f"{path} imports {bad}"


def test_guard_tells_the_port_from_the_reference():
    assert _forbidden("jax.numpy") and _forbidden("tpu_operator.workloads.serving")
    assert _forbidden("tpu_operator") and not _forbidden("tpu_operator_torch.workloads")


def test_import_builds_nothing_and_needs_no_toolchain(tmp_path):
    """Every module imports in a fresh interpreter whose PATH has no nvcc,
    with CUDA_HOME unset and triton unimportable; no library is built."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    )
    (tmp_path / "triton.py").write_text("raise ImportError('triton is absent here')\n")
    code = (
        "import importlib, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "from tpu_operator_torch.kernels import build\n"
        "assert not build._loaded, build._loaded\n"
        "assert 'triton' not in sys.modules\n"
        "print('ok')\n"
    )
    build_dir = PORT / "kernels" / "_build"
    before = sorted(build_dir.iterdir()) if build_dir.exists() else None
    env = {k: v for k, v in os.environ.items() if k != "CUDA_HOME"}
    env["PATH"] = str(tmp_path)
    env["PYTHONPATH"] = os.pathsep.join([str(tmp_path), str(REPO), env.get("PYTHONPATH", "")])
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
    after = sorted(build_dir.iterdir()) if build_dir.exists() else None
    assert after == before


def test_unset_device_raises_without_cuda(monkeypatch):
    from tpu_operator_torch.entry import entry
    from tpu_operator_torch.workloads.serving import DecodeEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        DecodeEngine()
    with pytest.raises(RuntimeError, match="CUDA"):
        entry(device="cuda")



def test_multichip_entry_and_bootstrap_raise_without_cuda(monkeypatch):
    from tpu_operator_torch.entry import dryrun_multichip
    from tpu_operator_torch.workloads.distributed import initialize, spawn_world

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        initialize({})
    with pytest.raises(RuntimeError, match="CUDA"):
        initialize({"TPU_WORKER_ID": "1", "TPU_WORKER_HOSTNAMES": "a,b"})
    with pytest.raises(RuntimeError, match="CUDA"):
        spawn_world(2, print)


def test_slice_payloads_raise_without_cuda(monkeypatch):
    from tpu_operator_torch.validator.main import Context, validate_slice
    from tpu_operator_torch.workloads.allreduce import run_allreduce
    from tpu_operator_torch.workloads.collectives import run_collectives_check
    from tpu_operator_torch.workloads.distributed import gang_world
    from tpu_operator_torch.workloads.fabric import run_fabric_probe
    from tpu_operator_torch.workloads.multiproc import run_multiprocess_check, run_multislice_check

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (run_allreduce, run_collectives_check, lambda: run_fabric_probe("1x1x1"),
                 run_multiprocess_check, run_multislice_check, lambda: validate_slice(Context()),
                 lambda: gang_world().__enter__()):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_elastic_trainer_raises_without_cuda(monkeypatch, tmp_path):
    from tpu_operator_torch.dataplane.worker import JobWorkerMain
    from tpu_operator_torch.workloads.checkpoint import CheckpointStore
    from tpu_operator_torch.workloads.distributed import RankPool
    from tpu_operator_torch.workloads.training import InProcessJobRunner, ResumableTrainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    store = CheckpointStore(str(tmp_path))
    trainer = ResumableTrainer(store)
    for call in (lambda: trainer.resume(1), lambda: RankPool(2, print),
                 lambda: InProcessJobRunner(None, "ns", "job", store),
                 lambda: JobWorkerMain(None, "ns", {"TPU_JOB_NAME": "job"})):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert not trainer.ready and trainer.resumes == []


def test_self_test_payloads_raise_without_cuda(monkeypatch):
    from tpu_operator_torch.workloads.kernels import hbm_bandwidth_probe
    from tpu_operator_torch.workloads.smoke import run_smoke

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_smoke()
    with pytest.raises(RuntimeError, match="CUDA"):
        hbm_bandwidth_probe()

def _run_smoke(cwd, extra_env=None):
    env = dict(os.environ, **(extra_env or {}))
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_card():
    out = _run_smoke(REPO, {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
