"""The driver installer, the validator's driver check and the node-status
exporter on the card (``agents/driver_installer.py``,
``validator/main.py::validate_driver``, ``validator/metrics.py``) against the
reference's libtpu installer, ``validate_libtpu`` and ``NodeMetrics``
(``tests/test_validator.py``'s ``TestLibtpuComponent``, ``TestNodeMetrics``
and ``TestLibtpuInstaller``).

The port's counterparts of the reference's names: the installed library is
``libcuda.so.1`` (a symlink to ``libcuda.so.1-<version>``; the reference's
``libtpu.so`` to ``libtpu-<version>.so``), the component is ``driver``
writing ``driver-ready`` (``libtpu``, ``libtpu-ready``), and the exporter's
card gauge is ``tpu_operator_node_gpus`` from the card probe
(``tpu_operator_node_tpu_chips`` from the node's allocatable) beside
``tpu_operator_node_driver_revalidations_total``
(``..._libtpu_revalidations_total``). Under that renaming both packages
must write the same files, reach the same outcomes and expose the same
series; every comparison is exact.

On a card the driver check also loads the installed library in a process
of its own and holds its card count to the probe's; here a stand-in
library built with ``g++`` answers ``cuInit`` and ``cuDeviceGetCount``.
"""

from __future__ import annotations

import os
import subprocess
import threading
import time

import prometheus_client
import pytest
import torch
from prometheus_client.parser import text_string_to_metric_families

import tests.test_torch_gpuinfo as inv
from tpu_operator import consts as ref_consts
from tpu_operator.agents import libtpu_installer as ref_installer
from tpu_operator.kube.fake import FakeClient
from tpu_operator.kube.sim import make_tpu_node
from tpu_operator.validator import main as ref_main
from tpu_operator.validator import status as ref_status
from tpu_operator.validator.metrics import NodeMetrics as RefNodeMetrics
from tpu_operator_torch import consts
from tpu_operator_torch.agents import driver_installer
from tpu_operator_torch.validator import main as vmain
from tpu_operator_torch.validator import status as status_files
from tpu_operator_torch.validator.metrics import NodeMetrics

NODE = "tpu-0"
FAKE_DRIVER = r"""
#include <cstdlib>
extern "C" int cuInit(unsigned int) { return INIT_RC; }
extern "C" int cuDeviceGetCount(int* n) {
  *n = std::getenv("CUDA_VISIBLE_DEVICES") ? 1 : COUNT;
  return 0;
}
"""


@pytest.fixture(scope="module")
def fake_driver(tmp_path_factory):
    """Stand-in driver libraries: count -> path (init fails for "broken")."""
    root = tmp_path_factory.mktemp("driver")
    src = root / "fake.cc"
    src.write_text(FAKE_DRIVER)
    out = {}
    for name, count, rc in (("4", 4, 0), ("3", 3, 0), ("broken", 4, 100)):
        lib = root / f"libcuda-{name}.so"
        subprocess.run(["g++", "-shared", "-fPIC", f"-DCOUNT={count}", f"-DINIT_RC={rc}",
                        "-o", str(lib), str(src)], check=True, timeout=120)
        out[name] = str(lib)
    return out


@pytest.fixture()
def node(tmp_path, monkeypatch):
    """Four cards on the probe's root."""
    root = inv.make_inventory(tmp_path / "node")
    monkeypatch.setenv("GPUINFO_SCAN_ROOT", str(root))
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    return root


def contexts(tmp_path):
    """(reference context, port context) over their own install and
    validation dirs; the port's runs on the CPU."""
    out = []
    for pkg, module in (("ref", ref_main), ("port", vmain)):
        client = FakeClient()
        client.create(make_tpu_node(NODE, chips=4))
        install = tmp_path / pkg / "install"
        install.mkdir(parents=True)
        kwargs = dict(client=client, node_name=NODE, validation_dir=str(tmp_path / pkg / "val"),
                      install_dir=str(install), retry_interval=0.01, resource_poll_retries=3,
                      pod_wait_retries=5)
        if module is vmain:
            kwargs["device"] = "cpu"
        out.append(module.Context(**kwargs))
    return out


def install_both(ref_ctx, ctx, source, marker=True):
    """The reference's test helper's library, and the port's installed from
    the same bytes."""
    for path, name in ((ref_ctx.install_dir, "libtpu.so"), (ctx.install_dir, consts.DRIVER_LIBRARY)):
        with open(source, "rb") as f, open(os.path.join(path, name), "wb") as out:
            out.write(f.read())
        if marker:
            open(os.path.join(path, consts.LIBTPU_CTR_READY_FILE), "w").close()


# -------------------------------------------------------------- the driver check


def test_fails_without_the_library(tmp_path):
    ref_ctx, ctx = contexts(tmp_path)
    with pytest.raises(RuntimeError, match="libtpu.so not found"):
        ref_main.validate_libtpu(ref_ctx)
    with pytest.raises(RuntimeError, match="libcuda.so.1 not found"):
        vmain.validate_driver(ctx)


def test_fails_without_the_marker(tmp_path, fake_driver):
    ref_ctx, ctx = contexts(tmp_path)
    install_both(ref_ctx, ctx, fake_driver["4"], marker=False)
    for fn, c in ((ref_main.validate_libtpu, ref_ctx), (vmain.validate_driver, ctx)):
        with pytest.raises(RuntimeError, match="installer ready marker missing"):
            fn(c)


def test_passes_and_writes_status(tmp_path, fake_driver):
    ref_ctx, ctx = contexts(tmp_path)
    install_both(ref_ctx, ctx, fake_driver["4"])
    want = ref_main.run_component("libtpu", ref_ctx, max_attempts=1)
    got = vmain.run_component("driver", ctx, max_attempts=1)
    assert got["size"] == want["size"] > 0
    assert status_files.read_status(consts.DRIVER_READY_FILE, ctx.validation_dir) == got
    assert ref_status.read_status(ref_consts.LIBTPU_READY_FILE, ref_ctx.validation_dir) == want
    assert vmain.COMPONENTS["driver"] == (vmain.validate_driver, "driver-ready")


def test_retry_until_installed(tmp_path, fake_driver):
    ref_ctx, ctx = contexts(tmp_path)
    done = threading.Event()

    def install_later():
        time.sleep(0.05)
        install_both(ref_ctx, ctx, fake_driver["4"])
        done.set()

    t = threading.Thread(target=install_later)
    t.start()
    got = vmain.run_component("driver", ctx, max_attempts=200)
    want = ref_main.run_component("libtpu", ref_ctx, max_attempts=200)
    t.join(10)
    assert done.is_set() and got["size"] == want["size"] > 0


@pytest.fixture()
def on_a_card(monkeypatch):
    """The driver check as it runs on a card (its device resolves to CUDA)."""
    monkeypatch.setattr(vmain, "resolve_device", lambda device: torch.device("cuda"))


def test_on_a_card_the_driver_answers_with_the_probed_count(tmp_path, fake_driver, node,
                                                            on_a_card, monkeypatch):
    _, ctx = contexts(tmp_path)
    driver_installer.install(fake_driver["4"], ctx.install_dir, "550.54.15")
    # every card of the node counts, whatever this process's CUDA may see
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "GPU-x")
    payload = vmain.validate_driver(ctx)
    assert payload == {"library": os.path.join(ctx.install_dir, consts.DRIVER_LIBRARY),
                       "size": os.path.getsize(fake_driver["4"]), "cards": 4,
                       "driver_version": inv.DRIVER}


@pytest.mark.parametrize("lib, match", [("3", "the driver reports 3 card"),
                                        ("broken", "did not answer")])
def test_on_a_card_a_wrong_or_silent_driver_fails(tmp_path, fake_driver, node, on_a_card, lib,
                                                  match):
    _, ctx = contexts(tmp_path)
    driver_installer.install(fake_driver[lib], ctx.install_dir, "550.54.15")
    with pytest.raises(RuntimeError, match=match):
        vmain.validate_driver(ctx)


def test_no_cuda_is_no_cpu_fallback(tmp_path, fake_driver, monkeypatch):
    """Given no device the check runs on the card: without CUDA it fails
    after the file checks instead of passing on them alone."""
    _, ctx = contexts(tmp_path)
    driver_installer.install(fake_driver["4"], ctx.install_dir)
    ctx.device = None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        vmain.validate_driver(ctx)


def test_context_reads_the_install_dir(monkeypatch):
    monkeypatch.setenv("LIBTPU_INSTALL_DIR", "/srv/driver-install")
    monkeypatch.delenv("PERF_FLOORS_JSON", raising=False)
    assert vmain.Context.from_env().install_dir == "/srv/driver-install"
    monkeypatch.delenv("LIBTPU_INSTALL_DIR")
    assert vmain.Context.from_env().install_dir == ref_main.Context().install_dir


# -------------------------------------------------------------- the exporter


SLICE_PAYLOAD = {
    "peak_busbw_gbps_per_chip": 42.5,
    "ring_attention": {"max_abs_err": 3.5e-7},
    "flash_attention": {"max_abs_err": 7.8e-3},
    "ring_flash_attention": {"max_abs_err": 5.4e-7},
    "pipeline": {"ok": True, "stages": 4, "max_abs_err_vs_sequential": 9e-8},
}
RENAMED = {"tpu_operator_node_tpu_chips": "tpu_operator_node_gpus",
           "tpu_operator_node_libtpu_revalidations_total":
               "tpu_operator_node_driver_revalidations_total",
           ref_consts.LIBTPU_READY_FILE: consts.DRIVER_READY_FILE}


def series(registry, rename=False):
    """{(sample name, labels): value} of the exposition, ``_created`` aside."""
    out = {}
    text = prometheus_client.generate_latest(registry).decode()
    for family in text_string_to_metric_families(text):
        for s in family.samples:
            if s.name.endswith("_created"):
                continue
            name = s.name
            labels = dict(s.labels)
            if rename:
                name = next((name.replace(k, v) for k, v in RENAMED.items() if k in name), name)
                labels = {k: RENAMED.get(v, v) for k, v in labels.items()}
            out[(name, tuple(sorted(labels.items())))] = s.value
    return out


def exporters(tmp_path, fake_driver, installed=True):
    ref_ctx, ctx = contexts(tmp_path)
    if installed:
        install_both(ref_ctx, ctx, fake_driver["4"])
    for c, module, ready in ((ref_ctx, ref_status, ref_consts.LIBTPU_READY_FILE),
                             (ctx, status_files, consts.DRIVER_READY_FILE)):
        module.write_status(ready, c.validation_dir, {"ok": True})
        module.write_status("slice-ready", c.validation_dir, SLICE_PAYLOAD)
    return (RefNodeMetrics(ref_ctx), ref_ctx), (NodeMetrics(ctx), ctx)


def test_exposition_equals_the_reference(tmp_path, fake_driver, node):
    (ref, _), (port, _) = exporters(tmp_path, fake_driver)
    for exp, revalidate in ((ref, ref.revalidate_libtpu), (port, port.revalidate_driver)):
        exp.collect_status_files()
        exp.collect_device_count()
        revalidate()
    got, want = series(port.registry), series(ref.registry, rename=True)
    assert got == want
    node_label = (("node", NODE),)
    assert got[("tpu_operator_node_gpus", node_label)] == 4
    assert got[("tpu_operator_node_driver_revalidations_total",
                (("node", NODE), ("result", "success")))] == 1
    assert got[("tpu_operator_node_component_ready",
                (("component", "driver-ready"), ("node", NODE)))] == 1
    assert got[("tpu_operator_node_component_ready",
                (("component", "plugin-ready"), ("node", NODE)))] == 0
    assert got[("tpu_operator_node_slice_pipeline_max_abs_err", node_label)] == 9e-8


def test_revalidation_failure_clears_the_barrier(tmp_path, fake_driver, node):
    (ref, ref_ctx), (port, ctx) = exporters(tmp_path, fake_driver, installed=False)
    ref.revalidate_libtpu()
    port.revalidate_driver()
    assert ref_status.read_status(ref_consts.LIBTPU_READY_FILE, ref_ctx.validation_dir) is None
    assert status_files.read_status(consts.DRIVER_READY_FILE, ctx.validation_dir) is None
    assert series(port.registry) == series(ref.registry, rename=True)


def test_the_card_gauge_counts_the_probe_and_keeps_its_value_on_failure(tmp_path, fake_driver,
                                                                       node, monkeypatch):
    (_, _), (port, _) = exporters(tmp_path, fake_driver)
    port.collect_device_count()
    (node / "dev" / "nvidia3").unlink()
    port.collect_device_count()
    assert port.registry.get_sample_value("tpu_operator_node_gpus", {"node": NODE}) == 3
    monkeypatch.setenv("GPUINFO_SCAN_ROOT", str(tmp_path / "absent"))
    port.collect_device_count()
    assert port.registry.get_sample_value("tpu_operator_node_gpus", {"node": NODE}) == 3


# -------------------------------------------------------------- the installer


def both_installs(tmp_path, *versions_and_sources):
    """Install each (source, version) with both installers into their own
    dirs; returns (reference dir, port dir, [(ref report, port report)])."""
    rdir, pdir = str(tmp_path / "ref"), str(tmp_path / "port")
    reports = [(ref_installer.install(src, rdir, version=v), driver_installer.install(src, pdir, v))
               for src, v in versions_and_sources]
    return rdir, pdir, reports


def port_name(ref_name: str) -> str:
    """The reference installer's file name in the port's naming."""
    if ref_name == "libtpu.so":
        return consts.DRIVER_LIBRARY
    if ref_name.startswith("libtpu-") and ref_name.endswith(".so"):
        return f"{consts.DRIVER_LIBRARY}-{ref_name[len('libtpu-'):-len('.so')]}"
    return ref_name


def read(path):
    with open(path) as f:
        return f.read()


def test_install_and_validate_round_trip(tmp_path, fake_driver):
    src = fake_driver["4"]
    rdir, pdir, [(rrep, prep), (rrep2, prep2)] = both_installs(
        tmp_path, (src, "1.2.3"), (src, "1.2.3"))
    assert (prep["changed"], prep2["changed"]) == (rrep["changed"], rrep2["changed"]) == (
        True, False)
    assert (prep["version"], prep["digest"]) == (rrep["version"], rrep["digest"])
    link = os.path.join(pdir, consts.DRIVER_LIBRARY)
    assert os.path.islink(link) and os.readlink(link) == "libcuda.so.1-1.2.3"
    assert os.readlink(os.path.join(rdir, "libtpu.so")) == "libtpu-1.2.3.so"
    for name in ("version", consts.LIBTPU_CTR_READY_FILE):
        assert read(os.path.join(pdir, name)) == read(os.path.join(rdir, name))
    # the validator's driver check passes against this dir
    ctx = vmain.Context(install_dir=pdir, validation_dir=str(tmp_path / "val"), device="cpu")
    assert vmain.validate_driver(ctx)["size"] == os.path.getsize(src)


def test_version_upgrade_repoints_the_symlink(tmp_path):
    a, b = tmp_path / "a.so", tmp_path / "b.so"
    a.write_bytes(b"v1" * 50)
    b.write_bytes(b"v2" * 50)
    rdir, pdir, reports = both_installs(tmp_path, (str(a), "1"), (str(b), "2"), (str(b), ""))
    assert [p["changed"] for _, p in reports] == [r["changed"] for r, _ in reports] == [
        True, True, True]
    assert os.readlink(os.path.join(pdir, consts.DRIVER_LIBRARY)) == \
        f"libcuda.so.1-{reports[2][1]['digest'][:12]}"
    for name in ("version", consts.LIBTPU_CTR_READY_FILE):
        assert read(os.path.join(pdir, name)) == read(os.path.join(rdir, name))
    # the same files, the library's under the port's names
    assert sorted(os.listdir(pdir)) == sorted(port_name(n) for n in os.listdir(rdir))


def test_explicit_source_takes_priority(tmp_path, monkeypatch):
    src = tmp_path / "custom-libcuda.so.1"
    src.write_bytes(b"custom")
    env = tmp_path / "env-libcuda.so.1"
    env.write_bytes(b"env")
    monkeypatch.setenv(driver_installer.LIBRARY_ENV, str(env))
    assert driver_installer.find_driver_library(str(src)) == str(src)
    assert ref_installer.find_libtpu(str(src)) == str(src)
    # a missing explicit source falls back to the env's path
    assert driver_installer.find_driver_library(str(tmp_path / "absent")) == str(env)
    monkeypatch.delenv(driver_installer.LIBRARY_ENV)
    monkeypatch.setattr(driver_installer, "loader_path", lambda: None)
    with pytest.raises(FileNotFoundError, match="libcuda.so.1"):
        driver_installer.find_driver_library()


def test_the_loader_resolves_a_soname():
    path = driver_installer.loader_path("libc.so.6", "printf")
    assert path and os.path.basename(path).startswith("libc") and os.path.exists(path)
    assert driver_installer.loader_path("libnot-a-library.so.9") is None


def test_oneshot_installs_with_the_probed_driver_version(tmp_path, fake_driver, node):
    install = tmp_path / "inst"
    assert driver_installer.main(["--oneshot", "--install-dir", str(install),
                                  "--source", fake_driver["4"]]) == 0
    assert read(install / "version").strip() == inv.DRIVER
    assert os.readlink(install / consts.DRIVER_LIBRARY) == f"libcuda.so.1-{inv.DRIVER}"
    assert (install / consts.LIBTPU_CTR_READY_FILE).exists()
