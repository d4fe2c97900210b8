"""The metrics exporter on the card (``agents/metrics_exporter_agent.py``)
against the reference's.

Each case drives both packages' exporters, each on its own registry and
its own copy of one fake cluster, through the same readings (floors,
probe samples, card inventories, probe reports) and must give the same
returns, the same Node writes and the same exposition: the metric
families (name, type, help), label sets and values of
``prometheus_client.generate_latest``, a counter's ``_created`` time
aside. The cases are the reference's grey-failure, hot-reload and
stale-series tests (``tests/test_telemetry.py``, ``tests/test_autotune.py``);
the device inventory is the reference's fake (two bytes of HBM, one in
use) as ``torch.cuda.mem_get_info`` reports it (one byte free of two).
The port's own probes run on the CPU where they are cheap (the matmul
chain, a gloo world of two ranks for ``probe_ici``).
"""

from __future__ import annotations

import json

import prometheus_client
import pytest
import torch
from prometheus_client.parser import text_string_to_metric_families

import tests.test_telemetry as ref_tel
from tpu_operator import consts as ref_consts
from tpu_operator.agents.metrics_exporter_agent import MetricsExporterAgent as RefExporter
from tpu_operator.kube.fake import FakeClient
from tpu_operator.kube.objects import new_object
from tpu_operator.kube.sim import make_tpu_node
from tpu_operator_torch import consts
from tpu_operator_torch.agents import metrics_exporter_agent as mea
from tpu_operator_torch.agents.metrics_exporter_agent import MetricsExporterAgent
from tpu_operator_torch.workloads import matmul_bench as tmb

NS = "tpu-operator"
NODE = "tpu-0"
BREACH = consts.PERF_BREACH_SAMPLES


def exposition(registry) -> dict:
    """{(family, type, help): {(sample name, sorted labels): value}} of a
    registry's text exposition, ``_created`` samples (times) aside."""
    text = prometheus_client.generate_latest(registry).decode()
    out = {}
    for family in text_string_to_metric_families(text):
        out[(family.name, family.type, family.documentation)] = {
            (s.name, tuple(sorted(s.labels.items()))): s.value
            for s in family.samples if not s.name.endswith("_created")}
    return out


def sample(registry, name, **labels):
    return registry.get_sample_value(name, labels or None)


def node_labels(store):
    node = store.get_or_none("v1", "Node", NODE)
    return (node or {}).get("metadata", {}).get("labels") or {}


class Patch:
    """Readings given to both packages at once: the card inventory
    (``jax.local_devices`` for the reference, ``local_devices`` and
    ``torch.cuda.mem_get_info`` for the port) and the probes' reports."""

    def __init__(self, monkeypatch):
        self.mp = monkeypatch
        monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (1, 2))

    def cards(self, n):
        self.mp.setattr("jax.local_devices", lambda: [ref_tel._FakeDevice(i) for i in range(n)])
        self.mp.setattr(mea, "local_devices",
                        lambda device=None: [torch.device("cuda", i) for i in range(n)])

    def no_runtime(self):
        def boom(*args, **kwargs):
            raise RuntimeError("runtime gone")
        self.mp.setattr("jax.local_devices", boom)
        self.mp.setattr(mea, "local_devices", boom)

    def probe(self, name, fn):
        for pkg in ("tpu_operator", "tpu_operator_torch"):
            module = "kernels" if name == "hbm_bandwidth_probe" else "matmul_bench"
            self.mp.setattr(f"{pkg}.workloads.{module}.{name}", fn)


def _boom(*args, **kwargs):
    raise RuntimeError("card busy")


def run_both(steps, floors=None, nodes=(make_tpu_node,), client=True,
             **kwargs) -> dict:
    """Each package's exporter over its own fake cluster (``nodes`` made
    as ``NODE``), the steps applied in turn: ``step(exporter, store)``.
    Asserts equal returns, Node writes and expositions; returns the
    port's."""
    out = {}
    for pkg, cls in (("reference", RefExporter), ("port", MetricsExporterAgent)):
        store = FakeClient()
        for make in nodes:
            store.create(make(NODE))
        registry = prometheus_client.CollectorRegistry()
        extra = {"device": "cpu"} if pkg == "port" else {}
        exp = cls(node_name=NODE, client=store if client else None, registry=registry,
                  floors=dict(floors or {}), namespace=NS, generation="v4", **kwargs,
                  **extra)
        returns = [step(exp, store) for step in steps]
        out[pkg] = {"returns": returns, "labels": node_labels(store),
                    "exposition": exposition(registry), "registry": registry,
                    "exporter": exp, "store": store}
    for key in ("returns", "labels", "exposition"):
        assert out["port"][key] == out["reference"][key], key
    return out["port"]


def observe(probe, value):
    return lambda exp, store: exp.observe_probe(probe, value)


def labelled(exp, store):
    return node_labels(store).get(consts.TPU_PERF_LABEL)


def floors_cm(table):
    def step(exp, store):
        cm = store.get_or_none("v1", "ConfigMap", consts.PERF_FLOORS_CONFIGMAP, NS)
        data = {consts.PERF_FLOORS_KEY: json.dumps(table)}
        if cm is None:
            store.create(new_object("v1", "ConfigMap", consts.PERF_FLOORS_CONFIGMAP, NS,
                                    data=data))
        else:
            cm["data"] = data
            store.update(cm)
    return step


def refresh(exp, store):
    return exp.refresh_floors()


# ------------------------------------------------- grey-failure detection

GREY = {
    "sustained breach sets the series and the label": (
        [observe("matmul_tflops", 60.0), labelled] * BREACH, {"matmul_tflops": 100.0}),
    "one good sample resets the count": (
        [observe("matmul_tflops", 60.0)] * (BREACH - 1) + [observe("matmul_tflops", 150.0)]
        + [observe("matmul_tflops", 60.0)] * (BREACH - 1) + [labelled],
        {"matmul_tflops": 100.0}),
    "recovery clears the label and the series": (
        [observe("matmul_tflops", 60.0)] * BREACH
        + [labelled, observe("matmul_tflops", 150.0), labelled], {"matmul_tflops": 100.0}),
    "baseline and floor gauges": (
        [observe("matmul_tflops", v) for v in (100.0, 120.0, 110.0)], {"matmul_tflops": 100.0}),
    "a probe with no floor only feeds the baseline": (
        [observe("mystery_probe", 1.0)], {}),
    "two probes: one in breach keeps the label": (
        [observe("matmul_tflops", 60.0), observe("triad_gbps", 900.0)] * BREACH
        + [labelled, observe("triad_gbps", 1500.0), labelled,
           observe("matmul_tflops", 150.0), labelled],
        {"matmul_tflops": 100.0, "triad_gbps": 1000.0}),
}


@pytest.mark.parametrize("case", list(GREY))
def test_grey_failure_detection_equals_the_reference(case):
    steps, floors = GREY[case]
    got = run_both(steps, floors=floors)
    reg = got["registry"]
    if "sustained" in case:
        assert got["returns"][-2:] == [True, consts.PERF_DEGRADED]
        assert got["returns"][1] is None  # not after one sample
        assert sample(reg, "tpu_exporter_perf_degraded", node=NODE, probe="matmul_tflops") == 1
    if "recovery" in case:
        assert got["returns"][-3:] == [consts.PERF_DEGRADED, False, None]
    if case.startswith("baseline"):
        assert sample(reg, "tpu_exporter_probe_baseline", node=NODE,
                      probe="matmul_tflops") == 110.0
        assert sample(reg, "tpu_exporter_perf_floor", node=NODE, probe="matmul_tflops") == 100.0
    if "no floor" in case:
        assert sample(reg, "tpu_exporter_perf_degraded", node=NODE, probe="mystery_probe") is None


def test_no_client_flips_the_series_without_a_write():
    got = run_both([observe("matmul_tflops", 60.0)] * BREACH, floors={"matmul_tflops": 100.0},
                   client=False)
    assert got["returns"][-1] is True and consts.TPU_PERF_LABEL not in got["labels"]


def test_failed_label_write_retries_on_the_next_sample():
    """The node is absent at first (the patch 404s): the next sample
    re-derives the verdict and publishes it."""
    def create_node(exp, store):
        store.create(make_tpu_node(NODE))

    steps = [observe("matmul_tflops", 60.0)] * BREACH + [
        create_node, observe("matmul_tflops", 60.0), labelled]
    got = run_both(steps, floors={"matmul_tflops": 100.0}, nodes=())
    assert got["returns"][-1] == consts.PERF_DEGRADED


def test_restart_does_not_clear_a_live_label_without_recovery():
    def degraded_node(name):
        node = make_tpu_node(name)
        node["metadata"]["labels"][consts.TPU_PERF_LABEL] = consts.PERF_DEGRADED
        return node

    steps = [observe("matmul_tflops", 60.0), labelled, observe("matmul_tflops", 150.0), labelled]
    got = run_both(steps, floors={"matmul_tflops": 100.0}, nodes=(degraded_node,))
    assert got["returns"][1] == consts.PERF_DEGRADED and got["returns"][3] is None


# --------------------------------------------------------- floors hot-reload


def test_updated_floor_changes_the_next_observe():
    stale = {"matmul_tflops": 100.0, "triad_gbps": 500.0}
    tightened = dict(stale, matmul_tflops=103.0)
    steps = [floors_cm({"v4": stale}), observe("matmul_tflops", 102.0),
             floors_cm({"v4": tightened}), refresh, observe("matmul_tflops", 102.0)]
    got = run_both(steps, floors=stale, breach_samples=1)
    assert got["returns"] == [None, False, None, True, True]
    assert got["exporter"].floors == tightened


def test_refresh_tolerates_a_missing_configmap_and_no_client():
    def no_client(exp, store):
        exp.client = None
        return exp.refresh_floors()

    def no_generation(exp, store):
        exp.client, exp.generation = store, ""
        return exp.refresh_floors()

    got = run_both([refresh, no_client, no_generation], floors={"matmul_tflops": 100.0})
    assert got["returns"] == [False, False, False]
    assert got["exporter"].floors == {"matmul_tflops": 100.0}


@pytest.mark.parametrize("blob, changed", [
    ({"v4": {"matmul_tflops": 100.0}}, False),          # unchanged
    ({"v5e": {"matmul_tflops": 5.0}}, False),           # another generation only
    ({"v4": {"matmul_tflops": "x", "triad_gbps": 5}}, True),  # the numeric values
])
def test_refresh_reads_only_this_generations_numeric_floors(blob, changed):
    got = run_both([floors_cm(blob), refresh], floors={"matmul_tflops": 100.0})
    assert got["returns"] == [None, changed]
    if changed:
        assert got["exporter"].floors == {"triad_gbps": 5.0}


# ------------------------------------------------------ stale-series hygiene


def seeded(exp, store):
    exp.ici_bandwidth.labels(NODE).set(42.0)
    exp.hbm_bandwidth.labels(NODE).set(600.0)
    exp.matmul_tflops.labels(NODE).set(150.0)
    exp.observe_probe("ici_gbps", 42.0)
    exp.observe_probe("matmul_tflops", 150.0)


def collect(exp, store):
    exp.collect_device_stats()


HYGIENE = {
    # name: (inventories in turn: a card count or None for a dead runtime)
    "a drop to one card retires the interconnect series": [1],
    "vanishing hardware retires every probe series": [0],
    "a dead runtime retires too": [None],
    "a healthy card count keeps the series": [4],
    "vanished cards take their memory series": [4, 2, None],
    "detection state resets with the series": [1, 4],
}


@pytest.mark.parametrize("case", list(HYGIENE))
def test_stale_series_hygiene_equals_the_reference(case, monkeypatch):
    patch = Patch(monkeypatch)

    def inventory(n):
        def step(exp, store):
            patch.no_runtime() if n is None else patch.cards(n)
            exp.collect_device_stats()
            return exposition(exp.registry)
        return step

    steps = [seeded] + [inventory(n) for n in HYGIENE[case]]
    if "detection" in case:
        steps = ([observe("ici_gbps", 5.0)] * (BREACH - 1) + steps[1:]
                 + [observe("ici_gbps", 5.0)])
    got = run_both(steps, floors={"matmul_tflops": 100.0, "ici_gbps": 10.0})
    reg = got["registry"]
    ici = sample(reg, "tpu_exporter_ici_bandwidth_gbps", node=NODE)
    if case.startswith("a healthy"):
        assert ici == 42.0
        assert sample(reg, "tpu_exporter_hbm_used_bytes", node=NODE, chip="3") == 1
        assert sample(reg, "tpu_exporter_hbm_limit_bytes", node=NODE, chip="3") == 2
    elif "detection" in case:
        assert sample(reg, "tpu_exporter_perf_degraded", node=NODE, probe="ici_gbps") == 0
    else:
        assert ici is None
    if "vanished" in case:
        assert sample(reg, "tpu_exporter_hbm_used_bytes", node=NODE, chip="1") is None
        assert sample(reg, "tpu_exporter_collect_errors_total", node=NODE) == 1


# --------------------------------------------------------------- the probes


def test_probe_failure_is_indeterminate_in_auto(monkeypatch):
    Patch(monkeypatch).probe("matmul_tflops", _boom)

    def probe(exp, store):
        exp.probe_utilization()

    steps = [observe("matmul_tflops", 60.0)] * (BREACH - 1) + [probe, labelled]
    got = run_both(steps, floors={"matmul_tflops": 100.0}, active_probes="auto")
    assert got["returns"][-1] is None
    assert sample(got["registry"], "tpu_exporter_collect_errors_total", node=NODE) is None


@pytest.mark.parametrize("name, method", [
    ("hbm_bandwidth_probe", "probe_bandwidth"), ("matmul_tflops", "probe_utilization"),
])
def test_probe_failure_counts_in_on_mode(monkeypatch, name, method):
    Patch(monkeypatch).probe(name, _boom)
    got = run_both([lambda exp, store: getattr(exp, method)()], active_probes="on")
    assert sample(got["registry"], "tpu_exporter_collect_errors_total", node=NODE) == 1


@pytest.mark.parametrize("report", [
    {"bandwidth_gbps": 900.0}, {"bandwidth_gbps": 1500.0},
    {"bandwidth_gbps": 700.0, "unstable_timing": True},
])
def test_bandwidth_probe_feeds_the_triad_floor(monkeypatch, report):
    Patch(monkeypatch).probe("hbm_bandwidth_probe", lambda size_mb, iters, **kw: dict(report))
    steps = [lambda exp, store: exp.probe_bandwidth(), labelled] * BREACH
    got = run_both(steps, floors={"triad_gbps": 1000.0}, active_probes="on")
    reg = got["registry"]
    assert sample(reg, "tpu_exporter_hbm_bandwidth_gbps", node=NODE) == report["bandwidth_gbps"]
    breached = report["bandwidth_gbps"] < 1000.0 and not report.get("unstable_timing")
    assert got["returns"][-1] == (consts.PERF_DEGRADED if breached else None)


def test_the_bandwidth_probe_is_the_exporters_triad(monkeypatch):
    seen = []

    def probe(**kwargs):
        seen.append(kwargs)
        return {"bandwidth_gbps": 1.0}

    monkeypatch.setattr("tpu_operator_torch.workloads.kernels.hbm_bandwidth_probe", probe)
    MetricsExporterAgent(NODE, device="cpu", active_probes="on").probe_bandwidth()
    assert seen == [{"size_mb": 64, "iters": 25, "device": "cpu"}]


def test_utilization_probe_on_the_cpu_observes_nothing():
    """On the CPU the chain runs (256, 2 steps) and its rate is published,
    but it is no card's rate: no floor comparison, no utilization."""
    exp = MetricsExporterAgent(NODE, device="cpu", active_probes="on",
                               floors={"matmul_tflops": 1e9})
    exp.probe_utilization()
    reg = exp.registry
    assert sample(reg, "tpu_exporter_matmul_tflops", node=NODE) is not None
    assert sample(reg, "tpu_exporter_mxu_utilization_pct", node=NODE) is None
    assert sample(reg, "tpu_exporter_probe_baseline", node=NODE, probe="matmul_tflops") is None
    assert sample(reg, "tpu_exporter_collect_errors_total", node=NODE) is None


@pytest.mark.parametrize("unstable", [False, True])
def test_utilization_probe_on_a_card(monkeypatch, unstable):
    """On a card: the 8192 chain of 16 steps, the rate held to the floor
    and its share of the generation's data-sheet peak."""
    seen = []

    def fake(size, iters, device=None):
        seen.append((size, iters))
        return {"tflops": 600.0, "unstable_timing": unstable}

    monkeypatch.setattr(tmb, "matmul_tflops", fake)
    monkeypatch.setattr(tmb, "chip_generation", lambda: "h100-sxm")
    monkeypatch.setattr(mea, "resolve_device", lambda device=None: torch.device("cuda"))
    exp = MetricsExporterAgent(NODE, active_probes="on", floors={"matmul_tflops": 700.0})
    exp.probe_utilization()
    reg = exp.registry
    assert seen == [(8192, 16)]
    assert sample(reg, "tpu_exporter_matmul_tflops", node=NODE) == 600.0
    util = sample(reg, "tpu_exporter_mxu_utilization_pct", node=NODE)
    floor = sample(reg, "tpu_exporter_perf_floor", node=NODE, probe="matmul_tflops")
    if unstable:
        assert util is None and floor is None
    else:
        assert util == pytest.approx(100.0 * 600.0 / tmb.PEAK_TFLOPS["h100-sxm"])
        assert floor == 700.0


def test_ici_probe_on_one_card_publishes_nothing():
    exp = MetricsExporterAgent(NODE, device="cpu", active_probes="on")
    exp.probe_ici()
    assert sample(exp.registry, "tpu_exporter_ici_bandwidth_gbps", node=NODE) is None
    assert sample(exp.registry, "tpu_exporter_collect_errors_total", node=NODE) is None


def test_ici_probe_over_two_cpu_ranks():
    """Two gloo ranks run the all-reduce at 16 MiB; rank 0's bus rate per
    rank is the series and feeds the ici floor."""
    exp = MetricsExporterAgent(NODE, device="cpu", cpu_ranks=2, active_probes="on",
                               floors={"ici_gbps": 1e9})
    exp.collect_device_stats()
    exp.probe_ici()
    reg = exp.registry
    busbw = sample(reg, "tpu_exporter_ici_bandwidth_gbps", node=NODE)
    assert sample(reg, "tpu_exporter_collect_errors_total", node=NODE) is None
    assert busbw is not None and busbw > 0
    assert sample(reg, "tpu_exporter_probe_baseline", node=NODE, probe="ici_gbps") == busbw
    assert sample(reg, "tpu_exporter_chips", node=NODE) == 2


def test_cpu_inventory_has_no_device_memory():
    exp = MetricsExporterAgent(NODE, device="cpu")
    exp.collect_device_stats()
    reg = exp.registry
    assert sample(reg, "tpu_exporter_chips", node=NODE) == 1
    assert sample(reg, "tpu_exporter_hbm_used_bytes", node=NODE, chip="0") is None


def test_device_memory_is_device_wide(monkeypatch):
    """Used is the total less the free bytes mem_get_info reports for each
    card, whoever holds them."""
    monkeypatch.setattr(mea, "local_devices",
                        lambda device=None: [torch.device("cuda", 0), torch.device("cuda", 1)])
    got = {0: (30, 80), 1: (80, 80)}
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device: got[device.index])
    exp = MetricsExporterAgent(NODE)
    exp.collect_device_stats()
    reg = exp.registry
    assert [sample(reg, "tpu_exporter_hbm_used_bytes", node=NODE, chip=c) for c in "01"] == [50, 0]
    assert [sample(reg, "tpu_exporter_hbm_limit_bytes", node=NODE, chip=c) for c in "01"] == [80, 80]


def test_no_cuda_is_a_collect_error_not_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    exp = MetricsExporterAgent(NODE)
    exp.collect_device_stats()
    assert sample(exp.registry, "tpu_exporter_chips", node=NODE) == 0
    assert sample(exp.registry, "tpu_exporter_collect_errors_total", node=NODE) == 1


# ----------------------------------------------------------------- plumbing


def test_registration_is_idempotent_on_a_shared_registry():
    reg = prometheus_client.CollectorRegistry()
    a = MetricsExporterAgent(node_name="n0", registry=reg)
    b = MetricsExporterAgent(node_name="n1", registry=reg)
    a.chips.labels("n0").set(4)
    b.chips.labels("n1").set(4)
    assert a.chips is b.chips and a.collect_errors is b.collect_errors
    assert sample(reg, "tpu_exporter_chips", node="n1") == 4
    # and one registry holds both packages' exporters' series as one
    ref = RefExporter(node_name="n2", registry=reg)
    assert ref.chips is a.chips


def test_every_family_equals_the_reference():
    reg, ref_reg = prometheus_client.CollectorRegistry(), prometheus_client.CollectorRegistry()
    MetricsExporterAgent(NODE, registry=reg)
    RefExporter(NODE, registry=ref_reg)
    assert exposition(reg) == exposition(ref_reg)
    assert len(exposition(reg)) == 11


def test_active_probes_must_be_auto_on_or_off():
    with pytest.raises(ValueError, match="auto/on/off"):
        MetricsExporterAgent(NODE, active_probes="sometimes")


@pytest.mark.parametrize("gen, want", [("h100-sxm", {"matmul_tflops": 470.0}), ("", {})])
def test_floors_from_env(monkeypatch, gen, want):
    monkeypatch.setattr(tmb, "chip_generation", lambda: gen)
    monkeypatch.setenv("PERF_FLOORS_JSON", json.dumps({
        "h100-sxm": {"matmul_tflops": 470.0}, "v5e": {"matmul_tflops": 129.5}}))
    assert mea.floors_from_env() == want


def test_the_perf_label_is_the_reference_key():
    assert (consts.TPU_PERF_LABEL, consts.PERF_DEGRADED) == (
        ref_consts.TPU_PERF_LABEL, ref_consts.PERF_DEGRADED)
