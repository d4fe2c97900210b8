"""The autotune and compile-cache agents and the node identity they read.

Each of the reference's agent cases (``tests/test_autotune.py``
``TestAutotuneAgent``, ``tests/test_compilecache.py``
``TestCompileCacheAgent``) runs over both packages' agents on the same
fake client, with the same fake sweep or warm-up: the outcome and every
ConfigMap, Node and Pod write must be the same. ``node_generation``
equals the reference's ``tpu_info(node).generation`` on every catalog
entry under both TPU label sets and maps GFD product names to the H100
variants. Two drills close the loop across the packages on the sim: the
reference's autotune controller elects, the port's agent sweeps (the
cpu-smoke profile on the CPU) and the controller clears the election
without folding a CPU entry into the floors; the reference's
compile-cache controller elects, the port's agent prewarms the default
serving config on the CPU, and a rerun is a zero-write hit.
"""

from __future__ import annotations

import copy
import json

import pytest

import tests.test_autotune as ref_at
import tests.test_compilecache as ref_cc
from tpu_operator import consts as ref_consts
from tpu_operator.agents.autotune_agent import AutotuneAgent as RefAutotuneAgent
from tpu_operator.agents.compilecache_agent import CompileCacheAgent as RefCompileCacheAgent
from tpu_operator.controllers.autotune_controller import AutotuneReconciler
from tpu_operator.controllers.compilecache_controller import CompileCacheReconciler
from tpu_operator.kube.fake import FakeClient
from tpu_operator.kube.objects import new_object
from tpu_operator.kube.sim import make_tpu_node
from tpu_operator.nodeinfo import ACCELERATORS, tpu_info
from tpu_operator.workloads import compilecache as ref_compilecache
from tpu_operator_torch import consts, nodeinfo
from tpu_operator_torch.agents.autotune_agent import AutotuneAgent
from tpu_operator_torch.agents.compilecache_agent import CompileCacheAgent
from tpu_operator_torch.workloads import autotune, compilecache

NS = "tpu-operator"
AGENTS = {"autotune": {"reference": RefAutotuneAgent, "port": AutotuneAgent},
          "compilecache": {"reference": RefCompileCacheAgent, "port": CompileCacheAgent}}


class Recording:
    """A client that records every write (verb and arguments) it passes on."""

    WRITES = ("create", "patch", "patch_status", "update", "update_status", "delete")

    def __init__(self, inner):
        self._inner = inner
        self.writes = []

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if name not in self.WRITES:
            return attr

        def recorded(*args, **kwargs):
            self.writes.append((name, _plain(copy.deepcopy(args)), kwargs))
            return attr(*args, **kwargs)
        return recorded


def _plain(value):
    """JSON blobs in ConfigMap data parsed (key order is not a write's
    meaning); the sweep's wall-clock seconds dropped."""
    if isinstance(value, dict):
        return {k: _plain(_parsed(v)) for k, v in value.items() if k != "sweep_seconds"}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    return value


def _parsed(value):
    if isinstance(value, str) and value[:1] in "{[":
        try:
            return json.loads(value)
        except ValueError:
            return value
    return value


@pytest.fixture(autouse=True)
def _pinned_version(monkeypatch):
    # one toolchain version for both packages' fingerprints (the
    # controller's image-tag expectation)
    monkeypatch.setenv("LIBTPU_VERSION", "1.0.0")


def _run_both(kind, seed, agent_kwargs, passes=1):
    """Each package's agent over its own copy of the store ``seed``
    builds: (outcomes, writes, final store) per package."""
    out = {}
    for pkg, cls in AGENTS[kind].items():
        store = FakeClient()
        for obj in seed():
            store.create(obj)
        client = Recording(store)
        calls = []
        agent = cls(client, agent_kwargs["node"], NS, **agent_kwargs["fake"](calls))
        outcomes = [agent.reconcile_once() for _ in range(passes)]
        out[pkg] = {"outcomes": outcomes, "writes": client.writes, "calls": calls,
                    "store": store}
    assert out["port"]["outcomes"] == out["reference"]["outcomes"]
    assert out["port"]["writes"] == out["reference"]["writes"]
    assert out["port"]["calls"] == out["reference"]["calls"]
    return out


# ---------------------------------------------------------------- autotune


def _sweep(calls):
    return {"sweep_fn": ref_at._fake_sweep(calls)}


def _results_cm(entries):
    return new_object("v1", "ConfigMap", ref_consts.AUTOTUNE_RESULTS_CONFIGMAP, NS,
                      data={autotune.entry_key(g): json.dumps(e) for g, e in entries.items()})


def _bare_elected():
    return new_object("v1", "Node", "bare-0",
                      labels={consts.AUTOTUNE_ELECTED_LABEL: consts.AUTOTUNE_ELECTED})


def _gpu_node(name, product="NVIDIA-H100-80GB-HBM3", count="1", elected_label=None):
    labels = {consts.GFD_PRODUCT_LABEL: product, consts.GFD_COUNT_LABEL: count}
    if elected_label:
        labels[elected_label] = "elected"
    return new_object("v1", "Node", name, labels=labels,
                      status={"allocatable": {consts.GPU_RESOURCE_NAME: count}})


AUTOTUNE_CASES = {
    # the reference's TestAutotuneAgent
    "not elected": (lambda: [ref_at._tpu_node("n-0")], "n-0", ["not-elected"], []),
    "elected sweeps and publishes": (
        lambda: [ref_at._tpu_node("n-0", elected=True)], "n-0", ["swept"], ["v4"]),
    "cache hit issues zero writes": (
        lambda: [ref_at._tpu_node("n-0", elected=True), _results_cm({"v4": ref_at._entry()})],
        "n-0", ["cache-hit"], []),
    "toolchain bump re-sweeps": (
        lambda: [ref_at._tpu_node("n-0", elected=True),
                 _results_cm({"v4": ref_at._entry(version="0.9.0")})],
        "n-0", ["swept"], ["v4"]),
    "unrecognizable generation never sweeps": (lambda: [_bare_elected()], "bare-0",
                                               ["no-generation"], []),
    # and past them: a second pass is a zero-write hit, another
    # generation's entry is kept, the discovery label set names v5e
    "swept then cache hit": (lambda: [ref_at._tpu_node("n-0", elected=True)], "n-0",
                             ["swept", "cache-hit"], ["v4"]),
    "other generation's entry kept": (
        lambda: [ref_at._tpu_node("n-0", elected=True),
                 _results_cm({"v5e": ref_at._entry(gen="v5e")})],
        "n-0", ["swept"], ["v4"]),
    "discovery labels": (
        lambda: [new_object("v1", "Node", "sm-0", labels={
            ref_consts.TFD_ACCELERATOR_TYPE_LABEL: "tpu-v5-lite-podslice",
            ref_consts.TFD_TOPOLOGY_LABEL: "2x4",
            consts.AUTOTUNE_ELECTED_LABEL: consts.AUTOTUNE_ELECTED})],
        "sm-0", ["swept"], ["v5e"]),
}


@pytest.mark.parametrize("case", list(AUTOTUNE_CASES))
def test_autotune_agent_equals_the_reference(case):
    seed, node, want, calls = AUTOTUNE_CASES[case]
    out = _run_both("autotune", seed, {"node": node, "fake": _sweep},
                    passes=len(want))
    got = out["port"]
    assert got["outcomes"] == want and got["calls"] == calls
    if "swept" in want:
        cm = got["store"].get("v1", "ConfigMap", consts.AUTOTUNE_RESULTS_CONFIGMAP, NS)
        entry = json.loads(cm["data"][autotune.entry_key(calls[0])])
        assert entry["libtpu_version"] == "1.0.0" and entry["swept_by"] == node
        assert [w[0] for w in got["writes"]][:1] == (
            ["patch"] if "kept" in case or "bump" in case else ["create"])
    else:
        assert got["writes"] == []


def test_autotune_agent_sweeps_a_card_under_its_gfd_generation():
    store = FakeClient()
    store.create(_gpu_node("h100-0", elected_label=consts.AUTOTUNE_ELECTED_LABEL))
    calls = []
    agent = AutotuneAgent(store, "h100-0", NS, sweep_fn=ref_at._fake_sweep(calls))
    assert agent.reconcile_once() == "swept" and calls == ["h100-sxm"]
    cm = store.get("v1", "ConfigMap", consts.AUTOTUNE_RESULTS_CONFIGMAP, NS)
    assert set(cm["data"]) == {"h100-sxm.json"}
    assert cm["metadata"]["labels"] == {"app": "tpu-autotuner"}


def test_autotune_agent_create_race_ends_in_a_patch():
    """Two agents that both saw no ConfigMap: the second's create loses
    (AlreadyExists) and its entry goes in by a key-scoped patch."""
    store = FakeClient()
    store.create(ref_at._tpu_node("n-0", elected=True))
    agent = AutotuneAgent(store, "n-0", NS, sweep_fn=ref_at._fake_sweep())
    store.create(_results_cm({"v5e": ref_at._entry(gen="v5e")}))
    agent._publish("v4", ref_at._entry(), cm_exists=False)
    data = store.get("v1", "ConfigMap", consts.AUTOTUNE_RESULTS_CONFIGMAP, NS)["data"]
    assert set(data) == {"v4.json", "v5e.json"}


def test_autotune_agent_has_no_cpu_default(monkeypatch):
    """The default sweep runs on the card: without CUDA it raises instead
    of sweeping the CPU."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    store = FakeClient()
    store.create(ref_at._tpu_node("n-0", elected=True))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AutotuneAgent(store, "n-0", NS).reconcile_once()


# ------------------------------------------------------------ compile cache


def _warm(calls):
    return {"warm_fn": ref_cc._fake_warm(calls)}


def _rid(gen="v5e", topology="2x4", model="mhash"):
    return compilecache.request_id(gen, topology, model)


COMPILECACHE_CASES = {
    # the reference's TestCompileCacheAgent
    "not elected": (lambda: [ref_cc._v5e_node("n-0")], ["not-elected"], []),
    "elected compiles publishes and acks": (
        lambda: [ref_cc._v5e_node("n-0", elected=True),
                 ref_cc._cache_cm(requests={_rid(): ref_cc._request()})],
        ["prewarmed"], ["v5e"]),
    "satisfied request is a zero-write cache hit": (
        lambda: [ref_cc._v5e_node("n-0", elected=True),
                 ref_cc._cache_cm(entries={"v5e": ref_cc._centry()},
                                  requests={_rid(): ref_cc._request()})],
        ["cache-hit"], []),
    "other generation's requests are not mine": (
        lambda: [ref_cc._v5e_node("n-0", elected=True),
                 ref_cc._cache_cm(requests={_rid("v4", "4x4x4"): ref_cc._request(
                     gen="v4", topology="4x4x4")})],
        ["no-requests"], []),
    "stale entry recompiles": (
        lambda: [ref_cc._v5e_node("n-0", elected=True),
                 ref_cc._cache_cm(entries={"v5e": ref_cc._centry(version="0.9.0")},
                                  requests={_rid(): ref_cc._request()})],
        ["prewarmed"], ["v5e"]),
    # and past them: a second pass is a zero-write hit, two requests are
    # prewarmed in order, no generation and no ConfigMap
    "prewarmed then cache hit": (
        lambda: [ref_cc._v5e_node("n-0", elected=True),
                 ref_cc._cache_cm(requests={_rid(): ref_cc._request()})],
        ["prewarmed", "cache-hit"], ["v5e"]),
    "two requests": (
        lambda: [ref_cc._v5e_node("n-0", elected=True),
                 ref_cc._cache_cm(requests={_rid(): ref_cc._request(),
                                            _rid(topology="4x4"): ref_cc._request(
                                                topology="4x4")})],
        ["prewarmed"], ["v5e", "v5e"]),
    "unrecognizable generation": (
        lambda: [new_object("v1", "Node", "n-0", labels={
            consts.COMPILE_CACHE_ELECTED_LABEL: consts.COMPILE_CACHE_ELECTED})],
        ["no-generation"], []),
    "no cache configmap": (lambda: [ref_cc._v5e_node("n-0", elected=True)],
                           ["no-requests"], []),
}


@pytest.mark.parametrize("case", list(COMPILECACHE_CASES))
def test_compilecache_agent_equals_the_reference(case):
    seed, want, calls = COMPILECACHE_CASES[case]
    out = _run_both("compilecache", seed, {"node": "n-0", "fake": _warm},
                    passes=len(want))
    got = out["port"]
    assert got["outcomes"] == want and got["calls"] == calls
    if "prewarmed" not in want:
        assert got["writes"] == []
        return
    data = got["store"].get("v1", "ConfigMap", consts.COMPILE_CACHE_CONFIGMAP, NS)["data"]
    record = compilecache.cache_record(compilecache.parse_entry(data["v5e.json"]), "2x4",
                                       "mhash", "1.0.0")
    assert record == {"seconds": 1.5, "source": "prewarm", "serving": "svc", "node": "n-0"}
    acks = json.loads(data[consts.COMPILE_PREWARM_ACK_KEY])["acks"]
    assert acks[_rid()]["outcome"] == "prewarmed"


def test_compilecache_agent_prewarms_a_card_under_its_gfd_generation():
    store = FakeClient()
    store.create(_gpu_node("h100-0", elected_label=consts.COMPILE_CACHE_ELECTED_LABEL))
    store.create(ref_cc._cache_cm(requests={_rid("h100-sxm", "1x1x1"): ref_cc._request(
        gen="h100-sxm", topology="1x1x1")}))
    calls = []
    agent = CompileCacheAgent(store, "h100-0", NS, warm_fn=ref_cc._fake_warm(calls))
    assert agent.reconcile_once() == "prewarmed" and calls == ["h100-sxm"]
    assert agent.reconcile_once() == "cache-hit"


# ------------------------------------------------------------ node identity


@pytest.mark.parametrize("accelerator", sorted(ACCELERATORS) + ["tpu-v9-mystery"])
@pytest.mark.parametrize("label_set", ["gke", "discovery"])
def test_node_generation_equals_tpu_info(accelerator, label_set):
    node = make_tpu_node("n-0", accelerator, "2x4")
    if label_set == "discovery":
        labels = node["metadata"]["labels"]
        for key, new in ((ref_consts.GKE_TPU_ACCELERATOR_LABEL,
                          ref_consts.TFD_ACCELERATOR_TYPE_LABEL),
                         (ref_consts.GKE_TPU_TOPOLOGY_LABEL, ref_consts.TFD_TOPOLOGY_LABEL)):
            labels[new] = labels.pop(key)
    want = tpu_info(node)
    assert want is not None and want.label_source == label_set
    assert nodeinfo.node_generation(node) == want.generation
    assert nodeinfo.expected_cards(node) == want.chips_per_node
    # the TPU label sets win over GFD's, as the controllers elect by them
    node["metadata"]["labels"][consts.GFD_PRODUCT_LABEL] = "NVIDIA-H100-PCIe"
    assert nodeinfo.node_generation(node) == want.generation


@pytest.mark.parametrize("product, want", [
    ("NVIDIA-H100-80GB-HBM3", "h100-sxm"),
    ("NVIDIA-H100-SXM5-80GB", "h100-sxm"),
    ("NVIDIA-H100-PCIe", "h100-pcie"),
    ("NVIDIA-H100-NVL", "h100-nvl"),
    ("NVIDIA-A100-SXM4-80GB", "unknown"),
])
def test_gfd_products_map_to_the_card_generations(product, want):
    node = _gpu_node("g-0", product=product, count="8")
    assert nodeinfo.node_generation(node) == want
    assert nodeinfo.expected_cards(node) == 8
    # the same table as the CUDA device name (spaces for dashes)
    assert nodeinfo.device_generation(product.replace("-", " ")) == (
        "" if want == "unknown" else want)


def test_node_without_either_label_set():
    bare = new_object("v1", "Node", "n-0", labels={"kubernetes.io/os": "linux"})
    assert tpu_info(bare) is None
    assert nodeinfo.node_generation(bare) == "" and nodeinfo.expected_cards(bare) is None
    assert nodeinfo.node_generation(None) == ""
    chips = new_object("v1", "Node", "n-1", labels={ref_consts.TFD_CHIPS_PER_NODE_LABEL: "2"})
    assert nodeinfo.expected_cards(chips) == 2


# ------------------------------------------------------------------- drills


def test_drill_reference_autotune_controller_and_the_port_agent():
    """The reference's controller elects one v4 node, the port's agent
    sweeps there (cpu-smoke, on the CPU), the controller clears the
    election and publishes the winners, and the CPU entry folds into no
    floor."""
    store = ref_at._cluster([ref_at._tpu_node("v4-b"), ref_at._tpu_node("v4-a")])
    floors_before = store.get("v1", "ConfigMap", ref_consts.PERF_FLOORS_CONFIGMAP, NS)["data"]
    rec = AutotuneReconciler(store, NS)
    rec.reconcile(ref_at.REQ)
    assert ref_at._elected(store) == ["v4-a"]
    agent = AutotuneAgent(store, "v4-a", NS, profile="cpu-smoke", device="cpu")
    assert AutotuneAgent(store, "v4-b", NS, device="cpu").reconcile_once() == "not-elected"
    assert agent.reconcile_once() == "swept"
    rec.reconcile(ref_at.REQ)
    assert ref_at._elected(store) == []
    assert agent.reconcile_once() == "not-elected"
    results = store.get("v1", "ConfigMap", ref_consts.AUTOTUNE_RESULTS_CONFIGMAP, NS)["data"]
    entry = json.loads(results["v4.json"])
    assert entry["platform"] == "cpu" and entry["swept_by"] == "v4-a"
    winners = json.loads(results[ref_consts.AUTOTUNE_WINNERS_KEY])
    assert set(winners["v4"]) == set(autotune.KERNEL_FAMILIES)
    floors_after = store.get("v1", "ConfigMap", ref_consts.PERF_FLOORS_CONFIGMAP, NS)["data"]
    assert floors_after == floors_before


def test_drill_reference_compilecache_controller_and_the_port_agent():
    """The reference's controller elects the v5e node for a prewarm of the
    default serving config, the port's agent warms it up (on the CPU),
    publishes the record and acks; a rerun is a zero-write hit, the
    controller clears the election, and the reference's store resolves
    the port's record."""
    model = compilecache.model_descriptor_hash()
    assert model == ref_compilecache.model_descriptor_hash()
    rid = _rid(model=model)
    store = ref_cc._cluster([ref_cc._v5e_node("v5e-a"), ref_cc._v5e_node("v5e-b")],
                            requests={rid: ref_cc._request(model=model)})
    rec = CompileCacheReconciler(store, NS)
    rec.reconcile(ref_cc.REQ)
    assert ref_cc._elected(store) == ["v5e-a"]
    assert CompileCacheAgent(store, "v5e-a", NS, device="cpu").reconcile_once() == "prewarmed"
    client = Recording(store)
    rerun = CompileCacheAgent(client, "v5e-a", NS, device="cpu")
    assert rerun.reconcile_once() == "cache-hit" and client.writes == []
    rec.reconcile(ref_cc.REQ)
    assert ref_cc._elected(store) == []
    assert rerun.reconcile_once() == "not-elected"
    data = store.get("v1", "ConfigMap", ref_consts.COMPILE_CACHE_CONFIGMAP, NS)["data"]
    record = ref_compilecache.CompileCacheStore(store, NS, "1.0.0").resolve("v5e", "2x4", model)
    acks = json.loads(data[consts.COMPILE_PREWARM_ACK_KEY])["acks"]
    assert record["source"] == "prewarm" and record["node"] == "v5e-a" and record["seconds"] > 0
    assert acks[rid] == {"node": "v5e-a", "seconds": record["seconds"], "outcome": "prewarmed"}
