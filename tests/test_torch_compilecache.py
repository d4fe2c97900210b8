"""The port's fleet compile cache (``tpu_operator_torch/workloads/compilecache.py``)
against the JAX package's on the CPU: every keying and warm-start case of
``tests/test_compilecache.py`` run over both packages, the model
descriptor hash equal across them, records crossing between the two
stores in both directions (one explicit toolchain version for both: the
reference fingerprints jax, the port torch and its kernels), ``warm_start``
over each package's real ``DecodeEngine``, and the CUDA binding's CPU
behaviour.
"""

import json
import time
import types

import pytest
import torch

from tpu_operator import consts as ref_consts
from tpu_operator.kube import errors
from tpu_operator.kube.fake import FakeClient
from tpu_operator.kube.objects import new_object
from tpu_operator.workloads import compilecache as ref_cc
from tpu_operator.workloads import serving as ref_serving
from tpu_operator_torch import consts
from tpu_operator_torch.kernels import build
from tpu_operator_torch.workloads import compilecache as cc
from tpu_operator_torch.workloads import serving

NS = "tpu-operator"
VERSION = "1.0.0"
PACKAGES = {
    "reference": types.SimpleNamespace(cc=ref_cc, serving=ref_serving),
    "port": types.SimpleNamespace(cc=cc, serving=serving),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def _record(seconds=3.2, source="worker", serving="svc", node="n-0"):
    return {"seconds": seconds, "source": source, "serving": serving, "node": node}


def _centry(mod, gen="v5e", version=VERSION, records=None):
    if records is None:
        records = {mod.record_key("2x4", "mhash"): _record()}
    return {"generation": gen, "libtpu_version": version, "records": records}


class StubEngine:
    """warm_start needs ``cfg`` (the content address), the engine's
    ``device`` (the port binds its kernel cache on a card only) and a
    ``warmup`` to time."""

    def __init__(self, pkg, delay=0.0):
        self.cfg = pkg.serving.ServingModelConfig()
        self.device = torch.device("cpu")
        self.delay = delay
        self.warmups = 0

    def warmup(self, prompt_len):
        self.warmups += 1
        if self.delay:
            time.sleep(self.delay)


class CountingClient:
    WRITE_VERBS = ("create", "patch", "patch_status", "update", "update_status",
                   "delete", "apply", "apply_set")

    def __init__(self, inner):
        self._inner = inner
        self.writes = 0

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if name in self.WRITE_VERBS and callable(attr):
            def counted(*a, **kw):
                self.writes += 1
                return attr(*a, **kw)

            return counted
        return attr


class DownClient:
    """Every call raises: the apiserver is unreachable."""

    def __getattr__(self, name):
        def down(*a, **kw):
            raise errors.ApiError("apiserver down")

        return down


def _cache_cm(mod, entries):
    data = {mod.entry_key(gen): json.dumps(entry) for gen, entry in entries.items()}
    return new_object("v1", "ConfigMap", consts.COMPILE_CACHE_CONFIGMAP, NS, data=data)


def _store(pkg, client):
    return pkg.cc.CompileCacheStore(client, NS, libtpu_version=VERSION)


# ------------------------------------------------- keying and invalidation


def test_complete_entry_valid(pkg):
    assert pkg.cc.entry_valid(_centry(pkg.cc), VERSION)


def test_libtpu_version_invalidates(pkg):
    assert not pkg.cc.entry_valid(_centry(pkg.cc, version="1.0.0"), "1.1.0")


def test_empty_record_map_invalid(pkg):
    assert not pkg.cc.entry_valid(_centry(pkg.cc, records={}), VERSION)


def test_record_resolves_only_its_content_address(pkg):
    entry = _centry(pkg.cc)
    assert pkg.cc.cache_record(entry, "2x4", "mhash", VERSION) == _record()
    assert pkg.cc.cache_record(entry, "4x4", "mhash", VERSION) is None
    assert pkg.cc.cache_record(entry, "2x4", "other", VERSION) is None
    assert pkg.cc.cache_record(entry, "2x4", "mhash", "2.0.0") is None


def test_parse_entry_tolerates_garbage(pkg):
    assert pkg.cc.parse_entry(None) is None
    assert pkg.cc.parse_entry("") is None
    assert pkg.cc.parse_entry("{not json") is None
    assert pkg.cc.parse_entry('["list"]') is None
    assert pkg.cc.parse_entry('{"a": 1}') == {"a": 1}


def test_parse_requests_tolerates_garbage(pkg):
    assert pkg.cc.parse_requests(None) == {}
    assert pkg.cc.parse_requests("{torn") == {}
    assert pkg.cc.parse_requests('{"requests": ["not", "a", "map"]}') == {}
    assert pkg.cc.parse_requests(
        '{"requests": {"rid": {"generation": "v5e"}, "bad": 3}}'
    ) == {"rid": {"generation": "v5e"}}


def test_cached_entries_skips_handshake_keys_and_torn_blobs(pkg):
    data = {
        pkg.cc.entry_key("v5e"): json.dumps(_centry(pkg.cc)),
        pkg.cc.entry_key("v4"): "{torn",
        consts.COMPILE_PREWARM_REQUEST_KEY: json.dumps({"requests": {}}),
        consts.COMPILE_PREWARM_ACK_KEY: json.dumps({"acks": {}}),
        "not-an-entry": "x",
    }
    assert set(pkg.cc.cached_entries(data)) == {"v5e"}


def test_model_hash_tracks_model_geometry(pkg):
    cfg = pkg.serving.ServingModelConfig
    assert pkg.cc.model_descriptor_hash(cfg()) == pkg.cc.model_descriptor_hash(cfg())
    assert pkg.cc.model_descriptor_hash(cfg()) != pkg.cc.model_descriptor_hash(cfg(max_seq=32))
    assert pkg.cc.model_descriptor_hash(None) == pkg.cc.model_descriptor_hash(cfg())


def test_request_id_composition(pkg):
    assert pkg.cc.request_id("v5e", "2x4", "mhash") == "v5e/2x4/mhash"
    assert pkg.cc.request_id("v5e", "", "mhash") == "v5e/any/mhash"


# ------------------------------------------------------ the warm-start path


def test_miss_measures_and_publishes(pkg):
    pkg.cc.reset_stats()
    store = _store(pkg, FakeClient())
    engine = StubEngine(pkg, delay=0.01)
    outcome, seconds = store.warm_start(engine, "v5e", "2x4", serving="svc")
    assert outcome == "miss" and engine.warmups == 1
    assert seconds >= 0.01
    entry = pkg.cc.parse_entry(store.read_data()[pkg.cc.entry_key("v5e")])
    record = pkg.cc.cache_record(entry, "2x4", pkg.cc.model_descriptor_hash(engine.cfg), VERSION)
    assert record["source"] == "worker" and record["serving"] == "svc"
    assert record["seconds"] == pytest.approx(seconds, abs=0.01)
    assert pkg.cc.stats()["misses"] == {"v5e": 1}


def test_hit_replays_recorded_cost_and_writes_nothing(pkg):
    pkg.cc.reset_stats()
    inner = FakeClient()
    cold = _store(pkg, inner).warm_start(StubEngine(pkg, delay=0.02), "v5e", "2x4")[1]
    client = CountingClient(inner)
    outcome, warm = _store(pkg, client).warm_start(StubEngine(pkg, delay=0.02), "v5e", "2x4")
    assert outcome == "hit" and client.writes == 0
    assert warm == pytest.approx(cold * pkg.cc.WARM_FRACTION, abs=0.01)
    assert warm < cold
    assert pkg.cc.stats()["hits"] == {"v5e": 1}


def test_unkeyed_engine_skips_cache(pkg):
    pkg.cc.reset_stats()
    client = CountingClient(FakeClient())
    outcome, _ = _store(pkg, client).warm_start(StubEngine(pkg), "", "2x4")
    assert outcome == "unkeyed" and client.writes == 0
    assert pkg.cc.stats()["hits"] == {} and pkg.cc.stats()["misses"] == {}


def test_unreachable_api_compiles_cold_without_raising(pkg):
    pkg.cc.reset_stats()
    engine = StubEngine(pkg)
    outcome, _ = _store(pkg, DownClient()).warm_start(engine, "v5e", "2x4")
    assert outcome == "miss" and engine.warmups == 1


def test_read_data_distinguishes_missing_from_unreachable(pkg):
    assert _store(pkg, FakeClient()).read_data() == {}
    assert _store(pkg, DownClient()).read_data() is None


def test_version_bump_replaces_stale_entry_wholesale(pkg):
    inner = FakeClient()
    inner.create(_cache_cm(pkg.cc, {"v5e": _centry(pkg.cc, version="0.9.0")}))
    store = _store(pkg, inner)
    store.publish("v5e", "4x4", "newhash", 2.0)
    entry = pkg.cc.parse_entry(store.read_data()[pkg.cc.entry_key("v5e")])
    assert entry["libtpu_version"] == VERSION
    assert list(entry["records"]) == [pkg.cc.record_key("4x4", "newhash")]


def test_publish_keeps_sibling_records_for_same_toolchain(pkg):
    store = _store(pkg, FakeClient())
    store.publish("v5e", "2x4", "a", 1.0)
    store.publish("v5e", "4x4", "b", 2.0)
    entry = pkg.cc.parse_entry(store.read_data()[pkg.cc.entry_key("v5e")])
    assert set(entry["records"]) == {pkg.cc.record_key("2x4", "a"),
                                     pkg.cc.record_key("4x4", "b")}


# ------------------------------------------------------ across the packages


def test_copied_vocabulary_equals_the_reference():
    assert cc.WARM_FRACTION == ref_cc.WARM_FRACTION
    for name in ("COMPILE_CACHE_CONFIGMAP", "COMPILE_PREWARM_REQUEST_KEY",
                 "COMPILE_PREWARM_ACK_KEY", "COMPILE_CACHE_DIR_ENV",
                 "COMPILE_CACHE_DIR_DEFAULT"):
        assert getattr(consts, name) == getattr(ref_consts, name), name


@pytest.mark.parametrize("over", [{}, {"max_seq": 32}, {"int8_mlp": False}],
                         ids=["default", "max_seq", "int8_mlp"])
def test_model_descriptor_hash_equal_across_packages(over):
    assert cc.model_descriptor_hash(serving.ServingModelConfig(**over)) == \
        ref_cc.model_descriptor_hash(ref_serving.ServingModelConfig(**over))


@pytest.mark.parametrize("writer, reader", [("reference", "port"), ("port", "reference")])
def test_a_record_crosses_between_the_stores(writer, reader):
    """Either package's published record resolves as a hit through the
    other's store, and the reader's publication keeps the writer's record."""
    client = FakeClient()
    w, r = PACKAGES[writer], PACKAGES[reader]
    model_hash = w.cc.model_descriptor_hash()
    _store(w, client).publish("h100-sxm", "1x1x1", model_hash, 4.5, serving="svc", node="n-0")
    r.cc.reset_stats()
    record = _store(r, client).resolve("h100-sxm", "1x1x1", r.cc.model_descriptor_hash())
    assert record == _record(seconds=4.5, serving="svc", node="n-0")
    assert r.cc.stats()["hits"] == {"h100-sxm": 1}
    _store(r, client).publish("h100-sxm", "2x1x1", model_hash, 1.0)
    entry = w.cc.parse_entry(_store(w, client).read_data()[w.cc.entry_key("h100-sxm")])
    assert set(entry["records"]) == {"1x1x1/" + model_hash, "2x1x1/" + model_hash}


def _real_engine(name):
    cfg_kw = dict(d_model=16, n_heads=2, head_dim=8, d_ff=32, vocab=64, page_tokens=4,
                  max_pages=32, max_batch=4, max_seq=32, prefill_chunk=4)
    if name == "reference":
        return ref_serving.DecodeEngine(ref_serving.ServingModelConfig(**cfg_kw))
    return serving.DecodeEngine(serving.ServingModelConfig(**cfg_kw), device="cpu")


@pytest.mark.parametrize("name", sorted(PACKAGES))
def test_warm_start_over_the_real_engine(name):
    """Miss (published, the engine's warm-up recorded), then hit, then
    unkeyed, for each package's DecodeEngine on the CPU."""
    pkg = PACKAGES[name]
    client = FakeClient()
    engine = _real_engine(name)
    outcome, seconds = _store(pkg, client).warm_start(engine, "v5e", "2x1x1")
    assert outcome == "miss" and seconds > 0.0 and engine.warmup_seconds is not None
    counting = CountingClient(client)
    second = _real_engine(name)
    outcome, warm = _store(pkg, counting).warm_start(second, "v5e", "2x1x1")
    assert outcome == "hit" and counting.writes == 0
    # the hit replays the published record's seconds (already rounded to
    # 4 places) at the warm fraction
    record = _store(pkg, client).resolve("v5e", "2x1x1", pkg.cc.model_descriptor_hash(engine.cfg))
    assert warm <= round(record["seconds"] * pkg.cc.WARM_FRACTION, 4) + 1e-9
    assert _store(pkg, client).warm_start(_real_engine(name), "", "2x1x1")[0] == "unkeyed"


def test_read_data_reraises_what_is_not_a_client_error():
    class Broken:
        def get_or_none(self, *args):
            raise KeyError("a bug, not the apiserver")

    with pytest.raises(KeyError):
        _store(PACKAGES["port"], Broken()).read_data()


def test_merge_creates_then_patches_with_errors_matched_by_name():
    """Any client whose NotFound/AlreadyExists carry those class names."""
    class NotFound(Exception):
        pass

    class DictClient:
        def __init__(self):
            self.cm = None

        def get_or_none(self, *args):
            return self.cm

        def patch(self, api, kind, name, body, ns):
            if self.cm is None:
                raise NotFound(name)
            self.cm["data"].update(body["data"])

        def create(self, obj):
            self.cm = obj

    client = DictClient()
    store = _store(PACKAGES["port"], client)
    store.publish("h100-sxm", "1x1x1", "m", 1.0)
    store.ack("h100-sxm/1x1x1/m", "n-0", 1.0, "miss")
    assert client.cm["metadata"]["name"] == consts.COMPILE_CACHE_CONFIGMAP
    assert set(client.cm["data"]) == {"h100-sxm.json", consts.COMPILE_PREWARM_ACK_KEY}


# ------------------------------------------------------ the CUDA binding


def test_bind_persistent_cache_is_false_on_the_cpu():
    before = (build.BUILD_DIR, build.build_dir())
    assert cc.bind_persistent_cache(device="cpu") is False
    if not torch.cuda.is_available():
        assert cc.bind_persistent_cache() is False
    assert (build.BUILD_DIR, build.build_dir()) == before


def test_bind_persistent_cache_binds_the_build_dir_for_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "_bound_dir", None)
    monkeypatch.setenv(consts.COMPILE_CACHE_DIR_ENV, str(tmp_path / "cache"))
    default = build.BUILD_DIR
    assert cc.bind_persistent_cache(device="cuda") is True
    assert build.build_dir() == tmp_path / "cache" and build.BUILD_DIR == default
    assert build.library_path("flash_fwd").parent == tmp_path / "cache"
    blocker = tmp_path / "a-file"
    blocker.write_text("")
    assert cc.bind_persistent_cache(str(blocker / "sub"), device="cuda") is False
    assert build.build_dir() == tmp_path / "cache"  # a failed bind changes nothing
    with pytest.raises(OSError):
        build.bind_build_dir(blocker / "sub")
