"""The port's in-cluster apiserver client (``tpu_operator_torch/kube.py``)
against the reference's served fake apiserver (``tpu_operator.kube.httpserver``
over a ``FakeClient`` on loopback): every verb the agents call, for
Nodes, ConfigMaps and Pods, gives the reference ``HttpClient``'s result,
and every error raises a class of the reference's name."""

from __future__ import annotations

import pytest

from tpu_operator.kube import errors as ref_errors
from tpu_operator.kube.fake import FakeClient
from tpu_operator.kube.http_client import HttpClient
from tpu_operator.kube.httpserver import FakeApiServer
from tpu_operator_torch import kube
from tpu_operator_torch.kube import is_api_error

NS = "tpu-operator"


@pytest.fixture
def served():
    """A fake apiserver on loopback, and both packages' clients to it."""
    store = FakeClient()
    server = FakeApiServer(store).start()
    try:
        yield store, {"reference": HttpClient(server.base_url, retry_budget=0),
                      "port": kube.Client(server.base_url, timeout=10.0)}
    finally:
        server.stop()


def _node(name):
    return kube.new_object("v1", "Node", name, labels={"a": "1"}, status={"allocatable": {}})


def _outcome(call):
    """A call's result with the server-stamped fields dropped, or the
    name of the error class it raised."""
    try:
        got = call()
    except Exception as e:  # noqa: BLE001 — the class name is the outcome
        return type(e).__name__
    if isinstance(got, dict):
        md = {k: v for k, v in (got.get("metadata") or {}).items()
              if k not in ("resourceVersion", "uid", "creationTimestamp", "generation")}
        return dict(got, metadata=md)
    return got


def _script(client, suffix):
    """Every verb of the port's client, for each kind it supports, each
    success and each error the agents handle."""
    node, cm, pod = f"n-{suffix}", f"cm-{suffix}", f"pod-{suffix}"
    steps = [
        ("get absent node", lambda: client.get_or_none("v1", "Node", node)),
        ("create node", lambda: client.create(_node(node))),
        ("create node again", lambda: client.create(_node(node))),
        ("get node", lambda: client.get_or_none("v1", "Node", node)),
        ("patch labels", lambda: client.patch(
            "v1", "Node", node, {"metadata": {"labels": {"a": None, "b": "2"}}})),
        ("patch absent", lambda: client.patch("v1", "Node", node + "x", {"metadata": {}})),
        ("create cm", lambda: client.create(kube.new_object(
            "v1", "ConfigMap", cm, NS, data={"k": "v"}))),
        ("merge cm", lambda: client.patch("v1", "ConfigMap", cm, {"data": {"j": "w"}}, NS)),
        ("cm in another namespace", lambda: client.get_or_none("v1", "ConfigMap", cm, "other")),
        ("create pod", lambda: client.create(kube.new_object(
            "v1", "Pod", pod, NS, spec={"containers": []}))),
        ("delete pod", lambda: client.delete("v1", "Pod", pod, NS)),
        ("delete absent pod", lambda: client.delete("v1", "Pod", pod, NS)),
        ("get deleted pod", lambda: client.get_or_none("v1", "Pod", pod, NS)),
    ]
    out = [(what, _outcome(call)) for what, call in steps]
    live = client.get_or_none("v1", "Node", node)
    live["metadata"]["labels"]["c"] = "3"
    out.append(("update", _outcome(lambda: client.update(dict(live)))))
    out.append(("update stale", _outcome(lambda: client.update(live))))  # old resourceVersion
    fresh = client.get_or_none("v1", "Node", node)
    fresh["status"]["conditions"] = [{"type": "TPUHealthy", "status": "True"}]
    out.append(("update status", _outcome(lambda: client.update_status(fresh))))
    return out


def test_every_verb_gives_the_reference_clients_result(served):
    _, clients = served
    ref = _script(clients["reference"], "ref")
    got = _script(clients["port"], "port")
    swap = {"n-ref": "n-port", "cm-ref": "cm-port", "pod-ref": "pod-port"}

    def renamed(obj):
        if isinstance(obj, dict):
            return {k: renamed(v) for k, v in obj.items()}
        return swap.get(obj, obj) if isinstance(obj, str) else obj

    assert got == [(what, renamed(outcome)) for what, outcome in ref]
    outcomes = dict(got)
    assert outcomes["get absent node"] is None and outcomes["get deleted pod"] is None
    assert outcomes["create node again"] == "AlreadyExists"
    assert outcomes["patch absent"] == outcomes["delete absent pod"] == "NotFound"
    assert outcomes["update stale"] == "Conflict"
    assert outcomes["patch labels"]["metadata"]["labels"] == {"b": "2"}
    assert outcomes["merge cm"]["data"] == {"k": "v", "j": "w"}
    assert outcomes["update status"]["status"]["conditions"][0]["type"] == "TPUHealthy"


@pytest.mark.parametrize("cls, ref_cls", [
    (kube.ApiError, ref_errors.ApiError), (kube.NotFound, ref_errors.NotFound),
    (kube.AlreadyExists, ref_errors.AlreadyExists), (kube.Conflict, ref_errors.Conflict),
])
def test_error_classes_carry_the_reference_names(cls, ref_cls):
    names = [c.__name__ for c in cls.__mro__]
    assert cls.__name__ == ref_cls.__name__ and cls.code == ref_cls.code
    assert "ApiError" in names
    # the port's name matching sees both packages' errors alike
    assert is_api_error(cls("x"), cls.__name__) and is_api_error(ref_cls("x"), cls.__name__)


def test_unreachable_server_is_an_api_error():
    client = kube.Client("http://127.0.0.1:9", timeout=2.0)  # the discard port: refused
    with pytest.raises(kube.ApiError) as raised:
        client.get_or_none("v1", "Node", "n")
    assert raised.value.code == 0


def test_only_the_agents_kinds(served):
    _, clients = served
    with pytest.raises(ValueError, match="unsupported kind"):
        clients["port"].get_or_none("apps/v1", "DaemonSet", "x", NS)
    with pytest.raises(ValueError, match="unsupported kind"):
        clients["port"].get_or_none("v1", "Secret", "x", NS)


def test_in_cluster_needs_the_service_env(monkeypatch):
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    with pytest.raises(kube.ApiError, match="not running in a cluster"):
        kube.Client.in_cluster()


def test_token_file_is_read_on_every_request(tmp_path):
    token = tmp_path / "token"
    token.write_text("first\n")
    client = kube.Client("http://127.0.0.1:1", token_path=str(token))
    assert client._bearer() == "first"
    token.write_text("rotated")
    assert client._bearer() == "rotated"


def test_new_object_equals_the_reference():
    from tpu_operator.kube.objects import new_object

    for args, kw in ((("v1", "Pod", "p", NS), {"labels": {"a": "b"}, "spec": {}}),
                     (("v1", "Node", "n"), {})):
        assert kube.new_object(*args, **kw) == new_object(*args, **kw)
